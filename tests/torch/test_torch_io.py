"""Cross tests of the port's Matrix Market IO against the JAX package's
(mirrors ``tests/test_io.py``): round trips, symmetry expansion, scipy's
reader and writer, duplicates summed, the array format; then, on one file
each, the port's CSR arrays bitwise the JAX package's for every field ×
symmetry of the format and the array format, ``mmwrite``'s text byte for
byte the JAX package's, the compiled parser bitwise its NumPy version, and
malformed files raising ValueError in both packages.  Values are exact
(tolerance 0) wherever both sides parse the same decimal text; a round trip
through ``%.17g`` is exact too."""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io as scipy_io
import scipy.sparse as sps
import torch

import sprsolve_tpu as jsp
from sprsolve_tpu.utils import io as jio
from sprsolve_tpu.utils import problems as jprob
import sprsolve_tpu_torch as tsp
from sprsolve_tpu_torch import native
from sprsolve_tpu_torch.utils import io as tio
from sprsolve_tpu_torch.utils import problems as tprob

torch.set_num_threads(2)


def _dense(A) -> np.ndarray:
    return sps.csr_matrix((A.data.numpy(), A.indices.numpy(), A.indptr.numpy()),
                          shape=A.shape).toarray()


def _rt(A, **kw):
    buf = io.StringIO()
    tio.mmwrite(buf, A, **kw)
    buf.seek(0)
    return tio.mmread(buf)


def _same_csr(A, J):
    """The port's CSR arrays equal the JAX package's, bit for bit."""
    assert A.shape == tuple(J.shape)
    assert np.array_equal(A.data.numpy(), np.asarray(J.data))
    assert A.data.numpy().dtype == np.asarray(J.data).dtype
    assert np.array_equal(A.indices.numpy(), np.asarray(J.indices, np.int64))
    assert np.array_equal(A.indptr.numpy(), np.asarray(J.indptr, np.int64))


# --- the cases of tests/test_io.py -------------------------------------------
def test_coordinate_roundtrip_real(tmp_path):
    rng = np.random.default_rng(0)
    dense = rng.standard_normal((9, 7)) * (rng.random((9, 7)) < 0.3)
    path = tmp_path / "a.mtx"
    tio.mmwrite(path, tsp.csr_from_dense(dense), comment="test matrix\nsecond line")
    B = tio.mmread(path)
    np.testing.assert_array_equal(_dense(B), dense)
    _same_csr(B, jio.mmread(path))


def test_coordinate_roundtrip_complex():
    rng = np.random.default_rng(1)
    dense = (rng.standard_normal((6, 6)) + 1j * rng.standard_normal((6, 6))
             ) * (rng.random((6, 6)) < 0.4)
    np.testing.assert_array_equal(_dense(_rt(tsp.csr_from_dense(dense))), dense)


def test_symmetric_storage_expansion():
    rng = np.random.default_rng(2)
    low = np.tril(rng.standard_normal((8, 8)) * (rng.random((8, 8)) < 0.5))
    dense = low + np.triu(low.T, 1)
    np.testing.assert_array_equal(
        _dense(_rt(tsp.csr_from_dense(dense), symmetry="symmetric")), dense)


HERMITIAN = """%%MatrixMarket matrix coordinate complex hermitian
% a comment
3 3 3
1 1 2.0 0.0
2 1 1.0 -1.0
3 3 4.0 0.0
"""
SKEW = """%%MatrixMarket matrix coordinate real skew-symmetric
2 2 1
2 1 3.0
"""
PATTERN = """%%MatrixMarket matrix coordinate pattern general
2 3 2
1 3
2 1
"""


def test_parse_symmetries_from_text():
    d = _dense(tio.mmread(io.StringIO(HERMITIAN)))
    np.testing.assert_array_equal(d, np.array([[2, 1 + 1j, 0], [1 - 1j, 0, 0], [0, 0, 4]]))
    np.testing.assert_array_equal(_dense(tio.mmread(io.StringIO(SKEW))),
                                  np.array([[0, -3.0], [3.0, 0]]))
    np.testing.assert_array_equal(_dense(tio.mmread(io.StringIO(PATTERN))),
                                  np.array([[0, 0, 1.0], [1.0, 0, 0]]))
    for text in (HERMITIAN, SKEW, PATTERN):
        _same_csr(tio.mmread(io.StringIO(text)), jio.mmread(io.StringIO(text)))


def test_array_format():
    dense = np.arange(12.0).reshape(3, 4)
    buf = io.StringIO()
    tio.mmwrite(buf, dense)
    buf.seek(0)
    got = tio.mmread(buf)
    assert isinstance(got, np.ndarray)
    np.testing.assert_array_equal(got, dense)


def test_array_symmetric_text():
    text = "%%MatrixMarket matrix array real symmetric\n3 3\n1.0\n2.0\n3.0\n4.0\n5.0\n6.0\n"
    got = tio.mmread(io.StringIO(text))
    np.testing.assert_array_equal(got, np.array([[1, 2, 3], [2, 4, 5], [3, 5, 6.0]]))
    np.testing.assert_array_equal(got, jio.mmread(io.StringIO(text)))


def test_duplicates_summed():
    text = ("%%MatrixMarket matrix coordinate real general\n2 2 3\n"
            "1 1 1.0\n1 1 2.5\n2 2 1.0\n")
    np.testing.assert_array_equal(_dense(tio.mmread(io.StringIO(text))),
                                  np.array([[3.5, 0], [0, 1.0]]))


def test_bad_header_raises():
    with pytest.raises(ValueError):
        tio.mmread(io.StringIO("%%NotMatrixMarket nope\n1 1 0\n"))


def test_cross_check_scipy(tmp_path):
    rng = np.random.default_rng(3)
    dense = rng.standard_normal((11, 5)) * (rng.random((11, 5)) < 0.3)
    path = tmp_path / "x.mtx"
    tio.mmwrite(path, tsp.csr_from_dense(dense))
    np.testing.assert_array_equal(scipy_io.mmread(str(path)).toarray(), dense)
    path2 = tmp_path / "y.mtx"
    scipy_io.mmwrite(str(path2), sps.csr_matrix(dense))
    np.testing.assert_allclose(_dense(tio.mmread(path2)), dense, rtol=0, atol=1e-12)
    _same_csr(tio.mmread(path2), jio.mmread(path2))


def test_solve_from_mtx_end_to_end():
    A = tprob.grid_laplacian_dirichlet((10, 10))
    A2 = _rt(A)
    b = np.zeros(100)
    tprob.set_boundary_condition(b, (10, 10), lambda r, c: float(r + c))
    x, info = tsp.solve(A2, b, tol=1e-12, max_iter=500, device="cpu")
    info.raise_if_error()
    buf = io.StringIO()
    jio.mmwrite(buf, jprob.grid_laplacian_dirichlet((10, 10)))
    buf.seek(0)
    xj, info_j = jsp.solve(jio.mmread(buf), b, tol=1e-12, max_iter=500)
    assert abs(int(info.iterations) - int(info_j.iterations)) <= 3
    assert np.linalg.norm(_dense(A) @ x.numpy() - b) / np.linalg.norm(b) < 1e-10
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=0, atol=1e-10)


def test_csr_from_bcoo_interop():
    """tests/test_io.py's BCOO case on a torch sparse COO tensor."""
    rng = np.random.default_rng(7)
    dense = rng.standard_normal((9, 6)) * (rng.random((9, 6)) < 0.4)
    A = tsp.csr_from_bcoo(torch.as_tensor(dense).to_sparse())
    np.testing.assert_array_equal(_dense(A), dense)
    d2 = rng.standard_normal((20, 20)) * (rng.random((20, 20)) < 0.3) + np.eye(20) * 8.0
    b = rng.standard_normal(20)
    x, info = tsp.solve(tsp.csr_from_bcoo(torch.as_tensor(d2).to_sparse()), b, tol=1e-12,
                        max_iter=500, device="cpu")
    info.raise_if_error()
    assert np.linalg.norm(d2 @ x.numpy() - b) / np.linalg.norm(b) < 1e-10


def test_bcoo_padded_nse():
    """tests/test_io.py's padded-BCOO case: index pairs outside the shape
    (a fixed-size buffer's padding, two slots here) are dropped."""
    from jax.experimental import sparse as jsparse

    dense = np.array([[1.0, 0.0], [0.0, 2.0]])
    idx = torch.tensor([[0, 1, 2, 2], [0, 1, 2, 2]])
    vals = torch.tensor([1.0, 2.0, 0.0, 0.0], dtype=torch.float64)
    with torch.sparse.check_sparse_tensor_invariants(enable=False):
        t = torch.sparse_coo_tensor(idx, vals, size=(2, 2))
    A = tsp.csr_from_bcoo(t)
    np.testing.assert_array_equal(_dense(A), dense)
    _same_csr(A, jsp.csr_from_bcoo(jsparse.BCOO.fromdense(dense, nse=4)))


def test_hermitian_and_skew_write_roundtrip():
    herm = np.array([[2.0, 1 + 1j], [1 - 1j, 3.0]], complex)
    np.testing.assert_array_equal(
        _dense(_rt(tsp.csr_from_dense(herm), symmetry="hermitian")), herm)
    skew = np.array([[0.0, -3.0, 1.5], [3.0, 0.0, 0.25], [-1.5, -0.25, 0.0]])
    np.testing.assert_array_equal(
        _dense(_rt(tsp.csr_from_dense(skew), symmetry="skew-symmetric")), skew)


def test_array_skew_symmetric_text():
    text = "%%MatrixMarket matrix array real skew-symmetric\n3 3\n2.0\n3.0\n4.0\n"
    got = tio.mmread(io.StringIO(text))
    np.testing.assert_array_equal(got, np.array([[0, -2, -3], [2, 0, -4], [3, 4, 0.0]]))


# --- against the JAX package, field by symmetry ----------------------------
COORD_CASES = [("real", s) for s in ("general", "symmetric", "skew-symmetric")] + \
    [("integer", s) for s in ("general", "symmetric", "skew-symmetric")] + \
    [("complex", s) for s in ("general", "symmetric", "hermitian", "skew-symmetric")] + \
    [("pattern", s) for s in ("general", "symmetric")]


def _coord_text(field, sym, seed=0, n=9, nnz=30):
    """A coordinate file of ``nnz`` random records (duplicates included, the
    stored triangle only for a symmetric kind), with comments and blank
    lines between records."""
    rng = np.random.default_rng(seed)
    r, c = rng.integers(0, n, nnz), rng.integers(0, n, nnz)
    if sym != "general":
        r, c = np.maximum(r, c), np.minimum(r, c)
        if sym == "skew-symmetric":
            keep = r != c
            r, c = r[keep], c[keep]
    lines = [f"%%MatrixMarket matrix coordinate {field} {sym}", "% generated",
             f"{n} {n} {len(r)}"]
    for k, (i, j) in enumerate(zip(r, c)):
        vals = {"real": f" {rng.standard_normal():.6e}",
                "integer": f" {int(rng.integers(-9, 10))}",
                "complex": f" {rng.standard_normal():.17g} {rng.standard_normal():.17g}",
                "pattern": ""}[field]
        lines.append(f"{i + 1} {j + 1}{vals}")
        if k % 7 == 3:
            lines.append("% a comment between records")
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("field,sym", COORD_CASES)
def test_coordinate_csr_bitwise_the_jax_packages(field, sym):
    text = _coord_text(field, sym)
    A = tio.mmread(io.StringIO(text))
    J = jio.mmread(io.StringIO(text))
    _same_csr(A, J)


ARRAY_CASES = [("real", "general"), ("real", "symmetric"), ("real", "skew-symmetric"),
               ("complex", "general"), ("complex", "hermitian")]


@pytest.mark.parametrize("field,sym", ARRAY_CASES)
def test_array_format_equal_to_the_jax_packages(field, sym):
    rng = np.random.default_rng(5)
    m = n = 4
    count = {"general": m * n, "skew-symmetric": m * (m - 1) // 2}.get(sym, m * (m + 1) // 2)
    vals = [f"{rng.standard_normal():.17g}" + (f" {rng.standard_normal():.17g}"
                                               if field == "complex" else "")
            for _ in range(count)]
    text = f"%%MatrixMarket matrix array {field} {sym}\n{m} {n}\n" + "\n".join(vals) + "\n"
    got, want = tio.mmread(io.StringIO(text)), jio.mmread(io.StringIO(text))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, np.asarray(want))


WRITE_CASES = [("real", "general"), ("real", "symmetric"), ("real", "skew-symmetric"),
               ("complex", "general"), ("complex", "hermitian"), ("complex", "symmetric"),
               ("integer", "general"), ("real", "array")]


@pytest.mark.parametrize("field,sym", WRITE_CASES)
def test_mmwrite_text_byte_identical_to_the_jax_packages(field, sym):
    rng = np.random.default_rng(11)
    dense = rng.standard_normal((7, 7)) * (rng.random((7, 7)) < 0.5) / 3.0
    if field == "complex":
        dense = dense + 1j * rng.standard_normal((7, 7)) * (dense != 0)
    elif field == "integer":
        dense = np.round(dense * 30).astype(np.int64)
    if sym == "skew-symmetric":
        dense = np.tril(dense, -1) - np.tril(dense, -1).T
    elif sym in ("symmetric", "hermitian"):
        low = np.tril(dense, -1)
        dense = low + (low.conj() if sym == "hermitian" else low).T + np.diag(dense.diagonal().real)
    t_buf, j_buf = io.StringIO(), io.StringIO()
    if sym == "array":
        tio.mmwrite(t_buf, dense, comment="the array format")
        jio.mmwrite(j_buf, dense, comment="the array format")
    else:
        kw = dict(comment="one\ntwo", symmetry=sym)
        tio.mmwrite(t_buf, tsp.csr_from_dense(dense), **kw)
        jio.mmwrite(j_buf, jsp.csr_from_dense(dense), **kw)
    assert t_buf.getvalue() == j_buf.getvalue()
    assert t_buf.getvalue().startswith("%%MatrixMarket matrix")


def test_mmwrite_coo_and_a_poisson_file_byte_identical(tmp_path):
    A = tprob.poisson3d(6, 6, 6, dtype=np.float64)
    J = jprob.poisson3d(6, 6, 6, dtype=np.float64)
    tio.mmwrite(tmp_path / "t.mtx", A, symmetry="symmetric")
    jio.mmwrite(tmp_path / "j.mtx", J, symmetry="symmetric")
    assert (tmp_path / "t.mtx").read_bytes() == (tmp_path / "j.mtx").read_bytes()
    coo = tsp.COO(data=A.data.numpy(), row=A.row_ids.numpy(), col=A.indices.numpy(),
                  shape=A.shape)
    buf = io.StringIO()
    tio.mmwrite(buf, coo, symmetry="symmetric")
    assert buf.getvalue() == (tmp_path / "t.mtx").read_text()
    _same_csr(tio.mmread(tmp_path / "t.mtx"), jio.mmread(tmp_path / "j.mtx"))


@pytest.mark.parametrize("field,sym", COORD_CASES)
def test_compiled_parser_bitwise_its_plain_version(field, sym):
    text = _coord_text(field, sym, seed=3, n=50, nnz=400)
    body = text.split("\n", 3)[3].encode()
    nnz = int(text.split("\n")[2].split()[2])
    code = {"pattern": 0, "real": 1, "integer": 1, "complex": 2}[field]
    got = native.mm_parse_coord(body, nnz, code)
    want = native.mm_parse_coord_plain(body, nnz, code)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


MALFORMED = {
    "header": "%%NotMatrixMarket nope\n1 1 0\n",
    "format": "%%MatrixMarket matrix ragged real general\n1 1 1\n1 1 1.0\n",
    "field": "%%MatrixMarket matrix coordinate quaternion general\n1 1 1\n1 1 1.0\n",
    "symmetry": "%%MatrixMarket matrix coordinate real lopsided\n1 1 1\n1 1 1.0\n",
    "no size line": "%%MatrixMarket matrix coordinate real general\n% only a comment\n",
    "too few records": "%%MatrixMarket matrix coordinate real general\n2 2 3\n1 1 1.0\n",
    "too many records": ("%%MatrixMarket matrix coordinate real general\n2 2 1\n"
                         "1 1 1.0\n2 2 2.0\n"),
    "index out of range": "%%MatrixMarket matrix coordinate real general\n2 2 1\n3 1 1.0\n",
    "zero index": "%%MatrixMarket matrix coordinate real general\n2 2 1\n0 1 1.0\n",
    "not a number": "%%MatrixMarket matrix coordinate real general\n2 2 1\n1 1 x\n",
    "short record": "%%MatrixMarket matrix coordinate complex general\n2 2 2\n1 1 1.0\n2 2\n",
    "array count": "%%MatrixMarket matrix array real general\n2 2\n1.0\n2.0\n3.0\n",
}


@pytest.mark.parametrize("case", list(MALFORMED))
def test_malformed_files_raise_in_both_packages(case):
    text = MALFORMED[case]
    with pytest.raises(ValueError):
        tio.mmread(io.StringIO(text))
    with pytest.raises(ValueError):
        jio.mmread(io.StringIO(text))


def test_read_gives_host_tensors_and_jax_reads_the_ports_file(tmp_path):
    A = tprob.grid_laplacian_dirichlet((8, 8))
    tio.mmwrite(tmp_path / "a.mtx", A)
    B = tio.mmread(tmp_path / "a.mtx")
    assert B.device.type == "cpu" and B.data.dtype == torch.float64
    J = jio.mmread(tmp_path / "a.mtx")
    np.testing.assert_array_equal(np.asarray(J.matvec(jnp.ones(64))),
                                  B.matvec(torch.ones(64, dtype=torch.float64)).numpy())
