"""Cross tests of the port's compiled host toolkit (``csrc/hostkit.cpp``
through ``sprsolve_tpu_torch.native``) against its plain Python versions and
against the JAX package's hostkit (cases of ``tests/test_native.py``).

Exact where the arithmetic is the same: the patterns, colorings, RCM
orders and counts are integers, and the real factorizations run the same
IEEE operations in the same order, so compiled and plain agree bitwise in
f32/f64. Complex division is Smith's algorithm in NumPy and libgcc's in
C++, and the JAX hostkit is built with ``-march=native`` (which may fuse
multiply-adds), so those comparisons take rtol 1e-12 (f64/c128) or 1e-6
(f32/c64). RCM equals the JAX hostkit's order only on patterns whose rows
have at most 16 entries: the JAX hostkit sorts neighbours with
``std::sort``, stable only on such short ranges."""

import numpy as np
import pytest
import scipy.sparse as sps

from sprsolve_tpu import native as jnative
from sprsolve_tpu_torch import native


def _poisson2d(side: int) -> sps.csr_matrix:
    T = sps.diags([-np.ones(side - 1), 2 * np.ones(side), -np.ones(side - 1)], [-1, 0, 1])
    return (sps.kron(T, sps.eye(side)) + sps.kron(sps.eye(side), T)).tocsr()


def _scrambled(S: sps.csr_matrix, seed: int) -> sps.csr_matrix:
    p = np.random.default_rng(seed).permutation(S.shape[0])
    out = S[p][:, p].tocsr()
    out.sort_indices()
    return out


def _pattern(S):
    return S.shape[0], S.indptr.astype(np.int64), S.indices.astype(np.int32)


def test_hostkit_builds_from_the_port_source():
    lib = native.load()
    path = native.library_path()
    assert path.exists() and path.parent == native.build_dir()
    assert path.parent.parts[-2:] == ("build", "hostkit")
    assert native.SOURCE.name == "hostkit.cpp" and native.SOURCE.parent.name == "csrc"
    assert lib.csr_count_diagonals is not None


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "hostkit.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "build_dir", lambda: tmp_path / "out")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as e:
        native.build()
    assert "error" in str(e.value)
    assert not list((tmp_path / "out").glob("*.so"))


@pytest.mark.parametrize("seed", [0, 1])
def test_symmetrize_pattern_matches_plain_jax_and_scipy(seed):
    S = sps.random(120, 120, density=0.05, random_state=seed, format="csr")
    n, indptr, indices = _pattern(S)
    ip, ind = native.symmetrize_pattern(n, indptr, indices)
    for ip2, ind2 in (native.symmetrize_pattern_plain(n, indptr, indices),
                      jnative.symmetrize_pattern(n, indptr, indices)):
        np.testing.assert_array_equal(ip, ip2)
        np.testing.assert_array_equal(ind, ind2)
    a = sps.csr_matrix((np.ones(len(indices)), indices, indptr), shape=(n, n))
    want = (a + a.T).tocsr()
    want.sort_indices()
    np.testing.assert_array_equal(ip, want.indptr)
    np.testing.assert_array_equal(ind, want.indices)


def test_greedy_color_matches_plain_and_jax_and_is_proper():
    S = _scrambled(_poisson2d(16), 3)
    n, indptr, indices = _pattern(S)
    ip, ind = native.symmetrize_pattern(n, indptr, indices)
    colors = native.greedy_color(n, ip, ind)
    np.testing.assert_array_equal(colors, native.greedy_color_plain(n, ip, ind))
    np.testing.assert_array_equal(colors, jnative.greedy_color(n, ip, ind))
    for i in range(n):
        nbr = ind[ip[i]: ip[i + 1]]
        assert not np.any(colors[nbr[nbr != i]] == colors[i])


@pytest.mark.parametrize("side", [20, 64])
def test_rcm_order_matches_plain_and_jax_on_scrambled_grids(side):
    """Rows of at most 5 entries: the compiled, the plain and the JAX
    hostkit's orders are equal, and RCM cuts the diagonal count."""
    S = _scrambled(_poisson2d(side), side)
    n, indptr, indices = _pattern(S)
    ip, ind = native.symmetrize_pattern(n, indptr, indices)
    order = native.rcm_order(n, ip, ind)
    np.testing.assert_array_equal(order, native.rcm_order_plain(n, ip, ind))
    np.testing.assert_array_equal(order, jnative.rcm_order(n, ip, ind))
    B = S[order][:, order].tocsr()
    diags = native.csr_count_diagonals(n, B.indptr, B.indices)
    assert diags == native.csr_count_diagonals_plain(n, B.indptr, B.indices)
    assert diags < native.csr_count_diagonals(n, indptr, indices) // 10


def test_rcm_reduces_bandwidth_on_a_random_pattern():
    n = 300
    a = sps.random(n, n, density=0.01, random_state=0)
    a = (((a + a.T) > 0).astype(np.int8) + sps.eye(n, dtype=np.int8)).tocsr()
    a.sort_indices()
    _, indptr, indices = _pattern(a)
    assert np.diff(indptr).max() <= 16
    order = native.rcm_order(n, indptr, indices)
    assert sorted(order.tolist()) == list(range(n))
    np.testing.assert_array_equal(order, native.rcm_order_plain(n, indptr, indices))
    np.testing.assert_array_equal(order, jnative.rcm_order(n, indptr, indices))
    b = a[order][:, order].tocsr()
    assert native.csr_bandwidth(n, b.indptr, b.indices) <= native.csr_bandwidth(n, indptr,
                                                                               indices)


def test_coo_sort_perm_matches_lexsort_exactly():
    rng = np.random.default_rng(1)
    rows = rng.integers(0, 50, 500).astype(np.int32)
    cols = rng.integers(0, 50, 500).astype(np.int32)
    perm = native.coo_sort_perm(50, rows, cols)
    # a stable sort: equal keys keep their input order, as lexsort's do
    np.testing.assert_array_equal(perm, native.coo_sort_perm_plain(50, rows, cols))
    jperm = jnative.coo_sort_perm(50, rows, cols)
    np.testing.assert_array_equal(rows[perm], rows[jperm])
    np.testing.assert_array_equal(cols[perm], cols[jperm])


@pytest.mark.parametrize("name", ["grid16", "random"])
def test_bandwidth_and_diagonal_count_match_plain_and_jax(name):
    S = _poisson2d(16) if name == "grid16" else sps.random(
        90, 90, density=0.05, random_state=4, format="csr")
    n, indptr, indices = _pattern(S)
    bw, nd = native.csr_bandwidth(n, indptr, indices), native.csr_count_diagonals(
        n, indptr, indices)
    assert (bw, nd) == (native.csr_bandwidth_plain(n, indptr, indices),
                        native.csr_count_diagonals_plain(n, indptr, indices))
    assert (bw, nd) == (jnative.csr_bandwidth(n, indptr, indices),
                        jnative.csr_count_diagonals(n, indptr, indices))
    if name == "grid16":
        assert (bw, nd) == (16, 5)


def _factor_case(dtype):
    S = _scrambled(_poisson2d(12), 2)
    rng = np.random.default_rng(5)
    vals = S.data.astype(np.float64) + 0.01 * rng.standard_normal(S.nnz) * (
        S.indices != np.repeat(np.arange(S.shape[0]), np.diff(S.indptr)))
    if np.dtype(dtype).kind == "c":
        vals = vals + 0.05j * rng.standard_normal(S.nnz)
    # symmetric values for IC(0): average with the transpose
    M = sps.csr_matrix((vals, S.indices, S.indptr), shape=S.shape)
    M = ((M + M.T) * 0.5).tocsr() if np.dtype(dtype).kind == "f" else M
    M.sort_indices()
    return M.shape[0], M.indptr, M.indices, M.data.astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.complex64, np.complex128])
def test_ilu0_ic0_match_plain_and_jax(dtype):
    n, indptr, indices, vals = _factor_case(dtype)
    wide = np.dtype(dtype).itemsize >= (16 if np.dtype(dtype).kind == "c" else 8)
    rtol = 1e-12 if wide else 1e-6
    for kind in ("ilu0", "ic0"):
        got = getattr(native, kind)(n, indptr, indices, vals)
        plain = getattr(native, f"{kind}_plain")(n, indptr, indices, vals)
        ref = getattr(jnative, kind)(n, indptr, indices, vals)
        assert got.dtype == vals.dtype
        if np.dtype(dtype).kind == "f":
            np.testing.assert_array_equal(got, plain)
        else:
            np.testing.assert_allclose(got, plain, rtol=rtol, atol=0)
        np.testing.assert_allclose(got, ref, rtol=rtol, atol=0)


def test_factor_errors_match_plain():
    A = sps.csr_matrix(np.array([[1.0, 2.0, 0.0], [2.0, 4.0, 1.0], [0.0, 1.0, 3.0]]))
    n, indptr, indices = _pattern(A)
    for kind in ("ilu0", "ic0"):
        rows = []
        for fn in (getattr(native, kind), getattr(native, f"{kind}_plain")):
            with pytest.raises(ZeroDivisionError) as e:
                fn(n, indptr, indices, A.data)
            rows.append(e.value.args)
        assert rows[0] == rows[1] == (1,)
        with pytest.raises(TypeError):
            getattr(native, kind)(n, indptr, indices, A.data.astype(np.float16))
