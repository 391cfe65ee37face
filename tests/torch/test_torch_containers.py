"""Cross tests of the port's containers, SpMV oracles, problem generators,
layout routing and interop against the JAX package.

Tolerances: the reference's 5×5 fixtures keep their own atol 1e-8
(``tests/test_spmv.py``); CSR and DIA products of the same data are
compared at rtol/atol 1e-14 in f64 (a row sums at most 5 terms, in the
same entry order in both packages); generators and band extraction are
exact (host NumPy in both)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

import sprsolve_tpu as jsp
import sprsolve_tpu_torch as tsp
from sprsolve_tpu.ops.spmv import spmv_csr as j_spmv_csr, spmv_dia as j_spmv_dia
from sprsolve_tpu.utils import problems as jprob
from sprsolve_tpu_torch.interop import csr_from_reference
from sprsolve_tpu_torch.ops.spmv import spmv_csr, spmv_dia
from sprsolve_tpu_torch.utils import problems as tprob

torch.set_num_threads(2)

EPS = 1e-8


def _ref_arrays():
    # src/mat.rs:232-255 (dense_csr_mat), as in tests/test_spmv.py
    indptr = np.array([0, 3, 3, 5, 6, 7])
    indices = np.array([1, 2, 3, 2, 3, 4, 4])
    data = np.array([0.75672424, 0.1649078, 0.30140296, 0.10358244, 0.6283315,
                     0.39244208, 0.57202407])
    return data, indices, indptr


def test_csr_spmv_reference_values():
    data, indices, indptr = _ref_arrays()
    mat = tsp.CSR.from_arrays(data, indices, indptr, (5, 5))
    v = torch.tensor([0.1, 0.2, -0.1, 0.3, 0.9], dtype=torch.float64)
    expected = [0.22527496, 0.0, 0.17814121, 0.35319787, 0.51482166]
    got = spmv_csr(mat, v)
    np.testing.assert_allclose(got.numpy(), expected, atol=EPS)
    jmat = jsp.CSR.from_arrays(data, indices, indptr, (5, 5))
    want = j_spmv_csr(jmat, jnp.asarray(v.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-14, atol=1e-14)
    assert got[1] == 0.0   # empty row → 0 (src/mat.rs:71)
    # the same fixture as DIA (offsets 0..3), against the JAX DIA path
    dia = mat.to_dia()
    assert dia.offsets == jmat.to_dia().offsets == (0, 1, 2, 3)
    got_d = spmv_dia(dia, v)
    np.testing.assert_allclose(got_d.numpy(), expected, atol=EPS)
    np.testing.assert_allclose(
        got_d.numpy(), np.asarray(j_spmv_dia(jmat.to_dia(), jnp.asarray(v.numpy()))),
        rtol=1e-14, atol=1e-14)


def test_coo_duplicates_sum_and_csr_from_coo_matches_jax():
    rng = np.random.default_rng(0)
    row = rng.integers(0, 6, 40)
    col = rng.integers(0, 6, 40)
    dat = rng.standard_normal(40)
    t = tsp.COO(data=dat, row=row, col=col, shape=(6, 6)).to_csr()
    j = jsp.COO(data=dat, row=row.astype(np.int32), col=col.astype(np.int32),
                shape=(6, 6)).to_csr()
    assert t.nnz == j.nnz
    np.testing.assert_array_equal(t.indptr.numpy(), np.asarray(j.indptr))
    np.testing.assert_array_equal(t.indices.numpy(), np.asarray(j.indices))
    np.testing.assert_array_equal(t.row_ids.numpy(), np.asarray(j.row_ids))
    np.testing.assert_allclose(t.data.numpy(), np.asarray(j.data), rtol=1e-15)


@pytest.mark.parametrize("shape", [(9, 9), (12, 12), (20, 20)])
def test_grid_csr_dia_match_jax(shape):
    """Generator, band extraction, diagonal and both SpMV paths."""
    tA = tprob.grid_laplacian_dirichlet(shape)
    jA = jprob.grid_laplacian_dirichlet(shape)
    for f in ("data", "indices", "indptr", "row_ids"):
        np.testing.assert_array_equal(getattr(tA, f).numpy(), np.asarray(getattr(jA, f)))
    tb, toffs = tsp.DIA.arrays_from_csr(tA)
    jb, joffs = jsp.DIA.arrays_from_csr(jA)
    assert toffs == joffs
    np.testing.assert_array_equal(tb, np.asarray(jb))
    np.testing.assert_array_equal(tA.diagonal().numpy(), np.asarray(jA.diagonal()))
    np.testing.assert_array_equal(tA.to_dia().diagonal().numpy(),
                                  np.asarray(jA.to_dia().diagonal()))
    x = np.random.default_rng(1).standard_normal(tA.shape[0])
    xt = torch.from_numpy(x)
    want = np.asarray(j_spmv_csr(jA, jnp.asarray(x)))
    for got in (spmv_csr(tA, xt), spmv_dia(tA.to_dia(), xt), tA.matvec(xt),
                tA.to_dia().matvec(xt)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-14, atol=1e-14)
    wd = np.asarray(jax.jit(j_spmv_dia)(jA.to_dia(), jnp.asarray(x)))
    np.testing.assert_allclose(spmv_dia(tA.to_dia(), xt).numpy(), wd, rtol=1e-14,
                               atol=1e-14)
    y, d = tA.matvec_dot(xt)
    np.testing.assert_allclose(float(d), float(np.dot(x, want)), rtol=1e-13)


def test_set_boundary_condition_matches_jax():
    f = lambda r, c: float(r + c)
    np.testing.assert_array_equal(
        tprob.set_boundary_condition(np.zeros(400), (20, 20), f),
        jprob.set_boundary_condition(np.zeros(400), (20, 20), f))


@pytest.mark.parametrize("dims", [(8, 8, 8), (6, 7, 5)])
def test_poisson3d_matches_jax(dims):
    t = tprob.poisson3d(*dims)
    j = jprob.poisson3d(*dims)
    assert t.dtype == torch.float32 and t.shape == j.shape
    for f in ("data", "indices", "indptr"):
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)))


def test_scipy_dense_and_reference_builders_agree():
    S = sps.random(30, 30, density=0.2, random_state=3, format="coo") + sps.eye(30)
    c = jsp.csr_from_scipy(S)
    a = csr_from_reference(np.asarray(c.data), np.asarray(c.indices),
                           np.asarray(c.indptr), (30, 30))
    b = tsp.csr_from_scipy(S)
    d = tsp.csr_from_dense(S.toarray())
    for m in (b, d):
        np.testing.assert_array_equal(m.indptr.numpy(), a.indptr.numpy())
        np.testing.assert_array_equal(m.indices.numpy(), a.indices.numpy())
        np.testing.assert_allclose(m.data.numpy(), a.data.numpy(), rtol=1e-15)
    x = np.random.default_rng(4).standard_normal(30)
    np.testing.assert_allclose(b.matvec(torch.from_numpy(x)).numpy(), S @ x,
                               rtol=1e-13, atol=1e-14)


def test_optimize_routes_banded_like_jax():
    """f32 banded → PaddedDIA (the kernels), as optimize.py:67-75; f64 →
    PaddedDIA too in the port (the JAX package's DIA: its TPU kernels have
    no f64), and DIA with prefer_kernels=False."""
    A32 = tprob.poisson3d(6, 6, 6)
    op = tsp.optimize(A32, device="cpu")
    assert isinstance(op, tsp.PaddedDIA) and op.bands.dtype == torch.int8
    assert isinstance(jsp.optimize(jprob.poisson3d(6, 6, 6)), jsp.PaddedDIA)
    A64 = tprob.grid_laplacian_dirichlet((10, 10))
    op64 = tsp.optimize(A64, device="cpu")
    assert type(op64) is tsp.PaddedDIA and op64.bands.dtype == torch.float64
    assert type(tsp.optimize(A64, prefer_kernels=False, device="cpu")) is tsp.DIA
    assert type(jsp.optimize(jprob.grid_laplacian_dirichlet((10, 10)))) is jsp.DIA


def test_optimize_non_banded_names_roadmap_item():
    """The non-banded layouts are ported: a random pattern, which used to
    raise naming ROADMAP item 9, gets a structured layout that computes A·x
    (the routing itself is held against JAX's in test_torch_optimize.py)."""
    S = (sps.random(200, 200, density=0.05, random_state=0, format="csr")
         + sps.eye(200)).astype(np.float32)
    op = tsp.optimize(tsp.csr_from_scipy(S), device="cpu")
    assert not isinstance(op, tsp.ELL)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(200).astype(np.float32))
    y = op.unpad_vec(op.matvec(op.pad_vec(x))) if hasattr(op, "pad_vec") else op.matvec(x)
    np.testing.assert_allclose(y.numpy(), S.astype(np.float64) @ x.numpy().astype(np.float64),
                               rtol=1e-5, atol=1e-5)


def test_dia_max_diags_guard():
    S = sps.random(50, 50, density=0.5, random_state=1, format="csr")
    with pytest.raises(ValueError, match="distinct diagonals"):
        tsp.DIA.from_csr(tsp.csr_from_scipy(S), max_diags=8)


def test_complex_csr_matvec_matches_jax():
    """Complex data sums each plane per row (segment_reduce is real-only)."""
    rng = np.random.default_rng(5)
    S = sps.random(25, 25, density=0.2, random_state=6, format="csr")
    S = (S + 1j * sps.random(25, 25, density=0.2, random_state=7, format="csr")).tocsr()
    x = rng.standard_normal(25) + 1j * rng.standard_normal(25)
    got = tsp.csr_from_scipy(S).matvec(torch.from_numpy(x))
    want = jsp.csr_from_scipy(S).matvec(jnp.asarray(x))
    assert got.dtype == torch.complex128
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-13, atol=1e-14)
