"""Cross tests of the port's HybridDIA (band core + COO sidecar) against
the JAX package's (cases of ``tests/test_hybrid.py``).

Routing and the split are compared under the JAX package's cost constants
(the port's own table holds H100 measurements). The split and the sidecar
arrays are equal; f64 applies agree with scipy to 1e-12, f32 ones (a
PaddedDIA core) to 2e-5. ``_hybrid_stats`` is held against the split
``HybridDIA.from_csr`` makes — offset 0 included — not against the JAX
value, which leaves offset 0 out."""

import importlib
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

import sprsolve_tpu as jsp
import sprsolve_tpu_torch as tsp
from sprsolve_tpu.ops.hybrid import HybridDIA as JHybridDIA
from sprsolve_tpu.ops.reordered import Reordered as JReordered
from sprsolve_tpu.utils import problems as jprob
from sprsolve_tpu_torch.interop import hybrid_from_reference
from sprsolve_tpu_torch.multigrid import FlatViewOperator
from sprsolve_tpu_torch.ops.reordered import Reordered

topt = importlib.import_module("sprsolve_tpu_torch.ops.optimize")
jopt = importlib.import_module("sprsolve_tpu.ops.optimize")

torch.set_num_threads(2)


@pytest.fixture
def jax_costs(monkeypatch):
    """The port's cost table set to the JAX package's constants."""
    monkeypatch.setattr(topt, "COSTS", {
        "eff_dia": jopt._EFF_XLA_DIA, "eff_bsr": jopt._EFF_BSR,
        "eff_padded_dia": jopt._EFF_PALLAS_DIA, "scatter_bytes_eq": jopt._SCATTER_BYTES_EQ})


def _band(its):
    return max(3, -(-its // 4))


def _poisson_plus_outliers(side=40, n_out=60, seed=0, dtype=np.float64):
    """2-D Poisson (positive definite) plus symmetric long-range couplings."""
    A, _ = jprob.sym_grid_laplacian((side, side))
    n = side * side
    S = -sps.csr_matrix((np.asarray(A.data), np.asarray(A.indices), np.asarray(A.indptr)),
                        shape=A.shape).astype(dtype)
    rng = np.random.default_rng(seed)
    r, c = rng.integers(0, n, n_out), rng.integers(0, n, n_out)
    v = rng.standard_normal(n_out).astype(dtype) * 0.01
    O = sps.coo_matrix((np.concatenate([v, v]), (np.concatenate([r, c]),
                                                 np.concatenate([c, r]))), shape=(n, n))
    return (S + O.tocsr()).tocsr()


def _poisson3d_plus_outliers(nx=24, n_out=60, seed=0, dtype=np.float32):
    """The fixture of ``tests/test_hybrid.py:74-91``."""
    A = jprob.poisson3d(nx, nx, nx, dtype=dtype)
    n = A.shape[0]
    S = sps.csr_matrix((np.asarray(A.data), np.asarray(A.indices), np.asarray(A.indptr)),
                       shape=A.shape)
    rng = np.random.default_rng(seed)
    r, c = rng.integers(0, n, n_out), rng.integers(0, n, n_out)
    v = rng.standard_normal(n_out).astype(dtype) * 0.01
    O = sps.coo_matrix((np.concatenate([v, v]), (np.concatenate([r, c]),
                                                 np.concatenate([c, r]))), shape=(n, n))
    return (S + O.tocsr()).tocsr().astype(dtype)


def _same_sidecar(H, jH):
    np.testing.assert_array_equal(H.out_rows.numpy(), np.asarray(jH.out_rows))
    np.testing.assert_array_equal(H.out_cols.numpy(), np.asarray(jH.out_cols))
    np.testing.assert_array_equal(H.out_vals.numpy(), np.asarray(jH.out_vals))


def test_matvec_matches_scipy_and_jax(jax_costs):
    S = _poisson_plus_outliers()
    H = tsp.HybridDIA.from_csr(tsp.csr_from_scipy(S), max_diags=8, prefer_kernels=False)
    jH = JHybridDIA.from_csr(jsp.csr_from_scipy(S), max_diags=8, prefer_pallas=False)
    assert H.n_outliers > 0 and isinstance(H.core, tsp.DIA)
    _same_sidecar(H, jH)
    assert H.core.offsets == jH.core.offsets
    x = np.random.default_rng(1).standard_normal(S.shape[0])
    y = H.matvec(torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), S @ x, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(y.numpy(), np.asarray(jH.matvec(jnp.asarray(x))), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(H.diagonal().numpy(), S.diagonal(), rtol=1e-12)
    X = np.random.default_rng(2).standard_normal((S.shape[0], 2))
    np.testing.assert_allclose(H.matmat(torch.from_numpy(X)).numpy(), S @ X, rtol=1e-12,
                               atol=1e-12)
    # the reference's sidecar around the port's core is the same operator
    r = hybrid_from_reference(H.core, jH.out_rows, jH.out_cols, jH.out_vals, jH.shape)
    assert torch.equal(r.matvec(torch.from_numpy(x)), y)


def test_matvec_f32_kernel_core(jax_costs):
    S = _poisson_plus_outliers(dtype=np.float32)
    H = tsp.HybridDIA.from_csr(tsp.csr_from_scipy(S), max_diags=8, prefer_kernels=True)
    assert isinstance(H.core, FlatViewOperator) and isinstance(H.core.op, tsp.PaddedDIA)
    x = np.random.default_rng(1).standard_normal(S.shape[0]).astype(np.float32)
    y = H.matvec(torch.from_numpy(x))
    assert y.dtype == torch.float32 and y.shape == (S.shape[0],)
    np.testing.assert_allclose(y.numpy(), S.astype(np.float64) @ x, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(H.diagonal().numpy(), S.diagonal(), rtol=1e-7)


def test_spill_budget_raises():
    S = sps.random(400, 400, density=0.05, random_state=0, format="csr")
    S.setdiag(S.diagonal() + 10.0)
    with pytest.raises(ValueError, match="spills"):
        tsp.HybridDIA.from_csr(tsp.csr_from_scipy(S.tocsr()), max_diags=8, max_outliers=100)


@pytest.mark.parametrize("max_diags", [2, 8])
def test_hybrid_stats_count_what_the_split_keeps(max_diags, jax_costs):
    """Three heavy off-diagonal bands outweigh a sparse main diagonal: with
    max_diags = 2 the split keeps offset 0 on top of the two heaviest, and
    the cost model must count it."""
    n = 600
    rng = np.random.default_rng(0)
    S = sps.diags([rng.standard_normal(n - 5), rng.standard_normal(n - 3),
                   rng.standard_normal(n - 1)], [5, -3, 1], format="lil")
    S[np.arange(0, n, 50), np.arange(0, n, 50)] = 4.0
    S = S.tocsr()
    A = tsp.csr_from_scipy(S)
    nd_core, n_out = topt._hybrid_stats(A, max_diags)
    H = tsp.HybridDIA.from_csr(A, max_diags=max_diags, prefer_kernels=False)
    assert nd_core == len(H.core.offsets) and n_out == H.n_outliers
    assert 0 in H.core.offsets
    assert nd_core == min(max_diags, 3) + 1
    x = rng.standard_normal(n)
    np.testing.assert_allclose(H.matvec(torch.from_numpy(x)).numpy(), S @ x, rtol=1e-12,
                               atol=1e-12)


def test_optimize_routes_spiked_pattern_to_hybrid(jax_costs):
    """3-D Poisson plus a few couplings: a HybridDIA with the K1 core, as in
    the JAX package, with the same sidecar; never the ELL warning."""
    S = _poisson3d_plus_outliers()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        op = tsp.optimize(tsp.csr_from_scipy(S), device="cpu")
        jop = jsp.optimize(jsp.csr_from_scipy(S))
    assert isinstance(op, tsp.HybridDIA) and isinstance(jop, JHybridDIA)
    assert isinstance(op.core, FlatViewOperator) and isinstance(op.core.op, tsp.PaddedDIA)
    _same_sidecar(op, jop)
    x = np.random.default_rng(2).standard_normal(S.shape[0]).astype(np.float32)
    np.testing.assert_allclose(op.matvec(torch.from_numpy(x)).numpy(),
                               S.astype(np.float64) @ x, rtol=2e-4, atol=2e-4)


def test_optimize_keeps_uniform_random_off_hybrid(jax_costs):
    S = sps.random(600, 600, density=0.03, random_state=1, format="csr")
    S.setdiag(S.diagonal() + 10.0)
    S = S.tocsr()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        op = tsp.optimize(tsp.csr_from_scipy(S), prefer_kernels=False, device="cpu")
        jop = jsp.optimize(jsp.csr_from_scipy(S), prefer_pallas=False)
    inner = op.inner if isinstance(op, Reordered) else op
    jinner = jop.inner if isinstance(jop, JReordered) else jop
    assert not isinstance(inner, tsp.HybridDIA)
    assert type(op).__name__ == type(jop).__name__
    assert type(inner).__name__ == type(jinner).__name__
    x = np.random.default_rng(2).standard_normal(600)
    xt = torch.from_numpy(x)
    got = op.unpad_vec(op.matvec(op.pad_vec(xt))) if hasattr(op, "pad_vec") else op.matvec(xt)
    np.testing.assert_allclose(got.numpy(), S @ x, rtol=1e-10, atol=1e-10)


def test_solve_end_to_end_on_hybrid_matches_jax(jax_costs):
    S = _poisson_plus_outliers(n_out=30)
    A, jA = tsp.csr_from_scipy(S), jsp.csr_from_scipy(S)
    b = np.random.default_rng(3).standard_normal(S.shape[0])
    kw = dict(method="bicgstab", M="jacobi", tol=1e-13, max_iter=2000)
    handle = tsp.prepare(A, device="cpu", **kw)
    x, info = handle(b)
    xj, info_j = jsp.solve(jA, b, **kw)
    assert info.converged and bool(info_j.converged)
    assert abs(info.iterations - int(info_j.iterations)) <= _band(int(info_j.iterations))
    assert np.linalg.norm(S @ x.numpy() - b) / np.linalg.norm(b) <= 1e-12
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-10, atol=1e-10)
    # the port's f64 core runs on the kernels and is priced as such, so the
    # split wins; the JAX package's f64 core is XLA's DIA, and BSR wins there,
    # as it does in the port with prefer_kernels=False
    assert isinstance(handle.operator, tsp.HybridDIA)
    assert isinstance(handle.operator.core.op, tsp.PaddedDIA)
    assert type(jsp.optimize(jA)).__name__ == "BSR"
    assert type(tsp.optimize(A, prefer_kernels=False, device="cpu")).__name__ == "BSR"
