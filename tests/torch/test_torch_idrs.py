"""Cross tests of the port's IDR(s) against the JAX package's (mirrors
``tests/test_idrs.py``): the dense-solve oracle, the reference workload
and its matvec economy, s = 1 and 8, ILU(0) preconditioning, the complex
system, ``solve`` with Jacobi, the zero rhs and the warm start, the padded
layout, the true-residual restart under f32 drift, and the shadow-traffic
warning.

The JAX package draws the shadow space from ``jax.random.key(7)``; torch
cannot reproduce that draw, so these tests monkeypatch the port's
``_shadow_space`` with the JAX package's P, as numpy, and hold the port to
JAX's count: equal where the two stay in step (the f64 dense oracle and the
Jacobi solve at tol 1e-12), within the band of ``test_serial_parity.py:183``
(max(3, ⌈its/4⌉)) elsewhere; x to 1e-10 in f64.  One test checks
the port's own P: orthonormal, and the same from run to run."""

import importlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

import sprsolve_tpu as jsp
from sprsolve_tpu.utils import problems as jprob
import sprsolve_tpu_torch as tsp
from sprsolve_tpu_torch.interop import csr_from_reference
from sprsolve_tpu_torch.utils import problems as tprob

torch.set_num_threads(2)
# the module, not the function the solvers package exports under its name
tidrs = importlib.import_module("sprsolve_tpu_torch.solvers.idrs")


def _band(its):
    return max(3, -(-its // 4))


def _jax_shadow_space(n, s, dtype, device):
    """The JAX package's P (``sprsolve_tpu/solvers/idrs.py:130-139``)."""
    cplx = dtype.is_complex
    rdt = jnp.float64 if dtype in (torch.float64, torch.complex128) else jnp.float32
    key = jax.random.key(7)
    P = jax.random.normal(key, (n, s), dtype=rdt)
    if cplx:
        P = P + 1j * jax.random.normal(jax.random.fold_in(key, 1), (n, s), dtype=rdt)
    P, _ = jnp.linalg.qr(P)
    return torch.as_tensor(np.asarray(P)).to(dtype).to(device)


@pytest.fixture
def jax_p(monkeypatch):
    monkeypatch.setattr(tidrs, "_shadow_space", _jax_shadow_space)


def _dirichlet(shape=(20, 20)):
    tA = tprob.grid_laplacian_dirichlet(shape)
    jA = jprob.grid_laplacian_dirichlet(shape)
    b = np.zeros(shape[0] * shape[1])
    tprob.set_boundary_condition(b, shape, lambda r, c: float(r + c))
    return tA, jA, b


def _rel_res(A, x, b):
    y = A.matvec(torch.as_tensor(np.asarray(x), dtype=torch.float64)).numpy()
    return np.linalg.norm(y - b) / np.linalg.norm(b)


def test_matches_dense_solve_nonsymmetric(jax_p):
    rng = np.random.default_rng(0)
    n = 120
    dense = rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.15) + np.eye(n) * 6.0
    b = rng.standard_normal(n)
    x, info = tsp.idrs(tsp.csr_from_dense(dense), torch.as_tensor(b), tol=1e-12,
                       max_iter=2000)
    _, ij = jsp.idrs(jsp.csr_from_dense(dense), jnp.asarray(b), tol=1e-12, max_iter=2000)
    info.raise_if_error()
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(dense, b), atol=1e-9)
    assert info.iterations == int(ij.iterations)


def test_reference_workload_and_matvec_economy(jax_p):
    tA, jA, b = _dirichlet()
    x, info = tsp.idrs(tA.to_dia(), torch.as_tensor(b), s=4, tol=1e-13, max_iter=3000)
    xj, ij = jsp.idrs(jA.to_dia(), jnp.asarray(b), s=4, tol=1e-13, max_iter=3000)
    info.raise_if_error()
    assert _rel_res(tA, x, b) < 1e-11
    # tol 1e-13 sits at the f64 floor of this grid: a restart or two apart
    assert abs(info.iterations - int(ij.iterations)) <= _band(int(ij.iterations))
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=0, atol=1e-10)
    _, info_b = tsp.bicgstab(tA.to_dia(), torch.as_tensor(b), tol=1e-13, max_iter=3000)
    assert info.iterations <= info_b.iterations * 2 * 1.5


@pytest.mark.parametrize("s", [1, 8])
def test_s1_and_s8_converge_as_jax(jax_p, s):
    tA, jA, b = _dirichlet((12, 12))
    x, info = tsp.idrs(tA, torch.as_tensor(b), s=s, tol=1e-12, max_iter=3000)
    _, ij = jsp.idrs(jA, jnp.asarray(b), s=s, tol=1e-12, max_iter=3000)
    info.raise_if_error()
    assert _rel_res(tA, x, b) < 1e-10
    assert abs(info.iterations - int(ij.iterations)) <= _band(int(ij.iterations))


def test_ilu0_preconditioned(jax_p):
    tA, jA, b = _dirichlet()
    x, info = tsp.idrs(tA, torch.as_tensor(b), M=tsp.ILU0Precond.from_csr(tA, device="cpu"),
                       tol=1e-13, max_iter=3000)
    _, info_0 = tsp.idrs(tA, torch.as_tensor(b), tol=1e-13, max_iter=3000)
    _, ij = jsp.idrs(jA, jnp.asarray(b), M=jsp.ILU0Precond.from_csr(jA), tol=1e-13,
                     max_iter=3000)
    info.raise_if_error()
    assert info.iterations < info_0.iterations
    assert _rel_res(tA, x, b) < 1e-11
    assert abs(info.iterations - int(ij.iterations)) <= _band(int(ij.iterations))


def test_complex_system(jax_p):
    jA, rhs, _ = jprob.complex_symmetric_grid_with_diag((8, 8))
    tA = csr_from_reference(jA.data, jA.indices, jA.indptr, jA.shape)
    x, info = tsp.idrs(tA, torch.as_tensor(rhs), tol=1e-12, max_iter=3000)
    _, ij = jsp.idrs(jA, jnp.asarray(rhs), tol=1e-12, max_iter=3000)
    info.raise_if_error()
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(np.asarray(jA.todense()), rhs),
                               atol=1e-8)
    assert abs(info.iterations - int(ij.iterations)) <= _band(int(ij.iterations))


def test_solve_with_jacobi_matches_jax(monkeypatch):
    tA, jA, b = _dirichlet((16, 16))
    kw = dict(method="idrs", M="jacobi", tol=1e-12, max_iter=3000, s=4)
    # solve() runs the port on the f64 PaddedDIA, the JAX package on XLA's
    # DIA: the port's shadow space is JAX's (n, s) P with zero halo and tail
    # rows, the same projections in the padded layout
    op = tsp.optimize(tA, device="cpu")
    assert isinstance(op, tsp.PaddedDIA)
    monkeypatch.setattr(tidrs, "_shadow_space", lambda n, s, dtype, device: op.pad_block(
        _jax_shadow_space(op.n, s, dtype, device)))
    x, info = tsp.solve(tA, b, device="cpu", **kw)
    xj, ij = jsp.solve(jA, b, **kw)
    info.raise_if_error()
    assert _rel_res(tA, x, b) < 1e-10
    assert info.iterations == int(ij.iterations)
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=0, atol=1e-9)


def test_zero_rhs_and_warm_start(jax_p):
    tA, _, b = _dirichlet((10, 10))
    x, info = tsp.idrs(tA, torch.zeros(100, dtype=torch.float64), tol=1e-10, max_iter=100)
    assert info.iterations == 0 and not bool(x.any())
    x1, _ = tsp.idrs(tA, torch.as_tensor(b), tol=1e-13, max_iter=3000)
    _, info_w = tsp.idrs(tA, torch.as_tensor(b), x1, tol=1e-10, max_iter=100)
    info_w.raise_if_error()
    assert info_w.iterations <= 2


def test_padded_kernel_layout():
    """solve() lays the f32 grid out as a PaddedDIA: the shadow algebra rides
    its padded vectors (the port's own P; JAX's is of another length)."""
    tA, jA, b = _dirichlet((16, 16))
    A32 = tsp.CSR.from_arrays(tA.data.numpy().astype(np.float32), tA.indices, tA.indptr,
                              tA.shape)
    kw = dict(method="idrs", M="jacobi", tol=1e-5, max_iter=2000)
    x, info = tsp.solve(A32, b.astype(np.float32), device="cpu", **kw)
    info.raise_if_error()
    assert isinstance(tsp.prepare(A32, device="cpu", **kw).operator, tsp.PaddedDIA)
    assert _rel_res(tA, x.double(), b) < 1e-4


def test_true_residual_restart_converges_under_f32_drift(jax_p):
    n = 140
    S = sps.random(n, n, density=0.04, random_state=0)
    S = (S + sps.diags(np.abs(S).sum(axis=1).A1 + 1.0)).tocsr().astype(np.float32)
    b = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    kw = dict(method="idrs", M="jacobi", tol=1e-5, max_iter=4000)
    x, info = tsp.solve(tsp.csr_from_scipy(S), b, device="cpu", optimize_layout=False, **kw)
    _, ij = jsp.solve(jsp.csr_from_scipy(S), b, optimize_layout=False, **kw)
    info.raise_if_error()
    r = S @ x.numpy().astype(np.float64) - b
    assert np.linalg.norm(r) / np.linalg.norm(b) <= 2e-5
    assert info.iterations < 4000
    assert abs(info.iterations - int(ij.iterations)) <= _band(int(ij.iterations))


def test_warns_when_shadow_traffic_dominates():
    tA, _, b = _dirichlet((12, 12))
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        tsp.idrs(tA.to_dia(), torch.as_tensor(b), s=4, tol=1e-8, max_iter=200)
    assert any("shadow-space" in str(x.message) for x in w)
    # the message quotes stream counts, no measured time
    assert not any("µs" in str(x.message) for x in w)
    n = 256
    dense = np.diag(np.full(n, 64.0)) + np.random.default_rng(0).standard_normal((n, n)) * 0.1
    Ab = tsp.BSR.from_csr(tsp.csr_from_dense(dense), bs=64)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        tsp.idrs(Ab, torch.ones(n, dtype=torch.float64), s=4, tol=1e-6, max_iter=50)
    assert not any("shadow-space" in str(x.message) for x in w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.complex128])
def test_own_shadow_space_is_orthonormal_and_fixed(dtype):
    P = tidrs._shadow_space(300, 4, dtype, "cpu")
    assert P.shape == (300, 4) and P.dtype == dtype
    G = (P.conj().T @ P).to(torch.complex128)
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    assert float((G - torch.eye(4, dtype=torch.complex128)).abs().max()) < tol
    assert torch.equal(P, tidrs._shadow_space(300, 4, dtype, "cpu"))
