"""Cross tests of the port's CGS and TFQMR against the JAX package's
(mirrors ``tests/test_cgs_tfqmr.py``): the random diagonally dominant
systems against a direct solve, the boundary-rhs breakdown (scipy fails
there too), the complex manufactured solution, Jacobi through ``solve``,
TFQMR's true-residual gate, the residual trace, and the padded layout.
The scipy-compat wrappers are held in ``test_torch_scipy_compat.py``, the
distributed case in ``test_torch_dist_krylov.py`` (``cgs_distributed``,
``tfqmr_distributed``).

Tolerances: the f64 fixtures keep equal counts (the recurrences see the
same sums in the same order on the CSR path), x to 1e-10 against the JAX
package's and to the direct solve's scale; the f32 padded solves hold the
count within the band of ``test_serial_parity.py:183`` (max(3, ⌈its/4⌉))
and x to 1e-4."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import scipy.sparse.linalg as spla
import torch

import sprsolve_tpu as jsp
from sprsolve_tpu.utils import problems as jprob
import sprsolve_tpu_torch as tsp
from sprsolve_tpu_torch.errors import Status
from sprsolve_tpu_torch.interop import csr_from_reference
from sprsolve_tpu_torch.utils import problems as tprob

torch.set_num_threads(2)
METHODS = ["cgs", "tfqmr"]


def _band(its):
    return max(3, -(-its // 4))


def _diag_dominant(n, seed, density=0.05):
    A = sps.random(n, n, density=density, random_state=seed)
    return (A + sps.diags(np.abs(A).sum(axis=1).A1 + 1.0)).tocsr()


def _pair(S):
    return tsp.csr_from_scipy(S), jsp.csr_from_scipy(S)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("seed", [0, 1])
def test_random_diag_dominant_matches_jax_and_direct(method, seed):
    S = _diag_dominant(120, seed)
    b = np.random.default_rng(seed + 100).standard_normal(120)
    tA, jA = _pair(S)
    x, info = getattr(tsp, method)(tA, torch.as_tensor(b), tol=1e-13, max_iter=2000)
    xj, ij = getattr(jsp, method)(jA, jnp.asarray(b), tol=1e-13, max_iter=2000)
    info.raise_if_error()
    np.testing.assert_allclose(x.numpy(), spla.spsolve(S.tocsc(), b), rtol=1e-8, atol=1e-10)
    assert info.iterations == int(ij.iterations)
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=0, atol=1e-10)


@pytest.mark.parametrize("method", METHODS)
def test_breakdown_agrees_with_jax_and_scipy(method):
    """The Dirichlet Laplacian with a boundary-supported rhs: ρ collapses,
    and the predicated BREAKDOWN fires in both packages (scipy fails too)."""
    tA = tprob.grid_laplacian_dirichlet((20, 20))
    jA = jprob.grid_laplacian_dirichlet((20, 20))
    b = np.zeros(400)
    tprob.set_boundary_condition(b, (20, 20), lambda r, c: float(r + c))
    _, info = getattr(tsp, method)(tA, torch.as_tensor(b), tol=1e-12, max_iter=800)
    _, ij = getattr(jsp, method)(jA, jnp.asarray(b), tol=1e-12, max_iter=800)
    assert info.status == Status.BREAKDOWN == int(ij.status)
    assert info.iterations == int(ij.iterations)
    S = sps.csr_matrix((tA.data.numpy(), tA.indices.numpy(), tA.indptr.numpy()),
                       shape=tA.shape)
    _, sinfo = getattr(spla, method)(S, b, rtol=1e-12, maxiter=800)
    assert sinfo != 0


@pytest.mark.parametrize("method", METHODS)
def test_complex_manufactured_solution(method):
    jA, rhs, _ = jprob.complex_symmetric_grid_with_diag((8, 8))
    tA = csr_from_reference(jA.data, jA.indices, jA.indptr, jA.shape)
    x_known = np.array([complex(i, j) for i in range(8) for j in range(8)])
    x, info = getattr(tsp, method)(tA, torch.as_tensor(rhs), tol=1e-12, max_iter=2000)
    _, ij = getattr(jsp, method)(jA, jnp.asarray(rhs), tol=1e-12, max_iter=2000)
    info.raise_if_error()
    assert np.abs(x.numpy() - x_known).max() < 1e-9
    assert abs(info.iterations - int(ij.iterations)) <= _band(int(ij.iterations))


@pytest.mark.parametrize("method", METHODS)
def test_jacobi_through_solve_matches_jax(method):
    n = 150
    S = _diag_dominant(n, 3, density=0.03) + sps.diags(np.linspace(1.0, 50.0, n))
    tA, jA = _pair(S.tocsr())
    b = np.random.default_rng(7).standard_normal(n)
    kw = dict(method=method, tol=1e-11, max_iter=3000)
    _, i0 = tsp.solve(tA, b, device="cpu", **kw)
    xp, ip = tsp.solve(tA, b, M="jacobi", device="cpu", **kw)
    xj, ij = jsp.solve(jA, b, M="jacobi", **kw)
    ip.raise_if_error()
    i0.raise_if_error()
    assert ip.iterations <= i0.iterations
    np.testing.assert_allclose(xp.numpy(), spla.spsolve(S.tocsc(), b), rtol=1e-6, atol=1e-8)
    assert abs(ip.iterations - int(ij.iterations)) <= _band(int(ij.iterations))


def test_tfqmr_true_residual_gate():
    S = _diag_dominant(120, 5)
    b = np.random.default_rng(5).standard_normal(120)
    tA, jA = _pair(S)
    x, info = tsp.tfqmr(tA, torch.as_tensor(b), tol=1e-10, max_iter=2000)
    _, ij = jsp.tfqmr(jA, jnp.asarray(b), tol=1e-10, max_iter=2000)
    info.raise_if_error()
    true = np.linalg.norm(S @ x.numpy() - b) / np.linalg.norm(b)
    assert float(info.residual) <= 1e-10
    np.testing.assert_allclose(float(info.residual), true, rtol=1e-6)
    # the same x to rounding: the reported residuals agree to f64 noise
    assert abs(float(info.residual) - float(ij.residual)) <= 1e-14


@pytest.mark.parametrize("method", METHODS)
def test_record_residuals_matches_jax(method):
    S = _diag_dominant(100, 9)
    tA, jA = _pair(S)
    b = np.random.default_rng(9).standard_normal(100)
    x, info, hist = getattr(tsp, method)(tA, torch.as_tensor(b), tol=1e-10, max_iter=400,
                                         record_residuals=True)
    _, ij, hj = getattr(jsp, method)(jA, jnp.asarray(b), tol=1e-10, max_iter=400,
                                     record_residuals=True)
    info.raise_if_error()
    h, it = hist.numpy(), info.iterations
    assert h.shape == (401,) and it == int(ij.iterations)
    assert np.isfinite(h[: it + 1]).all() and np.isnan(h[it + 1:]).all()
    assert h[0] == pytest.approx(1.0)
    np.testing.assert_allclose(h[: it + 1], np.asarray(hj)[: it + 1], rtol=1e-8)


@pytest.mark.parametrize("method", METHODS)
def test_padded_f32_matches_jax_functional(method):
    """The f32 convection-diffusion operator on the padded layouts of both
    packages (K1's plain version here; Pallas in interpret mode there)."""
    from sprsolve_tpu_torch.interop import padded_dia_from_reference, vec_from_reference

    jC = jprob.convection_diffusion3d(8, 8, 8)
    jop = jsp.optimize(jC)
    op = padded_dia_from_reference(np.asarray(jop.bands3), jop.offsets, jop.n, jop.hr,
                                   jop.shape, np.float32)
    b = np.random.default_rng(3).standard_normal(512).astype(np.float32)
    x2, info = getattr(tsp, method)(op, op.pad_vec(torch.as_tensor(b)), tol=1e-5,
                                    max_iter=300)
    xj2, ij = getattr(jsp, method)(jop, jop.pad_vec(jnp.asarray(b)), tol=1e-5, max_iter=300)
    info.raise_if_error()
    assert abs(info.iterations - int(ij.iterations)) <= _band(int(ij.iterations))
    xj = vec_from_reference(np.asarray(xj2), jop.n, jop.hr)
    np.testing.assert_allclose(op.unpad_vec(x2).numpy(), xj.numpy(), rtol=1e-4, atol=1e-4)
    assert not bool(x2[: op.h].any()) and not bool(x2[op.h + op.n:].any())
