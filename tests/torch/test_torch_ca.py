"""Cross tests of the port's s-step CG and BiCGStab against the JAX
package's (mirrors ``tests/test_ca_cg.py`` and ``tests/test_ca_bicgstab.py``):
the static basis change, parity with plain CG/BiCGStab across bases and s,
the complex cases, f32, the breakdowns, the residual trace, the zero rhs
and warm start, input validation, ``fold_jacobi``'s fold and unfold, the
Jacobi fold through ``solve`` (and a ``DiagPrecond``, which the code
refuses though the JAX package's docstring offers it), the wrong-bounds
rollback, and ``solve``'s Gershgorin default on the unpadded layout.  The
matrix-powers and distributed cases are in ``test_torch_dist_solve*.py``
(``ca_cg_mpk``); the HLO case is a TPU artefact.

Tolerances: f64 x to 1e-10 where the JAX package's x is the reference (its
count within the band of ``test_serial_parity.py:183``, max(3, ⌈its/4⌉):
the JAX package's CSR applies its basis block with one ``matmat``, the port
with one matvec per column, so the sums round apart); f32 x within the
tolerance's reach, κ·tol in norm."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch
from scipy.linalg import block_diag

import sprsolve_tpu as jsp
from sprsolve_tpu.solvers.ca_cg import _basis_change as j_basis_change
from sprsolve_tpu.solvers.ca_cg import fold_jacobi as j_fold_jacobi
from sprsolve_tpu.utils import problems as jprob
import sprsolve_tpu_torch as tsp
from sprsolve_tpu_torch.errors import IncompatibleMatrixFormat, InvalidPreconditioner, Status
from sprsolve_tpu_torch.solvers.ca_cg import _basis_change, fold_jacobi
from sprsolve_tpu_torch.utils import problems as tprob

torch.set_num_threads(2)


def _band(its):
    return max(3, -(-its // 4))


def _spd_grid(side=16):
    """The folded grid Laplacian negated (positive definite), both packages."""
    jA, _ = jprob.sym_grid_laplacian((side, side))
    jA = dataclasses.replace(jA, data=-jA.data)
    tA, _ = tprob.sym_grid_laplacian((side, side))
    tA = tsp.CSR.from_arrays(-tA.data.numpy(), tA.indices, tA.indptr, tA.shape)
    return tA, jA


def _res(dense, x, b):
    return np.linalg.norm(dense @ np.asarray(x) - b) / np.linalg.norm(b)


def _dense(A):
    return sps.csr_matrix((A.data.numpy(), A.indices.numpy(), A.indptr.numpy()),
                          shape=A.shape).toarray()


@pytest.mark.parametrize("basis,s,theta,delta", [
    ("monomial", 2, 0.0, 1.0), ("monomial", 4, 0.0, 1.0),
    ("chebyshev", 3, 4.0, 3.5), ("chebyshev", 8, 1.5, 0.25)])
def test_basis_change_equals_jax(basis, s, theta, delta):
    np.testing.assert_array_equal(_basis_change(s, basis, theta, delta),
                                  j_basis_change(s, basis, theta, delta))


@pytest.mark.parametrize("method,basis,s", [
    ("ca_cg", "monomial", 2), ("ca_cg", "chebyshev", 4), ("ca_cg", "chebyshev", 8),
    ("ca_bicgstab", "monomial", 1), ("ca_bicgstab", "chebyshev", 2)])
def test_serial_parity_and_jax(method, basis, s):
    tA, jA = _spd_grid()
    b = np.random.default_rng(3).standard_normal(256)
    bounds = tsp.gershgorin_bounds(tA)
    assert bounds == jsp.gershgorin_bounds(jA)
    plain = tsp.cg if method == "ca_cg" else tsp.bicgstab
    _, ref = plain(tA, torch.as_tensor(b), tol=1e-10, max_iter=2000)
    x, info = getattr(tsp, method)(tA, torch.as_tensor(b), s=s, basis=basis, bounds=bounds,
                                   tol=1e-10, max_iter=2000)
    xj, ij = getattr(jsp, method)(jA, jnp.asarray(b), s=s, basis=basis, bounds=bounds,
                                  tol=1e-10, max_iter=2000)
    info.raise_if_error()
    assert _res(_dense(tA), x.numpy(), b) <= 1e-10
    slack = 2 if method == "ca_cg" else max(10, ref.iterations // 5)
    assert abs(info.iterations - ref.iterations) <= slack
    assert abs(info.iterations - int(ij.iterations)) <= _band(int(ij.iterations))
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=0, atol=1e-9)


def test_complex_cases():
    jH, _ = jprob.hermitian_grid((8, 8))
    dense = -np.asarray(jH.todense()) + 6.0 * np.eye(64)
    rng = np.random.default_rng(5)
    b = rng.standard_normal(64) + 1j * rng.standard_normal(64)
    tA = tsp.csr_from_dense(dense)
    bounds = tsp.gershgorin_bounds(tA)
    x, info = tsp.ca_cg(tA, torch.as_tensor(b), s=4, bounds=bounds, tol=1e-11, max_iter=600)
    _, ij = jsp.ca_cg(jsp.csr_from_dense(dense), jnp.asarray(b), s=4, bounds=bounds,
                      tol=1e-11, max_iter=600)
    info.raise_if_error()
    assert _res(dense, x.numpy(), b) <= 1e-11
    assert abs(info.iterations - int(ij.iterations)) <= _band(int(ij.iterations))
    rng = np.random.default_rng(11)
    n = 96
    dense = (rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n)))
    dense = dense * (rng.random((n, n)) < 0.12) + np.eye(n) * (6.0 + 2.0j)
    b = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    x, info = tsp.ca_bicgstab(tsp.csr_from_dense(dense), torch.as_tensor(b), s=2,
                              tol=1e-11, max_iter=1000)
    info.raise_if_error()
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(dense, b), atol=1e-8)


@pytest.mark.parametrize("method,s", [("ca_cg", 4), ("ca_bicgstab", 2)])
def test_f32(method, s):
    tA, jA = _spd_grid(32)
    A32 = tsp.CSR.from_arrays(tA.data.numpy().astype(np.float32), tA.indices, tA.indptr,
                              tA.shape)
    jA32 = dataclasses.replace(jA, data=jA.data.astype(jnp.float32))
    b = np.random.default_rng(7).standard_normal(1024).astype(np.float32)
    x, info = getattr(tsp, method)(A32, torch.as_tensor(b), s=s, bounds=(0.0, 8.0),
                                   tol=1e-4, max_iter=2000)
    xj, ij = getattr(jsp, method)(jA32, jnp.asarray(b), s=s, bounds=(0.0, 8.0), tol=1e-4,
                                  max_iter=2000)
    info.raise_if_error()
    assert x.dtype == torch.float32
    assert _res(_dense(tA), x.numpy().astype(np.float64), b) <= 1e-4
    assert abs(info.iterations - int(ij.iterations)) <= _band(int(ij.iterations))
    # x within the tolerance's reach: ‖x − x_J‖ ≤ κ·tol·‖x_J‖ with κ ≈ 400
    # on the 32×32 grid (BiCGStab's f32 steps round apart; CG's stay close)
    xj = np.asarray(xj)
    assert np.linalg.norm(x.numpy() - xj) <= 400 * 1e-4 * np.linalg.norm(xj)


def test_breakdowns_as_jax():
    tA, rhs = tprob.sym_grid_laplacian((8, 8))
    jA, _ = jprob.sym_grid_laplacian((8, 8))
    _, info = tsp.ca_cg(tA, torch.as_tensor(rhs), s=4, tol=1e-10, max_iter=100)
    _, ij = jsp.ca_cg(jA, jnp.asarray(rhs), s=4, tol=1e-10, max_iter=100)
    assert info.status == Status.BREAKDOWN == int(ij.status)
    # a skew-symmetric A makes ⟨r̃₀, A·r̃₀⟩ vanish; with b zero on the odd
    # rows every product in that dot is exactly 0, so the breakdown does not
    # hang on the order in which a Gram product sums (the JAX package's
    # test draws a dense b, whose terms cancel only in its own order)
    skew = block_diag(*[np.array([[0.0, 1.0], [-1.0, 0.0]])] * 32)
    b = np.random.default_rng(0).standard_normal(64)
    b[1::2] = 0.0
    _, info = tsp.ca_bicgstab(tsp.csr_from_dense(skew), torch.as_tensor(b), s=2, tol=1e-10,
                              max_iter=100)
    _, ij = jsp.ca_bicgstab(jsp.csr_from_dense(skew), jnp.asarray(b), s=2, tol=1e-10,
                            max_iter=100)
    assert info.status == Status.BREAKDOWN == int(ij.status)
    assert info.iterations == int(ij.iterations)


@pytest.mark.parametrize("method,s", [("ca_cg", 4), ("ca_bicgstab", 2)])
def test_residual_history_boundary(method, s):
    tA, jA = _spd_grid(32)
    b = np.random.default_rng(3).standard_normal(1024)
    x, info, hist = getattr(tsp, method)(tA, torch.as_tensor(b), s=s, bounds=(0.0, 8.0),
                                         tol=1e-10, max_iter=2000, record_residuals=True)
    info.raise_if_error()
    its, vals = info.iterations, hist.numpy()
    assert hist.shape == (2001,)
    assert np.isfinite(vals[: its - 1]).all() and np.isnan(vals[its + 1:]).all()


@pytest.mark.parametrize("method", ["ca_cg", "ca_bicgstab"])
def test_zero_rhs_warm_start_and_validation(method):
    tA, _ = _spd_grid(16)
    fn = getattr(tsp, method)
    x, info = fn(tA, torch.zeros(256, dtype=torch.float64), s=2, tol=1e-10, max_iter=50)
    assert info.status == Status.CONVERGED and info.iterations == 0 and not bool(x.any())
    b = torch.as_tensor(np.random.default_rng(1).standard_normal(256))
    x1, _ = fn(tA, b, s=2, tol=1e-12, max_iter=500)
    _, info_w = fn(tA, b, x1, s=2, tol=1e-10, max_iter=50)
    assert info_w.status == Status.CONVERGED and info_w.iterations <= 2
    with pytest.raises(IncompatibleMatrixFormat):
        fn(tA, torch.zeros((16, 16), dtype=torch.float64), s=2, tol=1e-6, max_iter=10)
    with pytest.raises(ValueError, match="s >= 1"):
        fn(tA, b, s=0, tol=1e-6, max_iter=10)
    with pytest.raises(ValueError, match="bounds"):
        fn(tA, b, s=2, basis="chebyshev", tol=1e-6, max_iter=10)
    with pytest.raises(ValueError, match="unknown basis"):
        fn(tA, b, s=2, basis="legendre", tol=1e-6, max_iter=10)
    # a padded kernel layout is refused, as the JAX package refuses its 2-D vectors
    op = tsp.optimize(tprob.poisson3d(4, 4, 4), device="cpu")
    with pytest.raises(IncompatibleMatrixFormat, match="padded"):
        fn(op, op.pad_vec(torch.ones(64)), s=2, tol=1e-6, max_iter=10)


def test_wrong_bounds_never_returns_poisoned_x():
    tA = tprob.grid_laplacian_dirichlet((20, 20))
    rhs = np.zeros(400)
    tprob.set_boundary_condition(rhs, (20, 20), lambda r, c: float(r + c))
    x, info = tsp.ca_bicgstab(tA, torch.as_tensor(rhs), s=2, bounds=(0.0, 9.0), tol=1e-10,
                              max_iter=2000)
    tr = _res(_dense(tA), x.numpy(), rhs)
    np.testing.assert_allclose(float(info.residual), tr, rtol=1e-6)
    assert tr < 1.0
    if info.status == Status.CONVERGED:
        assert tr <= 1e-10


def test_fold_jacobi_folds_and_unfolds_as_jax():
    tA = tprob.poisson3d(5, 5, 5, dtype=np.float64)
    jA = jprob.poisson3d(5, 5, 5, dtype=np.float64)
    rng = np.random.default_rng(2)
    b, x0 = rng.standard_normal(125), rng.standard_normal(125)
    A_s, b_s, x0_s, unfold = fold_jacobi(tA, torch.as_tensor(b), torch.as_tensor(x0))
    jA_s, jb_s, jx0_s, junfold = j_fold_jacobi(jA, jnp.asarray(b), jnp.asarray(x0))
    np.testing.assert_array_equal(A_s.data.numpy(), np.asarray(jA_s.data))
    np.testing.assert_array_equal(b_s.numpy(), np.asarray(jb_s))
    np.testing.assert_array_equal(x0_s.numpy(), np.asarray(jx0_s))
    np.testing.assert_allclose(unfold(x0_s).numpy(), x0, rtol=1e-15)
    np.testing.assert_array_equal(unfold(b_s).numpy(), np.asarray(junfold(jb_s)))
    # the scaled matrix has a unit diagonal
    np.testing.assert_allclose(A_s.diagonal().numpy(), 1.0, rtol=1e-15)


def _scaled_grid(side=16):
    tA, jA = _spd_grid(side)
    n = side * side
    scale = np.logspace(0, 4, n)[np.random.default_rng(0).permutation(n)]
    S = sps.csr_matrix((tA.data.numpy(), tA.indices.numpy(), tA.indptr.numpy()), shape=tA.shape)
    D = sps.diags(np.sqrt(scale))
    S2 = (D @ S @ D).tocsr()
    return S2, tsp.csr_from_scipy(S2), jsp.csr_from_scipy(S2)


def test_jacobi_fold_through_solve_matches_jax_and_pcg():
    """``solve(method="ca_cg", M="jacobi")`` folds the Jacobi into the
    system: Jacobi-CG's convergence, tol in the scaled norm, x of the
    ORIGINAL system; the same through prepare(), and JAX's count."""
    S2, tA, jA = _scaled_grid()
    b = np.random.default_rng(3).standard_normal(S2.shape[0])
    _, pcg = tsp.cg(tA, torch.as_tensor(b), M=tsp.DiagPrecond.new(tA.diagonal()), tol=1e-10,
                    max_iter=4000)
    kw = dict(method="ca_cg", s=4, tol=1e-10, max_iter=4000)
    x, info = tsp.solve(tA, b, M="jacobi", device="cpu", **kw)
    xj, ij = jsp.solve(jA, b, M="jacobi", **kw)
    _, plain = tsp.solve(tA, b, device="cpu", **kw)
    info.raise_if_error()
    d = S2.diagonal()
    r = S2 @ x.numpy() - b
    assert np.linalg.norm(r / np.sqrt(d)) / np.linalg.norm(b / np.sqrt(d)) <= 1e-10
    assert np.linalg.norm(r) / np.linalg.norm(b) <= 1e-7
    assert abs(info.iterations - pcg.iterations) <= 6
    assert info.iterations < plain.iterations * 0.6
    assert abs(info.iterations - int(ij.iterations)) <= _band(int(ij.iterations))
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-6, atol=1e-8)
    handle = tsp.prepare(tA, M="jacobi", device="cpu", **kw)
    assert isinstance(handle.operator, tsp.DIA)
    x2, info2 = handle(b)
    assert torch.equal(x, x2) and info2.iterations == info.iterations


@pytest.mark.parametrize("method", ["ca_cg", "ca_bicgstab"])
def test_preconditioners_the_s_step_pipeline_refuses(method):
    """The JAX package's docstring says a real DiagPrecond is accepted; its
    code folds only M="jacobi" (``sprsolve_tpu/api.py:155``). The port
    follows the code: a DiagPrecond raises, as does any M for ca_bicgstab."""
    tA, jA = _spd_grid(8)
    b = np.ones(64)
    M = tsp.DiagPrecond.new(tA.diagonal())
    with pytest.raises(InvalidPreconditioner, match="s-step"):
        tsp.solve(tA, b, method=method, M=M, device="cpu")
    with pytest.raises(Exception):
        jsp.solve(jA, b, method=method, M=jsp.DiagPrecond.new(jA.diagonal()))
    if method == "ca_bicgstab":
        with pytest.raises(InvalidPreconditioner):
            tsp.solve(tA, b, method=method, M="jacobi", device="cpu")
    with pytest.raises(InvalidPreconditioner):
        tsp.solve(tA, b, method=method, M="ilu0", device="cpu")


@pytest.mark.parametrize("method", ["ca_cg", "ca_bicgstab"])
def test_solve_defaults_to_gershgorin_on_the_unpadded_layout(method):
    """solve() runs the s-step pair on the unpadded DIA with Gershgorin
    bounds (the f32 banded matrix does not go to the PaddedDIA)."""
    from sprsolve_tpu_torch.ops import padded_dia as pd

    tA = tprob.poisson3d(8, 8, 8)
    jA = jprob.poisson3d(8, 8, 8)
    b = np.random.default_rng(1).standard_normal(512).astype(np.float32)
    handle = tsp.prepare(tA, method=method, tol=1e-5, max_iter=1000, device="cpu")
    assert isinstance(handle.operator, tsp.DIA)
    assert handle._run.keywords["bounds"] == tsp.gershgorin_bounds(tA)
    pd.reset_launch_counts()
    x, info = handle(b)
    xj, ij = jsp.solve(jA, b, method=method, tol=1e-5, max_iter=1000)
    info.raise_if_error()
    assert _res(_dense(tA).astype(np.float64), x.numpy().astype(np.float64), b) <= 1e-5
    assert abs(info.iterations - int(ij.iterations)) <= _band(int(ij.iterations))
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-4, atol=1e-4)
