"""Cross tests of the port's GMRES and FGMRES against the JAX package's
(mirrors ``tests/test_gmres.py`` and ``tests/test_fgmres.py``): the
nonsymmetric convection-diffusion grid, full GMRES's n-step exactness,
restart, right preconditioning, the complex manufactured solution, the
exits (insufficient budget, zero rhs), the residual trace, the padded
layout through ``solve``, the ``GMRES`` handle, FGMRES = right GMRES under
a fixed M, FGMRES with ``InnerSolvePrecond`` (the inner-method whitelist
included), and plain GMRES with that M.  The distributed cases are in
``test_torch_dist_solve.py`` (``gmres_dia``) and ``test_torch_dist_krylov.py``
(``fgmres_with_inner_cg``), the scipy-compat wrapper in
``test_torch_scipy_compat.py``.

Tolerances: the f64 and c128 fixtures converge in the same number of steps
in both packages (GMRES's residual is monotone, so rounding moves no exit
here): equal counts, x to 1e-10; the Hermitian grid at tol 1e-12 takes 5
restarts and lands within the band, x to 1e-9.  The f32 solves through ``solve()`` hold
the count within the band of ``test_serial_parity.py:183``
(max(3, ⌈its/4⌉)) and x to 1e-4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sprsolve_tpu as jsp
from sprsolve_tpu.utils import problems as jprob
import sprsolve_tpu_torch as tsp
from sprsolve_tpu_torch.errors import InsufficientIterNum, InvalidPreconditioner, Status
from sprsolve_tpu_torch.interop import csr_from_reference
from sprsolve_tpu_torch.utils import problems as tprob

torch.set_num_threads(2)


def _band(its):
    return max(3, -(-its // 4))


def _convection_diffusion(nx, ny, wind=20.0):
    """Nonsymmetric upwinded convection-diffusion on an (nx, ny) grid."""
    n = nx * ny
    A = np.zeros((n, n))
    for r in range(ny):
        for c in range(nx):
            i = r * nx + c
            A[i, i] = 4.0 + wind / nx
            if c > 0:
                A[i, i - 1] = -1.0 - wind / nx
            if c + 1 < nx:
                A[i, i + 1] = -1.0
            if r > 0:
                A[i, i - nx] = -1.0
            if r + 1 < ny:
                A[i, i + nx] = -1.0
    return A


def _pair(dense):
    return tsp.csr_from_dense(dense), jsp.csr_from_dense(dense)


def _true_res(dense, x, b):
    return np.linalg.norm(dense @ np.asarray(x) - b) / np.linalg.norm(b)


def _same(x, xj, its, its_j, tol=1e-10):
    assert its == its_j
    np.testing.assert_allclose(np.asarray(x), np.asarray(xj), rtol=0, atol=tol)


@pytest.mark.parametrize("restart", [30, 10])
def test_nonsymmetric_converges_as_jax(restart):
    dense = _convection_diffusion(12, 12)
    tA, jA = _pair(dense)
    b = np.random.default_rng(0).standard_normal(144)
    x, info = tsp.gmres(tA, torch.as_tensor(b), tol=1e-10, max_iter=500, restart=restart)
    xj, ij = jsp.gmres(jA, jnp.asarray(b), tol=1e-10, max_iter=500, restart=restart)
    info.raise_if_error()
    _same(x, xj, info.iterations, int(ij.iterations))
    assert _true_res(dense, x.numpy(), b) < 1e-9
    assert abs(float(info.residual) - float(ij.residual)) < 1e-12


def test_full_is_exact_in_n_steps():
    rng = np.random.default_rng(1)
    n = 24
    dense = np.eye(n) * 3.0 + 0.5 * rng.standard_normal((n, n))
    b = rng.standard_normal(n)
    tA, jA = _pair(dense)
    x, info = tsp.gmres(tA, torch.as_tensor(b), tol=1e-12, max_iter=2 * n, restart=n)
    xj, ij = jsp.gmres(jA, jnp.asarray(b), tol=1e-12, max_iter=2 * n, restart=n)
    info.raise_if_error()
    assert info.iterations <= n
    _same(x, xj, info.iterations, int(ij.iterations))


def test_restart_needs_more_iterations():
    dense = _convection_diffusion(10, 10)
    b = np.random.default_rng(2).standard_normal(100)
    tA, _ = _pair(dense)
    _, full = tsp.gmres(tA, torch.as_tensor(b), tol=1e-10, max_iter=400, restart=100)
    _, r10 = tsp.gmres(tA, torch.as_tensor(b), tol=1e-10, max_iter=400, restart=10)
    full.raise_if_error()
    r10.raise_if_error()
    assert r10.iterations >= full.iterations


def test_jacobi_right_preconditioning_matches_jax():
    dense = _convection_diffusion(12, 12, wind=40.0) * np.linspace(1.0, 50.0, 144)[:, None]
    tA, jA = _pair(dense)
    b = np.random.default_rng(3).standard_normal(144)
    M = tsp.DiagPrecond.new(tA.diagonal())
    Mj = jsp.DiagPrecond.new(jnp.asarray(np.diag(dense)))
    x, info = tsp.gmres(tA, torch.as_tensor(b), M=M, tol=1e-10, max_iter=600, restart=25)
    xj, ij = jsp.gmres(jA, jnp.asarray(b), M=Mj, tol=1e-10, max_iter=600, restart=25)
    _, plain = tsp.gmres(tA, torch.as_tensor(b), tol=1e-10, max_iter=600, restart=25)
    info.raise_if_error()
    _same(x, xj, info.iterations, int(ij.iterations), tol=1e-9)
    assert info.iterations < plain.iterations


def test_complex_manufactured_solution():
    A, rhs = tprob.hermitian_grid((8, 8))
    jA, _ = jprob.hermitian_grid((8, 8))
    x_known = np.array([complex(r, c) for r in range(8) for c in range(8)])
    x, info = tsp.gmres(A, torch.as_tensor(rhs), tol=1e-12, max_iter=300, restart=40)
    xj, ij = jsp.gmres(jA, jnp.asarray(rhs), tol=1e-12, max_iter=300, restart=40)
    info.raise_if_error()
    np.testing.assert_allclose(x.numpy(), x_known, atol=1e-9)
    # 5 restarts at tol 1e-12: the exit lands a step apart, within the band
    assert abs(info.iterations - int(ij.iterations)) <= _band(int(ij.iterations))
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), atol=1e-9)


def test_insufficient_iter_and_zero_rhs():
    dense = _convection_diffusion(12, 12)
    tA, jA = _pair(dense)
    x, info = tsp.gmres(tA, torch.ones(144, dtype=torch.float64), tol=1e-14, max_iter=5,
                        restart=3)
    _, ij = jsp.gmres(jA, jnp.ones(144), tol=1e-14, max_iter=5, restart=3)
    assert info.status == Status.INSUFFICIENT_ITER == int(ij.status)
    assert info.iterations == 5 == int(ij.iterations)
    with pytest.raises(InsufficientIterNum):
        info.raise_if_error()
    tA6, _ = _pair(_convection_diffusion(6, 6))
    for fn in (tsp.gmres, tsp.fgmres):
        x, info = fn(tA6, torch.zeros(36, dtype=torch.float64), tol=1e-10, max_iter=50)
        assert info.status == Status.CONVERGED and info.iterations == 0
        assert not bool(x.any())


@pytest.mark.parametrize("fn", ["gmres", "fgmres"])
def test_record_residuals_matches_jax(fn):
    dense = _convection_diffusion(8, 8)
    tA, jA = _pair(dense)
    b = np.random.default_rng(5).standard_normal(64)
    x, info, hist = getattr(tsp, fn)(tA, torch.as_tensor(b), tol=1e-10, max_iter=200,
                                     restart=20, record_residuals=True)
    _, ij, hj = getattr(jsp, fn)(jA, jnp.asarray(b), tol=1e-10, max_iter=200, restart=20,
                                 record_residuals=True)
    info.raise_if_error()
    k = info.iterations
    h = hist.numpy()
    assert h.shape == (200,) and k == int(ij.iterations)
    assert np.all(np.isfinite(h[:k])) and np.all(np.isnan(h[k:]))
    assert h[k - 1] <= 1e-10
    np.testing.assert_allclose(h[:k], np.asarray(hj)[:k], rtol=1e-6)


def test_solve_padded_layout_f32_matches_jax():
    """solve(method='gmres') through optimize(): the f32 banded matrix lands
    on the PaddedDIA, whose padded vectors the basis holds raveled."""
    A = jprob.grid_laplacian_dirichlet((16, 16))
    dense32 = np.asarray(A.todense()).astype(np.float32)
    tA, jA = _pair(dense32)
    rhs = np.zeros(256, np.float32)
    jprob.set_boundary_condition(rhs, (16, 16), lambda r, c: float(r + c))
    kw = dict(method="gmres", tol=1e-6, max_iter=600, restart=40)
    x, info = tsp.solve(tA, rhs, device="cpu", **kw)
    xj, ij = jsp.solve(jA, rhs, **kw)
    info.raise_if_error()
    assert isinstance(tsp.prepare(tA, device="cpu", **kw).operator, tsp.PaddedDIA)
    assert abs(info.iterations - int(ij.iterations)) <= _band(int(ij.iterations))
    assert _true_res(np.asarray(A.todense()), x.numpy(), rhs) < 1e-5
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-4, atol=1e-4)


def test_gmres_handle_matches_jax():
    dense = _convection_diffusion(10, 10)
    tA, jA = _pair(dense)
    b = np.random.default_rng(6).standard_normal(100)
    h = tsp.GMRES.new(tA, 100, restart=25, device="cpu")
    assert h.restart == 25
    x, (its, res) = h.solve(b, max_iter=400, tol=1e-10)
    xj, (its_j, _) = jsp.GMRES.new(jA, 100, restart=25).solve(b, max_iter=400, tol=1e-10)
    _same(x, xj, its, its_j)
    M = tsp.DiagPrecond.new(tA.diagonal())
    xp, (its_p, _) = h.precond_solve(M, b, max_iter=400, tol=1e-10)
    xpj, (its_pj, _) = jsp.GMRES.new(jA, 100, restart=25).precond_solve(
        jsp.DiagPrecond.new(jA.diagonal()), b, max_iter=400, tol=1e-10)
    _same(xp, xpj, its_p, its_pj)
    with pytest.raises(InsufficientIterNum):
        h.solve(b, max_iter=3, tol=1e-14)


def test_fgmres_fixed_linear_m_is_right_gmres():
    """With a constant linear M FGMRES and right GMRES take the same steps
    (Saad 1993, Prop. 2.2), in both packages."""
    dense = _convection_diffusion(12, 12)
    tA, jA = _pair(dense)
    b = np.random.default_rng(0).standard_normal(144)
    M = tsp.DiagPrecond.new(tA.diagonal())
    xg, ig = tsp.gmres(tA, torch.as_tensor(b), M=M, tol=1e-10, max_iter=400, restart=30)
    xf, if_ = tsp.fgmres(tA, torch.as_tensor(b), M=M, tol=1e-10, max_iter=400, restart=30)
    xfj, ifj = jsp.fgmres(jA, jnp.asarray(b), M=jsp.DiagPrecond.new(jA.diagonal()),
                          tol=1e-10, max_iter=400, restart=30)
    assert if_.status == Status.CONVERGED and if_.iterations == ig.iterations
    np.testing.assert_allclose(xf.numpy(), xg.numpy(), rtol=0, atol=1e-8)
    _same(xf, xfj, if_.iterations, int(ifj.iterations))


def test_fgmres_inner_cg_matches_jax():
    """Eight Jacobi-CG steps as M cut FGMRES's outer count by more than 4×
    on the SPD grid; the count and x are JAX's (the inner solve is the
    same CG)."""
    A = jprob.sym_grid_laplacian((24, 24))[0]
    dense = -np.asarray(A.todense())
    tA, jA = _pair(dense)
    b = np.random.default_rng(1).standard_normal(576)
    _, plain = tsp.fgmres(tA, torch.as_tensor(b), tol=1e-8, max_iter=600, restart=30)
    M = tsp.InnerSolvePrecond(tA, inner_M=tsp.DiagPrecond.new(tA.diagonal()), method="cg",
                              iters=8)
    Mj = jsp.InnerSolvePrecond(jA, inner_M=jsp.DiagPrecond.new(jA.diagonal()),
                               method="cg", iters=8)
    xf, flex = tsp.fgmres(tA, torch.as_tensor(b), M=M, tol=1e-8, max_iter=600, restart=30)
    xfj, fj = jsp.fgmres(jA, jnp.asarray(b), M=Mj, tol=1e-8, max_iter=600, restart=30)
    assert flex.status == Status.CONVERGED
    assert _true_res(dense, xf.numpy(), b) < 1e-7
    assert flex.iterations * 4 < plain.iterations
    _same(xf, xfj, flex.iterations, int(fj.iterations), tol=1e-9)


@pytest.mark.parametrize("method,inner_tol", [("cg", 0.3), ("bicgstab", 0.0)])
def test_fgmres_variable_inner_solve_reports_the_true_residual(method, inner_tol):
    """A tolerance-exiting inner CG (and an inner BiCGStab on the
    nonsymmetric grid) make M vary per apply; FGMRES's reported residual is
    the true one of its x."""
    if method == "cg":
        dense = -np.asarray(jprob.sym_grid_laplacian((20, 20))[0].todense())
    else:
        dense = _convection_diffusion(14, 14, wind=40.0)
    tA, jA = _pair(dense)
    b = np.random.default_rng(2).standard_normal(dense.shape[0])
    M = tsp.InnerSolvePrecond(tA, method=method, iters=6, inner_tol=inner_tol)
    x, info = tsp.fgmres(tA, torch.as_tensor(b), M=M, tol=1e-9, max_iter=300, restart=25)
    _, ij = jsp.fgmres(jA, jnp.asarray(b), M=jsp.InnerSolvePrecond(
        jA, method=method, iters=6, inner_tol=inner_tol), tol=1e-9, max_iter=300, restart=25)
    assert info.status == Status.CONVERGED
    tr = _true_res(dense, x.numpy(), b)
    assert tr < 1e-8 and abs(tr - float(info.residual)) <= 1e-12
    assert abs(info.iterations - int(ij.iterations)) <= _band(int(ij.iterations))


def test_inner_solve_on_the_padded_operator_runs_through_prepare():
    """prepare(op, method="fgmres", M=InnerSolvePrecond(A=op)) on the f32
    PaddedDIA: the M built on the operator itself is not relayed, and the
    inner CG runs the operator's fused dot (K3).  (The JAX package's
    prepare() wraps this M in RelayedPrecond and fails; its functional
    fgmres takes the same M, and that is the reference here.)"""
    from sprsolve_tpu_torch.ops import padded_dia as pd

    tP, jP = tprob.poisson3d(8, 8, 8), jprob.poisson3d(8, 8, 8)
    b = np.random.default_rng(3).standard_normal(512).astype(np.float32)
    op, jop = tsp.optimize(tP, device="cpu"), jsp.optimize(jP)
    M = tsp.InnerSolvePrecond(A=op, method="cg", iters=8)
    handle = tsp.prepare(op, method="fgmres", M=M, tol=1e-5, max_iter=200, device="cpu")
    assert handle._run.keywords["M"] is M
    calls = []
    orig = op.matvec_dot
    object.__setattr__(op, "matvec_dot", lambda x: calls.append(1) or orig(x))
    x, info = handle(b)
    object.__delattr__(op, "matvec_dot")
    xj, ij = jsp.fgmres(jop, jop.pad_vec(jnp.asarray(b)), M=jsp.InnerSolvePrecond(
        A=jop, method="cg", iters=8), tol=1e-5, max_iter=200)
    assert info.converged and bool(ij.converged)
    assert abs(info.iterations - int(ij.iterations)) <= _band(int(ij.iterations))
    assert len(calls) == 8 * info.iterations
    np.testing.assert_allclose(x.numpy(), np.asarray(jop.unpad_vec(xj)), rtol=1e-4,
                               atol=1e-4)
    assert pd.dia_dot.launches == 0   # on the CPU the plain version runs


def test_plain_gmres_with_inner_solve_m_is_documented_not_asserted():
    """Plain GMRES rebuilds x through one more apply of a nonlinear M: the
    reported residual need not be the true residual's recurrence.  Both
    packages take the same course on this fixture."""
    dense = -np.asarray(jprob.sym_grid_laplacian((12, 12))[0].todense())
    tA, jA = _pair(dense)
    b = np.random.default_rng(4).standard_normal(144)
    M = tsp.InnerSolvePrecond(tA, method="cg", iters=4, inner_tol=0.3)
    x, info = tsp.gmres(tA, torch.as_tensor(b), M=M, tol=1e-8, max_iter=60, restart=20)
    _, ij = jsp.gmres(jA, jnp.asarray(b), M=jsp.InnerSolvePrecond(
        jA, method="cg", iters=4, inner_tol=0.3), tol=1e-8, max_iter=60, restart=20)
    assert int(info.status) == int(ij.status)
    assert abs(float(info.residual) - _true_res(dense, x.numpy(), b)) <= 1e-12


@pytest.mark.parametrize("method", ["lobpcg", "block_cg", "nope"])
def test_inner_method_whitelist(method):
    tA, _ = _pair(_convection_diffusion(4, 4))
    M = tsp.InnerSolvePrecond(tA, method=method)
    with pytest.raises(InvalidPreconditioner, match="not supported"):
        M.matvec(torch.ones(16, dtype=torch.float64))


def test_solve_routes_fgmres_and_complex():
    dense = _convection_diffusion(10, 10)
    tA, jA = _pair(dense)
    b = np.random.default_rng(7).standard_normal(100)
    x, info = tsp.solve(tA, b, method="fgmres", tol=1e-9, max_iter=300, restart=20,
                        device="cpu")
    xj, ij = jsp.solve(jA, b, method="fgmres", tol=1e-9, max_iter=300, restart=20)
    info.raise_if_error()
    _same(x, xj, info.iterations, int(ij.iterations))
    C, rhs, _ = jprob.complex_symmetric_grid_with_diag((10, 10))
    tC = csr_from_reference(C.data, C.indices, C.indptr, C.shape)
    x, info = tsp.fgmres(tC, torch.as_tensor(rhs), tol=1e-10, max_iter=400, restart=40)
    xj, ij = jsp.fgmres(C, jnp.asarray(rhs), tol=1e-10, max_iter=400, restart=40)
    info.raise_if_error()
    _same(x, xj, info.iterations, int(ij.iterations))
