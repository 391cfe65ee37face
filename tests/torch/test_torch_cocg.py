"""Cross tests of the port's COCG against the JAX package's (mirrors
``tests/test_cocg.py``): the manufactured solution with and without the
complex Jacobi, COCG = CG on a real SPD system, the dense-oracle count, the
``solve`` route, warm start and zero rhs, the residual trace, and the
breakdown exit.  The batched case is in ``test_torch_block_solve.py``;
the distributed one no cross test holds yet (ROADMAP.md Queue 3).

Counts: on the complex-symmetric 8×8 grid the two packages stay in step
(41 with the complex Jacobi and 45 without, at tol 1e-13): equal counts
are asserted."""

import jax.numpy as jnp
import numpy as np
import torch

import sprsolve_tpu as jsp
from sprsolve_tpu.precond import ComplexDiagPrecond as JCDP
from sprsolve_tpu.solvers import cocg as j_cocg
from sprsolve_tpu.utils import problems as jprob
import sprsolve_tpu_torch as tsp
from sprsolve_tpu_torch.errors import Status
from sprsolve_tpu_torch.utils import problems as tprob

torch.set_num_threads(2)


def _x_known(rows, cols):
    return np.array([complex(i, j) for i in range(rows) for j in range(cols)])


def _problem():
    A, rhs, diag = tprob.complex_symmetric_grid_with_diag((8, 8))
    jA, _, _ = jprob.complex_symmetric_grid_with_diag((8, 8))
    return A, jA, rhs, diag


def test_manufactured_solution_matches_jax():
    A, jA, rhs, diag = _problem()
    b = torch.as_tensor(rhs)
    x, info = tsp.cocg(A, b, M=tsp.ComplexDiagPrecond.new(diag), tol=1e-13, max_iter=500)
    _, info_j = j_cocg(jA, jnp.asarray(rhs), M=JCDP.new(diag), tol=1e-13, max_iter=500)
    info.raise_if_error()
    assert info.iterations == int(info_j.iterations)
    assert np.abs(x.numpy() - _x_known(8, 8)).max() < 1e-10
    x2, info2 = tsp.cocg(A, b, tol=1e-13, max_iter=1000)
    _, info2_j = j_cocg(jA, jnp.asarray(rhs), tol=1e-13, max_iter=1000)
    info2.raise_if_error()
    assert info2.iterations == int(info2_j.iterations)
    assert info.iterations <= info2.iterations
    assert np.abs(x2.numpy() - _x_known(8, 8)).max() < 1e-10


def test_reduces_to_cg_on_real_spd():
    """On a real SPD system the bilinear form is the inner product: COCG is
    CG step for step."""
    A = tprob.poisson3d(6, 6, 6, dtype=np.float64)
    b = torch.as_tensor(np.random.default_rng(0).standard_normal(216))
    x1, i1 = tsp.cg(A, b, tol=1e-12, max_iter=600)
    x2, i2 = tsp.cocg(A, b, tol=1e-12, max_iter=600)
    _, ij = j_cocg(jprob.poisson3d(6, 6, 6, dtype=np.float64), jnp.asarray(b.numpy()),
                   tol=1e-12, max_iter=600)
    i1.raise_if_error()
    i2.raise_if_error()
    assert i1.iterations == i2.iterations == int(ij.iterations)
    np.testing.assert_allclose(x1.numpy(), x2.numpy(), rtol=1e-12, atol=1e-12)


def test_matches_the_dense_oracle_count():
    """A left-fold dense COCG with the same update order and guards."""
    A, _, rhs, diag = _problem()
    S = A.to_dia()
    dense = np.zeros((64, 64), complex)
    for d, off in enumerate(S.offsets):
        for i in range(64):
            if 0 <= i + off < 64:
                dense[i, i + off] = S.bands[d, i]
    Minv = 1.0 / diag
    x = np.zeros(64, np.complex128)
    r = rhs - dense @ x
    z = Minv * r
    p, rho = z.copy(), r @ z
    it_oracle = None
    for it in range(500):
        if np.linalg.norm(r) <= 1e-13 * np.linalg.norm(rhs):
            it_oracle = it
            break
        q = dense @ p
        alpha = rho / (p @ q)
        x, r = x + alpha * p, r - alpha * q
        z = Minv * r
        rho_new = r @ z
        p, rho = z + (rho_new / rho) * p, rho_new
    assert it_oracle is not None
    _, info = tsp.cocg(A, torch.as_tensor(rhs), M=tsp.ComplexDiagPrecond.new(diag),
                       tol=1e-13, max_iter=500)
    info.raise_if_error()
    assert abs(info.iterations - it_oracle) <= max(3, it_oracle // 10)


def test_through_solve_and_prepare():
    """solve(method="cocg", M="jacobi"): a complex128 CSR stays on DIA with a
    flat complex Jacobi; a complex64 one is laid out as a ComplexPaddedDIA
    with the padded complex Jacobi. Both agree with the JAX package."""
    A, jA, rhs, _ = _problem()
    x, info = tsp.solve(A, rhs, method="cocg", M="jacobi", tol=1e-12, max_iter=500,
                        device="cpu")
    _, info_j = jsp.solve(jA, rhs, method="cocg", M="jacobi", tol=1e-12, max_iter=500)
    info.raise_if_error()
    assert info.iterations == int(info_j.iterations)
    assert np.abs(x.numpy() - _x_known(8, 8)).max() < 1e-9
    A64, rhs64, _ = tprob.complex_symmetric_grid_with_diag((8, 8), dtype=np.complex64)
    handle = tsp.prepare(A64, method="cocg", M="jacobi", tol=1e-5, max_iter=500, device="cpu")
    assert isinstance(handle.operator, tsp.ComplexPaddedDIA)
    x, info = handle(rhs64)
    info.raise_if_error()
    assert x.dtype == torch.complex64 and np.abs(x.numpy() - _x_known(8, 8)).max() < 1e-3
    x2, info2 = tsp.solve(A64, rhs64, method="cocg", M="jacobi", tol=1e-5, max_iter=500,
                          device="cpu")
    assert torch.equal(x, x2) and info.iterations == info2.iterations


def test_warm_start_and_zero_rhs():
    A, _, rhs, _ = _problem()
    x, info = tsp.cocg(A, torch.as_tensor(rhs), torch.as_tensor(_x_known(8, 8)), tol=1e-10,
                       max_iter=100)
    assert int(info.status) == Status.CONVERGED and info.iterations == 0
    xz, infoz = tsp.cocg(A, torch.zeros(64, dtype=torch.complex128), tol=1e-10, max_iter=10)
    assert int(infoz.status) == Status.CONVERGED and not bool(xz.any())


def test_residual_trace():
    """The traces agree closely at first; COCG's non-minimizing recurrence
    then amplifies rounding about tenfold every three steps, so at tol 1e-10
    the port stops at 35 and the JAX package at 34 (band of
    ``test_serial_parity.py:183``; ROADMAP.md Queue 3)."""
    A, jA, rhs, diag = _problem()
    x, info, hist = tsp.cocg(A, torch.as_tensor(rhs), M=tsp.ComplexDiagPrecond.new(diag),
                             tol=1e-10, max_iter=200, record_residuals=True)
    _, info_j, hist_j = j_cocg(jA, jnp.asarray(rhs), M=JCDP.new(diag), tol=1e-10,
                               max_iter=200, record_residuals=True)
    info.raise_if_error()
    h, it = hist.numpy(), info.iterations
    assert np.isclose(h[0], 1.0, rtol=1e-6)   # x0 = 0 → first relative residual 1
    assert np.isfinite(h[: it + 1]).all() and np.isnan(h[it + 1:]).all()
    assert h[it] <= 1e-10 < h[it - 1]
    np.testing.assert_allclose(h[:16], np.asarray(hist_j)[:16], rtol=1e-9)
    its_j = int(info_j.iterations)
    assert abs(it - its_j) <= max(3, -(-its_j // 4))


def test_breakdown_keeps_the_previous_iterate():
    """pᵀAp = 0 on the first step (A = [[0, 1], [1, 0]], b = e₁): BREAKDOWN
    at 0 iterations with x = x0, as in the JAX package."""
    A = tsp.csr_from_dense(np.array([[0, 1], [1, 0]], dtype=np.complex128))
    jA = jsp.csr_from_dense(np.array([[0, 1], [1, 0]], dtype=np.complex128))
    b = np.array([1.0, 0.0], dtype=np.complex128)
    x, info = tsp.cocg(A, torch.as_tensor(b), tol=1e-10, max_iter=10)
    _, info_j = j_cocg(jA, jnp.asarray(b), tol=1e-10, max_iter=10)
    assert int(info.status) == int(info_j.status) == Status.BREAKDOWN
    assert info.iterations == int(info_j.iterations) == 0 and not bool(x.any())
    assert float(info.residual) == float(info_j.residual) == 1.0
