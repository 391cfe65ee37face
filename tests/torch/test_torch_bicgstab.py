"""Cross tests of the port's BiCGStab against the JAX package's.

Both solve the same systems from the same NumPy data: the f64 PaddedDIA
path (K1/K2's plain versions here, the Pallas kernels in interpret mode on
the JAX side), the CSR path of the reference's 20×20 golden, and small
dense systems that take the rare exits (ρ-restart, breakdown).

Iteration counts.  f64 counts move with reduction order: torch and XLA sum
in different orders (the JAX package's own serial oracle lands 128 against
its 112 on the 20×20 golden, ``tests/test_serial_parity.py:181-182``).  So:
- where the two stay in step (Jacobi on the fixtures, the small dense
  systems), counts must be equal;
- elsewhere, and at the 1e-17 golden, both must converge with a true
  residual below 1e-12, and the counts must lie within the band of
  ``test_serial_parity.py:183``: |Δ| ≤ max(3, ⌈its/4⌉).
Measured on this suite's CPU run: Jacobi 36/36 (tol 1e-8) and 54/54
(1e-17); unpreconditioned PaddedDIA 51 against 59 (1e-8) and 94 against 103
(1e-17); CSR golden 114 against 112.
Solutions of converged solves agree to rtol 1e-5 in norm (tol 1e-8 times
the grid's condition number, a few hundred)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sprsolve_tpu as jsp
import sprsolve_tpu.ops.pallas_spmv as jps
import sprsolve_tpu_torch as tsp
from sprsolve_tpu.ops.operator import as_operator as j_as_operator
from sprsolve_tpu.utils import problems as jprob
from sprsolve_tpu_torch.errors import IncompatibleMatrixFormat, InsufficientIterNum, Status
from sprsolve_tpu_torch.interop import padded_dia_from_reference, vec_from_reference
from sprsolve_tpu_torch.ops.operator import as_operator
from sprsolve_tpu_torch.utils import problems as tprob
from sprsolve_tpu_torch.vecalg import conj_dot

torch.set_num_threads(2)


def _band(its):
    return max(3, -(-its // 4))


def _grid(shape=(20, 20)):
    rhs = np.zeros(shape[0] * shape[1])
    tprob.set_boundary_condition(rhs, shape, lambda r, c: float(r + c))
    return tprob.grid_laplacian_dirichlet(shape), jprob.grid_laplacian_dirichlet(shape), rhs


def _true_res(A, x, rhs):
    y = A.matvec(torch.as_tensor(np.asarray(x, np.float64))).numpy()
    return np.linalg.norm(y - rhs) / np.linalg.norm(rhs)


def _padded_pair():
    tA, jA, rhs = _grid()
    pj = jps.PaddedDIA.from_dia(jA.to_dia(), lanes=128, block_rows=8)
    pt = padded_dia_from_reference(np.asarray(pj.bands3), pj.offsets, pj.n, pj.hr,
                                   pj.shape, pj.vdtype)
    return tA, pj, pt, rhs


@pytest.mark.parametrize("tol", [1e-8, 1e-17])
@pytest.mark.parametrize("jacobi", [True, False])
def test_padded_f64_matches_jax(jacobi, tol):
    tA, pj, pt, rhs = _padded_pair()
    Mj = pj.jacobi_precond() if jacobi else None
    Mt = pt.jacobi_precond() if jacobi else None
    xj, ij = jsp.bicgstab(pj, pj.pad_vec(jnp.asarray(rhs)), M=Mj, tol=tol, max_iter=1500)
    xt, it = tsp.bicgstab(pt, pt.pad_vec(torch.from_numpy(rhs)), M=Mt, tol=tol,
                          max_iter=1500)
    assert it.converged and bool(ij.converged)
    assert float(it.residual) <= tol
    assert not bool(xt[: pt.h].any()) and not bool(xt[pt.h + pt.n:].any())
    x_t = pt.unpad_vec(xt)
    x_j = vec_from_reference(xj, pj.n, pj.hr)
    assert _true_res(tA, x_t, rhs) < (1e-12 if tol < 1e-12 else 1e-6)
    assert float(torch.linalg.norm(x_t - x_j) / torch.linalg.norm(x_j)) < 1e-5
    n_t, n_j = int(it.iterations), int(ij.iterations)
    if jacobi:
        assert n_t == n_j, (n_t, n_j)
    else:
        assert abs(n_t - n_j) <= _band(n_j), (n_t, n_j)


@pytest.mark.parametrize("tol", [1e-8, 1e-17])
def test_csr_golden_object_api(tol):
    """The reference's tests/test_solvers.rs:33-57 through BiCGStab.new on
    the CSR gather path (no kernel), against the JAX handle."""
    tA, jA, rhs = _grid()
    x, (its, res) = tsp.BiCGStab.new(tA, 400, device="cpu").solve(rhs, max_iter=1500, tol=tol)
    _, (its_j, res_j) = jsp.BiCGStab.new(jA, 400).solve(rhs, max_iter=1500, tol=tol)
    assert res <= tol
    assert _true_res(tA, x, rhs) < (1e-12 if tol < 1e-12 else 1e-6)
    assert abs(its - its_j) <= _band(its_j), (its, its_j)


def test_warm_start_early_exit():
    tA, _, rhs = _grid((10, 10))
    x, _ = tsp.BiCGStab.new(tA, 100, device="cpu").solve(rhs, max_iter=1500, tol=1e-15)
    x2, (its2, _) = tsp.BiCGStab.new(tA, 100, device="cpu").solve(rhs, x=x, max_iter=1500, tol=1e-12)
    assert its2 == 0 and torch.equal(x2, x)


def test_insufficient_iter_matches_jax():
    tA, jA, rhs = _grid((10, 10))
    with pytest.raises(InsufficientIterNum):
        tsp.BiCGStab.new(tA, 100, device="cpu").solve(rhs, max_iter=5, tol=1e-15)
    _, info = tsp.bicgstab(tA, torch.from_numpy(rhs), tol=1e-15, max_iter=5)
    _, info_j = jsp.bicgstab(jA, jnp.asarray(rhs), tol=1e-15, max_iter=5)
    assert (info.status, info.iterations) == (int(info_j.status), int(info_j.iterations))
    assert info.status == Status.INSUFFICIENT_ITER
    np.testing.assert_allclose(float(info.residual), float(info_j.residual), rtol=1e-6)


def test_dimension_mismatch_raises():
    tA, _, rhs = _grid((10, 10))
    with pytest.raises(IncompatibleMatrixFormat):
        tsp.BiCGStab.new(tA, 99, device="cpu")
    with pytest.raises(IncompatibleMatrixFormat):
        tsp.bicgstab(tA, torch.ones(99), tol=1e-8, max_iter=10)
    with pytest.raises(IncompatibleMatrixFormat):
        tsp.bicgstab(tA, torch.from_numpy(rhs), torch.ones(99), tol=1e-8, max_iter=10)
    pt = tsp.PaddedDIA.from_dia(tA.to_dia())
    with pytest.raises(IncompatibleMatrixFormat):
        tsp.bicgstab(pt, torch.from_numpy(rhs), tol=1e-8, max_iter=10)


def test_zero_rhs_guard():
    tA, _, _ = _grid((6, 6))
    x, info = tsp.bicgstab(tA, torch.zeros(36, dtype=torch.float64),
                           torch.ones(36, dtype=torch.float64), tol=1e-8, max_iter=10)
    assert info.converged and info.iterations == 0 and not bool(x.any())


def test_degenerate_system_never_false_converges():
    """tests/test_narrow_wdot.py:99: on a nilpotent system r0·v is exactly 0
    in the unguarded first iteration; the solve must not claim convergence."""
    a = np.array([[0.0, 0.0], [1.0, 0.0]])
    b = np.array([1.0, 0.0])
    _, info = tsp.bicgstab(as_operator(a), torch.from_numpy(b), tol=1e-30, max_iter=50)
    _, info_j = jsp.bicgstab(j_as_operator(jnp.asarray(a)), jnp.asarray(b), tol=1e-30,
                             max_iter=50)
    assert info.status != Status.CONVERGED
    assert (info.status, info.iterations) == (int(info_j.status), int(info_j.iterations))


class _WdotDense:
    """A dense operator with the fused w-dot form, counting matvec calls:
    BiCGStab calls ``matvec`` only for r = A·x0 − b and the ρ-restart."""

    def __init__(self, a):
        self.a = torch.as_tensor(a)
        self.shape = tuple(self.a.shape)
        self.calls = 0

    def matvec(self, x):
        self.calls += 1
        return self.a @ x

    def matvec_dot(self, x):
        y = self.a @ x
        return y, conj_dot(x, y)

    def matvec_wdot(self, x, w):
        y = self.a @ x
        return y, conj_dot(w, y), conj_dot(y, y)


# small integer systems that take the rare exits, found by search; the
# breakdowns are on singular systems, where most such searches end in
# rounding-dependent exits — these two end alike in both packages
RARE = {
    "restart3": ([[2, 1, 2], [0, -1, 2], [-1, 1, 0]], [-2, -2, 0], 2),
    "restart3b": ([[-1, 0, 0], [1, 0, 2], [1, -2, -2]], [-1, 0, 0], 2),
    "breakdown2": ([[2, 0], [1, 0]], [1, 2], 1),
    "restart_breakdown3": ([[0, -2, 1], [0, -2, 1], [0, -1, 0]], [-2, -2, 1], 2),
}


@pytest.mark.parametrize("name", sorted(RARE))
def test_restart_and_breakdown_exits_match_jax(name):
    a, b, matvecs = RARE[name]
    a, b = np.array(a, float), np.array(b, float)
    op = _WdotDense(a)
    x, info = tsp.bicgstab(op, torch.from_numpy(b), tol=1e-10, max_iter=50)
    xd, info_d = tsp.bicgstab(as_operator(a), torch.from_numpy(b), tol=1e-10, max_iter=50)
    xj, info_j = jsp.bicgstab(j_as_operator(jnp.asarray(a)), jnp.asarray(b), tol=1e-10,
                              max_iter=50)
    assert op.calls == matvecs   # 2: one ρ-restart ran
    for got, gx in ((info, x), (info_d, xd)):
        assert (got.status, got.iterations) == (int(info_j.status), int(info_j.iterations))
        # a converged residual is rounding noise below tol: atol 1e-12
        np.testing.assert_allclose(float(got.residual), float(info_j.residual),
                                   rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(gx.numpy(), np.asarray(xj), rtol=1e-10, atol=1e-12)


def test_record_residuals_matches_jax():
    tA, pj, pt, rhs = _padded_pair()
    xt, info, hist = tsp.bicgstab(pt, pt.pad_vec(torch.from_numpy(rhs)),
                                  M=pt.jacobi_precond(), tol=1e-10, max_iter=200,
                                  record_residuals=True)
    _, info_j, hist_j = jsp.bicgstab(pj, pj.pad_vec(jnp.asarray(rhs)),
                                     M=pj.jacobi_precond(), tol=1e-10, max_iter=200,
                                     record_residuals=True)
    k = info.iterations
    h, hj = hist.numpy(), np.asarray(hist_j)
    assert k == int(info_j.iterations) and h.shape == hj.shape == (201,)
    assert h[0] == 1.0 and h[k] <= 1e-10
    assert np.all(np.isfinite(h[: k + 1])) and np.all(np.isnan(h[k + 1:]))
    np.testing.assert_allclose(h[: k + 1], hj[: k + 1], rtol=1e-6)
