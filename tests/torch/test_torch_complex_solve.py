"""Cross tests of the port's complex solves against the JAX package's
(mirrors ``tests/test_complex_solve.py`` and the BiCGStab case of
``tests/test_complex_solve2.py``), and the complex slice as a whole at
small size.

Goldens at tol 1e-22 on the reference's 8×8 grids (CSR gather path, c128):
preconditioned MINRES 104 and complex-Jacobi BiCGStab 40 are equal in both
packages.  Near stagnation, rounding moves the others (ROADMAP.md North
star, Queue 3): MINRES on the Hermitian grid takes 106 against 105 (in step
through tol 1e-14), and BiCGStab with the real diagonal 119 against 124
(its residual traces agree to 1e-13 for the first 10 steps, then part);
both are held to the band of ``test_serial_parity.py:183`` with the
manufactured solution to 1e-12.

The slice: the damped complex-symmetric 12³ Poisson (A + 0.5i·I, c64,
1,728 rows) through the port's ``solve`` (``device="cpu"``: the plain
versions of K5-K7) and the JAX package's (its ComplexPaddedDIA, Pallas in
interpret mode), for ``auto`` (→ COCG), ``cs_minres`` and ``bicgstab``,
all with ``M="jacobi"``: true residuals below 1e-3, solutions within 1e-4
relative in 2-norm, counts within ±2 (f32 sums in other orders)."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

import sprsolve_tpu as jsp
from sprsolve_tpu.solvers import bicgstab as j_bicgstab
from sprsolve_tpu.utils import problems as jprob
import sprsolve_tpu_torch as tsp
from sprsolve_tpu_torch.interop import csr_from_reference
from sprsolve_tpu_torch.ops import padded_dia as pd
from sprsolve_tpu_torch.utils import problems as tprob

torch.set_num_threads(2)


def _band(its):
    return max(3, -(-its // 4))


def _x_known(rows, cols):
    return np.array([complex(i, j) for i in range(rows) for j in range(cols)])


@pytest.mark.parametrize("name", ["hermitian_grid", "hermitian_grid_with_diag",
                                  "complex_symmetric_grid_with_diag"])
@pytest.mark.parametrize("dtype", [np.complex128, np.complex64])
def test_complex_fixtures_match_jax_entry_for_entry(name, dtype):
    got = getattr(tprob, name)((6, 7), dtype=dtype)
    want = getattr(jprob, name)((6, 7), dtype=dtype)
    A, jA = got[0], want[0]
    assert A.dtype == {np.complex128: torch.complex128, np.complex64: torch.complex64}[dtype]
    np.testing.assert_array_equal(A.data.numpy(), np.asarray(jA.data))
    np.testing.assert_array_equal(A.indices.numpy(), np.asarray(jA.indices))
    np.testing.assert_array_equal(A.indptr.numpy(), np.asarray(jA.indptr))
    for a, b in zip(got[1:], want[1:]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_minres_hermitian_golden_within_the_band():
    A, rhs = tprob.hermitian_grid((8, 8))
    jA, _ = jprob.hermitian_grid((8, 8))
    S = sps.csr_matrix((A.data.numpy(), A.indices.numpy(), A.indptr.numpy()), shape=A.shape)
    assert abs(S - S.conj().T).max() == 0
    x, (its, res) = tsp.MinRes.new(A, 64, device="cpu").solve(rhs, max_iter=300, tol=1e-22)
    _, (its_j, _) = jsp.MinRes.new(jA, 64).solve(rhs, max_iter=300, tol=1e-22)
    assert its_j == 105 and abs(its - its_j) <= _band(its_j) and res < 1e-22
    assert np.abs(x.numpy() - _x_known(8, 8)).max() < 1e-12
    _, (its, _) = tsp.MinRes.new(A, 64, device="cpu").solve(rhs, max_iter=300, tol=1e-14)
    _, (its_j, _) = jsp.MinRes.new(jA, 64).solve(rhs, max_iter=300, tol=1e-14)
    assert its == its_j


def test_precond_minres_real_diagonal_golden_104():
    """A real diagonal on a complex system (reference src/precond.rs:6-13)."""
    A, rhs, diag = tprob.hermitian_grid_with_diag((8, 8))
    assert diag.dtype == np.float64
    jA, _, _ = jprob.hermitian_grid_with_diag((8, 8))
    x, (its, res) = tsp.MinRes.new(A, 64, device="cpu").precond_solve(
        tsp.DiagPrecond.new(diag), rhs, max_iter=300, tol=1e-22)
    _, (its_j, _) = jsp.MinRes.new(jA, 64).precond_solve(jsp.DiagPrecond.new(diag), rhs,
                                                         max_iter=300, tol=1e-22)
    assert its == its_j == 104 and res < 1e-22
    assert np.abs(x.numpy() - _x_known(8, 8)).max() < 1e-12


def test_bicgstab_hermitian_real_diagonal_within_the_band():
    A, rhs, diag = tprob.hermitian_grid_with_diag((8, 8))
    jA, _, _ = jprob.hermitian_grid_with_diag((8, 8))
    x, (its, res) = tsp.BiCGStab.new(A, 64, device="cpu").precond_solve(
        tsp.DiagPrecond.new(diag), rhs, max_iter=300, tol=1e-22)
    _, (its_j, _) = jsp.BiCGStab.new(jA, 64).precond_solve(jsp.DiagPrecond.new(diag), rhs,
                                                           max_iter=300, tol=1e-22)
    assert its_j == 124 and abs(its - its_j) <= _band(its_j) and res <= 1e-22
    assert np.abs(x.numpy() - _x_known(8, 8)).max() < 1e-12
    # the two iterations are the same one: their traces agree before rounding parts them
    _, _, h = tsp.bicgstab(A, torch.as_tensor(rhs), M=tsp.DiagPrecond.new(diag), tol=1e-22,
                           max_iter=300, record_residuals=True)
    _, _, hj = j_bicgstab(jA, jnp.asarray(rhs), M=jsp.DiagPrecond.new(diag), tol=1e-22,
                          max_iter=300, record_residuals=True)
    np.testing.assert_allclose(h.numpy()[:11], np.asarray(hj)[:11], rtol=1e-12)


def test_bicgstab_complex_symmetric_complex_diagonal_golden_40():
    A, rhs, diag = tprob.complex_symmetric_grid_with_diag((8, 8))
    jA, _, _ = jprob.complex_symmetric_grid_with_diag((8, 8))
    x, (its, res) = tsp.BiCGStab.new(A, 64, device="cpu").precond_solve(
        tsp.DiagPrecond.new(diag), rhs, max_iter=300, tol=1e-22)
    _, (its_j, _) = jsp.BiCGStab.new(jA, 64).precond_solve(jsp.DiagPrecond.new(diag), rhs,
                                                           max_iter=300, tol=1e-22)
    assert its == its_j == 40 and res <= 1e-22
    assert np.abs(x.numpy() - _x_known(8, 8)).max() < 1e-12


def _damped(k):
    """The damped complex-symmetric Poisson A + 0.5i·I of both packages, and
    b = r + 0.25i·r (``bench.py:569-576``)."""
    jP = jprob.poisson3d(k, k, k)
    data = np.asarray(jP.data).astype(np.complex64)
    rows = np.repeat(np.arange(k ** 3), np.diff(np.asarray(jP.indptr)))
    data[np.asarray(jP.indices) == rows] += 0.5j
    jA = jsp.CSR.from_arrays(data, jP.indices, jP.indptr, jP.shape)
    A = csr_from_reference(data, jP.indices, jP.indptr, jP.shape)
    r = np.random.default_rng(12).standard_normal(k ** 3).astype(np.float32)
    return A, jA, (r + 0.25j * r).astype(np.complex64)


@pytest.mark.parametrize("method", ["auto", "cs_minres", "bicgstab"])
def test_slice_damped_poisson_matches_jax(method):
    """The slice as a whole at 12³, through both packages' solve()."""
    A, jA, b = _damped(12)
    kw = dict(method=method, M="jacobi", tol=1e-5, max_iter=400)
    pd.reset_launch_counts()
    x, info = tsp.solve(A, b, device="cpu", **kw)
    xj, info_j = jsp.solve(jA, b, **kw)
    assert info.converged and bool(info_j.converged)
    assert x.dtype == torch.complex64 and x.shape == (A.shape[0],)
    assert abs(info.iterations - int(info_j.iterations)) <= 2
    S = sps.csr_matrix((A.data.numpy().astype(np.complex128), A.indices.numpy(),
                        A.indptr.numpy()), shape=A.shape)
    xj = np.asarray(xj)
    for sol in (x.numpy(), xj):
        assert np.linalg.norm(S @ sol - b) / np.linalg.norm(b) < 1e-3
    assert np.linalg.norm(x.numpy() - xj) / np.linalg.norm(xj) < 1e-4
    # the CPU runs the plain versions: no kernel launched
    assert pd.dia_complex_spmv.launches == pd.dia_complex_dot.launches == 0


def test_auto_routes_the_damped_poisson_to_cocg_with_complex_jacobi():
    A, _, b = _damped(6)
    handle = tsp.prepare(A, method="auto", M="jacobi", tol=1e-5, max_iter=400, device="cpu")
    assert isinstance(handle.operator, tsp.ComplexPaddedDIA)
    x, info = handle(b)
    x2, info2 = tsp.cocg(handle.operator, handle.operator.pad_vec(torch.as_tensor(b)),
                         M=handle.operator.jacobi_precond(), tol=1e-5, max_iter=400)
    assert info.converged and info.iterations == info2.iterations
    assert torch.equal(x, handle.operator.unpad_vec(x2))


def test_with_real_planes_shim():
    A, jA, b = _damped(6)
    op = tsp.optimize(A, device="cpu")
    b2 = op.pad_vec(torch.as_tensor(b))
    xr, xi, info = tsp.with_real_planes(tsp.cocg)(op, b2.real.contiguous(),
                                                  b2.imag.contiguous(), tol=1e-5,
                                                  max_iter=400)
    x, info2 = tsp.cocg(op, b2, tol=1e-5, max_iter=400)
    assert info.iterations == info2.iterations
    assert torch.equal(xr, x.real) and torch.equal(xi, x.imag)
    xr2, xi2, info3 = tsp.with_real_planes(tsp.cocg)(op, b2.real.contiguous(),
                                                     b2.imag.contiguous(), xr, xi, tol=1e-5,
                                                     max_iter=400)
    assert info3.iterations <= 1
