"""Cross tests of the port's MINRES against the JAX package's.

Both solve the same systems from the same NumPy data: the reference's
goldens on the CSR gather path, the f64 PaddedDIA path (K3/K4's plain
versions here, the Pallas kernels in interpret mode on the JAX side), a
truly indefinite dense system, and the preconditioned form's exits.

Iteration counts.  The two packages sum in different orders, so counts may
move (ROADMAP.md, North star).  Where they stay in step the tests assert
equal counts: the goldens 34 and 64, 56 on the 16×16 PaddedDIA at tol
1e-12, and the preconditioned exits (measured on this suite's CPU run).
The truly indefinite system takes 104 against 103, and is held to the
band of ``test_serial_parity.py:183`` instead.  Solutions of
converged f64 solves agree to rtol 1e-10 in norm: both stop at a tolerance
of 1e-12 or below on grids whose condition number is a few hundred."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

import sprsolve_tpu as jsp
import sprsolve_tpu.ops.pallas_spmv as jps
import sprsolve_tpu_torch as tsp
from sprsolve_tpu.utils import problems as jprob
from sprsolve_tpu_torch.errors import Status
from sprsolve_tpu_torch.interop import padded_dia_from_reference, vec_from_reference
from sprsolve_tpu_torch.ops.operator import as_operator
from sprsolve_tpu_torch.utils import problems as tprob

torch.set_num_threads(2)

GOLDEN = {"sym_grid_laplacian": (1e-22, 34), "simple_diag_system": (1e-20, 64)}


def _rel(x, ref):
    x, ref = np.asarray(x), np.asarray(ref)
    return np.linalg.norm(x - ref) / np.linalg.norm(ref)


def _true_res(A, x, rhs):
    y = A.matvec(torch.as_tensor(np.asarray(x), dtype=torch.float64)).numpy()
    return np.linalg.norm(y - rhs) / np.linalg.norm(rhs)


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_goldens_through_the_handle_match_jax(name):
    """tests/test_minres.py:10-11 — the reference's counts, on the CSR path."""
    tol, golden = GOLDEN[name]
    tA, rhs = getattr(tprob, name)((8, 8))
    jA, rhs_j = getattr(jprob, name)((8, 8))
    assert np.array_equal(rhs, rhs_j)
    handle = tsp.MinRes.new(tA, 64)
    assert handle.A is tA   # a CSR runs the gather path, not a kernel
    x, (its, res) = handle.solve(rhs, max_iter=300, tol=tol)
    xj, (its_j, _) = jsp.MinRes.new(jA, 64).solve(rhs, max_iter=300, tol=tol)
    assert its == golden == its_j
    assert res < tol
    assert _true_res(tA, x, rhs) < 1e-12
    assert _rel(x, xj) < 1e-10
    if name == "simple_diag_system":
        np.testing.assert_allclose(x.numpy(), 0.5, rtol=1e-12)


def test_padded_f64_matches_jax():
    """MINRES on the PaddedDIA of the 16×16 grid: K3 and K4 on the port's
    side, the fused Pallas pair on the JAX side."""
    jA, rhs = jprob.sym_grid_laplacian((16, 16))
    tA, _ = tprob.sym_grid_laplacian((16, 16))
    pj = jps.PaddedDIA.from_dia(jA.to_dia(), lanes=128, block_rows=8)
    pt = padded_dia_from_reference(np.asarray(pj.bands3), pj.offsets, pj.n, pj.hr,
                                   pj.shape, pj.vdtype)
    xj, ij = jsp.minres(pj, pj.pad_vec(jnp.asarray(rhs)), tol=1e-12, max_iter=600)
    xt, it = tsp.minres(pt, pt.pad_vec(torch.from_numpy(rhs)), tol=1e-12, max_iter=600)
    assert it.converged and bool(ij.converged)
    assert it.iterations == int(ij.iterations) == 56
    assert abs(float(it.residual) - float(ij.residual)) <= 1e-6 * float(ij.residual)
    # the halo and tail of every iterate stay exactly zero
    assert not bool(xt[: pt.h].any()) and not bool(xt[pt.h + pt.n:].any())
    x = pt.unpad_vec(xt)
    assert _true_res(tA, x, rhs) < 1e-9
    assert _rel(x, vec_from_reference(xj, pj.n, pj.hr)) < 1e-10


def test_fused_branch_only_on_operators_with_orth_norm():
    """minres.py:177-181 picks the fused step by hasattr: only the padded
    operator has it, so the others keep the unfused rounding."""
    tA = tprob.poisson3d(4, 4, 4)
    assert hasattr(tsp.PaddedDIA.from_dia(tA.to_dia()), "orth_norm")
    for op in (tA, tA.to_dia(), as_operator(np.eye(3))):
        assert not hasattr(op, "orth_norm")


def test_truly_indefinite_matches_direct_solve():
    """tests/test_minres.py:66-84: the folded Laplacian shifted by +3 has
    eigenvalues on both sides of zero.

    The count differs: 104 here against the JAX package's 103 on the CSR
    gather path at tol 1e-13 (the two sum in other orders; reported in
    ROADMAP.md Queue 3). So the count is held to the band of
    ``test_serial_parity.py:183``, and the solve to a true residual below
    1e-12."""
    tA, _ = tprob.sym_grid_laplacian((12, 12))
    dense = sps.csr_matrix((tA.data.numpy(), tA.indices.numpy(), tA.indptr.numpy()),
                           shape=tA.shape).toarray() + 3.0 * np.eye(144)
    eig = np.linalg.eigvalsh(dense)
    assert eig[0] < 0 < eig[-1]
    b = np.random.default_rng(7).standard_normal(144)
    x, info = tsp.minres(tsp.csr_from_dense(dense), torch.from_numpy(b), tol=1e-13,
                         max_iter=2000)
    _, info_j = jsp.minres(jsp.csr_from_dense(dense), jnp.asarray(b), tol=1e-13,
                           max_iter=2000)
    info.raise_if_error()
    its_j = int(info_j.iterations)
    assert abs(info.iterations - its_j) <= max(3, -(-its_j // 4))
    assert np.linalg.norm(dense @ x.numpy() - b) / np.linalg.norm(b) < 1e-12
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(dense, b), rtol=1e-7, atol=1e-9)


def test_record_residuals_matches_jax():
    tA, rhs = tprob.sym_grid_laplacian((8, 8))
    jA, _ = jprob.sym_grid_laplacian((8, 8))
    x, info, hist = tsp.minres(tA, torch.from_numpy(rhs), tol=1e-22, max_iter=300,
                               record_residuals=True)
    _, info_j, hist_j = jsp.minres(jA, jnp.asarray(rhs), tol=1e-22, max_iter=300,
                                   record_residuals=True)
    info.raise_if_error()
    k = info.iterations
    h = hist.numpy()
    assert h.shape == (300,)
    assert np.all(np.isfinite(h[: k + 1])) and np.all(np.isnan(h[k + 1:]))
    # the recurrence estimate is monotone non-increasing
    assert np.all(np.diff(h[: k + 1]) <= 1e-16)
    assert h[k] == float(info.residual)
    # atol 1e-12: at tol 1e-22 the recurrence runs below the f64 rounding
    # floor of the sums, where the two packages' orders part
    np.testing.assert_allclose(h, np.asarray(hist_j), rtol=1e-6, atol=1e-12)
    # the zero-rhs guard: x = 0, 0 iterations, an all-NaN history
    x0, info0, hist0 = tsp.minres(tA, torch.zeros(64, dtype=torch.float64), tol=1e-8,
                                  max_iter=5, record_residuals=True)
    assert info0.converged and info0.iterations == 0 and not bool(x0.any())
    assert hist0.shape == (5,) and bool(hist0.isnan().all())


def test_exact_jacobi_lucky_breakdown():
    """Second half of tests/test_minres.py:87-115: a diagonal SPD system
    with its exact Jacobi finishes in at most 3 iterations; the guarded 1/β
    turns β = 0 into convergence."""
    d = np.linspace(1.0, 9.0, 64)
    S = sps.diags(d).tocsr()
    b = np.random.default_rng(8).standard_normal(64)
    x, info = tsp.solve(tsp.csr_from_scipy(S), b, method="minres", M="jacobi",
                        tol=1e-12, max_iter=50)
    _, info_j = jsp.solve(jsp.csr_from_scipy(S), b, method="minres", M="jacobi",
                          tol=1e-12, max_iter=50)
    info.raise_if_error()
    assert info.iterations <= 3 and info.iterations == int(info_j.iterations)
    np.testing.assert_allclose(x.numpy(), b / d, rtol=1e-10)


@pytest.mark.parametrize("signs", ["all_negative", "one_negative"])
def test_invalid_preconditioner_matches_jax(signs):
    """A negative diagonal in M fails the β² gate: at the start when every
    entry is negative, inside the loop (after 4 iterations) when one is.
    The exit comes before the update, with the status and count of the JAX
    package."""
    tA, rhs = tprob.sym_grid_laplacian((8, 8))
    jA, _ = jprob.sym_grid_laplacian((8, 8))
    diag = -tA.diagonal_host()                 # 4 > 0: the SPD scaling of -A
    if signs == "all_negative":
        diag = -diag
    else:
        diag[27] = -diag[27]
    x, info = tsp.minres(tA, torch.from_numpy(rhs), M=tsp.DiagPrecond.new(diag),
                         tol=1e-10, max_iter=200)
    xj, info_j = jsp.minres(jA, jnp.asarray(rhs), M=jsp.DiagPrecond.new(jnp.asarray(diag)),
                            tol=1e-10, max_iter=200)
    assert info.status == Status.INVALID_PRECONDITIONER == int(info_j.status)
    assert info.iterations == int(info_j.iterations)
    assert info.iterations == (0 if signs == "all_negative" else 4)
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-10, atol=1e-12)
    with pytest.raises(tsp.errors.InvalidPreconditioner):
        tsp.MinRes.new(tA, 64).precond_solve(tsp.DiagPrecond.new(diag), rhs)
