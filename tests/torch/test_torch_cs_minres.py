"""Cross tests of the port's CS-MINRES against the JAX package's
(mirrors ``tests/test_complex_solve2.py``).

Both solve the same systems from the same NumPy data, on the CSR gather
path unless a test says otherwise.  Iteration counts (ROADMAP.md, North
star): the two packages stay in step on the complex-symmetric 8×8 grid
through tol 1e-14 (equal counts asserted at 1e-12); at the golden's tol
1e-22, near stagnation, the port takes 75 against the JAX package's 77,
both below 1e-22 — held to the band of ``test_serial_parity.py:183`` and
recorded in ROADMAP.md Queue 3.  On a real symmetric system CS-MINRES is
MINRES, bitwise."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

import sprsolve_tpu as jsp
import sprsolve_tpu.ops.pallas_spmv as jps
import sprsolve_tpu_torch as tsp
from sprsolve_tpu.precond import real_abs_jacobi as j_real_abs_jacobi
from sprsolve_tpu.solvers import cs_minres as j_cs_minres
from sprsolve_tpu.utils import problems as jprob
from sprsolve_tpu_torch.errors import InvalidPreconditioner, Status
from sprsolve_tpu_torch.interop import complex_padded_dia_from_reference, vec_from_reference
from sprsolve_tpu_torch.ops.padded_dia import ComplexPaddedDIA, PaddedDIA
from sprsolve_tpu_torch.utils import problems as tprob

torch.set_num_threads(2)

GOLDEN = {"cs_minres": 77, "cs_minres_real_sym": 34}


def _band(its):
    return max(3, -(-its // 4))


def _x_known(rows, cols):
    return np.array([complex(i, j) for i in range(rows) for j in range(cols)])


def _problem(dtype=np.complex128):
    A, rhs, diag = tprob.complex_symmetric_grid_with_diag((8, 8), dtype=dtype)
    jA, rhs_j, diag_j = jprob.complex_symmetric_grid_with_diag((8, 8), dtype=dtype)
    assert np.array_equal(rhs, rhs_j) and np.array_equal(diag, diag_j)
    S = sps.csr_matrix((A.data.numpy(), A.indices.numpy(), A.indptr.numpy()), shape=A.shape)
    assert abs(S - S.T).max() == 0 and abs(S - S.conj().T).max() > 1.0
    return A, jA, rhs, diag


def test_golden_77_within_the_band_and_in_step_at_1e_12():
    A, jA, rhs, _ = _problem()
    x, (its, res) = tsp.CSMinRes.new(A, 64, device="cpu").solve(rhs, max_iter=300, tol=1e-22)
    xj, (its_j, _) = jsp.CSMinRes.new(jA, 64).solve(rhs, max_iter=300, tol=1e-22)
    assert its_j == GOLDEN["cs_minres"] and abs(its - its_j) <= _band(its_j)
    assert res < 1e-22
    assert np.abs(x.numpy() - _x_known(8, 8)).max() < 1e-12
    _, (its, _) = tsp.CSMinRes.new(A, 64, device="cpu").solve(rhs, max_iter=300, tol=1e-12)
    _, (its_j, _) = jsp.CSMinRes.new(jA, 64).solve(rhs, max_iter=300, tol=1e-12)
    assert its == its_j


def test_reduces_to_minres_on_real_symmetric_bitwise():
    """On a real symmetric system conj() is the identity: the Saunders
    process is the Lanczos process step for step."""
    A, rhs = tprob.sym_grid_laplacian((8, 8))
    x1, (it1, res1) = tsp.MinRes.new(A, 64, device="cpu").solve(rhs, max_iter=300, tol=1e-22)
    x2, (it2, res2) = tsp.CSMinRes.new(A, 64, device="cpu").solve(rhs, max_iter=300,
                                                                  tol=1e-22)
    jA, _ = jprob.sym_grid_laplacian((8, 8))
    _, (it_j, _) = jsp.CSMinRes.new(jA, 64).solve(rhs, max_iter=300, tol=1e-22)
    assert it1 == it2 == it_j == GOLDEN["cs_minres_real_sym"]
    assert res1 == res2 and torch.equal(x1, x2)


def test_preconditioned_real_abs_jacobi_matches_jax():
    A, jA, rhs, diag = _problem()
    M = tsp.DiagPrecond.new(np.abs(diag))
    x, info = tsp.cs_minres(A, torch.as_tensor(rhs), M=M, max_iter=300, tol=1e-22)
    _, info_j = j_cs_minres(jA, jnp.asarray(rhs), M=jsp.DiagPrecond.new(np.abs(diag)),
                            max_iter=300, tol=1e-22)
    info.raise_if_error()
    assert float(info.residual) <= 1e-22
    assert info.iterations <= GOLDEN["cs_minres"]
    assert abs(info.iterations - int(info_j.iterations)) <= _band(int(info_j.iterations))
    assert np.abs(x.numpy() - _x_known(8, 8)).max() < 1e-12
    _, info = tsp.cs_minres(A, torch.as_tensor(rhs), M=M, max_iter=300, tol=1e-12)
    _, info_j = j_cs_minres(jA, jnp.asarray(rhs), M=jsp.DiagPrecond.new(np.abs(diag)),
                            max_iter=300, tol=1e-12)
    assert info.iterations == int(info_j.iterations)


@pytest.mark.parametrize("tol", [1e-12, 1e-22])
def test_identity_preconditioner_reproduces_the_plain_process(tol):
    """M = I gives the unpreconditioned process up to rounding: β from
    conj(v)ᵀ(M⁻¹v) in place of ‖v‖. Equal counts at tol 1e-12; at 1e-22,
    near stagnation, the port takes 74 against 75 (the JAX package 77 and
    77), held to the band."""
    A, _, rhs, _ = _problem()
    b = torch.as_tensor(rhs)
    x1, i1 = tsp.cs_minres(A, b, max_iter=300, tol=tol)
    x2, i2 = tsp.cs_minres(A, b, M=tsp.DiagPrecond.new(np.ones(64)), max_iter=300, tol=tol)
    assert i1.converged and i2.converged
    if tol == 1e-12:
        assert i1.iterations == i2.iterations
    else:
        assert abs(i1.iterations - i2.iterations) <= _band(i1.iterations)
    np.testing.assert_allclose(x1.numpy(), x2.numpy(), rtol=1e-10, atol=1e-11)


def test_invalid_preconditioner_gate():
    """A negative definite M trips the β² gate (INVALID_PRECONDITIONER),
    as in the JAX package."""
    A, jA, rhs, _ = _problem()
    _, info = tsp.cs_minres(A, torch.as_tensor(rhs), M=tsp.DiagPrecond.new(-np.ones(64)),
                            max_iter=300, tol=1e-22)
    _, info_j = j_cs_minres(jA, jnp.asarray(rhs), M=jsp.DiagPrecond.new(-np.ones(64)),
                            max_iter=300, tol=1e-22)
    assert int(info.status) == int(info_j.status) == Status.INVALID_PRECONDITIONER
    with pytest.raises(InvalidPreconditioner):
        tsp.CSMinRes.new(A, 64, device="cpu").precond_solve(
            tsp.DiagPrecond.new(-np.ones(64)), rhs, max_iter=300, tol=1e-22)


def test_indefinite_preconditioner_never_reports_false_convergence():
    n = 100
    A = tsp.csr_from_dense(np.eye(n, dtype=np.complex128))
    dinv = np.ones(n)
    dinv[0] = -1.0
    b = torch.ones(n, dtype=torch.complex128)
    x0 = b + 3e-3 * torch.eye(n, 1, dtype=torch.complex128).ravel()
    _, info = tsp.cs_minres(A, b, x0, M=tsp.DiagPrecond(diag_inv=torch.as_tensor(dinv)),
                            tol=1e-6, max_iter=50)
    assert int(info.status) == Status.INVALID_PRECONDITIONER


def test_warm_start_at_the_solution_exits_at_zero():
    A, _, rhs, diag = _problem()
    x_exact = torch.as_tensor(_x_known(8, 8))
    for M in (None, tsp.DiagPrecond.new(np.abs(diag))):
        x, info = tsp.cs_minres(A, torch.as_tensor(rhs), x_exact, M=M, tol=1e-10,
                                max_iter=100)
        assert int(info.status) == Status.CONVERGED and info.iterations == 0
        assert bool(torch.isfinite(x).all())


def test_residual_trace_and_zero_rhs():
    A, _, rhs, _ = _problem()
    x, info, hist = tsp.cs_minres(A, torch.as_tensor(rhs), tol=1e-10, max_iter=200,
                                  record_residuals=True)
    info.raise_if_error()
    h, it = hist.numpy(), info.iterations
    assert h.shape == (200,) and np.isfinite(h[: it + 1]).all() and np.isnan(h[it + 1:]).all()
    assert h[it] < 1e-10 and np.all(np.diff(h[: it + 1]) <= 0)   # MINRES is monotone
    xz, infoz = tsp.cs_minres(A, torch.zeros(64, dtype=torch.complex128), tol=1e-10,
                              max_iter=10)
    assert int(infoz.status) == Status.CONVERGED and not bool(xz.any())


def test_solve_cs_minres_jacobi_matches_jax():
    """solve(method="cs_minres", M="jacobi") builds the real 1/|d| Jacobi: a
    complex128 CSR stays on DIA in both packages."""
    A, jA, rhs, _ = _problem()
    x, info = tsp.solve(A, rhs, method="cs_minres", M="jacobi", tol=1e-12, max_iter=300,
                        device="cpu")
    xj, info_j = jsp.solve(jA, rhs, method="cs_minres", M="jacobi", tol=1e-12, max_iter=300)
    info.raise_if_error()
    assert info.iterations == int(info_j.iterations)
    assert np.abs(x.numpy() - _x_known(8, 8)).max() < 1e-9
    handle = tsp.prepare(A, method="cs_minres", M="jacobi", tol=1e-12, max_iter=300,
                         device="cpu")
    x2, info2 = handle(rhs)
    assert torch.equal(x, x2) and info2.iterations == info.iterations


def test_scale_free_gate_on_a_tiny_complex64_rhs():
    A, _, rhs, diag = _problem(np.complex64)
    M = tsp.DiagPrecond.new(np.abs(diag).astype(np.float32))
    tiny = (rhs * 1e-6).astype(np.complex64)
    x, info = tsp.cs_minres(A, torch.as_tensor(tiny), M=M, tol=1e-5, max_iter=300)
    info.raise_if_error()
    S = sps.csr_matrix((A.data.numpy(), A.indices.numpy(), A.indptr.numpy()), shape=A.shape)
    assert np.linalg.norm(S @ x.numpy() - tiny) / np.linalg.norm(tiny) < 1e-4


def test_residual_is_trustworthy_when_m_is_ill_conditioned():
    n = 200
    rng = np.random.default_rng(0)
    scale = np.logspace(-4, 4, n)
    dense = np.diag(scale * (3.0 + 0.5j))
    for k in (1, 2):
        off = (0.2 + 0.1j) * np.sqrt(scale[k:] * scale[:-k])
        dense += np.diag(off, k) + np.diag(off, -k)
    A = tsp.csr_from_scipy(sps.csr_matrix(dense))
    x_true = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    b = dense @ x_true
    M = tsp.DiagPrecond.new(np.abs(np.diag(dense)))
    x, info = tsp.cs_minres(A, torch.as_tensor(b), M=M, tol=1e-8, max_iter=2000)
    assert int(info.status) == Status.CONVERGED
    assert np.linalg.norm(dense @ x.numpy() - b) / np.linalg.norm(b) < 1e-6


@pytest.mark.parametrize("M", ["complex_diag", "complex_diag_precond", "ilu0",
                               "block_jacobi", "amg", "ic0"])
def test_solve_rejects_invalid_preconditioners(M):
    """A complex diagonal, and every string builder but "jacobi", is no real
    symmetric-positive M⁻¹: refused before any builder runs."""
    A, _, rhs, diag = _problem()
    M = {"complex_diag": tsp.DiagPrecond.new(diag),
         "complex_diag_precond": tsp.ComplexDiagPrecond.new(diag)}.get(M, M)
    with pytest.raises(InvalidPreconditioner):
        tsp.solve(A, rhs, method="cs_minres", M=M, tol=1e-8, max_iter=100, device="cpu")
    with pytest.raises(InvalidPreconditioner):
        tsp.prepare(A, method="cs_minres", M=M, device="cpu")


def test_real_abs_jacobi_branches_match_jax():
    """real_abs_jacobi in each operator's own layout: a real PaddedDIA, a
    two-plane ComplexPaddedDIA, and a flat operator."""
    from sprsolve_tpu_torch.interop import padded_dia_from_reference

    R = jprob.grid_laplacian_dirichlet((16, 16), dtype=np.float32)
    pj = jps.PaddedDIA.from_dia(R.to_dia(), lanes=128, block_rows=8)
    pt = padded_dia_from_reference(np.asarray(pj.bands3), pj.offsets, pj.n, pj.hr,
                                   pj.shape, pj.vdtype)
    Mt, Mj = tsp.real_abs_jacobi(pt), j_real_abs_jacobi(pj)
    assert Mt.diag_inv.dtype == torch.float32 and Mt.diag_inv.shape == (pt.padded_len,)
    assert torch.equal(pt.unpad_vec(Mt.diag_inv), vec_from_reference(Mj.diag_inv, pj.n, pj.hr))
    assert bool((Mt.diag_inv[: pt.h] == 1).all())

    A, jA, _, diag = _problem(np.complex64)
    cj = jps.ComplexPaddedDIA.from_dia(jA.to_dia(), lanes=128, block_rows=8)
    ct = complex_padded_dia_from_reference(np.asarray(cj.re.bands3), np.asarray(cj.im.bands3),
                                           cj.re.offsets, cj.n, cj.hr, cj.shape, cj.re.vdtype)
    Mt, Mj = tsp.real_abs_jacobi(ct), j_real_abs_jacobi(cj)
    assert type(Mt) is tsp.DiagPrecond and Mt.diag_inv.dtype == torch.float32
    torch.testing.assert_close(ct.unpad_vec(Mt.diag_inv),
                               vec_from_reference(Mj.diag_inv, cj.n, cj.hr), rtol=1e-6, atol=0)

    A, jA, _, diag = _problem()
    Mt, Mj = tsp.real_abs_jacobi(A), j_real_abs_jacobi(jA)
    assert Mt.diag_inv.dtype == torch.float64
    np.testing.assert_array_equal(Mt.diag_inv.numpy(), np.asarray(Mj.diag_inv))
    np.testing.assert_allclose(Mt.diag_inv.numpy(), 1 / np.abs(diag), rtol=1e-15)


def test_padded_route_runs_the_conjugate_fold():
    """solve(..., method="cs_minres") on a banded complex64 CSR lays it out as
    a ComplexPaddedDIA, whose Saunders step is K6 with conj_x; the port's
    solve agrees with the JAX package's on the same system."""
    A, jA, rhs, _ = _problem(np.complex64)
    assert isinstance(tsp.optimize(A, device="cpu"), ComplexPaddedDIA)
    kw = dict(method="cs_minres", M="jacobi", tol=1e-5, max_iter=300)
    x, info = tsp.solve(A, rhs, device="cpu", **kw)
    xj, info_j = jsp.solve(jA, rhs, **kw)
    assert info.converged and bool(info_j.converged)
    assert abs(info.iterations - int(info_j.iterations)) <= 2
    xj = np.asarray(xj)
    assert np.linalg.norm(x.numpy() - xj) / np.linalg.norm(xj) < 1e-4
    assert not isinstance(tsp.optimize(tprob.poisson3d(4, 4, 4), device="cpu"),
                          ComplexPaddedDIA)
    assert isinstance(tsp.optimize(tprob.poisson3d(4, 4, 4), device="cpu"), PaddedDIA)
