"""Cross tests of the port's preconditioners against the JAX package's:
Chebyshev with the Lanczos bounds, block-Jacobi, ILU(0)/IC(0) and
RelayedPrecond (cases of ``tests/test_chebyshev.py``,
``tests/test_block_jacobi.py`` and ``tests/test_ilu.py``), and the
Gershgorin bounds.

Tolerances: an apply agrees with JAX's to 1e-14 in f64 (the same
elementwise steps and SpMVs), or 1e-12 where a dense inverse or a Lanczos
sum stands between; the ILU/IC factors to rtol 1e-12 (the JAX side factors
in C++ built with ``-march=native``, which may contract multiply-adds).
Krylov counts under a preconditioner are asserted equal where the two
packages stay in step and otherwise within the band of
``tests/test_serial_parity.py:183``, max(3, ⌈its/4⌉); both must converge."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sprsolve_tpu as jsp
import sprsolve_tpu.ops.pallas_spmv as jps
import sprsolve_tpu_torch as tsp
from sprsolve_tpu import native as jnative
from sprsolve_tpu.utils import bounds as jbounds
from sprsolve_tpu.utils import problems as jprob
from sprsolve_tpu_torch import native
from sprsolve_tpu_torch.errors import InvalidPreconditioner, ZeroDiagonalElem
from sprsolve_tpu_torch.utils import problems as tprob

torch.set_num_threads(2)


def _band(its):
    return max(3, -(-its // 4))


def _spd(side=16, dtype=np.float64):
    dense = (-np.asarray(jprob.sym_grid_laplacian((side, side))[0].todense())).astype(dtype)
    return tsp.csr_from_dense(dense), jsp.csr_from_dense(dense), dense


def _rhs(n, seed, dtype=np.float64):
    return np.random.default_rng(seed).standard_normal(n).astype(dtype)


def _res(A, x, b):
    return float(torch.linalg.vector_norm(A.matvec(x) - torch.as_tensor(b))) / np.linalg.norm(b)


def _counts_close(info, info_j):
    assert info.converged and bool(info_j.converged)
    assert abs(info.iterations - int(info_j.iterations)) <= _band(int(info_j.iterations))


# --------------------------------------------------------------- Chebyshev


def test_chebyshev_apply_matches_jax_and_is_linear():
    A, jA, _ = _spd()
    M = tsp.ChebyshevPrecond(A=A.to_dia(), lmin=0.1, lmax=8.0, degree=4)
    Mj = jsp.ChebyshevPrecond(A=jA.to_dia(), lmin=0.1, lmax=8.0, degree=4)
    r, s = _rhs(256, 0), _rhs(256, 1)
    z = M.matvec(torch.as_tensor(r))
    np.testing.assert_allclose(z.numpy(), np.asarray(Mj.matvec(jnp.asarray(r))),
                               rtol=1e-14, atol=1e-14)
    both = M.matvec(torch.as_tensor(2.0 * r - 3.0 * s))
    np.testing.assert_allclose(both.numpy(),
                               2.0 * z.numpy() - 3.0 * M.matvec(torch.as_tensor(s)).numpy(),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("solver", ["minres", "bicgstab"])
def test_chebyshev_accelerates(solver):
    A, jA, _ = _spd()
    b = _rhs(256, 0 if solver == "minres" else 1)
    deg, tol = (6, 1e-10) if solver == "minres" else (4, 1e-12)
    M = tsp.ChebyshevPrecond(A=A.to_dia(), lmin=0.08, lmax=8.0, degree=deg)
    Mj = jsp.ChebyshevPrecond(A=jA.to_dia(), lmin=0.08, lmax=8.0, degree=deg)
    t, j = getattr(tsp, solver), getattr(jsp, solver)
    x, info = t(A.to_dia(), torch.as_tensor(b), M=M, tol=tol, max_iter=2000)
    _, info_0 = t(A.to_dia(), torch.as_tensor(b), tol=tol, max_iter=2000)
    # about half the iterations (JAX's test asks for fewer than half; the
    # unpreconditioned counts differ by one between the packages)
    assert info.iterations <= info_0.iterations // 2
    _, info_j = j(jA.to_dia(), jnp.asarray(b), M=Mj, tol=tol, max_iter=2000)
    _counts_close(info, info_j)
    _, info_j0 = j(jA.to_dia(), jnp.asarray(b), tol=tol, max_iter=2000)
    _counts_close(info_0, info_j0)
    assert _res(A, x, b) < 1e-8


def test_estimate_lmax_and_spectral_bounds_match_jax():
    A, jA, dense = _spd()
    x = _rhs(256, 2)
    est = tsp.ChebyshevPrecond.estimate_lmax(A.to_dia(), torch.as_tensor(x))
    est_j = jsp.ChebyshevPrecond.estimate_lmax(jA.to_dia(), jnp.asarray(x))
    assert 6.0 < est <= 8.2 and abs(est - est_j) <= 1e-10 * est_j
    ev = np.linalg.eigvalsh(dense)
    lmin, lmax = tsp.estimate_spectral_bounds(A, m=40, seed=0)
    lmin_j, lmax_j = jsp.estimate_spectral_bounds(jA, m=40, seed=0)
    np.testing.assert_allclose([lmin, lmax], [lmin_j, lmax_j], rtol=1e-8)
    assert 0 < lmin and lmax >= ev[-1] * 0.999 and lmax <= ev[-1] * 1.2
    assert lmin <= ev[0] * 1.001 or lmin <= ev[0] + 0.05 * (ev[-1] - ev[0])


def test_chebyshev_auto_on_the_padded_layout():
    """``auto`` on a PaddedDIA starts Lanczos from a padded vector, and the
    apply keeps the halo at zero; MINRES with it needs under half the
    iterations, in as many as JAX's with the same bounds within the band."""
    A, jA, _ = _spd()
    p = tsp.PaddedDIA.from_dia(A.to_dia(), device="cpu")
    M = tsp.ChebyshevPrecond.auto(p, degree=6, lanczos_iters=30)
    lmin, lmax = tsp.estimate_spectral_bounds(A.to_dia(), m=30, seed=0)
    np.testing.assert_allclose([M.lmin, M.lmax], [lmin, lmax], rtol=1e-10)
    b = _rhs(256, 5)
    b2 = p.pad_vec(torch.as_tensor(b))
    z = M.matvec(b2)
    assert not bool(z[: p.h].any()) and not bool(z[p.h + p.n:].any())
    x2, info = tsp.minres(p, b2, M=M, tol=1e-10, max_iter=2000)
    _, info_0 = tsp.minres(p, b2, tol=1e-10, max_iter=2000)
    assert info.converged and info.iterations < info_0.iterations // 2
    assert _res(A, p.unpad_vec(x2), b) < 1e-8
    Mj = jsp.ChebyshevPrecond(A=jA.to_dia(), lmin=M.lmin, lmax=M.lmax, degree=6)
    _, info_j = jsp.minres(jA.to_dia(), jnp.asarray(b), M=Mj, tol=1e-10, max_iter=2000)
    _counts_close(info, info_j)


def test_chebyshev_auto_rejects_indefinite():
    dense = np.asarray(jprob.sym_grid_laplacian((8, 8))[0].todense())
    with pytest.raises(InvalidPreconditioner):
        tsp.ChebyshevPrecond.auto(tsp.csr_from_dense(dense))


# ------------------------------------------------------------ block-Jacobi


def _blockdiag_inv_oracle(dense, bs):
    out = np.zeros_like(dense)
    for s in range(0, dense.shape[0], bs):
        e = min(s + bs, dense.shape[0])
        out[s:e, s:e] = np.linalg.inv(dense[s:e, s:e])
    return out


@pytest.mark.parametrize("complex_", [False, True])
def test_block_jacobi_apply_matches_oracle_and_jax(complex_):
    rng = np.random.default_rng(0)
    if complex_:
        n, bs = 24, 6
        h = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
        dense = h @ h.conj().T + np.eye(n) * n   # HPD
        r = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    else:
        n, bs = 50, 8   # a ragged tail block
        dense = rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.2) + np.eye(n) * 5.0
        r = rng.standard_normal(n)
    M = tsp.BlockJacobiPrecond.from_csr(tsp.csr_from_dense(dense), block_size=bs)
    Mj = jsp.BlockJacobiPrecond.from_csr(jsp.csr_from_dense(dense), block_size=bs)
    got = M.matvec(torch.as_tensor(r)).numpy()
    np.testing.assert_allclose(got, _blockdiag_inv_oracle(dense, bs) @ r, rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_allclose(got, np.asarray(Mj.matvec(jnp.asarray(r))), rtol=1e-12,
                               atol=1e-14)
    if complex_:
        quad = np.vdot(r, got)   # HPD apply: MINRES's β² gate
        assert abs(quad.imag) < 1e-10 * abs(quad) and quad.real > 0


def test_block_size_one_equals_diag_precond():
    A, _, _ = _spd(8)
    r = torch.as_tensor(_rhs(64, 1))
    M1 = tsp.BlockJacobiPrecond.from_csr(A, block_size=1)
    np.testing.assert_allclose(M1.matvec(r).numpy(),
                               tsp.DiagPrecond.new(A.diagonal()).matvec(r).numpy(), rtol=1e-12)


def test_block_jacobi_accelerates_cg_and_passes_minres_gate():
    A, jA, _ = _spd()
    b = _rhs(256, 3)
    M = tsp.BlockJacobiPrecond.from_csr(A, block_size=16)
    Mj = jsp.BlockJacobiPrecond.from_csr(jA, block_size=16)
    x, info = tsp.cg(A.to_dia(), torch.as_tensor(b), M=M, tol=1e-10, max_iter=2000)
    _, info_0 = tsp.cg(A.to_dia(), torch.as_tensor(b), tol=1e-10, max_iter=2000)
    assert info.iterations < info_0.iterations and _res(A, x, b) < 1e-8
    _, info_j = jsp.cg(jA.to_dia(), jnp.asarray(b), M=Mj, tol=1e-10, max_iter=2000)
    _counts_close(info, info_j)
    _, info_m = tsp.minres(A.to_dia(), torch.as_tensor(b), M=M, tol=1e-10, max_iter=2000)
    info_m.raise_if_error()


def test_block_jacobi_singular_block_raises():
    dense = np.zeros((4, 4))
    dense[2, 3] = dense[3, 2] = dense[0, 2] = 1.0
    with pytest.raises(InvalidPreconditioner):
        tsp.BlockJacobiPrecond.from_csr(tsp.csr_from_dense(dense), block_size=2)


def test_block_jacobi_f32_product_runs_at_full_precision():
    """The f32 apply rounds like the f32 reference product (TF32 is off for
    the batched product): within 1e-6 of the f64 apply, as JAX's HIGHEST."""
    A, jA, _ = _spd(8, np.float32)
    r = _rhs(64, 6, np.float32)
    got = tsp.BlockJacobiPrecond.from_csr(A, block_size=16).matvec(torch.as_tensor(r))
    want = _blockdiag_inv_oracle(np.asarray(jA.todense(), np.float64), 16) @ r
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


# -------------------------------------------------------------- ILU / IC


def _parts(A):
    return (A.shape[0], A.indptr.numpy().astype(np.int64), A.indices.numpy().astype(np.int32),
            A.data.numpy())


def _factor_fixtures():
    rng = np.random.default_rng(3)
    n = 20
    cplx = np.diag(4.0 + 1j + rng.random(n)).astype(np.complex128)
    for off in (1, 2):
        v = (rng.random(n - off) + 1j * rng.random(n - off)) * 0.5
        cplx += np.diag(v, off) + np.diag(v * 0.7, -off)
    tri = np.diag(np.full(40, 4.0)) - np.diag(np.ones(39), 1) - np.diag(np.ones(39), -1)
    return {"spd16": _spd()[2], "tridiagonal": tri, "complex20": cplx,
            "spd8_f32": _spd(8, np.float32)[2]}


@pytest.mark.parametrize("name", ["spd16", "tridiagonal", "complex20", "spd8_f32"])
def test_ilu0_ic0_factors_match_jax(name):
    dense = _factor_fixtures()[name]
    n, indptr, indices, vals = _parts(tsp.csr_from_dense(dense))
    rtol = 1e-12 if vals.dtype.itemsize * (2 if np.iscomplexobj(vals) else 1) >= 8 else 1e-6
    f, f_j = native.ilu0(n, indptr, indices, vals), jnative.ilu0(n, indptr, indices, vals)
    assert f.dtype == vals.dtype
    np.testing.assert_allclose(f, f_j, rtol=rtol, atol=0)
    if name != "complex20":
        c, c_j = native.ic0(n, indptr, indices, vals), jnative.ic0(n, indptr, indices, vals)
        np.testing.assert_allclose(c, c_j, rtol=rtol, atol=0)
    # the defining ILU(0) property on the pattern: (L·U)_ij = A_ij
    L, U = np.eye(n, dtype=f.dtype), np.zeros((n, n), f.dtype)
    for i in range(n):
        for p in range(indptr[i], indptr[i + 1]):
            (L if indices[p] < i else U)[i, indices[p]] = f[p]
    P = L @ U
    rows = np.repeat(np.arange(n), np.diff(indptr))
    np.testing.assert_allclose(P[rows, indices], dense[rows, indices], rtol=1e-5, atol=1e-5)


def test_symmetrize_and_color_match_jax():
    A, jA, _ = _spd(6)
    rng = np.random.default_rng(0)
    dense = rng.standard_normal((30, 30)) * (rng.random((30, 30)) < 0.1) + np.eye(30)
    for M in (A, tsp.csr_from_dense(dense)):
        n, indptr, indices, _ = _parts(M)
        ip, ind = native.symmetrize_pattern(n, indptr, indices)
        ip_j, ind_j = jnative.symmetrize_pattern(n, indptr, indices)
        np.testing.assert_array_equal(ip, ip_j)
        np.testing.assert_array_equal(ind, ind_j)
        np.testing.assert_array_equal(native.greedy_color(n, ip, ind),
                                      jnative.greedy_color(n, ip_j, ind_j))


def test_ilu0_zero_pivot_and_ic0_not_spd_raise():
    with pytest.raises(ZeroDiagonalElem):
        tsp.ILU0Precond.from_csr(tsp.csr_from_dense(np.array([[0.0, 1.0], [1.0, 1.0]])))
    with pytest.raises(InvalidPreconditioner):
        tsp.IC0Precond.from_csr(tsp.csr_from_dense(np.array([[1.0, 2.0], [2.0, 1.0]])))


def test_ilu0_apply_matches_jax_and_is_exact_with_enough_sweeps():
    A, jA, _ = _spd(5)
    n = A.shape[0]
    r = _rhs(n, 0)
    M3, M3j = tsp.ILU0Precond.from_csr(A), jsp.ILU0Precond.from_csr(jA)
    np.testing.assert_allclose(M3.matvec(torch.as_tensor(r)).numpy(),
                               np.asarray(M3j.matvec(jnp.asarray(r))), rtol=1e-12, atol=1e-14)
    M = tsp.ILU0Precond.from_csr(A, sweeps=n)
    f = native.ilu0(*_parts(A))
    _, indptr, indices, _ = _parts(A)
    L, U = np.eye(n), np.zeros((n, n))
    for i in range(n):
        for p in range(indptr[i], indptr[i + 1]):
            (L if indices[p] < i else U)[i, indices[p]] = f[p]
    want = np.linalg.solve(U, np.linalg.solve(L, r))
    np.testing.assert_allclose(M.matvec(torch.as_tensor(r)).numpy(), want, rtol=1e-10,
                               atol=1e-12)


def test_ilu0_on_an_unbanded_pattern_matches_jax(monkeypatch):
    """A random pattern has more diagonals than the banded layouts take, so
    the triangular parts get the cost model's layout: under the JAX
    package's cost constants, BSR as there; the apply and a BiCGStab solve
    agree with JAX's."""
    import importlib

    jopt = importlib.import_module("sprsolve_tpu.ops.optimize")
    monkeypatch.setattr(importlib.import_module("sprsolve_tpu_torch.ops.optimize"), "COSTS", {
        "eff_dia": jopt._EFF_XLA_DIA, "eff_bsr": jopt._EFF_BSR,
        "eff_padded_dia": jopt._EFF_PALLAS_DIA, "scatter_bytes_eq": jopt._SCATTER_BYTES_EQ})
    rng = np.random.default_rng(9)
    n = 60
    dense = rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.1) + np.eye(n) * 6.0
    A, jA = tsp.csr_from_dense(dense), jsp.csr_from_dense(dense)
    M, Mj = tsp.ILU0Precond.from_csr(A), jsp.ILU0Precond.from_csr(jA)
    assert isinstance(M.L_s, tsp.BSR) and isinstance(M.U_s, tsp.BSR)
    assert type(Mj.L_s).__name__ == type(Mj.U_s).__name__ == "BSR"
    r = _rhs(n, 1)
    np.testing.assert_allclose(M.matvec(torch.as_tensor(r)).numpy(),
                               np.asarray(Mj.matvec(jnp.asarray(r))), rtol=1e-12, atol=1e-14)
    x, info = tsp.bicgstab(A, torch.as_tensor(r), M=M, tol=1e-10, max_iter=500)
    _, info_j = jsp.bicgstab(jA, jnp.asarray(r), M=Mj, tol=1e-10, max_iter=500)
    _counts_close(info, info_j)
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(dense, r), rtol=1e-8, atol=1e-9)


def test_ic0_apply_is_spd_and_matches_jax():
    A, jA, _ = _spd(6)
    n = A.shape[0]
    for sweeps in (1, 2, 5):
        M = tsp.IC0Precond.from_csr(A, sweeps=sweeps)
        Mj = jsp.IC0Precond.from_csr(jA, sweeps=sweeps)
        D = np.column_stack([M.matvec(torch.eye(n, dtype=torch.float64)[:, i]).numpy()
                             for i in range(n)])
        Dj = np.column_stack([np.asarray(Mj.matvec(jnp.eye(n)[:, i])) for i in range(n)])
        np.testing.assert_allclose(D, Dj, rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(D, D.T, atol=1e-12)
        assert np.linalg.eigvalsh(0.5 * (D + D.T)).min() > 0


@pytest.mark.parametrize("kind", ["ilu0_bicgstab", "ic0_minres"])
def test_factored_preconditioners_accelerate(kind):
    A, jA, _ = _spd()
    b = _rhs(256, 0 if kind == "ilu0_bicgstab" else 1)
    if kind == "ilu0_bicgstab":
        M, Mj = tsp.ILU0Precond.from_csr(A, sweeps=3), jsp.ILU0Precond.from_csr(jA, sweeps=3)
        t, j, tol = tsp.bicgstab, jsp.bicgstab, 1e-10
        M0 = tsp.DiagPrecond.new(A.diagonal())
    else:
        M, Mj = tsp.IC0Precond.from_csr(A, sweeps=3), jsp.IC0Precond.from_csr(jA, sweeps=3)
        t, j, tol, M0 = tsp.minres, jsp.minres, 1e-8, None
    assert isinstance(M.L_s, tsp.DIA)   # prefer_kernels=False: the flat DIA layout
    x, info = t(A.to_dia(), torch.as_tensor(b), M=M, tol=tol, max_iter=2000)
    info.raise_if_error()   # IC0: the SPD apply passes MINRES's β² gate
    _, info_0 = t(A.to_dia(), torch.as_tensor(b), M=M0, tol=tol, max_iter=2000)
    assert info.iterations < info_0.iterations
    _, info_j = j(jA.to_dia(), jnp.asarray(b), M=Mj, tol=tol, max_iter=2000)
    _counts_close(info, info_j)
    assert _res(A, x, b) < 1e-6


# ------------------------------------------------------- through solve()


@pytest.mark.parametrize("method,M", [("bicgstab", "ilu0"), ("minres", "ic0"),
                                      ("cg", "block_jacobi"), ("bicgstab", "block_jacobi")])
def test_solve_builds_and_relays_the_string_preconditioners(method, M):
    """f32 routes to the PaddedDIA; the flat preconditioner built from the
    CSR runs through RelayedPrecond. The JAX package relays the same way."""
    A, jA, _ = _spd(16, np.float32)
    b = _rhs(256, 2, np.float32)
    kw = dict(method=method, M=M, tol=1e-5, max_iter=2000)
    h = tsp.prepare(A, device="cpu", **kw)
    assert isinstance(h.operator, tsp.PaddedDIA)
    assert isinstance(h._run.keywords["M"], tsp.RelayedPrecond)
    x, info = h(b)
    assert info.converged and _res(A, x, b) < 1e-4
    xj, info_j = jsp.solve(jA, b, **kw)
    _counts_close(info, info_j)
    assert float(np.linalg.norm(x.numpy() - np.asarray(xj)) / np.linalg.norm(xj)) < 1e-3


def test_string_preconditioners_need_the_matrix_and_cs_minres_refuses_them():
    A, jA, _ = _spd(6)
    b = _rhs(36, 0)
    with pytest.raises(InvalidPreconditioner):
        tsp.solve(A.to_dia(), b, M="ilu0", device="cpu")
    for M in ("ilu0", "ic0", "block_jacobi", tsp.ILU0Precond.from_csr(A),
              tsp.IC0Precond.from_csr(A)):
        with pytest.raises(InvalidPreconditioner):
            tsp.solve(A, b, method="cs_minres", M=M, device="cpu")
    Z = tsp.csr_from_dense(np.asarray(jA.todense()) * (1 + 0.5j))
    with pytest.raises(InvalidPreconditioner):
        tsp.solve(Z, b.astype(complex), method="cs_minres",
                  M=tsp.BlockJacobiPrecond.from_csr(Z, block_size=4), device="cpu")


def test_relayed_precond_on_a_padded_operator():
    """RelayedPrecond unpads, applies the flat preconditioner and pads again:
    the body bitwise the flat apply, the halo and tail zero."""
    A, _, _ = _spd(16, np.float32)
    p = tsp.PaddedDIA.from_dia(A.to_dia(), device="cpu")
    inner = tsp.BlockJacobiPrecond.from_csr(A, block_size=16)
    R = tsp.RelayedPrecond(inner=inner, op=p)
    r = torch.as_tensor(_rhs(256, 4, np.float32))
    z2, d = R.matvec_dot(p.pad_vec(r))
    assert z2.shape == (p.padded_len,)
    assert torch.equal(p.unpad_vec(z2), inner.matvec(r))
    assert not bool(z2[: p.h].any()) and not bool(z2[p.h + p.n:].any())
    assert abs(float(d) - float(r @ inner.matvec(r))) <= 1e-5 * abs(float(d))
    assert R.shape == (256, 256)


def test_gershgorin_bounds_match_jax():
    A, jA, dense = _spd(8)
    for t, j in ((A, jA), (A.to_dia(), jA.to_dia())):
        np.testing.assert_allclose(tsp.gershgorin_bounds(t), jbounds.gershgorin_bounds(j),
                                   rtol=1e-14)
    lo, hi = tsp.gershgorin_bounds(A)
    ev = np.linalg.eigvalsh(dense)
    assert lo <= ev[0] and ev[-1] <= hi


def test_masked_gs_and_chebyshev_on_padded_kernels_layout_match_plain():
    """A MaskedGSPrecond and a ChebyshevPrecond built on the port's
    PaddedDIA give the apply of the same preconditioner on the flat DIA
    (f64, to 1e-14): the padded layout changes nothing but the halo."""
    A, _, _ = _spd(12)
    p = tsp.PaddedDIA.from_dia(A.to_dia(), device="cpu")
    colors = tsp.greedy_color(A)
    masks = tuple(p.pad_vec(m.to(torch.float64)) > 0 for m in tsp.color_masks(colors))
    r = torch.as_tensor(_rhs(144, 7))
    for sym in (False, True):
        M = tsp.MaskedGSPrecond(A=p, diag=p.diagonal_padded(), masks=masks, omega=1.5,
                                symmetric=sym)
        Mf = tsp.MaskedGSPrecond(A=A.to_dia(), diag=A.diagonal(),
                                 masks=tsp.color_masks(colors), omega=1.5, symmetric=sym)
        np.testing.assert_allclose(p.unpad_vec(M.matvec(p.pad_vec(r))).numpy(),
                                   Mf.matvec(r).numpy(), rtol=1e-14, atol=1e-14)
    C = tsp.ChebyshevPrecond(A=p, lmin=0.1, lmax=8.0, degree=4)
    Cf = tsp.ChebyshevPrecond(A=A.to_dia(), lmin=0.1, lmax=8.0, degree=4)
    np.testing.assert_allclose(p.unpad_vec(C.matvec(p.pad_vec(r))).numpy(),
                               Cf.matvec(r).numpy(), rtol=1e-14, atol=1e-14)


def test_abs_jacobi_is_correctly_rounded_as_jax():
    """The real 1/|d| Jacobi of a two-plane operator (CS-MINRES's
    ``M="jacobi"``) takes a correctly rounded square root, bit for bit the
    JAX package's ``jnp.sqrt(dr*dr + di*di)`` (``sprsolve_tpu/precond.py:609-611``):
    torch's CPU sqrt of a large float64 tensor is about 1% 1 ULP off and
    changed bits between processes, which moved the c128 CS-MINRES count
    on the damped 100³ Poisson from 297 to 362 in 1 of 20 runs. The
    diagonal here is 6 + u + 0.5i with u uniform in [0, 1): many distinct
    magnitudes."""
    A = tprob.poisson3d(40, 40, 40)
    Z = tsp.CSR.from_arrays(A.data.numpy().astype(np.complex128), A.indices, A.indptr,
                            A.shape)
    u = np.random.default_rng(11).uniform(0.0, 1.0, A.shape[0])
    Z.data[Z.indices == Z.row_ids] += torch.as_tensor(u + 0.5j)
    op = tsp.ComplexPaddedDIA.from_csr(Z, device="cpu")
    got = tsp.precond.real_abs_jacobi(op).diag_inv.numpy()
    dr, di = op.re.diagonal_padded().numpy(), op.im.diagonal_padded().numpy()
    d = jnp.sqrt(dr * dr + di * di)
    want = np.asarray(jnp.ones((), d.dtype) / jnp.where(d == 0, jnp.ones((), d.dtype), d))
    assert np.array_equal(got, want)
