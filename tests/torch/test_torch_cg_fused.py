"""CG's fused update route (U = ``ops.fused.cg_update``, P =
``ops.fused.cg_direction``) on the CPU, where the wrappers run their plain
versions.

The routed loop must give bitwise the x, count, residual and history of the
unfused loop, built here op for op from ``vecalg`` (the loop ``cg`` ran
before U and P): the plain versions repeat its ``addcmul``/``mul``/``sum``
sequence, so the JAX cross tests of ``test_torch_cg.py`` hold unchanged.
Which loop runs is read from counting shims over U and P."""

import importlib

import numpy as np
import pytest
import torch

import sprsolve_tpu_torch as tsp
from sprsolve_tpu_torch.errors import Status
from sprsolve_tpu_torch.ops import fused
from sprsolve_tpu_torch.ops import padded_dia as pd
from sprsolve_tpu_torch.solvers.common import read_flags
from sprsolve_tpu_torch.utils import problems
from sprsolve_tpu_torch.vecalg import axpy, conj_dot, norm2

cg_module = importlib.import_module("sprsolve_tpu_torch.solvers.cg")
torch.set_num_threads(2)


def _counting(orig):
    def shim(*args, **kwargs):
        shim.calls += 1
        return orig(*args, **kwargs)

    shim.calls = 0
    return shim


@pytest.fixture
def shims(monkeypatch):
    """U and P behind counting shims: ``(U shim, P shim)``."""
    u, p = _counting(fused.cg_update), _counting(fused.cg_direction)
    monkeypatch.setattr(fused, "cg_update", u)
    monkeypatch.setattr(fused, "cg_direction", p)
    return u, p


def _unfused_cg(A, b, x0, M, tol, max_iter):
    """The unfused CG iteration from ``vecalg`` ops: ``(x, iterations,
    status, residual, history)``, the history a list of the relative
    residuals at the top of each iteration (and the converged one)."""
    one = torch.ones((), dtype=b.dtype)
    rhs_norm = norm2(b)
    tol2 = torch.tensor(tol, dtype=b.dtype) * rhs_norm
    r = axpy(-one, A.matvec(x0), b)
    r_norm = norm2(r)
    z = r if M is None else M.matvec(r)
    x, p, rz = x0, z, conj_dot(r, z)
    hist = []
    its = 0
    while its < max_iter and bool(r_norm > tol2):
        hist.append(r_norm / rhs_norm)
        q, pq = A.matvec_dot(p)
        ok = pq > 0
        alpha = rz / torch.where(ok, pq, one)
        x_next = axpy(alpha, p, x)
        r = axpy(-alpha, q, r)
        z = r if M is None else M.matvec(r)
        rz_next = conj_dot(r, z)
        p = axpy(rz_next / rz, p, z)
        rz = rz_next
        r_norm_next = norm2(r)
        if not bool(ok):
            return x, its, Status.BREAKDOWN, r_norm / rhs_norm, hist
        x, r_norm, its = x_next, r_norm_next, its + 1
    converged = bool(r_norm <= tol2)
    if converged:
        hist.append(r_norm / rhs_norm)
    status = Status.CONVERGED if converged else Status.INSUFFICIENT_ITER
    return x, its, status, r_norm / rhs_norm, hist


def _system(name):
    """``(operator, b, M)`` on the 8³ Poisson: f64 on the padded layout
    with or without its Jacobi, or f32 on the flat CSR with Jacobi."""
    dtype = np.float32 if name == "f32_flat_jacobi" else np.float64
    A = problems.poisson3d(8, 8, 8, dtype=dtype)
    b = torch.as_tensor(np.random.default_rng(4).standard_normal(512).astype(dtype))
    if name == "f32_flat_jacobi":
        return A, b, tsp.DiagPrecond.new(A.diagonal())
    op = pd.PaddedDIA.from_dia(A.to_dia(), device="cpu")
    return op, op.pad_vec(b), (op.jacobi_precond() if name == "f64_padded_jacobi" else None)


@pytest.mark.parametrize("max_iter", [500, 7])
@pytest.mark.parametrize("name", ["f64_padded", "f64_padded_jacobi", "f32_flat_jacobi"])
def test_routed_cg_is_bitwise_the_unfused_loop(name, max_iter, shims):
    A, b, M = _system(name)
    tol = 1e-5 if b.dtype == torch.float32 else 1e-10
    x, info, hist = tsp.cg(A, b, M=M, tol=tol, max_iter=max_iter, record_residuals=True)
    x_ref, its, status, res, hist_ref = _unfused_cg(A, b, torch.zeros_like(b), M, tol,
                                                    max_iter)
    assert (info.iterations, info.status) == (its, int(status))
    assert info.converged == (max_iter == 500)
    assert shims[0].calls == shims[1].calls == its
    assert torch.equal(x, x_ref)
    assert torch.equal(torch.as_tensor(info.residual), res)
    k = len(hist_ref)
    assert torch.equal(hist[:k], torch.stack(hist_ref)) and bool(hist[k:].isnan().all())


def test_routed_cg_breaks_down_on_a_negative_definite_grid_with_x0(shims):
    """pᵀAp < 0 on the first step: BREAKDOWN, count 0, x the caller's x0
    bit for bit, and the residual of x0, as the unfused loop gives."""
    A, rhs = problems.sym_grid_laplacian((8, 8))
    b = torch.from_numpy(rhs)
    x0 = torch.as_tensor(np.random.default_rng(2).standard_normal(64))
    x0_before = x0.clone()
    x, info = tsp.cg(A, b, x0, tol=1e-10, max_iter=100)
    _, its, status, res, _ = _unfused_cg(A, b, x0, None, 1e-10, 100)
    assert info.status == Status.BREAKDOWN == status and info.iterations == its == 0
    assert torch.equal(x, x0_before) and torch.equal(x0, x0_before)
    assert torch.equal(torch.as_tensor(info.residual), res)
    assert shims[0].calls == shims[1].calls == 1


@pytest.mark.parametrize("name", ["f64_padded_jacobi", "f32_flat_jacobi"])
def test_routed_cg_leaves_the_callers_b_and_x0_alone(name, shims):
    A, b, M = _system(name)
    x0 = torch.as_tensor(np.random.default_rng(9).standard_normal(b.shape[0]), dtype=b.dtype)
    if name == "f64_padded_jacobi":
        x0 = A.pad_vec(A.unpad_vec(x0))   # the padded layout's zero halo
    b_before, x0_before = b.clone(), x0.clone()
    x, info = tsp.cg(A, b, x0, M=M, tol=1e-5, max_iter=500)
    assert info.converged and shims[0].calls == info.iterations > 0
    assert torch.equal(b, b_before) and torch.equal(x0, x0_before)
    assert x is not x0 and x is not b


def _complex_system():
    """The 6³ Poisson in c128 (Hermitian positive definite), a complex b."""
    P = problems.poisson3d(6, 6, 6, dtype=np.float64)
    A = tsp.CSR.from_arrays(P.data.numpy().astype(np.complex128), P.indices, P.indptr,
                            P.shape)
    rng = np.random.default_rng(1)
    return A, torch.as_tensor(rng.standard_normal(216) + 1j * rng.standard_normal(216)), None


def _ic0_system():
    A = problems.poisson3d(6, 6, 6, dtype=np.float64)
    b = torch.as_tensor(np.random.default_rng(1).standard_normal(216))
    return A, b, tsp.IC0Precond.from_csr(A, device="cpu")


def _wider_diagonal_system():
    A = problems.poisson3d(6, 6, 6, dtype=np.float32)
    b = torch.as_tensor(np.random.default_rng(1).standard_normal(216).astype(np.float32))
    return A, b, tsp.DiagPrecond.new(A.diagonal().double())


@pytest.mark.parametrize("make", [_complex_system, _ic0_system, _wider_diagonal_system],
                         ids=["complex", "ic0", "f64_diagonal_on_f32"])
def test_cg_keeps_the_unfused_loop_where_the_route_does_not_apply(make, shims):
    A, b, M = make()
    x, info = tsp.cg(A, b, M=M, tol=1e-5, max_iter=500)
    assert info.converged and info.iterations > 0
    assert shims[0].calls == shims[1].calls == 0


def test_cg_route_decision_reads_dtype_group_and_m():
    """The route engages on a flat real b and an x0 of its dtype with M
    None, the identity or a DiagPrecond of b's length, dtype and device,
    and never with a group."""
    b = torch.ones(16)
    diag = tsp.DiagPrecond(diag_inv=torch.full((16,), 0.5))
    assert cg_module._fused_dinv(b, b, None, None) == (True, None)
    assert cg_module._fused_dinv(b, b, tsp.IdentityOperator(16), None) == (True, None)
    routed, dinv = cg_module._fused_dinv(b, b, diag, None)
    assert routed and torch.equal(dinv, diag.diag_inv)
    z = b.to(torch.complex64)
    for args in ((b, b, diag, object()), (z, z, None, None), (b, b.double(), None, None),
                 (b, b, tsp.DiagPrecond(diag_inv=torch.full((8,), 0.5)), None),
                 (b.reshape(4, 4), b.reshape(4, 4), None, None)):
        assert cg_module._fused_dinv(*args) == (False, None)


def test_cg_update_and_direction_plain_versions_write_in_place():
    """U with r as its own output and P with p as its own: the outputs are
    the given tensors, and their values those of fresh outputs."""
    rng = np.random.default_rng(6)
    x, p, r, q, d = (torch.as_tensor(rng.standard_normal(1000)) for _ in range(5))
    rz, pq, tol = torch.tensor(0.8), torch.tensor(2.5), torch.tensor(1e-3)
    fresh = fused.cg_update(x, p, r, q, d, rz, pq, tol, torch.empty_like(x),
                            torch.empty_like(r))
    r_in = r.clone()
    xo = torch.empty_like(x)
    got = fused.cg_update(x, p, r_in, q, d, rz, pq, tol, xo, r_in)
    assert got[0] is xo and got[1] is r_in
    assert all(torch.equal(a, b) for a, b in zip(got, fresh))
    assert got[2][3:].tolist() == [1.0, 1.0, 0.0]
    p_in = p.clone()
    out = fused.cg_direction(p_in, r_in, d, got[2][0], rz, p_in)
    assert out is p_in
    assert torch.equal(out, fused.cg_direction(p, r_in, d, got[2][0], rz,
                                               torch.empty_like(p)))


def test_cg_update_and_direction_refuse_what_the_kernels_do_not_take():
    v = torch.ones(64)
    c = torch.tensor(1.0)
    with pytest.raises(TypeError):
        fused.cg_update(*(v.to(torch.complex64),) * 4, None, c, c, c, *(v,) * 2)
    with pytest.raises(ValueError, match="one length"):
        fused.cg_update(v, v, v, torch.ones(32), None, c, c, c, v, v)
    with pytest.raises(ValueError, match="contiguous"):
        fused.cg_direction(v, torch.ones(128)[::2], None, c, c, v)


def test_reset_launch_counts_zeroes_u_and_p_and_read_flags_takes_a_vector():
    fused.cg_update.launches = fused.cg_direction.launches = 5
    pd.reset_launch_counts()
    assert fused.cg_update.launches == fused.cg_direction.launches == 0
    assert read_flags(torch.tensor([1.0, 0.0, 1.0])) == [1.0, 0.0, 1.0]
    assert read_flags.calls == 1
