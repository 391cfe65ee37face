"""CS-MINRES's fused update route (A = ``ops.fused.csm_lanczos``, B =
``ops.fused.csm_update``) on the CPU, where the wrappers run their plain
versions.

The routed loop must give bitwise the x, count, status and residual of the
unfused loop, which ``cs_minres`` still runs for every input the route
refuses: the plain versions repeat its ``addcmul``/``mul``/``sum`` sequence
and share its Givens step, so the JAX cross tests of
``test_torch_cs_minres.py`` hold unchanged. The unfused loop is reached
here by refusing the route (``_fused_dinv`` patched to say no); which loop
ran is read from counting shims over A and B."""

import importlib

import numpy as np
import pytest
import torch

import sprsolve_tpu_torch as tsp
from sprsolve_tpu_torch.errors import Status
from sprsolve_tpu_torch.ops import fused
from sprsolve_tpu_torch.ops import padded_dia as pd
from sprsolve_tpu_torch.precond import real_abs_jacobi
from sprsolve_tpu_torch.utils import problems

csm_module = importlib.import_module("sprsolve_tpu_torch.solvers.cs_minres")
torch.set_num_threads(2)

DTYPES = {"c64": (np.complex64, torch.complex64), "c128": (np.complex128, torch.complex128)}


def _counting(orig):
    def shim(*args, **kwargs):
        shim.calls += 1
        return orig(*args, **kwargs)

    shim.calls = 0
    return shim


@pytest.fixture
def shims(monkeypatch):
    """A and B behind counting shims: ``(A shim, B shim)``."""
    a, b = _counting(fused.csm_lanczos), _counting(fused.csm_update)
    monkeypatch.setattr(fused, "csm_lanczos", a)
    monkeypatch.setattr(fused, "csm_update", b)
    return a, b


def _damped(side: int, dtype: str, layout: str, seed: int = 3):
    """``(operator, b)``: the damped complex-symmetric Poisson A + 0.5i·I on
    side³ in ``dtype``, laid out by ``optimize`` (``ComplexPaddedDIA``, K6's
    plain version) or left a CSR, and a complex normal b in its layout."""
    np_dt, _ = DTYPES[dtype]
    P = problems.poisson3d(side, side, side, dtype=np.float64)
    data = P.data.numpy().astype(np_dt)
    rows = np.repeat(np.arange(P.shape[0]), np.diff(P.indptr.numpy()))
    data[P.indices.numpy() == rows] += 0.5j
    A = tsp.CSR.from_arrays(data, P.indices, P.indptr, P.shape)
    rng = np.random.default_rng(seed)
    b = torch.as_tensor((rng.standard_normal(P.shape[0])
                         + 1j * rng.standard_normal(P.shape[0])).astype(np_dt))
    if layout == "csr":
        return A, b
    op = tsp.optimize(A, device="cpu")
    assert isinstance(op, pd.ComplexPaddedDIA)
    return op, op.pad_vec(b)


def _solve(A, b, M, routed, monkeypatch, x0=None, **kw):
    """``cs_minres`` with the route as it decides (``routed``) or refused."""
    with monkeypatch.context() as m:
        if not routed:
            m.setattr(csm_module, "_fused_dinv", lambda *args: (False, None))
        return tsp.cs_minres(A, b, x0, M=M, **kw)


@pytest.mark.parametrize("max_iter", [400, 9])
@pytest.mark.parametrize("precond", ["abs_jacobi", "none"])
@pytest.mark.parametrize("dtype,layout", [("c64", "padded"), ("c128", "padded"),
                                          ("c128", "csr")])
def test_routed_cs_minres_is_bitwise_the_unfused_loop(dtype, layout, precond, max_iter,
                                                      shims, monkeypatch):
    A, b = _damped(8, dtype, layout)
    M = real_abs_jacobi(A) if precond == "abs_jacobi" else None
    tol = 1e-5 if dtype == "c64" else 1e-10
    x_ref, info_ref = _solve(A, b, M, False, monkeypatch, tol=tol, max_iter=max_iter)
    assert shims[0].calls == shims[1].calls == 0
    x, info = _solve(A, b, M, True, monkeypatch, tol=tol, max_iter=max_iter)
    assert (info.iterations, info.status) == (info_ref.iterations, info_ref.status)
    assert info.converged == (max_iter == 400)
    # a converged solve makes its + 1 passes; one stopped at max_iter its
    assert shims[0].calls == shims[1].calls == info.iterations + info.converged > 0
    assert torch.equal(x, x_ref)
    assert torch.equal(torch.as_tensor(info.residual), torch.as_tensor(info_ref.residual))


def test_routed_cs_minres_leaves_the_callers_b_and_x0_alone(shims, monkeypatch):
    A, b = _damped(6, "c128", "padded")
    M = real_abs_jacobi(A)
    g = np.random.default_rng(8)
    x0 = A.pad_vec(torch.as_tensor(g.standard_normal(A.n) + 1j * g.standard_normal(A.n)))
    b_before, x0_before = b.clone(), x0.clone()
    x_ref, info_ref = _solve(A, b, M, False, monkeypatch, x0=x0, tol=1e-10, max_iter=400)
    x, info = _solve(A, b, M, True, monkeypatch, x0=x0, tol=1e-10, max_iter=400)
    assert info.converged and shims[0].calls == info.iterations + 1
    assert info.iterations == info_ref.iterations and torch.equal(x, x_ref)
    assert torch.equal(b, b_before) and torch.equal(x0, x0_before)
    assert x is not x0 and x is not b


@pytest.mark.parametrize("scale", [-40.0, -2.0])
@pytest.mark.parametrize("x0_kind", ["zero", "random"])
def test_routed_beta_gate_exit_leaves_x_as_the_unfused_loop(x0_kind, scale, shims,
                                                            monkeypatch):
    """M⁻¹ = diag(d⁻¹) with one entry times ``scale``: β² turns negative at
    once (−40) or after 7-11 iterations (−2); the routed loop exits
    INVALID_PRECONDITIONER with the unfused loop's count, residual and x (x0
    where no step ran), and B never runs after the failing gate."""
    A, b = _damped(6, "c128", "padded")
    d = real_abs_jacobi(A).diag_inv.clone()
    d[A.h + 50] = scale * d[A.h + 50]
    M = tsp.DiagPrecond(diag_inv=d)
    g = np.random.default_rng(5)
    x0 = (torch.zeros_like(b) if x0_kind == "zero" else
          A.pad_vec(torch.as_tensor(g.standard_normal(A.n) + 1j * g.standard_normal(A.n))))
    x_ref, info_ref = _solve(A, b, M, False, monkeypatch, x0=x0, tol=1e-10, max_iter=400)
    x, info = _solve(A, b, M, True, monkeypatch, x0=x0, tol=1e-10, max_iter=400)
    assert info_ref.status == info.status == Status.INVALID_PRECONDITIONER
    assert info.iterations == info_ref.iterations
    assert torch.equal(torch.as_tensor(info.residual), torch.as_tensor(info_ref.residual))
    assert torch.equal(x, x_ref)
    assert shims[1].calls == max(shims[0].calls - 1, 0) == info.iterations
    assert (info.iterations > 5) == (scale == -2.0)


def _flat_b(n=64, dtype=torch.complex64):
    g = torch.Generator().manual_seed(2)
    return torch.randn(n, generator=g, dtype=dtype)


def test_route_decision_reads_dtype_shape_group_and_m():
    """The route engages on a flat complex b, an x0 of its dtype, no group
    and no history, with M None or a DiagPrecond whose d⁻¹ is real, of b's
    real dtype, length and device; it refuses everything else."""
    b = _flat_b()
    diag = tsp.DiagPrecond(diag_inv=torch.full((64,), 0.5))
    assert csm_module._fused_dinv(b, b, None, None, False) == (True, None)
    routed, dinv = csm_module._fused_dinv(b, b, diag, None, False)
    assert routed and torch.equal(dinv, diag.diag_inv)
    z = b.to(torch.complex128)
    refused = [
        (b, b, diag, object(), False),                                   # a group
        (b, b, diag, None, True),                                        # a history
        (b.real.contiguous(), b.real.contiguous(), None, None, False),   # real b
        (b.reshape(8, 8), b.reshape(8, 8), None, None, False),           # 2-d b
        (b, z, None, None, False),                                       # x0 of another dtype
        (b, b, tsp.DiagPrecond(diag_inv=torch.full((64,), 0.5 + 0j)), None, False),
        (b, b, tsp.DiagPrecond(diag_inv=torch.full((32,), 0.5)), None, False),
        (z, z, diag, None, False),                                       # f32 d⁻¹, c128 b
        (b, b, tsp.IdentityOperator(64), None, False),                   # another M
        (b, b, tsp.ComplexDiagPrecond(diag_inv=torch.full((64,), 0.5 + 0j)), None, False),
    ]
    for args in refused:
        assert csm_module._fused_dinv(*args) == (False, None)


def _identity_m(A):
    return tsp.IdentityOperator(A.shape[0])


def _diagonal_operator(A):
    return tsp.DiagonalOperator(real_abs_jacobi(A).diag_inv)


@pytest.mark.parametrize("case", ["history", "identity_m", "diagonal_operator", "real_b"])
def test_cs_minres_keeps_the_unfused_loop_where_the_route_does_not_apply(case, shims):
    """Inputs the predicate refuses run the unfused loop to convergence and
    launch neither kernel."""
    if case == "real_b":
        A = problems.poisson3d(6, 6, 6, dtype=np.float64)
        b = torch.as_tensor(np.random.default_rng(1).standard_normal(216))
        M = tsp.DiagPrecond.new(A.diagonal())
    else:
        A, b = _damped(6, "c64", "padded")
        M = {"history": real_abs_jacobi, "identity_m": _identity_m,
             "diagonal_operator": _diagonal_operator}[case](A)
    out = tsp.cs_minres(A, b, M=M, tol=1e-4, max_iter=400,
                        record_residuals=case == "history")
    assert out[1].converged and out[1].iterations > 0
    assert shims[0].calls == shims[1].calls == 0


def test_csm_kernels_refuse_what_they_do_not_take():
    v = _flat_b()
    st = torch.zeros(fused.CSM_SLOTS)
    a = torch.tensor(1.0 + 0j, dtype=torch.complex64)
    with pytest.raises(TypeError):
        fused.csm_lanczos(v.real, v.real, v.real, None, a, st, None)
    with pytest.raises(ValueError, match="one length"):
        fused.csm_lanczos(v, _flat_b(32), v, None, a, st, None)
    with pytest.raises(ValueError, match="real"):
        fused.csm_lanczos(v, v.clone(), v, torch.ones(64, dtype=torch.float64), a, st,
                          v.clone())
    with pytest.raises(ValueError, match="state"):
        fused.csm_update(v, v.clone(), v.clone(), v.clone(), v.clone(), None,
                         torch.zeros(fused.CSM_SLOTS, dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        fused.csm_update(v, v.clone(), _flat_b(128)[::2], v.clone(), v.clone(), None, st)


def test_reset_launch_counts_zeroes_a_and_b():
    fused.csm_lanczos.launches = fused.csm_update.launches = 4
    pd.reset_launch_counts()
    assert fused.csm_lanczos.launches == fused.csm_update.launches == 0
