"""Mixed-precision iterative refinement: f64 accuracy from f32 inner solves.

Counterpart of ``sprsolve_tpu/solvers/refine.py``::

    x₀ = 0
    repeat:  r = b − A·x   (f64, torch DIA ops, one SpMV per outer step)
             d ≈ A⁻¹ r     (an f32 Krylov solve on the kernels K1-K4)
             x ← x + d     (f64)

with the same exits: the residual is scaled to unit norm before the f32
cast (no underflow), an outer step must contract (a step that does not
improve ends in BREAKDOWN with the best iterate; two weak steps in a row,
factor above 0.5, do too), and ``max_refine`` bounds the outer steps.  The
complex path runs c128 residuals on a complex torch ``DIA`` and c64 inner
solves on the two-plane kernels K5-K7.  The H100 runs f64 and complex
tensors natively, so the JAX package's re/im plane operators (``_PlanesDIA``,
``_PlanesComplexOp``) are not ported; :func:`refine_complex` keeps its
plane signature as a thin shim over the complex loop.  The loop is a
Python ``while`` with one host read of the residual norm per outer step.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import numpy as np
import torch

from ..errors import IncompatibleMatrixFormat, Status
from ..vecalg import eps_for, norm2
from .common import make_info


def _refine_loop(A64, A32, b, x0, *, inner, M, tol, max_refine, inner_tol,
                 inner_max_iter, low):
    """The outer loop of :func:`refine` and :func:`refine_complex`: ``b``
    and ``x0`` are f64 (c128) tensors, ``low`` the inner solve's dtype."""
    padded = hasattr(A32, "pad_vec")
    kwargs = dict(tol=inner_tol, max_iter=inner_max_iter)
    if M is not None:
        kwargs["M"] = M
    inner_run = partial(inner, **kwargs)

    def correction(r64, r_norm):
        # unit-scale the residual before the low-precision cast, solve in the
        # inner layout, un-scale in f64
        r32 = (r64 / r_norm).to(low)
        if padded:
            r32 = A32.pad_vec(r32)
        d32, _ = inner_run(A32, r32)
        if padded:
            d32 = A32.unpad_vec(d32)
        return d32.to(b.dtype) * r_norm

    rhs_norm = norm2(b)
    if float(rhs_norm) <= float(eps_for(torch.float64)):
        return torch.zeros_like(b), make_info(0, rhs_norm, Status.CONVERGED)
    tol_abs = float(tol) * float(rhs_norm)
    x = x0
    r = b - A64.matvec(x0)
    r_norm = norm2(r)
    rn = float(r_norm)
    outer, stall, status = 0, 0, Status.RUNNING
    while status == Status.RUNNING and outer < max_refine and rn > tol_abs:
        x_new = x + correction(r, r_norm)
        r_vec = b - A64.matvec(x_new)          # the step's single f64 apply
        r_norm_new = norm2(r_vec)
        rn_new = float(r_norm_new)
        # refinement must contract (κ·ε_f32 too large if not); a kept but
        # weak step (factor in (0.5, 1)) gets one more chance, a rejected
        # step would repeat itself and breaks down at once
        improved = rn_new < rn * 0.5
        keep = rn_new < rn
        stall = 0 if improved else stall + 1
        if keep:
            x, r, r_norm, rn = x_new, r_vec, r_norm_new, rn_new
        outer += 1
        if stall >= 2 or not keep:
            status = Status.BREAKDOWN
    if rn <= tol_abs:
        status = Status.CONVERGED
    elif status == Status.RUNNING:
        status = Status.INSUFFICIENT_ITER
    return x, make_info(outer, r_norm / rhs_norm, status)


def refine(
    A64,
    A32,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    inner=None,
    M=None,
    tol,
    max_refine: int = 20,
    inner_tol: float = 1e-5,
    inner_max_iter: int = 400,
):
    """Solve A·x = b to f64 accuracy with an f32 inner solver.

    ``A64`` is the f64 operator of the true residuals (one apply per outer
    step; torch ``DIA`` is the natural choice).  ``A32`` is the f32
    execution-layout operator of the inner solves (``optimize()``'s
    ``PaddedDIA`` runs K1-K4; it may have ``pad_vec``).  ``inner`` is a
    functional solver (default
    :func:`~sprsolve_tpu_torch.solvers.bicgstab.bicgstab`); ``M``
    preconditions the inner solve, in ``A32``'s layout.

    Returns ``(x, SolveInfo)``: ``iterations`` counts outer steps and
    ``residual`` is the true f64 relative residual.
    """
    from .bicgstab import bicgstab

    b = torch.as_tensor(b)
    if b.dtype != torch.float64:
        raise IncompatibleMatrixFormat(
            "refine() solves to f64 accuracy; b must be float64")
    x0 = torch.zeros_like(b) if x0 is None else torch.as_tensor(x0, device=b.device)
    return _refine_loop(A64, A32, b, x0, inner=inner or bicgstab, M=M, tol=tol,
                        max_refine=max_refine, inner_tol=inner_tol,
                        inner_max_iter=inner_max_iter, low=torch.float32)


def refine_complex(
    A64,
    A32,
    b_re: torch.Tensor,
    b_im: torch.Tensor,
    x0_re: Optional[torch.Tensor] = None,
    x0_im: Optional[torch.Tensor] = None,
    *,
    inner=None,
    M=None,
    tol,
    max_refine: int = 20,
    inner_tol: float = 1e-5,
    inner_max_iter: int = 500,
):
    """Complex counterpart of :func:`refine`: c128 accuracy from c64 inner
    solves (K5-K7 on a
    :class:`~sprsolve_tpu_torch.ops.padded_dia.ComplexPaddedDIA`).

    ``A64`` is a c128 operator (a complex torch ``DIA``), ``A32`` a c64
    one; the right-hand side and the warm start come as f64 re/im planes,
    the JAX package's signature.  ``inner`` defaults to
    :func:`~sprsolve_tpu_torch.solvers.cs_minres.cs_minres` (use
    ``bicgstab`` for non-symmetric complex systems).  Returns
    ``(x_re, x_im, SolveInfo)``.
    """
    from .cs_minres import cs_minres

    b_re = torch.as_tensor(b_re)
    if b_re.dtype != torch.float64:
        raise IncompatibleMatrixFormat(
            "refine_complex solves to c128 accuracy; planes must be float64")
    b = torch.complex(b_re, torch.as_tensor(b_im, device=b_re.device))
    if x0_re is None and x0_im is None:
        x0 = torch.zeros_like(b)
    else:
        zero = torch.zeros_like(b_re)
        x0 = torch.complex(zero if x0_re is None else torch.as_tensor(x0_re, device=b.device),
                           zero if x0_im is None else torch.as_tensor(x0_im, device=b.device))
    x, info = _refine_loop(A64, A32, b, x0, inner=inner or cs_minres, M=M, tol=tol,
                           max_refine=max_refine, inner_tol=inner_tol,
                           inner_max_iter=inner_max_iter, low=torch.complex64)
    return x.real, x.imag, info


def _inner_jacobi(A32, inner: str):
    """``M="jacobi"`` in the inner layout: the real 1/|d| for CS-MINRES,
    else the operator's own Jacobi (or one from its diagonal)."""
    from ..precond import DiagPrecond, real_abs_jacobi

    if inner == "cs_minres":
        return real_abs_jacobi(A32)
    if hasattr(A32, "jacobi_precond"):
        return A32.jacobi_precond()
    return DiagPrecond.new(A32.diagonal())


def _residual_operator(A, data, dtype, device):
    """The f64 (c128) residual operator: torch DIA, or the CSR itself for a
    pattern of more than 64 diagonals."""
    from ..sparse.containers import CSR, DIA

    csr = CSR.from_arrays(data.astype(dtype), A.indices, A.indptr, A.shape)
    try:
        return DIA.from_csr(csr, device=device)
    except ValueError:
        return csr.to(device)


def refine_solve(
    A,
    b,
    *,
    inner: str = "bicgstab",
    M=None,
    tol: float = 1e-12,
    max_refine: int = 20,
    inner_tol: float = 1e-5,
    inner_max_iter: int = 400,
    x0=None,
    device=None,
):
    """Build both precisions from a CSR and run :func:`refine` (or, for a
    complex CSR, the c128 refinement over c64 inner solves).

    The f64 residual operator is the matrix's torch ``DIA`` (its CSR past
    64 diagonals); the f32 (c64) inner operator comes from ``optimize()``,
    on the kernels when banded.  ``M`` is ``"jacobi"`` (built in the inner
    layout; the real 1/|d| for ``inner="cs_minres"``) or a preconditioner
    in the inner operator's layout.  Runs on ``device``, by default the
    CUDA device.  Returns ``(x, SolveInfo)`` with an f64 (c128) ``x``.
    """
    from . import bicgstab, cg, cocg, cs_minres, gmres, minres
    from ..ops.optimize import default_device, optimize
    from ..sparse.containers import CSR, _host

    if not isinstance(A, CSR):
        raise IncompatibleMatrixFormat("refine_solve needs a CSR")
    device = default_device(device)
    data = _host(A.data)
    is_complex = np.iscomplexobj(data)
    if is_complex:
        solvers = {"cs_minres": cs_minres, "bicgstab": bicgstab, "cocg": cocg}
        if inner not in solvers:
            raise IncompatibleMatrixFormat(
                "refine inner solver must be 'cocg', 'cs_minres' or 'bicgstab' "
                f"for complex systems (got {inner!r})")
        hi, lo = np.complex128, np.complex64
    else:
        solvers = {"bicgstab": bicgstab, "cg": cg, "minres": minres, "gmres": gmres}
        if inner not in solvers:
            raise IncompatibleMatrixFormat(
                f"refine inner solver must be one of {sorted(solvers)} for real "
                f"systems (got {inner!r})")
        hi, lo = np.float64, np.float32
    A64 = _residual_operator(A, data, hi, device)
    low_csr = CSR.from_arrays(data.astype(hi).astype(lo), A.indices, A.indptr, A.shape)
    # complex: no wide torch-DIA candidate, as in the JAX package
    A32 = optimize(low_csr, device=device, **({"wide_diags": 0} if is_complex else {}))
    if isinstance(M, str):
        if M != "jacobi":
            raise IncompatibleMatrixFormat(
                "refine_solve supports M='jacobi' or a prebuilt "
                "inner-layout preconditioner")
        M = _inner_jacobi(A32, inner)
    b = torch.as_tensor(np.asarray(_host(b) if torch.is_tensor(b) else b, dtype=hi),
                        device=device)
    x0 = (torch.zeros_like(b) if x0 is None else
          torch.as_tensor(np.asarray(_host(x0) if torch.is_tensor(x0) else x0, dtype=hi),
                          device=device))
    low = torch.complex64 if is_complex else torch.float32
    return _refine_loop(A64, A32, b, x0, inner=solvers[inner], M=M, tol=tol,
                        max_refine=max_refine, inner_tol=inner_tol,
                        inner_max_iter=inner_max_iter, low=low)
