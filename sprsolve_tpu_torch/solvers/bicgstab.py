"""BiCGStab for general (non-symmetric, possibly indefinite) systems.

Counterpart of ``sprsolve_tpu/solvers/bicgstab.py`` (reference
``src/bicg_stab.rs``) with the same recurrences, guards and exits:

- the zero-rhs guard and the r0-norm early exit;
- the unrolled first iteration, whose r0·v is unguarded as in the reference;
- the ρ-breakdown restart (``src/bicg_stab.rs:131-145``), which recomputes
  r = A·x − b and resets r0, ρ and the restart tolerance;
- the breakdown exit on |r0·v| = 0, which keeps the previous x and count;
- the ω guard (ω = 0 when ‖t‖² is not positive);
- the exit classification: converged only when ‖r‖ ≤ tol·‖b‖ with
  its < max_iter, else InsufficientIterNum.

The loop is a Python ``while``.  Scalars stay 0-d tensors on the solve's
device, and each iteration brings one small tensor of predicates
(convergence, restart, breakdown) to the host.  With a ``DiagPrecond`` on a
:class:`~sprsolve_tpu_torch.ops.padded_dia.PaddedDIA` both SpMVs of an
iteration run kernel K2 with the Jacobi apply folded in.

Sign convention: r = A·x − b, hence the x-updates subtract. The reported
residual is relative, ‖r‖/‖b‖.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..errors import Status
from ..ops.operator import IdentityOperator, mv_prec_wdot, mv_prec_wdot2
from ..vecalg import axpby, axpy, conj_dot, eps_for, norm2, real_dtype
from .common import check_shapes, make_info, read_flags, with_zero_rhs_guard


def bicgstab(
    A,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    M=None,
    tol,
    max_iter,
    record_residuals: bool = False,
    group=None,
):
    """Solve A·x = b with BiCGStab. Returns ``(x, SolveInfo)``.

    ``x0`` is the warm start. ``M`` applies the preconditioner (an
    approximation of A⁻¹, e.g. :class:`~sprsolve_tpu_torch.precond.DiagPrecond`).
    ``record_residuals=True`` also returns the relative residual after each
    iteration, a ``(max_iter + 1,)`` tensor that is NaN past the last one.
    ``group`` (a ``torch.distributed`` process group) makes every reduction
    a sum over its ranks: b, x0 and x are this rank's rows of a
    row-partitioned system (``parallel.distributed_solve``).
    """
    if x0 is None:
        x0 = torch.zeros_like(b)
    check_shapes(A, b, x0, group)
    if M is None:
        M = IdentityOperator(b.shape[0])

    T, dev = b.dtype, b.device
    rdt = real_dtype(T)
    max_iter = int(max_iter)
    hist = torch.full((max_iter + 1 if record_residuals else 0,), float("nan"),
                      dtype=rdt, device=dev)
    eps = eps_for(T, dev)
    one = torch.ones((), dtype=T, device=dev)
    zero = torch.zeros((), dtype=T, device=dev)

    def main(rhs_norm):
        tol2 = torch.tensor(tol, dtype=rdt, device=dev) * rhs_norm

        # r = A·x − b ; r0 = r (src/bicg_stab.rs:72-79)
        r = axpy(-one, b, A.matvec(x0))
        r0_norm = norm2(r, group)
        if record_residuals:
            hist[0] = r0_norm / rhs_norm
        if read_flags(r0_norm <= tol2)[0]:
            return x0, make_info(0, r0_norm / rhs_norm, Status.CONVERGED)

        def restart_values(x):
            # the ρ-breakdown restart recompute (src/bicg_stab.rs:131-145)
            r_r = axpy(-one, b, A.matvec(x))
            rn = norm2(r_r, group)
            rho_r = (rn * rn).to(T)
            return r_r, rho_r, rho_r.real * eps * eps

        # ---- unrolled first iteration (src/bicg_stab.rs:87-120 / :258-293)
        r0 = r
        r0_norm_tol = (r0_norm * eps) ** 2
        rho = (r0_norm * r0_norm).to(T)
        p = r
        y, v, r0v = mv_prec_wdot(A, M, p, r0, group)
        alpha = rho / r0v
        s = axpy(-alpha, v, r)
        z, t, st_, tt = mv_prec_wdot2(A, M, s, s, group)
        w = torch.where(tt.real > 0, st_.conj() / tt, zero)
        x = axpy(-w, z, axpy(-alpha, y, x0))
        r = axpy(-w, t, s)
        rho_next = conj_dot(r0, r, group)
        r_norm = norm2(r, group)
        its, status, res = 1, Status.RUNNING, None
        ok = None            # breakdown predicate of the last step (none for the first)
        x_prev = r_norm_prev = None

        while True:
            preds = [r_norm > tol2, r_norm <= tol2, rho_next.abs() < r0_norm_tol]
            if ok is not None:
                preds.append(ok)
            flags = read_flags(*preds)   # the iteration's one host read
            if ok is not None and not flags[3]:
                # breakdown exit |r0·v| ≤ 0 (src/bicg_stab.rs:164-167): the
                # reference returns before the x-update of that step
                x, its, r_norm = x_prev, its - 1, r_norm_prev
                status, res = Status.BREAKDOWN, r_norm / rhs_norm
                break
            above, below, restart = flags[:3]
            if not (its < max_iter and above):
                break
            if record_residuals:
                hist[its] = r_norm / rhs_norm
            if restart:
                # r_norm is deliberately not refreshed: the reference keeps the
                # pre-restart norm until the next tail
                r, rho_next, r0_norm_tol = restart_values(x)
                r0 = r

            rho_old, rho = rho, rho_next
            beta = (rho / rho_old) * (alpha / w)
            # p = r + β·(p − ω·v), MKL-axpby form (src/bicg_stab.rs:153-156)
            p = axpy(one, r, axpby(-beta * w, v, beta, p))
            y, v, r0v = mv_prec_wdot(A, M, p, r0, group)
            ok = r0v.abs() > 0
            alpha = rho / torch.where(ok, r0v, one)
            s = axpy(-alpha, v, r)
            z, t, st_, tt = mv_prec_wdot2(A, M, s, s, group)
            w = torch.where(tt.real > 0, st_.conj() / tt, zero)
            x_prev, r_norm_prev = x, r_norm
            x = axpy(-w, z, axpy(-alpha, y, x))
            r = axpy(-w, t, s)
            rho_next = conj_dot(r0, r, group)
            r_norm = norm2(r, group)
            its += 1

        if status == Status.RUNNING:
            # converged only with its < max_iter: the reference's loop range ends
            # before a check at its == max_iter could run (src/bicg_stab.rs:122,199)
            converged = below and its < max_iter
            status = Status.CONVERGED if converged else Status.INSUFFICIENT_ITER
            res = r_norm / rhs_norm
            if record_residuals and converged:
                hist[its] = res
        return x, make_info(its, res, status)

    x, info = with_zero_rhs_guard(b, x0, main, group)
    return (x, info, hist) if record_residuals else (x, info)
