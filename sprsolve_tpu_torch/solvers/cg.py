"""Preconditioned Conjugate Gradients for SPD / Hermitian-PD systems.

Counterpart of ``sprsolve_tpu/solvers/cg.py`` (the reference has no CG,
its SPD solver is MINRES): :func:`cg` and the Chronopoulos–Gear
:func:`cg_single_sync`.  ``cg`` has the same iteration and exits:

- the ‖r‖ > tol·‖b‖ test at the top of each iteration;
- α's dot pᴴ(A·p) from the operator's fused ``matvec_dot`` (K3 on a
  :class:`~sprsolve_tpu_torch.ops.padded_dia.PaddedDIA`);
- the pᴴAp ≤ 0 gate → BREAKDOWN, which keeps the previous x and count;
- converged when the loop ends with ‖r‖ ≤ tol·‖b‖, else
  INSUFFICIENT_ITER.

The loop is a Python ``while``.  Scalars stay 0-d tensors on the solve's
device, and each iteration brings one small tensor of predicates (the gate
and the next residual test) to the host.

Where the input allows it (:func:`_fused_dinv`: a real b, no ``group``, and
M none, the identity or a diagonal of b's length and dtype), the iteration's
vector work after K3 runs as two kernels, :func:`~sprsolve_tpu_torch.ops.fused.cg_update`
(x, r and the two dots: α's and the next ‖r‖) and
:func:`~sprsolve_tpu_torch.ops.fused.cg_direction` (the next p), in place of
17 eager launches; r and p are then updated in place and x alternates
between two buffers of the solve's own. On the CPU their plain versions
repeat the unfused ops one for one, so both loops give the same bits there.
Every other input (complex, distributed, any other M) runs the unfused loop.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..errors import Status
from ..ops import fused
from ..ops.operator import IdentityOperator
from ..precond import DiagPrecond
from ..vecalg import axpy, conj_dot, group_sum, norm2, real_dtype
from .common import _guard3, check_shapes, make_info, read_flags


def _fused_dinv(b: torch.Tensor, x0: torch.Tensor, M, group):
    """``(True, d⁻¹ or None)`` when :func:`cg` may run its updates as the
    fused U/P pair: b flat and real, x0 of its dtype and device, no
    ``group``, and M None, an
    :class:`IdentityOperator` (no d⁻¹) or a :class:`DiagPrecond` whose
    ``diag_inv`` is real and of b's length, dtype and device. Else
    ``(False, None)``."""
    if (group is not None or b.dtype not in (torch.float32, torch.float64) or b.dim() != 1
            or x0.dtype != b.dtype or x0.device != b.device):
        return False, None
    if M is None or isinstance(M, IdentityOperator):
        return True, None
    if type(M) is DiagPrecond:
        d = M.diag_inv
        if d.shape == b.shape and d.dtype == b.dtype and d.device == b.device:
            return True, d.contiguous()
    return False, None


def cg(
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
    """Solve SPD A·x = b with (preconditioned) CG. Returns ``(x, SolveInfo)``.

    ``M`` must be an SPD preconditioner apply (≈ A⁻¹), e.g.
    :class:`~sprsolve_tpu_torch.precond.DiagPrecond`.
    ``record_residuals=True`` also returns the relative residual at the top
    of each iteration, a ``(max_iter + 1,)`` tensor that is NaN past the last.
    ``group`` makes every reduction a sum over its ranks (b, x0 and x are
    this rank's rows; ``parallel.distributed_solve``).
    """
    if x0 is None:
        x0 = torch.zeros_like(b)
    check_shapes(A, b, x0, group)
    routed, dinv = _fused_dinv(b, x0, M, group)
    if routed:
        x0 = x0.contiguous()
    if M is None:
        M = IdentityOperator(b.shape[0])

    T, dev = b.dtype, b.device
    rdt = real_dtype(T)
    max_iter = int(max_iter)
    # +1: the final write lands at hist[its] with its == max_iter when the
    # solve converges exactly at the budget
    hist_len = max_iter + 1 if record_residuals else 0
    one = torch.ones((), dtype=T, device=dev)

    def main(rhs_norm):
        tol2 = torch.tensor(tol, dtype=rdt, device=dev) * rhs_norm
        hist = torch.full((hist_len,), float("nan"), dtype=rdt, device=dev)

        r = axpy(-one, A.matvec(x0), b)  # r = b − A·x
        r_norm = norm2(r, group)
        z = M.matvec(r)
        x, p, rz = x0, z, conj_dot(r, z, group)
        if routed:
            # U rewrites r and P rewrites p in place; x' goes to the buffer
            # x is not in, so a breakdown keeps x, and x0 is never written
            p = z.clone() if z is r else z
            xbufs = (torch.empty_like(b), torch.empty_like(b))
        its, status, res = 0, Status.RUNNING, None
        above, below = read_flags(r_norm > tol2, r_norm <= tol2)
        while its < max_iter and above:
            if hist_len:
                hist[its] = r_norm / rhs_norm
            q, pq = A.matvec_dot(p)
            pq = group_sum(pq, group)
            if routed:
                x_next, r, st = fused.cg_update(x, p, r, q.contiguous(), dinv, rz, pq, tol2,
                                                xbufs[its % 2], r)
                p = fused.cg_direction(p, r, dinv, st[0], rz, p)
                rz, r_norm_next = st[0], st[2]
                flags = read_flags(st[3:])
            else:
                # positive-definiteness gate (cg.py:118-133)
                ok = pq.real > 0
                alpha = rz / torch.where(ok, pq, one)
                x_next = axpy(alpha, p, x)
                r = axpy(-alpha, q, r)
                z = M.matvec(r)
                rz_next = conj_dot(r, z, group)
                p = axpy(rz_next / rz, p, z)  # p = z + β·p
                rz = rz_next
                r_norm_next = norm2(r, group)
                flags = read_flags(ok, r_norm_next > tol2, r_norm_next <= tol2)
            if not flags[0]:
                # BREAKDOWN keeps the previous x, count and residual
                status, res = Status.BREAKDOWN, r_norm / rhs_norm
                break
            x, r_norm, its = x_next, r_norm_next, its + 1
            above, below = flags[1:]

        if status == Status.RUNNING:
            converged = below
            status = Status.CONVERGED if converged else Status.INSUFFICIENT_ITER
            res = r_norm / rhs_norm
            if hist_len and converged:
                hist[its] = res
        return x, make_info(its, res, status), hist

    x, info, hist = _guard3(b, x0, main, hist_len, rdt, group)
    return (x, info, hist) if record_residuals else (x, info)


def cg_single_sync(
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
    """Chronopoulos–Gear CG (``sprsolve_tpu/solvers/cg.py:179-353``): the
    same Krylov iteration as :func:`cg`, with the three dots of a step,
    γ = rᴴu, δ = uᴴw and ‖r‖², taken back to back as one stacked (3,)
    tensor — the JAX package's single reduction round, one all-reduce a
    step with ``group=``.  s = A·p is carried by recurrence (s ← w + β·s), so
    each iteration applies A once, to u = M⁻¹r: one K1 on a
    :class:`~sprsolve_tpu_torch.ops.padded_dia.PaddedDIA`, K3 never.

    The gate δ − β·γ/α_prev > 0 (the recurrence form of pᴴAp > 0) ends in
    BREAKDOWN with the previous x, count and residual; converged when the
    loop ends with ‖r‖ ≤ tol·‖b‖, else INSUFFICIENT_ITER.  Returns
    ``(x, SolveInfo)``; ``record_residuals=True`` adds the per-iteration
    trace as :func:`cg` does. ``group`` as in :func:`cg`: the stacked dots
    are one collective call.
    """
    if x0 is None:
        x0 = torch.zeros_like(b)
    check_shapes(A, b, x0, group)
    if M is None:
        M = IdentityOperator(b.shape[0])

    T, dev = b.dtype, b.device
    rdt = real_dtype(T)
    max_iter = int(max_iter)
    hist_len = max_iter + 1 if record_residuals else 0
    one = torch.ones((), dtype=T, device=dev)
    zero = torch.zeros((), dtype=T, device=dev)

    def fused_dots(r, u, w):
        """(rᴴu, uᴴw, ‖r‖) from one stacked (3,) tensor."""
        st = group_sum(torch.stack([conj_dot(r, u), conj_dot(u, w), conj_dot(r, r)]), group)
        return st[0], st[1], torch.sqrt(st[2].abs())

    def main(rhs_norm):
        tol2 = torch.tensor(tol, dtype=rdt, device=dev) * rhs_norm
        hist = torch.full((hist_len,), float("nan"), dtype=rdt, device=dev)

        r = axpy(-one, A.matvec(x0), b)
        u = M.matvec(r)
        w = A.matvec(u)
        gamma, delta, r_norm = fused_dots(r, u, w)
        x, p, s = x0, torch.zeros_like(b), torch.zeros_like(b)
        gamma_prev, alpha_prev = one, one
        its, status, res = 0, Status.RUNNING, None
        above, below = read_flags(r_norm > tol2, r_norm <= tol2)
        while its < max_iter and above:
            if hist_len:
                hist[its] = r_norm / rhs_norm
            beta = zero if its == 0 else gamma / gamma_prev
            # α = γ / (δ − β·γ/α_prev); the first step has β = 0 → γ/δ
            denom = delta - beta * gamma / alpha_prev
            ok = denom.real > 0
            alpha = gamma / torch.where(ok, denom, one)
            p = axpy(beta, p, u)         # p = u + β·p
            s = axpy(beta, s, w)         # s = w + β·s  (= A·p)
            x_next = axpy(alpha, p, x)
            r = axpy(-alpha, s, r)
            u = M.matvec(r)
            w = A.matvec(u)
            gamma_prev, alpha_prev = gamma, alpha
            gamma, delta, r_norm_next = fused_dots(r, u, w)
            flags = read_flags(ok, r_norm_next > tol2, r_norm_next <= tol2)
            if not flags[0]:
                # BREAKDOWN keeps the previous x, count and residual
                status, res = Status.BREAKDOWN, r_norm / rhs_norm
                break
            x, r_norm, its = x_next, r_norm_next, its + 1
            above, below = flags[1:]

        if status == Status.RUNNING:
            status = Status.CONVERGED if below else Status.INSUFFICIENT_ITER
            res = r_norm / rhs_norm
            if hist_len and below:
                hist[its] = res
        return x, make_info(its, res, status), hist

    x, info, hist = _guard3(b, x0, main, hist_len, rdt, group)
    return (x, info, hist) if record_residuals else (x, info)
