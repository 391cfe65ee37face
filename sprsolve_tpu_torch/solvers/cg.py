"""Preconditioned Conjugate Gradients for SPD / Hermitian-PD systems.

Counterpart of ``sprsolve_tpu/solvers/cg.py`` (``cg`` only; the reference
has no CG, its SPD solver is MINRES), with the same iteration and exits:

- the ‖r‖ > tol·‖b‖ test at the top of each iteration;
- α's dot pᴴ(A·p) from the operator's fused ``matvec_dot`` (K3 on a
  :class:`~sprsolve_tpu_torch.ops.padded_dia.PaddedDIA`);
- the pᴴAp ≤ 0 gate → BREAKDOWN, which keeps the previous x and count;
- converged when the loop ends with ‖r‖ ≤ tol·‖b‖, else
  INSUFFICIENT_ITER.

The loop is a Python ``while``.  Scalars stay 0-d tensors on the solve's
device, and each iteration brings one small tensor of predicates (the gate
and the next residual test) to the host.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..errors import Status
from ..ops.operator import IdentityOperator
from ..vecalg import axpy, conj_dot, norm2, real_dtype
from .common import _guard3, check_shapes, make_info


def cg(
    A,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    M=None,
    tol,
    max_iter,
    record_residuals: bool = False,
):
    """Solve SPD A·x = b with (preconditioned) CG. Returns ``(x, SolveInfo)``.

    ``M`` must be an SPD preconditioner apply (≈ A⁻¹), e.g.
    :class:`~sprsolve_tpu_torch.precond.DiagPrecond`.
    ``record_residuals=True`` also returns the relative residual at the top
    of each iteration, a ``(max_iter + 1,)`` tensor that is NaN past the last.
    """
    if x0 is None:
        x0 = torch.zeros_like(b)
    check_shapes(A, b, x0)
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
        r_norm = norm2(r)
        z = M.matvec(r)
        x, p, rz = x0, z, conj_dot(r, z)
        its, status, res = 0, Status.RUNNING, None
        above, below = torch.stack([r_norm > tol2, r_norm <= tol2]).tolist()
        while its < max_iter and above:
            if hist_len:
                hist[its] = r_norm / rhs_norm
            q, pq = A.matvec_dot(p)
            # positive-definiteness gate (cg.py:118-133)
            ok = pq.real > 0
            alpha = rz / torch.where(ok, pq, one)
            x_next = axpy(alpha, p, x)
            r = axpy(-alpha, q, r)
            z = M.matvec(r)
            rz_next = conj_dot(r, z)
            p = axpy(rz_next / rz, p, z)  # p = z + β·p
            rz = rz_next
            r_norm_next = norm2(r)
            flags = torch.stack([ok, r_norm_next > tol2, r_norm_next <= tol2]).tolist()
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

    x, info, hist = _guard3(b, x0, main, hist_len, rdt)
    return (x, info, hist) if record_residuals else (x, info)
