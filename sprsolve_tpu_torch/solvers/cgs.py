"""CGS: conjugate-gradient-squared for general nonsymmetric systems.

Counterpart of ``sprsolve_tpu/solvers/cgs.py`` (Sonneveld, 1989; beyond
the reference's surface, whose nonsymmetric solver is BiCGStab): the BiCG
residual polynomial squared, transpose-free, with the same iteration and
exits as the JAX package:

- Templates §2.3.7 with both M⁻¹ applies folded into the vector updates,
  so x is tracked directly: two SpMVs (K1 on a
  :class:`~sprsolve_tpu_torch.ops.padded_dia.PaddedDIA`, K5 on a
  :class:`~sprsolve_tpu_torch.ops.padded_dia.ComplexPaddedDIA`), two M⁻¹
  applies and two shadow products per iteration;
- q = p = 0 at the start, so the first iteration gives u = r, p = u;
- the ρ = r̃ᴴr and σ = r̃ᴴv breakdown gates against (ε·‖r₀‖)², BiCGStab's
  ρ-scale; BREAKDOWN keeps the previous x, count and residual;
- converged when the loop ends with ‖r‖ ≤ tol·‖b‖, else INSUFFICIENT_ITER.

The loop is a Python ``while`` with one host read of the iteration's
predicates.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..errors import Status
from ..ops.operator import IdentityOperator
from ..vecalg import axpy, conj_dot, eps_for, norm2, real_dtype
from .common import _guard3, check_shapes, make_info, read_flags


def cgs(
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
    """Solve general A·x = b with CGS. Returns ``(x, SolveInfo)``.

    ``M`` applies M⁻¹. ``record_residuals=True`` also returns the relative
    residual at the top of each iteration, a ``(max_iter + 1,)`` tensor that
    is NaN past the last (expect it to be non-monotone: that is CGS).
    ``group`` makes every reduction a sum over its ranks (b, x0 and x are
    this rank's rows; ``parallel.distributed_solve``).
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
    eps = eps_for(T, dev)
    one = torch.ones((), dtype=T, device=dev)

    def main(rhs_norm):
        tol2 = torch.tensor(tol, dtype=rdt, device=dev) * rhs_norm
        hist = torch.full((hist_len,), float("nan"), dtype=rdt, device=dev)

        r = axpy(-one, A.matvec(x0), b)  # r = b − A·x
        r_norm = norm2(r, group)
        rt = r                           # shadow residual r̃ = r₀
        above, below = read_flags(r_norm > tol2, r_norm <= tol2)
        if below:
            if hist_len:
                hist[0] = r_norm / rhs_norm
            return x0, make_info(0, r_norm / rhs_norm, Status.CONVERGED), hist

        brk_tol = (r_norm * eps) ** 2
        x, p, q, rho_prev = x0, torch.zeros_like(r), torch.zeros_like(r), one
        its, status, res = 0, Status.RUNNING, None
        while its < max_iter and above:
            if hist_len:
                hist[its] = r_norm / rhs_norm
            rho = conj_dot(rt, r, group)
            ok_rho = rho.abs() > brk_tol
            beta = rho / torch.where(ok_rho, rho_prev, one)
            u = axpy(beta, q, r)
            p_new = axpy(beta, axpy(beta, p, q), u)
            v = A.matvec(M.matvec(p_new))
            sigma = conj_dot(rt, v, group)
            ok = ok_rho & (sigma.abs() > brk_tol)
            alpha = rho / torch.where(ok, sigma, one)
            q_new = axpy(-alpha, v, u)
            uh = M.matvec(u + q_new)
            x_new = axpy(alpha, uh, x)
            r_new = axpy(-alpha, A.matvec(uh), r)
            r_norm_new = norm2(r_new, group)
            flags = read_flags(ok, r_norm_new > tol2, r_norm_new <= tol2)
            if not flags[0]:
                # BREAKDOWN keeps the previous x, count and residual
                status, res = Status.BREAKDOWN, r_norm / rhs_norm
                break
            x, r, p, q, rho_prev = x_new, r_new, p_new, q_new, rho
            r_norm, its = r_norm_new, its + 1
            above, below = flags[1:]

        if status == Status.RUNNING:
            status = Status.CONVERGED if below else Status.INSUFFICIENT_ITER
            res = r_norm / rhs_norm
            if hist_len and below:
                hist[its] = res
        return x, make_info(its, res, status), hist

    x, info, hist = _guard3(b, x0, main, hist_len, rdt, group)
    return (x, info, hist) if record_residuals else (x, info)
