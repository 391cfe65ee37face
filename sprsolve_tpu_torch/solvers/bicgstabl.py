"""BiCGStab(ℓ) — the Sleijpen–Fokkema generalization of BiCGStab.

Counterpart of ``sprsolve_tpu/solvers/bicgstabl.py`` with the same cycle:
ℓ BiCG steps, then a modified Gram–Schmidt over r₁..r_ℓ and the
ℓ-dimensional minimal-residual step.

- ℓ is a Python int ≥ 1; the j/i loops of a cycle are Python loops.
- Right preconditioning on the correction equation: with x = x0 + M·z the
  system (A∘M)·z = b − A·x0 is solved for z, so the carried residual is the
  true residual b − A·x, and x = x0 + M·z is formed once at the end.
- The BiCG half's two SpMVs per step go through ``mv_prec_wdot`` (kernel K2
  on a :class:`~sprsolve_tpu_torch.ops.padded_dia.PaddedDIA`, with the
  Jacobi fold for a ``DiagPrecond``): 2ℓ launches per cycle.
- A dead scalar (ρ, γ or σⱼ below the rounding floor (ε‖r₀‖)², or a
  non-finite ω) abandons the cycle at the last consistent j-step boundary
  and restarts the shadow space; two dead cycles in a row that have not
  converged are a BREAKDOWN.

Every commit inside a cycle is predicated with ``torch.where``, as in the
JAX package, so a cycle runs as straight-line tensor code; the cycle loop
is a Python ``while`` that brings one small tensor of predicates to the host
per cycle.  ``info.iterations`` counts cycles.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..errors import Status
from ..ops.operator import IdentityOperator, mv_prec_wdot
from ..vecalg import axpy, conj_dot, eps_for, norm2, real_dtype
from .common import _guard3, check_shapes, make_info


def bicgstabl(
    A,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    l: int = 2,
    M=None,
    tol,
    max_iter,
    record_residuals: bool = False,
):
    """Solve A·x = b with BiCGStab(ℓ). Returns ``(x, SolveInfo)``.

    ``info.iterations`` counts cycles of 2ℓ operator applications;
    ``max_iter`` bounds cycles. ``record_residuals=True`` also returns the
    relative residual at the top of each cycle, a ``(max_iter + 1,)`` tensor
    that is NaN past the last.
    """
    l = int(l)
    if l < 1:
        raise ValueError(f"bicgstabl needs l >= 1, got {l}")
    if x0 is None:
        x0 = torch.zeros_like(b)
    check_shapes(A, b, x0)
    if M is None:
        M = IdentityOperator(b.shape[0])

    T, dev = b.dtype, b.device
    rdt = real_dtype(T)
    max_iter = int(max_iter)
    hist_len = max_iter + 1 if record_residuals else 0
    one = torch.ones((), dtype=T, device=dev)
    zero = torch.zeros((), dtype=T, device=dev)

    def cycle(z, r, u, rt, rho0, alpha, omega, brk_tol):
        """One BiCG half and MR half (bicgstabl.py:171-268). Returns the
        cycle's (z, r, u, ρ₀, α, ω, completed) with nothing committed on the
        host: z and r freeze at the last live j-step boundary."""
        rho0 = -omega * rho0
        alive = torch.ones((), dtype=torch.bool, device=dev)
        rs = [r] + [None] * l
        us = [u] + [None] * l
        # ρ₁ of the first step is a fresh dot; later ones come fused from the
        # r-matvec of the step before
        rho1 = conj_dot(rt, rs[0])

        # ---- BiCG half: ℓ steps
        for j in range(l):
            step_ok = rho0.abs() > brk_tol
            beta = alpha * (rho1 / torch.where(step_ok, rho0, one))
            rho0_n = rho1
            us_n = [axpy(-beta, us[i], rs[i]) for i in range(j + 1)]
            # u_{j+1} = A·M·u_j with γ = ⟨r̃₀, u_{j+1}⟩ in the same pass
            _, u_next, gamma = mv_prec_wdot(A, M, us_n[j], rt)
            step_ok = step_ok & (gamma.abs() > brk_tol)
            alpha_n = rho0_n / torch.where(step_ok, gamma, one)
            uall = us_n + [u_next]
            rs_n = [axpy(-alpha_n, uall[i + 1], rs[i]) for i in range(j + 1)]
            # r_{j+1} = A·M·r_j; its dot is the next step's ρ₁
            _, r_next, rho1_n = mv_prec_wdot(A, M, rs_n[j], rt)
            ok_step = alive & step_ok
            for i in range(j + 1):
                us[i] = torch.where(ok_step, us_n[i], us[i])
                rs[i] = torch.where(ok_step, rs_n[i], rs[i])
            us[j + 1] = u_next   # read only while later steps live
            rs[j + 1] = r_next
            z = torch.where(ok_step, axpy(alpha_n, us_n[0], z), z)
            rho0 = torch.where(ok_step, rho0_n, rho0)
            alpha = torch.where(ok_step, alpha_n, alpha)
            rho1 = rho1_n
            alive = ok_step

        # ---- MR half: modified Gram–Schmidt over r₁..r_ℓ, then the
        # ℓ-dimensional residual minimization; only on a live BiCG half
        mr_ok = alive
        tau = [[None] * (l + 1) for _ in range(l + 1)]
        sigma = [None] * (l + 1)
        gamma_p = [None] * (l + 1)
        rm = list(rs)
        for j in range(1, l + 1):
            for i in range(1, j):
                tau[i][j] = conj_dot(rm[i], rm[j]) / sigma[i]
                rm[j] = axpy(-tau[i][j], rm[i], rm[j])
            sigma[j] = conj_dot(rm[j], rm[j])
            mr_ok = mr_ok & (sigma[j].abs() > brk_tol)
            sigma[j] = torch.where(mr_ok, sigma[j], one)
            gamma_p[j] = conj_dot(rm[j], rm[0]) / sigma[j]

        gamma = [None] * (l + 1)
        gamma[l] = gamma_p[l]
        omega = gamma[l]
        for j in range(l - 1, 0, -1):
            acc = gamma_p[j]
            for i in range(j + 1, l + 1):
                acc = acc - tau[j][i] * gamma[i]
            gamma[j] = acc
        gamma_pp = [None] * l
        for j in range(1, l):
            acc = gamma[j + 1]
            for i in range(j + 1, l):
                acc = acc + tau[j][i] * gamma[i + 1]
            gamma_pp[j] = acc

        mr_ok = mr_ok & torch.isfinite(omega.abs())
        z_mr = axpy(gamma[1], rm[0], z)
        r_mr = axpy(-gamma_p[l], rm[l], rm[0])
        u_mr = axpy(-gamma[l], us[l], us[0])
        for j in range(1, l):
            u_mr = axpy(-gamma[j], us[j], u_mr)
            z_mr = axpy(gamma_pp[j], rm[j], z_mr)
            r_mr = axpy(-gamma_p[j], rm[j], r_mr)

        completed = mr_ok
        z = torch.where(completed, z_mr, z)
        r = torch.where(completed, r_mr, rs[0])
        return z, r, u_mr, rho0, alpha, omega, completed

    def main(rhs_norm):
        tol2 = torch.tensor(tol, dtype=rdt, device=dev) * rhs_norm
        hist = torch.full((hist_len,), float("nan"), dtype=rdt, device=dev)

        # true residual of the warm start; the loop solves (A∘M)·z = r_init
        r = axpy(-one, A.matvec(x0), b)
        r_norm = norm2(r)
        above, below = torch.stack([r_norm > tol2, r_norm <= tol2]).tolist()
        if below:
            if hist_len:
                hist[0] = r_norm / rhs_norm
            return x0, make_info(0, r_norm / rhs_norm, Status.CONVERGED), hist

        # scalar-death floor at the problem's rounding scale (bicgstabl.py:132-141)
        brk_tol = (r_norm * eps_for(T, dev)) ** 2
        z, u, rt = torch.zeros_like(b), torch.zeros_like(b), r
        rho0, alpha, omega = one, zero, one
        rcount, its, status, res = 0, 0, Status.RUNNING, None
        while its < max_iter and above:
            if hist_len:
                hist[its] = r_norm / rhs_norm
            z, r, u_mr, rho0_c, alpha_c, omega_c, completed = cycle(
                z, r, u, rt, rho0, alpha, omega, brk_tol)
            r_norm = norm2(r)
            # the cycle's one host read
            done, above, below = torch.stack(
                [completed, r_norm > tol2, r_norm <= tol2]).tolist()
            # an incomplete cycle restarts the shadow space from the boundary
            # iterate: r̃₀ ← r₀, u₀ ← 0, (ρ₀, α, ω) ← (1, 0, 1)
            u = torch.where(completed, u_mr, torch.zeros_like(u_mr))
            rt = torch.where(completed, rt, r)
            rho0 = torch.where(completed, rho0_c, one)
            alpha = torch.where(completed, alpha_c, zero)
            omega = torch.where(completed, omega_c, one)
            rcount = 0 if done else rcount + 1
            its += 1
            # two dead cycles in a row are a breakdown unless the boundary
            # iterate has converged (a near-exact M finishes inside a step)
            if not done and rcount >= 2 and above:
                status, res = Status.BREAKDOWN, r_norm / rhs_norm
                break

        if status == Status.RUNNING:
            converged = below
            status = Status.CONVERGED if converged else Status.INSUFFICIENT_ITER
            res = r_norm / rhs_norm
            if hist_len and converged:
                hist[its] = res
        x = axpy(one, M.matvec(z), x0)  # x = x0 + M·z
        return x, make_info(its, res, status), hist

    x, info, hist = _guard3(b, x0, main, hist_len, rdt)
    return (x, info, hist) if record_residuals else (x, info)
