"""TFQMR: transpose-free quasi-minimal-residual solver.

Counterpart of ``sprsolve_tpu/solvers/tfqmr.py`` (Freund, 1993; beyond
the reference's surface): the quasi-minimal residual smoothing of the CGS
half-iterates, at CGS's cost, with the same iteration and exits as the JAX
package:

- Saad, *Iterative Methods*, Alg. 7.7, both half-steps in one loop body,
  the A·y product of the trailing half-step carried into the next
  iteration: two fresh SpMVs per iteration (K1 on a
  :class:`~sprsolve_tpu_torch.ops.padded_dia.PaddedDIA`, K5 on a
  :class:`~sprsolve_tpu_torch.ops.padded_dia.ComplexPaddedDIA`);
- right preconditioning in residual space, x tracked through D = M⁻¹d;
- the loop tests Freund's bound τ·√(m+1); the reported residual is the
  TRUE ‖b − A·x‖/‖b‖, one SpMV after the loop, and CONVERGED is gated
  on it;
- the σ = r̃ᴴv and ρ = r̃ᴴw breakdown gates against (ε·‖r₀‖)²; BREAKDOWN
  keeps the previous state and count.

The loop is a Python ``while`` with one host read of the iteration's
predicates.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..errors import Status
from ..ops.operator import IdentityOperator
from ..vecalg import axpy, conj_dot, eps_for, norm2, real_dtype
from .common import _guard3, check_shapes, make_info, read_flags


def tfqmr(
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
    """Solve general A·x = b with TFQMR. Returns ``(x, SolveInfo)``.

    ``M`` applies M⁻¹ (right preconditioning). ``max_iter`` counts full
    iterations (two SpMVs each). ``record_residuals=True`` also returns the
    quasi-residual bound at the top of each iteration (not the true
    residual, which would cost a third SpMV), a ``(max_iter + 1,)`` tensor.
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
    one_r = torch.ones((), dtype=rdt, device=dev)
    tiny = torch.tensor(torch.finfo(rdt).tiny * 1e4, dtype=rdt, device=dev)

    def main(rhs_norm):
        tol_t = torch.tensor(tol, dtype=rdt, device=dev)
        tol2 = tol_t * rhs_norm
        hist = torch.full((hist_len,), float("nan"), dtype=rdt, device=dev)

        r0 = axpy(-one, A.matvec(x0), b)  # r = b − A·x
        r_norm0 = norm2(r0, group)
        rt = r0                            # shadow residual r̃ = r₀
        if bool(r_norm0 <= tol2):
            if hist_len:
                hist[0] = r_norm0 / rhs_norm
            return x0, make_info(0, r_norm0 / rhs_norm, Status.CONVERGED), hist

        brk_tol = (r_norm0 * eps) ** 2

        def qmr_half(x, D, tau, theta, eta, alpha, w_new, yM, m_idx):
            """Lines 9-12 of Saad 7.7: the quasi-minimization update of one
            half-step (the d-recurrence carried as D = M⁻¹d)."""
            # θ²η/α, α guarded (the first step has η = 0, so the guarded
            # value never contributes)
            shrink = (theta * theta).to(T) * eta / torch.where(alpha.abs() > tiny, alpha, one)
            D_new = axpy(shrink, D, yM)
            theta_new = norm2(w_new, group) / torch.maximum(tau, tiny)
            c = one_r / torch.sqrt(one_r + theta_new * theta_new)
            tau_new = tau * theta_new * c
            eta_new = (c * c).to(T) * alpha
            x_new = axpy(eta_new, D_new, x)
            # √(m+1) rounds the same in float64 then rdt as in rdt alone
            bound = tau_new * math.sqrt(m_idx + 1)
            return x_new, D_new, tau_new, theta_new, eta_new, bound

        yM = M.matvec(r0)
        Ay = A.matvec(yM)
        x, w, y, v, D = x0, r0, r0, Ay, torch.zeros_like(r0)
        tau, theta = r_norm0, torch.zeros((), dtype=rdt, device=dev)
        eta = torch.zeros((), dtype=T, device=dev)
        rho, bound = conj_dot(rt, r0, group), r_norm0
        its, status = 0, Status.RUNNING
        above = True
        while its < max_iter and above:
            if hist_len:
                hist[its] = bound / rhs_norm
            # --- odd half-step m = 2j+1 (Saad lines 5-12)
            sigma = conj_dot(rt, v, group)
            ok_sigma = sigma.abs() > brk_tol
            alpha = rho / torch.where(ok_sigma, sigma, one)
            w1 = axpy(-alpha, Ay, w)
            x1, D1, tau1, theta1, eta1, _ = qmr_half(
                x, D, tau, theta, eta, alpha, w1, yM, 2 * its + 1)
            y_even = axpy(-alpha, v, y)
            yM1 = M.matvec(y_even)
            Ay1 = A.matvec(yM1)
            # --- even half-step m = 2j+2 (lines 8-16)
            w2 = axpy(-alpha, Ay1, w1)
            x2, D2, tau2, theta2, eta2, bound2 = qmr_half(
                x1, D1, tau1, theta1, eta1, alpha, w2, yM1, 2 * its + 2)
            rho_new = conj_dot(rt, w2, group)
            ok = ok_sigma & (rho.abs() > brk_tol)
            beta = rho_new / torch.where(ok, rho, one)
            y_odd = axpy(beta, y_even, w2)
            yM2 = M.matvec(y_odd)
            Ay2 = A.matvec(yM2)
            v_new = axpy(beta, axpy(beta, v, Ay1), Ay2)
            flags = read_flags(ok, bound2 > tol2)
            if not flags[0]:
                status = Status.BREAKDOWN
                break
            x, w, y, yM, Ay, v, D = x2, w2, y_odd, yM2, Ay2, v_new, D2
            tau, theta, eta, rho, bound = tau2, theta2, eta2, rho_new, bound2
            its += 1
            above = flags[1]

        # the loop gate is Freund's bound; report (and gate CONVERGED on) the
        # true residual of the returned x
        true_res = norm2(axpy(-one, A.matvec(x), b), group) / rhs_norm
        if status == Status.RUNNING:
            converged = bool(true_res <= tol_t)
            status = Status.CONVERGED if converged else Status.INSUFFICIENT_ITER
            if hist_len:
                hist[its] = bound / rhs_norm
        return x, make_info(its, true_res, status), hist

    x, info, hist = _guard3(b, x0, main, hist_len, rdt, group)
    return (x, info, hist) if record_residuals else (x, info)
