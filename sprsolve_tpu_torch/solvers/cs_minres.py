"""CS-MINRES: MINRES for complex-*symmetric* (Aᵀ = A, non-Hermitian) systems
via the Saunders process.

Counterpart of ``sprsolve_tpu/solvers/cs_minres.py`` (reference
``src/cs_minres.rs``) with the same recurrences, gates and exits:

- the Krylov step multiplies A·conj(q_k), with α = conj(q_k)ᵀ(A·conj(q_k))
  from the operator's fused ``matvec_conj_dot`` (K6 with ``conj_x`` on a
  :class:`~sprsolve_tpu_torch.ops.padded_dia.ComplexPaddedDIA`);
- the modified Givens rotation with conjugated cosines: tr = c̄_old·β,
  r1̂ = c̄·α − tr·s, new cosine c = conj(r1̂)·r1_inv;
- the p-recurrence seeded from conj(q_k);
- the recurrence residual res ← res·|s| with the strict < threshold test;
  the count is 0-based (the converging pass does not count); a start
  already within tol exits at 0 iterations.

**Preconditioned form (beyond the reference).** ``M`` must apply a real
symmetric positive M⁻¹ (e.g. the real 1/|d| Jacobi of
:func:`~sprsolve_tpu_torch.precond.real_abs_jacobi`): the Saunders step then
runs on the M⁻¹-image w = M⁻¹·v, the residual is tracked in the M⁻¹-norm and
reported relative to ‖b‖_{M⁻¹}, and β² = conj(v̂)ᵀM⁻¹v̂ must be real positive
above its noise floor, else the solve exits INVALID_PRECONDITIONER before
touching x. With M = I it reduces to the unpreconditioned process.

The loop is a Python ``while``.  Scalars stay 0-d tensors on the solve's
device, and each iteration brings one small tensor of predicates (the
convergence test, and with M the β² gate) to the host; the ``lax.cond``
branches of the JAX package are Python branches on that read.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..errors import Status
from ..ops.operator import mv_conj_dot
from ..vecalg import abs2, axpy, conj, conj_dot, eps_for, norm2, real_dtype, rscale
from .common import _guard3, check_shapes, make_info, read_flags


def cs_minres(
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
    """Solve A·x = b for complex-symmetric A. Returns ``(x, SolveInfo)``;
    ``record_residuals=True`` also returns the relative recurrence residual
    of each iteration, a ``(max_iter,)`` tensor that is NaN past the last.

    ``M`` (optional) applies a real symmetric-positive M⁻¹ — see the module
    docstring for the β² gate. ``group`` makes every reduction a sum over
    its ranks (b, x0 and x are this rank's rows; ``parallel.distributed_solve``)."""
    if x0 is None:
        x0 = torch.zeros_like(b)
    check_shapes(A, b, x0, group)
    has_precond = M is not None

    T, dev = b.dtype, b.device
    rdt = real_dtype(T)
    max_iter = int(max_iter)
    hist_len = max_iter if record_residuals else 0
    eps = eps_for(T, dev)
    one_t = torch.ones((), dtype=T, device=dev)
    one_r = torch.ones((), dtype=rdt, device=dev)
    zero_r = torch.zeros((), dtype=rdt, device=dev)

    def imag(z):
        return z.imag if z.is_complex() else torch.zeros_like(z)

    def beta_gate(beta_new2, noise_scale):
        # β² = v̂ᴴM⁻¹v̂ must be real positive: a negative real part, or an
        # imaginary part, counts only above the dot's noise floor
        # ε·noise_scale (cs_minres.py:101-116)
        re2 = beta_new2.real
        return (re2 < -eps * noise_scale) | (
            imag(beta_new2).abs() > eps * torch.maximum(re2.abs(), noise_scale))

    def guarded_inv(beta):
        # β = 0 is a warm start at the solution or lucky breakdown: scale by 0
        return torch.where(beta > 0, one_r / beta, zero_r)

    def main(rhs_norm):
        tol_t = torch.tensor(tol, dtype=rdt, device=dev)
        hist = torch.full((hist_len,), float("nan"), dtype=rdt, device=dev)
        v_new = axpy(-one_t, A.matvec(x0), b)  # r₁ = b − A·x
        zeros = torch.zeros_like(b)

        if has_precond:
            # the Givens sines contract the preconditioned system's residual:
            # start from, and report relative to, the M⁻¹-norm
            # (cs_minres.py:122-154)
            beta_b2 = conj_dot(b, M.matvec(b), group)
            w_new = M.matvec(v_new)
            beta_new2 = conj_dot(v_new, w_new, group)
            re_b = beta_b2.real
            bad0 = (beta_gate(beta_new2, re_b) | (re_b <= 0)
                    | (imag(beta_b2).abs() > eps * re_b))
            denom = torch.sqrt(torch.clamp(re_b, min=0))
            beta_new = torch.sqrt(torch.clamp(beta_new2.real, min=0))
            # |β²|^½: a clamped negative β² reports its magnitude, never 0
            res_norm = torch.sqrt(beta_new2.abs())
            ts = guarded_inv(beta_new)
            v_new, w_new = rscale(ts, v_new), rscale(ts, w_new)
        else:
            bad0 = torch.zeros((), dtype=torch.bool, device=dev)
            res_norm = norm2(v_new, group)
            denom = rhs_norm
            beta_new = res_norm
            v_new = rscale(guarded_inv(beta_new), v_new)
            w_new = zeros
        beta_one = beta_new
        threshold = tol_t * denom

        done, bad = read_flags(res_norm <= threshold, bad0)
        if done and not bad:
            # already converged at entry (e.g. a warm start at the solution)
            if hist_len:
                hist[0] = res_norm / denom
            return x0, make_info(0, res_norm / denom, Status.CONVERGED), hist

        status = Status.INVALID_PRECONDITIONER if bad else Status.RUNNING
        x, v, p, p_old = x0, zeros, zeros, zeros
        c = c_old = eta = one_t
        s = s_old = zero_r
        its, res = 0, zero_r
        while status == Status.RUNNING and its < max_iter:
            beta = beta_new
            v_old, v = v, v_new
            w = w_new if has_precond else v

            # A·conj(q_k) and α = conj(q_k)ᵀ(A·conj(q_k)) in one operator pass
            # (src/cs_minres.rs:99-103); preconditioned, on the M⁻¹-image w
            tvec = conj(w)                      # seeds p below
            v_next, alpha = mv_conj_dot(A, w, group)
            v_next = axpy((-beta).to(T), v_old, v_next)
            v_next = axpy(-alpha, v, v_next)
            if has_precond:
                w_next = M.matvec(v_next)
                beta_next2 = conj_dot(v_next, w_next, group)
                # the gate's noise scale is the previous β², free
                bad = beta_gate(beta_next2, beta * beta)
                beta_next = torch.sqrt(torch.clamp(beta_next2.real, min=0))
            else:
                beta_next = norm2(v_next, group)

            # modified Givens with c / c̄ entries (src/cs_minres.rs:109-134)
            ts = guarded_inv(beta_next)
            r3 = s_old * beta
            tr = torch.conj(c_old) * beta
            r2 = alpha * s + c * tr
            r1_hat = torch.conj(c) * alpha - tr * s
            r1_inv = one_r / torch.sqrt(abs2(r1_hat) + beta_next * beta_next)
            c_next = torch.conj(r1_hat) * r1_inv
            s_next = beta_next * r1_inv

            # p seeded from conj(q_k) (src/cs_minres.rs:141-146); with M from
            # conj(w_k)
            p_next = axpy(-r2, p, tvec)
            p_next = axpy((-r3).to(T), p_old, p_next)
            p_next = rscale(r1_inv, p_next)
            res_next = res_norm * s_next.abs()
            converged = res_next < threshold

            preds = [converged, bad] if has_precond else [converged]
            flags = read_flags(*preds)   # the iteration's one host read
            if has_precond and flags[1]:
                # the β² gate exits before the update (cs_minres.py:274-282)
                status = Status.INVALID_PRECONDITIONER
                break
            x = axpy((c_next * eta) * beta_one, p_next, x)
            v_new = rscale(ts, v_next)
            if has_precond:
                w_new = rscale(ts, w_next)
            beta_new = beta_next
            c_old, c = c, c_next
            s_old, s = s, s_next
            p_old, p = p, p_next
            eta = eta * (-s_next)
            res_norm = res_next
            if hist_len:
                hist[its] = res_next / denom
            if flags[0]:
                status, res = Status.CONVERGED, res_next / denom
            else:
                its += 1

        if status == Status.RUNNING:
            status, res = Status.INSUFFICIENT_ITER, res_norm / denom
        return x, make_info(its, res, status), hist

    x, info, hist = _guard3(b, x0, main, hist_len, rdt, group)
    return (x, info, hist) if record_residuals else (x, info)
