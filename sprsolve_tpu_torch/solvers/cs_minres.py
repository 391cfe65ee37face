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

Where the input allows it (:func:`_fused_dinv`: a flat complex b, no
``group``, no residual history, and M None or a :class:`DiagPrecond` whose
d⁻¹ is real, of b's real dtype and length), the iteration's vector work
after the operator's ``matvec_conj_dot`` runs as two kernels,
:func:`~sprsolve_tpu_torch.ops.fused.csm_lanczos` (A: the next Lanczos
vector, its M⁻¹-image and dot, and the Givens step on the device) and
:func:`~sprsolve_tpu_torch.ops.fused.csm_update` (B: p, x, v and w, after the
read), in place of about 60 eager launches; the scalars then live in one
small device tensor and the vectors in buffers of the solve's own. On the
CPU their plain versions repeat the unfused ops one for one, so both loops
give the same bits there. Every other input (real, distributed, any other
M, ``record_residuals``) runs the unfused loop.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..errors import Status
from ..ops import fused
from ..ops.fused import csm_beta_gate, csm_givens, csm_guarded_inv
from ..ops.operator import mv_conj_dot
from ..precond import DiagPrecond
from ..vecalg import axpy, conj, conj_dot, eps_for, norm2, real_dtype, rscale
from .common import _guard3, check_shapes, make_info, read_flags


def _fused_dinv(b: torch.Tensor, x0: torch.Tensor, M, group, record_residuals: bool):
    """``(True, d⁻¹ or None)`` when :func:`cs_minres` may run its updates as
    the fused A/B pair: b flat and complex, x0 of its dtype and device, no
    ``group``, no residual history, and M None (no d⁻¹) or a
    :class:`DiagPrecond` whose ``diag_inv`` is real and of b's length, real
    dtype and device. Else ``(False, None)``."""
    if (group is not None or record_residuals or b.dtype not in (torch.complex64,
                                                                  torch.complex128)
            or b.dim() != 1 or x0.dtype != b.dtype or x0.device != b.device):
        return False, None
    if M is None:
        return True, None
    if type(M) is DiagPrecond:
        d = M.diag_inv
        if d.shape == b.shape and d.dtype == real_dtype(b.dtype) and d.device == b.device:
            return True, d.contiguous()
    return False, None


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
    routed, dinv = _fused_dinv(b, x0, M, group, record_residuals)

    T, dev = b.dtype, b.device
    rdt = real_dtype(T)
    max_iter = int(max_iter)
    hist_len = max_iter if record_residuals else 0
    eps = eps_for(T, dev)
    one_t = torch.ones((), dtype=T, device=dev)
    zero_r = torch.zeros((), dtype=rdt, device=dev)

    def imag(z):
        return z.imag if z.is_complex() else torch.zeros_like(z)

    def fused_loop(v, w, beta, res_norm, threshold, beta_one, denom, status):
        # the unfused loop below as A and B: the scalars in one device
        # tensor, A writing v_next over v_old and w_next over the spare w
        # buffer, B p_next over p_old and x in place, so x0 is never written
        st = fused.csm_state(beta, res_norm, threshold, beta_one)
        x = x0.clone(memory_format=torch.contiguous_format) if status == Status.RUNNING else x0
        v_old, p, p_old = (torch.zeros_like(v) for _ in range(3))
        w_spare = torch.empty_like(v) if has_precond else None
        if not has_precond:
            w = v
        its, res = 0, zero_r
        while status == Status.RUNNING and its < max_iter:
            y, alpha = mv_conj_dot(A, w)
            v_next, w_next = fused.csm_lanczos(y, v_old, v, dinv, alpha, st, w_spare)
            del y
            converged, bad = read_flags(st[fused.CSM_FLAGS:fused.CSM_FLAGS + 2])
            if bad:
                # the β² gate exits before the update (cs_minres.py:274-282)
                status = Status.INVALID_PRECONDITIONER
                break
            fused.csm_update(w, p, p_old, x, v_next, w_next, st)
            v_old, v = v, v_next
            p_old, p = p, p_old
            if has_precond:
                w_spare, w = w, w_next
            else:
                w = v
            if converged:
                status, res = Status.CONVERGED, st[fused.CSM_RES] / denom
            else:
                its += 1
        if status == Status.RUNNING:
            status, res = Status.INSUFFICIENT_ITER, st[fused.CSM_RES] / denom
        return x, make_info(its, res, status)

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
            bad0 = (csm_beta_gate(beta_new2, re_b, eps) | (re_b <= 0)
                    | (imag(beta_b2).abs() > eps * re_b))
            denom = torch.sqrt(torch.clamp(re_b, min=0))
            beta_new = torch.sqrt(torch.clamp(beta_new2.real, min=0))
            # |β²|^½: a clamped negative β² reports its magnitude, never 0
            res_norm = torch.sqrt(beta_new2.abs())
            ts = csm_guarded_inv(beta_new)
            v_new, w_new = rscale(ts, v_new), rscale(ts, w_new)
        else:
            bad0 = torch.zeros((), dtype=torch.bool, device=dev)
            res_norm = norm2(v_new, group)
            denom = rhs_norm
            beta_new = res_norm
            v_new = rscale(csm_guarded_inv(beta_new), v_new)
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
        if routed:
            return (*fused_loop(v_new, w_new, beta_new, res_norm, threshold, beta_one, denom,
                                status), hist)
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
                bad = csm_beta_gate(beta_next2, beta * beta, eps)
                beta_next = torch.sqrt(torch.clamp(beta_next2.real, min=0))
            else:
                beta_next = norm2(v_next, group)

            # modified Givens with c / c̄ entries (src/cs_minres.rs:109-134)
            ts, r2, r3, r1_inv, c_next, s_next = csm_givens(alpha, beta, beta_next, c_old, c,
                                                            s_old, s)

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
