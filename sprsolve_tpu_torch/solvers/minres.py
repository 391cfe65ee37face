"""MINRES for real-symmetric / complex-Hermitian (possibly indefinite) systems.

Counterpart of ``sprsolve_tpu/solvers/minres.py`` (reference
``src/minres.rs``) with the same recurrences, gates and exits:

- the Lanczos step in the Wiki-stable order, v₊ = A·q − β·q₋ − α·q with
  α = qᴴ(A·q) from the operator's fused ``matvec_dot`` (K3 on a
  :class:`~sprsolve_tpu_torch.ops.padded_dia.PaddedDIA`); unpreconditioned
  and real, an operator with ``orth_norm`` (the PaddedDIA, K4) takes the
  orthogonalisation and ‖v₊‖² in one pass;
- the Givens QR of the tridiagonal and the p- and x-recurrences;
- the recurrence residual res ← res·|s| with the *strict* < threshold test;
  the count is 0-based (the converging pass does not count);
- the preconditioned variant's self-relative β² gate, which exits with
  INVALID_PRECONDITIONER before the update; the guarded 1/β turns lucky
  breakdown into convergence.

The loop is a Python ``while``.  Scalars stay 0-d tensors on the solve's
device, and each iteration brings one small tensor of predicates
(convergence, and with M the β² gate) to the host.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..errors import Status
from ..vecalg import abs2, axpy, conj_dot, eps_for, group_sum, norm2, real_dtype, rscale
from .common import _guard3, check_shapes, make_info


def minres(
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
    """Solve A·x = b with MINRES (A symmetric/Hermitian, may be indefinite).

    Like the reference, symmetry is not checked. Returns ``(x, SolveInfo)``;
    ``record_residuals=True`` also returns the relative recurrence residual
    of each iteration, a ``(max_iter,)`` tensor that is NaN past the last.
    ``group`` makes every reduction a sum over its ranks (b, x0 and x are
    this rank's rows; ``parallel.distributed_solve``): the fused α and
    Σv₊² are local partials, summed here.
    """
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
    # the fused Lanczos step, under the condition of minres.py:177-181
    fused_orth = not has_precond and not b.is_complex() and hasattr(A, "orth_norm")

    def beta_gate(beta_new2, noise_scale):
        # β² = rᴴM⁻¹r must be real positive; negative real and imaginary
        # parts count only above the dot's noise floor ε·noise_scale
        # (minres.py:98-113)
        re2 = beta_new2.real
        bad = re2 < -eps * noise_scale
        if beta_new2.is_complex():
            bad = bad | (beta_new2.imag.abs() > eps * torch.maximum(re2.abs(), noise_scale))
        return bad

    def guarded_inv(beta):
        # β = 0 is a warm start at the solution or lucky breakdown: scale by 0
        return torch.where(beta > 0, one_r / beta, zero_r)

    def main(rhs_norm):
        threshold = torch.tensor(tol, dtype=rdt, device=dev) * rhs_norm
        hist = torch.full((hist_len,), float("nan"), dtype=rdt, device=dev)

        # v_new = b − A·x (r₁, src/minres.rs:76-80)
        v_new = axpy(-one_t, A.matvec(x0), b)
        res_norm = norm2(v_new, group)
        zeros = torch.zeros_like(b)
        status = Status.RUNNING
        if has_precond:
            w_new = M.matvec(v_new)
            beta_new2 = conj_dot(v_new, w_new, group)
            # noise floor of the init dot: ε·‖r₁‖·‖M⁻¹r₁‖
            bad0 = beta_gate(beta_new2, res_norm * norm2(w_new, group))
            beta_new = torch.sqrt(torch.clamp(beta_new2.real, min=0))
            ts = guarded_inv(beta_new)
            v_new, w_new = rscale(ts, v_new), rscale(ts, w_new)
            if bool(bad0):
                status = Status.INVALID_PRECONDITIONER
        else:
            beta_new = res_norm
            v_new = rscale(one_r / beta_new, v_new)
            w_new = zeros
        beta_one = beta_new

        x, v, p, p_old = x0, zeros, zeros, zeros
        c = c_old = eta = one_t
        s = s_old = zero_r
        its, res = 0, zero_r
        while status == Status.RUNNING and its < max_iter:
            beta = beta_new
            v_old, v = v, v_new
            w = w_new if has_precond else v

            # α = qᴴ(A·q) fused with the SpMV (src/minres.rs:116 / :271)
            a_v, alpha = A.matvec_dot(w)
            alpha = group_sum(alpha, group)
            if fused_orth:
                # orthogonalisation + ‖v₊‖² in one kernel pass
                v_next, sumsq = A.orth_norm(a_v, v_old, v, beta, alpha)
                sumsq = group_sum(sumsq, group)
                beta_next = torch.sqrt(sumsq)
            else:
                v_next = axpy((-beta).to(T), v_old, a_v)
                v_next = axpy(-alpha, v, v_next)
            if has_precond:
                w_next = M.matvec(v_next)
                beta_next2 = conj_dot(v_next, w_next, group)
                # the gate's noise scale is the previous β², free
                bad = beta_gate(beta_next2, beta * beta)
                beta_next = torch.sqrt(torch.clamp(beta_next2.real, min=0))
            elif not fused_orth:
                beta_next = norm2(v_next, group)

            # --- Givens rotation on the tridiagonal (src/minres.rs:123-148)
            ts = guarded_inv(beta_next)
            r3 = s_old * beta
            tr = c_old * beta
            r2 = alpha * s + c * tr
            r1_hat = c * alpha - tr * s
            r1_inv = one_r / torch.sqrt(abs2(r1_hat) + beta_next * beta_next)
            c_next = r1_hat * r1_inv
            s_next = beta_next * r1_inv

            # p-recurrence (src/minres.rs:151-160), seeded from q_k
            # (preconditioned: from the M⁻¹-image w, src/minres.rs:324-329)
            p_next = axpy(-r2, p, w)
            p_next = axpy((-r3).to(T), p_old, p_next)
            p_next = rscale(r1_inv, p_next)
            res_next = res_norm * s_next.abs()
            converged = res_next < threshold

            preds = [converged, bad] if has_precond else [converged]
            flags = torch.stack(preds).tolist()   # the iteration's one host read
            if has_precond and flags[1]:
                # the reference returns Err before touching x (:266-274)
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
                hist[its] = res_next / rhs_norm
            if flags[0]:
                status, res = Status.CONVERGED, res_next / rhs_norm
            else:
                its += 1

        if status == Status.RUNNING:
            status, res = Status.INSUFFICIENT_ITER, res_norm / rhs_norm
        return x, make_info(its, res, status), hist

    x, info, hist = _guard3(b, x0, main, hist_len, rdt, group)
    return (x, info, hist) if record_residuals else (x, info)


def _minres_block(A, B: torch.Tensor, X0: Optional[torch.Tensor] = None, *, M=None,
                  tol, max_iter, group=None):
    """MINRES on every column of an (n, m) block in lockstep: the port's
    counterpart of ``jax.vmap(minres)``.

    Each iteration applies A to the whole block once (``A.matmat``: one K1b
    launch on a padded operator's flat view), and every scalar of
    :func:`minres`'s recurrence is an (m,) tensor. A column stops at its own
    exit — convergence, the β² gate of the preconditioned variant,
    ``max_iter`` — and its x, count, residual and status stay frozen after
    (``torch.where``), so each column gets its single solve's result; a zero
    column takes the zero-rhs guard. One host read per iteration: whether
    any column still runs. No fused Lanczos step (K4 takes one vector).

    ``group`` (the JAX package's ``vmap(minres, axis_name=...)``): B and X
    hold this rank's rows, A does its own exchange, and every column
    reduction is one all-reduce of the m partials, two a lockstep
    iteration; every rank then reads the same ``live``.

    Returns ``(X, SolveInfo, steps)``: the info's fields are (m,) tensors,
    as :func:`~sprsolve_tpu_torch.solvers.block_cg.batched` returns, and
    ``steps`` counts the lockstep iterations (block applies in the loop).
    """
    from ..errors import SolveInfo
    from .common import block_apply, check_block, col_conj_dot, col_norm

    B, X0 = check_block(A, B, X0, group)
    has_precond = M is not None
    T, dev = B.dtype, B.device
    rdt = real_dtype(T)
    m, max_iter = B.shape[1], int(max_iter)
    eps = eps_for(T, dev)
    one_r = torch.ones((), dtype=rdt, device=dev)
    zero_r = torch.zeros((), dtype=rdt, device=dev)
    RUN, DONE, BAD, OUT = (torch.tensor(int(s), device=dev) for s in (
        Status.RUNNING, Status.CONVERGED, Status.INVALID_PRECONDITIONER,
        Status.INSUFFICIENT_ITER))

    def beta_gate(beta_new2, noise_scale):
        re2 = beta_new2.real
        bad = re2 < -eps * noise_scale
        if beta_new2.is_complex():
            bad = bad | (beta_new2.imag.abs() > eps * torch.maximum(re2.abs(), noise_scale))
        return bad

    def guarded_inv(beta):
        return torch.where(beta > 0, one_r / beta, zero_r)

    rhs_norm = col_norm(B, group)
    zero_rhs = rhs_norm <= eps
    threshold = torch.tensor(tol, dtype=rdt, device=dev) * rhs_norm
    V_new = torch.addcmul(B, block_apply(A, X0), -torch.ones((), dtype=T, device=dev))
    res_norm = col_norm(V_new, group)
    zeros = torch.zeros_like(B)
    status = torch.full((m,), int(Status.RUNNING), device=dev)
    if has_precond:
        W_new = block_apply(M, V_new)
        beta_new2 = col_conj_dot(V_new, W_new, group)
        bad0 = beta_gate(beta_new2, res_norm * col_norm(W_new, group))
        beta_new = torch.sqrt(torch.clamp(beta_new2.real, min=0))
        ts = guarded_inv(beta_new)
        V_new, W_new = V_new * ts, W_new * ts
        status = torch.where(bad0, BAD, status)
    else:
        beta_new = res_norm
        V_new = V_new * (one_r / beta_new)
        W_new = zeros
    beta_one = beta_new

    X, V, P, P_old = X0, zeros, zeros, zeros
    c = c_old = eta = torch.ones(m, dtype=T, device=dev)
    s = s_old = torch.zeros(m, dtype=rdt, device=dev)
    its = torch.zeros(m, dtype=torch.int64, device=dev)
    res = torch.zeros(m, dtype=rdt, device=dev)

    def settle(live, status, res):
        # columns that left the loop still running ran out of iterations
        out = ~live & (status == RUN)
        return torch.where(out, OUT, status), torch.where(out, res_norm / rhs_norm, res)

    live = (status == RUN) & (its < max_iter) & ~zero_rhs
    status, res = settle(live | zero_rhs, status, res)
    steps = 0
    while bool(live.any()):   # the iteration's one host read
        steps += 1
        beta = beta_new
        V_old, V = V, V_new
        W = W_new if has_precond else V
        AW = block_apply(A, W)
        alpha = col_conj_dot(W, AW, group)
        V_next = torch.addcmul(AW, V_old, (-beta).to(T))
        V_next = torch.addcmul(V_next, V, -alpha)
        if has_precond:
            W_next = block_apply(M, V_next)
            beta_next2 = col_conj_dot(V_next, W_next, group)
            bad = live & beta_gate(beta_next2, beta * beta)
            beta_next = torch.sqrt(torch.clamp(beta_next2.real, min=0))
        else:
            bad = torch.zeros_like(live)
            beta_next = col_norm(V_next, group)

        ts = guarded_inv(beta_next)
        r3 = s_old * beta
        tr = c_old * beta
        r2 = alpha * s + c * tr
        r1_hat = c * alpha - tr * s
        r1_inv = one_r / torch.sqrt(abs2(r1_hat) + beta_next * beta_next)
        c_next = r1_hat * r1_inv
        s_next = beta_next * r1_inv
        P_next = torch.addcmul(W, P, -r2)
        P_next = torch.addcmul(P_next, P_old, (-r3).to(T))
        P_next = P_next * r1_inv
        res_next = res_norm * s_next.abs()
        converged = res_next < threshold

        # a column whose β² gate fails keeps its x (the reference returns
        # before the update); the others take the step
        upd = live & ~bad
        X = torch.where(upd, torch.addcmul(X, P_next, (c_next * eta) * beta_one), X)
        status = torch.where(bad, BAD, status)
        status = torch.where(upd & converged, DONE, status)
        res = torch.where(upd & converged, res_next / rhs_norm, res)
        its = its + (upd & ~converged)
        V_new = V_next * ts
        if has_precond:
            W_new = W_next * ts
        beta_new = beta_next
        c_old, c = c, c_next
        s_old, s = s, s_next
        P_old, P = P, P_next
        eta = eta * (-s_next)
        res_norm = torch.where(live, res_next, res_norm)
        live = upd & ~converged & (its < max_iter)
        status, res = settle(live, status, res)

    X = torch.where(zero_rhs, torch.zeros_like(X), X)
    res = torch.where(zero_rhs, rhs_norm, res)
    status = torch.where(zero_rhs, DONE, status)
    its = torch.where(zero_rhs, torch.zeros_like(its), its)
    return X, SolveInfo(iterations=its, residual=res, status=status), steps
