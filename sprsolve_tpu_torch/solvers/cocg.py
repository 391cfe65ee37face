"""COCG: conjugate-orthogonal CG for complex-*symmetric* systems.

Counterpart of ``sprsolve_tpu/solvers/cocg.py`` (beyond the reference's
surface; van der Vorst & Melissen, 1990): CG with every Hermitian inner
product replaced by the unconjugated bilinear form xᵀy, under which a
complex-symmetric A is self-adjoint.  One SpMV per iteration (K5 on a
:class:`~sprsolve_tpu_torch.ops.padded_dia.ComplexPaddedDIA`), and any
complex-*symmetric* M⁻¹ serves, the complex Jacobi included.  The same
iteration and exits as the JAX package:

- the ‖r‖ > tol·‖b‖ test at the top of each iteration, on the true 2-norm;
  a start already within tol exits at 0 iterations;
- the ρ = rᵀz and pᵀAp breakdown gates against (ε·‖r₀‖)², BiCGStab's
  ρ-scale: the bilinear form is indefinite, so either can vanish without
  convergence; BREAKDOWN keeps the previous x, count and residual;
- converged when the loop ends with ‖r‖ ≤ tol·‖b‖, else INSUFFICIENT_ITER.

|ρ| and |pᵀAp| are ``abs()``; the JAX package's sqrt(re² + im²) form works
around a TPU compiler fault and is not ported.  The loop is a Python
``while`` with one host read of the iteration's predicates, as in
:func:`~sprsolve_tpu_torch.solvers.cg.cg`.  Several right-hand sides go
through :func:`~sprsolve_tpu_torch.solvers.block_cg.batched`, which runs one
solve per column: each column stops at its own exit, what the JAX
package's per-column freeze of COCG's lockstep ``vmap`` guarantees there.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..errors import Status
from ..ops.operator import IdentityOperator
from ..vecalg import axpy, dot, eps_for, norm2, real_dtype
from .common import _guard3, check_shapes, make_info


def cocg(
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
    """Solve complex-symmetric A·x = b with COCG. Returns ``(x, SolveInfo)``.

    ``M`` must apply a complex-*symmetric* M⁻¹ (e.g.
    :class:`~sprsolve_tpu_torch.precond.ComplexDiagPrecond` or a real
    ``DiagPrecond``). On a real symmetric system COCG is CG.
    ``record_residuals=True`` also returns the relative residual at the top
    of each iteration, a ``(max_iter + 1,)`` tensor that is NaN past the last.
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
    # +1: the final write lands at hist[its] with its == max_iter when the
    # solve converges exactly at the budget
    hist_len = max_iter + 1 if record_residuals else 0
    eps = eps_for(T, dev)
    one = torch.ones((), dtype=T, device=dev)

    def main(rhs_norm):
        tol2 = torch.tensor(tol, dtype=rdt, device=dev) * rhs_norm
        hist = torch.full((hist_len,), float("nan"), dtype=rdt, device=dev)

        r = axpy(-one, A.matvec(x0), b)  # r = b − A·x
        r_norm = norm2(r, group)
        above, below = torch.stack([r_norm > tol2, r_norm <= tol2]).tolist()
        if below:
            if hist_len:
                hist[0] = r_norm / rhs_norm
            return x0, make_info(0, r_norm / rhs_norm, Status.CONVERGED), hist

        z = M.matvec(r)
        rho = dot(r, z, group)           # unconjugated bilinear form
        brk_tol = (r_norm * eps) ** 2
        x, p = x0, z
        its, status, res = 0, Status.RUNNING, None
        while its < max_iter and above:
            if hist_len:
                hist[its] = r_norm / rhs_norm
            q = A.matvec(p)
            pq = dot(p, q, group)
            ok = (rho.abs() > brk_tol) & (pq.abs() > brk_tol)
            alpha = rho / torch.where(ok, pq, one)
            x_next = axpy(alpha, p, x)
            r = axpy(-alpha, q, r)
            z = M.matvec(r)
            rho_next = dot(r, z, group)
            r_norm_next = norm2(r, group)
            p = axpy(rho_next / torch.where(ok, rho, one), p, z)  # p = z + β·p
            rho = rho_next
            flags = torch.stack([ok, r_norm_next > tol2, r_norm_next <= tol2]).tolist()
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


def _cocg_block(A, B: torch.Tensor, X0: Optional[torch.Tensor] = None, *, M=None,
                tol, max_iter, group=None):
    """COCG on every column of an (n, m) block in lockstep: the port's
    counterpart of ``jax.vmap(cocg)``.

    Each iteration applies A to the whole block once (``A.matmat``), and
    ρ, pᵀAp, α and the norms are (m,) tensors. A column stops at its own
    exit — convergence, a ρ or pᵀAp breakdown, ``max_iter`` — and its x,
    count, residual and status stay frozen after (the ``live``/``upd``
    masks of ``sprsolve_tpu/solvers/cocg.py:136-181``), so each column gets
    its single solve's result; a zero column takes the zero-rhs guard. One
    host read per iteration: whether any column still runs.

    ``group`` (the JAX package's ``vmap(cocg, axis_name=...)``): B and X
    hold this rank's rows, A does its own exchange, and every column
    reduction is one all-reduce of the m partials, three a lockstep
    iteration; every rank then reads the same ``live``.

    Returns ``(X, SolveInfo, steps)``: the info's fields are (m,) tensors,
    and ``steps`` counts the lockstep iterations (block applies in the
    loop).
    """
    from ..errors import SolveInfo
    from .common import block_apply, check_block, col_dot, col_norm

    B, X0 = check_block(A, B, X0, group)
    T, dev = B.dtype, B.device
    rdt = real_dtype(T)
    m, max_iter = B.shape[1], int(max_iter)
    eps = eps_for(T, dev)
    one = torch.ones((), dtype=T, device=dev)
    precond = (lambda R: R) if M is None else (lambda R: block_apply(M, R))
    RUN, DONE, BRK, OUT = (torch.tensor(int(s), device=dev) for s in (
        Status.RUNNING, Status.CONVERGED, Status.BREAKDOWN, Status.INSUFFICIENT_ITER))

    rhs_norm = col_norm(B, group)
    zero_rhs = rhs_norm <= eps
    tol2 = torch.tensor(tol, dtype=rdt, device=dev) * rhs_norm
    R = torch.addcmul(B, block_apply(A, X0), -one)   # R = B − A·X
    r_norm = col_norm(R, group)
    below = r_norm <= tol2
    status = torch.where(below, DONE, torch.full((m,), int(Status.RUNNING), device=dev))
    res = torch.where(below, r_norm / rhs_norm, torch.zeros_like(r_norm))
    its = torch.zeros(m, dtype=torch.int64, device=dev)

    Z = precond(R)
    rho = col_dot(R, Z, group)            # unconjugated bilinear form
    brk_tol = (r_norm * eps) ** 2
    X, P = X0, Z

    def settle(live, status, res):
        # columns that left the loop running: converged or out of iterations
        out = ~live & (status == RUN)
        status = torch.where(out, torch.where(r_norm <= tol2, DONE, OUT), status)
        return status, torch.where(out, r_norm / rhs_norm, res)

    live = (status == RUN) & (r_norm > tol2) & (its < max_iter) & ~zero_rhs
    status, res = settle(live | zero_rhs, status, res)
    steps = 0
    while bool(live.any()):   # the iteration's one host read
        steps += 1
        Q = block_apply(A, P)
        pq = col_dot(P, Q, group)
        ok = (rho.abs() > brk_tol) & (pq.abs() > brk_tol)
        alpha = rho / torch.where(ok, pq, one)
        X_next = torch.addcmul(X, P, alpha)
        R = torch.addcmul(R, Q, -alpha)
        Z = precond(R)
        rho_next = col_dot(R, Z, group)
        r_norm_next = col_norm(R, group)
        P = torch.addcmul(Z, P, rho_next / torch.where(ok, rho, one))   # p = z + β·p
        rho = rho_next
        # BREAKDOWN keeps the previous x, count and residual
        brk = live & ~ok
        status = torch.where(brk, BRK, status)
        res = torch.where(brk, r_norm / rhs_norm, res)
        upd = live & ok
        X = torch.where(upd, X_next, X)
        r_norm = torch.where(upd, r_norm_next, r_norm)
        its = its + upd
        live = upd & (r_norm > tol2) & (its < max_iter)
        status, res = settle(live, status, res)

    X = torch.where(zero_rhs, torch.zeros_like(X), X)
    res = torch.where(zero_rhs, rhs_norm, res)
    status = torch.where(zero_rhs, DONE, status)
    return X, SolveInfo(iterations=its, residual=res, status=status), steps
