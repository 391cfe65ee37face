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
):
    """Solve complex-symmetric A·x = b with COCG. Returns ``(x, SolveInfo)``.

    ``M`` must apply a complex-*symmetric* M⁻¹ (e.g.
    :class:`~sprsolve_tpu_torch.precond.ComplexDiagPrecond` or a real
    ``DiagPrecond``). On a real symmetric system COCG is CG.
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
    eps = eps_for(T, dev)
    one = torch.ones((), dtype=T, device=dev)

    def main(rhs_norm):
        tol2 = torch.tensor(tol, dtype=rdt, device=dev) * rhs_norm
        hist = torch.full((hist_len,), float("nan"), dtype=rdt, device=dev)

        r = axpy(-one, A.matvec(x0), b)  # r = b − A·x
        r_norm = norm2(r)
        above, below = torch.stack([r_norm > tol2, r_norm <= tol2]).tolist()
        if below:
            if hist_len:
                hist[0] = r_norm / rhs_norm
            return x0, make_info(0, r_norm / rhs_norm, Status.CONVERGED), hist

        z = M.matvec(r)
        rho = dot(r, z)                  # unconjugated bilinear form
        brk_tol = (r_norm * eps) ** 2
        x, p = x0, z
        its, status, res = 0, Status.RUNNING, None
        while its < max_iter and above:
            if hist_len:
                hist[its] = r_norm / rhs_norm
            q = A.matvec(p)
            pq = dot(p, q)
            ok = (rho.abs() > brk_tol) & (pq.abs() > brk_tol)
            alpha = rho / torch.where(ok, pq, one)
            x_next = axpy(alpha, p, x)
            r = axpy(-alpha, q, r)
            z = M.matvec(r)
            rho_next = dot(r, z)
            r_norm_next = norm2(r)
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

    x, info, hist = _guard3(b, x0, main, hist_len, rdt)
    return (x, info, hist) if record_residuals else (x, info)
