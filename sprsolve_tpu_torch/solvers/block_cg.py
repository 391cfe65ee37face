"""Block (multi-rhs) solvers: block CG and a per-column batching adapter.

Counterpart of ``sprsolve_tpu/solvers/block_cg.py`` (O'Leary 1980; beyond
the reference's surface, which solves one rhs at a time):

- :func:`block_cg` searches the sum of the k Krylov spaces with an
  (n, k) block: every inner product is a k×k Gram product (full
  precision), α and β are k×k solves of the jittered Pᴴ·A·P, a column
  with a zero rhs counts as converged with x = 0, and a non-positive Gram
  diagonal is BREAKDOWN.  ``A.matmat`` serves where the operator has one
  (BSR, ``HybridDIA``, ``DIA``, and a
  :class:`~sprsolve_tpu_torch.ops.padded_dia.PaddedDIA`, whose (padded_len,
  k) block is one K1b launch); otherwise one ``matvec`` per column.
- :func:`batched` lifts any single-rhs solver to a block by running it
  ONCE PER COLUMN, so each column stops at its own exit.  The JAX
  package's ``vmap`` runs the columns in lockstep, and a column of an
  unfrozen recurrence (BiCGStab, CGS, IDR(s)) keeps iterating there until
  the slowest one ends; here its count is its single solve's.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..errors import SolveInfo, Status
from ..vecalg import eps_for, full_precision_matmul, group_sum, real_dtype
from .common import block_apply, make_info


def _apply_M(M, R):
    """Column-wise preconditioner apply on an (n, k) block."""
    return R if M is None else block_apply(M, R)


def block_cg(
    A,
    B: torch.Tensor,
    X0: Optional[torch.Tensor] = None,
    *,
    M=None,
    tol,
    max_iter,
    group=None,
):
    """Solve SPD A·X = B for an (n, k) block of right-hand sides.

    Returns ``(X, SolveInfo)``: ``iterations`` is the loop count (shared by
    the columns), ``residual`` the worst per-column relative residual, and
    ``status`` CONVERGED only when every column converged.  The k×k normal
    matrix carries a jitter of ε·mean(|diag|), which keeps converged
    columns inert as the block loses rank.  ``group`` makes the column norms
    and the Gram products sums over its ranks (B, X0 and X are this rank's
    rows; ``parallel.distributed_solve``).
    """
    B = torch.as_tensor(B)
    if B.dim() != 2:
        raise ValueError("block_cg expects B of shape (n, k)")
    k = B.shape[1]
    if X0 is None:
        X0 = torch.zeros_like(B)

    T, dev = B.dtype, B.device
    rdt = real_dtype(T)
    max_iter = int(max_iter)
    eps = eps_for(T, dev)
    eye = torch.eye(k, dtype=T, device=dev)
    tiny = torch.tensor(torch.finfo(rdt).tiny, dtype=rdt, device=dev)

    def colnorms(R):
        return torch.sqrt(group_sum(torch.sum(R.abs() ** 2, dim=0), group)).to(rdt)

    def gram(U, V):
        """(k, k) = Uᴴ·V, one full-precision product."""
        return group_sum(full_precision_matmul(U.conj().T, V), group)

    bn = colnorms(B)
    # zero-rhs columns count as converged with x = 0 (the reference's
    # early-out, src/bicg_stab.rs:56-60, per column)
    thresholds = tol * torch.maximum(bn, tiny)

    X, R = X0, B - block_apply(A, X0)
    Z = _apply_M(M, R)
    P, rn = Z, colnorms(R)
    its, status = 0, Status.RUNNING
    while its < max_iter and bool(torch.any(rn > thresholds)):
        Q = block_apply(A, P)
        S = gram(P, Q)
        jitter = eps * torch.mean(torch.diagonal(S).abs())
        S = S + jitter.to(T) * eye
        # solve_ex: a singular S gives non-finite steps, as jnp.linalg.solve
        # does, instead of raising (and reads no status back to the host)
        alpha = torch.linalg.solve_ex(S, gram(P, R)).result
        X_new = X + full_precision_matmul(P, alpha)
        R_new = R - full_precision_matmul(Q, alpha)
        Z = _apply_M(M, R_new)
        beta = -torch.linalg.solve_ex(S, gram(Q, Z)).result
        P = Z + full_precision_matmul(P, beta)
        # non-PD detection: the (jittered) Gram's diagonal must stay positive
        if not bool(torch.all(torch.diagonal(S).real > 0)):
            status = Status.BREAKDOWN
            break
        X, R, rn, its = X_new, R_new, colnorms(R_new), its + 1

    if status == Status.RUNNING:
        status = (Status.CONVERGED if bool(torch.all(rn <= thresholds))
                  else Status.INSUFFICIENT_ITER)
    res = torch.max(rn / torch.maximum(bn, eps))
    return X, make_info(its, res, status)


def batched(solver):
    """Lift a single-rhs functional solver to an (n, k) block of rhs.

    ``batched(bicgstab)(A, B, X0, **kw)`` runs the solver once per column
    and returns the (n, k) solution with a ``SolveInfo`` whose
    ``iterations``, ``residual`` and ``status`` are (k,) tensors.  Each
    column stops at its own exit (the JAX package's lockstep ``vmap``
    freezes only COCG's columns).  Use :func:`block_cg` for SPD systems.
    """

    def run(A, B, X0=None, **kwargs):
        B = torch.as_tensor(B)
        if B.dim() != 2:
            raise ValueError("batched solver expects B of shape (n, k)")
        if X0 is None:
            X0 = torch.zeros_like(B)
        xs, infos = [], []
        for i in range(B.shape[1]):
            x, info = solver(A, B[:, i].contiguous(), X0[:, i].contiguous(), **kwargs)[:2]
            xs.append(x)
            infos.append(info)
        dev = B.device
        rdt = real_dtype(B.dtype)
        return torch.stack(xs, dim=1), SolveInfo(
            iterations=torch.tensor([int(i.iterations) for i in infos], device=dev),
            residual=torch.tensor([float(i.residual) for i in infos], dtype=rdt,
                                  device=dev),
            status=torch.tensor([int(i.status) for i in infos], device=dev))

    return run
