"""Flexible GMRES(m): GMRES with a preconditioner that may change per step.

Counterpart of ``sprsolve_tpu/solvers/fgmres.py`` (Saad 1993): right
preconditioned GMRES rebuilds the update as M⁻¹(V·y), which holds only
for a FIXED linear M; FGMRES keeps the preconditioned basis
Z = [M⁻¹v₁ … M⁻¹vₘ] beside V and updates x += Z·y, so M may differ per
step — an inner iterative solve
(:class:`~sprsolve_tpu_torch.precond.InnerSolvePrecond`) in particular.
The loop is :func:`~sprsolve_tpu_torch.solvers.gmres.arnoldi_solve`, with
one ``(m, size)`` block Z more; see there for the CGS2, Givens, restart
and true-residual rules.
"""

from __future__ import annotations

from typing import Optional

import torch

from .gmres import arnoldi_solve


def fgmres(
    A,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    M=None,
    tol,
    max_iter,
    restart: int = 32,
    record_residuals: bool = False,
    group=None,
):
    """Solve A·x = b with flexible restarted GMRES(m). Returns ``(x, info)``.

    ``M`` is applied once per inner step and its output kept in the Z basis;
    it need not be linear or constant across steps (any object with
    ``matvec``).  With a fixed linear ``M`` the iterates are those of
    right-preconditioned GMRES; with ``M=None`` it is plain GMRES.
    ``group`` as in :func:`~sprsolve_tpu_torch.solvers.gmres.gmres`.
    """
    x, info, hist = arnoldi_solve(A, b, x0, M=M, tol=tol, max_iter=max_iter,
                                  restart=restart, record_residuals=record_residuals,
                                  flexible=True, group=group)
    return (x, info, hist) if record_residuals else (x, info)
