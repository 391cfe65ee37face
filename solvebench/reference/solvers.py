"""Plain reference solves, for the control of the correctness check.

:func:`jacobi_cg` is Jacobi-preconditioned CG in the bilinear form uᵀv: CG
on a real SPD operator, COCG on a complex-symmetric one.  With ``storage``
given, every vector is rounded to that type after each operation (complex
vectors plane by plane), with the arithmetic in the vectors' own type: the
solve a program would make that kept its vectors in the lower precision.
It uses the plain operator of :mod:`.stencil7` and nothing of the program.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from . import stencil7


@dataclass(frozen=True)
class Info:
    iterations: int
    converged: bool


def rounded(v: torch.Tensor, storage: Optional[torch.dtype]) -> torch.Tensor:
    """``v`` rounded to ``storage`` and back (each plane of a complex ``v``)."""
    if storage is None:
        return v
    if v.is_complex():
        return torch.complex(v.real.to(storage).to(v.real.dtype),
                             v.imag.to(storage).to(v.real.dtype))
    return v.to(storage).to(v.dtype)


def jacobi_cg(cfg: dict, b: torch.Tensor, *, tol: float, max_iter: int,
              storage: Optional[torch.dtype] = None):
    """``(x, Info)``: x from 0 until ‖b − A·x‖ ≤ tol·‖b‖ by the recurrence,
    or ``max_iter`` steps."""
    q = lambda v: rounded(v, storage)
    d = stencil7.diagonal(cfg)
    dinv = 1 / d if b.is_complex() else 1 / d.real
    x = torch.zeros_like(b)
    r = q(b.clone())
    z = q(r * dinv)
    p = z
    rz = (r * z).sum()
    limit = tol * float(torch.linalg.vector_norm(b))
    its = 0
    while its < max_iter:
        if float(torch.linalg.vector_norm(r)) <= limit:
            return x, Info(its, True)
        ap = q(stencil7.matvec(cfg, p))
        alpha = rz / (p * ap).sum()
        x = q(x + alpha * p)
        r = q(r - alpha * ap)
        z = q(r * dinv)
        rz_next = (r * z).sum()
        p = q(z + (rz_next / rz) * p)
        rz = rz_next
        its += 1
    return x, Info(its, float(torch.linalg.vector_norm(r)) <= limit)
