"""Preconditioners: the diagonal (Jacobi) one of the first slice.

Counterpart of ``sprsolve_tpu/precond.py:20-48`` (reference
``src/precond.rs``): the reciprocal of the diagonal is taken once at
construction and the apply is an elementwise multiply.
"""

from __future__ import annotations

import dataclasses

import torch

from .vecalg import conj_dot


@dataclasses.dataclass(frozen=True)
class DiagPrecond:
    """Jacobi (diagonal) preconditioner: M⁻¹ = diag(1/d)."""

    diag_inv: torch.Tensor

    @staticmethod
    def new(diag, device=None) -> "DiagPrecond":
        diag = torch.as_tensor(diag, device=device)
        return DiagPrecond(diag_inv=torch.ones((), dtype=diag.dtype,
                                               device=diag.device) / diag)

    @property
    def shape(self):
        n = self.diag_inv.shape[0]
        return (n, n)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.diag_inv

    def matvec_dot(self, x: torch.Tensor):
        # the reference leaves this unimplemented (src/precond.rs:55-62)
        y = x * self.diag_inv
        return y, conj_dot(x, y)
