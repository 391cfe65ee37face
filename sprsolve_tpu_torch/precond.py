"""Preconditioners: the diagonal (Jacobi) ones.

Counterpart of ``sprsolve_tpu/precond.py:20-94,581-627`` (reference
``src/precond.rs``): the reciprocal of the diagonal is taken once at
construction and the apply is an elementwise multiply.  As in the
reference, a real diagonal may serve a complex system (``src/precond.rs:6-13``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .sparse.containers import _host
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


@dataclasses.dataclass(frozen=True)
class ComplexDiagPrecond:
    """Jacobi preconditioner with a complex diagonal: M⁻¹ = diag(1/d).

    The JAX package stores re/im planes because some of its backends reject
    complex device buffers; here ``diag_inv`` is one complex tensor. It is
    its own class, not a ``DiagPrecond``, so that the operators can fold it
    into kernel K7 (``ops.operator.mv_prec_wdot``) and CS-MINRES can refuse
    it (a complex diagonal is no real symmetric-positive M⁻¹)."""

    diag_inv: torch.Tensor

    @staticmethod
    def new(diag, device=None) -> "ComplexDiagPrecond":
        d = torch.as_tensor(diag, device=device)
        if not d.is_complex():
            d = d.to(torch.complex64 if d.dtype == torch.float32 else torch.complex128)
        return ComplexDiagPrecond(diag_inv=torch.ones((), dtype=d.dtype,
                                                      device=d.device) / d)

    @property
    def shape(self):
        n = self.diag_inv.shape[0]
        return (n, n)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.diag_inv

    def matvec_dot(self, x: torch.Tensor):
        y = self.matvec(x)
        return y, conj_dot(x, y)


def real_abs_jacobi(op) -> DiagPrecond:
    """Real 1/|d| Jacobi in ``op``'s own layout — the preconditioner shape
    the Saunders process of preconditioned CS-MINRES needs (real symmetric
    positive; Freund's standard choice for complex-symmetric systems).

    A two-plane padded operator builds |d| from its plane diagonals, a real
    padded operator from its padded diagonal, anything else from
    ``diagonal()`` on the host. Zero diagonals (and the padded layout's pad
    slots) are forced to 1, which keeps them inert."""
    if hasattr(op, "diagonal_padded"):
        if hasattr(op, "re"):
            dr, di = op.re.diagonal_padded(), op.im.diagonal_padded()
            d = torch.sqrt(dr * dr + di * di)
        else:
            d = op.diagonal_padded().abs()
        one = torch.ones((), dtype=d.dtype, device=d.device)
        return DiagPrecond(diag_inv=one / torch.where(d == 0, one, d))
    d = np.abs(_host(op.diagonal()))
    d[d == 0] = 1.0
    rdt = d.dtype if d.dtype in (np.float32, np.float64) else np.float32
    return DiagPrecond.new(d.astype(rdt), device=getattr(op, "device", None))
