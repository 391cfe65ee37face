"""Multigrid support (counterpart of ``sprsolve_tpu/multigrid.py``).

Only :class:`FlatViewOperator` (``multigrid.py:242-271``) is here so far:
``HybridDIA`` puts a ``PaddedDIA`` core behind it.  ``GridMGPrecond`` and
``M="amg"`` are ``ROADMAP.md`` Queue 1 item 10.
"""

from __future__ import annotations

import dataclasses

import torch

from .vecalg import conj_dot


@dataclasses.dataclass(frozen=True)
class FlatViewOperator:
    """Flat-vector view of a padded-layout operator: each apply pads x,
    runs the operator's SpMV (kernel K1 on a ``PaddedDIA``) and unpads the
    result, two vector passes besides the SpMV."""

    op: object

    @property
    def shape(self):
        return self.op.shape

    @property
    def device(self) -> torch.device:
        return self.op.device

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return self.op.unpad_vec(self.op.matvec(self.op.pad_vec(x)))

    def matvec_dot(self, x: torch.Tensor):
        y = self.matvec(x)
        return y, conj_dot(x, y)
