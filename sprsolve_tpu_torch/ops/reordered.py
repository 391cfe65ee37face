"""Reordered operator: solve P·A·Pᵀ in a fast layout, permute at the edges.

Counterpart of ``sprsolve_tpu/ops/reordered.py:21-108``: when a matrix is
banded after RCM, ``optimize()`` wraps the banded operator in
:class:`Reordered`, so the caller still sees the original order.  The
permutations run once per solve, at the vector boundary (``pad_vec``/
``unpad_vec``), never inside the iteration.

It forwards what the JAX class forwards and nothing more: ``matvec``,
``matvec_dot``, ``jacobi_precond``, ``relay_diag_precond``, ``diagonal``,
``pad_vec`` and ``unpad_vec``.  A solver on a ``Reordered(PaddedDIA)`` so
runs kernel K1 for each SpMV and K3 for each ``matvec_dot``; the fused
BiCGStab and Lanczos steps (K2, K4) compose from K1 and separate dots.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Reordered:
    """An operator built from A' = A[perm, perm].

    ``pad_vec`` maps an original-order vector into the inner layout
    (permute, then the inner pad); ``unpad_vec`` inverts it.  Inside the
    solve every vector is in the permuted (and inner) layout."""

    inner: object
    perm: torch.Tensor       # (n,) int64: permuted row i is original row perm[i]
    inv_perm: torch.Tensor   # (n,) int64, the inverse

    @staticmethod
    def wrap(inner, perm) -> "Reordered":
        """Wrap ``inner`` with the permutation ``perm`` (array-like), on the
        inner operator's device."""
        perm = np.asarray(perm, dtype=np.int64)
        inv = np.empty_like(perm)
        inv[perm] = np.arange(len(perm))
        dev = getattr(inner, "device", None)
        return Reordered(inner=inner, perm=torch.as_tensor(perm, device=dev),
                         inv_perm=torch.as_tensor(inv, device=dev))

    @property
    def shape(self):
        return self.inner.shape

    @property
    def n(self) -> int:
        return self.inner.shape[0]

    @property
    def dtype(self):
        return self.inner.dtype

    @property
    def device(self) -> torch.device:
        return self.perm.device

    @property
    def padded_len(self) -> int:
        """Length of a vector in the inner layout."""
        return self.inner.padded_len if hasattr(self.inner, "pad_vec") else self.n

    def pad_vec(self, x: torch.Tensor) -> torch.Tensor:
        xp = torch.as_tensor(x, device=self.device)[self.perm]
        return self.inner.pad_vec(xp) if hasattr(self.inner, "pad_vec") else xp

    def unpad_vec(self, x2: torch.Tensor) -> torch.Tensor:
        x = self.inner.unpad_vec(x2) if hasattr(self.inner, "pad_vec") else x2
        return x[self.inv_perm]

    def matvec(self, x2: torch.Tensor) -> torch.Tensor:
        return self.inner.matvec(x2)

    def matvec_dot(self, x2: torch.Tensor):
        return self.inner.matvec_dot(x2)

    def jacobi_precond(self):
        """The inner operator's Jacobi, or one from its diagonal (zero → 1)
        for an inner operator without it, in the permuted layout."""
        if hasattr(self.inner, "jacobi_precond"):
            return self.inner.jacobi_precond()
        from ..precond import DiagPrecond

        d = self.inner.diagonal()
        one = torch.ones((), dtype=d.dtype, device=d.device)
        return DiagPrecond(diag_inv=one / torch.where(d == 0, one, d))

    def relay_diag_precond(self, M):
        """Permute a flat diagonal preconditioner with the rows, then re-lay
        it for the inner operator where that has a layout of its own."""
        Mp = type(M)(diag_inv=M.diag_inv.to(self.device)[self.perm])
        if hasattr(self.inner, "relay_diag_precond"):
            return self.inner.relay_diag_precond(Mp)
        return Mp

    def diagonal(self) -> torch.Tensor:
        """The diagonal in the ORIGINAL order."""
        return self.inner.diagonal()[self.inv_perm]
