"""Geometric (aggregation) multigrid V-cycle preconditioner.

Counterpart of ``sprsolve_tpu/multigrid.py``:

- restriction sums the 2×…×2 blocks of the grid view (reshape and sum,
  the grid padded to even sizes first) and prolongation broadcasts and
  crops, exactly adjoint (R = Pᵀ);
- the coarse operators are the Galerkin products PᵀAP of the
  piecewise-constant aggregation, built on the host by relabeling each
  COO entry with its aggregate and summing duplicates;
- the smoother is weighted Jacobi (ω = 2/3), ν₁ = ν₂ = 2 sweeps, the
  coarsest level a dense inverse (pinv when singular) applied as a
  full-precision product, and the prolonged correction is scaled by
  ``coarse_scale`` = 1.8;
- each level's operator comes from ``optimize(..., prefer_kernels=False)``
  (torch ``DIA`` for a banded level), as the JAX package keeps Pallas off
  inside preconditioner applies; a padded level is wrapped in
  :class:`FlatViewOperator`.

With ν₁ = ν₂ and z₀ = 0 the cycle is a symmetric positive linear map for
an SPD A: a stationary preconditioner for every Krylov solver.
``M="amg"`` in :func:`~sprsolve_tpu_torch.solve` runs it on a 1-D
hierarchy over the RCM order.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .utils.timing import span
from .vecalg import conj_dot, full_precision_matmul


def _coarse_grid(grid):
    return tuple(max(1, -(-g // 2)) for g in grid)


def _pad_to_even(a: torch.Tensor, grid) -> torch.Tensor:
    pads = [(-g) % 2 for g in grid]
    if any(pads):
        # F.pad takes the last axis first
        a = F.pad(a, [p for q in reversed(pads) for p in (0, q)])
    return a


def restrict_grid(r: torch.Tensor, grid: Tuple[int, ...]) -> torch.Tensor:
    """Sum over 2×…×2 aggregates: flat (∏grid,) → flat (∏coarse,)."""
    a = _pad_to_even(r.reshape(grid), grid)
    for axis in range(len(grid)):
        shape = a.shape
        a = a.reshape(shape[:axis] + (shape[axis] // 2, 2) + shape[axis + 1:]).sum(dim=axis + 1)
    return a.reshape(-1)


def prolong_grid(z: torch.Tensor, grid: Tuple[int, ...]) -> torch.Tensor:
    """Adjoint of :func:`restrict_grid`: each aggregate value onto its
    2×…×2 fine block, cropped to the fine grid."""
    a = z.reshape(_coarse_grid(grid))
    for axis in range(len(grid)):
        a = torch.repeat_interleave(a, 2, dim=axis)
    return a[tuple(slice(0, g) for g in grid)].reshape(-1)


def _aggregate_map(grid, coarse) -> np.ndarray:
    """(n,) flat row-major fine index → flat coarse index of its aggregate."""
    agg = np.zeros((1,) * len(grid), np.int64)
    for ax in range(len(grid)):
        stride = int(np.prod(coarse[ax + 1:], dtype=np.int64))
        shape = [1] * len(grid)
        shape[ax] = grid[ax]
        agg = agg + ((np.arange(grid[ax], dtype=np.int64) >> 1) * stride).reshape(shape)
    return agg.reshape(-1)


def _galerkin_coarse(csr, grid):
    """PᵀAP by COO relabeling (piecewise-constant aggregation P), on the
    host; scipy's coo→csr sums the duplicates."""
    import scipy.sparse as sps

    from .sparse.containers import CSR, _host

    coarse = _coarse_grid(grid)
    agg = _aggregate_map(grid, coarse)
    crow = agg[_host(csr.row_ids).astype(np.int64)]
    ccol = agg[_host(csr.indices).astype(np.int64)]
    nc = int(np.prod(coarse))
    Ac = sps.csr_matrix((_host(csr.data), (crow, ccol)), shape=(nc, nc))
    return CSR.from_arrays(Ac.data, Ac.indices, Ac.indptr, (nc, nc)), coarse


@dataclasses.dataclass(frozen=True)
class GridMGPrecond:
    """V-cycle on a structured grid hierarchy. Build with :meth:`from_csr`."""

    ops: tuple            # per-level operators, fine → coarse
    dinvs: tuple          # per-level 1/diag tensors
    coarse_inv: torch.Tensor   # dense inverse of the coarsest Galerkin operator
    grids: tuple          # per-level grid shapes
    nu1: int = 2
    nu2: int = 2
    omega: float = 2.0 / 3.0
    coarse_scale: float = 1.8

    @property
    def shape(self):
        return self.ops[0].shape if self.ops else tuple(self.coarse_inv.shape)

    @property
    def device(self) -> torch.device:
        return self.coarse_inv.device

    @staticmethod
    def from_csr(
        A,
        grid: Tuple[int, ...],
        *,
        nu1: int = 2,
        nu2: int = 2,
        omega: float = 2.0 / 3.0,
        coarse_scale: float = 1.8,
        coarse_max: int = 512,
        max_levels: int = 12,
        device=None,
        **layout_kwargs,
    ) -> "GridMGPrecond":
        """Build the hierarchy from a CSR whose rows are the points of
        ``grid`` (row-major), on ``device`` (default: the CUDA device).
        ``layout_kwargs`` go to :func:`~sprsolve_tpu_torch.optimize` for each
        level's operator (default ``prefer_kernels=False``)."""
        from .errors import IncompatibleMatrixFormat
        from .ops.optimize import default_device, optimize
        from .sparse.containers import _host

        device = default_device(device)
        n = int(np.prod(grid))
        if A.shape[0] != n:
            raise IncompatibleMatrixFormat(
                f"grid {grid} has {n} points but A is {A.shape[0]}×{A.shape[1]}"
            )
        layout_kwargs.setdefault("prefer_kernels", False)

        ops, dinvs, grids = [], [], []
        csr, g = A, tuple(int(x) for x in grid)
        for _ in range(max_levels):
            if csr.shape[0] <= coarse_max or all(x == 1 for x in g):
                break
            diag = csr.diagonal_host()
            lvl_op = optimize(csr, device=device, **layout_kwargs)
            if hasattr(lvl_op, "pad_vec"):
                lvl_op = FlatViewOperator(op=lvl_op)
            ops.append(lvl_op)
            dinvs.append(torch.as_tensor(np.where(diag == 0, 1.0, 1.0 / diag), device=device))
            grids.append(g)
            csr, g = _galerkin_coarse(csr, g)
        rows = _host(csr.row_ids)
        dense = np.zeros(csr.shape, dtype=_host(csr.data).dtype)
        np.add.at(dense, (rows, _host(csr.indices)), _host(csr.data))
        try:
            cinv = np.linalg.inv(dense)
        except np.linalg.LinAlgError:
            cinv = np.linalg.pinv(dense)
        return GridMGPrecond(
            ops=tuple(ops), dinvs=tuple(dinvs),
            coarse_inv=torch.as_tensor(cinv.astype(_host(A.data).dtype), device=device),
            grids=tuple(grids), nu1=int(nu1), nu2=int(nu2), omega=float(omega),
            coarse_scale=float(coarse_scale))

    def _smooth(self, lvl, r, z, sweeps, skip_first_matvec):
        om = self.omega     # a Python scalar: rounded to the vectors' dtype
        for s in range(sweeps):
            if s == 0 and skip_first_matvec:
                z = om * self.dinvs[lvl] * r    # z = 0 ⇒ A·z = 0
            else:
                z = z + om * self.dinvs[lvl] * (r - self.ops[lvl].matvec(z))
        return z

    def _cycle(self, lvl, r):
        if lvl == len(self.ops):
            return full_precision_matmul(self.coarse_inv.to(r.dtype), r)
        z = self._smooth(lvl, r, None, self.nu1, skip_first_matvec=True)
        res = r - self.ops[lvl].matvec(z)
        zc = self._cycle(lvl + 1, restrict_grid(res, self.grids[lvl]))
        z = z + self.coarse_scale * prolong_grid(zc, self.grids[lvl]).to(r.dtype)
        return self._smooth(lvl, r, z, self.nu2, skip_first_matvec=False)

    def matvec(self, r: torch.Tensor) -> torch.Tensor:
        with span("precond"):
            return self._cycle(0, r)

    def matvec_dot(self, r: torch.Tensor):
        z = self.matvec(r)
        return z, conj_dot(r, z)


@dataclasses.dataclass(frozen=True)
class FlatViewOperator:
    """Flat-vector view of a padded-layout operator: each apply pads x,
    runs the operator's SpMV (kernel K1 on a ``PaddedDIA``) and unpads the
    result, two vector passes besides the SpMV. :meth:`matmat` does the same
    for an (n, m) block: one K1b launch on a ``PaddedDIA``, one matvec per
    column on an operator without a block apply."""

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

    def matmat(self, X: torch.Tensor) -> torch.Tensor:
        if hasattr(self.op, "matmat") and hasattr(self.op, "pad_block"):
            return self.op.unpad_block(self.op.matmat(self.op.pad_block(X)))
        return torch.stack([self.matvec(X[:, j]) for j in range(X.shape[1])], dim=1)
