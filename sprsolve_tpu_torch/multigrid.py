"""Multigrid V-cycle preconditioners: the geometric (aggregation) one of the
JAX package, and HPCG's (:class:`InjectionMGPrecond`, at the end).

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


# --- HPCG's V-cycle: generated levels, injection, colour Gauss-Seidel -------
def halved(grid) -> Tuple[int, ...]:
    """HPCG's coarse grid (``GenerateCoarseProblem``): each side halved, the
    coarse point i on the fine point 2i. An odd side keeps its last point,
    ⌈n/2⌉ (HPCG itself takes even sides only)."""
    return tuple((int(g) + 1) // 2 for g in grid)


def _check_couplings(op, grid) -> None:
    """Raise unless every nonzero of the padded operator ``op`` couples
    points of ``grid`` at most 1 apart in each coordinate (the 27-point
    pattern, or inside it), so that the parity colours never couple; and
    unless the diagonal is nonzero on every row. Runs where the bands are."""
    from .errors import IncompatibleMatrixFormat, ZeroDiagonalElem

    nx, ny, nz = grid
    n = nx * ny * nz
    if 0 not in op.offsets or bool((op.bands[op.offsets.index(0), :n] == 0).any()):
        raise ZeroDiagonalElem("a multigrid level has a zero on its diagonal")
    i = torch.arange(n, device=op.device)
    coords = lambda k: (k // (ny * nz), (k // nz) % ny, k % nz)
    ci = coords(i)
    for d, off in enumerate(op.offsets):
        j = i + off
        cj = coords(j.clamp(0, n - 1))
        far = (j < 0) | (j >= n)
        for a, b in zip(ci, cj):
            far |= (a - b).abs() > 1
        if bool((far & (op.bands[d, :n] != 0)).any()):
            raise IncompatibleMatrixFormat(
                f"offset {off} couples points of the grid {tuple(grid)} more than 1 "
                "apart: the parity colours of a Gauss-Seidel step would couple")


def _grid_view(v: torch.Tensor, h: int, grid) -> torch.Tensor:
    """The body of the padded vector ``v`` as a (nx, ny, nz) view."""
    return v[h: h + grid[0] * grid[1] * grid[2]].view(*grid)


def _injected(v: torch.Tensor, h: int, grid) -> torch.Tensor:
    """The entries of ``v`` at the fine points (2i, 2j, 2k), a strided view."""
    return _grid_view(v, h, grid)[::2, ::2, ::2]


@dataclasses.dataclass(frozen=True)
class InjectionMGPrecond:
    """HPCG's multigrid V-cycle (HPCG 3.1 ``ComputeMG``) on the kernels'
    padded layout. Build with :meth:`from_levels`.

    - the levels are the caller's operators on grids whose sides halve
      (:func:`halved`), each generated, not a Galerkin product, each a
      :class:`~sprsolve_tpu_torch.ops.padded_dia.PaddedDIA`;
    - restriction by injection: r_c = (r − A·z) at the fine points
      (2i, 2j, 2k) (A·z one K1); prolongation z[2i, 2j, 2k] += z_c, its
      transpose;
    - the smoother is symmetric Gauss-Seidel in the 8 parity colours
      (:mod:`~sprsolve_tpu_torch.ops.gs_color`, one hand-kernel launch a
      colour step): the colours forward, then backward, the last colour
      once (15 steps); one SymGS before the coarse correction and one after
      it, as HPCG fixes them, one SymGS alone on the coarsest level, no
      coarse solve and no correction scale. The first step from z = 0 skips its
      SpMV. A colour with no point on a level's grid is left out.

    With the colours in a palindrome and R = Pᵀ the cycle is a symmetric
    linear map for a symmetric A, so CG takes it. ``A`` is the finest
    level: :func:`~sprsolve_tpu_torch.prepare` on that operator uses the
    cycle as it is (``M.A is op``); it takes vectors in that level's padded
    layout, or flat ones (then padded and unpadded around the cycle)."""

    ops: tuple            # per-level PaddedDIA, fine → coarse
    grids: tuple          # per-level (nx, ny, nz)
    diags: tuple          # per-level index of the band at offset 0
    orders: tuple         # per-level colour order of one SymGS

    @property
    def A(self):
        return self.ops[0]

    @property
    def shape(self):
        return self.ops[0].shape

    @property
    def device(self) -> torch.device:
        return self.ops[0].device

    @staticmethod
    def from_levels(levels, grids, *, device=None) -> "InjectionMGPrecond":
        """The cycle on ``levels``, fine first: each a CSR, laid out by
        :func:`~sprsolve_tpu_torch.optimize` on ``device`` (default: the
        CUDA device), or an operator already laid out, used as it is. ``grids[l]`` is level l's (nx, ny, nz), its rows x-major with z
        fastest, and ``grids[l + 1]`` must be ``halved(grids[l])``. Raises
        ValueError for grids that do not halve or a count of grids that
        differs from the levels',
        :class:`~sprsolve_tpu_torch.errors.IncompatibleMatrixFormat` for a
        level that is no ``PaddedDIA`` of its grid's size and the first
        level's dtype or that couples points more than 1 apart, and
        :class:`~sprsolve_tpu_torch.errors.ZeroDiagonalElem` for a zero on
        a diagonal."""
        from .errors import IncompatibleMatrixFormat
        from .ops.gs_color import COLORS, color_extent
        from .ops.optimize import default_device, optimize
        from .ops.padded_dia import PaddedDIA
        from .sparse.containers import CSR

        levels, grids = list(levels), [tuple(int(g) for g in grid) for grid in grids]
        if not levels or len(levels) != len(grids):
            raise ValueError(f"{len(levels)} levels and {len(grids)} grids")
        if any(len(g) != 3 or min(g) < 1 for g in grids):
            raise ValueError(f"grids {grids}: each must be three positive sides")
        for fine, coarse in zip(grids, grids[1:]):
            if coarse != halved(fine):
                raise ValueError(f"grid {coarse} is not {fine} halved ({halved(fine)})")
        device = default_device(device)
        ops = []
        for lvl, grid in zip(levels, grids):
            op = optimize(lvl, device=device) if isinstance(lvl, CSR) else lvl
            if not isinstance(op, PaddedDIA):
                raise IncompatibleMatrixFormat(
                    f"a level laid out as {type(op).__name__}; the colour steps take a "
                    "PaddedDIA (at most 32 diagonals, f32 or f64)")
            if op.n != grid[0] * grid[1] * grid[2] or op.shape[0] != op.shape[1]:
                raise IncompatibleMatrixFormat(
                    f"a level of shape {op.shape} on the grid {grid}")
            if ops and (op.vdtype != ops[0].vdtype or op.device != ops[0].device):
                raise IncompatibleMatrixFormat("the levels differ in dtype or device")
            _check_couplings(op, grid)
            ops.append(op)
        orders = []
        for grid in grids:
            fwd = tuple(c for c in range(COLORS) if min(color_extent(grid, c)) > 0)
            orders.append(fwd + fwd[::-1][1:])   # a repeat of the last changes nothing
        return InjectionMGPrecond(
            ops=tuple(ops), grids=tuple(grids),
            diags=tuple(op.offsets.index(0) for op in ops), orders=tuple(orders))

    def steps_per_apply(self) -> Tuple[int, ...]:
        """The colour steps (kernel launches) one apply runs on each level:
        two SymGS on each level but the coarsest, one there."""
        last = len(self.ops) - 1
        return tuple(len(order) * (1 if lvl == last else 2)
                     for lvl, order in enumerate(self.orders))

    def _symgs(self, lvl: int, z: torch.Tensor, r: torch.Tensor, zero: bool) -> None:
        from .ops.gs_color import color_step

        op = self.ops[lvl]
        for k, color in enumerate(self.orders[lvl]):
            color_step(op.bands, z, r, op.offsets, op.h, self.grids[lvl], color,
                       self.diags[lvl], first=zero and k == 0)

    def _cycle(self, lvl: int, r: torch.Tensor) -> torch.Tensor:
        op, grid = self.ops[lvl], self.grids[lvl]
        z = torch.zeros_like(r)
        if lvl == len(self.ops) - 1:
            with span("mg_smooth"):
                self._symgs(lvl, z, r, zero=True)
            return z
        with span("mg_smooth"):
            self._symgs(lvl, z, r, zero=True)
        cop, cgrid = self.ops[lvl + 1], self.grids[lvl + 1]
        with span("mg_transfer"):
            rc = torch.zeros(cop.padded_len, dtype=r.dtype, device=r.device)
            torch.sub(_injected(r, op.h, grid), _injected(op.matvec(z), op.h, grid),
                      out=_grid_view(rc, cop.h, cgrid))
        zc = self._cycle(lvl + 1, rc)
        with span("mg_transfer"):
            _injected(z, op.h, grid).add_(_grid_view(zc, cop.h, cgrid))
        with span("mg_smooth"):
            self._symgs(lvl, z, r, zero=False)
        return z

    def matvec(self, r: torch.Tensor) -> torch.Tensor:
        with span("precond"):
            op = self.ops[0]
            if r.shape[0] == op.padded_len:
                return self._cycle(0, r)
            return op.unpad_vec(self._cycle(0, op.pad_vec(r)))

    def matvec_dot(self, r: torch.Tensor):
        z = self.matvec(r)
        return z, conj_dot(r, z)
