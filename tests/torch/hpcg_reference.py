"""Plain reference of HPCG's problem and preconditioner, in plain PyTorch.

HPCG 3.1 (hpcg-benchmark.org; Dongarra, Heroux & Luszczek, SAND2013-8752):
``GenerateProblem``'s 27-point operator on an (nx, ny, nz) grid, ``diagonal``
(26) on the diagonal and ``neighbour`` (−1) to every neighbour inside the
grid (Dirichlet elimination); ``ComputeMG``'s V-cycle over levels that
``GenerateCoarseProblem`` makes by halving each side and generating the
same stencil again; restriction by injection, r_c = (r − A·z) at the fine
point (2i, 2j, 2k); prolongation z[2i, 2j, 2k] += z_c; one ``ComputeSYMGS``
before the coarse correction and one after it, and one alone on the
coarsest level; and CG preconditioned by that cycle.

Vectors are 3-D arrays in x-major order, z fastest (the flat order of the
benchmark's CSR).  A smoother's iterate lives in an array with a frame of
zeros one point wide, so every stencil is 27 shifted slices and Dirichlet
elimination is the frame.  Nothing here comes from the program under test:
no kernel, no padded layout, no CSR.

Departures from HPCG's reference code:

- the Gauss-Seidel sweeps visit the points by parity colour (colour
  4·(ix & 1) + 2·(iy & 1) + (iz & 1)), forward 0..7 and then backward
  6..0, where HPCG sweeps lexicographically forward and then backward;
  points of one colour never couple, so each colour is one masked update;
- a colour update is z + (r − A·z)/a_ii at its points, HPCG's
  (r − Σ_{j≠i} a_ij·z_j)/a_ii: the same number up to rounding;
- an odd side keeps its last point when halved (⌈n/2⌉), where HPCG
  takes even sides only;
- CG starts from x = 0 and stops when ‖r‖ ≤ tol·‖b‖ at the top of an
  iteration, or after ``max_iter``; HPCG runs sets of 50 iterations at
  tolerance 0, on b = A·1;
- ``storage`` rounds every vector of the cycle and of CG to that type after
  each operation, with the arithmetic in the vectors' own type: the solve
  that keeps its vectors in a lower precision (a control, not HPCG).

The benchmark keeps a copy of this file as ``solvebench/reference/stencil27.py``
(its ``matvec(cfg, x)`` judges the answers); the two are the same bytes.
"""

from __future__ import annotations

import itertools
from typing import NamedTuple, Optional, Tuple

import torch

# the 26 neighbours' shifts, in x, y, z order
SHIFTS = [s for s in itertools.product((-1, 0, 1), repeat=3) if s != (0, 0, 0)]
COLORS = 8


class Info(NamedTuple):
    iterations: int
    converged: bool


def coefficients(cfg: dict) -> Tuple[float, float]:
    """(diagonal, neighbour) of a configuration; HPCG's are (26, −1)."""
    return float(cfg.get("diagonal", 26.0)), float(cfg.get("neighbour", -1.0))


def halved(grid) -> Tuple[int, ...]:
    return tuple((int(g) + 1) // 2 for g in grid)


def level_grids(grid, levels: int):
    grids = [tuple(int(g) for g in grid)]
    for _ in range(levels - 1):
        grids.append(halved(grids[-1]))
    return grids


def rounded(v: torch.Tensor, storage: Optional[torch.dtype]) -> torch.Tensor:
    return v if storage is None else v.to(storage).to(v.dtype)


def framed(x3: torch.Tensor) -> torch.Tensor:
    """``x3`` inside a frame of zeros one point wide."""
    return torch.nn.functional.pad(x3, (1, 1, 1, 1, 1, 1))


def stencil(xp: torch.Tensor, d: float, c: float) -> torch.Tensor:
    """A·x on the grid for a framed ``xp``: d·x + c·Σ of the 26 shifts."""
    nx, ny, nz = (s - 2 for s in xp.shape)
    acc = torch.zeros((nx, ny, nz), dtype=xp.dtype, device=xp.device)
    for dx, dy, dz in SHIFTS:
        acc += xp[1 + dx: 1 + dx + nx, 1 + dy: 1 + dy + ny, 1 + dz: 1 + dz + nz]
    return d * xp[1:-1, 1:-1, 1:-1] + c * acc


def matvec(cfg: dict, x: torch.Tensor) -> torch.Tensor:
    """y = A·x for a flat ``x`` of the configuration's grid, in x's dtype."""
    d, c = coefficients(cfg)
    grid = tuple(int(g) for g in cfg["grid"])
    return stencil(framed(x.reshape(grid)), d, c).reshape(-1)


def color_points(xp: torch.Tensor, color: int, shift=(0, 0, 0)) -> torch.Tensor:
    """The framed ``xp`` at the points of ``color`` moved by ``shift``: a
    strided view."""
    bits = ((color >> 2) & 1, (color >> 1) & 1, color & 1)
    n = [s - 2 for s in xp.shape]
    return xp[tuple(slice(1 + b + s, 1 + s + m, 2) for b, s, m in zip(bits, shift, n))]


def color_step(zp: torch.Tensor, r3: torch.Tensor, d: float, c: float, color: int,
               first: bool = False, storage=None) -> None:
    """One Gauss-Seidel update of the points of ``color``, in place on the
    framed iterate ``zp``: z ← z + (r − A·z)/d there, or z = r/d when z is
    0 (``first``)."""
    zc = color_points(zp, color)
    rc = color_points(framed(r3), color)
    if first:
        zc.copy_(rounded(rc / d, storage))
        return
    acc = torch.zeros_like(zc)
    for s in SHIFTS:
        acc += color_points(zp, color, s)
    zc.copy_(rounded(zc + (rc - (d * zc + c * acc)) / d, storage))


def symgs(zp: torch.Tensor, r3: torch.Tensor, d: float, c: float, zero: bool,
          storage=None) -> None:
    """One symmetric sweep: colours 0..7, then 6..0."""
    order = list(range(COLORS)) + list(range(COLORS - 2, -1, -1))
    for k, color in enumerate(order):
        color_step(zp, r3, d, c, color, first=zero and k == 0, storage=storage)


def vcycle(r3: torch.Tensor, d: float, c: float, levels: int, storage=None) -> torch.Tensor:
    """z = M·r for a 3-D ``r3``: HPCG's ``ComputeMG`` from z = 0, one SymGS
    before the coarse correction and one after it."""
    zp = framed(torch.zeros_like(r3))
    if levels == 1:
        symgs(zp, r3, d, c, zero=True, storage=storage)
        return zp[1:-1, 1:-1, 1:-1].clone()
    symgs(zp, r3, d, c, zero=True, storage=storage)
    rc = rounded((r3 - stencil(zp, d, c))[::2, ::2, ::2].contiguous(), storage)
    zc = vcycle(rc, d, c, levels - 1, storage)
    z = zp[1:-1, 1:-1, 1:-1]
    z[::2, ::2, ::2] = rounded(z[::2, ::2, ::2] + zc, storage)
    symgs(zp, r3, d, c, zero=False, storage=storage)
    return zp[1:-1, 1:-1, 1:-1].clone()


def mg_apply(cfg: dict, r: torch.Tensor, levels: int, storage=None) -> torch.Tensor:
    """M·r for a flat ``r`` of the configuration's grid."""
    d, c = coefficients(cfg)
    grid = tuple(int(g) for g in cfg["grid"])
    return vcycle(r.reshape(grid), d, c, levels, storage).reshape(-1)


def pcg(cfg: dict, b: torch.Tensor, *, tol: float, max_iter: int, levels: int,
        storage: Optional[torch.dtype] = None):
    """``(x, Info)``: CG preconditioned by :func:`mg_apply` from x = 0 until
    ‖r‖ ≤ tol·‖b‖ by the recurrence, or ``max_iter`` steps, on a flat b."""
    q = lambda v: rounded(v, storage)
    M = lambda v: mg_apply(cfg, v, levels, storage)
    x = torch.zeros_like(b)
    r = q(b.clone())
    z = q(M(r))
    p = z
    rz = (r * z).sum()
    limit = tol * float(torch.linalg.vector_norm(b))
    its = 0
    while its < max_iter and float(torch.linalg.vector_norm(r)) > limit:
        ap = q(matvec(cfg, p))
        alpha = rz / (p * ap).sum()
        x = q(x + alpha * p)
        r = q(r - alpha * ap)
        z = q(M(r))
        rz_next = (r * z).sum()
        p = q(z + (rz_next / rz) * p)
        rz = rz_next
        its += 1
    return x, Info(its, float(torch.linalg.vector_norm(r)) <= limit)
