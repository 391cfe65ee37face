"""Least bytes of the multigrid V-cycle's Gauss-Seidel colour steps
(``gs_color_step_kernel``, the smoother of HPCG's cycle), from the fine
operator's geometry: the work, not an implementation's traffic.

A colour step on a level of n rows with nd bands updates the m rows of its
colour: it reads their band rows, all of z once (the neighbours) and their
rows of r, and writes their rows of z, nd·b·m + v·(n + 2·m) bytes for
bands of b bytes and vectors of v (37·n in f64 with 27 bands and m = n/8).
The first step of a level starts from z = 0 and reads its colour's
diagonal and r and writes its z: (b + 2·v)·m.

HPCG's cycle is fixed (``ComputeMG``): one symmetric Gauss-Seidel sweep
before the coarse correction and one after it on each level but the
coarsest, one there; a sweep visits the parity colours that have a point
on the level's grid forward and then backward, the last once.  Each level
makes exactly one first step an apply, so the launches name the level
count; a launch's name says whether it is a first step (the template flag
``FIRST``) but not its level, so :func:`apply_bytes` sums one apply over
the levels.  The fine grid is the cube whose padded rows are the
geometry's ``n_pad`` (the summary carries no grid: another grid reads
None), each coarser one the finer halved, ⌈n/2⌉ a side.
"""

from __future__ import annotations

import itertools
import re
from typing import List, Optional, Tuple

FAMILY = "gs_color_step_kernel"
ROW_TILE = 256   # the padded layout's n_pad is a multiple of it
_ANON = "(anonymous namespace)::"

Grid = Tuple[int, int, int]


def parse(name: str) -> Optional[bool]:
    """The ``FIRST`` flag of a colour-step launch named as the profiler
    names it (demangled, ``void (anonymous namespace)::gs_color_step_kernel<
    double, double, false>(...)``, or mangled), else None."""
    if name.startswith("_Z"):
        at = name.find(f"{len(FAMILY)}{FAMILY}I")
        if at < 0:
            return None
        flags = re.findall(r"Lb([01])E", name[at:])
        return flags[0] == "1" if flags else None
    head = name.replace(_ANON, "").split("(", 1)[0].strip()
    m = re.search(r"(\w+)\s*<([^<>]*)>\s*$", head)
    if not m or m.group(1) != FAMILY:
        return None
    last = m.group(2).split(",")[-1].strip()
    return {"true": True, "false": False}.get(last)


def cube_grid(n_pad: int) -> Optional[Grid]:
    """The cube (s, s, s) whose rows padded to the layout's tile are
    ``n_pad``, or None."""
    s = round(n_pad ** (1 / 3))
    for side in (s - 1, s, s + 1):
        if side > 0 and max(-(-side ** 3 // ROW_TILE) * ROW_TILE, ROW_TILE) == n_pad:
            return (side, side, side)
    return None


def level_grids(grid: Grid, levels: int) -> List[Grid]:
    """The grids of ``levels`` levels from the fine ``grid``, each side
    halved, ⌈n/2⌉, a level down."""
    out = [tuple(grid)]
    for _ in range(levels - 1):
        out.append(tuple((g + 1) // 2 for g in out[-1]))
    return out


def color_rows(grid: Grid) -> List[int]:
    """The rows of each parity colour that has a point on ``grid``, in
    colour order."""
    rows = []
    for bits in itertools.product((0, 1), repeat=3):
        m = 1
        for g, b in zip(grid, bits):
            m *= (g - b + 1) // 2
        if m:
            rows.append(m)
    return rows


def sweep(grid: Grid) -> List[int]:
    """The colours' rows of one symmetric sweep's steps, in order."""
    fwd = color_rows(grid)
    return fwd + fwd[::-1][1:]


def apply_steps(grid: Grid, levels: int) -> List[List[int]]:
    """The colour rows of each step of one apply, by level."""
    grids = level_grids(grid, levels)
    return [sweep(g) * (1 if lvl == levels - 1 else 2) for lvl, g in enumerate(grids)]


def apply_bytes(g, levels: int) -> Optional[float]:
    """Least bytes of one apply's colour steps with ``levels`` levels on the
    fine geometry ``g`` (``byte_models.Geometry``), or None where the fine
    grid is no cube."""
    grid = cube_grid(g.n_pad)
    if grid is None:
        return None
    (band,) = g.band_itemsizes
    v = g.vec_itemsize
    total = 0.0
    for lvl_grid, steps in zip(level_grids(grid, levels), apply_steps(grid, levels)):
        n = lvl_grid[0] * lvl_grid[1] * lvl_grid[2]
        total += (band + 2 * v) * steps[0]
        total += sum(g.nd * band * m + v * (n + 2 * m) for m in steps[1:])
    return total


def apply_launches(g, levels: int) -> Optional[int]:
    """The colour-step launches of one apply, or None where the fine grid is
    no cube."""
    grid = cube_grid(g.n_pad)
    if grid is None:
        return None
    return sum(len(steps) for steps in apply_steps(grid, levels))
