"""One Gauss-Seidel colour step on a 3-D grid in the padded DIA layout:
the smoother kernel of :class:`~sprsolve_tpu_torch.multigrid.InjectionMGPrecond`.

The body's first nx·ny·nz rows of a
:class:`~sprsolve_tpu_torch.ops.padded_dia.PaddedDIA` are the points of an
(nx, ny, nz) grid, x-major, z fastest; point (ix, iy, iz) has colour
4·(ix & 1) + 2·(iy & 1) + (iz & 1).  On an operator that couples only
points at most 1 apart in each coordinate (the 27-point stencil), two
points of one colour never couple, so a step over one colour is exact
Gauss-Seidel on its rows:

    z[i] ← z[i] + (r[i] − (A·z)[i]) / a_ii    for the rows i of the colour,

every other row of z left as it is, z updated in place.  ``first`` is the
step from z = 0: z[i] = r[i] / a_ii, no SpMV (the caller has zeroed z).

:func:`color_step` launches ``gs_color_step_kernel`` (``csrc/gs_color.cu``)
for CUDA tensors, one launch a step, and runs :func:`color_step_plain` for
CPU tensors; ``color_step.launches`` counts the launches
(:func:`~sprsolve_tpu_torch.ops.padded_dia.reset_launch_counts` zeroes it).
The kernel's row sum runs over the bands in K1's order with K1's fused
multiply-add, so a row's result does not depend on the launch's grid.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _cuda_build
from .padded_dia import _check, _launch_args, _on_device, dia_spmv_plain

COLORS = 8


def color_extent(grid, color: int) -> Tuple[int, int, int]:
    """The number of points of ``color`` along each axis of ``grid``."""
    if not 0 <= color < COLORS:
        raise ValueError(f"colour {color} outside [0, {COLORS})")
    bits = ((color >> 2) & 1, (color >> 1) & 1, color & 1)
    return tuple((g - c + 1) // 2 for g, c in zip(grid, bits))


def _color_view(v: torch.Tensor, h: int, grid, color: int) -> torch.Tensor:
    """The entries of the padded vector ``v`` at the points of ``color``, as
    a strided (mx, my, mz) view."""
    nx, ny, nz = grid
    g = v[h: h + nx * ny * nz].view(nx, ny, nz)
    cx, cy, cz = (color >> 2) & 1, (color >> 1) & 1, color & 1
    return g[cx::2, cy::2, cz::2]


def color_step_plain(bands: torch.Tensor, z: torch.Tensor, r: torch.Tensor, offsets,
                     h: int, grid, color: int, diag: int, first: bool = False
                     ) -> torch.Tensor:
    """The colour step in plain PyTorch, in place on ``z``: K1's plain SpMV
    over all rows (:func:`~sprsolve_tpu_torch.ops.padded_dia.dia_spmv_plain`,
    the bands in K1's order), then the update on the colour's rows alone.
    Returns ``z``."""
    d = _color_view(torch.nn.functional.pad(bands[diag].to(z.dtype), (h, h)), h, grid, color)
    zc = _color_view(z, h, grid, color)
    rc = _color_view(r, h, grid, color)
    if first:
        zc.copy_(rc / d)
        return z
    az = _color_view(dia_spmv_plain(bands, z, offsets, h), h, grid, color)
    zc.copy_(zc + (rc - az) / d)
    return z


def _check_grid(n_pad: int, grid, color: int, diag: int, nd: int) -> Tuple[int, int, int]:
    grid = tuple(int(g) for g in grid)
    if len(grid) != 3 or min(grid) < 1:
        raise ValueError(f"grid {grid} is not three positive sides")
    if grid[0] * grid[1] * grid[2] > n_pad:
        raise ValueError(f"grid {grid} has more points than the {n_pad} body rows")
    if not 0 <= diag < nd:
        raise ValueError(f"diagonal band {diag} outside the {nd} bands")
    color_extent(grid, color)
    return grid


def color_step(bands: torch.Tensor, z: torch.Tensor, r: torch.Tensor, offsets, h: int,
               grid, color: int, diag: int, first: bool = False) -> torch.Tensor:
    """One Gauss-Seidel step on the rows of ``color`` of ``grid``, in place
    on the padded vector ``z`` (see the module's docstring); ``diag`` is the
    index of the band at offset 0, ``r`` the right-hand side in the same
    layout.  Bands and vectors as K1 takes them (f64 vectors with f64
    bands; f32 with f32, bf16 or int8 bands; at most ``MAX_DIAGS``).
    Returns ``z``.  A colour with no point on the grid changes nothing and
    launches nothing."""
    n_pad = _check((bands,), z, offsets, h, r)
    grid = _check_grid(n_pad, grid, color, diag, len(offsets))
    if z.device.type == "cpu":
        return color_step_plain(bands, z, r, offsets, h, grid, color, diag, first)
    mx, my, mz = color_extent(grid, color)
    if mx * my * mz == 0:
        return z
    lib, codes, offs, stream = _launch_args((bands,), z, offsets)
    err = _on_device(
        z, lib.sprsolve_gs_color_step, *codes, bands.data_ptr(), z.data_ptr(), r.data_ptr(),
        n_pad, h, *grid, int(color), offs, len(offsets), int(diag), int(bool(first)), stream,
    )
    _cuda_build.check(lib, err, "gs_color_step")
    color_step.launches += 1
    return z


color_step.launches = 0
