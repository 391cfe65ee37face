"""Plain reference of the 7-point stencil operator: A·x on the 3-D grid by
shifted slices, in whatever dtype ``x`` has (float64 or complex128 for the
check).  It reads only the configuration's stencil definition: nothing of
the program, and not the CSR the benchmark hands the program.
"""

from __future__ import annotations

import torch


def diagonal(cfg: dict) -> complex:
    """The centre coefficient, ``diagonal`` + i·``diagonal_imag``."""
    return complex(cfg["diagonal"], cfg.get("diagonal_imag", 0.0))


def is_complex(cfg: dict) -> bool:
    return cfg.get("diagonal_imag", 0.0) != 0.0 or cfg["dtype"].startswith("complex")


def matvec(cfg: dict, x: torch.Tensor) -> torch.Tensor:
    """y = A·x for a flat ``x`` of the grid's size (x-major, z fastest),
    Dirichlet boundaries: a neighbour outside the grid contributes nothing."""
    nx, ny, nz = (int(v) for v in cfg["grid"])
    g = x.reshape(nx, ny, nz)
    d = diagonal(cfg)
    y = g * (d if x.is_complex() else d.real)
    c = cfg["neighbour"]
    y[1:, :, :] += c * g[:-1, :, :]
    y[:-1, :, :] += c * g[1:, :, :]
    y[:, 1:, :] += c * g[:, :-1, :]
    y[:, :-1, :] += c * g[:, 1:, :]
    y[:, :, 1:] += c * g[:, :, :-1]
    y[:, :, :-1] += c * g[:, :, 1:]
    return y.reshape(-1)
