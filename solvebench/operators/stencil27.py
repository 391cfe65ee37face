"""HPCG's 27-point stencil (HPCG 3.1 ``GenerateProblem``) on the interior
unknowns of a 3-D grid, as the CSR arrays a user hands to ``prepare()``.

Rows are grid points in x-major order (z fastest); each row holds, in
ascending column order, the entries of the 26 neighbours and the centre
that lie inside the grid (Dirichlet elimination): ``diagonal`` on the
centre, ``neighbour`` elsewhere.  Built in one vectorised pass, already
sorted, with no per-row work.

The operator is (``diagonal`` − ``neighbour``)·I + ``neighbour``·K⊗K⊗K with
K = tridiag(1, 1, 1) on each axis, so its orthonormal eigenvectors are the
7-point stencil's, the products of the axes' sine vectors:
:func:`eigenbasis` is :func:`solvebench.operators.stencil7.eigenbasis`.
"""

from __future__ import annotations

import itertools

import numpy as np

from solvebench.operators.stencil7 import DTYPES, eigenbasis  # noqa: F401

# the 27 shifts in (x, y, z) order: ascending columns within a row
SHIFTS = list(itertools.product((-1, 0, 1), repeat=3))
CENTRE = SHIFTS.index((0, 0, 0))


def csr_arrays(cfg: dict):
    """``(data, indices, indptr, shape)`` of the configuration's operator:
    int64 indices and indptr, ``data`` in the configuration's dtype."""
    nx, ny, nz = (int(v) for v in cfg["grid"])
    dtype = DTYPES[cfg["dtype"]]
    n = nx * ny * nz

    def inside(side):
        """(side, 3): whether the shift −1, 0, +1 stays inside this axis."""
        k = np.arange(side)
        return np.stack([k > 0, np.ones(side, dtype=bool), k < side - 1], axis=1)

    vx, vy, vz = inside(nx), inside(ny), inside(nz)
    valid = (vx[:, None, None, :, None, None] & vy[None, :, None, None, :, None]
             & vz[None, None, :, None, None, :]).reshape(n, 27)
    del vx, vy, vz
    counts = valid.sum(axis=1)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    del counts
    offsets = np.array([(dx * ny + dy) * nz + dz for dx, dy, dz in SHIFTS], dtype=np.int64)
    indices = (np.arange(n, dtype=np.int64)[:, None] + offsets[None, :])[valid]
    row_vals = np.full(27, cfg["neighbour"], dtype=dtype)
    row_vals[CENTRE] = cfg["diagonal"]
    data = np.broadcast_to(row_vals, (n, 27))[valid]
    return data, indices, indptr, (n, n)
