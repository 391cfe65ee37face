"""The 7-point stencil on the interior unknowns of a 3-D grid, as the CSR
arrays a user hands to ``prepare()``.

Rows are grid points in x-major order (z fastest); each row holds, in
ascending column order, the −x, −y, −z, centre, +z, +y, +x entries that lie
inside the grid (Dirichlet elimination).  The centre is ``diagonal`` +
i·``diagonal_imag``, each neighbour ``neighbour``.  Built in one vectorised
pass, already sorted, with no per-row work.
"""

from __future__ import annotations

import numpy as np

DTYPES = {"float32": np.float32, "float64": np.float64,
          "complex64": np.complex64, "complex128": np.complex128}


def csr_arrays(cfg: dict):
    """``(data, indices, indptr, shape)`` of the configuration's operator:
    int64 indices and indptr, ``data`` in the configuration's dtype."""
    nx, ny, nz = (int(v) for v in cfg["grid"])
    dtype = DTYPES[cfg["dtype"]]
    n = nx * ny * nz
    idx = np.arange(n, dtype=np.int64)
    iz = idx % nz
    iy = (idx // nz) % ny
    ix = idx // (nz * ny)
    offsets = np.array([-nz * ny, -nz, -1, 0, 1, nz, nz * ny], dtype=np.int64)
    valid = np.stack([ix > 0, iy > 0, iz > 0, np.ones(n, dtype=bool),
                      iz < nz - 1, iy < ny - 1, ix < nx - 1], axis=1)
    del ix, iy, iz
    counts = valid.sum(axis=1)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    indices = (idx[:, None] + offsets[None, :])[valid]
    centre = cfg["diagonal"] + 1j * cfg.get("diagonal_imag", 0.0)
    row_vals = np.full(7, cfg["neighbour"], dtype=dtype)
    row_vals[3] = centre if np.iscomplexobj(row_vals) else centre.real
    data = np.broadcast_to(row_vals, (n, 7))[valid]
    return data, indices, indptr, (n, n)


def sine_basis(n: int, torch, device):
    """The orthonormal eigenvectors of the 1-D Dirichlet Laplacian on ``n``
    points, as the rows of a symmetric (n, n) float64 matrix:
    √(2/(n+1))·sin(π·k·m/(n+1))."""
    k = torch.arange(1, n + 1, dtype=torch.float64, device=device)
    return (2.0 / (n + 1)) ** 0.5 * torch.sin(torch.pi * torch.outer(k, k) / (n + 1))


def eigenbasis(cfg: dict, coeffs):
    """Σ_j coeffs_j·v_j over the operator's orthonormal eigenvectors, which
    are the products of the three axes' sine vectors (the 7-point stencil
    with Dirichlet elimination and a constant centre); ``coeffs`` flat,
    float64, in the grid's order.  Three products with the sine bases."""
    import torch

    nx, ny, nz = (int(v) for v in cfg["grid"])
    g = coeffs.reshape(nx, ny, nz)
    g = torch.tensordot(sine_basis(nx, torch, g.device), g, dims=([1], [0]))
    g = torch.tensordot(g, sine_basis(ny, torch, g.device), dims=([1], [0])).permute(0, 2, 1)
    g = torch.tensordot(g, sine_basis(nz, torch, g.device), dims=([2], [0]))
    return g.reshape(-1)
