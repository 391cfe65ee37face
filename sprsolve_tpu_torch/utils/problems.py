"""Problem generators: NumPy builders that return the port's CSR.

Counterpart of ``sprsolve_tpu/utils/problems.py:35-133,216-297``, with the
same matrices entry for entry:

- :func:`grid_laplacian_dirichlet` + :func:`set_boundary_condition` — the
  Dirichlet 5-point grid Laplacian of the reference's
  ``tests/test_solvers.rs:74-124``;
- :func:`sym_grid_laplacian` and :func:`simple_diag_system` — the MINRES
  goldens of the reference's ``tests/test_minres.rs``;
- :func:`hermitian_grid`, :func:`hermitian_grid_with_diag` and
  :func:`complex_symmetric_grid_with_diag` — the reference's complex grids
  with the manufactured solution x[vid] = row + col·i
  (``tests/test_complex_solve.rs:95-214``, ``tests/test_complex_solve2.rs:35-96``);
- :func:`poisson3d` — the 7-point 3-D Poisson operator (interior unknowns);
- :func:`convection_diffusion3d` — its nonsymmetric upwind variant;
- :func:`hpcg27` — HPCG's 27-point operator (``GenerateProblem``).
"""

from __future__ import annotations

import itertools
from typing import Callable, Tuple

import numpy as np

from ..sparse.containers import COO, CSR


def _coo_to_csr(rows, cols, vals, n, dtype, device=None) -> CSR:
    coo = COO(
        data=np.asarray(vals, dtype=dtype),
        row=np.asarray(rows, dtype=np.int64),
        col=np.asarray(cols, dtype=np.int64),
        shape=(n, n),
    )
    return CSR.from_coo(coo, device=device)


def is_border(row: int, col: int, shape: Tuple[int, int]) -> bool:
    rows, cols = shape
    return row == 0 or row + 1 == rows or col == 0 or col + 1 == cols


def grid_laplacian_dirichlet(shape: Tuple[int, int], dtype=np.float64,
                             device=None) -> CSR:
    """Dirichlet grid Laplacian (``tests/test_solvers.rs:74-109``): identity
    rows on the border, 5-point stencil (-4 center, +1 neighbors) inside."""
    rows, cols = shape
    n = rows * cols
    ri, ci, vv = [], [], []
    for i in range(rows):
        for j in range(cols):
            vid = i * cols + j
            if is_border(i, j, shape):
                ri.append(vid)
                ci.append(vid)
                vv.append(1.0)
            else:
                for (ti, tj, val) in (
                    (i - 1, j, 1.0),
                    (i, j - 1, 1.0),
                    (i, j, -4.0),
                    (i, j + 1, 1.0),
                    (i + 1, j, 1.0),
                ):
                    ri.append(vid)
                    ci.append(ti * cols + tj)
                    vv.append(val)
    return _coo_to_csr(ri, ci, vv, n, dtype, device)


def set_boundary_condition(
    rhs: np.ndarray, grid_shape: Tuple[int, int], f: Callable[[int, int], float]
) -> np.ndarray:
    """Set rhs entries on the border (``tests/test_solvers.rs:111-124``)."""
    rows, cols = grid_shape
    for i in range(rows):
        for j in range(cols):
            if is_border(i, j, grid_shape):
                rhs[i * cols + j] = f(i, j)
    return rhs


def sym_grid_laplacian(shape: Tuple[int, int], dtype=np.float64,
                       device=None) -> Tuple[CSR, np.ndarray]:
    """Symmetric grid Laplacian with the boundary folded into the rhs
    (``tests/test_minres.rs:76-120``): -4 on the diagonal, +1 to each
    neighbour inside the grid, boundary value bv(r, c) = r + c. Negative
    definite. Returns ``(A, rhs)``."""
    rows, cols = shape
    n = rows * cols
    rhs = np.zeros(n, dtype=dtype)
    ri, ci, vv = [], [], []
    bv = lambda r, c: float(r + c)
    for i in range(rows):
        for j in range(cols):
            vid = i * cols + j
            ri.append(vid); ci.append(vid); vv.append(-4.0)
            for (ti, tj, inside) in ((i - 1, j, i > 0), (i, j - 1, j > 0),
                                     (i + 1, j, i < rows - 1), (i, j + 1, j < cols - 1)):
                if inside:
                    ri.append(vid); ci.append(ti * cols + tj); vv.append(1.0)
                else:
                    rhs[vid] -= bv(ti, tj)
    return _coo_to_csr(ri, ci, vv, n, dtype, device), rhs


def simple_diag_system(shape: Tuple[int, int], dtype=np.float64,
                       device=None) -> Tuple[CSR, np.ndarray]:
    """Diagonal system a_ii = 2(i+1), b_i = i+1 (``tests/test_minres.rs:62-74``).
    Returns ``(A, rhs)``."""
    n = shape[0] * shape[1]
    idx = np.arange(n)
    return _coo_to_csr(idx, idx, (idx + 1) * 2.0, n, dtype, device), (idx + 1).astype(dtype)


def _complex_grid(shape, off_diag: Callable[[int, int], complex],
                  diag_fn: Callable[[int, int], complex], dtype, device):
    """The manufactured-solution complex grids: rhs = A·x_known with
    x_known[vid] = row + col·i, accumulated term by term in the reference's
    order (``tests/test_complex_solve.rs:109-149``). Returns
    ``(A, rhs, diag)``."""
    rows, cols = shape
    n = rows * cols
    rhs = np.zeros(n, dtype=dtype)
    diag = np.zeros(n, dtype=dtype)
    ri, ci, vv = [], [], []
    for i in range(rows):
        for j in range(cols):
            vid = i * cols + j
            c = diag_fn(i, j)
            diag[vid] = c
            ri.append(vid); ci.append(vid); vv.append(c)
            rv = 0.0 + 0.0j
            rv += c * complex(i, j)
            for tid, ti, tj, inside in (((i - 1) * cols + j, i - 1, j, i > 0),
                                        (i * cols + j - 1, i, j - 1, j > 0),
                                        ((i + 1) * cols + j, i + 1, j, i < rows - 1),
                                        (i * cols + j + 1, i, j + 1, j < cols - 1)):
                if inside:
                    cv = off_diag(vid, tid)
                    ri.append(vid); ci.append(tid); vv.append(cv)
                    rv += cv * complex(ti, tj)
            rhs[vid] = rv
    return _coo_to_csr(ri, ci, vv, n, dtype, device), rhs, diag


def _hermitian(shape, dtype, device):
    return _complex_grid(shape, off_diag=lambda r, c: (1 + 2.5j) if r > c else (1 - 2.5j),
                         diag_fn=lambda i, j: complex(-3.0 - i, 0.0), dtype=dtype,
                         device=device)


def hermitian_grid(shape, dtype=np.complex128, device=None) -> Tuple[CSR, np.ndarray]:
    """Hermitian grid operator (``tests/test_complex_solve.rs:95-151``):
    off-diagonals (1 ± 2.5i) in conjugate pairs, real diagonal −3 − row.
    Returns ``(A, rhs)``."""
    A, rhs, _ = _hermitian(shape, dtype, device)
    return A, rhs


def hermitian_grid_with_diag(shape, dtype=np.complex128, device=None
                             ) -> Tuple[CSR, np.ndarray, np.ndarray]:
    """Same, plus the **real** preconditioner diagonal −Re(a_ii) = 3 + row
    (``tests/test_complex_solve.rs:153-214``)."""
    A, rhs, diag = _hermitian(shape, dtype, device)
    return A, rhs, -diag.real


def complex_symmetric_grid_with_diag(shape, dtype=np.complex128, device=None
                                     ) -> Tuple[CSR, np.ndarray, np.ndarray]:
    """Complex-symmetric (non-Hermitian) grid
    (``tests/test_complex_solve2.rs:35-96``): both off-diagonals (1 − 2.5i),
    complex diagonal (−2 − row) + (−2 − col)·i. Returns ``(A, rhs, diag)``."""
    return _complex_grid(shape, off_diag=lambda r, c: 1 - 2.5j,
                         diag_fn=lambda i, j: complex(-2.0 - i, -2.0 - j),
                         dtype=dtype, device=device)


def poisson3d(nx: int, ny: int, nz: int, dtype=np.float32, device=None) -> CSR:
    """7-point 3-D Poisson operator with Dirichlet elimination (interior-only
    unknowns): 6 on the diagonal, -1 to each neighbour."""
    return _stencil7(nx, ny, nz, 0.0, dtype, device)


def convection_diffusion3d(nx: int, ny: int, nz: int, peclet: float = 20.0,
                           dtype=np.float32, device=None) -> CSR:
    """7-point convection-diffusion −Δu + v·∇u, first-order upwind along x
    (flow in +x): :func:`poisson3d` with ``peclet`` added to the diagonal and
    subtracted from the −x coupling. Banded and nonsymmetric."""
    return _stencil7(nx, ny, nz, float(peclet), dtype, device)


def hpcg27(nx: int, ny: int, nz: int, dtype=np.float64, device=None) -> CSR:
    """HPCG's 27-point operator on interior unknowns (HPCG 3.1
    ``GenerateProblem``): 26 on the diagonal, −1 to each of the 26
    neighbours inside the grid; rows x-major, z fastest."""
    n = nx * ny * nz
    idx = np.arange(n, dtype=np.int64)
    coords = (idx // (nz * ny), (idx // nz) % ny, idx % nz)
    rows, cols, vals = [idx], [idx], [np.full(n, 26.0, dtype=dtype)]
    for shift in itertools.product((-1, 0, 1), repeat=3):
        if shift == (0, 0, 0):
            continue
        mask = np.ones(n, dtype=bool)
        for c, s, side in zip(coords, shift, (nx, ny, nz)):
            mask &= (c + s >= 0) & (c + s < side)
        delta = (shift[0] * ny + shift[1]) * nz + shift[2]
        rows.append(idx[mask])
        cols.append(idx[mask] + delta)
        vals.append(np.full(int(mask.sum()), -1.0, dtype=dtype))
    return _coo_to_csr(np.concatenate(rows), np.concatenate(cols), np.concatenate(vals),
                       n, dtype, device)


def _stencil7(nx: int, ny: int, nz: int, c: float, dtype, device) -> CSR:
    """The 7-point stencil on interior unknowns: 6 + c on the diagonal,
    −1 − c to the −x neighbour and −1 to the other five."""
    n = nx * ny * nz
    idx = np.arange(n, dtype=np.int64)
    iz = idx % nz
    iy = (idx // nz) % ny
    ix = idx // (nz * ny)

    rows = [idx]
    cols = [idx]
    vals = [np.full(n, 6.0 + c, dtype=dtype)]
    for delta, mask, v in (
        (-nz * ny, ix > 0, -1.0 - c),
        (nz * ny, ix < nx - 1, -1.0),
        (-nz, iy > 0, -1.0),
        (nz, iy < ny - 1, -1.0),
        (-1, iz > 0, -1.0),
        (1, iz < nz - 1, -1.0),
    ):
        rows.append(idx[mask])
        cols.append(idx[mask] + delta)
        vals.append(np.full(mask.sum(), v, dtype=dtype))

    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    vals = np.concatenate(vals)
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    indptr = np.zeros(n + 1, dtype=np.int64)
    indptr[1:] = np.cumsum(np.bincount(rows, minlength=n))
    return CSR.from_arrays(vals, cols, indptr, (n, n), device=device)
