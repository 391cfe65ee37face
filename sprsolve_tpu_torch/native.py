"""Host toolkit: the graph and factorization passes that run once at setup.

The port's own copy of the NumPy/Python paths of ``sprsolve_tpu/native``
(``native/__init__.py:99-144,218-318``), only the functions the
preconditioners need: ``symmetrize_pattern``, ``greedy_color``, ``ilu0`` and
``ic0``.  (Importing ``sprsolve_tpu.native`` would import the JAX package.)
There is no compiled path: the coloring and the factorizations are Python
row loops, O(nnz) and fine at the sizes the factorizations serve; the
coloring of a 1M-row stencil takes seconds.
"""

from __future__ import annotations

import numpy as np


def symmetrize_pattern(n: int, indptr: np.ndarray, indices: np.ndarray):
    """The pattern of A ∪ Aᵀ as (indptr int64, indices int32), each row's
    columns sorted."""
    indptr = np.asarray(indptr, dtype=np.int64)
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    cols = np.asarray(indices, dtype=np.int64)
    keys = np.unique(np.concatenate([rows * n + cols, cols * n + rows]))
    out_indptr = np.zeros(n + 1, dtype=np.int64)
    out_indptr[1:] = np.cumsum(np.bincount(keys // n, minlength=n))
    return out_indptr, (keys % n).astype(np.int32)


def greedy_color(n: int, indptr: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """First-fit coloring of a symmetric CSR adjacency, rows in order: each
    row takes the least color no earlier neighbour holds."""
    ip = np.asarray(indptr, dtype=np.int64).tolist()
    ind = np.asarray(indices).tolist()
    colors = [-1] * n
    for i in range(n):
        used = {colors[j] for j in ind[ip[i]: ip[i + 1]] if j != i}
        c = 0
        while c in used:
            c += 1
        colors[i] = c
    return np.asarray(colors, dtype=np.int32)


_FACTOR_DTYPES = (np.float32, np.float64, np.complex64, np.complex128)


def _diag_positions(n: int, indptr, indices) -> np.ndarray:
    """Position of each row's diagonal entry; ``ZeroDivisionError(row)``
    where the pattern has none."""
    diag = np.full(n, -1, dtype=np.int64)
    for i in range(n):
        hit = np.nonzero(indices[indptr[i]: indptr[i + 1]] == i)[0]
        if len(hit) == 0:
            raise ZeroDivisionError(i)
        diag[i] = indptr[i] + hit[0]
    return diag


def ilu0(n: int, indptr, indices, values) -> np.ndarray:
    """ILU(0) in the CSR pattern (columns sorted within each row).

    Returns a new values array holding L (strict lower, unit diagonal
    implied) and U (upper with the diagonal) in the original pattern.
    Raises ``ZeroDivisionError`` with the 0-based row of a zero pivot."""
    indptr = np.asarray(indptr, dtype=np.int64)
    indices = np.asarray(indices, dtype=np.int32)
    values = np.array(values, copy=True)
    if values.dtype not in _FACTOR_DTYPES:
        raise TypeError(f"ilu0: unsupported dtype {values.dtype}")
    diag = _diag_positions(n, indptr, indices)
    for i in range(n):
        pos = {int(c): int(p) for p, c in
               zip(range(indptr[i], indptr[i + 1]), indices[indptr[i]: indptr[i + 1]])}
        for p in range(indptr[i], indptr[i + 1]):
            k = int(indices[p])
            if k >= i:
                break
            akk = values[diag[k]]
            if akk == 0:
                raise ZeroDivisionError(k)
            aik = values[p] / akk
            values[p] = aik
            for q in range(diag[k] + 1, indptr[k + 1]):
                pj = pos.get(int(indices[q]))
                if pj is not None:
                    values[pj] -= aik * values[q]
        if values[diag[i]] == 0:
            raise ZeroDivisionError(i)
    return values


def ic0(n: int, indptr, indices, values) -> np.ndarray:
    """IC(0): incomplete Cholesky A ≈ L·Lᴴ in the lower-triangle pattern.

    Returns a new values array with L over the lower-triangle positions
    (the upper positions are left as they were and must be ignored).
    Raises ``ZeroDivisionError`` with the 0-based row of a non-positive
    pivot."""
    indptr = np.asarray(indptr, dtype=np.int64)
    indices = np.asarray(indices, dtype=np.int32)
    values = np.array(values, copy=True)
    if values.dtype not in _FACTOR_DTYPES:
        raise TypeError(f"ic0: unsupported dtype {values.dtype}")
    diag = _diag_positions(n, indptr, indices)
    for i in range(n):
        pos = {}
        for p in range(indptr[i], indptr[i + 1]):
            c = int(indices[p])
            if c > i:
                break
            pos[c] = p
        for p in range(indptr[i], indptr[i + 1]):
            k = int(indices[p])
            if k >= i:
                break
            s = values[p]
            for q in range(indptr[k], indptr[k + 1]):
                j = int(indices[q])
                if j >= k:
                    break
                pj = pos.get(j)
                if pj is not None:
                    s -= values[pj] * np.conj(values[q])
            values[p] = s / values[diag[k]]
        d = float(np.real(values[diag[i]]))
        for p in range(indptr[i], diag[i]):
            d -= float(np.real(values[p] * np.conj(values[p])))
        if not d > 0.0:
            raise ZeroDivisionError(i)
        values[diag[i]] = np.sqrt(d)
    return values
