"""Host toolkit: the graph and factorization passes that run once at setup.

The port's own copy of ``sprsolve_tpu/native`` (importing that would import
the JAX package): ``csrc/hostkit.cpp``, compiled with g++ at first use and
bound with ctypes, with a plain NumPy/Python version of every function
beside it.  The entry points (``symmetrize_pattern``, ``greedy_color``,
``rcm_order``, ``coo_sort_perm``, ``csr_bandwidth``,
``csr_count_diagonals``, ``ilu0``, ``ic0``, ``mm_parse_coord``) always run
the compiled code; the ``*_plain`` versions are what the tests hold them
against.

The library goes to ``build/hostkit/`` at the root of the checkout (listed
in ``.gitignore``), named by a digest of the source and the flags, and is
written under a temporary name and renamed into place.  There is no
fallback: a failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from collections import deque
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "hostkit.cpp"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def build_dir() -> Path:
    """``build/hostkit`` beside the package directory."""
    return SOURCE.parent.parent.parent / "build" / "hostkit"


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return build_dir() / f"libhostkit_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile :data:`SOURCE` into :func:`library_path` unless it exists;
    returns the path. Raises RuntimeError with g++'s output on failure."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: sprsolve_tpu_torch builds its host "
                           "toolkit (csrc/hostkit.cpp) with g++")
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        lib = os.path.join(tmp, out.name)
        cmd = [cxx, *CXX_FLAGS, str(SOURCE), "-o", lib]
        p = subprocess.run(cmd, capture_output=True, text=True)
        if p.returncode != 0:
            raise RuntimeError(f"g++ failed ({p.returncode}): {' '.join(cmd)}\n"
                               f"{p.stdout}\n{p.stderr}")
        os.replace(lib, out)
    return out


_I64P = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_I32P = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_I64 = ctypes.c_int64
_F64P = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_FACTOR_SUFFIX = {np.dtype(np.float32): "f32", np.dtype(np.float64): "f64",
                  np.dtype(np.complex64): "c64", np.dtype(np.complex128): "c128"}
_SIGNATURES = {
    "greedy_color": ([_I64, _I64P, _I32P, _I32P], ctypes.c_int32),
    "symmetrize_pattern": ([_I64, _I64P, _I32P, _I64P, ctypes.c_void_p], _I64),
    "rcm_order": ([_I64, _I64P, _I32P, _I32P], None),
    "coo_sort_perm": ([_I64, _I64, _I32P, _I32P, _I64P], None),
    "csr_bandwidth": ([_I64, _I64P, _I32P], _I64),
    "csr_count_diagonals": ([_I64, _I64P, _I32P], _I64),
    "mm_parse_coord": ([ctypes.c_char_p, _I64, _I64, ctypes.c_int32, _I64P, _I64P,
                        _F64P, _F64P], _I64),
    **{f"{kind}_{sfx}": ([_I64, _I64P, _I32P, ctypes.c_void_p], _I64)
       for kind in ("ilu0", "ic0") for sfx in _FACTOR_SUFFIX.values()},
}


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build if needed, then load the library once per process, with every
    function's ``argtypes``/``restype`` declared."""
    lib = ctypes.CDLL(str(build()))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def _pattern(n: int, indptr, indices):
    """(indptr int64, indices int32), contiguous, checked to be an n-row
    pattern of an n-column matrix before C++ indexes with them."""
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    if (len(indptr) != n + 1 or indptr[0] != 0 or indptr[-1] != len(indices)
            or np.any(np.diff(indptr) < 0)):
        raise ValueError(f"not the indptr of a {n}-row CSR with {len(indices)} entries")
    if len(indices) and not (0 <= indices.min() and indices.max() < n):
        raise ValueError(f"column indices outside [0, {n}): the host toolkit takes "
                         "square patterns")
    return indptr, indices


# --- compiled entry points ---------------------------------------------------
def symmetrize_pattern(n: int, indptr, indices):
    """The pattern of A ∪ Aᵀ as (indptr int64, indices int32), each row's
    columns sorted."""
    lib = load()
    indptr, indices = _pattern(n, indptr, indices)
    out_indptr = np.zeros(n + 1, dtype=np.int64)
    total = lib.symmetrize_pattern(n, indptr, indices, out_indptr, None)
    out_indices = np.zeros(total, dtype=np.int32)
    lib.symmetrize_pattern(n, indptr, indices, out_indptr,
                           out_indices.ctypes.data_as(ctypes.c_void_p))
    return out_indptr, out_indices


def greedy_color(n: int, indptr, indices) -> np.ndarray:
    """First-fit coloring of a symmetric CSR adjacency, rows in order: each
    row takes the least color no earlier neighbour holds."""
    indptr, indices = _pattern(n, indptr, indices)
    colors = np.zeros(n, dtype=np.int32)
    load().greedy_color(n, indptr, indices, colors)
    return colors


def rcm_order(n: int, indptr, indices) -> np.ndarray:
    """Reverse Cuthill-McKee order of a symmetric pattern: ``order[k]`` is
    the original index of the k-th node (see ``csrc/hostkit.cpp``)."""
    indptr, indices = _pattern(n, indptr, indices)
    order = np.zeros(n, dtype=np.int32)
    load().rcm_order(n, indptr, indices, order)
    return order


def coo_sort_perm(n_rows: int, rows, cols) -> np.ndarray:
    """The permutation that sorts COO triplets by (row, col), stable."""
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    cols = np.ascontiguousarray(cols, dtype=np.int32)
    if len(rows) != len(cols) or (len(rows) and not 0 <= rows.min() <= rows.max() < n_rows):
        raise ValueError(f"rows outside [0, {n_rows}) or rows and cols of other lengths")
    perm = np.zeros(len(rows), dtype=np.int64)
    load().coo_sort_perm(n_rows, len(rows), rows, cols, perm)
    return perm


def csr_bandwidth(n: int, indptr, indices) -> int:
    """max |col − row| over the pattern."""
    return int(load().csr_bandwidth(n, *_pattern(n, indptr, indices)))


def csr_count_diagonals(n: int, indptr, indices) -> int:
    """Number of distinct offsets col − row of a square pattern."""
    return int(load().csr_count_diagonals(n, *_pattern(n, indptr, indices)))


def _factor(kind: str, n: int, indptr, indices, values) -> np.ndarray:
    indptr, indices = _pattern(n, indptr, indices)
    values = np.array(values, copy=True)
    if values.dtype not in _FACTOR_SUFFIX:
        raise TypeError(f"{kind}: unsupported dtype {values.dtype}")
    if values.shape != indices.shape:
        raise ValueError(f"{kind}: {values.shape[0]} values for {len(indices)} entries")
    fn = getattr(load(), f"{kind}_{_FACTOR_SUFFIX[values.dtype]}")
    rc = fn(n, indptr, indices, values.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise ZeroDivisionError(int(rc) - 1)
    return values


def ilu0(n: int, indptr, indices, values) -> np.ndarray:
    """ILU(0) in the CSR pattern (columns sorted within each row).

    Returns a new values array holding L (strict lower, unit diagonal
    implied) and U (upper with the diagonal) in the original pattern.
    Raises ``ZeroDivisionError`` with the 0-based row of a zero pivot or a
    missing diagonal."""
    return _factor("ilu0", n, indptr, indices, values)


def ic0(n: int, indptr, indices, values) -> np.ndarray:
    """IC(0): incomplete Cholesky A ≈ L·Lᴴ in the lower-triangle pattern.

    Returns a new values array with L over the lower-triangle positions
    (the upper positions are left as they were and must be ignored).
    Raises ``ZeroDivisionError`` with the 0-based row of a non-positive
    pivot or a missing diagonal."""
    return _factor("ic0", n, indptr, indices, values)


def _mm_check(got: int, nnz: int) -> None:
    if got != nnz:
        raise ValueError(f"malformed Matrix Market data: expected {nnz} entries, "
                         f"parsed {max(got, 0)}")


def mm_parse_coord(text: bytes, nnz: int, field: int):
    """Parse the ``nnz`` coordinate records of a Matrix Market file's body
    (the text after the size line; blank and ``%`` lines skipped).

    ``field``: 0 pattern, 1 real/integer, 2 complex. Returns ``(rows, cols,
    re, im)``: 0-based int64 indices and float64 values, ``re`` empty for a
    pattern file and ``im`` empty unless complex. Raises ValueError on a
    malformed record or an early end."""
    if field not in (0, 1, 2):
        raise ValueError(f"field must be 0, 1 or 2, got {field}")
    rows = np.empty(nnz, dtype=np.int64)
    cols = np.empty(nnz, dtype=np.int64)
    re = np.empty(nnz if field >= 1 else 0, dtype=np.float64)
    im = np.empty(nnz if field == 2 else 0, dtype=np.float64)
    _mm_check(load().mm_parse_coord(text, len(text), nnz, field, rows, cols, re, im), nnz)
    return rows, cols, re, im


# --- plain versions ----------------------------------------------------------
def symmetrize_pattern_plain(n: int, indptr, indices):
    """:func:`symmetrize_pattern` in NumPy: the sorted union of the (r, c)
    and (c, r) keys."""
    indptr = np.asarray(indptr, dtype=np.int64)
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    cols = np.asarray(indices, dtype=np.int64)
    keys = np.unique(np.concatenate([rows * n + cols, cols * n + rows]))
    out_indptr = np.zeros(n + 1, dtype=np.int64)
    out_indptr[1:] = np.cumsum(np.bincount(keys // n, minlength=n))
    return out_indptr, (keys % n).astype(np.int32)


def greedy_color_plain(n: int, indptr, indices) -> np.ndarray:
    """:func:`greedy_color` as a Python row loop."""
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


def rcm_order_plain(n: int, indptr, indices) -> np.ndarray:
    """:func:`rcm_order` as a Python BFS: components seeded in scan order,
    each node's new neighbours queued by ascending degree, ties in pattern
    order (Python's sort is stable)."""
    ip = np.asarray(indptr, dtype=np.int64).tolist()
    ind = np.asarray(indices).tolist()
    degree = [ip[i + 1] - ip[i] for i in range(n)]
    visited = [False] * n
    result = []
    for seed in range(n):
        if visited[seed]:
            continue
        visited[seed] = True
        queue = deque([seed])
        while queue:
            u = queue.popleft()
            result.append(u)
            nbrs = []
            for v in ind[ip[u]: ip[u + 1]]:
                if not visited[v]:
                    visited[v] = True
                    nbrs.append(v)
            queue.extend(sorted(nbrs, key=degree.__getitem__))
    return np.asarray(result[::-1], dtype=np.int32)


def coo_sort_perm_plain(n_rows: int, rows, cols) -> np.ndarray:
    return np.lexsort((np.asarray(cols), np.asarray(rows)))


def csr_bandwidth_plain(n: int, indptr, indices) -> int:
    rows = np.repeat(np.arange(n), np.diff(np.asarray(indptr)))
    return int(np.abs(np.asarray(indices, np.int64) - rows).max()) if len(rows) else 0


def csr_count_diagonals_plain(n: int, indptr, indices) -> int:
    rows = np.repeat(np.arange(n), np.diff(np.asarray(indptr)))
    return int(np.unique(np.asarray(indices, np.int64) - rows).size)


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


def ilu0_plain(n: int, indptr, indices, values) -> np.ndarray:
    """:func:`ilu0` as a Python row loop."""
    indptr, indices = _pattern(n, indptr, indices)
    values = np.array(values, copy=True)
    if values.dtype not in _FACTOR_SUFFIX:
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


def ic0_plain(n: int, indptr, indices, values) -> np.ndarray:
    """:func:`ic0` as a Python row loop."""
    indptr, indices = _pattern(n, indptr, indices)
    values = np.array(values, copy=True)
    if values.dtype not in _FACTOR_SUFFIX:
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


def mm_parse_coord_plain(text: bytes, nnz: int, field: int):
    """:func:`mm_parse_coord` with ``np.loadtxt``: the first ``2 + field``
    fields of the first ``nnz`` records (``%`` lines skipped), read as
    float64."""
    import io

    ncols = 2 + field
    try:
        a = np.loadtxt(io.StringIO(text.decode()), comments="%", ndmin=2,
                       usecols=range(ncols))
    except ValueError as e:
        raise ValueError(f"malformed Matrix Market data: {e}") from e
    if a.size == 0:
        a = a.reshape(0, ncols)
    _mm_check(min(a.shape[0], nnz), nnz)
    a = a[:nnz]
    rows = a[:, 0].astype(np.int64) - 1
    cols = a[:, 1].astype(np.int64) - 1
    re = a[:, 2].copy() if field >= 1 else np.empty(0, np.float64)
    im = a[:, 3].copy() if field == 2 else np.empty(0, np.float64)
    return rows, cols, re, im
