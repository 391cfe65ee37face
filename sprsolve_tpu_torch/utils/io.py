"""Matrix Market IO: NumPy and the compiled host toolkit, no scipy.

Counterpart of ``sprsolve_tpu/utils/io.py``, with the same checks and the
same text out.  Reads and writes the full coordinate/array ×
real/complex/integer/pattern × general/symmetric/skew-symmetric/hermitian
grid of the format.

``mmread`` returns the port's :class:`~sprsolve_tpu_torch.sparse.containers.CSR`
(on the CPU; ``solve()`` moves it) for a coordinate file, duplicates summed
and symmetry expanded, and a NumPy array for an array file.  Coordinate
records are parsed by the host toolkit's ``mm_parse_coord``
(``csrc/hostkit.cpp``); a failed build raises, there is no second parser.
``mmwrite`` writes coordinate format from a CSR or COO, array format from a
dense array.
"""

from __future__ import annotations

import io as _io

import numpy as np

from .. import native
from ..sparse.containers import COO, CSR, _host


def _parse_header(line: str):
    parts = line.strip().split()
    if len(parts) != 5 or parts[0] != "%%MatrixMarket" or parts[1].lower() != "matrix":
        raise ValueError(f"not a MatrixMarket matrix file: {line.strip()!r}")
    fmt, field, sym = parts[2].lower(), parts[3].lower(), parts[4].lower()
    if fmt not in ("coordinate", "array"):
        raise ValueError(f"unknown MatrixMarket format {fmt!r}")
    if field not in ("real", "complex", "integer", "pattern"):
        raise ValueError(f"unknown MatrixMarket field {field!r}")
    if sym not in ("general", "symmetric", "skew-symmetric", "hermitian"):
        raise ValueError(f"unknown MatrixMarket symmetry {sym!r}")
    return fmt, field, sym


def _expand_symmetry(row, col, val, sym):
    if sym == "general":
        return row, col, val
    off = row != col
    r2, c2, v2 = col[off], row[off], val[off]
    if sym == "hermitian":
        v2 = np.conj(v2)
    elif sym == "skew-symmetric":
        v2 = -v2
    return (np.concatenate([row, r2]), np.concatenate([col, c2]),
            np.concatenate([val, v2]))


def _check_record_count(tail: str, expected: int) -> None:
    """Reject a file whose count of data records disagrees with its size
    line (reading only the declared count would hide a corruption)."""
    got = sum(1 for ln in tail.splitlines()
              if ln.strip() and not ln.strip().startswith("%"))
    if got != expected:
        raise ValueError(f"malformed Matrix Market data: {got} records but the size "
                         f"line declares {expected}")


def _loadtxt_block(tail: str, ncols: int, nrows: int) -> np.ndarray:
    a = np.loadtxt(_io.StringIO(tail), comments="%", ndmin=2)
    if a.size == 0:
        a = a.reshape(0, ncols)
    if a.shape[0] < nrows or a.shape[1] != ncols:
        raise ValueError(f"malformed Matrix Market data: expected {nrows} records of "
                         f"{ncols} fields, got {a.shape}")
    return a[:nrows]


def _split(text: str):
    """((format, field, symmetry), size fields, the text after the size
    line): the header and size lines found by character offset, so the rest
    goes to a bulk parser as one string."""
    pos, header = 0, None
    while pos < len(text):
        nl = text.find("\n", pos)
        nl = len(text) if nl < 0 else nl
        line = text[pos:nl]
        pos = nl + 1
        if header is None:
            header = _parse_header(line)
            continue
        s = line.strip()
        if s and not s.startswith("%"):
            return header, s.split(), text[pos:]
    raise ValueError("malformed Matrix Market file: no size line")


def _read_array(tail, m, n, field, sym, dtype) -> np.ndarray:
    if sym == "general":
        count = m * n
    elif sym == "skew-symmetric":
        count = sum(m - j - 1 for j in range(n))
    else:
        count = sum(m - j for j in range(n))
    _check_record_count(tail, count)
    block = _loadtxt_block(tail, 2 if field == "complex" else 1, count)
    vals = block[:, 0] + 1j * block[:, 1] if field == "complex" else block[:, 0]
    if sym == "general":
        return vals.astype(dtype).reshape((n, m)).T   # column-major
    # the lower triangle, column by column; mirror its strict part (a
    # skew-symmetric file leaves out the diagonal, which is 0)
    a = np.zeros((m, n), dtype=dtype)
    it = iter(vals)
    for j in range(n):
        for i in range(j + 1 if sym == "skew-symmetric" else j, m):
            a[i, j] = next(it)
    upper = a.T
    if sym == "hermitian":
        upper = np.conj(upper)
    elif sym == "skew-symmetric":
        upper = -upper
    return a + np.triu(upper, 1)


def mmread(source):
    """Read a Matrix Market file (a path, a path-like or an open text file).

    Coordinate files give a CSR (symmetry expanded, duplicates summed),
    array files a dense ``np.ndarray`` (filled column-major, as the format
    stores it). Values are float64, complex128 or int64, by the file's
    field. Malformed files raise ValueError."""
    if hasattr(source, "read"):
        text = source.read()
    else:
        with open(source, "r") as f:
            text = f.read()
    (fmt, field, sym), size, tail = _split(text)
    dtype = {"complex": np.complex128, "integer": np.int64}.get(field, np.float64)
    if fmt == "array":
        return _read_array(tail, int(size[0]), int(size[1]), field, sym, dtype)

    m, n, nnz = int(size[0]), int(size[1]), int(size[2])
    _check_record_count(tail, nnz)
    field_code = {"pattern": 0, "real": 1, "integer": 1, "complex": 2}[field]
    row, col, re, im = native.mm_parse_coord(tail.encode(), nnz, field_code)
    if field == "pattern":
        val = np.ones(nnz, dtype=dtype)
    elif field == "complex":
        val = re + 1j * im
    else:
        val = re.astype(dtype)
    if nnz and (row.min() < 0 or col.min() < 0 or row.max() >= m or col.max() >= n):
        raise ValueError("malformed Matrix Market data: index out of range")
    row, col, val = _expand_symmetry(row, col, val, sym)
    return CSR.from_coo(COO(data=val, row=row, col=col, shape=(m, n)))


def mmwrite(target, a, comment: str = "", symmetry: str = "general"):
    """Write ``a``: a CSR or COO in coordinate format, a dense array in
    array format (always general).

    ``symmetry`` is 'general', 'symmetric', 'hermitian' or
    'skew-symmetric'; the last three store only the lower triangle (the
    strict one for skew-symmetric, whose diagonal is 0 by definition). The
    caller vouches for the symmetry: the entries above the diagonal are
    dropped, not checked."""
    if hasattr(target, "write"):
        _mmwrite_impl(target, a, comment, symmetry)
        return
    with open(target, "w") as f:
        _mmwrite_impl(f, a, comment, symmetry)


def _fmt_val(v, field):
    if field == "complex":
        return f"{v.real:.17g} {v.imag:.17g}"
    return f"{v:.17g}"


def _write_header(f, fmt, field, symmetry, comment):
    f.write(f"%%MatrixMarket matrix {fmt} {field} {symmetry}\n")
    for line in comment.splitlines():
        f.write(f"% {line}\n")


def _mmwrite_impl(f, a, comment, symmetry):
    if isinstance(a, (CSR, COO)):
        if isinstance(a, COO):
            a = CSR.from_coo(a)
        dat = _host(a.data)
        rows = _host(a.row_ids).astype(np.int64)
        cols = _host(a.indices).astype(np.int64)
        if np.iscomplexobj(dat):
            field = "complex"
        elif np.issubdtype(dat.dtype, np.integer):
            field = "integer"
        else:
            field = "real"
        if symmetry not in ("general", "symmetric", "hermitian", "skew-symmetric"):
            raise ValueError(f"unknown MatrixMarket symmetry {symmetry!r}")
        if symmetry != "general":
            # a skew matrix's diagonal is 0 and not stored
            keep = rows > cols if symmetry == "skew-symmetric" else rows >= cols
            rows, cols, dat = rows[keep], cols[keep], dat[keep]
        _write_header(f, "coordinate", field, symmetry, comment)
        f.write(f"{a.shape[0]} {a.shape[1]} {len(dat)}\n")
        # chunked bulk %-formatting: about twice the per-entry write loop
        # and 3.5 times np.savetxt on files of millions of entries
        if field == "complex":
            fmt1, parts = "%d %d %.17g %.17g\n", (rows + 1, cols + 1, dat.real, dat.imag)
        elif field == "integer":
            fmt1, parts = "%d %d %d\n", (rows + 1, cols + 1, dat)
        else:
            fmt1, parts = "%d %d %.17g\n", (rows + 1, cols + 1, dat)
        k = len(parts)
        inter = np.empty(k * len(dat), dtype=object)
        for j, p in enumerate(parts):
            inter[j::k] = p
        step = 131072
        for s in range(0, len(dat), step):
            blk = inter[k * s:k * (s + step)]
            f.write((fmt1 * (len(blk) // k)) % tuple(blk))
        return

    arr = np.asarray(a)
    if arr.ndim != 2:
        raise ValueError("mmwrite needs a matrix (2-D) input")
    field = "complex" if np.iscomplexobj(arr) else "real"
    _write_header(f, "array", field, "general", comment)
    f.write(f"{arr.shape[0]} {arr.shape[1]}\n")
    for v in arr.T.ravel():   # column-major, as the format stores it
        f.write(_fmt_val(v, field) + "\n")
