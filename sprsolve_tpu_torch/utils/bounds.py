"""Host-side spectral interval estimates (Gershgorin).

Counterpart of ``sprsolve_tpu/utils/bounds.py``: one O(nnz) NumPy pass over
a CSR or DIA container gives an interval [lo, hi] that holds every
eigenvalue.  For tight estimates at the cost of about 30 matvecs use
:func:`sprsolve_tpu_torch.precond.estimate_spectral_bounds` (Lanczos).
"""

from __future__ import annotations

import numpy as np

from ..sparse.containers import DIA, _host


def gershgorin_bounds(A) -> tuple:
    """Gershgorin (lower, upper) eigenvalue bounds of a CSR or DIA
    container; for a Hermitian A they bracket the real spectrum."""
    if isinstance(A, DIA):
        bands = _host(A.bands)
        diag = bands[A.offsets.index(0)] if 0 in A.offsets else np.zeros(
            A.shape[0], bands.dtype)
        radius = np.zeros(A.shape[0], dtype=np.float64)
        for d, off in enumerate(A.offsets):
            if off != 0:
                # band d holds a_{i, i+off} at row i; out-of-range slots are 0
                radius += np.abs(bands[d])
        return float(np.min(diag.real - radius)), float(np.max(diag.real + radius))
    data, indices = _host(A.data), _host(A.indices)
    n = A.shape[0]
    rows = np.repeat(np.arange(n), np.diff(_host(A.indptr)))
    off = rows != indices
    radius = np.bincount(rows[off], weights=np.abs(data[off]), minlength=n)
    diag = np.zeros(n, dtype=np.float64)
    diag[rows[~off]] = data[~off].real
    return float(np.min(diag - radius)), float(np.max(diag + radius))
