"""Operator optimization: pick the execution layout for a matrix.

Counterpart of ``sprsolve_tpu/ops/optimize.py``, the banded branch only
(``optimize.py:151-156`` → ``_dia_operator``, ``:67-75``): a CSR with at most
``max_diags`` distinct diagonals becomes a :class:`PaddedDIA` when it is
float32, and a :class:`DIA` otherwise.  The diagonals are counted in NumPy.
The RCM, BSR, hybrid and ELL routes are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..sparse.containers import CSR, DIA, _host
from .padded_dia import PaddedDIA


def count_diagonals(m: CSR) -> int:
    """Number of distinct offsets col − row (``csr_count_diagonals``)."""
    return int(np.unique(_host(m.indices) - _host(m.row_ids)).size)


def _dia_operator(m: CSR, max_diags: int, device):
    """The banded fast path: f32 → PaddedDIA (kernels K1/K2), else DIA."""
    if m.dtype == torch.float32:
        dia = DIA.from_csr(m, max_diags=max_diags, device="cpu")
        return PaddedDIA.from_dia(dia, device=device)
    return DIA.from_csr(m, max_diags=max_diags, device=device)


def optimize(m: CSR, *, max_diags: int = 32, device=None):
    """Analyze ``m`` and return the operator for repeated SpMV, on ``device``
    (default: the matrix's device).

    Only banded matrices are handled so far; any other pattern raises
    NotImplementedError."""
    device = m.device if device is None else torch.device(device)
    n_diags = count_diagonals(m)
    if n_diags <= max_diags:
        return _dia_operator(m, max_diags, device)
    raise NotImplementedError(
        f"optimize(): {n_diags} diagonals (> max_diags={max_diags}); the "
        "non-banded layouts (RCM, BSR, hybrid, ELL) are ROADMAP.md Queue 1 item 9"
    )
