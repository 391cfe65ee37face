"""Operator optimization: pick the execution layout for a matrix.

Counterpart of ``sprsolve_tpu/ops/optimize.py``, the banded branch
(``optimize.py:151-156`` → ``_dia_operator``, ``:67-75``): a CSR with at most
``max_diags`` distinct diagonals becomes a :class:`PaddedDIA` when it is
float32, a :class:`ComplexPaddedDIA` when it is complex64, and a
:class:`DIA` otherwise or when ``prefer_kernels=False``.  The diagonals are
counted in NumPy.  The other layouts (RCM, BSR, hybrid, ELL) are
``ROADMAP.md`` Queue 1 item 9; float64 and complex128 reach the kernels when
the padded operator is built directly (item 5).
"""

from __future__ import annotations

import numpy as np
import torch

from ..sparse.containers import CSR, DIA, _host
from .padded_dia import ComplexPaddedDIA, PaddedDIA


def default_device(device) -> torch.device:
    """``device`` as given, else the CUDA device: the entry points run on the
    card unless the caller asks for the CPU. Raises RuntimeError when no
    device was given and CUDA is absent, rather than solving on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: sprsolve_tpu_torch runs on the GPU by default; "
            "pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda")


def count_diagonals(m: CSR) -> int:
    """Number of distinct offsets col − row (``csr_count_diagonals``)."""
    return int(np.unique(_host(m.indices) - _host(m.row_ids)).size)


def _dia_operator(m: CSR, max_diags: int, prefer_kernels: bool, device):
    """The banded fast path: f32 → PaddedDIA (kernels K1-K4), c64 →
    ComplexPaddedDIA (K5-K7), else (or without ``prefer_kernels``) DIA."""
    if prefer_kernels and m.dtype == torch.complex64:
        return ComplexPaddedDIA.from_csr(m, device=device)
    if prefer_kernels and m.dtype == torch.float32:
        dia = DIA.from_csr(m, max_diags=max_diags, device="cpu")
        return PaddedDIA.from_dia(dia, device=device)
    return DIA.from_csr(m, max_diags=max_diags, device=device)


def optimize(m: CSR, *, max_diags: int = 32, prefer_kernels: bool = True, device=None):
    """Analyze ``m`` and return the operator for repeated SpMV, on ``device``
    (default: the CUDA device; see :func:`default_device`).

    ``prefer_kernels=False`` keeps a banded matrix on the plain ``DIA`` path
    (torch ops, flat vectors): the counterpart of the JAX package's
    ``prefer_pallas``. The factors of ``ILU0Precond`` and ``IC0Precond``
    take it, since a padded operator does not compose inside a flat
    preconditioner apply. Only banded matrices are handled so far; any
    other pattern raises NotImplementedError."""
    device = default_device(device)
    n_diags = count_diagonals(m)
    if n_diags <= max_diags:
        return _dia_operator(m, max_diags, prefer_kernels, device)
    raise NotImplementedError(
        f"optimize(): {n_diags} diagonals (> max_diags={max_diags}); the "
        "non-banded layouts (RCM, BSR, hybrid, ELL) are ROADMAP.md Queue 1 item 9"
    )
