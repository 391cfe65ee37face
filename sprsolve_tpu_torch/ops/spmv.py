"""SpMV as plain torch ops — the oracles of the hand kernels.

Counterpart of ``sprsolve_tpu/ops/spmv.py`` (the pure-XLA paths):

- ``spmv_csr``: gather x at the column indices, multiply, and sum each row's
  segment. ``torch.segment_reduce`` sums every segment in entry order, so the
  result does not depend on scheduling (``index_add_`` would use float
  atomics on a GPU).
- ``spmv_dia``: y[i] = Σ_d bands[d, i] · x[i + off_d] from contiguous
  shifted slices, no gathers.
"""

from __future__ import annotations

import torch

from ..sparse.containers import CSR, DIA


def spmv_csr(m: CSR, x: torch.Tensor) -> torch.Tensor:
    """y = A·x for CSR. Rows with no entries produce 0."""
    contrib = m.data * x[m.indices]
    if contrib.is_complex():
        # segment_reduce takes real data only: sum the two planes
        re = torch.segment_reduce(contrib.real, "sum", offsets=m.indptr)
        im = torch.segment_reduce(contrib.imag, "sum", offsets=m.indptr)
        return torch.complex(re, im)
    return torch.segment_reduce(contrib, "sum", offsets=m.indptr)


def spmv_dia(m: DIA, x: torch.Tensor) -> torch.Tensor:
    """y = A·x for DIA: y[i] = Σ_d bands[d, i] · x[i + off_d], zero beyond
    the ends. The multiply-add is fused as XLA fuses it."""
    n = m.shape[0]
    dt = torch.promote_types(m.dtype, x.dtype)
    y = torch.zeros(n, dtype=dt, device=x.device)
    for d, off in enumerate(m.offsets):
        if off >= 0:
            shifted = torch.nn.functional.pad(x[off:], (0, off))
        else:
            shifted = torch.nn.functional.pad(x[:off], (-off, 0))
        y = torch.addcmul(y, m.bands[d].to(dt), shifted.to(dt))
    return y
