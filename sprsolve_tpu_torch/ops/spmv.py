"""SpMV as plain torch ops — the oracles of the hand kernels.

Counterpart of ``sprsolve_tpu/ops/spmv.py`` (the pure-XLA paths):

- ``spmv_csr``: gather x at the column indices, multiply, and sum each row's
  segment. ``torch.segment_reduce`` sums every segment in entry order, so the
  result does not depend on scheduling (``index_add_`` would use float
  atomics on a GPU).
- ``spmv_dia``: y[i] = Σ_d bands[d, i] · x[i + off_d] from contiguous
  shifted slices, no gathers.
- ``spmv_ell``: gather x at the (n, k) column slab and sum each row over its
  k slots left to right (:func:`row_sum`, the order XLA takes); no
  scatter, so it is deterministic on a GPU too.
"""

from __future__ import annotations

import torch

from ..sparse.containers import CSR, DIA, ELL


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


def spmm_dia(m: DIA, X: torch.Tensor) -> torch.Tensor:
    """Y = A·X for DIA with X of shape (n, k) (``sprsolve_tpu/ops/spmv.py:63``):
    :func:`spmv_dia`'s band loop over all columns at once. The sums run on
    the transposed block, whose rows are contiguous like a vector, so each
    column takes the same multiply-adds as ``spmv_dia`` and equals it bit
    for bit."""
    n = m.shape[0]
    dt = torch.promote_types(m.dtype, X.dtype)
    Xt = X.t().to(dt).contiguous()
    Y = torch.zeros((X.shape[1], n), dtype=dt, device=X.device)
    for d, off in enumerate(m.offsets):
        if off >= 0:
            shifted = torch.nn.functional.pad(Xt[:, off:], (0, off))
        else:
            shifted = torch.nn.functional.pad(Xt[:, :off], (-off, 0))
        Y = torch.addcmul(Y, m.bands[d].to(dt), shifted)
    return Y.t().contiguous()


def row_sum(p: torch.Tensor) -> torch.Tensor:
    """Σ_j p[:, j], the slots added strictly left to right (``torch.sum``
    may add them in another order, and the exact Gauss-Seidel fixed points
    depend on the order)."""
    acc = torch.zeros(p.shape[0], dtype=p.dtype, device=p.device)
    for j in range(p.shape[1]):
        acc = acc + p[:, j]
    return acc


def spmv_ell(m: ELL, x: torch.Tensor) -> torch.Tensor:
    """y = A·x for ELL: an (n, k) gather, then a row sum over the k slots."""
    return row_sum(m.data * x[m.cols])
