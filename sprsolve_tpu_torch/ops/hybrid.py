"""Hybrid band+outlier operator: a banded core plus a small COO sidecar.

Counterpart of ``sprsolve_tpu/ops/hybrid.py:42-169``: a few long-range
entries (a constraint coupling, a periodic stitch) multiply the diagonal
count past every banded threshold.  :class:`HybridDIA` keeps the offsets
that earn their stream as a banded core — a ``PaddedDIA`` behind a
:class:`~sprsolve_tpu_torch.multigrid.FlatViewOperator` (kernel K1) for
float32 and float64, a ``DIA`` otherwise — and spills the rest to a
row-sorted COO sidecar applied with ``index_add_`` (float atomics on a
GPU: the order of duplicate rows' sums, and so the last bits, may change
from call to call).
``optimize()`` prices the sidecar per element and routes here only when
the split wins.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..sparse.containers import CSR, DIA, _host
from ..vecalg import conj_dot


def split_offsets(m: CSR, max_diags: int):
    """The band/sidecar split of ``m``: ``(kept, n_bands)``, whether each
    entry's offset col − row is kept as a band, and how many offsets are.

    An offset is kept when it earns its n-long stream: its entries must
    outnumber n·itemsize / (efficiency of the core) / (price of a sidecar
    entry), from ``optimize``'s cost table; the heaviest ``max_diags`` of
    those are kept, and offset 0 always is. (The counts come from a
    ``bincount`` over the offsets, in the order ``np.unique`` gives them.)"""
    from .optimize import COSTS

    n = m.shape[0]
    offs = np.asarray(_host(m.indices), np.int64) - np.asarray(_host(m.row_ids), np.int64)
    full = np.bincount(offs + (n - 1), minlength=n + m.shape[1] - 1)
    present = np.flatnonzero(full)           # the offsets in ascending order, + n − 1
    counts = full[present]
    itemsize = _host(m.data).dtype.itemsize
    min_count = max(4, int(n * itemsize / COSTS["eff_padded_dia"] / COSTS["scatter_bytes_eq"]))
    order = np.argsort(counts)[::-1]
    keep = np.zeros(len(full), dtype=bool)
    keep[present[order[counts[order] >= min_count][:max_diags]]] = True
    keep[n - 1] |= bool(full[n - 1])         # offset 0
    return keep[offs + (n - 1)], int(keep.sum())


@dataclasses.dataclass(frozen=True)
class HybridDIA:
    """Banded core (a flat-vector operator) plus a row-sorted COO sidecar.
    The operator works on flat vectors (no ``pad_vec``), so every solver
    and preconditioner composes with it unchanged."""

    core: object
    out_rows: torch.Tensor   # (m,) int64, sorted
    out_cols: torch.Tensor   # (m,) int64
    out_vals: torch.Tensor   # (m,)
    shape: Tuple[int, int]

    @property
    def dtype(self) -> torch.dtype:
        return self.out_vals.dtype

    @property
    def device(self) -> torch.device:
        return self.out_vals.device

    @property
    def n_outliers(self) -> int:
        return int(self.out_vals.shape[0])

    @staticmethod
    def from_csr(m: CSR, *, max_diags: int = 32, max_outliers: int | None = None,
                 prefer_kernels: bool = True, device=None) -> "HybridDIA":
        """Split ``m`` into its kept offsets (:func:`split_offsets`) and the
        rest, on ``device`` (by default the CSR's).

        Raises ``ValueError`` when the spill exceeds ``max_outliers``
        (default ``max(4096, nnz // 100)``): the pattern is then not
        "banded plus a few couplings", and other layouts should serve it."""
        from ..multigrid import FlatViewOperator
        from .padded_dia import REAL_DTYPES, PaddedDIA

        if max_outliers is None:
            max_outliers = max(4096, m.nnz // 100)
        kept, n_bands = split_offsets(m, max_diags)
        n_out = int((~kept).sum())
        if n_out > max_outliers:
            raise ValueError(f"hybrid split spills {n_out} entries (> {max_outliers}): "
                             "no dominant band structure")
        rows = _host(m.row_ids).astype(np.int64)
        cols = _host(m.indices).astype(np.int64)
        data = _host(m.data)
        n = m.shape[0]
        indptr = np.zeros(n + 1, dtype=np.int64)
        indptr[1:] = np.cumsum(np.bincount(rows[kept], minlength=n))
        core_csr = CSR.from_arrays(data[kept], cols[kept], indptr, m.shape)
        dev = m.device if device is None else torch.device(device)
        dia = DIA.from_csr(core_csr, max_diags=max(max_diags, n_bands), device="cpu")
        if prefer_kernels and dia.dtype in REAL_DTYPES:
            core = FlatViewOperator(op=PaddedDIA.from_dia(dia, device=dev))
        else:
            core = DIA(bands=dia.bands.to(dev), offsets=dia.offsets, shape=dia.shape)
        order = np.argsort(rows[~kept], kind="stable")
        as_t = lambda a: torch.as_tensor(np.ascontiguousarray(a[~kept][order]), device=dev)
        return HybridDIA(core=core, out_rows=as_t(rows), out_cols=as_t(cols),
                         out_vals=as_t(data), shape=m.shape)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        y = self.core.matvec(x)
        if self.n_outliers == 0:
            return y
        return y.index_add_(0, self.out_rows, self.out_vals * x[self.out_cols])

    def matvec_dot(self, x: torch.Tensor):
        y = self.matvec(x)
        return y, conj_dot(x, y)

    def matmat(self, X: torch.Tensor) -> torch.Tensor:
        return torch.stack([self.matvec(X[:, j]) for j in range(X.shape[1])], dim=1)

    def diagonal(self) -> torch.Tensor:
        # offset 0 is in the core by construction
        if hasattr(self.core, "diagonal"):
            return self.core.diagonal()
        return self.core.op.unpad_vec(self.core.op.diagonal_padded())
