"""Sparse containers as frozen dataclasses of tensors.

PyTorch counterpart of ``sprsolve_tpu/sparse/containers.py``, the part the
first slice needs: COO (build format), CSR and DIA.

- Analysis and conversion (duplicate summing, band extraction) run on the
  host in NumPy, as in the JAX package.
- The containers hold tensors, on the CPU unless a ``device`` is given;
  ``to(device)`` moves one.
- ``CSR.matvec`` is a gather and a per-row segment sum, the counterpart of
  the XLA gather + ``segment_sum``.  It is no hand kernel, as the JAX
  package leaves it to XLA.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


def _host(a) -> np.ndarray:
    """A host NumPy view of a tensor or array-like."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _scatter_sum(idx, dat, size):
    """Host-side duplicate-summing scatter: out[idx[k]] += dat[k]
    (``np.bincount``; complex sums in two passes)."""
    idx = np.asarray(idx, np.int64)
    if np.iscomplexobj(dat):
        out = np.bincount(idx, weights=dat.real, minlength=size).astype(dat.dtype)
        out += 1j * np.bincount(idx, weights=dat.imag, minlength=size)
        return out
    return np.bincount(idx, weights=dat, minlength=size).astype(dat.dtype)


@dataclasses.dataclass(frozen=True)
class COO:
    """Coordinate-format sparse matrix (host arrays). Duplicate (row, col)
    entries sum."""

    data: np.ndarray
    row: np.ndarray
    col: np.ndarray
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return len(self.data)

    def to_csr(self, device=None) -> "CSR":
        return CSR.from_coo(self, device=device)


@dataclasses.dataclass(frozen=True)
class CSR:
    """CSR with a precomputed flat ``row_ids`` companion.

    ``indptr`` (int64) drives the per-row sum of :meth:`matvec`;
    ``row_ids`` serves host analysis (diagonals, band extraction).
    """

    data: torch.Tensor      # (nnz,)
    indices: torch.Tensor   # (nnz,) int64 column index per entry
    indptr: torch.Tensor    # (n_rows + 1,) int64
    row_ids: torch.Tensor   # (nnz,) int64 row index per entry
    shape: Tuple[int, int]

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def nnz(self) -> int:
        return self.data.shape[0]

    @staticmethod
    def from_arrays(data, indices, indptr, shape, device=None) -> "CSR":
        indptr_np = _host(indptr).astype(np.int64)
        row_ids = np.repeat(np.arange(shape[0], dtype=np.int64), np.diff(indptr_np))
        as_t = lambda a: torch.as_tensor(a, device=device)
        return CSR(
            data=as_t(np.ascontiguousarray(_host(data))),
            indices=as_t(_host(indices).astype(np.int64)),
            indptr=as_t(indptr_np),
            row_ids=as_t(row_ids),
            shape=(int(shape[0]), int(shape[1])),
        )

    @staticmethod
    def from_coo(m: COO, device=None) -> "CSR":
        row = np.asarray(m.row, np.int64)
        col = np.asarray(m.col, np.int64)
        dat = np.asarray(m.data)
        # np.unique sorts the keys, which is the row-major (row, col) order
        key = row * m.shape[1] + col
        uniq, inv = np.unique(key, return_inverse=True)
        dat_sum = _scatter_sum(inv, dat, len(uniq))
        row_u = uniq // m.shape[1]
        col_u = uniq % m.shape[1]
        indptr = np.zeros(m.shape[0] + 1, dtype=np.int64)
        indptr[1:] = np.cumsum(np.bincount(row_u, minlength=m.shape[0]))
        return CSR.from_arrays(dat_sum, col_u, indptr, m.shape, device=device)

    def to(self, device) -> "CSR":
        return dataclasses.replace(
            self, data=self.data.to(device), indices=self.indices.to(device),
            indptr=self.indptr.to(device), row_ids=self.row_ids.to(device),
        )

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        from ..ops.spmv import spmv_csr

        return spmv_csr(self, x)

    def matvec_dot(self, x: torch.Tensor):
        from ..vecalg import conj_dot

        y = self.matvec(x)
        return y, conj_dot(x, y)

    def to_dia(self, device=None) -> "DIA":
        return DIA.from_csr(self, device=device)

    def diagonal(self) -> torch.Tensor:
        """The main diagonal (host-side extraction, on the matrix's device)."""
        return torch.as_tensor(self.diagonal_host(), device=self.device)

    def diagonal_host(self) -> np.ndarray:
        rows, cols, dat = _host(self.row_ids), _host(self.indices), _host(self.data)
        on_diag = rows == cols
        return _scatter_sum(rows[on_diag], dat[on_diag], self.shape[0])


@dataclasses.dataclass(frozen=True)
class DIA:
    """Offset-diagonal storage: y[i] = Σ_d bands[d, i] · x[i + offsets[d]].

    Band values are stored at their *row* index; entries whose column
    ``i + off`` falls outside [0, n) are zero.
    """

    bands: torch.Tensor       # (n_diags, n_rows)
    offsets: Tuple[int, ...]
    shape: Tuple[int, int]

    @property
    def dtype(self) -> torch.dtype:
        return self.bands.dtype

    @property
    def device(self) -> torch.device:
        return self.bands.device

    @staticmethod
    def arrays_from_csr(m: CSR, max_diags: int = 64):
        """Host-side band extraction: (bands ndarray, offsets tuple)
        (``sprsolve_tpu/sparse/containers.py:326-345``)."""
        row = _host(m.row_ids).astype(np.int64)
        col = _host(m.indices).astype(np.int64)
        dat = _host(m.data)
        offs = np.unique(col - row)
        if len(offs) > max_diags:
            raise ValueError(
                f"matrix has {len(offs)} distinct diagonals (> {max_diags}); "
                "DIA is only efficient for banded/stencil matrices"
            )
        n = m.shape[0]
        drow = np.searchsorted(offs, col - row)
        bands = _scatter_sum(drow * n + row, dat, len(offs) * n).reshape(len(offs), n)
        return bands, tuple(int(o) for o in offs)

    @staticmethod
    def from_csr(m: CSR, max_diags: int = 64, device=None) -> "DIA":
        bands, offsets = DIA.arrays_from_csr(m, max_diags=max_diags)
        dev = m.device if device is None else device
        return DIA(bands=torch.as_tensor(bands, device=dev), offsets=offsets,
                   shape=m.shape)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        from ..ops.spmv import spmv_dia

        return spmv_dia(self, x)

    def matvec_dot(self, x: torch.Tensor):
        from ..vecalg import conj_dot

        y = self.matvec(x)
        return y, conj_dot(x, y)

    def diagonal(self) -> torch.Tensor:
        if 0 in self.offsets:
            return self.bands[self.offsets.index(0)]
        return torch.zeros(self.shape[0], dtype=self.dtype, device=self.device)


def csr_from_scipy(m, device=None) -> CSR:
    """Build from a scipy.sparse matrix (any format)."""
    m = m.tocsr()
    return CSR.from_arrays(m.data, m.indices, m.indptr, m.shape, device=device)


def csr_from_dense(a, device=None) -> CSR:
    """Build from a dense array (test convenience)."""
    a = _host(a)
    nz = np.nonzero(a)
    return CSR.from_coo(COO(data=a[nz], row=nz[0], col=nz[1], shape=a.shape),
                        device=device)
