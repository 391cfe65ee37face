"""Sparse containers as frozen dataclasses of tensors.

PyTorch counterpart of ``sprsolve_tpu/sparse/containers.py``: COO (build
format), CSR and CSC (interchange), ELL and DIA (execution layouts).

- Analysis and conversion (duplicate summing, band extraction) run on the
  host in NumPy, as in the JAX package.
- The containers hold tensors, on the CPU unless a ``device`` is given;
  ``to(device)`` moves one.
- ``CSR.matvec`` is a gather and a per-row segment sum, the counterpart of
  the XLA gather + ``segment_sum``; ``ELL.matvec`` a gather and a row sum
  over the k slots.  Neither is a hand kernel, as the JAX package leaves
  both to XLA.
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

    def to_ell(self, k: int | None = None, device=None) -> "ELL":
        return ELL.from_csr(self, k=k, device=device)

    def transpose(self, conj: bool = False) -> "CSR":
        """Aᵀ (or Aᴴ with ``conj=True``) as a new CSR on the same device,
        built on the host in NumPy; rectangular matrices too. Built once at
        setup, the adjoint pairs with LSQR (no transposed gather per
        iteration)."""
        rows, cols = _host(self.row_ids), _host(self.indices)
        dat = _host(self.data)
        if conj:
            dat = np.conj(dat)
        order = np.lexsort((rows, cols))
        m, n = self.shape
        indptr = np.zeros(n + 1, dtype=np.int64)
        indptr[1:] = np.cumsum(np.bincount(cols, minlength=n))
        return CSR.from_arrays(dat[order], rows[order], indptr, (n, m),
                               device=self.device)

    def adjoint(self) -> "CSR":
        """Aᴴ = conj(A)ᵀ (:meth:`transpose` for a real dtype)."""
        return self.transpose(conj=True)

    def diagonal(self) -> torch.Tensor:
        """The main diagonal (host-side extraction, on the matrix's device)."""
        return torch.as_tensor(self.diagonal_host(), device=self.device)

    def diagonal_host(self) -> np.ndarray:
        rows, cols, dat = _host(self.row_ids), _host(self.indices), _host(self.data)
        on_diag = rows == cols
        return _scatter_sum(rows[on_diag], dat[on_diag], self.shape[0])


@dataclasses.dataclass(frozen=True)
class ELL:
    """ELLPACK: each row padded to ``k`` slots, pad slots (col 0, value 0).

    Built once on the host from a CSR (``sprsolve_tpu/sparse/containers.py:234-304``);
    the exact Gauss-Seidel sweep and the multicolor sweep read its slabs."""

    data: torch.Tensor   # (n_rows, k)
    cols: torch.Tensor   # (n_rows, k) int64
    shape: Tuple[int, int]

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    @staticmethod
    def arrays_from_csr(m: CSR, k: int | None = None):
        """Host-side build: the (data, cols) slabs as NumPy arrays."""
        indptr = _host(m.indptr).astype(np.int64)
        counts = np.diff(indptr)
        kmax = int(counts.max()) if len(counts) else 0
        k = kmax if k is None else k
        if k < kmax:
            raise ValueError(f"k={k} < max row nnz {kmax}")
        n = m.shape[0]
        flat = _host(m.data)
        data = np.zeros((n, k), dtype=flat.dtype)
        cols = np.zeros((n, k), dtype=np.int64)
        # each entry's slot within its row
        slot = np.arange(len(flat)) - np.repeat(indptr[:-1], counts)
        rows = np.repeat(np.arange(n), counts)
        data[rows, slot] = flat
        cols[rows, slot] = _host(m.indices)
        return data, cols

    @staticmethod
    def from_csr(m: CSR, k: int | None = None, device=None) -> "ELL":
        data, cols = ELL.arrays_from_csr(m, k)
        dev = m.device if device is None else device
        return ELL(data=torch.as_tensor(data, device=dev),
                   cols=torch.as_tensor(cols, device=dev), shape=m.shape)

    def to(self, device) -> "ELL":
        return dataclasses.replace(self, data=self.data.to(device),
                                   cols=self.cols.to(device))

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        from ..ops.spmv import spmv_ell

        return spmv_ell(self, x)

    def matvec_dot(self, x: torch.Tensor):
        from ..vecalg import conj_dot

        y = self.matvec(x)
        return y, conj_dot(x, y)

    def diagonal(self) -> torch.Tensor:
        rows = torch.arange(self.shape[0], device=self.device)[:, None]
        return torch.sum(torch.where(self.cols == rows, self.data,
                                     torch.zeros((), dtype=self.dtype,
                                                 device=self.device)), dim=1)


@dataclasses.dataclass(frozen=True)
class CSC:
    """Compressed sparse column, an interchange format
    (``sprsolve_tpu/sparse/containers.py:377-446``): solves convert it to
    CSR. Its own SpMV is a gather and a scatter-add over rows (the
    reference's per-column accumulation, ``src/mat.rs:130-142``)."""

    data: torch.Tensor     # (nnz,)
    indices: torch.Tensor  # (nnz,) int64 row index per entry
    indptr: torch.Tensor   # (n_cols + 1,) int64
    col_ids: torch.Tensor  # (nnz,) int64 column index per entry
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
    def from_arrays(data, indices, indptr, shape, device=None) -> "CSC":
        indptr_np = _host(indptr).astype(np.int64)
        col_ids = np.repeat(np.arange(shape[1], dtype=np.int64), np.diff(indptr_np))
        as_t = lambda a: torch.as_tensor(a, device=device)
        return CSC(
            data=as_t(np.ascontiguousarray(_host(data))),
            indices=as_t(_host(indices).astype(np.int64)),
            indptr=as_t(indptr_np),
            col_ids=as_t(col_ids),
            shape=(int(shape[0]), int(shape[1])),
        )

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        # index_add_ sums with float atomics on a GPU: the order, and so the
        # last bits, may change from call to call there
        contrib = self.data * x[self.col_ids]
        y = torch.zeros(self.shape[0], dtype=contrib.dtype, device=contrib.device)
        return y.index_add_(0, self.indices, contrib)

    def matvec_dot(self, x: torch.Tensor):
        from ..vecalg import conj_dot

        y = self.matvec(x)
        return y, conj_dot(x, y)

    def to_csr(self) -> CSR:
        coo = COO(data=_host(self.data), row=_host(self.indices),
                  col=_host(self.col_ids), shape=self.shape)
        return CSR.from_coo(coo, device=self.device)


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


def reorder_rcm(m: CSR):
    """Symmetric RCM reordering (``sprsolve_tpu/sparse/containers.py:449-472``):
    returns (permuted CSR, perm) with A'[i, j] = A[perm[i], perm[j]], on
    the host and then on ``m``'s device. Solve with A' and b[perm], then
    undo with x[inv_perm]."""
    from ..native import rcm_order, symmetrize_pattern

    n = m.shape[0]
    sym_indptr, sym_indices = symmetrize_pattern(n, _host(m.indptr), _host(m.indices))
    perm = rcm_order(n, sym_indptr, sym_indices)
    inv = np.empty(n, dtype=np.int64)
    inv[perm] = np.arange(n)
    coo = COO(data=_host(m.data), row=inv[_host(m.row_ids)], col=inv[_host(m.indices)],
              shape=m.shape)
    return CSR.from_coo(coo, device=m.device), perm


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
