"""BSR (block sparse row): dense (bs × bs) blocks for general sparsity.

Counterpart of ``sprsolve_tpu/sparse/bsr.py``: the nonzeros are grouped
into dense blocks, and the SpMV becomes a gather of x blocks (contiguous
bs-element rows), one batched block·vector product and a sum of the
products into their block rows.  The JAX package's einsum becomes
:func:`full_precision_bmm` (TF32 off, so a float32 product rounds like the
float32 reference) and its ``segment_sum`` an ``index_add_`` over the
sorted block rows.  ``index_add_`` sums with float atomics on a GPU: the
order, and so the last bits, may change from call to call there.

The JAX package computes BSR with XLA ops, not a Pallas kernel (its kernel
was measured slower and deleted, ``bsr.py:28-35``), so the port's apply is
torch ops too.  :class:`ComplexBSR` keeps the two real block planes and
combines them before the row sum (``bsr.py:262-265``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..vecalg import full_precision_matmul
from .containers import CSR, _host


def full_precision_bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.bmm`` with TF32 off for the call: a float32 product on the
    card then rounds like the float32 reference, not to a 10-bit mantissa."""
    return full_precision_matmul(a, b)


def _block_keys(m: CSR, bs: int):
    """(rows, cols, block key, nb) of ``m``'s entries for blocking by ``bs``."""
    nb = -(-m.shape[0] // bs)
    rows = np.asarray(_host(m.row_ids), np.int64)
    cols = np.asarray(_host(m.indices), np.int64)
    return rows, cols, (rows // bs) * nb + cols // bs, nb


def _block_diagonal(planes, blk_row, blk_col, bs: int, n: int) -> np.ndarray:
    """The diagonal of block planes (host arrays), zero where no diagonal
    block is stored; ``planes`` of one real or two (re, im) arrays."""
    on_diag = blk_row == blk_col
    brows = blk_row[on_diag]
    idx = (brows[:, None] * bs + np.arange(bs)).reshape(-1)
    vals = [p[on_diag][:, np.arange(bs), np.arange(bs)].reshape(-1) for p in planes]
    dt = vals[0].dtype if len(planes) == 1 else np.result_type(vals[0].dtype, np.complex64)
    diag = np.zeros(-(-n // bs) * bs, dtype=dt)
    diag[idx] = vals[0] if len(planes) == 1 else vals[0] + 1j * vals[1]
    return diag[:n]


@dataclasses.dataclass(frozen=True)
class BSR:
    """Dense-block sparse matrix: ``blocks[k]`` sits at block row
    ``blk_row[k]`` (sorted) and block column ``blk_col[k]``; vectors are the
    logical length n (padded to ``padded_dim`` inside the apply)."""

    blocks: torch.Tensor    # (nblk, bs, bs)
    blk_row: torch.Tensor   # (nblk,) int64, sorted
    blk_col: torch.Tensor   # (nblk,) int64
    padded_dim: int         # nb·bs
    n: int                  # logical dimension

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n, self.n)

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks.dtype

    @property
    def device(self) -> torch.device:
        return self.blocks.device

    @property
    def bs(self) -> int:
        return self.blocks.shape[1]

    @property
    def nblk(self) -> int:
        return self.blocks.shape[0]

    @property
    def fill_ratio(self) -> float:
        """Share of stored block entries that are nonzero."""
        return float((self.blocks != 0).sum()) / self.blocks.numel() if self.nblk else 0.0

    @staticmethod
    def estimate_blocks(m: CSR, bs: int) -> int:
        """Number of (bs × bs) blocks the pattern touches, without building
        them (the cost model of ``optimize()``)."""
        return int(np.unique(_block_keys(m, bs)[2]).size)

    @staticmethod
    def from_csr(m: CSR, bs: int = 128, device=None) -> "BSR":
        """Block ``m`` on the host; the tensors land on ``device`` (by
        default the CSR's)."""
        rows, cols, key, nb = _block_keys(m, bs)
        dat = _host(m.data)
        uniq, inv = np.unique(key, return_inverse=True)
        blocks = np.zeros((len(uniq), bs, bs), dtype=dat.dtype)
        blocks[inv, rows % bs, cols % bs] = dat
        dev = m.device if device is None else device
        # np.unique sorts the keys, so blk_row comes out ascending
        return BSR(blocks=torch.as_tensor(blocks, device=dev),
                   blk_row=torch.as_tensor(uniq // nb, device=dev),
                   blk_col=torch.as_tensor(uniq % nb, device=dev),
                   padded_dim=nb * bs, n=m.shape[0])

    def _gather(self, x: torch.Tensor) -> torch.Tensor:
        """x padded to ``padded_dim``, as (nb, bs, ...) rows, gathered at
        the block columns: (nblk, bs, ...)."""
        pad = (0, 0) * (x.dim() - 1) + (0, self.padded_dim - self.n)
        return F.pad(x, pad).reshape(-1, self.bs, *x.shape[1:])[self.blk_col]

    def _row_sum(self, prod: torch.Tensor) -> torch.Tensor:
        """Σ of the (nblk, bs, ...) products into their block rows, cut to n."""
        out = torch.zeros((self.padded_dim // self.bs, *prod.shape[1:]), dtype=prod.dtype,
                          device=prod.device)
        out.index_add_(0, self.blk_row, prod)
        return out.reshape(self.padded_dim, *prod.shape[2:])[: self.n]

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """y = A·x on a length-n vector."""
        dt = torch.promote_types(self.dtype, x.dtype)
        g = self._gather(x).to(dt).unsqueeze(-1)
        return self._row_sum(full_precision_bmm(self.blocks.to(dt), g).squeeze(-1))

    def matvec_dot(self, x: torch.Tensor):
        from ..vecalg import conj_dot

        y = self.matvec(x)
        return y, conj_dot(x, y)

    def matmat(self, X: torch.Tensor) -> torch.Tensor:
        """Y = A·X on an (n, k) block of vectors."""
        dt = torch.promote_types(self.dtype, X.dtype)
        return self._row_sum(full_precision_bmm(self.blocks.to(dt), self._gather(X).to(dt)))

    def diagonal(self) -> torch.Tensor:
        """The main diagonal (host-side extraction, on the blocks' device)."""
        d = _block_diagonal([_host(self.blocks)], _host(self.blk_row), _host(self.blk_col),
                            self.bs, self.n)
        return torch.as_tensor(d, device=self.device)

    def jacobi_precond(self):
        """Diagonal preconditioner on the flat layout (a zero diagonal → 1)."""
        from ..precond import DiagPrecond

        d = self.diagonal()
        one = torch.ones((), dtype=d.dtype, device=d.device)
        return DiagPrecond(diag_inv=one / torch.where(d == 0, one, d))


@dataclasses.dataclass(frozen=True)
class ComplexBSR:
    """Two-plane BSR for complex matrices: real ``blocks_re`` and
    ``blocks_im`` over one union block pattern. The apply gathers x's real
    and imaginary planes as a k = 2 right-hand side, takes one batched
    product per plane, combines y_re = A_re·x_re − A_im·x_im and y_im =
    A_re·x_im + A_im·x_re before the row sum, and returns a complex vector."""

    blocks_re: torch.Tensor   # (nblk, bs, bs)
    blocks_im: torch.Tensor   # (nblk, bs, bs)
    blk_row: torch.Tensor     # (nblk,) int64, sorted
    blk_col: torch.Tensor     # (nblk,) int64
    padded_dim: int
    n: int

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n, self.n)

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks_re.dtype.to_complex()

    @property
    def device(self) -> torch.device:
        return self.blocks_re.device

    @property
    def bs(self) -> int:
        return self.blocks_re.shape[1]

    @property
    def nblk(self) -> int:
        return self.blocks_re.shape[0]

    @staticmethod
    def from_csr(m: CSR, bs: int = 128, device=None) -> "ComplexBSR":
        rows, cols, key, nb = _block_keys(m, bs)
        dat = _host(m.data)
        uniq, inv = np.unique(key, return_inverse=True)
        planes = []
        for part in (dat.real, dat.imag):
            p = np.zeros((len(uniq), bs, bs), dtype=dat.real.dtype)
            p[inv, rows % bs, cols % bs] = part
            planes.append(p)
        dev = m.device if device is None else device
        return ComplexBSR(blocks_re=torch.as_tensor(planes[0], device=dev),
                          blocks_im=torch.as_tensor(planes[1], device=dev),
                          blk_row=torch.as_tensor(uniq // nb, device=dev),
                          blk_col=torch.as_tensor(uniq % nb, device=dev),
                          padded_dim=nb * bs, n=m.shape[0])

    def _as_real(self) -> BSR:
        """The re plane as a :class:`BSR`, for its gather and row sum."""
        return BSR(blocks=self.blocks_re, blk_row=self.blk_row, blk_col=self.blk_col,
                   padded_dim=self.padded_dim, n=self.n)

    def _planes_apply(self, xr: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
        """(n, ..., 2)-shaped [y_re, y_im] for real planes (n, ...) of x."""
        re = self._as_real()
        k = xr[0].numel()
        g = re._gather(torch.stack([xr, xi], dim=-1)).reshape(self.nblk, self.bs, 2 * k)
        pr = full_precision_bmm(self.blocks_re.to(g.dtype), g).reshape(self.nblk, self.bs, -1, 2)
        pi = full_precision_bmm(self.blocks_im.to(g.dtype), g).reshape(self.nblk, self.bs, -1, 2)
        # combine the planes before the row sum (linear; half the summing)
        stacked = torch.stack([pr[..., 0] - pi[..., 1], pr[..., 1] + pi[..., 0]], dim=-1)
        return re._row_sum(stacked).reshape(self.n, *xr.shape[1:], 2)

    def _apply(self, x: torch.Tensor) -> torch.Tensor:
        xr = x.real if x.is_complex() else x
        xi = x.imag if x.is_complex() else torch.zeros_like(x)
        rdt = torch.promote_types(self.blocks_re.dtype, xr.dtype)
        y = self._planes_apply(xr.to(rdt), xi.to(rdt))
        return torch.complex(y[..., 0], y[..., 1])

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """y = A·x on a length-n complex vector."""
        return self._apply(x)

    def matvec_dot(self, x: torch.Tensor):
        from ..vecalg import conj_dot

        y = self.matvec(x)
        return y, conj_dot(x, y)

    def matmat(self, X: torch.Tensor) -> torch.Tensor:
        """Y = A·X on an (n, k) block of complex vectors."""
        return self._apply(X)

    def diagonal(self) -> torch.Tensor:
        """The complex diagonal (host-side extraction, on the blocks' device)."""
        d = _block_diagonal([_host(self.blocks_re), _host(self.blocks_im)],
                            _host(self.blk_row), _host(self.blk_col), self.bs, self.n)
        return torch.as_tensor(d, device=self.device)

    def jacobi_precond(self):
        """Complex Jacobi on the flat layout (a zero diagonal → 1)."""
        from ..precond import ComplexDiagPrecond

        d = self.diagonal()
        return ComplexDiagPrecond.new(torch.where(d == 0, torch.ones_like(d), d))
