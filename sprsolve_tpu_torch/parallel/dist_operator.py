"""Row-partitioned distributed operators on a ``torch.distributed`` group.

Counterpart of ``sprsolve_tpu/parallel/dist_operator.py``. Each rank owns a
contiguous block of matrix rows and the matching block of every solver
vector. Three operators, all plain torch ops (the JAX package computes them
with XLA ops, not Pallas):

- :class:`AllGatherELL` — any sparsity: x is all-gathered over the group,
  the rank's rows then take a plain ELL SpMV against the whole vector.
- :class:`HaloDIA` — banded matrices: only the h = max|offset| boundary
  entries move, one neighbour exchange per SpMV (:func:`comm.halo_exchange`).
  The rank builds the window [left halo, its rows, right halo] and runs
  the band loop of :func:`~sprsolve_tpu_torch.ops.spmv.spmv_dia` on it, so
  each row is summed in the same band order as on one device, bit for bit.
- :class:`MPKDIA` — HaloDIA plus band windows ``ext`` rows wider on each
  side: the matrix-powers operator of the s-step solvers, one exchange for
  a whole chain of ``ext // h`` applications.

An operator is built globally on the host by :func:`partition_csr`,
:func:`partition_dia` or :func:`partition_dia_mpk` (every rank builds the
same one), and ``pspec()`` gives the dimension of each field that is cut
into the ranks' row blocks; ``parallel.solve.local_part`` cuts out a rank's
part and binds it to the group. Row blocks are padded with identity rows
(and zero rhs entries) to make n divisible by the group's size: zeros
propagate through every Krylov recurrence, so the padding is exact.
(``auto_mesh`` is a JAX artefact and has no counterpart.)
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..ops.spmv import row_sum
from ..sparse.containers import CSR, DIA, ELL, _host
from ..vecalg import conj_dot
from . import comm


def band_rows(bands: torch.Tensor, W: torch.Tensor, offsets, h: int, m: int) -> torch.Tensor:
    """Rows i < m of Σ_d bands[d, i] · W[h + i + off_d]: the band loop of
    ``spmv_dia``/``spmm_dia`` (multiply-adds fused, bands in order) on a
    window ``W`` whose row h is the first output row. A block ``W`` (rows,
    k) runs transposed, as ``spmm_dia`` does, so each column is bitwise the
    vector's result."""
    dt = torch.promote_types(bands.dtype, W.dtype)
    if W.dim() == 1:
        y = torch.zeros(m, dtype=dt, device=W.device)
        for d, off in enumerate(offsets):
            y = torch.addcmul(y, bands[d].to(dt), W[h + off: h + off + m].to(dt))
        return y
    Wt = W.t().to(dt).contiguous()
    Y = torch.zeros((W.shape[1], m), dtype=dt, device=W.device)
    for d, off in enumerate(offsets):
        Y = torch.addcmul(Y, bands[d].to(dt), Wt[:, h + off: h + off + m])
    return Y.t().contiguous()


@dataclasses.dataclass(frozen=True)
class AllGatherELL:
    """The rank's rows as ELL over an all-gathered x. General sparsity.

    ``data``/``cols`` are (n_pad, k) globally and (n_pad / world, k) on a
    rank; ``cols`` holds *global* column ids."""

    data: torch.Tensor
    cols: torch.Tensor
    shape: Tuple[int, int]
    group: object = None

    @property
    def dtype(self):
        return self.data.dtype

    def pspec(self) -> "AllGatherELL":
        return dataclasses.replace(self, data=0, cols=0)

    def matvec(self, x_local: torch.Tensor) -> torch.Tensor:
        x_full = comm.all_gather_rows(x_local, self.group)
        return row_sum(self.data * x_full[self.cols])

    def matvec_dot(self, x_local: torch.Tensor):
        # the LOCAL partial dot: solvers sum it over the group
        y = self.matvec(x_local)
        return y, conj_dot(x_local, y)

    def matmat(self, X_local: torch.Tensor) -> torch.Tensor:
        """A·X for an (m, k) local block: ONE all-gather covers all k
        columns; each column is bitwise :meth:`matvec`'s."""
        X_full = comm.all_gather_rows(X_local, self.group)
        G = X_full[self.cols]                       # (m, k_slots, columns)
        acc = torch.zeros_like(G[:, 0])
        for j in range(G.shape[1]):                 # row_sum's slot order
            acc = acc + self.data[:, j, None] * G[:, j]
        return acc


@dataclasses.dataclass(frozen=True)
class HaloDIA:
    """The rank's rows of a banded matrix with a neighbour halo exchange.

    ``bands`` is (n_diags, n_pad) globally and (n_diags, m) on a rank (band
    values at their row index, so a rank's band block matches its rows).
    Requires max|offset| ≤ m."""

    bands: torch.Tensor
    offsets: Tuple[int, ...]
    shape: Tuple[int, int]
    group: object = None

    @property
    def dtype(self):
        return self.bands.dtype

    @property
    def halo(self) -> int:
        return max((abs(o) for o in self.offsets), default=0)

    def pspec(self) -> "HaloDIA":
        return dataclasses.replace(self, bands=1)

    def _window(self, X: torch.Tensor, h: int) -> torch.Tensor:
        """[previous rank's last h rows, X, next rank's first h rows]: one
        exchange; the global edges read zero (the DIA boundary convention)."""
        if h == 0:
            return X
        prev, nxt = comm.halo_exchange(X[:h], X[X.shape[0] - h:], self.group)
        return torch.cat([prev, X, nxt])

    def matvec(self, x_local: torch.Tensor) -> torch.Tensor:
        h = self.halo
        return band_rows(self.bands, self._window(x_local, h), self.offsets, h,
                         x_local.shape[0])

    def matvec_dot(self, x_local: torch.Tensor):
        y = self.matvec(x_local)
        return y, conj_dot(x_local, y)

    def matmat(self, X_local: torch.Tensor) -> torch.Tensor:
        """A·X for an (m, k) local block: ONE halo exchange of (h, k) slabs
        covers all k columns (vs k for a per-column ``matvec`` loop)."""
        h = self.halo
        return band_rows(self.bands, self._window(X_local, h), self.offsets, h,
                         X_local.shape[0])


def _padded_rows(n: int, world: int) -> int:
    return (n + world - 1) // world * world


def partition_csr(m: CSR, world: int) -> AllGatherELL:
    """CSR → row-padded global ELL, ready to cut into ``world`` row blocks.

    Pad rows are identity (a_ii = 1), so the padded system decouples; with
    zero rhs padding the extra coordinates stay exactly 0."""
    data, cols = ELL.arrays_from_csr(m)
    n = m.shape[0]
    n_pad = _padded_rows(n, world)
    if n_pad != n:
        extra = n_pad - n
        pad_data = np.zeros((extra, data.shape[1]), dtype=data.dtype)
        pad_cols = np.zeros((extra, data.shape[1]), dtype=np.int64)
        pad_data[:, 0] = 1.0
        pad_cols[:, 0] = np.arange(n, n_pad)
        data = np.concatenate([data, pad_data])
        cols = np.concatenate([cols, pad_cols])
    return AllGatherELL(data=torch.from_numpy(data), cols=torch.from_numpy(cols),
                        shape=(n_pad, n_pad))


def partition_dia(m: DIA, world: int) -> HaloDIA:
    """DIA → row-padded global banded layout, ready to cut into ``world``
    row blocks. Raises when the bandwidth exceeds a block."""
    n = m.shape[0]
    n_pad = _padded_rows(n, world)
    if 0 not in m.offsets:
        raise ValueError("partition_dia requires a stored main diagonal")
    bands = _host(m.bands)
    if n_pad != n:
        pad = np.zeros((bands.shape[0], n_pad - n), dtype=bands.dtype)
        pad[m.offsets.index(0), :] = 1.0  # identity pad rows
        bands = np.concatenate([bands, pad], axis=1)
    h = max(abs(o) for o in m.offsets)
    if h > n_pad // world:
        raise ValueError(
            f"bandwidth {h} exceeds rows-per-rank {n_pad // world}; "
            "use AllGatherELL or fewer ranks"
        )
    return HaloDIA(bands=torch.from_numpy(np.ascontiguousarray(bands)),
                   offsets=tuple(m.offsets), shape=(n_pad, n_pad))


@dataclasses.dataclass(frozen=True)
class MPKDIA:
    """HaloDIA plus per-rank EXTENDED band windows: the matrix-powers
    operator of the s-step Krylov methods.

    Each rank stores the bands of its rows AND of ``ext`` rows on each side
    (``bands_ext``), so one depth-``ext`` halo exchange of a vector
    (:meth:`mpk_extend`) lets it apply A locally ``ext // halo`` times
    (:meth:`mpk_apply`): application ℓ is exact on window rows
    [ℓ·h, L − ℓ·h), which holds the rank's rows while ℓ·h ≤ ext. Rows past
    the global edges read x = 0 and carry zero bands. That turns the s
    exchanges of s plain SpMVs into one.

    ``bands_ext`` is (n_diags, world, m + 2·ext) globally and (n_diags, 1,
    m + 2·ext) on a rank (``pspec`` cuts dim 1); ``matvec``/``matmat`` run
    a :class:`HaloDIA` view of the central columns, so every ordinary
    solver runs on this operator unchanged."""

    bands_ext: torch.Tensor
    offsets: Tuple[int, ...]
    shape: Tuple[int, int]
    ext: int
    group: object = None

    @property
    def dtype(self):
        return self.bands_ext.dtype

    @property
    def halo(self) -> int:
        return max((abs(o) for o in self.offsets), default=0)

    @property
    def max_power(self) -> int:
        """Exact local applications per exchange (ext // halo)."""
        h = self.halo
        return self.ext // h if h else 1 << 30

    def pspec(self) -> "MPKDIA":
        return dataclasses.replace(self, bands_ext=1)

    def _halo_view(self) -> HaloDIA:
        E, L = self.ext, self.bands_ext.shape[-1]
        return HaloDIA(bands=self.bands_ext[:, 0, E:L - E], offsets=self.offsets,
                       shape=self.shape, group=self.group)

    def matvec(self, x_local: torch.Tensor) -> torch.Tensor:
        return self._halo_view().matvec(x_local)

    def matvec_dot(self, x_local: torch.Tensor):
        return self._halo_view().matvec_dot(x_local)

    def matmat(self, X_local: torch.Tensor) -> torch.Tensor:
        return self._halo_view().matmat(X_local)

    def diagonal(self) -> torch.Tensor:
        E, L = self.ext, self.bands_ext.shape[-1]
        return self.bands_ext[self.offsets.index(0), 0, E:L - E]

    def mpk_extend(self, X_local: torch.Tensor) -> torch.Tensor:
        """The (m + 2·ext, ...) window: X with ``ext`` neighbour rows each
        side, ONE halo exchange for the whole power chain; the global edges
        read zero."""
        return self._halo_view()._window(X_local, self.ext)

    def mpk_apply(self, Xe: torch.Tensor) -> torch.Tensor:
        """One band product on the extended window, local compute only. Row
        j of the window is global row (start − ext + j); its result is exact
        wherever its inputs were (the window's edges shrink by the halo per
        application)."""
        h, L = self.halo, Xe.shape[0]
        pad = torch.zeros((h,) + tuple(Xe.shape[1:]), dtype=Xe.dtype, device=Xe.device)
        return band_rows(self.bands_ext[:, 0], torch.cat([pad, Xe, pad]), self.offsets,
                         h, L)

    def mpk_central(self, Xe: torch.Tensor) -> torch.Tensor:
        """The rank's own rows of a window vector."""
        return Xe[self.ext: Xe.shape[0] - self.ext]


def partition_dia_mpk(m: DIA, world: int, s: int) -> MPKDIA:
    """DIA → :class:`MPKDIA` with band windows for s-step methods
    (``ext = s · halo``); the identity row padding of :func:`partition_dia`."""
    base = partition_dia(m, world)
    bands = base.bands.numpy()
    E = int(s) * base.halo
    n_pad = base.shape[0]
    mm = n_pad // world
    if E > mm:
        raise ValueError(
            f"extension {E} = s·halo exceeds rows-per-rank {mm}; "
            "reduce s or use fewer ranks"
        )
    padded = np.zeros((bands.shape[0], n_pad + 2 * E), dtype=bands.dtype)
    padded[:, E:E + n_pad] = bands
    ext = np.empty((bands.shape[0], world, mm + 2 * E), dtype=bands.dtype)
    for i in range(world):
        ext[:, i, :] = padded[:, i * mm: i * mm + mm + 2 * E]
    return MPKDIA(bands_ext=torch.from_numpy(ext), offsets=base.offsets,
                  shape=base.shape, ext=E)
