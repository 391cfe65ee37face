"""The distributed kernel operators: K1-K7 per shard, fed by a halo exchange.

Counterpart of ``sprsolve_tpu/parallel/pallas_dist.py``. A rank holds its
row block in the padded layout of
:class:`~sprsolve_tpu_torch.ops.padded_dia.PaddedDIA`: bands ``(D,
r_local)`` and vectors ``(h + r_local + h,)`` with ``h`` zero halo slots on
each side, ``r_local`` whole row tiles and ``h ≤ r_local``. An SpMV is

    prev, next = halo_exchange(x[h: 2h], x[r_local: r_local + h])
    window     = [prev, body, next]           # a new tensor: x keeps its zero halo
    y          = kernel(bands_local, window)  # the single-GPU wrapper, unchanged

so the neighbours' entries live only in the window, never in a solver
vector: the vecalg dots sum whole padded vectors, and a halo left in one
would count a neighbour's edge. The kernels' outputs have a zero halo, and
their fused dots sum body rows only, so every partial is the rank's own.

Per shard: ``matvec`` → K1, ``matmat`` → K1b, ``matvec_dot`` → K3,
``matvec_wdot`` → K2 (no fold; ``w = None`` where w is the input),
``orth_norm`` → K4 (vectors need no exchange; one launch gives v₊ and the
rank's Σv₊² over its body rows);
complex ``matvec`` → K5, ``matvec_dot``/``matvec_conj_dot`` →
K6, ``matvec_wdot`` → K7 (no fold). As in the JAX package there is no
``matvec_wdot_prec``: folding Jacobi into the kernel input would need an
exchange of dinv ⊙ x, so the composed path (u = M⁻¹x, then K2 on u) runs
instead (``pallas_dist.py:207-212``).

The global layout, which ``pad_vec``/``unpad_vec`` and the Jacobi builders
use on the host, is the ranks' padded vectors one after another: a flat
``(world · (h + r_local + h),)`` tensor whose ``world`` equal blocks are the
ranks' vectors.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import fused
from ..ops import padded_dia as pd
from ..sparse.containers import DIA, _host
from ..vecalg import sqrt_exact
from . import comm


@dataclasses.dataclass(frozen=True)
class DistPaddedDIA:
    """Row-partitioned banded operator running K1-K4 per shard.

    ``bands`` is ``(D, world · r_local)`` globally (on the host, from
    :meth:`from_dia`) and ``(D, r_local)`` on a rank (``pspec`` cuts dim 1),
    stored as narrow as is exact (int8/bf16/f32 for f32 bands, as
    ``PaddedDIA``, decided once for all ranks)."""

    bands: torch.Tensor
    offsets: Tuple[int, ...]
    n: int                  # logical system size
    h: int                  # halo slots each side
    r_local: int            # rows per rank
    world: int
    vdtype: torch.dtype
    group: object = None

    @property
    def dtype(self) -> torch.dtype:
        return self.vdtype

    @property
    def shape(self) -> Tuple[int, int]:
        n_total = self.world * self.r_local
        return (n_total, n_total)

    @property
    def local_len(self) -> int:
        """Length of a rank's vector, h + r_local + h."""
        return self.r_local + 2 * self.h

    @property
    def padded_len(self) -> int:
        """Length of a global vector (the solvers' shape checks)."""
        return self.world * self.local_len

    def pspec(self) -> "DistPaddedDIA":
        return dataclasses.replace(self, bands=1)

    @staticmethod
    def from_dia(m: DIA, world_size: int) -> "DistPaddedDIA":
        """The global operator of ``m`` for ``world_size`` ranks, on the
        host. Raises when the halo exceeds a rank's rows."""
        bands = _host(m.bands)
        if bands.dtype not in (np.float32, np.float64):
            raise TypeError(f"bands must be float32 or float64, got {bands.dtype}")
        if len(m.offsets) > pd.MAX_DIAGS:
            raise ValueError(f"{len(m.offsets)} diagonals; the kernels take {pd.MAX_DIAGS}")
        n, world = m.shape[0], int(world_size)
        h, _ = pd.layout(n, m.offsets, bands.dtype.itemsize)
        per = -(-n // world)
        r_local = max(-(-per // pd.ROW_TILE) * pd.ROW_TILE, pd.ROW_TILE)
        if h > r_local:
            raise ValueError(
                f"halo {h} exceeds rows-per-rank {r_local}; fewer ranks required"
            )
        padded = np.zeros((bands.shape[0], world * r_local), dtype=bands.dtype)
        padded[:, :n] = bands
        return DistPaddedDIA(bands=pd.PaddedDIA._narrow_bands(torch.from_numpy(padded)),
                             offsets=tuple(m.offsets), n=n, h=h, r_local=r_local, world=world,
                             vdtype=torch.from_numpy(bands[:0]).dtype)

    # --- the global layout (host side) --------------------------------------
    def pad_vec(self, x: torch.Tensor) -> torch.Tensor:
        """(n,) → (world · (h + r_local + h),): each rank's rows with a zero
        halo, zero past row n. An (n, k) block of columns goes to
        (world · (h + r_local + h), k) the same way, row by row."""
        cols = x.reshape(x.shape[0], -1)
        flat = F.pad(cols, (0, 0, 0, self.world * self.r_local - self.n))
        blocks = F.pad(flat.reshape(self.world, self.r_local, -1), (0, 0, self.h, self.h))
        return blocks.reshape((-1,) + tuple(x.shape[1:]))

    def unpad_vec(self, x2: torch.Tensor) -> torch.Tensor:
        blocks = x2.reshape((self.world, self.local_len) + tuple(x2.shape[1:]))
        body = blocks[:, self.h: self.h + self.r_local]
        return body.reshape((-1,) + tuple(x2.shape[1:]))[: self.n]

    def diagonal_global(self) -> torch.Tensor:
        """The global diagonal in the global layout (zero halo and pads)."""
        if 0 in self.offsets:
            d = self.bands[self.offsets.index(0)].to(self.vdtype)
        else:
            d = torch.zeros(self.bands.shape[1], dtype=self.vdtype, device=self.bands.device)
        return F.pad(d.reshape(self.world, -1), (self.h, self.h)).reshape(-1)

    # --- the rank's operator -------------------------------------------------
    def window(self, x: torch.Tensor) -> torch.Tensor:
        """The kernel's input: x's body between the previous rank's last h
        rows and the next rank's first h (zeros at the global edges), one
        exchange; x itself is left as it was."""
        h, r = self.h, self.r_local
        if h == 0:
            return x
        prev, nxt = comm.halo_exchange(x[h: 2 * h], x[r: r + h], self.group)
        return torch.cat([prev, x[h: h + r], nxt])

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """K1 on the window. Real vectors, as in the JAX package: complex
        systems take :class:`DistComplexPaddedDIA`."""
        return pd.dia_spmv(self.bands, self.window(x), self.offsets, self.h)

    def matmat(self, X: torch.Tensor) -> torch.Tensor:
        """A·X for a rank's (h + r_local + h, k) block of padded columns in
        one K1b launch on its window, after one exchange of (h, k) slabs
        (block CG; the JAX package's distributed kernel layout has no block
        form). Each column is bitwise :meth:`matvec`'s."""
        return pd.dia_spmm(self.bands, self.window(X), self.offsets, self.h)

    def matvec_dot(self, x: torch.Tensor):
        """(A·x, the rank's partial of xᵀ(A·x)) in one pass (K3); solvers sum
        the partial over the group."""
        return pd.dia_dot(self.bands, self.window(x), self.offsets, self.h)

    def matvec_wdot(self, x: torch.Tensor, w: torch.Tensor):
        """(A·x, partials of wᵀ(A·x) and ‖A·x‖²) in one pass (K2). w needs
        no exchange: the dots read body rows only. ``w is x`` reads w from
        the window's body, which is x's."""
        return pd.dia_wdot(self.bands, self.window(x), None if w is x else w, None,
                           self.offsets, self.h)

    def orth_norm(self, a, vold, v, beta, alpha):
        """The fused Lanczos step (K4) with the rank's partial of Σv₊², which
        the one launch sums over the window's body rows; the vectors need no
        exchange."""
        return fused.orth_norm(a, vold, v, beta, alpha, self.h)


@dataclasses.dataclass(frozen=True)
class DistComplexPaddedDIA:
    """Row-partitioned complex banded operator: the two-plane kernels K5-K7
    per shard, fed by one exchange of the interleaved complex vector. ``re``
    and ``im`` are :class:`DistPaddedDIA` planes, each narrowed on its own."""

    re: DistPaddedDIA
    im: DistPaddedDIA

    @property
    def shape(self):
        return self.re.shape

    @property
    def n(self) -> int:
        return self.re.n

    @property
    def h(self) -> int:
        return self.re.h

    @property
    def offsets(self):
        return self.re.offsets

    @property
    def padded_len(self) -> int:
        return self.re.padded_len

    @property
    def dtype(self) -> torch.dtype:
        return self.re.vdtype.to_complex()

    def pspec(self) -> "DistComplexPaddedDIA":
        return DistComplexPaddedDIA(re=self.re.pspec(), im=self.im.pspec())

    @staticmethod
    def from_dia(m: DIA, world_size: int) -> "DistComplexPaddedDIA":
        bands = _host(m.bands)
        if bands.dtype not in (np.complex64, np.complex128):
            raise TypeError(f"bands must be complex64 or complex128, got {bands.dtype}")
        plane = lambda b: DistPaddedDIA.from_dia(
            DIA(bands=torch.from_numpy(np.ascontiguousarray(b)), offsets=m.offsets,
                shape=m.shape), world_size)
        return DistComplexPaddedDIA(re=plane(bands.real), im=plane(bands.imag))

    # --- the global layout (host side) --------------------------------------
    def pad_vec(self, x: torch.Tensor) -> torch.Tensor:
        return self.re.pad_vec(x)

    def unpad_vec(self, x2: torch.Tensor) -> torch.Tensor:
        return self.re.unpad_vec(x2)

    def diagonal_planes_global(self):
        """The re/im diagonal planes in the global layout."""
        return self.re.diagonal_global(), self.im.diagonal_global()

    def jacobi_precond(self):
        """Complex Jacobi in the global layout, 1/d = (d_re − i·d_im)/|d|²;
        halo and pad slots (zero diagonal) take 1 + 0i."""
        from ..precond import ComplexDiagPrecond

        dr, di = self.diagonal_planes_global()
        denom = dr * dr + di * di
        one = torch.ones((), dtype=dr.dtype, device=dr.device)
        zero = torch.zeros((), dtype=dr.dtype, device=dr.device)
        safe = torch.where(denom == 0, one, denom)
        inv_re = torch.where(denom == 0, one, dr) / safe
        inv_im = torch.where(denom == 0, zero, -di) / safe
        return ComplexDiagPrecond(diag_inv=torch.complex(inv_re, inv_im))

    def abs_jacobi_precond(self):
        """Real 1/|d| Jacobi in the global layout — the M of the
        preconditioned Saunders process (``solvers/cs_minres.py``)."""
        from ..precond import DiagPrecond

        dr, di = self.diagonal_planes_global()
        d = sqrt_exact(dr * dr + di * di)
        one = torch.ones((), dtype=d.dtype, device=d.device)
        return DiagPrecond(diag_inv=one / torch.where(d == 0, one, d))

    # --- the rank's operator -------------------------------------------------
    def _planes(self):
        return self.re.bands, self.im.bands

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """y = A·x on the window (K5)."""
        return pd.dia_complex_spmv(*self._planes(), self.re.window(x), self.offsets, self.h)

    def matvec_dot(self, x: torch.Tensor):
        """(A·x, the rank's partial of conj(x)ᵀ(A·x)) in one pass (K6)."""
        return pd.dia_complex_dot(*self._planes(), self.re.window(x), self.offsets, self.h)

    def matvec_conj_dot(self, x: torch.Tensor):
        """(A·conj(x), the partial of conj(x)ᵀA·conj(x)) in one pass (K6
        with ``conj_x``): distributed CS-MINRES's Saunders step."""
        return pd.dia_complex_dot(*self._planes(), self.re.window(x), self.offsets, self.h,
                                  conj_x=True)

    def matvec_wdot(self, x: torch.Tensor, w: torch.Tensor):
        """(A·x, partials of conj(w)ᵀ(A·x) and ‖A·x‖²) in one pass (K7); no
        w stream when w is x."""
        return pd.dia_complex_wdot(*self._planes(), self.re.window(x),
                                   None if w is x else w, None, self.offsets, self.h)
