"""Padded DIA operator and its CUDA kernels K1-K3 — the hot single-GPU path.

Counterpart of ``sprsolve_tpu/ops/pallas_spmv.py`` for real dtypes: a
one-time layout step at construction (:meth:`PaddedDIA.from_dia`, the
``mkl_sparse_optimize`` analog) and hand-written kernels for the
per-iteration SpMV.

Layout.  A vector is flat: ``h`` zeros, ``n_pad`` body entries, ``h`` zeros.
``h`` is max |offset| rounded up so that the body starts 16-byte aligned;
``n_pad`` is n rounded up to the kernels' row tile.  Bands are stored
``(D, n_pad)``, zero past row n.  Every vecalg op keeps the halo and the
tail at zero, so a solve runs in this layout with no per-iteration
conversion; :meth:`PaddedDIA.pad_vec`/:meth:`PaddedDIA.unpad_vec` convert at
the solve boundary.  (The TPU's (rows, 1024-lane) layout, lane rotations and
VMEM budget have no counterpart here.)

Kernels (``csrc/dia_spmv.cu``), each beside its plain PyTorch version:

- K1 :func:`dia_spmv` — y = Σ_d band_d ⊙ shift(x, off_d).
- K2 :func:`dia_wdot` — K1 on u = dinv ⊙ x (Jacobi fold) or on x, plus
  [wᵀy, yᵀy] as per-block partials summed in a second step; w = None reads
  the dot's w from x itself.
- K3 :func:`dia_dot` — K1 plus xᵀy (the ``dotmv`` form), per-block partials
  summed in a second step.

The fused Lanczos step K4, which :meth:`PaddedDIA.orth_norm` runs, lives in
:mod:`.fused`.

A wrapper runs the plain version for tensors on the CPU, and launches its
kernel for CUDA tensors or raises: there is no fallback.  Each wrapper
counts its kernel launches in its ``launches`` attribute.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..sparse.containers import DIA, _host
from . import _cuda_build

ROW_TILE = 256   # rows per CUDA block (ROW_TILE in csrc/dia_spmv.cu)
MAX_DIAGS = 32   # offsets a kernel takes (MAX_DIAGS in csrc/dia_spmv.cu)

# band storage each vector dtype takes, and the launchers' type codes
_BAND_DTYPES = {
    torch.float32: (torch.float32, torch.bfloat16, torch.int8),
    torch.float64: (torch.float64,),
}
_VCODE = {torch.float32: 0, torch.float64: 1}
_BCODE = {torch.float32: 0, torch.float64: 0, torch.bfloat16: 1, torch.int8: 2}

_SLICE3 = "ROADMAP.md Queue 1 item 7 (slice 3, ComplexPaddedDIA)"


def layout(n: int, offsets, itemsize: int) -> Tuple[int, int]:
    """``(h, n_pad)`` of the padded layout: the halo covers every offset and
    keeps the body 16-byte aligned; the body is whole row tiles."""
    align = 16 // itemsize
    hmax = max((abs(o) for o in offsets), default=0)
    return -(-hmax // align) * align, max(-(-n // ROW_TILE) * ROW_TILE, ROW_TILE)


# --- plain versions ---------------------------------------------------------
def dia_spmv_plain(bands: torch.Tensor, x: torch.Tensor, offsets, h: int
                   ) -> torch.Tensor:
    """K1 in plain PyTorch: a loop over bands of shifted slices (the XLA-DIA
    analog); the multiply-add is fused as XLA and the kernel fuse it."""
    n_pad = bands.shape[1]
    acc = torch.zeros(n_pad, dtype=x.dtype, device=x.device)
    for d, off in enumerate(offsets):
        acc = torch.addcmul(acc, bands[d].to(x.dtype),
                            x[h + off: h + off + n_pad])
    return F.pad(acc, (h, h))


def dia_wdot_plain(bands: torch.Tensor, x: torch.Tensor,
                   w: Optional[torch.Tensor], dinv: Optional[torch.Tensor],
                   offsets, h: int):
    """K2 in plain PyTorch: (y = A·u, wᵀy, yᵀy) with u = dinv ⊙ x when dinv is
    given, else u = x; w = None takes w from the raw x."""
    u = x if dinv is None else x * dinv
    y = dia_spmv_plain(bands, u, offsets, h)
    wv = x if w is None else w
    return y, torch.sum(wv * y), torch.sum(y * y)


def dia_dot_plain(bands: torch.Tensor, x: torch.Tensor, offsets, h: int):
    """K3 in plain PyTorch: (y = A·x, xᵀy)."""
    y = dia_spmv_plain(bands, x, offsets, h)
    return y, torch.sum(x * y)


# --- kernel wrappers --------------------------------------------------------
def check_layout(n_pad: int, h: int, x: torch.Tensor, *vecs, bands=None) -> None:
    """Validate the vectors a kernel takes: float32 or float64, flat, of the
    layout ``(h + n_pad + h,)`` with whole row tiles, of one dtype, and with
    ``bands`` on one device and contiguous."""
    if x.dtype not in _BAND_DTYPES:
        raise TypeError(f"vectors must be float32 or float64, got {x.dtype}")
    if n_pad <= 0 or n_pad % ROW_TILE:
        raise ValueError(f"n_pad={n_pad} is not a positive multiple of {ROW_TILE}")
    if not 0 <= h <= n_pad:
        raise ValueError(f"halo h={h} outside [0, n_pad]")
    for t in (x, *vecs):
        if t.shape != (n_pad + 2 * h,) or t.dtype != x.dtype:
            raise ValueError(
                f"vector of shape {tuple(t.shape)} and {t.dtype}; the layout "
                f"takes ({n_pad + 2 * h},) {x.dtype}"
            )
    for t in (x, *vecs) if bands is None else (bands, x, *vecs):
        if t.device != x.device:
            raise ValueError("bands and vectors must share one device")
        if not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous")


def _check(bands: torch.Tensor, x: torch.Tensor, offsets, h: int, *vecs) -> int:
    """Validate what the DIA kernels take; returns n_pad."""
    if x.dtype not in _BAND_DTYPES:
        raise TypeError(f"vectors must be float32 or float64, got {x.dtype}")
    if bands.dtype not in _BAND_DTYPES[x.dtype]:
        raise TypeError(f"{bands.dtype} bands do not serve {x.dtype} vectors")
    if bands.dim() != 2 or x.dim() != 1:
        raise ValueError("bands must be (D, n_pad) and vectors flat")
    if len(offsets) != bands.shape[0] or len(offsets) > MAX_DIAGS:
        raise ValueError(
            f"{len(offsets)} offsets for {bands.shape[0]} bands (at most {MAX_DIAGS})"
        )
    if offsets and max(abs(o) for o in offsets) > h:
        raise ValueError("an offset reaches past the halo")
    check_layout(bands.shape[1], h, x, *vecs, bands=bands)
    return bands.shape[1]


def launch_env(x: torch.Tensor):
    """``(library, stream)`` for a launch on ``x``'s CUDA device; raises for
    a device that is neither CPU nor CUDA."""
    if x.device.type != "cuda":
        raise ValueError(f"the kernels run on CPU or CUDA tensors, not {x.device}")
    return _cuda_build.load(), torch.cuda.current_stream(x.device).cuda_stream


def _launch_args(bands: torch.Tensor, x: torch.Tensor, offsets):
    lib, stream = launch_env(x)
    offs = (ctypes.c_longlong * max(len(offsets), 1))(*offsets)
    return lib, (_VCODE[x.dtype], _BCODE[bands.dtype]), offs, stream


def dia_spmv(bands: torch.Tensor, x: torch.Tensor, offsets, h: int
             ) -> torch.Tensor:
    """K1: y = Σ_d band_d ⊙ shift(x, off_d) in the padded layout (zero halo).

    Replaces ``_dia_kernel`` (``sprsolve_tpu/ops/pallas_spmv.py:131``)."""
    n_pad = _check(bands, x, offsets, h)
    if x.device.type == "cpu":
        return dia_spmv_plain(bands, x, offsets, h)
    lib, codes, offs, stream = _launch_args(bands, x, offsets)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.sprsolve_dia_spmv(
            *codes, bands.data_ptr(), x.data_ptr(), y.data_ptr(), n_pad, h,
            ctypes.addressof(offs), len(offsets), stream,
        )
    _cuda_build.check(lib, err, "dia_spmv")
    dia_spmv.launches += 1
    return y


def dia_wdot(bands: torch.Tensor, x: torch.Tensor, w: Optional[torch.Tensor],
             dinv: Optional[torch.Tensor], offsets, h: int):
    """K2: (y = A·u, wᵀy, yᵀy), u = dinv ⊙ x when ``dinv`` is given.

    ``w=None`` takes w from the raw x (one stream fewer). The dots are
    per-block partials summed by ``torch.sum(partials, 0)`` in a fixed
    order. Replaces ``_dia_wdot_kernel``
    (``sprsolve_tpu/ops/pallas_spmv.py:159``)."""
    vecs = [v for v in (w, dinv) if v is not None]
    n_pad = _check(bands, x, offsets, h, *vecs)
    if x.device.type == "cpu":
        return dia_wdot_plain(bands, x, w, dinv, offsets, h)
    lib, codes, offs, stream = _launch_args(bands, x, offsets)
    y = torch.empty_like(x)
    partials = torch.empty((n_pad // ROW_TILE, 2), dtype=x.dtype, device=x.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(x.device):
        err = lib.sprsolve_dia_wdot(
            *codes, bands.data_ptr(), x.data_ptr(), ptr(dinv), ptr(w),
            y.data_ptr(), partials.data_ptr(), n_pad, h,
            ctypes.addressof(offs), len(offsets), stream,
        )
    _cuda_build.check(lib, err, "dia_wdot")
    dia_wdot.launches += 1
    sums = torch.sum(partials, 0)
    return y, sums[0], sums[1]


def dia_dot(bands: torch.Tensor, x: torch.Tensor, offsets, h: int):
    """K3: (y = A·x, xᵀy) in the padded layout (zero halo), with x the raw
    SpMV input. The dot is per-block partials summed by ``torch.sum`` in a
    fixed order. Replaces ``_dia_dot_kernel``
    (``sprsolve_tpu/ops/pallas_spmv.py:140``)."""
    n_pad = _check(bands, x, offsets, h)
    if x.device.type == "cpu":
        return dia_dot_plain(bands, x, offsets, h)
    lib, codes, offs, stream = _launch_args(bands, x, offsets)
    y = torch.empty_like(x)
    partials = torch.empty(n_pad // ROW_TILE, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.sprsolve_dia_dot(
            *codes, bands.data_ptr(), x.data_ptr(), y.data_ptr(),
            partials.data_ptr(), n_pad, h, ctypes.addressof(offs), len(offsets),
            stream,
        )
    _cuda_build.check(lib, err, "dia_dot")
    dia_dot.launches += 1
    return y, torch.sum(partials)


dia_spmv.launches = 0
dia_wdot.launches = 0
dia_dot.launches = 0


def reset_launch_counts() -> None:
    """Set the launch count of every kernel wrapper (K1-K4) to 0."""
    from .fused import orth_norm

    for wrapper in (dia_spmv, dia_wdot, dia_dot, orth_norm):
        wrapper.launches = 0


# --- the operator -----------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class PaddedDIA:
    """DIA re-laid-out for the kernels (built once per operator).

    ``bands`` is ``(D, n_pad)``, possibly stored narrower than ``vdtype``;
    vectors are flat ``(h + n_pad + h,)`` with zero halo and tail."""

    bands: torch.Tensor
    offsets: Tuple[int, ...]
    n: int
    h: int
    shape: Tuple[int, int]
    vdtype: torch.dtype

    @property
    def dtype(self) -> torch.dtype:
        return self.vdtype

    @property
    def device(self) -> torch.device:
        return self.bands.device

    @property
    def n_pad(self) -> int:
        return self.bands.shape[1]

    @property
    def padded_len(self) -> int:
        return self.n_pad + 2 * self.h

    @staticmethod
    def _narrow_bands(bands: torch.Tensor) -> torch.Tensor:
        """Narrowest storage that represents every band value EXACTLY
        (``pallas_spmv.py:569-589``): int8 for integers in [-127, 127], else
        bf16 when a bf16 round trip is exact, else f32. Only f32 band sets
        are narrowed."""
        if bands.dtype != torch.float32 or bands.numel() == 0:
            return bands
        if float(bands.abs().max()) <= 127 and bool(torch.all(bands == bands.round())):
            return bands.to(torch.int8)
        bf = bands.to(torch.bfloat16)
        if torch.equal(bf.to(torch.float32), bands):
            return bf
        return bands

    @staticmethod
    def from_dia(m: DIA, narrow: bool = True, device=None) -> "PaddedDIA":
        bands = _host(m.bands)
        if np.iscomplexobj(bands):
            raise NotImplementedError(f"complex bands: {_SLICE3}")
        if bands.dtype not in (np.float32, np.float64):
            raise TypeError(f"bands must be float32 or float64, got {bands.dtype}")
        if len(m.offsets) > MAX_DIAGS:
            raise ValueError(f"{len(m.offsets)} diagonals; the kernels take {MAX_DIAGS}")
        n = m.shape[0]
        h, n_pad = layout(n, m.offsets, bands.dtype.itemsize)
        padded = np.zeros((bands.shape[0], n_pad), dtype=bands.dtype)
        padded[:, :n] = bands
        t = torch.from_numpy(padded)
        if narrow:
            t = PaddedDIA._narrow_bands(t)
        dev = m.device if device is None else torch.device(device)
        return PaddedDIA(bands=t.to(dev), offsets=tuple(m.offsets), n=n, h=h,
                         shape=tuple(m.shape),
                         vdtype=torch.float32 if bands.dtype == np.float32
                         else torch.float64)

    # --- padded-layout vector helpers ---------------------------------------
    def pad_vec(self, x: torch.Tensor) -> torch.Tensor:
        """(n,) → (h + n_pad + h,) with zero halo and tail."""
        return F.pad(x, (self.h, self.n_pad - self.n + self.h))

    def unpad_vec(self, x2: torch.Tensor) -> torch.Tensor:
        return x2[self.h: self.h + self.n]

    # --- operator protocol ---------------------------------------------------
    def _require_real(self, x2: torch.Tensor) -> None:
        if x2.is_complex():
            raise NotImplementedError(f"complex vectors: {_SLICE3}")

    def matvec(self, x2: torch.Tensor) -> torch.Tensor:
        """SpMV in the padded layout (K1)."""
        self._require_real(x2)
        return dia_spmv(self.bands, x2, self.offsets, self.h)

    def matvec_wdot(self, x2: torch.Tensor, w2: torch.Tensor):
        """(A·x, wᵀ(A·x), (A·x)ᵀ(A·x)) in one pass (K2). ``w2 is x2``, decided
        by identity as in the JAX package, drops the w stream."""
        self._require_real(x2)
        return dia_wdot(self.bands, x2, None if w2 is x2 else w2, None,
                        self.offsets, self.h)

    def matvec_wdot_prec(self, x2: torch.Tensor, w2: torch.Tensor,
                         dinv2: torch.Tensor):
        """Jacobi-folded w-dot: (A·(dinv ⊙ x), wᵀy, yᵀy) in one pass (K2)."""
        self._require_real(x2)
        return dia_wdot(self.bands, x2, None if w2 is x2 else w2, dinv2,
                        self.offsets, self.h)

    def matvec_dot(self, x2: torch.Tensor):
        """(A·x, xᵀ(A·x)) in one pass (K3) — the ``mkl_sparse_?_dotmv``
        analog behind MINRES's and CG's α."""
        self._require_real(x2)
        return dia_dot(self.bands, x2, self.offsets, self.h)

    def orth_norm(self, a2, vold2, v2, beta, alpha):
        """The fused Lanczos step (K4): (v₊ = a − β·v_old − α·v, Σv₊²) in one
        pass, v₊ padded with a zero halo. β and α may be 0-d device tensors:
        the launch reads neither on the host."""
        from .fused import orth_norm

        self._require_real(a2)
        return orth_norm(a2, vold2, v2, beta, alpha, self.h)

    def diagonal_padded(self) -> torch.Tensor:
        if 0 in self.offsets:
            body = self.bands[self.offsets.index(0)].to(self.vdtype)
        else:
            body = torch.zeros(self.n_pad, dtype=self.vdtype, device=self.device)
        return F.pad(body, (self.h, self.h))

    def jacobi_precond(self):
        """Diagonal preconditioner in the padded layout. Halo and pad
        coordinates have a zero diagonal; their reciprocal is forced to 1,
        and their residual stays exactly 0."""
        from ..precond import DiagPrecond

        d = self.diagonal_padded()
        one = torch.ones((), dtype=d.dtype, device=d.device)
        return DiagPrecond(diag_inv=one / torch.where(d == 0, one, d))

    def relay_diag_precond(self, M):
        """Re-lay a flat-layout DiagPrecond into the padded layout (zero pads
        keep pad coordinates inert)."""
        from ..precond import DiagPrecond

        if M.diag_inv.is_complex():
            raise NotImplementedError(
                "complex diagonal preconditioner on a real operator"
            )
        return DiagPrecond(diag_inv=self.pad_vec(M.diag_inv.to(self.device)))
