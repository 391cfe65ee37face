"""Padded DIA operators and their CUDA kernels K1-K3 and K5-K7 — the hot
single-GPU path.

Counterpart of ``sprsolve_tpu/ops/pallas_spmv.py``: a one-time layout step
at construction (:meth:`PaddedDIA.from_dia`, the ``mkl_sparse_optimize``
analog) and hand-written kernels for the per-iteration SpMV.
:class:`PaddedDIA` holds real bands; :class:`ComplexPaddedDIA` holds a
complex matrix as two real band planes, each narrowed on its own.

Layout.  A vector is flat: ``h`` zeros, ``n_pad`` body entries, ``h`` zeros.
``h`` is max |offset| rounded up so that the body starts 16-byte aligned;
``n_pad`` is n rounded up to the kernels' row tile.  Bands are stored
``(D, n_pad)``, zero past row n.  Every vecalg op keeps the halo and the
tail at zero, so a solve runs in this layout with no per-iteration
conversion; :meth:`PaddedDIA.pad_vec`/:meth:`PaddedDIA.unpad_vec` convert at
the solve boundary.  (The TPU's (rows, 1024-lane) layout, lane rotations and
VMEM budget have no counterpart here.)

Complex vectors are flat complex64/complex128 tensors in the same layout;
the kernels read them interleaved, so a solve needs no split into planes.

Kernels (``csrc/dia_spmv.cu``, ``csrc/dia_complex.cu``), each beside its
plain PyTorch version:

- K1 :func:`dia_spmv` — y = Σ_d band_d ⊙ shift(x, off_d).
- K1b :func:`dia_spmm` — K1 on every column of a row-major block of padded
  vectors in one launch (the JAX package's K1 under ``jax.vmap``), each
  column bitwise K1's.
- K2 :func:`dia_wdot` — K1 on u = dinv ⊙ x (Jacobi fold) or on x, plus
  [wᵀy, yᵀy]; w = None reads the dot's w from x itself.
- K3 :func:`dia_dot` — K1 plus xᵀy (the ``dotmv`` form).

  K2 and K3 are one launch each: the last block to finish sums the
  per-tile partials in tile order (a ticket in a per-(device, stream)
  scratch, :func:`dot_scratch`), over one wave of blocks
  (:func:`persistent_grid`). K6 and K7 below are built the same way.
- K5 :func:`dia_complex_spmv` — y = A·x over two band planes.
- K6 :func:`dia_complex_dot` — K5 plus conj(x)ᵀy; ``conj_x`` gives
  y = A·conj(x) by a sign fold, with the same dot (the Saunders step).
- K7 :func:`dia_complex_wdot` — K5 on u = dinv ⊙ x (complex Jacobi fold) or
  on x, plus [conj(w)ᵀy, ‖y‖²]; w = None reads w from x.

The fused Lanczos step K4, which :meth:`PaddedDIA.orth_norm` runs, lives in
:mod:`.fused`.

A wrapper runs the plain version for tensors on the CPU, and launches its
kernel for CUDA tensors or raises: there is no fallback.  Each wrapper
counts its kernel launches in its ``launches`` attribute.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..sparse.containers import DIA, _host
from ..vecalg import conj_dot
from . import _cuda_build

ROW_TILE = 256   # rows per CUDA block (ROW_TILE in csrc/dia_spmv.cu)
MAX_DIAGS = 32   # offsets a kernel takes (MAX_DIAGS in csrc/dia_spmv.cu)
SPMM_MAX_ENTRIES = 0x7FFFFF00   # K1b blocks hold fewer (SPMM_MAX_ENTRIES there)

# band storage each vector dtype takes, and the launchers' type codes
_BAND_DTYPES = {
    torch.float32: (torch.float32, torch.bfloat16, torch.int8),
    torch.float64: (torch.float64,),
}
_VCODE = {torch.float32: 0, torch.float64: 1, torch.complex64: 0, torch.complex128: 1}
_BCODE = {torch.float32: 0, torch.float64: 0, torch.bfloat16: 1, torch.int8: 2}
_REAL = (torch.float32, torch.float64)
_COMPLEX = (torch.complex64, torch.complex128)


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


def dia_spmm_plain(bands: torch.Tensor, X: torch.Tensor, offsets, h: int
                   ) -> torch.Tensor:
    """K1b in plain PyTorch: :func:`dia_spmv_plain`'s band loop over all
    columns at once. The sums run on the transposed block, whose rows are
    contiguous like a padded vector, so each column takes the same
    vectorised multiply-add as ``dia_spmv_plain`` and equals it bitwise."""
    n_pad = bands.shape[1]
    Xt = X.t().contiguous()
    acc = torch.zeros((X.shape[1], n_pad), dtype=X.dtype, device=X.device)
    for d, off in enumerate(offsets):
        acc = torch.addcmul(acc, bands[d].to(X.dtype), Xt[:, h + off: h + off + n_pad])
    return F.pad(acc, (h, h)).t().contiguous()


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


def _plane_sums(bre, bim, ur, ui, offsets, h):
    """(A_re·u_re, A_im·u_im, A_re·u_im, A_im·u_re), the four real band sums
    of the two-plane kernels (``pallas_spmv.py:254-257``)."""
    mv = lambda b, v: dia_spmv_plain(b, v, offsets, h)
    return mv(bre, ur), mv(bim, ui), mv(bre, ui), mv(bim, ur)


def dia_complex_spmv_plain(bre: torch.Tensor, bim: torch.Tensor, x: torch.Tensor,
                           offsets, h: int) -> torch.Tensor:
    """K5 in plain PyTorch: y = (A_re + i·A_im)·x from the four real sums."""
    rr, ii, ri, ir = _plane_sums(bre, bim, x.real, x.imag, offsets, h)
    return torch.complex(rr - ii, ri + ir)


def dia_complex_dot_plain(bre: torch.Tensor, bim: torch.Tensor, x: torch.Tensor,
                          offsets, h: int, conj_x: bool = False):
    """K6 in plain PyTorch: (y, conj(x)ᵀy) with y = A·x, or y = A·conj(x)
    when ``conj_x`` (the sign fold of ``pallas_spmv.py:286-291``)."""
    xr, xi = x.real, x.imag
    rr, ii, ri, ir = _plane_sums(bre, bim, xr, xi, offsets, h)
    yr, yi = (rr + ii, ir - ri) if conj_x else (rr - ii, ri + ir)
    dot = torch.complex(torch.sum(xr * yr + xi * yi), torch.sum(xr * yi - xi * yr))
    return torch.complex(yr, yi), dot


def dia_complex_wdot_plain(bre: torch.Tensor, bim: torch.Tensor, x: torch.Tensor,
                           w: Optional[torch.Tensor], dinv: Optional[torch.Tensor],
                           offsets, h: int):
    """K7 in plain PyTorch: (y = A·u, conj(w)ᵀy, ‖y‖²) with u = dinv ⊙ x
    when dinv is given, else u = x; w = None takes w from the raw x. ‖y‖²
    comes back complex with a zero imaginary part, as in the JAX package."""
    xr, xi = x.real, x.imag
    if dinv is None:
        ur, ui = xr, xi
    else:
        dr, di = dinv.real, dinv.imag
        ur, ui = xr * dr - xi * di, xr * di + xi * dr
    rr, ii, ri, ir = _plane_sums(bre, bim, ur, ui, offsets, h)
    yr, yi = rr - ii, ri + ir
    wr, wi = (xr, xi) if w is None else (w.real, w.imag)
    wd = torch.complex(torch.sum(wr * yr + wi * yi), torch.sum(wr * yi - wi * yr))
    yy = torch.sum(yr * yr + yi * yi)
    return torch.complex(yr, yi), wd, torch.complex(yy, torch.zeros_like(yy))


# --- kernel wrappers --------------------------------------------------------
def check_layout(n_pad: int, h: int, x: torch.Tensor, *vecs, bands=(),
                 dtypes=_REAL) -> None:
    """Validate the vectors a kernel takes: of one of ``dtypes``, flat, of
    the layout ``(h + n_pad + h,)`` with whole row tiles, of one dtype, and
    with the ``bands`` on one device, contiguous and not lazily conjugated
    (a kernel reads the raw data)."""
    if x.dtype not in dtypes:
        names = " or ".join(str(d).replace("torch.", "") for d in dtypes)
        raise TypeError(f"vectors must be {names}, got {x.dtype}")
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
    for t in (*bands, x, *vecs):
        if t.device != x.device:
            raise ValueError("bands and vectors must share one device")
        if not t.is_contiguous() or t.is_conj():
            raise ValueError("kernel operands must be contiguous and not lazily "
                             "conjugated (use torch.conj_physical)")


def _check(planes, x: torch.Tensor, offsets, h: int, *vecs) -> int:
    """Validate what the DIA kernels take; ``planes`` is ``(bands,)`` for
    real vectors, or the pair of band planes (re, im) for complex ones.
    Returns n_pad."""
    dtypes = _COMPLEX if len(planes) == 2 else _REAL
    if x.dtype not in dtypes:
        names = " or ".join(str(d).replace("torch.", "") for d in dtypes)
        raise TypeError(f"vectors must be {names}, got {x.dtype}")
    rdt = x.dtype.to_real() if x.dtype.is_complex else x.dtype
    for b in planes:
        if b.dtype not in _BAND_DTYPES[rdt]:
            raise TypeError(f"{b.dtype} bands do not serve {x.dtype} vectors")
        if b.dim() != 2 or b.shape != planes[0].shape:
            raise ValueError("bands must be (D, n_pad), both planes of one shape")
    if x.dim() != 1:
        raise ValueError("vectors must be flat")
    if len(offsets) != planes[0].shape[0] or len(offsets) > MAX_DIAGS:
        raise ValueError(
            f"{len(offsets)} offsets for {planes[0].shape[0]} bands (at most {MAX_DIAGS})"
        )
    if offsets and max(abs(o) for o in offsets) > h:
        raise ValueError("an offset reaches past the halo")
    check_layout(planes[0].shape[1], h, x, *vecs, bands=planes, dtypes=dtypes)
    return planes[0].shape[1]


def _check_block(bands: torch.Tensor, X: torch.Tensor, offsets, h: int) -> int:
    """Validate what K1b takes: a real row-major ``(h + n_pad + h, m)``
    block of fewer than SPMM_MAX_ENTRIES entries, contiguous, of the bands'
    device, with bands that serve its dtype. Returns n_pad."""
    if X.dim() != 2 or X.shape[1] < 1:
        raise ValueError(f"a block must be (rows, m ≥ 1), got {tuple(X.shape)}")
    if X.dtype not in _REAL or bands.dtype not in _BAND_DTYPES[X.dtype]:
        raise TypeError(f"{bands.dtype} bands and {X.dtype} blocks: K1b takes real "
                        "blocks (a complex block goes as its interleaved planes)")
    if bands.dim() != 2 or len(offsets) != bands.shape[0] or len(offsets) > MAX_DIAGS:
        raise ValueError(f"{len(offsets)} offsets for bands of shape {tuple(bands.shape)}")
    if offsets and max(abs(o) for o in offsets) > h:
        raise ValueError("an offset reaches past the halo")
    n_pad = bands.shape[1]
    if n_pad <= 0 or n_pad % ROW_TILE or not 0 <= h <= n_pad:
        raise ValueError(f"n_pad={n_pad}, h={h}: not a padded layout")
    if X.shape[0] != n_pad + 2 * h:
        raise ValueError(f"block of {X.shape[0]} rows; the layout takes {n_pad + 2 * h}")
    if X.shape[1] >= SPMM_MAX_ENTRIES // X.shape[0]:
        raise ValueError(f"a block of {X.shape[0]} × {X.shape[1]} entries: K1b takes "
                         f"fewer than {SPMM_MAX_ENTRIES} (32-bit indices)")
    if X.device != bands.device:
        raise ValueError("bands and block must share one device")
    if not X.is_contiguous() or not bands.is_contiguous():
        raise ValueError("K1b's operands must be contiguous")
    return n_pad


def launch_env(x: torch.Tensor):
    """``(library, stream)`` for a launch on ``x``'s CUDA device; raises for
    a device that is neither CPU nor CUDA."""
    if x.device.type != "cuda":
        raise ValueError(f"the kernels run on CPU or CUDA tensors, not {x.device}")
    return _cuda_build.load(), torch.cuda.current_stream(x.device).cuda_stream


@functools.lru_cache(maxsize=256)
def _launch_consts(offsets: tuple, vdtype: torch.dtype, bdtypes: tuple):
    """(type codes, ctypes offsets array) of an operator, built once: the
    vector's type code, then one for each band plane."""
    offs = (ctypes.c_longlong * max(len(offsets), 1))(*offsets)
    return (_VCODE[vdtype], *(_BCODE[b] for b in bdtypes)), offs


def _launch_args(planes, x: torch.Tensor, offsets):
    """(library, type codes, ctypes offsets array, stream); ctypes passes
    the array by address."""
    lib, stream = launch_env(x)
    codes, offs = _launch_consts(tuple(offsets), x.dtype, tuple(b.dtype for b in planes))
    return lib, codes, offs, stream


def _on_device(x: torch.Tensor, launch, *args) -> int:
    """``launch(*args)`` with ``x``'s device current (entered only when it
    is not already)."""
    if x.device.index == torch.cuda.current_device():
        return launch(*args)
    with torch.cuda.device(x.device):
        return launch(*args)


# Launch geometry of the dot kernels (DOT_TILE, SCRATCH_HEAD and
# blocks_per_sm in csrc/dia_spmv.cu for K2/K3; CDOT_TILE and
# cdot_blocks_per_sm in csrc/dia_complex.cu for K6/K7)
DOT_TILE = 1024          # rows of a K2/K3 tile: 256 threads of 4 rows
COMPLEX_DOT_TILE = 512   # rows of a K6/K7 tile: 256 threads of 2 rows
DOT_SCRATCH_HEAD = 256   # scratch bytes before the partials: the ticket
DOT_BLOCKS_PER_SM = {torch.float32: 8, torch.float64: 4,
                     torch.complex64: 4, torch.complex128: 3}
_dot_scratch = {}        # (device, stream handle) → zeroed uint8 tensor


def persistent_grid(n_pad: int, vdtype: torch.dtype, sm_count: int) -> int:
    """Blocks of one dot-kernel launch (K2/K3 for real ``vdtype``, K6/K7 for
    complex): one per tile, at most the blocks that share an SM times the
    SM count (one wave); each block walks the tiles blockIdx, + grid, ...
    The dots do not depend on it: the kernel sums per-tile partials."""
    tile = COMPLEX_DOT_TILE if vdtype.is_complex else DOT_TILE
    return max(1, min(-(-n_pad // tile), DOT_BLOCKS_PER_SM[vdtype] * sm_count))


def dot_scratch(device: torch.device, stream: int, n_pad: int) -> torch.Tensor:
    """The dot kernels' scratch of one (device, stream): the last-block
    ticket, then room for the partials of any one launch on ``n_pad`` rows
    (f64 at most: two per K2/K3 tile, three per K6/K7 tile), zeroed when
    made and made again only to grow. Each launch leaves the ticket at 0,
    so the launches in one stream's order share it; two streams never do."""
    need = DOT_SCRATCH_HEAD + max(16 * -(-n_pad // DOT_TILE),
                                  24 * -(-n_pad // COMPLEX_DOT_TILE))
    key = (device.type, device.index, stream)
    buf = _dot_scratch.get(key)
    if buf is None or buf.numel() < need:
        buf = _dot_scratch[key] = torch.zeros(need, dtype=torch.uint8, device=device)
    return buf


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def dia_spmv(bands: torch.Tensor, x: torch.Tensor, offsets, h: int
             ) -> torch.Tensor:
    """K1: y = Σ_d band_d ⊙ shift(x, off_d) in the padded layout (zero halo).

    Replaces ``_dia_kernel`` (``sprsolve_tpu/ops/pallas_spmv.py:131``)."""
    n_pad = _check((bands,), x, offsets, h)
    if x.device.type == "cpu":
        return dia_spmv_plain(bands, x, offsets, h)
    lib, codes, offs, stream = _launch_args((bands,), x, offsets)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.sprsolve_dia_spmv(
            *codes, bands.data_ptr(), x.data_ptr(), y.data_ptr(), n_pad, h,
            offs, len(offsets), stream,
        )
    _cuda_build.check(lib, err, "dia_spmv")
    dia_spmv.launches += 1
    return y


SPMM_TILE = 256   # column groups of a K1b tile (SPMM_THREADS in csrc/dia_spmv.cu)


def dia_spmm(bands: torch.Tensor, X: torch.Tensor, offsets, h: int) -> torch.Tensor:
    """K1b: Y[:, j] = A·X[:, j] for a row-major ``(h + n_pad + h, m)`` block
    whose columns are padded vectors (zero halo rows), in one launch; each
    column is bitwise K1's result on that column.

    One wave of blocks walks the tiles of SPMM_TILE column groups, as many
    as share an SM times the card's SM count (:func:`_sm_count`); the
    result does not depend on the grid.
    Replaces ``_dia_kernel`` (``sprsolve_tpu/ops/pallas_spmv.py:131``) under
    ``jax.vmap``, the call ``sprsolve_tpu/solvers/lobpcg.py:51-54`` makes
    through ``multigrid.py:259`` and ``_dia_pallas_call`` (``:509``)."""
    n_pad = _check_block(bands, X, offsets, h)
    if X.device.type == "cpu":
        return dia_spmm_plain(bands, X, offsets, h)
    lib, codes, offs, stream = _launch_args((bands,), X, offsets)
    Y = torch.empty_like(X)
    err = _on_device(
        X, lib.sprsolve_dia_spmm, *codes, bands.data_ptr(), X.data_ptr(), Y.data_ptr(),
        n_pad, h, X.shape[1], offs, len(offsets), _sm_count(X.device.index), stream,
    )
    _cuda_build.check(lib, err, "dia_spmm")
    dia_spmm.launches += 1
    return Y


def dia_wdot(bands: torch.Tensor, x: torch.Tensor, w: Optional[torch.Tensor],
             dinv: Optional[torch.Tensor], offsets, h: int):
    """K2: (y = A·u, wᵀy, yᵀy), u = dinv ⊙ x when ``dinv`` is given.

    ``w=None`` takes w from the raw x (one stream fewer). One launch: the
    kernel sums its per-tile partials itself, in tile order, into a
    ``(2,)`` tensor whose 0-d views come back; the dots depend on n_pad
    alone, not on the grid, the card or the band storage. Replaces
    ``_dia_wdot_kernel`` (``sprsolve_tpu/ops/pallas_spmv.py:159``)."""
    vecs = [v for v in (w, dinv) if v is not None]
    n_pad = _check((bands,), x, offsets, h, *vecs)
    if x.device.type == "cpu":
        return dia_wdot_plain(bands, x, w, dinv, offsets, h)
    lib, codes, offs, stream = _launch_args((bands,), x, offsets)
    grid = persistent_grid(n_pad, x.dtype, _sm_count(x.device.index))
    y = torch.empty_like(x)
    out = torch.empty(2, dtype=x.dtype, device=x.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    scratch = dot_scratch(x.device, stream, n_pad)
    err = _on_device(
        x, lib.sprsolve_dia_wdot, *codes, bands.data_ptr(), x.data_ptr(), ptr(dinv),
        ptr(w), y.data_ptr(), out.data_ptr(), scratch.data_ptr(), scratch.numel(),
        grid, n_pad, h, offs, len(offsets), stream,
    )
    _cuda_build.check(lib, err, "dia_wdot")
    dia_wdot.launches += 1
    wd, yd = out.unbind()
    return y, wd, yd


def dia_dot(bands: torch.Tensor, x: torch.Tensor, offsets, h: int):
    """K3: (y = A·x, xᵀy) in the padded layout (zero halo), with x the raw
    SpMV input. One launch: the kernel sums its per-tile partials itself,
    in tile order, into the 0-d dot. Replaces ``_dia_dot_kernel``
    (``sprsolve_tpu/ops/pallas_spmv.py:140``)."""
    n_pad = _check((bands,), x, offsets, h)
    if x.device.type == "cpu":
        return dia_dot_plain(bands, x, offsets, h)
    lib, codes, offs, stream = _launch_args((bands,), x, offsets)
    grid = persistent_grid(n_pad, x.dtype, _sm_count(x.device.index))
    y = torch.empty_like(x)
    d = torch.empty((), dtype=x.dtype, device=x.device)
    scratch = dot_scratch(x.device, stream, n_pad)
    err = _on_device(
        x, lib.sprsolve_dia_dot, *codes, bands.data_ptr(), x.data_ptr(), y.data_ptr(),
        d.data_ptr(), scratch.data_ptr(), scratch.numel(), grid, n_pad, h, offs,
        len(offsets), stream,
    )
    _cuda_build.check(lib, err, "dia_dot")
    dia_dot.launches += 1
    return y, d


def dia_complex_spmv(bre: torch.Tensor, bim: torch.Tensor, x: torch.Tensor,
                     offsets, h: int) -> torch.Tensor:
    """K5: y = (A_re + i·A_im)·x in the padded layout (zero halo), x complex.

    Replaces ``_dia_complex_kernel`` (``sprsolve_tpu/ops/pallas_spmv.py:244``)."""
    n_pad = _check((bre, bim), x, offsets, h)
    if x.device.type == "cpu":
        return dia_complex_spmv_plain(bre, bim, x, offsets, h)
    lib, codes, offs, stream = _launch_args((bre, bim), x, offsets)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.sprsolve_dia_complex_spmv(
            *codes, bre.data_ptr(), bim.data_ptr(), x.data_ptr(), y.data_ptr(),
            n_pad, h, offs, len(offsets), stream,
        )
    _cuda_build.check(lib, err, "dia_complex_spmv")
    dia_complex_spmv.launches += 1
    return y


def dia_complex_dot(bre: torch.Tensor, bim: torch.Tensor, x: torch.Tensor,
                    offsets, h: int, conj_x: bool = False):
    """K6: (y, conj(x)ᵀy) with y = A·x, or y = A·conj(x) when ``conj_x``.

    One launch: the kernel sums its per-tile partials itself, in tile order,
    into the 0-d complex dot; it depends on n_pad alone, not on the grid,
    the card or the plane storage. Replaces ``_dia_complex_dot_kernel``
    (``sprsolve_tpu/ops/pallas_spmv.py:262``)."""
    n_pad = _check((bre, bim), x, offsets, h)
    if x.device.type == "cpu":
        return dia_complex_dot_plain(bre, bim, x, offsets, h, conj_x)
    lib, codes, offs, stream = _launch_args((bre, bim), x, offsets)
    grid = persistent_grid(n_pad, x.dtype, _sm_count(x.device.index))
    y = torch.empty_like(x)
    d = torch.empty((), dtype=x.dtype, device=x.device)
    scratch = dot_scratch(x.device, stream, n_pad)
    err = _on_device(
        x, lib.sprsolve_dia_complex_dot, *codes, int(bool(conj_x)), bre.data_ptr(),
        bim.data_ptr(), x.data_ptr(), y.data_ptr(), d.data_ptr(), scratch.data_ptr(),
        scratch.numel(), grid, n_pad, h, offs, len(offsets), stream,
    )
    _cuda_build.check(lib, err, "dia_complex_dot")
    dia_complex_dot.launches += 1
    return y, d


def dia_complex_wdot(bre: torch.Tensor, bim: torch.Tensor, x: torch.Tensor,
                     w: Optional[torch.Tensor], dinv: Optional[torch.Tensor],
                     offsets, h: int):
    """K7: (y = A·u, conj(w)ᵀy, ‖y‖²), u = dinv ⊙ x when ``dinv`` is given
    (a complex diagonal of the vectors' dtype), else u = x.

    ``w=None`` takes w from the raw x. One launch: the kernel sums its
    per-tile partials itself, in tile order, into a ``(2,)`` complex tensor
    whose 0-d views come back (‖y‖² with a zero imaginary part). Replaces
    ``_dia_complex_wdot_kernel`` (``sprsolve_tpu/ops/pallas_spmv.py:343``)."""
    vecs = [v for v in (w, dinv) if v is not None]
    n_pad = _check((bre, bim), x, offsets, h, *vecs)
    if x.device.type == "cpu":
        return dia_complex_wdot_plain(bre, bim, x, w, dinv, offsets, h)
    lib, codes, offs, stream = _launch_args((bre, bim), x, offsets)
    grid = persistent_grid(n_pad, x.dtype, _sm_count(x.device.index))
    y = torch.empty_like(x)
    out = torch.empty(2, dtype=x.dtype, device=x.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    scratch = dot_scratch(x.device, stream, n_pad)
    err = _on_device(
        x, lib.sprsolve_dia_complex_wdot, *codes, bre.data_ptr(), bim.data_ptr(),
        x.data_ptr(), ptr(dinv), ptr(w), y.data_ptr(), out.data_ptr(), scratch.data_ptr(),
        scratch.numel(), grid, n_pad, h, offs, len(offsets), stream,
    )
    _cuda_build.check(lib, err, "dia_complex_wdot")
    dia_complex_wdot.launches += 1
    wd, yd = out.unbind()
    return y, wd, yd


dia_spmv.launches = 0
dia_spmm.launches = 0
dia_wdot.launches = 0
dia_dot.launches = 0
dia_complex_spmv.launches = 0
dia_complex_dot.launches = 0
dia_complex_wdot.launches = 0


def reset_launch_counts() -> None:
    """Set the launch count of every kernel wrapper (K1-K7, K1b) to 0."""
    from .fused import orth_norm

    for wrapper in (dia_spmv, dia_spmm, dia_wdot, dia_dot, orth_norm, dia_complex_spmv,
                    dia_complex_dot, dia_complex_wdot):
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
    def from_dia(m: DIA, narrow: bool = True, device=None):
        """The padded operator of ``m``; complex bands give a
        :class:`ComplexPaddedDIA`."""
        bands = _host(m.bands)
        if np.iscomplexobj(bands):
            return ComplexPaddedDIA.from_dia(m, narrow=narrow, device=device)
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

    def pad_block(self, X: torch.Tensor) -> torch.Tensor:
        """(n, m) → the row-major (h + n_pad + h, m) block :meth:`matmat`
        takes: each column padded, zero halo and tail rows."""
        return F.pad(X, (0, 0, self.h, self.n_pad - self.n + self.h))

    def unpad_block(self, X2: torch.Tensor) -> torch.Tensor:
        return X2[self.h: self.h + self.n]

    # --- operator protocol ---------------------------------------------------
    # A complex vector is two real planes through K1, composed with separate
    # dots, as in the JAX package (``pallas_spmv.py:682-751``).
    def matvec(self, x2: torch.Tensor) -> torch.Tensor:
        """SpMV in the padded layout (K1; once per plane for complex x)."""
        if x2.is_complex():
            mv = lambda v: dia_spmv(self.bands, v.contiguous(), self.offsets, self.h)
            return torch.complex(mv(x2.real), mv(x2.imag))
        return dia_spmv(self.bands, x2, self.offsets, self.h)

    def matmat(self, X2: torch.Tensor) -> torch.Tensor:
        """A·X for a row-major ``(h + n_pad + h, m)`` block of padded vectors
        (:meth:`pad_block`) in one K1b launch. A complex block goes as its
        interleaved real and imaginary planes, 2m real columns of the same
        launch (no copy); each column is bitwise :meth:`matvec`'s."""
        if X2.is_complex():
            m = X2.shape[1]
            planes = torch.view_as_real(X2.resolve_conj().contiguous()).reshape(-1, 2 * m)
            Y = dia_spmm(self.bands, planes, self.offsets, self.h)
            return torch.view_as_complex(Y.view(-1, m, 2))
        return dia_spmm(self.bands, X2.contiguous(), self.offsets, self.h)

    def matvec_wdot(self, x2: torch.Tensor, w2: torch.Tensor):
        """(A·x, wᵀ(A·x), (A·x)ᵀ(A·x)) in one pass (K2). ``w2 is x2``, decided
        by identity as in the JAX package, drops the w stream."""
        if x2.is_complex():
            y = self.matvec(x2)
            return y, conj_dot(w2, y), conj_dot(y, y)
        return dia_wdot(self.bands, x2, None if w2 is x2 else w2, None,
                        self.offsets, self.h)

    def matvec_wdot_prec(self, x2: torch.Tensor, w2: torch.Tensor,
                         dinv2: torch.Tensor):
        """Jacobi-folded w-dot: (A·(dinv ⊙ x), wᵀy, yᵀy) in one pass (K2)."""
        if x2.is_complex():
            y = self.matvec(x2 * dinv2)
            return y, conj_dot(w2, y), conj_dot(y, y)
        return dia_wdot(self.bands, x2, None if w2 is x2 else w2, dinv2,
                        self.offsets, self.h)

    def matvec_dot(self, x2: torch.Tensor):
        """(A·x, xᵀ(A·x)) in one pass (K3) — the ``mkl_sparse_?_dotmv``
        analog behind MINRES's and CG's α."""
        if x2.is_complex():
            y = self.matvec(x2)
            return y, conj_dot(x2, y)
        return dia_dot(self.bands, x2, self.offsets, self.h)

    def orth_norm(self, a2, vold2, v2, beta, alpha):
        """The fused Lanczos step (K4): (v₊ = a − β·v_old − α·v, Σv₊²) in one
        pass, v₊ padded with a zero halo. β and α may be 0-d device tensors:
        the launch reads neither on the host. Real vectors only, as in the
        JAX package (MINRES takes it only for a real system)."""
        from .fused import orth_norm

        if a2.is_complex():
            raise TypeError("orth_norm takes real vectors; a complex Lanczos "
                            "step runs unfused")
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


@dataclasses.dataclass(frozen=True)
class ComplexPaddedDIA:
    """A complex banded matrix as two real band planes over the kernels K5-K7.

    Counterpart of ``sprsolve_tpu/ops/pallas_spmv.py:811-1030``. ``re`` and
    ``im`` are :class:`PaddedDIA` planes with the same offsets, halo and
    ``n_pad``; each narrows on its own (int8/bf16/f32 for a complex64
    matrix, f64 for complex128). Vectors stay flat complex tensors of the
    planes' padded layout, and the kernels read them interleaved, so a
    complex solve needs no per-iteration split into planes. (The TPU's VMEM
    re-fit of the block geometry has no counterpart.)"""

    re: PaddedDIA
    im: PaddedDIA

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
    def n_pad(self) -> int:
        return self.re.n_pad

    @property
    def padded_len(self) -> int:
        return self.re.padded_len

    @property
    def offsets(self):
        return self.re.offsets

    @property
    def device(self) -> torch.device:
        return self.re.device

    @property
    def dtype(self) -> torch.dtype:
        return self.re.vdtype.to_complex()

    @staticmethod
    def from_dia(m: DIA, narrow: bool = True, device=None) -> "ComplexPaddedDIA":
        bands = _host(m.bands)
        if not np.iscomplexobj(bands) or bands.dtype not in (np.complex64, np.complex128):
            raise TypeError(f"bands must be complex64 or complex128, got {bands.dtype}")
        dev = m.device if device is None else device
        plane = lambda b: PaddedDIA.from_dia(
            DIA(bands=torch.from_numpy(np.ascontiguousarray(b)), offsets=m.offsets,
                shape=m.shape), narrow=narrow, device=dev)
        return ComplexPaddedDIA(re=plane(bands.real), im=plane(bands.imag))

    @staticmethod
    def from_csr(m, narrow: bool = True, device=None) -> "ComplexPaddedDIA":
        """Build from a CSR: bands extracted on the host, each plane narrowed
        on its own (``pallas_spmv.py:884-905``)."""
        bands, offsets = DIA.arrays_from_csr(m)
        dia = DIA(bands=torch.from_numpy(bands), offsets=offsets, shape=m.shape)
        return ComplexPaddedDIA.from_dia(dia, narrow=narrow,
                                         device=m.device if device is None else device)

    # --- padded-layout vector helpers ---------------------------------------
    def pad_vec(self, x: torch.Tensor) -> torch.Tensor:
        return self.re.pad_vec(x)

    def unpad_vec(self, x2: torch.Tensor) -> torch.Tensor:
        return self.re.unpad_vec(x2)

    # --- operator protocol ---------------------------------------------------
    def _planes(self):
        return self.re.bands, self.im.bands

    def matvec(self, x2: torch.Tensor) -> torch.Tensor:
        """y = A·x in one pass over both planes (K5)."""
        return dia_complex_spmv(*self._planes(), x2, self.offsets, self.h)

    def matvec_dot(self, x2: torch.Tensor):
        """(A·x, conj(x)ᵀ(A·x)) in one pass (K6) — MINRES's α on a
        Hermitian matrix."""
        return dia_complex_dot(*self._planes(), x2, self.offsets, self.h)

    def matvec_conj_dot(self, x2: torch.Tensor):
        """(A·conj(x), conj(x)ᵀ(A·conj(x))) in one pass (K6 with ``conj_x``)
        — the CS-MINRES Saunders step: the conjugation is a sign fold in the
        kernel, so no conj pass and no dot pass remain."""
        return dia_complex_dot(*self._planes(), x2, self.offsets, self.h, conj_x=True)

    def matvec_wdot(self, x2: torch.Tensor, w2: torch.Tensor):
        """(A·x, conj(w)ᵀ(A·x), ‖A·x‖²) in one pass (K7). ``w2 is x2``,
        decided by identity as in the JAX package, drops the w stream."""
        return dia_complex_wdot(*self._planes(), x2, None if w2 is x2 else w2, None,
                                self.offsets, self.h)

    def matvec_wdot_cprec(self, x2: torch.Tensor, w2: torch.Tensor,
                          dinv2: torch.Tensor):
        """Complex-Jacobi-folded w-dot (K7): u = dinv ⊙ x in the kernel, then
        (A·u, conj(w)ᵀ(A·u), ‖A·u‖²) in the same pass. ``dinv2`` is a complex
        diagonal of the vectors' dtype in this layout."""
        return dia_complex_wdot(*self._planes(), x2, None if w2 is x2 else w2, dinv2,
                                self.offsets, self.h)

    def diagonal_padded(self) -> torch.Tensor:
        return torch.complex(self.re.diagonal_padded(), self.im.diagonal_padded())

    def jacobi_precond(self):
        """Complex Jacobi in the padded layout: 1/d = (d_re − i·d_im)/|d|²
        from the planes (``pallas_spmv.py:992-1007``). Halo and pad slots
        have a zero diagonal; their reciprocal is forced to 1 + 0i."""
        from ..precond import ComplexDiagPrecond

        dr, di = self.re.diagonal_padded(), self.im.diagonal_padded()
        denom = dr * dr + di * di
        one = torch.ones((), dtype=dr.dtype, device=dr.device)
        zero = torch.zeros((), dtype=dr.dtype, device=dr.device)
        safe = torch.where(denom == 0, one, denom)
        inv_re = torch.where(denom == 0, one, dr) / safe
        inv_im = torch.where(denom == 0, zero, -di) / safe
        return ComplexDiagPrecond(diag_inv=torch.complex(inv_re, inv_im))

    def relay_diag_precond(self, M):
        """Re-lay a flat diagonal preconditioner into the padded layout (zero
        pads keep pad coordinates inert): a complex diagonal gives a
        :class:`~sprsolve_tpu_torch.precond.ComplexDiagPrecond` of the
        vectors' dtype, a real one a real ``DiagPrecond`` of the planes'
        dtype — a real diagonal on a complex system (reference
        ``src/precond.rs:6-13``)."""
        from ..precond import ComplexDiagPrecond, DiagPrecond

        d = M.diag_inv.to(self.device)
        if d.is_complex():
            return ComplexDiagPrecond(diag_inv=self.pad_vec(d.to(self.dtype)))
        return DiagPrecond(diag_inv=self.pad_vec(d.to(self.re.vdtype)))
