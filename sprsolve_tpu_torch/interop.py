"""Carry the JAX package's state into the port, so both compute from the
same data.

Every function takes NumPy arrays and Python ints — never a JAX object —
so this module imports no JAX.  Pass ``np.asarray(...)`` of the JAX
package's arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.hybrid import HybridDIA
from .ops.padded_dia import ComplexPaddedDIA, PaddedDIA, layout
from .ops.reordered import Reordered
from .precond import ComplexDiagPrecond
from .sparse.bsr import BSR, ComplexBSR
from .sparse.containers import CSR


def csr_from_reference(data, indices, indptr, shape, device=None) -> CSR:
    """The port's CSR from the reference CSR's arrays."""
    return CSR.from_arrays(np.asarray(data), np.asarray(indices),
                           np.asarray(indptr), shape, device=device)


def _band_tensor(bands: np.ndarray) -> torch.Tensor:
    # bfloat16 arrives as an ml_dtypes array; its values are exact in f32
    if bands.dtype.name == "bfloat16":
        return torch.from_numpy(bands.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(bands))


def padded_dia_from_reference(bands3, offsets, n: int, hr: int, shape, vdtype,
                              device=None) -> PaddedDIA:
    """Re-lay the JAX ``PaddedDIA.bands3`` ``(D, R_pad, LANES)`` into the
    port's ``(D, n_pad)`` layout, keeping the stored (possibly narrow) band
    dtype as it is.

    ``hr`` is the JAX operator's halo in rows; it is checked to cover every
    offset, as the port's halo ``h`` then does too."""
    bands3 = np.asarray(bands3)
    d, r_pad, lanes = bands3.shape
    offsets = tuple(int(o) for o in offsets)
    if offsets and max(abs(o) for o in offsets) > hr * lanes:
        raise ValueError("the reference halo does not cover the offsets")
    vdtype = np.dtype(vdtype)
    h, n_pad = layout(n, offsets, vdtype.itemsize)
    body = _band_tensor(bands3.reshape(d, r_pad * lanes)[:, :n])
    bands = torch.zeros((d, n_pad), dtype=body.dtype)
    bands[:, :n] = body
    return PaddedDIA(
        bands=bands.to(device) if device is not None else bands,
        offsets=offsets, n=int(n), h=h, shape=tuple(int(s) for s in shape),
        vdtype=torch.float32 if vdtype == np.float32 else torch.float64,
    )


def complex_padded_dia_from_reference(re_bands3, im_bands3, offsets, n: int, hr: int,
                                      shape, vdtype, device=None) -> ComplexPaddedDIA:
    """Re-lay the JAX ``ComplexPaddedDIA``'s planes ``re.bands3`` and
    ``im.bands3`` into the port's layout, each keeping its stored dtype;
    ``vdtype`` is the planes' compute dtype (``re.vdtype``)."""
    plane = lambda b: padded_dia_from_reference(b, offsets, n, hr, shape, vdtype,
                                                device=device)
    return ComplexPaddedDIA(re=plane(re_bands3), im=plane(im_bands3))


def complex_diag_precond_from_reference(inv_re, inv_im, op, hr: int) -> ComplexDiagPrecond:
    """The port's ``ComplexDiagPrecond`` in ``op``'s padded layout from the
    planes of the JAX ``ComplexDiagPrecond`` in the JAX padded layout (as
    ``jacobi_precond`` builds it: pad and halo slots 1)."""
    body = torch.complex(vec_from_reference(inv_re, op.n, hr),
                         vec_from_reference(inv_im, op.n, hr))
    d = torch.ones(op.padded_len, dtype=body.dtype)
    d[op.h: op.h + op.n] = body
    return ComplexDiagPrecond(diag_inv=d.to(op.device))


def vec_from_reference(x2, n: int, hr: int, device=None) -> torch.Tensor:
    """The flat ``(n,)`` vector of a JAX padded vector ``(hr + R_pad + hr, LANES)``,
    real or complex."""
    x2 = np.asarray(x2)
    flat = x2[hr: x2.shape[0] - hr].reshape(-1)[:n]
    return torch.as_tensor(np.array(flat), device=device)


def _index(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a).astype(np.int64), device=device)


def bsr_from_reference(blocks, blk_row, blk_col, padded_dim: int, n: int,
                       device=None) -> BSR:
    """The port's ``BSR`` from the reference BSR's arrays."""
    return BSR(blocks=torch.as_tensor(np.array(blocks), device=device),
               blk_row=_index(blk_row, device), blk_col=_index(blk_col, device),
               padded_dim=int(padded_dim), n=int(n))


def complex_bsr_from_reference(blocks_re, blocks_im, blk_row, blk_col, padded_dim: int,
                               n: int, device=None) -> ComplexBSR:
    """The port's ``ComplexBSR`` from the reference's two block planes."""
    return ComplexBSR(blocks_re=torch.as_tensor(np.array(blocks_re), device=device),
                      blocks_im=torch.as_tensor(np.array(blocks_im), device=device),
                      blk_row=_index(blk_row, device), blk_col=_index(blk_col, device),
                      padded_dim=int(padded_dim), n=int(n))


def reordered_from_reference(inner, perm) -> Reordered:
    """A ``Reordered`` around the port's ``inner`` operator with the
    reference's permutation."""
    return Reordered.wrap(inner, np.asarray(perm))


def hybrid_from_reference(core, out_rows, out_cols, out_vals, shape) -> HybridDIA:
    """A ``HybridDIA`` around the port's ``core`` operator with the
    reference's sidecar arrays, on the core's device."""
    dev = getattr(core, "device", None)
    return HybridDIA(core=core, out_rows=_index(out_rows, dev), out_cols=_index(out_cols, dev),
                     out_vals=torch.as_tensor(np.array(out_vals), device=dev),
                     shape=tuple(int(s) for s in shape))


def grid_mg_from_reference(level_csrs, dinvs, coarse_inv, grids, nu1: int = 2,
                           nu2: int = 2, omega: float = 2.0 / 3.0,
                           coarse_scale: float = 1.8, device="cpu"):
    """The port's :class:`~sprsolve_tpu_torch.multigrid.GridMGPrecond` from
    the JAX hierarchy's state: each level's Galerkin CSR as a ``(data,
    indices, indptr, shape)`` tuple (laid out as ``from_csr`` lays it out,
    torch ``DIA`` when banded), the per-level 1/diag arrays, the coarsest
    dense inverse and the per-level grid shapes."""
    from .multigrid import FlatViewOperator, GridMGPrecond
    from .ops.optimize import optimize

    ops = []
    for data, indices, indptr, shape in level_csrs:
        op = optimize(csr_from_reference(data, indices, indptr, shape),
                      prefer_kernels=False, device=device)
        ops.append(FlatViewOperator(op=op) if hasattr(op, "pad_vec") else op)
    return GridMGPrecond(
        ops=tuple(ops),
        dinvs=tuple(torch.as_tensor(np.asarray(d), device=device) for d in dinvs),
        coarse_inv=torch.as_tensor(np.asarray(coarse_inv), device=device),
        grids=tuple(tuple(int(x) for x in g) for g in grids),
        nu1=int(nu1), nu2=int(nu2), omega=float(omega), coarse_scale=float(coarse_scale))
