"""Carry the JAX package's state into the port, so both compute from the
same data.

Every function takes NumPy arrays and Python ints — never a JAX object —
so this module imports no JAX.  Pass ``np.asarray(...)`` of the JAX
package's arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.padded_dia import PaddedDIA, layout
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


def vec_from_reference(x2, n: int, hr: int, device=None) -> torch.Tensor:
    """The flat ``(n,)`` vector of a JAX padded vector ``(hr + R_pad + hr, LANES)``."""
    x2 = np.asarray(x2)
    flat = x2[hr: x2.shape[0] - hr].reshape(-1)[:n]
    return torch.as_tensor(np.array(flat), device=device)
