"""The fused Lanczos step, kernel K4 of the MINRES path.

Counterpart of ``sprsolve_tpu/ops/pallas_fused.py``: v₊ = a − β·v_old − α·v
and Σv₊² in one pass over the padded layout of
:class:`~sprsolve_tpu_torch.ops.padded_dia.PaddedDIA` (``csrc/fused.cu``),
beside its plain PyTorch version.  Real dtypes only.

β and α reach the kernel as device pointers to 0-d tensors: MINRES computes
α on the device (K3's dot), and a host read to pass it would synchronise
every iteration.  As with K1-K3, a CPU tensor takes the plain version and a
CUDA tensor launches the kernel or raises; :func:`orth_norm` counts its
launches in ``orth_norm.launches``.
"""

from __future__ import annotations

import torch

from . import _cuda_build
from .padded_dia import _VCODE, ROW_TILE, check_layout, launch_env


def orth_norm_plain(a: torch.Tensor, vold: torch.Tensor, v: torch.Tensor,
                    beta, alpha):
    """K4 in plain PyTorch: (a − β·v_old − α·v, its sum of squares)."""
    vn = a - beta * vold - alpha * v
    return vn, torch.sum(vn * vn)


def _coefficient(c, like: torch.Tensor) -> torch.Tensor:
    """``c`` as a contiguous 0-d tensor of ``like``'s dtype on its device
    (no copy when it already is one; never a host read)."""
    return torch.as_tensor(c, dtype=like.dtype, device=like.device).reshape(())


def orth_norm(a: torch.Tensor, vold: torch.Tensor, v: torch.Tensor, beta, alpha,
              h: int):
    """K4: (v₊ = a − β·v_old − α·v, Σv₊²) on padded vectors with halo ``h``;
    v₊ has a zero halo. β and α are cast to the vectors' dtype, as the JAX
    package's ``jnp.asarray(beta, a2.dtype)`` does. The sum is per-block
    partials summed by ``torch.sum``. Replaces ``_orth_norm_kernel``
    (``sprsolve_tpu/ops/pallas_fused.py:37``)."""
    if a.dim() != 1:
        raise ValueError("vectors must be flat")
    n_pad = a.shape[0] - 2 * h
    check_layout(n_pad, h, a, vold, v)
    beta, alpha = _coefficient(beta, a), _coefficient(alpha, a)
    if a.device.type == "cpu":
        return orth_norm_plain(a, vold, v, beta, alpha)
    lib, stream = launch_env(a)
    out = torch.empty_like(a)
    partials = torch.empty(n_pad // ROW_TILE, dtype=a.dtype, device=a.device)
    with torch.cuda.device(a.device):
        err = lib.sprsolve_orth_norm(
            _VCODE[a.dtype], a.data_ptr(), vold.data_ptr(), v.data_ptr(),
            beta.data_ptr(), alpha.data_ptr(), out.data_ptr(), partials.data_ptr(),
            n_pad, h, stream,
        )
    _cuda_build.check(lib, err, "orth_norm")
    orth_norm.launches += 1
    return out, torch.sum(partials)


orth_norm.launches = 0
