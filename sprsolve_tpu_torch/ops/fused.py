"""The fused Lanczos step, kernel K4 of the MINRES path.

Counterpart of ``sprsolve_tpu/ops/pallas_fused.py``: v₊ = a − β·v_old − α·v
and Σv₊² in one pass over the padded layout of
:class:`~sprsolve_tpu_torch.ops.padded_dia.PaddedDIA` (``csrc/fused.cu``),
beside its plain PyTorch version.  Real dtypes only.

One launch, as K2/K3: the kernel sums its per-tile partials itself, in
tile order, through the ticket of the per-(device, stream) scratch
(:func:`~sprsolve_tpu_torch.ops.padded_dia.dot_scratch`), so Σv₊² depends on
n_pad alone, not on the grid. β and α reach the kernel as device pointers
to 0-d tensors: MINRES computes α on the device (K3's dot), and a host read
to pass it would synchronise every iteration.  As with K1-K3, a CPU tensor
takes the plain version and a CUDA tensor launches the kernel or raises;
:func:`orth_norm` counts its launches in ``orth_norm.launches``.
"""

from __future__ import annotations

import torch

from . import _cuda_build, padded_dia
from .padded_dia import (_VCODE, _on_device, check_layout, dot_scratch, launch_env,
                         persistent_grid)


def orth_norm_plain(a: torch.Tensor, vold: torch.Tensor, v: torch.Tensor,
                    beta, alpha, h: int = 0):
    """K4 in plain PyTorch: (a − β·v_old − α·v, its sum of squares over the
    rows past the halo ``h``). v₊ is the two ``axpy`` of the unfused
    Lanczos step (``addcmul``), and the sum skips the zero halo as the
    kernel does, so a padded operator's MINRES on the CPU rounds as a flat
    one's (``DIA``) does."""
    vn = torch.addcmul(torch.addcmul(a, vold, -beta), v, -alpha)
    body = vn[h: vn.shape[0] - h]
    return vn, torch.sum(body * body)


def _coefficient(c, like: torch.Tensor) -> torch.Tensor:
    """``c`` as a contiguous 0-d tensor of ``like``'s dtype on its device
    (no copy when it already is one; never a host read)."""
    return torch.as_tensor(c, dtype=like.dtype, device=like.device).reshape(())


def orth_norm(a: torch.Tensor, vold: torch.Tensor, v: torch.Tensor, beta, alpha,
              h: int):
    """K4: (v₊ = a − β·v_old − α·v, Σv₊²) on padded vectors with halo ``h``;
    v₊ has a zero halo and the sum runs over the body rows. β and α are
    cast to the vectors' dtype, as the JAX package's
    ``jnp.asarray(beta, a2.dtype)`` does.

    One launch: one wave of blocks (:func:`persistent_grid`, K2/K3's)
    walks tiles of 4 rows a thread, and the last block sums the per-tile
    partials in tile order into the 0-d Σv₊², whatever the grid. Replaces
    ``_orth_norm_kernel`` (``sprsolve_tpu/ops/pallas_fused.py:37``)."""
    if a.dim() != 1:
        raise ValueError("vectors must be flat")
    n_pad = a.shape[0] - 2 * h
    check_layout(n_pad, h, a, vold, v)
    beta, alpha = _coefficient(beta, a), _coefficient(alpha, a)
    if a.device.type == "cpu":
        return orth_norm_plain(a, vold, v, beta, alpha, h)
    lib, stream = launch_env(a)
    grid = persistent_grid(n_pad, a.dtype, padded_dia._sm_count(a.device.index))
    out = torch.empty_like(a)
    s = torch.empty((), dtype=a.dtype, device=a.device)
    scratch = dot_scratch(a.device, stream, n_pad)
    err = _on_device(
        a, lib.sprsolve_orth_norm, _VCODE[a.dtype], a.data_ptr(), vold.data_ptr(),
        v.data_ptr(), beta.data_ptr(), alpha.data_ptr(), out.data_ptr(), s.data_ptr(),
        scratch.data_ptr(), scratch.numel(), grid, n_pad, h, stream,
    )
    _cuda_build.check(lib, err, "orth_norm")
    orth_norm.launches += 1
    return out, s


orth_norm.launches = 0
