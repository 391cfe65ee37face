"""The fused Lanczos step, kernel K4 of the MINRES path, and CG's two fused
update kernels U (:func:`cg_update`) and P (:func:`cg_direction`).

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

U and P run CG's vector recurrence on flat vectors of any length (a padded
layout's halos are entries like any other) in two passes where eager
PyTorch takes 17 launches: U updates x and r and sums rᵀ(d⁻¹⊙r) and rᵀr,
P makes the next direction from them. They read α's and β's operands as
0-d device tensors, and U leaves ‖r‖ and the iteration's predicates in one
small tensor, so the solver's one host read copies that tensor alone.
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


def _check_cg(x: torch.Tensor, *vecs) -> None:
    """Validate what U and P take: flat real vectors of one dtype, length
    and device, contiguous (``None`` entries, an absent d⁻¹, are skipped)."""
    if x.dtype not in padded_dia.REAL_DTYPES:
        raise TypeError(f"vectors must be float32 or float64, got {x.dtype}")
    if x.dim() != 1 or x.numel() == 0:
        raise ValueError("vectors must be flat and not empty")
    for t in (x, *vecs):
        if t is None:
            continue
        if t.shape != x.shape or t.dtype != x.dtype or t.device != x.device:
            raise ValueError("vectors must share one length, dtype and device")
        if not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous")


def _cg_grid(x: torch.Tensor, blocks_per_sm) -> int:
    """One wave of U or P blocks on ``x``'s card; ``blocks_per_sm`` is the
    library's count for the kernel, by type code."""
    return persistent_grid(x.numel(), x.dtype, padded_dia._sm_count(x.device.index),
                           blocks_per_sm(_VCODE[x.dtype]))


def cg_update_plain(x, p, r, q, dinv, rz, pq, tol, x_out, r_out):
    """U in plain PyTorch, op for op the unfused CG iteration: α = rz /
    (pq if pq > 0 else 1), x_out = x + α·p and r_out = r − α·q (``addcmul``,
    as ``vecalg.axpy``), z = r_out ⊙ d⁻¹ (r_out itself for ``dinv=None``),
    then ``stats`` = [rᵀz, rᵀr, ‖r‖, pq > 0, ‖r‖ > tol, ‖r‖ ≤ tol] (the
    predicates 1 or 0) of r = r_out. Returns ``(x_out, r_out, stats)``."""
    one = torch.ones((), dtype=x.dtype, device=x.device)
    ok = pq > 0
    alpha = rz / torch.where(ok, pq, one)
    torch.addcmul(x, p, alpha, out=x_out)
    torch.addcmul(r, q, -alpha, out=r_out)
    z = r_out if dinv is None else r_out * dinv
    rr = torch.sum(r_out * r_out)
    rz_next = rr if dinv is None else torch.sum(r_out * z)
    norm = torch.sqrt(rr)
    stats = torch.stack([rz_next, rr, norm, ok.to(x.dtype), (norm > tol).to(x.dtype),
                         (norm <= tol).to(x.dtype)])
    return x_out, r_out, stats


def cg_update(x, p, r, q, dinv, rz, pq, tol, x_out, r_out):
    """U: CG's step along p and the sums of the next residual, in one launch.

    α = rz / (pq if pq > 0 else 1), ``x_out`` = x + α·p, ``r_out`` = r − α·q,
    and ``stats``, a (6,) tensor of the vectors' dtype: [rᵀ(d⁻¹⊙r), rᵀr,
    ‖r‖, pq > 0, ‖r‖ > tol, ‖r‖ ≤ tol] of the new r, the predicates 1 or 0
    (rᵀ(d⁻¹⊙r) = rᵀr for ``dinv=None``). ``r_out`` may be r and ``x_out``
    x (in place; CG passes another x_out, so that a breakdown keeps x); no
    other operands may overlap. rz, pq and tol are 0-d tensors, read on
    the device. The sums run in tile order through the dot kernels'
    per-stream scratch, so they depend on the length alone, not on the grid.
    Returns ``(x_out, r_out, stats)``."""
    _check_cg(x, p, r, q, dinv, x_out, r_out)
    rz, pq, tol = (_coefficient(c, x) for c in (rz, pq, tol))
    if x.device.type == "cpu":
        return cg_update_plain(x, p, r, q, dinv, rz, pq, tol, x_out, r_out)
    lib, stream = launch_env(x)
    stats = torch.empty(6, dtype=x.dtype, device=x.device)
    scratch = dot_scratch(x.device, stream, x.numel())
    err = _on_device(
        x, lib.sprsolve_cg_update, _VCODE[x.dtype], x.data_ptr(), p.data_ptr(),
        r.data_ptr(), q.data_ptr(), None if dinv is None else dinv.data_ptr(),
        rz.data_ptr(), pq.data_ptr(), tol.data_ptr(), x_out.data_ptr(), r_out.data_ptr(),
        stats.data_ptr(), scratch.data_ptr(), scratch.numel(),
        _cg_grid(x, lib.sprsolve_cg_update_blocks_per_sm),
        x.numel(), stream,
    )
    _cuda_build.check(lib, err, "cg_update")
    cg_update.launches += 1
    return x_out, r_out, stats


def cg_direction_plain(p, r, dinv, rz_next, rz, p_out):
    """P in plain PyTorch, op for op the unfused iteration's
    ``axpy(rz_next / rz, p, z)`` with z = r ⊙ d⁻¹ (r for ``dinv=None``)."""
    z = r if dinv is None else r * dinv
    return torch.addcmul(z, p, rz_next / rz, out=p_out)


def cg_direction(p, r, dinv, rz_next, rz, p_out):
    """P: CG's next direction ``p_out`` = d⁻¹⊙r + β·p, β = rz_next / rz
    read on the device (0-d tensors), in one launch; ``p_out`` may be p."""
    _check_cg(p, r, dinv, p_out)
    rz_next, rz = _coefficient(rz_next, p), _coefficient(rz, p)
    if p.device.type == "cpu":
        return cg_direction_plain(p, r, dinv, rz_next, rz, p_out)
    lib, stream = launch_env(p)
    err = _on_device(
        p, lib.sprsolve_cg_direction, _VCODE[p.dtype], r.data_ptr(),
        None if dinv is None else dinv.data_ptr(), p.data_ptr(), rz_next.data_ptr(),
        rz.data_ptr(), p_out.data_ptr(), _cg_grid(p, lib.sprsolve_cg_direction_blocks_per_sm),
        p.numel(), stream,
    )
    _cuda_build.check(lib, err, "cg_direction")
    cg_direction.launches += 1
    return p_out


cg_update.launches = 0
cg_direction.launches = 0
