"""The fused Lanczos step, kernel K4 of the MINRES path, CG's two fused
update kernels U (:func:`cg_update`) and P (:func:`cg_direction`), and
CS-MINRES's two, A (:func:`csm_lanczos`) and B (:func:`csm_update`).

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

A and B do the same for real-preconditioned CS-MINRES on flat complex
vectors, where eager PyTorch takes about 60 launches and 30 vector passes
an iteration: A finishes the Lanczos vector after K6 (v_next, M⁻¹·v_next
and their dot) and runs the Givens step on the device into the solve's
state tensor (:data:`CSM_SLOTS` slots); B, after the host read, updates p,
x, v and w from the coefficients A left there.
"""

from __future__ import annotations

import torch

from ..vecalg import abs2, conj_dot, eps_for, norm2
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


def _wave_grid(x: torch.Tensor, blocks_per_sm) -> int:
    """One wave of U, P, A or B blocks on ``x``'s card (tiles of the dot
    kernels' rows, by dtype); ``blocks_per_sm`` is the library's count for
    the kernel, by type code."""
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
        _wave_grid(x, lib.sprsolve_cg_update_blocks_per_sm),
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
        rz.data_ptr(), p_out.data_ptr(), _wave_grid(p, lib.sprsolve_cg_direction_blocks_per_sm),
        p.numel(), stream,
    )
    _cuda_build.check(lib, err, "cg_direction")
    cg_direction.launches += 1
    return p_out


cg_update.launches = 0
cg_direction.launches = 0


# --- CS-MINRES's two update kernels: A (csm_lanczos) and B (csm_update) ------
# Slots of the solve's device state, one real tensor of the vectors' real
# dtype; a complex scalar takes two slots, its real part first (the CSM_*
# defines of csrc/fused.cu). A reads β and writes everything from R2 on, and
# moves the rotation on (c_old ← c ← c_next, s_old ← s ← s_next, β ← β_next,
# η ← −η·s_next, res ← res_next); B reads R2 to XC.
CSM_BETA, CSM_C_OLD, CSM_C, CSM_S_OLD, CSM_S, CSM_ETA = 0, 1, 3, 5, 6, 7
CSM_RES, CSM_THRESHOLD, CSM_BETA_ONE = 9, 10, 11
CSM_R2, CSM_R3, CSM_R1_INV, CSM_TS, CSM_XC = 12, 14, 15, 16, 17
CSM_FLAGS = 19    # [converged, bad], 1 or 0: the iteration's one host read
CSM_SLOTS = 21


def csm_beta_gate(beta_new2, noise_scale, eps):
    """CS-MINRES's β² gate: β² = v̂ᴴM⁻¹v̂ must be real positive; a negative
    real part, or an imaginary part, counts only above the dot's noise
    floor ε·``noise_scale`` (``sprsolve_tpu/solvers/cs_minres.py:101-116``).
    True where the gate fails."""
    re2 = beta_new2.real
    im2 = beta_new2.imag if beta_new2.is_complex() else torch.zeros_like(re2)
    return (re2 < -eps * noise_scale) | (im2.abs() > eps * torch.maximum(re2.abs(),
                                                                        noise_scale))


def csm_guarded_inv(beta):
    """1/β, and 0 where β is not positive (a warm start at the solution or a
    lucky breakdown scales by 0)."""
    one = torch.ones((), dtype=beta.dtype, device=beta.device)
    return torch.where(beta > 0, one / beta, torch.zeros_like(one))


def csm_givens(alpha, beta, beta_next, c_old, c, s_old, s):
    """CS-MINRES's modified Givens step with c / c̄ entries
    (``src/cs_minres.rs:109-134``) on 0-d tensors: ``(ts, r2, r3, r1_inv,
    c_next, s_next)``, ts = 1/β_next guarded."""
    ts = csm_guarded_inv(beta_next)
    r3 = s_old * beta
    tr = torch.conj(c_old) * beta
    r2 = alpha * s + c * tr
    r1_hat = torch.conj(c) * alpha - tr * s
    r1_inv = torch.ones_like(beta) / torch.sqrt(abs2(r1_hat) + beta_next * beta_next)
    return ts, r2, r3, r1_inv, torch.conj(r1_hat) * r1_inv, beta_next * r1_inv


def csm_state(beta, res_norm, threshold, beta_one) -> torch.Tensor:
    """The state at the loop's entry (real 0-d tensors of one dtype): β,
    c = c_old = η = 1, s = s_old = 0, the residual, the threshold and β₁."""
    st = torch.zeros(CSM_SLOTS, dtype=beta.dtype, device=beta.device)
    st[[CSM_BETA, CSM_RES, CSM_THRESHOLD, CSM_BETA_ONE]] = torch.stack(
        [beta, res_norm, threshold, beta_one])
    st[[CSM_C_OLD, CSM_C, CSM_ETA]] = 1.0
    return st


def _cplx(st: torch.Tensor, k: int) -> torch.Tensor:
    return torch.complex(st[k], st[k + 1])


def _check_csm(v: torch.Tensor, *vecs, dinv=None, state=None) -> None:
    """Validate what A and B take: flat complex vectors of one dtype, length
    and device, contiguous (``None`` entries skipped); d⁻¹ real of their real
    dtype and length; the state of :data:`CSM_SLOTS` entries of that dtype."""
    if v.dtype not in padded_dia.COMPLEX_DTYPES:
        raise TypeError(f"vectors must be complex64 or complex128, got {v.dtype}")
    if v.dim() != 1 or v.numel() == 0:
        raise ValueError("vectors must be flat and not empty")
    rdt = v.dtype.to_real()
    for t in (v, *vecs):
        if t is None:
            continue
        if t.shape != v.shape or t.dtype != v.dtype or t.device != v.device:
            raise ValueError("vectors must share one length, dtype and device")
        if not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous")
    if dinv is not None and (dinv.shape != v.shape or dinv.dtype != rdt
                             or dinv.device != v.device or not dinv.is_contiguous()):
        raise ValueError("d⁻¹ must be real, of the vectors' real dtype, length and device")
    if state is not None and (state.shape != (CSM_SLOTS,) or state.dtype != rdt
                              or state.device != v.device):
        raise ValueError(f"the state must be {CSM_SLOTS} values of the vectors' real dtype")


def csm_lanczos_plain(y, vold, v, dinv, alpha, state, w_out, eps):
    """A in plain PyTorch, op for op the unfused CS-MINRES iteration from
    its SpMV y = A·conj(w) and α on: v_next = y − β·v_old − α·v written into
    ``vold`` (two ``addcmul``, as ``vecalg.axpy``); w_next = v_next ⊙ d⁻¹
    (``DiagPrecond.matvec``) into ``w_out`` and β² = v_nextᴴw_next with its
    gate, or β = ‖v_next‖ for ``dinv=None``; then the Givens step
    (:func:`csm_givens`) and the state's update, in ``state``. Returns
    ``(v_next, w_next)`` (w_next None for ``dinv=None``)."""
    T = y.dtype
    st = state.clone()
    beta = st[CSM_BETA]
    v_next = torch.addcmul(y, vold, (-beta).to(T), out=vold)
    torch.addcmul(v_next, v, -alpha, out=v_next)
    if dinv is None:
        w_next = None
        bad = torch.zeros((), dtype=torch.bool, device=y.device)
        beta_next = norm2(v_next)
    else:
        w_next = torch.mul(v_next, dinv, out=w_out)
        beta_next2 = conj_dot(v_next, w_next)
        bad = csm_beta_gate(beta_next2, beta * beta, eps)
        beta_next = torch.sqrt(torch.clamp(beta_next2.real, min=0))
    ts, r2, r3, r1_inv, c_next, s_next = csm_givens(
        alpha, beta, beta_next, _cplx(st, CSM_C_OLD), _cplx(st, CSM_C), st[CSM_S_OLD],
        st[CSM_S])
    eta = _cplx(st, CSM_ETA)
    res_next = st[CSM_RES] * s_next.abs()
    xc = (c_next * eta) * st[CSM_BETA_ONE]
    state[CSM_BETA] = beta_next
    state[CSM_C_OLD:CSM_C_OLD + 2] = st[CSM_C:CSM_C + 2]
    state[CSM_C:CSM_C + 2] = torch.view_as_real(c_next)
    state[CSM_S_OLD] = st[CSM_S]
    state[CSM_S] = s_next
    state[CSM_ETA:CSM_ETA + 2] = torch.view_as_real(eta * (-s_next))
    state[CSM_RES] = res_next
    state[CSM_R2:CSM_R2 + 2] = torch.view_as_real(r2)
    state[CSM_R3], state[CSM_R1_INV], state[CSM_TS] = r3, r1_inv, ts
    state[CSM_XC:CSM_XC + 2] = torch.view_as_real(xc)
    state[CSM_FLAGS] = res_next < st[CSM_THRESHOLD]
    state[CSM_FLAGS + 1] = bad
    return v_next, w_next


def csm_lanczos(y, vold, v, dinv, alpha, state, w_out):
    """A: CS-MINRES's Lanczos step after its SpMV, in one launch.

    v_next = y − β·v_old − α·v, written over ``vold``; with d⁻¹ (M⁻¹ =
    diag(d⁻¹), real), w_next = d⁻¹ ⊙ v_next into ``w_out`` and β_next² =
    Σ conj(v_next)·w_next, else β_next² = Σ|v_next|²; then the whole Givens
    step on the device (:func:`csm_givens`, the β² gate, the residual test)
    into ``state`` (the :data:`CSM_SLOTS` layout), whose [converged, bad]
    at :data:`CSM_FLAGS` the solver reads. α (K6's 0-d dot) and β (the
    state's) are read on the device. The sums run in tile order through
    the dot kernels' per-stream scratch, so they depend on the length
    alone, not on the grid. The gate's ε is the real dtype's machine
    epsilon. ``w_out`` may overlap no other operand. Returns ``(v_next,
    w_next)`` (``vold`` and ``w_out``; w_next None for ``dinv=None``)."""
    _check_csm(y, vold, v, w_out if dinv is not None else None, dinv=dinv, state=state)
    alpha = torch.as_tensor(alpha, dtype=y.dtype, device=y.device).reshape(())
    if y.device.type == "cpu":
        return csm_lanczos_plain(y, vold, v, dinv, alpha, state, w_out, eps_for(y.dtype))
    lib, stream = launch_env(y)
    scratch = dot_scratch(y.device, stream, y.numel())
    err = _on_device(
        y, lib.sprsolve_csm_lanczos, _VCODE[y.dtype], y.data_ptr(), vold.data_ptr(),
        v.data_ptr(), None if dinv is None else dinv.data_ptr(), alpha.data_ptr(),
        state.data_ptr(), None if dinv is None else w_out.data_ptr(), scratch.data_ptr(),
        scratch.numel(), _wave_grid(y, lib.sprsolve_csm_lanczos_blocks_per_sm), y.numel(),
        stream,
    )
    _cuda_build.check(lib, err, "csm_lanczos")
    csm_lanczos.launches += 1
    return vold, (None if dinv is None else w_out)


def csm_update_plain(w, p, p_old, x, v_next, w_next, state):
    """B in plain PyTorch, op for op the unfused iteration's update after
    its host read: p_next = r1_inv·(conj(w) − r2·p − r3·p_old) (``conj``,
    two ``addcmul``, ``rscale``) written over ``p_old``; x += xc·p_next in
    place (xc = c_next·η·β₁); v_next and w_next (unless None) scaled by ts
    in place; the coefficients from ``state``."""
    T = w.dtype
    p_next = torch.addcmul(torch.conj_physical(w), p, -_cplx(state, CSM_R2))
    p_next = torch.addcmul(p_next, p_old, (-state[CSM_R3]).to(T))
    torch.mul(p_next, state[CSM_R1_INV], out=p_old)
    torch.addcmul(x, p_old, _cplx(state, CSM_XC), out=x)
    ts = state[CSM_TS]
    torch.mul(v_next, ts, out=v_next)
    if w_next is not None:
        torch.mul(w_next, ts, out=w_next)


def csm_update(w, p, p_old, x, v_next, w_next, state):
    """B: CS-MINRES's update of p, x, v and w, in one launch, from the
    coefficients A left in ``state``: p_next = r1_inv·(conj(w) − r2·p −
    r3·p_old) over ``p_old``, x += c_next·η·β₁·p_next, v_next and w_next
    scaled by 1/β_next, all in place (``w_next=None`` for M = I, where w is
    v). No operand may overlap another."""
    _check_csm(w, p, p_old, x, v_next, w_next, state=state)
    if w.device.type == "cpu":
        return csm_update_plain(w, p, p_old, x, v_next, w_next, state)
    lib, stream = launch_env(w)
    err = _on_device(
        w, lib.sprsolve_csm_update, _VCODE[w.dtype], w.data_ptr(), p.data_ptr(),
        p_old.data_ptr(), x.data_ptr(), v_next.data_ptr(),
        None if w_next is None else w_next.data_ptr(), state.data_ptr(),
        _wave_grid(w, lib.sprsolve_csm_update_blocks_per_sm), w.numel(), stream,
    )
    _cuda_build.check(lib, err, "csm_update")
    csm_update.launches += 1


csm_lanczos.launches = 0
csm_update.launches = 0
