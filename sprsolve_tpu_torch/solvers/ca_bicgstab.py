"""s-step (communication-avoiding) BiCGStab.

Counterpart of ``sprsolve_tpu/solvers/ca_bicgstab.py`` (Carson, Demmel &
Knight's CA-BiCGStab; beyond the reference's surface), with the same block
and exits: per outer block, the 4s+1 basis vectors
V = [ρ₀(A)p … ρ_{2s}(A)p, ρ₀(A)r … ρ_{2s−1}(A)r], the Gram matrix G = VᴴV
and the shadow projection g = Vᴴr̃₀ from one full-precision product, s
exact BiCGStab steps as coefficient recurrences, and x/r/p rebuilt from V.
The outer loop re-anchors on the TRUE residual with r̃₀ := r and p := r,
which is also the reference's ρ-breakdown restart
(``src/bicg_stab.rs:131-145``); ⟨r̃₀, v⟩ = 0 is a terminal BREAKDOWN, a
tᴴt ≤ 0 exits the block to the anchor (the ω guard), and a block whose
coordinate ‖r‖² passes 1e12 times the anchor's is rolled back.

As :mod:`~sprsolve_tpu_torch.solvers.ca_cg`: the basis applies
``A.matmat`` or one ``matvec`` per column, the (4s+1)-sized coefficient
algebra runs on the host in the solve's dtype (one read of (G, g) per
block), and a padded kernel layout is refused.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..errors import IncompatibleMatrixFormat, Status
from ..vecalg import (NUMPY_DTYPES, axpy, conj_dot, eps_for, full_precision_matmul, group_sum,
                      real_dtype)
from .ca_cg import _basis_change, _chebyshev, _kernel_layout, basis_block
from .common import _guard3, check_shapes, make_info

# a block whose coordinate ‖r‖² exceeds this factor times the last anchor's
# exact ‖r‖² is rolled back (its Gram is poisoned: typically Chebyshev
# bounds that miss the spectrum); ‖r‖ excursions of 1e3-1e4 are normal
# BiCGStab oscillation, 1e8 on ‖r‖²
_DIVERGENCE_CAP = 1e12


def ca_bicgstab(
    A,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    s: int = 2,
    basis: str = "auto",
    bounds=None,
    tol,
    max_iter,
    record_residuals: bool = False,
    group=None,
):
    """Solve general A·x = b with s-step BiCGStab. Returns ``(x, SolveInfo)``.

    ``s``: BiCGStab iterations per block (2-4 sensible: one block spans
    polynomial degree 2s).  ``basis``/``bounds`` as in
    :func:`~sprsolve_tpu_torch.solvers.ca_cg.ca_cg`.  ``iterations`` counts
    BiCGStab steps; each outer anchor adds one.  Unpreconditioned.
    ``group`` as in :func:`~sprsolve_tpu_torch.solvers.ca_cg.ca_cg`.
    """
    if x0 is None:
        x0 = torch.zeros_like(b)
    check_shapes(A, b, x0, group)
    if b.dim() != 1 or _kernel_layout(A):
        raise IncompatibleMatrixFormat(
            "ca_bicgstab works on flat vectors (the basis block stacks p "
            "and r); padded kernel layouts are not supported here"
        )
    if s < 1:
        raise ValueError(f"need s >= 1, got {s}")
    basis, theta, delta = _chebyshev(basis, bounds)
    deg = 2 * s
    if hasattr(A, "max_power") and deg > A.max_power:
        raise ValueError(
            f"s={s} needs matrix-powers depth 2s={deg}, exceeding the "
            f"operator's {A.max_power} (ext={A.ext}, halo={A.halo}); "
            f"partition with mpk_s=2*s"
        )
    mpk = hasattr(A, "mpk_extend") and group is not None

    T, dev = b.dtype, b.device
    rdt = real_dtype(T)
    npT, npR = NUMPY_DTYPES[T], NUMPY_DTYPES[rdt]
    max_iter = int(max_iter)
    hist_len = max_iter + 1 if record_residuals else 0
    epsr = npR(float(eps_for(T)))
    tiny = npR(np.finfo(npR).tiny)
    t = 2 * deg + 1
    Bmat = _basis_change(deg, basis, theta, delta).astype(npR)
    one = torch.ones((), dtype=T, device=dev)
    cap = npR(_DIVERGENCE_CAP)

    def main(rhs_norm):
        rhs_h = npR(float(rhs_norm))
        tol_h = npR(tol)
        tol2sq = np.square(tol_h * rhs_h)
        hist = np.full(hist_len, np.nan, dtype=npR)

        def block(x, r, p, rt0, rn2, rn2_anchor, rt0_tol, its, status):
            V = basis_block(A, p, r, deg, basis, theta, delta, mpk)
            GE = group_sum(full_precision_matmul(V.conj().T, torch.cat([V, rt0[:, None]], dim=1)),
                           group)
            GE = GE.cpu().numpy()
            G, gh = GE[:, :t], GE[:, t].conj()
            a = np.zeros(t, npT)
            a[0] = 1
            bv = np.zeros(t, npT)
            bv[deg + 1] = 1
            c = np.zeros(t, npT)
            rn2_blk, need_anchor, active = rn2, False, True
            for _ in range(s):
                rho = gh @ bv
                # ρ-restart predicate: the block cannot reset r̃₀ itself
                collapse = abs(rho) < rt0_tol
                wv = (Bmat @ a).astype(npT)
                delta_ = gh @ wv
                ok_d = abs(delta_) > 0
                alpha = rho / (delta_ if ok_d else npT(1))
                bs = bv - alpha * wv
                wt = (Bmat @ bs).astype(npT)
                Gbs, Gwt = G @ bs, G @ wt
                tt = npR(np.real(wt.conj() @ Gwt))
                ts = wt.conj() @ Gbs
                sn2 = max(npR(np.real(bs.conj() @ Gbs)), npR(0))
                ok_t = tt > 0
                omega = ts / npT(tt) if ok_t else npT(0)
                step = active and ok_d and not collapse and its < max_iter
                # the ω guard: tᴴt ≤ 0 with the block residual above tol
                # exits the block to the outer anchor
                degen = not ok_t and sn2 > tol2sq
                bnew = bs - omega * wt if step else bv
                rn2_new = max(npR(np.real(bnew.conj() @ (G @ bnew))), npR(0))
                rho_new = gh @ bnew
                beta = ((rho_new / (rho if abs(rho) > 0 else npT(1)))
                        * (alpha / (omega if abs(omega) > 0 else npT(1))))
                if step:
                    c = c + alpha * a + omega * bs
                    rn2_blk = rn2_new
                    if ok_t:
                        a = bnew + beta * (a - omega * wv)
                if hist_len and step:
                    hist[min(its, max_iter)] = np.sqrt(rn2_blk) / rhs_h
                bv = bnew
                if active and not collapse and not ok_d:
                    status = Status.BREAKDOWN
                need_anchor = need_anchor or (active and (collapse or degen))
                if step:
                    its += 1
                active = step and not degen and rn2_blk > tol2sq
            # roll back a block whose basis exploded (NaN counts as exploded)
            if not rn2_blk <= cap * rn2_anchor:
                return x, r, p, rn2, True, its, status
            cvec = torch.as_tensor(np.stack([c, bv, a], axis=1), device=dev)
            xrp = full_precision_matmul(V, cvec)
            return x + xrp[:, 0], xrp[:, 1], xrp[:, 2], rn2_blk, need_anchor, its, status

        r = axpy(-one, A.matvec(x0), b)
        x, p, rt0, its, status = x0, r, r, 0, Status.RUNNING
        rn2 = npR(float(conj_dot(r, r, group).real))
        rn2_anchor, rt0_tol, need_anchor = rn2, np.square(epsr) * rn2, False
        # outer anchor loop: re-anchor on the TRUE residual, r̃₀ := r, p := r
        while (status == Status.RUNNING and its < max_iter
               and (rn2 > tol2sq or need_anchor)):
            while (status == Status.RUNNING and not need_anchor and its < max_iter
                   and rn2 > tol2sq):
                x, r, p, rn2, need_anchor, its, status = block(
                    x, r, p, rt0, rn2, rn2_anchor, rt0_tol, its, status)
            r = axpy(-one, A.matvec(x), b)
            p = rt0 = r
            rn2 = rn2_anchor = npR(float(conj_dot(r, r, group).real))
            rt0_tol = np.square(epsr) * max(rn2, tiny)
            need_anchor = False
            its += 1
        true_res = np.sqrt(rn2) / rhs_h
        converged = status == Status.RUNNING and true_res <= tol_h
        if converged:
            status = Status.CONVERGED
        elif status == Status.RUNNING:
            status = Status.INSUFFICIENT_ITER
        if hist_len and converged:
            hist[min(its, max_iter)] = true_res
        return (x, make_info(its, float(true_res), status),
                torch.as_tensor(hist, device=dev))

    x, info, hist = _guard3(b, x0, main, hist_len, rdt, group)
    return (x, info, hist) if record_residuals else (x, info)
