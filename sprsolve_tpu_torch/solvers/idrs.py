"""IDR(s): induced dimension reduction for nonsymmetric systems.

Counterpart of ``sprsolve_tpu/solvers/idrs.py`` (Sonneveld & van Gijzen
2008, the biorthogonal variant of van Gijzen & Sonneveld 2011; beyond the
reference's surface), with the same cycle and exits:

- the shadow space P is a fixed (n, s) normal block, orthonormalized by
  QR, drawn by :func:`_shadow_space` from its own generator seeded 7.  The
  JAX package draws it from ``jax.random.key(7)``, which torch cannot
  reproduce, so the counts of the two packages differ by the draw;
- per cycle s+1 SpMVs (K1 on a
  :class:`~sprsolve_tpu_torch.ops.padded_dia.PaddedDIA`), each new
  direction replaced by M⁻¹v before A (right preconditioning), the
  TOMS-913 ω safeguard (κ = 0.7);
- the inner loop exits on the recurrence norm; an outer loop re-anchors
  on the TRUE residual b − A·x (one SpMV more) and restarts the shadow
  recurrence until the true residual meets tol, the budget ends or a
  breakdown (|Mₖₖ| ≤ tiny, or tᴴt ≤ 0) is flagged;
- ``iterations`` counts SpMVs, the r₀ one included: K1 launches once per
  iteration counted.

The projections Pᴴv and the direction updates are tensor work on the
solve's device; the (s,)/(s, s) coefficient algebra — the forward
substitutions and the biorthogonalization's scalars — runs on the host in
the solve's own dtype, reading Pᴴr once per cycle, Pᴴg once per step and
the ω step's three dots once.  Vectors in a padded layout are raveled for
the shadow-space products and keep their shape otherwise.
"""

from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch

from ..errors import Status
from ..ops.operator import IdentityOperator
from ..vecalg import (NUMPY_DTYPES, axpy, conj_dot, full_precision_matmul, group_sum, norm2,
                      real_dtype)
from .common import check_shapes, make_info, with_zero_rhs_guard


def _est_nnz_per_row(A):
    """Best-effort nnz/row of an operator (None when unknowable)."""
    try:
        n = A.shape[0]
        if hasattr(A, "offsets"):          # DIA / PaddedDIA
            return len(A.offsets)
        if hasattr(A, "nnz"):              # CSR/COO/CSC
            return A.nnz / max(n, 1)
        if hasattr(A, "k"):                # ELL
            return A.k
        if hasattr(A, "nblk") and hasattr(A, "bs"):   # BSR
            return A.nblk * A.bs * A.bs / max(n, 1)
    except Exception:
        pass
    return None


def _warn_if_shadow_traffic_dominates(A, s: int) -> None:
    """Every IDR step streams the (n, s) shadow and direction blocks (P, G,
    U: about 3·s vector streams) on top of the SpMV (about nnz/row + 2
    streams).  Warn when the shadow traffic dominates the operator's: the
    per-matvec cost is then several times BiCGStab's, and IDR(s) pays off
    only when the matvec COUNT is the bottleneck."""
    npr = _est_nnz_per_row(A)
    if npr is not None and (npr + 2) < 3 * s:
        warnings.warn(
            f"idrs: the (n, {s}) shadow-space streams (~{3*s} vector reads "
            f"per step) dominate this operator's ~{npr + 2:.0f}-stream SpMV;"
            " per-matvec wall cost will be several times BiCGStab's. Prefer"
            " bicgstab/gmres unless matvec COUNT is the bottleneck, or"
            " reduce s.",
            RuntimeWarning,
            stacklevel=3,
        )


def _shadow_space(n: int, s: int, dtype: torch.dtype, device) -> torch.Tensor:
    """The fixed (n, s) shadow space: a unit-normal block from a CPU
    generator seeded 7 (complex systems get a complex block), orthonormalized
    by QR, then moved to ``device``. The same P for every run of the same
    shape and dtype."""
    rdt = real_dtype(dtype)
    gen = torch.Generator().manual_seed(7)
    P = torch.randn((n, s), generator=gen, dtype=rdt)
    if dtype.is_complex:
        P = torch.complex(P, torch.randn((n, s), generator=gen, dtype=rdt))
    P, _ = torch.linalg.qr(P)
    return P.to(device)


def idrs(
    A,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    M=None,
    s: int = 4,
    tol,
    max_iter,
    group=None,
):
    """Solve nonsymmetric A·x = b with IDR(s). Returns ``(x, SolveInfo)``.

    ``iterations`` counts operator applications (SpMVs), comparable with
    BiCGStab's two per iteration. ``max_iter`` gates cycle entry: a final
    cycle may finish past it. ``M`` is a right preconditioner applied to
    each new direction; ``s`` is the shadow-space dimension (4 is the
    standard default, 1 ≈ BiCGStab). ``group`` makes every reduction a sum
    over its ranks (b, x0 and x are this rank's rows); each rank draws the
    shadow block of its own rows, a valid shadow space of the whole
    (``sprsolve_tpu/solvers/idrs.py:144``).
    """
    if x0 is None:
        x0 = torch.zeros_like(b)
    check_shapes(A, b, x0, group)
    s = int(s)
    _warn_if_shadow_traffic_dominates(A, s)
    if M is None:
        M = IdentityOperator(b.shape[0])
    T, dev = b.dtype, b.device
    rdt = real_dtype(T)
    npT, npR = NUMPY_DTYPES[T], NUMPY_DTYPES[rdt]
    max_iter = int(max_iter)
    tiny = npR(np.finfo(npR).tiny * 1e3)
    one_t = torch.ones((), dtype=T, device=dev)
    n, vshape = b.numel(), b.shape
    PH = _shadow_space(n, s, T, dev).conj().T.contiguous()   # (s, n)

    def pdot(v):
        """Pᴴ·v on the host, in the solve's dtype."""
        return group_sum(full_precision_matmul(PH, v.reshape(-1)), group).cpu().numpy()

    def col(X, c):
        """X·c for an (n, s) block and a host (s,) vector, in v's shape."""
        return full_precision_matmul(X, torch.as_tensor(c, device=dev)).reshape(vshape)

    def main(rhs_norm):
        tol_h = npR(tol)
        tol2 = tol_h * npR(float(rhs_norm))

        def cycle(x, r, G, U, Mm, om, its, status):
            """One IDR cycle: s steps and the ω step (s + 1 SpMVs)."""
            f = pdot(r)
            for k in range(s):
                # forward substitution M[k:, k:]·c = f[k:]
                c = np.zeros(s, dtype=npT)
                for i in range(k, s):
                    acc = f[i] - (Mm[i] * c).sum()
                    den = Mm[i, i] if abs(Mm[i, i]) > tiny else npT(1)
                    c[i] = acc / den
                v = M.matvec(r - col(G, c))
                u = col(U, c) + om.item() * v
                g = A.matvec(u)
                # biorthogonalize g against the updated P columns: one full
                # projection, then updated incrementally (Mm[:, i] = PᴴG_i)
                h = pdot(g)
                for i in range(k):
                    den = Mm[i, i] if abs(Mm[i, i]) > tiny else npT(1)
                    alpha = h[i] / den
                    g = g - alpha.item() * G[:, i].reshape(vshape)
                    u = u - alpha.item() * U[:, i].reshape(vshape)
                    h = h - alpha * Mm[:, i]
                Mm[:, k] = h
                ok = abs(h[k]) > tiny
                beta = f[k] / h[k] if ok else npT(0)
                r = r - beta.item() * g
                x = x + beta.item() * u
                f = f - beta * h
                G[:, k] = g.reshape(-1)
                U[:, k] = u.reshape(-1)
                its += 1
                if not ok:
                    status = Status.BREAKDOWN
            # ω step with the TOMS-913 "maintaining convergence" safeguard:
            # when t and r are nearly orthogonal (|ρ| < κ), rescale ω by κ/|ρ|
            v = M.matvec(r)
            t = A.matvec(v)
            its += 1
            tt, tr, rr = group_sum(torch.stack([conj_dot(t, t), conj_dot(t, r),
                                                conj_dot(r, r)]), group).cpu().numpy()
            tt, rr = npR(tt.real), npR(rr.real)
            ok_t = tt > 0
            safe_tt = tt if ok_t else npR(1)
            om = tr / npT(safe_tt)
            kappa = npR(0.7)
            rho = npR(abs(tr)) / np.sqrt(safe_tt * max(rr, tiny))
            if rho < kappa:
                om = om * npT(kappa / max(rho, tiny))
            if not ok_t:
                om = npT(0)
                status = Status.BREAKDOWN
            x = x + om.item() * v
            r = r - om.item() * t
            return x, r, om, its, status

        x = x0
        r = b - A.matvec(x0)
        r_norm = npR(float(norm2(r, group)))
        its, status = 1, Status.RUNNING
        while status == Status.RUNNING and its < max_iter and r_norm > tol2:
            # a restart: fresh shadow recurrence from the current iterate
            G = torch.zeros((n, s), dtype=T, device=dev)
            U = torch.zeros((n, s), dtype=T, device=dev)
            Mm = np.eye(s, dtype=npT)
            om = npT(1)
            while status == Status.RUNNING and its < max_iter and r_norm > tol2:
                x, r, om, its, status = cycle(x, r, G, U, Mm, om, its, status)
                r_norm = npR(float(norm2(r, group)))
            # re-anchor on the TRUE residual (the recurrence one drifts)
            r = axpy(-one_t, A.matvec(x), b)
            r_norm = npR(float(norm2(r, group)))
            its += 1
        true_res = r_norm / npR(float(rhs_norm))
        converged = status == Status.RUNNING and true_res <= tol_h
        if converged:
            status = Status.CONVERGED
        elif status == Status.RUNNING:
            status = Status.INSUFFICIENT_ITER
        return x, make_info(its, float(true_res), status)

    return with_zero_rhs_guard(b, x0, main, group)
