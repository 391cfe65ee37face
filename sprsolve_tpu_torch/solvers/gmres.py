"""Restarted GMRES(m), and the flexible variant's shared core.

Counterpart of ``sprsolve_tpu/solvers/gmres.py`` (and of ``fgmres.py``
through :func:`arnoldi_solve`; beyond the reference's surface, whose
general solver is BiCGStab), with the same iteration and exits:

- the Arnoldi basis is an ``(m+1, size)`` tensor of raveled vectors (a
  padded layout's halo rows stay zero), orthogonalized by CGS2: two
  project-and-subtract passes of basis products, each run with TF32 off
  (:func:`~sprsolve_tpu_torch.vecalg.full_precision_matmul`), as the JAX
  package pins ``Precision.HIGHEST``.  Step j projects on rows 0..j only,
  the rows the JAX package's mask keeps;
- the Hessenberg QR by Givens rotations, the recurrence residual |g[j+1]|
  as the per-step test, and the back substitution R·y = g;
- right preconditioning: x += M⁻¹(V·y) (GMRES), or x += Z·y over the
  stored preconditioned basis (FGMRES, any M, even a nonlinear one);
- ``restart`` = m steps per cycle, ``max_iter`` bounding the total steps;
  each cycle ends with the TRUE residual b − A·x, which carries into the
  next cycle, and CONVERGED needs both the recurrence and the true
  residual within tol.  A zero column (t ≤ tiny) is BREAKDOWN.

Each step applies A once (K1 on a
:class:`~sprsolve_tpu_torch.ops.padded_dia.PaddedDIA`, K5 on a
:class:`~sprsolve_tpu_torch.ops.padded_dia.ComplexPaddedDIA`), and each
cycle once more for its true residual, plus one for r₀: its + cycles + 1
in all.  The rotations are 0-d work: each step reads the new Hessenberg
column (j + 2 values) to the host once and rotates it there in the
solve's own dtype (numpy float32 for a float32 solve), which keeps the
JAX package's rounding without dozens of 0-d launches.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..errors import Status
from ..vecalg import (NUMPY_DTYPES, conj_dot, full_precision_matmul, group_sum, norm2,
                      real_dtype)
from .common import _guard3, check_shapes, make_info


def _abs2(a):
    return a.real * a.real + a.imag * a.imag if np.iscomplexobj(a) else a * a


def _givens(hc, j, cs, sn, h_next, tiny):
    """Replay the j earlier rotations on the Hessenberg column ``hc``, then
    the new rotation that annihilates ``h_next``. Returns (hc, c, s, brk)."""
    for i in range(j):
        a_, b_ = hc[i], hc[i + 1]
        hc[i] = np.conj(cs[i]) * a_ + sn[i] * b_
        hc[i + 1] = -sn[i] * a_ + cs[i] * b_
    a_ = hc[j]
    t = np.sqrt(_abs2(a_) + h_next * h_next)
    brk = bool(t <= tiny)   # zero column: A·M⁻¹ singular on the basis
    t_safe = max(t, tiny)
    c = hc.dtype.type(1) if brk else a_ / t_safe
    s = h_next.dtype.type(0) if brk else h_next / t_safe
    hc[j] = np.conj(c) * a_ + s * h_next
    return hc, c, s, brk


def arnoldi_solve(A, b, x0, *, M, tol, max_iter, restart, record_residuals,
                  flexible, group=None):
    """The shared restarted loop of :func:`gmres` (``flexible=False``) and
    :func:`~sprsolve_tpu_torch.solvers.fgmres.fgmres` (``flexible=True``).
    With ``group`` the basis rows are this rank's, the CGS2 projections and
    norms are summed over the ranks, and every rank runs the same host
    algebra on the same bits."""
    if x0 is None:
        x0 = torch.zeros_like(b)
    check_shapes(A, b, x0, group)
    m = int(restart)
    if m < 1:
        raise ValueError("restart must be >= 1")

    T, dev = b.dtype, b.device
    rdt = real_dtype(T)
    npT, npR = NUMPY_DTYPES[T], NUMPY_DTYPES[rdt]
    max_iter = int(max_iter)
    hist_len = max_iter if record_residuals else 0
    tiny_h = npR(np.finfo(npR).tiny)
    tiny = torch.tensor(float(tiny_h), dtype=rdt, device=dev)
    vshape, size = b.shape, b.numel()
    keep_z = flexible and M is not None

    def main(rhs_norm):
        import scipy.linalg

        rhs_h = npR(float(rhs_norm))
        tol_h = npR(tol)
        threshold = tol_h * rhs_h
        hist = np.full(hist_len, np.nan, dtype=npR)
        V = torch.empty((m + 1, size), dtype=T, device=dev)
        Z = torch.empty((m, size), dtype=T, device=dev) if keep_z else None

        x = x0
        r = (b - A.matvec(x0).reshape(vshape)).reshape(size)
        res = norm2(r, group) / rhs_norm
        its, status = 0, Status.RUNNING
        while status == Status.RUNNING and its < max_iter:
            beta = norm2(r, group)
            V[0] = r / torch.maximum(beta, tiny)
            beta_h = npR(float(beta))
            g = np.zeros(m + 1, dtype=npT)
            g[0] = beta_h
            R = np.zeros((m, m), dtype=npT)
            cs = np.ones(m, dtype=npT)
            sn = np.zeros(m, dtype=npR)
            j, res_est, inner_status = 0, beta_h, status
            steps_left = max_iter - its
            while (inner_status == Status.RUNNING and j < m and res_est > threshold
                   and j < steps_left):
                v_j = V[j].reshape(vshape)
                z = M.matvec(v_j) if M is not None else v_j
                if keep_z:
                    Z[j] = z.reshape(size)
                w = A.matvec(z).reshape(size)
                # CGS2 over the rows 0..j of the basis
                Vj = V[: j + 1]
                h1 = group_sum(full_precision_matmul(Vj.conj(), w), group)
                w = w - full_precision_matmul(h1, Vj)
                h2 = group_sum(full_precision_matmul(Vj.conj(), w), group)
                w = w - full_precision_matmul(h2, Vj)
                h_next = torch.sqrt(torch.clamp(conj_dot(w, w, group).real, min=0))
                V[j + 1] = w / torch.maximum(h_next, tiny)
                col = torch.cat([h1 + h2, h_next.to(T).reshape(1)]).cpu().numpy()
                hc = np.zeros(m + 1, dtype=npT)
                hc[: j + 2] = col
                hn = npR(col[j + 1].real)
                hc, c, s, brk = _givens(hc, j, cs, sn, hn, tiny_h)
                R[:, j] = hc[:m]
                cs[j], sn[j] = c, s
                gj = g[j]
                g[j] = np.conj(c) * gj
                g[j + 1] = (-s) * gj
                res_est = npR(abs(g[j + 1]))
                if hist_len:
                    hist[its + j] = res_est / rhs_h
                j += 1
                if brk:
                    inner_status = Status.BREAKDOWN
            k = j

            # back-substitute R[:k,:k]·y = g[:k]; rows ≥ k are the identity
            # with a zero rhs, so stale entries cannot leak in
            idx = np.arange(m)
            d = np.diagonal(R).copy()
            Rm = R.copy()
            Rm[idx, idx] = np.where((idx < k) & (np.abs(d) > tiny_h), d, npT(1))
            gm = np.where(idx < k, g[:m], npT(0)).astype(npT)
            y = scipy.linalg.solve_triangular(Rm, gm, lower=False).astype(npT)
            yk = torch.as_tensor(y[:k], device=dev)
            if keep_z:
                dx = full_precision_matmul(yk, Z[:k]).reshape(vshape)
            else:
                dz = full_precision_matmul(yk, V[:k]).reshape(vshape)
                dx = M.matvec(dz) if M is not None else dz
            x = x + dx

            # the true residual at the cycle's end: CONVERGED only when it
            # passes too, and every exit reports the residual of x itself
            r = (b - A.matvec(x).reshape(vshape)).reshape(size)
            res = norm2(r, group) / rhs_norm
            converged = bool(res_est <= threshold) and bool(res <= tol)
            status = (Status.CONVERGED if converged and inner_status == Status.RUNNING
                      else inner_status)
            its += k
            if k == 0 and status == Status.RUNNING:
                # the recurrence and the true residual disagree at the
                # threshold's last bit: another cycle would repeat this one
                break
        if status == Status.RUNNING:
            status = Status.INSUFFICIENT_ITER
        return x, make_info(its, res, status), torch.as_tensor(hist, device=dev)

    return _guard3(b, x0, main, hist_len, rdt, group)


def gmres(
    A,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    M=None,
    tol,
    max_iter,
    restart: int = 32,
    record_residuals: bool = False,
    group=None,
):
    """Solve A·x = b with restarted GMRES(m). Returns ``(x, SolveInfo)``.

    ``restart`` (= m) is the Krylov dimension per cycle; ``max_iter`` bounds
    the total number of inner steps across cycles.  ``M`` is a FIXED right
    preconditioner (≈ A⁻¹); for one that varies per apply, e.g.
    :class:`~sprsolve_tpu_torch.precond.InnerSolvePrecond`, use
    :func:`~sprsolve_tpu_torch.solvers.fgmres.fgmres`.
    ``record_residuals=True`` also returns the recurrence residual after
    each step, a ``(max_iter,)`` tensor that is NaN past the last.
    ``group`` makes every reduction a sum over its ranks (b, x0 and x are
    this rank's rows; ``parallel.distributed_solve``).
    """
    x, info, hist = arnoldi_solve(A, b, x0, M=M, tol=tol, max_iter=max_iter,
                                  restart=restart, record_residuals=record_residuals,
                                  flexible=False, group=group)
    return (x, info, hist) if record_residuals else (x, info)
