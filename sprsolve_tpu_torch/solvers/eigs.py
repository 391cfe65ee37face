"""Shift-invert eigensolver: interior eigenpairs of a Hermitian operator
near a target σ.

Counterpart of ``sprsolve_tpu/solvers/eigs.py``. Eigenvalues of
(A − σI)⁻¹ are μ = 1/(λ − σ), so the λ nearest σ become the extreme μ,
which LOBPCG reaches, at the price of an inner linear solve per apply:

- the shifted operator is
  :class:`~sprsolve_tpu_torch.ops.operator.ShiftedOperator` (padded kernel
  layouts kept);
- each inverse apply is a MINRES inner solve, the right Krylov method for
  the symmetric indefinite A − σI, on the whole (n, 3k) block in lockstep
  (:func:`~sprsolve_tpu_torch.solvers.minres._minres_block`: one K1b
  launch and one host read per lockstep iteration, each column frozen at
  its own exit, as ``jax.vmap(minres)`` gives the JAX package);
- λ above σ have μ > 0 (the top of the μ-spectrum) and λ below σ have
  μ < 0 (the bottom), so both sides are collected with two LOBPCG passes
  and merged on the host by Rayleigh quotients on the ORIGINAL A.

Parity bar: ``scipy.sparse.linalg.eigsh(A, k, sigma=σ)`` (ARPACK with a
direct inner factorisation); here the inner solve is iterative.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..errors import IncompatibleMatrixFormat, Status
from ..ops.operator import ShiftedOperator
from .common import block_apply, make_info
from .lobpcg import lobpcg
from .minres import _minres_block, minres


@dataclasses.dataclass(frozen=True)
class InvertedOperator:
    """y ≈ A⁻¹·x by an inner solve: an operator whose ``matvec`` is itself
    a Krylov loop.

    ``method="minres"`` (M symmetric positive): :meth:`matvec` is one
    :func:`minres`, :meth:`matmat` the lockstep block MINRES on every
    column at once (one block apply of A per lockstep iteration).
    ``method="fgmres"`` (M any operator, e.g. an inner Krylov sweep):
    :meth:`matmat` runs ``batched(fgmres)``, one solve per column.

    ``group`` (the JAX package's ``axis_name``) makes the inner solves
    row-partitioned: A and M are this rank's parts, the vectors this
    rank's rows, and every inner reduction a sum over the group (used by
    :func:`~sprsolve_tpu_torch.parallel.distributed_shift_invert_eigs`)."""

    A: object
    M: object = None
    inner_tol: float = 1e-8
    inner_max_iter: int = 400
    method: str = "minres"
    group: object = None

    @property
    def shape(self):
        return self.A.shape

    @property
    def dtype(self):
        return getattr(self.A, "dtype", None)

    def _kw(self):
        return dict(M=self.M, tol=self.inner_tol, max_iter=self.inner_max_iter,
                    group=self.group)

    def _check_method(self):
        if self.method not in ("minres", "fgmres"):
            raise IncompatibleMatrixFormat(
                f"InvertedOperator: unknown inner method {self.method!r} "
                "(choose 'minres' or 'fgmres')")

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        self._check_method()
        if self.method == "fgmres":
            from .fgmres import fgmres

            return fgmres(self.A, x, **self._kw())[0]
        return minres(self.A, x, **self._kw())[0]

    def matvec_dot(self, x: torch.Tensor):
        from ..vecalg import conj_dot

        y = self.matvec(x)
        return y, conj_dot(x, y)

    def matmat(self, X: torch.Tensor) -> torch.Tensor:
        self._check_method()
        if self.method == "fgmres":
            from .block_cg import batched
            from .fgmres import fgmres

            return batched(fgmres)(self.A, X, **self._kw())[0]
        return _minres_block(self.A, X, **self._kw())[0]


def _rayleigh_and_residuals(A, X: torch.Tensor):
    """Rayleigh quotients and relative residuals on the original A, as
    numpy arrays."""
    AX = block_apply(A, X)
    lam = torch.real(torch.sum(torch.conj(X) * AX, dim=0))
    R = AX - X * lam[None, :].to(X.dtype)
    rel = torch.linalg.norm(R, dim=0) / torch.clamp(lam.abs(), min=torch.finfo(lam.dtype).tiny)
    return lam.cpu().numpy(), rel.cpu().numpy()


def _op_dtype(op, X0) -> torch.dtype:
    """The working dtype: the operator's, else its diagonal's, else X0's,
    else float64 (``sprsolve_tpu/solvers/eigs.py:188-198``)."""
    dt = getattr(op, "dtype", None)
    if dt is not None:
        return dt
    inner = getattr(op, "op", op)
    if hasattr(inner, "diagonal"):
        return inner.diagonal().dtype
    if hasattr(inner, "diagonal_padded"):
        return inner.diagonal_padded().dtype
    if X0 is not None:
        return torch.as_tensor(X0).dtype
    return torch.float64


def shift_invert_eigs(
    A,
    k: int,
    sigma: float,
    *,
    side: str = "both",
    X0=None,
    M_inner=None,
    inner_tol: Optional[float] = None,
    inner_max_iter: int = 400,
    inner_method: str = "minres",
    tol: float = 1e-6,
    max_iter: int = 100,
    optimize_layout: bool = True,
    seed: int = 0,
    device=None,
):
    """The ``k`` eigenpairs of Hermitian ``A`` nearest ``sigma``.

    Returns ``(lam, X, info)``: eigenvalues ordered by |λ − σ| ascending,
    their vectors as columns, and a :class:`SolveInfo` whose ``residual``
    is the worst relative residual ‖A·xᵢ − λᵢxᵢ‖/|λᵢ| of the returned pairs
    (on the original A, not the inverted operator) and whose
    ``iterations`` counts LOBPCG iterations summed over the passes.
    CONVERGED says the returned pairs meet ``tol``; where eigenvalues near σ
    lie closer than tol·|λ| in their distance to σ, they need not be the k
    nearest (the reference behaves the same; ROADMAP Queue 3).

    ``side``: ``"both"`` (k nearest from either side of σ, two LOBPCG
    passes over the μ-spectrum's two ends), ``"above"`` / ``"below"`` (one
    pass, λ ≥ σ resp. λ < σ only).

    ``M_inner`` preconditions the inner solves: symmetric positive with the
    default ``inner_method="minres"``, any operator with ``"fgmres"``.
    ``inner_tol`` defaults to ``min(tol·1e-2, 1e-8)``.

    A CSR (or CSC) ``A`` is laid out by ``optimize()`` on ``device``
    (default: the CUDA device) unless ``optimize_layout=False``; an
    operator runs where it lives. A padded layout is applied through its
    flat view, one K1b launch per block apply.
    """
    if k < 1:
        raise IncompatibleMatrixFormat(f"need k >= 1, got {k}")
    if side not in ("both", "above", "below"):
        raise IncompatibleMatrixFormat(
            f"side must be 'both', 'above' or 'below', got {side!r}")
    if inner_tol is None:
        inner_tol = min(tol * 1e-2, 1e-8)

    from ..multigrid import FlatViewOperator
    from ..ops.optimize import optimize as _optimize
    from ..sparse.containers import CSC, CSR

    op = A
    if isinstance(op, CSC):
        op = op.to_csr()
    if optimize_layout and isinstance(op, CSR):
        op = _optimize(op, device=device)
    elif device is not None and isinstance(op, CSR):
        op = op.to(device)
    if hasattr(op, "pad_vec"):
        # LOBPCG's block algebra is flat: the flat view pads per apply
        op = FlatViewOperator(op=op)
    n = op.shape[0]
    dt = _op_dtype(op, X0)
    dev = getattr(op, "device", None)
    shifted = ShiftedOperator(A=op, shift=sigma)
    inv = InvertedOperator(A=shifted, M=M_inner, inner_tol=float(inner_tol),
                           inner_max_iter=int(inner_max_iter), method=str(inner_method))

    # per-pass block size: each pass hunts k pairs (either side of σ may
    # hold all k nearest)
    if X0 is None:
        X0 = torch.as_tensor(np.random.default_rng(seed).standard_normal((n, k))).to(dt)
    else:
        X0 = torch.as_tensor(X0)
        if tuple(X0.shape) != (n, k):
            raise IncompatibleMatrixFormat(f"X0 must be ({n}, {k}), got {tuple(X0.shape)}")
    X0 = X0.to(dtype=dt, device=dev)

    passes = {"both": (True, False), "above": (True,), "below": (False,)}[side]
    # μ-space LOBPCG runs a decade tighter than tol: the 1/(λ−σ) transform
    # dilates residuals near σ, and CONVERGED below is the MEASURED
    # A-residual ≤ tol
    cand_vecs, total_its = [], 0
    for largest in passes:
        _, Xp, info_p = lobpcg(inv, X0, largest=largest, tol=tol / 10, max_iter=max_iter)
        total_its += int(info_p.iterations)
        cand_vecs.append(Xp)

    # merge on the host: Rayleigh quotients on the ORIGINAL operator, dedupe
    # (a pair straddling both passes appears twice), pick k nearest σ
    Xall = torch.cat(cand_vecs, dim=1)
    lam_all, rel_all = _rayleigh_and_residuals(op, Xall)
    lam, Xsel, info = _select_nearest(lam_all, rel_all, Xall.cpu().numpy(), sigma, side, k,
                                      tol, total_its)
    return lam.to(dev), Xsel.to(dev), info


def _select_nearest(lam_all, rel_all, Xnp, sigma, side, k, tol, total_its):
    """Merge candidate pairs: side filter, |λ−σ| order, dedupe, pick k.

    CONVERGED is gated on the measured residuals of the returned pairs on
    the original A, not on the inner LOBPCG passes' status: the μ-iteration
    may hit its budget while the Rayleigh quotients on A are within tol,
    and a converged μ-pass with sloppy inner solves could return bad pairs.
    """
    if side == "above":
        keep0 = lam_all >= sigma
    elif side == "below":
        keep0 = lam_all < sigma
    else:
        keep0 = np.ones_like(lam_all, bool)
    order = np.argsort(np.abs(lam_all - sigma))
    sel, lam_sel, rel_sel = [], [], []
    for i in order:
        if not keep0[i]:
            continue
        if any(abs(np.vdot(Xnp[:, i], Xnp[:, j])) > 0.9 for j in sel):
            continue
        sel.append(i)
        lam_sel.append(lam_all[i])
        rel_sel.append(rel_all[i])
        if len(sel) == k:
            break
    lam = torch.as_tensor(np.array(lam_sel, dtype=lam_all.dtype))
    X = torch.as_tensor(np.ascontiguousarray(Xnp[:, sel]))
    worst = float(np.max(rel_sel)) if rel_sel else float("inf")
    status = (Status.CONVERGED if (len(sel) == k and worst <= tol)
              else Status.INSUFFICIENT_ITER)
    return lam, X, make_info(total_its, torch.tensor(worst, dtype=torch.float64), status)
