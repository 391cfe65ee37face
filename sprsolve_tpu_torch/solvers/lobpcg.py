"""LOBPCG: preconditioned block eigensolver for extreme eigenpairs.

Counterpart of ``sprsolve_tpu/solvers/lobpcg.py`` (beyond the reference,
whose surface is linear solvers; cf. ``scipy.sparse.linalg.lobpcg``). Per
iteration the work is one operator apply on an (n, 3k) block — one K1b
launch on a padded operator's flat view — a QR and a 3k×3k Hermitian
eigendecomposition.

Design (robust basis variant, as in the JAX package): the search space
S = [X, W, P] (current iterates, preconditioned residuals, direction
history) is re-orthonormalised with one QR every iteration, then
Rayleigh–Ritz reduces A to QᴴAQ; A·X is carried, so A is applied once per
iteration. P is the difference direction X_new − X·(XᴴX_new),
column-normalised, and a column that degenerates (converged directions
make S rank-deficient) is refilled with a fresh pseudo-random direction.

The loop is a Python ``while`` with one host read per iteration (the
convergence test). Every product of the block algebra goes through
:func:`~sprsolve_tpu_torch.vecalg.full_precision_matmul` (TF32 off): at a
million rows a 10-bit mantissa in the Rayleigh–Ritz projections would
leave the residuals stuck. The refills come from
:func:`_fresh_directions`, a seeded torch generator: JAX's
``jax.random`` draws cannot be reproduced in torch, so the cross tests
patch that one function with the JAX package's draws.

The distributed form (``axis_name``, shifted CholQR2 over a mesh axis) is
ROADMAP Queue 1 item 13 and is not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from ..errors import IncompatibleMatrixFormat, Status
from ..vecalg import full_precision_matmul as mm
from ..vecalg import real_dtype
from .common import block_apply, make_info


def _col_norms(X: torch.Tensor, rdt) -> torch.Tensor:
    return torch.sqrt(torch.sum(X.abs() ** 2, dim=0)).to(rdt)


def _fresh_directions(tag, shape, dtype, device) -> torch.Tensor:
    """Standard-normal draws of ``shape`` (real, cast to ``dtype``) from a
    generator seeded by ``tag``: ``(0,)`` for the initial P, ``(its + 1,
    17)`` and ``(its + 1, 29)`` for the W and P refills of iteration
    ``its`` — the ``fold_in`` path of the JAX package's keys
    (``sprsolve_tpu/solvers/lobpcg.py:232-266``). The same tag gives the
    same draw on one device from run to run."""
    seed = int(np.random.SeedSequence(list(tag)).generate_state(1)[0])
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.randn(shape, generator=gen, dtype=real_dtype(dtype),
                       device=device).to(dtype)


def _safe_colnormalize(X: torch.Tensor, tag, rdt, tiny) -> torch.Tensor:
    """Normalise the columns; a column of norm ≤ ``tiny`` is replaced by a
    fresh normalised direction (keeps S full-rank)."""
    nrm = _col_norms(X, rdt)
    bad = nrm <= tiny
    fresh = _fresh_directions(tag, tuple(X.shape), X.dtype, X.device)
    fresh = fresh / _col_norms(fresh, rdt)[None, :]
    Xn = X / torch.where(bad, torch.ones_like(nrm), nrm)[None, :]
    return torch.where(bad[None, :], fresh, Xn)


def lobpcg(A, X0, *, M=None, largest: bool = False, tol: float = 1e-6,
           max_iter: int = 200, buffer: int = 0, axis_name=None):
    """Compute the ``k`` smallest (or largest) eigenpairs of Hermitian ``A``.

    ``X0`` is the (n, k) initial block (random is fine; it is
    orthonormalised here), moved to the operator's device: the solve runs
    where ``A`` lives (the CUDA device for what ``optimize()`` returns by
    default). Returns ``(lam, X, info)``: ascending real eigenvalues
    ``(k,)``, orthonormal eigenvectors ``(n, k)``, and a
    :class:`~sprsolve_tpu_torch.errors.SolveInfo` whose ``residual`` is the
    worst relative residual ‖A·xᵢ − λᵢ·xᵢ‖ / (|λᵢ| + max|λ|).

    Convergence: all ``k`` pairs below ``tol`` (relative). ``M`` is a
    linear preconditioner apply (≈ A⁻¹, sensible for ``largest=False``).
    A padded operator (``pad_vec``), and such an ``M``, are applied through
    their flat view (:class:`~sprsolve_tpu_torch.multigrid.FlatViewOperator`).

    ``buffer``: extra guard columns iterated beside the wanted block (the
    convergence rate of pair i is set by the gap to the first eigenvalue
    outside the block); clamped so that 3·(k + buffer) < n. Convergence is
    tested on, and the return holds, the wanted ``k`` pairs only.
    """
    if axis_name is not None:
        raise NotImplementedError(
            "lobpcg(axis_name=...) is the distributed layer, ROADMAP Queue 1 item 13; "
            "the port runs on one device")
    dev = getattr(A, "device", None)
    X0 = torch.as_tensor(X0, device=dev)
    if X0.dim() != 2:
        raise IncompatibleMatrixFormat("X0 must be (n, k)")
    k_want = X0.shape[1]
    if buffer:
        buffer = max(0, min(int(buffer), (X0.shape[0] - 1) // 3 - k_want))
    if buffer:
        extra = np.random.default_rng(k_want).standard_normal((X0.shape[0], buffer))
        if X0.is_complex():
            extra = extra + 1j * np.random.default_rng(k_want + 1).standard_normal(
                extra.shape)
        X0 = torch.cat([X0, torch.as_tensor(extra).to(X0.dtype).to(X0.device)], dim=1)
    from ..multigrid import FlatViewOperator

    if hasattr(A, "pad_vec"):
        # the block algebra is flat: each apply pads, runs K1b, unpads
        A = FlatViewOperator(op=A)
    if M is not None and hasattr(M, "pad_vec"):
        M = FlatViewOperator(op=M)
    n, k = X0.shape
    if getattr(A, "shape", None) is not None and A.shape[1] != n:
        raise IncompatibleMatrixFormat("Input vec dimension doesn't match the matrix size")
    if 3 * k >= n:
        raise IncompatibleMatrixFormat(
            f"LOBPCG needs 3k < n (got k={k}, n={n}); use a dense eigensolver")
    T, dev = X0.dtype, X0.device
    rdt = real_dtype(T)
    tiny = torch.tensor(torch.finfo(rdt).tiny * 1e4, dtype=rdt, device=dev)
    tol_t = torch.tensor(tol, dtype=rdt, device=dev)
    max_iter = int(max_iter)
    half = torch.tensor(0.5, dtype=rdt, device=dev)

    def rayleigh_ritz(S):
        """Orthonormalise S, project A, solve the small Hermitian problem:
        (X, λ, A·X), A·X = (A·Q)·Y reusing the projection's apply."""
        Q = torch.linalg.qr(S).Q
        AQ = block_apply(A, Q)
        Tm = mm(Q.conj().T, AQ)
        Tm = (Tm + Tm.conj().T) * half
        evals, V = torch.linalg.eigh(Tm)   # ascending
        if largest:
            lam, Y = evals[-k:].flip(0), V[:, -k:].flip(1)
        else:
            lam, Y = evals[:k], V[:, :k]
        return mm(Q, Y), lam, mm(AQ, Y)

    def residual_info(X_, lam_, AX_):
        R = AX_ - X_ * lam_[None, :].to(T)
        scale = lam_.abs() + torch.max(lam_.abs())
        rel = _col_norms(R, rdt) / torch.maximum(scale, tiny)
        # buffer columns never gate convergence
        return R, torch.max(rel[:k_want])

    X, lam, AX = rayleigh_ritz(X0)
    P = _safe_colnormalize(torch.zeros_like(X), (0,), rdt, tiny)
    _, resmax = residual_info(X, lam, AX)
    its = 0
    while its < max_iter and bool(resmax > tol_t):   # the iteration's one host read
        R, _ = residual_info(X, lam, AX)
        W = R if M is None else block_apply(M, R)
        W = _safe_colnormalize(W, (its + 1, 17), rdt, tiny)
        S = torch.cat([X, W, P], dim=1)
        X_new, lam, AX = rayleigh_ritz(S)
        P = _safe_colnormalize(X_new - mm(X, mm(X.conj().T, X_new)), (its + 1, 29), rdt,
                               tiny)
        X = X_new
        _, resmax = residual_info(X, lam, AX)
        its += 1

    status = Status.CONVERGED if bool(resmax <= tol_t) else Status.INSUFFICIENT_ITER
    # the wanted pairs ascending whatever the search direction (buffer
    # columns are scaffolding, not results)
    lam_w, X_w = lam[:k_want], X[:, :k_want]
    order = torch.argsort(lam_w)
    return lam_w[order], X_w[:, order], make_info(its, resmax, status)
