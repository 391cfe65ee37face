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

Distributed (``group=``, the JAX package's ``axis_name``): the rows of
every block are this rank's, A does its own exchange (``HaloDIA.matmat``:
one for the whole block), and the only other collectives are all-reduces
of column norms and of k×k / 3k×3k Gram matrices (``vecalg.group_sum``).
QR of the row-partitioned basis becomes shifted CholQR2 (two rounds of
G = Σ SᴴS, Cholesky of G + σI, a triangular solve), and every rank solves
the small eigenproblem from the same all-reduced bits, so λ and the
``SolveInfo`` come out the same on every rank. The refills fold the rank
into their tag, as ``fold_in(key, axis_index)`` does: the same draw on
every rank would make the global vector block-periodic.
:func:`~sprsolve_tpu_torch.parallel.distributed_lobpcg` is the driver.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..errors import IncompatibleMatrixFormat, Status
from ..vecalg import full_precision_matmul as mm
from ..vecalg import group_sum, real_dtype
from .common import block_apply, make_info


def _col_norms(X: torch.Tensor, rdt, group=None) -> torch.Tensor:
    return torch.sqrt(group_sum(torch.sum(X.abs() ** 2, dim=0), group)).to(rdt)


def _fresh_directions(tag, shape, dtype, device) -> torch.Tensor:
    """Standard-normal draws of ``shape`` (real, cast to ``dtype``) from a
    generator seeded by ``tag``: ``(0,)`` for the initial P, ``(its + 1,
    17)`` and ``(its + 1, 29)`` for the W and P refills of iteration
    ``its``, each with the rank appended in a distributed solve — the
    ``fold_in`` path of the JAX package's keys
    (``sprsolve_tpu/solvers/lobpcg.py:63-71, 232-266``). The same tag gives
    the same draw on one device from run to run."""
    seed = int(np.random.SeedSequence(list(tag)).generate_state(1)[0])
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.randn(shape, generator=gen, dtype=real_dtype(dtype),
                       device=device).to(dtype)


def _safe_colnormalize(X: torch.Tensor, tag, rdt, tiny, group=None) -> torch.Tensor:
    """Normalise the columns; a column of norm ≤ ``tiny`` is replaced by a
    fresh normalised direction (keeps S full-rank). With ``group`` the
    norms are global and the rank is folded into the draw's tag."""
    nrm = _col_norms(X, rdt, group)
    if group is not None:
        tag = tuple(tag) + (dist.get_rank(group),)
    bad = nrm <= tiny
    fresh = _fresh_directions(tag, tuple(X.shape), X.dtype, X.device)
    fresh = fresh / _col_norms(fresh, rdt, group)[None, :]
    Xn = X / torch.where(bad, torch.ones_like(nrm), nrm)[None, :]
    return torch.where(bad[None, :], fresh, Xn)


def lobpcg(A, X0, *, M=None, largest: bool = False, tol: float = 1e-6,
           max_iter: int = 200, buffer: int = 0, group=None):
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

    ``group``: run row-partitioned over a ``torch.distributed`` group (the
    JAX package's ``axis_name``; the driver is
    :func:`~sprsolve_tpu_torch.parallel.distributed_lobpcg`). ``A`` is this
    rank's part of a distributed operator with the global shape, ``X0``
    and the returned X this rank's rows of one of the group's equal row
    blocks; λ and the ``SolveInfo`` are the same on every rank.
    """
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

    if group is None and hasattr(A, "pad_vec"):
        # the block algebra is flat: each apply pads, runs K1b, unpads
        A = FlatViewOperator(op=A)
    if group is None and M is not None and hasattr(M, "pad_vec"):
        M = FlatViewOperator(op=M)
    n, k = X0.shape
    rows = n if group is None else n * dist.get_world_size(group)
    if getattr(A, "shape", None) is not None and A.shape[1] != rows:
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

    def orthonormalize(S):
        if group is None:
            return torch.linalg.qr(S).Q
        # shifted CholQR2, the QR of a row-partitioned basis
        # (sprsolve_tpu/solvers/lobpcg.py:185-208): each round one
        # all-reduced Gram matrix, the same Cholesky on every rank and
        # S ← S·L⁻ᴴ locally; the σ-shift keeps the factor finite when
        # converged directions make S numerically rank-deficient. S·L⁻ᴴ is
        # one product with the small inverse: a triangular solve with a
        # million rows as right-hand sides crawls on the card
        dim = S.shape[1]
        eye = torch.eye(dim, dtype=T, device=dev)
        shift = 100.0 * torch.finfo(rdt).eps
        for _ in range(2):
            G = group_sum(mm(S.conj().T, S), group)
            sigma = shift * torch.real(torch.trace(G)).to(rdt) / dim
            L = torch.linalg.cholesky(G + sigma.to(T) * eye)
            S = mm(S, torch.linalg.solve_triangular(L, eye, upper=False).conj().T)
        return S

    def rayleigh_ritz(S):
        """Orthonormalise S, project A, solve the small Hermitian problem:
        (X, λ, A·X), A·X = (A·Q)·Y reusing the projection's apply."""
        Q = orthonormalize(S)
        AQ = block_apply(A, Q)
        Tm = group_sum(mm(Q.conj().T, AQ), group)
        Tm = (Tm + Tm.conj().T) * half
        evals, V = torch.linalg.eigh(Tm)   # ascending
        if largest:
            lam, Y = evals[-k:].flip(0), V[:, -k:].flip(1)
        else:
            lam, Y = evals[:k], V[:, :k]
        return mm(Q, Y), lam, mm(AQ, Y)

    def residual(X_, lam_, AX_):
        return AX_ - X_ * lam_[None, :].to(T)

    def worst(R, lam_):
        scale = lam_.abs() + torch.max(lam_.abs())
        rel = _col_norms(R, rdt, group) / torch.maximum(scale, tiny)
        # buffer columns never gate convergence
        return torch.max(rel[:k_want])

    X, lam, AX = rayleigh_ritz(X0)
    P = _safe_colnormalize(torch.zeros_like(X), (0,), rdt, tiny, group)
    resmax = worst(residual(X, lam, AX), lam)
    its = 0
    while its < max_iter and bool(resmax > tol_t):   # the iteration's one host read
        R = residual(X, lam, AX)
        W = R if M is None else block_apply(M, R)
        W = _safe_colnormalize(W, (its + 1, 17), rdt, tiny, group)
        S = torch.cat([X, W, P], dim=1)
        X_new, lam, AX = rayleigh_ritz(S)
        P = _safe_colnormalize(X_new - mm(X, group_sum(mm(X.conj().T, X_new), group)),
                               (its + 1, 29), rdt, tiny, group)
        X = X_new
        resmax = worst(residual(X, lam, AX), lam)
        its += 1

    status = Status.CONVERGED if bool(resmax <= tol_t) else Status.INSUFFICIENT_ITER
    # the wanted pairs ascending whatever the search direction (buffer
    # columns are scaffolding, not results)
    lam_w, X_w = lam[:k_want], X[:, :k_want]
    order = torch.argsort(lam_w)
    return lam_w[order], X_w[:, order], make_info(its, resmax, status)
