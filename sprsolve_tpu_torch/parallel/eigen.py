"""Row-partitioned eigensolvers on a ``torch.distributed`` group.

Counterpart of ``sprsolve_tpu/parallel/eigen.py``: LOBPCG, shift-invert and
the rational filter with every block's rows partitioned over the ranks of a
group, as :func:`~sprsolve_tpu_torch.parallel.distributed_solve` partitions
a solve. Every rank calls the same driver with the same arguments (SPMD),
the solvers run with ``group=`` (the JAX package's ``axis_name`` inside
``shard_map``), and every rank returns the global ``(lam, X, info)``.

One distributed LOBPCG iteration:

- the (rows, 3k) block apply makes ONE exchange for the whole block
  (``HaloDIA.matmat``: one halo exchange; ``AllGatherELL.matmat``: one
  all-gather), whatever k;
- every k×k / 3k×3k Gram matrix and every set of column norms is one
  all-reduce;
- QR of the row-partitioned basis is shifted CholQR2 (no gather of the
  basis);
- every rank solves the 3k×3k Rayleigh–Ritz problem from the same
  all-reduced bits, so λ and the ``SolveInfo`` come out the same on every
  rank.

Shift-invert runs that LOBPCG on an
:class:`~sprsolve_tpu_torch.solvers.eigs.InvertedOperator` whose applies
are lockstep block MINRES solves over the group (one exchange and two
all-reduces a lockstep iteration, whatever the block's width); the rational
filter runs its node solves as lockstep block COCG over the group (one
exchange and three all-reduces a lockstep iteration, both planes of the
complex block in one real block apply) and its orthonormalisation as
CholQR2.

Padding: n is padded to a multiple of the group's size with DECOUPLED rows.
For LOBPCG their diagonal sits strictly outside the wanted end of the
spectrum (Gershgorin), so Rayleigh–Ritz can never select a pad pair, and
the pad rows of X0 start at zero; for the other two it is σ + 2·D (D the
largest distance from σ to the Gershgorin bounds), strictly farther from σ
than every true eigenvalue, and the inner systems stay nonsingular on the
pad rows. A pre-partitioned operator carries its padded global shape, so
every row of it counts as real: its size must be a multiple of the
group's.

The block applies are torch ops (``HaloDIA``, ``AllGatherELL``), as they are
XLA ops in the JAX package; no hand kernel lies on this path.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..errors import IncompatibleMatrixFormat
from ..precond import DiagPrecond
from ..sparse.containers import CSR, DIA
from ..utils.bounds import gershgorin_bounds
from .comm import all_gather_rows
from .dist_operator import AllGatherELL, HaloDIA, partition_csr, partition_dia
from .solve import default_device, local_part


def _set_pad_diag(A_parts, n: int, pad_val: float):
    """Rewrite the pad rows' diagonal (identity after ``partition_*``) to
    ``pad_val``; the pad rows stay decoupled from the real ones."""
    if A_parts.shape[0] == n:
        return A_parts
    if isinstance(A_parts, HaloDIA):
        bands = A_parts.bands.clone()
        bands[A_parts.offsets.index(0), n:] = pad_val
        return dataclasses.replace(A_parts, bands=bands)
    data = A_parts.data.clone()
    data[n:, 0] = pad_val
    return dataclasses.replace(A_parts, data=data)


def _pad_rows(A_parts, n: int, largest: bool, bounds):
    """Put the pad diagonal strictly outside the wanted end of the
    spectrum."""
    lo, hi = bounds
    span = max(hi - lo, 1.0)
    return _set_pad_diag(A_parts, n, (lo - span) if largest else (hi + span))


def _context(group, device):
    """``(group, device, world)``: the world group and ``cuda:{LOCAL_RANK}``
    by default; raises without an initialised process group."""
    if not dist.is_initialized():
        raise RuntimeError("the distributed eigensolvers need an initialised process "
                           "group (torch.distributed.init_process_group, or "
                           "parallel.multihost.initialize)")
    group = dist.group.WORLD if group is None else group
    device = default_device() if device is None else torch.device(device)
    return group, device, dist.get_world_size(group)


def _partitioned(A, world: int):
    """``(A_parts, n, bounds)``: a host CSR/DIA partitioned into ``world``
    row blocks with its Gershgorin bounds, or a pre-partitioned operator as
    it is (``bounds`` None; its size must be a multiple of ``world``)."""
    if isinstance(A, CSR):
        return partition_csr(A, world), A.shape[0], gershgorin_bounds(A)
    if isinstance(A, DIA):
        return partition_dia(A, world), A.shape[0], gershgorin_bounds(A)
    if isinstance(A, (AllGatherELL, HaloDIA)):
        if A.shape[0] % world:
            raise ValueError(f"a pre-partitioned operator of {A.shape[0]} rows does not "
                             f"split into {world} equal row blocks")
        return A, A.shape[0], None
    raise TypeError(f"cannot partition operator of type {type(A)}")


def _padded(X: np.ndarray, n_pad: int) -> np.ndarray:
    """X with zero rows appended up to ``n_pad``."""
    return np.concatenate([X, np.zeros((n_pad - X.shape[0],) + X.shape[1:], X.dtype)])


def _diag_parts(M, n_pad: int, group, device, what: str):
    """This rank's part of a ``DiagPrecond``, its reciprocal padded with 1
    (keeps the decoupled pad coordinates inert)."""
    if not isinstance(M, DiagPrecond):
        raise TypeError(f"{what} supports a DiagPrecond")
    di = torch.as_tensor(M.diag_inv)
    if di.shape[0] != n_pad:
        di = torch.cat([di, torch.ones(n_pad - di.shape[0], dtype=di.dtype,
                                       device=di.device)])
    return DiagPrecond(diag_inv=local_part(di, 0, group, device))


def _start_block(rng, n: int, k: int, dtype: torch.dtype) -> np.ndarray:
    """Standard-normal (n, k) draws, complex for a complex ``dtype``."""
    X = rng.standard_normal((n, k))
    if dtype.is_complex:
        X = X + 1j * rng.standard_normal((n, k))
    return X


def distributed_lobpcg(A, k: Optional[int] = None, X0=None, *, M=None, largest: bool = False,
                       tol: float = 1e-6, max_iter: int = 200, buffer: int = 0, group=None,
                       device=None, seed: int = 0):
    """The k smallest (or largest) eigenpairs of Hermitian ``A``,
    row-partitioned over ``group`` (default: the world group).

    ``A`` is a host CSR/DIA (partitioned here: ``AllGatherELL`` or
    ``HaloDIA``) or an operator already partitioned by
    :func:`~sprsolve_tpu_torch.parallel.partition_csr` /
    :func:`~sprsolve_tpu_torch.parallel.partition_dia`. Give ``k`` (random
    X0 from ``seed``) or a global (n, k) ``X0``. ``M`` is a
    :class:`~sprsolve_tpu_torch.precond.DiagPrecond`; its diagonal is cut
    with the rows. The solve runs on ``device`` (default
    ``cuda:{LOCAL_RANK}``, which must exist). Returns the global ``(lam, X,
    info)`` of :func:`~sprsolve_tpu_torch.solvers.lobpcg.lobpcg` on every
    rank, on ``device``."""
    from ..solvers.lobpcg import lobpcg

    group, device, world = _context(group, device)
    A_parts, n, bounds = _partitioned(A, world)
    n_pad = A_parts.shape[0]
    if bounds is not None:
        A_parts = _pad_rows(A_parts, n, largest, bounds)
    if X0 is None:
        if k is None:
            raise ValueError("give either k or an explicit X0")
        X0 = torch.as_tensor(_start_block(np.random.default_rng(seed), n, k,
                                          A_parts.dtype)).to(A_parts.dtype)
    else:
        X0 = torch.as_tensor(X0).cpu()
    # the pad rows start exactly zero (decoupled coordinates)
    X0 = torch.cat([X0, torch.zeros((n_pad - n, X0.shape[1]), dtype=X0.dtype)])
    M_l = None if M is None else _diag_parts(M, n_pad, group, device, "distributed_lobpcg")
    lam, X, info = lobpcg(local_part(A_parts, A_parts.pspec(), group, device),
                          local_part(X0, 0, group, device), M=M_l, largest=largest, tol=tol,
                          max_iter=max_iter, buffer=buffer, group=group)
    return lam, all_gather_rows(X, group)[:n], info


def _check_interior(k: int, side: str) -> None:
    if k < 1:
        raise IncompatibleMatrixFormat(f"need k >= 1, got {k}")
    if side not in ("both", "above", "below"):
        raise IncompatibleMatrixFormat(
            f"side must be 'both', 'above' or 'below', got {side!r}")


def _sigma_pad(A_parts, n: int, bounds, sigma: float):
    """Pad rows at σ + 2·D: farther from σ than every true eigenvalue."""
    lo, hi = bounds
    D = max(abs(hi - sigma), abs(lo - sigma), 1.0)
    return _set_pad_diag(A_parts, n, sigma + 2.0 * D)


def distributed_shift_invert_eigs(A, k: int, sigma: float, *, side: str = "both",
                                  M_inner=None, inner_tol: Optional[float] = None,
                                  inner_max_iter: int = 400, tol: float = 1e-6,
                                  max_iter: int = 100, group=None, device=None,
                                  seed: int = 0):
    """The ``k`` eigenpairs of Hermitian ``A`` nearest ``sigma``,
    row-partitioned over ``group``: the distributed composition of
    :func:`~sprsolve_tpu_torch.solvers.eigs.shift_invert_eigs`.

    Each pass is one distributed LOBPCG on the inverted operator, whose
    every apply is a lockstep block MINRES on this rank's rows of
    A − σI (``M_inner``, a ``DiagPrecond``, preconditions it). The passes'
    vectors are gathered, their pad rows cut, the pad-dominated columns
    dropped (a true eigenvector has exactly zero pad coordinates), and the
    Rayleigh quotients and residuals taken on the original rows through the
    distributed operator. ``A`` as in :func:`distributed_lobpcg`. Returns
    ``(lam, X, info)`` as the single-device driver does, on every rank, on
    ``device``."""
    from ..ops.operator import ShiftedOperator
    from ..solvers.eigs import InvertedOperator, _select_nearest
    from ..solvers.lobpcg import lobpcg

    _check_interior(k, side)
    if inner_tol is None:
        inner_tol = min(tol * 1e-2, 1e-8)
    group, device, world = _context(group, device)
    A_parts, n, bounds = _partitioned(A, world)
    n_pad = A_parts.shape[0]
    if bounds is not None:
        A_parts = _sigma_pad(A_parts, n, bounds, sigma)
    dt = A_parts.dtype
    A_l = local_part(A_parts, A_parts.pspec(), group, device)
    M_l = (None if M_inner is None else
           _diag_parts(M_inner, n_pad, group, device, "distributed_shift_invert_eigs"))
    inv = InvertedOperator(A=ShiftedOperator(A=A_l, shift=sigma), M=M_l,
                           inner_tol=float(inner_tol), inner_max_iter=int(inner_max_iter),
                           group=group)
    X0 = torch.as_tensor(_padded(_start_block(np.random.default_rng(seed), n, k, dt),
                                 n_pad)).to(dt)
    X0_l = local_part(X0, 0, group, device)

    passes = {"both": (True, False), "above": (True,), "below": (False,)}[side]
    cand, total_its = [], 0
    for largest in passes:
        # μ-space runs a decade tighter than tol, as on one device; the
        # CONVERGED gate below is the measured A-residual
        _, Xp, info_p = lobpcg(inv, X0_l, largest=largest, tol=tol / 10, max_iter=max_iter,
                               group=group)
        total_its += int(info_p.iterations)
        cand.append(all_gather_rows(Xp, group).cpu().numpy())

    # merge: cut the pad rows, drop the pad-dominated columns, then Rayleigh
    # quotients and residuals on the original rows (the pad rows are
    # decoupled, so zero-padded columns see exactly A)
    Xall = np.concatenate(cand, axis=1)[:n]
    norms = np.linalg.norm(Xall, axis=0)
    keep = norms > 0.5
    Xall = Xall[:, keep] / norms[keep]
    AX = A_l.matmat(local_part(torch.as_tensor(_padded(Xall, n_pad)), 0, group, device))
    AXn = all_gather_rows(AX, group).cpu().numpy()[:n]
    lam_all = np.real(np.sum(np.conj(Xall) * AXn, axis=0))
    R = AXn - Xall * lam_all[None, :].astype(Xall.dtype)
    rel_all = np.linalg.norm(R, axis=0) / np.maximum(np.abs(lam_all),
                                                     np.finfo(lam_all.dtype).tiny)
    lam, X, info = _select_nearest(lam_all, rel_all, Xall, sigma, side, k, tol, total_its)
    return lam.to(device), X.to(device), info


def distributed_rational_filter_eigs(A, k: int, sigma: float, *,
                                     radius: Optional[float] = None, side: str = "both",
                                     m0: Optional[int] = None, n_quad: int = 6,
                                     inner_tol: Optional[float] = None,
                                     inner_max_iter: int = 600, contour_aspect: float = 3.0,
                                     inner_refine: int = 0, tol: float = 1e-6,
                                     max_iter: int = 8, group=None, device=None,
                                     seed: int = 0):
    """The ``k`` eigenpairs of real-symmetric ``A`` nearest ``sigma``,
    row-partitioned over ``group``: the distributed composition of
    :func:`~sprsolve_tpu_torch.solvers.rational.rational_filter_eigs`.

    Per subspace iteration: each quadrature node's m0 right-hand sides run
    as one lockstep block COCG on this rank's rows (the complex apply takes
    both planes of the block in one real block apply, so one exchange a
    lockstep iteration), the orthonormalisation is CholQR2 with all-reduced
    Gram matrices, and every rank solves the m0×m0 Rayleigh–Ritz problem
    from the same bits. ``inner_refine`` runs its complex128 true residuals
    on a partitioned f64 copy of ``A`` (the card has native f64). ``A`` is
    a host CSR/DIA. The final disc filter uses the radius that produced the
    kept pairs, not the current one. Returns ``(lam, X, info)`` as the
    single-device driver does, on every rank, on ``device``."""
    from ..solvers.eigs import _select_nearest
    from ..solvers.rational import _kept, _subspace_iterations

    _check_interior(k, side)
    if m0 is None:
        m0 = max(2 * k, k + 6)
    if inner_tol is None:
        inner_tol = min(tol * 1e-2, 1e-7)
    group, device, world = _context(group, device)
    if not isinstance(A, (CSR, DIA)):
        raise TypeError("distributed_rational_filter_eigs needs a host CSR/DIA container, "
                        f"got {type(A)}")
    A_parts, n, bounds = _partitioned(A, world)
    n_pad = A_parts.shape[0]
    rdt = A_parts.dtype
    if rdt not in (torch.float32, torch.float64):
        raise IncompatibleMatrixFormat(
            "rational filter needs a real symmetric operator "
            f"(dtype {rdt}); use distributed_shift_invert_eigs for complex")
    A_parts = _sigma_pad(A_parts, n, bounds, sigma)
    A64_l = None
    if inner_refine:
        if isinstance(A, CSR):
            src64 = dataclasses.replace(A, data=torch.as_tensor(A.data).to(torch.float64))
        else:
            src64 = dataclasses.replace(A, bands=torch.as_tensor(A.bands).to(torch.float64))
        A64 = _sigma_pad(_partitioned(src64, world)[0], n, bounds, sigma)
        A64_l = local_part(A64, A64.pspec(), group, device)
    Y0 = torch.as_tensor(_padded(np.random.default_rng(seed).standard_normal((n, m0)),
                                 n_pad)).to(rdt)
    lam_np, rel_np, V, r_best, total_inner = _subspace_iterations(
        local_part(A_parts, A_parts.pspec(), group, device), A64_l,
        local_part(Y0, 0, group, device), sigma=sigma, radius=radius, bounds=bounds,
        side=side, k=k, n_quad=n_quad, contour_aspect=contour_aspect, inner_tol=inner_tol,
        inner_max_iter=inner_max_iter, inner_refine=inner_refine, tol=tol,
        max_iter=max_iter, group=group)
    Vn = all_gather_rows(V, group).cpu().numpy()[:n]
    keep = _kept(lam_np, rel_np, sigma, r_best, tol, rdt)
    lam, X, info = _select_nearest(lam_np[keep], rel_np[keep], Vn[:, keep], sigma, side, k,
                                   tol, total_inner)
    return lam.to(device), X.to(device), info
