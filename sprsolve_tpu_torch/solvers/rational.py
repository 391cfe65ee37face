"""Rational-filter (FEAST-style) interior eigensolver.

Counterpart of ``sprsolve_tpu/solvers/rational.py``. Interior eigenpairs
of a deep-spectrum Hermitian operator are where shift-invert is slow:
MINRES on the indefinite real shift A − σI is bound by the gap to the
nearest eigenvalue, and no SPD preconditioner open to MINRES helps. The
production method of contour-integral eigensolvers (FEAST, Polizzi 2009)
approximates the spectral projector onto the eigenspace inside a disc
around σ by a quadrature of the resolvent,

    ρ(A)·Y = (1/2πi) ∮_C (zI − A)⁻¹ Y dz  ≈  Σⱼ wⱼ·Re[(zⱼI − A)⁻¹ Y],

then runs subspace iteration with Rayleigh–Ritz on the filtered block.
Every node zⱼ sits off the real axis, so each inner system has
κ(zⱼI − A) ≤ ‖A‖/|Im zⱼ| however densely the real eigenvalues crowd σ.

Regime: the disc must hold about k eigenvalues, so its radius is about k
times the local eigenvalue spacing Δ at σ, and Im zⱼ about aspect times
the radius. Where Δ is comfortably above rounding scales the inner COCG
solves converge in O(√κ) iterations and the filter gives machine-grade
interior pairs; deep in the interior of a large operator the displaced
spectrum is indefinite and dense on the scale of Im z, the inner counts
grow like √(κ₊·κ₋), and :func:`shift_invert_eigs`, whose LOBPCG
tolerates sloppy inner solves, is the better method.

Composition on the card (no kernel of its own):

- zI − A for a real-symmetric A is complex symmetric, so the inner solver
  is COCG (one operator apply per iteration);
- the complex apply runs on the REAL fast path: both planes of the block
  go through one K1b launch (:meth:`_ComplexShifted.matmat`);
- the m0 right-hand sides of a node run as one lockstep block COCG
  (:func:`~sprsolve_tpu_torch.solvers.cocg._cocg_block`), so the matrix
  stream is shared by the block.

Accuracy contract as in :func:`shift_invert_eigs`: CONVERGED is gated on
the measured residuals ‖A·x − λx‖/|λ| of the returned pairs on the
original A.

Unlike the JAX package (``rational.py:486``), the final disc filter uses
the radius that produced the kept Ritz pairs, not the current one: a
calibration step may change the radius after the pairs were formed.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import Optional

import numpy as np
import torch

from ..errors import IncompatibleMatrixFormat
from ..vecalg import conj_dot, group_sum
from ..vecalg import full_precision_matmul as mm
from .cocg import _cocg_block
from .common import block_apply
from .eigs import _select_nearest

# env-gated per-iteration diagnostics on stderr (radius walk, Ritz
# spectrum, residuals)
_RF_DEBUG = bool(os.environ.get("SPRSOLVE_RF_DEBUG"))


@dataclasses.dataclass(frozen=True)
class _ComplexShifted:
    """(zr + i·zi)I − A on complex vectors, through REAL applies of A.

    A is a real flat-vector operator; the complex-symmetric structure COCG
    needs follows from Aᵀ = A."""

    A: object
    zr: object
    zi: object

    @property
    def shape(self):
        return self.A.shape

    def _combine(self, xr, xi, Axr, Axi):
        return torch.complex(self.zr * xr - self.zi * xi - Axr,
                             self.zr * xi + self.zi * xr - Axi)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        xr, xi = x.real, x.imag
        Axr = self.A.matvec(xr.contiguous())
        Axi = self.A.matvec(xi.contiguous())
        return self._combine(xr, xi, Axr, Axi)

    def matvec_dot(self, x: torch.Tensor):
        y = self.matvec(x)
        return y, conj_dot(x, y)

    def matmat(self, X: torch.Tensor) -> torch.Tensor:
        """Both planes of an (n, m) block in one block apply (one K1b
        launch on a padded operator's flat view): the interleaved planes
        are 2m real columns."""
        n, m = X.shape
        planes = torch.view_as_real(X.contiguous()).reshape(n, 2 * m)
        AX = block_apply(self.A, planes).reshape(n, m, 2)
        return self._combine(X.real, X.imag, AX[..., 0], AX[..., 1])


def _gauss_semicircle(n_quad: int, aspect: float = 1.0):
    """Gauss–Legendre nodes and weights for the upper half of an elliptic
    contour z(θ) = σ + r·(cos θ + i·aspect·sin θ).

    Returns complex constants ``(c_j, d_j)`` with z_j = σ + r·c_j and the
    filter applied as ρ(A)·Y ≈ Σⱼ Re[r·d_j·(z_jI − A)⁻¹ Y]: ρ(λ) =
    (1/2πi)∮ dz/(z−λ), dz = r·(−sin θ + i·aspect·cos θ)dθ, and conjugate
    symmetry of the real-λ integrand folds the lower half onto the upper.

    ``aspect`` is the conditioning knob: for a real spectrum only the
    crossings σ ± r matter (ρ is 1 inside and 0 outside for any height),
    while the inner systems' κ ≈ ‖A‖/|Im z_j| shrinks ∝ aspect; a taller
    contour softens the filter's edge slightly.
    """
    t, v = np.polynomial.legendre.leggauss(n_quad)
    theta = np.pi * (t + 1.0) / 2.0          # (0, π)
    c = np.cos(theta) + 1j * aspect * np.sin(theta)
    # (1/2πi)·2·(π/2)·v_j·dz/dθ / r  =  (v_j/2i)·(−sinθ + i·aspect·cosθ)
    d = (v / 2.0) * (aspect * np.cos(theta) + 1j * np.sin(theta))
    return c, d


def _cholqr(B: torch.Tensor, group=None) -> torch.Tensor:
    """One CholeskyQR round with a tiny trace-scaled ridge (directions the
    filter annihilated stay finite); two rounds give QR-grade
    orthogonality. With ``group`` B is this rank's rows and the Gram matrix
    is summed over the group (``sprsolve_tpu/parallel/eigen.py:539-553``)."""
    G = group_sum(mm(B.T, B), group)
    eps_r = float(torch.finfo(B.dtype).eps) * 100 * torch.trace(G)
    L = torch.linalg.cholesky(G + eps_r * torch.eye(G.shape[0], dtype=B.dtype,
                                                     device=B.device))
    return torch.linalg.solve_triangular(L, B.T, upper=False).T


def rational_filter_eigs(
    A,
    k: int,
    sigma: float,
    *,
    radius: Optional[float] = None,
    side: str = "both",
    m0: Optional[int] = None,
    n_quad: int = 6,
    inner_tol: Optional[float] = None,
    inner_max_iter: int = 600,
    contour_aspect: float = 3.0,
    inner_dtype=None,
    inner_refine: int = 0,
    tol: float = 1e-6,
    max_iter: int = 8,
    optimize_layout: bool = True,
    seed: int = 0,
    device=None,
):
    """The ``k`` eigenpairs of real-symmetric ``A`` nearest ``sigma``.

    Same return contract as :func:`shift_invert_eigs`: ``(lam, X, info)``
    with eigenvalues ordered by |λ − σ|, ``info.residual`` the worst
    measured A-residual of the returned pairs, ``info.iterations`` the
    TOTAL inner COCG iterations over every column of every quadrature
    solve (each one complex apply, two real SpMVs).

    ``radius``: half-width of the search disc around σ. ``None``
    auto-calibrates from a small fraction of the Gershgorin width, and
    expands or shrinks it between subspace iterations until the disc holds
    about ``k`` to ``m0`` Ritz values. ``m0`` (subspace size, default
    ``max(2k, k+6)``) must exceed the number of eigenvalues in the final
    disc. ``max_iter`` caps subspace iterations.

    ``contour_aspect`` (default 3): vertical stretch of the elliptic
    contour; the inner κ ≈ ‖A‖/|Im z| shrinks ∝ aspect. ``inner_max_iter``
    must cover the near-axis node: about √κ·ln(2/inner_tol)/2 with
    κ ≈ (hi−lo)/(r·aspect·sin θ_min); the tol exit makes a generous ceiling
    free.

    Where κ exceeds what f32 Krylov can resolve (attainable residual about
    ε·κ), two escapes:

    - ``inner_refine=p``: each node solve runs ``p`` refinement passes —
      a c64 COCG sweep on the correction after a complex128 true residual
      on an f64 torch DIA built from the CSR — and the quadrature sum is
      accumulated in f64 before the cast. Needs a CSR/CSC input.
    - ``inner_dtype="float64"``: the whole filter in f64, on a DIA rebuilt
      at that dtype.

    A CSR (or CSC) ``A`` is laid out by ``optimize()`` on ``device``
    (default: the CUDA device); an operator runs where it lives.
    """
    if k < 1:
        raise IncompatibleMatrixFormat(f"need k >= 1, got {k}")
    if side not in ("both", "above", "below"):
        raise IncompatibleMatrixFormat(
            f"side must be 'both', 'above' or 'below', got {side!r}")
    if m0 is None:
        m0 = max(2 * k, k + 6)
    if m0 < k:
        raise IncompatibleMatrixFormat(f"need m0 >= k, got m0={m0} < k={k}")
    if inner_tol is None:
        inner_tol = min(tol * 1e-2, 1e-7)

    from ..multigrid import FlatViewOperator
    from ..ops.optimize import default_device
    from ..ops.optimize import optimize as _optimize
    from ..sparse.containers import CSC, CSR
    from ..utils.bounds import gershgorin_bounds

    op = A
    bounds = None
    if isinstance(op, CSC):
        op = op.to_csr()
    op64 = None
    if inner_refine:
        if not isinstance(op, CSR):
            raise IncompatibleMatrixFormat(
                "inner_refine needs a CSR/CSC input (the f64 residual operator "
                "is built from it)")
        src64 = dataclasses.replace(op, data=op.data.to(torch.float64))
        try:
            op64 = src64.to_dia(device=default_device(device))
        except ValueError:
            op64 = src64.to(default_device(device))
    if inner_dtype is not None:
        idt = inner_dtype if isinstance(inner_dtype, torch.dtype) else getattr(
            torch, str(np.dtype(inner_dtype)))
        if not isinstance(op, CSR):
            raise IncompatibleMatrixFormat(
                "inner_dtype override needs a CSR/CSC input (the operator is "
                "rebuilt at that dtype)")
        bounds = gershgorin_bounds(op)
        src = dataclasses.replace(op, data=op.data.to(idt))
        try:
            op = src.to_dia(device=default_device(device))
        except ValueError:
            op = src.to(default_device(device))
    elif isinstance(op, CSR):
        bounds = gershgorin_bounds(op)
        if optimize_layout:
            op = _optimize(op, device=device)
        elif device is not None:
            op = op.to(device)
    if hasattr(op, "pad_vec"):
        op = FlatViewOperator(op=op)
    n = op.shape[0]

    dt = getattr(op, "dtype", None)
    if dt is None and hasattr(op, "op"):
        dt = getattr(op.op, "dtype", None)
    rdt = torch.float64 if dt is None else dt
    if rdt not in (torch.float32, torch.float64):
        raise IncompatibleMatrixFormat(
            "rational_filter_eigs needs a real symmetric operator "
            f"(dtype {rdt}); for Hermitian complex use shift_invert_eigs")
    dev = getattr(op, "device", None)
    Y0 = torch.as_tensor(np.random.default_rng(seed).standard_normal((n, m0))).to(
        dtype=rdt, device=dev)
    if radius is None and bounds is None:
        raise IncompatibleMatrixFormat(
            "radius=None auto-calibration needs a CSR/CSC input (Gershgorin "
            "seed); pass radius= for a bare operator")
    lam_np, rel_np, V, r_best, total_inner = _subspace_iterations(
        op, op64, Y0, sigma=sigma, radius=radius, bounds=bounds, side=side, k=k,
        n_quad=n_quad, contour_aspect=contour_aspect, inner_tol=inner_tol,
        inner_max_iter=inner_max_iter, inner_refine=inner_refine, tol=tol,
        max_iter=max_iter)
    keep = _kept(lam_np, rel_np, sigma, r_best, tol, rdt)
    lam, X, info = _select_nearest(lam_np[keep], rel_np[keep], V.cpu().numpy()[:, keep],
                                   sigma, side, k, tol, total_inner)
    return lam.to(dev), X.to(dev), info


def _ghost_threshold(tol: float, rdt) -> float:
    """The residual above which a Ritz pair is a ghost, not an eigenpair."""
    return max(10.0 * tol, float(np.sqrt(torch.finfo(rdt).eps)))


def _kept(lam_np, rel_np, sigma, r_best, tol, rdt):
    """The final selection's mask: the disc filter, with the radius that
    produced these pairs, and the ghost filter (a Ritz value whose measured
    residual sits orders above tol is a boundary artefact)."""
    return (np.abs(lam_np - sigma) <= r_best) & (rel_np <= _ghost_threshold(tol, rdt))


def _subspace_iterations(op, op64, Y0, *, sigma, radius, bounds, side, k, n_quad,
                         contour_aspect, inner_tol, inner_max_iter, inner_refine, tol,
                         max_iter, group=None):
    """The filter's subspace iteration with Rayleigh–Ritz and the radius
    calibration, shared by :func:`rational_filter_eigs` and the distributed
    driver. ``op`` is the real operator (``op64`` its f64 copy for
    ``inner_refine``), ``Y0`` the (rows, m0) start block. With ``group``
    the operators are this rank's parts and the blocks this rank's rows;
    the Gram matrices, norms and trace estimates are summed over the group
    and every rank takes the same branches. Returns ``(λ, residuals, V,
    radius, total inner iterations)`` of the kept pass: λ and residuals as
    NumPy arrays, V (this rank's rows of) its Ritz block, and the radius
    that produced them."""
    rdt, dev = Y0.dtype, Y0.device
    m0 = Y0.shape[1]
    cdt = torch.complex64 if rdt == torch.float32 else torch.complex128
    c_np, d_np = _gauss_semicircle(int(n_quad), float(contour_aspect))
    scalar = lambda v, t=rdt: torch.tensor(v, dtype=t, device=dev)

    def _solve_node(Yc, zr, zi):
        opz = _ComplexShifted(A=op, zr=zr, zi=zi)
        X, info, _ = _cocg_block(opz, Yc, tol=inner_tol, max_iter=inner_max_iter,
                                 group=group)
        return X, int(info.iterations.sum())

    def _one_node(Yc, zr, zi):
        X, its = _solve_node(Yc, zr, zi)
        if not inner_refine:
            return X, its
        # mixed-precision refinement: the c64 COCG sweep floors out at about
        # ε₃₂·κ relative accuracy; a complex128 true residual against the f64
        # operator restarts the sweep on the correction
        z64 = torch.complex(zr.to(torch.float64), zi.to(torch.float64))
        X64, Y64 = X.to(torch.complex128), Yc.to(torch.complex128)
        for _ in range(int(inner_refine)):
            R = Y64 - (z64 * X64 - block_apply(op64, X64))
            D, itd = _solve_node(R.to(cdt), zr, zi)
            X64 = X64 + D.to(torch.complex128)
            its += itd
        # kept in c128: the resolvent is near-singular, so ‖X‖ ≫ ‖Y‖ and a
        # cast here would inject ε₃₂·‖X‖ noise that survives the
        # quadrature's cross-node cancellation
        return X64, its

    def filter_and_ritz(Y, r):
        """One subspace iteration: Q = ρ(A)Y, Rayleigh–Ritz on Q."""
        Yc = Y.to(cdt)
        its = 0
        # with inner_refine the per-node X are near-singular-sized and
        # cancel across nodes: sum in f64, then cast the O(‖Y‖)-sized Q
        Q = torch.zeros(Y.shape, dtype=torch.float64 if inner_refine else rdt, device=dev)
        rq = r.to(Q.dtype)
        for j in range(int(n_quad)):
            zr = sigma + r * scalar(c_np[j].real)
            zi = r * scalar(c_np[j].imag)
            Xj, itj = _one_node(Yc, zr, zi)
            if inner_refine:
                Q = Q + rq * (float(d_np[j].real) * Xj.real - float(d_np[j].imag) * Xj.imag)
            else:
                Q = Q + rq * torch.real(scalar(d_np[j], cdt) * Xj)
            its += itj
        Q = Q.to(rdt)
        Qo = _cholqr(_cholqr(Q, group), group)
        AQ = block_apply(op, Qo)
        H = group_sum(mm(Qo.T, AQ), group)
        H = 0.5 * (H + H.T)
        lam, W = torch.linalg.eigh(H)
        V = mm(Qo, W)
        R = mm(AQ, W) - V * lam[None, :]
        norms = (torch.linalg.norm(R, dim=0) if group is None
                 else torch.sqrt(group_sum(torch.sum(R * R, dim=0), group)))
        rel = norms / torch.clamp(lam.abs(), min=torch.finfo(rdt).tiny)
        # stochastic eigencount: E[yᵀρ(A)y] = tr ρ(A) ≈ #eigs inside the
        # disc when Y is the standard-normal block (the host loop tracks
        # when it is); drives the radius calibration
        est = group_sum(torch.sum(Y * Q), group) / Y.shape[1]
        return V, lam, rel, its, est

    if radius is not None:
        r_cur = float(radius)
        calibrate = False
    else:
        r_cur = max((bounds[1] - bounds[0]) * 1e-3, 1e-12)
        calibrate = True

    total_inner = 0
    best = None
    Y = Y0
    y_is_random = True
    # aim the disc at slightly more than k eigenvalues, leaving ≥ 2/3 of the
    # (m0 − k) columns as the convergence buffer FEAST's rate depends on
    target = k + max(1.0, (m0 - k) / 3.0)
    calib_left = 6
    ghost_thr = _ghost_threshold(tol, rdt)
    for _ in range(int(max_iter)):
        V, lam, rel, its, est = filter_and_ritz(Y, scalar(r_cur))
        total_inner += its
        lam_np, rel_np = lam.cpu().numpy(), rel.cpu().numpy()
        inside = np.abs(lam_np - sigma) <= r_cur
        if side == "above":
            inside &= lam_np >= sigma
        elif side == "below":
            inside &= lam_np < sigma
        n_in = int(inside.sum())
        # the pairs and the radius that produced them, kept together
        best = (lam_np, rel_np, V, r_cur)
        if _RF_DEBUG:
            o = np.argsort(np.abs(lam_np - sigma))[:6]
            print(f"rf: r={r_cur:.3e} n_in={n_in} est={float(est):.1f} "
                  f"lam6={np.round(lam_np[o], 6)} rel6={rel_np[o]}",
                  file=sys.stderr, flush=True)
        # done when the k nearest non-ghost pairs inside the disc meet tol; a
        # ghost (a spurious boundary Ritz value whose residual sits orders
        # above tol and never improves) cannot block termination
        cand = np.where(inside & (rel_np <= ghost_thr))[0]
        cand = cand[np.argsort(np.abs(lam_np[cand] - sigma))][:k]
        if (len(cand) >= 1 and (len(cand) >= k or not calibrate)
                and bool(np.all(rel_np[cand] <= tol))):
            break
        if calibrate and calib_left > 0 and (n_in < k or n_in > m0 - 2):
            calib_left -= 1
            # one-shot proportional correction, count(r) ∝ r; the Ritz count
            # saturates at m0, so from the random block prefer the unbiased
            # trace estimate
            count = float(n_in)
            if y_is_random:
                count = max(count, float(est))
            count = max(count, 0.5)
            r_cur *= float(np.clip(target / count, 0.05, 20.0))
            Y = Y0              # restart from the random block: keeps the
            y_is_random = True  # trace estimate valid next pass
            continue
        Y = V  # plain subspace iteration on the Ritz block
        y_is_random = False
    return best + (total_inner,)
