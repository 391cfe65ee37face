"""s-step (communication-avoiding) Conjugate Gradients.

Counterpart of ``sprsolve_tpu/solvers/ca_cg.py`` (Carson & Demmel's
CA-KSM formulation; beyond the reference's surface), with the same block
and exits: per outer block, the 2s+1 basis vectors
V = [ρ₀(A)p … ρ_s(A)p, ρ₀(A)r … ρ_{s−1}(A)r] (Chebyshev on ``bounds``, else
monomial), the Gram matrix G = VᴴV (a full-precision product), s exact CG
steps as coefficient recurrences against G with the static basis change B
(A·(V·a) = V·B·a), and x/r/p rebuilt from V by three products.  The block
loop exits on the coordinate norm rᴴGr; an outer loop re-anchors on the
TRUE residual b − A·x with p = r, and CONVERGED is gated on it.

The JAX package's one-reduction-per-block structure matters across ranks
(``group=``, the distributed layer); on one card the basis costs about twice plain CG's
SpMVs.  The basis block applies ``A.matmat`` where the operator has one,
else one ``matvec`` per column (the JAX package's ``vmap``); the
(2s+1)-sized coefficient algebra runs on the host in the solve's dtype,
one read of G per block.  The operator works on flat vectors: a padded
kernel layout is refused, as in the JAX package, and ``solve()`` runs this
solver on an unpadded ``DIA`` or CSR, so no hand kernel launches.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..errors import IncompatibleMatrixFormat, Status
from ..vecalg import (NUMPY_DTYPES, axpy, conj_dot, full_precision_matmul, group_sum,
                      real_dtype)
from .common import _guard3, block_apply, check_shapes, make_info


def _basis_change(s: int, basis: str, theta: float, delta: float) -> np.ndarray:
    """Static B with A·V[:, j] = Σ_i B[i, j]·V[:, i] on the valid columns.

    Block-diagonal over the p-chain (s+1 columns) and the r-chain (s
    columns); the highest column of each chain maps out of the space and is
    never touched by the recurrences, so those columns are left zero.
    """
    t = 2 * s + 1
    B = np.zeros((t, t))

    def chain(off: int, size: int) -> None:
        for j in range(size - 1):
            c = off + j
            if basis == "monomial":
                B[c + 1, c] = 1.0
            else:  # chebyshev: ρ₀=1, ρ₁=(A−θ)/δ, ρ_{j+1}=2(A−θ)/δ·ρ_j − ρ_{j−1}
                B[c, c] = theta
                B[c + 1, c] = delta if j == 0 else delta / 2.0
                if j >= 1:
                    B[c - 1, c] = delta / 2.0

    chain(0, s + 1)
    chain(s + 1, s)
    return B


def fold_jacobi(A, b, x0=None):
    """Fold a Jacobi preconditioner into the system by symmetric diagonal
    scaling: Ā = D^{-1/2}·A·D^{-1/2}, b̄ = D^{-1/2}·b, x = D^{-1/2}·x̄.

    Plain ``ca_cg`` on the scaled system reproduces Jacobi-CG's convergence
    with the s-step block unchanged.  Built on the host, O(nnz).  Returns
    ``(A_scaled, b_scaled, x0_scaled, unfold)`` with ``x = unfold(x̄)``;
    ``A`` is a CSR with a nonzero diagonal (zeros count as 1).  ``tol``
    then applies to the scaled (preconditioned) residual, as under PETSc's
    left preconditioning.
    """
    from ..sparse.containers import CSR, _host

    d = _host(A.diagonal())
    mag = np.abs(d).astype(np.float64)
    mag[mag == 0] = 1.0
    s_host = 1.0 / np.sqrt(mag)
    rows = _host(A.row_ids).astype(np.int64)
    cols = _host(A.indices).astype(np.int64)
    data = _host(A.data)
    A_s = CSR.from_arrays((data * (s_host[rows] * s_host[cols])).astype(data.dtype),
                          A.indices, A.indptr, A.shape, device=A.device)
    b = torch.as_tensor(b)
    s_dev = torch.as_tensor(s_host, dtype=real_dtype(b.dtype), device=b.device)
    b_s = b * s_dev
    x0_s = None if x0 is None else torch.as_tensor(x0, device=b.device) / s_dev

    def unfold(x_s):
        return x_s * s_dev.to(x_s.device)

    return A_s, b_s, x0_s, unfold


def _kernel_layout(A) -> bool:
    """A padded kernel layout (itself or inside a ``Reordered``): its
    vectors are not the flat ones the basis block stacks."""
    from ..ops.padded_dia import ComplexPaddedDIA, PaddedDIA

    return isinstance(getattr(A, "inner", A), (PaddedDIA, ComplexPaddedDIA))


def _chebyshev(basis: str, bounds):
    """(basis, θ, δ) of ``basis``/``bounds`` (``auto`` → Chebyshev when
    bounds are given)."""
    if basis == "auto":
        basis = "chebyshev" if bounds is not None else "monomial"
    if basis == "chebyshev":
        if bounds is None:
            raise ValueError("basis='chebyshev' needs bounds=(lo, hi)")
        lo, hi = float(bounds[0]), float(bounds[1])
        return basis, 0.5 * (hi + lo), max(0.5 * (hi - lo), 1e-30)
    if basis == "monomial":
        return basis, 0.0, 1.0
    raise ValueError(f"unknown basis {basis!r}")


def basis_block(A, p, r, deg: int, basis: str, theta: float, delta: float,
                mpk: bool = False):
    """V = [ρ₀(A)p … ρ_deg(A)p, ρ₀(A)r … ρ_{deg−1}(A)r] as (m, 2·deg + 1).

    ``mpk``: the operator is a matrix-powers
    :class:`~sprsolve_tpu_torch.parallel.MPKDIA` on a process group; the
    chain then runs on its extended window after ONE halo exchange
    (``mpk_extend``), each power a local ``mpk_apply``, and the columns are
    cut back to the rank's rows (``sprsolve_tpu/solvers/ca_cg.py:206-238``)."""
    Z = torch.stack([p, r], dim=1)
    if mpk:
        chain, apply_, central = [A.mpk_extend(Z)], A.mpk_apply, A.mpk_central
    else:
        chain, apply_, central = [Z], (lambda X: block_apply(A, X)), (lambda v: v)
    for j in range(deg):
        Av = apply_(chain[-1])
        if basis == "monomial":
            nxt = Av
        elif j == 0:
            nxt = (Av - theta * chain[-1]) / delta
        else:
            nxt = (2.0 / delta) * (Av - theta * chain[-1]) - chain[-2]
        chain.append(nxt)
    chain = [central(c) for c in chain]
    cols = [c[:, 0] for c in chain] + [c[:, 1] for c in chain[:deg]]
    return torch.stack(cols, dim=1)


def ca_cg(
    A,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    s: int = 4,
    basis: str = "auto",
    bounds=None,
    tol,
    max_iter,
    record_residuals: bool = False,
    group=None,
):
    """Solve SPD/HPD A·x = b with s-step CG. Returns ``(x, SolveInfo)``.

    ``s``: CG iterations per block (2-8 sensible).  ``basis``:
    ``"chebyshev"`` (needs ``bounds=(lo, hi)`` containing the spectrum;
    Gershgorin serves), ``"monomial"``, or ``"auto"`` (Chebyshev when
    bounds are given).  Unpreconditioned: fold a Jacobi in with
    :func:`fold_jacobi`, or use :func:`~sprsolve_tpu_torch.solvers.cg.cg`
    with ``M``.  ``record_residuals=True`` also returns the coordinate
    residual of each step, a ``(max_iter + 1,)`` tensor.  ``group`` makes
    the Gram matrix and the norms sums over its ranks (b, x0 and x are this
    rank's rows); on an ``MPKDIA`` the basis costs one halo exchange a
    block.
    """
    if x0 is None:
        x0 = torch.zeros_like(b)
    check_shapes(A, b, x0, group)
    if b.dim() != 1 or _kernel_layout(A):
        raise IncompatibleMatrixFormat(
            "ca_cg works on flat vectors (the basis block stacks p and r); "
            "padded kernel layouts are not supported here"
        )
    if s < 1:
        raise ValueError(f"need s >= 1, got {s}")
    basis, theta, delta = _chebyshev(basis, bounds)
    if hasattr(A, "max_power") and s > A.max_power:
        raise ValueError(
            f"s={s} exceeds the operator's matrix-powers depth "
            f"{A.max_power} (ext={A.ext}, halo={A.halo})"
        )
    mpk = hasattr(A, "mpk_extend") and group is not None

    T, dev = b.dtype, b.device
    rdt = real_dtype(T)
    npT, npR = NUMPY_DTYPES[T], NUMPY_DTYPES[rdt]
    max_iter = int(max_iter)
    hist_len = max_iter + 1 if record_residuals else 0
    tiny = npR(np.finfo(npR).tiny)
    t = 2 * s + 1
    Bmat = _basis_change(s, basis, theta, delta).astype(npR)
    one = torch.ones((), dtype=T, device=dev)

    def main(rhs_norm):
        rhs_h = npR(float(rhs_norm))
        tol_h = npR(tol)
        tol2sq = np.square(tol_h * rhs_h)
        hist = np.full(hist_len, np.nan, dtype=npR)

        def block(x, r, p, its, status):
            V = basis_block(A, p, r, s, basis, theta, delta, mpk)
            G = group_sum(full_precision_matmul(V.conj().T, V), group).cpu().numpy()
            a = np.zeros(t, npT)
            a[0] = 1
            bv = np.zeros(t, npT)
            bv[s + 1] = 1
            c = np.zeros(t, npT)
            num = npR(np.real(bv.conj() @ (G @ bv)))
            active = True
            for _ in range(s):
                w = (Bmat @ a).astype(npT)
                den = npR(np.real(a.conj() @ (G @ w)))
                ok = den > 0
                step = active and ok and its < max_iter
                alpha = npT(num / (den if ok else npR(1)))
                bnew = bv - alpha * w if step else bv
                num_new = max(npR(np.real(bnew.conj() @ (G @ bnew))), npR(0))
                beta = npT(num_new / max(num, tiny))
                if step:
                    c = c + alpha * a
                    a = bnew + beta * a
                bv = bnew
                if hist_len and step:
                    hist[min(its, max_iter)] = np.sqrt(num) / rhs_h
                if active and not ok:
                    status = Status.BREAKDOWN
                if step:
                    its += 1
                    num = num_new
                active = step and num > tol2sq
            # rebuild the iterates from the basis: three products
            cvec = torch.as_tensor(np.stack([c, bv, a], axis=1), device=dev)
            xrp = full_precision_matmul(V, cvec)
            return x + xrp[:, 0], xrp[:, 1], xrp[:, 2], num, its, status

        r = axpy(-one, A.matvec(x0), b)
        x, p, its, status = x0, r, 0, Status.RUNNING
        rn2 = npR(float(conj_dot(r, r, group).real))
        # outer re-anchor loop: the block loop exits on the COORDINATE norm
        # rᴴGr; each pass recomputes b − A·x and restarts with p = r
        while status == Status.RUNNING and its < max_iter and rn2 > tol2sq:
            while status == Status.RUNNING and its < max_iter and rn2 > tol2sq:
                x, r, p, rn2, its, status = block(x, r, p, its, status)
            r = axpy(-one, A.matvec(x), b)
            p = r
            rn2 = npR(float(conj_dot(r, r, group).real))
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
