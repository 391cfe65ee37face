"""LSQR: damped least squares for any m×n A (Paige & Saunders 1982).

Counterpart of ``sprsolve_tpu/solvers/lsqr.py``: min ‖A·x − b‖² + damp²·‖x‖²
by Golub-Kahan bidiagonalization, one ``A`` apply and one ``Aᴴ`` apply per
iteration plus two norms.  The adjoint is an operator of its own (``AH``),
built once at setup (:meth:`~sprsolve_tpu_torch.sparse.containers.CSR.adjoint`).
The rotation scalars (α, β, ρ, c, s, φ) are real norms, so the Givens
machinery is real also when the vectors are complex.

Stopping (the simplified ``scipy.sparse.linalg.lsqr`` tests with atol =
btol = ``tol``): ‖r‖ ≤ tol·‖b‖ (a consistent system) or ‖Aᴴr‖ ≤
tol·‖A‖·‖r‖ (least-squares convergence, ‖A‖ the accumulated Frobenius
estimate).  Both give CONVERGED; an α or β at or below ε (the Krylov space
is exhausted) exits converged after that step's rotation.

The loop is a Python ``while``; scalars stay 0-d tensors on the solve's
device, and each iteration brings the two stopping predicates to the host
in one read.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..errors import IncompatibleMatrixFormat, Status
from ..vecalg import eps_for, norm2, real_dtype
from .common import make_info, read_flags


def lsqr(
    A,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    AH=None,
    damp: float = 0.0,
    tol,
    max_iter,
    record_residuals: bool = False,
    group=None,
):
    """Least-squares solve of the m×n ``A``. Returns ``(x, SolveInfo)``.

    ``AH`` is the adjoint operator (Aᴴ), by default ``A.adjoint()`` (a host
    build for a CSR). ``b`` has length m, ``x0`` and the solution length n.
    ``info.residual`` is ‖r‖/‖b‖, with the damping term when ``damp > 0``.
    ``record_residuals=True`` also returns that ratio at the top of each
    iteration, a ``(max_iter + 1,)`` tensor that is NaN past the last.
    ``group`` makes the norms sums over its ranks: b, x0 and x are this
    rank's rows of equal row blocks, A's and AH's sizes global."""
    if AH is None:
        if not hasattr(A, "adjoint"):
            raise IncompatibleMatrixFormat(
                "lsqr needs the adjoint operator: pass AH= (or use a CSR "
                "container, whose .adjoint() is built automatically)"
            )
        AH = A.adjoint()
    world = 1
    if group is not None:
        import torch.distributed as dist

        world = dist.get_world_size(group)
    m_dim, n_dim = (d // world for d in A.shape)
    if b.dim() == 1 and b.shape[0] * world != A.shape[0]:
        raise IncompatibleMatrixFormat("Input vec dimension doesn't match the matrix size")
    if x0 is not None and x0.dim() == 1 and x0.shape[0] != n_dim:
        raise IncompatibleMatrixFormat("Input and output vec dimension do not match")

    T, dev = b.dtype, b.device
    rdt = real_dtype(T)
    max_iter = int(max_iter)
    hist = torch.full((max_iter + 1 if record_residuals else 0,), float("nan"),
                      dtype=rdt, device=dev)
    eps = eps_for(T, dev)
    tol_t = torch.tensor(tol, dtype=rdt, device=dev)
    damp_r = torch.tensor(damp, dtype=rdt, device=dev)
    one = torch.ones((), dtype=rdt, device=dev)
    zero = torch.zeros((), dtype=rdt, device=dev)
    if x0 is None:
        x0 = torch.zeros(n_dim, dtype=T, device=dev)

    def normalize(vec):
        nrm = norm2(vec, group)
        return vec * (one / torch.where(nrm > 0, nrm, one)), nrm

    rhs_norm = norm2(b, group)
    if bool(rhs_norm <= eps):
        info = make_info(0, rhs_norm, Status.CONVERGED)
        x = torch.zeros(n_dim, dtype=T, device=dev)
        return (x, info, hist) if record_residuals else (x, info)

    u, beta = normalize(b - A.matvec(x0))
    v, alpha = normalize(AH.matvec(u))
    x, w = x0, v
    phibar, rhobar = beta, alpha
    anorm2 = alpha * alpha + damp_r * damp_r
    res2 = zero
    rnorm, arnorm = beta, alpha * beta
    its = 0

    def stop_flags():
        small_r = rnorm <= tol_t * rhs_norm
        small_ar = arnorm <= tol_t * torch.sqrt(anorm2) * rnorm
        return read_flags(small_r, small_ar)

    flags = stop_flags()
    while its < max_iter and not any(flags):
        if record_residuals:
            hist[its] = rnorm / rhs_norm
        # continue the bidiagonalization
        u, beta = normalize(A.matvec(v) - alpha * u)
        v_next, alpha_next = normalize(AH.matvec(u) - beta * v)
        # α or β = 0: the Krylov space is exhausted and the iterate exact (in
        # exact arithmetic): exit converged after this step's rotation
        exhausted = (beta <= eps) | (alpha_next <= eps)
        v, alpha = v_next, alpha_next

        # eliminate the damping row (the identity rotation when damp = 0)
        rhobar1 = torch.sqrt(rhobar ** 2 + damp_r ** 2)
        c1, s1 = rhobar / rhobar1, damp_r / rhobar1
        psi, phibar_d = s1 * phibar, c1 * phibar
        # eliminate the subdiagonal β
        rho = torch.sqrt(rhobar1 ** 2 + beta ** 2)
        c, s = rhobar1 / rho, beta / rho
        theta, rhobar = s * alpha, -c * alpha
        phi, phibar = c * phibar_d, s * phibar_d
        tau = s * phi

        x = x + (phi / rho) * w
        w = v - (theta / rho) * w
        anorm2 = anorm2 + alpha * alpha + beta * beta + damp_r * damp_r
        res2 = res2 + psi * psi
        rnorm = torch.sqrt(phibar * phibar + res2)
        arnorm = torch.where(exhausted, zero, alpha * torch.abs(tau))
        its += 1
        flags = stop_flags()

    status = Status.CONVERGED if any(flags) else Status.INSUFFICIENT_ITER
    res = rnorm / rhs_norm
    if record_residuals and its < hist.shape[0]:
        hist[its] = res
    info = make_info(its, res, status)
    return (x, info, hist) if record_residuals else (x, info)
