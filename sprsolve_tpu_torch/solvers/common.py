"""Shared solver plumbing: early-out wrappers and info construction
(counterpart of ``sprsolve_tpu/solvers/common.py``)."""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..errors import IncompatibleMatrixFormat, SolveInfo, Status
from ..vecalg import eps_for, group_sum, norm2


def make_info(iterations, residual, status) -> SolveInfo:
    return SolveInfo(iterations=int(iterations), residual=residual,
                     status=int(status))


def with_zero_rhs_guard(b: torch.Tensor, x0: torch.Tensor,
                        main: Callable[[torch.Tensor], tuple], group=None):
    """Reference early-out: if ‖b‖ ≤ ε, return x = 0 with Ok((0, ‖b‖))
    (``src/bicg_stab.rs:56-60``). ``main`` receives ``rhs_norm`` and returns
    ``(x, SolveInfo)``. One host read of ‖b‖, taken over ``group``'s ranks
    when one is given."""
    rhs_norm = norm2(b, group)
    if bool(rhs_norm <= eps_for(b.dtype, b.device)):
        return torch.zeros_like(x0), make_info(0, rhs_norm, Status.CONVERGED)
    return main(rhs_norm)


def _guard3(b: torch.Tensor, x0: torch.Tensor,
            main: Callable[[torch.Tensor], tuple], hist_len: int, rdt: torch.dtype,
            group=None):
    """The zero-rhs guard of the three-output form ``(x, SolveInfo, hist)``
    (``sprsolve_tpu/solvers/bicgstab.py:42-56``): if ‖b‖ ≤ ε, x = 0 with
    Ok((0, ‖b‖)) and an all-NaN history of ``hist_len``. One host read."""
    rhs_norm = norm2(b, group)
    if bool(rhs_norm <= eps_for(b.dtype, b.device)):
        return (torch.zeros_like(x0), make_info(0, rhs_norm, Status.CONVERGED),
                torch.full((hist_len,), float("nan"), dtype=rdt, device=b.device))
    return main(rhs_norm)


def check_shapes(A, b: torch.Tensor, x0: torch.Tensor, group=None) -> None:
    """Dimension checks — the reference's IncompatibleMatrixFormat returns
    (``src/bicg_stab.rs:44-53``).

    Operators with their own vector layout (``pad_vec``) take vectors of
    ``padded_len``; every other operator takes vectors of ``A.shape[1]``.
    With ``group`` the operator's sizes are global and b is this rank's
    block of one of ``group``'s equal blocks
    (``sprsolve_tpu/solvers/common.py:44-66``)."""
    if b.dim() == 1 and getattr(A, "shape", None) is not None:
        n = A.padded_len if hasattr(A, "pad_vec") else A.shape[1]
        if group is not None:
            import torch.distributed as dist

            n_global = b.shape[0] * dist.get_world_size(group)
        else:
            n_global = b.shape[0]
        if n_global != n:
            raise IncompatibleMatrixFormat(
                "Input vec dimension doesn't match the matrix size"
            )
    if x0.shape != b.shape:
        raise IncompatibleMatrixFormat(
            "Input and output vec dimension do not match"
        )


# --- (n, m) blocks: the lockstep solves' column algebra ----------------------
def block_apply(A, X: torch.Tensor) -> torch.Tensor:
    """A·X for an (n, m) block: ``A.matmat`` (one K1b launch on a padded
    operator's flat view), else one ``matvec`` per column."""
    if hasattr(A, "matmat"):
        return A.matmat(X)
    return torch.stack([A.matvec(X[:, j].contiguous()) for j in range(X.shape[1])], dim=1)


def col_dot(X: torch.Tensor, Y: torch.Tensor, group=None) -> torch.Tensor:
    """Xⱼᵀ·Yⱼ for every column j, no conjugation: an (m,) tensor, summed
    over ``group``'s ranks (one all-reduce of the m partials) when given."""
    return group_sum(torch.sum(X * Y, dim=0), group)


def col_conj_dot(X: torch.Tensor, Y: torch.Tensor, group=None) -> torch.Tensor:
    """Xⱼᴴ·Yⱼ for every column j: an (m,) tensor, summed over ``group``."""
    return group_sum(torch.sum(torch.conj(X) * Y, dim=0), group)


def col_norm(X: torch.Tensor, group=None) -> torch.Tensor:
    """‖Xⱼ‖₂ for every column j, real: an (m,) tensor. With ``group`` the
    squares are summed over its ranks, then the root taken."""
    if X.is_complex():
        return torch.sqrt(group_sum(torch.sum(X.real * X.real + X.imag * X.imag, dim=0),
                                    group))
    return torch.sqrt(group_sum(torch.sum(X * X, dim=0), group))


def check_block(A, B: torch.Tensor, X0: Optional[torch.Tensor], group=None):
    """``(B, X0)`` of a lockstep solve: B an (n, m) tensor whose rows match
    ``A.shape[1]`` (with ``group``: B holds this rank's block of one of the
    group's equal row blocks, as :func:`check_shapes` takes b), X0 zeros of
    B's shape by default."""
    B = torch.as_tensor(B)
    if B.dim() != 2:
        raise IncompatibleMatrixFormat("a block solve takes B of shape (n, m)")
    rows = B.shape[0]
    if group is not None:
        import torch.distributed as dist

        rows *= dist.get_world_size(group)
    if getattr(A, "shape", None) is not None and rows != A.shape[1]:
        raise IncompatibleMatrixFormat("Input vec dimension doesn't match the matrix size")
    X0 = torch.zeros_like(B) if X0 is None else torch.as_tensor(X0, device=B.device)
    if X0.shape != B.shape:
        raise IncompatibleMatrixFormat("Input and output vec dimension do not match")
    return B, X0
