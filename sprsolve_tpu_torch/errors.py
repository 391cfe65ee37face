"""Solver status codes and host-level exceptions.

PyTorch counterpart of ``sprsolve_tpu/errors.py`` (reference error model,
``src/error.rs:3-22`` in sprsolve).  The solvers here run as Python loops, so
the termination reason is known on the host when the loop ends; it is still
reported as a :class:`Status` inside :class:`SolveInfo`, and the object API
turns a failure status into the matching exception (the reference's
``.unwrap()``).
"""

from __future__ import annotations

import enum
from typing import NamedTuple, Union

import torch


class Status(enum.IntEnum):
    """Termination status of an iterative solve (same codes as the JAX package)."""

    RUNNING = -1
    CONVERGED = 0
    INSUFFICIENT_ITER = 1   # reference: SolverError::InsufficientIterNum
    BREAKDOWN = 2           # reference: SolverError::BreakDown
    INVALID_PRECONDITIONER = 3  # reference: SolverError::InvalidPreconditioner
    ZERO_DIAGONAL = 4       # reference: SolverError::ZeorDiagonalElem (sic)
    INCOMPATIBLE_FORMAT = 5  # reference: SolverError::IncompatibleMatrixFormat


class SolverError(Exception):
    """Base class mirroring the reference ``SolverError`` enum."""


class IncompatibleMatrixFormat(SolverError):
    pass


class ZeroDiagonalElem(SolverError):
    pass


class InsufficientIterNum(SolverError):
    pass


class BreakDown(SolverError):
    pass


class InvalidPreconditioner(SolverError):
    pass


_STATUS_TO_EXC = {
    int(Status.INSUFFICIENT_ITER): InsufficientIterNum,
    int(Status.BREAKDOWN): BreakDown,
    int(Status.INVALID_PRECONDITIONER): InvalidPreconditioner,
    int(Status.ZERO_DIAGONAL): ZeroDiagonalElem,
    int(Status.INCOMPATIBLE_FORMAT): IncompatibleMatrixFormat,
}

Scalar = Union[int, float, torch.Tensor]


class SolveInfo(NamedTuple):
    """Observable outcome of a solve: ``(iterations, residual, status)``.

    Each field is a Python number or a 0-d tensor (the residual usually stays
    on the solve's device); ``int()``/``float()`` work on either.
    """

    iterations: Scalar
    residual: Scalar
    status: Scalar

    @property
    def converged(self) -> bool:
        return int(self.status) == int(Status.CONVERGED)

    def raise_if_error(self) -> "SolveInfo":
        """Raise the exception matching a failure status (``.unwrap()``)."""
        code = int(self.status)
        if code == int(Status.CONVERGED):
            return self
        exc = _STATUS_TO_EXC.get(code, SolverError)
        raise exc(
            f"solver failed with status {Status(code).name} after "
            f"{int(self.iterations)} iterations (residual {float(self.residual):.3e})"
        )
