"""The LinearOperator protocol and the fused-dot helpers.

Counterpart of ``sprsolve_tpu/ops/operator.py`` (the reference's
``MatVecMul`` trait, ``src/mat.rs:12-37``).  Anything with ``shape``,
``matvec(x)`` and ``matvec_dot(x)`` is an operator.  Operators that provide
``matvec_wdot`` / ``matvec_wdot_prec`` (the padded-DIA kernel K2) take
BiCGStab's reductions inside the SpMV pass; every other operator composes
the matvec with separate dots, with the same result.
"""

from __future__ import annotations

import dataclasses
from typing import Protocol, Tuple, runtime_checkable

import torch

from ..vecalg import conj_dot


@runtime_checkable
class LinearOperator(Protocol):
    shape: Tuple[int, int]

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """y = A·x (reference ``mul_vec``)."""
        ...

    def matvec_dot(self, x: torch.Tensor):
        """(A·x, conj(x)·A·x) — mirrors ``mkl_sparse_?_dotmv``."""
        ...


def mv_wdot(A, x: torch.Tensor, w: torch.Tensor):
    """(y = A·x, conj(w)·y), the dot taken inside the SpMV pass when the
    operator provides ``matvec_wdot``."""
    fn = getattr(A, "matvec_wdot", None)
    if fn is not None:
        y, wd, _ = fn(x, w)
        return y, wd
    y = A.matvec(x)
    return y, conj_dot(w, y)


def mv_wdot2(A, x: torch.Tensor, w: torch.Tensor):
    """(y = A·x, conj(w)·y, conj(y)·y) — both of BiCGStab's post-SpMV
    reductions in the SpMV pass where the operator supports it."""
    fn = getattr(A, "matvec_wdot", None)
    if fn is not None:
        return fn(x, w)
    y = A.matvec(x)
    return y, conj_dot(w, y), conj_dot(y, y)


def mv_prec_wdot(A, M, x: torch.Tensor, w: torch.Tensor):
    """(u = M⁻¹·x, y = A·u, conj(w)·y), a diagonal M folded into the SpMV
    input where the operator supports ``matvec_wdot_prec``.

    The fold is taken for ``type(M) is DiagPrecond`` exactly, as in the JAX
    package: a subclass may apply something else. u is returned as its own
    tensor for BiCGStab's x-update."""
    from ..precond import DiagPrecond

    fn = getattr(A, "matvec_wdot_prec", None)
    if fn is not None and type(M) is DiagPrecond:
        y, wd, _ = fn(x, w, M.diag_inv)
        return x * M.diag_inv, y, wd
    u = M.matvec(x)
    y, wd = mv_wdot(A, u, w)
    return u, y, wd


def mv_prec_wdot2(A, M, x: torch.Tensor, w: torch.Tensor):
    """(u = M⁻¹·x, y = A·u, conj(w)·y, conj(y)·y) — the second-half variant
    of :func:`mv_prec_wdot`."""
    from ..precond import DiagPrecond

    fn = getattr(A, "matvec_wdot_prec", None)
    if fn is not None and type(M) is DiagPrecond:
        y, wd, yd = fn(x, w, M.diag_inv)
        return x * M.diag_inv, y, wd, yd
    u = M.matvec(x)
    y, wd, yd = mv_wdot2(A, u, w)
    return u, y, wd, yd


@dataclasses.dataclass(frozen=True)
class IdentityOperator:
    n: int

    @property
    def shape(self):
        return (self.n, self.n)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        # the same tensor, not a copy: mv_prec_wdot2(A, I, s, s) then hands
        # the kernel w is x, and K2 drops the w stream
        return x

    def matvec_dot(self, x: torch.Tensor):
        return x, conj_dot(x, x)


@dataclasses.dataclass(frozen=True)
class DiagonalOperator:
    """y = diag ⊙ x. Also the apply-form of the diagonal preconditioner."""

    diag: torch.Tensor

    @property
    def shape(self):
        n = self.diag.shape[0]
        return (n, n)

    @property
    def dtype(self):
        return self.diag.dtype

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.diag

    def matvec_dot(self, x: torch.Tensor):
        y = x * self.diag
        return y, conj_dot(x, y)


def as_operator(a, device=None) -> LinearOperator:
    """Coerce common inputs (containers, dense arrays) to an operator."""
    if hasattr(a, "matvec"):
        return a
    arr = torch.as_tensor(a, device=device)
    if arr.dim() == 2:
        return _DenseOperator(arr)
    raise TypeError(f"cannot interpret {type(a)} as a LinearOperator")


@dataclasses.dataclass(frozen=True)
class _DenseOperator:
    a: torch.Tensor

    @property
    def shape(self):
        return tuple(self.a.shape)

    @property
    def dtype(self):
        return self.a.dtype

    @property
    def device(self):
        return self.a.device

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return self.a @ x

    def matvec_dot(self, x: torch.Tensor):
        y = self.a @ x
        return y, conj_dot(x, y)
