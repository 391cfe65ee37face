"""The LinearOperator protocol and the fused-dot helpers.

Counterpart of ``sprsolve_tpu/ops/operator.py`` (the reference's
``MatVecMul`` trait, ``src/mat.rs:12-37``).  Anything with ``shape``,
``matvec(x)`` and ``matvec_dot(x)`` is an operator.  Operators that provide
``matvec_wdot`` / ``matvec_wdot_prec`` (the padded-DIA kernel K2) or
``matvec_wdot_cprec`` (the two-plane kernel K7) take BiCGStab's reductions
inside the SpMV pass, and ``matvec_conj_dot`` (K6) takes CS-MINRES's
Saunders step in one pass; every other operator composes the matvec with
separate dots, with the same result.
"""

from __future__ import annotations

import dataclasses
from typing import Protocol, Tuple, runtime_checkable

import torch

from ..vecalg import conj, conj_dot


@runtime_checkable
class LinearOperator(Protocol):
    shape: Tuple[int, int]

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """y = A·x (reference ``mul_vec``)."""
        ...

    def matvec_dot(self, x: torch.Tensor):
        """(A·x, conj(x)·A·x) — mirrors ``mkl_sparse_?_dotmv``."""
        ...


def mv_conj_dot(A, x: torch.Tensor):
    """(y = A·conj(x), conj(x)ᵀy) — the CS-MINRES Saunders step
    (``src/cs_minres.rs:99-103``), in one pass on an operator with
    ``matvec_conj_dot`` (K6 folds the conjugation into the accumulation),
    composed conj → matvec → dot otherwise. The dot is the unconjugated
    product of conj(x) with y, which is ``conj_dot(x, y)``."""
    fn = getattr(A, "matvec_conj_dot", None)
    if fn is not None:
        return fn(x)
    y = A.matvec(conj(x))
    return y, conj_dot(x, y)


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


def _fold(A, M):
    """The operator's method that folds ``M``'s diagonal into its SpMV pass
    (``sprsolve_tpu/ops/operator.py:78-86``), or None."""
    from ..precond import ComplexDiagPrecond, DiagPrecond

    if type(M) is DiagPrecond:
        return getattr(A, "matvec_wdot_prec", None)
    if type(M) is ComplexDiagPrecond:
        return getattr(A, "matvec_wdot_cprec", None)
    return None


def mv_prec_wdot(A, M, x: torch.Tensor, w: torch.Tensor):
    """(u = M⁻¹·x, y = A·u, conj(w)·y), a diagonal M folded into the SpMV
    input where the operator supports ``matvec_wdot_prec`` (a real
    diagonal) or ``matvec_wdot_cprec`` (a complex one).

    The fold is taken for ``type(M) is DiagPrecond`` or ``type(M) is
    ComplexDiagPrecond`` exactly, as in the JAX package: a subclass may apply
    something else. u is returned as its own tensor for BiCGStab's x-update."""
    fold = _fold(A, M)
    if fold is not None:
        y, wd, _ = fold(x, w, M.diag_inv)
        return x * M.diag_inv, y, wd
    u = M.matvec(x)
    y, wd = mv_wdot(A, u, w)
    return u, y, wd


def mv_prec_wdot2(A, M, x: torch.Tensor, w: torch.Tensor):
    """(u = M⁻¹·x, y = A·u, conj(w)·y, conj(y)·y) — the second-half variant
    of :func:`mv_prec_wdot`."""
    fold = _fold(A, M)
    if fold is not None:
        y, wd, yd = fold(x, w, M.diag_inv)
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


# the padded-layout protocol a ShiftedOperator forwards, so that a shifted
# kernel operator keeps solving in its own layout
_LAYOUT_ATTRS = ("pad_vec", "unpad_vec", "padded_len")


@dataclasses.dataclass(frozen=True)
class ShiftedOperator:
    """y = A·x − shift·x, without materialising A − shift·I.

    Counterpart of ``sprsolve_tpu/ops/operator.py:209-285``: wraps any
    operator, for spectral transformations (``scipy.sparse.linalg.minres(...,
    shift=σ)`` parity, shift-invert eigencomputations, Helmholtz-like
    A − σI solves) on every layout, the padded kernel layouts included: the
    wrapper forwards the layout protocol (``pad_vec``/``unpad_vec``, and
    ``padded_len``, which the solvers' shape checks read), so a shifted
    ``PaddedDIA`` still runs in its internal layout. Like the JAX
    class it forwards no fused method: MINRES on it runs K1 and separate
    dots. Build Jacobi preconditioners from :meth:`diagonal`, which
    includes the shift.
    """

    A: object
    shift: object  # a Python scalar or a 0-d tensor

    @property
    def shape(self):
        return self.A.shape

    @property
    def dtype(self):
        return getattr(self.A, "dtype", None)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return self.A.matvec(x) - self.shift * x

    def matvec_dot(self, x: torch.Tensor):
        y = self.matvec(x)
        return y, conj_dot(x, y)

    def matmat(self, X: torch.Tensor) -> torch.Tensor:
        if hasattr(self.A, "matmat"):
            return self.A.matmat(X) - self.shift * X
        return torch.stack([self.matvec(X[:, j]) for j in range(X.shape[1])], dim=1)

    def __getattr__(self, name):
        if name in _LAYOUT_ATTRS:
            return getattr(self.A, name)
        raise AttributeError(name)

    def diagonal(self) -> torch.Tensor:
        """Flat shifted diagonal (a padded inner operator's is un-laid)."""
        if hasattr(self.A, "diagonal"):
            d = self.A.diagonal()
        elif hasattr(self.A, "diagonal_padded"):
            d = self.A.unpad_vec(self.A.diagonal_padded())
        else:
            raise AttributeError("diagonal")
        return d - self.shift

    def jacobi_precond(self):
        """Jacobi of the *shifted* operator, 1/(diag(A) − σ), re-laid into
        the inner operator's layout when it has one (the path
        ``solve(..., M="jacobi")`` takes for padded operators)."""
        from ..precond import DiagPrecond

        M = DiagPrecond.new(self.diagonal())
        if hasattr(self.A, "relay_diag_precond"):
            return self.A.relay_diag_precond(M)
        return M

    def relay_diag_precond(self, M):
        if hasattr(self.A, "relay_diag_precond"):
            return self.A.relay_diag_precond(M)
        raise NotImplementedError(
            "inner operator has no internal-layout diagonal relay"
        )
