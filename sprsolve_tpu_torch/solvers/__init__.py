"""Iterative solvers as plain functions on tensors (counterpart of
``sprsolve_tpu/solvers``): BiCGStab, BiCGStab(ℓ), CG and MINRES so far."""

from .bicgstab import bicgstab
from .bicgstabl import bicgstabl
from .cg import cg
from .minres import minres

__all__ = ["bicgstab", "bicgstabl", "cg", "minres"]
