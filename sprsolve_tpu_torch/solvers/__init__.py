"""Iterative solvers as plain functions on tensors (counterpart of
``sprsolve_tpu/solvers``): BiCGStab, BiCGStab(ℓ), CG, MINRES, CS-MINRES and
COCG so far, and the ``with_real_planes`` shim."""

from .bicgstab import bicgstab
from .bicgstabl import bicgstabl
from .cg import cg
from .cocg import cocg
from .cs_minres import cs_minres
from .minres import minres
from .planes import with_real_planes

__all__ = ["bicgstab", "bicgstabl", "cg", "cocg", "cs_minres", "minres",
           "with_real_planes"]
