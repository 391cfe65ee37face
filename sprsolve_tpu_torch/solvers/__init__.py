"""Iterative solvers as plain functions on tensors (counterpart of
``sprsolve_tpu/solvers``): BiCGStab, BiCGStab(ℓ), CG, MINRES, CS-MINRES,
COCG, LSQR, the exact and the multicolor Gauss-Seidel with the multicolor
GS preconditioners, and the ``with_real_planes`` shim."""

from .bicgstab import bicgstab
from .bicgstabl import bicgstabl
from .cg import cg
from .cocg import cocg
from .cs_minres import cs_minres
from .gauss_seidel import gauss_seidel
from .lsqr import lsqr
from .minres import minres
from .planes import with_real_planes
from .redblack import (
    ColoredELL,
    MaskedGSPrecond,
    MulticolorGSPrecond,
    color_masks,
    gauss_seidel_redblack,
    greedy_color,
)

__all__ = ["bicgstab", "bicgstabl", "cg", "cocg", "cs_minres", "gauss_seidel", "lsqr",
           "minres", "with_real_planes", "ColoredELL", "MaskedGSPrecond",
           "MulticolorGSPrecond", "color_masks", "gauss_seidel_redblack", "greedy_color"]
