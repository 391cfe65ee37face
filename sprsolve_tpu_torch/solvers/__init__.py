"""Iterative solvers as plain functions on tensors (counterpart of
``sprsolve_tpu/solvers``): BiCGStab, BiCGStab(ℓ), CG and the
Chronopoulos–Gear CG, MINRES, CS-MINRES, COCG, CGS, TFQMR, GMRES and
FGMRES, IDR(s), the s-step CG and BiCGStab, block CG and ``batched``,
LSQR, mixed-precision refinement, the exact and the multicolor
Gauss-Seidel with the multicolor GS preconditioners, the
``with_real_planes`` shim, and the eigensolvers: LOBPCG, shift-invert
(with ``InvertedOperator``) and the rational filter."""

from .bicgstab import bicgstab
from .bicgstabl import bicgstabl
from .block_cg import batched, block_cg
from .ca_bicgstab import ca_bicgstab
from .ca_cg import ca_cg
from .cg import cg, cg_single_sync
from .cgs import cgs
from .cocg import cocg
from .cs_minres import cs_minres
from .eigs import InvertedOperator, shift_invert_eigs
from .fgmres import fgmres
from .gauss_seidel import gauss_seidel
from .gmres import gmres
from .idrs import idrs
from .lobpcg import lobpcg
from .lsqr import lsqr
from .minres import minres
from .planes import with_real_planes
from .rational import rational_filter_eigs
from .redblack import (
    ColoredELL,
    MaskedGSPrecond,
    MulticolorGSPrecond,
    color_masks,
    gauss_seidel_redblack,
    greedy_color,
)
from .refine import refine, refine_solve
from .tfqmr import tfqmr

__all__ = ["bicgstab", "bicgstabl", "batched", "block_cg", "ca_bicgstab", "ca_cg", "cg",
           "cg_single_sync", "cgs", "cocg", "cs_minres", "fgmres", "gauss_seidel", "gmres",
           "idrs", "lobpcg", "lsqr", "minres", "rational_filter_eigs", "refine",
           "refine_solve", "shift_invert_eigs", "tfqmr", "with_real_planes",
           "InvertedOperator",
           "ColoredELL", "MaskedGSPrecond", "MulticolorGSPrecond", "color_masks",
           "gauss_seidel_redblack", "greedy_color"]
