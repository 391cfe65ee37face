"""sprsolve_tpu_torch — the PyTorch/CUDA port of ``sprsolve_tpu``.

A second package beside the JAX one, for one NVIDIA H100.  Module layout
and names follow ``sprsolve_tpu``, so each module's counterpart is found by
name.  Plain tensor code is PyTorch; the padded-DIA SpMV kernels that the
JAX package wrote in Pallas are CUDA C++ for Hopper (``csrc/``), built with
nvcc at first use.  The package imports no JAX.

Ported: every solver of the JAX package's ``solve()`` — BiCGStab on the
padded-DIA kernels K1/K2, MINRES and CG on K3/K4, BiCGStab(ℓ), the
Chronopoulos–Gear CG, CGS, TFQMR, GMRES and FGMRES, IDR(s), the s-step CG
and BiCGStab, LSQR, the complex path on the two-plane kernels K5-K7 (COCG,
CS-MINRES, complex BiCGStab, MINRES and GMRES) — plus block CG and
``batched``, mixed-precision refinement (``refine``, ``refine_solve``),
the exact Gauss-Seidel sweep (on the host by design) and the multicolor
one; the preconditioners: Jacobi, multicolor GS/SOR/SSOR, Chebyshev,
block-Jacobi, ILU(0) and IC(0), the multigrid V-cycle (``GridMGPrecond``,
``M="amg"``), HPCG's V-cycle with its colour Gauss-Seidel hand kernel
(``InjectionMGPrecond``) and the inner-solve ``InnerSolvePrecond``, a flat one relayed
onto a padded operator; and every layout of ``optimize()``: padded DIA,
RCM-reordered DIA (``Reordered``), BSR and ComplexBSR, the band+outlier
``HybridDIA`` and the warned ELL, on a compiled host toolkit (``native``,
``csrc/hostkit.cpp``).  ``solve``, ``prepare`` and the ``BiCGStab``,
``MinRes``, ``CG``, ``GMRES``, ``CSMinRes`` and ``GaussSeidel`` handles
run on the CUDA device unless given ``device`` (e.g. ``device="cpu"``).
The eigensolvers — ``lobpcg``, ``shift_invert_eigs`` (MINRES on a
``ShiftedOperator``) and ``rational_filter_eigs`` — run their block
applies on K1b, the column-batched K1, with lockstep block MINRES and
COCG inside; the last two lay out a CSR on the CUDA device by default.
A banded float64 or complex128 matrix runs the same kernels in its own
dtype.  The front ends: ``scipy_compat`` (scipy.sparse.linalg's
conventions), ``python -m sprsolve_tpu_torch info|solve|eig``, Matrix
Market ``utils.mmread``/``mmwrite``, ``utils.timing``, the dot kernels'
grid autotune (``utils.tune_padded_dia``) and ``examples/``.
"""

from . import debug, errors, precond, vecalg
from .api import (CG, GMRES, BiCGStab, CSMinRes, GaussSeidel, MinRes, PreparedSolver,
                  prepare, solve)
from .errors import SolveInfo, SolverError, Status
from .ops.operator import DiagonalOperator, IdentityOperator, LinearOperator, ShiftedOperator
from .ops.hybrid import HybridDIA
from .ops.optimize import optimize
from .multigrid import GridMGPrecond, InjectionMGPrecond
from .ops.padded_dia import ComplexPaddedDIA, PaddedDIA
from .precond import (
    BlockJacobiPrecond,
    ChebyshevPrecond,
    ComplexDiagPrecond,
    DiagPrecond,
    IC0Precond,
    ILU0Precond,
    InnerSolvePrecond,
    RelayedPrecond,
    estimate_spectral_bounds,
    real_abs_jacobi,
)
from .solvers import (
    ColoredELL,
    MaskedGSPrecond,
    MulticolorGSPrecond,
    batched,
    bicgstab,
    bicgstabl,
    block_cg,
    ca_bicgstab,
    ca_cg,
    cg,
    cg_single_sync,
    cgs,
    cocg,
    color_masks,
    cs_minres,
    fgmres,
    gauss_seidel,
    gauss_seidel_redblack,
    gmres,
    greedy_color,
    idrs,
    lobpcg,
    lsqr,
    minres,
    rational_filter_eigs,
    refine,
    refine_solve,
    shift_invert_eigs,
    tfqmr,
    with_real_planes,
)
from .sparse import (
    BSR,
    COO,
    CSC,
    CSR,
    DIA,
    ELL,
    ComplexBSR,
    csr_from_bcoo,
    csr_from_dense,
    csr_from_scipy,
    reorder_rcm,
)
from .utils.bounds import gershgorin_bounds

__version__ = "0.1.0"

__all__ = [
    "solve",
    "prepare",
    "PreparedSolver",
    "BiCGStab",
    "CG",
    "GMRES",
    "CSMinRes",
    "MinRes",
    "GaussSeidel",
    "bicgstab",
    "bicgstabl",
    "cg",
    "cg_single_sync",
    "ca_cg",
    "ca_bicgstab",
    "cgs",
    "tfqmr",
    "gmres",
    "fgmres",
    "idrs",
    "lobpcg",
    "shift_invert_eigs",
    "rational_filter_eigs",
    "block_cg",
    "batched",
    "refine",
    "refine_solve",
    "cocg",
    "cs_minres",
    "minres",
    "lsqr",
    "gauss_seidel",
    "gauss_seidel_redblack",
    "greedy_color",
    "color_masks",
    "ColoredELL",
    "MaskedGSPrecond",
    "MulticolorGSPrecond",
    "with_real_planes",
    "COO",
    "CSR",
    "CSC",
    "DIA",
    "ELL",
    "BSR",
    "ComplexBSR",
    "csr_from_dense",
    "csr_from_bcoo",
    "csr_from_scipy",
    "reorder_rcm",
    "LinearOperator",
    "IdentityOperator",
    "DiagonalOperator",
    "ShiftedOperator",
    "DiagPrecond",
    "ComplexDiagPrecond",
    "real_abs_jacobi",
    "ChebyshevPrecond",
    "estimate_spectral_bounds",
    "BlockJacobiPrecond",
    "ILU0Precond",
    "IC0Precond",
    "RelayedPrecond",
    "InnerSolvePrecond",
    "GridMGPrecond",
    "InjectionMGPrecond",
    "gershgorin_bounds",
    "optimize",
    "HybridDIA",
    "PaddedDIA",
    "ComplexPaddedDIA",
    "SolveInfo",
    "SolverError",
    "Status",
    "debug",
    "errors",
    "precond",
    "vecalg",
]
