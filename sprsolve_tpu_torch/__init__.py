"""sprsolve_tpu_torch — the PyTorch/CUDA port of ``sprsolve_tpu``.

A second package beside the JAX one, for one NVIDIA H100.  Module layout
and names follow ``sprsolve_tpu``, so each module's counterpart is found by
name.  Plain tensor code is PyTorch; the padded-DIA SpMV kernels that the
JAX package wrote in Pallas are CUDA C++ for Hopper (``csrc/``), built with
nvcc at first use.  The package imports no JAX.

Ported so far: BiCGStab on the padded-DIA kernels K1/K2, MINRES and CG on
K3/K4, BiCGStab(ℓ) as ``method="auto"``'s nonsymmetric route, and the complex
path on the two-plane kernels K5-K7 (COCG, CS-MINRES, complex BiCGStab and
MINRES): ``solve(A, b, method="bicgstab" | "minres" | "cg" | "bicgstabl" |
"cs_minres" | "cocg" | "auto", M="jacobi")``, ``prepare`` and the
``BiCGStab``, ``MinRes``, ``CG`` and ``CSMinRes`` handles.  The entry points
run on the CUDA device unless given ``device`` (e.g. ``device="cpu"``).
"""

from . import errors, precond, vecalg
from .api import CG, BiCGStab, CSMinRes, MinRes, PreparedSolver, prepare, solve
from .errors import SolveInfo, SolverError, Status
from .ops.operator import DiagonalOperator, IdentityOperator, LinearOperator
from .ops.optimize import optimize
from .ops.padded_dia import ComplexPaddedDIA, PaddedDIA
from .precond import ComplexDiagPrecond, DiagPrecond, real_abs_jacobi
from .solvers import bicgstab, bicgstabl, cg, cocg, cs_minres, minres, with_real_planes
from .sparse import COO, CSR, DIA, csr_from_dense, csr_from_scipy

__version__ = "0.1.0"

__all__ = [
    "solve",
    "prepare",
    "PreparedSolver",
    "BiCGStab",
    "CG",
    "CSMinRes",
    "MinRes",
    "bicgstab",
    "bicgstabl",
    "cg",
    "cocg",
    "cs_minres",
    "minres",
    "with_real_planes",
    "COO",
    "CSR",
    "DIA",
    "csr_from_dense",
    "csr_from_scipy",
    "LinearOperator",
    "IdentityOperator",
    "DiagonalOperator",
    "DiagPrecond",
    "ComplexDiagPrecond",
    "real_abs_jacobi",
    "optimize",
    "PaddedDIA",
    "ComplexPaddedDIA",
    "SolveInfo",
    "SolverError",
    "Status",
    "errors",
    "precond",
    "vecalg",
]
