"""sprsolve_tpu_torch — the PyTorch/CUDA port of ``sprsolve_tpu``.

A second package beside the JAX one, for one NVIDIA H100.  Module layout
and names follow ``sprsolve_tpu``, so each module's counterpart is found by
name.  Plain tensor code is PyTorch; the padded-DIA SpMV kernels that the
JAX package wrote in Pallas are CUDA C++ for Hopper (``csrc/``), built with
nvcc at first use.  The package imports no JAX.

Ported so far: BiCGStab on the padded-DIA kernels K1/K2, and MINRES and CG
on K3/K4, with BiCGStab(ℓ) as ``method="auto"``'s nonsymmetric route:
``solve(A, b, method="bicgstab" | "minres" | "cg" | "bicgstabl" | "auto",
M="jacobi", device="cuda")``, ``prepare`` and the ``BiCGStab``, ``MinRes``
and ``CG`` handles.
"""

from . import errors, precond, vecalg
from .api import CG, BiCGStab, MinRes, PreparedSolver, prepare, solve
from .errors import SolveInfo, SolverError, Status
from .ops.operator import DiagonalOperator, IdentityOperator, LinearOperator
from .ops.optimize import optimize
from .ops.padded_dia import PaddedDIA
from .precond import DiagPrecond
from .solvers import bicgstab, bicgstabl, cg, minres
from .sparse import COO, CSR, DIA, csr_from_dense, csr_from_scipy

__version__ = "0.1.0"

__all__ = [
    "solve",
    "prepare",
    "PreparedSolver",
    "BiCGStab",
    "CG",
    "MinRes",
    "bicgstab",
    "bicgstabl",
    "cg",
    "minres",
    "COO",
    "CSR",
    "DIA",
    "csr_from_dense",
    "csr_from_scipy",
    "LinearOperator",
    "IdentityOperator",
    "DiagonalOperator",
    "DiagPrecond",
    "optimize",
    "PaddedDIA",
    "SolveInfo",
    "SolverError",
    "Status",
    "errors",
    "precond",
    "vecalg",
]
