"""Utilities: Matrix Market IO, the timing harness, the kernel-grid
autotune, the problem generators and the Gershgorin bounds."""

from . import timing
from .bounds import gershgorin_bounds
from .io import mmread, mmwrite
from .problems import (
    complex_symmetric_grid_with_diag,
    convection_diffusion3d,
    grid_laplacian_dirichlet,
    hermitian_grid,
    hermitian_grid_with_diag,
    poisson3d,
    set_boundary_condition,
    simple_diag_system,
    sym_grid_laplacian,
)
from .tuning import tune_complex_padded_dia, tune_padded_dia

__all__ = [
    "mmread",
    "mmwrite",
    "tune_padded_dia",
    "tune_complex_padded_dia",
    "complex_symmetric_grid_with_diag",
    "convection_diffusion3d",
    "gershgorin_bounds",
    "grid_laplacian_dirichlet",
    "hermitian_grid",
    "hermitian_grid_with_diag",
    "poisson3d",
    "set_boundary_condition",
    "simple_diag_system",
    "sym_grid_laplacian",
]
