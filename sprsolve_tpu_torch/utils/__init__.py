"""Utilities: the problem generators and the Gershgorin bounds."""

from .bounds import gershgorin_bounds
from .problems import (
    convection_diffusion3d,
    grid_laplacian_dirichlet,
    poisson3d,
    set_boundary_condition,
    simple_diag_system,
    sym_grid_laplacian,
)

__all__ = [
    "convection_diffusion3d",
    "gershgorin_bounds",
    "grid_laplacian_dirichlet",
    "poisson3d",
    "set_boundary_condition",
    "simple_diag_system",
    "sym_grid_laplacian",
]
