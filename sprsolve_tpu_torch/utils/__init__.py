"""Utilities: the problem generators of the first slice."""

from .problems import grid_laplacian_dirichlet, poisson3d, set_boundary_condition

__all__ = ["grid_laplacian_dirichlet", "poisson3d", "set_boundary_condition"]
