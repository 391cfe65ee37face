"""Iterative solvers as plain functions on tensors (counterpart of
``sprsolve_tpu/solvers``). The first slice ports BiCGStab."""

from .bicgstab import bicgstab

__all__ = ["bicgstab"]
