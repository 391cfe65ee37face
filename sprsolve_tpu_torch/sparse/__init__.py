"""Sparse containers and host-side builders (counterpart of
``sprsolve_tpu/sparse``): COO and CSR build formats, DIA banded storage."""

from .containers import COO, CSR, DIA, csr_from_dense, csr_from_scipy

__all__ = ["COO", "CSR", "DIA", "csr_from_dense", "csr_from_scipy"]
