"""Sparse containers and host-side builders (counterpart of
``sprsolve_tpu/sparse``): COO, CSR and CSC build formats, ELL and DIA
execution layouts."""

from .containers import COO, CSC, CSR, DIA, ELL, csr_from_dense, csr_from_scipy

__all__ = ["COO", "CSC", "CSR", "DIA", "ELL", "csr_from_dense", "csr_from_scipy"]
