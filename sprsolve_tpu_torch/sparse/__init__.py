"""Sparse containers and host-side builders (counterpart of
``sprsolve_tpu/sparse``): COO, CSR and CSC build formats, ELL, DIA, BSR and
ComplexBSR execution layouts, and the RCM reordering."""

from .bsr import BSR, ComplexBSR
from .containers import (COO, CSC, CSR, DIA, ELL, csr_from_bcoo, csr_from_dense,
                         csr_from_scipy, reorder_rcm)

__all__ = ["BSR", "COO", "CSC", "CSR", "ComplexBSR", "DIA", "ELL", "csr_from_bcoo",
           "csr_from_dense", "csr_from_scipy", "reorder_rcm"]
