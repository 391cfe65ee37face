"""SpMV paths, the operator protocol, layout optimization and the padded-DIA
CUDA kernels (counterpart of ``sprsolve_tpu/ops``)."""

from .operator import DiagonalOperator, IdentityOperator, LinearOperator, as_operator
from .optimize import optimize
from .padded_dia import PaddedDIA
from .spmv import spmv_csr, spmv_dia

__all__ = [
    "LinearOperator",
    "IdentityOperator",
    "DiagonalOperator",
    "as_operator",
    "optimize",
    "PaddedDIA",
    "spmv_csr",
    "spmv_dia",
]
