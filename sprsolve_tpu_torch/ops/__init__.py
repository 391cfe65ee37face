"""SpMV paths, the operator protocol, layout optimization (with the
``Reordered`` and ``HybridDIA`` layouts) and the padded-DIA CUDA kernels
(counterpart of ``sprsolve_tpu/ops``)."""

from .hybrid import HybridDIA
from .operator import (DiagonalOperator, IdentityOperator, LinearOperator, ShiftedOperator,
                       as_operator)
from .optimize import optimize
from .padded_dia import ComplexPaddedDIA, PaddedDIA
from .reordered import Reordered
from .spmv import spmv_csr, spmv_dia

__all__ = [
    "LinearOperator",
    "IdentityOperator",
    "DiagonalOperator",
    "ShiftedOperator",
    "as_operator",
    "optimize",
    "PaddedDIA",
    "ComplexPaddedDIA",
    "HybridDIA",
    "Reordered",
    "spmv_csr",
    "spmv_dia",
]
