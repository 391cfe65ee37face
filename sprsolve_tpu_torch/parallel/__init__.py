"""Row-partitioned distributed solves on ``torch.distributed``.

Counterpart of ``sprsolve_tpu/parallel/``: the matrix is partitioned by row
blocks over the ranks of a process group, each rank owns the matching block
of every solver vector, the solvers' reductions become one-collective sums
over the group (their ``group=`` argument, the JAX package's
``axis_name``), and the SpMV obtains remote x entries by a neighbour halo
exchange (banded operators) or an all-gather (any sparsity). The kernel
operators :class:`DistPaddedDIA` and :class:`DistComplexPaddedDIA` run the
single-GPU kernels K1-K7 on each rank's shard. Every rank calls the same
functions (SPMD), as every device runs the body of the JAX package's
``shard_map``. The distributed eigensolvers (:func:`distributed_lobpcg`,
:func:`distributed_shift_invert_eigs`, :func:`distributed_rational_filter_eigs`)
run the single-device ones with the same ``group=`` over the torch-op
operators.
"""

from . import comm, multihost
from .dist_operator import (
    AllGatherELL, HaloDIA, MPKDIA, partition_csr, partition_dia, partition_dia_mpk,
)
from .dist_padded_dia import DistComplexPaddedDIA, DistPaddedDIA
from .eigen import (
    distributed_lobpcg, distributed_rational_filter_eigs, distributed_shift_invert_eigs,
)
from .solve import distributed_solve, local_part, make_solver_specs

__all__ = [
    "AllGatherELL",
    "HaloDIA",
    "DistComplexPaddedDIA",
    "DistPaddedDIA",
    "partition_csr",
    "partition_dia",
    "MPKDIA",
    "partition_dia_mpk",
    "distributed_solve",
    "distributed_lobpcg",
    "distributed_shift_invert_eigs",
    "distributed_rational_filter_eigs",
    "local_part",
    "make_solver_specs",
    "comm",
    "multihost",
]
