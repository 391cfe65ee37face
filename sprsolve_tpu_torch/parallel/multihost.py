"""Process-group entry points: initialisation, the row group, and moving
host arrays to and from a row-partitioned run.

Counterpart of ``sprsolve_tpu/parallel/multihost.py``. ``jax.distributed``
becomes ``torch.distributed``: :func:`initialize` joins the process group
(from the ``torchrun`` environment, or from explicit arguments), the 1-D row
mesh is the world group in rank order (adjacent row blocks on adjacent
ranks, so ``torchrun``'s host-major rank order keeps most halo exchanges
inside a host), and the host↔global helpers cut out or gather row blocks.
Nothing on a machine tells a program of a cluster: pass the address
(``tcp://host:port`` or ``file://...``), the world size and the rank, or
start the program under ``torchrun``.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .comm import all_gather_rows


def initialize(init_method: Optional[str] = None, world_size: Optional[int] = None,
               rank: Optional[int] = None, *, backend: Optional[str] = None) -> None:
    """Join the process group. With no arguments the ``torchrun``
    environment (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``)
    gives them; else pass all three. ``backend`` defaults to NCCL when CUDA
    is present (each rank then takes ``cuda:{LOCAL_RANK}`` as its current
    device) and gloo otherwise."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    kw = {}
    if init_method is not None:
        kw.update(init_method=init_method, world_size=int(world_size), rank=int(rank))
    dist.init_process_group(backend, **kw)


def global_row_mesh():
    """The row group: every rank of the world, in rank order."""
    return dist.group.WORLD


def host_to_global(x, group=None, dim: int = 0) -> torch.Tensor:
    """This rank's row block of a host array that every rank holds: the
    ``rank``-th of the group's equal blocks along ``dim``."""
    group = dist.group.WORLD if group is None else group
    t = torch.as_tensor(np.asarray(x))
    size = t.shape[dim] // dist.get_world_size(group)
    return t.narrow(dim, dist.get_rank(group) * size, size).contiguous()


def replicate(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's row block, gathered in rank order, on every rank."""
    return all_gather_rows(x, dist.group.WORLD if group is None else group)


def fetch(x: torch.Tensor, group=None) -> np.ndarray:
    """The gathered array (:func:`replicate`) on the host."""
    return replicate(x, group).cpu().numpy()
