"""The three communication primitives of the distributed layer.

Counterparts of ``lax.psum``, ``lax.ppermute`` and ``lax.all_gather`` in
``sprsolve_tpu/parallel/`` (``dist_operator.py:152-160``), on a
``torch.distributed`` process group:

- :func:`all_reduce_sum` — one collective for a small tensor of stacked
  partials, the same bits on every rank. It lives in ``vecalg``, under the
  reductions that call it, and is re-exported here.
- :func:`halo_exchange` — the neighbour exchange of the row-partitioned
  SpMV: rank r sends its head to r − 1 and its tail to r + 1; the global
  edges receive zeros, as ``ppermute`` leaves unmatched destinations.
- :func:`all_gather_rows` — equal row blocks, concatenated in rank order.

The backend is read from the group. Under NCCL the tensors stay on the
device and the halo goes through ``dist.batch_isend_irecv``. Gloo takes
CUDA tensors for ``all_reduce`` and ``broadcast`` only, so under gloo the
halo and the gathers of CUDA tensors go through host copies. Complex
tensors travel as their real views.

Each primitive counts its calls and bytes in ``calls`` and ``bytes``
attributes (:func:`reset_counts`, :func:`counts`), as the kernel wrappers
count their launches: ``all_reduce_sum`` the slab it reduces,
``halo_exchange`` the bytes this rank sends (its head to a previous rank,
its tail to a next one: nothing on a group of one), ``all_gather_rows``
the block it contributes.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..vecalg import all_reduce_sum


def _wire(t: torch.Tensor) -> torch.Tensor:
    """The real view a complex tensor travels as (itself for a real one)."""
    return torch.view_as_real(t) if t.is_complex() else t


def _through_host(group, t: torch.Tensor) -> bool:
    """Whether ``t`` must go through a host copy on ``group`` (a CUDA
    tensor under gloo, which takes CUDA tensors for all_reduce only)."""
    return t.device.type == "cuda" and dist.get_backend(group) == "gloo"


def halo_exchange(head: torch.Tensor, tail: torch.Tensor, group):
    """``(from_prev, from_next)``: the previous rank's ``tail`` and the next
    rank's ``head``, zeros at the global edges (rank 0 has no previous, the
    last rank no next). Every rank of ``group`` must call it."""
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    host = _through_host(group, head)
    stage = (lambda v: v.cpu()) if host else (lambda v: v.contiguous())
    buf_prev = torch.zeros(tail.shape, dtype=tail.dtype,
                           device="cpu" if host else tail.device)
    buf_next = torch.zeros(head.shape, dtype=head.dtype,
                           device="cpu" if host else head.device)
    ops = []
    if rank > 0:
        peer = dist.get_global_rank(group, rank - 1)
        ops += [dist.P2POp(dist.isend, _wire(stage(head)), peer, group),
                dist.P2POp(dist.irecv, _wire(buf_prev), peer, group)]
    if rank < world - 1:
        peer = dist.get_global_rank(group, rank + 1)
        ops += [dist.P2POp(dist.isend, _wire(stage(tail)), peer, group),
                dist.P2POp(dist.irecv, _wire(buf_next), peer, group)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    halo_exchange.calls += 1
    halo_exchange.bytes += ((rank > 0) * head.numel() * head.element_size()
                            + (rank < world - 1) * tail.numel() * tail.element_size())
    if host:
        return buf_prev.to(tail.device), buf_next.to(head.device)
    return buf_prev, buf_next


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The row blocks of every rank (each of ``x``'s shape), concatenated
    along dim 0 in rank order, on every rank."""
    world = dist.get_world_size(group)
    host = _through_host(group, x)
    src = x.cpu() if host else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(world)]
    dist.all_gather([_wire(p) for p in parts], _wire(src), group=group)
    all_gather_rows.calls += 1
    all_gather_rows.bytes += x.numel() * x.element_size()
    out = torch.cat(parts, dim=0)
    return out.to(x.device) if host else out


PRIMITIVES = (all_reduce_sum, halo_exchange, all_gather_rows)


def reset_counts() -> None:
    """Set the call and byte counts of every primitive to 0."""
    for p in PRIMITIVES:
        p.calls = p.bytes = 0


def counts() -> dict:
    """``{name: (calls, bytes)}`` of every primitive."""
    return {p.__name__: (p.calls, p.bytes) for p in PRIMITIVES}


reset_counts()
