"""The distributed solve: one solver, row-partitioned over a group.

Counterpart of ``sprsolve_tpu/parallel/solve.py``. The solvers take a
``group=`` (the JAX package's ``axis_name``) that turns every reduction
into a sum over the group's ranks, so this module only lays out the data:
pad n to the group's size, cut out this rank's rows of the operator, the
rhs, the guess and the preconditioner, run the solver with the group (the
SpMV does its own exchange), then all-gather x. It runs SPMD: every rank
calls :func:`distributed_solve` with the same arguments, inside an
initialised process group, and every rank gets the global ``(x, info)``.
``shard_map``'s PartitionSpecs become :func:`make_solver_specs`: for each
argument, the dimension of each tensor that is cut into the ranks' row
blocks (``None``: the whole tensor on every rank).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..errors import SolveInfo
from ..precond import ComplexDiagPrecond, DiagPrecond
from ..sparse.containers import CSR, DIA
from .comm import all_gather_rows
from .dist_operator import (
    AllGatherELL, HaloDIA, MPKDIA, partition_csr, partition_dia, partition_dia_mpk,
)
from .dist_padded_dia import DistComplexPaddedDIA, DistPaddedDIA

_DISTRIBUTED = (AllGatherELL, HaloDIA, MPKDIA, DistPaddedDIA, DistComplexPaddedDIA)


def _row_spec(M):
    """The spec of a diagonal preconditioner: each tensor field on its rows."""
    return dataclasses.replace(M, **{f.name: 0 for f in dataclasses.fields(M)
                                     if isinstance(getattr(M, f.name), torch.Tensor)})


def make_solver_specs(A_parts, M_parts=None):
    """``(in_specs, out_specs)`` of ``solver(A, b, x0[, M])``: the operator's
    own ``pspec()``, b and x0 on their rows (dim 0), a preconditioner's
    ``pspec()`` or, for a diagonal one, its diagonal on its rows; x comes
    out on its rows and the ``SolveInfo`` whole on every rank."""
    specs = [A_parts.pspec(), 0, 0]
    if M_parts is not None:
        specs.append(M_parts.pspec() if hasattr(M_parts, "pspec") else _row_spec(M_parts))
    return tuple(specs), (0, SolveInfo(None, None, None))


def local_part(obj, spec, group, device=None):
    """This rank's part of ``obj`` under ``spec`` (a :func:`make_solver_specs`
    entry), on ``device``: a tensor is cut into the group's equal blocks
    along dimension ``spec`` (``None``: kept whole); a dataclass is cut
    field by field, and its ``group`` field, where it has one, is set to
    ``group``."""
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    if isinstance(obj, torch.Tensor):
        if spec is not None:
            size = obj.shape[spec] // world
            obj = obj.narrow(spec, rank * size, size)
        return obj.to(device).contiguous()
    if isinstance(obj, tuple):
        return tuple(local_part(o, s, group, device) for o, s in zip(obj, spec))
    if dataclasses.is_dataclass(obj):
        kw = {}
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if f.name == "group":
                kw[f.name] = group
            elif isinstance(v, (torch.Tensor, tuple)) or dataclasses.is_dataclass(v):
                if isinstance(v, tuple) and not all(isinstance(t, torch.Tensor) for t in v):
                    continue   # static metadata such as offsets
                kw[f.name] = local_part(v, getattr(spec, f.name), group, device)
        return dataclasses.replace(obj, **kw)
    return obj


def default_device() -> torch.device:
    """``cuda:{LOCAL_RANK}``; raises when that device does not exist."""
    idx = int(os.environ.get("LOCAL_RANK", "0"))
    if not torch.cuda.is_available() or idx >= torch.cuda.device_count():
        raise RuntimeError(
            f"no CUDA device cuda:{idx} (LOCAL_RANK={idx}); pass device='cpu' "
            "to run the ranks on the CPU"
        )
    return torch.device("cuda", idx)


def _partition(A, world: int, mpk_s):
    if isinstance(A, CSR):
        if mpk_s:
            raise TypeError("matrix-powers partitioning (mpk_s) needs a banded DIA "
                            "operator; convert with A.to_dia()")
        return partition_csr(A, world)
    if isinstance(A, DIA):
        return partition_dia_mpk(A, world, mpk_s) if mpk_s else partition_dia(A, world)
    if isinstance(A, _DISTRIBUTED):
        return A
    raise TypeError(f"cannot partition operator of type {type(A)}")


def _relay(M, A_parts, n_pad: int):
    """A flat diagonal preconditioner in the operator's global layout
    (``sprsolve_tpu/parallel/solve.py:100-147``): pads of a padded-kernel
    layout get a zero reciprocal (0·0 = 0), identity pad rows a one; a
    diagonal already in the global layout passes as it is."""
    kernel = isinstance(A_parts, (DistPaddedDIA, DistComplexPaddedDIA))
    if type(M) in (DiagPrecond, ComplexDiagPrecond):
        d = torch.as_tensor(M.diag_inv)
        if kernel and d.shape[0] != A_parts.padded_len:
            if type(M) is ComplexDiagPrecond:
                # inert 1 + 0i pad reciprocals, as the JAX package's planes
                rows = A_parts.pad_vec(torch.ones(A_parts.n, dtype=d.real.dtype,
                                                  device=d.device)) != 0
                d = torch.where(rows, A_parts.pad_vec(d), torch.ones((), dtype=d.dtype))
            else:
                d = A_parts.pad_vec(d)
        elif not kernel and d.shape[0] != n_pad:
            d = torch.cat([d, torch.ones(n_pad - d.shape[0], dtype=d.dtype, device=d.device)])
        return type(M)(diag_inv=d)
    if hasattr(M, "pspec"):
        # operator preconditioners (e.g. MaskedGSPrecond over a distributed
        # operator) give their own specs; the caller builds them in the
        # distributed layout
        return M
    raise TypeError("distributed_solve takes a DiagPrecond, a ComplexDiagPrecond or a "
                    "preconditioner with pspec()")


def distributed_solve(solver_fn, A, b, x0=None, *, M=None, tol, max_iter, group=None,
                      device=None, mpk_s: Optional[int] = None):
    """Solve A·x = b with ``solver_fn`` row-partitioned over ``group``.

    Every rank of ``group`` (default: the world group, which must be
    initialised: without one this raises) calls it with the same arguments.
    ``A`` is a host CSR/DIA (partitioned here) or an operator already
    partitioned (:class:`AllGatherELL`, :class:`HaloDIA`, :class:`MPKDIA`,
    :class:`DistPaddedDIA`, :class:`DistComplexPaddedDIA`). ``M`` is a
    ``DiagPrecond``/``ComplexDiagPrecond`` (flat, re-laid here, or already
    in the operator's global layout) or a preconditioner with ``pspec()``.
    ``mpk_s`` partitions a DIA with matrix-powers windows of depth
    ``mpk_s`` for an s-step solver (``functools.partial(ca_cg, s=...)``).
    The solve runs on ``device`` (default ``cuda:{LOCAL_RANK}``, which must
    exist). Returns the global ``(x, SolveInfo)`` on every rank, x on
    ``device``."""
    if not dist.is_initialized():
        raise RuntimeError("distributed_solve needs an initialised process group "
                           "(torch.distributed.init_process_group, or "
                           "parallel.multihost.initialize)")
    group = dist.group.WORLD if group is None else group
    device = default_device() if device is None else torch.device(device)
    world = dist.get_world_size(group)
    A_parts = _partition(A, world, mpk_s)

    b = torch.as_tensor(b)
    n = b.shape[0]
    x0 = torch.zeros_like(b) if x0 is None else torch.as_tensor(x0)
    kernel = isinstance(A_parts, (DistPaddedDIA, DistComplexPaddedDIA))
    if kernel:
        b, x0 = A_parts.pad_vec(b), A_parts.pad_vec(x0)
        n_pad = n
    else:
        n_pad = A_parts.shape[0]
        if n_pad != n:
            # rhs may be (n,) or an (n, k) block (block_cg)
            pad = torch.zeros((n_pad - n,) + tuple(b.shape[1:]), dtype=b.dtype, device=b.device)
            b, x0 = torch.cat([b, pad]), torch.cat([x0, pad.to(x0.dtype)])
    M_parts = None if M is None else _relay(M, A_parts, n_pad)

    in_specs, _ = make_solver_specs(A_parts, M_parts)
    args = [local_part(a, s, group, device)
            for a, s in zip((A_parts, b, x0, M_parts), in_specs)]
    kw = {} if M_parts is None else {"M": args[3]}
    x_local, info = solver_fn(args[0], args[1], args[2], tol=tol, max_iter=max_iter,
                              group=group, **kw)[:2]
    x_pad = all_gather_rows(x_local, group)
    return (A_parts.unpad_vec(x_pad) if kernel else x_pad[:n]), info
