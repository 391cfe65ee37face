"""Distributed solve walkthrough, the counterpart of
``examples/distributed_demo.py``: the three row-partitioning strategies of
:mod:`sprsolve_tpu_torch.parallel` on ranks of a gloo process group, and the
same solver on one device for comparison. The solver code is the same in
all four; only the operator and the ``group`` differ. Then the eigen surface
on the same ranks: row-partitioned LOBPCG (the 2 smallest eigenpairs of the
SPD 16×16 grid Laplacian, Jacobi M) against a dense eigensolver.

Run: python -m sprsolve_tpu_torch.examples.distributed_demo [--device cpu]
[--ranks 2] [--grid 16]

The ranks are processes started here (``spawn``), joined through a
``file://`` store in a temporary directory; they all run on ``--device``
(default: the CUDA device, which they then share). On a machine with one
card per rank, start the solve under ``torchrun`` with NCCL instead
(``parallel.multihost.initialize``).
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch


def _problem(grid: int):
    from sprsolve_tpu_torch.utils import problems

    A = problems.poisson3d(grid, grid, grid, dtype=np.float64)
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    return A, b


def _spd_grid():
    """The SPD 16×16 grid Laplacian (5-point, Dirichlet), f64."""
    import dataclasses

    from sprsolve_tpu_torch.utils import problems

    L, _ = problems.sym_grid_laplacian((16, 16))
    return dataclasses.replace(L, data=-L.data)


def _rank(rank: int, world: int, store: str, device: str, grid: int, out: str) -> None:
    """One rank: the three strategies through ``distributed_solve``; rank 0
    writes each x and count to ``out``."""
    import torch.distributed as dist

    import sprsolve_tpu_torch as spt
    from sprsolve_tpu_torch.parallel import DistPaddedDIA, distributed_lobpcg, distributed_solve

    torch.set_num_threads(2)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=store, rank=rank, world_size=world)
    try:
        A, b = _problem(grid)
        dia = A.to_dia()
        M = spt.DiagPrecond.new(dia.diagonal())
        results = {}
        for name, op in (
            ("AllGatherELL + Jacobi", A),              # general sparsity: x all-gathered
            ("HaloDIA + Jacobi", dia),                 # banded: neighbour halo exchange
            ("DistPaddedDIA (kernels)", DistPaddedDIA.from_dia(dia, world)),  # K1/K2 per shard
        ):
            x, info = distributed_solve(spt.bicgstab, op, b, M=M, tol=1e-12, max_iter=500,
                                        device=dev)
            results[name] = (x.cpu().numpy(), int(info.iterations))
        # eigen surface × distributed: the k = 2 smallest pairs over the ranks
        G = _spd_grid()
        lam, _, info = distributed_lobpcg(G, k=2, M=spt.DiagPrecond.new(G.diagonal()),
                                          tol=1e-8, max_iter=200, device=dev)
        if rank == 0:
            np.savez(out, **{f"x{i}": x for i, (x, _) in enumerate(results.values())},
                     names=np.array(list(results)),
                     its=np.array([its for _, its in results.values()]),
                     lam=lam.cpu().numpy(), lam_its=int(info.iterations),
                     lam_status=int(info.status))
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    from sprsolve_tpu_torch.ops.optimize import default_device

    ap = argparse.ArgumentParser(prog="python -m sprsolve_tpu_torch.examples.distributed_demo")
    ap.add_argument("--device", default=None, help="default: the CUDA device")
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--grid", type=int, default=16, help="the grid³ Poisson (default 16)")
    args = ap.parse_args(argv)
    dev = default_device(args.device)

    import sprsolve_tpu_torch as spt

    A, b = _problem(args.grid)
    print(f"ranks: {args.ranks} (gloo) on {dev}; the {args.grid}³ Poisson, {A.shape[0]} rows")

    def check(name, x, its):
        y = A.matvec(torch.as_tensor(x, dtype=torch.float64)).numpy()
        rel = np.linalg.norm(y - b) / np.linalg.norm(b)
        print(f"{name:28s}: {its:4d} iters, true rel res {rel:.2e}")

    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rank0.npz")
        procs = [ctx.Process(target=_rank, args=(r, args.ranks, "file://" + os.path.join(
            tmp, "store"), str(dev), args.grid, out)) for r in range(args.ranks)]
        for p in procs:
            p.start()
        for p in procs:
            p.join()
        if any(p.exitcode != 0 for p in procs):
            raise RuntimeError(f"a rank failed: exit codes {[p.exitcode for p in procs]}")
        with np.load(out) as res:
            for i, name in enumerate(res["names"]):
                check(str(name), res[f"x{i}"], int(res["its"][i]))
            lobpcg = (res["lam"], int(res["lam_its"]), int(res["lam_status"]))

    # the same solver on one device, for comparison
    dia = A.to_dia()
    op = spt.PaddedDIA.from_dia(dia, device=dev)
    M = op.jacobi_precond()
    x2, info = spt.bicgstab(op, op.pad_vec(torch.as_tensor(b, device=dev)), M=M, tol=1e-12,
                            max_iter=500)
    check("single-device PaddedDIA", op.unpad_vec(x2).cpu().numpy(), int(info.iterations))

    from sprsolve_tpu_torch.errors import Status

    G = _spd_grid()
    import scipy.sparse as sps

    w = np.linalg.eigvalsh(sps.csr_matrix((G.data.numpy(), G.indices.numpy(),
                                           G.indptr.numpy()), shape=G.shape).toarray())
    lam, its, status = lobpcg
    print(f"{'distributed_lobpcg k=2':28s}: {its:4d} iters, {Status(status).name}, "
          f"max |lam - dense| {np.abs(np.sort(lam) - w[:2]).max():.2e}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
