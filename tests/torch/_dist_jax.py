"""The JAX package's side of the distributed cross tests: each case of
``_dist_worker.CASESETS`` through ``sprsolve_tpu.parallel.distributed_solve``
on a sub-mesh of the conftest's virtual CPU devices, and the checks that
hold the port's ranks to it."""

from __future__ import annotations

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

import sprsolve_tpu as sp
from sprsolve_tpu.parallel import distributed_solve, partition_dia
from sprsolve_tpu.precond import ComplexDiagPrecond
from sprsolve_tpu.solvers.redblack import MaskedGSPrecond
from sprsolve_tpu.utils import problems

import _dist_worker as worker


def band(its: int) -> int:
    """The count band of ``tests/test_serial_parity.py:183``."""
    return max(3, -(-its // 4))


def _dirichlet(shape):
    A = problems.grid_laplacian_dirichlet(shape)
    rhs = np.zeros(shape[0] * shape[1])
    problems.set_boundary_condition(rhs, shape, lambda r, c: float(r + c))
    return A, rhs


def _spd_grid(side):
    A, _ = problems.sym_grid_laplacian((side, side))
    return dataclasses.replace(A, data=-A.data)


def write_shadow(world: int, out: str) -> None:
    """The JAX package's IDR(4) shadow block of one rank's rows of the 16×16
    grid (``sprsolve_tpu/solvers/idrs.py:128-139`` under shard_map), for the
    port's ranks to use in place of their own draw."""
    key = jax.random.key(7)
    P = jax.random.normal(key, (256 // world, 4), dtype=jnp.float64)
    P, _ = jnp.linalg.qr(P)
    np.save(os.path.join(out, f"shadow_w{world}.npy"), np.asarray(P))


def jax_case(name: str, world: int):
    """``(x, iterations, A, rhs)`` of case ``name`` from the JAX package on a
    ``world``-device mesh; ``A`` is a JAX CSR for the true residual."""
    mesh = jax.make_mesh((world,), ("rows",), devices=jax.devices()[:world])
    run = functools.partial(distributed_solve, mesh=mesh)
    if name in ("bicgstab_ell", "bicgstab_dia", "padding_exact"):
        A, rhs = _dirichlet((9, 9) if name == "padding_exact" else (20, 20))
        x, info = run(sp.bicgstab, A.to_dia() if name == "bicgstab_dia" else A, rhs,
                      tol=1e-15, max_iter=1500)
    elif name == "minres_complex_precond":
        A, rhs, diag = problems.hermitian_grid_with_diag((8, 8))
        x, info = run(sp.minres, A, rhs, M=sp.DiagPrecond.new(diag), tol=1e-22,
                      max_iter=300)
    elif name == "cs_minres_ell":
        A, rhs, _ = problems.complex_symmetric_grid_with_diag((8, 8))
        x, info = run(sp.cs_minres, A, rhs, tol=1e-22, max_iter=300)
    elif name == "masked_gs":
        A, rhs = _dirichlet((20, 20))
        op = partition_dia(A.to_dia(), world)
        M = MaskedGSPrecond(A=op, diag=A.diagonal(),
                            masks=sp.color_masks(sp.greedy_color(A)), sweeps=1)
        x, info = run(sp.bicgstab, op, jnp.asarray(rhs), M=M, tol=1e-14, max_iter=1500)
    elif name == "cg_dia":
        A = _spd_grid(16)
        rhs = np.random.default_rng(7).standard_normal(256)
        x, info = run(sp.cg, A.to_dia(), rhs, tol=1e-12, max_iter=2000)
    elif name in ("gmres_dia", "idrs_dia"):
        A, rhs = _dirichlet((16, 16))
        solver = functools.partial(sp.gmres, restart=16) if name == "gmres_dia" else sp.idrs
        x, info = run(solver, A.to_dia(), rhs, tol=1e-12,
                      max_iter=600 if name == "gmres_dia" else 2000)
    elif name in ("complex_bicgstab", "complex_flat_jacobi", "complex_cs_minres"):
        A, rhs, diag = problems.complex_symmetric_grid_with_diag((16, 16))
        d = np.asarray(A.todense()).diagonal()
        if name == "complex_cs_minres":
            x, info = run(sp.cs_minres, A.to_dia(), rhs, M=sp.DiagPrecond.new(np.abs(d)),
                          tol=1e-14, max_iter=600)
        else:
            x, info = run(sp.bicgstab, A.to_dia(), rhs, M=ComplexDiagPrecond.new(d),
                          tol=1e-14, max_iter=600)
    elif name in ("padded_bicgstab", "padded_minres"):
        A = problems.poisson3d(10, 10, 10, dtype=np.float64)
        dia = A.to_dia()
        if name == "padded_bicgstab":
            rhs = worker.poisson_rhs(1000, 1)
            x, info = run(sp.bicgstab, dia, rhs, M=sp.DiagPrecond.new(np.asarray(dia.diagonal())),
                          tol=1e-12, max_iter=500)
        else:
            rhs = worker.poisson_rhs(1000, 3)
            x, info = run(sp.minres, dia, rhs, tol=1e-10, max_iter=400)
    elif name == "ca_cg_mpk":
        A = _spd_grid(32)
        rhs = np.random.default_rng(9).standard_normal(1024)
        solver = functools.partial(sp.ca_cg, s=4, bounds=sp.gershgorin_bounds(A))
        x, info = run(solver, A.to_dia(), rhs, tol=1e-10, max_iter=2000, mpk_s=4)
    else:
        raise KeyError(name)
    info.raise_if_error()
    return np.asarray(x), int(info.iterations), A, np.asarray(rhs)


# the cases whose counts the two packages keep in step, on 2 and on 4
# ranks (the others lie in the band: tol 1e-15 to 1e-22 near stagnation,
# and IDR(s)'s and BiCGStab's restarts move with the reduction order)
EQUAL_COUNTS = {"masked_gs", "cg_dia", "gmres_dia", "complex_cs_minres", "padded_bicgstab",
                "padded_minres", "ca_cg_mpk"}


def run_all(caseset: str, world: int, out: str):
    """Start the ranks of ``caseset``, compute the JAX side of its solve cases
    meanwhile (four at a time: XLA compiles outside the interpreter lock),
    then wait for the ranks. Returns ``(rank results, {case: jax_case})``."""
    from concurrent.futures import ThreadPoolExecutor

    write_shadow(world, out)
    procs = worker.launch(caseset, world, out)
    names = [n for n in worker.CASESETS[caseset] if n in SOLVE_CASES]
    with ThreadPoolExecutor(4) as pool:
        refs = dict(zip(names, pool.map(lambda n: jax_case(n, world), names)))
    return worker.collect(procs, out), refs


SOLVE_CASES = set(worker.CASESETS["solve"])


def check_case(run, name: str, world: int):
    """Every rank's x bits and info identical; the port's x within 1e-10
    (relative) of the JAX package's, its true residual converged, and its
    count equal to JAX's or within the band. ``run`` is :func:`run_all`'s
    result."""
    results, refs = run
    xj, its_j, A, rhs = refs[name]
    r0 = results[0][name]
    assert "error" not in r0, r0.get("error")
    for r in range(1, world):
        rr = results[r][name]
        assert "error" not in rr, rr.get("error")
        assert np.array_equal(rr["x"], r0["x"]), f"rank {r} x differs"
        assert (rr["its"], rr["res"], rr["status"]) == (r0["its"], r0["res"], r0["status"])
    assert r0["status"] == 0, r0
    x = r0["x"]
    assert x.shape == xj.shape
    err = np.linalg.norm(x - xj) / np.linalg.norm(xj)
    assert err <= 1e-10, (name, err)
    res = np.linalg.norm(np.asarray(A.matvec(jnp.asarray(x))) - rhs) / np.linalg.norm(rhs)
    assert res <= 1e-9, (name, res)
    if name in EQUAL_COUNTS:
        assert r0["its"] == its_j, (name, r0["its"], its_j)
    else:
        assert abs(r0["its"] - its_j) <= band(its_j), (name, r0["its"], its_j)
    return r0["its"], its_j
