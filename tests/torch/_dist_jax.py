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


# --- the distributed eigensolvers ------------------------------------------------
EIGEN_TAGS = 400   # the largest max_iter of a LOBPCG in the eigen cases
# the (rows per rank, k) of each world's LOBPCG blocks whose draws are patched
EIGEN_SHAPES = {2: ((128, 4), (72, 3), (128, 2)), 3: ((34, 4),)}


@functools.lru_cache(maxsize=None)
def _draws_fn(rows: int, k: int):
    """The JAX package's LOBPCG draws of one shard under ``shard_map``
    (``sprsolve_tpu/solvers/lobpcg.py:63-71, 232-266``): the initial P's
    key ``fold_in(fold_in(key(0), 0), rank)``, then ``fold_in(fold_in(
    fold_in(key(0), i), j), rank)`` for j = 17, 29 and i = 1..EIGEN_TAGS."""
    def draws(rank):
        key0 = jax.random.key(0)
        normal = lambda key: jax.random.normal(key, (rows, k), dtype=jnp.float64)
        first = normal(jax.random.fold_in(jax.random.fold_in(key0, 0), rank))

        def at(i):
            key = jax.random.fold_in(key0, i)
            return jnp.stack([normal(jax.random.fold_in(jax.random.fold_in(key, j), rank))
                              for j in (17, 29)])

        rest = jax.vmap(at)(jnp.arange(1, EIGEN_TAGS + 1, dtype=jnp.uint32))
        return jnp.concatenate([first[None], rest.reshape(-1, rows, k)])

    return jax.jit(draws)


def write_draws(world: int, out: str) -> None:
    """Each rank's table of draws, as ``_dist_worker.jax_draws`` reads it."""
    for rank in range(world):
        np.savez(os.path.join(out, f"draws_w{world}_r{rank}.npz"),
                 **{f"{r}x{k}": np.asarray(_draws_fn(r, k)(jnp.uint32(rank)))
                    for r, k in EIGEN_SHAPES[world]})


def _dense(A) -> np.ndarray:
    return np.asarray(A.todense())


def _ramp_grid(side, lo, span):
    dense = _dense(_spd_grid(side))
    n = dense.shape[0]
    dense = dense + np.diag(lo + span * np.arange(n) / n)
    return sp.csr_from_dense(dense).to_dia(), dense


def _nearest(w, sigma, k):
    return np.sort(w[np.argsort(np.abs(w - sigma), kind="stable")[:k]])


def jax_eigen_case(name: str, world: int) -> dict:
    """Case ``name`` of the eigen case sets through the JAX package's
    distributed drivers on a ``world``-device mesh: ``{"lam", "X", "its",
    "status", "dense", "want"}``, ``want`` the dense eigenvalues the case
    should return, ascending."""
    from sprsolve_tpu.parallel import (
        distributed_lobpcg, distributed_rational_filter_eigs, distributed_shift_invert_eigs,
    )

    mesh = jax.make_mesh((world,), ("rows",), devices=jax.devices()[:world])
    lob = functools.partial(distributed_lobpcg, mesh=mesh)
    si = functools.partial(distributed_shift_invert_eigs, mesh=mesh)
    rf = functools.partial(distributed_rational_filter_eigs, mesh=mesh)
    if name in ("lobpcg_ell", "lobpcg_dia", "lobpcg_pad"):
        A = _spd_grid(10 if name == "lobpcg_pad" else 16)
        dense = _dense(A)
        out = lob(A.to_dia() if name == "lobpcg_dia" else A, 4, tol=1e-9, max_iter=400)
        want = np.linalg.eigvalsh(dense)[:4]
    elif name == "lobpcg_largest":
        A = _spd_grid(12)
        dense = _dense(A)
        out = lob(A, 3, largest=True, tol=1e-9, max_iter=400)
        want = np.linalg.eigvalsh(dense)[-3:]
    elif name == "lobpcg_jacobi":
        A, dense = _ramp_grid(12, 1.0, 9.0)
        out = lob(A, 3, M=sp.DiagPrecond.new(jnp.asarray(np.diag(dense))), tol=1e-9,
                  max_iter=400)
        want = np.linalg.eigvalsh(dense)[:3]
    elif name in ("si_both", "si_pad"):
        A = _spd_grid(10 if name == "si_pad" else 16)
        dense = _dense(A)
        w = np.linalg.eigvalsh(dense)
        sigma = 1.0 if name == "si_pad" else worker.between(w, 5)
        out = si(A, 4, sigma, tol=1e-7, max_iter=300 if name == "si_pad" else 200)
        want = _nearest(w, sigma, 4)
    elif name in ("si_above", "si_below"):
        A = _spd_grid(12)
        dense = _dense(A)
        w = np.linalg.eigvalsh(dense)
        sigma = worker.between(w, 3, unique=True)
        side = name[3:]
        out = si(A, 3, sigma, side=side, tol=1e-7, max_iter=200)
        want = np.sort(w[w >= sigma])[:3] if side == "above" else np.sort(w[w < sigma])[-3:]
    elif name == "si_jacobi":
        A, dense = _ramp_grid(12, 2.0, 10.0)
        w = np.linalg.eigvalsh(dense)
        sigma = worker.between(w, 3)
        out = si(A, 3, sigma, M_inner=sp.DiagPrecond.new(jnp.asarray(np.abs(np.diag(dense)))),
                 tol=1e-7, max_iter=200)
        want = _nearest(w, sigma, 3)
    elif name == "si_prepartitioned":
        A = _spd_grid(16)
        dense = _dense(A)
        w = np.linalg.eigvalsh(dense)
        sigma = worker.between(w, 2, unique=True)
        out = si(partition_dia(A.to_dia(), world), 2, sigma, tol=1e-7, max_iter=200)
        want = _nearest(w, sigma, 2)
    elif name == "rf_dense":
        A = _spd_grid(24)
        dense = _dense(A)
        out = rf(A, 4, 2.0, tol=1e-8, seed=1)
        want = _nearest(np.linalg.eigvalsh(dense), 2.0, 4)
    elif name == "rf_refine":
        A = _spd_grid(24)
        dense = _dense(A)
        A32 = dataclasses.replace(A, data=np.asarray(A.data).astype(np.float32))
        out = rf(A32, 3, 2.0, tol=5e-5, inner_tol=1e-3, inner_max_iter=1500, inner_refine=2,
                 seed=1)
        want = _nearest(np.linalg.eigvalsh(dense), 2.0, 3)
    else:
        raise KeyError(name)
    lam, X, info = out
    return {"lam": np.asarray(lam), "X": np.asarray(X), "its": int(info.iterations),
            "status": int(info.status), "dense": dense, "want": want}


def run_eigen(caseset: str, world: int, out: str):
    """Start the ranks of an eigen case set, compute the JAX side of its
    cases meanwhile, then wait for the ranks. Returns ``(rank results,
    {case: jax_eigen_case})``."""
    from concurrent.futures import ThreadPoolExecutor

    write_draws(world, out)
    procs = worker.launch(caseset, world, out)
    names = [n for n in worker.CASESETS[caseset] if n in EIGEN_CASES]
    with ThreadPoolExecutor(4) as pool:
        refs = dict(zip(names, pool.map(lambda n: jax_eigen_case(n, world), names)))
    return worker.collect(procs, out, timeout=600), refs


EIGEN_CASES = {"lobpcg_ell", "lobpcg_dia", "lobpcg_largest", "lobpcg_jacobi", "lobpcg_pad",
               "si_both", "si_above", "si_below", "si_jacobi", "si_prepartitioned", "si_pad",
               "rf_dense", "rf_refine"}


def same_on_every_rank(results, name: str, world: int) -> dict:
    """Rank 0's result of case ``name``, after holding every rank's λ, X
    and info to rank 0's bits."""
    r0 = results[0][name]
    for r in range(world):
        rr = results[r][name]
        assert "error" not in rr, rr.get("error")
        assert rr["lam"].tobytes() == r0["lam"].tobytes(), f"rank {r} λ differs"
        assert rr["X"].tobytes() == r0["X"].tobytes(), f"rank {r} X differs"
        assert (rr["its"], rr["res"], rr["status"]) == (r0["its"], r0["res"], r0["status"])
    return r0


def check_eigen(run, name: str, world: int, lam_atol: float, res_max: float,
                orth_atol: float = 1e-8, lam_rtol: float = 1e-8):
    """The checks of an eigen case: every rank the same bits; CONVERGED (the
    JAX test's bar: on 2 devices the JAX package stops one-sided
    shift-invert above σ at INSUFFICIENT_ITER with the same λ, its measured
    residual just over tol); λ within ``lam_rtol`` (relative) of JAX's and within ``lam_atol`` of the
    dense eigenvalues; the largest residual ‖A·xᵢ − λᵢxᵢ‖/max(|λᵢ|, 1) on
    the dense A below ``res_max``; XᵀX = I within ``orth_atol``; the count
    equal to JAX's or within the band. Returns ``(its, JAX's its)``."""
    results, refs = run
    ref = refs[name]
    r0 = same_on_every_rank(results, name, world)
    assert r0["status"] == 0, (r0["status"], ref["status"])
    lam, X = r0["lam"].astype(np.float64), r0["X"].astype(np.float64)
    assert X.shape == ref["X"].shape and lam.shape == ref["want"].shape
    np.testing.assert_allclose(np.sort(lam), np.sort(ref["lam"]), rtol=lam_rtol, atol=0)
    np.testing.assert_allclose(np.sort(lam), ref["want"], rtol=0, atol=lam_atol)
    R = ref["dense"] @ X - X * lam[None, :]
    assert (np.linalg.norm(R, axis=0) / np.maximum(np.abs(lam), 1.0)).max() < res_max
    np.testing.assert_allclose(X.T @ X, np.eye(X.shape[1]), rtol=0, atol=orth_atol)
    assert abs(r0["its"] - ref["its"]) <= band(ref["its"]), (name, r0["its"], ref["its"])
    return r0["its"], ref["its"]


# --- the Krylov family's distributed cases -----------------------------------------
COLLECTIVES = ("psum", "ppermute", "all_gather")


def _has_collectives(levels: dict) -> bool:
    return any(sum(c.values()) for c in levels.values())


def _walk(jaxpr, path: tuple, out: dict, loops: list) -> None:
    """Add the collectives of ``jaxpr`` to ``out[path]``: a ``while`` whose
    body holds collectives becomes the level ``path + (i,)`` (i counts such
    loops at this level), a ``cond`` contributes the one branch that holds
    collectives (the other is the solvers' zero-rhs or converged-x0 early
    out), a ``scan`` must hold none, and any other sub-jaxpr (pjit, custom
    derivatives, the shard_map body, a Pallas kernel) counts at this level."""
    level = out.setdefault(path, dict.fromkeys(COLLECTIVES, 0))
    for eqn in jaxpr.eqns:
        prim = eqn.primitive.name
        if prim in COLLECTIVES:
            level[prim] += 1
        elif prim == "while":
            body = {}
            _walk(eqn.params["body_jaxpr"].jaxpr, (), body, [0])
            if _has_collectives(body):
                for p, c in body.items():
                    out[path + (loops[0],) + p] = c
                loops[0] += 1
        elif prim == "cond":
            taken = []
            for br in eqn.params["branches"]:
                probe = {}
                _walk(br.jaxpr, (), probe, [0])
                if _has_collectives(probe):
                    taken.append(br)
            assert len(taken) <= 1, "collectives in two branches of a cond"
            for br in taken:
                _walk(br.jaxpr, path, out, loops)
        elif prim == "scan":
            probe = {}
            _walk(eqn.params["jaxpr"].jaxpr, (), probe, [0])
            assert not _has_collectives(probe), "collectives in a scan body"
        else:
            for v in eqn.params.values():
                sub = getattr(v, "jaxpr", v)
                if hasattr(sub, "eqns"):
                    _walk(sub, path, out, loops)


def loop_collectives(mesh, solver, parts, b, M=None, **kw) -> dict:
    """``{level: {primitive: count}}`` of ``solver`` row-partitioned on
    ``mesh`` as ``distributed_solve`` runs it: the collectives the traced
    program performs at the top (level ``()``) and in each execution of
    every while loop's body (level ``(i,)``, a loop nested in it ``(i, j)``)."""
    from sprsolve_tpu.parallel.solve import make_solver_specs

    in_specs, out_specs = make_solver_specs(parts, M, "rows")
    if M is None:
        run = lambda A_, b_, x_: solver(A_, b_, x_, axis_name="rows", **kw)
        args = (parts, b, jnp.zeros_like(b))
    else:
        run = lambda A_, b_, x_, M_: solver(A_, b_, x_, M=M_, axis_name="rows", **kw)
        args = (parts, b, jnp.zeros_like(b), M)
    sharded = jax.shard_map(run, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                            check_vma=False)
    out = {}
    _walk(jax.make_jaxpr(sharded)(*args).jaxpr, (), out, [0])
    return {p: c for p, c in out.items() if sum(c.values()) or p == ()}


def _spd_dense_csr(side):
    return sp.csr_from_dense(-np.asarray(problems.sym_grid_laplacian((side, side))[0].todense()))


def _fgmres_inner_cg(Ad, b, x0, *, tol, max_iter, axis_name=None):
    M = sp.InnerSolvePrecond(Ad, method="cg", iters=worker.FGMRES_INNER, axis_name=axis_name)
    return sp.fgmres(Ad, b, x0, M=M, tol=tol, max_iter=max_iter,
                     restart=worker.FGMRES_RESTART, axis_name=axis_name)


def _krylov_problem(name: str, world: int) -> dict:
    """Case ``name`` as its JAX test builds it: the solver, the operator
    (host or already partitioned), the rhs, M, the solve's keywords, the
    CSR of the true residual and the test's gate on it."""
    from sprsolve_tpu.parallel import DistComplexPaddedDIA
    from sprsolve_tpu.solvers.cocg import cocg

    if name in ("block_cg_distributed", "block_cg_padded"):
        # block_cg_padded: the port on DistPaddedDIA, held to JAX's HaloDIA
        A = _spd_dense_csr(16)
        return dict(solver=sp.block_cg, op=A.to_dia(), rhs=np.random.default_rng(7)
                    .standard_normal((256, 4)), kw=dict(tol=1e-10, max_iter=600), A=A,
                    gate=1e-8)
    if name == "cg_single_sync_iteration_invariance":
        A = problems.poisson3d(12, 12, 12, dtype=np.float64)
        return dict(solver=sp.cg_single_sync, op=A.to_dia(),
                    rhs=np.random.default_rng(9).standard_normal(A.shape[0]),
                    kw=dict(tol=1e-10, max_iter=500), A=A, gate=1e-9)
    if name == "cocg_distributed":
        A, rhs, _ = problems.complex_symmetric_grid_with_diag((16, 16), dtype=np.complex64)
        op = DistComplexPaddedDIA.from_dia(A.to_dia(), world, lanes=128, block_rows=8)
        return dict(solver=cocg, op=op, rhs=rhs.astype(np.complex64), M=op.jacobi_precond(),
                    kw=dict(tol=1e-5, max_iter=500), A=A, gate=1e-4, planes=2)
    if name == "bicgstabl_distributed":
        A, rhs = _dirichlet((16, 16))
        return dict(solver=sp.bicgstabl, op=A.to_dia(), rhs=rhs,
                    kw=dict(tol=1e-11, max_iter=500), A=A, gate=1e-10)
    if name in ("cgs_distributed", "tfqmr_distributed"):
        A = problems.poisson3d(12, 12, 12, dtype=np.float64)
        return dict(solver=getattr(sp, name.split("_")[0]), op=A,
                    rhs=np.random.default_rng(13).standard_normal(A.shape[0]),
                    kw=dict(tol=1e-11, max_iter=1500), A=A, gate=None)
    if name == "ca_bicgstab_matches_serial":
        A = _spd_grid(32)
        return dict(solver=functools.partial(sp.ca_bicgstab, s=2, bounds=sp.gershgorin_bounds(A)),
                    op=A.to_dia(), rhs=np.random.default_rng(9).standard_normal(1024),
                    kw=dict(tol=1e-10, max_iter=2000), mpk_s=4, A=A, gate=1e-9)
    if name == "fgmres_with_inner_cg":
        A = _spd_dense_csr(16)
        return dict(solver=_fgmres_inner_cg, op=A.to_dia(),
                    rhs=np.random.default_rng(8).standard_normal(256),
                    kw=dict(tol=1e-9, max_iter=300), A=A, gate=1e-8)
    raise KeyError(name)


def jax_krylov_case(name: str, world: int) -> dict:
    """Case ``name`` through the JAX package's ``distributed_solve`` on a
    ``world``-device mesh: ``{"x", "its", "status", "loops", ...}`` with the
    problem's fields; ``loops`` is :func:`loop_collectives` of the same
    program, and CGS/TFQMR add ``x1``, the single-device solve their test
    holds the distributed x to."""
    from sprsolve_tpu.parallel import DistComplexPaddedDIA, partition_csr, partition_dia_mpk

    case = _krylov_problem(name, world)
    mesh = jax.make_mesh((world,), ("rows",), devices=jax.devices()[:world])
    M, rhs = case.get("M"), case["rhs"]
    x, info = distributed_solve(case["solver"], case["op"], jnp.asarray(rhs), M=M,
                                mesh=mesh, mpk_s=case.get("mpk_s"), **case["kw"])
    op = case["op"]
    if isinstance(op, DistComplexPaddedDIA):
        parts, b = op, op.pad_vec(jnp.zeros(rhs.shape, rhs.dtype))
    else:
        parts = (partition_csr(op, world, "rows") if isinstance(op, sp.CSR) else
                 partition_dia_mpk(op, world, case["mpk_s"], "rows") if "mpk_s" in case else
                 partition_dia(op, world, "rows"))
        b = jnp.zeros((parts.shape[0],) + rhs.shape[1:], rhs.dtype)
    case.update(x=np.asarray(x), its=int(info.iterations), status=int(info.status),
                loops=loop_collectives(mesh, case["solver"], parts, b, M, **case["kw"]))
    if name in ("cgs_distributed", "tfqmr_distributed"):
        x1, info1 = case["solver"](case["A"], jnp.asarray(rhs), **case["kw"])
        info1.raise_if_error()
        case["x1"] = np.asarray(x1)
    return case


def run_krylov(out: str):
    """Start the ranks of case set ``krylov`` (3: the cases run on subgroups
    of 1 and 2 of them, or all), compute the JAX side of every (case, ranks)
    meanwhile, then wait for the ranks. Returns ``(rank results, {(case,
    ranks): jax_krylov_case})``."""
    from concurrent.futures import ThreadPoolExecutor

    procs = worker.launch("krylov", 3, out)
    keys = [(n, s) for n, sizes in worker.KRYLOV_SIZES.items() for s in sizes]
    with ThreadPoolExecutor(4) as pool:
        refs = dict(zip(keys, pool.map(lambda k: jax_krylov_case(*k), keys)))
    return worker.collect(procs, out), refs


# the cases whose counts the two packages keep in step; COCG in c64 and
# CA-BiCGStab lie in the band (ROADMAP.md, "Counts that differ from JAX")
KRYLOV_IN_STEP = {"block_cg_distributed", "block_cg_padded",
                  "cg_single_sync_iteration_invariance", "bicgstabl_distributed",
                  "cgs_distributed", "tfqmr_distributed", "fgmres_with_inner_cg"}


def _port_units(loops: dict, planes: int) -> dict:
    """The JAX levels in the port's counters: a psum is one
    ``all_reduce_sum``, the 2·planes ppermutes of an SpMV's halo (each
    direction, each real plane) one ``halo_exchange``, an all_gather one
    ``all_gather_rows``."""
    per = 2 * planes
    out = {}
    for p, c in loops.items():
        assert c["ppermute"] % per == 0, (p, c)
        out[p] = {"all_reduce_sum": c["psum"], "halo_exchange": c["ppermute"] // per,
                  "all_gather_rows": c["all_gather"]}
    return out


def _executions(name: str, r0: dict, levels: dict) -> dict:
    """How often the port's run passed through each JAX level: the top once,
    the loop ``its`` times; CA-BiCGStab's anchor loop once per anchor and its
    block loop once per block; FGMRES's cycle loop once per restart cycle,
    its Arnoldi loop ``its`` times and the inner CG's loop FGMRES_INNER times
    an Arnoldi step."""
    its = r0["its"]
    if name == "ca_bicgstab_matches_serial":
        inner, outer = levels[(0, 0)], levels[(0,)]
        both = {k: inner[k] + outer[k] for k in inner}
        marks = r0["blocks"]
        deltas = [{k: b[k][0] - a[k][0] for k in inner} for a, b in zip(marks, marks[1:])]
        assert all(d in (inner, both) for d in deltas), (deltas, inner, outer)
        return {(): 1, (0,): 1 + deltas.count(both), (0, 0): len(marks)}
    if name == "fgmres_with_inner_cg":
        return {(): 1, (0,): -(-its // worker.FGMRES_RESTART), (0, 0): its,
                (0, 0, 0): worker.FGMRES_INNER * its}
    return {(): 1, (0,): its}


def check_krylov(run, name: str, size: int) -> dict:
    """The checks of a Krylov case on ``size`` ranks: every rank the same x
    bits, count, residual and status; CONVERGED as JAX; the JAX test's gate
    on the true residual (CGS/TFQMR: x within its rtol 1e-7, atol 1e-9 of
    the single-device x); the count equal to JAX's, x within 1e-10 of JAX's
    (``KRYLOV_IN_STEP``), or else within the band; and the port's collective
    counts equal to the JAX program's, level by level. Returns rank 0's
    result with the JAX side's under ``"jax"``."""
    results, refs = run
    ref = refs[name, size]
    r0 = results[0][name]
    assert "error" not in r0, r0.get("error")
    r0 = r0[size]
    for r in range(1, size):
        rr = results[r][name]
        assert "error" not in rr, rr.get("error")
        rr = rr[size]
        assert rr["x"].tobytes() == r0["x"].tobytes(), f"rank {r} x differs"
        assert (rr["its"], rr["res"], rr["status"]) == (r0["its"], r0["res"], r0["status"])
        calls = lambda c: {k: v[0] for k, v in c.items()}
        assert calls(rr["comm"]) == calls(r0["comm"]), (r, rr["comm"], r0["comm"])
    assert r0["status"] == ref["status"] == 0, (r0["status"], ref["status"])
    x = r0["x"]
    assert x.shape == ref["x"].shape and x.dtype == ref["x"].dtype, (x.shape, x.dtype)
    dense = np.asarray(ref["A"].todense())
    R = dense @ x.astype(dense.dtype) - ref["rhs"]
    axis = 0 if R.ndim == 2 else None
    res = np.linalg.norm(R, axis=axis) / np.linalg.norm(ref["rhs"], axis=axis)
    if ref["gate"] is None:
        np.testing.assert_allclose(x, ref["x1"], rtol=1e-7, atol=1e-9)
    else:
        assert np.all(res < ref["gate"]), (name, res)
    if name in KRYLOV_IN_STEP:
        assert r0["its"] == ref["its"], (name, size, r0["its"], ref["its"])
        err = np.linalg.norm(x - ref["x"]) / np.linalg.norm(ref["x"])
        assert err <= 1e-10, (name, size, err)
    else:
        assert abs(r0["its"] - ref["its"]) <= band(ref["its"]), (name, size, r0["its"],
                                                                 ref["its"])
    levels = _port_units(ref["loops"], ref.get("planes", 1))
    execs = _executions(name, r0, levels)
    assert set(execs) == set(levels), (name, sorted(levels))
    for prim in ("all_reduce_sum", "halo_exchange", "all_gather_rows"):
        want = sum(levels[p][prim] * k for p, k in execs.items()) + (prim == "all_gather_rows")
        assert r0["comm"][prim][0] == want, (name, size, prim, r0["comm"][prim][0], want)
    return dict(r0, jax=ref, levels=levels)
