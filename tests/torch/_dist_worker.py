"""One rank of the distributed cross tests, and the launcher that starts them.

    python tests/torch/_dist_worker.py CASESET RANK WORLD STORE OUT

joins a gloo group of WORLD ranks on the CPU through the ``file://`` store
STORE, runs every case of CASESET in order (each a function of this module
named in :data:`CASESETS`) and pickles ``{case: result}`` to
``OUT/rank{RANK}.pkl``; a case that raises records the exception's text.
It imports torch and the port, never JAX: the test files compute the JAX
package's side themselves. :func:`launch` starts the WORLD processes and
:func:`collect` waits for them and reads their results.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import functools
import importlib
import os
import pickle
import subprocess
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import sprsolve_tpu_torch as tsp  # noqa: E402
from sprsolve_tpu_torch import parallel as par  # noqa: E402
from sprsolve_tpu_torch.parallel import comm  # noqa: E402
from sprsolve_tpu_torch.utils import problems  # noqa: E402


# --- the problems, built as the JAX tests build them --------------------------
def dirichlet(shape):
    A = problems.grid_laplacian_dirichlet(shape)
    rhs = np.zeros(shape[0] * shape[1])
    problems.set_boundary_condition(rhs, shape, lambda r, c: float(r + c))
    return A, rhs


def spd_grid(side):
    A, _ = problems.sym_grid_laplacian((side, side))
    return dataclasses.replace(A, data=-A.data)


def complex_banded(side=16):
    A, rhs, diag = problems.complex_symmetric_grid_with_diag((side, side))
    return A, rhs, diag


def cg_system():
    A = spd_grid(16)
    return A, np.random.default_rng(7).standard_normal(256)


def poisson_rhs(n, seed):
    return np.random.default_rng(seed).standard_normal(n)


def mpk_system():
    A = spd_grid(32)
    return A, np.random.default_rng(9).standard_normal(1024)


# --- helpers -------------------------------------------------------------------
class Ctx:
    def __init__(self, rank, world, group, out):
        self.rank, self.world, self.group, self.out = rank, world, group, out


def solved(x, info, extra=None):
    out = {"x": x.cpu().numpy(), "its": int(info.iterations),
           "res": float(info.residual), "status": int(info.status)}
    out.update(extra or {})
    return out


def gather_body(op, v, group):
    """The global body rows of a padded-layout local vector."""
    return op.unpad_vec(comm.all_gather_rows(v, group))


def run_solve(ctx, solver, A, b, **kw):
    comm.reset_counts()
    x, info = par.distributed_solve(solver, A, b, device="cpu", group=ctx.group, **kw)
    return solved(x, info, {"comm": comm.counts()})


# --- solve cases -----------------------------------------------------------------
def bicgstab_ell(ctx):
    A, rhs = dirichlet((20, 20))
    return run_solve(ctx, tsp.bicgstab, A, rhs, tol=1e-15, max_iter=1500)


def bicgstab_dia(ctx):
    A, rhs = dirichlet((20, 20))
    return run_solve(ctx, tsp.bicgstab, A.to_dia(), rhs, tol=1e-15, max_iter=1500)


def padding_exact(ctx):
    A, rhs = dirichlet((9, 9))     # 81 rows: identity pad rows on 2 and 4 ranks
    return run_solve(ctx, tsp.bicgstab, A, rhs, tol=1e-15, max_iter=1500)


def minres_complex_precond(ctx):
    A, rhs, diag = problems.hermitian_grid_with_diag((8, 8))
    return run_solve(ctx, tsp.minres, A, rhs, M=tsp.DiagPrecond.new(diag), tol=1e-22,
                     max_iter=300)


def cs_minres_ell(ctx):
    A, rhs, _ = problems.complex_symmetric_grid_with_diag((8, 8))
    return run_solve(ctx, tsp.cs_minres, A, rhs, tol=1e-22, max_iter=300)


def masked_gs(ctx):
    A, rhs = dirichlet((20, 20))
    op = par.partition_dia(A.to_dia(), ctx.world)
    M = tsp.MaskedGSPrecond(A=op, diag=A.diagonal(),
                            masks=tsp.color_masks(tsp.greedy_color(A)), sweeps=1)
    return run_solve(ctx, tsp.bicgstab, op, rhs, M=M, tol=1e-14, max_iter=1500)


def cg_dia(ctx):
    A, b = cg_system()
    return run_solve(ctx, tsp.cg, A.to_dia(), b, tol=1e-12, max_iter=2000)


def gmres_dia(ctx):
    A, rhs = dirichlet((16, 16))
    return run_solve(ctx, functools.partial(tsp.gmres, restart=16), A.to_dia(), rhs,
                     tol=1e-12, max_iter=600)


def idrs_dia(ctx):
    # the JAX package's shadow block of this rank's rows, written by the test
    tidrs = importlib.import_module("sprsolve_tpu_torch.solvers.idrs")
    P = np.load(os.path.join(ctx.out, f"shadow_w{ctx.world}.npy"))
    tidrs._shadow_space = lambda n, s, dtype, device: torch.as_tensor(P).to(dtype).to(device)
    A, rhs = dirichlet((16, 16))
    return run_solve(ctx, tsp.idrs, A.to_dia(), rhs, tol=1e-12, max_iter=2000)


def complex_op(ctx):
    A, rhs, diag = complex_banded()
    return A, rhs, diag, par.DistComplexPaddedDIA.from_dia(A.to_dia(), ctx.world)


def complex_bicgstab(ctx):
    _, rhs, _, op = complex_op(ctx)
    return run_solve(ctx, tsp.bicgstab, op, rhs, M=op.jacobi_precond(), tol=1e-14,
                     max_iter=600)


def complex_flat_jacobi(ctx):
    _, rhs, diag, op = complex_op(ctx)
    M = tsp.ComplexDiagPrecond.new(torch.as_tensor(diag))
    return run_solve(ctx, tsp.bicgstab, op, rhs, M=M, tol=1e-14, max_iter=600)


def complex_cs_minres(ctx):
    _, rhs, _, op = complex_op(ctx)
    return run_solve(ctx, tsp.cs_minres, op, rhs, M=op.abs_jacobi_precond(), tol=1e-14,
                     max_iter=600)


def padded_bicgstab(ctx):
    A = problems.poisson3d(10, 10, 10, dtype=np.float64)
    dia = A.to_dia()
    op = par.DistPaddedDIA.from_dia(dia, ctx.world)
    return run_solve(ctx, tsp.bicgstab, op, poisson_rhs(1000, 1),
                     M=tsp.DiagPrecond.new(dia.diagonal()), tol=1e-12, max_iter=500)


def padded_minres(ctx):
    A = problems.poisson3d(10, 10, 10, dtype=np.float64)
    op = par.DistPaddedDIA.from_dia(A.to_dia(), ctx.world)
    return run_solve(ctx, tsp.minres, op, poisson_rhs(1000, 3), tol=1e-10, max_iter=400)


def ca_cg_mpk(ctx):
    A, b = mpk_system()
    bounds = tsp.gershgorin_bounds(A)
    return run_solve(ctx, functools.partial(tsp.ca_cg, s=4, bounds=bounds), A.to_dia(), b,
                     tol=1e-10, max_iter=2000, mpk_s=4)


COUNT_SEEDS = {"float64": (0,), "float32": (0, 1, 2, 3)}


def counts_across_world_sizes(ctx):
    """Jacobi-BiCGStab on the 16³ Poisson (tol 1e-5) on 1, 2 and 4 ranks:
    the first 1 and 2 ranks of the group, then all 4; f64 with the rhs of
    seed 0, f32 with those of :data:`COUNT_SEEDS`. ``{(dtype, seed, ranks):
    solved}``."""
    out = {}
    subs = {1: dist.new_group([0]), 2: dist.new_group([0, 1]), ctx.world: ctx.group}
    for dt in (np.float64, np.float32):
        A = problems.poisson3d(16, 16, 16, dtype=dt)
        dia = A.to_dia()
        M = tsp.DiagPrecond.new(dia.diagonal())
        for seed in COUNT_SEEDS[np.dtype(dt).name]:
            rhs = np.random.default_rng(seed).standard_normal(A.shape[0]).astype(dt)
            for size, sub in subs.items():
                if ctx.rank < size:
                    x, info = par.distributed_solve(tsp.bicgstab, dia, rhs, M=M, tol=1e-5,
                                                    max_iter=300, group=sub, device="cpu")
                    out[np.dtype(dt).name, seed, size] = solved(x, info)
    return out


# --- operator cases (world 4) --------------------------------------------------
def local_vec(v, ctx):
    """This rank's block of a global host vector."""
    return par.multihost.host_to_global(v, ctx.group)


def spmv_rows(ctx):
    """Rows of every distributed operator's matvec and matmat against the
    single-rank operator's, bitwise (f64, c128)."""
    g, out = ctx.group, {}
    A, _ = dirichlet((16, 16))
    rng = np.random.default_rng(0)
    x = rng.standard_normal(256)
    X = rng.standard_normal((256, 3))
    dia, ell = A.to_dia(), A.to_ell()
    ops = {"halo": (par.partition_dia(dia, ctx.world), dia),
           "mpk": (par.partition_dia_mpk(dia, ctx.world, 2), dia),
           "ell": (par.partition_csr(A, ctx.world), ell)}
    for name, (parts, single) in ops.items():
        op = par.local_part(parts, parts.pspec(), g)
        y = comm.all_gather_rows(op.matvec(local_vec(x, ctx)), g)
        Y = comm.all_gather_rows(op.matmat(local_vec(X, ctx)), g)
        want_Y = (torch.stack([single.matvec(torch.as_tensor(X[:, j])) for j in range(3)], 1)
                  if name == "ell" else single.matmat(torch.as_tensor(X)))
        out[name] = (torch.equal(y, single.matvec(torch.as_tensor(x))),
                     torch.equal(Y, want_Y),
                     float((y - A.matvec(torch.as_tensor(x))).abs().max()))
    P = problems.poisson3d(12, 12, 12, dtype=np.float64)
    pdia = P.to_dia()
    xp = np.random.default_rng(1).standard_normal(P.shape[0])
    dist_op = par.DistPaddedDIA.from_dia(pdia, ctx.world)
    single = tsp.PaddedDIA.from_dia(pdia, device="cpu")
    op = par.local_part(dist_op, dist_op.pspec(), g)
    v = local_vec(dist_op.pad_vec(torch.as_tensor(xp)), ctx)
    y = gather_body(dist_op, op.matvec(v), g)
    out["padded"] = (torch.equal(y, single.unpad_vec(single.matvec(single.pad_vec(
        torch.as_tensor(xp))))), dist_op.h, dist_op.r_local)
    C, _, _ = complex_banded()
    cdia = C.to_dia()
    xc = rng.standard_normal(256) + 1j * rng.standard_normal(256)
    cdist = par.DistComplexPaddedDIA.from_dia(cdia, ctx.world)
    csingle = tsp.ComplexPaddedDIA.from_dia(cdia, device="cpu")
    cop = par.local_part(cdist, cdist.pspec(), g)
    yc = gather_body(cdist, cop.matvec(local_vec(cdist.pad_vec(torch.as_tensor(xc)),
                                                  ctx)), g)
    out["complex_padded"] = torch.equal(
        yc, csingle.unpad_vec(csingle.matvec(csingle.pad_vec(torch.as_tensor(xc)))))
    return out


def fused_partials(ctx):
    """K2, K3, K4 (f64) and K6, K7 (c128) partials summed over the ranks,
    against the single-rank operator's dots; and the halos after each call."""
    g, out = ctx.group, {}
    P = problems.poisson3d(12, 12, 12, dtype=np.float64)
    pdia = P.to_dia()
    rng = np.random.default_rng(2)
    xs = [torch.as_tensor(rng.standard_normal(P.shape[0])) for _ in range(3)]
    dist_op = par.DistPaddedDIA.from_dia(pdia, ctx.world)
    single = tsp.PaddedDIA.from_dia(pdia, device="cpu")
    op = par.local_part(dist_op, dist_op.pspec(), g)
    loc = [local_vec(dist_op.pad_vec(v), ctx) for v in xs]
    pad = [single.pad_vec(v) for v in xs]
    S = lambda t: float(comm.all_reduce_sum(t, g))
    halo_zero = lambda v: not bool(v[: op.h].any() or v[op.h + op.r_local:].any())
    y, d = op.matvec_dot(loc[0])
    ys, ds = single.matvec_dot(pad[0])
    out["K3"] = (S(d), float(ds), halo_zero(y) and halo_zero(loc[0]))
    y, wd, yd = op.matvec_wdot(loc[0], loc[1])
    _, wds, yds = single.matvec_wdot(pad[0], pad[1])
    out["K2"] = (S(wd), float(wds), S(yd), float(yds), halo_zero(y))
    _, wd, _ = op.matvec_wdot(loc[0], loc[0])
    _, wds, _ = single.matvec_wdot(pad[0], pad[0])
    out["K2_w_is_x"] = (S(wd), float(wds))
    vn, sq = op.orth_norm(loc[0], loc[1], loc[2], 0.7, -1.3)
    _, sqs = single.orth_norm(pad[0], pad[1], pad[2], 0.7, -1.3)
    out["K4"] = (S(sq), float(sqs), halo_zero(vn))
    # the halo stays zero in the solver vectors: dots of the SpMV's input
    # after a matvec (a neighbour's entries left in x's halo would count)
    y = op.matvec(loc[0])
    ys = single.matvec(pad[0])
    out["dot_after_matvec"] = (float(tsp.vecalg.conj_dot(loc[0], y, g)),
                               float(tsp.vecalg.conj_dot(pad[0], ys)))
    out["norm_after_matvec"] = (float(tsp.vecalg.norm2_sq(loc[0], g)),
                                float(tsp.vecalg.norm2_sq(pad[0])))

    C, _, _ = complex_banded()
    cdia = C.to_dia()
    zs = [torch.as_tensor(rng.standard_normal(256) + 1j * rng.standard_normal(256))
          for _ in range(2)]
    cdist = par.DistComplexPaddedDIA.from_dia(cdia, ctx.world)
    csingle = tsp.ComplexPaddedDIA.from_dia(cdia, device="cpu")
    cop = par.local_part(cdist, cdist.pspec(), g)
    cl = [local_vec(cdist.pad_vec(v), ctx) for v in zs]
    cp = [csingle.pad_vec(v) for v in zs]
    C_ = lambda t: complex(comm.all_reduce_sum(t, g))
    out["K6"] = (C_(cop.matvec_dot(cl[0])[1]), complex(csingle.matvec_dot(cp[0])[1]))
    out["K6_conj"] = (C_(cop.matvec_conj_dot(cl[0])[1]),
                      complex(csingle.matvec_conj_dot(cp[0])[1]))
    _, wd, yd = cop.matvec_wdot(cl[0], cl[1])
    _, wds, yds = csingle.matvec_wdot(cp[0], cp[1])
    out["K7"] = (C_(wd), complex(wds), C_(yd), complex(yds))
    _, wd, _ = cop.matvec_wdot(cl[0], cl[0])
    _, wds, _ = csingle.matvec_wdot(cp[0], cp[0])
    out["K7_w_is_x"] = (C_(wd), complex(wds))
    return out


def comm_per_iteration(ctx):
    """The counters over one Jacobi-BiCGStab solve on each layout."""
    P = problems.poisson3d(12, 12, 12, dtype=np.float64)
    pdia = P.to_dia()
    b = poisson_rhs(P.shape[0], 4)
    M = tsp.DiagPrecond.new(pdia.diagonal())
    out = {}
    dist_op = par.DistPaddedDIA.from_dia(pdia, ctx.world)
    for name, A in (("padded", dist_op), ("halo", pdia), ("ell", P)):
        out[name] = run_solve(ctx, tsp.bicgstab, A, b, M=M, tol=1e-10, max_iter=500)
    out["h"] = dist_op.h
    return out


def ca_cg_exchanges(ctx):
    """ca_cg on MPKDIA: the halo exchanges each s-step block makes."""
    tcacg = importlib.import_module("sprsolve_tpu_torch.solvers.ca_cg")
    per_block, inner = [], tcacg.basis_block

    def counted(*a, **k):
        before = comm.halo_exchange.calls
        V = inner(*a, **k)
        per_block.append(comm.halo_exchange.calls - before)
        return V

    tcacg.basis_block = counted
    try:
        out = ca_cg_mpk(ctx)
    finally:
        tcacg.basis_block = inner
    out["per_block"] = per_block
    return out


def refusals(ctx):
    """What a rank refuses: the default device where there is no CUDA, an
    s beyond the matrix-powers depth."""
    out = {}
    A, rhs = dirichlet((16, 16))
    try:
        par.distributed_solve(tsp.bicgstab, A.to_dia(), rhs, tol=1e-8, max_iter=10,
                              group=ctx.group)
        out["no_device"] = "no error"
    except RuntimeError as e:
        out["no_device"] = str(e)
    mpk = par.partition_dia_mpk(spd_grid(32).to_dia(), ctx.world, 2)
    try:
        par.distributed_solve(functools.partial(tsp.ca_cg, s=3), mpk, np.ones(1024),
                              tol=1e-6, max_iter=10, group=ctx.group, device="cpu")
        out["mpk_depth"] = "no error"
    except ValueError as e:
        out["mpk_depth"] = str(e)
    return out


# --- eigen cases (the distributed eigensolvers) ------------------------------------
def dense_of(A):
    """The dense form of a host CSR."""
    import scipy.sparse as sps

    return sps.csr_matrix((A.data.numpy(), A.indices.numpy(), A.indptr.numpy()),
                          shape=A.shape).toarray()


def ramp_grid(side, lo, span):
    """The SPD grid plus a diagonal ramp lo + span·i/n, as a DIA."""
    dense = dense_of(spd_grid(side))
    n = dense.shape[0]
    dense = dense + np.diag(lo + span * np.arange(n) / n)
    return tsp.csr_from_dense(dense).to_dia(), dense


def between(w, i, unique=False):
    """σ halfway between two eigenvalues of w (of its distinct values, rounded
    to 8 digits, with ``unique``), as the JAX tests pick it."""
    if unique:
        w = np.unique(np.round(w, 8))
    return float(0.5 * (w[i] + w[i + 1]))


def jax_draws(ctx):
    """The port's LOBPCG refills with the JAX package's per-shard draws
    (``fold_in(key, axis_index)``) patched in, which the test wrote for this
    rank: ``{"ROWSxK": (1 + 2·T, rows, k)}``, index 0 the tag (0, rank),
    2i − 1 and 2i the tags (i, 17, rank) and (i, 29, rank). Returns the
    original, to be put back."""
    tlob = importlib.import_module("sprsolve_tpu_torch.solvers.lobpcg")
    with np.load(os.path.join(ctx.out, f"draws_w{ctx.world}_r{ctx.rank}.npz")) as f:
        tables = {key: f[key] for key in f.files}

    def fresh(tag, shape, dtype, device):
        assert tag[-1] == ctx.rank, tag
        i = 0 if len(tag) == 2 else 2 * tag[0] - (tag[1] == 17)
        return torch.as_tensor(tables[f"{shape[0]}x{shape[1]}"][i]).to(dtype).to(device)

    orig, tlob._fresh_directions = tlob._fresh_directions, fresh
    return orig


def eig_out(lam, X, info, extra=None):
    out = {"lam": lam.cpu().numpy(), "X": X.cpu().numpy(), "its": int(info.iterations),
           "res": float(info.residual), "status": int(info.status)}
    out.update(extra or {})
    return out


def run_eig(ctx, driver, *args, **kw):
    """One driver call with the JAX draws, and the counters over it."""
    tlob = importlib.import_module("sprsolve_tpu_torch.solvers.lobpcg")
    orig = jax_draws(ctx)
    comm.reset_counts()
    try:
        out = driver(*args, group=ctx.group, device="cpu", **kw)
    finally:
        tlob._fresh_directions = orig
    return eig_out(*out, {"comm": comm.counts()})


def eig_matmat(ctx):
    """HaloDIA.matmat and AllGatherELL.matmat on 5 columns against the dense
    product, gathered: the largest absolute error of each."""
    A = spd_grid(16)
    X = np.random.default_rng(1).standard_normal((256, 5))
    want = dense_of(A) @ X
    out = {}
    for name, parts in (("ell", par.partition_csr(A, ctx.world)),
                        ("dia", par.partition_dia(A.to_dia(), ctx.world))):
        op = par.local_part(parts, parts.pspec(), ctx.group)
        Y = comm.all_gather_rows(op.matmat(local_vec(X, ctx)), ctx.group)
        out[name] = float(np.abs(Y.numpy() - want).max())
    return out


def lobpcg_ell(ctx):
    return run_eig(ctx, par.distributed_lobpcg, spd_grid(16), 4, tol=1e-9, max_iter=400)


def lobpcg_dia(ctx):
    return run_eig(ctx, par.distributed_lobpcg, spd_grid(16).to_dia(), 4, tol=1e-9,
                   max_iter=400)


def lobpcg_largest(ctx):
    return run_eig(ctx, par.distributed_lobpcg, spd_grid(12), 3, largest=True, tol=1e-9,
                   max_iter=400)


def lobpcg_jacobi(ctx):
    A, dense = ramp_grid(12, 1.0, 9.0)
    return run_eig(ctx, par.distributed_lobpcg, A, 3, M=tsp.DiagPrecond.new(np.diag(dense)),
                   tol=1e-9, max_iter=400)


def lobpcg_pad(ctx):
    return run_eig(ctx, par.distributed_lobpcg, spd_grid(10), 4, tol=1e-9, max_iter=400)


def si_both(ctx):
    A = spd_grid(16)
    sigma = between(np.linalg.eigvalsh(dense_of(A)), 5)
    return run_eig(ctx, par.distributed_shift_invert_eigs, A, 4, sigma, tol=1e-7,
                   max_iter=200)


def si_side(ctx, side):
    A = spd_grid(12)
    sigma = between(np.linalg.eigvalsh(dense_of(A)), 3, unique=True)
    return run_eig(ctx, par.distributed_shift_invert_eigs, A, 3, sigma, side=side, tol=1e-7,
                   max_iter=200)


def si_above(ctx):
    return si_side(ctx, "above")


def si_below(ctx):
    return si_side(ctx, "below")


def si_jacobi(ctx):
    A, dense = ramp_grid(12, 2.0, 10.0)
    sigma = between(np.linalg.eigvalsh(dense), 3)
    return run_eig(ctx, par.distributed_shift_invert_eigs, A, 3, sigma,
                   M_inner=tsp.DiagPrecond.new(np.abs(np.diag(dense))), tol=1e-7,
                   max_iter=200)


def si_prepartitioned(ctx):
    A = spd_grid(16)
    sigma = between(np.linalg.eigvalsh(dense_of(A)), 2, unique=True)
    return run_eig(ctx, par.distributed_shift_invert_eigs,
                   par.partition_dia(A.to_dia(), ctx.world), 2, sigma, tol=1e-7, max_iter=200)


def si_pad(ctx):
    return run_eig(ctx, par.distributed_shift_invert_eigs, spd_grid(10), 4, 1.0, tol=1e-7,
                   max_iter=300)


def rf_dense(ctx):
    return run_eig(ctx, par.distributed_rational_filter_eigs, spd_grid(24), 4, 2.0, tol=1e-8,
                   seed=1)


def rf_refine(ctx):
    A = spd_grid(24)
    A32 = dataclasses.replace(A, data=A.data.to(torch.float32))
    return run_eig(ctx, par.distributed_rational_filter_eigs, A32, 3, 2.0, tol=5e-5,
                   inner_tol=1e-3, inner_max_iter=1500, inner_refine=2, seed=1)


def rf_complex(ctx):
    """The refusal of a complex operator: the exception's type name."""
    A, _, _ = problems.complex_symmetric_grid_with_diag((8, 8))
    try:
        par.distributed_rational_filter_eigs(A, 2, 1.0, group=ctx.group, device="cpu")
    except Exception as e:  # the test names the types it accepts
        return {"raised": type(e).__name__}
    return {"raised": None}


def rf_radius(ctx):
    """``max_iter=1`` from r₀ = 1e-3 of the Gershgorin width on the 24×24
    grid at σ = 1: the kept pass and the result (the port's single-device
    ``test_final_filter_uses_the_radius_of_the_kept_pairs`` on ranks)."""
    trat = importlib.import_module("sprsolve_tpu_torch.solvers.rational")
    passes, inner = [], trat._subspace_iterations

    def kept(*a, **k):
        out = inner(*a, **k)
        passes.append((out[0], out[1], out[3]))
        return out

    trat._subspace_iterations = kept
    try:
        out = run_eig(ctx, par.distributed_rational_filter_eigs, spd_grid(24), 4, 1.0,
                      tol=1e-8, seed=1, max_iter=1)
    finally:
        trat._subspace_iterations = inner
    out["pass"] = passes
    return out


def eig_counts(ctx):
    """The collectives of a few budget-bound steps of each driver on the
    16×16 grid (DIA), for k = 2 and 4, with the lockstep iterations of every
    inner solve: ``{(driver, k): {"its", "steps", "comm"}}``."""
    teigs = importlib.import_module("sprsolve_tpu_torch.solvers.eigs")
    trat = importlib.import_module("sprsolve_tpu_torch.solvers.rational")
    A = spd_grid(16).to_dia()
    out = {}
    for k in (2, 4):
        runs = {
            "lobpcg": lambda: par.distributed_lobpcg(A, k, tol=1e-14, max_iter=5,
                                                     group=ctx.group, device="cpu"),
            "shift_invert": lambda: par.distributed_shift_invert_eigs(
                A, k, 1.0, tol=1e-14, max_iter=2, inner_max_iter=7, group=ctx.group,
                device="cpu"),
            "rational": lambda: par.distributed_rational_filter_eigs(
                A, k, 2.0, m0=k + 2, n_quad=2, radius=0.5, tol=1e-14, max_iter=2,
                inner_max_iter=6, group=ctx.group, device="cpu"),
        }
        for name, run in runs.items():
            steps = []
            mod, fn = (teigs, "_minres_block") if name == "shift_invert" else (trat, "_cocg_block")
            orig = getattr(mod, fn)

            def rec(*a, _orig=orig, **kw):
                X, info, n = _orig(*a, **kw)
                steps.append(n)
                return X, info, n

            setattr(mod, fn, rec)
            comm.reset_counts()
            try:
                _, _, info = run()
            finally:
                setattr(mod, fn, orig)
            out[name, k] = {"its": int(info.iterations), "steps": steps, "comm": comm.counts()}
    return out


CASESETS = {
    "solve": ["bicgstab_ell", "bicgstab_dia", "padding_exact", "minres_complex_precond",
              "cs_minres_ell", "masked_gs", "cg_dia", "gmres_dia", "idrs_dia",
              "complex_bicgstab", "complex_flat_jacobi", "complex_cs_minres",
              "padded_bicgstab", "padded_minres", "ca_cg_mpk"],
    "solve4": ["bicgstab_ell", "bicgstab_dia", "padding_exact", "minres_complex_precond",
               "cs_minres_ell", "cg_dia", "complex_bicgstab", "complex_flat_jacobi",
               "padded_bicgstab", "ca_cg_mpk", "counts_across_world_sizes"],
    "ops": ["spmv_rows", "fused_partials", "comm_per_iteration", "ca_cg_exchanges",
            "refusals"],
    "eigen": ["eig_matmat", "lobpcg_ell", "lobpcg_dia", "lobpcg_largest", "lobpcg_jacobi",
              "si_both", "si_above", "si_below", "si_jacobi", "si_prepartitioned", "rf_dense",
              "rf_refine", "rf_complex"],
    "eigen3": ["lobpcg_pad", "si_pad", "eig_counts", "rf_radius"],
}


def main(argv):
    caseset, rank, world, store, out = argv[1], int(argv[2]), int(argv[3]), argv[4], argv[5]
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    ctx = Ctx(rank, world, dist.group.WORLD, out)
    results = {}
    try:
        for name in CASESETS[caseset]:
            try:
                results[name] = globals()[name](ctx)
            except Exception:   # recorded; the test names the case
                results[name] = {"error": traceback.format_exc()}
    finally:
        with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
        dist.destroy_process_group()
    return 0


# --- the launcher (test side) ----------------------------------------------------
@contextlib.contextmanager
def one_rank_group(tmp: str):
    """A gloo group of this process alone (a ``file://`` store in ``tmp``),
    destroyed on exit: the group-of-one form of a distributed solve, in the
    test process itself."""
    dist.init_process_group("gloo", init_method="file://" + os.path.join(tmp, "store"),
                            rank=0, world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()



def launch(caseset: str, world: int, out: str):
    """Start WORLD ranks of ``caseset`` writing into ``out``; returns the
    processes (:func:`collect` waits for them)."""
    store = os.path.join(out, "store")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="2")
    return [subprocess.Popen([sys.executable, os.path.abspath(__file__), caseset, str(r),
                              str(world), store, out],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                             cwd=REPO, env=env)
            for r in range(world)]


def collect(procs, out: str, timeout: float = 300):
    """Wait for the ranks; returns ``[results of rank 0, ...]``. A rank that
    fails or outlasts ``timeout`` fails the caller with its output."""
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"rank {r} exited {p.returncode}:\n{log}")
    results = []
    for r in range(len(procs)):
        with open(os.path.join(out, f"rank{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


if __name__ == "__main__":
    sys.exit(main(sys.argv))
