"""Drive the PyTorch/CUDA port's main path once on one GPU, and check it.

    python3 chip_smoke.py

Phases, each printing one line of its own:

1. device  — requires CUDA (no CPU fallback); prints the card's name and
   power limit as nvidia-smi reports them.
2. build   — builds the CUDA kernels from ``sprsolve_tpu_torch/csrc`` with
   nvcc (one per source, in parallel); prints the build seconds.
3. kernels — K1 (dia_spmv), K2 (dia_wdot, in all four variants) and K3
   (dia_dot) against their plain PyTorch versions on the card, on the 100³
   Poisson (int8 bands), a random band set that does not narrow, a
   bf16-exact set and an f64 set; narrow band storage must give bitwise the
   output of the same values stored f32.  K4 (orth_norm) against its plain
   version on f32 and f64 vectors of the same layout, with β and α as 0-d
   CUDA tensors.  Prints median times and nnz/s.
4. slice   — ``solve(A, b, method="bicgstab", M="jacobi")`` on the 100³
   Poisson in f32, with the launch counters reset just before: it must
   converge, reach a true relative residual (f64, scipy) below 1e-3, launch
   K1 at least once and K2 twice per iteration. Then the same through
   ``prepare`` (median of 3 timed solves).
5. f64     — BiCGStab on the padded-DIA kernels in f64 on the reference's
   100×100 Dirichlet grid, tol 1e-16.
6. symmetric — the symmetric slice on the same f32 Poisson and rhs, each
   solve with the launch counters reset just before: MINRES (K1 once, K3
   and K4 iterations + 1 times each, K2 never), CG with Jacobi (K3
   iterations times, K4 never) and ``method="auto"`` (routes to MINRES: K4
   launches); all converge to a true residual below 1e-3.  Then MINRES and
   CG through ``prepare`` (median of 3 timed solves), and the same solves
   through an operator that calls the plain versions on the card.
7. f64 symmetric — MINRES and CG on the f64 kernels, 100×100 folded grid
   Laplacian (negative definite): MINRES converges, CG ends in BREAKDOWN,
   and CG on the negated matrix converges; true residuals below 1e-9.
8. nonsymmetric — ``method="auto"`` with Jacobi on the 100³
   convection-diffusion operator (Péclet 20, f32) routes to BiCGStab(ℓ=2):
   it converges, and K2 launches 4 times per cycle.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Any failure raises, and the
script exits non-zero.  It imports no JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import sprsolve_tpu_torch as spt
from sprsolve_tpu_torch.ops import _cuda_build, fused
from sprsolve_tpu_torch.ops import padded_dia as pd
from sprsolve_tpu_torch.sparse.containers import DIA
from sprsolve_tpu_torch.utils import problems

SEED = 0
GRID = 100          # the 100³ Poisson: 1,000,000 rows, 6,940,000 nnz
KERNELS = {   # name → (source, the TPU kernel it replaces)
    "dia_spmv": ("sprsolve_tpu_torch/csrc/dia_spmv.cu", "sprsolve_tpu/ops/pallas_spmv.py:131"),
    "dia_wdot": ("sprsolve_tpu_torch/csrc/dia_spmv.cu", "sprsolve_tpu/ops/pallas_spmv.py:159"),
    "dia_dot": ("sprsolve_tpu_torch/csrc/dia_spmv.cu", "sprsolve_tpu/ops/pallas_spmv.py:140"),
    "orth_norm": ("sprsolve_tpu_torch/csrc/fused.cu", "sprsolve_tpu/ops/pallas_fused.py:37"),
}
# tolerances of kernel against plain version, by vector dtype:
#  y:        rtol of the row's |A|·|x| — the kernel fuses each multiply-add
#            into an FMA, the plain version may not;
#  partials: rtol of Σ|w·y| — the block tree sums in another order than
#            torch.sum;
#  K4's v₊:  Y_RTOL of |a| + |β||v_old| + |α||v| per entry — the kernel
#            fuses the two multiply-subtracts, the plain version does not.
Y_RTOL = {torch.float32: 1e-6, torch.float64: 1e-13}
DOT_RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def median_ms(fn, reps: int = 5, inner: int = 20) -> float:
    """Median over ``reps`` of the mean time of ``inner`` back-to-back calls,
    by CUDA events, after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def band_sets(dev):
    """(name, PaddedDIA, nnz) for the four band sets of phase 3."""
    rng = np.random.default_rng(SEED)
    A = problems.poisson3d(GRID, GRID, GRID)
    dia = DIA.from_csr(A, device="cpu")
    sets = [("poisson100_int8", spt.PaddedDIA.from_dia(dia, device=dev), A.nnz)]
    mask = (dia.bands != 0).numpy()
    rand = np.where(mask, rng.uniform(0.5, 1.5, dia.bands.shape), 0.0)
    for name, vals, dtype in (
        ("random_f32", rand, np.float32),
        ("bf16exact_f32", dia.bands.numpy() * 2.5, np.float32),
        ("random_f64", rand, np.float64),
    ):
        d = DIA(bands=torch.as_tensor(vals.astype(dtype)), offsets=dia.offsets,
                shape=dia.shape)
        sets.append((name, spt.PaddedDIA.from_dia(d, device=dev), A.nnz))
    expect = {"poisson100_int8": torch.int8, "random_f32": torch.float32,
              "bf16exact_f32": torch.bfloat16, "random_f64": torch.float64}
    for name, op, _ in sets:
        assert op.bands.dtype == expect[name], (name, op.bands.dtype)
    return sets


def launch_counts() -> dict:
    return {"dia_spmv": pd.dia_spmv.launches, "dia_wdot": pd.dia_wdot.launches,
            "dia_dot": pd.dia_dot.launches, "orth_norm": fused.orth_norm.launches}


def check_halo(name, op, v):
    """The halo and the tail of a padded output must be exactly zero."""
    if bool(v[: op.h].any()) or bool(v[op.h + op.n:].any()):
        raise AssertionError(f"{name}: nonzero halo or tail")


def dirty(like):
    """Free a NaN-filled block of ``like``'s size, so that the next
    ``torch.empty_like`` (a kernel's output) likely reuses it: a halo the
    kernel forgot to clear then shows."""
    junk = torch.full_like(like, float("nan"))
    del junk


def check_close(name, got, want, scale, rtol):
    err = float((got - want).abs().max())
    bound = rtol * float(scale)
    if not err <= bound:
        raise AssertionError(f"{name}: max |kernel - plain| {err:.3e} > {bound:.3e}")
    return err


def phase_kernels(dev):
    """Phase 3: every kernel and variant against its plain version."""
    rng = np.random.default_rng(SEED + 1)
    errs = dict.fromkeys(KERNELS, 0.0)
    times = {}
    for name, op, nnz in band_sets(dev):
        dt = op.vdtype
        mk = lambda: op.pad_vec(torch.as_tensor(rng.standard_normal(op.n), dtype=dt,
                                                device=dev))
        x, w = mk(), mk()
        dinv = op.jacobi_precond().diag_inv
        absb = op.bands.to(dt).abs()
        # K1
        y = pd.dia_spmv(op.bands, x, op.offsets, op.h)
        y_ref = pd.dia_spmv_plain(op.bands, x, op.offsets, op.h)
        scale = pd.dia_spmv_plain(absb, x.abs(), op.offsets, op.h).max()
        e = check_close(f"{name} K1 y", y, y_ref, scale, Y_RTOL[dt])
        errs["dia_spmv"] = max(errs["dia_spmv"], e)
        if op.bands.dtype in (torch.int8, torch.bfloat16):
            wide = op.bands.to(torch.float32)
            y_wide = pd.dia_spmv(wide, x, op.offsets, op.h)
            if not torch.equal(y, y_wide):
                raise AssertionError(f"{name}: narrow and f32 bands differ (K1)")
        # K2, four variants
        for wv in (w, None):
            for dv in (None, dinv):
                tag = f"{name} K2 w_is_x={wv is None} has_dinv={dv is not None}"
                y, wd, yd = pd.dia_wdot(op.bands, x, wv, dv, op.offsets, op.h)
                y_r, wd_r, yd_r = pd.dia_wdot_plain(op.bands, x, wv, dv, op.offsets, op.h)
                u = x if dv is None else x * dv
                scale = pd.dia_spmv_plain(absb, u.abs(), op.offsets, op.h).max()
                e = check_close(tag + " y", y, y_r, scale, Y_RTOL[dt])
                errs["dia_wdot"] = max(errs["dia_wdot"], e)
                wsrc = x if wv is None else wv
                check_close(tag + " wy", wd, wd_r, (wsrc * y_r).abs().sum(), DOT_RTOL[dt])
                check_close(tag + " yy", yd, yd_r, yd_r, DOT_RTOL[dt])
                if op.bands.dtype in (torch.int8, torch.bfloat16):
                    yw, wdw, ydw = pd.dia_wdot(op.bands.to(torch.float32), x, wv, dv,
                                               op.offsets, op.h)
                    if not (torch.equal(y, yw) and torch.equal(wd, wdw)
                            and torch.equal(yd, ydw)):
                        raise AssertionError(f"{tag}: narrow and f32 bands differ")
        # K3
        dirty(x)
        y, d = pd.dia_dot(op.bands, x, op.offsets, op.h)
        y_r, d_r = pd.dia_dot_plain(op.bands, x, op.offsets, op.h)
        scale = pd.dia_spmv_plain(absb, x.abs(), op.offsets, op.h).max()
        e = check_close(f"{name} K3 y", y, y_r, scale, Y_RTOL[dt])
        errs["dia_dot"] = max(errs["dia_dot"], e)
        check_close(f"{name} K3 xy", d, d_r, (x * y_r).abs().sum(), DOT_RTOL[dt])
        check_halo(f"{name} K3 y", op, y)
        if op.bands.dtype in (torch.int8, torch.bfloat16):
            yw, dw = pd.dia_dot(op.bands.to(torch.float32), x, op.offsets, op.h)
            if not (torch.equal(y, yw) and torch.equal(d, dw)):
                raise AssertionError(f"{name}: narrow and f32 bands differ (K3)")
        torch.cuda.synchronize()
        # timings at the main path's shapes: K2 as BiCGStab's second SpMV
        # (Jacobi fold, w = x)
        t = {
            "dia_spmv": median_ms(lambda: pd.dia_spmv(op.bands, x, op.offsets, op.h)),
            "dia_spmv_plain": median_ms(
                lambda: pd.dia_spmv_plain(op.bands, x, op.offsets, op.h)),
            "dia_wdot": median_ms(
                lambda: pd.dia_wdot(op.bands, x, None, dinv, op.offsets, op.h)),
            "dia_wdot_plain": median_ms(
                lambda: pd.dia_wdot_plain(op.bands, x, None, dinv, op.offsets, op.h)),
            "dia_dot": median_ms(lambda: pd.dia_dot(op.bands, x, op.offsets, op.h)),
            "dia_dot_plain": median_ms(
                lambda: pd.dia_dot_plain(op.bands, x, op.offsets, op.h)),
        }
        if name in ("poisson100_int8", "random_f64"):
            t.update(phase_orth_norm(name, op, mk, errs))
        times[name] = t
        log("kernels", set=name, bands=str(op.bands.dtype).replace("torch.", ""),
            **{f"{k}_ms": f"{v:.4f}" for k, v in t.items()},
            K1_Gnnz_s=f"{nnz / t['dia_spmv'] / 1e6:.1f}",
            K2_Gnnz_s=f"{nnz / t['dia_wdot'] / 1e6:.1f}",
            K3_Gnnz_s=f"{nnz / t['dia_dot'] / 1e6:.1f}")
    return errs, times


def phase_orth_norm(name, op, mk, errs):
    """K4 on three vectors of ``op``'s layout, with β and α as 0-d CUDA
    tensors as MINRES passes them; returns its and its plain version's
    median times."""
    dt, dev = op.vdtype, op.device
    a, vold, v = mk(), mk(), mk()
    beta = torch.tensor(0.7, dtype=dt, device=dev)
    alpha = torch.tensor(-1.3, dtype=dt, device=dev)
    dirty(a)
    vn, ss = fused.orth_norm(a, vold, v, beta, alpha, op.h)
    vn_r, ss_r = fused.orth_norm_plain(a, vold, v, beta, alpha)
    scale = a.abs() + 0.7 * vold.abs() + 1.3 * v.abs()
    if not bool(((vn - vn_r).abs() <= Y_RTOL[dt] * scale).all()):
        raise AssertionError(f"{name} K4: v+ outside rtol {Y_RTOL[dt]}")
    errs["orth_norm"] = max(errs["orth_norm"], float((vn - vn_r).abs().max()))
    check_close(f"{name} K4 sumsq", ss, ss_r, ss_r, DOT_RTOL[dt])
    check_halo(f"{name} K4 v+", op, vn)
    torch.cuda.synchronize()
    return {
        "orth_norm": median_ms(lambda: fused.orth_norm(a, vold, v, beta, alpha, op.h)),
        "orth_norm_plain": median_ms(lambda: fused.orth_norm_plain(a, vold, v, beta, alpha)),
    }


def true_residual(A, x, b) -> float:
    import scipy.sparse as sps

    S = sps.csr_matrix((A.data.numpy().astype(np.float64), A.indices.numpy(),
                        A.indptr.numpy()), shape=A.shape)
    xh = x.detach().cpu().numpy().astype(np.float64)
    bh = np.asarray(b, np.float64)
    return float(np.linalg.norm(S @ xh - bh) / np.linalg.norm(bh))


def poisson_rhs(A) -> np.ndarray:
    return np.random.default_rng(SEED + 2).standard_normal(A.shape[0]).astype(np.float32)


def timed_solves(handle, b, its, what):
    """Three solves through a prepared handle, each required to converge (in
    ``its`` iterations when ``its`` is given). Returns the median wall
    seconds, the walls, and the last solve's ``(x, info)``."""
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, info = handle(b)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if not info.converged or (its is not None and int(info.iterations) != its):
            raise AssertionError(f"{what}: {info} (solve took {its} iterations)")
    return statistics.median(walls), walls, x, info


def phase_slice(dev):
    """Phase 4: the main path through solve() and prepare()."""
    A = problems.poisson3d(GRID, GRID, GRID)
    b = poisson_rhs(A)
    kw = dict(method="bicgstab", M="jacobi", tol=1e-4, max_iter=400)
    pd.reset_launch_counts()
    x, info = spt.solve(A, b, device=dev, **kw)
    torch.cuda.synchronize()
    launches = launch_counts()
    its = int(info.iterations)
    res = true_residual(A, x, b)
    if not info.converged:
        raise AssertionError(f"solve did not converge: {info}")
    if not (x.shape == (A.shape[0],) and bool(torch.isfinite(x).all())):
        raise AssertionError("solution is not a finite (n,) vector")
    if not res < 1e-3:
        raise AssertionError(f"true relative residual {res:.3e} >= 1e-3")
    if launches["dia_spmv"] < 1 or launches["dia_wdot"] != 2 * its:
        raise AssertionError(f"launch counts {launches} for {its} iterations")
    log("slice", entry="solve", iterations=its, recurrence_residual=float(info.residual),
        true_residual=res, K1_launches=launches["dia_spmv"],
        K2_launches=launches["dia_wdot"])

    handle = spt.prepare(A, device=dev, **kw)
    wall, walls, x2, _ = timed_solves(handle, torch.as_tensor(b, device=dev), its,
                                      "prepare")
    res2 = true_residual(A, x2, b)
    if not res2 < 1e-3:
        raise AssertionError(f"prepare: true relative residual {res2:.3e}")
    log("slice", entry="prepare", iterations=its, wall_s_median=f"{wall:.4f}",
        walls_s=",".join(f"{w:.4f}" for w in walls),
        per_iteration_ms=f"{wall / its * 1e3:.4f}", true_residual=res2)
    return launches


def phase_f64(dev):
    """Phase 5: f64 BiCGStab on the kernels, the reference's 100×100 grid."""
    A = problems.grid_laplacian_dirichlet((100, 100))
    rhs = np.zeros(A.shape[0])
    problems.set_boundary_condition(rhs, (100, 100), lambda r, c: float(r + c))
    op = spt.PaddedDIA.from_dia(A.to_dia(), device=dev)
    before = pd.dia_wdot.launches
    x2, info = spt.bicgstab(op, op.pad_vec(torch.as_tensor(rhs, device=dev)),
                            tol=1e-16, max_iter=5000)
    x = op.unpad_vec(x2)
    res = true_residual(A, x, rhs)
    if not info.converged or not res < 1e-12 or pd.dia_wdot.launches == before:
        raise AssertionError(f"f64 grid: {info}, true residual {res:.3e}")
    log("f64", grid="100x100", iterations=int(info.iterations),
        recurrence_residual=float(info.residual), true_residual=res)


class PlainOperator:
    """A PaddedDIA's operator protocol through the plain PyTorch versions of
    K1, K3 and K4 on the same CUDA tensors: the baseline of phase 6."""

    def __init__(self, op):
        self.op = op
        self.shape, self.padded_len, self.device = op.shape, op.padded_len, op.device
        self.pad_vec, self.unpad_vec = op.pad_vec, op.unpad_vec
        self.jacobi_precond = op.jacobi_precond

    def matvec(self, x2):
        return pd.dia_spmv_plain(self.op.bands, x2, self.op.offsets, self.op.h)

    def matvec_dot(self, x2):
        return pd.dia_dot_plain(self.op.bands, x2, self.op.offsets, self.op.h)

    def orth_norm(self, a2, vold2, v2, beta, alpha):
        return fused.orth_norm_plain(a2, vold2, v2, beta, alpha)


def phase_symmetric(dev):
    """Phase 6: MINRES, CG and auto on the f32 Poisson through solve(), then
    through prepare(), against the plain versions. Returns MINRES's launch
    counts."""
    A = problems.poisson3d(GRID, GRID, GRID)
    b = poisson_rhs(A)
    runs = {
        "minres": dict(method="minres"),
        "cg": dict(method="cg", M="jacobi"),
        "auto": dict(method="auto"),
    }
    its = {}
    for name, kw in runs.items():
        pd.reset_launch_counts()
        x, info = spt.solve(A, b, device=dev, tol=1e-4, max_iter=1000, **kw)
        torch.cuda.synchronize()
        n, c = int(info.iterations), launch_counts()
        res = true_residual(A, x, b)
        if not (info.converged and res < 1e-3 and bool(torch.isfinite(x).all())
                and x.shape == (A.shape[0],)):
            raise AssertionError(f"{name}: {info}, true residual {res:.3e}")
        want = {"dia_spmv": 1, "dia_wdot": 0,
                "dia_dot": n if name == "cg" else n + 1,
                "orth_norm": 0 if name == "cg" else n + 1}
        if c != want:
            raise AssertionError(f"{name}: launch counts {c}, expected {want}")
        its[name] = n
        if name == "minres":
            launches = c
        log("symmetric", entry=f"solve(method={kw['method']!r}"
            + (", M='jacobi')" if "M" in kw else ")"), iterations=n,
            recurrence_residual=float(info.residual), true_residual=res,
            **{f"{k}_launches": v for k, v in c.items()})

    bd = torch.as_tensor(b, device=dev)
    kernel_op = spt.PaddedDIA.from_dia(DIA.from_csr(A, device="cpu"), device=dev)
    for name in ("minres", "cg"):
        kw = dict(runs[name], tol=1e-4, max_iter=1000)
        for path, op in (("kernels", A), ("plain", PlainOperator(kernel_op))):
            handle = spt.prepare(op, device=dev, **kw)
            wall, walls, x, info = timed_solves(
                handle, bd, its[name] if path == "kernels" else None, f"{name} {path}")
            n = int(info.iterations)
            res = true_residual(A, x, b)
            if not res < 1e-3:
                raise AssertionError(f"{name} {path}: true residual {res:.3e}")
            log("symmetric", entry=f"prepare({name}, {path})", iterations=n,
                wall_s_median=f"{wall:.4f}", walls_s=",".join(f"{w:.4f}" for w in walls),
                per_iteration_ms=f"{wall / max(n, 1) * 1e3:.4f}", true_residual=res)
    return launches


def phase_f64_symmetric(dev):
    """Phase 7: f64 MINRES and CG on the kernels, 100×100 folded grid."""
    A, rhs = problems.sym_grid_laplacian((100, 100))
    dia = A.to_dia()
    op = spt.PaddedDIA.from_dia(dia, device=dev)
    neg = spt.PaddedDIA.from_dia(DIA(bands=-dia.bands, offsets=dia.offsets,
                                     shape=dia.shape), device=dev)
    b2 = op.pad_vec(torch.as_tensor(rhs, device=dev))
    pd.reset_launch_counts()
    x2, info = spt.minres(op, b2, tol=1e-12, max_iter=5000)
    torch.cuda.synchronize()
    c = launch_counts()
    res = true_residual(A, op.unpad_vec(x2), rhs)
    n = int(info.iterations)
    if not (info.converged and res < 1e-9 and c["dia_dot"] == c["orth_norm"] == n + 1):
        raise AssertionError(f"f64 minres: {info}, true residual {res:.3e}, launches {c}")
    check_halo("f64 minres x", op, x2)
    log("f64_symmetric", solver="minres", grid="100x100", iterations=n,
        recurrence_residual=float(info.residual), true_residual=res,
        K3_launches=c["dia_dot"], K4_launches=c["orth_norm"])
    _, info = spt.cg(op, b2, tol=1e-12, max_iter=5000)
    if int(info.status) != int(spt.Status.BREAKDOWN):
        raise AssertionError(f"f64 cg on a negative-definite matrix: {info}")
    log("f64_symmetric", solver="cg", matrix="A (negative definite)",
        status=spt.Status(int(info.status)).name, iterations=int(info.iterations))
    x2, info = spt.cg(neg, -b2, tol=1e-12, max_iter=5000)
    res = true_residual(A, neg.unpad_vec(x2), rhs)
    if not (info.converged and res < 1e-9):
        raise AssertionError(f"f64 cg on -A: {info}, true residual {res:.3e}")
    check_halo("f64 cg x", neg, x2)
    log("f64_symmetric", solver="cg", matrix="-A", iterations=int(info.iterations),
        recurrence_residual=float(info.residual), true_residual=res)


def phase_nonsymmetric(dev):
    """Phase 8: auto routes the convection-diffusion operator to
    BiCGStab(ℓ=2), which launches K2 2ℓ = 4 times per cycle."""
    A = problems.convection_diffusion3d(GRID, GRID, GRID, peclet=20.0)
    b = np.random.default_rng(SEED + 3).standard_normal(A.shape[0]).astype(np.float32)
    pd.reset_launch_counts()
    t0 = time.perf_counter()
    x, info = spt.solve(A, b, device=dev, method="auto", M="jacobi", tol=1e-4,
                        max_iter=500)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c, n = launch_counts(), int(info.iterations)
    res = true_residual(A, x, b)
    want = {"dia_spmv": 1, "dia_wdot": 4 * n, "dia_dot": 0, "orth_norm": 0}
    if not (info.converged and res < 1e-3 and c == want):
        raise AssertionError(f"auto on convection-diffusion: {info}, true residual "
                             f"{res:.3e}, launches {c} (expected {want})")
    log("nonsymmetric", entry="solve(method='auto', M='jacobi')", route="bicgstabl(l=2)",
        cycles=n, recurrence_residual=float(info.residual), true_residual=res,
        K2_launches=c["dia_wdot"], wall_s_with_setup=f"{wall:.4f}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    log("device", torch=torch.__version__, cuda=torch.version.cuda,
        name=repr(torch.cuda.get_device_name(0)), count=torch.cuda.device_count())

    t0 = time.perf_counter()
    lib = _cuda_build.load()
    log("build", seconds=f"{time.perf_counter() - t0:.2f}",
        library=_cuda_build.library_path().name,
        row_tile=lib.sprsolve_dia_row_tile())
    assert lib.sprsolve_dia_row_tile() == pd.ROW_TILE
    assert lib.sprsolve_dia_max_diags() == pd.MAX_DIAGS

    errs, times = phase_kernels(dev)
    launches = phase_slice(dev)
    phase_f64(dev)
    # each path's kernels read their counts from that path's own run
    launches.update({k: v for k, v in phase_symmetric(dev).items()
                     if k in ("dia_dot", "orth_norm")})
    phase_f64_symmetric(dev)
    phase_nonsymmetric(dev)

    t = times["poisson100_int8"]
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": t[name], "plain_ms": t[name + "_plain"]}
        for name, (src, replaces) in KERNELS.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
