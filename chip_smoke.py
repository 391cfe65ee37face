"""Drive the PyTorch/CUDA port's main path once on one GPU, and check it.

    python3 chip_smoke.py

Phases, each printing one line of its own:

1. device  — requires CUDA (no CPU fallback); prints the card's name and
   power limit as nvidia-smi reports them.
2. build   — builds the CUDA kernels from ``sprsolve_tpu_torch/csrc`` with
   nvcc; prints the build seconds.
3. kernels — K1 (dia_spmv) and K2 (dia_wdot, in all four variants) against
   their plain PyTorch versions on the card, on the 100³ Poisson (int8
   bands), a random band set that does not narrow, a bf16-exact set and an
   f64 set; narrow band storage must give bitwise the output of the same
   values stored f32.  Prints median times and nnz/s.
4. slice   — ``solve(A, b, method="bicgstab", M="jacobi")`` on the 100³
   Poisson in f32, with the launch counters reset just before: it must
   converge, reach a true relative residual (f64, scipy) below 1e-3, launch
   K1 at least once and K2 twice per iteration. Then the same through
   ``prepare`` (median of 3 timed solves).
5. f64     — BiCGStab on the padded-DIA kernels in f64 on the reference's
   100×100 Dirichlet grid, tol 1e-16.

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
from sprsolve_tpu_torch.ops import _cuda_build
from sprsolve_tpu_torch.ops import padded_dia as pd
from sprsolve_tpu_torch.sparse.containers import DIA
from sprsolve_tpu_torch.utils import problems

SEED = 0
GRID = 100          # the 100³ Poisson: 1,000,000 rows, 6,940,000 nnz
SOURCE = "sprsolve_tpu_torch/csrc/dia_spmv.cu"
REPLACES = {
    "dia_spmv": "sprsolve_tpu/ops/pallas_spmv.py:131",
    "dia_wdot": "sprsolve_tpu/ops/pallas_spmv.py:159",
}
# tolerances of kernel against plain version, by vector dtype:
#  y:        rtol of the row's |A|·|x| — the kernel fuses each multiply-add
#            into an FMA, the plain version may not;
#  partials: rtol of Σ|w·y| — the block tree sums in another order than
#            torch.sum.
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


def check_close(name, got, want, scale, rtol):
    err = float((got - want).abs().max())
    bound = rtol * float(scale)
    if not err <= bound:
        raise AssertionError(f"{name}: max |kernel - plain| {err:.3e} > {bound:.3e}")
    return err


def phase_kernels(dev):
    """Phase 3: every kernel and variant against its plain version."""
    rng = np.random.default_rng(SEED + 1)
    errs = {"dia_spmv": 0.0, "dia_wdot": 0.0}
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
        }
        times[name] = t
        log("kernels", set=name, bands=str(op.bands.dtype).replace("torch.", ""),
            **{f"{k}_ms": f"{v:.4f}" for k, v in t.items()},
            K1_Gnnz_s=f"{nnz / t['dia_spmv'] / 1e6:.1f}",
            K2_Gnnz_s=f"{nnz / t['dia_wdot'] / 1e6:.1f}")
    return errs, times


def true_residual(A, x, b) -> float:
    import scipy.sparse as sps

    S = sps.csr_matrix((A.data.numpy().astype(np.float64), A.indices.numpy(),
                        A.indptr.numpy()), shape=A.shape)
    xh = x.detach().cpu().numpy().astype(np.float64)
    bh = np.asarray(b, np.float64)
    return float(np.linalg.norm(S @ xh - bh) / np.linalg.norm(bh))


def phase_slice(dev):
    """Phase 4: the main path through solve() and prepare()."""
    A = problems.poisson3d(GRID, GRID, GRID)
    b = np.random.default_rng(SEED + 2).standard_normal(A.shape[0]).astype(np.float32)
    kw = dict(method="bicgstab", M="jacobi", tol=1e-4, max_iter=400)
    pd.reset_launch_counts()
    x, info = spt.solve(A, b, device=dev, **kw)
    torch.cuda.synchronize()
    launches = {"dia_spmv": pd.dia_spmv.launches, "dia_wdot": pd.dia_wdot.launches}
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
    bd = torch.as_tensor(b, device=dev)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x2, info2 = handle(bd)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if not info2.converged or int(info2.iterations) != its:
            raise AssertionError(f"prepare: {info2} (solve took {its} iterations)")
    wall = statistics.median(walls)
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

    t = times["poisson100_int8"]
    kernels = [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": t[name], "plain_ms": t[name + "_plain"]}
        for name in ("dia_spmv", "dia_wdot")
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
