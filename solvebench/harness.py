"""The benchmark of ``sprsolve_tpu_torch``: repeated Krylov solves against one
prepared operator, driven by the data files of this folder.

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``:
the operator, its size and precision) and a traffic mix
(``traffic/<name>.json``: method, preconditioner, tolerance and the stream of
right-hand sides).  A run:

1. set-up: imports the program, builds the operator's CSR with the
   benchmark's own generator (``operators/<operator>.py``), builds the solve
   pipeline (``pipelines/<pipeline>.py``: ``prepare()`` and any
   preconditioner) and runs one warm-up solve;
2. the window: a closed loop of solves, one caller, the next solve when the
   last returns, x0 = 0, until ``--seconds`` have passed.  Solve i gets its
   own right-hand side, made on the device from (``--seed``, i) before the
   solve's clock starts (:class:`Rhs`); every solve is timed on the host
   clock from the call to its return, ending in a synchronise;
3. with ``--trace 1``, two traced stretches of further solves (the device
   alone, then the host beside it) for the per-layer metrics;
4. the check: the program's state is freed, and the plain reference
   (``reference/``) judges a sample of the window's answers, drawn from the
   seed, by their true residual against the limits of
   ``limits/<workload>.json``.

Every metric is read from the run's summary by a reader of its own,
``metrics/<name>.py``, found by the name ``BENCHMARK.json`` gives it.  Nothing
here imports JAX or the JAX package, and the run fails if either was loaded.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Callable, Optional

import numpy as np

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "sprsolve_tpu")   # whole top-level names
SAMPLES = 4          # answers of the window that the reference judges
TRACE_DEVICE_S = 1.0  # least length of the device-only traced stretch
TRACE_HOST_S = 0.25   # least length of the traced stretch with the host
DTYPES = ("float32", "float64", "complex64", "complex128")


class SetupError(RuntimeError):
    """The run cannot start: no card, a missing file, a bad name."""


def load_module(path: Path) -> ModuleType:
    """The module in the file ``path``, loaded by its path (a name may hold
    dots), under a name of this folder's."""
    if not path.is_file():
        raise SetupError(f"no file {path.relative_to(ROOT)}")
    name = "solvebench._loaded." + "_".join(path.relative_to(BENCH).with_suffix("").parts)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path) -> dict:
    if not path.is_file():
        raise SetupError(f"no file {path.relative_to(ROOT)}")
    return json.loads(path.read_text())


def forbidden_modules() -> list:
    """The loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


class Cell:
    """One workload of ``BENCHMARK.json`` with its files read."""

    def __init__(self, spec: dict, workload: str):
        cells = {w["name"]: w for w in spec["workloads"]}
        if workload not in cells:
            raise SetupError(f"no workload {workload!r} in BENCHMARK.json")
        self.name = workload
        self.entry = cells[workload]
        configs = {c["name"]: c for c in spec["configs"]}
        self.cfg = read_json(ROOT / configs[self.entry["config"]]["file"])
        self.traffic = read_json(BENCH / "traffic" / f"{self.entry['traffic']}.json")
        self.limits = read_json(BENCH / "limits" / f"{workload}.json")
        self.chips = int(self.entry["chips"])
        self.metrics = {
            kind: [m for m in spec[kind]
                   if "workloads" not in m or workload in m["workloads"]]
            for kind in ("end_to_end", "per_layer")
        }


def operator_module(cfg: dict) -> ModuleType:
    return load_module(BENCH / "operators" / f"{cfg['operator']}.py")


def reference_module(cfg: dict) -> ModuleType:
    return load_module(BENCH / "reference" / f"{cfg['operator']}.py")


class Rhs:
    """The traffic's stream of right-hand sides: b of solve ``i`` made on the
    device from (``seed``, i) alone, so the check can make it again.  The
    traffic's ``rhs.kind`` names the generator, ``rhs/<kind>.py``, whose
    ``stream(cfg, spec, dtype, operator)`` returns ``make(gen, device)``."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device, torch):
        self.torch = torch
        self.seed = int(seed) % (1 << 63)
        self.device = device
        if cfg["dtype"] not in DTYPES:
            raise SetupError(f"unknown dtype {cfg['dtype']!r}")
        self.dtype = getattr(torch, cfg["dtype"])
        spec = traffic["rhs"]
        self.make = load_module(BENCH / "rhs" / f"{spec['kind']}.py").stream(
            cfg, spec, self.dtype, operator_module(cfg))

    def __call__(self, i: int):
        key = np.random.SeedSequence([self.seed, i + 1]).generate_state(1, np.uint64)[0]
        gen = self.torch.Generator(device=self.device)
        gen.manual_seed(int(key) % (1 << 63))
        return self.make(gen, self.device)


def geometry_of(op, itemsize: int):
    """The byte models' view of a padded operator, or None for a layout
    they do not model."""
    from .byte_models import Geometry

    planes = [getattr(op, "bands", None)]
    if planes[0] is None and hasattr(op, "re"):
        planes = [op.re.bands, op.im.bands]
    if any(p is None for p in planes) or not hasattr(op, "n_pad"):
        return None
    return Geometry(n_pad=int(op.n_pad), h=int(op.h), nd=len(op.offsets),
                    band_itemsizes=tuple(p.element_size() for p in planes),
                    vec_itemsize=itemsize)


class Reservoir:
    """A sample of ``k`` of the window's answers, uniform over all of them,
    drawn from the seed (Algorithm R)."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = np.random.default_rng([int(seed) % (1 << 63), 1])
        self.kept = []    # [(i, item)] for the i-th answer offered

    def offer(self, i: int, item) -> None:
        if i < self.k:
            self.kept.append((i, item))
            return
        j = int(self.rng.integers(0, i + 1))
        if j < self.k:
            self.kept[j] = (i, item)


class Session:
    """The set-up of one run: the program's pipeline on the operator, built
    once, and the clocks of its parts."""

    def __init__(self, cell: Cell, device, t0: float, pipeline: Optional[Callable] = None):
        import torch

        import sprsolve_tpu_torch as spt   # the system under test

        self.torch = torch
        self.device = torch.device(device)
        self.parts = {}
        if self.device.type == "cuda":
            torch.cuda.init()
            torch.empty(1, device=self.device)
            self.sync()
        self.parts["import_s"] = time.perf_counter() - t0   # process start to here
        t = time.perf_counter()
        data, indices, indptr, shape = operator_module(cell.cfg).csr_arrays(cell.cfg)
        self.A = spt.CSR.from_arrays(data, indices, indptr, shape)
        del data, indices, indptr
        self.parts["csr_s"] = time.perf_counter() - t
        t = time.perf_counter()
        build = pipeline or load_module(
            BENCH / "pipelines" / f"{cell.traffic['pipeline']}.py").build
        self.handle = build(spt, self.A, cell.traffic, self.device)
        self.sync()
        self.parts["prepare_s"] = time.perf_counter() - t
        self.op = getattr(self.handle, "operator", None)

    def sync(self) -> None:
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def warm_up(self, rhs: Rhs) -> None:
        """One solve on a right-hand side of its own (index −1): every
        kernel the window runs is built and loaded before it opens."""
        t = time.perf_counter()
        self.handle(rhs(-1))
        self.sync()
        self.parts["warmup_s"] = time.perf_counter() - t

    def launches(self) -> int:
        """The program's hand-kernel launch counters, summed (K1-K7, K1b)."""
        from sprsolve_tpu_torch.ops import fused, padded_dia as pd

        return sum(f.launches for f in (pd.dia_spmv, pd.dia_spmm, pd.dia_wdot, pd.dia_dot,
                                        fused.orth_norm, pd.dia_complex_spmv,
                                        pd.dia_complex_dot, pd.dia_complex_wdot))

    def solves(self, rhs: Rhs, start: int, until: float,
               reservoir: Optional[Reservoir] = None, min_solves: int = 1) -> dict:
        """Closed-loop solves of right-hand sides ``start``, ``start`` + 1, …
        until the host clock passes ``until`` and ``min_solves`` are done.
        Each b is made and the device idle before the solve's clock starts;
        the memory peak is taken over the solves alone."""
        cuda = self.device.type == "cuda"
        times, iters, unconverged, peak = [], [], 0, 0
        i = start
        while True:
            b = rhs(i)
            self.sync()
            if cuda:
                self.torch.cuda.reset_peak_memory_stats(self.device)
            t = time.perf_counter()
            x, info = self.handle(b)
            self.sync()
            t_end = time.perf_counter()
            if cuda:
                peak = max(peak, int(self.torch.cuda.max_memory_allocated(self.device)))
            times.append(t_end - t)
            iters.append(int(info.iterations))
            unconverged += not info.converged
            if reservoir is not None:
                reservoir.offer(i - start, (i, x, bool(info.converged)))
            del x, b
            i += 1
            if t_end >= until and len(times) >= min_solves:
                return {"solve_times": times, "iterations": iters,
                        "unconverged": unconverged, "n_solves": len(times),
                        "window_s": sum(times), "peak_bytes": peak}

    def free(self) -> None:
        """Drop the program's state: the pipeline, its operator, the CSR."""
        self.handle = self.op = self.A = None
        gc.collect()
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()


def run_window(s: Session, rhs: Rhs, seconds: float, seed: int, min_solves: int = 1):
    """The measured window: closed-loop solves for ``seconds``; returns its
    summary (``window_s`` the solves' seconds, the making of each b left
    out) and the reservoir of answers kept for the check."""
    s.sync()
    reservoir = Reservoir(SAMPLES, seed)
    out = s.solves(rhs, 0, time.perf_counter() + seconds, reservoir, min_solves)
    if s.device.type == "cuda":
        out["peak_window_bytes"] = out["peak_bytes"]
    return out, reservoir


def run_traced(s: Session, rhs: Rhs, start: int) -> dict:
    """The per-layer stretch: solves under ``torch.profiler`` with the
    device alone (:data:`TRACE_DEVICE_S` at least), then with the host
    beside it (:data:`TRACE_HOST_S`), each between two marker fills.  They
    take turns on two right-hand sides made before the profiler starts, so
    the trace holds the solves' device work and nothing of the b's."""
    from . import profiling

    out = {}
    itemsize = s.torch.empty((), dtype=rhs.dtype).element_size()
    geom = geometry_of(s.op, itemsize) if s.op is not None else None
    pool = [rhs(start), rhs(start + 1)]
    for host, least in ((False, TRACE_DEVICE_S), (True, TRACE_HOST_S)):
        counted = {}

        def body():
            n0 = s.launches()
            done = s.solves(lambda i: pool[i % 2], 0, time.perf_counter() + least)
            counted.update(iterations=sum(done["iterations"]), solves=done["n_solves"],
                           launches=s.launches() - n0)

        t = time.perf_counter()
        for _ in range(3):   # a trace can come back with no device event
            summary = profiling.profile(body, s.device, host=host)
            if summary["n_events"] or s.device.type != "cuda":
                break
        summary.update(counted)
        summary["read_s"] = time.perf_counter() - t
        out["host" if host else "device"] = summary
    out["geometry"] = geom
    return out


def within(value, limit) -> bool:
    return not math.isnan(value) and value <= limit


def check(cell: Cell, kept, rhs: Rhs):
    """The reference's verdict on the sampled answers: ``({name: (value,
    limit)}, rejected)``, ``rejected`` the number of sampled solves that
    converged by the program's account and fail a limit (an unconverged one
    is counted as failed already)."""
    from .reference import check as ref_check

    ref = reference_module(cell.cfg)
    limit = cell.limits["true_rel_residual_worst"]
    residuals = [(ref_check.true_rel_residual(ref, cell.cfg, x, rhs(k)), converged)
                 for _, (k, x, converged) in kept]
    worst = max((r for r, _ in residuals), default=float("nan"),
                key=lambda r: math.inf if math.isnan(r) else r)
    rejected = sum(converged and not within(r, limit) for r, converged in residuals)
    return {"true_rel_residual_worst": (worst, limit)}, rejected


def read_metrics(cell: Cell, kind: str, summary: dict) -> dict:
    out = {}
    for m in cell.metrics[kind]:
        value = load_module(BENCH / "metrics" / f"{m['name']}.py").read(summary)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run(cell: Cell, *, seed: int, seconds: float, trace: bool, device, t0: float,
        log: Callable, pipeline: Optional[Callable] = None,
        wrap: Optional[Callable] = None) -> dict:
    """One run of ``cell``: set-up, window, traced stretch, check.  Returns
    the result object.  ``pipeline`` replaces the cell's (the control puts
    the reference in the program's place); ``wrap`` wraps the built
    pipeline (a test breaks the timed path with it)."""
    s = Session(cell, device, t0, pipeline)
    if wrap is not None:
        s.handle = wrap(s.handle)
    rhs = Rhs(cell.cfg, cell.traffic, seed, s.device, s.torch)
    s.warm_up(rhs)
    setup_s = time.perf_counter() - t0
    peak_setup = (int(s.torch.cuda.max_memory_allocated(s.device))
                  if s.device.type == "cuda" else 0)
    log("[setup] " + " ".join(f"{k}={v:.4f}" for k, v in s.parts.items())
        + f" setup_s={setup_s:.4f}")

    summary, reservoir = run_window(s, rhs, seconds, seed)
    summary.update(setup_s=setup_s, prepare_s=s.parts["prepare_s"],
                   device_kind=(s.torch.cuda.get_device_name(s.device)
                                if s.device.type == "cuda" else "cpu"))
    q = np.quantile(summary["solve_times"], [0.0, 0.25, 0.5, 0.75, 1.0])
    log(f"[window] solves={summary['n_solves']} window_s={summary['window_s']:.4f} "
        f"iterations={min(summary['iterations'])}-{max(summary['iterations'])} "
        f"unconverged={summary['unconverged']} solve_time_quantiles_s="
        + ",".join(f"{v:.5f}" for v in q))
    if trace:
        summary["trace"] = run_traced(s, rhs, summary["n_solves"])
        for part in ("device", "host"):
            t_ = summary["trace"][part]
            log(f"[trace.{part}] solves={t_['solves']} iterations={t_['iterations']} "
                f"window_s={t_['window_s']:.6f} busy_s={t_['busy_s']:.6f} "
                f"events={t_['n_events']} read_s={t_['read_s']:.2f}")
    peak = max(peak_setup, summary.get("peak_window_bytes", 0))
    s.free()
    del s
    checks, rejected = check(cell, reservoir.kept, rhs)
    checks["unconverged_solves"] = (summary["unconverged"], 0)
    failed = summary["unconverged"] + rejected
    correct = failed == 0 and all(within(v, lim) for v, lim in checks.values())

    import torch
    dev = torch.device(device)
    result = {
        "correct": bool(correct),
        "attempted": summary["n_solves"],
        "failed": int(failed),
        "metrics": read_metrics(cell, "per_layer" if trace else "end_to_end", summary),
        "device": {
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "count": cell.chips,
            "memory_peak_bytes": peak,
        },
    }
    if trace:
        t_dev, t_host = summary["trace"]["device"], summary["trace"]["host"]
        result["device"].update(busy_s=t_dev["busy_s"], window_s=t_dev["window_s"])
        result["breakdown"] = {"device_ops": t_dev["device_ops"],
                               "idle_gaps": t_host["idle_gaps"]}
    # JSON has no NaN: a residual that is not a number is printed as null
    result["checks"] = {k: {"value": None if isinstance(v, float) and math.isnan(v) else v,
                            "limit": lim} for k, (v, lim) in checks.items()}
    result["compared_solves"] = [i for i, _ in reservoir.kept]
    return result


def main(argv=None, *, t0: Optional[float] = None, require_cuda: bool = True,
         device: str = "cuda:0", cell: Optional[Cell] = None,
         pipeline: Optional[Callable] = None, wrap: Optional[Callable] = None,
         out=None, err=None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    out = out or sys.stdout
    err = err or sys.stderr
    p = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    log = lambda line: print(line, file=err, flush=True)
    try:
        if cell is None:
            cell = Cell(read_json(ROOT / "BENCHMARK.json"), args.workload)
        if require_cuda:
            import torch
            if not torch.cuda.is_available():
                raise SetupError("no CUDA device: torch.cuda.is_available() is false")
            if torch.cuda.device_count() < cell.chips:
                raise SetupError(f"{torch.cuda.device_count()} CUDA devices; the cell "
                                 f"asks for {cell.chips}")
        result = run(cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                     device=device, t0=t0, log=log, pipeline=pipeline, wrap=wrap)
    except (SetupError, ImportError) as e:
        log(f"solvebench: {type(e).__name__}: {e}")
        return 2
    found = forbidden_modules()
    if found:
        log(f"solvebench: the process loaded {', '.join(found)}; the port runs "
            "without JAX and the JAX package")
        return 3
    for name, c in result["checks"].items():
        log(f"[check] {name}={c['value']!r} limit={c['limit']!r}")
    log(f"[check] correct={result['correct']} attempted={result['attempted']} "
        f"failed={result['failed']} compared_solves={result['compared_solves']}")
    del result["compared_solves"]
    print(json.dumps(result), file=out, flush=True)
    return 0
