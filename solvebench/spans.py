"""The program's spans beside the device: a traced stretch of solves with
``sprsolve_tpu_torch.utils.timing``'s spans on, and its summary.

    python3 -m solvebench.spans --workload <name> --seed <n> --seconds <s> [--spans-seconds <s>]

Run from the checkout's root.  Set-up as a benchmark run (the cell's files,
one warm-up solve), the window of closed-loop solves with spans off for
``--seconds``, then the spans stretch (:func:`stretch`): further solves under
``torch.profiler`` with the device alone, between two marker fills, inside
``timing.spans_on()``, for at least ``--spans-seconds`` and one solve.  The
``[trace.spans]`` line on standard error splits the device's idle time by the
innermost span over it, and gives the idle from each copy to the host to the
next device event (``read_gap_s``, on the device's clock alone); the last line of standard output is
one JSON object: the window's ``solve_s``, the stretch's summary and
:func:`metrics`.

The program keeps its spans in memory (``solve`` around each prepared solve,
``host_read`` around each read of a solver's predicates, ``precond`` around
each preconditioner apply) on ``time.time_ns()``; less the profiler's
``trace_start_ns`` they land on the profiler's timeline, in µs.  A program
without spans gives no stretch (:func:`stretch` returns None).
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
import time
from typing import Optional

from . import harness, profiling

SPANS_S = 0.5    # least length of the spans stretch
ALIGN_PIECES = 16   # runs of reads, each with its own clock offset
IDLE_KINDS = ("solve", "host_read", "precond", "outside")


def _timing():
    """The program's timing module where it keeps spans, else None."""
    from sprsolve_tpu_torch.utils import timing

    return timing if hasattr(timing, "spans_on") else None


def overlap(a, b) -> float:
    """The length of the intersection of two sorted, disjoint interval
    lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def summarize(dev, spans, start_ns: int) -> dict:
    """The stretch's summary from the device's events ``[(name, start_us,
    end_us)]`` (a marker fill first and last, as :func:`profiling.summarize`
    takes them) and the program's spans ``(name, start_ns, end_ns, parent,
    solve_id)``, placed on the profiler's timeline as (t − ``start_ns``)/1e3
    µs.  Times in s; ``idle_s`` None where there is no device event."""
    sp = [(s[0], (s[1] - start_ns) / 1e3, (s[2] - start_ns) / 1e3, s[4]) for s in spans]
    solves = [(a, b) for name, a, b, _ in sp if name == "solve"]
    reads = [(a, b) for name, a, b, sid in sp if name == "host_read" and sid >= 0]
    preconds = [(a, b) for name, a, b, sid in sp if name == "precond" and sid >= 0]
    per_solve = {}
    for name, a, b, sid in sp:
        if sid >= 0 and name in ("solve", "host_read"):
            row = per_solve.setdefault(sid, [0.0, 0.0, 0])
            if name == "solve":
                row[0] += (b - a) * 1e-3
            else:
                row[1] += (b - a) * 1e-3
                row[2] += 1
    out = {
        "solve_s": sum(b - a for a, b in solves) * 1e-6,
        "host_read_s": sum(b - a for a, b in reads) * 1e-6,
        "precond_s": sum(b - a for a, b in preconds) * 1e-6,
        "n_spans": len(sp),
        "n_host_reads": len(reads),
        # [solve ms, ms in host_read, host reads] of each solve
        "per_solve": [per_solve[k] for k in sorted(per_solve)],
        "idle_s": None,
    }
    dev = sorted(dev, key=lambda r: r[1])
    if len(dev) < 2:
        return out
    w0, w1 = dev[0][1], dev[-1][2]
    body = [(n, max(a, w0), min(b, w1)) for n, a, b in dev[1:-1] if b > w0 and a < w1]
    busy = profiling.merged((a, b) for _, a, b in body)
    copies = [(a, b) for n, a, b in body if n.startswith("Memcpy DtoH")]
    out.update(window_s=(w1 - w0) * 1e-6, busy_s=sum(b - a for a, b in busy) * 1e-6,
               n_events=len(body), n_dtoh=len(copies))
    # a read returns after the work issued before it: a device event that
    # starts before a host_read begins ends before the read returns.  The
    # largest (event end − read end) over the reads, on the clocks as they
    # are; > 0 where they disagree
    starts = [a for _, a, _ in dev]
    latest, m = [], float("-inf")
    for _, _, b in dev:
        m = max(m, b)
        latest.append(m)
    all_reads = sorted((a, b) for name, a, b, _ in sp if name == "host_read")
    skews = []
    for a, b in all_reads:
        k = bisect.bisect_left(starts, a)   # the events that start before the read
        if k:
            skews.append(latest[k - 1] - b)
    out["clock_skew_us"] = max(skews) if skews else None
    # the k-th copy to the host is the k-th read's where their counts agree:
    # the least (read end − its copy's end) over a run of reads is the host's
    # least wake-up plus the offset of the two clocks, which drift apart by
    # tens of µs over seconds; each span is moved back by the offset of the
    # run of reads it starts in, before the idle is split
    if copies and len(copies) == len(all_reads):
        lags = [rb - cb for (_, rb), (_, cb) in zip(all_reads, copies)]
        size = -(-len(lags) // ALIGN_PIECES)
        cuts = [all_reads[i][0] for i in range(0, len(lags), size)]
        offsets = [min(lags[i:i + size]) for i in range(0, len(lags), size)]
        out["clock_offset_us"] = [min(offsets), max(offsets)]
        offset = lambda t: offsets[max(bisect.bisect_right(cuts, t) - 1, 0)]
        reads, preconds, solves = ([(a - offset(a), b - offset(a)) for a, b in iv]
                                   for iv in (reads, preconds, solves))
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    idle = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    total = sum(b - a for a, b in idle)
    in_read = overlap(idle, profiling.merged(reads))
    in_precond = overlap(idle, profiling.merged(reads + preconds))
    in_solve = overlap(idle, profiling.merged(reads + preconds + solves))
    out["idle_s"] = {"solve": (in_solve - in_precond) * 1e-6,
                     "host_read": in_read * 1e-6,
                     "precond": (in_precond - in_read) * 1e-6,
                     "outside": (total - in_solve) * 1e-6}
    # on the device's clock alone: the idle in solves from the end of each
    # copy to the host to the next device event, the card drained at a read
    # and waiting for the host to issue again
    idle_starts = [a for a, _ in idle]
    after = []
    for _, b in copies:
        k = bisect.bisect_left(idle_starts, b - 1e-6)
        if k < len(idle) and idle[k][0] <= b + 1e-6:   # the card idles from the copy's end
            after.append(idle[k])
    out["read_gap_s"] = overlap(profiling.merged(after), profiling.merged(solves)) * 1e-6
    return out


def metrics(t: Optional[dict]) -> dict:
    """The four per-layer numbers of a stretch's summary, each None where
    there is nothing to read: host reads an iteration, the host's own ms an
    iteration (solve time less its reads), the share of solve time spent in
    reads (%), and the share of the device's idle time inside a solve and
    outside every read (%)."""
    out = dict.fromkeys(("host_reads_per_iter", "host_issue_ms_per_iter",
                         "host_wait_share", "idle_issue_share"))
    if not t or not t.get("iterations") or t["solve_s"] <= 0:
        return out
    its = t["iterations"]
    out["host_reads_per_iter"] = t["reads"] / its
    out["host_issue_ms_per_iter"] = 1e3 * (t["solve_s"] - t["host_read_s"]) / its
    out["host_wait_share"] = 100.0 * t["host_read_s"] / t["solve_s"]
    idle = t["idle_s"]
    if idle and sum(idle.values()) > 0:
        out["idle_issue_share"] = 100.0 * (idle["solve"] + idle["precond"]) / sum(idle.values())
    return out


def _profiled(body, device):
    """``body`` under the profiler, the device alone (the CPU's ops where
    there is no card), between two marker fills: ``(device events, the
    trace's start in ns)``."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    cuda = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)
    sync()
    with tprofile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]) as prof:
        torch.full((1,), 1.0, device=device)
        sync()
        body()
        sync()
        torch.full((1,), 1.0, device=device)
        sync()
    dev, _ = profiling._events(prof)
    return dev, prof.profiler.kineto_results.trace_start_ns()


def stretch(s: "harness.Session", pool, least: float = SPANS_S) -> Optional[dict]:
    """Closed-loop solves on the right-hand sides of ``pool`` (taken in
    turn) for at least ``least`` seconds and one solve, traced with the
    device alone and the program's spans on: :func:`summarize`'s summary,
    with the stretch's solves, iterations and host reads (the change of
    ``read_flags.calls``).  None for a program that keeps no spans."""
    timing = _timing()
    if timing is None:
        return None
    from sprsolve_tpu_torch.solvers.common import read_flags

    counted = {}

    def body():
        timing.reset_spans()
        n0 = read_flags.calls
        with timing.spans_on():
            done = s.solves(lambda i: pool[i % len(pool)], 0, time.perf_counter() + least)
        counted.update(reads=read_flags.calls - n0, iterations=sum(done["iterations"]),
                       solves=done["n_solves"], solve_times=done["solve_times"],
                       spans=timing.spans(), dropped=timing.dropped_spans())

    for _ in range(3):   # a trace can come back with no device event
        dev, start_ns = _profiled(body, s.device)
        if dev or s.device.type != "cuda":
            break
    out = summarize(dev, counted.pop("spans"), start_ns)
    out.update(counted)
    return out


def log_line(t: dict) -> str:
    idle = t["idle_s"] or {}
    return ("[trace.spans] " + f"solves={t['solves']} iterations={t['iterations']} "
            f"reads={t['reads']} host_read_spans={t['n_host_reads']} "
            f"dtoh={t.get('n_dtoh')} dropped={t['dropped']} "
            f"solve_s={t['solve_s']:.6f} host_read_s={t['host_read_s']:.6f} "
            f"precond_s={t['precond_s']:.6f} window_s={t.get('window_s', 0.0):.6f} "
            f"busy_s={t.get('busy_s', 0.0):.6f} clock_skew_us={t.get('clock_skew_us')} "
            f"clock_offset_us={t.get('clock_offset_us')} idle_s "
            + " ".join(f"{k}={idle[k]:.6f}" for k in IDLE_KINDS if k in idle)
            + f" read_gap_s={t.get('read_gap_s')}")


def main(argv=None, *, require_cuda: bool = True, device: str = "cuda:0",
         cell: Optional["harness.Cell"] = None, out=None, err=None) -> int:
    t0 = time.perf_counter()
    out = out or sys.stdout
    err = err or sys.stderr
    p = argparse.ArgumentParser(description="The spans stretch of one cell of BENCHMARK.json.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--spans-seconds", type=float, default=SPANS_S)
    args = p.parse_args(argv)
    log = lambda line: print(line, file=err, flush=True)
    try:
        if cell is None:
            cell = harness.Cell(harness.read_json(harness.ROOT / "BENCHMARK.json"),
                                args.workload)
        if require_cuda:
            import torch
            if not torch.cuda.is_available():
                raise harness.SetupError("no CUDA device: torch.cuda.is_available() is false")
        s = harness.Session(cell, device, t0)
    except (harness.SetupError, ImportError) as e:
        log(f"solvebench.spans: {type(e).__name__}: {e}")
        return 2
    rhs = harness.Rhs(cell.cfg, cell.traffic, args.seed, s.device, s.torch)
    s.warm_up(rhs)
    window, _ = harness.run_window(s, rhs, args.seconds, args.seed)
    n = window["n_solves"]
    t = stretch(s, [rhs(n), rhs(n + 1)], args.spans_seconds)
    if t is None:
        log("[trace.spans] the program keeps no spans")
    else:
        log(log_line(t))
    result = {
        "workload": cell.name,
        "device": (s.torch.cuda.get_device_name(s.device) if s.device.type == "cuda"
                   else "cpu"),
        "window": {"solve_s": window["window_s"] / n, "solves": n,
                   "iterations": sum(window["iterations"])},
        "spans": t,
        "metrics": metrics(t),
    }
    print(json.dumps(result), file=out, flush=True)
    return 0


if __name__ == "__main__":
    # kernel and compile caches at fixed places inside the checkout, as run.py
    os.environ.setdefault("TRITON_CACHE_DIR", str(harness.ROOT / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(harness.ROOT / "build" / "torch_extensions"))
    sys.exit(main())
