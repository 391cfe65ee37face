"""Timing, profiling and roofline reports.

Counterpart of ``sprsolve_tpu/utils/timing.py``:

- :func:`time_fn` — seconds per call of a callable: on a CUDA device the
  calls are captured in a CUDA graph and replayed between CUDA events (the
  kernels' own time, no launch overhead: the counterpart of chaining the
  calls inside one ``jax.jit``); on the CPU a synchronised wall clock.
- :func:`spmv_report` — nnz/s, achieved bandwidth and the share of the
  card's memory rate for one SpMV.
- :func:`span` — the program's own spans, kept in memory when
  :func:`spans_on` turns them on (off by default): ``solve`` around each
  prepared solve, ``host_read`` around each read of a solver's predicates
  (:func:`~sprsolve_tpu_torch.solvers.common.read_flags`), ``precond``
  around each preconditioner apply, and inside the multigrid V-cycle's
  (:class:`~sprsolve_tpu_torch.multigrid.InjectionMGPrecond`) ``mg_smooth``
  around a level's Gauss-Seidel sweeps and ``mg_transfer`` around each
  restriction and prolongation.
- :func:`trace` — a ``torch.profiler`` context that writes a Chrome trace,
  the program's spans in it.

The memory rate of a card comes from :data:`HBM_BYTES_PER_S`, keyed by the
device name (``torch.cuda.get_device_name``); a card not in the table, as
the CPU, reports no roofline share.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import time
from dataclasses import dataclass
from typing import Callable, List, NamedTuple, Optional

import torch

# published memory rate of each card, bytes per second (NVIDIA's data sheet;
# the H100 SXM part at its 700 W limit)
HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}


def detect_chip(device=None) -> str:
    """The name of the CUDA ``device`` (default: the current one), or
    ``"cpu"`` for a CPU device or when CUDA is absent."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def _cuda_device(out) -> Optional[torch.device]:
    """The CUDA device of the first tensor in ``out`` (a tensor or a
    nest of tuples and lists), else None."""
    if isinstance(out, torch.Tensor):
        return out.device if out.is_cuda else None
    if isinstance(out, (tuple, list)):
        for o in out:
            d = _cuda_device(o)
            if d is not None:
                return d
    return None


def time_fn(fn: Callable, *args, iters: int = 20, warmup: int = 3, reps: int = 5) -> float:
    """Seconds per call of ``fn(*args)``, after ``warmup`` calls.

    When ``fn`` returns CUDA tensors, ``iters`` calls are captured in a
    CUDA graph and replayed ``reps`` times between CUDA events; the median
    replay over ``iters`` is the device time of one call, inputs warm in
    L2 where they fit. ``fn`` must then be capturable (no host read of a
    device value). Otherwise: the wall time of ``iters`` calls over
    ``iters``, the best of ``reps``."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    dev = _cuda_device(out)
    if dev is None:
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            for _ in range(iters):
                fn(*args)
            walls.append((time.perf_counter() - t0) / iters)
        return min(walls)
    with torch.cuda.device(dev):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):   # per-stream state exists before capture
            fn(*args)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(iters):
                fn(*args)
        graph.replay()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3 / iters)
    return statistics.median(times)


def hbm_bytes_per_s(chip: str) -> Optional[float]:
    """The memory rate a roofline share divides by: the published rate of
    ``chip`` where :data:`HBM_BYTES_PER_S` has it, else None (the CPU, a
    card not in the table)."""
    return HBM_BYTES_PER_S.get(chip)


@dataclass
class SpmvReport:
    seconds: float
    nnz: int
    bytes_algorithmic: int
    chip: str
    peak_bytes_per_s: Optional[float]   # None on the CPU

    @property
    def gnnz_per_s(self) -> float:
        return self.nnz / self.seconds / 1e9

    @property
    def achieved_gbps(self) -> float:
        return self.bytes_algorithmic / self.seconds / 1e9

    @property
    def roofline_fraction(self) -> Optional[float]:
        """Achieved bytes per second over the card's memory rate; None on
        the CPU, which has no device roofline."""
        if self.peak_bytes_per_s is None:
            return None
        return self.bytes_algorithmic / self.seconds / self.peak_bytes_per_s

    def __str__(self) -> str:
        s = (f"SpMV: {self.seconds * 1e3:.5f} ms, {self.gnnz_per_s:.2f} Gnnz/s, "
             f"{self.achieved_gbps:.0f} GB/s")
        if self.roofline_fraction is None:
            return s + f" on {self.chip} (no device roofline)"
        return s + (f" ({100 * self.roofline_fraction:.1f}% of {self.chip}'s "
                    f"{self.peak_bytes_per_s / 1e12:.2f} TB/s)")


def dia_bytes(n: int, n_diags: int, itemsize: int = 4, band_itemsize: Optional[int] = None
              ) -> int:
    """Least traffic of a DIA SpMV: the bands, x and y once each.
    ``band_itemsize`` is the bands' storage (1 for int8, 2 for bf16),
    default ``itemsize``."""
    b = itemsize if band_itemsize is None else band_itemsize
    return n_diags * n * b + 2 * n * itemsize


def ell_bytes(n: int, k: int, itemsize: int = 4) -> int:
    """ELL SpMV: the values and int32 columns, x and y."""
    return k * n * (itemsize + 4) + 2 * n * itemsize


def spmv_report(seconds: float, nnz: int, bytes_algorithmic: int, device=None
                ) -> SpmvReport:
    """A :class:`SpmvReport` of an SpMV on ``device`` (default: the current
    CUDA device, or the CPU without CUDA)."""
    chip = detect_chip(device)
    return SpmvReport(seconds=seconds, nnz=nnz, bytes_algorithmic=bytes_algorithmic,
                      chip=chip, peak_bytes_per_s=hbm_bytes_per_s(chip))


# --- spans -------------------------------------------------------------------
# One host thread's spans, kept in memory.  Off, span() returns a shared
# object that does nothing, after one check of _on: no clock read, no record.
SPAN_CAP = 1 << 20   # records kept until reset_spans(); later ones are dropped


class Span(NamedTuple):
    """A recorded span: ``time.time_ns()`` at its start and end, the index
    of the enclosing span in :func:`spans` (−1 for none) and the sequence
    number of the enclosing ``solve`` span (−1 outside any)."""

    name: str
    start_ns: int
    end_ns: int
    parent: int
    solve_id: int


_on = False
_records: list = []   # [name, start_ns, end_ns, parent, solve_id]
_open: list = []      # (index, solve_id) of each open span, innermost last
_solves = 0           # solve spans begun since the last reset
_dropped = 0          # spans past SPAN_CAP since the last reset


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global _solves, _dropped
        parent, solve_id = _open[-1] if _open else (-1, -1)
        if self.name == "solve":
            solve_id, _solves = _solves, _solves + 1
        if len(_records) < SPAN_CAP:
            index = len(_records)
            _records.append([self.name, time.time_ns(), 0, parent, solve_id])
        else:
            index = -1
            _dropped += 1
        _open.append((index, solve_id))
        return None

    def __exit__(self, *exc):
        index, _ = _open.pop()
        if index >= 0:
            _records[index][2] = time.time_ns()
        return False


def span(name: str):
    """``with span("precond"): ...`` records the block as a span while
    :func:`spans_on` is active; otherwise it does nothing."""
    if not _on:
        return _NO_SPAN
    return _Span(name)


@contextlib.contextmanager
def spans_on():
    """Record spans inside the block (:func:`spans` reads them)."""
    global _on
    was, _on = _on, True
    try:
        yield
    finally:
        _on = was


def spans() -> List[Span]:
    """The spans recorded since the last :func:`reset_spans`, in the order
    they began (a span still open has ``end_ns`` 0)."""
    return [Span(*r) for r in _records]


def dropped_spans() -> int:
    """Spans not recorded since the last :func:`reset_spans`: the list was
    full (:data:`SPAN_CAP`)."""
    return _dropped


def reset_spans() -> None:
    """Forget the recorded spans and restart the solve numbering."""
    global _solves, _dropped
    if _open:
        raise RuntimeError("reset_spans() inside an open span")
    _records.clear()
    _solves = _dropped = 0


@contextlib.contextmanager
def trace(logdir: str):
    """``with trace(logdir) as path: run_solve()`` profiles the CPU and,
    where CUDA is present, the card, with the program's spans on, and
    writes a Chrome trace (for chrome://tracing or Perfetto) to ``path``,
    ``trace.json`` in ``logdir``: the profiler's events and each span
    recorded in the block as a complete event (``cat`` "span") on the
    profiler's timeline."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace.json")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    first = len(_records)
    with profile(activities=activities) as prof:
        with spans_on():
            yield path
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    with open(path) as f:
        data = json.load(f)
    base = data.get("baseTimeNanoseconds", 0)   # the trace's ts: µs after it
    pid = os.getpid()
    for i, s in enumerate(spans()[first:], first):
        data["traceEvents"].append({
            "ph": "X", "cat": "span", "name": s.name, "pid": pid, "tid": "spans",
            "ts": (s.start_ns - base) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
            "args": {"index": i, "parent": s.parent, "solve_id": s.solve_id}})
    with open(path, "w") as f:
        json.dump(data, f)
