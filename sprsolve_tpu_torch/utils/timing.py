"""Timing, profiling and roofline reports.

Counterpart of ``sprsolve_tpu/utils/timing.py``:

- :func:`time_fn` — seconds per call of a callable: on a CUDA device the
  calls are captured in a CUDA graph and replayed between CUDA events (the
  kernels' own time, no launch overhead: the counterpart of chaining the
  calls inside one ``jax.jit``); on the CPU a synchronised wall clock.
- :func:`spmv_report` — nnz/s, achieved bandwidth and the share of the
  card's memory rate for one SpMV.
- :func:`trace` — a ``torch.profiler`` context that writes a Chrome trace.

The memory rate of a card comes from :data:`HBM_BYTES_PER_S`, keyed by the
device name (``torch.cuda.get_device_name``); a card not in the table is
measured with a device-to-device copy (:func:`copy_bytes_per_s`).  A CPU
run reports no roofline share.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import tempfile
import time
from dataclasses import dataclass
from typing import Callable, Optional

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


def copy_bytes_per_s(device, nbytes: int = 1 << 30) -> float:
    """Bytes per second of a device-to-device copy of ``nbytes`` (read and
    written once each) on the CUDA ``device``, by :func:`time_fn`."""
    src = torch.empty(nbytes // 2, dtype=torch.uint8, device=device)
    dst = torch.empty_like(src)
    return 2 * src.numel() / time_fn(dst.copy_, src, iters=5)


def hbm_bytes_per_s(chip: str, device=None) -> Optional[float]:
    """The memory rate a roofline share divides by: the published rate of
    ``chip`` where :data:`HBM_BYTES_PER_S` has it, else a copy's measured
    rate on ``device`` (default: the current CUDA device); None for the
    CPU."""
    if chip == "cpu":
        return None
    if chip in HBM_BYTES_PER_S:
        return HBM_BYTES_PER_S[chip]
    return copy_bytes_per_s(device if device is not None else torch.device("cuda"))


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
                      chip=chip, peak_bytes_per_s=hbm_bytes_per_s(chip, device))


@contextlib.contextmanager
def trace(logdir: Optional[str] = None):
    """``with trace() as path: run_solve()`` profiles the CPU and, where
    CUDA is present, the card, and writes a Chrome trace (for
    chrome://tracing or Perfetto) to ``path``: ``trace.json`` in
    ``logdir``, by default a ``sprsolve_tpu_torch_trace`` directory in the
    system's temporary directory."""
    from torch.profiler import ProfilerActivity, profile

    logdir = logdir or os.path.join(tempfile.gettempdir(), "sprsolve_tpu_torch_trace")
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace.json")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield path
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
