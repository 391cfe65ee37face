"""The traced stretch of a run: ``torch.profiler`` kept in memory, reduced
to a summary that the per-layer readers read.

The stretch opens and closes with a one-element fill on the device after a
synchronise, so the traced window runs from the first fill's start to the
last one's end on the device's clock; the fills themselves are left out of
every sum.  ``host=False`` traces the device alone (CUPTI activity, no host
op events, which would slow the host that paces the solves); ``host=True``
traces the host's ops beside it, to name the idle gaps.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Callable

TOP = 10                       # entries of each breakdown list
_COPY_PREFIXES = ("Memcpy", "Memset", "memcpy", "memset")


def short_name(name: str) -> str:
    """A kernel's name without its argument list and leading ``void``."""
    head = name.replace("(anonymous namespace)::", "").split("(", 1)[0].strip()
    return head[5:] if head.startswith("void ") else head


def is_kernel(name: str) -> bool:
    return not name.startswith(_COPY_PREFIXES)


def merged(intervals):
    """Sorted, disjoint union of ``[(start, end)]``."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _events(prof):
    """``(device, host)``: ``[(name, start_us, end_us)]`` of the device's
    events and of the host's op events."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.events():
        rec = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == DeviceType.CUDA:
            dev.append(rec)
        elif e.device_type == DeviceType.CPU:
            host.append(rec)
    return dev, host


def _gap_owner(starts, host, mid: float, reach: int = 512) -> str:
    """The innermost host op that covers ``mid``: the latest-starting one
    whose span holds it (host ops nest), else ``host (no op)``."""
    i = bisect.bisect_right(starts, mid) - 1
    for j in range(i, max(i - reach, -1), -1):
        name, a, b = host[j]
        if b >= mid:
            return name
    return "host (no op)"


def summarize(dev, host, wall_s: float) -> dict:
    """The summary of one traced stretch from its events (µs)."""
    dev = sorted(dev, key=lambda r: r[1])
    if len(dev) >= 2:
        (_, w0, _), (_, _, w1) = dev[0], dev[-1]
        dev = [(n, max(a, w0), min(b, w1)) for n, a, b in dev[1:-1] if b > w0 and a < w1]
        window_us = w1 - w0
    else:   # no device (a CPU run): the host's clock, nothing busy
        dev, w0, w1, window_us = [], 0.0, wall_s * 1e6, wall_s * 1e6
    busy = merged((a, b) for _, a, b in dev)
    kernels = defaultdict(lambda: [0, 0.0])
    by_short = defaultdict(float)
    for name, a, b in dev:
        kernels[name][0] += 1
        kernels[name][1] += (b - a) * 1e-6
        by_short[short_name(name)] += (b - a) * 1e-6
    out = {
        "window_s": window_us * 1e-6,
        "busy_s": sum(b - a for a, b in busy) * 1e-6,
        "n_events": len(dev),
        "n_kernels": sum(c for name, (c, _) in kernels.items() if is_kernel(name)),
        "kernels": {k: v for k, v in kernels.items()},
        "device_ops": [[k, v] for k, v in sorted(by_short.items(), key=lambda kv: -kv[1])[:TOP]],
        "idle_gaps": [],
    }
    if host:
        host = sorted(host, key=lambda r: r[1])
        starts = [a for _, a, _ in host]
        edges = [w0] + [x for iv in busy for x in iv] + [w1]
        gaps = defaultdict(float)
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                gaps[_gap_owner(starts, host, (a + b) / 2)] += (b - a) * 1e-6
        out["idle_gaps"] = [[k, v] for k, v in
                            sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]]
    return out


def profile(body: Callable[[], None], device, host: bool) -> dict:
    """Run ``body`` under the profiler between two marker fills and return
    :func:`summarize`'s summary."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    cuda = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)
    acts = [ProfilerActivity.CUDA] if cuda else []
    if host or not cuda:
        acts.append(ProfilerActivity.CPU)
    sync()
    t = time.perf_counter()
    with tprofile(activities=acts) as prof:
        torch.full((1,), 1.0, device=device)
        sync()
        body()
        sync()
        torch.full((1,), 1.0, device=device)
        sync()
    wall = time.perf_counter() - t
    dev, host_ops = _events(prof)
    return summarize(dev, host_ops if host else [], wall)
