"""Persisted layout choices of ``optimize(measure=True)``.

The layout half of ``sprsolve_tpu/utils/tuning.py`` (``:35-73, 118-184``):
a measured winner persists across processes, keyed by the sparsity
pattern's signature, the dtype and the device, so re-running the same
problem skips the measurement pass.  (The kernel-geometry autotune is
``ROADMAP.md`` Queue 1 item 12.)

Cache location: ``$SPRSOLVE_TUNE_CACHE`` or
``~/.cache/sprsolve_tpu_torch/autotune.json``.  Writes are atomic (a
temporary file renamed into place); a corrupt or unreadable file reads as
empty.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Optional

import numpy as np
import torch


def _cache_path() -> str:
    return os.environ.get("SPRSOLVE_TUNE_CACHE") or os.path.join(
        os.path.expanduser("~"), ".cache", "sprsolve_tpu_torch", "autotune.json")


def _load() -> dict:
    try:
        with open(_cache_path()) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return {}
    return data if isinstance(data, dict) else {}


def _save(data: dict) -> None:
    path = _cache_path()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(data, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


def _device_kind(device) -> str:
    """The card's name (``torch.cuda.get_device_name``) for a CUDA device,
    else the device type."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device).replace(" ", "_")
    return device.type


def pattern_sig(n: int, nnz: int, indptr, indices) -> str:
    """Stable 16-hex signature of a sparsity pattern (its size and a
    sample of its structure)."""
    h = hashlib.blake2b(digest_size=8)
    h.update(np.asarray([n, nnz], np.int64).tobytes())
    ip = np.asarray(indptr, np.int64)
    ix = np.asarray(indices, np.int64)
    h.update(np.ascontiguousarray(ip[:: max(1, len(ip) // 64)]).tobytes())
    h.update(np.ascontiguousarray(ix[:: max(1, len(ix) // 64)]).tobytes())
    return h.hexdigest()


def _layout_key(sig: str, dtype, device) -> str:
    return f"layout|{_device_kind(device)}|{np.dtype(dtype).name}|{sig}"


def lookup_layout(sig: str, dtype, device) -> Optional[str]:
    """The persisted winning layout label for this pattern, or None."""
    ent = _load().get(_layout_key(sig, dtype, device))
    if isinstance(ent, dict) and "label" in ent:
        return str(ent["label"])
    return None


def store_layout(sig: str, dtype, device, label: str, gnnz_s: float) -> None:
    data = _load()
    data[_layout_key(sig, dtype, device)] = {
        "label": str(label), "gnnz_s": round(float(gnnz_s), 3),
        "tuned_at": int(time.time())}
    _save(data)


def _sync(x: torch.Tensor) -> None:
    if x.is_cuda:
        torch.cuda.synchronize(x.device)


def _time_step(step, x: torch.Tensor, iters: int) -> float:
    """Seconds per apply of a chain x ← step(x) of ``iters`` applies, the
    better of two chains after a warm-up of 2, each ending in a CUDA
    synchronise on a card. ``step`` must keep the shape; scale inside it to
    keep float32 from overflowing."""
    def run(k):
        v = x
        for _ in range(k):
            v = step(v)
        _sync(v)

    run(2)
    ts = []
    for _ in range(2):
        t0 = time.perf_counter()
        run(iters)
        ts.append(time.perf_counter() - t0)
    return max(min(ts) / iters, 1e-12)
