"""Persisted tuning: the dot kernels' grid and the layout choices of
``optimize(measure=True)``.

Counterpart of ``sprsolve_tpu/utils/tuning.py``: a measured winner
persists across processes, keyed by the device's name, so a sweep is paid
once per shape class, not per run.

- :func:`tune_padded_dia` / :func:`tune_complex_padded_dia` time the
  candidate grids of the single-launch dot kernels (K2/K3 and K6/K7) on the
  device, persist the winner and return the tuned operator.  The knob is
  what those kernels take at run time: the blocks per SM of their
  persistent grid (``dot_blocks_per_sm``; ``persistent_grid`` in
  ``ops/padded_dia.py``).  The JAX package tunes the TPU's (lanes,
  block_rows) tile, which has no counterpart here.  K1, K1b and K5 launch
  at tile sizes fixed when they are compiled (ROW_TILE and SPMM_THREADS in
  ``csrc/dia_spmv.cu``, the row tile of ``csrc/dia_complex.cu``), as do
  the dot kernels' own tiles (DOT_TILE, CDOT_TILE), so none of those is
  tuned.  Every candidate gives bitwise the same y and dots: the dot
  kernels sum per-tile partials in tile order, whatever the grid.
- ``PaddedDIA.from_dia`` / ``ComplexPaddedDIA.from_dia`` take the cached
  grid when the caller passes none; an explicit setting wins; with no
  entry the kernels' default applies.
- The layout half (``:35-73, 118-184`` there): the winning layout of a
  sparsity pattern, keyed by its signature and the dtype.

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


def _dtype_name(dtype) -> str:
    """``"float32"``, ``"complex128"``, ... of a torch or NumPy dtype."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return np.dtype(dtype).name


def _bucket(n: int) -> int:
    """Size bucket: the next power of two, so one entry serves a 2× range."""
    return 1 << max(int(n) - 1, 0).bit_length()


def _key(kind: str, dtype, nbands: int, n: int, device) -> str:
    return f"{kind}|{_device_kind(device)}|{_dtype_name(dtype)}|b{nbands}|n{_bucket(n)}"


def lookup(kind: str, dtype, nbands: int, n: int, device) -> Optional[dict]:
    """The persisted dot-kernel grid of this shape class on ``device``
    (``{"blocks_per_sm": k, ...}``), or None. ``kind`` is ``"dia"`` for
    K2/K3, ``"cdia"`` for K6/K7; ``dtype`` the vectors' dtype."""
    ent = _load().get(_key(kind, dtype, nbands, n, device))
    if isinstance(ent, dict) and isinstance(ent.get("blocks_per_sm"), int) \
            and ent["blocks_per_sm"] >= 1:
        return ent
    return None


def store(kind: str, dtype, nbands: int, n: int, device, config: dict,
          metric_gnnz_s: float) -> None:
    data = _load()
    data[_key(kind, dtype, nbands, n, device)] = {
        "blocks_per_sm": int(config["blocks_per_sm"]),
        "gnnz_s": round(float(metric_gnnz_s), 3),
        "tuned_at": int(time.time())}
    _save(data)


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


# --- the dot kernels' grid ---------------------------------------------------
# candidate blocks per SM of a dot kernel's grid; the kernels' defaults
# (DOT_BLOCKS_PER_SM: 8 f32, 4 f64 and c64, 3 c128) are among them
GRID_CANDIDATES = (1, 2, 3, 4, 6, 8)


def _sweep(kind: str, build, n: int, nnz: int, candidates, iters: int, verbose: bool):
    """Build each candidate's operator (``build(blocks_per_sm)``; one that
    raises ValueError is skipped), time its two dot-kernel calls
    (:func:`~sprsolve_tpu_torch.utils.timing.time_fn`), check that its y
    and dots equal the first candidate's bit for bit, persist the fastest
    and return it; None when no candidate survives."""
    from .timing import time_fn

    best, ref = None, None
    for bps in candidates:
        try:
            op = build(bps)
        except ValueError as e:
            if verbose:
                print(f"  blocks_per_sm={bps}: skipped ({e})")
            continue
        x = _probe(op)
        dinv = op.jacobi_precond().diag_inv
        wdot = op.matvec_wdot_cprec if kind == "cdia" else op.matvec_wdot_prec

        def step(v, op=op, wdot=wdot, dinv=dinv):
            # the dot form a MINRES/CG step takes, then BiCGStab's folded one
            y, _ = op.matvec_dot(v)
            return wdot(y, y, dinv)[0]

        out = (*op.matvec_dot(x), *wdot(x, x, dinv))
        if ref is None:
            ref = out
        elif not all(torch.equal(a, b) for a, b in zip(out, ref)):
            raise RuntimeError(f"{kind}: blocks_per_sm={bps} changes y or a dot; the "
                               "dot kernels must not depend on their grid")
        t = time_fn(step, x, iters=iters)
        if verbose:
            pair = "K3+K2" if kind == "dia" else "K6+K7"
            print(f"  blocks_per_sm={bps}: {t * 1e6:.3f} us per {pair} pair")
        if best is None or t < best[0]:
            best = (t, bps, op)
    if best is None:
        return None
    t, bps, op = best
    store(kind, op.dtype, len(op.offsets), n, op.device, {"blocks_per_sm": bps},
          2 * nnz / t / 1e9)
    return op


def _probe(op) -> torch.Tensor:
    """A seeded normal padded vector of ``op``'s dtype on its device."""
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal(op.n))
    if op.dtype.is_complex:
        x = torch.complex(x, torch.as_tensor(rng.standard_normal(op.n)))
    return op.pad_vec(x.to(op.dtype).to(op.device))


def tune_padded_dia(m, candidates=GRID_CANDIDATES, iters: int = 50,
                    verbose: bool = False, device=None):
    """Time K3 and the Jacobi-folded K2 of the real DIA matrix ``m`` at each
    candidate ``dot_blocks_per_sm`` on ``device`` (default: the CUDA
    device), persist the fastest, return its ``PaddedDIA``.

    A candidate that is not a positive integer is skipped; with none left,
    the kernels' default operator comes back and nothing is stored."""
    from ..ops.optimize import default_device
    from ..ops.padded_dia import PaddedDIA

    device = default_device(device)
    nnz = sum(m.shape[0] - abs(o) for o in m.offsets)
    op = _sweep("dia", lambda bps: PaddedDIA.from_dia(m, device=device,
                                                      dot_blocks_per_sm=bps),
                m.shape[0], nnz, candidates, iters, verbose)
    return op if op is not None else PaddedDIA.from_dia(m, device=device)


def tune_complex_padded_dia(m, candidates=GRID_CANDIDATES, iters: int = 50,
                            verbose: bool = False, device=None):
    """:func:`tune_padded_dia` for a complex DIA matrix: K6 and the
    complex-Jacobi-folded K7, a ``ComplexPaddedDIA``."""
    from ..ops.optimize import default_device
    from ..ops.padded_dia import ComplexPaddedDIA

    device = default_device(device)
    nnz = sum(m.shape[0] - abs(o) for o in m.offsets)
    op = _sweep("cdia", lambda bps: ComplexPaddedDIA.from_dia(m, device=device,
                                                              dot_blocks_per_sm=bps),
                m.shape[0], nnz, candidates, iters, verbose)
    return op if op is not None else ComplexPaddedDIA.from_dia(m, device=device)
