"""Operator optimization: pick the execution layout for a matrix.

Counterpart of ``sprsolve_tpu/ops/optimize.py:67-302`` (the inspector half
of MKL's inspector-executor flow): the pattern is analysed once on the host,
and every SpMV then runs in the chosen layout.  In order:

1. At most ``max_diags`` distinct diagonals: a float32 or float64 matrix
   becomes a :class:`PaddedDIA` (kernels K1-K4), a complex64 or complex128
   one a :class:`ComplexPaddedDIA` (K5-K7), any other (or with
   ``prefer_kernels=False``) a :class:`DIA` (torch ops).
2. Otherwise RCM-reorder and count again: a matrix banded after RCM takes
   the same layouts inside a :class:`Reordered` wrapper (the permutations
   run at the solve boundary only).
3. Otherwise the cost model ranks wide DIA (torch shifted slices), BSR
   (:class:`ComplexBSR` for complex data) and the band+outlier
   :class:`HybridDIA`, on both the original and the RCM pattern, by
   predicted time: the bytes per nonzero each layout moves over the share
   of the HBM rate that layout reaches on the card (:data:`COSTS`), plus
   the sidecar's elements at their measured price.  The fastest that fits
   ``mem_limit_bytes`` is built; ``measure=True`` times the candidates
   instead.
4. Otherwise ELL, with a RuntimeWarning.

The analysis (diagonal counts, RCM) runs on the compiled host toolkit
(:mod:`..native`).  The BSR apply and the hybrid's sidecar are torch ops,
as the JAX package computes them with XLA ops, not Pallas kernels.  A
banded float64 or complex128 matrix takes the kernels too, in its own
dtype: the JAX package sends it to XLA's DIA only because its TPU kernels
have no f64 lowering (``sprsolve_tpu/ops/optimize.py:152-155``), and the
CUDA kernels have no such limit.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from .. import native
from ..sparse.bsr import BSR, ComplexBSR
from ..sparse.containers import CSR, DIA, ELL, _host, reorder_rcm
from .hybrid import HybridDIA, split_offsets
from .padded_dia import COMPLEX_DTYPES, REAL_DTYPES, ComplexPaddedDIA, PaddedDIA
from .reordered import Reordered

# block sizes the BSR cost model tries (those of the JAX package)
_BSR_SIZES = (128, 64, 32, 16, 8)

# The cost model's constants, measured on an NVIDIA H100 80GB HBM3 at a
# 700.00 W power limit by chip_smoke.py phase 12 (1M rows, f32, cold in
# L2, graph-replayed): eff_* is the share of 3.35 TB/s each path reaches on
# the bytes the model counts for it (DIA: (diagonals + 2)·n values; BSR:
# blocks·(bs² + 2·bs) values), on the spiked 100³ Poisson's 127-diagonal
# torch DIA (1.2509 ms), the scrambled 100³ Poisson's BSR-8 (2.0519 ms)
# and the scrambled 2²⁰-row chain's 5-diagonal PaddedDIA through K1
# (0.01456 ms); scatter_bytes_eq is the time of one sidecar element in
# bytes at 3.35 TB/s: 3.35e12 over the 3.383e10 elements per second of a
# 2²⁰-element gather, multiply and index_add_.
COSTS = {
    "eff_dia": 0.1231,
    "eff_bsr": 0.0625,
    "eff_padded_dia": 0.6018,
    "scatter_bytes_eq": 99.03,
}


def default_device(device) -> torch.device:
    """``device`` as given, else the CUDA device: the entry points run on the
    card unless the caller asks for the CPU. Raises RuntimeError when no
    device was given and CUDA is absent, rather than solving on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: sprsolve_tpu_torch runs on the GPU by default; "
            "pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda")


def count_diagonals(m: CSR) -> int:
    """Number of distinct offsets col − row (the host toolkit's
    ``csr_count_diagonals``)."""
    return native.csr_count_diagonals(m.shape[0], _host(m.indptr), _host(m.indices))


def _dia_operator(m: CSR, max_diags: int, prefer_kernels: bool, device):
    """The banded fast path: f32/f64 → PaddedDIA (kernels K1-K4), c64/c128 →
    ComplexPaddedDIA (K5-K7), else (or without ``prefer_kernels``) DIA."""
    if prefer_kernels and m.dtype in COMPLEX_DTYPES:
        return ComplexPaddedDIA.from_csr(m, device=device)
    if prefer_kernels and m.dtype in REAL_DTYPES:
        dia = DIA.from_csr(m, max_diags=max_diags, device="cpu")
        return PaddedDIA.from_dia(dia, device=device)
    return DIA.from_csr(m, max_diags=max_diags, device=device)


def _hybrid_stats(m: CSR, max_diags: int):
    """(core diagonal count, outlier count) of the split
    :meth:`HybridDIA.from_csr` makes, offset 0 included (the JAX package's
    ``_hybrid_stats``, ``optimize.py:78-89``, leaves it out)."""
    kept, n_bands = split_offsets(m, max_diags)
    return max(n_bands, 1), int((~kept).sum())


def _bsr_cost(m: CSR, itemsize: int, mem_limit: int):
    """(bytes per nnz, bs) of the cheapest BSR blocking, or (inf, 0)."""
    best = (float("inf"), 0)
    for bs in _BSR_SIZES:
        nblk = BSR.estimate_blocks(m, bs)
        if nblk * bs * bs * itemsize > mem_limit:
            continue
        # traffic per SpMV: blocks + gathered x blocks + row-summed products
        bpn = nblk * (bs * bs + 2 * bs) * itemsize / m.nnz
        if bpn < best[0]:
            best = (bpn, bs)
    return best


def _wrap(inner, perm):
    return inner if perm is None else Reordered.wrap(inner, perm)


def candidates_of(m: CSR, perm, n_diags: int, tag: str, *, max_diags: int,
                  prefer_kernels: bool, allow_bsr: bool, allow_hybrid: bool,
                  wide_diags: int, mem_limit_bytes: int, device):
    """The cost model's candidates for one pattern (``m``, RCM-permuted by
    ``perm`` or not): ``[(score, label, build)]``, the score each
    layout's bytes per nnz over its path's share of the HBM rate
    (:data:`COSTS`), the hybrid's sidecar elements at their price on top."""
    n, nnz = m.shape[0], m.nnz
    itemsize = _host(m.data).dtype.itemsize
    out = []
    if n_diags <= wide_diags and n_diags * n * itemsize <= mem_limit_bytes:
        bpn = (n_diags + 2) * n * itemsize / nnz
        out.append((bpn / COSTS["eff_dia"], f"dia{n_diags}{tag}",
                    lambda: _wrap(DIA.from_csr(m, max_diags=n_diags, device=device), perm)))
    if allow_bsr:
        bpn, bs = _bsr_cost(m, itemsize, mem_limit_bytes)
        if bs:
            cls = ComplexBSR if m.dtype.is_complex else BSR
            out.append((bpn / COSTS["eff_bsr"], f"bsr{bs}{tag}",
                        lambda: _wrap(cls.from_csr(m, bs=bs, device=device), perm)))
    if allow_hybrid:
        nd_core, n_out = _hybrid_stats(m, max_diags)
        cap = max(4096, nnz // 100)
        if 0 < n_out <= cap:
            kernel_core = prefer_kernels and m.dtype in REAL_DTYPES
            eff_core = COSTS["eff_padded_dia" if kernel_core else "eff_dia"]
            score = ((nd_core + 2) * n * itemsize / nnz / eff_core
                     + COSTS["scatter_bytes_eq"] * n_out / nnz)
            out.append((score, f"hybrid{nd_core}+{n_out}{tag}",
                        lambda: _wrap(HybridDIA.from_csr(
                            m, max_diags=max_diags, max_outliers=cap,
                            prefer_kernels=prefer_kernels, device=device), perm)))
    return out


def optimize(
    m: CSR,
    *,
    max_diags: int = 32,
    prefer_kernels: bool = True,
    allow_reorder: bool = True,
    allow_bsr: bool = True,
    allow_hybrid: bool = True,
    wide_diags: int = 192,
    mem_limit_bytes: int = 4 << 30,
    measure: bool = False,
    measure_iters: int = 30,
    device=None,
):
    """Analyze ``m`` and return the operator for repeated SpMV, on ``device``
    (default: the CUDA device; see :func:`default_device`).

    Returns a DIA, PaddedDIA, ComplexPaddedDIA, BSR, ComplexBSR or
    HybridDIA, possibly inside a :class:`Reordered`, or an ELL as the warned
    last resort. An operator with ``pad_vec``/``unpad_vec`` works in a
    vector layout of its own (``solve()`` converts at the boundary).

    ``max_diags`` bounds the banded kernels' diagonal count and
    ``wide_diags`` the wide-DIA candidate's; ``mem_limit_bytes`` caps any
    layout's storage. ``prefer_kernels=False`` keeps a banded matrix on the
    plain ``DIA`` path (torch ops, flat vectors), the counterpart of the
    JAX package's ``prefer_pallas``; ``allow_reorder``, ``allow_bsr`` and
    ``allow_hybrid`` switch routes off.

    ``measure=True`` builds every candidate of step 3, times its SpMV
    (``measure_iters`` chained applies) on ``device`` and returns the
    fastest; the winner's label persists in the layout cache of
    :mod:`~sprsolve_tpu_torch.utils.tuning`, so the same pattern is not
    timed again."""
    device = default_device(device)
    n = m.shape[0]
    itemsize = _host(m.data).dtype.itemsize
    n_diags = count_diagonals(m)
    if n_diags <= max_diags:
        return _dia_operator(m, max_diags, prefer_kernels, device)

    mp = perm = None
    nd_perm = n_diags
    if allow_reorder:
        mp, perm = reorder_rcm(m)
        nd_perm = count_diagonals(mp)
        if nd_perm <= max_diags and nd_perm * n * itemsize <= mem_limit_bytes:
            return Reordered.wrap(_dia_operator(mp, max_diags, prefer_kernels, device), perm)

    candidates = []   # (score, label, build)
    for cm, cp, nd, tag in ((m, None, n_diags, ""), (mp, perm, nd_perm, "-rcm")):
        if cm is not None:
            candidates += candidates_of(
                cm, cp, nd, tag, max_diags=max_diags, prefer_kernels=prefer_kernels,
                allow_bsr=allow_bsr, allow_hybrid=allow_hybrid, wide_diags=wide_diags,
                mem_limit_bytes=mem_limit_bytes, device=device)
    if measure and len(candidates) > 1:
        return _measure_pick(m, candidates, measure_iters, device)
    if candidates:
        return min(candidates, key=lambda c: c[0])[2]()

    warnings.warn(
        f"optimize(): no structured layout found ({n_diags} diagonals, no "
        "block or band structure within the memory budget); falling back to "
        "the ELL gather SpMV, a scalar gather per entry that runs far below "
        "the card's memory rate. Consider a reordering or another "
        "preconditioner strategy.",
        RuntimeWarning,
        stacklevel=2,
    )
    return ELL.from_csr(m, device=device)


def _layout_step(inner, n: int, scale: float, device):
    """(step, x0) timing one candidate's SpMV as a shape-keeping chain."""
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal(n), device=device).to(inner.dtype)
    if inner.dtype.is_complex:
        x = x + 1j * torch.as_tensor(rng.standard_normal(n), device=device).to(inner.dtype)
    return (lambda v: inner.matvec(v) * scale), x


def _measure_pick(m: CSR, candidates, iters: int, device):
    """Build and time each candidate's SpMV on ``device`` and return the
    fastest; its label persists, keyed by the pattern signature, the dtype
    and the device. A label found in the cache is built without timing."""
    from ..utils import tuning

    n, nnz = m.shape[0], m.nnz
    data = _host(m.data)
    sig = tuning.pattern_sig(n, nnz, _host(m.indptr), _host(m.indices))
    by_label = {label: build for _, label, build in candidates}
    cached = tuning.lookup_layout(sig, data.dtype, device)
    if cached in by_label:
        return by_label[cached]()
    # keep 'iters' chained applies from overflowing: scale by a cheap upper
    # bound of ‖A‖∞
    rows_max = int(np.diff(_host(m.indptr)).max()) if n else 1
    ainf_ub = float(np.abs(data).max()) * max(rows_max, 1) if len(data) else 1.0
    scale = 0.5 / max(ainf_ub, 1e-30)
    best = None
    for _, label, build in candidates:
        op = build()
        inner = op.inner if isinstance(op, Reordered) else op
        step, x = _layout_step(inner, n, scale, device)
        t = tuning._time_step(step, x, iters)
        if best is None or t < best[0]:
            best = (t, label, op)
    t, label, op = best
    tuning.store_layout(sig, data.dtype, device, label, nnz / t / 1e9)
    return op
