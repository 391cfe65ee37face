"""Frozen byte models of the port's hand-written kernels, and the card's peak.

The models are copies of the port's own as the benchmark was defined
(``sprsolve_tpu_torch/utils/timing.py:dia_bytes`` and ``chip_smoke.py``'s
``nbytes``/``orth_norm_bytes``), kept here so that a change to the program
cannot move the yardstick.  Each input byte is counted once and each output
byte once, whatever a kernel reads again.

:func:`launch_bytes` maps one kernel launch, named as the profiler names it,
to the bytes that launch needs, from the operator's :class:`Geometry`.  The
template flags in the name (``HAS_DINV``, ``W_IS_X``, ``YY``) say which
vectors a launch reads, so K2 with w = r0 and K2 with w = x are told apart.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Optional, Tuple

# published memory rate of each card, bytes per second (NVIDIA's data sheet;
# the H100 SXM part at its 700 W limit)
HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}


def dia_bytes(n: int, n_diags: int, itemsize: int = 4,
              band_itemsize: Optional[int] = None) -> int:
    """Least traffic of a DIA SpMV: the bands, x and y once each.
    ``band_itemsize`` is the bands' storage (1 for int8, 2 for bf16),
    default ``itemsize``."""
    b = itemsize if band_itemsize is None else band_itemsize
    return n_diags * n * b + 2 * n * itemsize


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def orth_norm_bytes(a, h: int) -> int:
    """Bytes K4 moves on padded vectors like ``a`` with halo ``h``: the body
    rows of a, v_old and v read once, all of v₊ (halos too) written once."""
    return (3 * (a.numel() - 2 * h) + a.numel()) * a.element_size()


@dataclass(frozen=True)
class _Shaped:
    """A stand-in with a tensor's ``numel``/``element_size``, so the frozen
    models above count bytes from shapes alone."""
    n: int
    itemsize: int

    def numel(self) -> int:
        return self.n

    def element_size(self) -> int:
        return self.itemsize


@dataclass(frozen=True)
class Geometry:
    """What the byte models need of a padded operator: ``n_pad`` body rows,
    halo ``h``, ``nd`` diagonals, the storage of each band plane (one plane
    for a real operator, re and im for a complex one) and of a vector entry."""
    n_pad: int
    h: int
    nd: int
    band_itemsizes: Tuple[int, ...]
    vec_itemsize: int

    @property
    def vec(self) -> _Shaped:
        return _Shaped(self.n_pad + 2 * self.h, self.vec_itemsize)

    @property
    def planes(self) -> Tuple[_Shaped, ...]:
        return tuple(_Shaped(self.nd * self.n_pad, b) for b in self.band_itemsizes)


# kernel family → (kernel label, number of trailing bool template flags)
_FAMILIES = {
    "dia_spmv_kernel": ("K1", 0),
    "dia_spmv_kernel_rows": ("K1", 0),
    "dia_dots_kernel": ("K2/K3", 3),          # HAS_DINV, W_IS_X, YY
    "orth_norm_kernel": ("K4", 0),
    "dia_complex_spmv_kernel": ("K5", 0),
    "dia_complex_dots_kernel": ("K6/K7", 4),  # CONJ_X, HAS_DINV, W_IS_X, YY
    "dia_spmm_kernel": ("K1b", 0),
}
_ANON = "(anonymous namespace)::"


def parse_kernel(name: str) -> Optional[Tuple[str, str, Tuple[bool, ...]]]:
    """``(family, label, flags)`` of a hand-kernel launch named as the
    profiler names it (demangled, ``void (anonymous namespace)::
    dia_dots_kernel<float, signed char, true, false, true>(...)``, or
    mangled), else None."""
    if name.startswith("_Z"):
        found = [(name.find(f"{len(f)}{f}"), f) for f in _FAMILIES]
        found = [(i + len(f"{len(f)}{f}"), f) for i, f in found if i >= 0]
        if not found:
            return None
        end, family = max(found)   # the longest family whose mangled name is there
        if name[end:end + 1] not in ("I", "E", "v", ""):
            return None
        flags = tuple(f == "1" for f in re.findall(r"Lb([01])E", name[end:].split("EE", 1)[0]
                                                    + "E"))
    else:
        head = name.replace(_ANON, "").split("(", 1)[0].strip()
        m = re.search(r"(\w+)\s*(?:<([^<>]*)>)?\s*$", head)
        if not m or m.group(1) not in _FAMILIES:
            return None
        family = m.group(1)
        args = [a.strip() for a in (m.group(2) or "").split(",")]
        flags = tuple(a == "true" for a in args if a in ("true", "false"))
    label, nflags = _FAMILIES[family]
    if len(flags) < nflags:
        return None
    flags = flags[len(flags) - nflags:] if nflags else ()
    if label == "K2/K3":
        label = "K2" if flags[2] else "K3"
    elif label == "K6/K7":
        label = "K7" if flags[3] else "K6"
    return family, label, flags


def launch_bytes(name: str, g: Geometry) -> Optional[int]:
    """Bytes one launch of the kernel ``name`` needs on an operator of
    geometry ``g`` (the frozen models above), or None where the name is no
    hand kernel or its bytes depend on what the name does not say (K1b's
    block width)."""
    parsed = parse_kernel(name)
    if parsed is None:
        return None
    _, label, flags = parsed
    x = y = g.vec
    if label == "K1":
        (bands,) = g.planes
        return nbytes(bands, x, y)
    if label in ("K2", "K3"):
        has_dinv, w_is_x, yy = flags
        (bands,) = g.planes
        extra = ([g.vec] if has_dinv else []) + ([g.vec] if yy and not w_is_x else [])
        return nbytes(bands, x, y, *extra)
    if label == "K4":
        return orth_norm_bytes(g.vec, g.h)
    if label == "K5":
        return nbytes(*g.planes, x, y)
    if label in ("K6", "K7"):
        _, has_dinv, w_is_x, yy = flags
        extra = ([g.vec] if has_dinv else []) + ([g.vec] if yy and not w_is_x else [])
        return nbytes(*g.planes, x, y, *extra)
    return None
