"""The hand-written kernels' share of their bound, in %: Σ least time over
Σ device time of every hand-kernel launch in the device-only traced stretch.
A launch's least time is its bytes (``byte_models.launch_bytes``, from its
name and the operator's geometry) over the card's published memory rate.
Nothing where the stretch has no hand kernel, where a hand kernel's bytes
are not modelled, or where the profiler's launches disagree with the
program's launch counters."""

from solvebench import byte_models


def read(s: dict):
    t = s.get("trace", {}).get("device")
    geom = s.get("trace", {}).get("geometry")
    peak = byte_models.HBM_BYTES_PER_S.get(s.get("device_kind", ""))
    if not t or geom is None or peak is None:
        return None
    launches, bound, spent = 0, 0.0, 0.0
    for name, (count, seconds) in t["kernels"].items():
        if byte_models.parse_kernel(name) is None:
            continue
        nb = byte_models.launch_bytes(name, geom)
        if nb is None:
            return None
        launches += count
        bound += count * nb / peak
        spent += seconds
    if not launches or launches != t.get("launches") or spent <= 0:
        return None
    return 100.0 * bound / spent
