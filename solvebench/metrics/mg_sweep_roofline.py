"""The multigrid colour steps' share of their bound, in %: Σ least time
over Σ device time of the ``gs_color_step_kernel`` launches in the
device-only traced stretch.  Least bytes per apply of the V-cycle from
``mg_byte_models.apply_bytes`` (the fine geometry and the halving) over the
card's published memory rate, times the applies (CG applies M once a
solve and once an iteration).  The first steps, one a level, give the
level count.  Nothing unless the traced launches, first steps and others
apart, are the applies times each apply's."""

from solvebench import byte_models, mg_byte_models


def read(s: dict):
    t = s.get("trace", {}).get("device")
    geom = s.get("trace", {}).get("geometry")
    peak = byte_models.HBM_BYTES_PER_S.get(s.get("device_kind", ""))
    if not t or geom is None or peak is None:
        return None
    counts, spent = {True: 0, False: 0}, 0.0
    for name, (count, seconds) in t["kernels"].items():
        first = mg_byte_models.parse(name)
        if first is not None:
            counts[first] += count
            spent += seconds
    applies = t["iterations"] + t["solves"]
    if not applies or spent <= 0 or counts[True] % applies:
        return None
    levels = counts[True] // applies
    steps = mg_byte_models.apply_launches(geom, levels) if levels else None
    if steps is None or counts[False] != applies * (steps - levels):
        return None
    return 100.0 * applies * mg_byte_models.apply_bytes(geom, levels) / peak / spent
