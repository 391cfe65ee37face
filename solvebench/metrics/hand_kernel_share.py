"""The hand-written kernels' device time over all device time in the
device-only traced stretch, in %."""

from solvebench import byte_models


def read(s: dict):
    t = s.get("trace", {}).get("device")
    if not t:
        return None
    total = sum(sec for _, sec in t["kernels"].values())
    hand = sum(sec for name, (_, sec) in t["kernels"].items()
               if byte_models.parse_kernel(name) is not None)
    if total <= 0 or hand <= 0:
        return None
    return 100.0 * hand / total
