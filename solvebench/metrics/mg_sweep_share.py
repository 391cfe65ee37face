"""The multigrid colour steps' (``gs_color_step_kernel``) device time over
all device time in the device-only traced stretch, in %."""

from solvebench import mg_byte_models


def read(s: dict):
    t = s.get("trace", {}).get("device")
    if not t:
        return None
    total = sum(sec for _, sec in t["kernels"].values())
    sweep = sum(sec for name, (_, sec) in t["kernels"].items()
                if mg_byte_models.parse(name) is not None)
    if total <= 0 or sweep <= 0:
        return None
    return 100.0 * sweep / total
