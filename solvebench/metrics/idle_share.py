"""The device's idle share of the device-only traced stretch, in %:
1 − (the union of its device events' intervals ÷ the traced window)."""


def read(s: dict):
    t = s.get("trace", {}).get("device")
    if not t or t["busy_s"] <= 0 or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
