"""Device kernels launched in the device-only traced stretch over its
iterations (copies and fills left out)."""


def read(s: dict):
    t = s.get("trace", {}).get("device")
    if not t or not t["n_kernels"] or not t["iterations"]:
        return None
    return t["n_kernels"] / t["iterations"]
