"""Right-hand sides of standard normal entries (both planes of a complex b)."""

import math


def stream(cfg: dict, spec: dict, dtype, operator):
    """``make(gen, device)``: b of the grid's size from the generator ``gen``."""
    import torch

    n = math.prod(int(v) for v in cfg["grid"])

    def make(gen, device):
        return torch.randn(n, generator=gen, dtype=dtype, device=device)
    return make
