"""Flat-spectrum right-hand sides: Σ_j s_j·v_j over the operator's orthonormal
eigenvectors v_j (``operators/<operator>.py``'s ``eigenbasis``), with signs
s_j = ±1 drawn from the generator.  White noise with every spectral weight at
its expectation: a Krylov solve's work depends on the weights |s_j|² = 1
alone, so every seed gets the same work in another order.  Real operators
only."""

import math

from solvebench.harness import SetupError


def stream(cfg: dict, spec: dict, dtype, operator):
    """``make(gen, device)``: b of the grid's size from the generator ``gen``."""
    import torch

    if dtype.is_complex:
        raise SetupError("a flat_spectrum right-hand side is real; the "
                         f"configuration's dtype is {cfg['dtype']}")
    n = math.prod(int(v) for v in cfg["grid"])
    eigenbasis = operator.eigenbasis

    def make(gen, device):
        signs = torch.randint(0, 2, (n,), generator=gen, device=device)
        return eigenbasis(cfg, signs.double() * 2 - 1).to(dtype)
    return make
