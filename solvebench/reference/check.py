"""The numbers that decide ``correct``, worked out by the plain reference.

A solve's answer x is judged by what it says: its true relative residual
‖b − A·x‖₂ / ‖b‖₂, with A the configuration's operator applied by the
reference (``reference/<operator>.py``'s ``matvec``) in float64 or
complex128, whatever precision x came in.
"""

from __future__ import annotations

import torch


def wide(v: torch.Tensor) -> torch.Tensor:
    return v.to(torch.complex128 if v.is_complex() else torch.float64)


def true_rel_residual(ref, cfg: dict, x: torch.Tensor, b: torch.Tensor) -> float:
    """‖b − A·x‖₂ / ‖b‖₂ in double precision; NaN where x is not finite."""
    xw, bw = wide(x), wide(b)
    if not bool(torch.isfinite(xw).all()):
        return float("nan")
    r = bw - ref.matvec(cfg, xw)
    return float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(bw))
