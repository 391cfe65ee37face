"""Debugging aids (counterpart of ``sprsolve_tpu/debug.py``).

- :func:`check_operator` — sanity harness for a LinearOperator: shape and
  dtype stability, finiteness, linearity, and ``matvec``/``matvec_dot``
  consistency.
- NaN hunting: ``torch.autograd.set_detect_anomaly`` does not reach the
  solvers (no autograd); rerun a failing solve with ``record_residuals=True``
  and look for the first non-finite entry.

The JAX package's ``interpret_kernels`` (run the Pallas kernels in
interpret mode) has no counterpart: every kernel wrapper of the port runs
its plain PyTorch version for CPU tensors, so ``device="cpu"`` is the
interpreter.
"""

from __future__ import annotations

import numpy as np
import torch


def check_operator(op, x_example, rtol=None, seed=0):
    """Sanity checks on a LinearOperator. Raises AssertionError on failure.

    ``x_example`` supplies the vector shape, dtype and device the operator
    consumes (e.g. ``padded.pad_vec(torch.zeros(n))`` for kernel-layout
    operators). ``rtol`` defaults to 1e5·ε of the vectors' real dtype.
    """
    rng = np.random.default_rng(seed)
    x_example = torch.as_tensor(x_example)
    shape, dtype, dev = tuple(x_example.shape), x_example.dtype, x_example.device

    def rand():
        r = rng.standard_normal(shape)
        if dtype.is_complex:
            r = r + 1j * rng.standard_normal(shape)
        return torch.as_tensor(r).to(dtype=dtype, device=dev)

    if rtol is None:
        rdt = dtype.to_real() if dtype.is_complex else dtype
        rtol = 1e5 * float(torch.finfo(rdt).eps)

    u, v = rand(), rand()
    a = torch.tensor(2.5, dtype=dtype, device=dev)

    yu = op.matvec(u)
    assert tuple(yu.shape) == shape, f"matvec changed shape: {shape} -> {tuple(yu.shape)}"
    assert yu.dtype == dtype, f"matvec changed dtype: {dtype} -> {yu.dtype}"
    assert bool(torch.isfinite(yu).all()), "matvec produced non-finite values"

    # linearity: A(a·u + v) == a·A·u + A·v
    lhs = op.matvec(a * u + v)
    rhs = a * yu + op.matvec(v)
    err = float((lhs - rhs).abs().max()) / max(float(rhs.abs().max()), 1e-30)
    assert err < rtol, f"matvec not linear: rel err {err:.2e}"

    # matvec_dot consistency
    y2, d = op.matvec_dot(u)
    err_y = float((y2 - yu).abs().max())
    assert err_y == 0.0 or err_y / max(float(yu.abs().max()), 1e-30) < rtol, (
        f"matvec_dot y differs from matvec: {err_y:.2e}"
    )
    want = torch.sum(torch.conj(u) * yu)
    err_d = abs(complex(d - want)) / max(abs(complex(want)), 1e-30)
    assert err_d < rtol, f"matvec_dot dot mismatch: rel err {err_d:.2e}"
    return True
