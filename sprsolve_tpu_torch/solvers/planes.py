"""Real-planes adapter (counterpart of ``sprsolve_tpu/solvers/planes.py``).

The JAX package moves the re/im split of a complex solve outside its jit
boundary, for backends that reject complex device buffers.  PyTorch holds
complex tensors on the GPU, so the port needs no such workaround; this
shim keeps the call shape for code written against it::

    solve = with_real_planes(cs_minres)
    x_re, x_im, info = solve(op, b_re, b_im, tol=..., max_iter=...)
"""

from __future__ import annotations

import torch


def with_real_planes(solver_fn):
    """Wrap a solver so complex vectors pass as re/im pairs:
    ``(A, b_re, b_im, x0_re=None, x0_im=None, **kw)`` →
    ``(x_re, x_im, info)``."""

    def wrapped(A, b_re, b_im, x0_re=None, x0_im=None, **kwargs):
        b = torch.complex(b_re, b_im)
        x0 = None
        if x0_re is not None:
            x0 = torch.complex(x0_re, torch.zeros_like(x0_re) if x0_im is None else x0_im)
        x, info = solver_fn(A, b, x0, **kwargs)
        return x.real, x.imag, info

    return wrapped
