"""Gauss-Seidel: the exact sequential sweep.

Counterpart of ``sprsolve_tpu/solvers/gauss_seidel.py`` (reference
``src/gauss_seidel.rs``).  True Gauss-Seidel is sequential over rows: x[i]
reads the x[j<i] already updated in the same sweep.  The JAX package runs
that row loop as a ``fori_loop`` and calls it slow on the TPU by
construction; here the sweep runs on the host, by design, over NumPy copies
of the ELL slabs, and only the residual ‖A·x − b‖ of each sweep is taken on
the operator's device.  The parallel multicolor sweep is in
:mod:`.redblack`.

Semantics kept exactly:

- x[i] = (b[i] − σ)/a_ii with σ = Σ_{j≠i} a_ij·x[j] summed left to right in
  slot order, rows in order (``src/gauss_seidel.rs:111-125``);
- a diagonal with |a_ii|² < ε gives ZERO_DIAGONAL (``:72-78``); a
  structurally missing one reads as 0 and fails the same check;
- the residual is **absolute**, ‖A·x − b‖ ≤ eps·‖b‖ after every sweep, and
  it is what the info reports (``:87-108,127-137``);
- the first sweep's check returns 1, the sweep at loop index ``it``
  returns ``it`` (``:106-107,135-136``);
- ``max_iter == 0`` gives INSUFFICIENT_ITER before any work (``:52-54``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..errors import IncompatibleMatrixFormat, Status
from ..sparse.containers import ELL
from ..vecalg import abs2, axpy, eps_for, norm2, real_dtype
from .common import check_shapes, make_info


def _sweep(data: np.ndarray, cols: np.ndarray, off: np.ndarray, diag: np.ndarray,
           b: np.ndarray, x: np.ndarray) -> None:
    """One in-order sweep over host arrays, updating ``x`` in place. ``off``
    marks the off-diagonal slots (pad slots hold 0 and add nothing);
    ``cumsum`` adds the slots strictly left to right."""
    zero = np.zeros((), dtype=x.dtype)
    for i in range(x.shape[0]):
        sigma = np.cumsum(np.where(off[i], data[i] * x[cols[i]], zero))[-1]
        x[i] = (b[i] - sigma) / diag[i]


def gauss_seidel(
    A: ELL,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    max_iter,
    eps,
):
    """Solve A·x = b with sequential Gauss-Seidel sweeps, run on the host.

    ``A`` is a square :class:`~sprsolve_tpu_torch.sparse.containers.ELL`
    (``csr.to_ell()``). Returns ``(x, SolveInfo)`` with x on b's device and
    the **absolute** residual."""
    if A.shape[0] != A.shape[1]:
        raise IncompatibleMatrixFormat("Not a square matrix")
    if x0 is None:
        x0 = torch.zeros_like(b)
    check_shapes(A, b, x0)

    T, dev = b.dtype, b.device
    rdt = real_dtype(T)
    zero_r = torch.zeros((), dtype=rdt, device=dev)
    if int(max_iter) == 0:
        return x0, make_info(0, zero_r, Status.INSUFFICIENT_ITER)
    diag = A.diagonal()
    if bool(torch.any(abs2(diag) < eps_for(T, dev))):
        return x0, make_info(0, zero_r, Status.ZERO_DIAGONAL)

    one = torch.ones((), dtype=T, device=dev)
    tol2 = torch.tensor(eps, dtype=rdt, device=dev) * norm2(b)
    data, cols = A.data.cpu().numpy(), A.cols.cpu().numpy()
    off = cols != np.arange(A.shape[0])[:, None]
    diag_h, b_h = diag.cpu().numpy(), b.cpu().numpy()
    x_h = x0.cpu().numpy().copy()

    def step():
        _sweep(data, cols, off, diag_h, b_h, x_h)
        x = torch.tensor(x_h, device=dev)
        res = norm2(axpy(-one, b, A.matvec(x)))
        return x, res, bool(res <= tol2)

    x, res, done = step()
    it = 1
    while not done and it < int(max_iter):
        x, res, done = step()
        if not done:
            it += 1
    status = Status.CONVERGED if done else Status.INSUFFICIENT_ITER
    return x, make_info(it, res, status)
