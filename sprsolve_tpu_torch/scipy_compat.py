"""``scipy.sparse.linalg``-style entry points.

Counterpart of ``sprsolve_tpu/scipy_compat.py``: the call conventions of
scipy for users migrating scipy code.  ``cg``, ``bicgstab``, ``cgs``,
``tfqmr``, ``gmres`` and ``minres`` take a scipy.sparse matrix, a dense
array, this package's containers and operators, or a host
``LinearOperator``-like, and return ``(x, info)`` with scipy's integer info
codes (0 converged, > 0 no convergence within ``maxiter`` (the iteration
count), < 0 breakdown or invalid input).  The tolerance follows scipy ≥
1.12: ‖r‖ ≤ max(rtol·‖b‖, atol).

Everything runs through :func:`sprsolve_tpu_torch.solve`, so a scipy-shaped
call gets the layout optimizer (the padded-DIA kernels, BSR, RCM) on the
card, in the dtype it is given: a banded float64 matrix runs the f64
kernels.  Each function takes a keyword-only ``device`` (default: the CUDA
device; ``device="cpu"`` runs on the CPU), passed to ``solve()``; without
CUDA and without a device, they raise.  ``x`` comes back as a tensor on
that device.  This is an interop veneer: new code should prefer
:func:`sprsolve_tpu_torch.solve` or the functional solvers, which return
the richer :class:`~sprsolve_tpu_torch.errors.SolveInfo`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .api import solve as _solve
from .errors import BreakDown, InvalidPreconditioner, Status, ZeroDiagonalElem
from .ops.operator import as_operator
from .ops.optimize import default_device
from .sparse.containers import CSR, _host, csr_from_dense, csr_from_scipy

__all__ = [
    "aslinearoperator", "bicgstab", "cg", "cgs", "eigsh", "gmres", "lobpcg",
    "lsqr", "minres", "tfqmr",
]


def _is_scipy_sparse(a) -> bool:
    # a LinearOperator also lives under scipy.sparse.*; a sparse *matrix*
    # is what tocsr() identifies
    return type(a).__module__.startswith("scipy.sparse") and hasattr(a, "tocsr")


class _CallbackOperator:
    """A host ``matvec`` (e.g. a scipy ``LinearOperator``) as an operator:
    each apply copies the vector to the host as NumPy, calls ``matvec`` and
    copies the result back to the vector's device, in its dtype. Correct
    and slow: for interop and tests, not production."""

    def __init__(self, a):
        self._a = a
        self.shape = tuple(a.shape)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        y = self._a.matvec(x.detach().cpu().numpy())
        return torch.as_tensor(np.asarray(y).reshape(-1)).to(dtype=x.dtype, device=x.device)

    def matvec_dot(self, x: torch.Tensor):
        from .vecalg import conj_dot

        y = self.matvec(x)
        return y, conj_dot(x, y)


def _holds_tensors(a) -> bool:
    fields = getattr(a, "__dict__", {}).values()
    return any(isinstance(v, torch.Tensor) for v in fields)


def aslinearoperator(a, device=None):
    """``a`` as an operator of this package.

    Takes this package's containers and operators (returned as they are),
    scipy.sparse matrices (a CSR on the CPU: ``solve()`` lays it out on the
    device), dense arrays (a dense operator on ``device``, by default the
    CUDA device) and any object with ``shape`` and ``matvec`` that holds no
    tensors (a host-callback operator: the way in for a scipy
    ``LinearOperator``)."""
    if _is_scipy_sparse(a):
        return csr_from_scipy(a)
    if isinstance(a, (np.ndarray, torch.Tensor)) or not hasattr(a, "matvec"):
        return as_operator(a, device=default_device(device))
    if isinstance(a, CSR) or type(a).__module__.startswith("sprsolve_tpu_torch") \
            or _holds_tensors(a):
        return a
    return _CallbackOperator(a)


def _run(method: str, A, b, x0, rtol, atol, maxiter, M, device, **solver_kwargs):
    b_np = _host(b)
    n = b_np.shape[0]
    if maxiter is None:
        maxiter = 10 * n
    bnorm = float(np.linalg.norm(b_np))
    tol = rtol if bnorm == 0.0 else max(float(rtol), float(atol) / bnorm)
    device = default_device(device)

    op = A if isinstance(A, CSR) else aslinearoperator(A, device)
    if M is not None and not isinstance(M, str):
        M = aslinearoperator(M, device)
    try:
        x, info = _solve(op, b_np, method=method, M=M, tol=tol, max_iter=maxiter,
                         x0=None if x0 is None else _host(x0), device=device,
                         **solver_kwargs)
    except (BreakDown, InvalidPreconditioner, ZeroDiagonalElem):
        return torch.zeros(n, dtype=torch.as_tensor(b_np).dtype, device=device), -1
    status = int(info.status)
    if status == Status.CONVERGED:
        return x, 0
    if status == Status.INSUFFICIENT_ITER:
        return x, int(info.iterations)   # scipy: info > 0 is the count at maxiter
    return x, -abs(status)


def cg(A, b, x0=None, *, rtol: float = 1e-5, atol: float = 0.0,
       maxiter: Optional[int] = None, M=None, device=None):
    """SPD conjugate gradients, ``scipy.sparse.linalg.cg`` conventions."""
    return _run("cg", A, b, x0, rtol, atol, maxiter, M, device)


def bicgstab(A, b, x0=None, *, rtol: float = 1e-5, atol: float = 0.0,
             maxiter: Optional[int] = None, M=None, device=None):
    """``scipy.sparse.linalg.bicgstab`` conventions."""
    return _run("bicgstab", A, b, x0, rtol, atol, maxiter, M, device)


def cgs(A, b, x0=None, *, rtol: float = 1e-5, atol: float = 0.0,
        maxiter: Optional[int] = None, M=None, device=None):
    """``scipy.sparse.linalg.cgs`` conventions."""
    return _run("cgs", A, b, x0, rtol, atol, maxiter, M, device)


def tfqmr(A, b, x0=None, *, rtol: float = 1e-5, atol: float = 0.0,
          maxiter: Optional[int] = None, M=None, show: bool = False, device=None):
    """``scipy.sparse.linalg.tfqmr`` conventions (``show`` is accepted and
    ignored: the solve prints nothing per iteration)."""
    return _run("tfqmr", A, b, x0, rtol, atol, maxiter, M, device)


def gmres(A, b, x0=None, *, rtol: float = 1e-5, atol: float = 0.0,
          restart: Optional[int] = None, maxiter: Optional[int] = None, M=None,
          device=None):
    """``scipy.sparse.linalg.gmres`` conventions.

    As in scipy, ``maxiter`` counts restart *cycles* (the inner steps are
    ``maxiter·restart``) and ``restart`` defaults to ``min(20, n)``."""
    n = _host(b).shape[0]
    if restart is None:
        restart = min(20, n)
    if maxiter is None:
        maxiter = min(10 * n, 1000)
    return _run("gmres", A, b, x0, rtol, atol, maxiter * restart, M, device,
                restart=restart)


def _op_dtype(op, b) -> torch.dtype:
    dt = getattr(op, "dtype", None)
    return dt if isinstance(dt, torch.dtype) else torch.as_tensor(_host(b)).dtype


def minres(A, b, x0=None, *, shift: float = 0.0, rtol: float = 1e-5,
           maxiter: Optional[int] = None, M=None, device=None):
    """``scipy.sparse.linalg.minres`` conventions.

    ``shift`` solves (A − shift·I)·x = b through
    :class:`~sprsolve_tpu_torch.ops.operator.ShiftedOperator`, on the layout
    ``optimize()`` picks for A (the padded kernels for a banded matrix)."""
    if shift != 0.0:
        from .ops.operator import ShiftedOperator
        from .ops.optimize import optimize as _optimize

        device = default_device(device)
        op = aslinearoperator(A, device)
        if isinstance(op, CSR):
            # lay the matrix out *before* wrapping: solve() lays out only a
            # raw container, and the shift must ride the kernel
            op = _optimize(op, device=device)
        A = ShiftedOperator(A=op, shift=torch.tensor(
            shift, dtype=_op_dtype(op, b), device=getattr(op, "device", device)))
    return _run("minres", A, b, x0, rtol, 0.0, maxiter, M, device)


def lobpcg(A, X, B=None, M=None, Y=None, tol=None, maxiter: int = 20,
           largest: bool = True, verbosityLevel: int = 0, *, device=None):
    """``scipy.sparse.linalg.lobpcg`` conventions (the standard problem).

    Returns ``(w, v)`` as tensors on the device, ``w`` descending for
    ``largest`` as scipy gives it. ``B`` (the generalized problem) and
    ``Y`` (constraints) are not supported; ``largest`` defaults to True as
    in scipy."""
    if B is not None or Y is not None:
        raise NotImplementedError("lobpcg B/Y are not supported")
    from .solvers import lobpcg as _lobpcg

    device = default_device(device)
    X = torch.as_tensor(_host(X))
    if not (X.dtype.is_floating_point or X.dtype.is_complex):
        # scipy takes an integer X after promotion; finfo would raise
        X = X.to(torch.promote_types(X.dtype, torch.float32))
    if tol is None:
        tol = float(np.sqrt(torch.finfo(X.dtype).eps))
    op = _on(aslinearoperator(A, device), device)
    if M is not None:
        M = _on(aslinearoperator(M, device), device)
    # the block takes the operator's precision where it is wider, as the
    # JAX package's products promote
    X = X.to(torch.promote_types(X.dtype, _op_dtype(op, X)))
    w, v, _info = _lobpcg(op, X.to(device), M=M, largest=largest, tol=tol,
                          max_iter=maxiter)
    if largest:   # scipy returns the largest in descending order
        return w.flip(0), v.flip(1)
    return w, v


def _on(op, device):
    """A CSR moved to ``device``; any other operator as it is."""
    return op.to(device) if isinstance(op, CSR) else op


def eigsh(A, k: int = 6, M=None, sigma=None, which: str = "LM", v0=None,
          ncv=None, maxiter=None, tol: float = 0,
          return_eigenvectors: bool = True, mode: str = "normal",
          precond=None, *, device=None):
    """``scipy.sparse.linalg.eigsh`` conventions (a supported subset).

    Returns NumPy ``(w, v)`` (``w`` ascending), or ``w`` alone with
    ``return_eigenvectors=False``.

    - ``sigma=None``: ``which`` must be ``"LA"`` (largest algebraic) or
      ``"SA"`` (smallest), solved by LOBPCG on the matrix as given (a CSR
      stays a CSR: no padded layout, no hand kernel, as in the JAX
      package). ``"LM"`` without a shift (largest magnitude) has no LOBPCG
      analog on an indefinite spectrum and raises.
    - ``sigma`` given: ``which="LM"`` only (ARPACK's shift-invert default,
      the k eigenvalues nearest σ), solved by
      :func:`~sprsolve_tpu_torch.solvers.shift_invert_eigs` with iterative
      inner solves (MINRES) in place of ARPACK's factorization, on the CSR
      (``optimize_layout=False``).
    - ``M`` (the generalized problem), ``ncv`` and ``mode != "normal"``
      raise NotImplementedError.
    - ``tol=0`` stands for scipy's machine precision as √ε of the working
      dtype (an iterative method cannot reach 0).
    - ``v0`` seeds the first column of the search block.
    - ``precond`` (beyond scipy, LOBPCG only): ``"jacobi"``, a built
      ≈A⁻¹ operator, or None. At scale it decides convergence: the
      smallest eigenvalues of a grid operator cluster at O(h²), and
      LOBPCG without one is limited by the gap.

    When fewer than k pairs converge near σ, raises scipy's
    ``ArpackNoConvergence`` with the pairs found, as scipy does.
    """
    if M is not None or ncv is not None or mode != "normal":
        raise NotImplementedError("eigsh M/ncv/mode are not supported")
    if precond is not None and sigma is not None:
        raise NotImplementedError(
            "precond applies to the LOBPCG path (sigma=None); the shift-invert "
            "inner MINRES on the indefinite A - sigma*I has no safe SPD "
            "preconditioner to build automatically")
    device = default_device(device)
    if isinstance(precond, str):
        if precond != "jacobi":
            raise NotImplementedError(
                f"precond={precond!r}: 'jacobi', a built operator, or None (for "
                "multigrid build GridMGPrecond.from_csr and pass it; the CLI's "
                "'eig --precond mg --grid ...' does exactly that)")
        d = A.diagonal_host() if hasattr(A, "diagonal_host") else _host(A.diagonal())
        d = np.where(d == 0, 1.0, np.abs(d))
        from .precond import DiagPrecond

        precond = DiagPrecond.new(d, device=device)
    op = aslinearoperator(A, device)
    n = op.shape[0]
    dt = _op_dtype(op, np.zeros(0))
    if tol == 0:
        tol = float(np.sqrt(torch.finfo(dt).eps))
    rng = np.random.default_rng(0)
    X0 = torch.as_tensor(rng.standard_normal((n, k))).to(dt)
    if v0 is not None:
        X0[:, 0] = torch.as_tensor(_host(v0)).reshape(-1).to(dt)
    if sigma is None:
        if which not in ("LA", "SA"):
            raise NotImplementedError(
                "eigsh without sigma supports which='LA'/'SA' only "
                f"(got {which!r}); for eigenvalues nearest a target pass sigma=")
        from .solvers import lobpcg as _lobpcg

        w, v, _info = _lobpcg(
            _on(op, device), X0.to(device), M=precond, largest=(which == "LA"), tol=tol,
            max_iter=200 if maxiter is None else maxiter,
            # guard columns (ARPACK's ncv > k): the k-th pair's convergence
            # when it sits in a cluster
            buffer=min(k, 4))
    else:
        if which != "LM":
            raise NotImplementedError(
                "eigsh with sigma supports which='LM' (nearest sigma) only")
        from .solvers import shift_invert_eigs as _sie

        w, v, _info = _sie(op, k, float(sigma), X0=X0, tol=tol,
                           max_iter=100 if maxiter is None else maxiter,
                           optimize_layout=False, device=device)
        order = torch.argsort(w)
        w, v = w[order], v[:, order]
        # scipy's eigsh returns exactly k pairs or raises; the dedupe and
        # side filter of shift_invert_eigs can keep fewer when fewer than k
        # distinct pairs converged near sigma
        if w.shape[0] < k:
            from scipy.sparse.linalg import ArpackNoConvergence

            raise ArpackNoConvergence(
                f"eigsh(sigma={sigma}): only {w.shape[0]} of {k} requested "
                "eigenpairs converged (try a larger maxiter, looser tol, or a "
                "different sigma)", _host(w), _host(v))
    if return_eigenvectors:
        return _host(w), _host(v)
    return _host(w)


def lsqr(A, b, damp: float = 0.0, atol: float = 1e-6, btol: float = 1e-6,
         conlim: float = 1e8, iter_lim: Optional[int] = None,
         show: bool = False, calc_var: bool = False, x0=None, *, device=None):
    """``scipy.sparse.linalg.lsqr`` conventions.

    Returns scipy's 10-tuple ``(x, istop, itn, r1norm, r2norm, anorm,
    acond, arnorm, xnorm, var)``: ``x`` a tensor on the device, the norms
    computed on the host from the CSR. ``acond`` is not estimated (NaN)
    and ``calc_var`` is not supported; the solve takes ``max(atol, btol)``
    as the one tolerance of :func:`sprsolve_tpu_torch.solvers.lsqr`.

    Departures from scipy:

    - ``conlim`` is accepted and ignored: no condition estimate is kept,
      so the istop = 3 and 6 exits never fire.
    - ``istop=1`` tests ``r1norm ≤ max(atol, btol)·‖b‖`` in place of
      scipy's ``btol·‖b‖ + atol·‖A‖·‖x‖``; a caller that branches on
      scipy's exact istop should classify from the returned norms.
    """
    if calc_var:
        raise NotImplementedError("lsqr calc_var is not supported")
    if _is_scipy_sparse(A):
        A = csr_from_scipy(A)
    elif isinstance(A, (np.ndarray, torch.Tensor)):
        A = csr_from_dense(_host(A))
    if not isinstance(A, CSR):
        raise NotImplementedError(
            "scipy_compat.lsqr needs a matrix input (CSR/scipy.sparse/dense); for "
            "operator inputs call sprsolve_tpu_torch.lsqr with an explicit AH=")
    b_np = _host(b)
    n = A.shape[1]
    if iter_lim is None:
        iter_lim = 2 * n
    tol = max(float(atol), float(btol))
    x, info = _solve(A, b_np, method="lsqr", tol=tol, max_iter=iter_lim,
                     x0=None if x0 is None else _host(x0), damp=damp,
                     device=default_device(device))
    A = A.to("cpu")
    x_h = x.detach().cpu()
    x_np = x_h.numpy()
    itn = int(info.iterations)
    r = b_np - A.matvec(x_h).numpy()
    r1norm = float(np.linalg.norm(r))
    xnorm = float(np.linalg.norm(x_np))
    r2norm = float(np.sqrt(r1norm ** 2 + (damp * xnorm) ** 2))
    anorm = float(np.linalg.norm(_host(A.data)))   # Frobenius
    arnorm = float(np.linalg.norm(A.adjoint().matvec(torch.as_tensor(r)).numpy()
                                  - (damp * damp) * x_np))
    bnorm = float(np.linalg.norm(b_np))
    if bnorm == 0.0:
        istop = 0
    elif r1norm <= tol * bnorm * 1.01:
        istop = 1
    elif int(info.status) == Status.CONVERGED:
        istop = 2   # least-squares convergence (‖Aᴴr‖ small)
    else:
        istop = 7   # the iteration limit
    return (x, istop, itn, r1norm, r2norm, anorm, float("nan"), arnorm, xnorm, None)
