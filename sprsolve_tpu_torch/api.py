"""One-call and object APIs (counterpart of ``sprsolve_tpu/api.py``).

The reference writes ``BiCGStab::new(&lap, n).solve(rhs, x, 1500, 1e-17)``;
here::

    x, (iters, res) = sprsolve_tpu_torch.BiCGStab.new(A, n).solve(b, x0, 1500, 1e-17)

and the layout-optimizing form::

    x, info = sprsolve_tpu_torch.solve(A, b, method="bicgstab", M="jacobi",
                                       device="cuda")

Every entry point takes an explicit ``device``; by default the solve runs on
the device of ``b`` when it is a tensor, else on the device of ``A``.
Ported so far: ``method="bicgstab"``, ``"bicgstabl"``, ``"cg"``,
``"minres"`` and ``"auto"``, with ``M=None``, ``"jacobi"`` or a
:class:`~sprsolve_tpu_torch.precond.DiagPrecond`, and the ``BiCGStab``,
``MinRes`` and ``CG`` handles; other methods and preconditioners (and the
routes of ``"auto"`` to them) raise NotImplementedError naming their
ROADMAP.md item.
"""

from __future__ import annotations

from functools import partial

import torch

from .errors import IncompatibleMatrixFormat
from .ops.operator import as_operator
from .solvers import bicgstab, bicgstabl, cg, minres
from .sparse.containers import CSR

_SOLVERS = {"bicgstab": bicgstab, "bicgstabl": bicgstabl, "cg": cg, "minres": minres}

# the JAX package's other methods and preconditioner builders, by the
# ROADMAP.md Queue 1 item that ports them
_LATER_METHODS = {
    "lsqr": 6,
    **dict.fromkeys(("cs_minres", "cocg"), 7),
    **dict.fromkeys(("gmres", "fgmres", "idrs", "cgs", "tfqmr", "cg_single_sync",
                     "ca_cg", "ca_bicgstab"), 10),
}
_LATER_M = {"ilu0": 8, "ic0": 8, "block_jacobi": 8, "amg": 10}


def _auto_method(A, parity: str = "fast") -> str:
    """Pick a solver from the matrix structure, on the host with NumPy and
    scipy (``sprsolve_tpu/api.py:65-105``): Hermitian, incl. real symmetric
    → ``minres``; complex symmetric → ``cocg``; rectangular → ``lsqr``;
    anything else (or an operator, which cannot be inspected) →
    ``bicgstabl``, or plain ``bicgstab`` with ``parity="reference"``."""
    import numpy as np
    import scipy.sparse as sps

    from .sparse.containers import _host

    nonsym = "bicgstab" if parity == "reference" else "bicgstabl"
    if not isinstance(A, CSR):
        return nonsym
    S = sps.csr_matrix((_host(A.data), _host(A.indices), _host(A.indptr)),
                       shape=A.shape)
    if S.shape[0] != S.shape[1]:
        return "lsqr"
    scale = float(abs(S).max()) if S.nnz else 0.0
    if scale == 0.0:
        return nonsym
    tol = 1e-12 * scale

    def dev(X):
        return float(abs(X).max()) if X.nnz else 0.0

    if dev(S - S.conj().T) <= tol:
        return "minres"
    if np.iscomplexobj(S.data) and dev(S - S.T) <= tol:
        return "cocg"
    return nonsym


def _resolve(method: str, A, solver_kwargs: dict):
    """The solver for ``method``; ``"auto"`` is routed by :func:`_auto_method`
    (``parity`` is popped from ``solver_kwargs``, and BiCGStab(ℓ) gets
    ``l=2`` unless the caller set ``l``)."""
    if method == "auto":
        method = _auto_method(A, parity=solver_kwargs.pop("parity", "fast"))
        if method == "bicgstabl":
            solver_kwargs.setdefault("l", 2)
    return _solver(method)


def _solver(method: str):
    if method in _SOLVERS:
        return _SOLVERS[method]
    if method in _LATER_METHODS:
        raise NotImplementedError(
            f"method={method!r} is not ported yet: ROADMAP.md Queue 1 item "
            f"{_LATER_METHODS[method]}"
        )
    raise ValueError(f"unknown method {method!r}")


def _device(A, b, device) -> torch.device:
    if device is not None:
        return torch.device(device)
    if isinstance(b, torch.Tensor):
        return b.device
    return getattr(A, "device", torch.device("cpu"))


def _prepare_op_M(A, M, optimize_layout: bool, device):
    """Shared pipeline of :func:`solve` and :func:`prepare`: pick the
    execution layout for ``A`` and build or re-lay the preconditioner.
    Returns ``(op, M, padded)``; ``padded`` means the operator works in its
    own vector layout (``pad_vec``/``unpad_vec``)."""
    from .errors import InvalidPreconditioner
    from .ops.optimize import optimize
    from .precond import DiagPrecond

    if isinstance(M, str) and M != "jacobi":
        if M in _LATER_M:
            raise NotImplementedError(
                f"M={M!r} is not ported yet: ROADMAP.md Queue 1 item {_LATER_M[M]}"
            )
        raise ValueError(f"unknown preconditioner {M!r}")

    op = A
    if isinstance(A, CSR):
        op = optimize(A, device=device) if optimize_layout else A.to(device)

    padded = hasattr(op, "pad_vec")
    if padded:
        if isinstance(M, str):
            M = op.jacobi_precond()
        elif isinstance(M, DiagPrecond):
            try:
                M = op.relay_diag_precond(M)
            except NotImplementedError as e:
                raise InvalidPreconditioner(str(e)) from e
        elif M is not None:
            raise NotImplementedError(
                "a general preconditioner on a padded operator (RelayedPrecond): "
                "ROADMAP.md Queue 1 item 8"
            )
    elif isinstance(M, str):
        diag = op.diagonal() if hasattr(op, "diagonal") else A.diagonal()
        M = DiagPrecond.new(diag, device=device)
    return op, M, padded


def _vec(v, n, device, what: str) -> torch.Tensor:
    v = torch.as_tensor(v, device=device)
    if n is not None and tuple(v.shape) != (n,):
        raise IncompatibleMatrixFormat(f"{what} dimension doesn't match the matrix size")
    return v


def solve(
    A,
    b,
    *,
    method: str = "bicgstab",
    M=None,
    tol: float = 1e-8,
    max_iter: int = 1000,
    x0=None,
    optimize_layout: bool = True,
    device=None,
    **solver_kwargs,
):
    """One-call solve: pick the execution layout, run, return ``(x, info)``.

    ``A`` is a CSR container (laid out by :func:`~sprsolve_tpu_torch.optimize`:
    the padded-DIA kernels for a banded float32 matrix, with the padding
    handled here) or any operator, used as it is. ``x`` comes back flat, on
    the solve's device.

    ``method="auto"`` picks the solver from the matrix structure (see
    :func:`_auto_method`; ``parity="reference"`` keeps plain BiCGStab for a
    nonsymmetric matrix).
    """
    solver = _resolve(method, A, solver_kwargs)
    device = _device(A, b, device)
    n = getattr(A, "shape", (None,))[0]
    # validate before padding: pad_vec would silently zero-extend a short b
    b = _vec(b, n, device, "Input vec")
    x0 = None if x0 is None else _vec(x0, n, device, "x0")
    op, M, padded = _prepare_op_M(A, M, optimize_layout, device)
    run = PreparedSolver(op, partial(solver, tol=tol, max_iter=max_iter, M=M,
                                     **solver_kwargs), n)
    return run(b, x0)


class PreparedSolver:
    """A solve pipeline optimized once, reusable across right-hand sides
    (the ``mkl_sparse_set_mv_hint`` + ``mkl_sparse_optimize`` amortization).

    Each call converts ``b``/``x0`` to the operator's layout and back::

        handle = prepare(A, M="jacobi", tol=1e-8, device="cuda")
        x1, info1 = handle(b1)
        x2, info2 = handle(b2, x0=x1)
    """

    def __init__(self, op, run, n):
        self._op = op
        self._run = run
        self._padded = hasattr(op, "pad_vec")
        self._n = n

    @property
    def operator(self):
        """The execution-layout operator."""
        return self._op

    def __call__(self, b, x0=None):
        device = getattr(self._op, "device", None)
        b = _vec(b, self._n, device, "Input vec")
        x0 = None if x0 is None else _vec(x0, self._n, device, "x0")
        if self._padded:
            b = self._op.pad_vec(b)
            x0 = None if x0 is None else self._op.pad_vec(x0)
        x, *rest = self._run(self._op, b, x0)
        if self._padded:
            x = self._op.unpad_vec(x)
        return (x, *rest)


def prepare(
    A,
    *,
    method: str = "bicgstab",
    M=None,
    tol: float = 1e-8,
    max_iter: int = 1000,
    optimize_layout: bool = True,
    device=None,
    **solver_kwargs,
) -> PreparedSolver:
    """Build a :class:`PreparedSolver` for repeated solves against ``A``;
    takes what :func:`solve` takes."""
    solver = _resolve(method, A, solver_kwargs)
    device = _device(A, None, device)
    op, M, _ = _prepare_op_M(A, M, optimize_layout, device)
    return PreparedSolver(
        op, partial(solver, tol=tol, max_iter=max_iter, M=M, **solver_kwargs),
        A.shape[0],
    )


def _run(fn, A, b, x, max_iter, tol, M=None):
    device = getattr(A, "device", torch.device("cpu"))
    b = torch.as_tensor(b, device=device)
    x = torch.zeros_like(b) if x is None else torch.as_tensor(x, device=device)
    xr, info = fn(A, b, x, tol=tol, max_iter=max_iter, M=M)
    info.raise_if_error()
    return xr, (int(info.iterations), float(info.residual))


class _Handle:
    """The reference's solver-handle shape: ``new(A, n)``, then ``solve`` and
    ``precond_solve``, which raise the exception of a failure status.

    ``A`` is used as it is (a CSR runs the gather SpMV, not the kernels);
    ``device`` moves a CSR or a dense matrix there first."""

    _fn = None

    def __init__(self, A, size: int, device=None):
        if device is not None and isinstance(A, CSR):
            A = A.to(device)
        self.A = as_operator(A, device=device)
        if self.A.shape[1] != size:
            raise IncompatibleMatrixFormat(
                "Input vec dimension doesn't match the matrix size"
            )
        self.size = size

    new = classmethod(lambda cls, A, size, device=None: cls(A, size, device))

    def solve(self, rhs, x=None, max_iter: int = 1000, tol: float = 1e-12):
        return _run(self._fn, self.A, rhs, x, max_iter, tol)

    def precond_solve(self, precond, rhs, x=None, max_iter: int = 1000,
                      tol: float = 1e-12):
        return _run(self._fn, self.A, rhs, x, max_iter, tol, M=precond)


class BiCGStab(_Handle):
    """BiCGStab solver handle (reference ``src/bicg_stab.rs:25-31``)."""

    _fn = staticmethod(bicgstab)


class MinRes(_Handle):
    """MINRES solver handle (reference ``src/minres.rs:21-27``)."""

    _fn = staticmethod(minres)


class CG(_Handle):
    """Conjugate-gradient handle for SPD systems (no reference counterpart;
    the handle shape of :class:`BiCGStab`)."""

    _fn = staticmethod(cg)
