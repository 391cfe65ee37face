"""One-call and object APIs (counterpart of ``sprsolve_tpu/api.py``).

The reference writes ``BiCGStab::new(&lap, n).solve(rhs, x, 1500, 1e-17)``;
here::

    x, (iters, res) = sprsolve_tpu_torch.BiCGStab.new(A, n).solve(b, x0, 1500, 1e-17)

and the layout-optimizing form::

    x, info = sprsolve_tpu_torch.solve(A, b, method="bicgstab", M="jacobi")

Every entry point (``solve``, ``prepare``, ``optimize``, ``refine_solve``
and the handles) runs on the CUDA device unless the caller passes
``device``, e.g. ``device="cpu"``; without CUDA and without a device they
raise.  The functional solvers (``bicgstab(op, b)`` and the like) run
where their tensors are.  ``method`` is any of the JAX package's:
``"bicgstab"``, ``"bicgstabl"``, ``"cg"``, ``"cg_single_sync"``,
``"minres"``, ``"cs_minres"``, ``"cocg"``, ``"cgs"``, ``"tfqmr"``,
``"gmres"``, ``"fgmres"``, ``"idrs"``, ``"lsqr"``, the s-step ``"ca_cg"``
and ``"ca_bicgstab"`` (on flat layouts, see :func:`_prepare_ca`), or
``"auto"``; ``M`` is None, ``"jacobi"``, ``"block_jacobi"``, ``"ilu0"``,
``"ic0"``, ``"amg"`` or a preconditioner object (a flat one on a padded
operator runs through :class:`~sprsolve_tpu_torch.precond.RelayedPrecond`;
one built on the operator itself, ``M.A is op``, runs as it is).  The
handles are ``BiCGStab``, ``MinRes``, ``CG``, ``GMRES``, ``CSMinRes`` and
``GaussSeidel``.  ``solve`` and ``prepare`` lay out any square CSR through
:func:`~sprsolve_tpu_torch.optimize` (padded DIA, RCM-reordered DIA, BSR,
the band+outlier hybrid, or ELL with a warning).
"""

from __future__ import annotations

from functools import partial

import torch

from .errors import IncompatibleMatrixFormat, InvalidPreconditioner
from .ops.operator import as_operator
from .ops.optimize import default_device
from .solvers import (bicgstab, bicgstabl, ca_bicgstab, ca_cg, cg, cg_single_sync, cgs,
                      cocg, cs_minres, fgmres, gauss_seidel, gmres, idrs, lsqr, minres,
                      tfqmr)
from .sparse.containers import CSC, CSR, DIA, ELL
from .utils.timing import span

_SOLVERS = {"bicgstab": bicgstab, "bicgstabl": bicgstabl, "ca_bicgstab": ca_bicgstab,
            "ca_cg": ca_cg, "cg": cg, "cg_single_sync": cg_single_sync, "cgs": cgs,
            "cocg": cocg, "cs_minres": cs_minres, "fgmres": fgmres, "gmres": gmres,
            "idrs": idrs, "lsqr": lsqr, "minres": minres, "tfqmr": tfqmr}
# the s-step pair runs a pipeline of its own (_prepare_ca)
_CA_METHODS = ("ca_cg", "ca_bicgstab")
_BUILT_M = ("jacobi", "block_jacobi", "ilu0", "ic0", "amg")


def _auto_method(A, parity: str = "fast") -> str:
    """Pick a solver from the matrix structure, on the host with NumPy and
    scipy (``sprsolve_tpu/api.py:65-105``): Hermitian, incl. real symmetric
    → ``minres``; complex symmetric → ``cocg``; rectangular → ``lsqr``;
    anything else (or an operator, which cannot be inspected) →
    ``bicgstabl``, or plain ``bicgstab`` with ``parity="reference"``. A CSC
    is read as its CSR."""
    import numpy as np
    import scipy.sparse as sps

    from .sparse.containers import _host

    nonsym = "bicgstab" if parity == "reference" else "bicgstabl"
    if isinstance(A, CSC):
        A = A.to_csr()
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
    """``(method, solver)``; ``"auto"`` is routed by :func:`_auto_method`
    (``parity`` is popped from ``solver_kwargs``, and BiCGStab(ℓ) gets
    ``l=2`` unless the caller set ``l``)."""
    if method == "auto":
        method = _auto_method(A, parity=solver_kwargs.pop("parity", "fast"))
        if method == "bicgstabl":
            solver_kwargs.setdefault("l", 2)
    return method, _solver(method)


def _solver(method: str):
    if method in _SOLVERS:
        return _SOLVERS[method]
    raise ValueError(f"unknown method {method!r}")


_CS_MINRES_M = (
    "cs_minres's preconditioned form needs a REAL symmetric-positive M⁻¹; "
)


def _build_M(M: str, src, device):
    """The preconditioner a string names, built from the CSR on the host
    (``sprsolve_tpu/api.py:261-274``); the device parts land on ``device``."""
    from .precond import BlockJacobiPrecond, IC0Precond, ILU0Precond

    if not isinstance(src, CSR):
        raise InvalidPreconditioner(
            f"M={M!r} builds from the matrix on the host and needs a CSR/CSC "
            "input (got an operator); build the preconditioner object directly."
        )
    if M == "block_jacobi":
        return BlockJacobiPrecond.from_csr(src, device=device)
    return (ILU0Precond if M == "ilu0" else IC0Precond).from_csr(src, device=device)


def _amg(src, optimize_layout: bool, device):
    """``M="amg"`` (``sprsolve_tpu/api.py:210-241``): RCM localizes the
    graph, a 1-D aggregation hierarchy is built over that order, and the
    operator is wrapped in the permutation. A padded inner operator gets
    the V-cycle through :class:`~sprsolve_tpu_torch.precond.RelayedPrecond`
    (the outer ``Reordered`` boundary handles the permutation). Returns
    ``(op, M, padded)``."""
    from .multigrid import GridMGPrecond
    from .ops.optimize import optimize
    from .ops.reordered import Reordered
    from .precond import RelayedPrecond
    from .sparse.containers import reorder_rcm

    if not isinstance(src, CSR):
        raise InvalidPreconditioner(
            "M='amg' builds from the matrix on the host and needs a CSR/CSC "
            "input (got an operator); build GridMGPrecond."
        )
    A_rcm, perm = reorder_rcm(src)
    mg = GridMGPrecond.from_csr(A_rcm, (A_rcm.shape[0],), device=device)
    inner_op = optimize(A_rcm, device=device) if optimize_layout else A_rcm.to(device)
    op = Reordered.wrap(inner_op, perm)
    if hasattr(inner_op, "pad_vec"):
        return op, RelayedPrecond(inner=mg, op=inner_op), True
    return op, mg, True


def _prepare_ca(A, method: str, M, optimize_layout: bool, device, solver_kwargs):
    """The s-step pipeline of ``ca_cg``/``ca_bicgstab``
    (``sprsolve_tpu/api.py:133-182``). Returns ``(op, scale)``.

    - The CA solvers take no M apply: their basis is a polynomial in the
      bare operator.  ``ca_cg`` takes ``M="jacobi"`` on a CSR/CSC input
      by folding it into the system
      (:func:`~sprsolve_tpu_torch.solvers.ca_cg.fold_jacobi`; ``tol`` then
      applies to the scaled residual): b is scaled by ``scale`` and x
      unscaled at each call.  Any other M, a ``DiagPrecond`` included,
      raises :class:`~sprsolve_tpu_torch.errors.InvalidPreconditioner`.
    - The layout is the unpadded torch ``DIA`` when the pattern is banded,
      else the CSR: never a padded kernel layout, so no hand kernel runs.
    - ``bounds`` default to Gershgorin's, for the Chebyshev basis."""
    from .solvers.ca_cg import fold_jacobi
    from .utils.bounds import gershgorin_bounds
    from .vecalg import real_dtype

    src = A.to_csr() if isinstance(A, CSC) else A
    scale = None
    if M is not None:
        if method != "ca_cg" or not (isinstance(M, str) and M == "jacobi") \
                or not isinstance(src, CSR):
            raise InvalidPreconditioner(
                "the s-step solvers take no M apply (the CA basis is a "
                "polynomial in the bare operator); ca_cg supports "
                "M='jacobi' on a CSR/CSC input by folding it into the "
                "system — for anything stronger use cg/cg_single_sync/"
                "bicgstab with M"
            )
        # folding a ones vector gives the scale D^{-1/2} itself
        ones = torch.ones(src.shape[0], dtype=real_dtype(src.dtype))
        src, scale, _, _ = fold_jacobi(src, ones)
        scale = scale.to(device)
    op = src
    if isinstance(src, CSR):
        if optimize_layout:
            try:
                op = DIA.from_csr(src, device=device)
            except ValueError:   # a wide pattern: the CSR gather path
                op = src.to(device)
        else:
            op = src.to(device)
    if solver_kwargs.get("bounds") is None and isinstance(op, (CSR, DIA)):
        solver_kwargs["bounds"] = gershgorin_bounds(op)
    return op, scale


def _prepare_op_M(A, method: str, M, optimize_layout: bool, device):
    """Shared pipeline of :func:`solve` and :func:`prepare`: pick the
    execution layout for ``A`` and build or re-lay the preconditioner.
    Returns ``(op, M, padded)``; ``padded`` means the operator works in its
    own vector layout (``pad_vec``/``unpad_vec``).

    - ``method="lsqr"`` stays on the CSR path (A and Aᴴ in one layout, any
      shape) and takes no M.
    - ``method="cs_minres"`` takes only a real symmetric-positive M: the
      string ``"jacobi"`` builds the real 1/|d| of
      :func:`~sprsolve_tpu_torch.precond.real_abs_jacobi` in the operator's
      layout; a complex diagonal or block, ILU(0) and IC(0) are refused
      (``sprsolve_tpu/api.py:251-306``).
    - ``optimize`` lays out any square CSR (banded, ``Reordered``, BSR,
      ``HybridDIA`` or ELL); ``M="jacobi"`` on a flat layout takes its
      ``jacobi_precond()`` where it has one, else the diagonal.
    - On a padded operator (``Reordered`` included) a diagonal is re-laid
      into its layout; a preconditioner built on the operator itself
      (``M.A is op``, e.g. a
      :class:`~sprsolve_tpu_torch.solvers.redblack.MaskedGSPrecond` with
      padded masks) is used as it is; any other is wrapped in
      :class:`~sprsolve_tpu_torch.precond.RelayedPrecond`."""
    from .ops.optimize import optimize
    from .precond import (BlockJacobiPrecond, ComplexDiagPrecond, DiagPrecond,
                          IC0Precond, ILU0Precond, RelayedPrecond, real_abs_jacobi)

    src = A.to_csr() if isinstance(A, CSC) else A
    if method == "lsqr":
        if M is not None:
            raise InvalidPreconditioner("lsqr has no preconditioned form; pass M=None")
        return (src.to(device) if isinstance(src, CSR) else src), None, False

    if isinstance(M, str) and M != "jacobi":
        if method == "cs_minres":
            # gate before any builder runs
            raise InvalidPreconditioner(
                _CS_MINRES_M + "of the string builders only M='jacobi' (→ 1/|d|) "
                "qualifies"
            )
        if M not in _BUILT_M:
            raise ValueError(f"unknown preconditioner {M!r}")
        if M == "amg":
            return _amg(src, optimize_layout, device)
        M = _build_M(M, src, device)

    op = src
    if isinstance(src, CSR):
        op = optimize(src, device=device) if optimize_layout else src.to(device)

    padded = hasattr(op, "pad_vec")
    if method == "cs_minres" and M is not None:
        if isinstance(M, str):
            # real_abs_jacobi builds in the operator's own layout: no relay
            return op, real_abs_jacobi(op), padded
        if isinstance(M, (ComplexDiagPrecond, ILU0Precond, IC0Precond)) or (
                isinstance(M, DiagPrecond) and M.diag_inv.is_complex()) or (
                isinstance(M, BlockJacobiPrecond) and M.inv_blocks.is_complex()):
            raise InvalidPreconditioner(
                _CS_MINRES_M + "a complex diagonal or block, or a nonsymmetric "
                "ILU0/IC0 sweep apply, is not one; use M='jacobi' or a real "
                "symmetric-positive operator"
            )
    if padded:
        if isinstance(M, str):
            M = op.jacobi_precond()
        elif isinstance(M, (DiagPrecond, ComplexDiagPrecond)):
            try:
                M = op.relay_diag_precond(M)
            except NotImplementedError as e:
                raise InvalidPreconditioner(str(e)) from e
        elif M is not None and getattr(M, "A", None) is not op:
            M = RelayedPrecond(inner=M, op=op)
    elif isinstance(M, str):
        # a flat layout: its own Jacobi where it has one (BSR → DiagPrecond,
        # ComplexBSR → ComplexDiagPrecond), else one from its diagonal
        if hasattr(op, "jacobi_precond"):
            M = op.jacobi_precond()
        else:
            diag = op.diagonal() if hasattr(op, "diagonal") else src.diagonal()
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
    the padded-DIA kernels for a banded float32 or complex64 matrix, the
    same behind an RCM permutation for one banded after reordering, else BSR,
    the band+outlier hybrid or ELL; the padding and the permutation are
    handled here) or any operator, used as it is. The solve runs on
    ``device``, by default the CUDA device; ``x`` comes back flat, there.

    ``method="auto"`` picks the solver from the matrix structure (see
    :func:`_auto_method`; ``parity="reference"`` keeps plain BiCGStab for a
    nonsymmetric matrix). ``method="lsqr"`` solves any m×n ``A`` in the
    least-squares sense (``damp=``, ``AH=``; ``AH`` defaults to
    ``A.adjoint()``). ``"gmres"``/``"fgmres"`` take ``restart=``,
    ``"idrs"`` takes ``s=``, and the s-step ``"ca_cg"``/``"ca_bicgstab"``
    take ``s=``, ``basis=`` and ``bounds=`` (Gershgorin by default); they
    run on the unpadded layout, and ``ca_cg`` takes ``M="jacobi"`` only,
    folded into the system. ``M="amg"`` is the RCM-ordered 1-D
    aggregation V-cycle. A CSC is converted to CSR first.
    """
    handle = prepare(A, method=method, M=M, tol=tol, max_iter=max_iter,
                     optimize_layout=optimize_layout, device=device, **solver_kwargs)
    return handle(b, x0)


class PreparedSolver:
    """A solve pipeline optimized once, reusable across right-hand sides
    (the ``mkl_sparse_set_mv_hint`` + ``mkl_sparse_optimize`` amortization).

    Each call converts ``b``/``x0`` to the operator's layout and back::

        handle = prepare(A, M="jacobi", tol=1e-8, device="cuda")
        x1, info1 = handle(b1)
        x2, info2 = handle(b2, x0=x1)
    """

    def __init__(self, op, run, shape, device=None, scale=None):
        self._op = op
        self._run = run
        self._scale = scale   # a folded Jacobi's D^{-1/2} (ca_cg), else None
        self._padded = hasattr(op, "pad_vec")
        self._m, self._n = shape
        self._device = getattr(op, "device", device)

    @property
    def operator(self):
        """The execution-layout operator."""
        return self._op

    def __call__(self, b, x0=None):
        with span("solve"):   # the root span of a request
            device = self._device
            # validate before padding: pad_vec would silently zero-extend a short b
            b = _vec(b, self._m, device, "Input vec")
            x0 = None if x0 is None else _vec(x0, self._n, device, "x0")
            if self._scale is not None:
                b = b * self._scale
                x0 = None if x0 is None else x0 / self._scale
            if self._padded:
                b = self._op.pad_vec(b)
                x0 = None if x0 is None else self._op.pad_vec(x0)
            x, *rest = self._run(self._op, b, x0)
            if self._padded:
                x = self._op.unpad_vec(x)
            if self._scale is not None:
                x = x * self._scale
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
    method, solver = _resolve(method, A, solver_kwargs)
    device = default_device(device)
    if method in _CA_METHODS:
        op, scale = _prepare_ca(A, method, M, optimize_layout, device, solver_kwargs)
        return PreparedSolver(op, partial(solver, tol=tol, max_iter=max_iter,
                                          **solver_kwargs), A.shape, device, scale)
    op, M, _ = _prepare_op_M(A, method, M, optimize_layout, device)
    if method == "lsqr" and "AH" not in solver_kwargs:
        # the adjoint is a host build, made once (sprsolve_tpu/api.py:546-552)
        if not hasattr(op, "adjoint"):
            raise IncompatibleMatrixFormat(
                "lsqr needs the adjoint operator: pass AH= (or use a CSR/CSC "
                "container, whose adjoint is built automatically)"
            )
        solver_kwargs["AH"] = op.adjoint()
    if M is not None:
        solver_kwargs["M"] = M
    return PreparedSolver(op, partial(solver, tol=tol, max_iter=max_iter, **solver_kwargs),
                          A.shape, device)


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

    ``A`` keeps its format (a CSR runs the gather SpMV, not the kernels). A
    CSR or a dense matrix is moved to ``device``, by default the CUDA
    device; an operator object is used where it lives."""

    _fn = None

    def __init__(self, A, size: int, device=None):
        device = default_device(device)
        if isinstance(A, CSR) and A.device != device:
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


class GMRES(_Handle):
    """Restarted GMRES(m) handle for general systems (no reference
    counterpart; the handle shape of :class:`BiCGStab`). ``restart`` is the
    Krylov dimension per cycle."""

    def __init__(self, A, size: int, restart: int = 32, device=None):
        super().__init__(A, size, device)
        self.restart = int(restart)
        self._fn = partial(gmres, restart=self.restart)

    new = classmethod(lambda cls, A, size, restart=32, device=None:
                      cls(A, size, restart, device))


class CSMinRes(_Handle):
    """Complex-symmetric MINRES handle (reference ``src/cs_minres.rs:17-25``).
    ``precond_solve`` (beyond the reference, whose handle exports only
    ``solve``) takes a REAL symmetric-positive M⁻¹; see
    :mod:`~sprsolve_tpu_torch.solvers.cs_minres`."""

    _fn = staticmethod(cs_minres)


class GaussSeidel:
    """Gauss-Seidel handle (reference ``src/gauss_seidel.rs:13-31``).

    Takes a CSR, converted to ELL once here, or an ELL; raises on a
    non-square matrix like the reference ``new``. The sweep runs on the host
    by design (:mod:`~sprsolve_tpu_torch.solvers.gauss_seidel`); the slabs,
    vectors and residuals live on ``device``, by default the CUDA device."""

    def __init__(self, A, device=None):
        device = default_device(device)
        if isinstance(A, CSR):
            A = A.to_ell()
        if not isinstance(A, ELL):
            raise IncompatibleMatrixFormat("Not in CSR format")
        if A.shape[0] != A.shape[1]:
            raise IncompatibleMatrixFormat("Not a square matrix")
        self.A = A.to(device)

    new = classmethod(lambda cls, A, device=None: cls(A, device))

    def solve(self, rhs, x=None, max_iter: int = 1000, eps: float = 0.0):
        b = torch.as_tensor(rhs, device=self.A.device)
        x = torch.zeros_like(b) if x is None else torch.as_tensor(x, device=self.A.device)
        xr, info = gauss_seidel(self.A, b, x, max_iter=max_iter, eps=eps)
        info.raise_if_error()
        return xr, (int(info.iterations), float(info.residual))
