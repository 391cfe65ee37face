"""Preconditioners.

Counterpart of ``sprsolve_tpu/precond.py`` (reference ``src/precond.rs``):

- the diagonal (Jacobi) ones: the reciprocal of the diagonal is taken once
  at construction and the apply is an elementwise multiply; as in the
  reference, a real diagonal may serve a complex system
  (``src/precond.rs:6-13``);
- :class:`ChebyshevPrecond`, a polynomial in A: its apply is ``degree``
  SpMVs through the operator (kernel K1 on a ``PaddedDIA``), with the
  spectral interval from :func:`estimate_spectral_bounds` (Lanczos);
- :class:`BlockJacobiPrecond`: dense diagonal blocks inverted on the host,
  applied as one batched matrix product at full precision;
- :class:`ILU0Precond` and :class:`IC0Precond`: factored on the host
  (:mod:`.native`), applied by truncated triangular sweeps, each one SpMV
  with a strict triangular factor laid out by ``optimize(...,
  prefer_kernels=False, allow_reorder=False)``;
- :class:`RelayedPrecond`, which applies a flat-layout preconditioner to
  the vectors of a padded operator;
- :class:`InnerSolvePrecond`, a budgeted inner Krylov solve (for FGMRES).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .errors import InvalidPreconditioner, ZeroDiagonalElem
from .sparse.bsr import full_precision_bmm
from .sparse.containers import CSR, _host
from .utils.timing import span
from .vecalg import conj_dot, real_dtype, sqrt_exact


@dataclasses.dataclass(frozen=True)
class DiagPrecond:
    """Jacobi (diagonal) preconditioner: M⁻¹ = diag(1/d)."""

    diag_inv: torch.Tensor

    @staticmethod
    def new(diag, device=None) -> "DiagPrecond":
        diag = torch.as_tensor(diag, device=device)
        return DiagPrecond(diag_inv=torch.ones((), dtype=diag.dtype,
                                               device=diag.device) / diag)

    @property
    def shape(self):
        n = self.diag_inv.shape[0]
        return (n, n)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        with span("precond"):
            return x * self.diag_inv

    def matvec_dot(self, x: torch.Tensor):
        # the reference leaves this unimplemented (src/precond.rs:55-62)
        y = x * self.diag_inv
        return y, conj_dot(x, y)


@dataclasses.dataclass(frozen=True)
class ComplexDiagPrecond:
    """Jacobi preconditioner with a complex diagonal: M⁻¹ = diag(1/d).

    The JAX package stores re/im planes because some of its backends reject
    complex device buffers; here ``diag_inv`` is one complex tensor. It is
    its own class, not a ``DiagPrecond``, so that the operators can fold it
    into kernel K7 (``ops.operator.mv_prec_wdot``) and CS-MINRES can refuse
    it (a complex diagonal is no real symmetric-positive M⁻¹)."""

    diag_inv: torch.Tensor

    @staticmethod
    def new(diag, device=None) -> "ComplexDiagPrecond":
        d = torch.as_tensor(diag, device=device)
        if not d.is_complex():
            d = d.to(torch.complex64 if d.dtype == torch.float32 else torch.complex128)
        return ComplexDiagPrecond(diag_inv=torch.ones((), dtype=d.dtype,
                                                      device=d.device) / d)

    @property
    def shape(self):
        n = self.diag_inv.shape[0]
        return (n, n)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        with span("precond"):
            return x * self.diag_inv

    def matvec_dot(self, x: torch.Tensor):
        y = self.matvec(x)
        return y, conj_dot(x, y)


def real_abs_jacobi(op) -> DiagPrecond:
    """Real 1/|d| Jacobi in ``op``'s own layout — the preconditioner shape
    the Saunders process of preconditioned CS-MINRES needs (real symmetric
    positive; Freund's standard choice for complex-symmetric systems).

    A two-plane padded operator builds |d| from its plane diagonals, a real
    padded operator from its padded diagonal, anything else from
    ``diagonal()`` on the host. A :class:`~sprsolve_tpu_torch.ops.reordered.Reordered`
    operator builds from its inner operator, so the diagonal lands in the
    permuted order the solve runs in (``sprsolve_tpu/precond.py:594-595``).
    Zero diagonals (and the padded layout's pad slots) are forced to 1,
    which keeps them inert."""
    from .ops.reordered import Reordered

    if isinstance(op, Reordered):
        return real_abs_jacobi(op.inner)
    if hasattr(op, "diagonal_padded"):
        if hasattr(op, "re"):
            dr, di = op.re.diagonal_padded(), op.im.diagonal_padded()
            d = sqrt_exact(dr * dr + di * di)
        else:
            d = op.diagonal_padded().abs()
        one = torch.ones((), dtype=d.dtype, device=d.device)
        return DiagPrecond(diag_inv=one / torch.where(d == 0, one, d))
    d = np.abs(_host(op.diagonal()))
    d[d == 0] = 1.0
    rdt = d.dtype if d.dtype in (np.float32, np.float64) else np.float32
    return DiagPrecond.new(d.astype(rdt), device=getattr(op, "device", None))


@dataclasses.dataclass(frozen=True)
class ChebyshevPrecond:
    """Chebyshev polynomial preconditioner: M⁻¹ = p_k(A) ≈ A⁻¹ on [λmin, λmax].

    The apply is ``degree`` SpMVs and axpys through the operator, with no
    row dependency and no triangular solve: on a ``PaddedDIA`` each SpMV is
    kernel K1. It needs an SPD (or HPD) A and an interval that holds its
    spectrum (:meth:`auto` estimates one)."""

    A: object
    lmin: float
    lmax: float
    degree: int = 4

    @property
    def shape(self):
        return self.A.shape

    @staticmethod
    def estimate_lmax(A, x_example, iters: int = 20) -> float:
        """Power-iteration estimate of the largest |eigenvalue| (host loop)."""
        x = x_example
        if float(torch.linalg.vector_norm(x)) == 0.0:
            x = torch.ones_like(x_example)
        lam = 1.0
        for _ in range(iters):
            y = A.matvec(x)
            lam = float(torch.linalg.vector_norm(y))
            x = y / lam
        return lam

    @classmethod
    def auto(cls, A, x_example=None, *, degree: int = 4, lanczos_iters: int = 30,
             seed: int = 0) -> "ChebyshevPrecond":
        """Build with the bounds of :func:`estimate_spectral_bounds`. Raises
        :class:`~sprsolve_tpu_torch.errors.InvalidPreconditioner` unless the
        estimated spectrum is positive (A SPD/HPD)."""
        lmin, lmax = estimate_spectral_bounds(A, x_example, m=lanczos_iters, seed=seed)
        if lmin <= 0.0:
            raise InvalidPreconditioner(
                f"Chebyshev needs a positive spectrum; estimated "
                f"[{lmin:.3g}, {lmax:.3g}] — is A SPD?"
            )
        return cls(A=A, lmin=lmin, lmax=lmax, degree=degree)

    def matvec(self, r: torch.Tensor) -> torch.Tensor:
        # Chebyshev iteration for A·z = r from z₀ = 0 (Saad, Iterative
        # Methods, alg. 12.1): θ = (λmax + λmin)/2, δ = (λmax − λmin)/2
        # the Python scalars round to r's dtype (the JAX package's
        # jnp.asarray(v, r.dtype)) and need no copy to the card
        with span("precond"):
            theta = (self.lmax + self.lmin) / 2.0
            delta = (self.lmax - self.lmin) / 2.0
            sigma1 = theta / delta
            rho = 1.0 / sigma1
            z = r / theta
            d = z
            res = r - self.A.matvec(z)
            for _ in range(self.degree - 1):
                rho_new = 1.0 / (2.0 * sigma1 - rho)
                d = res * (2.0 * rho_new / delta) + d * (rho_new * rho)
                z = z + d
                res = r - self.A.matvec(z)
                rho = rho_new
            return z

    def matvec_dot(self, r: torch.Tensor):
        z = self.matvec(r)
        return z, conj_dot(r, z)


def estimate_spectral_bounds(A, x_example=None, *, m: int = 30, seed: int = 0,
                             safety: float = 0.05):
    """The extreme eigenvalues of a Hermitian operator, estimated.

    ``m`` steps of Lanczos with full reorthogonalization, driven from the
    host against ``A.matvec`` (K1 on a ``PaddedDIA``), a one-time setup
    cost. Returns ``(lmin, lmax)`` widened by ``safety`` at each end (Ritz
    values lie inside the spectrum, and Chebyshev's interval must hold it).

    ``x_example`` sets the start vector's layout and dtype; by default a
    seeded unit-normal vector of ``A.shape[0]`` entries, of A's dtype on A's
    device, and put into A's padded layout where A has one."""
    if x_example is None:
        dt = getattr(A, "dtype", None) or torch.float32
        dev = getattr(A, "device", None)
        v = np.random.default_rng(seed).standard_normal(A.shape[0])
        x = torch.as_tensor(v, dtype=real_dtype(dt), device=dev).to(dt)
        if hasattr(A, "pad_vec"):
            x = A.pad_vec(x)
    else:
        x = torch.as_tensor(x_example)
    vdot = lambda a, b: torch.sum(torch.conj(a) * b)
    q = x / float(torch.linalg.vector_norm(x))
    basis = [q]
    alphas, betas = [], []
    beta = 0.0
    q_prev = torch.zeros_like(q)
    for _ in range(m):
        w = A.matvec(q)
        alpha = float(vdot(q, w).real)
        w = w - alpha * q - beta * q_prev
        for qq in basis:   # full reorthogonalization (small m)
            w = w - vdot(qq, w) * qq
        alphas.append(alpha)
        beta = float(torch.linalg.vector_norm(w))
        if not np.isfinite(beta) or beta < 1e-30:
            break
        betas.append(beta)
        q_prev, q = q, w / beta
        basis.append(q)
    T = np.diag(np.asarray(alphas, np.float64))
    if len(alphas) > 1:
        off = np.asarray(betas[: len(alphas) - 1], np.float64)
        T += np.diag(off, 1) + np.diag(off, -1)
    ev = np.linalg.eigvalsh(T)
    lmin, lmax = float(ev[0]), float(ev[-1])
    lmin = lmin * (1.0 - safety) if lmin > 0 else lmin * (1.0 + safety)
    lmax = lmax * (1.0 + safety) if lmax > 0 else lmax * (1.0 - safety)
    return lmin, lmax


@dataclasses.dataclass(frozen=True)
class BlockJacobiPrecond:
    """Block-Jacobi preconditioner: M⁻¹ = blockdiag(A₁₁⁻¹, …, A_kk⁻¹).

    Each dense ``bs×bs`` diagonal block is inverted once on the host (in
    f64/c128); the apply is one batched ``(nb, bs, bs) × (nb, bs)`` product.
    For an SPD/HPD A every block is too, so M⁻¹ is HPD: valid for CG and
    for MINRES's β² gate (``src/minres.rs:235-244``)."""

    inv_blocks: torch.Tensor   # (nb, bs, bs)
    n: int

    @property
    def shape(self):
        return (self.n, self.n)

    @staticmethod
    def from_csr(A: CSR, *, block_size: int = 16, device=None) -> "BlockJacobiPrecond":
        """Build from a CSR on the host; the blocks land on ``device`` (by
        default the CSR's)."""
        n = A.shape[0]
        bs = int(block_size)
        nb = -(-n // bs)
        data, indices = _host(A.data), _host(A.indices).astype(np.int64)
        rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(_host(A.indptr)))
        in_block = (rows // bs) == (indices // bs)
        r, c, v = rows[in_block], indices[in_block], data[in_block]
        blocks = np.zeros((nb, bs, bs), dtype=data.dtype)
        # add.at sums duplicate (row, col) entries, as CSR.diagonal() does
        np.add.at(blocks, (r // bs, r % bs, c % bs), v)
        pad = np.arange(n, nb * bs)   # a unit diagonal keeps the tail inert
        blocks[pad // bs, pad % bs, pad % bs] = 1
        wide = blocks.astype(np.complex128 if np.iscomplexobj(data) else np.float64)
        try:
            inv = np.linalg.inv(wide)
        except np.linalg.LinAlgError:
            raise InvalidPreconditioner("block-Jacobi: a diagonal block is singular") from None
        dev = A.device if device is None else device
        return BlockJacobiPrecond(
            inv_blocks=torch.as_tensor(inv.astype(data.dtype), device=dev), n=n)

    def matvec(self, r: torch.Tensor) -> torch.Tensor:
        with span("precond"):
            nb, bs, _ = self.inv_blocks.shape
            rp = torch.nn.functional.pad(r, (0, nb * bs - self.n)).reshape(nb, bs, 1)
            z = full_precision_bmm(self.inv_blocks, rp.to(self.inv_blocks.dtype))
            return z.reshape(-1)[: self.n]

    def matvec_dot(self, x: torch.Tensor):
        y = self.matvec(x)
        return y, conj_dot(x, y)


def _split_factored(n, indptr, indices, factored):
    """Host split of a factored values array into CSR triplets (strict
    lower, strict upper, diagonal). The diagonal holds diag(U) after ilu0
    and diag(L) after ic0; ic0 leaves the strict upper positions as they
    were, so its caller ignores that triplet."""
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    cols = indices.astype(np.int64)
    diag = np.zeros(n, dtype=factored.dtype)
    diag[rows[cols == rows]] = factored[cols == rows]

    def csr_of(mask):
        ip = np.zeros(n + 1, dtype=np.int64)
        ip[1:] = np.cumsum(np.bincount(rows[mask], minlength=n))
        return ip, indices[mask].astype(np.int32), factored[mask]

    return csr_of(cols < rows), csr_of(cols > rows), diag


def _operator_of(n, trip, dtype, device, layout_kwargs):
    """The operator of one triangular part on ``device``, or None if empty:
    :func:`~sprsolve_tpu_torch.optimize`'s flat layout of it. The sweeps
    apply it to vectors in the original order, so ``allow_reorder`` is
    False: a ``Reordered`` factor would run in its permuted order there
    (the JAX package's ``_operator_of``, ``precond.py:349-365``, leaves it
    on, and its apply is wrong wherever RCM bands a factor)."""
    from .ops.optimize import optimize

    ip, ind, val = trip
    if len(val) == 0:
        return None
    csr = CSR.from_arrays(val.astype(dtype, copy=False), ind, ip, (n, n))
    return optimize(csr, device=device, **{**layout_kwargs, "allow_reorder": False})


def _sweep_lower(L_s, r, y0, sweeps):
    """Truncated-Neumann solve of (I + L_s)·y = r: y ← r − L_s·y."""
    if L_s is None:
        return r
    y = y0
    for _ in range(sweeps):
        y = r - L_s.matvec(y)
    return y


def _sweep_scaled(N_s, d_inv, r, z0, sweeps):
    """Truncated-Jacobi solve of (D + N_s)·z = r: z ← D⁻¹(r − N_s·z)."""
    if N_s is None:
        return r * d_inv
    z = z0
    for _ in range(sweeps):
        z = (r - N_s.matvec(z)) * d_inv
    return z


def _factor_inputs(A: CSR, device):
    """(n, indptr, indices, values, device) of a CSR on the host; the
    device is ``device``, else the CSR's."""
    return (A.shape[0], _host(A.indptr).astype(np.int64),
            _host(A.indices).astype(np.int32), _host(A.data),
            A.device if device is None else torch.device(device))


@dataclasses.dataclass(frozen=True)
class ILU0Precond:
    """ILU(0) with iterative (truncated-Neumann/Jacobi) triangular solves.

    A ≈ L·U with no fill-in, factored once on the host (:func:`.native.ilu0`).
    The apply replaces the sequential triangular solves by ``sweeps``
    sweeps, each one SpMV with a strict triangular factor (Chow & Patel,
    "Fine-grained parallel ILU"); with ``sweeps`` at least the factor's
    level depth the solves are exact. Not symmetric: use it with BiCGStab;
    for MINRES use :class:`IC0Precond`."""

    L_s: object                 # strict lower of L (unit diagonal implied), or None
    U_s: object                 # strict upper of U, or None
    du_inv: torch.Tensor        # 1 / diag(U)
    sweeps: int = 3

    @property
    def shape(self):
        n = self.du_inv.shape[0]
        return (n, n)

    @staticmethod
    def from_csr(A: CSR, *, sweeps: int = 3, device=None, **layout_kwargs):
        """Factor the CSR on the host and lay out the triangular parts with
        :func:`~sprsolve_tpu_torch.optimize` on ``device`` (by default the
        CSR's). ``prefer_kernels`` defaults to False: a padded operator's
        layout does not compose inside this flat apply; ``allow_reorder``
        is always False, for the same reason."""
        from . import native

        n, indptr, indices, values, dev = _factor_inputs(A, device)
        try:
            factored = native.ilu0(n, indptr, indices, values)
        except ZeroDivisionError as e:
            raise ZeroDiagonalElem(f"ILU(0): zero pivot at row {e.args[0]}") from None
        lo, up, diag = _split_factored(n, indptr, indices, factored)
        layout_kwargs.setdefault("prefer_kernels", False)
        return ILU0Precond(
            L_s=_operator_of(n, lo, values.dtype, dev, layout_kwargs),
            U_s=_operator_of(n, up, values.dtype, dev, layout_kwargs),
            du_inv=torch.as_tensor(np.ones((), values.dtype) / diag, device=dev),
            sweeps=sweeps,
        )

    def matvec(self, r: torch.Tensor) -> torch.Tensor:
        # L·y = r (unit lower), then U·z = y (upper with the diagonal du)
        with span("precond"):
            y = _sweep_lower(self.L_s, r, r, self.sweeps)
            return _sweep_scaled(self.U_s, self.du_inv, y, y * self.du_inv, self.sweeps)

    def matvec_dot(self, x: torch.Tensor):
        y = self.matvec(x)
        return y, conj_dot(x, y)


@dataclasses.dataclass(frozen=True)
class IC0Precond:
    """IC(0) (incomplete Cholesky) with an SPD apply, for MINRES and CG.

    A ≈ L·Lᴴ factored on the host (:func:`.native.ic0`). The apply solves
    with L and then Lᴴ by ``sweeps`` truncated-Jacobi iterations each. With
    S = Σ_{j≤sweeps} (−D⁻¹L_s)ʲ D⁻¹ the approximate L-solve, the Lᴴ-solve
    with the same count is Sᴴ, so the apply Sᴴ·S is Hermitian positive
    definite for any sweep count and passes MINRES's β² gate."""

    L_s: object                 # strict lower of L, or None
    LH_s: object                # its conjugate transpose (strict upper), or None
    dl_inv: torch.Tensor        # 1 / diag(L), real positive
    sweeps: int = 3

    @property
    def shape(self):
        n = self.dl_inv.shape[0]
        return (n, n)

    @staticmethod
    def from_csr(A: CSR, *, sweeps: int = 3, device=None, **layout_kwargs):
        """Factor the CSR on the host; as :meth:`ILU0Precond.from_csr`."""
        from . import native

        n, indptr, indices, values, dev = _factor_inputs(A, device)
        try:
            factored = native.ic0(n, indptr, indices, values)
        except ZeroDivisionError as e:
            raise InvalidPreconditioner(
                f"IC(0): non-positive pivot at row {e.args[0]} "
                "(matrix not SPD on this pattern)"
            ) from None
        lo, _, diag = _split_factored(n, indptr, indices, factored)
        # Lᴴ's strict part on the host: the transpose of the strict lower CSR
        ip, ind, val = lo
        rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(ip))
        tr_rows, tr_cols = ind.astype(np.int64), rows
        order = np.lexsort((tr_cols, tr_rows))
        tip = np.zeros(n + 1, dtype=np.int64)
        tip[1:] = np.cumsum(np.bincount(tr_rows, minlength=n))
        up = (tip, tr_cols[order].astype(np.int32), np.conj(val)[order])
        layout_kwargs.setdefault("prefer_kernels", False)
        rdt = np.real(diag).dtype
        return IC0Precond(
            L_s=_operator_of(n, lo, values.dtype, dev, layout_kwargs),
            LH_s=_operator_of(n, up, values.dtype, dev, layout_kwargs),
            dl_inv=torch.as_tensor(np.ones((), rdt) / np.real(diag).astype(rdt), device=dev),
            sweeps=sweeps,
        )

    def matvec(self, r: torch.Tensor) -> torch.Tensor:
        with span("precond"):
            y = _sweep_scaled(self.L_s, self.dl_inv, r, r * self.dl_inv, self.sweeps)
            return _sweep_scaled(self.LH_s, self.dl_inv, y, y * self.dl_inv, self.sweeps)

    def matvec_dot(self, x: torch.Tensor):
        y = self.matvec(x)
        return y, conj_dot(x, y)


@dataclasses.dataclass(frozen=True)
class RelayedPrecond:
    """A flat-layout preconditioner applied to a padded operator's vectors:
    each apply unpads, applies ``inner`` and pads again (halo and tail 0).
    A diagonal has its own, cheaper path (``relay_diag_precond``)."""

    inner: object
    op: object

    @property
    def shape(self):
        return self.inner.shape

    def matvec(self, r2: torch.Tensor) -> torch.Tensor:
        with span("precond"):
            return self.op.pad_vec(self.inner.matvec(self.op.unpad_vec(r2)))

    def matvec_dot(self, r2: torch.Tensor):
        y = self.matvec(r2)
        return y, conj_dot(r2, y)


@dataclasses.dataclass(frozen=True)
class InnerSolvePrecond:
    """A preconditioner that applies a budgeted INNER Krylov solve, z ≈ A⁻¹·r
    (Saad, *Iterative Methods* §9.4).

    The map r ↦ z is a nonlinear function of r (the Krylov polynomial
    depends on its input), so the outer solver must be flexible:
    :func:`~sprsolve_tpu_torch.solvers.fgmres.fgmres`.  Each apply starts
    from z₀ = 0, runs at most ``iters`` steps (``inner_tol`` allows an
    early exit) and ignores the inner status.  ``A`` should be the SAME
    (possibly padded) operator the outer solve runs on, so the vector
    layouts agree: ``solve()`` and ``prepare()`` then pass the object
    through as it is (``M.A is op``), and on a ``PaddedDIA`` an inner CG
    runs K3.  ``inner_M`` preconditions the inner solve itself.  ``group``
    (``sprsolve_tpu/precond.py:658``) runs the inner solve on a process
    group, for an outer solve row-partitioned on it.
    """

    A: object
    inner_M: object = None
    method: str = "cg"
    iters: int = 8
    inner_tol: float = 0.0
    group: object = None

    @property
    def shape(self):
        return getattr(self.A, "shape", None)

    # inner methods with the standard (A, b, x0=None, *, M=None, tol,
    # max_iter) -> (x, info) signature: a whitelist, so that a name of
    # another signature fails here with a clear message
    _INNER_METHODS = (
        "cg", "cg_single_sync", "bicgstab", "bicgstabl", "cgs", "tfqmr",
        "minres", "gmres", "fgmres", "idrs", "cocg", "cs_minres",
    )

    def _solver(self):
        if self.method not in self._INNER_METHODS:
            raise InvalidPreconditioner(
                f"InnerSolvePrecond: inner method {self.method!r} is not "
                f"supported (choose one of {', '.join(self._INNER_METHODS)})"
            )
        from . import solvers

        return getattr(solvers, self.method)

    def matvec(self, r: torch.Tensor) -> torch.Tensor:
        with span("precond"):
            z, _info = self._solver()(self.A, r, M=self.inner_M, tol=self.inner_tol,
                                      max_iter=self.iters, group=self.group)
        return z

    def matvec_dot(self, r: torch.Tensor):
        z = self.matvec(r)
        return z, conj_dot(r, z, self.group)
