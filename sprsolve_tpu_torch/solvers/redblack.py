"""Multicolor (red-black) Gauss-Seidel: the parallel reformulation.

Counterpart of ``sprsolve_tpu/solvers/redblack.py``.  A greedy host-side
coloring splits the rows into classes with no coupling inside a class; the
rows of one class update together, the classes in order.  Two colors
suffice for 5- and 7-point stencils.  Convergence differs from the
natural-order sweep of :mod:`.gauss_seidel` (same asymptotic rate for
consistently ordered matrices).

- :class:`ColoredELL` regroups the ELL rows by color: each class update is
  a gather, a row sum and an indexed write.
- :class:`MaskedGSPrecond` writes the same sweep as masked whole-vector
  updates, z ← where(mask_c, z + ω·(r − A·z)/d, z), so it runs through any
  operator: on a :class:`~sprsolve_tpu_torch.ops.padded_dia.PaddedDIA` each
  update after the first launches kernel K1.  From z = 0 the map r ↦ z is a
  fixed linear operator, a valid Krylov preconditioner (the "Gauss-Seidel
  preconditioner" of ``BASELINE.md`` config #4).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..errors import Status
from ..ops.spmv import row_sum
from ..sparse.containers import CSR, ELL, _host
from ..utils.timing import span
from ..vecalg import abs2, axpy, conj_dot, eps_for, norm2, real_dtype
from .common import make_info


def greedy_color(csr: CSR) -> np.ndarray:
    """First-fit row coloring of the symmetrized adjacency (host-side): rows
    i and j conflict if a_ij ≠ 0 or a_ji ≠ 0."""
    from ..native import greedy_color as _color
    from ..native import symmetrize_pattern

    n = csr.shape[0]
    sym_indptr, sym_indices = symmetrize_pattern(n, _host(csr.indptr), _host(csr.indices))
    return _color(n, sym_indptr, sym_indices)


@dataclasses.dataclass(frozen=True)
class ColoredELL:
    """ELL rows regrouped by color for the parallel class updates.

    ``perm`` maps a color-block position to its row; ``data``/``cols`` are
    the permuted (n, k) slabs with the diagonal slots in place; ``diag`` is
    the permuted diagonal; ``starts`` delimits the color blocks."""

    data: torch.Tensor      # (n, k) permuted rows
    cols: torch.Tensor      # (n, k) global column ids
    diag: torch.Tensor      # (n,) permuted
    perm: torch.Tensor      # (n,) int64
    starts: Tuple[int, ...]
    shape: Tuple[int, int]

    @property
    def n_colors(self) -> int:
        return len(self.starts) - 1

    @property
    def device(self) -> torch.device:
        return self.data.device

    @staticmethod
    def from_csr(csr: CSR, colors: Optional[np.ndarray] = None) -> "ColoredELL":
        """Color (unless ``colors`` is given) and regroup on the host; the
        slabs land on the CSR's device."""
        if colors is None:
            colors = greedy_color(csr)
        order = np.argsort(colors, kind="stable")
        starts = tuple(int(s) for s in np.concatenate([[0], np.cumsum(np.bincount(colors))]))
        data, cols = ELL.arrays_from_csr(csr)
        as_t = lambda a: torch.as_tensor(a, device=csr.device)
        return ColoredELL(data=as_t(data[order]), cols=as_t(cols[order]),
                          diag=as_t(csr.diagonal_host()[order]), perm=as_t(order),
                          starts=starts, shape=csr.shape)

    def sweep(self, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """One multicolor sweep: each color class in order updates all its
        rows at once from the current x. Returns the new x."""
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        for c in range(self.n_colors):
            s, e = self.starts[c], self.starts[c + 1]
            rows, cls = self.perm[s:e], self.cols[s:e]
            off = cls != rows[:, None]
            sigma = row_sum(torch.where(off, self.data[s:e] * x[cls], zero))
            x = x.index_put((rows,), (b[rows] - sigma) / self.diag[s:e])
        return x

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """A·x from the permuted slabs."""
        contrib = row_sum(self.data * x[self.cols])
        return torch.zeros_like(x).index_put((self.perm,), contrib)


def gauss_seidel_redblack(
    A: ColoredELL,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    max_iter,
    eps,
):
    """Multicolor GS solve with the convergence test and iteration count of
    the sequential solver (absolute residual ‖A·x − b‖ ≤ eps·‖b‖,
    ``src/gauss_seidel.rs:87-108``). The sweeps run on b's device; each
    brings one predicate to the host."""
    if x0 is None:
        x0 = torch.zeros_like(b)
    T, dev = b.dtype, b.device
    rdt = real_dtype(T)
    zero_r = torch.zeros((), dtype=rdt, device=dev)
    if int(max_iter) == 0:
        return x0, make_info(0, zero_r, Status.INSUFFICIENT_ITER)
    if bool(torch.any(abs2(A.diag) < eps_for(T, dev))):
        return x0, make_info(0, zero_r, Status.ZERO_DIAGONAL)

    one = torch.ones((), dtype=T, device=dev)
    tol2 = torch.tensor(eps, dtype=rdt, device=dev) * norm2(b)

    def step(x):
        x = A.sweep(b, x)
        res = norm2(axpy(-one, b, A.matvec(x)))
        return x, res, bool(res <= tol2)

    x, res, done = step(x0)
    it = 1
    while not done and it < int(max_iter):
        x, res, done = step(x)
        if not done:
            it += 1
    status = Status.CONVERGED if done else Status.INSUFFICIENT_ITER
    return x, make_info(it, res, status)


@dataclasses.dataclass(frozen=True)
class MaskedGSPrecond:
    """Multicolor Gauss-Seidel sweeps as masked whole-vector updates.

    For each color class c in order: z ← where(mask_c, z + ω·(r − A·z)/d, z).
    Each update recomputes A·z from the current z, so a class sees the
    classes before it: exact multicolor GS at one SpMV per color, through
    any operator (K1 on a ``PaddedDIA``). The first update of an apply
    skips its SpMV: z = 0 there, so A·z = 0.

    Vectors may be flat or in a padded layout; ``diag`` and the masks must
    be in the same one, the masks False on the halo and the tail so those
    entries stay 0. ``omega`` over-relaxes each update (SOR);
    ``symmetric=True`` runs the classes forward, then backward without
    repeating the middle class (multicolor SSOR: a symmetric map for a
    symmetric A, valid for CG and MINRES)."""

    A: object
    diag: torch.Tensor
    masks: Tuple[torch.Tensor, ...]
    sweeps: int = 1
    omega: float = 1.0
    symmetric: bool = False

    @property
    def shape(self):
        return self.A.shape

    def matvec(self, r: torch.Tensor) -> torch.Tensor:
        with span("precond"):
            # the halo's and pad rows' diagonal is 0: its reciprocal never
            # reaches z (the masks are False there), but keep 1/0 out of it
            one = torch.ones((), dtype=self.diag.dtype, device=self.diag.device)
            safe_diag = torch.where(self.diag == 0, one, self.diag)
            # a Python scalar is rounded to the vectors' dtype, as the JAX
            # package's jnp.asarray(omega, dtype), and needs no copy to the card
            om = float(self.omega)
            order = tuple(self.masks)
            if self.symmetric:
                # palindrome without the middle class twice: rows of one class
                # do not couple, so a repeat would cost a SpMV and change nothing
                order = order + order[::-1][1:]
            z, first = torch.zeros_like(r), True
            for _ in range(self.sweeps):
                for mask in order:
                    if first:
                        zi, first = om * r / safe_diag, False
                    else:
                        zi = z + om * (r - self.A.matvec(z)) / safe_diag
                    z = torch.where(mask, zi, z)
            return z

    def matvec_dot(self, r: torch.Tensor):
        z = self.matvec(r)
        return z, conj_dot(r, z)

    def pspec(self) -> "MaskedGSPrecond":
        """The row slicing of each field for a row-partitioned solve
        (``sprsolve_tpu/solvers/redblack.py:231-246``): the operator's own
        spec, the diagonal and the masks on their rows (dim 0). The
        operator must be a distributed one (``sprsolve_tpu_torch.parallel``)
        in the layout of ``diag`` and the masks."""
        return dataclasses.replace(
            self, A=self.A.pspec() if hasattr(self.A, "pspec") else 0, diag=0,
            masks=tuple(0 for _ in self.masks))


def color_masks(colors: np.ndarray, device=None) -> Tuple[torch.Tensor, ...]:
    """One boolean mask per color class, flat layout."""
    colors = np.asarray(colors)
    return tuple(torch.as_tensor(colors == c, device=device)
                 for c in range(int(colors.max()) + 1))


@dataclasses.dataclass(frozen=True)
class MulticolorGSPrecond:
    """M⁻¹·r ≈ ``sweeps`` multicolor GS sweeps on A·z = r from z = 0, a fixed
    linear operator (``BASELINE.md`` config #4's preconditioner)."""

    A: ColoredELL
    sweeps: int = 1

    @property
    def shape(self):
        return self.A.shape

    def matvec(self, r: torch.Tensor) -> torch.Tensor:
        with span("precond"):
            z = torch.zeros_like(r)
            for _ in range(self.sweeps):
                z = self.A.sweep(r, z)
            return z

    def matvec_dot(self, r: torch.Tensor):
        z = self.matvec(r)
        return z, conj_dot(r, z)
