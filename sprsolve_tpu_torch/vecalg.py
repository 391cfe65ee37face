"""Dense BLAS-1 vector algebra for the solvers.

PyTorch counterpart of ``sprsolve_tpu/vecalg.py`` (reference
``src/vecalg.rs``).  Same conventions:

- ``dot``        = xᵀy, no conjugation
- ``conj_dot``   = xᴴy, conjugate-linear in the first argument
- ``norm2``      = sqrt(Σ|xᵢ|²), always real
- ``axpy(a,x,y)``  = y + a·x
- ``axpby(a,x,b,y)`` = a·x + b·y
- ``scale``/``rscale`` = a·x with a scalar of the vector's type / a real scalar

``axpy``/``axpby`` go through ``torch.addcmul``: one pass instead of two, and
the multiply-add is fused exactly where XLA fuses it (an FMA), so on the CPU
the port's updates are bitwise those of the JAX package.

Distributed use: the reductions take ``group=`` (a ``torch.distributed``
process group), the JAX package's ``axis_name``; with a group they return
the sum over its ranks (:func:`group_sum`), so one solver runs on one
device and row-partitioned over ranks. ``group=None`` is the single-device
path, unchanged.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

# the numpy scalar type of each dtype: the solvers that do their small
# coefficient algebra on the host do it in the solve's own precision
NUMPY_DTYPES = {torch.float32: np.float32, torch.float64: np.float64,
                torch.complex64: np.complex64, torch.complex128: np.complex128}


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` (a 0-d or small tensor of partials) summed over the ranks of
    ``group``, the same bits on every rank; one collective call.

    Each rank puts its partials in its own row of a zero ``(world, k)``
    slab and the group sums the slab: every entry has one nonzero term, so
    the collective is exact whatever the backend's order. Every rank then
    holds the same slab and sums it with the same ``sum(0)``, so all ranks
    get the same bits, run after run, and one rank's sum is its own partial
    bit for bit. Counts its calls and the bytes of the slab it reduces in
    ``calls`` and ``bytes`` (``parallel.comm`` re-exports it beside the
    other primitives)."""
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    flat = t.reshape(-1)
    slab = torch.zeros((world, flat.numel()), dtype=t.dtype, device=t.device)
    slab[rank] = flat
    wire = torch.view_as_real(slab) if slab.is_complex() else slab
    dist.all_reduce(wire, op=dist.ReduceOp.SUM, group=group)
    all_reduce_sum.calls += 1
    all_reduce_sum.bytes += wire.numel() * wire.element_size()
    return slab.sum(0).reshape(t.shape)


all_reduce_sum.calls = all_reduce_sum.bytes = 0


def group_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t`` summed over the ranks of ``group`` (``lax.psum``,
    :func:`all_reduce_sum`); ``t`` itself for ``group=None``."""
    return t if group is None else all_reduce_sum(t, group)


def dot(x: torch.Tensor, y: torch.Tensor, group=None) -> torch.Tensor:
    """xᵀ·y — no conjugation even for complex (``src/vecalg.rs:19-32``)."""
    return group_sum(torch.sum(x * y), group)


def conj_dot(x: torch.Tensor, y: torch.Tensor, group=None) -> torch.Tensor:
    """xᴴ·y — conjugate-linear in x, linear in y (``src/vecalg.rs:34-59``)."""
    return group_sum(torch.sum(torch.conj(x) * y), group)


def abs2(x: torch.Tensor) -> torch.Tensor:
    """|x|² elementwise, always real — cauchy ``Scalar::square``."""
    if x.is_complex():
        return x.real * x.real + x.imag * x.imag
    return x * x


def norm2_sq(x: torch.Tensor, group=None) -> torch.Tensor:
    """Σ|xᵢ|² (real)."""
    return group_sum(torch.sum(abs2(x)), group)


def norm2(x: torch.Tensor, group=None) -> torch.Tensor:
    """‖x‖₂ = sqrt(Σ|xᵢ|²), real (``src/vecalg.rs:602-605``)."""
    return torch.sqrt(norm2_sq(x, group))


def sqrt_exact(t: torch.Tensor) -> torch.Tensor:
    """Elementwise √t, correctly rounded and the same bits in every process.

    On the CPU ``torch.sqrt`` of a large float64 tensor is not correctly
    rounded (about 0.9% of a million random values come out 1 ULP off),
    and now and then one thread's chunk comes out 1.9e-11 off (4 of 108
    fresh processes on the damped 100³ Poisson's |d|², 1 of 70 on a bare
    sqrt); NumPy's sqrt is the hardware's, as XLA's and CUDA's are. The
    preconditioner builds take their square roots here: a changed bit
    there moves every iteration count after it."""
    if t.device.type == "cpu":
        return torch.from_numpy(np.sqrt(t.numpy()))
    return torch.sqrt(t)


def scale(a, x: torch.Tensor) -> torch.Tensor:
    """a·x with scalar a of the vector's dtype (``src/vecalg.rs:593-595``)."""
    return x * a


def rscale(a, x: torch.Tensor) -> torch.Tensor:
    """a·x with *real* scalar a on a possibly-complex x (``src/vecalg.rs:597-600``)."""
    return x * a


def conj(x: torch.Tensor) -> torch.Tensor:
    """Elementwise conjugate (``src/vecalg.rs:578-584``), materialized: a lazy
    conjugate view would reach a kernel's raw pointer unconjugated."""
    return torch.conj_physical(x)


def axpy(a: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """y + a·x (``src/vecalg.rs:571-576``). Returns the new y; ``a`` is a 0-d tensor."""
    return torch.addcmul(y, x, a)


def axpby(a: torch.Tensor, x: torch.Tensor, b: torch.Tensor,
          y: torch.Tensor) -> torch.Tensor:
    """a·x + b·y (MKL's axpby extension, ``src/vecalg.rs:586-591``)."""
    return torch.addcmul(y * b, x, a)


def mul_real(z: torch.Tensor, s) -> torch.Tensor:
    """z·s with s real — cauchy ``Scalar::mul_real``."""
    return z * s


def real_dtype(dtype: torch.dtype) -> torch.dtype:
    """The real counterpart of a (possibly complex) dtype: T::Real."""
    return dtype.to_real() if dtype.is_complex else dtype


def eps_for(dtype: torch.dtype, device=None) -> torch.Tensor:
    """Machine epsilon of the real counterpart of ``dtype`` as a 0-d tensor
    (T::Real::epsilon())."""
    rdt = real_dtype(dtype)
    return torch.tensor(torch.finfo(rdt).eps, dtype=rdt, device=device)


def full_precision_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with TF32 off for the call, whatever the global setting: a
    float32 product on the card then rounds like the float32 reference
    (the JAX package pins ``Precision.HIGHEST`` on its basis and Gram
    products), not to a 10-bit mantissa."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return a @ b
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
