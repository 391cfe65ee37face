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
the port's updates are bitwise those of the JAX package.  The distributed
``axis_name`` argument is gone; reductions are local.
"""

from __future__ import annotations

import torch


def dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """xᵀ·y — no conjugation even for complex (``src/vecalg.rs:19-32``)."""
    return torch.sum(x * y)


def conj_dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """xᴴ·y — conjugate-linear in x, linear in y (``src/vecalg.rs:34-59``)."""
    return torch.sum(torch.conj(x) * y)


def abs2(x: torch.Tensor) -> torch.Tensor:
    """|x|² elementwise, always real — cauchy ``Scalar::square``."""
    if x.is_complex():
        return x.real * x.real + x.imag * x.imag
    return x * x


def norm2_sq(x: torch.Tensor) -> torch.Tensor:
    """Σ|xᵢ|² (real)."""
    return torch.sum(abs2(x))


def norm2(x: torch.Tensor) -> torch.Tensor:
    """‖x‖₂ = sqrt(Σ|xᵢ|²), real (``src/vecalg.rs:602-605``)."""
    return torch.sqrt(norm2_sq(x))


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
