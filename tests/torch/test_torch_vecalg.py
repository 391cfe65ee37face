"""Cross tests of the port's vecalg, errors and solver plumbing against the
JAX package (``sprsolve_tpu.vecalg``, ``errors``, ``solvers.common``).

Inputs are made from a seed with NumPy and handed to both packages.
Tolerances: real elementwise ops and the fused multiply-adds of
axpy/axpby round identically in both (torch.addcmul fuses where jitted XLA
does, as inside the solvers), so those are compared bitwise; complex
multiplies expand into several real multiply-adds that the two fuse
differently, and reductions are summed in another order, so those agree to
a few ulps: rtol 1e-5 (f32/c64) and 1e-13 (f64/c128)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sprsolve_tpu.errors as jerr
import sprsolve_tpu.solvers.common as jcommon
from sprsolve_tpu import vecalg as jv
from sprsolve_tpu_torch import errors as terr
from sprsolve_tpu_torch import vecalg as tv
from sprsolve_tpu_torch.solvers import common as tcommon

torch.set_num_threads(2)

DTYPES = ["float32", "float64", "complex64", "complex128"]
RTOL = {"float32": 1e-5, "complex64": 1e-5, "float64": 1e-13, "complex128": 1e-13}


def _mk(dtype, n=37, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(n)
    if dtype.startswith("complex"):
        a = a + 1j * rng.standard_normal(n)
    return a.astype(dtype)


def _both(a):
    return jnp.asarray(a), torch.from_numpy(np.array(a))


def _scalar(v, dtype):
    a = np.asarray(v, dtype=dtype)
    return jnp.asarray(a), torch.tensor(a)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


REDUCTIONS = ["dot", "conj_dot", "norm2_sq", "norm2"]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", REDUCTIONS)
def test_reductions_match_jax(name, dtype):
    xj, xt = _both(_mk(dtype, seed=1))
    yj, yt = _both(_mk(dtype, seed=2))
    args_j, args_t = ((xj, yj), (xt, yt)) if "dot" in name else ((xj,), (xt,))
    got = getattr(tv, name)(*args_t)
    want = getattr(jv, name)(*args_j)
    assert got.dtype.is_complex == bool(jnp.iscomplexobj(want))
    np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL[dtype])


ELEMENTWISE = ["abs2", "conj", "scale", "rscale", "mul_real", "axpy", "axpby"]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ELEMENTWISE)
def test_elementwise_match_jax(name, dtype):
    xj, xt = _both(_mk(dtype, seed=3))
    yj, yt = _both(_mk(dtype, seed=4))
    rdt = "float32" if dtype in ("float32", "complex64") else "float64"
    aj, at = _scalar(2.5 - (0.5j if dtype.startswith("complex") else 0), dtype)
    bj, bt = _scalar(-1.5, dtype)
    sj, st = _scalar(0.75, rdt)
    args = {
        "abs2": ((xj,), (xt,)),
        "conj": ((xj,), (xt,)),
        "scale": ((aj, xj), (at, xt)),
        "rscale": ((sj, xj), (st, xt)),
        "mul_real": ((xj, sj), (xt, st)),
        "axpy": ((aj, xj, yj), (at, xt, yt)),
        "axpby": ((aj, xj, bj, yj), (at, xt, bt, yt)),
    }[name]
    got = _np(getattr(tv, name)(*args[1]))
    want = _np(jax.jit(getattr(jv, name))(*args[0]))
    assert got.dtype == want.dtype
    if dtype.startswith("complex") and name not in ("conj", "rscale", "mul_real"):
        np.testing.assert_allclose(got, want, rtol=RTOL[dtype])
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_real_dtype_and_eps_for(dtype):
    tdt = getattr(torch, dtype)
    rdt = tv.real_dtype(tdt)
    assert str(rdt).replace("torch.", "") == str(np.dtype(jv.real_dtype(jnp.dtype(dtype))))
    assert float(tv.eps_for(tdt)) == float(jv.eps_for(jnp.dtype(dtype)))
    assert tv.eps_for(tdt).dtype == rdt


def test_axpby_doctest_values():
    # src/vecalg.rs:123-132: axpby(2, ones, -1, twos) == 0
    out = tv.axpby(torch.tensor(2.0), torch.ones(128), torch.tensor(-1.0),
                   torch.full((128,), 2.0))
    assert torch.equal(out, torch.zeros(128))


def test_status_codes_and_exceptions_match_jax():
    assert {s.name: int(s) for s in terr.Status} == {s.name: int(s) for s in jerr.Status}
    for code, exc in jerr._STATUS_TO_EXC.items():
        assert terr._STATUS_TO_EXC[code].__name__ == exc.__name__
        assert issubclass(terr._STATUS_TO_EXC[code], terr.SolverError)


@pytest.mark.parametrize("status", [s for s in terr.Status if s != terr.Status.RUNNING])
def test_solve_info_raise_if_error(status):
    """Tensor and Python-number fields behave alike, as the JAX SolveInfo."""
    for info in (
        terr.SolveInfo(7, 1e-3, int(status)),
        terr.SolveInfo(torch.tensor(7), torch.tensor(1e-3), torch.tensor(int(status))),
    ):
        assert info.converged == (status == terr.Status.CONVERGED)
        if status == terr.Status.CONVERGED:
            assert info.raise_if_error() is info
        else:
            want = jerr._STATUS_TO_EXC[int(status)].__name__
            with pytest.raises(terr.SolverError, match=status.name) as e:
                info.raise_if_error()
            assert type(e.value).__name__ == want


def test_make_info_and_zero_rhs_guard():
    info = tcommon.make_info(torch.tensor(3), torch.tensor(0.5), terr.Status.CONVERGED)
    assert (info.iterations, info.status) == (3, 0) and float(info.residual) == 0.5
    x0 = torch.ones(5)
    b = torch.zeros(5)
    x, info = tcommon.with_zero_rhs_guard(b, x0, lambda rn: pytest.fail("main ran"))
    # lax.cond traces both branches: the JAX main returns a well-formed result
    xj, infoj = jcommon.with_zero_rhs_guard(
        jnp.zeros(5), jnp.ones(5),
        lambda rn: (jnp.ones(5), jcommon.make_info(9, rn, jerr.Status.BREAKDOWN)))
    assert torch.equal(x, torch.zeros(5)) and np.array_equal(np.asarray(xj), np.zeros(5))
    assert (info.iterations, info.status) == (int(infoj.iterations), int(infoj.status))
    marker = object()
    assert tcommon.with_zero_rhs_guard(torch.ones(5), x0, lambda rn: marker) is marker


def test_check_shapes_errors():
    from sprsolve_tpu_torch.ops.operator import as_operator

    A = as_operator(np.eye(4))
    tcommon.check_shapes(A, torch.ones(4), torch.ones(4))
    with pytest.raises(terr.IncompatibleMatrixFormat, match="matrix size"):
        tcommon.check_shapes(A, torch.ones(5), torch.ones(5))
    with pytest.raises(terr.IncompatibleMatrixFormat, match="do not match"):
        tcommon.check_shapes(A, torch.ones(4), torch.ones(3))
