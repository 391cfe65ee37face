"""Cross tests of the port's mixed-precision refinement against the JAX
package's (mirrors ``tests/test_refine.py``): f64 accuracy from f32 inner
solves for each real inner method, beyond the pure f32 floor, the
nonsymmetric grid with Jacobi, the zero rhs and the dtype guard, the warm
start, the complex path for each inner method (c128 accuracy from c64
solves, the real 1/|d| Jacobi under CS-MINRES), ``refine_complex``'s
plane signature, the CSR residual fallback past 64 diagonals, a host
preconditioner object, and the unknown-inner errors.

Tolerances: the outer step counts are equal (each step contracts the
error by orders of magnitude, so rounding moves no exit), x to 1e-10
against the JAX package's (both reach the f64 floor, about 1e-13 here)."""

import numpy as np
import pytest
import torch

import sprsolve_tpu as jsp
from sprsolve_tpu.utils import problems as jprob
import sprsolve_tpu_torch as tsp
from sprsolve_tpu_torch.errors import IncompatibleMatrixFormat, Status
from sprsolve_tpu_torch.interop import csr_from_reference
from sprsolve_tpu_torch.solvers.refine import refine, refine_complex

torch.set_num_threads(2)


def _spd(side=20):
    A, _ = jprob.sym_grid_laplacian((side, side))
    dense = -np.asarray(A.todense())
    return tsp.csr_from_dense(dense), jsp.csr_from_dense(dense), dense


def _port(jA):
    return csr_from_reference(jA.data, jA.indices, jA.indptr, jA.shape)


def _rel(dense, x, b):
    return np.linalg.norm(dense @ np.asarray(x) - b) / np.linalg.norm(b)


@pytest.mark.parametrize("inner", ["cg", "minres", "bicgstab", "gmres"])
def test_reaches_f64_accuracy_as_jax(inner):
    tA, jA, dense = _spd()
    b = np.random.default_rng(0).standard_normal(400)
    x, info = tsp.refine_solve(tA, b, inner=inner, tol=1e-13, inner_tol=1e-6, device="cpu")
    xj, ij = jsp.refine_solve(jA, b, inner=inner, tol=1e-13, inner_tol=1e-6)
    info.raise_if_error()
    assert x.dtype == torch.float64 and _rel(dense, x.numpy(), b) < 1e-12
    assert 1 < info.iterations <= 6 and info.iterations == int(ij.iterations)
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=0, atol=1e-10)


def test_beats_pure_f32_accuracy():
    tA, _, dense = _spd(16)
    b = np.random.default_rng(1).standard_normal(256)
    A32 = tsp.csr_from_dense(dense.astype(np.float32))
    x32, _ = tsp.cg(A32.to_dia(), torch.as_tensor(b, dtype=torch.float32), tol=1e-14,
                    max_iter=5000)
    rel32 = _rel(dense, x32.numpy().astype(np.float64), b)
    x, info = tsp.refine_solve(tA, b, inner="cg", tol=1e-13, device="cpu")
    info.raise_if_error()
    assert _rel(dense, x.numpy(), b) < rel32 * 1e-3


def test_nonsymmetric_bicgstab_inner_with_jacobi():
    jA = jprob.grid_laplacian_dirichlet((16, 16))
    tA = _port(jA)
    b = np.zeros(256)
    jprob.set_boundary_condition(b, (16, 16), lambda r, c: float(r + c))
    x, info = tsp.refine_solve(tA, b, inner="bicgstab", tol=1e-13, M="jacobi", device="cpu")
    xj, ij = jsp.refine_solve(jA, b, inner="bicgstab", tol=1e-13, M="jacobi")
    info.raise_if_error()
    assert _rel(np.asarray(jA.todense()), x.numpy(), b) < 1e-12
    assert info.iterations == int(ij.iterations)
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=0, atol=1e-10)


def test_zero_rhs_and_dtype_guards():
    tA, _, _ = _spd(8)
    x, info = tsp.refine_solve(tA, np.zeros(64), tol=1e-13, device="cpu")
    assert info.iterations == 0 and info.status == Status.CONVERGED and not bool(x.any())
    with pytest.raises(IncompatibleMatrixFormat):
        refine(tA.to_dia(), tA.to_dia(), torch.zeros(64, dtype=torch.float32), tol=1e-12)
    with pytest.raises(IncompatibleMatrixFormat):
        refine_complex(tA.to_dia(), tA.to_dia(), torch.zeros(64, dtype=torch.float32),
                       torch.zeros(64, dtype=torch.float32), tol=1e-12)
    with pytest.raises(IncompatibleMatrixFormat):
        tsp.refine_solve(tA.to_dia(), np.ones(64), tol=1e-12, device="cpu")


def test_warm_start():
    tA, jA, _ = _spd(12)
    b = np.random.default_rng(2).standard_normal(144)
    x1, _ = tsp.refine_solve(tA, b, inner="cg", tol=1e-13, device="cpu")
    _, info2 = tsp.refine_solve(tA, b, inner="cg", tol=1e-13, x0=x1, device="cpu")
    _, ij2 = jsp.refine_solve(jA, b, inner="cg", tol=1e-13, x0=np.asarray(x1.numpy()))
    assert info2.iterations <= 1 and info2.iterations == int(ij2.iterations)


@pytest.mark.parametrize("inner,M", [("cs_minres", None), ("cs_minres", "jacobi"),
                                     ("cocg", "jacobi"), ("bicgstab", "jacobi")])
def test_complex_refinement_as_jax(inner, M):
    jA, rhs, _ = jprob.complex_symmetric_grid_with_diag((10, 10))
    tA = _port(jA)
    kw = dict(inner=inner, M=M, tol=1e-12, inner_tol=1e-5, inner_max_iter=800)
    x, info = tsp.refine_solve(tA, rhs, device="cpu", **kw)
    xj, ij = jsp.refine_solve(jA, rhs, **kw)
    info.raise_if_error()
    assert x.dtype == torch.complex128
    dense = np.asarray(jA.todense())
    assert np.abs(x.numpy() - np.linalg.solve(dense, rhs)).max() < 1e-10
    assert info.iterations == int(ij.iterations)
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=0, atol=1e-10)


def test_complex_hermitian_bicgstab_inner():
    jA, rhs, _ = jprob.hermitian_grid_with_diag((8, 8))
    x, info = tsp.refine_solve(_port(jA), rhs, inner="bicgstab", tol=1e-12, M="jacobi",
                               inner_max_iter=800, device="cpu")
    info.raise_if_error()
    assert _rel(np.asarray(jA.todense()), x.numpy(), rhs) < 1e-11


def test_refine_complex_keeps_the_plane_signature():
    """refine_complex takes and returns f64 planes; the inner operator is
    the c64 ComplexPaddedDIA (K5-K7's plain versions here)."""
    jA, rhs, _ = jprob.complex_symmetric_grid_with_diag((8, 8))
    tA = _port(jA)
    data = tA.data.numpy()
    A64 = tsp.CSR.from_arrays(data, tA.indices, tA.indptr, tA.shape).to_dia()
    A32 = tsp.optimize(tsp.CSR.from_arrays(data.astype(np.complex64), tA.indices, tA.indptr,
                                           tA.shape), device="cpu")
    assert isinstance(A32, tsp.ComplexPaddedDIA)
    xr, xi, info = refine_complex(A64, A32, torch.as_tensor(rhs.real), torch.as_tensor(rhs.imag),
                                  tol=1e-12, M=tsp.real_abs_jacobi(A32))
    info.raise_if_error()
    assert xr.dtype == xi.dtype == torch.float64
    want = np.linalg.solve(np.asarray(jA.todense()), rhs)
    assert np.abs((xr.numpy() + 1j * xi.numpy()) - want).max() < 1e-10
    x, info2 = tsp.refine_solve(tA, rhs, inner="cs_minres", M="jacobi", tol=1e-12, device="cpu")
    assert info2.iterations == info.iterations
    np.testing.assert_allclose(x.numpy(), xr.numpy() + 1j * xi.numpy(), rtol=0, atol=1e-13)


def _unstructured(n, seed):
    rng = np.random.default_rng(seed)
    dense = rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.05)
    return (dense + dense.T) / 2 + np.eye(n) * 10


def test_unstructured_matrix_falls_back_to_csr_residuals():
    """Past 64 diagonals the f64 residual runs on the CSR, and refinement
    still reaches f64 accuracy in the JAX package's outer count."""
    from sprsolve_tpu_torch.solvers.refine import _residual_operator

    dense = _unstructured(300, 9)
    tA, jA = tsp.csr_from_dense(dense), jsp.csr_from_dense(dense)
    assert isinstance(_residual_operator(tA, tA.data.numpy(), np.float64, "cpu"), tsp.CSR)
    b = np.random.default_rng(9).standard_normal(300)
    x, info = tsp.refine_solve(tA, b, inner="cg", tol=1e-12, device="cpu")
    _, ij = jsp.refine_solve(jA, b, inner="cg", tol=1e-12)
    info.raise_if_error()
    assert _rel(dense, x.numpy(), b) < 1e-12
    assert info.iterations == int(ij.iterations)


def test_host_preconditioner_object():
    """A plain object with ``matvec`` serves as M, in the inner operator's
    layout: here optimize() reorders the random matrix, so the Jacobi is
    built on the permuted diagonal."""
    dense = _unstructured(144, 10)
    tA = tsp.csr_from_dense(dense)

    class MyJacobi:
        def __init__(self, d):
            self.dinv = 1.0 / d

        def matvec(self, x):
            return x * self.dinv

    b = np.random.default_rng(11).standard_normal(144)
    op = tsp.optimize(tsp.CSR.from_arrays(tA.data.numpy().astype(np.float32), tA.indices,
                                          tA.indptr, tA.shape), device="cpu")
    d = torch.as_tensor(np.diag(dense).astype(np.float32))
    M = MyJacobi(op.pad_vec(d) if hasattr(op, "pad_vec") else d)
    x, info = tsp.refine_solve(tA, b, inner="cg", M=M, tol=1e-12, device="cpu")
    info.raise_if_error()
    assert _rel(dense, x.numpy(), b) < 1e-11


@pytest.mark.parametrize("complex_", [False, True])
def test_unknown_inner_raises(complex_):
    tA, _, _ = _spd(8)
    if complex_:
        tA = tsp.CSR.from_arrays(tA.data.numpy().astype(np.complex128), tA.indices, tA.indptr,
                                 tA.shape)
    with pytest.raises(IncompatibleMatrixFormat, match="inner solver"):
        tsp.refine_solve(tA, np.ones(64), inner="lsqr", tol=1e-10, device="cpu")
    with pytest.raises(IncompatibleMatrixFormat, match="jacobi"):
        tsp.refine_solve(tA, np.ones(64), M="ilu0", tol=1e-10, device="cpu")
