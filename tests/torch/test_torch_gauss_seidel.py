"""Cross tests of the port's Gauss-Seidel (the exact sweep and the
multicolor one) against the JAX package's.

The exact sweep runs on the host in the port, as a ``fori_loop`` in the JAX
package; both take x_i = (b_i − σ)/a_ii with σ summed over the slots in
order, so the reference golden (296 sweeps at eps = 0, residual exactly 0,
``tests/test_solvers.py:16,31-39``) holds in both, with equal iterates.
The multicolor sweeps agree to 1e-12 and their counts are equal: they are
the same elementwise steps on the same data."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import scipy.sparse.linalg as spla
import torch

import sprsolve_tpu as jsp
import sprsolve_tpu.errors as jerr
import sprsolve_tpu_torch as tsp
from sprsolve_tpu.solvers import redblack as jrb
from sprsolve_tpu.utils import problems as jprob
from sprsolve_tpu_torch.errors import (IncompatibleMatrixFormat, InsufficientIterNum,
                                       ZeroDiagonalElem)
from sprsolve_tpu_torch.utils import problems as tprob

torch.set_num_threads(2)


def _dirichlet(shape):
    rhs = np.zeros(shape[0] * shape[1])
    tprob.set_boundary_condition(rhs, shape, lambda r, c: float(r + c))
    return tprob.grid_laplacian_dirichlet(shape), jprob.grid_laplacian_dirichlet(shape), rhs


def test_gauss_seidel_golden_through_the_handle_and_the_function():
    A, jA, rhs = _dirichlet((10, 10))
    x, (its, res) = tsp.GaussSeidel.new(A, device="cpu").solve(rhs, max_iter=300, eps=0.0)
    assert its == 296 and res == 0.0
    assert float(torch.linalg.vector_norm(A.matvec(x) - torch.as_tensor(rhs))) == 0.0
    x2, info = tsp.gauss_seidel(A.to_ell(), torch.as_tensor(rhs), max_iter=300, eps=0.0)
    assert info.converged and info.iterations == 296 and float(info.residual) == 0.0
    assert torch.equal(x, x2)
    xj, (its_j, res_j) = jsp.GaussSeidel.new(jA).solve(rhs, max_iter=300, eps=0.0)
    assert (its_j, res_j) == (its, res)
    np.testing.assert_array_equal(x.numpy(), np.asarray(xj))


def test_gauss_seidel_zero_diagonal():
    dense = np.array([[1.0, 2.0], [3.0, 0.0]])
    with pytest.raises(ZeroDiagonalElem):
        tsp.GaussSeidel.new(tsp.csr_from_dense(dense), device="cpu").solve(
            np.ones(2), max_iter=10, eps=1e-8)
    with pytest.raises(jerr.ZeroDiagonalElem):
        jsp.GaussSeidel.new(jsp.csr_from_dense(dense)).solve(np.ones(2), max_iter=10, eps=1e-8)


def test_gauss_seidel_not_square():
    coo = tsp.COO(data=np.array([1.0]), row=np.array([0]), col=np.array([0]), shape=(2, 3))
    with pytest.raises(IncompatibleMatrixFormat):
        tsp.GaussSeidel.new(tsp.CSR.from_coo(coo), device="cpu")
    jcoo = jsp.COO(data=jnp.asarray([1.0]), row=jnp.asarray([0], dtype=jnp.int32),
                   col=jnp.asarray([0], dtype=jnp.int32), shape=(2, 3))
    with pytest.raises(jerr.IncompatibleMatrixFormat):
        jsp.GaussSeidel.new(jsp.CSR.from_coo(jcoo))


def test_gauss_seidel_max_iter_zero():
    A, _, rhs = _dirichlet((10, 10))
    with pytest.raises(InsufficientIterNum):
        tsp.GaussSeidel.new(A, device="cpu").solve(rhs, max_iter=0, eps=0.0)
    x, info = tsp.gauss_seidel(A.to_ell(), torch.as_tensor(rhs), max_iter=0, eps=0.0)
    assert info.iterations == 0 and not bool(x.any())


def test_gauss_seidel_random_diag_dominant():
    """``tests/test_random_systems.py:77``: a random diagonally dominant
    system against the direct solve (rtol 1e-9), in as many sweeps as JAX."""
    n = 60
    S = sps.random(n, n, density=0.08, random_state=5)
    S = (S + sps.diags(np.abs(S).sum(axis=1).A1 + 1.0)).tocsr()
    b = np.random.default_rng(6).standard_normal(n)
    x_direct = spla.spsolve(S.tocsc(), b)
    x, (its, _) = tsp.GaussSeidel.new(tsp.csr_from_scipy(S), device="cpu").solve(
        b, max_iter=5000, eps=1e-14)
    np.testing.assert_allclose(x.numpy(), x_direct, rtol=1e-9, atol=1e-11)
    xj, (its_j, _) = jsp.GaussSeidel.new(jsp.csr_from_scipy(S)).solve(b, max_iter=5000,
                                                                       eps=1e-14)
    assert its == its_j
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-12, atol=1e-14)


def test_entry_points_raise_without_a_device_and_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    A, _, _ = _dirichlet((4, 4))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsp.GaussSeidel.new(A)


def _coloring_fixtures():
    rng = np.random.default_rng(3)
    dense = rng.standard_normal((40, 40)) * (rng.random((40, 40)) < 0.1)
    dense += np.eye(40) * 4.0   # a nonsymmetric pattern
    return {
        "grid12": (tprob.grid_laplacian_dirichlet((12, 12)),
                   jprob.grid_laplacian_dirichlet((12, 12))),
        "poisson6": (tprob.poisson3d(6, 6, 6), jprob.poisson3d(6, 6, 6)),
        "random40": (tsp.csr_from_dense(dense), jsp.csr_from_dense(dense)),
    }


@pytest.mark.parametrize("name", ["grid12", "poisson6", "random40"])
def test_greedy_color_equals_jax(name):
    A, jA = _coloring_fixtures()[name]
    colors = tsp.greedy_color(A)
    np.testing.assert_array_equal(colors, jrb.greedy_color(jA))
    rows, cols = A.row_ids.numpy(), A.indices.numpy()
    off = rows != cols
    assert not np.any(colors[rows[off]] == colors[cols[off]])
    if name == "poisson6":
        assert colors.max() + 1 == 2


def test_colored_sweep_matches_jax():
    A, jA, b = _dirichlet((8, 8))
    C, jC = tsp.ColoredELL.from_csr(A), jrb.ColoredELL.from_csr(jA)
    assert C.starts == jC.starts
    x0 = np.random.default_rng(0).standard_normal(64)
    x = C.sweep(torch.as_tensor(b), torch.as_tensor(x0))
    xj = jC.sweep(jnp.asarray(b), jnp.asarray(x0))
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(C.matvec(x).numpy(), A.matvec(x).numpy(), rtol=1e-14)


@pytest.mark.parametrize("eps", [0.0, 1e-10])
def test_redblack_solve_matches_jax(eps):
    A, jA, b = _dirichlet((10, 10))
    x, info = tsp.gauss_seidel_redblack(tsp.ColoredELL.from_csr(A), torch.as_tensor(b),
                                        max_iter=500, eps=eps)
    xj, info_j = jsp.gauss_seidel_redblack(jrb.ColoredELL.from_csr(jA), jnp.asarray(b),
                                           max_iter=500, eps=eps)
    assert info.converged and bool(info_j.converged)
    assert info.iterations == int(info_j.iterations)
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-12, atol=1e-12)
    if eps == 0.0:
        assert float(info.residual) == 0.0
    else:
        assert float(info.residual) <= eps * np.linalg.norm(b)


def test_redblack_error_paths():
    A, _, b = _dirichlet((4, 4))
    C = tsp.ColoredELL.from_csr(A)
    x, info = tsp.gauss_seidel_redblack(C, torch.as_tensor(b), max_iter=0, eps=0.0)
    assert info.status == int(tsp.Status.INSUFFICIENT_ITER) and info.iterations == 0
    Z = tsp.csr_from_dense(np.array([[1.0, 2.0], [3.0, 0.0]]))
    _, info = tsp.gauss_seidel_redblack(tsp.ColoredELL.from_csr(Z), torch.ones(2),
                                        max_iter=10, eps=1e-8)
    assert info.status == int(tsp.Status.ZERO_DIAGONAL)


def test_multicolor_gs_precond_matches_jax():
    """MulticolorGSPrecond (two sweeps from z = 0) against JAX's, and under
    BiCGStab on the 20×20 grid, where it must cut the count at least in
    half (``tests/test_redblack.py:73-83``)."""
    A, jA, b = _dirichlet((20, 20))
    M = tsp.MulticolorGSPrecond(tsp.ColoredELL.from_csr(A), sweeps=2)
    Mj = jsp.MulticolorGSPrecond(jrb.ColoredELL.from_csr(jA), sweeps=2)
    r = np.random.default_rng(1).standard_normal(400)
    np.testing.assert_allclose(M.matvec(torch.as_tensor(r)).numpy(),
                               np.asarray(Mj.matvec(jnp.asarray(r))), rtol=1e-12, atol=1e-14)
    x, info = tsp.bicgstab(A, torch.as_tensor(b), M=M, tol=1e-14, max_iter=1500)
    _, info_0 = tsp.bicgstab(A, torch.as_tensor(b), tol=1e-14, max_iter=1500)
    assert info.converged and info.iterations < info_0.iterations // 2
    assert float(torch.linalg.vector_norm(A.matvec(x) - torch.as_tensor(b))) \
        / np.linalg.norm(b) < 1e-11
