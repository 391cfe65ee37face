"""Cross tests of the port's LSQR and adjoint surface against the JAX
package's: the cases of ``tests/test_lsqr.py`` (all but the scipy-compat
wrapper, held in ``test_torch_scipy_compat.py``), each run through both.

Ground truth is NumPy dense linear algebra, to the tolerances of the JAX
test (atol 1e-8 for consistent systems, 1e-7 for least squares); the two
packages take the same Golub-Kahan steps, so their counts agree within
the band of ``tests/test_serial_parity.py:183`` and their solutions to
atol 1e-8. The JAX test's "under jit" case becomes the explicit-``AH``
case: the port has no jit."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

import sprsolve_tpu as jsp
import sprsolve_tpu_torch as tsp
from sprsolve_tpu.utils import problems as jprob
from sprsolve_tpu_torch.errors import InvalidPreconditioner

torch.set_num_threads(2)


def _band(its):
    return max(3, -(-its // 4))


def _random_sparse(m, n, density=0.15, seed=0, complex_=False):
    rng = np.random.default_rng(seed)
    dense = rng.standard_normal((m, n)) * (rng.random((m, n)) < density)
    if complex_:
        dense = dense + 1j * rng.standard_normal((m, n)) * (rng.random((m, n)) < density)
    k = min(m, n)
    dense[np.arange(k), np.arange(k)] += 3.0
    return tsp.csr_from_dense(dense), jsp.csr_from_dense(dense), dense


def _dense(A) -> np.ndarray:
    """A port CSR or CSC as a dense array (scipy, the oracle's side)."""
    if isinstance(A, tsp.CSC):
        return sps.csc_matrix((A.data.numpy(), A.indices.numpy(), A.indptr.numpy()),
                              shape=A.shape).toarray()
    return sps.csr_matrix((A.data.numpy(), A.indices.numpy(), A.indptr.numpy()),
                          shape=A.shape).toarray()


def _both(A, jA, b, **kw):
    """The same lsqr call in both packages; both must converge, with counts
    within the band and solutions within atol 1e-8."""
    x, info = tsp.lsqr(A, torch.as_tensor(b), **kw)
    xj, info_j = jsp.lsqr(jA, jnp.asarray(b), **kw)
    info.raise_if_error()
    info_j.raise_if_error()
    assert abs(info.iterations - int(info_j.iterations)) <= _band(int(info_j.iterations))
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), atol=1e-8)
    return x.numpy(), info


@pytest.mark.parametrize("fmt", ["csr", "csc"])
def test_transpose_and_adjoint_dense_oracle(fmt):
    A, jA, dense = _random_sparse(13, 7, seed=1, complex_=True)
    if fmt == "csc":
        S = sps.csc_matrix(dense)
        C = tsp.CSC.from_arrays(S.data, S.indices, S.indptr, S.shape)
        np.testing.assert_allclose(_dense(C), dense, atol=0)
        A = C.to_csr()
        y = np.random.default_rng(3).standard_normal(7)
        np.testing.assert_allclose(C.matvec(torch.as_tensor(y, dtype=torch.complex128)).numpy(),
                                   dense @ y, atol=1e-12)
    np.testing.assert_allclose(_dense(A.transpose()), dense.T, atol=1e-14)
    np.testing.assert_allclose(_dense(A.adjoint()), dense.conj().T, atol=1e-14)
    assert A.adjoint().shape == (7, 13)
    y = np.random.default_rng(2).standard_normal(13)
    got = A.adjoint().matvec(torch.as_tensor(y, dtype=torch.complex128)).numpy()
    np.testing.assert_allclose(got, dense.conj().T @ y, atol=1e-12)
    np.testing.assert_allclose(got, np.asarray(jA.adjoint().matvec(jnp.asarray(y))),
                               atol=1e-14)


def test_consistent_square_system():
    A, jA, dense = _random_sparse(40, 40, seed=3)
    x_true = np.random.default_rng(4).standard_normal(40)
    x, info = _both(A, jA, dense @ x_true, tol=1e-12, max_iter=400)
    np.testing.assert_allclose(x, x_true, atol=1e-8)
    assert float(info.residual) < 1e-10


def test_overdetermined_matches_lstsq():
    A, jA, dense = _random_sparse(60, 20, seed=5)
    b = np.random.default_rng(6).standard_normal(60)
    x, _ = _both(A, jA, b, tol=1e-12, max_iter=400)
    np.testing.assert_allclose(x, np.linalg.lstsq(dense, b, rcond=None)[0], atol=1e-7)
    r = b - dense @ x
    assert np.linalg.norm(dense.T @ r) < 1e-7 * np.linalg.norm(dense.T @ b)


def test_underdetermined_min_norm():
    A, jA, dense = _random_sparse(15, 40, seed=7)
    b = dense @ np.random.default_rng(8).standard_normal(40)
    x, _ = _both(A, jA, b, tol=1e-12, max_iter=600)
    np.testing.assert_allclose(x, np.linalg.pinv(dense) @ b, atol=1e-7)


def test_damped_matches_normal_equations():
    A, jA, dense = _random_sparse(50, 20, seed=9)
    b = np.random.default_rng(10).standard_normal(50)
    x, _ = _both(A, jA, b, damp=0.7, tol=1e-13, max_iter=600)
    want = np.linalg.solve(dense.T @ dense + 0.49 * np.eye(20), dense.T @ b)
    np.testing.assert_allclose(x, want, atol=1e-8)


def test_complex_overdetermined():
    A, jA, dense = _random_sparse(30, 12, seed=11, complex_=True)
    rng = np.random.default_rng(12)
    b = rng.standard_normal(30) + 1j * rng.standard_normal(30)
    x, _ = _both(A, jA, b, tol=1e-12, max_iter=400)
    np.testing.assert_allclose(x, np.linalg.lstsq(dense, b, rcond=None)[0], atol=1e-7)


def test_explicit_adjoint():
    A, jA, dense = _random_sparse(25, 25, seed=13)
    b = np.random.default_rng(14).standard_normal(25)
    x, _ = _both(A, jA, b, tol=1e-12, max_iter=400)
    x2, info = tsp.lsqr(A, torch.as_tensor(b), AH=A.adjoint(), tol=1e-12, max_iter=400)
    info.raise_if_error()
    assert torch.equal(torch.as_tensor(x), x2)
    np.testing.assert_allclose(x, np.linalg.solve(dense, b), atol=1e-8)


def test_warm_start_and_zero_rhs():
    A, jA, dense = _random_sparse(30, 30, seed=15)
    x_true = np.random.default_rng(16).standard_normal(30)
    b = torch.as_tensor(dense @ x_true)
    _, info = tsp.lsqr(A, b, torch.as_tensor(x_true + 1e-10), tol=1e-8, max_iter=200)
    info.raise_if_error()
    assert info.iterations <= 2
    x_z, info_z = tsp.lsqr(A, torch.zeros(30, dtype=torch.float64), tol=1e-8, max_iter=200)
    assert info_z.iterations == 0 and not bool(x_z.any())
    _, info_j = jsp.lsqr(jA, jnp.asarray(b.numpy()), jnp.asarray(x_true + 1e-10), tol=1e-8,
                         max_iter=200)
    assert int(info_j.iterations) == info.iterations
    x_r, info_r, hist = tsp.lsqr(A, b, tol=1e-12, max_iter=200, record_residuals=True)
    _, info_jr, hist_j = jsp.lsqr(jA, jnp.asarray(b.numpy()), tol=1e-12, max_iter=200,
                                  record_residuals=True)
    # the two histories agree to 1e-8 while the residual is above 1e-4; below
    # it the rounding of the two summation orders, grown by the condition
    # number over the residual, reaches the digits compared
    k = min(info_r.iterations, int(info_jr.iterations))
    hj = np.asarray(hist_j)[:k]
    top = hj >= 1e-4
    assert top.sum() >= k // 2
    np.testing.assert_allclose(hist.numpy()[:k][top], hj[top], rtol=1e-8)
    assert float(hist[info_r.iterations]) == float(info_r.residual)
    assert bool(torch.isnan(hist[info_r.iterations + 1:]).all())


def test_solve_api_and_prepare():
    A, jA, dense = _random_sparse(40, 16, seed=17)
    b = np.random.default_rng(18).standard_normal(40)
    want = np.linalg.lstsq(dense, b, rcond=None)[0]
    x, info = tsp.solve(A, b, method="lsqr", tol=1e-12, max_iter=400, device="cpu")
    info.raise_if_error()
    assert x.shape == (16,)
    np.testing.assert_allclose(x.numpy(), want, atol=1e-7)
    xj, _ = jsp.solve(jA, b, method="lsqr", tol=1e-12, max_iter=400)
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), atol=1e-8)
    with pytest.raises(InvalidPreconditioner):
        tsp.solve(A, b, method="lsqr", M="jacobi", tol=1e-8, max_iter=10, device="cpu")
    x2, info2 = tsp.prepare(A, method="lsqr", tol=1e-12, max_iter=400, device="cpu")(b)
    info2.raise_if_error()
    assert torch.equal(x, x2)
    S = sps.csc_matrix(dense)
    C = tsp.CSC.from_arrays(S.data, S.indices, S.indptr, S.shape)
    x3, _ = tsp.solve(C, b, method="auto", tol=1e-12, max_iter=400, device="cpu")
    np.testing.assert_allclose(x3.numpy(), want, atol=1e-7)


def test_square_banded_poisson_consistency():
    dense = -np.asarray(jprob.sym_grid_laplacian((12, 12))[0].todense())
    A, jA = tsp.csr_from_dense(dense), jsp.csr_from_dense(dense)
    b = np.random.default_rng(21).standard_normal(144)
    x_l, _ = _both(A, jA, b, tol=1e-12, max_iter=2000)
    x_c, info_c = tsp.cg(A.to_dia(), torch.as_tensor(b), tol=1e-12, max_iter=2000)
    info_c.raise_if_error()
    np.testing.assert_allclose(x_l, x_c.numpy(), atol=1e-6)
