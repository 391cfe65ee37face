"""Cross tests of the port's BiCGStab(ℓ) against the JAX package's.

Both solve the same systems from the same NumPy data: the f64 PaddedDIA of
the nonsymmetric 8³ convection-diffusion operator (K2's plain version
here, the Pallas kernel in interpret mode on the JAX side), and the
reference's 20×20 Dirichlet grid on the CSR path for the exits of
``tests/test_bicgstabl.py:231-260``.

Cycle counts stay in step on these fixtures (6 and 8 cycles at ℓ = 2, 3
and 4 at ℓ = 4, at tol 1e-8 and 1e-12, with and without Jacobi; measured
on this suite's CPU run), so the tests assert equal counts.  Solutions
agree to rtol 1e-10 in norm: the two take the same steps, and the
operator's condition number is a few tens."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

import sprsolve_tpu as jsp
import sprsolve_tpu.ops.pallas_spmv as jps
import sprsolve_tpu_torch as tsp
from sprsolve_tpu.utils import problems as jprob
from sprsolve_tpu_torch.errors import InsufficientIterNum, Status
from sprsolve_tpu_torch.interop import padded_dia_from_reference, vec_from_reference
from sprsolve_tpu_torch.utils import problems as tprob

torch.set_num_threads(2)


def _dirichlet(shape=(20, 20)):
    b = np.zeros(shape[0] * shape[1])
    tprob.set_boundary_condition(b, shape, lambda r, c: float(r + c))
    return tprob.grid_laplacian_dirichlet(shape), jprob.grid_laplacian_dirichlet(shape), b


@pytest.mark.parametrize("tol", [1e-8, 1e-12])
@pytest.mark.parametrize("jacobi", [False, True])
@pytest.mark.parametrize("l", [2, 4])
def test_padded_f64_convection_diffusion_matches_jax(l, jacobi, tol):
    jC = jprob.convection_diffusion3d(8, 8, 8, dtype=np.float64)
    tC = tprob.convection_diffusion3d(8, 8, 8, dtype=np.float64)
    pj = jps.PaddedDIA.from_dia(jC.to_dia(), lanes=128, block_rows=8)
    pt = padded_dia_from_reference(np.asarray(pj.bands3), pj.offsets, pj.n, pj.hr,
                                   pj.shape, pj.vdtype)
    b = np.random.default_rng(2).standard_normal(512)
    Mj = pj.jacobi_precond() if jacobi else None
    Mt = pt.jacobi_precond() if jacobi else None
    xj, ij = jsp.bicgstabl(pj, pj.pad_vec(jnp.asarray(b)), M=Mj, l=l, tol=tol,
                           max_iter=200)
    xt, it = tsp.bicgstabl(pt, pt.pad_vec(torch.from_numpy(b)), M=Mt, l=l, tol=tol,
                           max_iter=200)
    assert it.status == Status.CONVERGED == int(ij.status)
    assert it.iterations == int(ij.iterations)
    assert float(it.residual) <= tol
    assert not bool(xt[: pt.h].any()) and not bool(xt[pt.h + pt.n:].any())
    x = pt.unpad_vec(xt)
    r = tC.matvec(x).numpy() - b
    assert np.linalg.norm(r) / np.linalg.norm(b) < 10 * tol
    xr = vec_from_reference(xj, pj.n, pj.hr)
    assert float(torch.linalg.norm(x - xr) / torch.linalg.norm(xr)) < 1e-10


def test_insufficient_iterations_status_matches_jax():
    tA, jA, b = _dirichlet()
    x, info = tsp.bicgstabl(tA, torch.from_numpy(b), tol=1e-13, max_iter=2)
    xj, info_j = jsp.bicgstabl(jA, jnp.asarray(b), tol=1e-13, max_iter=2)
    assert info.status == Status.INSUFFICIENT_ITER == int(info_j.status)
    assert info.iterations == 2 == int(info_j.iterations)
    assert bool(torch.isfinite(x).all()) and float(info.residual) > 1e-13
    assert float(info.residual) == pytest.approx(float(info_j.residual), rel=1e-8)
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-8, atol=1e-10)
    _, info2 = tsp.solve(tA, b, method="bicgstabl", tol=1e-13, max_iter=2)
    with pytest.raises(InsufficientIterNum):
        info2.raise_if_error()


def test_warm_start_zero_rhs_and_trace_match_jax():
    tA, jA, b = _dirichlet()
    dense = sps.csr_matrix((tA.data.numpy(), tA.indices.numpy(), tA.indptr.numpy()),
                           shape=tA.shape).toarray()
    x_exact = torch.from_numpy(np.linalg.solve(dense, b))
    x, info = tsp.bicgstabl(tA, torch.from_numpy(b), x_exact, tol=1e-8, max_iter=100)
    assert info.converged and info.iterations == 0 and torch.equal(x, x_exact)
    xz, iz = tsp.bicgstabl(tA, torch.zeros(400, dtype=torch.float64), tol=1e-10,
                           max_iter=5)
    assert iz.converged and not bool(xz.any())
    x, info, hist = tsp.bicgstabl(tA, torch.from_numpy(b), tol=1e-10, max_iter=200,
                                  record_residuals=True)
    _, info_j, hist_j = jsp.bicgstabl(jA, jnp.asarray(b), tol=1e-10, max_iter=200,
                                      record_residuals=True)
    info.raise_if_error()
    h, it = hist.numpy(), info.iterations
    assert h.shape == (201,) and it == int(info_j.iterations)
    assert np.isclose(h[0], 1.0, rtol=1e-6)
    assert np.isfinite(h[: it + 1]).all() and np.isnan(h[it + 1:]).all()
    assert h[it] <= 1e-10   # the converged entry is recorded
    np.testing.assert_allclose(h, np.asarray(hist_j), rtol=1e-6)


def test_l_must_be_a_positive_int():
    tA, _, b = _dirichlet((4, 4))
    with pytest.raises(ValueError, match="l >= 1"):
        tsp.bicgstabl(tA, torch.from_numpy(b), l=0, tol=1e-8, max_iter=10)
