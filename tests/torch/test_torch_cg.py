"""Cross tests of the port's CG against the JAX package's.

Both solve the same systems from the same NumPy data: the f64 PaddedDIA
path (K3's plain version here, the Pallas kernel in interpret mode on the
JAX side), and the negative-definite folded grid Laplacian on the CSR
path, where pᴴAp ≤ 0 ends the solve in BREAKDOWN.

Iteration counts stay in step on these fixtures (32 at tol 1e-8 and 43 at
1e-12 on the 8³ Poisson, with and without Jacobi; measured on this suite's
CPU run), so the tests assert equal counts.  Solutions agree to rtol 1e-10
in norm: both stop at tol 1e-8 or below on a grid whose condition number is
about 30, and take the same steps."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sprsolve_tpu as jsp
import sprsolve_tpu.ops.pallas_spmv as jps
import sprsolve_tpu_torch as tsp
from sprsolve_tpu.utils import problems as jprob
from sprsolve_tpu_torch.errors import BreakDown, Status
from sprsolve_tpu_torch.interop import padded_dia_from_reference, vec_from_reference
from sprsolve_tpu_torch.utils import problems as tprob

torch.set_num_threads(2)


def _padded_pair(jA):
    pj = jps.PaddedDIA.from_dia(jA.to_dia(), lanes=128, block_rows=8)
    pt = padded_dia_from_reference(np.asarray(pj.bands3), pj.offsets, pj.n, pj.hr,
                                   pj.shape, pj.vdtype)
    return pj, pt


@pytest.mark.parametrize("tol", [1e-8, 1e-12])
@pytest.mark.parametrize("jacobi", [False, True])
def test_padded_f64_poisson_matches_jax(jacobi, tol):
    pj, pt = _padded_pair(jprob.poisson3d(8, 8, 8, dtype=np.float64))
    tA = tprob.poisson3d(8, 8, 8, dtype=np.float64)
    b = np.random.default_rng(0).standard_normal(512)
    Mj = pj.jacobi_precond() if jacobi else None
    Mt = pt.jacobi_precond() if jacobi else None
    xj, ij = jsp.cg(pj, pj.pad_vec(jnp.asarray(b)), M=Mj, tol=tol, max_iter=500)
    xt, it = tsp.cg(pt, pt.pad_vec(torch.from_numpy(b)), M=Mt, tol=tol, max_iter=500)
    assert it.converged and bool(ij.converged)
    assert it.iterations == int(ij.iterations)
    assert float(it.residual) <= tol
    assert abs(float(it.residual) - float(ij.residual)) <= 1e-6 * float(ij.residual)
    assert not bool(xt[: pt.h].any()) and not bool(xt[pt.h + pt.n:].any())
    x = pt.unpad_vec(xt)
    r = tA.matvec(x).numpy() - b
    assert np.linalg.norm(r) / np.linalg.norm(b) < 10 * tol
    xr = vec_from_reference(xj, pj.n, pj.hr)
    assert float(torch.linalg.norm(x - xr) / torch.linalg.norm(xr)) < 1e-10


def test_negative_definite_breaks_down_like_jax():
    """The folded grid Laplacian is negative definite: pᴴAp < 0 on the first
    step, so CG ends in BREAKDOWN with x0 and count 0 (cg.py:118-133)."""
    tA, rhs = tprob.sym_grid_laplacian((8, 8))
    jA, _ = jprob.sym_grid_laplacian((8, 8))
    x, info = tsp.cg(tA, torch.from_numpy(rhs), tol=1e-10, max_iter=100)
    xj, info_j = jsp.cg(jA, jnp.asarray(rhs), tol=1e-10, max_iter=100)
    assert info.status == Status.BREAKDOWN == int(info_j.status)
    assert info.iterations == int(info_j.iterations) == 0
    assert float(info.residual) == pytest.approx(float(info_j.residual), rel=1e-12)
    assert not bool(x.any()) and not np.asarray(xj).any()
    with pytest.raises(BreakDown):
        tsp.CG.new(tA, 64, device="cpu").solve(rhs, tol=1e-10)
    # on the negated (SPD) matrix the handle converges
    neg = tsp.csr_from_scipy(-_scipy(tA))
    xn, (its, res) = tsp.CG.new(neg, 64, device="cpu").solve(-rhs, tol=1e-10)
    assert res <= 1e-10
    np.testing.assert_allclose(tA.matvec(xn).numpy(), rhs, rtol=1e-8, atol=1e-8)


def _scipy(A):
    import scipy.sparse as sps

    return sps.csr_matrix((A.data.numpy(), A.indices.numpy(), A.indptr.numpy()),
                          shape=A.shape)


def test_record_residuals_matches_jax():
    tA = tprob.poisson3d(8, 8, 8, dtype=np.float64)
    jA = jprob.poisson3d(8, 8, 8, dtype=np.float64)
    b = np.random.default_rng(1).standard_normal(512)
    x, info, hist = tsp.cg(tA, torch.from_numpy(b), tol=1e-10, max_iter=200,
                           record_residuals=True)
    _, info_j, hist_j = jsp.cg(jA, jnp.asarray(b), tol=1e-10, max_iter=200,
                               record_residuals=True)
    info.raise_if_error()
    k = info.iterations
    assert k == int(info_j.iterations)
    h = hist.numpy()
    assert h.shape == (201,)
    assert h[0] == 1.0 and h[k] == float(info.residual) <= 1e-10
    assert np.all(np.isfinite(h[: k + 1])) and np.all(np.isnan(h[k + 1:]))
    np.testing.assert_allclose(h, np.asarray(hist_j), rtol=1e-6)
    # the budget runs out: INSUFFICIENT_ITER, no converged entry
    _, info2, hist2 = tsp.cg(tA, torch.from_numpy(b), tol=1e-10, max_iter=5,
                             record_residuals=True)
    assert info2.status == Status.INSUFFICIENT_ITER and info2.iterations == 5
    assert bool(hist2[:5].isfinite().all()) and bool(hist2[5].isnan())


def test_cg_single_sync_names_its_roadmap_item():
    """Item 10 is ported: ``method="cg_single_sync"`` solves, in as many
    iterations as the JAX package's within the band, and prepare() runs
    the same solve."""
    tA, jA = tprob.poisson3d(4, 4, 4), jprob.poisson3d(4, 4, 4)
    b = np.ones(64, np.float32)
    kw = dict(method="cg_single_sync", M="jacobi", tol=1e-5, max_iter=200)
    x, info = tsp.solve(tA, b, device="cpu", **kw)
    xj, info_j = jsp.solve(jA, b, **kw)
    assert info.converged and bool(info_j.converged)
    its_j = int(info_j.iterations)
    assert abs(info.iterations - its_j) <= max(3, -(-its_j // 4))
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-3, atol=1e-4)
    x2, info2 = tsp.prepare(tA, device="cpu", **kw)(b)
    assert torch.equal(x, x2) and info2.iterations == info.iterations
