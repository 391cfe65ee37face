"""Cross tests of the port's BSR and ComplexBSR against the JAX package's
(cases of ``tests/test_bsr.py`` and ``tests/test_complex_bsr.py``), and of
``reorder_rcm``.

The blocks are built by the same NumPy steps and compared exactly. The
applies take the same products in another order (a batched matmul and an
``index_add_`` against an einsum and a ``segment_sum``): f64/c128 agree to
1e-12, f32/c64 with scipy's f64 product to 1e-5, with TF32 allowed
globally (the apply turns it off per call). Krylov counts lie within the
band of ``tests/test_serial_parity.py:183``, max(3, ⌈its/4⌉)."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

import sprsolve_tpu as jsp
import sprsolve_tpu_torch as tsp
from sprsolve_tpu.ops.reordered import Reordered as JReordered
from sprsolve_tpu.sparse.bsr import ComplexBSR as JComplexBSR
from sprsolve_tpu.utils import problems as jprob
from sprsolve_tpu_torch.interop import (bsr_from_reference, complex_bsr_from_reference,
                                        reordered_from_reference)
from sprsolve_tpu_torch.ops.reordered import Reordered
from sprsolve_tpu_torch.utils import problems as tprob

torch.set_num_threads(2)


def _band(its):
    return max(3, -(-its // 4))


def _random(n=300, density=0.03, seed=0, diag=6.0):
    S = sps.random(n, n, density=density, random_state=seed, format="csr")
    return (S + sps.eye(n) * diag).tocsr()


def _random_complex(n=300, density=0.03, seed=0, diag=6.0):
    rng = np.random.default_rng(seed)
    S = _random(n, density, seed, diag)
    data = S.data.astype(np.complex128) * (1.0 + 1j * rng.standard_normal(S.nnz))
    return sps.csr_matrix((data, S.indices, S.indptr), shape=S.shape)


def _assert_same_blocks(b, jb, planes):
    for got, want in planes:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(b.blk_row.numpy(), np.asarray(jb.blk_row))
    np.testing.assert_array_equal(b.blk_col.numpy(), np.asarray(jb.blk_col))
    assert (b.padded_dim, b.n) == (jb.padded_dim, jb.n)


def test_bsr_matches_csr_oracle_and_jax():
    S = _random()
    A, jA = tsp.csr_from_scipy(S), jsp.csr_from_scipy(S)
    b, jb = tsp.BSR.from_csr(A, bs=32), jsp.BSR.from_csr(jA, bs=32)
    _assert_same_blocks(b, jb, [(b.blocks, jb.blocks)])
    assert b.fill_ratio == pytest.approx(jb.fill_ratio, rel=1e-15) and 0 < b.fill_ratio <= 1
    assert tsp.BSR.estimate_blocks(A, 32) == jsp.BSR.estimate_blocks(jA, 32) == b.nblk
    x = np.random.default_rng(0).standard_normal(300)
    y = b.matvec(torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), S @ x, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(y.numpy(), np.asarray(jb.matvec(jnp.asarray(x))), rtol=1e-12,
                               atol=1e-12)
    X = np.random.default_rng(1).standard_normal((300, 3))
    np.testing.assert_allclose(b.matmat(torch.from_numpy(X)).numpy(), S @ X, rtol=1e-12,
                               atol=1e-12)
    yd, dot = b.matvec_dot(torch.from_numpy(x))
    assert float(dot) == pytest.approx(float(x @ (S @ x)), rel=1e-12)
    # the reference's arrays carried across give the same operator
    r = bsr_from_reference(jb.blocks, jb.blk_row, jb.blk_col, jb.padded_dim, jb.n)
    assert torch.equal(r.matvec(torch.from_numpy(x)), y)


def test_bsr_diagonal_and_padding():
    A = tprob.grid_laplacian_dirichlet((13, 13))   # n = 169, not a multiple of bs
    b = tsp.BSR.from_csr(A, bs=32)
    jb = jsp.BSR.from_csr(jprob.grid_laplacian_dirichlet((13, 13)), bs=32)
    assert b.padded_dim % 32 == 0 and b.shape == (169, 169) and b.padded_dim == jb.padded_dim
    np.testing.assert_array_equal(b.diagonal().numpy(), np.asarray(jb.diagonal()))
    np.testing.assert_array_equal(b.diagonal().numpy(), A.diagonal().numpy())
    M = b.jacobi_precond()
    assert isinstance(M, tsp.DiagPrecond)
    np.testing.assert_array_equal(M.diag_inv.numpy(), 1.0 / A.diagonal().numpy())


@pytest.mark.parametrize("bs", [8, 32])
def test_bsr_f32_matches_scipy_with_tf32_allowed(bs):
    S = _random(n=257, seed=3).astype(np.float32)
    b = tsp.BSR.from_csr(tsp.csr_from_scipy(S), bs=bs)
    x = np.random.default_rng(4).standard_normal(257).astype(np.float32)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        y = b.matvec(torch.from_numpy(x))
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert y.dtype == torch.float32
    want = S.astype(np.float64) @ x.astype(np.float64)
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_bicgstab_on_bsr_matches_jax():
    rhs = np.zeros(400)
    tprob.set_boundary_condition(rhs, (20, 20), lambda r, c: float(r + c))
    A = tprob.grid_laplacian_dirichlet((20, 20))
    b = tsp.BSR.from_csr(A, bs=64)
    jb = jsp.BSR.from_csr(jprob.grid_laplacian_dirichlet((20, 20)), bs=64)
    x, info = tsp.bicgstab(b, torch.from_numpy(rhs), tol=1e-14, max_iter=1500)
    xj, info_j = jsp.bicgstab(jb, jnp.asarray(rhs), tol=1e-14, max_iter=1500)
    assert info.converged and bool(info_j.converged)
    assert abs(info.iterations - int(info_j.iterations)) <= _band(int(info_j.iterations))
    r = A.matvec(x).numpy() - rhs
    assert np.linalg.norm(r) / np.linalg.norm(rhs) < 1e-11
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-9, atol=1e-9)


def test_reorder_rcm_matches_jax_and_preserves_solve():
    S = sps.random(200, 200, density=0.03, random_state=3, format="csr")
    S = (S + S.T + sps.eye(200) * 10).tocsr()
    A, jA = tsp.csr_from_scipy(S), jsp.csr_from_scipy(S)
    Ap, perm = tsp.reorder_rcm(A)
    jAp, jperm = jsp.reorder_rcm(jA)
    np.testing.assert_array_equal(perm, np.asarray(jperm))
    np.testing.assert_array_equal(Ap.indptr.numpy(), np.asarray(jAp.indptr))
    np.testing.assert_array_equal(Ap.indices.numpy(), np.asarray(jAp.indices))
    np.testing.assert_array_equal(Ap.data.numpy(), np.asarray(jAp.data))
    from sprsolve_tpu_torch import native

    assert native.csr_bandwidth(200, Ap.indptr, Ap.indices) <= native.csr_bandwidth(
        200, A.indptr, A.indices)
    b = np.random.default_rng(4).standard_normal(200)
    x_p, info = tsp.bicgstab(Ap, torch.from_numpy(b[perm]), tol=1e-12, max_iter=2000)
    info.raise_if_error()
    x = np.empty(200)
    x[perm] = x_p.numpy()
    assert np.linalg.norm(S @ x - b) / np.linalg.norm(b) < 1e-9


def test_complex_bsr_matches_csr_oracle_and_jax():
    Sc = _random_complex()
    A, jA = tsp.csr_from_scipy(Sc), jsp.csr_from_scipy(Sc)
    cb, jcb = tsp.ComplexBSR.from_csr(A, bs=32), JComplexBSR.from_csr(jA, bs=32)
    _assert_same_blocks(cb, jcb, [(cb.blocks_re, jcb.blocks_re), (cb.blocks_im, jcb.blocks_im)])
    assert cb.shape == (300, 300) and cb.dtype == torch.complex128
    rng = np.random.default_rng(1)
    x = rng.standard_normal(300) + 1j * rng.standard_normal(300)
    y = cb.matvec(torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), Sc @ x, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(y.numpy(), np.asarray(jcb.matvec(jnp.asarray(x))), rtol=1e-12,
                               atol=1e-12)
    _, d = cb.matvec_dot(torch.from_numpy(x))
    assert complex(d) == pytest.approx(np.vdot(x, Sc @ x), rel=1e-12)
    r = complex_bsr_from_reference(jcb.blocks_re, jcb.blocks_im, jcb.blk_row, jcb.blk_col,
                                   jcb.padded_dim, jcb.n)
    assert torch.equal(r.matvec(torch.from_numpy(x)), y)


def test_complex_bsr_matmat_and_diagonal():
    Sc = _random_complex(n=200, seed=2)
    cb = tsp.ComplexBSR.from_csr(tsp.csr_from_scipy(Sc), bs=64)
    jcb = JComplexBSR.from_csr(jsp.csr_from_scipy(Sc), bs=64)
    rng = np.random.default_rng(3)
    X = rng.standard_normal((200, 3)) + 1j * rng.standard_normal((200, 3))
    np.testing.assert_allclose(cb.matmat(torch.from_numpy(X)).numpy(), Sc @ X, rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_array_equal(cb.diagonal().numpy(), np.asarray(jcb.diagonal()))
    np.testing.assert_array_equal(cb.diagonal().numpy(), Sc.diagonal())


@pytest.mark.parametrize("dtype", [np.complex128, np.complex64])
def test_complex_bsr_padding_non_multiple(dtype):
    Sc = _random_complex(n=173, seed=4).astype(dtype)
    cb = tsp.ComplexBSR.from_csr(tsp.csr_from_scipy(Sc), bs=32)
    assert cb.padded_dim % 32 == 0 and cb.shape == (173, 173)
    x = (np.random.default_rng(5).standard_normal(173) * (1 + 0.5j)).astype(dtype)
    y = cb.matvec(torch.from_numpy(x))
    assert y.dtype == torch.from_numpy(x).dtype
    want = Sc.astype(np.complex128) @ x.astype(np.complex128)
    tol = 1e-12 if dtype == np.complex128 else 1e-5
    np.testing.assert_allclose(y.numpy(), want, rtol=tol, atol=tol * np.abs(want).max())


def test_bicgstab_through_complex_bsr_matches_jax():
    Sc = _random_complex(n=256, seed=8, diag=12.0)
    cb = tsp.ComplexBSR.from_csr(tsp.csr_from_scipy(Sc), bs=32)
    jcb = JComplexBSR.from_csr(jsp.csr_from_scipy(Sc), bs=32)
    rng = np.random.default_rng(9)
    b = Sc @ (rng.standard_normal(256) + 1j * rng.standard_normal(256))
    M = cb.jacobi_precond()
    assert isinstance(M, tsp.ComplexDiagPrecond)
    x, info = tsp.bicgstab(cb, torch.from_numpy(b), M=M, tol=1e-10, max_iter=500)
    xj, info_j = jsp.bicgstab(jcb, jnp.asarray(b), M=jcb.jacobi_precond(), tol=1e-10,
                              max_iter=500)
    assert info.converged and bool(info_j.converged)
    assert abs(info.iterations - int(info_j.iterations)) <= _band(int(info_j.iterations))
    assert np.linalg.norm(Sc @ x.numpy() - b) / np.linalg.norm(b) < 1e-9
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-8, atol=1e-9)


def test_real_abs_jacobi_covers_bsr_and_reordered():
    """1/|d| from a ComplexBSR's diagonal, and through a Reordered wrapper
    from the inner (permuted) diagonal, as the JAX dispatcher builds it."""
    from sprsolve_tpu.precond import real_abs_jacobi as j_real_abs_jacobi

    Sc = _random_complex(n=120, seed=12, diag=9.0)
    cb = tsp.ComplexBSR.from_csr(tsp.csr_from_scipy(Sc), bs=32)
    jcb = JComplexBSR.from_csr(jsp.csr_from_scipy(Sc), bs=32)
    M2 = tsp.real_abs_jacobi(cb)
    np.testing.assert_allclose(M2.diag_inv.numpy(), 1.0 / np.abs(Sc.diagonal()), rtol=1e-12)
    perm = np.random.default_rng(13).permutation(120)
    M3 = tsp.real_abs_jacobi(reordered_from_reference(cb, perm))
    Mj = j_real_abs_jacobi(JReordered.wrap(jcb, perm))
    assert torch.equal(M3.diag_inv, M2.diag_inv)
    np.testing.assert_allclose(M3.diag_inv.numpy(), np.asarray(Mj.diag_inv), rtol=1e-12)


def test_reordered_forwards_what_jax_forwards():
    """Only the JAX class's methods: no fused K2/K4 entry points, so a
    solver composes them from matvec and separate dots."""
    A = tprob.poisson3d(4, 4, 4)
    op = Reordered.wrap(tsp.optimize(A, device="cpu"), np.arange(64)[::-1].copy())
    for name in ("matvec", "matvec_dot", "jacobi_precond", "relay_diag_precond",
                 "diagonal", "pad_vec", "unpad_vec"):
        assert hasattr(op, name)
    for name in ("matvec_wdot", "matvec_wdot_prec", "orth_norm", "matvec_conj_dot"):
        assert not hasattr(op, name)
    x = torch.arange(64, dtype=torch.float32)
    assert torch.equal(op.unpad_vec(op.pad_vec(x)), x)
    y = op.unpad_vec(op.matvec(op.pad_vec(x)))
    torch.testing.assert_close(y, A.matvec(x), rtol=1e-6, atol=1e-5)
