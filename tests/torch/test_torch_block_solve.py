"""Cross tests of the port's block CG and ``batched`` against the JAX
package's (mirrors ``tests/test_block_solve.py`` without its distributed
case, which no cross test holds yet: ROADMAP.md Queue 3): block CG's columns,
its shared Krylov space, Jacobi, a zero column, the breakdown, the complex
Hermitian block, and the padded layout's per-column SpMVs; ``batched``
BiCGStab, MINRES, COCG and CG.

``batched`` runs one solve per column, so each column's count and x are
its single solve's, bitwise.  The JAX package's ``vmap`` runs the columns
in lockstep and freezes only COCG's: an unfrozen recurrence (BiCGStab)
keeps iterating there until the slowest column ends.  So ``batched`` is
held per column against the port's own single solves (bitwise) and the JAX
package's SINGLE-column solves (BiCGStab at tol 1e-12 within the band of
``test_serial_parity.py:183``, x to 1e-9), and against the JAX ``batched`` only for COCG
and MINRES, where the two agree.  Block CG: equal counts with the JAX
package's on these f64 fixtures, X to 1e-10."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sprsolve_tpu as jsp
from sprsolve_tpu.utils import problems as jprob
import sprsolve_tpu_torch as tsp
from sprsolve_tpu_torch.errors import Status
from sprsolve_tpu_torch.interop import csr_from_reference
from sprsolve_tpu_torch.utils import problems as tprob

torch.set_num_threads(2)


def _spd_dense(shape=(16, 16)):
    A, _ = jprob.sym_grid_laplacian(shape)
    return -np.asarray(A.todense())


def _pair_dia(dense):
    return tsp.csr_from_dense(dense).to_dia(), jsp.csr_from_dense(dense).to_dia()


def _rel(dense, X, B):
    return np.linalg.norm(dense @ np.asarray(X) - B, axis=0) / np.linalg.norm(B, axis=0)


def test_block_cg_converges_all_columns_as_jax():
    dense = _spd_dense()
    tA, jA = _pair_dia(dense)
    B = np.random.default_rng(0).standard_normal((256, 8))
    X, info = tsp.block_cg(tA, torch.as_tensor(B), tol=1e-10, max_iter=600)
    Xj, ij = jsp.block_cg(jA, jnp.asarray(B), tol=1e-10, max_iter=600)
    info.raise_if_error()
    assert np.all(_rel(dense, X.numpy(), B) < 1e-9)
    assert info.iterations == int(ij.iterations)
    np.testing.assert_allclose(X.numpy(), np.asarray(Xj), rtol=0, atol=1e-10)


def test_block_cg_no_more_iterations_than_single():
    dense = _spd_dense()
    tA, _ = _pair_dia(dense)
    B = np.random.default_rng(1).standard_normal((256, 4))
    _, info = tsp.block_cg(tA, torch.as_tensor(B), tol=1e-10, max_iter=600)
    info.raise_if_error()
    worst = max(tsp.cg(tA, torch.as_tensor(B[:, j]), tol=1e-10, max_iter=600)[1].iterations
                for j in range(4))
    assert info.iterations <= worst


def test_block_cg_jacobi_as_jax():
    scal = np.linspace(1.0, 100.0, 256)
    dense = _spd_dense() * scal[:, None] * scal[None, :]
    tA, jA = _pair_dia(dense)
    B = np.random.default_rng(2).standard_normal((256, 6))
    M = tsp.DiagPrecond.new(torch.as_tensor(np.diag(dense).copy()))
    X, info = tsp.block_cg(tA, torch.as_tensor(B), M=M, tol=1e-10, max_iter=2000)
    Xj, ij = jsp.block_cg(jA, jnp.asarray(B), M=jsp.DiagPrecond.new(jnp.asarray(np.diag(dense))),
                          tol=1e-10, max_iter=2000)
    _, info_u = tsp.block_cg(tA, torch.as_tensor(B), tol=1e-10, max_iter=2000)
    info.raise_if_error()
    assert np.all(_rel(dense, X.numpy(), B) < 1e-8)
    assert info.iterations < info_u.iterations
    assert info.iterations == int(ij.iterations)


def test_block_cg_zero_column():
    dense = _spd_dense((8, 8))
    tA, jA = _pair_dia(dense)
    B = np.random.default_rng(3).standard_normal((64, 3))
    B[:, 1] = 0.0
    X, info = tsp.block_cg(tA, torch.as_tensor(B), tol=1e-12, max_iter=300)
    _, ij = jsp.block_cg(jA, jnp.asarray(B), tol=1e-12, max_iter=300)
    info.raise_if_error()
    X = X.numpy()
    assert np.linalg.norm(X[:, 1]) < 1e-10
    for j in (0, 2):
        assert np.linalg.norm(dense @ X[:, j] - B[:, j]) / np.linalg.norm(B[:, j]) < 1e-11
    assert info.iterations == int(ij.iterations)


def test_block_cg_not_pd_breaks_down_as_jax():
    tA, jA = _pair_dia(-np.eye(32))
    _, info = tsp.block_cg(tA, torch.ones((32, 2), dtype=torch.float64), tol=1e-12,
                           max_iter=50)
    _, ij = jsp.block_cg(jA, jnp.ones((32, 2)), tol=1e-12, max_iter=50)
    assert info.status == Status.BREAKDOWN == int(ij.status)
    assert info.iterations == int(ij.iterations)


def test_block_cg_complex_hermitian():
    jH, _ = jprob.hermitian_grid((8, 8))
    H = np.asarray(jH.todense())
    dense = -H + (abs(float(np.linalg.eigvalsh(-H).min())) + 1.0) * np.eye(64)
    rng = np.random.default_rng(4)
    B = rng.standard_normal((64, 4)) + 1j * rng.standard_normal((64, 4))
    X, info = tsp.block_cg(tsp.csr_from_dense(dense), torch.as_tensor(B), tol=1e-10,
                           max_iter=500)
    _, ij = jsp.block_cg(jsp.csr_from_dense(dense), jnp.asarray(B), tol=1e-10, max_iter=500)
    info.raise_if_error()
    assert np.all(_rel(dense, X.numpy(), B) < 1e-9)
    assert info.iterations == int(ij.iterations)


def test_block_cg_on_the_padded_layout_applies_a_per_column():
    """On a PaddedDIA each iteration applies A to every column of the
    (padded_len, k) block in one K1b launch (``PaddedDIA.matmat``, the
    JAX package's K1 under ``vmap``): its + 1 block applies in all, the
    first for R₀, and X bitwise what one matvec per column gives."""
    from sprsolve_tpu_torch.ops import padded_dia as pd

    A = tprob.poisson3d(6, 6, 6)
    op = tsp.optimize(A, device="cpu")
    B = np.random.default_rng(5).standard_normal((216, 4)).astype(np.float32)
    B2 = torch.stack([op.pad_vec(torch.as_tensor(B[:, j])) for j in range(4)], dim=1)
    calls = []
    orig = pd.dia_spmm
    pd.dia_spmm = lambda *a, **k: calls.append(a[1].shape) or orig(*a, **k)
    try:
        X2, info = tsp.block_cg(op, B2, tol=1e-5, max_iter=200)
    finally:
        pd.dia_spmm = orig
    info.raise_if_error()
    assert calls == [(op.padded_len, 4)] * (info.iterations + 1)

    class PerColumn:          # the same operator without a block apply
        shape = op.shape
        matvec = staticmethod(op.matvec)

    X2c, infoc = tsp.block_cg(PerColumn(), B2, tol=1e-5, max_iter=200)
    assert torch.equal(X2, X2c) and infoc.iterations == info.iterations
    X = torch.stack([op.unpad_vec(X2[:, j]) for j in range(4)], dim=1).numpy()
    S = A.to_dia()
    for j in range(4):
        r = S.matvec(torch.as_tensor(X[:, j])).numpy() - B[:, j]
        assert np.linalg.norm(r) / np.linalg.norm(B[:, j]) < 2e-5
    assert not bool(X2[: op.h].any())


def test_batched_bicgstab_is_per_column():
    tA = tprob.grid_laplacian_dirichlet((12, 12))
    jA = jprob.grid_laplacian_dirichlet((12, 12))
    dense = np.asarray(jA.todense())
    B = np.random.default_rng(6).standard_normal((144, 5))
    X, info = tsp.batched(tsp.bicgstab)(tA, torch.as_tensor(B), tol=1e-12, max_iter=800)
    assert info.iterations.shape == (5,) and info.residual.shape == (5,)
    assert bool((info.status == Status.CONVERGED).all())
    assert np.all(_rel(dense, X.numpy(), B) < 1e-10)
    for j in range(5):
        x, ij = tsp.bicgstab(tA, torch.as_tensor(B[:, j]), tol=1e-12, max_iter=800)
        assert torch.equal(X[:, j], x) and int(info.iterations[j]) == ij.iterations
        xj, ijj = jsp.bicgstab(jA, jnp.asarray(B[:, j]), tol=1e-12, max_iter=800)
        its_j = int(ijj.iterations)
        assert abs(int(info.iterations[j]) - its_j) <= max(3, -(-its_j // 4))
        np.testing.assert_allclose(X[:, j].numpy(), np.asarray(xj), rtol=0, atol=1e-9)


def test_batched_minres_mixed_convergence_as_jax():
    tA, rhs = tprob.sym_grid_laplacian((8, 8))
    jA, _ = jprob.sym_grid_laplacian((8, 8))
    B = np.stack([rhs, 1e-3 * rhs + 0.0], axis=1)
    X, info = tsp.batched(tsp.minres)(tA, torch.as_tensor(B), tol=1e-10, max_iter=300)
    Xj, ij = jsp.batched(jsp.minres)(jA, jnp.asarray(B), tol=1e-10, max_iter=300)
    assert bool((info.status == Status.CONVERGED).all())
    np.testing.assert_array_equal(info.iterations.numpy(), np.asarray(ij.iterations))
    np.testing.assert_allclose(X.numpy(), np.asarray(Xj), rtol=0, atol=1e-10)


def test_batched_cocg_freezes_per_column_as_jax():
    jC, rhs, diag = jprob.complex_symmetric_grid_with_diag((8, 8))
    tC = csr_from_reference(jC.data, jC.indices, jC.indptr, jC.shape)
    B = np.stack([rhs, 1e-2 * rhs, rhs[::-1].copy()], axis=1)
    X, info = tsp.batched(tsp.cocg)(tC, torch.as_tensor(B), tol=1e-12, max_iter=500)
    Xj, ij = jsp.batched(jsp.cocg)(jC, jnp.asarray(B), tol=1e-12, max_iter=500)
    assert bool((info.status == Status.CONVERGED).all())
    np.testing.assert_array_equal(info.iterations.numpy(), np.asarray(ij.iterations))
    np.testing.assert_allclose(X.numpy(), np.asarray(Xj), rtol=0, atol=1e-10)


def test_batched_jacobi_cg_on_the_padded_layout_matches_single_solves():
    A = tprob.poisson3d(6, 6, 6)
    op = tsp.optimize(A, device="cpu")
    M = op.jacobi_precond()
    B = np.random.default_rng(7).standard_normal((216, 3)).astype(np.float32)
    B2 = torch.stack([op.pad_vec(torch.as_tensor(B[:, j])) for j in range(3)], dim=1)
    X2, info = tsp.batched(tsp.cg)(op, B2, M=M, tol=1e-5, max_iter=200)
    for j in range(3):
        x, i1 = tsp.cg(op, B2[:, j].contiguous(), M=M, tol=1e-5, max_iter=200)
        assert torch.equal(X2[:, j], x) and int(info.iterations[j]) == i1.iterations


def test_batched_rejects_a_vector():
    with pytest.raises(ValueError, match="shape"):
        tsp.batched(tsp.cg)(tsp.csr_from_dense(np.eye(4)), torch.ones(4), tol=1e-6,
                            max_iter=5)
    with pytest.raises(ValueError, match="shape"):
        tsp.block_cg(tsp.csr_from_dense(np.eye(4)), torch.ones(4), tol=1e-6, max_iter=5)
