"""Cross tests of the port's multigrid V-cycle against the JAX package's
(mirrors ``tests/test_multigrid.py``): restriction and prolongation are
adjoint and equal to the JAX package's, each Galerkin level equals the
JAX hierarchy's and the explicit PᵀAP, the V-cycle is symmetric positive
definite (dense materialisation) and equals the JAX cycle applied to the
same state (``interop.grid_mg_from_reference``) and the port's own
``from_csr``, CG and MINRES with it, BiCGStab on the 3-D Poisson, the
relay onto the padded operator through ``solve``, the kernel-layout levels
behind ``FlatViewOperator``, and ``M="amg"`` on an unstructured matrix
(errors included).

Tolerances: f64 cycles agree with the JAX package's to 1e-12 (the same
smoother sweeps, transfers and dense coarse inverse), CG counts are equal
on the f64 fixtures; f32 counts within the band of
``test_serial_parity.py:183`` (max(3, ⌈its/4⌉))."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sprsolve_tpu as jsp
from sprsolve_tpu import multigrid as jmg
from sprsolve_tpu.utils import problems as jprob
import sprsolve_tpu_torch as tsp
from sprsolve_tpu_torch import multigrid as tmg
from sprsolve_tpu_torch.errors import IncompatibleMatrixFormat, InvalidPreconditioner
from sprsolve_tpu_torch.interop import csr_from_reference, grid_mg_from_reference
from sprsolve_tpu_torch.utils import problems as tprob

torch.set_num_threads(2)


def _band(its):
    return max(3, -(-its // 4))


def _spd_poisson2d(side):
    A, _ = jprob.sym_grid_laplacian((side, side))
    dense = -np.asarray(A.todense())
    return tsp.csr_from_dense(dense), jsp.csr_from_dense(dense)


@pytest.mark.parametrize("grid", [(7,), (8,), (5, 6), (8, 8), (3, 4, 5)])
def test_restrict_prolong_adjoint_and_as_jax(grid):
    rng = np.random.default_rng(0)
    n = int(np.prod(grid))
    nc = int(np.prod(tmg._coarse_grid(grid)))
    assert tmg._coarse_grid(grid) == jmg._coarse_grid(grid)
    x, y = rng.standard_normal(n), rng.standard_normal(nc)
    rx = tmg.restrict_grid(torch.as_tensor(x), grid)
    py = tmg.prolong_grid(torch.as_tensor(y), grid)
    lhs, rhs = float(rx @ torch.as_tensor(y)), float(torch.as_tensor(x) @ py)
    assert abs(lhs - rhs) < 1e-12 * max(1.0, abs(lhs))
    np.testing.assert_array_equal(rx.numpy(), np.asarray(jmg.restrict_grid(jnp.asarray(x), grid)))
    np.testing.assert_array_equal(py.numpy(), np.asarray(jmg.prolong_grid(jnp.asarray(y), grid)))


def test_galerkin_matches_jax_and_explicit_ptap():
    grid = (6, 5)
    rng = np.random.default_rng(1)
    n = 30
    dense = rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.3)
    Ac, coarse = tmg._galerkin_coarse(tsp.csr_from_dense(dense), grid)
    Acj, coarse_j = jmg._galerkin_coarse(jsp.csr_from_dense(dense), grid)
    assert coarse == coarse_j
    nc = int(np.prod(coarse))
    P = np.zeros((n, nc))
    for i in range(n):
        c = np.unravel_index(i, grid)
        P[i, np.ravel_multi_index(tuple(x // 2 for x in c), coarse)] = 1.0
    got = np.zeros((nc, nc))
    np.add.at(got, (Ac.row_ids.numpy(), Ac.indices.numpy()), Ac.data.numpy())
    np.testing.assert_allclose(got, P.T @ dense @ P, atol=1e-13)
    np.testing.assert_array_equal(got, np.asarray(Acj.todense()))


def test_hierarchy_levels_equal_jax():
    """Each level's grid, 1/diag and the coarsest inverse equal the JAX
    hierarchy's; the Galerkin CSRs chain to the same matrices."""
    tA, jA = _spd_poisson2d(16)
    M = tsp.GridMGPrecond.from_csr(tA, (16, 16), coarse_max=16, device="cpu")
    Mj = jsp.GridMGPrecond.from_csr(jA, (16, 16), coarse_max=16)
    assert M.grids == Mj.grids and len(M.ops) == len(Mj.ops)
    for d, dj in zip(M.dinvs, Mj.dinvs):
        np.testing.assert_array_equal(d.numpy(), np.asarray(dj))
    np.testing.assert_allclose(M.coarse_inv.numpy(), np.asarray(Mj.coarse_inv), rtol=1e-12,
                               atol=1e-14)
    csr, cj, g = tA, jA, (16, 16)
    for _ in M.grids:
        (csr, g1), (cj, _) = tmg._galerkin_coarse(csr, g), jmg._galerkin_coarse(cj, g)
        np.testing.assert_array_equal(csr.data.numpy(), np.asarray(cj.data))
        np.testing.assert_array_equal(csr.indices.numpy(), np.asarray(cj.indices))
        g = g1


def _reference_state(jA, grid, coarse_max):
    """The JAX hierarchy's state as numpy: level CSRs, 1/diags, coarse inverse."""
    Mj = jsp.GridMGPrecond.from_csr(jA, grid, coarse_max=coarse_max)
    levels, csr, g = [], jA, grid
    for _ in Mj.grids:
        levels.append((np.asarray(csr.data), np.asarray(csr.indices), np.asarray(csr.indptr),
                       csr.shape))
        csr, g = jmg._galerkin_coarse(csr, g)
    return Mj, levels


def test_vcycle_symmetric_pd_and_equal_to_jax():
    tA, jA = _spd_poisson2d(8)
    M = tsp.GridMGPrecond.from_csr(tA, (8, 8), coarse_max=8, device="cpu")
    Mj, levels = _reference_state(jA, (8, 8), 8)
    Mr = grid_mg_from_reference(levels, [np.asarray(d) for d in Mj.dinvs],
                                np.asarray(Mj.coarse_inv), Mj.grids)
    eye = torch.eye(64, dtype=torch.float64)
    dense = torch.stack([M.matvec(eye[:, i]) for i in range(64)], dim=1).numpy()
    np.testing.assert_allclose(dense, dense.T, rtol=1e-10, atol=1e-12)
    assert np.linalg.eigvalsh((dense + dense.T) / 2)[0] > 0
    dense_r = torch.stack([Mr.matvec(eye[:, i]) for i in range(64)], dim=1).numpy()
    dense_j = np.stack([np.asarray(Mj.matvec(jnp.zeros(64).at[i].set(1.0)))
                        for i in range(64)], axis=1)
    np.testing.assert_allclose(dense_r, dense_j, rtol=0, atol=1e-12)
    np.testing.assert_allclose(dense, dense_j, rtol=0, atol=1e-12)


def test_accelerates_cg_as_jax_and_nearly_grid_independent():
    iters = {}
    for side in (16, 32):
        tA, jA = _spd_poisson2d(side)
        M = tsp.GridMGPrecond.from_csr(tA, (side, side), coarse_max=32, device="cpu")
        Mj = jsp.GridMGPrecond.from_csr(jA, (side, side), coarse_max=32)
        b = np.random.default_rng(2).standard_normal(side * side)
        x, info = tsp.cg(tA.to_dia(), torch.as_tensor(b), M=M, tol=1e-10, max_iter=500)
        xj, ij = jsp.cg(jA.to_dia(), jnp.asarray(b), M=Mj, tol=1e-10, max_iter=500)
        info.raise_if_error()
        iters[side] = info.iterations
        assert info.iterations == int(ij.iterations)
        np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=0, atol=1e-10)
        _, info_0 = tsp.cg(tA.to_dia(), torch.as_tensor(b), tol=1e-10, max_iter=2000)
        assert iters[side] < info_0.iterations // 3
    assert iters[32] <= iters[16] + 6


def test_minres_gate_passes():
    tA, _ = _spd_poisson2d(16)
    M = tsp.GridMGPrecond.from_csr(tA, (16, 16), coarse_max=16, device="cpu")
    b = torch.as_tensor(np.random.default_rng(3).standard_normal(256))
    _, info = tsp.minres(tA.to_dia(), b, M=M, tol=1e-10, max_iter=500)
    info.raise_if_error()


def test_3d_poisson_bicgstab():
    A = tprob.poisson3d(8, 8, 8, dtype=np.float64)
    M = tsp.GridMGPrecond.from_csr(A, (8, 8, 8), coarse_max=64, device="cpu")
    b = torch.as_tensor(np.random.default_rng(4).standard_normal(512))
    x, info = tsp.bicgstab(A.to_dia(), b, M=M, tol=1e-10, max_iter=500)
    info.raise_if_error()
    _, info_j = tsp.bicgstab(A.to_dia(), b, M=tsp.DiagPrecond.new(A.diagonal()), tol=1e-10,
                             max_iter=500)
    assert info.iterations < info_j.iterations
    r = A.matvec(x).numpy() - b.numpy()
    assert np.linalg.norm(r) / np.linalg.norm(b.numpy()) < 1e-8


def test_through_solve_relayed_onto_the_padded_operator():
    """The f32 Poisson lands on the PaddedDIA; the flat V-cycle rides
    RelayedPrecond (the outer CG's fused dot on the kernel layout, the
    levels on torch DIA)."""
    tA, jA = tprob.poisson3d(8, 8, 8), jprob.poisson3d(8, 8, 8)
    M = tsp.GridMGPrecond.from_csr(tA, (8, 8, 8), device="cpu")
    Mj = jsp.GridMGPrecond.from_csr(jA, (8, 8, 8))
    assert all(isinstance(op, tsp.DIA) for op in M.ops)
    b = np.random.default_rng(5).standard_normal(512).astype(np.float32)
    kw = dict(method="cg", tol=1e-5, max_iter=200)
    handle = tsp.prepare(tA, M=M, device="cpu", **kw)
    assert isinstance(handle.operator, tsp.PaddedDIA)
    assert isinstance(handle._run.keywords["M"], tsp.RelayedPrecond)
    x, info = handle(b)
    xj, ij = jsp.solve(jA, b, M=Mj, **kw)
    info.raise_if_error()
    assert abs(info.iterations - int(ij.iterations)) <= _band(int(ij.iterations))
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-4, atol=1e-4)


def test_wrong_grid_raises():
    tA, _ = _spd_poisson2d(8)
    with pytest.raises(IncompatibleMatrixFormat):
        tsp.GridMGPrecond.from_csr(tA, (8, 9), device="cpu")


def test_kernel_layout_levels_match_default():
    A = tprob.poisson3d(8, 8, 8)
    b = torch.as_tensor(np.random.default_rng(6).standard_normal(512).astype(np.float32))
    M0 = tsp.GridMGPrecond.from_csr(A, (8, 8, 8), coarse_max=64, device="cpu")
    Mp = tsp.GridMGPrecond.from_csr(A, (8, 8, 8), coarse_max=64, prefer_kernels=True,
                                    device="cpu")
    assert any(isinstance(o, tmg.FlatViewOperator) for o in Mp.ops)
    np.testing.assert_allclose(Mp.matvec(b).numpy(), M0.matvec(b).numpy(), rtol=1e-5,
                               atol=1e-6)
    x, info = tsp.cg(A.to_dia(), b, M=Mp, tol=1e-5, max_iter=200)
    info.raise_if_error()


def _unstructured_spd(n=600, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.random((n, 2))
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    nbrs = np.argsort(d2, axis=1)[:, :6]
    W = np.zeros((n, n))
    W[np.repeat(np.arange(n), 6), nbrs.ravel()] = 1.0
    W = np.maximum(W, W.T)
    return np.diag(W.sum(1)) - W + 0.01 * np.eye(n)


def test_amg_string_on_unstructured_matrix_as_jax():
    L = _unstructured_spd()
    tA, jA = tsp.csr_from_dense(L), jsp.csr_from_dense(L)
    b = np.random.default_rng(1).standard_normal(600)
    kw = dict(method="cg", tol=1e-8, max_iter=2000)
    x, info = tsp.solve(tA, b, M="amg", device="cpu", **kw)
    xj, ij = jsp.solve(jA, b, M="amg", **kw)
    info.raise_if_error()
    assert np.linalg.norm(L @ x.numpy() - b) / np.linalg.norm(b) < 1e-6
    _, info_j = tsp.solve(tA, b, M="jacobi", device="cpu", **kw)
    assert info.iterations < info_j.iterations // 2
    assert abs(info.iterations - int(ij.iterations)) <= _band(int(ij.iterations))
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=0, atol=1e-8)


def test_amg_on_a_banded_order_relays_the_vcycle():
    """M="amg" where the RCM order is banded (a scrambled f32 chain): the
    inner operator is a PaddedDIA, so the 1-D V-cycle is relayed onto it
    inside the ``Reordered`` boundary.  (An RCM-ordered 3-D Poisson has
    hundreds of diagonals and lands on BSR, where the V-cycle runs flat.)"""
    import scipy.sparse as sps

    from sprsolve_tpu_torch.ops.reordered import Reordered

    n = 1024
    chain = sps.diags([-np.ones(n - 1), 2.5 * np.ones(n), -np.ones(n - 1)], [-1, 0, 1])
    perm = np.random.default_rng(3).permutation(n)
    S = chain.tocsr()[perm][:, perm].astype(np.float32).tocsr()
    tA, jA = tsp.csr_from_scipy(S), jsp.csr_from_scipy(S)
    b = np.random.default_rng(2).standard_normal(n).astype(np.float32)
    kw = dict(method="cg", tol=1e-5, max_iter=400)
    handle = tsp.prepare(tA, M="amg", device="cpu", **kw)
    assert isinstance(handle.operator, Reordered)
    assert isinstance(handle.operator.inner, tsp.PaddedDIA)
    M = handle._run.keywords["M"]
    assert isinstance(M, tsp.RelayedPrecond) and isinstance(M.inner, tsp.GridMGPrecond)
    assert len(M.inner.ops) >= 1
    x, info = handle(b)
    xj, ij = jsp.solve(jA, b, M="amg", **kw)
    info.raise_if_error()
    assert np.linalg.norm(S @ x.numpy() - b) / np.linalg.norm(b) < 2e-5
    assert abs(info.iterations - int(ij.iterations)) <= _band(int(ij.iterations))
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-3, atol=1e-3)


def test_amg_errors():
    L = _unstructured_spd(100, seed=2)
    A = tsp.csr_from_dense(L)
    with pytest.raises(InvalidPreconditioner):
        tsp.solve(A.to_ell(), np.zeros(100), M="amg", tol=1e-8, max_iter=10, device="cpu")
    Ac = tsp.CSR.from_arrays(A.data.numpy().astype(np.complex128), A.indices, A.indptr,
                             A.shape)
    with pytest.raises(InvalidPreconditioner):
        tsp.solve(Ac, np.zeros(100, complex), method="cs_minres", M="amg", tol=1e-8,
                  max_iter=10, device="cpu")
    assert isinstance(csr_from_reference(*([np.ones(1), np.zeros(1, np.int32),
                                            np.array([0, 1])]), (1, 1)), tsp.CSR)
