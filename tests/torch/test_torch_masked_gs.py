"""Cross tests of the port's MaskedGSPrecond against the JAX package's:
the six cases of ``tests/test_masked_gs.py``, each run through both.

The masked apply is elementwise work plus one SpMV per color after the
first, the same steps in both packages, so one apply agrees to 1e-14 in
f64 (the tolerance of the JAX test). Krylov counts under it agree within
the band of ``tests/test_serial_parity.py:183``, max(3, ⌈its/4⌉) (torch
sums in another order than XLA); the padded layout runs the port's
``PaddedDIA`` through its plain versions on the CPU."""

import jax.numpy as jnp
import numpy as np
import torch

import sprsolve_tpu as jsp
import sprsolve_tpu.ops.pallas_spmv as jps
import sprsolve_tpu_torch as tsp
from sprsolve_tpu.solvers.redblack import ColoredELL as JColoredELL
from sprsolve_tpu.utils import problems as jprob
from sprsolve_tpu_torch.utils import problems as tprob

torch.set_num_threads(2)


def _band(its):
    return max(3, -(-its // 4))


def _dirichlet(shape):
    b = np.zeros(shape[0] * shape[1])
    tprob.set_boundary_condition(b, shape, lambda r, c: float(r + c))
    return tprob.grid_laplacian_dirichlet(shape), jprob.grid_laplacian_dirichlet(shape), b


def _spd_poisson(side):
    dense = -np.asarray(jprob.sym_grid_laplacian((side, side))[0].todense())
    return tsp.csr_from_dense(dense), jsp.csr_from_dense(dense)


def _pair(A, jA, **kw):
    """The same masked GS preconditioner in both packages, on DIA."""
    colors = tsp.greedy_color(A)
    M = tsp.MaskedGSPrecond(A=A.to_dia(), diag=A.diagonal(), masks=tsp.color_masks(colors),
                            **kw)
    Mj = jsp.MaskedGSPrecond(A=jA.to_dia(), diag=jA.diagonal(),
                             masks=jsp.color_masks(colors), **kw)
    return M, Mj, colors


def test_masked_equals_colored_sweep():
    A, jA, _ = _dirichlet((8, 8))
    M, Mj, colors = _pair(A, jA, sweeps=1)
    r = np.random.default_rng(0).standard_normal(64)
    z = M.matvec(torch.as_tensor(r))
    z_colored = tsp.ColoredELL.from_csr(A, colors).sweep(torch.as_tensor(r),
                                                         torch.zeros(64, dtype=torch.float64))
    np.testing.assert_allclose(z.numpy(), z_colored.numpy(), rtol=1e-14, atol=1e-14)
    np.testing.assert_allclose(z.numpy(), np.asarray(Mj.matvec(jnp.asarray(r))),
                               rtol=1e-14, atol=1e-14)


def test_masked_gs_precond_accelerates_bicgstab():
    A, jA, b = _dirichlet((20, 20))
    M, Mj, _ = _pair(A, jA, sweeps=2)
    x, info = tsp.bicgstab(A, torch.as_tensor(b), M=M, tol=1e-14, max_iter=1500)
    _, info_0 = tsp.bicgstab(A, torch.as_tensor(b), tol=1e-14, max_iter=1500)
    assert info.converged and info.iterations < info_0.iterations // 2
    assert float(torch.linalg.vector_norm(A.matvec(x) - torch.as_tensor(b))) \
        / np.linalg.norm(b) < 1e-11
    xj, info_j = jsp.bicgstab(jA, jnp.asarray(b), M=Mj, tol=1e-14, max_iter=1500)
    assert bool(info_j.converged)
    assert abs(info.iterations - int(info_j.iterations)) <= _band(int(info_j.iterations))
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-9, atol=1e-9)


def test_masked_gs_in_pallas_layout():
    """The whole stack in the port's padded layout (the plain versions of
    K1/K2 on the CPU): masks padded as floats so the halo and the tail are
    False, the diagonal from ``diagonal_padded``; the JAX package runs its
    Pallas kernel in interpret mode."""
    A, jA, b = _dirichlet((16, 16))
    p = tsp.PaddedDIA.from_dia(A.to_dia(), device="cpu")
    colors = tsp.greedy_color(A)
    masks = tuple(p.pad_vec(m.to(torch.float64)) > 0 for m in tsp.color_masks(colors))
    for m in masks:
        assert not bool(m[: p.h].any()) and not bool(m[p.h + p.n:].any())
    M = tsp.MaskedGSPrecond(A=p, diag=p.diagonal_padded(), masks=masks, sweeps=1)
    b2 = p.pad_vec(torch.as_tensor(b))
    z = M.matvec(b2)
    assert not bool(z[: p.h].any()) and not bool(z[p.h + p.n:].any())
    x2, info = tsp.bicgstab(p, b2, M=M, tol=1e-13, max_iter=1500)
    assert info.converged
    x = p.unpad_vec(x2)
    assert float(torch.linalg.vector_norm(A.matvec(x) - torch.as_tensor(b))) \
        / np.linalg.norm(b) < 1e-10
    pj = jps.PaddedDIA.from_dia(jA.to_dia())
    jmasks = tuple(pj.pad_vec(m.astype(jnp.float64)).astype(bool)
                   for m in jsp.color_masks(colors))
    Mj = jsp.MaskedGSPrecond(A=pj, diag=pj.diagonal_padded(), masks=jmasks, sweeps=1)
    xj2, info_j = jsp.bicgstab(pj, pj.pad_vec(jnp.asarray(b)), M=Mj, tol=1e-13, max_iter=1500)
    assert bool(info_j.converged)
    assert abs(info.iterations - int(info_j.iterations)) <= _band(int(info_j.iterations))
    np.testing.assert_allclose(x.numpy(), np.asarray(pj.unpad_vec(xj2)), rtol=1e-9,
                               atol=1e-9)
    # the same apply as the flat preconditioner's, to 1e-14
    Mf, _, _ = _pair(A, jA, sweeps=1)
    np.testing.assert_allclose(p.unpad_vec(z).numpy(), Mf.matvec(torch.as_tensor(b)).numpy(),
                               rtol=1e-14, atol=1e-14)


def _materialize(M, n):
    return np.stack([M.matvec(torch.eye(n, dtype=torch.float64)[i]).numpy()
                     for i in range(n)], axis=1)


def test_ssor_apply_is_symmetric_map():
    A, jA = _spd_poisson(6)
    M, Mj, _ = _pair(A, jA, sweeps=1, omega=1.3, symmetric=True)
    dense = _materialize(M, 36)
    np.testing.assert_allclose(dense, dense.T, rtol=1e-12, atol=1e-13)
    assert np.linalg.eigvalsh((dense + dense.T) / 2)[0] > 0
    dense_j = np.stack([np.asarray(Mj.matvec(jnp.eye(36)[i])) for i in range(36)], axis=1)
    np.testing.assert_allclose(dense, dense_j, rtol=1e-14, atol=1e-14)


def test_forward_omega_one_unchanged():
    A, jA, _ = _dirichlet((8, 8))
    M, _, colors = _pair(A, jA)
    r = np.random.default_rng(3).standard_normal(64)
    want = JColoredELL.from_csr(jA, colors).sweep(jnp.asarray(r), jnp.zeros(64))
    np.testing.assert_allclose(M.matvec(torch.as_tensor(r)).numpy(), np.asarray(want),
                               rtol=1e-14, atol=1e-14)


def test_ssor_with_minres_and_cg():
    A, jA = _spd_poisson(16)
    M, Mj, _ = _pair(A, jA, sweeps=1, omega=1.5, symmetric=True)
    b = np.random.default_rng(4).standard_normal(256)
    bt, D, Dj = torch.as_tensor(b), A.to_dia(), jA.to_dia()
    _, info_m = tsp.minres(D, bt, M=M, tol=1e-10, max_iter=2000)
    info_m.raise_if_error()   # the symmetric apply passes the β² gate
    _, info_0 = tsp.minres(D, bt, tol=1e-10, max_iter=2000)
    assert info_m.iterations < info_0.iterations
    x_c, info_c = tsp.cg(D, bt, M=M, tol=1e-10, max_iter=2000)
    info_c.raise_if_error()
    assert float(torch.linalg.vector_norm(A.matvec(x_c) - bt)) / np.linalg.norm(b) < 1e-8
    for solver, info in ((jsp.minres, info_m), (jsp.cg, info_c)):
        _, info_j = solver(Dj, jnp.asarray(b), M=Mj, tol=1e-10, max_iter=2000)
        assert bool(info_j.converged)
        assert abs(info.iterations - int(info_j.iterations)) <= _band(int(info_j.iterations))
