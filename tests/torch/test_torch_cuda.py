"""GPU tests of the port: the CUDA kernels K1-K4 against their plain
PyTorch versions, and the solvers' paths through them.

Every test is marked ``cuda`` and skips itself where
``torch.cuda.is_available()`` is false.  This file imports no JAX, so it
also runs on a GPU machine without it; ``tests/conftest.py`` configures JAX,
so there run it with ``python -m pytest --noconftest tests/torch/test_torch_cuda.py``.

Tolerances, by vector dtype (eps = 2⁻²³ for f32, 2⁻⁵² for f64):
- y: |Δ| ≤ 8·eps·(|A|·|x|) per row (at most 7 products; either side may
  fuse a multiply-add);
- w·y, y·y, xᵀy, Σv₊²: |Δ| ≤ 1e-5 (f32) or 1e-12 (f64) · Σ|w·y| (block
  partials against one sum);
- K4's v₊: |Δ| ≤ 8·eps·(|a| + |β||v_old| + |α||v|) per entry (the kernel
  fuses the multiply-subtracts);
- narrow (int8/bf16) band storage: bitwise equal to the same values
  stored f32 (widening is exact)."""

import numpy as np
import pytest
import torch

import sprsolve_tpu_torch as tsp
from sprsolve_tpu_torch.ops import fused
from sprsolve_tpu_torch.ops import padded_dia as pd
from sprsolve_tpu_torch.sparse.containers import DIA
from sprsolve_tpu_torch.utils import problems

torch.set_num_threads(2)

EPS = {torch.float32: 2.0 ** -23, torch.float64: 2.0 ** -52}
DOT_RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _dia(name) -> DIA:
    if name == "grid20_f64":
        return problems.grid_laplacian_dirichlet((20, 20)).to_dia()
    base = problems.poisson3d(10, 10, 10).to_dia()
    vals = base.bands.numpy()
    if name == "random10":
        rng = np.random.default_rng(7)
        vals = np.where(vals != 0, rng.uniform(0.5, 1.5, vals.shape), 0)
    elif name == "bf16x2.5":
        vals = vals * 2.5
    return DIA(bands=torch.from_numpy(vals.astype(np.float32)), offsets=base.offsets,
               shape=base.shape)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["poisson10", "random10", "bf16x2.5", "grid20_f64"])
def test_cuda_kernels_match_plain(name, cuda):
    """K1 and the four K2 variants on the GPU against their plain versions
    on the same CUDA tensors."""
    op = pd.PaddedDIA.from_dia(_dia(name), device=cuda)
    rng = np.random.default_rng(5)
    mk = lambda: op.pad_vec(torch.as_tensor(rng.standard_normal(op.n), dtype=op.vdtype,
                                            device=cuda))
    x, w = mk(), mk()
    dinv = op.jacobi_precond().diag_inv
    absb = op.bands.to(op.vdtype).abs()
    pd.reset_launch_counts()
    for wv in (w, None):
        for dv in (None, dinv):
            y, wd, yd = pd.dia_wdot(op.bands, x, wv, dv, op.offsets, op.h)
            y_r, wd_r, yd_r = pd.dia_wdot_plain(op.bands, x, wv, dv, op.offsets, op.h)
            u = x if dv is None else x * dv
            scale = pd.dia_spmv_plain(absb, u.abs(), op.offsets, op.h)
            assert bool(((y - y_r).abs() <= 8 * EPS[op.vdtype] * scale).all())
            assert not bool(y[: op.h].any()) and not bool(y[op.h + op.n:].any())
            ws = x if wv is None else wv
            assert abs(float(wd - wd_r)) <= DOT_RTOL[op.vdtype] * float((ws * y_r).abs().sum())
            assert abs(float(yd - yd_r)) <= DOT_RTOL[op.vdtype] * float(yd_r)
            wide = pd.dia_wdot(op.bands.to(op.vdtype), x, wv, dv, op.offsets, op.h)
            assert torch.equal(y, wide[0]) and torch.equal(wd, wide[1])
    y = pd.dia_spmv(op.bands, x, op.offsets, op.h)
    y_r = pd.dia_spmv_plain(op.bands, x, op.offsets, op.h)
    scale = pd.dia_spmv_plain(absb, x.abs(), op.offsets, op.h)
    assert bool(((y - y_r).abs() <= 8 * EPS[op.vdtype] * scale).all())
    torch.cuda.synchronize()
    assert pd.dia_spmv.launches == 1 and pd.dia_wdot.launches == 8


def _dirty(like):
    """Free a NaN-filled block of ``like``'s size, so that the next kernel
    output (``torch.empty_like``) likely reuses it: a halo left uncleared
    then shows."""
    junk = torch.full_like(like, float("nan"))
    del junk


def _zero_halo(op, v):
    return not bool(v[: op.h].any()) and not bool(v[op.h + op.n:].any())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["poisson10", "random10", "bf16x2.5", "grid20_f64"])
def test_cuda_k3_k4_match_plain(name, cuda):
    """K3 and K4 on the GPU against their plain versions on the same CUDA
    tensors, with β and α as 0-d CUDA tensors; every output halo zero."""
    op = pd.PaddedDIA.from_dia(_dia(name), device=cuda)
    dt = op.vdtype
    rng = np.random.default_rng(6)
    mk = lambda: op.pad_vec(torch.as_tensor(rng.standard_normal(op.n), dtype=dt,
                                            device=cuda))
    x, vold, v = mk(), mk(), mk()
    absb = op.bands.to(dt).abs()
    pd.reset_launch_counts()
    _dirty(x)
    y, d = pd.dia_dot(op.bands, x, op.offsets, op.h)
    y_r, d_r = pd.dia_dot_plain(op.bands, x, op.offsets, op.h)
    scale = pd.dia_spmv_plain(absb, x.abs(), op.offsets, op.h)
    assert bool(((y - y_r).abs() <= 8 * EPS[dt] * scale).all())
    assert _zero_halo(op, y)
    assert abs(float(d - d_r)) <= DOT_RTOL[dt] * float((x * y_r).abs().sum())
    y2, d2 = pd.dia_dot(op.bands.to(dt), x, op.offsets, op.h)
    assert torch.equal(y, y2) and torch.equal(d, d2)
    beta = torch.tensor(0.7, dtype=dt, device=cuda)
    alpha = torch.tensor(-1.3, dtype=dt, device=cuda)
    _dirty(x)
    vn, ss = op.orth_norm(x, vold, v, beta, alpha)
    vn_r, ss_r = fused.orth_norm_plain(x, vold, v, beta, alpha)
    scale = x.abs() + 0.7 * vold.abs() + 1.3 * v.abs()
    assert bool(((vn - vn_r).abs() <= 8 * EPS[dt] * scale).all())
    assert _zero_halo(op, vn)
    assert abs(float(ss - ss_r)) <= DOT_RTOL[dt] * float(ss_r)
    torch.cuda.synchronize()
    assert pd.dia_dot.launches == 2 and fused.orth_norm.launches == 1


@pytest.mark.cuda
def test_cuda_minres_and_cg_run_through_k3_k4(cuda):
    """MINRES launches K1 once and K3 and K4 iterations + 1 times each (the
    converging pass is not counted); CG with Jacobi launches K3 once per
    iteration and K4 never. Both agree with the same solves on the CPU."""
    A = problems.poisson3d(10, 10, 10)
    b = np.random.default_rng(0).standard_normal(A.shape[0]).astype(np.float32)
    for kw in (dict(method="minres"), dict(method="cg", M="jacobi")):
        pd.reset_launch_counts()
        x, info = tsp.solve(A, b, tol=1e-5, max_iter=500, device=cuda, **kw)
        torch.cuda.synchronize()
        n = info.iterations
        assert info.converged and x.is_cuda
        minres = kw["method"] == "minres"
        assert pd.dia_spmv.launches == 1 and pd.dia_wdot.launches == 0
        assert pd.dia_dot.launches == (n + 1 if minres else n)
        assert fused.orth_norm.launches == (n + 1 if minres else 0)
        x_cpu, info_cpu = tsp.solve(A, b, tol=1e-5, max_iter=500, **kw)
        assert abs(n - info_cpu.iterations) <= 3
        r = A.matvec(x.cpu()).double().numpy() - b
        assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-4
        assert float(torch.linalg.norm(x.cpu() - x_cpu) / torch.linalg.norm(x_cpu)) < 1e-3
    # the padded iterate keeps an exact zero halo through the solve
    G, rhs = problems.sym_grid_laplacian((20, 20))
    op = pd.PaddedDIA.from_dia(G.to_dia(), device=cuda)
    x2, info = tsp.minres(op, op.pad_vec(torch.as_tensor(rhs, device=cuda)), tol=1e-12,
                          max_iter=1000)
    assert info.converged and _zero_halo(op, x2)


@pytest.mark.cuda
def test_cuda_wrappers_reject_what_the_kernels_do_not_take(cuda):
    op = pd.PaddedDIA.from_dia(problems.poisson3d(6, 6, 6).to_dia(), device=cuda)
    x = op.pad_vec(torch.ones(op.n, device=cuda))
    with pytest.raises(ValueError, match="one device"):
        pd.dia_spmv(op.bands.cpu(), x, op.offsets, op.h)
    with pytest.raises(TypeError):
        pd.dia_wdot(op.bands, x.double(), None, None, op.offsets, op.h)
    with pytest.raises(ValueError, match="one device"):
        fused.orth_norm(x, x.cpu(), x, 1.0, 1.0, op.h)


@pytest.mark.cuda
def test_cuda_solve_runs_through_the_kernels(cuda):
    """The main path on the GPU: K1 once, K2 twice per iteration, and the
    answer of the same solve on the CPU within f32 noise."""
    A = problems.poisson3d(24, 24, 24)
    b = np.random.default_rng(0).standard_normal(A.shape[0]).astype(np.float32)
    pd.reset_launch_counts()
    x, info = tsp.solve(A, b, M="jacobi", tol=1e-5, max_iter=400, device=cuda)
    assert info.converged and x.is_cuda
    assert pd.dia_spmv.launches == 1 and pd.dia_wdot.launches == 2 * info.iterations
    x_cpu, info_cpu = tsp.solve(A, b, M="jacobi", tol=1e-5, max_iter=400)
    assert abs(info.iterations - info_cpu.iterations) <= 3
    r = A.matvec(x.cpu()).double().numpy() - b
    assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-4
    assert float(torch.linalg.norm(x.cpu() - x_cpu) / torch.linalg.norm(x_cpu)) < 1e-3


@pytest.mark.cuda
def test_cuda_object_api_and_f64_route(cuda):
    """The CSR gather path (BiCGStab handle) and the f64 DIA route of
    solve() on the GPU agree with the same solves on the CPU."""
    rhs = np.zeros(400)
    problems.set_boundary_condition(rhs, (20, 20), lambda r, c: float(r + c))
    A = problems.grid_laplacian_dirichlet((20, 20))
    x, (its, res) = tsp.BiCGStab.new(A, 400, device=cuda).solve(rhs, max_iter=1500,
                                                                tol=1e-12)
    x_cpu, (its_cpu, _) = tsp.BiCGStab.new(A, 400).solve(rhs, max_iter=1500, tol=1e-12)
    assert x.is_cuda and res <= 1e-12 and abs(its - its_cpu) <= max(3, its_cpu // 4)
    np.testing.assert_allclose(x.cpu().numpy(), x_cpu.numpy(), rtol=1e-9, atol=1e-9)
    x2, info = tsp.solve(A, rhs, M="jacobi", tol=1e-12, max_iter=1500, device=cuda)
    assert x2.is_cuda and info.converged
    np.testing.assert_allclose(x2.cpu().numpy(), x_cpu.numpy(), rtol=1e-9, atol=1e-9)
