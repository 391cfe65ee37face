"""GPU tests of the port: the CUDA kernels K1-K7 against their plain
PyTorch versions, and the solvers' paths through them; K2's and K3's y
bitwise equal to K1's, K6's and K7's (without the fold) to K5's, and their
dots bitwise the same from call to call and through a CUDA-graph replay.

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
  stored f32 (widening is exact);
- K5-K7 (complex): y within 8·eps·((|A_re| + |A_im|)·(|u_re| + |u_im|)) per
  row, the partials within 1e-5 (c64) or 1e-12 (c128) · Σ|w||y|."""

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
        x_cpu, info_cpu = tsp.solve(A, b, tol=1e-5, max_iter=500, device="cpu", **kw)
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
    x_cpu, info_cpu = tsp.solve(A, b, M="jacobi", tol=1e-5, max_iter=400,
                                device="cpu")
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
    x_cpu, (its_cpu, _) = tsp.BiCGStab.new(A, 400, device="cpu").solve(rhs, max_iter=1500,
                                                                    tol=1e-12)
    assert x.is_cuda and res <= 1e-12 and abs(its - its_cpu) <= max(3, its_cpu // 4)
    np.testing.assert_allclose(x.cpu().numpy(), x_cpu.numpy(), rtol=1e-9, atol=1e-9)
    x2, info = tsp.solve(A, rhs, M="jacobi", tol=1e-12, max_iter=1500, device=cuda)
    assert x2.is_cuda and info.converged
    np.testing.assert_allclose(x2.cpu().numpy(), x_cpu.numpy(), rtol=1e-9, atol=1e-9)


def _complex_dia(name, k=10) -> DIA:
    """The two-plane band sets: the damped Poisson (A + 0.5i·I: int8 real
    plane, bf16 imaginary plane), the Poisson times (1 + 0.5i) (int8/bf16),
    and random complex64 and complex128 values on the Poisson's pattern."""
    base = problems.poisson3d(k, k, k).to_dia()
    vals = base.bands.numpy().astype(np.complex128)
    if name == "damped":
        vals[base.offsets.index(0)] += 0.5j
    elif name == "scaled":
        vals = vals * (1 + 0.5j)
    else:
        rng = np.random.default_rng(8)
        mask = vals != 0
        vals = np.where(mask, rng.uniform(0.5, 1.5, vals.shape)
                        + 1j * rng.uniform(-1, 1, vals.shape), 0)
    dt = np.complex128 if name == "random_c128" else np.complex64
    return DIA(bands=torch.from_numpy(vals.astype(dt)), offsets=base.offsets,
               shape=base.shape)


COMPLEX_STORAGE = {"damped": (torch.int8, torch.bfloat16),
                   "scaled": (torch.int8, torch.bfloat16),
                   "random_c64": (torch.float32, torch.float32),
                   "random_c128": (torch.float64, torch.float64)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(COMPLEX_STORAGE))
def test_cuda_complex_kernels_match_plain(name, cuda):
    """K5, K6 (both forms) and the four K7 variants on the GPU against their
    plain versions on the same CUDA tensors; every output halo zero; narrow
    planes bitwise equal to the same values stored wide."""
    op = tsp.ComplexPaddedDIA.from_dia(_complex_dia(name), device=cuda)
    assert (op.re.bands.dtype, op.im.bands.dtype) == COMPLEX_STORAGE[name]
    rdt = op.re.vdtype
    rng = np.random.default_rng(9)
    mk = lambda: op.pad_vec(torch.complex(
        *(torch.as_tensor(rng.standard_normal(op.n), dtype=rdt, device=cuda)
          for _ in range(2))))
    x, w = mk(), mk()
    dinv = op.jacobi_precond().diag_inv
    bre, bim = op.re.bands, op.im.bands
    wide = (bre.to(rdt), bim.to(rdt))
    absb = bre.to(rdt).abs() + bim.to(rdt).abs()
    eps, dot_rtol = EPS[rdt], DOT_RTOL[rdt]

    def y_ok(y, y_r, u):
        scale = pd.dia_spmv_plain(absb, u.real.abs() + u.imag.abs(), op.offsets, op.h)
        return bool(((y - y_r).abs() <= 8 * eps * scale).all()) and _zero_halo(op, y)

    pd.reset_launch_counts()
    _dirty(x)
    y = pd.dia_complex_spmv(bre, bim, x, op.offsets, op.h)
    assert y_ok(y, pd.dia_complex_spmv_plain(bre, bim, x, op.offsets, op.h), x)
    assert torch.equal(y, pd.dia_complex_spmv(*wide, x, op.offsets, op.h))
    for conj_x in (False, True):
        _dirty(x)
        y, d = pd.dia_complex_dot(bre, bim, x, op.offsets, op.h, conj_x)
        y_r, d_r = pd.dia_complex_dot_plain(bre, bim, x, op.offsets, op.h, conj_x)
        assert y_ok(y, y_r, x)
        assert abs(complex(d - d_r)) <= dot_rtol * float((x.abs() * y_r.abs()).sum())
        yw, dw = pd.dia_complex_dot(*wide, x, op.offsets, op.h, conj_x)
        assert torch.equal(y, yw) and torch.equal(d, dw)
    for wv in (w, None):
        for dv in (None, dinv):
            _dirty(x)
            y, wd, yd = pd.dia_complex_wdot(bre, bim, x, wv, dv, op.offsets, op.h)
            y_r, wd_r, yd_r = pd.dia_complex_wdot_plain(bre, bim, x, wv, dv,
                                                        op.offsets, op.h)
            assert y_ok(y, y_r, x if dv is None else x * dv)
            ws = (x if wv is None else wv).abs()
            assert abs(complex(wd - wd_r)) <= dot_rtol * float((ws * y_r.abs()).sum())
            assert abs(complex(yd - yd_r)) <= dot_rtol * float(yd_r.real)
            assert yd.dtype == x.dtype and float(yd.imag) == 0.0
            got_w = pd.dia_complex_wdot(*wide, x, wv, dv, op.offsets, op.h)
            assert all(torch.equal(a, b) for a, b in zip((y, wd, yd), got_w))
    torch.cuda.synchronize()
    assert pd.dia_complex_spmv.launches == 2 and pd.dia_complex_dot.launches == 4
    assert pd.dia_complex_wdot.launches == 8
    assert pd.dia_spmv.launches == pd.dia_wdot.launches == pd.dia_dot.launches == 0


@pytest.mark.cuda
def test_cuda_complex_solves_run_through_k5_k7(cuda):
    """The slice on the GPU at small size, on the damped complex-symmetric
    Poisson: auto → COCG launches K5 once per iteration plus once; CS-MINRES
    with M="jacobi" (real 1/|d|) launches K6 per pass; BiCGStab with the
    complex Jacobi launches K7 twice per iteration; none touches K1-K4. Each
    agrees with the same solve on the CPU."""
    from sprsolve_tpu_torch.sparse.containers import CSR

    dia = _complex_dia("damped", 12)
    S = sum_planes(dia)
    A = CSR.from_arrays(S.data, S.indices, S.indptr, S.shape)
    rng = np.random.default_rng(1)
    r = rng.standard_normal(A.shape[0])
    b = (r + 0.25j * r).astype(np.complex64)
    for method in ("auto", "cs_minres", "bicgstab"):
        pd.reset_launch_counts()
        x, info = tsp.solve(A, b, method=method, M="jacobi", tol=1e-5, max_iter=400,
                            device=cuda)
        torch.cuda.synchronize()
        n = info.iterations
        assert info.converged and x.is_cuda and x.dtype == torch.complex64
        want = {"auto": (n + 1, 0, 0), "cs_minres": (1, n + 1, 0),
                "bicgstab": (1, 0, 2 * n)}[method]
        got = (pd.dia_complex_spmv.launches, pd.dia_complex_dot.launches,
               pd.dia_complex_wdot.launches)
        assert got == want, (method, got, want)
        assert pd.dia_spmv.launches == pd.dia_wdot.launches == pd.dia_dot.launches == 0
        assert fused.orth_norm.launches == 0
        x_cpu, info_cpu = tsp.solve(A, b, method=method, M="jacobi", tol=1e-5,
                                    max_iter=400, device="cpu")
        assert abs(n - info_cpu.iterations) <= 3
        res = np.linalg.norm(S @ x.cpu().numpy().astype(np.complex128) - b)
        assert res / np.linalg.norm(b) < 1e-4
        assert float(torch.linalg.norm(x.cpu() - x_cpu) / torch.linalg.norm(x_cpu)) < 1e-3


def sum_planes(dia: DIA):
    """scipy CSR of a DIA (the test's reference operator)."""
    import scipy.sparse as sps

    n = dia.shape[0]
    bands = dia.bands.numpy()
    cols = [np.arange(n) + off for off in dia.offsets]
    rows = np.concatenate([np.arange(n)[(c >= 0) & (c < n)] for c in cols])
    vals = np.concatenate([bands[d][(c >= 0) & (c < n)] for d, c in enumerate(cols)])
    cols = np.concatenate([c[(c >= 0) & (c < n)] for c in cols])
    return sps.csr_matrix((vals, (rows, cols)), shape=dia.shape)


@pytest.mark.cuda
def test_cuda_c128_minres_on_a_hermitian_grid_runs_k6(cuda):
    """MINRES on a Hermitian c128 ComplexPaddedDIA takes α from K6 without
    conjugation; the manufactured solution comes back to 1e-9."""
    A, rhs = problems.hermitian_grid((20, 20))
    op = tsp.ComplexPaddedDIA.from_csr(A, device=cuda)
    pd.reset_launch_counts()
    x2, info = tsp.minres(op, op.pad_vec(torch.as_tensor(rhs, device=cuda)), tol=1e-12,
                          max_iter=3000)
    torch.cuda.synchronize()
    assert info.converged and _zero_halo(op, x2)
    assert pd.dia_complex_dot.launches == info.iterations + 1
    xk = np.array([complex(i, j) for i in range(20) for j in range(20)])
    assert np.abs(op.unpad_vec(x2).cpu().numpy() - xk).max() < 1e-9


@pytest.mark.cuda
def test_cuda_solve_defaults_to_the_card(cuda):
    """Without a device argument solve() runs on the GPU through the
    kernels."""
    A = problems.poisson3d(8, 8, 8)
    b = np.random.default_rng(2).standard_normal(A.shape[0]).astype(np.float32)
    pd.reset_launch_counts()
    x, info = tsp.solve(A, b, M="jacobi", tol=1e-5, max_iter=200)
    torch.cuda.synchronize()
    assert info.converged and x.is_cuda
    assert pd.dia_wdot.launches == 2 * info.iterations
    assert isinstance(tsp.optimize(A), tsp.PaddedDIA)
    assert tsp.optimize(A).device.type == "cuda"


# --- K2 and K3: one launch, y bitwise K1's, deterministic dots --------------
def _dot_op(storage, k, cuda):
    """A PaddedDIA on the k³ Poisson's pattern whose bands store as
    ``storage``: the Poisson itself (int8), ×2.5 (bf16), random values (f32)
    or random f64 values."""
    base = problems.poisson3d(k, k, k).to_dia()
    vals = base.bands.numpy().astype(np.float64)
    rng = np.random.default_rng(11)
    if storage == "bfloat16":
        vals = vals * 2.5
    elif storage in ("float32", "float64"):
        vals = np.where(vals != 0, rng.uniform(0.5, 1.5, vals.shape), 0)
    dt = np.float64 if storage == "float64" else np.float32
    op = pd.PaddedDIA.from_dia(DIA(bands=torch.from_numpy(vals.astype(dt)),
                                   offsets=base.offsets, shape=base.shape), device=cuda)
    assert str(op.bands.dtype) == f"torch.{storage}"
    return op


def _dot_vecs(op, cuda, seed=12):
    rng = np.random.default_rng(seed)
    mk = lambda: op.pad_vec(torch.as_tensor(rng.standard_normal(op.n), dtype=op.vdtype,
                                            device=cuda))
    return mk(), mk(), op.jacobi_precond().diag_inv


def _dot_calls(op, x, w, dinv):
    """name → (call, the SpMV input u) for K3 and the four K2 variants."""
    b, o, h = op.bands, op.offsets, op.h
    return {
        "K3": (lambda bb: pd.dia_dot(bb, x, o, h), x),
        "K2 w": (lambda bb: pd.dia_wdot(bb, x, w, None, o, h), x),
        "K2 w=x": (lambda bb: pd.dia_wdot(bb, x, None, None, o, h), x),
        "K2 w dinv": (lambda bb: pd.dia_wdot(bb, x, w, dinv, o, h), x * dinv),
        "K2 w=x dinv": (lambda bb: pd.dia_wdot(bb, x, None, dinv, o, h), x * dinv),
    }


# n = 216 (one row tile, offsets 1, 6, 36), 2197 (ragged: the last tile is
# part full; offset 169 lies beyond the staged halo and breaks 16-byte
# alignment) and 13824 (offset 576 beyond the halo, aligned): each grid is
# smaller than the card
@pytest.mark.cuda
@pytest.mark.parametrize("k", [6, 13, 24])
@pytest.mark.parametrize("storage", ["int8", "bfloat16", "float32", "float64"])
def test_cuda_k2_k3_y_is_k1_bitwise_and_dots_match_plain(storage, k, cuda):
    """K3's y equals K1(x) and K2's y equals K1(x ⊙ dinv) or K1(x) bit for
    bit, with a zero halo; the dots agree with the plain versions; narrow
    bands give bitwise the output of the same values stored wide; one
    launch per call."""
    op = _dot_op(storage, k, cuda)
    x, w, dinv = _dot_vecs(op, cuda)
    dt, wide = op.vdtype, op.bands.to(op.vdtype)
    pd.reset_launch_counts()
    for name, (call, u) in _dot_calls(op, x, w, dinv).items():
        _dirty(x)
        got = call(op.bands)
        assert torch.equal(got[0], pd.dia_spmv(op.bands, u, op.offsets, op.h)), name
        assert _zero_halo(op, got[0]), name
        assert all(d.shape == () and d.dtype == dt for d in got[1:])
        if name == "K3":
            want = pd.dia_dot_plain(op.bands, x, op.offsets, op.h)
            scales = [(x * want[0]).abs().sum()]
        else:
            wv = None if "w=x" in name else w
            dv = dinv if "dinv" in name else None
            want = pd.dia_wdot_plain(op.bands, x, wv, dv, op.offsets, op.h)
            scales = [((x if wv is None else wv) * want[0]).abs().sum(), want[2]]
        for d, d_r, s in zip(got[1:], want[1:], scales):
            assert abs(float(d - d_r)) <= DOT_RTOL[dt] * float(s), name
        assert all(torch.equal(a, b) for a, b in zip(got, call(wide))), name
    torch.cuda.synchronize()
    assert pd.dia_dot.launches == 2 and pd.dia_wdot.launches == 8
    assert pd.dia_spmv.launches == 5


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["int8", "float64"])
def test_cuda_k2_k3_are_deterministic_and_replay_in_a_graph(storage, cuda):
    """Ten eager calls give bitwise the same dots; a CUDA graph of the same
    calls replays to bitwise the eager outputs, and every ticket is back at
    0 after the replay."""
    op = _dot_op(storage, 24, cuda)
    x, w, dinv = _dot_vecs(op, cuda)
    calls = _dot_calls(op, x, w, dinv)
    eager = {name: call(op.bands) for name, (call, _) in calls.items()}
    for _ in range(10):
        for name, (call, _) in calls.items():
            assert all(torch.equal(a, b) for a, b in zip(call(op.bands), eager[name]))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for call, _ in calls.values():
            call(op.bands)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = {name: call(op.bands) for name, (call, _) in calls.items()}
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        for name in calls:
            assert all(torch.equal(a, b) for a, b in zip(captured[name], eager[name])), name
    for buf in pd._dot_scratch.values():
        assert int(buf[:4].view(torch.int32).item()) == 0


@pytest.mark.cuda
def test_cuda_k2_k3_walk_many_tiles_on_a_small_grid(monkeypatch, cuda):
    """With the card said to have one SM (8 blocks), each block walks many
    tiles: y and the dots are bitwise those of the full grid (the kernel
    sums per-tile partials in tile order, whatever the grid)."""
    op = _dot_op("int8", 24, cuda)
    x, w, dinv = _dot_vecs(op, cuda)
    calls = _dot_calls(op, x, w, dinv)
    full = {name: call(op.bands) for name, (call, _) in calls.items()}
    monkeypatch.setattr(pd, "_sm_count", lambda index: 1)
    assert pd.persistent_grid(op.n_pad, op.vdtype, 1) == 8 < op.n_pad // pd.DOT_TILE
    for name, (call, _) in calls.items():
        assert all(torch.equal(a, b) for a, b in zip(call(op.bands), full[name])), name


# --- K6 and K7: one launch, y bitwise K5's, deterministic dots --------------
COMPLEX_PLANES = ["int8/bfloat16", "bfloat16/int8", "float32/float32", "float64/float64"]


def _cdot_op(planes, k, cuda):
    """A ComplexPaddedDIA on the k³ Poisson's pattern whose planes store as
    ``planes`` (real/imaginary): the damped Poisson A + 0.5i·I, the Poisson
    times (2.5 + i), random complex64 or random complex128 values."""
    base = problems.poisson3d(k, k, k).to_dia()
    vals = base.bands.numpy().astype(np.complex128)
    if planes == "int8/bfloat16":
        vals[base.offsets.index(0)] += 0.5j
    elif planes == "bfloat16/int8":
        vals = vals * (2.5 + 1j)
    else:
        rng = np.random.default_rng(13)
        vals = np.where(vals != 0, rng.uniform(0.5, 1.5, vals.shape)
                        + 1j * rng.uniform(-1, 1, vals.shape), 0)
    dt = np.complex128 if planes == "float64/float64" else np.complex64
    op = tsp.ComplexPaddedDIA.from_dia(DIA(bands=torch.from_numpy(vals.astype(dt)),
                                           offsets=base.offsets, shape=base.shape),
                                       device=cuda)
    got = "/".join(str(p.bands.dtype).replace("torch.", "") for p in (op.re, op.im))
    assert got == planes
    return op


def _cdot_vecs(op, cuda, seed=14):
    rng = np.random.default_rng(seed)
    rdt = op.re.vdtype
    mk = lambda: op.pad_vec(torch.complex(
        *(torch.as_tensor(rng.standard_normal(op.n), dtype=rdt, device=cuda)
          for _ in range(2))))
    return mk(), mk(), op.jacobi_precond().diag_inv


def _cdot_calls(op, x, w, dinv):
    """name → (call on a pair of planes, K5's input that gives its y bit for
    bit, or None under the fold) for K6 (both forms) and the four K7
    variants."""
    o, h = op.offsets, op.h
    return {
        "K6": (lambda p: pd.dia_complex_dot(*p, x, o, h), x),
        "K6 conj": (lambda p: pd.dia_complex_dot(*p, x, o, h, True), torch.conj_physical(x)),
        "K7 w": (lambda p: pd.dia_complex_wdot(*p, x, w, None, o, h), x),
        "K7 w=x": (lambda p: pd.dia_complex_wdot(*p, x, None, None, o, h), x),
        "K7 w dinv": (lambda p: pd.dia_complex_wdot(*p, x, w, dinv, o, h), None),
        "K7 w=x dinv": (lambda p: pd.dia_complex_wdot(*p, x, None, dinv, o, h), None),
    }


# k as for K2/K3 above: offset 169 (k = 13) lies beyond the staged halo and is
# odd, 576 (k = 24) is even; n_pad 256, 2304 and 13824 give 1, 5 (the last
# half full) and 27 tiles of 512 rows
@pytest.mark.cuda
@pytest.mark.parametrize("k", [6, 13, 24])
@pytest.mark.parametrize("planes", COMPLEX_PLANES)
def test_cuda_k6_k7_y_is_k5_bitwise_and_dots_match_plain(planes, k, cuda):
    """K6's y equals K5(x), K6 with conj_x K5(conj(x)) and K7's without the
    fold K5(x) bit for bit, with a zero halo; under the fold y agrees with
    the plain version; the dots agree with the plain versions and come back
    as 0-d complex tensors; narrow planes give bitwise the output of the
    same values stored wide; one launch per call."""
    op = _cdot_op(planes, k, cuda)
    x, w, dinv = _cdot_vecs(op, cuda)
    rdt, o, h = op.re.vdtype, op.offsets, op.h
    planes_t = (op.re.bands, op.im.bands)
    wide = tuple(p.to(rdt) for p in planes_t)
    absb = wide[0].abs() + wide[1].abs()
    pd.reset_launch_counts()
    for name, (call, u) in _cdot_calls(op, x, w, dinv).items():
        _dirty(x)
        got = call(planes_t)
        if u is not None:
            assert torch.equal(got[0], pd.dia_complex_spmv(*planes_t, u, o, h)), name
        assert _zero_halo(op, got[0]), name
        assert all(d.shape == () and d.dtype == x.dtype for d in got[1:]), name
        if name.startswith("K6"):
            want = pd.dia_complex_dot_plain(*planes_t, x, o, h, name == "K6 conj")
            ws = x
        else:
            wv = None if "w=x" in name else w
            dv = dinv if "dinv" in name else None
            want = pd.dia_complex_wdot_plain(*planes_t, x, wv, dv, o, h)
            ws = x if wv is None else wv
            assert float(got[2].imag) == 0.0, name
        uu = x if "dinv" not in name else x * dinv
        scale = pd.dia_spmv_plain(absb, uu.real.abs() + uu.imag.abs(), o, h)
        assert bool(((got[0] - want[0]).abs() <= 8 * EPS[rdt] * scale).all()), name
        scales = [(ws.abs() * want[0].abs()).sum(), want[2].real if len(want) > 2 else 0]
        for d, d_r, s in zip(got[1:], want[1:], scales):
            assert abs(complex(d - d_r)) <= DOT_RTOL[rdt] * float(s), name
        assert all(torch.equal(a, b) for a, b in zip(got, call(wide))), name
    torch.cuda.synchronize()
    assert pd.dia_complex_dot.launches == 4 and pd.dia_complex_wdot.launches == 8
    assert pd.dia_complex_spmv.launches == 4


@pytest.mark.cuda
@pytest.mark.parametrize("planes", ["int8/bfloat16", "float64/float64"])
def test_cuda_k6_k7_are_deterministic_and_replay_in_a_graph(planes, cuda):
    """Ten eager calls give bitwise the same outputs; a CUDA graph of the
    same calls replays to bitwise the eager outputs, and every ticket is
    back at 0 after the replay."""
    op = _cdot_op(planes, 24, cuda)
    x, w, dinv = _cdot_vecs(op, cuda)
    p = (op.re.bands, op.im.bands)
    calls = _cdot_calls(op, x, w, dinv)
    eager = {name: call(p) for name, (call, _) in calls.items()}
    for _ in range(10):
        for name, (call, _) in calls.items():
            assert all(torch.equal(a, b) for a, b in zip(call(p), eager[name])), name
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for call, _ in calls.values():
            call(p)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = {name: call(p) for name, (call, _) in calls.items()}
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        for name in calls:
            assert all(torch.equal(a, b) for a, b in zip(captured[name], eager[name])), name
    for buf in pd._dot_scratch.values():
        assert int(buf[:4].view(torch.int32).item()) == 0


@pytest.mark.cuda
def test_cuda_k6_k7_walk_many_tiles_on_a_small_grid(monkeypatch, cuda):
    """With the card said to have one SM, each K6/K7 block walks 72 tiles
    through its two-stage pipeline: y is still K5's bit for bit where
    unfolded, and y and the dots are bitwise those of the full grid."""
    op = _cdot_op("int8/bfloat16", 48, cuda)
    x, w, dinv = _cdot_vecs(op, cuda)
    p = (op.re.bands, op.im.bands)
    calls = _cdot_calls(op, x, w, dinv)
    full = {name: call(p) for name, (call, _) in calls.items()}
    monkeypatch.setattr(pd, "_sm_count", lambda index: 1)
    blocks = pd.persistent_grid(op.n_pad, x.dtype, 1)
    assert blocks == pd.DOT_BLOCKS_PER_SM[x.dtype] and op.n_pad // pd.COMPLEX_DOT_TILE == 216
    for name, (call, u) in calls.items():
        got = call(p)
        if u is not None:
            assert torch.equal(got[0], pd.dia_complex_spmv(*p, u, op.offsets, op.h)), name
        assert all(torch.equal(a, b) for a, b in zip(got, full[name])), name


# --- the preconditioners on the kernels --------------------------------------
class _PlainK1:
    """``op``'s SpMV through K1's plain version on the same CUDA tensors: the
    yardstick of a preconditioner built on the kernel operator."""

    def __init__(self, op):
        self.op, self.shape = op, op.shape

    def matvec(self, x2):
        return pd.dia_spmv_plain(self.op.bands, x2, self.op.offsets, self.op.h)


def _gs_setup(cuda, k=10):
    A = problems.poisson3d(k, k, k)
    op = pd.PaddedDIA.from_dia(A.to_dia(), device=cuda)
    colors = tsp.greedy_color(A)
    assert colors.max() + 1 == 2
    masks = tuple(op.pad_vec(m.to(torch.float32)) > 0
                  for m in tsp.color_masks(colors, device=cuda))
    return A, op, masks


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["gs", "ssor", "chebyshev"])
def test_cuda_preconditioners_on_k1_match_plain(kind, cuda):
    """Forward masked GS, multicolor SSOR and Chebyshev of degree 4 on a
    CUDA PaddedDIA: one apply launches K1 once, twice and four times, keeps
    the halo zero, and agrees with the same preconditioner on K1's plain
    version: within 8·eps·|A|·|z| per SpMV (|A|'s row sums are at most 12),
    times 8 for up to four SpMVs and the apply's scalings between them."""
    A, op, masks = _gs_setup(cuda)
    diag = op.diagonal_padded()

    def build(oper):
        if kind == "chebyshev":
            return tsp.ChebyshevPrecond(A=oper, lmin=0.05, lmax=12.0, degree=4)
        return tsp.MaskedGSPrecond(A=oper, diag=diag, masks=masks, omega=1.5 if kind == "ssor"
                                   else 1.0, symmetric=kind == "ssor")

    r = op.pad_vec(torch.as_tensor(np.random.default_rng(3).standard_normal(op.n),
                                   dtype=torch.float32, device=cuda))
    pd.reset_launch_counts()
    _dirty(r)
    z = build(op).matvec(r)
    torch.cuda.synchronize()
    assert pd.dia_spmv.launches == {"gs": 1, "ssor": 2, "chebyshev": 4}[kind]
    assert pd.dia_wdot.launches == pd.dia_dot.launches == 0
    assert _zero_halo(op, z) and bool(torch.isfinite(z).all())
    z_plain = build(_PlainK1(op)).matvec(r)
    scale = float(z_plain.abs().max() + r.abs().max())
    assert float((z - z_plain).abs().max()) <= 64 * EPS[torch.float32] * 12 * scale


@pytest.mark.cuda
def test_cuda_config4_counts_per_iteration(cuda):
    """BiCGStab with the 2-color masked GS on the kernels: K1 once plus once
    per apply (two applies an iteration), K2 twice an iteration; the
    solution agrees with the same solve on the CPU."""
    A, op, masks = _gs_setup(cuda, 12)
    M = tsp.MaskedGSPrecond(A=op, diag=op.diagonal_padded(), masks=masks)
    b = np.random.default_rng(0).standard_normal(A.shape[0]).astype(np.float32)
    pd.reset_launch_counts()
    x2, info = tsp.bicgstab(op, op.pad_vec(torch.as_tensor(b, device=cuda)), M=M, tol=1e-5,
                            max_iter=400)
    torch.cuda.synchronize()
    n = info.iterations
    assert info.converged and _zero_halo(op, x2)
    assert pd.dia_spmv.launches == 1 + 2 * n and pd.dia_wdot.launches == 2 * n
    assert pd.dia_dot.launches == fused.orth_norm.launches == 0
    x, info_h = tsp.prepare(op, M=M, tol=1e-5, max_iter=400, device=cuda)(b)
    assert info_h.iterations == n and torch.equal(x, op.unpad_vec(x2))
    opc = pd.PaddedDIA.from_dia(A.to_dia(), device="cpu")
    Mc = tsp.MaskedGSPrecond(A=opc, diag=opc.diagonal_padded(),
                             masks=tuple(m.cpu() for m in masks))
    xc, info_c = tsp.prepare(opc, M=Mc, tol=1e-5, max_iter=400, device="cpu")(b)
    assert abs(n - info_c.iterations) <= 3
    assert float(torch.linalg.norm(x.cpu() - xc) / torch.linalg.norm(xc)) < 1e-3


@pytest.mark.cuda
def test_cuda_gauss_seidel_golden_and_relayed_preconditioners(cuda):
    """The exact sweep's golden with the vectors on the card (296 sweeps,
    residual exactly 0), and ILU(0) relayed onto the kernel operator under
    BiCGStab (K1 once, K2 twice an iteration)."""
    G = problems.grid_laplacian_dirichlet((10, 10))
    rhs = np.zeros(100)
    problems.set_boundary_condition(rhs, (10, 10), lambda r, c: float(r + c))
    x, (its, res) = tsp.GaussSeidel.new(G, device=cuda).solve(rhs, max_iter=300, eps=0.0)
    assert x.is_cuda and its == 296 and res == 0.0
    A = problems.poisson3d(10, 10, 10)
    b = np.random.default_rng(5).standard_normal(A.shape[0]).astype(np.float32)
    h = tsp.prepare(A, M="ilu0", tol=1e-5, max_iter=400, device=cuda)
    assert isinstance(h._run.keywords["M"], tsp.RelayedPrecond)
    pd.reset_launch_counts()
    x, info = h(b)
    torch.cuda.synchronize()
    assert info.converged and x.is_cuda
    assert pd.dia_spmv.launches == 1 and pd.dia_wdot.launches == 2 * info.iterations


def _scrambled_band_csr(n=3000, seed=0, symmetric=False):
    """The [-3, 0, 3] band behind a random symmetric permutation, f32."""
    import scipy.sparse as sps

    rng = np.random.default_rng(seed)
    lo = rng.standard_normal(n - 3)
    hi = lo if symmetric else rng.standard_normal(n - 3)
    base = sps.diags([lo, np.full(n, 8.0), hi], [-3, 0, 3], format="csr")
    P = sps.eye(n, format="csr")[rng.permutation(n)]
    S = (P @ base @ P.T).tocsr().astype(np.float32)
    S.sort_indices()
    return S


@pytest.mark.cuda
def test_cuda_flat_view_and_reordered_run_the_kernels(cuda):
    """A HybridDIA's FlatViewOperator core launches K1 once per matvec; a
    Reordered(PaddedDIA) launches K1 per matvec and K3 per matvec_dot, never
    K2 or K4; both agree with the same operators on the CPU."""
    import scipy.sparse as sps

    A = problems.poisson3d(12, 12, 12)
    n = A.shape[0]
    S = sps.csr_matrix((A.data.numpy(), A.indices.numpy(), A.indptr.numpy()), shape=A.shape)
    rng = np.random.default_rng(1)
    r, c = rng.integers(0, n, 20), rng.integers(0, n, 20)
    O = sps.coo_matrix((np.full(40, 0.01, np.float32), (np.r_[r, c], np.r_[c, r])),
                       shape=(n, n))
    csr = tsp.csr_from_scipy((S + O).tocsr().astype(np.float32))
    H = tsp.HybridDIA.from_csr(csr, device=cuda)
    Hc = tsp.HybridDIA.from_csr(csr, device="cpu")
    x = torch.as_tensor(rng.standard_normal(n), dtype=torch.float32)
    pd.reset_launch_counts()
    y = H.matvec(x.to(cuda))
    torch.cuda.synchronize()
    assert pd.dia_spmv.launches == 1 and H.n_outliers > 0
    torch.testing.assert_close(y.cpu(), Hc.matvec(x), rtol=1e-5, atol=1e-5)

    Sb = _scrambled_band_csr(symmetric=True)
    op = tsp.optimize(tsp.csr_from_scipy(Sb), device=cuda)
    assert type(op).__name__ == "Reordered" and isinstance(op.inner, pd.PaddedDIA)
    xb = torch.as_tensor(np.random.default_rng(2).standard_normal(3000), dtype=torch.float32)
    x2 = op.pad_vec(xb.to(cuda))
    pd.reset_launch_counts()
    y2 = op.matvec(x2)
    y3, d = op.matvec_dot(x2)
    torch.cuda.synchronize()
    assert (pd.dia_spmv.launches, pd.dia_dot.launches) == (1, 1)
    assert pd.dia_wdot.launches == fused.orth_norm.launches == 0
    want = Sb.astype(np.float64) @ xb.numpy().astype(np.float64)
    np.testing.assert_allclose(op.unpad_vec(y2).cpu().numpy(), want, rtol=1e-5, atol=1e-5)
    assert torch.equal(y2, y3)


@pytest.mark.cuda
def test_cuda_non_banded_solves_count_their_launches(cuda):
    """solve() on a scrambled band: BiCGStab + Jacobi launches K1 1 + 2·its
    times and K2 never; MINRES on the symmetric twin K3 its + 1 times and K4
    never; both converge."""
    for symmetric, method, M in ((False, "bicgstab", "jacobi"), (True, "minres", None)):
        S = _scrambled_band_csr(symmetric=symmetric)
        b = np.random.default_rng(3).standard_normal(3000).astype(np.float32)
        pd.reset_launch_counts()
        x, info = tsp.solve(tsp.csr_from_scipy(S), b, method=method, M=M, tol=1e-5,
                            max_iter=500, device=cuda)
        torch.cuda.synchronize()
        n = info.iterations
        assert info.converged and x.is_cuda
        res = np.linalg.norm(S.astype(np.float64) @ x.cpu().numpy() - b) / np.linalg.norm(b)
        assert res < 1e-4
        if method == "bicgstab":
            assert pd.dia_spmv.launches == 1 + 2 * n and pd.dia_wdot.launches == 0
        else:
            assert pd.dia_spmv.launches == 1 and pd.dia_dot.launches == n + 1
            assert fused.orth_norm.launches == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.complex64, np.complex128])
def test_cuda_bsr_matches_scipy_with_tf32_allowed(dtype, cuda):
    """BSR and ComplexBSR on the card against scipy's f64/c128 product, with
    TF32 allowed globally: the apply turns it off, so f32/c64 stay within
    1e-5 and f64/c128 within 1e-12."""
    import scipy.sparse as sps

    rng = np.random.default_rng(4)
    S = (sps.random(700, 700, density=0.02, random_state=5, format="csr")
         + sps.eye(700) * 6.0).tocsr()
    if np.dtype(dtype).kind == "c":
        S = sps.csr_matrix((S.data * (1 + 0.5j * rng.standard_normal(S.nnz)), S.indices,
                            S.indptr), shape=S.shape)
    S = S.astype(dtype)
    cls = tsp.ComplexBSR if np.dtype(dtype).kind == "c" else tsp.BSR
    op = cls.from_csr(tsp.csr_from_scipy(S), bs=16, device=cuda)
    x = rng.standard_normal(700) + (1j * rng.standard_normal(700)
                                    if np.dtype(dtype).kind == "c" else 0)
    x = x.astype(dtype)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        y = op.matvec(torch.as_tensor(x, device=cuda)).cpu().numpy()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    want = S.astype(np.complex128) @ x.astype(np.complex128)
    tol = 1e-12 if dtype in (np.float64, np.complex128) else 1e-5
    np.testing.assert_allclose(y, want, rtol=tol, atol=tol * np.abs(want).max())


def _smoke(monkeypatch):
    """``chip_smoke.py``'s module, with phase 13 set to check launch counts
    alone (its 32³ CGS and TFQMR drift, as the JAX package's do)."""
    import importlib
    import os
    import sys

    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    monkeypatch.syspath_prepend(root)
    smoke = importlib.import_module("chip_smoke")
    monkeypatch.setattr(smoke, "STRICT", False)
    return smoke


@pytest.mark.cuda
@pytest.mark.parametrize("phase", ["nonsym", "spd", "mg", "inner", "complex", "refine"])
def test_cuda_phase13_exact_launch_counts_at_32(phase, monkeypatch, cuda):
    """Phase 13's cases (a)-(g) on the card at a 32³ grid, each asserting
    its exact launch counts (GMRES its + cycles + 1, CGS 1 + 2·its, block
    CG its + 1 K1b, batched BiCGStab per column as its single solve, ...)."""
    smoke = _smoke(monkeypatch)
    fn = getattr(smoke, "phase_refine" if phase == "refine" else f"phase_krylov_{phase}")
    fn(cuda, grid=32, timed=False)


@pytest.mark.cuda
def test_cuda_basis_products_ignore_a_global_tf32(cuda):
    """GMRES's basis products and block CG's Gram products run with TF32
    off whatever the global setting: with it on, the count and x are those
    of a run with it off."""
    A = problems.convection_diffusion3d(32, 32, 32, peclet=20.0)
    op = tsp.optimize(A, device=cuda)
    rng = np.random.default_rng(3)
    cols = [op.pad_vec(torch.as_tensor(rng.standard_normal(A.shape[0]), dtype=torch.float32,
                                       device=cuda)) for _ in range(5)]
    b, B = cols[0], torch.stack(cols[1:], dim=1)
    runs = {}
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        for tf32 in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            g = tsp.gmres(op, b, M=op.jacobi_precond(), tol=1e-5, max_iter=500, restart=32)
            k = tsp.block_cg(op, B, tol=1e-5, max_iter=500)
            runs[tf32] = (g, k)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    for (x0, i0), (x1, i1) in zip(runs[False], runs[True]):
        assert int(i0.iterations) == int(i1.iterations) and torch.equal(x0, x1)


def _k1b_operator(storage, grid, cuda):
    """A PaddedDIA of the grid³ Poisson with the given band storage."""
    base = problems.poisson3d(grid, grid, grid).to_dia()
    scale = {"int8": 1.0, "bf16": 2.5, "f32": 1.0 + 1e-3, "f64": 1.0 + 1e-9}[storage]
    dt = np.float64 if storage == "f64" else np.float32
    op = tsp.PaddedDIA.from_dia(DIA(bands=torch.from_numpy(base.bands.numpy().astype(dt) * dt(scale)),
                                    offsets=base.offsets, shape=base.shape), device=cuda)
    want = {"int8": torch.int8, "bf16": torch.bfloat16, "f32": torch.float32,
            "f64": torch.float64}[storage]
    assert op.bands.dtype == want
    return op


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["int8", "bf16", "f32", "f64"])
@pytest.mark.parametrize("m", [1, 5, 12, 16])
def test_cuda_k1b_columns_are_k1_bitwise(storage, m, cuda, monkeypatch):
    """K1b on a 56³ block: each column bitwise K1's on it, halo rows zero
    (a NaN block freed first), the same bits with the card said to have 1
    or 3 SMs (each block of the one wave then walks at least 72 tiles, or
    24), and within 8·eps·(|A|·|x|) of the plain version; one launch per
    call."""
    from sprsolve_tpu_torch.ops import _cuda_build

    op = _k1b_operator(storage, 56, cuda)
    dt, b, o, h = op.vdtype, op.bands, op.offsets, op.h
    rng = np.random.default_rng(m)
    X2 = op.pad_block(torch.as_tensor(rng.standard_normal((op.n, m)), dtype=dt, device=cuda))
    junk = torch.full_like(X2, float("nan"))
    del junk
    before = pd.dia_spmm.launches
    Y = pd.dia_spmm(b, X2, o, h)
    assert pd.dia_spmm.launches == before + 1
    for j in range(m):
        assert torch.equal(Y[:, j], pd.dia_spmv(b, X2[:, j].contiguous(), o, h)), j
    assert not bool(Y[:h].any()) and not bool(Y[h + op.n:].any())
    width = _cuda_build.load().sprsolve_dia_spmm_width(pd._VCODE[dt], m, X2.data_ptr(),
                                                       Y.data_ptr())
    # an SM holds at most 2048 threads: 8 blocks of SPMM_TILE
    assert -(-(op.n_pad * (m // width)) // pd.SPMM_TILE) >= 72 * 8
    for sms in (1, 3):
        monkeypatch.setattr(pd, "_sm_count", lambda index, sms=sms: sms)
        assert torch.equal(pd.dia_spmm(b, X2, o, h), Y), sms
    scale = pd.dia_spmm_plain(b.to(dt).abs(), X2.abs(), o, h)
    err = (Y - pd.dia_spmm_plain(b, X2, o, h)).abs()
    assert bool((err <= 8 * EPS[dt] * scale).all())


@pytest.mark.cuda
def test_cuda_k1b_complex_block_and_flat_view(cuda):
    """A complex block through PaddedDIA.matmat is one K1b launch over its
    interleaved planes, each column bitwise the two-K1 matvec; the flat
    view pads, launches once and unpads."""
    from sprsolve_tpu_torch.multigrid import FlatViewOperator

    op = _k1b_operator("int8", 24, cuda)
    rng = np.random.default_rng(2)
    Z = torch.complex(*(torch.as_tensor(rng.standard_normal((op.n, 4)), dtype=torch.float32,
                                        device=cuda) for _ in range(2)))
    before = pd.dia_spmm.launches
    Y = FlatViewOperator(op=op).matmat(Z)
    assert pd.dia_spmm.launches == before + 1
    for j in range(4):
        assert torch.equal(Y[:, j], op.unpad_vec(op.matvec(op.pad_vec(Z[:, j]))))


def _portable_draws(tag, shape, dtype, device):
    """LOBPCG's refills from numpy, the same on every device."""
    draw = np.random.default_rng(list(tag)).standard_normal(shape)
    return torch.as_tensor(draw).to(dtype).to(device)


@pytest.mark.cuda
def test_cuda_lobpcg_and_shift_invert_match_their_cpu_runs(monkeypatch, cuda):
    """LOBPCG on the 16³ Poisson's PaddedDIA and shift_invert_eigs on the
    12³ one, on the card by default and on the CPU: the same status, the
    counts within max(3, ⌈its/4⌉) and the eigenvalues within tol·|λ|
    (f32 sums differ between the two)."""
    import importlib

    lob = importlib.import_module("sprsolve_tpu_torch.solvers.lobpcg")
    monkeypatch.setattr(lob, "_fresh_directions", _portable_draws)
    A = problems.poisson3d(16, 16, 16)
    X0 = np.random.default_rng(0).standard_normal((A.shape[0], 4)).astype(np.float32)
    runs = {}
    for dev in (cuda, torch.device("cpu")):
        op = tsp.optimize(A, device=dev)
        runs[dev.type] = tsp.lobpcg(op, X0, tol=1e-4, max_iter=200)
    (lg, _, ig), (lc, _, ic) = runs["cuda"], runs["cpu"]
    assert lg.device.type == "cuda" and ig.status == ic.status == 0
    assert abs(ig.iterations - ic.iterations) <= max(3, -(-ic.iterations // 4))
    np.testing.assert_allclose(lg.cpu().numpy(), lc.numpy(), rtol=1e-4)
    B = problems.poisson3d(12, 12, 12)
    kw = dict(tol=1e-4, max_iter=100, inner_max_iter=400)
    lg, Xg, ig = tsp.shift_invert_eigs(B, 2, 1.0, **kw)
    lc, _, ic = tsp.shift_invert_eigs(B, 2, 1.0, device="cpu", **kw)
    assert Xg.device.type == "cuda" and ig.status == ic.status == 0
    assert abs(ig.iterations - ic.iterations) <= max(3, -(-ic.iterations // 4))
    np.testing.assert_allclose(np.sort(lg.cpu().numpy()), np.sort(lc.numpy()), rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["lobpcg", "shift_invert", "rational", "shifted"])
def test_cuda_phase14_exact_launch_counts_at_16(case, monkeypatch, cuda):
    """Phase 14's cases on the card at a 16³ grid with cut budgets, each
    asserting its exact K1b (or K1) launch count."""
    smoke = _smoke(monkeypatch)
    monkeypatch.setattr(smoke, "SI_MAX_ITER", 6)
    monkeypatch.setattr(smoke, "SI_INNER_MAX_ITER", 60)
    fn = getattr(smoke, f"phase_eigen_{case}")
    fn(cuda, grid=16, **({} if case == "shifted" else {"timed": False}))
