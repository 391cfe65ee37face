"""Cross tests of the port's PaddedDIA and kernels K1-K4 against the JAX
package's Pallas kernels (interpret mode on the CPU, as the session
fixture in ``tests/conftest.py`` arranges).

On the CPU the port's wrappers run their plain PyTorch versions
(``tests/torch/test_torch_cuda.py`` holds the CUDA kernels against them on a
GPU).  Both packages compute from the same data:
the port's operator is re-laid from the JAX operator's bands with
``interop.padded_dia_from_reference``.

Tolerances, by vector dtype (eps = 2⁻²³ for f32, 2⁻⁵² for f64):
- y: |Δ| ≤ 8·eps·(|A|·|x|) per row — a row sums at most 7 products, and
  either side may fuse a multiply-add;
- w·y, y·y, xᵀy: |Δ| ≤ 1e-5 (f32) or 1e-12 (f64) · Σ|w·y| — the kernels
  sum per-block partials, the plain version one sum, in other orders;
- K4's v₊: |Δ| ≤ 1e-6 (f32) or 1e-13 (f64) · (|a| + |β||v_old| + |α||v|)
  per entry (either side may fuse a multiply-add), and Σv₊² within the dot
  tolerance of itself."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sprsolve_tpu.ops.pallas_spmv as jps
from sprsolve_tpu.sparse.containers import DIA as JDIA
from sprsolve_tpu.utils import problems as jprob
from sprsolve_tpu_torch.interop import padded_dia_from_reference, vec_from_reference
from sprsolve_tpu_torch.ops import _cuda_build
from sprsolve_tpu_torch.ops import fused
from sprsolve_tpu_torch.ops import padded_dia as pd
from sprsolve_tpu_torch.sparse.containers import DIA as TDIA
from sprsolve_tpu_torch.utils import problems as tprob

torch.set_num_threads(2)

EPS = {torch.float32: 2.0 ** -23, torch.float64: 2.0 ** -52}
DOT_RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}
ORTH_RTOL = {torch.float32: 1e-6, torch.float64: 1e-13}


def _bandsets():
    """name → (JAX DIA, port DIA) of the same values."""
    out = {}
    for name, (tA, jA) in {
        "poisson8": (tprob.poisson3d(8, 8, 8), jprob.poisson3d(8, 8, 8)),
        "poisson16": (tprob.poisson3d(16, 16, 16), jprob.poisson3d(16, 16, 16)),
        "grid20_f64": (tprob.grid_laplacian_dirichlet((20, 20)),
                       jprob.grid_laplacian_dirichlet((20, 20))),
        "poisson10_f64": (tprob.poisson3d(10, 10, 10, dtype=np.float64),
                          jprob.poisson3d(10, 10, 10, dtype=np.float64)),
    }.items():
        out[name] = (jA.to_dia(), tA.to_dia())
    base = jprob.poisson3d(10, 10, 10).to_dia()
    bands = np.asarray(base.bands)
    rng = np.random.default_rng(7)
    for name, vals in (
        ("random10", np.where(bands != 0, rng.uniform(0.5, 1.5, bands.shape), 0)),
        ("bf16x2.5", bands * 2.5),
    ):
        vals = vals.astype(np.float32)
        out[name] = (JDIA(bands=jnp.asarray(vals), offsets=base.offsets, shape=base.shape),
                     TDIA(bands=torch.from_numpy(vals), offsets=base.offsets,
                          shape=base.shape))
    return out


BANDSETS = _bandsets()
STORAGE = {"poisson8": "int8", "poisson16": "int8", "grid20_f64": "float64",
           "poisson10_f64": "float64", "random10": "float32", "bf16x2.5": "bfloat16"}
# K3/K4 cases: the f64 Poisson of tests/test_pallas_spmv.py:58-98, an f32
# Poisson (int8 bands) and a random band set that does not narrow
K3K4_SETS = ["poisson10_f64", "poisson8", "random10"]


def _pair(name):
    jd, td = BANDSETS[name]
    pj = jps.PaddedDIA.from_dia(jd, lanes=128, block_rows=8)
    pt = padded_dia_from_reference(np.asarray(pj.bands3), pj.offsets, pj.n, pj.hr,
                                   pj.shape, pj.vdtype)
    return pj, pt, td


def _vec(pj, pt, seed):
    x = np.random.default_rng(seed).standard_normal(pt.n).astype(pj.vdtype)
    return pj.pad_vec(jnp.asarray(x)), pt.pad_vec(torch.from_numpy(x))


def _y_close(pt, got, want_j, pj, u):
    """got: port padded y; want_j: JAX padded y; u: the port's SpMV input."""
    want = vec_from_reference(want_j, pj.n, pj.hr)
    scale = pd.dia_spmv_plain(pt.bands.to(pt.vdtype).abs(), u.abs(), pt.offsets, pt.h)
    diff = (pt.unpad_vec(got) - want).abs()
    assert bool((diff <= 8 * EPS[pt.vdtype] * pt.unpad_vec(scale)).all())
    # halo and tail stay exactly zero
    assert not bool(got[: pt.h].any()) and not bool(got[pt.h + pt.n:].any())


@pytest.mark.parametrize("name", sorted(BANDSETS))
def test_narrow_tier_and_layout_match_jax(name):
    pj, pt, td = _pair(name)
    assert str(np.asarray(pj.bands3).dtype) == STORAGE[name]
    own = pd.PaddedDIA.from_dia(td)
    assert str(own.bands.dtype).replace("torch.", "") == STORAGE[name]
    assert own.bands.dtype == pt.bands.dtype and own.offsets == pt.offsets
    assert (own.h, own.n_pad) == (pt.h, pt.n_pad)
    assert own.h >= max(abs(o) for o in own.offsets)
    assert (own.h * own.vdtype.itemsize) % 16 == 0   # the body starts 16-byte aligned
    assert torch.equal(own.bands, pt.bands)
    wide = pd.PaddedDIA.from_dia(td, narrow=False)
    assert wide.bands.dtype == own.vdtype
    assert torch.equal(wide.bands, own.bands.to(own.vdtype))


@pytest.mark.parametrize("name", sorted(BANDSETS))
def test_k1_plain_matches_jax_matvec(name):
    pj, pt, _ = _pair(name)
    xj, xt = _vec(pj, pt, 1)
    y = pt.matvec(xt)
    _y_close(pt, y, pj.matvec(xj), pj, xt)
    # narrow storage gives bitwise the output of the same values stored wide
    assert torch.equal(y, pd.dia_spmv(pt.bands.to(pt.vdtype), xt, pt.offsets, pt.h))


@pytest.mark.parametrize("w_is_x", [False, True])
@pytest.mark.parametrize("has_dinv", [False, True])
@pytest.mark.parametrize("name", sorted(BANDSETS))
def test_k2_plain_matches_jax_wdot(name, has_dinv, w_is_x):
    pj, pt, _ = _pair(name)
    xj, xt = _vec(pj, pt, 2)
    wj, wt = (xj, xt) if w_is_x else _vec(pj, pt, 3)
    if has_dinv:
        Mj, Mt = pj.jacobi_precond(), pt.jacobi_precond()
        yj, wdj, ydj = pj.matvec_wdot_prec(xj, wj, Mj.diag_inv)
        y, wd, yd = pt.matvec_wdot_prec(xt, wt, Mt.diag_inv)
        u = xt * Mt.diag_inv
    else:
        yj, wdj, ydj = pj.matvec_wdot(xj, wj)
        y, wd, yd = pt.matvec_wdot(xt, wt)
        u = xt
    _y_close(pt, y, yj, pj, u)
    scale = float((wt * y).abs().sum())
    assert abs(float(wd) - float(wdj)) <= DOT_RTOL[pt.vdtype] * scale
    assert abs(float(yd) - float(ydj)) <= DOT_RTOL[pt.vdtype] * float(ydj)
    # the w = x form reads the raw x, also under the Jacobi fold
    y2, wd2, yd2 = pd.dia_wdot_plain(pt.bands, xt, wt.clone(),
                                     Mt.diag_inv if has_dinv else None,
                                     pt.offsets, pt.h)
    assert torch.equal(y, y2) and torch.equal(yd, yd2)
    assert float(wd) == float(wd2)


@pytest.mark.parametrize("name", K3K4_SETS)
def test_k3_plain_matches_jax_matvec_dot(name):
    pj, pt, _ = _pair(name)
    xj, xt = _vec(pj, pt, 4)
    yj, dj = pj.matvec_dot(xj)
    y, d = pt.matvec_dot(xt)
    _y_close(pt, y, yj, pj, xt)
    scale = float((xt * y).abs().sum())
    assert abs(float(d) - float(dj)) <= DOT_RTOL[pt.vdtype] * scale
    # the dot reads the raw SpMV input, and narrow storage is exact
    y2, d2 = pd.dia_dot(pt.bands.to(pt.vdtype), xt, pt.offsets, pt.h)
    assert torch.equal(y, y2) and float(d) == float(d2)
    assert float(d) == float(torch.sum(xt * pd.dia_spmv(pt.bands, xt, pt.offsets, pt.h)))


@pytest.mark.parametrize("coef", ["tensor", "float"])
@pytest.mark.parametrize("name", K3K4_SETS)
def test_k4_plain_matches_jax_orth_norm(name, coef):
    pj, pt, _ = _pair(name)
    (aj, at), (oj, ot), (vj, vt) = (_vec(pj, pt, s) for s in (5, 6, 7))
    beta, alpha = 0.7, -1.3
    vnj, sj = pj.orth_norm(aj, oj, vj, jnp.asarray(beta), jnp.asarray(alpha))
    if coef == "tensor":
        # MINRES passes 0-d tensors; β as f64 is cast to the vector dtype
        bt, al = torch.tensor(beta, dtype=torch.float64), torch.tensor(alpha, dtype=pt.vdtype)
    else:
        bt, al = beta, alpha
    vn, ss = pt.orth_norm(at, ot, vt, bt, al)
    want = vec_from_reference(vnj, pj.n, pj.hr)
    scale = at.abs() + abs(beta) * ot.abs() + abs(alpha) * vt.abs()
    diff = (pt.unpad_vec(vn) - want).abs()
    assert bool((diff <= ORTH_RTOL[pt.vdtype] * pt.unpad_vec(scale)).all())
    assert abs(float(ss) - float(sj)) <= DOT_RTOL[pt.vdtype] * float(sj)
    assert not bool(vn[: pt.h].any()) and not bool(vn[pt.h + pt.n:].any())
    assert vn.dtype == pt.vdtype and ss.dtype == pt.vdtype
    c = lambda v: torch.tensor(v, dtype=pt.vdtype)
    v2, s2 = fused.orth_norm_plain(at, ot, vt, c(beta), c(alpha))
    assert torch.equal(vn, v2) and float(ss) == float(s2)


def test_k4_wrapper_validates_inputs():
    pt = pd.PaddedDIA.from_dia(tprob.poisson3d(6, 6, 6).to_dia())
    x = pt.pad_vec(torch.ones(pt.n))
    with pytest.raises(ValueError, match="layout"):
        fused.orth_norm(x, x[:-1], x, 1.0, 1.0, pt.h)
    with pytest.raises(ValueError, match="layout"):
        fused.orth_norm(x, x.double(), x, 1.0, 1.0, pt.h)
    with pytest.raises(ValueError, match="multiple"):
        fused.orth_norm(x[:-2], x[:-2], x[:-2], 1.0, 1.0, pt.h)
    with pytest.raises(TypeError, match="float32 or float64"):
        fused.orth_norm(x.half(), x.half(), x.half(), 1.0, 1.0, pt.h)
    with pytest.raises(ValueError, match="contiguous"):
        fused.orth_norm(x, torch.ones(2 * x.numel())[::2], x, 1.0, 1.0, pt.h)
    meta = torch.empty(x.shape, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fused.orth_norm(meta, meta, meta, 1.0, 1.0, pt.h)


@pytest.mark.parametrize("name", ["poisson8", "grid20_f64", "random10"])
def test_jacobi_and_relay_match_jax(name):
    pj, pt, td = _pair(name)
    dj = vec_from_reference(pj.jacobi_precond().diag_inv, pj.n, pj.hr)
    M = pt.jacobi_precond()
    assert M.diag_inv.dtype == pt.vdtype
    assert torch.equal(pt.unpad_vec(M.diag_inv), dj)
    # pad coordinates: reciprocal forced to 1 (pallas_spmv.py:783-790)
    assert bool((M.diag_inv[: pt.h] == 1).all()) and bool((M.diag_inv[pt.h + pt.n:] == 1).all())
    from sprsolve_tpu_torch.precond import DiagPrecond

    R = pt.relay_diag_precond(DiagPrecond.new(td.diagonal()))
    assert torch.equal(pt.unpad_vec(R.diag_inv), dj)
    assert not bool(R.diag_inv[: pt.h].any()) and not bool(R.diag_inv[pt.h + pt.n:].any())


def test_pad_unpad_round_trip_and_zero_pads():
    pt = pd.PaddedDIA.from_dia(tprob.poisson3d(5, 6, 7).to_dia())
    x = torch.arange(1.0, pt.n + 1)
    x2 = pt.pad_vec(x)
    assert x2.shape == (pt.padded_len,) and torch.equal(pt.unpad_vec(x2), x)
    assert x2.sum() == x.sum()
    assert pt.n_pad % pd.ROW_TILE == 0


def test_wrappers_validate_inputs():
    pt = pd.PaddedDIA.from_dia(tprob.poisson3d(6, 6, 6).to_dia())
    x = pt.pad_vec(torch.ones(pt.n))
    with pytest.raises(TypeError, match="do not serve"):
        pd.dia_spmv(pt.bands, x.double(), pt.offsets, pt.h)
    with pytest.raises(ValueError, match="layout"):
        pd.dia_spmv(pt.bands, x[:-1], pt.offsets, pt.h)
    with pytest.raises(ValueError, match="offsets"):
        pd.dia_spmv(pt.bands, x, pt.offsets[:-1], pt.h)
    with pytest.raises(ValueError, match="halo"):
        pd.dia_wdot(pt.bands, x, None, None, pt.offsets, pt.h // 4)
    with pytest.raises(ValueError, match="contiguous"):
        pd.dia_wdot(pt.bands, x, torch.ones(2 * x.numel())[::2], None, pt.offsets, pt.h)
    meta = torch.empty(x.shape, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        pd.dia_spmv(pt.bands.to("meta"), meta, pt.offsets, pt.h)


def test_cpu_path_counts_no_launch():
    pt = pd.PaddedDIA.from_dia(tprob.poisson3d(6, 6, 6).to_dia())
    x = pt.pad_vec(torch.ones(pt.n))
    pd.reset_launch_counts()
    pt.matvec(x)
    pt.matvec_wdot(x, x)
    pt.matvec_dot(x)
    pt.orth_norm(x, x, x, 0.5, 0.25)
    assert pd.dia_spmv.launches == 0 and pd.dia_wdot.launches == 0
    assert pd.dia_dot.launches == 0 and fused.orth_norm.launches == 0
    fused.orth_norm.launches = pd.dia_dot.launches = 3
    pd.reset_launch_counts()
    assert fused.orth_norm.launches == 0 and pd.dia_dot.launches == 0


def test_slice2_and_complex_entry_points_name_their_roadmap_item():
    """The slice-2 entry points run; their complex forms name slice 3."""
    pt = pd.PaddedDIA.from_dia(tprob.poisson3d(4, 4, 4).to_dia())
    x = pt.pad_vec(torch.ones(pt.n))
    y, d = pt.matvec_dot(x)
    assert torch.equal(y, pt.matvec(x)) and float(d) == float(torch.sum(x * y))
    vn, ss = pt.orth_norm(x, x, x, 0.0, 1.0)
    assert not bool(vn.any()) and float(ss) == 0.0
    xc = x.to(torch.complex64)
    for call in (lambda: pt.matvec(xc), lambda: pt.matvec_dot(xc),
                 lambda: pt.orth_norm(xc, xc, xc, 0.0, 1.0)):
        with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
            call()


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    import shutil

    import torch.utils.cpp_extension as ext

    monkeypatch.setattr(ext, "CUDA_HOME", None)
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setattr(_cuda_build, "build_dir", lambda: tmp_path)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _cuda_build.build()
    assert not any(tmp_path.iterdir())
    # the library's name follows the sources and flags
    name = _cuda_build.library_path().name
    monkeypatch.setattr(_cuda_build, "NVCC_FLAGS", _cuda_build.NVCC_FLAGS + ("-lineinfo",))
    assert _cuda_build.library_path().name != name
