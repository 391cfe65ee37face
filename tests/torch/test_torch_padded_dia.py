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


# K1's edge layouts that BANDSETS does not reach: n_pad = 256 (one row tile),
# a halo wider than K1's 1024-row tile, and odd offsets beyond its 128-row
# staged window, in f32 (int8-exact and random values) and f64
EDGE_LAYOUTS = {   # name → (offsets, n, vector dtype, int8-exact values)
    "n_pad256": ((-1, 0, 1), 200, np.float32, False),
    "h_beyond_tile": ((-1100, -1, 0, 1, 1100), 2304, np.float32, True),
    "far_odd_f64": ((-1301, -129, 0, 131, 1299), 1792, np.float64, False),
}


@pytest.mark.parametrize("name", sorted(EDGE_LAYOUTS))
def test_k1_plain_edge_layouts_match_jax(name):
    """The plain K1 at the layouts above against the JAX package's padded
    matvec (Pallas, interpret mode) on the same bands and x; y within the
    y tolerance, halo and tail exactly zero."""
    offsets, n, dt, exact = EDGE_LAYOUTS[name]
    rng = np.random.default_rng(11)
    vals = (rng.integers(-3, 4, (len(offsets), n)) if exact
            else rng.uniform(0.5, 1.5, (len(offsets), n))).astype(dt)
    jd = JDIA(bands=jnp.asarray(vals), offsets=offsets, shape=(n, n))
    pj = jps.PaddedDIA.from_dia(jd, lanes=128, block_rows=8)
    pt = padded_dia_from_reference(np.asarray(pj.bands3), pj.offsets, pj.n, pj.hr,
                                   pj.shape, pj.vdtype)
    assert (pt.n_pad == 256) == (name == "n_pad256")
    assert pt.h > 1024 or name != "h_beyond_tile"
    xj, xt = _vec(pj, pt, 2)
    _y_close(pt, pt.matvec(xt), pj.matvec(xj), pj, xt)


# (grid, values, vector dtype) → whether K1 streams its bands on an H100
# (50 MiB of L2): a call's bytes are the bands, x and y
K1_HINTS = {
    "int8_100": (100, "poisson", torch.float32, False),      # 15 MB
    "f32_bands_100": (100, "random", torch.float32, False),  # 36 MB
    "f64_100": (100, "random", torch.float64, True),         # 72 MB
    "f64_64": (64, "random", torch.float64, False),          # 19 MB
}


@pytest.mark.parametrize("name", sorted(K1_HINTS))
def test_k1_streams_its_bands_only_where_a_call_exceeds_l2(name):
    """K1's band loads carry the streaming hint exactly where the bytes of
    one call exceed the L2: at the shapes timed on the H100, only the f64
    100³ Poisson."""
    grid, values, dt, streamed = K1_HINTS[name]
    dia = TDIA.from_csr(tprob.poisson3d(grid, grid, grid), device="cpu")
    if values == "random":
        rng = np.random.default_rng(3)
        dia = TDIA(bands=torch.where(dia.bands != 0, torch.as_tensor(
            rng.uniform(0.5, 1.5, tuple(dia.bands.shape))), 0.0).to(dt),
            offsets=dia.offsets, shape=dia.shape)
    op = pd.PaddedDIA.from_dia(dia, device="cpu")
    assert op.vdtype == dt and (op.bands.dtype == torch.int8) == (values == "poisson")
    call = op.bands.nbytes + 2 * op.padded_len * op.bands.new_empty((), dtype=dt).element_size()
    assert pd.stream_bands(call, 50 << 20) == streamed


@pytest.mark.parametrize("grid,quads", [(64, False), (81, False), (82, True), (100, True)])
def test_k1_walks_4_row_tiles_only_where_they_fill_half_an_h100(grid, quads):
    """K1 takes its tiles of 4 rows a thread where those threads fill at
    least half of an H100's 132 × 2048 thread slots (n_pad ≥ 540,672),
    and one thread per row below: the 64³ Poisson (262,144 rows) ran
    faster so on the card."""
    n_pad = pd.PaddedDIA.from_dia(TDIA.from_csr(tprob.poisson3d(grid, grid, grid),
                                                device="cpu"), device="cpu").n_pad
    assert pd.k1_by_quads(n_pad, 132) == quads


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
    # over the body rows, as the kernel sums it
    body = slice(pt.h, pt.h + pt.n_pad)
    assert float(d) == float(torch.sum((xt * pd.dia_spmv(pt.bands, xt, pt.offsets, pt.h))[body]))


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
    v2, s2 = fused.orth_norm_plain(at, ot, vt, c(beta), c(alpha), pt.h)
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


def _cvec(pj, pt, seed, dtype=np.complex64):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(pt.n) + 1j * rng.standard_normal(pt.n)).astype(dtype)
    return pj.pad_vec(jnp.asarray(x)), pt.pad_vec(torch.from_numpy(x))


def _planes_close(pt, got, want_j, pj, u):
    """A complex y of a real operator, plane by plane: y_re from u_re, y_im
    from u_im."""
    _y_close(pt, got.real.contiguous(), np.real(np.asarray(want_j)), pj, u.real)
    _y_close(pt, got.imag.contiguous(), np.imag(np.asarray(want_j)), pj, u.imag)


@pytest.mark.parametrize("name", ["poisson8", "random10"])
def test_real_padded_dia_takes_complex_vectors(name):
    """A real PaddedDIA times a complex vector runs K1 on each plane, and
    matvec_dot/matvec_wdot/matvec_wdot_prec compose it with separate dots,
    as the JAX package does (pallas_spmv.py:682-751)."""
    pj, pt, _ = _pair(name)
    (xj, xt), (wj, wt) = _cvec(pj, pt, 12), _cvec(pj, pt, 13)
    pd.reset_launch_counts()
    y = pt.matvec(xt)
    assert y.dtype == torch.complex64
    _planes_close(pt, y, pj.matvec(xj), pj, xt)
    assert torch.equal(y, torch.complex(pt.matvec(xt.real.contiguous()),
                                        pt.matvec(xt.imag.contiguous())))
    scale = float((xt.abs() * y.abs()).sum())
    y2, d = pt.matvec_dot(xt)
    yj2, dj = pj.matvec_dot(xj)
    assert torch.equal(y2, y) and abs(complex(d) - complex(dj)) <= 1e-5 * scale
    dinv = pt.jacobi_precond().diag_inv
    for fold in (False, True):
        if fold:
            got = pt.matvec_wdot_prec(xt, wt, dinv)
            want = pj.matvec_wdot_prec(xj, wj, pj.jacobi_precond().diag_inv)
            u = xt * dinv
        else:
            got, want, u = pt.matvec_wdot(xt, wt), pj.matvec_wdot(xj, wj), xt
        _planes_close(pt, got[0], want[0], pj, u)
        ws = float((wt.abs() * got[0].abs()).sum())
        assert abs(complex(got[1]) - complex(want[1])) <= 1e-5 * ws
        assert abs(complex(got[2]) - complex(want[2])) <= 1e-5 * abs(complex(want[2]))
    # on the CPU every plane takes the plain version: no launch
    assert pd.dia_spmv.launches == pd.dia_wdot.launches == pd.dia_dot.launches == 0


def test_slice2_and_complex_entry_points_name_their_roadmap_item():
    """The slice-2 entry points run on real vectors. Their complex forms run
    since slice 3 (see test_real_padded_dia_takes_complex_vectors), but the
    fused Lanczos step stays real-only, as in the JAX package."""
    pt = pd.PaddedDIA.from_dia(tprob.poisson3d(4, 4, 4).to_dia())
    x = pt.pad_vec(torch.ones(pt.n))
    y, d = pt.matvec_dot(x)
    assert torch.equal(y, pt.matvec(x)) and float(d) == float(torch.sum(x * y))
    vn, ss = pt.orth_norm(x, x, x, 0.0, 1.0)
    assert not bool(vn.any()) and float(ss) == 0.0
    xc = x.to(torch.complex64)
    with pytest.raises(TypeError, match="real vectors"):
        pt.orth_norm(xc, xc, xc, 0.0, 1.0)


def test_persistent_grid_is_one_block_per_tile_in_one_wave():
    """K2/K3 launch one block per tile of DOT_TILE rows, at most one wave:
    8 blocks per SM in f32, 4 in f64."""
    assert pd.DOT_TILE == 4 * pd.ROW_TILE
    assert pd.persistent_grid(pd.ROW_TILE, torch.float32, 132) == 1
    assert pd.persistent_grid(1_000_192, torch.float32, 132) == 977   # 100³ Poisson
    assert pd.persistent_grid(1_000_192, torch.float64, 132) == 528
    assert pd.persistent_grid(4_000_000, torch.float32, 132) == 1056
    assert pd.persistent_grid(4096, torch.float32, 0) == 1


def test_dot_scratch_is_kept_per_device_and_stream_and_grows(monkeypatch):
    """The dot kernels' scratch: the ticket, then three f64 partials per
    K6/K7 tile of 512 rows (which also holds K2/K3's two per 1024-row tile);
    zeroed once per (device, stream) and made again only to grow."""
    monkeypatch.setattr(pd, "_dot_scratch", {})
    cpu = torch.device("cpu")
    a = pd.dot_scratch(cpu, 1, 1_000_192)           # the 100³ Poisson
    assert a.dtype == torch.uint8 and a.shape == (pd.DOT_SCRATCH_HEAD + 24 * 1954,)
    assert not bool(a.any())                        # the ticket starts at 0
    assert pd.dot_scratch(cpu, 1, 1_000_192) is a
    assert pd.dot_scratch(cpu, 1, pd.ROW_TILE) is a
    assert pd.dot_scratch(cpu, 2, pd.ROW_TILE) is not a
    b = pd.dot_scratch(cpu, 1, 2_000_128)           # a larger operator: it grows
    assert b.numel() == pd.DOT_SCRATCH_HEAD + 24 * 3907 and not bool(b.any())
    assert pd.dot_scratch(cpu, 1, pd.ROW_TILE) is b
    assert len(pd._dot_scratch) == 2


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_complex_grid_and_scratch_at_the_100_cubed_shapes(dtype, monkeypatch):
    """K6/K7 on the damped 100³ Poisson (n_pad 1,000,192): 1954 tiles of
    COMPLEX_DOT_TILE rows, walked by one wave of blocks on 132 SMs; the
    scratch holds each kernel's partials, K7's three per tile in f64 too."""
    assert pd.COMPLEX_DOT_TILE == 2 * pd.ROW_TILE
    n_pad, tiles, sms = 1_000_192, 1954, 132
    assert pd.persistent_grid(n_pad, dtype, sms) == pd.DOT_BLOCKS_PER_SM[dtype] * sms
    assert pd.DOT_BLOCKS_PER_SM[dtype] * sms < tiles
    assert pd.persistent_grid(pd.ROW_TILE, dtype, sms) == 1
    assert pd.persistent_grid(n_pad, dtype, 0) == 1
    monkeypatch.setattr(pd, "_dot_scratch", {})
    buf = pd.dot_scratch(torch.device("cpu"), 1, n_pad)
    real_bytes = dtype.to_real().itemsize
    assert buf.numel() >= pd.DOT_SCRATCH_HEAD + 3 * tiles * real_bytes
    assert buf.numel() >= pd.DOT_SCRATCH_HEAD + 2 * 977 * 8   # K2/K3 in f64


@pytest.mark.parametrize("n_pad, h, dtype", [
    (256 * 3, 4, torch.float32),            # one ragged tile
    (256 * 9, 2000, torch.float32),         # halo wider than a tile
    (256 * 5, 0, torch.float64),            # no halo
    (1_000_192, 10_000, torch.float32),     # the 100³ Poisson: 977 tiles
    (1_000_192, 10_000, torch.float64),
])
def test_k4_grid_and_scratch_share(n_pad, h, dtype, monkeypatch):
    """K4 walks DOT_TILE-row tiles (the last ragged where n_pad is 256·odd)
    with K2/K3's one wave of blocks, and its one partial per tile fits the
    per-stream scratch behind the ticket; the 1M-row layouts on one SM's
    grid make each block walk at least 72 tiles."""
    tiles = -(-n_pad // pd.DOT_TILE)
    grid = pd.persistent_grid(n_pad, dtype, 132)
    assert grid == min(tiles, pd.DOT_BLOCKS_PER_SM[dtype] * 132)
    assert h <= n_pad and (h * dtype.itemsize) % 16 == 0
    if n_pad > 500_000:
        assert tiles // pd.persistent_grid(n_pad, dtype, 1) >= 72
    monkeypatch.setattr(pd, "_dot_scratch", {})
    buf = pd.dot_scratch(torch.device("cpu"), 1, n_pad)
    assert buf.numel() >= pd.DOT_SCRATCH_HEAD + tiles * dtype.itemsize


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k4_bound_counts_the_body_reads_and_the_whole_write(dtype):
    """chip_smoke.py's K4 bound counts what the kernel moves: the body rows
    of a, v_old and v read (never their zero halos) and all of v₊ written,
    at the 100³ Poisson's layout 16,083,072 bytes in f32."""
    import importlib
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    smoke = importlib.import_module("chip_smoke")
    h, n_pad = pd.layout(100 ** 3, (-100 * 100, 100 * 100), dtype.itemsize)
    a = torch.zeros(n_pad + 2 * h, dtype=dtype)
    assert (n_pad, h) == (1_000_192, 10_000)
    assert smoke.orth_norm_bytes(a, h) == (4 * n_pad + 2 * h) * dtype.itemsize
    assert smoke.orth_norm_bytes(a, h) == 16_083_072 * dtype.itemsize // 4
    assert smoke.orth_norm_bytes(a, 0) == smoke.nbytes(a, a, a, a)


def test_k4_source_constants_match_the_wrapper():
    """fused.cu stands alone: its tile, scratch head and blocks per SM are
    the ones the wrapper sizes the grid and the scratch with."""
    import re
    from pathlib import Path

    src = (Path(fused.__file__).resolve().parent.parent / "csrc" / "fused.cu").read_text()
    define = lambda name: re.search(rf"#define {name} \(?([^)/\n]+)", src).group(1).strip()
    assert int(define("K4_THREADS")) == pd.DOT_TILE // 4
    assert define("K4_TILE") == "4 * K4_THREADS"
    assert int(define("SCRATCH_HEAD")) == pd.DOT_SCRATCH_HEAD
    assert "sizeof(V) == 4 ? 8 : 4" in src
    assert (pd.DOT_BLOCKS_PER_SM[torch.float32], pd.DOT_BLOCKS_PER_SM[torch.float64]) == (8, 4)


def test_launch_constants_are_built_once_per_operator():
    codes, offs = pd._launch_consts((1, -1, 100), torch.float32, (torch.int8,))
    assert codes == (0, 2) and list(offs) == [1, -1, 100]
    assert pd._launch_consts((1, -1, 100), torch.float32, (torch.int8,))[1] is offs
    codes, _ = pd._launch_consts((0,), torch.complex128, (torch.float64, torch.float64))
    assert codes == (1, 0, 0)
    assert list(pd._launch_consts((), torch.float64, (torch.float64,))[1]) == [0]


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
