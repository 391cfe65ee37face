"""Cross tests of the port's ComplexPaddedDIA and kernels K5-K7 against the
JAX package's ComplexPaddedDIA (Pallas in interpret mode on the CPU, as
``tests/conftest.py`` arranges), with the state carried across by
``interop``; the complex128 set against the JAX package's XLA DIA path,
since its Pallas kernels stop at complex64 (``pallas_spmv.py:22-23``).

On the CPU the port's wrappers run their plain PyTorch versions
(``tests/torch/test_torch_cuda.py`` holds the CUDA kernels against them).

Tolerances, by plane dtype (eps = 2⁻²³ for f32, 2⁻⁵² for f64):
- y: |Δ| ≤ 8·eps·((|A_re| + |A_im|)·(|u_re| + |u_im|)) per row and
  component — a row sums at most 7 products per plane, and either side may
  fuse a multiply-add;
- the dots: |Δ| ≤ 1e-5 (c64) or 1e-12 (c128) · Σ|w||y| — per-block
  partials against one sum, in other orders."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sprsolve_tpu.ops.pallas_spmv as jps
from sprsolve_tpu.precond import DiagPrecond as JDiagPrecond
from sprsolve_tpu.sparse.containers import DIA as JDIA
from sprsolve_tpu.utils import problems as jprob
from sprsolve_tpu_torch.interop import (complex_diag_precond_from_reference,
                                        complex_padded_dia_from_reference,
                                        vec_from_reference)
from sprsolve_tpu_torch.ops import padded_dia as pd
from sprsolve_tpu_torch.precond import ComplexDiagPrecond, DiagPrecond
from sprsolve_tpu_torch.sparse.containers import DIA as TDIA

torch.set_num_threads(2)

EPS = {torch.float32: 2.0 ** -23, torch.float64: 2.0 ** -52}
DOT_RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}


def _bandsets():
    """name → (JAX DIA, port DIA) of the same complex values on the 8³
    Poisson's pattern."""
    base = jprob.poisson3d(8, 8, 8).to_dia()
    bands = np.asarray(base.bands).astype(np.complex128)
    ctr = base.offsets.index(0)
    damped = bands.copy()
    damped[ctr] += 0.5j
    rng = np.random.default_rng(21)
    rand = np.where(bands != 0, rng.uniform(0.5, 1.5, bands.shape)
                    + 1j * rng.uniform(-1.0, 1.0, bands.shape), 0)
    out = {}
    for name, vals, dt in (("damped", damped, np.complex64),
                           ("scaled", bands * (1 + 0.5j), np.complex64),
                           ("random_c64", rand, np.complex64),
                           ("random_c128", rand, np.complex128)):
        vals = vals.astype(dt)
        out[name] = (JDIA(bands=jnp.asarray(vals), offsets=base.offsets, shape=base.shape),
                     TDIA(bands=torch.from_numpy(vals), offsets=base.offsets,
                          shape=base.shape))
    return out


BANDSETS = _bandsets()
C64_SETS = ["damped", "scaled", "random_c64"]
STORAGE = {"damped": ("int8", "bfloat16"), "scaled": ("int8", "bfloat16"),
           "random_c64": ("float32", "float32"), "random_c128": ("float64", "float64")}


def _pair(name):
    jd, td = BANDSETS[name]
    pj = jps.ComplexPaddedDIA.from_dia(jd, lanes=128, block_rows=8)
    pt = complex_padded_dia_from_reference(
        np.asarray(pj.re.bands3), np.asarray(pj.im.bands3), pj.re.offsets, pj.n,
        pj.hr, pj.shape, pj.re.vdtype)
    return pj, pt


def _vec(pt, seed, pj=None):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(pt.n) + 1j * rng.standard_normal(pt.n)).astype(
        np.complex64 if pt.dtype == torch.complex64 else np.complex128)
    xt = pt.pad_vec(torch.from_numpy(x))
    return (xt,) if pj is None else (pj.pad_vec(jnp.asarray(x)), xt)


def _scale(pt, u):
    rdt = pt.re.vdtype
    absb = pt.re.bands.to(rdt).abs() + pt.im.bands.to(rdt).abs()
    return pd.dia_spmv_plain(absb, u.real.abs() + u.imag.abs(), pt.offsets, pt.h)


def _y_close(pt, got, want_flat, u):
    """got: port padded y; want_flat: the reference y, flat (n,)."""
    bound = 8 * EPS[pt.re.vdtype] * pt.unpad_vec(_scale(pt, u))
    diff = pt.unpad_vec(got) - want_flat
    assert bool((diff.real.abs() <= bound).all()) and bool((diff.imag.abs() <= bound).all())
    # halo and tail stay exactly zero
    assert not bool(got[: pt.h].any()) and not bool(got[pt.h + pt.n:].any())


def _dot_close(pt, got, want, scale):
    assert abs(complex(got) - complex(want)) <= DOT_RTOL[pt.re.vdtype] * float(scale)


@pytest.mark.parametrize("name", sorted(BANDSETS))
def test_planes_narrow_on_their_own_as_jax(name):
    jd, td = BANDSETS[name]
    own = pd.ComplexPaddedDIA.from_dia(td)
    got = tuple(str(p.bands.dtype).replace("torch.", "") for p in (own.re, own.im))
    assert got == STORAGE[name]
    assert own.dtype == td.dtype and own.re.offsets == own.im.offsets
    assert (own.re.h, own.re.n_pad) == (own.im.h, own.im.n_pad)
    # a complex DIA handed to PaddedDIA goes to the two-plane class
    assert isinstance(pd.PaddedDIA.from_dia(td), pd.ComplexPaddedDIA)
    if name != "random_c128":
        pj, pt = _pair(name)
        assert tuple(str(np.asarray(p.bands3).dtype) for p in (pj.re, pj.im)) == STORAGE[name]
        assert torch.equal(own.re.bands, pt.re.bands) and torch.equal(own.im.bands, pt.im.bands)
        assert (own.h, own.n_pad) == (pt.h, pt.n_pad)
    wide = pd.ComplexPaddedDIA.from_dia(td, narrow=False)
    assert wide.re.bands.dtype == wide.im.bands.dtype == own.re.vdtype


@pytest.mark.parametrize("name", C64_SETS)
def test_k5_k6_match_jax(name):
    """matvec (K5), matvec_dot (K6) and matvec_conj_dot (K6, conj_x)."""
    pj, pt = _pair(name)
    xj, xt = _vec(pt, 1, pj)
    y = pt.matvec(xt)
    _y_close(pt, y, vec_from_reference(pj.matvec(xj), pj.n, pj.hr), xt)
    for conj in (False, True):
        fn_t = pt.matvec_conj_dot if conj else pt.matvec_dot
        fn_j = pj.matvec_conj_dot if conj else pj.matvec_dot
        y, d = fn_t(xt)
        yj, dj = fn_j(xj)
        _y_close(pt, y, vec_from_reference(yj, pj.n, pj.hr), xt)
        _dot_close(pt, d, dj, (xt.abs() * y.abs()).sum())
    # the conjugate fold: A·conj(x) and its Saunders α, against the composed form
    y, d = pt.matvec_conj_dot(xt)
    y2 = pt.matvec(torch.conj_physical(xt))
    _y_close(pt, y, pt.unpad_vec(y2), xt)
    _dot_close(pt, d, torch.sum(xt.conj() * y2), (xt.abs() * y.abs()).sum())


@pytest.mark.parametrize("w_is_x", [False, True])
@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("name", C64_SETS)
def test_k7_matches_jax(name, fold, w_is_x):
    """matvec_wdot (w given, and w is x) and matvec_wdot_cprec (K7 with the
    complex Jacobi folded in)."""
    pj, pt = _pair(name)
    xj, xt = _vec(pt, 2, pj)
    wj, wt = (xj, xt) if w_is_x else _vec(pt, 3, pj)
    if fold:
        Mj, Mt = pj.jacobi_precond(), pt.jacobi_precond()
        yj, wdj, ydj = pj.matvec_wdot_cprec(xj, wj, Mj.inv_re, Mj.inv_im)
        y, wd, yd = pt.matvec_wdot_cprec(xt, wt, Mt.diag_inv)
        u = xt * Mt.diag_inv
    else:
        yj, wdj, ydj = pj.matvec_wdot(xj, wj)
        y, wd, yd = pt.matvec_wdot(xt, wt)
        u = xt
    _y_close(pt, y, vec_from_reference(yj, pj.n, pj.hr), u)
    _dot_close(pt, wd, wdj, (wt.abs() * y.abs()).sum())
    _dot_close(pt, yd, ydj, abs(complex(ydj)))
    assert yd.dtype == pt.dtype and float(yd.imag) == 0.0
    # w = None reads the raw x, under the fold too
    dinv = pt.jacobi_precond().diag_inv if fold else None
    y2, wd2, yd2 = pd.dia_complex_wdot_plain(pt.re.bands, pt.im.bands, xt, wt.clone(), dinv,
                                             pt.offsets, pt.h)
    assert torch.equal(y, y2) and torch.equal(wd, wd2) and torch.equal(yd, yd2)


@pytest.mark.parametrize("name", sorted(BANDSETS))
def test_plain_k6_k7_y_are_k5s_bitwise(name):
    """The identities the CUDA kernels are held to on the card, here on the
    plain versions: K6's y is K5's, K6 with ``conj_x`` is K5 on conj(x) bit
    for bit (negation is exact in every product and sum, and ir − ri equals
    (−ri) + ir), and K7's y without the fold is K5's."""
    pt = pd.ComplexPaddedDIA.from_dia(BANDSETS[name][1])
    x, = _vec(pt, 8)
    w, = _vec(pt, 9)
    p, o, h = (pt.re.bands, pt.im.bands), pt.offsets, pt.h
    k5 = lambda v: pd.dia_complex_spmv_plain(*p, v, o, h)
    assert torch.equal(pd.dia_complex_dot_plain(*p, x, o, h)[0], k5(x))
    xc = torch.conj_physical(x)
    assert torch.equal(pd.dia_complex_dot_plain(*p, x, o, h, conj_x=True)[0], k5(xc))
    assert torch.equal(pt.matvec_conj_dot(x)[0], pt.matvec(xc))
    for wv in (w, None):
        assert torch.equal(pd.dia_complex_wdot_plain(*p, x, wv, None, o, h)[0], k5(x))


def test_c128_matches_the_jax_xla_path():
    """The c128 planes against the JAX package's XLA DIA matvec (its Pallas
    kernels stop at complex64), every method."""
    jd, td = BANDSETS["random_c128"]
    pt = pd.ComplexPaddedDIA.from_dia(td)
    xt, = _vec(pt, 4)
    wt, = _vec(pt, 5)
    x, w = pt.unpad_vec(xt).numpy(), pt.unpad_vec(wt).numpy()
    mv = lambda v: np.asarray(jd.matvec(jnp.asarray(v)))
    y_ref, yc_ref = mv(x), mv(np.conj(x))
    t = lambda a: torch.from_numpy(np.array(a))
    _y_close(pt, pt.matvec(xt), t(y_ref), xt)
    y, d = pt.matvec_dot(xt)
    _y_close(pt, y, t(y_ref), xt)
    _dot_close(pt, d, np.vdot(x, y_ref), np.abs(x) @ np.abs(y_ref))
    y, d = pt.matvec_conj_dot(xt)
    _y_close(pt, y, t(yc_ref), xt)
    _dot_close(pt, d, np.vdot(x, yc_ref), np.abs(x) @ np.abs(yc_ref))
    M = pt.jacobi_precond()
    u = pt.unpad_vec(M.diag_inv).numpy() * x
    yu = mv(u)
    y, wd, yd = pt.matvec_wdot_cprec(xt, wt, M.diag_inv)
    _y_close(pt, y, t(yu), xt * M.diag_inv)
    _dot_close(pt, wd, np.vdot(w, yu), np.abs(w) @ np.abs(yu))
    _dot_close(pt, yd, np.vdot(yu, yu), np.vdot(yu, yu).real)
    y, wd, yd = pt.matvec_wdot(xt, xt)
    _dot_close(pt, wd, np.vdot(x, y_ref), np.abs(x) @ np.abs(y_ref))


@pytest.mark.parametrize("name", ["damped", "random_c64"])
def test_jacobi_and_relay_match_jax(name):
    pj, pt = _pair(name)
    Mj, Mt = pj.jacobi_precond(), pt.jacobi_precond()
    assert isinstance(Mt, ComplexDiagPrecond) and Mt.diag_inv.dtype == torch.complex64
    want = torch.complex(vec_from_reference(Mj.inv_re, pj.n, pj.hr),
                         vec_from_reference(Mj.inv_im, pj.n, pj.hr))
    torch.testing.assert_close(pt.unpad_vec(Mt.diag_inv), want, rtol=1e-6, atol=0)
    # pad and halo slots: reciprocal forced to 1 + 0i (pallas_spmv.py:992-1007)
    pads = torch.cat([Mt.diag_inv[: pt.h], Mt.diag_inv[pt.h + pt.n:]])
    assert bool((pads == 1).all())
    carried = complex_diag_precond_from_reference(Mj.inv_re, Mj.inv_im, pt, pj.hr)
    torch.testing.assert_close(carried.diag_inv, Mt.diag_inv, rtol=1e-6, atol=0)
    # relay: a complex diagonal → ComplexDiagPrecond, a real one → DiagPrecond
    # (a real diagonal on a complex system), zero pads
    d = BANDSETS[name][1].bands[BANDSETS[name][1].offsets.index(0)]
    for diag, cls, dt in ((d, ComplexDiagPrecond, torch.complex64),
                          (d.real.contiguous(), DiagPrecond, torch.float32)):
        R = pt.relay_diag_precond(DiagPrecond.new(diag))
        Rj = pj.relay_diag_precond(JDiagPrecond.new(jnp.asarray(diag.numpy())))
        assert type(R) is cls and R.diag_inv.dtype == dt
        if cls is DiagPrecond:
            want = vec_from_reference(Rj.diag_inv, pj.n, pj.hr)
        else:
            want = torch.complex(vec_from_reference(Rj.inv_re, pj.n, pj.hr),
                                 vec_from_reference(Rj.inv_im, pj.n, pj.hr))
        torch.testing.assert_close(pt.unpad_vec(R.diag_inv), want.to(dt), rtol=1e-6, atol=0)
        assert not bool(R.diag_inv[: pt.h].any()) and not bool(R.diag_inv[pt.h + pt.n:].any())


def test_complex_wrappers_validate_inputs():
    pt = pd.ComplexPaddedDIA.from_dia(BANDSETS["damped"][1])
    x, = _vec(pt, 6)
    bre, bim, o, h = pt.re.bands, pt.im.bands, pt.offsets, pt.h
    with pytest.raises(TypeError, match="do not serve"):
        pd.dia_complex_spmv(bre, bim, x.to(torch.complex128), o, h)
    with pytest.raises(TypeError, match="complex64 or complex128"):
        pd.dia_complex_spmv(bre, bim, x.real.contiguous(), o, h)
    with pytest.raises(ValueError, match="one shape"):
        pd.dia_complex_spmv(bre, bim[:, :-256], x, o, h)
    with pytest.raises(ValueError, match="conjugated"):
        pd.dia_complex_dot(bre, bim, torch.conj(x), o, h)
    with pytest.raises(ValueError, match="layout"):
        pd.dia_complex_wdot(bre, bim, x, None, x.to(torch.complex128), o, h)
    with pytest.raises(ValueError, match="halo"):
        pd.dia_complex_wdot(bre, bim, x, None, None, o, h // 4)
    meta = torch.empty(x.shape, dtype=x.dtype, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        pd.dia_complex_spmv(bre.to("meta"), bim.to("meta"), meta, o, h)


def test_cpu_path_counts_no_launch_and_reset_covers_k5_k7():
    pt = pd.ComplexPaddedDIA.from_dia(BANDSETS["scaled"][1])
    x, = _vec(pt, 7)
    pd.reset_launch_counts()
    pt.matvec(x)
    pt.matvec_dot(x)
    pt.matvec_conj_dot(x)
    pt.matvec_wdot(x, x)
    pt.matvec_wdot_cprec(x, x, pt.jacobi_precond().diag_inv)
    assert pd.dia_complex_spmv.launches == pd.dia_complex_dot.launches == 0
    assert pd.dia_complex_wdot.launches == 0
    pd.dia_complex_spmv.launches = pd.dia_complex_dot.launches = 2
    pd.dia_complex_wdot.launches = 5
    pd.reset_launch_counts()
    assert pd.dia_complex_spmv.launches == pd.dia_complex_dot.launches == 0
    assert pd.dia_complex_wdot.launches == 0


def test_complex_pad_unpad_round_trip_and_layout():
    pt = pd.ComplexPaddedDIA.from_dia(BANDSETS["random_c64"][1])
    x = torch.complex(torch.arange(1.0, pt.n + 1), -torch.arange(1.0, pt.n + 1))
    x2 = pt.pad_vec(x)
    assert x2.shape == (pt.padded_len,) and x2.dtype == torch.complex64
    assert torch.equal(pt.unpad_vec(x2), x) and x2.sum() == x.sum()
    assert pt.shape == (pt.n, pt.n) and pt.n_pad % pd.ROW_TILE == 0
    assert (pt.h * 8) % 16 == 0   # the body starts 16-byte aligned
    d = pt.diagonal_padded()
    assert d.dtype == torch.complex64 and torch.equal(
        pt.unpad_vec(d), BANDSETS["random_c64"][1].bands[3])
