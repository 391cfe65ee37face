"""Cross tests of the port's rational-filter eigensolver against the JAX
package's (mirrors ``tests/test_rational_filter.py``; the FGMRES-inner
shift-invert case lives in ``test_torch_shift_invert.py``): interior pairs
against dense ``eigh``, an explicit radius and the |λ − σ| order, the side
filter, the f32 path, an empty disc, the error paths, ``inner_refine``
(c64 sweeps with c128 residuals on an f64 DIA) and ``inner_dtype``, and
the radius fault of ``sprsolve_tpu/solvers/rational.py:486`` that the port
does not copy.

The filter's draws are numpy's on both sides, so the subspace iterations
stay in step: eigenvalues agree with JAX's and dense ``eigh`` within tol,
status is equal, and the total inner COCG count (summed over columns and
nodes) lies within the band of ``test_serial_parity.py:183``
(max(3, ⌈its/4⌉)): the lockstep COCG sums in another order than XLA."""

import dataclasses
import importlib

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import sprsolve_tpu as jsp
from sprsolve_tpu.utils import problems as jprob
import sprsolve_tpu_torch as tsp
from sprsolve_tpu_torch.errors import IncompatibleMatrixFormat, Status
from sprsolve_tpu_torch.utils import problems as tprob

torch.set_num_threads(2)
trat = importlib.import_module("sprsolve_tpu_torch.solvers.rational")


def _band(its):
    return max(3, -(-its // 4))


def _spd_grid(side=24, dtype=np.float64):
    A, _ = jprob.sym_grid_laplacian((side, side))
    A = dataclasses.replace(A, data=(-np.asarray(A.data)).astype(dtype))
    tA = tsp.CSR.from_arrays(np.asarray(A.data), np.asarray(A.indices), np.asarray(A.indptr),
                             A.shape)
    return tA, A


def _dense_eigs(A):
    S = sps.csr_matrix((np.asarray(A.data, np.float64), np.asarray(A.indices),
                        np.asarray(A.indptr)), shape=A.shape)
    return np.linalg.eigvalsh(S.toarray()), S


def _agree(out, outj, atol):
    lam, _, info = out
    lamj, _, infoj = outj
    assert info.status == int(infoj.status)
    its_j = int(infoj.iterations)
    assert abs(info.iterations - its_j) <= _band(its_j), (info.iterations, its_j)
    np.testing.assert_allclose(np.sort(lam.numpy()), np.sort(np.asarray(lamj)), atol=atol)


def test_interior_pairs_match_dense_and_jax():
    tA, jA = _spd_grid(24)
    w, S = _dense_eigs(jA)
    sigma = 2.0
    out = tsp.rational_filter_eigs(tA, 4, sigma, tol=1e-8, seed=1, device="cpu")
    outj = jsp.rational_filter_eigs(jA, 4, sigma, tol=1e-8, seed=1)
    lam, X, info = out
    assert info.status == Status.CONVERGED and float(info.residual) <= 1e-8
    _agree(out, outj, 1e-9)
    want = np.sort(w[np.argsort(np.abs(w - sigma))[:4]])
    np.testing.assert_allclose(np.sort(lam.numpy()), want, atol=1e-9)
    Xn = X.numpy()
    assert np.abs(S @ Xn - Xn * lam.numpy()[None, :]).max() < 1e-7


def test_explicit_radius_and_ordering():
    tA, jA = _spd_grid(16)
    w, _ = _dense_eigs(jA)
    sigma = 3.0
    gaps = np.sort(np.abs(w - sigma))
    i = next(j for j in range(3, len(gaps) - 1) if gaps[j + 1] - gaps[j] > 1e-3)
    radius = float(0.5 * (gaps[i] + gaps[i + 1]))
    kw = dict(radius=radius, m0=max(8, i + 4), tol=1e-8, seed=0)
    out = tsp.rational_filter_eigs(tA, 3, sigma, device="cpu", **kw)
    outj = jsp.rational_filter_eigs(jA, 3, sigma, **kw)
    assert out[2].status == Status.CONVERGED
    _agree(out, outj, 1e-9)
    d = np.abs(out[0].numpy() - sigma)
    assert np.all(np.diff(d) >= -1e-12)
    np.testing.assert_allclose(np.sort(d), gaps[:3], atol=1e-9)


@pytest.mark.parametrize("side", ["above", "below"])
def test_side_filter(side):
    tA, jA = _spd_grid(16)
    w, _ = _dense_eigs(jA)
    sigma = 3.0
    out = tsp.rational_filter_eigs(tA, 2, sigma, side=side, tol=1e-8, seed=0, device="cpu")
    outj = jsp.rational_filter_eigs(jA, 2, sigma, side=side, tol=1e-8, seed=0)
    assert out[2].status == Status.CONVERGED
    _agree(out, outj, 1e-9)
    lam = out[0].numpy()
    if side == "above":
        assert np.all(lam >= sigma)
        want = np.sort(w[w >= sigma])[:2]
    else:
        assert np.all(lam < sigma)
        want = np.sort(w[w < sigma])[-2:]
    np.testing.assert_allclose(np.sort(lam), want, atol=1e-9)


def test_f32_path_runs_k1b():
    """The f32 CSR lays out as a PaddedDIA: each node's lockstep COCG
    applies both planes of the block in one K1b (plain on the CPU)."""
    tA, jA = _spd_grid(16, np.float32)
    w, _ = _dense_eigs(jA)
    sigma = 2.5
    kw = dict(tol=5e-4, inner_tol=1e-6, seed=2)
    from sprsolve_tpu_torch.ops import padded_dia as pd

    calls = []
    spmm = pd.dia_spmm
    orig = pd.dia_spmm
    pd.dia_spmm = lambda *a, **k: calls.append(a[1].shape[1]) or spmm(*a, **k)
    try:
        out = tsp.rational_filter_eigs(tA, 2, sigma, device="cpu", **kw)
    finally:
        pd.dia_spmm = orig
    # the JAX side on its CSR: its padded layout would run Pallas in
    # interpret mode, minutes on the CPU for the same numbers
    outj = jsp.rational_filter_eigs(jA, 2, sigma, optimize_layout=False, **kw)
    assert out[2].status == Status.CONVERGED and out[0].dtype == torch.float32
    m0 = max(2 * 2, 2 + 6)
    assert set(calls) == {2 * m0, m0}     # the planes of a node block; the Ritz block
    _agree(out, outj, 5e-3)
    want = np.sort(w[np.argsort(np.abs(w - sigma))[:2]])
    np.testing.assert_allclose(np.sort(out[0].numpy()), want, atol=5e-3)


def test_empty_disc_reports_insufficient():
    tA, jA = _spd_grid(12)
    w, _ = _dense_eigs(jA)
    sigma = 3.0
    gap = np.abs(w - sigma).min()
    kw = dict(radius=float(gap * 0.3), tol=1e-8, max_iter=2, seed=0)
    out = tsp.rational_filter_eigs(tA, 2, sigma, device="cpu", **kw)
    outj = jsp.rational_filter_eigs(jA, 2, sigma, **kw)
    assert out[2].status == Status.INSUFFICIENT_ITER == int(outj[2].status)
    assert abs(out[2].iterations - int(outj[2].iterations)) <= _band(int(outj[2].iterations))


def test_rejects_complex_and_bad_args():
    A, _, _ = tprob.complex_symmetric_grid_with_diag((8, 8))
    with pytest.raises(IncompatibleMatrixFormat):
        tsp.rational_filter_eigs(A, 2, 1.0, device="cpu")
    tA, _ = _spd_grid(8)
    with pytest.raises(IncompatibleMatrixFormat):
        tsp.rational_filter_eigs(tA, 0, 1.0, device="cpu")
    with pytest.raises(IncompatibleMatrixFormat):
        tsp.rational_filter_eigs(tA, 2, 1.0, side="nope", device="cpu")
    with pytest.raises(IncompatibleMatrixFormat):
        tsp.rational_filter_eigs(tA, 4, 1.0, m0=2, device="cpu")
    with pytest.raises(IncompatibleMatrixFormat, match="radius="):
        tsp.rational_filter_eigs(tA.to_dia(), 2, 1.0)
    with pytest.raises(IncompatibleMatrixFormat, match="inner_refine"):
        tsp.rational_filter_eigs(tA.to_dia(), 2, 1.0, radius=0.1, inner_refine=1)


def test_inner_refine_and_inner_dtype():
    """``inner_refine=1`` on the f32 grid (c64 sweeps, c128 residuals on an
    f64 DIA, the quadrature summed in f64) and ``inner_dtype="float64"``
    (the filter rebuilt as an f64 DIA) against the JAX package's."""
    tA, jA = _spd_grid(12, np.float32)
    w, _ = _dense_eigs(jA)
    sigma = 2.5
    want = np.sort(w[np.argsort(np.abs(w - sigma))[:2]])
    kw = dict(tol=1e-4, inner_tol=1e-4, seed=3, inner_refine=1)
    out = tsp.rational_filter_eigs(tA, 2, sigma, device="cpu", **kw)
    outj = jsp.rational_filter_eigs(jA, 2, sigma, optimize_layout=False, **kw)
    assert out[2].status == Status.CONVERGED
    # the gate is the relative residual: λ within tol·|λ| of the dense one
    _agree(out, outj, 1e-4 * sigma)
    np.testing.assert_allclose(np.sort(out[0].numpy()), want, atol=1e-4 * sigma)
    kw = dict(tol=1e-9, seed=3, inner_dtype="float64")
    out = tsp.rational_filter_eigs(tA, 2, sigma, device="cpu", **kw)
    outj = jsp.rational_filter_eigs(jA, 2, sigma, **kw)
    assert out[2].status == Status.CONVERGED and out[0].dtype == torch.float64
    _agree(out, outj, 1e-9)
    np.testing.assert_allclose(np.sort(out[0].numpy()), want, atol=1e-9)


def test_final_filter_uses_the_radius_of_the_kept_pairs(monkeypatch, capsys):
    """The radius fault (ROADMAP Queue 3): with ``max_iter=1`` the first
    pass at r₀ = 1e-3 of the Gershgorin width finds no Ritz value inside
    the disc, so the calibration grows the radius and the loop ends. The
    kept pairs are that pass's: the port filters them with r₀ and returns
    none, although a converged Ritz pair sits just outside r₀ (which a
    filter with the grown radius would return)."""
    monkeypatch.setattr(trat, "_RF_DEBUG", True)
    seen = []
    select = trat._select_nearest
    monkeypatch.setattr(trat, "_select_nearest",
                        lambda lam, rel, *a: seen.append((lam, rel)) or select(lam, rel, *a))
    tA, jA = _spd_grid(24)
    sigma, tol = 1.0, 1e-8
    lo, hi = tsp.gershgorin_bounds(tA)
    r0 = (hi - lo) * 1e-3
    lam, X, info = tsp.rational_filter_eigs(tA, 4, sigma, tol=tol, seed=1, max_iter=1,
                                            device="cpu")
    line = capsys.readouterr().err.split("rf: ")[1:]
    assert len(line) == 1 and f"r={r0:.3e}" in line[0] and "n_in=0" in line[0]
    assert info.status == Status.INSUFFICIENT_ITER and lam.numel() == 0
    assert len(seen) == 1 and seen[0][0].size == 0
    w, S = _dense_eigs(jA)
    near = w[np.argmin(np.abs(w - sigma))]
    assert r0 < abs(near - sigma) < 20 * r0     # outside r₀, inside the grown disc
    assert "0.99118" in line[0]                  # and the pass found it, converged
