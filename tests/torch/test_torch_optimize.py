"""Cross tests of the port's ``optimize()`` and of ``solve()``/``prepare()``
on non-banded matrices, against the JAX package (cases of
``tests/test_optimize.py``).

Routing is compared under the JAX package's cost constants (the
``jax_costs`` fixture); under the port's own table, measured on the H100,
only what does not depend on it is checked: a pattern the JAX package
keeps off ELL stays off it, and the operator computes A·x. Solutions agree
with JAX's to 1e-10 in f64/c128 (solved to tol 1e-13) and 1e-4 in f32/c64;
iteration counts lie within the band of ``tests/test_serial_parity.py:183``,
max(3, ⌈its/4⌉)."""

import importlib
import json
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

import sprsolve_tpu as jsp
import sprsolve_tpu_torch as tsp
from sprsolve_tpu.ops.reordered import Reordered as JReordered
from sprsolve_tpu_torch.ops.reordered import Reordered
from sprsolve_tpu_torch.utils import tuning

topt = importlib.import_module("sprsolve_tpu_torch.ops.optimize")
jopt = importlib.import_module("sprsolve_tpu.ops.optimize")

torch.set_num_threads(2)


@pytest.fixture
def jax_costs(monkeypatch):
    """The port's cost table set to the JAX package's constants."""
    monkeypatch.setattr(topt, "COSTS", {
        "eff_dia": jopt._EFF_XLA_DIA, "eff_bsr": jopt._EFF_BSR,
        "eff_padded_dia": jopt._EFF_PALLAS_DIA, "scatter_bytes_eq": jopt._SCATTER_BYTES_EQ})


def _band(its):
    return max(3, -(-its // 4))


def _scrambled_band(n=240, seed=7):
    """The [-3, 0, 3] band of ``tests/test_optimize.py:46-70`` behind a random
    symmetric permutation."""
    rng = np.random.default_rng(seed)
    base = sps.diags([rng.standard_normal(n - 3), np.full(n, 8.0), rng.standard_normal(n - 3)],
                     [-3, 0, 3], format="csr")
    P = sps.eye(n, format="csr")[rng.permutation(n)]
    return (P @ base @ P.T).tocsr()


def _spiked(nx=24, n_out=60, seed=0):
    """3-D Poisson plus symmetric couplings (``tests/test_hybrid.py:74-91``)."""
    from sprsolve_tpu_torch.utils import problems

    A = problems.poisson3d(nx, nx, nx)
    n = A.shape[0]
    S = sps.csr_matrix((A.data.numpy(), A.indices.numpy(), A.indptr.numpy()), shape=A.shape)
    rng = np.random.default_rng(seed)
    r, c = rng.integers(0, n, n_out), rng.integers(0, n, n_out)
    v = rng.standard_normal(n_out).astype(np.float32) * 0.01
    O = sps.coo_matrix((np.concatenate([v, v]), (np.concatenate([r, c]),
                                                 np.concatenate([c, r]))), shape=(n, n))
    return (S + O.tocsr()).tocsr().astype(np.float32)


def _random300():
    S = sps.random(300, 300, density=0.02, random_state=0, format="csr")
    return (S + sps.eye(300)).tocsr()


def _scrambled_complex_grid(side=16, seed=3):
    """A damped complex-symmetric 2-D operator, A + 0.5i·I, scrambled."""
    T = sps.diags([-np.ones(side - 1), 4 * np.ones(side), -np.ones(side - 1)], [-1, 0, 1])
    S = (sps.kron(T, sps.eye(side)) + 0.5 * sps.kron(sps.eye(side), T)).astype(np.complex128)
    S = (S + 0.5j * sps.eye(side * side)).tocsr()
    p = np.random.default_rng(seed).permutation(side * side)
    return S[p][:, p].tocsr()


FIXTURES = {
    "scrambled_band_f64": (_scrambled_band, np.float64),
    "scrambled_band_f32": (_scrambled_band, np.float32),
    "spiked_poisson_f32": (_spiked, np.float32),
    "random300_f64": (_random300, np.float64),
    "complex_grid_c128": (_scrambled_complex_grid, np.complex128),
    "complex_grid_c64": (_scrambled_complex_grid, np.complex64),
}
LAYOUTS = {   # the class the JAX package routes each to, and its inner class
    "scrambled_band_f64": ("Reordered", "DIA"),
    "scrambled_band_f32": ("Reordered", "PaddedDIA"),
    "spiked_poisson_f32": ("HybridDIA", "HybridDIA"),
    "random300_f64": ("Reordered", "BSR"),
    "complex_grid_c128": ("Reordered", "ComplexBSR"),
    "complex_grid_c64": ("Reordered", "ComplexBSR"),
}
# where the port's route differs from the JAX package's: a banded f64 (c128)
# matrix takes the padded kernels, which the JAX package keeps for f32 (c64)
PORT_LAYOUTS = {**LAYOUTS, "scrambled_band_f64": ("Reordered", "PaddedDIA")}


def _fixture(name):
    make, dtype = FIXTURES[name]
    S = make().astype(dtype)
    S.sort_indices()
    return S


def _names(op):
    inner = op.inner if isinstance(op, (Reordered, JReordered)) else op
    return type(op).__name__, type(inner).__name__


def _apply(op, x: torch.Tensor) -> torch.Tensor:
    return op.unpad_vec(op.matvec(op.pad_vec(x))) if hasattr(op, "pad_vec") else op.matvec(x)


def _check_matvec(op, S, rtol):
    rng = np.random.default_rng(11)
    x = rng.standard_normal(S.shape[0])
    if np.iscomplexobj(S.data):
        x = x + 1j * rng.standard_normal(S.shape[0])
    x = x.astype(S.dtype)
    want = S.astype(np.complex128) @ x.astype(np.complex128)
    got = _apply(op, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("name", list(FIXTURES))
def test_routing_matches_jax(name, jax_costs):
    S = _fixture(name)
    with warnings.catch_warnings():
        warnings.simplefilter("error")   # the ELL warning would fail the test
        op = tsp.optimize(tsp.csr_from_scipy(S), device="cpu")
        jop = jsp.optimize(jsp.csr_from_scipy(S))
    assert _names(op) == PORT_LAYOUTS[name] and _names(jop) == LAYOUTS[name]
    _check_matvec(op, S, 1e-12 if S.dtype.itemsize * (1 + (S.dtype.kind != "c")) >= 16
                  else 2e-5)


@pytest.mark.parametrize("name", list(FIXTURES))
def test_solve_and_prepare_match_jax(name, jax_costs):
    """solve() and prepare() on each non-banded fixture: auto's route with
    Jacobi, the same x as JAX's, counts within the band."""
    S = _fixture(name)
    wide = S.dtype in (np.float64, np.complex128)
    rng = np.random.default_rng(1)
    b = rng.standard_normal(S.shape[0])
    if np.iscomplexobj(S.data):
        b = b + 0.3j * rng.standard_normal(S.shape[0])
    b = b.astype(S.dtype)
    kw = dict(method="auto", M="jacobi", tol=1e-13 if wide else 1e-5, max_iter=3000)
    A, jA = tsp.csr_from_scipy(S), jsp.csr_from_scipy(S)
    x, info = tsp.solve(A, b, device="cpu", **kw)
    xj, info_j = jsp.solve(jA, b, **kw)
    assert info.converged and bool(info_j.converged)
    assert abs(info.iterations - int(info_j.iterations)) <= _band(int(info_j.iterations))
    xj = np.asarray(xj)
    tol = 1e-10 if wide else 1e-4
    np.testing.assert_allclose(x.numpy(), xj, rtol=tol, atol=tol * np.abs(xj).max())
    handle = tsp.prepare(A, device="cpu", **kw)
    assert _names(handle.operator) == PORT_LAYOUTS[name]
    x2, info2 = handle(b)
    assert torch.equal(x, x2) and info2.iterations == info.iterations


def test_reordered_solve_roundtrip():
    """solve() through a Reordered operator: permutations at the boundary
    only, the original order returned (``tests/test_optimize.py:46-70``)."""
    S = _scrambled_band()
    A = tsp.csr_from_scipy(S)
    op = tsp.optimize(A, device="cpu")
    assert isinstance(op, Reordered) and isinstance(op.inner, tsp.PaddedDIA)
    b = np.random.default_rng(7).standard_normal(240)
    x, info = tsp.solve(A, b, M="jacobi", tol=1e-12, max_iter=500, device="cpu")
    info.raise_if_error()
    assert np.linalg.norm(S @ x.numpy() - b) / np.linalg.norm(b) < 1e-10
    # on the flat inner DIA, the relayed flat diagonal is the inner
    # operator's Jacobi, permuted
    op = tsp.optimize(A, prefer_kernels=False, device="cpu")
    assert isinstance(op, Reordered) and isinstance(op.inner, tsp.DIA)
    M = op.relay_diag_precond(tsp.DiagPrecond.new(A.diagonal()))
    torch.testing.assert_close(M.diag_inv, op.jacobi_precond().diag_inv, rtol=0, atol=0)
    torch.testing.assert_close(op.diagonal(), A.diagonal(), rtol=0, atol=0)


def test_reordered_padded_relays_the_diagonal_into_the_inner_layout():
    S = _scrambled_band().astype(np.float32)
    A = tsp.csr_from_scipy(S)
    op = tsp.optimize(A, device="cpu")
    assert isinstance(op.inner, tsp.PaddedDIA) and op.padded_len == op.inner.padded_len
    M = op.relay_diag_precond(tsp.DiagPrecond.new(A.diagonal()))
    J = op.jacobi_precond()
    assert M.diag_inv.shape == (op.inner.padded_len,)
    body = slice(op.inner.h, op.inner.h + op.n)
    torch.testing.assert_close(M.diag_inv[body], J.diag_inv[body], rtol=0, atol=0)
    assert not bool(M.diag_inv[: op.inner.h].any())


def test_optimize_ell_fallback_warns():
    """With every structured route off, ELL with a RuntimeWarning that
    speaks of the card, as the JAX package warns (of its TPU)."""
    S = sps.random(300, 300, density=0.05, random_state=1, format="csr")
    S = (S + sps.eye(300)).astype(np.complex128).tocsr()
    kw = dict(allow_reorder=False, wide_diags=0, allow_bsr=False, allow_hybrid=False)
    with pytest.warns(RuntimeWarning, match="card") as rec:
        op = tsp.optimize(tsp.csr_from_scipy(S), device="cpu", **kw)
    assert not any("TPU" in str(w.message) for w in rec)
    with pytest.warns(RuntimeWarning):
        jop = jsp.optimize(jsp.csr_from_scipy(S), **kw)
    assert isinstance(op, tsp.ELL) and type(jop).__name__ == "ELL"
    _check_matvec(op, S, 1e-12)


def test_optimize_cost_model_weighs_efficiency_not_bytes(jax_costs):
    """129 dense diagonals: wide DIA is byte-cheaper than BSR, but the JAX
    constants weigh it 0.19 against 0.90, so both packages pick BSR."""
    n, hw = 4096, 64
    rng = np.random.default_rng(0)
    diags = [rng.standard_normal(n - abs(k)).astype(np.float32) for k in range(-hw, hw + 1)]
    S = sps.diags(diags, list(range(-hw, hw + 1)), format="csr")
    S = (S + sps.eye(n, format="csr") * 200.0).astype(np.float32).tocsr()
    op = tsp.optimize(tsp.csr_from_scipy(S), device="cpu")
    jop = jsp.optimize(jsp.csr_from_scipy(S))
    assert _names(op) == _names(jop) and _names(op)[1] == "BSR"
    _check_matvec(op, S, 2e-5)


def test_optimize_measure_picks_and_persists(tmp_path, monkeypatch):
    """measure=True times the candidates, persists the winner's label keyed
    by the pattern, and a second call builds it from the cache untimed."""
    monkeypatch.setenv("SPRSOLVE_TUNE_CACHE", str(tmp_path / "autotune.json"))
    n, hw = 1024, 16
    rng = np.random.default_rng(1)
    diags = [rng.standard_normal(n - abs(k)).astype(np.float32) for k in range(-hw, hw + 1)]
    S = sps.diags(diags, list(range(-hw, hw + 1)), format="csr")
    S = (S + sps.eye(n, format="csr") * 100.0).astype(np.float32).tocsr()
    A = tsp.csr_from_scipy(S)
    op = tsp.optimize(A, measure=True, measure_iters=3, device="cpu")
    assert not isinstance(op, tsp.ELL)
    _check_matvec(op, S, 2e-5)
    saved = json.load(open(tmp_path / "autotune.json"))
    (key, ent), = saved.items()
    assert key.startswith("layout|cpu|float32|")
    assert ent["label"].startswith(("dia", "bsr", "hybrid")) and ent["gnnz_s"] > 0

    def no_timing(*args):
        raise AssertionError("a cached layout was timed again")

    monkeypatch.setattr(tuning, "_time_step", no_timing)
    op2 = tsp.optimize(A, measure=True, measure_iters=3, device="cpu")
    assert _names(op2) == _names(op)
    assert json.load(open(tmp_path / "autotune.json")) == saved


def test_optimize_measure_complex(tmp_path, monkeypatch):
    monkeypatch.setenv("SPRSOLVE_TUNE_CACHE", str(tmp_path / "autotune.json"))
    rng = np.random.default_rng(2)
    S = sps.random(400, 400, density=0.03, random_state=2, format="csr")
    S = (S + sps.eye(400)).astype(np.complex64).tocsr()
    S.data = S.data + 0.5j * rng.standard_normal(len(S.data)).astype(np.float32)
    op = tsp.optimize(tsp.csr_from_scipy(S), measure=True, measure_iters=3, device="cpu")
    assert not isinstance(op, tsp.ELL)
    _check_matvec(op, S, 2e-5)


@pytest.mark.parametrize("name", list(FIXTURES))
def test_h100_table_keeps_every_fixture_off_ell(name):
    """Under the port's own constants: no ELL where the JAX package avoids
    it, and the chosen layout computes A·x."""
    S = _fixture(name)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        op = tsp.optimize(tsp.csr_from_scipy(S), device="cpu")
    assert not isinstance(op, tsp.ELL)
    _check_matvec(op, S, 1e-12 if S.dtype.itemsize * (1 + (S.dtype.kind != "c")) >= 16
                  else 2e-5)


def test_ilu0_factors_stay_in_the_original_order():
    """A scrambled tridiagonal whose factors are banded after RCM: the
    port lays them out without reordering, so the apply equals the JAX
    package's with ``allow_reorder=False`` and is a better inverse than the
    JAX default's (which applies a Reordered factor to original-order
    vectors)."""
    n = 400
    rng = np.random.default_rng(0)
    base = sps.diags([-np.ones(n - 1), np.full(n, 4.0) + rng.random(n), -np.ones(n - 1)],
                     [-1, 0, 1], format="csr")
    P = sps.eye(n, format="csr")[rng.permutation(n)]
    S = (P @ base @ P.T).tocsr()
    S.sort_indices()
    A, jA = tsp.csr_from_scipy(S), jsp.csr_from_scipy(S)
    M = tsp.ILU0Precond.from_csr(A)
    assert not isinstance(M.L_s, Reordered) and not isinstance(M.U_s, Reordered)
    Mj = jsp.ILU0Precond.from_csr(jA, allow_reorder=False)
    Mj_default = jsp.ILU0Precond.from_csr(jA)
    x = rng.standard_normal(n)
    y = M.matvec(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, np.asarray(Mj.matvec(jnp.asarray(x))), rtol=1e-12,
                               atol=1e-14)
    y_default = np.asarray(Mj_default.matvec(jnp.asarray(x)))
    assert np.abs(S @ y - x).max() < np.abs(S @ y_default - x).max()


def test_cs_minres_jacobi_through_reordered_matches_jax(jax_costs):
    """M="jacobi" under cs_minres builds the real 1/|d| from the inner,
    permuted diagonal of a Reordered operator."""
    S = _fixture("complex_grid_c128")
    A, jA = tsp.csr_from_scipy(S), jsp.csr_from_scipy(S)
    rng = np.random.default_rng(4)
    b = rng.standard_normal(S.shape[0]) + 0.25j * rng.standard_normal(S.shape[0])
    kw = dict(method="cs_minres", M="jacobi", tol=1e-13, max_iter=2000)
    handle = tsp.prepare(A, device="cpu", **kw)
    assert isinstance(handle.operator, Reordered)
    M = handle._run.keywords["M"]
    d = np.abs(S.diagonal())[handle.operator.perm.numpy()]
    np.testing.assert_allclose(M.diag_inv.numpy(), 1.0 / d, rtol=1e-15)
    x, info = handle(b)
    xj, info_j = jsp.solve(jA, b, **kw)
    assert info.converged and bool(info_j.converged)
    assert abs(info.iterations - int(info_j.iterations)) <= _band(int(info_j.iterations))
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-10, atol=1e-10)
