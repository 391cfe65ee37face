"""Cross tests of the port's LOBPCG against the JAX package's (mirrors
``tests/test_lobpcg.py``; ``scipy_compat`` is held in
``test_torch_scipy_compat.py``): the dense-eigh oracle, the largest pairs, Chebyshev
preconditioning, a complex Hermitian block, the status at a short budget,
the 3k < n guard, the padded layout on the plain K1b, the guard buffer and
its clamp, and the multigrid preconditioner.

JAX's ``jax.random`` draws (the initial P and the refills of degenerate
columns) cannot be reproduced in torch, so the ``jax_draws`` fixture
patches the port's ``_fresh_directions`` with the JAX package's draws: the
counts must then be equal where the two stay in step, and within the band
of ``test_serial_parity.py:183`` (max(3, ⌈its/4⌉)) otherwise. Eigenvalues
agree with JAX's and with dense ``eigh`` within the solver's tol; status is
equal. Every case runs in f64 on the CPU unless it says f32."""

import functools
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sprsolve_tpu as jsp
from sprsolve_tpu.utils import problems as jprob
import sprsolve_tpu_torch as tsp
from sprsolve_tpu_torch.errors import IncompatibleMatrixFormat, Status
from sprsolve_tpu_torch.ops import padded_dia as pd
from sprsolve_tpu_torch.utils import problems as tprob

torch.set_num_threads(2)
tlob = importlib.import_module("sprsolve_tpu_torch.solvers.lobpcg")


def _band(its):
    return max(3, -(-its // 4))


@functools.lru_cache(maxsize=None)
def _jax_draw(shape, rdt, depth):
    def draw(tag):
        key = jax.random.key(0)
        for i in range(depth):
            key = jax.random.fold_in(key, tag[i])
        return jax.random.normal(key, shape, dtype=rdt)

    return jax.jit(draw)


def jax_fresh_directions(tag, shape, dtype, device):
    """The JAX package's draw for ``tag``: ``fold_in`` of ``key(0)`` by each
    entry (``sprsolve_tpu/solvers/lobpcg.py:232-266``)."""
    rdt = jnp.float32 if dtype in (torch.float32, torch.complex64) else jnp.float64
    draw = np.array(_jax_draw(tuple(shape), rdt, len(tag))(jnp.asarray(tag, jnp.uint32)))
    return torch.as_tensor(draw).to(dtype).to(device)


@pytest.fixture
def jax_draws(monkeypatch):
    monkeypatch.setattr(tlob, "_fresh_directions", jax_fresh_directions)


def _spd_poisson(side=16):
    Aj, _ = jprob.sym_grid_laplacian((side, side))
    dense = -np.asarray(Aj.todense())
    return tsp.csr_from_dense(dense), jsp.csr_from_dense(dense), dense


def _agree(out, outj, tol_lam, exact_count=True):
    lam, X, info = out
    lamj, _, infoj = outj
    assert info.status == int(infoj.status)
    its, its_j = info.iterations, int(infoj.iterations)
    if exact_count:
        assert its == its_j, (its, its_j)
    else:
        assert abs(its - its_j) <= _band(its_j), (its, its_j)
    np.testing.assert_allclose(lam.numpy(), np.asarray(lamj), rtol=0, atol=tol_lam)


def test_smallest_pairs_match_dense_eigh_and_jax(jax_draws):
    tA, jA, dense = _spd_poisson()
    ev = np.linalg.eigvalsh(dense)
    X0 = np.random.default_rng(0).standard_normal((256, 4))
    out = tsp.lobpcg(tA, torch.as_tensor(X0), tol=1e-9, max_iter=400)
    outj = jsp.lobpcg(jA, jnp.asarray(X0), tol=1e-9, max_iter=400)
    out[2].raise_if_error()
    # a 124-iteration run: the QR and eigh of another LAPACK round apart
    # and the count lands one over JAX's 123
    _agree(out, outj, 1e-7, exact_count=False)
    lam, X, _ = out
    np.testing.assert_allclose(lam.numpy(), ev[:4], atol=1e-7)
    Xn = X.numpy()
    R = dense @ Xn - Xn * lam.numpy()[None, :]
    assert np.linalg.norm(R, axis=0).max() < 1e-6
    np.testing.assert_allclose(Xn.T @ Xn, np.eye(4), atol=1e-8)


def test_largest_pairs(jax_draws):
    tA, jA, dense = _spd_poisson()
    ev = np.linalg.eigvalsh(dense)
    X0 = np.random.default_rng(1).standard_normal((256, 3))
    out = tsp.lobpcg(tA, torch.as_tensor(X0), largest=True, tol=1e-9, max_iter=400)
    outj = jsp.lobpcg(jA, jnp.asarray(X0), largest=True, tol=1e-9, max_iter=400)
    out[2].raise_if_error()
    _agree(out, outj, 1e-7, exact_count=False)   # 104 against JAX's 103
    np.testing.assert_allclose(out[0].numpy(), ev[-3:], atol=1e-7)


def test_preconditioning_accelerates(jax_draws):
    tA, jA, dense = _spd_poisson()
    X0 = np.random.default_rng(2).standard_normal((256, 4))
    _, _, info_0 = tsp.lobpcg(tA.to_dia(), torch.as_tensor(X0), tol=1e-8, max_iter=400)
    M = tsp.ChebyshevPrecond.auto(tA.to_dia(), degree=8)
    out = tsp.lobpcg(tA.to_dia(), torch.as_tensor(X0), M=M, tol=1e-8, max_iter=400)
    Mj = jsp.ChebyshevPrecond.auto(jA.to_dia(), degree=8)
    outj = jsp.lobpcg(jA.to_dia(), jnp.asarray(X0), M=Mj, tol=1e-8, max_iter=400)
    out[2].raise_if_error()
    assert out[2].iterations < info_0.iterations // 2
    _agree(out, outj, 1e-6)
    np.testing.assert_allclose(out[0].numpy(), np.linalg.eigvalsh(dense)[:4], atol=1e-6)


def test_complex_hermitian(jax_draws):
    rng = np.random.default_rng(3)
    n = 80
    h = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    dense = (h + h.conj().T) / 2
    X0 = rng.standard_normal((n, 3)) + 1j * rng.standard_normal((n, 3))
    out = tsp.lobpcg(tsp.csr_from_dense(dense), torch.as_tensor(X0), tol=1e-9, max_iter=600)
    outj = jsp.lobpcg(jsp.csr_from_dense(dense), jnp.asarray(X0), tol=1e-9, max_iter=600)
    out[2].raise_if_error()
    _agree(out, outj, 1e-6)
    lam, X, _ = out
    np.testing.assert_allclose(lam.numpy(), np.linalg.eigvalsh(dense)[:3], atol=1e-6)
    R = dense @ X.numpy() - X.numpy() * lam.numpy()[None, :]
    assert np.linalg.norm(R, axis=0).max() < 1e-5


def test_insufficient_iterations_status(jax_draws):
    tA, jA, _ = _spd_poisson()
    X0 = np.random.default_rng(5).standard_normal((256, 4))
    out = tsp.lobpcg(tA, torch.as_tensor(X0), tol=1e-12, max_iter=2)
    outj = jsp.lobpcg(jA, jnp.asarray(X0), tol=1e-12, max_iter=2)
    assert out[2].status == Status.INSUFFICIENT_ITER and out[2].iterations == 2
    _agree(out, outj, 1e-6)


def test_block_too_large_and_distributed_raise():
    tA, _, _ = _spd_poisson(4)
    with pytest.raises(IncompatibleMatrixFormat):
        tsp.lobpcg(tA, torch.zeros(16, 6, dtype=torch.float64), tol=1e-8, max_iter=10)
    with pytest.raises(IncompatibleMatrixFormat):
        tsp.lobpcg(tA, torch.zeros(15, 2, dtype=torch.float64), tol=1e-8, max_iter=10)
    with pytest.raises(NotImplementedError, match="item 13"):
        tsp.lobpcg(tA, torch.zeros(16, 2, dtype=torch.float64), axis_name="rows")


def test_padded_kernel_operator_runs_k1b(jax_draws, monkeypatch):
    """optimize() gives a PaddedDIA for the f32 grid: lobpcg applies it
    through the flat view, one K1b (plain, on the CPU) per iteration plus
    one, and matches the JAX package's padded run."""
    _, jA, dense = _spd_poisson(10)
    data32 = np.asarray(jA.data, np.float32)
    op = tsp.optimize(tsp.CSR.from_arrays(data32, np.asarray(jA.indices),
                                          np.asarray(jA.indptr), jA.shape), device="cpu")
    assert isinstance(op, tsp.PaddedDIA)
    from sprsolve_tpu.ops.optimize import optimize as joptimize

    jop = joptimize(jsp.CSR.from_arrays(data32, jA.indices, jA.indptr, jA.shape))
    calls = []
    spmm = pd.dia_spmm
    monkeypatch.setattr(pd, "dia_spmm", lambda *a, **k: calls.append(1) or spmm(*a, **k))
    X0 = np.random.default_rng(7).standard_normal((100, 2)).astype(np.float32)
    lam, _, info = tsp.lobpcg(op, torch.as_tensor(X0), tol=1e-4, max_iter=300)
    lamj, _, infoj = jsp.lobpcg(jop, jnp.asarray(X0), tol=1e-4, max_iter=300)
    info.raise_if_error()
    assert lam.dtype == torch.float32
    assert len(calls) == info.iterations + 1
    assert abs(info.iterations - int(infoj.iterations)) <= _band(int(infoj.iterations))
    ev = np.linalg.eigvalsh(dense)
    np.testing.assert_allclose(lam.numpy(), ev[:2], atol=1e-3)
    np.testing.assert_allclose(lam.numpy(), np.asarray(lamj), atol=1e-3)


def test_buffer_accelerates_clustered_pair(jax_draws):
    n = 200
    d = np.arange(1.0, n + 1.0)
    d[3] = 4.0 + 1e-4   # λ₄ clustered against λ₃ (k = 4 wanted)
    X0 = np.random.default_rng(5).standard_normal((n, 4))
    _, _, info0 = tsp.lobpcg(tsp.csr_from_dense(np.diag(d)), torch.as_tensor(X0), tol=1e-8,
                             max_iter=500)
    out = tsp.lobpcg(tsp.csr_from_dense(np.diag(d)), torch.as_tensor(X0), tol=1e-8,
                     max_iter=500, buffer=4)
    outj = jsp.lobpcg(jsp.csr_from_dense(np.diag(d)), jnp.asarray(X0), tol=1e-8,
                      max_iter=500, buffer=4)
    out[2].raise_if_error()
    _agree(out, outj, 1e-5)
    np.testing.assert_allclose(out[0].numpy(), np.sort(d)[:4], rtol=0, atol=1e-5)
    assert tuple(out[1].shape) == (n, 4) and tuple(out[0].shape) == (4,)
    assert out[2].iterations < info0.iterations


def test_buffer_clamps_to_block_bound(jax_draws):
    n = 30
    X0 = np.random.default_rng(6).standard_normal((n, 3))
    dense = np.diag(np.arange(1.0, n + 1.0))
    out = tsp.lobpcg(tsp.csr_from_dense(dense), torch.as_tensor(X0), tol=1e-8, max_iter=300,
                     buffer=100)
    outj = jsp.lobpcg(jsp.csr_from_dense(dense), jnp.asarray(X0), tol=1e-8, max_iter=300,
                      buffer=100)
    out[2].raise_if_error()
    _agree(out, outj, 1e-6, exact_count=False)   # 9 against JAX's 10
    np.testing.assert_allclose(out[0].numpy(), [1.0, 2.0, 3.0], atol=1e-6)
    assert tuple(out[1].shape) == (n, 3)


def test_multigrid_preconditioned_lobpcg(jax_draws):
    """M = GridMGPrecond (≈ A⁻¹) on the f32 16³ Poisson, tol 5e-4: λ₀
    within tol of 3·(2·sin(π/34))², and fewer iterations than without M."""
    side = 16
    tA = tprob.poisson3d(side, side, side)
    jA = jprob.poisson3d(side, side, side, dtype=np.float32)
    X0 = np.random.default_rng(7).standard_normal((tA.shape[0], 4)).astype(np.float32)
    M = tsp.GridMGPrecond.from_csr(tA, (side,) * 3, device="cpu")
    out = tsp.lobpcg(tA.to_dia(), torch.as_tensor(X0), M=M, tol=5e-4, max_iter=60)
    Mj = jsp.GridMGPrecond.from_csr(jA, (side,) * 3)
    outj = jsp.lobpcg(jA.to_dia(), jnp.asarray(X0), M=Mj, tol=5e-4, max_iter=60)
    out[2].raise_if_error()
    _agree(out, outj, 5e-4 * float(out[0].abs().max()))
    l1 = 3 * (2 * math.sin(math.pi / (2 * (side + 1)))) ** 2
    assert abs(float(out[0][0]) - l1) < 5e-3 * l1 + 1e-4
    _, _, info_u = tsp.lobpcg(tA.to_dia(), torch.as_tensor(X0), tol=5e-4, max_iter=60)
    assert out[2].iterations < max(info_u.iterations, 60)


def test_fresh_directions_repeat_and_refill_degenerate_columns():
    """The port's own draws: the same tag gives the same block, another tag
    another one; a zero column is refilled with a unit direction."""
    a = tlob._fresh_directions((3, 17), (50, 4), torch.float64, torch.device("cpu"))
    b = tlob._fresh_directions((3, 17), (50, 4), torch.float64, torch.device("cpu"))
    c = tlob._fresh_directions((3, 29), (50, 4), torch.float64, torch.device("cpu"))
    assert torch.equal(a, b) and not torch.equal(a, c)
    X = torch.as_tensor(np.random.default_rng(0).standard_normal((50, 3)))
    X[:, 1] = 0
    tiny = torch.tensor(torch.finfo(torch.float64).tiny * 1e4, dtype=torch.float64)
    Xn = tlob._safe_colnormalize(X, (1, 17), torch.float64, tiny)
    np.testing.assert_allclose(torch.linalg.norm(Xn, dim=0).numpy(), 1.0, rtol=1e-14)
    assert bool(Xn[:, 1].abs().sum() > 0)


def test_block_products_run_with_tf32_off(monkeypatch):
    """Every product of the block algebra goes through
    ``full_precision_matmul``, whatever the global TF32 switch, and the
    switch is left as it was (ROADMAP hazard: TF32 in the projections)."""
    seen = []
    orig = tlob.mm

    def spy(a, b):
        seen.append(1)
        return orig(a, b)

    monkeypatch.setattr(tlob, "mm", spy)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tA, _, _ = _spd_poisson(8)
        X0 = torch.as_tensor(np.random.default_rng(0).standard_normal((64, 2)))
        _, _, info = tsp.lobpcg(tA, X0, tol=1e-8, max_iter=100)
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    # three products per Rayleigh–Ritz, two for P, per iteration
    assert len(seen) == 3 + 5 * info.iterations
    assert torch.get_float32_matmul_precision() == "highest"
