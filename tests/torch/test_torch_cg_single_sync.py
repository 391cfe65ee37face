"""Cross tests of the port's Chronopoulos–Gear CG against the JAX
package's (mirrors ``tests/test_cg_single_sync.py``): parity with plain CG,
Jacobi in f32, a Hermitian positive-definite complex system, the
breakdown on an indefinite matrix, the residual trace, ``solve``, and the
padded layout's launches (one SpMV per iteration, the fused dot never).
The HLO all-reduce count is a TPU artefact; the distributed case, with its
one all-reduce an iteration counted, is
``cg_single_sync_iteration_invariance`` in ``test_torch_dist_krylov.py``.

Tolerances: the f64 Poisson keeps equal counts with the JAX package's
single-sync CG, x to 1e-10; f32 counts within the band of
``test_serial_parity.py:183`` (max(3, ⌈its/4⌉)), x to 1e-4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sprsolve_tpu as jsp
from sprsolve_tpu.utils import problems as jprob
import sprsolve_tpu_torch as tsp
from sprsolve_tpu_torch.errors import Status
from sprsolve_tpu_torch.utils import problems as tprob

torch.set_num_threads(2)


def _band(its):
    return max(3, -(-its // 4))


def _spd_poisson(dtype=np.float64, k=8):
    b = np.random.default_rng(5).standard_normal(k ** 3).astype(dtype)
    return tprob.poisson3d(k, k, k, dtype=dtype), jprob.poisson3d(k, k, k, dtype=dtype), b


def test_matches_cg_and_jax():
    tA, jA, b = _spd_poisson()
    x1, i1 = tsp.cg(tA, torch.as_tensor(b), tol=1e-11, max_iter=600)
    x2, i2 = tsp.cg_single_sync(tA, torch.as_tensor(b), tol=1e-11, max_iter=600)
    xj, ij = jsp.cg_single_sync(jA, jnp.asarray(b), tol=1e-11, max_iter=600)
    i1.raise_if_error()
    i2.raise_if_error()
    assert abs(i1.iterations - i2.iterations) <= 3
    np.testing.assert_allclose(x1.numpy(), x2.numpy(), atol=1e-8)
    assert i2.iterations == int(ij.iterations)
    np.testing.assert_allclose(x2.numpy(), np.asarray(xj), rtol=0, atol=1e-10)


def test_preconditioned_f32_matches_jax():
    tA, jA, b = _spd_poisson(np.float32, k=10)
    M = tsp.DiagPrecond.new(tA.diagonal())
    x, info = tsp.cg_single_sync(tA, torch.as_tensor(b), M=M, tol=1e-5, max_iter=500)
    xj, ij = jsp.cg_single_sync(jA, jnp.asarray(b), M=jsp.DiagPrecond.new(jA.diagonal()),
                                tol=1e-5, max_iter=500)
    info.raise_if_error()
    r = tA.matvec(x).numpy() - b
    assert np.linalg.norm(r) / np.linalg.norm(b) < 2e-5
    assert abs(info.iterations - int(ij.iterations)) <= _band(int(ij.iterations))
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-4, atol=1e-4)


def test_hermitian_complex():
    rng = np.random.default_rng(2)
    Bm = rng.standard_normal((48, 48)) + 1j * rng.standard_normal((48, 48))
    dense = Bm.conj().T @ Bm + 48 * np.eye(48)
    x_known = rng.standard_normal(48) + 1j * rng.standard_normal(48)
    b = dense @ x_known
    x, info = tsp.cg_single_sync(tsp.csr_from_dense(dense), torch.as_tensor(b), tol=1e-12,
                                 max_iter=600)
    _, ij = jsp.cg_single_sync(jsp.csr_from_dense(dense), jnp.asarray(b), tol=1e-12,
                               max_iter=600)
    info.raise_if_error()
    assert np.abs(x.numpy() - x_known).max() < 1e-8
    assert info.iterations == int(ij.iterations)


def test_breakdown_on_indefinite():
    d = np.ones(32)
    d[3] = -1.0
    b = np.random.default_rng(1).standard_normal(32)
    _, info = tsp.cg_single_sync(tsp.csr_from_dense(np.diag(d)), torch.as_tensor(b),
                                 tol=1e-12, max_iter=100)
    _, ij = jsp.cg_single_sync(jsp.csr_from_dense(np.diag(d)), jnp.asarray(b), tol=1e-12,
                               max_iter=100)
    assert info.status == Status.BREAKDOWN == int(ij.status)
    assert info.iterations == int(ij.iterations)


def test_record_residuals_boundary():
    tA, jA, b = _spd_poisson()
    x, info, hist = tsp.cg_single_sync(tA, torch.as_tensor(b), tol=1e-11, max_iter=600,
                                       record_residuals=True)
    _, ij, hj = jsp.cg_single_sync(jA, jnp.asarray(b), tol=1e-11, max_iter=600,
                                   record_residuals=True)
    info.raise_if_error()
    its, h = info.iterations, hist.numpy()
    assert h.shape == (601,)
    assert np.isfinite(h[: its + 1]).all() and np.isnan(h[its + 1:]).all()
    assert h[its] == pytest.approx(float(info.residual), rel=1e-6)
    np.testing.assert_allclose(h[: its + 1], np.asarray(hj)[: its + 1], rtol=1e-8)


def test_solve_on_the_padded_layout_applies_a_once_per_iteration():
    """solve(method="cg_single_sync") lands on the PaddedDIA: each iteration
    applies A once (s = A·p by recurrence) and never the fused dot."""
    tA, jA, b = _spd_poisson(np.float32)
    kw = dict(method="cg_single_sync", M="jacobi", tol=1e-5, max_iter=500)
    handle = tsp.prepare(tA, device="cpu", **kw)
    op = handle.operator
    assert isinstance(op, tsp.PaddedDIA)
    calls = {"matvec": 0, "matvec_dot": 0}
    for name in calls:
        orig = getattr(op, name)
        object.__setattr__(op, name, (lambda o, k: lambda x: calls.__setitem__(
            k, calls[k] + 1) or o(x))(orig, name))
    x, info = handle(b)
    for name in calls:
        object.__delattr__(op, name)
    xj, ij = jsp.solve(jA, b, **kw)
    info.raise_if_error()
    assert calls == {"matvec": info.iterations + 2, "matvec_dot": 0}
    r = tA.matvec(x).numpy() - b
    assert np.linalg.norm(r) / np.linalg.norm(b) < 2e-5
    assert abs(info.iterations - int(ij.iterations)) <= _band(int(ij.iterations))
