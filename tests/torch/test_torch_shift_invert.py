"""Cross tests of the port's shift-invert eigensolver against the JAX
package's (mirrors ``tests/test_shift_invert.py``, and the FGMRES-inner
case of ``tests/test_rational_filter.py``; ``scipy_compat.eigsh`` is
ROADMAP Queue 1 item 12 and is left out): nearest-σ pairs against dense
``eigh``, the one-sided modes, a degenerate 2-D cluster, the padded layout
through the plain K1b, ``InvertedOperator`` (a single MINRES and the
lockstep block MINRES), the FGMRES inner method with a nonlinear M, and
the error paths.

The JAX package's LOBPCG draws are patched into the port's
``_fresh_directions``; the inner MINRES solves sum in another order than
XLA, so the LOBPCG counts are held to the band of
``test_serial_parity.py:183`` (max(3, ⌈its/4⌉)). Eigenvalues agree with
JAX's and dense ``eigh`` within tol; status is equal. f64 on the CPU."""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sprsolve_tpu as jsp
from sprsolve_tpu.solvers import InvertedOperator as JInverted
from sprsolve_tpu.utils import problems as jprob
import sprsolve_tpu_torch as tsp
from sprsolve_tpu_torch.errors import IncompatibleMatrixFormat, Status
from sprsolve_tpu_torch.ops import padded_dia as pd
from sprsolve_tpu_torch.solvers import InvertedOperator

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
    """The JAX package's LOBPCG draw for ``tag``
    (``sprsolve_tpu/solvers/lobpcg.py:232-266``)."""
    rdt = jnp.float32 if dtype in (torch.float32, torch.complex64) else jnp.float64
    draw = np.array(_jax_draw(tuple(shape), rdt, len(tag))(jnp.asarray(tag, jnp.uint32)))
    return torch.as_tensor(draw).to(dtype).to(device)


@pytest.fixture
def jax_draws(monkeypatch):
    monkeypatch.setattr(tlob, "_fresh_directions", jax_fresh_directions)


def _tridiag(n=64):
    dense = (np.diag(np.full(n, 2.0)) + np.diag(np.full(n - 1, -1.0), 1)
             + np.diag(np.full(n - 1, -1.0), -1))
    return dense, tsp.csr_from_dense(dense), jsp.csr_from_dense(dense)


def _agree(out, outj, atol):
    lam, _, info = out
    lamj, _, infoj = outj
    assert info.status == int(infoj.status)
    its_j = int(infoj.iterations)
    assert abs(info.iterations - its_j) <= _band(its_j), (info.iterations, its_j)
    np.testing.assert_allclose(np.sort(lam.numpy()), np.sort(np.asarray(lamj)), atol=atol)


def test_interior_eigs_match_dense_oracle_and_jax(jax_draws):
    dense, tA, jA = _tridiag()
    ev = np.linalg.eigvalsh(dense)
    sigma = 1.0
    want = np.sort(ev[np.argsort(np.abs(ev - sigma))[:4]])
    out = tsp.shift_invert_eigs(tA, 4, sigma, tol=1e-8, max_iter=200, device="cpu")
    outj = jsp.shift_invert_eigs(jA, 4, sigma, tol=1e-8, max_iter=200)
    lam, X, info = out
    assert info.status == Status.CONVERGED
    _agree(out, outj, 1e-7)
    np.testing.assert_allclose(np.sort(lam.numpy()), want, atol=1e-7)
    Xn = X.numpy()
    for i in range(4):
        assert np.linalg.norm(dense @ Xn[:, i] - lam.numpy()[i] * Xn[:, i]) < 1e-6
    d = np.abs(lam.numpy() - sigma)
    assert np.all(np.diff(d) >= -1e-12)


@pytest.mark.parametrize("side", ["above", "below"])
def test_one_sided_modes(jax_draws, side):
    dense, tA, jA = _tridiag()
    ev = np.linalg.eigvalsh(dense)
    sigma = 1.0
    out = tsp.shift_invert_eigs(tA, 3, sigma, side=side, tol=1e-8, max_iter=200,
                                device="cpu")
    outj = jsp.shift_invert_eigs(jA, 3, sigma, side=side, tol=1e-8, max_iter=200)
    lam = out[0].numpy()
    assert out[2].status == Status.CONVERGED
    _agree(out, outj, 1e-7)
    if side == "above":
        assert np.all(lam >= sigma)
        want = np.sort(ev[ev >= sigma])[:3]
    else:
        assert np.all(lam < sigma)
        want = np.sort(ev[ev < sigma])[-3:]
    np.testing.assert_allclose(np.sort(lam), want, atol=1e-7)


def test_degenerate_interior_cluster_2d(jax_draws):
    Aj, _ = jprob.sym_grid_laplacian((10, 10))
    dense = -np.asarray(Aj.todense())
    ev = np.linalg.eigvalsh(dense)
    sigma = 2.0
    want = np.sort(ev[np.argsort(np.abs(ev - sigma))[:4]])
    kw = dict(tol=1e-7, max_iter=300, inner_max_iter=600)
    out = tsp.shift_invert_eigs(tsp.csr_from_dense(dense), 4, sigma, device="cpu", **kw)
    outj = jsp.shift_invert_eigs(jsp.csr_from_dense(dense), 4, sigma, **kw)
    assert out[2].status == Status.CONVERGED
    _agree(out, outj, 1e-5)
    np.testing.assert_allclose(np.sort(out[0].numpy()), want, atol=1e-5)


def test_padded_kernel_layout_path(jax_draws, monkeypatch):
    """The f64 6³ Poisson on the padded layout (the port's optimize()
    sends f64 to torch DIA, so the PaddedDIA is built directly): each block
    apply of the inner solves is one K1b (plain on the CPU), and the pairs
    are genuine eigenpairs at the nearest distances, as in the JAX
    package's padded run. The two nearest slots are a 6+6-fold tie."""
    A3 = jprob.poisson3d(6, 6, 6, dtype=np.float64)
    dense = np.asarray(A3.todense())
    ev = np.linalg.eigvalsh(dense)
    sigma = float(np.median(ev))
    tA = tsp.csr_from_dense(dense)
    op = tsp.PaddedDIA.from_dia(tA.to_dia(), device="cpu")
    assert op.bands.dtype == torch.float64
    calls = []
    spmm = pd.dia_spmm
    monkeypatch.setattr(pd, "dia_spmm", lambda *a, **k: calls.append(1) or spmm(*a, **k))
    kw = dict(tol=1e-6, max_iter=300, inner_max_iter=800)
    lam, X, info = tsp.shift_invert_eigs(op, 2, sigma, **kw)
    assert info.status == Status.CONVERGED and len(calls) > info.iterations
    _, _, infoj = jsp.shift_invert_eigs(A3, 2, sigma, **kw)
    assert int(infoj.status) == Status.CONVERGED
    want_d = np.sort(np.abs(ev - sigma))[:2]
    np.testing.assert_allclose(np.sort(np.abs(lam.numpy() - sigma)), want_d, atol=1e-4)
    Xn = X.numpy()
    for i in range(2):
        r = dense @ Xn[:, i] - lam.numpy()[i] * Xn[:, i]
        assert np.linalg.norm(r) / np.linalg.norm(Xn[:, i]) < 1e-4
    assert abs(np.vdot(Xn[:, 0], Xn[:, 1])) < 0.1


def test_inverted_operator_applies_the_inverse():
    dense, tA, jA = _tridiag(32)
    sigma = 0.7
    sh = tsp.ShiftedOperator(A=tA, shift=sigma)
    inv = InvertedOperator(A=sh, inner_tol=1e-12, inner_max_iter=400)
    jinv = JInverted(A=jsp.ShiftedOperator(A=jA, shift=jnp.asarray(sigma)), inner_tol=1e-12,
                     inner_max_iter=400)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(32)
    np.testing.assert_allclose(inv.matvec(torch.as_tensor(x)).numpy(),
                               np.linalg.solve(dense - sigma * np.eye(32), x), atol=1e-9)
    np.testing.assert_allclose(inv.matvec(torch.as_tensor(x)).numpy(),
                               np.asarray(jinv.matvec(jnp.asarray(x))), atol=1e-10)
    # matmat: the lockstep block MINRES, each column its single solve
    X = rng.standard_normal((32, 3))
    Y = inv.matmat(torch.as_tensor(X))
    np.testing.assert_allclose(Y.numpy(), np.linalg.solve(dense - sigma * np.eye(32), X),
                               atol=1e-9)
    np.testing.assert_allclose(Y.numpy(), np.asarray(jinv.matmat(jnp.asarray(X))), atol=1e-10)
    for j in range(3):
        y = inv.matvec(torch.as_tensor(X[:, j])).numpy()
        np.testing.assert_allclose(Y[:, j].numpy(), y, rtol=0, atol=1e-12 * np.abs(y).max())


def test_shift_invert_fgmres_inner_with_any_M(jax_draws):
    """``inner_method="fgmres"`` (``batched(fgmres)``, one solve per
    column) with an inner-MINRES preconditioner on the shifted system."""
    from sprsolve_tpu.ops.operator import ShiftedOperator as JShifted
    from sprsolve_tpu.precond import InnerSolvePrecond as JInner

    Aj, _ = jprob.sym_grid_laplacian((12, 12))
    dense = -np.asarray(Aj.todense())
    ev = np.linalg.eigvalsh(dense)
    sigma = 2.0
    tA, jA = tsp.csr_from_dense(dense), jsp.csr_from_dense(dense)
    M_in = tsp.InnerSolvePrecond(A=tsp.ShiftedOperator(A=tA.to_dia(), shift=sigma),
                                 method="minres", iters=8)
    Mj = JInner(A=JShifted(A=jA.to_dia(), shift=np.float64(sigma)), method="minres", iters=8)
    kw = dict(inner_method="fgmres", inner_max_iter=200, tol=1e-6, max_iter=60)
    out = tsp.shift_invert_eigs(tA, 2, sigma, M_inner=M_in, device="cpu", **kw)
    outj = jsp.shift_invert_eigs(jA, 2, sigma, M_inner=Mj, **kw)
    assert out[2].status == Status.CONVERGED
    _agree(out, outj, 1e-6)
    want = np.sort(ev[np.argsort(np.abs(ev - sigma))[:2]])
    np.testing.assert_allclose(np.sort(out[0].numpy()), want, atol=1e-6)


def test_error_paths():
    _, tA, _ = _tridiag(32)
    with pytest.raises(IncompatibleMatrixFormat):
        tsp.shift_invert_eigs(tA, 0, 1.0, device="cpu")
    with pytest.raises(IncompatibleMatrixFormat):
        tsp.shift_invert_eigs(tA, 2, 1.0, side="sideways", device="cpu")
    with pytest.raises(IncompatibleMatrixFormat):
        tsp.shift_invert_eigs(tA, 2, 1.0, X0=torch.zeros(5, 5), device="cpu")
    inv = InvertedOperator(A=tA.to_dia(), method="nope")
    with pytest.raises(IncompatibleMatrixFormat):
        inv.matvec(torch.ones(32, dtype=torch.float64))
    with pytest.raises(IncompatibleMatrixFormat):
        inv.matmat(torch.ones(32, 2, dtype=torch.float64))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tsp.shift_invert_eigs(tA, 2, 1.0)
