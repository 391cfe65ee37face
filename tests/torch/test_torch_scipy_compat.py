"""Cross tests of the port's ``scipy_compat`` against the JAX package's
(mirrors ``tests/test_cg_scipy_compat.py``'s compat cases and
``tests/test_scipy_minres_shift.py``): each wrapper on a scipy CSR, a
dense array and a scipy ``LinearOperator`` (the host round trip), with the
same info code and x within 1e-10 relative (f64, rtol 1e-13 on a system of
condition ~100); the maxiter info (the iteration count, equal in both);
breakdown (-2) and a refused preconditioner (-1); the atol rule; minres
with a shift; LOBPCG's descending order for ``largest``; eigsh's LA, SA
and σ paths and ``return_eigenvectors=False`` (eigenvalues within 1e-7);
``ArpackNoConvergence`` when fewer than k pairs come back; lsqr's 10-tuple
within 1e-10; and every entry point's device rule (the CPU only when
asked)."""

import numpy as np
import pytest
import scipy.sparse as sps
import scipy.sparse.linalg as spla
import torch

from sprsolve_tpu import scipy_compat as J
from sprsolve_tpu.utils import problems as jprob
from sprsolve_tpu_torch import scipy_compat as T
import sprsolve_tpu_torch as tsp

torch.set_num_threads(2)
CPU = dict(device="cpu")


def _spd(side=16) -> sps.csr_matrix:
    A, _ = jprob.sym_grid_laplacian((side, side))
    return sps.csr_matrix(-np.asarray(A.todense()))


def _input(kind, S):
    return {"scipy_csr": S, "dense": S.toarray(),
            "linear_operator": spla.aslinearoperator(S.toarray())}[kind]


def _rel(x, xj) -> float:
    xj = np.asarray(xj)
    return float(np.abs(np.asarray(x) - xj).max() / np.abs(xj).max())


@pytest.mark.parametrize("kind", ["scipy_csr", "dense", "linear_operator"])
@pytest.mark.parametrize("name", ["cg", "bicgstab", "cgs", "tfqmr", "gmres", "minres"])
def test_wrapper_matches_the_jax_packages(name, kind):
    S = _spd()
    b = np.random.default_rng(2).standard_normal(S.shape[0])
    A = _input(kind, S)
    x, info = getattr(T, name)(A, b, rtol=1e-13, **CPU)
    xj, info_j = getattr(J, name)(A, b, rtol=1e-13)
    assert info == info_j == 0
    assert isinstance(x, torch.Tensor) and x.dtype == torch.float64
    assert _rel(x.numpy(), xj) <= 1e-10
    assert np.linalg.norm(S @ x.numpy() - b) / np.linalg.norm(b) <= 1e-12


@pytest.mark.parametrize("name", ["cg", "bicgstab", "minres"])
def test_maxiter_info_is_the_count(name):
    S = _spd()
    b = np.random.default_rng(1).standard_normal(S.shape[0])
    _, info = getattr(T, name)(S, b, rtol=1e-14, maxiter=3, **CPU)
    _, info_j = getattr(J, name)(S, b, rtol=1e-14, maxiter=3)
    assert info == info_j == 3
    _, info_s = getattr(spla, name)(S, b, rtol=1e-14, maxiter=3)
    if name == "cg":
        assert info_s == 3   # scipy's own cg reports the same


def test_breakdown_and_refused_preconditioner():
    dense = np.diag(np.array([1.0, -1.0, 2.0, -2.0]))
    b = np.ones(4)
    # CG on an indefinite matrix: the BREAKDOWN status, -2
    assert T.cg(dense, b, rtol=1e-14, maxiter=50, **CPU)[1] == \
        J.cg(dense, b, rtol=1e-14, maxiter=50)[1] == -2
    # M="amg" builds from a CSR: on a host operator it is refused, -1
    L = spla.aslinearoperator(np.diag([1.0, 2.0, 3.0, 4.0]))
    x, info = T.cg(L, b, M="amg", **CPU)
    assert info == J.cg(L, b, M="amg")[1] == -1
    assert not bool(x.any())


def test_atol_semantics():
    S = _spd()
    b = np.random.default_rng(3).standard_normal(S.shape[0])
    x, info = T.cg(S, b, rtol=1e-12, atol=1e6, **CPU)
    xj, info_j = J.cg(S, b, rtol=1e-12, atol=1e6)
    assert info == info_j == 0
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=0, atol=1e-12)


def test_preconditioner_string_and_operator():
    S = _spd()
    b = np.random.default_rng(4).standard_normal(S.shape[0])
    for M in ("jacobi", sps.diags(1.0 / S.diagonal()).tocsr()):
        x, info = T.bicgstab(S, b, rtol=1e-13, M=M, **CPU)
        xj, info_j = J.bicgstab(S, b, rtol=1e-13, M=M)
        assert info == info_j == 0 and _rel(x.numpy(), xj) <= 1e-10


@pytest.mark.parametrize("shift", [0.5, -1.25])
def test_minres_shift_matches_jax_and_dense(shift):
    S = _spd(12)
    b = np.random.default_rng(5).standard_normal(S.shape[0])
    x, info = T.minres(S, b, shift=shift, rtol=1e-12, **CPU)
    xj, info_j = J.minres(S, b, shift=shift, rtol=1e-12)
    assert info == info_j == 0 and _rel(x.numpy(), xj) <= 1e-10
    want = np.linalg.solve(S.toarray() - shift * np.eye(S.shape[0]), b)
    np.testing.assert_allclose(x.numpy(), want, rtol=0, atol=1e-9 * np.abs(want).max())


def test_aslinearoperator_passthrough_and_callback():
    A = tsp.csr_from_scipy(_spd())
    assert T.aslinearoperator(A, **CPU) is A
    dia = A.to_dia()
    assert T.aslinearoperator(dia, **CPU) is dia
    op = tsp.optimize(A, device="cpu")
    assert T.aslinearoperator(op, **CPU) is op
    host = spla.aslinearoperator(_spd(4).toarray())
    cb = T.aslinearoperator(host, **CPU)
    x = torch.arange(16, dtype=torch.float64)
    np.testing.assert_array_equal(cb.matvec(x).numpy(), host.matvec(x.numpy()))
    assert isinstance(T.aslinearoperator(_spd(4), **CPU), tsp.CSR)


def test_lobpcg_largest_descending_like_the_jax_package():
    S = _spd()
    X = np.random.default_rng(6).standard_normal((S.shape[0], 3))
    w, v = T.lobpcg(S, X, tol=1e-9, maxiter=300, **CPU)
    wj, _ = J.lobpcg(S, X, tol=1e-9, maxiter=300)
    assert bool((w[:-1] >= w[1:]).all())
    np.testing.assert_allclose(w.numpy(), np.asarray(wj), rtol=0, atol=1e-7)
    np.testing.assert_allclose(w.numpy(), np.linalg.eigvalsh(S.toarray())[::-1][:3],
                               rtol=0, atol=1e-7)
    w2, _ = T.lobpcg(S, X, largest=False, tol=1e-9, maxiter=300, **CPU)
    assert bool((w2[:-1] <= w2[1:]).all())
    # an integer X is promoted, as scipy's is, and takes the f64 of A
    Xi = np.ones((S.shape[0], 1), dtype=np.int64) + np.eye(S.shape[0], 1, dtype=np.int64)
    wi, _ = T.lobpcg(S, Xi, tol=1e-8, maxiter=300, **CPU)
    wij, _ = J.lobpcg(S, Xi, tol=1e-8, maxiter=300)
    assert wi.dtype == torch.float64 and np.asarray(wij).dtype == np.float64
    np.testing.assert_allclose(wi.numpy(), np.asarray(wij), rtol=0, atol=1e-7)
    with pytest.raises(NotImplementedError):
        T.lobpcg(S, X, B=S, **CPU)


@pytest.mark.parametrize("which,sigma", [("SA", None), ("LA", None), ("LM", 2.0)])
def test_eigsh_paths_match_the_jax_package(which, sigma):
    S = _spd(12)
    kw = dict(k=3, which=which, tol=1e-9)
    if sigma is not None:
        kw["sigma"] = sigma
    w, v = T.eigsh(S, **kw, **CPU)
    wj, _ = J.eigsh(S, **kw)
    assert isinstance(w, np.ndarray) and isinstance(v, np.ndarray) and v.shape == (144, 3)
    assert bool((np.diff(w) >= 0).all())
    np.testing.assert_allclose(w, np.asarray(wj), rtol=0, atol=1e-7)
    full = np.linalg.eigvalsh(S.toarray())
    want = {"SA": full[:3], "LA": full[-3:]}.get(
        which, np.sort(full[np.argsort(np.abs(full - 2.0))[:3]]))
    np.testing.assert_allclose(w, want, rtol=0, atol=1e-7)
    w_only = T.eigsh(S, return_eigenvectors=False, **kw, **CPU)
    np.testing.assert_allclose(w_only, w, rtol=0, atol=1e-12)


def test_eigsh_tol_zero_precond_and_refusals():
    A = jprob.poisson3d(8, 8, 8, dtype=np.float64)
    S = sps.csr_matrix((np.asarray(A.data), np.asarray(A.indices), np.asarray(A.indptr)),
                       shape=A.shape)
    l1 = 3 * (2 * np.sin(np.pi / 18)) ** 2
    w = T.eigsh(S, k=2, which="SA", tol=0, maxiter=200, precond="jacobi",
                return_eigenvectors=False, **CPU)
    wj = J.eigsh(S, k=2, which="SA", tol=0, maxiter=200, precond="jacobi",
                 return_eigenvectors=False)
    assert abs(w[0] - l1) < 1e-6 and abs(w[0] - float(wj[0])) < 1e-7
    Mg = tsp.GridMGPrecond.from_csr(tsp.csr_from_scipy(S), (8, 8, 8), device="cpu")
    w, _ = T.eigsh(S, k=2, which="SA", tol=1e-8, maxiter=100, precond=Mg, **CPU)
    assert abs(w[0] - l1) < 1e-6
    for kw in (dict(sigma=1.0, precond="jacobi"), dict(which="SA", precond="ilu0"),
               dict(which="LM"), dict(which="SA", M=S), dict(which="SA", mode="buckling"),
               dict(sigma=1.0, which="SA")):
        with pytest.raises(NotImplementedError):
            T.eigsh(S, k=2, **kw, **CPU)


def test_eigsh_fewer_pairs_than_k_raises_arpack_no_convergence(monkeypatch):
    """shift-invert's dedupe can keep fewer than k pairs; eigsh then raises
    scipy's ArpackNoConvergence with the pairs found, in both packages (the
    inner solver stubbed to return one pair)."""
    import jax.numpy as jnp

    import sprsolve_tpu.solvers as jsolvers
    import sprsolve_tpu_torch.solvers as tsolvers

    S = _spd(8)
    x1 = np.ones((64, 1)) / 8.0
    monkeypatch.setattr(tsolvers, "shift_invert_eigs", lambda *a, **k: (
        torch.tensor([2.5], dtype=torch.float64), torch.as_tensor(x1), None))
    monkeypatch.setattr(jsolvers, "shift_invert_eigs", lambda *a, **k: (
        jnp.asarray([2.5]), jnp.asarray(x1), None))
    with pytest.raises(spla.ArpackNoConvergence, match="only 1 of 3") as e:
        T.eigsh(S, k=3, sigma=2.0, tol=1e-8, **CPU)
    with pytest.raises(spla.ArpackNoConvergence, match="only 1 of 3") as ej:
        J.eigsh(S, k=3, sigma=2.0, tol=1e-8)
    np.testing.assert_array_equal(e.value.eigenvalues, np.asarray(ej.value.eigenvalues))
    np.testing.assert_array_equal(e.value.eigenvectors, np.asarray(ej.value.eigenvectors))


@pytest.mark.parametrize("kind", ["scipy_csr", "dense"])
@pytest.mark.parametrize("damp", [0.0, 0.3])
def test_lsqr_tuple_matches_the_jax_package(kind, damp):
    R = (sps.random(60, 20, density=0.3, random_state=1, format="csr")
         + sps.eye(60, 20)).tocsr()
    b = np.random.default_rng(1).standard_normal(60)
    A = R if kind == "scipy_csr" else R.toarray()
    t = T.lsqr(A, b, damp=damp, atol=1e-12, btol=1e-12, **CPU)
    j = J.lsqr(A, b, damp=damp, atol=1e-12, btol=1e-12)
    assert len(t) == len(j) == 10
    assert t[1] == j[1] and t[2] == j[2]
    assert _rel(t[0].numpy(), j[0]) <= 1e-10
    for i in (3, 4, 5, 7, 8):
        np.testing.assert_allclose(t[i], j[i], rtol=1e-10, atol=1e-10)
    assert np.isnan(t[6]) and t[9] is None
    with pytest.raises(NotImplementedError):
        T.lsqr(A, b, calc_var=True, **CPU)
    with pytest.raises(NotImplementedError):
        T.lsqr(spla.aslinearoperator(R), b, **CPU)


def test_every_entry_point_needs_cuda_or_a_device():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device exists")
    S = _spd(4)
    b = np.ones(16)
    calls = [lambda: T.cg(S, b), lambda: T.gmres(S, b), lambda: T.minres(S, b, shift=0.5),
             lambda: T.lobpcg(S, np.ones((16, 1))), lambda: T.eigsh(S, k=1, which="SA"),
             lambda: T.lsqr(S, b), lambda: T.aslinearoperator(S.toarray())]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
