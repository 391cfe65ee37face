"""The lockstep block MINRES and COCG, K1b's plain version, and the small
pieces of slice 9: ``ShiftedOperator`` against the JAX class,
``csr_from_bcoo`` against the JAX function on the same triplets, and
``debug.check_operator``.

A lockstep block solve must give every column its single solve's count,
status and x (to 1e-12 in f64: the column sums run in another order than
a vector's), including columns that converge at different iterations, a
zero column, ``max_iter`` 0, a preconditioner whose β² gate fails on one
column, and a COCG breakdown that freezes one column while the others go
on. K1b's plain version equals K1's per column bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import sparse as jsparse

import sprsolve_tpu as jsp
from sprsolve_tpu.ops.operator import ShiftedOperator as JShifted
from sprsolve_tpu.utils import problems as jprob
import sprsolve_tpu_torch as tsp
from sprsolve_tpu_torch.debug import check_operator
from sprsolve_tpu_torch.errors import Status
from sprsolve_tpu_torch.ops import padded_dia as pd
from sprsolve_tpu_torch.solvers.cocg import _cocg_block
from sprsolve_tpu_torch.solvers.minres import _minres_block
from sprsolve_tpu_torch.parallel import comm
from sprsolve_tpu_torch.utils import problems as tprob

import _dist_worker

torch.set_num_threads(2)


def _indefinite(n=120):
    """A symmetric indefinite tridiagonal system (a shuffled diagonal with a
    gap around 0: MINRES converges well inside n steps, where rounding
    moves no count) and its dense form."""
    d = np.concatenate([np.linspace(-3.0, -1.0, n // 2), np.linspace(1.0, 3.0, n - n // 2)])
    np.random.default_rng(0).shuffle(d)
    dense = np.diag(d) + np.diag(np.full(n - 1, 0.1), 1) + np.diag(np.full(n - 1, 0.1), -1)
    return tsp.csr_from_dense(dense), dense


def _same_as_single(solver, block, A, B, **kw):
    X, info, steps = block(A, torch.as_tensor(B), **kw)
    per = []
    for j in range(B.shape[1]):
        x, i1 = solver(A, torch.as_tensor(B[:, j]).contiguous(), **kw)
        assert int(info.iterations[j]) == i1.iterations, (j, info.iterations, i1)
        assert int(info.status[j]) == i1.status, (j, info.status, i1)
        np.testing.assert_allclose(X[:, j].numpy(), x.numpy(), rtol=0, atol=1e-12)
        np.testing.assert_allclose(float(info.residual[j]), float(i1.residual), rtol=1e-9,
                                   atol=1e-300)
        per.append(i1.iterations)
    return X, info, steps, per


def test_block_minres_columns_are_single_solves():
    A, dense = _indefinite()
    rng = np.random.default_rng(1)
    B = rng.standard_normal((120, 5))
    B[:, 2] = 0.0                                  # the zero-rhs guard
    B[:, 3] = np.eye(120)[:, 50] + np.eye(120)[:, 90]   # fewer spectral weights
    B[:, 4] = np.eye(120)[:, 7]
    X, info, steps, per = _same_as_single(tsp.minres, _minres_block, A, B, tol=1e-10,
                                          max_iter=400)
    assert len(set(per) - {0}) >= 3                # columns stop at different its
    assert bool((info.status == Status.CONVERGED).all())
    assert not bool(X[:, 2].any())
    # one lockstep pass per iteration of the slowest column, plus its exit pass
    assert steps == max(per) + 1


def test_block_minres_budget_and_max_iter_zero():
    A, _ = _indefinite()
    B = np.random.default_rng(2).standard_normal((120, 3))
    _, info, _, per = _same_as_single(tsp.minres, _minres_block, A, B, tol=1e-12,
                                      max_iter=7)
    assert per == [7, 7, 7] and bool((info.status == Status.INSUFFICIENT_ITER).all())
    X, info, steps, _ = _same_as_single(tsp.minres, _minres_block, A, B, tol=1e-12,
                                        max_iter=0)
    assert steps == 0 and bool((info.status == Status.INSUFFICIENT_ITER).all())


def test_block_minres_preconditioned_and_a_failing_gate():
    """Jacobi on an SPD system under MINRES, and an M that is negative on
    one column's residual only: that column stops with
    INVALID_PRECONDITIONER and keeps its x, the others converge."""
    A = tprob.poisson3d(6, 6, 6, dtype=np.float64)
    Mj = tsp.DiagPrecond.new(A.diagonal())
    B = np.random.default_rng(3).standard_normal((216, 3))
    _same_as_single(tsp.minres, _minres_block, A, B, M=Mj, tol=1e-10, max_iter=300)
    # a diagonal A keeps each column's Krylov space on its own rows: an M
    # negative on rows 0-19 fails the gate of the columns that reach them
    # and not of the one that lives on rows 100 and up
    Ad = tsp.csr_from_dense(np.diag(np.linspace(1.0, 4.0, 216)))
    d = np.ones(216)
    d[:20] = -50.0
    Mbad = tsp.DiagPrecond(diag_inv=torch.as_tensor(d))
    rng = np.random.default_rng(4)
    B2 = np.zeros((216, 3))
    B2[:, 0] = rng.standard_normal(216)
    B2[:20, 0] *= 0.05
    B2[:, 1] = rng.standard_normal(216)
    B2[:20, 1] *= 30.0
    B2[100:, 2] = 1.0
    X, info, _, _ = _same_as_single(tsp.minres, _minres_block, Ad, B2, M=Mbad, tol=1e-10,
                                    max_iter=300)
    assert info.status.tolist() == [Status.INVALID_PRECONDITIONER] * 2 + [Status.CONVERGED]
    assert not bool(X[:, :2].any())


def test_block_minres_complex_hermitian():
    jH, _ = jprob.hermitian_grid((8, 8))
    H = np.asarray(jH.todense())
    # scaled and shifted so that MINRES ends well inside n steps (near n
    # the count follows rounding)
    A = tsp.csr_from_dense(H / np.abs(np.linalg.eigvalsh(H)).max() + 2.0 * np.eye(64))
    rng = np.random.default_rng(5)
    B = rng.standard_normal((64, 3)) + 1j * rng.standard_normal((64, 3))
    _same_as_single(tsp.minres, _minres_block, A, B, tol=1e-10, max_iter=400)


def _complex_shifted(n=100):
    """A complex-symmetric tridiagonal A + i·I, conditioned so that COCG
    ends in 27-35 steps (an ill-conditioned one lets rounding move the
    counts)."""
    dense = (np.diag(np.linspace(2.0, 5.0, n)) + np.diag(np.full(n - 1, -1.0), 1)
             + np.diag(np.full(n - 1, -1.0), -1)).astype(np.complex128)
    dense += 1.0j * np.eye(n)
    return tsp.csr_from_dense(dense), dense


def test_block_cocg_columns_are_single_solves():
    A, dense = _complex_shifted()
    rng = np.random.default_rng(6)
    B = rng.standard_normal((100, 4)) + 1j * rng.standard_normal((100, 4))
    B[:, 1] = 0.0
    B[:, 2] = dense @ np.eye(100)[:, 3]
    X, info, steps, per = _same_as_single(tsp.cocg, _cocg_block, A, B, tol=1e-10,
                                          max_iter=500)
    assert bool((info.status == Status.CONVERGED).all()) and len(set(per)) >= 3
    assert steps == max(per)
    M = tsp.ComplexDiagPrecond.new(torch.as_tensor(np.diag(dense).copy()))
    _same_as_single(tsp.cocg, _cocg_block, A, B, M=M, tol=1e-10, max_iter=500)
    _, info, steps, _ = _same_as_single(tsp.cocg, _cocg_block, A, B, tol=1e-10, max_iter=0)
    assert steps == 0


def test_block_cocg_breakdown_freezes_one_column():
    """xᵀx = 0 for x = e₀ + i·e₁ makes ρ = 0 on the identity at the first
    step: that column stops with BREAKDOWN at 0 iterations and x = 0, and
    the other columns run on to their single solves' results."""
    n = 60
    dense = np.diag(np.linspace(1.0, 2.0, n)).astype(np.complex128)
    A = tsp.csr_from_dense(dense)
    B = np.zeros((n, 3), np.complex128)
    B[0, 0], B[1, 0] = 1.0, 1.0j
    rng = np.random.default_rng(7)
    B[:, 1] = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    B[:, 2] = rng.standard_normal(n)
    X, info, _, per = _same_as_single(tsp.cocg, _cocg_block, A, B, tol=1e-10, max_iter=200)
    assert int(info.status[0]) == Status.BREAKDOWN and per[0] == 0
    assert not bool(X[:, 0].any())
    assert int(info.status[1]) == int(info.status[2]) == Status.CONVERGED


@pytest.fixture(scope="module")
def group1(tmp_path_factory):
    with _dist_worker.one_rank_group(str(tmp_path_factory.mktemp("group1"))) as g:
        yield g


def _same_with_group(block, A, B, group, per_step, start, **kw):
    """The block solve with ``group`` (one rank) bitwise the solve without:
    X, every info field and the lockstep count; and the all-reduces it made
    ``start`` + ``per_step`` a lockstep iteration, whatever the width."""
    X, info, steps = block(A, torch.as_tensor(B), **kw)
    comm.reset_counts()
    Xg, info_g, steps_g = block(A, torch.as_tensor(B), group=group, **kw)
    assert torch.equal(X, Xg) and steps == steps_g
    for f in ("iterations", "residual", "status"):
        assert torch.equal(getattr(info, f), getattr(info_g, f)), f
    assert comm.counts()["all_reduce_sum"][0] == start + per_step * steps
    return steps


def test_block_solves_with_a_group_of_one_are_bitwise_without(group1):
    """``_minres_block``/``_cocg_block`` with ``group=`` on a gloo group of
    one rank give bitwise the solve without a group: every column reduction
    goes through ``all_reduce_sum``, whose one-rank sum is the rank's own
    partials. MINRES makes 2 all-reduces to start (4 with M: the β² gate)
    and 2 a lockstep iteration, COCG 3 and 3."""
    A, _ = _indefinite()
    rng = np.random.default_rng(11)
    B = rng.standard_normal((120, 4))
    B[:, 1] = 0.0
    assert _same_with_group(_minres_block, A, B, group1, 2, 2, tol=1e-10, max_iter=400) > 0
    P = tprob.poisson3d(6, 6, 6, dtype=np.float64)
    Bp = rng.standard_normal((216, 3))
    _same_with_group(_minres_block, P, Bp, group1, 2, 4, M=tsp.DiagPrecond.new(P.diagonal()),
                     tol=1e-10, max_iter=300)
    C, dense = _complex_shifted()
    Bc = rng.standard_normal((100, 3)) + 1j * rng.standard_normal((100, 3))
    _same_with_group(_cocg_block, C, Bc, group1, 3, 3, tol=1e-10, max_iter=500)
    M = tsp.ComplexDiagPrecond.new(torch.as_tensor(np.diag(dense).copy()))
    _same_with_group(_cocg_block, C, Bc, group1, 3, 3, M=M, tol=1e-10, max_iter=500)


@pytest.mark.parametrize("bands", ["int8", "bf16", "f32", "f64"])
@pytest.mark.parametrize("m", [1, 3, 12, 17])
def test_dia_spmm_plain_is_k1_plain_per_column(bands, m):
    A = tprob.poisson3d(7, 7, 7, dtype=np.float64 if bands == "f64" else np.float32)
    dia = A.to_dia()
    scale = {"int8": 1.0, "bf16": 2.5, "f32": 1.0 + 1e-3, "f64": 1.0 + 1e-9}[bands]
    op = tsp.PaddedDIA.from_dia(tsp.DIA(bands=dia.bands * scale, offsets=dia.offsets,
                                        shape=dia.shape), device="cpu")
    want = {"int8": torch.int8, "bf16": torch.bfloat16, "f32": torch.float32,
            "f64": torch.float64}[bands]
    assert op.bands.dtype == want
    X = torch.as_tensor(np.random.default_rng(m).standard_normal((A.shape[0], m))).to(
        op.vdtype)
    X2 = op.pad_block(X)
    Y = pd.dia_spmm_plain(op.bands, X2, op.offsets, op.h)
    assert tuple(Y.shape) == tuple(X2.shape) and Y.is_contiguous()
    for j in range(m):
        y = pd.dia_spmv_plain(op.bands, X2[:, j].contiguous(), op.offsets, op.h)
        assert torch.equal(Y[:, j], y), j
    assert torch.equal(pd.dia_spmm(op.bands, X2, op.offsets, op.h), Y)
    wide = tsp.DIA(bands=dia.bands.double() * scale, offsets=dia.offsets, shape=dia.shape)
    ref = np.stack([wide.matvec(X[:, j].double()).numpy() for j in range(m)], 1)
    np.testing.assert_allclose(op.unpad_block(Y).double().numpy(), ref, rtol=1e-5, atol=1e-5)


def test_dia_spmm_refuses_blocks_past_32_bit_indices():
    """K1b indexes a block in 32 bits: a block of SPMM_MAX_ENTRIES entries
    or more is refused before any launch (meta tensors: nothing is
    allocated)."""
    bands = torch.zeros((1, 256), device="meta")
    rows = 256 + 2 * 64
    m = pd.SPMM_MAX_ENTRIES // rows
    with pytest.raises(ValueError, match="32-bit"):
        pd.dia_spmm(bands, torch.empty((rows, m), device="meta"), (0,), 64)
    with pytest.raises(ValueError, match="the kernels run on CPU or CUDA"):
        pd.dia_spmm(bands, torch.empty((rows, m - 1), device="meta"), (0,), 64)


def test_padded_matmat_takes_complex_blocks_in_one_launch(monkeypatch):
    A = tprob.poisson3d(6, 6, 6)
    op = tsp.optimize(A, device="cpu")
    calls = []
    spmm = pd.dia_spmm
    monkeypatch.setattr(pd, "dia_spmm", lambda *a, **k: calls.append(a[1].shape) or
                        spmm(*a, **k))
    rng = np.random.default_rng(8)
    Z = torch.as_tensor(rng.standard_normal((216, 3)) + 1j * rng.standard_normal((216, 3))
                        ).to(torch.complex64)
    Y = op.unpad_block(op.matmat(op.pad_block(Z)))
    assert calls == [(op.padded_len, 6)]
    for j in range(3):
        y = op.unpad_vec(op.matvec(op.pad_vec(Z[:, j])))
        assert torch.equal(Y[:, j], y)
    from sprsolve_tpu_torch.multigrid import FlatViewOperator

    assert torch.equal(FlatViewOperator(op=op).matmat(Z), Y)
    assert len(calls) == 2


def test_shifted_operator_matches_the_jax_class():
    Aj, _ = jprob.sym_grid_laplacian((10, 10))
    dense = -np.asarray(Aj.todense())
    tA, jA = tsp.csr_from_dense(dense), jsp.csr_from_dense(dense)
    sig = 0.7
    S = tsp.ShiftedOperator(A=tA.to_dia(), shift=sig)
    Sj = JShifted(A=jA.to_dia(), shift=jnp.asarray(sig))
    rng = np.random.default_rng(9)
    x = rng.standard_normal(100)
    X = rng.standard_normal((100, 3))
    np.testing.assert_allclose(S.matvec(torch.as_tensor(x)).numpy(),
                               np.asarray(Sj.matvec(jnp.asarray(x))), rtol=1e-14, atol=1e-14)
    y, d = S.matvec_dot(torch.as_tensor(x))
    yj, dj = Sj.matvec_dot(jnp.asarray(x))
    np.testing.assert_allclose(float(d), float(dj), rtol=1e-13)
    np.testing.assert_allclose(S.matmat(torch.as_tensor(X)).numpy(),
                               np.asarray(Sj.matmat(jnp.asarray(X))), rtol=1e-14, atol=1e-14)
    np.testing.assert_allclose(S.diagonal().numpy(), np.asarray(Sj.diagonal()), rtol=1e-15)
    np.testing.assert_allclose(S.jacobi_precond().diag_inv.numpy(),
                               np.asarray(Sj.jacobi_precond().diag_inv), rtol=1e-15)
    # on the padded layout: the protocol forwards, the diagonal is un-laid,
    # and the Jacobi is re-laid
    A32 = tprob.poisson3d(6, 6, 6)
    op = tsp.optimize(A32, device="cpu")
    Sp = tsp.ShiftedOperator(A=op, shift=0.01)
    assert Sp.padded_len == op.padded_len and Sp.pad_vec is not None
    assert not hasattr(tsp.ShiftedOperator(A=A32, shift=1.0), "pad_vec")
    assert not hasattr(Sp, "matvec_wdot") and not hasattr(Sp, "orth_norm")
    x = torch.as_tensor(rng.standard_normal(216)).float()
    x2 = op.pad_vec(x)
    assert torch.equal(Sp.matvec(x2), op.matvec(x2) - 0.01 * x2)
    np.testing.assert_allclose(Sp.diagonal().numpy(), 6.0 - 0.01, rtol=1e-7)
    assert tuple(Sp.jacobi_precond().diag_inv.shape) == (op.padded_len,)
    b = torch.as_tensor(np.random.default_rng(10).standard_normal(216)).float()
    x, info = tsp.minres(Sp, op.pad_vec(b), tol=1e-5, max_iter=400)
    info.raise_if_error()
    r = A32.matvec(op.unpad_vec(x)) - 0.01 * op.unpad_vec(x) - b
    assert float(torch.linalg.norm(r) / torch.linalg.norm(b)) < 1e-4


def _triplets():
    rows = np.array([0, 1, 1, 2, 3, 3, 0, 4, 4], np.int64)
    cols = np.array([0, 1, 2, 2, 0, 3, 0, 4, 4], np.int64)
    vals = np.array([1.0, 2.0, -1.0, 3.0, 0.5, 4.0, 2.5, 1.0, -1.0])
    return rows, cols, vals


def test_csr_from_bcoo_matches_the_jax_function():
    """Duplicates sum (rows 0 and 4), padding entries at index == shape are
    dropped, and a torch CSR input gives the same CSR."""
    rows, cols, vals = _triplets()
    pad_r, pad_c = np.array([5, 5]), np.array([5, 5])
    r_all, c_all = np.concatenate([rows, pad_r]), np.concatenate([cols, pad_c])
    v_all = np.concatenate([vals, [7.0, 8.0]])
    jb = jsparse.BCOO((jnp.asarray(v_all), jnp.asarray(np.stack([r_all, c_all], 1))),
                      shape=(5, 5))
    jc = jsp.csr_from_bcoo(jb)
    tb = torch.sparse_coo_tensor(torch.as_tensor(np.stack([r_all, c_all])),
                                 torch.as_tensor(v_all), size=(5, 5), check_invariants=False)
    tc = tsp.csr_from_bcoo(tb)
    for f in ("data", "indices", "indptr"):
        np.testing.assert_array_equal(getattr(tc, f).numpy(), np.asarray(getattr(jc, f)))
    assert tc.shape == (5, 5)
    tcsr = torch.sparse_coo_tensor(torch.as_tensor(np.stack([rows, cols])),
                                   torch.as_tensor(vals), size=(5, 5)).coalesce().to_sparse_csr()
    tc2 = tsp.csr_from_bcoo(tcsr)
    for f in ("data", "indices", "indptr"):
        np.testing.assert_array_equal(getattr(tc2, f).numpy(), np.asarray(getattr(jc, f)))
    with pytest.raises(ValueError):
        tsp.csr_from_bcoo(torch.zeros(3, 3))


def test_check_operator_passes_a_good_operator_and_catches_a_broken_one():
    A = tprob.poisson3d(5, 5, 5)
    op = tsp.optimize(A, device="cpu")
    assert check_operator(op, op.pad_vec(torch.zeros(125)))
    assert check_operator(A.to_dia(), torch.zeros(125))
    assert tsp.debug.check_operator(tsp.ShiftedOperator(A=A.to_dia(), shift=0.5),
                                    torch.zeros(125))

    class Affine:          # A·x + 1: not linear
        shape = (125, 125)

        def matvec(self, x):
            return A.matvec(x) + 1.0

        def matvec_dot(self, x):
            y = self.matvec(x)
            return y, torch.sum(x * y)

    with pytest.raises(AssertionError, match="not linear"):
        check_operator(Affine(), torch.zeros(125))

    class WrongDot(Affine):
        def matvec(self, x):
            return A.matvec(x)

        def matvec_dot(self, x):
            y = self.matvec(x)
            return y, 2 * torch.sum(x * y)

    with pytest.raises(AssertionError, match="dot mismatch"):
        check_operator(WrongDot(), torch.zeros(125))
