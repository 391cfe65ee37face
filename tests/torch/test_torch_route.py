"""The banded f64/c128 route of ``optimize()`` and this slice's launch
counts, on the CPU.

- ``optimize()`` sends a banded float64 matrix to ``PaddedDIA`` and a
  complex128 one to ``ComplexPaddedDIA`` (the JAX package's XLA ``DIA``:
  its TPU kernels have no f64), ``prefer_kernels=False`` keeps ``DIA``, and
  a HybridDIA's f64 core is a ``PaddedDIA`` too.
- Through ``solve()`` on that route the f64 goldens hold: MINRES 34 on the
  8×8 folded grid at tol 1e-22 and 64 on the diagonal system at 1e-20
  (``tests/test_minres.py``), Jacobi-BiCGStab on the 20×20 Dirichlet grid
  equal to the JAX package's count at tol 1e-8 and 1e-17, and plain
  BiCGStab at 1e-17 within the band of ``tests/test_serial_parity.py:183``
  of the reference's 128 and of the JAX package's count; x within 1e-6
  (relative) of the JAX package's at tol 1e-8, 1e-12 at 1e-17 and 1e-10 for
  the MINRES goldens.
- ``chip_smoke.py`` phase 15 at a 10³ grid with ``device="cpu"``: each
  kernel wrapper replaced by a shim that counts its calls (a launch on the
  card), so every exact count it asserts (MINRES K1 1, K3 and K4 its + 1;
  Jacobi-BiCGStab K1 1, K2 2·its; COCG K5 its + 1; CS-MINRES K5 1, K6
  its + 1; complex BiCGStab K5 1, K7 2·its) holds here."""

import importlib
import os

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import sprsolve_tpu as jsp
from sprsolve_tpu.utils import problems as jprob
import sprsolve_tpu_torch as tsp
from sprsolve_tpu_torch.multigrid import FlatViewOperator
from sprsolve_tpu_torch.ops import fused
from sprsolve_tpu_torch.ops import padded_dia as pd
from sprsolve_tpu_torch.utils import problems as tprob

torch.set_num_threads(2)


def _band(its):
    return max(3, -(-its // 4))


def _c128(A):
    data = A.data.numpy().astype(np.complex128)
    data[A.indices.numpy() == A.row_ids.numpy()] += 0.5j
    return tsp.CSR.from_arrays(data, A.indices, A.indptr, A.shape)


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.complex64, np.complex128])
def test_banded_matrices_take_the_padded_kernels_in_their_dtype(dtype):
    A = tprob.poisson3d(6, 6, 6, dtype=np.float64)
    A = _c128(A) if np.iscomplexobj(np.zeros(1, dtype)) else A
    A = tsp.CSR.from_arrays(A.data.numpy().astype(dtype), A.indices, A.indptr, A.shape)
    op = tsp.optimize(A, device="cpu")
    if np.iscomplexobj(np.zeros(1, dtype)):
        assert isinstance(op, tsp.ComplexPaddedDIA) and op.dtype == torch.as_tensor(
            np.zeros(1, dtype)).dtype
    else:
        assert isinstance(op, tsp.PaddedDIA) and op.vdtype == torch.as_tensor(
            np.zeros(1, dtype)).dtype
        # the wide storage stays exact: int8 narrowing is an f32 route only
        assert op.bands.dtype == (torch.int8 if dtype == np.float32 else torch.float64)
    flat = tsp.optimize(A, prefer_kernels=False, device="cpu")
    assert type(flat) is tsp.DIA and flat.dtype == A.dtype
    x = np.random.default_rng(0).standard_normal(A.shape[0]).astype(dtype)
    xt = torch.from_numpy(x)
    y = op.unpad_vec(op.matvec(op.pad_vec(xt)))
    S = sps.csr_matrix((A.data.numpy(), A.indices.numpy(), A.indptr.numpy()), shape=A.shape)
    if dtype == np.float64:
        # K1's plain version sums a row's bands in DIA's order: bitwise (the
        # complex one sums the four real plane products instead)
        assert torch.equal(y, flat.matvec(xt))
    np.testing.assert_allclose(y.numpy(), S @ x, rtol=1e-5 if dtype in (np.float32, np.complex64)
                               else 1e-14, atol=1e-5)


def test_jax_package_keeps_f64_on_xla_dia():
    assert type(jsp.optimize(jprob.grid_laplacian_dirichlet((10, 10)))).__name__ == "DIA"
    assert isinstance(tsp.optimize(tprob.grid_laplacian_dirichlet((10, 10)), device="cpu"),
                      tsp.PaddedDIA)


def test_hybrid_core_is_padded_in_f64():
    A = tprob.sym_grid_laplacian((20, 20))[0]
    S = sps.csr_matrix((A.data.numpy(), A.indices.numpy(), A.indptr.numpy()), shape=A.shape)
    S = (S + sps.coo_matrix(([0.01, 0.01], ([0, 399], [399, 0])), shape=S.shape)).tocsr()
    H = tsp.HybridDIA.from_csr(tsp.csr_from_scipy(S), max_diags=8)
    assert isinstance(H.core, FlatViewOperator) and isinstance(H.core.op, tsp.PaddedDIA)
    assert H.core.op.vdtype == torch.float64
    Hf = tsp.HybridDIA.from_csr(tsp.csr_from_scipy(S), max_diags=8, prefer_kernels=False)
    assert type(Hf.core) is tsp.DIA
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(400))
    np.testing.assert_allclose(H.matvec(x).numpy(), S @ x.numpy(), rtol=1e-14, atol=1e-14)


@pytest.mark.parametrize("case,golden", [("sym_grid", 34), ("diag", 64)])
def test_minres_goldens_hold_through_solve(case, golden):
    make = {"sym_grid": tprob.sym_grid_laplacian, "diag": tprob.simple_diag_system}[case]
    tol = {"sym_grid": 1e-22, "diag": 1e-20}[case]
    A, rhs = make((8, 8))
    assert isinstance(tsp.optimize(A, device="cpu"), tsp.PaddedDIA)
    x, info = tsp.solve(A, rhs, method="minres", tol=tol, max_iter=300, device="cpu")
    assert info.converged and int(info.iterations) == golden
    assert float(info.residual) < tol
    jA, _ = {"sym_grid": jprob.sym_grid_laplacian, "diag": jprob.simple_diag_system}[case]((8, 8))
    xj, _ = jsp.solve(jA, rhs, method="minres", tol=tol, max_iter=300)
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=0,
                               atol=1e-10 * np.abs(np.asarray(xj)).max())


@pytest.mark.parametrize("tol", [1e-8, 1e-17])
@pytest.mark.parametrize("M", [None, "jacobi"])
def test_bicgstab_counts_through_solve(tol, M):
    shape = (20, 20)
    A, jA = tprob.grid_laplacian_dirichlet(shape), jprob.grid_laplacian_dirichlet(shape)
    b = np.zeros(400)
    tprob.set_boundary_condition(b, shape, lambda r, c: float(r + c))
    x, info = tsp.solve(A, b, method="bicgstab", M=M, tol=tol, max_iter=1500, device="cpu")
    xj, info_j = jsp.solve(jA, b, method="bicgstab", M=M, tol=tol, max_iter=1500)
    its, its_j = int(info.iterations), int(info_j.iterations)
    assert info.converged and bool(info_j.converged)
    if M == "jacobi":
        assert its == its_j            # 36 at 1e-8, 54 at 1e-17
    else:
        assert abs(its - its_j) <= _band(its_j)
    if tol == 1e-17 and M is None:
        assert abs(its - 128) <= _band(128)   # the reference's serial count
    # x within 1e-6 of the JAX package's at tol 1e-8 (the two stop at
    # residuals of 1e-8 on different iterations), 1e-12 at the 1e-17 floor
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=0,
                               atol=(1e-6 if tol > 1e-12 else 1e-12)
                               * np.abs(np.asarray(xj)).max())
    S = sps.csr_matrix((A.data.numpy(), A.indices.numpy(), A.indptr.numpy()), shape=A.shape)
    assert np.linalg.norm(S @ x.numpy() - b) / np.linalg.norm(b) < 10 * max(tol, 1e-15)


def test_c128_route_matches_the_jax_packages_counts():
    """COCG with the complex Jacobi on the c128 complex-symmetric fixture:
    ComplexPaddedDIA in the port, XLA's DIA in the JAX package."""
    A, rhs, _ = tprob.complex_symmetric_grid_with_diag((12, 12))
    jA, _, _ = jprob.complex_symmetric_grid_with_diag((12, 12))
    assert isinstance(tsp.optimize(A, device="cpu"), tsp.ComplexPaddedDIA)
    for method in ("cocg", "cs_minres", "bicgstab"):
        x, info = tsp.solve(A, rhs, method=method, M="jacobi", tol=1e-12, max_iter=600,
                            device="cpu")
        xj, info_j = jsp.solve(jA, rhs, method=method, M="jacobi", tol=1e-12, max_iter=600)
        assert info.converged and bool(info_j.converged)
        assert abs(int(info.iterations) - int(info_j.iterations)) <= _band(
            int(info_j.iterations)), method
        np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=0,
                                   atol=1e-9 * np.abs(np.asarray(xj)).max())


def _counting(orig):
    def shim(*args, **kwargs):
        shim.launches += 1
        return orig(*args, **kwargs)

    shim.launches = 0
    return shim


def test_phase15_counts_hold_on_the_cpu(monkeypatch):
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    monkeypatch.syspath_prepend(root)
    smoke = importlib.import_module("chip_smoke")
    for name in ("dia_spmv", "dia_spmm", "dia_wdot", "dia_dot", "dia_complex_spmv",
                 "dia_complex_dot", "dia_complex_wdot"):
        monkeypatch.setattr(pd, name, _counting(getattr(pd, name)))
    monkeypatch.setattr(fused, "orth_norm", _counting(fused.orth_norm))
    smoke.phase_front(torch.device("cpu"), grid=10, timed=False)
