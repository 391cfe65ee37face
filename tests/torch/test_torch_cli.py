"""Cross tests of ``python -m sprsolve_tpu_torch`` against the JAX
package's CLI (the 11 cases of ``tests/test_cli.py``): each case runs both
``main``s on one ``.mtx`` file and compares what they print (the method,
the iterations within the band of ``tests/test_serial_parity.py:183``,
max(3, ⌈its/4⌉), and the status), the solution each writes (within 1e-10
relative, f64) and the return codes; eigenvalues agree within 1e-7.  The
port's ``solve`` and ``eig`` get ``--device cpu``; one more case checks
that without CUDA and without ``--device`` the command exits nonzero and
solves nothing."""

import math

import numpy as np
import pytest
import torch

import sprsolve_tpu as jsp
from sprsolve_tpu.__main__ import main as jmain
from sprsolve_tpu.utils import problems as jprob
from sprsolve_tpu.utils.io import mmwrite as jmmwrite
import sprsolve_tpu_torch as tsp
from sprsolve_tpu_torch.__main__ import main as tmain

torch.set_num_threads(2)
CPU = ["--device", "cpu"]


def _band(its):
    return max(3, -(-its // 4))


def _run_both(capsys, argv, port_extra=CPU):
    """(rc, stdout) of the JAX package's main and of the port's."""
    rc_j = jmain(list(argv))
    out_j = capsys.readouterr().out
    rc_t = tmain(list(argv) + list(port_extra))
    out_t = capsys.readouterr().out
    return (rc_j, out_j), (rc_t, out_t)


def _report(out: str):
    """(method, iterations, status, true rel-res) of a solve report line."""
    line = out.splitlines()[0]
    head, rest = line.split(": ", 1)
    return (head, int(rest.split(" iterations")[0]), rest.split("status ")[1].split(",")[0],
            float(rest.split("true rel-res ")[1].split(",")[0]))


def _same_solve(jres, tres):
    (rc_j, out_j), (rc_t, out_t) = jres, tres
    assert rc_j == rc_t
    hj, itj, sj, rj = _report(out_j)
    ht, itt, st, rt = _report(out_t)
    assert (hj, sj) == (ht, st)
    assert abs(itt - itj) <= _band(itj), (itt, itj)
    return rj, rt


def _lambdas(out: str):
    return np.array([float(line.split("=")[1].split()[0])
                     for line in out.splitlines() if "lambda[" in line])


@pytest.fixture()
def lap_mtx(tmp_path):
    A = jprob.grid_laplacian_dirichlet((10, 10))
    p = tmp_path / "lap.mtx"
    jmmwrite(p, A)
    b = np.zeros(100)
    jprob.set_boundary_condition(b, (10, 10), lambda r, c: float(r + c))
    bp = tmp_path / "b.npy"
    np.save(bp, b)
    return A, str(p), b, str(bp)


@pytest.fixture()
def sym_mtx(tmp_path):
    A, _ = jprob.sym_grid_laplacian((8, 8))
    p = tmp_path / "sym.mtx"
    jmmwrite(p, A)
    return np.asarray(A.todense()), str(p)


def test_info(lap_mtx, capsys):
    _, path, _, _ = lap_mtx
    (rc_j, out_j), (rc_t, out_t) = _run_both(capsys, ["info", path], port_extra=())
    assert rc_j == rc_t == 0
    assert out_t == out_j
    assert "100 x 100" in out_t and "symmetric" in out_t


def test_solve_writes_solution(lap_mtx, tmp_path, capsys):
    A, path, b, bpath = lap_mtx
    xs = {}
    for name, main in (("jax", jmain), ("port", tmain)):
        out = tmp_path / f"x_{name}.npy"
        rc = main(["solve", path, "--rhs", bpath, "--method", "bicgstab", "--precond",
                   "jacobi", "--tol", "1e-12", "--max-iter", "1500", "--out", str(out)]
                  + (CPU if name == "port" else []))
        xs[name] = (rc, capsys.readouterr().out, np.load(out))
    rj, rt = _same_solve(xs["jax"][:2], xs["port"][:2])
    assert xs["port"][0] == 0 and "CONVERGED" in xs["port"][1] and rt < 1e-10
    x, xj = xs["port"][2], xs["jax"][2]
    assert x.dtype == np.float64
    np.testing.assert_allclose(x, xj, rtol=0, atol=1e-10 * np.abs(xj).max())
    r = np.asarray(A.todense()) @ x - b
    assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-10


def test_solve_default_rhs_and_amg(lap_mtx, capsys):
    _, path, _, _ = lap_mtx
    jres, tres = _run_both(capsys, ["solve", path, "--method", "bicgstab", "--precond",
                                    "amg", "--tol", "1e-10", "--max-iter", "2000"])
    _same_solve(jres, tres)
    assert tres[0] == 0 and "CONVERGED" in tres[1]


def test_solve_bad_rhs_length(lap_mtx, tmp_path, capsys):
    _, path, _, _ = lap_mtx
    bad = tmp_path / "bad.npy"
    np.save(bad, np.ones(7))
    assert jmain(["solve", path, "--rhs", str(bad)]) == 2
    assert "rhs has 7 entries" in capsys.readouterr().err
    assert tmain(["solve", path, "--rhs", str(bad)] + CPU) == 2
    assert "rhs has 7 entries" in capsys.readouterr().err


def test_solve_refine_flag(lap_mtx, capsys):
    _, path, _, bpath = lap_mtx
    jres, tres = _run_both(capsys, ["solve", path, "--rhs", bpath, "--method", "bicgstab",
                                    "--precond", "jacobi", "--refine", "--tol", "1e-13",
                                    "--max-iter", "20"])
    rj, rt = _same_solve(jres, tres)
    assert tres[0] == 0 and "[refined]" in tres[1] and rt < 1e-12


def test_solve_auto_picks_minres(sym_mtx, capsys):
    _, path = sym_mtx
    jres, tres = _run_both(capsys, ["solve", path, "--tol", "1e-10", "--max-iter", "500"])
    _same_solve(jres, tres)
    assert tres[0] == 0 and tres[1].startswith("minres") and "CONVERGED" in tres[1]


def test_eig_smallest(sym_mtx, capsys):
    dense, path = sym_mtx
    (rc_j, out_j), (rc_t, out_t) = _run_both(
        capsys, ["eig", path, "-k", "3", "--which", "SA", "--tol", "1e-8"])
    assert rc_j == rc_t == 0
    ref = np.sort(np.linalg.eigvalsh(dense))[:3]
    np.testing.assert_allclose(np.sort(_lambdas(out_t)), ref, rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(_lambdas(out_t), _lambdas(out_j), rtol=0, atol=1e-7)


def test_eig_shift_invert(sym_mtx, tmp_path, capsys):
    dense, path = sym_mtx
    full = np.linalg.eigvalsh(dense)
    sigma = float((full[3] + full[4]) / 2)   # between two interior eigenvalues
    out = tmp_path / "eig.npz"
    (rc_j, out_j), (rc_t, out_t) = _run_both(
        capsys, ["eig", path, "-k", "2", "--which", "LM", "--sigma", repr(sigma),
                 "--tol", "1e-8", "--out", str(out)])
    assert rc_j == rc_t == 0
    ref = sorted(full, key=lambda lam: abs(lam - sigma))[:2]
    np.testing.assert_allclose(sorted(_lambdas(out_t)), sorted(ref), rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(_lambdas(out_t), _lambdas(out_j), rtol=0, atol=1e-7)
    saved = np.load(out)   # the port's, written last
    np.testing.assert_allclose(saved["w"], _lambdas(out_t), rtol=1e-9)
    assert saved["v"].shape == (64, 2)


def test_eig_lm_without_sigma_errors(sym_mtx, capsys):
    _, path = sym_mtx
    assert jmain(["eig", path, "--which", "LM"]) == 2
    assert "--sigma" in capsys.readouterr().err
    assert tmain(["eig", path, "--which", "LM"] + CPU) == 2
    assert "--sigma" in capsys.readouterr().err


def test_eig_mg_precond(tmp_path, capsys):
    """--precond mg --grid: multigrid-preconditioned LOBPCG, and its guard
    rails (mg without --grid, a wrong grid size, a preconditioner with
    --sigma)."""
    A = jprob.poisson3d(8, 8, 8, dtype=np.float64)
    p = tmp_path / "p3d.mtx"
    jmmwrite(p, A)
    (rc_j, out_j), (rc_t, out_t) = _run_both(
        capsys, ["eig", str(p), "-k", "2", "--tol", "1e-7", "--precond", "mg",
                 "--grid", "8,8,8"])
    assert rc_j == rc_t == 0
    l1 = 3 * (2 * math.sin(math.pi / 18)) ** 2
    assert abs(_lambdas(out_t)[0] - l1) < 1e-6
    np.testing.assert_allclose(_lambdas(out_t), _lambdas(out_j), rtol=0, atol=1e-7)
    for argv in (["eig", str(p), "--precond", "mg"],
                 ["eig", str(p), "--precond", "mg", "--grid", "4,4,4"],
                 ["eig", str(p), "--precond", "jacobi", "--sigma", "1.0"]):
        assert jmain(argv) == tmain(argv + CPU) == 2


def test_eigsh_precond_extension():
    """scipy_compat.eigsh(precond=...): the 'jacobi' string and a built
    multigrid, as tests/test_cli.py checks them for the JAX package."""
    from sprsolve_tpu import scipy_compat as J
    from sprsolve_tpu_torch import scipy_compat as T

    A = jprob.poisson3d(8, 8, 8, dtype=np.float64)
    At = tsp.CSR.from_arrays(np.asarray(A.data), np.asarray(A.indices),
                             np.asarray(A.indptr), A.shape)
    l1 = 3 * (2 * math.sin(math.pi / 18)) ** 2
    M = tsp.GridMGPrecond.from_csr(At, (8, 8, 8), device="cpu")
    w, _ = T.eigsh(At, k=2, which="SA", tol=1e-8, maxiter=100, precond=M, device="cpu")
    wj, _ = J.eigsh(A, k=2, which="SA", tol=1e-8, maxiter=100,
                    precond=jsp.GridMGPrecond.from_csr(A, (8, 8, 8)))
    assert abs(float(w[0]) - l1) < 1e-6
    np.testing.assert_allclose(w, np.asarray(wj), rtol=0, atol=1e-7)
    w2 = T.eigsh(At, k=2, which="SA", tol=1e-8, maxiter=200, precond="jacobi",
                 return_eigenvectors=False, device="cpu")
    assert abs(float(w2[0]) - l1) < 1e-6
    with pytest.raises(NotImplementedError):
        T.eigsh(At, k=2, sigma=1.0, precond="jacobi", device="cpu")
    with pytest.raises(NotImplementedError):
        T.eigsh(At, k=2, which="SA", precond="ilu0", device="cpu")


def test_no_cuda_and_no_device_solves_nothing(lap_mtx, tmp_path, capsys):
    """Without CUDA and without --device, solve and eig print the error of
    the default device and exit with 2; nothing is solved or written."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device exists")
    _, path, _, bpath = lap_mtx
    out = tmp_path / "x.npy"
    assert tmain(["solve", path, "--rhs", bpath, "--out", str(out)]) == 2
    captured = capsys.readouterr()
    assert "no CUDA device" in captured.err and captured.out == ""
    assert not out.exists()
    assert tmain(["eig", path, "-k", "2", "--which", "SA"]) == 2
    assert "no CUDA device" in capsys.readouterr().err
    # info reads the file on the host and needs no device
    assert tmain(["info", path]) == 0
