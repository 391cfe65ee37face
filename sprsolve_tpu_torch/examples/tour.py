"""Tour of the surface, the counterpart of ``examples/tour.py``: every solver
family and preconditioner on small problems, each with its true residual.
A user of the reference crate can skim it to find each capability.

Run: python -m sprsolve_tpu_torch.examples.tour [--device cpu]
(default: the CUDA device)
"""

from __future__ import annotations

import argparse
import io

import numpy as np
import scipy.sparse as sps
import torch

import sprsolve_tpu_torch as spt
from sprsolve_tpu_torch import scipy_compat
from sprsolve_tpu_torch.ops.optimize import default_device
from sprsolve_tpu_torch.sparse.containers import _host
from sprsolve_tpu_torch.utils import mmread, mmwrite, problems


def scipy_of(A: spt.CSR) -> sps.csr_matrix:
    return sps.csr_matrix((_host(A.data), _host(A.indices), _host(A.indptr)), shape=A.shape)


def relres(A, x, b) -> float:
    r = scipy_of(A) @ _host(x) - b
    return float(np.linalg.norm(r) / np.linalg.norm(b))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m sprsolve_tpu_torch.examples.tour")
    ap.add_argument("--device", default=None, help="default: the CUDA device")
    dev = default_device(ap.parse_args(argv).device)
    on = dict(device=dev)

    # --- the reference's own flagship workload --------------------------------
    A = problems.grid_laplacian_dirichlet((20, 20))
    b = np.zeros(400)
    problems.set_boundary_condition(b, (20, 20), lambda r, c: float(r + c))

    x, (iters, _) = spt.BiCGStab.new(A, 400, **on).solve(b, max_iter=1500, tol=1e-15)
    print(f"BiCGStab (object API):      {iters:4d} iters  rel-res {relres(A, x, b):.2e}")

    x, info = spt.solve(A, b, M="jacobi", tol=1e-15, max_iter=1500, **on)
    print(f"BiCGStab + Jacobi:          {int(info.iterations):4d} iters  "
          f"rel-res {relres(A, x, b):.2e}")

    # --- the SPD path: CG / MINRES with the stronger preconditioners ----------
    Aspd = spt.csr_from_scipy(-scipy_of(problems.sym_grid_laplacian((24, 24))[0]))
    bspd = np.random.default_rng(0).standard_normal(576)

    for name, M in [
        ("CG  + block-Jacobi", spt.BlockJacobiPrecond.from_csr(Aspd, block_size=16, **on)),
        ("CG  + IC(0)", spt.IC0Precond.from_csr(Aspd, **on)),
        ("CG  + Chebyshev(auto)", spt.ChebyshevPrecond.auto(Aspd.to_dia(**on), degree=6)),
        ("CG  + multigrid", spt.GridMGPrecond.from_csr(Aspd, (24, 24), coarse_max=36, **on)),
    ]:
        x, info = spt.solve(Aspd, bspd, method="cg", M=M, tol=1e-10, max_iter=2000, **on)
        print(f"{name:27s} {int(info.iterations):4d} iters  "
              f"rel-res {relres(Aspd, x, bspd):.2e}")

    colors = spt.greedy_color(Aspd)
    ssor = spt.MaskedGSPrecond(
        A=Aspd.to_dia(**on), diag=Aspd.diagonal().to(dev),
        masks=spt.color_masks(colors, **on), omega=1.5, symmetric=True)
    x, info = spt.solve(Aspd, bspd, method="minres", M=ssor, tol=1e-10, max_iter=2000, **on)
    print(f"{'MINRES + SSOR':27s} {int(info.iterations):4d} iters  "
          f"rel-res {relres(Aspd, x, bspd):.2e}")

    # --- general nonsymmetric: GMRES -------------------------------------------
    x, info = spt.solve(A, b, method="gmres", restart=32, tol=1e-12, max_iter=1000, **on)
    print(f"{'GMRES(32)':27s} {int(info.iterations):4d} iters  rel-res {relres(A, x, b):.2e}")

    # --- inner-outer: FGMRES with a budgeted inner CG as the preconditioner ---
    Minner = spt.InnerSolvePrecond(
        A=Aspd.to(dev), inner_M=spt.DiagPrecond.new(Aspd.diagonal(), **on), method="cg",
        iters=8)
    x, info = spt.solve(Aspd, bspd, method="fgmres", M=Minner, restart=30, tol=1e-10,
                        max_iter=600, **on)
    print(f"{'FGMRES(30) + inner CG(8)':27s} {int(info.iterations):4d} iters  "
          f"rel-res {relres(Aspd, x, bspd):.2e}")

    # --- hard nonsymmetric: IDR(s) ---------------------------------------------
    x, info = spt.solve(A, b, method="idrs", s=4, tol=1e-12, max_iter=3000, **on)
    print(f"{'IDR(4)':27s} {int(info.iterations):4d} SpMVs  rel-res {relres(A, x, b):.2e}")

    # --- complex spectra: BiCGStab(2) converges where plain BiCGStab fails
    # (the 24x24 seed-1 strongly skewed system of tests/test_bicgstabl.py)
    AL = scipy_of(problems.grid_laplacian_dirichlet((24, 24))).toarray()
    rng_l = np.random.default_rng(1)
    n_l = AL.shape[0]
    skew = np.triu(rng_l.standard_normal((n_l, n_l)) * (rng_l.random((n_l, n_l)) < 0.01))
    skew = skew - skew.T
    Ask = spt.csr_from_dense(AL + 0.5 * skew)
    bsk = rng_l.standard_normal(n_l)
    x, info = spt.solve(Ask, bsk, method="bicgstabl", l=2, tol=1e-10, max_iter=3000,
                        optimize_layout=False, **on)
    print(f"{'BiCGStab(2), skewed':27s} {int(info.iterations):4d} cycles "
          f"rel-res {relres(Ask, x, bsk):.2e}  (plain BiCGStab fails here)")

    # --- complex symmetric: CS-MINRES (the solver the reference never tests)
    Ac, bc, _ = problems.complex_symmetric_grid_with_diag((12, 12))
    xc, info = spt.cs_minres(Ac.to(dev), torch.as_tensor(bc, device=dev), tol=1e-12,
                             max_iter=600)
    print(f"{'CS-MINRES (c128)':27s} {int(info.iterations):4d} iters  "
          f"rel-res {relres(Ac, xc, bc):.2e}")

    # COCG: the cheap complex-symmetric iteration (one SpMV per iteration)
    # with the complex Jacobi, beyond the reference's surface
    xg, info = spt.solve(Ac, bc, method="cocg", M="jacobi", tol=1e-12, max_iter=600, **on)
    print(f"{'COCG + complex Jacobi':27s} {int(info.iterations):4d} iters  "
          f"rel-res {relres(Ac, xg, bc):.2e}")

    # preconditioned CS-MINRES (beyond the reference): the real 1/|d|
    # Jacobi, built by solve() from the matrix diagonal
    xcp, info = spt.solve(Ac, bc, method="cs_minres", M="jacobi", tol=1e-12,
                          max_iter=600, **on)
    print(f"{'CS-MINRES + |d| Jacobi':27s} {int(info.iterations):4d} iters  "
          f"rel-res {relres(Ac, xcp, bc):.2e}")

    # --- unstructured complex: ComplexBSR through plain solve() ----------------
    rng = np.random.default_rng(42)
    S = sps.random(400, 400, density=0.02, random_state=42, format="csr")
    S = S + sps.eye(400) * 8
    Sc = sps.csr_matrix((S.data * (1 + 0.6j * rng.standard_normal(S.nnz)), S.indices,
                         S.indptr), shape=S.shape)
    Au = spt.csr_from_scipy(Sc)
    bu = Sc @ (rng.standard_normal(400) + 1j * rng.standard_normal(400))
    xu, info = spt.solve(Au, bu, method="bicgstab", M="jacobi", tol=1e-10, max_iter=800,
                         **on)
    print(f"{'unstructured c128 (BSR)':27s} {int(info.iterations):4d} iters  "
          f"rel-res {relres(Au, xu, bu):.2e}")

    # --- least squares: LSQR ----------------------------------------------------
    rng = np.random.default_rng(1)
    dense = rng.standard_normal((120, 40)) * (rng.random((120, 40)) < 0.2)
    dense[np.arange(40), np.arange(40)] += 3.0
    Als = spt.csr_from_dense(dense)
    bls = rng.standard_normal(120)
    xls, info = spt.solve(Als, bls, method="lsqr", tol=1e-12, max_iter=400, **on)
    nrm = np.linalg.norm(dense.T @ (bls - dense @ _host(xls)))
    print(f"{'LSQR (120x40)':27s} {int(info.iterations):4d} iters  ||A^T r|| {nrm:.2e}")

    # --- eigenpairs: LOBPCG -----------------------------------------------------
    X0 = torch.as_tensor(rng.standard_normal((576, 3)))
    lam, _, info = spt.lobpcg(
        Aspd.to(dev), X0, M=spt.GridMGPrecond.from_csr(Aspd, (24, 24), coarse_max=36, **on),
        tol=1e-8, max_iter=200)
    print(f"{'LOBPCG smallest 3':27s} {int(info.iterations):4d} iters  "
          f"lambda = {np.array2string(_host(lam), precision=4)}")

    # interior eigenpairs near a target: shift-invert (LOBPCG over
    # (A - sigma I)^-1, MINRES inner solves)
    lam_si, _, info = spt.shift_invert_eigs(Aspd, 3, 2.0, tol=1e-7, max_iter=200, **on)
    print(f"{'shift-invert eigs @ 2.0':27s} {int(info.iterations):4d} iters  "
          f"lambda = {np.array2string(np.sort(_host(lam_si)), precision=4)}")

    # --- f64 accuracy from f32 inner solves: iterative refinement -------------
    xr, info = spt.refine_solve(Aspd, bspd, inner="cg", tol=1e-13, **on)
    print(f"{'refine_solve (f64 via f32)':27s} {int(info.iterations):4d} outer  "
          f"rel-res {relres(Aspd, xr, bspd):.2e}")

    # --- algebraic multigrid on an unstructured matrix -------------------------
    rng_u = np.random.default_rng(7)
    W = np.zeros((700, 700))
    pts = rng_u.random((700, 2))
    d2 = ((pts[:, None] - pts[None]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    nb = np.argsort(d2, 1)[:, :5]
    W[np.repeat(np.arange(700), 5), nb.ravel()] = 1
    W = np.maximum(W, W.T)
    Lg = spt.csr_from_dense(np.diag(W.sum(1)) - W + 0.05 * np.eye(700))
    bg = rng_u.standard_normal(700)
    xg, info = spt.solve(Lg, bg, method="cg", M="amg", tol=1e-10, max_iter=2000, **on)
    print(f"{'CG + amg (unstructured)':27s} {int(info.iterations):4d} iters  "
          f"rel-res {relres(Lg, xg, bg):.2e}")

    # --- file IO: a Matrix Market round trip -----------------------------------
    buf = io.StringIO()
    mmwrite(buf, A, comment="Dirichlet Laplacian from the tour")
    buf.seek(0)
    A_rt = mmread(buf)
    x, info = spt.solve(A_rt, b, tol=1e-12, max_iter=1500, **on)
    print(f"{'mmread/mmwrite round trip':27s} {int(info.iterations):4d} iters  "
          f"rel-res {relres(A, x, b):.2e}")

    # --- the scipy calling convention ------------------------------------------
    x, code = scipy_compat.bicgstab(A, b, rtol=1e-12, **on)
    print(f"{'scipy_compat.bicgstab':27s} code {code}  rel-res {relres(A, x, b):.2e}")

    # --- amortized re-solves ----------------------------------------------------
    handle = spt.prepare(A, M="jacobi", tol=1e-12, max_iter=1500, **on)
    x1, _ = handle(b)
    _, info2 = handle(np.roll(b, 7), x0=x1)   # warm start from the last solution
    print(f"{'prepare() re-solve':27s} {int(info2.iterations):4d} iters (warm-started)")

    print("tour complete.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
