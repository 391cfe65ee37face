"""Command line: solve a Matrix Market system from the shell.

Counterpart of ``sprsolve_tpu/__main__.py``, with its flags, messages,
return codes, report lines and output files: read A (.mtx) and b
(.npy/.mtx/text), pick a solver and a preconditioner, print the solve
report, and write x if asked.

    python -m sprsolve_tpu_torch solve A.mtx --rhs b.npy --method cg --precond amg \\
        --tol 1e-10 --max-iter 2000 --out x.npy
    python -m sprsolve_tpu_torch info A.mtx
    python -m sprsolve_tpu_torch eig A.mtx -k 4 --which SA
    python -m sprsolve_tpu_torch eig A.mtx -k 2 --sigma 3.5   # interior, near σ
    python -m sprsolve_tpu_torch eig P.mtx -k 4 --precond mg --grid 100,100,100

``solve`` and ``eig`` run on the CUDA device unless ``--device`` names
another (``--device cpu``); without CUDA and without ``--device`` they
print the error and exit with 2, having solved nothing.  The system keeps
the file's dtype (float64 or complex128: the f64/c128 kernels) unless
``--f32`` downcasts it.
"""

from __future__ import annotations

import argparse
import sys
import time


def _load_rhs(path, n, dtype):
    import numpy as np

    if path is None:
        return np.ones(n, dtype=dtype)
    if path.endswith(".npy"):
        b = np.load(path)
    elif path.endswith(".mtx"):
        from .utils.io import mmread

        m = mmread(path)
        b = m if isinstance(m, np.ndarray) else _dense(m)
        b = np.asarray(b).reshape(-1)
    else:
        b = np.loadtxt(path)
    return np.asarray(b, dtype=dtype).reshape(-1)


def _dense(A):
    """The CSR as a dense NumPy array (on the host)."""
    import scipy.sparse as sps

    from .sparse.containers import _host

    return sps.csr_matrix((_host(A.data), _host(A.indices), _host(A.indptr)),
                          shape=A.shape).toarray()


def _device(args):
    """The device ``--device`` names, else the CUDA device; prints the error
    and returns None when there is neither."""
    from .ops.optimize import default_device

    try:
        return default_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return None


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _cmd_info(args):
    import numpy as np

    from .sparse.containers import _host
    from .utils.io import mmread

    A = mmread(args.matrix)
    if isinstance(A, np.ndarray):
        print(f"{args.matrix}: dense array {A.shape} {A.dtype}")
        return 0
    m, n = A.shape
    print(f"{args.matrix}: {m} x {n}, nnz {A.nnz} "
          f"({A.nnz / max(m, 1):.2f}/row), dtype {_host(A.data).dtype}")
    if m == n:
        from .native import csr_bandwidth, csr_count_diagonals

        indptr, indices = _host(A.indptr), _host(A.indices)
        bw = csr_bandwidth(m, indptr, indices)
        nd = csr_count_diagonals(m, indptr, indices)
        print(f"bandwidth {bw}, distinct diagonals {nd}")
        if m <= 2000:
            dense = _dense(A)
            sym = np.allclose(dense, dense.T)
            herm = np.allclose(dense, dense.conj().T)
            print(f"symmetric: {sym}  hermitian: {herm}")
    return 0


def _cmd_solve(args):
    import numpy as np

    from . import errors, solve
    from .sparse.containers import CSR, _host
    from .utils.io import mmread

    device = _device(args)
    if device is None:
        return 2
    A = mmread(args.matrix)
    if isinstance(A, np.ndarray):
        print("error: matrix file is a dense array; expected sparse", file=sys.stderr)
        return 2
    if args.f32:
        dt = np.complex64 if np.iscomplexobj(_host(A.data)) else np.float32
        A = CSR.from_arrays(_host(A.data).astype(dt), A.indices, A.indptr, A.shape)
    b = _load_rhs(args.rhs, A.shape[0], _host(A.data).dtype)
    if b.shape[0] != A.shape[0]:
        print(f"error: rhs has {b.shape[0]} entries, matrix has {A.shape[0]} rows",
              file=sys.stderr)
        return 2

    M = args.precond if args.precond != "none" else None
    if args.method == "auto":
        # resolve here so that the report line names the method that ran;
        # --refine's inner solvers have no bicgstabl, so auto under --refine
        # takes the reference-parity nonsymmetric method
        from .api import _auto_method

        args.method = _auto_method(A, parity="reference" if args.refine else "fast")
    t0 = time.perf_counter()
    try:
        if args.refine:
            from .solvers import refine_solve

            if M not in (None, "jacobi"):
                print("error: --refine supports --precond none|jacobi", file=sys.stderr)
                return 2
            x, info = refine_solve(A, b, inner=args.method, M=M, tol=args.tol,
                                   max_refine=args.max_iter, device=device)
        else:
            x, info = solve(A, b, method=args.method, M=M, tol=args.tol,
                            max_iter=args.max_iter, device=device)
    except errors.SolverError as e:
        print(f"solver error: {e}", file=sys.stderr)
        return 1
    _sync(device)   # the launches are asynchronous: finish before the clock
    wall = time.perf_counter() - t0
    x_h = x.detach().cpu()
    r = A.matvec(x_h).numpy() - b
    relres = float(np.linalg.norm(r) / max(np.linalg.norm(b), 1e-300))
    status = errors.Status(int(info.status)).name
    print(
        f"{args.method}"
        + (f" + {args.precond}" if M is not None else "")
        + f": {int(info.iterations)} iterations, status {status}, "
        f"true rel-res {relres:.3e}, {wall:.3f} s (incl. compile)"
        + (" [refined]" if args.refine else "")
    )
    if args.out:
        np.save(args.out, x_h.numpy())
        print(f"wrote {args.out}")
    return 0 if status == "CONVERGED" else 1


def _cmd_eig(args):
    import numpy as np
    import torch

    from .scipy_compat import eigsh
    from .utils.io import mmread

    device = _device(args)
    if device is None:
        return 2
    A = mmread(args.matrix)
    if isinstance(A, np.ndarray):
        print("error: matrix file is a dense array; expected sparse", file=sys.stderr)
        return 2
    if A.shape[0] != A.shape[1]:
        print("error: eigensolver needs a square matrix", file=sys.stderr)
        return 2
    # --which defaults by mode: --sigma means shift-invert (LM, nearest
    # sigma); without a shift, LOBPCG serves the spectrum's ends (SA)
    which = args.which
    if which is None:
        which = "LM" if args.sigma is not None else "SA"
    if args.sigma is not None and which != "LM":
        print("error: --sigma (shift-invert) implies --which LM", file=sys.stderr)
        return 2
    if args.sigma is None and which == "LM":
        # scipy's eigsh default is LM, but without a shift an indefinite
        # spectrum has no LOBPCG analog: steer to the supported ends
        print("error: --which LM needs --sigma; use LA/SA for the spectrum's "
              "ends", file=sys.stderr)
        return 2
    precond = None
    if args.precond != "none":
        if args.sigma is not None:
            print("error: --precond applies to the LOBPCG path (no --sigma)",
                  file=sys.stderr)
            return 2
        if args.precond == "mg":
            # structured-grid multigrid: at scale the difference between
            # converging and not (the smallest grid eigenvalues cluster at O(h²))
            if not args.grid:
                print("error: --precond mg needs --grid NX[,NY[,NZ]]", file=sys.stderr)
                return 2
            grid = tuple(int(g) for g in args.grid.split(","))
            if int(np.prod(grid)) != A.shape[0]:
                print(f"error: --grid {args.grid} has {int(np.prod(grid))} "
                      f"points, matrix has {A.shape[0]} rows", file=sys.stderr)
                return 2
            from .multigrid import GridMGPrecond

            precond = GridMGPrecond.from_csr(A, grid, device=device)
        else:
            precond = args.precond   # "jacobi": built inside eigsh
    if args.interior == "rational" and args.sigma is None:
        print("error: --interior rational needs --sigma", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    try:
        if args.sigma is not None and args.interior == "rational":
            # the FEAST-style contour filter: complex-shifted COCG inner
            # solves, conditioned independently of the eigenvalue crowding
            # at sigma (solvers/rational.py)
            from .solvers import rational_filter_eigs

            lam, X, _info = rational_filter_eigs(A, args.k, args.sigma, tol=args.tol,
                                                 device=device)
            _sync(device)
            w, v = lam.cpu().numpy(), X.cpu().numpy()
        else:
            w, v = eigsh(A, k=args.k, sigma=args.sigma, which=which, tol=args.tol,
                         maxiter=args.max_iter, precond=precond, device=device)
    except NotImplementedError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    wall = time.perf_counter() - t0
    Av = np.stack([A.matvec(torch.as_tensor(v[:, i])).numpy() for i in range(v.shape[1])],
                  axis=1)
    rel = np.linalg.norm(Av - v * w[None, :], axis=0) / np.maximum(np.abs(w), 1e-300)
    kind = (f"nearest sigma={args.sigma:g}" if args.sigma is not None
            else {"LA": "largest", "SA": "smallest"}[which])
    print(f"{args.k} eigenpairs ({kind}), {wall:.3f} s (incl. compile)")
    for i in range(len(w)):
        print(f"  lambda[{i}] = {w[i]:+.10e}   rel-res {rel[i]:.2e}")
    if args.out:
        np.savez(args.out, w=w, v=v)
        print(f"wrote {args.out}")
    return 0 if float(rel.max()) <= max(args.tol * 50, 1e-6) else 1


def _add_device(p):
    p.add_argument(
        "--device", default=None,
        help="torch device to solve on (default: the CUDA device; 'cpu' runs on "
        "the CPU)",
    )


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m sprsolve_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_info = sub.add_parser("info", help="print matrix statistics")
    p_info.add_argument("matrix", help="Matrix Market file")
    p_info.set_defaults(fn=_cmd_info)

    p_solve = sub.add_parser("solve", help="solve A x = b")
    p_solve.add_argument("matrix", help="Matrix Market file for A")
    p_solve.add_argument("--rhs", help=".npy/.mtx/text file for b (default: ones)")
    p_solve.add_argument(
        "--method", default="auto",
        choices=["auto", "bicgstab", "bicgstabl", "ca_bicgstab", "ca_cg",
                 "cg", "cg_single_sync", "cgs", "tfqmr", "minres",
                 "cs_minres", "cocg", "gmres", "fgmres", "idrs", "lsqr"],
    )
    p_solve.add_argument(
        "--precond", default="none",
        choices=["none", "jacobi", "ilu0", "ic0", "block_jacobi", "amg"],
    )
    p_solve.add_argument("--tol", type=float, default=1e-8)
    p_solve.add_argument("--max-iter", type=int, default=1000)
    p_solve.add_argument("--out", help="write the solution to this .npy file")
    p_solve.add_argument(
        "--f32", action="store_true",
        help="downcast the system to f32/c64 (by default it keeps the file's "
        "f64/c128)",
    )
    p_solve.add_argument(
        "--refine", action="store_true",
        help="mixed-precision iterative refinement: f64/c128 accuracy with "
        "--method as the f32/c64 inner solver (max-iter = outer steps)",
    )
    _add_device(p_solve)
    p_solve.set_defaults(fn=_cmd_solve)

    p_eig = sub.add_parser("eig", help="k eigenpairs of a symmetric/Hermitian matrix")
    p_eig.add_argument("matrix", help="Matrix Market file for A")
    p_eig.add_argument("-k", type=int, default=6, help="number of eigenpairs")
    p_eig.add_argument(
        "--which", default=None, choices=["LA", "SA", "LM"],
        help="LA/SA: largest/smallest algebraic (LOBPCG); "
        "LM with --sigma: nearest sigma (shift-invert). "
        "Default: LM when --sigma is given, else SA",
    )
    p_eig.add_argument(
        "--sigma", type=float, default=None,
        help="interior target: return the k eigenvalues nearest this",
    )
    p_eig.add_argument(
        "--interior", default="shift-invert", choices=["shift-invert", "rational"],
        help="interior method with --sigma: 'shift-invert' (LOBPCG on "
        "(A-sigma I)^-1, MINRES inner solves) or 'rational' (FEAST-style "
        "contour filter, complex-shifted COCG inner solves: the fast path "
        "when sigma sits deep in a dense spectrum; real-symmetric matrices "
        "only)",
    )
    p_eig.add_argument("--tol", type=float, default=1e-8)
    p_eig.add_argument("--max-iter", type=int, default=200)
    p_eig.add_argument(
        "--precond", default="none", choices=["none", "jacobi", "mg"],
        help="LOBPCG preconditioner (LA/SA only): 'mg' needs --grid and is "
        "the choice at scale on a structured grid",
    )
    p_eig.add_argument(
        "--grid", default=None, help="structured grid shape NX[,NY[,NZ]] for --precond mg",
    )
    p_eig.add_argument("--out", help="write w/v to this .npz file")
    _add_device(p_eig)
    p_eig.set_defaults(fn=_cmd_eig)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
