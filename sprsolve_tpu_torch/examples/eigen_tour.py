"""Tour of the eigensolvers, the counterpart of ``examples/eigen_tour.py``:
which method for which eigenpairs.

- the ends of the spectrum (smallest/largest) -> lobpcg (with a
  preconditioner at scale: multigrid decides convergence there)
- interior, near sigma                         -> shift_invert_eigs (LOBPCG
  on (A - sigma I)^-1, tolerant of inexact inner solves)
- interior, near sigma, where the spectrum is
  not too dense there                          -> rational_filter_eigs (a
  FEAST-style contour filter; complex-shifted COCG inner solves)

Each has a row-partitioned form over the ranks of a ``torch.distributed``
group: ``parallel.distributed_lobpcg``, ``distributed_shift_invert_eigs``
and ``distributed_rational_filter_eigs`` (``distributed_demo`` runs the
first).

Run: python -m sprsolve_tpu_torch.examples.eigen_tour [--device cpu]
(default: the CUDA device)
"""

from __future__ import annotations

import argparse

import numpy as np
import scipy.sparse as sps

import sprsolve_tpu_torch as spt
from sprsolve_tpu_torch import scipy_compat
from sprsolve_tpu_torch.errors import Status
from sprsolve_tpu_torch.ops.optimize import default_device
from sprsolve_tpu_torch.sparse.containers import _host
from sprsolve_tpu_torch.utils import problems


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m sprsolve_tpu_torch.examples.eigen_tour")
    ap.add_argument("--device", default=None, help="default: the CUDA device")
    dev = default_device(ap.parse_args(argv).device)

    side = 24
    n = side * side
    L, _ = problems.sym_grid_laplacian((side, side))
    S = -sps.csr_matrix((_host(L.data), _host(L.indices), _host(L.indptr)), shape=L.shape)
    A = spt.csr_from_scipy(S)                 # the SPD grid Laplacian
    w = np.linalg.eigvalsh(S.toarray())       # a dense oracle for the demo

    # --- the spectrum's end: LOBPCG (Jacobi M; at scale use GridMGPrecond)
    lam, _, info = spt.lobpcg(
        A.to_dia(device=dev), np.random.default_rng(0).standard_normal((n, 4)),
        M=spt.DiagPrecond.new(A.diagonal(), device=dev), tol=1e-8, max_iter=200)
    print(f"lobpcg smallest-4: {Status(int(info.status)).name}, "
          f"lam {np.sort(_host(lam))} (oracle {w[:4]})")

    # --- interior, shift-invert: the k nearest sigma through (A - sigma I)^-1
    sigma = 2.0
    lam_si, _, info_si = spt.shift_invert_eigs(A, 3, sigma, tol=1e-6, device=dev)
    want = np.sort(w[np.argsort(np.abs(w - sigma))[:3]])
    print(f"shift-invert nearest {sigma}: {Status(int(info_si.status)).name}, "
          f"lam {np.sort(_host(lam_si))} (oracle {want})")

    # --- interior, rational filter: contour quadrature of the resolvent
    lam_rf, _, info_rf = spt.rational_filter_eigs(A, 3, sigma, tol=1e-8, device=dev)
    print(f"rational-filter nearest {sigma}: {Status(int(info_rf.status)).name}, "
          f"lam {np.sort(_host(lam_rf))} (oracle {want})")

    # --- the scipy calling convention
    w_sc, _ = scipy_compat.eigsh(A, k=3, which="SA", tol=1e-8, device=dev)
    print(f"scipy_compat.eigsh SA: lam {np.sort(w_sc)} (oracle {w[:3]})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
