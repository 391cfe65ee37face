"""Demo, the counterpart of ``examples/demo.py`` (the reference binary,
``src/main.rs:4-36``): build a 4×4 Dirichlet grid Laplacian, print its
nonzero pattern, set the boundary rhs, run one SpMV, then solve with
BiCGStab, which the reference's binary leaves commented out.

Run: python -m sprsolve_tpu_torch.examples.demo [--device cpu]
(default: the CUDA device)
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

import sprsolve_tpu_torch as spt
from sprsolve_tpu_torch.ops.optimize import default_device
from sprsolve_tpu_torch.utils import problems


def nnz_pattern(csr: spt.CSR) -> str:
    """ASCII nonzero pattern (``sprs::visu::nnz_pattern_formatter``)."""
    rows = csr.row_ids.numpy()
    cols = csr.indices.numpy()
    grid = [["."] * csr.shape[1] for _ in range(csr.shape[0])]
    for r, c, v in zip(rows, cols, csr.data.numpy()):
        if v != 0:
            grid[r][c] = "x"
    return "\n".join("".join(row) for row in grid)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m sprsolve_tpu_torch.examples.demo")
    ap.add_argument("--device", default=None, help="default: the CUDA device")
    dev = default_device(ap.parse_args(argv).device)

    shape = (4, 4)
    lap = problems.grid_laplacian_dirichlet(shape)
    print(f"grid laplacian nnz structure:\n{nnz_pattern(lap)}")

    rhs = np.zeros(16)
    problems.set_boundary_condition(rhs, shape, lambda r, c: float(r + c))

    y = lap.to(dev).matvec(torch.as_tensor(rhs, device=dev)).cpu().numpy()
    print("\nA @ rhs =", np.array2string(y, precision=3))

    x, (iters, res) = spt.BiCGStab.new(lap, 16, device=dev).solve(rhs, max_iter=300,
                                                                   tol=1e-14)
    print(f"\nBiCGStab solved in {iters} iterations, relative residual {res:.2e}")
    xh = x.cpu().numpy()
    for i in range(shape[0]):
        print(" ".join(f"{xh[i * shape[1] + j]:7.3f}" for j in range(shape[1])))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
