"""HPCG's preconditioned CG through ``prepare()``: the operator laid out by
``optimize()``, the coarse levels generated by the configuration's own
generator (``operators/stencil27.py``) on grids whose sides halve, each laid
out by ``optimize()`` too, HPCG's V-cycle on them
(``InjectionMGPrecond``: injection, one symmetric Gauss-Seidel sweep in the
parity colours before the coarse correction and one after it, one on the
coarsest level), then ``prepare(op, method="cg", M=…)``, which uses a
preconditioner built on its own operator as it is.  The traffic's
``levels`` and ``colors`` set the cycle; a grid with another colour count
is an error.

The pipeline gets the fine CSR alone, so it reads the grid from its first
row: the columns of the point (0, 0, 0)'s neighbours are 1, nz, nz + 1,
ny·nz, ... (a side of 1 folds into the next axis, which gives the same
operator and the same hierarchy), and the stencil's coefficients from the
same row.
"""

import numpy as np

from solvebench.operators import stencil27


def grid_of(A):
    """``(nx, ny, nz)`` of a 27-point CSR with rows x-major, z fastest."""
    n = A.shape[0]
    indptr, indices = A.indptr.cpu().numpy(), A.indices.cpu().numpy()
    pos = sorted(int(c) for c in indices[indptr[0]: indptr[1]] if c > 0)
    if len(pos) == 7:
        grid = (n // pos[3], pos[3] // pos[1], pos[1])
    elif len(pos) == 3:
        grid = (1, n // pos[1], pos[1])
    elif len(pos) <= 1:
        grid = (1, 1, n)
    else:
        raise ValueError(f"row 0 of the operator has columns {pos}: not a 27-point stencil")
    if int(np.prod(grid)) != n or A.nnz != int(np.prod([3 * g - 2 for g in grid])):
        raise ValueError(f"the operator is not the 27-point stencil of the grid {grid}")
    return grid


def build(spt, A, traffic: dict, device):
    from sprsolve_tpu_torch.multigrid import halved

    grid = grid_of(A)
    data = A.data.cpu().numpy()
    # row 0's entries in column order: its diagonal, then a neighbour
    cfg = {"dtype": data.dtype.name, "diagonal": float(data[0]), "neighbour": float(data[1])}
    grids = [grid]
    for _ in range(traffic["levels"] - 1):
        grids.append(halved(grids[-1]))
    op = spt.optimize(A, device=device)
    coarse = [spt.CSR.from_arrays(*stencil27.csr_arrays(dict(cfg, grid=list(g))))
              for g in grids[1:]]
    mg = spt.InjectionMGPrecond.from_levels([op, *coarse], grids, device=device)
    if len(mg.orders[0]) != 2 * traffic["colors"] - 1:
        raise ValueError(f"the grid {grid} has {(len(mg.orders[0]) + 1) // 2} colours, the "
                         f"traffic file expects {traffic['colors']}")
    return spt.prepare(op, method=traffic["method"], M=mg, tol=traffic["tol"],
                       max_iter=traffic["max_iter"], device=device)
