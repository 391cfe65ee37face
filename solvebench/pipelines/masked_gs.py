"""Multicolour Gauss-Seidel through ``prepare()``: the operator laid out by
``optimize()``, the rows coloured by ``greedy_color``, a
``MaskedGSPrecond`` (``sweeps``, ``omega`` from the traffic file) built on
that operator with the colour masks in its padded layout, then
``prepare(op, M=…)``, which uses a preconditioner built on its own operator
as it is.  The traffic's ``colors`` is the number of colours the stencil
needs; another count is an error."""

import torch


def build(spt, A, traffic: dict, device):
    op = spt.optimize(A, device=device)
    colors = spt.greedy_color(A)
    n_colors = int(colors.max()) + 1
    if n_colors != traffic["colors"]:
        raise ValueError(f"greedy_color gave {n_colors} colours, the traffic "
                         f"file expects {traffic['colors']}")
    masks = tuple(op.pad_vec(m.to(torch.float32)) > 0
                  for m in spt.color_masks(colors, device=device))
    M = spt.MaskedGSPrecond(A=op, diag=op.diagonal_padded(), masks=masks,
                            sweeps=traffic.get("sweeps", 1),
                            omega=traffic.get("omega", 1.0))
    return spt.prepare(op, method=traffic["method"], M=M, tol=traffic["tol"],
                       max_iter=traffic["max_iter"], device=device)
