"""HPCG's V-cycle on the port (``multigrid.InjectionMGPrecond``, its colour
step ``ops.gs_color``) against the plain reference of ``hpcg_reference.py``,
in f64 at 16³ and 24×16×20 with 4 levels (the second with odd sides below
the fine level), on the CPU, where the colour step runs its plain version.

Tolerances: the port sums each row over its bands in K1's order, the
reference over 26 shifted slices and then the centre, so a colour step
differs by rounding alone (1e-14 relative); one apply of the cycle is
15-105 such steps and 3 restrictions (1e-12 relative); CG on either cycle
takes the same iterations ±1 and x agrees within the tolerance."""

import numpy as np
import pytest
import torch

import hpcg_reference as ref
import sprsolve_tpu_torch as spt
from sprsolve_tpu_torch.errors import IncompatibleMatrixFormat, ZeroDiagonalElem
from sprsolve_tpu_torch.multigrid import halved
from sprsolve_tpu_torch.ops import gs_color
from sprsolve_tpu_torch.utils import problems

GRIDS = [(16, 16, 16), (24, 16, 20)]
LEVELS = 4


def hierarchy(grid, levels=LEVELS):
    grids = [tuple(grid)]
    for _ in range(levels - 1):
        grids.append(halved(grids[-1]))
    return grids


def cycle(grid, **kw):
    grids = hierarchy(grid)
    return spt.InjectionMGPrecond.from_levels([problems.hpcg27(*g) for g in grids], grids,
                                              device="cpu", **kw)


def rand(n, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(n))


def rel(a, b):
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("first", [False, True])
def test_color_step_plain_matches_reference(grid, first):
    op = spt.optimize(problems.hpcg27(*grid), device="cpu")
    n = op.n
    diag = op.offsets.index(0)
    for color in range(gs_color.COLORS):
        z, r = rand(n, color), rand(n, 100 + color)
        if first:
            z = torch.zeros(n, dtype=torch.float64)
        z2 = op.pad_vec(z)
        gs_color.color_step(op.bands, z2, op.pad_vec(r), op.offsets, op.h, grid, color, diag,
                            first=first)
        zp = ref.framed(z.reshape(grid).clone())
        ref.color_step(zp, r.reshape(grid), 26.0, -1.0, color, first=first)
        want = zp[1:-1, 1:-1, 1:-1].reshape(-1)
        assert rel(op.unpad_vec(z2), want) < 1e-14
        # rows of the other colours, the halo and the tail are left as they were
        mask = torch.zeros(grid, dtype=torch.bool)
        cx, cy, cz = (color >> 2) & 1, (color >> 1) & 1, color & 1
        mask[cx::2, cy::2, cz::2] = True
        assert torch.equal(op.unpad_vec(z2)[~mask.reshape(-1)], z[~mask.reshape(-1)])
        assert not z2[: op.h].any() and not z2[op.h + n:].any()


@pytest.mark.parametrize("grid", GRIDS + [(5, 3, 1)])
def test_parity_colours_do_not_couple(grid):
    """Every nonzero of the 27-point operator off its diagonal joins two
    colours: a colour's rows read no row of their own colour."""
    A = problems.hpcg27(*grid)
    rows, cols = A.row_ids.numpy(), A.indices.numpy()
    nx, ny, nz = grid
    colour = lambda k: 4 * ((k // (ny * nz)) & 1) + 2 * (((k // nz) % ny) & 1) + ((k % nz) & 1)
    off = rows != cols
    assert off.any()
    assert not np.any(colour(rows[off]) == colour(cols[off]))


@pytest.mark.parametrize("grid", GRIDS)
def test_one_apply_matches_reference(grid):
    mg = cycle(grid)
    r = rand(int(np.prod(grid)), 1)
    want = ref.mg_apply({"grid": list(grid)}, r, LEVELS)
    assert rel(mg.matvec(r), want) < 1e-12
    # padded and flat inputs give one z
    op = mg.A
    assert torch.equal(op.unpad_vec(mg.matvec(op.pad_vec(r))), mg.matvec(r))


@pytest.mark.parametrize("grid", GRIDS)
def test_cycle_is_symmetric(grid):
    mg = cycle(grid)
    n = int(np.prod(grid))
    u, v = rand(n, 2), rand(n, 3)
    a, b = float(mg.matvec(u) @ v), float(u @ mg.matvec(v))
    assert abs(a - b) <= 1e-12 * abs(a)
    assert float(mg.matvec(u) @ u) > 0


@pytest.mark.parametrize("grid", GRIDS)
def test_pcg_through_prepare_matches_reference(grid):
    mg = cycle(grid)
    b = rand(int(np.prod(grid)), 4)
    tol = 1e-8
    x, info = spt.prepare(mg.A, method="cg", M=mg, tol=tol, max_iter=200, device="cpu")(b)
    assert info.converged
    xr, ir = ref.pcg({"grid": list(grid)}, b, tol=tol, max_iter=200, levels=LEVELS)
    assert ir.converged and abs(info.iterations - ir.iterations) <= 1
    assert rel(x, xr) < 10 * tol
    true = rel(ref.matvec({"grid": list(grid)}, x), b)
    assert true < 2 * tol


def test_a_csr_solve_relays_the_cycle():
    """``solve()`` on the CSR lays out its own operator, so the cycle runs
    relayed on flat vectors, and gives prepare()'s x."""
    grid = GRIDS[0]
    mg = cycle(grid)
    b = rand(int(np.prod(grid)), 5)
    x, info = spt.solve(problems.hpcg27(*grid), b, method="cg", M=mg, tol=1e-8,
                        max_iter=200, device="cpu")
    x2, info2 = spt.prepare(mg.A, method="cg", M=mg, tol=1e-8, max_iter=200,
                            device="cpu")(b)
    assert info.iterations == info2.iterations and rel(x, x2) < 1e-12


@pytest.mark.parametrize("grid", GRIDS + [(12, 10, 8)])
def test_colour_steps_an_apply(grid, monkeypatch):
    """One apply runs 15 colour steps a SymGS (fewer where a level's grid
    has empty colours), 2 SymGS a level and one on the coarsest, each step
    one call of the colour-step wrapper; the first step of each level starts
    from z = 0."""
    mg = cycle(grid)
    calls = []
    real = gs_color.color_step

    def counting(bands, z, r, offsets, h, grid_, color, diag, first=False):
        calls.append((tuple(grid_), first))
        return real(bands, z, r, offsets, h, grid_, color, diag, first=first)

    monkeypatch.setattr(gs_color, "color_step", counting)
    mg.matvec(rand(int(np.prod(grid)), 6))
    per_level = mg.steps_per_apply()
    assert [sum(g == lvl for g, _ in calls) for lvl in mg.grids] == list(per_level)
    assert [g for g, first in calls if first] == list(mg.grids)
    if grid != (12, 10, 8):
        assert per_level == (30, 30, 30, 15)
    else:   # the coarsest grid (2, 2, 1) has 4 colours
        assert per_level == (30, 30, 30, 7)


def test_bad_levels_raise():
    grids = hierarchy((16, 16, 16))
    levels = [problems.hpcg27(*g) for g in grids]
    with pytest.raises(ValueError, match="halved"):
        spt.InjectionMGPrecond.from_levels(levels, grids[:2] + [(4, 4, 3), (2, 2, 2)],
                                           device="cpu")
    with pytest.raises(ValueError, match="levels and"):
        spt.InjectionMGPrecond.from_levels(levels, grids[:3], device="cpu")
    with pytest.raises(ValueError, match="levels and"):
        spt.InjectionMGPrecond.from_levels([], [], device="cpu")
    with pytest.raises(IncompatibleMatrixFormat, match="grid"):
        spt.InjectionMGPrecond.from_levels([levels[1]] + levels[1:], grids, device="cpu")
    with pytest.raises(IncompatibleMatrixFormat, match="DIA"):
        spt.InjectionMGPrecond.from_levels([levels[0].to_dia()] + levels[1:], grids,
                                           device="cpu")


def test_far_couplings_and_zero_diagonals_raise():
    grid = (8, 8, 8)
    A = problems.hpcg27(*grid)
    n = A.shape[0]
    far = problems._coo_to_csr(
        np.concatenate([A.row_ids.numpy(), np.arange(n - 2)]),
        np.concatenate([A.indices.numpy(), np.arange(2, n)]),
        np.concatenate([A.data.numpy(), np.full(n - 2, -0.5)]), n, np.float64)
    with pytest.raises(IncompatibleMatrixFormat, match="colours"):
        spt.InjectionMGPrecond.from_levels([far], [grid], device="cpu")
    data = A.data.numpy().copy()
    data[(A.row_ids.numpy() == 3) & (A.indices.numpy() == 3)] = 0.0
    zero = spt.CSR.from_arrays(data, A.indices, A.indptr, A.shape)
    with pytest.raises(ZeroDiagonalElem):
        spt.InjectionMGPrecond.from_levels([zero], [grid], device="cpu")


def test_cpu_steps_launch_nothing_and_reset_zeroes_the_counter():
    from sprsolve_tpu_torch.ops import padded_dia as pd

    mg = cycle(GRIDS[0])
    pd.reset_launch_counts()
    mg.matvec(rand(int(np.prod(GRIDS[0])), 7))
    assert gs_color.color_step.launches == 0
    gs_color.color_step.launches = 5
    pd.reset_launch_counts()
    assert gs_color.color_step.launches == 0


def test_smooth_and_transfer_spans_inside_precond():
    """Each SymGS group of a level is an ``mg_smooth`` span and each
    restriction and prolongation an ``mg_transfer`` span, all inside the
    apply's ``precond`` span."""
    from sprsolve_tpu_torch.utils import timing

    mg = cycle(GRIDS[0])
    timing.reset_spans()
    with timing.spans_on():
        mg.matvec(rand(int(np.prod(GRIDS[0])), 8))
    spans = timing.spans()
    timing.reset_spans()
    assert spans[0].name == "precond"
    names = [s.name for s in spans[1:]]
    assert names.count("mg_smooth") == 2 * (LEVELS - 1) + 1
    assert names.count("mg_transfer") == 2 * (LEVELS - 1)
    assert all(s.parent == 0 and s.end_ns >= s.start_ns for s in spans[1:])
