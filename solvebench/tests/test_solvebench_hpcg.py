"""The HPCG cell's files: the 27-point generator against the plain
reference and the port's own problem, its eigenbasis, the pipeline's grid,
the cell's plumbing on a tiny grid, its control, and the readers of
``mg_sweep_roofline`` and ``mg_sweep_share`` on made-up summaries."""

import math

import numpy as np
import pytest
import torch

from sbhelpers import ROOT, run_tiny, tiny_cell

from solvebench import control_stencil27, harness, mg_byte_models
from solvebench.byte_models import Geometry
from solvebench.operators import stencil27 as gen
from solvebench.pipelines import hpcg_mg
from solvebench.reference import stencil27 as ref
from sprsolve_tpu_torch.utils import problems

WORKLOAD = "hpcg27_f64_256.cg_mg4_symgs8"
SHAPES = [[12, 10, 8], [5, 3, 1], [1, 1, 4], [2, 2, 2], [3, 1, 2]]


def config(grid):
    return dict(tiny_cell(WORKLOAD).cfg, grid=grid)


@pytest.mark.parametrize("grid", SHAPES)
def test_generator_equals_reference_and_port(grid):
    import scipy.sparse as sps

    cfg = config(grid)
    data, indices, indptr, shape = gen.csr_arrays(cfg)
    n = math.prod(grid)
    assert shape == (n, n) and data.dtype == np.float64 and len(data) == indptr[-1]
    assert all(np.all(np.diff(indices[indptr[i]: indptr[i + 1]]) > 0) for i in range(n))
    assert len(data) == math.prod(3 * g - 2 for g in grid)
    port = problems.hpcg27(*grid)
    np.testing.assert_array_equal(indptr, port.indptr.numpy())
    np.testing.assert_array_equal(indices, port.indices.numpy())
    np.testing.assert_array_equal(data, port.data.numpy())
    x = np.random.default_rng(3).standard_normal(n)
    S = sps.csr_matrix((data, indices, indptr), shape=shape)
    np.testing.assert_allclose(ref.matvec(cfg, torch.from_numpy(x)).numpy(), S @ x,
                               rtol=0, atol=1e-12)


def test_configuration_counts():
    cfg = harness.read_json(ROOT / "solvebench" / "configs" / "hpcg27_f64_256.json")
    assert cfg["rows"] == math.prod(cfg["grid"])
    assert cfg["nonzeros"] == math.prod(3 * g - 2 for g in cfg["grid"]) == 766 ** 3


@pytest.mark.parametrize("grid", [[12, 10, 8], [7, 5, 6]])
def test_eigenbasis_gives_eigenvectors(grid):
    """A·v = λ·v for single sine products v, λ = (d − c) + c·Π(1 + 2 cos θ_k)."""
    cfg = config(grid)
    n = math.prod(grid)
    for k in [(1, 1, 1), (3, 2, 5), (grid[0], grid[1], grid[2])]:
        coeffs = torch.zeros(grid, dtype=torch.float64)
        coeffs[k[0] - 1, k[1] - 1, k[2] - 1] = 1.0
        v = gen.eigenbasis(cfg, coeffs.reshape(-1))
        assert abs(float(v.norm()) - 1) < 1e-12 and v.shape == (n,)
        lam = (26.0 + 1.0) - math.prod(1 + 2 * math.cos(math.pi * kk / (g + 1))
                                       for kk, g in zip(k, grid))
        assert float((ref.matvec(cfg, v) - lam * v).norm()) < 1e-12


@pytest.mark.parametrize("grid", SHAPES + [[1, 1, 1], [4, 1, 1], [1, 6, 1]])
def test_pipeline_reads_the_grid(grid):
    """The grid from the CSR's first row, up to sides of 1 folded into the
    next axis: the same number of points and the same hierarchy's sizes."""
    import sprsolve_tpu_torch as spt
    from sprsolve_tpu_torch.multigrid import halved

    A = spt.CSR.from_arrays(*gen.csr_arrays(config(grid)))
    got = hpcg_mg.grid_of(A)
    assert math.prod(got) == math.prod(grid)
    assert sorted(g for g in got if g > 1) == sorted(g for g in grid if g > 1)
    assert math.prod(halved(got)) == math.prod(halved(grid))


def test_pipeline_refuses_another_stencil():
    import sprsolve_tpu_torch as spt

    A = problems.poisson3d(6, 5, 4, dtype=np.float64)
    with pytest.raises(ValueError, match="27-point"):
        hpcg_mg.grid_of(spt.CSR.from_arrays(A.data, A.indices, A.indptr, A.shape))


@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_the_cycle_on_a_tiny_grid(trace):
    """The whole run on the CPU: every solve through prepare() with the
    V-cycle, converged, judged correct, with the cycle's iteration count."""
    cell = tiny_cell(WORKLOAD)
    rc, result, err = run_tiny(cell, trace=trace, seconds=0.2)
    assert rc == 0, err
    assert result["correct"] is True and result["failed"] == 0, err
    if trace:
        assert {"prepare_s", "iters_per_solve"} <= set(result["metrics"])
        # the CPU names no card: no roofline
        assert "mg_sweep_roofline" not in result["metrics"]
        assert "hand_kernel_roofline" not in result["metrics"]
    b = harness.Rhs(cell.cfg, cell.traffic, 5, torch.device("cpu"), torch)(0)
    _, info = ref.pcg(cell.cfg, b, tol=cell.traffic["tol"], max_iter=1000, levels=4)
    import sprsolve_tpu_torch as spt
    A = spt.CSR.from_arrays(*gen.csr_arrays(cell.cfg))
    x, pinfo = hpcg_mg.build(spt, A, cell.traffic, "cpu")(b)
    assert pinfo.converged and abs(pinfo.iterations - info.iterations) <= 1


@pytest.mark.parametrize("storage, correct", [("float32", False), ("bfloat16", False),
                                              (None, True)])
def test_control(storage, correct):
    """The plain MG-PCG with its vectors in float32 (the precision below the
    configuration's float64) or bfloat16 fails the limit; in float64 it
    passes, so the control fails by its precision alone.  The float32
    solve's residual floor falls with the grid (1.245e-6 at 256³, about
    1.6e-7 here), so the tiny grid takes the tolerance and limit a power of
    ten below the cell's (1e-8, 3e-8): the floor over the limit is then
    about the cell's."""
    cell = tiny_cell(WORKLOAD)
    cell.cfg = dict(cell.cfg, grid=[24, 20, 16])
    cell.traffic = dict(cell.traffic, tol=cell.traffic["tol"] / 10)
    cell.limits = {k: v / 10 for k, v in cell.limits.items()}
    rc, result, err = run_tiny(cell, seconds=0.0,
                               pipeline=control_stencil27.control_pipeline(cell.cfg, storage))
    assert rc == 0, err
    assert result["correct"] is correct, err
    if not correct:
        worst = result["checks"]["true_rel_residual_worst"]
        assert worst["value"] > 2 * worst["limit"]


def test_reference_copy_is_the_tests_reference():
    assert (ROOT / "solvebench" / "reference" / "stencil27.py").read_bytes() == \
        (ROOT / "tests" / "torch" / "hpcg_reference.py").read_bytes()


# --- the readers on made-up summaries ---------------------------------------
DEMANGLED = ("void (anonymous namespace)::gs_color_step_kernel<double, double, {}>"
             "(double const*, double*, double const*, long long, long long, unsigned int, "
             "unsigned int, unsigned int, long long, long long, long long, int, "
             "(anonymous namespace)::Offsets)")
MANGLED = "_ZN12_GLOBAL__N_120gs_color_step_kernelIddLb{}EEEvPKT0_PT_PKS3_xxjjjxxxiNS_7OffsetsE"
G256 = Geometry(n_pad=256 ** 3, h=65800, nd=27, band_itemsizes=(8,), vec_itemsize=8)


def summary(first_count, other_count, first_s, other_s, iterations=200, solves=2,
            mangled=False, extra=None):
    name = MANGLED if mangled else DEMANGLED
    kernels = {name.format("1" if mangled else "true"): [first_count, first_s],
               name.format("0" if mangled else "false"): [other_count, other_s],
               "void (anonymous namespace)::dia_spmv_kernel<double, double>(...)": [600, 0.5]}
    kernels.update(extra or {})
    return {"device_kind": "NVIDIA H100 80GB HBM3",
            "trace": {"geometry": G256,
                      "device": {"kernels": kernels, "iterations": iterations,
                                 "solves": solves}}}


def test_parse_names():
    assert mg_byte_models.parse(DEMANGLED.format("true")) is True
    assert mg_byte_models.parse(DEMANGLED.format("false")) is False
    assert mg_byte_models.parse(MANGLED.format(1)) is True
    assert mg_byte_models.parse(MANGLED.format(0)) is False
    for other in ("void (anonymous namespace)::dia_spmv_kernel<double, double>(double const*)",
                  "_ZN12_GLOBAL__N_115dia_spmv_kernelIddEEvPKT0_PKT_PS3_xxNS_7OffsetsE",
                  "Memset (Device)", "gs_color_step_kernel"):
        assert mg_byte_models.parse(other) is None


def test_apply_bytes_by_hand():
    """One apply at 256³ in f64 with 27 bands: on each level 1 first step
    ((8 + 16)/8·n bytes) and 29 others (37·n), 14 on the coarsest."""
    n = 256 ** 3
    want = sum(3 * n / 8 ** lvl + (14 if lvl == 3 else 29) * 37 * n / 8 ** lvl
               for lvl in range(4))
    assert mg_byte_models.apply_bytes(G256, 4) == pytest.approx(want)
    assert mg_byte_models.apply_launches(G256, 4) == 105
    assert mg_byte_models.apply_launches(G256, 1) == 15


@pytest.mark.parametrize("grid", [(256, 256, 256), (12, 10, 8), (5, 3, 1), (2, 2, 1),
                                  (17, 17, 17)])
def test_byte_model_steps_are_the_programs(grid):
    """The model's grids and steps a level are the program's cycle's, odd
    sides and missing colours included; its cube is the layout's."""
    import sprsolve_tpu_torch as spt
    from sprsolve_tpu_torch.multigrid import halved
    from sprsolve_tpu_torch.ops import gs_color, padded_dia as pd

    levels = 4 if min(grid) >= 8 else 1
    grids = mg_byte_models.level_grids(grid, levels)
    want = [tuple(grid)]
    for _ in range(levels - 1):
        want.append(halved(want[-1]))
    assert grids == want
    steps = mg_byte_models.apply_steps(grid, levels)
    if max(grid) <= 17:
        mg = spt.InjectionMGPrecond.from_levels([problems.hpcg27(*g) for g in grids], grids,
                                                device="cpu")
        assert tuple(len(s) for s in steps) == mg.steps_per_apply()
        assert [[math.prod(gs_color.color_extent(g, c)) for c in order] * (len(s) // len(order))
                for g, order, s in zip(grids, mg.orders, steps)] == steps
    if grid[0] == grid[1] == grid[2]:
        _, n_pad = pd.layout(math.prod(grid), (-1, 0, 1), 8)
        assert mg_byte_models.cube_grid(n_pad) == tuple(grid)


@pytest.mark.parametrize("mangled", [False, True])
def test_roofline_and_share_on_made_up_summaries(mangled):
    from solvebench.metrics import mg_sweep_roofline, mg_sweep_share

    applies = 202
    spent = 1.5
    s = summary(4 * applies, 101 * applies, 0.1, spent - 0.1, mangled=mangled)
    want = 100 * applies * mg_byte_models.apply_bytes(G256, 4) / 3.35e12 / spent
    assert mg_sweep_roofline.read(s) == pytest.approx(want)
    assert 0 < want < 100
    assert mg_sweep_share.read(s) == pytest.approx(100 * spent / (spent + 0.5))


@pytest.mark.parametrize("counts", [(4 * 202, 101 * 202 - 1), (4 * 202 + 1, 101 * 202),
                                    (3 * 202, 101 * 202), (0, 0)])
def test_roofline_is_none_when_the_counts_disagree(counts):
    from solvebench.metrics import mg_sweep_roofline

    assert mg_sweep_roofline.read(summary(*counts, 0.1, 1.0)) is None


def test_roofline_reads_other_level_counts_and_no_other_grid():
    """Three levels are read from three first steps an apply; a fine layout
    that is no cube's reads None."""
    from solvebench.metrics import mg_sweep_roofline

    s = summary(3 * 202, (15 * 5 - 3) * 202, 0.1, 1.0)
    want = 100 * 202 * mg_byte_models.apply_bytes(G256, 3) / 3.35e12 / 1.1
    assert mg_sweep_roofline.read(s) == pytest.approx(want)
    s["trace"]["geometry"] = Geometry(n_pad=256 * 256 * 128, h=65800, nd=27,
                                      band_itemsizes=(8,), vec_itemsize=8)
    assert mg_sweep_roofline.read(s) is None
    assert mg_byte_models.apply_bytes(s["trace"]["geometry"], 4) is None


def test_readers_without_a_card_or_a_trace():
    from solvebench.metrics import mg_sweep_roofline, mg_sweep_share

    s = summary(4 * 202, 101 * 202, 0.1, 1.0)
    assert mg_sweep_roofline.read(dict(s, device_kind="cpu")) is None
    assert mg_sweep_roofline.read({"device_kind": "cpu"}) is None
    assert mg_sweep_share.read({}) is None
    no_steps = {"trace": {"device": {"kernels": {"dia_spmv_kernel<double>": [3, 1.0]}}}}
    assert mg_sweep_share.read(no_steps) is None
