"""The comparison that decides ``correct`` fails what it must: the control
(the reference in bfloat16 in the program's place), and the timed path
broken underneath a whole run: a solve that returns its state unchanged,
half of its answer left out, an answer altered where it is produced.  The
exchange between chips has no place in these one-chip cells."""

import pytest
import torch

from sbhelpers import run_tiny, tiny_cell, workloads

from solvebench import control


def broken(fault):
    def wrap(handle):
        def solve(b):
            x, info = handle(b)
            if fault == "unchanged":
                x = torch.zeros_like(x)          # x0 handed back
            elif fault == "half_left_out":
                x = x.clone()
                x[x.shape[0] // 2:] = 0
            elif fault == "not_a_number":
                x = torch.full_like(x, float("nan"))
            elif fault == "altered":
                x = x.clone()
                x[x.shape[0] // 3] += 1.0 + float(x.abs().max())
            return x, info
        return solve
    return wrap


@pytest.mark.parametrize("workload", workloads())
@pytest.mark.parametrize("fault", ["unchanged", "half_left_out", "altered", "not_a_number"])
def test_fault_is_not_correct(workload, fault):
    rc, result, err = run_tiny(tiny_cell(workload), seconds=0.1, wrap=broken(fault))
    assert rc == 0, err
    assert result["correct"] is False
    assert result["failed"] >= 1
    worst = result["checks"]["true_rel_residual_worst"]
    assert worst["value"] is None if fault == "not_a_number" else \
        worst["value"] > worst["limit"]


@pytest.mark.parametrize("workload", workloads())
def test_control_is_not_correct(workload):
    """At a grid a test can hold; at the cells' size the chip readings are
    in PERF.md §2."""
    cell = tiny_cell(workload)
    cell.cfg = dict(cell.cfg, grid=[24, 20, 16])
    rc, result, err = run_tiny(cell, seconds=0.0,
                               pipeline=control.control_pipeline(cell.cfg, "bfloat16"))
    assert rc == 0, err
    assert result["correct"] is False
    worst = result["checks"]["true_rel_residual_worst"]
    assert worst["value"] > 2 * worst["limit"]


@pytest.mark.parametrize("workload", workloads())
def test_reference_in_full_precision_is_correct(workload):
    """The control's solver itself is sound: kept in the configuration's own
    precision it passes, so the control fails by its precision alone."""
    cell = tiny_cell(workload)
    rc, result, err = run_tiny(cell, seconds=0.0,
                               pipeline=control.control_pipeline(cell.cfg, None))
    assert rc == 0, err
    assert result["correct"] is True, err


@pytest.mark.cuda
@pytest.mark.parametrize("workload", workloads())
def test_cell_on_the_card_at_a_small_grid(workload, cuda):
    import io
    import json

    from solvebench import harness

    cell = tiny_cell(workload)
    cell.cfg = dict(cell.cfg, grid=[64, 64, 64])
    out, err = io.StringIO(), io.StringIO()
    rc = harness.main(["--workload", workload, "--seed", str(2**40 + 11), "--seconds", "1",
                       "--trace", "1"], out=out, err=err, cell=cell)
    assert rc == 0, err.getvalue()
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["device"]["busy_s"] > 0
    assert 0 < result["metrics"]["hand_kernel_roofline"]["value"] <= 105
