"""Every cell's plumbing on a tiny grid on the CPU: set-up, window, traced
stretch, check and result line, with the metrics of BENCHMARK.json."""

import pytest

from sbhelpers import run_tiny, spec, tiny_cell, workloads


@pytest.mark.parametrize("workload", workloads())
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_correct(workload, trace):
    cell = tiny_cell(workload)
    rc, result, err = run_tiny(cell, trace=trace, seconds=0.2)
    assert rc == 0, err
    assert list(result)[-1] == "checks"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in result
    assert result["correct"] is True, err
    assert result["failed"] == 0 and result["attempted"] >= 1
    kind = "per_layer" if trace else "end_to_end"
    names = {m["name"] for m in spec()[kind]
             if "workloads" not in m or workload in m["workloads"]}
    # the CPU has no device trace and no device memory: those metrics stay out
    assert set(result["metrics"]) <= names
    for m in result["metrics"].values():
        assert m["value"] == m["value"] and m["unit"]
    if trace:
        assert {"prepare_s", "iters_per_solve"} <= set(result["metrics"])
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert {"solve_s", "setup_s"} <= set(result["metrics"])
    assert "[setup] import_s=" in err and "prepare_s=" in err
    last = err.strip().splitlines()[-3:]
    assert last[0].startswith("[check] true_rel_residual_worst=")
    assert last[-1].startswith("[check] correct=True")


@pytest.mark.parametrize("workload", workloads())
def test_same_seed_same_inputs(workload):
    """Solve i's right-hand side is made from (seed, i) alone."""
    import torch

    from solvebench import harness

    cell = tiny_cell(workload)
    dev = torch.device("cpu")
    a = harness.Rhs(cell.cfg, cell.traffic, 2**40 + 3, dev, torch)
    b = harness.Rhs(cell.cfg, cell.traffic, 2**40 + 3, dev, torch)
    c = harness.Rhs(cell.cfg, cell.traffic, 2**40 + 4, dev, torch)
    assert torch.equal(a(5), b(5)) and not torch.equal(a(5), a(6))
    assert not torch.equal(a(5), c(5))
    assert a(5).dtype == getattr(torch, cell.cfg["dtype"])


def test_flat_spectrum_gives_every_seed_the_same_work():
    """A flat-spectrum b has every eigenvector's weight at 1: CG takes the
    same number of iterations whatever the seed."""
    import torch

    import sprsolve_tpu_torch as spt
    from solvebench import harness

    cell = tiny_cell("poisson7_f32_256.cg_jacobi")
    cell.cfg = dict(cell.cfg, grid=[20, 18, 16])
    assert cell.traffic["rhs"]["kind"] == "flat_spectrum"
    data, indices, indptr, shape = harness.operator_module(cell.cfg).csr_arrays(cell.cfg)
    handle = spt.prepare(spt.CSR.from_arrays(data, indices, indptr, shape), method="cg",
                         M="jacobi", tol=1e-4, max_iter=1000, device="cpu")
    its = set()
    for seed in (1, 2**40 + 5, 77):
        rhs = harness.Rhs(cell.cfg, cell.traffic, seed, torch.device("cpu"), torch)
        b = rhs(0)
        assert abs(float(b.norm()) ** 2 / b.numel() - 1) < 1e-5
        its.add(int(handle(b)[1].iterations))
    assert len(its) == 1


def test_reservoir_is_seeded_and_uniform_in_size():
    from solvebench.harness import Reservoir

    picks = []
    for _ in range(2):
        r = Reservoir(4, 99)
        for i in range(50):
            r.offer(i, i)
        picks.append([i for i, _ in r.kept])
    assert picks[0] == picks[1] and len(picks[0]) == 4
    assert any(i >= 4 for i in picks[0])


@pytest.mark.parametrize("workload, kind", [
    ("helmholtz7_c64_256.csminres_absjacobi", "flat_spectrum"),   # real b only
    ("poisson7_f32_256.cg_jacobi", "no_such_kind"),
])
def test_rhs_kind_is_refused(workload, kind):
    import torch

    from solvebench import harness

    cell = tiny_cell(workload)
    traffic = dict(cell.traffic, rhs={"kind": kind})
    with pytest.raises(harness.SetupError, match=kind):
        harness.Rhs(cell.cfg, traffic, 3, torch.device("cpu"), torch)
