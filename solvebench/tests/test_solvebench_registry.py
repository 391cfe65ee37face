"""Configurations, traffic mixes, right-hand sides, pipelines and metrics
are files found by the names BENCHMARK.json and the traffic give them: a new cell and a new metric come as new
files and entries, and no file that is there is edited."""

import json
import shutil

from sbhelpers import ROOT, TINY_GRID, run_tiny

from solvebench import harness


def test_new_files_are_found_by_name(tmp_path, monkeypatch):
    bench = tmp_path / "solvebench"
    shutil.copytree(ROOT / "solvebench", bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p.relative_to(bench): p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((bench / "configs" / "poisson7_f32_256.json").read_text())
    (bench / "configs" / "dummy7_f64.json").write_text(json.dumps(
        dict(cfg, name="dummy7_f64", grid=TINY_GRID, dtype="float64", diagonal=6.5)))
    (bench / "traffic" / "dummy_minres.json").write_text(json.dumps(
        {"pipeline": "prepare", "method": "minres", "M": None, "tol": 1e-8,
         "max_iter": 500, "rhs": {"kind": "dummy_uniform", "low": -1.0}}))
    (bench / "rhs" / "dummy_uniform.py").write_text(
        "import math\n\nimport torch\n\n\n"
        "def stream(cfg, spec, dtype, operator):\n"
        "    n = math.prod(cfg['grid'])\n\n"
        "    def make(gen, device):\n"
        "        u = torch.rand(n, generator=gen, dtype=dtype, device=device)\n"
        "        return spec['low'] + 2 * u\n"
        "    return make\n")
    (bench / "limits" / "dummy7_f64.dummy_minres.json").write_text(
        json.dumps({"true_rel_residual_worst": 1e-6}))
    (bench / "metrics" / "dummy.answer.py").write_text(
        "def read(s):\n    return 42.0 + 0 * len(s['iterations'])\n")
    spec["configs"].append({"name": "dummy7_f64", "source": "a test",
                            "file": "solvebench/configs/dummy7_f64.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "dummy7_f64.dummy_minres", "config": "dummy7_f64",
                              "traffic": "dummy_minres", "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "dummy.answer", "unit": "1", "better": "higher",
                              "source": "program_counter", "layer": "solver",
                              "moves": "solve_s", "workloads": ["dummy7_f64.dummy_minres"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    monkeypatch.setattr(harness, "ROOT", tmp_path)
    monkeypatch.setattr(harness, "BENCH", bench)

    cell = harness.Cell(json.loads((tmp_path / "BENCHMARK.json").read_text()),
                        "dummy7_f64.dummy_minres")
    assert cell.cfg["grid"] == TINY_GRID and cell.traffic["method"] == "minres"
    import torch
    b = harness.Rhs(cell.cfg, cell.traffic, 5, torch.device("cpu"), torch)(0)
    assert b.dtype == torch.float64 and -1 <= float(b.min()) < 0 < float(b.max()) <= 1
    rc, result, err = run_tiny(cell, trace=1, seconds=0.1)
    assert rc == 0, err
    assert result["correct"] is True, err
    assert result["metrics"]["dummy.answer"] == {"value": 42.0, "unit": "1"}
    # the metrics listed for other cells stay out of this one
    assert "hand_kernel_roofline" not in result["metrics"]
    assert "iters_per_solve" in result["metrics"]
    after = {p.relative_to(bench): p.read_bytes() for p in bench.rglob("*")
             if p.is_file() and p.relative_to(bench) in before}
    assert after == before


def test_unknown_workload_is_refused():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    try:
        harness.Cell(spec, "no_such.cell")
    except harness.SetupError as e:
        assert "no_such.cell" in str(e)
    else:
        raise AssertionError("an unknown workload was accepted")
