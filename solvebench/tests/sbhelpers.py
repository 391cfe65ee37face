"""Helpers of the benchmark's CPU tests: cells cut to a tiny grid, run
through the harness on the CPU with the look for a card skipped."""

import io
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from solvebench import harness  # noqa: E402

TINY_GRID = [12, 10, 8]
SEED = 2**40 + 7   # wider than 32 signed bits, as a check's seeds may be


def spec():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def workloads():
    return [w["name"] for w in spec()["workloads"]]


def tiny_cell(workload: str, spec_=None) -> "harness.Cell":
    cell = harness.Cell(spec_ or spec(), workload)
    cell.cfg = dict(cell.cfg, grid=TINY_GRID)
    return cell


def run_tiny(cell, trace: int = 0, seconds: float = 0.3, seed: int = SEED, **kw):
    """``(rc, result or None, stderr)`` of one CPU run of ``cell``."""
    out, err = io.StringIO(), io.StringIO()
    rc = harness.main(["--workload", cell.name, "--seed", str(seed), "--seconds",
                       str(seconds), "--trace", str(trace)],
                      require_cuda=False, device="cpu", cell=cell, out=out, err=err, **kw)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()
