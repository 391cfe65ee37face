"""Readings that the limits of ``limits/<workload>.json`` are set from.

    python solvebench/control.py --workload <name> --program-seeds 1,2,... \\
        --control-seeds 7,8,9 [--seconds 3] [--out readings.jsonl]

In one process, at the cell's own size and load: the program's pipeline is
built once, and for each program seed a short closed-loop window runs on
that seed's right-hand sides, and the reference judges its sampled answers,
as a benchmark run does.  Then the control takes the program's place: the plain
reference's Jacobi CG (COCG on a complex operator) with every vector held in
bfloat16, the precision below the configuration's float32, at the cell's
tolerance and iteration budget, on the control seeds.  Each reading is one
JSON line.  The benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)   # this folder off the path: its modules are imported as solvebench.*

from solvebench import harness  # noqa: E402
from solvebench.reference import solvers  # noqa: E402

CONTROL_STORAGE = "bfloat16"


def control_pipeline(cfg: dict, storage: str):
    """A pipeline builder that puts the reference, in ``storage``, in the
    program's place."""
    def build(spt, A, traffic, device):
        import torch

        dtype = None if storage is None else getattr(torch, storage)

        def solve(b):
            return solvers.jacobi_cg(cfg, b, tol=traffic["tol"],
                                     max_iter=traffic["max_iter"], storage=dtype)
        return solve
    return build


def readings(cell, side: str, seeds, seconds: float, device, pipeline=None, log=print):
    """One reading a seed: the window's worst true residual over its sampled
    answers, its iterations and unconverged solves."""
    s = harness.Session(cell, device, time.perf_counter(), pipeline)
    out = []
    for seed in seeds:
        rhs = harness.Rhs(cell.cfg, cell.traffic, seed, s.device, s.torch)
        if pipeline is None:
            s.warm_up(rhs)
        summary, reservoir = harness.run_window(
            s, rhs, seconds, seed, min_solves=1 if pipeline is None else harness.SAMPLES)
        checks, rejected = harness.check(cell, reservoir.kept, rhs)
        value, limit = checks["true_rel_residual_worst"]
        rec = {"workload": cell.name, "side": side, "seed": seed,
               "true_rel_residual_worst": value, "limit": limit,
               "solves": summary["n_solves"], "compared": len(reservoir.kept),
               "iterations": [min(summary["iterations"]), max(summary["iterations"])],
               "unconverged": summary["unconverged"], "rejected": rejected,
               "window_s": summary["window_s"]}
        log(json.dumps(rec))
        out.append(rec)
        del reservoir
    s.free()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--program-seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--device", default="cuda:0")
    p.add_argument("--out")
    args = p.parse_args(argv)
    cell = harness.Cell(harness.read_json(ROOT / "BENCHMARK.json"), args.workload)
    seeds = lambda text: [int(v) for v in text.split(",") if v]
    lines = []

    def log(line):
        print(line, flush=True)
        lines.append(line)

    readings(cell, "program", seeds(args.program_seeds), args.seconds, args.device, log=log)
    readings(cell, "control", seeds(args.control_seeds), 0.0, args.device,
             pipeline=control_pipeline(cell.cfg, CONTROL_STORAGE), log=log)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write("".join(line + "\n" for line in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
