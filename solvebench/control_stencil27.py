"""Readings that the limits of ``limits/<workload>.json`` are set from, for
the cells on HPCG's 27-point operator (``operator`` "stencil27").

    python solvebench/control_stencil27.py --workload hpcg27_f64_256.cg_mg4_symgs8 \\
        --program-seeds 1,2,... --control-seeds 7,8,9 [--storage float32] \\
        [--seconds 3] [--out readings.jsonl]

As ``control.py`` (its :func:`~solvebench.control.readings`), with the
control in the program's place: the plain reference's CG preconditioned by
HPCG's V-cycle (``reference/stencil27.py``: ``pcg``, the traffic's levels)
with every vector held in ``--storage``, by default
float32, the precision below the configuration's float64, at the cell's
tolerance and iteration budget, on the control seeds.  Each reading is one
JSON line.  The benchmark's own runs never run this.
"""

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)   # this folder off the path: its modules are imported as solvebench.*

from solvebench import control, harness  # noqa: E402
from solvebench.reference import stencil27  # noqa: E402

CONTROL_STORAGE = "float32"


def control_pipeline(cfg: dict, storage):
    """A pipeline builder that puts the reference, its vectors in
    ``storage`` (None: the configuration's own precision), in the program's
    place."""
    def build(spt, A, traffic, device):
        import torch

        dtype = None if storage is None else getattr(torch, storage)

        def solve(b):
            return stencil27.pcg(cfg, b, tol=traffic["tol"], max_iter=traffic["max_iter"],
                                 levels=traffic["levels"], storage=dtype)
        return solve
    return build


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--program-seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--storage", default=CONTROL_STORAGE)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--device", default="cuda:0")
    p.add_argument("--out")
    args = p.parse_args(argv)
    cell = harness.Cell(harness.read_json(ROOT / "BENCHMARK.json"), args.workload)
    if cell.cfg["operator"] != "stencil27":
        raise SystemExit(f"{args.workload} runs {cell.cfg['operator']}; use control.py")
    seeds = lambda text: [int(v) for v in text.split(",") if v]
    lines = []

    def log(line):
        print(line, flush=True)
        lines.append(line)

    control.readings(cell, "program", seeds(args.program_seeds), args.seconds, args.device,
                     log=log)
    control.readings(cell, f"control_{args.storage}", seeds(args.control_seeds), 0.0,
                     args.device, pipeline=control_pipeline(cell.cfg, args.storage), log=log)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write("".join(line + "\n" for line in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
