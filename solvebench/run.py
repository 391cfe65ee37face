"""Run one cell of ``BENCHMARK.json`` on the card and print its result line.

    python solvebench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from anywhere: the checkout's root is this file's parent directory.  The
result is the last line of standard output, one JSON object; the set-up's
parts, the window and the numbers compared with their limits go to standard
error, the compared numbers last.  See ``harness.py``.
"""

import time

T0 = time.perf_counter()   # the set-up's clock starts before any import

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)   # this folder off the path: its modules are imported as solvebench.*
# kernel and compile caches at fixed places inside the checkout
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))

from solvebench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t0=T0))
