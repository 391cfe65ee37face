"""Time the port's dot kernels on one GPU at the main path's shapes: K2
(``dia_wdot``) and K3 (``dia_dot``) beside K1 (``dia_spmv``) on the 100³
Poisson (int8 bands, f32 vectors), and K6 (``dia_complex_dot``, with and
without ``conj_x``) and K7 (``dia_complex_wdot``, Jacobi fold with w = x and
with w = r0) beside K5 (``dia_complex_spmv``) on the damped complex-symmetric
100³ Poisson (c64, int8 real and bf16 imaginary plane, as
``chip_smoke.damped_dia()`` builds it):

- the device events of one wrapper call, by torch.profiler (which kernels a
  call launches, and how long each runs);
- the graph-replayed device time per call, with the inputs warm in L2 and
  with them cold (rotating through copies whose total exceeds twice L2);
- the wrapper time (20 back-to-back calls, host included).

    python3 tools/torch_dot_kernels.py [--root DIR] [--label NAME]

``--root`` names the checkout whose ``sprsolve_tpu_torch`` is measured
(default: the one holding this script), so that two trees can be compared
in one run on one card; the timing helpers always come from this
checkout's ``chip_smoke.py``.  Prints one line per call and, last, one
JSON object with every number.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--label", default="this tree")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    spec = importlib.util.spec_from_file_location("smoke", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    import numpy as np
    import torch

    import sprsolve_tpu_torch as spt
    from sprsolve_tpu_torch.ops import padded_dia as pd
    from sprsolve_tpu_torch.sparse.containers import DIA
    from sprsolve_tpu_torch.utils import problems

    if not torch.cuda.is_available():
        print("torch_dot_kernels: needs a CUDA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    op = spt.PaddedDIA.from_dia(DIA.from_csr(problems.poisson3d(100, 100, 100),
                                             device="cpu"), device=dev)
    rng = np.random.default_rng(0)
    mk = lambda: op.pad_vec(torch.as_tensor(rng.standard_normal(op.n),
                                            dtype=torch.float32, device=dev))
    x, r0 = mk(), mk()
    dinv = op.jacobi_precond().diag_inv
    b, o, h = op.bands, op.offsets, op.h
    cop = spt.ComplexPaddedDIA.from_dia(smoke.damped_dia(), device=dev)
    cmk = lambda: cop.pad_vec(torch.complex(
        *(torch.as_tensor(rng.standard_normal(cop.n), dtype=torch.float32, device=dev)
          for _ in range(2))))
    cx, cr0 = cmk(), cmk()
    cdinv = cop.jacobi_precond().diag_inv
    co, ch = cop.offsets, cop.h
    calls = {   # name → (call, operands)
        "K1 dia_spmv": (lambda b, x: pd.dia_spmv(b, x, o, h), (b, x)),
        "K2 dia_wdot[has_dinv,w=x]": (
            lambda b, x, d: pd.dia_wdot(b, x, None, d, o, h), (b, x, dinv)),
        "K2 dia_wdot[has_dinv,w=r0]": (
            lambda b, x, w, d: pd.dia_wdot(b, x, w, d, o, h), (b, x, r0, dinv)),
        "K3 dia_dot": (lambda b, x: pd.dia_dot(b, x, o, h), (b, x)),
        "K5 dia_complex_spmv": (lambda br, bi, x: pd.dia_complex_spmv(br, bi, x, co, ch),
                                (cop.re.bands, cop.im.bands, cx)),
        "K6 dia_complex_dot[conj_x]": (
            lambda br, bi, x: pd.dia_complex_dot(br, bi, x, co, ch, True),
            (cop.re.bands, cop.im.bands, cx)),
        "K6 dia_complex_dot": (
            lambda br, bi, x: pd.dia_complex_dot(br, bi, x, co, ch),
            (cop.re.bands, cop.im.bands, cx)),
        "K7 dia_complex_wdot[has_dinv,w=x]": (
            lambda br, bi, x, d: pd.dia_complex_wdot(br, bi, x, None, d, co, ch),
            (cop.re.bands, cop.im.bands, cx, cdinv)),
        "K7 dia_complex_wdot[has_dinv,w=r0]": (
            lambda br, bi, x, w, d: pd.dia_complex_wdot(br, bi, x, w, d, co, ch),
            (cop.re.bands, cop.im.bands, cx, cr0, cdinv)),
    }
    out = {"label": args.label, "package": spt.__file__, "gpu": smi, "calls": {}}
    print(smi, flush=True)
    for name, (call, ops) in calls.items():
        one = lambda: call(*ops)
        rec = {
            "events": smoke.kernel_events(one),
            "warm_us": smoke.device_ms(one) * 1e3,
            "cold_us": smoke.cold_device_ms(call, ops) * 1e3,
            "wrapper_ms": smoke.median_ms(one),
        }
        out["calls"][name] = rec
        print(f"[{args.label}] {name}: warm {rec['warm_us']:.3f} us, cold "
              f"{rec['cold_us']:.3f} us, wrapper {rec['wrapper_ms']:.5f} ms, events "
              + "; ".join(f"{n[:60]} {t:.3f} us" for n, t in rec["events"]), flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
