"""Time the port's dot kernels on one GPU at the main path's shapes: K2
(``dia_wdot``) and K3 (``dia_dot``) beside K1 (``dia_spmv``) on the 100³
Poisson (int8 bands, f32 vectors), and K6 (``dia_complex_dot``, with and
without ``conj_x``) and K7 (``dia_complex_wdot``, Jacobi fold with w = x
and with w = r0) beside K5 (``dia_complex_spmv``) on the damped
complex-symmetric 100³ Poisson (c64, int8 real and bf16 imaginary plane,
as ``chip_smoke.damped_dia()`` builds it).  K1 also runs on the Poisson's
pattern with random f32 bands and in f64, at 100³ (36 and 72 MB a call,
beyond or near the 50 MB L2) and at 64³ (where a call fits in L2); where
the measured tree picks K1's body and band loads
(``padded_dia.k1_by_quads``, ``padded_dia.stream_bands``), each of those
also runs with each forced: one thread per row, and 4-row tiles with
plain or with streamed band loads.  K4 (``orth_norm``) runs on the
padded layout of the 100³ and 64³ Poisson in f32 and f64, with β and α as
0-d tensors of the vectors' dtype.  Beside each K4 shape, as a reading
and no yardstick of K4's function, one
``torch.addcmul(a, vold, v)``: 3 reads and 1 write an entry, K4's bytes,
in a plain elementwise pass.  For each call:

- the device events of one wrapper call, by torch.profiler (which kernels a
  call launches, and how long each runs);
- the graph-replayed device time per call, with the inputs warm in L2 and
  with them cold (rotating through copies whose total exceeds twice L2);
- the wrapper time (20 back-to-back calls, host included).

    python3 tools/torch_dot_kernels.py [--root DIR] [--label NAME] [--y-dir DIR]
                                       [--only PREFIX]

``--y-dir`` saves K1's y of every K1 call (the same seeded x whatever the
tree) to ``DIR/k1_y_<label>.pt``, and K4's (v₊, Σv₊²) of every K4 shape to
``DIR/k4_y_<label>.pt``, and holds them bitwise against every other
label's files already there, one line per call (K4: v₊ and the sum
each).  ``--only`` times only the calls whose name starts with PREFIX
(``K1``: K1's; ``K4``: K4's and the readings beside it).

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
    ap.add_argument("--y-dir", default=None)
    ap.add_argument("--only", default="")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    spec = importlib.util.spec_from_file_location("smoke", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    sys.modules["smoke"] = smoke   # its dataclasses look their module up there
    spec.loader.exec_module(smoke)

    import numpy as np
    import torch

    import sprsolve_tpu_torch as spt
    from sprsolve_tpu_torch.ops import fused
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
    k1 = {}   # name → (bands, x, offsets, h): K1 beyond the main path's int8 bands
    for grid in (100, 64):
        dia = DIA.from_csr(problems.poisson3d(grid, grid, grid), device="cpu")
        rand = torch.where(dia.bands != 0, torch.as_tensor(
            rng.uniform(0.5, 1.5, tuple(dia.bands.shape))), 0.0)
        kinds = (("f64", torch.float64, rand), ("f32 bands", torch.float32, rand))
        if grid != 100:
            kinds += (("int8", torch.float32, dia.bands.double()),)
        for kind, dt, vals in kinds:
            kop = spt.PaddedDIA.from_dia(DIA(bands=vals.to(dt), offsets=dia.offsets,
                                             shape=dia.shape), device=dev)
            kx = kop.pad_vec(torch.as_tensor(rng.standard_normal(kop.n), dtype=dt,
                                             device=dev))
            k1[f"K1 dia_spmv {kind} {grid}^3"] = (kop.bands, kx, kop.offsets, kop.h)
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
    modes = {"": None}   # tag → (4-row tiles, streamed band loads) forced
    if hasattr(pd, "k1_by_quads"):   # the tree picks K1's body and loads: time each
        modes.update({" [rows]": (False, False), " [quads, plain]": (True, False),
                      " [quads, streamed]": (True, True)})
    picks = (getattr(pd, "k1_by_quads", None), getattr(pd, "stream_bands", None))
    for name, (kb, kx, ko, kh) in k1.items():
        for tag, mode in modes.items():
            def call(b, x, ko=ko, kh=kh, mode=mode):
                if mode is not None:
                    pd.k1_by_quads = lambda *_, q=mode[0]: q
                    pd.stream_bands = lambda *_, s=mode[1]: s
                try:
                    return pd.dia_spmv(b, x, ko, kh)
                finally:
                    if mode is not None:
                        pd.k1_by_quads, pd.stream_bands = picks
            calls[name + tag] = (call, (kb, kx))
    k4 = {}   # name → (a, v_old, v, β, α, h)
    for grid in (100, 64):
        for kind, dt in (("f32", torch.float32), ("f64", torch.float64)):
            n = grid ** 3
            kh, n_pad = pd.layout(n, (-grid * grid, grid * grid), dt.itemsize)
            vecs = []
            for _ in range(3):
                t = torch.zeros(n_pad + 2 * kh, dtype=dt)
                t[kh: kh + n] = torch.as_tensor(rng.standard_normal(n), dtype=dt)
                vecs.append(t.to(dev))
            k4[f"K4 orth_norm {kind} {grid}^3"] = (
                *vecs, torch.tensor(0.7, dtype=dt, device=dev),
                torch.tensor(-1.3, dtype=dt, device=dev), kh)
    for name, (ka, kvo, kv, kb, kal, kh) in k4.items():
        calls[name] = (lambda a, vo, v, bt, al, kh=kh: fused.orth_norm(a, vo, v, bt, al, kh),
                       (ka, kvo, kv, kb, kal))
        calls[name.replace("orth_norm", "reading torch.addcmul")] = (
            lambda a, vo, v: torch.addcmul(a, vo, v), (ka, kvo, kv))
    calls = {k: v for k, v in calls.items() if k.startswith(args.only)}
    out = {"label": args.label, "package": spt.__file__, "gpu": smi, "calls": {}}
    print(smi, flush=True)
    if args.y_dir:
        ys = {"K1 dia_spmv int8 100^3": pd.dia_spmv(b, x, o, h).cpu()}
        ys.update({name: pd.dia_spmv(kb, kx, ko, kh).cpu()
                   for name, (kb, kx, ko, kh) in k1.items()})
        y_dir = Path(args.y_dir)
        y_dir.mkdir(parents=True, exist_ok=True)
        for other in sorted(y_dir.glob("k1_y_*.pt")):
            theirs = torch.load(other)
            for name, y in ys.items():
                same = name in theirs and torch.equal(theirs[name], y)
                print(f"[{args.label}] {name}: y bitwise {other.stem[5:]}'s: {same}",
                      flush=True)
                out.setdefault("y_bitwise", {})[f"{name} vs {other.stem[5:]}"] = same
        torch.save(ys, y_dir / f"k1_y_{args.label}.pt")
        vs = {name: tuple(t.cpu() for t in fused.orth_norm(*ops[:5], ops[5]))
              for name, ops in k4.items()}
        for other in sorted(y_dir.glob("k4_y_*.pt")):
            theirs = torch.load(other)
            for name, (vn, sq) in vs.items():
                for what, j, mine in (("v+", 0, vn), ("sum", 1, sq)):
                    same = name in theirs and torch.equal(theirs[name][j], mine)
                    print(f"[{args.label}] {name}: {what} bitwise {other.stem[5:]}'s: "
                          f"{same}", flush=True)
                    out.setdefault("y_bitwise", {})[
                        f"{name} {what} vs {other.stem[5:]}"] = same
        torch.save(vs, y_dir / f"k4_y_{args.label}.pt")
    for name, (call, ops) in calls.items():
        one = lambda: call(*ops)
        rec = {
            "events": smoke.kernel_events(one),
            "warm_us": smoke.device_ms(one) * 1e3,
            "cold_us": smoke.cold_device_ms(call, ops) * 1e3,
            "wrapper_ms": smoke.median_ms(one),
        }
        bound = ""
        if name in k4:   # K4's bound: its bytes over the card's memory rate
            a, kh = k4[name][0], k4[name][5]
            rec["bound_us"] = smoke.bound_ms(smoke.orth_norm_bytes(a, kh),
                                             6 * (a.numel() - 2 * kh), a.dtype)[0] * 1e3
            bound = f", bound {rec['bound_us']:.3f} us"
        out["calls"][name] = rec
        print(f"[{args.label}] {name}: warm {rec['warm_us']:.3f} us, cold "
              f"{rec['cold_us']:.3f} us{bound}, wrapper {rec['wrapper_ms']:.5f} ms, events "
              + "; ".join(f"{n[:60]} {t:.3f} us" for n, t in rec["events"]), flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
