"""Cross tests of the port's timing harness against the JAX package's
``utils/timing.py``: the byte counts of a DIA and an ELL SpMV equal (exact
integers), the report's nnz rate and bandwidth are the same arithmetic
(rtol 1e-15), the roofline share divides by the card's memory rate keyed
by its name (never a TPU figure) and is absent on the CPU, ``time_fn``
times a call on the CPU, and ``trace`` writes a Chrome trace."""

import json
import os

import numpy as np
import pytest
import torch

from sprsolve_tpu.utils import timing as jtiming
from sprsolve_tpu_torch.ops import padded_dia as pd
from sprsolve_tpu_torch.utils import problems, timing

torch.set_num_threads(2)


@pytest.mark.parametrize("n,d", [(1, 1), (1000, 7), (1_000_000, 7), (4096, 27)])
def test_byte_counts_equal_the_jax_packages(n, d):
    for itemsize in (4, 8):
        assert timing.dia_bytes(n, d, itemsize) == jtiming.dia_bytes(n, d, itemsize)
        assert timing.ell_bytes(n, d, itemsize) == jtiming.ell_bytes(n, d, itemsize)
    # int8 bands (the Poisson's storage): one byte per band entry
    assert timing.dia_bytes(n, d, 4, band_itemsize=1) == d * n + 8 * n


def test_report_arithmetic_equals_the_jax_packages():
    seconds, nnz, moved = 8.1e-6, 6_940_000, 15_000_000
    rep = timing.spmv_report(seconds, nnz, moved, device="cpu")
    jrep = jtiming.SpmvReport(seconds=seconds, nnz=nnz, bytes_algorithmic=moved, chip="cpu")
    np.testing.assert_allclose(rep.gnnz_per_s, jrep.gnnz_per_s, rtol=1e-15)
    np.testing.assert_allclose(rep.achieved_gbps, jrep.achieved_gbps, rtol=1e-15)
    # no device roofline on the CPU (the JAX package's 100 GB/s placeholder
    # is not carried)
    assert rep.chip == "cpu" and rep.roofline_fraction is None
    assert "no device roofline" in str(rep)


def test_roofline_uses_the_cards_rate_by_name():
    assert timing.HBM_BYTES_PER_S == {"NVIDIA H100 80GB HBM3": 3.35e12}
    assert not set(timing.HBM_BYTES_PER_S) & set(jtiming.HBM_GBPS)
    rep = timing.SpmvReport(seconds=1e-3, nnz=10, bytes_algorithmic=int(3.35e9),
                            chip="NVIDIA H100 80GB HBM3",
                            peak_bytes_per_s=timing.hbm_bytes_per_s("NVIDIA H100 80GB HBM3"))
    assert rep.roofline_fraction == pytest.approx(1.0, rel=1e-12)
    assert "3.35 TB/s" in str(rep) and "100.0%" in str(rep)
    assert timing.hbm_bytes_per_s("cpu") is None
    assert timing.detect_chip("cpu") == "cpu"


def test_time_fn_on_the_cpu_times_a_kernel_call():
    op = pd.PaddedDIA.from_dia(problems.poisson3d(8, 8, 8).to_dia())
    x = op.pad_vec(torch.ones(op.n))
    calls = []

    def call(v):
        calls.append(1)
        return pd.dia_spmv(op.bands, v, op.offsets, op.h)

    t = timing.time_fn(call, x, iters=4, warmup=2, reps=3)
    assert t > 0 and len(calls) == 2 + 4 * 3
    rep = timing.spmv_report(t, 512 * 7, timing.dia_bytes(op.n, 7, 4, 1), device="cpu")
    assert rep.seconds == t and rep.gnnz_per_s > 0


def test_trace_writes_a_chrome_trace(tmp_path):
    with timing.trace(str(tmp_path)) as path:
        torch.ones(100).sum()
    assert path == os.path.join(str(tmp_path), "trace.json")
    with open(path) as f:
        data = json.load(f)
    assert "traceEvents" in data
