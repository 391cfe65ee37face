"""Cross tests of the port's timing harness against the JAX package's
``utils/timing.py``: the byte counts of a DIA and an ELL SpMV equal (exact
integers), the report's nnz rate and bandwidth are the same arithmetic
(rtol 1e-15), the roofline share divides by the card's memory rate keyed
by its name (never a TPU figure) and is absent on the CPU, ``time_fn``
times a call on the CPU, and ``trace`` writes a Chrome trace with the
program's spans.  The port's own spans and host-read counter: nesting,
the off path, the cap, the profiler's timeline, the reads of a solve."""

import json
import os
import time

import numpy as np
import pytest
import torch

import sprsolve_tpu_torch as spt
from sprsolve_tpu.utils import timing as jtiming
from sprsolve_tpu_torch.ops import padded_dia as pd
from sprsolve_tpu_torch.solvers.common import read_flags
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


def _poisson(k: int = 6, shift: complex = 0.0) -> spt.CSR:
    """The 7-point Poisson on k³, with ``shift`` added to the diagonal
    (complex64 when the shift is complex)."""
    A = problems.poisson3d(k, k, k)
    data = A.data.numpy()
    if isinstance(shift, complex):
        rows = np.repeat(np.arange(A.shape[0]), np.diff(A.indptr.numpy()))
        data = data.astype(np.complex64)
        data[A.indices.numpy() == rows] += shift
    return spt.CSR.from_arrays(data, A.indices.numpy(), A.indptr.numpy(), A.shape)


def test_trace_writes_a_chrome_trace(tmp_path):
    A = _poisson()
    handle = spt.prepare(A, method="cg", M="jacobi", tol=1e-5, max_iter=200, device="cpu")
    with timing.trace(str(tmp_path)) as path:
        torch.ones(100).sum()
        handle(torch.ones(A.shape[0]))
    assert path == os.path.join(str(tmp_path), "trace.json")
    with open(path) as f:
        data = json.load(f)
    assert "traceEvents" in data
    spans = [e for e in data["traceEvents"] if e.get("cat") == "span"]
    (solve,) = [e for e in spans if e["name"] == "solve"]
    reads = [e for e in spans if e["name"] == "host_read"]
    assert len(reads) >= 3
    for e in reads:   # a solve span contains its host_read children
        assert e["args"]["parent"] == solve["args"]["index"]
        assert solve["ts"] <= e["ts"] and e["ts"] + e["dur"] <= solve["ts"] + solve["dur"]
    # on the profiler's timeline: the solve's ops lie inside its span
    muls = [e for e in data["traceEvents"] if e.get("name") == "aten::mul"
            and e.get("ph") == "X" and e["ts"] >= solve["ts"]]
    assert muls and all(e["ts"] + e["dur"] <= solve["ts"] + solve["dur"] for e in muls)


@pytest.fixture
def fresh_spans():
    timing.reset_spans()
    yield
    timing.reset_spans()


def test_spans_nest_with_parent_and_solve_id(fresh_spans):
    with timing.spans_on():
        with timing.span("outer"):
            for _ in range(2):
                with timing.span("solve"):
                    with timing.span("precond"):
                        with timing.span("host_read"):
                            pass
                    with timing.span("host_read"):
                        pass
        with timing.span("host_read"):
            pass
    got = [(s.name, s.parent, s.solve_id) for s in timing.spans()]
    assert got == [("outer", -1, -1),
                   ("solve", 0, 0), ("precond", 1, 0), ("host_read", 2, 0), ("host_read", 1, 0),
                   ("solve", 0, 1), ("precond", 5, 1), ("host_read", 6, 1), ("host_read", 5, 1),
                   ("host_read", -1, -1)]
    spans = timing.spans()
    for s in spans:
        assert 0 < s.start_ns <= s.end_ns
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    with pytest.raises(RuntimeError):
        with timing.spans_on(), timing.span("solve"):
            timing.reset_spans()


def test_spans_off_read_no_clock_and_the_cap_drops(fresh_spans, monkeypatch):
    def no_clock():
        raise AssertionError("a span read the clock with spans off")

    with monkeypatch.context() as m:
        m.setattr(time, "time_ns", no_clock)
        assert timing.span("solve") is timing.span("host_read")   # one shared no-op
        with timing.span("solve"):
            assert read_flags(torch.tensor(True), torch.tensor(False)) == [True, False]
    assert timing.spans() == [] and timing.dropped_spans() == 0
    monkeypatch.setattr(timing, "SPAN_CAP", 3)
    with timing.spans_on():
        with timing.span("solve"):
            for _ in range(4):
                with timing.span("host_read"):
                    pass
    assert [s.name for s in timing.spans()] == ["solve", "host_read", "host_read"]
    assert timing.dropped_spans() == 2
    timing.reset_spans()
    assert timing.spans() == [] and timing.dropped_spans() == 0


def test_a_span_holds_its_op_on_the_profilers_timeline(fresh_spans):
    """``time.time_ns()`` less the profiler's ``trace_start_ns`` is the
    profiler's µs: a span around an op contains the op's event."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(1 << 16)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timing.spans_on(), timing.span("precond"):
            x * 2.0
    t0 = prof.profiler.kineto_results.trace_start_ns()
    (s,) = timing.spans()
    a, b = (s.start_ns - t0) / 1e3, (s.end_ns - t0) / 1e3
    (mul,) = [e for e in prof.events() if e.name == "aten::mul"]
    assert a <= mul.time_range.start <= mul.time_range.end <= b


@pytest.mark.parametrize("method, shift, extra", [
    ("cg", 0.0, 2),            # the zero-b guard, the first test, one read an iteration
    ("bicgstab", 0.0, 2),      # the zero-b guard, ‖r0‖ ≤ tol, one read an iteration
    ("cs_minres", 0.5j, 3),    # the zero-b guard, the entry test, its + 1 in the loop
])
def test_read_flags_counts_a_solves_host_reads(fresh_spans, method, shift, extra):
    A = _poisson(6, shift)
    b = torch.as_tensor(np.random.default_rng(3).standard_normal(A.shape[0]),
                        dtype=A.data.dtype)
    handle = spt.prepare(A, method=method, M="jacobi", tol=1e-5, max_iter=400, device="cpu")
    pd.reset_launch_counts()
    assert read_flags.calls == 0
    with timing.spans_on():
        _, info = handle(b)
    assert info.converged and info.iterations > 5
    assert read_flags.calls == info.iterations + extra
    spans = timing.spans()
    assert spans[0].name == "solve" and spans[0].parent == -1
    reads = [s for s in spans if s.name == "host_read"]
    assert len(reads) == read_flags.calls
    assert all(s.solve_id == 0 for s in spans)
    # a Jacobi folded into K2's input (BiCGStab) applies no M.matvec
    assert any(s.name == "precond" for s in spans) == (method != "bicgstab")
