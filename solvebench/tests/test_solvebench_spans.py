"""The spans stretch: its summary on made-up events (issue time, wait share,
the idle split by the innermost span, the clocks' agreement), one tiny run of
each cell on the CPU with the host reads the solvers imply, and a program
without spans, which gives no stretch and no number."""

import pytest

from sbhelpers import SEED, tiny_cell, workloads

from solvebench import spans

T0 = 5_000_000   # the profiler's trace start, ns


def ns(us: float) -> int:
    return T0 + int(us * 1000)


DEV = [("marker", 0.0, 1.0), ("dia_dots_kernel<float>", 10.0, 30.0),
       ("Memcpy DtoH (Device -> Pageable)", 50.0, 52.0),
       ("at::native::vectorized_elementwise_kernel<4>", 60.0, 80.0),
       ("marker", 99.0, 100.0)]
SPANS = [("solve", ns(5), ns(90), -1, 0),
         ("precond", ns(8), ns(12), 0, 0),
         ("host_read", ns(40), ns(53), 0, 0),
         ("host_read", ns(81), ns(88), 0, 0)]


def test_summary_of_made_up_spans():
    t = spans.summarize(DEV, SPANS, T0)
    assert t["window_s"] == pytest.approx(100e-6) and t["busy_s"] == pytest.approx(42e-6)
    assert t["n_dtoh"] == 1 and t["n_host_reads"] == 2
    assert t["solve_s"] == pytest.approx(85e-6)
    assert t["host_read_s"] == pytest.approx(20e-6) and t["precond_s"] == pytest.approx(4e-6)
    # idle: 0-10, 30-50, 52-60, 80-100 µs (58 in all), split by the innermost span
    idle = t["idle_s"]
    assert idle["host_read"] == pytest.approx(18e-6)    # 40-50, 52-53, 81-88
    assert idle["precond"] == pytest.approx(2e-6)       # 8-10
    assert idle["solve"] == pytest.approx(23e-6)        # 5-8, 30-40, 53-60, 80-81, 88-90
    assert idle["outside"] == pytest.approx(15e-6)      # 0-5, 90-100
    assert t["read_gap_s"] == pytest.approx(8e-6)       # 52-60: after the copy
    assert t["per_solve"] == [[pytest.approx(0.085), pytest.approx(0.020), 2]]
    # every event that starts before a read ends 8 µs or more before it returns
    assert t["clock_skew_us"] == pytest.approx(-8.0)
    t.update(iterations=2, reads=2)
    m = spans.metrics(t)
    assert m["host_reads_per_iter"] == 1.0
    assert m["host_issue_ms_per_iter"] == pytest.approx(1e3 * 65e-6 / 2)
    assert m["host_wait_share"] == pytest.approx(100 * 20 / 85)
    assert m["idle_issue_share"] == pytest.approx(100 * 25 / 58)


def test_a_read_that_returns_before_earlier_work_ends_shows_as_skew():
    """Spans placed 10 µs early: the second read ends at 78 µs, before the
    kernel that started at 60 µs ends (80 µs)."""
    t = spans.summarize(DEV, SPANS, T0 + 10_000)
    assert t["clock_skew_us"] == pytest.approx(2.0)


def test_the_spans_are_aligned_on_the_reads_copies():
    """With a copy to the host for each read, the least (read end − copy
    end) is taken as the clocks' offset and the spans are moved back by it:
    spans read 7 µs late split the idle as the spans on time do."""
    dev = DEV[:3] + [("Memcpy DtoH (Device -> Pageable)", 84.0, 86.0)] + DEV[3:]
    on_time = [("solve", ns(5), ns(90), -1, 0), ("precond", ns(8), ns(12), 0, 0),
               ("host_read", ns(40), ns(52), 0, 0), ("host_read", ns(81), ns(86), 0, 0)]
    t0, t7 = spans.summarize(dev, on_time, T0), spans.summarize(dev, on_time, T0 - 7000)
    assert t0["clock_offset_us"] == [0.0, 0.0] and t7["clock_offset_us"] == [7.0, 7.0]
    assert t0["clock_skew_us"] == -6.0 and t7["clock_skew_us"] == -7.0
    for kind in spans.IDLE_KINDS:
        assert t7["idle_s"][kind] == pytest.approx(t0["idle_s"][kind], abs=1e-12)
    assert t0["idle_s"]["host_read"] == pytest.approx(13e-6)   # 40-50, 81-84 µs
    assert t0["read_gap_s"] == t7["read_gap_s"] == pytest.approx(12e-6)   # 52-60, 86-90


def test_no_device_events_give_no_idle_split():
    t = spans.summarize([], SPANS, T0)
    assert t["idle_s"] is None and "n_dtoh" not in t
    t.update(iterations=4, reads=5)
    m = spans.metrics(t)
    assert m["idle_issue_share"] is None and m["host_reads_per_iter"] == 1.25


@pytest.mark.parametrize("workload, reads_per_solve", [
    ("poisson7_f32_256.cg_jacobi", 2),
    ("poisson7_f32_256.bicgstab_gs2", 2),
    ("helmholtz7_c64_256.csminres_absjacobi", 3),
])
def test_tiny_run_reports_the_host_side_numbers(workload, reads_per_solve):
    import io
    import json

    out, err = io.StringIO(), io.StringIO()
    rc = spans.main(["--workload", workload, "--seed", str(SEED), "--seconds", "0.1",
                     "--spans-seconds", "0.05"],
                    require_cuda=False, device="cpu", cell=tiny_cell(workload),
                    out=out, err=err)
    assert rc == 0, err.getvalue()
    r = json.loads(out.getvalue().strip().splitlines()[-1])
    t, m = r["spans"], r["metrics"]
    assert r["device"] == "cpu" and r["window"]["solve_s"] > 0
    assert t["reads"] == t["iterations"] + reads_per_solve * t["solves"]
    assert t["n_host_reads"] == t["reads"] and len(t["per_solve"]) == t["solves"]
    assert t["dropped"] == 0
    assert m["host_reads_per_iter"] > 1 and m["host_issue_ms_per_iter"] > 0
    assert 0 < m["host_wait_share"] < 100
    # the CPU has no device to sit idle
    assert m["idle_issue_share"] is None
    assert "[trace.spans] solves=" in err.getvalue()


def test_a_program_without_spans_gives_no_stretch(monkeypatch):
    import io
    import json

    monkeypatch.setattr(spans, "_timing", lambda: None)
    out, err = io.StringIO(), io.StringIO()
    workload = workloads()[0]
    rc = spans.main(["--workload", workload, "--seed", "3", "--seconds", "0.05"],
                    require_cuda=False, device="cpu", cell=tiny_cell(workload),
                    out=out, err=err)
    assert rc == 0
    r = json.loads(out.getvalue().strip().splitlines()[-1])
    assert r["spans"] is None and set(r["metrics"].values()) == {None}
    assert "keeps no spans" in err.getvalue()
