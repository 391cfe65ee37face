"""The reduction of a traced stretch to its summary, on events made up to
show each rule: markers bound the window, busy is the union of device
intervals, idle gaps are named by the innermost host op over them."""

import pytest

from sbhelpers import ROOT  # noqa: F401  (puts the checkout on the path)

from solvebench import profiling


def test_summary_of_made_up_events():
    dev = [("marker", 0.0, 1.0),
           ("void (anonymous namespace)::dia_dots_kernel<float, signed char, false, true, "
            "false>(signed char const*)", 10.0, 30.0),
           ("void at::native::vectorized_elementwise_kernel<4>(int)", 20.0, 45.0),
           ("Memcpy DtoH (Device -> Pageable)", 60.0, 62.0),
           ("marker", 99.0, 100.0)]
    host = [("aten::mul", 40.0, 58.0), ("cudaLaunchKernel", 45.0, 50.0),
            ("aten::item", 62.0, 98.0)]
    s = profiling.summarize(dev, host, wall_s=1.0)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx((35 + 2) * 1e-6)
    assert s["n_events"] == 3 and s["n_kernels"] == 2
    assert s["device_ops"][0] == ["at::native::vectorized_elementwise_kernel<4>",
                                  pytest.approx(25e-6)]
    assert s["device_ops"][1][0] == "dia_dots_kernel<float, signed char, false, true, false>"
    gaps = dict(s["idle_gaps"])
    assert gaps["aten::item"] == pytest.approx(38e-6)     # 62 → 100
    assert gaps["aten::mul"] == pytest.approx(15e-6)      # 45 → 60, mid 52.5
    assert gaps["host (no op)"] == pytest.approx(10e-6)   # 0 → 10


def test_no_device_events_reads_the_host_clock():
    s = profiling.summarize([], [], wall_s=0.5)
    assert s["window_s"] == pytest.approx(0.5) and s["busy_s"] == 0 and s["n_events"] == 0
