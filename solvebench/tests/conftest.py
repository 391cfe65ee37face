"""The card marker and fixture of the benchmark's tests."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA GPU; the test skips itself when "
        "torch.cuda.is_available() is false")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda:0")


@pytest.fixture(autouse=True)
def short_traces(monkeypatch):
    """Short traced stretches on the CPU, where the profiler's host events
    take long to read."""
    from sbhelpers import harness

    monkeypatch.setattr(harness, "TRACE_DEVICE_S", 0.05)
    monkeypatch.setattr(harness, "TRACE_HOST_S", 0.02)
