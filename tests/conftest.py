"""Test configuration.

Mirrors the reference test strategy (SURVEY.md §4): deterministic, CPU-only,
single-process. Multi-chip logic is tested on a virtual 8-device CPU mesh
(``jax_num_cpu_devices``) — the JAX-native analog of a fake backend —
exercising the same shard_map code paths that run on a pod.

f64/c128 are enabled because the reference tolerances (1e-17, 1e-22) require
x64 arithmetic; the TPU roofline paths are benchmarked in f32 separately
(see bench.py, which runs on the real chip).

Note: in this environment jax may already be imported at interpreter startup
with a TPU platform configured; ``jax.config.update`` still redirects the
not-yet-initialized backend to CPU, which also skips the slow TPU handshake.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import pytest

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", True)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA GPU; the test skips itself when "
        "torch.cuda.is_available() is false",
    )


@pytest.fixture(autouse=True, scope="session")
def _interpret_pallas():
    """The CPU backend only runs Pallas kernels in interpreter mode; enable
    it once for the whole suite through the package's supported switch."""
    from sprsolve_tpu.debug import interpret_kernels

    with interpret_kernels():
        yield
