"""The launch counts that ``chip_smoke.py`` phase 13 asserts on the card,
checked here on the CPU at a 10³ grid through the same counters: each
kernel wrapper is replaced by a shim that counts its calls (on the card a
call is a launch), and phase 13's functions run with ``device="cpu"``,
untimed.  Every count formula of phase 13 (GMRES's its + cycles + 1,
CGS's 1 + 2·its, TFQMR's 3 + 2·its, IDR(s)'s its, single-sync CG's
its + 2, block CG's its + 1 block applies (K1b), FGMRES with an inner CG, the V-cycle
relayed under CG, refinement's per-inner-solve sums) must hold exactly;
the JAX package's 1M-row counts are checked on the card only.  Phase 16
(e)'s launch and collective counts are checked the same way, on one gloo
rank."""

import importlib
import os
import sys

import pytest
import torch

from sprsolve_tpu_torch.ops import fused
from sprsolve_tpu_torch.ops import padded_dia as pd

torch.set_num_threads(2)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
smoke = importlib.import_module("chip_smoke")

# every solve of phase 13 converges at 10³ (TFQMR's true residual misses tol
# 1e-4 at 12³); a restart of 6 gives GMRES and FGMRES several cycles
GRID = 10


def _counting(orig):
    def shim(*args, **kwargs):
        shim.launches += 1
        return orig(*args, **kwargs)

    shim.launches = 0
    return shim


@pytest.fixture
def counters(monkeypatch):
    monkeypatch.setattr(smoke, "RESTART", 6)
    for name in ("dia_spmv", "dia_spmm", "dia_wdot", "dia_dot", "dia_complex_spmv",
                 "dia_complex_dot", "dia_complex_wdot"):
        monkeypatch.setattr(pd, name, _counting(getattr(pd, name)))
    monkeypatch.setattr(fused, "orth_norm", _counting(fused.orth_norm))


@pytest.mark.parametrize("phase", ["nonsym", "spd", "mg", "inner", "complex", "refine"])
def test_phase13_counts_hold_on_the_cpu(phase, counters):
    fn = getattr(smoke, "phase_refine" if phase == "refine" else f"phase_krylov_{phase}")
    fn(torch.device("cpu"), grid=GRID, timed=False)


def test_gmres_count_formula():
    assert smoke.RESTART == 32
    assert smoke.gmres_k1(161) == 161 + 6 + 1
    assert smoke.gmres_k1(32) == 32 + 1 + 1 and smoke.gmres_k1(33) == 33 + 2 + 1


def test_phase16_krylov_counts_hold_on_the_cpu(counters):
    """Phase 16 (e) on one gloo rank: every launch and collective count it
    asserts on the card, and each count equal to the single-card solve's."""
    smoke.phase_dist_krylov(torch.device("cpu"), grid=GRID, timed=False)
