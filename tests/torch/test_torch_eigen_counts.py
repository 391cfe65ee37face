"""The K1b launch formulas of ``chip_smoke.py`` phase 14, checked on the
CPU at a 10³ grid through counting shims over the kernel wrappers (on the
card a call is a launch), as ``test_torch_krylov_counts.py`` does for
phase 13: LOBPCG's its + 1 (the V-cycle's levels launch nothing),
shift-invert's Σ(1 + lockstep iterations) over its inner block MINRES
solves plus one, the rational filter's Σ(1 + lockstep iterations) over
its node solves plus one per subspace iteration, and MINRES on a
ShiftedOperator's K1 its + 2. The budgets are cut (convergence is the
card's check, not this one's). Phase 17's collective counts (``de_counts``)
and its gates on a gloo group of one rank and on two spawned ranks, at
10³ and 8³."""

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

GRID = 10


def _counting(orig):
    def shim(*args, **kwargs):
        shim.launches += 1
        return orig(*args, **kwargs)

    shim.launches = 0
    return shim


@pytest.fixture
def counters(monkeypatch):
    monkeypatch.setattr(smoke, "STRICT", False)
    monkeypatch.setattr(smoke, "SI_MAX_ITER", 4)
    monkeypatch.setattr(smoke, "SI_INNER_MAX_ITER", 40)
    monkeypatch.setattr(smoke, "RF_INNER_MAX_ITER", 200)
    for name in ("dia_spmv", "dia_spmm", "dia_wdot", "dia_dot", "dia_complex_spmv",
                 "dia_complex_dot", "dia_complex_wdot"):
        monkeypatch.setattr(pd, name, _counting(getattr(pd, name)))
    monkeypatch.setattr(fused, "orth_norm", _counting(fused.orth_norm))


@pytest.mark.parametrize("case", ["lobpcg", "shift_invert", "rational", "shifted"])
def test_phase14_counts_hold_on_the_cpu(case, counters):
    fn = getattr(smoke, f"phase_eigen_{case}")
    kw = {} if case == "shifted" else {"timed": False}
    out = fn(torch.device("cpu"), grid=GRID, **kw)
    if case != "shifted":
        assert out > 0


def test_phase17_collectives_hold_on_the_cpu(counters, monkeypatch):
    """Phase 17 as the card runs it, (a)-(c) on one gloo rank, then (d) on
    two spawned gloo ranks, each driver at 10³ (LOBPCG) or 8³: no kernel
    launched, every rank the same bits, each rank's collectives exactly
    ``de_counts``, and (d)'s LOBPCG converged to the analytic λ."""
    grids = {"lobpcg": GRID, "shift_invert": 8, "rational": 8}
    monkeypatch.setattr(smoke, "DE_LOBPCG_MAX_ITER", 5)
    monkeypatch.setattr(smoke, "RUN_COUNTS", {})    # no phase 14 run to compare with
    monkeypatch.setattr(smoke, "DE_GRIDS", grids)
    monkeypatch.setattr(smoke, "DE_GLOO_GRIDS", grids)
    smoke.phase_dist_eigen(torch.device("cpu"))


def test_phase14_analytic_eigenvalues():
    """The analytic spectrum the card's run is held to: the smallest 10³
    eigenvalue is 3·(2·sin(π/22))², the nearest σ come out sorted, and
    ``match_nearest`` takes the 64³ shift-invert answer (two pairs from
    each 6-fold cluster at 0.998321 and 1.001746, whose distances to σ
    differ by 7e-5 < tol) as nearest within tol but not with
    multiplicity, and refuses a λ off the spectrum or a farther one."""
    import numpy as np

    lam = smoke.poisson_eigs_nearest(10, 0.0, 1)
    np.testing.assert_allclose(lam, [3 * (2 * np.sin(np.pi / 22)) ** 2], rtol=1e-14)
    near = smoke.poisson_eigs_nearest(10, 1.0, 4)
    assert np.all(np.diff(near) >= 0) and near.shape == (4,)
    got = [0.99815935, 0.9982717, 1.00176644, 1.00180435]
    assert smoke.match_nearest(got, 64, 1.0, 5e-4) == (True, False)
    assert smoke.match_nearest([0.998321] * 4, 64, 1.0, 5e-4) == (True, True)
    assert not smoke.match_nearest(got[:3] + [1.0040], 64, 1.0, 5e-4)[0]
    assert not smoke.match_nearest(got[:3] + [1.0029665], 64, 1.0, 5e-4)[0]
    assert not smoke.match_nearest([], 32, 1.0, 5e-4)[0]
