"""The port's distributed eigensolvers on 3 gloo ranks:

- the padding cases, n not divisible by the group (the 10×10 grid's 100
  rows over 3 ranks: 2 pad rows), against the JAX package on a 3-device
  mesh: LOBPCG's spectrum-safe padding
  (``tests/test_dist_lobpcg.py::test_padding_is_spectrum_safe``) and
  shift-invert's σ-safe padding at σ = 1.0, where an identity pad row
  would be an exact eigenvalue
  (``tests/test_dist_shift_invert.py::test_padding_is_sigma_safe``);
- the collectives of each driver, counted (``comm.counts()``) over a few
  budget-bound steps on the 16×16 grid and held to formulas worked out
  from the code, the same for k = 2 and 4 (the port's counterpart of
  ``test_collective_structure_is_k_independent``): one halo exchange per
  block apply, of (h, columns) slabs; LOBPCG 6 all-reduces to start and 9
  a step (two per column normalisation, two Gram matrices for CholQR2, the
  projection, P's Gram matrix, the residual norms); a lockstep block MINRES
  2 to start and 2 an iteration; a lockstep block COCG 3 and 3; the
  rational filter's subspace iteration 5 beside its node solves (the trace
  estimate, two CholQR Gram matrices, the projection, the residual norms);
- the distributed rational filter's final disc filter with the radius of
  the kept pairs (ROADMAP Queue 3, "Radius filter"): with ``max_iter=1``
  the one pass at r₀ finds no Ritz value inside r₀, the calibration grows
  the radius, and the result is empty, though the pass holds a converged
  pair just outside r₀ that a filter with the grown radius would return.

One process group for the file (``_dist_worker.py``, case set ``eigen3``);
every case holds every rank to the same bits.
"""

import numpy as np
import pytest
import torch

import _dist_jax

torch.set_num_threads(2)
WORLD = 3


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return _dist_jax.run_eigen("eigen3", WORLD, str(tmp_path_factory.mktemp("dist_eigen3")))


def test_lobpcg_padding_is_spectrum_safe(run):
    _dist_jax.check_eigen(run, "lobpcg_pad", WORLD, lam_atol=1e-7, res_max=1e-6)
    assert run[0][0]["lobpcg_pad"]["X"].shape == (100, 4)


def test_shift_invert_padding_is_sigma_safe(run):
    _dist_jax.check_eigen(run, "si_pad", WORLD, lam_atol=1e-6, res_max=1e-7)
    assert run[0][0]["si_pad"]["X"].shape == (100, 4)


H = 16          # the 16×16 grid's halo
N_QUAD = 2      # the rational filter's nodes in eig_counts


def _want(name, k, c, sides):
    """The calls of each primitive, and the halo bytes this rank sends, of
    one ``eig_counts`` run."""
    its, steps = c["its"], c["steps"]
    if name == "lobpcg":
        calls = {"all_reduce_sum": 6 + 9 * its, "halo_exchange": 1 + its,
                 "all_gather_rows": 1}
        columns = k + 3 * k * its                       # X0, then (rows, 3k) bases
        return calls, sides * H * 8 * columns
    if name == "shift_invert":
        passes = 2
        per_pass, rest = divmod(its, passes)            # each pass runs its budget
        assert not rest and len(steps) == its + passes  # X0's apply, then one a step
        calls = {"all_reduce_sum": sum(2 + 2 * s for s in steps) + 6 * passes + 9 * its,
                 "halo_exchange": sum(1 + s for s in steps) + 1,
                 "all_gather_rows": passes + 1}
        # each pass applies the inverted operator to X0, then to (rows, 3k)
        # bases; the merge applies A once to the 2k candidates
        widths = ([k] + [3 * k] * per_pass) * passes
        columns = sum(w * (1 + s) for w, s in zip(widths, steps)) + 2 * k
        return calls, sides * H * 8 * columns
    iters, rest = divmod(len(steps), N_QUAD)
    assert not rest
    calls = {"all_reduce_sum": sum(3 + 3 * s for s in steps) + 5 * iters,
             "halo_exchange": sum(1 + s for s in steps) + iters,
             "all_gather_rows": 1}
    m0 = k + 2
    # a node solve's block is m0 complex columns, 2·m0 real ones on the wire
    return calls, sides * H * 8 * (sum(2 * m0 * (1 + s) for s in steps) + iters * m0)


def test_collectives_per_step_are_k_independent(run):
    results = run[0]
    for r in range(WORLD):
        counts = results[r]["eig_counts"]
        assert "error" not in counts, counts.get("error")
        sides = (r > 0) + (r < WORLD - 1)
        for name in ("lobpcg", "shift_invert", "rational"):
            calls = {}
            for k in (2, 4):
                c = counts[name, k]
                want, halo_bytes = _want(name, k, c, sides)
                got = {p: c["comm"][p][0] for p in want}
                assert got == want, (r, name, k, got, want)
                assert c["comm"]["halo_exchange"][1] == halo_bytes, (r, name, k, c["comm"])
                calls[k] = got
            assert calls[2] == calls[4], (r, name, calls)


def test_final_filter_uses_the_radius_of_the_kept_pairs(run):
    import _dist_worker

    results = run[0]
    r0 = _dist_jax.same_on_every_rank(results, "rf_radius", WORLD)
    assert r0["status"] == 1 and r0["lam"].size == 0, r0
    lo, hi = _dist_worker.tsp.gershgorin_bounds(_dist_worker.spd_grid(24))
    rad0 = (hi - lo) * 1e-3
    (lam, rel, r_kept), = r0["pass"]
    assert r_kept == rad0
    sigma, tol = 1.0, 1e-8
    # the pass's pair nearest σ with the smallest residual, which passes the
    # ghost filter (10·tol): outside r₀, inside the grown disc
    near = np.flatnonzero(np.abs(np.abs(lam - sigma) - np.abs(lam - sigma).min()) < 1e-6)
    best = near[np.argmin(rel[near])]
    assert rad0 < abs(lam[best] - sigma) < 20 * rad0 and rel[best] <= 10 * tol
    assert abs(lam[best] - 0.99118) < 1e-5
