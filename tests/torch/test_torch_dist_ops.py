"""The port's distributed operators and communication on 4 gloo ranks:

- the rows of ``HaloDIA``, ``AllGatherELL``, ``MPKDIA`` (matvec and
  matmat), ``DistPaddedDIA`` and ``DistComplexPaddedDIA`` bitwise the
  single-rank operator's rows in f64/c128 (the band loop runs on a window
  in the single-rank order; ``tests/test_distributed.py::test_distributed_spmv_matches_local``
  holds the JAX package to 1e-14);
- the per-shard partials of K2, K3, K4 (f64) and K6, K7 (c128), summed over
  the ranks, within 1e-12 of the single-rank dots
  (``tests/test_pallas_dist.py::test_dist_matvec_dot_fused_partials``,
  ``tests/test_dist_complex.py::test_dist_complex_fused_dots_match``), with
  every halo still zero after the call, and a dot after a matvec equal to
  the single-rank one (a neighbour's entries left in a solver vector's halo
  would count twice);
- the counters over a Jacobi-BiCGStab solve on every rank: 2 SpMVs × h ×
  itemsize halo bytes sent an iteration to each neighbour the rank has
  (2 sides inside, 1 at an edge), scalar-sized all-reduces only, one
  all-gather (the final x) except on ``AllGatherELL``, whose every SpMV
  gathers (``tests/test_comm_volume.py:46-55``); ``ca_cg`` on ``MPKDIA``
  exchanging once per s-step block;
- the refusals: a halo wider than a rank's rows (``test_halo_dia_rejects_wide_bands``,
  ``test_halo_too_wide_rejected``), ``distributed_solve`` without a process
  group or without the default ``cuda:{LOCAL_RANK}``, and an s beyond the
  matrix-powers depth.
"""

import numpy as np
import pytest
import torch

import sprsolve_tpu_torch as tsp
from sprsolve_tpu_torch import parallel as par
from sprsolve_tpu_torch.utils import problems

import _dist_worker

torch.set_num_threads(2)
WORLD = 4


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dist_ops"))
    return _dist_worker.collect(_dist_worker.launch("ops", WORLD, out), out)


def _case(ranks, name):
    for r in range(WORLD):
        assert "error" not in ranks[r][name], ranks[r][name].get("error")
    return ranks[0][name]


def test_spmv_rows_bitwise_single_rank(ranks):
    for r in range(WORLD):
        out = _case(ranks, "spmv_rows") if r == 0 else ranks[r]["spmv_rows"]
        for name in ("halo", "mpk", "ell"):
            mv_equal, mm_equal, err_vs_csr = out[name]
            assert mv_equal and mm_equal, (r, name)
            assert err_vs_csr <= 1e-14
        assert out["padded"][0], r
        assert out["complex_padded"], r
    # the padded layout really crosses ranks: 4 × 512 rows, a 144-wide halo
    assert ranks[0]["spmv_rows"]["padded"][1:] == (144, 512)


def test_fused_partials_sum_to_single_rank_dots(ranks):
    out = _case(ranks, "fused_partials")
    rel = lambda a, b: abs(a - b) / abs(b)
    got, want, halo_ok = out["K3"]
    assert rel(got, want) <= 1e-12 and halo_ok
    wd, wds, yd, yds, halo_ok = out["K2"]
    assert rel(wd, wds) <= 1e-12 and rel(yd, yds) <= 1e-12 and halo_ok
    assert rel(*out["K2_w_is_x"]) <= 1e-12
    sq, sqs, halo_ok = out["K4"]
    assert rel(sq, sqs) <= 1e-12 and halo_ok
    assert rel(*out["dot_after_matvec"]) <= 1e-12
    assert rel(*out["norm_after_matvec"]) <= 1e-12
    for k in ("K6", "K6_conj", "K7_w_is_x"):
        assert rel(*out[k]) <= 1e-12, k
    wd, wds, yd, yds = out["K7"]
    assert rel(wd, wds) <= 1e-12 and rel(yd, yds) <= 1e-12
    # every rank holds the same sums
    for r in range(1, WORLD):
        assert ranks[r]["fused_partials"] == out


def test_communication_per_bicgstab_iteration(ranks):
    out = _case(ranks, "comm_per_iteration")
    h = out["h"]
    for rank in range(WORLD):
        # a rank sends h entries to each neighbour it has: 1 at the edges, else 2
        sides = (rank > 0) + (rank < WORLD - 1)
        for name in ("padded", "halo", "ell"):
            run = ranks[rank]["comm_per_iteration"][name]
            its = run["its"]
            assert run["status"] == 0 and its == out[name]["its"]
            (ar_calls, ar_bytes), (hx_calls, hx_bytes), (ag_calls, ag_bytes) = (
                run["comm"][k] for k in ("all_reduce_sum", "halo_exchange", "all_gather_rows"))
            # ‖b‖, ‖r₀‖, then r0ᴴv, [sᴴt, tᴴt], ρ and ‖r‖ each iteration
            assert ar_calls == 2 + 4 * its, (name, ar_calls, its)
            assert ar_bytes <= ar_calls * WORLD * 2 * 8   # scalars, never vectors
            spmvs = 1 + 2 * its
            if name == "ell":
                assert hx_calls == 0 and ag_calls == spmvs + 1
            else:
                assert ag_calls == 1
                assert hx_calls == spmvs
                halo = h if name == "padded" else 144   # the padded layout's h, or max|offset|
                assert hx_bytes == spmvs * sides * halo * 8, (rank, name, hx_bytes)
    # x agrees across the layouts
    assert np.allclose(out["padded"]["x"], out["halo"]["x"], rtol=1e-8, atol=1e-10)


def test_ca_cg_exchanges_once_per_block_on_mpkdia(ranks):
    out = _case(ranks, "ca_cg_exchanges")
    assert out["status"] == 0
    assert out["per_block"] and set(out["per_block"]) == {1}, out["per_block"]


def test_refusals_on_the_ranks(ranks):
    out = _case(ranks, "refusals")
    assert out["no_device"].startswith("no CUDA device cuda:0")
    assert "matrix-powers depth" in out["mpk_depth"]


def test_halo_wider_than_a_block_is_refused():
    A = problems.grid_laplacian_dirichlet((4, 4))   # offsets ±4, 2 rows a rank
    with pytest.raises(ValueError, match="bandwidth"):
        par.partition_dia(A.to_dia(), 8)
    with pytest.raises(ValueError, match="extension"):
        par.partition_dia_mpk(problems.grid_laplacian_dirichlet((16, 16)).to_dia(), 4, 5)
    P = problems.poisson3d(20, 20, 20, dtype=np.float64)   # offsets ±400
    par.DistPaddedDIA.from_dia(P.to_dia(), 8)               # 1024 rows a rank
    with pytest.raises(ValueError, match="halo"):
        par.DistPaddedDIA.from_dia(P.to_dia(), 32)          # 256 rows a rank


def test_distributed_solve_needs_a_process_group():
    import torch.distributed as dist

    assert not dist.is_initialized()
    A = problems.grid_laplacian_dirichlet((4, 4))
    with pytest.raises(RuntimeError, match="process group"):
        par.distributed_solve(tsp.bicgstab, A, np.ones(16), tol=1e-8, max_iter=10,
                              device="cpu")
