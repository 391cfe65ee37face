"""Cross tests of the port's Krylov family on gloo ranks against the JAX
package's distributed tests on its virtual CPU devices, with their problems,
tolerances and seeds:

- block CG on ``HaloDIA`` (``tests/test_block_solve.py::test_block_cg_distributed``);
- single-sync CG on 1 and 2 ranks
  (``tests/test_cg_single_sync.py::test_distributed_iteration_invariance``);
- COCG on ``DistComplexPaddedDIA`` with the complex Jacobi, c64
  (``tests/test_cocg.py::test_cocg_distributed``);
- BiCGStab(2) (``tests/test_bicgstabl.py::test_bicgstabl_distributed``);
- CGS and TFQMR on ``AllGatherELL`` (``tests/test_cgs_tfqmr.py::test_distributed``);
- CA-BiCGStab (s = 2) on ``MPKDIA`` of depth 4 on 1, 2 and 3 ranks, 3 with
  pad rows (``tests/test_ca_bicgstab.py::test_distributed_matches_serial``);
- FGMRES(25) with a 5-step inner CG as M, both on the group
  (``tests/test_fgmres.py::test_distributed_fgmres_with_inner_cg``).

One process group for the file: a module-scoped fixture starts 3 ranks
(``_dist_worker.py``, case set ``krylov``; each case runs on the subgroups
of ``KRYLOV_SIZES``) and computes the JAX side while they run. Each case
holds every rank to the same x bits and ``SolveInfo``, the status to JAX's,
the true residual to the JAX test's gate, and the count to JAX's
(``_dist_jax.KRYLOV_IN_STEP``, x within 1e-10) or to the band of
``tests/test_serial_parity.py:183`` (COCG in c64, CA-BiCGStab). The port's
collective counters (``parallel.comm``) must equal the collectives of the
JAX program, traced: its top level once and each while loop's body once per
execution of that loop in the port's run.
"""

import pytest
import torch

import _dist_jax
import _dist_worker

torch.set_num_threads(2)
CASES = [(name, size) for name, sizes in _dist_worker.KRYLOV_SIZES.items() for size in sizes]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return _dist_jax.run_krylov(str(tmp_path_factory.mktemp("dist_krylov")))


@pytest.mark.parametrize("name,size", CASES, ids=[f"{n}-{s}" for n, s in CASES])
def test_distributed_krylov_matches_jax(run, name, size):
    _dist_jax.check_krylov(run, name, size)


def test_single_sync_cg_one_all_reduce_an_iteration(run):
    """The claim of ``cg_single_sync``: one all-reduce and one halo exchange
    an iteration, in the JAX program and in the port's counters, and the
    count of 1 rank within 2 of 2 ranks' as in the JAX test."""
    got = {s: _dist_jax.check_krylov(run, "cg_single_sync_iteration_invariance", s)
           for s in (1, 2)}
    for out in got.values():
        assert out["levels"][(0,)] == {"all_reduce_sum": 1, "halo_exchange": 1,
                                       "all_gather_rows": 0}
    assert abs(got[1]["its"] - got[2]["its"]) <= 2


def test_ca_bicgstab_one_exchange_a_block(run):
    """CA-BiCGStab's s = 2 steps a block take one halo exchange (depth 2s)
    and one all-reduce (the Gram matrix with the shadow projection); the
    counts of 1, 2 and 3 ranks lie within the JAX test's drift of 6."""
    its = {}
    for s in (1, 2, 3):
        out = _dist_jax.check_krylov(run, "ca_bicgstab_matches_serial", s)
        assert out["levels"][(0, 0)] == {"all_reduce_sum": 1, "halo_exchange": 1,
                                         "all_gather_rows": 0}
        its[s] = out["its"]
    assert max(its.values()) - min(its.values()) <= 6, its


def test_block_cg_on_the_kernel_layout(run):
    """Block CG on ``DistPaddedDIA`` (on the parent tree its layout took
    vectors only, and the solve raised): each SpMV sends one (h, 4) slab to
    the rank's one neighbour, and a ``matmat`` gives the single-rank
    ``PaddedDIA.matmat``'s rows bit for bit."""
    results = run[0]
    for r in range(2):
        out = results[r]["block_cg_padded"]
        assert "error" not in out, out.get("error")
        out = out[2]
        assert out["matmat"], r
        calls, sent = out["comm"]["halo_exchange"]
        assert sent == calls * out["h"] * 4 * 8, (r, calls, sent, out["h"])
