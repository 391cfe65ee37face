"""Cross tests of the port's ``parallel.distributed_solve`` on 4 gloo ranks
against the JAX package's on a 4-device mesh: the cases of
``tests/test_distributed.py``, ``tests/test_dist_complex.py``,
``tests/test_pallas_dist.py`` and the MPK case of ``tests/test_ca_cg.py``
(of the 2-rank file's cases: BiCGStab on ELL and on DIA, the exact
identity padding, preconditioned complex MINRES, CS-MINRES, CG, BiCGStab
with the complex Jacobi in the layout and flat, Jacobi-BiCGStab on
``DistPaddedDIA`` and ``ca_cg`` on ``MPKDIA``), and the counts of one
solve on 1, 2 and 4 ranks.

One process group for the file: a module-scoped fixture starts the 4 ranks
(``_dist_worker.py``, case set ``solve4``) and computes the JAX side while
they run. Each case holds every rank to the same x bits and
``SolveInfo``, and the port's x to JAX's within 1e-10 relative (f64, c128),
its true residual converged and its count equal to JAX's or within the band
of ``tests/test_serial_parity.py:183`` (the reduction orders differ). The
kernel layouts run their plain versions here (CPU tensors); the JAX side
runs them on ``HaloDIA``, as XLA ops.
"""

import pytest
import torch

import _dist_jax
import _dist_worker

torch.set_num_threads(2)
WORLD = 4


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return _dist_jax.run_all("solve4", WORLD, str(tmp_path_factory.mktemp("dist_solve4")))


@pytest.mark.parametrize("name", _dist_worker.CASESETS["solve4"][:-1])
def test_distributed_solve_matches_jax(run, name):
    _dist_jax.check_case(run, name, WORLD)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_counts_across_world_sizes(run, dtype):
    """Jacobi-BiCGStab on the 16³ Poisson (tol 1e-5, ``tests/test_comm_volume.py:64-82``)
    on 1, 2 and 4 ranks: each converges below a true residual of 1e-4, and
    the counts spread by at most max(3, min/10) (``:82``). In f64 that holds
    for the counts of one rhs. In f32 it holds for each world size's mean
    count over the rhs of seeds 0-3: there one count is a draw from a spread
    wider than the bound on one rank alone
    (:func:`test_f32_count_moves_under_one_ulp_changes`), so the counts of
    one rhs (seed 0: 36, 33, 32) test that noise, not the partitioning."""
    import numpy as np

    from sprsolve_tpu_torch.utils import problems

    runs = run[0][0]["counts_across_world_sizes"]
    assert "error" not in runs, runs.get("error")
    A = problems.poisson3d(16, 16, 16, dtype=np.dtype(dtype))
    seeds = _dist_worker.COUNT_SEEDS[dtype]
    counts = {}
    for (dt, seed, size), r in runs.items():
        if dt != dtype:
            continue
        rhs = np.random.default_rng(seed).standard_normal(A.shape[0]).astype(dtype)
        assert r["status"] == 0
        y = A.matvec(torch.as_tensor(r["x"])).numpy()
        assert np.linalg.norm(y - rhs) / np.linalg.norm(rhs) < 1e-4
        counts.setdefault(size, []).append(r["its"])
    assert sorted(counts) == [1, 2, 4]
    assert all(len(c) == len(seeds) for c in counts.values())
    mean = {size: sum(c) / len(c) for size, c in counts.items()}
    lo, hi = min(mean.values()), max(mean.values())
    assert hi - lo <= max(3, int(lo) // 10), counts


def test_f32_count_moves_under_one_ulp_changes():
    """The f32 count of the case above, on one device with no partitioning,
    over 16 copies of the seed-0 rhs with 20 entries each moved up 1 ULP:
    in the port and in the JAX package alike the counts spread wider than
    max(3, min/10). That is why the f32 case holds means to the bound."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import sprsolve_tpu as sp
    import sprsolve_tpu_torch as tsp
    from sprsolve_tpu.utils import problems as jproblems
    from sprsolve_tpu_torch.utils import problems

    A = problems.poisson3d(16, 16, 16, dtype=np.float32).to_dia()
    M = tsp.DiagPrecond.new(A.diagonal())
    jA = jproblems.poisson3d(16, 16, 16, dtype=np.float32).to_dia()
    jM = sp.DiagPrecond.new(np.asarray(jA.diagonal()))
    jits = jax.jit(lambda r: sp.bicgstab(jA, r, M=jM, tol=1e-5, max_iter=300)[1].iterations)
    rhs = np.random.default_rng(0).standard_normal(A.shape[0]).astype(np.float32)
    rng = np.random.default_rng(0)
    port, ref = [], []
    for _ in range(16):
        r = rhs.copy()
        idx = rng.choice(r.size, 20, replace=False)
        r[idx] = np.nextafter(r[idx], np.float32(np.inf))
        _, info = tsp.bicgstab(A, torch.as_tensor(r), M=M, tol=1e-5, max_iter=300)
        assert info.converged
        port.append(int(info.iterations))
        ref.append(int(jits(jnp.asarray(r))))
    for counts in (port, ref):
        assert max(counts) - min(counts) > max(3, min(counts) // 10), (port, ref)
