"""Cross tests of the port's ``parallel.distributed_solve`` on 2 gloo ranks
against the JAX package's on a 2-device mesh: the cases of
``tests/test_distributed.py``, ``tests/test_dist_complex.py``,
``tests/test_pallas_dist.py`` and the MPK case of ``tests/test_ca_cg.py``
(BiCGStab on ELL and on DIA, the exact identity padding, preconditioned
complex MINRES, CS-MINRES, masked Gauss-Seidel, CG, GMRES(16), IDR(4) with
the JAX package's shadow block, BiCGStab with the complex Jacobi in the
layout and flat, CS-MINRES with 1/|d|, Jacobi-BiCGStab and MINRES on
``DistPaddedDIA``, ``ca_cg`` on ``MPKDIA``).

One process group for the file: a module-scoped fixture starts the 2 ranks
(``_dist_worker.py``, case set ``solve``) and computes the JAX side while
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
WORLD = 2


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return _dist_jax.run_all("solve", WORLD, str(tmp_path_factory.mktemp("dist_solve")))


@pytest.mark.parametrize("name", _dist_worker.CASESETS["solve"])
def test_distributed_solve_matches_jax(run, name):
    _dist_jax.check_case(run, name, WORLD)
