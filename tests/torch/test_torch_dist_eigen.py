"""Cross tests of the port's distributed eigensolvers
(``parallel.distributed_lobpcg``, ``distributed_shift_invert_eigs``,
``distributed_rational_filter_eigs``) on 2 gloo ranks against the JAX
package's on a 2-device mesh: the cases of ``tests/test_dist_lobpcg.py``,
``tests/test_dist_shift_invert.py`` and ``tests/test_dist_rational.py``, at
their sizes, in f64 unless a case says f32.

One process group for the file: a module-scoped fixture starts the 2 ranks
(``_dist_worker.py``, case set ``eigen``) and computes the JAX side while
they run. The JAX package's per-shard LOBPCG draws (``fold_in(key,
axis_index)``) are computed here and patched into the ranks'
``lobpcg._fresh_directions``. Each case holds every rank to the same λ and
X bits and ``SolveInfo``, λ to JAX's within 1e-8 (relative) and to the
dense eigenvalues within the JAX test's tolerance, the residuals on the
dense A, XᵀX = I, and the count to JAX's or within the band of
``tests/test_serial_parity.py:183``.
"""

import numpy as np
import pytest
import torch

import _dist_jax

torch.set_num_threads(2)
WORLD = 2


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return _dist_jax.run_eigen("eigen", WORLD, str(tmp_path_factory.mktemp("dist_eigen")))


def test_block_applies_match_the_per_column_product(run):
    """``HaloDIA.matmat`` and ``AllGatherELL.matmat`` on 5 columns, one
    exchange for the block, against the dense product (1e-13;
    ``tests/test_dist_lobpcg.py::test_matmat_matches_per_column_matvec``)."""
    for r in range(WORLD):
        out = run[0][r]["eig_matmat"]
        assert "error" not in out, out.get("error")
        assert out["ell"] <= 1e-13 and out["dia"] <= 1e-13, out


@pytest.mark.parametrize("name", ["lobpcg_ell", "lobpcg_dia", "lobpcg_largest",
                                  "lobpcg_jacobi"])
def test_distributed_lobpcg_matches_jax(run, name):
    _dist_jax.check_eigen(run, name, WORLD, lam_atol=1e-7, res_max=1e-6)


@pytest.mark.parametrize("name", ["si_both", "si_above", "si_below", "si_jacobi",
                                  "si_prepartitioned"])
def test_distributed_shift_invert_matches_jax(run, name):
    _dist_jax.check_eigen(run, name, WORLD, lam_atol=1e-6, res_max=1e-7)
    lam = run[0][0][name]["lam"]
    if name == "si_above":
        assert (lam >= _side_sigma()).all()
    if name == "si_below":
        assert (lam < _side_sigma()).all()


def _side_sigma():
    import _dist_worker

    A = _dist_worker.spd_grid(12)
    return _dist_worker.between(np.linalg.eigvalsh(_dist_worker.dense_of(A)), 3, unique=True)


def test_distributed_rational_filter_matches_jax(run):
    _dist_jax.check_eigen(run, "rf_dense", WORLD, lam_atol=1e-9, res_max=1e-7)


def test_distributed_rational_filter_inner_refine_f32(run):
    """The f32 operator with two mixed-precision refinement passes (f64
    true residuals on a partitioned f64 copy): converged to tol 5e-5, λ
    within 5e-4 of the dense eigenvalues (the JAX test's bar) and within
    1e-5 (relative) of JAX's f32 λ (the two f32 Rayleigh–Ritz solves round
    apart by a few ULPs: 4.8e-7 here), and the f32 vectors orthonormal to
    1e-4 (CholQR's ridge, 100·ε₃₂·tr(G) over m0 = 9 columns, moves XᵀX by
    about 5e-5)."""
    _dist_jax.check_eigen(run, "rf_refine", WORLD, lam_atol=5e-4, res_max=1e-4,
                          orth_atol=1e-4, lam_rtol=1e-5)


def test_distributed_rational_filter_refuses_complex(run):
    for r in range(WORLD):
        assert run[0][r]["rf_complex"].get("raised") in ("IncompatibleMatrixFormat",
                                                        "TypeError"), run[0][r]["rf_complex"]
