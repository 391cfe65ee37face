"""The benchmark's generator and its plain reference against the port's own
problem definitions (``utils/problems``) at a small size."""

import numpy as np
import pytest
import torch

from sbhelpers import TINY_GRID, spec

from solvebench import harness
from solvebench.operators import stencil7 as gen
from solvebench.reference import check, stencil7 as ref
from sprsolve_tpu_torch.utils import problems


def config(name, grid=TINY_GRID):
    entry = {c["name"]: c for c in spec()["configs"]}[name]
    cfg = harness.read_json(harness.ROOT / entry["file"])
    return dict(cfg, grid=grid)


def port_csr(cfg):
    """The port's CSR of the configuration: ``poisson3d``, with the damping
    added on its diagonal as the port's own damped Poisson is made
    (``chip_smoke.damped_csr_arrays``)."""
    A = problems.poisson3d(*cfg["grid"])
    data = A.data.numpy().astype(gen.DTYPES[cfg["dtype"]])
    if cfg["diagonal_imag"]:
        data[A.indices.numpy() == A.row_ids.numpy()] += 1j * cfg["diagonal_imag"]
    return data, A.indices.numpy(), A.indptr.numpy()


@pytest.mark.parametrize("name", ["poisson7_f32_256", "helmholtz7_c64_256"])
@pytest.mark.parametrize("grid", [TINY_GRID, [5, 7, 6], [1, 3, 4]])
def test_generator_equals_port_problem(name, grid):
    cfg = config(name, grid)
    data, indices, indptr, shape = gen.csr_arrays(cfg)
    pdata, pindices, pindptr = port_csr(cfg)
    assert shape == (int(np.prod(grid)),) * 2
    assert data.dtype == pdata.dtype
    np.testing.assert_array_equal(indptr, pindptr)
    np.testing.assert_array_equal(indices, pindices)
    np.testing.assert_array_equal(data, pdata)


@pytest.mark.parametrize("name", ["poisson7_f32_256", "helmholtz7_c64_256"])
def test_reference_matvec_equals_port_csr(name):
    import scipy.sparse as sps

    cfg = config(name)
    data, indices, indptr = port_csr(cfg)
    n = int(np.prod(cfg["grid"]))
    S = sps.csr_matrix((data.astype(np.complex128), indices, indptr), shape=(n, n))
    rng = np.random.default_rng(3)
    x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    y = ref.matvec(cfg, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, S @ x, rtol=0, atol=1e-12)


def test_true_residual_judges_the_answer():
    cfg = config("poisson7_f32_256")
    n = int(np.prod(cfg["grid"]))
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(n))
    b = ref.matvec(cfg, x.clone())
    assert check.true_rel_residual(ref, cfg, x.float(), b.float()) < 1e-6
    bad = x.clone()
    bad[5] += 1.0
    assert check.true_rel_residual(ref, cfg, bad, b) > 1e-3
    bad[7] = float("nan")
    assert np.isnan(check.true_rel_residual(ref, cfg, bad, b))
