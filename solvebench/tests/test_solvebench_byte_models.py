"""The frozen byte models agree with the port's own, and the profiler's
kernel names map to the right model."""

import importlib
import sys

import numpy as np
import pytest
import torch

from sbhelpers import ROOT

from solvebench import byte_models as bm
from sprsolve_tpu_torch.sparse.containers import DIA
from sprsolve_tpu_torch.utils import problems, timing

sys.path.insert(0, str(ROOT))
smoke = importlib.import_module("chip_smoke")


@pytest.mark.parametrize("n,nd,itemsize,band", [(1000, 7, 4, 1), (4096, 13, 8, None),
                                                (16777216, 7, 4, 2)])
def test_dia_bytes_equals_port(n, nd, itemsize, band):
    assert bm.dia_bytes(n, nd, itemsize, band) == timing.dia_bytes(n, nd, itemsize, band)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.complex64])
def test_nbytes_and_orth_norm_bytes_equal_port(dtype):
    a = torch.zeros(1000, dtype=dtype)
    b = torch.zeros((7, 900), dtype=torch.int8)
    assert bm.nbytes(a, b, a) == smoke.nbytes(a, b, a)
    assert bm.orth_norm_bytes(a, 50) == smoke.orth_norm_bytes(a, 50)


def _ops():
    from sprsolve_tpu_torch import PaddedDIA

    dia = DIA.from_csr(problems.poisson3d(12, 10, 8), device="cpu")
    real = PaddedDIA.from_dia(dia, device="cpu")
    cdia = DIA(bands=torch.from_numpy(dia.bands.numpy().astype(np.complex64)
                                      + np.where(np.array(dia.offsets)[:, None] == 0, 0.5j, 0)),
               offsets=dia.offsets, shape=dia.shape)
    cplx = PaddedDIA.from_dia(cdia, device="cpu")
    return real, cplx


REAL = {   # kernel name → the tensors chip_smoke counts for that launch
    "void dia_spmv_kernel<float, signed char, false>(signed char const*, float const*, "
    "float*, long long, long long, Offsets)": "bxy",
    "void dia_spmv_kernel_rows<float, signed char>(signed char const*)": "bxy",
    "void dia_dots_kernel<float, signed char, true, true, true>(signed char const*)": "bxdy",
    "void dia_dots_kernel<float, signed char, true, false, true>(signed char const*)": "bxdwy",
    "void dia_dots_kernel<float, signed char, false, true, false>(signed char const*)": "bxy",
    "_Z15dia_dots_kernelIfaLb0ELb1ELb1EEvPKT0_PKT_": "bxy",
    "_Z15dia_dots_kernelIfaLb1ELb0ELb1EEvPKT0_PKT_": "bxdwy",
}
COMPLEX = {
    "void dia_complex_spmv_kernel<float, signed char, __nv_bfloat16>(signed char const*)": "pxy",
    "void dia_complex_dots_kernel<float, signed char, __nv_bfloat16, true, false, true, "
    "false>(signed char const*)": "pxy",
    "void dia_complex_dots_kernel<float, signed char, __nv_bfloat16, false, true, true, "
    "true>(signed char const*)": "pxdy",
    "void dia_complex_dots_kernel<float, signed char, __nv_bfloat16, false, true, false, "
    "true>(signed char const*)": "pxdwy",
}


def _geometry(op, vec):
    from solvebench.harness import geometry_of

    return geometry_of(op, vec.element_size())


def test_launch_bytes_equal_chip_smoke_counts():
    real, cplx = _ops()
    for op, names, dtype in ((real, REAL, torch.float32), (cplx, COMPLEX, torch.complex64)):
        x = torch.zeros(op.n_pad + 2 * op.h, dtype=dtype)
        planes = (op.bands,) if hasattr(op, "bands") else (op.re.bands, op.im.bands)
        g = _geometry(op, x)
        for name, parts in names.items():
            tensors = [t for c in parts for t in
                       (planes if c in "bp" else (x,))]
            assert bm.launch_bytes(name, g) == smoke.nbytes(*tensors), name
    g = _geometry(real, torch.zeros(1))
    a = torch.zeros(real.n_pad + 2 * real.h)
    assert bm.launch_bytes("void orth_norm_kernel<float>(float const*)", g) == \
        smoke.orth_norm_bytes(a, real.h)


def test_names_that_are_not_hand_kernels():
    g = bm.Geometry(n_pad=64, h=8, nd=7, band_itemsizes=(1,), vec_itemsize=4)
    for name in ("void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor"
                 "<float>>(int, at::native::FillFunctor<float>)", "Memcpy DtoH (Device -> "
                 "Pinned)", "void cub::DeviceReduceKernel<float>(float)"):
        assert bm.parse_kernel(name) is None and bm.launch_bytes(name, g) is None
    # K1b's bytes depend on its block width, which the name does not say
    assert bm.parse_kernel("void dia_spmm_kernel<float, signed char, 8>(int)")[1] == "K1b"
    assert bm.launch_bytes("void dia_spmm_kernel<float, signed char, 8>(int)", g) is None
    assert bm.parse_kernel(
        "void dia_dots_kernel<float, signed char, false, true, false>()")[1] == "K3"
