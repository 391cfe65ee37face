"""The port's examples run in process with ``--device cpu``: ``demo``
prints what the JAX package's ``examples/demo.py`` prints (the nonzero
pattern, A·rhs and the solution to 3 decimals; the BiCGStab count within
the band of ``tests/test_serial_parity.py:183``), ``tour`` completes with
every reported residual within its section's tolerance (×10), and
``eigen_tour`` matches its dense oracle to the 8 digits it prints, and
``distributed_demo`` solves the 16³ Poisson with each row-partitioning
strategy on 2 gloo ranks and on one device to a true residual of 1e-11,
the counts within the band of ``tests/test_serial_parity.py:183``."""

import importlib.util
import os
import re

import numpy as np
import pytest
import torch

from sprsolve_tpu_torch.examples import demo, distributed_demo, eigen_tour, tour

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _jax_demo_output(capsys) -> str:
    spec = importlib.util.spec_from_file_location(
        "jax_demo", os.path.join(REPO, "examples", "demo.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main()
    return capsys.readouterr().out


def test_demo_prints_what_the_jax_demo_prints(capsys):
    want = _jax_demo_output(capsys)
    assert demo.main(["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    its = [int(re.search(r"solved in (\d+) iterations", t).group(1)) for t in (got, want)]
    assert abs(its[0] - its[1]) <= max(3, -(-its[1] // 4))
    strip = lambda t: re.sub(r"solved in \d+ iterations, relative residual \S+", "", t)
    assert strip(got) == strip(want)


# the tol each section of the tour solves to (1e-10 where not listed)
TOUR_TOL = {"BiCGStab (object API):": 1e-15, "BiCGStab + Jacobi:": 1e-15,
            "GMRES(32)": 1e-12, "IDR(4)": 1e-12, "CS-MINRES (c128)": 1e-12,
            "COCG + complex Jacobi": 1e-12, "CS-MINRES + |d| Jacobi": 1e-12,
            "LSQR (120x40)": 1e-11, "refine_solve (f64 via f32)": 1e-13,
            "mmread/mmwrite round trip": 1e-12, "scipy_compat.bicgstab": 1e-12}


def test_tour_completes_within_its_tolerances(capsys):
    assert tour.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.rstrip().endswith("tour complete.")
    lines = out.splitlines()
    assert len(lines) == 24
    for line in lines:
        m = re.search(r"(rel-res|\|\|A\^T r\|\|) (\S+)", line)
        if m:
            label = line[:27].strip()
            assert float(m.group(2)) <= 10 * TOUR_TOL.get(label, 1e-10), line


    assert re.search(r"LOBPCG smallest 3 .*lambda = \[0\.0315 0\.0786 0\.0786\]", out)
    assert re.search(r"shift-invert eigs @ 2\.0 .*lambda = \[2\.0072 2\.0072 2\.0149\]", out)


def test_eigen_tour_matches_its_oracle(capsys):
    assert eigen_tour.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    lines = out.splitlines()
    assert len(lines) == 4
    for line in lines:
        got, want = (np.array([float(v) for v in s.split()])
                     for s in re.findall(r"\[([^\]]*)\]", line))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
        assert "INSUFFICIENT" not in line


def test_examples_need_cuda_or_a_device():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device exists")
    for mod in (demo, tour, eigen_tour, distributed_demo):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.main([])


def test_distributed_demo_solves_with_each_strategy(capsys):
    assert distributed_demo.main(["--device", "cpu", "--grid", "16"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("ranks: 2 (gloo) on cpu; the 16³ Poisson, 4096 rows")
    rows = [re.match(r"(.{28}): +(\d+) iters, true rel res (\S+)", ln) for ln in lines[1:]]
    assert [m.group(1).strip() for m in rows] == [
        "AllGatherELL + Jacobi", "HaloDIA + Jacobi", "DistPaddedDIA (kernels)",
        "single-device PaddedDIA"]
    its = [int(m.group(2)) for m in rows]
    assert all(float(m.group(3)) <= 1e-11 for m in rows), lines
    assert all(abs(k - its[-1]) <= max(3, -(-its[-1] // 4)) for k in its), its
