"""Nothing of the benchmark imports JAX or the JAX package, compared by the
whole top-level name (``sprsolve_tpu_torch`` is the code under test and
allowed, ``sprsolve_tpu`` is not), and the reference imports nothing of the
program; a run that finds either loaded prints no result."""

import ast
import io
import sys
import types
from pathlib import Path

import pytest

from sbhelpers import run_tiny, tiny_cell, workloads

from solvebench import harness

BENCH = Path(harness.__file__).resolve().parent


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".", 1)[0])
    return names


def sources(sub=""):
    return sorted(p for p in (BENCH / sub).rglob("*.py") if "tests" not in p.parts)


def test_no_jax_anywhere():
    for path in sources():
        bad = top_level_imports(path) & set(harness.FORBIDDEN)
        assert not bad, f"{path.name} imports {bad}"


def test_reference_imports_nothing_of_the_program():
    for path in sources("reference"):
        names = top_level_imports(path)
        assert "sprsolve_tpu_torch" not in names and "solvebench" not in names, path.name


def test_forbidden_names_compare_whole():
    saved = dict(sys.modules)
    try:
        sys.modules["sprsolve_tpu_torch_x"] = types.ModuleType("sprsolve_tpu_torch_x")
        sys.modules["jaxtyping"] = types.ModuleType("jaxtyping")
        assert harness.forbidden_modules() == []
        sys.modules["sprsolve_tpu.ops"] = types.ModuleType("sprsolve_tpu.ops")
        sys.modules["jaxlib"] = types.ModuleType("jaxlib")
        assert harness.forbidden_modules() == ["jaxlib", "sprsolve_tpu"]
    finally:
        for k in set(sys.modules) - set(saved):
            del sys.modules[k]


def test_run_with_jax_loaded_prints_no_result(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc, result, err = run_tiny(tiny_cell(workloads()[0]), seconds=0.05)
    assert rc != 0 and result is None
    assert "jax" in err


def test_no_card_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out, err = io.StringIO(), io.StringIO()
    rc = harness.main(["--workload", workloads()[0], "--seed", "1", "--seconds", "1",
                       "--trace", "0"], out=out, err=err)
    assert rc != 0 and out.getvalue() == ""
    assert "CUDA" in err.getvalue()


def test_benchmark_alone_prints_no_result(tmp_path):
    """In a directory with only BENCHMARK.json and the benchmark's folder,
    the program is missing: the run fails and prints no result."""
    import shutil
    import subprocess

    root = Path(harness.ROOT)
    shutil.copy(root / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(root / "solvebench", tmp_path / "solvebench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path[0] = '.'; from solvebench import harness; "
            "sys.exit(harness.main(['--workload', %r, '--seed', '1', '--seconds', '0.1', "
            "'--trace', '0'], require_cuda=False, device='cpu'))" % workloads()[0])
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                       text=True, timeout=120, env={"PATH": "/usr/bin:/bin"})
    assert p.returncode != 0 and p.stdout == ""
    assert "sprsolve_tpu_torch" in p.stderr
