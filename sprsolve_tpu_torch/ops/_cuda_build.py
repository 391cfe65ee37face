"""Build the hand-written CUDA kernels at first use and load them with ctypes.

``csrc/*.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into one shared
library with a plain C interface.  The library's name carries a hash of the
sources and flags, so an edited source is rebuilt and an unchanged one is
loaded as built.  Builds go to ``build/kernels/`` at the root of the
checkout (listed in ``.gitignore``); a build is written under a temporary
name and renamed into place, so concurrent first calls cannot load half a
file.

Nothing here runs at import time: :func:`load` is called by the kernel
wrappers the first time they meet a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_SIGNATURES = {
    "sprsolve_dia_row_tile": ([], _I32),
    "sprsolve_dia_max_diags": ([], _I32),
    "sprsolve_cuda_error_string": ([_I32], ctypes.c_char_p),
    # vcode, bcode, bands, x, y, n_pad, h, offsets, nd, stream
    "sprsolve_dia_spmv": ([_I32, _I32, _P, _P, _P, _I64, _I64, _P, _I32, _P], _I32),
    # vcode, bcode, bands, x, dinv, w, y, partials, n_pad, h, offsets, nd, stream
    "sprsolve_dia_wdot": (
        [_I32, _I32, _P, _P, _P, _P, _P, _P, _I64, _I64, _P, _I32, _P], _I32
    ),
}


def build_dir() -> Path:
    """``build/kernels`` beside the package directory."""
    return CSRC.parent.parent / "build" / "kernels"


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def nvcc_path() -> str:
    """The nvcc of the CUDA toolkit PyTorch finds (``CUDA_HOME``, ``nvcc`` on
    ``PATH``, or the toolkit's default place), or RuntimeError."""
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [shutil.which("nvcc")]
    if CUDA_HOME:
        candidates.insert(0, os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of sprsolve_tpu_torch are built "
        "with the CUDA toolkit's nvcc (set CUDA_HOME or put nvcc on PATH)"
    )


def library_path() -> Path:
    return build_dir() / f"libsprsolve_kernels_{_digest()}.so"


def build() -> Path:
    """Compile every source into :func:`library_path` unless it exists.
    Returns the path; raises RuntimeError with nvcc's output on failure."""
    out = library_path()
    if out.exists():
        return out
    nvcc = nvcc_path()
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *(str(s) for s in sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build if needed, then load the library once per process, with every
    function's ``argtypes``/``restype`` declared."""
    lib = ctypes.CDLL(str(build()))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise RuntimeError if a launcher returned a CUDA error code."""
    if code != 0:
        msg = lib.sprsolve_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
