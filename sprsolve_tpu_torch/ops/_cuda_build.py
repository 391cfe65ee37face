"""Build the hand-written CUDA kernels at first use and load them with ctypes.

Each ``csrc/*.cu`` is compiled by its own ``nvcc`` for Hopper (``sm_90a``),
all started together, and the objects are linked into one shared library
with a plain C interface.  The long pole, ``dia_complex.cu`` with its 60
K6/K7 instantiations, is optimised on every core (``-split-compile=0``,
:data:`SPLIT_COMPILE`).  Each source stands alone (it includes no header of
its own), and the library's name carries a hash of the sources and
flags, so an edited source is rebuilt and an unchanged one is loaded as
built.  Builds go to
``build/kernels/`` at the root of the checkout (listed in ``.gitignore``); a
build is written under a temporary name and renamed into place, so
concurrent first calls cannot load half a file.

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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)
# sources whose device code nvcc optimises in parallel: dia_complex.cu's
# build fell from the longest by far to below a minute on the card's
# machine; dia_spmv.cu built so ran K3 about 1.3 µs slower, so it and
# fused.cu keep the serial build
SPLIT_COMPILE = ("dia_complex.cu",)

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_SIGNATURES = {
    "sprsolve_dia_row_tile": ([], _I32),
    "sprsolve_dia_max_diags": ([], _I32),
    "sprsolve_cuda_error_string": ([_I32], ctypes.c_char_p),
    "sprsolve_dia_dots_tile": ([], _I32),
    "sprsolve_dia_dots_scratch_head": ([], _I32),
    "sprsolve_dia_dots_blocks_per_sm": ([_I32], _I32),   # vcode
    # vcode, bcode, bands, x, y, n_pad, h, offsets, nd, quads, sm_count, stream_bands,
    # stream
    "sprsolve_dia_spmv": ([_I32, _I32, _P, _P, _P, _I64, _I64, _P, _I32, _I32, _I32, _I32,
                           _P], _I32),
    "sprsolve_dia_spmm_threads": ([], _I32),
    "sprsolve_dia_spmm_width": ([_I32, _I64, _P, _P], _I32),   # vcode, m, x, y
    # vcode, bcode, bands, x, y, n_pad, h, m, offsets, nd, sm_count, stream
    "sprsolve_dia_spmm": (
        [_I32, _I32, _P, _P, _P, _I64, _I64, _I64, _P, _I32, _I32, _P], _I32
    ),
    # vcode, bcode, bands, x, dinv, w, y, out, scratch, scratch_bytes, grid,
    # n_pad, h, offsets, nd, stream
    "sprsolve_dia_wdot": (
        [_I32, _I32, _P, _P, _P, _P, _P, _P, _P, _I64, _I32, _I64, _I64, _P, _I32, _P],
        _I32,
    ),
    # vcode, bcode, bands, x, y, out, scratch, scratch_bytes, grid, n_pad, h,
    # offsets, nd, stream
    "sprsolve_dia_dot": (
        [_I32, _I32, _P, _P, _P, _P, _P, _I64, _I32, _I64, _I64, _P, _I32, _P], _I32
    ),
    "sprsolve_orth_norm_tile": ([], _I32),
    "sprsolve_orth_norm_blocks_per_sm": ([_I32], _I32),   # vcode
    # vcode, a, v_old, v, beta, alpha, out, sumsq, scratch, scratch_bytes, grid,
    # n_pad, h, stream
    "sprsolve_orth_norm": (
        [_I32, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _I32, _I64, _I64, _P], _I32
    ),
    "sprsolve_cg_tile": ([], _I32),
    "sprsolve_cg_update_blocks_per_sm": ([_I32], _I32),      # vcode
    "sprsolve_cg_direction_blocks_per_sm": ([_I32], _I32),   # vcode
    # vcode, x, p, r, q, dinv, rz, pq, tol, x_out, r_out, stats, scratch,
    # scratch_bytes, grid, n, stream
    "sprsolve_cg_update": (
        [_I32, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _I32, _I64, _P], _I32
    ),
    # vcode, r, dinv, p, rz_next, rz, p_out, grid, n, stream
    "sprsolve_cg_direction": ([_I32, _P, _P, _P, _P, _P, _P, _I32, _I64, _P], _I32),
    "sprsolve_csm_tile": ([], _I32),
    "sprsolve_csm_slots": ([], _I32),
    "sprsolve_csm_lanczos_blocks_per_sm": ([_I32], _I32),   # vcode
    "sprsolve_csm_update_blocks_per_sm": ([_I32], _I32),    # vcode
    # vcode, y, v_old, v, dinv, alpha, state, w_out, scratch, scratch_bytes,
    # grid, n, stream
    "sprsolve_csm_lanczos": (
        [_I32, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _I32, _I64, _P], _I32
    ),
    # vcode, w, p, p_old, x, v_next, w_next, state, grid, n, stream
    "sprsolve_csm_update": ([_I32, _P, _P, _P, _P, _P, _P, _P, _I32, _I64, _P], _I32),
    # vcode, bcode, bands, z, r, n_pad, h, nx, ny, nz, color, offsets, nd, diag,
    # first, stream
    "sprsolve_gs_color_step": (
        [_I32, _I32, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _I32, _P, _I32, _I32, _I32,
         _P], _I32
    ),
    # vcode, re_code, im_code, bre, bim, x, y, n_pad, h, offsets, nd, stream
    "sprsolve_dia_complex_spmv": (
        [_I32, _I32, _I32, _P, _P, _P, _P, _I64, _I64, _P, _I32, _P], _I32
    ),
    "sprsolve_dia_complex_dots_tile": ([], _I32),
    "sprsolve_dia_complex_dots_blocks_per_sm": ([_I32], _I32),   # vcode
    # vcode, re_code, im_code, conj_x, bre, bim, x, y, out, scratch,
    # scratch_bytes, grid, n_pad, h, offsets, nd, stream
    "sprsolve_dia_complex_dot": (
        [_I32, _I32, _I32, _I32, _P, _P, _P, _P, _P, _P, _I64, _I32, _I64, _I64, _P,
         _I32, _P],
        _I32,
    ),
    # vcode, re_code, im_code, bre, bim, x, dinv, w, y, out, scratch,
    # scratch_bytes, grid, n_pad, h, offsets, nd, stream
    "sprsolve_dia_complex_wdot": (
        [_I32, _I32, _I32, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _I32, _I64, _I64, _P,
         _I32, _P],
        _I32,
    ),
}


def build_dir() -> Path:
    """``build/kernels`` beside the package directory."""
    return CSRC.parent.parent / "build" / "kernels"


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join((*NVCC_FLAGS, *SPLIT_COMPILE)).encode())
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


def _run_all(cmds) -> None:
    """Run the commands side by side; wait for all, then raise RuntimeError
    with the output of the first that failed."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for cmd in cmds]
    outputs = [p.communicate() for p in procs]
    for cmd, p, (out, err) in zip(cmds, procs, outputs):
        if p.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{out}\n{err}"
            )


def build() -> Path:
    """Compile every source into :func:`library_path` unless it exists: one
    nvcc per source, all started together, then one link.  Returns the
    path; raises RuntimeError with nvcc's output on failure."""
    out = library_path()
    if out.exists():
        return out
    nvcc = nvcc_path()
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs = [os.path.join(tmp, src.stem + ".o") for src in sources()]
        _run_all([[nvcc, *NVCC_FLAGS, *(["-split-compile=0"] if src.name in SPLIT_COMPILE
                                         else []), "-c", "-o", obj, str(src)]
                  for src, obj in zip(sources(), objs)])
        lib = os.path.join(tmp, out.name)
        _run_all([[nvcc, "-shared", "-o", lib, *objs]])
        os.replace(lib, out)
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
