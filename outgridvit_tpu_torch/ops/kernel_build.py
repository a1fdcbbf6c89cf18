"""Build and load the package's CUDA kernels.

All sources under ``outgridvit_tpu_torch/csrc/`` are compiled by ``nvcc``
for ``sm_90a`` into one shared library with a plain C interface, loaded with
``ctypes``. The build runs at first use (never at import), into
``outgridvit_tpu_torch/_build/``, under a name keyed on a hash of the
sources, so an edit to any source rebuilds.

C entry points return a ``cudaError_t`` from ``cudaGetLastError()`` after
their launch; :func:`check` turns a non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import torch

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# element types the kernels take (enum DType in csrc/common.cuh)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signature of each entry point: argtypes (restype is int: cudaError_t)
_SIGNATURES = {
    # qkv, out, G, N, C, heads, scale, dtype, stream
    "ogvt_grid_mhsa": (_P, _P, _I, _I, _I, _I, _F, _I, _P),
    # x, ln_scale, ln_bias, w1, b1, w2, b2, y, M, C, H, act, eps, apply_ln,
    # dtype, stream
    "ogvt_mlp_branch": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F,
                        _I, _I, _P),
}


@dataclass(frozen=True)
class BuildResult:
    path: Path
    built: bool  # False when the library for these sources already existed
    seconds: float
    log: str  # nvcc's output (ptxas register / shared-memory report)


def _sources():
    return sorted(p for p in CSRC_DIR.iterdir()
                  if p.suffix in (".cu", ".cuh"))


def library_path() -> Path:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libogvt_kernels_{h.hexdigest()[:16]}.so"


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, then ``nvcc`` on ``PATH``, then
    ``/usr/local/cuda/bin/nvcc``."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(Path(on_path))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin); the CUDA kernels cannot be built")


def build() -> BuildResult:
    """Compile the kernels unless the library for these sources exists."""
    out = library_path()
    if out.exists():
        return BuildResult(out, False, 0.0, "")
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
           *[str(p) for p in _sources() if p.suffix == ".cu"]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
    os.replace(tmp, out)  # atomic: a reader never sees a half-written .so
    return BuildResult(out, True, seconds, log)


_lib: Optional[ctypes.CDLL] = None


def load() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build().path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.ogvt_error_string.argtypes = (ctypes.c_int,)
        lib.ogvt_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    if err != 0:
        msg = load().ogvt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
