"""Build and load the package's CUDA kernels.

All ``.cu`` sources under ``outgridvit_tpu_torch/csrc/`` are compiled by
``nvcc`` for ``sm_90a`` (one process per source, in parallel) into one
shared library with a plain C interface, loaded with ``ctypes``. The
``.cpp`` sources, plain C++ that answers the launch plans' questions about a
kernel's layout from the header the kernel itself includes, are compiled
by the host's ``c++`` into a second library (:func:`load_layouts`), so that
a plan is also made where there is no nvcc or card. Each build runs at
first use (never at import), into ``outgridvit_tpu_torch/_build/``, under a
name keyed on a hash of its sources, so an edit to any source rebuilds.

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
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")
HOST_FLAGS = ("-std=c++17", "-O2", "-fPIC", "-shared")

# element types the kernels take (enum DType in csrc/common.cuh)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# one H100 SM: shared memory (each block reserves 1 KB more), registers;
# the SMs of an H100 SXM
SM_SMEM, SM_BLOCK_RESERVED, SM_REGS, SMS = 228 * 1024, 1024, 65536, 132


def sm_blocks(threads: int, smem: int, regs: int) -> int:
    """Blocks of ``threads`` threads, ``smem`` shared bytes and ``regs``
    registers a thread that one H100 SM holds (at least one)."""
    return max(1, min(SM_REGS // (regs * threads),
                      SM_SMEM // (smem + SM_BLOCK_RESERVED)))


def check_aligned16(name: str, **tensors) -> None:
    """A ValueError naming the first tensor whose data is not 16-byte
    aligned: the tensor-core kernels copy 16 bytes at a time."""
    for label, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(
                f"{name}: {label} of shape {tuple(t.shape)} at "
                f"{t.data_ptr():#x} is not 16-byte aligned; the tensor-core "
                "kernel copies 16 bytes at a time")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signature of each entry point: (argtypes, restype). A launch returns a
# cudaError_t as int.
_SIGNATURES = {
    # qkv, out, G, N, C, heads, scale, dtype, stream
    "ogvt_grid_mhsa": ((_P, _P, _I, _I, _I, _I, _F, _I, _P), _I),
    # qkv, dout, dqkv, G, N, C, heads, scale, dtype, stream
    "ogvt_grid_mhsa_bwd": ((_P, _P, _P, _I, _I, _I, _I, _F, _I, _P), _I),
    # qkv, out, G, N, C, heads, scale, warps, smem, dtype, stream
    "ogvt_grid_mhsa_th": ((_P, _P, _I, _I, _I, _I, _F, _I, _I, _I, _P), _I),
    # qkv, dout, dqkv, G, N, C, heads, scale, warps, smem, dtype, stream
    "ogvt_grid_mhsa_th_bwd": ((_P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _I,
                               _P), _I),
    # x, ln_scale, ln_bias, w1, b1, w2, b2, y, M, C, H, act, eps, apply_ln,
    # dtype, stream
    "ogvt_mlp_branch": ((_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F,
                         _I, _I, _P), _I),
    # the same, then the plan: split, buffers, blocks, smem; stream
    "ogvt_mlp_branch_mma": ((_P,) * 8 + (_I, _I, _I, _I, _F, _I, _I)
                            + (_I,) * 4 + (_P,), _I),
    # x, ln_scale, ln_bias, w1, b1, w2, dy, dx, dln_scale, dln_bias, dw1,
    # db1, dw2, db2, workspace, M, C, H, act, eps, apply_ln, dtype, stream
    "ogvt_mlp_branch_bwd": ((_P,) * 15 + (_I, _I, _I, _I, _F, _I, _I, _P),
                            _I),
    # M, C, H -> floats of workspace
    "ogvt_mlp_branch_bwd_workspace": ((_I, _I, _I), ctypes.c_longlong),
    # the same pointers, M, C, H, act, eps, apply_ln, dtype; the plan:
    # t_split, t_buffers, t_blocks, t_smem, w_units, w_rows, w_mt,
    # w_buffers, w_splits, w_smem; stream
    "ogvt_mlp_branch_bwd_mma": ((_P,) * 15 + (_I, _I, _I, _I, _F, _I, _I)
                                + (_I,) * 10 + (_P,), _I),
    # M, C, H, t_blocks, w_splits -> floats of workspace
    "ogvt_mlp_branch_bwd_mma_workspace": ((_I,) * 5, ctypes.c_longlong),
    # x, ln_scale, ln_bias, wqkv, bqkv, wp, bp, y, G, N, C, heads, scale, eps,
    # apply_ln, dtype, stream
    "ogvt_attn_branch": ((_P,) * 8 + (_I, _I, _I, _I, _F, _F, _I, _I, _P),
                         _I),
    # the same, then the plan: blocks, grids a block, smem; stream
    "ogvt_attn_branch_mma": ((_P,) * 8 + (_I, _I, _I, _I, _F, _F, _I, _I)
                             + (_I,) * 3 + (_P,), _I),
    # x, ln_scale, ln_bias, wqkv, bqkv, wp, dy, dx, dln_scale, dln_bias,
    # dwqkv, dbqkv, dwp, dbp, workspace, G, N, C, heads, scale, eps,
    # apply_ln, dtype, stream
    "ogvt_attn_branch_bwd": ((_P,) * 15 + (_I, _I, _I, _I, _F, _F, _I, _I,
                                           _P), _I),
    # G, C -> floats of workspace
    "ogvt_attn_branch_bwd_workspace": ((_I, _I), ctypes.c_longlong),
    # x, ln_scale, ln_bias, wqkv, bqkv, wp, bp, y, B, H, W, C, g, heads,
    # scale, eps, apply_ln, dtype, stream
    "ogvt_attn_branch_nhwc": ((_P,) * 8 + (_I,) * 6 + (_F, _F, _I, _I, _P),
                              _I),
    # the same, then the plan: blocks, grids a block, smem; stream
    "ogvt_attn_branch_nhwc_mma": ((_P,) * 8 + (_I,) * 6 + (_F, _F, _I, _I)
                                  + (_I,) * 3 + (_P,), _I),
    # x, ln_scale, ln_bias, wqkv, bqkv, wp, dy, dx, dln_scale, dln_bias,
    # dwqkv, dbqkv, dwp, dbp, workspace, B, H, W, C, g, heads, scale, eps,
    # apply_ln, dtype, stream
    "ogvt_attn_branch_nhwc_bwd": ((_P,) * 15 + (_I,) * 6 + (_F, _F, _I, _I,
                                                           _P), _I),
    # the same pointers, G, N, C, heads, scale, eps, apply_ln, dtype; the
    # plan: t_blocks, t_grids, t_smem, w_splits, w_grids, w_smem; stream
    "ogvt_attn_branch_bwd_mma": ((_P,) * 15 + (_I, _I, _I, _I, _F, _F, _I,
                                               _I) + (_I,) * 6 + (_P,), _I),
    # the same on B, H, W, C, g, heads
    "ogvt_attn_branch_nhwc_bwd_mma": ((_P,) * 15 + (_I,) * 6 + (_F, _F, _I,
                                                               _I)
                                      + (_I,) * 6 + (_P,), _I),
    # G, C, t_blocks, w_splits -> floats of workspace
    "ogvt_attn_branch_bwd_mma_workspace": ((_I,) * 4, ctypes.c_longlong),
    # qkv, out, G, N, C, heads, scale, dtype, stream
    "ogvt_grid_mhsa_packed": ((_P, _P, _I, _I, _I, _I, _F, _I, _P), _I),
    # qkv, dout, dqkv, G, N, C, heads, scale, dtype, stream
    "ogvt_grid_mhsa_packed_bwd": ((_P, _P, _P, _I, _I, _I, _I, _F, _I, _P),
                                  _I),
    # qkv, out, G, N, C, heads, scale, warps, smem, dtype, stream
    "ogvt_grid_mhsa_packed_mma": ((_P, _P, _I, _I, _I, _I, _F, _I, _I, _I,
                                   _P), _I),
    # qkv, dout, dqkv, G, N, C, heads, scale, warps, smem, dtype, stream
    "ogvt_grid_mhsa_packed_mma_bwd": ((_P, _P, _P, _I, _I, _I, _I, _F, _I,
                                       _I, _I, _P), _I),
    # qkv, out, G, N, C, heads, scale, warps, smem, dtype, stream
    "ogvt_grid_mhsa_long": ((_P, _P, _I, _I, _I, _I, _F, _I, _I, _I, _P),
                            _I),
    # qkv, dout, dqkv, G, N, C, heads, scale, warps, smem, dtype, stream
    "ogvt_grid_mhsa_long_bwd": ((_P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _I,
                                 _P), _I),
    # qkv, out, saved (or null), G, N, C, heads, scale, parts, warps, smem,
    # stream
    "ogvt_grid_mhsa_tiles": ((_P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _I,
                              _P), _I),
    # qkv, dout, dqkv, saved, dsum, G, N, C, heads, scale, parts, warps,
    # smem_query, smem_key, stream
    "ogvt_grid_mhsa_tiles_bwd": ((_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I,
                                  _I, _I, _I, _P), _I),
    # x, a, wv, bv, wp, bp, out, B, H, W, Cin, C, heads, rows, fold, dtype,
    # stream
    "ogvt_outlook_agg": ((_P,) * 7 + (_I,) * 9 + (_P,), _I),
    # the same pointers, B, H, W, Cin, C, heads; the plan: rows, chunk;
    # fold, dtype; the plan: blocks, smem; stream
    "ogvt_outlook_agg_fwd_mma": ((_P,) * 7 + (_I,) * 12 + (_P,), _I),
    # x, a, wv, bv, wp, g, dx, da, dwv, dbv, dwp, dbp, workspace, B, H, W,
    # Cin, C, heads, rows, fold, dtype, stream
    "ogvt_outlook_agg_bwd": ((_P,) * 13 + (_I,) * 9 + (_P,), _I),
    # B, H, W, Cin, C, heads, rows, fold -> floats of workspace
    "ogvt_outlook_agg_bwd_workspace": ((_I,) * 8, ctypes.c_longlong),
    # the same pointers, B, H, W, Cin, C, heads; the plan: rows, chunk;
    # fold, dtype; the plan: blocks, smem; stream
    "ogvt_outlook_agg_bwd_mma": ((_P,) * 13 + (_I,) * 12 + (_P,), _I),
    # Cin, C, fold, blocks -> floats of workspace
    "ogvt_outlook_agg_bwd_mma_workspace": ((_I,) * 4, ctypes.c_longlong),
    # v, logits, out, B, H, W, C, heads, k, dtype, stream
    "ogvt_outlook_softmax": ((_P,) * 3 + (_I,) * 7 + (_P,), _I),
    # v, logits, out, B, H, W, C, heads; the plan: rows, pix; dtype; the
    # plan: blocks, smem; stream
    "ogvt_outlook_softmax_rows": ((_P,) * 3 + (_I,) * 10 + (_P,), _I),
    # x, w9, y, B, H, W, C, rows, tw, chunk, bands, parts, smem, vecio, dtype,
    # stream
    "ogvt_dwconv3x3": ((_P,) * 3 + (_I,) * 12 + (_P,), _I),
    # x, w9, dy, dx, dw, workspace, B, H, W, C, rows, chunk, bands, parts,
    # smem, vecio, dtype, stream
    "ogvt_dwconv3x3_bwd": ((_P,) * 6 + (_I,) * 11 + (_P,), _I),
    "ogvt_error_string": ((_I,), ctypes.c_char_p),
}
# The same for the layout library's functions (csrc/*.cpp): 0, or 1 where
# the kernel does not take the layout.
_HOST_SIGNATURES = {
    # C, H, split, weight buffers, activation code, int out[5]
    "ogvt_mlp_branch_fwd_mma_layout": ((_I, _I, _I, _I, _I, _P), _I),
    # C, split, weight buffers, int out[5]
    "ogvt_mlp_branch_bwd_mma_tokens_layout": ((_I, _I, _I, _P), _I),
    # C, units, rows, buffers, int out[4]
    "ogvt_mlp_branch_bwd_mma_weights_layout": ((_I, _I, _I, _I, _P), _I),
    # N, C, heads, int out[3]
    "ogvt_attn_branch_mma_fwd_layout": ((_I, _I, _I, _P), _I),
    # N, C, heads, int out[3]
    "ogvt_attn_branch_bwd_mma_tokens_layout": ((_I, _I, _I, _P), _I),
    # N, C, heads, int out[3]
    "ogvt_attn_branch_bwd_mma_weights_layout": ((_I, _I, _I, _P), _I),
    # N, C, heads, backward, int out[6]
    "ogvt_grid_mhsa_th_layout": ((_I, _I, _I, _I, _P), _I),
    # N, C, heads, backward, int out[11]
    "ogvt_grid_mhsa_tiles_layout": ((_I, _I, _I, _I, _P), _I),
    # W, Cin, C, heads, rows, chunk, fold, int out[4]
    "ogvt_outlook_agg_bwd_mma_layout": ((_I,) * 7 + (_P,), _I),
    # W, Cin, C, heads, rows, chunk, fold, int out[3]
    "ogvt_outlook_agg_fwd_mma_layout": ((_I,) * 7 + (_P,), _I),
    # W, C, heads, rows, pix, int out[3]
    "ogvt_outlook_softmax_rows_layout": ((_I,) * 5 + (_P,), _I),
}


@dataclass(frozen=True)
class BuildResult:
    path: Path
    built: bool  # False when the library for these sources already existed
    seconds: float
    log: str  # nvcc's output (ptxas register / shared-memory report)


def _sources(suffixes=(".cu", ".cuh", ".h")):
    return sorted(p for p in CSRC_DIR.iterdir() if p.suffix in suffixes)


def _keyed(stem: str, sources, flags) -> Path:
    h = hashlib.sha256()
    for p in sources:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"{stem}_{h.hexdigest()[:16]}.so"


def library_path() -> Path:
    return _keyed("libogvt_kernels", _sources(), NVCC_FLAGS + LINK_FLAGS)


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
    """Compile the kernels unless the library for these sources exists: one
    ``nvcc -c`` per source, all started together, then one link."""
    out = library_path()
    if out.exists():
        return BuildResult(out, False, 0.0, "")
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in (p for p in _sources() if p.suffix == ".cu"):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        procs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
        objs.append(obj)
    log = []
    failed = []
    for cmd, proc in procs:
        text, _ = proc.communicate()
        log.append(text)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                          f"\n{text}")
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if not failed:
        cmd = [nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"nvcc link failed ({proc.returncode}): "
                          f"{' '.join(cmd)}\n{log[-1]}")
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("\n".join(failed))
    os.replace(tmp, out)  # atomic: a reader never sees a half-written .so
    return BuildResult(out, True, time.perf_counter() - t0, "".join(log))


_lib: Optional[ctypes.CDLL] = None


def load() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build().path))
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _lib = lib
    return _lib


_layouts: Optional[ctypes.CDLL] = None


def load_layouts() -> ctypes.CDLL:
    """The loaded layout library: the ``.cpp`` sources, built first if
    needed by one ``c++`` call (``$CXX``, else ``c++`` on ``PATH``)."""
    global _layouts
    if _layouts is None:
        out = _keyed("libogvt_layouts", _sources((".cpp", ".h")), HOST_FLAGS)
        if not out.exists():
            cxx = os.environ.get("CXX") or shutil.which("c++")
            if not cxx:
                raise RuntimeError("no C++ compiler ($CXX, or c++ on PATH); "
                                   "the kernels' layouts cannot be built")
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [cxx, *HOST_FLAGS, "-o", str(tmp),
                   *map(str, _sources((".cpp",)))]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"c++ failed ({proc.returncode}): "
                                   f"{' '.join(cmd)}\n{proc.stdout}"
                                   f"{proc.stderr}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        for name, (argtypes, restype) in _HOST_SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _layouts = lib
    return _layouts


def check_variant(name: str, variant: str, variants) -> None:
    if variant not in variants:
        raise ValueError(f"{name}: variant {variant!r} is not one of "
                         f"{variants}")


def count_launch(fn, variant: Optional[str],
                 entry: Optional[str] = None) -> None:
    """Count one kernel launch on the wrapper ``fn``: ``fn.launches``;
    ``fn.by_variant[variant]``, the JAX kernel the launch stands for, for a
    wrapper that stands for more than one; ``fn.by_entry[entry]`` for a
    wrapper with more than one C entry point."""
    fn.launches += 1
    if variant is not None:
        fn.by_variant[variant] += 1
    if entry is not None:
        fn.by_entry[entry] += 1


def tracing() -> bool:
    """True while ``torch.export`` or ``torch.compile`` traces the caller.
    A kernel wrapper then returns its ``ogvt::`` custom op
    (:func:`traced_op`) in place of launching: the tracer's tensors hold no
    data, so no pointer, plan or launch can be made from them."""
    return torch.compiler.is_compiling() or torch.compiler.is_exporting()


def traced_op(name: str):
    """The custom op ``ogvt::name`` of ``ops/library.py`` (registered on
    this first use while tracing, if nothing imported the library
    before)."""
    from outgridvit_tpu_torch.ops import library  # noqa: F401

    return getattr(torch.ops.ogvt, name)


def check(err: int, what: str) -> None:
    if err != 0:
        msg = load().ogvt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
