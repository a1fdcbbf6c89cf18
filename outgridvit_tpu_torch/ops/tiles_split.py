"""Where the device time of #6's backward past 256 tokens
(``csrc/grid_mhsa_tiles.cu``, bf16) goes between its two kernels. A probe
source includes the kernel's source as it is and adds one entry point that
launches the query-row kernel or the key-row kernel alone, at hd 24 (the
7M model's stage 0), with the package's launch plan. At the stage 0 of
the 7M model at 192 and 224 px, train batch 32 (G = 2048 grids of N = 576
/ 784, C = 48, 2 heads), each kernel alone and the whole backward
(``grid_mhsa_packed_backward`` from the forward's row statistics) are
timed in CUDA graphs in turns (in order, then in reverse); each kernel's
part of dqkv is held bit for bit to the whole backward's. Then each
backward kernel's static SASS instructions by opcode (``cuobjdump
-sass``). Needs nvcc and one card; imports no JAX::

    python -m outgridvit_tpu_torch.ops.tiles_split
"""

from __future__ import annotations

import collections
import ctypes
import re
import subprocess
import tempfile
from pathlib import Path

import torch

from outgridvit_tpu_torch.ops import grid_attention as ga
from outgridvit_tpu_torch.ops import kernel_build
from outgridvit_tpu_torch.ops.attn_ablation import _graph_ms

NT = 3  # hd 24
_PROBE = r"""
#include "grid_mhsa_tiles.cu"

// which: 0 the query-row kernel, 1 the key-row kernel, at hd = 8 * NT
extern "C" int probe_bwd_kernel(int which, const void* qkv, const void* dout,
                                void* dqkv, const void* saved, void* dsum,
                                int G, int N, int C, int heads, float scale,
                                int parts, int warps, int smem,
                                void* stream) {
  const dim3 grid(G * heads * parts), block(32 * warps);
  const int covered = lay::covered(N);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto q = static_cast<const bf16*>(qkv);
  const auto g = static_cast<const bf16*>(dout);
  const auto s = static_cast<const float*>(saved);
  if (which == 0) {
    set_smem(tiles_bwd_query<NT>, smem);
    tiles_bwd_query<NT><<<grid, block, smem, st>>>(
        q, g, static_cast<bf16*>(dqkv), s, static_cast<float*>(dsum), N,
        heads, parts, covered, scale);
  } else {
    set_smem(tiles_bwd_key<NT>, smem);
    tiles_bwd_key<NT><<<grid, block, smem, st>>>(
        q, g, static_cast<bf16*>(dqkv), s, static_cast<const float*>(dsum),
        N, heads, parts, covered, scale);
  }
  return cudaGetLastError();
}
"""
# (label, N) of the stage-0 shapes, train batch 32
SHAPES = (("a7m_192 B=32", 576), ("a7m_224 B=32", 784))
G, C, HEADS = 2048, 48, 2


def _build(tmp: Path) -> Path:
    src, out = tmp / "probe.cu", tmp / "libprobe.so"
    src.write_text(_PROBE.replace("NT>", f"{NT}>"))
    subprocess.run([kernel_build.find_nvcc(), *kernel_build.NVCC_FLAGS,
                    "-shared", "-I", str(kernel_build.CSRC_DIR), "-o",
                    str(out), str(src)], check=True, capture_output=True,
                   timeout=900)
    return out


def sass_counts(tmp: Path) -> dict:
    """{kernel: Counter of static SASS opcodes} of the two backward
    kernels at NT, from the source compiled alone for sm_90a."""
    cubin = tmp / "tiles.cubin"
    subprocess.run([kernel_build.find_nvcc(), *kernel_build.NVCC_FLAGS[:6],
                    "-cubin", "-o", str(cubin),
                    str(kernel_build.CSRC_DIR / "grid_mhsa_tiles.cu")],
                   check=True, capture_output=True, timeout=900)
    sass = subprocess.run(["cuobjdump", "-sass", str(cubin)], check=True,
                          capture_output=True, text=True).stdout
    out = {}
    for body in sass.split("Function : ")[1:]:
        name = body.split("\n", 1)[0]
        kind = re.search(rf"tiles_bwd_(query|key)ILi{NT}E", name)
        if kind:
            out[kind.group(1)] = collections.Counter(
                m.group(1).split(".")[0] for m in re.finditer(
                    r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)",
                    body) if m.group(1) != "NOP")
    return out


def split() -> tuple[dict, dict]:
    """({shape label: {"query" / "key" / "backward": device µs}}, the SASS
    counts)."""
    kernel_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    times = {}
    with tempfile.TemporaryDirectory(dir=kernel_build.BUILD_DIR) as tmp:
        lib = ctypes.CDLL(str(_build(Path(tmp))))
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.probe_bwd_kernel.argtypes = (I, P, P, P, P, P, I, I, I, I,
                                         ctypes.c_float, I, I, I, P)
        counts = sass_counts(Path(tmp))
        gen = torch.Generator().manual_seed(0)
        for label, N in SHAPES:
            qkv = torch.randn(G, N, 3 * C, generator=gen).cuda().bfloat16()
            dout = torch.randn(G, N, C, generator=gen).cuda().bfloat16()
            _, stats = ga.grid_mhsa_packed(qkv, HEADS, save_stats=True)
            p = ga.grid_mhsa_tiles_plan(G, N, C, HEADS, True)
            dqkv = torch.zeros_like(qkv)
            dsum = torch.empty(p.scratch_floats, device="cuda")

            def alone(which):
                err = lib.probe_bwd_kernel(
                    which, qkv.data_ptr(), dout.data_ptr(), dqkv.data_ptr(),
                    stats.data_ptr(), dsum.data_ptr(), G, N, C, HEADS,
                    ctypes.c_float((C // HEADS) ** -0.5), p.parts, p.warps,
                    p.smem_key if which else p.smem_bytes,
                    torch.cuda.current_stream().cuda_stream)
                kernel_build.check(err, f"tiles_split kernel {which}")

            alone(0)
            alone(1)
            want = ga.grid_mhsa_packed_backward(qkv, dout, HEADS, stats)
            if not torch.equal(dqkv, want):
                raise RuntimeError(f"{label}: the kernels alone differ from "
                                   "the package's backward")
            fns = {"query": lambda: alone(0), "key": lambda: alone(1),
                   "backward": lambda: ga.grid_mhsa_packed_backward(
                       qkv, dout, HEADS, stats)}
            runs = {n: [] for n in fns}
            for n in [*fns, *reversed(fns)]:
                runs[n].append(_graph_ms(fns[n], 10) * 1e3)
            times[label] = {n: sum(v) / len(v) for n, v in runs.items()}
            del qkv, dout, stats, dqkv, dsum, want
            torch.cuda.empty_cache()
    return times, counts


if __name__ == "__main__":
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    times, counts = split()
    for label, t in times.items():
        print(f"{label}: query kernel {t['query']:.1f} us, key kernel "
              f"{t['key']:.1f} us, whole backward {t['backward']:.1f} us "
              f"a launch (device time) [{gpu}]")
    for kind, c in counts.items():
        total = sum(c.values())
        print(f"tiles_bwd_{kind}<{NT}>: {total} static SASS instructions; "
              + ", ".join(f"{op} {n}" for op, n in c.most_common(16))
              + f"; HMMA {c['HMMA']} ({c['HMMA'] / total:.1%}), MUFU "
              f"{c['MUFU']} ({c['MUFU'] / total:.1%})")
