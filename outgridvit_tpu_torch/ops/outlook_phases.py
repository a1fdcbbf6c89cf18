"""Where the device time of the outlook backward's tensor-core kernel
(``csrc/outlook_agg_bwd_mma.cu``) goes, phase by phase: the kernel's source
is built alone with a ``clock64`` probe after each of its block barriers
(an edit of the source text), and block 0's thread 0 sums the cycles
between consecutive barriers over its tiles. The probed build runs at
Model B's front and the Tiny-ImageNet outlooker shapes of C <= 128 (batch
128, both fold modes) with the package's launch plan; its outputs are held
to the package's own launch, bit for bit (the probes change no value).
Prints cycles a tile per phase and the phase's share. A phase's count
includes its wait at the barrier that ends it. Needs nvcc and one card;
imports no JAX::

    python -m outgridvit_tpu_torch.ops.outlook_phases
"""

from __future__ import annotations

import ctypes
import subprocess
import tempfile
from pathlib import Path

import torch

from outgridvit_tpu_torch.ops import kernel_build
from outgridvit_tpu_torch.ops import outlook_agg as oa

SOURCE = kernel_build.CSRC_DIR / "outlook_agg_bwd_mma.cu"
# the phase each block barrier of the kernel ends, in the order of the
# source (None: a barrier inside a phase)
PHASES = ("stage", "products (v, dyag)", "y + da", "dv", None,
          "dbv + round(dv)", "dbp + dW", "dx", "stores + next staging")
ANCHOR = "  const int per = (H + R - 1) / R, ntiles = B * per;"
END = "  // this block's partial: dWp [C, C], dbp [C]; the fold: dWv [Cin, C],"
# (label, H = W, C, heads)
SHAPES = (("model_b front", 32, 64, 2), ("tin200 stage0", 64, 64, 2),
          ("tin200 stage1", 32, 128, 4))


def probed_source() -> str:
    """The kernel's source with the probes in."""
    text = SOURCE.read_text()
    parts = text.split("__syncthreads();")
    if len(parts) - 1 != len(PHASES) or ANCHOR not in text or END not in text:
        raise RuntimeError(f"{SOURCE.name} no longer has the barriers this "
                           "tool probes")
    out = parts[0]
    slot = 0
    for name, rest in zip(PHASES, parts[1:]):
        out += "__syncthreads();"
        if name is not None:
            out += f" OGVT_PROBE({slot});"
            slot += 1
        out += rest
    n = slot
    out = out.replace("namespace {\n", "__device__ unsigned long long "
                      f"g_phase[{n}];\nnamespace {{\n", 1)
    out = out.replace(ANCHOR, f"""  unsigned long long phase[{n}] = {{}};
  long long last = clock64();
#define OGVT_PROBE(k)                                                    \\
  if (blockIdx.x == 0 && threadIdx.x == 0) {{                            \\
    const long long now = clock64();                                     \\
    phase[k] += now - last;                                              \\
    last = now;                                                          \\
  }}
""" + ANCHOR, 1)
    out = out.replace(END, f"""  if (blockIdx.x == 0 && threadIdx.x == 0) {{
    for (int k = 0; k < {n}; ++k) g_phase[k] = phase[k];
  }}
""" + END, 1)
    return out + f"""
extern "C" int ogvt_outlook_phases(unsigned long long* out) {{
  return cudaMemcpyFromSymbol(out, g_phase, {n} * sizeof(unsigned long long));
}}
"""


def _build(text: str, tmp: Path) -> ctypes.CDLL:
    src, out = tmp / "probed.cu", tmp / "libprobed.so"
    src.write_text(text)
    subprocess.run([kernel_build.find_nvcc(), *kernel_build.NVCC_FLAGS,
                    "-shared", "-I", str(kernel_build.CSRC_DIR), "-o",
                    str(out), str(src)], check=True, capture_output=True,
                   timeout=900)
    lib = ctypes.CDLL(str(out))
    fn = lib.ogvt_outlook_agg_bwd_mma
    fn.argtypes, fn.restype = kernel_build._SIGNATURES[
        "ogvt_outlook_agg_bwd_mma"]
    lib.ogvt_outlook_phases.argtypes = (ctypes.c_void_p,)
    lib.ogvt_outlook_phases.restype = ctypes.c_int
    return lib


def _args(B, H, C, heads, fold, gen):
    def r(*s, scale=1.0):
        return (torch.randn(*s, generator=gen) * scale).cuda().bfloat16()

    a = torch.softmax(torch.randn(B, H, H, heads, 9, generator=gen), -1)
    a = a.reshape(B, H, H, heads * 9).cuda().bfloat16()
    w = (r(C, C, scale=C ** -0.5), r(C, scale=0.02)) if fold else \
        (None, None)
    return r(B, H, H, C), a, *w, r(C, C, scale=C ** -0.5), r(B, H, H, C)


def phases(batch: int = 128) -> dict:
    """{(shape label, fold): {phase: cycles a tile of block 0}}."""
    names = [p for p in PHASES if p is not None]
    kernel_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {}
    with tempfile.TemporaryDirectory(dir=kernel_build.BUILD_DIR) as tmp:
        lib = _build(probed_source(), Path(tmp))
        gen = torch.Generator().manual_seed(0)
        for label, H, C, heads in SHAPES:
            for fold in (False, True):
                x, a, wv, bv, wp, g = _args(batch, H, C, heads, fold, gen)
                name = ("outlook_branch_backward" if fold
                        else "outlook_agg_proj_backward")
                want = oa._launch_backward(oa.BACKWARD_ENTRIES[0], name, x,
                                           a, wv, bv, wp, g)
                plan = oa.outlook_agg_backward_plan(batch, H, H, C, C,
                                                    heads, fold)
                slots = (torch.empty_like(x), torch.empty_like(a),
                         torch.empty_like(wv) if fold else None,
                         torch.empty_like(bv) if fold else None,
                         torch.empty_like(wp), torch.empty_like(wp[0]))
                ws = torch.empty(plan.ws_floats, dtype=torch.float32,
                                 device=x.device)
                err = lib.ogvt_outlook_agg_bwd_mma(
                    *(None if t is None else t.data_ptr()
                      for t in (x, a, wv, bv, wp, g, *slots, ws)),
                    batch, H, H, C, C, heads, plan.rows, plan.chunk,
                    int(fold), 1, plan.blocks, plan.smem,
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"outlook_phases {label}: CUDA error "
                                       f"{err}")
                torch.cuda.synchronize()
                mine = [t for t in slots if t is not None]
                if not all(torch.equal(m, w) for m, w in zip(mine, want)):
                    raise RuntimeError(f"{label}: the probed build differs "
                                       "from the package's launch")
                cycles = (ctypes.c_ulonglong * len(names))()
                lib.ogvt_outlook_phases(cycles)
                tiles = len(range(0, plan.tiles, plan.blocks))
                out[(label, fold)] = {n: c / tiles
                                      for n, c in zip(names, cycles)}
    return out


if __name__ == "__main__":
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    for (label, fold), got in phases().items():
        total = sum(got.values())
        print(f"{label} {'#8 (fold)' if fold else '#7'}: {total:.0f} "
              f"cycles a tile of block 0; " + ", ".join(
                  f"{n} {c:.0f} ({c / total:.1%})" for n, c in got.items())
              + f" [{gpu}]")
