"""Where the device time of the outlook projection's tensor-core kernels
goes, phase by phase: the backward (``csrc/outlook_agg_bwd_mma.cu``, batch
128) and the forward (``csrc/outlook_agg_fwd_mma.cu``, batch 64). A
kernel's source is built alone with a ``clock64`` probe after each of its
block barriers (an edit of the source text), and block 0's thread 0 sums
the cycles between consecutive barriers over its tiles. The probed build
runs at Model B's front and the Tiny-ImageNet outlooker shapes of C <= 128
(both fold modes) with the package's launch plan; its outputs are held to
the package's own launch, bit for bit (the probes change no value). Prints
cycles a tile per phase and the phase's share. A phase's count includes its
wait at the barrier that ends it; the forward's first phase also holds the
tile before's stores (and, on the first tile, the weights' staging). Needs
nvcc and one card; imports no JAX::

    python -m outgridvit_tpu_torch.ops.outlook_phases [forward|backward]
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import NamedTuple, Optional

import torch

from outgridvit_tpu_torch.ops import kernel_build
from outgridvit_tpu_torch.ops import outlook_agg as oa


class Probe(NamedTuple):
    """One kernel to probe: its source, the phase each block barrier ends
    in the order of the source (None: a barrier inside a phase), the line
    before which the probes start, the line after the tile loop, its C
    entry point, the batch it runs at."""
    source: Path
    phases: tuple
    anchor: str
    end: str
    entry: str
    batch: int


KERNELS = {
    "backward": Probe(
        kernel_build.CSRC_DIR / "outlook_agg_bwd_mma.cu",
        ("stage", "products (v, dyag)", "y + da", "dv", None,
         "dbv + round(dv)", "dbp + dW", "dx", "stores + next staging"),
        "  const int per = (H + R - 1) / R, ntiles = B * per;",
        "  // this block's partial: dWp [C, C], dbp [C]; the fold: dWv "
        "[Cin, C],",
        oa.BACKWARD_ENTRIES[0], 128),
    "forward": Probe(
        kernel_build.CSRC_DIR / "outlook_agg_fwd_mma.cu",
        ("stores + staging wait", "v", "y", "y.Wp"),
        "  const int per = (H + R - 1) / R, ntiles = B * per;",
        "  cp_async_wait<0>();  // a block with no tile still drains its "
        "weights",
        oa.FORWARD_ENTRIES[0], 64),
}
# (label, H = W, C, heads)
SHAPES = (("model_b front", 32, 64, 2), ("tin200 stage0", 64, 64, 2),
          ("tin200 stage1", 32, 128, 4))


def probed_source(kind: str, text: Optional[str] = None) -> str:
    """The kernel's source (or ``text`` in its place) with the probes in."""
    k = KERNELS[kind]
    text = k.source.read_text() if text is None else text
    parts = text.split("__syncthreads();")
    if len(parts) - 1 != len(k.phases) or k.anchor not in text \
            or k.end not in text:
        raise RuntimeError(f"{k.source.name} no longer has the barriers "
                           "this tool probes")
    out = parts[0]
    slot = 0
    for name, rest in zip(k.phases, parts[1:]):
        out += "__syncthreads();"
        if name is not None:
            out += f" OGVT_PROBE({slot});"
            slot += 1
        out += rest
    n = slot
    out = out.replace("namespace {\n", "__device__ unsigned long long "
                      f"g_phase[{n}];\nnamespace {{\n", 1)
    out = out.replace(k.anchor, f"""  unsigned long long phase[{n}] = {{}};
  long long last = clock64();
#define OGVT_PROBE(k)                                                    \\
  if (blockIdx.x == 0 && threadIdx.x == 0) {{                            \\
    const long long now = clock64();                                     \\
    phase[k] += now - last;                                              \\
    last = now;                                                          \\
  }}
""" + k.anchor, 1)
    out = out.replace(k.end, f"""  if (blockIdx.x == 0 && threadIdx.x == 0) {{
    for (int k = 0; k < {n}; ++k) g_phase[k] = phase[k];
  }}
""" + k.end, 1)
    return out + f"""
extern "C" int ogvt_outlook_phases(unsigned long long* out) {{
  return cudaMemcpyFromSymbol(out, g_phase, {n} * sizeof(unsigned long long));
}}
"""


def _build(kind: str, text: str, tmp: Path) -> ctypes.CDLL:
    src, out = tmp / f"probed_{kind}.cu", tmp / f"libprobed_{kind}.so"
    src.write_text(text)
    subprocess.run([kernel_build.find_nvcc(), *kernel_build.NVCC_FLAGS,
                    "-shared", "-I", str(kernel_build.CSRC_DIR), "-o",
                    str(out), str(src)], check=True, capture_output=True,
                   timeout=900)
    lib = ctypes.CDLL(str(out))
    entry = KERNELS[kind].entry
    fn = getattr(lib, entry)
    fn.argtypes, fn.restype = kernel_build._SIGNATURES[entry]
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


def _ptr(t):
    return None if t is None else t.data_ptr()


def _run_backward(lib, label, B, H, C, heads, fold, args):
    """The probed backward against the package's launch; its plan."""
    x, a, wv, bv, wp, g = args
    name = ("outlook_branch_backward" if fold
            else "outlook_agg_proj_backward")
    want = oa._launch_backward(oa.BACKWARD_ENTRIES[0], name, x, a, wv, bv,
                               wp, g)
    plan = oa.outlook_agg_backward_plan(B, H, H, C, C, heads, fold)
    slots = (torch.empty_like(x), torch.empty_like(a),
             torch.empty_like(wv) if fold else None,
             torch.empty_like(bv) if fold else None,
             torch.empty_like(wp), torch.empty_like(wp[0]))
    ws = torch.empty(plan.ws_floats, dtype=torch.float32, device=x.device)
    err = lib.ogvt_outlook_agg_bwd_mma(
        *(_ptr(t) for t in (x, a, wv, bv, wp, g, *slots, ws)), B, H, H, C,
        C, heads, plan.rows, plan.chunk, int(fold), 1, plan.blocks,
        plan.smem, torch.cuda.current_stream().cuda_stream)
    mine = [t for t in slots if t is not None]
    return err, mine, want, plan


def _run_forward(lib, label, B, H, C, heads, fold, args):
    """The probed forward against the package's launch; its plan."""
    x, a, wv, bv, wp, bp = args
    name = "outlook_branch" if fold else "outlook_agg_proj"
    want = oa._launch_forward(oa.FORWARD_ENTRIES[0], name, x, a, wv, bv, wp,
                              bp)
    plan = oa.outlook_agg_forward_plan(B, H, H, C, C, heads, fold)
    out = torch.empty_like(want)
    err = lib.ogvt_outlook_agg_fwd_mma(
        *(_ptr(t) for t in (x, a, wv, bv, wp, bp, out)), B, H, H, C, C,
        heads, plan.rows, plan.chunk, int(fold), 1, plan.blocks, plan.smem,
        torch.cuda.current_stream().cuda_stream)
    return err, [out], [want], plan


def phases(kind: str = "backward", batch: Optional[int] = None,
           text: Optional[str] = None) -> dict:
    """{(shape label, fold): {phase: cycles a tile of block 0}} of the
    ``kind`` kernel (``text``: its source in place of the file's)."""
    k = KERNELS[kind]
    batch = batch or k.batch
    names = [p for p in k.phases if p is not None]
    run = _run_backward if kind == "backward" else _run_forward
    kernel_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {}
    with tempfile.TemporaryDirectory(dir=kernel_build.BUILD_DIR) as tmp:
        lib = _build(kind, probed_source(kind, text), Path(tmp))
        gen = torch.Generator().manual_seed(0)
        for label, H, C, heads in SHAPES:
            for fold in (False, True):
                args = _args(batch, H, C, heads, fold, gen)
                if kind == "forward":  # the bias in g's place
                    args = (*args[:-1], args[-1][0, 0, 0].contiguous())
                err, mine, want, plan = run(lib, label, batch, H, C, heads,
                                            fold, args)
                if err:
                    raise RuntimeError(f"outlook_phases {label}: CUDA error "
                                       f"{err}")
                torch.cuda.synchronize()
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
    for kind in sys.argv[1:] or ("backward", "forward"):
        for (label, fold), got in phases(kind).items():
            total = sum(got.values())
            print(f"{kind} {label} {'#8 (fold)' if fold else '#7'}: "
                  f"{total:.0f} cycles a tile of block 0; " + ", ".join(
                      f"{n} {c:.0f} ({c / total:.1%})"
                      for n, c in got.items()) + f" [{gpu}]")
