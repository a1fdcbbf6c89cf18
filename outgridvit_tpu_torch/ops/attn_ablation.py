"""Where the device time of the fused attention branch's tensor-core forward
(``csrc/attn_branch_mma.cu``) goes: the kernel's source is built alone
(with ``csrc/errors.cu``) as it is, and once more for each phase in
:data:`CUTS` with that phase switched off by an edit of the source; each
build runs at the Tiny-ImageNet and default Model A stage-0 shapes with
the package's launch plan, timed in CUDA graphs in turns (the builds in
order, then in reverse). A phase costs about what the kernel saves without
it. "no LN" is the unmodified build called with ``apply_ln`` off. The cut
builds compute wrong values (a cut qkv leaves the softmax its garbage, so
it is not one of them); only the unmodified build is held to the package's
own launch, bit for bit. Needs nvcc and one card; imports no JAX::

    python -m outgridvit_tpu_torch.ops.attn_ablation
"""

from __future__ import annotations

import ctypes
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from outgridvit_tpu_torch.ops import attn_branch as ab
from outgridvit_tpu_torch.ops import kernel_build

SOURCE = kernel_build.CSRC_DIR / "attn_branch_mma.cu"
# phase -> (text of the source, what it becomes without the phase)
CUTS = {
    "softmax": [("      packed::softmax<8>(s, scale, kN, lane);\n", "")],
    "attention (S, softmax, round(a).v)": [
        ("""      mma_xyt<NT, 8>(s, rows_a(s_qkv, g.rowQ, r0, lane) + cq * 2,
                     s_qkv + (C + cq) * 2, g.rowQ, lane);
      packed::softmax<8>(s, scale, kN, lane);""", ""),
        ("""        mma_rows<NT, 1>(o, a, s_qkv, g.rowQ, 16 * kk, (2 * C + cq) / 8,
                        lane);""", "        o[0][kk] += __uint_as_float(a[0][0]);")],
    "projection (out.Wp)": [
        ("""        mma_rows<CT, 1>(acc, a, base + g.wp, g.rowC, 16 * kc, h * CT, lane);""",
         "        acc[0][kc & 3] += __uint_as_float(a[0][0]);")],
    "y stores": [
        ("""      *reinterpret_cast<uint4*>(y + geo.token(w, r, kN, C) + u * 8) =""",
         """      if (w < 0) *reinterpret_cast<uint4*>(y + geo.token(w, r, kN, C) + u * 8) =""")],
    "next x staged": [
        ("""      stage_grid(s_x, x, geo, w + 1, C, g.rowC);
      cp_async_commit();""", "      cp_async_commit();")],
}
# (label, G or the NHWC map [B, H, W], C): the stage-0 shapes
SHAPES = (("tin200 #5 B=64", 4096, 64), ("tin200 #5 B=128", 8192, 64),
          ("a_base #12 B=64", (64, 32, 32), 80),
          ("a_base #5 B=64", 1024, 80))


def _build(name: str, text: str, tmp: Path) -> Path:
    src, out = tmp / f"{name}.cu", tmp / f"lib{name}.so"
    src.write_text(text)
    subprocess.run([kernel_build.find_nvcc(), *kernel_build.NVCC_FLAGS,
                    "-shared", "-I", str(kernel_build.CSRC_DIR), "-o",
                    str(out), str(src),
                    str(kernel_build.CSRC_DIR / "errors.cu")], check=True,
                   capture_output=True, timeout=900)
    return out


def _graph_ms(fn, iters=20) -> float:
    """Mean device ms of ``iters`` calls captured in one CUDA graph."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def _inputs(shape, C, gen):
    def r(*s, scale=1.0, shift=0.0):
        return (torch.randn(*s, generator=gen) * scale + shift).cuda()

    G = shape if isinstance(shape, int) else shape[0] * 16
    x = r(G, 64, C) if isinstance(shape, int) else r(*shape, C)
    return (x.bfloat16(), r(C, scale=0.1, shift=1.0), r(C, scale=0.1),
            r(C, 3 * C, scale=C ** -0.5).bfloat16(),
            r(3 * C, scale=0.02).bfloat16(),
            r(C, C, scale=C ** -0.5).bfloat16(),
            r(C, scale=0.02).bfloat16())


def ablate() -> dict:
    """{shape label: {build: device µs a launch}}."""
    text = SOURCE.read_text()
    builds = {"kernel": text}
    for phase, edits in CUTS.items():
        cut = text
        for old, new in edits:
            if old not in cut:
                raise RuntimeError(f"{SOURCE.name} no longer holds the "
                                   f"{phase!r} code this tool cuts")
            cut = cut.replace(old, new)
        builds[f"no {phase}"] = cut
    kernel_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {}
    with tempfile.TemporaryDirectory(dir=kernel_build.BUILD_DIR) as tmp:
        with ThreadPoolExecutor(len(builds)) as ex:
            paths = dict(zip(builds, ex.map(
                lambda kv: _build(f"b{list(builds).index(kv[0])}", kv[1],
                                  Path(tmp)), builds.items())))
        libs = {}
        for name, path in paths.items():
            lib = ctypes.CDLL(str(path))
            for entry in ("ogvt_attn_branch_mma",
                          "ogvt_attn_branch_nhwc_mma"):
                fn = getattr(lib, entry)
                fn.argtypes, fn.restype = kernel_build._SIGNATURES[entry]
            libs[name] = lib
        libs["no LN"] = libs["kernel"]
        gen = torch.Generator().manual_seed(0)
        for label, shape, C in SHAPES:
            args = _inputs(shape, C, gen)
            nhwc = not isinstance(shape, int)
            G = shape[0] * 16 if nhwc else shape
            plan = ab.attn_branch_forward_plan(G, 64, C, 2)
            dims = (*shape, C, 4, 2) if nhwc else (G, 64, C, 2)
            ys = {n: torch.empty_like(args[0]) for n in libs}

            def call(n):
                fn = (libs[n].ogvt_attn_branch_nhwc_mma if nhwc
                      else libs[n].ogvt_attn_branch_mma)
                err = fn(*(t.data_ptr() for t in args), ys[n].data_ptr(),
                         *dims, ctypes.c_float((C // 2) ** -0.5), 1e-5,
                         int(n != "no LN"), 1, *plan.args(),
                         torch.cuda.current_stream().cuda_stream)
                kernel_build.check(err, f"attn_ablation {n}")

            for n in libs:
                call(n)
            want = (ab.attn_branch_nhwc(*args, 2, 4) if nhwc
                    else ab.attn_branch(*args, 2))
            if not torch.equal(ys["kernel"], want):
                raise RuntimeError(f"{label}: the unmodified build differs "
                                   "from the package's launch")
            runs = {n: [] for n in libs}
            for n in [*libs, *reversed(libs)]:
                runs[n].append(_graph_ms(lambda n=n: call(n)) * 1e3)
            out[label] = {n: sum(v) / len(v) for n, v in runs.items()}
    return out


if __name__ == "__main__":
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    for label, times in ablate().items():
        base = times["kernel"]
        print(f"{label}: kernel {base:.1f} us a launch; " + ", ".join(
            f"{n} {t:.1f} ({base - t:+.1f})" for n, t in times.items()
            if n != "kernel") + f" [{gpu}]")
