"""SASS instructions of the MLP branch kernels' activation epilogues per
(token, hidden unit), as the bf16 tensor-core kernels run them: the
forward's a (``csrc/mlp_branch_mma.cu:epilogue_a``), the backward tokens
kernel's dh (``csrc/mlp_branch_bwd_mma.cu:epilogue_dh``) and the weights
kernel's a and dh from one transcendental (``epilogue_a_dh``), for GELU,
SiLU and ReLU.

A probe that includes a kernel's source gives each epilogue a kernel of its
own (one epilogue a thread, from (h, da, b1) in memory). Each probe is
compiled for sm_90a and disassembled (``cuobjdump -sass``); an epilogue's
count is its kernel's instructions (no NOPs, up to its last EXIT) less
those of the probe kernel that only loads and stores. Needs nvcc and
cuobjdump, no card::

    python -m outgridvit_tpu_torch.ops.mlp_sass
"""

from __future__ import annotations

import re
import subprocess
import tempfile
from pathlib import Path

from outgridvit_tpu_torch.ops import kernel_build

_BODY = r"""
template <int ACT, int KIND>
__device__ __forceinline__ void body(const float4* in, float2* out) {
  const float4 v = in[threadIdx.x];
  float a = 0.f, d = v.y;
  EPILOGUES
  out[threadIdx.x] = make_float2(a, d);
}
#define PROBE(NAME, ACT, KIND) \
  extern "C" __global__ void NAME(const float4* in, float2* out) { \
    body<ACT, KIND>(in, out); \
  }
PROBE(probe_none, kGelu, 0)
"""
# source -> (the epilogues, kind by kind, and their names)
PROBES = {
    "mlp_branch_mma.cu": (
        "if (KIND == 1) a = epilogue_a<ACT>(v.x, v.z);", ("forward",)),
    "mlp_branch_bwd_mma.cu": (
        "if (KIND == 1) d = epilogue_dh<ACT>(v.x, v.y, v.z);\n"
        "  if (KIND == 2) d = epilogue_a_dh<ACT>(v.x, v.y, v.z, a);",
        ("tokens", "weights")),
}


def _probe(source: str) -> str:
    epilogues, kinds = PROBES[source]
    text = f'#include "{source}"\n' + _BODY.replace("EPILOGUES", epilogues)
    for kind, name in enumerate(kinds, 1):
        for act in ("gelu", "silu", "relu"):
            text += (f"PROBE(probe_{name}_{act}, k{act.capitalize()}, "
                     f"{kind})\n")
    return text


def _counts(sass: str) -> dict:
    """{kernel: instructions} of every probe kernel, less the base's."""
    ops, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            name = m.group(1)
            ops[name] = []
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?"
                      r"([A-Z][A-Z0-9_.]*)", line)
        if m and name:
            ops[name].append(m.group(2))
    count = {}
    for fn, seq in ops.items():
        if not fn.startswith("probe_"):
            continue
        last = max(i for i, op in enumerate(seq) if op.startswith("EXIT"))
        count[fn.removeprefix("probe_")] = sum(op != "NOP"
                                              for op in seq[:last + 1])
    base = count.pop("none")
    return {fn: n - base for fn, n in sorted(count.items())}


def epilogue_sass() -> dict:
    """{"forward_gelu": n, ..., "weights_relu": n}: instructions a (token,
    unit) of each epilogue."""
    nvcc = kernel_build.find_nvcc()
    cuobjdump = Path(nvcc).parent / "cuobjdump"
    kernel_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {}
    with tempfile.TemporaryDirectory(dir=kernel_build.BUILD_DIR) as tmp:
        for source in PROBES:
            src = Path(tmp) / f"probe_{Path(source).stem}.cu"
            cubin = src.with_suffix(".cubin")
            src.write_text(_probe(source))
            subprocess.run([nvcc, "-cubin", "-gencode",
                            "arch=compute_90a,code=sm_90a", "-std=c++17",
                            "-O3", "-I", str(kernel_build.CSRC_DIR), "-o",
                            str(cubin), str(src)], check=True,
                           capture_output=True, timeout=600)
            out.update(_counts(subprocess.run(
                [str(cuobjdump), "-sass", str(cubin)], check=True,
                capture_output=True, text=True, timeout=120).stdout))
    return out


if __name__ == "__main__":
    print("MLP activation epilogues, SASS instructions per (token, hidden "
          "unit), sm_90a, csrc/mlp_branch_mma.cu (forward) and "
          "csrc/mlp_branch_bwd_mma.cu (tokens, weights), kernel minus its "
          "loads and stores: " + ", ".join(
              f"{k} {v}" for k, v in epilogue_sass().items()))
