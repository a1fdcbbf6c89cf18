"""SASS instructions of the MLP backward's activation epilogue per (token,
hidden unit), as ``csrc/mlp_branch_bwd_mma.cu`` runs it: the tokens
kernel's dh (``epilogue_dh``) and the weights kernel's a and dh from one
transcendental (``epilogue_a_dh``), for GELU, SiLU and ReLU.

A probe that includes the kernel's source gives each epilogue a kernel of
its own (one epilogue a thread, from (h, da, b1) in memory). Each is
compiled for sm_90a and disassembled (``cuobjdump -sass``); its count is
its instructions (no NOPs, up to its last EXIT) less those of the probe
that only loads and stores. Needs nvcc and cuobjdump, no card::

    python -m outgridvit_tpu_torch.ops.mlp_bwd_sass
"""

from __future__ import annotations

import re
import subprocess
import tempfile
from pathlib import Path

from outgridvit_tpu_torch.ops import kernel_build

PROBE = r"""
#include "mlp_branch_bwd_mma.cu"
template <int ACT, int KIND>
__device__ __forceinline__ void body(const float4* in, float2* out) {
  const float4 v = in[threadIdx.x];
  float a = 0.f, d = v.y;
  if (KIND == 1) d = epilogue_dh<ACT>(v.x, v.y, v.z);
  if (KIND == 2) d = epilogue_a_dh<ACT>(v.x, v.y, v.z, a);
  out[threadIdx.x] = make_float2(a, d);
}
#define PROBE(NAME, ACT, KIND) \
  extern "C" __global__ void NAME(const float4* in, float2* out) { \
    body<ACT, KIND>(in, out); \
  }
PROBE(probe_none, kGelu, 0)
PROBE(probe_tokens_gelu, kGelu, 1)
PROBE(probe_tokens_silu, kSilu, 1)
PROBE(probe_tokens_relu, kRelu, 1)
PROBE(probe_weights_gelu, kGelu, 2)
PROBE(probe_weights_silu, kSilu, 2)
PROBE(probe_weights_relu, kRelu, 2)
"""


def epilogue_sass() -> dict:
    """{"tokens_gelu": n, ..., "weights_relu": n}: instructions a (token,
    unit) of each epilogue."""
    nvcc = kernel_build.find_nvcc()
    cuobjdump = Path(nvcc).parent / "cuobjdump"
    kernel_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=kernel_build.BUILD_DIR) as tmp:
        src, cubin = Path(tmp) / "probe.cu", Path(tmp) / "probe.cubin"
        src.write_text(PROBE)
        subprocess.run([nvcc, "-cubin", "-gencode",
                        "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                        "-I", str(kernel_build.CSRC_DIR), "-o", str(cubin),
                        str(src)], check=True, capture_output=True,
                       timeout=600)
        sass = subprocess.run([str(cuobjdump), "-sass", str(cubin)],
                              check=True, capture_output=True, text=True,
                              timeout=120).stdout
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


if __name__ == "__main__":
    print("MLP backward activation epilogue, SASS instructions per (token, "
          "hidden unit), sm_90a, csrc/mlp_branch_bwd_mma.cu (kernel minus "
          "its loads and stores): " + ", ".join(
              f"{k} {v}" for k, v in epilogue_sass().items()))
