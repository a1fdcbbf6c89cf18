// The layout query of the grid MHSA core's bf16 tensor-core kernel
// (csrc/grid_mhsa_th.cu) for its launch plan (ops/grid_attention.py:
// grid_mhsa_th_plan): plain C++ over grid_mhsa_th_layout.h, built for the
// host by ops/kernel_build.py:load_layouts, so a plan is made without a
// card too.
#include "grid_mhsa_th_layout.h"

using namespace ogvt::th;

// Grids of N tokens, C channels and `heads` heads, the forward or (with
// `backward`) the backward: out = {warps a block, shared bytes a block,
// register cap, grids a unit, staged tiles a warp, bytes between staged
// rows}. Returns 1, writing nothing, where the kernel does not take them.
extern "C" int ogvt_grid_mhsa_th_layout(int N, int C, int heads, int backward,
                                        int* out) {
  if (!takes(N, C, heads)) return 1;
  const int nt = C / heads / 8;
  const bool bwd = backward != 0;
  out[0] = kWarps;
  out[1] = smem_bytes(nt, bwd);
  out[2] = reg_cap(sm_blocks(nt, bwd));
  out[3] = grids_per_unit(N);
  out[4] = tiles(bwd);
  out[5] = row_bytes(nt);
  return 0;
}
