// The layout query of #6's bf16 kernels for N > 256 (csrc/grid_mhsa_tiles.cu)
// for their launch plan (ops/grid_attention.py:grid_mhsa_tiles_plan): plain
// C++ over grid_mhsa_tiles_layout.h, built for the host by
// ops/kernel_build.py:load_layouts, so a plan is made without a card too.
#include "grid_mhsa_tiles_layout.h"

using namespace ogvt::tiles;

// Grids of N tokens, C channels and `heads` heads, the forward or (with
// `backward`) the backward: out = {blocks a unit, warps a block; shared
// bytes of the forward or the backward's query kernel, of the backward's
// key kernel; the register caps of the same two; rows a streamed chunk,
// ring buffers, bytes between staged rows, the backward's scratch floats a
// unit (D), the floats a unit of the statistics the forward keeps under
// grad}, the backward's key kernel and scratch 0 for the forward. Returns
// 1, writing nothing, where the kernels do not take them.
extern "C" int ogvt_grid_mhsa_tiles_layout(int N, int C, int heads,
                                           int backward, int* out) {
  if (!takes(N, C, heads)) return 1;
  const int nt = C / heads / 8;
  const bool bwd = backward != 0;
  const Kernel first = bwd ? kBwdQuery : kFwd;
  out[0] = parts(N);
  out[1] = warps(N);
  out[2] = smem_bytes(N, nt, first);
  out[3] = bwd ? smem_bytes(N, nt, kBwdKey) : 0;
  out[4] = reg_cap(nt, first);
  out[5] = bwd ? reg_cap(nt, kBwdKey) : 0;
  out[6] = kChunk;
  out[7] = kStages;
  out[8] = row_bytes(nt);
  out[9] = bwd ? scratch_floats(N) : 0;
  out[10] = saved_floats(N);
  return 0;
}
