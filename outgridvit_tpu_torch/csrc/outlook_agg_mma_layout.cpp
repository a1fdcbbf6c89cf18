// The layout queries of the fused outlook projection's tensor-core kernels
// (csrc/outlook_agg_bwd_mma.cu, csrc/outlook_agg_fwd_mma.cu) for their
// launch plans (ops/outlook_agg.py:outlook_agg_backward_plan,
// outlook_agg_forward_plan): plain C++ over outlook_agg_mma_layout.h, built
// for the host by ops/kernel_build.py:load_layouts, so a plan is made
// without a card too.
#include "outlook_agg_mma_layout.h"

using namespace ogvt::outlook_mma;

// The backward at W pixels a row, Cin and C channels, `heads` heads, tiles
// of `rows` image rows, chunks of `chunk` channels, with the value
// projection folded in (`fold`) or not: out = {threads a block, shared
// bytes, register cap, dW tiles a warp (its template, 1 to 4)}. Returns 1,
// writing nothing, where the kernel does not take them.
extern "C" int ogvt_outlook_agg_bwd_mma_layout(int W, int Cin, int C,
                                               int heads, int rows,
                                               int chunk, int fold,
                                               int* out) {
  if (!fits(W, Cin, C, heads, rows, chunk, fold)) return 1;
  const Geom g = geom(W, Cin, C, heads, rows, chunk, fold);
  out[0] = kThreads;
  out[1] = g.bytes;
  out[2] = kRegCap;
  out[3] = g.slots;
  return 0;
}

// The forward at the same shapes and tiles: out = {threads a block, shared
// bytes, register cap}. Returns 1, writing nothing, where the kernel does
// not take them.
extern "C" int ogvt_outlook_agg_fwd_mma_layout(int W, int Cin, int C,
                                               int heads, int rows,
                                               int chunk, int fold,
                                               int* out) {
  if (!fwd_fits(W, Cin, C, heads, rows, chunk, fold)) return 1;
  out[0] = kThreads;
  out[1] = fwd_geom(W, Cin, C, heads, rows, chunk, fold).bytes;
  out[2] = kRegCap;
  return 0;
}
