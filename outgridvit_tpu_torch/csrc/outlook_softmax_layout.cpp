// The layout query of the fused outlook softmax's bf16 row kernel
// (csrc/outlook_softmax_rows.cu) for its launch plan
// (ops/outlook_softmax.py:outlook_softmax_plan): plain C++ over
// outlook_softmax_layout.h, built for the host by
// ops/kernel_build.py:load_layouts, so a plan is made without a card too.
#include "outlook_softmax_layout.h"

using namespace ogvt::osm_rows;

// The kernel at W pixels a row, C channels, `heads` heads, tiles of `rows`
// image rows and runs of `pix` pixels a thread: out = {threads a block,
// shared bytes, register cap}. Returns 1, writing nothing, where the kernel
// does not take them.
extern "C" int ogvt_outlook_softmax_rows_layout(int W, int C, int heads,
                                                int rows, int pix,
                                                int* out) {
  if (!fits(W, C, heads, rows, pix)) return 1;
  out[0] = kThreads;
  out[1] = geom(W, C, heads, rows, pix).bytes;
  out[2] = kRegCap;
  return 0;
}
