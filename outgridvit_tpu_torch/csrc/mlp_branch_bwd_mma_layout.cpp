// The layout queries of csrc/mlp_branch_bwd_mma.cu's kernels for the launch
// plan (ops/mlp_branch.py:mlp_branch_backward_plan): plain C++ over
// mlp_branch_bwd_mma_layout.h, built for the host by
// ops/kernel_build.py:load_layouts, so a plan is made without a card too.
#include "mlp_branch_bwd_mma_layout.h"

using namespace ogvt::mlp_mma;

// The tokens kernel at C channels, split S and NB weight buffers: out =
// {threads a block, shared bytes, register cap, tokens a tile, hidden units
// a chunk}. Returns 1, writing nothing, where the kernel does not take them.
extern "C" int ogvt_mlp_branch_bwd_mma_tokens_layout(int C, int S, int NB,
                                                     int* out) {
  if (!tok_fits(C, S, NB)) return 1;
  const TokGeom g = tok_geom(C, S, NB);
  out[0] = kThreads;
  out[1] = g.bytes;
  out[2] = reg_cap(tok_blocks(tok_ntx(C, S)));
  out[3] = g.TM;
  out[4] = g.chunk;
  return 0;
}

// The weights kernel at C channels, WC units a block, TM tokens a tile and
// NB buffers: out = {threads a block, shared bytes, register cap, m16
// tiles a warp (its template, 2 or 4)}. Returns 1, writing nothing, where
// the kernel does not take them.
extern "C" int ogvt_mlp_branch_bwd_mma_weights_layout(int C, int WC, int TM,
                                                      int NB, int* out) {
  if (!w_fits(C, WC, TM, NB)) return 1;
  const WGeom g = w_geom(C, WC, TM, NB);
  out[0] = kThreads;
  out[1] = g.bytes;
  out[2] = reg_cap(w_blocks(w_mtt(g.MT)));
  out[3] = w_mtt(g.MT);
  return 0;
}
