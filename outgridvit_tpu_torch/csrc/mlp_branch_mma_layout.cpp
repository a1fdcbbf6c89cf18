// The layout queries of the MLP branch's tensor-core kernels
// (csrc/mlp_branch_mma.cu, csrc/mlp_branch_bwd_mma.cu) for their launch
// plans (ops/mlp_branch.py:mlp_branch_forward_plan,
// mlp_branch_backward_plan): plain C++ over mlp_branch_mma_layout.h, built
// for the host by ops/kernel_build.py:load_layouts, so a plan is made
// without a card too.
#include "mlp_branch_mma_layout.h"

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

// The forward kernel at C channels, H hidden units, split S, NB weight
// buffers (0: resident) and activation `act` (csrc/act.cuh's codes; 1,
// SiLU, divides): out = {threads a block, shared bytes, register cap,
// tokens a tile, hidden units a chunk}. Returns 1, writing nothing, where
// the kernel does not take them.
extern "C" int ogvt_mlp_branch_fwd_mma_layout(int C, int H, int S, int NB,
                                              int act, int* out) {
  if (!fwd_fits(C, H, S, NB) || act < 0 || act > 2) return 1;
  const FwdGeom g = fwd_geom(C, H, S, NB);
  out[0] = kThreads;
  out[1] = g.bytes;
  out[2] = reg_cap(fwd_blocks(fwd_nty(C, S), act == 1));
  out[3] = g.TM;
  out[4] = g.chunk;
  return 0;
}
