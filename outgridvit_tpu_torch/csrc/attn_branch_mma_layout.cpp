// The layout queries of the fused attention branch's tensor-core kernels
// (csrc/attn_branch_mma.cu, the forward; csrc/attn_branch_bwd_mma.cu, the
// backward) for their launch plans (ops/attn_branch.py:
// attn_branch_forward_plan, attn_branch_backward_plan): plain C++ over
// attn_branch_mma_layout.h, built for the host by
// ops/kernel_build.py:load_layouts, so a plan is made without a card too.
#include "attn_branch_mma_layout.h"

using namespace ogvt::attn_mma;

// The forward at grids of N tokens, C channels and `heads` heads: out =
// {threads a block, shared bytes, register cap}. Returns 1, writing
// nothing, where the kernel does not take them.
extern "C" int ogvt_attn_branch_mma_fwd_layout(int N, int C, int heads,
                                               int* out) {
  if (!fwd_fits(N, C, heads)) return 1;
  out[0] = kThreads;
  out[1] = fwd_geom(C).bytes;
  out[2] = reg_cap(kFwdBlocks);
  return 0;
}

// The backward's tokens kernel at the same shapes: out = {threads a block,
// shared bytes, register cap}. Returns 1, writing nothing, where the
// kernel does not take them.
extern "C" int ogvt_attn_branch_bwd_mma_tokens_layout(int N, int C, int heads,
                                                      int* out) {
  if (!tok_fits(N, C, heads)) return 1;
  out[0] = kThreads;
  out[1] = tok_geom(C).bytes;
  out[2] = reg_cap(kTokBlocks);
  return 0;
}

// The backward's weights kernel at the same shapes: out = {threads a
// block, shared bytes, register cap}. Returns 1, writing nothing, where
// the kernel does not take them.
extern "C" int ogvt_attn_branch_bwd_mma_weights_layout(int N, int C,
                                                       int heads, int* out) {
  if (!w_fits(N, C, heads)) return 1;
  out[0] = kThreads;
  out[1] = w_geom(C).bytes;
  out[2] = reg_cap(kWBlocks);
  return 0;
}
