// Device helpers of the fused MLP branch's bf16 tensor-core kernels
// (csrc/mlp_branch_mma.cu, the forward; csrc/mlp_branch_bwd_mma.cu, the
// backward's tokens and weights kernels), all of kThreads threads: bf16
// rounding and packing, the staging of token rows and weight chunks by
// 16-byte cp.async (rows past M and units past H zero-filled), and the
// in-place LayerNorm of staged rows.
#pragma once

#include <stddef.h>

#include "common.cuh"
#include "mlp_branch_mma_layout.h"
#include "mma.cuh"

namespace ogvt {
namespace mlp_mma {

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  return as_u32(__floats2bfloat162_rn(lo, hi));
}

__device__ __forceinline__ float2 unpack_bf16(unsigned v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

// Rows [row0, row0 + TM) of a [M, C] bf16 matrix into the tile at shared
// address `tile`, rows `rowb` bytes apart; rows past M zero-filled.
__device__ __forceinline__ void stage_rows(unsigned tile,
                                           const __nv_bfloat16* src,
                                           size_t row0, int M, int C, int TM,
                                           int rowb) {
  const int units = C / 8;
  for (int i = threadIdx.x; i < TM * units; i += kThreads) {
    const int r = i / units, u = i - r * units;
    const bool in = row0 + r < static_cast<size_t>(M);
    cp_async16_zfill(tile + r * rowb + u * 16,
                     in ? src + (row0 + r) * C + u * 8 : src, in ? 16 : 0);
  }
}

// w1[:, j0:j0 + n] ([C, n], rows `rowk` bytes apart) and w2[j0:j0 + n, :]
// ([n, C], rows `rowc` apart) into shared memory; units past H zero-filled.
__device__ __forceinline__ void stage_weights(unsigned t1, unsigned t2,
                                              const __nv_bfloat16* w1,
                                              const __nv_bfloat16* w2,
                                              int j0, int n, int C, int H,
                                              int rowk, int rowc) {
  const int un = n / 8, uc = C / 8;
  for (int i = threadIdx.x; i < C * un; i += kThreads) {
    const int c = i / un, u = i - c * un;
    const int j = j0 + u * 8;
    const bool in = j < H;
    cp_async16_zfill(t1 + c * rowk + u * 16,
                     in ? w1 + static_cast<size_t>(c) * H + j : w1,
                     in ? 16 : 0);
  }
  for (int i = threadIdx.x; i < n * uc; i += kThreads) {
    const int r = i / uc, u = i - r * uc;
    const bool in = j0 + r < H;
    cp_async16_zfill(t2 + r * rowc + u * 16,
                     in ? w2 + static_cast<size_t>(j0 + r) * C + u * 8 : w2,
                     in ? 16 : 0);
  }
}

// LayerNorm in place of rows first, first + step, ... below end of the
// staged bf16 tile at `tile` (rows `rowb` bytes apart), one warp a row:
// round(LN(x)) with fp32 statistics, fast variance clamped at 0, as
// csrc/mlp_branch_bwd.cu:layernorm_rows (a lane sums its column pairs in
// order, the warp's xor tree sums the lanes). Writes mu and rstd when s_mu
// is given.
__device__ __forceinline__ void layernorm_rows(unsigned char* tile, int rowb,
                                               int first, int step, int end,
                                               int C,
                                               const float* __restrict__ ls,
                                               const float* __restrict__ lb,
                                               float eps, float* s_mu,
                                               float* s_rstd) {
  const int lane = threadIdx.x % 32;
  for (int r = first; r < end; r += step) {
    unsigned* row = reinterpret_cast<unsigned*>(tile + r * rowb);
    float s = 0.f, ss = 0.f;
    for (int c = 2 * lane; c < C; c += 64) {
      const float2 v = unpack_bf16(row[c / 2]);
      s += v.x;
      s += v.y;
      ss = fmaf(v.x, v.x, ss);
      ss = fmaf(v.y, v.y, ss);
    }
    s = warp_sum(s);
    ss = warp_sum(ss);
    const float mu = s / C;
    const float rstd = rsqrtf(fmaxf(0.f, ss / C - mu * mu) + eps);
    if (s_mu != nullptr && lane == 0) {
      s_mu[r] = mu;
      s_rstd[r] = rstd;
    }
    for (int c = 2 * lane; c < C; c += 64) {
      const float2 v = unpack_bf16(row[c / 2]);
      row[c / 2] = pack_bf16((v.x - mu) * (rstd * ls[c]) + lb[c],
                             (v.y - mu) * (rstd * ls[c + 1]) + lb[c + 1]);
    }
  }
}

}  // namespace mlp_mma
}  // namespace ogvt
