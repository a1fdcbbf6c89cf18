// Device code shared by the fused attention branch's bf16 tensor-core
// kernels, forward (csrc/attn_branch_mma.cu) and backward
// (csrc/attn_branch_bwd_mma.cu): the staging of a grid's tokens and of
// weights by 16-byte cp.async, the LN of a staged grid, the ldmatrix
// addressing and mma.sync loops over staged bf16 tiles, and the qkv
// projection. Both directions form xn and qkv with this one code, in the
// same order, so the backward recomputes the forward's values bit for bit.
// The tiles' layout is attn_branch_mma_layout.h's.
#pragma once

#include <stdint.h>

#include "attn_branch_geom.cuh"
#include "attn_branch_mma_layout.h"
#include "mma.cuh"

namespace ogvt {
namespace attn_mma {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ unsigned pack(float lo, float hi) {
  return as_u32(__floats2bfloat162_rn(lo, hi));
}

__device__ __forceinline__ float2 unpack(unsigned v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

// Window w's 64 token rows of x (or dy) into the tile at shared address
// `tile`, rows `rowb` bytes apart, by 16-byte cp.async.
__device__ __forceinline__ void stage_grid(unsigned tile, const bf16* src,
                                           Geom geo, int w, int C, int rowb) {
  const int units = C / 8;
  for (int i = threadIdx.x; i < kN * units; i += kThreads) {
    const int r = i / units, u = i - r * units;
    cp_async16(tile + r * rowb + u * 16, src + geo.token(w, r, kN, C) + u * 8);
  }
}

// `rows` contiguous rows of `cols` bf16 at src into the tile at `tile`.
__device__ __forceinline__ void stage_rows(unsigned tile, const bf16* src,
                                           int rows, int cols, int rowb) {
  const int units = cols / 8;
  for (int i = threadIdx.x; i < rows * units; i += kThreads) {
    const int r = i / units, u = i - r * units;
    cp_async16(tile + r * rowb + u * 16,
               src + static_cast<size_t>(r) * cols + u * 8);
  }
}

// round(LN(x)) of the 64 rows of the staged bf16 tile `src` into `dst`
// (rows rowb bytes apart; dst may be src), four lanes a row: warp w takes
// rows 8w..8w+7, lane (r, q) = (lane / 4, lane % 4) row 8w + r and its
// 8-column units q, q + 4, ... by 16-byte loads. fp32 statistics (a lane
// sums its columns in order, the quad's xor tree sums the lanes), the fast
// variance clamped at 0. Every kernel of the branch calls it, so they all
// form the same xn. Writes mu and rstd when s_mu is given.
__device__ __forceinline__ void ln_rows(const unsigned char* src,
                                        unsigned char* dst, int rowb, int C,
                                        const float* __restrict__ ls,
                                        const float* __restrict__ lb,
                                        float eps, float* s_mu,
                                        float* s_rstd) {
  const int lane = threadIdx.x & 31, q = lane & 3;
  const int r = 8 * (threadIdx.x >> 5) + (lane >> 2);
  const unsigned char* row = src + r * rowb;
  float s = 0.f, ss = 0.f;
  for (int u = q; u < C / 8; u += 4) {
    const uint4 v = *reinterpret_cast<const uint4*>(row + u * 16);
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = unpack(w[k]);
      s += f.x;
      s += f.y;
      ss = fmaf(f.x, f.x, ss);
      ss = fmaf(f.y, f.y, ss);
    }
  }
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  ss += __shfl_xor_sync(0xffffffffu, ss, 1);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  ss += __shfl_xor_sync(0xffffffffu, ss, 2);
  const float mu = s / C;
  const float rstd = rsqrtf(fmaxf(0.f, ss / C - mu * mu) + eps);
  if (s_mu != nullptr && q == 0) {
    s_mu[r] = mu;
    s_rstd[r] = rstd;
  }
  for (int u = q; u < C / 8; u += 4) {
    const uint4 v = *reinterpret_cast<const uint4*>(row + u * 16);
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
    unsigned o[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = 8 * u + 2 * k;
      const float2 f = unpack(w[k]);
      o[k] = pack((f.x - mu) * (rstd * ls[c]) + lb[c],
                  (f.y - mu) * (rstd * ls[c + 1]) + lb[c + 1]);
    }
    *reinterpret_cast<uint4*>(dst + r * rowb + u * 16) =
        make_uint4(o[0], o[1], o[2], o[3]);
  }
}

// The A-operand ldmatrix address of lane `lane` for the 16 rows from r0 of a
// staged tile (rows rowb bytes apart), k unit 0: (rows 0-7, k 0-7),
// (8-15, 0-7), (0-7, 8-15), (8-15, 8-15).
__device__ __forceinline__ unsigned rows_a(unsigned tile, int rowb, int r0,
                                           int lane) {
  return tile + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * rowb +
         (lane >> 4) * 16;
}

// The B fragments of n tiles j0.. (NJ of them) of y (rows rowy bytes apart)
// for one k16 step at column unit ku, ldmatrix without .trans: yb is the
// lane's x4 address (n 0-7, k 0-7), (0-7, 8-15), (8-15, 0-7), (8-15, 8-15);
// an odd last tile takes an .x2 (lanes 0-15's addresses: n 0-7, k 0-15).
template <int NJ>
__device__ __forceinline__ void frags_nt(unsigned (&b)[NJ][2], unsigned yb,
                                         int rowy, int ku) {
#pragma unroll
  for (int j = 0; j < NJ; j += 2) {
    if (j + 1 < NJ) {
      unsigned q[4];
      ldsm_x4(yb + j * 8 * rowy + ku * 16, q);
      b[j][0] = q[0];
      b[j][1] = q[1];
      b[j + 1][0] = q[2];
      b[j + 1][1] = q[3];
    } else {
      unsigned q[2];
      ldsm_x2(yb + j * 8 * rowy + ku * 16, q);
      b[j][0] = q[0];
      b[j][1] = q[1];
    }
  }
}

// acc[j] += x.y^T: x the 16 rows whose A address is xa, y the 8 * NJ rows
// from `y` (rows rowy bytes apart), both over 8 * KU bf16 columns, an
// m16n8k8 step for the k8 tail when KU is odd; bf16 products summed in
// fp32 in k order. Each k step loads all its fragments before its mma, so
// that the loads' latencies overlap.
template <int KU, int NJ>
__device__ __forceinline__ void mma_xyt(float (&acc)[NJ][4], unsigned xa,
                                        unsigned y, int rowy, int lane) {
  const int lr = lane & 7, lm = lane >> 3;
  const unsigned yb = y + (lr + (lm >> 1) * 8) * rowy + (lm & 1) * 16;
#pragma unroll
  for (int kc = 0; kc + 1 < KU; kc += 2) {
    unsigned a[4], b[NJ][2];
    ldsm_x4(xa + kc * 16, a);
    frags_nt(b, yb, rowy, kc);
#pragma unroll
    for (int j = 0; j < NJ; ++j) mma_k16(acc[j], a, b[j][0], b[j][1]);
  }
  if constexpr (KU & 1) {  // the k8 tail: lanes 0-15 address n rows 0-15
    const unsigned tail = y + (lane & 15) * rowy + (KU - 1) * 16;
    unsigned a[2], b[NJ];
    ldsm_x2(xa + (KU - 1) * 16, a);  // rows 0-7, rows 8-15
#pragma unroll
    for (int j = 0; j < NJ; j += 2) {
      if (j + 1 < NJ) {
        unsigned q[2];
        ldsm_x2(tail + j * 8 * rowy, q);
        b[j] = q[0];
        b[j + 1] = q[1];
      } else {
        ldsm_x1(tail + j * 8 * rowy, b[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) mma_k8(acc[j], a, b[j]);
  }
}

// acc[j] += sum_u a[u].y over one k16 step: rows k0..k0+15 of the tile y
// (the k index, rows rowy bytes apart), its 8-column units j0u + j the n
// tiles (ldmatrix .trans). T = 2 sums a two-term split: each tile takes
// the hi term, then the lo term. The step's fragments are loaded first.
template <int NJ, int T>
__device__ __forceinline__ void mma_rows(float (&acc)[NJ][4],
                                         const unsigned (&a)[T][4],
                                         unsigned y, int rowy, int k0,
                                         int j0u, int lane) {
  const int lr = lane & 7, lm = lane >> 3;
  // (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15)
  const unsigned yb =
      y + (k0 + lr + (lm & 1) * 8) * rowy + (j0u + (lm >> 1)) * 16;
  unsigned b[NJ][2];
#pragma unroll
  for (int j = 0; j < NJ; j += 2) {
    if (j + 1 < NJ) {
      unsigned q[4];
      ldsm_x4_t(yb + j * 16, q);
      b[j][0] = q[0];
      b[j][1] = q[1];
      b[j + 1][0] = q[2];
      b[j + 1][1] = q[3];
    } else {  // an .x2: lanes 0-15's addresses, n 0-7
      unsigned q[2];
      ldsm_x2_t(yb + j * 16, q);
      b[j][0] = q[0];
      b[j][1] = q[1];
    }
  }
#pragma unroll
  for (int u = 0; u < T; ++u) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) mma_k16(acc[j], a[u], b[j][0], b[j][1]);
  }
}

template <int NJ>
__device__ __forceinline__ void zero(float (&acc)[NJ][4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  }
}

// acc * scale as bf16 into rows r0 + g and r0 + g + 8, columns col + 8j +
// 2t, 2t + 1 of the tile (rows rowb bytes apart).
template <int NJ>
__device__ __forceinline__ void put(unsigned char* tile, int rowb,
                                    const float (&acc)[NJ][4], float scale,
                                    int r0, int col, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    unsigned char* row = tile + (r0 + g + 8 * h) * rowb;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      *reinterpret_cast<unsigned*>(row + (col + 8 * j + 2 * t) * 2) =
          pack(acc[j][2 * h] * scale, acc[j][2 * h + 1] * scale);
    }
  }
}

// acc[j] + bias[col + 8j + 2t, + 1] (bf16 in global memory), the bias of
// an accumulator's two columns added to both of its rows.
template <int NJ>
__device__ __forceinline__ void add_bias(float (&acc)[NJ][4],
                                         const bf16* __restrict__ bias,
                                         int col, int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int c = col + 8 * j + 2 * t;
    const float b0 = __bfloat162float(bias[c]);
    const float b1 = __bfloat162float(bias[c + 1]);
    acc[j][0] += b0;
    acc[j][1] += b1;
    acc[j][2] += b0;
    acc[j][3] += b1;
  }
}

// qkv = round(xn.Wqkv + bqkv) of the 16 rows whose A address (rows_a) is
// xa, over NJ n8 column tiles from 8-column unit j0u, into the qkv tile
// (rows rowQ bytes apart; r0 the rows' first): CT k16 steps over C, Wqkv
// [C, 3C] resident at shared address wqkv (rows rowQ bytes apart) read by
// ldmatrix.trans.
template <int CT, int NJ>
__device__ __forceinline__ void qkv_rows(unsigned char* t_qkv, int rowQ,
                                         unsigned xa, unsigned wqkv,
                                         const bf16* __restrict__ bqkv,
                                         int r0, int j0u, int lane) {
  float acc[NJ][4];
  zero(acc);
#pragma unroll
  for (int kc = 0; kc < CT; ++kc) {
    unsigned a[1][4];
    ldsm_x4(xa + kc * 32, a[0]);
    mma_rows<NJ, 1>(acc, a, wqkv, rowQ, 16 * kc, j0u, lane);
  }
  add_bias(acc, bqkv, 8 * j0u, lane);
  put(t_qkv, rowQ, acc, 1.f, r0, 8 * j0u, lane);
}

}  // namespace attn_mma
}  // namespace ogvt
