// Backward of the fused pre-LN channel-MLP branch y = fc2(act(fc1(LN(x))))
// in bf16, with all five products on mma.sync tensor-core tiles.
//
// Replaces the TPU kernels outgridvit_tpu/ops/mlp_branch_pallas_t.py:
// mlp_branch_pallas_t (#2) and outgridvit_tpu/ops/mlp_branch_pallas.py:
// mlp_branch_pallas (#4), backward half (`_bwd_kernel`), for bf16 launches
// whose C and H are multiples of 16 (ops/mlp_branch.py routes them here;
// fp32 and other shapes keep csrc/mlp_branch_bwd.cu). The math and the
// rounding points are that kernel's (csrc/mlp_branch_bwd.cu's docstring):
//   xn = round(LN(x)), h = round(xn.w1 + b1), a = round(act(h)),
//   da = dy.w2^T (fp32), dh = round(da * act'(h)), dxn = dh.w1^T (fp32),
//   dx = the fp32 LN backward of dxn, cast once; over all tokens in fp32:
//   dW1 = xn^T.dh, dW2 = a^T.dy, db1 = sum dh, db2 = sum dy,
//   dln_scale = sum dxn * xhat, dln_bias = sum dxn.
// Every operand of the five products (xn, w1, dy, w2, dh, a) is a bf16
// value at one of these rounding points, so mma.sync.m16n8k16 with bf16
// operands and fp32 accumulators forms each product exactly and sums it in
// fp32: only the order of the fp32 sums differs from the plain version.
//
// What bounds it on the H100: the products, ~14*C*H flops a token with the
// recompute (fc1 and da in both kernels, dxn, dW1, dW2), against 6*C bytes
// of activations; then the activation epilogue at small C (erf and exp a
// (token, unit), in both kernels). Measured (PERF.md §6), it runs at 3-7%
// of that bound: latency, with 8-16 warps an SM at these register counts,
// and the GELU epilogue (~50 SASS instructions a (token, unit)) at C <= 128.
//
// What the design does about it. The deterministic three-way split of
// csrc/mlp_branch_bwd.cu stays (no float atomics: two calls are bitwise
// equal); its products move to mma.sync through csrc/mma.cuh:
//   1. tokens_kernel: 8 warps; S warps share one m16 row tile (the plan's
//      split, 1, 2 or 4), so a block takes TM = 128 / S tokens a tile. It
//      stages x and dy as bf16 by cp.async (rows past M zero-filled), takes
//      LN in fp32 from the staged bf16 (xn written back in place, mu and
//      rstd kept per row), then walks H in chunks whose w1[:, chunk] and
//      w2[chunk, :] are staged in their natural layouts (two buffers where
//      shared memory allows): ldmatrix.trans gives fc1's B operand, plain
//      ldmatrix da's and dxn's. Each warp computes h and da for its 32 (16
//      at S = 4) units of the chunk on mma, rounds h + b1, applies act' in
//      registers and rounds dh (0 on rows past M). At S = 1 the dh
//      accumulators are the A fragments of dxn += dh.w1^T as they stand
//      (bf16 pairs of two m16n8 tiles, as FlashAttention-2 reuses P); at
//      S > 1 the warps of a row tile swap their dh through shared memory.
//      dxn stays in fp32 registers, C / S columns a warp (at most 64
//      registers). Then the LN backward per row (x staged again), dx through
//      shared memory by 16-byte stores, and the block's dln_scale, dln_bias
//      and db2 sums in a fixed order, one fp32 partial a block.
//   2. weights_kernel: a block owns WC hidden units (a column slab of dW1, a
//      row slab of dW2, a slice of db1) and one contiguous split of token
//      tiles; w1[:, slab] and w2[slab, :] stay in shared memory. Per tile
//      (x and dy staged in two buffers where shared memory allows) it
//      recomputes h and da for its units on mma, stages a and dh as bf16
//      (erf or exp once for both act and act') and sums db1 from the
//      rounded dh; then dW1^T-slab += xn^T.dh and dW2-slab^T += dy^T.a on
//      mma, the transposed operands by ldmatrix.trans from the staged
//      [tokens, .] tiles. One fp32 partial a split.
//   3. reduce_partials (partials.cuh): the partials summed in order, cast.
// Staged rows are an odd number of 16-byte units apart (row16), so the 8
// rows one ldmatrix reads fall in 8 distinct bank groups. The launch plan
// (split, buffers, blocks; slab width, tile rows, m16 tiles a warp,
// buffers, splits) is ops/mlp_branch.py:mlp_branch_backward_plan, made from
// the layout queries of mlp_branch_mma_layout.cpp; the layout itself is
// mlp_branch_mma_layout.h, and the entry point refuses any plan it does not
// match. The staging and LayerNorm helpers are mlp_branch_mma.cuh's, shared
// with the forward (csrc/mlp_branch_mma.cu).
#include <stdint.h>

#include "act.cuh"
#include "common.cuh"
#include "mlp_branch_mma.cuh"
#include "mlp_branch_mma_layout.h"
#include "mma.cuh"
#include "partials.cuh"

using namespace ogvt;
using namespace ogvt::mlp_mma;

namespace {

using bf16 = __nv_bfloat16;

// The tokens kernel's epilogue of one (token, hidden unit), from the fp32
// sums h = xn.w1 and da = dy.w2^T: dh = da * act'(round(h + b1)), in fp32
// (rounded to bf16 as it is packed).
template <int ACT>
__device__ __forceinline__ float epilogue_dh(float h, float da, float b1) {
  return da * act_grad_f32<ACT>(round_bf16(h + b1));
}

// The weights kernel's: the same dh with a = act(round(h + b1)) too, their
// shared transcendental once.
template <int ACT>
__device__ __forceinline__ float epilogue_a_dh(float h, float da, float b1,
                                               float& a) {
  float g;
  act_and_grad_f32<ACT>(round_bf16(h + b1), a, g);
  return da * g;
}

template <int ACT, int NTX>
__global__ void __launch_bounds__(kThreads, tok_blocks(NTX))
tokens_kernel(const bf16* __restrict__ x, const float* __restrict__ ls,
              const float* __restrict__ lb, const bf16* __restrict__ w1,
              const bf16* __restrict__ b1, const bf16* __restrict__ w2,
              const bf16* __restrict__ dy, bf16* __restrict__ dx,
              float* __restrict__ part, int M, int C, int H, int S, int NB,
              float eps, int apply_ln) {
  extern __shared__ __align__(16) unsigned char smem[];
  const TokGeom g = tok_geom(C, S, NB);
  const unsigned base = smem_addr(smem);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;  // fragment row, column pair
  const int lr = lane % 8, lm = lane / 8;  // ldmatrix row, matrix
  const int rt = warp / S, cs = warp - rt * S;
  const int r0 = 16 * rt;        // the warp's first row in a tile
  const int c0 = cs * (C / S);   // its first dxn column
  float* s_mu = reinterpret_cast<float*>(smem + g.mu);
  float* s_rstd = reinterpret_cast<float*>(smem + g.rstd);
  float* s_red = reinterpret_cast<float*>(smem + g.red);  // dls, dlb, db2
  for (int i = tid; i < 3 * C; i += kThreads) s_red[i] = 0.f;

  // ldmatrix lane offsets: A of the warp's rows in a [TM, C] tile; B of fc1
  // (w1 chunk, .trans, the warp's units), of da (w2 chunk) and of dxn (w1
  // chunk, the warp's columns); A of dh in the exchange tile (S > 1)
  const unsigned a_ln = (r0 + lr + (lm & 1) * 8) * g.rowC + (lm >> 1) * 16;
  const unsigned bh_ln =
      (lr + (lm & 1) * 8) * g.rowK + (cs * g.HW / 8 + (lm >> 1)) * 16;
  const unsigned bd_ln =
      g.w2 + (cs * g.HW + lr + (lm >> 1) * 8) * g.rowC + (lm & 1) * 16;
  const unsigned bx_ln = (c0 + lr + (lm >> 1) * 8) * g.rowK + (lm & 1) * 16;
  const unsigned ad_ln = (r0 + lr + (lm & 1) * 8) * g.rowK + (lm >> 1) * 16;

  const int ntiles = (M + g.TM - 1) / g.TM;
  const int nch = (H + g.chunk - 1) / g.chunk;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const size_t row0 = static_cast<size_t>(t) * g.TM;
    const int rows = min(g.TM, static_cast<int>(M - row0));
    stage_rows(base + g.xn, x, row0, M, C, g.TM, g.rowC);
    stage_rows(base + g.dy, dy, row0, M, C, g.TM, g.rowC);
    stage_weights(base + g.w, base + g.w + g.w2, w1, w2, 0, g.chunk, C, H,
                  g.rowK, g.rowC);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (apply_ln) {
      layernorm_rows(smem + g.xn, g.rowC, warp, kWarps, rows, C, ls, lb, eps,
                     s_mu, s_rstd);
    }
    // db2: a thread sums a column pair over every RG-th row, in order
    float* s_db2 = reinterpret_cast<float*>(smem + g.db2);  // [RG][C]
    const int pairs = C / 2, RG = kDb2Floats / C;
    if (tid < RG * pairs) {
      const int pr = tid % pairs, rg = tid / pairs;
      const unsigned* col =
          reinterpret_cast<const unsigned*>(smem + g.dy) + pr;
      float s0 = 0.f, s1 = 0.f;
      for (int r = rg; r < rows; r += RG) {
        const float2 v = unpack_bf16(col[r * (g.rowC / 4)]);
        s0 += v.x;
        s1 += v.y;
      }
      s_db2[rg * C + 2 * pr] = s0;
      s_db2[rg * C + 2 * pr + 1] = s1;
    }
    __syncthreads();
    for (int c = tid; c < C; c += kThreads) {  // row groups in order
      float sb = 0.f;
      for (int r = 0; r < RG; ++r) sb += s_db2[r * C + c];
      s_red[2 * C + c] += sb;
    }

    float acc[NTX][4];  // dxn, rows r0 + gq (+ 8), the warp's columns
#pragma unroll
    for (int n = 0; n < NTX; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    }
    for (int k = 0; k < nch; ++k) {
      const int j0 = k * g.chunk;
      if (k > 0) {
        cp_async_wait<0>();
        __syncthreads();  // chunk k staged; every warp done with k - 1
      }
      if (NB == 2 && k + 1 < nch) {
        const unsigned nb = base + g.w + ((k + 1) & 1) * g.wbuf;
        stage_weights(nb, nb + g.w2, w1, w2, j0 + g.chunk, g.chunk, C, H,
                      g.rowK, g.rowC);
        cp_async_commit();
      }
      const unsigned wb = base + g.w + (NB == 2 ? (k & 1) : 0) * g.wbuf;

      // h = xn.w1[:, units] and da = dy.w2[units, :]^T, the warp's units
      float h[4][4], da[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) h[n][e] = da[n][e] = 0.f;
      }
      for (int kc = 0; kc < C / 16; ++kc) {
        unsigned ax[4], ay[4];
        ldsm_x4(base + g.xn + a_ln + kc * 32, ax);
        ldsm_x4(base + g.dy + a_ln + kc * 32, ay);
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          if (16 * p < g.HW) {
            unsigned bh[4], bd[4];
            ldsm_x4_t(wb + bh_ln + kc * 16 * g.rowK + p * 32, bh);
            ldsm_x4(wb + bd_ln + p * 16 * g.rowC + kc * 32, bd);
            mma_k16(h[2 * p], ax, bh[0], bh[1]);
            mma_k16(h[2 * p + 1], ax, bh[2], bh[3]);
            mma_k16(da[2 * p], ay, bd[0], bd[1]);
            mma_k16(da[2 * p + 1], ay, bd[2], bd[3]);
          }
        }
      }
      // dh = round(da * act'(round(h + b1))), 0 on rows past M, as bf16
      // pairs: dhp[n][0] row gq, dhp[n][1] row gq + 8
      unsigned dhp[4][2];
      const bool in0 = r0 + gq < rows, in1 = r0 + gq + 8 < rows;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        if (8 * n < g.HW) {
          const int j = j0 + cs * g.HW + 8 * n + 2 * tq;
          float bj0 = 0.f, bj1 = 0.f;
          if (j < H) {
            bj0 = to_f32(b1[j]);
            bj1 = to_f32(b1[j + 1]);
          }
          const float d0 = epilogue_dh<ACT>(h[n][0], da[n][0], bj0);
          const float d1 = epilogue_dh<ACT>(h[n][1], da[n][1], bj1);
          const float d2 = epilogue_dh<ACT>(h[n][2], da[n][2], bj0);
          const float d3 = epilogue_dh<ACT>(h[n][3], da[n][3], bj1);
          dhp[n][0] = in0 ? pack_bf16(d0, d1) : 0u;
          dhp[n][1] = in1 ? pack_bf16(d2, d3) : 0u;
        } else {
          dhp[n][0] = dhp[n][1] = 0u;
        }
      }
      // dxn += dh.w1[:, units]^T over the warp's columns
      if (S == 1) {  // the dh accumulators are the A fragments
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const unsigned a[4] = {dhp[2 * kk][0], dhp[2 * kk][1],
                                 dhp[2 * kk + 1][0], dhp[2 * kk + 1][1]};
#pragma unroll
          for (int q = 0; q < NTX / 2; ++q) {
            if (2 * q < g.nct) {
              unsigned b[4];
              ldsm_x4(wb + bx_ln + q * 16 * g.rowK + kk * 32, b);
              mma_k16(acc[2 * q], a, b[0], b[1]);
              mma_k16(acc[2 * q + 1], a, b[2], b[3]);
            }
          }
        }
      } else {  // the row tile's warps swap their dh through shared memory
        unsigned char* sd = smem + g.dh + (r0 + gq) * g.rowK +
                            (cs * g.HW + 2 * tq) * 2;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          if (8 * n < g.HW) {
            *reinterpret_cast<unsigned*>(sd + 16 * n) = dhp[n][0];
            *reinterpret_cast<unsigned*>(sd + 8 * g.rowK + 16 * n) =
                dhp[n][1];
          }
        }
        __syncthreads();
        for (int kk = 0; kk < g.chunk / 16; ++kk) {
          unsigned a[4];
          ldsm_x4(base + g.dh + ad_ln + kk * 32, a);
#pragma unroll
          for (int q = 0; q < NTX / 2; ++q) {
            if (2 * q < g.nct) {
              unsigned b[4];
              ldsm_x4(wb + bx_ln + q * 16 * g.rowK + kk * 32, b);
              mma_k16(acc[2 * q], a, b[0], b[1]);
              mma_k16(acc[2 * q + 1], a, b[2], b[3]);
            }
          }
        }
      }
      if (NB == 1 && k + 1 < nch) {
        __syncthreads();  // every warp done with the one buffer
        stage_weights(base + g.w, base + g.w + g.w2, w1, w2, j0 + g.chunk,
                      g.chunk, C, H, g.rowK, g.rowC);
        cp_async_commit();
      }
    }
    __syncthreads();  // the weight buffers, xn and dy tiles are free

    // The LN backward: x again (into the dy tile), row sums of dxhat and
    // dxhat * xhat, column sums of dxn * xhat and dxn over the block's rows
    float* s_cs = reinterpret_cast<float*>(smem + g.cs);  // [2][R][C]
    float* s_rs = reinterpret_cast<float*>(smem + g.rs);  // [2][TM][S]
    const int ra = r0 + gq, rb = ra + 8;  // this lane's rows
    const bool ina = ra < rows, inb = rb < rows;
    float mu_a = 0.f, rs_a = 0.f, mu_b = 0.f, rs_b = 0.f;
    float m1a = 0.f, m2a = 0.f, m1b = 0.f, m2b = 0.f;
    const unsigned* xr_a =
        reinterpret_cast<const unsigned*>(smem + g.dy + ra * g.rowC);
    const unsigned* xr_b =
        reinterpret_cast<const unsigned*>(smem + g.dy + rb * g.rowC);
    if (apply_ln) {
      stage_rows(base + g.dy, x, row0, M, C, g.TM, g.rowC);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      if (ina) {
        mu_a = s_mu[ra];
        rs_a = s_rstd[ra];
      }
      if (inb) {
        mu_b = s_mu[rb];
        rs_b = s_rstd[rb];
      }
      float s1a = 0.f, s2a = 0.f, s1b = 0.f, s2b = 0.f;
#pragma unroll
      for (int n = 0; n < NTX; ++n) {
        if (n < g.nct) {
          const int c = c0 + 8 * n + 2 * tq;
          const float l0 = ls[c], l1 = ls[c + 1];
          const float2 xa = unpack_bf16(xr_a[c / 2]);
          const float2 xb = unpack_bf16(xr_b[c / 2]);
          const float ha0 = ina ? (xa.x - mu_a) * rs_a : 0.f;
          const float ha1 = ina ? (xa.y - mu_a) * rs_a : 0.f;
          const float hb0 = inb ? (xb.x - mu_b) * rs_b : 0.f;
          const float hb1 = inb ? (xb.y - mu_b) * rs_b : 0.f;
          const float d0 = acc[n][0] * l0, d1 = acc[n][1] * l1;
          const float d2 = acc[n][2] * l0, d3 = acc[n][3] * l1;
          s1a += d0 + d1;
          s2a = fmaf(d1, ha1, fmaf(d0, ha0, s2a));
          s1b += d2 + d3;
          s2b = fmaf(d3, hb1, fmaf(d2, hb0, s2b));
          // column sums over the warp's 16 rows
          float cl0 = fmaf(acc[n][2], hb0, acc[n][0] * ha0);
          float cl1 = fmaf(acc[n][3], hb1, acc[n][1] * ha1);
          float cb0 = acc[n][0] + acc[n][2];
          float cb1 = acc[n][1] + acc[n][3];
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) {
            cl0 += __shfl_xor_sync(0xffffffffu, cl0, o);
            cl1 += __shfl_xor_sync(0xffffffffu, cl1, o);
            cb0 += __shfl_xor_sync(0xffffffffu, cb0, o);
            cb1 += __shfl_xor_sync(0xffffffffu, cb1, o);
          }
          if (gq == 0) {
            s_cs[rt * C + c] = cl0;
            s_cs[rt * C + c + 1] = cl1;
            s_cs[(g.R + rt) * C + c] = cb0;
            s_cs[(g.R + rt) * C + c + 1] = cb1;
          }
        }
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        s1a += __shfl_xor_sync(0xffffffffu, s1a, o);
        s2a += __shfl_xor_sync(0xffffffffu, s2a, o);
        s1b += __shfl_xor_sync(0xffffffffu, s1b, o);
        s2b += __shfl_xor_sync(0xffffffffu, s2b, o);
      }
      if (tq == 0) {
        s_rs[ra * S + cs] = s1a;
        s_rs[rb * S + cs] = s1b;
        s_rs[(g.TM + ra) * S + cs] = s2a;
        s_rs[(g.TM + rb) * S + cs] = s2b;
      }
      __syncthreads();
      for (int c = tid; c < C; c += kThreads) {  // row tiles in order
        float sl = 0.f, sb = 0.f;
        for (int r = 0; r < g.R; ++r) {
          sl += s_cs[r * C + c];
          sb += s_cs[(g.R + r) * C + c];
        }
        s_red[c] += sl;
        s_red[C + c] += sb;
      }
      for (int s = 0; s < S; ++s) {  // column splits in order
        m1a += s_rs[ra * S + s];
        m1b += s_rs[rb * S + s];
        m2a += s_rs[(g.TM + ra) * S + s];
        m2b += s_rs[(g.TM + rb) * S + s];
      }
      m1a /= C;
      m2a /= C;
      m1b /= C;
      m2b /= C;
    }
    // dx into the xn tile, then out by 16-byte stores
    unsigned* da_ = reinterpret_cast<unsigned*>(smem + g.xn + ra * g.rowC);
    unsigned* db_ = reinterpret_cast<unsigned*>(smem + g.xn + rb * g.rowC);
#pragma unroll
    for (int n = 0; n < NTX; ++n) {
      if (n < g.nct) {
        const int c = c0 + 8 * n + 2 * tq;
        if (apply_ln) {
          const float l0 = ls[c], l1 = ls[c + 1];
          const float2 xa = unpack_bf16(xr_a[c / 2]);
          const float2 xb = unpack_bf16(xr_b[c / 2]);
          const float ha0 = (xa.x - mu_a) * rs_a, ha1 = (xa.y - mu_a) * rs_a;
          const float hb0 = (xb.x - mu_b) * rs_b, hb1 = (xb.y - mu_b) * rs_b;
          da_[c / 2] = pack_bf16(rs_a * (acc[n][0] * l0 - m1a - ha0 * m2a),
                                 rs_a * (acc[n][1] * l1 - m1a - ha1 * m2a));
          db_[c / 2] = pack_bf16(rs_b * (acc[n][2] * l0 - m1b - hb0 * m2b),
                                 rs_b * (acc[n][3] * l1 - m1b - hb1 * m2b));
        } else {
          da_[c / 2] = pack_bf16(acc[n][0], acc[n][1]);
          db_[c / 2] = pack_bf16(acc[n][2], acc[n][3]);
        }
      }
    }
    __syncthreads();
    const int units = C / 8;
    for (int i = tid; i < rows * units; i += kThreads) {
      const int r = i / units, u = i - r * units;
      *reinterpret_cast<uint4*>(dx + (row0 + r) * C + u * 8) =
          *reinterpret_cast<const uint4*>(smem + g.xn + r * g.rowC + u * 16);
    }
    __syncthreads();  // before the next tile's staging
  }
  float* pb = part + static_cast<size_t>(blockIdx.x) * 3 * C;
  for (int i = tid; i < 3 * C; i += kThreads) pb[i] = s_red[i];
}

template <int ACT, int MTT>
__global__ void __launch_bounds__(kThreads, w_blocks(MTT))
weights_kernel(const bf16* __restrict__ x, const float* __restrict__ ls,
               const float* __restrict__ lb, const bf16* __restrict__ w1,
               const bf16* __restrict__ b1, const bf16* __restrict__ w2,
               const bf16* __restrict__ dy, float* __restrict__ ws, int M,
               int C, int H, int WC, int TM, int NB, int tiles_per_split,
               float eps, int apply_ln) {
  extern __shared__ __align__(16) unsigned char smem[];
  const WGeom g = w_geom(C, WC, TM, NB);
  const unsigned base = smem_addr(smem);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int lr = lane % 8, lm = lane / 8;
  const int wn = warp % g.WN, wm = warp / g.WN;
  const int j0 = blockIdx.x * WC;
  const int ntiles = (M + TM - 1) / TM;
  const int t0 = blockIdx.y * tiles_per_split;
  const int t1 = min(ntiles, t0 + tiles_per_split);
  const int mtiles = C / 16;
  float* s_db = reinterpret_cast<float*>(smem + g.db);  // [TM / 16][WC]

  stage_weights(base + g.w1, base + g.w2, w1, w2, j0, WC, C, H, g.rowW,
                g.rowC);
  stage_rows(base, x, static_cast<size_t>(t0) * TM, M, C, TM, g.rowC);
  stage_rows(base + TM * g.rowC, dy, static_cast<size_t>(t0) * TM, M, C, TM,
             g.rowC);
  cp_async_commit();

  float acc1[MTT][4][4], acc2[MTT][4][4];  // dW1 and dW2^T slabs [C, WC]
#pragma unroll
  for (int i = 0; i < MTT; ++i) {
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc1[i][n][e] = acc2[i][n][e] = 0.f;
    }
  }
  float db1 = 0.f;  // unit j0 + tid

  // ldmatrix lane offsets: phase 1 B of fc1 (w1 slab, .trans) and of da
  // (w2 slab); phase 2 B (.trans) of the dh and a tiles, A (.trans) of the
  // xn and dy tiles
  const unsigned bh_ln = (lr + (lm & 1) * 8) * g.rowW + (lm >> 1) * 16;
  const unsigned bd_ln = (lr + (lm >> 1) * 8) * g.rowC + (lm & 1) * 16;
  const unsigned b2_ln =
      (lr + (lm & 1) * 8) * g.rowW + (wn * 4 + (lm >> 1)) * 16;
  const unsigned a2_ln = (lr + (lm >> 1) * 8) * g.rowC + (lm & 1) * 16;

  for (int t = t0; t < t1; ++t) {
    const int b = NB == 2 ? (t - t0) & 1 : 0;
    cp_async_wait<0>();
    __syncthreads();  // tile t staged; every warp done with tile t - 1
    if (NB == 2 && t + 1 < t1) {
      const unsigned nb = base + (b ^ 1) * g.buf;
      stage_rows(nb, x, static_cast<size_t>(t + 1) * TM, M, C, TM, g.rowC);
      stage_rows(nb + TM * g.rowC, dy, static_cast<size_t>(t + 1) * TM, M, C,
                 TM, g.rowC);
      cp_async_commit();
    }
    const size_t row0 = static_cast<size_t>(t) * TM;
    const int rows = min(TM, static_cast<int>(M - row0));
    const unsigned xb = base + b * g.buf, yb = xb + TM * g.rowC;
    if (apply_ln) {
      layernorm_rows(smem + b * g.buf, g.rowC, warp, kWarps, rows, C, ls, lb,
                     eps, nullptr, nullptr);
      __syncthreads();
    }

    // phase 1: h and da for (16 rows, iw units) items; a, dh, db1 parts
    const int rts = (rows + 15) / 16;
    const int ugs = WC / g.iw;
    for (int item = warp; item < rts * ugs; item += kWarps) {
      const int rt = item / ugs, u0 = (item - rt * ugs) * g.iw;
      float h[4][4], da[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) h[n][e] = da[n][e] = 0.f;
      }
      const unsigned a_ln =
          (16 * rt + lr + (lm & 1) * 8) * g.rowC + (lm >> 1) * 16;
      for (int kc = 0; kc < C / 16; ++kc) {
        unsigned ax[4], ay[4];
        ldsm_x4(xb + a_ln + kc * 32, ax);
        ldsm_x4(yb + a_ln + kc * 32, ay);
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          if (16 * p < g.iw) {
            unsigned bh[4], bd[4];
            ldsm_x4_t(base + g.w1 + bh_ln + kc * 16 * g.rowW +
                          (u0 / 8 + 2 * p) * 16,
                      bh);
            ldsm_x4(base + g.w2 + bd_ln + (u0 + 16 * p) * g.rowC + kc * 32,
                    bd);
            mma_k16(h[2 * p], ax, bh[0], bh[1]);
            mma_k16(h[2 * p + 1], ax, bh[2], bh[3]);
            mma_k16(da[2 * p], ay, bd[0], bd[1]);
            mma_k16(da[2 * p + 1], ay, bd[2], bd[3]);
          }
        }
      }
      const int ra = 16 * rt + gq, rb = ra + 8;
      const bool ina = ra < rows, inb = rb < rows;
      unsigned char* sa = smem + g.a + ra * g.rowW + (u0 + 2 * tq) * 2;
      unsigned char* sd = smem + g.dh + ra * g.rowW + (u0 + 2 * tq) * 2;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        if (8 * n < g.iw) {
          const int j = j0 + u0 + 8 * n + 2 * tq;
          float bj0 = 0.f, bj1 = 0.f;
          if (j < H) {
            bj0 = to_f32(b1[j]);
            bj1 = to_f32(b1[j + 1]);
          }
          float a0, a1, a2, a3;
          float d0 = epilogue_a_dh<ACT>(h[n][0], da[n][0], bj0, a0);
          float d1 = epilogue_a_dh<ACT>(h[n][1], da[n][1], bj1, a1);
          float d2 = epilogue_a_dh<ACT>(h[n][2], da[n][2], bj0, a2);
          float d3 = epilogue_a_dh<ACT>(h[n][3], da[n][3], bj1, a3);
          d0 = ina ? round_bf16(d0) : 0.f;
          d1 = ina ? round_bf16(d1) : 0.f;
          d2 = inb ? round_bf16(d2) : 0.f;
          d3 = inb ? round_bf16(d3) : 0.f;
          *reinterpret_cast<unsigned*>(sa + 16 * n) = pack_bf16(a0, a1);
          *reinterpret_cast<unsigned*>(sa + 8 * g.rowW + 16 * n) =
              pack_bf16(a2, a3);
          *reinterpret_cast<unsigned*>(sd + 16 * n) = pack_bf16(d0, d1);
          *reinterpret_cast<unsigned*>(sd + 8 * g.rowW + 16 * n) =
              pack_bf16(d2, d3);
          // db1: the rounded dh over the item's 16 rows
          float c0 = d0 + d2, c1 = d1 + d3;
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) {
            c0 += __shfl_xor_sync(0xffffffffu, c0, o);
            c1 += __shfl_xor_sync(0xffffffffu, c1, o);
          }
          if (gq == 0) {
            s_db[rt * WC + u0 + 8 * n + 2 * tq] = c0;
            s_db[rt * WC + u0 + 8 * n + 2 * tq + 1] = c1;
          }
        }
      }
    }
    __syncthreads();
    if (tid < WC) {  // row tiles in order
      for (int r = 0; r < rts; ++r) db1 += s_db[r * WC + tid];
    }

    // phase 2: dW1 += xn^T.dh and dW2^T += dy^T.a over the tile's tokens
    for (int ks = 0; ks < rts; ++ks) {
      unsigned bdh[2][4], ba[2][4];
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const unsigned o = b2_ln + ks * 16 * g.rowW + p * 32;
        ldsm_x4_t(base + g.dh + o, bdh[p]);
        ldsm_x4_t(base + g.a + o, ba[p]);
      }
#pragma unroll
      for (int i = 0; i < MTT; ++i) {
        const int mi = wm + g.WM * i;
        if (mi < mtiles) {
          unsigned ax[4], ay[4];
          const unsigned o = a2_ln + ks * 16 * g.rowC + mi * 32;
          ldsm_x4_t(xb + o, ax);
          ldsm_x4_t(yb + o, ay);
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            mma_k16(acc1[i][2 * p], ax, bdh[p][0], bdh[p][1]);
            mma_k16(acc1[i][2 * p + 1], ax, bdh[p][2], bdh[p][3]);
            mma_k16(acc2[i][2 * p], ay, ba[p][0], ba[p][1]);
            mma_k16(acc2[i][2 * p + 1], ay, ba[p][2], ba[p][3]);
          }
        }
      }
    }
    if (NB == 1 && t + 1 < t1) {
      __syncthreads();  // every warp done with the one buffer
      stage_rows(base, x, static_cast<size_t>(t + 1) * TM, M, C, TM, g.rowC);
      stage_rows(base + TM * g.rowC, dy, static_cast<size_t>(t + 1) * TM, M,
                 C, TM, g.rowC);
      cp_async_commit();
    }
  }

  // this split's partial: dW1 [C, H], dW2 [H, C], db1 [H]
  float* out = ws + static_cast<size_t>(blockIdx.y) * (2ll * C * H + H);
  float* out2 = out + static_cast<size_t>(C) * H;
#pragma unroll
  for (int i = 0; i < MTT; ++i) {
    const int mi = wm + g.WM * i;
    if (mi >= mtiles) continue;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int j = j0 + wn * 32 + 8 * n + 2 * tq;
      if (j >= H) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 16 * mi + gq + (e >> 1) * 8;
        const int jj = j + (e & 1);
        out[static_cast<size_t>(c) * H + jj] = acc1[i][n][e];
        out2[static_cast<size_t>(jj) * C + c] = acc2[i][n][e];
      }
    }
  }
  if (tid < WC && j0 + tid < H) out[2ll * C * H + j0 + tid] = db1;
}

struct Args {
  const bf16 *x, *w1, *b1, *w2, *dy;
  const float *ls, *lb;
  bf16* dx;
  void *dls, *dlb, *dw1, *db1, *dw2, *db2;
  float* ws;
  int M, C, H;
  float eps;
  int apply_ln;
};

struct Plan {
  int t_split, t_buffers, t_blocks, t_smem;
  int w_units, w_rows, w_mt, w_buffers, w_splits, w_smem;
};

template <int ACT, int NTX>
cudaError_t launch_tokens(const Args& a, const Plan& p, float* part,
                          cudaStream_t s) {
  auto kernel = tokens_kernel<ACT, NTX>;
  cudaError_t err = set_smem(kernel, p.t_smem);
  if (err != cudaSuccess) return err;
  kernel<<<p.t_blocks, kThreads, p.t_smem, s>>>(
      a.x, a.ls, a.lb, a.w1, a.b1, a.w2, a.dy, a.dx, part, a.M, a.C, a.H,
      p.t_split, p.t_buffers, a.eps, a.apply_ln);
  return cudaGetLastError();
}

template <int ACT, int MTT>
cudaError_t launch_weights(const Args& a, const Plan& p, float* wpart,
                           cudaStream_t s) {
  auto kernel = weights_kernel<ACT, MTT>;
  cudaError_t err = set_smem(kernel, p.w_smem);
  if (err != cudaSuccess) return err;
  const int ntiles = (a.M + p.w_rows - 1) / p.w_rows;
  const int tps = (ntiles + p.w_splits - 1) / p.w_splits;
  const dim3 grid((a.H + p.w_units - 1) / p.w_units, p.w_splits);
  kernel<<<grid, kThreads, p.w_smem, s>>>(
      a.x, a.ls, a.lb, a.w1, a.b1, a.w2, a.dy, wpart, a.M, a.C, a.H,
      p.w_units, p.w_rows, p.w_buffers, tps, a.eps, a.apply_ln);
  return cudaGetLastError();
}

template <int ACT>
cudaError_t launch(const Args& a, const Plan& p, cudaStream_t s) {
  const int C = a.C, H = a.H;
  float* part = a.ws;                                     // [P1, 3, C]
  float* wpart = part + 3ll * C * p.t_blocks;             // [S, 2CH + H]
  cudaError_t err = tok_ntx(C, p.t_split) == 8
                        ? launch_tokens<ACT, 8>(a, p, part, s)
                        : launch_tokens<ACT, 16>(a, p, part, s);
  if (err != cudaSuccess) return err;
  err = p.w_mt == 2 ? launch_weights<ACT, 2>(a, p, wpart, s)
                    : launch_weights<ACT, 4>(a, p, wpart, s);
  if (err != cudaSuccess) return err;
  const long long stride = 2ll * C * H + H;
  if ((err = reduce<bf16>(wpart, p.w_splits, stride, C * H, a.dw1, s))) {
    return err;
  }
  if ((err = reduce<bf16>(wpart + static_cast<size_t>(C) * H, p.w_splits,
                          stride, H * C, a.dw2, s))) {
    return err;
  }
  if ((err = reduce<bf16>(wpart + 2ll * C * H, p.w_splits, stride, H, a.db1,
                          s))) {
    return err;
  }
  if ((err = reduce<float>(part, p.t_blocks, 3ll * C, C, a.dls, s))) {
    return err;
  }
  if ((err = reduce<float>(part + C, p.t_blocks, 3ll * C, C, a.dlb, s))) {
    return err;
  }
  return reduce<bf16>(part + 2 * C, p.t_blocks, 3ll * C, C, a.db2, s);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Whether the plan is one the kernels take for these shapes: layouts both
// kernels take (mlp_branch_mma_layout.h), their shared bytes and the
// weights kernel's template, blocks and splits that cover M.
bool plan_ok(int M, int C, int H, const Plan& p) {
  if (M <= 0 || H < 16 || H % 16 || !tok_fits(C, p.t_split, p.t_buffers) ||
      !w_fits(C, p.w_units, p.w_rows, p.w_buffers)) {
    return false;
  }
  const TokGeom tg = tok_geom(C, p.t_split, p.t_buffers);
  const WGeom wg = w_geom(C, p.w_units, p.w_rows, p.w_buffers);
  const int ttiles = (M + tg.TM - 1) / tg.TM;
  const int wtiles = (M + p.w_rows - 1) / p.w_rows;
  if (tg.bytes != p.t_smem || p.t_blocks < 1 || p.t_blocks > ttiles ||
      wg.bytes != p.w_smem || w_mtt(wg.MT) != p.w_mt || p.w_splits < 1 ||
      p.w_splits > wtiles) {
    return false;
  }
  const int tps = (wtiles + p.w_splits - 1) / p.w_splits;
  return (wtiles + tps - 1) / tps == p.w_splits;  // no split left empty
}

}  // namespace

// Floats of fp32 workspace ogvt_mlp_branch_bwd_mma needs: the token
// kernel's t_blocks partials and the weight kernel's w_splits ones.
extern "C" long long ogvt_mlp_branch_bwd_mma_workspace(int M, int C, int H,
                                                       int t_blocks,
                                                       int w_splits) {
  if (M <= 0 || C <= 0 || H <= 0 || t_blocks <= 0 || w_splits <= 0) return 0;
  return 3ll * C * t_blocks + (2ll * C * H + H) * w_splits;
}

// x, dy, dx [M, C]; w1, dw1 [C, H]; b1, db1 [H]; w2, dw2 [H, C]; db2 [C]:
// contiguous bf16 (dtype must be 1), x, w1, w2, dy and dx 16-byte aligned.
// ln_scale, ln_bias, dln_scale, dln_bias [C]: float32. C and H multiples of
// 16. ws: ogvt_mlp_branch_bwd_mma_workspace(M, C, H, t_blocks, w_splits)
// floats. The plan is ops/mlp_branch.py:mlp_branch_backward_plan's: tokens
// kernel split, weight buffers, blocks and shared bytes; weights kernel slab
// units, tile rows, m16 tiles a warp, buffers, splits and shared bytes.
// Returns cudaErrorInvalidValue for a plan or shape it does not take. Every
// output is written (dln_* are 0 without LN).
extern "C" int ogvt_mlp_branch_bwd_mma(
    const void* x, const void* ln_scale, const void* ln_bias, const void* w1,
    const void* b1, const void* w2, const void* dy, void* dx, void* dln_scale,
    void* dln_bias, void* dw1, void* db1, void* dw2, void* db2, void* ws,
    int M, int C, int H, int act, float eps, int apply_ln, int dtype,
    int t_split, int t_buffers, int t_blocks, int t_smem, int w_units,
    int w_rows, int w_mt, int w_buffers, int w_splits, int w_smem,
    void* stream) {
  const Plan p{t_split, t_buffers, t_blocks, t_smem, w_units,
               w_rows,  w_mt,      w_buffers, w_splits, w_smem};
  if (dtype != kBFloat16 || !plan_ok(M, C, H, p) || !aligned16(x) ||
      !aligned16(w1) || !aligned16(w2) || !aligned16(dy) || !aligned16(dx)) {
    return cudaErrorInvalidValue;
  }
  const Args a{static_cast<const bf16*>(x),
               static_cast<const bf16*>(w1),
               static_cast<const bf16*>(b1),
               static_cast<const bf16*>(w2),
               static_cast<const bf16*>(dy),
               static_cast<const float*>(ln_scale),
               static_cast<const float*>(ln_bias),
               static_cast<bf16*>(dx),
               dln_scale, dln_bias, dw1, db1, dw2, db2,
               static_cast<float*>(ws), M, C, H, eps, apply_ln};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (act) {
    case kGelu:
      return launch<kGelu>(a, p, s);
    case kSilu:
      return launch<kSilu>(a, p, s);
    case kRelu:
      return launch<kRelu>(a, p, s);
    default:
      return cudaErrorInvalidValue;
  }
}
