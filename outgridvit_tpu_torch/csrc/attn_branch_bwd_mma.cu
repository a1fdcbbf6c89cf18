// Backward of the fused pre-LN grid-attention branch
// y = proj(MHSA(qkv(LN(x)))) in bf16, with every product on mma.sync
// tensor-core tiles, for grids of 64 tokens on tokens or on an NHWC map.
//
// Replaces the TPU kernels outgridvit_tpu/ops/attn_branch_pallas.py:
// attn_branch_pallas (#5) and outgridvit_tpu/ops/experimental/
// attn_branch_nhwc_pallas.py:attn_branch_nhwc_pallas (#12), backward half
// (`_bwd_kernel`, `_rows_bwd`), for the bf16 launches whose shape the
// kernels are instantiated at (attn_branch_mma_layout.h:takes; the
// shipped N = 64, C = 64 / hd 32 and C = 80 / hd 40). ops/attn_branch.py
// routes them here (backward_entry); fp32 and other shapes keep
// csrc/attn_branch.cu. The math and the rounding points are that kernel's
// (csrc/attn_branch.cu's docstring):
//   xn = round(LN(x)); qkv = round(xn.Wqkv + bqkv); dout = round(dy.Wp^T);
//   per head a = softmax(q.k^T * scale) in fp32 (IEEE division);
//   out = round(round(a).v); dp = dout.v^T; ds = a * (dp - sum_m dp*a);
//   dq = scale * ds.k, dk = scale * ds^T.q, dv = a^T.dout;
//   dxn = round(dqkv).Wqkv^T; dx = the fp32 LN backward of dxn, cast once;
//   over all tokens in fp32: dWqkv = xn^T.round(dqkv), dWp = out^T.dy,
//   dbqkv = sum of the unrounded dqkv, dbp = sum dy, dln_scale =
//   sum dxn * xhat, dln_bias = sum dxn.
// The operands of qkv, dout, q.k^T, round(a).v, dout.v^T, dxn, dWqkv and
// dWp are bf16 values at those rounding points, so one bf16 mma.sync forms
// each product exactly and sums it in fp32. dv, dq and dk take their fp32
// operand (a, ds) as two bf16 terms, hi = bf16(x) and lo = bf16(x - hi)
// (csrc/mma.cuh:split2), into one fp32 accumulator. So only the order of
// the fp32 sums, and the 2^-17 residue of the split, differ from the plain
// version.
//
// What bounds it on the H100: the products, 22*N*C^2 + 10*N^2*C flops a
// grid with the recompute (8.4 MFLOP at N = C = 64), against 4*N*C bytes of
// x, dy and dx (and the parameter grads once): ~380 flop/byte, above the
// tensor cores' ridge (~295). Next, the softmax: an exp and a division per
// logit, 8,192 a grid at 2 heads.
//
// What the design does about it. The deterministic split of
// csrc/mlp_branch_bwd_mma.cu: no float atomics, so two calls are bitwise
// equal.
//   1. attn_bwd_tokens: 8 warps walk a contiguous run of grids (about one wave
//      of blocks, one an SM); Wqkv and Wp stay in shared memory in their own
//      layouts, and x and dy of the next grid are copied by 16-byte cp.async
//      while this one computes (Geom::token gives a token's row, so #5 and
//      #12 share the kernel). Warp (rt, hs) takes the 16 rows of row tile
//      rt: LN per row into the xn tile; half the qkv columns (hs) on mma,
//      rounded with bqkv into the qkv tile; half the dout columns, kept in
//      the dy tile. Then head hs (hs + 2, ...): S = q.k^T in 8 n8
//      accumulators, the softmax in registers (grid_mhsa_packed_mma.cuh),
//      out = round(a).v with round(a) packed straight into A fragments, dp,
//      ds, and a and ds stored as hi / lo bf16 tiles; dq = ds.k. After a
//      barrier the warp owns keys 16rt.. of its head: dv = a^T.dout and
//      dk = ds^T.q, the A fragments by ldmatrix.trans from the hi / lo
//      tiles, summed over the query rows in order. dq, dk and dv (the
//      warp's own token rows) go rounded into the qkv tile; their column
//      sums (unrounded) make dbqkv. Then dxn = round(dqkv).Wqkv^T, the LN
//      backward per row (the two column halves' row sums through shared
//      memory), dx out by 16-byte stores; round(dqkv) and out go to the
//      workspace. dbqkv, dbp, dln_scale and dln_bias: one fp32 partial a
//      block, its grids in order.
//   2. attn_bwd_weights: a block walks a contiguous run of grids (x, dy,
//      round(dqkv) and out staged in two buffers, the next grid's in
//      flight),
//      recomputes xn as the tokens kernel does, and sums dWqkv = xn^T.dqkv
//      (warps 0-5, C/2 columns each) and dWp = out^T.dy (warps 6-7) over
//      the grid's tokens in k16 steps on mma, the transposed operands by
//      ldmatrix.trans. One fp32 partial [C, 4C] a block.
//   3. partials.cuh:reduce_segments: the partials summed in block order,
//      all six outputs in one launch.
// The blocks and their grids depend on G alone, never on the layout, so
// #12's parameter grads equal #5's on the partitioned tokens bit for bit.
// Staged rows are an odd number of 16-byte units apart (row_bytes), so the
// 8 rows one ldmatrix reads fall in 8 distinct bank groups. The launch plan
// (blocks and grids a block of each kernel, shared bytes) is
// ops/attn_branch.py:attn_branch_backward_plan, made from the layout queries
// of attn_branch_mma_layout.cpp; the layout itself is
// attn_branch_mma_layout.h, and the entry points refuse any plan it does not
// match. The staging, LN, ldmatrix and mma loops and the qkv projection are
// attn_branch_mma.cuh's, shared with the forward (csrc/attn_branch_mma.cu),
// so the recompute forms the forward's xn and qkv.
#include "attn_branch_mma.cuh"
#include "common.cuh"
#include "grid_mhsa_packed_mma.cuh"
#include "partials.cuh"

using namespace ogvt;
using namespace ogvt::attn_mma;

namespace {

// The column sums of acc * scale over the warp's 16 rows (rows g and g + 8
// in a lane, then the xor tree over g) into dst[col + 8j + 2t, + 1].
template <int NJ>
__device__ __forceinline__ void col_sums(float* dst, const float (&acc)[NJ][4],
                                         float scale, int col, int lane) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    float c0 = acc[j][0] * scale + acc[j][2] * scale;
    float c1 = acc[j][1] * scale + acc[j][3] * scale;
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      c0 += __shfl_xor_sync(0xffffffffu, c0, o);
      c1 += __shfl_xor_sync(0xffffffffu, c1, o);
    }
    if (lane < 4) {
      dst[col + 8 * j + 2 * lane] = c0;
      dst[col + 8 * j + 2 * lane + 1] = c1;
    }
  }
}

// CT = C / 16, NT = hd / 8.
template <int CT, int NT>
__global__ void __launch_bounds__(kThreads, kTokBlocks)
attn_bwd_tokens(const bf16* __restrict__ x, const float* __restrict__ ls,
              const float* __restrict__ lb, const bf16* __restrict__ wqkv,
              const bf16* __restrict__ bqkv, const bf16* __restrict__ wp,
              const bf16* __restrict__ dy, bf16* __restrict__ dx,
              bf16* __restrict__ ws_dqkv, bf16* __restrict__ ws_out,
              float* __restrict__ part, Geom geo, int G, int grids,
              float scale, float eps, int apply_ln) {
  constexpr int C = 16 * CT, C3 = 3 * C, HD = 8 * NT, HEADS = C / HD;
  constexpr int QT = 3 * CT;  // qkv n8 tiles a warp: half of 3C
  extern __shared__ __align__(16) unsigned char smem[];
  const TokGeom g = tok_geom(C);
  const unsigned base = smem_addr(smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int lr = lane & 7, lm = lane >> 3;
  const int rt = warp & 3, hs = warp >> 2;  // row tile, column half / head
  const int r0 = 16 * rt;
  float* s_mu = reinterpret_cast<float*>(smem + g.mu);
  float* s_rstd = reinterpret_cast<float*>(smem + g.rstd);
  float* s_red = reinterpret_cast<float*>(smem + g.red);  // [6C]
  float* s_cq = reinterpret_cast<float*>(smem + g.cq);    // [4][3C]
  float* s_cs = reinterpret_cast<float*>(smem + g.cs);    // [2][4][C]
  float* s_rs = reinterpret_cast<float*>(smem + g.rs);    // [2][64][2]
  unsigned char* t_xn = smem + g.xn;
  unsigned char* t_qkv = smem + g.qkv;
  const unsigned s_qkv = base + g.qkv;
  for (int i = tid; i < 6 * C; i += kThreads) s_red[i] = 0.f;

  const int w0 = blockIdx.x * grids, w1 = min(G, w0 + grids);
  stage_rows(base + g.wqkv, wqkv, C, C3, g.rowQ);
  stage_rows(base + g.wp, wp, C, C, g.rowC);
  if (w0 < w1) {
    stage_grid(base + g.x, x, geo, w0, C, g.rowC);
    stage_grid(base + g.dy, dy, geo, w0, C, g.rowC);
  }
  cp_async_commit();

  for (int w = w0; w < w1; ++w) {
    const int b = (w - w0) & 1;
    cp_async_wait<0>();
    __syncthreads();  // grid w staged; every warp done with grid w - 1
    if (w + 1 < w1) {
      stage_grid(base + g.x + (b ^ 1) * kN * g.rowC, x, geo, w + 1, C,
                 g.rowC);
      stage_grid(base + g.dy + (b ^ 1) * kN * g.rowC, dy, geo, w + 1, C,
                 g.rowC);
      cp_async_commit();
    }
    unsigned char* t_x = smem + g.x + b * kN * g.rowC;
    unsigned char* t_dy = smem + g.dy + b * kN * g.rowC;
    const unsigned s_x = smem_addr(t_x), s_dy = smem_addr(t_dy);
    if (apply_ln) {
      ln_rows(t_x, t_xn, g.rowC, C, ls, lb, eps, s_mu, s_rstd);
    }
    // dbp: a thread sums a column pair of dy over a row tile in order, into
    // s_cq (free until the key walk)
    for (int i = tid; i < 2 * C; i += kThreads) {
      const int p = i % (C / 2), rg = i / (C / 2);
      float s0 = 0.f, s1 = 0.f;
      for (int r = 16 * rg; r < 16 * rg + 16; ++r) {
        const float2 v =
            unpack(reinterpret_cast<const unsigned*>(t_dy + r * g.rowC)[p]);
        s0 += v.x;
        s1 += v.y;
      }
      s_cq[rg * C + 2 * p] = s0;
      s_cq[rg * C + 2 * p + 1] = s1;
    }
    __syncthreads();  // xn, dbp's row-tile sums
    for (int c = tid; c < C; c += kThreads) {  // the row tiles in order
      s_red[C3 + c] += ((s_cq[c] + s_cq[C + c]) + s_cq[2 * C + c]) +
                       s_cq[3 * C + c];
    }

    // qkv = round(xn.Wqkv + bqkv), the warp's rows and half of the columns
    qkv_rows<CT, QT>(t_qkv, g.rowQ,
                     rows_a(apply_ln ? base + g.xn : s_x, g.rowC, r0, lane),
                     base + g.wqkv, bqkv, r0, hs * QT, lane);
    // dout = round(dy.Wp^T), the warp's rows and half of the columns
    float dout[CT][4];
    zero(dout);
    mma_xyt<2 * CT, CT>(dout, rows_a(s_dy, g.rowC, r0, lane),
                        base + g.wp + hs * (C / 2) * g.rowC, g.rowC, lane);
    __syncthreads();  // every warp done reading xn and dy as operands
    put(t_dy, g.rowC, dout, 1.f, r0, hs * (C / 2), lane);
    __syncthreads();  // qkv and dout

    // per head: the warp's query rows, then (after a barrier) its keys
#pragma unroll 1
    for (int hi = 0; hi < (HEADS + 1) / 2; ++hi) {
      const int h = hs + 2 * hi;
      const bool on = h < HEADS;
      const int cq = h * HD;  // the head's first column in q, k, v, dout
      unsigned char* ad = smem + g.ad + hs * 4 * g.adt;  // a hi, lo; ds hi, lo
      float dq[NT][4];
      if (on) {
        // S = q.k^T, 8 n8 tiles of keys; a = softmax in fp32
        float s[8][4], dp[8][4];
        zero(s);
        mma_xyt<NT, 8>(s, rows_a(s_qkv, g.rowQ, r0, lane) + cq * 2,
                       s_qkv + (C + cq) * 2, g.rowQ, lane);
        // dp = dout.v^T, issued before the softmax that it does not need
        zero(dp);
        mma_xyt<NT, 8>(dp, rows_a(s_dy, g.rowC, r0, lane) + cq * 2,
                       s_qkv + (2 * C + cq) * 2, g.rowQ, lane);
        packed::softmax<8>(s, scale, kN, lane);
        // out = round(round(a).v) into the xn tile
        float o[NT][4];
        zero(o);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const unsigned a[1][4] = {
              {pack(s[2 * kk][0], s[2 * kk][1]),
               pack(s[2 * kk][2], s[2 * kk][3]),
               pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
               pack(s[2 * kk + 1][2], s[2 * kk + 1][3])}};
          mma_rows<NT, 1>(o, a, s_qkv, g.rowQ, 16 * kk, (2 * C + cq) / 8,
                          lane);
        }
        put(t_xn, g.rowC, o, 1.f, r0, cq, lane);
        // ds = a * (dp - sum_m dp*a) in place
#pragma unroll
        for (int hf = 0; hf < 4; hf += 2) {  // rows g, then g + 8
          float d = 0.f;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            d += dp[j][hf] * s[j][hf] + dp[j][hf + 1] * s[j][hf + 1];
          }
          d += __shfl_xor_sync(0xffffffffu, d, 1);
          d += __shfl_xor_sync(0xffffffffu, d, 2);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            dp[j][hf] = s[j][hf] * (dp[j][hf] - d);
            dp[j][hf + 1] = s[j][hf + 1] * (dp[j][hf + 1] - d);
          }
        }
        // a and ds as hi / lo bf16 tiles [query, key] for the key walk
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          unsigned* p0 = reinterpret_cast<unsigned*>(
              ad + (r0 + gq) * g.rowA + (8 * j + 2 * tq) * 2);
          unsigned* p1 = reinterpret_cast<unsigned*>(
              reinterpret_cast<unsigned char*>(p0) + 8 * g.rowA);
          const int t = g.adt / 4;  // one tile, in 4-byte words
          split2(s[j][0], s[j][1], p0[0], p0[t]);
          split2(s[j][2], s[j][3], p1[0], p1[t]);
          split2(dp[j][0], dp[j][1], p0[2 * t], p0[3 * t]);
          split2(dp[j][2], dp[j][3], p1[2 * t], p1[3 * t]);
        }
        // dq = ds.k, ds as two bf16 terms, over the 4 k16 steps of keys
        zero(dq);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          unsigned a[2][4];
          to_a(dp[2 * kk], dp[2 * kk + 1], a[0], a[1]);
          mma_rows<NT, 2>(dq, a, s_qkv, g.rowQ, 16 * kk, (C + cq) / 8, lane);
        }
      }
      __syncthreads();  // every warp's a and ds tiles
      float dk[NT][4], dv[NT][4];
      if (on) {
        // keys 16rt.. of head h: dv = a^T.dout, dk = ds^T.q over the query
        // rows in order, a^T and ds^T by ldmatrix.trans of the hi / lo tiles
        zero(dk);
        zero(dv);
        const unsigned sad = smem_addr(ad) + (lr + (lm >> 1) * 8) * g.rowA +
                             (2 * rt + (lm & 1)) * 16;
#pragma unroll
        for (int kq = 0; kq < 4; ++kq) {
          const unsigned o = sad + 16 * kq * g.rowA;
          unsigned a[2][4];
          ldsm_x4_t(o, a[0]);
          ldsm_x4_t(o + g.adt, a[1]);
          mma_rows<NT, 2>(dv, a, s_dy, g.rowC, 16 * kq, cq / 8, lane);
          ldsm_x4_t(o + 2 * g.adt, a[0]);
          ldsm_x4_t(o + 3 * g.adt, a[1]);
          mma_rows<NT, 2>(dk, a, s_qkv, g.rowQ, 16 * kq, cq / 8, lane);
        }
      }
      __syncthreads();  // every warp done with the head's q, k, v and tiles
      if (on) {  // round(dqkv) of the warp's rows; dbqkv's column sums
        float* cs = s_cq + rt * C3;
        put(t_qkv, g.rowQ, dq, scale, r0, cq, lane);
        col_sums(cs, dq, scale, cq, lane);
        put(t_qkv, g.rowQ, dk, scale, r0, C + cq, lane);
        col_sums(cs, dk, scale, C + cq, lane);
        put(t_qkv, g.rowQ, dv, 1.f, r0, 2 * C + cq, lane);
        col_sums(cs, dv, 1.f, 2 * C + cq, lane);
      }
    }
    __syncthreads();  // round(dqkv), out and the column sums

    // dbqkv: the row tiles in order
    for (int j = tid; j < C3; j += kThreads) {
      s_red[j] += ((s_cq[j] + s_cq[C3 + j]) + s_cq[2 * C3 + j]) +
                  s_cq[3 * C3 + j];
    }
    // round(dqkv) and out to the workspace, for the weights kernel
    const size_t row0 = static_cast<size_t>(w) * kN;
    for (int i = tid; i < kN * (C3 / 8); i += kThreads) {
      const int r = i / (C3 / 8), u = i - r * (C3 / 8);
      *reinterpret_cast<uint4*>(ws_dqkv + (row0 + r) * C3 + u * 8) =
          *reinterpret_cast<const uint4*>(t_qkv + r * g.rowQ + u * 16);
    }
    for (int i = tid; i < kN * (C / 8); i += kThreads) {
      const int r = i / (C / 8), u = i - r * (C / 8);
      *reinterpret_cast<uint4*>(ws_out + (row0 + r) * C + u * 8) =
          *reinterpret_cast<const uint4*>(t_xn + r * g.rowC + u * 16);
    }
    // dxn = round(dqkv).Wqkv^T, the warp's rows and half of the columns
    const int c0 = hs * (C / 2);
    float dxn[CT][4];
    zero(dxn);
    mma_xyt<6 * CT, CT>(dxn, rows_a(s_qkv, g.rowQ, r0, lane),
                        base + g.wqkv + c0 * g.rowQ, g.rowQ, lane);

    // the LN backward: row sums of dxhat and dxhat * xhat (the two column
    // halves through shared memory), column sums of dxn * xhat and dxn
    const int ra = r0 + gq, rb = ra + 8;  // this lane's rows
    const unsigned* xr_a = reinterpret_cast<const unsigned*>(t_x + ra * g.rowC);
    const unsigned* xr_b = reinterpret_cast<const unsigned*>(t_x + rb * g.rowC);
    float mu_a = 0.f, rs_a = 0.f, mu_b = 0.f, rs_b = 0.f;
    float m1a = 0.f, m2a = 0.f, m1b = 0.f, m2b = 0.f;
    if (apply_ln) {
      mu_a = s_mu[ra];
      rs_a = s_rstd[ra];
      mu_b = s_mu[rb];
      rs_b = s_rstd[rb];
      float s1a = 0.f, s2a = 0.f, s1b = 0.f, s2b = 0.f;
#pragma unroll
      for (int n = 0; n < CT; ++n) {
        const int c = c0 + 8 * n + 2 * tq;
        const float l0 = ls[c], l1 = ls[c + 1];
        const float2 xa = unpack(xr_a[c / 2]);
        const float2 xb = unpack(xr_b[c / 2]);
        const float ha0 = (xa.x - mu_a) * rs_a, ha1 = (xa.y - mu_a) * rs_a;
        const float hb0 = (xb.x - mu_b) * rs_b, hb1 = (xb.y - mu_b) * rs_b;
        const float d0 = dxn[n][0] * l0, d1 = dxn[n][1] * l1;
        const float d2 = dxn[n][2] * l0, d3 = dxn[n][3] * l1;
        s1a += d0 + d1;
        s2a = fmaf(d1, ha1, fmaf(d0, ha0, s2a));
        s1b += d2 + d3;
        s2b = fmaf(d3, hb1, fmaf(d2, hb0, s2b));
        float cl0 = fmaf(dxn[n][2], hb0, dxn[n][0] * ha0);
        float cl1 = fmaf(dxn[n][3], hb1, dxn[n][1] * ha1);
        float cb0 = dxn[n][0] + dxn[n][2];
        float cb1 = dxn[n][1] + dxn[n][3];
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
          s_cs[(4 + rt) * C + c] = cb0;
          s_cs[(4 + rt) * C + c + 1] = cb1;
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
        s_rs[ra * 2 + hs] = s1a;
        s_rs[rb * 2 + hs] = s1b;
        s_rs[(kN + ra) * 2 + hs] = s2a;
        s_rs[(kN + rb) * 2 + hs] = s2b;
      }
      __syncthreads();
      for (int c = tid; c < C; c += kThreads) {  // row tiles in order
        s_red[4 * C + c] += ((s_cs[c] + s_cs[C + c]) + s_cs[2 * C + c]) +
                            s_cs[3 * C + c];
        s_red[5 * C + c] += ((s_cs[4 * C + c] + s_cs[5 * C + c]) +
                             s_cs[6 * C + c]) + s_cs[7 * C + c];
      }
      m1a = (s_rs[ra * 2] + s_rs[ra * 2 + 1]) / C;
      m1b = (s_rs[rb * 2] + s_rs[rb * 2 + 1]) / C;
      m2a = (s_rs[(kN + ra) * 2] + s_rs[(kN + ra) * 2 + 1]) / C;
      m2b = (s_rs[(kN + rb) * 2] + s_rs[(kN + rb) * 2 + 1]) / C;
    }
    // dx into the dy tile (dout is read no more), then out by 16-byte stores
    unsigned* da_ = reinterpret_cast<unsigned*>(t_dy + ra * g.rowC);
    unsigned* db_ = reinterpret_cast<unsigned*>(t_dy + rb * g.rowC);
#pragma unroll
    for (int n = 0; n < CT; ++n) {
      const int c = c0 + 8 * n + 2 * tq;
      if (apply_ln) {
        const float l0 = ls[c], l1 = ls[c + 1];
        const float2 xa = unpack(xr_a[c / 2]);
        const float2 xb = unpack(xr_b[c / 2]);
        const float ha0 = (xa.x - mu_a) * rs_a, ha1 = (xa.y - mu_a) * rs_a;
        const float hb0 = (xb.x - mu_b) * rs_b, hb1 = (xb.y - mu_b) * rs_b;
        da_[c / 2] = pack(rs_a * (dxn[n][0] * l0 - m1a - ha0 * m2a),
                          rs_a * (dxn[n][1] * l1 - m1a - ha1 * m2a));
        db_[c / 2] = pack(rs_b * (dxn[n][2] * l0 - m1b - hb0 * m2b),
                          rs_b * (dxn[n][3] * l1 - m1b - hb1 * m2b));
      } else {
        da_[c / 2] = pack(dxn[n][0], dxn[n][1]);
        db_[c / 2] = pack(dxn[n][2], dxn[n][3]);
      }
    }
    __syncthreads();
    for (int i = tid; i < kN * (C / 8); i += kThreads) {
      const int r = i / (C / 8), u = i - r * (C / 8);
      *reinterpret_cast<uint4*>(dx + geo.token(w, r, kN, C) + u * 8) =
          *reinterpret_cast<const uint4*>(t_dy + r * g.rowC + u * 16);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  float* pb = part + static_cast<size_t>(blockIdx.x) * 6 * C;
  for (int i = tid; i < 6 * C; i += kThreads) pb[i] = s_red[i];
}

template <int CT>
__global__ void __launch_bounds__(kThreads, kWBlocks)
attn_bwd_weights(const bf16* __restrict__ x, const float* __restrict__ ls,
               const float* __restrict__ lb, const bf16* __restrict__ dy,
               const bf16* __restrict__ ws_dqkv,
               const bf16* __restrict__ ws_out, float* __restrict__ wpart,
               Geom geo, int G, int grids, float eps, int apply_ln) {
  constexpr int C = 16 * CT, C3 = 3 * C;
  extern __shared__ __align__(16) unsigned char smem[];
  const WGeom g = w_geom(C);
  const unsigned base = smem_addr(smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int lr = lane & 7, lm = lane >> 3;
  // warps 0-5: dWqkv = xn^T.round(dqkv), warps 6-7: dWp = out^T.dy; each
  // C / 2 output columns (CT n8 tiles) over all C rows (CT m16 tiles)
  const bool proj = warp >= 6;
  const int j0 = (proj ? warp - 6 : warp) * (C / 2);
  const int t0 = blockIdx.x * grids, t1 = min(G, t0 + grids);
  auto stage = [&](unsigned buf, int w) {
    stage_grid(buf + g.x, x, geo, w, C, g.rowC);
    stage_grid(buf + g.dy, dy, geo, w, C, g.rowC);
    stage_rows(buf + g.dq, ws_dqkv + static_cast<size_t>(w) * kN * C3, kN,
               C3, g.rowQ);
    stage_rows(buf + g.out, ws_out + static_cast<size_t>(w) * kN * C, kN, C,
               g.rowC);
  };
  if (t0 < t1) stage(base, t0);
  cp_async_commit();

  float acc[CT][CT][4];
#pragma unroll
  for (int i = 0; i < CT; ++i) zero(acc[i]);
  // A of the transposed [tokens, C] tile (ldmatrix .trans): (c 0-7, tokens
  // 0-7), (c 8-15, 0-7), (c 0-7, 8-15), (c 8-15, 8-15); m16 tile mi at
  // + 32 * mi, k16 step ks at + 16 * ks rows
  const unsigned a_ln = (lr + (lm >> 1) * 8) * g.rowC + (lm & 1) * 16;
  // B of the [tokens, n] tile (.trans), the warp's columns
  const int rowb = proj ? g.rowC : g.rowQ;
  const unsigned b_ln =
      (lr + (lm & 1) * 8) * rowb + (j0 / 8 + (lm >> 1)) * 16;
  for (int t = t0; t < t1; ++t) {
    const int b = (t - t0) & 1;
    cp_async_wait<0>();
    __syncthreads();  // grid t staged; every warp done with grid t - 1
    if (t + 1 < t1) {
      stage(base + (b ^ 1) * g.buf, t + 1);
      cp_async_commit();
    }
    const unsigned buf = base + b * g.buf;
    if (apply_ln) {
      unsigned char* tx = smem + b * g.buf + g.x;
      ln_rows(tx, tx, g.rowC, C, ls, lb, eps, nullptr, nullptr);
      __syncthreads();
    }
    const unsigned sa = buf + (proj ? g.out : g.x) + a_ln;
    const unsigned sb = buf + (proj ? g.dy : g.dq) + b_ln;
#pragma unroll
    for (int ks = 0; ks < kN / 16; ++ks) {
      unsigned bf[CT][2];
#pragma unroll
      for (int j = 0; j < CT; j += 2) {
        const unsigned o = sb + 16 * ks * rowb + j * 16;
        if (j + 1 < CT) {
          unsigned q[4];
          ldsm_x4_t(o, q);
          bf[j][0] = q[0];
          bf[j][1] = q[1];
          bf[j + 1][0] = q[2];
          bf[j + 1][1] = q[3];
        } else {
          unsigned q[2];
          ldsm_x2_t(o, q);
          bf[j][0] = q[0];
          bf[j][1] = q[1];
        }
      }
#pragma unroll
      for (int mi = 0; mi < CT; ++mi) {
        unsigned a[4];
        ldsm_x4_t(sa + 16 * ks * g.rowC + mi * 32, a);
#pragma unroll
        for (int j = 0; j < CT; ++j) mma_k16(acc[mi][j], a, bf[j][0], bf[j][1]);
      }
    }
  }
  // this block's partial: dWqkv [C, 3C], then dWp [C, C]
  float* out = wpart + static_cast<size_t>(blockIdx.x) * 4 * C * C +
               (proj ? 3 * C * C : 0);
  const int ld = proj ? C : C3;
#pragma unroll
  for (int mi = 0; mi < CT; ++mi) {
#pragma unroll
    for (int j = 0; j < CT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 16 * mi + gq + (e >> 1) * 8;
        const int col = j0 + 8 * j + 2 * tq + (e & 1);
        out[static_cast<size_t>(c) * ld + col] = acc[mi][j][e];
      }
    }
  }
}

struct Args {
  const bf16 *x, *wqkv, *bqkv, *wp, *dy;
  const float *ls, *lb;
  bf16* dx;
  void *dls, *dlb, *dwqkv, *dbqkv, *dwp, *dbp;
  float* ws;
  Geom geo;
  int G, N, C, heads;
  float scale, eps;
  int apply_ln;
};

struct Plan {
  int t_blocks, t_grids, t_smem, w_splits, w_grids, w_smem;
};

// Whether the plan is one the kernels take for these shapes: the shapes
// they are instantiated at, both layouts' shared bytes, blocks that cover
// the grids.
bool plan_ok(const Args& a, const Plan& p) {
  if (a.G <= 0 || !tok_fits(a.N, a.C, a.heads) ||
      !w_fits(a.N, a.C, a.heads)) {
    return false;
  }
  return p.t_smem == tok_geom(a.C).bytes &&
         p.w_smem == w_geom(a.C).bytes &&
         covers(a.G, p.t_blocks, p.t_grids) &&
         covers(a.G, p.w_splits, p.w_grids);
}

template <int CT, int NT>
cudaError_t launch(const Args& a, const Plan& p, cudaStream_t s) {
  constexpr int C = 16 * CT;
  float* part = a.ws;                                    // [P, 6C]
  float* wpart = part + 6ll * C * p.t_blocks;            // [S, 4C^2]
  bf16* ws_dqkv =
      reinterpret_cast<bf16*>(wpart + 4ll * C * C * p.w_splits);  // [M, 3C]
  bf16* ws_out = ws_dqkv + static_cast<size_t>(a.G) * kN * 3 * C;  // [M, C]
  auto tk = attn_bwd_tokens<CT, NT>;
  cudaError_t err = set_smem(tk, p.t_smem);
  if (err != cudaSuccess) return err;
  tk<<<p.t_blocks, kThreads, p.t_smem, s>>>(
      a.x, a.ls, a.lb, a.wqkv, a.bqkv, a.wp, a.dy, a.dx, ws_dqkv, ws_out,
      part, a.geo, a.G, p.t_grids, a.scale, a.eps, a.apply_ln);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  auto wk = attn_bwd_weights<CT>;
  if ((err = set_smem(wk, p.w_smem)) != cudaSuccess) return err;
  wk<<<p.w_splits, kThreads, p.w_smem, s>>>(a.x, a.ls, a.lb, a.dy, ws_dqkv,
                                            ws_out, wpart, a.geo, a.G,
                                            p.w_grids, a.eps, a.apply_ln);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long ws = 4ll * C * C, ts = 6ll * C;
  const Segs<6> segs{{{wpart, p.w_splits, ws, 3 * C * C, a.dwqkv, 0},
                      {wpart + 3ll * C * C, p.w_splits, ws, C * C, a.dwp, 0},
                      {part, p.t_blocks, ts, 3 * C, a.dbqkv, 0},
                      {part + 3 * C, p.t_blocks, ts, C, a.dbp, 0},
                      {part + 4 * C, p.t_blocks, ts, C, a.dls, 1},
                      {part + 5 * C, p.t_blocks, ts, C, a.dlb, 1}}};
  return reduce_segments(segs, 3 * C * C, s);
}

int bwd(const Args& a, const Plan& p, int dtype, void* stream) {
  if (dtype != kBFloat16 || !plan_ok(a, p) || !aligned16(a.x) ||
      !aligned16(a.wqkv) || !aligned16(a.wp) || !aligned16(a.dy) ||
      !aligned16(a.dx) || !aligned16(a.ws)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the instantiations: takes() of the layout header
  if (a.C == 64) return launch<4, 4>(a, p, s);
  return launch<5, 5>(a, p, s);
}

Args make_args(const void* x, const void* ln_scale, const void* ln_bias,
               const void* wqkv, const void* bqkv, const void* wp,
               const void* dy, void* dx, void* dln_scale, void* dln_bias,
               void* dwqkv, void* dbqkv, void* dwp, void* dbp, void* ws,
               Geom geo, int G, int N, int C, int heads, float scale,
               float eps, int apply_ln) {
  return Args{static_cast<const bf16*>(x),
              static_cast<const bf16*>(wqkv),
              static_cast<const bf16*>(bqkv),
              static_cast<const bf16*>(wp),
              static_cast<const bf16*>(dy),
              static_cast<const float*>(ln_scale),
              static_cast<const float*>(ln_bias),
              static_cast<bf16*>(dx),
              dln_scale, dln_bias, dwqkv, dbqkv, dwp, dbp,
              static_cast<float*>(ws), geo, G, N, C, heads, scale, eps,
              apply_ln};
}

}  // namespace

// Floats of workspace ogvt_attn_branch[_nhwc]_bwd_mma needs for G grids of
// 64 tokens and C channels under a plan of t_blocks tokens blocks and
// w_splits weights blocks: their fp32 partials ([t_blocks, 6C], [w_splits,
// 4C^2]), then round(dqkv) [G*64, 3C] and out [G*64, C] in bf16.
extern "C" long long ogvt_attn_branch_bwd_mma_workspace(int G, int C,
                                                        int t_blocks,
                                                        int w_splits) {
  if (G <= 0 || C <= 0 || t_blocks <= 0 || w_splits <= 0) return 0;
  return 6ll * C * t_blocks + 4ll * C * C * w_splits +
         2ll * kN * C * static_cast<long long>(G);
}

// x, dy, dx [G, N, C]; wqkv, dwqkv [C, 3C]; bqkv, dbqkv [3C]; wp, dwp
// [C, C]; dbp [C]: contiguous bf16 (dtype must be 1); x, wqkv, wp, dy, dx
// and ws 16-byte aligned. ln_scale, ln_bias, dln_scale, dln_bias [C]:
// float32. ws: ogvt_attn_branch_bwd_mma_workspace(G, C, t_blocks, w_splits)
// floats. The plan is ops/attn_branch.py:attn_branch_backward_plan's:
// tokens blocks, grids a block, shared bytes; weights blocks, grids a
// block, shared bytes. Returns cudaErrorInvalidValue for a plan or
// shape it does not take. Every output is written (dln_* are 0 without LN).
extern "C" int ogvt_attn_branch_bwd_mma(
    const void* x, const void* ln_scale, const void* ln_bias,
    const void* wqkv, const void* bqkv, const void* wp, const void* dy,
    void* dx, void* dln_scale, void* dln_bias, void* dwqkv, void* dbqkv,
    void* dwp, void* dbp, void* ws, int G, int N, int C, int heads,
    float scale, float eps, int apply_ln, int dtype, int t_blocks,
    int t_grids, int t_smem, int w_splits, int w_grids, int w_smem,
    void* stream) {
  const Args a = make_args(x, ln_scale, ln_bias, wqkv, bqkv, wp, dy, dx,
                           dln_scale, dln_bias, dwqkv, dbqkv, dwp, dbp, ws,
                           Geom{0, 0, 0}, G, N, C, heads, scale, eps,
                           apply_ln);
  const Plan p{t_blocks, t_grids, t_smem, w_splits, w_grids, w_smem};
  return bwd(a, p, dtype, stream);
}

// The same on x, dy, dx [B, H, W, C] with grid size g: the B*g*g windows of
// (H/g)*(W/g) tokens; ws and the plan as for B*g*g grids.
extern "C" int ogvt_attn_branch_nhwc_bwd_mma(
    const void* x, const void* ln_scale, const void* ln_bias,
    const void* wqkv, const void* bqkv, const void* wp, const void* dy,
    void* dx, void* dln_scale, void* dln_bias, void* dwqkv, void* dbqkv,
    void* dwp, void* dbp, void* ws, int B, int H, int W, int C, int g,
    int heads, float scale, float eps, int apply_ln, int dtype, int t_blocks,
    int t_grids, int t_smem, int w_splits, int w_grids, int w_smem,
    void* stream) {
  Geom geo;
  int G, N;
  if (!nhwc_geom(B, H, W, g, &geo, &G, &N)) return cudaErrorInvalidValue;
  const Args a = make_args(x, ln_scale, ln_bias, wqkv, bqkv, wp, dy, dx,
                           dln_scale, dln_bias, dwqkv, dbqkv, dwp, dbp, ws,
                           geo, G, N, C, heads, scale, eps, apply_ln);
  const Plan p{t_blocks, t_grids, t_smem, w_splits, w_grids, w_smem};
  return bwd(a, p, dtype, stream);
}
