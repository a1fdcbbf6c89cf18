// Backward of the fused outlook projection in bf16, its five products on
// mma.sync tensor-core tiles and one pass per tile:
//   #7  out = aggregate(v, a).Wp + bp
//   #8  out = aggregate(x.Wv + bv, a).Wp + bp   (the fold)
//
// Replaces the TPU kernels outgridvit_tpu/ops/experimental/
// outlook_agg_pallas.py: outlook_attention_proj_pallas (#7, `_bwd_kernel`,
// `_bwd_chunk_kernel`) and outlook_branch_pallas (#8, `_bwdv_kernel`,
// `_bwdv_chunk_kernel`), backward half, for bf16 launches that its plan
// takes (ops/outlook_agg.py:outlook_agg_backward_plan routes them here;
// fp32 and other shapes keep csrc/outlook_agg.cu). The math and rounding
// points are that kernel's (csrc/outlook_agg.cu's docstring): y =
// round(sum_t v[p + off_t] * w_t) with the fp32 v; dyag = g.Wp^T in fp32;
// da[p, h*9+t] = sum over head h's channels of v[p + off_t] * dyag[p];
// dv[q] = sum_t (dyag * w_t)[q - off_t] in fp32; dWp = y^T.g, dbp = sum g;
// with the fold v = x.Wv + bv (fp32, never rounded), dx = round(dv).Wv^T,
// dWv = x^T.round(dv), dbv = sum of the unrounded dv. The operands of the
// five products (x, Wv, g, Wp, y, round(dv)) are bf16 values at those
// rounding points, so mma.sync.m16n8k16 with bf16 operands and fp32
// accumulators forms each product exactly and sums it in fp32: only the
// order of the fp32 sums differs from the plain version. The taps stay fp32
// on the FMA pipe in the plain version's order, each product rounded apart.
//
// What bounds it on the H100: bytes (x, a and g read, dx and da written;
// the products are ~40 flop a byte, far below the tensor cores' ~295), then
// the fp32 taps, ~45 FMA-pipe instructions a (pixel, channel) that the
// tensor cores cannot take, each fed by its own shared-memory read. As
// measured (PERF.md's phase profile), it is latency-bound: 16 warps an
// SM, phases behind block barriers, each at about a third of the rate its
// instructions could be dispatched at.
//
// What the design does about it. A block of 16 warps (one an SM: up to 227
// KB of shared memory) walks tiles of R whole image rows of one image (t =
// blockIdx.x, + gridDim.x, ...). A tile's x (or v), g and tap weights a are
// staged by cp.async for its rows and one halo row above and below (rows
// outside the image zero-filled: zero v, not bv; zero dyag); the next
// tile's rows are prefetched into L2 as a tile starts and staged as soon as
// the dW products have read this tile's, under dx and the stores. Wp and Wv
// stay resident. Per chunk of CH channels:
//   1. v = x.Wv + bv and dyag = g.Wp^T at every staged pixel on mma.sync
//      (the halo rows' dyag recomputed, so no fp32 dyag leaves the block),
//      into fp32 rows padded with a zero pixel either side, so that the
//      taps need no column test;
//   2. one thread a (pixel, head, part of the head's channels; the parts
//      in neighbouring lanes), four channels at a time: y (into a bf16
//      tile) and da (the parts' sums over their lanes' xor tree), from the
//      fp32 v around the pixel and its dyag;
//   3. the same threads: dv from the dyag and a around the pixel (gather
//      form: no pixel is added to twice);
//   4. the fold: dbv from the unrounded dv by column sums over kSegs pixel
//      segments in order, and round(dv) into a bf16 tile.
// Then per tile dWp += y^T.g and dWv += x^T.round(dv) on mma.sync into
// register accumulators held across the block's tiles (ldmatrix.trans of
// the staged [pixels, channels] tiles), dbp from column sums of g, dx =
// round(dv).Wv^T on mma.sync through the y tile, and dx (dv) and da out by
// coalesced stores. Each block's fp32 partial is summed with the others in
// block order (partials.cuh:reduce_segments), with no float atomics: two
// calls give bitwise-equal grads. Staged bf16 rows are an odd number of
// 16-byte units apart (row_bytes). The layout is outlook_agg_mma_layout.h;
// the entry point refuses any plan it does not match. The staging, the v
// and dyag products and the taps of y are outlook_agg_mma.cuh's, shared
// with the forward (csrc/outlook_agg_fwd_mma.cu).
#include "outlook_agg_mma.cuh"
#include "partials.cuh"

using namespace ogvt;
using namespace ogvt::outlook_mma;

namespace {

// acc += A^T.B over K rows: A [K, *] and B [K, *] row-major bf16 tiles whose
// 16 columns start at shared addresses a0 and b0 (row 0), rows rowA and
// rowB bytes apart; both by ldmatrix.trans.
__device__ __forceinline__ void mma_cols_step(unsigned a_ln, int rowA,
                                              unsigned b_ln, int rowB, int k,
                                              float (&acc)[2][4]) {
  unsigned af[4], bf[4];
  ldsm_x4_t(a_ln + k * 16 * rowA, af);
  ldsm_x4_t(b_ln + k * 16 * rowB, bf);
  mma_k16(acc[0], af, bf[0], bf[1]);
  mma_k16(acc[1], af, bf[2], bf[3]);
}

__device__ __forceinline__ unsigned cols_a(unsigned a0, int rowA) {
  const int lane = threadIdx.x % 32, lr = lane % 8, lm = lane / 8;
  return a0 + (lr + (lm >> 1) * 8) * rowA + (lm & 1) * 16;
}

__device__ __forceinline__ unsigned cols_b(unsigned b0, int rowB) {
  const int lane = threadIdx.x % 32, lr = lane % 8, lm = lane / 8;
  return b0 + (lr + (lm & 1) * 8) * rowB + (lm >> 1) * 16;
}

__device__ __forceinline__ void mma_cols(unsigned a0, int rowA, unsigned b0,
                                         int rowB, int K,
                                         float (&acc)[2][4]) {
  const unsigned a = cols_a(a0, rowA), b = cols_b(b0, rowB);
#pragma unroll 2
  for (int k = 0; k < K / 16; ++k) mma_cols_step(a, rowA, b, rowB, k, acc);
}

// Two such products over the same K, their steps interleaved.
__device__ __forceinline__ void mma_cols2(unsigned a0, int rowA, unsigned b0,
                                          int rowB, float (&acc0)[2][4],
                                          unsigned a1, int rowA1, unsigned b1,
                                          int rowB1, float (&acc1)[2][4],
                                          int K) {
  const unsigned pa = cols_a(a0, rowA), pb = cols_b(b0, rowB);
  const unsigned qa = cols_a(a1, rowA1), qb = cols_b(b1, rowB1);
#pragma unroll 2
  for (int k = 0; k < K / 16; ++k) {
    mma_cols_step(pa, rowA, pb, rowB, k, acc0);
    mma_cols_step(qa, rowA1, qb, rowB1, k, acc1);
  }
}

template <bool kFold, int NU>
__global__ void __launch_bounds__(kThreads, 1)
outlook_bwd_mma(const bf16* __restrict__ x, const bf16* __restrict__ a,
                const bf16* __restrict__ wv, const bf16* __restrict__ bv,
                const bf16* __restrict__ wp, const bf16* __restrict__ g,
                bf16* __restrict__ dx, bf16* __restrict__ da,
                float* __restrict__ part, int B, int H, int W, int Cin,
                int C, int heads, int R, int CH) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Geom G = geom(W, Cin, C, heads, R, CH, kFold);
  const unsigned base = smem_addr(smem);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;  // fragment row, column pair
  const int hd = G.hd, h9 = G.h9, ldv = G.ldv;
  const int nc = C / 16;
  bf16* s_a = reinterpret_cast<bf16*>(smem + G.as);
  const bool a_pairs = pairs_ok(a, W, h9);
  float* s_v = reinterpret_cast<float*>(smem + G.vf);
  float* s_d = reinterpret_cast<float*>(smem + G.df);
  bf16* s_da = reinterpret_cast<bf16*>(smem + G.da);
  float* s_red = reinterpret_cast<float*>(smem + G.red);
  float* s_dbp = reinterpret_cast<float*>(smem + G.dbp);
  float* s_dbv = reinterpret_cast<float*>(smem + G.dbv);

  stage_rows(base + G.wp, wp, 0, 0, C, C, C, G.rowC);
  if (kFold) stage_rows(base + G.wv, wv, 0, 0, Cin, Cin, C, G.rowC);
  cp_async_commit();
  for (int c = tid; c < C; c += kThreads) s_dbp[c] = s_dbv[c] = 0.f;

  // dWp, and dWv with the fold: the m16n16 tiles u = warp + kWarps * k
  float accp[NU][2][4], accv[NU][2][4];
#pragma unroll
  for (int k = 0; k < NU; ++k) {
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) accp[k][n][e] = accv[k][n][e] = 0.f;
    }
  }

  // v and dyag sit in the padded layout (one zero pixel left and right of
  // each staged row): written only at the image's pixels, so the padding
  // stays 0 and the taps need no column test
  for (int i = tid; i < G.NP * ldv; i += kThreads) s_v[i] = s_d[i] = 0.f;
  const int WP = W + 2;
  const FastDiv divW(W), divSP(G.SP);
  const int lnp = __ffs(G.np) - 1;  // np is a power of 2

  const int per = (H + R - 1) / R, ntiles = B * per;
  // stage tile tt's rows: x (or v), g and a of its R rows and the halo rows,
  // the rows outside the image zero-filled
  auto stage = [&](int tt) {
    const int bb = tt / per, rr = (tt - bb * per) * R;
    const long long f = (static_cast<long long>(bb) * H + rr - 1) * W;
    const int lo = rr == 0 ? W : 0, hi = min(R + 2, H - rr + 1) * W;
    stage_rows(base + G.xs, x, f, lo, hi, G.NE, Cin, G.rowX);
    stage_rows(base + G.gs, g, f, lo, hi, G.NE, C, G.rowC);
    stage_flat(s_a, a, f, lo, hi, G.ext, h9, a_pairs);
    cp_async_commit();
  };
  if (blockIdx.x < ntiles) stage(blockIdx.x);
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int b = t / per, r0 = (t - b * per) * R, nr = min(R, H - r0);
    // the image pixel of staged pixel 0 (the halo row above the tile)
    const long long first = (static_cast<long long>(b) * H + r0 - 1) * W;
    const long long pix0 = first + W;
    const int Sv = nr * W;  // the tile's pixels
    // the staged pixels inside the image
    const int e_lo = r0 == 0 ? W : 0, e_hi = min(R + 2, H - r0 + 1) * W;
    if (t + gridDim.x < ntiles) {  // the next tile's rows into L2
      const int tn = t + gridDim.x, bn = tn / per, rn = (tn - bn * per) * R;
      const long long fn = (static_cast<long long>(bn) * H + rn - 1) * W;
      const int lo = rn == 0 ? W : 0, hi = min(R + 2, H - rn + 1) * W;
      prefetch_l2(x + (fn + lo) * Cin, 2ll * (hi - lo) * Cin);
      prefetch_l2(g + (fn + lo) * C, 2ll * (hi - lo) * C);
      prefetch_l2(a + (fn + lo) * h9, 2ll * (hi - lo) * h9);
    }
    cp_async_wait<0>();
    __syncthreads();

    for (int c0 = 0; c0 < C; c0 += CH) {
      // 1. v (the fold: x.Wv + bv; else x) and dyag = g.Wp^T of the chunk's
      // channels at every staged pixel, fp32, 0 outside the image
      if (CH % 32 == 0) {
        products<kFold, true, 2>(G, base, s_v, s_d, bv, c0, CH, Cin, C, W,
                                 e_lo, e_hi, divW);
      } else {
        products<kFold, true, 1>(G, base, s_v, s_d, bv, c0, CH, Cin, C, W,
                                 e_lo, e_hi, divW);
      }
      if (!kFold) values_f32(G, smem, s_v, c0, CH, W, divW);
      __syncthreads();

      // 2. y and da, a thread a (tile pixel, head of the chunk, part of its
      // channels), the parts' da summed over their lanes; rows past the
      // tile's pixels get y = 0 (they enter dWp's sums). Every lane of a
      // warp runs the same iterations (an item past the last, or a pixel
      // past the tile's, computes pixel 0's and stores nothing), so the
      // parts' sums take full-warp shuffles.
      const int hc = CH / hd, h0 = c0 / hd, np = G.np, cp = hd / np;
      const int items = G.SP * hc * np;
      const int tstride = WP * ldv;  // one padded row
      for (int i0 = tid - lane; i0 < items; i0 += kThreads) {
        const int i = min(i0 + lane, items - 1);
        const int part = i & (np - 1), rest = i >> lnp;
        const int hl = divSP.div(rest), sl = rest - hl * G.SP, h = h0 + hl;
        const int cl0 = hl * hd + part * cp;
        const bool live = i0 + lane < items && sl < Sv;
        if (i0 + lane < items && sl >= Sv) {
          unsigned* yrow = reinterpret_cast<unsigned*>(smem + G.ys +
                                                       sl * G.rowO) +
                           (c0 + cl0) / 2;
          for (int c = 0; c < cp; c += 2) yrow[c / 2] = 0u;
        }
        const int s = live ? sl : 0, r = divW.div(s);
        unsigned* yrow = reinterpret_cast<unsigned*>(smem + G.ys +
                                                     s * G.rowO) +
                         (c0 + cl0) / 2;
        // the tap weights of the pixel; its neighbours in the padded rows
        float w[kTaps], dac[kTaps];
#pragma unroll
        for (int tp = 0; tp < kTaps; ++tp) {
          w[tp] = to_f32(s_a[(s + W) * h9 + h * kTaps + tp]);
          dac[tp] = 0.f;
        }
        const int P = (r + 1) * WP + s - r * W + 1;
        const float* vrow = s_v + P * ldv + cl0;
        const float* drow = s_d + P * ldv + cl0;
        // four channels at a time, the taps inside
        for (int c = 0; c < cp; c += 4) {
          const float2 da0 = *reinterpret_cast<const float2*>(drow + c);
          const float2 da1 = *reinterpret_cast<const float2*>(drow + c + 2);
          float y[4];
          taps4<true>(vrow + c, tstride, ldv, w, da0, da1, dac, y);
          if (live) {
            yrow[c / 2] = pack2(y[0], y[1]);
            yrow[c / 2 + 1] = pack2(y[2], y[3]);
          }
        }
        // the np lanes of the head: a tree over the parts; lane `part`
        // stores taps part, part + np, ...
#pragma unroll
        for (int tp = 0; tp < kTaps; ++tp) {
          for (int o = 1; o < np; o <<= 1) {
            dac[tp] += __shfl_xor_sync(0xffffffffu, dac[tp], o);
          }
          if (live && tp % np == part) {
            s_da[s * h9 + h * kTaps + tp] = __float2bfloat16(dac[tp]);
          }
        }
      }
      __syncthreads();

      // 3. dv[q] = sum_t (dyag * w_t)[q - off_t], a thread a (tile pixel,
      // head of the chunk, part of its channels): unrounded into the v rows
      // (the fold), or rounded into the dv tile (0 on rows past the tile's
      // pixels). A source pixel in a padding column has dyag 0 and, here,
      // the tap weight 0.
      for (int i = tid; i < items; i += kThreads) {
        const int part = i & (np - 1), rest = i >> lnp;
        const int hl = divSP.div(rest), s = rest - hl * G.SP, h = h0 + hl;
        const int cl0 = hl * hd + part * cp;
        unsigned* dout = reinterpret_cast<unsigned*>(smem + G.dvs +
                                                     s * G.rowC) +
                         (c0 + cl0) / 2;
        if (s >= Sv) {
          if (!kFold) {
            for (int c = 0; c < cp; c += 2) dout[c / 2] = 0u;
          }
          continue;
        }
        const int e = s + W, r = divW.div(s), j = s - r * W;
        float w[kTaps];
#pragma unroll
        for (int tp = 0; tp < kTaps; ++tp) {
          const int ox = tp % 3 - 1, oy = tp / 3 - 1;
          const bool ok = !((ox > 0 && j == 0) || (ox < 0 && j == W - 1));
          w[tp] = ok ? to_f32(s_a[(e - oy * W - ox) * h9 + h * kTaps + tp])
                     : 0.f;
        }
        const int P = (r + 1) * WP + j + 1;
        const float* drow = s_d + P * ldv + cl0;
        float* vout = s_v + P * ldv + cl0;
        for (int c = 0; c < cp; c += 4) {
          float q0 = 0.f, q1 = 0.f, q2 = 0.f, q3 = 0.f;
#pragma unroll
          for (int tp = 0; tp < kTaps; ++tp) {
            const float* dp =
                drow - (tp / 3 - 1) * tstride - (tp % 3 - 1) * ldv + c;
            const float2 da0 = *reinterpret_cast<const float2*>(dp);
            const float2 da1 = *reinterpret_cast<const float2*>(dp + 2);
            q0 = __fadd_rn(q0, __fmul_rn(da0.x, w[tp]));
            q1 = __fadd_rn(q1, __fmul_rn(da0.y, w[tp]));
            q2 = __fadd_rn(q2, __fmul_rn(da1.x, w[tp]));
            q3 = __fadd_rn(q3, __fmul_rn(da1.y, w[tp]));
          }
          if (kFold) {
            *reinterpret_cast<float2*>(vout + c) = make_float2(q0, q1);
            *reinterpret_cast<float2*>(vout + c + 2) = make_float2(q2, q3);
          } else {
            dout[c / 2] = pack2(q0, q1);
            dout[c / 2 + 1] = pack2(q2, q3);
          }
        }
      }
      __syncthreads();

      // 4. the fold: dbv from the unrounded dv, column sums over kSegs
      // pixel segments in order; round(dv) into the dv tile (0 on rows past
      // the tile's pixels)
      if (kFold) {
        const int L = (G.SP + kSegs - 1) / kSegs;
        bf16* s_dv = reinterpret_cast<bf16*>(smem + G.dvs);
        for (int i = tid; i < CH * kSegs; i += kThreads) {
          const int cl = i % CH, seg = i / CH;
          const int s1 = min(G.SP, (seg + 1) * L);
          float sum = 0.f;
          int r = divW.div(seg * L), j = seg * L - r * W;
          for (int s = seg * L; s < s1; ++s) {
            const float d =
                s < Sv ? s_v[((r + 1) * WP + j + 1) * ldv + cl] : 0.f;
            sum += d;
            s_dv[s * (G.rowC / 2) + c0 + cl] = __float2bfloat16(d);
            if (++j == W) {
              j = 0;
              ++r;
            }
          }
          s_red[seg * C + c0 + cl] = sum;
        }
        __syncthreads();
        for (int cl = tid; cl < CH; cl += kThreads) {
          float sum = 0.f;
          for (int seg = 0; seg < kSegs; ++seg) {
            sum += s_red[seg * C + c0 + cl];
          }
          s_dbv[c0 + cl] += sum;
        }
      }
      __syncthreads();  // before the next chunk's products overwrite v, dyag
    }

    // dbp: column sums of g over the tile's pixels, kSegs segments in order
    {
      const int L = (Sv + kSegs - 1) / kSegs;
      const bf16* s_g = reinterpret_cast<const bf16*>(smem + G.gs);
      for (int i = tid; i < C * kSegs; i += kThreads) {
        const int c = i % C, seg = i / C;
        const int s1 = min(Sv, (seg + 1) * L);
        float sum = 0.f;
        for (int s = seg * L; s < s1; ++s) {
          sum += to_f32(s_g[(W + s) * (G.rowC / 2) + c]);
        }
        s_red[seg * C + c] = sum;
      }
    }
    // dWp += y^T.g and (the fold) dWv += x^T.round(dv) over the tile's
    // pixels (rows past them: y and round(dv) are 0)
#pragma unroll
    for (int k = 0; k < NU; ++k) {
      const int u = warp + kWarps * k;
      const unsigned ap = base + G.ys + (u / nc) * 32;
      const unsigned bp = base + G.gs + W * G.rowC + (u % nc) * 32;
      const unsigned av = base + G.xs + W * G.rowX + (u / nc) * 32;
      const unsigned bvv = base + G.dvs + (u % nc) * 32;
      if (kFold && u < nc * nc && u < (Cin / 16) * nc) {  // both at once
        mma_cols2(ap, G.rowO, bp, G.rowC, accp[k], av, G.rowX, bvv, G.rowC,
                  accv[k], G.SP);
      } else if (u < nc * nc) {
        mma_cols(ap, G.rowO, bp, G.rowC, G.SP, accp[k]);
      } else if (kFold && u < (Cin / 16) * nc) {
        mma_cols(av, G.rowX, bvv, G.rowC, G.SP, accv[k]);
      }
    }
    __syncthreads();  // the y tile and the column sums are read
    // x, g and a are free: the next tile's rows come in under dx and the
    // stores
    if (t + gridDim.x < ntiles) stage(t + gridDim.x);
    for (int c = tid; c < C; c += kThreads) {
      float sum = 0.f;
      for (int seg = 0; seg < kSegs; ++seg) sum += s_red[seg * C + c];
      s_dbp[c] += sum;
    }
    if (kFold) {  // dx = round(dv).Wv^T into the y tile
      const int ngx = Cin / 16;
      for (int u = warp; u < (G.SP / 16) * ngx; u += kWarps) {
        const int m0 = (u / ngx) * 16, n0 = (u % ngx) * 16;
        float acc[2][4] = {};
        mma_rows<false, 1>(base + G.dvs + m0 * G.rowC, G.rowC,
                           base + G.wv + n0 * G.rowC, G.rowC, C, acc);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            *reinterpret_cast<unsigned*>(
                smem + G.ys + (m0 + gq + 8 * hh) * G.rowO +
                (n0 + 8 * n + 2 * tq) * 2) =
                pack2(acc[n][2 * hh], acc[n][2 * hh + 1]);
          }
        }
      }
      __syncthreads();
    }
    // out: dx (the fold, from the y tile) or dv (from the dv tile), and da
    {
      const int cols = kFold ? Cin : C, units = cols / 8;
      const int rowb = kFold ? G.rowO : G.rowC;
      const unsigned char* src = smem + (kFold ? G.ys : G.dvs);
      for (int i = tid; i < Sv * units; i += kThreads) {
        const int s = i / units, u = i - s * units;
        *reinterpret_cast<uint4*>(dx + (pix0 + s) * cols + u * 8) =
            *reinterpret_cast<const uint4*>(src + s * rowb + u * 16);
      }
      bf16* dat = da + pix0 * h9;
      for (int i = tid; i < Sv * h9; i += kThreads) dat[i] = s_da[i];
    }
    __syncthreads();  // before the next tile overwrites the y, dv, da tiles
  }

  // this block's partial: dWp [C, C], dbp [C]; the fold: dWv [Cin, C],
  // dbv [C]
  float* pb = part + blockIdx.x * partial_floats(Cin, C, kFold);
#pragma unroll
  for (int k = 0; k < NU; ++k) {
    const int u = warp + kWarps * k;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = (u / nc) * 16 + gq + (e >> 1) * 8;
        const int c = (u % nc) * 16 + 8 * n + 2 * tq + (e & 1);
        if (u < nc * nc) pb[r * C + c] = accp[k][n][e];
        if (kFold && u < (Cin / 16) * nc) {
          pb[C * C + C + r * C + c] = accv[k][n][e];
        }
      }
    }
  }
  for (int c = tid; c < C; c += kThreads) {
    pb[C * C + c] = s_dbp[c];
    if (kFold) pb[C * C + C + Cin * C + c] = s_dbv[c];
  }
}

struct Args {
  const bf16 *x, *a, *wv, *bv, *wp, *g;
  bf16 *dx, *da;
  void *dwv, *dbv, *dwp, *dbp;
  float* ws;
  int B, H, W, Cin, C, heads, rows, chunk, blocks;
};

template <bool kFold, int NU>
cudaError_t launch(const Args& r, int smem, cudaStream_t s) {
  auto kernel = outlook_bwd_mma<kFold, NU>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<r.blocks, kThreads, smem, s>>>(
      r.x, r.a, r.wv, r.bv, r.wp, r.g, r.dx, r.da, r.ws, r.B, r.H, r.W,
      r.Cin, r.C, r.heads, r.rows, r.chunk);
  if ((err = cudaGetLastError())) return err;
  const long long per = partial_floats(r.Cin, r.C, kFold);
  const int C = r.C, CC = C * C;
  if (kFold) {
    const Segs<4> segs{{{r.ws, r.blocks, per, CC, r.dwp, 0},
                        {r.ws + CC, r.blocks, per, C, r.dbp, 0},
                        {r.ws + CC + C, r.blocks, per, r.Cin * C, r.dwv, 0},
                        {r.ws + CC + C + r.Cin * C, r.blocks, per, C, r.dbv,
                         0}}};
    return reduce_segments(segs, r.Cin > C ? r.Cin * C : CC, s);
  }
  const Segs<2> segs{{{r.ws, r.blocks, per, CC, r.dwp, 0},
                      {r.ws + CC, r.blocks, per, C, r.dbp, 0}}};
  return reduce_segments(segs, CC, s);
}

template <bool kFold>
cudaError_t dispatch(const Args& r, int slots, int smem, cudaStream_t s) {
  switch (slots) {
    case 1:
      return launch<kFold, 1>(r, smem, s);
    case 2:
      return launch<kFold, 2>(r, smem, s);
    case 3:
      return launch<kFold, 3>(r, smem, s);
    case 4:
      return launch<kFold, 4>(r, smem, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Floats of fp32 workspace ogvt_outlook_agg_bwd_mma needs: one partial a
// block.
extern "C" long long ogvt_outlook_agg_bwd_mma_workspace(int Cin, int C,
                                                        int fold,
                                                        int blocks) {
  if (Cin <= 0 || C <= 0 || blocks <= 0) return 0;
  return blocks * partial_floats(Cin, C, fold != 0);
}

// Inputs and outputs as ogvt_outlook_agg_bwd's (x [B, H, W, Cin], v when
// fold == 0; a [B, H, W, heads*9]; wv [Cin, C], bv [C], null without the
// fold; wp [C, C]; g [B, H, W, C]; dx like x, da like a, dwv / dbv, dwp,
// dbp), contiguous bf16 (dtype must be 1), x, wv, wp, g and dx 16-byte
// aligned. ws: ogvt_outlook_agg_bwd_mma_workspace(Cin, C, fold, blocks)
// floats. The plan is ops/outlook_agg.py:outlook_agg_backward_plan's: tile
// rows, channel chunk, blocks (at most the tiles) and shared bytes.
// Returns cudaErrorInvalidValue for a plan or shape it does not take.
extern "C" int ogvt_outlook_agg_bwd_mma(
    const void* x, const void* a, const void* wv, const void* bv,
    const void* wp, const void* g, void* dx, void* da, void* dwv, void* dbv,
    void* dwp, void* dbp, void* ws, int B, int H, int W, int Cin, int C,
    int heads, int rows, int chunk, int fold, int dtype, int blocks,
    int smem, void* stream) {
  if (dtype != kBFloat16 || B < 1 || H < 1 ||
      !fits(W, Cin, C, heads, rows, chunk, fold) ||
      geom(W, Cin, C, heads, rows, chunk, fold).bytes != smem ||
      blocks < 1 ||
      blocks > static_cast<long long>(B) * ((H + rows - 1) / rows) ||
      !aligned16(x) || !aligned16(wp) || !aligned16(g) || !aligned16(dx) ||
      (fold && !aligned16(wv))) {
    return cudaErrorInvalidValue;
  }
  const Args r{static_cast<const bf16*>(x),  static_cast<const bf16*>(a),
               static_cast<const bf16*>(wv), static_cast<const bf16*>(bv),
               static_cast<const bf16*>(wp), static_cast<const bf16*>(g),
               static_cast<bf16*>(dx),       static_cast<bf16*>(da),
               dwv, dbv, dwp, dbp,           static_cast<float*>(ws),
               B, H, W, Cin, C, heads, rows, chunk, blocks};
  const int slots = geom(W, Cin, C, heads, rows, chunk, fold).slots;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return fold ? dispatch<true>(r, slots, smem, s)
              : dispatch<false>(r, slots, smem, s);
}
