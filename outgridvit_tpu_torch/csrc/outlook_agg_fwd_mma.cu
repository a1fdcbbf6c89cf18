// Forward of the fused outlook projection in bf16, its products on mma.sync
// tensor-core tiles:
//   #7  out = aggregate(v, a).Wp + bp
//   #8  out = aggregate(x.Wv + bv, a).Wp + bp   (the fold)
//
// Replaces the TPU kernels outgridvit_tpu/ops/experimental/
// outlook_agg_pallas.py: outlook_attention_proj_pallas (#7, `_fwd_kernel`,
// `_fwd_chunk_kernel`) and outlook_branch_pallas (#8, `_fwdv_kernel`,
// `_fwdv_chunk_kernel`), forward half, for bf16 launches that its plan
// takes (ops/outlook_agg.py:outlook_agg_forward_plan routes them here;
// fp32 and other shapes keep csrc/outlook_agg.cu). The math and rounding
// points are that kernel's (csrc/outlook_agg.cu's docstring): with the
// fold v = x.Wv + bv in fp32, never rounded (without it v is given, bf16,
// and widened exactly); y = round(sum_t v[p + off_t] * w_t), zero v
// outside the image; out = round(y.Wp + bp). The operands of the two
// products (x, Wv; y, Wp) are bf16 values at those rounding points, so
// mma.sync.m16n8k16 with bf16 operands and fp32 accumulators forms each
// product exactly and sums it in fp32: only the order of the fp32 sums
// differs from the plain version. The taps stay fp32 on the FMA pipe in the
// plain version's order, each product rounded apart.
//
// What bounds it on the H100: bytes (x or v and a read, out written; at C
// = 64 the products are ~43 flop a byte, far below the tensor cores' ~295,
// and the taps ~9 fp32 flop a byte). The FMA kernel it replaces ran both
// products on the fp32 pipe at a ninth of its peak, staged every input one
// scalar at a time with a division per element, and took one thread a
// (pixel, channel) with a column test per tap.
//
// What the design does about it: the backward's (csrc/outlook_agg_bwd_mma.cu)
// layout and code without its gradients. A block of 16 warps (one an SM)
// walks tiles of R whole image rows of one image (t = blockIdx.x, +
// gridDim.x, ...). A tile's x (or v) comes by 16-byte cp.async for its rows
// and one halo row above and below (rows outside the image zero-filled: zero
// v, not bv), its tap weights a for its own rows; Wp and Wv stay resident.
// Per chunk of CH channels:
//   1. v = x.Wv + bv at every staged pixel on mma.sync (without the fold,
//      the bf16 v widened), into fp32 rows padded with a zero pixel either
//      side, so that the taps need no column test; 0 outside the image;
//   2. y, one thread a (tile pixel, head of the chunk, part of its
//      channels), four channels at a time, into a bf16 tile.
// Then out = y.Wp + bp on mma.sync, rounded once into a bf16 tile over the
// (now free) v rows, and out by coalesced 16-byte stores. The next tile's
// rows are prefetched into L2 as a tile starts; its x is staged as soon as
// the last chunk's v is formed, its a once the taps have read this tile's,
// under the taps, y.Wp and the stores. Staged bf16 rows are an odd number
// of 16-byte units apart (row_bytes). The staging, the v product and the
// taps are outlook_agg_mma.cuh's, shared with the backward; the layout is
// outlook_agg_mma_layout.h's fwd_geom, and the entry point refuses any
// plan it does not match.
#include "outlook_agg_mma.cuh"

using namespace ogvt;
using namespace ogvt::outlook_mma;

namespace {

// out = round(y.Wp + bp) of the tile's SP rows into the out tile os (bf16,
// rows rowC bytes apart): a warp an (m16, 16 * NG columns) unit, the bias
// added to the fp32 sum before the one rounding. Rows past the tile's
// pixels come from y rows the taps did not write and are never stored.
template <int NG>
__device__ __forceinline__ void out_rows(const FwdGeom& G, unsigned base,
                                         unsigned char* smem,
                                         const bf16* __restrict__ bp,
                                         int C) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, tq = lane % 4, ng = C / (16 * NG);
  for (int u = warp; u < (G.SP / 16) * ng; u += kWarps) {
    const int m0 = (u / ng) * 16, n0 = (u % ng) * 16 * NG;
    // the bias of the lane's columns, read before the product so that its
    // latency hides behind it
    float bias[2 * NG][2];
#pragma unroll
    for (int n = 0; n < 2 * NG; ++n) {
      bias[n][0] = to_f32(bp[n0 + 8 * n + 2 * tq]);
      bias[n][1] = to_f32(bp[n0 + 8 * n + 2 * tq + 1]);
    }
    float acc[2 * NG][4] = {};
    mma_rows<true, NG>(base + G.ys + m0 * G.rowC, G.rowC,
                       base + G.wp + n0 * 2, G.rowC, C, acc);
#pragma unroll
    for (int n = 0; n < 2 * NG; ++n) {
      const int col = n0 + 8 * n + 2 * tq;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        *reinterpret_cast<unsigned*>(smem + G.os +
                                     (m0 + gq + 8 * hh) * G.rowC + col * 2) =
            pack2(acc[n][2 * hh] + bias[n][0],
                  acc[n][2 * hh + 1] + bias[n][1]);
      }
    }
  }
}

template <bool kFold>
__global__ void __launch_bounds__(kThreads, 1)
outlook_fwd_mma(const bf16* __restrict__ x, const bf16* __restrict__ a,
                const bf16* __restrict__ wv, const bf16* __restrict__ bv,
                const bf16* __restrict__ wp, const bf16* __restrict__ bp,
                bf16* __restrict__ out, int B, int H, int W, int Cin, int C,
                int heads, int R, int CH) {
  extern __shared__ __align__(16) unsigned char smem[];
  const FwdGeom G = fwd_geom(W, Cin, C, heads, R, CH, kFold);
  const unsigned base = smem_addr(smem);
  const int tid = threadIdx.x;
  const int hd = G.hd, h9 = G.h9, ldv = G.ldv, WP = W + 2;
  bf16* s_a = reinterpret_cast<bf16*>(smem + G.as);
  const bool a_pairs = pairs_ok(a, W, h9);
  float* s_v = reinterpret_cast<float*>(smem + G.vf);

  stage_rows(base + G.wp, wp, 0, 0, C, C, C, G.rowC);
  if (kFold) stage_rows(base + G.wv, wv, 0, 0, Cin, Cin, C, G.rowC);
  cp_async_commit();

  const FastDiv divW(W), divSP(G.SP);
  const int lnp = __ffs(G.np) - 1;  // np is a power of 2
  const int per = (H + R - 1) / R, ntiles = B * per;
  // tile tt's rows: x (or v) of its R rows and the halo rows, the rows
  // outside the image zero-filled; the tap weights of its own rows
  auto first_of = [&](int tt, int& rr) {
    const int bb = tt / per;
    rr = (tt - bb * per) * R;
    return (static_cast<long long>(bb) * H + rr - 1) * W;
  };
  auto stage_x = [&](int tt) {
    int rr;
    const long long f = first_of(tt, rr);
    stage_rows(base + G.xs, x, f, rr == 0 ? W : 0,
               min(R + 2, H - rr + 1) * W, G.NE, Cin, G.rowX);
    cp_async_commit();
  };
  auto stage_a = [&](int tt) {
    int rr;
    const long long f = first_of(tt, rr);
    stage_flat(s_a, a, f + W, 0, min(R, H - rr) * W, G.S, h9, a_pairs);
    cp_async_commit();
  };
  if (blockIdx.x < ntiles) {
    stage_x(blockIdx.x);
    stage_a(blockIdx.x);
  }
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int b = t / per, r0 = (t - b * per) * R, nr = min(R, H - r0);
    const long long pix0 = (static_cast<long long>(b) * H + r0) * W;
    const int Sv = nr * W;  // the tile's pixels
    // the staged pixels inside the image
    const int e_lo = r0 == 0 ? W : 0, e_hi = min(R + 2, H - r0 + 1) * W;
    const int tn = t + gridDim.x;
    if (tn < ntiles) {  // the next tile's rows into L2
      int rn;
      const long long fn = first_of(tn, rn);
      const int lo = rn == 0 ? W : 0, hi = min(R + 2, H - rn + 1) * W;
      prefetch_l2(x + (fn + lo) * Cin, 2ll * (hi - lo) * Cin);
      prefetch_l2(a + (fn + W) * h9, 2ll * min(R, H - rn) * W * h9);
    }
    cp_async_wait<0>();
    __syncthreads();

    for (int c0 = 0; c0 < C; c0 += CH) {
      // 1. v of the chunk's channels at every staged pixel, fp32, 0 outside
      // the image. The out rows of the tile before overwrote the zero
      // pixels either side of each row: restored beside the products, which
      // write only the image's columns.
      if (c0 == 0) {
        for (int i = tid; i < (R + 2) * 2 * ldv; i += kThreads) {
          const int side = i / ldv, r = side / 2;
          s_v[(r * WP + (side % 2) * (W + 1)) * ldv + i % ldv] = 0.f;
        }
      }
      if (!kFold) {
        values_f32(G, smem, s_v, c0, CH, W, divW);
      } else if (CH % 32 == 0) {
        products<true, false, 2>(G, base, s_v, nullptr, bv, c0, CH, Cin, C,
                                 W, e_lo, e_hi, divW);
      } else {
        products<true, false, 1>(G, base, s_v, nullptr, bv, c0, CH, Cin, C,
                                 W, e_lo, e_hi, divW);
      }
      __syncthreads();
      // x is free after the last chunk's v: the next tile's comes in under
      // the taps, y.Wp and the stores
      if (c0 + CH == C && tn < ntiles) stage_x(tn);

      // 2. y, a thread a (tile pixel, head of the chunk, part of its
      // channels); the parts of a pixel's head in neighbouring lanes
      const int hc = CH / hd, h0 = c0 / hd, np = G.np, cp = hd / np;
      const int items = G.SP * hc * np;
      for (int i = tid; i < items; i += kThreads) {
        const int part = i & (np - 1), rest = i >> lnp;
        const int hl = divSP.div(rest), s = rest - hl * G.SP, h = h0 + hl;
        if (s >= Sv) continue;  // a padding row of the tile: never stored
        const int cl0 = hl * hd + part * cp, r = divW.div(s);
        float w[kTaps], unused[kTaps];
#pragma unroll
        for (int tp = 0; tp < kTaps; ++tp) {
          w[tp] = to_f32(s_a[s * h9 + h * kTaps + tp]);
        }
        const float* vrow = s_v + ((r + 1) * WP + s - r * W + 1) * ldv + cl0;
        unsigned* yrow =
            reinterpret_cast<unsigned*>(smem + G.ys + s * G.rowC) +
            (c0 + cl0) / 2;
        for (int c = 0; c < cp; c += 4) {
          float y[4];
          taps4<false>(vrow + c, WP * ldv, ldv, w, float2{}, float2{}, unused,
                       y);
          yrow[c / 2] = pack2(y[0], y[1]);
          yrow[c / 2 + 1] = pack2(y[2], y[3]);
        }
      }
      __syncthreads();  // before the next chunk's v, or out, overwrite v
    }
    if (tn < ntiles) stage_a(tn);  // the taps have read a

    // 3. out = y.Wp + bp on mma.sync, rounded once, into the out tile over
    // the v rows
    if (C % 32 == 0) {
      out_rows<2>(G, base, smem, bp, C);
    } else {
      out_rows<1>(G, base, smem, bp, C);
    }
    __syncthreads();
    // 4. out by coalesced 16-byte stores; the next tile's barrier keeps its
    // v from the out tile until they are done
    {
      const int units = C / 8;
      for (int i = tid; i < Sv * units; i += kThreads) {
        const int s = i / units, u = i - s * units;
        *reinterpret_cast<uint4*>(out + (pix0 + s) * C + u * 8) =
            *reinterpret_cast<const uint4*>(smem + G.os + s * G.rowC +
                                            u * 16);
      }
    }
  }
  cp_async_wait<0>();  // a block with no tile still drains its weights
}

template <bool kFold>
cudaError_t launch(const bf16* x, const bf16* a, const bf16* wv,
                   const bf16* bv, const bf16* wp, const bf16* bp, bf16* out,
                   int B, int H, int W, int Cin, int C, int heads, int rows,
                   int chunk, int blocks, int smem, cudaStream_t s) {
  auto kernel = outlook_fwd_mma<kFold>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kThreads, smem, s>>>(x, a, wv, bv, wp, bp, out, B, H, W,
                                        Cin, C, heads, rows, chunk);
  return cudaGetLastError();
}

}  // namespace

// Inputs and output as ogvt_outlook_agg's (x [B, H, W, Cin], v when fold
// == 0; a [B, H, W, heads*9]; wv [Cin, C], bv [C], null without the fold;
// wp [C, C], bp [C]; out [B, H, W, C]), contiguous bf16 (dtype must be 1),
// x, wv, wp and out 16-byte aligned. The plan is
// ops/outlook_agg.py:outlook_agg_forward_plan's: tile rows, channel chunk,
// blocks (at most the tiles) and shared bytes. Returns cudaErrorInvalidValue
// for a plan or shape it does not take.
extern "C" int ogvt_outlook_agg_fwd_mma(const void* x, const void* a,
                                        const void* wv, const void* bv,
                                        const void* wp, const void* bp,
                                        void* out, int B, int H, int W,
                                        int Cin, int C, int heads, int rows,
                                        int chunk, int fold, int dtype,
                                        int blocks, int smem, void* stream) {
  if (dtype != kBFloat16 || B < 1 || H < 1 ||
      !fwd_fits(W, Cin, C, heads, rows, chunk, fold) ||
      fwd_geom(W, Cin, C, heads, rows, chunk, fold).bytes != smem ||
      blocks < 1 ||
      blocks > static_cast<long long>(B) * ((H + rows - 1) / rows) ||
      !aligned16(x) || !aligned16(wp) || !aligned16(out) ||
      (fold && !aligned16(wv))) {
    return cudaErrorInvalidValue;
  }
  const bf16 *px = static_cast<const bf16*>(x),
             *pa = static_cast<const bf16*>(a),
             *pwv = static_cast<const bf16*>(wv),
             *pbv = static_cast<const bf16*>(bv),
             *pwp = static_cast<const bf16*>(wp),
             *pbp = static_cast<const bf16*>(bp);
  bf16* po = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return fold ? launch<true>(px, pa, pwv, pbv, pwp, pbp, po, B, H, W, Cin, C,
                             heads, rows, chunk, blocks, smem, s)
              : launch<false>(px, pa, pwv, pbv, pwp, pbp, po, B, H, W, Cin,
                              C, heads, rows, chunk, blocks, smem, s);
}
