// Device code shared by the fused outlook projection's bf16 tensor-core
// kernels, the backward (csrc/outlook_agg_bwd_mma.cu) and the forward
// (csrc/outlook_agg_fwd_mma.cu): 16-byte cp.async staging of whole image
// rows with a halo (zero-filled outside the image), the product v = x.Wv +
// bv (and the backward's dyag = g.Wp^T) on mma.sync into fp32 rows padded
// with a zero pixel either side, and the exact fp32 taps of y. One copy, so
// the backward's recompute forms the forward's v and y. The layouts are
// outlook_agg_mma_layout.h's (Geom, FwdGeom).
#pragma once

#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"
#include "outlook_agg_mma_layout.h"

namespace ogvt {
namespace outlook_mma {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ unsigned pack2(float lo, float hi) {
  return as_u32(__floats2bfloat162_rn(lo, hi));
}

// The entry points' check of a pointer that is copied 16 bytes at a time.
inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// n / d by a multiply for 0 <= n, d < 2^16 (the layout keeps every
// quotient the taps take there): m = ceil(2^32 / d), exact below 2^32 / d.
struct FastDiv {
  unsigned m;
  int d;
  __device__ explicit FastDiv(int d_) : m(0xffffffffu / d_ + 1u), d(d_) {}
  __device__ __forceinline__ int div(int n) const {
    return d == 1 ? n : static_cast<int>(__umulhi(n, m));
  }
};

// Staged rows [lo, hi) of the n rows at shared address `tile` (rowb bytes
// apart) from rows first + e of the [*, cols] bf16 matrix `src`; the other
// rows zero-filled (src is then not read).
__device__ __forceinline__ void stage_rows(unsigned tile, const bf16* src,
                                           long long first, int lo, int hi,
                                           int n, int cols, int rowb) {
  // item i = e * units + u, walked without a division: i advances by
  // kThreads, i.e. de rows and du units
  const int units = cols / 8, de = kThreads / units, du = kThreads % units;
  int e = threadIdx.x / units, u = threadIdx.x % units;
  for (; e < n; e += de, u += du) {
    if (u >= units) {
      u -= units;
      ++e;
      if (e >= n) break;
    }
    const bool in = e >= lo && e < hi;
    cp_async16_zfill(tile + e * rowb + u * 16,
                     in ? src + (first + e) * cols + u * 8 : src,
                     in ? 16 : 0);
  }
}

// Whether the tap weights a [*, h9] can come 4 bytes at a time: every run
// of them staged starts at a multiple of W pixels, so W * h9 even and a
// 4-byte aligned.
__device__ __forceinline__ bool pairs_ok(const bf16* a, int W, int h9) {
  return (W * h9) % 2 == 0 && reinterpret_cast<uintptr_t>(a) % 4 == 0;
}

// Rows [lo, hi) of `rows` rows of `cols` bf16 at `src` (row 0 at src
// row `first`) into the rows at `dst`, the other rows zero-filled: 4 bytes
// at a time by cp.async where rows of `cols` bf16 keep 4-byte alignment
// (`pairs`: pairs_ok), else 2 at a time through registers.
__device__ __forceinline__ void stage_flat(bf16* dst, const bf16* src,
                                          long long first, int lo, int hi,
                                          int rows, int cols, bool pairs) {
  const int n0 = lo * cols, n = (hi - lo) * cols;
  for (int i = threadIdx.x; i < n0; i += kThreads) {
    dst[i] = __float2bfloat16(0.f);
  }
  for (int i = n0 + n + threadIdx.x; i < rows * cols; i += kThreads) {
    dst[i] = __float2bfloat16(0.f);
  }
  const bf16* s0 = src + (first + lo) * cols;
  bf16* d0 = dst + n0;
  if (pairs) {
    for (int i = threadIdx.x; i < n / 2; i += kThreads) {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                       smem_addr(d0 + 2 * i)),
                   "l"(s0 + 2 * i)
                   : "memory");
    }
  } else {
    for (int i = threadIdx.x; i < n; i += kThreads) d0[i] = s0[i];
  }
}

// Ask L2 for the bytes [p, p + n), one 128-byte line a thread at a time.
__device__ __forceinline__ void prefetch_l2(const void* p, long long n) {
  const char* c = static_cast<const char*>(p);
  for (long long i = threadIdx.x * 128ll; i < n; i += kThreads * 128ll) {
    asm volatile("prefetch.global.L2 [%0];\n" ::"l"(c + i));
  }
}

// acc += A.B for 16 rows and 16 * NG columns: A [16, K] row-major at shared
// address a0 (rows rowA bytes apart); B [K, 16 * NG] from a staged matrix
// at b0, kBT: row-major [K, n] (ldmatrix.trans), else its transpose [n, K]
// (ldmatrix). acc[i]: the m16n8 tile of columns 8i..8i+7; A's fragments
// serve all NG column groups.
template <bool kBT, int NG>
__device__ __forceinline__ void mma_rows(unsigned a0, int rowA, unsigned b0,
                                         int rowB, int K,
                                         float (&acc)[2 * NG][4]) {
  const int lane = threadIdx.x % 32, lr = lane % 8, lm = lane / 8;
  const unsigned a_ln = a0 + (lr + (lm & 1) * 8) * rowA + (lm >> 1) * 16;
  const unsigned b_ln =
      kBT ? b0 + (lr + (lm & 1) * 8) * rowB + (lm >> 1) * 16
          : b0 + (lr + (lm >> 1) * 8) * rowB + (lm & 1) * 16;
#pragma unroll 2
  for (int k = 0; k < K / 16; ++k) {
    unsigned af[4];
    ldsm_x4(a_ln + k * 32, af);
#pragma unroll
    for (int gi = 0; gi < NG; ++gi) {
      unsigned bf[4];
      if (kBT) {
        ldsm_x4_t(b_ln + k * 16 * rowB + gi * 32, bf);
      } else {
        ldsm_x4(b_ln + gi * 16 * rowB + k * 32, bf);
      }
      mma_k16(acc[2 * gi], af, bf[0], bf[1]);
      mma_k16(acc[2 * gi + 1], af, bf[2], bf[3]);
    }
  }
}

// The products of the chunk's channels [c0, c0 + CH) at every staged pixel
// into the padded fp32 rows, 0 outside the image; a warp an (m16, 16 * NG
// columns) unit. kDyag: dyag = g.Wp^T into s_d (the backward's units,
// first); kFold: v = x.Wv + bv into s_v. G: a Geom or a FwdGeom (kDyag: a
// Geom).
template <bool kFold, bool kDyag, int NG, class Geo>
__device__ __forceinline__ void products(const Geo& G, unsigned base,
                                         float* s_v, float* s_d,
                                         const bf16* __restrict__ bv, int c0,
                                         int CH, int Cin, int C, int W,
                                         int e_lo, int e_hi,
                                         const FastDiv& divW) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, tq = lane % 4, ldv = G.ldv, WP = W + 2;
  const int ng = CH / (16 * NG), units = (G.NE / 16) * ng;
  const int nd = kDyag ? units : 0;  // the dyag units come first
  for (int u = warp; u < nd + (kFold ? units : 0); u += kWarps) {
    const bool is_v = kFold && u >= nd;
    const int uu = is_v ? u - nd : u;
    const int m0 = (uu / ng) * 16, n0 = c0 + (uu % ng) * 16 * NG;
    // v's bias of the lane's columns (0 for dyag), read before the product
    // so that its latency hides behind it
    float bias[2 * NG][2] = {};
    if (is_v) {
#pragma unroll
      for (int n = 0; n < 2 * NG; ++n) {
        bias[n][0] = to_f32(bv[n0 + 8 * n + 2 * tq]);
        bias[n][1] = to_f32(bv[n0 + 8 * n + 2 * tq + 1]);
      }
    }
    float acc[2 * NG][4] = {};
    if (is_v) {
      mma_rows<true, NG>(base + G.xs + m0 * G.rowX, G.rowX,
                         base + G.wv + n0 * 2, G.rowC, Cin, acc);
    } else if constexpr (kDyag) {
      mma_rows<false, NG>(base + G.gs + m0 * G.rowC, G.rowC,
                          base + G.wp + n0 * G.rowC, G.rowC, C, acc);
    }
    float* dst = is_v ? s_v : s_d;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int e = m0 + gq + 8 * hh;
      if (e >= G.ext) continue;
      const bool in = e >= e_lo && e < e_hi;
      const int r = divW.div(e);
      float* row = dst + (r * WP + e - r * W + 1) * ldv;
#pragma unroll
      for (int n = 0; n < 2 * NG; ++n) {
        const int cl = n0 - c0 + 8 * n + 2 * tq;
        *reinterpret_cast<float2*>(row + cl) =
            in ? make_float2(acc[n][2 * hh] + bias[n][0],
                             acc[n][2 * hh + 1] + bias[n][1])
               : make_float2(0.f, 0.f);
      }
    }
  }
}

// Without the fold: the staged bf16 v of the chunk's channels [c0, c0 + CH)
// at every ext pixel into the padded fp32 rows (exact; the zero-filled rows
// outside the image give 0); a warp a row, a lane two channels at a time.
template <class Geo>
__device__ __forceinline__ void values_f32(const Geo& G,
                                           const unsigned char* smem,
                                           float* s_v, int c0, int CH, int W,
                                           const FastDiv& divW) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int e = warp; e < G.ext; e += kWarps) {
    const __nv_bfloat162* xr = reinterpret_cast<const __nv_bfloat162*>(
        smem + G.xs + e * G.rowX + c0 * 2);
    const int r = divW.div(e);
    float* row = s_v + (r * (W + 2) + e - r * W + 1) * G.ldv;
    for (int c = lane; c < CH / 2; c += 32) {
      *reinterpret_cast<float2*>(row + 2 * c) = __bfloat1622float2(xr[c]);
    }
  }
}

// y of the four channels c..c+3 of one pixel: vrow its v in the padded
// fp32 rows (tstride floats a padded row, ldv a pixel; a neighbour in a
// padding column reads 0), w its tap weights; the taps in order t = 0..8,
// each product rounded apart (__fmul_rn, __fadd_rn: no contraction), as the
// plain version sums them. kDa (the backward): also dac[t] += v[p + off_t]
// . dyag over the four channels, one fmaf a channel in order, d0 / d1 the
// pixel's dyag of them.
template <bool kDa>
__device__ __forceinline__ void taps4(const float* vrow, int tstride,
                                      int ldv, const float (&w)[kTaps],
                                      float2 d0, float2 d1,
                                      float (&dac)[kTaps], float (&y)[4]) {
  y[0] = y[1] = y[2] = y[3] = 0.f;
#pragma unroll
  for (int tp = 0; tp < kTaps; ++tp) {
    const float* vp = vrow + (tp / 3 - 1) * tstride + (tp % 3 - 1) * ldv;
    const float2 va = *reinterpret_cast<const float2*>(vp);
    const float2 vb = *reinterpret_cast<const float2*>(vp + 2);
    y[0] = __fadd_rn(y[0], __fmul_rn(va.x, w[tp]));
    y[1] = __fadd_rn(y[1], __fmul_rn(va.y, w[tp]));
    y[2] = __fadd_rn(y[2], __fmul_rn(vb.x, w[tp]));
    y[3] = __fadd_rn(y[3], __fmul_rn(vb.y, w[tp]));
    if (kDa) {
      dac[tp] = fmaf(vb.y, d1.y,
                     fmaf(vb.x, d1.x, fmaf(va.y, d0.y, fmaf(va.x, d0.x,
                                                             dac[tp]))));
    }
  }
}

}  // namespace outlook_mma
}  // namespace ogvt
