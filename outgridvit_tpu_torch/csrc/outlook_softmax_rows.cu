// Fused outlook attention at K = 3, stride 1, in bf16: the softmax over
// each head's 9 tap logits fused with the taps,
//   a[p, h, t] = exp(l[p, h*9 + t] - max_t l) / sum_t exp(...)   (fp32)
//   y[p, c]    = round(sum_t a[p, head(c), t] * v[p + off_t, c])
// taps t = ky*3 + kx row-major, off_t = (ky - 1, kx - 1), zero v outside
// the image, the weights not renormalised.
//
// Replaces the TPU kernel outgridvit_tpu/ops/experimental/outlook_pallas.py:
// outlook_attention_pallas (#9: `_fwd_kernel`, pallas_call at :157) for the
// bf16 launches at K = 3 with a head width that is a multiple of 8 that its
// plan takes (ops/outlook_softmax.py:outlook_softmax_plan routes them
// here; fp32, K != 3 and other shapes keep csrc/outlook_softmax.cu). Its
// rounding points are that kernel's: the logits widened to fp32; the max,
// exp (expf under the package's NVCC_FLAGS, no fast-math), the sum over the
// taps in order (__fadd_rn) and one __fdiv_rn; the probabilities kept fp32;
// each output's taps summed in row-major order from +0, each product
// rounded apart (__fmul_rn, __fadd_rn); one cast at the end. Every output
// is its own ordered sum, and a tap outside the image adds the product of
// a zero v and a probability in [0, 1], +0, to a sum that is never -0: the
// outputs are bitwise those of csrc/outlook_softmax.cu, which skips such
// taps.
//
// What bounds it on the H100: bytes. Per pixel and channel 18 fp32
// operations of taps (mul and add apart) against 4 bytes (v read, out
// written; the logits add 36 * heads / C bytes a pixel), and 9 exps a
// pixel and head: at Model B's front (B = 64, 32x32x64, 2 heads) 19.1 MB,
// 5.7 us at 3.35 TB/s. The kernel it replaces reaches 6% of that: one
// thread a (pixel, channel), each of its 9 taps a 2-byte load from global
// memory (every v value fetched 9 times through L1 / L2) and 64-bit
// divisions per element.
//
// What the design does about it: persistent blocks of 256 threads (two an
// SM) walk tiles of R whole image rows of one image (t = blockIdx.x, +
// gridDim.x, ...). A tile's v rows, with a halo row above and below
// (zero-filled outside the image), come by 16-byte cp.async into a staged
// row with zero pixels at either end (outlook_softmax_layout.h), so that no
// tap tests a bound; its logits beside them (16, 4 or 2 bytes at a time,
// as their alignment allows). Two buffers: the next tile's copy is issued
// as the current tile starts and lands under its softmax and taps. Each
// (pixel, head) softmax is computed once into fp32 shared memory; then a
// thread takes one 8-channel chunk (16 bytes) of a run of P = 4 (or 2)
// adjacent pixels of one row: for each of the three tap rows it loads the
// P + 2 chunks once and applies each to the <= 3 outputs that use it (at
// P = 4, 18 shared loads of 16 bytes for 36 chunk-taps), and stores each
// output chunk as 16 bytes, consecutive threads on consecutive chunks. Every
// index comes from a walk advanced by the block's thread count: no
// division a tile beyond one per item for its head.
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"
#include "outlook_softmax_layout.h"

using namespace ogvt;
using namespace ogvt::osm_rows;

namespace {

using bf16 = __nv_bfloat16;

__host__ __device__ inline bool aligned_to(const void* p, int n) {
  return reinterpret_cast<uintptr_t>(p) % n == 0;
}

__device__ __forceinline__ void cp_async4(unsigned dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// Two digits (lo in [0, n), hi) of the items i = threadIdx.x,
// threadIdx.x + kThreads, ...: i = hi * n + lo, advanced without a
// division.
struct Walk {
  int lo, hi, dlo, dhi, n;
  __device__ explicit Walk(int n_)
      : lo(threadIdx.x % n_), hi(threadIdx.x / n_), dlo(kThreads % n_),
        dhi(kThreads / n_), n(n_) {}
  __device__ __forceinline__ void next() {
    lo += dlo;
    if (lo >= n) {
      lo -= n;
      ++hi;
    }
    hi += dhi;
  }
};

template <int P>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
outlook_softmax_rows(const bf16* __restrict__ v,
                     const bf16* __restrict__ logits, bf16* __restrict__ out,
                     int B, int H, int W, int C, int heads, int R) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Geom G = geom(W, C, heads, R, P);
  const unsigned base = smem_addr(smem);
  const int tid = threadIdx.x, h9 = G.h9, U = C / kChunk, C2 = 2 * C;
  const int hd8 = C / heads / kChunk, WP = G.WP, runs = G.runs;
  const int per = (H + R - 1) / R, ntiles = B * per;
  // the logits' copy width: 16 bytes where every tile's run of them starts
  // on a 16-byte boundary, else 4, else 2 through registers
  const int lw = (W * h9) % 8 == 0 && aligned_to(logits, 16)  ? 16
                 : (W * h9) % 2 == 0 && aligned_to(logits, 4) ? 4
                                                              : 2;

  // the zero pixels either end of every staged row of both buffers; the
  // staging writes only the image's pixels, so they stay zero
  {
    const int side = WP - W;  // pixel 0 and pixels W + 1 .. WP - 1
    for (int i = tid; i < 2 * (R + 2) * side * U; i += kThreads) {
      const int u = i % U, rest = i / U, px = rest % side, row = rest / side;
      *reinterpret_cast<uint4*>(smem + row * WP * C2 +
                                (px == 0 ? 0 : W + px) * C2 + u * 16) =
          make_uint4(0, 0, 0, 0);
    }
  }

  // tile tt into buffer bb: the v rows r0 - 1 .. r0 + nr of its image (the
  // rows outside it zero-filled), the logits of its nr rows; one cp.async
  // group
  auto stage = [&](int tt, int bb) {
    const int b = tt / per, r0 = (tt - b * per) * R, nr = min(R, H - r0);
    const long long row0 = static_cast<long long>(b) * H + r0;  // image row
    const int e_lo = r0 == 0 ? 1 : 0, e_hi = min(nr + 2, H - r0 + 1);
    const unsigned vb = base + (bb ? G.v1 : G.v0) + C2;
    for (Walk w(G.units); w.hi < nr + 2; w.next()) {
      const bool in = w.hi >= e_lo && w.hi < e_hi;
      cp_async16_zfill(vb + w.hi * WP * C2 + w.lo * 16,
                       in ? v + ((row0 + w.hi - 1) * W * U + w.lo) * kChunk
                          : v,
                       in ? 16 : 0);
    }
    const bf16* src = logits + row0 * W * h9;
    const int n = nr * W * h9;
    const unsigned lb = base + (bb ? G.l1 : G.l0);
    if (lw == 16) {
      for (int i = tid; i < n / 8; i += kThreads) {
        cp_async16(lb + i * 16, src + i * 8);
      }
    } else if (lw == 4) {
      for (int i = tid; i < n / 2; i += kThreads) {
        cp_async4(lb + i * 4, src + i * 2);
      }
    } else {
      bf16* dst = reinterpret_cast<bf16*>(smem + (bb ? G.l1 : G.l0));
      for (int i = tid; i < n; i += kThreads) dst[i] = src[i];
    }
    cp_async_commit();
  };

  // the thread's first tap item (chunk, run, row) and the step between its
  // items, kThreads on, as digits
  const int q0 = tid / U, dq = kThreads / U;
  const int u_0 = tid % U, k_0 = q0 % runs, r_0 = q0 / runs;
  const int du = kThreads % U, dk = dq % runs, dr = dq / runs;

  if (blockIdx.x < ntiles) stage(blockIdx.x, 0);
  float* pr = reinterpret_cast<float*>(smem + G.pr);
  int buf = 0;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x, buf ^= 1) {
    const int b = t / per, r0 = (t - b * per) * R, nr = min(R, H - r0);
    const long long pix0 = (static_cast<long long>(b) * H + r0) * W;
    cp_async_wait<0>();
    __syncthreads();  // the tile is staged; the previous tile's taps done
    if (t + gridDim.x < ntiles) stage(t + gridDim.x, buf ^ 1);

    // 1. each (pixel, head) softmax once, fp32, in tap order
    const bf16* sl = reinterpret_cast<const bf16*>(smem + (buf ? G.l1
                                                               : G.l0));
    for (int q = tid; q < nr * W * heads; q += kThreads) {
      const bf16* l = sl + q * kTaps;
      float e[kTaps];
      float m = to_f32(l[0]);
#pragma unroll
      for (int tp = 0; tp < kTaps; ++tp) {
        e[tp] = to_f32(l[tp]);
        m = fmaxf(m, e[tp]);
      }
      float s = 0.f;
#pragma unroll
      for (int tp = 0; tp < kTaps; ++tp) {
        e[tp] = expf(e[tp] - m);
        s = __fadd_rn(s, e[tp]);
      }
#pragma unroll
      for (int tp = 0; tp < kTaps; ++tp) {
        pr[q * kTaps + tp] = __fdiv_rn(e[tp], s);
      }
    }
    __syncthreads();

    // 2. the taps: a thread an item (row r, run k of P pixels, chunk u), u
    // fastest, the block's items walked from the thread's first
    const unsigned char* vs = smem + (buf ? G.v1 : G.v0);
    for (int u = u_0, k = k_0, r = r_0; r < nr;) {
      const int h = u / hd8;
      const int s0 = r * W + k * P;  // the run's first pixel in the tile
      const float* a = pr + s0 * h9 + h * kTaps;
      const unsigned char* vr = vs + (r * WP + k * P) * C2 + u * 16;
      float acc[P][kChunk];
#pragma unroll
      for (int i = 0; i < P; ++i) {
#pragma unroll
        for (int c = 0; c < kChunk; ++c) acc[i][c] = 0.f;
      }
      // one tap row at a time (unrolled, the three rows' loads were hoisted
      // together and spilled at the register cap)
#pragma unroll 1
      for (int ky = 0; ky < 3; ++ky) {
        float w[P][3];
#pragma unroll
        for (int i = 0; i < P; ++i) {
#pragma unroll
          for (int kx = 0; kx < 3; ++kx) w[i][kx] = a[i * h9 + ky * 3 + kx];
        }
        const unsigned char* row = vr + ky * WP * C2;
#pragma unroll
        for (int j = 0; j < P + 2; ++j) {
          const uint4 q = *reinterpret_cast<const uint4*>(row + j * C2);
          const unsigned qs[4] = {q.x, q.y, q.z, q.w};
          float x[kChunk];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            x[2 * c] = __uint_as_float(qs[c] << 16);
            x[2 * c + 1] = __uint_as_float(qs[c] & 0xffff0000u);
          }
          // chunk j is tap kx = j - i of output i; each output meets its
          // kx in order
#pragma unroll
          for (int i = 0; i < P; ++i) {
            const int kx = j - i;
            if (kx < 0 || kx > 2) continue;
#pragma unroll
            for (int c = 0; c < kChunk; ++c) {
              acc[i][c] = __fadd_rn(acc[i][c], __fmul_rn(x[c], w[i][kx]));
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < P; ++i) {
        if (k * P + i >= W) break;  // past the row: a ragged run's slack
        uint4 o;
        o.x = as_u32(__floats2bfloat162_rn(acc[i][0], acc[i][1]));
        o.y = as_u32(__floats2bfloat162_rn(acc[i][2], acc[i][3]));
        o.z = as_u32(__floats2bfloat162_rn(acc[i][4], acc[i][5]));
        o.w = as_u32(__floats2bfloat162_rn(acc[i][6], acc[i][7]));
        *reinterpret_cast<uint4*>(out + (pix0 + s0 + i) * C + u * kChunk) =
            o;
      }
      u += du;  // the next item: kThreads on, carried through the digits
      int carry = 0;
      if (u >= U) {
        u -= U;
        carry = 1;
      }
      k += dk + carry;
      if (k >= runs) {
        k -= runs;
        ++r;
      }
      r += dr;
    }
  }
}

template <int P>
cudaError_t launch(const bf16* v, const bf16* logits, bf16* out, int B,
                   int H, int W, int C, int heads, int rows, int blocks,
                   int smem, cudaStream_t s) {
  auto kernel = outlook_softmax_rows<P>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kThreads, smem, s>>>(v, logits, out, B, H, W, C, heads,
                                        rows);
  return cudaGetLastError();
}

}  // namespace

// v [B, H, W, C], logits [B, H, W, heads*9], out [B, H, W, C]: contiguous
// bf16 (dtype must be 1), v and out 16-byte aligned. The plan is
// ops/outlook_softmax.py:outlook_softmax_plan's: tile rows, run pixels,
// blocks (at most the tiles) and shared bytes. Returns
// cudaErrorInvalidValue for a plan or shape it does not take.
extern "C" int ogvt_outlook_softmax_rows(const void* v, const void* logits,
                                         void* out, int B, int H, int W,
                                         int C, int heads, int rows, int pix,
                                         int dtype, int blocks, int smem,
                                         void* stream) {
  if (dtype != kBFloat16 || B < 1 || H < 1 ||
      !fits(W, C, heads, rows, pix) ||
      geom(W, C, heads, rows, pix).bytes != smem || blocks < 1 ||
      blocks > static_cast<long long>(B) * ((H + rows - 1) / rows) ||
      !aligned_to(v, 16) || !aligned_to(out, 16)) {
    return cudaErrorInvalidValue;
  }
  const bf16 *pv = static_cast<const bf16*>(v),
             *pl = static_cast<const bf16*>(logits);
  bf16* po = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return pix == 2
             ? launch<2>(pv, pl, po, B, H, W, C, heads, rows, blocks, smem, s)
             : launch<4>(pv, pl, po, B, H, W, C, heads, rows, blocks, smem,
                         s);
}
