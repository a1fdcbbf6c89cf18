// Forward of the fused pre-LN channel-MLP branch y = fc2(act(fc1(LN(x))))
// in bf16, with both products on mma.sync tensor-core tiles.
//
// Replaces the TPU kernels outgridvit_tpu/ops/mlp_branch_pallas_t.py:
// mlp_branch_pallas_t (#2) and outgridvit_tpu/ops/mlp_branch_pallas.py:
// mlp_branch_pallas (#4), forward half (`_fwd_kernel`), for bf16 launches
// whose C and H are multiples of 16 (ops/mlp_branch.py routes them here;
// fp32 and other shapes keep csrc/mlp_branch.cu). The rounding points are
// that kernel's: xn = round(LN(x)) with fp32 statistics (fast variance
// clamped at 0), h = round(xn.w1 + b1), a = round(act(h)) with act in fp32,
// y = round(a.w2 + b2), both products summed in fp32. Every operand of the
// two products (xn, w1, a, w2) is a bf16 value at one of these points, so
// mma.sync.m16n8k16 with bf16 operands and fp32 accumulators forms each
// product exactly: only the order of the fp32 sums differs from the plain
// version.
//
// What bounds it on the H100: the two products, 4*C*H flops a token at the
// bf16 tensor-core peak, against 4*C bytes of activations (x in, y out);
// at C <= 96 the activation epilogue (an erf or an exp a (token, unit), some
// 30 instructions on the fp32 pipe) costs more than the products.
//
// What the design does about it. A block of 8 warps walks a contiguous run
// of token tiles (about one wave of blocks). S warps share one m16 row tile
// (the plan's split: 1, 2, 4 or 8), so a tile is TM = 128 / S tokens. Per
// tile: x staged as bf16 by cp.async (rows past M zero-filled) while the
// previous tile computes, LN in fp32 from the staged bf16 written back in
// place as xn (the A operand; each warp normalizes its share of its row
// tile, so at S = 1 no block barrier waits for it);
// then H in chunks. w1 and w2 stay in their
// natural layouts, [C, H] and [H, C]: ldmatrix.trans gives the B operand of
// both products. Where w1 and w2 fit beside the two x tiles (NB = 0: the
// stage-0 shapes, C <= 96, with by far the most tokens) a block stages them
// once for all its tiles; elsewhere it stages w1[:, chunk] and w2[chunk, :]
// per chunk (NB buffers). Per chunk each warp computes h for its units on
// mma, rounds h + b1, applies act and rounds in registers. At S = 1 the
// rounded accumulators of two m16n8 tiles, packed as bf16 pairs, are the A
// fragment of y += a.w2[chunk, :] as they stand (as FlashAttention-2 reuses
// P for P.V); at S > 1 the warps of a row tile swap a through shared memory
// and each sums y for C / S columns over the whole chunk. y stays in fp32
// registers (at most 128 columns a warp), then y + b2, rounded, leaves
// through the tile's x buffer by 16-byte stores. Rows past M are never
// written. The launch plan (split, buffers, blocks, shared bytes) is
// ops/mlp_branch.py:mlp_branch_forward_plan, made from the layout query of
// mlp_branch_mma_layout.cpp over mlp_branch_mma_layout.h, which this kernel
// includes too; the entry point refuses any plan it does not match.
#include <stdint.h>

#include "act.cuh"
#include "common.cuh"
#include "mlp_branch_mma.cuh"
#include "mlp_branch_mma_layout.h"
#include "mma.cuh"

using namespace ogvt;
using namespace ogvt::mlp_mma;

namespace {

using bf16 = __nv_bfloat16;

// a = act(round(h + b1)) of one (token, hidden unit), from the fp32 sum
// h = xn.w1, in fp32 (rounded to bf16 as it is packed).
template <int ACT>
__device__ __forceinline__ float epilogue_a(float h, float b1) {
  return act_f32<ACT>(round_bf16(h + b1));
}

// The a of one m16n8 tile of h whose lane holds units j, j + 1 (0 from H
// on) as bf16 pairs: lo of row gq, hi of row gq + 8.
template <int ACT>
__device__ __forceinline__ void act_tile(const float (&h)[4],
                                         const bf16* __restrict__ b1, int j,
                                         int H, unsigned& lo, unsigned& hi) {
  if (j < H) {
    const float bj0 = to_f32(b1[j]), bj1 = to_f32(b1[j + 1]);
    lo = pack_bf16(epilogue_a<ACT>(h[0], bj0), epilogue_a<ACT>(h[1], bj1));
    hi = pack_bf16(epilogue_a<ACT>(h[2], bj0), epilogue_a<ACT>(h[3], bj1));
  } else {
    lo = hi = 0u;
  }
}

template <int ACT, int NTY>
__global__ void __launch_bounds__(kThreads, fwd_blocks(NTY, ACT == kSilu))
mlp_fwd_kernel(const bf16* __restrict__ x, const float* __restrict__ ls,
               const float* __restrict__ lb, const bf16* __restrict__ w1,
               const bf16* __restrict__ b1, const bf16* __restrict__ w2,
               const bf16* __restrict__ b2, bf16* __restrict__ y, int M,
               int C, int H, int S, int NB, float eps, int apply_ln) {
  extern __shared__ __align__(16) unsigned char smem[];
  const FwdGeom g = fwd_geom(C, H, S, NB);
  const unsigned base = smem_addr(smem);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;  // fragment row, column pair
  const int lr = lane % 8, lm = lane / 8;  // ldmatrix row, matrix
  const int rt = warp / S, cs = warp - rt * S;
  const int r0 = 16 * rt;        // the warp's first row in a tile
  const int c0 = cs * (C / S);   // its first y column
  const bool resident = NB == 0;
  const int rowW1 = resident ? g.rowH : g.rowK;  // between staged w1 rows
  const int ntiles = (M + g.TM - 1) / g.TM;
  const int per = (ntiles + gridDim.x - 1) / gridDim.x;
  const int t0 = blockIdx.x * per, t1 = min(t0 + per, ntiles);
  const int nch = (H + g.chunk - 1) / g.chunk;
  if (t0 >= t1) return;

  // ldmatrix lane offsets: A of the warp's rows in an x tile; B of fc1
  // (w1, .trans, the warp's units of a chunk) and of fc2 (w2, .trans, the
  // warp's columns); A of a in the exchange tile (S > 1)
  const unsigned a_ln = (r0 + lr + (lm & 1) * 8) * g.rowC + (lm >> 1) * 16;
  const unsigned b1_ln =
      (lr + (lm & 1) * 8) * rowW1 + (cs * g.HW / 8 + (lm >> 1)) * 16;
  const unsigned b2_ln =
      g.w2 + (lr + (lm & 1) * 8) * g.rowC + (c0 / 8 + (lm >> 1)) * 16;
  const unsigned ax_ln = (r0 + lr + (lm & 1) * 8) * g.rowK + (lm >> 1) * 16;

  if (resident) {
    stage_weights(base + g.w, base + g.w + g.w2, w1, w2, 0, H, C, H, g.rowH,
                  g.rowC);
  }
  stage_rows(base, x, static_cast<size_t>(t0) * g.TM, M, C, g.TM, g.rowC);
  cp_async_commit();
  for (int t = t0; t < t1; ++t) {
    const int cur = (t - t0) & 1;
    unsigned char* xs = smem + cur * g.xbuf;
    const unsigned xb = base + cur * g.xbuf;
    const size_t row0 = static_cast<size_t>(t) * g.TM;
    const int rows = min(g.TM, static_cast<int>(M - row0));
    const bool next = t + 1 < t1;
    cp_async_wait<0>();
    __syncthreads();  // tile t's x (and the weights) staged; tile t - 1 done
    if (!resident) {  // the first chunk, ahead of the next tile's x
      stage_weights(base + g.w, base + g.w + g.w2, w1, w2, 0, g.chunk, C, H,
                    g.rowK, g.rowC);
      cp_async_commit();
    }
    if (next) {
      stage_rows(base + (cur ^ 1) * g.xbuf, x, row0 + g.TM, M, C, g.TM,
                 g.rowC);
      cp_async_commit();
    }
    if (apply_ln) {  // the warp's share of its row tile's rows
      const int share = 16 / S, rb = r0 + cs * share;
      layernorm_rows(xs, g.rowC, rb, 1, min(rb + share, rows), C, ls, lb, eps,
                     nullptr, nullptr);
      __syncwarp();
    }

    float acc[NTY][4];  // y, rows r0 + gq (+ 8), the warp's columns
#pragma unroll
    for (int n = 0; n < NTY; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    }
    for (int k = 0; k < nch; ++k) {
      const int j0 = k * g.chunk;
      // this chunk's w1 (w2 at + g.w2), and where the chunk starts in it
      unsigned wb = base + g.w, o1 = 0, o2 = 0;
      if (resident) {
        if (S > 1) {  // the row tile's LN done; every warp done with the
          __syncthreads();  // exchange (at S = 1 a warp reads its own rows)
        }
        o1 = 2 * j0;
        o2 = j0 * g.rowC;
      } else {
        if (k == 0 && next) {
          cp_async_wait<1>();  // the chunk, not the next tile's x
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();  // chunk k staged, LN done; every warp done with k-1
        if (NB == 2 && k + 1 < nch) {
          const unsigned nb = base + g.w + ((k + 1) & 1) * g.wbuf;
          stage_weights(nb, nb + g.w2, w1, w2, j0 + g.chunk, g.chunk, C, H,
                        g.rowK, g.rowC);
          cp_async_commit();
        }
        wb += (NB == 2 ? (k & 1) : 0) * g.wbuf;
      }

      // h = xn.w1[:, units], the warp's units (units past H skipped)
      const int ju = j0 + cs * g.HW;
      float h[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) h[n][e] = 0.f;
      }
      for (int kc = 0; kc < C / 16; ++kc) {
        unsigned ax[4];
        ldsm_x4(xb + a_ln + kc * 32, ax);
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          if (16 * p < g.HW && ju + 16 * p < H) {
            unsigned bh[4];
            ldsm_x4_t(wb + o1 + b1_ln + kc * 16 * rowW1 + p * 32, bh);
            mma_k16(h[2 * p], ax, bh[0], bh[1]);
            mma_k16(h[2 * p + 1], ax, bh[2], bh[3]);
          }
        }
      }
      // a = round(act(round(h + b1))) as bf16 pairs, then y += a.w2[units,
      // :] over the warp's columns
      const int jq = ju + 2 * tq;  // the lane's first unit
      if (S == 1) {  // the a accumulators are the A fragments, a k16 step
                     // at a time
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          if (ju + 16 * kk < H) {
            unsigned a[4];
            act_tile<ACT>(h[2 * kk], b1, jq + 16 * kk, H, a[0], a[1]);
            act_tile<ACT>(h[2 * kk + 1], b1, jq + 16 * kk + 8, H, a[2],
                          a[3]);
#pragma unroll
            for (int q = 0; q < NTY / 2; ++q) {
              if (2 * q < g.nct) {
                unsigned b[4];
                ldsm_x4_t(wb + o2 + b2_ln + kk * 16 * g.rowC + q * 32, b);
                mma_k16(acc[2 * q], a, b[0], b[1]);
                mma_k16(acc[2 * q + 1], a, b[2], b[3]);
              }
            }
          }
        }
      } else {  // the row tile's warps swap their a through shared memory
        unsigned char* sx = smem + g.ex + (r0 + gq) * g.rowK +
                            (cs * g.HW + 2 * tq) * 2;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          if (8 * n < g.HW) {
            unsigned lo, hi;
            act_tile<ACT>(h[n], b1, jq + 8 * n, H, lo, hi);
            *reinterpret_cast<unsigned*>(sx + 16 * n) = lo;
            *reinterpret_cast<unsigned*>(sx + 8 * g.rowK + 16 * n) = hi;
          }
        }
        __syncthreads();
        for (int kk = 0; kk < g.chunk / 16; ++kk) {
          if (j0 + 16 * kk < H) {
            unsigned a[4];
            ldsm_x4(base + g.ex + ax_ln + kk * 32, a);
#pragma unroll
            for (int q = 0; q < NTY / 2; ++q) {
              if (2 * q < g.nct) {
                unsigned b[4];
                ldsm_x4_t(wb + o2 + b2_ln + kk * 16 * g.rowC + q * 32, b);
                mma_k16(acc[2 * q], a, b[0], b[1]);
                mma_k16(acc[2 * q + 1], a, b[2], b[3]);
              }
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

    // y = round(acc + b2) into the warp's rows and columns of this tile's
    // x buffer (no warp reads xn after its last fc1), then out by 16-byte
    // stores of the rows below M
    unsigned* ya = reinterpret_cast<unsigned*>(xs + (r0 + gq) * g.rowC);
    unsigned* yb = reinterpret_cast<unsigned*>(xs + (r0 + gq + 8) * g.rowC);
#pragma unroll
    for (int n = 0; n < NTY; ++n) {
      if (n < g.nct) {
        const int c = c0 + 8 * n + 2 * tq;
        const float bc0 = to_f32(b2[c]), bc1 = to_f32(b2[c + 1]);
        ya[c / 2] = pack_bf16(acc[n][0] + bc0, acc[n][1] + bc1);
        yb[c / 2] = pack_bf16(acc[n][2] + bc0, acc[n][3] + bc1);
      }
    }
    __syncthreads();
    const int units = C / 8;
    for (int i = tid; i < rows * units; i += kThreads) {
      const int r = i / units, u = i - r * units;
      *reinterpret_cast<uint4*>(y + (row0 + r) * C + u * 8) =
          *reinterpret_cast<const uint4*>(xs + r * g.rowC + u * 16);
    }
  }
}

struct Args {
  const bf16 *x, *w1, *b1, *w2, *b2;
  const float *ls, *lb;
  bf16* y;
  int M, C, H;
  float eps;
  int apply_ln;
};

struct Plan {
  int split, buffers, blocks, smem;
};

template <int ACT, int NTY>
cudaError_t launch_nty(const Args& a, const Plan& p, cudaStream_t s) {
  auto kernel = mlp_fwd_kernel<ACT, NTY>;
  cudaError_t err = set_smem(kernel, p.smem);
  if (err != cudaSuccess) return err;
  kernel<<<p.blocks, kThreads, p.smem, s>>>(
      a.x, a.ls, a.lb, a.w1, a.b1, a.w2, a.b2, a.y, a.M, a.C, a.H, p.split,
      p.buffers, a.eps, a.apply_ln);
  return cudaGetLastError();
}

template <int ACT>
cudaError_t launch(const Args& a, const Plan& p, cudaStream_t s) {
  return fwd_nty(a.C, p.split) == 8 ? launch_nty<ACT, 8>(a, p, s)
                                    : launch_nty<ACT, 16>(a, p, s);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Whether the plan is one the kernel takes for these shapes: a layout it
// takes (mlp_branch_mma_layout.h), its shared bytes, and blocks that each
// walk a non-empty run of the token tiles.
bool plan_ok(int M, int C, int H, const Plan& p) {
  if (M <= 0 || !fwd_fits(C, H, p.split, p.buffers)) return false;
  const FwdGeom g = fwd_geom(C, H, p.split, p.buffers);
  const int tiles = (M + g.TM - 1) / g.TM;
  if (g.bytes != p.smem || p.blocks < 1 || p.blocks > tiles) return false;
  const int per = (tiles + p.blocks - 1) / p.blocks;
  return (tiles + per - 1) / per == p.blocks;  // no block left empty
}

}  // namespace

// x, y [M, C]; w1 [C, H]; b1 [H]; w2 [H, C]; b2 [C]: contiguous bf16 (dtype
// must be 1), x, w1, w2 and y 16-byte aligned. ln_scale, ln_bias [C]:
// float32. C and H multiples of 16. The plan is ops/mlp_branch.py:
// mlp_branch_forward_plan's: split, weight buffers (0: resident), blocks and
// shared bytes. Returns cudaErrorInvalidValue for a plan or shape it does not
// take.
extern "C" int ogvt_mlp_branch_mma(const void* x, const void* ln_scale,
                                   const void* ln_bias, const void* w1,
                                   const void* b1, const void* w2,
                                   const void* b2, void* y, int M, int C,
                                   int H, int act, float eps, int apply_ln,
                                   int dtype, int split, int buffers,
                                   int blocks, int smem, void* stream) {
  const Plan p{split, buffers, blocks, smem};
  if (dtype != kBFloat16 || !plan_ok(M, C, H, p) || !aligned16(x) ||
      !aligned16(w1) || !aligned16(w2) || !aligned16(y)) {
    return cudaErrorInvalidValue;
  }
  const Args a{static_cast<const bf16*>(x),
               static_cast<const bf16*>(w1),
               static_cast<const bf16*>(b1),
               static_cast<const bf16*>(w2),
               static_cast<const bf16*>(b2),
               static_cast<const float*>(ln_scale),
               static_cast<const float*>(ln_bias),
               static_cast<bf16*>(y),
               M, C, H, eps, apply_ln};
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
