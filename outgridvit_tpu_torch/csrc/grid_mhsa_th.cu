// Grid multi-head self-attention core in bf16 at grids of 1 <= N <= 16
// tokens, head width hd a multiple of 8 up to 64; forward and recompute
// backward on mma.sync tensor-core tiles.
//
// Serves two TPU kernels of outgridvit_tpu/ops/grid_attention_pallas_t.py
// that compute the same function in different VMEM layouts:
// grid_mhsa_pallas_t (#1, tag "t": `_fwd_kernel`, `_bwd_kernel`) and the
// head-chunked grid_mhsa_pallas_th (#3, tag "th": `_fwd_kernel_h`,
// `_bwd_kernel_h`); th_fwd and th_bwd here, with their rounding points:
//   forward:  logits = q.k^T, bf16 products summed in fp32, then scaled;
//             a = softmax in fp32 (max subtracted, multiplied by 1/sum);
//             out = a.v with a kept in fp32, cast once;
//   backward: a recomputed; dp = dO.v^T; ds = a * (dp - sum_m dp*a) in fp32;
//             dq = scale * ds.k, dk = scale * ds^T.q, dv = a^T.dO, each cast
//             once.
// fp32 launches are not this kernel's, nor a bf16 "t" launch at a head
// width it does not take: the wrapper sends them to csrc/grid_mhsa.cu
// (ops/grid_attention.py:grid_mhsa_entry), decided from dtype and shape.
//
// What bounds it on the H100: memory. Per grid it reads N*3C elements and
// writes N*C (forward) for 4*N*N*C flops, 8 flop/byte in bf16 at N = 16
// (about 11 in the backward), 2 at N = 4, far below the tensor cores' ~295.
// The floor is each input read once and each output written once at HBM
// rate.
//
// What the design does about it: one warp per unit and four units per
// block, with no barrier wider than a warp. A unit is one head of P = 16 / N
// adjacent grids (grid_mhsa_th_layout.h): the rows of adjacent grids are
// adjacent in qkv [G, N, 3C], so a unit's P * N rows are one [16, hd]
// slice, 16 tokens being the M of one mma.sync.m16n8k16 tile. A warp copies
// its unit's slices of q, k, v (and dO) into shared memory as bf16 by
// 16-byte cp.async (q and k in a first group, so the logits start while v
// is in flight), at a row stride of an odd number of 16-byte units, so the
// 8 rows one ldmatrix reads fall in 8 distinct bank groups:
//   - q.k^T and dO.v^T are bf16 mmas (exact products, fp32 sums), k-looped
//     over hd with an m16n8k8 step for the tail when hd % 16 == 8;
//   - the softmax runs in registers on the accumulator fragment: a row's 16
//     values lie in the 4 lanes of a quad (2 shuffles for the max, 2 for
//     the sum);
//   - a.v, ds.k, ds^T.q and a^T.dO take their fp32 left operand as two bf16
//     terms, hi = bf16(x) and lo = bf16(x - hi), two mmas into one fp32
//     accumulator (about 2^-17 relative per element; the probabilities are
//     never rounded to bf16, which is #6's rounding point, not #1's or
//     #3's). The accumulator fragment of a 16 x 16 product is the A
//     fragment of the next; the transposes a^T and ds^T are movmatrix in
//     registers;
//   - each result is cast once into a shared tile the warp no longer reads
//     and leaves by 16-byte stores.
// At N < 16 (the MASKED instantiations) rows past P * N, and the rows of
// grids past G in the last unit, are zero-filled by cp.async with a source
// size of 0 (nothing is read past qkv's or dO's end), and the logits are
// masked block-diagonally: column c is a key of row r only where both lie
// in the same real grid. A padding row has no key: its probabilities are
// exact zeros (not exp(-inf + inf)), so ds is 0 wherever a is and no
// padding row or other grid reaches dq, dk or dv; only real rows are
// stored. At N = 16 (P = 1) nothing is masked, and the instantiation is the
// N = 16 kernel's, unchanged.
// Shared memory: 3 (forward) or 4 (backward) tiles of 16 * hd bf16 a warp,
// 3-27 KB (forward) and 4-36 KB (backward) a block; with the register caps
// of grid_mhsa_th_layout.h, 6-8 blocks (24-32 units) are resident on an
// SM. The launch plan is ops/grid_attention.py:grid_mhsa_th_plan, asked of
// the same header; the entry points refuse any other. Every warp owns its
// unit's rows: no atomics, and two calls give bitwise-equal results.
#include <stdint.h>

#include <initializer_list>

#include "common.cuh"
#include "grid_mhsa_th_layout.h"
#include "mma.cuh"

using namespace ogvt;

namespace {

using bf16 = __nv_bfloat16;

constexpr int kN = th::kTokens;  // rows of a unit: the M of one mma tile
using th::kThreads;
using th::kWarps;
using th::tile_bytes;

// Where the units of a masked launch (N < 16) lie: `per` = P = 16 / N grids
// a unit, G in all; (r * mul) >> 8 = r / N for every row or column r < 16,
// with mul = ceil(256 / N) (the excess r * (mul - 256 / N) / 256 is below
// 1 / 16 <= 1 / N, so the quotient never reaches the next integer).
struct Mask {
  int G, N, per, mul;
};

// The first row of qkv [G * N, 3C] of unit group `grp` (a group: a unit's
// grids, all its heads), and how many of its 16 rows are real.
template <bool MASKED>
__device__ __forceinline__ size_t unit_rows(int grp, const Mask& m,
                                            int& rows) {
  if constexpr (MASKED) {
    const int g0 = grp * m.per;
    rows = min(m.per, m.G - g0) * m.N;
    return static_cast<size_t>(g0) * m.N;
  } else {
    rows = kN;
    return static_cast<size_t>(grp) * kN;
  }
}

// Copy the [16, hd] slice of 16 rows `ld` elements apart at `src` into the
// tile at shared address `tile`; MASKED: rows >= `rows` are zero-filled.
template <int NT, bool MASKED>
__device__ __forceinline__ void stage(unsigned tile, const bf16* src, int ld,
                                      int rows, int lane) {
#pragma unroll
  for (int i = lane; i < kN * NT; i += 32) {
    const int r = i / NT, c = i - r * NT;
    if constexpr (MASKED) {
      const bool live = r < rows;
      cp_async16_zfill(tile + (r * row16(NT) + c) * 16,
                       src + static_cast<size_t>(live ? r : 0) * ld + c * 8,
                       live ? 16 : 0);
    } else {
      cp_async16(tile + (r * row16(NT) + c) * 16,
                 src + static_cast<size_t>(r) * ld + c * 8);
    }
  }
}

// The tile back to the [16, hd] slice at `dst`, 16 bytes a lane; MASKED:
// rows [0, rows) only.
template <int NT, bool MASKED>
__device__ __forceinline__ void unstage(bf16* dst, int ld,
                                        const unsigned char* tile, int rows,
                                        int lane) {
#pragma unroll
  for (int i = lane; i < kN * NT; i += 32) {
    const int r = i / NT, c = i - r * NT;
    if (MASKED && r >= rows) break;
    *reinterpret_cast<uint4*>(dst + static_cast<size_t>(r) * ld + c * 8) =
        *reinterpret_cast<const uint4*>(tile + (r * row16(NT) + c) * 16);
  }
}

// s = x.y^T for two staged [16, hd] tiles: s[j] is the m16n8 accumulator of
// columns 8j..8j+7 (rows of y). bf16 products summed in fp32.
template <int NT>
__device__ __forceinline__ void product_t(float (&s)[2][4], unsigned x,
                                          unsigned y, int lane) {
  const int r = lane & 7, mi = lane >> 3;
  // A (x): matrices (rows 0-7, k 0-7), (8-15, 0-7), (0-7, 8-15), (8-15,
  // 8-15); B (y): (y rows 0-7, k 0-7), (0-7, 8-15), (8-15, 0-7), (8-15, 8-15)
  const unsigned xa = x + ((r + (mi & 1) * 8) * row16(NT) + (mi >> 1)) * 16;
  const unsigned yb = y + ((r + (mi >> 1) * 8) * row16(NT) + (mi & 1)) * 16;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
  }
#pragma unroll
  for (int kc = 0; kc + 1 < NT; kc += 2) {
    unsigned a[4], b[4];
    ldsm_x4(xa + kc * 16, a);
    ldsm_x4(yb + kc * 16, b);
    mma_k16(s[0], a, b[0], b[1]);
    mma_k16(s[1], a, b[2], b[3]);
  }
  if constexpr (NT & 1) {
    const unsigned off = ((lane & 15) * row16(NT) + NT - 1) * 16;
    unsigned a[2], b[2];
    ldsm_x2(x + off, a);  // rows 0-7, rows 8-15
    ldsm_x2(y + off, b);  // columns 0-7, columns 8-15
    mma_k8(s[0], a, b[0]);
    mma_k8(s[1], a, b[1]);
  }
}

// acc = p.y for a 16 x 16 fp32 p held as the A fragments of its bf16 terms
// (hi, lo) and a staged [16, hd] tile y whose rows are the k index
// (ldmatrix .trans): acc[j] is the m16n8 accumulator of columns 8j..8j+7.
template <int NT>
__device__ __forceinline__ void product(float (&acc)[NT][4],
                                        const unsigned (&hi)[4],
                                        const unsigned (&lo)[4], unsigned y,
                                        int lane) {
  const int r = lane & 7, mi = lane >> 3;
  // matrices (k 0-7, cols 8j..), (k 8-15, 8j..), (0-7, 8j+8..), (8-15, 8j+8..)
  const unsigned yb = y + ((r + (mi & 1) * 8) * row16(NT) + (mi >> 1)) * 16;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < NT; j += 2) {
    if (j + 1 < NT) {
      unsigned b[4];
      ldsm_x4_t(yb + j * 16, b);
      mma_k16(acc[j], hi, b[0], b[1]);
      mma_k16(acc[j], lo, b[0], b[1]);
      mma_k16(acc[j + 1], hi, b[2], b[3]);
      mma_k16(acc[j + 1], lo, b[2], b[3]);
    } else {
      unsigned b[2];
      ldsm_x2_t(y + ((lane & 15) * row16(NT) + j) * 16, b);
      mma_k16(acc[j], hi, b[0], b[1]);
      mma_k16(acc[j], lo, b[0], b[1]);
    }
  }
}

// The scaled logits in s (fp32 accumulators of q.k^T) -> probabilities, in
// place. Lane (g, t) = (lane / 4, lane % 4) holds columns 8j + 2t, 8j + 2t + 1
// of rows g (s[j][0..1]) and g + 8 (s[j][2..3]). MASKED: column c is a key
// of row r only where both are among the unit's `rows` real rows and in the
// same grid ((x * mul) >> 8 = x / N); a row with no key (a padding row)
// gets probabilities of exactly 0.
template <bool MASKED>
__device__ __forceinline__ void softmax16(float (&s)[2][4], float scale,
                                          int rows, int mul, int lane) {
  int col[4];  // MASKED: the grid of each column this lane holds, or -2
  if constexpr (MASKED) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = 8 * (i >> 1) + 2 * (lane & 3) + (i & 1);
      col[i] = c < rows ? (c * mul) >> 8 : -2;
    }
  }
#pragma unroll
  for (int h = 0; h < 4; h += 2) {
    float x[4] = {__fmul_rn(s[0][h], scale), __fmul_rn(s[0][h + 1], scale),
                  __fmul_rn(s[1][h], scale), __fmul_rn(s[1][h + 1], scale)};
    if constexpr (MASKED) {
      const int r = (lane >> 2) + 4 * h;  // row g, then g + 8
      const int grid = r < rows ? (r * mul) >> 8 : -1;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (col[i] != grid) x[i] = -INFINITY;
      }
    }
    float mx = fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    if (MASKED && mx == -INFINITY) mx = 0.f;  // no key: every exp is 0
    float den = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[i] = expf(x[i] - mx);
      den += x[i];
    }
    den += __shfl_xor_sync(0xffffffffu, den, 1);
    den += __shfl_xor_sync(0xffffffffu, den, 2);
    const float inv = MASKED && den == 0.f ? 0.f : 1.f / den;
    s[0][h] = x[0] * inv;
    s[0][h + 1] = x[1] * inv;
    s[1][h] = x[2] * inv;
    s[1][h + 1] = x[3] * inv;
  }
}

// acc * scale cast to bf16 into the tile (row g: acc[j][0..1], row g + 8:
// acc[j][2..3], columns 8j + 2t).
template <int NT>
__device__ __forceinline__ void put(unsigned char* tile,
                                    const float (&acc)[NT][4], float scale,
                                    int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    *reinterpret_cast<__nv_bfloat162*>(tile + (g * row16(NT) + j) * 16 +
                                       t * 4) =
        __floats2bfloat162_rn(acc[j][0] * scale, acc[j][1] * scale);
    *reinterpret_cast<__nv_bfloat162*>(tile + ((g + 8) * row16(NT) + j) * 16 +
                                       t * 4) =
        __floats2bfloat162_rn(acc[j][2] * scale, acc[j][3] * scale);
  }
}

// qkv [G, N, 3C] -> out [G, N, C]; unit = group * heads + head, a group
// being P = 16 / N adjacent grids (1 at N = 16, !MASKED).
template <int NT, bool MASKED>
__global__ void __launch_bounds__(kThreads, th::sm_blocks(NT, false))
th_fwd(const bf16* __restrict__ qkv, bf16* __restrict__ out, int units,
       int heads, float scale, Mask m) {
  extern __shared__ uint4 smem[];
  constexpr int kTile = tile_bytes(NT);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int unit = blockIdx.x * kWarps + warp;
  if (unit >= units) return;
  const int g = unit / heads, h = unit - g * heads;
  const int C = heads * 8 * NT;
  int rows;
  const size_t row0 = unit_rows<MASKED>(g, m, rows);
  unsigned char* tq = reinterpret_cast<unsigned char*>(smem) + warp * 3 * kTile;
  const unsigned sq = smem_addr(tq), sk = sq + kTile, sv = sk + kTile;
  const bf16* src = qkv + row0 * 3 * C + h * 8 * NT;
  stage<NT, MASKED>(sq, src, 3 * C, rows, lane);
  stage<NT, MASKED>(sk, src + C, 3 * C, rows, lane);
  cp_async_commit();
  stage<NT, MASKED>(sv, src + 2 * C, 3 * C, rows, lane);
  cp_async_commit();
  cp_async_wait<1>();
  __syncwarp();

  float s[2][4];
  product_t<NT>(s, sq, sk, lane);
  softmax16<MASKED>(s, scale, rows, m.mul, lane);
  unsigned hi[4], lo[4];
  to_a(s[0], s[1], hi, lo);
  cp_async_wait<0>();
  __syncwarp();
  float acc[NT][4];
  product<NT>(acc, hi, lo, sv, lane);
  put<NT>(tq, acc, 1.f, lane);  // q's tile: its last read was the logits
  __syncwarp();
  unstage<NT, MASKED>(out + row0 * C + h * 8 * NT, C, tq, rows, lane);
}

// qkv [G, N, 3C], dout [G, N, C] -> dqkv [G, N, 3C]; units as th_fwd's.
template <int NT, bool MASKED>
__global__ void __launch_bounds__(kThreads, th::sm_blocks(NT, true))
th_bwd(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
       bf16* __restrict__ dqkv, int units, int heads, float scale, Mask m) {
  extern __shared__ uint4 smem[];
  constexpr int kTile = tile_bytes(NT);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int unit = blockIdx.x * kWarps + warp;
  if (unit >= units) return;
  const int g = unit / heads, h = unit - g * heads;
  const int C = heads * 8 * NT;
  unsigned char* tq = reinterpret_cast<unsigned char*>(smem) + warp * 4 * kTile;
  unsigned char* tv = tq + 2 * kTile;
  unsigned char* td = tq + 3 * kTile;
  const unsigned sq = smem_addr(tq), sk = sq + kTile, sv = sk + kTile,
                 sd = sv + kTile;
  int rows;
  const size_t row0 = unit_rows<MASKED>(g, m, rows);
  const bf16* src = qkv + row0 * 3 * C + h * 8 * NT;
  stage<NT, MASKED>(sq, src, 3 * C, rows, lane);
  stage<NT, MASKED>(sk, src + C, 3 * C, rows, lane);
  cp_async_commit();
  stage<NT, MASKED>(sv, src + 2 * C, 3 * C, rows, lane);
  stage<NT, MASKED>(sd, dout + row0 * C + h * 8 * NT, C, rows, lane);
  cp_async_commit();
  cp_async_wait<1>();
  __syncwarp();

  float a[2][4];
  product_t<NT>(a, sq, sk, lane);
  softmax16<MASKED>(a, scale, rows, m.mul, lane);
  cp_async_wait<0>();
  __syncwarp();
  float ds[2][4];
  product_t<NT>(ds, sd, sv, lane);  // dp = dO.v^T
#pragma unroll
  for (int r = 0; r < 4; r += 2) {  // rows g, then g + 8
    float d = ds[0][r] * a[0][r] + ds[0][r + 1] * a[0][r + 1] +
              ds[1][r] * a[1][r] + ds[1][r + 1] * a[1][r + 1];
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    d += __shfl_xor_sync(0xffffffffu, d, 2);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      ds[j][r] = a[j][r] * (ds[j][r] - d);
      ds[j][r + 1] = a[j][r + 1] * (ds[j][r + 1] - d);
    }
  }

  unsigned hi[4], lo[4], thi[4], tlo[4];
  float acc[NT][4];
  to_a(a[0], a[1], hi, lo);
  transpose_a(hi, thi);
  transpose_a(lo, tlo);
  product<NT>(acc, thi, tlo, sd, lane);  // dv = a^T.dO
  __syncwarp();                          // every lane is done with v (dp)
  put<NT>(tv, acc, 1.f, lane);
  to_a(ds[0], ds[1], hi, lo);
  transpose_a(hi, thi);
  transpose_a(lo, tlo);
  product<NT>(acc, thi, tlo, sq, lane);  // ds^T.q
  __syncwarp();                          // every lane is done with dO
  put<NT>(td, acc, scale, lane);
  product<NT>(acc, hi, lo, sk, lane);  // ds.k
  __syncwarp();                        // every lane is done with q
  put<NT>(tq, acc, scale, lane);
  __syncwarp();
  bf16* dst = dqkv + row0 * 3 * C + h * 8 * NT;
  unstage<NT, MASKED>(dst, 3 * C, tq, rows, lane);
  unstage<NT, MASKED>(dst + C, 3 * C, td, rows, lane);
  unstage<NT, MASKED>(dst + 2 * C, 3 * C, tv, rows, lane);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The launch this file takes: the layout of grid_mhsa_th_layout.h for
// grids of N tokens, C channels and `heads` heads (1 <= N <= 16, hd = C /
// heads a multiple of 8 in [8, 64]; kWarps warps, its shared bytes for the
// direction), 16-byte aligned pointers. Returns hd / 8, or 0 for anything
// else.
int plan_ok(int G, int N, int C, int heads, int warps, int smem, bool bwd,
            std::initializer_list<const void*> ptrs) {
  if (G < 0 || !th::takes(N, C, heads) || warps != kWarps) return 0;
  const int nt = C / heads / 8;
  if (smem != th::smem_bytes(nt, bwd)) return 0;
  for (const void* p : ptrs) {
    if (!aligned16(p)) return 0;
  }
  return nt;
}

// The mask of grids of N tokens, G in all, and the units they make.
Mask make_mask(int G, int N, int heads, int& units) {
  const int per = th::grids_per_unit(N);
  units = (G + per - 1) / per * heads;
  return Mask{G, N, per, (256 + N - 1) / N};
}

template <int NT, bool MASKED>
cudaError_t launch_fwd(const void* qkv, void* out, int units, int heads,
                       float scale, Mask m, int smem, cudaStream_t stream) {
  cudaError_t err = set_smem(th_fwd<NT, MASKED>, smem);
  if (err != cudaSuccess) return err;
  th_fwd<NT, MASKED><<<(units + kWarps - 1) / kWarps, kThreads, smem,
                       stream>>>(static_cast<const bf16*>(qkv),
                                 static_cast<bf16*>(out), units, heads, scale,
                                 m);
  return cudaGetLastError();
}

template <int NT>
cudaError_t launch_fwd(const void* qkv, void* out, int units, int heads,
                       float scale, Mask m, int smem, cudaStream_t stream) {
  return m.N == kN
             ? launch_fwd<NT, false>(qkv, out, units, heads, scale, m, smem,
                                     stream)
             : launch_fwd<NT, true>(qkv, out, units, heads, scale, m, smem,
                                    stream);
}

template <int NT, bool MASKED>
cudaError_t launch_bwd(const void* qkv, const void* dout, void* dqkv,
                       int units, int heads, float scale, Mask m, int smem,
                       cudaStream_t stream) {
  cudaError_t err = set_smem(th_bwd<NT, MASKED>, smem);
  if (err != cudaSuccess) return err;
  th_bwd<NT, MASKED><<<(units + kWarps - 1) / kWarps, kThreads, smem,
                       stream>>>(static_cast<const bf16*>(qkv),
                                 static_cast<const bf16*>(dout),
                                 static_cast<bf16*>(dqkv), units, heads,
                                 scale, m);
  return cudaGetLastError();
}

template <int NT>
cudaError_t launch_bwd(const void* qkv, const void* dout, void* dqkv,
                       int units, int heads, float scale, Mask m, int smem,
                       cudaStream_t stream) {
  return m.N == kN ? launch_bwd<NT, false>(qkv, dout, dqkv, units, heads,
                                           scale, m, smem, stream)
                   : launch_bwd<NT, true>(qkv, dout, dqkv, units, heads,
                                          scale, m, smem, stream);
}

}  // namespace

// #1 and #3 in bf16: qkv [G, N, 3C] -> out [G, N, C], both contiguous, 1 <=
// N <= 16; `warps` and `smem` (bytes a block) as grid_mhsa_th_plan gives
// them. Returns cudaErrorInvalidValue, launching nothing, for fp32, a
// shape or plan grid_mhsa_th_layout.h does not give, or a pointer off 16
// bytes.
extern "C" int ogvt_grid_mhsa_th(const void* qkv, void* out, int G, int N,
                                 int C, int heads, float scale, int warps,
                                 int smem, int dtype, void* stream) {
  const int nt =
      dtype == kBFloat16
          ? plan_ok(G, N, C, heads, warps, smem, false, {qkv, out})
          : 0;
  if (nt == 0) return cudaErrorInvalidValue;
  if (G == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int units;
  const Mask m = make_mask(G, N, heads, units);
  switch (nt) {
    case 1: return launch_fwd<1>(qkv, out, units, heads, scale, m, smem, s);
    case 2: return launch_fwd<2>(qkv, out, units, heads, scale, m, smem, s);
    case 3: return launch_fwd<3>(qkv, out, units, heads, scale, m, smem, s);
    case 4: return launch_fwd<4>(qkv, out, units, heads, scale, m, smem, s);
    case 5: return launch_fwd<5>(qkv, out, units, heads, scale, m, smem, s);
    case 6: return launch_fwd<6>(qkv, out, units, heads, scale, m, smem, s);
    case 7: return launch_fwd<7>(qkv, out, units, heads, scale, m, smem, s);
    default: return launch_fwd<8>(qkv, out, units, heads, scale, m, smem, s);
  }
}

// #1 and #3's backward in bf16: qkv [G, N, 3C], dout [G, N, C] -> dqkv
// [G, N, 3C], all contiguous, 1 <= N <= 16; `warps` and `smem` as
// grid_mhsa_th_plan gives them; refuses as ogvt_grid_mhsa_th does.
extern "C" int ogvt_grid_mhsa_th_bwd(const void* qkv, const void* dout,
                                     void* dqkv, int G, int N, int C,
                                     int heads, float scale, int warps,
                                     int smem, int dtype, void* stream) {
  const int nt =
      dtype == kBFloat16
          ? plan_ok(G, N, C, heads, warps, smem, true, {qkv, dout, dqkv})
          : 0;
  if (nt == 0) return cudaErrorInvalidValue;
  if (G == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int units;
  const Mask m = make_mask(G, N, heads, units);
  switch (nt) {
    case 1: return launch_bwd<1>(qkv, dout, dqkv, units, heads, scale, m, smem, s);
    case 2: return launch_bwd<2>(qkv, dout, dqkv, units, heads, scale, m, smem, s);
    case 3: return launch_bwd<3>(qkv, dout, dqkv, units, heads, scale, m, smem, s);
    case 4: return launch_bwd<4>(qkv, dout, dqkv, units, heads, scale, m, smem, s);
    case 5: return launch_bwd<5>(qkv, dout, dqkv, units, heads, scale, m, smem, s);
    case 6: return launch_bwd<6>(qkv, dout, dqkv, units, heads, scale, m, smem, s);
    case 7: return launch_bwd<7>(qkv, dout, dqkv, units, heads, scale, m, smem, s);
    default:
      return launch_bwd<8>(qkv, dout, dqkv, units, heads, scale, m, smem, s);
  }
}
