// Grid multi-head self-attention core for grids of 16 < N < 64 tokens
// (takes 1 <= N <= 63) in bf16, head width hd a multiple of 8 up to 64;
// forward and recompute backward on mma.sync tensor-core tiles.
//
// Replaces the TPU kernel outgridvit_tpu/ops/grid_attention_pallas.py:
// grid_mhsa_pallas (#6): `_fwd_kernel` / `_attn_tile` (packed_fwd here) and
// `_bwd_kernel` (packed_bwd), with their rounding points:
//   forward:  logits = q.k^T, bf16 products summed in fp32, then scaled;
//             a = exp(logit - max) / sum, by IEEE division; P = bf16(a);
//             out = bf16(P.v), summed in fp32;
//   backward: a recomputed by division and kept in fp32; dv = a^T.dO;
//             dp = dO.v^T; ds = a * (dp - sum_m dp*a); dq = scale * ds.k,
//             dk = scale * ds^T.q; each cast once.
// The TPU kernel packs 32 // N grids of N < 16 tokens block-diagonally under
// a -1e30 mask to widen its matrix-unit products; exp of a masked logit is
// exactly 0 in fp32, so packing is layout only, and this kernel packs
// nothing. fp32 launches (the parity path) take csrc/grid_mhsa_packed.cu.
//
// What bounds it on the H100: memory. Per grid it reads N*3C elements and
// writes N*C (forward) for about 4*N*N*C flops: N/2 flop/byte in bf16, 18
// at N = 36, far below the tensor cores' ~295 (the backward reads 4C and
// writes 3C a token for 10*N*N*C flops). The floor is each input read once
// and each output written once at HBM rate. Next in line, measured on the
// card: instruction issue, which at N = 36 takes about as long as the
// bytes (an exp and a division per logit, the two-term splits, addresses).
//
// What the design does about it: one warp per (grid, head) unit, up to four
// units a block, no barrier wider than a warp. A warp copies its head's
// slices of q, k and v (and dO) into shared memory as bf16 by 16-byte
// cp.async (q and k in a first group, so the logits start while the rest is
// in flight), at a row stride of an odd number of 16-byte units (ldmatrix
// without bank conflicts). Keys are staged to KT8 = ceil(N/8) n8 tiles,
// query rows to MT = ceil(KT8/2) m16 tiles; rows past N are zero-filled by
// cp.async (0 * garbage could be NaN). KT8 and hd / 8 are template
// constants and the row tiles are unrolled, so every loop, branch and
// shared offset but the masks at N is fixed at compile time. Per row tile:
//   - q_i.k^T (and dO_i.v^T) are bf16 mmas into KT8 n8 accumulators, an
//     m16n8k8 step for the hd tail when hd % 16 == 8;
//   - logits of key columns >= N are set to -inf before the row max; the
//     softmax runs in registers, a row's values in the 4 lanes of a quad;
//     the division is the IEEE one, three instructions a value (divide());
//   - forward: P = bf16(a) is packed straight from the accumulators into
//     the A fragments of P.v, one bf16 mma per k16 step of keys (an m16n8k8
//     step for a key tail of 8);
//   - backward: a and ds of query rows >= N are set to 0; ds.k, a^T.dO and
//     ds^T.q take their fp32 left operand as two bf16 terms, hi = bf16(x)
//     and lo = bf16(x - hi), the transposes by movmatrix. dq_i is complete
//     after its row tile; dv and dk sum over the row tiles in row-tile
//     order in fp32 accumulators in the warp's shared memory (a float4 a
//     lane per m16n8 tile); heads wider than 32 are taken 32 columns at a
//     time, so that all fit the register cap at 63 tokens.
// Each result is cast once into a staged tile the warp no longer reads and
// leaves by 16-byte stores, rows >= N never stored. A second staging
// buffer, to copy a warp's next unit while it computes one, measured
// slower (it halves the warps an SM holds). The launch plan (warps a
// block, shared bytes) is ops/grid_attention.py:grid_mhsa_packed_plan; the
// entry points (csrc/grid_mhsa_packed_mma.cu) refuse any other. Every warp
// owns its unit's rows: no atomics, and two calls give bitwise-equal
// results.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

// The kernels and their launcher; csrc/grid_mhsa_packed_mma.cu holds the
// entry points and the forward's instantiations,
// csrc/grid_mhsa_packed_mma_bwd_short.cu and _bwd_long.cu the backward's.
namespace ogvt::packed {

using bf16 = __nv_bfloat16;

constexpr int kMaxWarps = 4;  // (grid, head) units per block, one per warp
constexpr int kThreads = 32 * kMaxWarps;
constexpr int kAccTile = 32 * 16;  // an m16n8 fp32 tile, a float4 a lane

__host__ __device__ constexpr int row_bytes(int nt) { return row16(nt) * 16; }

// m16 tiles of query rows beside kt8 n8 tiles of keys: ceil(N / 16).
__host__ __device__ constexpr int row_tiles(int kt8) { return (kt8 + 1) / 2; }

// Shared bytes of one warp: q (and dO) tiles of 16 * row_tiles rows, k and
// v tiles of 8 * kt8 rows; the backward adds the dv and dk accumulators.
__host__ __device__ constexpr int warp_bytes(int kt8, int nt, bool bwd) {
  return ((bwd ? 2 : 1) * 16 * row_tiles(kt8) + 16 * kt8) * row_bytes(nt) +
         (bwd ? 2 * row_tiles(kt8) * nt * kAccTile : 0);
}

// Blocks of kMaxWarps warps one SM holds, by shared memory and by the fp32
// values a lane keeps live (forward: the logits of KT8 key tiles and the
// P.v accumulators, hd 8 taking a few more; backward: a, ds and two
// accumulator rows): the kernels' __launch_bounds__, so that each
// instantiation takes the registers that occupancy leaves it, fitted so
// that ptxas spills at none.
// ops/grid_attention.py:packed_regs mirrors it.
__host__ __device__ constexpr int sm_blocks(int kt8, int nt, bool bwd) {
  const int mt = row_tiles(kt8);
  const int live =
      bwd ? 16 * mt + 8 * nt : 4 * kt8 + 4 * nt + (nt == 1 ? 8 : 0);
  const int by_regs = bwd ? (live <= 40 ? 6 : live <= 72 ? 4 : 3)
                          : (live <= 32 ? 8 : live <= 48 ? 6 : 5);
  const int by_smem =
      233472 / (kMaxWarps * warp_bytes(kt8, nt, bwd) + 1024);
  const int b = by_smem < by_regs ? by_smem : by_regs;
  return b < 1 ? 1 : b;
}

// Copy rows [0, ROWS) of the [*, hd] slice at `src` (rows `ld` elements
// apart) into the tile at shared address `tile`; rows >= n are zero-filled.
template <int NT, int ROWS>
__device__ __forceinline__ void stage(unsigned tile, const bf16* src, int ld,
                                      int n, int lane) {
#pragma unroll
  for (int k = 0; k < (ROWS * NT + 31) / 32; ++k) {
    const int i = lane + 32 * k;
    if (i >= ROWS * NT) break;
    const int r = i / NT, c = i - r * NT;
    const bool live = r < n;
    cp_async16_zfill(tile + (r * row16(NT) + c) * 16,
                     src + static_cast<size_t>(live ? r : 0) * ld + c * 8,
                     live ? 16 : 0);
  }
}

// Rows [0, n) of the tile (n <= ROWS) back to the slice at `dst`, 16 bytes
// a lane.
template <int NT, int ROWS>
__device__ __forceinline__ void unstage(bf16* dst, int ld,
                                        const unsigned char* tile, int n,
                                        int lane) {
#pragma unroll
  for (int k = 0; k < (ROWS * NT + 31) / 32; ++k) {
    const int i = lane + 32 * k;
    const int r = i / NT, c = i - r * NT;
    if (r >= n) break;
    *reinterpret_cast<uint4*>(dst + static_cast<size_t>(r) * ld + c * 8) =
        *reinterpret_cast<const uint4*>(tile + (r * row16(NT) + c) * 16);
  }
}

// s[j] = x.y^T for the 16 rows of tile x at shared address x and the key
// columns 8j..8j+7 (rows of tile y), j < KT8; bf16 products summed in fp32.
// s[j] for KT8 <= j < 2 * row_tiles(KT8) is zero.
template <int KT8, int NT>
__device__ __forceinline__ void logits(float (&s)[2 * row_tiles(KT8)][4],
                                       unsigned x, unsigned y, int lane) {
  const int r = lane & 7, mi = lane >> 3;
  // A: (rows 0-7, k 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15);
  // B, two key tiles: (keys 0-7, k 0-7), (0-7, 8-15), (8-15, 0-7),
  // (8-15, 8-15); one key tile: the first two (an .x2 reads lanes 0-15's
  // addresses, and those of xa and yb serve it too)
  const unsigned xa = x + ((r + (mi & 1) * 8) * row16(NT) + (mi >> 1)) * 16;
  const unsigned yb = y + ((r + (mi >> 1) * 8) * row16(NT) + (mi & 1)) * 16;
#pragma unroll
  for (int j = 0; j < 2 * row_tiles(KT8); ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  }
#pragma unroll
  for (int kc = 0; kc + 1 < NT; kc += 2) {
    unsigned a[4];
    ldsm_x4(xa + kc * 16, a);
#pragma unroll
    for (int j = 0; j < KT8; j += 2) {
      const unsigned rows = (8 * j * row16(NT) + kc) * 16;
      if (j + 1 < KT8) {
        unsigned b[4];
        ldsm_x4(yb + rows, b);
        mma_k16(s[j], a, b[0], b[1]);
        mma_k16(s[j + 1], a, b[2], b[3]);
      } else {
        unsigned b[2];
        ldsm_x2(yb + rows, b);
        mma_k16(s[j], a, b[0], b[1]);
      }
    }
  }
  if constexpr (NT & 1) {  // the k8 tail of hd
    const unsigned tail = ((lane & 15) * row16(NT) + NT - 1) * 16;
    unsigned a[2];
    ldsm_x2(xa + (NT - 1) * 16, a);  // rows 0-7, rows 8-15
#pragma unroll
    for (int j = 0; j < KT8; j += 2) {
      const unsigned rows = 8 * j * row16(NT) * 16;
      if (j + 1 < KT8) {
        unsigned b[2];
        ldsm_x2(y + rows + tail, b);  // keys 8j.., keys 8j+8..
        mma_k8(s[j], a, b[0]);
        mma_k8(s[j + 1], a, b[1]);
      } else {
        unsigned b;
        ldsm_x1(y + rows + tail, b);
        mma_k8(s[j], a, b);
      }
    }
  }
}

// e / d, the IEEE quotient, for 0 <= e <= d with d in [1, 64] (an
// exponential and its row's sum), given r = 1/d correctly rounded: q = e*r
// is within an ulp of e/d, the remainder e - d*q is exact in one fma, and
// q + (e - d*q)*r rounds to e/d (Markstein's theorem), wherever e is 0 or
// at least kTiny (the remainder does not underflow). Three instructions
// where __fdiv_rn takes a call with a range check.
constexpr float kTiny = 0x1p-100f;
__device__ __forceinline__ float divide(float e, float d, float r) {
  const float q = __fmul_rn(e, r);
  return __fmaf_rn(__fmaf_rn(-d, q, e), r, q);
}

// The logits in s (fp32 accumulators of q.k^T) -> probabilities in place:
// scaled, key columns >= n set to -inf, max subtracted, exp, divided by the
// row's sum (IEEE division, as _attn_tile's `e / sum`: divide(), or
// __fdiv_rn for every value of a tile that holds an e below kTiny); tiles
// j >= KT8 stay zero. Lane (g, t) holds columns 8j + 2t, 8j + 2t + 1 of rows
// g (s[j][0..1]) and g + 8 (s[j][2..3]); a row's values lie in one quad.
template <int KT8>
__device__ __forceinline__ void softmax(float (&s)[2 * row_tiles(KT8)][4],
                                        float scale, int n, int lane) {
  const int t = lane & 3;
  float den[2];
  bool tiny = false;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < KT8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float x = __fmul_rn(s[j][2 * h + e], scale);
        // only the last key tile can hold columns >= n
        s[j][2 * h + e] =
            j + 1 < KT8 || 8 * j + 2 * t + e < n ? x : -INFINITY;
        mx = fmaxf(mx, s[j][2 * h + e]);
      }
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    den[h] = 0.f;
#pragma unroll
    for (int j = 0; j < KT8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float x = expf(s[j][2 * h + e] - mx);
        s[j][2 * h + e] = x;
        den[h] += x;
        tiny |= x > 0.f && x < kTiny;
      }
    }
    den[h] += __shfl_xor_sync(0xffffffffu, den[h], 1);
    den[h] += __shfl_xor_sync(0xffffffffu, den[h], 2);
  }
  if (__any_sync(0xffffffffu, tiny)) {
#pragma unroll
    for (int j = 0; j < KT8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = __fdiv_rn(s[j][e], den[e >> 1]);
    }
    return;
  }
  const float r[2] = {__frcp_rn(den[0]), __frcp_rn(den[1])};
#pragma unroll
  for (int j = 0; j < KT8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = divide(s[j][e], den[e >> 1], r[e >> 1]);
    }
  }
}

// Column tiles (n8, of hd) a product of the backward holds in registers at
// once: wider heads are taken in chunks, so that hd 56 and 64 fit the
// register cap at 63 tokens.
constexpr int kChunk = 4;

// f(J0, NJ) for the column tiles J0..J0+NJ-1 of each chunk of NT, as
// compile-time constants.
template <int NT, int J0 = 0, typename F>
__device__ __forceinline__ void for_chunks(F&& f) {
  if constexpr (J0 < NT) {
    f(std::integral_constant<int, J0>{},
      std::integral_constant<int, NT - J0 < kChunk ? NT - J0 : kChunk>{});
    for_chunks<NT, J0 + kChunk>(f);
  }
}

// acc[j] += sum_u a[u].y over one k16 step: rows k0..k0+15 of tile y (the
// k index), column tiles J0..J0+NJ-1 of its NT (ldmatrix .trans).
template <int NT, int J0, int NJ, int T>
__device__ __forceinline__ void mma_rows16(float (&acc)[NJ][4],
                                           const unsigned (&a)[T][4],
                                           unsigned y, int k0, int lane) {
  const int r = lane & 7, mi = lane >> 3;
  // (k 0-7, cols 8j..), (k 8-15, 8j..), (0-7, 8j+8..), (8-15, 8j+8..)
  const unsigned yb =
      y + ((k0 + r + (mi & 1) * 8) * row16(NT) + J0 + (mi >> 1)) * 16;
#pragma unroll
  for (int j = 0; j < NJ; j += 2) {
    if (j + 1 < NJ) {
      unsigned b[4];
      ldsm_x4_t(yb + j * 16, b);
#pragma unroll
      for (int u = 0; u < T; ++u) {
        mma_k16(acc[j], a[u], b[0], b[1]);
        mma_k16(acc[j + 1], a[u], b[2], b[3]);
      }
    } else {  // an .x2: lanes 0-15's addresses, those of yb
      unsigned b[2];
      ldsm_x2_t(yb + j * 16, b);
#pragma unroll
      for (int u = 0; u < T; ++u) mma_k16(acc[j], a[u], b[0], b[1]);
    }
  }
}

// As mma_rows16 over one k8 step: rows k0..k0+7 of tile y.
template <int NT, int J0, int NJ, int T>
__device__ __forceinline__ void mma_rows8(float (&acc)[NJ][4],
                                          const unsigned (&a)[T][2],
                                          unsigned y, int k0, int lane) {
  const unsigned yb = y + ((k0 + (lane & 7)) * row16(NT) + J0) * 16;
#pragma unroll
  for (int j = 0; j < NJ; j += 2) {
    if (j + 1 < NJ) {
      unsigned b[2];
      ldsm_x2_t(yb + (j + ((lane >> 3) & 1)) * 16, b);
#pragma unroll
      for (int u = 0; u < T; ++u) {
        mma_k8(acc[j], a[u], b[0]);
        mma_k8(acc[j + 1], a[u], b[1]);
      }
    } else {
      unsigned b;
      ldsm_x1_t(yb + j * 16, b);
#pragma unroll
      for (int u = 0; u < T; ++u) mma_k8(acc[j], a[u], b);
    }
  }
}

// The bf16 pair (x0, x1) as one register, x0 in the lower half.
__device__ __forceinline__ unsigned pack(float x0, float x1) {
  return as_u32(__floats2bfloat162_rn(x0, x1));
}

// acc = p.y over column tiles J0..J0+NJ-1: p the [16, 8*KT8] matrix in the
// accumulators p[j] (its columns the keys, the k index), y the tile whose
// rows are the keys. T = 1: p is cast to bf16 (#6's P); T = 2: p enters
// as hi + lo bf16 terms.
template <int KT8, int NT, int T, int J0, int NJ>
__device__ __forceinline__ void times_keys(
    float (&acc)[NJ][4], const float (&p)[2 * row_tiles(KT8)][4], unsigned y,
    int lane) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  }
#pragma unroll
  for (int kk = 0; kk < row_tiles(KT8); ++kk) {
    const float(&p0)[4] = p[2 * kk];
    const float(&p1)[4] = p[2 * kk + 1];
    unsigned a[T][4];
    if constexpr (T == 1) {
      a[0][0] = pack(p0[0], p0[1]);
      a[0][1] = pack(p0[2], p0[3]);
      a[0][2] = pack(p1[0], p1[1]);
      a[0][3] = pack(p1[2], p1[3]);
    } else {
      to_a(p0, p1, a[0], a[1]);
    }
    if (2 * kk + 1 < KT8) {
      mma_rows16<NT, J0, NJ, T>(acc, a, y, 16 * kk, lane);
    } else {  // a key tail of 8: keys 16kk..16kk+7
      unsigned a8[T][2];
#pragma unroll
      for (int u = 0; u < T; ++u) {
        a8[u][0] = a[u][0];
        a8[u][1] = a[u][1];
      }
      mma_rows8<NT, J0, NJ, T>(acc, a8, y, 16 * kk, lane);
    }
  }
}

// acc * scale cast to bf16 into columns J0.. of rows r0 + g and r0 + g + 8
// of the tile, the rows below ROWS only.
template <int NT, int ROWS, int J0, int NJ>
__device__ __forceinline__ void put(unsigned char* tile,
                                    const float (&acc)[NJ][4], float scale,
                                    int r0, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + g + 8 * h;
    if (r0 + 8 * h >= ROWS) continue;  // ROWS is a multiple of 8
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(
          tile + (r * row16(NT) + J0 + j) * 16 + t * 4) =
          __floats2bfloat162_rn(acc[j][2 * h] * scale,
                                acc[j][2 * h + 1] * scale);
    }
  }
}

// Where a lane keeps its float4 of the m16n8 accumulator tile (key tile
// jm, column tile j) in the warp's shared memory.
template <int NT>
__device__ __forceinline__ int slot(int jm, int j, int lane) {
  return (jm * NT + j) * 32 + lane;
}

// The contribution of query row tile I to a sum over query rows, p^T.x
// (dv = a^T.dO, dk = ds^T.q): p the tile's [16, keys] fp32 values, x the
// tile's 16 rows at shared address x, summed into the accumulator tiles in
// `acc` (the first row tile sets them). kPut: the last row tile's sums are
// not stored but scaled, cast and put into `out`, its 8 * KT8 rows.
template <int KT8, int NT, int I, bool kPut>
__device__ __forceinline__ void sum_rows_t(
    float4* acc, const float (&p)[2 * row_tiles(KT8)][4], unsigned x,
    unsigned char* out, float scale, int lane) {
#pragma unroll
  for (int jm = 0; jm < row_tiles(KT8); ++jm) {
    unsigned hi[4], lo[4], t[2][4];
    to_a(p[2 * jm], p[2 * jm + 1], hi, lo);
    transpose_a(hi, t[0]);
    transpose_a(lo, t[1]);
    for_chunks<NT>([&](auto j0, auto nj) {
      constexpr int J0 = decltype(j0)::value, NJ = decltype(nj)::value;
      float c[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float4 v = I > 0 ? acc[slot<NT>(jm, J0 + j, lane)]
                               : make_float4(0.f, 0.f, 0.f, 0.f);
        c[j][0] = v.x;
        c[j][1] = v.y;
        c[j][2] = v.z;
        c[j][3] = v.w;
      }
      mma_rows16<NT, J0, NJ, 2>(c, t, x, 0, lane);
      if constexpr (kPut) {
        put<NT, 8 * KT8, J0, NJ>(out, c, scale, 16 * jm, lane);
      } else {
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          acc[slot<NT>(jm, J0 + j, lane)] =
              make_float4(c[j][0], c[j][1], c[j][2], c[j][3]);
        }
      }
    });
  }
}

// The accumulator tiles in `acc` scaled, cast and put into `out`, its
// 8 * KT8 rows.
template <int KT8, int NT>
__device__ __forceinline__ void put_sums(const float4* acc,
                                         unsigned char* out, float scale,
                                         int lane) {
#pragma unroll
  for (int jm = 0; jm < row_tiles(KT8); ++jm) {
    for_chunks<NT>([&](auto j0, auto nj) {
      constexpr int J0 = decltype(j0)::value, NJ = decltype(nj)::value;
      float c[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float4 v = acc[slot<NT>(jm, J0 + j, lane)];
        c[j][0] = v.x;
        c[j][1] = v.y;
        c[j][2] = v.z;
        c[j][3] = v.w;
      }
      put<NT, 8 * KT8, J0, NJ>(out, c, scale, 16 * jm, lane);
    });
  }
}

// Row tile I of a forward unit whose tiles are staged at tq (q), sk (k) and
// sv (v), then the next: out_I into q's tile.
template <int KT8, int NT, int I>
__device__ __forceinline__ void fwd_rows(unsigned char* tq, unsigned sk,
                                         unsigned sv, int N, float scale,
                                         int lane) {
  constexpr int kRow = row_bytes(NT);
  float s[2 * row_tiles(KT8)][4];
  logits<KT8, NT>(s, smem_addr(tq) + 16 * I * kRow, sk, lane);
  softmax<KT8>(s, scale, N, lane);
  if constexpr (I == 0) {
    cp_async_wait<0>();  // v
    __syncwarp();
  }
  float acc[NT][4];
  times_keys<KT8, NT, 1, 0, NT>(acc, s, sv, lane);
  __syncwarp();  // every lane is done with q_I
  put<NT, 16 * row_tiles(KT8), 0, NT>(tq, acc, 1.f, 16 * I, lane);
  if constexpr (I + 1 < row_tiles(KT8)) {
    fwd_rows<KT8, NT, I + 1>(tq, sk, sv, N, scale, lane);
  }
}

// bwd_rows for row tile I as a call of its own: at the widest tiles
// (4 row tiles, hd 56 and 64) ptxas interleaves inlined row tiles past the
// register cap (spills); a call keeps each within it.
template <int KT8, int NT, int I>
__device__ __noinline__ void bwd_rows_call(unsigned char* tq,
                                           unsigned char* tk,
                                           unsigned char* tv, unsigned sd,
                                           float4* acc_v, int N, float scale,
                                           int lane);

// Row tile I of a backward unit whose tiles are staged at tq (q), tk (k),
// tv (v) and sd (dO), with its dv and dk accumulators, then the next: dq_I
// into q's tile; after the last row tile dv into v's tile and dk into k's.
template <int KT8, int NT, int I>
__device__ __forceinline__ void bwd_rows(unsigned char* tq, unsigned char* tk,
                                         unsigned char* tv, unsigned sd,
                                         float4* acc_v, int N, float scale,
                                         int lane) {
  constexpr int MT = row_tiles(KT8), kRow = row_bytes(NT);
  constexpr bool kLast = I + 1 == MT;
  float4* acc_k = acc_v + MT * NT * 32;
  const unsigned qi = smem_addr(tq) + 16 * I * kRow, di = sd + 16 * I * kRow;
  float a[2 * MT][4], ds[2 * MT][4];
  logits<KT8, NT>(a, qi, smem_addr(tk), lane);
  softmax<KT8>(a, scale, N, lane);
  if constexpr (I == 0) {
    cp_async_wait<0>();  // v and dO
    __syncwarp();
  }
  logits<KT8, NT>(ds, di, smem_addr(tv), lane);  // dp = dO_I.v^T
  const int gr = lane >> 2;
#pragma unroll
  for (int hf = 0; hf < 4; hf += 2) {  // rows g, then g + 8
    float d = 0.f;
#pragma unroll
    for (int j = 0; j < KT8; ++j) {
      d += ds[j][hf] * a[j][hf] + ds[j][hf + 1] * a[j][hf + 1];
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    d += __shfl_xor_sync(0xffffffffu, d, 2);
    const bool live = 16 * I + gr + 4 * hf < N;  // hf = 2: row g + 8
#pragma unroll
    for (int j = 0; j < KT8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        ds[j][hf + e] = live ? a[j][hf + e] * (ds[j][hf + e] - d) : 0.f;
        a[j][hf + e] = live ? a[j][hf + e] : 0.f;
      }
    }
  }
  if constexpr (kLast) __syncwarp();  // every lane is done with v (dp)
  sum_rows_t<KT8, NT, I, kLast>(acc_v, a, di, tv, 1.f, lane);  // dv
  // dk's sums stay in the accumulators: ds_I.k below still reads k's tile
  sum_rows_t<KT8, NT, I, false>(acc_k, ds, qi, tk, scale, lane);
  __syncwarp();  // every lane is done with q_I
  for_chunks<NT>([&](auto j0, auto nj) {  // dq_I = scale * ds_I.k
    constexpr int J0 = decltype(j0)::value, NJ = decltype(nj)::value;
    float dq[NJ][4];
    times_keys<KT8, NT, 2, J0, NJ>(dq, ds, smem_addr(tk), lane);
    put<NT, 16 * MT, J0, NJ>(tq, dq, scale, 16 * I, lane);
  });
  if constexpr (kLast) {
    __syncwarp();  // every lane is done with k
    put_sums<KT8, NT>(acc_k, tk, scale, lane);
  } else if constexpr (MT * NT > 24) {
    bwd_rows_call<KT8, NT, I + 1>(tq, tk, tv, sd, acc_v, N, scale, lane);
  } else {
    bwd_rows<KT8, NT, I + 1>(tq, tk, tv, sd, acc_v, N, scale, lane);
  }
}

template <int KT8, int NT, int I>
__device__ __noinline__ void bwd_rows_call(unsigned char* tq,
                                           unsigned char* tk,
                                           unsigned char* tv, unsigned sd,
                                           float4* acc_v, int N, float scale,
                                           int lane) {
  bwd_rows<KT8, NT, I>(tq, tk, tv, sd, acc_v, N, scale, lane);
}

// qkv [G, N, 3C] -> out [G, N, C]; unit = grid * heads + head.
template <int KT8, int NT>
__global__ void __launch_bounds__(kThreads, sm_blocks(KT8, NT, false))
packed_fwd(const bf16* __restrict__ qkv, bf16* __restrict__ out, int units,
           int N, int heads, float scale) {
  extern __shared__ uint4 smem[];
  constexpr int MT = row_tiles(KT8), kRow = row_bytes(NT);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int unit = blockIdx.x * (blockDim.x >> 5) + warp;
  if (unit >= units) return;
  const int g = unit / heads, h = unit - g * heads;
  const int C = heads * 8 * NT;
  unsigned char* tq = reinterpret_cast<unsigned char*>(smem) +
                      warp * warp_bytes(KT8, NT, false);
  const unsigned sk = smem_addr(tq) + 16 * MT * kRow,
                 sv = sk + 8 * KT8 * kRow;
  const bf16* src = qkv + static_cast<size_t>(g) * N * 3 * C + h * 8 * NT;
  stage<NT, 16 * MT>(smem_addr(tq), src, 3 * C, N, lane);
  stage<NT, 8 * KT8>(sk, src + C, 3 * C, N, lane);
  cp_async_commit();
  stage<NT, 8 * KT8>(sv, src + 2 * C, 3 * C, N, lane);
  cp_async_commit();
  cp_async_wait<1>();  // q and k
  __syncwarp();
  fwd_rows<KT8, NT, 0>(tq, sk, sv, N, scale, lane);
  __syncwarp();
  unstage<NT, 16 * MT>(out + static_cast<size_t>(g) * N * C + h * 8 * NT, C,
                       tq, N, lane);
}

// qkv [G, N, 3C], dout [G, N, C] -> dqkv [G, N, 3C].
template <int KT8, int NT>
__global__ void __launch_bounds__(kThreads, sm_blocks(KT8, NT, true))
packed_bwd(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
           bf16* __restrict__ dqkv, int units, int N, int heads,
           float scale) {
  extern __shared__ uint4 smem[];
  constexpr int MT = row_tiles(KT8), kRow = row_bytes(NT);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int unit = blockIdx.x * (blockDim.x >> 5) + warp;
  if (unit >= units) return;
  const int g = unit / heads, h = unit - g * heads;
  const int C = heads * 8 * NT;
  unsigned char* tq = reinterpret_cast<unsigned char*>(smem) +
                      warp * warp_bytes(KT8, NT, true);
  unsigned char* tk = tq + 16 * MT * kRow;
  unsigned char* tv = tk + 8 * KT8 * kRow;
  unsigned char* td = tv + 8 * KT8 * kRow;
  float4* acc_v = reinterpret_cast<float4*>(td + 16 * MT * kRow);
  const size_t row0 = static_cast<size_t>(g) * N;
  const bf16* src = qkv + row0 * 3 * C + h * 8 * NT;
  stage<NT, 16 * MT>(smem_addr(tq), src, 3 * C, N, lane);
  stage<NT, 8 * KT8>(smem_addr(tk), src + C, 3 * C, N, lane);
  cp_async_commit();
  stage<NT, 8 * KT8>(smem_addr(tv), src + 2 * C, 3 * C, N, lane);
  stage<NT, 16 * MT>(smem_addr(td), dout + row0 * C + h * 8 * NT, C, N,
                     lane);
  cp_async_commit();
  cp_async_wait<1>();  // q and k
  __syncwarp();
  bwd_rows<KT8, NT, 0>(tq, tk, tv, smem_addr(td), acc_v, N, scale, lane);
  __syncwarp();
  bf16* dst = dqkv + row0 * 3 * C + h * 8 * NT;
  unstage<NT, 16 * MT>(dst, 3 * C, tq, N, lane);
  unstage<NT, 8 * KT8>(dst + C, 3 * C, tk, N, lane);
  unstage<NT, 8 * KT8>(dst + 2 * C, 3 * C, tv, N, lane);
}

// One launch: its tensors, its (grid, head) units and its plan.
struct Launch {
  const bf16* qkv;
  const bf16* dout;  // the backward's
  bf16* out;         // out, or dqkv
  int units, N, heads;
  float scale;
  int warps, smem;
  cudaStream_t stream;
};

// f(v) with v in [Lo, Hi] as a compile-time constant.
template <int Lo, int Hi, typename F>
cudaError_t with_const(int v, F&& f) {
  if constexpr (Lo == Hi) {
    return f(std::integral_constant<int, Lo>{});
  } else {
    return v == Lo ? f(std::integral_constant<int, Lo>{})
                   : with_const<Lo + 1, Hi>(v, f);
  }
}

// The kernel for KT8 = ceil(N / 8) in [Lo, Hi] and NT = hd / 8 in [1, 8]:
// the instantiations a translation unit holds.
template <bool kBwd, int Lo, int Hi>
cudaError_t launch(int kt8, int nt, const Launch& a) {
  return with_const<Lo, Hi>(kt8, [&](auto k) {
    return with_const<1, 8>(nt, [&](auto n) {
      constexpr int KT8 = decltype(k)::value, NT = decltype(n)::value;
      const int blocks = (a.units + a.warps - 1) / a.warps;
      cudaError_t err;
      if constexpr (kBwd) {
        err = set_smem(packed_bwd<KT8, NT>, a.smem);
        if (err != cudaSuccess) return err;
        packed_bwd<KT8, NT><<<blocks, 32 * a.warps, a.smem, a.stream>>>(
            a.qkv, a.dout, a.out, a.units, a.N, a.heads, a.scale);
      } else {
        err = set_smem(packed_fwd<KT8, NT>, a.smem);
        if (err != cudaSuccess) return err;
        packed_fwd<KT8, NT><<<blocks, 32 * a.warps, a.smem, a.stream>>>(
            a.qkv, a.out, a.units, a.N, a.heads, a.scale);
      }
      return cudaGetLastError();
    });
  });
}

// The backward's launches by key tiles, one translation unit each (built in
// parallel): KT8 1-5 (N <= 40) and 6-8.
cudaError_t launch_bwd_short(int kt8, int nt, const Launch& a);
cudaError_t launch_bwd_long(int kt8, int nt, const Launch& a);

}  // namespace ogvt::packed
