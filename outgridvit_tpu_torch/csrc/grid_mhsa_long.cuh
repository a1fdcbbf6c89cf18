// The bf16 tensor-core helpers of #6's kernels for long grids: the exact
// softmax passes over key tiles of 16 on mma.sync, shared by
// csrc/grid_mhsa_long.cu (64 <= N <= 256, a head's whole grid a block)
// and csrc/grid_mhsa_tiles.cu (N > 256, a head's query rows split over
// blocks, the keys streamed). Staged tiles hold rows of hd = 8 * NT bf16
// values at a stride of row_bytes(NT), an odd number of 16-byte units
// (ldmatrix without bank conflicts).
#pragma once

#include <stdint.h>

#include <type_traits>

#include "grid_mhsa_packed_mma.cuh"

namespace ogvt::longk {

using bf16 = __nv_bfloat16;

__host__ __device__ constexpr int row_bytes(int nt) { return row16(nt) * 16; }

// Copy rows [0, rows) of the [*, hd] slice at `src` (rows `ld` elements
// apart) into the tile at shared address `tile`, the whole block; rows >= n
// are zero-filled.
template <int NT>
__device__ __forceinline__ void stage(unsigned tile, const bf16* src, int ld,
                                      int n, int rows) {
  for (int i = threadIdx.x; i < rows * NT; i += blockDim.x) {
    const int r = i / NT, c = i - r * NT;
    const bool live = r < n;
    cp_async16_zfill(tile + (r * row16(NT) + c) * 16,
                     src + static_cast<size_t>(live ? r : 0) * ld + c * 8,
                     live ? 16 : 0);
  }
}

// Rows [r0, r0 + 16) of the tile, those below n, back to the slice at `dst`,
// 16 bytes a lane.
template <int NT>
__device__ __forceinline__ void unstage(bf16* dst, int ld,
                                        const unsigned char* tile, int r0,
                                        int n, int lane) {
  for (int i = lane; i < 16 * NT; i += 32) {
    const int r = r0 + i / NT, c = i % NT;
    if (r >= n) break;
    *reinterpret_cast<uint4*>(dst + static_cast<size_t>(r) * ld + c * 8) =
        *reinterpret_cast<const uint4*>(tile + (r * row16(NT) + c) * 16);
  }
}

// The A fragments of 16 rows of a staged tile, all hd: a k16 step per pair
// of 8-column units, and the k8 tail when NT is odd.
template <int NT>
struct Frag {
  unsigned a[NT / 2 > 0 ? NT / 2 : 1][4];
  unsigned t[2];
};

template <int NT>
__device__ __forceinline__ void load_frag(Frag<NT>& f, unsigned x, int lane) {
  const int r = lane & 7, mi = lane >> 3;
  // (rows 0-7, k 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15)
  const unsigned xa = x + ((r + (mi & 1) * 8) * row16(NT) + (mi >> 1)) * 16;
#pragma unroll
  for (int kc = 0; kc + 1 < NT; kc += 2) ldsm_x4(xa + kc * 16, f.a[kc / 2]);
  if constexpr (NT & 1) ldsm_x2(xa + (NT - 1) * 16, f.t);  // rows 0-7, 8-15
}

// s = x.y^T for the 16 rows whose fragments are f and the 16 rows of the
// tile at shared address y (two n8 tiles of columns); bf16 products summed
// in fp32. Lane (g, t) holds columns 8j + 2t, 8j + 2t + 1 of rows g
// (s[j][0..1]) and g + 8 (s[j][2..3]).
template <int NT>
__device__ __forceinline__ void scores(float (&s)[2][4], const Frag<NT>& f,
                                       unsigned y, int lane) {
  const int r = lane & 7, mi = lane >> 3;
  // (cols 0-7, k 0-7), (0-7, 8-15), (8-15, 0-7), (8-15, 8-15)
  const unsigned yb = y + ((r + (mi >> 1) * 8) * row16(NT) + (mi & 1)) * 16;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  }
#pragma unroll
  for (int kc = 0; kc + 1 < NT; kc += 2) {
    unsigned b[4];
    ldsm_x4(yb + kc * 16, b);
    mma_k16(s[0], f.a[kc / 2], b[0], b[1]);
    mma_k16(s[1], f.a[kc / 2], b[2], b[3]);
  }
  if constexpr (NT & 1) {  // the k8 tail of hd: cols 0-7, cols 8-15
    unsigned b[2];
    ldsm_x2(y + ((lane & 15) * row16(NT) + NT - 1) * 16, b);
    mma_k8(s[0], f.t, b[0]);
    mma_k8(s[1], f.t, b[1]);
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// f(c, mask) for the tiles c of 16 rows that cover [0, n): the full ones
// with mask false, then the partial last one (n % 16 != 0) with mask true,
// whose columns >= n the caller masks out.
template <typename F>
__device__ __forceinline__ void for_tiles(int n, F&& f) {
  const int full = n >> 4;
  for (int c = 0; c < full; ++c) f(c, std::false_type{});
  if (full << 4 < n) f(full, std::true_type{});
}

// Whether the lane's value (j, v) of tile c lies in a column below n.
template <typename Mask>
__device__ __forceinline__ bool live(Mask, int c, int j, int v, int n,
                                     int lane) {
  return !Mask::value || 16 * c + 8 * j + 2 * (lane & 3) + (v & 1) < n;
}

// exp(s * scale - m): the logit scaled after its sum and the max
// subtracted, no contraction into an fma; 0 where `on` is false.
__device__ __forceinline__ float expo(float s, float scale, float m,
                                      bool on) {
  return on ? expf(__fmul_rn(s, scale) - m) : 0.f;
}

// e[j][v] / l[j][v] for the 8 values of a tile, by IEEE division:
// packed::divide with the reciprocals r, or __fdiv_rn for every value when
// any lane holds an exponential below packed::kTiny (divide()'s remainder
// could underflow there).
__device__ __forceinline__ void normalise(float (&e)[2][4],
                                         const float (&l)[2][4],
                                         const float (&r)[2][4]) {
  bool tiny = false;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      tiny |= e[j][v] > 0.f && e[j][v] < packed::kTiny;
    }
  }
  if (__any_sync(0xffffffffu, tiny)) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int v = 0; v < 4; ++v) e[j][v] = __fdiv_rn(e[j][v], l[j][v]);
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      e[j][v] = packed::divide(e[j][v], l[j][v], r[j][v]);
    }
  }
}

// The statistics of rows g (index 0) and g + 8 (index 1) spread over a
// tile's 8 values: the max m, the sum l and its reciprocal r (__frcp_rn(l),
// computed here or given).
struct RowStats {
  float m[2][4], l[2][4], r[2][4];
  __device__ __forceinline__ RowStats(const float (&mr)[2],
                                      const float (&lr)[2]) {
    const float rr[2] = {__frcp_rn(lr[0]), __frcp_rn(lr[1])};
    spread(mr, lr, rr);
  }
  __device__ __forceinline__ RowStats(const float (&mr)[2],
                                      const float (&lr)[2],
                                      const float (&rr)[2]) {
    spread(mr, lr, rr);
  }
  __device__ __forceinline__ void spread(const float (&mr)[2],
                                         const float (&lr)[2],
                                         const float (&rr)[2]) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        m[j][v] = mr[v >> 1];
        l[j][v] = lr[v >> 1];
        r[j][v] = rr[v >> 1];
      }
    }
  }
};

// s (the logits of tile c) -> a = exp(s * scale - m) / l with the rows'
// statistics; masked columns (>= n) give 0.
template <typename Mask>
__device__ __forceinline__ void row_probs(float (&s)[2][4], float scale,
                                          const RowStats& st, Mask mask,
                                          int c, int n, int lane) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      s[j][v] = expo(s[j][v], scale, st.m[j][v],
                     live(mask, c, j, v, n, lane));
    }
  }
  normalise(s, st.l, st.r);
}

// acc[j] (column tile j of hd) as bf16, times `scale`, into rows r0 + g and
// r0 + g + 8 of the tile.
template <int NT>
__device__ __forceinline__ void put(unsigned char* tile,
                                    const float (&acc)[NT][4], float scale,
                                    int r0, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + g + 8 * h;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(tile + (r * row16(NT) + j) * 16 +
                                         t * 4) =
          __floats2bfloat162_rn(acc[j][2 * h] * scale,
                                acc[j][2 * h + 1] * scale);
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  }
}

}  // namespace ogvt::longk
