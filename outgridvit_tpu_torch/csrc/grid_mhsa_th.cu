// Grid multi-head self-attention core at the head-chunked "th" shapes: grids
// of N = 16 tokens in bf16, head width hd a multiple of 8 up to 64; forward
// and recompute backward on mma.sync tensor-core tiles.
//
// Replaces the TPU kernel outgridvit_tpu/ops/grid_attention_pallas_t.py:
// grid_mhsa_pallas_th (#3): `_fwd_kernel_h` (th_fwd here) and `_bwd_kernel_h`
// (th_bwd), with their rounding points:
//   forward:  logits = q.k^T, bf16 products summed in fp32, then scaled;
//             a = softmax in fp32 (max subtracted, multiplied by 1/sum);
//             out = a.v with a kept in fp32, cast once;
//   backward: a recomputed; dp = dO.v^T; ds = a * (dp - sum_m dp*a) in fp32;
//             dq = scale * ds.k, dk = scale * ds^T.q, dv = a^T.dO, each cast
//             once.
// fp32 "th" launches are not this kernel's: the wrapper sends them to
// csrc/grid_mhsa.cu (ops/grid_attention.py:grid_mhsa).
//
// What bounds it on the H100: memory. Per grid it reads 16*3C elements and
// writes 16*C (forward) for 4*16*16*C flops, 8 flop/byte in bf16 (about 11 in
// the backward), far below the tensor cores' ~295. The floor is each input
// read once and each output written once at HBM rate.
//
// What the design does about it: one warp per (grid, head) unit and four
// units per block, with no barrier wider than a warp. A warp copies its
// head's [16, hd] slices of q, k, v (and dO) into shared memory as bf16 by
// 16-byte cp.async (q and k in a first group, so the logits start while v
// is in flight), at a row stride of an odd number of 16-byte units, so the
// 8 rows one ldmatrix reads fall in 8 distinct bank groups. 16 tokens are
// the M of one mma.sync.m16n8k16 tile:
//   - q.k^T and dO.v^T are bf16 mmas (exact products, fp32 sums), k-looped
//     over hd with an m16n8k8 step for the tail when hd % 16 == 8 (hd 56);
//   - the softmax runs in registers on the accumulator fragment: a row's 16
//     values lie in the 4 lanes of a quad (2 shuffles for the max, 2 for
//     the sum);
//   - a.v, ds.k, ds^T.q and a^T.dO take their fp32 left operand as two bf16
//     terms, hi = bf16(x) and lo = bf16(x - hi), two mmas into one fp32
//     accumulator (about 2^-17 relative per element; the probabilities are
//     never rounded to bf16, which is #6's rounding point, not #3's). The
//     accumulator fragment of a 16 x 16 product is the A fragment of the
//     next; the transposes a^T and ds^T are movmatrix in registers;
//   - each result is cast once into a shared tile the warp no longer reads
//     and leaves by 16-byte stores.
// Shared memory: 3 (forward) or 4 (backward) tiles of 16 * hd bf16 a warp,
// 15-27 KB (forward) and 20-36 KB (backward) a block; with the register
// caps below, 6-8 blocks (24-32 units) are resident on an SM. The launch
// plan is ops/grid_attention.py:grid_mhsa_th_plan; the entry points refuse
// any other. Every warp owns its unit's rows: no atomics, and two calls give
// bitwise-equal results.
#include <stdint.h>

#include <initializer_list>

#include "common.cuh"
#include "mma.cuh"

using namespace ogvt;

namespace {

using bf16 = __nv_bfloat16;

constexpr int kN = 16;      // tokens per grid: the M of one mma tile
constexpr int kWarps = 4;   // (grid, head) units per block, one per warp
constexpr int kThreads = 32 * kWarps;

__host__ __device__ constexpr int tile_bytes(int nt) {
  return kN * row16(nt) * 16;
}

// Copy the [16, hd] slice of 16 rows `ld` elements apart at `src` into the
// tile at shared address `tile`.
template <int NT>
__device__ __forceinline__ void stage(unsigned tile, const bf16* src, int ld,
                                      int lane) {
#pragma unroll
  for (int i = lane; i < kN * NT; i += 32) {
    const int r = i / NT, c = i - r * NT;
    cp_async16(tile + (r * row16(NT) + c) * 16,
               src + static_cast<size_t>(r) * ld + c * 8);
  }
}

// The tile back to the [16, hd] slice at `dst`, 16 bytes a lane.
template <int NT>
__device__ __forceinline__ void unstage(bf16* dst, int ld,
                                        const unsigned char* tile, int lane) {
#pragma unroll
  for (int i = lane; i < kN * NT; i += 32) {
    const int r = i / NT, c = i - r * NT;
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
// of rows g (s[j][0..1]) and g + 8 (s[j][2..3]).
__device__ __forceinline__ void softmax16(float (&s)[2][4], float scale) {
#pragma unroll
  for (int h = 0; h < 4; h += 2) {
    float x[4] = {__fmul_rn(s[0][h], scale), __fmul_rn(s[0][h + 1], scale),
                  __fmul_rn(s[1][h], scale), __fmul_rn(s[1][h + 1], scale)};
    float mx = fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    float den = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[i] = expf(x[i] - mx);
      den += x[i];
    }
    den += __shfl_xor_sync(0xffffffffu, den, 1);
    den += __shfl_xor_sync(0xffffffffu, den, 2);
    const float inv = 1.f / den;
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

// qkv [G, 16, 3C] -> out [G, 16, C]; unit = grid * heads + head.
template <int NT>
__global__ void __launch_bounds__(kThreads, 8)
th_fwd(const bf16* __restrict__ qkv, bf16* __restrict__ out, int units,
       int heads, float scale) {
  extern __shared__ uint4 smem[];
  constexpr int kTile = tile_bytes(NT);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int unit = blockIdx.x * kWarps + warp;
  if (unit >= units) return;
  const int g = unit / heads, h = unit - g * heads;
  const int C = heads * 8 * NT;
  unsigned char* tq = reinterpret_cast<unsigned char*>(smem) + warp * 3 * kTile;
  const unsigned sq = smem_addr(tq), sk = sq + kTile, sv = sk + kTile;
  const bf16* src = qkv + static_cast<size_t>(g) * kN * 3 * C + h * 8 * NT;
  stage<NT>(sq, src, 3 * C, lane);
  stage<NT>(sk, src + C, 3 * C, lane);
  cp_async_commit();
  stage<NT>(sv, src + 2 * C, 3 * C, lane);
  cp_async_commit();
  cp_async_wait<1>();
  __syncwarp();

  float s[2][4];
  product_t<NT>(s, sq, sk, lane);
  softmax16(s, scale);
  unsigned hi[4], lo[4];
  to_a(s[0], s[1], hi, lo);
  cp_async_wait<0>();
  __syncwarp();
  float acc[NT][4];
  product<NT>(acc, hi, lo, sv, lane);
  put<NT>(tq, acc, 1.f, lane);  // q's tile: its last read was the logits
  __syncwarp();
  unstage<NT>(out + static_cast<size_t>(g) * kN * C + h * 8 * NT, C, tq,
              lane);
}

// qkv [G, 16, 3C], dout [G, 16, C] -> dqkv [G, 16, 3C].
template <int NT>
__global__ void __launch_bounds__(kThreads, NT <= 4 ? 8 : 6)
th_bwd(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
       bf16* __restrict__ dqkv, int units, int heads, float scale) {
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
  const size_t row0 = static_cast<size_t>(g) * kN;
  const bf16* src = qkv + row0 * 3 * C + h * 8 * NT;
  stage<NT>(sq, src, 3 * C, lane);
  stage<NT>(sk, src + C, 3 * C, lane);
  cp_async_commit();
  stage<NT>(sv, src + 2 * C, 3 * C, lane);
  stage<NT>(sd, dout + row0 * C + h * 8 * NT, C, lane);
  cp_async_commit();
  cp_async_wait<1>();
  __syncwarp();

  float a[2][4];
  product_t<NT>(a, sq, sk, lane);
  softmax16(a, scale);
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
  unstage<NT>(dst, 3 * C, tq, lane);
  unstage<NT>(dst + C, 3 * C, td, lane);
  unstage<NT>(dst + 2 * C, 3 * C, tv, lane);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The launch this file takes: N = 16, hd = C / heads a multiple of 8 in
// [8, 64], kWarps warps and `tiles` tiles a warp of shared memory, 16-byte
// aligned pointers. Returns hd / 8, or 0 for anything else.
int plan_ok(int G, int N, int C, int heads, int warps, int smem, int tiles,
          std::initializer_list<const void*> ptrs) {
  if (G < 0 || N != kN || heads <= 0 || C % heads || warps != kWarps) {
    return 0;
  }
  const int hd = C / heads;
  if (hd % 8 || hd < 8 || hd > 64) return 0;
  if (smem != kWarps * tiles * tile_bytes(hd / 8)) return 0;
  for (const void* p : ptrs) {
    if (!aligned16(p)) return 0;
  }
  return hd / 8;
}

template <int NT>
cudaError_t launch_fwd(const void* qkv, void* out, int units, int heads,
                       float scale, int smem, cudaStream_t stream) {
  cudaError_t err = set_smem(th_fwd<NT>, smem);
  if (err != cudaSuccess) return err;
  th_fwd<NT><<<(units + kWarps - 1) / kWarps, kThreads, smem, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<bf16*>(out), units, heads,
      scale);
  return cudaGetLastError();
}

template <int NT>
cudaError_t launch_bwd(const void* qkv, const void* dout, void* dqkv,
                       int units, int heads, float scale, int smem,
                       cudaStream_t stream) {
  cudaError_t err = set_smem(th_bwd<NT>, smem);
  if (err != cudaSuccess) return err;
  th_bwd<NT><<<(units + kWarps - 1) / kWarps, kThreads, smem, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(dout),
      static_cast<bf16*>(dqkv), units, heads, scale);
  return cudaGetLastError();
}

}  // namespace

// qkv [G, 16, 3C] -> out [G, 16, C], both contiguous bf16; `warps` and
// `smem` (bytes a block) as grid_mhsa_th_plan gives them.
extern "C" int ogvt_grid_mhsa_th(const void* qkv, void* out, int G, int N,
                                 int C, int heads, float scale, int warps,
                                 int smem, int dtype, void* stream) {
  const int nt = dtype == kBFloat16
                     ? plan_ok(G, N, C, heads, warps, smem, 3, {qkv, out})
                     : 0;
  if (nt == 0) return cudaErrorInvalidValue;
  if (G == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int units = G * heads;
  switch (nt) {
    case 1: return launch_fwd<1>(qkv, out, units, heads, scale, smem, s);
    case 2: return launch_fwd<2>(qkv, out, units, heads, scale, smem, s);
    case 3: return launch_fwd<3>(qkv, out, units, heads, scale, smem, s);
    case 4: return launch_fwd<4>(qkv, out, units, heads, scale, smem, s);
    case 5: return launch_fwd<5>(qkv, out, units, heads, scale, smem, s);
    case 6: return launch_fwd<6>(qkv, out, units, heads, scale, smem, s);
    case 7: return launch_fwd<7>(qkv, out, units, heads, scale, smem, s);
    default: return launch_fwd<8>(qkv, out, units, heads, scale, smem, s);
  }
}

// qkv [G, 16, 3C], dout [G, 16, C] -> dqkv [G, 16, 3C], all contiguous
// bf16; `warps` and `smem` as grid_mhsa_th_plan gives them.
extern "C" int ogvt_grid_mhsa_th_bwd(const void* qkv, const void* dout,
                                     void* dqkv, int G, int N, int C,
                                     int heads, float scale, int warps,
                                     int smem, int dtype, void* stream) {
  const int nt =
      dtype == kBFloat16
          ? plan_ok(G, N, C, heads, warps, smem, 4, {qkv, dout, dqkv})
          : 0;
  if (nt == 0) return cudaErrorInvalidValue;
  if (G == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int units = G * heads;
  switch (nt) {
    case 1: return launch_bwd<1>(qkv, dout, dqkv, units, heads, scale, smem, s);
    case 2: return launch_bwd<2>(qkv, dout, dqkv, units, heads, scale, smem, s);
    case 3: return launch_bwd<3>(qkv, dout, dqkv, units, heads, scale, smem, s);
    case 4: return launch_bwd<4>(qkv, dout, dqkv, units, heads, scale, smem, s);
    case 5: return launch_bwd<5>(qkv, dout, dqkv, units, heads, scale, smem, s);
    case 6: return launch_bwd<6>(qkv, dout, dqkv, units, heads, scale, smem, s);
    case 7: return launch_bwd<7>(qkv, dout, dqkv, units, heads, scale, smem, s);
    default:
      return launch_bwd<8>(qkv, dout, dqkv, units, heads, scale, smem, s);
  }
}
