// Grid multi-head self-attention core for grids of 16 < N < 64 tokens
// (takes 1 <= N <= 63) in fp32, forward and backward: the parity path. bf16
// launches take csrc/grid_mhsa_packed_mma.cu.
//
// Replaces the TPU kernel outgridvit_tpu/ops/grid_attention_pallas.py:
// grid_mhsa_pallas (#6): `_fwd_kernel` / `_attn_tile` (packed_fwd here) and
// `_bwd_kernel` (packed_bwd), with their rounding points:
//   forward:  per grid and head, logits = q.k^T summed in fp32, then scaled;
//             a = softmax (max subtracted, divided by the sum); out = a.v,
//             P.V summed in fp32 (in fp32 the cast of a to the compute type
//             before P.V is exact);
//   backward: a recomputed by division and kept in fp32; dv = a^T.dO;
//             dp = dO.v^T; ds = a * (dp - sum_m dp*a); dq = scale * ds.k,
//             dk = scale * ds^T.q.
// The TPU kernel packs 32 // N grids of N < 16 tokens block-diagonally under
// a -1e30 mask to widen its matrix-unit products. exp of a masked logit is
// exactly 0 in fp32, so packing changes the layout and not the result; this
// kernel packs nothing.
//
// What bounds it on the H100: memory. Per grid it reads N*3C elements and
// writes N*C (forward) for about 4*N*N*C flops: N/4 flop/byte in fp32, 9 at
// N = 36, below the fp32 FMA pipe's ~20. The floor is the qkv read plus the
// out write at HBM rate.
//
// What the design does about it: one block per grid reads its rows once, one
// head at a time, into shared memory (rows padded by one float so
// that column walks do not collide in one bank), and writes each head's
// output columns once. Staging one head rather than all (as csrc/grid_mhsa.cu
// does for N <= 16) keeps the block within the 227 KB of shared memory at
// every head width the configs use: 3*N*(hd+1) + N*(N+1) floats forward,
// 64 KB at N = 63, hd = 64 (98 KB backward). The products are block_gemm's
// register-tiled loops.
// Every block owns its grid's rows, so no atomics are needed and two calls
// give bitwise-equal results.
#include "common.cuh"

using namespace ogvt;

namespace {

constexpr int kThreads = 256;
constexpr int kRT = 4;
constexpr size_t kMaxSmem = 227 * 1024;

size_t fwd_smem_floats(int N, int hd) {
  return 3 * static_cast<size_t>(N) * (hd + 1) +
         static_cast<size_t>(N) * (N + 1);
}

size_t bwd_smem_floats(int N, int hd) {
  return 4 * static_cast<size_t>(N) * (hd + 1) +
         2 * static_cast<size_t>(N) * (N + 1);
}

// Copy head h's columns of `parts` consecutive C-wide parts of each of the N
// rows of src (row stride ld_src) into parts [N, ld] fp32 tiles.
__device__ void load_head(const float* __restrict__ src, int ld_src, int N,
                          int C, int hd, int h, int parts, float* dst,
                          int ld) {
  const int per = N * hd;
  for (int i = threadIdx.x; i < parts * per; i += blockDim.x) {
    const int part = i / per, r = i % per;
    const int n = r / hd, d = r % hd;
    dst[part * N * ld + n * ld + d] =
        src[static_cast<size_t>(n) * ld_src + part * C + h * hd + d];
  }
}

__global__ void __launch_bounds__(kThreads)
packed_fwd(const float* __restrict__ qkv, float* __restrict__ out, int N, int C,
           int heads, float scale) {
  extern __shared__ float smem[];
  const int C3 = 3 * C, hd = C / heads;
  const int ld = hd + 1, lp = N + 1;
  float* s_q = smem;           // [N, ld] one head's q | k | v
  float* s_k = s_q + N * ld;
  float* s_v = s_k + N * ld;
  float* s_p = s_v + N * ld;   // [N, lp] logits, then a

  const size_t g = blockIdx.x;
  const float* src = qkv + g * N * C3;
  float* dst = out + g * N * C;
  for (int h = 0; h < heads; ++h) {
    load_head(src, C3, N, C, hd, h, 3, s_q, ld);
    __syncthreads();
    block_gemm<kRT, float>(s_q, ld, 1, N, hd, s_k, 1, ld, N,
                           [&](int n, int m, float acc) {
                             s_p[n * lp + m] = acc * scale;
                           });
    __syncthreads();
    softmax_rows<float>(s_p, lp, N, N, false);
    __syncthreads();
    block_gemm<kRT, float>(s_p, lp, 1, N, N, s_v, ld, 1, hd,
                           [&](int n, int d, float acc) {
                             dst[n * C + h * hd + d] = acc;
                           });
    __syncthreads();  // before the next head overwrites the tiles
  }
}

__global__ void __launch_bounds__(kThreads)
packed_bwd(const float* __restrict__ qkv, const float* __restrict__ dout,
           float* __restrict__ dqkv, int N, int C, int heads, float scale) {
  extern __shared__ float smem[];
  const int C3 = 3 * C, hd = C / heads;
  const int ld = hd + 1, lp = N + 1;
  float* s_q = smem;            // [N, ld] one head's q | k | v
  float* s_k = s_q + N * ld;
  float* s_v = s_k + N * ld;
  float* s_do = s_v + N * ld;   // [N, ld] its dO
  float* s_a = s_do + N * ld;   // [N, lp] logits, then a (fp32)
  float* s_ds = s_a + N * lp;   // [N, lp] dp, then ds
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  const size_t g = blockIdx.x;
  const float* src = qkv + g * N * C3;
  const float* gsrc = dout + g * N * C;
  float* dst = dqkv + g * N * C3;
  for (int h = 0; h < heads; ++h) {
    load_head(src, C3, N, C, hd, h, 3, s_q, ld);
    load_head(gsrc, C, N, C, hd, h, 1, s_do, ld);
    __syncthreads();
    block_gemm<kRT, float>(s_q, ld, 1, N, hd, s_k, 1, ld, N,
                           [&](int n, int m, float acc) {
                             s_a[n * lp + m] = acc * scale;
                           });
    block_gemm<kRT, float>(s_do, ld, 1, N, hd, s_v, 1, ld, N,
                           [&](int n, int m, float acc) {
                             s_ds[n * lp + m] = acc;
                           });
    __syncthreads();
    softmax_rows<float>(s_a, lp, N, N, false);
    __syncthreads();
    // ds = a * (dp - sum_m dp*a), one warp per row
    for (int r = warp; r < N; r += blockDim.x / 32) {
      const float* ar = s_a + r * lp;
      float* dr = s_ds + r * lp;
      float s = 0.f;
      for (int m = lane; m < N; m += 32) s = fmaf(dr[m], ar[m], s);
      s = warp_sum(s);
      for (int m = lane; m < N; m += 32) dr[m] = ar[m] * (dr[m] - s);
    }
    __syncthreads();
    const int o = h * hd;
    // dv = a^T.dO, dq = scale * ds.k, dk = scale * ds^T.q
    block_gemm<kRT, float>(s_a, 1, lp, N, N, s_do, ld, 1, hd,
                           [&](int m, int d, float acc) {
                             dst[m * C3 + 2 * C + o + d] = acc;
                           });
    block_gemm<kRT, float>(s_ds, lp, 1, N, N, s_k, ld, 1, hd,
                           [&](int n, int d, float acc) {
                             dst[n * C3 + o + d] = acc * scale;
                           });
    block_gemm<kRT, float>(s_ds, 1, lp, N, N, s_q, ld, 1, hd,
                           [&](int m, int d, float acc) {
                             dst[m * C3 + C + o + d] =
                                 acc * scale;
                           });
    __syncthreads();  // before the next head overwrites the tiles
  }
}

bool shape_ok(int G, int N, int C, int heads) {
  return G >= 0 && N >= 1 && N <= 63 && C >= 1 && heads >= 1 &&
         C % heads == 0;
}

cudaError_t launch_fwd(const void* qkv, void* out, int G, int N, int C,
                       int heads, float scale, cudaStream_t stream) {
  const size_t smem = fwd_smem_floats(N, C / heads) * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = set_smem(packed_fwd, smem);
  if (err != cudaSuccess) return err;
  packed_fwd<<<G, kThreads, smem, stream>>>(
      static_cast<const float*>(qkv), static_cast<float*>(out), N, C, heads,
      scale);
  return cudaGetLastError();
}

cudaError_t launch_bwd(const void* qkv, const void* dout, void* dqkv, int G,
                       int N, int C, int heads, float scale,
                       cudaStream_t stream) {
  const size_t smem = bwd_smem_floats(N, C / heads) * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = set_smem(packed_bwd, smem);
  if (err != cudaSuccess) return err;
  packed_bwd<<<G, kThreads, smem, stream>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(dout),
      static_cast<float*>(dqkv), N, C, heads, scale);
  return cudaGetLastError();
}

}  // namespace

// qkv [G, N, 3C] -> out [G, N, C], both contiguous fp32 (`dtype` 0).
extern "C" int ogvt_grid_mhsa_packed(const void* qkv, void* out, int G, int N,
                                     int C, int heads, float scale, int dtype,
                                     void* stream) {
  if (!shape_ok(G, N, C, heads)) return cudaErrorInvalidValue;
  if (G == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != kFloat32) return cudaErrorInvalidValue;
  return launch_fwd(qkv, out, G, N, C, heads, scale, s);
}

// qkv [G, N, 3C], dout [G, N, C] -> dqkv [G, N, 3C], all contiguous fp32
// (`dtype` 0).
extern "C" int ogvt_grid_mhsa_packed_bwd(const void* qkv, const void* dout,
                                         void* dqkv, int G, int N, int C,
                                         int heads, float scale, int dtype,
                                         void* stream) {
  if (!shape_ok(G, N, C, heads)) return cudaErrorInvalidValue;
  if (G == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != kFloat32) return cudaErrorInvalidValue;
  return launch_bwd(qkv, dout, dqkv, G, N, C, heads, scale, s);
}
