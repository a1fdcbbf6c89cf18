// Shared helpers for the OutGridViT CUDA kernels: element-type conversion,
// the dtype codes the Python wrappers pass (0 = float32, 1 = bfloat16), warp
// reductions, the block-wide product from shared memory, the row softmax and
// the dynamic shared-memory opt-in.
#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <cuda_runtime.h>

namespace ogvt {

enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

// Round an fp32 value to T's precision and back: marks the points where the
// reference casts an intermediate to the compute dtype.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  return v;
}

// out[r][j] = sum_k round_to<TA>(A[r*asr + k*ask]) * B[k*bsk + j*bsj] for
// r < R, j < J, handed to epi(r, j, sum). A is fp32 in shared memory (TA
// marks an operand that the reference rounds to the compute type), B is of
// type TB in shared or global memory. A thread owns one column j and RT
// consecutive rows: each B element it loads feeds RT FMAs, and the threads
// of a warp (consecutive j, the same rows) read A as a broadcast.
template <int RT, typename TA, typename TB, typename Epi>
__device__ __forceinline__ void block_gemm(const float* A, int asr, int ask,
                                           int R, int K, const TB* B, int bsk,
                                           int bsj, int J, Epi epi) {
  const int groups = (R + RT - 1) / RT;
  for (int item = threadIdx.x; item < groups * J; item += blockDim.x) {
    const int j = item % J;
    const int r0 = (item / J) * RT;
    int row[RT];
    float acc[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      row[i] = min(r0 + i, R - 1) * asr;
      acc[i] = 0.f;
    }
    const TB* b = B + j * bsj;
    for (int k = 0; k < K; ++k) {
      const float bv = to_f32(b[k * bsk]);
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        acc[i] = fmaf(round_to<TA>(A[row[i] + k * ask]), bv, acc[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      if (r0 + i < R) epi(r0 + i, j, acc[i]);
    }
  }
}

// Softmax over the N columns of rows [0, R) of s (row stride ld), one warp
// per row: fp32, max subtracted, divided by the sum; cast to T when `round`
// (the P.V operand of the fused branch and of the block-packed core).
template <typename T>
__device__ void softmax_rows(float* s, int ld, int R, int N, bool round) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < R; r += blockDim.x / 32) {
    float* row = s + r * ld;
    float mx = -INFINITY;
    for (int m = lane; m < N; m += 32) mx = fmaxf(mx, row[m]);
    mx = warp_max(mx);
    float den = 0.f;
    for (int m = lane; m < N; m += 32) {
      row[m] = expf(row[m] - mx);
      den += row[m];
    }
    den = warp_sum(den);
    for (int m = lane; m < N; m += 32) {
      const float p = row[m] / den;
      row[m] = round ? round_to<T>(p) : p;
    }
  }
}

// Above 48 KB a kernel must opt in to its dynamic shared memory.
template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace ogvt
