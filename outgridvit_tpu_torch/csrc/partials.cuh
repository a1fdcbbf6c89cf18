// Helpers of the backward kernels' deterministic parameter-gradient sums:
// fp32 copies of transposed weights, and the in-order reduction of per-block
// fp32 partials (no float atomics, so two calls give bitwise-equal sums).
#pragma once

#include "common.cuh"

namespace ogvt {

constexpr int kPartialThreads = 256;

// dst [cols, rows] fp32 = src [rows, cols] transposed.
template <typename T>
__global__ void transpose_f32(const T* __restrict__ src, int rows, int cols,
                              float* __restrict__ dst) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= static_cast<long long>(rows) * cols) return;
  const int r = static_cast<int>(i / cols), c = static_cast<int>(i % cols);
  dst[static_cast<size_t>(c) * rows + r] = to_f32(src[i]);
}

template <typename T>
cudaError_t transpose(const void* src, int rows, int cols, float* dst,
                      cudaStream_t stream) {
  const long long n = static_cast<long long>(rows) * cols;
  transpose_f32<T><<<static_cast<int>((n + kPartialThreads - 1) /
                                      kPartialThreads),
                     kPartialThreads, 0, stream>>>(
      static_cast<const T*>(src), rows, cols, dst);
  return cudaGetLastError();
}

// out[i] = sum_{s < S} ws[s * stride + i], in order of s.
template <typename Tout>
__global__ void reduce_partials(const float* __restrict__ ws, int S,
                                long long stride, int n,
                                Tout* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < S; ++k) s += ws[k * stride + i];
  out[i] = from_f32<Tout>(s);
}

template <typename Tout>
cudaError_t reduce(const float* ws, int S, long long stride, int n, void* out,
                   cudaStream_t stream) {
  reduce_partials<Tout><<<(n + kPartialThreads - 1) / kPartialThreads,
                          kPartialThreads, 0, stream>>>(
      ws, S, stride, n, static_cast<Tout*>(out));
  return cudaGetLastError();
}

}  // namespace ogvt
