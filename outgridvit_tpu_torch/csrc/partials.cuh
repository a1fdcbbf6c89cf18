// Helpers of the backward kernels' deterministic parameter-gradient sums:
// fp32 copies of transposed weights, and the in-order reduction of per-block
// fp32 partials, one output a launch or several in one (no float atomics,
// so two calls give bitwise-equal sums).
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

// Several reductions as reduce() computes them, in one launch: output y of
// the grid (blockIdx.y) sums the `count` partials of `src`, `stride` floats
// apart, over its n elements, and writes them as bf16 or fp32 (f32).
struct Seg {
  const float* src;
  int count;
  long long stride;
  int n;
  void* out;
  int f32;
};

template <int K>
struct Segs {
  Seg s[K];
};

template <int K>
__global__ void reduce_segments_kernel(Segs<K> segs) {
  const Seg sg = segs.s[blockIdx.y];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= sg.n) return;
  float acc = 0.f;
  for (int k = 0; k < sg.count; ++k) acc += sg.src[k * sg.stride + i];
  if (sg.f32) {
    static_cast<float*>(sg.out)[i] = acc;
  } else {
    static_cast<__nv_bfloat16*>(sg.out)[i] = from_f32<__nv_bfloat16>(acc);
  }
}

// `max_n`: the longest output's n.
template <int K>
cudaError_t reduce_segments(const Segs<K>& segs, int max_n,
                            cudaStream_t stream) {
  const dim3 grid((max_n + kPartialThreads - 1) / kPartialThreads, K);
  reduce_segments_kernel<K><<<grid, kPartialThreads, 0, stream>>>(segs);
  return cudaGetLastError();
}

}  // namespace ogvt
