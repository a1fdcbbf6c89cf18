// Grid multi-head self-attention core for tiny token grids (N <= 16).
//
// Replaces the TPU kernel outgridvit_tpu/ops/grid_attention_pallas_t.py:
// grid_mhsa_pallas_t (forward half, `_fwd_kernel`). For each grid g and head
// h: out[g, n, h*hd:(h+1)*hd] = softmax_m(q_n . k_m * hd^-1/2) v_m, with the
// q.k sum in fp32 and scaled after the sum, an fp32 softmax with max
// subtraction, and the P.V sum in fp32 cast to the output type once.
//
// What bounds it on the H100: memory. Per grid it reads N*3C elements and
// writes N*C (8*N*C bytes in bf16) for about 4*N*N*C flops: N/2 flop/byte,
// 8 at N=16 and 2 at N=4, far below the ~295 flop/byte ridge and below the
// fp32 FMA pipe's ~20. The time floor is the qkv read plus the out write at
// HBM rate.
//
// What the design does about it: the natural row-major [G, N, 3C] layout
// (no boundary transposes, unlike the TPU kernel's [N*3C, G]) is read once,
// coalesced, into shared memory as fp32 (<= 12 KB at every Model A-7M
// shape); logits, softmax and P.V then run entirely from shared memory and
// the output is written once, coalesced. One block per grid; threads cover
// (head, n, m) for the logits and (n, channel) for the output.
#include "common.cuh"

using namespace ogvt;

namespace {

constexpr int kThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
grid_mhsa_fwd(const T* __restrict__ qkv, T* __restrict__ out, int N, int C,
              int heads, float scale) {
  extern __shared__ float smem[];
  const int C3 = 3 * C;
  const int hd = C / heads;
  const int NN = N * N;
  float* s_qkv = smem;           // [N, 3C]: q | k | v, heads contiguous
  float* s_p = smem + N * C3;    // [heads, N, N] logits, then probabilities

  const size_t g = blockIdx.x;
  const T* src = qkv + g * static_cast<size_t>(N) * C3;
  for (int i = threadIdx.x; i < N * C3; i += blockDim.x) {
    s_qkv[i] = to_f32(src[i]);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < heads * NN; i += blockDim.x) {
    const int h = i / NN;
    const int n = (i / N) % N;
    const int m = i % N;
    const float* q = s_qkv + n * C3 + h * hd;
    const float* k = s_qkv + m * C3 + C + h * hd;
    float acc = 0.f;
    for (int d = 0; d < hd; ++d) acc = fmaf(q[d], k[d], acc);
    s_p[i] = acc * scale;
  }
  __syncthreads();

  for (int r = threadIdx.x; r < heads * N; r += blockDim.x) {
    float* row = s_p + r * N;
    float mx = row[0];
    for (int m = 1; m < N; ++m) mx = fmaxf(mx, row[m]);
    float den = 0.f;
    for (int m = 0; m < N; ++m) {
      const float e = expf(row[m] - mx);
      row[m] = e;
      den += e;
    }
    const float inv = 1.f / den;
    for (int m = 0; m < N; ++m) row[m] *= inv;
  }
  __syncthreads();

  T* dst = out + g * static_cast<size_t>(N) * C;
  for (int i = threadIdx.x; i < N * C; i += blockDim.x) {
    const int n = i / C;
    const int c = i % C;
    const float* p = s_p + ((c / hd) * N + n) * N;
    const float* v = s_qkv + 2 * C + c;
    float acc = 0.f;
    for (int m = 0; m < N; ++m) acc = fmaf(p[m], v[m * C3], acc);
    dst[i] = from_f32<T>(acc);
  }
}

template <typename T>
cudaError_t launch(const void* qkv, void* out, int G, int N, int C, int heads,
                   float scale, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(N * 3 * C + heads * N * N) *
                      sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        grid_mhsa_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  grid_mhsa_fwd<T><<<G, kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), N, C, heads, scale);
  return cudaGetLastError();
}

}  // namespace

// qkv [G, N, 3C] -> out [G, N, C], both contiguous, of type `dtype`.
extern "C" int ogvt_grid_mhsa(const void* qkv, void* out, int G, int N, int C,
                              int heads, float scale, int dtype,
                              void* stream) {
  if (G <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch<float>(qkv, out, G, N, C, heads, scale, s);
    case kBFloat16:
      return launch<__nv_bfloat16>(qkv, out, G, N, C, heads, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}
