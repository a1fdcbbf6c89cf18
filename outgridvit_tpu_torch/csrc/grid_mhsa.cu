// Grid multi-head self-attention core for tiny token grids (N <= 16).
//
// Replaces the TPU kernel outgridvit_tpu/ops/grid_attention_pallas_t.py:
// grid_mhsa_pallas_t: `_fwd_kernel` here, `_bwd_kernel` below (grid_mhsa_bwd).
// It runs the fp32 launches (the parity path, of #1 and #3) and bf16 ones
// at a head width that is not a multiple of 8 up to 64: every other bf16
// launch takes the tensor-core kernel csrc/grid_mhsa_th.cu
// (ops/grid_attention.py:grid_mhsa_entry).
// Forward: for each grid g and head
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

// Backward (replaces `_bwd_kernel` of the same file, recompute style: only
// qkv is saved). Per grid g and head h, with a = softmax(q.k^T * scale)
// recomputed as in the forward and dO the output gradient, all in fp32:
//   dp[n,m] = dO_n . v_m          ds[n,m] = a[n,m] * (dp[n,m] - sum_m' dp*a)
//   dq_n = scale * sum_m ds[n,m] k_m      dk_m = scale * sum_n ds[n,m] q_n
//   dv_m = sum_n a[n,m] dO_n
// each cast to the output type once. Bound by HBM like the forward (reads
// 4C and writes 3C elements per token for ~10*N*C flops); the same design:
// one block per grid stages qkv and dO in shared memory as fp32, keeps the
// [heads, N, N] probabilities and ds there, and writes dqkv in the natural
// row-major [G, N, 3C] layout. Every block owns its grid's rows, so no
// atomics are needed and the result is deterministic.
template <typename T>
__global__ void __launch_bounds__(kThreads)
grid_mhsa_bwd(const T* __restrict__ qkv, const T* __restrict__ dout,
              T* __restrict__ dqkv, int N, int C, int heads, float scale) {
  extern __shared__ float smem[];
  const int C3 = 3 * C;
  const int hd = C / heads;
  const int NN = N * N;
  float* s_qkv = smem;              // [N, 3C]
  float* s_do = s_qkv + N * C3;     // [N, C]
  float* s_a = s_do + N * C;        // [heads, N, N] logits, then probabilities
  float* s_ds = s_a + heads * NN;   // [heads, N, N] dp, then ds

  const size_t g = blockIdx.x;
  const T* src = qkv + g * static_cast<size_t>(N) * C3;
  const T* gsrc = dout + g * static_cast<size_t>(N) * C;
  for (int i = threadIdx.x; i < N * C3; i += blockDim.x) {
    s_qkv[i] = to_f32(src[i]);
  }
  for (int i = threadIdx.x; i < N * C; i += blockDim.x) {
    s_do[i] = to_f32(gsrc[i]);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < heads * NN; i += blockDim.x) {
    const int h = i / NN;
    const int n = (i / N) % N;
    const int m = i % N;
    const float* q = s_qkv + n * C3 + h * hd;
    const float* k = s_qkv + m * C3 + C + h * hd;
    const float* v = s_qkv + m * C3 + 2 * C + h * hd;
    const float* go = s_do + n * C + h * hd;
    float lg = 0.f, dp = 0.f;
    for (int d = 0; d < hd; ++d) {
      lg = fmaf(q[d], k[d], lg);
      dp = fmaf(go[d], v[d], dp);
    }
    s_a[i] = lg * scale;
    s_ds[i] = dp;
  }
  __syncthreads();

  for (int r = threadIdx.x; r < heads * N; r += blockDim.x) {
    float* row = s_a + r * N;
    float* dpr = s_ds + r * N;
    float mx = row[0];
    for (int m = 1; m < N; ++m) mx = fmaxf(mx, row[m]);
    float den = 0.f;
    for (int m = 0; m < N; ++m) {
      const float e = expf(row[m] - mx);
      row[m] = e;
      den += e;
    }
    const float inv = 1.f / den;
    float s = 0.f;
    for (int m = 0; m < N; ++m) {
      row[m] *= inv;
      s = fmaf(dpr[m], row[m], s);
    }
    for (int m = 0; m < N; ++m) dpr[m] = row[m] * (dpr[m] - s);
  }
  __syncthreads();

  T* dst = dqkv + g * static_cast<size_t>(N) * C3;
  for (int i = threadIdx.x; i < N * C3; i += blockDim.x) {
    const int n = i / C3;
    const int j = i % C3;
    const int part = j / C;  // 0: dq, 1: dk, 2: dv
    const int c = j % C;
    const int h = c / hd;
    const float* a = s_a + h * NN;
    const float* ds = s_ds + h * NN;
    float acc = 0.f;
    if (part == 0) {
      for (int m = 0; m < N; ++m) {
        acc = fmaf(ds[n * N + m], s_qkv[m * C3 + C + c], acc);
      }
      acc *= scale;
    } else if (part == 1) {
      for (int r = 0; r < N; ++r) acc = fmaf(ds[r * N + n], s_qkv[r * C3 + c], acc);
      acc *= scale;
    } else {
      for (int r = 0; r < N; ++r) acc = fmaf(a[r * N + n], s_do[r * C + c], acc);
    }
    dst[i] = from_f32<T>(acc);
  }
}

template <typename T>
cudaError_t launch(const void* qkv, void* out, int G, int N, int C, int heads,
                   float scale, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(N * 3 * C + heads * N * N) *
                      sizeof(float);
  cudaError_t err = set_smem(grid_mhsa_fwd<T>, smem);
  if (err != cudaSuccess) return err;
  grid_mhsa_fwd<T><<<G, kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), N, C, heads, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* qkv, const void* dout, void* dqkv, int G,
                       int N, int C, int heads, float scale,
                       cudaStream_t stream) {
  const size_t smem =
      static_cast<size_t>(N * 4 * C + 2 * heads * N * N) * sizeof(float);
  cudaError_t err = set_smem(grid_mhsa_bwd<T>, smem);
  if (err != cudaSuccess) return err;
  grid_mhsa_bwd<T><<<G, kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(dout),
      static_cast<T*>(dqkv), N, C, heads, scale);
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

// qkv [G, N, 3C], dout [G, N, C] -> dqkv [G, N, 3C], all contiguous, of type
// `dtype`.
extern "C" int ogvt_grid_mhsa_bwd(const void* qkv, const void* dout,
                                  void* dqkv, int G, int N, int C, int heads,
                                  float scale, int dtype, void* stream) {
  if (G <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch_bwd<float>(qkv, dout, dqkv, G, N, C, heads, scale, s);
    case kBFloat16:
      return launch_bwd<__nv_bfloat16>(qkv, dout, dqkv, G, N, C, heads, scale,
                                       s);
    default:
      return cudaErrorInvalidValue;
  }
}
