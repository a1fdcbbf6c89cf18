// Fused pre-LN channel-MLP branch: y = fc2(act(fc1(LN(x)))) per token.
//
// Replaces the TPU kernel outgridvit_tpu/ops/mlp_branch_pallas_t.py:
// mlp_branch_pallas_t (forward half, `_fwd_kernel`), with its rounding
// points: LN with fp32 statistics (fast variance clamped at 0) cast to the
// compute type; h = xn.w1 summed in fp32, + b1, cast; act in fp32, cast;
// y = a.w2 summed in fp32, + b2, cast.
//
// What bounds it on the H100: a token costs 4*C*H flops against 4*C bytes of
// activation traffic in bf16 (x in, y out), so the fused branch has an
// arithmetic intensity of H flop/byte. With tensor cores (ridge ~295
// flop/byte) the Model A-7M stages with H <= 256 are bound by HBM and only
// the widest block MLP (H = 1024) by math. This first version runs its
// products on the fp32 FMA pipe (~67 TFLOP/s), so at these shapes it is
// bound by FMA throughput, not by HBM; the weights (C*H*2 elements, <= 1 MB
// in bf16) are re-read by every block from L2.
//
// What the design does about it: the branch is fused, so the [M, H] hidden
// activation never touches device memory: x is read once and y written once,
// both in the natural row-major [M, C] layout (no transposes, unlike the TPU
// kernel's [C, M]). A block takes TM <= 16 tokens: it normalizes them into
// shared memory (one warp per token), then walks the hidden dimension in
// chunks of 64 units: the fc1 chunk goes to shared memory (each thread keeps
// one hidden unit for up to 4 tokens, so each w1 load feeds 4 FMAs), and the
// fc2 partial sums accumulate in registers across chunks. Weight loads are
// coalesced along the output dimension and hit L2. Moving both products to
// the tensor cores (mma.sync, then wgmma) is what lifts the FMA bound; it is
// left for a later version.
#include "act.cuh"
#include "common.cuh"

using namespace ogvt;

namespace {

constexpr int kThreads = 256;
constexpr int kHC = 64;                        // hidden units per chunk
constexpr int kRowGroups = kThreads / kHC;     // 4 token groups in fc1
constexpr int kMaxTM = 16;                     // tokens per block
constexpr int kRPT = kMaxTM / kRowGroups;      // fc1 tokens per thread
constexpr int kMaxTile = 4096;                 // TM * C <= kMaxTile
constexpr int kYPT = kMaxTile / kThreads;      // fc2 outputs per thread

template <typename T, int ACT>
__global__ void __launch_bounds__(kThreads)
mlp_branch_fwd(const T* __restrict__ x, const float* __restrict__ ln_scale,
               const float* __restrict__ ln_bias, const T* __restrict__ w1,
               const T* __restrict__ b1, const T* __restrict__ w2,
               const T* __restrict__ b2, T* __restrict__ y, int M, int C,
               int H, int TM, float eps, int apply_ln) {
  __shared__ float s_x[kMaxTile];       // [TM, C] normalized tokens
  __shared__ float s_a[kMaxTM * kHC];   // [TM, kHC] activated hidden chunk

  const int tid = threadIdx.x;
  const size_t row0 = static_cast<size_t>(blockIdx.x) * TM;
  const int rows = min(TM, static_cast<int>(M - row0));
  const int tile = TM * C;
  const T* xb = x + row0 * C;
  for (int i = tid; i < tile; i += kThreads) {
    s_x[i] = i < rows * C ? to_f32(xb[i]) : 0.f;
  }
  __syncthreads();

  if (apply_ln) {
    const int warp = tid / 32;
    const int lane = tid % 32;
    for (int r = warp; r < rows; r += kThreads / 32) {
      float* xr = s_x + r * C;
      float s = 0.f, ss = 0.f;
      for (int c = lane; c < C; c += 32) {
        const float v = xr[c];
        s += v;
        ss = fmaf(v, v, ss);
      }
      for (int o = 16; o > 0; o >>= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, o);
        ss += __shfl_xor_sync(0xffffffffu, ss, o);
      }
      const float mu = s / C;
      const float var = fmaxf(0.f, ss / C - mu * mu);
      const float rstd = rsqrtf(var + eps);
      for (int c = lane; c < C; c += 32) {
        xr[c] = round_to<T>((xr[c] - mu) * (rstd * ln_scale[c]) + ln_bias[c]);
      }
    }
    __syncthreads();
  }

  float acc[kYPT];
#pragma unroll
  for (int i = 0; i < kYPT; ++i) acc[i] = 0.f;

  const int jj = tid % kHC;
  const int rg = tid / kHC;
  for (int j0 = 0; j0 < H; j0 += kHC) {
    const int j = j0 + jj;
    float h[kRPT];
#pragma unroll
    for (int q = 0; q < kRPT; ++q) h[q] = 0.f;
    if (j < H) {
      for (int c = 0; c < C; ++c) {
        const float w = to_f32(w1[static_cast<size_t>(c) * H + j]);
#pragma unroll
        for (int q = 0; q < kRPT; ++q) {
          const int r = rg + q * kRowGroups;
          if (r < TM) h[q] = fmaf(s_x[r * C + c], w, h[q]);
        }
      }
    }
    __syncthreads();  // the previous chunk's fc2 is done reading s_a
#pragma unroll
    for (int q = 0; q < kRPT; ++q) {
      const int r = rg + q * kRowGroups;
      if (r < TM) {
        s_a[r * kHC + jj] =
            j < H ? round_to<T>(act_f32<ACT>(round_to<T>(h[q] + to_f32(b1[j]))))
                  : 0.f;
      }
    }
    __syncthreads();

    const int kn = min(kHC, H - j0);
#pragma unroll
    for (int i = 0; i < kYPT; ++i) {
      const int idx = tid + i * kThreads;
      if (idx < tile) {
        const float* a = s_a + (idx / C) * kHC;
        const T* w = w2 + static_cast<size_t>(j0) * C + idx % C;
        float s = acc[i];
        for (int k = 0; k < kn; ++k) {
          s = fmaf(a[k], to_f32(w[static_cast<size_t>(k) * C]), s);
        }
        acc[i] = s;
      }
    }
  }

  T* yb = y + row0 * C;
#pragma unroll
  for (int i = 0; i < kYPT; ++i) {
    const int idx = tid + i * kThreads;
    if (idx < rows * C) yb[idx] = from_f32<T>(acc[i] + to_f32(b2[idx % C]));
  }
}

template <typename T, int ACT>
cudaError_t launch(const void* x, const void* ls, const void* lb,
                   const void* w1, const void* b1, const void* w2,
                   const void* b2, void* y, int M, int C, int H, float eps,
                   int apply_ln, cudaStream_t stream) {
  const int TM = kMaxTile / C < kMaxTM ? kMaxTile / C : kMaxTM;
  const int blocks = (M + TM - 1) / TM;
  mlp_branch_fwd<T, ACT><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(ls),
      static_cast<const float*>(lb), static_cast<const T*>(w1),
      static_cast<const T*>(b1), static_cast<const T*>(w2),
      static_cast<const T*>(b2), static_cast<T*>(y), M, C, H, TM, eps,
      apply_ln);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_act(int act, const void* x, const void* ls, const void* lb,
                       const void* w1, const void* b1, const void* w2,
                       const void* b2, void* y, int M, int C, int H, float eps,
                       int apply_ln, cudaStream_t s) {
  switch (act) {
    case kGelu:
      return launch<T, kGelu>(x, ls, lb, w1, b1, w2, b2, y, M, C, H, eps,
                              apply_ln, s);
    case kSilu:
      return launch<T, kSilu>(x, ls, lb, w1, b1, w2, b2, y, M, C, H, eps,
                              apply_ln, s);
    case kRelu:
      return launch<T, kRelu>(x, ls, lb, w1, b1, w2, b2, y, M, C, H, eps,
                              apply_ln, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x, y [M, C]; w1 [C, H]; b1 [H]; w2 [H, C]; b2 [C]: contiguous, of type
// `dtype`. ln_scale, ln_bias [C]: float32. Requires 1 <= C <= 4096.
extern "C" int ogvt_mlp_branch(const void* x, const void* ln_scale,
                               const void* ln_bias, const void* w1,
                               const void* b1, const void* w2, const void* b2,
                               void* y, int M, int C, int H, int act,
                               float eps, int apply_ln, int dtype,
                               void* stream) {
  if (M <= 0) return cudaSuccess;
  if (C < 1 || C > kMaxTile || H < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch_act<float>(act, x, ln_scale, ln_bias, w1, b1, w2, b2, y,
                               M, C, H, eps, apply_ln, s);
    case kBFloat16:
      return launch_act<__nv_bfloat16>(act, x, ln_scale, ln_bias, w1, b1, w2,
                                       b2, y, M, C, H, eps, apply_ln, s);
    default:
      return cudaErrorInvalidValue;
  }
}
