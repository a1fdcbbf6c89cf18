// Depthwise 3x3 convolution, stride 1, zero padding 1, no bias, NHWC,
// forward and backward:
//   y[p, c]  = round(sum_t x[p + off_t, c] * w[t, c])
//   dx[p, c] = round(sum_t w[t, c] * dy[p - off_t, c])
//   dw[t, c] = round(sum_p x[p + off_t, c] * dy[p, c])
// taps t = 3*(oy+1) + (ox+1) row-major, off_t = (oy, ox); zero outside the
// image.
//
// Replaces the TPU kernels outgridvit_tpu/ops/experimental/dwconv_pallas_t.py:
// dwconv3x3_t (#10: `_fwd_kernel`, pallas_call at :181; `_bwd_kernel`, :211)
// and dwconv_bwd_pallas.py:dwconv3x3 (#11: its forward is XLA's conv, its
// backward `_bwd_kernel`, :170). The two backwards compute the same function
// in two TPU layouts, so one kernel serves both. Rounding points (round() is
// the cast to the compute type): x, dy and w (already in the compute type)
// read as fp32; the 9 taps summed in fp32 in order, each product rounded
// apart (__fmul_rn / __fadd_rn, as the plain version's separate multiply and
// add); y and dx cast once; dw an fp32 sum over every pixel, cast once to
// w's type.
//
// What bounds it on the H100: 18 flop per element forward (36 backward)
// against 4 bytes moved in bf16 (x read, y written; backward 6: x and dy
// read, dx written): 4.5-6 flop per byte, well below the fp32 pipe's balance
// (~20), so it is bound by memory. Least time at the Tiny-ImageNet stage 0
// (B = 128, 64x64x256, bf16): forward 537 MB, 160 us; backward 805 MB,
// 240 us.
//
// What the design does about it: the natural NHWC layout (the TPU kernel's
// transposed [C*H, B*W] one would cost two transposes a call). A thread
// handles VEC channels of one pixel with one 16-byte load per neighbour (8
// bytes in the backward, whose thread keeps 9*VEC fp32 dw sums in
// registers); the 9 neighbours come straight from global memory, where a warp
// reads contiguous channels and L1 / the 50 MB L2 serve the re-reads of a
// row by the rows above and below, so each tensor comes from device memory
// about once. dx is a gather (dx[p] reads dy at p - off_t): no pixel is
// written twice. dw: each thread sums its pixels, a block sums its threads in
// order into its own fp32 partial [9, C], and a last pass sums the partials
// in block order (partials.cuh): no float atomics, so two calls give
// bitwise-equal dw. VEC falls back to 1 where C or a pointer does not allow
// the wide loads (the Python wrapper picks it).
#include "common.cuh"
#include "partials.cuh"

using namespace ogvt;

namespace {

constexpr int kThreads = 256;
constexpr int kTargetBlocks = 528;  // 4 per SM on 132 SMs
constexpr long long kMaxWorkspaceFloats = 16ll << 20;  // 64 MB of partials

struct Dims {
  int B, H, W, C;
  __host__ __device__ long long pixels() const {
    return static_cast<long long>(B) * H * W;
  }
};

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T e[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ void load(const T* p, float (&f)[VEC]) {
  const Pack<T, VEC> r = *reinterpret_cast<const Pack<T, VEC>*>(p);
#pragma unroll
  for (int i = 0; i < VEC; ++i) f[i] = to_f32(r.e[i]);
}

template <typename T, int VEC>
__device__ __forceinline__ void store(T* p, const float (&f)[VEC]) {
  Pack<T, VEC> r;
#pragma unroll
  for (int i = 0; i < VEC; ++i) r.e[i] = from_f32<T>(f[i]);
  *reinterpret_cast<Pack<T, VEC>*>(p) = r;
}

__device__ __forceinline__ bool inside(int r, int j, const Dims& d) {
  return r >= 0 && r < d.H && j >= 0 && j < d.W;
}

// One thread per (pixel, VEC channels).
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
dwconv_fwd(const T* __restrict__ x, const T* __restrict__ w,
           T* __restrict__ y, Dims d) {
  const int CV = d.C / VEC;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= d.pixels() * CV) return;
  const int c = static_cast<int>(i % CV) * VEC;
  const long long p = i / CV;
  const int j = static_cast<int>(p % d.W);
  const int r = static_cast<int>((p / d.W) % d.H);
  float acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    const int oy = t / 3 - 1, ox = t % 3 - 1;
    if (!inside(r + oy, j + ox, d)) continue;
    float xv[VEC], wv[VEC];
    load<T, VEC>(x + (p + oy * d.W + ox) * d.C + c, xv);
    load<T, VEC>(w + t * d.C + c, wv);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      acc[e] = __fadd_rn(acc[e], __fmul_rn(xv[e], wv[e]));
    }
  }
  store<T, VEC>(y + p * d.C + c, acc);
}

// Block (chunk, part): threads (lane, cvl) own channels [c, c + VEC) of the
// chunk, c = (chunk * cvb + cvl) * VEC, and walk pixels lane + part * lanes,
// step lanes * parts. Writes dx at those pixels and the block's dw partial
// part_ws[part][t][c] for the chunk's channels.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
dwconv_bwd(const T* __restrict__ x, const T* __restrict__ w,
           const T* __restrict__ g, T* __restrict__ dx,
           float* __restrict__ part_ws, Dims d, int cvb, int lanes) {
  extern __shared__ float s_red[];  // [lanes][9][cvb * VEC]
  const int CV = d.C / VEC, C = d.C, W = d.W;
  const int cvl = threadIdx.x % cvb, lane = threadIdx.x / cvb;
  const int cv = blockIdx.x * cvb + cvl;
  const int c = cv * VEC;
  float sw[9][VEC];
#pragma unroll
  for (int t = 0; t < 9; ++t) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) sw[t][e] = 0.f;
  }
  if (cv < CV) {
    const long long npix = d.pixels();
    const long long step = static_cast<long long>(gridDim.y) * lanes;
    for (long long p = static_cast<long long>(blockIdx.y) * lanes + lane;
         p < npix; p += step) {
      const int j = static_cast<int>(p % W);
      const int r = static_cast<int>((p / W) % d.H);
      float gp[VEC], acc[VEC];
      load<T, VEC>(g + p * C + c, gp);
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const int oy = t / 3 - 1, ox = t % 3 - 1;
        if (inside(r - oy, j - ox, d)) {  // dx[p] += w[t] * dy[p - off_t]
          float gv[VEC], wv[VEC];
          load<T, VEC>(g + (p - oy * W - ox) * C + c, gv);
          load<T, VEC>(w + t * C + c, wv);
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            acc[e] = __fadd_rn(acc[e], __fmul_rn(gv[e], wv[e]));
          }
        }
        if (inside(r + oy, j + ox, d)) {  // dw[t] += x[p + off_t] * dy[p]
          float xv[VEC];
          load<T, VEC>(x + (p + oy * W + ox) * C + c, xv);
#pragma unroll
          for (int e = 0; e < VEC; ++e) sw[t][e] = fmaf(xv[e], gp[e], sw[t][e]);
        }
      }
      store<T, VEC>(dx + p * C + c, acc);
    }
  }
  // the block's partial: its lanes summed in order
  const int ld = cvb * VEC;
#pragma unroll
  for (int t = 0; t < 9; ++t) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      s_red[(lane * 9 + t) * ld + cvl * VEC + e] = sw[t][e];
    }
  }
  __syncthreads();
  const int cols = min(cvb, CV - static_cast<int>(blockIdx.x) * cvb) * VEC;
  float* out = part_ws + static_cast<long long>(blockIdx.y) * 9 * C +
               static_cast<long long>(blockIdx.x) * cvb * VEC;
  for (int k = threadIdx.x; k < 9 * cols; k += blockDim.x) {
    const int t = k / cols, cc = k % cols;
    float s = 0.f;
    for (int l = 0; l < lanes; ++l) s += s_red[(l * 9 + t) * ld + cc];
    out[static_cast<long long>(t) * C + cc] = s;
  }
}

bool dims_ok(const Dims& d) {
  return d.B >= 1 && d.H >= 1 && d.W >= 1 && d.C >= 1;
}

// The backward's launch shape for VEC channels per thread.
struct BwdPlan {
  int cvb, lanes, chunks, parts;
  long long workspace;  // floats: parts partials of [9, C]
};

BwdPlan bwd_plan(const Dims& d, int vec) {
  BwdPlan p;
  const int CV = d.C / vec;
  p.cvb = CV < kThreads ? CV : kThreads;
  p.lanes = kThreads / p.cvb;
  p.chunks = (CV + p.cvb - 1) / p.cvb;
  const long long rows = (d.pixels() + p.lanes - 1) / p.lanes;
  long long parts = (kTargetBlocks + p.chunks - 1) / p.chunks;
  if (parts > rows) parts = rows;
  if (parts * 9 * d.C > kMaxWorkspaceFloats) {
    parts = kMaxWorkspaceFloats / (9ll * d.C);
  }
  p.parts = static_cast<int>(parts < 1 ? 1 : parts);
  p.workspace = static_cast<long long>(p.parts) * 9 * d.C;
  return p;
}

// The vector widths each direction takes for element type T.
template <typename T>
constexpr int fwd_vec() { return 16 / sizeof(T); }
template <typename T>
constexpr int bwd_vec() { return 8 / sizeof(T); }

template <typename T, int VEC>
cudaError_t launch_fwd(const void* x, const void* w, void* y, const Dims& d,
                       cudaStream_t stream) {
  const long long n = d.pixels() * (d.C / VEC);
  dwconv_fwd<T, VEC><<<static_cast<unsigned>((n + kThreads - 1) / kThreads),
                       kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y),
      d);
  return cudaGetLastError();
}

template <typename T>
cudaError_t fwd(const void* x, const void* w, void* y, const Dims& d,
                int vec, cudaStream_t stream) {
  if (vec == 1) return launch_fwd<T, 1>(x, w, y, d, stream);
  if (vec == fwd_vec<T>()) return launch_fwd<T, fwd_vec<T>()>(x, w, y, d,
                                                              stream);
  return cudaErrorInvalidValue;
}

template <typename T, int VEC>
cudaError_t launch_bwd(const void* x, const void* w, const void* g, void* dx,
                       void* dw, float* ws, const Dims& d,
                       cudaStream_t stream) {
  const BwdPlan p = bwd_plan(d, VEC);
  const size_t smem = static_cast<size_t>(p.lanes) * 9 * p.cvb * VEC *
                      sizeof(float);
  cudaError_t err = set_smem(dwconv_bwd<T, VEC>, smem);
  if (err != cudaSuccess) return err;
  dwconv_bwd<T, VEC><<<dim3(p.chunks, p.parts), p.cvb * p.lanes, smem,
                       stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(g), static_cast<T*>(dx), ws, d, p.cvb, p.lanes);
  if ((err = cudaGetLastError())) return err;
  return reduce<T>(ws, p.parts, 9ll * d.C, 9 * d.C, dw, stream);
}

template <typename T>
cudaError_t bwd(const void* x, const void* w, const void* g, void* dx,
                void* dw, float* ws, const Dims& d, int vec,
                cudaStream_t stream) {
  if (vec == 1) return launch_bwd<T, 1>(x, w, g, dx, dw, ws, d, stream);
  if (vec == bwd_vec<T>()) {
    return launch_bwd<T, bwd_vec<T>()>(x, w, g, dx, dw, ws, d, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// x, y [B, H, W, C], w [9, C]: contiguous, of type `dtype`. vec: channels
// per thread, 1 or 16 bytes' worth (C and the pointers must allow it).
extern "C" int ogvt_dwconv3x3(const void* x, const void* w, void* y, int B,
                              int H, int W, int C, int vec, int dtype,
                              void* stream) {
  const Dims d{B, H, W, C};
  if (!dims_ok(d) || vec < 1 || C % vec != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return fwd<float>(x, w, y, d, vec, s);
    case kBFloat16:
      return fwd<__nv_bfloat16>(x, w, y, d, vec, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// Floats of fp32 workspace ogvt_dwconv3x3_bwd needs for these shapes and vec.
extern "C" long long ogvt_dwconv3x3_bwd_workspace(int B, int H, int W, int C,
                                                  int vec) {
  const Dims d{B, H, W, C};
  if (!dims_ok(d) || vec < 1 || C % vec != 0) return 0;
  return bwd_plan(d, vec).workspace;
}

// x, dy, dx [B, H, W, C], w, dw [9, C]: contiguous, of type `dtype`. vec: 1
// or 8 bytes' worth of channels per thread. ws:
// ogvt_dwconv3x3_bwd_workspace(B, H, W, C, vec) floats.
extern "C" int ogvt_dwconv3x3_bwd(const void* x, const void* w,
                                  const void* dy, void* dx, void* dw,
                                  void* ws, int B, int H, int W, int C,
                                  int vec, int dtype, void* stream) {
  const Dims d{B, H, W, C};
  if (!dims_ok(d) || vec < 1 || C % vec != 0) return cudaErrorInvalidValue;
  float* f = static_cast<float*>(ws);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return bwd<float>(x, w, dy, dx, dw, f, d, vec, s);
    case kBFloat16:
      return bwd<__nv_bfloat16>(x, w, dy, dx, dw, f, d, vec, s);
    default:
      return cudaErrorInvalidValue;
  }
}
