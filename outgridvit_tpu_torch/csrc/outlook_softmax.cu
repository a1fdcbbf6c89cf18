// Fused outlook attention, stride 1, any odd K: the softmax over each head's
// K*K tap logits fused with the taps,
//   a[p, h, t] = exp(l[p, h*KK + t] - max_t l) / sum_t exp(...)   (fp32)
//   y[p, c]    = round(sum_t a[p, head(c), t] * v[p + off_t, c])
// taps t = ky*K + kx row-major, off_t = (ky - K/2, kx - K/2). A tap outside
// the image adds nothing (zero v); the weights are not renormalised.
//
// Replaces the TPU kernel outgridvit_tpu/ops/experimental/outlook_pallas.py:
// outlook_attention_pallas (#9: `_fwd_kernel`, pallas_call at :157), with
// its rounding points (round() is the cast to the compute type): v and the
// logits read as fp32; the softmax in fp32 (max, exp, the sum over the taps
// in order, one division); the probabilities stay fp32; the taps summed in
// fp32 in order, each product rounded apart (__fmul_rn / __fadd_rn: no FMA
// contraction, as the plain version's separate multiply and add); one cast
// at the end. The backward is not a kernel: the TPU kernel's is XLA's vjp of
// an equivalent forward (:176-195), and the port's is autograd of the same
// plain forward (ops/outlook_softmax.py).
//
// What bounds it on the H100: per pixel and channel 2*K*K flop of taps (and
// K*K exps per pixel and head) against about 4 bytes in bf16 (v read, out
// written; the logits add 2*heads*K*K/C bytes): 4.5 flop per byte at K = 3,
// below the fp32 pipe's balance (~20), so it is bound by memory. Least time
// at Model B's front (B = 64, 32x32x64, 2 heads, bf16): 19.1 MB at
// 3.35 TB/s, 5.7 us.
//
// What the design does about it: a block takes kPix consecutive pixels. Its
// threads first softmax the block's (pixel, head) logit rows into shared
// memory, then each thread computes one channel of one pixel, reading the
// K*K neighbours straight from global memory: a warp reads consecutive
// channels of one neighbour (coalesced), and the blocks of the rows above
// and below read the same rows again from L1 / the 50 MB L2, so v comes from
// device memory about once.
#include "common.cuh"

using namespace ogvt;

namespace {

constexpr int kThreads = 256;
constexpr int kPix = 32;  // pixels per block
constexpr size_t kMaxSmem = 227 * 1024;

struct Dims {
  int B, H, W, C, heads, k;
  __host__ __device__ int kk() const { return k * k; }
  __host__ __device__ long long pixels() const {
    return static_cast<long long>(B) * H * W;
  }
};

size_t smem_bytes(const Dims& d) {
  return static_cast<size_t>(kPix) * d.heads * d.kk() * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
outlook_softmax_fwd(const T* __restrict__ v, const T* __restrict__ logits,
                    T* __restrict__ out, Dims d) {
  extern __shared__ float s_a[];  // [kPix, heads * kk] probabilities
  const int kk = d.kk(), hk = d.heads * kk, C = d.C, hd = C / d.heads;
  const int H = d.H, W = d.W, k = d.k, pk = d.k / 2;
  const long long p0 = static_cast<long long>(blockIdx.x) * kPix;
  const int np = static_cast<int>(min(static_cast<long long>(kPix),
                                      d.pixels() - p0));

  // row r = (pixel, head): s_a[r * kk + t] = softmax of its kk logits
  for (int r = threadIdx.x; r < np * d.heads; r += blockDim.x) {
    const T* l = logits + p0 * hk + static_cast<long long>(r) * kk;
    float* a = s_a + r * kk;
    float m = to_f32(l[0]);
    for (int t = 0; t < kk; ++t) {
      a[t] = to_f32(l[t]);
      m = fmaxf(m, a[t]);
    }
    float s = 0.f;
    for (int t = 0; t < kk; ++t) {
      a[t] = expf(a[t] - m);
      s = __fadd_rn(s, a[t]);
    }
    for (int t = 0; t < kk; ++t) a[t] = __fdiv_rn(a[t], s);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < np * C; i += blockDim.x) {
    const int p = i / C, c = i % C;
    const long long g = p0 + p;
    const int j = static_cast<int>(g % W);
    const int y = static_cast<int>((g / W) % H);
    const long long img = g - static_cast<long long>(y) * W - j;  // (b, 0, 0)
    const float* a = s_a + p * hk + (c / hd) * kk;
    float acc = 0.f;
    for (int ky = 0; ky < k; ++ky) {
      const int qy = y + ky - pk;
      if (qy < 0 || qy >= H) continue;
      const T* row = v + (img + static_cast<long long>(qy) * W) * C + c;
      for (int kx = 0; kx < k; ++kx) {
        const int qx = j + kx - pk;
        if (qx < 0 || qx >= W) continue;
        acc = __fadd_rn(acc, __fmul_rn(to_f32(row[static_cast<long long>(qx)
                                                  * C]),
                                       a[ky * k + kx]));
      }
    }
    out[g * C + c] = from_f32<T>(acc);
  }
}

template <typename T>
cudaError_t launch(const void* v, const void* logits, void* out,
                   const Dims& d, cudaStream_t stream) {
  const size_t smem = smem_bytes(d);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = set_smem(outlook_softmax_fwd<T>, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (d.pixels() + kPix - 1) / kPix;
  outlook_softmax_fwd<T><<<static_cast<unsigned>(blocks), kThreads, smem,
                           stream>>>(
      static_cast<const T*>(v), static_cast<const T*>(logits),
      static_cast<T*>(out), d);
  return cudaGetLastError();
}

}  // namespace

// v [B, H, W, C], logits [B, H, W, heads*k*k], out [B, H, W, C]: contiguous,
// of type `dtype`; k odd.
extern "C" int ogvt_outlook_softmax(const void* v, const void* logits,
                                    void* out, int B, int H, int W, int C,
                                    int heads, int k, int dtype,
                                    void* stream) {
  const Dims d{B, H, W, C, heads, k};
  if (B < 0 || H < 1 || W < 1 || C < 1 || heads < 1 || C % heads != 0 ||
      k < 1 || k % 2 == 0) {
    return cudaErrorInvalidValue;
  }
  if (B == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch<float>(v, logits, out, d, s);
    case kBFloat16:
      return launch<__nv_bfloat16>(v, logits, out, d, s);
    default:
      return cudaErrorInvalidValue;
  }
}
