// Backward of the fused pre-LN channel-MLP branch y = fc2(act(fc1(LN(x)))).
//
// Replaces the TPU kernel outgridvit_tpu/ops/mlp_branch_pallas_t.py:
// mlp_branch_pallas_t (backward half, `_bwd_kernel`), recompute style: only
// the inputs are saved. With the rounding points of that kernel, per token:
//   xn = round(LN(x)) (fp32 statistics), xhat = (x - mu) * rstd
//   h  = round(xn.w1 + b1), a = round(act(h))
//   da = dy.w2^T (fp32), dh = round(da * act'(h))
//   dxn = dh.w1^T (fp32); dx = round(rstd * (dxhat - mean(dxhat)
//         - xhat * mean(dxhat * xhat))) with dxhat = dxn * ln_scale
// and over all M tokens, in fp32: dW1 = xn^T.dh, db1 = sum dh,
// dW2 = a^T.dy, db2 = sum dy, dln_scale = sum dxn * xhat, dln_bias = sum dxn.
// round() is the cast to the compute type (common.cuh:round_to).
//
// What bounds it on the H100: like the forward, a token costs ~12*C*H flops
// (fc1, da, dxn, dW1, dW2 products) against 6*C bytes of activations in
// bf16 (x, dy in; dx out); this first version runs every product on the fp32
// FMA pipe, so it is bound by FMA throughput at every Model A-7M shape.
//
// What the design does about it: on the TPU the weight-gradient sums are
// carried across the sequential grid in VMEM. On Hopper nothing carries
// across blocks, and float atomics would make two calls differ in the last
// bits. So the work is split three ways, all deterministic:
//   1. mlp_bwd_tokens: blocks walk token tiles (TM <= 16 tokens) as the
//      forward does, recompute fc1 and da per 64-unit hidden chunk in
//      shared memory, accumulate dxn in registers and write dx. Each block
//      also sums dln_scale, dln_bias and db2 over its tiles in a fixed order
//      and writes one fp32 partial per block ([P1, 3, C]).
//   2. mlp_bwd_weights: a block owns WC hidden units (a column slab of dW1,
//      a row slab of dW2, a slice of db1) and one contiguous split of the
//      token tiles. It recomputes h and da for just its units (both need
//      only w1[:, j] and w2[j, :]) and accumulates the slabs in registers
//      over its tokens, in order; one fp32 partial per split ([S, 2CH + H]).
//   3. reduce_partials: the partials are summed over the splits in order
//      and cast to the gradients' types.
// Weight reads: every block walks w1 and w2 along the hidden dimension for
// fixed c and along c for fixed hidden units, so the entry point first
// copies w1^T [H, C] and w2^T [C, H] into the workspace as fp32 (exact), and
// each walk reads whichever layout makes neighbouring threads touch
// neighbouring addresses.
// The workspace is bounded: S is capped so that the weight partials stay
// within kMaxWorkspaceFloats (64 MB), and P1 <= kMaxTokenBlocks.
#include "act.cuh"
#include "common.cuh"
#include "partials.cuh"

using namespace ogvt;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHC = 64;                     // hidden units per chunk (tokens)
constexpr int kRowGroups = kThreads / kHC;  // 4 token groups in fc1
constexpr int kMaxTM = 16;                  // tokens per tile
constexpr int kRPT = kMaxTM / kRowGroups;   // fc1 tokens per thread
constexpr int kMaxTile = 4096;              // TM * C <= kMaxTile, WC * C too
constexpr int kYPT = kMaxTile / kThreads;   // outputs per thread
constexpr int kMaxTokenBlocks = 1056;       // 8 per SM on 132 SMs
constexpr int kTargetWeightBlocks = 1056;
constexpr long long kMaxWorkspaceFloats = 16ll << 20;  // 64 MB

struct Plan {
  int TM, ntiles, P1;     // token tiles and token-kernel blocks
  int WC, nchunks;        // hidden units per weight block, chunks of H
  int S, tiles_per_split; // token splits of the weight kernel
  long long ws_tokens, ws_weights;  // floats of each partial buffer
  long long ws_transposed;          // w1^T and w2^T in fp32
};

Plan make_plan(int M, int C, int H) {
  Plan p;
  p.TM = kMaxTile / C < kMaxTM ? kMaxTile / C : kMaxTM;
  p.ntiles = (M + p.TM - 1) / p.TM;
  p.P1 = p.ntiles < kMaxTokenBlocks ? p.ntiles : kMaxTokenBlocks;
  p.WC = kMaxTile / C < kHC ? kMaxTile / C : kHC;
  p.nchunks = (H + p.WC - 1) / p.WC;
  const long long per_split = 2ll * C * H + H;
  long long S = (kTargetWeightBlocks + p.nchunks - 1) / p.nchunks;
  if (S > p.ntiles) S = p.ntiles;
  if (S * per_split > kMaxWorkspaceFloats) S = kMaxWorkspaceFloats / per_split;
  if (S < 1) S = 1;
  p.tiles_per_split = static_cast<int>((p.ntiles + S - 1) / S);
  p.S = (p.ntiles + p.tiles_per_split - 1) / p.tiles_per_split;
  p.ws_tokens = 3ll * C * p.P1;
  p.ws_weights = per_split * p.S;
  p.ws_transposed = 2ll * C * H;
  return p;
}

// LayerNorm of `rows` tokens of s_x [rows, C] (one warp per token), with the
// forward's numerics: fp32 statistics, fast variance clamped at 0. Writes
// round(LN(x)) to s_xn (may alias s_x) and, when mu/rstd are given, the
// statistics.
template <typename T>
__device__ void layernorm_rows(const float* s_x, float* s_xn, float* s_mu,
                               float* s_rstd, const float* __restrict__ ls,
                               const float* __restrict__ lb, int rows, int C,
                               float eps) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int r = warp; r < rows; r += kWarps) {
    const float* xr = s_x + r * C;
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
    const float rstd = rsqrtf(fmaxf(0.f, ss / C - mu * mu) + eps);
    if (s_mu != nullptr && lane == 0) {
      s_mu[r] = mu;
      s_rstd[r] = rstd;
    }
    __syncwarp();
    for (int c = lane; c < C; c += 32) {
      s_xn[r * C + c] = round_to<T>((xr[c] - mu) * (rstd * ls[c]) + lb[c]);
    }
  }
}

template <typename T, int ACT>
__global__ void __launch_bounds__(kThreads)
mlp_bwd_tokens(const T* __restrict__ x, const float* __restrict__ ls,
               const float* __restrict__ lb, const T* __restrict__ w1,
               const T* __restrict__ b1, const float* __restrict__ w1t,
               const float* __restrict__ w2t, const T* __restrict__ dy,
               T* __restrict__ dx,
               float* __restrict__ part, int M, int C, int H, int TM,
               float eps, int apply_ln) {
  extern __shared__ float smem[];
  const int tile = TM * C;
  float* s_x = smem;               // [TM, C] x (fp32)
  float* s_xn = s_x + tile;        // [TM, C] fc1 operand: round(LN(x)) or x
  float* s_dy = s_xn + tile;       // [TM, C] dy
  float* s_dxn = s_dy + tile;      // [TM, C] dL/dxn
  float* s_dh = s_dxn + tile;      // [TM, kHC] dh of the current chunk
  float* s_mu = s_dh + TM * kHC;   // [TM]
  float* s_rstd = s_mu + TM;       // [TM]
  float* s_red = s_rstd + TM;      // [3, C] dln_scale, dln_bias, db2 sums

  const int tid = threadIdx.x;
  for (int i = tid; i < 3 * C; i += kThreads) s_red[i] = 0.f;
  const int ntiles = (M + TM - 1) / TM;
  const int jj = tid % kHC;
  const int rg = tid / kHC;

  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const size_t row0 = static_cast<size_t>(t) * TM;
    const int rows = min(TM, static_cast<int>(M - row0));
    const T* xb = x + row0 * C;
    const T* dyb = dy + row0 * C;
    for (int i = tid; i < tile; i += kThreads) {
      const bool in = i < rows * C;
      s_x[i] = in ? to_f32(xb[i]) : 0.f;
      s_xn[i] = s_x[i];
      s_dy[i] = in ? to_f32(dyb[i]) : 0.f;
    }
    __syncthreads();
    if (apply_ln) {
      layernorm_rows<T>(s_x, s_xn, s_mu, s_rstd, ls, lb, rows, C, eps);
      __syncthreads();
    }

    float acc[kYPT];
#pragma unroll
    for (int i = 0; i < kYPT; ++i) acc[i] = 0.f;
    for (int j0 = 0; j0 < H; j0 += kHC) {
      const int j = j0 + jj;
      float h[kRPT], g[kRPT];
#pragma unroll
      for (int q = 0; q < kRPT; ++q) h[q] = g[q] = 0.f;
      if (j < H) {
        for (int c = 0; c < C; ++c) {
          const float wa = to_f32(w1[static_cast<size_t>(c) * H + j]);
          const float wb = w2t[static_cast<size_t>(c) * H + j];
#pragma unroll
          for (int q = 0; q < kRPT; ++q) {
            const int r = rg + q * kRowGroups;
            if (r < TM) {
              h[q] = fmaf(s_xn[r * C + c], wa, h[q]);
              g[q] = fmaf(s_dy[r * C + c], wb, g[q]);
            }
          }
        }
      }
      __syncthreads();  // the previous chunk's dxn loop is done with s_dh
#pragma unroll
      for (int q = 0; q < kRPT; ++q) {
        const int r = rg + q * kRowGroups;
        if (r < TM) {
          float d = 0.f;
          if (j < H && r < rows) {
            const float hr = round_to<T>(h[q] + to_f32(b1[j]));
            d = round_to<T>(g[q] * act_grad_f32<ACT>(hr));
          }
          s_dh[r * kHC + jj] = d;
        }
      }
      __syncthreads();
      const int kn = min(kHC, H - j0);
#pragma unroll
      for (int i = 0; i < kYPT; ++i) {
        const int idx = tid + i * kThreads;
        if (idx < tile) {
          const float* d = s_dh + (idx / C) * kHC;
          const float* w = w1t + static_cast<size_t>(j0) * C + idx % C;
          float s = acc[i];
          for (int k = 0; k < kn; ++k) {
            s = fmaf(d[k], w[static_cast<size_t>(k) * C], s);
          }
          acc[i] = s;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kYPT; ++i) {
      const int idx = tid + i * kThreads;
      if (idx < tile) s_dxn[idx] = acc[i];
    }
    __syncthreads();

    // this tile's share of dln_scale, dln_bias and db2, tokens in order
    for (int c = tid; c < C; c += kThreads) {
      float sls = 0.f, slb = 0.f, sb2 = 0.f;
      for (int r = 0; r < rows; ++r) {
        const float d = s_dxn[r * C + c];
        sb2 += s_dy[r * C + c];
        if (apply_ln) {
          sls = fmaf(d, (s_x[r * C + c] - s_mu[r]) * s_rstd[r], sls);
          slb += d;
        }
      }
      s_red[c] += sls;
      s_red[C + c] += slb;
      s_red[2 * C + c] += sb2;
    }

    // dx: the LayerNorm backward per token (one warp per token)
    const int warp = tid / 32;
    const int lane = tid % 32;
    for (int r = warp; r < rows; r += kWarps) {
      const float* d = s_dxn + r * C;
      T* out = dx + (row0 + r) * C;
      if (!apply_ln) {
        for (int c = lane; c < C; c += 32) out[c] = from_f32<T>(d[c]);
        continue;
      }
      const float mu = s_mu[r], rstd = s_rstd[r];
      const float* xr = s_x + r * C;
      float s1 = 0.f, s2 = 0.f;
      for (int c = lane; c < C; c += 32) {
        const float dxhat = d[c] * ls[c];
        s1 += dxhat;
        s2 = fmaf(dxhat, (xr[c] - mu) * rstd, s2);
      }
      for (int o = 16; o > 0; o >>= 1) {
        s1 += __shfl_xor_sync(0xffffffffu, s1, o);
        s2 += __shfl_xor_sync(0xffffffffu, s2, o);
      }
      const float m1 = s1 / C, m2 = s2 / C;
      for (int c = lane; c < C; c += 32) {
        const float xhat = (xr[c] - mu) * rstd;
        out[c] = from_f32<T>(rstd * (d[c] * ls[c] - m1 - xhat * m2));
      }
    }
    __syncthreads();  // before the next tile overwrites shared memory
  }
  float* pb = part + static_cast<size_t>(blockIdx.x) * 3 * C;
  for (int i = tid; i < 3 * C; i += kThreads) pb[i] = s_red[i];
}

template <typename T, int ACT>
__global__ void __launch_bounds__(kThreads)
mlp_bwd_weights(const T* __restrict__ x, const float* __restrict__ ls,
                const float* __restrict__ lb, const T* __restrict__ w1,
                const T* __restrict__ b1, const float* __restrict__ w2t,
                const T* __restrict__ dy, float* __restrict__ ws, int M,
                int C, int H, int TM, int WC, int tiles_per_split, float eps,
                int apply_ln) {
  extern __shared__ float smem[];
  const int tile = TM * C;
  float* s_xn = smem;             // [TM, C] fc1 operand
  float* s_dy = s_xn + tile;      // [TM, C] dy
  float* s_dh = s_dy + tile;      // [TM, WC] dh of this block's units
  float* s_a = s_dh + TM * WC;    // [TM, WC] a of this block's units

  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * WC;
  const int wc = min(WC, H - j0);
  const int ntiles = (M + TM - 1) / TM;
  const int t0 = blockIdx.y * tiles_per_split;
  const int t1 = min(ntiles, t0 + tiles_per_split);
  const int nw = C * wc;  // outputs of each slab

  float a1[kYPT], a2[kYPT];  // dW1[c, j0 + j] and dW2[j0 + j, c] slabs
#pragma unroll
  for (int i = 0; i < kYPT; ++i) a1[i] = a2[i] = 0.f;
  float ab1 = 0.f;

  for (int t = t0; t < t1; ++t) {
    const size_t row0 = static_cast<size_t>(t) * TM;
    const int rows = min(TM, static_cast<int>(M - row0));
    const T* xb = x + row0 * C;
    const T* dyb = dy + row0 * C;
    for (int i = tid; i < tile; i += kThreads) {
      const bool in = i < rows * C;
      s_xn[i] = in ? to_f32(xb[i]) : 0.f;
      s_dy[i] = in ? to_f32(dyb[i]) : 0.f;
    }
    __syncthreads();
    if (apply_ln) {
      layernorm_rows<T>(s_xn, s_xn, nullptr, nullptr, ls, lb, rows, C, eps);
      __syncthreads();
    }
    for (int i = tid; i < TM * wc; i += kThreads) {
      const int r = i / wc;
      const int j = i % wc;
      const int jg = j0 + j;
      float av = 0.f, dh = 0.f;
      if (r < rows) {
        float h = 0.f, g = 0.f;
        for (int c = 0; c < C; ++c) {
          h = fmaf(s_xn[r * C + c], to_f32(w1[static_cast<size_t>(c) * H + jg]),
                   h);
          g = fmaf(s_dy[r * C + c], w2t[static_cast<size_t>(c) * H + jg], g);
        }
        const float hr = round_to<T>(h + to_f32(b1[jg]));
        av = round_to<T>(act_f32<ACT>(hr));
        dh = round_to<T>(g * act_grad_f32<ACT>(hr));
      }
      s_a[r * WC + j] = av;
      s_dh[r * WC + j] = dh;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kYPT; ++i) {
      const int idx = tid + i * kThreads;
      if (idx < nw) {
        const int c = idx / wc, j = idx % wc;
        float s = a1[i];
        for (int r = 0; r < rows; ++r) {
          s = fmaf(s_xn[r * C + c], s_dh[r * WC + j], s);
        }
        a1[i] = s;
        const int j2 = idx / C, c2 = idx % C;
        s = a2[i];
        for (int r = 0; r < rows; ++r) {
          s = fmaf(s_a[r * WC + j2], s_dy[r * C + c2], s);
        }
        a2[i] = s;
      }
    }
    if (tid < wc) {
      for (int r = 0; r < rows; ++r) ab1 += s_dh[r * WC + tid];
    }
    __syncthreads();  // before the next tile overwrites shared memory
  }

  float* base = ws + static_cast<size_t>(blockIdx.y) * (2ll * C * H + H);
#pragma unroll
  for (int i = 0; i < kYPT; ++i) {
    const int idx = tid + i * kThreads;
    if (idx < nw) {
      base[static_cast<size_t>(idx / wc) * H + j0 + idx % wc] = a1[i];
      base[static_cast<size_t>(C) * H +
           static_cast<size_t>(j0 + idx / C) * C + idx % C] = a2[i];
    }
  }
  if (tid < wc) base[2ll * C * H + j0 + tid] = ab1;
}

struct Args {
  const void *x, *ls, *lb, *w1, *b1, *w2, *dy;
  void *dx, *dls, *dlb, *dw1, *db1, *dw2, *db2;
  float* ws;
  int M, C, H;
  float eps;
  int apply_ln;
};

template <typename T, int ACT>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const Plan p = make_plan(a.M, a.C, a.H);
  const int C = a.C, H = a.H;
  float* part = a.ws;                  // [P1, 3, C]
  float* wpart = part + p.ws_tokens;   // [S, 2CH + H]
  float* w1t = wpart + p.ws_weights;   // [H, C]
  float* w2t = w1t + static_cast<size_t>(C) * H;  // [C, H]
  cudaError_t err = transpose<T>(a.w1, C, H, w1t, stream);
  if (err != cudaSuccess) return err;
  if ((err = transpose<T>(a.w2, H, C, w2t, stream)) != cudaSuccess) return err;

  const size_t smem1 =
      (4ull * p.TM * C + p.TM * kHC + 2ull * p.TM + 3ull * C) * sizeof(float);
  if ((err = set_smem(mlp_bwd_tokens<T, ACT>, smem1)) != cudaSuccess) {
    return err;
  }
  mlp_bwd_tokens<T, ACT><<<p.P1, kThreads, smem1, stream>>>(
      static_cast<const T*>(a.x), static_cast<const float*>(a.ls),
      static_cast<const float*>(a.lb), static_cast<const T*>(a.w1),
      static_cast<const T*>(a.b1), w1t, w2t, static_cast<const T*>(a.dy),
      static_cast<T*>(a.dx), part, a.M, C, H, p.TM, a.eps, a.apply_ln);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t smem2 = (2ull * p.TM * C + 2ull * p.TM * p.WC) * sizeof(float);
  if ((err = set_smem(mlp_bwd_weights<T, ACT>, smem2)) != cudaSuccess) {
    return err;
  }
  mlp_bwd_weights<T, ACT><<<dim3(p.nchunks, p.S), kThreads, smem2, stream>>>(
      static_cast<const T*>(a.x), static_cast<const float*>(a.ls),
      static_cast<const float*>(a.lb), static_cast<const T*>(a.w1),
      static_cast<const T*>(a.b1), w2t, static_cast<const T*>(a.dy), wpart,
      a.M, C, H, p.TM, p.WC,
      p.tiles_per_split, a.eps, a.apply_ln);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const long long ws_stride = 2ll * C * H + H;
  if ((err = reduce<T>(wpart, p.S, ws_stride, C * H, a.dw1, stream))) return err;
  if ((err = reduce<T>(wpart + static_cast<size_t>(C) * H, p.S, ws_stride,
                       H * C, a.dw2, stream))) {
    return err;
  }
  if ((err = reduce<T>(wpart + 2ll * C * H, p.S, ws_stride, H, a.db1,
                       stream))) {
    return err;
  }
  if ((err = reduce<float>(part, p.P1, 3ll * C, C, a.dls, stream))) return err;
  if ((err = reduce<float>(part + C, p.P1, 3ll * C, C, a.dlb, stream))) {
    return err;
  }
  return reduce<T>(part + 2 * C, p.P1, 3ll * C, C, a.db2, stream);
}

template <typename T>
cudaError_t launch_act(int act, const Args& a, cudaStream_t s) {
  switch (act) {
    case kGelu:
      return launch<T, kGelu>(a, s);
    case kSilu:
      return launch<T, kSilu>(a, s);
    case kRelu:
      return launch<T, kRelu>(a, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Floats of fp32 workspace ogvt_mlp_branch_bwd needs for these shapes.
extern "C" long long ogvt_mlp_branch_bwd_workspace(int M, int C, int H) {
  if (M <= 0 || C < 1 || C > kMaxTile || H < 1) return 0;
  const Plan p = make_plan(M, C, H);
  return p.ws_tokens + p.ws_weights + p.ws_transposed;
}

// x, dy, dx [M, C]; w1, dw1 [C, H]; b1, db1 [H]; w2, dw2 [H, C]; db2 [C]:
// contiguous, of type `dtype`. ln_scale, ln_bias, dln_scale, dln_bias [C]:
// float32. ws: ogvt_mlp_branch_bwd_workspace(M, C, H) floats. Requires
// 1 <= C <= 4096. Every output is written (dln_* are 0 without LN).
extern "C" int ogvt_mlp_branch_bwd(
    const void* x, const void* ln_scale, const void* ln_bias, const void* w1,
    const void* b1, const void* w2, const void* dy, void* dx, void* dln_scale,
    void* dln_bias, void* dw1, void* db1, void* dw2, void* db2, void* ws,
    int M, int C, int H, int act, float eps, int apply_ln, int dtype,
    void* stream) {
  if (M <= 0 || C < 1 || C > kMaxTile || H < 1) return cudaErrorInvalidValue;
  const Args a{x,   ln_scale, ln_bias, w1,  b1,  w2,
               dy,  dx,       dln_scale, dln_bias, dw1, db1,
               dw2, db2,      static_cast<float*>(ws), M, C, H,
               eps, apply_ln};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch_act<float>(act, a, s);
    case kBFloat16:
      return launch_act<__nv_bfloat16>(act, a, s);
    default:
      return cudaErrorInvalidValue;
  }
}
