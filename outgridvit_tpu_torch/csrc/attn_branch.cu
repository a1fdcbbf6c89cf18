// Fused pre-LN grid-attention branch y = proj(MHSA(qkv(LN(x)))) for grids
// of N >= 64 tokens, forward and backward, on tokens or on an NHWC map.
//
// Replaces two TPU kernels that share their branch math (`_rows_fwd` /
// `_rows_bwd`):
// - outgridvit_tpu/ops/attn_branch_pallas.py:attn_branch_pallas (#5):
//   `_fwd_kernel` (attn_branch_fwd here) and `_bwd_kernel` (attn_branch_bwd)
//   on tokens x [G, N, C] (ogvt_attn_branch, ogvt_attn_branch_bwd);
// - outgridvit_tpu/ops/experimental/attn_branch_nhwc_pallas.py:
//   attn_branch_nhwc_pallas (#12): the same on the raw map x [B, H, W, C],
//   the dilated grid partition folded into the loads and stores
//   (ogvt_attn_branch_nhwc, ogvt_attn_branch_nhwc_bwd). Token n = i*Wg + j
//   of window w = (b*g + gy)*g + gx sits at pixel (b, i*g + gy, j*g + gx)
//   (Geom::token, attn_branch_geom.cuh); the windows are numbered in the
//   partition's order (ops/grid.py), so the per-block partials below, and
//   with them the parameter grads, are the same as #5's on the partitioned
//   tokens, bit for bit. Each token's C channels stay contiguous, so a row
//   load stays coalesced; only the stride between tokens changes.
// Both with the rounding points
// (round() is the cast to the compute type, common.cuh:round_to):
//   forward:  xn = round(LN(x)) (fp32 statistics, fast variance clamped at
//             0); qkv = round(xn.Wqkv + bqkv); per head, logits = q.k^T
//             summed in fp32 then scaled; a = softmax (max subtracted,
//             divided by the sum); out = round(round(a).v); y = round(
//             out.Wp + bp).
//   backward: dout = round(dy.Wp^T); dv = a^T.dout from the fp32 a, but the
//             out that feeds dWp = out^T.dy from round(a); dp = dout.v^T;
//             ds = a * (dp - sum_m dp*a); dq = scale * ds.k, dk = scale *
//             ds^T.q; dWqkv = xn^T.round(dqkv) and dxn = round(dqkv).Wqkv^T,
//             but dbqkv = sum of the unrounded dqkv; the LN backward in fp32
//             from xhat and rstd.
// The qkv and output projections run inside the kernels, as in the TPU one.
//
// Which launches run here: fp32 launches both ways, and bf16 ones at the
// shapes the tensor-core kernels (csrc/attn_branch_mma.cu forward,
// ogvt_attn_branch[_nhwc]_mma; csrc/attn_branch_bwd_mma.cu backward,
// ogvt_attn_branch[_nhwc]_bwd_mma) are not instantiated at: every shipped
// bf16 shape goes there. ops/attn_branch.py:forward_entry and
// backward_entry decide by dtype and shape.
//
// What bounds it on the H100: per grid of N tokens the forward does
// 2*N*C*(4C + 2N) flops (3.1 MFLOP at N = C = 64) against 4*N*C bytes of
// x and y in bf16 (16 KB): ~190 flop/byte, below the tensor cores' ridge
// (~295) but far above the fp32 FMA pipe's (~20). These kernels run every
// product on the FMA pipe (no tensor cores), fed from shared memory, so
// they are bound by arithmetic and by the shared-memory loads that feed it.
//
// What the design does about it: one block per grid (forward) keeps x, qkv
// and one head's [N, N] probabilities in shared memory as fp32 (rows padded
// by one float so that column walks do not collide in one bank: 83 KB at
// N = C = 64); only x is read and y written. Every product is a block-wide
// register-tiled loop (block_gemm): a thread owns one output column and RT
// rows, so each operand it loads feeds RT FMAs and the row operand is a warp
// broadcast. The backward recomputes the forward per grid; on the TPU the
// parameter-gradient sums are carried across the sequential grid in VMEM,
// which Hopper cannot do across blocks, and float atomics would make two
// calls differ. So a fixed number of blocks walks the grids, each block
// adds its grids' contributions, in order, into its own fp32 partial in the
// workspace, and a second pass sums the partials in block order
// (partials.cuh). The weights' transposes are copied to the workspace as
// fp32 first, so that every weight walk of this backward is coalesced.
#include <cmath>

#include "attn_branch_geom.cuh"
#include "common.cuh"
#include "partials.cuh"

using namespace ogvt;

namespace {

constexpr int kFwdThreads = 256;
constexpr int kBwdThreads = 512;
constexpr int kMaxBwdBlocks = 264;                     // 2 per SM on 132 SMs
constexpr long long kMaxWorkspaceFloats = 16ll << 20;  // 64 MB of partials
constexpr size_t kMaxSmem = 227 * 1024;

// LayerNorm over the C columns of rows [0, R) of s_x (row stride ld), one
// warp per row, with flax's numerics: fp32 statistics, fast variance clamped
// at 0. Writes round(LN(x)) to s_xn (may alias s_x); when s_rstd is given
// also xhat = (x - mu) * rstd over s_x and rstd to s_rstd.
template <typename T>
__device__ void layernorm_rows(float* s_x, float* s_xn, int ld, int R, int C,
                               const float* __restrict__ ls,
                               const float* __restrict__ lb, float eps,
                               float* s_rstd) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < R; r += blockDim.x / 32) {
    float* xr = s_x + r * ld;
    float s = 0.f, ss = 0.f;
    for (int c = lane; c < C; c += 32) {
      s += xr[c];
      ss = fmaf(xr[c], xr[c], ss);
    }
    s = warp_sum(s);
    ss = warp_sum(ss);
    const float mu = s / C;
    const float rstd = rsqrtf(fmaxf(0.f, ss / C - mu * mu) + eps);
    for (int c = lane; c < C; c += 32) {
      const float d = xr[c] - mu;
      s_xn[r * ld + c] = round_to<T>(d * (rstd * ls[c]) + lb[c]);
      if (s_rstd != nullptr) xr[c] = d * rstd;
    }
    if (s_rstd != nullptr && lane == 0) s_rstd[r] = rstd;
  }
}

// Shared-memory floats of one block; the Python wrapper
// (ops/attn_branch.py:smem_bytes) mirrors both.
size_t fwd_smem_floats(int N, int C) {
  return static_cast<size_t>(N) * ((C + 1) + (3 * C + 1) + (N + 1));
}

size_t bwd_smem_floats(int N, int C, int heads) {
  const int hd = C / heads;
  return static_cast<size_t>(N) *
         (5 * (C + 1) + (3 * C + 1) + 2 * (N + 1) + (hd + 1) + 1);
}

template <typename T>
__global__ void __launch_bounds__(kFwdThreads)
attn_branch_fwd(const T* __restrict__ x, const float* __restrict__ ls,
                const float* __restrict__ lb, const T* __restrict__ wqkv,
                const T* __restrict__ bqkv, const T* __restrict__ wp,
                const T* __restrict__ bp, T* __restrict__ y, Geom geo, int N,
                int C, int heads, float scale, float eps, int apply_ln) {
  constexpr int RT = 8;
  extern __shared__ float smem[];
  const int C3 = 3 * C, hd = C / heads;
  const int lx = C + 1, lq = C3 + 1, lp = N + 1;  // padded row strides
  float* s_x = smem;            // [N, lx] round(LN(x)), then MHSA's output
  float* s_qkv = s_x + N * lx;  // [N, lq] q | k | v, heads contiguous
  float* s_p = s_qkv + N * lq;  // [N, lp] one head's logits, then round(a)

  const int w = blockIdx.x;
  for (int i = threadIdx.x; i < N * C; i += blockDim.x) {
    s_x[(i / C) * lx + i % C] = to_f32(x[geo.token(w, i / C, N, C) + i % C]);
  }
  __syncthreads();
  if (apply_ln) {
    layernorm_rows<T>(s_x, s_x, lx, N, C, ls, lb, eps, nullptr);
    __syncthreads();
  }
  block_gemm<RT, float>(s_x, lx, 1, N, C, wqkv, C3, 1, C3,
                        [&](int n, int j, float acc) {
                          s_qkv[n * lq + j] =
                              round_to<T>(acc + to_f32(bqkv[j]));
                        });
  __syncthreads();
  for (int h = 0; h < heads; ++h) {
    const float* q = s_qkv + h * hd;
    const float* k = q + C;
    const float* v = q + 2 * C;
    block_gemm<RT, float>(q, lq, 1, N, hd, k, 1, lq, N,
                          [&](int n, int m, float acc) {
                            s_p[n * lp + m] = acc * scale;
                          });
    __syncthreads();
    softmax_rows<T>(s_p, lp, N, N, true);
    __syncthreads();
    block_gemm<RT, float>(s_p, lp, 1, N, N, v, lq, 1, hd,
                          [&](int n, int d, float acc) {
                            s_x[n * lx + h * hd + d] = round_to<T>(acc);
                          });
    __syncthreads();
  }
  block_gemm<RT, float>(s_x, lx, 1, N, C, wp, C, 1, C,
                        [&](int n, int j, float acc) {
                          y[geo.token(w, n, N, C) + j] =
                              from_f32<T>(acc + to_f32(bp[j]));
                        });
}

// Parameter-gradient partial of one block: dWqkv [C, 3C], dWp [C, C],
// dbqkv [3C], dbp [C], dln_scale [C], dln_bias [C].
__host__ __device__ long long partial_floats(int C) {
  return 4ll * C * C + 6ll * C;
}

template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
attn_branch_bwd(const T* __restrict__ x, const float* __restrict__ ls,
                const float* __restrict__ lb, const T* __restrict__ wqkv,
                const T* __restrict__ bqkv, const float* __restrict__ wqkvt,
                const float* __restrict__ wpt, const T* __restrict__ dy,
                T* __restrict__ dx, float* __restrict__ part, Geom geo, int G,
                int N, int C, int heads, float scale, float eps,
                int apply_ln) {
  constexpr int RT = 4;
  extern __shared__ float smem[];
  const int C3 = 3 * C, hd = C / heads;
  const int lx = C + 1, lq = C3 + 1, lp = N + 1, lt = hd + 1;
  float* s_x = smem;              // [N, lx] x, then xhat
  float* s_xn = s_x + N * lx;     // [N, lx] round(LN(x)) (x without LN)
  float* s_dy = s_xn + N * lx;    // [N, lx] dy, then dxn
  float* s_dout = s_dy + N * lx;  // [N, lx] round(dy.Wp^T)
  float* s_out = s_dout + N * lx; // [N, lx] round(round(a).v), recomputed
  float* s_qkv = s_out + N * lx;  // [N, lq] qkv, then dqkv
  float* s_a = s_qkv + N * lq;    // [N, lp] one head's a (fp32)
  float* s_ds = s_a + N * lp;     // [N, lp] dp, then ds
  float* s_t = s_ds + N * lp;     // [N, lt] one head's dk
  float* s_rstd = s_t + N * lt;   // [N]

  float* p_dwqkv = part + blockIdx.x * partial_floats(C);
  float* p_dwp = p_dwqkv + C * C3;
  float* p_dbqkv = p_dwp + C * C;
  float* p_dbp = p_dbqkv + C3;
  float* p_dls = p_dbp + C;
  float* p_dlb = p_dls + C;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;

  for (int w = blockIdx.x; w < G; w += gridDim.x) {
    for (int i = tid; i < N * C; i += blockDim.x) {
      const int e = (i / C) * lx + i % C;
      const size_t src = geo.token(w, i / C, N, C) + i % C;
      s_x[e] = s_xn[e] = to_f32(x[src]);
      s_dy[e] = to_f32(dy[src]);
    }
    __syncthreads();
    if (apply_ln) {
      layernorm_rows<T>(s_x, s_xn, lx, N, C, ls, lb, eps, s_rstd);
      __syncthreads();
    }
    block_gemm<RT, float>(s_xn, lx, 1, N, C, wqkv, C3, 1, C3,
                          [&](int n, int j, float acc) {
                            s_qkv[n * lq + j] =
                                round_to<T>(acc + to_f32(bqkv[j]));
                          });
    block_gemm<RT, float>(s_dy, lx, 1, N, C, wpt, C, 1, C,
                          [&](int n, int c, float acc) {
                            s_dout[n * lx + c] = round_to<T>(acc);
                          });
    __syncthreads();

    for (int h = 0; h < heads; ++h) {
      const int o = h * hd;
      float* q = s_qkv + o;
      float* k = q + C;
      float* v = q + 2 * C;
      block_gemm<RT, float>(q, lq, 1, N, hd, k, 1, lq, N,
                            [&](int n, int m, float acc) {
                              s_a[n * lp + m] = acc * scale;
                            });
      __syncthreads();
      softmax_rows<T>(s_a, lp, N, N, false);
      __syncthreads();
      // out_h = round(round(a).v); dp = dout_h.v^T
      block_gemm<RT, T>(s_a, lp, 1, N, N, v, lq, 1, hd,
                        [&](int n, int d, float acc) {
                          s_out[n * lx + o + d] = round_to<T>(acc);
                        });
      block_gemm<RT, float>(s_dout + o, lx, 1, N, hd, v, 1, lq, N,
                            [&](int n, int m, float acc) {
                              s_ds[n * lp + m] = acc;
                            });
      __syncthreads();
      // ds = a * (dp - sum_m dp*a), one warp per row; dv = a^T.dout_h
      // into v's columns (v is not read again)
      for (int r = warp; r < N; r += blockDim.x / 32) {
        const float* ar = s_a + r * lp;
        float* dr = s_ds + r * lp;
        float s = 0.f;
        for (int m = lane; m < N; m += 32) s = fmaf(dr[m], ar[m], s);
        s = warp_sum(s);
        for (int m = lane; m < N; m += 32) dr[m] = ar[m] * (dr[m] - s);
      }
      block_gemm<RT, float>(s_a, 1, lp, N, N, s_dout + o, lx, 1, hd,
                            [&](int m, int d, float acc) {
                              v[m * lq + d] = acc;
                            });
      __syncthreads();
      block_gemm<RT, float>(s_ds, 1, lp, N, N, q, lq, 1, hd,
                            [&](int m, int d, float acc) {
                              s_t[m * lt + d] = acc * scale;
                            });
      __syncthreads();
      // dq into q's columns (q is not read again), then dk into k's
      block_gemm<RT, float>(s_ds, lp, 1, N, N, k, lq, 1, hd,
                            [&](int n, int d, float acc) {
                              q[n * lq + d] = acc * scale;
                            });
      __syncthreads();
      for (int i = tid; i < N * hd; i += blockDim.x) {
        k[(i / hd) * lq + i % hd] = s_t[(i / hd) * lt + i % hd];
      }
    }
    __syncthreads();

    // dWp += out^T.dy, dbp += sum dy, dbqkv += sum dqkv (unrounded)
    block_gemm<RT, float>(s_out, 1, lx, C, N, s_dy, lx, 1, C,
                          [&](int c, int j, float acc) {
                            p_dwp[c * C + j] += acc;
                          });
    for (int j = tid; j < C3; j += blockDim.x) {
      float s = 0.f;
      for (int n = 0; n < N; ++n) s += s_qkv[n * lq + j];
      p_dbqkv[j] += s;
    }
    for (int j = tid; j < C; j += blockDim.x) {
      float s = 0.f;
      for (int n = 0; n < N; ++n) s += s_dy[n * lx + j];
      p_dbp[j] += s;
    }
    __syncthreads();
    for (int i = tid; i < N * C3; i += blockDim.x) {
      const int e = (i / C3) * lq + i % C3;
      s_qkv[e] = round_to<T>(s_qkv[e]);
    }
    __syncthreads();
    // dWqkv += xn^T.round(dqkv); dxn = round(dqkv).Wqkv^T into s_dy
    block_gemm<RT, float>(s_xn, 1, lx, C, N, s_qkv, lq, 1, C3,
                          [&](int c, int j, float acc) {
                            p_dwqkv[c * C3 + j] += acc;
                          });
    block_gemm<RT, float>(s_qkv, lq, 1, N, C3, wqkvt, C, 1, C,
                          [&](int n, int c, float acc) {
                            s_dy[n * lx + c] = acc;
                          });
    __syncthreads();

    if (apply_ln) {
      for (int c = tid; c < C; c += blockDim.x) {
        float sls = 0.f, slb = 0.f;
        for (int n = 0; n < N; ++n) {
          sls = fmaf(s_dy[n * lx + c], s_x[n * lx + c], sls);
          slb += s_dy[n * lx + c];
        }
        p_dls[c] += sls;
        p_dlb[c] += slb;
      }
      for (int r = warp; r < N; r += blockDim.x / 32) {
        const float* d = s_dy + r * lx;
        const float* xh = s_x + r * lx;
        float s1 = 0.f, s2 = 0.f;
        for (int c = lane; c < C; c += 32) {
          const float dxhat = d[c] * ls[c];
          s1 += dxhat;
          s2 = fmaf(dxhat, xh[c], s2);
        }
        const float m1 = warp_sum(s1) / C, m2 = warp_sum(s2) / C;
        T* dxr = dx + geo.token(w, r, N, C);
        for (int c = lane; c < C; c += 32) {
          dxr[c] = from_f32<T>(s_rstd[r] * (d[c] * ls[c] - m1 - xh[c] * m2));
        }
      }
    } else {
      for (int i = tid; i < N * C; i += blockDim.x) {
        dx[geo.token(w, i / C, N, C) + i % C] =
            from_f32<T>(s_dy[(i / C) * lx + i % C]);
      }
    }
    __syncthreads();  // before the next grid overwrites shared memory
  }
}

struct BwdPlan {
  int P;                  // blocks, each with its own partial
  long long partials;     // floats of the P partials
  long long transposed;   // Wqkv^T [3C, C] and Wp^T [C, C] in fp32
};

BwdPlan bwd_plan(int G, int C) {
  BwdPlan p;
  const long long per = partial_floats(C);
  long long P = G < kMaxBwdBlocks ? G : kMaxBwdBlocks;
  if (P * per > kMaxWorkspaceFloats) P = kMaxWorkspaceFloats / per;
  p.P = static_cast<int>(P < 1 ? 1 : P);
  p.partials = per * p.P;
  p.transposed = 4ll * C * C;
  return p;
}

bool shape_ok(int G, int N, int C, int heads) {
  return G >= 0 && N >= 1 && C >= 1 && heads >= 1 && C % heads == 0;
}

template <typename T>
cudaError_t launch_fwd(const void* x, const void* ls, const void* lb,
                       const void* wqkv, const void* bqkv, const void* wp,
                       const void* bp, void* y, Geom geo, int G, int N,
                       int C, int heads, float scale, float eps,
                       int apply_ln, cudaStream_t stream) {
  const size_t smem = fwd_smem_floats(N, C) * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = set_smem(attn_branch_fwd<T>, smem);
  if (err != cudaSuccess) return err;
  attn_branch_fwd<T><<<G, kFwdThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(ls),
      static_cast<const float*>(lb), static_cast<const T*>(wqkv),
      static_cast<const T*>(bqkv), static_cast<const T*>(wp),
      static_cast<const T*>(bp), static_cast<T*>(y), geo, N, C, heads, scale,
      eps, apply_ln);
  return cudaGetLastError();
}

struct BwdArgs {
  const void *x, *ls, *lb, *wqkv, *bqkv, *wp, *dy;
  void *dx, *dls, *dlb, *dwqkv, *dbqkv, *dwp, *dbp;
  float* ws;
  Geom geo;
  int G, N, C, heads;
  float scale, eps;
  int apply_ln;
};

template <typename T>
cudaError_t launch_bwd(const BwdArgs& a, cudaStream_t stream) {
  const int C = a.C, C3 = 3 * a.C;
  const size_t smem = bwd_smem_floats(a.N, C, a.heads) * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const BwdPlan p = bwd_plan(a.G, C);
  float* part = a.ws;                                      // [P, partial]
  float* wqkvt = part + p.partials;                        // [3C, C]
  float* wpt = wqkvt + static_cast<size_t>(C3) * C;       // [C, C]
  cudaError_t err = transpose<T>(a.wqkv, C, C3, wqkvt, stream);
  if (err != cudaSuccess) return err;
  if ((err = transpose<T>(a.wp, C, C, wpt, stream)) != cudaSuccess) return err;
  err = cudaMemsetAsync(part, 0, p.partials * sizeof(float), stream);
  if (err != cudaSuccess) return err;
  if ((err = set_smem(attn_branch_bwd<T>, smem)) != cudaSuccess) return err;
  attn_branch_bwd<T><<<p.P, kBwdThreads, smem, stream>>>(
      static_cast<const T*>(a.x), static_cast<const float*>(a.ls),
      static_cast<const float*>(a.lb), static_cast<const T*>(a.wqkv),
      static_cast<const T*>(a.bqkv), wqkvt, wpt, static_cast<const T*>(a.dy),
      static_cast<T*>(a.dx), part, a.geo, a.G, a.N, C, a.heads, a.scale,
      a.eps, a.apply_ln);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const long long stride = partial_floats(C);
  const long long o_dwp = 3ll * C * C, o_dbqkv = 4ll * C * C;
  const long long o_dbp = o_dbqkv + C3, o_dls = o_dbp + C, o_dlb = o_dls + C;
  if ((err = reduce<T>(part, p.P, stride, C * C3, a.dwqkv, stream))) {
    return err;
  }
  if ((err = reduce<T>(part + o_dwp, p.P, stride, C * C, a.dwp, stream))) {
    return err;
  }
  if ((err = reduce<T>(part + o_dbqkv, p.P, stride, C3, a.dbqkv, stream))) {
    return err;
  }
  if ((err = reduce<T>(part + o_dbp, p.P, stride, C, a.dbp, stream))) {
    return err;
  }
  if ((err = reduce<float>(part + o_dls, p.P, stride, C, a.dls, stream))) {
    return err;
  }
  return reduce<float>(part + o_dlb, p.P, stride, C, a.dlb, stream);
}

int fwd(const void* x, const void* ln_scale, const void* ln_bias,
        const void* wqkv, const void* bqkv, const void* wp, const void* bp,
        void* y, Geom geo, int G, int N, int C, int heads, float scale,
        float eps, int apply_ln, int dtype, void* stream) {
  if (!shape_ok(G, N, C, heads)) return cudaErrorInvalidValue;
  if (G == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch_fwd<float>(x, ln_scale, ln_bias, wqkv, bqkv, wp, bp, y,
                               geo, G, N, C, heads, scale, eps, apply_ln, s);
    case kBFloat16:
      return launch_fwd<__nv_bfloat16>(x, ln_scale, ln_bias, wqkv, bqkv, wp,
                                       bp, y, geo, G, N, C, heads, scale, eps,
                                       apply_ln, s);
    default:
      return cudaErrorInvalidValue;
  }
}

int bwd(const BwdArgs& a, int dtype, void* stream) {
  if (!shape_ok(a.G, a.N, a.C, a.heads) || a.G == 0) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch_bwd<float>(a, s);
    case kBFloat16:
      return launch_bwd<__nv_bfloat16>(a, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x, y [G, N, C]; wqkv [C, 3C]; bqkv [3C]; wp [C, C]; bp [C]: contiguous,
// of type `dtype`. ln_scale, ln_bias [C]: float32. scale = (C/heads)^-1/2.
extern "C" int ogvt_attn_branch(const void* x, const void* ln_scale,
                                const void* ln_bias, const void* wqkv,
                                const void* bqkv, const void* wp,
                                const void* bp, void* y, int G, int N, int C,
                                int heads, float scale, float eps,
                                int apply_ln, int dtype, void* stream) {
  return fwd(x, ln_scale, ln_bias, wqkv, bqkv, wp, bp, y, Geom{0, 0, 0}, G,
             N, C, heads, scale, eps, apply_ln, dtype, stream);
}

// The same on x, y [B, H, W, C] with grid size g (H and W divisible by g):
// the B*g*g windows of (H/g)*(W/g) tokens each.
extern "C" int ogvt_attn_branch_nhwc(const void* x, const void* ln_scale,
                                     const void* ln_bias, const void* wqkv,
                                     const void* bqkv, const void* wp,
                                     const void* bp, void* y, int B, int H,
                                     int W, int C, int g, int heads,
                                     float scale, float eps, int apply_ln,
                                     int dtype, void* stream) {
  Geom geo;
  int G, N;
  if (!nhwc_geom(B, H, W, g, &geo, &G, &N)) return cudaErrorInvalidValue;
  return fwd(x, ln_scale, ln_bias, wqkv, bqkv, wp, bp, y, geo, G, N, C, heads,
             scale, eps, apply_ln, dtype, stream);
}

// Floats of fp32 workspace ogvt_attn_branch_bwd needs for these shapes.
extern "C" long long ogvt_attn_branch_bwd_workspace(int G, int C) {
  if (G <= 0 || C < 1) return 0;
  const BwdPlan p = bwd_plan(G, C);
  return p.partials + p.transposed;
}

// x, dy, dx [G, N, C]; wqkv, dwqkv [C, 3C]; bqkv, dbqkv [3C]; wp, dwp
// [C, C]; dbp [C]: contiguous, of type `dtype`. ln_scale, ln_bias,
// dln_scale, dln_bias [C]: float32 (dln_* are 0 without LN). ws:
// ogvt_attn_branch_bwd_workspace(G, C) floats.
extern "C" int ogvt_attn_branch_bwd(
    const void* x, const void* ln_scale, const void* ln_bias,
    const void* wqkv, const void* bqkv, const void* wp, const void* dy,
    void* dx, void* dln_scale, void* dln_bias, void* dwqkv, void* dbqkv,
    void* dwp, void* dbp, void* ws, int G, int N, int C, int heads,
    float scale, float eps, int apply_ln, int dtype, void* stream) {
  const BwdArgs a{x, ln_scale, ln_bias, wqkv, bqkv, wp, dy,
                  dx, dln_scale, dln_bias, dwqkv, dbqkv, dwp, dbp,
                  static_cast<float*>(ws), Geom{0, 0, 0}, G, N, C, heads,
                  scale, eps, apply_ln};
  return bwd(a, dtype, stream);
}

// The same on x, dy, dx [B, H, W, C] with grid size g; ws:
// ogvt_attn_branch_bwd_workspace(B*g*g, C) floats.
extern "C" int ogvt_attn_branch_nhwc_bwd(
    const void* x, const void* ln_scale, const void* ln_bias,
    const void* wqkv, const void* bqkv, const void* wp, const void* dy,
    void* dx, void* dln_scale, void* dln_bias, void* dwqkv, void* dbqkv,
    void* dwp, void* dbp, void* ws, int B, int H, int W, int C, int g,
    int heads, float scale, float eps, int apply_ln, int dtype,
    void* stream) {
  Geom geo;
  int G, N;
  if (!nhwc_geom(B, H, W, g, &geo, &G, &N)) return cudaErrorInvalidValue;
  const BwdArgs a{x, ln_scale, ln_bias, wqkv, bqkv, wp, dy,
                  dx, dln_scale, dln_bias, dwqkv, dbqkv, dwp, dbp,
                  static_cast<float*>(ws), geo, G, N, C, heads,
                  scale, eps, apply_ln};
  return bwd(a, dtype, stream);
}
