// Fused outlook value path for K = 3, stride 1, forward and backward:
//   #7  out = aggregate(v, a).Wp + bp
//   #8  out = aggregate(x.Wv + bv, a).Wp + bp   (kFold: v never in memory)
// aggregate(v, a)[p, c] = sum_t v[p + off_t, c] * a[p, head(c)*9 + t], taps
// t = 3*(dy+1) + (dx+1) row-major, zero outside the image (zero v, not bv).
//
// Replaces the TPU kernels of outgridvit_tpu/ops/experimental/
// outlook_agg_pallas.py: outlook_attention_proj_pallas (#7: `_fwd_kernel`,
// `_fwd_chunk_kernel`, `_bwd_kernel`, `_bwd_chunk_kernel`) and
// outlook_branch_pallas (#8: `_fwdv_kernel`, `_fwdv_chunk_kernel`,
// `_bwdv_kernel`, `_bwdv_chunk_kernel`), with their rounding points
// (round() is the cast to the compute type, common.cuh:round_to):
//   forward:  v = x.Wv + bv stays fp32 (kFold); y = round(sum_t v*w_t), the
//             taps summed in order, each product rounded apart; out =
//             round(y.Wp + bp) summed in fp32.
//   backward: y recomputed; dyag = g.Wp^T in fp32; da[p, h*9+t] = sum over
//             head h's channels of v[p + off_t] * dyag[p]; dv[q] = sum_t
//             (dyag * w_t)[q - off_t] in fp32; dWp = y^T.g, dbp = sum g;
//             kFold: dx = round(dv).Wv^T, dWv = x^T.round(dv), dbv = sum of
//             the unrounded dv. Parameter grads are fp32 sums over every
//             pixel, cast once.
// The projections run inside the kernels, as in the TPU ones.
//
// What bounds it on the H100: per pixel and channel the forward of #7 does
// 18 flop of taps and 2 * C of projection against about 4 bytes moved in
// bf16 (v and a read, out written): 36 flop per byte at C = 64, above the
// fp32 FMA pipe's balance (~20) and far below the tensor cores' (~295). On
// the FMA pipe, as here, it is bound by arithmetic and by the shared-memory
// loads that feed it; #8 adds the x.Wv product and saves v's write and
// read. This first version runs every product on the FMA pipe.
//
// What the design does about it: a block takes a tile of `rows` whole image
// rows of one image plus a one-row halo above and below, in shared memory
// as fp32 (rows padded by one float so that column walks do not collide in
// a bank); v is read once per tile (the halo rows twice), and the aggregate
// never leaves shared memory. A 64 x 64 x 64 stage-0 image does not fit
// (1 MB in fp32), so the Python side picks `rows` (at most 128 pixels, and
// what shared memory holds), as the TPU kernel's row-chunked variant does.
// The backward is two passes: (1) per tile, recompute y, dyag = g.Wp^T, da,
// and the dWp / dbp partials, writing dyag to an fp32 workspace; (2) per
// tile with a halo, dv in gather form, dv[q] = sum_t (dyag * w_t)[q -
// off_t], so no pixel is scattered to twice (and, kFold, dx and the dWv /
// dbv partials). The TPU carries the weight-gradient sums across its
// sequential grid in VMEM, which Hopper cannot do across blocks, and float
// atomics would make two calls differ: a fixed number of blocks walks the
// tiles, each adds its tiles' sums in order into its own fp32 partial, and
// a last pass sums the partials in block order (partials.cuh).
#include "common.cuh"
#include "partials.cuh"

using namespace ogvt;

namespace {

constexpr int kFwdThreads = 256;
constexpr int kBwdThreads = 512;
constexpr int kMaxBwdBlocks = 264;                     // 2 per SM on 132 SMs
constexpr long long kMaxWorkspaceFloats = 16ll << 20;  // 64 MB of partials
constexpr size_t kMaxSmem = 227 * 1024;
constexpr int kTaps = 9;

struct Dims {
  int B, H, W, Cin, C, heads, rows;
  __host__ __device__ int hd() const { return C / heads; }
  __host__ __device__ int h9() const { return kTaps * heads; }
  __host__ __device__ int tiles() const {
    return B * ((H + rows - 1) / rows);
  }
};

// Shared-memory floats of each kernel for a tile of `rows` image rows; the
// Python wrapper (ops/outlook_agg.py:smem_bytes) mirrors all three. x
// shares its space with what is loaded after v is made from it.
size_t fwd_smem_floats(const Dims& d, bool fold) {
  const size_t ext = (d.rows + 2) * d.W, S = d.rows * d.W;
  const size_t lc = d.C + 1, la = d.h9() + 1, li = d.Cin + 1;
  const size_t rest = S * la + S * lc;
  return ext * lc + (fold && ext * li > rest ? ext * li : rest);
}

size_t bwd_proj_smem_floats(const Dims& d, bool fold) {
  const size_t ext = (d.rows + 2) * d.W, S = d.rows * d.W;
  const size_t lc = d.C + 1, la = d.h9() + 1, li = d.Cin + 1;
  const size_t rest = S * la + 3 * S * lc;
  return ext * lc + (fold && ext * li > rest ? ext * li : rest);
}

size_t bwd_dv_smem_floats(const Dims& d, bool fold) {
  const size_t ext = (d.rows + 2) * d.W, S = d.rows * d.W;
  const size_t lc = d.C + 1, la = d.h9() + 1, li = d.Cin + 1;
  return ext * lc + ext * la + (fold ? S * lc + S * li : 0);
}

// A tile: image b, image rows [r0, r0 + nr). Row e of the haloed tile is
// image row r0 - 1 + e; rows [e_lo, e_hi) of it lie inside the image.
struct Tile {
  int b, r0, nr, e_lo, e_hi;
  long long pix0;  // flat index of pixel (b, r0, 0)
  __device__ Tile(int t, int H, int W, int rows) {
    const int per = (H + rows - 1) / rows;
    b = t / per;
    r0 = (t % per) * rows;
    nr = min(rows, H - r0);
    e_lo = r0 == 0 ? 1 : 0;
    e_hi = min(rows + 2, H - r0 + 1);
    pix0 = (static_cast<long long>(b) * H + r0) * W;
  }
};

// s_v[e*W + j][c] = v at row e of the haloed tile, zero outside the image.
// Without the fold v is read from `x`; with it, x (into s_x) times Wv plus
// bv, in fp32 (`_fwdv_kernel`: never rounded). Ends with a barrier.
template <typename T, bool kFold, int RT>
__device__ void load_values(const T* __restrict__ x, const T* __restrict__ wv,
                            const T* __restrict__ bv, float* s_v, float* s_x,
                            const Tile& tl, int W, int Cin, int C, int rows) {
  const int lc = C + 1, li = Cin + 1;
  const int lo = tl.e_lo * W, hi = tl.e_hi * W, n = (rows + 2) * W;
  const long long base = tl.pix0 - W;  // flat index of haloed pixel 0
  if constexpr (!kFold) {
    for (int i = threadIdx.x; i < n * C; i += blockDim.x) {
      const int p = i / C, c = i % C;
      s_v[p * lc + c] =
          (p >= lo && p < hi) ? to_f32(x[(base + p) * C + c]) : 0.f;
    }
  } else {
    for (int i = threadIdx.x; i < (hi - lo) * Cin; i += blockDim.x) {
      const int p = lo + i / Cin, c = i % Cin;
      s_x[p * li + c] = to_f32(x[(base + p) * Cin + c]);
    }
    for (int i = threadIdx.x; i < n * C; i += blockDim.x) {
      const int p = i / C;
      if (p < lo || p >= hi) s_v[p * lc + i % C] = 0.f;
    }
    __syncthreads();
    block_gemm<RT, float>(s_x + lo * li, li, 1, hi - lo, Cin, wv, C, 1, C,
                          [&](int r, int c, float acc) {
                            s_v[(lo + r) * lc + c] = acc + to_f32(bv[c]);
                          });
  }
  __syncthreads();
}

// s_y[p][c] = round(sum_t s_v[p + off_t][c] * s_a[p][head(c)*9 + t]) for
// the S pixels of the tile; a tap outside the image's columns adds nothing
// (outside its rows, s_v is zero).
template <typename T>
__device__ void aggregate(const float* s_v, const float* s_a, float* s_y,
                          int S, int W, int C, int hd, int la) {
  const int lc = C + 1;
  for (int i = threadIdx.x; i < S * C; i += blockDim.x) {
    const int p = i / C, c = i % C, pi = p / W, pj = p % W;
    const float* w = s_a + p * la + (c / hd) * kTaps;
    float acc = 0.f;
#pragma unroll
    for (int t = 0; t < kTaps; ++t) {
      const int qj = pj + t % 3 - 1;
      if (qj < 0 || qj >= W) continue;
      // haloed row of the source pixel: pi + 1 + dy = pi + t / 3
      acc = __fadd_rn(acc, __fmul_rn(s_v[((pi + t / 3) * W + qj) * lc + c],
                                     w[t]));
    }
    s_y[p * lc + c] = round_to<T>(acc);
  }
}

template <typename T>
__device__ void load_rows(const T* __restrict__ src, long long first, int n,
                          int cols, float* dst, int ld) {
  for (int i = threadIdx.x; i < n * cols; i += blockDim.x) {
    dst[(i / cols) * ld + i % cols] = to_f32(src[first * cols + i]);
  }
}

template <typename T, bool kFold>
__global__ void __launch_bounds__(kFwdThreads)
outlook_fwd(const T* __restrict__ x, const T* __restrict__ a,
            const T* __restrict__ wv, const T* __restrict__ bv,
            const T* __restrict__ wp, const T* __restrict__ bp,
            T* __restrict__ out, Dims d) {
  constexpr int RT = 8;
  extern __shared__ float smem[];
  const int W = d.W, C = d.C, h9 = d.h9();
  const int lc = C + 1, la = h9 + 1;
  const Tile tl(blockIdx.x, d.H, W, d.rows);
  const int S = tl.nr * W;
  float* s_v = smem;                            // [(rows+2)*W, lc]
  float* s_x = s_v + (d.rows + 2) * W * lc;     // [(rows+2)*W, Cin+1]
  float* s_a = s_x;                             // [rows*W, la], after v
  float* s_y = s_a + d.rows * W * la;           // [rows*W, lc]

  load_values<T, kFold, RT>(x, wv, bv, s_v, s_x, tl, W, d.Cin, C, d.rows);
  load_rows(a, tl.pix0, S, h9, s_a, la);
  __syncthreads();
  aggregate<T>(s_v, s_a, s_y, S, W, C, d.hd(), la);
  __syncthreads();
  T* o = out + tl.pix0 * C;
  block_gemm<RT, float>(s_y, lc, 1, S, C, wp, C, 1, C,
                        [&](int n, int j, float acc) {
                          o[n * C + j] = from_f32<T>(acc + to_f32(bp[j]));
                        });
}

// Parameter-gradient partials of one block.
__host__ __device__ long long proj_partial_floats(int C) {
  return static_cast<long long>(C) * C + C;  // dWp [C, C], dbp [C]
}
__host__ __device__ long long fold_partial_floats(int Cin, int C) {
  return static_cast<long long>(Cin) * C + C;  // dWv [Cin, C], dbv [C]
}

// Pass 1, per tile: y, dyag = g.Wp^T (to the fp32 workspace), da, and the
// block's dWp / dbp partial. wpt = Wp^T in fp32 ([j][c] = Wp[c][j]).
template <typename T, bool kFold>
__global__ void __launch_bounds__(kBwdThreads)
outlook_bwd_proj(const T* __restrict__ x, const T* __restrict__ a,
                 const T* __restrict__ wv, const T* __restrict__ bv,
                 const float* __restrict__ wpt, const T* __restrict__ g,
                 float* __restrict__ dyag, T* __restrict__ da,
                 float* __restrict__ part, Dims d) {
  constexpr int RT = 4;
  extern __shared__ float smem[];
  const int W = d.W, C = d.C, hd = d.hd(), h9 = d.h9();
  const int lc = C + 1, la = h9 + 1, S_max = d.rows * W;
  float* s_v = smem;                         // [(rows+2)*W, lc]
  float* s_x = s_v + (d.rows + 2) * W * lc;  // [(rows+2)*W, Cin+1]
  float* s_a = s_x;                          // [rows*W, la], after v
  float* s_y = s_a + S_max * la;             // [rows*W, lc] round(agg)
  float* s_g = s_y + S_max * lc;             // [rows*W, lc] g
  float* s_d = s_g + S_max * lc;             // [rows*W, lc] dyag
  float* p_dwp = part + blockIdx.x * proj_partial_floats(C);
  float* p_dbp = p_dwp + C * C;
  const int ntiles = d.tiles();

  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const Tile tl(t, d.H, W, d.rows);
    const int S = tl.nr * W;
    load_values<T, kFold, RT>(x, wv, bv, s_v, s_x, tl, W, d.Cin, C, d.rows);
    load_rows(a, tl.pix0, S, h9, s_a, la);
    load_rows(g, tl.pix0, S, C, s_g, lc);
    __syncthreads();
    aggregate<T>(s_v, s_a, s_y, S, W, C, hd, la);
    block_gemm<RT, float>(s_g, lc, 1, S, C, wpt, C, 1, C,
                          [&](int n, int c, float acc) {
                            s_d[n * lc + c] = acc;
                          });
    __syncthreads();
    // dWp += y^T.g, dbp += sum g
    block_gemm<RT, float>(s_y, 1, lc, C, S, s_g, lc, 1, C,
                          [&](int c, int j, float acc) {
                            p_dwp[c * C + j] += acc;
                          });
    for (int j = threadIdx.x; j < C; j += blockDim.x) {
      float s = 0.f;
      for (int p = 0; p < S; ++p) s += s_g[p * lc + j];
      p_dbp[j] += s;
    }
    float* dyag_t = dyag + tl.pix0 * C;
    for (int i = threadIdx.x; i < S * C; i += blockDim.x) {
      dyag_t[i] = s_d[(i / C) * lc + i % C];
    }
    // da[p][h*9+t] = sum_{c in head h} v[p + off_t][c] * dyag[p][c]
    T* da_t = da + tl.pix0 * h9;
    for (int i = threadIdx.x; i < S * h9; i += blockDim.x) {
      const int p = i / h9, k = i % h9, h = k / kTaps, tap = k % kTaps;
      const int qj = p % W + tap % 3 - 1;
      float s = 0.f;
      if (qj >= 0 && qj < W) {
        const float* v = s_v + ((p / W + tap / 3) * W + qj) * lc + h * hd;
        const float* dy = s_d + p * lc + h * hd;
        for (int e = 0; e < hd; ++e) s = fmaf(v[e], dy[e], s);
      }
      da_t[i] = from_f32<T>(s);
    }
    __syncthreads();  // before the next tile overwrites shared memory
  }
}

// Pass 2, per tile with a one-row halo: dv[q] = sum_t (dyag * w_t)[q -
// off_t] from the fp32 dyag of pass 1. Without the fold, dv is the output;
// with it, dx = round(dv).Wv^T and the block's dWv / dbv partial. wvt =
// Wv^T in fp32 ([c][ci] = Wv[ci][c]).
template <typename T, bool kFold>
__global__ void __launch_bounds__(kBwdThreads)
outlook_bwd_dv(const float* __restrict__ dyag, const T* __restrict__ a,
               const T* __restrict__ x, const float* __restrict__ wvt,
               T* __restrict__ dx, float* __restrict__ part, Dims d) {
  constexpr int RT = 4;
  extern __shared__ float smem[];
  const int W = d.W, C = d.C, Cin = d.Cin, hd = d.hd(), h9 = d.h9();
  const int lc = C + 1, la = h9 + 1, li = Cin + 1;
  const int ext = (d.rows + 2) * W, S_max = d.rows * W;
  float* s_d = smem;              // [(rows+2)*W, lc] dyag, haloed
  float* s_a = s_d + ext * lc;    // [(rows+2)*W, la] a, haloed
  float* s_dv = s_a + ext * la;   // [rows*W, lc] dv (kFold)
  float* s_x = s_dv + S_max * lc; // [rows*W, li] x (kFold)
  float* p_dwv = kFold ? part + blockIdx.x * fold_partial_floats(Cin, C)
                       : nullptr;
  float* p_dbv = kFold ? p_dwv + Cin * C : nullptr;
  const int ntiles = d.tiles();

  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const Tile tl(t, d.H, W, d.rows);
    const int S = tl.nr * W;
    const int lo = tl.e_lo * W, hi = tl.e_hi * W;
    const long long base = tl.pix0 - W;
    for (int i = threadIdx.x; i < ext * C; i += blockDim.x) {
      const int p = i / C, c = i % C;
      s_d[p * lc + c] = (p >= lo && p < hi) ? dyag[(base + p) * C + c] : 0.f;
    }
    for (int i = threadIdx.x; i < ext * h9; i += blockDim.x) {
      const int p = i / h9, k = i % h9;
      s_a[p * la + k] = (p >= lo && p < hi) ? to_f32(a[(base + p) * h9 + k])
                                            : 0.f;
    }
    if constexpr (kFold) load_rows(x, tl.pix0, S, Cin, s_x, li);
    __syncthreads();
    T* dx_t = dx + tl.pix0 * (kFold ? Cin : C);
    for (int i = threadIdx.x; i < S * C; i += blockDim.x) {
      const int p = i / C, c = i % C, pi = p / W, pj = p % W;
      const int k0 = (c / hd) * kTaps;
      float acc = 0.f;
#pragma unroll
      for (int tap = 0; tap < kTaps; ++tap) {
        const int sj = pj - (tap % 3 - 1);
        if (sj < 0 || sj >= W) continue;
        // haloed row of the source pixel p - off_t: pi + 1 - dy
        const int sp = (pi + 2 - tap / 3) * W + sj;
        acc = __fadd_rn(acc, __fmul_rn(s_d[sp * lc + c],
                                       s_a[sp * la + k0 + tap]));
      }
      if constexpr (kFold) {
        s_dv[p * lc + c] = acc;
      } else {
        dx_t[i] = from_f32<T>(acc);
      }
    }
    if constexpr (kFold) {
      __syncthreads();
      for (int c = threadIdx.x; c < C; c += blockDim.x) {
        float s = 0.f;
        for (int p = 0; p < S; ++p) s += s_dv[p * lc + c];
        p_dbv[c] += s;  // from the unrounded dv
      }
      __syncthreads();
      for (int i = threadIdx.x; i < S * C; i += blockDim.x) {
        const int e = (i / C) * lc + i % C;
        s_dv[e] = round_to<T>(s_dv[e]);
      }
      __syncthreads();
      block_gemm<RT, float>(s_dv, lc, 1, S, C, wvt, Cin, 1, Cin,
                            [&](int n, int ci, float acc) {
                              dx_t[n * Cin + ci] = from_f32<T>(acc);
                            });
      block_gemm<RT, float>(s_x, 1, li, Cin, S, s_dv, lc, 1, C,
                            [&](int ci, int c, float acc) {
                              p_dwv[ci * C + c] += acc;
                            });
    }
    __syncthreads();  // before the next tile overwrites shared memory
  }
}

bool dims_ok(const Dims& d) {
  return d.B >= 0 && d.H >= 1 && d.W >= 1 && d.Cin >= 1 && d.C >= 1 &&
         d.heads >= 1 && d.C % d.heads == 0 && d.rows >= 1;
}

// Blocks of a backward pass that keeps one partial of `per` floats each.
int partial_blocks(int ntiles, long long per) {
  long long P = ntiles < kMaxBwdBlocks ? ntiles : kMaxBwdBlocks;
  if (P * per > kMaxWorkspaceFloats) P = kMaxWorkspaceFloats / per;
  return static_cast<int>(P < 1 ? 1 : P);
}

struct BwdPlan {
  int P1, P2;                // blocks of pass 1 and of pass 2
  long long dyag, wpt, part1, wvt, part2;  // workspace offsets (floats)
  long long total;
};

BwdPlan bwd_plan(const Dims& d, bool fold) {
  BwdPlan p;
  const int ntiles = d.tiles();
  p.P1 = partial_blocks(ntiles, proj_partial_floats(d.C));
  p.P2 = fold ? partial_blocks(ntiles, fold_partial_floats(d.Cin, d.C))
              : ntiles;
  p.dyag = 0;
  p.wpt = p.dyag + static_cast<long long>(d.B) * d.H * d.W * d.C;
  p.part1 = p.wpt + static_cast<long long>(d.C) * d.C;
  p.wvt = p.part1 + p.P1 * proj_partial_floats(d.C);
  p.part2 = p.wvt + (fold ? static_cast<long long>(d.C) * d.Cin : 0);
  p.total = p.part2 + (fold ? p.P2 * fold_partial_floats(d.Cin, d.C) : 0);
  return p;
}

template <typename T, bool kFold>
cudaError_t launch_fwd(const void* x, const void* a, const void* wv,
                       const void* bv, const void* wp, const void* bp,
                       void* out, const Dims& d, cudaStream_t stream) {
  const size_t smem = fwd_smem_floats(d, kFold) * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = set_smem(outlook_fwd<T, kFold>, smem);
  if (err != cudaSuccess) return err;
  outlook_fwd<T, kFold><<<d.tiles(), kFwdThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(a),
      static_cast<const T*>(wv), static_cast<const T*>(bv),
      static_cast<const T*>(wp), static_cast<const T*>(bp),
      static_cast<T*>(out), d);
  return cudaGetLastError();
}

struct BwdArgs {
  const void *x, *a, *wv, *bv, *wp, *g;
  void *dx, *da, *dwv, *dbv, *dwp, *dbp;
  float* ws;
};

template <typename T, bool kFold>
cudaError_t launch_bwd(const BwdArgs& r, const Dims& d, cudaStream_t stream) {
  const size_t smem1 = bwd_proj_smem_floats(d, kFold) * sizeof(float);
  const size_t smem2 = bwd_dv_smem_floats(d, kFold) * sizeof(float);
  if (smem1 > kMaxSmem || smem2 > kMaxSmem) return cudaErrorInvalidValue;
  const BwdPlan p = bwd_plan(d, kFold);
  float* ws = r.ws;
  const long long per1 = proj_partial_floats(d.C);
  const long long per2 = fold_partial_floats(d.Cin, d.C);
  cudaError_t err = transpose<T>(r.wp, d.C, d.C, ws + p.wpt, stream);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(ws + p.part1, 0, p.P1 * per1 * sizeof(float), stream);
  if (err != cudaSuccess) return err;
  if constexpr (kFold) {
    if ((err = transpose<T>(r.wv, d.Cin, d.C, ws + p.wvt, stream))) {
      return err;
    }
    err = cudaMemsetAsync(ws + p.part2, 0, p.P2 * per2 * sizeof(float),
                          stream);
    if (err != cudaSuccess) return err;
  }
  if ((err = set_smem(outlook_bwd_proj<T, kFold>, smem1))) return err;
  outlook_bwd_proj<T, kFold><<<p.P1, kBwdThreads, smem1, stream>>>(
      static_cast<const T*>(r.x), static_cast<const T*>(r.a),
      static_cast<const T*>(r.wv), static_cast<const T*>(r.bv),
      ws + p.wpt, static_cast<const T*>(r.g), ws + p.dyag,
      static_cast<T*>(r.da), ws + p.part1, d);
  if ((err = cudaGetLastError())) return err;
  if ((err = reduce<T>(ws + p.part1, p.P1, per1, d.C * d.C, r.dwp, stream))) {
    return err;
  }
  if ((err = reduce<T>(ws + p.part1 + static_cast<long long>(d.C) * d.C,
                       p.P1, per1, d.C, r.dbp, stream))) {
    return err;
  }
  if ((err = set_smem(outlook_bwd_dv<T, kFold>, smem2))) return err;
  outlook_bwd_dv<T, kFold><<<p.P2, kBwdThreads, smem2, stream>>>(
      ws + p.dyag, static_cast<const T*>(r.a), static_cast<const T*>(r.x),
      ws + p.wvt, static_cast<T*>(r.dx), ws + p.part2, d);
  if ((err = cudaGetLastError())) return err;
  if constexpr (kFold) {
    if ((err = reduce<T>(ws + p.part2, p.P2, per2, d.Cin * d.C, r.dwv,
                         stream))) {
      return err;
    }
    return reduce<T>(ws + p.part2 + static_cast<long long>(d.Cin) * d.C,
                     p.P2, per2, d.C, r.dbv, stream);
  }
  return cudaSuccess;
}

}  // namespace

// x [B, H, W, Cin] (v when fold == 0, then Cin == C), a [B, H, W, heads*9],
// wv [Cin, C], bv [C] (null when fold == 0), wp [C, C], bp [C], out [B, H,
// W, C]: contiguous, of type `dtype`. `rows`: image rows per block.
extern "C" int ogvt_outlook_agg(const void* x, const void* a, const void* wv,
                                const void* bv, const void* wp,
                                const void* bp, void* out, int B, int H,
                                int W, int Cin, int C, int heads, int rows,
                                int fold, int dtype, void* stream) {
  const Dims d{B, H, W, Cin, C, heads, rows};
  if (!dims_ok(d) || (!fold && Cin != C)) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype * 2 + (fold ? 1 : 0)) {
    case kFloat32 * 2:
      return launch_fwd<float, false>(x, a, wv, bv, wp, bp, out, d, s);
    case kFloat32 * 2 + 1:
      return launch_fwd<float, true>(x, a, wv, bv, wp, bp, out, d, s);
    case kBFloat16 * 2:
      return launch_fwd<__nv_bfloat16, false>(x, a, wv, bv, wp, bp, out, d,
                                              s);
    case kBFloat16 * 2 + 1:
      return launch_fwd<__nv_bfloat16, true>(x, a, wv, bv, wp, bp, out, d, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// Floats of fp32 workspace ogvt_outlook_agg_bwd needs for these shapes.
extern "C" long long ogvt_outlook_agg_bwd_workspace(int B, int H, int W,
                                                    int Cin, int C, int heads,
                                                    int rows, int fold) {
  const Dims d{B, H, W, Cin, C, heads, rows};
  if (!dims_ok(d) || B == 0) return 0;
  return bwd_plan(d, fold != 0).total;
}

// Inputs as ogvt_outlook_agg, g [B, H, W, C]; outputs dx (dv without the
// fold) like x, da like a, dwv / dbv (null without the fold), dwp, dbp, all
// of type `dtype`. ws: ogvt_outlook_agg_bwd_workspace(...) floats.
extern "C" int ogvt_outlook_agg_bwd(const void* x, const void* a,
                                    const void* wv, const void* bv,
                                    const void* wp, const void* g, void* dx,
                                    void* da, void* dwv, void* dbv, void* dwp,
                                    void* dbp, void* ws, int B, int H, int W,
                                    int Cin, int C, int heads, int rows,
                                    int fold, int dtype, void* stream) {
  const Dims d{B, H, W, Cin, C, heads, rows};
  if (!dims_ok(d) || B == 0 || (!fold && Cin != C)) {
    return cudaErrorInvalidValue;
  }
  const BwdArgs r{x, a, wv, bv, wp, g, dx, da, dwv, dbv, dwp, dbp,
                  static_cast<float*>(ws)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype * 2 + (fold ? 1 : 0)) {
    case kFloat32 * 2:
      return launch_bwd<float, false>(r, d, s);
    case kFloat32 * 2 + 1:
      return launch_bwd<float, true>(r, d, s);
    case kBFloat16 * 2:
      return launch_bwd<__nv_bfloat16, false>(r, d, s);
    case kBFloat16 * 2 + 1:
      return launch_bwd<__nv_bfloat16, true>(r, d, s);
    default:
      return cudaErrorInvalidValue;
  }
}
