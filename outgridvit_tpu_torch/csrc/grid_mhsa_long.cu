// Grid multi-head self-attention core for grids of 64 <= N <= 256 tokens
// in bf16 (mma.sync tensor-core tiles) and 64 <= N <= 4096 in fp32 (the
// parity path), head width hd a multiple of 8 up to 64, forward and
// recompute backward.
//
// Replaces the TPU kernel outgridvit_tpu/ops/grid_attention_pallas.py:
// grid_mhsa_pallas (#6) at N >= 64, where the JAX model runs it for the
// grids the fused attention branch (#5) cannot hold: `_fwd_kernel` /
// `_attn_tile` (long_fwd here) and `_bwd_kernel` (long_bwd), with their
// rounding points:
//   forward:  logits s = q.k^T summed in fp32, then scaled; m = max s;
//             a = exp(s - m) / sum exp(s - m), by IEEE division;
//             P = a cast to the compute type before P.V; out = P.v summed
//             in fp32 and cast once;
//   backward: a recomputed in fp32; dv = a^T.dO; dp = dO.v^T;
//             ds = a * (dp - sum_m dp*a); dq = scale * ds.k,
//             dk = scale * ds^T.q; each cast once.
// Grids of N <= 63 take csrc/grid_mhsa_packed_mma.cu (bf16) and
// csrc/grid_mhsa_packed.cu (fp32), which keep a head's [N, N]
// probabilities in registers or shared memory; this kernel never holds
// them: it streams the keys in tiles of 16 and recomputes q.k^T in exact
// passes (the row max, then the row sum, then the normalised products). An
// online rescaled softmax would change #6's rounding points, and a second
// q.k^T costs little next to the bytes. bf16 grids of N > 256, whose head
// a block cannot stage whole, take csrc/grid_mhsa_tiles.cu, the same
// passes over keys streamed into blocks of query rows; the bf16 tile
// helpers both use are csrc/grid_mhsa_long.cuh's.
//
// What bounds it on the H100: by the card's peaks, memory. Per grid it
// reads N*3C elements and writes N*C (forward) for about 4*N*N*C flops:
// N/2 flop/byte in bf16, 72 at N = 144, below the tensor cores' ~295 (the
// backward reads 4C and writes 3C a token for 10*N*N*C flops). Measured,
// instruction issue: the exact passes take two exp and one division a
// logit forward, five and four backward, and hold the kernel near a fifth
// of the bytes bound forward and a seventh backward at N = 144.
//
// What the design does about it (bf16): one block per (grid, head), one
// warp per m16 tile of query rows (ceil(N / 16) warps, up to 16). The block
// copies its head's slices of q, k and v (and dO) into shared memory as bf16
// by 16-byte cp.async, rows past N zero-filled, at a row stride of an odd
// number of 16-byte units (ldmatrix without bank conflicts). A warp keeps
// its rows' q (and dO) fragments in registers and walks the key tiles:
// q.k^T and dO.v^T are bf16 mmas into two n8 accumulators (an m16n8k8 step
// for the hd tail when hd % 16 == 8); only the last tile of N % 16 != 0
// masks keys >= N; a row's values lie in the 4 lanes of a quad; the IEEE
// division is grid_mhsa_packed_mma.cuh's divide() (a row's reciprocal and
// one fma correction), __fdiv_rn for a tile with an exponential below
// 2^-100. Forward: pass 1 the row max, pass 2 the row sum, pass 3 P =
// bf16(a) packed straight into the A fragment of one bf16 mma per key tile
// of P.v. Backward, two phases split by one barrier:
//   - query rows (a warp's m16 tile): the max, the sum, then
//     D = sum_m dp*a, then dq += ds.k; m, the sum, its reciprocal and D go
//     to shared memory;
//   - key rows (a warp's m16 tile of keys): the logits transposed,
//     k.q^T and v.dO^T, a from the stored statistics, dv += a^T.dO and
//     dk += ds^T.q, with hd > 32 taken in two walks (dv, then dk) to stay in
//     registers.
// The backward's fp32 a and ds enter the products as two bf16 terms,
// hi = bf16(x) and lo = bf16(x - hi). dv and dk sum over query rows inside
// the warp that owns the key tile, and dq over keys inside the warp that
// owns the query tile: no atomics, and two calls give bitwise-equal results.
// Results are cast once into staged tiles and leave by 16-byte stores.
//
// fp32 (the parity path): one block of 128 threads per (grid, head), two
// threads a row, each taking half of the head's columns and the sum of the
// two halves of a dot product by a shuffle; the same passes in fp32, keys
// and values read through the L1 cache. Nothing is staged but the
// backward's three statistics a query row, so any N whose 12 * N bytes fit
// the default 48 KB of shared memory runs it.
//
// The launch plan (warps a block, shared bytes) is
// ops/grid_attention.py:grid_mhsa_long_plan; the entry points refuse any
// other.
#include <stdint.h>

#include <initializer_list>

#include "grid_mhsa_long.cuh"

using namespace ogvt;
using namespace ogvt::longk;

namespace {

constexpr int kMinN = 64, kMaxN = 256;
constexpr int kMaxF32N = 4096;  // 12 * N shared bytes within 48 KB
constexpr int kMaxWarps = kMaxN / 16;  // a bf16 block: one warp a row tile
constexpr int kF32Threads = 128;       // an fp32 block: two threads a row

// Shared bytes of a bf16 block of `warps` warps: q, k and v tiles of 16 *
// warps rows; the backward adds dO, dq and four fp32 statistics a row (the
// max, the sum, its reciprocal, D).
__host__ __device__ constexpr int bf16_smem(int warps, int nt, bool bwd) {
  return (bwd ? 5 : 3) * 16 * warps * row_bytes(nt) +
         (bwd ? 4 * 16 * warps * 4 : 0);
}

// ---- bf16 --------------------------------------------------------------

// Blocks of 512 threads an SM holds by the kernels' register caps: 64
// registers a thread (two blocks of up to 16 warps, three of the 9 warps at
// N = 144) for the forward at hd <= 32 and the backward at hd <= 16, 128
// otherwise (at 64, ptxas spilled the backward at hd 24 and 32).
// ops/grid_attention.py:LONG_REGS mirrors it.
__host__ __device__ constexpr int sm_blocks(int nt, bool bwd) {
  return nt <= (bwd ? 2 : 4) ? 2 : 1;
}

// exp(s * scale - m) / l: the logit scaled after its sum, the max
// subtracted, divided by the row's sum (IEEE); no contraction into an fma.
// The fp32 kernels' form.
__device__ __forceinline__ float prob(float s, float scale, float m,
                                      float l) {
  return __fdiv_rn(expf(__fmul_rn(s, scale) - m), l);
}

// Passes 1 and 2 over the key tiles of tile k that cover the keys below n:
// the max m and the sum l of exp(s - m) of rows g (index 0) and g + 8
// (index 1) of the query rows whose fragments are qf.
template <int NT>
__device__ __forceinline__ void row_stats(const Frag<NT>& qf, unsigned k,
                                          int n, float scale, int lane,
                                          float (&m)[2], float (&l)[2]) {
  constexpr int kRow = row_bytes(NT);
  m[0] = m[1] = -INFINITY;
  for_tiles(n, [&](int c, auto mask) {
    float s[2][4];
    scores<NT>(s, qf, k + 16 * c * kRow, lane);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        if (live(mask, c, j, v, n, lane)) {
          m[v >> 1] = fmaxf(m[v >> 1], __fmul_rn(s[j][v], scale));
        }
      }
    }
  });
  m[0] = quad_max(m[0]);
  m[1] = quad_max(m[1]);
  l[0] = l[1] = 0.f;
  for_tiles(n, [&](int c, auto mask) {
    float s[2][4];
    scores<NT>(s, qf, k + 16 * c * kRow, lane);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        l[v >> 1] += expo(s[j][v], scale, m[v >> 1],
                          live(mask, c, j, v, n, lane));
      }
    }
  });
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
}

// qkv [G, N, 3C] -> out [G, N, C]; block = grid * heads + head.
template <int NT>
__global__ void __launch_bounds__(32 * kMaxWarps, sm_blocks(NT, false))
long_fwd(const bf16* __restrict__ qkv, bf16* __restrict__ out, int N,
         int heads, float scale) {
  extern __shared__ uint4 smem[];
  constexpr int kRow = row_bytes(NT);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rows = 16 * (blockDim.x >> 5);
  const int g = blockIdx.x / heads, h = blockIdx.x - g * heads;
  const int C = heads * 8 * NT;
  unsigned char* tq = reinterpret_cast<unsigned char*>(smem);
  const unsigned sq = smem_addr(tq), sk = sq + rows * kRow,
                 sv = sk + rows * kRow;
  const bf16* src = qkv + static_cast<size_t>(g) * N * 3 * C + h * 8 * NT;
  stage<NT>(sq, src, 3 * C, N, rows);
  stage<NT>(sk, src + C, 3 * C, N, rows);
  cp_async_commit();
  stage<NT>(sv, src + 2 * C, 3 * C, N, rows);
  cp_async_commit();
  cp_async_wait<1>();  // q and k
  __syncthreads();
  const int r0 = 16 * warp;
  Frag<NT> qf;
  load_frag<NT>(qf, sq + r0 * kRow, lane);
  float m[2], l[2];
  row_stats<NT>(qf, sk, N, scale, lane, m, l);
  const RowStats st(m, l);
  cp_async_wait<0>();  // v
  __syncthreads();
  float acc[NT][4];
  zero<NT>(acc);
  for_tiles(N, [&](int c, auto mask) {  // pass 3: P = bf16(a), acc += P.v
    float s[2][4];
    scores<NT>(s, qf, sk + 16 * c * kRow, lane);
    row_probs(s, scale, st, mask, c, N, lane);
    unsigned a[1][4];
    a[0][0] = packed::pack(s[0][0], s[0][1]);  // rows 0-7, keys 0-7
    a[0][1] = packed::pack(s[0][2], s[0][3]);  // rows 8-15, keys 0-7
    a[0][2] = packed::pack(s[1][0], s[1][1]);  // rows 0-7, keys 8-15
    a[0][3] = packed::pack(s[1][2], s[1][3]);  // rows 8-15, keys 8-15
    packed::mma_rows16<NT, 0, NT, 1>(acc, a, sv, 16 * c, lane);
  });
  // only this warp reads its q rows: out_r0 goes there
  put<NT>(tq, acc, 1.f, r0, lane);
  __syncwarp();
  unstage<NT>(out + static_cast<size_t>(g) * N * C + h * 8 * NT, C, tq, r0, N,
              lane);
}

// The key-row walk of the backward for the warp's key tile (fragments kf,
// vf): over the query tiles, a^T from k.q^T and the stored statistics of
// each query (st: the max, the sum, its reciprocal and D, `rows` floats
// apart); kDv: dv += a^T.dO; kDk: ds^T = a^T * (v.dO^T - D), dk += ds^T.q.
template <int NT, bool kDv, bool kDk>
__device__ __forceinline__ void key_walk(float (&dv)[NT][4],
                                         float (&dk)[NT][4],
                                         const Frag<NT>& kf,
                                         const Frag<NT>& vf, unsigned sq,
                                         unsigned sd, const float* st,
                                         int rows, int N, float scale,
                                         int lane) {
  constexpr int kRow = row_bytes(NT);
  const int t = lane & 3;
  for_tiles(N, [&](int c, auto mask) {
    float s[2][4], dp[2][4], m[2][4], l[2][4], r[2][4], d[2][4];
    scores<NT>(s, kf, sq + 16 * c * kRow, lane);
    if constexpr (kDk) scores<NT>(dp, vf, sd + 16 * c * kRow, lane);
#pragma unroll
    for (int j = 0; j < 2; ++j) {  // queries 16c + 8j + 2t, + 1
      const int q = 16 * c + 8 * j + 2 * t;
      const float2 qm = *reinterpret_cast<const float2*>(st + q);
      const float2 ql = *reinterpret_cast<const float2*>(st + rows + q);
      const float2 qr = *reinterpret_cast<const float2*>(st + 2 * rows + q);
      const float2 qd = *reinterpret_cast<const float2*>(st + 3 * rows + q);
#pragma unroll
      for (int v = 0; v < 4; ++v) {  // key rows g (v < 2), g + 8
        m[j][v] = v & 1 ? qm.y : qm.x;
        l[j][v] = v & 1 ? ql.y : ql.x;
        r[j][v] = v & 1 ? qr.y : qr.x;
        d[j][v] = v & 1 ? qd.y : qd.x;
        s[j][v] = expo(s[j][v], scale, m[j][v], live(mask, c, j, v, N, lane));
      }
    }
    normalise(s, l, r);  // a^T
    unsigned a[2][4];
    if constexpr (kDv) {
      to_a(s[0], s[1], a[0], a[1]);
      packed::mma_rows16<NT, 0, NT, 2>(dv, a, sd, 16 * c, lane);
    }
    if constexpr (kDk) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int v = 0; v < 4; ++v) dp[j][v] = s[j][v] * (dp[j][v] - d[j][v]);
      }
      to_a(dp[0], dp[1], a[0], a[1]);
      packed::mma_rows16<NT, 0, NT, 2>(dk, a, sq, 16 * c, lane);
    }
  });
}

// qkv [G, N, 3C], dout [G, N, C] -> dqkv [G, N, 3C].
template <int NT>
__global__ void __launch_bounds__(32 * kMaxWarps, sm_blocks(NT, true))
long_bwd(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
         bf16* __restrict__ dqkv, int N, int heads, float scale) {
  extern __shared__ uint4 smem[];
  constexpr int kRow = row_bytes(NT);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rows = 16 * (blockDim.x >> 5);
  const int g = blockIdx.x / heads, h = blockIdx.x - g * heads;
  const int C = heads * 8 * NT, gr = lane >> 2;
  unsigned char* tq = reinterpret_cast<unsigned char*>(smem);
  unsigned char* tk = tq + rows * kRow;
  unsigned char* tv = tk + rows * kRow;
  unsigned char* td = tv + rows * kRow;  // dO
  unsigned char* tg = td + rows * kRow;  // dq
  // per query row: the max, the sum, its reciprocal, D (rows apart)
  float* st = reinterpret_cast<float*>(tg + rows * kRow);
  const unsigned sq = smem_addr(tq), sk = smem_addr(tk), sv = smem_addr(tv),
                 sd = smem_addr(td);
  const size_t row0 = static_cast<size_t>(g) * N;
  const bf16* src = qkv + row0 * 3 * C + h * 8 * NT;
  stage<NT>(sq, src, 3 * C, N, rows);
  stage<NT>(sk, src + C, 3 * C, N, rows);
  cp_async_commit();
  stage<NT>(sv, src + 2 * C, 3 * C, N, rows);
  stage<NT>(sd, dout + row0 * C + h * 8 * NT, C, N, rows);
  cp_async_commit();
  cp_async_wait<1>();  // q and k
  __syncthreads();

  // phase 1, the warp's query rows: m, l, D and dq
  const int r0 = 16 * warp;
  Frag<NT> qf, df;
  load_frag<NT>(qf, sq + r0 * kRow, lane);
  float m[2], l[2];
  row_stats<NT>(qf, sk, N, scale, lane, m, l);
  const RowStats rs(m, l);
  cp_async_wait<0>();  // v and dO
  __syncthreads();
  load_frag<NT>(df, sd + r0 * kRow, lane);
  float d[2] = {0.f, 0.f};
  for_tiles(N, [&](int c, auto mask) {  // pass 3: D = sum_m dp*a
    float s[2][4], dp[2][4];
    scores<NT>(s, qf, sk + 16 * c * kRow, lane);
    scores<NT>(dp, df, sv + 16 * c * kRow, lane);
    row_probs(s, scale, rs, mask, c, N, lane);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int v = 0; v < 4; ++v) d[v >> 1] += dp[j][v] * s[j][v];
    }
  });
  d[0] = quad_sum(d[0]);
  d[1] = quad_sum(d[1]);
  float acc[NT][4];
  zero<NT>(acc);
  for_tiles(N, [&](int c, auto mask) {  // pass 4: dq += ds.k
    float s[2][4], dp[2][4];
    scores<NT>(s, qf, sk + 16 * c * kRow, lane);
    scores<NT>(dp, df, sv + 16 * c * kRow, lane);
    row_probs(s, scale, rs, mask, c, N, lane);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int v = 0; v < 4; ++v) s[j][v] *= dp[j][v] - d[v >> 1];
    }
    unsigned a[2][4];
    to_a(s[0], s[1], a[0], a[1]);
    packed::mma_rows16<NT, 0, NT, 2>(acc, a, sk, 16 * c, lane);
  });
  put<NT>(tg, acc, scale, r0, lane);
  if ((lane & 3) == 0) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = r0 + gr + 8 * hf;
      st[r] = m[hf];
      st[rows + r] = l[hf];
      st[2 * rows + r] = rs.r[0][2 * hf];
      st[3 * rows + r] = d[hf];
    }
  }
  __syncthreads();  // every warp's statistics; every warp is done with k, v
  bf16* dst = dqkv + row0 * 3 * C + h * 8 * NT;
  unstage<NT>(dst, 3 * C, tg, r0, N, lane);

  // phase 2, the warp's key rows: dv and dk
  Frag<NT> kf, vf;
  load_frag<NT>(kf, sk + r0 * kRow, lane);
  load_frag<NT>(vf, sv + r0 * kRow, lane);
  float dv[NT][4], dk[NT][4];
  zero<NT>(dv);
  zero<NT>(dk);
  if constexpr (NT <= 4) {
    key_walk<NT, true, true>(dv, dk, kf, vf, sq, sd, st, rows, N,
                             scale, lane);
  } else {  // two walks keep the accumulators within the register cap
    key_walk<NT, true, false>(dv, dk, kf, vf, sq, sd, st, rows,
                              N, scale, lane);
    __syncwarp();  // every lane has its v fragments: dv goes to v's rows
    put<NT>(tv, dv, 1.f, r0, lane);
    key_walk<NT, false, true>(dv, dk, kf, vf, sq, sd, st, rows,
                              N, scale, lane);
  }
  __syncwarp();  // only this warp reads its k and v rows
  if constexpr (NT <= 4) put<NT>(tv, dv, 1.f, r0, lane);
  put<NT>(tk, dk, scale, r0, lane);
  __syncwarp();
  unstage<NT>(dst + C, 3 * C, tk, r0, N, lane);
  unstage<NT>(dst + 2 * C, 3 * C, tv, r0, N, lane);
}

// ---- fp32 ----------------------------------------------------------------

// A thread's half of a head's row: NT float4 (hd = 8 * NT).
template <int NT>
__device__ __forceinline__ void load_half(float4 (&x)[NT], const float* p) {
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    x[i] = __ldg(reinterpret_cast<const float4*>(p) + i);
  }
}

// x.y over the whole row: this thread's half, plus its partner's.
template <int NT>
__device__ __forceinline__ float dot(const float4 (&x)[NT], const float* p) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const float4 y = __ldg(reinterpret_cast<const float4*>(p) + i);
    s = fmaf(x[i].x, y.x, s);
    s = fmaf(x[i].y, y.y, s);
    s = fmaf(x[i].z, y.z, s);
    s = fmaf(x[i].w, y.w, s);
  }
  return s + __shfl_xor_sync(0xffffffffu, s, 1);
}

template <int NT>
__device__ __forceinline__ void axpy(float4 (&acc)[NT], float a,
                                     const float* p) {
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const float4 y = __ldg(reinterpret_cast<const float4*>(p) + i);
    acc[i].x = fmaf(a, y.x, acc[i].x);
    acc[i].y = fmaf(a, y.y, acc[i].y);
    acc[i].z = fmaf(a, y.z, acc[i].z);
    acc[i].w = fmaf(a, y.w, acc[i].w);
  }
}

template <int NT>
__device__ __forceinline__ void store_half(float* p, const float4 (&x)[NT],
                                           float scale) {
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    reinterpret_cast<float4*>(p)[i] = make_float4(
        x[i].x * scale, x[i].y * scale, x[i].z * scale, x[i].w * scale);
  }
}

template <int NT>
__device__ __forceinline__ void zero_half(float4 (&x)[NT]) {
#pragma unroll
  for (int i = 0; i < NT; ++i) x[i] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// The max and the sum of exps of one query row q over the N keys at `k`
// (rows ld apart).
template <int NT>
__device__ __forceinline__ void row_stats_f32(const float4 (&q)[NT],
                                              const float* k, int ld, int N,
                                              float scale, float& m,
                                              float& l) {
  m = -INFINITY;
  for (int j = 0; j < N; ++j) {
    m = fmaxf(m, __fmul_rn(dot<NT>(q, k + static_cast<size_t>(j) * ld),
                           scale));
  }
  l = 0.f;
  for (int j = 0; j < N; ++j) {
    l += expf(__fmul_rn(dot<NT>(q, k + static_cast<size_t>(j) * ld), scale) -
              m);
  }
}

// qkv [G, N, 3C] -> out [G, N, C], fp32.
template <int NT>
__global__ void __launch_bounds__(kF32Threads)
long_fwd_f32(const float* __restrict__ qkv, float* __restrict__ out, int N,
             int heads, float scale) {
  const int g = blockIdx.x / heads, h = blockIdx.x - g * heads;
  const int C = heads * 8 * NT, ld = 3 * C;
  const int off = h * 8 * NT + (threadIdx.x & 1) * 4 * NT;
  const float* base = qkv + static_cast<size_t>(g) * N * ld + off;
  for (int r0 = 0; r0 < N; r0 += kF32Threads / 2) {
    const int r = r0 + threadIdx.x / 2, rr = r < N ? r : N - 1;
    float4 q[NT], acc[NT];
    load_half<NT>(q, base + static_cast<size_t>(rr) * ld);
    float m, l;
    row_stats_f32<NT>(q, base + C, ld, N, scale, m, l);
    zero_half<NT>(acc);
    for (int j = 0; j < N; ++j) {
      const float* kj = base + static_cast<size_t>(j) * ld;
      axpy<NT>(acc, prob(dot<NT>(q, kj + C), scale, m, l), kj + 2 * C);
    }
    if (r < N) {
      store_half<NT>(out + (static_cast<size_t>(g) * N + r) * C + off, acc,
                     1.f);
    }
  }
}

// qkv [G, N, 3C], dout [G, N, C] -> dqkv [G, N, 3C], fp32.
template <int NT>
__global__ void __launch_bounds__(kF32Threads)
long_bwd_f32(const float* __restrict__ qkv, const float* __restrict__ dout,
             float* __restrict__ dqkv, int N, int heads, float scale) {
  extern __shared__ uint4 smem[];
  float* st_m = reinterpret_cast<float*>(smem);
  float* st_l = st_m + N;
  float* st_d = st_l + N;
  const int g = blockIdx.x / heads, h = blockIdx.x - g * heads;
  const int C = heads * 8 * NT, ld = 3 * C;
  const int off = h * 8 * NT + (threadIdx.x & 1) * 4 * NT;
  const size_t row0 = static_cast<size_t>(g) * N;
  const float* base = qkv + row0 * ld + off;
  const float* gbase = dout + row0 * C + off;
  float* dst = dqkv + row0 * ld + off;
  // phase 1, query rows: m, l, D and dq
  for (int r0 = 0; r0 < N; r0 += kF32Threads / 2) {
    const int r = r0 + threadIdx.x / 2, rr = r < N ? r : N - 1;
    float4 q[NT], dO[NT], acc[NT];
    load_half<NT>(q, base + static_cast<size_t>(rr) * ld);
    load_half<NT>(dO, gbase + static_cast<size_t>(rr) * C);
    float m, l, d = 0.f;
    row_stats_f32<NT>(q, base + C, ld, N, scale, m, l);
    for (int j = 0; j < N; ++j) {
      const float* kj = base + static_cast<size_t>(j) * ld;
      const float a = prob(dot<NT>(q, kj + C), scale, m, l);
      d += dot<NT>(dO, kj + 2 * C) * a;
    }
    zero_half<NT>(acc);
    for (int j = 0; j < N; ++j) {
      const float* kj = base + static_cast<size_t>(j) * ld;
      const float a = prob(dot<NT>(q, kj + C), scale, m, l);
      axpy<NT>(acc, a * (dot<NT>(dO, kj + 2 * C) - d), kj + C);
    }
    if (r < N) {
      store_half<NT>(dst + static_cast<size_t>(r) * ld, acc, scale);
      if ((threadIdx.x & 1) == 0) {
        st_m[r] = m;
        st_l[r] = l;
        st_d[r] = d;
      }
    }
  }
  __syncthreads();
  // phase 2, key rows: dv and dk
  for (int j0 = 0; j0 < N; j0 += kF32Threads / 2) {
    const int j = j0 + threadIdx.x / 2, jj = j < N ? j : N - 1;
    float4 k[NT], v[NT], dk[NT], dv[NT];
    load_half<NT>(k, base + static_cast<size_t>(jj) * ld + C);
    load_half<NT>(v, base + static_cast<size_t>(jj) * ld + 2 * C);
    zero_half<NT>(dk);
    zero_half<NT>(dv);
    for (int n = 0; n < N; ++n) {
      const float* qn = base + static_cast<size_t>(n) * ld;
      const float* gn = gbase + static_cast<size_t>(n) * C;
      const float a = prob(dot<NT>(k, qn), scale, st_m[n], st_l[n]);
      const float ds = a * (dot<NT>(v, gn) - st_d[n]);
      axpy<NT>(dv, a, gn);
      axpy<NT>(dk, ds, qn);
    }
    if (j < N) {
      store_half<NT>(dst + static_cast<size_t>(j) * ld + C, dk, scale);
      store_half<NT>(dst + static_cast<size_t>(j) * ld + 2 * C, dv, 1.f);
    }
  }
}

// ---- launch ----------------------------------------------------------------

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The launch this file takes: hd = C / heads a multiple of 8 in [8, 64];
// bf16: 64 <= N <= 256, ceil(N / 16) warps of bf16_smem bytes; fp32: 64 <=
// N <= 4096, 4 warps and 3 * N floats (backward) or none; 16-byte aligned
// pointers. Returns false for anything else.
bool plan_ok(int G, int N, int C, int heads, int dtype, int warps, int smem,
             bool bwd, std::initializer_list<const void*> ptrs) {
  if (G < 0 || N < kMinN || N > (dtype == kFloat32 ? kMaxF32N : kMaxN) ||
      heads <= 0 || C % heads) {
    return false;
  }
  const int hd = C / heads;
  if (hd % 8 || hd < 8 || hd > 64) return false;
  if (dtype == kBFloat16) {
    if (warps != (N + 15) / 16 || smem != bf16_smem(warps, hd / 8, bwd)) {
      return false;
    }
  } else if (dtype == kFloat32) {
    if (warps != kF32Threads / 32 || smem != (bwd ? 12 * N : 0)) return false;
  } else {
    return false;
  }
  for (const void* p : ptrs) {
    if (!aligned16(p)) return false;
  }
  return true;
}

struct Launch {
  const void* qkv;
  const void* dout;  // the backward's
  void* out;         // out, or dqkv
  int units, N, heads, dtype;
  float scale;
  int warps, smem;
  cudaStream_t stream;
};

template <bool kBwd>
cudaError_t launch(int nt, const Launch& a) {
  return packed::with_const<1, 8>(nt, [&](auto n) {
    constexpr int NT = decltype(n)::value;
    const dim3 grid(a.units), block(32 * a.warps);
    cudaError_t err;
    if (a.dtype == kBFloat16) {
      const bf16* qkv = static_cast<const bf16*>(a.qkv);
      bf16* out = static_cast<bf16*>(a.out);
      if constexpr (kBwd) {
        err = set_smem(long_bwd<NT>, a.smem);
        if (err != cudaSuccess) return err;
        long_bwd<NT><<<grid, block, a.smem, a.stream>>>(
            qkv, static_cast<const bf16*>(a.dout), out, a.N, a.heads,
            a.scale);
      } else {
        err = set_smem(long_fwd<NT>, a.smem);
        if (err != cudaSuccess) return err;
        long_fwd<NT><<<grid, block, a.smem, a.stream>>>(qkv, out, a.N,
                                                         a.heads, a.scale);
      }
    } else {
      const float* qkv = static_cast<const float*>(a.qkv);
      float* out = static_cast<float*>(a.out);
      if constexpr (kBwd) {
        long_bwd_f32<NT><<<grid, block, a.smem, a.stream>>>(
            qkv, static_cast<const float*>(a.dout), out, a.N, a.heads,
            a.scale);
      } else {
        long_fwd_f32<NT><<<grid, block, a.smem, a.stream>>>(
            qkv, out, a.N, a.heads, a.scale);
      }
    }
    return cudaGetLastError();
  });
}

}  // namespace

// qkv [G, N, 3C] -> out [G, N, C], both contiguous, bf16 or fp32 (`dtype`);
// `warps` and `smem` (bytes a block) as grid_mhsa_long_plan gives them.
extern "C" int ogvt_grid_mhsa_long(const void* qkv, void* out, int G, int N,
                                   int C, int heads, float scale, int warps,
                                   int smem, int dtype, void* stream) {
  if (!plan_ok(G, N, C, heads, dtype, warps, smem, false, {qkv, out})) {
    return cudaErrorInvalidValue;
  }
  if (G == 0) return cudaSuccess;
  const Launch a{qkv, nullptr, out, G * heads, N, heads, dtype, scale, warps,
                 smem, static_cast<cudaStream_t>(stream)};
  return launch<false>(C / heads / 8, a);
}

// qkv [G, N, 3C], dout [G, N, C] -> dqkv [G, N, 3C], all contiguous, bf16
// or fp32; `warps` and `smem` as grid_mhsa_long_plan gives them.
extern "C" int ogvt_grid_mhsa_long_bwd(const void* qkv, const void* dout,
                                       void* dqkv, int G, int N, int C,
                                       int heads, float scale, int warps,
                                       int smem, int dtype, void* stream) {
  if (!plan_ok(G, N, C, heads, dtype, warps, smem, true,
               {qkv, dout, dqkv})) {
    return cudaErrorInvalidValue;
  }
  if (G == 0) return cudaSuccess;
  const Launch a{qkv, dout, dqkv, G * heads, N, heads, dtype, scale, warps,
                 smem, static_cast<cudaStream_t>(stream)};
  return launch<true>(C / heads / 8, a);
}
