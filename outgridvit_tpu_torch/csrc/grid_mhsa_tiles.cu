// Grid multi-head self-attention core for grids of 257 <= N <= 4096 tokens,
// head width hd a multiple of 8 up to 64, in bf16 on mma.sync tensor-core
// tiles, forward and recompute backward.
//
// Replaces the TPU kernel outgridvit_tpu/ops/grid_attention_pallas.py:
// grid_mhsa_pallas (#6) for grids of N > 256, where the JAX model runs it
// for every grid the fused attention branch (#5) cannot hold
// (outgridvit_tpu/models/blocks.py:283-290): the 7M model's stage 0 at 192
// px (N = 576) and 224 px (N = 784). `_fwd_kernel` / `_attn_tile` (tiles_fwd
// here) and `_bwd_kernel` (tiles_bwd_query, tiles_bwd_key) keep the
// rounding points of csrc/grid_mhsa_long.cu, which takes 64 <= N <= 256:
//   forward:  logits s = q.k^T summed in fp32, then scaled; m = max s;
//             a = exp(s - m) / sum exp(s - m), by IEEE division;
//             P = a cast to bf16 before P.V; out = P.v summed in fp32 and
//             cast once;
//   backward: a recomputed in fp32; dv = a^T.dO; dp = dO.v^T;
//             ds = a * (dp - sum_m dp*a); dq = scale * ds.k,
//             dk = scale * ds^T.q; each cast once.
// As there, the keys are walked in exact passes (the row max, then the row
// sum, then the normalised products) and never held as [N, N]
// probabilities; an online rescaled softmax would change #6's rounding
// points. The passes sum each row's terms in key order, as the long kernel
// does.
//
// What bounds it on the H100: by the card's peaks, bytes and tensor-core
// products about equally at N = 576 (a grid's head reads 3 * N * hd and
// writes N * hd bf16 values for 4 * N * N * hd flops forward, N / 2 flop a
// byte against the bf16 ridge of ~295; 10 * N * N * hd backward for 7 * N
// * hd values). In fact instruction issue and its latency: the exact
// passes take two exps and one division a logit forward, and the backward
// three exps and three divisions beside its products.
//
// What the design does about it: a head's k and v no longer fit one block
// beside its q (k and v alone take 200 KB at N = 784, hd 64), so its query
// rows are cut into blocks of up to 16 m16 tiles, one a warp
// (grid_mhsa_tiles_layout.h), and each block streams the keys and values in
// chunks of 64 rows through a ring of two shared buffers filled by 16-byte
// cp.async while the previous chunk is computed; a pass that needs only k
// streams only k. No statistic crosses blocks. The tile arithmetic
// (fragments, q.k^T on mma.sync, the masked last tile, the IEEE division,
// P cast into the A fragment of the P.v product) is csrc/grid_mhsa_long.cuh's,
// shared with the long kernel.
//
// Under grad the forward keeps each query row's max m, sum l and 1 / l
// (RowStats', __frcp_rn(l)) in an fp32 residual [G * heads, 3, covered
// rows], which the JAX kernel does not (its _fwd_vjp saves only qkv): the
// backward reads them instead of recomputing them in two more walks over
// the keys. They are row_stats' values over the same chunks in the same
// order, so the bits a recompute gives. A forward without grad writes
// nothing (its own instantiation). The
// backward is two kernels on one stream, no atomics, so two calls give
// bitwise-equal results:
//   - tiles_bwd_query, a block of query rows over the streamed keys and
//     values in two walks: D = sum_m dp*a, then dq += ds.k; it writes D of
//     each of its rows to an fp32 scratch [G * heads, covered] that the
//     wrapper allocates;
//   - tiles_bwd_key, a block of key rows over the streamed queries (q, dO
//     and the four statistics m, l, 1 / l and D): a^T from the statistics,
//     dv += a^T.dO and dk += ds^T.q, at hd > 32 in two walks (dv, then dk)
//     to stay in registers.
// Per logit at hd <= 32: three q.k^T and three dO.v^T products, three exps
// and three divisions. Both backward kernels take their blocks' own rows'
// fragments from shared memory at each tile instead of holding them, so
// that they fit 72 registers a thread (__maxnreg__, grid_mhsa_tiles_layout.h:
// reg_cap) and two blocks of up to 14 warps share an SM: 24 warps at N =
// 576, 26 at 784, against 12 and 13 at 128 registers. The backward's fp32 a
// and ds enter the products as two bf16 terms, hi = bf16(x) and lo =
// bf16(x - hi). Results are cast once into the block's own staged rows and
// leave by 16-byte stores.
//
// The launch plan (blocks a unit, warps a block, shared bytes) is
// ops/grid_attention.py:grid_mhsa_tiles_plan, asked of the layout header;
// the entry points refuse any other.
#include <stdint.h>

#include <initializer_list>
#include <utility>

#include "grid_mhsa_long.cuh"
#include "grid_mhsa_tiles_layout.h"

using namespace ogvt;
using namespace ogvt::longk;
namespace lay = ogvt::tiles;

namespace {

constexpr int kChunk = lay::kChunk, kStages = lay::kStages,
              kStats = lay::kStats, kSaved = lay::kSaved;

// A ring of kStages shared buffers, `bytes` apart from shared address
// `base`, through which the block streams `items` chunks; load(i, buf)
// issues the cp.async copies of item i into the buffer at buf.
template <typename Load>
struct Ring {
  unsigned base;
  int bytes, items;
  Load load;
  int i;

  __device__ __forceinline__ void issue(int j) {
    if (j < items) load(j, base + (j % kStages) * bytes);
    cp_async_commit();  // an empty group past the end keeps the count
  }

  // The buffer of the next item, once the whole block's copies of it (and
  // of every group committed before it) have landed; then the copy of the
  // item kStages - 1 ahead starts, into the buffer every thread has just
  // finished with.
  __device__ __forceinline__ unsigned next() {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    issue(i + kStages - 1);
    return base + (i++ % kStages) * bytes;
  }
};

// A ring whose first kStages - 1 items' copies are issued: after the
// block's own rows, whose group the first next() waits for too.
template <typename Load>
__device__ __forceinline__ Ring<Load> make_ring(unsigned base, int bytes,
                                                int items, Load load) {
  Ring<Load> r{base, bytes, items, load, 0};
  for (int j = 0; j < kStages - 1; ++j) r.issue(j);
  return r;
}

// Rows [r0, r0 + kChunk) of the [*, hd] slice at `src` (rows `ld`
// elements apart), those below n, into the tile at shared address `tile`,
// the partial last m16 tile zero-filled.
template <int NT>
__device__ __forceinline__ void stage_chunk(unsigned tile, const bf16* src,
                                            int ld, int r0, int n) {
  const int live = min(kChunk, n - r0);
  stage<NT>(tile, src + static_cast<size_t>(r0) * ld, ld, live,
            (live + 15) & ~15);
}

// f(u, c, mask) for the m16 tiles u of the chunk of rows [r0, r0 + kChunk)
// that cover rows below n, c = r0 / 16 + u the tile's index in the head:
// the full ones with mask false, then the partial last one with mask true.
template <typename F>
__device__ __forceinline__ void for_chunk_tiles(int r0, int n, F&& f) {
  for_tiles(min(kChunk, n - r0),
            [&](int u, auto mask) { f(u, (r0 >> 4) + u, mask); });
}

// The row max (pass 1) and the row sum of exp(s - m) (pass 2) of the
// warp's query rows g (index 0) and g + 8 (index 1), whose fragments qf
// are loaded at the first chunk, over the keys streaming through `keys`.
template <int NT, typename R>
__device__ __forceinline__ void row_stats(R& keys, Frag<NT>& qf,
                                          unsigned sq, int chunks, int N,
                                          float scale, int lane,
                                          float (&m)[2], float (&l)[2]) {
  constexpr int kRow = row_bytes(NT);
  m[0] = m[1] = -INFINITY;
  for (int c = 0; c < chunks; ++c) {
    const unsigned sk = keys.next();
    if (c == 0) load_frag<NT>(qf, sq, lane);
    for_chunk_tiles(c * kChunk, N, [&](int u, int ct, auto mask) {
      float s[2][4];
      scores<NT>(s, qf, sk + 16 * u * kRow, lane);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          if (live(mask, ct, j, v, N, lane)) {
            m[v >> 1] = fmaxf(m[v >> 1], __fmul_rn(s[j][v], scale));
          }
        }
      }
    });
  }
  m[0] = quad_max(m[0]);
  m[1] = quad_max(m[1]);
  l[0] = l[1] = 0.f;
  for (int c = 0; c < chunks; ++c) {
    const unsigned sk = keys.next();
    for_chunk_tiles(c * kChunk, N, [&](int u, int ct, auto mask) {
      float s[2][4];
      scores<NT>(s, qf, sk + 16 * u * kRow, lane);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          l[v >> 1] += expo(s[j][v], scale, m[v >> 1],
                            live(mask, ct, j, v, N, lane));
        }
      }
    });
  }
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
}

// The unit (grid * heads + head) and the first own row of this block.
struct Part {
  int unit, g, h, r0;
  __device__ __forceinline__ Part(int parts, int heads, int rows) {
    unit = blockIdx.x / parts;
    g = unit / heads;
    h = unit - g * heads;
    r0 = (blockIdx.x - unit * parts) * rows;
  }
};

// s = x.y^T for the warp's 16 rows staged at shared address x (their
// fragments loaded for this product only) and the 16 rows at y.
template <int NT>
__device__ __forceinline__ void scores_at(float (&s)[2][4], unsigned x,
                                          unsigned y, int lane) {
  Frag<NT> f;
  load_frag<NT>(f, x, lane);
  scores<NT>(s, f, y, lane);
}

// qkv [G, N, 3C] -> out [G, N, C]; `parts` blocks a (grid, head) unit, each
// 16 * warps query rows. kSave: each query row's max, sum and 1 / sum
// (RowStats') into saved [G * heads, kSaved, covered] for the backward.
template <int NT, bool kSave>
__global__ void __launch_bounds__(lay::kThreads, lay::fwd_blocks(NT))
tiles_fwd(const bf16* __restrict__ qkv, bf16* __restrict__ out,
          float* __restrict__ saved, int N, int heads, int parts,
          int covered, float scale) {
  extern __shared__ uint4 smem[];
  constexpr int kRow = row_bytes(NT), kTile = kChunk * kRow;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rows = 16 * (blockDim.x >> 5);
  const Part p(parts, heads, rows);
  const int C = heads * 8 * NT, ld = 3 * C;
  const bf16* src = qkv + static_cast<size_t>(p.g) * N * ld + p.h * 8 * NT;
  unsigned char* tq = reinterpret_cast<unsigned char*>(smem);
  const unsigned sq = smem_addr(tq);
  stage<NT>(sq, src + static_cast<size_t>(p.r0) * ld, ld, N - p.r0, rows);
  cp_async_commit();
  const int chunks = (N + kChunk - 1) / kChunk;
  // passes 1 and 2 stream k, pass 3 k and v
  auto keys = make_ring(sq + rows * kRow, lay::buffer_bytes(NT, lay::kFwd),
                        3 * chunks,
                        [&](int i, unsigned buf) {
    const int pass = i / chunks, r0 = (i - pass * chunks) * kChunk;
    stage_chunk<NT>(buf, src + C, ld, r0, N);
    if (pass == 2) stage_chunk<NT>(buf + kTile, src + 2 * C, ld, r0, N);
  });
  const int w0 = 16 * warp;
  Frag<NT> qf;
  float m[2], l[2];
  row_stats<NT>(keys, qf, sq + w0 * kRow, chunks, N, scale, lane, m, l);
  const RowStats st(m, l);
  if constexpr (kSave) {  // rows g and g + 8 of the warp's tile
    if ((lane & 3) == 0) {
      float* row = saved + static_cast<size_t>(p.unit) * kSaved * covered +
                   p.r0 + w0 + (lane >> 2);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        row[8 * hf] = m[hf];
        row[covered + 8 * hf] = l[hf];
        row[2 * covered + 8 * hf] = st.r[0][2 * hf];
      }
    }
  }
  float acc[NT][4];
  zero<NT>(acc);
  for (int c = 0; c < chunks; ++c) {  // pass 3: P = bf16(a), acc += P.v
    const unsigned sk = keys.next(), sv = sk + kTile;
    for_chunk_tiles(c * kChunk, N, [&](int u, int ct, auto mask) {
      float s[2][4];
      scores<NT>(s, qf, sk + 16 * u * kRow, lane);
      row_probs(s, scale, st, mask, ct, N, lane);
      unsigned a[1][4];
      a[0][0] = packed::pack(s[0][0], s[0][1]);  // rows 0-7, keys 0-7
      a[0][1] = packed::pack(s[0][2], s[0][3]);  // rows 8-15, keys 0-7
      a[0][2] = packed::pack(s[1][0], s[1][1]);  // rows 0-7, keys 8-15
      a[0][3] = packed::pack(s[1][2], s[1][3]);  // rows 8-15, keys 8-15
      packed::mma_rows16<NT, 0, NT, 1>(acc, a, sv, 16 * u, lane);
    });
  }
  // only this warp reads its q rows: out goes there
  put<NT>(tq, acc, 1.f, w0, lane);
  __syncwarp();
  unstage<NT>(out + (static_cast<size_t>(p.g) * N + p.r0) * C + p.h * 8 * NT,
              C, tq, w0, N - p.r0, lane);
}

// The probabilities a (in s) and dp = dO.v^T (in dp) of the warp's query
// rows (q staged at wq, dO at wd) against the 16 keys of tile ct at sk
// (k) and sv (v), with the rows' statistics rs.
template <int NT, typename Mask>
__device__ __forceinline__ void probs_dp(float (&s)[2][4], float (&dp)[2][4],
                                         unsigned wq, unsigned wd,
                                         unsigned sk, unsigned sv,
                                         float scale, const RowStats& rs,
                                         Mask mask, int ct, int N, int lane) {
  scores_at<NT>(s, wq, sk, lane);
  scores_at<NT>(dp, wd, sv, lane);
  row_probs(s, scale, rs, mask, ct, N, lane);
}

// qkv [G, N, 3C], dout [G, N, C] and the forward's statistics saved [G *
// heads, kSaved, covered] -> dq of dqkv [G, N, 3C], and D of the block's
// query rows into dsum [G * heads, covered]: two walks over the keys, D =
// sum_m dp*a, then dq += ds.k.
template <int NT>
__global__ void __maxnreg__(lay::reg_cap(NT, lay::kBwdQuery))
tiles_bwd_query(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                bf16* __restrict__ dqkv, const float* __restrict__ saved,
                float* __restrict__ dsum, int N, int heads, int parts,
                int covered, float scale) {
  extern __shared__ uint4 smem[];
  constexpr int kRow = row_bytes(NT), kTile = kChunk * kRow;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rows = 16 * (blockDim.x >> 5);
  const Part p(parts, heads, rows);
  const int C = heads * 8 * NT, ld = 3 * C, gr = lane >> 2;
  const size_t row0 = static_cast<size_t>(p.g) * N;
  const bf16* src = qkv + row0 * ld + p.h * 8 * NT;
  unsigned char* tq = reinterpret_cast<unsigned char*>(smem);
  const unsigned sq = smem_addr(tq), sd = sq + rows * kRow;
  stage<NT>(sq, src + static_cast<size_t>(p.r0) * ld, ld, N - p.r0, rows);
  stage<NT>(sd, dout + (row0 + p.r0) * C + p.h * 8 * NT, C, N - p.r0, rows);
  cp_async_commit();
  const int chunks = (N + kChunk - 1) / kChunk;
  // both walks stream k and v
  auto keys = make_ring(sd + rows * kRow,
                        lay::buffer_bytes(NT, lay::kBwdQuery), 2 * chunks,
                        [&](int i, unsigned buf) {
    const int r0 = (i % chunks) * kChunk;
    stage_chunk<NT>(buf, src + C, ld, r0, N);
    stage_chunk<NT>(buf + kTile, src + 2 * C, ld, r0, N);
  });
  const int w0 = 16 * warp;
  const unsigned wq = sq + w0 * kRow, wd = sd + w0 * kRow;
  const float* st = saved + static_cast<size_t>(p.unit) * kSaved * covered +
                    p.r0 + w0 + gr;  // rows g and g + 8 of the warp's tile
  const float m[2] = {st[0], st[8]}, l[2] = {st[covered], st[covered + 8]},
              r[2] = {st[2 * covered], st[2 * covered + 8]};
  const RowStats rs(m, l, r);
  float d[2] = {0.f, 0.f};
  for (int c = 0; c < chunks; ++c) {  // walk 1: D = sum_m dp*a
    const unsigned sk = keys.next(), sv = sk + kTile;
    for_chunk_tiles(c * kChunk, N, [&](int u, int ct, auto mask) {
      float s[2][4], dp[2][4];
      probs_dp<NT>(s, dp, wq, wd, sk + 16 * u * kRow, sv + 16 * u * kRow,
                   scale, rs, mask, ct, N, lane);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int v = 0; v < 4; ++v) d[v >> 1] += dp[j][v] * s[j][v];
      }
    });
  }
  d[0] = quad_sum(d[0]);
  d[1] = quad_sum(d[1]);
  float acc[NT][4];
  zero<NT>(acc);
  for (int c = 0; c < chunks; ++c) {  // walk 2: dq += ds.k
    const unsigned sk = keys.next(), sv = sk + kTile;
    for_chunk_tiles(c * kChunk, N, [&](int u, int ct, auto mask) {
      float s[2][4], dp[2][4];
      probs_dp<NT>(s, dp, wq, wd, sk + 16 * u * kRow, sv + 16 * u * kRow,
                   scale, rs, mask, ct, N, lane);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int v = 0; v < 4; ++v) s[j][v] *= dp[j][v] - d[v >> 1];
      }
      unsigned a[2][4];
      to_a(s[0], s[1], a[0], a[1]);
      packed::mma_rows16<NT, 0, NT, 2>(acc, a, sk, 16 * u, lane);
    });
  }
  __syncwarp();  // only this warp reads its q rows: dq goes there
  put<NT>(tq, acc, scale, w0, lane);
  __syncwarp();
  unstage<NT>(dqkv + (row0 + p.r0) * ld + p.h * 8 * NT, ld, tq, w0,
              N - p.r0, lane);
  if ((lane & 3) == 0) {
    float* dr = dsum + static_cast<size_t>(p.unit) * covered + p.r0 + w0 + gr;
    dr[0] = d[0];
    dr[8] = d[1];
  }
}

// The key rows' walk of one chunk of queries for the warp's key tile (k
// staged at wk; vscores(dp, y) computes dp = v.y^T for its v rows): over the
// chunk's query tiles, a^T from k.q^T and the staged statistics of each
// query (st: the max, the sum, its reciprocal and D of the chunk's rows,
// kChunk floats apart, each read where it is used); kDv: dv += a^T.dO;
// kDk: ds^T = a^T * (v.dO^T - D), dk += ds^T.q.
template <int NT, bool kDv, bool kDk, typename VScores>
__device__ __forceinline__ void key_chunk(float (&dv)[NT][4],
                                          float (&dk)[NT][4], unsigned wk,
                                          VScores&& vscores, unsigned sq,
                                          unsigned sd, const float* st,
                                          int r0, int N, float scale,
                                          int lane) {
  constexpr int kRow = row_bytes(NT);
  const int t = lane & 3;
  for_chunk_tiles(r0, N, [&](int u, int ct, auto mask) {
    // statistic k of queries 16u + 8j + 2t (x) and + 1 (y) of the chunk:
    // key rows g take x (v < 2 at column 2t), g + 8 the same; v & 1 picks
    const auto at = [&](int k, int j) {
      return *reinterpret_cast<const float2*>(st + k * kChunk + 16 * u +
                                              8 * j + 2 * t);
    };
    float s[2][4];
    scores_at<NT>(s, wk, sq + 16 * u * kRow, lane);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float2 qm = at(0, j);
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        s[j][v] = expo(s[j][v], scale, v & 1 ? qm.y : qm.x,
                       live(mask, ct, j, v, N, lane));
      }
    }
    {
      float l[2][4], r[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float2 ql = at(1, j), qr = at(2, j);
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          l[j][v] = v & 1 ? ql.y : ql.x;
          r[j][v] = v & 1 ? qr.y : qr.x;
        }
      }
      normalise(s, l, r);  // a^T
    }
    // dp before the dv product: at the 72-register cap ptxas then spills
    // nothing at hd <= 32 (with dp after it, 20 bytes at hd 24 and 32)
    unsigned a[2][4];
    [[maybe_unused]] float dp[2][4];
    if constexpr (kDk) vscores(dp, sd + 16 * u * kRow);
    if constexpr (kDv) {
      to_a(s[0], s[1], a[0], a[1]);
      packed::mma_rows16<NT, 0, NT, 2>(dv, a, sd, 16 * u, lane);
    }
    if constexpr (kDk) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float2 qd = at(3, j);
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          dp[j][v] = s[j][v] * (dp[j][v] - (v & 1 ? qd.y : qd.x));
        }
      }
      to_a(dp[0], dp[1], a[0], a[1]);
      packed::mma_rows16<NT, 0, NT, 2>(dk, a, sq, 16 * u, lane);
    }
  });
}

// qkv [G, N, 3C], dout [G, N, C], the forward's statistics saved [G *
// heads, kSaved, covered] and the query kernel's D, dsum [G * heads,
// covered] -> dk and dv of dqkv [G, N, 3C]; `parts` blocks a unit, each 16
// * warps key rows.
template <int NT>
__global__ void __maxnreg__(lay::reg_cap(NT, lay::kBwdKey))
tiles_bwd_key(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
              bf16* __restrict__ dqkv, const float* __restrict__ saved,
              const float* __restrict__ dsum, int N, int heads, int parts,
              int covered, float scale) {
  extern __shared__ uint4 smem[];
  constexpr int kRow = row_bytes(NT), kTile = kChunk * kRow;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rows = 16 * (blockDim.x >> 5);
  const Part p(parts, heads, rows);
  const int C = heads * 8 * NT, ld = 3 * C;
  const size_t row0 = static_cast<size_t>(p.g) * N;
  const bf16* src = qkv + row0 * ld + p.h * 8 * NT;
  const bf16* go = dout + row0 * C + p.h * 8 * NT;
  const float* sa = saved + static_cast<size_t>(p.unit) * kSaved * covered;
  const float* sd_ = dsum + static_cast<size_t>(p.unit) * covered;
  unsigned char* tk = reinterpret_cast<unsigned char*>(smem);
  unsigned char* tv = tk + rows * kRow;
  const unsigned sk = smem_addr(tk), sv = smem_addr(tv);
  stage<NT>(sk, src + C + static_cast<size_t>(p.r0) * ld, ld, N - p.r0, rows);
  stage<NT>(sv, src + 2 * C + static_cast<size_t>(p.r0) * ld, ld, N - p.r0,
            rows);
  cp_async_commit();
  const int chunks = (N + kChunk - 1) / kChunk;
  const unsigned ring = sv + rows * kRow;
  // each walk streams q, dO and the statistics of every query chunk
  auto queries = make_ring(ring, lay::buffer_bytes(NT, lay::kBwdKey),
                           lay::walks(NT) * chunks, [&](int i, unsigned buf) {
    const int r0 = (i % chunks) * kChunk;
    stage_chunk<NT>(buf, src, ld, r0, N);
    stage_chunk<NT>(buf + kTile, go, C, r0, N);
    // the statistics of the chunk's rows below N rounded up to a tile,
    // which the forward and the query kernel wrote (covered >= that): the
    // forward's kSaved, then D
    const int n4 = ((min(kChunk, N - r0) + 15) & ~15) / 4;
    for (int e = threadIdx.x; e < kStats * n4; e += blockDim.x) {
      const int k = e / n4, c4 = e - k * n4;
      const float* from = k < kSaved ? sa + static_cast<size_t>(k) * covered
                                     : sd_;
      cp_async16(buf + 2 * kTile + (k * kChunk + 4 * c4) * 4,
                 from + r0 + 4 * c4);
    }
  });
  // the generic pointer to the statistics of the buffer at shared `buf`
  const auto stats_at = [&](unsigned buf) {
    return reinterpret_cast<const float*>(tk + (buf - sk) + 2 * kTile);
  };
  const int w0 = 16 * warp;
  const unsigned wk = sk + w0 * kRow, wv = sv + w0 * kRow;
  const auto v_staged = [&](float (&dp)[2][4], unsigned y) {
    scores_at<NT>(dp, wv, y, lane);
  };
  float dv[NT][4], dk[NT][4];
  zero<NT>(dv);
  zero<NT>(dk);
  for (int c = 0; c < chunks; ++c) {
    const unsigned buf = queries.next();
    key_chunk<NT, true, lay::walks(NT) == 1>(
        dv, dk, wk, v_staged, buf, buf + kTile, stats_at(buf), c * kChunk,
        N, scale, lane);
  }
  if constexpr (lay::walks(NT) == 2) {  // dk in a walk of its own
    // dv goes to v's rows: their fragments stay in registers for the walk
    Frag<NT> vf;
    load_frag<NT>(vf, wv, lane);
    __syncwarp();
    put<NT>(tv, dv, 1.f, w0, lane);
    const auto v_held = [&](float (&dp)[2][4], unsigned y) {
      scores<NT>(dp, vf, y, lane);
    };
    for (int c = 0; c < chunks; ++c) {
      const unsigned buf = queries.next();
      key_chunk<NT, false, true>(dv, dk, wk, v_held, buf, buf + kTile,
                                 stats_at(buf), c * kChunk, N, scale, lane);
    }
  }
  __syncwarp();  // only this warp reads its k and v rows
  if constexpr (lay::walks(NT) == 1) put<NT>(tv, dv, 1.f, w0, lane);
  put<NT>(tk, dk, scale, w0, lane);
  __syncwarp();
  bf16* dst = dqkv + (row0 + p.r0) * ld + p.h * 8 * NT;
  unstage<NT>(dst + C, ld, tk, w0, N - p.r0, lane);
  unstage<NT>(dst + 2 * C, ld, tv, w0, N - p.r0, lane);
}

// ---- launch ----------------------------------------------------------------

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The launch the layout header gives: N and a head width the kernels take,
// `parts` blocks a unit of `warps` warps, each kernel's shared bytes, and
// 16-byte aligned pointers. Returns false for anything else.
bool plan_ok(int G, int N, int C, int heads, int parts, int warps,
             std::initializer_list<std::pair<lay::Kernel, int>> smem,
             std::initializer_list<const void*> ptrs) {
  if (G < 0 || !lay::takes(N, C, heads)) return false;
  if (parts != lay::parts(N) || warps != lay::warps(N)) return false;
  const int nt = C / heads / 8;
  for (const auto& [kernel, bytes] : smem) {
    if (bytes != lay::smem_bytes(N, nt, kernel)) return false;
  }
  for (const void* p : ptrs) {
    if (!aligned16(p)) return false;
  }
  return true;
}

struct Launch {
  const bf16* qkv;
  const bf16* dout;  // the backward's
  bf16* out;         // out, or dqkv
  float* saved;      // the forward's statistics (null: none kept)
  float* dsum;       // the backward's D
  int units, N, heads, parts, warps;
  float scale;
  int smem, smem_key;  // the forward's or the query kernel's; the key one's
  cudaStream_t stream;
};

template <bool kBwd>
cudaError_t launch(int nt, const Launch& a) {
  return packed::with_const<1, lay::kMaxNT>(nt, [&](auto n) {
    constexpr int NT = decltype(n)::value;
    const dim3 grid(a.units * a.parts), block(32 * a.warps);
    const int covered = lay::covered(a.N);
    cudaError_t err;
    if constexpr (kBwd) {
      err = set_smem(tiles_bwd_query<NT>, a.smem);
      if (err != cudaSuccess) return err;
      err = set_smem(tiles_bwd_key<NT>, a.smem_key);
      if (err != cudaSuccess) return err;
      tiles_bwd_query<NT><<<grid, block, a.smem, a.stream>>>(
          a.qkv, a.dout, a.out, a.saved, a.dsum, a.N, a.heads, a.parts,
          covered, a.scale);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
      tiles_bwd_key<NT><<<grid, block, a.smem_key, a.stream>>>(
          a.qkv, a.dout, a.out, a.saved, a.dsum, a.N, a.heads, a.parts,
          covered, a.scale);
    } else if (a.saved) {
      err = set_smem(tiles_fwd<NT, true>, a.smem);
      if (err != cudaSuccess) return err;
      tiles_fwd<NT, true><<<grid, block, a.smem, a.stream>>>(
          a.qkv, a.out, a.saved, a.N, a.heads, a.parts, covered, a.scale);
    } else {
      err = set_smem(tiles_fwd<NT, false>, a.smem);
      if (err != cudaSuccess) return err;
      tiles_fwd<NT, false><<<grid, block, a.smem, a.stream>>>(
          a.qkv, a.out, nullptr, a.N, a.heads, a.parts, covered, a.scale);
    }
    return cudaGetLastError();
  });
}

}  // namespace

// qkv [G, N, 3C] -> out [G, N, C], both contiguous bf16; `saved`, null or
// an fp32 [G * heads, 3, covered] (covered: the rows a unit's blocks cover)
// that the call overwrites with each query row's max, sum and 1 / sum for
// the backward; `parts` (blocks a unit), `warps` and `smem` (bytes a
// block) as grid_mhsa_tiles_plan gives them.
extern "C" int ogvt_grid_mhsa_tiles(const void* qkv, void* out, void* saved,
                                    int G, int N, int C, int heads,
                                    float scale, int parts, int warps,
                                    int smem, void* stream) {
  if (!plan_ok(G, N, C, heads, parts, warps, {{lay::kFwd, smem}},
               {qkv, out}) ||
      (saved && !aligned16(saved))) {
    return cudaErrorInvalidValue;
  }
  if (G == 0) return cudaSuccess;
  const Launch a{static_cast<const bf16*>(qkv), nullptr,
                 static_cast<bf16*>(out), static_cast<float*>(saved),
                 nullptr, G * heads, N, heads, parts, warps, scale, smem, 0,
                 static_cast<cudaStream_t>(stream)};
  return launch<false>(C / heads / 8, a);
}

// qkv [G, N, 3C], dout [G, N, C] -> dqkv [G, N, 3C], all contiguous bf16;
// `saved` the forward's statistics of the same qkv (fp32 [G * heads, 3,
// covered], ogvt_grid_mhsa_tiles'), `dsum` an fp32 scratch of G * heads *
// covered floats, which the call overwrites; `parts`, `warps` and the two
// kernels' shared bytes as grid_mhsa_tiles_plan gives them.
extern "C" int ogvt_grid_mhsa_tiles_bwd(const void* qkv, const void* dout,
                                        void* dqkv, const void* saved,
                                        void* dsum, int G, int N, int C,
                                        int heads, float scale, int parts,
                                        int warps, int smem_query,
                                        int smem_key, void* stream) {
  if (!plan_ok(G, N, C, heads, parts, warps,
               {{lay::kBwdQuery, smem_query}, {lay::kBwdKey, smem_key}},
               {qkv, dout, dqkv, saved, dsum})) {
    return cudaErrorInvalidValue;
  }
  if (G == 0) return cudaSuccess;
  const Launch a{static_cast<const bf16*>(qkv),
                 static_cast<const bf16*>(dout), static_cast<bf16*>(dqkv),
                 const_cast<float*>(static_cast<const float*>(saved)),
                 static_cast<float*>(dsum), G * heads, N, heads, parts,
                 warps, scale, smem_query, smem_key,
                 static_cast<cudaStream_t>(stream)};
  return launch<true>(C / heads / 8, a);
}
