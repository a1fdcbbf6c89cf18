// The shared-memory layouts, register caps and limits of the fused attention
// branch's bf16 tensor-core kernels (csrc/attn_branch_mma.cu: the forward;
// csrc/attn_branch_bwd_mma.cu: the backward's tokens kernel and weights
// kernel), in plain C++ (no CUDA), so that one copy serves the kernels,
// their entry points' plan checks and the layout queries of
// attn_branch_mma_layout.cpp, which the launch plans
// (ops/attn_branch.py:attn_branch_forward_plan, attn_branch_backward_plan)
// ask on any host.
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define OGVT_HD __host__ __device__
#else
#define OGVT_HD
#endif

namespace ogvt {
namespace attn_mma {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kN = 64;                 // tokens a grid: four m16 row tiles
constexpr int kMaxBlockSmem = 232448;  // 227 KB, the most one block may use
constexpr int kSmSmem = 233472;        // 228 KB, one SM's shared memory
constexpr int kBlockReserved = 1024;   // what the card reserves a block
// Blocks an SM holds at the kernels' register caps (__launch_bounds__).
// The backward's: one, so 255 registers a thread; shared memory holds one
// tokens block anyway. The forward's: two, so 128 registers a thread, and
// fwd_fits() requires that two blocks' shared memory fits an SM.
constexpr int kTokBlocks = 1;
constexpr int kWBlocks = 1;
constexpr int kFwdBlocks = 2;

constexpr int reg_cap(int blocks) {
  return 65536 / (kThreads * blocks) > 255 ? 255 : 65536 / (kThreads * blocks);
}

// Bytes between two staged rows of `cols` bf16: cols / 8 16-byte units made
// odd, so the 8 rows one ldmatrix reads fall in 8 distinct bank groups (as
// csrc/mma.cuh:row16).
OGVT_HD constexpr int row_bytes(int cols) { return 16 * ((cols / 8) | 1); }

// The shapes the kernels are instantiated at: grids of 64 tokens, C = 64
// with heads of 32 and C = 80 with heads of 40 (every shipped shape of the
// fused branch: Tiny-ImageNet's and cifar100_64's stage 0, the default
// Model A's).
OGVT_HD constexpr bool takes(int N, int C, int heads) {
  return N == kN && heads > 0 && C % heads == 0 &&
         ((C == 64 && C / heads == 32) || (C == 80 && C / heads == 40));
}

// The forward's shared memory for C channels (byte offsets): Wqkv [C, 3C]
// and Wp [C, C], resident; one x tile [64, C] (the next grid's is staged
// into it once this grid's qkv is formed, and lands while this grid's
// attention and projection run); the xn tile (then the attention output);
// qkv [64, 3C] (then y, at the xn tile's row stride, for 16-byte stores).
struct FwdGeom {
  int rowC, rowQ;  // bytes between staged rows: [., C], [., 3C]
  int wqkv, wp, x, xn, qkv, bytes;
};

OGVT_HD inline FwdGeom fwd_geom(int C) {
  FwdGeom g;
  g.rowC = row_bytes(C);
  g.rowQ = row_bytes(3 * C);
  g.wqkv = 0;
  g.wp = C * g.rowQ;
  g.x = g.wp + C * g.rowC;
  g.xn = g.x + kN * g.rowC;
  g.qkv = g.xn + kN * g.rowC;
  g.bytes = g.qkv + kN * g.rowQ;
  return g;
}

// The backward's tokens kernel's shared memory for C channels (byte
// offsets): Wqkv [C, 3C] and Wp [C, C], resident; two buffers each of x
// and dy [64, C] (the next grid's staged while this one computes; dy
// becomes dout, then dx); the xn tile (then the attention output); qkv
// [64, 3C] (then dqkv); per head slot (two heads at once) the fp32
// probabilities a and ds as two bf16 terms each, [64, 64]; then fp32: mu
// and rstd per row, the block's running sums (dbqkv, dbp, dln_scale,
// dln_bias), dbqkv's sums per row tile [4][3C], the LN backward's column
// sums [2][4][C] and row sums [2][64][2].
struct TokGeom {
  int rowC, rowQ, rowA;  // bytes between staged rows: [., C], [., 3C], [., 64]
  int wqkv, wp, x, dy, xn, qkv, ad, adt, mu, rstd, red, cq, cs, rs, bytes;
};

OGVT_HD inline TokGeom tok_geom(int C) {
  TokGeom g;
  g.rowC = row_bytes(C);
  g.rowQ = row_bytes(3 * C);
  g.rowA = row_bytes(kN);
  g.wqkv = 0;
  g.wp = C * g.rowQ;
  g.x = g.wp + C * g.rowC;
  g.dy = g.x + 2 * kN * g.rowC;
  g.xn = g.dy + 2 * kN * g.rowC;
  g.qkv = g.xn + kN * g.rowC;
  g.ad = g.qkv + kN * g.rowQ;
  g.adt = kN * g.rowA;  // one [64, 64] tile; a slot holds four
  g.mu = g.ad + 8 * g.adt;
  g.rstd = g.mu + 4 * kN;
  g.red = g.rstd + 4 * kN;
  g.cq = g.red + 4 * 6 * C;
  g.cs = g.cq + 4 * 4 * 3 * C;
  g.rs = g.cs + 4 * 8 * C;
  g.bytes = g.rs + 4 * 4 * kN;
  return g;
}

// The weights kernel's shared memory for C channels: two buffers (the next
// grid's staged while this one is summed), each a grid's x (then xn), dy,
// dqkv and attention output. Two fit at every shape takes() admits.
constexpr int kWBuffers = 2;

struct WGeom {
  int rowC, rowQ;
  int x, dy, dq, out, buf, bytes;
};

OGVT_HD inline WGeom w_geom(int C) {
  WGeom g;
  g.rowC = row_bytes(C);
  g.rowQ = row_bytes(3 * C);
  g.x = 0;
  g.dy = kN * g.rowC;
  g.dq = 2 * kN * g.rowC;
  g.out = g.dq + kN * g.rowQ;
  g.buf = g.out + kN * g.rowC;
  g.bytes = kWBuffers * g.buf;
  return g;
}

inline bool fwd_fits(int N, int C, int heads) {
  return takes(N, C, heads) &&
         kFwdBlocks * (fwd_geom(C).bytes + kBlockReserved) <= kSmSmem;
}

inline bool tok_fits(int N, int C, int heads) {
  return takes(N, C, heads) && tok_geom(C).bytes <= kMaxBlockSmem;
}

inline bool w_fits(int N, int C, int heads) {
  return takes(N, C, heads) && w_geom(C).bytes <= kMaxBlockSmem;
}

// Whether `n` blocks of `per` grids each cover G grids, none left empty.
inline bool covers(int G, int n, int per) {
  return n >= 1 && per >= 1 && static_cast<long long>(n - 1) * per < G &&
         static_cast<long long>(n) * per >= G;
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace attn_mma
}  // namespace ogvt
