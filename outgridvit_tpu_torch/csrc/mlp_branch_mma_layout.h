// The shared-memory layouts, register caps and limits of the fused MLP
// branch's bf16 tensor-core kernels: the forward of csrc/mlp_branch_mma.cu
// and the two backward kernels of csrc/mlp_branch_bwd_mma.cu, in plain C++
// (no CUDA), so that one copy serves the kernels, their entry points' plan
// checks and the layout queries of mlp_branch_mma_layout.cpp, which the
// launch plans (ops/mlp_branch.py:mlp_branch_forward_plan and
// mlp_branch_backward_plan) ask on any host.
#pragma once

#ifdef __CUDACC__
#define OGVT_HD __host__ __device__
#else
#define OGVT_HD
#endif

namespace ogvt {
namespace mlp_mma {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxBlockSmem = 232448;     // 227 KB, the most one block may use
constexpr int kDb2Floats = 2 * kThreads;  // the tokens kernel's db2 parts
constexpr int kMaxDxn = 128;              // dxn columns one warp holds

// Bytes between two staged rows of `cols` bf16: cols / 8 16-byte units made
// odd, so the 8 rows one ldmatrix reads fall in 8 distinct bank groups (as
// csrc/mma.cuh:row16).
OGVT_HD constexpr int row_bytes(int cols) { return 16 * ((cols / 8) | 1); }

// The register cap of a thread when an SM must hold `blocks` blocks
// (__launch_bounds__(kThreads, blocks)).
constexpr int reg_cap(int blocks) {
  return 65536 / (kThreads * blocks) > 255 ? 255 : 65536 / (kThreads * blocks);
}

// The tokens kernel's template: dxn n8 tiles a warp holds (8 up to 64
// columns, else 16), and the blocks an SM holds at its register cap (two
// for 8: a 64-column dxn tile fits 128 registers).
OGVT_HD constexpr int tok_ntx(int C, int S) { return C / S <= 64 ? 8 : 16; }
constexpr int tok_blocks(int ntx) { return ntx == 8 ? 2 : 1; }

// The weights kernel's template: m16 tiles of C a warp holds (2 or 4), and
// the blocks an SM holds at its register cap.
OGVT_HD constexpr int w_mtt(int mt) { return mt <= 2 ? 2 : 4; }
constexpr int w_blocks(int mtt) { return mtt == 2 ? 2 : 1; }

// The tokens kernel's shared memory for C channels, split S, NB weight
// buffers (byte offsets). After the chunk loop the weight buffers hold the
// column sums [2][R][C] and row sums [2][TM][S] of the LN backward.
struct TokGeom {
  int S, R, TM, HW, chunk, nct;  // nct: dxn n8 tiles a warp
  int rowC, rowK;                // bytes between staged rows
  int xn, dy, w, w2, wbuf, dh, mu, rstd, red, db2, cs, rs, bytes;
};

OGVT_HD inline TokGeom tok_geom(int C, int S, int NB) {
  TokGeom g;
  g.S = S;
  g.R = kWarps / S;
  g.TM = 16 * g.R;
  g.HW = S == 4 ? 16 : 32;
  g.chunk = S * g.HW;
  g.nct = C / S / 8;
  g.rowC = row_bytes(C);
  g.rowK = row_bytes(g.chunk);
  g.xn = 0;
  g.dy = g.TM * g.rowC;
  g.w = 2 * g.TM * g.rowC;
  g.w2 = C * g.rowK;  // w2's chunk after w1's, within a buffer
  g.wbuf = C * g.rowK + g.chunk * g.rowC;
  g.dh = g.w + NB * g.wbuf;
  g.mu = g.dh + (S > 1 ? g.TM * g.rowK : 0);
  g.rstd = g.mu + 4 * g.TM;
  g.red = g.rstd + 4 * g.TM;
  g.db2 = g.red + 16 * ((12 * C + 15) / 16);
  g.bytes = g.db2 + 4 * kDb2Floats;
  g.cs = g.w;
  g.rs = g.cs + 8 * g.R * C;
  return g;
}

// Whether the tokens kernel takes C channels at split S (C / S dxn columns
// a warp, a multiple of 16 up to kMaxDxn) with NB weight buffers, within
// one block's shared memory.
inline bool tok_fits(int C, int S, int NB) {
  if (C < 16 || (S != 1 && S != 2 && S != 4) || C % (16 * S) ||
      C / S > kMaxDxn || (NB != 1 && NB != 2)) {
    return false;
  }
  const TokGeom g = tok_geom(C, S, NB);
  return g.bytes <= kMaxBlockSmem && 8 * g.R * C + 8 * g.TM * S <= NB * g.wbuf;
}

// The weights kernel's shared memory for C channels, WC units a block, TM
// tokens a tile, NB buffers of x and dy.
struct WGeom {
  int WN, WM, MT, iw;  // warp grid (n groups of 32 units, m groups), m16
                       // tiles a warp, units of a recompute item
  int rowC, rowW, buf, a, dh, w1, w2, db, bytes;
};

OGVT_HD inline WGeom w_geom(int C, int WC, int TM, int NB) {
  WGeom g;
  g.WN = WC / 32;
  g.WM = kWarps / g.WN;
  g.MT = (C / 16 + g.WM - 1) / g.WM;
  g.iw = (TM / 16) * (WC / 32) >= kWarps ? 32 : 16;
  g.rowC = row_bytes(C);
  g.rowW = row_bytes(WC);
  g.buf = 2 * TM * g.rowC;  // xn then dy
  g.a = NB * g.buf;
  g.dh = g.a + TM * g.rowW;
  g.w1 = g.dh + TM * g.rowW;
  g.w2 = g.w1 + C * g.rowW;
  g.db = g.w2 + WC * g.rowC;
  g.bytes = g.db + 4 * (TM / 16) * WC;
  return g;
}

// Whether the weights kernel takes C channels with WC units a block (32 to
// 256), TM tokens a tile (16 to 128) and NB buffers: at most 4 m16 tiles a
// warp, within one block's shared memory.
inline bool w_fits(int C, int WC, int TM, int NB) {
  if (C < 16 || C % 16 || (WC != 32 && WC != 64 && WC != 128 && WC != 256) ||
      TM < 16 || TM > 128 || TM % 16 || (NB != 1 && NB != 2)) {
    return false;
  }
  const WGeom g = w_geom(C, WC, TM, NB);
  return g.MT <= 4 && g.bytes <= kMaxBlockSmem;
}

// The forward kernel's template: y n8 tiles a warp holds (8 up to 64
// columns, else 16), and the blocks an SM holds at its register cap: two
// for 8 (a 64-column y tile fits 128 registers; ptxas spilled at 16),
// except for an activation that divides (SiLU, whose correctly rounded
// division has a slow path that spilled at 128).
OGVT_HD constexpr int fwd_nty(int C, int S) { return C / S <= 64 ? 8 : 16; }
constexpr int fwd_blocks(int nty, bool divides) {
  return nty == 8 && !divides ? 2 : 1;
}

// The forward kernel's shared memory for C channels, H hidden units, split S
// and NB weight buffers (byte offsets): two x tiles (the next tile's x is
// staged while this one computes; y leaves through this one's), then either
// all of w1 [C, H] and w2 [H, C] (NB = 0, resident for every tile) or NB
// buffers of w1[:, chunk] and w2[chunk, :], then the a exchange tile
// [TM, chunk] where S warps share a row tile.
struct FwdGeom {
  int S, R, TM, HW, chunk, nct;  // nct: y n8 tiles a warp
  int rowC, rowK, rowH;          // bytes between staged rows
  int xbuf, w, w2, wbuf, ex, bytes;
};

OGVT_HD inline FwdGeom fwd_geom(int C, int H, int S, int NB) {
  FwdGeom g;
  g.S = S;
  g.R = kWarps / S;
  g.TM = 16 * g.R;
  g.HW = S <= 2 ? 32 : 16;
  g.chunk = S * g.HW;
  g.nct = C / S / 8;
  g.rowC = row_bytes(C);
  g.rowK = row_bytes(g.chunk);
  g.rowH = row_bytes(H);
  g.xbuf = g.TM * g.rowC;
  g.w = 2 * g.xbuf;
  if (NB == 0) {
    g.w2 = C * g.rowH;  // w2 after w1, within the weights
    g.wbuf = g.w2 + H * g.rowC;
  } else {
    g.w2 = C * g.rowK;  // w2's chunk after w1's, within a buffer
    g.wbuf = g.w2 + g.chunk * g.rowC;
  }
  g.ex = g.w + (NB == 0 ? 1 : NB) * g.wbuf;
  g.bytes = g.ex + (S > 1 ? g.TM * g.rowK : 0);
  return g;
}

// Whether the forward kernel takes C channels and H hidden units (multiples
// of 16) at split S (C / S y columns a warp, a multiple of 16 up to kMaxY)
// with NB weight buffers (0: the weights resident), within one block's
// shared memory.
constexpr int kMaxY = 128;  // y columns one warp holds

inline bool fwd_fits(int C, int H, int S, int NB) {
  if (C < 16 || H < 16 || H % 16 ||
      (S != 1 && S != 2 && S != 4 && S != 8) || C % (16 * S) ||
      C / S > kMaxY || NB < 0 || NB > 2) {
    return false;
  }
  return fwd_geom(C, H, S, NB).bytes <= kMaxBlockSmem;
}

}  // namespace mlp_mma
}  // namespace ogvt
