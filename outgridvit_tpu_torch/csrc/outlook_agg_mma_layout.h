// The shared-memory layouts, register cap and limits of the fused outlook
// projection's bf16 tensor-core kernels, the backward
// (csrc/outlook_agg_bwd_mma.cu: geom, fits) and the forward
// (csrc/outlook_agg_fwd_mma.cu: fwd_geom, fwd_fits), in plain C++ (no
// CUDA), so that one copy serves each kernel, its entry point's plan check
// and the layout queries of outlook_agg_mma_layout.cpp, which the launch
// plans (ops/outlook_agg.py:outlook_agg_backward_plan,
// outlook_agg_forward_plan) ask on any host.
#pragma once

#ifdef __CUDACC__
#define OGVT_HD __host__ __device__
#else
#define OGVT_HD
#endif

namespace ogvt {
namespace outlook_mma {

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxBlockSmem = 232448;  // 227 KB, the most one block may use
constexpr int kTaps = 9;
constexpr int kSegs = 8;      // pixel segments of the dbp / dbv column sums
constexpr int kMaxSlots = 4;  // m16n16 tiles of dWp (and dWv) a warp holds
constexpr int kRegCap = 65536 / kThreads;  // one block an SM

// Bytes between two staged rows of `cols` bf16: cols / 8 16-byte units made
// odd, so the 8 rows one ldmatrix reads fall in 8 distinct bank groups (as
// csrc/mma.cuh:row16).
OGVT_HD constexpr int row_bytes(int cols) { return 16 * ((cols / 8) | 1); }
OGVT_HD constexpr int up16(int n) { return (n + 15) / 16 * 16; }

// The parts a head's channels are cut into for the taps, one thread a
// (tile pixel, head of the chunk, part): the fewest (a power of 2 up to 8,
// each part a multiple of 4 channels) that give every thread of the block
// an item, for SP tile pixels and hc heads a chunk.
OGVT_HD inline int parts(int hd, int SP, int hc) {
  int np = 1;
  while (np < 8 && (hd / np) % 8 == 0 && SP * hc * np < kThreads) np *= 2;
  return np;
}

// The m16n16 tiles of dWp [C, C], and of dWv [Cin, C] with the fold, that
// each warp holds in registers across the block's tiles (the kernel's
// template): the larger count over kWarps warps, rounded up.
OGVT_HD inline int slots(int Cin, int C, int fold) {
  const int n = C / 16, wp = n * n, wv = fold ? (Cin / 16) * n : 0;
  return ((wp > wv ? wp : wv) + kWarps - 1) / kWarps;
}

// Floats of one block's fp32 partial: dWp [C, C], dbp [C], then with the
// fold dWv [Cin, C] and dbv [C].
OGVT_HD inline long long partial_floats(int Cin, int C, int fold) {
  return static_cast<long long>(C) * C + C +
         (fold ? static_cast<long long>(Cin) * C + C : 0);
}

// One block's shared memory for a tile of R image rows W pixels wide, Cin
// input and C output channels, `heads` heads and channel chunks of CH
// (byte offsets). A tile's pixels are its R rows; its staged ("ext") pixels
// add one halo row above and one below, ext = (R + 2) W, ext pixel e being
// tile pixel e - W. NE staged rows: ext, or the tile's rows past W rounded
// up to 16 if more, rounded up to 16 (the m16 tiles of every product).
//   xs [NE, Cin] bf16   x of the ext pixels (v without the fold)
//   gs [NE, C] bf16     g of the ext pixels
//   wp [C, C], wv [Cin, C] bf16, resident for every tile
//   ys [SP, max(C, Cin)] bf16  y = round(aggregate), then dx (the fold)
//   dvs [SP, C] bf16    round(dv)
//   as [ext, h9] bf16   the tap weights of the ext pixels
//   vf, df [R + 2, W + 2, CH + 2] fp32  v and dyag of one chunk's channels
//                       at every ext pixel, a zero pixel either side of
//                       each row (the fold's unrounded dv after the taps)
//   da [SP, h9] bf16    da of the tile, copied out whole
//   red [kSegs, C], dbp [C], dbv [C] fp32  the column sums
// The taps take one thread a (tile pixel, head of the chunk, part of the
// head's channels), the np parts of a head in neighbouring lanes: np is
// the fewest (a power of 2 up to 8, each part a multiple of 4 channels)
// that give every thread of the block an item, which reads four channels
// at a time (two 8-byte loads). fp32 pixels are CH + 2 floats apart, so
// where CH is a multiple of 32 the 16 lanes of a half-warp (8 or fewer
// pixels, a part each) read distinct bank pairs (at CH = 48 or 80 a few
// of them two-way); the tap weights' rows are unpadded, as they lie in
// memory.
struct Geom {
  int hd, h9, ext, S, SP, NE, NP, ldv, rowX, rowC, rowO, slots, np;
  int xs, gs, wp, wv, ys, dvs, as, vf, df, da, red, dbp, dbv, bytes;
};

OGVT_HD inline Geom geom(int W, int Cin, int C, int heads, int R, int CH,
                         int fold) {
  Geom g;
  g.hd = C / heads;
  g.h9 = kTaps * heads;
  g.ext = (R + 2) * W;
  g.S = R * W;
  g.SP = up16(g.S);
  g.NE = up16(W + g.SP > g.ext ? W + g.SP : g.ext);
  g.NP = (R + 2) * (W + 2);
  g.ldv = CH + 2;
  g.rowX = row_bytes(Cin);
  g.rowC = row_bytes(C);
  g.rowO = row_bytes(Cin > C ? Cin : C);
  g.slots = slots(Cin, C, fold);
  g.np = parts(g.hd, g.SP, CH / g.hd);
  int o = 0;
  g.xs = o;
  o += g.NE * g.rowX;
  g.gs = o;
  o += g.NE * g.rowC;
  g.wp = o;
  o += C * g.rowC;
  g.wv = o;
  o += fold ? Cin * g.rowC : 0;
  g.ys = o;
  o += g.SP * g.rowO;
  g.dvs = o;
  o += g.SP * g.rowC;
  g.as = o;
  o += up16(2 * g.ext * g.h9);
  g.vf = o;
  o += up16(4 * g.NP * g.ldv);
  g.df = o;
  o += up16(4 * g.NP * g.ldv);
  g.da = o;
  o += up16(2 * g.SP * g.h9);
  g.red = o;
  o += up16(4 * kSegs * C);
  g.dbp = o;
  o += up16(4 * C);
  g.dbv = o;
  o += up16(4 * C);
  g.bytes = o;
  return g;
}

// Whether both kernels take these shapes at R rows a tile and chunks of CH
// channels, before their shared memory: C and Cin multiples of 16 (Cin ==
// C without the fold), a head width that is a multiple of 4, CH a multiple
// of 16 and of the head width dividing C. The sizes are capped so that no
// byte offset overflows an int, and the quotients the kernels take by a
// multiply (pixels of the haloed tile by W, tap items by SP) stay below
// 2^16.
inline bool shapes_ok(int W, int Cin, int C, int heads, int R, int CH,
                      int fold) {
  if (W < 1 || W > 4096 || R < 1 || R > 4096 || heads < 1 || C < 16 ||
      C > 1024 || C % 16 || Cin < 16 || Cin > 1024 || Cin % 16 ||
      (fold != 0 && fold != 1) || (!fold && Cin != C) || C % heads) {
    return false;
  }
  const int hd = C / heads;
  if (hd % 4 || CH < 16 || CH % 16 || C % CH || CH % hd) return false;
  return static_cast<long long>(R + 2) * W <= 8192 &&
         static_cast<long long>(up16(R * W)) * heads <= 8192;
}

// Whether the backward takes these shapes: shapes_ok, at most kMaxSlots dW
// tiles a warp, within one block's shared memory.
inline bool fits(int W, int Cin, int C, int heads, int R, int CH, int fold) {
  if (!shapes_ok(W, Cin, C, heads, R, CH, fold)) return false;
  const Geom g = geom(W, Cin, C, heads, R, CH, fold);
  return g.slots <= kMaxSlots && g.bytes <= kMaxBlockSmem;
}

// The forward's shared memory for the same tiles (byte offsets): the
// backward's staging, weights, y tile, tap weights and fp32 v rows, with no
// g, dyag, dv, da or column sums, and no dW tiles in registers.
//   xs [NE, Cin] bf16   x of the ext pixels (v without the fold); NE: ext
//                       rounded up to 16 (the m16 tiles of x.Wv)
//   wp [C, C], wv [Cin, C] bf16, resident for every tile
//   ys [SP, C] bf16     y = round(aggregate), the A operand of y.Wp
//   as [S, h9] bf16     the tap weights of the tile's own pixels
//   vf [R + 2, W + 2, CH + 2] fp32  v of one chunk's channels at every ext
//                       pixel, a zero pixel either side of each row (as the
//                       backward's); once the taps have read it, out's
//                       rows os [SP, C] bf16 in its place (os == vf), so
//                       the zero pixels are restored every tile
// The taps take the backward's items (parts); the rows are the backward's
// (row_bytes), so its staging and products serve both.
struct FwdGeom {
  int hd, h9, ext, S, SP, NE, NP, ldv, rowX, rowC, np;
  int xs, wp, wv, ys, as, vf, os, bytes;
};

OGVT_HD inline FwdGeom fwd_geom(int W, int Cin, int C, int heads, int R,
                                int CH, int fold) {
  FwdGeom g;
  g.hd = C / heads;
  g.h9 = kTaps * heads;
  g.ext = (R + 2) * W;
  g.S = R * W;
  g.SP = up16(g.S);
  g.NE = up16(g.ext);
  g.NP = (R + 2) * (W + 2);
  g.ldv = CH + 2;
  g.rowX = row_bytes(Cin);
  g.rowC = row_bytes(C);
  g.np = parts(g.hd, g.SP, CH / g.hd);
  int o = 0;
  g.xs = o;
  o += g.NE * g.rowX;
  g.wp = o;
  o += C * g.rowC;
  g.wv = o;
  o += fold ? Cin * g.rowC : 0;
  g.ys = o;
  o += g.SP * g.rowC;
  g.as = o;
  o += up16(2 * g.S * g.h9);
  g.vf = g.os = o;
  const int v = up16(4 * g.NP * g.ldv), os = g.SP * g.rowC;
  o += v > os ? v : os;
  g.bytes = o;
  return g;
}

// Whether the forward takes these shapes: shapes_ok, within one block's
// shared memory (Wp, and Wv with the fold, resident: at C = 256 with the
// fold they alone take 270 KB).
inline bool fwd_fits(int W, int Cin, int C, int heads, int R, int CH,
                     int fold) {
  return shapes_ok(W, Cin, C, heads, R, CH, fold) &&
         fwd_geom(W, Cin, C, heads, R, CH, fold).bytes <= kMaxBlockSmem;
}

}  // namespace outlook_mma
}  // namespace ogvt
