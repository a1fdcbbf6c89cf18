// The shared-memory layout, register cap and limits of the fused outlook
// softmax's bf16 row kernel (csrc/outlook_softmax_rows.cu: TPU kernel #9
// at K = 3), in plain C++ (no CUDA), so that one copy serves the kernel,
// its entry point's plan check and the layout query of
// outlook_softmax_layout.cpp, which the launch plan
// (ops/outlook_softmax.py:outlook_softmax_plan) asks on any host.
#pragma once

#ifdef __CUDACC__
#define OGVT_OS_HD __host__ __device__
#else
#define OGVT_OS_HD
#endif

namespace ogvt {
namespace osm_rows {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 2;  // __launch_bounds__: two blocks an SM
constexpr int kRegCap = 65536 / (kThreads * kMinBlocks);
constexpr int kMaxBlockSmem = 232448;  // 227 KB, the most one block may use
constexpr int kTaps = 9;               // K = 3
constexpr int kChunk = 8;              // channels a 16-byte chunk of bf16

OGVT_OS_HD constexpr int up16(int n) { return (n + 15) / 16 * 16; }

// One block's shared memory for tiles of R whole image rows W pixels wide,
// C channels, `heads` heads, runs of P adjacent pixels a thread (byte
// offsets). A staged row is WP = runs * P + 2 pixels of C bf16: a zero
// pixel, the image row's W pixels, then zero pixels to the end of the last
// run and one past it, so that every tap of every run reads inside its row
// and a tap outside the image reads 0. A tile stages R + 2 such rows (a
// halo row above and below, zero-filled outside the image) and the logits
// of its R rows, in two buffers (the next tile's copy lands under the
// current tile's taps); the probabilities of its pixels are fp32, P pixels
// of slack past the tile so that a ragged run's discarded outputs read
// inside the buffer.
//   v[2]   [R + 2, WP, C] bf16
//   l[2]   [R * W, heads * 9] bf16
//   pr     [R * W + P, heads * 9] fp32
struct Geom {
  int h9, runs, WP, units, vbuf, lbuf, v0, v1, l0, l1, pr, bytes;
};

OGVT_OS_HD inline Geom geom(int W, int C, int heads, int R, int P) {
  Geom g;
  g.h9 = kTaps * heads;
  g.runs = (W + P - 1) / P;
  g.WP = g.runs * P + 2;
  g.units = W * (C / kChunk);  // 16-byte chunks of one image row
  g.vbuf = (R + 2) * g.WP * C * 2;
  g.lbuf = up16(R * W * g.h9 * 2);
  int o = 0;
  g.v0 = o;
  o += g.vbuf;
  g.v1 = o;
  o += g.vbuf;
  g.l0 = o;
  o += g.lbuf;
  g.l1 = o;
  o += g.lbuf;
  g.pr = o;
  o += up16((R * W + P) * g.h9 * 4);
  g.bytes = o;
  return g;
}

// Whether the kernel takes these shapes before its shared memory: a head
// width that is a multiple of 8 (a 16-byte chunk never straddles a head),
// runs of 2 or 4 pixels; sizes capped so that no byte offset or item count
// overflows an int.
inline bool shapes_ok(int W, int C, int heads, int R, int P) {
  if (W < 1 || W > 4096 || R < 1 || R > 4096 || heads < 1 || C < kChunk ||
      C > 4096 || C % heads || (C / heads) % kChunk ||
      (P != 2 && P != 4)) {
    return false;
  }
  return static_cast<long long>(R + 2) * (W + P + 2) * C * 2 <= (1 << 30);
}

// Whether the kernel takes these shapes at tiles of R rows and runs of P
// pixels: shapes_ok, within one block's shared memory.
inline bool fits(int W, int C, int heads, int R, int P) {
  return shapes_ok(W, C, heads, R, P) &&
         geom(W, C, heads, R, P).bytes <= kMaxBlockSmem;
}

}  // namespace osm_rows
}  // namespace ogvt
