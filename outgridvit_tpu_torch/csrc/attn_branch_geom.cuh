// Where the fused attention branch's kernels find a grid's tokens: on the
// tokens x [G, N, C] (TPU kernel #5) or on the raw NHWC map (#12), whose
// dilated grid partition the kernels fold into their loads and stores.
// Shared by csrc/attn_branch.cu (the FMA kernels) and
// csrc/attn_branch_bwd_mma.cu (the bf16 tensor-core backward), so that both
// walk one window's tokens in the same order in either layout.
#pragma once

#include <stddef.h>

namespace ogvt {

// Where token n of window w starts: tokens [G, N, C] when g == 0, else the
// pixel of an NHWC map [B, Hg*g, Wg*g, C] that window w's token n is. Token
// n = i*Wg + j of window w = (b*g + gy)*g + gx sits at pixel (b, i*g + gy,
// j*g + gx); the windows are numbered in the partition's order (ops/grid.py).
struct Geom {
  int g, Hg, Wg;

  __device__ size_t token(int w, int n, int N, int C) const {
    if (g == 0) return (static_cast<size_t>(w) * N + n) * C;
    const int b = w / (g * g), gy = (w / g) % g, gx = w % g;
    const int row = (n / Wg) * g + gy, col = (n % Wg) * g + gx;
    return ((static_cast<size_t>(b) * Hg * g + row) * Wg * g + col) * C;
  }
};

// The windows of an NHWC map [B, H, W, C] with grid size g, or false.
inline bool nhwc_geom(int B, int H, int W, int g, Geom* geo, int* G, int* N) {
  if (B < 0 || g < 1 || H < g || W < g || H % g || W % g) return false;
  *geo = Geom{g, H / g, W / g};
  *G = B * g * g;
  *N = geo->Hg * geo->Wg;
  return true;
}

}  // namespace ogvt
