// The layout, register caps and limits of the grid MHSA core's bf16
// tensor-core kernel (csrc/grid_mhsa_th.cu: TPU kernels #1 and #3 at
// 1 <= N <= 16), in plain C++ (no CUDA), so that one copy serves the
// kernels, their entry points' plan checks and the layout query of
// grid_mhsa_th_layout.cpp, which the launch plan
// (ops/grid_attention.py:grid_mhsa_th_plan) asks on any host.
//
// A unit is one head of P = 16 / N adjacent grids: their P * N rows are
// one [16, hd] slice of qkv (rows past P * N zero-filled), the M of one
// mma.sync m16 tile. One warp takes one unit.
#pragma once

#ifdef __CUDACC__
#define OGVT_TH_HD __host__ __device__
#else
#define OGVT_TH_HD
#endif

namespace ogvt {
namespace th {

constexpr int kTokens = 16;  // rows of a unit: the M of one mma tile
constexpr int kWarps = 4;    // units a block, one a warp
constexpr int kThreads = 32 * kWarps;
constexpr int kFwdTiles = 3;  // staged [16, hd] tiles a warp: q, k, v
constexpr int kBwdTiles = 4;  // and dO
constexpr int kMaxNT = 8;     // hd / 8 up to 8 (the accumulators' registers)

// Blocks an SM holds at the kernels' register caps (__launch_bounds__):
// eight (64 registers a thread), six for the backward at hd > 32 (80).
OGVT_TH_HD constexpr int sm_blocks(int nt, bool bwd) {
  return bwd && nt > 4 ? 6 : 8;
}

// Registers a thread at `blocks` blocks an SM, in the card's allocation
// unit of 8.
OGVT_TH_HD constexpr int reg_cap(int blocks) {
  return 65536 / (kThreads * blocks) / 8 * 8;
}

// Bytes between two staged rows: hd / 8 16-byte units made odd, so the 8
// rows one ldmatrix reads fall in 8 distinct bank groups.
OGVT_TH_HD constexpr int row_bytes(int nt) { return 16 * (nt | 1); }

OGVT_TH_HD constexpr int tile_bytes(int nt) {
  return kTokens * row_bytes(nt);
}

OGVT_TH_HD constexpr int tiles(bool bwd) { return bwd ? kBwdTiles : kFwdTiles; }

OGVT_TH_HD constexpr int smem_bytes(int nt, bool bwd) {
  return kWarps * tiles(bwd) * tile_bytes(nt);
}

// Grids of N tokens a unit holds.
OGVT_TH_HD constexpr int grids_per_unit(int N) { return kTokens / N; }

// Grids of N tokens, C channels and `heads` heads: 1 <= N <= 16, hd =
// C / heads a multiple of 8 in [8, 64].
inline bool takes(int N, int C, int heads) {
  if (N < 1 || N > kTokens || heads <= 0 || C % heads) return false;
  const int hd = C / heads;
  return hd % 8 == 0 && hd >= 8 && hd <= 8 * kMaxNT;
}

}  // namespace th
}  // namespace ogvt
