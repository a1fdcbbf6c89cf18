// The layout, register caps and limits of #6's bf16 kernels for grids of
// N > 256 tokens (csrc/grid_mhsa_tiles.cu), in plain C++ (no CUDA), so
// that one copy serves the kernels, their entry points' plan checks and the
// layout query of grid_mhsa_tiles_layout.cpp, which the launch plan
// (ops/grid_attention.py:grid_mhsa_tiles_plan) asks on any host.
//
// A unit is one head of one grid. Its query rows (forward, backward's
// query kernel) or key rows (backward's key kernel) are cut into `parts`
// blocks of `warps` m16 tiles, one a warp, as even as whole tiles allow;
// the other side's rows stream through a ring of kStages shared buffers in
// chunks of kChunk rows. Every kernel stages its block's own rows (q; q and
// dO; k and v) once and two [kChunk, hd] tiles a chunk (k and v; q and dO),
// the key kernel also the chunk's kStats fp32 statistics a query row. Under
// grad the forward keeps kSaved statistics of each query row for the
// backward, [units, kSaved, covered] fp32; the backward's query kernel adds
// D, [units, covered].
#pragma once

#ifdef __CUDACC__
#define OGVT_TILES_HD __host__ __device__
#else
#define OGVT_TILES_HD
#endif

namespace ogvt {
namespace tiles {

constexpr int kMinN = 257;     // N <= 256 takes csrc/grid_mhsa_long.cu
constexpr int kMaxN = 4096;    // (512 px / grid 8)^2; the ints stay small
constexpr int kMaxWarps = 16;  // m16 tiles of own rows a block, one a warp
constexpr int kThreads = 32 * kMaxWarps;  // the kernels' launch bound
constexpr int kChunk = 64;     // streamed rows a chunk: four m16 tiles
constexpr int kStages = 2;     // the ring's buffers: one chunk in flight
constexpr int kStats = 4;      // a query row's max, sum, 1 / sum and D
constexpr int kSaved = 3;      // the forward's: the max, the sum, 1 / sum
constexpr int kMaxNT = 8;      // hd / 8 up to 8 (the accumulators)

enum Kernel : int { kFwd = 0, kBwdQuery = 1, kBwdKey = 2 };

// Bytes between two staged rows: hd / 8 16-byte units made odd, so the 8
// rows one ldmatrix reads fall in 8 distinct bank groups.
OGVT_TILES_HD constexpr int row_bytes(int nt) { return 16 * (nt | 1); }

OGVT_TILES_HD constexpr int tiles16(int N) { return (N + 15) / 16; }

// Blocks a unit and warps a block: the fewest blocks of at most kMaxWarps
// tiles, the tiles spread evenly over them.
OGVT_TILES_HD constexpr int parts(int N) {
  return (tiles16(N) + kMaxWarps - 1) / kMaxWarps;
}
OGVT_TILES_HD constexpr int warps(int N) {
  return (tiles16(N) + parts(N) - 1) / parts(N);
}

// Rows the blocks of a unit cover (at least N), and so the rows of each
// statistic of a unit.
OGVT_TILES_HD constexpr int covered(int N) { return 16 * warps(N) * parts(N); }

// fp32 statistics a unit that the forward keeps under grad: kSaved of
// covered(N) rows, read by both backward kernels.
OGVT_TILES_HD constexpr int saved_floats(int N) {
  return kSaved * covered(N);
}

// fp32 scratch of the backward a unit: D of covered(N) rows, written by the
// query kernel, read by the key kernel.
OGVT_TILES_HD constexpr int scratch_floats(int N) { return covered(N); }

// One ring buffer: two [kChunk, hd] tiles, and the key kernel's statistics.
OGVT_TILES_HD constexpr int buffer_bytes(int nt, Kernel k) {
  return 2 * kChunk * row_bytes(nt) + (k == kBwdKey ? kStats * kChunk * 4 : 0);
}

// Shared bytes of a block: its own rows (q; q and dO; k and v), then the
// ring.
OGVT_TILES_HD constexpr int smem_bytes(int N, int nt, Kernel k) {
  return (k == kFwd ? 1 : 2) * 16 * warps(N) * row_bytes(nt) +
         kStages * buffer_bytes(nt, k);
}

// Blocks of kThreads an SM holds by the forward's register cap
// (__launch_bounds__(kThreads, fwd_blocks)): two (64 registers a thread) at
// hd <= 32, one (128) otherwise, as csrc/grid_mhsa_long.cu's forward.
OGVT_TILES_HD constexpr int fwd_blocks(int nt) { return nt <= 4 ? 2 : 1; }

// The backward kernels' cap at hd <= 32 (__maxnreg__): two blocks of up to
// 14 warps share an SM (14 * 32 * 72 * 2 <= 65536), so 24 warps at N = 576
// (12 a block) and 26 at N = 784 (13); 128 above, one block of 16 warps.
constexpr int kBwdRegs = 72;

// Registers a thread of each kernel.
OGVT_TILES_HD constexpr int reg_cap(int nt, Kernel k) {
  return k == kFwd ? 65536 / (kThreads * fwd_blocks(nt)) / 8 * 8
                   : nt <= 4 ? kBwdRegs : 128;
}

// Walks of the key kernel over the query chunks: dv and dk in one, or at
// hd > 32 dv, then dk, to stay within the register cap.
OGVT_TILES_HD constexpr int walks(int nt) { return nt <= 4 ? 1 : 2; }

// Grids of N tokens, C channels and `heads` heads: 257 <= N <= 4096, hd =
// C / heads a multiple of 8 in [8, 64].
inline bool takes(int N, int C, int heads) {
  if (N < kMinN || N > kMaxN || heads <= 0 || C % heads) return false;
  const int hd = C / heads;
  return hd % 8 == 0 && hd >= 8 && hd <= 8 * kMaxNT;
}

}  // namespace tiles
}  // namespace ogvt
