// Entry points of #6's bf16 kernel (csrc/grid_mhsa_packed_mma.cuh, whose
// note says what it computes and how) and its forward's instantiations.
#include <stdint.h>

#include <initializer_list>

#include "grid_mhsa_packed_mma.cuh"

using namespace ogvt;
using namespace ogvt::packed;

namespace {

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The launch this file takes: 1 <= N <= 63, hd = C / heads a multiple of 8
// in [8, 64], 1 to kMaxWarps warps of warp_bytes each, 16-byte aligned
// pointers. Returns false for anything else.
bool plan_ok(int G, int N, int C, int heads, int warps, int smem, bool bwd,
             std::initializer_list<const void*> ptrs) {
  if (G < 0 || N < 1 || N > 63 || heads <= 0 || C % heads) return false;
  const int hd = C / heads;
  if (hd % 8 || hd < 8 || hd > 64) return false;
  if (warps < 1 || warps > kMaxWarps) return false;
  if (smem != warps * warp_bytes((N + 7) / 8, hd / 8, bwd)) return false;
  for (const void* p : ptrs) {
    if (!aligned16(p)) return false;
  }
  return true;
}

}  // namespace

// qkv [G, N, 3C] -> out [G, N, C], both contiguous bf16; `warps` and `smem`
// (bytes a block) as grid_mhsa_packed_plan gives them.
extern "C" int ogvt_grid_mhsa_packed_mma(const void* qkv, void* out, int G,
                                         int N, int C, int heads, float scale,
                                         int warps, int smem, int dtype,
                                         void* stream) {
  if (dtype != kBFloat16 ||
      !plan_ok(G, N, C, heads, warps, smem, false, {qkv, out})) {
    return cudaErrorInvalidValue;
  }
  if (G == 0) return cudaSuccess;
  const Launch a{static_cast<const bf16*>(qkv), nullptr,
                 static_cast<bf16*>(out), G * heads, N, heads, scale, warps,
                 smem, static_cast<cudaStream_t>(stream)};
  return launch<false, 1, 8>((N + 7) / 8, C / heads / 8, a);
}

// qkv [G, N, 3C], dout [G, N, C] -> dqkv [G, N, 3C], all contiguous bf16;
// `warps` and `smem` as grid_mhsa_packed_plan gives them.
extern "C" int ogvt_grid_mhsa_packed_mma_bwd(const void* qkv,
                                             const void* dout, void* dqkv,
                                             int G, int N, int C, int heads,
                                             float scale, int warps, int smem,
                                             int dtype, void* stream) {
  if (dtype != kBFloat16 ||
      !plan_ok(G, N, C, heads, warps, smem, true, {qkv, dout, dqkv})) {
    return cudaErrorInvalidValue;
  }
  if (G == 0) return cudaSuccess;
  const Launch a{static_cast<const bf16*>(qkv),
                 static_cast<const bf16*>(dout), static_cast<bf16*>(dqkv),
                 G * heads, N, heads, scale, warps, smem,
                 static_cast<cudaStream_t>(stream)};
  const int kt8 = (N + 7) / 8, nt = C / heads / 8;
  return kt8 <= 5 ? launch_bwd_short(kt8, nt, a)
                  : launch_bwd_long(kt8, nt, a);
}
