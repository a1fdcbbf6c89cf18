// The backward instantiations of #6's bf16 kernel for 1 <= ceil(N / 8)
// <= 5 (N <= 40); csrc/grid_mhsa_packed_mma.cuh holds the kernel.
#include "grid_mhsa_packed_mma.cuh"

namespace ogvt::packed {

cudaError_t launch_bwd_short(int kt8, int nt, const Launch& a) {
  return launch<true, 1, 5>(kt8, nt, a);
}

}  // namespace ogvt::packed
