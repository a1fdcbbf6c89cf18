// The backward instantiations of #6's bf16 kernel for 6 <= ceil(N / 8)
// <= 8 (40 < N <= 63); csrc/grid_mhsa_packed_mma.cuh holds the kernel.
#include "grid_mhsa_packed_mma.cuh"

namespace ogvt::packed {

cudaError_t launch_bwd_long(int kt8, int nt, const Launch& a) {
  return launch<true, 6, 8>(kt8, nt, a);
}

}  // namespace ogvt::packed
