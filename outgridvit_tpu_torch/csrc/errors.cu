// Error text for the codes the kernel entry points return.
#include <cuda_runtime.h>

extern "C" const char* ogvt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
