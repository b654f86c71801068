// Error text for the codes the kernel entry points return, so the Python
// wrappers can raise with CUDA's own message.
#include <cuda_runtime.h>

extern "C" const char* flexvec_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
