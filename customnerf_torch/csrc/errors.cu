// Error text for the cudaError_t codes the kernel launchers return.

#include <cuda_runtime.h>

extern "C" const char* cn_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
