// Error text for the codes the launch entry points return.
#include <cuda_runtime.h>

extern "C" const char* pmt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
