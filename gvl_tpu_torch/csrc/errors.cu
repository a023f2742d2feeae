// The text of a cudaError_t returned by one of the entry points.
#include <cuda_runtime.h>

extern "C" const char* gvl_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
