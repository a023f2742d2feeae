// The text of an error code returned by one of the entry points: a
// cudaError_t, or 0x10000 plus the CUresult of a TMA tensor map that the
// driver did not encode (0x10000 alone: the driver has no
// cuTensorMapEncodeTiled).
#include <cuda_runtime.h>
#include <stdio.h>

extern "C" const char* gvl_error_string(int err) {
  if (err >= 0x10000) {
    static thread_local char text[96];
    snprintf(text, sizeof text, "cuTensorMapEncodeTiled failed (CUresult %d)", err - 0x10000);
    return text;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
