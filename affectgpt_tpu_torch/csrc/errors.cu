// Names a CUDA error code returned by one of the library's C entries.
#include <cuda_runtime.h>

extern "C" const char* agk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
