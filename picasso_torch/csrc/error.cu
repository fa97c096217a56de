// Message for a cudaError_t returned by the C entries of this library.

#include <cuda_runtime.h>

extern "C" const char* picasso_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
