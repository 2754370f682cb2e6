// Shared entry of the port's kernel library: the message of a CUDA error
// code, for the Python wrappers that raise on a failed launch.
#include <cuda_runtime.h>

extern "C" const char* arrl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
