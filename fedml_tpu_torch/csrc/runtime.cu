// The C interface's error text: the Python wrappers raise with it when a
// launch entry returns a nonzero cudaError_t.
#include <cuda_runtime.h>

extern "C" const char* fedml_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
