// The CUDA runtime's message for an error code returned by a launcher, so the
// Python wrappers can raise with it (the runtime is linked statically into
// the kernels' library, so its symbols are not otherwise reachable).

#include <cuda_runtime.h>

extern "C" const char* amt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
