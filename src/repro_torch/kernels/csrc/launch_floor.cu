// An empty kernel of one thread: the floor under every launch's device time.
//
// Replaces no TPU kernel.  It is timed the way the port's kernels are
// (CUDA events around back-to-back launches queued behind a device sleep),
// so a kernel's time can be read against what a launch costs by itself:
// a kernel that does almost no work, such as rmsnorm at one decode step,
// cannot take less.

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

// Launches one block of one thread on the stream; returns cudaGetLastError().
extern "C" int launch_floor_empty(void* stream) {
  empty_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* launch_floor_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
