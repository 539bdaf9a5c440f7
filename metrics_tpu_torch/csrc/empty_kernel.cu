// A kernel that does nothing: its device time is the floor under every
// kernel's, which a byte bound of a few KB (B5 at C = 1) cannot show.
#include <cuda_runtime.h>

#include "device_scope.cuh"

namespace {

__global__ void empty_kernel() {}

}  // namespace

// Launches one block of one thread on `stream` with `device` made current.
// Returns the first CUDA error of the call (0 if none).
extern "C" int empty_kernel_launch(int device, void* stream) {
  DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  empty_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
