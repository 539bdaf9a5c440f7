// Confusion-matrix counts: out[t * C + p] += 1 for each (target, pred) pair.
//
// Replaces the Pallas kernel `_confmat_kernel` of
// metrics_tpu/kernels/confusion_matrix.py (entry `confmat_counts_pallas`).
// There the TPU counts with a one-hot matmul on its matrix unit; on Hopper a
// histogram with integer atomics does the same count with N additions
// instead of N*C*C multiply-adds.
//
// Bound: the C*C*4-byte int32 output, zero-filled by the caller and written
// once (4 MB at C=1000: about 1.2 us at the H100's 3.35 TB/s); the two (N,)
// label vectors add 16 KB at N=1024.
//
// Design: a grid-stride loop over the pairs. When the C*C histogram fits in
// the 48 KB a block may use without opting in (C <= 110), each block counts
// into its own copy in shared memory and then adds its non-zero cells to the
// output, so the global atomics scale with the cells rather than the pairs.
// Above that, each pair is one atomicAdd into the output, which at C=1000
// (4 MB) stays in the 50 MB L2 cache. Integer atomics make the counts exact
// and independent of order. A pair with t or p outside [0, C) is dropped, as
// the Pallas kernel drops it.
#include <cstdint>
#include <cuda_runtime.h>

#include "device_scope.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 1056;  // eight blocks per SM of the H100's 132
constexpr int kSharedMaxClasses = 110;  // 110 * 110 * 4 = 48,400 bytes

template <typename Index>
__global__ void confmat_shared_kernel(const Index* __restrict__ preds, const Index* __restrict__ target, int64_t n,
                                      int c, int* __restrict__ out) {
  extern __shared__ int hist[];
  const int cells = c * c;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) hist[i] = 0;
  __syncthreads();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n; i += stride) {
    const Index t = target[i];
    const Index p = preds[i];
    if (t >= 0 && t < c && p >= 0 && p < c) atomicAdd(hist + static_cast<int>(t) * c + static_cast<int>(p), 1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const int v = hist[i];
    if (v) atomicAdd(out + i, v);
  }
}

template <typename Index>
__global__ void confmat_global_kernel(const Index* __restrict__ preds, const Index* __restrict__ target, int64_t n,
                                      int c, int* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n; i += stride) {
    const Index t = target[i];
    const Index p = preds[i];
    if (t >= 0 && t < c && p >= 0 && p < c) {
      atomicAdd(out + static_cast<int64_t>(t) * c + static_cast<int64_t>(p), 1);
    }
  }
}

template <typename Index>
int launch(const void* preds, const void* target, int64_t n, int c, void* out, cudaStream_t stream) {
  if (n <= 0 || c <= 0) return 0;
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const Index* p = static_cast<const Index*>(preds);
  const Index* t = static_cast<const Index*>(target);
  int* o = static_cast<int*>(out);
  if (c <= kSharedMaxClasses) {
    const size_t smem = static_cast<size_t>(c) * c * sizeof(int);
    confmat_shared_kernel<Index><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(p, t, n, c, o);
  } else {
    confmat_global_kernel<Index><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(p, t, n, c, o);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// preds, target: (n,) int32 (index_bytes=4) or int64 (index_bytes=8),
// contiguous. out: (c, c) int32, zero-filled. The launch goes to `stream` with
// `device` made current for the call. Returns the first CUDA error of the
// call (0 if none).
extern "C" int confmat_counts_launch(const void* preds, const void* target, int64_t n, int c, int index_bytes,
                                     void* out, int device, void* stream) {
  if (n <= 0 || c <= 0) return 0;
  DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (index_bytes == 8) return launch<int64_t>(preds, target, n, c, out, s);
  if (index_bytes == 4) return launch<int32_t>(preds, target, n, c, out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
