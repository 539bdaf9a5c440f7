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
//
// Batched form (confmat_counts_batched_launch): a (B, N) stack of label pairs
// (the keyed rows of a ConfusionMatrix, (R, 1) under torch.func.vmap; a
// bootstrap's children, (20, 1024)) into (B, C, C) counts in one launch,
// cell offsets in int64. Bound: the B*C*C*4-byte output, written once, and
// the 2*B*N*8 bytes of int64 pairs read once (8.4 MB and 131 KB at
// (8192, 1, 16); 80 MB and 328 KB at (20, 1024, 1000)).
// Two routes, picked from C:
//
// * C*C*4 bytes fit a block's shared memory (227 KB with the opt-in, C <=
//   241): a block owns a run of whole slices. It zeroes their histograms in
//   shared memory, counts their pairs with shared-memory atomics, and writes
//   every cell of its slices, zeros included, with 16-byte stores. No global
//   atomics, no separate zero fill: each output byte is written once. At
//   C = 16 a slice is 1 KB, and a block holds up to 48 of them in the 48 KB
//   it may use without opting in; a slice above that has a block of its own,
//   with the opt-in.
// * Larger C (a bootstrap's C = 1000, 4 MB a slice): the output is zeroed
//   with cudaMemsetAsync on the same stream, then blockIdx.y picks the slice,
//   so that the blocks in flight share a few slices' cells in the 50 MB L2,
//   and a grid-stride loop over its pairs adds int32 atomics at int64
//   offsets.
#include <cstdint>
#include <cuda_runtime.h>

#include "device_scope.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 1056;  // eight blocks per SM of the H100's 132
constexpr int64_t kTargetBlocks = 264;  // two blocks per SM
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

// the batched form
constexpr int64_t kDefaultShared = 48 * 1024;  // a block's shared memory without the opt-in
constexpr int64_t kMaxShared = 232448;          // the opt-in maximum of sm_90: 227 KB
constexpr int64_t kMaxGridY = 65535;

// Block b owns slices [b * per_block, min(batch, (b + 1) * per_block)).
template <typename Index>
__global__ void confmat_batched_shared_kernel(const Index* __restrict__ preds, const Index* __restrict__ target,
                                              int64_t batch, int64_t n, int c, int64_t per_block,
                                              int* __restrict__ out) {
  extern __shared__ int4 smem[];
  int* hist = reinterpret_cast<int*>(smem);
  const int64_t first = static_cast<int64_t>(blockIdx.x) * per_block;
  const int64_t slices = batch - first < per_block ? batch - first : per_block;
  const int cells = c * c;
  const int64_t total = slices * cells;  // < kMaxShared / 4
  const int zero_vecs = static_cast<int>(total / 4);
  for (int i = threadIdx.x; i < zero_vecs; i += blockDim.x) smem[i] = make_int4(0, 0, 0, 0);
  for (int i = zero_vecs * 4 + threadIdx.x; i < total; i += blockDim.x) hist[i] = 0;
  __syncthreads();
  const int64_t pairs = slices * n;
  preds += first * n;
  target += first * n;
  for (int64_t j = threadIdx.x; j < pairs; j += blockDim.x) {
    const Index t = target[j];
    const Index p = preds[j];
    if (t >= 0 && t < c && p >= 0 && p < c) {
      const int64_t slice = n == 1 ? j : j / n;
      atomicAdd(hist + slice * cells + static_cast<int>(t) * c + static_cast<int>(p), 1);
    }
  }
  __syncthreads();
  // every cell of the block's slices, zeros included: 16-byte stores where
  // the block's first cell is 16-byte aligned, else 4-byte ones
  int* dst = out + first * cells;
  if ((first * cells) % 4 == 0) {
    int4* dst4 = reinterpret_cast<int4*>(dst);
    for (int i = threadIdx.x; i < zero_vecs; i += blockDim.x) dst4[i] = smem[i];
    for (int i = zero_vecs * 4 + threadIdx.x; i < total; i += blockDim.x) dst[i] = hist[i];
  } else {
    for (int i = threadIdx.x; i < total; i += blockDim.x) dst[i] = hist[i];
  }
}

// Slice blockIdx.y (and every gridDim.y-th after it): its pairs by a
// grid-stride loop over the x blocks, one atomicAdd each into the zeroed output.
template <typename Index>
__global__ void confmat_batched_global_kernel(const Index* __restrict__ preds, const Index* __restrict__ target,
                                              int64_t batch, int64_t n, int c, int* __restrict__ out) {
  const int64_t cells = static_cast<int64_t>(c) * c;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t slice = blockIdx.y; slice < batch; slice += gridDim.y) {
    const Index* p_row = preds + slice * n;
    const Index* t_row = target + slice * n;
    int* o = out + slice * cells;
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n; i += stride) {
      const Index t = t_row[i];
      const Index p = p_row[i];
      if (t >= 0 && t < c && p >= 0 && p < c) atomicAdd(o + static_cast<int64_t>(t) * c + static_cast<int64_t>(p), 1);
    }
  }
}

template <typename Index>
int launch_batched(const void* preds, const void* target, int64_t batch, int64_t n, int c, void* out,
                   cudaStream_t stream) {
  const Index* p = static_cast<const Index*>(preds);
  const Index* t = static_cast<const Index*>(target);
  int* o = static_cast<int*>(out);
  const int64_t slice_bytes = static_cast<int64_t>(c) * c * sizeof(int);
  if (slice_bytes <= kMaxShared) {
    // as many slices a block as fit in the default 48 KB, but no fewer than
    // two blocks per SM where the stack has the slices for them
    int64_t per_block = slice_bytes <= kDefaultShared ? kDefaultShared / slice_bytes : 1;
    const int64_t spread = (batch + kTargetBlocks - 1) / kTargetBlocks;
    if (per_block > spread) per_block = spread;
    const int64_t blocks = (batch + per_block - 1) / per_block;
    const size_t smem = static_cast<size_t>(per_block * slice_bytes);
    if (smem > static_cast<size_t>(kDefaultShared)) {
      const cudaError_t err = cudaFuncSetAttribute(confmat_batched_shared_kernel<Index>,
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                   static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    confmat_batched_shared_kernel<Index><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
        p, t, batch, n, c, per_block, o);
    return static_cast<int>(cudaGetLastError());
  }
  const cudaError_t err = cudaMemsetAsync(o, 0, static_cast<size_t>(batch * slice_bytes), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t rows = batch < kMaxGridY ? batch : kMaxGridY;
  int64_t xblocks = (n + kThreads - 1) / kThreads;
  const int64_t x_cap = kMaxBlocks / rows > 1 ? kMaxBlocks / rows : 1;
  if (xblocks > x_cap) xblocks = x_cap;
  if (xblocks < 1) xblocks = 1;
  const dim3 grid(static_cast<unsigned>(xblocks), static_cast<unsigned>(rows));
  confmat_batched_global_kernel<Index><<<grid, kThreads, 0, stream>>>(p, t, batch, n, c, o);
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

// The batched form: preds, target: (batch, n) int32 (index_bytes=4) or int64
// (index_bytes=8), contiguous. out: (batch, c, c) int32, need not be
// initialised: every cell is written (see the routes above). Otherwise as
// confmat_counts_launch.
extern "C" int confmat_counts_batched_launch(const void* preds, const void* target, int64_t batch, int64_t n, int c,
                                             int index_bytes, void* out, int device, void* stream) {
  if (batch <= 0 || c <= 0) return 0;
  if (index_bytes != 4 && index_bytes != 8) return static_cast<int>(cudaErrorInvalidValue);
  DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (index_bytes == 8) return launch_batched<int64_t>(preds, target, batch, n, c, out, s);
  return launch_batched<int32_t>(preds, target, batch, n, c, out, s);
}
