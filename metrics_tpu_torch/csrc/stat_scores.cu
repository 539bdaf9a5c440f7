// Per-class tp/fp/tn/fn counts of canonical binary (N, C) inputs.
//
// Replaces the Pallas kernel `_stat_scores_kernel` of
// metrics_tpu/kernels/stat_scores.py (entry `stat_scores_counts_pallas`).
//
// Bound: reading the two (N, C) int32 inputs once, 2*N*C*4 bytes (8.19 MB at
// the ImageNet-1k evaluation shape N=1024, C=1000: about 2.4 us at the H100's
// 3.35 TB/s). The arithmetic is four compares per element.
//
// Design: one thread per class column, so the 32 threads of a warp read 32
// neighbouring classes of one row and every load is coalesced. A block covers
// 256 columns and one chunk of rows; the grid splits N into chunks so that
// about two blocks per SM are in flight. Each thread keeps its four counters
// in registers over its rows and ends with at most four int32 atomicAdd into
// the (4, C) output, which the caller zero-fills. Integer atomics make the
// counts exact and independent of the order of the blocks. The ragged edges
// are masked here (columns past C) and by the row bounds, so no sentinel
// padding is needed.
//
// Batched form: a (B, N, C) stack of independent inputs (under
// torch.func.vmap, as pallas_call's batching rule runs the Pallas kernel over
// a leading grid axis) has two layouts, picked by the C entry from (B, N, C):
//
// * Long slices (a bootstrap's children, (20, 1024, 1000)) take the grid's z
//   axis for their batch index; each z counts its own (N, C) slice into its
//   own (C,) rows of the (4, B, C) output with the atomics above, after a
//   cudaMemsetAsync of the output on the same stream.
// * Short slices (the keyed path's rows, (R, 1, C)): a flat 1-D grid over the
//   B*C (slice, column) pairs. Thread i owns slice i / C and column i % C,
//   loops over the slice's few rows and stores its four counts: no atomics,
//   and every output cell is written once, so the output needs no zero fill.
//   At N = 1 the 32 threads of a warp read 32 consecutive ints. The z form
//   would give each slice a block of 256 threads for its C columns (246 of
//   them idle at C = 10) and loop over groups of 65,535 slices.
#include <cstdint>
#include <cuda_runtime.h>

#include "device_scope.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int64_t kTargetBlocks = 264;  // two blocks per SM of the H100's 132
// a stack's blocks: eight per SM (2048 threads, the SM's most), enough loads
// in flight to stream a (20, 1024, 1000) stack's 164 MB
constexpr int64_t kBatchedTargetBlocks = 1056;

__global__ void stat_scores_counts_kernel(const int* __restrict__ preds, const int* __restrict__ target,
                                          int64_t batch, int64_t n, int64_t c, int64_t rows_per_chunk,
                                          int* __restrict__ out) {
  const int64_t col = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (col >= c) return;
  const int64_t slice = blockIdx.z;
  preds += slice * n * c;
  target += slice * n * c;
  const int64_t row_begin = static_cast<int64_t>(blockIdx.y) * rows_per_chunk;
  const int64_t row_end = row_begin + rows_per_chunk < n ? row_begin + rows_per_chunk : n;
  int tp = 0, fp = 0, tn = 0, fn = 0;
  for (int64_t r = row_begin; r < row_end; ++r) {
    const int p = __ldg(preds + r * c + col);
    const int t = __ldg(target + r * c + col);
    const int eq = p == t;
    if (p == 1) {
      tp += eq;
      fp += 1 - eq;
    } else if (p == 0) {
      tn += eq;
      fn += 1 - eq;
    }
  }
  // rows tp, fp, tn, fn of the (4, batch, c) output
  const int64_t stride = batch * c;
  out += slice * c + col;
  if (tp) atomicAdd(out, tp);
  if (fp) atomicAdd(out + stride, fp);
  if (tn) atomicAdd(out + 2 * stride, tn);
  if (fn) atomicAdd(out + 3 * stride, fn);
}

// One thread per (slice, column) pair of a stack of short slices: the
// (4, batch, c) output's cell slice * c + col of each row, stored once.
__global__ void stat_scores_counts_short_kernel(const int* __restrict__ preds, const int* __restrict__ target,
                                                int64_t batch, int64_t n, int64_t c, int* __restrict__ out) {
  const int64_t pairs = batch * c;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= pairs) return;
  const int64_t slice = i / c;
  const int64_t col = i - slice * c;
  const int* p_row = preds + slice * n * c + col;
  const int* t_row = target + slice * n * c + col;
  int tp = 0, fp = 0, tn = 0, fn = 0;
  for (int64_t r = 0; r < n; ++r) {
    const int p = __ldg(p_row + r * c);
    const int t = __ldg(t_row + r * c);
    const int eq = p == t;
    if (p == 1) {
      tp += eq;
      fp += 1 - eq;
    } else if (p == 0) {
      tn += eq;
      fn += 1 - eq;
    }
  }
  out[i] = tp;
  out[pairs + i] = fp;
  out[2 * pairs + i] = tn;
  out[3 * pairs + i] = fn;
}

// A slice of at most this many rows is short: one thread loops over all of
// its rows, where the z form would split them into chunks of a row or two,
// each ending in atomics.
constexpr int64_t kShortRows = 32;

constexpr int64_t kMaxGridZ = 65535;

// Launches the batch in groups of at most kMaxGridZ slices (the grid's z
// limit); each group's blocks split N so that about kTargetBlocks blocks
// (kBatchedTargetBlocks for a stack) are in flight.
int launch(const int* preds, const int* target, int64_t batch, int64_t n, int64_t c, int* out,
           cudaStream_t stream) {
  const int64_t col_blocks = (c + kThreads - 1) / kThreads;
  for (int64_t first = 0; first < batch; first += kMaxGridZ) {
    const int64_t slices = batch - first < kMaxGridZ ? batch - first : kMaxGridZ;
    int64_t chunks = (batch > 1 ? kBatchedTargetBlocks : kTargetBlocks) / (col_blocks * slices);
    if (chunks < 1) chunks = 1;
    if (chunks > n) chunks = n;
    const int64_t rows_per_chunk = (n + chunks - 1) / chunks;
    chunks = (n + rows_per_chunk - 1) / rows_per_chunk;
    const dim3 grid(static_cast<unsigned>(col_blocks), static_cast<unsigned>(chunks), static_cast<unsigned>(slices));
    // the group's first slice: its inputs, and its columns of every output row
    stat_scores_counts_kernel<<<grid, kThreads, 0, stream>>>(preds + first * n * c, target + first * n * c, batch, n,
                                                           c, rows_per_chunk, out + first * c);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

// preds, target: (n, c) int32, contiguous. out: (4, c) int32, zero-filled,
// rows tp, fp, tn, fn. The launch goes to `stream` with `device` made current
// for the call. Returns the first CUDA error of the call (0 if none).
extern "C" int stat_scores_counts_launch(const void* preds, const void* target, int64_t n, int64_t c, void* out,
                                         int device, void* stream) {
  if (n <= 0 || c <= 0) return 0;
  DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  return launch(static_cast<const int*>(preds), static_cast<const int*>(target), 1, n, c, static_cast<int*>(out),
                static_cast<cudaStream_t>(stream));
}

// The batched form: preds, target: (batch, n, c) int32, contiguous. out:
// (4, batch, c) int32, need not be initialised: the short-slice layout stores
// every cell, the long-slice one zero-fills it on `stream` first. A slice is
// short when it has at most kShortRows rows, or when the z form's grid is
// full without splitting any slice's rows (one chunk covers a whole slice).
// Otherwise as stat_scores_counts_launch.
extern "C" int stat_scores_counts_batched_launch(const void* preds, const void* target, int64_t batch, int64_t n,
                                                 int64_t c, void* out, int device, void* stream) {
  if (batch <= 0 || c <= 0) return 0;
  DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(preds);
  const int* t = static_cast<const int*>(target);
  int* o = static_cast<int*>(out);
  const int64_t col_blocks = (c + kThreads - 1) / kThreads;
  if (n <= kShortRows || col_blocks * batch >= kBatchedTargetBlocks) {
    const int64_t blocks = (batch * c + kThreads - 1) / kThreads;
    stat_scores_counts_short_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(p, t, batch, n, c, o);
    return static_cast<int>(cudaGetLastError());
  }
  const cudaError_t err = cudaMemsetAsync(o, 0, static_cast<size_t>(4 * batch * c) * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch(p, t, batch, n, c, o, s);
}
