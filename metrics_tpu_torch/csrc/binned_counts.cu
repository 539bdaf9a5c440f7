// Label/score sketch histograms (B5): per-class histograms of (N, C) scores
// on a fixed grid of B bins over [lo, hi], split by label, plus the count of
// scores outside [lo, hi].
//
// Replaces the Pallas kernel `_hist_kernel` of
// metrics_tpu/kernels/binned_counts.py (entry
// `label_score_histograms_pallas`). There the TPU walks one class column at
// a time, builds a (TILE, B) one-hot of the bin indices in VMEM and
// contracts it with the label masses on its matrix unit: N * B
// multiply-adds per class for N useful additions. On Hopper each score is
// one addition of 1.0 into its bin.
//
// Bound: bytes. Each score and label is read once and each histogram bin
// written once: at N = 1024, C = 1000, B = 2048 that is 8.2 MB of input and
// 16.4 MB of output, 7.3 us at the H100's 3.35 TB/s. At N = 10,000, C = 1
// it is 96 KB (0.03 us): launch latency sets that floor.
//
// Design: a grid-stride loop over the N * C scores in memory order, so a
// warp reads 32 neighbouring classes of a row (C = 1000) or 32 rows (C = 1)
// coalesced. Two ways to count:
//  * when both histograms fit in 47 KB of shared memory (2 * C * B * 4
//    bytes, C = 1 at B = 2048 takes 16 KB), each block counts
//    into its own copy in shared memory with integer atomics and then adds
//    its non-zero bins to the output; rows of one class contend there, not
//    in L2;
//  * otherwise each score is one float atomicAdd of 1.0 into the output,
//    which at C = 1000, B = 2048 (16.4 MB) stays in the 50 MB L2 cache.
// Adding whole numbers below 2^24 in float32 is exact, so the counts do not
// depend on the order of the atomics. Each block adds its clipped count once.
//
// The bin index is the reference's float32 arithmetic in its order:
// floor((x - lo) / span * B), clipped to [0, B - 1], with lo, span and B
// each a float32 the caller rounded once. The intrinsics keep the compiler
// from contracting or reordering it, and the division is IEEE (no
// reciprocal). A NaN score goes to bin 0 and is not clipped, as in the
// reference; +-inf clip into the edge bins and are counted; a subnormal score
// counts as zero, as XLA reads it.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxGlobalBlocks = 2112;  // sixteen blocks per SM of the H100's 132
constexpr int64_t kMaxSharedBlocks = 264;   // two per SM: each block flushes its whole copy
constexpr int64_t kScoresPerSharedBlock = 4096;
// the 48 KB a block may use without opting in, less room for add_clipped's
// static warp sums
constexpr int64_t kSharedBytes = 47 * 1024;

struct Grid {
  float lo, hi, span, bins, last;  // last = B - 1
  int num_bins;
};

// XLA reads a subnormal as zero (on the TPU and on the CPU), which decides
// whether a tiny negative score is below lo = 0.
__device__ __forceinline__ float flush_subnormal(float x) { return fabsf(x) < 1.17549435e-38f ? 0.0f : x; }

__device__ __forceinline__ int bin_of(float x, const Grid& g) {
  if (x != x) return 0;  // NaN
  const float f = floorf(__fmul_rn(__fdiv_rn(__fsub_rn(x, g.lo), g.span), g.bins));
  if (!(f > 0.0f)) return 0;  // below the grid, -inf, or NaN (from an infinite lo)
  if (f > g.last) return g.num_bins - 1;
  return static_cast<int>(f);
}

__device__ __forceinline__ int out_of_range(float x, const Grid& g) { return (x < g.lo) || (x > g.hi); }

// Adds a block's clipped count to the output, once per block and only if
// it is non-zero.
__device__ void add_clipped(int count, float* clipped) {
  __shared__ int warp_sums[kThreads / 32];
  for (int offset = 16; offset > 0; offset >>= 1) count += __shfl_down_sync(0xffffffffu, count, offset);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = count;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kThreads / 32; ++w) total += warp_sums[w];
    if (total) atomicAdd(clipped, static_cast<float>(total));
  }
}

__global__ void hist_global_kernel(const float* __restrict__ x, const int* __restrict__ t, int64_t total, int64_t c,
                                   Grid g, float* __restrict__ hist, float* __restrict__ clipped) {
  const int64_t neg_offset = c * g.num_bins;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int count = 0;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < total; i += stride) {
    const float v = flush_subnormal(x[i]);
    const int64_t col = i % c;
    const int64_t cell = (t[i] == 1 ? 0 : neg_offset) + col * g.num_bins + bin_of(v, g);
    atomicAdd(hist + cell, 1.0f);
    count += out_of_range(v, g);
  }
  add_clipped(count, clipped);
}

__global__ void hist_shared_kernel(const float* __restrict__ x, const int* __restrict__ t, int64_t total, int c,
                                   Grid g, float* __restrict__ hist, float* __restrict__ clipped) {
  extern __shared__ unsigned int local[];
  const int neg_offset = c * g.num_bins;
  const int cells = 2 * neg_offset;
  for (int j = threadIdx.x; j < cells; j += blockDim.x) local[j] = 0u;
  __syncthreads();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int count = 0;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < total; i += stride) {
    const float v = flush_subnormal(x[i]);
    const int col = static_cast<int>(i % c);
    atomicAdd(local + (t[i] == 1 ? 0 : neg_offset) + col * g.num_bins + bin_of(v, g), 1u);
    count += out_of_range(v, g);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < cells; j += blockDim.x) {
    const unsigned int n = local[j];
    if (n) atomicAdd(hist + j, static_cast<float>(n));
  }
  add_clipped(count, clipped);
}

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

}  // namespace

// preds: (n, c) float32, target: (n, c) int32 (1 = positive), both
// contiguous. out: 2 * c * num_bins + 1 float32, zero-filled: pos_hist
// (c, num_bins), then neg_hist (c, num_bins), then the clipped count. lo, hi
// and span = hi - lo are the caller's float32 roundings. Returns
// cudaGetLastError() after the launch.
extern "C" int label_score_histograms_launch(const void* preds, const void* target, int64_t n, int64_t c,
                                             int num_bins, float lo, float hi, float span, void* out,
                                             void* stream) {
  if (n <= 0 || c <= 0) return 0;
  if (num_bins < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Grid g{lo, hi, span, static_cast<float>(num_bins), static_cast<float>(num_bins - 1), num_bins};
  const int64_t total = n * c;
  const float* x = static_cast<const float*>(preds);
  const int* t = static_cast<const int*>(target);
  float* hist = static_cast<float*>(out);
  float* clipped = hist + 2 * c * num_bins;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t shared_bytes = 2 * c * num_bins * static_cast<int64_t>(sizeof(unsigned int));
  if (shared_bytes <= kSharedBytes) {
    int64_t blocks = ceil_div(total, kScoresPerSharedBlock);
    if (blocks > kMaxSharedBlocks) blocks = kMaxSharedBlocks;
    hist_shared_kernel<<<static_cast<unsigned>(blocks), kThreads, static_cast<size_t>(shared_bytes), st>>>(
        x, t, total, static_cast<int>(c), g, hist, clipped);
  } else {
    int64_t blocks = ceil_div(total, kThreads);
    if (blocks > kMaxGlobalBlocks) blocks = kMaxGlobalBlocks;
    hist_global_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(x, t, total, c, g, hist, clipped);
  }
  return static_cast<int>(cudaGetLastError());
}
