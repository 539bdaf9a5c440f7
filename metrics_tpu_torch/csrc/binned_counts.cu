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
// one addition of 1 into its bin.
//
// Bound: bytes. Each score and label is read once and each histogram bin
// written once: at N = 1024, C = 1000, B = 2048 that is 8.2 MB of input
// (4.1 MB with class ids for labels) and 16.4 MB of output, 7.3 us (6.1 us)
// at the H100's 3.35 TB/s. At N = 10,000, C = 1 it is 96 KB (0.03 us): the
// latency of one launch sets that floor.
//
// Design: owner computes. The caller's plan cuts the C class columns into
// tiles of K columns whose two (K, B) count tiles fit in a block's shared
// memory (up to 226 KB, opted into per kernel), and the N rows into chunks;
// block (tile, chunk) zeroes its counts, walks its rows reading K scores and
// K labels per row (K a multiple of 8 where C allows, so that a row's K
// floats are whole 32-byte sectors; 16-byte loads where C, K and the
// pointers allow), and counts with 32-bit integer atomics in shared memory.
// Then, by mode:
//  * store (one chunk): the block owns its (K, B) tiles of both outputs and
//    stores them as float32 with plain coalesced 16-byte stores. Every
//    output bin is written exactly once: no fill, no global atomic, and the
//    result does not depend on the order of anything. The clipped count is
//    stored by the block itself when the grid is one block, else added by
//    each block that has any to a cell that a 4-byte memset on the same
//    stream zeroed first.
//  * add (several chunks; few columns, many rows, as the binary stream's
//    10,000 x 1): one cooperative launch whose blocks first zero their share
//    of the outputs, count, sync the grid and then add their non-zero bins
//    with float atomics. Adding whole numbers below 2^24 in float32 is
//    exact, so the counts do not depend on the order of the atomics. On the
//    H100 the cooperative launch took 4.7 us of device time at 10,000 x 1
//    against 6.0-6.8 us behind three memsets (4.3-4.4 behind one memset of
//    outputs laid out back to back, whose views cost the host more), and
//    8.6 against 10.8 us at 1,000,000 x 1; one block that stores took 6.4.
//  * global (B so large that one column's two tiles do not fit): one float
//    atomicAdd of 1.0 per score into the outputs.
// Labels come dense ((N, C) int32, positive where 1) or as one class id per
// row ((N,) int32 or int64, positive where the id equals the column; an id
// outside [0, C) makes the whole row negative), which saves reading and
// building N * C labels in the one-vs-rest case.
//
// The batched form (label_score_histograms_batched_launch) is the same
// kernel under `jax.vmap`, where `pallas_call`'s batching rule runs
// `_hist_kernel` over a stack of R slices: (R, N, C) scores with (R, N, C)
// dense labels or (R, N) class ids, giving (R, C, B) x 2 and (R,). Every
// slice is counted exactly as one call of the single form counts it. Bound:
// bytes, dominated by the output's 2 * R * C * B floats where the slices are
// short (the keyed path's (R, 1, C) rows: 67 MB, 0.020 ms, at R = 4096,
// C = 1, B = 2048). Design: the store mode with the slice on the grid's z
// axis, in groups of 65,535 slices. Block (tile, 0, slice) counts its
// slice's rows for its tile of columns in shared memory and stores both
// output tiles once, zeros included: no fill before the launch and no
// atomic on the histograms. A slice cut into several tiles adds its clipped
// count from each tile to a cell zeroed by a memset of R floats; a slice of
// one tile stores it. Long slices (a bootstrap's (20, 1024, 1000)) take the
// same layout, each block walking all of its slice's rows. A num_bins whose
// single column does not fit in shared memory takes the global mode: a
// memset of the outputs, then one float atomic per score. Offsets of slices
// are int64, so the outputs may pass 2^31 cells.
// A warp's lanes cover several rows of the tile's K columns, so scores that
// share a bin (softmax negatives near 0) meet at one shared-memory address:
// 32 / K ways with 4-byte loads; with 16-byte loads each lane starts at
// another of its four columns, which spreads a warp's adds over all of them
// as well. A warp-aggregated add (__match_any_sync, one add per distinct
// cell) was slower on the H100 both on softmax rows (15.5 against 11.4 us at
// 1024 x 1000) and on all-equal scores (12.6 against 11.4 us), so the adds
// are plain. The 16-byte loads took the same time as 4-byte loads with dense
// labels (10.4 against 10.5 us) and 0.7 us less with class ids (9.8 against
// 10.5 us), the curve path's form, so both widths stay, chosen by alignment.
//
// The bin index is the reference's float32 arithmetic in its order:
// floor((x - lo) / span * B), clipped to [0, B - 1], with lo, span and B
// each a float32 the caller rounded once. The intrinsics keep the compiler
// from contracting or reordering it, and the division is IEEE (no
// reciprocal). A NaN score goes to bin 0 and is not clipped, as in the
// reference; +-inf clip into the edge bins and are counted; a subnormal score
// counts as zero, as XLA reads it.
#include <atomic>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "device_scope.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kGlobalThreads = 256;
constexpr int64_t kMaxGlobalBlocks = 2112;  // sixteen blocks per SM of the H100's 132
// the 227 KB a block can opt into, less 1 KB for the static warp sums
constexpr int kMaxDynamicShared = 232448 - 1024;

enum Mode { kStore = 0, kAdd = 1, kGlobal = 2 };
enum Labels { kDense = 0, kIds32 = 1, kIds64 = 2 };

struct Grid {
  float lo, hi, span, bins, last;  // last = B - 1
  int num_bins;
};

struct Job {
  const float* x;
  const void* labels;
  int n, c;
  Grid g;
  int k, rows_per_chunk, mode;
  float* pos;
  float* neg;
  float* clipped;
  // the batched form: the stack's slices, and the first of this launch's z group
  int64_t slices = 1;
  int64_t first_slice = 0;
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

// The class id of a row, as the int32 the dense one-hot is built from (an
// int64 id is cut to its low 32 bits, as its cast to int32 would).
template <int kLabels>
__device__ __forceinline__ int row_id(const void* labels, size_t row) {
  if constexpr (kLabels == kIds64) return static_cast<int>(static_cast<const int64_t*>(labels)[row]);
  return static_cast<const int*>(labels)[row];
}

// The block's sum of `count`; thread 0 holds it.
__device__ int block_sum(int count) {
  __shared__ int warp_sums[kMaxThreads / 32];
  for (int offset = 16; offset > 0; offset >>= 1) count += __shfl_down_sync(0xffffffffu, count, offset);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = count;
  __syncthreads();
  int total = 0;
  if (threadIdx.x == 0) {
    for (int w = 0; w < (blockDim.x + 31) / 32; ++w) total += warp_sums[w];
  }
  return total;
}

// One score into the block's counts.
__device__ __forceinline__ void count_score(unsigned int* counts, float score, bool positive, int column_cell,
                                            int neg_offset, const Grid& g, int& clipped) {
  const float v = flush_subnormal(score);
  atomicAdd(counts + (positive ? 0 : neg_offset) + column_cell + bin_of(v, g), 1u);
  clipped += out_of_range(v, g);
}

__device__ __forceinline__ float pick(const float4& v, int i) { return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w; }
__device__ __forceinline__ int pick(const int4& v, int i) { return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w; }

// `words` counts of a tile (16-byte aligned in shared memory) to the output as float32.
__device__ __forceinline__ void store_tile(const unsigned int* __restrict__ src, float* __restrict__ dst, int words) {
  int done = 0;
  if (reinterpret_cast<uintptr_t>(dst) % 16 == 0) {
    const int vectors = words / 4;
    for (int i = threadIdx.x; i < vectors; i += blockDim.x) {
      const uint4 n = reinterpret_cast<const uint4*>(src)[i];
      reinterpret_cast<float4*>(dst)[i] = make_float4(static_cast<float>(n.x), static_cast<float>(n.y),
                                                      static_cast<float>(n.z), static_cast<float>(n.w));
    }
    done = vectors * 4;
  }
  for (int i = done + threadIdx.x; i < words; i += blockDim.x) dst[i] = static_cast<float>(src[i]);
}

__device__ __forceinline__ void add_tile(const unsigned int* __restrict__ src, float* __restrict__ dst, int words) {
  for (int i = threadIdx.x; i < words; i += blockDim.x) {
    const unsigned int n = src[i];
    if (n) atomicAdd(dst + i, static_cast<float>(n));
  }
}

// The labels of slice `slice`: (n, c) dense int32 or (n,) ids.
template <int kLabels>
__device__ __forceinline__ const void* slice_labels(const void* labels, int64_t slice, int64_t n, int64_t c) {
  if constexpr (kLabels == kDense) return static_cast<const int*>(labels) + slice * n * c;
  if constexpr (kLabels == kIds64) return static_cast<const int64_t*>(labels) + slice * n;
  return static_cast<const int*>(labels) + slice * n;
}

// Block (tile, chunk, slice) = (blockIdx.x, blockIdx.y, first_slice +
// blockIdx.z): columns [k0, k0 + kw) of rows [row_begin, row_end) of the
// slice (the single form has one slice). V = 4 reads four columns per
// 16-byte load (the entry checks C % 4 == 0, K % 4 == 0 and the pointers'
// alignment, which every slice then keeps).
template <int kLabels, int V>
__global__ void __launch_bounds__(kMaxThreads) hist_tile_kernel(const Job job) {
  extern __shared__ __align__(16) unsigned int counts[];
  const Grid g = job.g;
  const int b = g.num_bins;
  const int c = job.c;
  const int64_t slice = job.first_slice + blockIdx.z;
  const int64_t slice_cells = static_cast<int64_t>(c) * b;
  float* const pos = job.pos + slice * slice_cells;
  float* const neg = job.neg + slice * slice_cells;
  float* const clipped_out = job.clipped + slice;
  const void* const labels = slice_labels<kLabels>(job.labels, slice, job.n, c);
  const int k0 = blockIdx.x * job.k;
  const int kw = min(job.k, c - k0);
  const int words = kw * b;
  const int neg_offset = (words + 3) & ~3;  // the neg tile starts 16-byte aligned
  const unsigned row_begin = blockIdx.y * static_cast<unsigned>(job.rows_per_chunk);
  const unsigned row_end = min(static_cast<unsigned>(job.n), row_begin + static_cast<unsigned>(job.rows_per_chunk));
  const float* __restrict__ x = job.x + slice * job.n * static_cast<int64_t>(c);
  const int* __restrict__ dense = static_cast<const int*>(labels);

  if (job.mode == kAdd) {
    // this block's share of the outputs' zeroes; no add lands before the grid sync below
    const int64_t cells = static_cast<int64_t>(c) * b;
    const int64_t first = (static_cast<int64_t>(blockIdx.y) * gridDim.x + blockIdx.x) * blockDim.x + threadIdx.x;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * gridDim.y * blockDim.x;
    for (int64_t i = first; i < cells; i += stride) {
      pos[i] = 0.0f;
      neg[i] = 0.0f;
    }
    if (first == 0) *clipped_out = 0.0f;
  }
  for (int i = threadIdx.x; i < neg_offset / 2; i += blockDim.x) {
    reinterpret_cast<uint4*>(counts)[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();

  // threads as (row lane, item of the row: V columns): consecutive threads
  // read consecutive addresses of one row, then the next row
  constexpr unsigned kRowsInFlight = 8 / V;  // rows a thread loads before it counts them: eight scores
  const int per_row = kw / V;
  const int tx = min(per_row, static_cast<int>(blockDim.x));
  const int q0 = threadIdx.x % tx;
  const unsigned r0 = threadIdx.x / tx;
  const unsigned rstep = blockDim.x / tx;
  int clipped = 0;
  if (r0 < rstep) {
    for (int q = q0; q < per_row; q += tx) {
      const int j = q * V;  // the item's first column within the tile
      for (unsigned row = row_begin + r0; row < row_end; row += kRowsInFlight * rstep) {
        if constexpr (V == 4) {
          float4 xs[kRowsInFlight];
          int4 ts[kRowsInFlight];
          int ids[kRowsInFlight];
#pragma unroll
          for (unsigned u = 0; u < kRowsInFlight; ++u) {
            const size_t r = row + u * rstep;
            if (r < row_end) {
              xs[u] = *reinterpret_cast<const float4*>(x + r * c + k0 + j);
              if constexpr (kLabels == kDense) {
                ts[u] = *reinterpret_cast<const int4*>(dense + r * c + k0 + j);
              } else {
                ids[u] = row_id<kLabels>(labels, r);
              }
            }
          }
          const int rot = r0 & 3;  // each row lane starts at another column
#pragma unroll
          for (unsigned u = 0; u < kRowsInFlight; ++u) {
            if (row + u * rstep < row_end) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int i = (e + rot) & 3;
                bool positive;
                if constexpr (kLabels == kDense) {
                  positive = pick(ts[u], i) == 1;
                } else {
                  positive = ids[u] == k0 + j + i;
                }
                count_score(counts, pick(xs[u], i), positive, (j + i) * b, neg_offset, g, clipped);
              }
            }
          }
        } else {
          float xs[kRowsInFlight];
          int ts[kRowsInFlight];  // the dense label, or the row's class id
#pragma unroll
          for (unsigned u = 0; u < kRowsInFlight; ++u) {
            const size_t r = row + u * rstep;
            if (r < row_end) {
              xs[u] = x[r * c + k0 + j];
              if constexpr (kLabels == kDense) {
                ts[u] = dense[r * c + k0 + j];
              } else {
                ts[u] = row_id<kLabels>(labels, r);
              }
            }
          }
#pragma unroll
          for (unsigned u = 0; u < kRowsInFlight; ++u) {
            if (row + u * rstep < row_end) {
              const bool positive = kLabels == kDense ? ts[u] == 1 : ts[u] == k0 + j;
              count_score(counts, xs[u], positive, j * b, neg_offset, g, clipped);
            }
          }
        }
      }
    }
  }
  __syncthreads();

  const int out_offset = k0 * b;
  if (job.mode == kStore) {
    store_tile(counts, pos + out_offset, words);
    store_tile(counts + neg_offset, neg + out_offset, words);
  } else {
    cooperative_groups::this_grid().sync();
    add_tile(counts, pos + out_offset, words);
    add_tile(counts + neg_offset, neg + out_offset, words);
  }
  const int total = block_sum(clipped);
  if (threadIdx.x == 0) {
    if (job.mode == kStore && gridDim.x == 1) {
      *clipped_out = static_cast<float>(total);
    } else if (total) {
      atomicAdd(clipped_out, static_cast<float>(total));
    }
  }
}

// One float atomic per score into zeroed outputs, for grids whose single
// column does not fit in shared memory. Slice blockIdx.y (and every
// gridDim.y-th after it) by a grid-stride loop over the x blocks.
template <int kLabels>
__global__ void hist_global_kernel(const Job job) {
  const Grid g = job.g;
  const int64_t c = job.c;
  const int64_t total = static_cast<int64_t>(job.n) * c;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t slice = blockIdx.y; slice < job.slices; slice += gridDim.y) {
    const float* __restrict__ x = job.x + slice * total;
    const void* const labels = slice_labels<kLabels>(job.labels, slice, job.n, c);
    float* const pos = job.pos + slice * c * g.num_bins;
    float* const neg = job.neg + slice * c * g.num_bins;
    int clipped = 0;
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < total; i += stride) {
      const float v = flush_subnormal(x[i]);
      const int64_t row = i / c;
      const int col = static_cast<int>(i - row * c);
      bool positive;
      if constexpr (kLabels == kDense) {
        positive = static_cast<const int*>(labels)[i] == 1;
      } else {
        positive = row_id<kLabels>(labels, row) == col;
      }
      atomicAdd((positive ? pos : neg) + col * g.num_bins + bin_of(v, g), 1.0f);
      clipped += out_of_range(v, g);
    }
    const int sum = block_sum(clipped);
    if (threadIdx.x == 0 && sum) atomicAdd(job.clipped + slice, static_cast<float>(sum));
    __syncthreads();  // the next slice's block_sum reuses the warp sums
  }
}

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

// Zeroes of the two (slices, c, b) outputs and the slices' clipped counts, on `stream`.
cudaError_t zero_outputs(const Job& job, cudaStream_t stream) {
  const size_t slices = static_cast<size_t>(job.slices);
  const size_t cells = slices * job.c * job.g.num_bins;
  cudaError_t err = cudaMemsetAsync(job.pos, 0, cells * sizeof(float), stream);
  if (err == cudaSuccess) err = cudaMemsetAsync(job.neg, 0, cells * sizeof(float), stream);
  if (err == cudaSuccess) err = cudaMemsetAsync(job.clipped, 0, slices * sizeof(float), stream);
  return err;
}

// The shared memory of a tile block, after the kernel opted into the most a
// block may use (above 48 KB only once its kernel opted in, per device).
template <int kLabels, int V>
cudaError_t tile_shared(const Job& job, int device, size_t* shared) {
  *shared = 2 * static_cast<size_t>((job.k * job.g.num_bins + 3) & ~3) * sizeof(unsigned int);
  if (*shared > static_cast<size_t>(kMaxDynamicShared)) return cudaErrorInvalidValue;
  static std::atomic<bool> opted_in[kMaxDevices];
  if (!opted_in[device].load(std::memory_order_acquire)) {
    const cudaError_t err = cudaFuncSetAttribute(hist_tile_kernel<kLabels, V>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxDynamicShared);
    if (err != cudaSuccess) return err;
    opted_in[device].store(true, std::memory_order_release);
  }
  return cudaSuccess;
}

template <int kLabels, int V>
cudaError_t launch_tiles(const Job& job, int tiles, int chunks, int threads, int device, cudaStream_t stream) {
  size_t shared;
  const cudaError_t opt = tile_shared<kLabels, V>(job, device, &shared);
  if (opt != cudaSuccess) return opt;
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(chunks));
  if (job.mode == kAdd) {
    void* args[] = {const_cast<Job*>(&job)};
    return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(hist_tile_kernel<kLabels, V>), grid,
                                       dim3(static_cast<unsigned>(threads)), args, shared, stream);
  }
  if (tiles > 1) {  // several blocks add to the clipped count; one block stores it
    const cudaError_t err = cudaMemsetAsync(job.clipped, 0, sizeof(float), stream);
    if (err != cudaSuccess) return err;
  }
  hist_tile_kernel<kLabels, V><<<grid, threads, shared, stream>>>(job);
  return cudaGetLastError();
}

constexpr int64_t kMaxGridZ = 65535;

// The batched store mode: grid (tiles, 1, slices) in groups of kMaxGridZ slices.
template <int kLabels, int V>
cudaError_t launch_batched_tiles(const Job& job, int tiles, int threads, int device, cudaStream_t stream) {
  size_t shared;
  cudaError_t err = tile_shared<kLabels, V>(job, device, &shared);
  if (err != cudaSuccess) return err;
  if (tiles > 1) {  // the tiles of a slice add to its clipped count; a slice of one tile stores it
    err = cudaMemsetAsync(job.clipped, 0, static_cast<size_t>(job.slices) * sizeof(float), stream);
    if (err != cudaSuccess) return err;
  }
  for (int64_t first = 0; first < job.slices; first += kMaxGridZ) {
    Job group = job;
    group.first_slice = first;
    const int64_t slices = job.slices - first < kMaxGridZ ? job.slices - first : kMaxGridZ;
    const dim3 grid(static_cast<unsigned>(tiles), 1u, static_cast<unsigned>(slices));
    hist_tile_kernel<kLabels, V><<<grid, threads, shared, stream>>>(group);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <int kLabels>
cudaError_t launch_batched(const Job& job, int tiles, int threads, int vec, int device, cudaStream_t stream) {
  if (job.mode == kGlobal) {
    const cudaError_t err = zero_outputs(job, stream);
    if (err != cudaSuccess) return err;
    const int64_t rows = job.slices < kMaxGridZ ? job.slices : kMaxGridZ;  // slices on y: at most 65535 too
    int64_t blocks = ceil_div(static_cast<int64_t>(job.n) * job.c, kGlobalThreads);
    const int64_t cap = kMaxGlobalBlocks / rows > 1 ? kMaxGlobalBlocks / rows : 1;
    if (blocks > cap) blocks = cap;
    if (blocks > 0) {
      const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(rows));
      hist_global_kernel<kLabels><<<grid, kGlobalThreads, 0, stream>>>(job);
    }
    return cudaGetLastError();
  }
  if (vec == 4) return launch_batched_tiles<kLabels, 4>(job, tiles, threads, device, stream);
  return launch_batched_tiles<kLabels, 1>(job, tiles, threads, device, stream);
}

template <int kLabels>
cudaError_t launch(const Job& job, int tiles, int chunks, int threads, int vec, int device, cudaStream_t stream) {
  if (job.mode == kGlobal) {
    const cudaError_t err = zero_outputs(job, stream);
    if (err != cudaSuccess) return err;
    int64_t blocks = ceil_div(static_cast<int64_t>(job.n) * job.c, kGlobalThreads);
    if (blocks > kMaxGlobalBlocks) blocks = kMaxGlobalBlocks;
    if (blocks > 0) hist_global_kernel<kLabels><<<static_cast<unsigned>(blocks), kGlobalThreads, 0, stream>>>(job);
    return cudaGetLastError();
  }
  if (vec == 4) return launch_tiles<kLabels, 4>(job, tiles, chunks, threads, device, stream);
  return launch_tiles<kLabels, 1>(job, tiles, chunks, threads, device, stream);
}

}  // namespace

// preds: (n, c) float32, contiguous. labels, by label_form: 0, (n, c) int32,
// contiguous, 1 = positive; 4 or 8, (n,) int32 or int64 class ids, positive
// where the id equals the column. pos, neg: (c, num_bins) float32, clipped:
// one float32, all uninitialised: the call writes every element. lo, hi and
// span = hi - lo are the caller's float32 roundings. The plan, chosen by the
// caller: mode 0 (store: chunks = 1), 1 (add: a cooperative launch, so its
// tiles * chunks blocks must be co-resident) or 2 (global); k columns per
// tile (2 * k * num_bins counts within the shared-memory budget), chunks of
// rows (at most 65535), threads per block (a multiple of 32, at most 1024),
// vec 4 (c % 4 == 0, k % 4 == 0, preds and dense labels 16-byte aligned) or
// 1. Everything goes to `stream` with `device` made current for the call.
// Returns the first CUDA error of the call (0 if none).
extern "C" int label_score_histograms_launch(const void* preds, const void* labels, int label_form, int n, int c,
                                             int num_bins, float lo, float hi, float span, int mode, int k,
                                             int chunks, int threads, int vec, void* pos, void* neg, void* clipped,
                                             int device, void* stream) {
  if (n < 0 || c < 0 || num_bins < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (mode != kGlobal && (k < 1 || chunks < 1 || chunks > 65535 || threads < 32 || threads > kMaxThreads ||
                          threads % 32 != 0 || (mode == kStore && chunks != 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (vec == 4) {
    const uintptr_t address =
        reinterpret_cast<uintptr_t>(preds) | (label_form == 0 ? reinterpret_cast<uintptr_t>(labels) : 0);
    if (c % 4 != 0 || k % 4 != 0 || address % 16 != 0) return static_cast<int>(cudaErrorMisalignedAddress);
  } else if (vec != 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (c == 0) return static_cast<int>(cudaMemsetAsync(clipped, 0, sizeof(float), st));
  Job job;
  job.x = static_cast<const float*>(preds);
  job.labels = labels;
  job.n = n;
  job.c = c;
  job.g = Grid{lo, hi, span, static_cast<float>(num_bins), static_cast<float>(num_bins - 1), num_bins};
  job.k = k;
  job.rows_per_chunk = mode == kGlobal ? n : static_cast<int>(ceil_div(n > 0 ? n : 1, chunks));
  job.mode = mode;
  job.pos = static_cast<float*>(pos);
  job.neg = static_cast<float*>(neg);
  job.clipped = static_cast<float*>(clipped);
  const int tiles = mode == kGlobal ? 0 : static_cast<int>(ceil_div(c, k));
  switch (label_form) {
    case 0: return static_cast<int>(launch<kDense>(job, tiles, chunks, threads, vec, device, st));
    case 4: return static_cast<int>(launch<kIds32>(job, tiles, chunks, threads, vec, device, st));
    case 8: return static_cast<int>(launch<kIds64>(job, tiles, chunks, threads, vec, device, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The batched form: preds (slices, n, c) float32, contiguous; labels, by
// label_form, (slices, n, c) int32 (0) or (slices, n) int32/int64 class ids
// (4/8), contiguous; pos, neg: (slices, c, num_bins) float32, clipped:
// (slices,) float32, all uninitialised: the call writes every element. Each
// slice is counted as label_score_histograms_launch counts one call. The
// plan, chosen by the caller: mode 0 (store, one block per (column tile,
// slice) walking all of the slice's rows; k columns per tile, 2 * k *
// num_bins counts within the shared-memory budget) or 2 (global); threads
// per block (a multiple of 32, at most 1024); vec 4 or 1, as for the single
// form. Returns the first CUDA error of the call (0 if none).
extern "C" int label_score_histograms_batched_launch(const void* preds, const void* labels, int label_form,
                                                     int64_t slices, int n, int c, int num_bins, float lo, float hi,
                                                     float span, int mode, int k, int threads, int vec, void* pos,
                                                     void* neg, void* clipped, int device, void* stream) {
  if (slices < 0 || n < 0 || c < 0 || num_bins < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (mode == kStore) {
    if (k < 1 || threads < 32 || threads > kMaxThreads || threads % 32 != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  } else if (mode != kGlobal) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (vec == 4) {
    const uintptr_t address =
        reinterpret_cast<uintptr_t>(preds) | (label_form == 0 ? reinterpret_cast<uintptr_t>(labels) : 0);
    if (c % 4 != 0 || k % 4 != 0 || address % 16 != 0) return static_cast<int>(cudaErrorMisalignedAddress);
  } else if (vec != 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (slices == 0) return 0;
  DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (c == 0) return static_cast<int>(cudaMemsetAsync(clipped, 0, static_cast<size_t>(slices) * sizeof(float), st));
  Job job;
  job.x = static_cast<const float*>(preds);
  job.labels = labels;
  job.n = n;
  job.c = c;
  job.g = Grid{lo, hi, span, static_cast<float>(num_bins), static_cast<float>(num_bins - 1), num_bins};
  job.k = k;
  job.rows_per_chunk = n;
  job.mode = mode;
  job.pos = static_cast<float*>(pos);
  job.neg = static_cast<float*>(neg);
  job.clipped = static_cast<float*>(clipped);
  job.slices = slices;
  const int tiles = mode == kGlobal ? 0 : static_cast<int>(ceil_div(c, k));
  switch (label_form) {
    case 0: return static_cast<int>(launch_batched<kDense>(job, tiles, threads, vec, device, st));
    case 4: return static_cast<int>(launch_batched<kIds32>(job, tiles, threads, vec, device, st));
    case 8: return static_cast<int>(launch_batched<kIds64>(job, tiles, threads, vec, device, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
