// Segment scatter: per-segment sums (B3) and per-segment max/min (B4) of rows
// routed by segment id, plus each segment's count of valid rows.
//
// Replaces the Pallas kernels of metrics_tpu/kernels/segment_scatter.py:
// `_scatter_kernel` (entry `segment_scatter_add_pallas`) and `_extremal_kernel`
// (entry `_segment_scatter_extremal_pallas`, behind `segment_scatter_max_pallas`
// and `segment_scatter_min_pallas`). There the TPU contracts a one-hot of the
// ids with the rows on its matrix unit (sums) or masks a (TILE, S) tile per
// feature and reduces it (extrema), with the whole (S, D) output resident in
// VMEM, which caps S at 1024 and D at 511 (sums) or 16 (extrema). On Hopper
// each row element is one atomic into the output in device memory, so
// neither cap exists: at the keyed path's S = 10,000 tenants and D = 40 the
// 1.6 MB output stays in the 50 MB L2 cache.
//
// Bound: bytes. Each row element and id is read once and each output
// element written once: at R = 4096, D = 40, S = 10,000 that is 2.33 MB,
// 0.70 us at the H100's 3.35 TB/s; a few microseconds of launch cost
// dominate at this size.
//
// Design: one thread per row element (flat grid-stride loop over R * D), so
// a warp's loads are coalesced whatever D is (D is 1, 6 or 40 on the keyed
// path; a warp per row would leave most lanes idle at D = 1 or 6). The
// thread of feature 0 also adds the row to its segment's count. An id < 0 or
// >= S is dropped from both outputs, as the TPU kernels drop it. The caller
// fills the outputs: zeros for sums and counts, -inf (max) or +inf (min) for
// extrema, the identities that empty segments keep.
//
// Sums: atomicAdd in f32, skipping zeros (adding +-0.0 to a sum that starts
// at +0.0 never changes it). The order of the additions changes from run to
// run, so float sums agree with a sequential sum to rounding only;
// integer-valued rows whose per-segment sums stay below 2^24 are exact.
//
// Extrema: a 32-bit atomicCAS loop that stores x where x beats the slot in
// the order of XLA's segment_max/segment_min: NaN beats everything (a NaN
// row makes its segment NaN), and +0.0 is above -0.0 (max of {-0.0, +0.0} is
// +0.0, min is -0.0, in any row order). That order is total, so the result
// does not depend on the order of the atomics. The slot is read first and
// the CAS skipped when x cannot win; a stale read only costs a retry, since
// a slot only ever moves up (max) or down (min). The ordered-int atomicMax
// trick would not propagate NaN this way.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 2112;  // sixteen blocks per SM of the H100's 132

template <typename Index>
__global__ void segment_add_kernel(const float* __restrict__ rows, const Index* __restrict__ ids, int64_t r,
                                   int64_t d, int64_t s, float* __restrict__ sums, int* __restrict__ counts) {
  const int64_t width = d > 0 ? d : 1;
  const int64_t total = r * width;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < total; i += stride) {
    const int64_t row = i / width;
    const int64_t f = i - row * width;
    const int64_t id = static_cast<int64_t>(ids[row]);
    if (id < 0 || id >= s) continue;
    if (f < d) {
      const float x = rows[i];
      if (x != 0.0f) atomicAdd(sums + id * d + f, x);
    }
    if (f == 0) atomicAdd(counts + id, 1);
  }
}

__device__ __forceinline__ bool negative(float v) { return (__float_as_uint(v) >> 31) != 0u; }

// True where x takes the place of old in a max (kMax) or a min. (v != v is
// true for NaN only; nvcc keeps it without --use_fast_math.)
template <bool kMax>
__device__ __forceinline__ bool beats(float x, float old) {
  if (old != old) return false;
  if (x != x) return true;
  if (kMax) return x > old || (x == old && negative(old) && !negative(x));
  return x < old || (x == old && !negative(old) && negative(x));
}

template <typename Index, bool kMax>
__global__ void segment_extremal_kernel(const float* __restrict__ rows, const Index* __restrict__ ids, int64_t r,
                                        int64_t d, int64_t s, float* __restrict__ out, int* __restrict__ counts) {
  const int64_t width = d > 0 ? d : 1;
  const int64_t total = r * width;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < total; i += stride) {
    const int64_t row = i / width;
    const int64_t f = i - row * width;
    const int64_t id = static_cast<int64_t>(ids[row]);
    if (id < 0 || id >= s) continue;
    if (f < d) {
      const float x = rows[i];
      unsigned int* slot = reinterpret_cast<unsigned int*>(out + id * d + f);
      unsigned int old = *reinterpret_cast<volatile unsigned int*>(slot);
      while (beats<kMax>(x, __uint_as_float(old))) {
        const unsigned int assumed = old;
        old = atomicCAS(slot, assumed, __float_as_uint(x));
        if (old == assumed) break;
      }
    }
    if (f == 0) atomicAdd(counts + id, 1);
  }
}

unsigned blocks_for(int64_t r, int64_t d) {
  const int64_t total = r * (d > 0 ? d : 1);
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return static_cast<unsigned>(blocks);
}

template <typename Index>
int launch_add(const void* rows, const void* ids, int64_t r, int64_t d, int64_t s, void* sums, void* counts,
               cudaStream_t stream) {
  segment_add_kernel<Index><<<blocks_for(r, d), kThreads, 0, stream>>>(
      static_cast<const float*>(rows), static_cast<const Index*>(ids), r, d, s, static_cast<float*>(sums),
      static_cast<int*>(counts));
  return static_cast<int>(cudaGetLastError());
}

template <typename Index>
int launch_extremal(const void* rows, const void* ids, int64_t r, int64_t d, int64_t s, int is_max, void* out,
                    void* counts, cudaStream_t stream) {
  const float* x = static_cast<const float*>(rows);
  const Index* i = static_cast<const Index*>(ids);
  float* o = static_cast<float*>(out);
  int* c = static_cast<int*>(counts);
  if (is_max) {
    segment_extremal_kernel<Index, true><<<blocks_for(r, d), kThreads, 0, stream>>>(x, i, r, d, s, o, c);
  } else {
    segment_extremal_kernel<Index, false><<<blocks_for(r, d), kThreads, 0, stream>>>(x, i, r, d, s, o, c);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// rows: (r, d) float32, contiguous. ids: (r,) int32 (index_bytes=4) or int64
// (index_bytes=8). sums: (s, d) float32, zero-filled. counts: (s,) int32,
// zero-filled. Returns cudaGetLastError() after the launch.
extern "C" int segment_scatter_add_launch(const void* rows, const void* ids, int64_t r, int64_t d, int64_t s,
                                          int index_bytes, void* sums, void* counts, void* stream) {
  if (r <= 0 || s <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (index_bytes == 8) return launch_add<int64_t>(rows, ids, r, d, s, sums, counts, st);
  if (index_bytes == 4) return launch_add<int32_t>(rows, ids, r, d, s, sums, counts, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// As segment_scatter_add_launch, with out: (s, d) float32 filled with -inf
// (is_max=1) or +inf (is_max=0).
extern "C" int segment_scatter_extremal_launch(const void* rows, const void* ids, int64_t r, int64_t d, int64_t s,
                                               int index_bytes, int is_max, void* out, void* counts, void* stream) {
  if (r <= 0 || s <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (index_bytes == 8) return launch_extremal<int64_t>(rows, ids, r, d, s, is_max, out, counts, st);
  if (index_bytes == 4) return launch_extremal<int32_t>(rows, ids, r, d, s, is_max, out, counts, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
