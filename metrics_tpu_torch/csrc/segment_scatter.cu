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
// each row vector is one atomic into the output in device memory, so neither
// cap exists: at the keyed path's S = 10,000 tenants and D = 40 the 1.6 MB
// output stays in the 50 MB L2 cache.
//
// Bound: bytes. Each row element and id is read once and each output
// element written once: at R = 4096, D = 40, S = 10,000 that is 2.33 MB,
// 0.70 us at the H100's 3.35 TB/s. At this size a call costs its launches
// and the host's work around them, not bandwidth, so the design cuts both:
//
// - One C entry per call, one launch: the entry makes the caller's device
//   current (and restores the old one) and launches one cooperative kernel
//   on the caller's stream. Its blocks fill the outputs, which the wrapper
//   allocated uninitialised (zeros for sums and counts, -inf for max and
//   +inf for min, the identities that empty segments keep), sync the grid,
//   then scatter. Against a fill kernel followed by the scatter kernel, the
//   one launch cost 3-5 us less host time per call on the H100, for 0.3 us
//   more device time at D = 40. The grid is one block per SM until a thread
//   would take more than eight items; a grid of every co-resident block
//   spent 2.4 us more device time on the sync at the keyed path's sizes.
// - Sums (B3) read rows as 16-byte float4 vectors where D % 4 == 0 and the
//   rows and sums pointers are 16-byte aligned, else as float2 (D even,
//   8-byte aligned), else as scalars (the wrapper picks the width), and add
//   each vector with one of Hopper's vector float atomics (atomicAdd on
//   float4/float2, `red.global.add.v4.f32` on sm_90, global memory only): at
//   D = 40, 10 atomics per row instead of 40. A vector whose lanes are all
//   zero is skipped (adding +-0.0 to a sum that starts at +0.0 never changes
//   it, and a slot never becomes -0.0). One thread per vector (flat
//   grid-stride loop over R * D / V), so a warp's loads stay coalesced at
//   any D (1, 6 or 40 on the keyed path); the row's id is loaded once per
//   vector and the thread of the row's first vector adds the row's count.
//   Index math is 32-bit (the wrapper keeps R * D below 2^31), but for the
//   output offset id * D, taken in 64 bits.
// - Extrema (B4): a 32-bit atomicCAS loop per element that stores x where x
//   beats the slot in the order of XLA's segment_max/segment_min: NaN beats
//   everything (a NaN row makes its segment NaN), and +0.0 is above -0.0
//   (max of {-0.0, +0.0} is +0.0, min is -0.0, in any row order). That order
//   is total, so the result does not depend on the order of the atomics.
//   The slot is read first and the CAS skipped when x cannot win; a stale
//   read only costs a retry, since a slot only ever moves up (max) or down
//   (min). The ordered-int atomicMax trick would not propagate NaN this way.
//   There is no vector CAS, so B4 stays scalar.
//
// An id < 0 or >= S is dropped from both outputs, as the TPU kernels drop it.
// The order of the float additions changes from run to run, so float sums
// agree with a sequential sum to rounding only; integer-valued rows whose
// per-segment sums stay below 2^24 are exact.
#include <atomic>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>
#include <limits>

#include "device_scope.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItemsPerThread = 8;

enum Op { kAdd = 0, kMax = 1, kMin = 2 };

// --- the scatters, one item per thread of a grid-stride loop -----------------

// Item indices are unsigned: below 2^31 (the wrapper's limit), so that
// i + stride cannot wrap.
template <typename Index, int V>
__device__ __forceinline__ void add_items(const float* __restrict__ rows, const Index* __restrict__ ids, int r, int d,
                                          int s, float* __restrict__ sums, int* __restrict__ counts, unsigned first,
                                          unsigned stride) {
  const unsigned per_row = d > 0 ? d / V : 1;
  const unsigned total = static_cast<unsigned>(r) * per_row;
  for (unsigned i = first; i < total; i += stride) {
    const unsigned row = i / per_row;
    const unsigned v = i - row * per_row;
    const int64_t id = static_cast<int64_t>(ids[row]);
    if (id < 0 || id >= s) continue;
    if (v == 0) atomicAdd(counts + id, 1);
    if (d == 0) continue;
    float* slot = sums + id * d + v * V;
    if constexpr (V == 4) {
      const float4 x = reinterpret_cast<const float4*>(rows)[i];
      if (x.x != 0.0f || x.y != 0.0f || x.z != 0.0f || x.w != 0.0f) atomicAdd(reinterpret_cast<float4*>(slot), x);
    } else if constexpr (V == 2) {
      const float2 x = reinterpret_cast<const float2*>(rows)[i];
      if (x.x != 0.0f || x.y != 0.0f) atomicAdd(reinterpret_cast<float2*>(slot), x);
    } else {
      const float x = rows[i];
      if (x != 0.0f) atomicAdd(slot, x);
    }
  }
}

__device__ __forceinline__ bool negative(float v) { return (__float_as_uint(v) >> 31) != 0u; }

// True where x takes the place of old in a max (kMax) or a min. (v != v is
// true for NaN only; nvcc keeps it without --use_fast_math.)
template <bool kIsMax>
__device__ __forceinline__ bool beats(float x, float old) {
  if (old != old) return false;
  if (x != x) return true;
  if (kIsMax) return x > old || (x == old && negative(old) && !negative(x));
  return x < old || (x == old && !negative(old) && negative(x));
}

template <typename Index, bool kIsMax>
__device__ __forceinline__ void extremal_items(const float* __restrict__ rows, const Index* __restrict__ ids, int r,
                                               int d, int s, float* __restrict__ out, int* __restrict__ counts,
                                               unsigned first, unsigned stride) {
  const unsigned width = d > 0 ? d : 1;
  const unsigned total = static_cast<unsigned>(r) * width;
  for (unsigned i = first; i < total; i += stride) {
    const unsigned row = i / width;
    const unsigned f = i - row * width;
    const int64_t id = static_cast<int64_t>(ids[row]);
    if (id < 0 || id >= s) continue;
    if (f == 0) atomicAdd(counts + id, 1);
    if (d == 0) continue;
    const float x = rows[i];
    unsigned int* slot = reinterpret_cast<unsigned int*>(out + id * d + f);
    unsigned int old = *reinterpret_cast<volatile unsigned int*>(slot);
    while (beats<kIsMax>(x, __uint_as_float(old))) {
      const unsigned int assumed = old;
      old = atomicCAS(slot, assumed, __float_as_uint(x));
      if (old == assumed) break;
    }
  }
}

template <typename Index, int V, int kOp>
__device__ __forceinline__ void scatter_items(const float* rows, const Index* ids, int r, int d, int s, float* out,
                                              int* counts, unsigned first, unsigned stride) {
  if constexpr (kOp == kAdd) {
    add_items<Index, V>(rows, ids, r, d, s, out, counts, first, stride);
  } else {
    extremal_items<Index, kOp == kMax>(rows, ids, r, d, s, out, counts, first, stride);
  }
}

// out and counts are 16-byte aligned (the entry checks), so the body of each
// goes out as 16-byte stores and the last n % 4 (s % 4) elements one by one.
__device__ __forceinline__ void init_items(float* __restrict__ out, int64_t n, float value, int* __restrict__ counts,
                                           int s, int64_t first, int64_t stride) {
  const int64_t n4 = n / 4;
  const float4 v4 = make_float4(value, value, value, value);
  for (int64_t i = first; i < n4; i += stride) reinterpret_cast<float4*>(out)[i] = v4;
  for (int64_t i = n4 * 4 + first; i < n; i += stride) out[i] = value;
  const int s4 = s / 4;
  for (int64_t i = first; i < s4; i += stride) reinterpret_cast<int4*>(counts)[i] = make_int4(0, 0, 0, 0);
  for (int64_t i = s4 * 4 + first; i < s; i += stride) counts[i] = 0;
}

// --- the kernel: fill, sync the grid, scatter -----------------------------------

// One cooperative launch per call: every block fills its share of the
// outputs, the grid syncs (no atomic may land before every slot holds its
// identity), then every block scatters its share of the rows.
template <typename Index, int V, int kOp>
__global__ void __launch_bounds__(kThreads) scatter_kernel(const float* rows, const Index* ids, int r, int d, int s,
                                                           float* out, int* counts, float value) {
  const unsigned first = blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned stride = gridDim.x * blockDim.x;
  init_items(out, static_cast<int64_t>(s) * d, value, counts, s, first, stride);
  cooperative_groups::this_grid().sync();
  scatter_items<Index, V, kOp>(rows, ids, r, d, s, out, counts, first, stride);
}

// The SMs of `device` and the most blocks of this kernel a cooperative launch
// can hold there (all co-resident), asked once per device.
template <typename Index, int V, int kOp>
cudaError_t grid_limits(int device, int* sms, int* max_blocks) {
  static std::atomic<int> cached_sms[kMaxDevices];
  static std::atomic<int> cached_max[kMaxDevices];
  *sms = cached_sms[device].load(std::memory_order_acquire);
  *max_blocks = cached_max[device].load(std::memory_order_relaxed);
  if (*sms > 0) return cudaSuccess;
  int per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, scatter_kernel<Index, V, kOp>, kThreads, 0);
  }
  if (err != cudaSuccess) return err;
  *max_blocks = per_sm * *sms;
  cached_max[device].store(*max_blocks, std::memory_order_relaxed);
  cached_sms[device].store(*sms, std::memory_order_release);
  return cudaSuccess;
}

template <typename Index, int V, int kOp>
int launch(const void* rows_, const void* ids_, int r, int d, int s, void* out_, void* counts_, float value,
           int device, cudaStream_t stream) {
  const float* rows = static_cast<const float*>(rows_);
  const Index* ids = static_cast<const Index*>(ids_);
  float* out = static_cast<float*>(out_);
  int* counts = static_cast<int*>(counts_);
  int sms = 0, max_blocks = 0;
  cudaError_t err = grid_limits<Index, V, kOp>(device, &sms, &max_blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  // One block per SM until each thread would take more than kItemsPerThread
  // items (row vectors to scatter, or 16-byte stores of the fill); then as
  // many as the work asks for, up to every co-resident block.
  const int64_t items = static_cast<int64_t>(r) * (d > 0 ? d / V : 1);
  const int64_t stores = static_cast<int64_t>(s) * d / 4 + s / 4;
  const int64_t work = items > stores ? items : stores;
  int64_t grid = (work + kThreads * kItemsPerThread - 1) / (kThreads * kItemsPerThread);
  if (grid < sms) grid = sms;
  if (grid > max_blocks) grid = max_blocks;
  void* args[] = {&rows, &ids, &r, &d, &s, &out, &counts, &value};
  return static_cast<int>(cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(scatter_kernel<Index, V, kOp>),
                                                      static_cast<unsigned>(grid), kThreads, args, 0, stream));
}

template <typename Index>
int dispatch(const void* rows, const void* ids, int r, int d, int s, int op, int vec, void* out, void* counts,
             int device, cudaStream_t stream) {
  constexpr float inf = std::numeric_limits<float>::infinity();
  switch (op * 8 + vec) {
    case kAdd * 8 + 4: return launch<Index, 4, kAdd>(rows, ids, r, d, s, out, counts, 0.0f, device, stream);
    case kAdd * 8 + 2: return launch<Index, 2, kAdd>(rows, ids, r, d, s, out, counts, 0.0f, device, stream);
    case kAdd * 8 + 1: return launch<Index, 1, kAdd>(rows, ids, r, d, s, out, counts, 0.0f, device, stream);
    case kMax * 8 + 1: return launch<Index, 1, kMax>(rows, ids, r, d, s, out, counts, -inf, device, stream);
    case kMin * 8 + 1: return launch<Index, 1, kMin>(rows, ids, r, d, s, out, counts, inf, device, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// rows: (r, d) float32, contiguous, r * max(d, 1) < 2^31. ids: (r,) int32
// (index_bytes=4) or int64 (index_bytes=8). op: 0 sums (B3), 1 max, 2 min
// (B4). vec: floats per vector access, 4, 2 or 1 (1 for B4); d % vec == 0
// and rows and out aligned to 4 * vec bytes. out: (s, d) float32 and
// counts: (s,) int32, both uninitialised and 16-byte aligned: the one
// cooperative launch fills them (0, -inf or +inf; counts 0) and scatters,
// on `stream`, with `device` made current for the call. Returns the first
// CUDA error of the call (0 if none); s <= 0 does nothing.
extern "C" int segment_scatter_launch(const void* rows, const void* ids, int r, int d, int s, int index_bytes, int op,
                                      int vec, void* out, void* counts, int device, void* stream) {
  if (s <= 0) return 0;
  if ((reinterpret_cast<uintptr_t>(out) | reinterpret_cast<uintptr_t>(counts)) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (index_bytes == 8) return dispatch<int64_t>(rows, ids, r, d, s, op, vec, out, counts, device, st);
  if (index_bytes == 4) return dispatch<int32_t>(rows, ids, r, d, s, op, vec, out, counts, device, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
