// Segment scatter: per-segment sums (B3) and per-segment max/min (B4) of rows
// routed by segment id, plus each segment's count of valid rows; and the merge,
// which routes every int32/float32 leaf of a keyed update into its new stacked
// state in one launch.
//
// B3 and B4 replace the Pallas kernels of metrics_tpu/kernels/segment_scatter.py:
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
// The merge (`segment_merge_launch`) replaces no TPU kernel: it is the keyed
// update's whole per-leaf chain (XLA fuses the JAX package's segment_sum and
// segment_max of every leaf, their `state + delta` and masked `maximum` into
// its program). Launched per leaf, B3 and B4 left the host a chain of about
// 60 small launches a keyed update of two bundles: the subtraction of each
// sum leaf's default, the casts to and from float32, the `cat` of the
// columns, B3, the slices and adds back into the state, B4, its `counts > 0`
// mask, `maximum` and `where`, and the invalid-id sum. The host's dispatch of
// that chain, not the device, bounded the update. The merge does it all in
// one cooperative launch over a table of leaves passed by value (a
// `__grid_constant__` parameter, so nothing is copied to the device per
// call), each leaf int32 or float32, "sum", "max" or "min":
//
// 1. Fill: each leaf's output takes its state (int32 sums, every extremum)
//    or zeros (float32 sums); the counts and the invalid count take zeros.
// 2. Sync the grid, then scatter over one flat item space: an item per row
//    reads its id once and adds the row to its segment's count or, for an id
//    < 0 or >= S, to the dropped rows (summed in the warp, one atomic a
//    warp); then an item per (leaf, row, vector) of V = 4, 2 or 1 elements,
//    vectors as B3 takes them, where the leaf's D, row stride and pointers
//    allow. Rows are read in place at any row stride: 0 for a broadcast
//    default, 4 * D for B1's batched output. A sum adds `row - default` per
//    element where it is not zero: int32 by integer atomics (exact at any
//    size, wrapping as int32 adds do), float32 by B3's vector atomics. An
//    extremum picks by B4's ordered CAS (int32 by atomicMax/atomicMin) into
//    the output that already holds the state, so a segment without rows
//    keeps its state and a NaN state stays NaN: no mask, no `where`.
// 3. Only with a float32 sum leaf: sync the grid again and add the state to
//    the batch's sum, `state + sum` as the per-leaf route took it, so a large
//    accumulated state does not round each of the batch's adds.
//
// An id < 0 or >= S is dropped from every output, as the TPU kernels drop it.
// The order of the float additions changes from run to run, so float sums
// agree with a sequential sum to rounding only; B3's integer-valued rows
// whose per-segment sums stay below 2^24 are exact, and the merge's int32
// sums are exact at any size.
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

// Stores x into *slot where x beats the slot's value (B4's CAS loop; the merge's
// float extrema too).
template <bool kIsMax>
__device__ __forceinline__ void pick_slot(unsigned int* slot, float x) {
  unsigned int old = *reinterpret_cast<volatile unsigned int*>(slot);
  while (beats<kIsMax>(x, __uint_as_float(old))) {
    const unsigned int assumed = old;
    old = atomicCAS(slot, assumed, __float_as_uint(x));
    if (old == assumed) break;
  }
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
    pick_slot<kIsMax>(reinterpret_cast<unsigned int*>(out + id * d + f), rows[i]);
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

// The grid of a cooperative launch of kKernel on `device` for `work` items
// (row vectors to scatter, or 16-byte stores of the fill): one block per SM
// until each thread would take more than kItemsPerThread of them, then as
// many as the work asks for, up to every co-resident block. The SMs and the
// co-resident blocks are asked once per device and kernel.
template <auto kKernel>
cudaError_t cooperative_grid(int device, int64_t work, unsigned* grid) {
  static std::atomic<int> cached_sms[kMaxDevices];
  static std::atomic<int> cached_max[kMaxDevices];
  int sms = cached_sms[device].load(std::memory_order_acquire);
  int max_blocks = cached_max[device].load(std::memory_order_relaxed);
  if (sms <= 0) {
    int per_sm = 0;
    cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kKernel, kThreads, 0);
    if (err != cudaSuccess) return err;
    max_blocks = per_sm * sms;
    cached_max[device].store(max_blocks, std::memory_order_relaxed);
    cached_sms[device].store(sms, std::memory_order_release);
  }
  int64_t blocks = (work + kThreads * kItemsPerThread - 1) / (kThreads * kItemsPerThread);
  if (blocks < sms) blocks = sms;
  if (blocks > max_blocks) blocks = max_blocks;
  *grid = static_cast<unsigned>(blocks);
  return cudaSuccess;
}

template <typename Index, int V, int kOp>
int launch(const void* rows_, const void* ids_, int r, int d, int s, void* out_, void* counts_, float value,
           int device, cudaStream_t stream) {
  const float* rows = static_cast<const float*>(rows_);
  const Index* ids = static_cast<const Index*>(ids_);
  float* out = static_cast<float*>(out_);
  int* counts = static_cast<int*>(counts_);
  const int64_t items = static_cast<int64_t>(r) * (d > 0 ? d / V : 1);
  const int64_t stores = static_cast<int64_t>(s) * d / 4 + s / 4;
  unsigned grid = 0;
  const cudaError_t err = cooperative_grid<scatter_kernel<Index, V, kOp>>(device, items > stores ? items : stores,
                                                                         &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&rows, &ids, &r, &d, &s, &out, &counts, &value};
  return static_cast<int>(cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(scatter_kernel<Index, V, kOp>),
                                                      grid, kThreads, args, 0, stream));
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

// --- the merge: every int32/float32 leaf of a keyed update in one launch -------

// Leaves a launch takes; the entry launches once per chunk of this many (a
// table of 64 leaves is 3.6 KB of the 4 KB a kernel's parameters may hold).
constexpr int kMaxMergeLeaves = 64;
// The fields of a leaf in the caller's table, each an int64: rows, row stride
// (elements), state, out, default, D, V, kind.
constexpr int kMergeFields = 8;

// A leaf's kind: its op * 2 + 1 where it is float32 (op 0 sum, 1 max, 2 min).
enum MergeKind { kSumInt = 0, kSumFloat = 1, kMaxInt = 2, kMaxFloat = 3, kMinInt = 4, kMinFloat = 5 };

struct MergeLeaf {
  const void* rows;      // row i's D elements at rows + i * row_stride
  const void* state;     // (S, D), contiguous
  void* out;             // (S, D), contiguous, uninitialised
  const void* dflt;      // (D,), contiguous: subtracted from a sum's rows
  long long row_stride;  // in elements; 0 where every row is the same
  int d;                 // elements a row
  int vec;               // elements a vector access: 4, 2 or 1, d % vec == 0
  int kind;              // MergeKind
  unsigned first;        // the leaf's first item in the flat item space
};

struct MergeTable {
  MergeLeaf leaf[kMaxMergeLeaves];
  int n;            // leaves
  unsigned items;   // R count items, then every leaf's R * D / V
  int float_sums;   // a float32 sum leaf is here: phase 3 runs
};

template <int V>
__device__ __forceinline__ void load_words(const unsigned int* p, unsigned int (&w)[V]) {
  if constexpr (V == 4) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    w[0] = t.x;
    w[1] = t.y;
    w[2] = t.z;
    w[3] = t.w;
  } else if constexpr (V == 2) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    w[0] = t.x;
    w[1] = t.y;
  } else {
    w[0] = *p;
  }
}

// Vector v of row `row` of one leaf into segment id's slots of its output.
template <int V>
__device__ __forceinline__ void merge_vector(const MergeLeaf& leaf, unsigned row, int64_t id, unsigned v) {
  const unsigned e = v * V;
  unsigned int x[V];
  load_words<V>(static_cast<const unsigned int*>(leaf.rows) + row * leaf.row_stride + e, x);
  unsigned int* slot = static_cast<unsigned int*>(leaf.out) + id * leaf.d + e;
  if (leaf.kind == kSumInt || leaf.kind == kSumFloat) {
    unsigned int def[V];
    load_words<V>(static_cast<const unsigned int*>(leaf.dflt) + e, def);
    if (leaf.kind == kSumInt) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const int delta = static_cast<int>(x[k] - def[k]);  // int32's wrapping subtraction
        if (delta != 0) atomicAdd(reinterpret_cast<int*>(slot) + k, delta);
      }
      return;
    }
    float f[V];
    bool any = false;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      f[k] = __uint_as_float(x[k]) - __uint_as_float(def[k]);
      any |= f[k] != 0.0f;
    }
    if (!any) return;
    float* sum = reinterpret_cast<float*>(slot);
    if constexpr (V == 4) {
      atomicAdd(reinterpret_cast<float4*>(sum), make_float4(f[0], f[1], f[2], f[3]));
    } else if constexpr (V == 2) {
      atomicAdd(reinterpret_cast<float2*>(sum), make_float2(f[0], f[1]));
    } else {
      atomicAdd(sum, f[0]);
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < V; ++k) {
    int* islot = reinterpret_cast<int*>(slot) + k;
    const int xi = static_cast<int>(x[k]);
    switch (leaf.kind) {
      case kMaxInt:
        if (xi > *reinterpret_cast<volatile int*>(islot)) atomicMax(islot, xi);
        break;
      case kMinInt:
        if (xi < *reinterpret_cast<volatile int*>(islot)) atomicMin(islot, xi);
        break;
      case kMaxFloat: pick_slot<true>(slot + k, __uint_as_float(x[k])); break;
      default: pick_slot<false>(slot + k, __uint_as_float(x[k])); break;
    }
  }
}

// Phase 1 for one leaf: out = state, or zeros for a float32 sum; 16-byte
// stores where both pointers allow, the rest one by one.
__device__ __forceinline__ void fill_leaf(const MergeLeaf& leaf, int64_t n, int64_t first, int64_t stride) {
  const bool zero = leaf.kind == kSumFloat;
  const unsigned int* in = static_cast<const unsigned int*>(leaf.state);
  unsigned int* out = static_cast<unsigned int*>(leaf.out);
  int64_t done = 0;
  if (((reinterpret_cast<uintptr_t>(in) | reinterpret_cast<uintptr_t>(out)) & 15) == 0) {
    const int64_t n4 = n / 4;
    for (int64_t i = first; i < n4; i += stride) {
      reinterpret_cast<uint4*>(out)[i] = zero ? make_uint4(0u, 0u, 0u, 0u) : reinterpret_cast<const uint4*>(in)[i];
    }
    done = n4 * 4;
  }
  for (int64_t i = done + first; i < n; i += stride) out[i] = zero ? 0u : in[i];
}

// Phase 3 for one float32 sum leaf: out = state + out.
__device__ __forceinline__ void add_state(const MergeLeaf& leaf, int64_t n, int64_t first, int64_t stride) {
  const float* in = static_cast<const float*>(leaf.state);
  float* out = static_cast<float*>(leaf.out);
  int64_t done = 0;
  if (((reinterpret_cast<uintptr_t>(in) | reinterpret_cast<uintptr_t>(out)) & 15) == 0) {
    const int64_t n4 = n / 4;
    for (int64_t i = first; i < n4; i += stride) {
      const float4 a = reinterpret_cast<const float4*>(in)[i];
      float4 b = reinterpret_cast<float4*>(out)[i];
      b.x = a.x + b.x;
      b.y = a.y + b.y;
      b.z = a.z + b.z;
      b.w = a.w + b.w;
      reinterpret_cast<float4*>(out)[i] = b;
    }
    done = n4 * 4;
  }
  for (int64_t i = done + first; i < n; i += stride) out[i] = in[i] + out[i];
}

// One cooperative launch: fill, sync the grid, scatter every row of every
// leaf, and, with a float32 sum leaf, sync again and add the states.
template <typename Index>
__global__ void __launch_bounds__(kThreads) merge_kernel(const __grid_constant__ MergeTable table,
                                                         const Index* __restrict__ ids, int r, int s,
                                                         int* __restrict__ counts, int* __restrict__ invalid) {
  const unsigned first = blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned stride = gridDim.x * blockDim.x;
  for (int l = 0; l < table.n; ++l) {
    fill_leaf(table.leaf[l], static_cast<int64_t>(s) * table.leaf[l].d, first, stride);
  }
  const int64_t s4 = s / 4;  // counts is 16-byte aligned (the entry checks)
  for (int64_t i = first; i < s4; i += stride) reinterpret_cast<int4*>(counts)[i] = make_int4(0, 0, 0, 0);
  for (int64_t i = s4 * 4 + first; i < s; i += stride) counts[i] = 0;
  if (first == 0) *invalid = 0;
  cooperative_groups::this_grid().sync();

  unsigned dropped = 0;
  int l = -1;
  unsigned next = table.n > 0 ? table.leaf[0].first : table.items;
  unsigned per_row = 1;
  MergeLeaf leaf = {};
  for (unsigned i = first; i < table.items; i += stride) {
    if (i < static_cast<unsigned>(r)) {
      const int64_t id = static_cast<int64_t>(ids[i]);
      if (id < 0 || id >= s) {
        ++dropped;
      } else {
        atomicAdd(counts + id, 1);
      }
      continue;
    }
    while (i >= next) {  // i only grows: the thread's leaf only moves on
      leaf = table.leaf[++l];
      per_row = static_cast<unsigned>(leaf.d / leaf.vec);
      next = l + 1 < table.n ? table.leaf[l + 1].first : table.items;
    }
    const unsigned j = i - leaf.first;
    const unsigned row = j / per_row;
    const int64_t id = static_cast<int64_t>(ids[row]);
    if (id < 0 || id >= s) continue;
    const unsigned v = j - row * per_row;
    if (leaf.vec == 4) {
      merge_vector<4>(leaf, row, id, v);
    } else if (leaf.vec == 2) {
      merge_vector<2>(leaf, row, id, v);
    } else {
      merge_vector<1>(leaf, row, id, v);
    }
  }
  dropped = __reduce_add_sync(0xffffffffu, dropped);
  if ((threadIdx.x & 31) == 0 && dropped != 0) atomicAdd(invalid, static_cast<int>(dropped));

  if (table.float_sums) {
    cooperative_groups::this_grid().sync();
    for (int k = 0; k < table.n; ++k) {
      if (table.leaf[k].kind == kSumFloat) {
        add_state(table.leaf[k], static_cast<int64_t>(s) * table.leaf[k].d, first, stride);
      }
    }
  }
}

template <typename Index>
int launch_merge(MergeTable& table, const void* ids_, int r, int s, void* counts_, void* invalid_, int64_t stores,
                 int device, cudaStream_t stream) {
  const Index* ids = static_cast<const Index*>(ids_);
  int* counts = static_cast<int*>(counts_);
  int* invalid = static_cast<int*>(invalid_);
  unsigned grid = 0;
  const int64_t items = table.items;
  const cudaError_t err = cooperative_grid<merge_kernel<Index>>(device, items > stores ? items : stores, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&table, &ids, &r, &s, &counts, &invalid};
  return static_cast<int>(cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(merge_kernel<Index>), grid,
                                                      kThreads, args, 0, stream));
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

// leaves: n rows of kMergeFields int64 each (rows, row stride in elements,
// state, out, default, D, V, kind; see MergeLeaf), read before the call
// returns. Each leaf's rows are int32 or float32 as its kind says, its row i at
// rows + i * row stride; state and out (S, D) and default (D,) contiguous;
// D % V == 0, and rows, out and default aligned to 4 * V bytes with the row
// stride a multiple of V. ids: (r,) int32 (index_bytes=4) or int64 (8). counts:
// (s,) int32, 16-byte aligned, and invalid: one int32, both uninitialised.
// One cooperative launch for every kMaxMergeLeaves leaves, on `stream`, with
// `device` made current for the call; each launch writes the same counts.
// r * (1 + the sum of D / V over the leaves) < 2^31. Returns the first CUDA
// error of the call (0 if none); s <= 0 does nothing.
extern "C" int segment_merge_launch(const long long* leaves, int n, const void* ids, int r, int s, int index_bytes,
                                    void* counts, void* invalid, int device, void* stream) {
  if (s <= 0) return 0;
  if (n < 0 || r < 0 || (index_bytes != 4 && index_bytes != 8)) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(counts) % 16 != 0) return static_cast<int>(cudaErrorMisalignedAddress);
  DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int done = 0;
  do {
    MergeTable table;
    table.n = n - done < kMaxMergeLeaves ? n - done : kMaxMergeLeaves;
    table.float_sums = 0;
    int64_t items = r;
    int64_t stores = s / 4;
    for (int k = 0; k < table.n; ++k) {
      const long long* f = leaves + static_cast<int64_t>(done + k) * kMergeFields;
      MergeLeaf& leaf = table.leaf[k];
      leaf.rows = reinterpret_cast<const void*>(f[0]);
      leaf.row_stride = f[1];
      leaf.state = reinterpret_cast<const void*>(f[2]);
      leaf.out = reinterpret_cast<void*>(f[3]);
      leaf.dflt = reinterpret_cast<const void*>(f[4]);
      leaf.d = static_cast<int>(f[5]);
      leaf.vec = static_cast<int>(f[6]);
      leaf.kind = static_cast<int>(f[7]);
      if ((leaf.vec != 1 && leaf.vec != 2 && leaf.vec != 4) || f[5] < 0 || f[5] >= (1LL << 31) ||
          leaf.d % leaf.vec != 0 || leaf.kind < kSumInt || leaf.kind > kMinFloat) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      const uintptr_t address = static_cast<uintptr_t>(f[0]) | static_cast<uintptr_t>(f[3]) |
                                static_cast<uintptr_t>(f[4]);
      if (address % (4 * leaf.vec) != 0 || leaf.row_stride % leaf.vec != 0) {
        return static_cast<int>(cudaErrorMisalignedAddress);
      }
      leaf.first = static_cast<unsigned>(items);
      items += static_cast<int64_t>(r) * (leaf.d / leaf.vec);
      if (items >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
      stores += static_cast<int64_t>(s) * leaf.d / 4;
      if (leaf.kind == kSumFloat) table.float_sums = 1;
    }
    table.items = static_cast<unsigned>(items);
    const int err = index_bytes == 8 ? launch_merge<int64_t>(table, ids, r, s, counts, invalid, stores, device, st)
                                     : launch_merge<int32_t>(table, ids, r, s, counts, invalid, stores, device, st);
    if (err != 0) return err;
    done += table.n;
  } while (done < n);
  return 0;
}
