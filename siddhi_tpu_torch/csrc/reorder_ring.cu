// Kernel K10: one step of a stream's reorder ring
// (resilience/ordering.py ring_step).
//
// Replaces the reference's jitted ring step,
// siddhi_tpu/resilience/ordering.py::_build_ring_step (:820-875): the C
// ring rows and the C arrivals (2C rows, the live ones the first
// `count` and the first `n_in`) are sorted by (dead last, timestamp,
// arrival), the prefix at or below the watermark is released (at least
// `min_rel` rows, every live row when `final`), and the kept rows are
// compacted back to arrival order. A step is a fixed sequence of
// launches on the caller's stream, with no host sync:
//   1. ring_keys: each row's sortable key (a dead row's key INT64_MAX)
//      and its dead flag;
//   2. key_sort.cuh sort_rows: the stable radix sort of the 64-bit keys
//      with the dead flag as the last pass, the reference's
//      jnp.lexsort((rows, keyed, dead)); the sorted keys;
//   3. ring_cut (one thread): wm_cut, jnp.searchsorted(.., side="right")
//      step for step (key_sort.cuh bisect) clamped to the live rows, the
//      cut, and the first and last released timestamps;
//   4. ring_release: the released batch in sorted order (every row
//      written: past the cut, ts is `first`) and each row's rank;
//   5. ring_keep, a prefix sum of the keep flags (key_sort.cuh
//      prefix_sum) and ring_compact: the stable partition of the rows on
//      rank >= cut, the first C of which are the new ring (the rows past
//      `count` too, as the reference's gather leaves them).
// The host reads back only the four scalars of `meta`.
//
// Bound: the ring's and the arrivals' columns read, the new ring's and
// the released batch's written; the sort's nine passes over 2C rows
// make the step latency-bound at these sizes.
#include "siddhi_kernels.h"
#include "key_sort.cuh"

namespace {

constexpr int T1 = 256;
constexpr int64_t I64MAX = 0x7fffffffffffffffll;
constexpr uint64_t SIGN = 0x8000000000000000ull;

inline int grid(int64_t n) { return (int)((n + T1 - 1) / T1); }

__device__ __forceinline__ bool live_of(const RingArgs& a, int32_t i) {
  return i < a.C ? i < a.count : (i - a.C) < a.n_in;
}

__device__ __forceinline__ int64_t ts_of(const RingArgs& a, int32_t i) {
  return i < a.C ? a.sts[i] : a.in_ts[i - a.C];
}

// row i of column k: the ring's, or the arrivals'
__device__ __forceinline__ void copy_col(const RingArgs& a, int k,
                                         int32_t i, void* dst, int64_t j) {
  if (i < a.C)
    copy_row(dst, j, a.scols[k], i, a.col_size[k]);
  else
    copy_row(dst, j, a.in_cols[k], i - a.C, a.col_size[k]);
}

__global__ void ring_keys(const __grid_constant__ RingArgs a) {
  const int32_t i = blockIdx.x * T1 + threadIdx.x;
  if (i >= 2 * a.C) return;
  const bool live = live_of(a, i);
  const int64_t keyed = live ? ts_of(a, i) : I64MAX;
  a.sort.keys[i] = (int64_t)((uint64_t)keyed ^ SIGN);
  a.sort.pad[i] = !live;
}

__global__ void ring_cut(const __grid_constant__ RingArgs a) {
  const int64_t n_live = (int64_t)a.count + a.n_in;
  int64_t wm_cut = ks::bisect(a.sort.sk, 2 * (int64_t)a.C, a.levels,
                              (uint64_t)a.wm ^ SIGN, false);
  if (wm_cut > n_live) wm_cut = n_live;
  const int64_t m = a.min_rel < n_live ? a.min_rel : n_live;
  int64_t cut = wm_cut > m ? wm_cut : m;
  if (a.final_) cut = n_live;
  const int64_t first = cut > 0 ? ts_of(a, a.sort.order[0]) : 0;
  const int64_t last = cut > 0 ? ts_of(a, a.sort.order[cut - 1]) : 0;
  a.meta[0] = cut;
  a.meta[1] = wm_cut;
  a.meta[2] = first;
  a.meta[3] = last;
}

__global__ void ring_release(const __grid_constant__ RingArgs a) {
  const int32_t j = blockIdx.x * T1 + threadIdx.x;
  if (j >= 2 * a.C) return;
  const int32_t o = a.sort.order[j];
  const bool rel = j < a.meta[0];
  a.rel_valid[j] = rel;
  a.rel_ts[j] = rel ? ts_of(a, o) : a.meta[2];
  a.rel_kind[j] = 0;
  for (int k = 0; k < a.n_cols; ++k) {
    copy_col(a, k, o, a.rel_cols[k], j);
    a.rel_nulls[k][j] = false;
  }
  a.rank[o] = j;
}

__global__ void ring_keep(const __grid_constant__ RingArgs a) {
  const int32_t i = blockIdx.x * T1 + threadIdx.x;
  if (i >= 2 * a.C) return;
  a.keep[i] = live_of(a, i) && a.rank[i] >= a.meta[0];
}

// kept rows first in row order, then the others in row order (the
// reference's jnp.lexsort((rows, ~keep))); the first C are the new ring
__global__ void ring_compact(const __grid_constant__ RingArgs a) {
  const int32_t i = blockIdx.x * T1 + threadIdx.x;
  const int32_t R = 2 * a.C;
  if (i >= R) return;
  const int64_t excl = a.kpre[i] - a.keep[i];
  const int64_t pos = a.keep[i] ? excl : a.kpre[R - 1] + (i - excl);
  if (pos >= a.C) return;
  a.new_ts[pos] = ts_of(a, i);
  for (int k = 0; k < a.n_cols; ++k) copy_col(a, k, i, a.new_cols[k], pos);
}

}  // namespace

extern "C" cudaError_t siddhi_reorder_ring(const RingArgs* p,
                                           cudaStream_t stream) {
  const RingArgs& a = *p;
  const int32_t R = 2 * a.C;
  ring_keys<<<grid(R), T1, 0, stream>>>(a);
  cudaError_t err = ks::sort_rows(a.sort, R, 64, a.sort.pad, stream);
  if (err != cudaSuccess) return err;
  ring_cut<<<1, 1, 0, stream>>>(a);
  ring_release<<<grid(R), T1, 0, stream>>>(a);
  ring_keep<<<grid(R), T1, 0, stream>>>(a);
  ks::prefix_sum<uint8_t>(a.keep, a.kpre, R, a.sums, stream);
  ring_compact<<<grid(R), T1, 0, stream>>>(a);
  return cudaGetLastError();
}
