// Kernel K9p: a partition block's route, compaction and due
// (parallel/partition.py route, compact, min_due).
//
// Replaces the reference's PartitionBlockRuntime._slots_for
// (siddhi_tpu/parallel/partition.py:332), the slot masks of its
// jax.vmap(run_block) (:453, `batch.mask((slots == k) | is_timer_row)`),
// _flatten_compact (:212) and the minimum of the vmapped dues (:463,
// :609). The key or range expressions before it are kernel K2's.
//
// route, two launches:
//   1. one block: a value key's hash (ops/keyed.py hash_columns over the
//      one key column, keyed.cuh) and the block's first-seen slot table
//      (lookup_or_insert's 16 probe rounds, keyed.cuh probe_table: the
//      lowest row index claims a free slot, overflow counted), the
//      TIMER rows inactive; or, for range conditions, the first
//      condition that is TRUE and not null names the row's slot;
//   2. per (slot, row): the slot's valid mask, the row valid and either
//      in the slot or a TIMER row.
// compact: the reference's stable argsort of the K * N keys (ts where
// valid, 2**62 where not) puts the valid rows first, by (ts, row), and
// then the invalid rows in row order (all of one key), rows being
// numbered slot after slot, so (ts, slot, row). Only the valid rows are
// sorted: a prefix count of the valid flags (key_sort.cuh prefix_sum)
// places the valid rows' keys and indices in row order and the first
// out_cap invalid rows' indices; a stable LSD radix sort of the valid
// keys (eight of key_sort.cuh's 8-bit digit passes, no library sort)
// whose launches cover every row but read the valid count from the
// device, so that no pass waits on the host; then the first out_cap rows are gathered, and the
// rows kept and the valid rows dropped are added to the query's emitted
// and lost counters.
// due: one block per query, the minimum over its slots' dues.
//
// Bound: route reads the key and the batch's kind and valid and writes
// K * B mask bytes; compact reads the K * N rows' valid flags and
// timestamps, sorts the valid rows' keys eight times over (a pass a
// digit) and gathers out_cap rows.
#include "key_sort.cuh"
#include "keyed.cuh"
#include "siddhi_kernels.h"
#include "sort_scan.cuh"

namespace {

constexpr int32_t TMR = 2;   // core/event.py TIMER
constexpr int T1 = 256;

inline int grid(int64_t n) { return (int)((n + T1 - 1) / T1); }

__global__ void __launch_bounds__(SS_BLOCK) route_rows(const RouteArgs a) {
  __shared__ int64_t buf[SS_BLOCK];
  const int32_t B = a.B, K = a.K;
  if (a.mode == 1) {   // range conditions: the first that holds
    for (int32_t i = threadIdx.x; i < B; i += SS_BLOCK) {
      int32_t s = -1;
      for (int c = 0; c < a.n_conds && s < 0; ++c)
        if (a.cond_vals[c][i] && !a.cond_nulls[c][i]) s = a.cond_slot[c];
      a.slots[i] = s;
    }
    for (int32_t k = threadIdx.x; k < K; k += SS_BLOCK) {
      a.new_keys[k] = a.keys[k];
      a.new_used[k] = a.used[k];
    }
    if (threadIdx.x == 0) *a.new_overflow = *a.overflow;
    return;
  }
  for (int32_t i = threadIdx.x; i < B; i += SS_BLOCK) {
    a.hk[i] = kd::mix64(kd::HASH_SEED,
                        kd::key_lane(a.key_col, a.key_type, a.key_null, i));
    a.active[i] = a.valid[i] && a.kind[i] != TMR;
  }
  __syncthreads();
  const int64_t lost = kd::probe_table(B, K, a.keys, a.used, a.new_keys,
                                       a.new_used, a.hk, a.active, a.slots,
                                       a.prb, a.flags, a.claim, buf);
  if (threadIdx.x == 0) *a.new_overflow = *a.overflow + lost;
}

__global__ void slot_masks(const RouteArgs a) {
  const int64_t j = (int64_t)blockIdx.x * T1 + threadIdx.x;
  if (j >= (int64_t)a.K * a.B) return;
  const int32_t k = (int32_t)(j / a.B), i = (int32_t)(j % a.B);
  a.valid_k[j] = a.valid[i] && (a.slots[i] == k || a.kind[i] == TMR);
}

// the valid rows' keys and indices, compacted in row order, and the
// first out_cap invalid rows in row order
__global__ void compact_place(const CompactArgs a) {
  const int32_t i = blockIdx.x * T1 + threadIdx.x;
  if (i >= a.n) return;
  const int64_t before = a.vpref[i] - (a.valid[i] ? 1 : 0);
  if (a.valid[i]) {
    a.k0[before] = (uint64_t)a.ts[i] ^ 0x8000000000000000ull;
    a.i0[before] = i;
  } else {
    const int64_t r = i - before;   // invalid rows before this one
    if (r < a.out_cap) a.inv_idx[r] = i;
  }
}

// output row j: the j-th valid row by (ts, row), then the invalid rows
// in row order; the sorted indices are in i2 after the eight passes
__global__ void compact_gather(const CompactArgs a) {
  const int32_t j = blockIdx.x * T1 + threadIdx.x;
  if (j >= a.out_cap) return;
  const int64_t nv = a.vpref[a.n - 1];
  const int32_t i = j < nv ? a.i2[j] : a.inv_idx[j - nv];
  a.out_ts[j] = a.ts[i];
  a.out_kind[j] = a.kind[i];
  a.out_valid[j] = a.valid[i];
  for (int c = 0; c < a.n_cols; ++c) {
    copy_row(a.out_cols[c], j, a.cols[c], i, a.col_size[c]);
    a.out_nulls[c][j] = a.nulls[c][i];
  }
}

__global__ void compact_count(const CompactArgs a) {
  const int64_t nv = a.vpref[a.n - 1];
  const int64_t kept = nv < a.out_cap ? nv : a.out_cap;
  *a.emitted += kept;
  *a.lost += nv - kept;
}

__global__ void __launch_bounds__(SS_BLOCK) due_min(const DueArgs a) {
  __shared__ int64_t buf[SS_BLOCK];
  const int q = blockIdx.x, t = threadIdx.x;
  int64_t m = INT64_MAX;
  for (int64_t i = t; i < a.n[q]; i += SS_BLOCK)
    if (a.dues[q][i] < m) m = a.dues[q][i];
  buf[t] = m;
  __syncthreads();
  for (int off = SS_BLOCK / 2; off > 0; off >>= 1) {
    if (t < off && buf[t + off] < buf[t]) buf[t] = buf[t + off];
    __syncthreads();
  }
  if (t == 0) a.out[q] = buf[0];
}

}  // namespace

extern "C" cudaError_t siddhi_partition_route(const RouteArgs* p,
                                              cudaStream_t stream) {
  const RouteArgs& a = *p;
  route_rows<<<1, SS_BLOCK, 0, stream>>>(a);
  slot_masks<<<grid((int64_t)a.K * a.B), T1, 0, stream>>>(a);
  return cudaGetLastError();
}

extern "C" cudaError_t siddhi_partition_compact(const CompactArgs* p,
                                                cudaStream_t stream) {
  const CompactArgs& a = *p;
  ks::prefix_sum<bool>(a.valid, a.vpref, a.n, a.sums, stream);
  compact_place<<<grid(a.n), T1, 0, stream>>>(a);
  const int blocks = (a.n + SS_BLOCK - 1) / SS_BLOCK;
  const uint64_t* kin = a.k0;
  const int32_t* iin = a.i0;
  const int64_t* nv = a.vpref + (a.n - 1);   // the valid rows
  for (int pass = 0; pass < 8; ++pass) {   // ends in (k2, i2)
    uint64_t* kout = (pass & 1) ? a.k2 : a.k1;
    int32_t* iout = (pass & 1) ? a.i2 : a.i1;
    ks::hist64<<<blocks, SS_BLOCK, 0, stream>>>(kin, a.n, 8 * pass, a.counts,
                                                nv);
    ss::scan_counts<<<1, SS_BLOCK, 0, stream>>>(a.counts, 0, nv);
    ks::scatter64<<<blocks, SS_BLOCK, 0, stream>>>(kin, iin, a.n, 8 * pass,
                                                   a.counts, kout, iout, nv);
    kin = kout;
    iin = iout;
  }
  compact_gather<<<grid(a.out_cap), T1, 0, stream>>>(a);
  compact_count<<<1, 1, 0, stream>>>(a);
  return cudaGetLastError();
}

extern "C" cudaError_t siddhi_partition_due(const DueArgs* p,
                                            cudaStream_t stream) {
  due_min<<<p->n_q, SS_BLOCK, 0, stream>>>(*p);
  return cudaGetLastError();
}
