// Kernel H: one unionSet() aggregator's step (ops/aggregators.py
// UnionSetAgg.run_ref), launched between K6's two parts.
//
// Replaces the reference's UnionSetAgg.run (siddhi_tpu/ops/
// aggregators.py:413): a bounded multiset union of SET_LANES * (1 + B)
// signed int64 values with multiplicities. The pairs are the table's
// SET_LANES (value, count) entries (unless a reset in the step wiped it)
// and every lane of every row (+1 for an added row, -1 for a removed
// one, 0 for any other row or an empty lane). A step:
//   1. build: each pair's keep flag (a non-zero sign: a pair of sign 0
//      changes no total, and a value none of whose pairs has a sign is
//      not live), and their prefix;
//   2. each slot's kept count read back to the host in one copy, the
//      step's one sync (of the B rows' 32 lanes a createSet() feed
//      fills one); m, the most any slot kept, sizes what follows;
//   3. compact: each slot's kept pairs' sortable keys (the value with
//      its sign bit flipped: signed order) and signs, in pair order, m a
//      slot, the slot's places past its own count padded with the
//      largest key and sign 0 (they sort last and change no total);
//   4. the 64-bit stable radix sort of key_sort.cuh over the m pairs of
//      every slot, one segment a slot (the reference's argsort is
//      unstable, but equal values carry integer signs, so any order of
//      equal values gives the same totals), then the signs in sorted
//      order and their prefix;
//   5. segments: at the last pair of each run of equal values, the run's
//      total (the prefix less the prefix before the run's first pair,
//      found by bisection) and whether the value is live (total > 0, not
//      SET_EMPTY);
//   6. the live flags' prefix: each live value's rank;
//   7. scatter: ranks below SET_LANES into the new table (the smallest
//      live values by signed order);
//   8. finish (one block a slot): the tag (the running max over the
//      table and the step's effective rows) and overflow +=
//      max(n_live - SET_LANES, 0);
//   9. broadcast: every row's output is [tag, the new table's values].
// Every value is an integer, so the kernel is bit-equal to its plain
// version and to the reference.
//
// The slot axis (H[K]: a partition block's or a tenant pool's slots,
// the reference's jax.vmap(run_block), siddhi_tpu/parallel/
// partition.py:453, and its pool's vmapped steps): every launch takes
// one row of blocks a slot (blockIdx.y); the pointers into the slots'
// tables, rows and [n] scratch move through part_args, the compacted
// pairs are m a slot at blockIdx.y * m. One sync a step for all slots.
//
// Bound: memory bytes, the B set rows read and the B union rows written
// (264 bytes a row each); the sort's eight passes over the kept pairs
// and the compaction's passes over all n dominate the work.
#include "key_sort.cuh"
#include "siddhi_kernels.h"

namespace {

constexpr int32_t CUR = 0, EXP = 1;
constexpr int W = 1 + SIDDHI_SET_LANES;
constexpr uint64_t SIGN = 0x8000000000000000ull;
constexpr uint64_t PAD_KEY = 0xffffffffffffffffull;

// pair j of a slot: its sortable key and its sign
__device__ __forceinline__ void pair_of(const AggArgs& a, const UnionArgs& u,
                                        int64_t j, int64_t* key,
                                        int64_t* sgn) {
  const bool keep_tab = a.scal[0] == 0;   // no reset in the step
  int64_t v, c;
  if (j < SIDDHI_SET_LANES) {
    v = keep_tab ? u.vals[j] : SIDDHI_SET_EMPTY;
    c = keep_tab ? u.counts[j] : 0;
  } else {
    const int64_t i = (j - SIDDHI_SET_LANES) / SIDDHI_SET_LANES;
    const int64_t l = 1 + (j - SIDDHI_SET_LANES) % SIDDHI_SET_LANES;
    v = u.arg[i * W + l];
    const int32_t k = a.kind[i];
    const bool add = a.valid[i] && k == CUR, rem = a.valid[i] && k == EXP;
    const bool eff = (add || rem) && !u.arg_null[i] &&
                     a.reset_seg[i] == a.scal[0];
    c = (!eff || v == SIDDHI_SET_EMPTY) ? 0 : (add ? 1 : -1);
  }
  *key = (int64_t)((uint64_t)v ^ SIGN);
  *sgn = c;
}

__global__ void build(const __grid_constant__ AggArgs a0,
                      const __grid_constant__ UnionArgs u0) {
  const AggArgs& a = part_args(a0);
  const UnionArgs& u = part_args(u0);
  const int64_t j = (int64_t)blockIdx.x * ks::T1 + threadIdx.x;
  if (j >= u.n) return;
  if (j < SIDDHI_SET_LANES) {
    u.new_vals[j] = SIDDHI_SET_EMPTY;
    u.new_counts[j] = 0;
  }
  int64_t key, c;
  pair_of(a, u, j, &key, &c);
  u.keep[j] = c != 0;
}

// each slot's kept pairs: the last of its keep flags' prefix
__global__ void kept(const __grid_constant__ UnionArgs u0) {
  const UnionArgs& u = part_args(u0);
  if (threadIdx.x == 0) *u.kept = u.rank[u.n - 1];
}

// the kept pairs, in pair order, m a slot (rank: the keep flags'
// inclusive prefix)
__global__ void compact(const __grid_constant__ AggArgs a0,
                        const __grid_constant__ UnionArgs u0, int64_t m) {
  const AggArgs& a = part_args(a0);
  const UnionArgs& u = part_args(u0);
  const int64_t j = (int64_t)blockIdx.x * ks::T1 + threadIdx.x;
  if (j >= u.n || !u.keep[j]) return;
  const int64_t p = (int64_t)blockIdx.y * m + u.rank[j] - 1;
  int64_t key, c;
  pair_of(a, u, j, &key, &c);
  u.sort.keys[p] = key;
  u.sgn[p] = c;
}

// a slot's places past its own kept count: sorted last, no total
__global__ void pad(const __grid_constant__ UnionArgs u0, int64_t m) {
  const UnionArgs& u = part_args(u0);
  const int64_t j = (int64_t)blockIdx.x * ks::T1 + threadIdx.x;
  if (j >= m || j < *u.kept) return;
  const int64_t p = (int64_t)blockIdx.y * m + j;
  u.sort.keys[p] = (int64_t)PAD_KEY;
  u.sgn[p] = 0;
}

__global__ void sorted_signs(const UnionArgs u, int64_t m) {
  const int64_t j = (int64_t)blockIdx.x * ks::T1 + threadIdx.x;
  if (j >= m) return;
  const int64_t o = (int64_t)blockIdx.y * m;
  u.total[o + j] = u.sgn[o + u.sort.order[o + j]];
}

// the first index of the run of sorted keys equal to sk[j]
__device__ __forceinline__ int64_t run_start(const int64_t* sk, int64_t j) {
  const uint64_t v = (uint64_t)sk[j];
  int64_t lo = 0, hi = j;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if ((uint64_t)sk[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void segments(const UnionArgs u, int64_t m) {
  const int64_t j = (int64_t)blockIdx.x * ks::T1 + threadIdx.x;
  if (j >= m) return;
  const int64_t o = (int64_t)blockIdx.y * m;
  const int64_t* sk = u.sort.sk + o;
  const int64_t* csum = u.csum + o;
  bool live = false;
  if (j == m - 1 || sk[j] != sk[j + 1]) {
    const int64_t f = run_start(sk, j);
    const int64_t t = csum[j] - (f > 0 ? csum[f - 1] : 0);
    const int64_t v = (int64_t)((uint64_t)sk[j] ^ SIGN);
    live = t > 0 && v != SIDDHI_SET_EMPTY;
    u.total[o + j] = t;
  }
  u.live[o + j] = live;
}

__global__ void scatter(const __grid_constant__ UnionArgs u0, int64_t m) {
  const UnionArgs& u = part_args(u0);
  const int64_t j = (int64_t)blockIdx.x * ks::T1 + threadIdx.x;
  const int64_t o = (int64_t)blockIdx.y * m;
  if (j >= m || !u.live[o + j]) return;
  const int64_t r = u.lrank[o + j] - 1;
  if (r < SIDDHI_SET_LANES) {
    u.new_vals[r] = (int64_t)((uint64_t)u.sort.sk[o + j] ^ SIGN);
    u.new_counts[r] = u.total[o + j];
  }
}

// one block a slot: the tag and the overflow count (m kept pairs)
__global__ void __launch_bounds__(SS_BLOCK)
    finish(const __grid_constant__ AggArgs a0,
           const __grid_constant__ UnionArgs u0, int64_t m) {
  const AggArgs& a = part_args(a0);
  const UnionArgs& u = part_args(u0);
  __shared__ int64_t buf[SS_BLOCK];
  int64_t mx = 0;
  for (int64_t i = threadIdx.x; i < u.B; i += SS_BLOCK) {
    const int32_t k = a.kind[i];
    const bool eff = a.valid[i] && (k == CUR || k == EXP) &&
                     !u.arg_null[i] && a.reset_seg[i] == a.scal[0];
    const int64_t t = eff ? u.arg[i * W] : 0;
    mx = t > mx ? t : mx;
  }
  const int64_t top = ss::block_scan_max(mx, buf);
  if (threadIdx.x == SS_BLOCK - 1) {
    *u.new_tag = *u.tag > top ? *u.tag : top;
    const int64_t n_live =
        m > 0 ? u.lrank[(int64_t)blockIdx.y * m + m - 1] : 0;
    *u.new_overflow = *u.overflow + (n_live > SIDDHI_SET_LANES
                                         ? n_live - SIDDHI_SET_LANES : 0);
  }
}

__global__ void broadcast(const __grid_constant__ UnionArgs u0) {
  const UnionArgs& u = part_args(u0);
  const int64_t e = (int64_t)blockIdx.x * ks::T1 + threadIdx.x;
  if (e >= (int64_t)u.B * W) return;
  const int l = (int)(e % W);
  u.out[e] = l == 0 ? *u.new_tag : u.new_vals[l - 1];
  if (l == 0) u.out_null[e / W] = false;
}

inline dim3 rows(int64_t n, int64_t parts) {
  return dim3((unsigned)ks::grid(n), (unsigned)parts);
}

}  // namespace

// Steps 1-2: the keep flags, their prefix and every slot's kept count in
// n_kept (host memory), after the step's one sync.
extern "C" cudaError_t siddhi_union_count(const AggArgs* p,
                                          const UnionArgs* q,
                                          cudaStream_t stream) {
  const AggArgs& a = *p;
  const UnionArgs& u = *q;
  const int64_t n = u.n, parts = u.n_part;
  build<<<rows(n, parts), ks::T1, 0, stream>>>(a, u);
  ks::prefix_sum<uint8_t>(u.keep, u.rank, n, u.sums, stream, parts);
  kept<<<dim3(1, (unsigned)parts), 32, 0, stream>>>(u);
  cudaError_t err = cudaMemcpyAsync(u.n_kept, u.kept,
                                    parts * sizeof(int64_t),
                                    cudaMemcpyDeviceToHost, stream);
  if (err == cudaSuccess) err = cudaStreamSynchronize(stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Steps 3-9 over m kept pairs a slot (the compacted arrays of the struct
// hold n_part * m entries).
extern "C" cudaError_t siddhi_union_finish(const AggArgs* p,
                                           const UnionArgs* q, int64_t m,
                                           cudaStream_t stream) {
  const AggArgs& a = *p;
  const UnionArgs& u = *q;
  const int64_t parts = u.n_part;
  if (m > 0) {
    compact<<<rows(u.n, parts), ks::T1, 0, stream>>>(a, u, m);
    pad<<<rows(m, parts), ks::T1, 0, stream>>>(u, m);
    cudaError_t err = ks::sort_rows(u.sort, (int32_t)m, 64, nullptr, stream,
                                    parts);
    if (err != cudaSuccess) return err;
    sorted_signs<<<rows(m, parts), ks::T1, 0, stream>>>(u, m);
    ks::prefix_sum<int64_t>(u.total, u.csum, m, u.msums, stream, parts);
    segments<<<rows(m, parts), ks::T1, 0, stream>>>(u, m);
    ks::prefix_sum<uint8_t>(u.live, u.lrank, m, u.msums, stream, parts);
    scatter<<<rows(m, parts), ks::T1, 0, stream>>>(u, m);
  }
  finish<<<dim3(1, (unsigned)parts), SS_BLOCK, 0, stream>>>(a, u, m);
  broadcast<<<rows((int64_t)u.B * W, parts), ks::T1, 0, stream>>>(u);
  return cudaGetLastError();
}
