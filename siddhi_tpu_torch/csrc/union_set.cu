// Kernel H: one unionSet() aggregator's step (ops/aggregators.py
// UnionSetAgg.run_ref), launched between K6's two parts.
//
// Replaces the reference's UnionSetAgg.run (siddhi_tpu/ops/
// aggregators.py:413): a bounded multiset union of SET_LANES * (1 + B)
// signed int64 values with multiplicities. The pairs are the table's
// SET_LANES (value, count) entries (unless a reset in the step wiped it)
// and every lane of every row (+1 for an added row, -1 for a removed
// one, 0 for any other row or an empty lane). A step:
//   1. build: each pair's sortable key (the value with its sign bit
//      flipped: signed order) and its sign;
//   2. compact: the pairs of non-zero sign, in pair order (a pair of
//      sign 0 changes no total, and a value none of whose pairs has a
//      sign is not live), their count read back to the host, the step's
//      one sync (of the B rows' 32 lanes a createSet() feed fills one);
//   3. the 64-bit stable radix sort of key_sort.cuh over the kept pairs
//      (the reference's argsort is unstable, but equal values carry
//      integer signs, so any order of equal values gives the same
//      totals), then the signs in sorted order and their prefix;
//   4. segments: at the last pair of each run of equal values, the run's
//      total (the prefix less the prefix before the run's first pair,
//      found by bisection) and whether the value is live (total > 0, not
//      SET_EMPTY);
//   5. the live flags' prefix: each live value's rank;
//   6. scatter: ranks below SET_LANES into the new table (the smallest
//      live values by signed order);
//   7. finish (one block): the tag (the running max over the table and
//      the step's effective rows) and overflow += max(n_live - SET_LANES,
//      0);
//   8. broadcast: every row's output is [tag, the new table's values].
// Every value is an integer, so the kernel is bit-equal to its plain
// version and to the reference.
//
// Bound: memory bytes, the B set rows read and the B union rows written
// (264 bytes a row each); the sort's eight passes over the kept pairs
// and the compaction's pass over all n dominate the work.
#include "key_sort.cuh"
#include "siddhi_kernels.h"

namespace {

constexpr int32_t CUR = 0, EXP = 1;
constexpr int W = 1 + SIDDHI_SET_LANES;
constexpr uint64_t SIGN = 0x8000000000000000ull;

__global__ void build(const AggArgs a, const UnionArgs u) {
  const int64_t j = (int64_t)blockIdx.x * ks::T1 + threadIdx.x;
  if (j >= u.n) return;
  const bool keep_tab = a.scal[0] == 0;   // no reset in the step
  int64_t v, c;
  if (j < SIDDHI_SET_LANES) {
    v = keep_tab ? u.vals[j] : SIDDHI_SET_EMPTY;
    c = keep_tab ? u.counts[j] : 0;
    u.new_vals[j] = SIDDHI_SET_EMPTY;
    u.new_counts[j] = 0;
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
  u.keys_all[j] = (int64_t)((uint64_t)v ^ SIGN);
  u.sgn_all[j] = c;
  u.keep[j] = c != 0;
}

// the kept pairs, in pair order (rank: the keep flags' inclusive prefix)
__global__ void compact(const UnionArgs u) {
  const int64_t j = (int64_t)blockIdx.x * ks::T1 + threadIdx.x;
  if (j >= u.n || !u.keep[j]) return;
  const int64_t p = u.rank[j] - 1;
  u.sort.keys[p] = u.keys_all[j];
  u.sgn[p] = u.sgn_all[j];
}

__global__ void sorted_signs(const UnionArgs u, int64_t m) {
  const int64_t j = (int64_t)blockIdx.x * ks::T1 + threadIdx.x;
  if (j < m) u.total[j] = u.sgn[u.sort.order[j]];
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
  const int64_t* sk = u.sort.sk;
  bool live = false;
  if (j == m - 1 || sk[j] != sk[j + 1]) {
    const int64_t f = run_start(sk, j);
    const int64_t t = u.csum[j] - (f > 0 ? u.csum[f - 1] : 0);
    const int64_t v = (int64_t)((uint64_t)sk[j] ^ SIGN);
    live = t > 0 && v != SIDDHI_SET_EMPTY;
    u.total[j] = t;
  }
  u.live[j] = live;
}

__global__ void scatter(const UnionArgs u, int64_t m) {
  const int64_t j = (int64_t)blockIdx.x * ks::T1 + threadIdx.x;
  if (j >= m || !u.live[j]) return;
  const int64_t r = u.rank[j] - 1;
  if (r < SIDDHI_SET_LANES) {
    u.new_vals[r] = (int64_t)((uint64_t)u.sort.sk[j] ^ SIGN);
    u.new_counts[r] = u.total[j];
  }
}

// one block: the tag and the overflow count (m kept pairs)
__global__ void finish(const AggArgs a, const UnionArgs u, int64_t m) {
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
    const int64_t n_live = m > 0 ? u.rank[m - 1] : 0;
    *u.new_overflow = *u.overflow + (n_live > SIDDHI_SET_LANES
                                         ? n_live - SIDDHI_SET_LANES : 0);
  }
}

__global__ void broadcast(const UnionArgs u) {
  const int64_t e = (int64_t)blockIdx.x * ks::T1 + threadIdx.x;
  if (e >= (int64_t)u.B * W) return;
  const int l = (int)(e % W);
  u.out[e] = l == 0 ? *u.new_tag : u.new_vals[l - 1];
  if (l == 0) u.out_null[e / W] = false;
}

}  // namespace

extern "C" cudaError_t siddhi_union_set(const AggArgs* p, const UnionArgs* q,
                                        cudaStream_t stream) {
  const AggArgs& a = *p;
  const UnionArgs& u = *q;
  const int64_t n = u.n;
  build<<<ks::grid(n), ks::T1, 0, stream>>>(a, u);
  ks::prefix_sum<uint8_t>(u.keep, u.rank, n, u.sums, stream);
  compact<<<ks::grid(n), ks::T1, 0, stream>>>(u);
  cudaError_t err = cudaMemcpyAsync(u.n_kept, u.rank + n - 1,
                                    sizeof(int64_t), cudaMemcpyDeviceToHost,
                                    stream);
  if (err == cudaSuccess) err = cudaStreamSynchronize(stream);
  if (err != cudaSuccess) return err;
  const int64_t m = *u.n_kept;
  if (m > 0) {
    err = ks::sort_rows(u.sort, (int32_t)m, 64, nullptr, stream);
    if (err != cudaSuccess) return err;
    sorted_signs<<<ks::grid(m), ks::T1, 0, stream>>>(u, m);
    ks::prefix_sum<int64_t>(u.total, u.csum, m, u.sums, stream);
    segments<<<ks::grid(m), ks::T1, 0, stream>>>(u, m);
    ks::prefix_sum<uint8_t>(u.live, u.rank, m, u.sums, stream);
    scatter<<<ks::grid(m), ks::T1, 0, stream>>>(u, m);
  }
  finish<<<1, SS_BLOCK, 0, stream>>>(a, u, m);
  broadcast<<<ks::grid((int64_t)u.B * W), ks::T1, 0, stream>>>(u);
  return cudaGetLastError();
}
