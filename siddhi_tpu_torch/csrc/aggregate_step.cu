// Kernel K6: the aggregating selector's step and emission
// (ops/aggregators.py aggregate_step, aggregate_emit).
//
// Replaces the reference's AggregateOp.step (siddhi_tpu/ops/
// aggregators.py:825) with its group helpers (siddhi_tpu/ops/keyed.py:
// mix64 :25, hash_columns :33, lookup_or_insert :50, cumsum_fast :103,
// segmented_cumsum :113, _segmented_scan :134) and the selector's
// shape_output (siddhi_tpu/ops/selector.py:88). The projection and
// having between the two entry points are kernel K2's.
//
// The step, a fixed sequence of launches with no host sync:
//   1. hash: each row's key hash (splitmix64 over the group-by columns);
//   2. probe (one block): open addressing in rounds of the reference's
//      16; a claim is an atomicMin of the row index on the slot, then a
//      re-check after the claims land; rounds stop early once no row is
//      pending (a later round changes nothing);
//   3. segments (one block): each row's reset segment (RESET rows so far);
//   4. a stable radix sort of the slots (sort_scan.cuh): the rows by
//      slot, in row order within a slot;
//   5. per lane: the contributions in slot order, then the scan in
//      jax.lax.associative_scan's own tree order (level sums tile by tile
//      in shared memory, then each element walks its path down the
//      tree), the segment's prefix taken off (sum lanes, as
//      segmented_cumsum does) or the segment-aware min/max, the carry
//      added in, the order undone;
//   6. the value functions (avg's s / max(cnt, 1); stdDev's
//      sqrt(max(ss / n - mean^2, 0)) with the reference compiler's fused
//      multiply-add);
//   7. the new carries: one thread a slot folds its rows of the last
//      reset segment in row order, as the reference's scatter applies
//      them (float sums are not reassociated), reading the contributions
//      in slot order from the tree's level 0.
// Float arithmetic is the reference's: subnormal operands and results
// read as zero; the __d*_rn intrinsics keep nvcc from fusing what the
// reference does not fuse. min/max follow XLA's CPU minimum/maximum.
//
// The emission: the qualifying rows (slot in the table, and K2's gate
// and having), in batch mode the last per (slot, flush chunk) (a stable
// sort of slot * (B + 1) + chunk), placed by emission order with prefix
// sums (no sort), then offset and limit, and the count added to the
// query's emitted counter. With an order-by (keep_order) the qualifying
// rows are placed in row order, unshaped and uncounted: kernel G
// (order_by.cu) orders, offsets, limits and counts them.
#include <cfloat>

#include "keyed.cuh"
#include "lane_math.cuh"
#include "siddhi_kernels.h"
#include "sort_scan.cuh"

namespace {

constexpr int32_t CUR = 0, EXP = 1, RST = 3;
constexpr int T1 = 256;
constexpr int TILE = 2048;            // level-0 elements of an up-sweep tile
constexpr int TILE_LEVELS = 11;       // 2048 = 2^11

using namespace lm;

__device__ __forceinline__ double sub(double a, double b) {
  return flush(nan_pick(__dsub_rn(flush(a), flush(b)), b, a));
}
__device__ __forceinline__ float sub(float a, float b) {
  return flush(nan_pick(__fsub_rn(flush(a), flush(b)), b, a));
}

// a scan result as jax's _interleave leaves it: + 0.0 from the other
// half's zero padding (-0.0 and subnormals become +0.0, a NaN keeps its
// bits, made quiet)
template <typename T> __device__ __forceinline__ T plus_zero(T x) {
  return add(x, (T)0);
}
template <> __device__ __forceinline__ int32_t plus_zero(int32_t x) {
  return x;
}
template <> __device__ __forceinline__ int64_t plus_zero(int64_t x) {
  return x;
}
__device__ __forceinline__ int64_t sub(int64_t a, int64_t b) {
  return (int64_t)((uint64_t)a - (uint64_t)b);
}
__device__ __forceinline__ int32_t sub(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a - (uint32_t)b);
}

template <typename T> __device__ __forceinline__ T combine(int op, T a, T b) {
  return op == LANE_SUM ? add(a, b) : (op == LANE_MIN ? vmin(a, b)
                                                      : vmax(a, b));
}

template <typename T> __device__ __forceinline__ T identity(int op);
template <> __device__ __forceinline__ double identity<double>(int op) {
  return op == LANE_SUM ? 0.0 : (op == LANE_MIN ? __longlong_as_double(
      0x7ff0000000000000LL) : __longlong_as_double((long long)
      0xfff0000000000000ULL));
}
template <> __device__ __forceinline__ float identity<float>(int op) {
  return op == LANE_SUM ? 0.0f : (op == LANE_MIN ? __int_as_float(0x7f800000)
                                                 : __int_as_float((int)
                                                     0xff800000u));
}
template <> __device__ __forceinline__ int64_t identity<int64_t>(int op) {
  return op == LANE_SUM ? 0 : (op == LANE_MIN ? INT64_MAX : INT64_MIN);
}
template <> __device__ __forceinline__ int32_t identity<int32_t>(int op) {
  return op == LANE_SUM ? 0 : (op == LANE_MIN ? INT32_MAX : INT32_MIN);
}

// ---------------------------------------------------------------- inputs

__device__ __forceinline__ int64_t int_at(const void* col, int type,
                                          int64_t i) {
  switch (type) {
    case VT_INT: case VT_STRING: return ((const int32_t*)col)[i];
    case VT_LONG: return ((const int64_t*)col)[i];
    case VT_BOOL: return ((const bool*)col)[i];
    default: return 0;
  }
}

// the argument widened to the accumulator type
__device__ __forceinline__ double arg_f64(const void* col, int type,
                                          int64_t i) {
  switch (type) {
    case VT_INT: return (double)((const int32_t*)col)[i];
    case VT_LONG: return __ll2double_rn(((const int64_t*)col)[i]);
    case VT_FLOAT: return (double)flush(((const float*)col)[i]);
    default: return ((const double*)col)[i];
  }
}

struct Row {
  bool add, rem;   // a CURRENT row adds, an EXPIRED one removes
};

__device__ __forceinline__ Row row_of(const AggArgs& a, int64_t i) {
  const bool v = a.valid[i];
  const int32_t k = a.kind[i];
  return {v && k == CUR, v && k == EXP};
}

template <typename T> __device__ __forceinline__ T signed_(T x, Row r) {
  return r.add ? x : (r.rem ? (T)-x : (T)0);
}

// lane `l`'s contribution of row i (AggSpec.contribs)
template <typename T>
__device__ T contrib(const AggArgs& a, int l, int64_t i) {
  const int s = a.lane_spec[l], k = l - a.spec_lane0[s];
  if (a.spec_contrib[s]) return (T)a.spec_contrib[s][i];
  const Row r = row_of(a, i);
  const int kind = a.spec_kind[s];
  const int at = a.arg_type[s];
  const bool null = at >= 0 && a.arg_nulls[s][i];
  const bool any = r.add || r.rem;
  if (kind == AGG_COUNT) return (T)signed_<int64_t>(any ? 1 : 0, r);
  if (kind == AGG_MINMAX || kind == AGG_FOREVER) {
    const bool eff = (kind == AGG_MINMAX ? r.add : any) && !null;
    if (k == 1) return (T)(eff ? 1 : 0);
    if (!eff) return identity<T>(a.lane_op[l]);
    return ((const T*)a.arg_cols[s])[i];
  }
  const bool eff = any && !null;
  if (kind == AGG_BOOL) {
    const bool v = ((const bool*)a.arg_cols[s])[i];
    return (T)signed_<int64_t>((eff && (k == 0 ? v : !v)) ? 1 : 0, r);
  }
  const int count_lane = kind == AGG_STDDEV ? 2 : 1;
  if (k == count_lane) return (T)signed_<int64_t>(eff ? 1 : 0, r);
  if (a.lane_type[l] == VT_LONG) {     // sum() of an integral argument
    const int64_t x = eff ? int_at(a.arg_cols[s], at, i) : 0;
    return (T)(signed_<int64_t>(x, r) * (eff ? 1 : 0));
  }
  const double x = eff ? arg_f64(a.arg_cols[s], at, i) : 0.0;
  double v;
  if (kind == AGG_STDDEV && k == 1)
    v = signed_<double>(flush(__dmul_rn(flush(x), flush(x))), r);
  else
    v = signed_<double>(x, r);
  if (kind == AGG_SUM)   // _signed(x) * eff
    v = flush(__dmul_rn(flush(v), eff ? 1.0 : 0.0));
  return (T)v;
}

// ------------------------------------------------------------- the table

__global__ void hash_rows(const __grid_constant__ AggArgs a0) {
  const AggArgs& a = part_args(a0);
  const int64_t i = (int64_t)blockIdx.x * T1 + threadIdx.x;
  if (i >= a.B) return;
  int64_t h = 1469598103934665603LL;
  for (int c = 0; c < a.n_keys; ++c) {
    int64_t lane;
    switch (a.key_type[c]) {
      case VT_DOUBLE:
        lane = __double_as_longlong(((const double*)a.key_cols[c])[i]);
        break;
      case VT_FLOAT:
        lane = __float_as_int(((const float*)a.key_cols[c])[i]);
        break;
      default: lane = int_at(a.key_cols[c], a.key_type[c], i);
    }
    if (a.key_nulls[c][i]) lane = -987654321987654321LL;
    h = kd::mix64(h, lane);
  }
  a.hk[i] = h;
}

// one block: the group table's probe (lookup_or_insert)
__global__ void __launch_bounds__(SS_BLOCK)
    probe(const __grid_constant__ AggArgs a0) {
  const AggArgs& a = part_args(a0);
  __shared__ int64_t buf[SS_BLOCK];
  const int32_t B = a.B, K = a.K;
  if (!a.grouped) {
    for (int32_t i = threadIdx.x; i < B; i += SS_BLOCK) {
      const Row r = row_of(a, i);
      a.slots[i] = (r.add || r.rem) ? 0 : K;
    }
    for (int32_t k = threadIdx.x; k < K; k += SS_BLOCK) {
      a.new_keys[k] = a.keys[k];
      a.new_used[k] = a.used[k];
    }
    if (threadIdx.x == 0) *a.new_overflow = *a.overflow;
    return;
  }
  // the rows' activity, one byte a row in the sort keys' scratch (the
  // segments launch writes the keys after the probe)
  uint8_t* active = (uint8_t*)a.skeys;
  for (int32_t i = threadIdx.x; i < B; i += SS_BLOCK) {
    const Row r = row_of(a, i);
    active[i] = r.add || r.rem;
  }
  __syncthreads();
  const int64_t lost = kd::probe_table(B, K, a.keys, a.used, a.new_keys,
                                   a.new_used, a.hk, active, a.slots,
                                   a.probe, a.flags, a.claim, buf);
  for (int32_t i = threadIdx.x; i < B; i += SS_BLOCK) {
    const Row r = row_of(a, i);
    if (!(r.add || r.rem) || a.slots[i] < 0) a.slots[i] = K;
  }
  if (threadIdx.x == 0) *a.new_overflow = *a.overflow + lost;
}

// one block: reset segments, and the slots as sort keys
__global__ void __launch_bounds__(SS_BLOCK)
    segments(const __grid_constant__ AggArgs a0) {
  const AggArgs& a = part_args(a0);
  __shared__ int64_t buf[SS_BLOCK];
  int64_t lo, hi, n = 0, total;
  ss::span(a.B, &lo, &hi);
  for (int64_t i = lo; i < hi; ++i)
    n += a.valid[i] && a.kind[i] == RST;
  int64_t run = ss::block_scan_sum(n, buf, &total) - n;
  for (int64_t i = lo; i < hi; ++i) {
    run += a.valid[i] && a.kind[i] == RST;
    a.reset_seg[i] = run;
    a.skeys[i] = (uint32_t)a.slots[i];
  }
  if (threadIdx.x == 0) a.scal[0] = total;   // n_resets
  for (int32_t k = threadIdx.x; k <= a.K; k += SS_BLOCK) {
    a.slot_first[k] = -1;
    a.slot_last[k] = -1;
  }
}

__global__ void sorted_meta(const __grid_constant__ AggArgs a0) {
  const AggArgs& a = part_args(a0);
  const int64_t j = (int64_t)blockIdx.x * T1 + threadIdx.x;
  if (j >= a.B) return;
  const int32_t i = a.perm[j];
  a.inv_perm[i] = (int32_t)j;
  const int32_t s = a.slots[i];
  a.seg_sorted[j] = (int64_t)s * (a.B + 1) + a.reset_seg[i];
  if (j == 0 || a.slots[a.perm[j - 1]] != s) a.slot_first[s] = (int32_t)j;
  if (j == a.B - 1 || a.slots[a.perm[j + 1]] != s) a.slot_last[s] = (int32_t)j;
}

// one block: the first index of each element's run of equal segments
__global__ void __launch_bounds__(SS_BLOCK)
    seg_starts(const __grid_constant__ AggArgs a0) {
  const AggArgs& a = part_args(a0);
  __shared__ int64_t buf[SS_BLOCK];
  int64_t lo, hi, m = 0;
  ss::span(a.B, &lo, &hi);
  for (int64_t j = lo; j < hi; ++j)
    if (j == 0 || a.seg_sorted[j] != a.seg_sorted[j - 1]) m = j;
  const int64_t incl = ss::block_scan_max(m, buf);
  buf[threadIdx.x] = incl;
  __syncthreads();
  int64_t run = threadIdx.x > 0 ? buf[threadIdx.x - 1] : 0;
  for (int64_t j = lo; j < hi; ++j) {
    if (j == 0 || a.seg_sorted[j] != a.seg_sorted[j - 1]) run = j;
    a.seg_start[j] = run;
  }
}

// ------------------------------------------------ the associative-scan tree

template <typename T> struct Elem {
  T v;
  int64_t s;
};

// the combine of one scan: a sum lane adds (segments ignored: the
// segment's prefix is taken off later, as segmented_cumsum does); a
// min/max lane is _segmented_scan's combine
template <typename T>
__device__ __forceinline__ Elem<T> comb(int op, Elem<T> x, Elem<T> y) {
  // operands swapped, as ops/keyed.py cumsum_fast adds them: of two
  // NaNs the left one's propagates, as in the reference's compiled tree
  if (op == LANE_SUM) return {add(y.v, x.v), 0};
  return {x.s == y.s ? combine<T>(op, x.v, y.v) : y.v,
          x.s > y.s ? x.s : y.s};
}

// level 0 (the contributions in slot order) and the tile's levels 1..11
template <typename T>
__global__ void __launch_bounds__(TILE / 2)
    up_tile(const __grid_constant__ AggArgs a0, int l0) {
  const AggArgs& a = part_args(a0);
  __shared__ Elem<T> bufs[2][TILE / 2];
  const int op = a.lane_op[l0];
  T* tv = (T*)a.tree;
  const int64_t base = (int64_t)blockIdx.x * TILE;
  const int t = threadIdx.x;
  for (int q = 0; q < 2; ++q) {   // level 0, two elements a thread
    const int64_t j = base + 2 * t + q;
    if (j < a.B) {
      tv[j] = contrib<T>(a, l0, a.perm[j]);
      a.tree_seg[j] = a.seg_sorted[j];
    }
  }
  __syncthreads();
  int cur = 0;
  for (int l = 1; l <= TILE_LEVELS && l < a.n_levels; ++l) {
    const int64_t width = TILE >> l;
    const int64_t i = (base >> l) + t;
    if (t < width && i < a.level_n[l]) {
      Elem<T> x, y;
      if (l == 1) {
        x = {tv[2 * i], a.tree_seg[2 * i]};
        y = {tv[2 * i + 1], a.tree_seg[2 * i + 1]};
      } else {
        x = bufs[cur ^ 1][2 * t];
        y = bufs[cur ^ 1][2 * t + 1];
      }
      const Elem<T> z = comb<T>(op, x, y);
      bufs[cur][t] = z;
      tv[a.level_off[l] + i] = z.v;
      a.tree_seg[a.level_off[l] + i] = z.s;
    }
    __syncthreads();
    cur ^= 1;
  }
}

// one block: the levels above the tiles
template <typename T>
__global__ void __launch_bounds__(SS_BLOCK)
    up_top(const __grid_constant__ AggArgs a0, int l0) {
  const AggArgs& a = part_args(a0);
  const int op = a.lane_op[l0];
  T* tv = (T*)a.tree;
  for (int l = TILE_LEVELS + 1; l < a.n_levels; ++l) {
    const int64_t o = a.level_off[l], po = a.level_off[l - 1];
    for (int64_t i = threadIdx.x; i < a.level_n[l]; i += SS_BLOCK) {
      const Elem<T> z = comb<T>(
          op, Elem<T>{tv[po + 2 * i], a.tree_seg[po + 2 * i]},
          Elem<T>{tv[po + 2 * i + 1], a.tree_seg[po + 2 * i + 1]});
      tv[o + i] = z.v;
      a.tree_seg[o + i] = z.s;
    }
    __syncthreads();
  }
}

// each element's scan result: its path down the tree (res(l, p) =
// x_l[0] at p == 0; res(l + 1, (p - 1) / 2) at odd p; at even p,
// res(l + 1, p / 2 - 1) combined with x_l[p]), deepest first
template <typename T>
__global__ void down(const __grid_constant__ AggArgs a0, int l0) {
  const AggArgs& a = part_args(a0);
  const int64_t j = (int64_t)blockIdx.x * T1 + threadIdx.x;
  if (j >= a.B) return;
  const int op = a.lane_op[l0];
  const T* tv = (const T*)a.tree;
  int lv[SIDDHI_AGG_MAX_LEVELS];
  int64_t ps[SIDDHI_AGG_MAX_LEVELS];
  int n = 0, l = 0;
  int64_t p = j;
  while (p != 0) {
    if (p & 1) {
      p = (p - 1) >> 1;
    } else {
      lv[n] = l;
      ps[n++] = p;
      p = (p >> 1) - 1;
    }
    ++l;
  }
  Elem<T> acc{tv[a.level_off[l]], a.tree_seg[a.level_off[l]]};
  while (n > 0) {
    --n;
    const int64_t k = a.level_off[lv[n]] + ps[n];
    acc = comb<T>(op, acc, Elem<T>{tv[k], a.tree_seg[k]});
  }
  ((T*)a.res)[j] = plus_zero<T>(acc.v);
}

// a row's running value: the segment's scan, the carry in, unsorted
template <typename T>
__global__ void lane_finish(const __grid_constant__ AggArgs a0, int l0) {
  const AggArgs& a = part_args(a0);
  const int64_t j = (int64_t)blockIdx.x * T1 + threadIdx.x;
  if (j >= a.B) return;
  const int op = a.lane_op[l0];
  const T* res = (const T*)a.res;
  T pref = res[j];
  if (op == LANE_SUM) {
    const int64_t st = a.seg_start[j];
    pref = sub(pref, st > 0 ? res[st - 1] : (T)0);
  }
  const int32_t i = a.perm[j];
  int32_t s = a.slots[i];
  if (s > a.K - 1) s = a.K - 1;
  const T cin = a.reset_seg[i] == 0 ? ((const T*)a.carry[l0])[s]
                                    : identity<T>(op);
  ((T*)a.run[l0])[i] = combine<T>(op, cin, pref);
}

// the new carry of each slot: its rows of the last reset segment folded
// in row order onto the old carry (or the identity after a reset). The
// slot's rows are a contiguous run of the sorted order, and the lane's
// contributions in that order are the tree's level 0, so the walk reads
// contiguous memory.
template <typename T>
__global__ void carries(const __grid_constant__ AggArgs a0, int l0) {
  const AggArgs& a = part_args(a0);
  const int32_t k = blockIdx.x * T1 + threadIdx.x;
  if (k >= a.K) return;
  const int op = a.lane_op[l0];
  const int64_t n_resets = a.scal[0];
  const int64_t last_seg = (int64_t)k * (a.B + 1) + n_resets;
  const T* level0 = (const T*)a.tree;
  T c = n_resets == 0 ? ((const T*)a.carry[l0])[k] : identity<T>(op);
  const int32_t last = a.slot_last[k];
  if (last >= 0 && a.seg_sorted[last] == last_seg) {
    int32_t j = last;
    const int32_t first = a.slot_first[k];
    while (j > first && a.seg_sorted[j - 1] == last_seg) --j;
    for (; j <= last; ++j) c = combine<T>(op, c, level0[j]);
  }
  ((T*)a.new_carry[l0])[k] = c;
}

// ----------------------------------------------------------- the values

template <typename T> __device__ __forceinline__ T run_at(const AggArgs& a,
                                                          int l, int64_t i) {
  return ((const T*)a.run[l])[i];
}

__global__ void values(const __grid_constant__ AggArgs a0) {
  const AggArgs& a = part_args(a0);
  const int64_t i = (int64_t)blockIdx.x * T1 + threadIdx.x;
  if (i >= a.B) return;
  for (int s = 0; s < a.n_specs; ++s) {
    const int l = a.spec_lane0[s];
    void* out = a.out_vals[s];
    bool* nul = a.out_nulls[s];
    switch (a.spec_kind[s]) {
      case AGG_UNION:   // kernel H wrote the set rows
        break;
      case AGG_COUNT:
      case AGG_DISTINCT:
        ((int64_t*)out)[i] = run_at<int64_t>(a, l, i);
        nul[i] = false;
        break;
      case AGG_BOOL: {
        const int64_t t = run_at<int64_t>(a, l, i);
        const int64_t f = run_at<int64_t>(a, l + 1, i);
        ((bool*)out)[i] = a.spec_flag[s] ? f == 0 : t > 0;
        nul[i] = false;
        break;
      }
      case AGG_AVG: {
        const int64_t cnt = run_at<int64_t>(a, l + 1, i);
        const double n = __ll2double_rn(cnt > 1 ? cnt : 1);
        ((double*)out)[i] = cnt == 0 ? 0.0 : flush(__ddiv_rn(
            flush(run_at<double>(a, l, i)), n));
        nul[i] = cnt == 0;
        break;
      }
      case AGG_STDDEV: {
        const int64_t cnt = run_at<int64_t>(a, l + 2, i);
        const double n = __ll2double_rn(cnt > 1 ? cnt : 1);
        const double mean = flush(__ddiv_rn(flush(run_at<double>(a, l, i)),
                                            n));
        const double sq = flush(__ddiv_rn(flush(run_at<double>(a, l + 1, i)),
                                          n));
        const double var = vmax(flush(__fma_rn(-mean, mean, sq)), 0.0);
        ((double*)out)[i] = cnt == 0 ? 0.0 : flush(__dsqrt_rn(var));
        nul[i] = cnt == 0;
        break;
      }
      default: {   // sum, min/max: (value, count), null at count 0
        const int64_t cnt = run_at<int64_t>(a, l + 1, i);
        nul[i] = cnt == 0;
        switch (a.out_type[s]) {
          case VT_INT:
            ((int32_t*)out)[i] = cnt == 0 ? 0 : run_at<int32_t>(a, l, i);
            break;
          case VT_LONG:
            ((int64_t*)out)[i] = cnt == 0 ? 0 : run_at<int64_t>(a, l, i);
            break;
          case VT_FLOAT:
            ((float*)out)[i] = cnt == 0 ? 0.0f : run_at<float>(a, l, i);
            break;
          default:
            ((double*)out)[i] = cnt == 0 ? 0.0 : run_at<double>(a, l, i);
        }
      }
    }
  }
}

inline int grid(int64_t n) { return (int)((n + T1 - 1) / T1); }

// a launch's grid: n rows of T1 threads, one row of blocks per
// partition slot (blockIdx.y)
inline dim3 rows(int64_t n, int64_t parts) {
  return dim3(grid(n), (unsigned)parts);
}

template <typename T>
void lane(const AggArgs& a, int l, cudaStream_t stream) {
  const unsigned parts = (unsigned)a.n_part;
  up_tile<T><<<dim3((unsigned)((a.B + TILE - 1) / TILE), parts), TILE / 2,
               0, stream>>>(a, l);
  if (a.n_levels > TILE_LEVELS + 1)
    up_top<T><<<dim3(1, parts), SS_BLOCK, 0, stream>>>(a, l);
  down<T><<<rows(a.B, parts), T1, 0, stream>>>(a, l);
  lane_finish<T><<<rows(a.B, parts), T1, 0, stream>>>(a, l);
  carries<T><<<rows(a.K, parts), T1, 0, stream>>>(a, l);
}

// ------------------------------------------------------------- emission

__global__ void __launch_bounds__(SS_BLOCK)
    emit_chunks(const __grid_constant__ EmitArgs a0) {   // one block, batch
  const EmitArgs& a = part_args(a0);
  __shared__ int64_t buf[SS_BLOCK];
  int64_t lo, hi, m = -1, n = 0;
  ss::span(a.B, &lo, &hi);
  for (int64_t i = lo; i < hi; ++i)
    if (a.valid[i]) m = i;
  const int64_t incl = ss::block_scan_max(m, buf);
  buf[threadIdx.x] = incl;
  __syncthreads();
  int64_t prev = threadIdx.x > 0 ? buf[threadIdx.x - 1] : -1;
  __syncthreads();
  // boundaries: the first valid row, and an EXPIRED/RESET row after a
  // CURRENT one
  for (int64_t i = lo; i < hi; ++i) {
    const int32_t k = a.kind[i];
    const bool b = a.valid[i] && (prev < 0 || ((k == EXP || k == RST) &&
                                               a.kind[prev] == CUR));
    a.flag[i] = b;
    n += b;
    if (a.valid[i]) prev = i;
  }
  int64_t run = ss::block_scan_sum(n, buf, nullptr) - n;
  for (int64_t i = lo; i < hi; ++i) {
    run += a.flag[i];
    a.chunk[i] = run;
    const bool q = a.qual[i] && a.slots[i] < a.K;
    a.qkeys[i] = q ? (uint32_t)((int64_t)a.slots[i] * (a.B + 1) + run)
                   : 0x7fffffffu;
  }
}

// batch mode: the last row of each (slot, chunk) run and its first row
__global__ void __launch_bounds__(SS_BLOCK)
    emit_groups(const __grid_constant__ EmitArgs a0) {   // one block
  const EmitArgs& a = part_args(a0);
  __shared__ int64_t buf[SS_BLOCK];
  int64_t lo, hi, m = 0;
  ss::span(a.B, &lo, &hi);
  const uint32_t* qk = a.qkeys;
  const int32_t* p2 = a.perm2;
  for (int64_t j = lo; j < hi; ++j)
    if (j == 0 || qk[p2[j]] != qk[p2[j - 1]]) m = j;
  const int64_t incl = ss::block_scan_max(m, buf);
  buf[threadIdx.x] = incl;
  __syncthreads();
  int64_t gs = threadIdx.x > 0 ? buf[threadIdx.x - 1] : 0;
  for (int64_t j = lo; j < hi; ++j) {
    const uint32_t k = qk[p2[j]];
    if (j == 0 || k != qk[p2[j - 1]]) gs = j;
    const bool last = j == a.B - 1 || k != qk[p2[j + 1]];
    a.ovalid[p2[j]] = last && k < 0x7fffffffu;
    // with an order-by the qualifying rows stay in row order (kernel G
    // sorts them after)
    a.emit_order[p2[j]] = a.keep_order ? p2[j] : p2[gs];
  }
}

__global__ void emit_plain(const __grid_constant__ EmitArgs a0) {
  const EmitArgs& a = part_args(a0);
  const int64_t i = (int64_t)blockIdx.x * T1 + threadIdx.x;
  if (i >= a.B) return;
  a.ovalid[i] = a.qual[i] && a.slots[i] < a.K;
  a.emit_order[i] = (int32_t)i;
}

// one block: each row's output place. The valid rows go first, ordered
// by their emit_order (distinct: a group's first row), the others after
// in row order.
__global__ void __launch_bounds__(SS_BLOCK)
    emit_place(const __grid_constant__ EmitArgs a0) {
  const EmitArgs& a = part_args(a0);
  __shared__ int64_t buf[SS_BLOCK];
  int64_t lo, hi;
  ss::span(a.B, &lo, &hi);
  for (int64_t i = lo; i < hi; ++i) a.flag[i] = 0;
  __syncthreads();
  for (int64_t i = lo; i < hi; ++i)
    if (a.ovalid[i]) a.flag[a.emit_order[i]] = 1;
  __syncthreads();
  int64_t nv = 0, ni = 0, total_v;
  for (int64_t i = lo; i < hi; ++i) {
    nv += a.flag[i];
    ni += !a.ovalid[i];
  }
  int64_t rv = ss::block_scan_sum(nv, buf, &total_v) - nv;
  int64_t ri = ss::block_scan_sum(ni, buf, nullptr) - ni;
  // flag[e] -> rank of emit order e among the valid rows
  for (int64_t i = lo; i < hi; ++i) {
    const int32_t f = a.flag[i];
    a.flag[i] = (int32_t)rv;
    rv += f;
  }
  __syncthreads();
  for (int64_t i = lo; i < hi; ++i) {
    if (a.ovalid[i]) {
      a.pos[i] = a.flag[a.emit_order[i]];
    } else {
      a.pos[i] = (int32_t)(total_v + ri);
      ++ri;
    }
  }
  if (threadIdx.x == 0) {
    int64_t kept = total_v;
    const int64_t off = a.offset > 0 ? a.offset : 0;
    kept = kept > off ? kept - off : 0;
    if (a.limit >= 0 && kept > a.limit) kept = a.limit;
    a.scal[0] = total_v;
    if (a.emitted)   // shared by a partition block's slots
      atomicAdd((unsigned long long*)a.emitted, (unsigned long long)kept);
  }
}

__global__ void emit_gather(const __grid_constant__ EmitArgs a0) {
  const EmitArgs& a = part_args(a0);
  const int64_t i = (int64_t)blockIdx.x * T1 + threadIdx.x;
  if (i >= a.B) return;
  const int64_t q = a.pos[i];
  bool v = a.ovalid[i];
  if (v && a.offset >= 0) v = q >= a.offset;
  if (v && a.limit >= 0) v = q < (a.offset > 0 ? a.offset : 0) + a.limit;
  a.out_ts[q] = a.ts[i];
  a.out_kind[q] = a.kind[i];
  a.out_valid[q] = v;
  for (int c = 0; c < a.n_cols; ++c) {
    copy_row(a.out_cols[c], q, a.cols[c], i, a.col_size[c]);
    a.out_nulls[c][q] = a.nulls[c][i];
  }
}

}  // namespace

extern "C" cudaError_t siddhi_aggregate_step(const AggArgs* p,
                                             cudaStream_t stream,
                                             int32_t part) {
  const AggArgs& a = *p;
  const int64_t parts = a.n_part;   // partition slots, 1 outside a block
  const dim3 one(1, (unsigned)parts);
  if (part & 1) {
    if (a.grouped) hash_rows<<<rows(a.B, parts), T1, 0, stream>>>(a);
    probe<<<one, SS_BLOCK, 0, stream>>>(a);
    segments<<<one, SS_BLOCK, 0, stream>>>(a);
    cudaError_t err = ss::stable_sort(a.skeys, a.B, ss::key_bits(a.K),
                                      a.perm, a.k1, a.k2, a.i1, a.i2,
                                      a.counts, stream, parts);
    if (err != cudaSuccess) return err;
    sorted_meta<<<rows(a.B, parts), T1, 0, stream>>>(a);
    seg_starts<<<one, SS_BLOCK, 0, stream>>>(a);
  }
  if (part & 2) {
    for (int l = 0; l < a.n_lanes; ++l) {
      const int k = a.spec_kind[a.lane_spec[l]];
      // C, D; H's lane only carries the reference's [K] carry along
      if (k == AGG_SLIDING || k == AGG_DISTINCT || k == AGG_UNION) continue;
      switch (a.lane_type[l]) {
        case VT_INT: lane<int32_t>(a, l, stream); break;
        case VT_LONG: lane<int64_t>(a, l, stream); break;
        case VT_FLOAT: lane<float>(a, l, stream); break;
        default: lane<double>(a, l, stream);
      }
    }
    values<<<rows(a.B, parts), T1, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

namespace {

// ---------------------------------------------------- kernel C: min/max
//
// Replaces the reference's SlidingMinMaxAgg.run (siddhi_tpu/ops/
// aggregators.py:511). A key's live values are a contiguous sequence
// range [head, tail) of its ring (FIFO expiry); each row's extreme is a
// bottom-up range query over an implicit segment tree of its key's ring
// (index 1 the root, the ring at [W, 2W)), over the two non-wrapping
// leaf ranges of its live range. The tree is indexed in place: no row
// gathers its key's whole tree. Bound: the rings and trees (K * 3W
// values) and a query of 2 log2(W) + 2 reads a row.

__device__ __forceinline__ int64_t fmod_pos(int64_t x, int64_t m) {
  int64_t r = x % m;
  return r < 0 ? r + m : r;
}

// the inclusive prefix, in slot order, of the rows' adds (r0) and
// removes (r1), one block
__global__ void mm_prefix(const AggArgs a, const StatArgs st) {
  __shared__ int64_t buf[SS_BLOCK];
  int64_t lo, hi, na = 0, nr = 0;
  ss::span(a.B, &lo, &hi);
  auto add_rem = [&](int64_t j, int64_t* ad, int64_t* rm) {
    const int32_t i = a.perm[j];
    const Row r = row_of(a, i);
    const bool live = a.slots[i] < a.K && !st.arg_null[i];
    *ad = r.add && live;
    *rm = r.rem && live;
  };
  for (int64_t j = lo; j < hi; ++j) {
    int64_t x, y;
    add_rem(j, &x, &y);
    na += x;
    nr += y;
  }
  int64_t ra = ss::block_scan_sum(na, buf, nullptr) - na;
  int64_t rr = ss::block_scan_sum(nr, buf, nullptr) - nr;
  for (int64_t j = lo; j < hi; ++j) {
    int64_t x, y;
    add_rem(j, &x, &y);
    ra += x;
    rr += y;
    st.r0[j] = ra;
    st.r1[j] = rr;
  }
  if (threadIdx.x == 0) *st.count = 0;
}

// a row's rank among its slot's rows (inclusive), from a prefix
__device__ __forceinline__ int64_t seg_rank(const AggArgs& a,
                                            const int64_t* pref, int32_t s,
                                            int64_t j) {
  const int32_t f = a.slot_first[s];
  return pref[j] - (f > 0 ? pref[f - 1] : 0);
}

// per key: its adds and removes in the batch; the ring copied
template <typename T>
__global__ void mm_keys(const AggArgs a, const StatArgs st) {
  const int64_t x = (int64_t)blockIdx.x * T1 + threadIdx.x;
  if (x < (int64_t)a.K * st.W)
    ((T*)st.new_ring)[x] = ((const T*)st.ring)[x];
  if (x >= a.K) return;
  const int32_t f = a.slot_first[x], l = a.slot_last[x];
  int64_t na = 0, nr = 0;
  if (f >= 0) {
    na = st.r0[l] - (f > 0 ? st.r0[f - 1] : 0);
    nr = st.r1[l] - (f > 0 ? st.r1[f - 1] : 0);
  }
  st.ksum[x] = na;
  st.ksum[a.K + x] = nr;
}

struct MmRow {
  int32_t s;                 // the key's slot, clipped
  bool add;
  int64_t tail_row, head_eff, end_tail;
};

__device__ __forceinline__ MmRow mm_row(const AggArgs& a, const StatArgs& st,
                                        int32_t i) {
  const int32_t us = a.slots[i];
  MmRow m;
  m.s = us > a.K - 1 ? a.K - 1 : us;
  const Row r = row_of(a, i);
  m.add = r.add && us < a.K && !st.arg_null[i];
  const int64_t j = a.inv_perm[i];
  const int64_t add_rank = seg_rank(a, st.r0, us, j);
  const int64_t rem_rank = seg_rank(a, st.r1, us, j);
  const int64_t* heads0 = a.scal[0] > 0 ? st.tails : st.heads;
  m.tail_row = st.tails[m.s] + add_rank;
  const int64_t head_row = heads0[m.s] + rem_rank;
  const int64_t over = m.tail_row - head_row - st.W;
  m.head_eff = head_row + (over > 0 ? over : 0);
  m.end_tail = st.tails[m.s] + st.ksum[m.s];
  return m;
}

// the batch's added values into the rings: of two adds of a key W apart
// the later one stays, as the reference's in-order scatter leaves it
template <typename T>
__global__ void mm_scatter(const AggArgs a, const StatArgs st) {
  const int32_t i = blockIdx.x * T1 + threadIdx.x;
  if (i >= a.B) return;
  const MmRow m = mm_row(a, st, i);
  if (!m.add || m.tail_row <= m.end_tail - st.W) return;
  ((T*)st.new_ring)[(int64_t)m.s * st.W + fmod_pos(m.tail_row - 1, st.W)] =
      ((const T*)st.arg)[i];
}

// one block a key: the tree, level by level (cur[0::2] with cur[1::2])
template <typename T>
__global__ void mm_tree(const AggArgs a, const StatArgs st, int op) {
  const int64_t W = st.W;
  T* tree = (T*)st.tree + (int64_t)blockIdx.x * 2 * W;
  const T* ring = (const T*)st.new_ring + (int64_t)blockIdx.x * W;
  for (int64_t w = threadIdx.x; w < W; w += blockDim.x) tree[W + w] = ring[w];
  if (threadIdx.x == 0) tree[0] = identity<T>(op);
  __syncthreads();
  for (int64_t n = W / 2; n >= 1; n /= 2) {
    for (int64_t q = threadIdx.x; q < n; q += blockDim.x)
      tree[n + q] = combine<T>(op, tree[2 * (n + q)], tree[2 * (n + q) + 1]);
    __syncthreads();
  }
}

// the bottom-up range query over leaves [a0, b0) of one key's tree
template <typename T>
__device__ __forceinline__ T rmq(const T* tree, int op, int64_t W,
                                 int levels, int64_t a0, int64_t b0) {
  T res = identity<T>(op);
  int64_t li = a0 + W, ri = b0 + W;
  for (int k = 0; k <= levels; ++k) {
    if (li < ri && (li & 1)) {
      res = combine<T>(op, res, tree[li]);
      ++li;
    }
    if (li < ri && (ri & 1)) {
      res = combine<T>(op, res, tree[ri - 1]);
      --ri;
    }
    li >>= 1;
    ri >>= 1;
  }
  return res;
}

template <typename T>
__global__ void mm_query(const AggArgs a, const StatArgs st, int l0, int op,
                         int levels) {
  const int32_t i = blockIdx.x * T1 + threadIdx.x;
  if (i >= a.B) return;
  const MmRow m = mm_row(a, st, i);
  const int64_t W = st.W;
  const T* tree = (const T*)st.tree + (int64_t)m.s * 2 * W;
  const int64_t d = m.tail_row - m.head_eff;
  const int64_t span = d > 0 ? d : 0;
  const int64_t h = fmod_pos(m.head_eff, W);
  const int64_t end = h + (span < W ? span : W);
  const T r1 = rmq<T>(tree, op, W, levels, h, end < W ? end : W);
  const T r2 = rmq<T>(tree, op, W, levels, 0, end - W > 0 ? end - W : 0);
  ((T*)a.run[l0])[i] = combine<T>(op, r1, r2);
  ((int64_t*)a.run[l0 + 1])[i] = span;
  if (a.slots[i] < a.K && m.end_tail - m.head_eff > W)
    atomicAdd(st.count, 1ull);
}

__global__ void mm_finish(const AggArgs a, const StatArgs st) {
  const int32_t k = blockIdx.x * T1 + threadIdx.x;
  if (k == 0) *st.new_overflow = *st.overflow + (int64_t)*st.count;
  if (k >= a.K) return;
  const int64_t h0 = a.scal[0] > 0 ? st.tails[k] : st.heads[k];
  const int64_t nt = st.tails[k] + st.ksum[k];
  const int64_t nh = h0 + st.ksum[a.K + k];
  st.new_tails[k] = nt;
  st.new_heads[k] = nh > nt - st.W ? nh : nt - st.W;
}

template <typename T>
cudaError_t sliding(const AggArgs& a, const StatArgs& st,
                    cudaStream_t stream) {
  const int l0 = a.spec_lane0[st.spec];
  const int op = a.lane_op[l0];
  int levels = 0;
  while ((1 << (levels + 1)) <= st.W) ++levels;
  mm_prefix<<<1, SS_BLOCK, 0, stream>>>(a, st);
  const int64_t kw = (int64_t)a.K * st.W;
  mm_keys<T><<<grid(kw > a.K ? kw : a.K), T1, 0, stream>>>(a, st);
  mm_scatter<T><<<grid(a.B), T1, 0, stream>>>(a, st);
  mm_tree<T><<<a.K, T1, 0, stream>>>(a, st, op);
  mm_query<T><<<grid(a.B), T1, 0, stream>>>(a, st, l0, op, levels);
  mm_finish<<<grid(a.K), T1, 0, stream>>>(a, st);
  return cudaGetLastError();
}

// -------------------------------------------- kernel D: distinctCount
//
// Replaces the reference's DistinctCountAgg.run (siddhi_tpu/ops/
// aggregators.py:306). Each row's (group slot, value) pair is found or
// placed in a table of D pairs by K6's own probe rounds; the rows sorted
// by (pair, reset segment) (a stable radix sort) give each row's running
// pair count, whose 0<->1 transitions are the lane's contributions; the
// lane then runs K6's own scan and carry over (group, reset). Pair
// slots are never freed. Bound: the B-row passes and the sort, a few
// words a row.

__global__ void dc_hash(const AggArgs a, const StatArgs st) {
  const int32_t i = blockIdx.x * T1 + threadIdx.x;
  if (i >= a.B) return;
  int64_t lane;
  switch (st.arg_type) {
    case VT_DOUBLE:
      lane = __double_as_longlong(((const double*)st.arg)[i]);
      break;
    case VT_FLOAT:
      lane = __float_as_int(((const float*)st.arg)[i]);
      break;
    default: lane = int_at(st.arg, st.arg_type, i);
  }
  if (st.arg_null[i]) lane = -987654321987654321LL;
  st.r0[i] = kd::mix64(kd::mix64(1469598103934665603LL, a.slots[i]), lane);
  st.flags[i] = a.slots[i] < a.K;   // active: an aggregated row
}

__global__ void dc_probe(const AggArgs a, const StatArgs st) {
  __shared__ int64_t buf[SS_BLOCK];
  // the activity bytes move aside: the probe reuses the flags
  uint8_t* active = (uint8_t*)st.pkeys;
  for (int32_t i = threadIdx.x; i < a.B; i += SS_BLOCK)
    active[i] = st.flags[i];
  __syncthreads();
  const int64_t lost = kd::probe_table(a.B, st.D, st.keys, st.used,
                                       st.new_keys, st.new_used, st.r0,
                                       active, st.i0, st.i1, st.flags,
                                       st.claim, buf);
  if (threadIdx.x == 0) *st.new_overflow = *st.overflow + lost;
}

// each row's pair segment as a sort key; the new counts' base
__global__ void dc_keys(const AggArgs a, const StatArgs st) {
  const int32_t x = blockIdx.x * T1 + threadIdx.x;
  if (x < st.D)
    st.new_counts[x] = a.scal[0] == 0 ? st.counts[x] : 0;
  if (x >= a.B) return;
  const bool tracked = a.slots[x] < a.K && st.i0[x] >= 0;
  const int64_t ps = st.i0[x] < 0 ? 0 : st.i0[x];
  const int64_t seg = (tracked ? ps : st.D) * (a.B + 1) + a.reset_seg[x];
  st.pkeys[x] = (uint32_t)(seg < 0x7fffffffLL ? seg : 0x7fffffffLL);
}

__device__ __forceinline__ int64_t dc_sgn(const AggArgs& a,
                                          const StatArgs& st, int32_t i) {
  const Row r = row_of(a, i);
  const bool tracked = a.slots[i] < a.K && st.i0[i] >= 0;
  return tracked ? (r.add ? 1 : (r.rem ? -1 : 0)) : 0;
}

// one block: the running pair counts (a segmented prefix over the pair
// order), each row's transition, the new pair counts
__global__ void dc_scan(const AggArgs a, const StatArgs st) {
  __shared__ int64_t buf[SS_BLOCK];
  int64_t lo, hi, n = 0, m = 0;
  ss::span(a.B, &lo, &hi);
  const uint32_t* k = st.pkeys;
  const int32_t* p2 = st.perm2;
  for (int64_t j = lo; j < hi; ++j) {
    n += dc_sgn(a, st, p2[j]);
    if (j == 0 || k[p2[j]] != k[p2[j - 1]]) m = j;
  }
  int64_t run = ss::block_scan_sum(n, buf, nullptr) - n;
  const int64_t st_incl = ss::block_scan_max(m, buf);
  buf[threadIdx.x] = st_incl;
  __syncthreads();
  int64_t gs = threadIdx.x > 0 ? buf[threadIdx.x - 1] : 0;
  for (int64_t j = lo; j < hi; ++j) {
    run += dc_sgn(a, st, p2[j]);
    st.r1[j] = run;
    if (j == 0 || k[p2[j]] != k[p2[j - 1]]) gs = j;
    st.seg2[j] = gs;
  }
  __syncthreads();
  const int64_t nres = a.scal[0];
  for (int64_t j = lo; j < hi; ++j) {
    const int32_t i = p2[j];
    const int64_t g = st.seg2[j];
    const int64_t rs = st.r1[j] - (g > 0 ? st.r1[g - 1] : 0);
    const bool tracked = a.slots[i] < a.K && st.i0[i] >= 0;
    const int64_t ps = st.i0[i] < 0 ? 0 : st.i0[i];
    const int64_t carry = a.reset_seg[i] == 0 && tracked ? st.counts[ps] : 0;
    const int64_t rn = rs + carry;
    st.r3[i] = rn;
    const Row r = row_of(a, i);
    st.r2[i] = (tracked && r.add && rn == 1) ? 1
               : ((tracked && r.rem && rn == 0) ? -1 : 0);
    const bool last = j == a.B - 1 || k[p2[j + 1]] != k[i];
    if (last && tracked && a.reset_seg[i] == nres) st.new_counts[ps] = rn;
  }
}

cudaError_t distinct(const AggArgs& a, const StatArgs& st,
                     cudaStream_t stream) {
  dc_hash<<<grid(a.B), T1, 0, stream>>>(a, st);
  dc_probe<<<1, SS_BLOCK, 0, stream>>>(a, st);
  dc_keys<<<grid(a.B > st.D ? a.B : st.D), T1, 0, stream>>>(a, st);
  const uint64_t max_key = (uint64_t)st.D * (a.B + 1) + a.B;
  cudaError_t err = ss::stable_sort(st.pkeys, a.B, ss::key_bits(max_key),
                                    st.perm2, a.k1, a.k2, a.i1, a.i2,
                                    a.counts, stream);
  if (err != cudaSuccess) return err;
  dc_scan<<<1, SS_BLOCK, 0, stream>>>(a, st);
  lane<int64_t>(a, a.spec_lane0[st.spec], stream);
  return cudaGetLastError();
}

}  // namespace

extern "C" cudaError_t siddhi_sliding_minmax(const AggArgs* p,
                                             const StatArgs* q,
                                             cudaStream_t stream) {
  switch (p->lane_type[p->spec_lane0[q->spec]]) {
    case VT_INT: return sliding<int32_t>(*p, *q, stream);
    case VT_LONG: return sliding<int64_t>(*p, *q, stream);
    case VT_FLOAT: return sliding<float>(*p, *q, stream);
    default: return sliding<double>(*p, *q, stream);
  }
}

extern "C" cudaError_t siddhi_distinct_count(const AggArgs* p,
                                             const StatArgs* q,
                                             cudaStream_t stream) {
  return distinct(*p, *q, stream);
}

extern "C" cudaError_t siddhi_aggregate_emit(const EmitArgs* p,
                                             cudaStream_t stream) {
  const EmitArgs& a = *p;
  const int64_t parts = a.n_part;   // partition slots, 1 outside a block
  const dim3 one(1, (unsigned)parts);
  if (a.batch_mode) {
    emit_chunks<<<one, SS_BLOCK, 0, stream>>>(a);
    cudaError_t err = ss::stable_sort(a.qkeys, a.B, 31, a.perm2, a.k1, a.k2,
                                      a.i1, a.i2, a.counts, stream, parts);
    if (err != cudaSuccess) return err;
    emit_groups<<<one, SS_BLOCK, 0, stream>>>(a);
  } else {
    emit_plain<<<rows(a.B, parts), T1, 0, stream>>>(a);
  }
  emit_place<<<one, SS_BLOCK, 0, stream>>>(a);
  emit_gather<<<rows(a.B, parts), T1, 0, stream>>>(a);
  return cudaGetLastError();
}
