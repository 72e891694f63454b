// Kernel K11: an incremental aggregation's bucket step
// (core/aggregation.py aggregation_step).
//
// Replaces the reference's AggregationRuntime._make_step (siddhi_tpu/
// core/aggregation.py:248-317, jitted at :244) with bucket_start (:86)
// and its civil-calendar helpers (:61, :76), and its group table
// (siddhi_tpu/ops/keyed.py hash_columns :33, lookup_or_insert :50). The
// group-by and argument expressions before it are kernel K2's.
//
// One step, every duration at once (a block a duration, blockIdx.x, or
// a block row a duration, blockIdx.z), three stages and no host sync:
//   1. bucket_probe (one block a duration): the untouched state copied
//      into the new one; each row's bucket start (floor division
//      throughout, as jnp's // floors), the key hash of (bucket start,
//      group values) and the 16 probe rounds of keyed.cuh probe_table
//      over the 4,096 slots, the rows lost added to the overflow;
//   2. a stable radix sort of the rows by slot (sort_scan.cuh, one sort a
//      duration), the rows without a slot last;
//   3. fold (a thread a sorted row): the first row of each slot's run
//      folds the run in row order, as the reference's serial scatter
//      applies duplicate slots: the bucket start and the group values of
//      the last row; count, ncount and integer sums as wrapping adds;
//      float sums through lane_math.cuh add (a null argument adds +0.0);
//      min and max through XLA's minimum/maximum (a null argument gives
//      the lane's identity). A float sum cannot take atomicAdd: only row
//      order gives the reference's bits.
//
// Bound: the step reads the batch's columns and the [D, K] state once and
// writes the new state; its arithmetic is a few dozen integer operations
// a row and duration. The probe is one block a duration and the fold one
// thread a slot (a coarse duration folds its few slots' many rows
// serially): the design is simple first, not fast.
//
// K11[K], a tenant pool's aggregation class (the reference's agg_body
// under jax.vmap, siddhi_tpu/serving/pool.py:1288-1295): the same three
// stages over every slot in one launch sequence, the slot as blockIdx.y
// (part_args moves each slot's batch, state and scratch pointers); each
// slot keeps its own 4,096-slot table and overflow per duration, and the
// sort runs one segment a (slot, duration).
#include "keyed.cuh"
#include "lane_math.cuh"
#include "siddhi_kernels.h"
#include "sort_scan.cuh"

namespace {

using namespace lm;

constexpr int32_t CUR = 0;   // core/event.py CURRENT
constexpr int T1 = 256;

inline int grid(int64_t n) { return (int)((n + T1 - 1) / T1); }

// a // b for b > 0, rounding toward negative infinity
__device__ __forceinline__ int64_t fdiv(int64_t a, int64_t b) {
  const int64_t q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}
__device__ __forceinline__ int64_t wmul(int64_t a, int64_t b) {
  return (int64_t)((uint64_t)a * (uint64_t)b);   // int64 wraps, as in jnp
}

// the reference's _days_from_civil, term by term
__device__ __forceinline__ int64_t days_from_civil(int64_t y, int64_t m,
                                                   int64_t d) {
  y = m <= 2 ? y - 1 : y;
  const int64_t era = fdiv(y >= 0 ? y : y - 399, 400);
  const int64_t yoe = y - era * 400;
  const int64_t mp = m > 2 ? m - 3 : m + 9;
  const int64_t doy = fdiv(153 * mp + 2, 5) + d - 1;
  const int64_t doe = yoe * 365 + fdiv(yoe, 4) - fdiv(yoe, 100) + doy;
  return era * 146097 + doe - 719468;
}

__device__ __forceinline__ int64_t bucket_start(int64_t ts, int dur) {
  switch (dur) {
    case DUR_SECONDS: return wmul(fdiv(ts, 1000), 1000);
    case DUR_MINUTES: return wmul(fdiv(ts, 60000), 60000);
    case DUR_HOURS: return wmul(fdiv(ts, 3600000), 3600000);
    case DUR_DAYS: return wmul(fdiv(ts, 86400000), 86400000);
    default: break;
  }
  // the reference's _civil_from_days
  int64_t z = fdiv(ts, 86400000) + 719468;
  const int64_t era = fdiv(z >= 0 ? z : z - 146096, 146097);
  const int64_t doe = z - era * 146097;
  const int64_t yoe = fdiv(doe - fdiv(doe, 1460) + fdiv(doe, 36524) -
                           fdiv(doe, 146096), 365);
  int64_t y = yoe + era * 400;
  const int64_t doy = doe - (365 * yoe + fdiv(yoe, 4) - fdiv(yoe, 100));
  const int64_t mp = fdiv(5 * doy + 2, 153);
  const int64_t m = mp < 10 ? mp + 3 : mp - 9;
  y = m <= 2 ? y + 1 : y;
  const int64_t d0 = dur == DUR_MONTHS ? days_from_civil(y, m, 1)
                                       : days_from_civil(y, 1, 1);
  return wmul(d0, 86400000);
}

// an argument as its lane's accumulator type (the reference's astype)
__device__ __forceinline__ int64_t arg_i64(const void* col, int type,
                                           int64_t i) {
  switch (type) {
    case VT_LONG: return ((const int64_t*)col)[i];
    case VT_BOOL: return ((const bool*)col)[i];
    default: return ((const int32_t*)col)[i];   // INT, STRING codes
  }
}
__device__ __forceinline__ double arg_f64(const void* col, int type,
                                          int64_t i) {
  switch (type) {
    case VT_DOUBLE: return ((const double*)col)[i];
    case VT_FLOAT: return (double)flush(((const float*)col)[i]);
    case VT_LONG: return __ll2double_rn(((const int64_t*)col)[i]);
    case VT_BOOL: return ((const bool*)col)[i] ? 1.0 : 0.0;
    default: return (double)((const int32_t*)col)[i];
  }
}

__device__ __forceinline__ void copy_val(void* dst, int64_t to,
                                         const void* src, int64_t from,
                                         int size) {
  if (size == 8)
    ((int64_t*)dst)[to] = ((const int64_t*)src)[from];
  else if (size == 4)
    ((int32_t*)dst)[to] = ((const int32_t*)src)[from];
  else
    ((uint8_t*)dst)[to] = ((const uint8_t*)src)[from];
}

__global__ void __launch_bounds__(SS_BLOCK)
    bucket_probe(const __grid_constant__ AggrArgs a0) {
  const AggrArgs& a = part_args(a0);
  __shared__ int64_t buf[SS_BLOCK];
  const int d = blockIdx.x;
  const int32_t B = a.B, K = a.K;
  const int64_t rb = (int64_t)d * B, sb = (int64_t)d * K;
  for (int32_t k = threadIdx.x; k < K; k += SS_BLOCK) {
    a.new_bstart[sb + k] = a.bstart[sb + k];
    for (int g = 0; g < a.n_groups; ++g) {
      copy_val(a.new_groups[g], sb + k, a.groups[g], sb + k, a.gsize[g]);
      a.new_gnulls[g][sb + k] = a.gnulls[g][sb + k];
    }
    for (int l = 0; l < a.n_lanes; ++l)
      ((int64_t*)a.new_lanes[l])[sb + k] =
          ((const int64_t*)a.lanes[l])[sb + k];
  }
  for (int32_t i = threadIdx.x; i < B; i += SS_BLOCK) {
    const int64_t bs = bucket_start(a.ets[i], a.dur[d]);
    int64_t h = kd::mix64(kd::HASH_SEED, bs);
    for (int g = 0; g < a.n_groups; ++g)
      h = kd::mix64(h, kd::key_lane(a.gcol[g], a.gtype[g], a.gnull[g], i));
    a.bs[rb + i] = bs;
    a.hk[rb + i] = h;
    a.active[rb + i] = a.valid[i] && a.kind[i] == CUR;
  }
  __syncthreads();
  const int64_t lost = kd::probe_table(
      B, K, a.keys + sb, a.used + sb, a.new_keys + sb, a.new_used + sb,
      a.hk + rb, a.active + rb, a.slot + rb, a.prb + rb, a.flags + rb,
      a.claim + sb, buf);
  for (int32_t i = threadIdx.x; i < B; i += SS_BLOCK) {
    const int32_t s = a.slot[rb + i];
    a.skey[rb + i] = s >= 0 ? (uint32_t)s : (uint32_t)K;
  }
  if (threadIdx.x == 0) a.new_overflow[d] = a.overflow[d] + lost;
}

__global__ void __launch_bounds__(T1)
    fold(const __grid_constant__ AggrArgs a0) {
  const AggrArgs& a = part_args(a0);
  const int d = blockIdx.z;
  const int32_t B = a.B, K = a.K;
  const int32_t j = blockIdx.x * T1 + threadIdx.x;
  if (j >= B) return;
  const int64_t rb = (int64_t)d * B, sb = (int64_t)d * K;
  const int32_t* perm = a.perm + rb;
  const uint32_t* skey = a.skey + rb;
  const uint32_t s = skey[perm[j]];
  if (s >= (uint32_t)K) return;                      // no slot: sorted last
  if (j > 0 && skey[perm[j - 1]] == s) return;       // not a run's first
  int32_t e = j + 1;
  while (e < B && skey[perm[e]] == s) ++e;
  const int64_t at = sb + s;
  const int32_t last = perm[e - 1];                  // the set lanes' row
  a.new_bstart[at] = a.bs[rb + last];
  for (int g = 0; g < a.n_groups; ++g) {
    copy_val(a.new_groups[g], at, a.gcol[g], last, a.gsize[g]);
    a.new_gnulls[g][at] = a.gnull[g][last];
  }
  for (int l = 0; l < a.n_lanes; ++l) {
    const int kind = a.lane_kind[l];
    const void* col = a.arg[l];
    const bool* nul = a.arg_null[l];
    const int type = a.arg_type[l];
    if (a.lane_f64[l]) {
      double* lane = (double*)a.new_lanes[l];
      double acc = lane[at];
      for (int32_t q = j; q < e; ++q) {
        const int32_t r = perm[q];
        const bool eff = !nul[r];
        if (kind == AGGR_SUM) {
          acc = add(acc, eff ? arg_f64(col, type, r) : 0.0);
        } else if (kind == AGGR_MIN) {
          acc = vmin(acc, eff ? arg_f64(col, type, r)
                              : __longlong_as_double(0x7ff0000000000000LL));
        } else {
          acc = vmax(acc, eff ? arg_f64(col, type, r)
                              : __longlong_as_double(
                                    (long long)0xfff0000000000000ULL));
        }
      }
      lane[at] = acc;
      continue;
    }
    int64_t* lane = (int64_t*)a.new_lanes[l];
    int64_t acc = lane[at];
    for (int32_t q = j; q < e; ++q) {
      const int32_t r = perm[q];
      const bool eff = kind == AGGR_COUNT || !nul[r];
      switch (kind) {
        case AGGR_COUNT: case AGGR_NCOUNT: acc = add(acc, (int64_t)eff);
          break;
        case AGGR_SUM: acc = add(acc, eff ? arg_i64(col, type, r) : 0);
          break;
        case AGGR_MIN: acc = vmin(acc, eff ? arg_i64(col, type, r)
                                           : INT64_MAX);
          break;
        default: acc = vmax(acc, eff ? arg_i64(col, type, r) : INT64_MIN);
      }
    }
    lane[at] = acc;
  }
}

}  // namespace

extern "C" cudaError_t siddhi_aggregation_step(const AggrArgs* p,
                                               cudaStream_t stream) {
  const AggrArgs& a = *p;
  const int64_t S = a.n_part;   // tenant pool slots, 1 for one table set
  bucket_probe<<<dim3(a.D, (unsigned)S), SS_BLOCK, 0, stream>>>(a);
  // one sort a (slot, duration): S * D segments of B rows, at most
  // 65,535 (gridDim.y's limit) a call
  const int64_t P = S * a.D;
  const int64_t digits = (int64_t)SS_DIGITS * ((a.B + SS_BLOCK - 1) /
                                               SS_BLOCK);
  for (int64_t p0 = 0; p0 < P; p0 += 65535) {
    const int64_t np = P - p0 < 65535 ? P - p0 : 65535;
    const int64_t r = p0 * a.B;
    const cudaError_t err = ss::stable_sort(
        a.skey + r, a.B, ss::key_bits((uint64_t)a.K), a.perm + r, a.k1 + r,
        a.k2 + r, a.i1 + r, a.i2 + r, a.counts + p0 * digits, stream, np);
    if (err != cudaSuccess) return err;
  }
  fold<<<dim3(grid(a.B), (unsigned)S, a.D), T1, 0, stream>>>(a);
  return cudaGetLastError();
}
