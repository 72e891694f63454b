// Kernel K5s (B): the sort window's step (ops/windows2.py
// sort_window_step); and kernel E, the frequent and lossyFrequent
// windows' step (freq_window_step), after it.
//
// Replaces the reference's SortWindowOp.step (siddhi_tpu/ops/
// windows2.py:443), a lax.scan over the batch's rows with the buffer of
// L + 1 rows as its carry, and its emission_sort.
//
// The reference is sequential by nature: each arrival may evict a row
// that a later arrival would have compared against. One block walks the
// rows in order, as the scan does; the buffer's L + 1 rows are spread
// over the block's threads, so each step of the walk is a few
// block-wide reductions:
//   1. the lowest free slot (argmin of valid) takes the arrival;
//   2. when the count passes L, the comparator-max, key by key: a max
//      over the slots still tied (NaN-propagating, as jnp.max), the tie
//      mask narrowed to the slots equal to it; then the latest seq among
//      the tied slots (argmax, the first slot of equal values). A NaN
//      leaves no slot tied and the argmax takes slot 0, as in the
//      reference;
//   3. the evicted row is copied aside (it is emitted after the
//      arrival, EXPIRED at now) and its slot freed.
// A running count replaces the reference's sum(valid) after each
// insert; it gives the same number. `desc` negates the key in its own
// width, as the reference does (an INT or LONG minimum wraps, a float
// -0.0 flips).
// The emission then needs no sort: the keys emit_row * 4 + phase are
// already in order (row i's CURRENT, then its EXPIRED), so one block scan
// places the valid candidates, and the invalid ones after them in
// candidate order, as the reference's stable argsort leaves them.
//
// Bound: latency. Each arrival past the L-th costs a handful of
// dependent block reductions over L + 1 rows: the walk is a chain of
// B steps of a few microseconds, not a memory-bound pass.
#include <cfloat>

#include "keyed.cuh"
#include "siddhi_kernels.h"
#include "sort_scan.cuh"

namespace {

constexpr int32_t CUR = 0, EXP = 1;
constexpr int T1 = 256;

__device__ __forceinline__ void copy_val(void* dst, int64_t j,
                                         const void* src, int64_t r,
                                         int sz) {
  if (sz == 8)
    ((int64_t*)dst)[j] = ((const int64_t*)src)[r];
  else if (sz == 4)
    ((int32_t*)dst)[j] = ((const int32_t*)src)[r];
  else
    ((uint8_t*)dst)[j] = ((const uint8_t*)src)[r];
}

__device__ __forceinline__ void zero_val(void* dst, int64_t j, int sz) {
  if (sz == 8) ((int64_t*)dst)[j] = 0;
  else if (sz == 4) ((int32_t*)dst)[j] = 0;
  else ((uint8_t*)dst)[j] = 0;
}

// a key of slot s, negated in its own width for `desc`: integer keys as
// int64, float keys as double (widening keeps order, equality and NaN)
__device__ __forceinline__ int64_t key_int(const SortArgs& a, int k,
                                           int32_t s) {
  const void* col = a.na.cols[a.key_col[k]];
  if (a.key_type[k] == VT_INT) {
    const int32_t v = ((const int32_t*)col)[s];
    return a.key_desc[k] ? (int32_t)(0u - (uint32_t)v) : v;
  }
  const int64_t v = ((const int64_t*)col)[s];
  return a.key_desc[k] ? (int64_t)(0ull - (uint64_t)v) : v;
}

__device__ __forceinline__ double key_flt(const SortArgs& a, int k,
                                          int32_t s) {
  const void* col = a.na.cols[a.key_col[k]];
  if (a.key_type[k] == VT_FLOAT) {
    const float v = ((const float*)col)[s];
    return (double)(a.key_desc[k] ? -v : v);
  }
  const double v = ((const double*)col)[s];
  return a.key_desc[k] ? -v : v;
}

// max with NaN propagation (jnp.max)
__device__ __forceinline__ double nmax(double a, double b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

struct MinOp {
  __device__ int64_t operator()(int64_t x, int64_t y) const {
    return y < x ? y : x;
  }
};
struct MaxOp {
  __device__ int64_t operator()(int64_t x, int64_t y) const {
    return y > x ? y : x;
  }
};
struct SumOp {
  __device__ int64_t operator()(int64_t x, int64_t y) const { return x + y; }
};
struct NanMaxOp {
  __device__ double operator()(double x, double y) const {
    return nmax(x, y);
  }
};

// a block-wide reduction (blockDim.x == SS_BLOCK, `sh` 33 elements of
// shared memory); every thread gets the result
template <typename T, typename Op>
__device__ __forceinline__ T block_reduce(T v, T* sh, Op op) {
  for (int o = 16; o > 0; o >>= 1)
    v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x < 32) {
    v = sh[threadIdx.x];
    for (int o = 16; o > 0; o >>= 1)
      v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (threadIdx.x == 0) sh[32] = v;
  }
  __syncthreads();
  const T r = sh[32];
  __syncthreads();
  return r;
}

__global__ void sort_walk(const SortArgs a) {
  __shared__ int64_t shi[33];
  __shared__ double shf[33];
  const int t = threadIdx.x;
  const int32_t W = a.W;
  // the new buffer starts as the old one
  for (int32_t s = t; s < W; s += SS_BLOCK) {
    a.na.ts[s] = a.a.ts[s];
    a.na.seq[s] = a.a.seq[s];
    a.na.valid[s] = a.a.valid[s];
    for (int c = 0; c < a.n_cols; ++c) {
      copy_val(a.na.cols[c], s, a.a.cols[c], s, a.col_size[c]);
      a.na.nulls[c][s] = a.a.nulls[c][s];
    }
  }
  for (int32_t i = t; i < a.B; i += SS_BLOCK) a.ev.valid[i] = false;
  __syncthreads();
  int64_t cnt = 0;
  for (int32_t s = t; s < W; s += SS_BLOCK) cnt += a.na.valid[s];
  cnt = block_reduce<int64_t>(cnt, shi, SumOp());
  int64_t nseq = *a.next_seq;
  for (int32_t i = 0; i < a.B; ++i) {
    if (!(a.batch.valid[i] && a.batch_kind[i] == CUR)) continue;
    // 1. the lowest free slot
    int64_t f = W;
    for (int32_t s = t; s < W; s += SS_BLOCK)
      if (!a.na.valid[s] && s < f) f = s;
    f = block_reduce<int64_t>(f, shi, MinOp());
    if (t == 0) {
      a.na.ts[f] = a.batch.ts[i];
      a.na.seq[f] = nseq;
      a.na.valid[f] = true;
    }
    for (int c = t; c < a.n_cols; c += SS_BLOCK) {
      copy_val(a.na.cols[c], f, a.batch.cols[c], i, a.col_size[c]);
      a.na.nulls[c][f] = a.batch.nulls[c][i];
    }
    ++nseq;
    ++cnt;
    __syncthreads();
    if (cnt <= a.L) continue;
    // 2. the comparator-max, key by key, then the latest seq
    for (int32_t s = t; s < W; s += SS_BLOCK) a.mask[s] = a.na.valid[s];
    __syncthreads();
    for (int k = 0; k < a.n_keys; ++k) {
      const bool flt = a.key_type[k] == VT_FLOAT ||
                       a.key_type[k] == VT_DOUBLE;
      if (flt) {
        double m = -INFINITY;
        for (int32_t s = t; s < W; s += SS_BLOCK)
          m = nmax(m, a.mask[s] ? key_flt(a, k, s) : -INFINITY);
        m = block_reduce<double>(m, shf, NanMaxOp());
        for (int32_t s = t; s < W; s += SS_BLOCK)
          a.mask[s] = a.mask[s] && key_flt(a, k, s) == m;
      } else {
        // the reference's fill: the type's minimum
        const int64_t lo = a.key_type[k] == VT_INT ? (int64_t)INT32_MIN
                                                   : INT64_MIN;
        int64_t m = lo;
        for (int32_t s = t; s < W; s += SS_BLOCK) {
          const int64_t x = a.mask[s] ? key_int(a, k, s) : lo;
          if (x > m) m = x;
        }
        m = block_reduce<int64_t>(m, shi, MaxOp());
        for (int32_t s = t; s < W; s += SS_BLOCK)
          a.mask[s] = a.mask[s] && key_int(a, k, s) == m;
      }
      __syncthreads();
    }
    // argmax(where(mask, seq, -1)): the largest, the first slot of equals
    int64_t best = INT64_MIN, bs = W;
    for (int32_t s = t; s < W; s += SS_BLOCK) {
      const int64_t q = a.mask[s] ? a.na.seq[s] : -1;
      if (q > best) {
        best = q;
        bs = s;
      }
    }
    const int64_t top = block_reduce<int64_t>(best, shi, MaxOp());
    const int64_t e = block_reduce<int64_t>(best == top ? bs : W, shi,
                                            MinOp());
    // 3. the evicted row, copied aside; its slot freed
    if (t == 0) a.ev.valid[i] = true;
    for (int c = t; c < a.n_cols; c += SS_BLOCK) {
      copy_val(a.ev.cols[c], i, a.na.cols[c], e, a.col_size[c]);
      a.ev.nulls[c][i] = a.na.nulls[c][e];
    }
    __syncthreads();
    if (t == 0) a.na.valid[e] = false;
    --cnt;
    __syncthreads();
  }
  if (t == 0) *a.o_next_seq = nseq;
}

// one block: each candidate's place (candidates: the batch's rows as
// CURRENT, then their evicted copies as EXPIRED)
__global__ void sort_place(const SortArgs a) {
  __shared__ int64_t buf[SS_BLOCK];
  int64_t lo, hi;
  ss::span(a.B, &lo, &hi);
  int64_t nv = 0, nc = 0, ne = 0;
  for (int64_t i = lo; i < hi; ++i) {
    const bool c = a.batch.valid[i] && a.batch_kind[i] == CUR;
    const bool e = a.expired_enabled && a.ev.valid[i];
    nv += c + e;
    nc += !c;
    ne += !e;
  }
  int64_t tv, tc;
  int64_t rv = ss::block_scan_sum(nv, buf, &tv) - nv;
  int64_t rc = ss::block_scan_sum(nc, buf, &tc) - nc;
  int64_t re = ss::block_scan_sum(ne, buf, nullptr) - ne;
  for (int64_t i = lo; i < hi; ++i) {
    const bool c = a.batch.valid[i] && a.batch_kind[i] == CUR;
    const bool e = a.expired_enabled && a.ev.valid[i];
    if (c) {
      a.pos[i] = (int32_t)rv++;
    } else {
      a.pos[i] = (int32_t)(tv + rc++);
    }
    if (e) {
      a.pos[a.B + i] = (int32_t)rv++;
    } else {
      a.pos[a.B + i] = (int32_t)(tv + tc + re++);
    }
  }
}

__global__ void sort_gather(const SortArgs a) {
  const int64_t c = (int64_t)blockIdx.x * T1 + threadIdx.x;
  if (c >= 2 * (int64_t)a.B) return;
  const int32_t q = a.pos[c];
  const bool ev = c >= a.B;
  const int32_t i = ev ? (int32_t)(c - a.B) : (int32_t)c;
  if (!ev) {
    a.out.ts[q] = a.batch.ts[i];
    a.out_kind[q] = CUR;
    a.out.valid[q] = a.batch.valid[i] && a.batch_kind[i] == CUR;
    for (int k = 0; k < a.n_cols; ++k) {
      copy_val(a.out.cols[k], q, a.batch.cols[k], i, a.col_size[k]);
      a.out.nulls[k][q] = a.batch.nulls[k][i];
    }
  } else {
    const bool e = a.ev.valid[i];
    a.out.ts[q] = *a.now;
    a.out_kind[q] = EXP;
    a.out.valid[q] = a.expired_enabled && e;
    for (int k = 0; k < a.n_cols; ++k) {
      if (e)
        copy_val(a.out.cols[k], q, a.ev.cols[k], i, a.col_size[k]);
      else
        zero_val(a.out.cols[k], q, a.col_size[k]);
      a.out.nulls[k][q] = e && a.ev.nulls[k][i];
    }
  }
}


// ---------------------------------------------------------------- kernel E
//
// Replaces the reference's FrequentWindowOp.step (siddhi_tpu/ops/
// windows2.py:569) and LossyFrequentWindowOp.step (:732): a lax.scan
// over the batch's rows, each row's admission depending on the table the
// row before left. One warp walks the rows in order; lane l holds the
// table's slots l and l + 32 (key, count, bucket) in registers, the
// slots' stored events in shared memory, so every slot operation of a
// row is one warp vote: the hit (the lowest set bit of a ballot, jnp's
// argmax of `found`), the first free slot (the lowest clear bit of the
// valid mask, argmin of `valid`), the decrement of every count and the
// dying mask, the prune. The rows come in tiles of 32 through shared
// memory. Keys compare as the 64-bit hash of the key attributes, as in
// the reference.
//
// Emission: the reference emits B * N expired candidates (ts = now) and
// B current ones through its emission sort, whose order for the valid
// rows is the walk's own order: frequent emits a row's dying slots (in
// slot order) before the row, lossyFrequent after it. So the walk writes
// each valid row at its final place, keeps per row the dying mask and
// the counts of valid rows before it, and a second launch places the
// invalid candidates after the valid ones in candidate order, as the
// stable sort leaves them (expired ones: ts = now and zeros; current
// ones: the batch's row).
//
// Bound: latency. The walk is a chain of B steps of a few warp votes
// and shared-memory accesses each; the fill is a pass over B * N + B
// output rows, bound by their bytes.

#define FREQ_SLOTS 64
#define FREQ_TILE 32

__device__ __forceinline__ int64_t raw_at(const void* col, int64_t i,
                                          int sz) {
  if (sz == 8) return ((const int64_t*)col)[i];
  if (sz == 4) return (int64_t)((const uint32_t*)col)[i];
  return (int64_t)((const uint8_t*)col)[i];
}

__device__ __forceinline__ void raw_put(void* col, int64_t j, int64_t v,
                                        int sz) {
  if (sz == 8) ((int64_t*)col)[j] = v;
  else if (sz == 4) ((uint32_t*)col)[j] = (uint32_t)v;
  else ((uint8_t*)col)[j] = (uint8_t)v;
}

__device__ __forceinline__ uint64_t ballot64(bool lo, bool hi) {
  return (uint64_t)__ballot_sync(0xffffffffu, lo) |
         ((uint64_t)__ballot_sync(0xffffffffu, hi) << 32);
}

// each row's key: hash_columns over the key attributes
__global__ void freq_hash(const FreqArgs a) {
  const int64_t i = (int64_t)blockIdx.x * T1 + threadIdx.x;
  if (i >= a.B) return;
  int64_t h = kd::HASH_SEED;
  for (int k = 0; k < a.n_keys; ++k) {
    const int c = a.key_col[k];
    h = kd::mix64(h, kd::key_lane(a.batch.cols[c], a.key_type[k],
                                  a.batch.nulls[c], i));
  }
  a.hk[i] = h;
}

__global__ void freq_walk(const FreqArgs a) {
  __shared__ int64_t s_val[SIDDHI_WIN_MAX_COLS][FREQ_SLOTS];
  __shared__ bool s_null[SIDDHI_WIN_MAX_COLS][FREQ_SLOTS];
  __shared__ int64_t s_ts[FREQ_SLOTS];
  __shared__ int64_t t_val[SIDDHI_WIN_MAX_COLS][FREQ_TILE];
  __shared__ bool t_null[SIDDHI_WIN_MAX_COLS][FREQ_TILE];
  __shared__ int64_t t_ts[FREQ_TILE];
  __shared__ int64_t t_hk[FREQ_TILE];
  __shared__ bool t_cur[FREQ_TILE];
  const int l = threadIdx.x;
  const int N = a.N, C = a.n_cols;
  const int64_t B = a.B;
  const uint64_t nmask = N == 64 ? ~0ull : ((1ull << N) - 1ull);
  const int s0 = l, s1 = l + 32;
  int64_t key0 = 0, key1 = 0, cnt0 = 0, cnt1 = 0, bkt0 = 0, bkt1 = 0;
  bool v0 = false, v1 = false;
  if (s0 < N) {
    key0 = a.keys[s0];
    cnt0 = a.counts[s0];
    bkt0 = a.lossy ? a.buckets[s0] : 0;
    v0 = a.a.valid[s0];
    s_ts[s0] = a.a.ts[s0];
  }
  if (s1 < N) {
    key1 = a.keys[s1];
    cnt1 = a.counts[s1];
    bkt1 = a.lossy ? a.buckets[s1] : 0;
    v1 = a.a.valid[s1];
    s_ts[s1] = a.a.ts[s1];
  }
  for (int c = 0; c < C; ++c) {
    if (s0 < N) {
      s_val[c][s0] = raw_at(a.a.cols[c], s0, a.col_size[c]);
      s_null[c][s0] = a.a.nulls[c][s0];
    }
    if (s1 < N) {
      s_val[c][s1] = raw_at(a.a.cols[c], s1, a.col_size[c]);
      s_null[c][s1] = a.a.nulls[c][s1];
    }
  }
  uint64_t valid = ballot64(v0, v1);
  __syncwarp();
  const int64_t now = *a.now;
  int64_t nseq = *a.next_seq;
  int64_t total = a.lossy ? *a.total : 0, ovf = a.lossy ? *a.overflow : 0;
  int64_t run = 0, vexp = 0, vcur = 0;

  // the row in tile row r into slot s (lane c: column c; lane 31: ts)
  auto store = [&](int s, int r) {
    for (int c = l; c < C; c += 32) {
      s_val[c][s] = t_val[c][r];
      s_null[c][s] = t_null[c][r];
    }
    if (l == 31) s_ts[s] = t_ts[r];
  };
  auto put_cur = [&](int r, int64_t pos) {
    for (int c = l; c < C; c += 32) {
      raw_put(a.out.cols[c], pos, t_val[c][r], a.col_size[c]);
      a.out.nulls[c][pos] = t_null[c][r];
    }
    if (l == 31) {
      a.out.ts[pos] = t_ts[r];
      a.out_kind[pos] = CUR;
      a.out.valid[pos] = true;
    }
  };
  auto put_exp = [&](int s, int64_t pos) {
    for (int c = l; c < C; c += 32) {
      raw_put(a.out.cols[c], pos, s_val[c][s], a.col_size[c]);
      a.out.nulls[c][pos] = s_null[c][s];
    }
    if (l == 31) {
      a.out.ts[pos] = now;
      a.out_kind[pos] = EXP;
      a.out.valid[pos] = true;
    }
  };
  auto emit_dying = [&](uint64_t dies) {
    if (!a.expired_enabled) return;
    for (uint64_t m = dies; m; m &= m - 1) {
      put_exp(__ffsll((long long)m) - 1, run++);
      ++vexp;
    }
  };
  // the owner lane of slot s sets its key, count and bucket
  auto set_slot = [&](int s, int64_t kh, int64_t cnt, int64_t bkt) {
    if (l == (s & 31)) {
      if (s < 32) {
        key0 = kh; cnt0 = cnt; bkt0 = bkt;
      } else {
        key1 = kh; cnt1 = cnt; bkt1 = bkt;
      }
    }
  };

  for (int64_t base = 0; base < B; base += FREQ_TILE) {
    const int64_t il = base + l;
    if (il < B) {
      t_hk[l] = a.hk[il];
      t_ts[l] = a.batch.ts[il];
      t_cur[l] = a.batch.valid[il] && a.batch_kind[il] == CUR;
      for (int c = 0; c < C; ++c) {
        t_val[c][l] = raw_at(a.batch.cols[c], il, a.col_size[c]);
        t_null[c][l] = a.batch.nulls[c][il];
      }
    } else {
      t_cur[l] = false;
    }
    __syncwarp();
    const int nr = B - base < FREQ_TILE ? (int)(B - base) : FREQ_TILE;
    for (int r = 0; r < nr; ++r) {
      const int64_t i = base + r;
      if (l == 0) {
        a.vbefore[i] = (int32_t)vexp;
        a.cbefore[i] = (int32_t)vcur;
      }
      uint64_t dies = 0;
      if (t_cur[r]) {
        ++nseq;
        const int64_t kh = t_hk[r];
        const uint64_t found = ballot64(
            s0 < N && ((valid >> s0) & 1) && key0 == kh,
            s1 < N && ((valid >> s1) & 1) && key1 == kh);
        if (!a.lossy) {
          bool passed = true;
          if (found) {
            const int s = __ffsll((long long)found) - 1;
            const int64_t cs = __shfl_sync(0xffffffffu, s < 32 ? cnt0 : cnt1,
                                           s & 31);
            set_slot(s, kh, cs + 1, 0);
            store(s, r);
          } else if (__popcll((long long)valid) < N) {
            const int s = __ffsll((long long)(~valid & nmask)) - 1;
            set_slot(s, kh, 1, 0);
            store(s, r);
            valid |= 1ull << s;
          } else {
            // a full table: every count decremented, the zeroed freed
            bool d0 = false, d1 = false;
            if (s0 < N && ((valid >> s0) & 1)) {
              --cnt0;
              d0 = cnt0 <= 0;
              if (d0) cnt0 = 0;
            }
            if (s1 < N && ((valid >> s1) & 1)) {
              --cnt1;
              d1 = cnt1 <= 0;
              if (d1) cnt1 = 0;
            }
            dies = ballot64(d0, d1);
            emit_dying(dies);
            valid &= ~dies;
            passed = dies != 0;
            if (passed) {
              const int s = __ffsll((long long)(~valid & nmask)) - 1;
              set_slot(s, kh, 1, 0);
              store(s, r);
              valid |= 1ull << s;
            }
          }
          if (passed) {
            put_cur(r, run++);
            ++vcur;
          }
        } else {
          ++total;
          const int64_t bucket = (total + a.width - 1) / a.width;
          const uint64_t freeb = ~valid & nmask;
          const bool admitted = found != 0 || freeb != 0;
          const int s = found ? __ffsll((long long)found) - 1
                              : (freeb ? __ffsll((long long)freeb) - 1 : 0);
          const int64_t cs = __shfl_sync(0xffffffffu, s < 32 ? cnt0 : cnt1,
                                         s & 31);
          const int64_t bs = __shfl_sync(0xffffffffu, s < 32 ? bkt0 : bkt1,
                                         s & 31);
          int64_t nc = cs;
          if (admitted) {
            nc = found ? cs + 1 : 1;
            set_slot(s, kh, nc, found ? bs : bucket - 1);
            store(s, r);
            valid |= 1ull << s;
          } else {
            ++ovf;
          }
          if (admitted &&
              (double)nc >= __dmul_rn(a.thresh, (double)total)) {
            put_cur(r, run++);
            ++vcur;
          }
          if (total % a.width == 0) {
            dies = ballot64(
                s0 < N && ((valid >> s0) & 1) && cnt0 + bkt0 <= bucket,
                s1 < N && ((valid >> s1) & 1) && cnt1 + bkt1 <= bucket);
            emit_dying(dies);
            valid &= ~dies;
          }
        }
      }
      if (l == 0) a.dmask[i] = (int64_t)dies;
    }
    __syncwarp();
  }
  // the new table
  for (int h = 0; h < 2; ++h) {
    const int s = h ? s1 : s0;
    if (s >= N) continue;
    a.o_keys[s] = h ? key1 : key0;
    a.o_counts[s] = h ? cnt1 : cnt0;
    if (a.lossy) a.o_buckets[s] = h ? bkt1 : bkt0;
    a.na.valid[s] = (valid >> s) & 1;
    a.na.ts[s] = s_ts[s];
    for (int c = 0; c < C; ++c) {
      raw_put(a.na.cols[c], s, s_val[c][s], a.col_size[c]);
      a.na.nulls[c][s] = s_null[c][s];
    }
  }
  if (l == 0) {
    *a.o_next_seq = nseq;
    if (a.lossy) {
      *a.o_total = total;
      *a.o_overflow = ovf;
    }
    a.scal[0] = run;
    a.scal[1] = vexp;
    a.scal[2] = vcur;
  }
}

// the invalid candidates after the valid ones, in candidate order
__global__ void freq_fill(const FreqArgs a) {
  const int64_t c = (int64_t)blockIdx.x * T1 + threadIdx.x;
  const int64_t B = a.B, N = a.N, BN = B * N;
  if (c >= BN + B) return;
  const int64_t V = a.scal[0], VE = a.scal[1], VC = a.scal[2];
  const bool exp_first = !a.lossy;
  const bool is_exp = exp_first ? c < BN : c >= B;
  const int64_t e = exp_first ? c : c - B;          // expired index
  const int64_t i = is_exp ? e / N : (exp_first ? c - BN : c);
  int64_t pos;
  if (is_exp) {
    const int64_t j = e - i * N;
    const uint64_t dm = a.expired_enabled ? (uint64_t)a.dmask[i] : 0ull;
    if ((dm >> j) & 1) return;             // a valid row: the walk's
    const int64_t before =
        a.vbefore[i] + __popcll((long long)(dm & ((1ull << j) - 1ull)));
    pos = V + (exp_first ? 0 : B - VC) + (e - before);
    a.out.ts[pos] = *a.now;
    a.out_kind[pos] = EXP;
    for (int k = 0; k < a.n_cols; ++k) {
      zero_val(a.out.cols[k], pos, a.col_size[k]);
      a.out.nulls[k][pos] = false;
    }
  } else {
    const int64_t nxt = i + 1 < B ? a.cbefore[i + 1] : VC;
    if (nxt != a.cbefore[i]) return;       // it passed: the walk's
    pos = V + (exp_first ? BN - VE : 0) + (i - a.cbefore[i]);
    a.out.ts[pos] = a.batch.ts[i];
    a.out_kind[pos] = CUR;
    for (int k = 0; k < a.n_cols; ++k) {
      copy_val(a.out.cols[k], pos, a.batch.cols[k], i, a.col_size[k]);
      a.out.nulls[k][pos] = a.batch.nulls[k][i];
    }
  }
  a.out.valid[pos] = false;
}

}  // namespace

extern "C" cudaError_t siddhi_sort_window(const SortArgs* p,
                                          cudaStream_t stream) {
  const SortArgs& a = *p;
  sort_walk<<<1, SS_BLOCK, 0, stream>>>(a);
  sort_place<<<1, SS_BLOCK, 0, stream>>>(a);
  sort_gather<<<(int)((2 * (int64_t)a.B + T1 - 1) / T1), T1, 0, stream>>>(a);
  return cudaGetLastError();
}

extern "C" cudaError_t siddhi_freq_window(const FreqArgs* p,
                                          cudaStream_t stream) {
  const FreqArgs& a = *p;
  const int64_t M = (int64_t)a.B * a.N + a.B;
  freq_hash<<<(int)((a.B + T1 - 1) / T1), T1, 0, stream>>>(a);
  freq_walk<<<1, 32, 0, stream>>>(a);
  freq_fill<<<(int)((M + T1 - 1) / T1), T1, 0, stream>>>(a);
  return cudaGetLastError();
}
