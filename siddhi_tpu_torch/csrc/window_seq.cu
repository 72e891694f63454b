// Kernel K5s: the sort window's step (ops/windows2.py sort_window_step).
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

}  // namespace

extern "C" cudaError_t siddhi_sort_window(const SortArgs* p,
                                          cudaStream_t stream) {
  const SortArgs& a = *p;
  sort_walk<<<1, SS_BLOCK, 0, stream>>>(a);
  sort_place<<<1, SS_BLOCK, 0, stream>>>(a);
  sort_gather<<<(int)((2 * (int64_t)a.B + T1 - 1) / T1), T1, 0, stream>>>(a);
  return cudaGetLastError();
}
