// Kernel G: order-by, offset and limit over one chunk's rows
// (ops/selector.py shape_chunk).
//
// Replaces the reference's shape_output (siddhi_tpu/ops/selector.py:88)
// with its jnp.lexsort (:104): the rows sorted stably by (valid first,
// the order keys in order, the row index), then the valid rows whose
// rank r has offset <= r < offset + limit kept, the rest invalid.
//
// Each key becomes an unsigned word whose order is the lexsort's for
// it: BOOL as an integer; `desc` negates in the key's own width (an INT
// or LONG minimum wraps to itself, a float's sign flips); a float then
// by jax's sort comparator (zeros, and subnormals that compare equal to
// zero, as +0.0; every NaN one value above +inf, whatever its sign);
// then the sign bit flipped. A stable LSD radix sort (8-bit digits,
// key_sort.cuh's 64-bit passes) runs the keys least significant first,
// 4 passes for a 32-bit word and 8 for a 64-bit one, each key's words
// gathered through the permutation so far, then one pass over the dead
// flag; stability makes the row index the last tiebreak. With no keys
// (offset or limit alone) the rows keep their places. Then one prefix
// sum ranks the valid rows, and one gather writes every column, the
// timestamps, the nulls, the kinds and the new valid flags, and one
// thread adds the kept count to the query's emitted counter.
//
// Bound: bytes. Each pass reads and writes a key word and an index a
// row (12-16 bytes), against the chunk's columns read once and written
// once by the gather; at a 65,536-row chunk the launches (three a
// pass) and the one-block scans of the digit counts dominate.
#include <cfloat>

#include "key_sort.cuh"
#include "siddhi_kernels.h"
#include "sort_scan.cuh"

namespace {

constexpr int T1 = 256;

inline int grid(int64_t n) { return (int)((n + T1 - 1) / T1); }

__host__ __device__ __forceinline__ bool wide_word(int type) {
  return type == VT_LONG || type == VT_DOUBLE;
}

__device__ __forceinline__ float flush32(float x) {
  return fabsf(x) < FLT_MIN ? copysignf(0.0f, x) : x;
}

__device__ __forceinline__ double flush64(double x) {
  return fabs(x) < DBL_MIN ? copysign(0.0, x) : x;
}

// key k of row r as its order word
__device__ __forceinline__ uint64_t order_word(const OrderArgs& a, int k,
                                               int64_t r) {
  const void* col = a.cols[a.key_col[k]];
  const bool desc = a.key_desc[k];
  switch (a.key_type[k]) {
    case VT_LONG: {
      int64_t v = ((const int64_t*)col)[r];
      if (desc) v = (int64_t)(0ull - (uint64_t)v);
      return (uint64_t)v ^ 0x8000000000000000ull;
    }
    case VT_DOUBLE: {
      double d = ((const double*)col)[r];
      if (desc) d = -d;
      if (flush64(d) == 0.0) d = 0.0;
      int64_t b = isnan(d) ? 0x7ff8000000000000ll : __double_as_longlong(d);
      if (b < 0) b ^= 0x7fffffffffffffffll;
      return (uint64_t)b ^ 0x8000000000000000ull;
    }
    case VT_FLOAT: {
      float f = ((const float*)col)[r];
      if (desc) f = -f;
      if (flush32(f) == 0.0f) f = 0.0f;
      int32_t b = isnan(f) ? 0x7fc00000 : __float_as_int(f);
      if (b < 0) b ^= 0x7fffffff;
      return (uint64_t)((uint32_t)b ^ 0x80000000u);
    }
    case VT_BOOL: {
      int32_t v = ((const bool*)col)[r] ? 1 : 0;
      if (desc) v = -v;
      return (uint64_t)((uint32_t)v ^ 0x80000000u);
    }
    default: {   // VT_INT
      int32_t v = ((const int32_t*)col)[r];
      if (desc) v = (int32_t)(0u - (uint32_t)v);
      return (uint64_t)((uint32_t)v ^ 0x80000000u);
    }
  }
}

// the words of key k (k < 0: the dead flags) in the current order
__global__ void gather_words(const OrderArgs a, int k, const int32_t* perm,
                             uint64_t* out) {
  const int64_t j = (int64_t)blockIdx.x * T1 + threadIdx.x;
  if (j >= a.B) return;
  const int64_t r = perm ? perm[j] : j;
  out[j] = k < 0 ? (a.valid[r] ? 0ull : 1ull) : order_word(a, k, r);
}

// the valid flags in the new order (summed into ranks next)
__global__ void valid_flags(const OrderArgs a, const int32_t* perm) {
  const int64_t j = (int64_t)blockIdx.x * T1 + threadIdx.x;
  if (j >= a.B) return;
  a.rank[j] = a.valid[perm ? perm[j] : j] ? 1 : 0;
}

__global__ void shape_gather(const OrderArgs a, const int32_t* perm) {
  const int64_t j = (int64_t)blockIdx.x * T1 + threadIdx.x;
  if (j >= a.B) return;
  const int64_t r = perm ? perm[j] : j;
  const int64_t rank = a.rank[j] - 1;
  const int64_t off = a.offset > 0 ? a.offset : 0;
  bool keep = a.valid[r];
  if (keep && a.offset >= 0) keep = rank >= a.offset;
  if (keep && a.limit >= 0) keep = rank < off + a.limit;
  a.out_ts[j] = a.ts[r];
  a.out_kind[j] = a.kind[r];
  a.out_valid[j] = keep;
  for (int c = 0; c < a.n_cols; ++c) {
    const int sz = a.col_size[c];
    if (sz == 8)
      ((int64_t*)a.out_cols[c])[j] = ((const int64_t*)a.cols[c])[r];
    else if (sz == 4)
      ((int32_t*)a.out_cols[c])[j] = ((const int32_t*)a.cols[c])[r];
    else
      ((uint8_t*)a.out_cols[c])[j] = ((const uint8_t*)a.cols[c])[r];
    a.out_nulls[c][j] = a.nulls[c][r];
  }
  if (j == 0 && a.emitted) {
    int64_t kept = a.rank[a.B - 1] - off;
    if (kept < 0) kept = 0;
    if (a.limit >= 0 && kept > a.limit) kept = a.limit;
    *a.emitted += kept;
  }
}

}  // namespace

extern "C" cudaError_t siddhi_order_by(const OrderArgs* p,
                                       cudaStream_t stream) {
  const OrderArgs& a = *p;
  const int32_t n = a.B;
  const int blocks = (n + SS_BLOCK - 1) / SS_BLOCK;
  const int32_t* perm = nullptr;           // the identity
  int32_t* ib[2] = {a.i1, a.i2};
  int nb = 0;
  uint64_t* kcur = a.k1;
  uint64_t* kalt = a.k2;
  // least significant key first, then the dead flags
  for (int k = a.n_keys > 0 ? a.n_keys - 1 : -2; k >= -1; --k) {
    const int passes = k < 0 ? 1 : (wide_word(a.key_type[k]) ? 8 : 4);
    gather_words<<<grid(n), T1, 0, stream>>>(a, k, perm, kcur);
    for (int q = 0; q < passes; ++q) {
      int32_t* iout = ib[nb];
      nb ^= 1;
      ks::hist64<<<blocks, SS_BLOCK, 0, stream>>>(kcur, n, 8 * q, a.counts);
      ss::scan_counts<<<1, SS_BLOCK, 0, stream>>>(a.counts,
                                                  SS_DIGITS * blocks);
      ks::scatter64<<<blocks, SS_BLOCK, 0, stream>>>(kcur, perm, n, 8 * q,
                                                     a.counts, kalt, iout);
      uint64_t* t = kcur;
      kcur = kalt;
      kalt = t;
      perm = iout;
    }
  }
  valid_flags<<<grid(n), T1, 0, stream>>>(a, perm);
  ks::prefix_sum<int64_t>(a.rank, a.rank, n, a.sums, stream);
  shape_gather<<<grid(n), T1, 0, stream>>>(a, perm);
  return cudaGetLastError();
}
