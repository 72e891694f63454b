// Kernels G and G[K]: order-by, offset and limit over one chunk's rows
// (ops/selector.py shape_chunk), or over every slot's chunk of a
// partition block or a tenant pool (shape_chunk_slots).
//
// Replaces the reference's shape_output (siddhi_tpu/ops/selector.py:88)
// with its jnp.lexsort (:104): the rows sorted stably by (valid first,
// the order keys in order, the row index), then the valid rows whose
// rank r has offset <= r < offset + limit kept, the rest invalid. G[K]
// is the same function under the reference's jax.vmap (its partition
// block's run_block, its pool's chain step): each slot's rows sorted on
// their own, dead rows included, each slot ranking its own valid rows.
//
// Each key becomes an unsigned word whose order is the lexsort's for
// it: BOOL as an integer; `desc` negates in the key's own width (an INT
// or LONG minimum wraps to itself, a float's sign flips); a float then
// by jax's sort comparator (zeros, and subnormals that compare equal to
// zero, as +0.0; every NaN one value above +inf, whatever its sign);
// then the sign bit flipped.
//
// G: a stable LSD radix sort (8-bit digits, key_sort.cuh's 64-bit
// passes) runs the keys least significant first, 4 passes for a 32-bit
// word and 8 for a 64-bit one, each key's words gathered through the
// permutation so far, then one pass over the dead flag; stability makes
// the row index the last tiebreak. With no keys (offset or limit alone)
// the rows keep their places. Then one prefix sum ranks the valid rows,
// and one gather writes every column, the timestamps, the nulls, the
// kinds and the new valid flags, and one thread adds the kept count to
// the query's emitted counter.
//
// G[K]: one block a slot. Where the caller passes no global scratch
// (k1 NULL: a slot's B rows fit the block's shared memory, 12 bytes a
// row of the next power of two, 192 KB at 16,384; the caller alone
// decides, _kernels.ORDER_SHARED_ROWS) the block sorts them there, one
// bitonic network a key, least significant key first, over (the key's
// word, the row's position after the keys before) with the row beside
// it: the position makes every element distinct, so the network, which
// is not stable, gives the order a stable sort by the key would. With
// scratch (past that size) the keys run key_sort.cuh's radix passes in global memory,
// one sort segment a slot (blockIdx.y, at most 65,535 a launch). Then
// the same block a slot places the rows: a count of the valid rows,
// then tiles of 1,024 sorted positions, a thread a position, whose
// block scan of the valid flags gives each valid row its rank and its
// place (the valid rows first, the dead rows after them, each in their
// sorted order: the lexsort's dead-flag key) as every column of the
// slot's output is written; thread 0 adds the slot's kept count to its
// emitted counter (atomically where one counter serves every slot). (A
// thread a contiguous span of positions put a warp's reads and writes
// 32 lines apart: twice the time at partition_top's shapes on an H100.)
//
// Bound: bytes. G: each pass reads and writes a key word and an index a
// row (12-16 bytes), against the chunk's columns read once and written
// once by the gather; at a 65,536-row chunk the launches (three a pass)
// and the one-block scans of the digit counts dominate. G[K] in shared
// memory: the columns read once and written once, plus each key's
// words read; the network's log2(P) * (log2(P) + 1) / 2 steps a key
// are shared-memory traffic. G[K] in global memory: the digit passes
// (three launches each, 12 for a FLOAT and a LONG key) and the place
// kernel's gathers from random rows of the slot.
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

// row r of a key column of type `type` as its order word
__device__ __forceinline__ uint64_t key_word(const void* col, int type,
                                             bool desc, int64_t r) {
  switch (type) {
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

// key k of row r as its order word
__device__ __forceinline__ uint64_t order_word(const OrderArgs& a, int k,
                                               int64_t r) {
  return key_word(a.cols[a.key_col[k]], a.key_type[k], a.key_desc[k], r);
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

// ---- G[K] ---------------------------------------------------------------

// slot s's rows of an input array of `size`-byte elements
__device__ __forceinline__ const void* slot_rows(const void* base,
                                                 int64_t stride, int size,
                                                 int64_t s) {
  return (const char*)base + s * stride * size;
}

__device__ __forceinline__ uint64_t slot_word(const OrderArgs& a, int k,
                                              int64_t s, int64_t r) {
  const int c = a.key_col[k];
  return key_word(slot_rows(a.cols[c], a.col_stride[c], a.col_size[c], s),
                  a.key_type[k], a.key_desc[k], r);
}

// Slot s's shaped rows (one block): the row at sorted position j is
// row_of(j); with keys, the valid rows go first and the dead rows after
// them, each in sorted order; without, every row keeps its place. A
// valid row's rank is the valid rows before it. One pass counts the
// valid rows; a second walks tiles of SS_BLOCK positions, a thread a
// position, so that neighbouring threads read neighbouring positions
// and, for the dead rows, write neighbouring places.
template <class RowOf>
__device__ void place_slot(const OrderArgs& a, int64_t s, bool sorted,
                           RowOf row_of, int64_t* buf) {
  const int64_t B = a.B;
  const bool* valid = (const bool*)slot_rows(a.valid, a.valid_stride, 1, s);
  const int64_t* ts = (const int64_t*)slot_rows(a.ts, a.ts_stride, 8, s);
  const int32_t* kind =
      (const int32_t*)slot_rows(a.kind, a.kind_stride, 4, s);
  const int t = threadIdx.x;
  int64_t mine = 0;
  for (int64_t j = t; j < B; j += SS_BLOCK) mine += valid[row_of(j)] ? 1 : 0;
  int64_t n_valid;
  ss::block_scan_sum(mine, buf, &n_valid);
  const int64_t off = a.offset > 0 ? a.offset : 0;
  const int64_t o = s * B;
  int64_t base = 0;   // the valid rows of the tiles before
  for (int64_t tile = 0; tile < B; tile += SS_BLOCK) {
    const int64_t j = tile + t;
    const bool in = j < B;
    const int64_t r = in ? row_of(j) : 0;
    const bool v = in && valid[r];
    int64_t tile_valid;
    const int64_t before =
        base + ss::block_scan_sum(v ? 1 : 0, buf, &tile_valid) - (v ? 1 : 0);
    base += tile_valid;
    if (!in) continue;
    const int64_t dest =
        o + (!sorted ? j : (v ? before : n_valid + j - before));
    bool keep = v;
    if (keep && a.offset >= 0) keep = before >= a.offset;
    if (keep && a.limit >= 0) keep = before < off + a.limit;
    a.out_ts[dest] = ts[r];
    a.out_kind[dest] = kind[r];
    a.out_valid[dest] = keep;
    for (int c = 0; c < a.n_cols; ++c) {
      const int sz = a.col_size[c];
      const void* col = slot_rows(a.cols[c], a.col_stride[c], sz, s);
      if (sz == 8)
        ((int64_t*)a.out_cols[c])[dest] = ((const int64_t*)col)[r];
      else if (sz == 4)
        ((int32_t*)a.out_cols[c])[dest] = ((const int32_t*)col)[r];
      else
        ((uint8_t*)a.out_cols[c])[dest] = ((const uint8_t*)col)[r];
      a.out_nulls[c][dest] =
          ((const bool*)slot_rows(a.nulls[c], a.null_stride[c], 1, s))[r];
    }
  }
  if (t == 0 && a.emitted) {
    int64_t kept = n_valid - off;
    if (kept < 0) kept = 0;
    if (a.limit >= 0 && kept > a.limit) kept = a.limit;
    atomicAdd((unsigned long long*)(a.emitted + s * a.emitted_stride),
              (unsigned long long)kept);
  }
}

// One block a slot (blockIdx.x), rows in shared memory: w[P] the order
// words, pr[P] (position << 16) | row; P a power of two >= B, the pad
// words and rows all ones (after every real element). Without keys
// (offset or limit alone) the rows keep their places.
__global__ void __launch_bounds__(SS_BLOCK)
    order_slots_shared(const __grid_constant__ OrderArgs a, int P) {
  extern __shared__ uint64_t smem[];
  __shared__ int64_t buf[SS_BLOCK];
  uint64_t* w = smem;
  uint32_t* pr = (uint32_t*)(smem + P);
  const int64_t s = blockIdx.x;
  const int t = threadIdx.x;
  const int B = a.B;
  if (a.n_keys == 0) {
    place_slot(a, s, false, [](int64_t j) { return j; }, buf);
    return;
  }
  for (int j = t; j < P; j += SS_BLOCK)
    pr[j] = j < B ? ((uint32_t)j << 16) | (uint32_t)j : 0xffffffffu;
  for (int k = a.n_keys - 1; k >= 0; --k) {
    // this key's words in the order so far, each position beside its row
    for (int j = t; j < P; j += SS_BLOCK) {
      if (j < B) {
        const uint32_t r = pr[j] & 0xffffu;
        pr[j] = ((uint32_t)j << 16) | r;
        w[j] = slot_word(a, k, s, r);
      } else {
        w[j] = ~0ull;
      }
    }
    __syncthreads();
    for (int m = 2; m <= P; m <<= 1) {
      for (int h = m >> 1; h > 0; h >>= 1) {
        for (int i = t; i < P; i += SS_BLOCK) {
          const int o = i ^ h;
          if (o <= i) continue;
          const bool greater = w[i] != w[o] ? w[i] > w[o] : pr[i] > pr[o];
          if (((i & m) == 0) == greater) {
            const uint64_t tw = w[i];
            w[i] = w[o];
            w[o] = tw;
            const uint32_t tp = pr[i];
            pr[i] = pr[o];
            pr[o] = tp;
          }
        }
        __syncthreads();
      }
    }
  }
  place_slot(a, s, true,
             [&](int64_t j) { return (int64_t)(pr[j] & 0xffffu); }, buf);
}

// key k's words of segment (slot) s0 + blockIdx.y in the current order
__global__ void slot_words(const OrderArgs a, int k, int64_t s0,
                           const int32_t* perm, uint64_t* out) {
  const int64_t j = (int64_t)blockIdx.x * T1 + threadIdx.x;
  if (j >= a.B) return;
  const int64_t o = (int64_t)blockIdx.y * a.B;
  const int64_t r = perm ? perm[o + j] : j;
  out[o + j] = slot_word(a, k, s0 + blockIdx.y, r);
}

// one block a slot: place the rows of the global sort's permutation
__global__ void __launch_bounds__(SS_BLOCK)
    order_slots_place(const __grid_constant__ OrderArgs a, int64_t s0,
                      const int32_t* perm) {
  __shared__ int64_t buf[SS_BLOCK];
  const int32_t* p = perm + (int64_t)blockIdx.x * a.B;
  place_slot(a, s0 + blockIdx.x, true,
             [&](int64_t j) { return (int64_t)p[j]; }, buf);
}

// G[K] with global scratch: each group of at most 65,535
// slots sorts as that many segments of the radix passes, then places
cudaError_t order_slots_global(const OrderArgs& a, cudaStream_t stream) {
  const int32_t n = a.B;
  const int blocks = (n + SS_BLOCK - 1) / SS_BLOCK;
  for (int64_t s0 = 0; s0 < a.K; s0 += 65535) {
    const int64_t g = a.K - s0 < 65535 ? a.K - s0 : 65535;
    const unsigned y = (unsigned)g;
    const int64_t o = s0 * n;
    int32_t* ib[2] = {a.i1 + o, a.i2 + o};
    int nb = 0;
    uint64_t* kcur = a.k1 + o;
    uint64_t* kalt = a.k2 + o;
    int32_t* counts = a.counts + s0 * SS_DIGITS * blocks;
    const int32_t* perm = nullptr;
    for (int k = a.n_keys - 1; k >= 0; --k) {
      const int passes = wide_word(a.key_type[k]) ? 8 : 4;
      slot_words<<<dim3(grid(n), y), T1, 0, stream>>>(a, k, s0, perm, kcur);
      for (int q = 0; q < passes; ++q) {
        int32_t* iout = ib[nb];
        nb ^= 1;
        ks::hist64<<<dim3(blocks, y), SS_BLOCK, 0, stream>>>(kcur, n, 8 * q,
                                                             counts);
        ss::scan_counts<<<dim3(1, y), SS_BLOCK, 0, stream>>>(
            counts, SS_DIGITS * blocks);
        ks::scatter64<<<dim3(blocks, y), SS_BLOCK, 0, stream>>>(
            kcur, perm, n, 8 * q, counts, kalt, iout);
        uint64_t* tk = kcur;
        kcur = kalt;
        kalt = tk;
        perm = iout;
      }
    }
    order_slots_place<<<(unsigned)g, SS_BLOCK, 0, stream>>>(a, s0, perm);
  }
  return cudaGetLastError();
}

cudaError_t order_slots(const OrderArgs& a, cudaStream_t stream) {
  if (a.K == 0 || a.B == 0) return cudaSuccess;
  if (a.k1 != nullptr) return order_slots_global(a, stream);
  int P = 2;
  while (P < a.B) P <<= 1;
  const size_t smem = a.n_keys > 0 ? (size_t)P * 12 : 0;
  // fails (no launch) where the slot's rows exceed the block's shared
  // memory and no scratch was given
  cudaError_t err = cudaFuncSetAttribute(
      order_slots_shared, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  order_slots_shared<<<(unsigned)a.K, SS_BLOCK, smem, stream>>>(a, P);
  return cudaGetLastError();
}

}  // namespace

extern "C" cudaError_t siddhi_order_by(const OrderArgs* p,
                                       cudaStream_t stream) {
  const OrderArgs& a = *p;
  if (a.K > 0) return order_slots(a, stream);
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
