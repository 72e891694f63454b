// The key view shared by kernels K7 (join_cross.cu) and K8
// (table_step.cu): keys in the reference's sort order, a stable LSD radix
// sort of 64-bit keys with the padded rows last, the reference's own
// bisection, and prefix sums. No library sort.
//
// Sort order (ops/table.py encode_keys): the reference sorts and searches
// with jax's comparator, which first canonicalises a float (a zero, or a
// subnormal that compares equal to zero, becomes +0.0; every NaN the
// positive quiet NaN) and then orders floats totally by their bits. Here
// every key becomes a uint64 whose unsigned order is that order: a
// float's bits with the magnitude flipped below zero, then the sign bit
// flipped; ints and dictionary codes with the sign bit flipped. 32-bit
// types stay in the low 32 bits, so their sort runs four digit passes.
//
// sorted_key_view is a lexsort of (dead row, key, position): the radix
// passes over the key, then one pass over the dead flag, each stable, so
// positions stay in order within equal keys and a live key equal to the
// pad value sorts before the padding.
#pragma once

#include <stdint.h>
#include <cuda_runtime.h>

#include "expr_interp.cuh"
#include "sort_scan.cuh"

namespace ks {

constexpr int T1 = 256;

inline int grid(int64_t n) { return (int)((n + T1 - 1) / T1); }

// a key slot (the interpreter's raw 64-bit value of type `type`) as its
// signed sort key (ops/table.py encode_keys)
__device__ __forceinline__ int64_t enc_key(int64_t v, int type) {
  if (type == VT_FLOAT) {
    float f = siddhi::as_f(v);
    if (siddhi::flush(f) == 0.0f) f = 0.0f;
    int32_t b = isnan(f) ? 0x7fc00000 : __float_as_int(f);
    return b < 0 ? (int64_t)(b ^ 0x7fffffff) : (int64_t)b;
  }
  if (type == VT_DOUBLE) {
    double d = siddhi::as_d(v);
    if (siddhi::flush(d) == 0.0) d = 0.0;
    const int64_t b = isnan(d) ? (int64_t)0x7ff8000000000000ll
                               : __double_as_longlong(d);
    return b < 0 ? (b ^ 0x7fffffffffffffffll) : b;
  }
  return v;   // INT, STRING (sign-extended), LONG, BOOL (0/1)
}

__host__ __device__ __forceinline__ bool wide(int type) {
  return type == VT_LONG || type == VT_DOUBLE;
}

// a signed sort key as the unsigned key the radix sort orders
__device__ __forceinline__ uint64_t sortable(int64_t e, int type) {
  if (wide(type)) return (uint64_t)e ^ 0x8000000000000000ull;
  return (uint64_t)((uint32_t)(int32_t)e ^ 0x80000000u);
}

// jnp.searchsorted(sk[0:n], v, side) step for step: `levels` halvings
// from low 0, high n (its `scan` method), the result high. Exact even
// where sk is not sorted.
__device__ __forceinline__ int64_t bisect(const int64_t* sk, int64_t n,
                                          int levels, uint64_t v,
                                          bool left) {
  int64_t low = 0, high = n;
  for (int l = 0; l < levels; ++l) {
    const int64_t mid = (int64_t)(((uint64_t)low + (uint64_t)high) >> 1);
    const uint64_t a = (uint64_t)sk[mid];
    const bool go_left = left ? v <= a : v < a;
    if (go_left) high = mid; else low = mid;
  }
  return high;
}

// first index of a non-decreasing a[0:n] with a[i] > v (side right)
__device__ __forceinline__ int64_t upper_bound(const int64_t* a, int64_t n,
                                               int64_t v) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (a[mid] <= v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// first index of a non-decreasing a[0:n] with a[i] >= v (side left)
__device__ __forceinline__ int64_t lower_bound(const int64_t* a, int64_t n,
                                               int64_t v) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (a[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// inclusive prefix sums of src[0:n] (any integer type) into dst, one
// block of SS_BLOCK threads, each walking its span
template <typename S>
__global__ void prefix(const S* src, int64_t* dst, int64_t n) {
  __shared__ int64_t buf[SS_BLOCK];
  int64_t lo, hi;
  ss::span(n, &lo, &hi);
  int64_t s = 0;
  for (int64_t i = lo; i < hi; ++i) s += (int64_t)src[i];
  const int64_t incl = ss::block_scan_sum(s, buf, nullptr);
  int64_t run = incl - s;
  for (int64_t i = lo; i < hi; ++i) {
    run += (int64_t)src[i];
    dst[i] = run;
  }
}

// the total of each SS_BLOCK-element tile of src[0:n]
template <typename S>
__global__ void tile_sums(const S* src, int64_t n, int64_t* sums) {
  __shared__ int64_t buf[SS_BLOCK];
  const int64_t i = (int64_t)blockIdx.x * SS_BLOCK + threadIdx.x;
  int64_t total;
  ss::block_scan_sum(i < n ? (int64_t)src[i] : 0, buf, &total);
  if (threadIdx.x == 0) sums[blockIdx.x] = total;
}

// each tile's inclusive scan, offset by the tiles before it (sums holds
// the inclusive scan of the tile totals)
template <typename S>
__global__ void tile_scan(const S* src, int64_t n, const int64_t* sums,
                          int64_t* dst) {
  __shared__ int64_t buf[SS_BLOCK];
  const int64_t i = (int64_t)blockIdx.x * SS_BLOCK + threadIdx.x;
  const int64_t incl = ss::block_scan_sum(i < n ? (int64_t)src[i] : 0, buf,
                                          nullptr);
  if (i < n) dst[i] = incl + (blockIdx.x > 0 ? sums[blockIdx.x - 1] : 0);
}

// Inclusive prefix sums of src[0:n] into dst: one block for one tile,
// else tile totals, their one-block scan (scratch `sums`, one int64 a
// tile) and the tiles' scans.
template <typename S>
inline void prefix_sum(const S* src, int64_t* dst, int64_t n, int64_t* sums,
                       cudaStream_t stream) {
  const int64_t tiles = (n + SS_BLOCK - 1) / SS_BLOCK;
  if (tiles <= 1) {
    prefix<S><<<1, SS_BLOCK, 0, stream>>>(src, dst, n);
    return;
  }
  tile_sums<S><<<(int)tiles, SS_BLOCK, 0, stream>>>(src, n, sums);
  prefix<int64_t><<<1, SS_BLOCK, 0, stream>>>(sums, sums, tiles);
  tile_scan<S><<<(int)tiles, SS_BLOCK, 0, stream>>>(src, n, sums, dst);
}

// The blocks of a digit pass over n rows, or over *n_dev rows where the
// count is the device's (a grid for the most rows there can be, the
// blocks past the rows returning at once).
__device__ __forceinline__ int32_t pass_blocks(int32_t* n,
                                               const int64_t* n_dev) {
  if (!n_dev) return gridDim.x;
  *n = (int32_t)*n_dev;
  return (*n + SS_BLOCK - 1) / SS_BLOCK;
}

__global__ void hist64(const uint64_t* keys, int32_t n, int shift,
                       int32_t* counts, const int64_t* n_dev = nullptr) {
  __shared__ int32_t h[SS_DIGITS];
  const int32_t nb = pass_blocks(&n, n_dev);
  if ((int32_t)blockIdx.x >= nb) return;
  const int t = threadIdx.x;
  if (t < SS_DIGITS) h[t] = 0;
  __syncthreads();
  const int32_t i = blockIdx.x * SS_BLOCK + t;
  if (i < n) atomicAdd(&h[(keys[i] >> shift) & 0xff], 1);
  __syncthreads();
  if (t < SS_DIGITS) counts[t * nb + blockIdx.x] = h[t];
}

// ss::radix_scatter for 64-bit keys: place by digit offset, the items of
// the digit in earlier warps, and those in earlier lanes of the warp
__global__ void scatter64(const uint64_t* keys, const int32_t* idx,
                          int32_t n, int shift, const int32_t* offsets,
                          uint64_t* keys_out, int32_t* idx_out,
                          const int64_t* n_dev = nullptr) {
  __shared__ int32_t wcount[SS_WARPS][SS_DIGITS];
  const int32_t nb = pass_blocks(&n, n_dev);
  if ((int32_t)blockIdx.x >= nb) return;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  for (int k = t; k < SS_WARPS * SS_DIGITS; k += SS_BLOCK)
    (&wcount[0][0])[k] = 0;
  __syncthreads();
  const int32_t i = blockIdx.x * SS_BLOCK + t;
  const bool live = i < n;
  const uint64_t key = live ? keys[i] : 0ull;
  const uint32_t d = live ? (uint32_t)((key >> shift) & 0xff) : SS_DIGITS;
  const unsigned peers = __match_any_sync(0xffffffffu, d);
  const int rank = __popc(peers & ((1u << lane) - 1u));
  if (live && rank == 0) wcount[warp][d] = __popc(peers);
  __syncthreads();
  if (t < SS_DIGITS) {
    int32_t run = 0;
    for (int w = 0; w < SS_WARPS; ++w) {
      const int32_t c = wcount[w][t];
      wcount[w][t] = run;
      run += c;
    }
  }
  __syncthreads();
  if (live) {
    const int32_t pos = offsets[d * nb + blockIdx.x] +
                        wcount[warp][d] + rank;
    keys_out[pos] = key;
    idx_out[pos] = idx ? idx[i] : i;
  }
}

// the dead flags in the current order, as the last pass's keys
__global__ void pad_keys(const uint8_t* pad, const int32_t* idx, int32_t n,
                         uint64_t* out) {
  const int32_t j = blockIdx.x * T1 + threadIdx.x;
  if (j < n) out[j] = pad[idx[j]];
}

// sk[j] = keys[order[j]]
__global__ void gather_keys(const int64_t* keys, const int32_t* order,
                            int32_t n, int64_t* sk) {
  const int32_t j = blockIdx.x * T1 + threadIdx.x;
  if (j < n) sk[j] = keys[order[j]];
}

// Stable sort of rows 0..n-1 by (pad[i], keys[i], i), keys unsigned with
// `bits` (32 or 64) significant; pad may be NULL (no dead rows). The
// permutation lands in s.order.
inline cudaError_t sort_rows(const KeySortScratch& s, int32_t n, int bits,
                             const uint8_t* pad, cudaStream_t stream) {
  const int blocks = (n + SS_BLOCK - 1) / SS_BLOCK;
  const int passes = bits / 8;
  const uint64_t* kin = (const uint64_t*)s.keys;
  const int32_t* iin = nullptr;
  uint64_t* kb[2] = {(uint64_t*)s.k1, (uint64_t*)s.k2};
  int32_t* ib[2] = {s.i1, s.i2};
  for (int p = 0; p <= passes; ++p) {
    const bool pad_pass = p == passes;
    if (pad_pass && pad == nullptr) break;
    int shift = 8 * p;
    if (pad_pass) {   // keys: the dead flags, in the current order
      uint64_t* pk = (kin == kb[0]) ? kb[1] : kb[0];
      pad_keys<<<grid(n), T1, 0, stream>>>(pad, iin, n, pk);
      kin = pk;
      shift = 0;
    }
    const bool last = pad_pass || (p == passes - 1 && pad == nullptr);
    uint64_t* kout = (kin == kb[0]) ? kb[1] : kb[0];
    int32_t* iout = last ? s.order : ((iin == ib[0]) ? ib[1] : ib[0]);
    hist64<<<blocks, SS_BLOCK, 0, stream>>>(kin, n, shift, s.counts);
    ss::scan_counts<<<1, SS_BLOCK, 0, stream>>>(s.counts, SS_DIGITS * blocks);
    scatter64<<<blocks, SS_BLOCK, 0, stream>>>(kin, iin, n, shift, s.counts,
                                               kout, iout);
    kin = kout;
    iin = iout;
  }
  gather_keys<<<grid(n), T1, 0, stream>>>(s.keys, s.order, n, s.sk);
  return cudaGetLastError();
}

}  // namespace ks
