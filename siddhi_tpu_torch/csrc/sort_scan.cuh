// Building blocks shared by kernels K5 (window_step.cu) and K6
// (aggregate_step.cu): a block-wide prefix scan, and a stable LSD radix
// sort of 32-bit keys that returns the permutation, the counting sort
// with stable placement that replaces every argsort of the reference's
// window and aggregate steps. No library sort.
//
// The sort runs 8-bit digits, least significant first, three launches a
// digit: per-block digit histograms (a [256 x blocks] table, digit
// major), one exclusive scan of that table (so a digit's rows from
// earlier blocks come first), and the scatter, where an item's place is
// its digit's offset for its block, plus the items of the same digit in
// earlier warps of the block, plus those in earlier lanes of its warp
// (__match_any_sync). Each pass is stable, so the whole sort is.
#pragma once

#include <stdint.h>
#include <cuda_runtime.h>

#define SS_BLOCK 1024
#define SS_WARPS (SS_BLOCK / 32)
#define SS_DIGITS 256

namespace ss {

// Inclusive block scan (sum) of one int64 per thread; blockDim.x ==
// SS_BLOCK; `buf` is SS_BLOCK int64 of shared memory. Returns the
// inclusive prefix; *total (if given) receives the block total.
__device__ __forceinline__ int64_t block_scan_sum(int64_t v, int64_t* buf,
                                                  int64_t* total) {
  const int t = threadIdx.x;
  buf[t] = v;
  __syncthreads();
  for (int off = 1; off < SS_BLOCK; off <<= 1) {
    const int64_t add = t >= off ? buf[t - off] : 0;
    __syncthreads();
    buf[t] += add;
    __syncthreads();
  }
  const int64_t r = buf[t];
  if (total) *total = buf[SS_BLOCK - 1];
  __syncthreads();
  return r;
}

// Inclusive block scan (max) of one int64 per thread.
__device__ __forceinline__ int64_t block_scan_max(int64_t v, int64_t* buf) {
  const int t = threadIdx.x;
  buf[t] = v;
  __syncthreads();
  for (int off = 1; off < SS_BLOCK; off <<= 1) {
    const int64_t o = t >= off ? buf[t - off] : INT64_MIN;
    __syncthreads();
    if (o > buf[t]) buf[t] = o;
    __syncthreads();
  }
  const int64_t r = buf[t];
  __syncthreads();
  return r;
}

// Rows [lo, hi) of n owned by thread t when one block walks n rows in
// SS_BLOCK contiguous spans.
__device__ __forceinline__ void span(int64_t n, int64_t* lo, int64_t* hi) {
  const int64_t per = (n + SS_BLOCK - 1) / SS_BLOCK;
  *lo = per * threadIdx.x;
  if (*lo > n) *lo = n;
  *hi = *lo + per;
  if (*hi > n) *hi = n;
}

// The sort's launches take one row of blocks per partition slot
// (blockIdx.y; siddhi_kernels.h part_args): slot k's keys, permutation
// and scratch are k * n further on, its digit table k * 256 * blocks.
__global__ void radix_hist(const uint32_t* keys, int32_t n, int shift,
                           int32_t* counts) {
  __shared__ int32_t hist[SS_DIGITS];
  const int t = threadIdx.x;
  keys += (int64_t)blockIdx.y * n;
  counts += (int64_t)blockIdx.y * SS_DIGITS * gridDim.x;
  if (t < SS_DIGITS) hist[t] = 0;
  __syncthreads();
  const int32_t i = blockIdx.x * SS_BLOCK + t;
  if (i < n) atomicAdd(&hist[(keys[i] >> shift) & 0xff], 1);
  __syncthreads();
  if (t < SS_DIGITS) counts[t * gridDim.x + blockIdx.x] = hist[t];
}

// Exclusive scan of m ints in place, one block (a slot: blockIdx.y).
// With n_dev, the digit table of a sort whose row count the host does
// not know (key_sort.cuh hist64): m is SS_DIGITS a block of *n_dev rows.
__global__ void scan_counts(int32_t* counts, int32_t m,
                            const int64_t* n_dev = nullptr) {
  __shared__ int64_t buf[SS_BLOCK];
  if (n_dev) m = SS_DIGITS * (int32_t)((*n_dev + SS_BLOCK - 1) / SS_BLOCK);
  counts += (int64_t)blockIdx.y * m;
  int64_t lo, hi, s = 0;
  span(m, &lo, &hi);
  for (int64_t i = lo; i < hi; ++i) s += counts[i];
  const int64_t incl = block_scan_sum(s, buf, nullptr);
  int64_t run = incl - s;
  for (int64_t i = lo; i < hi; ++i) {
    const int32_t c = counts[i];
    counts[i] = (int32_t)run;
    run += c;
  }
}

__global__ void radix_scatter(const uint32_t* keys, const int32_t* idx,
                              int32_t n, int shift, const int32_t* offsets,
                              uint32_t* keys_out, int32_t* idx_out) {
  __shared__ int32_t wcount[SS_WARPS][SS_DIGITS];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int64_t po = (int64_t)blockIdx.y * n;
  keys += po;
  if (idx) idx += po;
  offsets += (int64_t)blockIdx.y * SS_DIGITS * gridDim.x;
  keys_out += po;
  idx_out += po;
  for (int k = t; k < SS_WARPS * SS_DIGITS; k += SS_BLOCK)
    (&wcount[0][0])[k] = 0;
  __syncthreads();
  const int32_t i = blockIdx.x * SS_BLOCK + t;
  const bool live = i < n;
  const uint32_t key = live ? keys[i] : 0u;
  // a dead lane's digit (256) matches no live lane's
  const uint32_t d = live ? (key >> shift) & 0xff : SS_DIGITS;
  const unsigned peers = __match_any_sync(0xffffffffu, d);
  const int rank = __popc(peers & ((1u << lane) - 1u));
  if (live && rank == 0) wcount[warp][d] = __popc(peers);
  __syncthreads();
  // per digit: exclusive prefix over the warps of the block
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
    const int32_t pos = offsets[d * gridDim.x + blockIdx.x] +
                        wcount[warp][d] + rank;
    keys_out[pos] = key;
    idx_out[pos] = idx ? idx[i] : i;
  }
}

// Stable sort of keys[n] (only the low `bits` bits are looked at): the
// permutation lands in perm_out (perm_out[j] = index of the j-th
// smallest). keys is left as it was. Scratch: k1, k2 (uint32 [n]), i1,
// i2 (int32 [n]) and counts (int32 [SS_DIGITS * blocks]). With `parts`
// > 1, that many sorts of n keys each, one per partition slot, every
// array a [parts] stack of the above.
inline cudaError_t stable_sort(const uint32_t* keys, int32_t n, int bits,
                               int32_t* perm_out, uint32_t* k1, uint32_t* k2,
                               int32_t* i1, int32_t* i2, int32_t* counts,
                               cudaStream_t stream, int64_t parts = 1) {
  const int blocks = (n + SS_BLOCK - 1) / SS_BLOCK;
  const dim3 grid(blocks, (unsigned)parts), one(1, (unsigned)parts);
  const int passes = bits <= 0 ? 1 : (bits + 7) / 8;
  const uint32_t* kin = keys;
  const int32_t* iin = nullptr;
  for (int p = 0; p < passes; ++p) {
    const bool last = p == passes - 1;
    uint32_t* kout = (p & 1) ? k2 : k1;
    int32_t* iout = last ? perm_out : ((p & 1) ? i2 : i1);
    radix_hist<<<grid, SS_BLOCK, 0, stream>>>(kin, n, 8 * p, counts);
    scan_counts<<<one, SS_BLOCK, 0, stream>>>(counts, SS_DIGITS * blocks);
    radix_scatter<<<grid, SS_BLOCK, 0, stream>>>(kin, iin, n, 8 * p,
                                                 counts, kout, iout);
    kin = kout;
    iin = iout;
  }
  return cudaGetLastError();
}

// Bits needed for keys in [0, max_key].
inline int key_bits(uint64_t max_key) {
  int b = 0;
  while (b < 32 && (max_key >> b) != 0) ++b;
  return b;
}

}  // namespace ss
