// The group table shared by kernels K6 (aggregate_step.cu) and F
// (session_step.cu): the reference's key hash (ops/keyed.py mix64 :25,
// hash_columns :33) and its open-addressing lookup_or_insert (:50) in
// rounds of 16 probes, bit-equal to the port's plain version.
#pragma once

#include <stdint.h>
#include <cuda_runtime.h>

#include "siddhi_kernels.h"
#include "sort_scan.cuh"

namespace kd {

constexpr int64_t HASH_SEED = 1469598103934665603LL;
constexpr int64_t NULL_LANE = -987654321987654321LL;

__device__ __forceinline__ int64_t mix64(int64_t h, int64_t v) {
  h = h ^ (int64_t)((uint64_t)v + 0x9E3779B97F4A7C15ULL);
  h = (int64_t)((uint64_t)(h ^ (h >> 30)) * 0xBF58476D1CE4E5B9ULL);
  h = (int64_t)((uint64_t)(h ^ (h >> 27)) * 0x94D049BB133111EBULL);
  return h ^ (h >> 31);
}

// one key column as the int64 lane the hash mixes (ops/keyed.py
// key_lane): float bits, integers widened, a null as NULL_LANE
__device__ __forceinline__ int64_t key_lane(const void* col, int type,
                                            const bool* nulls, int64_t i) {
  if (nulls[i]) return NULL_LANE;
  switch (type) {
    case VT_DOUBLE: return __double_as_longlong(((const double*)col)[i]);
    case VT_FLOAT: return __float_as_int(((const float*)col)[i]);
    case VT_LONG: return ((const int64_t*)col)[i];
    case VT_BOOL: return ((const bool*)col)[i] ? 1 : 0;
    default: return ((const int32_t*)col)[i];   // INT, STRING codes
  }
}

// the probe rounds of lookup_or_insert over a table of K slots, by one
// block: `slot_out` gets each active row's slot, -1 where the probe ran
// out (and for inactive rows); -> the rows lost, in every thread
static __device__ int64_t probe_table(int32_t B, int32_t K,
                                      const int64_t* keys, const bool* used,
                                      int64_t* new_keys, bool* new_used,
                                      const int64_t* hk,
                                      const uint8_t* active,
                                      int32_t* slot_out, int32_t* prb,
                                      uint8_t* flags, int32_t* claim,
                                      int64_t* buf) {
  for (int32_t k = threadIdx.x; k < K; k += SS_BLOCK) {
    new_keys[k] = keys[k];
    new_used[k] = used[k];
  }
  for (int32_t i = threadIdx.x; i < B; i += SS_BLOCK) {
    const int64_t key = hk[i];
    const int64_t ab = key == INT64_MIN ? key : (key < 0 ? -key : key);
    int64_t s = ab % K;
    if (s < 0) s += K;
    prb[i] = (int32_t)s;
    flags[i] = active[i] ? 0 : 1;    // bit 0: placed
    slot_out[i] = -1;
  }
  __syncthreads();
  for (int round = 0; round < 16; ++round) {
    int64_t pend = 0, total;
    for (int32_t i = threadIdx.x; i < B; i += SS_BLOCK)
      pend += !(flags[i] & 1);
    ss::block_scan_sum(pend, buf, &total);
    if (total == 0) break;
    for (int32_t k = threadIdx.x; k < K; k += SS_BLOCK) claim[k] = B;
    __syncthreads();
    for (int32_t i = threadIdx.x; i < B; i += SS_BLOCK) {
      if (flags[i] & 1) continue;
      const bool want = !new_used[prb[i]];
      flags[i] = want ? 2 : 0;
      if (want) atomicMin(&claim[prb[i]], i);
    }
    __syncthreads();
    for (int32_t i = threadIdx.x; i < B; i += SS_BLOCK) {
      const int32_t s = prb[i];
      if ((flags[i] & 2) && claim[s] == i) {
        new_keys[s] = hk[i];
        new_used[s] = true;
      }
    }
    __syncthreads();
    for (int32_t i = threadIdx.x; i < B; i += SS_BLOCK) {
      if (flags[i] & 1) continue;
      const int32_t s = prb[i];
      if (new_used[s] && new_keys[s] == hk[i]) {
        slot_out[i] = s;
        flags[i] = 1;
      } else {
        flags[i] = 0;
        prb[i] = s + 1 == K ? 0 : s + 1;
      }
    }
    __syncthreads();
  }
  int64_t lost = 0, total;
  for (int32_t i = threadIdx.x; i < B; i += SS_BLOCK)
    lost += active[i] && slot_out[i] < 0;
  ss::block_scan_sum(lost, buf, &total);
  return total;
}

}  // namespace kd
