// Kernel K1: decode one packed ingest buffer into an EventBatch.
//
// Replaces the reference's jitted decode, siddhi_tpu/core/ingest.py
// unpack_buffer (:397) with _bitcast_lane (:390). Format (core/ingest.py
// layout): an int64 header [n, base_ts, now, ts_stride, base_0..base_C-1]
// followed by one 8-byte-padded lane per timestamp/column, each in one
// of the codes of LaneCode. The reference compiles one XLA program per
// encoding tuple; here the tuple is runtime data (the lane descriptors
// in the by-value arguments), so a new encoding never rebuilds anything.
//
// Design: one thread per row decodes every lane of that row, so each
// lane is read once, coalesced, and each output column written once.
// The work is a few integer operations per byte: the kernel is bound by
// memory bytes (buffer in, columns + masks out), about 90 bytes a row for
// the bench stream, i.e. microseconds per 65,536-row chunk at HBM rate.
// What it does about that: nothing is staged or re-read; the header is
// read through the L1/L2 cache by every thread (one line), and nothing
// is materialised but the outputs.
//
// Semantics kept from the reference, bit for bit:
//  - padding rows (row >= n) get ts = base_ts; their columns decode the
//    zero-padded lane like any row;
//  - d8/d16/d32 deltas are unsigned and are added to the int64 base in
//    wrapping arithmetic, then narrowed (INT wraps mod 2^32);
//  - a FLOAT 'c' lane is a float64 bit pattern rounded to float32, with
//    subnormals flushed to zero on the way in and out and NaN bits kept
//    as the reference's (x86) conversion keeps them;
//  - a BOOL 'c' lane is base != 0; b1 bits are LSB-first;
//  - f32/f64/raw64 lanes are copied as raw bits (NaN payloads and -0.0
//    survive).
//
// A tenant pool's round (serving/pool.py, the reference's vmap of
// unpack_buffer at pool.py:1407-1411) is one (slots, total) buffer, one
// row a slot with its own header, all under one encoding: the launch
// takes the slot on blockIdx.y, its buffer row and output rows moved
// there by part_args (siddhi_kernels.h). An idle slot's row is zeros
// but for the round clock, and decodes to n = 0 rows.
#include <cfloat>

#include "siddhi_kernels.h"

namespace {

__device__ __forceinline__ float flush(float x) {
  return fabsf(x) < FLT_MIN ? copysignf(0.0f, x) : x;
}
__device__ __forceinline__ double flush(double x) {
  return fabs(x) < DBL_MIN ? copysign(0.0, x) : x;
}

// FLOAT 'c' lane: float64 -> float32 as the reference's x86 conversion
// does it (subnormals flushed in and out, a NaN keeps its sign and the
// top of its payload, made quiet)
__device__ __forceinline__ float narrow(double d) {
  if (isnan(d)) {
    const unsigned long long u = (unsigned long long)__double_as_longlong(d);
    return __int_as_float((int)((unsigned)((u >> 63) << 31) | 0x7fc00000u |
                                (unsigned)((u >> 29) & 0x7fffff)));
  }
  return flush(__double2float_rn(flush(d)));
}

__device__ __forceinline__ int64_t wrap_add(int64_t a, uint64_t b) {
  return (int64_t)((uint64_t)a + b);
}

__device__ __forceinline__ int64_t int_lane(const LaneDesc& d,
                                            const uint8_t* buf, int64_t base,
                                            int64_t stride, int row) {
  const uint8_t* lane = buf + d.offset;
  switch (d.code) {
    case LANE_AFF:
      return wrap_add(base, (uint64_t)stride * (uint64_t)row);
    case LANE_D8:
      return wrap_add(base, lane[row]);
    case LANE_D16:
      return wrap_add(base, ((const uint16_t*)lane)[row]);
    case LANE_D32:
      return wrap_add(base, ((const uint32_t*)lane)[row]);
    case LANE_RAW64:
      return ((const int64_t*)lane)[row];
    default:  // LANE_C
      return base;
  }
}

__global__ void unpack_packed_kernel(const __grid_constant__ UnpackParams p0) {
  const UnpackParams& p = part_args(p0);
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= p.capacity) return;
  const int64_t* hdr = (const int64_t*)p.buf;
  const int64_t n = hdr[0];
  const int64_t base_ts = hdr[1];
  const int64_t stride = hdr[3];
  const bool valid = row < n;

  for (int l = 0; l < p.n_lanes; ++l) {
    const LaneDesc d = p.lanes[l];
    const int64_t base = l == 0 ? base_ts : hdr[3 + l];
    const uint8_t* lane = p.buf + d.offset;
    switch (d.out_type) {
      case OUT_I32:
        ((int32_t*)d.out)[row] = (int32_t)int_lane(d, p.buf, base, stride, row);
        break;
      case OUT_I64: {
        int64_t v = int_lane(d, p.buf, base, stride, row);
        if (l == 0 && !valid) v = base_ts;
        ((int64_t*)d.out)[row] = v;
        break;
      }
      case OUT_F32:
        if (d.code == LANE_C) {
          ((float*)d.out)[row] = narrow(__longlong_as_double(base));
        } else {
          ((uint32_t*)d.out)[row] = ((const uint32_t*)lane)[row];
        }
        break;
      case OUT_F64:
        ((int64_t*)d.out)[row] =
            d.code == LANE_C ? base : ((const int64_t*)lane)[row];
        break;
      default:  // OUT_BOOL
        ((bool*)d.out)[row] = d.code == LANE_C
            ? base != 0
            : ((lane[row >> 3] >> (row & 7)) & 1) != 0;
        break;
    }
  }
  p.nulls[row] = false;
  p.kind[row] = 0;
  p.valid[row] = valid;
}

}  // namespace

extern "C" cudaError_t siddhi_unpack_packed(const UnpackParams* p,
                                            cudaStream_t stream) {
  const int threads = 256;
  const int blocks = (p->capacity + threads - 1) / threads;
  unpack_packed_kernel<<<dim3(blocks, (unsigned)p->n_part), threads, 0,
                         stream>>>(*p);
  return cudaGetLastError();
}
