// The reference's lane arithmetic on the card, shared by kernels K6
// (aggregate_step.cu) and K11 (aggregation_step.cu), bit-equal to the
// port's plain versions (ops/keyed.py add, minimum, maximum):
// subnormal operands and results read as zero (the reference's compiled
// CPU code runs with both flags set); the __d*_rn intrinsics keep nvcc
// from fusing what the reference does not fuse; a NaN result takes the
// bits ops/keyed.py _nan_pick gives it; min/max follow XLA's CPU
// minimum/maximum.
#pragma once

#include <cfloat>
#include <stdint.h>
#include <cuda_runtime.h>

namespace lm {

__device__ __forceinline__ double flush(double x) {
  return fabs(x) < DBL_MIN ? copysign(0.0, x) : x;
}
__device__ __forceinline__ float flush(float x) {
  return fabsf(x) < FLT_MIN ? copysignf(0.0f, x) : x;
}
__device__ __forceinline__ int32_t flush(int32_t x) { return x; }
__device__ __forceinline__ int64_t flush(int64_t x) { return x; }

// NaN results as the plain version's lanes make them (ops/keyed.py
// _nan_pick; the card would return its canonical NaN): a NaN second
// operand propagates first, then a NaN first operand, made quiet; an
// invalid operation on numbers gives the negative indefinite NaN.
// nan_pick(r, p, q): p's NaN before q's.
__device__ __forceinline__ double nan_pick(double r, double a, double b) {
  const long long q = 0x0008000000000000ll;
  if (!isnan(r)) return r;
  if (isnan(a)) return __longlong_as_double(__double_as_longlong(a) | q);
  if (isnan(b)) return __longlong_as_double(__double_as_longlong(b) | q);
  return __longlong_as_double((long long)0xfff8000000000000ull);
}
__device__ __forceinline__ float nan_pick(float r, float a, float b) {
  if (!isnan(r)) return r;
  if (isnan(a)) return __int_as_float(__float_as_int(a) | 0x00400000);
  if (isnan(b)) return __int_as_float(__float_as_int(b) | 0x00400000);
  return __int_as_float((int)0xffc00000u);
}

__device__ __forceinline__ double add(double a, double b) {
  return flush(nan_pick(__dadd_rn(flush(a), flush(b)), b, a));
}
__device__ __forceinline__ float add(float a, float b) {
  return flush(nan_pick(__fadd_rn(flush(a), flush(b)), b, a));
}
__device__ __forceinline__ int64_t add(int64_t a, int64_t b) {
  return (int64_t)((uint64_t)a + (uint64_t)b);
}
__device__ __forceinline__ int32_t add(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}

template <typename T> __device__ __forceinline__ bool sgn(T x) {
  return x < 0;
}
template <> __device__ __forceinline__ bool sgn<double>(double x) {
  return signbit(x);
}
template <> __device__ __forceinline__ bool sgn<float>(float x) {
  return signbit(x);
}
template <typename T> __device__ __forceinline__ bool is_nan(T x) {
  return x != x;
}

// XLA's CPU minimum / maximum (ops/keyed.py minimum / maximum)
template <typename T> __device__ __forceinline__ T vmin(T a, T b) {
  const T fa = flush(a), fb = flush(b);
  const bool neg = sgn(fa);
  const T x = neg ? fb : fa, y = neg ? fa : fb;
  return (is_nan(x) || x < y) ? x : y;
}
template <typename T> __device__ __forceinline__ T vmax(T a, T b) {
  const T fa = flush(a), fb = flush(b);
  const bool neg = sgn(fa);
  const T x = neg ? fa : fb, y = neg ? fb : fa;
  return (is_nan(x) || x > y) ? x : y;
}
template <> __device__ __forceinline__ int32_t vmin(int32_t a, int32_t b) {
  return a < b ? a : b;
}
template <> __device__ __forceinline__ int64_t vmin(int64_t a, int64_t b) {
  return a < b ? a : b;
}
template <> __device__ __forceinline__ int32_t vmax(int32_t a, int32_t b) {
  return a > b ? a : b;
}
template <> __device__ __forceinline__ int64_t vmax(int64_t a, int64_t b) {
  return a > b ? a : b;
}

}  // namespace lm
