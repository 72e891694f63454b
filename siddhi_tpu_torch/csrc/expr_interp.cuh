// The expression interpreter shared by kernels K2 (expr_eval.cu) and K3
// (nfa_parallel.cu): one typed postfix program (ops/expr.py
// ProgramBuilder) run by one thread for one row, so the reference's
// float, null and NaN rules live in one place.
//
// Semantics kept from the reference (and from Java), bit for bit:
//  - operands are widened to the promote() type at plan time (OP_CAST);
//  - INT/LONG + - * wrap: done in unsigned arithmetic, since signed
//    overflow is undefined in C++;
//  - INT/LONG / and % truncate toward zero, % takes the sign of the
//    dividend; MIN / -1 gives MIN and MIN % -1 gives 0, as XLA defines
//    them (the hardware instruction would trap);
//  - / and % by zero give null with value 0, for every numeric type,
//    except % by a non-zero constant (OP_MOD arg MOD_CONST), whose zero
//    test ran at plan time: a subnormal one reads as zero here and gives
//    NaN;
//  - any null operand of math gives null with value 0;
//  - a null operand of a compare gives FALSE (not null);
//  - AND/OR read null as FALSE, NOT(null) is TRUE, IS NULL reads the mask;
//  - float operations are single IEEE operations in round-to-nearest,
//    written with the _rn intrinsics so nvcc never contracts a multiply
//    and an add into an FMA;
//  - subnormal floats are flushed as the reference's XLA backends flush
//    them: + - * / and the compares read subnormal operands as zero of
//    the same sign, + - * / flush subnormal results, FLOAT -> DOUBLE
//    reads a subnormal as zero; % (fmod) reads and returns them as they
//    are (only its zero-divisor test flushes);
//  - NaN results carry the bits the reference's x86 CPU gives them
//    (nan_rule), not the card's canonical NaN.
// The planner applies the reference compiler's algebraic rewrites and
// folds constant subexpressions before the program gets here
// (ops/expr.py): a float divided by a constant is a multiply by its
// reciprocal, x*1, x+0 and x-0 are x.
#pragma once

#include <cfloat>

#include "siddhi_kernels.h"

namespace siddhi {

// OP_MOD's arg (ops/expr.py MOD_POW2, MOD_CONST)
enum ModArg { MOD_PLAIN = 0, MOD_POW2 = 1, MOD_CONST = 2 };


struct Slot {
  int64_t v;  // INT/STRING: int32 sign-extended; LONG; BOOL 0/1;
              // FLOAT: float bits in the low word; DOUBLE: double bits
  bool null;
};

__device__ __forceinline__ float as_f(int64_t v) {
  return __int_as_float((int)v);
}
__device__ __forceinline__ int64_t of_f(float f) {
  return (int64_t)(uint32_t)__float_as_int(f);
}
__device__ __forceinline__ double as_d(int64_t v) {
  return __longlong_as_double(v);
}
__device__ __forceinline__ int64_t of_d(double d) {
  return __double_as_longlong(d);
}

// a subnormal as the zero of its sign (the reference's flush-to-zero)
__device__ __forceinline__ float flush(float x) {
  return fabsf(x) < FLT_MIN ? copysignf(0.0f, x) : x;
}
__device__ __forceinline__ double flush(double x) {
  return fabs(x) < DBL_MIN ? copysign(0.0, x) : x;
}

// NaN results as the reference's x86 CPU makes them (the card would
// return its one canonical NaN): a NaN operand propagates, the first
// one first, made quiet; an invalid operation on numbers gives the
// negative "indefinite" NaN.
__device__ __forceinline__ float nan_rule(float r, float x, float y) {
  if (!isnan(r)) return r;
  if (isnan(x)) return __int_as_float(__float_as_int(x) | 0x00400000);
  if (isnan(y)) return __int_as_float(__float_as_int(y) | 0x00400000);
  return __int_as_float((int)0xffc00000u);
}
__device__ __forceinline__ double nan_rule(double r, double x, double y) {
  const long long quiet = 0x0008000000000000ll;
  if (!isnan(r)) return r;
  if (isnan(x)) return __longlong_as_double(__double_as_longlong(x) | quiet);
  if (isnan(y)) return __longlong_as_double(__double_as_longlong(y) | quiet);
  return __longlong_as_double((long long)0xfff8000000000000ull);
}

// x86 fmod: NaN operands propagate, an infinite dividend is invalid, a
// finite dividend over an infinite divisor is the dividend (the divisor
// is never zero here: the zero test comes first)
__device__ __forceinline__ float fmod_ref(float x, float y) {
  if (isnan(x) || isnan(y) || isinf(x)) return nan_rule(NAN, x, y);
  return fmodf(x, y);
}
__device__ __forceinline__ double fmod_ref(double x, double y) {
  if (isnan(x) || isnan(y) || isinf(x)) return nan_rule((double)NAN, x, y);
  return fmod(x, y);
}

// % by a literal +-2^k, k >= 0, as the reference's compiled code does it
// (not through fmod): a subnormal dividend gives a zero of its sign, an
// infinite one a quiet NaN of its sign
__device__ __forceinline__ float fmod_pow2(float x, float y) {
  if (isnan(x)) return nan_rule(x, x, y);
  if (isinf(x)) return copysignf(__int_as_float(0x7fc00000), x);
  if (flush(x) == 0.0f) return copysignf(0.0f, x);
  return fmodf(x, y);
}
__device__ __forceinline__ double fmod_pow2(double x, double y) {
  if (isnan(x)) return nan_rule(x, x, y);
  if (isinf(x)) {
    return copysign(__longlong_as_double(0x7ff8000000000000ll), x);
  }
  if (flush(x) == 0.0) return copysign(0.0, x);
  return fmod(x, y);
}

// FLOAT -> DOUBLE: a subnormal reads as zero, a NaN keeps sign and payload
__device__ __forceinline__ double widen(float x) {
  if (isnan(x)) {
    const unsigned u = (unsigned)__float_as_int(x);
    const unsigned long long d = ((unsigned long long)(u >> 31) << 63) |
        0x7ff8000000000000ull | ((unsigned long long)(u & 0x7fffff) << 29);
    return __longlong_as_double((long long)d);
  }
  return (double)flush(x);
}

__device__ __forceinline__ int64_t load_col(const void* col, int type,
                                            int64_t row) {
  switch (type) {
    case VT_LONG:
    case VT_DOUBLE:
      return ((const int64_t*)col)[row];
    case VT_FLOAT:
      return (int64_t)((const uint32_t*)col)[row];
    case VT_BOOL:
      return ((const bool*)col)[row] ? 1 : 0;
    default:  // VT_INT, VT_STRING
      return ((const int32_t*)col)[row];
  }
}

__device__ __forceinline__ void store_col(void* col, int type, int64_t row,
                                          int64_t v) {
  switch (type) {
    case VT_LONG:
    case VT_DOUBLE:
      ((int64_t*)col)[row] = v;
      break;
    case VT_FLOAT:
      ((uint32_t*)col)[row] = (uint32_t)v;
      break;
    case VT_BOOL:
      ((bool*)col)[row] = v != 0;
      break;
    default:
      ((int32_t*)col)[row] = (int32_t)v;
      break;
  }
}

__device__ __forceinline__ int64_t cast(int64_t v, int from, int to) {
  if (to == VT_LONG) return v;  // from INT: already sign-extended
  if (to == VT_FLOAT) {
    return of_f(from == VT_INT ? __int2float_rn((int)v) : __ll2float_rn(v));
  }
  // to == VT_DOUBLE
  if (from == VT_FLOAT) return of_d(widen(as_f(v)));
  return of_d(from == VT_INT ? (double)(int)v : __ll2double_rn(v));
}

// math on one promoted type; `zero` reports a zero divisor
__device__ __forceinline__ int64_t math(int op, int type, int64_t a,
                                        int64_t b, int mod_arg, bool* zero) {
  if (type == VT_INT) {
    const int32_t x = (int32_t)a, y = (int32_t)b;
    const uint32_t ux = (uint32_t)x, uy = (uint32_t)y;
    switch (op) {
      case OP_ADD: return (int32_t)(ux + uy);
      case OP_SUB: return (int32_t)(ux - uy);
      case OP_MUL: return (int32_t)(ux * uy);
      default:
        if (y == 0) { *zero = true; return 0; }
        if (y == -1) return op == OP_DIV ? (int32_t)(0u - ux) : 0;
        return op == OP_DIV ? x / y : x % y;
    }
  }
  if (type == VT_LONG) {
    const uint64_t ux = (uint64_t)a, uy = (uint64_t)b;
    switch (op) {
      case OP_ADD: return (int64_t)(ux + uy);
      case OP_SUB: return (int64_t)(ux - uy);
      case OP_MUL: return (int64_t)(ux * uy);
      default:
        if (b == 0) { *zero = true; return 0; }
        if (b == -1) return op == OP_DIV ? (int64_t)(0ull - ux) : 0;
        return op == OP_DIV ? a / b : a % b;
    }
  }
  if (type == VT_FLOAT) {
    const float x = flush(as_f(a)), y = flush(as_f(b));
    float r;
    switch (op) {
      case OP_ADD: r = __fadd_rn(x, y); break;
      case OP_SUB: r = __fsub_rn(x, y); break;
      case OP_MUL: r = __fmul_rn(x, y); break;
      case OP_DIV:
        if (y == 0.0f) { *zero = true; return 0; }
        r = __fdiv_rn(x, y);
        break;
      default:
        if (y == 0.0f) {
          // a non-zero constant divisor that reads as zero: NaN, not null
          if (mod_arg == MOD_CONST) return of_f(nan_rule(NAN, as_f(a), 0.0f));
          *zero = true;
          return 0;
        }
        return of_f(mod_arg == MOD_POW2 ? fmod_pow2(as_f(a), as_f(b))
                                        : fmod_ref(as_f(a), as_f(b)));
    }
    return of_f(flush(nan_rule(r, x, y)));
  }
  const double x = flush(as_d(a)), y = flush(as_d(b));
  double r;
  switch (op) {
    case OP_ADD: r = __dadd_rn(x, y); break;
    case OP_SUB: r = __dsub_rn(x, y); break;
    case OP_MUL: r = __dmul_rn(x, y); break;
    case OP_DIV:
      if (y == 0.0) { *zero = true; return 0; }
      r = __ddiv_rn(x, y);
      break;
    default:
      if (y == 0.0) {
        if (mod_arg == MOD_CONST) {
          return of_d(nan_rule((double)NAN, as_d(a), 0.0));
        }
        *zero = true;
        return 0;
      }
      return of_d(mod_arg == MOD_POW2 ? fmod_pow2(as_d(a), as_d(b))
                                      : fmod_ref(as_d(a), as_d(b)));
  }
  return of_d(flush(nan_rule(r, x, y)));
}

// OP_CONVERT: the reference's astype where it is not a widening. Ints
// narrow by wrapping; FLOAT/DOUBLE -> INT/LONG truncate toward zero and
// saturate, a NaN giving 0 (XLA's conversion); DOUBLE -> FLOAT rounds to
// nearest, reads a subnormal as zero and flushes a subnormal result, a
// NaN keeping its sign and its high payload bits (x86's cvtsd2ss); BOOL
// is 0 or 1.
__device__ __forceinline__ int64_t convert(int64_t v, int from, int to) {
  if (from == VT_FLOAT || from == VT_DOUBLE) {
    const double x = from == VT_FLOAT ? (double)as_f(v) : as_d(v);
    if (to == VT_FLOAT) {
      if (isnan(x)) {
        const unsigned long long u = (unsigned long long)v;
        return (int64_t)(uint32_t)(((u >> 63) << 31) | 0x7fc00000u |
                                   ((u >> 29) & 0x3fffffu));
      }
      return of_f(flush(__double2float_rn(flush(x))));
    }
    if (to == VT_DOUBLE) return of_d(widen(as_f(v)));
    if (isnan(x)) return 0;
    if (to == VT_INT) {
      if (x >= 2147483648.0) return 2147483647;
      if (x < -2147483648.0) return -2147483647 - 1;
      return (int32_t)x;
    }
    if (x >= 9223372036854775808.0) return 9223372036854775807ll;
    if (x < -9223372036854775808.0) return -9223372036854775807ll - 1;
    return (int64_t)x;
  }
  if (from == VT_BOOL) v = v ? 1 : 0;
  if (to == VT_INT) return (int32_t)v;   // sign-extended
  if (to == VT_LONG) return v;
  return cast(v, VT_LONG, to);
}

// OP_MATH over one operand of its result type (every function but abs
// reads a DOUBLE), as the reference's XLA code computes it: abs is a
// sign bit; ceil, floor, round and signum read a subnormal operand as
// zero, signum keeps a NaN and a zero's sign, round halves to even. The
// library functions are CUDA's double-precision ones (not bit-equal to
// XLA's: held to 2 ulp); sqrt, ln, log10 and atan read a subnormal
// operand as zero, exp flushes a subnormal result, asin gives a zero of
// the operand's sign below twice the smallest normal (ops/expr.py
// FLUSH_IN, FLUSH_OUT, ASIN_ZERO).
__device__ __forceinline__ int64_t math_fn(int fn, int type, int64_t v) {
  if (fn == MF_ABS) {
    switch (type) {
      case VT_INT: {
        const int32_t x = (int32_t)v;
        return (int32_t)(x < 0 ? 0u - (uint32_t)x : (uint32_t)x);
      }
      case VT_LONG:
        return (int64_t)(v < 0 ? 0ull - (uint64_t)v : (uint64_t)v);
      case VT_FLOAT: return of_f(fabsf(as_f(v)));
      default: return of_d(fabs(as_d(v)));
    }
  }
  const double x = as_d(v), fx = flush(x);
  switch (fn) {
    case MF_CEIL: return of_d(ceil(fx));
    case MF_FLOOR: return of_d(floor(fx));
    case MF_ROUND: return of_d(rint(fx));
    case MF_SIGNUM:
      return of_d(isnan(x) || fx == 0.0 ? fx : copysign(1.0, fx));
    case MF_SQRT: return of_d(sqrt(fx));
    case MF_EXP: return of_d(flush(exp(x)));
    case MF_LN: return of_d(log(fx));
    case MF_LOG10: return of_d(log10(fx));
    case MF_SIN: return of_d(sin(x));
    case MF_COS: return of_d(cos(x));
    case MF_TAN: return of_d(tan(x));
    case MF_ASIN:
      return of_d(fabs(x) < 2 * DBL_MIN ? copysign(0.0, x) : asin(x));
    case MF_ACOS: return of_d(acos(x));
    default: return of_d(atan(fx));
  }
}

// a createSet() element as its int64 lane (ops/expr.py set_element)
__device__ __forceinline__ int64_t set_element(int64_t v, int type) {
  if (type == VT_FLOAT) return of_d(widen(as_f(v)));
  if (type == VT_BOOL) return v ? 1 : 0;
  return v;   // INT/STRING sign-extended, LONG, DOUBLE bits
}

template <typename T>
__device__ __forceinline__ bool compare(int op, T x, T y) {
  switch (op) {
    case OP_EQ: return x == y;
    case OP_NE: return x != y;
    case OP_GT: return x > y;
    case OP_GE: return x >= y;
    case OP_LT: return x < y;
    default: return x <= y;
  }
}


// Run one program for one row. `ins(pc)` and `cst(i)` read the code and
// the constant pool; `load(arg, type, &slot)` pushes LOAD arg's value;
// `out(arg, type, slot)` takes an OP_OUT. -> whether every OP_KEEP held.
template <class Ins, class Cst, class Load, class Out>
__device__ __forceinline__ bool interp(int n_code, Ins ins, Cst cst,
                                       Load load, Out out) {
  Slot st[SIDDHI_MAX_STACK];
  int sp = 0;
  bool keep = true;
  for (int pc = 0; pc < n_code; ++pc) {
    const int word = ins(pc);
    const int op = word & 0xff;
    const int type = (word >> 8) & 0xff;
    const int arg = word >> 16;
    switch (op) {
      case OP_LOAD:
        load(arg, type, &st[sp]);
        ++sp;
        break;
      case OP_CONST:
        st[sp].v = cst(arg);
        st[sp].null = false;
        ++sp;
        break;
      case OP_NULLC:
        st[sp].v = 0;
        st[sp].null = true;
        ++sp;
        break;
      case OP_CAST:
        st[sp - 1].v = cast(st[sp - 1].v, arg, type);
        break;
      case OP_ADD: case OP_SUB: case OP_MUL: case OP_DIV: case OP_MOD: {
        Slot& l = st[sp - 2];
        const Slot r = st[sp - 1];
        --sp;
        bool zero = false;
        const int64_t v = math(op, type, l.v, r.v, arg, &zero);
        l.null = l.null || r.null || zero;
        l.v = l.null ? 0 : v;
        break;
      }
      case OP_EQ: case OP_NE: case OP_GT: case OP_GE: case OP_LT:
      case OP_LE: {
        Slot& l = st[sp - 2];
        const Slot r = st[sp - 1];
        --sp;
        bool c;
        switch (type) {
          case VT_FLOAT:
            c = compare(op, flush(as_f(l.v)), flush(as_f(r.v)));
            break;
          case VT_DOUBLE:
            c = compare(op, flush(as_d(l.v)), flush(as_d(r.v)));
            break;
          default: c = compare(op, l.v, r.v); break;
        }
        l.v = (c && !l.null && !r.null) ? 1 : 0;
        l.null = false;
        break;
      }
      case OP_AND: case OP_OR: {
        Slot& l = st[sp - 2];
        const Slot r = st[sp - 1];
        --sp;
        const bool a = l.v && !l.null, b = r.v && !r.null;
        l.v = (op == OP_AND ? (a && b) : (a || b)) ? 1 : 0;
        l.null = false;
        break;
      }
      case OP_ZNULL:
      case OP_NEG: {
        Slot& x = st[sp - 1];
        if (op == OP_NEG) {  // a sign flip, no flush (XLA's negate)
          x.v ^= type == VT_FLOAT ? (int64_t)0x80000000ll
                                  : (int64_t)0x8000000000000000ull;
        }
        if (x.null) x.v = 0;
        break;
      }
      case OP_NOT: {
        Slot& x = st[sp - 1];
        x.v = (x.v && !x.null) ? 0 : 1;
        x.null = false;
        break;
      }
      case OP_ISNULL: {
        Slot& x = st[sp - 1];
        x.v = x.null ? 1 : 0;
        x.null = false;
        break;
      }
      case OP_CONVERT:
        st[sp - 1].v = convert(st[sp - 1].v, arg, type);
        break;
      case OP_COALESCE: case OP_DEFAULT: {
        Slot& l = st[sp - 2];
        const Slot r = st[sp - 1];
        --sp;
        if (l.null && (op == OP_DEFAULT || !r.null)) l.v = r.v;
        l.null = l.null && r.null;
        break;
      }
      case OP_IFELSE: {
        const Slot c = st[sp - 3];
        sp -= 2;
        if (!(c.v && !c.null)) st[sp - 1] = st[sp + 1];
        else st[sp - 1] = st[sp];
        break;
      }
      case OP_MAXIMUM: case OP_MINIMUM: {
        Slot& l = st[sp - 2];
        const Slot r = st[sp - 1];
        --sp;
        const int cmp = op == OP_MAXIMUM ? OP_GT : OP_LT;
        bool c;
        switch (type) {
          case VT_FLOAT:
            c = compare(cmp, flush(as_f(r.v)), flush(as_f(l.v)));
            break;
          case VT_DOUBLE:
            c = compare(cmp, flush(as_d(r.v)), flush(as_d(l.v)));
            break;
          default: c = compare(cmp, r.v, l.v); break;
        }
        if (((c && !r.null) || l.null) && !r.null) l.v = r.v;
        l.null = l.null && r.null;
        break;
      }
      case OP_MATH: {
        Slot& x = st[sp - 1];
        x.v = x.null ? 0 : math_fn(arg, type, x.v);
        break;
      }
      case OP_POW: {
        Slot& l = st[sp - 2];
        const Slot r = st[sp - 1];
        --sp;
        l.null = l.null || r.null;
        l.v = l.null ? 0 : of_d(flush(pow(as_d(l.v), as_d(r.v))));
        break;
      }
      case OP_SETELEM: {
        Slot& x = st[sp - 1];
        x.v = x.null ? SIDDHI_SET_EMPTY : set_element(x.v, type);
        x.null = false;
        break;
      }
      case OP_SETSIZE: {
        Slot& x = st[sp - 1];
        x.v = x.v != SIDDHI_SET_EMPTY ? 1 : 0;
        break;
      }
      case OP_KEEP:
        --sp;
        keep = keep && st[sp].v && !st[sp].null;
        break;
      default:  // OP_OUT
        --sp;
        out(arg, type, st[sp]);
        break;
    }
  }
  return keep;
}

}  // namespace siddhi
