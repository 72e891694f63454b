// Shared argument layouts of the hand-written CUDA kernels of
// siddhi_tpu_torch. Plain C: each kernel source is built by nvcc into a
// shared library with a C interface and called through ctypes
// (siddhi_tpu_torch/_kernels.py mirrors these structs field by field).
//
// Every launcher takes its arguments as one struct, passes it to the
// kernel by value (it lands in the kernel's constant parameter bank, so
// the per-lane descriptors and the expression program are read by all
// threads of a warp at once), launches on the caller's stream,
// allocates nothing and returns cudaGetLastError().
#pragma once

#include <stdint.h>
#include <cuda_runtime.h>

#ifdef __cplusplus
extern "C" {
#endif

// ---- K1: packed ingest decode (unpack_packed.cu) -------------------------

#define SIDDHI_MAX_LANES 64

// lane encodings (core/ingest.py LANE_CODES)
enum LaneCode {
  LANE_C = 0, LANE_AFF = 1, LANE_D8 = 2, LANE_D16 = 3, LANE_D32 = 4,
  LANE_F32 = 5, LANE_F64 = 6, LANE_RAW64 = 7, LANE_B1 = 8
};

// output column types (core/ingest.py _OUT_TYPES)
enum OutType { OUT_I32 = 0, OUT_I64 = 1, OUT_F32 = 2, OUT_F64 = 3, OUT_BOOL = 4 };

typedef struct {
  int64_t offset;   // byte offset of the lane in the buffer
  void* out;        // output column [capacity]
  int32_t code;     // LaneCode
  int32_t out_type; // OutType
} LaneDesc;

typedef struct {
  const uint8_t* buf;  // int64 header [n, base_ts, now, stride, base_i...] + lanes
  bool* nulls;         // [capacity], written all false (shared by every column)
  int32_t* kind;       // [capacity], written CURRENT (0)
  bool* valid;         // [capacity], row < n
  int32_t capacity;
  int32_t n_lanes;     // lane 0 = timestamps (out = int64 ts), lane 1+i = column i
  LaneDesc lanes[SIDDHI_MAX_LANES];
} UnpackParams;

cudaError_t siddhi_unpack_packed(const UnpackParams* p, cudaStream_t stream);

// ---- K2: expression evaluation (expr_eval.cu) ----------------------------

#define SIDDHI_MAX_COLS 32
#define SIDDHI_MAX_OUTS 32
#define SIDDHI_MAX_CODE 384
#define SIDDHI_MAX_CONSTS 48
#define SIDDHI_MAX_STACK 16

// value types (ops/expr.py VT_*)
enum ValType { VT_INT = 0, VT_LONG = 1, VT_FLOAT = 2, VT_DOUBLE = 3,
               VT_BOOL = 4, VT_STRING = 5 };

// opcodes (ops/expr.py OP_*); an instruction is one int32:
// op | type << 8 | arg << 16
enum OpCode {
  OP_LOAD = 0,    // push input column `arg` (type = column type)
  OP_CONST = 1,   // push constant pool entry `arg` (non-null)
  OP_NULLC = 2,   // push a null of `type`
  OP_CAST = 3,    // widen top from type `arg` to `type`
  OP_ADD = 4, OP_SUB = 5, OP_MUL = 6, OP_DIV = 7,
  OP_MOD = 8,     // arg 1: the divisor is a literal +-2^k, k >= 0
  OP_EQ = 9, OP_NE = 10, OP_GT = 11, OP_GE = 12, OP_LT = 13, OP_LE = 14,
  OP_AND = 15, OP_OR = 16, OP_NOT = 17, OP_ISNULL = 18,
  OP_KEEP = 19,   // pop a BOOL: the row is kept only if it is TRUE
  OP_OUT = 20,    // pop into output column `arg` (values + nulls)
  OP_ZNULL = 21,  // value of a null top := 0 (math whose op was dropped)
  OP_NEG = 22     // float top := -top (sign flip), then as OP_ZNULL
};

typedef struct {
  const void* in_cols[SIDDHI_MAX_COLS];
  const bool* in_nulls[SIDDHI_MAX_COLS];
  void* out_cols[SIDDHI_MAX_OUTS];
  bool* out_nulls[SIDDHI_MAX_OUTS];
  const int32_t* kind;           // [rows]
  const bool* valid;             // [rows]
  bool* out_valid;               // [rows]
  unsigned long long* emitted;   // int64 counter += kept rows, or NULL
  int64_t consts[SIDDHI_MAX_CONSTS];  // constant pool, raw 64-bit values
  int32_t code[SIDDHI_MAX_CODE];
  int32_t n_code;
  int32_t rows;
  int32_t timer_pass;  // rows of kind TIMER pass the filters
  int32_t gate_bits;   // bit k set: rows of kind k pass the selector gate
} ExprParams;

cudaError_t siddhi_expr_eval(const ExprParams* p, cudaStream_t stream);

#ifdef __cplusplus
}
#endif
