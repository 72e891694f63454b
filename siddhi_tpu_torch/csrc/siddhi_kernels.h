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
  int64_t n_part;             // tenant pool slots (1 for one chunk)
  const int64_t* moves;       // [n_moves][2] (part_args, below)
  int64_t n_moves;
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
               VT_BOOL = 4, VT_STRING = 5,
               // set values (kernel K2 only): a createSet() singleton
               // (the slot holds the encoded element), a loaded
               // [rows, 1 + SIDDHI_SET_LANES] int64 column (the slot holds
               // the input index; OUT copies the row), and a load of such
               // a column's size (an INT)
               VT_SET = 6, VT_SETREF = 7, VT_SETSIZE = 8 };

#define SIDDHI_SET_LANES 32
#define SIDDHI_SET_EMPTY (-(1ll << 62))

#ifdef __CUDACC__
// Row `from` of a column into row `to` of another, rows of `size` bytes:
// 8, 4 or 1 for a scalar column, a multiple of 8 for a set column
// ([rows, 1 + SIDDHI_SET_LANES] int64, 264 bytes a row).
static __device__ __forceinline__ void copy_row(void* dst, int64_t to,
                                                const void* src,
                                                int64_t from, int size) {
  if (size == 8) {
    ((int64_t*)dst)[to] = ((const int64_t*)src)[from];
  } else if (size == 4) {
    ((int32_t*)dst)[to] = ((const int32_t*)src)[from];
  } else if (size == 1) {
    ((uint8_t*)dst)[to] = ((const uint8_t*)src)[from];
  } else {
    const int w = size / 8;
    for (int k = 0; k < w; ++k)
      ((int64_t*)dst)[to * w + k] = ((const int64_t*)src)[from * w + k];
  }
}
static __device__ __forceinline__ void zero_row(void* dst, int64_t to,
                                                int size) {
  if (size == 4) {
    ((int32_t*)dst)[to] = 0;
  } else if (size == 1) {
    ((uint8_t*)dst)[to] = 0;
  } else {
    const int w = size / 8;
    for (int k = 0; k < w; ++k) ((int64_t*)dst)[to * w + k] = 0;
  }
}
#endif

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
  OP_NEG = 22,    // float top := -top (sign flip), then as OP_ZNULL
  // the function calls (ops/expr.py _compile_function)
  OP_CONVERT = 23,   // top from type `arg` to `type`: narrowing, float ->
                     // int (saturating), DOUBLE -> FLOAT, BOOL -> number
  OP_COALESCE = 24,  // pop r: top := r where top is null and r is not
  OP_DEFAULT = 25,   // pop r: top := r where top is null
  OP_IFELSE = 26,    // pop b, a, c: c TRUE (not null) ? a : b
  OP_MAXIMUM = 27, OP_MINIMUM = 28,  // pop r: one step of the fold
  OP_MATH = 29,      // math:<fn> of top, fn = `arg` (MathFn)
  OP_POW = 30,       // pop y: top := power(top, y), DOUBLE
  OP_SETELEM = 31,   // top (of type `type`) as a createSet() singleton
  OP_SETSIZE = 32    // a singleton's size (0 or 1), INT
};

// OP_MATH's functions (ops/expr.py MATH_FNS)
enum MathFn { MF_ABS = 0, MF_CEIL, MF_FLOOR, MF_SIGNUM, MF_ROUND, MF_SQRT,
              MF_EXP, MF_LN, MF_LOG10, MF_SIN, MF_COS, MF_TAN, MF_ASIN,
              MF_ACOS, MF_ATAN };

typedef struct {
  const void* in_cols[SIDDHI_MAX_COLS];
  const bool* in_nulls[SIDDHI_MAX_COLS];   // NULL: the input is never null
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
  int32_t now_input;   // the input that is the step's clock (one int64), or -1
  // a tenant pool's step runs its slots' [slots, slot_rows] rows as one
  // batch: input k with bit k of tparam_mask set is a template parameter,
  // one value a slot, read at row / slot_rows
  uint32_t tparam_mask;
  int32_t slot_rows;
  // > 0: emitted is one counter a slot, row r counting to r / emit_rows
  int32_t emit_rows;
  int32_t pad_;
} ExprParams;

cudaError_t siddhi_expr_eval(const ExprParams* p, cudaStream_t stream);

// ---- K3: round-parallel NFA step (nfa_parallel.cu) -----------------------

#define SIDDHI_NFA_MAX_SLOTS 8
#define SIDDHI_NFA_MAX_SLOT_COLS 32   // attributes summed over the slots
#define SIDDHI_NFA_MAX_EV_COLS 16     // attributes of the consumed stream
#define SIDDHI_NFA_MAX_STATES 8       // states consuming the stream
#define SIDDHI_NFA_MAX_PERSONAS 2
#define SIDDHI_NFA_MAX_MATCH_COLS 64
#define SIDDHI_NFA_MAX_ROWS 16384     // table rows + sub-batch events

// a condition load (ops/nfa_parallel.py load_descriptor):
// kind | slot << 1 | attr << 8 | copy-or-k << 16, kind 0 = ("slot", j, a,
// c), kind 1 = ("slot_last", j, a, k)

typedef struct {
  int32_t idx, slot, next_idx, is_counting;
  int32_t min_count, max_count, cap_limit;
  int32_t prog_start, prog_len;  // condition program in `code`; 0 = none
  int32_t n_personas;            // counting states whose rows answer this one
  int32_t persona_idx[SIDDHI_NFA_MAX_PERSONAS];
  int32_t persona_slot[SIDDHI_NFA_MAX_PERSONAS];
  int32_t persona_min[SIDDHI_NFA_MAX_PERSONAS];
} NfaStateDesc;

typedef struct {
  // the pending table (population 1): M rows, updated in place
  int32_t* state;
  bool* valid;
  int64_t* ts0;
  bool* has_ts0;
  int64_t* born;
  int64_t* min_at;
  int64_t* deadline;
  int64_t* seq;
  int64_t* next_seq;   // 0-d
  int64_t* counter;    // 0-d
  int64_t* overflow;   // 0-d
  // slot storage of the table and of the spawns (population 2): slot j
  // has ts [rows, cap] and n [rows]; its attribute a is slot column
  // slot_col0[j] + a, values and nulls [rows, cap]
  void* tab_cols[SIDDHI_NFA_MAX_SLOT_COLS];
  bool* tab_nulls[SIDDHI_NFA_MAX_SLOT_COLS];
  int64_t* tab_ts[SIDDHI_NFA_MAX_SLOTS];
  int32_t* tab_n[SIDDHI_NFA_MAX_SLOTS];
  void* p2_cols[SIDDHI_NFA_MAX_SLOT_COLS];
  bool* p2_nulls[SIDDHI_NFA_MAX_SLOT_COLS];
  int64_t* p2_ts[SIDDHI_NFA_MAX_SLOTS];
  int32_t* p2_n[SIDDHI_NFA_MAX_SLOTS];
  // population 2's other fields [B]
  int32_t* p2_state;
  bool* p2_valid;
  int32_t* p2_last;
  int32_t* p2_born_rel;
  int64_t* p2_ts0;
  bool* p2_has_ts0;
  int32_t* p2_minrel;
  int64_t* p2_seq;
  int32_t* emit_at;  // [M + B]: both populations
  int32_t* emit_n;   // [M + B]
  int64_t* span;     // [4]: min and max ts of the valid events, any valid
                     // event, rows spawned
  // the sub-batch of events
  const int64_t* ev_ts;
  const int32_t* ev_kind;
  const bool* ev_valid;
  const void* ev_cols[SIDDHI_NFA_MAX_EV_COLS];
  const bool* ev_nulls[SIDDHI_NFA_MAX_EV_COLS];
  // the match batch [OUT]: the first sub-batch of a step clears it
  // (values 0, nulls set, out_n 0), the last one writes its valid mask
  // (row < out_n) and kinds (CURRENT)
  void* out_cols[SIDDHI_NFA_MAX_MATCH_COLS];
  bool* out_nulls[SIDDHI_NFA_MAX_MATCH_COLS];
  int64_t* out_ts;
  int64_t* out_n;    // 0-d
  bool* out_valid;
  int32_t* out_kind;
  // the condition programs (ops/expr.py ProgramBuilder), device memory
  const int32_t* code;
  const int64_t* consts;
  const int32_t* loads;
  int64_t within_ms;  // -1: no `within`
  NfaStateDesc states[SIDDHI_NFA_MAX_STATES];  // consuming, chain order
  NfaStateDesc start;                          // the always-armed start
  int32_t slot_cap[SIDDHI_NFA_MAX_SLOTS];
  int32_t slot_col0[SIDDHI_NFA_MAX_SLOTS];
  int32_t slot_ncols[SIDDHI_NFA_MAX_SLOTS];
  int32_t slot_final_counting[SIDDHI_NFA_MAX_SLOTS];
  int32_t col_type[SIDDHI_NFA_MAX_SLOT_COLS];
  int32_t ev_type[SIDDHI_NFA_MAX_EV_COLS];
  int32_t out_type[SIDDHI_NFA_MAX_MATCH_COLS];
  int32_t n_slots, n_consuming, has_start, advance_pop2, seqmode, n_states;
  int32_t M, B, OUT, sub_off, n_match_cols;
  int32_t first_sub, last_sub;  // this sub-batch opens / closes the step
  uint32_t min0_mask;  // bit s: state s is counting with min_count 0
  int64_t n_part;             // tenant pool slots (1 for one table)
  const int64_t* moves;       // [n_moves][2] (part_args)
  int64_t n_moves;
} NfaParams;

cudaError_t siddhi_nfa_parallel_step(const NfaParams* p, cudaStream_t stream);

// ---- K4: the scan NFA engine (nfa_scan.cu) --------------------------------
//
// One launch is one step: a block of M threads, one per table row, walks
// the events of a chunk in order (or runs the timer step). The engine's
// static description (ScanPlan) lives in device memory, uploaded once per
// engine and stream; the pointers of one launch travel by value
// (ScanArgs). Slot storage, condition loads and value types are K3's.

#define SIDDHI_SCAN_MAX_ROWS 256      // table rows = threads of the block
#define SIDDHI_SCAN_MAX_STATES 16     // states of the pattern
#define SIDDHI_SCAN_MAX_CONSUMING 8   // states consuming one stream
#define SIDDHI_SCAN_MAX_ABSENT 8      // absent states with a waiting time
#define SIDDHI_SCAN_MAX_PERSONAS 4    // counting states answering a state
#define SIDDHI_SCAN_MAX_STARTS 2      // always-armed starts of one stream
#define SIDDHI_SCAN_MAX_GROUPS 4      // logical AND groups (stabilize)

enum ScanLogical { SCAN_PLAIN = 0, SCAN_AND = 1, SCAN_OR = 2 };

// a state that consumes the stream, with what its step reads of its
// group, partner, anchor and enclosing `every` scope (ops/nfa.py
// NfaEngine._event_body)
typedef struct {
  int64_t waiting_ms;      // absent: the wait
  int64_t nxt_waiting_ms;  // counting: the next anchor's absent wait (0: none)
  int32_t idx, slot, cap, anchor, anchor_next, next_idx;
  int32_t prog_start, prog_len;  // condition program in `code`; 0 = none
  int32_t logical, has_partner, grp_final;
  int32_t is_absent, dl_field, viol_latch, viol_push;
  int32_t is_counting, min_count, max_count, nxt_dl_field;
  int32_t p_slot, p_is_absent, p_waits, p_dl_field, p_viol_latch;
  int32_t arm, clear;      // `every` re-arm target (-1: none), clear-from slot
  int32_t n_personas;
  int32_t persona_idx[SIDDHI_SCAN_MAX_PERSONAS];
  int32_t persona_slot[SIDDHI_SCAN_MAX_PERSONAS];
  int32_t persona_min[SIDDHI_SCAN_MAX_PERSONAS];
} ScanStateDesc;

// an absent state with a waiting time, as the deadline advance reads it
// (NfaEngine._advance_time)
typedef struct {
  int64_t w_next, w2_next;  // waits of the re-armed entry, lanes 0 and 1
  int32_t anchor, anchor_next, next_anchor, dl_field;
  int32_t has_partner, logical, p_is_absent, p_slot;
  int32_t arm, clear;
  int32_t n_personas;       // counting rows that wait at this anchor
  int32_t persona_idx[SIDDHI_SCAN_MAX_PERSONAS];
  int32_t persona_slot[SIDDHI_SCAN_MAX_PERSONAS];
  int32_t persona_min[SIDDHI_SCAN_MAX_PERSONAS];
} ScanAbsentDesc;

// a logical AND group anchor, for the sequence stabilize exemption;
// lane 0: no absent side, 1: deadline, 2: deadline2
typedef struct {
  int32_t anchor, slot_l, slot_r, lane;
} ScanGroupDesc;

// an always-armed start of the stream (NfaEngine._virtual_start)
typedef struct {
  int32_t idx, slot, next_idx, nxt_anchor;
  int32_t prog_start, prog_len;
  int32_t suppress, is_counting, min_count;
} ScanStartDesc;

typedef struct {
  int64_t within_ms;  // -1: no `within`
  int64_t wait_of[SIDDHI_SCAN_MAX_STATES + 1];
  int64_t wait2_of[SIDDHI_SCAN_MAX_STATES + 1];
  int32_t arm_of[SIDDHI_SCAN_MAX_STATES + 1];
  int32_t clear_of[SIDDHI_SCAN_MAX_STATES + 1];
  ScanStateDesc cons[SIDDHI_SCAN_MAX_CONSUMING];  // in state order
  ScanAbsentDesc absent[SIDDHI_SCAN_MAX_ABSENT];  // in state order
  ScanGroupDesc groups[SIDDHI_SCAN_MAX_GROUPS];
  ScanStartDesc starts[SIDDHI_SCAN_MAX_STARTS];
  int32_t rearm_anchor[SIDDHI_SCAN_MAX_STATES];  // every-scoped seq starts
  int32_t slot_cap[SIDDHI_NFA_MAX_SLOTS];
  int32_t slot_col0[SIDDHI_NFA_MAX_SLOTS];   // first slot column
  int32_t slot_ncols[SIDDHI_NFA_MAX_SLOTS];
  int32_t slot_ci0[SIDDHI_NFA_MAX_SLOTS];    // first match column
  int32_t col_type[SIDDHI_NFA_MAX_SLOT_COLS];
  int32_t n_slots, n_states, n_cons, n_absent, n_groups, n_starts, n_rearm;
  int32_t M, OUT, n_match_cols;
  int32_t seqmode, has_absent, any_every, absent_rearms, has_dl2;
  int32_t or_double_absent;
  uint32_t counting_mask;  // bit s: state s is a counting state
} ScanPlan;

typedef struct {
  const ScanPlan* plan;  // device memory
  // the pending table: M rows, updated in place
  int32_t* state;
  bool* valid;
  int64_t* ts0;
  bool* has_ts0;
  int64_t* born;
  int64_t* min_at;
  int64_t* deadline;
  int64_t* deadline2;
  int64_t* seq;
  int64_t* next_seq;   // 0-d
  int64_t* counter;    // 0-d
  int64_t* overflow;   // 0-d
  void* tab_cols[SIDDHI_NFA_MAX_SLOT_COLS];   // [M, cap] per slot column
  bool* tab_nulls[SIDDHI_NFA_MAX_SLOT_COLS];
  int64_t* tab_ts[SIDDHI_NFA_MAX_SLOTS];
  int32_t* tab_n[SIDDHI_NFA_MAX_SLOTS];
  // staging rows for appends, the table's layout
  void* stg_cols[SIDDHI_NFA_MAX_SLOT_COLS];
  bool* stg_nulls[SIDDHI_NFA_MAX_SLOT_COLS];
  int64_t* stg_ts[SIDDHI_NFA_MAX_SLOTS];
  // the chunk's events (n_events = 0: the timer step at `now`)
  const int64_t* ev_ts;
  const int32_t* ev_kind;
  const bool* ev_valid;
  const void* ev_cols[SIDDHI_NFA_MAX_EV_COLS];
  const bool* ev_nulls[SIDDHI_NFA_MAX_EV_COLS];
  int64_t now;
  int32_t n_events;
  int32_t rows;        // M: the threads of the block (the plan's M)
  // the match batch [OUT]: cleared, filled, closed by the launch
  void* out_cols[SIDDHI_NFA_MAX_MATCH_COLS];
  bool* out_nulls[SIDDHI_NFA_MAX_MATCH_COLS];
  int32_t out_type[SIDDHI_NFA_MAX_MATCH_COLS];
  int64_t* out_ts;
  int64_t* out_n;      // 0-d
  bool* out_valid;
  int32_t* out_kind;
  int64_t* due;        // 0-d: next_due of the table after the step, or NULL
  // the condition programs (ops/expr.py ProgramBuilder), device memory:
  // n_code words (<= SIDDHI_MAX_CODE), n_consts constants (<=
  // SIDDHI_MAX_CONSTS), n_loads load descriptors (<= SIDDHI_MAX_COLS)
  const int32_t* code;
  const int64_t* consts;
  const int32_t* loads;
  int32_t n_code, n_consts, n_loads;
  int32_t n_ev_cols;
  int32_t ev_size[SIDDHI_NFA_MAX_EV_COLS];   // an event column's bytes a row
  int64_t n_part;             // partition slots (1 outside a block)
  const int64_t* moves;       // [n_moves][2] (siddhi_kernels.h part_args)
  int64_t n_moves;
} ScanArgs;

cudaError_t siddhi_nfa_scan(const ScanArgs* a, cudaStream_t stream);

// ---- K5: window step (window_step.cu) -------------------------------------

#define SIDDHI_WIN_MAX_COLS 16

// window kinds (ops/windows.py, ops/windows2.py WindowOp.KIND)
enum WinKind { WIN_TIME = 0, WIN_LENGTH = 1, WIN_LENGTH_BATCH = 2,
               WIN_TIME_BATCH = 3, WIN_EMPTY = 4, WIN_EXT_TIME = 5,
               WIN_TIME_LENGTH = 6, WIN_DELAY = 7, WIN_BATCH = 8,
               WIN_EXT_BATCH = 9, WIN_HOPPING = 10, WIN_CRON = 11 };

// A struct-of-arrays batch or window buffer; `seq` is unused for batches.
typedef struct {
  int64_t* ts;
  int64_t* seq;
  void* cols[SIDDHI_WIN_MAX_COLS];
  bool* nulls[SIDDHI_WIN_MAX_COLS];
  bool* valid;
} WinBuf;

typedef struct {
  WinBuf batch;               // the input, B rows
  const int32_t* batch_kind;
  // state: a = buf / cur (batch: the reset row; W rows), e = exp (EB)
  WinBuf a, e;
  WinBuf na, ne;              // the new state buffers (fresh memory)
  // 0-d device scalars: the state's counters and the step's clock
  const int64_t* next_seq;
  const int64_t* overflow;    // NULL for a window without one
  const int64_t* next_emit;   // timeBatch; hopping's next_hop
  const int64_t* now;
  int64_t* o_next_seq;
  int64_t* o_overflow;
  int64_t* o_next_emit;
  // externalTimeBatch's start, flushed, sched and last_ext
  const int64_t* start;
  const bool* flushed;
  const int64_t* sched;
  const int64_t* last_ext;
  int64_t* o_start;
  bool* o_flushed;
  int64_t* o_sched;
  int64_t* o_last_ext;
  WinBuf out;                 // the output batch, N rows
  int32_t* out_kind;
  // scratch (device memory, sizes in ops/windows.py window_scratch)
  int64_t* b_seq;             // [B]
  int64_t* rt;                // [B] running time
  int32_t* cur_rows;          // [B]
  int64_t* scal;              // [32]
  uint32_t* keys;             // [N]
  uint32_t* k1;               // [N]
  uint32_t* k2;               // [N]
  int32_t* i1;                // [N]
  int32_t* i2;                // [N]
  int32_t* order;             // [N]
  int32_t* counts;            // [256 * ceil(N / 1024)]
  int32_t* cand_src;          // [N] source row: E, then A, then the batch
  int64_t* cand_ts;           // [N]
  int32_t* cand_kind;         // [N]
  uint8_t* keep;              // [2 * S] keep masks over the sources
  int32_t* rank_pos;          // [2 * S] source row of each kept rank
  int32_t* rank_of;           // [2 * S] kept rank of each source row
  uint8_t* pflag;             // [P] externalTimeBatch: a batch's first row
  int32_t col_size[SIDDHI_WIN_MAX_COLS];   // bytes per element: 1, 4 or 8
  // S = EB + W + B sources: E's rows, then A's, then the batch's
  int32_t n_cols, kind, B, W, EB, N, P, S;
  int32_t expired_enabled, stream_current, has_start;
  int32_t ts_idx, start_attr, has_timeout, replace_ts;   // -1: none
  int64_t length, span_ms, start_time, timeout_ms, hop_ms;
  int64_t n_part;             // partition slots (1 outside a block)
  const int64_t* moves;       // [n_moves][2] (siddhi_kernels.h part_args)
  int64_t n_moves;
} WindowArgs;

// Kernel K5: one window step (ops/windows.py window_step).
cudaError_t siddhi_window_step(const WindowArgs* a, cudaStream_t stream);

// ---- K5s: the sort window's step (window_seq.cu) ---------------------------

#define SIDDHI_SORT_MAX_KEYS 8

typedef struct {
  WinBuf batch;               // the input, B rows
  const int32_t* batch_kind;
  WinBuf a;                   // the buffer, W = L + 1 rows
  WinBuf na;                  // the new buffer (fresh memory)
  WinBuf ev;                  // scratch [B]: each row's evicted copy
  const int64_t* next_seq;
  const int64_t* now;
  int64_t* o_next_seq;
  WinBuf out;                 // the output batch, 2 * B rows
  int32_t* out_kind;
  uint8_t* mask;              // scratch [W]
  int32_t* pos;               // scratch [2 * B] each candidate's place
  int32_t* rows;              // scratch [B] the CURRENT rows, compacted
  int32_t col_size[SIDDHI_WIN_MAX_COLS];
  int32_t n_cols, B, W, L, expired_enabled, n_keys;
  int32_t key_col[SIDDHI_SORT_MAX_KEYS];
  int32_t key_desc[SIDDHI_SORT_MAX_KEYS];
  int32_t key_type[SIDDHI_SORT_MAX_KEYS];   // ValType
  int64_t n_part;             // partition or pool slots (1 outside)
  const int64_t* moves;       // [n_moves][2] (part_args)
  int64_t n_moves;
} SortArgs;

cudaError_t siddhi_sort_window(const SortArgs* a, cudaStream_t stream);

// ---- E: frequent and lossyFrequent (window_seq.cu) -------------------------

typedef struct {
  WinBuf batch;               // the input, B rows
  const int32_t* batch_kind;
  WinBuf a;                   // the buffer, N rows (seq unused)
  WinBuf na;                  // the new buffer (fresh memory)
  const int64_t *keys, *counts, *buckets;     // [N] (buckets: lossy)
  int64_t *o_keys, *o_counts, *o_buckets;
  const int64_t *next_seq, *total, *overflow; // 0-d (total, overflow: lossy)
  int64_t *o_next_seq, *o_total, *o_overflow;
  const int64_t* now;
  WinBuf out;                 // the output batch, B * N + B rows
  int32_t* out_kind;
  // scratch
  int64_t* hk;                // [B] key hashes
  int64_t* dmask;             // [B] each row's dying slots (bit j: slot j)
  int32_t* vbefore;           // [B] valid expired rows before row i
  int32_t* cbefore;           // [B] passing rows before row i
  int64_t* scal;              // [4]
  int32_t col_size[SIDDHI_WIN_MAX_COLS];
  int32_t key_col[SIDDHI_WIN_MAX_COLS];
  int32_t key_type[SIDDHI_WIN_MAX_COLS];   // ValType
  int32_t n_cols, n_keys, B, N, lossy, expired_enabled;
  int64_t width;
  double thresh;
  int64_t n_part;             // partition or pool slots (1 outside)
  const int64_t* moves;       // [n_moves][2] (part_args)
  int64_t n_moves;
} FreqArgs;

cudaError_t siddhi_freq_window(const FreqArgs* a, cudaStream_t stream);

// ---- F: the session window (session_step.cu) -------------------------------

typedef struct {
  WinBuf batch;               // the input, B rows
  const int32_t* batch_kind;
  WinBuf buf;                 // the members, K * S rows (seq unused)
  WinBuf nbuf;                // the new members (fresh memory)
  const int64_t* keys; const bool* used; const int64_t* count;
  const int64_t* end; const bool* open;
  const int64_t* next_seq; const int64_t* overflow;
  int64_t* o_keys; bool* o_used; int64_t* o_count;
  int64_t* o_end; bool* o_open;
  int64_t* o_next_seq; int64_t* o_overflow;
  WinBuf out;                 // the output batch, M = K * S + 2B rows
  int32_t* out_kind;
  // scratch: rows [B], slots [K], candidates [M]
  int64_t* hk; uint8_t* cur; int32_t* slots; int32_t* prb;
  uint8_t* flags; int32_t* claim; int64_t* rt; int32_t* order;
  int64_t *s_a, *s_b, *s_c; uint8_t* s_f;
  int64_t* r_close_ts; int32_t* r_close_row; int64_t* r_pos;
  uint8_t* r_flags;
  int32_t* sl_close_row; uint8_t* sl_flags;
  uint32_t* ekey; int32_t* eorder; uint32_t *k1, *k2; int32_t *i1, *i2;
  int32_t* counts; int64_t* scal;
  // the rows' sort by slot: keys and scratch [B], digits [256 blocks]
  uint32_t* rkey; uint32_t *rk1, *rk2; int32_t *ri1, *ri2;
  int32_t* rcounts;
  int32_t col_size[SIDDHI_WIN_MAX_COLS];
  int32_t n_cols, B, K, S, M, has_key, key_col, key_type, expired_enabled;
  int32_t pad_;
  int64_t gap;
  int64_t n_part;             // partition or pool slots (1 outside)
  const int64_t* moves;       // [n_moves][2] (part_args)
  int64_t n_moves;
} SessArgs;

cudaError_t siddhi_session_window(const SessArgs* a, cudaStream_t stream);

// ---- G, G[K]: order-by, offset and limit (order_by.cu) --------------------

#define SIDDHI_ORDER_MAX_COLS 32
#define SIDDHI_ORDER_MAX_KEYS 8

typedef struct {
  int32_t B, n_cols, n_keys, pad_;
  int64_t offset, limit;      // -1: none
  const int64_t* ts;          // [B] the chunk
  const int32_t* kind;
  const bool* valid;
  const void* cols[SIDDHI_ORDER_MAX_COLS];
  const bool* nulls[SIDDHI_ORDER_MAX_COLS];
  int32_t col_size[SIDDHI_ORDER_MAX_COLS];
  int32_t key_col[SIDDHI_ORDER_MAX_KEYS];
  int32_t key_type[SIDDHI_ORDER_MAX_KEYS];  // ValType
  int32_t key_desc[SIDDHI_ORDER_MAX_KEYS];
  int64_t* out_ts;            // [B] the shaped chunk
  int32_t* out_kind;
  bool* out_valid;
  void* out_cols[SIDDHI_ORDER_MAX_COLS];
  bool* out_nulls[SIDDHI_ORDER_MAX_COLS];
  int64_t* emitted;           // 0-d, added to; or NULL
  // scratch
  uint64_t *k1, *k2;          // [B]
  int32_t *i1, *i2;           // [B]
  int32_t* counts;            // [256 * ceil(B / 1024)]
  int64_t* rank;              // [B]
  int64_t* sums;              // [ceil(B / 1024)]
  // G[K]: K > 0 chunks of B rows, one a partition or pool slot. Inputs
  // are [K, B] with slot s's rows `stride` elements on (0: one array
  // every slot reads); outputs [K, B] contiguous; `emitted` is one
  // counter (stride 0) or one a slot (stride 1). The sort's scratch
  // (k1, k2, i1, i2: [K * B]; counts: [K * 256 * ceil(B / 1024)]) only
  // where a slot's rows are sorted in global memory: k1 non-NULL
  // selects that branch, NULL the block's shared memory.
  int32_t K, pad2_;
  int64_t ts_stride, kind_stride, valid_stride;
  int64_t col_stride[SIDDHI_ORDER_MAX_COLS];
  int64_t null_stride[SIDDHI_ORDER_MAX_COLS];
  int64_t emitted_stride;
} OrderArgs;

cudaError_t siddhi_order_by(const OrderArgs* a, cudaStream_t stream);

// ---- K6: aggregate step and emission (aggregate_step.cu) ------------------

#define SIDDHI_AGG_MAX_KEYS 8
#define SIDDHI_AGG_MAX_SPECS 16
#define SIDDHI_AGG_MAX_LANES 48
#define SIDDHI_AGG_MAX_LEVELS 40
#define SIDDHI_AGG_MAX_OUTS 32

// aggregator kinds (ops/aggregators.py AggSpec.KIND) and lane ops
enum AggKind { AGG_SUM = 0, AGG_AVG = 1, AGG_COUNT = 2, AGG_STDDEV = 3,
               AGG_MINMAX = 4, AGG_FOREVER = 5, AGG_BOOL = 6,
               AGG_SLIDING = 7, AGG_DISTINCT = 8, AGG_UNION = 9 };
enum LaneOp { LANE_SUM = 0, LANE_MIN = 1, LANE_MAX = 2 };

typedef struct {
  int32_t B, K, grouped, n_keys, n_specs, n_lanes;
  const int32_t* kind;              // [B] the rows' kinds
  const bool* valid;                // [B]
  const void* key_cols[SIDDHI_AGG_MAX_KEYS];
  const bool* key_nulls[SIDDHI_AGG_MAX_KEYS];
  int32_t key_type[SIDDHI_AGG_MAX_KEYS];   // ValType
  // per aggregator: its kind, flag (max, and), argument, first lane and
  // value column
  int32_t spec_kind[SIDDHI_AGG_MAX_SPECS];
  int32_t spec_flag[SIDDHI_AGG_MAX_SPECS];
  int32_t spec_lane0[SIDDHI_AGG_MAX_SPECS];
  int32_t arg_type[SIDDHI_AGG_MAX_SPECS];  // ValType, -1: no argument
  const void* arg_cols[SIDDHI_AGG_MAX_SPECS];
  const bool* arg_nulls[SIDDHI_AGG_MAX_SPECS];
  int32_t out_type[SIDDHI_AGG_MAX_SPECS];  // ValType of the value
  void* out_vals[SIDDHI_AGG_MAX_SPECS];    // [B]
  bool* out_nulls[SIDDHI_AGG_MAX_SPECS];   // [B]
  // per lane: op, accumulator type (ValType), spec, carry in and out
  int32_t lane_op[SIDDHI_AGG_MAX_LANES];
  int32_t lane_type[SIDDHI_AGG_MAX_LANES];
  int32_t lane_spec[SIDDHI_AGG_MAX_LANES];
  const void* carry[SIDDHI_AGG_MAX_LANES];   // [K]
  void* new_carry[SIDDHI_AGG_MAX_LANES];     // [K]
  void* run[SIDDHI_AGG_MAX_LANES];           // [B] running values
  // the group table, and the new one (fresh memory)
  const int64_t* keys;
  const bool* used;
  const int64_t* overflow;
  int64_t* new_keys;
  bool* new_used;
  int64_t* new_overflow;
  int32_t* slots;                   // [B] out: the row's slot, K if none
  // scratch (ops/aggregators.py agg_scratch)
  int64_t* hk;                      // [B] key hashes
  int32_t* probe;                   // [B] probed slot
  uint8_t* flags;                   // [B] bit 0 placed, bit 1 wants
  int32_t* claim;                   // [K]
  int64_t* reset_seg;               // [B]
  int64_t* scal;                    // [8]
  uint32_t* skeys;                  // [B]
  uint32_t *k1, *k2;                // [B]
  int32_t *i1, *i2;                 // [B]
  int32_t* counts;                  // [256 * ceil(B / 1024)]
  int32_t* perm;                    // [B] rows by slot, stable
  int32_t* inv_perm;                // [B]
  int64_t* seg_sorted;              // [B]
  int64_t* seg_start;               // [B]
  int32_t* slot_first;              // [K + 1]
  int32_t* slot_last;               // [K + 1]
  void* tree;                       // [2 * B] 8-byte values, level by level
  int64_t* tree_seg;                // [2 * B]
  void* res;                        // [B] 8-byte: scan result, sorted order
  int64_t level_off[SIDDHI_AGG_MAX_LEVELS];
  int64_t level_n[SIDDHI_AGG_MAX_LEVELS];
  int32_t n_levels;
  // a stateful aggregator's lane contributions, made by its kernel
  // (distinctCount's 0<->1 transitions), NULL for the others
  const int64_t* spec_contrib[SIDDHI_AGG_MAX_SPECS];
  int64_t n_part;             // partition slots (1 outside a block)
  const int64_t* moves;       // [n_moves][2] (siddhi_kernels.h part_args)
  int64_t n_moves;
} AggArgs;

// Kernel K6, the step (ops/aggregators.py aggregate_step): `part` 1 the
// group slots, reset segments and slot sort; 2 the lanes of the
// aggregators that are not stateful, and every value; 3 both.
cudaError_t siddhi_aggregate_step(const AggArgs* a, cudaStream_t stream,
                                  int32_t part);

// A stateful aggregator's table and scratch (kernels C and D, between
// K6's parts 1 and 2).
typedef struct {
  int32_t spec, W, D;
  const void* arg;                  // [B] the argument, ValType arg_type
  const bool* arg_null;
  int32_t arg_type, pad_;
  // C: per-key rings [K, W], heads and tails [K]
  const void* ring;
  const int64_t* heads;
  const int64_t* tails;
  void* new_ring;
  int64_t* new_heads;
  int64_t* new_tails;
  void* tree;                       // [K, 2W]
  // D: the pair table [D]: keys, used, counts
  const int64_t* keys;
  const bool* used;
  const int64_t* counts;
  int64_t* new_keys;
  bool* new_used;
  int64_t* new_counts;
  const int64_t* overflow;
  int64_t* new_overflow;
  // scratch
  int64_t* r0;                      // [B] C: add prefix; D: pair hash
  int64_t* r1;                      // [B] C: remove prefix; D: prefix
  int64_t* r2;                      // [B] D: the rows' deltas
  int64_t* r3;                      // [B] D: running pair counts
  int32_t* i0;                      // [B] D: pair slot
  int32_t* i1;                      // [B] D: probe
  uint8_t* flags;                   // [B]
  int32_t* claim;                   // [D]
  uint32_t* pkeys;                  // [B] D: pair segments as sort keys
  int32_t* perm2;                   // [B]
  int64_t* seg2;                    // [B] D: segment start, sorted order
  int64_t* ksum;                    // [2 K] C: adds and removes per key
  unsigned long long* count;        // [1] overflowed rows
  int64_t n_part;             // partition or pool slots (1 outside)
  const int64_t* moves;       // [n_moves][2] (part_args)
  int64_t n_moves;
} StatArgs;

// Kernels C (SlidingMinMaxAgg) and D (DistinctCountAgg).
cudaError_t siddhi_sliding_minmax(const AggArgs* a, const StatArgs* st,
                                  cudaStream_t stream);
cudaError_t siddhi_distinct_count(const AggArgs* a, const StatArgs* st,
                                  cudaStream_t stream);

typedef struct {
  int32_t B, K, batch_mode, n_cols;
  int32_t keep_order;               // 1: qualifying rows in row order
  int32_t pad_;
  int64_t offset, limit;            // -1: none
  const int32_t* slots;             // [B]
  const bool* qual;                 // [B] K2's gate and having
  const int64_t* ts;                // [B] the input rows
  const int32_t* kind;
  const bool* valid;
  const void* cols[SIDDHI_AGG_MAX_OUTS];    // [B] projected columns
  const bool* nulls[SIDDHI_AGG_MAX_OUTS];
  int32_t col_size[SIDDHI_AGG_MAX_OUTS];
  // the output batch
  int64_t* out_ts;
  int32_t* out_kind;
  bool* out_valid;
  void* out_cols[SIDDHI_AGG_MAX_OUTS];
  bool* out_nulls[SIDDHI_AGG_MAX_OUTS];
  int64_t* emitted;                 // 0-d, added to; or NULL
  // scratch
  uint8_t* ovalid;                  // [B]
  int32_t* emit_order;              // [B]
  int32_t* pos;                     // [B] output position of each row
  int32_t* flag;                    // [B]
  uint32_t* qkeys;                  // [B]
  uint32_t *k1, *k2;
  int32_t *i1, *i2, *perm2;         // [B]
  int32_t* counts;
  int64_t* chunk;                   // [B]
  int64_t* gstart;                  // [B]
  int64_t* scal;                    // [4]
  int64_t n_part;             // partition slots (1 outside a block)
  const int64_t* moves;       // [n_moves][2] (siddhi_kernels.h part_args)
  int64_t n_moves;
} EmitArgs;

// Kernel K6, the emission (ops/aggregators.py aggregate_emit).
cudaError_t siddhi_aggregate_emit(const EmitArgs* a, cudaStream_t stream);

// ---- K7 and K8: joins and tables (join_cross.cu, table_step.cu) ---------

#define SIDDHI_JOIN_MAX_COLS 16
#define SIDDHI_JOIN_MAX_OUT 32
#define SIDDHI_TABLE_MAX_PK 8

// A program of the K2 interpreter whose loads read one of two sides:
// ins[k] = side << 16 | column (ops/table.py PairProgram). In device
// memory; n_code 0: no program.
typedef struct {
  const int32_t* code;
  const int64_t* consts;
  const int32_t* ins;
  int32_t n_code;
  int32_t pad_;
} PairProg;

// One side's rows: a batch, a window's findable buffer, a table.
typedef struct {
  const int64_t* ts;
  const int32_t* kind;      // or NULL
  const bool* valid;
  const void* cols[SIDDHI_JOIN_MAX_COLS];
  const bool* nulls[SIDDHI_JOIN_MAX_COLS];
  int32_t col_size[SIDDHI_JOIN_MAX_COLS];
  int32_t n_cols;
  int32_t pad_;
} SideCols;

// Scratch of the key view's sort (key_sort.cuh), n rows.
typedef struct {
  int64_t *k1, *k2;         // uint64 sort keys, ping-pong
  int32_t *i1, *i2;         // index ping-pong
  int64_t* keys;            // [n] each row's sortable key
  uint8_t* pad;             // [n] 1: a padded (dead) row, sorted last
  int32_t* order;           // [n] sorted position -> row
  int64_t* sk;              // [n] sorted keys
  int64_t* n_live;          // [1]
  int32_t* counts;          // [256 * blocks]
} KeySortScratch;

typedef struct {
  SideCols trig, opp;       // the trigger batch [B], the opposite buffer [W]
  PairProg cond;            // grid: the ON condition (n_code 0: TRUE)
  PairProg tkey, okey;      // probe: the band key of each side, cast
  PairProg resid;           // probe: the residual conjuncts, or none
  int32_t probe, outer, need_resid, gate;
  int32_t key_type;         // ValType of the band key
  int32_t levels;           // jnp.searchsorted's halvings over W
  int64_t big;              // the key type's pad value, encoded
  int64_t win_ms;           // the liveness gate's window span
  int32_t B, W, CAP, CAND, n_out;
  int32_t out_from_trig[SIDDHI_JOIN_MAX_OUT];
  int32_t out_col[SIDDHI_JOIN_MAX_OUT];
  int32_t out_size[SIDDHI_JOIN_MAX_OUT];
  int64_t* out_ts;
  int32_t* out_kind;
  bool* out_valid;
  void* out_cols[SIDDHI_JOIN_MAX_OUT];
  bool* out_nulls[SIDDHI_JOIN_MAX_OUT];
  int64_t* lost;            // 0-d: pairs beyond CAP plus candidates beyond CAND
  KeySortScratch sort;
  // scratch
  int64_t* trig_keys;       // [B] the trigger rows' sortable keys
  uint8_t* act;             // [B]
  int32_t* lo;              // [B]
  int64_t *cnt, *coffs;     // [B]
  int32_t* coi;             // [CAND]
  uint8_t* s;               // [CAND]
  int64_t* S;               // [CAND]
  int64_t *surv, *soffs, *tot, *offs;  // [B]
  uint8_t* lead;            // [B]
  int32_t *ti, *oi;         // [CAP]
  uint8_t* is_pair;         // [CAP]
  int64_t* psum;            // [tiles of CAND]: prefix sums' tile totals
  int64_t n_part;           // tenant pool slots (1 for one join step)
  const int64_t* moves;     // [n_moves][2] (part_args)
  int64_t n_moves;
} JoinArgs;

cudaError_t siddhi_join_probe(const JoinArgs* a, cudaStream_t stream);
cudaError_t siddhi_join_grid(const JoinArgs* a, cudaStream_t stream);

// A table's state (ops/table.py TableRuntime.init_state).
typedef struct {
  void* cols[SIDDHI_JOIN_MAX_COLS];
  bool* nulls[SIDDHI_JOIN_MAX_COLS];
  int64_t* ts;
  int64_t* seq;
  bool* valid;
  int64_t* next_seq;        // 0-d
  int64_t* overflow;        // 0-d
} TableBuf;

typedef struct {
  TableBuf t;               // the state read
  TableBuf o;               // the state written (or the seq-ordered view)
  SideCols ev;              // the events [B]
  int32_t col_size[SIDDHI_JOIN_MAX_COLS];
  int32_t col_type[SIDDHI_JOIN_MAX_COLS];
  int32_t n_cols, T, B, n_pk;
  int32_t pk[SIDDHI_TABLE_MAX_PK];
  const bool* mask;         // the acting (or adding) events; NULL: all
  PairProg cond;            // side 0 the events, side 1 the table
  PairProg sets;            // the SET values, one output each
  int32_t has_cond;
  int32_t mode;             // table_match: 0 any_hit, 1 delete, 2 update
  int32_t n_sets;
  int32_t set_col[SIDDHI_JOIN_MAX_COLS];
  int32_t attr, key_type, op, levels;   // table_probe
  int64_t big;
  bool* touched;            // [T]
  bool* any_hit;            // [B]
  int32_t* delta;           // [T + 1]
  KeySortScratch sort;
  int64_t *hk, *tk, *hit, *win, *rank, *free_pos, *scal;
  uint8_t* adding;
} TableArgs;

cudaError_t siddhi_table_write(const TableArgs* a, cudaStream_t stream);
cudaError_t siddhi_table_match(const TableArgs* a, cudaStream_t stream);
cudaError_t siddhi_table_probe(const TableArgs* a, cudaStream_t stream);
cudaError_t siddhi_table_buffer(const TableArgs* a, cudaStream_t stream);

// ---- kernel H: unionSet (union_set.cu) -----------------------------------

// One unionSet() aggregator's step, between K6's parts 1 and 2: it reads
// the rows' kinds, validity and reset segments (and the reset count,
// scal[0]) from K6's AggArgs. With a slot axis (n_part slots), every
// pointer up to n_kept is slot 0's and moves through part_args; the
// compacted pairs are m a slot, slot k's at k * m.
typedef struct {
  int32_t B;
  int32_t pad_;
  int64_t n;                  // (value, sign) pairs: SET_LANES * (1 + B)
  const int64_t* arg;         // [B, 1 + SET_LANES] the rows' sets
  const bool* arg_null;       // [B]
  // the table and the new one (fresh memory)
  const int64_t* vals;        // [SET_LANES]
  const int64_t* counts;      // [SET_LANES]
  const int64_t* tag;         // 0-d
  const int64_t* overflow;    // 0-d
  int64_t* new_vals;
  int64_t* new_counts;
  int64_t* new_tag;
  int64_t* new_overflow;
  int64_t* out;               // [B, 1 + SET_LANES] the union every row sees
  bool* out_null;             // [B]
  // scratch
  uint8_t* keep;              // [n] 1: a pair with a non-zero sign
  int64_t* rank;              // [n] the keep flags' inclusive prefix
  int64_t* sums;              // [ceil(n / 1024)] prefix tile totals
  int64_t* kept;              // [1] the slot's kept pairs
  int64_t* n_kept;            // [n_part] host memory (pinned): kept pairs
  // the kept pairs, m a slot
  KeySortScratch sort;        // keys: the kept pairs' values, compacted
  int64_t* sgn;               // the kept pairs' signs, compacted
  int64_t* total;             // sorted order: sign, then the totals
  int64_t* csum;              // the signs' inclusive prefix
  uint8_t* live;
  int64_t* lrank;             // the live flags' inclusive prefix
  int64_t* msums;             // [ceil(m / 1024)] prefix tile totals
  int64_t n_part;             // partition or pool slots (1 outside)
  const int64_t* moves;       // [n_moves][2] (part_args)
  int64_t n_moves;
} UnionArgs;

// Kernel H in two calls around the step's one host sync: the kept pairs
// of every slot counted into n_kept, then the union over m pairs a slot
// (m the largest count).
cudaError_t siddhi_union_count(const AggArgs* a, const UnionArgs* u,
                               cudaStream_t stream);
cudaError_t siddhi_union_finish(const AggArgs* a, const UnionArgs* u,
                                int64_t m, cudaStream_t stream);

// ---- K9p: a partition block's route, compaction and due (partition.cu) --

#define SIDDHI_PART_MAX_LABELS 16
#define SIDDHI_PART_MAX_COLS 32
#define SIDDHI_PART_MAX_QUERIES 32

typedef struct {
  int32_t B, K;               // the batch's rows, the block's slots
  int32_t mode, n_conds;      // mode 0: a value key; 1: range conditions
  const int32_t* kind;        // [B] the batch
  const bool* valid;
  const void* key_col;        // mode 0: the key, K2's output [B]
  const bool* key_null;
  int32_t key_type, pad_;     // ValType
  const bool* cond_vals[SIDDHI_PART_MAX_LABELS];   // mode 1: BOOL [B] each
  const bool* cond_nulls[SIDDHI_PART_MAX_LABELS];
  int32_t cond_slot[SIDDHI_PART_MAX_LABELS];       // each condition's label
  const int64_t* keys;        // the slot table [K], and the new one
  const bool* used;
  const int64_t* overflow;    // 0-d
  int64_t* new_keys;
  bool* new_used;
  int64_t* new_overflow;
  int32_t* slots;             // [B] out: each row's slot, -1 for none
  bool* valid_k;              // [K, B] out: each slot's valid mask
  int64_t* hk;                // [B] scratch: key hashes
  uint8_t* active;            // [B]
  int32_t* prb;               // [B]
  uint8_t* flags;             // [B]
  int32_t* claim;             // [K]
} RouteArgs;

typedef struct {
  int32_t n, out_cap;         // n = K * N rows in, out_cap rows out
  int32_t n_cols, pad_;
  const int64_t* ts;          // [n] the slots' outputs, slot after slot
  const int32_t* kind;
  const bool* valid;
  const void* cols[SIDDHI_PART_MAX_COLS];
  const bool* nulls[SIDDHI_PART_MAX_COLS];
  int32_t col_size[SIDDHI_PART_MAX_COLS];
  int64_t* out_ts;            // [out_cap] the compacted batch
  int32_t* out_kind;
  bool* out_valid;
  void* out_cols[SIDDHI_PART_MAX_COLS];
  bool* out_nulls[SIDDHI_PART_MAX_COLS];
  int64_t* emitted;           // 0-d, added to: the rows kept
  int64_t* lost;              // 0-d, added to: the valid rows dropped
  // scratch
  int64_t* vpref;             // [n] inclusive prefix count of valid rows
  int64_t* sums;              // [ceil(n / 1024)] its tile totals
  uint64_t *k0, *k1, *k2;     // [n] the valid rows' keys, ping-pong
  int32_t *i0, *i1, *i2;      // [n] their row indices, ping-pong
  int32_t* inv_idx;           // [out_cap] the invalid rows, in row order
  int32_t* counts;            // [256 * ceil(n / 1024)] digit counts
} CompactArgs;

typedef struct {
  int32_t n_q, pad_;
  const int64_t* dues[SIDDHI_PART_MAX_QUERIES];   // each query's slot dues
  int64_t n[SIDDHI_PART_MAX_QUERIES];
  int64_t* out;               // [n_q] each query's minimum
} DueArgs;

cudaError_t siddhi_partition_route(const RouteArgs* a, cudaStream_t stream);
cudaError_t siddhi_partition_compact(const CompactArgs* a,
                                     cudaStream_t stream);
cudaError_t siddhi_partition_due(const DueArgs* a, cudaStream_t stream);

// ---- K11: an incremental aggregation's bucket step (aggregation_step.cu) -

#define SIDDHI_AGGR_MAX_DUR 6
#define SIDDHI_AGGR_MAX_GROUPS 8
#define SIDDHI_AGGR_MAX_LANES 40

// durations (core/aggregation.py DURATIONS) and lane kinds (_LANE_KINDS)
enum AggrDur { DUR_SECONDS = 0, DUR_MINUTES, DUR_HOURS, DUR_DAYS,
               DUR_MONTHS, DUR_YEARS };
enum AggrLane { AGGR_COUNT = 0, AGGR_NCOUNT = 1, AGGR_SUM = 2, AGGR_MIN = 3,
                AGGR_MAX = 4 };

// Every state tensor is [D, K] (overflow [D]), one row a duration; the
// scratch is [D, B] (claim [D, K]). In a tenant pool each of these, and
// the batch's [B] columns, is a slot's, and the pointers are slot 0's
// (part_args).
typedef struct {
  int32_t B, K, D;            // the batch's rows, the table's slots, durations
  int32_t n_groups, n_lanes;
  int32_t dur[SIDDHI_AGGR_MAX_DUR];             // AggrDur of each row
  const int64_t* ets;         // [B] the event times: the aggregate-by
                              // column (LONG), else the batch ts
  const int32_t* kind;        // [B] the batch
  const bool* valid;
  const void* gcol[SIDDHI_AGGR_MAX_GROUPS];     // [B] the group-by columns
  const bool* gnull[SIDDHI_AGGR_MAX_GROUPS];
  int32_t gtype[SIDDHI_AGGR_MAX_GROUPS];        // ValType
  int32_t gsize[SIDDHI_AGGR_MAX_GROUPS];        // bytes of a value
  const void* arg[SIDDHI_AGGR_MAX_LANES];       // [B] each lane's argument
  const bool* arg_null[SIDDHI_AGGR_MAX_LANES];
  int32_t arg_type[SIDDHI_AGGR_MAX_LANES];      // ValType
  int32_t lane_kind[SIDDHI_AGGR_MAX_LANES];     // AggrLane
  int32_t lane_f64[SIDDHI_AGGR_MAX_LANES];      // 1: float64, 0: int64
  const int64_t* keys;        // the state
  const bool* used;
  const int64_t* bstart;
  const int64_t* overflow;
  const void* groups[SIDDHI_AGGR_MAX_GROUPS];
  const bool* gnulls[SIDDHI_AGGR_MAX_GROUPS];
  const void* lanes[SIDDHI_AGGR_MAX_LANES];
  int64_t* new_keys;          // the new state
  bool* new_used;
  int64_t* new_bstart;
  int64_t* new_overflow;
  void* new_groups[SIDDHI_AGGR_MAX_GROUPS];
  bool* new_gnulls[SIDDHI_AGGR_MAX_GROUPS];
  void* new_lanes[SIDDHI_AGGR_MAX_LANES];
  int64_t* bs;                // scratch: bucket starts
  int64_t* hk;                // key hashes
  uint8_t* active;
  int32_t* slot;              // each row's slot, -1 for none
  int32_t* prb;
  uint8_t* flags;
  int32_t* claim;             // [D, K]
  uint32_t* skey;             // the sort key: the slot, K for none
  int32_t* perm;              // the rows by slot, in row order within one
  uint32_t *k1, *k2;          // the sort's ping-pong
  int32_t *i1, *i2;
  int32_t* counts;            // [D, 256 * ceil(B / 1024)] digit counts
  int64_t n_part;             // tenant pool slots (1 for one table set)
  const int64_t* moves;       // [n_moves][2] (part_args)
  int64_t n_moves;
} AggrArgs;

cudaError_t siddhi_aggregation_step(const AggrArgs* a, cudaStream_t stream);

// ---- kernel K10: the reorder ring's step (reorder_ring.cu) -------------

#define SIDDHI_RING_MAX_COLS 16

typedef struct {
  int32_t C;                  // the ring's capacity; a step sorts 2C rows
  int32_t n_cols;
  int32_t count;              // live ring rows [0, count)
  int32_t n_in;               // live arrivals [0, n_in)
  int64_t wm;                 // the watermark (-2^62 before one)
  int32_t min_rel;            // release at least this many rows
  int32_t final_;             // release every live row
  int32_t levels;             // jnp.searchsorted's halvings over 2C
  int32_t pad_;
  const int64_t* sts;         // [C] the ring
  const void* scols[SIDDHI_RING_MAX_COLS];
  const int64_t* in_ts;       // [C] the arrivals
  const void* in_cols[SIDDHI_RING_MAX_COLS];
  int32_t col_size[SIDDHI_RING_MAX_COLS];   // bytes a value: 1, 4 or 8
  int64_t* new_ts;            // [C] the new ring
  void* new_cols[SIDDHI_RING_MAX_COLS];
  int64_t* rel_ts;            // [2C] the released batch
  void* rel_cols[SIDDHI_RING_MAX_COLS];
  bool* rel_nulls[SIDDHI_RING_MAX_COLS];
  int32_t* rel_kind;
  bool* rel_valid;
  int64_t* meta;              // [4] cut, wm_cut, first, last
  KeySortScratch sort;        // the sort of the 2C rows
  int32_t* rank;              // [2C] each row's place in the sort
  uint8_t* keep;              // [2C] a live row the step keeps
  int64_t* kpre;              // [2C] inclusive prefix sums of keep
  int64_t* sums;              // [ceil(2C / 1024)] their tile totals
} RingArgs;

cudaError_t siddhi_reorder_ring(const RingArgs* a, cudaStream_t stream);

#ifdef __cplusplus
}
#endif

// ---- the slot axis of a partition block ----------------------------------
//
// Inside a partition block (parallel/partition.py) a K4, K5 or K6 launch
// runs n_part slots, and its struct holds slot 0's pointers; so does a
// K1, K3, K4, K5, K6 or K7 launch of a tenant pool (serving/pool.py),
// whose batches are per slot too. The host
// owns the layout (ops/slots.py part_moves): `moves` lists, for every
// pointer whose tensor has the slot axis, the pointer's byte offset in
// the struct and its tensor's slot stride in bytes (0 for a column all
// slots share is left out). A kernel takes its struct as a
// __grid_constant__ parameter and reads it through part_args: the block
// copies it into shared memory and moves each listed pointer blockIdx.y
// slots on. With n_part 1 the kernel reads its parameter as it is (no
// copy, no barrier).
#if defined(__CUDACC__) && defined(__cplusplus)
template <typename A>
static __device__ __forceinline__ const A& part_args(const A& src) {
  static_assert(sizeof(A) % 8 == 0, "the arguments are copied by words");
  __shared__ A sh;
  if (src.n_part <= 1) return src;
  const unsigned long long* s = (const unsigned long long*)&src;
  unsigned long long* d = (unsigned long long*)&sh;
  for (int i = threadIdx.x; i < (int)(sizeof(A) / 8); i += blockDim.x)
    d[i] = s[i];
  __syncthreads();
  if (blockIdx.y > 0) {
    const int64_t k = blockIdx.y;
    for (int64_t i = threadIdx.x; i < src.n_moves; i += blockDim.x) {
      char** p = (char**)((char*)&sh + src.moves[2 * i]);
      *p += k * src.moves[2 * i + 1];
    }
    __syncthreads();
  }
  return sh;
}
#endif
