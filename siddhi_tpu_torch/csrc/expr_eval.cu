// Kernel K2: evaluate the compiled expressions of one filter+project
// query step, for every row, in one launch.
//
// Replaces the reference's jitted expression closures,
// siddhi_tpu/ops/expr.py compile_expression (:184) with _compile_math
// (:300) and _compile_compare (:339), as evaluated by FilterOp.step
// (ops/operators.py:64) and ProjectOp.step (ops/selector.py:192): in the
// reference a query's filters and projections trace into one XLA
// program, and here they run as one launch.
//
// Why an interpreter: the planner lowers each expression to a flat typed
// postfix program (ops/expr.py lower_*) and this one kernel runs any
// such program. Generating CUDA per query instead would make every app
// deployment pay an nvcc build; with the interpreter, deploying an app
// compiles nothing. The program and its constant pool ride in the
// by-value arguments, i.e. the constant bank: every thread of a warp
// reads the same instruction at the same time, which the constant cache
// serves as one broadcast, and all threads take the same branch of the
// dispatch switch, so the interpreter does not diverge.
//
// Bound: memory bytes. Per row it reads the referenced columns, their
// null masks, kind and valid, and writes the keep mask and each output
// column and null mask; the arithmetic is a few operations a row. The
// stack is a small per-thread array of (64-bit value, null) pairs.
//
// The semantics (null, flush and NaN rules, kept bit for bit from the
// reference) live in the interpreter, csrc/expr_interp.cuh, which
// kernels K3, K4, K7 and K8 share. What only this kernel reads: the
// row's timestamp and the step's clock (eventTimestamp(),
// currentTimeMillis(): inputs with no null mask, the clock one int64
// every row reads) and set columns, [rows, 1 + SET_LANES] int64 rows
// that a projection copies (VT_SETREF), counts (VT_SETSIZE, sizeOfSet())
// or writes from a createSet() element (VT_SET, its tag in OUT's arg).
#include "expr_interp.cuh"

namespace {

using namespace siddhi;

__global__ void expr_eval_kernel(const ExprParams p) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  bool keep_row = false;
  if (row < p.rows) {
    bool keep = interp(
        p.n_code, [&](int pc) { return p.code[pc]; },
        [&](int i) { return p.consts[i]; },
        [&](int arg, int type, Slot* s) {
          s->null = p.in_nulls[arg] != nullptr && p.in_nulls[arg][row];
          if (type == VT_SETREF) {
            s->v = arg;
          } else if (type == VT_SETSIZE) {
            const int64_t* set = (const int64_t*)p.in_cols[arg] +
                                 (int64_t)row * (1 + SIDDHI_SET_LANES);
            int n = 0;
            for (int l = 1; l <= SIDDHI_SET_LANES; ++l)
              n += set[l] != SIDDHI_SET_EMPTY;
            s->v = n;
          } else {
            s->v = load_col(p.in_cols[arg], type,
                            arg == p.now_input ? 0 : row);
          }
        },
        [&](int arg, int type, const Slot& s) {
          if (type == VT_SET || type == VT_SETREF) {
            const int k = arg & 0xff;
            int64_t* o = (int64_t*)p.out_cols[k] +
                         (int64_t)row * (1 + SIDDHI_SET_LANES);
            if (type == VT_SET) {
              o[0] = arg >> 8;
              o[1] = s.v;
              for (int l = 2; l <= SIDDHI_SET_LANES; ++l)
                o[l] = SIDDHI_SET_EMPTY;
            } else {
              const int64_t* src = (const int64_t*)p.in_cols[s.v] +
                                   (int64_t)row * (1 + SIDDHI_SET_LANES);
              for (int l = 0; l <= SIDDHI_SET_LANES; ++l) o[l] = src[l];
            }
            p.out_nulls[k][row] = s.null;
          } else {
            store_col(p.out_cols[arg], type, row, s.v);
            p.out_nulls[arg][row] = s.null;
          }
        });
    const int kind = p.kind[row];
    keep = keep || (p.timer_pass && kind == 2);  // TIMER passes filters
    keep_row = p.valid[row] && keep && ((p.gate_bits >> kind) & 1);
    p.out_valid[row] = keep_row;
  }
  if (p.emitted != nullptr) {
    const int kept = __syncthreads_count(keep_row);
    if (threadIdx.x == 0 && kept) {
      atomicAdd(p.emitted, (unsigned long long)kept);
    }
  }
}

}  // namespace

extern "C" cudaError_t siddhi_expr_eval(const ExprParams* p,
                                        cudaStream_t stream) {
  const int threads = 256;
  const int blocks = (p->rows + threads - 1) / threads;
  expr_eval_kernel<<<blocks, threads, 0, stream>>>(*p);
  return cudaGetLastError();
}
