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
// kernel K3 shares.
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
          s->v = load_col(p.in_cols[arg], type, row);
          s->null = p.in_nulls[arg][row];
        },
        [&](int arg, int type, const Slot& s) {
          store_col(p.out_cols[arg], type, row, s.v);
          p.out_nulls[arg][row] = s.null;
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
