// Two-sided programs for kernels K7 (join_cross.cu) and K8
// (table_step.cu): a PairProg (ops/table.py PairProgram) run by the K2
// interpreter for one (side-0 row, side-1 row) pair, each load reading
// its column of one side, so a join's ON condition, a band key, a
// residual conjunct, a table condition and a SET value keep the
// reference's float, null and NaN rules (csrc/expr_interp.cuh).
#pragma once

#include "expr_interp.cuh"

namespace pairs {

using siddhi::Slot;

// the column index of side 0's timestamps (ops/table.py TS_COL)
constexpr int TS_COL = 0xffff;

// Run `p` for the pair (row r0 of side 0, row r1 of side 1); a side is
// any struct with `cols` and `nulls` arrays (SideCols, TableBuf), taken
// by reference so that no pointer into the kernel's parameters is made
// (that would copy the whole argument struct to each thread's stack).
// Outputs go to out[arg] (may be NULL for a condition). -> whether every
// KEEP held.
template <class S0, class S1>
__device__ __forceinline__ bool run(const PairProg& p, const S0& s0,
                                    int64_t r0, const S1& s1, int64_t r1,
                                    Slot* out) {
  return siddhi::interp(
      p.n_code, [&](int pc) { return p.code[pc]; },
      [&](int i) { return p.consts[i]; },
      [&](int arg, int type, Slot* sl) {
        const int in = p.ins[arg];
        const int col = in & 0xffff;
        if (col == TS_COL) {   // side 0's row timestamp (eventTimestamp())
          sl->v = s0.ts[r0];
          sl->null = false;
        } else if (in >> 16) {
          sl->v = siddhi::load_col(s1.cols[col], type, r1);
          sl->null = s1.nulls[col][r1];
        } else {
          sl->v = siddhi::load_col(s0.cols[col], type, r0);
          sl->null = s0.nulls[col][r0];
        }
      },
      [&](int arg, int type, const Slot& sl) {
        if (out != nullptr) out[arg] = sl;
      });
}

// copy element `from` of src into element `to` of dst, `size` bytes each
__device__ __forceinline__ void copy_elem(void* dst, int64_t to,
                                          const void* src, int64_t from,
                                          int size) {
  if (size == 8)
    ((int64_t*)dst)[to] = ((const int64_t*)src)[from];
  else if (size == 4)
    ((int32_t*)dst)[to] = ((const int32_t*)src)[from];
  else
    ((uint8_t*)dst)[to] = ((const uint8_t*)src)[from];
}

}  // namespace pairs
