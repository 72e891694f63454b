// Kernel K5: one window step over a batch (ops/windows.py window_step).
//
// Replaces the reference's window steps, siddhi_tpu/ops/windows.py:
// TimeWindowOp.step (:289), LengthWindowOp.step (:367),
// LengthBatchWindowOp.step (:459), TimeBatchWindowOp.step (:581) and
// the empty window of a join side without one (siddhi_tpu/ops/
// windows2.py EmptyWindowOp.step, :1460), with their helpers
// make_pool (:78), keep_newest (:113, the region path),
// emission_sort (:151), running_time (:178), arrival_seqs (:185) and
// current_row_positions (:194).
//
// The pool is the window's buffer (W rows) followed by the batch (B
// rows). A step is a fixed sequence of launches on the caller's stream,
// with no host sync:
//   1. batch_prefix (one block): arrival seqs of the CURRENT rows, the
//      running time (cummax of valid timestamps), the row of the k-th
//      CURRENT row;
//   2. scalars (one thread): the kind's flush decision (lengthBatch:
//      the completed batches; timeBatch: now >= next emit time);
//   3. pool_marks: per pool row, the keep masks of the next buffers;
//   4. keep_scan (one block a mask): each kept row's rank, by prefix sum;
//   5. cand_marks: per output candidate (expired copies of pool rows,
//      the CURRENT rows, RESET rows) its source row, timestamp, kind
//      and emission key emit_row * 4 + phase (a time window's expiry row
//      is a binary search of the running time);
//   6. a stable radix sort of the keys (sort_scan.cuh): the emission
//      order, ties in candidate order, which is seq order;
//   7. out_gather: the output batch in that order;
//   8. keep_gather: the newest `cap` kept rows into each new buffer;
//   9. finish: the counters.
// The output has every candidate, the invalid ones last in candidate
// order, as the reference's argsort leaves them; the new buffers hold
// the reference's garbage rows too (pool row 0 where nothing is kept),
// so state and output are bit-equal to the plain version's.
#include "siddhi_kernels.h"
#include "sort_scan.cuh"

namespace {

constexpr int32_t CUR = 0, EXP = 1, RST = 3;   // core/event.py kinds
constexpr int64_t NEG_INF = -(1LL << 62);
constexpr int T1 = 256;

// scal[] slots
enum { S_NS0 = 0, S_NCUR, S_NOW, S_COND, S_TOT0, S_TOT1, S_FIRST_BATCH,
       S_LAST_COMPLETE, S_FIRST_FLUSH_ROW, S_ZERO };

struct View {
  const WindowArgs& a;
  __device__ bool cur(int32_t i) const {
    return a.batch.valid[i] && a.batch_kind[i] == CUR;
  }
  __device__ int64_t pool_ts(int32_t p) const {
    return p < a.W ? a.a.ts[p] : a.batch.ts[p - a.W];
  }
  __device__ int64_t pool_seq(int32_t p) const {
    return p < a.W ? a.a.seq[p] : a.b_seq[p - a.W];
  }
  __device__ bool pool_valid(int32_t p) const {
    return p < a.W ? a.a.valid[p] : cur(p - a.W);
  }
  // the row of arrival seq s (LengthBatch, Length)
  __device__ int64_t row_of(int64_t s) const {
    int64_t k = s - a.scal[S_NS0];
    k = k < 0 ? 0 : (k > a.B - 1 ? a.B - 1 : k);
    return a.cur_rows[k];
  }
  __device__ int64_t floordiv(int64_t x, int64_t d) const {
    const int64_t q = x / d;
    return (x % d != 0 && ((x < 0) != (d < 0))) ? q - 1 : q;
  }
  __device__ int64_t batch_of(int32_t p) const {
    return pool_valid(p) ? floordiv(pool_seq(p), a.length) : -1;
  }
};

// source row s (E, then A, then the batch) of column c, copied
__device__ __forceinline__ void copy_col(const WindowArgs& a, int c,
                                         int32_t s, void* dst, int64_t j) {
  const int sz = a.col_size[c];
  const void* src;
  int64_t r;
  if (s < a.EB) {
    src = a.e.cols[c];
    r = s;
  } else if (s < a.EB + a.W) {
    src = a.a.cols[c];
    r = s - a.EB;
  } else {
    src = a.batch.cols[c];
    r = s - a.EB - a.W;
  }
  if (sz == 8)
    ((int64_t*)dst)[j] = ((const int64_t*)src)[r];
  else if (sz == 4)
    ((int32_t*)dst)[j] = ((const int32_t*)src)[r];
  else
    ((uint8_t*)dst)[j] = ((const uint8_t*)src)[r];
}

__device__ __forceinline__ bool src_null(const WindowArgs& a, int c,
                                         int32_t s) {
  if (s < a.EB) return a.e.nulls[c][s];
  if (s < a.EB + a.W) return a.a.nulls[c][s - a.EB];
  return a.batch.nulls[c][s - a.EB - a.W];
}

__global__ void batch_prefix(const WindowArgs a) {
  __shared__ int64_t buf[SS_BLOCK];
  const View v{a};
  int64_t lo, hi;
  ss::span(a.B, &lo, &hi);
  int64_t n = 0, mx = NEG_INF;
  for (int64_t i = lo; i < hi; ++i) {
    n += v.cur(i);
    if (a.batch.valid[i] && a.batch.ts[i] > mx) mx = a.batch.ts[i];
  }
  int64_t total;
  const int64_t incl = ss::block_scan_sum(n, buf, &total);
  const int64_t mx_incl = ss::block_scan_max(mx, buf);
  const int64_t ns0 = *a.next_seq;
  int64_t before = incl - n;
  // the running max of the spans before this one
  buf[threadIdx.x] = mx_incl;
  __syncthreads();
  int64_t run = threadIdx.x > 0 ? buf[threadIdx.x - 1] : NEG_INF;
  for (int64_t i = lo; i < hi; ++i) {
    const bool c = v.cur(i);
    a.b_seq[i] = c ? ns0 + before : NEG_INF;
    if (a.batch.valid[i] && a.batch.ts[i] > run) run = a.batch.ts[i];
    a.rt[i] = run;
    if (c)
      a.cur_rows[before] = (int32_t)i;
    else
      a.cur_rows[total + (i - before)] = (int32_t)i;
    before += c;
  }
  if (threadIdx.x == 0) {
    a.scal[S_NS0] = ns0;
    a.scal[S_NCUR] = total;
    a.scal[S_NOW] = *a.now;
    a.scal[S_ZERO] = 0;
    *a.o_next_seq = ns0 + total;
  }
}

__global__ void scalars(const WindowArgs a) {
  const View v{a};
  int64_t* s = a.scal;
  if (a.kind == WIN_LENGTH_BATCH) {
    const int64_t L = a.length;
    const int64_t first = v.floordiv(s[S_NS0], L);
    const int64_t last = v.floordiv(s[S_NS0] + s[S_NCUR], L);
    s[S_FIRST_BATCH] = first;
    s[S_LAST_COMPLETE] = last;
    s[S_COND] = last > first;
    s[S_FIRST_FLUSH_ROW] = v.row_of((first + 1) * L - 1);
  } else if (a.kind == WIN_TIME_BATCH) {
    const int64_t now = s[S_NOW], T = a.span_ms;
    int64_t init;
    if (a.has_start) {
      int64_t m = (now - a.start_time) % T;
      if (m != 0 && ((m < 0) != (T < 0))) m += T;
      init = now - m + T;
    } else {
      init = now + T;
    }
    int64_t ne = *a.next_emit == -1 ? init : *a.next_emit;
    const bool send = now >= ne;
    s[S_COND] = send;
    *a.o_next_emit = send ? ne + T : ne;
  } else {
    s[S_COND] = 0;
  }
}

// keep masks over the pool: mask 0 -> the new A buffer, mask 1 -> the new
// E buffer (lengthBatch, timeBatch; timeBatch's mask 1 is every valid
// pool row, whose count also gives had_pending and the overflow)
__global__ void pool_marks(const WindowArgs a) {
  const int32_t p = blockIdx.x * T1 + threadIdx.x;
  if (p >= a.P) return;
  const View v{a};
  const bool pv = v.pool_valid(p);
  uint8_t k0 = 0, k1 = 0;
  switch (a.kind) {
    case WIN_TIME: {
      int64_t lo = 0, hi = a.B;
      const int64_t due = v.pool_ts(p) + a.span_ms;
      while (lo < hi) {   // searchsorted(rt, due, side="left")
        const int64_t mid = (lo + hi) >> 1;
        if (a.rt[mid] < due) lo = mid + 1; else hi = mid;
      }
      const int64_t own = p < a.W ? -1 : p - a.W;
      const int64_t er = lo > own + 1 ? lo : own + 1;
      k0 = pv && !(er < a.B);
      break;
    }
    case WIN_LENGTH: {
      const int64_t last = a.scal[S_NS0] + a.scal[S_NCUR] - 1;
      k0 = pv && !(v.pool_seq(p) <= last - a.length);
      break;
    }
    case WIN_LENGTH_BATCH: {
      const int64_t b = v.batch_of(p), lc = a.scal[S_LAST_COMPLETE];
      k0 = pv && b >= lc;
      k1 = pv && b == lc - 1;
      break;
    }
    default: {   // WIN_TIME_BATCH
      k0 = pv && !a.scal[S_COND];
      k1 = pv;
    }
  }
  a.keep[p] = k0;
  a.keep[a.P + p] = k1;
}

// one block: the rank of every kept row of mask m, and the total
__global__ void keep_scan(const WindowArgs a, int m) {
  __shared__ int64_t buf[SS_BLOCK];
  const uint8_t* keep = a.keep + (int64_t)m * a.P;
  int32_t* rank_pos = a.rank_pos + (int64_t)m * a.P;
  int64_t lo, hi, n = 0, total;
  ss::span(a.P, &lo, &hi);
  for (int64_t p = lo; p < hi; ++p) n += keep[p];
  int64_t r = ss::block_scan_sum(n, buf, &total) - n;
  for (int64_t p = lo; p < hi; ++p)
    if (keep[p]) rank_pos[r++] = (int32_t)p;
  if (threadIdx.x == 0) a.scal[S_TOT0 + m] = total;
}

constexpr uint32_t INVALID = 0xffffffffu;

__global__ void cand_marks(const WindowArgs a, uint32_t inv) {
  const int32_t c = blockIdx.x * T1 + threadIdx.x;
  if (c >= a.N) return;
  const View v{a};
  const int64_t now = a.scal[S_NOW];
  const int32_t B = a.B, P = a.P, EB = a.EB;
  int32_t src = 0, kind = CUR;
  int64_t ts = 0, key = -1;     // key -1: not emitted
  switch (a.kind) {
    case WIN_TIME: {
      if (c < P) {
        int64_t lo = 0, hi = B;
        const int64_t due = v.pool_ts(c) + a.span_ms;
        while (lo < hi) {
          const int64_t mid = (lo + hi) >> 1;
          if (a.rt[mid] < due) lo = mid + 1; else hi = mid;
        }
        const int64_t own = c < a.W ? -1 : c - a.W;
        const int64_t er = lo > own + 1 ? lo : own + 1;
        const int64_t safe = er > B - 1 ? B - 1 : er;
        src = EB + c;
        ts = a.rt[safe];
        kind = EXP;
        if (a.expired_enabled && v.pool_valid(c) && er < B) key = safe * 4;
      } else {
        const int32_t i = c - P;
        src = EB + a.W + i;
        ts = a.batch.ts[i];
        if (v.cur(i)) key = (int64_t)i * 4 + 2;
      }
      break;
    }
    case WIN_EMPTY: {        // CURRENT, then its EXPIRED clone at now
      const int32_t seg = c / B, i = c % B;
      src = EB + a.W + i;
      ts = seg == 0 ? a.batch.ts[i] : now;
      kind = seg == 0 ? CUR : EXP;
      if (v.cur(i)) key = (int64_t)i * 4 + (seg == 0 ? 2 : 3);
      break;
    }
    case WIN_LENGTH: {
      if (a.length == 0) {   // CURRENT, its EXPIRED clone, then RESET
        const int32_t seg = c / B, i = c % B;
        src = EB + a.W + i;
        ts = a.batch.ts[i];
        kind = seg == 0 ? CUR : (seg == 1 ? EXP : RST);
        const bool on = v.cur(i) && (seg != 1 || a.expired_enabled);
        if (on) key = (int64_t)i * 4 + (seg == 0 ? 2 : 3);
      } else if (c < P) {
        const int64_t last = a.scal[S_NS0] + a.scal[S_NCUR] - 1;
        src = EB + c;
        ts = now;
        kind = EXP;
        const int64_t sq = v.pool_seq(c);
        if (a.expired_enabled && v.pool_valid(c) && sq <= last - a.length)
          key = v.row_of(sq + a.length) * 4;
      } else {
        const int32_t i = c - P;
        src = EB + a.W + i;
        ts = a.batch.ts[i];
        if (v.cur(i)) key = (int64_t)i * 4 + 2;
      }
      break;
    }
    case WIN_LENGTH_BATCH: {
      const int64_t L = a.length, lc = a.scal[S_LAST_COMPLETE];
      const bool any_flush = a.scal[S_COND];
      if (c < EB) {
        src = c;
        ts = now;
        kind = EXP;
        if (a.expired_enabled && !a.stream_current && a.e.valid[c] &&
            any_flush)
          key = a.scal[S_FIRST_FLUSH_ROW] * 4;
        break;
      }
      const int32_t seg = (c - EB) / P, p = (c - EB) % P;
      src = EB + p;
      const bool pv = v.pool_valid(p);
      const int64_t b = v.batch_of(p), sq = v.pool_seq(p);
      const bool flushed = pv && b < lc;
      const int64_t flush_seq = (b + 1) * L - 1;
      if (seg == 0) {          // expired copies
        ts = now;
        kind = EXP;
        if (a.stream_current) {
          if (a.expired_enabled && flushed) key = v.row_of(flush_seq) * 4;
        } else if (a.expired_enabled && flushed && b + 1 < lc) {
          key = v.row_of((b + 2) * L - 1) * 4;
        }
      } else if (seg == 1) {   // currents
        ts = v.pool_ts(p);
        kind = CUR;
        if (a.stream_current) {
          if (pv && sq >= a.scal[S_NS0]) key = v.row_of(sq) * 4 + 2;
        } else if (flushed) {
          key = v.row_of(flush_seq) * 4 + 2;
        }
      } else {                 // one RESET per flush, on the batch's tail
        ts = now;
        kind = RST;
        if (flushed && sq == flush_seq) key = v.row_of(flush_seq) * 4 + 1;
      }
      break;
    }
    default: {   // WIN_TIME_BATCH
      const bool send = a.scal[S_COND];
      if (c < EB) {
        src = c;
        ts = now;
        kind = EXP;
        if (!a.stream_current && a.expired_enabled && a.e.valid[c] && send)
          key = 0;
      } else if (c < EB + P) {
        const int32_t p = c - EB;
        src = EB + p;
        ts = v.pool_ts(p);
        kind = CUR;
        const bool pv = v.pool_valid(p);
        const bool on = a.stream_current ? pv && v.pool_seq(p) >= a.scal[S_NS0]
                                         : pv && send;
        if (on) key = 2;
      } else if (c == EB + P) {
        src = EB;              // pool row 0
        ts = now;
        kind = RST;
        if (send && a.scal[S_TOT1] > 0) key = 1;
      } else {                 // stream-current: the batch expires now
        const int32_t p = c - EB - P - 1;
        src = EB + p;
        ts = now;
        kind = EXP;
        if (a.expired_enabled && v.pool_valid(p) && send) key = 0;
      }
    }
  }
  a.keys[c] = key < 0 ? inv : (uint32_t)key;
  a.cand_src[c] = src;
  a.cand_ts[c] = ts;
  a.cand_kind[c] = kind;
}

__global__ void out_gather(const WindowArgs a, uint32_t inv) {
  const int32_t j = blockIdx.x * T1 + threadIdx.x;
  if (j >= a.N) return;
  const int32_t c = a.order[j];
  const int32_t s = a.cand_src[c];
  a.out.ts[j] = a.cand_ts[c];
  a.out_kind[j] = a.cand_kind[c];
  a.out.valid[j] = a.keys[c] != inv;
  for (int k = 0; k < a.n_cols; ++k) {
    copy_col(a, k, s, a.out.cols[k], j);
    a.out.nulls[k][j] = src_null(a, k, s);
  }
}

// the newest `cap` rows of mask m into dst; where scal[cond] is 0 (cond
// >= 0), dst takes the old buffer's row instead
__global__ void keep_gather(const WindowArgs a, int m, WinBuf dst, int32_t cap,
                            int cond, WinBuf old) {
  const int32_t j = blockIdx.x * T1 + threadIdx.x;
  if (j >= cap) return;
  if (cond >= 0 && !a.scal[cond]) {
    dst.ts[j] = old.ts[j];
    dst.seq[j] = old.seq[j];
    dst.valid[j] = old.valid[j];
    for (int k = 0; k < a.n_cols; ++k) {
      const int sz = a.col_size[k];
      if (sz == 8)
        ((int64_t*)dst.cols[k])[j] = ((const int64_t*)old.cols[k])[j];
      else if (sz == 4)
        ((int32_t*)dst.cols[k])[j] = ((const int32_t*)old.cols[k])[j];
      else
        ((uint8_t*)dst.cols[k])[j] = ((const uint8_t*)old.cols[k])[j];
      dst.nulls[k][j] = old.nulls[k][j];
    }
    return;
  }
  const View v{a};
  const int64_t r = a.scal[S_TOT0 + m] - cap + j;
  const int32_t p = r < 0 ? 0 : a.rank_pos[(int64_t)m * a.P + r];
  dst.ts[j] = v.pool_ts(p);
  dst.seq[j] = v.pool_seq(p);
  dst.valid[j] = r >= 0;
  for (int k = 0; k < a.n_cols; ++k) {
    copy_col(a, k, a.EB + p, dst.cols[k], j);
    dst.nulls[k][j] = src_null(a, k, a.EB + p);
  }
}

__global__ void finish(const WindowArgs a) {
  if (a.o_overflow == nullptr) return;
  int64_t tot = 0;
  if (a.kind == WIN_TIME) tot = a.scal[S_TOT0];
  if (a.kind == WIN_TIME_BATCH) tot = a.scal[S_TOT1];
  const int64_t ovf = tot > a.W ? tot - a.W : 0;
  *a.o_overflow = *a.overflow + ovf;
}

inline int grid(int64_t n) { return (int)((n + T1 - 1) / T1); }

}  // namespace

extern "C" cudaError_t siddhi_window_step(const WindowArgs* p,
                                          cudaStream_t stream) {
  const WindowArgs& a = *p;
  batch_prefix<<<1, SS_BLOCK, 0, stream>>>(a);
  scalars<<<1, 1, 0, stream>>>(a);
  const bool pooled =
      !(a.kind == WIN_LENGTH && a.length == 0) && a.kind != WIN_EMPTY;
  if (pooled) {
    pool_marks<<<grid(a.P), T1, 0, stream>>>(a);
    keep_scan<<<1, SS_BLOCK, 0, stream>>>(a, 0);
    if (a.kind == WIN_LENGTH_BATCH || a.kind == WIN_TIME_BATCH)
      keep_scan<<<1, SS_BLOCK, 0, stream>>>(a, 1);
  }
  // keys: emit_row * 4 + phase <= 4 * B - 1, invalid ones above
  const int bits = ss::key_bits(4ull * a.B);
  const uint32_t inv = (uint32_t)((1ull << bits) - 1);
  cand_marks<<<grid(a.N), T1, 0, stream>>>(a, inv);
  cudaError_t err = ss::stable_sort(a.keys, a.N, bits, a.order, a.k1, a.k2,
                                    a.i1, a.i2, a.counts, stream);
  if (err != cudaSuccess) return err;
  out_gather<<<grid(a.N), T1, 0, stream>>>(a, inv);
  if (a.kind == WIN_EMPTY) {
    // no buffer to keep
  } else if (!pooled) {   // length(0): the buffer stays as it was
    keep_gather<<<grid(a.W), T1, 0, stream>>>(a, 0, a.na, a.W, S_ZERO, a.a);
  } else if (a.kind == WIN_LENGTH_BATCH) {
    keep_gather<<<grid(a.W), T1, 0, stream>>>(a, 0, a.na, a.W, -1, a.a);
    keep_gather<<<grid(a.EB), T1, 0, stream>>>(a, 1, a.ne, a.EB, S_COND, a.e);
  } else if (a.kind == WIN_TIME_BATCH) {
    keep_gather<<<grid(a.W), T1, 0, stream>>>(a, 0, a.na, a.W, -1, a.a);
    keep_gather<<<grid(a.EB), T1, 0, stream>>>(a, 1, a.ne, a.EB, S_COND, a.e);
  } else {
    keep_gather<<<grid(a.W), T1, 0, stream>>>(a, 0, a.na, a.W, -1, a.a);
  }
  finish<<<1, 1, 0, stream>>>(a);
  return cudaGetLastError();
}
