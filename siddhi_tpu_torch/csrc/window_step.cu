// Kernel K5: one window step over a batch (ops/windows.py window_step).
//
// Replaces the reference's window steps, siddhi_tpu/ops/windows.py:
// TimeWindowOp.step (:289), LengthWindowOp.step (:367),
// LengthBatchWindowOp.step (:459), TimeBatchWindowOp.step (:581); and
// siddhi_tpu/ops/windows2.py: ExternalTimeWindowOp.step (:85),
// TimeLengthWindowOp.step (:152), DelayWindowOp.step (:239),
// BatchWindowOp.step (:302), ExternalTimeBatchWindowOp.step (:897),
// EmptyWindowOp.step (:1460) and HoppingWindowOp.step (:1519), and, as
// kernel K5c, CronWindowOp.step (:1393); with
// their helpers make_pool (:78), keep_newest (:113, the region path),
// emission_sort (:151), running_time (:178), arrival_seqs (:185),
// current_row_positions (:194) and _ext_running_time (windows2.py :54).
//
// The sources of a step are the window's expired batch E (EB rows), its
// buffer A (W rows: the buffer, the current batch, or the batch window's
// reset row) and the batch (B rows); the pool is A followed by the
// batch. A step is a fixed sequence of launches on the caller's stream,
// with no host sync:
//   1. batch_prefix (one block): arrival seqs of the CURRENT rows, the
//      running clock (cummax of valid timestamps, or of the CURRENT
//      rows' external clock), the row of the k-th CURRENT row, and the
//      externalTimeBatch reductions (clock max, TIMER rows);
//   2. scalars (one thread): the kind's step decisions (lengthBatch:
//      the completed batches; timeBatch, hopping: now >= the next emit;
//      batch: any arrivals; externalTimeBatch: its start; cron: a TIMER
//      row with rows pending, the flush);
//   3. ext_batch_prep (one block, externalTimeBatch): the carried
//      window, the step's first flush, the early (timeout) flush, each
//      batch's first row, the new counters;
//   4. src_marks: per source row, the keep masks of the new buffers;
//   5. keep_scan (one block a mask): each kept row's rank, by prefix sum
//      (timeLength scans its survivors first: their ranks are the
//      queue positions its eviction reads);
//   6. cand_marks: per output candidate (copies of source rows in the
//      kind's segments) its source row, timestamp, kind and emission key
//      emit_row * 4 + phase (a sliding window's expiry row is a binary
//      search of the running clock);
//   7. a stable radix sort of the keys (sort_scan.cuh): the emission
//      order, ties in candidate order, which is seq order;
//   8. out_gather: the output batch in that order;
//   9. keep_gather: the newest `cap` kept rows into each new buffer
//      (cron: the arrivals after the buffer, or alone on a flush, and
//      cron_rotate: the new expired batch, the buffer on a flush, else
//      the old one, row for row);
//  10. finish: the counters.
// The output has every candidate, the invalid ones last in candidate
// order, as the reference's argsort leaves them; the new buffers hold
// the reference's garbage rows too (the first row of the pool keep_newest
// ran over, or zeros where that pool began with an empty buffer), so
// state and output are bit-equal to the plain version's.
//
// Bound: the bytes of the pool and the output (a few words a row); the
// step is a chain of small launches and three block-wide scans, so at
// B = 65,536 it is latency-bound, not bandwidth-bound.
#include "siddhi_kernels.h"
#include "sort_scan.cuh"

namespace {

constexpr int32_t CUR = 0, EXP = 1, TMR = 2, RST = 3;   // core/event.py
constexpr int64_t NEG_INF = -(1LL << 62);
constexpr int64_t POS_INF = 1LL << 62;
constexpr int64_t BIG = 1LL << 62;
constexpr int T1 = 256;

// scal[] slots
enum { S_NS0 = 0, S_NCUR, S_NOW, S_COND, S_TOT0, S_TOT1, S_FIRST_BATCH,
       S_LAST_COMPLETE, S_FIRST_FLUSH_ROW, S_ZERO, S_HOP_AT, S_NEXT_HOP,
       S_START, S_LAST_EXT, S_BMAX_EXT, S_IS_TIMER, S_TIMER_TS, S_EARLY,
       S_ANY_FLUSH, S_FLUSH_TS, S_MAX_W, S_FLUSHED0, S_EXP_ON, S_RECUR_ON,
       S_LAST_GRP, S_PENDING };

__device__ __forceinline__ int64_t floordiv(int64_t x, int64_t d) {
  const int64_t q = x / d;
  return (x % d != 0 && ((x < 0) != (d < 0))) ? q - 1 : q;
}

__device__ __forceinline__ int64_t read_int(const void* col, int sz,
                                            int64_t r) {
  if (sz == 8) return ((const int64_t*)col)[r];
  if (sz == 4) return ((const int32_t*)col)[r];
  return ((const uint8_t*)col)[r];
}

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
  // column c of pool row p as int64 (the external clock)
  __device__ int64_t pool_int(int c, int32_t p) const {
    return p < a.W ? read_int(a.a.cols[c], a.col_size[c], p)
                   : read_int(a.batch.cols[c], a.col_size[c], p - a.W);
  }
  __device__ int64_t ext(int32_t i) const {   // batch row i's clock
    return read_int(a.batch.cols[a.ts_idx], a.col_size[a.ts_idx], i);
  }
  // source s: E, then A, then the batch
  __device__ int64_t src_ts(int32_t s) const {
    return s < a.EB ? a.e.ts[s] : pool_ts(s - a.EB);
  }
  __device__ int64_t src_seq(int32_t s) const {
    return s < a.EB ? a.e.seq[s] : pool_seq(s - a.EB);
  }
  // the row of arrival seq s (LengthBatch, Length)
  __device__ int64_t row_of(int64_t s) const {
    return cur_row(s - a.scal[S_NS0]);
  }
  __device__ int64_t cur_row(int64_t k) const {   // cur_rows[clip(k)]
    k = k < 0 ? 0 : (k > a.B - 1 ? a.B - 1 : k);
    return a.cur_rows[k];
  }
  __device__ int64_t batch_of(int32_t p) const {
    return pool_valid(p) ? floordiv(pool_seq(p), a.length) : -1;
  }
  // externalTimeBatch: a pool row's window, the arrivals' windows in
  // arrival order (padding BIG), and searchsorted(.., side="right")
  __device__ int64_t w_of(int32_t p) const {
    return pool_valid(p) ? floordiv(pool_int(a.ts_idx, p) - a.scal[S_START],
                                    a.span_ms)
                         : -1;
  }
  __device__ int64_t warr(int64_t k) const {
    if (k >= a.scal[S_NCUR]) return BIG;
    return floordiv(ext(a.cur_rows[k]) - a.scal[S_START], a.span_ms);
  }
  __device__ int64_t flush_a(int64_t w) const {
    int64_t lo = 0, hi = a.B;
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      if (warr(mid) <= w) lo = mid + 1; else hi = mid;
    }
    return lo;
  }
  // searchsorted(rt, due, side="left"), then past the row's own
  __device__ int64_t expire_row(int32_t p, int64_t due) const {
    int64_t lo = 0, hi = a.B;
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      if (a.rt[mid] < due) lo = mid + 1; else hi = mid;
    }
    const int64_t own = p < a.W ? -1 : p - a.W;
    return lo > own + 1 ? lo : own + 1;
  }
};

// externalTimeBatch with replace.with.batchtime: the emitted copy of a
// valid pool row carries its batch's end in the clock column
__device__ __forceinline__ bool replaced(const WindowArgs& a, int c,
                                         int32_t s, int64_t* v) {
  if (!a.replace_ts || c != a.ts_idx || s < a.EB) return false;
  const View w{a};
  const int32_t p = s - a.EB;
  if (!w.pool_valid(p)) return false;
  *v = a.scal[S_START] + (w.w_of(p) + 1) * a.span_ms;
  return true;
}

// source row s of column c, copied (s < 0: a zero row); `emit`: the
// emitted view of the pool
__device__ __forceinline__ void copy_col(const WindowArgs& a, int c,
                                         int32_t s, void* dst, int64_t j,
                                         bool emit) {
  const int sz = a.col_size[c];
  int64_t rv;
  if (emit && replaced(a, c, s, &rv)) {
    ((int64_t*)dst)[j] = rv;
    return;
  }
  if (s < 0) {
    zero_row(dst, j, sz);
    return;
  }
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
  copy_row(dst, j, src, r, sz);
}

__device__ __forceinline__ bool src_null(const WindowArgs& a, int c,
                                         int32_t s) {
  if (s < 0) return false;
  if (s < a.EB) return a.e.nulls[c][s];
  if (s < a.EB + a.W) return a.a.nulls[c][s - a.EB];
  return a.batch.nulls[c][s - a.EB - a.W];
}

// the block's maximum of one int64 a thread (every thread gets it)
__device__ __forceinline__ int64_t block_max(int64_t v, int64_t* buf) {
  ss::block_scan_max(v, buf);
  const int64_t m = buf[SS_BLOCK - 1];
  __syncthreads();
  return m;
}

__global__ void __launch_bounds__(SS_BLOCK)
    batch_prefix(const __grid_constant__ WindowArgs a0) {
  const WindowArgs& a = part_args(a0);
  __shared__ int64_t buf[SS_BLOCK];
  const View v{a};
  const bool ext_clock = a.kind == WIN_EXT_TIME;
  int64_t lo, hi;
  ss::span(a.B, &lo, &hi);
  // the running clock's element of row i
  auto clock = [&](int64_t i) -> int64_t {
    if (ext_clock) return v.cur(i) ? v.ext(i) : NEG_INF;
    return a.batch.valid[i] ? a.batch.ts[i] : NEG_INF;
  };
  int64_t n = 0, mx = NEG_INF;
  for (int64_t i = lo; i < hi; ++i) {
    n += v.cur(i);
    const int64_t t = clock(i);
    if (t > mx) mx = t;
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
  __syncthreads();
  for (int64_t i = lo; i < hi; ++i) {
    const bool c = v.cur(i);
    a.b_seq[i] = c ? ns0 + before : NEG_INF;
    const int64_t t = clock(i);
    if (t > run) run = t;
    a.rt[i] = run;
    if (c)
      a.cur_rows[before] = (int32_t)i;
    else
      a.cur_rows[total + (i - before)] = (int32_t)i;
    before += c;
  }
  if (a.kind == WIN_EXT_BATCH) {
    // max(where(cur, ext, 0)); any TIMER row; max(where(timer, ts, 0))
    int64_t em = 0, tm = 0, any_t = 0;
    for (int64_t i = lo; i < hi; ++i) {
      if (v.cur(i) && v.ext(i) > em) em = v.ext(i);
      if (a.batch.valid[i] && a.batch_kind[i] == TMR) {
        any_t = 1;
        if (a.batch.ts[i] > tm) tm = a.batch.ts[i];
      }
    }
    em = block_max(em, buf);
    tm = block_max(tm, buf);
    any_t = block_max(any_t, buf);
    if (threadIdx.x == 0) {
      a.scal[S_BMAX_EXT] = em;
      a.scal[S_TIMER_TS] = tm;
      a.scal[S_IS_TIMER] = any_t;
    }
  }
  if (a.kind == WIN_CRON) {
    // any(valid & TIMER) over the batch; any valid row in the buffer
    int64_t any_t = 0, any_p = 0, plo, phi;
    for (int64_t i = lo; i < hi; ++i)
      if (a.batch.valid[i] && a.batch_kind[i] == TMR) any_t = 1;
    ss::span(a.W, &plo, &phi);
    for (int64_t p = plo; p < phi; ++p)
      if (a.a.valid[p]) any_p = 1;
    any_t = block_max(any_t, buf);
    any_p = block_max(any_p, buf);
    if (threadIdx.x == 0) {
      a.scal[S_IS_TIMER] = any_t;
      a.scal[S_PENDING] = any_p;
    }
  }
  if (threadIdx.x == 0) {
    a.scal[S_NS0] = ns0;
    a.scal[S_NCUR] = total;
    a.scal[S_NOW] = *a.now;
    a.scal[S_ZERO] = 0;
    *a.o_next_seq = ns0 + total;
  }
}

__global__ void scalars(const __grid_constant__ WindowArgs a0) {
  const WindowArgs& a = part_args(a0);
  const View v{a};
  int64_t* s = a.scal;
  const int64_t now = s[S_NOW];
  s[S_COND] = 0;
  if (a.kind == WIN_LENGTH_BATCH) {
    const int64_t L = a.length;
    const int64_t first = floordiv(s[S_NS0], L);
    const int64_t last = floordiv(s[S_NS0] + s[S_NCUR], L);
    s[S_FIRST_BATCH] = first;
    s[S_LAST_COMPLETE] = last;
    s[S_COND] = last > first;
    s[S_FIRST_FLUSH_ROW] = v.row_of((first + 1) * L - 1);
  } else if (a.kind == WIN_TIME_BATCH || a.kind == WIN_HOPPING) {
    const int64_t T = a.kind == WIN_HOPPING ? a.hop_ms : a.span_ms;
    int64_t init;
    if (a.kind == WIN_TIME_BATCH && a.has_start) {
      int64_t m = (now - a.start_time) % T;
      if (m != 0 && ((m < 0) != (T < 0))) m += T;
      init = now - m + T;
    } else {
      init = now + T;
    }
    const int64_t ne = *a.next_emit == -1 ? init : *a.next_emit;
    const bool send = now >= ne;
    s[S_COND] = send;
    s[S_HOP_AT] = ne;
    s[S_NEXT_HOP] = send ? ne + T : ne;
    *a.o_next_emit = s[S_NEXT_HOP];
  } else if (a.kind == WIN_CRON) {
    s[S_COND] = s[S_IS_TIMER] && s[S_PENDING];   // the flush
  } else if (a.kind == WIN_BATCH) {
    s[S_COND] = s[S_NCUR] > 0;
    const int64_t lg = a.length > 0 ? floordiv(s[S_NCUR] - 1, a.length) : 0;
    s[S_LAST_GRP] = lg > 0 ? lg : 0;
  } else if (a.kind == WIN_EXT_BATCH) {
    const int32_t r0 = a.cur_rows[0];
    const int64_t first_start =
        a.start_attr >= 0
            ? read_int(a.batch.cols[a.start_attr], a.col_size[a.start_attr],
                       r0)
            : v.ext(r0);
    const int64_t st = *a.start >= 0 ? *a.start
                                     : (s[S_NCUR] > 0 ? first_start : -1);
    s[S_START] = st;
    const int64_t le = *a.last_ext > s[S_BMAX_EXT] ? *a.last_ext
                                                   : s[S_BMAX_EXT];
    s[S_LAST_EXT] = le;
    *a.o_start = st;
    *a.o_last_ext = le;
  }
}

// one block, externalTimeBatch: the flush decisions of the step
__global__ void __launch_bounds__(SS_BLOCK)
    ext_batch_prep(const __grid_constant__ WindowArgs a0) {
  const WindowArgs& a = part_args(a0);
  __shared__ int64_t buf[SS_BLOCK];
  const View v{a};
  int64_t* s = a.scal;
  const int64_t n_cur = s[S_NCUR];
  int64_t lo, hi;
  ss::span(a.P, &lo, &hi);
  // the carried batch's window; any carried row; the last flushed window
  int64_t cw = -BIG, has_c = 0, mw = -BIG, last = -1;
  for (int64_t p = lo; p < hi; ++p) {
    if (!v.pool_valid(p)) continue;
    last = p;
    const int64_t w = v.w_of(p);
    if (p < a.W) {
      has_c = 1;
      if (w > cw) cw = w;
    }
    if (v.flush_a(w) < n_cur && w > mw) mw = w;
  }
  cw = block_max(cw, buf);
  has_c = block_max(has_c, buf);
  mw = block_max(mw, buf);
  // each pool row's previous valid row: a batch's first row has another
  // window than the valid row before it
  const int64_t prev_incl = ss::block_scan_max(last, buf);
  buf[threadIdx.x] = prev_incl;
  __syncthreads();
  int64_t prev = threadIdx.x > 0 ? buf[threadIdx.x - 1] : -1;
  for (int64_t p = lo; p < hi; ++p) {
    const bool pv = v.pool_valid(p);
    const int64_t w = v.w_of(p);
    const int64_t pw = prev >= 0 ? v.w_of(prev) : -BIG;
    a.pflag[p] = pv && w != pw;
    if (pv) prev = p;
  }
  if (threadIdx.x != 0) return;
  const int64_t base_w = has_c ? cw : v.warr(0);
  const int64_t ffa = v.flush_a(base_w);
  const bool any_flush = ffa < n_cur;
  const int64_t ffr = v.cur_row(ffa);
  const int64_t ffe = v.ext(ffr);
  bool early = false;
  const int64_t sched = *a.sched;
  if (a.has_timeout)
    early = s[S_IS_TIMER] && sched < POS_INF && s[S_TIMER_TS] >= sched;
  const bool flushed0 = *a.flushed;
  const bool any_pool = has_c || n_cur > 0;
  s[S_EARLY] = early;
  s[S_ANY_FLUSH] = any_flush;
  s[S_FIRST_FLUSH_ROW] = ffr;
  s[S_FLUSH_TS] = early ? s[S_LAST_EXT] : ffe;
  s[S_MAX_W] = mw;
  s[S_FLUSHED0] = flushed0;
  s[S_EXP_ON] = any_flush || (early && (!flushed0 || any_pool));
  s[S_RECUR_ON] = flushed0 && (any_flush || (early && any_pool));
  s[S_COND] = s[S_EXP_ON];   // did_flush: the new exp replaces the old
  *a.o_flushed = early ? true : (any_flush ? false : flushed0);
  int64_t ns = sched;
  if (a.has_timeout &&
      (early || any_flush || (sched >= POS_INF && n_cur > 0)))
    ns = s[S_NOW] + a.timeout_ms;
  *a.o_sched = ns;
}

// timeLength: a pool row's time expiry at the head of the step
__device__ __forceinline__ bool tl_time_expired(const WindowArgs& a,
                                                int32_t p) {
  const View v{a};
  return v.pool_valid(p) && p < a.W &&
         v.pool_ts(p) + a.span_ms <= a.scal[S_NOW];
}

// timeLength: the arrival a live pool row is evicted at
__device__ __forceinline__ int64_t tl_k_evict(const WindowArgs& a,
                                              int32_t p) {
  const View v{a};
  const int64_t count0 = a.scal[S_TOT1];
  const int64_t q = p < a.W ? (int64_t)a.rank_of[a.S + a.EB + p]
                            : count0 + (v.pool_seq(p) - a.scal[S_NS0]);
  const int64_t d = a.length - count0;
  return q + (d > 0 ? d : 0);
}

// batch window: a batch row's arrival index and group
struct BatchRow {
  bool first, has_next;
  int64_t grp, next_start;
};

__device__ __forceinline__ BatchRow batch_row(const WindowArgs& a,
                                              int32_t i) {
  const View v{a};
  BatchRow r{false, false, 0, 0};
  if (!v.cur(i)) return r;
  const int64_t k = a.b_seq[i] - a.scal[S_NS0];
  const int64_t L = a.length;
  if (L > 0) {
    r.grp = k / L;
    r.first = k % L == 0;
    r.has_next = (r.grp + 1) * L < a.scal[S_NCUR];
    r.next_start = v.cur_row((r.grp + 1) * L);
  } else {
    r.first = k == 0;
  }
  return r;
}

// the first source a keep mask can hold: only externalTimeBatch keeps
// rows of E; the other kinds mark and scan the pool alone, as before
// E was a source
__host__ __device__ __forceinline__ int32_t keep_lo(const WindowArgs& a) {
  return a.kind == WIN_EXT_BATCH ? 0 : a.EB;
}

// the keep masks over the sources from keep_lo: mask 0 -> the new A
// buffer (batch: the new E), mask 1 -> the new E buffer (batch: the new
// reset row; timeLength's pass 0: the survivors of the time expiry)
__global__ void src_marks(const __grid_constant__ WindowArgs a0, int pass) {
  const WindowArgs& a = part_args(a0);
  const int32_t s = keep_lo(a) + blockIdx.x * T1 + threadIdx.x;
  if (s >= a.S) return;
  const View v{a};
  uint8_t k0 = 0, k1 = 0;
  const int32_t p = s - a.EB;     // pool row (s >= EB)
  const bool in_pool = s >= a.EB;
  const bool pv = in_pool && v.pool_valid(p);
  switch (a.kind) {
    case WIN_TIME:
      k0 = pv && !(v.expire_row(p, v.pool_ts(p) + a.span_ms) < a.B);
      break;
    case WIN_EXT_TIME:
      k0 = pv && !(v.expire_row(p, v.pool_int(a.ts_idx, p) + a.span_ms) <
                   a.B);
      break;
    case WIN_LENGTH: {
      const int64_t last = a.scal[S_NS0] + a.scal[S_NCUR] - 1;
      k0 = pv && !(v.pool_seq(p) <= last - a.length);
      break;
    }
    case WIN_LENGTH_BATCH: {
      const int64_t b = in_pool ? v.batch_of(p) : -1;
      const int64_t lc = a.scal[S_LAST_COMPLETE];
      k0 = pv && b >= lc;
      k1 = pv && b == lc - 1;
      break;
    }
    case WIN_TIME_BATCH:
      k0 = pv && !a.scal[S_COND];
      k1 = pv;
      break;
    case WIN_TIME_LENGTH: {
      const bool live = pv && !tl_time_expired(a, p);
      if (pass == 0) {
        k1 = live && p < a.W;
        a.keep[a.S + s] = k1;
        return;
      }
      k0 = live && !(tl_k_evict(a, p) < a.scal[S_NCUR]);
      a.keep[s] = k0;
      return;
    }
    case WIN_DELAY:
      k0 = pv && !(p < a.W && v.pool_ts(p) + a.span_ms <= a.scal[S_NOW]);
      break;
    case WIN_BATCH:
      if (s >= a.EB + a.W) {
        const int32_t i = s - a.EB - a.W;
        const BatchRow r = batch_row(a, i);
        k0 = v.cur(i);
        k1 = r.first && (a.length == 0 || r.grp == a.scal[S_LAST_GRP]);
      }
      break;
    case WIN_EXT_BATCH: {
      const bool early = a.scal[S_EARLY];
      if (!in_pool) {
        k1 = a.scal[S_FLUSHED0] && a.e.valid[s];
        break;
      }
      const int64_t w = v.w_of(p);
      const bool cur_emits = pv && v.flush_a(w) < a.scal[S_NCUR];
      k0 = pv && !cur_emits && !early;
      k1 = early ? pv : (cur_emits && w == a.scal[S_MAX_W]);
      break;
    }
    case WIN_CRON:   // the arrivals after the buffer (alone on a flush)
      k0 = pv && (p >= a.W || !a.scal[S_COND]);
      break;
    case WIN_HOPPING:
      if (in_pool) {
        const int64_t ts = v.pool_ts(p);
        const bool send = a.scal[S_COND];
        const int64_t hop_at = a.scal[S_HOP_AT];
        k0 = send ? pv && ts > a.scal[S_NEXT_HOP] - a.span_ms : pv;
        k1 = send && pv && ts > hop_at - a.span_ms && ts <= hop_at;
      }
      break;
    default:
      break;
  }
  a.keep[s] = k0;
  a.keep[a.S + s] = k1;
}

// one block: the source of every kept row of mask m by rank, the total,
// and (timeLength, whose eviction reads it) each kept row's rank
__global__ void __launch_bounds__(SS_BLOCK)
    keep_scan(const __grid_constant__ WindowArgs a0, int m) {
  const WindowArgs& a = part_args(a0);
  __shared__ int64_t buf[SS_BLOCK];
  const int32_t s0 = keep_lo(a);
  const uint8_t* keep = a.keep + (int64_t)m * a.S;
  int32_t* rank_pos = a.rank_pos + (int64_t)m * a.S;
  int32_t* rank_of = a.kind == WIN_TIME_LENGTH
                         ? a.rank_of + (int64_t)m * a.S : nullptr;
  int64_t lo, hi, n = 0, total;
  ss::span(a.S - s0, &lo, &hi);
  lo += s0;
  hi += s0;
  for (int64_t s = lo; s < hi; ++s) n += keep[s];
  int64_t r = ss::block_scan_sum(n, buf, &total) - n;
  for (int64_t s = lo; s < hi; ++s)
    if (keep[s]) {
      if (rank_of) rank_of[s] = (int32_t)r;
      rank_pos[r++] = (int32_t)s;
    }
  if (threadIdx.x == 0) a.scal[S_TOT0 + m] = total;
}

constexpr uint32_t INVALID = 0xffffffffu;

struct Cand {
  int32_t src, kind;
  int64_t ts, key;   // key -1: not emitted
};

__device__ Cand ext_batch_cand(const WindowArgs& a, int32_t c) {
  const View v{a};
  const int64_t* s = a.scal;
  const int32_t EB = a.EB, P = a.P;
  const int64_t ffr = s[S_FIRST_FLUSH_ROW];
  if (c < 2 * EB) {
    const int32_t r = c % EB;
    const bool re = c >= EB;
    Cand k{r, re ? CUR : EXP, s[S_FLUSH_TS], -1};
    if (a.e.valid[r]) {
      if (re && s[S_RECUR_ON]) k.key = ffr * 4 + 2;
      if (!re && a.expired_enabled && s[S_EXP_ON]) k.key = ffr * 4;
    }
    return k;
  }
  const int32_t seg = (c - 2 * EB) / P, p = (c - 2 * EB) % P;
  const bool pv = v.pool_valid(p);
  const bool early = s[S_EARLY];
  const int64_t n_cur = s[S_NCUR];
  const int64_t w = v.w_of(p);
  const int64_t a1 = v.flush_a(w);
  const bool cur_emits = pv && a1 < n_cur;
  const int64_t row1 = v.cur_row(a1);
  const bool gf = a.pflag[p];
  Cand k{EB + p, CUR, 0, -1};
  if (seg == 0) {
    k.ts = v.pool_ts(p);
    if (cur_emits || (pv && early)) k.key = (cur_emits ? row1 : 0) * 4 + 2;
  } else if (seg == 1) {
    k.kind = RST;
    k.ts = early ? s[S_LAST_EXT] : v.ext(row1);
    if ((cur_emits && gf) || (early && gf))
      k.key = ((cur_emits && gf) ? row1 : 0) * 4 + 1;
  } else {
    const int64_t a2 = v.flush_a(v.warr(a1 < 0 ? 0 : (a1 > a.B - 1 ? a.B - 1
                                                                    : a1)));
    const int64_t row2 = v.cur_row(a2);
    k.kind = EXP;
    k.ts = v.ext(row2);
    if (a.expired_enabled && pv && a2 < n_cur) k.key = row2 * 4;
  }
  return k;
}

__global__ void cand_marks(
    const __grid_constant__ WindowArgs a0, uint32_t inv) {
  const WindowArgs& a = part_args(a0);
  const int32_t c = blockIdx.x * T1 + threadIdx.x;
  if (c >= a.N) return;
  const View v{a};
  const int64_t now = a.scal[S_NOW];
  const int32_t B = a.B, P = a.P, EB = a.EB;
  int32_t src = 0, kind = CUR;
  int64_t ts = 0, key = -1;     // key -1: not emitted
  switch (a.kind) {
    case WIN_TIME:
    case WIN_EXT_TIME: {
      if (c < P) {
        const bool ext = a.kind == WIN_EXT_TIME;
        const int64_t due =
            (ext ? v.pool_int(a.ts_idx, c) : v.pool_ts(c)) + a.span_ms;
        const int64_t er = v.expire_row(c, due);
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
    case WIN_TIME_BATCH: {
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
      break;
    }
    case WIN_TIME_LENGTH: {
      if (c < P) {
        const bool te = tl_time_expired(a, c);
        const bool live = v.pool_valid(c) && !te;
        const int64_t k = tl_k_evict(a, c);
        const bool evicted = live && k < a.scal[S_NCUR];
        src = EB + c;
        ts = now;
        kind = EXP;
        if (a.expired_enabled && (te || evicted))
          key = (te ? 0 : v.cur_row(k)) * 4;
      } else {
        const int32_t i = c - P;
        src = EB + a.W + i;
        ts = a.batch.ts[i];
        if (v.cur(i)) key = (int64_t)i * 4 + 2;
      }
      break;
    }
    case WIN_DELAY: {        // released buffered rows, CURRENT at now
      src = EB + c;
      ts = now;
      if (v.pool_valid(c) && c < a.W && v.pool_ts(c) + a.span_ms <= now)
        key = 0;
      break;
    }
    case WIN_BATCH: {
      const bool any = a.scal[S_COND];
      if (c < EB) {            // the carried expired batch
        src = c;
        ts = now;
        kind = EXP;
        if (a.expired_enabled && a.e.valid[c] && any) key = 0;
      } else if (c == EB) {    // the carried reset row
        src = EB;
        ts = a.a.ts[0];
        kind = RST;
        if (a.a.valid[0] && any) key = 1;
      } else {
        const int32_t seg = (c - EB - 1) / B, i = (c - EB - 1) % B;
        src = EB + a.W + i;
        ts = a.batch.ts[i];
        if (seg == 0) {
          if (v.cur(i)) key = (int64_t)i * 4 + 2;
        } else {               // a group's first row: the next's reset
          kind = RST;
          const BatchRow r = batch_row(a, i);
          if (r.first && r.has_next) key = r.next_start * 4 + 1;
        }
      }
      break;
    }
    case WIN_CRON: {         // on a flush: E EXPIRED at now, then A
      const bool flush = a.scal[S_COND];
      if (c < EB) {
        src = c;
        ts = now;
        kind = EXP;
        if (a.expired_enabled && a.e.valid[c] && flush) key = 0;
      } else {
        const int32_t p = c - EB;
        src = EB + p;
        ts = a.a.ts[p];
        if (a.a.valid[p] && flush) key = 1;
      }
      break;
    }
    case WIN_EXT_BATCH: {
      const Cand k = ext_batch_cand(a, c);
      src = k.src;
      kind = k.kind;
      ts = k.ts;
      key = k.key;
      break;
    }
    default: {   // WIN_HOPPING
      const bool send = a.scal[S_COND];
      if (c < EB) {
        src = c;
        ts = now;
        kind = EXP;
        if (a.expired_enabled && a.e.valid[c] && send) key = 0;
      } else {
        const int32_t p = c - EB;
        src = EB + p;
        ts = v.pool_ts(p);
        const int64_t hop_at = a.scal[S_HOP_AT];
        if (send && v.pool_valid(p) && ts > hop_at - a.span_ms &&
            ts <= hop_at)
          key = 2;
      }
    }
  }
  a.keys[c] = key < 0 ? inv : (uint32_t)key;
  a.cand_src[c] = src;
  a.cand_ts[c] = ts;
  a.cand_kind[c] = kind;
}

__global__ void out_gather(
    const __grid_constant__ WindowArgs a0, uint32_t inv) {
  const WindowArgs& a = part_args(a0);
  const int32_t j = blockIdx.x * T1 + threadIdx.x;
  if (j >= a.N) return;
  const int32_t c = a.order[j];
  const int32_t s = a.cand_src[c];
  a.out.ts[j] = a.cand_ts[c];
  a.out_kind[j] = a.cand_kind[c];
  a.out.valid[j] = a.keys[c] != inv;
  for (int k = 0; k < a.n_cols; ++k) {
    copy_col(a, k, s, a.out.cols[k], j, true);
    a.out.nulls[k][j] = src_null(a, k, s);
  }
}

// the newest `cap` rows of mask m into dst (garbage rows: source
// `garbage`, -1 a zero row); where scal[cond] is 0 (cond >= 0), dst takes
// the old buffer's row instead. `emit`: the pool's emitted view.
__global__ void keep_gather(const __grid_constant__ WindowArgs a0, int m,
                            int which, int32_t cap, int cond,
                            int32_t garbage, int emit) {
  const WindowArgs& a = part_args(a0);
  // which 0: the new A from the old, 1: the new E from the old
  const WinBuf& dst = which == 0 ? a.na : a.ne;
  const WinBuf& old = which == 0 ? a.a : a.e;
  const int32_t j = blockIdx.x * T1 + threadIdx.x;
  if (j >= cap) return;
  if (cond >= 0 && !a.scal[cond]) {
    dst.ts[j] = old.ts[j];
    dst.seq[j] = old.seq[j];
    dst.valid[j] = old.valid[j];
    for (int k = 0; k < a.n_cols; ++k) {
      copy_row(dst.cols[k], j, old.cols[k], j, a.col_size[k]);
      dst.nulls[k][j] = old.nulls[k][j];
    }
    return;
  }
  const View v{a};
  // cron (garbage -2): the pool began with an empty buffer on a flush
  if (garbage == -2) garbage = a.scal[S_COND] ? -1 : a.EB;
  const int64_t r = a.scal[S_TOT0 + m] - cap + j;
  const int32_t s = r < 0 ? garbage : a.rank_pos[(int64_t)m * a.S + r];
  dst.ts[j] = s < 0 ? 0 : v.src_ts(s);
  dst.seq[j] = s < 0 ? 0 : v.src_seq(s);
  dst.valid[j] = r >= 0;
  for (int k = 0; k < a.n_cols; ++k) {
    copy_col(a, k, s, dst.cols[k], j, emit);
    dst.nulls[k][j] = src_null(a, k, s);
  }
}

// cron: the new expired batch is the buffer on a flush, else the old
// expired batch, row for row (EB == W)
__global__ void cron_rotate(const __grid_constant__ WindowArgs a0) {
  const WindowArgs& a = part_args(a0);
  const int32_t j = blockIdx.x * T1 + threadIdx.x;
  if (j >= a.EB) return;
  const WinBuf& src = a.scal[S_COND] ? a.a : a.e;
  a.ne.ts[j] = src.ts[j];
  a.ne.seq[j] = src.seq[j];
  a.ne.valid[j] = src.valid[j];
  for (int k = 0; k < a.n_cols; ++k) {
    copy_row(a.ne.cols[k], j, src.cols[k], j, a.col_size[k]);
    a.ne.nulls[k][j] = src.nulls[k][j];
  }
}

__global__ void finish(const __grid_constant__ WindowArgs a0) {
  const WindowArgs& a = part_args(a0);
  if (a.o_overflow == nullptr) return;
  int64_t tot = 0, cap = a.W;
  switch (a.kind) {
    case WIN_TIME: case WIN_EXT_TIME: case WIN_DELAY: case WIN_EXT_BATCH:
    case WIN_HOPPING: case WIN_CRON:
      tot = a.scal[S_TOT0];
      break;
    case WIN_BATCH:
      tot = a.scal[S_TOT0];
      cap = a.EB;
      break;
    case WIN_TIME_BATCH:
      tot = a.scal[S_TOT1];
      break;
    default:
      break;
  }
  const int64_t ovf = tot > cap ? tot - cap : 0;
  *a.o_overflow = *a.overflow + ovf;
}

inline int grid(int64_t n) { return (int)((n + T1 - 1) / T1); }

}  // namespace

extern "C" cudaError_t siddhi_window_step(const WindowArgs* p,
                                          cudaStream_t stream) {
  const WindowArgs& a = *p;
  // one row of blocks (or one block) per partition slot
  const unsigned parts = (unsigned)a.n_part;
  const dim3 one(1, parts);
  auto rows = [&](int64_t n) { return dim3(grid(n), parts); };
  batch_prefix<<<one, SS_BLOCK, 0, stream>>>(a);
  scalars<<<one, 1, 0, stream>>>(a);
  if (a.kind == WIN_EXT_BATCH) ext_batch_prep<<<one, SS_BLOCK, 0, stream>>>(a);
  const bool pooled =
      !(a.kind == WIN_LENGTH && a.length == 0) && a.kind != WIN_EMPTY;
  const int64_t n_src = a.S - keep_lo(a);
  if (a.kind == WIN_TIME_LENGTH) {
    src_marks<<<rows(n_src), T1, 0, stream>>>(a, 0);
    keep_scan<<<one, SS_BLOCK, 0, stream>>>(a, 1);
    src_marks<<<rows(n_src), T1, 0, stream>>>(a, 1);
    keep_scan<<<one, SS_BLOCK, 0, stream>>>(a, 0);
  } else if (pooled) {
    src_marks<<<rows(n_src), T1, 0, stream>>>(a, 0);
    keep_scan<<<one, SS_BLOCK, 0, stream>>>(a, 0);
    if ((a.EB > 0 && a.kind != WIN_CRON) || a.kind == WIN_TIME_BATCH ||
        a.kind == WIN_BATCH)
      keep_scan<<<one, SS_BLOCK, 0, stream>>>(a, 1);
  }
  // keys: emit_row * 4 + phase <= 4 * B - 1, invalid ones above
  const int bits = ss::key_bits(4ull * a.B);
  const uint32_t inv = (uint32_t)((1ull << bits) - 1);
  cand_marks<<<rows(a.N), T1, 0, stream>>>(a, inv);
  cudaError_t err = ss::stable_sort(a.keys, a.N, bits, a.order, a.k1, a.k2,
                                    a.i1, a.i2, a.counts, stream, parts);
  if (err != cudaSuccess) return err;
  out_gather<<<rows(a.N), T1, 0, stream>>>(a, inv);
  const int32_t pool0 = a.EB;   // the garbage row: the pool's first
  switch (a.kind) {
    case WIN_EMPTY:           // no buffer to keep
      break;
    case WIN_LENGTH:
      if (a.length == 0)      // the buffer stays as it was
        keep_gather<<<rows(a.W), T1, 0, stream>>>(a, 0, 0, a.W, S_ZERO,
                                                  pool0, 0);
      else
        keep_gather<<<rows(a.W), T1, 0, stream>>>(a, 0, 0, a.W, -1, pool0,
                                                  0);
      break;
    case WIN_LENGTH_BATCH:
    case WIN_TIME_BATCH:
    case WIN_HOPPING:
      keep_gather<<<rows(a.W), T1, 0, stream>>>(a, 0, 0, a.W, -1, pool0, 0);
      keep_gather<<<rows(a.EB), T1, 0, stream>>>(a, 1, 1, a.EB, S_COND,
                                                 pool0, 0);
      break;
    case WIN_BATCH:           // a pool of an empty buffer and the batch
      keep_gather<<<rows(a.EB), T1, 0, stream>>>(a, 0, 1, a.EB, S_COND, -1,
                                                 0);
      keep_gather<<<rows(a.W), T1, 0, stream>>>(a, 1, 0, a.W, S_COND, -1,
                                                0);
      break;
    case WIN_CRON:            // the new buffer; the rotated expired batch
      keep_gather<<<rows(a.W), T1, 0, stream>>>(a, 0, 0, a.W, -1, -2, 0);
      cron_rotate<<<rows(a.EB), T1, 0, stream>>>(a);
      break;
    case WIN_EXT_BATCH:       // the new exp from E and the emitted pool
      keep_gather<<<rows(a.W), T1, 0, stream>>>(a, 0, 0, a.W, -1, pool0, 0);
      keep_gather<<<rows(a.EB), T1, 0, stream>>>(a, 1, 1, a.EB, S_COND, 0,
                                                 1);
      break;
    default:                  // one buffer: time, externalTime, ...
      keep_gather<<<rows(a.W), T1, 0, stream>>>(a, 0, 0, a.W, -1, pool0, 0);
  }
  finish<<<one, 1, 0, stream>>>(a);
  return cudaGetLastError();
}
