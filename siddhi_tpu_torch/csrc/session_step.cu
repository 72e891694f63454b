// Kernel F: the session window's step (ops/windows2.py session_step).
//
// Replaces the reference's SessionWindowOp.step (siddhi_tpu/ops/
// windows2.py:1168) with its _sorted_by_slot (:1113). The reference's
// pass is data-parallel, and so is this one, stage by stage:
//   1. each row's key hash, the running clock (a block scan of the
//      valid rows' ts) and the slot probe over the K = 64 keys
//      (keyed.cuh's probe_table, K6's: 16 rounds, lost keys counted);
//   2. the rows by slot, stably, the unrouted last (sort_scan.cuh's
//      radix sort, one 8-bit pass over slot or K);
//   3. in that order, one block: the session breaks (a row reaching the
//      previous member's ts + gap; a slot's first row: the carried
//      session's end), the in-slot session ids (a segmented sum), which
//      rows extend the carried session (a running max of each slot's
//      first row), each session's close time (the suffix max of the
//      segment-last ts, over every later row as in the reference, plus
//      gap) and close row (jnp.searchsorted's index on the running
//      clock: the lower bound, exact on the sorted clock), the per-slot
//      max and sum reductions in shared memory (order-free integers),
//      then which rows stay in their slot's final session and their
//      member positions (a second segmented sum);
//   4. the [K, S] buffers: the carried members kept or cleared, the
//      staying rows written in; cell (0, 0) keeps a member only when no
//      row that does not stay comes after it, as the reference's
//      scatter applies its updates in row order;
//   5. the K * S + 2B candidates through the emission sort (a stable
//      radix sort of emit_row * 4 + phase, invalid last) and a gather.
// next_due (the minimum end of the open slots) stays a torch reduction
// over 64 values, read back by the runtime as the reference reads it.
//
// With a slot axis (F[K]: a partition block's or a tenant pool's n_part
// slots, each with its own 64-key table and [64, 128] members) every
// launch reads its struct through part_args, the slot as blockIdx.y: the
// probe and the scan are one block a slot, the other passes a row of
// blocks a slot, and both radix sorts run one segment a slot (the rows'
// sort on its own [n_part, B] keys and scratch). The reference's
// batch-wide quirk (a session's close time is the suffix max over every
// later row) stays within the slot's own rows, as its vmap has it.
//
// Bound: latency at 65,536 rows: stage 3 is one block walking the rows
// in spans with a dozen block scans; the rest are passes over B or
// K * S + 2B rows.
#include "keyed.cuh"
#include "key_sort.cuh"
#include "siddhi_kernels.h"
#include "sort_scan.cuh"

namespace {

constexpr int32_t CUR = 0, EXP = 1;
constexpr int T1 = 256;
constexpr int64_t NEG = -(1ll << 62), POS = 1ll << 62;
constexpr int MAX_K = 64;

// r_flags bits (row order)
constexpr uint8_t F_ROUTED = 1, F_CLOSES = 2, F_JOINS = 4, F_STAYS = 8,
                  F_INCAP = 16, F_BEXP = 32;
// s_f bits (slot order)
constexpr uint8_t S_VALID = 1, S_FIRSTCONT = 2, S_FIRST = 4, S_BREAK = 8;

inline int grid(int64_t n) { return (int)((n + T1 - 1) / T1); }

__device__ __forceinline__ void copy_val(void* dst, int64_t j,
                                         const void* src, int64_t r,
                                         int sz) {
  if (sz == 8)
    ((int64_t*)dst)[j] = ((const int64_t*)src)[r];
  else if (sz == 4)
    ((int32_t*)dst)[j] = ((const int32_t*)src)[r];
  else
    ((uint8_t*)dst)[j] = ((const uint8_t*)src)[r];
}

__device__ __forceinline__ void zero_val(void* dst, int64_t j, int sz) {
  if (sz == 8) ((int64_t*)dst)[j] = 0;
  else if (sz == 4) ((int32_t*)dst)[j] = 0;
  else ((uint8_t*)dst)[j] = 0;
}

__global__ void sess_rows(const __grid_constant__ SessArgs a0) {
  const SessArgs& a = part_args(a0);
  const int64_t i = (int64_t)blockIdx.x * T1 + threadIdx.x;
  if (i >= a.B) return;
  a.cur[i] = a.batch.valid[i] && a.batch_kind[i] == CUR;
  a.hk[i] = a.has_key
      ? kd::mix64(kd::HASH_SEED,
                  kd::key_lane(a.batch.cols[a.key_col], a.key_type,
                               a.batch.nulls[a.key_col], i))
      : 0;
}

// a block scan, exclusive: each thread's carry-in of a per-span value
__device__ __forceinline__ int64_t excl_sum(int64_t v, int64_t* buf) {
  return ss::block_scan_sum(v, buf, nullptr) - v;
}

__device__ __forceinline__ int64_t excl_max(int64_t v, int64_t* buf,
                                            int64_t low) {
  const int64_t incl = ss::block_scan_max(v, buf);
  buf[threadIdx.x] = incl;
  __syncthreads();
  const int64_t r = threadIdx.x > 0 ? buf[threadIdx.x - 1] : low;
  __syncthreads();
  return r > low ? r : low;
}

// the max over the spans of the threads after this one
__device__ __forceinline__ int64_t suffix_max(int64_t v, int64_t* buf,
                                              int64_t* tmp) {
  const int t = threadIdx.x;
  tmp[t] = v;
  __syncthreads();
  const int64_t w = tmp[SS_BLOCK - 1 - t];
  __syncthreads();
  const int64_t incl = ss::block_scan_max(w, buf);
  tmp[t] = incl;
  __syncthreads();
  const int64_t r = t < SS_BLOCK - 1 ? tmp[SS_BLOCK - 2 - t] : INT64_MIN;
  __syncthreads();
  return r;
}

// the block's max, in every thread
__device__ __forceinline__ int64_t block_max(int64_t v, int64_t* buf,
                                             int64_t* top) {
  const int64_t incl = ss::block_scan_max(v, buf);
  if (threadIdx.x == SS_BLOCK - 1) *top = incl;
  __syncthreads();
  const int64_t r = *top;
  __syncthreads();
  return r;
}

// one block: the probe, the running clock, the slot sort's keys
__global__ void __launch_bounds__(SS_BLOCK)
    sess_probe(const __grid_constant__ SessArgs a0) {
  const SessArgs& a = part_args(a0);
  __shared__ int64_t buf[SS_BLOCK];
  const int32_t B = a.B, K = a.K;
  const int64_t lost = kd::probe_table(B, K, a.keys, a.used, a.o_keys,
                                       a.o_used, a.hk, a.cur, a.slots,
                                       a.prb, a.flags, a.claim, buf);
  int64_t lo, hi, m = NEG;
  ss::span(B, &lo, &hi);
  for (int64_t i = lo; i < hi; ++i)
    if (a.batch.valid[i] && a.batch.ts[i] > m) m = a.batch.ts[i];
  int64_t run = excl_max(m, buf, NEG);
  for (int64_t i = lo; i < hi; ++i) {
    if (a.batch.valid[i] && a.batch.ts[i] > run) run = a.batch.ts[i];
    a.rt[i] = run;
    const bool routed = a.cur[i] && a.slots[i] >= 0;
    a.r_flags[i] = routed ? F_ROUTED : 0;
    a.rkey[i] = routed ? (uint32_t)a.slots[i] : (uint32_t)K;
  }
  if (threadIdx.x == 0) a.scal[0] = lost;
}

__device__ __forceinline__ int32_t slot_of(const SessArgs& a, int64_t i) {
  return (a.r_flags[i] & F_ROUTED) ? a.slots[i] : -1;
}

// one block: the sessions, in slot order (j) over the rows (i = order[j])
__global__ void __launch_bounds__(SS_BLOCK)
    sess_scan(const __grid_constant__ SessArgs a0) {
  const SessArgs& a = part_args(a0);
  __shared__ int64_t buf[SS_BLOCK];
  __shared__ int64_t tmp[SS_BLOCK];
  __shared__ long long ext[MAX_K], fin[MAX_K], st_end[MAX_K];
  __shared__ int32_t has_ext[MAX_K], nstay[MAX_K];
  __shared__ int64_t base[MAX_K];
  __shared__ uint8_t sl_closes[MAX_K];
  const int64_t B = a.B, gap = a.gap;
  const int K = a.K, S = a.S;
  const int64_t rt_max = a.rt[B - 1];
  const int32_t* order = a.order;
  for (int k = threadIdx.x; k < K; k += SS_BLOCK) {
    ext[k] = fin[k] = st_end[k] = INT64_MIN;
    has_ext[k] = nstay[k] = 0;
  }
  int64_t lo, hi;
  ss::span(B, &lo, &hi);
  // pass 1: breaks, slot starts and each slot's first row
  int64_t nbrk = 0, mstart = 0, mfirst = -1, ncur = 0;
  for (int64_t j = lo; j < hi; ++j) {
    const int64_t i = order[j];
    const int32_t sl = slot_of(a, i);
    const bool v = sl >= 0;
    const int64_t ts = a.batch.ts[i];
    bool same = false, seg_beg = j == 0;
    int64_t prev_ts = 0;
    if (j > 0) {
      const int64_t ip = order[j - 1];
      const int32_t sp = slot_of(a, ip);
      same = sp == sl && v && sp >= 0;
      seg_beg = sp != sl;
      prev_ts = a.batch.ts[ip];
    }
    const int cs = sl < 0 ? 0 : (sl >= K ? K - 1 : sl);
    const bool bound = v && (same ? ts >= prev_ts + gap
                                  : (!a.open[cs] || ts >= a.end[cs]));
    const bool first = v && !same;
    a.s_f[j] = (v ? S_VALID : 0) | (first && !bound ? S_FIRSTCONT : 0) |
               (first ? S_FIRST : 0) | (bound ? S_BREAK : 0);
    nbrk += first || bound;
    if (seg_beg) mstart = j;
    if (first) mfirst = j;
    ncur += a.cur[i];
  }
  int64_t csum = excl_sum(nbrk, buf);
  int64_t sstart = excl_max(mstart, buf, 0);
  int64_t fidx = excl_max(mfirst, buf, -1);
  int64_t total_cur;
  ss::block_scan_sum(ncur, buf, &total_cur);
  for (int64_t j = lo; j < hi; ++j) {
    const int32_t sl = slot_of(a, order[j]);
    const uint8_t f = a.s_f[j];
    csum += (f & (S_FIRST | S_BREAK)) != 0;
    if (j == 0 || slot_of(a, order[j - 1]) != sl) sstart = j;
    if (f & S_FIRST) fidx = j;
    a.s_a[j] = csum;
    a.s_b[j] = sstart;
    a.s_c[j] = fidx;
  }
  __syncthreads();
  // pass 2: session ids; whether a row extends the carried session
  for (int64_t j = lo; j < hi; ++j) {
    const int64_t ss0 = a.s_b[j];
    const int64_t sid = a.s_a[j] - (ss0 > 0 ? a.s_a[ss0 - 1] : 0) - 1;
    const int64_t fj = a.s_c[j];
    const bool cont = fj >= 0 && (a.s_f[fj] & S_FIRSTCONT);
    const int64_t i = order[j];
    if ((a.s_f[j] & S_VALID) && sid == 0 && cont) a.r_flags[i] |= F_JOINS;
    a.r_pos[i] = sid;   // in row order (pass 4 puts the positions there)
  }
  __syncthreads();
  // pass 3: the close times (suffix max of the segment-last ts)
  int64_t mlast = NEG;
  for (int64_t j = lo; j < hi; ++j) {
    const int64_t i = order[j];
    const int32_t sl = slot_of(a, i);
    if (sl < 0) continue;
    bool last = j == B - 1;
    if (!last) {
      const int64_t in = order[j + 1];
      last = slot_of(a, in) != sl || a.r_pos[in] != a.r_pos[i];
    }
    if (last && a.batch.ts[i] > mlast) mlast = a.batch.ts[i];
  }
  int64_t lrev = suffix_max(mlast, buf, tmp);
  if (lrev < NEG) lrev = NEG;
  for (int64_t j = hi - 1; j >= lo; --j) {
    const int64_t i = order[j];
    const int32_t sl = slot_of(a, i);
    if (sl >= 0) {
      bool last = j == B - 1;
      if (!last) {
        const int64_t in = order[j + 1];
        last = slot_of(a, in) != sl || a.r_pos[in] != a.r_pos[i];
      }
      if (last && a.batch.ts[i] > lrev) lrev = a.batch.ts[i];
    }
    const bool v = sl >= 0;
    const int64_t close_ts = v ? lrev + gap : POS;
    int64_t row = ks::lower_bound(a.rt, B, close_ts);
    if (row > B - 1) row = B - 1;
    a.r_close_ts[i] = close_ts;
    a.r_close_row[i] = (int32_t)row;
    if (v && close_ts <= rt_max) a.r_flags[i] |= F_CLOSES;
    if (v) {
      atomicMax(&fin[sl], (long long)a.r_pos[i]);
      if (a.r_flags[i] & F_JOINS) {
        atomicMax(&ext[sl], (long long)close_ts);
        has_ext[sl] = 1;
      }
    }
  }
  __syncthreads();
  // the carried sessions: extended close or standalone timeout
  for (int k = threadIdx.x; k < K; k += SS_BLOCK) {
    const int64_t ct = has_ext[k] ? (int64_t)ext[k] : a.end[k];
    const bool closes = a.open[k] && ct <= rt_max;
    int64_t row = ks::lower_bound(a.rt, B, ct);
    if (row > B - 1) row = B - 1;
    const bool keep = a.open[k] && !closes;
    sl_closes[k] = closes;
    base[k] = keep ? a.count[k] : 0;
    a.sl_close_row[k] = (int32_t)row;
    a.sl_flags[k] = (closes ? 1 : 0) | (keep ? 2 : 0);
  }
  __syncthreads();
  // pass 4: the rows that stay, ranked within their slot
  int64_t nst = 0;
  for (int64_t j = lo; j < hi; ++j) {
    const int64_t i = order[j];
    const int32_t sl = slot_of(a, i);
    const bool stays = sl >= 0 && !(a.r_flags[i] & F_CLOSES) &&
                       a.r_pos[i] == (int64_t)fin[sl];
    if (stays) a.r_flags[i] |= F_STAYS;
    nst += stays;
  }
  int64_t c2 = excl_sum(nst, buf);
  for (int64_t j = lo; j < hi; ++j) {
    c2 += (a.r_flags[order[j]] & F_STAYS) ? 1 : 0;
    a.s_a[j] = c2;
  }
  __syncthreads();
  int64_t movf = 0, last_other = -1, mine = -1;
  for (int64_t j = lo; j < hi; ++j) {
    const int64_t i = order[j];
    const int32_t sl = slot_of(a, i);
    const uint8_t rf = a.r_flags[i];
    bool in_cap = false;
    if (rf & F_STAYS) {
      const int64_t ss0 = a.s_b[j];
      const int64_t rank = a.s_a[j] - (ss0 > 0 ? a.s_a[ss0 - 1] : 0);
      const int64_t pos = base[sl] + rank - 1;
      in_cap = pos < S;
      movf += !in_cap;
      a.r_pos[i] = pos;
      atomicAdd(&nstay[sl], 1);
      atomicMax(&st_end[sl], (long long)a.r_close_ts[i]);
      if (in_cap && sl == 0 && pos == 0) mine = i;
    }
    uint8_t add = in_cap ? F_INCAP : 0;
    if ((rf & F_CLOSES) && (!(rf & F_JOINS) || sl_closes[sl])) add |= F_BEXP;
    a.r_flags[i] = rf | add;
    if (!in_cap && i > last_other) last_other = i;
  }
  int64_t member_ovf;
  ss::block_scan_sum(movf, buf, &member_ovf);
  last_other = block_max(last_other, buf, &tmp[0]);
  mine = block_max(mine, buf, &tmp[1]);
  if (threadIdx.x == 0) {
    a.scal[2] = member_ovf;
    a.scal[3] = total_cur;
    a.scal[4] = last_other > mine;   // cell (0, 0) reverts
  }
  // the new per-slot state
  for (int k = threadIdx.x; k < K; k += SS_BLOCK) {
    const bool keep = a.sl_flags[k] & 2;
    int64_t cnt = base[k] + nstay[k];
    a.o_count[k] = cnt < S ? cnt : S;
    const int64_t se = (int64_t)st_end[k];
    const int64_t e = se > NEG ? se : (keep ? a.end[k] : POS);
    a.o_end[k] = e;
    a.o_open[k] = (keep || nstay[k] > 0) && e < POS;
  }
  if (threadIdx.x == 0) {
    *a.o_overflow = *a.overflow + a.scal[0] + member_ovf;
    *a.o_next_seq = *a.next_seq + total_cur;
  }
}

// the new members: the carried ones kept or cleared
__global__ void sess_members(const __grid_constant__ SessArgs a0) {
  const SessArgs& a = part_args(a0);
  const int64_t c = (int64_t)blockIdx.x * T1 + threadIdx.x;
  if (c >= (int64_t)a.K * a.S) return;
  const bool keep = a.sl_flags[c / a.S] & 2;
  a.nbuf.ts[c] = keep ? a.buf.ts[c] : 0;
  a.nbuf.valid[c] = keep && a.buf.valid[c];
  for (int k = 0; k < a.n_cols; ++k) {
    if (keep)
      copy_val(a.nbuf.cols[k], c, a.buf.cols[k], c, a.col_size[k]);
    else
      zero_val(a.nbuf.cols[k], c, a.col_size[k]);
    a.nbuf.nulls[k][c] = keep && a.buf.nulls[k][c];
  }
}

// the staying rows written in (cell (0, 0): unless it reverts)
__global__ void sess_scatter(const __grid_constant__ SessArgs a0) {
  const SessArgs& a = part_args(a0);
  const int64_t i = (int64_t)blockIdx.x * T1 + threadIdx.x;
  if (i >= a.B || !(a.r_flags[i] & F_INCAP)) return;
  const int64_t c = (int64_t)a.slots[i] * a.S + a.r_pos[i];
  if (c == 0 && a.scal[4]) return;
  a.nbuf.ts[c] = a.batch.ts[i];
  a.nbuf.valid[c] = true;
  for (int k = 0; k < a.n_cols; ++k) {
    copy_val(a.nbuf.cols[k], c, a.batch.cols[k], i, a.col_size[k]);
    a.nbuf.nulls[k][c] = a.batch.nulls[k][i];
  }
}

// a candidate: the carried members [K * S], the batch as EXPIRED [B]
// and as CURRENT [B]; -> valid, and its emission key
__device__ __forceinline__ bool cand(const SessArgs& a, int64_t c,
                                     uint32_t* key) {
  const int64_t KS = (int64_t)a.K * a.S, B = a.B;
  int64_t row;
  bool v;
  uint32_t phase = 0;
  if (c < KS) {
    const int k = (int)(c / a.S);
    v = a.expired_enabled && a.buf.valid[c] && (a.sl_flags[k] & 1);
    row = a.sl_close_row[k];
  } else if (c < KS + B) {
    const int64_t i = c - KS;
    v = a.expired_enabled && (a.r_flags[i] & F_BEXP);
    row = a.r_close_row[i];
  } else {
    const int64_t i = c - KS - B;
    v = a.r_flags[i] & F_ROUTED;
    row = i;
    phase = 2;
  }
  *key = v ? (uint32_t)(row * 4 + phase) : (uint32_t)(4 * B);
  return v;
}

__global__ void sess_keys(const __grid_constant__ SessArgs a0) {
  const SessArgs& a = part_args(a0);
  const int64_t c = (int64_t)blockIdx.x * T1 + threadIdx.x;
  if (c >= a.M) return;
  uint32_t key;
  cand(a, c, &key);
  a.ekey[c] = key;
}

__global__ void sess_gather(const __grid_constant__ SessArgs a0) {
  const SessArgs& a = part_args(a0);
  const int64_t j = (int64_t)blockIdx.x * T1 + threadIdx.x;
  if (j >= a.M) return;
  const int64_t c = a.eorder[j];
  const int64_t KS = (int64_t)a.K * a.S, B = a.B;
  uint32_t key;
  a.out.valid[j] = cand(a, c, &key);
  if (c < KS) {
    a.out.ts[j] = a.buf.ts[c];
    a.out_kind[j] = EXP;
    for (int k = 0; k < a.n_cols; ++k) {
      copy_val(a.out.cols[k], j, a.buf.cols[k], c, a.col_size[k]);
      a.out.nulls[k][j] = a.buf.nulls[k][c];
    }
    return;
  }
  const int64_t i = c < KS + B ? c - KS : c - KS - B;
  a.out.ts[j] = a.batch.ts[i];
  a.out_kind[j] = c < KS + B ? EXP : CUR;
  for (int k = 0; k < a.n_cols; ++k) {
    copy_val(a.out.cols[k], j, a.batch.cols[k], i, a.col_size[k]);
    a.out.nulls[k][j] = a.batch.nulls[k][i];
  }
}

}  // namespace

extern "C" cudaError_t siddhi_session_window(const SessArgs* p,
                                             cudaStream_t stream) {
  const SessArgs& a = *p;
  if (a.K > MAX_K) return cudaErrorInvalidValue;
  // one block, or one row of blocks, a slot
  const unsigned parts = (unsigned)a.n_part;
  const dim3 one(1, parts);
  auto rows = [&](int64_t n) { return dim3(grid(n), parts); };
  sess_rows<<<rows(a.B), T1, 0, stream>>>(a);
  sess_probe<<<one, SS_BLOCK, 0, stream>>>(a);
  cudaError_t err = ss::stable_sort(a.rkey, a.B, ss::key_bits(a.K),
                                    a.order, a.rk1, a.rk2, a.ri1, a.ri2,
                                    a.rcounts, stream, parts);
  if (err != cudaSuccess) return err;
  sess_scan<<<one, SS_BLOCK, 0, stream>>>(a);
  sess_members<<<rows((int64_t)a.K * a.S), T1, 0, stream>>>(a);
  sess_scatter<<<rows(a.B), T1, 0, stream>>>(a);
  sess_keys<<<rows(a.M), T1, 0, stream>>>(a);
  err = ss::stable_sort(a.ekey, a.M, ss::key_bits(4ull * a.B), a.eorder,
                        a.k1, a.k2, a.i1, a.i2, a.counts, stream, parts);
  if (err != cudaSuccess) return err;
  sess_gather<<<rows(a.M), T1, 0, stream>>>(a);
  return cudaGetLastError();
}
