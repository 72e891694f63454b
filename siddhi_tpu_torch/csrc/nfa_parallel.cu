// Kernel K3: one sub-step of the round-parallel NFA over a sub-batch of
// at most PB = 4,096 events, as three launches on the caller's stream.
//
// Replaces the reference's jitted ParallelNfaEngine.make_stream_step
// (siddhi_tpu/ops/nfa_parallel.py:626, one `sub_step` :633-715): the
// pending table (population 1, M rows) and the spawns of the always-
// armed start state (population 2, one candidate row per event) advance
// through the states that consume the stream, matches are emitted in
// (emit_at, seq) order, and the surviving spawns are folded into free
// table rows.
//
// The reference builds a [rows x events] grid per state and takes an
// argmax per row. Here no grid exists:
//  (a) spawn launch, one block: one thread per event (four at most)
//      evaluates the start state's condition under the "virtual" env
//      (own slot = the event, every other slot null), ranks the hits
//      with a block prefix sum and writes population 2 (_spawn_pop
//      :433-521); it also reduces the sub-batch's time span for the
//      `within` prune;
//  (b) advance launch: one warp per row of both populations walks the
//      consuming states in chain order (_advance_rounds :251). At each
//      state the warp scans event tiles of 32 from the row's last event
//      on; each lane tests one event (eligible, then the condition
//      through the interpreter) and __ballot_sync + __ffs give the first
//      match, so a row stops at its first match (_state_round :287).
//      Counting states absorb matches in order up to their room
//      (_counting_round :353). Then the `within` prune (:681-693);
//  (c) emit-and-fold launch, one block: the emitting rows are compacted
//      with a prefix sum and bitonic-sorted by (emit_at, seq) in shared
//      memory (the keys are unique, so this is the reference's lexsort
//      order, _collect_emissions :523), their match columns scattered
//      from out_n on; then the free table rows (ascending, the order of
//      a stable argsort(~free)) take the surviving spawns in order
//      (_fold_spawns :577), and the counters move.
// Nothing is synchronised with the host: out_n, next_seq, counter and
// overflow stay in device memory and each launch reads them there.
//
// Bound: on the main path the work is data-dependent and small (a live
// row scans until its first match); the bytes are the sub-batch's
// columns, the live rows and the match columns written. A full table of
// rows that match nothing makes every warp scan every event: then the
// interpreter's operations bound it.
#include "expr_interp.cuh"

namespace {

using namespace siddhi;

constexpr int kThreads = 1024;  // the one-block launches
constexpr int kBig = 1 << 30;   // "no minimum crossing" (nfa_parallel BIG)
constexpr long long kPosInf = 1ll << 62;
constexpr unsigned kFull = 0xffffffffu;

static_assert(sizeof(NfaParams) <= 4096, "kernel arguments over 4 KB");

__device__ __forceinline__ long long iabs(long long x) {
  return x < 0 ? -x : x;
}

// exclusive prefix sum of one int per thread over the block (1024
// threads); -> (prefix, total). Uses s[0..32].
__device__ __forceinline__ int block_scan(int v, int* s, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) s[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = s[lane];
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, w, d);
      if (lane >= d) w += y;
    }
    s[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  const int before = warp > 0 ? s[warp - 1] : 0;
  *total = s[31];
  __syncthreads();  // s is reused by the next scan
  return before + x - v;
}

__device__ __forceinline__ void* slot_col(const NfaParams& p, bool p1,
                                          int x) {
  return p1 ? p.tab_cols[x] : p.p2_cols[x];
}
__device__ __forceinline__ bool* slot_null(const NfaParams& p, bool p1,
                                           int x) {
  return p1 ? p.tab_nulls[x] : p.p2_nulls[x];
}
__device__ __forceinline__ int64_t* slot_ts(const NfaParams& p, bool p1,
                                            int j) {
  return p1 ? p.tab_ts[j] : p.p2_ts[j];
}

// a load descriptor's parts
struct LoadRef {
  int kind, j, a, ck;
};
__device__ __forceinline__ LoadRef decode(int d) {
  return {d & 1, (d >> 1) & 0x7f, (d >> 8) & 0xff, d >> 16};
}

__device__ __forceinline__ void load_event(const NfaParams& p, int a,
                                           int type, int e, Slot* s) {
  s->v = load_col(p.ev_cols[a], type, e);
  s->null = p.ev_nulls[a][e];
}

// ---- (a) spawn ------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
    nfa_spawn_kernel(const NfaParams p) {
  __shared__ int s_scan[33];
  __shared__ long long s_lo[32], s_hi[32];
  __shared__ int s_any[32];
  const int B = p.B, t = threadIdx.x;
  const int per = (B + kThreads - 1) / kThreads;  // at most 4
  const int b0 = t * per;
  const NfaStateDesc& st = p.start;
  long long lo = kPosInf, hi = -kPosInf;
  int any = 0, hits = 0;
  unsigned hit_bits = 0;
  for (int k = 0; k < per; ++k) {
    const int b = b0 + k;
    if (b >= B || !p.ev_valid[b]) continue;
    const long long ts = p.ev_ts[b];
    lo = min(lo, ts);
    hi = max(hi, ts);
    any = 1;
    if (!p.has_start || p.ev_kind[b] != 0) continue;
    bool ok = true;
    if (st.prog_len > 0) {
      ok = interp(
          st.prog_len, [&](int pc) { return p.code[st.prog_start + pc]; },
          [&](int i) { return p.consts[i]; },
          [&](int arg, int type, Slot* s) {
            const LoadRef r = decode(p.loads[arg]);
            if (r.j == st.slot && r.ck == 0) {
              load_event(p, r.a, type, b, s);
            } else {  // every other slot of the virtual row is null
              s->v = 0;
              s->null = true;
            }
          },
          [](int, int, const Slot&) {});
    }
    if (ok) {
      hit_bits |= 1u << k;
      ++hits;
    }
  }
  // the sub-batch's time span (the `within` prune reads it)
  for (int d = 16; d > 0; d >>= 1) {
    lo = min(lo, __shfl_xor_sync(kFull, lo, d));
    hi = max(hi, __shfl_xor_sync(kFull, hi, d));
    any |= __shfl_xor_sync(kFull, any, d);
  }
  const int lane = t & 31, warp = t >> 5;
  if (lane == 0) {
    s_lo[warp] = lo;
    s_hi[warp] = hi;
    s_any[warp] = any;
  }
  int n_hits;
  const int rank0 = block_scan(hits, s_scan, &n_hits);  // syncs
  if (t == 0) {
    for (int w = 1; w < 32; ++w) {
      lo = min(lo, s_lo[w]);
      hi = max(hi, s_hi[w]);
      any |= s_any[w];
    }
  }
  const bool emit_only = !st.is_counting && st.next_idx == -1;
  const long long n_spawned = (p.has_start && !emit_only) ? n_hits : 0;
  if (t == 0) {
    p.span[0] = lo;
    p.span[1] = hi;
    p.span[2] = any;
    p.span[3] = n_spawned;
    if (p.first_sub) *p.out_n = 0;
  }
  if (!p.has_start) return;

  const long long next_seq = *p.next_seq;
  const bool min_now = st.min_count <= 1;
  const bool maxed_now = st.max_count != -1 && 1 >= st.max_count;
  int rank = rank0;
  for (int k = 0; k < per; ++k) {
    const int b = b0 + k;
    if (b >= B) break;
    const bool hit = (hit_bits >> k) & 1;
    int as_state, emit_at, minrel;
    bool alive;
    if (st.is_counting) {
      if (st.next_idx == -1) {
        as_state = st.idx;
        emit_at = (hit && min_now) ? b : -1;
        alive = maxed_now ? false : hit;
      } else {
        as_state = maxed_now ? st.next_idx : st.idx;
        emit_at = -1;
        alive = hit;
      }
      minrel = (hit && min_now) ? b : kBig;
    } else if (st.next_idx == -1) {  // single-state: every hit emits
      as_state = st.idx;
      emit_at = hit ? b : -1;
      alive = false;
      minrel = kBig;
    } else {
      as_state = st.next_idx;
      emit_at = -1;
      alive = hit;
      minrel = kBig;
    }
    p.p2_state[b] = hit ? as_state : p.n_states;
    p.p2_valid[b] = alive;
    p.p2_last[b] = hit ? b : -1;
    p.p2_born_rel[b] = hit ? b : 0;
    p.p2_ts0[b] = hit ? p.ev_ts[b] : 0;
    p.p2_has_ts0[b] = hit;
    p.p2_minrel[b] = minrel;
    // emit-only rows take seqs after the spawns (they sort after real
    // spawns at the same event)
    p.p2_seq[b] = (hit && !emit_only) ? next_seq + rank
                                      : next_seq + n_spawned + b;
    p.emit_at[p.M + b] = emit_at;
    p.emit_n[p.M + b] = emit_at >= 0 ? 1 : 0;
    if (hit) {
      // the row's slots: empty, but its own slot holds its event at copy 0
      for (int j = 0; j < p.n_slots; ++j) {
        const int cap = p.slot_cap[j];
        const bool own = j == st.slot;
        for (int c = 0; c < cap; ++c) {
          const long long at = (long long)b * cap + c;
          const bool ev = own && c == 0;
          for (int a = 0; a < p.slot_ncols[j]; ++a) {
            const int x = p.slot_col0[j] + a;
            const int type = p.col_type[x];
            store_col(p.p2_cols[x], type, at,
                      ev ? load_col(p.ev_cols[a], type, b) : 0);
            p.p2_nulls[x][at] = ev ? p.ev_nulls[a][b] : true;
          }
          p.p2_ts[j][at] = ev ? p.ev_ts[b] : 0;
        }
        p.p2_n[j][b] = own ? 1 : 0;
      }
      ++rank;
    }
  }
}

// ---- (b) advance ------------------------------------------------------------

struct Row {
  bool p1;        // population 1 (the table) or 2 (the spawns)
  int r;          // row in its population
  int state, last, minrel, emit_at, emit_n;
  bool valid, has_ts0, min_prev;
  long long ts0;
  int n[SIDDHI_NFA_MAX_SLOTS];
};

// eligible: a valid CURRENT event after the row's last one, within
// `within` of the row's first event
__device__ __forceinline__ bool eligible(const NfaParams& p, const Row& w,
                                         int e) {
  if (e <= w.last || e >= p.B || !p.ev_valid[e] || p.ev_kind[e] != 0) {
    return false;
  }
  return p.within_ms < 0 || !w.has_ts0 ||
         iabs(p.ev_ts[e] - w.ts0) <= p.within_ms;
}

// the state's condition for row w against event e (_env_grid :147-178:
// in the own slot, position n is the event, and so is slot_last k = 0)
__device__ __forceinline__ bool cond(const NfaParams& p,
                                     const NfaStateDesc& st, const Row& w,
                                     int e) {
  if (st.prog_len == 0) return true;
  return interp(
      st.prog_len, [&](int pc) { return p.code[st.prog_start + pc]; },
      [&](int i) { return p.consts[i]; },
      [&](int arg, int type, Slot* s) {
        const LoadRef r = decode(p.loads[arg]);
        const bool own = r.j == st.slot;
        const int cap = p.slot_cap[r.j];
        int pos;
        if (r.kind == 0) {
          if (own && w.n[r.j] == r.ck) {
            load_event(p, r.a, type, e, s);
            return;
          }
          pos = r.ck;
        } else {
          if (own && r.ck == 0) {
            load_event(p, r.a, type, e, s);
            return;
          }
          pos = w.n[r.j] + (own ? 1 : 0) - 1 - r.ck;
          pos = pos < 0 ? 0 : (pos > cap - 1 ? cap - 1 : pos);
        }
        const int x = p.slot_col0[r.j] + r.a;
        const long long at = (long long)w.r * cap + pos;
        s->v = load_col(slot_col(p, w.p1, x), type, at);
        s->null = slot_null(p, w.p1, x)[at];
      },
      [](int, int, const Slot&) {});
}

// event e into slot j's copy c of row w
__device__ __forceinline__ void capture(const NfaParams& p, const Row& w,
                                        int j, int c, int e) {
  const long long at = (long long)w.r * p.slot_cap[j] + c;
  for (int a = 0; a < p.slot_ncols[j]; ++a) {
    const int x = p.slot_col0[j] + a;
    const int type = p.col_type[x];
    store_col(slot_col(p, w.p1, x), type, at, load_col(p.ev_cols[a], type, e));
    slot_null(p, w.p1, x)[at] = p.ev_nulls[a][e];
  }
  slot_ts(p, w.p1, j)[at] = p.ev_ts[e];
}

// the first event from the row's last one on that is eligible (and, with
// `test`, meets the condition); -1 when none (_first_true)
__device__ __forceinline__ int first_event(const NfaParams& p,
                                           const NfaStateDesc& st,
                                           const Row& w, bool test) {
  const int lane = threadIdx.x & 31;
  for (int base = w.last + 1; base < p.B; base += 32) {
    const int e = base + lane;
    bool ok = eligible(p, w, e);
    if (ok && test) ok = cond(p, st, w, e);
    const unsigned m = __ballot_sync(kFull, ok);
    if (m) return base + __ffs(m) - 1;
  }
  return -1;
}

// a plain (non-counting) state (_state_round :287-351)
__device__ __forceinline__ void state_round(const NfaParams& p,
                                            const NfaStateDesc& st, Row& w,
                                            bool normal) {
  const int lane = threadIdx.x & 31;
  int j = -1;
  bool adv = false, kill = false;
  if (p.seqmode && normal) {
    // sequence: the first eligible event decides, advance or die
    const int j0 = first_event(p, st, w, false);
    if (j0 >= 0) {
      const bool ok = __shfl_sync(kFull, lane == 0 ? cond(p, st, w, j0)
                                                   : false, 0);
      adv = ok;
      kill = !ok;
      j = j0;
    }
  } else {
    j = first_event(p, st, w, true);
    adv = j >= 0;
  }
  if (adv) {
    if (lane == 0) capture(p, w, st.slot, 0, j);
    __syncwarp();
    w.n[st.slot] = 1;
    if (!w.has_ts0) {
      w.ts0 = p.ev_ts[j];
      w.has_ts0 = true;
    }
    w.last = j;
    if (st.next_idx == -1) {
      w.emit_at = j;
      w.emit_n = 1;
      w.valid = false;
    } else {
      w.state = st.next_idx;
    }
  }
  if (kill) w.valid = false;
}

// a counting state: absorb the matching events in order, up to the room
// left (_counting_round :353-431)
__device__ __forceinline__ void counting_round(const NfaParams& p,
                                               const NfaStateDesc& st,
                                               Row& w, bool persona) {
  const int lane = threadIdx.x & 31;
  const int j = st.slot;
  const int n0 = persona ? 0 : w.n[j];  // personas restart
  const int room = max(st.cap_limit - n0, 0);
  const int min_rank = st.min_count - n0;
  int k = 0, j_first = -1, j_last = -1, j_min = -1;
  for (int base = w.last + 1; base < p.B && k < room; base += 32) {
    const int e = base + lane;
    const bool ok = eligible(p, w, e) && cond(p, st, w, e);
    const unsigned m = __ballot_sync(kFull, ok);
    if (!m) continue;
    const int rank = k + __popc(m & ((1u << lane) - 1)) + 1;  // 1-based
    const int taken = min(__popc(m), room - k);
    const bool took = ok && rank <= room;
    if (took) capture(p, w, j, n0 + rank - 1, e);
    const unsigned at_first = __ballot_sync(kFull, took && rank == 1);
    const unsigned at_last = __ballot_sync(kFull, took && rank == k + taken);
    const unsigned at_min = __ballot_sync(kFull, took && rank == min_rank);
    if (at_first) j_first = base + __ffs(at_first) - 1;
    if (at_last) j_last = base + __ffs(at_last) - 1;
    if (at_min) j_min = base + __ffs(at_min) - 1;
    k += taken;
  }
  __syncwarp();
  const int new_n = n0 + k;
  w.n[j] = new_n;
  const bool absorbed = k > 0;
  if (!absorbed) return;
  if (!w.has_ts0) {
    w.ts0 = p.ev_ts[j_first];
    w.has_ts0 = true;
  }
  w.last = j_last;
  w.state = st.idx;
  const bool crossed = n0 < st.min_count && new_n >= st.min_count;
  if (crossed) w.minrel = j_min;
  const bool maxed = st.max_count != -1 && new_n >= st.max_count;
  if (st.next_idx == -1) {
    if (crossed) {
      w.emit_at = j_min;
      w.emit_n = st.min_count;
    }
    if (maxed) w.valid = false;
  } else if (maxed) {
    w.state = st.next_idx;
  }
}

__global__ void nfa_advance_kernel(const NfaParams p) {
  if (p.first_sub) {  // a clear match batch for the step
    const long long cells = (long long)p.OUT * (p.n_match_cols + 1);
    for (long long i = blockIdx.x * blockDim.x + threadIdx.x; i < cells;
         i += (long long)gridDim.x * blockDim.x) {
      const int c = (int)(i / p.OUT);
      const long long r = i % p.OUT;
      if (c == p.n_match_cols) {
        p.out_ts[r] = 0;
      } else {
        store_col(p.out_cols[c], p.out_type[c], r, 0);
        p.out_nulls[c][r] = true;
      }
    }
  }
  const int lane = threadIdx.x & 31;
  const int gw = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int R = p.M + (p.has_start ? p.B : 0);
  if (gw >= R) return;
  Row w;
  w.p1 = gw < p.M;
  w.r = w.p1 ? gw : gw - p.M;
  if (w.p1) {
    w.valid = p.valid[w.r];
    w.emit_at = -1;
    w.emit_n = 0;
    w.minrel = kBig;
    w.last = -1;
  } else {
    w.valid = p.p2_valid[w.r];
    w.emit_at = p.emit_at[gw];
    w.emit_n = p.emit_n[gw];
    w.minrel = p.p2_minrel[w.r];
    w.last = p.p2_last[w.r];
  }
  if (w.valid) {
    w.state = w.p1 ? p.state[w.r] : p.p2_state[w.r];
    w.ts0 = w.p1 ? p.ts0[w.r] : p.p2_ts0[w.r];
    w.has_ts0 = w.p1 ? p.has_ts0[w.r] : p.p2_has_ts0[w.r];
    // min<0:n> counting states reach their minimum at birth
    w.min_prev = w.p1 && (p.min_at[w.r] >= 0 ||
                          ((p.min0_mask >> w.state) & 1u));
    for (int j = 0; j < p.n_slots; ++j) {
      w.n[j] = w.p1 ? p.tab_n[j][w.r] : p.p2_n[j][w.r];
    }
    if (w.p1 || p.advance_pop2) {
      for (int i = 0; i < p.n_consuming; ++i) {
        const NfaStateDesc& st = p.states[i];
        const bool normal = w.valid && w.state == st.idx;
        bool persona = false;
        for (int q = 0; q < st.n_personas; ++q) {
          persona = persona ||
                    (w.valid && w.state == st.persona_idx[q] &&
                     w.n[st.persona_slot[q]] >= st.persona_min[q] &&
                     w.min_prev);
        }
        if (!normal && !persona) continue;
        if (st.is_counting) {
          counting_round(p, st, w, persona);
        } else {
          state_round(p, st, w, normal);
        }
      }
    }
    // the `within` prune at the sub-batch's end (time only moves on)
    if (p.within_ms >= 0 && w.valid && w.has_ts0 && p.span[2]) {
      const long long dist =
          max(iabs(p.span[1] - w.ts0), iabs(p.span[0] - w.ts0));
      if (dist > p.within_ms) w.valid = false;
    }
    if (lane == 0) {
      if (w.p1) {
        p.state[w.r] = w.state;
        p.valid[w.r] = w.valid;
        p.ts0[w.r] = w.ts0;
        p.has_ts0[w.r] = w.has_ts0;
        if (w.minrel < kBig) {
          p.min_at[w.r] = *p.counter + p.sub_off + w.minrel;
        }
      } else {
        p.p2_state[w.r] = w.state;
        p.p2_valid[w.r] = w.valid;
        p.p2_ts0[w.r] = w.ts0;
        p.p2_has_ts0[w.r] = w.has_ts0;
        p.p2_minrel[w.r] = w.minrel;
      }
      for (int j = 0; j < p.n_slots; ++j) {
        if (w.p1) {
          p.tab_n[j][w.r] = w.n[j];
        } else {
          p.p2_n[j][w.r] = w.n[j];
        }
      }
    }
  }
  if (lane == 0) {
    p.emit_at[gw] = w.emit_at;
    p.emit_n[gw] = w.emit_n;
  }
}

// ---- (c) emit and fold ------------------------------------------------------

// emission keys in shared memory: hi = emit_at << 14 | row, lo = seq
__device__ __forceinline__ bool key_greater(const int* hi, const long long* lo,
                                            int x, int y) {
  const int ex = hi[x] >> 14, ey = hi[y] >> 14;
  return ex != ey ? ex > ey : lo[x] > lo[y];
}

__global__ void __launch_bounds__(kThreads)
    nfa_emit_fold_kernel(const NfaParams p, int sort_n) {
  extern __shared__ long long smem[];
  long long* s_lo = smem;                   // [sort_n]
  int* s_hi = (int*)(smem + sort_n);        // [sort_n]
  __shared__ int s_scan[33];
  __shared__ long long s_base;
  const int t = threadIdx.x;
  const int M = p.M, B = p.B;
  const int R = M + (p.has_start ? B : 0);

  // 1. compact the emitting rows of both populations
  const int per = (R + kThreads - 1) / kThreads;
  const int r0 = t * per;
  int mine = 0;
  for (int r = r0; r < min(r0 + per, R); ++r) mine += p.emit_at[r] >= 0;
  int n_emit;
  int pos = block_scan(mine, s_scan, &n_emit);
  for (int r = r0; r < min(r0 + per, R); ++r) {
    const int at = p.emit_at[r];
    if (at < 0) continue;
    s_hi[pos] = (at << 14) | r;
    s_lo[pos] = r < M ? p.seq[r] : p.p2_seq[r - M];
    ++pos;
  }
  int width = 1;
  while (width < n_emit) width <<= 1;
  for (int i = n_emit + t; i < width; i += kThreads) {
    s_hi[i] = 0x7fffffff;
    s_lo[i] = 0x7fffffffffffffffll;
  }
  if (t == 0) s_base = *p.out_n;
  __syncthreads();

  // 2. bitonic sort by (emit_at, seq), ascending
  for (int k = 2; k <= width; k <<= 1) {
    for (int h = k >> 1; h > 0; h >>= 1) {
      for (int i = t; i < width; i += kThreads) {
        const int o = i ^ h;
        if (o > i && ((i & k) == 0) == key_greater(s_hi, s_lo, i, o)) {
          const int th = s_hi[i];
          s_hi[i] = s_hi[o];
          s_hi[o] = th;
          const long long tl = s_lo[i];
          s_lo[i] = s_lo[o];
          s_lo[o] = tl;
        }
      }
      __syncthreads();
    }
  }

  // 3. scatter the match columns from out_n on
  const long long base = s_base;
  const long long room = p.OUT - base;
  const long long written = n_emit < room ? n_emit : (room > 0 ? room : 0);
  for (int i = t; i < written; i += kThreads) {
    const int row = s_hi[i] & 0x3fff;
    const bool p1 = row < M;
    const int r = p1 ? row : row - M;
    const long long dest = base + i;
    const int en = p.emit_n[row];
    int ci = 0;
    for (int j = 0; j < p.n_slots; ++j) {
      const int cap = p.slot_cap[j];
      for (int a = 0; a < p.slot_ncols[j]; ++a) {
        const int x = p.slot_col0[j] + a;
        const int type = p.col_type[x];
        for (int c = 0; c < cap; ++c, ++ci) {
          const long long at = (long long)r * cap + c;
          store_col(p.out_cols[ci], type, dest,
                    load_col(slot_col(p, p1, x), type, at));
          // a final counting slot: the copies at and past emit_n are null
          p.out_nulls[ci][dest] = slot_null(p, p1, x)[at] ||
                                  (p.slot_final_counting[j] && c >= en);
        }
      }
    }
    int e = s_hi[i] >> 14;
    e = e > B - 1 ? B - 1 : e;
    p.out_ts[dest] = p.ev_ts[e];
  }
  __syncthreads();  // every read of the table's rows is done

  // 4. fold the surviving spawns into the free table rows
  long long lost = n_emit - written;
  if (p.has_start) {
    int* free_rows = s_hi;  // [M], reused
    const int fper = (M + kThreads - 1) / kThreads;
    const int f0 = t * fper;
    int nf = 0;
    for (int r = f0; r < min(f0 + fper, M); ++r) nf += !p.valid[r];
    int n_free;
    int fpos = block_scan(nf, s_scan, &n_free);
    for (int r = f0; r < min(f0 + fper, M); ++r) {
      if (!p.valid[r]) free_rows[fpos++] = r;
    }
    __syncthreads();
    const int bper = (B + kThreads - 1) / kThreads;
    const int b0 = t * bper;
    int ns = 0;
    for (int b = b0; b < min(b0 + bper, B); ++b) ns += p.p2_valid[b];
    int n_surv;
    int rank = block_scan(ns, s_scan, &n_surv);
    const long long counter = *p.counter;
    for (int b = b0; b < min(b0 + bper, B); ++b) {
      if (!p.p2_valid[b]) continue;
      if (rank < n_free) {
        const int d = free_rows[rank];
        p.state[d] = p.p2_state[b];
        p.valid[d] = true;
        p.born[d] = counter + p.sub_off + p.p2_born_rel[b];
        p.seq[d] = p.p2_seq[b];
        p.ts0[d] = p.p2_ts0[b];
        p.has_ts0[d] = p.p2_has_ts0[b];
        const int mr = p.p2_minrel[b];
        p.min_at[d] = mr < kBig ? counter + p.sub_off + mr : -1;
        p.deadline[d] = kPosInf;
        for (int j = 0; j < p.n_slots; ++j) {
          const int cap = p.slot_cap[j];
          for (int c = 0; c < cap; ++c) {
            const long long from = (long long)b * cap + c;
            const long long to = (long long)d * cap + c;
            for (int a = 0; a < p.slot_ncols[j]; ++a) {
              const int x = p.slot_col0[j] + a;
              const int type = p.col_type[x];
              store_col(p.tab_cols[x], type, to,
                        load_col(p.p2_cols[x], type, from));
              p.tab_nulls[x][to] = p.p2_nulls[x][from];
            }
            p.tab_ts[j][to] = p.p2_ts[j][from];
          }
          p.tab_n[j][d] = p.p2_n[j][b];
        }
      }
      ++rank;
    }
    if (t == 0) lost += n_surv > n_free ? n_surv - n_free : 0;
  }
  __syncthreads();
  if (t == 0) {
    *p.out_n = base + written;
    *p.next_seq += p.span[3];
    *p.counter += B;
    *p.overflow += lost;
  }
  if (p.last_sub) {  // the step's match batch: rows below out_n are valid
    const long long n = base + written;
    for (int i = t; i < p.OUT; i += kThreads) {
      p.out_valid[i] = i < n;
      p.out_kind[i] = 0;
    }
  }
}

}  // namespace

extern "C" cudaError_t siddhi_nfa_parallel_step(const NfaParams* p,
                                                cudaStream_t stream) {
  const int R = p->M + (p->has_start ? p->B : 0);
  int sort_n = 1;
  while (sort_n < R) sort_n <<= 1;
  const size_t smem = (size_t)sort_n * (sizeof(long long) + sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(
      nfa_emit_fold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  nfa_spawn_kernel<<<1, kThreads, 0, stream>>>(*p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int warps_per_block = 8;
  nfa_advance_kernel<<<(R + warps_per_block - 1) / warps_per_block,
                       32 * warps_per_block, 0, stream>>>(*p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  nfa_emit_fold_kernel<<<1, kThreads, smem, stream>>>(*p, sort_n);
  return cudaGetLastError();
}
