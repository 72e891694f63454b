// Kernel K4: one step of the scan NFA engine, as ONE launch of one block.
//
// Replaces the reference's jitted NfaEngine.make_stream_step
// (siddhi_tpu/ops/nfa.py:638, a lax.scan of event_body :654 over the
// chunk's events) and make_timer_step (:1319, one _advance_time :1087),
// with next_due (:1344) in the epilogue. The plain PyTorch version is
// NfaEngine.stream_step_ref / timer_step_ref (ops/nfa.py), which follows
// the reference function by function; this kernel computes the same
// table, match batch and counters, bit for bit.
//
// Shape of the work: a block of M threads (M = 128 table rows), thread r
// owning row r. Events depend on each other through the table, so the
// block walks the chunk's events in order, as the reference's scan does;
// a padding event changes nothing and is skipped. Per event, in the
// reference's order, with barriers between the phases:
//  1. the strict deadline advance (dl < ev_ts), which fires the absent
//     deadlines that passed before the event;
//  2. sequences: the stabilize kill and the respawn of every-scoped
//     starts; then `within` expiry with the re-arm of its scope;
//  3. per row, no barrier: every consuming state's condition (through
//     expr_interp.cuh, on the pre-event slots), then fill, forward,
//     complete or die, in state order;
//  4. the emissions, ranked by seq; the every re-arms, placed in free rows;
//  5. the always-armed starts' spawn or emission; absent anchors start
//     their clock; the round counter moves.
// Cross-row steps use no library sort: free rows are taken in ascending
// order (a block prefix sum, the order of the reference's stable
// argsort), an emitting row's place is the count of emitting rows with a
// smaller seq (M compares a thread), and the block-wide any/count/min are
// __syncthreads_or/_count and a shared-memory tree. A re-arm copies its
// source row through a staging row, so that no source is overwritten
// before it is read (the reference's functional update).
//
// Row scalars, slot fill counts, the table-wide counters, the plan and
// the condition program live in shared memory for the whole launch (the
// interpreter reads a code word and a load descriptor at every
// instruction); slot values stay in device memory (at 128 rows they sit
// in L2) and are written where a fill lands.
//
// Bound: the bytes are the chunk's events read once, the live rows read
// and written once and the matches written once. The design works
// against another floor the byte bound leaves out: one block walks the
// events one after another, a chain of barriers per event.
#include "expr_interp.cuh"

namespace {

using namespace siddhi;

constexpr int kMaxRows = SIDDHI_SCAN_MAX_ROWS;
constexpr long long kPosInf = 1ll << 62;
constexpr long long kDead = -2;   // an `or` side killed by an arrival

static_assert(sizeof(ScanArgs) <= 4096, "kernel arguments over 4 KB");

struct Shared {
  ScanPlan plan;
  int32_t code[SIDDHI_MAX_CODE];
  long long consts[SIDDHI_MAX_CONSTS];
  int32_t loads[SIDDHI_MAX_COLS];
  long long ts0[kMaxRows], born[kMaxRows], min_at[kMaxRows];
  long long dl1[kMaxRows], dl2[kMaxRows], seq[kMaxRows];
  long long red[kMaxRows];
  int32_t state[kMaxRows];
  int32_t n[SIDDHI_NFA_MAX_SLOTS][kMaxRows];
  int scan[kMaxRows];
  int free_pos[kMaxRows];
  int flag[kMaxRows];
  bool valid[kMaxRows], has_ts0[kMaxRows];
  long long next_seq, counter, overflow, out_n;
  int first_free;
};

__device__ __forceinline__ int clip(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// exclusive prefix sum of one int per thread over the block (blockDim a
// power of two); -> (prefix, total)
__device__ int excl_scan(Shared& sh, int v, int* total) {
  const int t = threadIdx.x, n = blockDim.x;
  sh.scan[t] = v;
  __syncthreads();
  for (int d = 1; d < n; d <<= 1) {
    const int x = t >= d ? sh.scan[t - d] : 0;
    __syncthreads();
    sh.scan[t] += x;
    __syncthreads();
  }
  *total = sh.scan[n - 1];
  const int r = sh.scan[t] - v;
  __syncthreads();
  return r;
}

__device__ long long block_min(Shared& sh, long long v) {
  const int t = threadIdx.x;
  sh.red[t] = v;
  __syncthreads();
  for (int d = blockDim.x / 2; d > 0; d >>= 1) {
    if (t < d && sh.red[t + d] < sh.red[t]) sh.red[t] = sh.red[t + d];
    __syncthreads();
  }
  const long long r = sh.red[0];
  __syncthreads();
  return r;
}

// the first free row (argmax(~valid)); M when none. The callers pass a
// barrier before the next call.
__device__ int first_free(Shared& sh) {
  const int r = threadIdx.x;
  if (r == 0) sh.first_free = blockDim.x;
  __syncthreads();
  if (!sh.valid[r]) atomicMin(&sh.first_free, r);
  __syncthreads();
  return sh.first_free;
}

__device__ __forceinline__ void load_event(const ScanArgs& a, int col,
                                           int type, int e, Slot* s) {
  s->v = load_col(a.ev_cols[col], type, e);
  s->null = a.ev_nulls[col][e];
}

// a state's condition for row r against event e (_slot_env :603): in the
// own slot, copy n is the event and so is slot_last k = 0; slot_last k
// reads copy n-1-k (own slot: n-k), clipped to [0, cap-1]
__device__ bool row_cond(const ScanArgs& a, const ScanPlan& P,
                         const Shared& sh, int prog_start, int prog_len,
                         int own, int r, int e) {
  if (prog_len == 0) return true;
  return interp(
      prog_len, [&](int pc) { return sh.code[prog_start + pc]; },
      [&](int i) { return sh.consts[i]; },
      [&](int arg, int type, Slot* s) {
        const int d = sh.loads[arg];
        const int kind = d & 1, j = (d >> 1) & 0x7f, col = (d >> 8) & 0xff;
        const int ck = d >> 16;
        const int cap = P.slot_cap[j];
        const int n = sh.n[j][r];
        int pos;
        if (kind == 0) {
          if (j == own && n == ck) {
            load_event(a, col, type, e, s);
            return;
          }
          pos = ck;
        } else {
          if (j == own && ck == 0) {
            load_event(a, col, type, e, s);
            return;
          }
          pos = clip(n + (j == own ? 1 : 0) - 1 - ck, 0, cap - 1);
        }
        const int x = P.slot_col0[j] + col;
        const long long at = (long long)r * cap + pos;
        s->v = load_col(a.tab_cols[x], type, at);
        s->null = a.tab_nulls[x][at];
      },
      [](int, int, const Slot&) {});
}

// a start state's condition against an empty pending (_virtual_env
// :1533): its own slot's copy 0 is the event, every other load is null
__device__ bool virtual_cond(const ScanArgs& a, const Shared& sh,
                             const ScanStartDesc& st, int e) {
  if (st.prog_len == 0) return true;
  return interp(
      st.prog_len, [&](int pc) { return sh.code[st.prog_start + pc]; },
      [&](int i) { return sh.consts[i]; },
      [&](int arg, int type, Slot* s) {
        const int d = sh.loads[arg];
        const int j = (d >> 1) & 0x7f, col = (d >> 8) & 0xff, ck = d >> 16;
        if (j == st.slot && ck == 0) {
          load_event(a, col, type, e, s);
        } else {
          s->v = 0;
          s->null = true;
        }
      },
      [](int, int, const Slot&) {});
}

// completed matches into the match batch in seq order (_emit :1459):
// row r lands at out_n + (emitting rows before it); the rest is lost
__device__ void emit(const ScanArgs& a, const ScanPlan& P, Shared& sh,
                     bool out_row, long long ts) {
  const int r = threadIdx.x, M = P.M;
  sh.flag[r] = out_row;
  const int n_emit = __syncthreads_count(out_row);
  if (n_emit == 0) return;
  const long long base = sh.out_n;
  if (out_row) {
    const long long my = sh.seq[r];
    int rank = 0;
    for (int i = 0; i < M; ++i) {
      rank += sh.flag[i] && (sh.seq[i] < my || (sh.seq[i] == my && i < r));
    }
    const long long dest = base + rank;
    if (dest < P.OUT) {
      for (int j = 0; j < P.n_slots; ++j) {
        const int cap = P.slot_cap[j];
        for (int col = 0; col < P.slot_ncols[j]; ++col) {
          const int x = P.slot_col0[j] + col;
          const int type = P.col_type[x];
          for (int c = 0; c < cap; ++c) {
            const int ci = P.slot_ci0[j] + col * cap + c;
            const long long at = (long long)r * cap + c;
            store_col(a.out_cols[ci], type, dest,
                      load_col(a.tab_cols[x], type, at));
            a.out_nulls[ci][dest] = a.tab_nulls[x][at];
          }
        }
      }
      a.out_ts[dest] = ts;
    }
  }
  __syncthreads();
  if (r == 0) {
    const long long room = P.OUT - base;
    const long long w = n_emit < room ? n_emit : (room > 0 ? room : 0);
    sh.out_n = base + w;
    sh.overflow += n_emit - w;
  }
  __syncthreads();
}

// place the rows of `mask` as fresh pendings into free rows, in
// ascending row order (_append_rows :1372, _scatter_append :1402): state
// `target`, slots from clear_from on cleared, born `counter`, new seqs;
// rows beyond the free ones are lost to overflow
__device__ void append(const ScanArgs& a, const ScanPlan& P, Shared& sh,
                       bool mask, int target, int clear_from,
                       long long counter, long long dl_src,
                       long long dl2_src) {
  const int r = threadIdx.x;
  if (__syncthreads_count(mask) == 0) return;
  // one scan ranks both: the sources (low half) and the free rows (high)
  const bool fr = !sh.valid[r];
  int total;
  const int pre = excl_scan(sh, (mask ? 1 : 0) | (fr ? 1 << 16 : 0), &total);
  const int cnt = pre & 0xffff, n_mask = total & 0xffff;
  const int n_free = total >> 16;
  if (fr) sh.free_pos[pre >> 16] = r;
  const bool ok = mask && cnt < n_free;
  // read the source row (table before the append), staging its slots
  const long long ts0 = sh.ts0[r];
  int nst[SIDDHI_NFA_MAX_SLOTS];
  bool any_kept = false;
  if (ok) {
    for (int j = 0; j < P.n_slots; ++j) {
      const bool keep = j < clear_from;
      const int cap = P.slot_cap[j];
      nst[j] = keep ? sh.n[j][r] : 0;
      any_kept = any_kept || (keep && sh.n[j][r] > 0);
      for (int c = 0; c < cap; ++c) {
        const long long at = (long long)r * cap + c;
        for (int col = 0; col < P.slot_ncols[j]; ++col) {
          const int x = P.slot_col0[j] + col;
          const int type = P.col_type[x];
          store_col(a.stg_cols[x], type, at,
                    keep ? load_col(a.tab_cols[x], type, at) : 0);
          a.stg_nulls[x][at] = keep ? a.tab_nulls[x][at] : true;
        }
        a.stg_ts[j][at] = keep ? a.tab_ts[j][at] : 0;
      }
    }
  }
  __syncthreads();
  if (ok) {
    const int d = sh.free_pos[cnt];
    sh.state[d] = target;
    sh.valid[d] = true;
    sh.born[d] = counter;
    sh.min_at[d] = -1;
    sh.dl1[d] = dl_src;
    sh.dl2[d] = dl2_src;
    sh.seq[d] = sh.next_seq + cnt;
    sh.ts0[d] = any_kept ? ts0 : 0;
    sh.has_ts0[d] = any_kept;
    for (int j = 0; j < P.n_slots; ++j) {
      const int cap = P.slot_cap[j];
      sh.n[j][d] = nst[j];
      for (int c = 0; c < cap; ++c) {
        const long long from = (long long)r * cap + c;
        const long long to = (long long)d * cap + c;
        for (int col = 0; col < P.slot_ncols[j]; ++col) {
          const int x = P.slot_col0[j] + col;
          const int type = P.col_type[x];
          store_col(a.tab_cols[x], type, to,
                    load_col(a.stg_cols[x], type, from));
          a.tab_nulls[x][to] = a.stg_nulls[x][from];
        }
        a.tab_ts[j][to] = a.stg_ts[j][from];
      }
    }
  }
  __syncthreads();
  if (r == 0) {
    const int placed = n_mask < n_free ? n_mask : n_free;
    sh.next_seq += placed;
    sh.overflow += n_mask - placed;
  }
  __syncthreads();
}

// clear row d's slots (every copy: values 0, nulls set, ts 0, n 0)
__device__ void clear_slots(const ScanArgs& a, const ScanPlan& P, Shared& sh,
                            int d) {
  for (int j = 0; j < P.n_slots; ++j) {
    const int cap = P.slot_cap[j];
    for (int c = 0; c < cap; ++c) {
      const long long at = (long long)d * cap + c;
      for (int col = 0; col < P.slot_ncols[j]; ++col) {
        const int x = P.slot_col0[j] + col;
        store_col(a.tab_cols[x], P.col_type[x], at, 0);
        a.tab_nulls[x][at] = true;
      }
      a.tab_ts[j][at] = 0;
    }
    sh.n[j][d] = 0;
  }
}

// an every-scoped sequence start re-initializes an empty pending when none
// is live (_spawn_empty :1614); born counter-1: this event tests it
__device__ void spawn_empty(const ScanArgs& a, const ScanPlan& P, Shared& sh,
                            int anchor, long long counter) {
  const int r = threadIdx.x;
  const bool has = __syncthreads_or(sh.valid[r] && sh.state[r] == anchor);
  if (has) return;
  const int d = first_free(sh);
  if (d >= P.M) return;
  if (r == d) {
    sh.state[d] = anchor;
    sh.valid[d] = true;
    sh.born[d] = counter - 1;
    sh.seq[d] = sh.next_seq;
    sh.min_at[d] = -1;
    sh.dl1[d] = kPosInf;
    sh.dl2[d] = kPosInf;
    sh.ts0[d] = 0;
    sh.has_ts0[d] = false;
    clear_slots(a, P, sh, d);
  }
  __syncthreads();
  if (r == 0) sh.next_seq += 1;
  __syncthreads();
}

// one row capturing the event in the start's slot (_spawn_virtual :1556)
__device__ void spawn_virtual(const ScanArgs& a, const ScanPlan& P,
                              Shared& sh, const ScanStartDesc& st, int e,
                              bool hit, long long counter, int as_state,
                              bool min_reached) {
  if (!hit) return;  // uniform
  const int r = threadIdx.x;
  const int d = first_free(sh);
  const bool ok = d < P.M;
  if (ok && r == d) {
    const long long ev_ts = a.ev_ts[e];
    for (int j = 0; j < P.n_slots; ++j) {
      const int cap = P.slot_cap[j];
      const bool own = j == st.slot;
      for (int c = 0; c < cap; ++c) {
        const long long at = (long long)d * cap + c;
        for (int col = 0; col < P.slot_ncols[j]; ++col) {
          const int x = P.slot_col0[j] + col;
          const int type = P.col_type[x];
          if (own && c == 0) {
            store_col(a.tab_cols[x], type, at, load_col(a.ev_cols[col], type,
                                                        e));
            a.tab_nulls[x][at] = a.ev_nulls[col][e];
          } else {  // n0 = 1: the copies past the event are cleared
            store_col(a.tab_cols[x], type, at, 0);
            a.tab_nulls[x][at] = true;
          }
        }
        // the own slot's ts is written at copy 0 only
        if (own && c == 0) {
          a.tab_ts[j][at] = ev_ts;
        } else if (!own) {
          a.tab_ts[j][at] = 0;
        }
      }
      sh.n[j][d] = own ? 1 : 0;
    }
    sh.state[d] = as_state;
    sh.valid[d] = true;
    sh.born[d] = counter;
    sh.seq[d] = sh.next_seq;
    sh.ts0[d] = ev_ts;
    sh.has_ts0[d] = true;
    sh.min_at[d] = min_reached ? counter : -1;
    sh.dl1[d] = kPosInf;
  }
  __syncthreads();
  if (r == 0) {
    if (ok) {
      sh.next_seq += 1;
    } else {
      sh.overflow += 1;
    }
  }
  __syncthreads();
}

// one match straight from the event (_emit_virtual :1682)
__device__ void emit_virtual(const ScanArgs& a, const ScanPlan& P, Shared& sh,
                             const ScanStartDesc& st, int e, bool hit) {
  if (!hit) return;  // uniform
  if (threadIdx.x == 0) {
    const long long dest = sh.out_n;
    if (dest < P.OUT) {
      const int j = st.slot, cap = P.slot_cap[j];
      for (int col = 0; col < P.slot_ncols[j]; ++col) {
        const int x = P.slot_col0[j] + col;
        const int ci = P.slot_ci0[j] + col * cap;
        store_col(a.out_cols[ci], P.col_type[x], dest,
                  load_col(a.ev_cols[col], P.col_type[x], e));
        a.out_nulls[ci][dest] = a.ev_nulls[col][e];
      }
      a.out_ts[dest] = a.ev_ts[e];
      sh.out_n = dest + 1;
    } else {
      sh.overflow += 1;
    }
  }
  __syncthreads();
}

__device__ __forceinline__ bool lane_passed(long long dl, long long now,
                                            bool strict) {
  return dl >= 0 && (strict ? dl < now : dl <= now);
}

// complete absent states whose deadline has passed (_advance_time :1087);
// emission timestamps are the deadlines themselves
__device__ void advance_time(const ScanArgs& a, const ScanPlan& P, Shared& sh,
                             long long now, bool strict) {
  if (!P.has_absent) return;
  const int r = threadIdx.x;
  const int st0 = sh.state[r];
  const bool valid0 = sh.valid[r];
  const long long dl1_0 = sh.dl1[r], dl2_0 = sh.dl2[r];
  bool live = valid0, new_valid = valid0;
  int new_state = st0;
  long long dl1 = dl1_0, dl2 = dl2_0;
  bool out_row = false, adv = false, orfwd = false;
  int rearm_t = -1, rearm_c = 0, orfwd_t = -1;
  long long rearm_dl = kPosInf, rearm_dl2 = kPosInf;
  const int stc = clip(st0, 0, P.n_states);

  if (P.within_ms >= 0) {
    // prune within-expired pendings BEFORE collecting; re-arm the
    // enclosing every scope unless the row's own state is the target
    const bool wexp = live && sh.has_ts0[r] &&
                      llabs(now - sh.ts0[r]) > P.within_ms;
    live = live && !wexp;
    new_valid = new_valid && !wexp;
    if (P.any_every) {
      const int r_arm = P.arm_of[stc];
      if (wexp && r_arm >= 0 && r_arm != st0) {
        rearm_t = r_arm;
        rearm_c = P.clear_of[stc];
      }
    }
  }
  // nothing passed, no lane pair satisfied, nothing expired: a no-op
  const bool moving =
      live && (lane_passed(dl1, now, strict) || lane_passed(dl2, now, strict)
               || (dl1 == -1 && dl2 == -1));
  if (!__syncthreads_or(moving || new_valid != valid0)) return;

  for (int i = 0; i < P.n_absent; ++i) {
    const ScanAbsentDesc& d = P.absent[i];
    const long long my_dl = d.dl_field ? dl2 : dl1;
    bool at_anchor = st0 == d.anchor;
    for (int q = 0; q < d.n_personas; ++q) {
      // counting rows whose forwarded persona waits at this anchor
      at_anchor = at_anchor || (st0 == d.persona_idx[q] &&
                                sh.n[d.persona_slot[q]][r] >=
                                    d.persona_min[q]);
    }
    bool rows = live && lane_passed(my_dl, now, strict) && at_anchor;
    if (d.has_partner) {
      if (d.p_is_absent && d.logical == SCAN_AND) {
        // both lanes must be done; lane 0 owns the group
        if (d.dl_field == 1) continue;
        const bool base = live && st0 == d.anchor;
        const bool ok1 = lane_passed(dl1, now, strict) || dl1 == -1;
        const bool ok2 = lane_passed(dl2, now, strict) || dl2 == -1;
        rows = base && ok1 && ok2;
        if (base && lane_passed(dl1, now, strict) && !ok2) dl1 = -1;
        if (base && lane_passed(dl2, now, strict) && !ok1) dl2 = -1;
      } else if (d.p_is_absent && d.logical == SCAN_OR) {
        // each lane completes the group on its own; the row survives
        // until both fired and re-arms at the second
        bool fire = rows;
        if (P.seqmode) fire = fire && !orfwd && !out_row;
        const long long other = d.dl_field ? dl1 : dl2;
        if (d.anchor_next == -1) {
          out_row = out_row || fire;
        } else {
          orfwd = orfwd || fire;
          if (fire) orfwd_t = d.anchor_next;
        }
        if (rows) {
          if (d.dl_field) {
            dl2 = -1;
          } else {
            dl1 = -1;
          }
        }
        const bool both = rows && other < 0;
        if (both) new_valid = false;
        if (d.arm >= 0 && both) {
          rearm_t = d.arm;
          rearm_c = d.clear;
          if (d.w_next > 0) rearm_dl = my_dl + d.w_next;
        }
        continue;
      } else if (d.logical == SCAN_AND) {
        // 'A and not B for t': the partner must have filled, else the
        // absence is satisfied (-1) and the row waits for the partner
        const bool filled = sh.n[d.p_slot][r] > 0;
        if (rows && !filled) dl1 = -1;
        rows = rows && filled;
      }
    }
    if (d.anchor_next == -1) {
      out_row = out_row || rows;
      if (rows) new_valid = false;
    } else {
      if (P.seqmode) {
        // sequence addState adds only when the next state's new list is
        // empty (first wins)
        const bool occupied = __syncthreads_or(
            new_valid && new_state == d.next_anchor &&
            sh.born[r] == sh.counter - 1);
        if (rows && occupied) {
          new_valid = false;
          rows = false;
        }
      }
      if (rows) new_state = d.anchor_next;
      adv = adv || rows;
    }
    if (rows) {
      dl1 = kPosInf;
      dl2 = kPosInf;
    }
    if (d.arm >= 0 && rows) {
      // every-scoped absents re-arm; the next wait rides the old deadline
      rearm_t = d.arm;
      rearm_c = d.clear;
      if (d.w_next > 0) rearm_dl = (dl1_0 >= 0 ? dl1_0 : now) + d.w_next;
      if (d.w2_next > 0) rearm_dl2 = (dl2_0 >= 0 ? dl2_0 : now) + d.w2_next;
    }
  }
  // emission timestamp = the lane that fired (min armed deadline)
  const long long e1 = dl1_0 >= 0 ? dl1_0 : kPosInf;
  const long long e2 = dl2_0 >= 0 ? dl2_0 : kPosInf;
  emit(a, P, sh, out_row, e1 < e2 ? e1 : e2);
  sh.state[r] = new_state;
  sh.valid[r] = new_valid;
  sh.dl1[r] = dl1;
  sh.dl2[r] = dl2;
  // a deadline fire forwards the pending: it survives the next round
  if (P.seqmode && adv) sh.born[r] = sh.counter - 1;
  __syncthreads();
  const long long counter = sh.counter;
  if (P.absent_rearms || (P.within_ms >= 0 && P.any_every)) {
    append(a, P, sh, rearm_t >= 0, rearm_t, rearm_c, counter - 1, rearm_dl,
           rearm_dl2);
  }
  if (P.or_double_absent) {
    // or-double-absent lane fires forward clones (slots kept)
    append(a, P, sh, orfwd, orfwd_t, P.n_slots, counter - 1, kPosInf,
           kPosInf);
  }
}

// one event of the chunk (event_body :654)
__device__ void event_body(const ScanArgs& a, const ScanPlan& P, Shared& sh,
                           int e) {
  const int r = threadIdx.x;
  const long long ev_ts = a.ev_ts[e];
  const bool is_current = a.ev_kind[e] == 0;

  advance_time(a, P, sh, ev_ts, true);
  const long long counter = sh.counter;
  bool live = sh.valid[r];

  if (P.seqmode) {
    // stabilize: kill rows that survived one full promoted round, except
    // half-filled AND groups, satisfied absent lanes, counting states
    // and every-start groups
    const int s0 = sh.state[r];
    const bool stale = live && sh.born[r] <= counter - 2;
    bool exempt = false;
    for (int g = 0; g < P.n_groups; ++g) {
      const ScanGroupDesc& G = P.groups[g];
      if (s0 != G.anchor) continue;
      exempt = exempt || ((sh.n[G.slot_l][r] > 0) != (sh.n[G.slot_r][r] > 0));
      if (G.lane == 1) exempt = exempt || sh.dl1[r] == -1;
      if (G.lane == 2) exempt = exempt || sh.dl2[r] == -1;
    }
    exempt = exempt || (s0 >= 0 && s0 < 32 && ((P.counting_mask >> s0) & 1u));
    for (int k = 0; k < P.n_rearm; ++k) {
      exempt = exempt || s0 == P.rearm_anchor[k];
    }
    live = live && !(stale && !exempt);
    sh.valid[r] = live;
    __syncthreads();
    for (int k = 0; k < P.n_rearm; ++k) {
      spawn_empty(a, P, sh, P.rearm_anchor[k], counter);
    }
    live = sh.valid[r];
  }

  bool mature = live && sh.born[r] < counter;
  if (P.within_ms >= 0) {
    const bool expired = mature && sh.has_ts0[r] &&
                         llabs(ev_ts - sh.ts0[r]) > P.within_ms;
    live = live && !expired;
    mature = mature && live;
    if (P.any_every) {
      // the re-armed clone is created before the event is processed
      const int s0 = sh.state[r];
      const int stc = clip(s0, 0, P.n_states);
      const int r_arm = P.arm_of[stc];
      const bool wr = expired && r_arm >= 0 && r_arm != s0;
      sh.valid[r] = live;
      __syncthreads();
      append(a, P, sh, wr, r_arm, P.clear_of[stc], counter - 1, kPosInf,
             kPosInf);
      live = sh.valid[r];
      mature = live && sh.born[r] < counter;
    }
  }

  // 3. the consuming states, per row: conditions on the pre-event slots
  const int pre = sh.state[r];
  unsigned at_bits = 0, cond_bits = 0, normal_bits = 0;
  for (int i = 0; i < P.n_cons; ++i) {
    const ScanStateDesc& d = P.cons[i];
    const bool normal = mature && pre == d.anchor;
    bool persona = false;
    for (int q = 0; q < d.n_personas; ++q) {
      persona = persona ||
                (mature && pre == d.persona_idx[q] &&
                 sh.n[d.persona_slot[q]][r] >= d.persona_min[q] &&
                 sh.min_at[r] < counter);
    }
    if (!((normal || persona) && is_current)) continue;
    at_bits |= 1u << i;
    if (normal) normal_bits |= 1u << i;
    if (row_cond(a, P, sh, d.prog_start, d.prog_len, d.slot, r, e)) {
      cond_bits |= 1u << i;
    }
  }
  int n_loc[SIDDHI_NFA_MAX_SLOTS];
  for (int j = 0; j < P.n_slots; ++j) n_loc[j] = sh.n[j][r];
  bool matched = false, or_taken = false, out_row = false, seq_kill = false;
  int rearm_t = -1, rearm_c = 0;
  int new_state = pre;
  bool new_valid = live;
  long long new_min = sh.min_at[r];
  long long dl1 = sh.dl1[r], dl2 = sh.dl2[r];
  for (int i = 0; i < P.n_cons; ++i) {
    if (!((at_bits >> i) & 1u)) continue;
    const ScanStateDesc& d = P.cons[i];
    const bool cond_ok = (cond_bits >> i) & 1u;
    const bool normal = (normal_bits >> i) & 1u;
    bool hit = cond_ok;
    if (d.logical == SCAN_OR) hit = hit && !or_taken;

    if (d.is_absent) {
      // a matching event violates the absence
      const long long my = d.dl_field ? dl2 : dl1;
      const bool viol = d.waiting_ms > 0 ? (hit && my >= 0) : hit;
      if (d.viol_latch) {  // latch the lane DEAD
        if (viol) {
          if (d.dl_field) {
            dl2 = kDead;
          } else {
            dl1 = kDead;
          }
        }
        continue;
      }
      bool kill = viol;
      if (d.viol_push && d.waiting_ms > 0) {  // push the deadline
        kill = false;
        if (viol) {
          if (d.dl_field) {
            dl2 = ev_ts + d.waiting_ms;
          } else {
            dl1 = ev_ts + d.waiting_ms;
          }
        }
      }
      if (d.logical == SCAN_OR && !(P.seqmode && d.grp_final)) {
        // only this side dies
        if (kill) {
          if (d.dl_field) {
            dl2 = kDead;
          } else {
            dl1 = kDead;
          }
        }
        if (d.p_is_absent) {
          const long long other = d.dl_field ? dl1 : dl2;
          if (kill && other == kDead) new_valid = false;
        }
      } else if (kill) {
        new_valid = false;
      }
      if (P.seqmode && d.has_partner && normal && !cond_ok) seq_kill = true;
      continue;
    }

    // fill the own slot at position n (plain slots: position 0)
    const int own = d.slot, cap = d.cap;
    int n = n_loc[own];
    bool can_fill;
    if (d.is_counting) {
      can_fill = hit && n < cap && (d.max_count == -1 || n < d.max_count);
    } else {
      can_fill = hit;
      n = 0;
    }
    if (can_fill) {
      const long long at = (long long)r * cap + clip(n, 0, cap - 1);
      for (int col = 0; col < P.slot_ncols[own]; ++col) {
        const int x = P.slot_col0[own] + col;
        const int type = P.col_type[x];
        store_col(a.tab_cols[x], type, at, load_col(a.ev_cols[col], type, e));
        a.tab_nulls[x][at] = a.ev_nulls[col][e];
      }
      a.tab_ts[own][at] = ev_ts;
      n_loc[own] = d.is_counting ? n_loc[own] + 1 : 1;
    }
    matched = matched || can_fill;

    bool fwd;
    if (d.is_counting) {
      const int nn = n_loc[own];
      const bool just_min = can_fill && nn == d.min_count;
      const bool maxed = can_fill && d.max_count != -1 && nn == d.max_count;
      if (can_fill) new_state = d.idx;
      if (just_min) new_min = counter;
      if (d.next_idx >= 0 && d.nxt_waiting_ms > 0 && can_fill &&
          nn >= d.min_count) {
        // the wait clock restarts at the latest absorb
        if (d.nxt_dl_field) {
          dl2 = ev_ts + d.nxt_waiting_ms;
        } else {
          dl1 = ev_ts + d.nxt_waiting_ms;
        }
      }
      if (d.next_idx == -1) {
        out_row = out_row || just_min;
        if (maxed) new_valid = false;
      } else if (maxed) {
        new_state = d.next_idx;
      }
      fwd = just_min;
    } else {
      bool complete = hit;
      if (d.has_partner) {
        if (d.logical == SCAN_OR) {
          or_taken = or_taken || complete;  // either side completes
        } else if (d.p_is_absent && d.p_waits) {
          // 'X and not Y for t': only once the deadline passed
          const long long pdl = d.p_dl_field ? dl2 : dl1;
          complete = hit && pdl < ev_ts;
        } else if (d.p_is_absent) {
          const long long pdl = d.p_dl_field ? dl2 : dl1;
          if (d.p_viol_latch) {
            // a latched lane fails the fill and re-initializes the group
            const bool blocked = hit && pdl == kDead;
            complete = hit && pdl != kDead;
            if (blocked) {
              new_valid = false;
              if (d.arm >= 0) {
                rearm_t = d.arm;
                rearm_c = d.clear;
              }
            }
          }
        } else {  // and, both present: partner slot filled?
          complete = hit && n_loc[d.p_slot] > 0;
        }
      }
      if (d.anchor_next == -1) {
        out_row = out_row || complete;
        if (complete) new_valid = false;
      } else if (complete) {
        new_state = d.anchor_next;
      }
      if (complete) {  // armed absent lanes die with the wait
        dl1 = kPosInf;
        dl2 = kPosInf;
      }
      fwd = complete;
    }
    if (d.arm >= 0 && fwd) {
      rearm_t = d.arm;
      rearm_c = d.clear;
    }
    if (P.seqmode && !d.is_counting && normal && !cond_ok &&
        !(d.has_partner && sh.n[d.slot][r] != 0)) {
      seq_kill = true;
    }
  }
  for (int j = 0; j < P.n_slots; ++j) sh.n[j][r] = n_loc[j];
  if (matched && !sh.has_ts0[r]) {  // the first captured event
    sh.ts0[r] = ev_ts;
    sh.has_ts0[r] = true;
  }
  if (P.seqmode && matched && is_current) sh.born[r] = counter;
  sh.state[r] = new_state;
  sh.valid[r] = new_valid && !seq_kill;
  sh.min_at[r] = new_min;
  sh.dl1[r] = dl1;
  sh.dl2[r] = dl2;
  __syncthreads();

  // 4. the matches (seq order), then the every re-arms
  emit(a, P, sh, out_row, ev_ts);
  append(a, P, sh, rearm_t >= 0 && is_current, rearm_t, rearm_c, counter,
         kPosInf, kPosInf);

  // 5. always-armed starts of this stream
  for (int k = 0; k < P.n_starts; ++k) {
    const ScanStartDesc& st = P.starts[k];
    bool hit = is_current && virtual_cond(a, sh, st, e);
    if (st.suppress) {
      // no new attempt while the next (absent) wait is pending
      hit = hit && !__syncthreads_or(sh.valid[r] &&
                                     sh.state[r] == st.nxt_anchor);
    }
    if (st.is_counting) {
      const bool reached_min = st.min_count <= 1;
      if (st.next_idx == -1 && reached_min) emit_virtual(a, P, sh, st, e, hit);
      spawn_virtual(a, P, sh, st, e, hit, counter, st.idx, reached_min);
    } else if (st.next_idx == -1) {
      emit_virtual(a, P, sh, st, e, hit);
    } else {
      spawn_virtual(a, P, sh, st, e, hit, counter, st.next_idx, false);
    }
  }

  if (P.has_absent) {
    // rows newly waiting at an absent anchor start their clock now
    const int stc = clip(sh.state[r], 0, P.n_states);
    const long long w = P.wait_of[stc];
    if (sh.valid[r] && w > 0 && sh.dl1[r] >= kPosInf) sh.dl1[r] = ev_ts + w;
    if (P.has_dl2) {
      const long long w2 = P.wait2_of[stc];
      if (sh.valid[r] && w2 > 0 && sh.dl2[r] >= kPosInf) {
        sh.dl2[r] = ev_ts + w2;
      }
    }
  }
  __syncthreads();
  if (r == 0) sh.counter = counter + 1;  // a real event: one round
  __syncthreads();
}

__global__ void __launch_bounds__(kMaxRows)
    nfa_scan_kernel(const __grid_constant__ ScanArgs a0) {
  // one block per partition slot (blockIdx.y), one outside a block
  const ScanArgs& a = part_args(a0);
  __shared__ Shared sh;
  const int r = threadIdx.x, M = blockDim.x;
  // the plan and the condition program, into shared memory
  static_assert(sizeof(ScanPlan) % 4 == 0, "the plan is copied by words");
  const int32_t* plan_words = (const int32_t*)a.plan;
  int32_t* plan_dst = (int32_t*)&sh.plan;
  for (int i = r; i < (int)(sizeof(ScanPlan) / 4); i += M) {
    plan_dst[i] = plan_words[i];
  }
  for (int i = r; i < a.n_code; i += M) sh.code[i] = a.code[i];
  for (int i = r; i < a.n_consts; i += M) sh.consts[i] = a.consts[i];
  for (int i = r; i < a.n_loads; i += M) sh.loads[i] = a.loads[i];
  __syncthreads();
  const ScanPlan& P = sh.plan;
  sh.state[r] = a.state[r];
  sh.valid[r] = a.valid[r];
  sh.ts0[r] = a.ts0[r];
  sh.has_ts0[r] = a.has_ts0[r];
  sh.born[r] = a.born[r];
  sh.min_at[r] = a.min_at[r];
  sh.dl1[r] = a.deadline[r];
  sh.dl2[r] = a.deadline2[r];
  sh.seq[r] = a.seq[r];
  for (int j = 0; j < P.n_slots; ++j) sh.n[j][r] = a.tab_n[j][r];
  if (r == 0) {
    sh.next_seq = *a.next_seq;
    sh.counter = *a.counter;
    sh.overflow = *a.overflow;
    sh.out_n = 0;
  }
  // a clear match batch
  const long long cells = (long long)P.OUT * (P.n_match_cols + 1);
  for (long long i = r; i < cells; i += M) {
    const int c = (int)(i / P.OUT);
    const long long o = i % P.OUT;
    if (c == P.n_match_cols) {
      a.out_ts[o] = 0;
    } else {
      store_col(a.out_cols[c], a.out_type[c], o, 0);
      a.out_nulls[c][o] = true;
    }
  }
  __syncthreads();

  if (a.n_events == 0) {
    advance_time(a, P, sh, a.now, false);  // the timer step
  } else {
    for (int e = 0; e < a.n_events; ++e) {
      if (!a.ev_valid[e]) continue;  // padding changes nothing
      event_body(a, P, sh, e);
    }
  }
  __syncthreads();

  a.state[r] = sh.state[r];
  a.valid[r] = sh.valid[r];
  a.ts0[r] = sh.ts0[r];
  a.has_ts0[r] = sh.has_ts0[r];
  a.born[r] = sh.born[r];
  a.min_at[r] = sh.min_at[r];
  a.deadline[r] = sh.dl1[r];
  a.deadline2[r] = sh.dl2[r];
  a.seq[r] = sh.seq[r];
  for (int j = 0; j < P.n_slots; ++j) a.tab_n[j][r] = sh.n[j][r];
  if (a.due != nullptr) {  // next_due: the earliest armed live deadline
    long long m = kPosInf;
    if (sh.valid[r]) {
      if (sh.dl1[r] >= 0) m = sh.dl1[r];
      if (sh.dl2[r] >= 0 && sh.dl2[r] < m) m = sh.dl2[r];
    }
    m = block_min(sh, m);
    if (r == 0) *a.due = m;
  }
  const long long out_n = sh.out_n;
  if (r == 0) {
    *a.next_seq = sh.next_seq;
    *a.counter = sh.counter;
    *a.overflow = sh.overflow;
    *a.out_n = out_n;
  }
  for (long long i = r; i < P.OUT; i += M) {
    a.out_valid[i] = i < out_n;
    a.out_kind[i] = 0;
  }
}

}  // namespace

#ifndef SIDDHI_EMU
extern "C" cudaError_t siddhi_nfa_scan(const ScanArgs* a,
                                       cudaStream_t stream) {
  // one block per partition slot, one thread per table row
  nfa_scan_kernel<<<dim3(1, (unsigned)a->n_part), a->rows, 0, stream>>>(*a);
  return cudaGetLastError();
}
#endif
