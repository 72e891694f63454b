// Kernel K7: one trigger direction of a join (ops/join.py join_probe,
// join_grid).
//
// Replaces the reference's JoinCross._cross_probe (siddhi_tpu/ops/
// join.py:421) with ops/table.py sorted_key_view (:373) and band_bounds
// (:405), and JoinCross._cross_grid (join.py:297).
//
// join_probe, a fixed sequence of launches on the caller's stream, no
// host sync:
//   1. probe_keys: the band key of each trigger row and each opposite
//      row through the interpreter, cast and encoded in sort order
//      (key_sort.cuh); dead opposite rows take the pad value;
//   2. the key view: a stable radix sort by (dead, key, position);
//   3. probe_bands: each trigger row's [lo, hi) by the reference's own
//      bisection, clamped to the live rows;
//   4. where a residual conjunct or the liveness gate applies: the band
//      sizes' prefix, one thread a candidate slot (its row by a binary
//      search of that prefix) evaluating the residual at (trigger row,
//      opposite row) and the gate, the survivors' prefix, per-row
//      survivor counts and their prefix; candidates beyond CAND are
//      counted (the prefix sums over CAND or B run tile by tile across
//      blocks: tile totals, their scan, each tile's scan);
//   5. probe_lead and a prefix: per trigger row its one-sided or RESET
//      row and its pairs, in emission order;
//   6. probe_place: one thread an output slot finds its row and its
//      opposite row;
//   7. gather: the output columns; pairs beyond CAP are counted.
// join_grid: one warp a trigger row walks the opposite buffer 32 rows at
// a time, evaluating the ON condition for each pair (ballot counts), a
// prefix over rows, then the same warps place their pairs in order; the
// [B, W] grid is never built.
//
// Both reproduce the plain versions bit for bit, the slots past the
// last emitted row included (their gathered values are the reference's
// clamped gathers).
//
// A tenant pool (serving/pool.py, the reference's vmap of the join step
// at pool.py:1337-1363) crosses every slot's trigger rows with that
// slot's opposite window in the same launches: the slot is blockIdx.y,
// part_args (siddhi_kernels.h) moves every side, output and scratch
// pointer to the slot's own, and the key view's sort and the prefix sums
// run one segment a slot (key_sort.cuh), each stable.
#include "siddhi_kernels.h"
#include "key_sort.cuh"
#include "pairs.cuh"

namespace {

using ks::T1;
using ks::grid;
using siddhi::Slot;

constexpr int32_t CUR = 0, EXP = 1, RST = 3;   // core/event.py kinds

__device__ __forceinline__ bool joinable(const JoinArgs& a, int64_t b) {
  const int32_t k = a.trig.kind[b];
  return a.trig.valid[b] && (k == CUR || k == EXP);
}

__device__ __forceinline__ bool reset_row(const JoinArgs& a, int64_t b) {
  return a.trig.valid[b] && a.trig.kind[b] == RST;
}

// the liveness gate: the opposite row was alive at the trigger row's time
__device__ __forceinline__ bool alive(const JoinArgs& a, int64_t b,
                                      int64_t w) {
  return !a.gate || a.opp.ts[w] + a.win_ms >= a.trig.ts[b];
}

// ---------------------------------------------------------------- probe

__global__ void probe_keys(const __grid_constant__ JoinArgs a0) {
  const JoinArgs& a = part_args(a0);
  const int64_t i = (int64_t)blockIdx.x * T1 + threadIdx.x;
  Slot k;
  if (i < a.B) {
    pairs::run(a.tkey, a.trig, i, a.opp, 0, &k);
    a.trig_keys[i] = (int64_t)ks::sortable(ks::enc_key(k.v, a.key_type),
                                       a.key_type);
    a.act[i] = joinable(a, i) && !k.null;
  }
  if (i < a.W) {
    pairs::run(a.okey, a.trig, 0, a.opp, i, &k);
    const bool live = a.opp.valid[i] && !k.null;
    const int64_t e = live ? ks::enc_key(k.v, a.key_type) : a.big;
    a.sort.keys[i] = (int64_t)ks::sortable(e, a.key_type);
    a.sort.pad[i] = !live;
    if (live) atomicAdd((unsigned long long*)a.sort.n_live, 1ull);
  }
}

__global__ void probe_bands(const __grid_constant__ JoinArgs a0) {
  const JoinArgs& a = part_args(a0);
  const int64_t b = (int64_t)blockIdx.x * T1 + threadIdx.x;
  if (b >= a.B) return;
  const int64_t nl = *a.sort.n_live;
  const uint64_t v = (uint64_t)a.trig_keys[b];
  int64_t lo = ks::bisect(a.sort.sk, a.W, a.levels, v, true);
  int64_t hi = ks::bisect(a.sort.sk, a.W, a.levels, v, false);
  lo = lo < nl ? lo : nl;
  hi = hi < nl ? hi : nl;
  if (!a.act[b]) hi = lo;
  a.lo[b] = (int32_t)lo;
  a.cnt[b] = hi - lo;
}

__global__ void probe_cands(const __grid_constant__ JoinArgs a0) {
  const JoinArgs& a = part_args(a0);
  const int64_t cj = (int64_t)blockIdx.x * T1 + threadIdx.x;
  if (cj >= a.CAND) return;
  const int64_t B = a.B, W = a.W;
  const int64_t ctotal = a.coffs[B - 1];
  // past the last candidate the search would give B, clamped to B - 1
  int64_t cr = cj < ctotal ? ks::upper_bound(a.coffs, B, cj) : B - 1;
  cr = cr > B - 1 ? B - 1 : cr;
  const int64_t ck = cj - (a.coffs[cr] - a.cnt[cr]);
  int64_t cp = a.lo[cr] + ck;
  cp = cp < 0 ? 0 : (cp > W - 1 ? W - 1 : cp);
  const int32_t oi = a.sort.order[cp];
  a.coi[cj] = oi;
  bool s = cj < ctotal;
  if (s && a.resid.n_code > 0) {
    s = pairs::run(a.resid, a.trig, cr, a.opp, oi, nullptr);
  }
  if (s) s = alive(a, cr, oi);
  a.s[cj] = s;
}

// survivors per trigger row: its candidates are a contiguous run
__global__ void probe_surv(const __grid_constant__ JoinArgs a0) {
  const JoinArgs& a = part_args(a0);
  const int64_t b = (int64_t)blockIdx.x * T1 + threadIdx.x;
  if (b >= a.B) return;
  int64_t st = a.coffs[b] - a.cnt[b], e = a.coffs[b];
  st = st < a.CAND ? st : a.CAND;
  e = e < a.CAND ? e : a.CAND;
  a.surv[b] = (e > 0 ? a.S[e - 1] : 0) - (st > 0 ? a.S[st - 1] : 0);
}

__global__ void probe_lead(const __grid_constant__ JoinArgs a0) {
  const JoinArgs& a = part_args(a0);
  const int64_t b = (int64_t)blockIdx.x * T1 + threadIdx.x;
  if (b >= a.B) return;
  const int64_t surv = a.need_resid ? a.surv[b] : a.cnt[b];
  const bool lone = a.outer && joinable(a, b) && surv == 0;
  const bool lead = lone || reset_row(a, b);
  a.lead[b] = lead;
  a.tot[b] = (int64_t)lead + surv;
}

__global__ void probe_place(const __grid_constant__ JoinArgs a0) {
  const JoinArgs& a = part_args(a0);
  const int64_t j = (int64_t)blockIdx.x * T1 + threadIdx.x;
  if (j >= a.CAP) return;
  const int64_t B = a.B, W = a.W;
  const int64_t total = a.offs[B - 1];
  int64_t r = ks::upper_bound(a.offs, B, j);
  r = r > B - 1 ? B - 1 : r;
  const int64_t start = a.offs[r] - a.tot[r];
  const int64_t k = j - start;
  const int64_t lead = a.lead[r];
  const bool valid_out = j < total;
  const bool is_pair = valid_out && k >= lead;
  int32_t oi;
  if (a.need_resid) {
    const int64_t surv = a.surv[r];
    const int64_t m = (a.soffs[r] - surv) + (k - lead);
    int64_t c = ks::lower_bound(a.S, a.CAND, m + 1);
    c = c > a.CAND - 1 ? a.CAND - 1 : c;
    oi = a.coi[c];
  } else {
    int64_t p = a.lo[r] + (k - lead);
    p = p < 0 ? 0 : (p > W - 1 ? W - 1 : p);
    oi = a.sort.order[p];
  }
  a.ti[j] = (int32_t)r;
  a.oi[j] = oi;
  a.is_pair[j] = is_pair;
}

// ----------------------------------------------------------------- grid

__device__ __forceinline__ bool grid_pair(const JoinArgs& a, int64_t b,
                                          int64_t w) {
  if (!a.opp.valid[w] || !alive(a, b, w)) return false;
  if (a.cond.n_code == 0) return true;
  return pairs::run(a.cond, a.trig, b, a.opp, w, nullptr);
}

// one warp a trigger row: its pairs counted, its lead row decided
__global__ void grid_count(const __grid_constant__ JoinArgs a0) {
  const JoinArgs& a = part_args(a0);
  const int64_t b = ((int64_t)blockIdx.x * T1 + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (b >= a.B) return;
  int64_t n = 0;
  const bool jn = joinable(a, b);
  if (jn) {
    for (int64_t w0 = 0; w0 < a.W; w0 += 32) {
      const int64_t w = w0 + lane;
      const bool p = w < a.W && grid_pair(a, b, w);
      n += __popc(__ballot_sync(0xffffffffu, p));
    }
  }
  if (lane == 0) {
    const bool lead = (a.outer && jn && n == 0) || reset_row(a, b);
    a.lead[b] = lead;
    a.tot[b] = (int64_t)lead + n;
  }
}

// the same warps place their row's slots: the lead row, then the pairs
// in buffer order, up to CAP
__global__ void grid_place(const __grid_constant__ JoinArgs a0) {
  const JoinArgs& a = part_args(a0);
  const int64_t b = ((int64_t)blockIdx.x * T1 + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (b >= a.B) return;
  const int64_t lead = a.lead[b];
  int64_t slot = a.offs[b] - a.tot[b];
  if (slot >= a.CAP) return;
  if (lead && lane == 0) {
    a.ti[slot] = (int32_t)b;
    a.oi[slot] = 0;
    a.is_pair[slot] = 0;
  }
  slot += lead;
  if (a.tot[b] == lead) return;
  for (int64_t w0 = 0; w0 < a.W && slot < a.CAP; w0 += 32) {
    const int64_t w = w0 + lane;
    const bool p = w < a.W && grid_pair(a, b, w);
    const unsigned m = __ballot_sync(0xffffffffu, p);
    const int64_t mine = slot + __popc(m & ((1u << lane) - 1u));
    if (p && mine < a.CAP) {
      a.ti[mine] = (int32_t)b;
      a.oi[mine] = (int32_t)w;
      a.is_pair[mine] = 1;
    }
    slot += __popc(m);
  }
}

// slots past the last emitted row: the reference's clamped gathers
// (row B - 1, opposite row W - 1, a pair)
__global__ void grid_tail(const __grid_constant__ JoinArgs a0) {
  const JoinArgs& a = part_args(a0);
  const int64_t j = (int64_t)blockIdx.x * T1 + threadIdx.x;
  if (j >= a.CAP || j < a.offs[a.B - 1]) return;
  a.ti[j] = a.B - 1;
  a.oi[j] = a.W - 1;
  a.is_pair[j] = 1;
}

// ----------------------------------------------------------- the output

__global__ void gather(const __grid_constant__ JoinArgs a0) {
  const JoinArgs& a = part_args(a0);
  const int64_t j = (int64_t)blockIdx.x * T1 + threadIdx.x;
  const int64_t total = a.offs[a.B - 1];
  if (j == 0) {
    const int64_t over = total > a.CAP ? total - a.CAP : 0;
    int64_t lost = 0;
    if (a.need_resid) {
      const int64_t ct = a.coffs[a.B - 1];
      lost = ct > a.CAND ? ct - a.CAND : 0;
    }
    *a.lost = over + lost;
  }
  if (j >= a.CAP) return;
  const int64_t ti = a.ti[j], oi = a.oi[j];
  const bool pair = a.is_pair[j];
  a.out_ts[j] = a.trig.ts[ti];
  a.out_kind[j] = a.trig.kind[ti];
  a.out_valid[j] = j < total;
  for (int c = 0; c < a.n_out; ++c) {
    const int col = a.out_col[c];
    if (a.out_from_trig[c]) {
      pairs::copy_elem(a.out_cols[c], j, a.trig.cols[col], ti,
                       a.out_size[c]);
      a.out_nulls[c][j] = a.trig.nulls[col][ti];
    } else {
      pairs::copy_elem(a.out_cols[c], j, a.opp.cols[col], oi,
                       a.out_size[c]);
      a.out_nulls[c][j] = a.opp.nulls[col][oi] || !pair;
    }
  }
}

}  // namespace

extern "C" cudaError_t siddhi_join_probe(const JoinArgs* p,
                                         cudaStream_t stream) {
  const JoinArgs& a = *p;
  const int64_t P = a.n_part;
  auto g = [&](int64_t n) { return dim3(grid(n), (unsigned)P); };
  cudaMemsetAsync(a.sort.n_live, 0, P * sizeof(int64_t), stream);
  const int64_t n = a.B > a.W ? a.B : a.W;
  probe_keys<<<g(n), T1, 0, stream>>>(a);
  const int bits = ks::wide(a.key_type) ? 64 : 32;
  cudaError_t err = ks::sort_rows(a.sort, a.W, bits, a.sort.pad, stream, P);
  if (err != cudaSuccess) return err;
  probe_bands<<<g(a.B), T1, 0, stream>>>(a);
  if (a.need_resid) {
    ks::prefix_sum(a.cnt, a.coffs, a.B, a.psum, stream, P);
    probe_cands<<<g(a.CAND), T1, 0, stream>>>(a);
    ks::prefix_sum(a.s, a.S, a.CAND, a.psum, stream, P);
    probe_surv<<<g(a.B), T1, 0, stream>>>(a);
    ks::prefix_sum(a.surv, a.soffs, a.B, a.psum, stream, P);
  }
  probe_lead<<<g(a.B), T1, 0, stream>>>(a);
  ks::prefix_sum(a.tot, a.offs, a.B, a.psum, stream, P);
  probe_place<<<g(a.CAP), T1, 0, stream>>>(a);
  gather<<<g(a.CAP), T1, 0, stream>>>(a);
  return cudaGetLastError();
}

extern "C" cudaError_t siddhi_join_grid(const JoinArgs* p,
                                        cudaStream_t stream) {
  const JoinArgs& a = *p;
  const int64_t P = a.n_part;
  auto g = [&](int64_t n) { return dim3(grid(n), (unsigned)P); };
  const dim3 warps = g((int64_t)a.B * 32);
  grid_count<<<warps, T1, 0, stream>>>(a);
  ks::prefix_sum(a.tot, a.offs, a.B, a.psum, stream, P);
  grid_place<<<warps, T1, 0, stream>>>(a);
  grid_tail<<<g(a.CAP), T1, 0, stream>>>(a);
  gather<<<g(a.CAP), T1, 0, stream>>>(a);
  return cudaGetLastError();
}
