// Kernel K8: table writes, condition passes, index probes and the
// seq-ordered view (ops/table.py table_write, table_match, probe_touched,
// table_buffer).
//
// Replaces the reference's siddhi_tpu/ops/table.py
// TableRuntime.insert (:72) with _scatter_rows (:111),
// TableOutputOp.step_tables (:235) and the grid branch of
// TableFilterOp.step_tables (:535), probe_touched (:432) and
// TableRuntime.buffer (:130).
//
// table_write: a copy of the state; with a primary key, each adding
//   row's key hash (K6's mix64) against the live rows' (one thread a row
//   finds the first match), each matched table row taking its LAST
//   adding row (an atomic max of the row index: the later row wins, as
//   the reference's scatter leaves it on the CPU, and the same on every
//   run); then the free slots ranked in ascending index (one block), the
//   remaining adding rows ranked (one block), each placed in its free
//   slot with seq = next_seq + rank; the counters.
// table_match: one warp a table row walks the events from the last, 32
//   at a time, stopping at the first (so the last) acting event whose
//   condition holds, and deletes the row or writes its SET values
//   evaluated at (that event, the row); one warp an event walks the rows
//   for any match.
// table_probe: the key view of key_sort.cuh over the indexed column, each
//   event's band by the reference's bisection, the bands' coverage by
//   +1/-1 marks and a prefix, scattered back through the view's order.
// table_buffer: a stable radix sort of (valid ? seq : POS_INF) and a
//   gather.
#include "siddhi_kernels.h"
#include "key_sort.cuh"
#include "pairs.cuh"

namespace {

using ks::T1;
using ks::grid;
using siddhi::Slot;

constexpr int64_t POS_INF = 1LL << 62;   // ops/sentinels.py

__device__ __forceinline__ int64_t mix64(int64_t h, int64_t v) {
  h = h ^ (int64_t)((uint64_t)v + 0x9E3779B97F4A7C15ULL);
  h = (int64_t)((uint64_t)(h ^ (h >> 30)) * 0xBF58476D1CE4E5B9ULL);
  h = (int64_t)((uint64_t)(h ^ (h >> 27)) * 0x94D049BB133111EBULL);
  return h ^ (h >> 31);
}

// ops/keyed.py hash_columns over the primary-key columns of row r of a
// side (the events or the table)
template <class S>
__device__ __forceinline__ int64_t pk_hash(const TableArgs& a, const S& s,
                                          int64_t r) {
  int64_t h = 1469598103934665603LL;
  for (int k = 0; k < a.n_pk; ++k) {
    const int c = a.pk[k];
    int64_t lane;
    switch (a.col_type[c]) {
      case VT_DOUBLE:
        lane = ((const int64_t*)s.cols[c])[r];
        break;
      case VT_FLOAT:
        lane = ((const int32_t*)s.cols[c])[r];
        break;
      default: lane = siddhi::load_col(s.cols[c], a.col_type[c], r);
    }
    if (s.nulls[c][r]) lane = -987654321987654321LL;
    h = mix64(h, lane);
  }
  return h;
}

__device__ __forceinline__ bool acting(const TableArgs& a, int64_t b) {
  return a.mask == nullptr || a.mask[b];
}

// ---------------------------------------------------------------- write

__global__ void tw_copy(const TableArgs a) {
  const int64_t t = (int64_t)blockIdx.x * T1 + threadIdx.x;
  if (t >= a.T) return;
  for (int c = 0; c < a.n_cols; ++c) {
    pairs::copy_elem(a.o.cols[c], t, a.t.cols[c], t, a.col_size[c]);
    a.o.nulls[c][t] = a.t.nulls[c][t];
  }
  a.o.ts[t] = a.t.ts[t];
  a.o.seq[t] = a.t.seq[t];
  a.o.valid[t] = a.t.valid[t];
  a.win[t] = -1;
}

__global__ void tw_hash(const TableArgs a) {
  const int64_t i = (int64_t)blockIdx.x * T1 + threadIdx.x;
  if (i < a.B) {
    a.adding[i] = a.mask[i] && a.ev.valid[i];
    if (a.n_pk) a.hk[i] = pk_hash(a, a.ev, i);
  }
  if (i < a.T && a.n_pk) a.tk[i] = pk_hash(a, a.t, i);
}

// each adding row's first live table row with the same key; the last
// adding row of each matched table row wins it
__global__ void tw_hit(const TableArgs a) {
  const int64_t b = (int64_t)blockIdx.x * T1 + threadIdx.x;
  if (b >= a.B) return;
  int64_t hit = a.T;
  if (a.adding[b]) {
    const int64_t h = a.hk[b];
    for (int64_t t = 0; t < a.T; ++t) {
      if (a.t.valid[t] && a.tk[t] == h) {
        hit = t;
        break;
      }
    }
  }
  a.hit[b] = hit;
  if (hit < a.T) atomicMax((long long*)&a.win[hit], (long long)b);
}

// the matched table rows take their winning row's values (seq kept)
__global__ void tw_replace(const TableArgs a) {
  const int64_t t = (int64_t)blockIdx.x * T1 + threadIdx.x;
  if (t >= a.T) return;
  const int64_t b = a.win[t];
  if (b < 0) return;
  for (int c = 0; c < a.n_cols; ++c) {
    pairs::copy_elem(a.o.cols[c], t, a.ev.cols[c], b, a.col_size[c]);
    a.o.nulls[c][t] = a.ev.nulls[c][b];
  }
  a.o.ts[t] = a.ev.ts[b];
}

// one block: free slots in ascending index, then the taken ones (the
// reference's stable argsort of ~free); the adding rows' ranks
__global__ void tw_ranks(const TableArgs a) {
  __shared__ int64_t buf[SS_BLOCK];
  int64_t lo, hi, n = 0, total;
  ss::span(a.T, &lo, &hi);
  for (int64_t t = lo; t < hi; ++t) n += !a.o.valid[t];
  int64_t before = ss::block_scan_sum(n, buf, &total) - n;
  for (int64_t t = lo; t < hi; ++t) {
    if (!a.o.valid[t]) {
      a.free_pos[before++] = t;
    } else {
      a.free_pos[total + (t - before)] = t;
    }
  }
  if (threadIdx.x == 0) a.scal[0] = total;
  int64_t blo, bhi, m = 0, madd;
  ss::span(a.B, &blo, &bhi);
  for (int64_t b = blo; b < bhi; ++b) {
    m += a.adding[b] && (a.n_pk == 0 || a.hit[b] == a.T);
  }
  int64_t r = ss::block_scan_sum(m, buf, &madd) - m;
  for (int64_t b = blo; b < bhi; ++b) {
    const bool add = a.adding[b] && (a.n_pk == 0 || a.hit[b] == a.T);
    a.rank[b] = add ? r : -1;
    r += add;
  }
  if (threadIdx.x == 0) a.scal[1] = madd;
}

__global__ void tw_append(const TableArgs a) {
  const int64_t b = (int64_t)blockIdx.x * T1 + threadIdx.x;
  if (b >= a.B) return;
  const int64_t r = a.rank[b];
  if (r < 0 || r >= a.scal[0]) return;
  const int64_t d = a.free_pos[r];
  for (int c = 0; c < a.n_cols; ++c) {
    pairs::copy_elem(a.o.cols[c], d, a.ev.cols[c], b, a.col_size[c]);
    a.o.nulls[c][d] = a.ev.nulls[c][b];
  }
  a.o.ts[d] = a.ev.ts[b];
  a.o.seq[d] = *a.t.next_seq + r;
  a.o.valid[d] = true;
}

__global__ void tw_finish(const TableArgs a) {
  const int64_t n_free = a.scal[0], n_add = a.scal[1];
  const int64_t ok = n_add < n_free ? n_add : n_free;
  *a.o.next_seq = *a.t.next_seq + ok;
  *a.o.overflow = *a.t.overflow + (n_add - ok);
}

// ---------------------------------------------------------------- match

__device__ __forceinline__ bool holds(const TableArgs& a, int64_t b,
                                      int64_t t) {
  if (!a.has_cond) return true;
  return pairs::run(a.cond, a.ev, b, a.t, t, nullptr);
}

// one warp a table row: the last acting event that matches it, 32
// events at a time from the last (the lowest set lane of the first
// ballot with a hit is the highest event); lane 0 deletes the row or
// writes its SET values
__global__ void tm_rows(const TableArgs a) {
  const int64_t t = ((int64_t)blockIdx.x * T1 + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (t >= a.T) return;
  const bool live = a.t.valid[t];
  int64_t src = -1;
  if (live) {
    for (int64_t top = a.B - 1; top >= 0 && src < 0; top -= 32) {
      const int64_t b = top - lane;
      const bool hit = b >= 0 && acting(a, b) && holds(a, b, t);
      const unsigned m = __ballot_sync(0xffffffffu, hit);
      if (m) src = top - (__ffs(m) - 1);
    }
  }
  if (lane != 0) return;
  const bool touched = src >= 0;
  if (a.mode == 1) {
    a.o.valid[t] = live && !touched;
    return;
  }
  a.o.valid[t] = live;
  Slot out[SIDDHI_JOIN_MAX_COLS];
  if (touched && a.n_sets > 0) pairs::run(a.sets, a.ev, src, a.t, t, out);
  for (int k = 0; k < a.n_sets; ++k) {
    const int c = a.set_col[k];
    if (touched) {
      siddhi::store_col(a.o.cols[c], a.col_type[c], t, out[k].v);
      a.o.nulls[c][t] = out[k].null;
    } else {
      pairs::copy_elem(a.o.cols[c], t, a.t.cols[c], t, a.col_size[c]);
      a.o.nulls[c][t] = a.t.nulls[c][t];
    }
  }
}

// one warp an event: does any live row match it? 32 rows at a time,
// stopping at the first ballot with a hit
__global__ void tm_events(const TableArgs a) {
  const int64_t b = ((int64_t)blockIdx.x * T1 + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (b >= a.B) return;
  bool hit = false;
  if (acting(a, b)) {
    for (int64_t t0 = 0; t0 < a.T && !hit; t0 += 32) {
      const int64_t t = t0 + lane;
      const bool h = t < a.T && a.t.valid[t] && holds(a, b, t);
      hit = __ballot_sync(0xffffffffu, h) != 0;
    }
  }
  if (lane == 0) a.any_hit[b] = hit;
}

// ---------------------------------------------------------------- probe

__global__ void tp_keys(const TableArgs a) {
  const int64_t i = (int64_t)blockIdx.x * T1 + threadIdx.x;
  if (i < a.T) {
    const bool live = a.t.valid[i] && !a.t.nulls[a.attr][i];
    const int64_t v = siddhi::load_col(a.t.cols[a.attr], a.key_type, i);
    const int64_t e = live ? ks::enc_key(v, a.key_type) : a.big;
    a.sort.keys[i] = (int64_t)ks::sortable(e, a.key_type);
    a.sort.pad[i] = !live;
    if (live) atomicAdd((unsigned long long*)a.sort.n_live, 1ull);
  }
  if (i < a.B) {
    Slot k;
    pairs::run(a.cond, a.ev, i, a.t, 0, &k);
    a.hk[i] = (int64_t)ks::sortable(ks::enc_key(k.v, a.key_type),
                                    a.key_type);
    a.adding[i] = a.mask[i] && !k.null;
  }
}

enum { OP_EQ_ = 0, OP_LT_, OP_LE_, OP_GT_, OP_GE_ };

__global__ void tp_bands(const TableArgs a) {
  const int64_t b = (int64_t)blockIdx.x * T1 + threadIdx.x;
  if (b >= a.B) return;
  const int64_t nl = *a.sort.n_live;
  const uint64_t v = (uint64_t)a.hk[b];
  int64_t lo, hi;
  switch (a.op) {
    case OP_EQ_:
      lo = ks::bisect(a.sort.sk, a.T, a.levels, v, true);
      hi = ks::bisect(a.sort.sk, a.T, a.levels, v, false);
      break;
    case OP_LT_:
      lo = 0;
      hi = ks::bisect(a.sort.sk, a.T, a.levels, v, true);
      break;
    case OP_LE_:
      lo = 0;
      hi = ks::bisect(a.sort.sk, a.T, a.levels, v, false);
      break;
    case OP_GT_:
      lo = ks::bisect(a.sort.sk, a.T, a.levels, v, false);
      hi = nl;
      break;
    default:
      lo = ks::bisect(a.sort.sk, a.T, a.levels, v, true);
      hi = nl;
      break;
  }
  lo = lo < nl ? lo : nl;
  hi = hi < nl ? hi : nl;
  const bool act = a.adding[b];
  if (!act) hi = lo;
  const bool hit = act && hi > lo;
  a.any_hit[b] = hit;
  if (hit) {
    atomicAdd(&a.delta[lo], 1);
    atomicAdd(&a.delta[hi], -1);
  }
}

// one block: the coverage of the sorted positions, back through the order
__global__ void tp_cover(const TableArgs a) {
  __shared__ int64_t buf[SS_BLOCK];
  int64_t lo, hi, n = 0;
  ss::span(a.T, &lo, &hi);
  for (int64_t j = lo; j < hi; ++j) n += a.delta[j];
  int64_t run = ss::block_scan_sum(n, buf, nullptr) - n;
  for (int64_t j = lo; j < hi; ++j) {
    run += a.delta[j];
    const int32_t t = a.sort.order[j];
    a.touched[t] = run > 0 && a.t.valid[t];
  }
}

// --------------------------------------------------------------- buffer

__global__ void tb_keys(const TableArgs a) {
  const int64_t t = (int64_t)blockIdx.x * T1 + threadIdx.x;
  if (t >= a.T) return;
  const int64_t k = a.t.valid[t] ? a.t.seq[t] : POS_INF;
  a.sort.keys[t] = (int64_t)ks::sortable(k, VT_LONG);
}

__global__ void tb_gather(const TableArgs a) {
  const int64_t j = (int64_t)blockIdx.x * T1 + threadIdx.x;
  if (j >= a.T) return;
  const int32_t t = a.sort.order[j];
  for (int c = 0; c < a.n_cols; ++c) {
    pairs::copy_elem(a.o.cols[c], j, a.t.cols[c], t, a.col_size[c]);
    a.o.nulls[c][j] = a.t.nulls[c][t];
  }
  a.o.ts[j] = a.t.ts[t];
  a.o.seq[j] = a.t.seq[t];
  a.o.valid[j] = a.t.valid[t];
}

}  // namespace

extern "C" cudaError_t siddhi_table_write(const TableArgs* p,
                                          cudaStream_t stream) {
  const TableArgs& a = *p;
  const int64_t n = a.T > a.B ? a.T : a.B;
  tw_copy<<<grid(a.T), T1, 0, stream>>>(a);
  tw_hash<<<grid(n), T1, 0, stream>>>(a);
  if (a.n_pk) {
    tw_hit<<<grid(a.B), T1, 0, stream>>>(a);
    tw_replace<<<grid(a.T), T1, 0, stream>>>(a);
  }
  tw_ranks<<<1, SS_BLOCK, 0, stream>>>(a);
  tw_append<<<grid(a.B), T1, 0, stream>>>(a);
  tw_finish<<<1, 1, 0, stream>>>(a);
  return cudaGetLastError();
}

extern "C" cudaError_t siddhi_table_match(const TableArgs* p,
                                          cudaStream_t stream) {
  const TableArgs& a = *p;
  if (a.mode != 0) tm_rows<<<grid((int64_t)a.T * 32), T1, 0, stream>>>(a);
  tm_events<<<grid((int64_t)a.B * 32), T1, 0, stream>>>(a);
  return cudaGetLastError();
}

extern "C" cudaError_t siddhi_table_probe(const TableArgs* p,
                                          cudaStream_t stream) {
  const TableArgs& a = *p;
  cudaMemsetAsync(a.sort.n_live, 0, sizeof(int64_t), stream);
  cudaMemsetAsync(a.delta, 0, sizeof(int32_t) * (a.T + 1), stream);
  const int64_t n = a.T > a.B ? a.T : a.B;
  tp_keys<<<grid(n), T1, 0, stream>>>(a);
  const int bits = ks::wide(a.key_type) ? 64 : 32;
  cudaError_t err = ks::sort_rows(a.sort, a.T, bits, a.sort.pad, stream);
  if (err != cudaSuccess) return err;
  tp_bands<<<grid(a.B), T1, 0, stream>>>(a);
  tp_cover<<<1, SS_BLOCK, 0, stream>>>(a);
  return cudaGetLastError();
}

extern "C" cudaError_t siddhi_table_buffer(const TableArgs* p,
                                           cudaStream_t stream) {
  const TableArgs& a = *p;
  tb_keys<<<grid(a.T), T1, 0, stream>>>(a);
  cudaError_t err = ks::sort_rows(a.sort, a.T, 64, nullptr, stream);
  if (err != cudaSuccess) return err;
  tb_gather<<<grid(a.T), T1, 0, stream>>>(a);
  return cudaGetLastError();
}
