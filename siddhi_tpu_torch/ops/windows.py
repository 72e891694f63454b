"""Window operators (PyTorch port of siddhi_tpu/ops/windows.py): kernel
K5 of PERF.md.

A window holds a struct-of-arrays buffer of capacity W with increasing
arrival sequence numbers. One step consumes a whole input batch:

  1. a "pool" = buffered rows ++ the batch's arrivals,
  2. per pool row, the input row at which it is emitted (expiry,
     eviction, flush): a search over the batch's running event time,
     or the row of the k-th CURRENT arrival,
  3. the output rows ordered by (emit row, phase) with ties in seq
     order, EXPIRED rows before their triggering CURRENT row
     (TimeWindowProcessor.java:141-152),
  4. the newest kept pool rows as the next buffer.

Reference mapping (modules/siddhi-core/.../query/processor/stream/window/):
TimeWindowProcessor -> TimeWindowOp, LengthWindowProcessor ->
LengthWindowOp, LengthBatchWindowProcessor -> LengthBatchWindowOp,
TimeBatchWindowProcessor -> TimeBatchWindowOp. The reference's second
wave (siddhi_tpu/ops/windows2.py) is in ops/windows2.py: externalTime,
timeLength, delay, batch, externalTimeBatch and hopping run on K5 too;
the sort window, frequent and lossyFrequent, and session have kernels
of their own; cron is K5's kind 11 (kernel K5c).

``window_step`` is K5. For tensors on the CPU it runs the window's
``step_ref``, the plain PyTorch version, which follows the reference's
``step`` line by line (stable argsorts where it sorts). For CUDA tensors
it launches csrc/window_step.cu: the marks, a stable counting sort of
the emission keys (emit_row * 4 + phase, bounded by 4B), the output
gather, and the newest-`cap` compaction by prefix sum, with no library
sort and no host sync.

Overflow: the reference's queues are unbounded; here capacity is fixed.
When live contents exceed W the oldest rows are dropped and
``state['overflow']`` counts them.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import _kernels
from ..core.event import CURRENT, EXPIRED, RESET, EventBatch, StreamSchema
from ..core.types import col_zeros, row_bytes
from .expr import CompileError
from .operators import Operator
from .sentinels import I32_MAX, NEG_INF, POS_INF
from .slots import part_moves, per_slot

I64 = torch.int64


def _full(n, v, dtype, dev):
    return torch.full((n,), int(v), dtype=dtype, device=dev)


def _i64(v, dev):
    return torch.as_tensor(v, dtype=I64, device=dev)


# ---------------------------------------------------------------------------
# buffer helpers
# ---------------------------------------------------------------------------


def empty_buffer(schema: StreamSchema, cap: int, device="cpu") -> dict:
    return {
        "ts": torch.zeros((cap,), dtype=I64, device=device),
        "seq": torch.zeros((cap,), dtype=I64, device=device),
        "cols": tuple(col_zeros(t, cap, device) for t in schema.types),
        "nulls": tuple(torch.zeros((cap,), dtype=torch.bool, device=device)
                       for _ in schema.types),
        "valid": torch.zeros((cap,), dtype=torch.bool, device=device),
    }


def _gather_buffer(pool: dict, idx, valid) -> dict:
    return {
        "ts": pool["ts"][idx],
        "seq": pool["seq"][idx],
        "cols": tuple(c[idx] for c in pool["cols"]),
        "nulls": tuple(n[idx] for n in pool["nulls"]),
        "valid": valid,
    }


def make_pool(buf: dict, batch: EventBatch, arrival_seq,
              arrival_valid) -> dict:
    """Buffered rows ++ the batch's arriving rows."""
    return {
        "ts": torch.cat([buf["ts"], batch.ts]),
        "seq": torch.cat([buf["seq"], arrival_seq]),
        "cols": tuple(torch.cat([b, c])
                      for b, c in zip(buf["cols"], batch.cols)),
        "nulls": tuple(torch.cat([b, c])
                       for b, c in zip(buf["nulls"], batch.nulls)),
        "valid": torch.cat([buf["valid"], arrival_valid]),
    }


def keep_newest(pool: dict, keep_mask, cap: int):
    """The newest (by seq) ``cap`` rows where keep_mask -> (buffer of
    size cap in seq order, overflow count). The pool's kept rows are in
    ascending seq order (buffer, then arrivals), so one prefix sum ranks
    them and one search places the newest ``cap``: the reference's region
    path (keep_newest with presorted=True), garbage rows included."""
    n = pool["seq"].shape[0]
    dev = pool["seq"].device
    keep = keep_mask & pool["valid"]
    c = torch.cumsum(keep.to(torch.int32), 0, dtype=torch.int32)
    total = c[n - 1]
    j = torch.arange(cap, dtype=torch.int32, device=dev)
    r = total - cap + j
    take = torch.clamp(torch.searchsorted(c, r + 1, side="left"), 0, n - 1)
    overflow = torch.clamp(total - cap, min=0).to(I64)
    return _gather_buffer(pool, take, r >= 0), overflow


def emission_sort(out: dict, emit_row, phase, valid,
                  out_cap: int) -> EventBatch:
    """Order output rows by (emit_row, phase), invalid rows last: one
    stable argsort. Rows with equal (emit_row, phase) must already be in
    seq order in ``out`` (the steps concatenate seq-sorted segments)."""
    primary = torch.where(valid, (emit_row * 4 + phase).to(torch.int32),
                          torch.full_like(valid, int(I32_MAX),
                                          dtype=torch.int32))
    idx = torch.argsort(primary, stable=True)[:out_cap]
    return EventBatch(ts=out["ts"][idx],
                      cols=tuple(c[idx] for c in out["cols"]),
                      nulls=tuple(nu[idx] for nu in out["nulls"]),
                      kind=out["kind"][idx], valid=valid[idx])


def emission_sort_slots(out: dict, emit_row, phase, valid,
                        out_cap: int) -> EventBatch:
    """``emission_sort`` of every slot at once: each argument carries the
    leading slot axis, and each slot's rows are ordered alone (one
    stable argsort along the row axis)."""
    primary = torch.where(valid, (emit_row * 4 + phase).to(torch.int32),
                          torch.full_like(valid, int(I32_MAX),
                                          dtype=torch.int32))
    idx = torch.argsort(primary, dim=1, stable=True)[:, :out_cap]

    def take(x):
        x = x.expand(valid.shape + tuple(x.shape[2:]))
        i = idx.reshape(idx.shape + (1,) * (x.dim() - 2))
        return torch.take_along_dim(x, i.expand(idx.shape + x.shape[2:]),
                                    dim=1)
    return EventBatch(ts=take(out["ts"]),
                      cols=tuple(take(c) for c in out["cols"]),
                      nulls=tuple(take(nu) for nu in out["nulls"]),
                      kind=take(out["kind"]), valid=take(valid))


def running_time(batch: EventBatch):
    """Per-row event time: the cumulative max of valid rows' timestamps."""
    ts = torch.where(batch.valid, batch.ts, torch.full_like(batch.ts,
                                                            int(NEG_INF)))
    return torch.cummax(ts, 0).values


def arrival_seqs(batch: EventBatch, next_seq):
    """Consecutive seq numbers for the CURRENT rows."""
    cur = batch.valid & (batch.kind == CURRENT)
    offs = torch.cumsum(cur.to(I64), 0) - 1
    seq = torch.where(cur, next_seq + offs, torch.full_like(offs,
                                                            int(NEG_INF)))
    return cur, seq, next_seq + cur.sum(dtype=I64)


def current_row_positions(cur, B: int):
    """Row index of the k-th CURRENT row (for k past the last one: the
    other rows in order; callers mask those)."""
    rows = torch.arange(B, dtype=torch.int32, device=cur.device)
    return torch.argsort(torch.where(cur, rows, int(I32_MAX)), stable=True)


def _kinds(dev, *parts):
    return torch.cat([_full(n, k, torch.int32, dev) for n, k in parts])


class WindowOp(Operator):
    """Base: windows preserve the input schema.

    is_batch mirrors the reference's ProcessingMode.BATCH: the selector
    then emits one result per flush chunk."""

    is_batch = False
    sort_heavy = True
    # batch windows flush one boundary a step and need a timer for each;
    # sliding windows expire per row inside the event step
    needs_catchup = True
    fifo_expiry = True
    host_due_bound = None
    KIND = -1      # csrc/window_step.cu's kind code
    LAUNCH = "window_step"   # its launches' counter (_kernels.LAUNCHES)
    LAUNCH_K = "window_step[K]"   # the same over a slot axis
    # K5's state buffers (A, E): the buffer or current batch, and the
    # expired batch (None where the window keeps none)
    buf_keys = ("buf", None)

    def out_capacity(self, B: int) -> int:
        """Rows of K5's output for a B-row batch (the reference's
        out_cap): a sliding window's expired pool rows and arrivals."""
        return self.cap + 2 * B

    def __init__(self, schema: StreamSchema, expired_enabled: bool = True):
        self.schema = schema
        self.expired_enabled = expired_enabled

    @property
    def out_schema(self):
        return self.schema

    def next_due(self, state) -> Optional[torch.Tensor]:
        """Earliest pending timer (int64 0-d tensor, POS_INF if none), or
        None if this window never needs timer wakeups."""
        return None

    def step(self, state, batch: EventBatch, now):
        return window_step(self, state, batch, now)

    def step_slots_ref(self, state, batch: EventBatch, now):
        """Plain version over a slot axis: ``step_ref`` once per slot."""
        return per_slot(lambda st, b: self.step_ref(st, b, now),
                        batch.ts.shape[0], state, batch)

    def findable_buffer(self, state, device=None) -> dict:
        """The window content a join or table find() searches (the
        reference's expiredEventQueue handed to OperatorParser,
        e.g. TimeWindowProcessor.java:172-184). ``device``: where a
        window that keeps no state makes its empty buffer."""
        raise CompileError(
            f"window '{type(self).__name__}' is not findable (cannot be "
            "used in joins)")


# ---------------------------------------------------------------------------
# sliding windows
# ---------------------------------------------------------------------------


class TimeWindowOp(WindowOp):
    """#window.time(T): keep each event T ms; on expiry emit it as EXPIRED
    with its timestamp set to the running time that expired it, before
    the triggering current event."""

    needs_catchup = False
    kind_name = "time"
    KIND = 0

    def __init__(self, schema, duration_ms: int, cap: int = 4096,
                 expired_enabled: bool = True):
        super().__init__(schema, expired_enabled)
        self.T = int(duration_ms)
        self.cap = int(cap)

    def init_state(self, device="cpu"):
        return {"buf": empty_buffer(self.schema, self.cap, device),
                "next_seq": _i64(0, device), "overflow": _i64(0, device)}

    def step_ref(self, state, batch: EventBatch, now):
        B, W = batch.capacity, self.cap
        dev = batch.ts.device
        cur, seq, next_seq = arrival_seqs(batch, state["next_seq"])
        rt = running_time(batch)
        pool = make_pool(state["buf"], batch, seq, cur)
        P = W + B
        expire_row = torch.searchsorted(rt, pool["ts"] + self.T, side="left")
        own_row = torch.cat([_full(W, -1, I64, dev),
                             torch.arange(B, dtype=I64, device=dev)])
        expire_row = torch.maximum(expire_row, own_row + 1)
        expires_here = pool["valid"] & (expire_row < B)
        exp_row_safe = torch.clamp(expire_row, 0, B - 1)
        out = {"ts": torch.cat([rt[exp_row_safe], batch.ts]),
               "cols": tuple(torch.cat([pc, bc]) for pc, bc in
                             zip(pool["cols"], batch.cols)),
               "nulls": tuple(torch.cat([pn, bn]) for pn, bn in
                              zip(pool["nulls"], batch.nulls)),
               "kind": _kinds(dev, (P, EXPIRED), (B, CURRENT))}
        emit_row = torch.cat([exp_row_safe,
                              torch.arange(B, dtype=I64, device=dev)])
        phase = torch.cat([_full(P, 0, I64, dev), _full(B, 2, I64, dev)])
        exp_valid = expires_here if self.expired_enabled \
            else torch.zeros_like(expires_here)
        valid = torch.cat([exp_valid, cur])
        result = emission_sort(out, emit_row, phase, valid, P + B)
        buf, overflow = keep_newest(pool, ~expires_here, W)
        return ({"buf": buf, "next_seq": next_seq,
                 "overflow": state["overflow"] + overflow}, result)

    def next_due(self, state):
        buf = state["buf"]
        due = torch.where(buf["valid"], buf["ts"] + self.T,
                          torch.full_like(buf["ts"], int(POS_INF)))
        return due.amin(-1)   # [K] dues inside a partition block

    def host_due_bound(self, ts_min: int) -> int:
        return ts_min + self.T

    def findable_buffer(self, state, device=None):
        return state["buf"]


class LengthWindowOp(WindowOp):
    """#window.length(L): keep the last L events; arrival L+k evicts
    arrival k as EXPIRED (timestamp: the processing time), before the
    current event."""

    kind_name = "length"
    KIND = 1

    def __init__(self, schema, length: int, expired_enabled: bool = True):
        super().__init__(schema, expired_enabled)
        if length < 0:
            raise CompileError("length window requires length >= 0")
        self.L = int(length)

    @property
    def cap(self):
        return max(self.L, 1)

    def out_capacity(self, B: int) -> int:
        """length(0) emits each arrival and its expiry."""
        return 3 * B if self.L == 0 else self.cap + 2 * B

    def init_state(self, device="cpu"):
        return {"buf": empty_buffer(self.schema, self.cap, device),
                "next_seq": _i64(0, device)}

    def step_ref(self, state, batch: EventBatch, now):
        B, L = batch.capacity, self.L
        dev = batch.ts.device
        cur, seq, next_seq = arrival_seqs(batch, state["next_seq"])
        rows = torch.arange(B, dtype=I64, device=dev)
        if L == 0:
            # every event -> CURRENT, then its EXPIRED clone, then RESET
            out = {"ts": torch.cat([batch.ts] * 3),
                   "cols": tuple(torch.cat([c] * 3) for c in batch.cols),
                   "nulls": tuple(torch.cat([n] * 3) for n in batch.nulls),
                   "kind": _kinds(dev, (B, CURRENT), (B, EXPIRED),
                                  (B, RESET))}
            emit_row = torch.cat([rows] * 3)
            phase = torch.cat([_full(B, 2, I64, dev), _full(B, 3, I64, dev),
                               _full(B, 3, I64, dev)])
            exp_on = cur if self.expired_enabled else torch.zeros_like(cur)
            valid = torch.cat([cur, exp_on, cur])
            return ({"buf": state["buf"], "next_seq": next_seq},
                    emission_sort(out, emit_row, phase, valid, 3 * B))
        pool = make_pool(state["buf"], batch, seq, cur)
        P = pool["seq"].shape[0]
        evicted = pool["valid"] & (pool["seq"] <= next_seq - 1 - L)
        cur_rows = current_row_positions(cur, B)
        k = torch.clamp(pool["seq"] + L - state["next_seq"], 0, B - 1)
        now_col = _i64(now, dev).expand(P)
        out = {"ts": torch.cat([now_col, batch.ts]),
               "cols": tuple(torch.cat([pc, bc]) for pc, bc in
                             zip(pool["cols"], batch.cols)),
               "nulls": tuple(torch.cat([pn, bn]) for pn, bn in
                              zip(pool["nulls"], batch.nulls)),
               "kind": _kinds(dev, (P, EXPIRED), (B, CURRENT))}
        emit_row = torch.cat([cur_rows[k].to(I64), rows])
        phase = torch.cat([_full(P, 0, I64, dev), _full(B, 2, I64, dev)])
        exp_valid = evicted if self.expired_enabled \
            else torch.zeros_like(evicted)
        valid = torch.cat([exp_valid, cur])
        result = emission_sort(out, emit_row, phase, valid, P + B)
        buf, _ = keep_newest(pool, ~evicted, self.cap)
        return ({"buf": buf, "next_seq": next_seq}, result)


# ---------------------------------------------------------------------------
# batch (tumbling) windows
# ---------------------------------------------------------------------------


LengthWindowOp.findable_buffer = TimeWindowOp.findable_buffer


def _batch_findable(self, state, device=None):
    """A batch window's findable content: the current batch in
    stream-current mode, else the last flushed one."""
    return state["cur"] if self.stream_current else state["exp"]


def _select(cond, a: dict, b: dict) -> dict:
    """where(cond, a, b) over two buffers."""
    def w(x, y):
        return torch.where(cond, x, y)
    return {"ts": w(a["ts"], b["ts"]), "seq": w(a["seq"], b["seq"]),
            "cols": tuple(w(x, y) for x, y in zip(a["cols"], b["cols"])),
            "nulls": tuple(w(x, y) for x, y in zip(a["nulls"], b["nulls"])),
            "valid": w(a["valid"], b["valid"])}


class LengthBatchWindowOp(WindowOp):
    """#window.lengthBatch(L): tumbling count window. When the L-th event
    of a batch arrives: the previous batch as EXPIRED (timestamp: now),
    RESET, this batch as CURRENT. With stream.current.event, currents go
    out on arrival and a batch expires at its own flush."""

    kind_name = "lengthBatch"
    is_batch = True
    KIND = 2
    buf_keys = ("cur", "exp")

    def __init__(self, schema, length: int, expired_enabled: bool = True,
                 stream_current: bool = False):
        super().__init__(schema, expired_enabled)
        if length <= 0:
            raise CompileError("lengthBatch window requires length > 0")
        self.L = int(length)
        self.stream_current = bool(stream_current)

    @property
    def cap(self):
        return self.L

    def out_capacity(self, B: int) -> int:
        """The expired batch, and three segments over the pool."""
        return self.cap + 3 * (self.cap + B)

    def init_state(self, device="cpu"):
        return {"cur": empty_buffer(self.schema, self.L, device),
                "exp": empty_buffer(self.schema, self.L, device),
                "next_seq": _i64(0, device)}

    def step_ref(self, state, batch: EventBatch, now):
        B, L = batch.capacity, self.L
        dev = batch.ts.device
        ns0 = state["next_seq"]
        cur, seq, next_seq = arrival_seqs(batch, ns0)
        pool = make_pool(state["cur"], batch, seq, cur)
        P = pool["seq"].shape[0]
        EB = state["exp"]["seq"].shape[0]
        cur_rows = current_row_positions(cur, B)

        def row_of(s):
            return cur_rows[torch.clamp(s - ns0, 0, B - 1)].to(I64)

        batch_of = torch.where(pool["valid"],
                               torch.div(pool["seq"], L,
                                         rounding_mode="floor"),
                               torch.full_like(pool["seq"], -1))
        first_batch = torch.div(ns0, L, rounding_mode="floor")
        last_complete = torch.div(next_seq, L, rounding_mode="floor")
        flushed = pool["valid"] & (batch_of < last_complete)
        any_flush = last_complete > first_batch
        flush_seq = (batch_of + 1) * L - 1
        flush_row = row_of(flush_seq)
        first_flush_row = row_of((first_batch + 1) * L - 1)
        exp_next_row = row_of((batch_of + 2) * L - 1)
        pool_expires = flushed & (batch_of + 1 < last_complete)
        is_batch_tail = flushed & (pool["seq"] == flush_seq)

        now_t = _i64(now, dev)
        out = {"ts": torch.cat([now_t.expand(EB), now_t.expand(P),
                                pool["ts"], now_t.expand(P)]),
               "cols": tuple(torch.cat([ec, pc, pc, pc]) for ec, pc in
                             zip(state["exp"]["cols"], pool["cols"])),
               "nulls": tuple(torch.cat([en, pn, pn, pn]) for en, pn in
                              zip(state["exp"]["nulls"], pool["nulls"])),
               "kind": _kinds(dev, (EB, EXPIRED), (P, EXPIRED),
                              (P, CURRENT), (P, RESET))}
        zero = torch.zeros_like(flush_row)
        arr_row = row_of(pool["seq"])
        if self.stream_current:
            cur_row_src = arr_row
            exp_row_src = torch.where(flushed, flush_row, zero)
        else:
            cur_row_src = torch.where(flushed, flush_row, zero)
            exp_row_src = torch.where(pool_expires, exp_next_row, zero)
        emit_row = torch.cat([first_flush_row.expand(EB), exp_row_src,
                              cur_row_src,
                              torch.where(is_batch_tail, flush_row, zero)])
        phase = torch.cat([_full(EB, 0, I64, dev), _full(P, 0, I64, dev),
                           _full(P, 2, I64, dev), _full(P, 1, I64, dev)])
        no_eb = torch.zeros((EB,), dtype=torch.bool, device=dev)
        no_p = torch.zeros((P,), dtype=torch.bool, device=dev)
        if self.expired_enabled:
            exp_carry_valid = state["exp"]["valid"] & any_flush
            exp_pool_valid = pool_expires
        else:
            exp_carry_valid, exp_pool_valid = no_eb, no_p
        arrivals = pool["valid"] & (pool["seq"] >= ns0)
        cur_valid = arrivals if self.stream_current else flushed
        if self.stream_current:
            exp_carry_valid = no_eb
            exp_pool_valid = flushed if self.expired_enabled else no_p
        valid = torch.cat([exp_carry_valid, exp_pool_valid, cur_valid,
                           is_batch_tail])
        result = emission_sort(out, emit_row, phase, valid, EB + 3 * P)

        pending = pool["valid"] & (batch_of >= last_complete)
        new_cur, _ = keep_newest(pool, pending, L)
        last_batch = pool["valid"] & (batch_of == last_complete - 1)
        new_exp_pool, _ = keep_newest(pool, last_batch, L)
        new_exp = _select(any_flush, new_exp_pool, state["exp"])
        return ({"cur": new_cur, "exp": new_exp, "next_seq": next_seq},
                result)


class TimeBatchWindowOp(WindowOp):
    """#window.timeBatch(T [, startTime]): tumbling time window. The flush
    is decided once per input batch (now >= next emit time): the expired
    previous batch (timestamp: now), RESET, the buffered batch with this
    batch's arrivals."""

    kind_name = "timeBatch"
    is_batch = True
    KIND = 3
    buf_keys = ("cur", "exp")

    def __init__(self, schema, duration_ms: int,
                 start_time: Optional[int] = None, cap: int = 4096,
                 expired_enabled: bool = True, stream_current: bool = False):
        super().__init__(schema, expired_enabled)
        self.T = int(duration_ms)
        self.start_time = start_time
        self.cap = int(cap)
        self.stream_current = bool(stream_current)

    def out_capacity(self, B: int) -> int:
        """The expired batch, the pool, the reset row, and the
        stream-current copies."""
        P = self.cap + B
        return self.cap + P + 1 + (P if self.stream_current else 0)

    def init_state(self, device="cpu"):
        return {"cur": empty_buffer(self.schema, self.cap, device),
                "exp": empty_buffer(self.schema, self.cap, device),
                "next_seq": _i64(0, device), "next_emit": _i64(-1, device),
                "overflow": _i64(0, device)}

    def step_ref(self, state, batch: EventBatch, now):
        B, W = batch.capacity, self.cap
        dev = batch.ts.device
        now = _i64(now, dev)
        cur, seq, next_seq = arrival_seqs(batch, state["next_seq"])
        if self.start_time is not None:
            init_emit = now - torch.remainder(now - self.start_time,
                                              self.T) + self.T
        else:
            init_emit = now + self.T
        next_emit = torch.where(state["next_emit"] == -1, init_emit,
                                state["next_emit"])
        send = now >= next_emit
        next_emit = torch.where(send, next_emit + self.T, next_emit)

        pool = make_pool(state["cur"], batch, seq, cur)
        P, EB = W + B, W
        out = {"ts": torch.cat([now.expand(EB), pool["ts"], now.expand(1)]),
               "cols": tuple(torch.cat([ec, pc, pc[:1]]) for ec, pc in
                             zip(state["exp"]["cols"], pool["cols"])),
               "nulls": tuple(torch.cat([en, pn, pn[:1]]) for en, pn in
                              zip(state["exp"]["nulls"], pool["nulls"])),
               "kind": _kinds(dev, (EB, EXPIRED), (P, CURRENT), (1, RESET))}
        emit_row = _full(EB + P + 1, 0, I64, dev)
        phase = torch.cat([_full(EB, 0, I64, dev), _full(P, 2, I64, dev),
                           _full(1, 1, I64, dev)])
        had_pending = pool["valid"].any()
        exp_valid = (state["exp"]["valid"] & send) if self.expired_enabled \
            else torch.zeros((EB,), dtype=torch.bool, device=dev)
        arrivals = pool["valid"] & (pool["seq"] >= state["next_seq"])
        cur_valid = arrivals if self.stream_current \
            else (pool["valid"] & send)
        valid = torch.cat([exp_valid, cur_valid, (send & had_pending)[None]])
        if self.stream_current:
            exp_now = pool["valid"] & send
            if not self.expired_enabled:
                exp_now = torch.zeros_like(exp_now)
            out = {"ts": torch.cat([out["ts"], now.expand(P)]),
                   "cols": tuple(torch.cat([oc, pc]) for oc, pc in
                                 zip(out["cols"], pool["cols"])),
                   "nulls": tuple(torch.cat([on, pn]) for on, pn in
                                  zip(out["nulls"], pool["nulls"])),
                   "kind": torch.cat([out["kind"],
                                      _full(P, EXPIRED, torch.int32, dev)])}
            emit_row = torch.cat([emit_row, _full(P, 0, I64, dev)])
            phase = torch.cat([phase, _full(P, 0, I64, dev)])
            valid = torch.cat([torch.zeros((EB,), dtype=torch.bool,
                                           device=dev), valid[EB:], exp_now])
        cap_out = EB + P + 1 + (P if self.stream_current else 0)
        result = emission_sort(out, emit_row, phase, valid, cap_out)

        new_cur_flush, _ = keep_newest(pool, torch.zeros_like(pool["valid"]),
                                       W)
        new_cur_keep, overflow = keep_newest(pool, pool["valid"], W)
        new_exp_flush = new_cur_keep
        new_cur = _select(send, new_cur_flush, new_cur_keep)
        new_exp = _select(send, new_exp_flush, state["exp"])
        return ({"cur": new_cur, "exp": new_exp, "next_seq": next_seq,
                 "next_emit": next_emit,
                 "overflow": state["overflow"] + overflow}, result)

    def next_due(self, state):
        ne = state["next_emit"]
        return torch.where(ne == -1, torch.full_like(ne, int(POS_INF)), ne)


LengthBatchWindowOp.findable_buffer = _batch_findable
TimeBatchWindowOp.findable_buffer = _batch_findable


class EmptyWindowOp(WindowOp):
    """The default window of a join side declared without one
    (JoinInputStreamParser.java:416, EmptyWindowProcessor; reference
    siddhi_tpu/ops/windows2.py:1442): CURRENT rows pass, each followed
    by its EXPIRED clone at ``now`` when expired output is on, and
    nothing is kept: the side triggers the cross and is never found."""

    kind_name = "empty"
    KIND = 4

    def out_capacity(self, B: int) -> int:
        """Each arrival and its expiry."""
        return 2 * B

    def init_state(self, device="cpu"):
        return ()

    def step(self, state, batch: EventBatch, now):
        if not self.expired_enabled:
            return state, batch.mask(batch.valid & (batch.kind == CURRENT))
        return window_step(self, state, batch, now)

    def step_ref(self, state, batch: EventBatch, now):
        B = batch.capacity
        dev = batch.ts.device
        cur = batch.valid & (batch.kind == CURRENT)
        out = {"ts": torch.cat([batch.ts, _i64(now, dev).expand(B)]),
               "cols": tuple(torch.cat([c, c]) for c in batch.cols),
               "nulls": tuple(torch.cat([n, n]) for n in batch.nulls),
               "kind": _kinds(dev, (B, CURRENT), (B, EXPIRED))}
        rows = torch.arange(B, dtype=I64, device=dev)
        phase = torch.cat([_full(B, 2, I64, dev), _full(B, 3, I64, dev)])
        return state, emission_sort(out, torch.cat([rows, rows]), phase,
                                    torch.cat([cur, cur]), 2 * B)

    def findable_buffer(self, state, device=None):
        return empty_buffer(self.schema, 1, device or "cpu")


# ---------------------------------------------------------------------------
# kernel K5 and its plain version
# ---------------------------------------------------------------------------


def window_step_ref(op: WindowOp, state, batch: EventBatch, now):
    """Plain PyTorch version of kernel K5: -> (state', output batch)."""
    return op.step_ref(state, batch, now)


def window_step(op: WindowOp, state, batch: EventBatch, now):
    """Kernel K5: one window step over a batch -> (state', output batch).
    A batch on the CPU takes the plain version; a CUDA batch launches
    csrc/window_step.cu (one call, a fixed sequence of launches, no host
    sync). ``now``: an int or an int64 0-d tensor.

    Inside a partition block the state and the batch carry the slot axis
    (ops/slots.py): the plain version is ``op.step_slots_ref``, the
    kernel runs once with a row of thread blocks (or one block) per
    slot, counted as ``op.LAUNCH_K``."""
    dev = batch.ts.device
    slotted = batch.ts.dim() == 2
    if dev.type == "cpu":
        if slotted:
            return op.step_slots_ref(state, batch, now)
        return window_step_ref(op, state, batch, now)
    if dev.type != "cuda":
        raise ValueError(f"window_step: unsupported device {dev}")
    new_state, out, args = window_args(op, state, batch, _i64(now, dev))
    _kernels.load().window_step(args,
                                torch.cuda.current_stream(dev).cuda_stream)
    _kernels.count_launch(op.LAUNCH_K if slotted else op.LAUNCH)
    return new_state, out


def _bufs(op: WindowOp, state, dev, K=None):
    """(A, E): the window's buffers (E None for the sliding windows; the
    empty window's A is a one-row stand-in K5 never reads, one a slot
    inside a partition block)."""
    if isinstance(op, EmptyWindowOp):
        a = empty_buffer(op.schema, 1, dev)
        if K is not None:
            from .slots import stacked
            a = stacked(a, K)
        return a, None
    ka, ke = op.buf_keys
    return state[ka], (state[ke] if ke is not None else None)


def _win_buf(wb, ts, seq, cols, nulls, valid) -> None:
    wb.ts = ts.data_ptr()
    wb.seq = seq.data_ptr() if seq is not None else None
    for k, (c, n) in enumerate(zip(cols, nulls)):
        wb.cols[k] = c.data_ptr()
        wb.nulls[k] = n.data_ptr()
    wb.valid = valid.data_ptr()


def _empty_like_buf(buf: dict) -> dict:
    return {"ts": torch.empty_like(buf["ts"]),
            "seq": torch.empty_like(buf["seq"]),
            "cols": tuple(torch.empty_like(c) for c in buf["cols"]),
            "nulls": tuple(torch.empty_like(n) for n in buf["nulls"]),
            "valid": torch.empty_like(buf["valid"])}


def window_args(op: WindowOp, state, batch: EventBatch, now):
    """K5's arguments: the new state's and the output batch's tensors
    (fresh), the scratch, and ``_kernels.WindowArgs`` pointing at them.
    -> (state', output batch, args). Inside a partition block (a [K, B]
    batch, a state a slot) every tensor gets the leading slot axis and
    ``n_part`` is K, with the slot strides in ``moves`` (ops/slots.py
    part_moves)."""
    dev = batch.ts.device
    slotted = batch.ts.dim() == 2
    K = batch.ts.shape[0] if slotted else None
    lead = (K,) if slotted else ()
    B, C = batch.ts.shape[-1], len(batch.cols)
    if C > _kernels.WIN_MAX_COLS:
        raise NotImplementedError(
            f"not ported yet: a window over more than "
            f"{_kernels.WIN_MAX_COLS} attributes ({C})")
    A, E = _bufs(op, state, dev, K)
    W = A["seq"].shape[-1]
    EB = 0 if E is None else E["seq"].shape[-1]
    P, N = W + B, op.out_capacity(B)
    S = EB + P
    na = _empty_like_buf(A)
    ne = _empty_like_buf(E) if E is not None else None
    nd = len(lead) + 1   # a column's dims before a set row's lanes

    def e(shape, dtype):
        return torch.empty(lead + shape, dtype=dtype, device=dev)
    out = EventBatch(ts=e((N,), I64),
                     cols=tuple(e((N,) + tuple(c.shape[nd:]), c.dtype)
                                for c in batch.cols),
                     nulls=tuple(e((N,), torch.bool) for _ in batch.cols),
                     kind=e((N,), torch.int32), valid=e((N,), torch.bool))
    new = {"next_seq": e((), I64)}
    for k in ("overflow", "next_emit", "next_hop", "start", "flushed",
              "sched", "last_ext"):
        if k in state:
            new[k] = torch.empty_like(state[k])

    def scratch(n, dtype):
        return e((max(int(n), 1),), dtype)
    blocks = (N + 1023) // 1024
    sc = {"b_seq": scratch(B, I64), "rt": scratch(B, I64),
          "cur_rows": scratch(B, torch.int32), "scal": scratch(32, I64),
          "keys": scratch(N, torch.int32), "k1": scratch(N, torch.int32),
          "k2": scratch(N, torch.int32), "i1": scratch(N, torch.int32),
          "i2": scratch(N, torch.int32), "order": scratch(N, torch.int32),
          "counts": scratch(256 * blocks, torch.int32),
          "cand_src": scratch(N, torch.int32), "cand_ts": scratch(N, I64),
          "cand_kind": scratch(N, torch.int32),
          "keep": scratch(2 * S, torch.uint8),
          "rank_pos": scratch(2 * S, torch.int32),
          "rank_of": scratch(2 * S, torch.int32),
          "pflag": scratch(P, torch.uint8)}
    a = _kernels.WindowArgs()
    _win_buf(a.batch, batch.ts, None, batch.cols, batch.nulls, batch.valid)
    a.batch_kind = batch.kind.data_ptr()
    _win_buf(a.a, A["ts"], A["seq"], A["cols"], A["nulls"], A["valid"])
    _win_buf(a.na, na["ts"], na["seq"], na["cols"], na["nulls"], na["valid"])
    if E is not None:
        _win_buf(a.e, E["ts"], E["seq"], E["cols"], E["nulls"], E["valid"])
        _win_buf(a.ne, ne["ts"], ne["seq"], ne["cols"], ne["nulls"],
                 ne["valid"])
    empty = isinstance(op, EmptyWindowOp)
    if empty:   # no state: a zero seq in, the seq out discarded
        sc["ns"] = torch.zeros(lead, dtype=I64, device=dev)
    a.next_seq = (sc["ns"] if empty else state["next_seq"]).data_ptr()
    a.o_next_seq = new["next_seq"].data_ptr()
    if "overflow" in state:
        a.overflow = state["overflow"].data_ptr()
        a.o_overflow = new["overflow"].data_ptr()
    for k, f in (("next_emit", "next_emit"), ("next_hop", "next_emit"),
                 ("start", "start"), ("flushed", "flushed"),
                 ("sched", "sched"), ("last_ext", "last_ext")):
        if k in state:
            setattr(a, f, state[k].data_ptr())
            setattr(a, "o_" + f, new[k].data_ptr())
    a.now = now.data_ptr()
    _win_buf(a.out, out.ts, None, out.cols, out.nulls, out.valid)
    a.out_kind = out.kind.data_ptr()
    for k, t in sc.items():
        setattr(a, k, t.data_ptr())
    for k, c in enumerate(batch.cols):
        a.col_size[k] = row_bytes(c[0] if slotted else c)
    a.n_cols, a.kind, a.B, a.W, a.EB, a.N, a.P, a.S = \
        C, op.KIND, B, W, EB, N, P, S
    a.n_part = K or 1
    a.expired_enabled = int(op.expired_enabled)
    a.stream_current = int(getattr(op, "stream_current", False))
    start = getattr(op, "start_time", None)
    a.has_start = int(start is not None)
    a.start_time = int(start or 0)
    a.length = int(getattr(op, "L", 0))
    a.span_ms = int(getattr(op, "T", getattr(op, "W_ms", 0)))
    a.hop_ms = int(getattr(op, "H_ms", 0))
    a.ts_idx = int(getattr(op, "ts_idx", -1))
    sa = getattr(op, "start_attr", None)
    a.start_attr = -1 if sa is None else int(sa)
    to = getattr(op, "timeout_ms", None)
    a.has_timeout = int(to is not None)
    a.timeout_ms = int(to or 0)
    a.replace_ts = int(getattr(op, "replace_ts", False))
    part_moves(a, (state, batch, A, E, na, ne, new, out, sc), dev)
    if empty:   # the seq out lives in the scratch, alive until launch
        sc["ns_out"] = new["next_seq"]
        new = ()
    else:
        ka, ke = op.buf_keys
        new[ka] = na
        if ke is not None:
            new[ke] = ne
    a._keep = (state, new, out, sc, now)   # alive until the launch is made
    return new, out, a
