"""Window operators, second wave (PyTorch port of siddhi_tpu/ops/
windows2.py): externalTime, timeLength, delay, batch, externalTimeBatch
and hopping on kernel K5's frame, and the sort window on a kernel of its
own.

Reference mapping (modules/siddhi-core/.../query/processor/stream/window/):
- ExternalTimeWindowProcessor.java:125-161      -> ExternalTimeWindowOp
- TimeLengthWindowProcessor.java:139-189        -> TimeLengthWindowOp
- DelayWindowProcessor.java:125-165             -> DelayWindowOp
- BatchWindowProcessor.java:122-195             -> BatchWindowOp
- SortWindowProcessor.java:152-183              -> SortWindowOp
- ExternalTimeBatchWindowProcessor.java:253-311 -> ExternalTimeBatchWindowOp
- HopingWindowProcessor.java:48                 -> HoppingWindowOp

Each ``step_ref`` is the plain PyTorch version and follows the
reference's ``step`` line by line. The K5-frame kinds run kernel K5
(csrc/window_step.cu) on a CUDA batch, as the first wave's windows do
(ops/windows.py window_step); the sort window runs csrc/window_seq.cu
(``sort_window_step``), one block walking the batch row by row as the
reference's ``lax.scan`` does.

The reference's documented deviation is kept: delay(0) releases at the
next step, not interleaved after the next in-chunk event.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import _kernels
from ..core.event import CURRENT, EXPIRED, RESET, TIMER, EventBatch
from ..core.types import AttrType
from .expr import CompileError
from .windows import (I64, NEG_INF, POS_INF, WindowOp, _full, _i64, _kinds,
                      _select, arrival_seqs, current_row_positions,
                      _win_buf, emission_sort, empty_buffer, keep_newest,
                      make_pool)

BIG = 2 ** 62


def _floordiv(x, d):
    return torch.div(x, d, rounding_mode="floor")


def _ext_running_time(batch: EventBatch, ts_idx: int):
    """Running external clock: the cumulative max of the ts attribute over
    valid CURRENT rows."""
    e = batch.cols[ts_idx].to(I64)
    e = torch.where(batch.valid & (batch.kind == CURRENT), e,
                    torch.full_like(e, int(NEG_INF)))
    return torch.cummax(e, 0).values


def _cat_out(ts, parts, kinds, dev):
    """An output dict from (cols, nulls) parts and (n, kind) runs."""
    return {"ts": torch.cat(ts),
            "cols": tuple(torch.cat(c) for c in zip(*[p[0] for p in parts])),
            "nulls": tuple(torch.cat(n) for n in zip(*[p[1] for p in parts])),
            "kind": _kinds(dev, *kinds)}


class ExternalTimeWindowOp(WindowOp):
    """#window.externalTime(tsAttr, T): a sliding window over an
    event-carried clock. An event expires when a later event's tsAttr
    reaches its own tsAttr + T; the expired clone's timestamp is that
    clock value and it is emitted before the triggering event."""

    needs_catchup = False
    kind_name = "externalTime"
    KIND = 5

    def __init__(self, schema, ts_idx: int, duration_ms: int,
                 cap: int = 4096, expired_enabled: bool = True):
        super().__init__(schema, expired_enabled)
        self.ts_idx = int(ts_idx)
        self.T = int(duration_ms)
        self.cap = int(cap)

    def init_state(self, device="cpu"):
        return {"buf": empty_buffer(self.schema, self.cap, device),
                "next_seq": _i64(0, device), "overflow": _i64(0, device)}

    def step_ref(self, state, batch: EventBatch, now):
        B, W = batch.capacity, self.cap
        dev = batch.ts.device
        cur, seq, next_seq = arrival_seqs(batch, state["next_seq"])
        rt = _ext_running_time(batch, self.ts_idx)
        pool = make_pool(state["buf"], batch, seq, cur)
        P = W + B
        pool_ext = pool["cols"][self.ts_idx].to(I64)
        expire_row = torch.searchsorted(rt, pool_ext + self.T, side="left")
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
        result = emission_sort(out, emit_row, phase,
                               torch.cat([exp_valid, cur]), P + B)
        buf, overflow = keep_newest(pool, ~expires_here, W)
        return ({"buf": buf, "next_seq": next_seq,
                 "overflow": state["overflow"] + overflow}, result)

    def findable_buffer(self, state, device=None):
        return state["buf"]


class TimeLengthWindowOp(WindowOp):
    """#window.timeLength(T, L): a sliding window bounded by time and
    count. Buffered rows past T expire at the head of the step (ts=now);
    an arrival finding L live rows evicts the oldest (ts=now), emitted
    before it."""

    needs_catchup = False
    kind_name = "timeLength"
    KIND = 6

    def __init__(self, schema, duration_ms: int, length: int,
                 expired_enabled: bool = True):
        super().__init__(schema, expired_enabled)
        if length <= 0:
            raise CompileError("timeLength window requires length > 0")
        self.T = int(duration_ms)
        self.L = int(length)

    @property
    def cap(self):
        return self.L

    def init_state(self, device="cpu"):
        return {"buf": empty_buffer(self.schema, self.L, device),
                "next_seq": _i64(0, device)}

    def step_ref(self, state, batch: EventBatch, now):
        B, L = batch.capacity, self.L
        dev = batch.ts.device
        now = _i64(now, dev)
        cur, seq, next_seq = arrival_seqs(batch, state["next_seq"])
        pool = make_pool(state["buf"], batch, seq, cur)
        P = L + B
        is_buf = torch.arange(P, device=dev) < L
        # 1. time expiry: buffered rows past T, all before row 0
        time_expired = pool["valid"] & is_buf & (pool["ts"] + self.T <= now)
        live = pool["valid"] & ~time_expired
        surv_buf = live & is_buf
        count0 = surv_buf.sum(dtype=I64)
        n_cur = cur.sum(dtype=I64)
        # 2. length eviction: queue position q (survivors first, then
        #    arrivals in seq order); q is evicted at arrival
        #    k = q + max(0, L - count0) when that arrival exists
        q = torch.where(is_buf, torch.cumsum(surv_buf.to(I64), 0) - 1,
                        count0 + (pool["seq"] - state["next_seq"]))
        k_evict = q + torch.clamp(L - count0, min=0)
        evicted = live & (k_evict < n_cur)
        cur_rows = current_row_positions(cur, B)
        evict_row = cur_rows[torch.clamp(k_evict, 0, B - 1)].to(I64)
        emit_row_exp = torch.where(time_expired, torch.zeros_like(evict_row),
                                   evict_row)
        out = {"ts": torch.cat([now.expand(P), batch.ts]),
               "cols": tuple(torch.cat([pc, bc]) for pc, bc in
                             zip(pool["cols"], batch.cols)),
               "nulls": tuple(torch.cat([pn, bn]) for pn, bn in
                              zip(pool["nulls"], batch.nulls)),
               "kind": _kinds(dev, (P, EXPIRED), (B, CURRENT))}
        emit_row = torch.cat([emit_row_exp,
                              torch.arange(B, dtype=I64, device=dev)])
        phase = torch.cat([_full(P, 0, I64, dev), _full(B, 2, I64, dev)])
        exp_emit = time_expired | evicted
        exp_valid = exp_emit if self.expired_enabled \
            else torch.zeros_like(exp_emit)
        result = emission_sort(out, emit_row, phase,
                               torch.cat([exp_valid, cur]), P + B)
        buf, _ = keep_newest(pool, live & ~evicted, L)
        return ({"buf": buf, "next_seq": next_seq}, result)

    def next_due(self, state):
        buf = state["buf"]
        due = torch.where(buf["valid"], buf["ts"] + self.T,
                          torch.full_like(buf["ts"], int(POS_INF)))
        return due.min()

    def host_due_bound(self, ts_min: int) -> int:
        return ts_min + self.T

    def findable_buffer(self, state, device=None):
        return state["buf"]


class DelayWindowOp(WindowOp):
    """#window.delay(T): hold every event T ms, then release it as
    CURRENT with its timestamp set to the release time; arrivals are
    consumed. delay(0) releases at the next step (the reference's
    stated deviation)."""

    kind_name = "delay"
    KIND = 7

    def __init__(self, schema, delay_ms: int, cap: int = 4096,
                 expired_enabled: bool = True):
        super().__init__(schema, expired_enabled)
        self.T = int(delay_ms)
        self.cap = int(cap)

    def out_capacity(self, B: int) -> int:
        """The pool: released buffered rows and the arrivals."""
        return self.cap + B

    def init_state(self, device="cpu"):
        return {"buf": empty_buffer(self.schema, self.cap, device),
                "next_seq": _i64(0, device), "overflow": _i64(0, device)}

    def step_ref(self, state, batch: EventBatch, now):
        B, W = batch.capacity, self.cap
        dev = batch.ts.device
        now = _i64(now, dev)
        cur, seq, next_seq = arrival_seqs(batch, state["next_seq"])
        pool = make_pool(state["buf"], batch, seq, cur)
        P = W + B
        is_buf = torch.arange(P, device=dev) < W
        released = pool["valid"] & is_buf & (pool["ts"] + self.T <= now)
        out = {"ts": now.expand(P), "cols": pool["cols"],
               "nulls": pool["nulls"], "kind": _full(P, CURRENT, torch.int32,
                                                     dev)}
        zero = _full(P, 0, I64, dev)
        result = emission_sort(out, zero, zero, released, P)
        buf, overflow = keep_newest(pool, pool["valid"] & ~released, W)
        return ({"buf": buf, "next_seq": next_seq,
                 "overflow": state["overflow"] + overflow}, result)

    def next_due(self, state):
        buf = state["buf"]
        due = torch.where(buf["valid"], buf["ts"] + self.T,
                          torch.full_like(buf["ts"], int(POS_INF)))
        return due.min()

    def host_due_bound(self, ts_min: int) -> int:
        return ts_min + self.T

    def findable_buffer(self, state, device=None):
        return state["buf"]


class BatchWindowOp(WindowOp):
    """#window.batch([L]): chunk-tumbling window. Each step's arrivals
    (grouped per L when given, else the whole chunk) flush as [previous
    batch EXPIRED (ts=now), previous RESET, group CURRENT]; the step's
    arrivals become the next EXPIRED batch."""

    kind_name = "batch"
    is_batch = True
    KIND = 8
    buf_keys = ("reset", "exp")

    def __init__(self, schema, length: int = 0, cap: int = 4096,
                 expired_enabled: bool = True):
        super().__init__(schema, expired_enabled)
        if length < 0:
            raise CompileError("batch window length must be >= 0")
        self.L = int(length)
        self.cap = int(cap)

    def out_capacity(self, B: int) -> int:
        """The expired batch (cap rows), the reset row, and the
        arrivals with their group resets."""
        return self.cap + 1 + 2 * B

    def init_state(self, device="cpu"):
        return {"exp": empty_buffer(self.schema, self.cap, device),
                "reset": empty_buffer(self.schema, 1, device),
                "next_seq": _i64(0, device), "overflow": _i64(0, device)}

    def step_ref(self, state, batch: EventBatch, now):
        B, L = batch.capacity, self.L
        dev = batch.ts.device
        now = _i64(now, dev)
        cur, seq, next_seq = arrival_seqs(batch, state["next_seq"])
        EB = state["exp"]["seq"].shape[0]
        n_cur = cur.sum(dtype=I64)
        any_arrivals = n_cur > 0
        cur_rows = current_row_positions(cur, B)
        # arrival index within this step; group g = a // L (L=0: one group)
        a = torch.cumsum(cur.to(I64), 0) - 1
        zero_b = torch.zeros((B,), dtype=I64, device=dev)
        if L > 0:
            grp = torch.where(cur, _floordiv(a, L), zero_b)
            grp_first = cur & (torch.remainder(a, L) == 0)
            next_g_start = cur_rows[torch.clamp((grp + 1) * L, 0, B - 1)].to(
                I64)
            has_next_g = (grp + 1) * L < n_cur
        else:
            grp = zero_b
            grp_first = cur & (a == 0)
            next_g_start = zero_b
            has_next_g = torch.zeros((B,), dtype=torch.bool, device=dev)
        exp, rst = state["exp"], state["reset"]
        out = {"ts": torch.cat([now.expand(EB), rst["ts"], batch.ts,
                                batch.ts]),
               "cols": tuple(torch.cat([ec, rc, bc, bc]) for ec, rc, bc in
                             zip(exp["cols"], rst["cols"], batch.cols)),
               "nulls": tuple(torch.cat([en, rn, bn, bn]) for en, rn, bn in
                              zip(exp["nulls"], rst["nulls"], batch.nulls)),
               "kind": _kinds(dev, (EB, EXPIRED), (1, RESET), (B, CURRENT),
                              (B, RESET))}
        # carried expired + carried reset emit before group 0; each
        # in-step group-first event doubles as the NEXT group's reset
        emit_row = torch.cat([
            _full(EB + 1, 0, I64, dev), torch.arange(B, dtype=I64, device=dev),
            torch.where(grp_first & has_next_g, next_g_start, zero_b)])
        phase = torch.cat([_full(EB, 0, I64, dev), _full(1, 1, I64, dev),
                           _full(B, 2, I64, dev), _full(B, 1, I64, dev)])
        exp_valid = (exp["valid"] & any_arrivals) if self.expired_enabled \
            else torch.zeros((EB,), dtype=torch.bool, device=dev)
        valid = torch.cat([exp_valid, rst["valid"] & any_arrivals, cur,
                           grp_first & has_next_g])
        result = emission_sort(out, emit_row, phase, valid, EB + 1 + 2 * B)
        # next state: this step's arrivals become the expired batch; the
        # LAST group's first event becomes the carried reset
        pool = make_pool(empty_buffer(self.schema, self.cap, dev), batch, seq,
                         cur)
        new_exp_pool, overflow = keep_newest(pool, pool["valid"], self.cap)
        new_exp = _select(any_arrivals, new_exp_pool, exp)
        if L > 0:
            last_grp = torch.clamp(_floordiv(n_cur - 1, L), min=0)
            last_first = grp_first & (grp == last_grp)
        else:
            last_first = grp_first
        pad = torch.zeros((self.cap,), dtype=torch.bool, device=dev)
        new_reset_pool, _ = keep_newest(pool, torch.cat([pad, last_first]), 1)
        new_reset = _select(any_arrivals, new_reset_pool, rst)
        return ({"exp": new_exp, "reset": new_reset, "next_seq": next_seq,
                 "overflow": state["overflow"] + overflow}, result)

    def findable_buffer(self, state, device=None):
        return state["exp"]


class ExternalTimeBatchWindowOp(WindowOp):
    """#window.externalTimeBatch(tsAttr, T [, start [, timeout [,
    replace]]]): a tumbling batch over the event-carried clock. The
    first event whose tsAttr reaches the batch end flushes [previous
    batch EXPIRED (ts=trigger clock), RESET, buffered batch CURRENT] and
    starts a new batch. The start may be a constant or an attribute (the
    first event's value); a timeout flushes the pending batch early from
    a TIMER batch; replace.with.batchtime sets the emitted events'
    tsAttr to their batch's end. The clock is monotone, so a batch is
    the window index w = (tsAttr - start) // T."""

    kind_name = "externalTimeBatch"
    is_batch = True
    KIND = 9
    buf_keys = ("cur", "exp")

    def __init__(self, schema, ts_idx: int, duration_ms: int,
                 start_time: Optional[int] = None, cap: int = 4096,
                 expired_enabled: bool = True,
                 start_attr: Optional[int] = None,
                 timeout_ms: Optional[int] = None, replace_ts: bool = False):
        super().__init__(schema, expired_enabled)
        self.ts_idx = int(ts_idx)
        self.T = int(duration_ms)
        self.start_time = start_time
        self.start_attr = start_attr
        self.timeout_ms = timeout_ms
        self.replace_ts = bool(replace_ts)
        self.cap = int(cap)

    def out_capacity(self, B: int) -> int:
        """The expired batch twice (expired, re-emitted), and three
        segments over the pool."""
        return 2 * self.cap + 3 * (self.cap + B)

    def init_state(self, device="cpu"):
        return {"cur": empty_buffer(self.schema, self.cap, device),
                "exp": empty_buffer(self.schema, self.cap, device),
                "start": _i64(self.start_time if self.start_time is not None
                              else -1, device),
                "next_seq": _i64(0, device),
                "flushed": torch.zeros((), dtype=torch.bool, device=device),
                "sched": _i64(POS_INF, device),
                "last_ext": _i64(0, device),
                "overflow": _i64(0, device)}

    def next_due(self, state):
        if self.timeout_ms is None:
            return None
        return state["sched"]

    def step_ref(self, state, batch: EventBatch, now):
        B, W, T = batch.capacity, self.cap, self.T
        dev = batch.ts.device
        now = _i64(now, dev)
        cur, seq, next_seq = arrival_seqs(batch, state["next_seq"])
        ext = batch.cols[self.ts_idx].to(I64)
        n_cur = cur.sum(dtype=I64)
        cur_rows = current_row_positions(cur, B)
        first_ext = ext[cur_rows[0]]
        if self.start_attr is not None:
            first_start = batch.cols[self.start_attr].to(I64)[cur_rows[0]]
        else:
            first_start = first_ext
        start = torch.where(state["start"] >= 0, state["start"],
                            torch.where(n_cur > 0, first_start,
                                        _i64(-1, dev)))
        zero_b = torch.zeros((B,), dtype=I64, device=dev)
        last_ext = torch.maximum(state["last_ext"],
                                 torch.where(cur, ext, zero_b).max())
        timer = batch.valid & (batch.kind == TIMER)
        is_timer = timer.any()
        timer_ts = torch.where(timer, batch.ts, zero_b).max()

        pool = make_pool(state["cur"], batch, seq, cur)
        P, EB = W + B, W
        pool_ext = pool["cols"][self.ts_idx].to(I64)
        w_of = torch.where(pool["valid"], _floordiv(pool_ext - start, T),
                           torch.full_like(pool_ext, -1))
        emit_cols = pool["cols"]
        if self.replace_ts:
            # emitted events carry their batch's END in tsAttr; the pending
            # buffer keeps the original values
            end_of = start + (w_of + 1) * T
            emit_cols = tuple(
                torch.where(pool["valid"], end_of, c).to(c.dtype)
                if k == self.ts_idx else c
                for k, c in enumerate(pool["cols"]))
        warr = torch.where(cur, _floordiv(ext - start, T),
                           torch.full_like(ext, BIG))
        warr_sorted = warr[cur_rows]

        # the step's first flush: the first arrival whose w exceeds the
        # carried batch's window (or the first in-step group's window)
        pidx_all = torch.arange(P, device=dev)
        carried_w = torch.where(pool["valid"] & (pidx_all < W), w_of,
                                torch.full_like(w_of, -BIG)).max()
        has_carried = pool["valid"][:W].any()
        base_w = torch.where(has_carried, carried_w, warr_sorted[0])

        def flush_a(w):
            return torch.searchsorted(warr_sorted, w, side="right")

        def clip(x):
            return torch.clamp(x, 0, B - 1)
        a1 = flush_a(w_of)
        row1 = cur_rows[clip(a1)].to(I64)
        w1 = warr_sorted[clip(a1)]
        a2 = flush_a(w1)
        row2 = cur_rows[clip(a2)].to(I64)
        cur_emits = pool["valid"] & (a1 < n_cur)
        exp_emits = pool["valid"] & (a2 < n_cur)
        flush_ext1 = ext[clip(row1)]
        flush_ext2 = ext[clip(row2)]
        first_flush_a = flush_a(base_w.reshape(1))[0]
        any_flush = first_flush_a < n_cur
        first_flush_row = cur_rows[clip(first_flush_a)].to(I64)
        first_flush_ext = ext[clip(first_flush_row)]

        # RESET per flush: the flushing batch's FIRST event (w differs from
        # the previous valid pool row's)
        pidx = torch.where(pool["valid"], pidx_all, torch.full_like(pidx_all,
                                                                    -1))
        prev_idx = torch.cat([torch.full((1,), -1, dtype=pidx.dtype,
                                         device=dev),
                              torch.cummax(pidx, 0).values[:-1]])
        prev_w = torch.where(prev_idx >= 0, w_of[torch.clamp(prev_idx, min=0)],
                             torch.full_like(w_of, -BIG))
        grp_first = pool["valid"] & (w_of != prev_w)

        # timeout early flush: a timer at/after the scheduled deadline
        # flushes the pending batch without closing its window
        has_timeout = self.timeout_ms is not None
        early = torch.zeros((), dtype=torch.bool, device=dev)
        if has_timeout:
            early = is_timer & (state["sched"] < int(POS_INF)) & \
                (timer_ts >= state["sched"])
        flushed0 = state["flushed"]
        any_pool = pool["valid"].any()
        exp = state["exp"]
        exp_exp_valid = exp["valid"] & (any_flush | (early &
                                                     (~flushed0 | any_pool)))
        if not self.expired_enabled:
            exp_exp_valid = torch.zeros((EB,), dtype=torch.bool, device=dev)
        # after an early flush the batch close re-emits the flushed events
        # as CURRENT ahead of the new ones
        re_cur_valid = exp["valid"] & flushed0 & (any_flush | (early &
                                                                any_pool))
        pool_cur_valid = cur_emits | (pool["valid"] & early)
        reset_valid = (cur_emits & grp_first) | (early & grp_first)
        flush_ts = torch.where(early, last_ext, first_flush_ext)

        parts = [(exp["cols"], exp["nulls"]), (exp["cols"], exp["nulls"])] + \
            [(emit_cols, pool["nulls"])] * 3
        out = _cat_out([flush_ts.expand(EB), flush_ts.expand(EB), pool["ts"],
                        torch.where(early, last_ext, flush_ext1), flush_ext2],
                       parts, [(EB, EXPIRED), (EB, CURRENT), (P, CURRENT),
                               (P, RESET), (P, EXPIRED)], dev)
        zero_p = torch.zeros((P,), dtype=I64, device=dev)
        emit_row = torch.cat([
            first_flush_row.expand(EB), first_flush_row.expand(EB),
            torch.where(cur_emits, row1, zero_p),
            torch.where(cur_emits & grp_first, row1, zero_p),
            torch.where(exp_emits, row2, zero_p)])
        phase = torch.cat([_full(EB, 0, I64, dev), _full(EB, 2, I64, dev),
                           _full(P, 2, I64, dev), _full(P, 1, I64, dev),
                           _full(P, 0, I64, dev)])
        exp_pool_valid = exp_emits if self.expired_enabled \
            else torch.zeros((P,), dtype=torch.bool, device=dev)
        valid = torch.cat([exp_exp_valid, re_cur_valid, pool_cur_valid,
                           reset_valid, exp_pool_valid])
        result = emission_sort(out, emit_row, phase, valid, 2 * EB + 3 * P)

        # next buffers: pending = the newest un-flushed window; exp = the
        # last flushed window's rows (merged with the early-flushed ones
        # while the same batch window stays open)
        pending = pool["valid"] & ~cur_emits & ~early
        new_cur, overflow = keep_newest(pool, pending, W)
        max_w = torch.where(cur_emits, w_of, torch.full_like(w_of, -BIG)).max()
        last_flushed = pool["valid"] & cur_emits & (w_of == max_w)
        flush_set = torch.where(early, pool["valid"], last_flushed)
        big = {"cols": tuple(torch.cat([ec, pc]) for ec, pc in
                             zip(exp["cols"], emit_cols)),
               "nulls": tuple(torch.cat([en, pn]) for en, pn in
                              zip(exp["nulls"], pool["nulls"])),
               "ts": torch.cat([exp["ts"], pool["ts"]]),
               "seq": torch.cat([exp["seq"], pool["seq"]]),
               "valid": torch.cat([exp["valid"], pool["valid"]])}
        keep_exp_old = flushed0 & exp["valid"]
        new_exp_m, _ = keep_newest(big, torch.cat([keep_exp_old, flush_set]),
                                   W)
        did_flush = any_flush | (early & (~flushed0 | any_pool))
        new_exp = _select(did_flush, new_exp_m, exp)
        flushed1 = torch.where(early, torch.ones_like(flushed0),
                               torch.where(any_flush,
                                           torch.zeros_like(flushed0),
                                           flushed0))
        sched = state["sched"]
        if has_timeout:
            trigger = early | any_flush | ((sched >= int(POS_INF)) & (n_cur > 0))
            sched = torch.where(trigger, now + self.timeout_ms, sched)
        return ({"cur": new_cur, "exp": new_exp, "start": start,
                 "next_seq": next_seq, "flushed": flushed1, "sched": sched,
                 "last_ext": last_ext,
                 "overflow": state["overflow"] + overflow}, result)

    def findable_buffer(self, state, device=None):
        return state["exp"]


class HoppingWindowOp(WindowOp):
    """#window.hopping(windowTime, hopTime) (also spelt hoping):
    overlapping tumbling windows. Every hopTime the retained last
    windowTime of events flushes as one CURRENT batch; at most one hop a
    step, the scheduler catching up on missed hops."""

    kind_name = "hopping"
    is_batch = True
    needs_catchup = True
    KIND = 10
    buf_keys = ("buf", "exp")

    def __init__(self, schema, window_ms: int, hop_ms: int, cap: int = 4096,
                 expired_enabled: bool = True):
        super().__init__(schema, expired_enabled)
        if hop_ms <= 0 or window_ms <= 0:
            raise CompileError("hopping window needs positive durations")
        self.W_ms = int(window_ms)
        self.H_ms = int(hop_ms)
        self.cap = int(cap)

    def out_capacity(self, B: int) -> int:
        """The expired hop and the pool."""
        return self.cap + self.cap + B

    def init_state(self, device="cpu"):
        return {"buf": empty_buffer(self.schema, self.cap, device),
                "exp": empty_buffer(self.schema, self.cap, device),
                "next_seq": _i64(0, device), "next_hop": _i64(-1, device),
                "overflow": _i64(0, device)}

    def step_ref(self, state, batch: EventBatch, now):
        B, W = batch.capacity, self.cap
        dev = batch.ts.device
        now = _i64(now, dev)
        cur, seq, next_seq = arrival_seqs(batch, state["next_seq"])
        pool = make_pool(state["buf"], batch, seq, cur)
        P, EB = W + B, W
        next_hop = torch.where(state["next_hop"] == -1, now + self.H_ms,
                               state["next_hop"])
        send = now >= next_hop
        hop_at = next_hop
        next_hop = torch.where(send, next_hop + self.H_ms, next_hop)
        # the closing hop covers (hop_at - windowTime, hop_at]
        in_span = pool["valid"] & (pool["ts"] > hop_at - self.W_ms) & \
            (pool["ts"] <= hop_at)
        flushed = in_span & send
        exp = state["exp"]
        out = {"ts": torch.cat([now.expand(EB), pool["ts"]]),
               "cols": tuple(torch.cat([ec, pc]) for ec, pc in
                             zip(exp["cols"], pool["cols"])),
               "nulls": tuple(torch.cat([en, pn]) for en, pn in
                              zip(exp["nulls"], pool["nulls"])),
               "kind": _kinds(dev, (EB, EXPIRED), (P, CURRENT))}
        emit_row = _full(EB + P, 0, I64, dev)
        phase = torch.cat([_full(EB, 0, I64, dev), _full(P, 2, I64, dev)])
        exp_valid = (exp["valid"] & send) if self.expired_enabled \
            else torch.zeros((EB,), dtype=torch.bool, device=dev)
        result = emission_sort(out, emit_row, phase,
                               torch.cat([exp_valid, flushed]), EB + P)
        # keep rows still inside ANY future hop; on send the flushed batch
        # becomes the next expired set
        keep = pool["valid"] & (pool["ts"] > next_hop - self.W_ms)
        new_buf, overflow = keep_newest(
            pool, torch.where(send, keep, pool["valid"]), W)
        new_exp_f, _ = keep_newest(pool, flushed, W)
        new_exp = _select(send, new_exp_f, exp)
        return ({"buf": new_buf, "exp": new_exp, "next_seq": next_seq,
                 "next_hop": next_hop,
                 "overflow": state["overflow"] + overflow}, result)

    def next_due(self, state):
        nh = state["next_hop"]
        return torch.where(nh == -1, torch.full_like(nh, int(POS_INF)), nh)

    def findable_buffer(self, state, device=None):
        return state["exp"]


# ---------------------------------------------------------------------------
# the sort window: a sequential walk over the batch
# ---------------------------------------------------------------------------


SORT_TYPES = (AttrType.INT, AttrType.LONG, AttrType.FLOAT, AttrType.DOUBLE)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_to(v, dev) for v in tree)
    return tree.to(dev)


class SortWindowOp(WindowOp):
    """#window.sort(L, attr [asc|desc], ...): keep the L smallest events
    by the comparator; when an arrival makes L+1, the comparator-max
    (the latest-inserted among ties) is emitted EXPIRED (ts=now) after
    the current event. Quirks of the reference kept: a NaN key makes
    the eviction take buffer slot 0; ``desc`` negates the value (an INT
    or LONG minimum wraps, a float -0.0 flips)."""

    kind_name = "sort"
    fifo_expiry = False

    def __init__(self, schema, length: int, keys: list,
                 expired_enabled: bool = True):
        # keys: [(col_idx, +1 asc | -1 desc), ...]
        super().__init__(schema, expired_enabled)
        if length <= 0:
            raise CompileError("sort window requires length > 0")
        for idx, _ in keys:
            if schema.attributes[idx].type is AttrType.STRING:
                raise CompileError(
                    "sort window ordering on STRING attributes is not "
                    "supported (dictionary codes do not preserve "
                    "lexicographic order)")
            if schema.attributes[idx].type not in SORT_TYPES:
                raise NotImplementedError(
                    "not ported yet: sort window ordering on "
                    f"{schema.attributes[idx].type.value} attributes")
        self.L = int(length)
        self.keys = list(keys)

    @property
    def cap(self):
        return self.L + 1

    def init_state(self, device="cpu"):
        return {"buf": empty_buffer(self.schema, self.L + 1, device),
                "next_seq": _i64(0, device)}

    def step(self, state, batch: EventBatch, now):
        return sort_window_step(self, state, batch, now)

    def _evict_slot(self, buf):
        """The slot the reference's eviction picks: the comparator-max
        over the valid rows, key by key, the latest seq among ties (slot
        0 when a NaN leaves no row)."""
        mask = buf["valid"]
        for idx, order in self.keys:
            v = buf["cols"][idx]
            v_eff = v if order > 0 else -v
            low = float("-inf") if v.is_floating_point() \
                else torch.iinfo(v.dtype).min
            m = torch.where(mask, v_eff, torch.full_like(v_eff, low)).max()
            mask = mask & (v_eff == m)
        return int(torch.argmax(torch.where(mask, buf["seq"],
                                            torch.full_like(buf["seq"], -1))))

    def step_ref(self, state, batch: EventBatch, now):
        """The reference's row walk. On a card it walks copies on the
        host (one row at a time: tiny launches would only add latency)
        and hands the results back to the card."""
        dev = batch.ts.device
        if dev.type != "cpu":
            host = {"buf": _to(state["buf"], "cpu"),
                    "next_seq": state["next_seq"].cpu()}
            hb = EventBatch(*(_to(x, "cpu") for x in (
                batch.ts, batch.cols, batch.nulls, batch.kind, batch.valid)))
            st, out = self.step_ref(host, hb, _i64(now, "cpu"))
            return _to(st, dev), EventBatch(*(_to(x, dev) for x in (
                out.ts, out.cols, out.nulls, out.kind, out.valid)))
        B, L = batch.capacity, self.L
        now = _i64(now, dev)
        cur, seq, next_seq = arrival_seqs(batch, state["next_seq"])
        buf = {k: (tuple(c.clone() for c in v) if isinstance(v, tuple)
                   else v.clone()) for k, v in state["buf"].items()}
        ev_ts = torch.zeros((B,), dtype=I64, device=dev)
        ev_cols = tuple(torch.zeros_like(c) for c in batch.cols)
        ev_nulls = tuple(torch.zeros_like(n) for n in batch.nulls)
        ev_valid = torch.zeros((B,), dtype=torch.bool, device=dev)
        nseq = int(state["next_seq"])
        count = int(buf["valid"].sum())
        for i in torch.nonzero(cur).flatten().tolist():
            free = int(torch.argmin(buf["valid"].to(torch.int8)))
            buf["ts"][free] = batch.ts[i]
            buf["seq"][free] = nseq
            for c, bc in zip(buf["cols"], batch.cols):
                c[free] = bc[i]
            for n, bn in zip(buf["nulls"], batch.nulls):
                n[free] = bn[i]
            buf["valid"][free] = True
            nseq += 1
            count += 1
            if count > L:
                ei = self._evict_slot(buf)
                ev_ts[i] = buf["ts"][ei]
                for ec, c in zip(ev_cols, buf["cols"]):
                    ec[i] = c[ei]
                for en, n in zip(ev_nulls, buf["nulls"]):
                    en[i] = n[ei]
                ev_valid[i] = True
                buf["valid"][ei] = False
                count -= 1
        rows = torch.arange(B, dtype=I64, device=dev)
        out = {"ts": torch.cat([batch.ts, now.expand(B)]),
               "cols": tuple(torch.cat([bc, ec]) for bc, ec in
                             zip(batch.cols, ev_cols)),
               "nulls": tuple(torch.cat([bn, en]) for bn, en in
                              zip(batch.nulls, ev_nulls)),
               "kind": _kinds(dev, (B, CURRENT), (B, EXPIRED))}
        phase = torch.cat([_full(B, 2, I64, dev), _full(B, 3, I64, dev)])
        if not self.expired_enabled:
            ev_valid = torch.zeros_like(ev_valid)
        result = emission_sort(out, torch.cat([rows, rows]), phase,
                               torch.cat([cur, ev_valid]), 2 * B)
        return {"buf": buf, "next_seq": next_seq}, result

    def findable_buffer(self, state, device=None):
        return state["buf"]


def sort_window_step_ref(op: SortWindowOp, state, batch: EventBatch, now):
    """Plain PyTorch version of the sort window's kernel."""
    return op.step_ref(state, batch, now)


def sort_window_step(op: SortWindowOp, state, batch: EventBatch, now):
    """The sort window's step: a batch on the CPU takes the plain
    version; a CUDA batch launches csrc/window_seq.cu (one block, the
    rows in order, no host sync)."""
    dev = batch.ts.device
    if dev.type == "cpu":
        return sort_window_step_ref(op, state, batch, now)
    if dev.type != "cuda":
        raise ValueError(f"sort_window_step: unsupported device {dev}")
    new_state, out, args = sort_args(op, state, batch, _i64(now, dev))
    _kernels.load().sort_window(args,
                                torch.cuda.current_stream(dev).cuda_stream)
    _kernels.count_launch("sort_window")
    return new_state, out


_SORT_VT = {torch.int32: 0, torch.int64: 1, torch.float32: 2,
            torch.float64: 3}


def sort_args(op: SortWindowOp, state, batch: EventBatch, now):
    """The sort window kernel's arguments: the new state's and the output
    batch's tensors (fresh), the scratch, and ``_kernels.SortArgs``
    pointing at them. -> (state', output batch, args)."""
    dev = batch.ts.device
    B, C = batch.capacity, len(batch.cols)
    if C > _kernels.WIN_MAX_COLS or len(op.keys) > _kernels.SORT_MAX_KEYS:
        raise NotImplementedError(
            f"not ported yet: a sort window over more than "
            f"{_kernels.WIN_MAX_COLS} attributes or "
            f"{_kernels.SORT_MAX_KEYS} keys")
    buf = state["buf"]
    W = buf["seq"].shape[0]

    def like(t, n):
        return torch.empty((n,), dtype=t.dtype, device=dev)
    na = {"ts": like(buf["ts"], W), "seq": like(buf["seq"], W),
          "cols": tuple(like(c, W) for c in buf["cols"]),
          "nulls": tuple(like(n, W) for n in buf["nulls"]),
          "valid": like(buf["valid"], W)}
    ev = {"cols": tuple(like(c, B) for c in batch.cols),
          "nulls": tuple(like(n, B) for n in batch.nulls),
          "valid": torch.empty((B,), dtype=torch.bool, device=dev)}
    out = EventBatch(ts=torch.empty((2 * B,), dtype=I64, device=dev),
                     cols=tuple(like(c, 2 * B) for c in batch.cols),
                     nulls=tuple(like(n, 2 * B) for n in batch.nulls),
                     kind=torch.empty((2 * B,), dtype=torch.int32,
                                      device=dev),
                     valid=torch.empty((2 * B,), dtype=torch.bool,
                                       device=dev))
    new = {"buf": na, "next_seq": torch.empty((), dtype=I64, device=dev)}
    sc = {"mask": torch.empty((W,), dtype=torch.uint8, device=dev),
          "pos": torch.empty((2 * B,), dtype=torch.int32, device=dev)}
    a = _kernels.SortArgs()
    _win_buf(a.batch, batch.ts, None, batch.cols, batch.nulls, batch.valid)
    a.batch_kind = batch.kind.data_ptr()
    _win_buf(a.a, buf["ts"], buf["seq"], buf["cols"], buf["nulls"],
             buf["valid"])
    _win_buf(a.na, na["ts"], na["seq"], na["cols"], na["nulls"], na["valid"])
    _win_buf(a.ev, sc["pos"], None, ev["cols"], ev["nulls"], ev["valid"])
    a.next_seq = state["next_seq"].data_ptr()
    a.now = now.data_ptr()
    a.o_next_seq = new["next_seq"].data_ptr()
    _win_buf(a.out, out.ts, None, out.cols, out.nulls, out.valid)
    a.out_kind = out.kind.data_ptr()
    a.mask, a.pos = sc["mask"].data_ptr(), sc["pos"].data_ptr()
    for k, c in enumerate(batch.cols):
        a.col_size[k] = c.element_size()
    a.n_cols, a.B, a.W, a.L = C, B, W, op.L
    a.expired_enabled = int(op.expired_enabled)
    a.n_keys = len(op.keys)
    for k, (idx, order) in enumerate(op.keys):
        a.key_col[k] = idx
        a.key_desc[k] = int(order < 0)
        a.key_type[k] = _SORT_VT[batch.cols[idx].dtype]
    a._keep = (state, new, out, ev, sc, now)   # alive until the launch
    return new, out, a

