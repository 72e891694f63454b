"""Window operators, second wave (PyTorch port of siddhi_tpu/ops/
windows2.py): externalTime, timeLength, delay, batch, externalTimeBatch
and hopping on kernel K5's frame; the sort window (kernel B), frequent
and lossyFrequent (kernel E) and session (kernel F) on kernels of their
own.

Reference mapping (modules/siddhi-core/.../query/processor/stream/window/):
- ExternalTimeWindowProcessor.java:125-161      -> ExternalTimeWindowOp
- TimeLengthWindowProcessor.java:139-189        -> TimeLengthWindowOp
- DelayWindowProcessor.java:125-165             -> DelayWindowOp
- BatchWindowProcessor.java:122-195             -> BatchWindowOp
- SortWindowProcessor.java:152-183              -> SortWindowOp
- ExternalTimeBatchWindowProcessor.java:253-311 -> ExternalTimeBatchWindowOp
- HopingWindowProcessor.java:48                 -> HoppingWindowOp
- FrequentWindowProcessor.java:115-172          -> FrequentWindowOp
- LossyFrequentWindowProcessor.java:149-210     -> LossyFrequentWindowOp
- SessionWindowProcessor.java:227-310           -> SessionWindowOp
- CronWindowProcessor.java:125-236              -> CronWindowOp

Each ``step_ref`` is the plain PyTorch version and follows the
reference's ``step`` line by line. The K5-frame kinds run kernel K5
(csrc/window_step.cu) on a CUDA batch, as the first wave's windows do
(ops/windows.py window_step); the sort window runs csrc/window_seq.cu
(``sort_window_step``), one block walking the batch row by row as the
reference's ``lax.scan`` does; frequent and lossyFrequent run
csrc/window_seq.cu's kernel E (``freq_window_step``), one warp walking
the rows; session runs csrc/session_step.cu (``session_step``), the
reference's vectorised pass stage by stage. The cron window runs K5's
frame too, as its own kind (kernel K5c): its fires come from the host
schedule (utils/cron.py), not a device due.

Inside a partition block or a tenant pool (a ``[K, B]`` batch, every
state with a leading slot axis: the reference's ``jax.vmap``) every kind
runs once over all K slots: K5's kinds through K5's slot layout
(A[K]), the sort window, kernel E and kernel F with the slot as
``blockIdx.y`` (B[K], E[K], F[K], counted as ``sort_window[K]``,
``freq_window[K]``, ``session_window[K]``), and the cron window of a
tenant pool through K5's slot layout as K5c[K] (counted as
``cron_window[K]``; a partition block refuses cron, as the reference's
does). Their plain versions over
the slot axis: ``per_slot`` of ``step_ref`` for K5's kinds; for the
sort and frequent windows a walk of every slot at once
(``sort_window_slots_ref``, ``freq_window_slots_ref``), for session
its stages along the row axis (``session_slots_ref``) and for cron
every slot's step at once (``cron_slots_ref``), each slot's result
equal to ``step_ref``'s on that slot alone. A ``next_due`` gives one
due a slot, which the block's K9p due reduces.

The reference's documented deviation is kept: delay(0) releases at the
next step, not interleaved after the next in-chunk event.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import _kernels
from ..core.event import CURRENT, EXPIRED, RESET, TIMER, EventBatch
from ..core.types import AttrType, col_zeros
from .expr import DTYPE_VT, CompileError
from .keyed import (hash_columns, lookup_or_insert, lookup_or_insert_tables,
                    segmented_cumsum)
from .sentinels import I32_MAX
from .slots import flat, part_moves
from .windows import (I64, NEG_INF, POS_INF, WindowOp, _full, _i64, _kinds,
                      _select, arrival_seqs, current_row_positions,
                      emission_sort_slots,
                      _win_buf, emission_sort, empty_buffer, keep_newest,
                      make_pool, running_time)

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
        return due.amin(-1)   # [K] dues inside a partition block

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
        return due.amin(-1)   # [K] dues inside a partition block

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


class CronWindowOp(WindowOp):
    """#window.cron('expr'): buffer arrivals; each cron firing (a TIMER
    batch from the host schedule) emits [previous batch EXPIRED (ts =
    now), buffered batch CURRENT] and rotates the buffers; nothing is
    emitted when the buffer is empty (CronWindowProcessor.java:125-135
    buffers, :188-236 dispatches; the Quartz scheduler is utils/cron.py
    and the app Scheduler). Kernel K5c: kind 11 of csrc/window_step.cu,
    counted as ``cron_window`` (``cron_window[K]`` over a tenant pool's
    slot axis)."""

    kind_name = "cron"
    KIND = 11
    LAUNCH = "cron_window"
    LAUNCH_K = "cron_window[K]"
    buf_keys = ("cur", "exp")

    def __init__(self, schema, cron_expr: str, cap: int = 4096,
                 expired_enabled: bool = True):
        from ..utils.cron import CronSchedule
        super().__init__(schema, expired_enabled)
        self.schedule = CronSchedule(cron_expr)
        self.cap = int(cap)

    @property
    def host_schedule(self):
        """The host-side next-fire computer: the runtime arms the app's
        timers from it (there is no device next_due)."""
        return self.schedule.next_fire

    def out_capacity(self, B: int) -> int:
        """The expired batch and the buffered batch."""
        return 2 * self.cap

    def init_state(self, device="cpu"):
        return {"cur": empty_buffer(self.schema, self.cap, device),
                "exp": empty_buffer(self.schema, self.cap, device),
                "next_seq": _i64(0, device), "overflow": _i64(0, device)}

    def step_ref(self, state, batch: EventBatch, now):
        W = EB = self.cap
        dev = batch.ts.device
        now = _i64(now, dev)
        cur, seq, next_seq = arrival_seqs(batch, state["next_seq"])
        fire = (batch.valid & (batch.kind == TIMER)).any()
        has_pending = state["cur"]["valid"].any()
        flush = fire & has_pending
        exp, buf = state["exp"], state["cur"]
        out = {"ts": torch.cat([now.expand(EB), buf["ts"]]),
               "cols": tuple(torch.cat([ec, cc]) for ec, cc in
                             zip(exp["cols"], buf["cols"])),
               "nulls": tuple(torch.cat([en, cn]) for en, cn in
                              zip(exp["nulls"], buf["nulls"])),
               "kind": _kinds(dev, (EB, EXPIRED), (W, CURRENT))}
        emit_row = torch.zeros((EB + W,), dtype=I64, device=dev)
        phase = torch.cat([_full(EB, 0, I64, dev), _full(W, 1, I64, dev)])
        exp_valid = (exp["valid"] & flush) if self.expired_enabled \
            else torch.zeros((EB,), dtype=torch.bool, device=dev)
        valid = torch.cat([exp_valid, buf["valid"] & flush])
        result = emission_sort(out, emit_row, phase, valid, EB + W)
        # rotate on a flush, then append this step's arrivals to cur
        mid_cur = _select(flush, empty_buffer(self.schema, W, dev), buf)
        new_exp = _select(flush, buf, exp)
        pool = make_pool(mid_cur, batch, seq, cur)
        new_cur, overflow = keep_newest(pool, pool["valid"], W)
        return ({"cur": new_cur, "exp": new_exp, "next_seq": next_seq,
                 "overflow": state["overflow"] + overflow}, result)

    def findable_buffer(self, state, device=None):
        return state["exp"]

    def step_slots_ref(self, state, batch: EventBatch, now):
        return cron_slots_ref(self, state, batch, now)


def _slot_take(x, idx):
    """Rows ``idx`` ([K, n]) of each slot of ``x`` ([K, m, ...])."""
    i = idx.reshape(idx.shape + (1,) * (x.dim() - 2))
    return torch.take_along_dim(x, i.expand(idx.shape + x.shape[2:]), dim=1)


def _slot_where(cond, a: dict, b: dict) -> dict:
    """Per slot, buffer ``a`` where ``cond`` ([K]) else buffer ``b``."""
    def w(x, y):
        if isinstance(x, tuple):
            return tuple(w(u, v) for u, v in zip(x, y))
        c = cond.reshape(cond.shape + (1,) * (x.dim() - 1))
        return torch.where(c, x, y)
    return {k: w(a[k], b[k]) for k in a}


def cron_slots_ref(op: "CronWindowOp", state, batch: EventBatch, now):
    """Plain PyTorch version of kernel K5c[K]: ``CronWindowOp.step_ref``
    of every slot at once (``state`` and ``batch`` with the leading slot
    axis; ``now`` one clock for all). -> (state', [K, EB + W] output)."""
    K = batch.ts.shape[0]
    W = EB = op.cap
    dev = batch.ts.device
    now = _i64(now, dev)
    cur = batch.valid & (batch.kind == CURRENT)
    offs = torch.cumsum(cur.to(I64), 1) - 1
    seq = torch.where(cur, state["next_seq"][:, None] + offs,
                      torch.full_like(offs, int(NEG_INF)))
    next_seq = state["next_seq"] + cur.sum(1, dtype=I64)
    fire = (batch.valid & (batch.kind == TIMER)).any(1)
    flush = fire & state["cur"]["valid"].any(1)
    exp, buf = state["exp"], state["cur"]
    out = {"ts": torch.cat([now.expand(K, EB), buf["ts"]], 1),
           "cols": tuple(torch.cat([ec, cc], 1) for ec, cc in
                         zip(exp["cols"], buf["cols"])),
           "nulls": tuple(torch.cat([en, cn], 1) for en, cn in
                          zip(exp["nulls"], buf["nulls"])),
           "kind": _kinds(dev, (EB, EXPIRED), (W, CURRENT)).expand(
               K, EB + W)}
    emit_row = torch.zeros((K, EB + W), dtype=I64, device=dev)
    phase = torch.cat([_full(EB, 0, I64, dev), _full(W, 1, I64, dev)]
                      ).expand(K, EB + W)
    f = flush[:, None]
    exp_valid = (exp["valid"] & f) if op.expired_enabled \
        else torch.zeros((K, EB), dtype=torch.bool, device=dev)
    valid = torch.cat([exp_valid, buf["valid"] & f], 1)
    result = emission_sort_slots(out, emit_row, phase, valid, EB + W)
    # rotate on a flush, then keep the newest W of (cur ++ arrivals)
    empty = {k: torch.zeros_like(v) if not isinstance(v, tuple)
             else tuple(torch.zeros_like(x) for x in v)
             for k, v in buf.items()}
    mid = _slot_where(flush, empty, buf)
    new_exp = _slot_where(flush, buf, exp)
    pool = {"ts": torch.cat([mid["ts"], batch.ts], 1),
            "seq": torch.cat([mid["seq"], seq], 1),
            "cols": tuple(torch.cat([b, c], 1)
                          for b, c in zip(mid["cols"], batch.cols)),
            "nulls": tuple(torch.cat([b, c], 1)
                           for b, c in zip(mid["nulls"], batch.nulls)),
            "valid": torch.cat([mid["valid"], cur], 1)}
    n = pool["seq"].shape[1]
    c = torch.cumsum(pool["valid"].to(torch.int32), 1, dtype=torch.int32)
    total = c[:, n - 1:]
    r = total - W + torch.arange(W, dtype=torch.int32, device=dev)
    take = torch.clamp(torch.searchsorted(c, r + 1, side="left"), 0, n - 1)
    new_cur = {"ts": _slot_take(pool["ts"], take),
               "seq": _slot_take(pool["seq"], take),
               "cols": tuple(_slot_take(x, take) for x in pool["cols"]),
               "nulls": tuple(_slot_take(x, take) for x in pool["nulls"]),
               "valid": r >= 0}
    overflow = torch.clamp(total[:, 0] - W, min=0).to(I64)
    return ({"cur": new_cur, "exp": new_exp, "next_seq": next_seq,
             "overflow": state["overflow"] + overflow}, result)


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


def _host_copy(state, batch: EventBatch, now):
    return (_to(state, "cpu"), EventBatch(*(_to(x, "cpu") for x in (
        batch.ts, batch.cols, batch.nulls, batch.kind, batch.valid))),
        _i64(now, "cpu"))


def _to_dev(st, out: EventBatch, dev):
    return _to(st, dev), EventBatch(*(_to(x, dev) for x in (
        out.ts, out.cols, out.nulls, out.kind, out.valid)))


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
            return _to_dev(*self.step_ref(*_host_copy(state, batch, now)),
                           dev)
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
    """Plain PyTorch version of the sort window's kernel (a partition
    block's or a pool's slot axis: ``sort_window_slots_ref``)."""
    if batch.ts.dim() == 2:
        return sort_window_slots_ref(op, state, batch, now)
    return op.step_ref(state, batch, now)


def _rows_in_order(cur):
    """Each slot's CURRENT rows in order: -> (their row indices first,
    [K, B]; their count a slot, [K])."""
    K, B = cur.shape
    rows = torch.arange(B, device=cur.device).expand(K, B)
    return (torch.argsort(torch.where(cur, rows, B), dim=1, stable=True),
            cur.sum(1))


def _put_rows(buf: dict, kk, s, batch: EventBatch, i) -> None:
    """Slot kk's row i of the batch into its buffer's place s (vectors of
    one entry a slot)."""
    buf["ts"][kk, s] = batch.ts[kk, i]
    for c, bc in zip(buf["cols"], batch.cols):
        c[kk, s] = bc[kk, i]
    for n, bn in zip(buf["nulls"], batch.nulls):
        n[kk, s] = bn[kk, i]
    buf["valid"][kk, s] = True


def sort_window_slots_ref(op: SortWindowOp, state, batch: EventBatch, now):
    """The sort window's plain version over the slot axis in one call
    ([K, B] batch, [K, L + 1] buffers): the row walk of ``step_ref`` run
    for every slot at once, each slot's r-th CURRENT row at walk step
    r; each slot's state and output equal ``step_ref``'s on that slot
    alone."""
    dev = batch.ts.device
    K, B = batch.ts.shape
    now = _i64(now, dev)
    cur = batch.valid & (batch.kind == CURRENT)
    buf = _clone_buf(state["buf"])
    nseq = state["next_seq"].clone()
    count = buf["valid"].sum(1)
    ev_cols = tuple(torch.zeros((K, B), dtype=c.dtype, device=dev)
                    for c in batch.cols)
    ev_nulls = tuple(torch.zeros((K, B), dtype=torch.bool, device=dev)
                     for _ in batch.nulls)
    ev_valid = torch.zeros((K, B), dtype=torch.bool, device=dev)
    order, ncur = _rows_in_order(cur)
    ks = torch.arange(K, device=dev)
    for r in range(int(ncur.max()) if K else 0):
        act = ncur > r
        kk, i = ks[act], order[act, r]
        free = torch.argmin(buf["valid"][kk].to(torch.int8), dim=1)
        _put_rows(buf, kk, free, batch, i)
        buf["seq"][kk, free] = nseq[kk]
        nseq[kk] += 1
        count[kk] += 1
        over = count[kk] > op.L
        ke, ie = kk[over], i[over]
        if not ke.numel():
            continue
        ei = _evict_slots(op, buf, ke)
        for ec, c in zip(ev_cols, buf["cols"]):
            ec[ke, ie] = c[ke, ei]
        for en, n in zip(ev_nulls, buf["nulls"]):
            en[ke, ie] = n[ke, ei]
        ev_valid[ke, ie] = True
        buf["valid"][ke, ei] = False
        count[ke] -= 1
    rows = torch.arange(B, dtype=I64, device=dev).expand(K, B)
    out = {"ts": torch.cat([batch.ts, now.expand(K, B)], 1),
           "cols": tuple(torch.cat([bc, ec], 1) for bc, ec in
                         zip(batch.cols, ev_cols)),
           "nulls": tuple(torch.cat([bn, en], 1) for bn, en in
                          zip(batch.nulls, ev_nulls)),
           "kind": _kinds(dev, (B, CURRENT), (B, EXPIRED)).expand(K, 2 * B)}
    phase = torch.cat([_full(B, 2, I64, dev), _full(B, 3, I64, dev)])
    if not op.expired_enabled:
        ev_valid = torch.zeros_like(ev_valid)
    result = emission_sort_slots(out, torch.cat([rows, rows], 1), phase,
                                 torch.cat([cur, ev_valid], 1), 2 * B)
    return {"buf": buf, "next_seq": nseq}, result


def _evict_slots(op: SortWindowOp, buf: dict, ke):
    """``SortWindowOp._evict_slot`` for the slots ``ke`` of a slotted
    buffer, one place a slot."""
    mask = buf["valid"][ke]
    for idx, order in op.keys:
        v = buf["cols"][idx][ke]
        v_eff = v if order > 0 else -v
        low = float("-inf") if v.is_floating_point() \
            else torch.iinfo(v.dtype).min
        m = torch.where(mask, v_eff, torch.full_like(v_eff, low)).amax(1)
        mask = mask & (v_eff == m[:, None])
    seq = buf["seq"][ke]
    return torch.argmax(torch.where(mask, seq, torch.full_like(seq, -1)),
                        dim=1)


def sort_window_step(op: SortWindowOp, state, batch: EventBatch, now):
    """The sort window's step: a batch on the CPU takes the plain
    version; a CUDA batch launches csrc/window_seq.cu (one block walking
    the rows in order, no host sync). Inside a partition block or a
    pool ([K, B] batch, a state a slot) the kernel runs one block a
    slot, counted as ``sort_window[K]``."""
    dev = batch.ts.device
    if dev.type == "cpu":
        return sort_window_step_ref(op, state, batch, now)
    if dev.type != "cuda":
        raise ValueError(f"sort_window_step: unsupported device {dev}")
    new_state, out, args = sort_args(op, state, batch, _i64(now, dev))
    _kernels.load().sort_window(args,
                                torch.cuda.current_stream(dev).cuda_stream)
    _kernels.count_launch("sort_window[K]" if batch.ts.dim() == 2
                          else "sort_window")
    return new_state, out


def sort_args(op: SortWindowOp, state, batch: EventBatch, now):
    """The sort window kernel's arguments: the new state's and the output
    batch's tensors (fresh), the scratch, and ``_kernels.SortArgs``
    pointing at them. -> (state', output batch, args). With the slot
    axis ([K, B] batch) every tensor leads with it, ``n_part`` is K and
    ``moves`` holds the slot strides (ops/slots.py part_moves)."""
    dev = batch.ts.device
    slotted = batch.ts.dim() == 2
    lead = tuple(batch.ts.shape[:1]) if slotted else ()
    B, C = batch.ts.shape[-1], len(batch.cols)
    if C > _kernels.WIN_MAX_COLS or len(op.keys) > _kernels.SORT_MAX_KEYS:
        raise NotImplementedError(
            f"not ported yet: a sort window over more than "
            f"{_kernels.WIN_MAX_COLS} attributes or "
            f"{_kernels.SORT_MAX_KEYS} keys")
    buf = state["buf"]
    W = buf["seq"].shape[-1]

    def like(t, n):
        return torch.empty(lead + (n,), dtype=t.dtype, device=dev)
    na = {"ts": like(buf["ts"], W), "seq": like(buf["seq"], W),
          "cols": tuple(like(c, W) for c in buf["cols"]),
          "nulls": tuple(like(n, W) for n in buf["nulls"]),
          "valid": like(buf["valid"], W)}
    ev = {"cols": tuple(like(c, B) for c in batch.cols),
          "nulls": tuple(like(n, B) for n in batch.nulls),
          "valid": like(batch.valid, B)}
    out = EventBatch(ts=like(batch.ts, 2 * B),
                     cols=tuple(like(c, 2 * B) for c in batch.cols),
                     nulls=tuple(like(n, 2 * B) for n in batch.nulls),
                     kind=like(batch.kind, 2 * B),
                     valid=like(batch.valid, 2 * B))
    new = {"buf": na, "next_seq": torch.empty(lead, dtype=I64, device=dev)}
    sc = {"mask": torch.empty(lead + (W,), dtype=torch.uint8, device=dev),
          "pos": torch.empty(lead + (2 * B,), dtype=torch.int32, device=dev),
          "rows": torch.empty(lead + (B,), dtype=torch.int32, device=dev)}
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
    a.rows = sc["rows"].data_ptr()
    for k, c in enumerate(batch.cols):
        a.col_size[k] = c.element_size()
    a.n_cols, a.B, a.W, a.L = C, B, W, op.L
    a.expired_enabled = int(op.expired_enabled)
    a.n_keys = len(op.keys)
    for k, (idx, order) in enumerate(op.keys):
        a.key_col[k] = idx
        a.key_desc[k] = int(order < 0)
        a.key_type[k] = DTYPE_VT[batch.cols[idx].dtype]
    a.n_part = lead[0] if slotted else 1
    part_moves(a, (state, batch, new, out, ev, sc), dev)
    a._keep = (state, new, out, ev, sc, now)   # alive until the launch
    return new, out, a


# ---------------------------------------------------------------------------
# the keyed windows: frequent and lossyFrequent (kernel E), session (F)
# ---------------------------------------------------------------------------


def _key_hash(batch: EventBatch, key_idxs):
    return hash_columns([batch.cols[i] for i in key_idxs],
                        [batch.nulls[i] for i in key_idxs])


class FrequentWindowOp(WindowOp):
    """#window.frequent(N [, attrs...]): retain the events of the N most
    frequent keys (Misra-Gries). A new key finding the table full
    decrements every tracked count; zeroed keys are emitted EXPIRED
    (ts = now) and freed; if that made room the new event is admitted,
    else it is ignored (its zeroed keys are emitted all the same). Keys
    compare as their 64-bit hash, as in the reference (a collision is
    the reference's behaviour)."""

    kind_name = "frequent"
    fifo_expiry = False
    LOSSY = False

    def __init__(self, schema, n: int, key_idxs: list,
                 expired_enabled: bool = True):
        super().__init__(schema, expired_enabled)
        if not 0 < n <= 64:
            raise CompileError("frequent window count must be in 1..64")
        self.N = int(n)
        self.key_idxs = list(key_idxs) or list(range(len(schema.types)))

    def init_state(self, device="cpu"):
        N = self.N
        return {"buf": empty_buffer(self.schema, N, device),
                "keys": torch.zeros((N,), dtype=I64, device=device),
                "counts": torch.zeros((N,), dtype=I64, device=device),
                "next_seq": _i64(0, device)}

    def step(self, state, batch: EventBatch, now):
        return freq_window_step(self, state, batch, now)

    def step_ref(self, state, batch: EventBatch, now):
        """The reference's row walk (its ``lax.scan``), one row at a
        time. On a card it walks copies on the host and hands the
        results back."""
        dev = batch.ts.device
        if dev.type != "cpu":
            return _to_dev(*self.step_ref(*_host_copy(state, batch, now)),
                           dev)
        B, N = batch.capacity, self.N
        cur, seq, next_seq = arrival_seqs(batch, state["next_seq"])
        khash = _key_hash(batch, self.key_idxs)
        buf = _clone_buf(state["buf"])
        keys, counts = state["keys"].clone(), state["counts"].clone()
        st = {"buf": buf, "keys": keys, "counts": counts}
        passed = torch.zeros((B,), dtype=torch.bool)
        dies = torch.zeros((B, N), dtype=torch.bool)
        ev = _ev_zeros(batch, B, N)
        for i in torch.nonzero(cur).flatten().tolist():
            passed[i] = self._walk_row(st, batch, i, int(khash[i]), dies, ev)
        out = _keyed_output(self, batch, now, passed & cur, dies, ev)
        return ({"buf": buf, "keys": keys, "counts": counts,
                 "next_seq": next_seq}, out)

    def _walk_row(self, st, batch, i, kh, dies, ev) -> bool:
        buf, keys, counts = st["buf"], st["keys"], st["counts"]
        valid = buf["valid"]
        found = valid & (keys == kh)
        if bool(found.any()):
            s = int(torch.argmax(found.to(torch.int8)))
            _store(buf, s, batch, i)
            keys[s] = kh
            counts[s] += 1
            return True
        if int(valid.sum()) < self.N:
            s = int(torch.argmin(valid.to(torch.int8)))
            _store(buf, s, batch, i)
            keys[s] = kh
            counts[s] = 1
            return True
        dec = counts - valid.to(I64)
        d = valid & (dec <= 0)
        dies[i] = d
        if self.expired_enabled:
            _capture(ev, buf, i, d)
        valid &= ~d
        counts.copy_(torch.where(d, torch.zeros_like(dec), dec))
        if not bool(d.any()):
            return False
        s = int(torch.argmin(valid.to(torch.int8)))
        _store(buf, s, batch, i)
        keys[s] = kh
        counts[s] = 1
        return True

    def findable_buffer(self, state, device=None):
        return state["buf"]


class LossyFrequentWindowOp(FrequentWindowOp):
    """#window.lossyFrequent(support [, error [, attrs...]]): lossy
    counting over CAP = 32 slots. A key whose count reaches
    (support - error) of the events so far passes; every ceil(1/error)
    events the slots with count + bucket <= the current bucket are
    pruned and their stored events emitted EXPIRED (ts = now), after the
    passing event. An event finding no slot is counted as overflow.
    ``width`` and ``thresh`` are the reference's Python float arithmetic
    at compile time; the pass test compares the updated count as a
    double against thresh * total."""

    kind_name = "lossyFrequent"
    LOSSY = True
    CAP = 32

    def __init__(self, schema, support: float, error: Optional[float],
                 key_idxs: list, expired_enabled: bool = True):
        WindowOp.__init__(self, schema, expired_enabled)
        self.support = float(support)
        self.error = float(error) if error is not None else \
            self.support / 10.0
        if not 0 < self.error < 1:
            raise CompileError("lossyFrequent error must be in (0,1)")
        self.width = int(-(-1.0 // self.error)) or 1  # ceil(1/error)
        self.thresh = self.support - self.error
        self.N = self.CAP
        self.key_idxs = list(key_idxs) or list(range(len(schema.types)))

    def init_state(self, device="cpu"):
        C = self.CAP
        return {"buf": empty_buffer(self.schema, C, device),
                "keys": torch.zeros((C,), dtype=I64, device=device),
                "counts": torch.zeros((C,), dtype=I64, device=device),
                "buckets": torch.zeros((C,), dtype=I64, device=device),
                "total": _i64(0, device), "overflow": _i64(0, device),
                "next_seq": _i64(0, device)}

    def step_ref(self, state, batch: EventBatch, now):
        dev = batch.ts.device
        if dev.type != "cpu":
            return _to_dev(*self.step_ref(*_host_copy(state, batch, now)),
                           dev)
        B, C = batch.capacity, self.CAP
        cur, seq, next_seq = arrival_seqs(batch, state["next_seq"])
        khash = _key_hash(batch, self.key_idxs)
        buf = _clone_buf(state["buf"])
        keys, counts = state["keys"].clone(), state["counts"].clone()
        buckets = state["buckets"].clone()
        total, ovf = int(state["total"]), int(state["overflow"])
        passed = torch.zeros((B,), dtype=torch.bool)
        dies = torch.zeros((B, C), dtype=torch.bool)
        ev = _ev_zeros(batch, B, C)
        width, thresh = self.width, self.thresh
        for i in torch.nonzero(cur).flatten().tolist():
            kh = int(khash[i])
            total += 1
            bucket = (total + width - 1) // width
            valid = buf["valid"]
            found = valid & (keys == kh)
            hit = bool(found.any())
            free_ok = bool((~valid).any())
            s = int(torch.argmax(found.to(torch.int8))) if hit else \
                int(torch.argmin(valid.to(torch.int8)))
            admitted = hit or free_ok
            if admitted:
                _store(buf, s, batch, i)
                keys[s] = kh
                if hit:
                    counts[s] += 1
                else:
                    counts[s] = 1
                    buckets[s] = bucket - 1
            else:
                ovf += 1
            passed[i] = admitted and \
                float(counts[s]) >= thresh * float(total)
            if total % width == 0:
                d = buf["valid"] & (counts + buckets <= bucket)
                dies[i] = d
                if self.expired_enabled:
                    _capture(ev, buf, i, d)
                buf["valid"] &= ~d
        out = _keyed_output(self, batch, now, passed & cur, dies, ev)
        return ({"buf": buf, "keys": keys, "counts": counts,
                 "buckets": buckets, "total": _i64(total, "cpu"),
                 "overflow": _i64(ovf, "cpu"), "next_seq": next_seq}, out)


def _clone_buf(buf) -> dict:
    return {k: (tuple(c.clone() for c in v) if isinstance(v, tuple)
                else v.clone()) for k, v in buf.items()}


def _store(buf, s: int, batch: EventBatch, i: int) -> None:
    buf["ts"][s] = batch.ts[i]
    for c, bc in zip(buf["cols"], batch.cols):
        c[s] = bc[i]
    for n, bn in zip(buf["nulls"], batch.nulls):
        n[s] = bn[i]
    buf["valid"][s] = True


def _ev_zeros(batch: EventBatch, B: int, N: int) -> dict:
    return {"cols": tuple(torch.zeros((B, N), dtype=c.dtype)
                          for c in batch.cols),
            "nulls": tuple(torch.zeros((B, N), dtype=torch.bool)
                           for _ in batch.nulls)}


def _capture(ev, buf, i: int, d) -> None:
    """Row i's dying slots, as the expired events it emits."""
    for e, c in zip(ev["cols"], buf["cols"]):
        e[i] = torch.where(d, c, torch.zeros_like(c))
    for e, n in zip(ev["nulls"], buf["nulls"]):
        e[i] = n & d


def _keyed_output(op, batch: EventBatch, now, passed, dies, ev):
    """The walk's [B * N] expired rows (ts = now) and [B] current rows in
    emission order: frequent emits a row's expired events before it
    (phase 0, then 2), lossyFrequent after it (phase 2, then 3). The
    expired candidates that do not die hold zeros (the reference holds
    the buffer there; only valid rows are ever read)."""
    B, N = dies.shape
    dev = batch.ts.device
    rows = torch.arange(B, dtype=I64, device=dev)
    ev_valid = dies.reshape(B * N) if op.expired_enabled \
        else torch.zeros((B * N,), dtype=torch.bool, device=dev)
    ecols = [c.reshape(B * N) for c in ev["cols"]]
    enulls = [n.reshape(B * N) for n in ev["nulls"]]
    ets = _i64(now, dev).expand(B * N)
    erow = rows.repeat_interleave(N)
    if op.LOSSY:
        out = {"ts": torch.cat([batch.ts, ets]),
               "cols": tuple(torch.cat([b, e]) for b, e in
                             zip(batch.cols, ecols)),
               "nulls": tuple(torch.cat([b, e]) for b, e in
                              zip(batch.nulls, enulls)),
               "kind": _kinds(dev, (B, CURRENT), (B * N, EXPIRED))}
        emit_row = torch.cat([rows, erow])
        phase = torch.cat([_full(B, 2, I64, dev), _full(B * N, 3, I64, dev)])
        valid = torch.cat([passed, ev_valid])
    else:
        out = {"ts": torch.cat([ets, batch.ts]),
               "cols": tuple(torch.cat([e, b]) for b, e in
                             zip(batch.cols, ecols)),
               "nulls": tuple(torch.cat([e, b]) for b, e in
                              zip(batch.nulls, enulls)),
               "kind": _kinds(dev, (B * N, EXPIRED), (B, CURRENT))}
        emit_row = torch.cat([erow, rows])
        phase = torch.cat([_full(B * N, 0, I64, dev), _full(B, 2, I64, dev)])
        valid = torch.cat([ev_valid, passed])
    return emission_sort(out, emit_row, phase, valid, B * N + B)


def freq_window_step(op: FrequentWindowOp, state, batch: EventBatch, now):
    """Kernel E: the frequent or lossyFrequent window's step. A batch on
    the CPU takes the plain version; a CUDA batch launches
    csrc/window_seq.cu (one warp walks the rows in order, the table in
    its lanes; no host sync). Inside a partition block or a pool ([K, B]
    batch, a state a slot) the kernel runs one warp a slot, counted as
    ``freq_window[K]``."""
    dev = batch.ts.device
    if dev.type == "cpu":
        return freq_window_step_ref(op, state, batch, now)
    if dev.type != "cuda":
        raise ValueError(f"freq_window_step: unsupported device {dev}")
    new_state, out, args = freq_args(op, state, batch, _i64(now, dev))
    _kernels.load().freq_window(args,
                                torch.cuda.current_stream(dev).cuda_stream)
    _kernels.count_launch("freq_window[K]" if batch.ts.dim() == 2
                          else "freq_window")
    return new_state, out


def freq_window_step_ref(op: FrequentWindowOp, state, batch: EventBatch,
                         now):
    """Plain PyTorch version of kernel E (the slot axis:
    ``freq_window_slots_ref``)."""
    if batch.ts.dim() == 2:
        return freq_window_slots_ref(op, state, batch, now)
    return op.step_ref(state, batch, now)


def freq_window_slots_ref(op: FrequentWindowOp, state, batch: EventBatch,
                          now):
    """Kernel E's plain version over the slot axis in one call ([K, B]
    batch, [K, N] tables): the row walk of ``step_ref`` run for every
    slot at once, each slot's r-th CURRENT row at walk step r; each
    slot's state and output equal ``step_ref``'s on that slot alone."""
    dev = batch.ts.device
    K, B = batch.ts.shape
    N = op.N
    cur = batch.valid & (batch.kind == CURRENT)
    khash = _key_hash(flat(batch), op.key_idxs).reshape(K, B)
    buf = _clone_buf(state["buf"])
    keys, counts = state["keys"].clone(), state["counts"].clone()
    if op.LOSSY:
        buckets = state["buckets"].clone()
        total, ovf = state["total"].clone(), state["overflow"].clone()
    passed = torch.zeros((K, B), dtype=torch.bool, device=dev)
    dies = torch.zeros((K, B, N), dtype=torch.bool, device=dev)
    ev = {"cols": tuple(torch.zeros((K, B, N), dtype=c.dtype, device=dev)
                        for c in batch.cols),
          "nulls": tuple(torch.zeros((K, B, N), dtype=torch.bool,
                                     device=dev) for _ in batch.nulls)}
    order, ncur = _rows_in_order(cur)
    ks = torch.arange(K, device=dev)

    def capture(kk, i, d):
        dies[kk, i] = d
        if op.expired_enabled:
            for e, c in zip(ev["cols"], buf["cols"]):
                e[kk, i] = torch.where(d, c[kk], torch.zeros_like(c[kk]))
            for e, n in zip(ev["nulls"], buf["nulls"]):
                e[kk, i] = n[kk] & d

    def first(m):
        return torch.argmax(m.to(torch.int8), dim=1)

    for r in range(int(ncur.max()) if K else 0):
        act = ncur > r
        kk, i = ks[act], order[act, r]
        kh = khash[kk, i]
        valid = buf["valid"][kk]
        found = valid & (keys[kk] == kh[:, None])
        hit = found.any(1)
        if not op.LOSSY:
            full = ~hit & (valid.sum(1) >= N)
            dec = counts[kk] - valid.to(I64)
            d = valid & (dec <= 0) & full[:, None]
            capture(kk[full], i[full], d[full])
            counts[kk] = torch.where(full[:, None],
                                     torch.where(d, torch.zeros_like(dec),
                                                 dec), counts[kk])
            valid = valid & ~d
            buf["valid"][kk] = valid
            ok = hit | ~full | d.any(1)
            s = torch.where(hit, first(found), first(~valid))
            cnt = torch.where(hit, counts[kk, s] + 1, torch.ones_like(s))
        else:
            total[kk] += 1
            t = total[kk]
            bucket = _floordiv(t + op.width - 1, op.width)
            ok = hit | (~valid).any(1)
            s = torch.where(hit, first(found), first(~valid))
            cnt = torch.where(hit, counts[kk, s] + 1, torch.ones_like(s))
            ovf[kk] += (~ok).to(I64)
            bkt = torch.where(hit, buckets[kk, s], bucket - 1)
            buckets[kk[ok], s[ok]] = bkt[ok]
        ka, ia, sa = kk[ok], i[ok], s[ok]
        _put_rows(buf, ka, sa, batch, ia)
        keys[ka, sa] = kh[ok]
        counts[ka, sa] = cnt[ok]
        if not op.LOSSY:
            passed[ka, ia] = True
            continue
        passed[kk, i] = ok & (counts[kk, s].to(torch.float64) >=
                              op.thresh * t.to(torch.float64))
        prune = torch.remainder(t, op.width) == 0
        kp, ip = kk[prune], i[prune]
        d = buf["valid"][kp] & (counts[kp] + buckets[kp] <=
                                bucket[prune][:, None])
        capture(kp, ip, d)
        buf["valid"][kp] &= ~d
    new = {"buf": buf, "keys": keys, "counts": counts}
    if op.LOSSY:
        new.update(buckets=buckets, total=total, overflow=ovf)
    new["next_seq"] = state["next_seq"] + cur.sum(1)
    return new, _keyed_output_slots(op, batch, now, passed & cur, dies, ev)


def _keyed_output_slots(op, batch: EventBatch, now, passed, dies, ev):
    """``_keyed_output`` of every slot at once ([K, B] rows, [K, B, N]
    dying slots)."""
    K, B, N = dies.shape
    dev = batch.ts.device
    rows = torch.arange(B, dtype=I64, device=dev)
    ev_valid = dies.reshape(K, B * N) if op.expired_enabled \
        else torch.zeros((K, B * N), dtype=torch.bool, device=dev)
    ecols = [c.reshape(K, B * N) for c in ev["cols"]]
    enulls = [n.reshape(K, B * N) for n in ev["nulls"]]
    ets = _i64(now, dev).expand(K, B * N)
    erow = rows.repeat_interleave(N)

    def cat(*xs):
        return torch.cat([x.expand(K, -1) for x in xs], 1)
    if op.LOSSY:
        out = {"ts": cat(batch.ts, ets),
               "cols": tuple(cat(b, e) for b, e in zip(batch.cols, ecols)),
               "nulls": tuple(cat(b, e) for b, e in
                              zip(batch.nulls, enulls)),
               "kind": _kinds(dev, (B, CURRENT), (B * N, EXPIRED))}
        emit_row = torch.cat([rows, erow])
        phase = torch.cat([_full(B, 2, I64, dev), _full(B * N, 3, I64, dev)])
        valid = torch.cat([passed, ev_valid], 1)
    else:
        out = {"ts": cat(ets, batch.ts),
               "cols": tuple(cat(e, b) for b, e in zip(batch.cols, ecols)),
               "nulls": tuple(cat(e, b) for b, e in
                              zip(batch.nulls, enulls)),
               "kind": _kinds(dev, (B * N, EXPIRED), (B, CURRENT))}
        emit_row = torch.cat([erow, rows])
        phase = torch.cat([_full(B * N, 0, I64, dev), _full(B, 2, I64, dev)])
        valid = torch.cat([ev_valid, passed], 1)
    out["kind"] = out["kind"].expand(K, -1)
    return emission_sort_slots(out, emit_row, phase, valid, B * N + B)


def _key_spec(a, batch: EventBatch, key_idxs) -> None:
    if len(key_idxs) > _kernels.WIN_MAX_COLS:
        raise NotImplementedError(
            f"not ported yet: more than {_kernels.WIN_MAX_COLS} key "
            "attributes")
    a.n_keys = len(key_idxs)
    for k, idx in enumerate(key_idxs):
        a.key_col[k] = idx
        a.key_type[k] = DTYPE_VT[batch.cols[idx].dtype]


def freq_args(op: FrequentWindowOp, state, batch: EventBatch, now):
    """Kernel E's arguments: the new state's and the output batch's
    tensors (fresh), the scratch, and ``_kernels.FreqArgs``.
    -> (state', output batch, args). With the slot axis ([K, B] batch)
    every tensor leads with it, ``n_part`` is K and ``moves`` holds the
    slot strides (ops/slots.py part_moves)."""
    dev = batch.ts.device
    slotted = batch.ts.dim() == 2
    lead = tuple(batch.ts.shape[:1]) if slotted else ()
    B, C, N = batch.ts.shape[-1], len(batch.cols), op.N
    if C > _kernels.WIN_MAX_COLS:
        raise NotImplementedError(
            f"not ported yet: a {op.kind_name} window over more than "
            f"{_kernels.WIN_MAX_COLS} attributes")
    buf = state["buf"]
    M = B * N + B

    def like(t, n):
        return torch.empty(lead + (n,), dtype=t.dtype, device=dev)

    def scalar():
        return torch.empty(lead, dtype=I64, device=dev)
    na = {"ts": like(buf["ts"], N), "seq": buf["seq"].clone(),
          "cols": tuple(like(c, N) for c in buf["cols"]),
          "nulls": tuple(like(n, N) for n in buf["nulls"]),
          "valid": like(buf["valid"], N)}
    new = {"buf": na, "keys": like(state["keys"], N),
           "counts": like(state["counts"], N)}
    if op.LOSSY:
        new["buckets"] = like(state["buckets"], N)
        for k in ("total", "overflow"):
            new[k] = scalar()
    new["next_seq"] = scalar()
    out = EventBatch(ts=like(batch.ts, M),
                     cols=tuple(like(c, M) for c in batch.cols),
                     nulls=tuple(like(n, M) for n in batch.nulls),
                     kind=like(batch.kind, M), valid=like(batch.valid, M))
    sc = {"hk": torch.empty(lead + (B,), dtype=I64, device=dev),
          "dmask": torch.empty(lead + (B,), dtype=I64, device=dev),
          "vbefore": torch.empty(lead + (B,), dtype=torch.int32, device=dev),
          "cbefore": torch.empty(lead + (B,), dtype=torch.int32, device=dev),
          "scal": torch.empty(lead + (4,), dtype=I64, device=dev)}
    a = _kernels.FreqArgs()
    _win_buf(a.batch, batch.ts, None, batch.cols, batch.nulls, batch.valid)
    a.batch_kind = batch.kind.data_ptr()
    _win_buf(a.a, buf["ts"], None, buf["cols"], buf["nulls"], buf["valid"])
    _win_buf(a.na, na["ts"], None, na["cols"], na["nulls"], na["valid"])
    _win_buf(a.out, out.ts, None, out.cols, out.nulls, out.valid)
    a.out_kind = out.kind.data_ptr()
    for f in ("keys", "counts", "next_seq"):
        setattr(a, f, state[f].data_ptr())
        setattr(a, "o_" + f, new[f].data_ptr())
    if op.LOSSY:
        for f in ("buckets", "total", "overflow"):
            setattr(a, f, state[f].data_ptr())
            setattr(a, "o_" + f, new[f].data_ptr())
    a.now = now.data_ptr()
    for k, v in sc.items():
        setattr(a, k, v.data_ptr())
    for k, c in enumerate(batch.cols):
        a.col_size[k] = c.element_size()
    _key_spec(a, batch, op.key_idxs)
    a.n_cols, a.B, a.N = C, B, N
    a.lossy, a.expired_enabled = int(op.LOSSY), int(op.expired_enabled)
    if op.LOSSY:
        a.width, a.thresh = op.width, op.thresh
    a.n_part = lead[0] if slotted else 1
    part_moves(a, (state, batch, new, out, sc), dev)
    a._keep = (state, new, out, sc, now)   # alive until the launch
    return new, out, a


class SessionWindowOp(WindowOp):
    """#window.session(gap [, keyAttr]): per-key sessions. Arrivals pass
    as CURRENT and join their key's open session; a session whose gap
    elapses (by the event clock or a TIMER row) emits its members
    EXPIRED, in order, at its close row. The reference's vectorised
    step: rows grouped by (key slot, in-step session id), a session's
    close row a search of the running clock for its last member's ts +
    gap; the final session of a slot stays open in a [K, S] buffer. Keys
    beyond the K = 64 slot table and members beyond S = 128 are dropped
    and counted. Quirks kept: the backward pass that finds a session's
    last member's ts runs over every later row, not only its own
    slot's; and buffer cell (slot 0, member 0) takes the last write of
    the reference's scatter, where every row that does not stay writes
    the cell's old value."""

    kind_name = "session"
    K = 64   # key slots
    S = 128  # members per open session

    def __init__(self, schema, gap_ms: int, key_idx: Optional[int] = None,
                 expired_enabled: bool = True):
        super().__init__(schema, expired_enabled)
        self.gap = int(gap_ms)
        self.key_idx = key_idx

    def init_state(self, device="cpu"):
        K, S = self.K, self.S
        return {
            "keys": torch.zeros((K,), dtype=I64, device=device),
            "used": torch.zeros((K,), dtype=torch.bool, device=device),
            "buf": {"ts": torch.zeros((K, S), dtype=I64, device=device),
                    "cols": tuple(col_zeros(t, K * S, device).reshape(K, S)
                                  for t in self.schema.types),
                    "nulls": tuple(torch.zeros((K, S), dtype=torch.bool,
                                               device=device)
                                   for _ in self.schema.types),
                    "valid": torch.zeros((K, S), dtype=torch.bool,
                                         device=device)},
            "count": torch.zeros((K,), dtype=I64, device=device),
            "end": torch.full((K,), int(POS_INF), dtype=I64, device=device),
            "open": torch.zeros((K,), dtype=torch.bool, device=device),
            "next_seq": _i64(0, device),
            "overflow": _i64(0, device),
        }

    def step(self, state, batch: EventBatch, now):
        return session_step(self, state, batch, now)

    def next_due(self, state):
        return torch.where(state["open"], state["end"],
                           torch.full_like(state["end"],
                                           int(POS_INF))).amin(-1)

    def host_due_bound(self, ts_min: int) -> int:
        return ts_min + self.gap

    def step_ref(self, state, batch: EventBatch, now):
        """The reference's ``SessionWindowOp.step`` in torch ops, stable
        sorts where it sorts."""
        B, K, S, gap = batch.capacity, self.K, self.S, self.gap
        dev = batch.ts.device
        cur, seq, next_seq = arrival_seqs(batch, state["next_seq"])
        rt = running_time(batch)
        rt_max = rt[B - 1]
        if self.key_idx is not None:
            khash = hash_columns([batch.cols[self.key_idx]],
                                 [batch.nulls[self.key_idx]])
        else:
            khash = torch.zeros((B,), dtype=I64, device=dev)
        slots, keys, used, kovf = lookup_or_insert(
            state["keys"], state["used"], khash, cur)
        routed = cur & (slots >= 0)
        rows = torch.arange(B, dtype=I64, device=dev)
        # rows by slot, stable, the unrouted last
        order = torch.argsort(torch.where(routed, slots, int(I32_MAX)),
                              stable=True)
        inv = torch.empty_like(order)
        inv[order] = rows
        s_slot = torch.where(routed, slots, -1)[order]
        s_ts = batch.ts[order]
        s_valid = routed[order]
        same_prev = torch.zeros((B,), dtype=torch.bool, device=dev)
        same_prev[1:] = (s_slot[1:] == s_slot[:-1]) & s_valid[1:] & \
            s_valid[:-1]
        prev_ts = torch.cat([torch.zeros((1,), dtype=I64, device=dev),
                             s_ts[:-1]])
        cs = torch.clamp(s_slot, 0, K - 1).to(I64)
        carried_end, carried_open = state["end"][cs], state["open"][cs]
        boundary = s_valid & torch.where(
            same_prev, s_ts >= prev_ts + gap,
            ~carried_open | (s_ts >= carried_end))
        slot_first = s_valid & ~same_prev
        grp_break = slot_first | boundary
        sid = segmented_cumsum(grp_break.to(I64), s_slot) - 1
        fidx = torch.cummax(torch.where(slot_first, rows, -1), 0).values
        first_cont = slot_first & ~boundary
        cont = first_cont[torch.clamp(fidx, min=0)] & (fidx >= 0)
        joins_carried = s_valid & (sid == 0) & cont
        seg_key = s_slot.to(I64) * (B + 1) + sid
        is_last = torch.ones((B,), dtype=torch.bool, device=dev)
        is_last[:-1] = seg_key[:-1] != seg_key[1:]
        is_last = is_last & s_valid
        last_ts_rev = torch.flip(torch.cummax(torch.flip(torch.where(
            is_last, s_ts, int(NEG_INF)), (0,)), 0).values, (0,))
        close_ts_sorted = torch.where(s_valid, last_ts_rev + gap,
                                      int(POS_INF))
        closes_sorted = close_ts_sorted <= rt_max
        close_row_sorted = torch.searchsorted(rt, close_ts_sorted,
                                              side="left")
        # back to row order
        close_ts = close_ts_sorted[inv]
        closes = closes_sorted[inv] & routed
        close_row = torch.clamp(close_row_sorted[inv], 0, B - 1)
        row_sid = torch.where(routed, sid[inv], -1)
        row_joins_carried = joins_carried[inv] & routed
        # carried sessions: extended close or standalone timeout
        slot_c = torch.clamp(slots, 0, K - 1).to(I64)
        ext_close_ts = _seg_max(torch.where(row_joins_carried, close_ts,
                                            int(NEG_INF)), slot_c, K)
        has_ext = _seg_max(row_joins_carried.to(I64), slot_c, K) > 0
        slot_close_ts = torch.where(has_ext, ext_close_ts, state["end"])
        slot_closes = state["open"] & (slot_close_ts <= rt_max)
        slot_close_row = torch.clamp(torch.searchsorted(
            rt, slot_close_ts, side="left"), 0, B - 1)
        # emissions: carried members [K, S] close with their slot
        buf = state["buf"]
        c_valid = buf["valid"] & slot_closes[:, None]
        b_exp_valid = closes & torch.where(row_joins_carried,
                                           slot_closes[slot_c],
                                           torch.ones_like(closes))
        KS = K * S
        out = {"ts": torch.cat([buf["ts"].reshape(KS), batch.ts, batch.ts]),
               "cols": tuple(torch.cat([c.reshape(KS), bc, bc]) for c, bc in
                             zip(buf["cols"], batch.cols)),
               "nulls": tuple(torch.cat([n.reshape(KS), bn, bn]) for n, bn in
                              zip(buf["nulls"], batch.nulls)),
               "kind": _kinds(dev, (KS + B, EXPIRED), (B, CURRENT))}
        emit_row = torch.cat([slot_close_row.repeat_interleave(S),
                              torch.where(b_exp_valid, close_row, 0), rows])
        phase = torch.cat([_full(KS + B, 0, I64, dev), _full(B, 2, I64, dev)])
        if self.expired_enabled:
            exp_c, exp_b = c_valid.reshape(KS), b_exp_valid
        else:
            exp_c = torch.zeros((KS,), dtype=torch.bool, device=dev)
            exp_b = torch.zeros((B,), dtype=torch.bool, device=dev)
        result = emission_sort(out, emit_row, phase,
                               torch.cat([exp_c, exp_b, routed]), KS + 2 * B)
        # new state: a slot's final session (or the surviving carried
        # one) stays open if it did not close
        final_sid = _seg_max(torch.where(routed, row_sid, -1), slot_c, K)
        keep_carried = state["open"] & ~slot_closes
        stays = routed & ~closes & (row_sid == final_sid[slot_c])
        base = torch.where(keep_carried, state["count"], 0)
        s_rank = segmented_cumsum(stays[order].to(I64), s_slot)
        pos = base[slot_c] + s_rank[inv] - 1
        in_cap = stays & (pos < S)
        member_ovf = (stays & ~in_cap).sum(dtype=I64)
        new_buf = _session_scatter(buf, keep_carried, batch, in_cap, slot_c,
                                   pos)
        new_count = torch.clamp(base + torch.zeros((K,), dtype=I64,
                                                   device=dev).index_add(
            0, slot_c, stays.to(I64)), max=S)
        stay_end = _seg_max(torch.where(stays, close_ts, int(NEG_INF)),
                            slot_c, K)
        new_open = keep_carried | (_seg_max(stays.to(I64), slot_c, K) > 0)
        new_end = torch.where(stay_end > int(NEG_INF), stay_end,
                              torch.where(keep_carried, state["end"],
                                          int(POS_INF)))
        new_open = new_open & (new_end < int(POS_INF))
        return ({"keys": keys, "used": used, "buf": new_buf,
                 "count": new_count, "end": new_end, "open": new_open,
                 "next_seq": next_seq,
                 "overflow": state["overflow"] + kovf + member_ovf}, result)


def _seg_max(vals, seg, K: int):
    """jax.ops.segment_max over K segments (an empty one: the type's
    minimum)."""
    init = torch.full((K,), torch.iinfo(vals.dtype).min, dtype=vals.dtype,
                      device=vals.device)
    return init.scatter_reduce(0, seg, vals, "amax", include_self=True)


def _session_scatter(buf, keep_carried, batch: EventBatch, in_cap, slot_c,
                     pos):
    """The reference's ``tgt.at[sk, sp].set(where(in_cap, vals,
    tgt[sk, sp]))`` over the cleared buffer, as its scatter applies the
    rows, one after the other: an in-capacity row writes its own cell;
    every other row writes cell (0, 0)'s cleared value back, so that
    cell keeps a member only if no such row comes after it."""
    K, S = buf["valid"].shape
    dev = in_cap.device
    keep = keep_carried[:, None]
    B = in_cap.shape[0]
    rows = torch.arange(B, dtype=I64, device=dev)
    last_other = torch.where(~in_cap, rows, -1).max()
    at00 = in_cap & (slot_c == 0) & (pos == 0)
    mine = torch.where(at00, rows, -1).max()
    revert = last_other > mine
    sk, sp = slot_c[in_cap], pos[in_cap]

    def put(old, vals):
        t = torch.where(keep, old, torch.zeros_like(old))
        c00 = t[0, 0].clone()
        t = t.clone()
        t[sk, sp] = vals[in_cap]
        t[0, 0] = torch.where(revert, c00, t[0, 0])
        return t
    return {"ts": put(buf["ts"], batch.ts),
            "cols": tuple(put(c, bc) for c, bc in
                          zip(buf["cols"], batch.cols)),
            "nulls": tuple(put(n, bn) for n, bn in
                           zip(buf["nulls"], batch.nulls)),
            "valid": put(buf["valid"], torch.ones_like(batch.valid))}


def session_step(op: SessionWindowOp, state, batch: EventBatch, now):
    """Kernel F: the session window's step. A batch on the CPU takes the
    plain version; a CUDA batch launches csrc/session_step.cu (the slot
    probe, a stable radix sort by slot, the sessions' scans, the [K, S]
    buffers and the emission sort; no host sync). Inside a partition
    block or a pool ([P, B] batch, a state a slot) every stage runs with
    the slot axis (one block a slot, one sort segment a slot), counted
    as ``session_window[K]``."""
    dev = batch.ts.device
    if dev.type == "cpu":
        return session_step_ref(op, state, batch, now)
    if dev.type != "cuda":
        raise ValueError(f"session_step: unsupported device {dev}")
    new_state, out, args = session_args(op, state, batch)
    _kernels.load().session_window(args,
                                   torch.cuda.current_stream(dev).cuda_stream)
    _kernels.count_launch("session_window[K]" if batch.ts.dim() == 2
                          else "session_window")
    return new_state, out


def session_step_ref(op: SessionWindowOp, state, batch: EventBatch, now):
    """Plain PyTorch version of kernel F (the slot axis:
    ``session_slots_ref``)."""
    if batch.ts.dim() == 2:
        return session_slots_ref(op, state, batch, now)
    return op.step_ref(state, batch, now)


def session_slots_ref(op: SessionWindowOp, state, batch: EventBatch, now):
    """Kernel F's plain version over the slot axis in one call ([P, B]
    batch, [P, 64] key tables, [P, 64, 128] members): ``step_ref``'s
    stages with each row of every tensor one slot (the key probe through
    ``lookup_or_insert_tables``, sorts and scans along the row axis, the
    per-key reductions on slot-offset indices); each slot's state and
    output equal ``step_ref``'s on that slot alone."""
    P, B = batch.ts.shape
    K, S, gap = op.K, op.S, op.gap
    dev = batch.ts.device
    cur = batch.valid & (batch.kind == CURRENT)
    rt = torch.cummax(torch.where(batch.valid, batch.ts,
                                  torch.full_like(batch.ts, int(NEG_INF))),
                      1).values
    rt_max = rt[:, B - 1:]
    if op.key_idx is not None:
        khash = hash_columns([flat(batch).cols[op.key_idx]],
                             [flat(batch).nulls[op.key_idx]]).reshape(P, B)
    else:
        khash = torch.zeros((P, B), dtype=I64, device=dev)
    slots, keys, used, kovf = lookup_or_insert_tables(
        state["keys"], state["used"], khash, cur)
    routed = cur & (slots >= 0)
    rows = torch.arange(B, dtype=I64, device=dev).expand(P, B)
    off = torch.arange(P, dtype=I64, device=dev)[:, None]

    def take(x, idx):
        return torch.take_along_dim(x, idx, dim=1)

    def seg_max(vals, seg):   # per slot's K keys; empty: the minimum
        init = torch.full((P * K,), torch.iinfo(vals.dtype).min,
                          dtype=vals.dtype, device=dev)
        return init.scatter_reduce(0, (seg + off * K).reshape(-1),
                                   vals.reshape(-1), "amax",
                                   include_self=True).reshape(P, K)

    def seg_cumsum(vals, seg):   # runs of equal seg along each row
        return segmented_cumsum(vals.reshape(-1),
                                (seg.to(I64) + 1 + off * (K + 2)).reshape(
                                    -1)).reshape(P, B)
    order = torch.argsort(torch.where(routed, slots, int(I32_MAX)), dim=1,
                          stable=True)
    inv = torch.empty_like(order).scatter_(1, order, rows)
    s_slot = take(torch.where(routed, slots, -1), order)
    s_ts = take(batch.ts, order)
    s_valid = take(routed, order)
    same_prev = torch.zeros((P, B), dtype=torch.bool, device=dev)
    same_prev[:, 1:] = (s_slot[:, 1:] == s_slot[:, :-1]) & s_valid[:, 1:] & \
        s_valid[:, :-1]
    prev_ts = torch.cat([torch.zeros((P, 1), dtype=I64, device=dev),
                         s_ts[:, :-1]], 1)
    cs = torch.clamp(s_slot, 0, K - 1).to(I64)
    carried_end, carried_open = take(state["end"], cs), take(state["open"],
                                                             cs)
    boundary = s_valid & torch.where(
        same_prev, s_ts >= prev_ts + gap,
        ~carried_open | (s_ts >= carried_end))
    slot_first = s_valid & ~same_prev
    grp_break = slot_first | boundary
    sid = seg_cumsum(grp_break.to(I64), s_slot) - 1
    fidx = torch.cummax(torch.where(slot_first, rows, -1), 1).values
    first_cont = slot_first & ~boundary
    cont = take(first_cont, torch.clamp(fidx, min=0)) & (fidx >= 0)
    joins_carried = s_valid & (sid == 0) & cont
    seg_key = s_slot.to(I64) * (B + 1) + sid
    is_last = torch.ones((P, B), dtype=torch.bool, device=dev)
    is_last[:, :-1] = seg_key[:, :-1] != seg_key[:, 1:]
    is_last = is_last & s_valid
    last_ts_rev = torch.flip(torch.cummax(torch.flip(torch.where(
        is_last, s_ts, int(NEG_INF)), (1,)), 1).values, (1,))
    close_ts_sorted = torch.where(s_valid, last_ts_rev + gap, int(POS_INF))
    closes_sorted = close_ts_sorted <= rt_max
    close_row_sorted = torch.searchsorted(rt, close_ts_sorted, side="left")
    close_ts = take(close_ts_sorted, inv)
    closes = take(closes_sorted, inv) & routed
    close_row = torch.clamp(take(close_row_sorted, inv), 0, B - 1)
    row_sid = torch.where(routed, take(sid, inv), -1)
    row_joins_carried = take(joins_carried, inv) & routed
    slot_c = torch.clamp(slots, 0, K - 1).to(I64)
    ext_close_ts = seg_max(torch.where(row_joins_carried, close_ts,
                                       int(NEG_INF)), slot_c)
    has_ext = seg_max(row_joins_carried.to(I64), slot_c) > 0
    slot_close_ts = torch.where(has_ext, ext_close_ts, state["end"])
    slot_closes = state["open"] & (slot_close_ts <= rt_max)
    slot_close_row = torch.clamp(torch.searchsorted(
        rt, slot_close_ts, side="left"), 0, B - 1)
    buf = state["buf"]
    c_valid = buf["valid"] & slot_closes[:, :, None]
    b_exp_valid = closes & torch.where(row_joins_carried,
                                       take(slot_closes, slot_c),
                                       torch.ones_like(closes))
    KS = K * S
    out = {"ts": torch.cat([buf["ts"].reshape(P, KS), batch.ts, batch.ts],
                           1),
           "cols": tuple(torch.cat([c.reshape(P, KS), bc, bc], 1)
                         for c, bc in zip(buf["cols"], batch.cols)),
           "nulls": tuple(torch.cat([n.reshape(P, KS), bn, bn], 1)
                          for n, bn in zip(buf["nulls"], batch.nulls)),
           "kind": _kinds(dev, (KS + B, EXPIRED), (B, CURRENT)).expand(
               P, KS + 2 * B)}
    emit_row = torch.cat([slot_close_row.repeat_interleave(S, dim=1),
                          torch.where(b_exp_valid, close_row, 0), rows], 1)
    phase = torch.cat([_full(KS + B, 0, I64, dev), _full(B, 2, I64, dev)])
    if op.expired_enabled:
        exp_c, exp_b = c_valid.reshape(P, KS), b_exp_valid
    else:
        exp_c = torch.zeros((P, KS), dtype=torch.bool, device=dev)
        exp_b = torch.zeros((P, B), dtype=torch.bool, device=dev)
    result = emission_sort_slots(out, emit_row, phase,
                                 torch.cat([exp_c, exp_b, routed], 1),
                                 KS + 2 * B)
    final_sid = seg_max(torch.where(routed, row_sid, -1), slot_c)
    keep_carried = state["open"] & ~slot_closes
    stays = routed & ~closes & (row_sid == take(final_sid, slot_c))
    base = torch.where(keep_carried, state["count"], 0)
    s_rank = seg_cumsum(take(stays, order).to(I64), s_slot)
    pos = take(base, slot_c) + take(s_rank, inv) - 1
    in_cap = stays & (pos < S)
    member_ovf = (stays & ~in_cap).sum(1, dtype=I64)
    # the reference's scatter, row after row: cell (0, 0) keeps a member
    # only if no row that does not stay comes after it
    last_other = torch.where(~in_cap, rows, -1).amax(1)
    mine = torch.where(in_cap & (slot_c == 0) & (pos == 0), rows, -1).amax(1)
    revert = last_other > mine
    flat_at = ((off * K + slot_c) * S + torch.clamp(pos, 0, S - 1))[in_cap]

    def put(old, vals):
        t = torch.where(keep_carried[:, :, None], old, torch.zeros_like(old))
        c00 = t[:, 0, 0].clone()
        t = t.reshape((P * KS,) + tuple(t.shape[3:])).clone()
        t[flat_at] = vals[in_cap]
        t = t.reshape((P, K, S) + tuple(t.shape[1:]))
        t[:, 0, 0] = torch.where(revert, c00, t[:, 0, 0])
        return t
    new_buf = {"ts": put(buf["ts"], batch.ts),
               "cols": tuple(put(c, bc) for c, bc in
                             zip(buf["cols"], batch.cols)),
               "nulls": tuple(put(n, bn) for n, bn in
                              zip(buf["nulls"], batch.nulls)),
               "valid": put(buf["valid"], torch.ones_like(batch.valid))}
    adds = torch.zeros((P * K,), dtype=I64, device=dev).index_add(
        0, (slot_c + off * K).reshape(-1), stays.to(I64).reshape(-1))
    new_count = torch.clamp(base + adds.reshape(P, K), max=S)
    stay_end = seg_max(torch.where(stays, close_ts, int(NEG_INF)), slot_c)
    new_open = keep_carried | (seg_max(stays.to(I64), slot_c) > 0)
    new_end = torch.where(stay_end > int(NEG_INF), stay_end,
                          torch.where(keep_carried, state["end"],
                                      int(POS_INF)))
    new_open = new_open & (new_end < int(POS_INF))
    return ({"keys": keys, "used": used, "buf": new_buf,
             "count": new_count, "end": new_end, "open": new_open,
             "next_seq": state["next_seq"] + cur.sum(1, dtype=I64),
             "overflow": state["overflow"] + kovf + member_ovf}, result)


def session_args(op: SessionWindowOp, state, batch: EventBatch):
    """Kernel F's arguments: the new state's and the output batch's
    tensors (fresh), the scratch, and ``_kernels.SessArgs``.
    -> (state', output batch, args). With the slot axis ([P, B] batch)
    every tensor leads with it, ``n_part`` is P and ``moves`` holds the
    slot strides (ops/slots.py part_moves)."""
    dev = batch.ts.device
    slotted = batch.ts.dim() == 2
    lead = tuple(batch.ts.shape[:1]) if slotted else ()
    B, C, K, S = batch.ts.shape[-1], len(batch.cols), op.K, op.S
    if C > _kernels.WIN_MAX_COLS:
        raise NotImplementedError(
            f"not ported yet: a session window over more than "
            f"{_kernels.WIN_MAX_COLS} attributes")
    KS = K * S
    M = KS + 2 * B
    buf = state["buf"]

    def e(n, dtype):
        return torch.empty(lead + (max(int(n), 1),), dtype=dtype, device=dev)
    nb = {"ts": torch.empty_like(buf["ts"]),
          "cols": tuple(torch.empty_like(c) for c in buf["cols"]),
          "nulls": tuple(torch.empty_like(n) for n in buf["nulls"]),
          "valid": torch.empty_like(buf["valid"])}
    new = {"keys": e(K, I64), "used": e(K, torch.bool), "buf": nb,
           "count": e(K, I64), "end": e(K, I64), "open": e(K, torch.bool),
           "next_seq": torch.empty(lead, dtype=I64, device=dev),
           "overflow": torch.empty(lead, dtype=I64, device=dev)}
    out = EventBatch(ts=e(M, I64), cols=tuple(e(M, c.dtype)
                                               for c in batch.cols),
                     nulls=tuple(e(M, torch.bool) for _ in batch.cols),
                     kind=e(M, torch.int32), valid=e(M, torch.bool))
    blocks = (M + 1023) // 1024
    sc = {"hk": e(B, I64), "cur": e(B, torch.uint8),
          "slots": e(B, torch.int32), "prb": e(B, torch.int32),
          "flags": e(B, torch.uint8), "claim": e(K, torch.int32),
          "rt": e(B, I64), "order": e(B, torch.int32),
          "s_a": e(B, I64), "s_b": e(B, I64), "s_c": e(B, I64),
          "s_f": e(B, torch.uint8), "r_close_ts": e(B, I64),
          "r_close_row": e(B, torch.int32), "r_pos": e(B, I64),
          "r_flags": e(B, torch.uint8), "sl_close_row": e(K, torch.int32),
          "sl_flags": e(K, torch.uint8), "ekey": e(M, torch.int32),
          "eorder": e(M, torch.int32), "k1": e(M, torch.int32),
          "k2": e(M, torch.int32), "i1": e(M, torch.int32),
          "i2": e(M, torch.int32), "counts": e(256 * blocks, torch.int32),
          "scal": e(16, I64), "rkey": e(B, torch.int32),
          "rk1": e(B, torch.int32), "rk2": e(B, torch.int32),
          "ri1": e(B, torch.int32), "ri2": e(B, torch.int32),
          "rcounts": e(256 * ((B + 1023) // 1024), torch.int32)}
    a = _kernels.SessArgs()
    _win_buf(a.batch, batch.ts, None, batch.cols, batch.nulls, batch.valid)
    a.batch_kind = batch.kind.data_ptr()
    _win_buf(a.buf, buf["ts"], None, buf["cols"], buf["nulls"], buf["valid"])
    _win_buf(a.nbuf, nb["ts"], None, nb["cols"], nb["nulls"], nb["valid"])
    for f in ("keys", "used", "count", "end", "open", "next_seq",
              "overflow"):
        setattr(a, f, state[f].data_ptr())
        setattr(a, "o_" + f, new[f].data_ptr())
    _win_buf(a.out, out.ts, None, out.cols, out.nulls, out.valid)
    a.out_kind = out.kind.data_ptr()
    for k, v in sc.items():
        setattr(a, k, v.data_ptr())
    for k, c in enumerate(batch.cols):
        a.col_size[k] = c.element_size()
    a.n_cols, a.B, a.K, a.S, a.M = C, B, K, S, M
    a.has_key = int(op.key_idx is not None)
    a.key_col = op.key_idx if op.key_idx is not None else 0
    a.key_type = DTYPE_VT[batch.cols[a.key_col].dtype] if C else 0
    a.expired_enabled = int(op.expired_enabled)
    a.gap = op.gap
    a.n_part = lead[0] if slotted else 1
    part_moves(a, (state, batch, new, out, sc), dev)
    a._keep = (state, new, out, sc)   # alive until the launch
    return new, out, a
