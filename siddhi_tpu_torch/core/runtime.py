"""Runtime assembly (PyTorch port of siddhi_tpu/core/runtime.py): query
runtimes, the app runtime, and the planner that builds them from the
parsed query object model.

Reference mapping:
- SiddhiAppRuntimeImpl (core/SiddhiAppRuntimeImpl.java:99) -> SiddhiAppRuntime
- QueryRuntimeImpl (query/QueryRuntimeImpl.java:43)        -> QueryRuntime
- SiddhiAppParser/QueryParser/SingleInputStreamParser
  (util/parser/*.java)                                     -> Planner

Execution model: a query step is ``(states, emitted, batch, now) ->
(states', emitted', out)``. The reference jits each step into one XLA
program; here a packed chunk's step is a fixed sequence of kernel
launches on the app's device, with no host sync between them: K1
decodes the chunk (core/ingest.py unpack_packed), K2 runs the query's
filters and projection and counts the emitted rows (ops/expr.py
expr_eval). A query with a window and/or aggregators runs K1, the
filters before the window (K2), the window step (K5, ops/windows.py
window_step), then its selector: K2 for the filters after the window
and the group-by keys and arguments, K6's step (ops/aggregators.py
aggregate_step), K2 for the projection and having, and K6's emission.
A pattern query runs K1, then its NFA step, then K2 (or the aggregating
selector) over the match batch: K3 once per sub-batch of 4,096 events where the
reference's parallel_supported holds (ops/nfa_parallel.py
parallel_step), else K4 once per chunk, the per-event scan over a
128-row table (ops/nfa.py scan_step). An absent pattern's deadlines
are read back after each step and fire K4's timer step from the
scheduler. On the CPU every kernel takes its plain PyTorch version.

A join query runs each side's chain (K1, its filters through K2, its
window through K5), then K7 (ops/join.py join_probe or join_grid)
against the opposite side's findable buffer, or against a table's
seq-ordered view (K8 table_buffer), then the selector. Table outputs
and IN-table filters run K8 (ops/table.py); on-demand queries over
tables run in core/ondemand.py.

A partition block (``partition with ... begin ... end``) runs as
parallel/partition.py's PartitionBlockRuntime: K9p routes each row to
its key slot, the inner queries run K2 and K4, K5 and K6 with the slot
axis, and K9p compacts each outer query's output (plan_partition).

The port plans single-stream queries with filters, one window of any
kind, and a plain or aggregating selector with having,
order-by, offset and limit (kernel G; a STRING order-by shapes the
decoded rows at the host edge, ``_host_shape_rows``); insert-into
chains between them; pattern and sequence queries; joins of two
streams or of a stream and a table; in-memory tables; and partition
blocks of single-stream and pattern queries (``_check_block_ops`` names
what a block does not run yet); named windows (one shared window
instance a definition, fed by ``insert into`` and read by queries, joins
and on-demand queries); and incremental aggregations
(core/aggregation.py, kernel K11); triggers, the cron window (kernel
K5c), output rate limiters (core/ratelimit.py) and ``@watermark``
reorder buffers (resilience/ordering.py, kernel K10). @Store tables,
sources and sinks raise NotImplementedError ("not ported yet") on every
device.
Window timers fire from the scheduler as in the reference
(QueryRuntime._schedule / _on_timer).
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import os
import threading
import time
from typing import Callable, Optional

import torch

from .. import _kernels
from ..lang import ast as A
from ..ops.aggregators import AggregateOp
from ..ops.expr import CompileError, ProgramBuilder, SingleStreamScope, \
    compile_expression, expr_eval
from ..ops.nfa import (MatchScope, NfaCompiler, NfaEngine, rewrite_last_refs,
                       rewrite_oob_refs, timer_step)
from ..ops.nfa_parallel import ParallelNfaEngine, parallel_supported
from ..ops.operators import FilterOp, Operator
from ..ops.selector import (OutputScope, ProjectOp, project,
                            selector_needs_aggregation)
from ..ops.sentinels import POS_INF
from ..ops.streamfn import StreamFunctionOp, make_stream_function
from ..ops.join import (JoinCombinedScope, JoinCross, JoinSideScope,
                        combined_schema)
from ..ops.table import (TableFilterOp, TableOutputOp, TableRuntime,
                         expr_mentions_table)
from ..ops.windows2 import (BatchWindowOp, CronWindowOp, DelayWindowOp,
                            ExternalTimeBatchWindowOp, ExternalTimeWindowOp,
                            FrequentWindowOp, HoppingWindowOp,
                            LossyFrequentWindowOp, SessionWindowOp,
                            SortWindowOp, TimeLengthWindowOp)
from ..ops.windows import (EmptyWindowOp, LengthBatchWindowOp,
                           LengthWindowOp, TimeBatchWindowOp, TimeWindowOp,
                           WindowOp)
from .event import (CURRENT, EXPIRED, TIMER, Attribute, EventBatch,
                    StreamSchema, batch_from_rows, rows_from_batch)
from .ingest import PackedChunk, unpack_packed
from .scheduler import Scheduler
from .stream import (Event, InputHandler, QueryCallback, Receiver,
                     StreamCallback, StreamJunction)
from .types import AttrType

BATCH_BUCKETS = (16, 128, 1024, 8192, 65536, 262144, 1048576)

# step capacity of a query with a window, aggregators or order-by (the
# reference's cap, kept: the send path chunks to it, and a larger device
# batch chained in from another query is split to it)
SORT_HEAVY_CAP = 65536
# the same cap inside a partition block: each of its steps runs every
# operator over K slots (parallel/partition.py)
PARTITION_SORT_HEAVY_CAP = 8192

WINDOW_CLASSES = {
    "time": TimeWindowOp,
    "length": LengthWindowOp,
    "lengthbatch": LengthBatchWindowOp,
    "timebatch": TimeBatchWindowOp,
    "externaltime": ExternalTimeWindowOp,
    "timelength": TimeLengthWindowOp,
    "delay": DelayWindowOp,
    "batch": BatchWindowOp,
    "sort": SortWindowOp,
    "externaltimebatch": ExternalTimeBatchWindowOp,
    "hopping": HoppingWindowOp,
    "hoping": HoppingWindowOp,   # the reference's spelling
    "frequent": FrequentWindowOp,
    "lossyfrequent": LossyFrequentWindowOp,
    "session": SessionWindowOp,
    "cron": CronWindowOp,
}
# the reference's other window kinds (siddhi_tpu/ops/windows2.py)
UNPORTED_WINDOWS = ()


JOIN_KERNEL_ENV = "SIDDHI_TPU_JOIN_KERNEL"


def _pick_join_kernel(cross) -> tuple[str, str, str]:
    """Join kernel for one JoinCross: ``(kernel, reason, cause)``. The
    banded probe where the ON condition carries an ``L == R`` conjunct,
    the grid otherwise; ``SIDDHI_TPU_JOIN_KERNEL=grid|probe`` overrides
    (probe falls back to the grid without an equi conjunct). Both are
    hand-written kernels (K7). The port has no cost table yet, so an
    equi join's cause is ``no-cost-table``, as in the reference without
    one."""
    env = os.environ.get(JOIN_KERNEL_ENV, "").strip().lower()
    eligible = cross.equi is not None
    if env == "grid":
        return "grid", "SIDDHI_TPU_JOIN_KERNEL=grid override", \
            "env-override"
    if env == "probe":
        if eligible:
            return "probe", "SIDDHI_TPU_JOIN_KERNEL=probe override", \
                "env-override"
        return "grid", ("SIDDHI_TPU_JOIN_KERNEL=probe requested but the "
                        "ON condition has no equi conjunct — grid "
                        "fallback"), "no-equi-conjunct"
    if not eligible:
        return "grid", ("no equi conjunct in ON condition (the banded "
                        "probe needs one)"), "no-equi-conjunct"
    return "probe", ("equi ON condition (banded searchsorted probe); "
                     "no cost table measured yet"), "no-cost-table"


def bucket_capacity(n: int) -> int:
    i = bisect.bisect_left(BATCH_BUCKETS, n)
    if i == len(BATCH_BUCKETS):
        return BATCH_BUCKETS[-1]
    return BATCH_BUCKETS[i]


def not_ported(what: str):
    return NotImplementedError(f"not ported yet: {what}")


def _as_current(batch: EventBatch) -> EventBatch:
    """Insert-into kind rewrite (InsertIntoStreamCallback.java:52-55):
    EXPIRED events become CURRENT on insert."""
    return EventBatch(
        ts=batch.ts, cols=batch.cols, nulls=batch.nulls,
        kind=torch.where(batch.valid, torch.full_like(batch.kind, CURRENT),
                         batch.kind),
        valid=batch.valid)


def _chain_body(ops):
    """One query's operator chain as a step:
    (states, emitted, batch, now) -> (states', out). Consecutive filters
    lower into ONE kernel K2 program with the projection after them, or
    into the K2 program of the aggregating selector after them, or, before
    a window, into a K2 filter program of their own; windows run K5 and
    aggregating selectors K6. The step adds the emitted rows to
    ``emitted`` in place."""
    stages, filters = [], []
    for i, op in enumerate(ops):
        if isinstance(op, FilterOp):
            filters.append(op)
            continue
        if getattr(op, "needs_tables", False):
            # an IN-table filter or a table output: kernel K8 (and K2)
            if filters:
                b = ProgramBuilder()
                for f in filters:
                    f.lower(b)
                stages.append(("filter", i, b.build()))
                filters = []
            stages.append(("tables", i, None))
            continue
        if isinstance(op, (WindowOp, StreamFunctionOp)):
            if filters:
                b = ProgramBuilder()
                for f in filters:
                    f.lower(b)
                stages.append(("filter", i, b.build()))
            stages.append(("window", i, None))
        elif isinstance(op, AggregateOp):
            op.pre_filters = list(filters)
            stages.append(("aggregate", i, None))
        else:
            assert isinstance(op, ProjectOp), type(op).__name__
            b = ProgramBuilder()
            for f in filters:
                f.lower(b)
            op.lower(b)
            stages.append(("project", i, b.build()))
        filters = []
    # a named window's chain is its window alone (Planner.plan)
    assert not filters and (any(k in ("project", "aggregate")
                                for k, _i, _p in stages)
                            or [k for k, _i, _p in stages] == ["window"]), \
        "a query chain ends in its selector (and its table output)"

    def chain(states, emitted, batch, now, tstates=None):
        """``tstates``: the states of the tables the chain touches, by
        table id, replaced in place by the chain's table stages."""
        states = list(states)
        for kind, i, prog in stages:
            if kind == "tables":
                states[i], batch, new = ops[i].step_tables(
                    states[i], batch, now, tstates)
                tstates.update(new)
            elif kind == "filter":
                _c, _n, valid = expr_eval(prog, batch, now=now)
                batch = EventBatch(batch.ts, batch.cols, batch.nulls,
                                   batch.kind, valid)
            elif kind == "window":
                states[i], batch = ops[i].step(states[i], batch, now)
            elif kind == "aggregate":
                states[i], batch = ops[i].step(states[i], batch, now,
                                               emitted)
            else:
                batch = project(ops[i], prog, batch, emitted, now)
        return tuple(states), batch

    chain.program = [p for k, _i, p in stages if k != "tables"][-1]
    return chain


def _timer_windows(operators) -> list:
    """Window ops that schedule timers."""
    return [op for op in operators if isinstance(op, WindowOp)
            and op.next_due(op.init_state()) is not None]


def _all_host_due(timer_ops) -> bool:
    return bool(timer_ops) and all(
        getattr(op, "host_due_bound", None) is not None for op in timer_ops)


def _timer_batch(schema: StreamSchema, due: int, device) -> EventBatch:
    """A 16-row batch whose one valid row is a TIMER at ``due``."""
    cap = BATCH_BUCKETS[0]
    batch = batch_from_rows(schema, [], [], cap, device=device)
    ts = torch.zeros((cap,), dtype=torch.int64)
    ts[0] = due
    kind = torch.zeros((cap,), dtype=torch.int32)
    kind[0] = TIMER
    valid = torch.zeros((cap,), dtype=torch.bool)
    valid[0] = True
    return EventBatch(ts=ts.to(device), cols=batch.cols, nulls=batch.nulls,
                      kind=kind.to(device), valid=valid.to(device))


def _build_packed_step(chain, schema: StreamSchema) -> Callable:
    """Unpack + chain over a PackedChunk's single buffer: K1 then K2."""
    types = schema.types

    def pstep(states, emitted, chunk: PackedChunk, tstates=None):
        batch, now = unpack_packed(types, chunk.enc, chunk.capacity,
                                   chunk.buf)
        return chain(states, emitted, batch, now, tstates)

    return pstep


class OutputHandler:
    def handle(self, timestamp: int, rows: list) -> None:
        raise NotImplementedError

    def handle_device_batch(self, out, timestamp: int,
                            current=None) -> bool:
        """Try to consume the device output batch without host row decode
        (device-to-device query chaining). Returns True when consumed.
        ``current`` is a memoized supplier of the CURRENT-kind-rewritten
        batch, built once per emitted batch."""
        return False


class InsertIntoStreamHandler(OutputHandler):
    """Publish query output into a stream junction; EXPIRED events become
    CURRENT on insert (InsertIntoStreamCallback.java:52-55). When every
    downstream receiver takes device batches, the output EventBatch is
    handed over directly — no host decode per hop."""

    def __init__(self, junction: StreamJunction, output_event_type: str):
        self.junction = junction
        self.output_event_type = output_event_type

    def handle_device_batch(self, out, timestamp: int,
                            current=None) -> bool:
        receivers = self.junction.receivers
        if not receivers:
            return True  # nobody listening — drop without decode
        if all(hasattr(r, "process_batch") for r in receivers):
            cur = current() if current is not None else _as_current(out)
            self.junction.publish_batch(cur, timestamp)
            return True
        return False

    def handle(self, timestamp, rows):
        events = [Event(timestamp=ts, data=vals) for ts, kind, vals in rows]
        self.junction.publish(events)


class InsertIntoWindowHandler(OutputHandler):
    """``insert into <named window>``: feed the shared window instance
    (query/output/callback/InsertIntoWindowCallback.java): inserted
    events enter the window as fresh CURRENT arrivals."""

    def __init__(self, wq: "QueryRuntime"):
        self.wq = wq

    def handle_device_batch(self, out, timestamp, current=None):
        cur = current() if current is not None else _as_current(out)
        self.wq.process_batch(cur, timestamp)
        return True

    def handle(self, timestamp, rows):
        """Rows from a rate limiter enter the window as CURRENT events."""
        self.wq.receive([Event(ts, vals) for ts, kind, vals in rows])


class WindowPublishHandler(OutputHandler):
    """Publish a named window's output with its kinds kept, so consuming
    queries see CURRENT and EXPIRED rows as after an inline window
    (window/Window.java:65); the definition's output event type filters
    what subscribers observe."""

    def __init__(self, junction: StreamJunction, out_type: str):
        self.junction = junction
        self.out_type = out_type

    def _filtered(self, out):
        if self.out_type == "current":
            return out.mask(out.kind == CURRENT)
        if self.out_type == "expired":
            return out.mask(out.kind == EXPIRED)
        return out

    def handle_device_batch(self, out, timestamp, current=None):
        self.junction.publish_batch(self._filtered(out), timestamp)
        return True


class QueryCallbackHandler(OutputHandler):
    def __init__(self):
        self.callbacks: list[QueryCallback] = []

    def handle(self, timestamp, rows):
        if not self.callbacks:
            return
        in_events = [Event(ts, vals) for ts, kind, vals in rows
                     if kind == CURRENT]
        rm_events = [Event(ts, vals, is_expired=True)
                     for ts, kind, vals in rows if kind == EXPIRED]
        if not in_events and not rm_events:
            return
        for cb in self.callbacks:
            cb.receive(timestamp, in_events or None, rm_events or None)


class QueryRuntime(Receiver):
    """One query: an operator chain run as one device step."""

    supports_packed = True

    def __init__(self, name: str, operators: list[Operator],
                 in_schema: StreamSchema, app: "SiddhiAppRuntime"):
        self.name = name
        self.operators = operators
        self.in_schema = in_schema
        self.out_schema = operators[-1].out_schema
        self.app = app
        self.output_handlers: list[OutputHandler] = []
        self.callback_handler = QueryCallbackHandler()
        # raw device-batch observers (no host row decode)
        self.batch_callbacks: list[Callable] = []
        self.states = _tree_to(tuple(op.init_state() for op in operators),
                               app.device)
        # the tables the chain reads or writes, locked in sorted order
        self.table_deps = sorted({t for op in operators
                                  for t in getattr(op, "table_ids",
                                                   tuple)()})
        self.max_step_capacity = SORT_HEAVY_CAP if any(
            getattr(op, "sort_heavy", False) for op in operators) else None
        # timers: when every timer window offers a host due bound, steps
        # schedule them with no device read; else the due is read back
        self._timer_ops = _timer_windows(operators)
        self._has_timers = bool(self._timer_ops)
        self._host_due_all = _all_host_due(self._timer_ops)
        # host-computed schedules (cron windows: the next fire time cannot
        # come from device state)
        self._host_sched = [op.host_schedule for op in operators
                            if getattr(op, "host_schedule", None)]
        self._sched_due: Optional[int] = None
        # clock of the latest event step: timers due at or before it were
        # covered by the step's own per-row expiry (see _schedule)
        self._last_now = -(2 ** 62)
        self._skip_past_dues = not any(
            getattr(op, "needs_catchup", False) for op in operators)
        self.rate_limiter = None
        self._chain = _chain_body(operators)
        self._packed_step = _build_packed_step(self._chain, in_schema)
        # device-resident emitted-row counter: kernel K2 adds to it in
        # place (zero host syncs); read once via stats()
        self._emitted_dev = torch.zeros((), dtype=torch.int64,
                                        device=app.device)
        self._lock = threading.Lock()

    @property
    def program(self):
        """The query step's kernel K2 program."""
        return self._chain.program

    def _table_locks(self):
        stack = contextlib.ExitStack()
        for t in self.table_deps:   # sorted: one lock order app-wide
            stack.enter_context(self.app.tables[t].lock)
        return stack

    @contextlib.contextmanager
    def _table_states(self):
        """The dependent tables' states (a dict the step updates), under
        their locks; written back to the tables on exit."""
        with self._table_locks():
            tstates = {t: self.app.tables[t].state for t in self.table_deps}
            yield tstates
            for t in self.table_deps:
                self.app.tables[t].state = tstates[t]

    def process_packed(self, chunk: PackedChunk) -> None:
        self._last_now = max(self._last_now, chunk.last_ts)
        with self._lock, self._table_states() as tstates:
            self.states, out = self._packed_step(
                self.states, self._emitted_dev, chunk, tstates)
        if self._host_due_all and chunk.ts_min is not None:
            self._dispatch_output(out, chunk.last_ts)
            self._schedule(min(op.host_due_bound(chunk.ts_min)
                               for op in self._timer_ops))
            return
        self._dispatch_output(out, chunk.last_ts, due=self._due())

    def _due(self):
        """The earliest window due after a step, as an int64 0-d tensor
        on the device (read back by _dispatch_output or later), or None
        when no window has timers."""
        if not self._has_timers:
            return None
        with self._lock:
            dues = [op.next_due(st) for op, st in
                    zip(self.operators, self.states) if op in self._timer_ops]
        due = dues[0]
        for d in dues[1:]:
            due = torch.minimum(due, d)
        return due

    def stats(self) -> dict:
        """Runtime counters (device-synced on read)."""
        with self._lock:  # vs restore_state rebinding the counter
            emitted = int(self._emitted_dev.item())
        return {"emitted": emitted, "overflow": self.overflow_total()}

    # -- snapshot ---------------------------------------------------------
    def snapshot_state(self) -> dict:
        with self._lock:
            snap = {"states": _tree_to(self.states, "cpu"),
                    "emitted": self._emitted_dev.cpu()}
            if self.rate_limiter is not None:
                snap["rate"] = self.rate_limiter.snapshot_state()
            return snap

    def restore_state(self, snap: dict) -> None:
        """Restore from ``snapshot_state()`` output (or from a reference
        snapshot carried over by carry.state_from_jax)."""
        with self._lock:
            self.states = _tree_to(snap["states"], self.app.device)
            self._sched_due = None
            self._emitted_dev = torch.as_tensor(
                snap["emitted"], dtype=torch.int64).to(
                    self.app.device).clone()
            if self.rate_limiter is not None and "rate" in snap:
                self.rate_limiter.restore_state(snap["rate"])

    def overflow_total(self) -> int:
        """Sum of overflow counters across operator states (windows and
        group tables: the 'counted, never silent' contract)."""
        total = 0

        def walk(st):
            nonlocal total
            if isinstance(st, dict):
                for k, v in st.items():
                    if k == "overflow":
                        total += int(v)
                    else:
                        walk(v)
            elif isinstance(st, (tuple, list)):
                for v in st:
                    walk(v)

        with self._lock:
            walk(self.states)
        return total

    # -- runtime ---------------------------------------------------------
    @staticmethod
    def encode_chunks(schema: StreamSchema, events: list[Event], device,
                      max_cap: Optional[int] = None):
        """Yield (EventBatch, last_timestamp) bucketed device batches of
        at most ``max_cap`` rows."""
        max_cap = max_cap or BATCH_BUCKETS[-1]
        for start in range(0, len(events), max_cap):
            chunk = events[start:start + max_cap]
            rows = [e.data for e in chunk]
            tss = [e.timestamp for e in chunk]
            kinds = [EXPIRED if e.is_expired else CURRENT for e in chunk]
            cap = bucket_capacity(len(chunk))
            yield (batch_from_rows(schema, rows, tss, cap, kinds,
                                   device=device),
                   chunk[-1].timestamp)

    def receive(self, events: list[Event]) -> None:
        for batch, last_ts in self.encode_chunks(self.in_schema, events,
                                                 self.app.device,
                                                 self.max_step_capacity):
            self.process_batch(batch, last_ts)

    def process_batch(self, batch: EventBatch, timestamp: int,
                      now: Optional[int] = None,
                      skip_due: bool = False) -> None:
        cap = self.max_step_capacity
        if cap is not None and batch.capacity > cap:
            # a device batch chained in from another query
            for sub in split_batch(batch, cap):
                self.process_batch(sub, timestamp, now=now,
                                   skip_due=skip_due)
            return
        if now is None:
            now = self.app.current_time()
        self._last_now = max(self._last_now, int(now))
        with self._lock, self._table_states() as tstates:
            self.states, out = self._chain(self.states, self._emitted_dev,
                                           batch, now, tstates)
        self._dispatch_output(out, timestamp,
                              due=None if skip_due else self._due())

    def set_rate_limiter(self, rl) -> None:
        """Install an output rate limiter: every row consumer (insert-into
        handlers, query and stream callbacks) sees only what it emits;
        ``batch_callbacks`` stay a tap before the limiter."""
        rl.emit = self._emit_limited
        rl.start(self.app)
        self.rate_limiter = rl

    def _emit_limited(self, timestamp: int, rows) -> None:
        for h in self.output_handlers:
            h.handle(timestamp, rows)
        self.callback_handler.handle(timestamp, rows)

    def _dispatch_output(self, out, timestamp: int, due=None) -> None:
        """Raw-batch observers, timer scheduling, device-to-device
        chaining, and (only when someone still needs rows) one host
        decode shared by every handler and callback. With a rate limiter
        every row goes through it on the host (the reference's branch;
        its debugger branch is not ported)."""
        for cb in self.batch_callbacks:
            cb(out)
        if self.rate_limiter is not None:
            if due is not None:
                self._schedule(int(due.item()))
            rows = self._host_shape_rows(
                rows_from_batch(self.out_schema.types, out))
            if rows:
                self.rate_limiter.process(timestamp, rows)
            return
        _current: list = []

        def current_once():
            if not _current:
                _current.append(_as_current(out))
            return _current[0]

        row_handlers = [h for h in self.output_handlers
                        if not h.handle_device_batch(
                            out, timestamp, current=current_once)]
        if not (row_handlers or self.callback_handler.callbacks):
            if due is not None:
                # no host rows this step: the due is read at the next
                # clock advance, as the reference resolves it
                self.app.defer_due(self, due)
            return
        if due is not None:
            self._schedule(int(due.item()))
        out_rows = rows_from_batch(self.out_schema.types, out)
        if not out_rows:
            return
        out_rows = self._host_shape_rows(out_rows)
        for h in row_handlers:
            h.handle(timestamp, out_rows)
        self.callback_handler.handle(timestamp, out_rows)

    def _host_shape_rows(self, rows):
        """A STRING order-by (with its offset and limit) on the decoded
        rows: the host edge of the selector's shaping. Python's stable
        ``sorted``, once per key, the last key first; ``batch_callbacks``
        see the batch unordered, as in the reference."""
        shape = getattr(self.operators[-1], "host_shape", None)
        if not shape:
            return rows
        order, offset, limit = shape
        for idx, direction in reversed(order):
            rows = sorted(rows,
                          key=lambda r: (r[2][idx] is None, r[2][idx]),
                          reverse=(direction == "desc"))
        if offset or limit:
            off = offset or 0
            rows = rows[off:off + limit] if limit is not None \
                else rows[off:]
        return rows

    # -- window timers ---------------------------------------------------
    def _schedule(self, due: int) -> None:
        if due >= int(POS_INF):
            return
        if due <= self._last_now and self._skip_past_dues \
                and self.app._columnar:
            # the event step that produced this due already expired every
            # row up to its own clock: a timer there is a no-op dispatch
            # (windows that flush one boundary a step opt out:
            # needs_catchup)
            return
        if self._sched_due is not None and self._sched_due <= due:
            return
        self._sched_due = due
        self.app.scheduler.notify_at(due, self._on_timer)

    def _on_timer(self, due: int) -> None:
        self._sched_due = None
        if not self.app.running:
            return
        # the TIMER row carries the advanced clock, not the scheduled due:
        # one fire drains every pending expiry
        now = max(due, self.app.current_time())
        batch = _timer_batch(self.in_schema, now, self.app.device)
        if self._host_due_all and self.app._playback:
            # host-bounded timers: no due read; re-arm at now + 1, at most
            # one timer step per clock advance
            self.process_batch(batch, due, now=now, skip_due=True)
            self._schedule(now + 1)
        else:
            self.process_batch(batch, due, now=now)
        if self._host_sched:
            self.arm_host_timers(due)

    def arm_host_timers(self, base_ms: int) -> None:
        """Schedule the host-computed fires (cron windows) after
        ``base_ms``."""
        for fn in self._host_sched:
            self._schedule(int(fn(base_ms)))


def split_batch(batch: EventBatch, cap: int):
    """Slice an oversized device batch into <= cap sub-batches (a batch
    chained in from another query to a capacity-capped one)."""
    for off in range(0, batch.capacity, cap):
        sl = slice(off, off + cap)
        yield EventBatch(batch.ts[sl], tuple(c[sl] for c in batch.cols),
                         tuple(n[sl] for n in batch.nulls), batch.kind[sl],
                         batch.valid[sl])


def _tree_to(tree, device):
    """Tensors of a nested tuple/list/dict state moved to ``device``
    (copied, so a snapshot never aliases live state)."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_to(v, device) for v in tree)
    return torch.as_tensor(tree).to(device).clone()


class StreamCallbackReceiver(Receiver):
    def __init__(self, callback: StreamCallback):
        self.callback = callback

    def receive(self, events):
        self.callback.receive(events)


class PatternStreamReceiver(Receiver):
    """Junction subscriber feeding one stream of a pattern query
    (= PatternMultiProcessStreamReceiver, .../state/receiver/*.java:29)."""

    supports_packed = True

    def __init__(self, runtime: "PatternQueryRuntime", stream_id: str):
        self.runtime = runtime
        self.stream_id = stream_id

    @property
    def max_step_capacity(self):
        return self.runtime.max_step_capacity

    def receive(self, events):
        self.runtime.process_stream_events(self.stream_id, events)

    def process_batch(self, batch, last_ts):
        self.runtime.process_pattern_batch(self.stream_id, batch, last_ts)

    def process_packed(self, chunk):
        self.runtime.process_pattern_packed(self.stream_id, chunk)


class PatternQueryRuntime(QueryRuntime):
    """Pattern/sequence query: the NFA engine feeds the selector chain.
    One receiver per distinct input stream; all share the pending-match
    table (reference: StateStreamRuntime + per-state processors).

    The base-class ``states`` tuple holds the selector operator states;
    the NFA pending table lives in ``nfa_state``. A step is the engine's
    stream step (kernel K3 or K4) and then the selector's K2 program over
    the match batch. An engine with absent states also writes its next
    deadline into ``_due`` (8 bytes, read back after the step, as the
    reference reads next_due), and the scheduler fires K4's timer step
    there (AbsentStreamPreStateProcessor's scheduler role)."""

    supports_packed = False  # consumes via PatternStreamReceivers only

    def __init__(self, name: str, engine: NfaEngine,
                 sel_ops: list[Operator], app: "SiddhiAppRuntime"):
        super().__init__(name, sel_ops, engine.match_schema, app)
        self.engine = engine
        self.nfa_state = engine.init_state(app.device)
        self._stream_steps: dict = {}
        self._due = torch.full((), int(POS_INF), dtype=torch.int64,
                               device=app.device) \
            if engine.has_absent else None
        # the armed timer's due (None: none armed), and the clock of the
        # latest event step: dues at or before it were covered in-step
        self._sched_due: Optional[int] = None
        self._last_now = -(2 ** 62)
        # max_step_capacity (QueryRuntime's: SORT_HEAVY_CAP with an
        # aggregating selector, else None, any bucket) is the largest batch
        # one step takes; a smaller cap trades throughput for latency, and
        # the junctions chunk every stream of the pattern to it

    def receive(self, events: list[Event]) -> None:
        raise RuntimeError(
            "pattern runtimes consume via per-stream PatternStreamReceivers")

    def overflow_total(self) -> int:
        """Include the NFA pending-table overflow counter."""
        total = super().overflow_total()
        with self._lock:
            return total + int(self.nfa_state["overflow"].item())

    def snapshot_state(self) -> dict:
        with self._lock:
            return {"states": _tree_to(self.states, "cpu"),
                    "emitted": self._emitted_dev.cpu(),
                    "nfa": _tree_to(self.nfa_state, "cpu")}

    def restore_state(self, snap: dict) -> None:
        super().restore_state(snap)
        with self._lock:
            self.nfa_state = _tree_to(snap["nfa"], self.app.device)
            self._sched_due = None

    def _step(self, stream_id: str, batch: EventBatch, now) -> EventBatch:
        """One step (the caller holds the lock): K3 or K4, then K2."""
        step = self._stream_steps.get(stream_id)
        if step is None:
            step = self._stream_steps[stream_id] = \
                self.engine.make_stream_step(stream_id)
        if self._due is not None:
            self.nfa_state, match = step(self.nfa_state, batch, self._due)
        else:
            self.nfa_state, match = step(self.nfa_state, batch)
        self.states, out = self._chain(self.states, self._emitted_dev,
                                       match, now)
        return out

    # -- absent-pattern timers -------------------------------------------
    def arm_start_deadlines(self, ts: int) -> None:
        """Base start-state absent deadlines at app start time
        (AbsentStreamPreStateProcessor.partitionCreated:291-308)."""
        with self._lock:
            self.nfa_state = self.engine.arm_start(self.nfa_state, ts)
            self._due.copy_(self.engine.next_due(self.nfa_state))
        self._schedule_absent()

    def _schedule_absent(self) -> None:
        """After a step: schedule a wakeup at the earliest live absent
        deadline, which the step left in ``_due`` (one 8-byte read)."""
        if self._due is None:
            return
        self._schedule(int(self._due.item()))

    def _schedule(self, due: int) -> None:
        if due >= int(POS_INF):
            return
        if due <= self._last_now and self.app._columnar:
            # the event step that produced this due already covered its
            # own clock: a timer for an instant the step covered is a
            # no-op dispatch (the reference skips it the same way)
            return
        if self._sched_due is not None and self._sched_due <= due:
            return
        self._sched_due = due
        self.app.scheduler.notify_at(due, self._on_timer)

    def _on_timer(self, due: int) -> None:
        """The scheduler's fire: K4's timer step at ``due``, then K2."""
        self._sched_due = None
        if not self.app.running:
            return
        with self._lock:
            self.nfa_state, match = timer_step(self.engine, self.nfa_state,
                                               due, self._due)
            self.states, out = self._chain(self.states, self._emitted_dev,
                                           match, due)
        self._dispatch_output(out, due)
        self._schedule_absent()

    def process_pattern_packed(self, stream_id: str,
                               chunk: PackedChunk) -> None:
        types = self.app.schemas[stream_id].types
        self._last_now = max(self._last_now, chunk.last_ts)
        with self._lock:
            batch, now = unpack_packed(types, chunk.enc, chunk.capacity,
                                       chunk.buf)
            out = self._step(stream_id, batch, now)
        self._dispatch_output(out, chunk.last_ts)
        self._schedule_absent()

    def process_stream_events(self, stream_id: str, events) -> None:
        schema = self.app.schemas[stream_id]
        for batch, last_ts in self.encode_chunks(
                schema, events, self.app.device, self.max_step_capacity):
            self.process_pattern_batch(stream_id, batch, last_ts)

    def process_pattern_batch(self, stream_id: str, batch: EventBatch,
                              timestamp: int) -> None:
        cap = self.max_step_capacity
        if cap is not None and batch.capacity > cap:
            # a device batch chained in from another query
            for sub in split_batch(batch, cap):
                self.process_pattern_batch(stream_id, sub, timestamp)
            return
        now = self.app.current_time()
        self._last_now = max(self._last_now, int(now))
        with self._lock:
            out = self._step(stream_id, batch, now)
        self._dispatch_output(out, timestamp)
        self._schedule_absent()


class JoinStreamReceiver(Receiver):
    """Junction subscriber feeding one side of a join query."""

    supports_packed = True

    def __init__(self, runtime: "JoinQueryRuntime", side: str):
        self.runtime = runtime
        self.side = side

    @property
    def max_step_capacity(self):
        return self.runtime.max_step_capacity

    def receive(self, events):
        self.runtime.process_side_events(self.side, events)

    def process_batch(self, batch, last_ts):
        self.runtime.process_side_batch(self.side, batch, last_ts)

    def process_packed(self, chunk):
        self.runtime.process_side_packed(self.side, chunk)


def _side_chain(ops):
    """One join side's handlers as a step: (states, batch, now) ->
    (states', window output). Consecutive filters lower into one K2
    filter program; the window runs K5."""
    stages, filters = [], []

    def flush(i):
        if filters:
            b = ProgramBuilder()
            for f in filters:
                f.lower(b)
            stages.append(("filter", i, b.build()))
            filters.clear()
    for i, op in enumerate(ops):
        if isinstance(op, FilterOp):
            filters.append(op)
            continue
        flush(i)
        stages.append(("window", i, None))
    flush(len(ops))

    def step(states, batch, now):
        states = list(states)
        for kind, i, prog in stages:
            if kind == "filter":
                _c, _n, valid = expr_eval(prog, batch, now=now)
                batch = EventBatch(batch.ts, batch.cols, batch.nulls,
                                   batch.kind, valid)
            else:
                states[i], batch = ops[i].step(states[i], batch, now)
        return tuple(states), batch

    return step


class JoinQueryRuntime(QueryRuntime):
    """Two-stream or stream-table join (the reference's
    JoinStreamRuntime with cross-wired JoinProcessors). Each stream side
    runs [filters..., window]; the window output crosses the opposite
    side's findable buffer (kernel K7), a table side's seq-ordered view
    (K8) read under the table's lock; then the selector. The opposite
    side's state is only read by a step."""

    supports_packed = False  # consumes via JoinStreamReceivers only

    def __init__(self, name: str, left_ops, right_ops, crosses, sel_ops,
                 in_schemas, jschema, app, side_tables=None):
        super().__init__(name, sel_ops, jschema, app)
        self.side_ops = {"L": left_ops, "R": right_ops}
        self.crosses = crosses   # {"L": JoinCross | None, "R": ...}
        self.in_schemas = in_schemas
        self.side_tables = side_tables or {}
        self.side_states = {
            s: _tree_to(tuple(op.init_state() for op in ops), app.device)
            for s, ops in self.side_ops.items()}
        self.table_deps = sorted(set(self.table_deps) | {
            t.table_id for t in self.side_tables.values()})
        self._side_chains = {s: _side_chain(ops)
                             for s, ops in self.side_ops.items()}
        # columnar apps coalesce timer fires, so a cross gates pairs on
        # the opposite row being alive: read once per step kind, when it
        # is first built (the reference captures it at trace time)
        self._gates: dict = {}
        self._join_timer_ops = _timer_windows(
            [op for ops in self.side_ops.values() for op in ops])
        self._has_timers = bool(self._join_timer_ops)
        self._join_host_due = _all_host_due(self._join_timer_ops)
        self._overflow_dev = torch.zeros((), dtype=torch.int64,
                                         device=app.device)
        if any(getattr(op, "sort_heavy", False)
               for ops in self.side_ops.values() for op in ops):
            self.max_step_capacity = SORT_HEAVY_CAP

    def receive(self, events):
        raise RuntimeError("join runtimes consume via JoinStreamReceivers")

    @property
    def overflow(self) -> int:
        """Join pairs (and probe candidates) dropped at their caps."""
        with self._lock:
            return int(self._overflow_dev.item())

    def overflow_total(self) -> int:
        """Selector + both sides' window overflow + dropped pairs."""
        total = super().overflow_total()
        with self._lock:
            for states in self.side_states.values():
                for st in states:
                    if isinstance(st, dict) and "overflow" in st:
                        total += int(st["overflow"])
        return total + self.overflow

    def snapshot_state(self) -> dict:
        with self._lock:
            return {"states": _tree_to(self.states, "cpu"),
                    "emitted": self._emitted_dev.cpu(),
                    "sides": _tree_to(self.side_states, "cpu"),
                    "join_overflow": self._overflow_dev.cpu()}

    def restore_state(self, snap: dict) -> None:
        super().restore_state(snap)
        with self._lock:
            self.side_states = _tree_to(snap["sides"], self.app.device)
            self._overflow_dev = torch.as_tensor(
                snap["join_overflow"], dtype=torch.int64).to(
                    self.app.device).clone()

    def _gate(self, key) -> bool:
        g = self._gates.get(key)
        if g is None:
            g = self._gates[key] = self.app._columnar
        return g

    def _side_step(self, side: str, batch: EventBatch, now, tstates,
                   gate: bool):
        """One side's step (the caller holds the locks): its chain, the
        cross, the selector; -> (output, the side's next due or None)."""
        opp = "R" if side == "L" else "L"
        my, trig = self._side_chains[side](self.side_states[side], batch,
                                           now)
        cross = self.crosses[side]
        if cross is not None:
            table = self.side_tables.get(opp)
            if table is not None:
                opp_buf = table.buffer(tstates[table.table_id])
            else:
                opp_buf = self.side_ops[opp][-1].findable_buffer(
                    self.side_states[opp][-1], self.app.device)
            joined, lost = cross.cross(trig, opp_buf, gate_alive=gate)
            self._overflow_dev = self._overflow_dev + lost
        else:
            joined = EventBatch.empty(self.in_schema, BATCH_BUCKETS[0],
                                      device=self.app.device)
        self.side_states[side] = my
        self.states, out = self._chain(self.states, self._emitted_dev,
                                       joined, now, tstates)
        due = None
        if self._has_timers:
            dues = [op.next_due(st) for op, st in
                    zip(self.side_ops[side], my) if isinstance(op, WindowOp)]
            dues = [d for d in dues if d is not None]
            due = dues[0] if dues else torch.full(
                (), int(POS_INF), dtype=torch.int64, device=self.app.device)
            for d in dues[1:]:
                due = torch.minimum(due, d)
        return out, due

    def process_side_packed(self, side: str, chunk: PackedChunk) -> None:
        self._last_now = max(self._last_now, chunk.last_ts)
        types = self.in_schemas[side].types
        with self._lock, self._table_states() as tstates:
            gate = self._gate((side, chunk.enc, chunk.capacity))
            batch, now = unpack_packed(types, chunk.enc, chunk.capacity,
                                       chunk.buf)
            out, due = self._side_step(side, batch, now, tstates, gate)
        if self._join_host_due and chunk.ts_min is not None:
            self._dispatch_output(out, chunk.last_ts)
            self._schedule(min(op.host_due_bound(chunk.ts_min)
                               for op in self._join_timer_ops))
            return
        self._dispatch_output(out, chunk.last_ts, due=due)

    def process_side_events(self, side: str, events) -> None:
        for batch, last_ts in self.encode_chunks(
                self.in_schemas[side], events, self.app.device,
                self.max_step_capacity):
            self.process_side_batch(side, batch, last_ts)

    def process_side_batch(self, side: str, batch: EventBatch,
                           timestamp: int, now: Optional[int] = None,
                           skip_due: bool = False,
                           is_timer: bool = False) -> None:
        cap = self.max_step_capacity
        if cap is not None and batch.capacity > cap:
            for sub in split_batch(batch, cap):
                self.process_side_batch(side, sub, timestamp, now=now,
                                        skip_due=skip_due)
            return
        if not is_timer:
            # only event steps move the due-subsumption clock: a timer
            # fire must not suppress its own follow-up dues
            self._last_now = max(self._last_now, int(timestamp))
        if now is None:
            now = self.app.current_time()
        now_dev = torch.tensor(int(now), dtype=torch.int64,
                               device=self.app.device)
        with self._lock, self._table_states() as tstates:
            out, due = self._side_step(side, batch, now_dev, tstates,
                                       self._gate((side, None)))
        self._dispatch_output(out, timestamp,
                              due=None if skip_due else due)

    def _on_timer(self, due: int) -> None:
        self._sched_due = None
        if not self.app.running:
            return
        now = max(due, self.app.current_time())
        skip = self._join_host_due and self.app._playback
        for side in ("L", "R"):
            # TIMER rows carry the advanced clock: one fire drains every
            # pending expiry of both sides
            batch = _timer_batch(self.in_schemas[side], now, self.app.device)
            self.process_side_batch(side, batch, due, now=now,
                                    skip_due=skip, is_timer=True)
        if skip:
            self._schedule(now + 1)


class TriggerRuntime:
    """``define trigger T at every 5 sec | at '<cron>' | at 'start'``:
    publishes (triggered_time) events into stream T on schedule
    (trigger/{Periodic,Cron,Start}Trigger.java; PeriodicTrigger.java:73).
    Its rows reach the queries as host events, as in the reference."""

    def __init__(self, app, td, junction: StreamJunction):
        self.app = app
        self.td = td
        self.junction = junction
        self.cron = None
        if td.at_cron not in (None, "start"):
            from ..utils.cron import CronSchedule
            self.cron = CronSchedule(td.at_cron)

    def arm(self, base_ms: int) -> None:
        if self.td.at_cron == "start":
            self._fire(base_ms)
            return
        if self.cron is not None:
            due = self.cron.next_fire(base_ms)
        else:
            due = base_ms + self.td.at_every_ms
        self.app.scheduler.notify_at(due, self._on_timer)

    def _on_timer(self, due: int) -> None:
        if not self.app.running:
            return
        self._fire(due)
        self.arm(due)

    def _fire(self, ts: int) -> None:
        self.junction.publish([Event(ts, (ts,))])


class SiddhiAppRuntime:
    """Per-app container: junctions, query runtimes, handlers, lifecycle
    (reference SiddhiAppRuntimeImpl: start/shutdown :440-655)."""

    def __init__(self, app_ast: A.SiddhiApp, manager=None, device="cuda"):
        self.ast = app_ast
        self.manager = manager
        self.device = torch.device(device)
        self.name = app_ast.name or f"app_{id(self):x}"
        self.junctions: dict[str, StreamJunction] = {}
        self.schemas: dict[str, StreamSchema] = {}
        self.input_handlers: dict[str, InputHandler] = {}
        self.queries: dict[str, QueryRuntime] = {}
        self.tables: dict[str, TableRuntime] = {}
        # named windows: the shared window instance of each definition
        self.named_windows: dict[str, QueryRuntime] = {}
        self.aggregations: dict = {}  # id -> AggregationRuntime
        # partition blocks by name ("partition_1", ...); their queries'
        # ports are in ``queries`` too
        self.partitions: dict = {}
        self.triggers: dict[str, TriggerRuntime] = {}
        # @watermark reorder buffers by stream (resilience/ordering.py)
        self._reorder: dict = {}
        # the planner's join kernel picks: {"<query>.<side>": {kernel,
        # reason, cause}}
        self.join_kernels: dict = {}
        self.running = False
        self._playback = False
        self._playback_time: Optional[int] = None
        # cron windows and triggers are armed once: at start, or under
        # playback at the first event time
        self._cron_armed = False
        # set by the first columnar send (InputHandler.send_arrays)
        self._columnar = False
        # window dues of steps whose output no host consumer read: read
        # back and scheduled before the next clock advance
        self._due_pending: list = []
        # app-wide quiesce barrier: ingest holds it; snapshot/restore of
        # the whole app would take it exclusively
        self.barrier = threading.RLock()
        self.scheduler = Scheduler(playback=False, barrier=self.barrier)
        Planner(self).plan()
        self.scheduler.playback = self._playback
        # start-state absent deadlines are based at app start, not the
        # first event (AbsentStreamPreStateProcessor.partitionCreated);
        # under playback the base is the first observed virtual tick
        self._unarmed_patterns = [
            q for q in self.queries.values()
            if getattr(getattr(q, "engine", None), "needs_start_arm",
                       False)]

    # -- time ------------------------------------------------------------
    def current_time(self) -> int:
        if self._playback and self._playback_time is not None:
            return self._playback_time
        return int(time.time() * 1000)

    def defer_due(self, q, due) -> None:
        self._due_pending.append((q, due))

    def _resolve_dues(self) -> None:
        if not self._due_pending:
            return
        pending, self._due_pending = self._due_pending, []
        for q, due in pending:
            q._schedule(int(due.item()))

    def on_ingest(self, stream_id: str, events: list[Event]) -> None:
        if events:
            self.on_ingest_ts(events[-1].timestamp, events[0].timestamp)

    def _arm_patterns(self, base: int) -> None:
        """Arm the start-state absent deadlines once, at ``base``."""
        if self._unarmed_patterns:
            pats, self._unarmed_patterns = self._unarmed_patterns, []
            for q in pats:
                q.arm_start_deadlines(base)

    def _arm_cron_once(self, base: int) -> None:
        """Under playback, arm the cron windows and triggers once, at
        ``base`` (the first event time less 1)."""
        if not self._cron_armed:
            self._cron_armed = True
            self._arm_cron(base)

    def _no_regress(self, last_ts: int) -> int:
        """Under watermarks the clock never goes back: PROCESS-policy
        late events carry old timestamps."""
        if self._reorder and self._playback_time is not None:
            return max(last_ts, self._playback_time)
        return last_ts

    def on_ingest_ts(self, last_ts: int,
                     first_ts: Optional[int] = None) -> None:
        """Advance the playback clock (and due timers) to an ingested
        timestamp — shared by the row and columnar ingest paths."""
        self._resolve_dues()
        if self._playback:
            base = first_ts if first_ts is not None else last_ts
            self._arm_patterns(base)
            self._arm_cron_once(base - 1)
            self._playback_time = self._no_regress(last_ts)
            self.scheduler.advance_to(self._playback_time)

    def on_ingest_span(self, first_ts: int, last_ts: int) -> None:
        """Columnar-chunk variant: fire only timers due STRICTLY BEFORE
        the chunk's span, then advance the clock to its end (the caller
        catches up with advance_to(last_ts) after publishing)."""
        self._resolve_dues()
        if self._playback:
            self._arm_patterns(first_ts)
            self._arm_cron_once(first_ts - 1)
            self.scheduler.advance_to(first_ts - 1)
            self._playback_time = self._no_regress(last_ts)

    def on_event_time(self, target_ms: int) -> None:
        """Watermark-driven clock (resilience/ordering.py): advance the
        virtual clock and due timers monotonically to the global
        watermark, so windows, joins and patterns fire on watermark
        progress instead of raw arrival, and never backwards."""
        self._resolve_dues()
        if not self._playback:
            return
        cur = self._playback_time
        if cur is not None and target_ms <= cur:
            return
        self._arm_patterns(target_ms)
        self._arm_cron_once(target_ms - 1)
        self._playback_time = target_ms
        self.scheduler.advance_to(target_ms)

    def global_watermark(self) -> Optional[int]:
        """The least watermark of the watermarked streams (a stream that
        has seen no event yet does not hold it back); None before any
        has seen traffic."""
        wms = [b.watermark for b in self._reorder.values()
               if b.watermark is not None]
        return min(wms) if wms else None

    def flush_watermarks(self, final: bool = False) -> None:
        """Release the reorder-buffered events up to each stream's
        watermark, or all of them when ``final`` (the shutdown path, which
        also advances the clock to the observed event-time frontier so
        that trailing window boundaries fire where an unbuffered run's
        would)."""
        if not self._reorder:
            return
        with self.barrier:
            for buf in self._reorder.values():
                buf.flush(final=final)
            if final:
                fronts = [b.max_ts for b in self._reorder.values()
                          if b.max_ts is not None]
                if fronts:
                    self.on_event_time(max(fronts))
            else:
                wm = self.global_watermark()
                if wm is not None:
                    self.on_event_time(wm)

    def _arm_cron(self, base_ms: int) -> None:
        # the named windows too: the reference arms only app.queries, so
        # a cron named window never fires there (ROADMAP Queue 3)
        for q in list(self.queries.values()) + \
                list(self.named_windows.values()):
            if getattr(q, "_host_sched", None):
                q.arm_host_timers(base_ms)
        for t in self.triggers.values():
            t.arm(base_ms)

    def junction_for(self, stream_id: str,
                     schema: Optional[StreamSchema] = None) -> StreamJunction:
        j = self.junctions.get(stream_id)
        if j is None:
            if schema is None:
                raise CompileError(f"undefined stream '{stream_id}'")
            j = StreamJunction(stream_id, schema)
            j.app = self
            self.junctions[stream_id] = j
            self.schemas[stream_id] = schema
        elif schema is not None and schema.types != j.schema.types:
            raise CompileError(
                f"output schema {list(schema.types)} does not match existing "
                f"definition of stream '{stream_id}' {list(j.schema.types)} "
                "(reference rejects mismatched insert-into at deploy time)")
        return j

    # -- public API (= SiddhiAppRuntime) ---------------------------------
    def get_input_handler(self, stream_id: str) -> InputHandler:
        h = self.input_handlers.get(stream_id)
        if h is None:
            raise KeyError(f"no input handler for stream '{stream_id}' "
                           f"(defined streams: {list(self.input_handlers)})")
        return h

    def add_callback(self, target, callback) -> None:
        """StreamCallback on a stream id, or QueryCallback on a query name."""
        if isinstance(callback, QueryCallback):
            q = self.queries.get(target)
            if q is None:
                raise KeyError(f"no query named '{target}'")
            q.callback_handler.callbacks.append(callback)
        else:
            j = self.junctions.get(target)
            if j is None:
                raise KeyError(f"no stream '{target}' to subscribe to")
            j.subscribe(StreamCallbackReceiver(callback))

    def statistics(self) -> dict:
        """Per-query counters: {query name: {"emitted", "overflow"}}; with
        reorder buffers, "reorder": {stream: {"watermark", "lag_ms",
        "depth", and the buffer's counters}}, as the reference reports."""
        with self.barrier:
            report = {n: q.stats() for n, q in self.queries.items()}
            if self._reorder:
                report["reorder"] = {
                    sid: {"watermark": b.watermark, "lag_ms": b.lag_ms,
                          "depth": b.depth, **b.counters}
                    for sid, b in self._reorder.items()}
            return report

    def stream_gauges(self) -> dict:
        """The event-time gauges of each watermarked stream under the
        reference's metric names: ``siddhi.<app>.stream.<sid>.watermark``
        (-1 before traffic), ``.watermark.lag_ms``, ``.reorder.depth`` and
        ``.reorder.<counter>``."""
        flat = {}
        with self.barrier:
            for sid, buf in self._reorder.items():
                base = f"siddhi.{self.name}.stream.{sid}"
                wm = buf.watermark
                flat[f"{base}.watermark"] = -1 if wm is None else int(wm)
                flat[f"{base}.watermark.lag_ms"] = buf.lag_ms
                flat[f"{base}.reorder.depth"] = buf.depth
                for k, v in buf.counters.items():
                    flat[f"{base}.reorder.{k}"] = v
        return flat

    def start(self) -> None:
        self.running = True
        self.scheduler.start()
        if not self._playback:
            self._arm_cron(self.current_time())
            self._arm_patterns(self.current_time())

    def shutdown(self) -> None:
        self.running = False   # reject new sends before draining
        if self._reorder:
            # release what the reorder buffers still hold: an accepted
            # event is never lost at shutdown
            try:
                self.flush_watermarks(final=True)
            except Exception:  # noqa: BLE001 — shutdown must finish
                import logging
                logging.getLogger("siddhi_tpu_torch.runtime").exception(
                    "app '%s': reorder-buffer final flush failed",
                    self.name)
        self.scheduler.shutdown()
        self._resolve_dues()

    # -- on-demand queries (OnDemandQueryParser.java:87) ----------------
    def query(self, q):
        """Run an on-demand query (text or AST) against the app's tables:
        -> result rows (select) or the number of rows touched (writes)."""
        from .ondemand import OnDemandExecutor
        with self.barrier:
            return OnDemandExecutor(self).execute(q)


class Planner:
    """AST -> runtime graph (= SiddhiAppParser + QueryParser +
    SingleInputStreamParser + SelectorParser + OutputParser), for the
    parts this slice ports."""

    def __init__(self, app: SiddhiAppRuntime):
        self.app = app
        self.ast = app.ast

    def plan(self) -> None:
        app, ast = self.app, self.ast
        if ast.function_definitions:
            raise not_ported("script functions")
        for ann in ast.annotations:
            name = ann.name.lower()
            if name == "playback":
                if ann.element("idle.time") is not None or \
                        ann.element("increment") is not None:
                    raise not_ported("@app:playback idle.time/increment")
                app._playback = True
            elif name not in ("name", "watermark"):
                raise not_ported(f"@app:{ann.name}")
        # 1. defined streams -> junctions + input handlers
        for sid, sd in ast.stream_definitions.items():
            for ann in sd.annotations:
                if ann.name.lower() == "onerror" and \
                        (ann.element("action") or "LOG").upper() == "LOG":
                    continue  # the junction's default: log and go on
                if ann.name.lower() == "watermark":
                    continue  # plan_watermarks
                raise not_ported(f"@{ann.name} on stream '{sid}'")
            schema = StreamSchema(sid, tuple(
                Attribute(a.name, a.type) for a in sd.attributes))
            j = app.junction_for(sid, schema)
            app.input_handlers[sid] = InputHandler(sid, j, app)
        # 1b. defined tables (@PrimaryKey: upsert in place; @Index:
        # sorted probes for deletes and IN-table filters)
        for tid, td in ast.table_definitions.items():
            schema = StreamSchema(tid, tuple(
                Attribute(a.name, a.type) for a in td.attributes))
            if A.find_annotation(td.annotations, "Store") is not None:
                raise not_ported("@Store tables")
            pk, idxs = [], []
            for name, out in (("PrimaryKey", pk), ("Index", idxs)):
                ann = A.find_annotation(td.annotations, name)
                if ann is not None:
                    for nm in ann.positional or list(ann.elements.values()):
                        out.append(schema.index_of(nm.strip("'\"")))
            cap_a = A.find_annotation(td.annotations, "cap")
            tcap = int(cap_a.element()) if cap_a is not None \
                else self.DEFAULT_TABLE_CAP
            app.tables[tid] = TableRuntime(tid, schema, capacity=tcap,
                                           pk_indices=pk,
                                           index_indices=idxs,
                                           device=app.device)
        # 1c. named windows: one shared window instance a definition
        # (window/Window.java:65); queries consume from its junction,
        # insert-into feeds the instance
        for wid, wd in ast.window_definitions.items():
            schema = StreamSchema(wid, tuple(
                Attribute(a.name, a.type) for a in wd.attributes))
            fo = wd.window
            if fo is None:
                raise CompileError(f"window '{wid}' needs a window type")
            h = A.WindowHandler(namespace=fo.namespace, name=fo.name,
                                parameters=fo.parameters)
            self.window_class(h)   # the kinds not ported yet raise
            op = self.make_window(h, schema, expired_enabled=True)
            wq = QueryRuntime(f"__window__{wid}", [op], schema, app)
            out_j = app.junction_for(wid, schema)
            wq.output_handlers.append(
                WindowPublishHandler(out_j, wd.output_event_type))
            app.named_windows[wid] = wq
        # 1c2. incremental aggregations (AggregationParser.java:93)
        from .aggregation import AggregationRuntime
        for aid, ad in ast.aggregation_definitions.items():
            sid = ad.input.stream_id
            schema = app.schemas.get(sid)
            if schema is None:
                raise CompileError(
                    f"aggregation '{aid}': undefined stream '{sid}'")
            ar = AggregationRuntime(app, ad, schema)
            app.junctions[sid].subscribe(ar)
            app.aggregations[aid] = ar
        # 1d. triggers: scheduled event publishers into stream <tid>
        for tid, td in ast.trigger_definitions.items():
            schema = StreamSchema(tid, (
                Attribute("triggered_time", AttrType.LONG),))
            tj = app.junction_for(tid, schema)
            app.triggers[tid] = TriggerRuntime(app, td, tj)
        # 1e. @app:watermark / @watermark reorder buffers
        self.plan_watermarks()
        # 2. queries in order; inferred output streams defined as we go
        qcount = 0
        pcount = 0
        for el in ast.execution_elements:
            if isinstance(el, A.Partition):
                pcount += 1
                qcount = self.plan_partition(el, qcount, pcount)
                continue
            qcount += 1
            self.plan_query(el, default_name=f"query_{qcount}")

    DEFAULT_TABLE_CAP = 8192

    def plan_watermarks(self) -> None:
        """``@app:watermark(...)`` / ``@watermark(...)`` on a definition ->
        a ReorderBuffer a configured stream, on its ingest path. The app
        level without ``stream=`` applies to every defined stream,
        ``stream='S'`` to one; a definition's annotation overrides both.
        Any watermark switches the app to event time (playback): the
        clock advances on watermark progress."""
        from ..resilience.ordering import (ReorderBuffer,
                                           config_from_annotation)
        app, ast = self.app, self.ast
        wm_default = None
        wm_streams: dict = {}
        for ann in ast.annotations:
            if ann.name.lower() != "watermark":
                continue
            try:
                conf = config_from_annotation(ann)
            except ValueError as e:
                raise CompileError(f"@app:watermark: {e}")
            tgt = ann.element("stream")
            if tgt is None:
                wm_default = conf
            else:
                tgt = str(tgt).strip().strip("'\"")
                if tgt not in ast.stream_definitions:
                    raise CompileError(
                        f"@app:watermark targets undefined stream "
                        f"'{tgt}'")
                wm_streams[tgt] = conf
        for sid, sd in ast.stream_definitions.items():
            wa = A.find_annotation(sd.annotations, "watermark")
            if wa is not None:
                try:
                    conf = config_from_annotation(wa)
                except ValueError as e:
                    raise CompileError(f"stream '{sid}': @watermark: {e}")
            else:
                conf = wm_streams.get(sid) or wm_default
            if conf is None:
                continue
            if conf.policy == "STORE":
                raise not_ported("@watermark policy='STORE' (the error "
                                 "store)")
            buf = ReorderBuffer(sid, app.schemas[sid], conf)
            buf.handler = app.input_handlers[sid]
            if conf.policy == "STREAM":
                lt = conf.late_stream
                lsd = ast.stream_definitions.get(lt)
                if lsd is None:
                    raise CompileError(
                        f"stream '{sid}': @watermark late.stream '{lt}' "
                        "is not a defined stream")
                if [a.type for a in lsd.attributes] != \
                        [a.type for a in sd.attributes]:
                    raise CompileError(
                        f"stream '{sid}': @watermark late.stream '{lt}' "
                        "schema does not match the source stream "
                        "(late events re-publish with the original "
                        "attributes)")
                lschema = StreamSchema(lt, tuple(
                    Attribute(a.name, a.type) for a in lsd.attributes))
                buf.late_junction = app.junction_for(lt, lschema)
            app._reorder[sid] = buf
        if app._reorder:
            # watermarks define event time (playback semantics)
            app._playback = True

    def attach_rate_limiter(self, qr, q: A.Query, name: str) -> None:
        """``output <all|first|last> every N events | T`` and ``output
        snapshot every T`` -> a host-side limiter on the row path
        (OutputParser's rate selection, query/output/ratelimit/)."""
        rate = q.output_rate
        if rate is None:
            return
        from .ratelimit import build_rate_limiter
        key_fn = None
        needs_key = (isinstance(rate, (A.EventOutputRate,
                                       A.TimeOutputRate))
                     and rate.type in ("first", "last")) or \
            isinstance(rate, A.SnapshotOutputRate)
        gb = q.selector.group_by or []
        if needs_key and gb:
            idxs = []
            for g in gb:
                col = None
                for i, oa in enumerate(q.selector.attributes):
                    e = oa.expression
                    if isinstance(e, A.Variable) and \
                            e.attribute == g.attribute:
                        col = i
                        break
                if col is None:
                    try:
                        col = qr.out_schema.index_of(g.attribute)
                    except KeyError:
                        raise CompileError(
                            f"query '{name}': group-by rate limiting "
                            f"needs '{g.attribute}' in the projection")
                idxs.append(col)

            def key_fn(row, _idxs=tuple(idxs)):
                return tuple(row[2][i] for i in _idxs)

        qr.set_rate_limiter(build_rate_limiter(rate, key_fn))

    def plan_query(self, q: A.Query, default_name: str) -> None:
        app = self.app
        name = q.name or default_name
        for ann in q.annotations:
            if ann.name.lower() not in ("info", "cap"):
                raise not_ported(f"@{ann.name} on query '{name}'")
        if isinstance(q.input, A.StateInputStream):
            return self.plan_pattern_query(q, name)
        if isinstance(q.input, A.JoinInputStream):
            return self.plan_join_query(q, name)
        if not isinstance(q.input, A.SingleInputStream):
            raise CompileError(
                f"query '{name}': only single-stream, join, and pattern "
                "queries supported in this stage")
        sin = q.input
        if sin.is_fault or sin.is_inner:
            raise not_ported("fault and inner streams")
        schema = app.schemas.get(sin.stream_id)
        if schema is None:
            raise CompileError(f"query '{name}': undefined stream "
                               f"'{sin.stream_id}'")
        scope = SingleStreamScope(schema, aliases=(sin.alias,))

        out = q.output
        if not isinstance(out, (A.InsertIntoStream, A.ReturnStream,
                                A.DeleteStream, A.UpdateStream,
                                A.UpdateOrInsertStream)):
            raise CompileError(f"query '{name}': unsupported output "
                               f"{type(out).__name__}")
        out_type = out.output_event_type
        target = getattr(out, "target", None) or name
        current_on = out_type in ("current", "all")
        expired_on = out_type in ("expired", "all")
        operators = self.build_single_chain(
            q, name, schema, sin, scope, target, current_on, expired_on)
        self.append_table_output(operators, out, name)

        if name in app.queries:
            raise CompileError(f"duplicate query name '{name}'")
        qr = QueryRuntime(name, operators, schema, app)
        app.junctions[sin.stream_id].subscribe(qr)
        app.queries[name] = qr
        self.wire_stream_output(qr, out, out_type)
        self.attach_rate_limiter(qr, q, name)

    def build_single_chain(self, q: A.Query, name: str,
                           schema: StreamSchema, sin: A.SingleInputStream,
                           scope, target: str, current_on: bool,
                           expired_on: bool,
                           allow_tables: bool = True) -> list:
        """Handler chain + selector for a single-stream query, shared by
        plan_query and the partition blocks' planning
        (= SingleInputStreamParser.parseInputStream + SelectorParser)."""
        needs_agg = selector_needs_aggregation(q.selector)
        cap_window, _pairs, _cands = self._cap_annotation(q)
        operators: list[Operator] = []
        window_op: Optional[WindowOp] = None
        for h in sin.handlers:
            if isinstance(h, A.Filter):
                # filters may stand before and after the window, in
                # declaration order (SingleInputStreamParser.java:202-243)
                if expr_mentions_table(h.expression):
                    if not allow_tables:
                        raise CompileError(
                            f"query '{name}': table references inside "
                            "partitions not yet supported")
                    operators.append(TableFilterOp(
                        h.expression, schema, self.app.tables, scope))
                    continue
                cond = compile_expression(h.expression, scope)
                if cond.type is not AttrType.BOOL:
                    raise CompileError(f"query '{name}': filter must be BOOL")
                operators.append(FilterOp(cond, schema))
            elif isinstance(h, A.WindowHandler):
                if window_op is not None:
                    raise CompileError(
                        f"query '{name}': multiple windows on one stream")
                cls = self.window_class(h)
                # sliding windows feed EXPIRED events to an aggregating
                # selector (subtract on expiry); batch windows emit expired
                # rows only when the output asks for them
                expired_enabled = expired_on if cls.is_batch \
                    else (expired_on or needs_agg)
                window_op = self.make_window(h, schema, expired_enabled,
                                             cap_override=cap_window)
                operators.append(window_op)
            else:
                op = make_stream_function(h, schema, scope, {}, name)
                operators.append(op)
                if op.out_schema.types != schema.types:
                    schema = op.out_schema
                    scope = SingleStreamScope(schema, aliases=(sin.alias,))
        batch_mode = window_op is not None and window_op.is_batch
        # a query reading a named window sees its EXPIRED rows
        src_window = None if sin.is_inner else \
            self.app.named_windows.get(sin.stream_id)
        expired_possible = (window_op is not None
                            and window_op.expired_enabled) or \
            src_window is not None
        if needs_agg:
            fifo = window_op.fifo_expiry if window_op is not None else (
                src_window.operators[0].fifo_expiry
                if src_window is not None else True)
            operators.append(AggregateOp(
                q.selector, schema, target, scope, batch_mode=batch_mode,
                expired_possible=expired_possible, current_on=current_on,
                expired_on=expired_on, fifo_expiry=fifo))
        else:
            operators.append(ProjectOp(
                q.selector, schema, target, scope,
                current_on=current_on, expired_on=expired_on))
        return operators

    # -- partitions ------------------------------------------------------
    DEFAULT_PARTITION_SLOTS = 32
    # the windows with a slot axis in kernel K5 (csrc/window_step.cu)
    PARTITION_WINDOWS = (TimeWindowOp, LengthWindowOp, LengthBatchWindowOp,
                         TimeBatchWindowOp)

    def plan_partition(self, part: A.Partition, qcount: int,
                       pcount: int) -> int:
        """``partition with (...) begin ... end`` -> PartitionBlockRuntime
        (reference: PartitionParser.java:46 + PartitionRuntimeImpl.java:75).
        See parallel/partition.py for the slot-axis design."""
        from ..parallel.partition import (BlockQueryPlan, BlockStreamReceiver,
                                          KeySpec, PartitionBlockRuntime)
        app = self.app
        # 1. key specs per partitioned stream (shared instance space)
        key_specs: dict = {}
        label_slots: dict[str, int] = {}
        has_value = False
        for pt in part.partition_types:
            schema = app.schemas.get(pt.stream_id)
            if schema is None:
                raise CompileError(
                    f"partition: undefined stream '{pt.stream_id}'")
            scope = SingleStreamScope(schema)
            if isinstance(pt, A.ValuePartitionType):
                has_value = True
                key_specs[pt.stream_id] = KeySpec(
                    "value", [compile_expression(pt.expression, scope)])
            elif isinstance(pt, A.RangePartitionType):
                conds, slots = [], []
                for expr, label in pt.ranges:
                    ce = compile_expression(expr, scope)
                    if ce.type is not AttrType.BOOL:
                        raise CompileError(
                            "partition range condition must be BOOL")
                    if label not in label_slots:
                        label_slots[label] = len(label_slots)
                    conds.append(ce)
                    slots.append(label_slots[label])
                if len(conds) > _kernels.PART_MAX_LABELS:
                    # K9p's route reads one K2 output a condition
                    raise not_ported(
                        f"more than {_kernels.PART_MAX_LABELS} range "
                        "conditions on one partitioned stream")
                key_specs[pt.stream_id] = KeySpec("range", conds, slots)
            else:
                raise CompileError(
                    f"unknown partition type {type(pt).__name__}")
        # slot capacity: ranges are exactly the label count; value keys get
        # a bounded first-seen table (@slots('N') overrides)
        n_slots = len(label_slots) if (label_slots and not has_value) \
            else max(self.DEFAULT_PARTITION_SLOTS, len(label_slots))
        sa = A.find_annotation(part.annotations, "slots")
        if sa is not None:
            n_slots = int(sa.element())
        if len(label_slots) > n_slots:
            raise CompileError(
                f"partition has {len(label_slots)} range labels but only "
                f"{n_slots} slots; @slots must be >= the label count")

        # 2. queries, in order; inner-stream (#S) schemas register as their
        # producers are planned
        inner_schemas: dict[str, StreamSchema] = {}
        plans: list = []
        block_names: set[str] = set()
        for q in part.queries:
            qcount += 1
            name = q.name or f"query_{qcount}"
            if name in app.queries or name in block_names:
                raise CompileError(f"duplicate query name '{name}'")
            block_names.add(name)
            for ann in q.annotations:
                if ann.name.lower() not in ("info", "cap"):
                    raise not_ported(f"@{ann.name} on query '{name}'")
            if q.output_rate is not None:
                raise not_ported("output rate limiting inside a partition")
            if isinstance(q.input, A.StateInputStream):
                plan = self._plan_partition_pattern(q, name, key_specs)
                if plan.inner_target:
                    prev = inner_schemas.get(plan.target)
                    if prev is not None and \
                            prev.types != plan.out_schema.types:
                        raise CompileError(
                            f"inner stream '{plan.target}' schema "
                            "mismatch between producers")
                    inner_schemas[plan.target] = plan.out_schema
                plans.append(plan)
                continue
            if getattr(q.output, "target", None) in app.named_windows or (
                    isinstance(q.input, A.SingleInputStream) and
                    q.input.stream_id in app.named_windows):
                raise not_ported("named windows inside a partition")
            if not isinstance(q.input, A.SingleInputStream):
                raise CompileError(
                    f"query '{name}': only single-stream and pattern/"
                    "sequence queries are supported inside partitions "
                    "(joins in partitions are a later stage)")
            sin = q.input
            if sin.is_fault:
                raise not_ported("fault and inner streams")
            if sin.is_inner:
                input_id = "#" + sin.stream_id
                schema = inner_schemas.get(input_id)
                if schema is None:
                    raise CompileError(
                        f"query '{name}': inner stream '{input_id}' has no "
                        "producer earlier in this partition")
            else:
                input_id = sin.stream_id
                schema = app.schemas.get(sin.stream_id)
                if schema is None:
                    raise CompileError(f"query '{name}': undefined stream "
                                       f"'{sin.stream_id}'")
                if sin.stream_id not in key_specs:
                    raise CompileError(
                        f"query '{name}': stream '{sin.stream_id}' is not "
                        "partitioned (no 'partition with' clause names it)")
            out = q.output
            if not isinstance(out, (A.InsertIntoStream, A.ReturnStream)):
                raise CompileError(
                    f"query '{name}': table output inside partitions not "
                    "yet supported")
            out_type = out.output_event_type
            inner_target = bool(getattr(out, "is_inner", False))
            raw_target = getattr(out, "target", None) or name
            target = ("#" + raw_target) if inner_target else raw_target
            scope = SingleStreamScope(schema, aliases=(sin.alias,))
            operators = self.build_single_chain(
                q, name, schema, sin, scope, target,
                current_on=out_type in ("current", "all"),
                expired_on=out_type in ("expired", "all"),
                allow_tables=False)
            if any(getattr(op, "host_schedule", None) for op in operators):
                raise CompileError(
                    f"query '{name}': cron windows inside partitions are "
                    "not supported")
            self._check_block_ops(name, operators)
            plan = BlockQueryPlan(name, input_id, schema, operators,
                                  target, inner_target, out_type)
            if inner_target:
                prev = inner_schemas.get(target)
                if prev is not None and prev.types != plan.out_schema.types:
                    raise CompileError(
                        f"inner stream '{target}' schema mismatch between "
                        "producers")
                inner_schemas[target] = plan.out_schema
            plans.append(plan)

        block = PartitionBlockRuntime(app, f"partition_{pcount}", n_slots,
                                      key_specs, plans)
        app.partitions[block.name] = block

        # 3. wiring: subscribe consumed outer streams; wire outer outputs
        consumed = sorted(
            {sid for p in plans
             for sid in getattr(p, "input_ids", {p.input_id})
             if not sid.startswith("#")})
        for sid in consumed:
            app.junctions[sid].subscribe(BlockStreamReceiver(block, sid))
        for q, plan in zip(part.queries, plans):
            port = block.ports[plan.name]
            app.queries[plan.name] = port
            if not plan.inner_target and isinstance(
                    q.output, A.InsertIntoStream):
                tj = app.junction_for(plan.target, plan.out_schema)
                if plan.target not in app.input_handlers:
                    app.input_handlers[plan.target] = InputHandler(
                        plan.target, tj, app)
                port.output_handlers.append(
                    InsertIntoStreamHandler(tj, plan.out_type))
        return qcount

    def _check_block_ops(self, name: str, operators) -> None:
        """The operators a partition block runs with its slot axis: the
        windows of K5's first wave, K6's aggregators without the C, D
        and H lanes, K2's filters and projections. The rest raise."""
        for op in operators:
            if isinstance(op, WindowOp) and \
                    not isinstance(op, self.PARTITION_WINDOWS):
                raise not_ported(f"window '{op.kind_name}' inside a "
                                 "partition")
            if isinstance(op, StreamFunctionOp):
                raise not_ported("stream functions inside a partition")
            if getattr(op, "order_by", None) or \
                    getattr(op, "host_shape", None) or (
                        isinstance(op, ProjectOp) and op.shapes_chunk):
                raise not_ported(f"query '{name}': order by, offset or "
                                 "limit on a projection inside a partition")
            if isinstance(op, AggregateOp) and any(
                    getattr(sp, "stateful", False) for sp in op.agg_specs):
                raise not_ported(
                    f"query '{name}': min/max over expiring content, "
                    "distinctCount or unionSet inside a partition")

    def _plan_partition_pattern(self, q: A.Query, name: str,
                                key_specs: dict):
        """A pattern/sequence query inside a partition: the scan engine
        (kernel K4) runs per key slot (PartitionRuntimeImpl.java:75
        clones state runtimes per key)."""
        from ..parallel.partition import BlockPatternPlan
        app = self.app
        sin = q.input
        out = q.output
        if not isinstance(out, (A.InsertIntoStream, A.ReturnStream)):
            raise CompileError(
                f"query '{name}': table output inside partitions not "
                "yet supported")
        out_type = out.output_event_type
        inner_target = bool(getattr(out, "is_inner", False))
        raw_target = getattr(out, "target", None) or name
        target = ("#" + raw_target) if inner_target else raw_target

        compiler = NfaCompiler(app.schemas, sin.state_type)
        slots, states = compiler.compile(sin.state)
        sel = q.selector
        if sel.attributes:
            sel.attributes = [
                dataclasses.replace(
                    oa, expression=rewrite_oob_refs(
                        rewrite_last_refs(oa.expression, slots), slots))
                for oa in sel.attributes]
        if sel.having is not None:
            sel.having = rewrite_oob_refs(
                rewrite_last_refs(sel.having, slots), slots)
        # per-slot pending tables stay modest: K instances multiply
        engine = NfaEngine(slots, states, sin.state_type, sin.within_ms,
                           capacity=32, out_capacity=64)
        scope = MatchScope(slots, engine.col_index)
        input_ids = {s.stream_id for s in slots}
        for sid in sorted(input_ids):
            if sid not in key_specs:
                raise CompileError(
                    f"query '{name}': pattern stream '{sid}' is not "
                    "partitioned (no 'partition with' clause names it)")
        current_on = out_type in ("current", "all")
        expired_on = out_type in ("expired", "all")
        if selector_needs_aggregation(q.selector):
            sel_ops: list[Operator] = [AggregateOp(
                q.selector, engine.match_schema, target, scope,
                batch_mode=False, expired_possible=False,
                current_on=current_on, expired_on=expired_on)]
        else:
            sel_ops = [ProjectOp(
                q.selector, engine.match_schema, target, scope,
                current_on=current_on, expired_on=expired_on,
                having_in_scope=scope)]
        self._check_block_ops(name, sel_ops)
        in_schema = app.schemas[sorted(input_ids)[0]]
        return BlockPatternPlan(name, engine, sel_ops, input_ids,
                                in_schema, target, inner_target, out_type)

    # -- windows ---------------------------------------------------------
    DEFAULT_TIME_CAP = 4096

    def window_class(self, h: A.WindowHandler):
        name = h.name if h.namespace is None else f"{h.namespace}:{h.name}"
        cls = WINDOW_CLASSES.get(name.lower())
        if cls is None:
            if name.lower() in UNPORTED_WINDOWS:
                raise not_ported(f"window '{name}'")
            raise CompileError(f"window '{name}' not yet supported")
        return cls

    def make_window(self, h: A.WindowHandler, schema: StreamSchema,
                    expired_enabled: bool,
                    cap_override: Optional[int] = None) -> WindowOp:
        name = h.name if h.namespace is None else f"{h.namespace}:{h.name}"
        params = []
        for p in h.parameters:
            if isinstance(p, (A.Constant, A.Variable)):
                params.append(p.value if isinstance(p, A.Constant) else p)
            else:
                raise CompileError(
                    f"window '{name}' parameters must be constants or "
                    "attributes")
        key = name.lower()
        time_cap = cap_override or self.DEFAULT_TIME_CAP
        if AttrType.OBJECT in schema.types and key in (
                "sort", "frequent", "lossyfrequent", "session"):
            # kernels B, E and F move one element a row
            raise not_ported(f"a set column through window '{name}'")

        def const_of(p, role):
            if isinstance(p, A.Variable):
                raise CompileError(
                    f"window '{name}' {role} must be a constant")
            return p

        def attr_idx(p, role):
            if not isinstance(p, A.Variable):
                raise CompileError(
                    f"window '{name}' {role} must be a stream attribute")
            try:
                return schema.index_of(p.attribute)
            except (KeyError, ValueError):
                raise CompileError(
                    f"window '{name}': '{p.attribute}' is not an "
                    "attribute of the input stream")

        def long_attr(p):
            ti = attr_idx(p, "timestamp parameter")
            if schema.attributes[ti].type is not AttrType.LONG:
                raise CompileError(
                    f"window '{name}' timestamp attribute must be LONG")
            return ti
        if key in ("hopping", "hoping"):
            _expect(params, 2, name)
            return HoppingWindowOp(schema, _ms(params[0], name),
                                   _ms(params[1], name), cap=time_cap,
                                   expired_enabled=expired_enabled)
        if key == "externaltimebatch":
            if len(params) not in (2, 3, 4, 5):
                raise CompileError(f"{name} takes 2-5 parameters")
            ti = long_attr(params[0])
            start = start_attr = None
            if len(params) >= 3:
                if isinstance(params[2], A.Variable):
                    start_attr = attr_idx(params[2], "start time")
                else:
                    start = int(const_of(params[2], "start time"))
            timeout = _ms(params[3], name) if len(params) >= 4 else None
            replace = bool(const_of(params[4], "replace flag")) \
                if len(params) == 5 else False
            return ExternalTimeBatchWindowOp(
                schema, ti, _ms(params[1], name), start_time=start,
                cap=time_cap, expired_enabled=expired_enabled,
                start_attr=start_attr, timeout_ms=timeout, replace_ts=replace)
        if key == "externaltime":
            _expect(params, 2, name)
            return ExternalTimeWindowOp(schema, long_attr(params[0]),
                                        _ms(params[1], name), cap=time_cap,
                                        expired_enabled=expired_enabled)
        if key == "timelength":
            _expect(params, 2, name)
            return TimeLengthWindowOp(schema, _ms(params[0], name),
                                      int(const_of(params[1], "length")),
                                      expired_enabled=expired_enabled)
        if key == "delay":
            _expect(params, 1, name)
            return DelayWindowOp(schema, _ms(params[0], name), cap=time_cap,
                                 expired_enabled=expired_enabled)
        if key == "batch":
            if len(params) > 1:
                raise CompileError(f"{name} takes 0-1 parameters")
            length = int(const_of(params[0], "length")) if params else 0
            return BatchWindowOp(schema, length, cap=time_cap,
                                 expired_enabled=expired_enabled)
        if key == "sort":
            if not params:
                raise CompileError(f"{name} needs a length parameter")
            keys = []
            i = 1
            while i < len(params):
                ki = attr_idx(params[i], "sort attribute")
                order = 1
                if i + 1 < len(params) and isinstance(params[i + 1], str):
                    d = params[i + 1].lower()
                    if d not in ("asc", "desc"):
                        raise CompileError(
                            f"{name}: order must be 'asc' or 'desc'")
                    order = 1 if d == "asc" else -1
                    i += 1
                keys.append((ki, order))
                i += 1
            if not keys:
                raise CompileError(f"{name} needs at least one sort "
                                   "attribute")
            return SortWindowOp(schema, int(const_of(params[0], "length")),
                                keys, expired_enabled=expired_enabled)
        if key == "cron":
            _expect(params, 1, name)
            if not isinstance(params[0], str):
                raise CompileError(
                    f"window '{name}' takes a cron expression string")
            from ..utils.cron import CronError
            try:
                return CronWindowOp(schema, params[0], cap=time_cap,
                                    expired_enabled=expired_enabled)
            except CronError as e:
                raise CompileError(f"window '{name}': {e}")
        if key == "session":
            if len(params) not in (1, 2):
                raise CompileError(
                    f"{name} takes 1-2 parameters (allowedLatency is not "
                    "supported)")
            ki = None
            if len(params) == 2:
                ki = attr_idx(params[1], "session key")
                if schema.attributes[ki].type is not AttrType.STRING:
                    raise CompileError(
                        f"window '{name}' session key must be STRING")
            return SessionWindowOp(schema, _ms(params[0], name), ki,
                                   expired_enabled=expired_enabled)
        if key == "frequent":
            if not params:
                raise CompileError(f"{name} needs a count parameter")
            idxs = [attr_idx(p, "key attribute") for p in params[1:]]
            return FrequentWindowOp(schema, int(const_of(params[0], "count")),
                                    idxs, expired_enabled=expired_enabled)
        if key == "lossyfrequent":
            if not params:
                raise CompileError(f"{name} needs a support parameter")
            error = None
            rest = params[1:]
            if rest and not isinstance(rest[0], A.Variable):
                error = float(const_of(rest[0], "error"))
                rest = rest[1:]
            idxs = [attr_idx(p, "key attribute") for p in rest]
            return LossyFrequentWindowOp(
                schema, float(const_of(params[0], "support")), error, idxs,
                expired_enabled=expired_enabled)
        if key == "time":
            _expect(params, 1, name)
            return TimeWindowOp(schema, _ms(params[0], name), cap=time_cap,
                                expired_enabled=expired_enabled)
        if key == "length":
            _expect(params, 1, name)
            return LengthWindowOp(schema, int(const_of(params[0], "length")),
                                  expired_enabled=expired_enabled)
        if key == "lengthbatch":
            if len(params) not in (1, 2):
                raise CompileError(f"{name} takes 1-2 parameters")
            stream_cur = bool(const_of(params[1], "mode")) \
                if len(params) == 2 else False
            return LengthBatchWindowOp(schema,
                                       int(const_of(params[0], "length")),
                                       expired_enabled=expired_enabled,
                                       stream_current=stream_cur)
        assert key == "timebatch", key
        if len(params) not in (1, 2, 3):
            raise CompileError(f"{name} takes 1-3 parameters")
        start = None
        stream_cur = False
        if len(params) >= 2:
            p1 = const_of(params[1], "start time / mode")
            if isinstance(p1, bool):
                stream_cur = p1
                if len(params) == 3:
                    raise CompileError(
                        f"{name}: bool mode must be the last parameter")
            elif isinstance(p1, int):
                start = int(p1)
            else:
                raise CompileError(
                    f"window '{name}' start time must be int/long")
        if len(params) == 3:
            mode = const_of(params[2], "mode")
            if not isinstance(mode, bool):
                raise CompileError(
                    f"window '{name}' stream.current.event mode must be a "
                    "bool constant")
            stream_cur = mode
        return TimeBatchWindowOp(schema, _ms(params[0], name),
                                 start_time=start, cap=time_cap,
                                 expired_enabled=expired_enabled,
                                 stream_current=stream_cur)

    @staticmethod
    def _cap_annotation(q: A.Query):
        """`@cap(window.size='N', join.pairs='M', join.candidates='C')`:
        the rows a time-based window keeps, the joined pairs a step emits
        (the rest are counted), the probe's candidates before its
        residual stage (default 4x join.pairs). The reference's queues
        are unbounded; these buffers are fixed, so capacity is a
        per-query dial. -> (window.size, join.pairs, join.candidates),
        None where not given."""
        ca = A.find_annotation(q.annotations, "cap")
        if ca is None:
            return None, None, None

        def to_int(v, key):
            if v is None:
                return None
            try:
                n = int(v)
            except ValueError:
                raise CompileError(
                    f"@cap({key}='{v}'): expected a positive integer")
            if n <= 0:
                raise CompileError(
                    f"@cap({key}='{v}'): expected a positive integer")
            return n

        return (to_int(ca.element("window.size"), "window.size"),
                to_int(ca.element("join.pairs"), "join.pairs"),
                to_int(ca.element("join.candidates"), "join.candidates"))

    # -- tables ------------------------------------------------------------
    def append_table_output(self, operators: list, out, name: str) -> None:
        """Insert, delete, update or update-or-insert into a table: a
        terminal TableOutputOp (the reference's table output callbacks)."""
        app = self.app
        sel_schema = operators[-1].out_schema
        escope = OutputScope(sel_schema)
        target = getattr(out, "target", None)
        if target in app.tables and \
                getattr(operators[-1], "host_shape", None):
            raise CompileError(
                "order by on a STRING attribute shapes rows at the host "
                "boundary and cannot feed a device table output (tables "
                "insert inside the step)")
        if isinstance(out, A.InsertIntoStream) and out.target in app.tables:
            operators.append(TableOutputOp(
                "insert", app.tables[out.target], None, None, escope,
                sel_schema))
        elif isinstance(out, (A.DeleteStream, A.UpdateStream,
                              A.UpdateOrInsertStream)):
            tr = app.tables.get(out.target)
            if tr is None:
                raise CompileError(
                    f"query '{name}': '{out.target}' is not a defined "
                    "table")
            kind = {"DeleteStream": "delete", "UpdateStream": "update",
                    "UpdateOrInsertStream": "update_or_insert"}[
                type(out).__name__]
            set_clause = getattr(out, "set_clause", None)
            if kind != "delete" and not set_clause:
                # no SET: every table attribute the output has, by name
                # (UpdateTableCallback's default)
                set_clause = [
                    (A.Variable(attribute=att.name),
                     A.Variable(attribute=att.name))
                    for att in tr.schema.attributes
                    if att.name in sel_schema.names]
            operators.append(TableOutputOp(
                kind, tr, out.on, set_clause, escope, sel_schema))

    # -- join queries ------------------------------------------------------
    def plan_join_query(self, q: A.Query, name: str) -> None:
        app = self.app
        jin: A.JoinInputStream = q.input
        out = q.output
        cap_window, cap_pairs, cap_cands = self._cap_annotation(q)
        if isinstance(out, (A.InsertIntoStream, A.ReturnStream)):
            out_type = out.output_event_type
        else:
            raise CompileError(f"query '{name}': table output not yet "
                               "supported")
        target = out.target if isinstance(out, A.InsertIntoStream) else name
        current_on = out_type in ("current", "all")
        expired_on = out_type in ("expired", "all")
        needs_agg = selector_needs_aggregation(q.selector)

        def side_chain(sin: A.SingleInputStream):
            schema = app.schemas.get(sin.stream_id)
            if schema is None:
                raise CompileError(
                    f"query '{name}': undefined stream '{sin.stream_id}'")
            scope = SingleStreamScope(schema, aliases=(sin.alias,))
            ops: list[Operator] = []
            window = None
            for h in sin.handlers:
                if isinstance(h, A.Filter):
                    ops.append(FilterOp(compile_expression(h.expression,
                                                           scope), schema))
                elif isinstance(h, A.WindowHandler):
                    if window is not None:
                        raise CompileError(
                            f"query '{name}': multiple windows on one "
                            "join side")
                    cls = self.window_class(h)
                    expired_enabled = expired_on if cls.is_batch \
                        else True  # joins need expired pairs for aggregates
                    window = self.make_window(h, schema, expired_enabled,
                                              cap_override=cap_window)
                    ops.append(window)
                else:
                    raise CompileError(
                        f"query '{name}': stream function in join not "
                        "supported")
            if window is None:
                # the default window (JoinInputStreamParser.java:416)
                ops.append(EmptyWindowOp(schema, expired_enabled=True))
            return schema, ops

        # a table side contributes its seq-ordered view and never
        # triggers (JoinInputStreamParser's table branch)
        side_tables = {}

        def table_side(sin: A.SingleInputStream, key: str):
            t = app.tables[sin.stream_id]
            if sin.handlers:
                raise CompileError(
                    f"query '{name}': windows/filters on the table side "
                    "of a join are not supported")
            side_tables[key] = t
            return t.schema, []

        l_is_table = jin.left.stream_id in app.tables
        r_is_table = jin.right.stream_id in app.tables
        if l_is_table and r_is_table:
            raise CompileError(
                f"query '{name}': joining two tables needs an on-demand "
                "query, not a stream join")
        if (l_is_table or r_is_table) and jin.unidirectional:
            raise CompileError(
                f"query '{name}': 'unidirectional' with a table side is "
                "redundant (tables never trigger) and would silence the "
                "stream side")
        l_schema, l_ops = table_side(jin.left, "L") if l_is_table \
            else side_chain(jin.left)
        r_schema, r_ops = table_side(jin.right, "R") if r_is_table \
            else side_chain(jin.right)
        side_scope = JoinSideScope(l_schema, jin.left.alias,
                                   r_schema, jin.right.alias)
        if q.selector.select_all:
            dup = set(l_schema.names) & set(r_schema.names)
            if dup:
                raise CompileError(
                    f"query '{name}': select * over a join with "
                    f"duplicate attribute(s) {sorted(dup)} — alias the "
                    "outputs (the reference rejects duplicate output "
                    "attributes)")
        jschema = combined_schema(target, l_schema, r_schema)
        crosses = {"L": None, "R": None}
        join_cap = cap_pairs or 1024

        def win_ms(ops):
            if ops and isinstance(ops[-1], TimeWindowOp):
                return ops[-1].T
            return None

        if jin.unidirectional != "right" and not l_is_table:
            crosses["L"] = JoinCross(True, l_schema, r_schema, jin.on,
                                     side_scope, jin.join_type,
                                     join_cap=join_cap,
                                     opp_window_ms=win_ms(r_ops),
                                     cand_cap=cap_cands)
        if jin.unidirectional != "left" and not r_is_table:
            crosses["R"] = JoinCross(False, l_schema, r_schema, jin.on,
                                     side_scope, jin.join_type,
                                     join_cap=join_cap,
                                     opp_window_ms=win_ms(l_ops),
                                     cand_cap=cap_cands)
        for key, side_name in (("L", "left"), ("R", "right")):
            cross = crosses[key]
            if cross is None:
                continue
            kernel, reason, cause = _pick_join_kernel(cross)
            cross.kernel = kernel
            app.join_kernels[f"{name}.{side_name}"] = {
                "kernel": kernel, "reason": reason, "cause": cause}

        sel_scope = JoinCombinedScope(side_scope, len(l_schema.types))
        if needs_agg:
            sel_ops: list[Operator] = [AggregateOp(
                q.selector, jschema, target, sel_scope,
                batch_mode=False, expired_possible=True,
                current_on=current_on, expired_on=expired_on,
                fifo_expiry=False)]
        else:
            sel_ops = [ProjectOp(q.selector, jschema, target, sel_scope,
                                 current_on=current_on,
                                 expired_on=expired_on)]

        if name in app.queries:
            raise CompileError(f"duplicate query name '{name}'")
        qr = JoinQueryRuntime(name, l_ops, r_ops, crosses, sel_ops,
                              {"L": l_schema, "R": r_schema}, jschema, app,
                              side_tables=side_tables)
        # cron windows on join sides are host-scheduled like a single
        # stream's; their fires reach both sides as TIMER batches
        qr._host_sched.extend(
            op.host_schedule for op in l_ops + r_ops
            if getattr(op, "host_schedule", None))
        if not l_is_table:
            app.junctions[jin.left.stream_id].subscribe(
                JoinStreamReceiver(qr, "L"))
        if not r_is_table:
            app.junctions[jin.right.stream_id].subscribe(
                JoinStreamReceiver(qr, "R"))
        app.queries[name] = qr
        self.wire_stream_output(qr, out, out_type)
        self.attach_rate_limiter(qr, q, name)

    # -- pattern / sequence queries --------------------------------------
    def plan_pattern_query(self, q: A.Query, name: str) -> None:
        app = self.app
        sin: A.StateInputStream = q.input
        out = q.output
        if isinstance(out, (A.InsertIntoStream, A.ReturnStream)):
            out_type = out.output_event_type
        else:
            raise CompileError(f"query '{name}': table output not yet "
                               "supported")
        target = out.target if isinstance(out, A.InsertIntoStream) else name
        current_on = out_type in ("current", "all")
        expired_on = out_type in ("expired", "all")

        compiler = NfaCompiler(app.schemas, sin.state_type)
        slots, states = compiler.compile(sin.state)
        # e[last] / e[last - k] select refs -> ifThenElse chains over the
        # slot's copy columns (nfa.rewrite_last_refs)
        sel = q.selector
        if sel.attributes:
            sel.attributes = [
                dataclasses.replace(
                    oa, expression=rewrite_oob_refs(
                        rewrite_last_refs(oa.expression, slots), slots))
                for oa in sel.attributes]
        if sel.having is not None:
            sel.having = rewrite_oob_refs(
                rewrite_last_refs(sel.having, slots), slots)
        if parallel_supported(slots, states, sin.state_type):
            # the round-parallel engine (kernel K3) with its larger table
            engine = ParallelNfaEngine(slots, states, sin.state_type,
                                       sin.within_ms, capacity=4096,
                                       out_capacity=16384)
        else:
            # the per-event scan (kernel K4): 128 rows, 256 matches a step
            engine = NfaEngine(slots, states, sin.state_type, sin.within_ms)
        scope = MatchScope(slots, engine.col_index)
        if selector_needs_aggregation(q.selector):
            sel_ops: list[Operator] = [AggregateOp(
                q.selector, engine.match_schema, target, scope,
                batch_mode=False, expired_possible=False,
                current_on=current_on, expired_on=expired_on)]
        else:
            sel_ops = [ProjectOp(
                q.selector, engine.match_schema, target, scope,
                current_on=current_on, expired_on=expired_on,
                having_in_scope=scope)]

        if name in app.queries:
            raise CompileError(f"duplicate query name '{name}'")
        qr = PatternQueryRuntime(name, engine, sel_ops, app)
        for sid in sorted({s.stream_id for s in slots}):
            app.junctions[sid].subscribe(PatternStreamReceiver(qr, sid))
        app.queries[name] = qr
        self.wire_stream_output(qr, out, out_type)
        self.attach_rate_limiter(qr, q, name)

    def wire_stream_output(self, qr, out, out_type: str) -> None:
        app = self.app
        if isinstance(out, A.InsertIntoStream) and \
                out.target in app.named_windows:
            qr.output_handlers.append(
                InsertIntoWindowHandler(app.named_windows[out.target]))
            return
        if isinstance(out, A.InsertIntoStream) and \
                out.target not in app.tables:
            tj = app.junction_for(out.target, qr.out_schema)
            if out.target not in app.input_handlers:
                app.input_handlers[out.target] = InputHandler(out.target, tj,
                                                              app)
            qr.output_handlers.append(
                InsertIntoStreamHandler(tj, out_type))


def _expect(params, n, name):
    if len(params) != n:
        raise CompileError(f"window '{name}' takes {n} parameter(s), got "
                           f"{len(params)}")


def _ms(v, name) -> int:
    if not isinstance(v, int):
        raise CompileError(f"window '{name}' duration must be int/time, got "
                           f"{v!r}")
    return int(v)
