"""Output rate limiters (port of siddhi_tpu/core/ratelimit.py, host side
in both packages): gatekeepers between a query's device output and
its callbacks / insert-into handlers.

Reference mapping (query/output/ratelimit/):
- OutputRateLimiter.java:43 (base, sendToCallBacks :64-108)
- event/{All,First,Last,FirstGroupBy,LastGroupBy}PerEventOutputRateLimiter
- time/{All,First,Last,FirstGroupBy,LastGroupBy}PerTimeOutputRateLimiter
- snapshot/* -> SnapshotRateLimiter (simplified: emits the latest row —
  per group key when the query groups — every interval; the reference's
  windowed/aggregation re-emission variants collapse to this because the
  device selector already materializes per-group current values)

Rate limiting is intentionally HOST-side: its entire purpose is to shrink
the event rate crossing the host boundary, and its state (counters, small
buffers) is tiny. Rows are (ts, kind, values) tuples as produced by
rows_from_batch; only CURRENT/EXPIRED rows count
(AllPerEventOutputRateLimiter.java:57).

Time-based limiters schedule flushes on the app Scheduler, so playback
replay drives them deterministically.
"""
from __future__ import annotations

from typing import Callable, Optional

from .event import CURRENT, EXPIRED

Row = tuple  # (ts, kind, values)


class OutputRateLimiter:
    """Base: process(ts, rows) gates rows; emit() forwards downstream."""

    needs_timers = False

    def __init__(self):
        self.emit: Callable = lambda ts, rows: None

    def process(self, timestamp: int, rows: list[Row]) -> None:
        raise NotImplementedError

    def start(self, app) -> None:
        """Attach to the app (scheduler access for time-based flushes)."""
        self.app = app

    # -- persistence ------------------------------------------------------
    def snapshot_state(self) -> dict:
        return {}

    def restore_state(self, snap: dict) -> None:
        pass


def _countable(rows):
    return [r for r in rows if r[1] in (CURRENT, EXPIRED)]


class PassThroughRateLimiter(OutputRateLimiter):
    def process(self, timestamp, rows):
        self.emit(timestamp, rows)


class AllPerEventRateLimiter(OutputRateLimiter):
    """Buffer every event; flush the batch when N have accumulated
    (event/AllPerEventOutputRateLimiter.java:55-66)."""

    def __init__(self, n: int):
        super().__init__()
        self.n = n
        self.counter = 0
        self.buffer: list[Row] = []

    def process(self, timestamp, rows):
        out = []
        for r in _countable(rows):
            self.buffer.append(r)
            self.counter += 1
            if self.counter == self.n:
                out.extend(self.buffer)
                self.buffer.clear()
                self.counter = 0
        if out:
            self.emit(timestamp, out)

    def snapshot_state(self):
        return {"counter": self.counter, "buffer": list(self.buffer)}

    def restore_state(self, snap):
        self.counter = snap["counter"]
        self.buffer = list(snap["buffer"])


class FirstPerEventRateLimiter(OutputRateLimiter):
    """Emit the 1st of every N events
    (event/FirstPerEventOutputRateLimiter.java:54-63)."""

    def __init__(self, n: int, key_fn: Optional[Callable] = None):
        super().__init__()
        self.n = n
        self.key_fn = key_fn
        self.counters: dict = {None: 0}

    def process(self, timestamp, rows):
        out = []
        for r in _countable(rows):
            k = self.key_fn(r) if self.key_fn else None
            c = self.counters.get(k, 0) + 1
            if c == 1:
                out.append(r)
            if c == self.n:
                c = 0
            self.counters[k] = c
        if out:
            self.emit(timestamp, out)

    def snapshot_state(self):
        return {"counters": dict(self.counters)}

    def restore_state(self, snap):
        self.counters = dict(snap["counters"])


class LastPerEventRateLimiter(OutputRateLimiter):
    """Emit the Nth (last) of every N events
    (event/LastPerEventOutputRateLimiter.java)."""

    def __init__(self, n: int, key_fn: Optional[Callable] = None):
        super().__init__()
        self.n = n
        self.key_fn = key_fn
        self.counters: dict = {}
        self.last: dict = {}

    def process(self, timestamp, rows):
        out = []
        for r in _countable(rows):
            k = self.key_fn(r) if self.key_fn else None
            self.last[k] = r
            c = self.counters.get(k, 0) + 1
            if c == self.n:
                out.append(self.last.pop(k))
                c = 0
            self.counters[k] = c
        if out:
            self.emit(timestamp, out)

    def snapshot_state(self):
        return {"counters": dict(self.counters), "last": dict(self.last)}

    def restore_state(self, snap):
        self.counters = dict(snap["counters"])
        self.last = dict(snap["last"])


class FirstPerTimeRateLimiter(OutputRateLimiter):
    """Emit the first event to arrive in each T window; event-driven, no
    timers (time/FirstPerTimeOutputRateLimiter.java:61-66)."""

    def __init__(self, ms: int, key_fn: Optional[Callable] = None):
        super().__init__()
        self.ms = ms
        self.key_fn = key_fn
        self.output_time: dict = {}

    def process(self, timestamp, rows):
        now = self.app.current_time()
        out = []
        for r in _countable(rows):
            k = self.key_fn(r) if self.key_fn else None
            ot = self.output_time.get(k)
            if ot is None or ot + self.ms <= now:
                self.output_time[k] = now
                out.append(r)
        if out:
            self.emit(timestamp, out)

    def snapshot_state(self):
        return {"output_time": dict(self.output_time)}

    def restore_state(self, snap):
        self.output_time = dict(snap["output_time"])


class _ScheduledRateLimiter(OutputRateLimiter):
    """Shared machinery for limiters that flush on a T-interval timer."""

    needs_timers = True

    def __init__(self, ms: int):
        super().__init__()
        self.ms = ms
        self._due: Optional[int] = None

    def _arm(self) -> None:
        if self._due is not None:
            return
        due = self.app.current_time() + self.ms
        self._due = due
        self.app.scheduler.notify_at(due, self._on_timer)

    def _on_timer(self, due: int) -> None:
        self._due = None
        if not self.app.running:
            return
        self.flush(due)

    def flush(self, due: int) -> None:
        raise NotImplementedError


class AllPerTimeRateLimiter(_ScheduledRateLimiter):
    """Buffer everything; flush every T
    (time/AllPerTimeOutputRateLimiter.java)."""

    def __init__(self, ms: int):
        super().__init__(ms)
        self.buffer: list[Row] = []

    def process(self, timestamp, rows):
        got = _countable(rows)
        if got:
            self.buffer.extend(got)
            self._arm()

    def flush(self, due):
        if self.buffer:
            out, self.buffer = self.buffer, []
            self.emit(due, out)

    def snapshot_state(self):
        return {"buffer": list(self.buffer)}

    def restore_state(self, snap):
        self.buffer = list(snap["buffer"])


class LastPerTimeRateLimiter(_ScheduledRateLimiter):
    """Keep the last event (per group key when grouped); emit at each
    interval end (time/LastPerTimeOutputRateLimiter.java)."""

    def __init__(self, ms: int, key_fn: Optional[Callable] = None):
        super().__init__(ms)
        self.key_fn = key_fn
        self.last: dict = {}

    def process(self, timestamp, rows):
        got = _countable(rows)
        if got:
            for r in got:
                self.last[self.key_fn(r) if self.key_fn else None] = r
            self._arm()

    def flush(self, due):
        if self.last:
            out = list(self.last.values())
            self.last.clear()
            self.emit(due, out)

    def snapshot_state(self):
        return {"last": dict(self.last)}

    def restore_state(self, snap):
        self.last = dict(snap["last"])


class SnapshotRateLimiter(_ScheduledRateLimiter):
    """`output snapshot every T`: re-emit the latest value (per group when
    grouped) as CURRENT at each interval (snapshot/*; simplified — see
    module docstring). Unlike last-per-time the snapshot is retained
    across intervals."""

    def __init__(self, ms: int, key_fn: Optional[Callable] = None):
        super().__init__(ms)
        self.key_fn = key_fn
        self.snap: dict = {}

    def process(self, timestamp, rows):
        got = [r for r in rows if r[1] == CURRENT]
        if got:
            for r in got:
                self.snap[self.key_fn(r) if self.key_fn else None] = r
            self._arm()

    def flush(self, due):
        if self.snap:
            out = [(due, CURRENT, r[2]) for r in self.snap.values()]
            self.emit(due, out)
            self._arm()

    def snapshot_state(self):
        return {"snap": dict(self.snap)}

    def restore_state(self, snap):
        self.snap = dict(snap["snap"])


def build_rate_limiter(rate, group_key_fn: Optional[Callable]):
    """AST OutputRate -> limiter (reference: OutputParser rate selection).
    group_key_fn extracts the query's group-by key from an output row (for
    the GroupBy limiter variants); None when the query has no group-by."""
    from ..lang import ast as A
    if rate is None:
        return None
    if isinstance(rate, A.EventOutputRate):
        if rate.type == "all":
            return AllPerEventRateLimiter(rate.events)
        if rate.type == "first":
            return FirstPerEventRateLimiter(rate.events, group_key_fn)
        if rate.type == "last":
            return LastPerEventRateLimiter(rate.events, group_key_fn)
    if isinstance(rate, A.TimeOutputRate):
        if rate.type == "all":
            return AllPerTimeRateLimiter(rate.ms)
        if rate.type == "first":
            return FirstPerTimeRateLimiter(rate.ms, group_key_fn)
        if rate.type == "last":
            return LastPerTimeRateLimiter(rate.ms, group_key_fn)
    if isinstance(rate, A.SnapshotOutputRate):
        return SnapshotRateLimiter(rate.ms, group_key_fn)
    raise ValueError(f"unknown output rate {rate!r}")
