"""Host-side scheduler (port of siddhi_tpu/core/scheduler.py): fires
TIMER work when wall-clock (or playback event-time) passes a due
timestamp.

Reference mapping:
- util/Scheduler.java:48,113 — notifyAt(ts) + toNotifyQueue drained by a
  worker; in playback mode driven by TimestampGenerator time-change
  listeners instead of wall clock.
- trigger/PeriodicTrigger.java:73 — periodic callbacks reuse the same
  machinery here.

The engine keeps expiry *evaluation* on device (windows compare buffered
timestamps against the batch `now` column); the scheduler's only job is to
inject a TIMER batch when no real events arrive to advance time. In playback
mode timers fire synchronously from the ingest path (deterministic replay —
the key to bit-equal tests, reference managment/PlaybackTestCase.java).
"""
from __future__ import annotations

import heapq
import itertools
import threading
import time
from typing import Callable, Optional


class Scheduler:
    """One per app runtime. Callbacks receive the due timestamp (ms)."""

    def __init__(self, playback: bool = False, barrier=None):
        self.playback = playback
        # app quiesce barrier: wall-clock callbacks run under it so a
        # concurrent snapshot sees no half-applied timer step
        self._barrier = barrier if barrier is not None \
            else threading.RLock()
        self._heap: list = []  # (due_ms, seq, callback)
        self._seq = itertools.count()
        self._cv = threading.Condition()
        self._thread: Optional[threading.Thread] = None
        self._running = False
        # called each worker tick to pull in async-deferred dues
        self.resolve_hook = None

    # -- lifecycle -------------------------------------------------------
    def start(self) -> None:
        if self.playback or self._thread is not None:
            return
        self._running = True
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="siddhi-scheduler")
        self._thread.start()

    def shutdown(self) -> None:
        with self._cv:
            self._running = False
            self._heap.clear()
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    # -- API -------------------------------------------------------------
    def notify_at(self, due_ms: int, callback: Callable[[int], None]) -> None:
        with self._cv:
            heapq.heappush(self._heap, (int(due_ms), next(self._seq), callback))
            self._cv.notify_all()

    def pending(self) -> int:
        """Armed timers not yet fired (obs: scheduler backlog gauge)."""
        with self._cv:
            return len(self._heap)

    def lag_ms(self, now_ms: int) -> int:
        """How far the earliest armed timer is overdue relative to
        ``now_ms`` (0 when idle or on time) — the obs timer-lag gauge."""
        with self._cv:
            if not self._heap:
                return 0
            return max(0, int(now_ms) - int(self._heap[0][0]))

    def advance_to(self, now_ms: int) -> None:
        """Playback mode: fire every timer due at or before now_ms,
        synchronously, in due order (deterministic replay)."""
        while True:
            with self._cv:
                if not self._heap or self._heap[0][0] > now_ms:
                    return
                due, _, cb = heapq.heappop(self._heap)
            cb(due)

    # -- wall-clock worker ----------------------------------------------
    def _run(self) -> None:
        while True:
            if self.resolve_hook is not None:
                try:
                    self.resolve_hook()
                except Exception:  # noqa: BLE001
                    pass
            with self._cv:
                if not self._running:
                    return
                if not self._heap:
                    self._cv.wait(timeout=0.5)
                    continue
                due = self._heap[0][0]
                now = time.time() * 1000.0
                if due > now:
                    self._cv.wait(timeout=min((due - now) / 1000.0, 0.5))
                    continue
                due, _, cb = heapq.heappop(self._heap)
            try:
                with self._barrier:
                    cb(due)
            except Exception:  # noqa: BLE001 — scheduler thread must survive
                import traceback
                traceback.print_exc()
