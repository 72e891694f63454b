"""Host-side stream layer (PyTorch port of siddhi_tpu/core/stream.py):
events, junctions, input handlers, callbacks.

Reference mapping:
- Event (io.siddhi.core.event.Event)            -> Event dataclass
- StreamJunction (stream/StreamJunction.java:61) -> StreamJunction (sync pub/sub)
- InputHandler (stream/input/InputHandler.java:28) -> InputHandler
- StreamCallback (stream/output/StreamCallback.java:38) -> StreamCallback
- QueryCallback (query/output/callback/QueryCallback.java:37) -> QueryCallback

The junction is the host edge of the device dataflow: queries subscribe as
receivers; events are handed over as row lists or device batches and each
receiver decides how to batch them onto the device.

A stream with a ``@watermark`` reorder buffer (resilience/ordering.py)
hands its sends to the buffer, which releases them through
``_dispatch_rows``, ``_dispatch_arrays`` or, from the device ring,
``_dispatch_device_batch``.

``@OnError(action='STORE')`` sends the events a receiver failed on to
the app's error store (resilience/errorstore.py). Not ported yet:
``@OnError(action='STREAM')`` (fault streams), ``@Async`` junctions,
the double-buffered ingest pipeline, fan-out fusion and the SLO spans
(the planner raises NotImplementedError for apps that ask for them).
"""
from __future__ import annotations

import dataclasses
import logging
import threading
from typing import Callable, Optional

from ..obs.tracing import maybe_span

log = logging.getLogger("siddhi_tpu_torch.stream")


@dataclasses.dataclass
class Event:
    timestamp: int
    data: tuple
    is_expired: bool = False

    def __repr__(self):
        kind = "EXPIRED" if self.is_expired else "CURRENT"
        return f"Event{{ts={self.timestamp}, data={list(self.data)}, {kind}}}"


class Receiver:
    """A junction subscriber (query input or stream callback)."""

    def receive(self, events: list[Event]) -> None:
        raise NotImplementedError


class StreamJunction:
    """Per-stream pub/sub hub. Synchronous: publish calls every receiver
    inline, preserving the reference's sync-mode semantics
    (StreamJunction.java:166-177)."""

    def __init__(self, stream_id: str, schema):
        self.stream_id = stream_id
        self.schema = schema
        self.receivers: list[Receiver] = []
        self.app = None  # wired by the app runtime (junction_for)
        # @OnError action: LOG (the default) or STORE
        self.on_error_action: str = "LOG"

    def subscribe(self, receiver: Receiver) -> None:
        self.receivers.append(receiver)

    def store_error(self, events: list[Event], exc: Exception,
                    attempts: int = 1) -> bool:
        """Capture failing events in the app's error store for a later
        replay; False when no app is wired (a standalone junction)."""
        if self.app is None or not events:
            return False
        from ..resilience.errorstore import ErroredEvent
        self.app._error_store().store(
            self.app.name,
            ErroredEvent.from_events(
                self.stream_id, events, f"{type(exc).__name__}: {exc}",
                attempts=attempts, now=self.app.current_time()))
        return True

    def _handle_error(self, events: Optional[list[Event]],
                      exc: Exception) -> None:
        """@OnError routing (StreamJunction.handleError:368-430): STORE
        captures the failing events in the error store for a replay;
        LOG (the default) logs and goes on."""
        if self.on_error_action == "STORE" and events and \
                self.store_error(events, exc):
            log.warning(
                "stream '%s': %d event(s) routed to the error store "
                "after %s", self.stream_id, len(events), exc)
            return
        log.error("error processing events on stream '%s' (action=%s)",
                  self.stream_id, self.on_error_action, exc_info=exc)

    def publish(self, events: list[Event]) -> None:
        if not events:
            return
        with maybe_span(self.app, "junction", self.stream_id,
                        events=len(events)):
            for r in list(self.receivers):
                try:
                    r.receive(events)
                except Exception as exc:  # noqa: BLE001 — @OnError
                    self._handle_error(events, exc)

    def publish_batch(self, batch, last_ts: int) -> None:
        """Columnar path: receivers that implement process_batch get the
        device batch directly; row-oriented receivers get decoded events
        (decoded at most once)."""
        decoded = None

        def decode():
            from .event import EXPIRED, rows_from_batch
            return [Event(ts, vals, is_expired=(kind == EXPIRED))
                    for ts, kind, vals in rows_from_batch(
                        self.schema.types, batch)]
        with maybe_span(self.app, "junction", self.stream_id,
                        capacity=int(batch.capacity)):
            for r in list(self.receivers):
                try:
                    if hasattr(r, "process_batch"):
                        r.process_batch(batch, last_ts)
                    else:
                        if decoded is None:
                            decoded = decode()
                        r.receive(decoded)
                except Exception as exc:  # noqa: BLE001 — @OnError
                    if decoded is None:
                        try:
                            decoded = decode()
                        except Exception:  # noqa: BLE001
                            decoded = []
                    self._handle_error(decoded, exc)


class InputHandler:
    """User entry point for one stream (InputHandler.send overloads:
    Object[] / Event / Event[] — stream/input/InputHandler.java:40-75)."""

    def __init__(self, stream_id: str, junction: StreamJunction, app_runtime):
        self.stream_id = stream_id
        self.junction = junction
        self.app = app_runtime
        self._encoder = None  # lazy sticky PackedEncoder (core/ingest.py)
        # serializes columnar sends per stream (the sticky encoder is
        # single-writer); ordering is always _ingest_lock -> app.barrier
        self._ingest_lock = threading.RLock()

    def send(self, data) -> None:
        if not self.app.running:
            raise RuntimeError(
                f"app '{self.app.name}' is not running; call start() first")
        now = self.app.current_time
        if isinstance(data, (list, tuple)) and len(data) == 0:
            return
        if isinstance(data, Event):
            events = [data]
        elif isinstance(data, (list, tuple)) and data and isinstance(
                data[0], Event):
            events = list(data)
        elif (isinstance(data, (list, tuple)) and data
              and isinstance(data[0], (list, tuple))):
            events = [Event(timestamp=now(), data=tuple(d)) for d in data]
        else:
            events = [Event(timestamp=now(), data=tuple(data))]
        buf = self.app._reorder.get(self.stream_id)
        if buf is not None:
            # bounded-lateness reorder buffer: buffered, sorted by the
            # watermark and released through _dispatch_rows; late events
            # go by the stream's policy
            with maybe_span(self.app, "ingest", self.stream_id,
                            events=len(events), buffered=1), \
                    self.app.barrier:
                buf.ingest_rows(events)
            return
        with maybe_span(self.app, "ingest", self.stream_id,
                        events=len(events)), self.app.barrier:
            self._dispatch_rows(events)

    def _dispatch_rows(self, events) -> None:
        """Row publish body (caller holds the app barrier): advance the
        clock, publish, fire timers armed during processing."""
        self.app.on_ingest(self.stream_id, events)
        self.junction.publish(events)
        if self.app._playback and self.app._playback_time is not None:
            self.app.scheduler.advance_to(self.app._playback_time)

    def send_arrays(self, ts, cols) -> None:
        """Columnar ingest: numpy timestamp + data column arrays
        (STRING columns as dictionary codes). When every subscriber
        takes packed chunks, a chunk travels as ONE adaptively-encoded
        uint8 buffer with one host-to-device copy (core/ingest.py);
        otherwise as an EventBatch. Capacities are bucketed
        (core/runtime.py BATCH_BUCKETS)."""
        if not self.app.running:
            raise RuntimeError(
                f"app '{self.app.name}' is not running; call start() first")
        n = len(ts)
        if n == 0:
            return
        self.app._columnar = True
        with self._ingest_lock:
            buf = self.app._reorder.get(self.stream_id)
            if buf is not None:
                # columnar reorder buffer: the chunk lands in numpy
                # segments (or the device ring); releases come back
                # through _dispatch_arrays / _dispatch_device_batch
                with maybe_span(self.app, "ingest", self.stream_id,
                                rows=n, buffered=1), self.app.barrier:
                    buf.ingest_columns(ts, cols)
                return
            self._dispatch_arrays(ts, cols)

    def _dispatch_arrays(self, ts, cols) -> None:
        """Columnar publish body: chunk to bucketed capacities and
        dispatch the chunks one after the other."""
        from .ingest import PackedEncoder
        from .runtime import BATCH_BUCKETS
        n = len(ts)
        packed_ok = all(getattr(r, "supports_packed", False)
                        for r in self.junction.receivers)
        max_cap = BATCH_BUCKETS[-1]
        # a receiver that caps its step capacity gets chunks it can take
        # whole (a pattern query feeds one receiver per stream: each one
        # is a receiver of its stream's junction)
        for r in self.junction.receivers:
            rc = getattr(r, "max_step_capacity", None)
            if rc is not None:
                max_cap = min(max_cap, rc)
        if packed_ok and self._encoder is None:
            self._encoder = PackedEncoder(self.junction.schema)
        for start in range(0, n, max_cap):
            t = ts[start:start + max_cap]
            c = [col[start:start + max_cap] for col in cols]
            self._dispatch_chunk(t, c, packed_ok)

    def _dispatch_chunk(self, t, c, packed_ok: bool) -> None:
        """Dispatch ONE bucketed chunk."""
        from .event import batch_from_columns
        from .ingest import PackedChunk
        from .runtime import bucket_capacity
        last_ts = int(t[-1])
        with maybe_span(self.app, "ingest", self.stream_id,
                        rows=len(t)), self.app.barrier:
            # fire only dues STRICTLY BEFORE the chunk's span; in-span
            # work happens inside the chunk's own step
            self.app.on_ingest_span(int(t[0]), last_ts)
            if packed_ok:
                chunk = PackedChunk.build(
                    self._encoder, t, c, bucket_capacity(len(t)),
                    now=self.app.current_time(), device=self.app.device)
                for r in list(self.junction.receivers):
                    r.process_packed(chunk)
            else:
                batch = batch_from_columns(
                    self.junction.schema, t, c,
                    capacity=bucket_capacity(len(t)),
                    device=self.app.device)
                self.junction.publish_batch(batch, last_ts)
            if self.app._playback:
                self.app.scheduler.advance_to(last_ts)

    def _dispatch_device_batch(self, batch, first_ts: int,
                               last_ts: int) -> None:
        """Publish a batch already on the device (the reorder ring's
        release) under _dispatch_chunk's clock and timer contract: no
        column copy and no K1 decode. The caller holds the app barrier
        (reentrant)."""
        with maybe_span(self.app, "ingest", self.stream_id,
                        rows=int(batch.capacity)), self.app.barrier:
            self.app.on_ingest_span(int(first_ts), int(last_ts))
            self.junction.publish_batch(batch, int(last_ts))
            if self.app._playback:
                self.app.scheduler.advance_to(int(last_ts))


class StreamCallback(Receiver):
    """Subscribe to a stream and receive raw events. Subclass and override
    receive(), or pass fn= to the constructor."""

    def __init__(self, fn: Optional[Callable[[list[Event]], None]] = None):
        self._fn = fn

    def receive(self, events: list[Event]) -> None:
        if self._fn is not None:
            self._fn(events)


class QueryCallback:
    """Per-query callback: receive(timestamp, in_events, removed_events),
    matching QueryCallback.receive(ts, inEvents, removeEvents)."""

    def __init__(self, fn: Optional[Callable] = None):
        self._fn = fn

    def receive(self, timestamp: int, in_events, removed_events) -> None:
        if self._fn is not None:
            self._fn(timestamp, in_events, removed_events)
