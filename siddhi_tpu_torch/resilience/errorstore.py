"""Error store (PyTorch port of siddhi_tpu/resilience/errorstore.py):
capture events that exhausted their on-error handling,
keep them durably, and replay them through the normal junctions.

Records are host-side rows (timestamp, data tuple, expired flag) — an
errored event never reaches the device, so no pytree snapshotting is
involved. Replay re-injects through the origin stream's InputHandler
(advancing the playback clock like any ingest) or, when the origin has
no handler, directly through its junction — either way the delivery
contract is at-least-once: a replayed event that fails again goes back
to the store, and downstream consumers may observe duplicates.
"""
from __future__ import annotations

import dataclasses
import itertools
import logging
import os
import pickle
import threading
import time
from typing import Optional

log = logging.getLogger("siddhi_tpu_torch.resilience")


@dataclasses.dataclass
class ErroredEvent:
    """One failed delivery: the events, where they came from, and why."""

    origin: str                # stream id whose junction/sink failed
    events: list               # [(timestamp, data tuple, is_expired), ...]
    cause: str                 # "ExcType: message"
    attempts: int = 1          # publish/deliver attempts before storing
    stored_at: int = 0         # app clock (ms) when captured

    @classmethod
    def from_events(cls, origin: str, events, cause: str,
                    attempts: int = 1, now: int = 0) -> "ErroredEvent":
        rows = [(e.timestamp, tuple(e.data), e.is_expired) for e in events]
        return cls(origin=origin, events=rows, cause=cause,
                   attempts=attempts, stored_at=now)

    def to_events(self) -> list:
        from ..core.stream import Event
        return [Event(ts, tuple(data), is_expired=exp)
                for ts, data, exp in self.events]


class ErrorStore:
    """SPI: per-app FIFO of ErroredEvent records."""

    def store(self, app_name: str, record: ErroredEvent) -> None:
        raise NotImplementedError

    def peek(self, app_name: str) -> list[ErroredEvent]:
        """Return stored records without removing them."""
        raise NotImplementedError

    def drain(self, app_name: str) -> list[ErroredEvent]:
        """Remove and return stored records (oldest first)."""
        raise NotImplementedError

    def size(self, app_name: str) -> int:
        return len(self.peek(app_name))

    def clear(self, app_name: str) -> None:
        self.drain(app_name)


class InMemoryErrorStore(ErrorStore):
    """Process-local store; survives app restarts within one process when
    shared through the SiddhiManager (like InMemoryPersistenceStore)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._records: dict[str, list[ErroredEvent]] = {}

    def store(self, app_name, record):
        with self._lock:
            self._records.setdefault(app_name, []).append(record)

    def peek(self, app_name):
        with self._lock:
            return list(self._records.get(app_name, ()))

    def drain(self, app_name):
        with self._lock:
            return self._records.pop(app_name, [])


class FileSystemErrorStore(ErrorStore):
    """One pickle file per record under base_dir/app_name/; written with
    tmp-file + rename so a crash mid-store never leaves a torn record."""

    _seq = itertools.count()

    def __init__(self, base_dir: str):
        self.base_dir = base_dir
        self._lock = threading.Lock()

    def _dir(self, app_name: str) -> str:
        return os.path.join(self.base_dir, app_name)

    def store(self, app_name, record):
        d = self._dir(app_name)
        with self._lock:
            os.makedirs(d, exist_ok=True)
            name = f"{int(time.time() * 1000):015d}_{next(self._seq):06d}"
            tmp = os.path.join(d, f".{name}.tmp")
            with open(tmp, "wb") as f:
                pickle.dump(dataclasses.asdict(record), f,
                            protocol=pickle.HIGHEST_PROTOCOL)
            os.replace(tmp, os.path.join(d, f"{name}.err"))

    def _files(self, app_name: str) -> list[str]:
        d = self._dir(app_name)
        if not os.path.isdir(d):
            return []
        return sorted(os.path.join(d, f) for f in os.listdir(d)
                      if f.endswith(".err"))

    def _read(self, path: str) -> Optional[ErroredEvent]:
        try:
            with open(path, "rb") as f:
                return ErroredEvent(**pickle.load(f))
        except Exception as exc:  # noqa: BLE001 — skip torn records
            log.warning("error-store record %s is unreadable (%s); "
                        "skipping", path, exc)
            return None

    def peek(self, app_name):
        with self._lock:
            recs = [self._read(p) for p in self._files(app_name)]
        return [r for r in recs if r is not None]

    def drain(self, app_name):
        with self._lock:
            paths = self._files(app_name)
            recs = []
            for p in paths:
                r = self._read(p)
                os.remove(p)
                if r is not None:
                    recs.append(r)
        return recs


def replay(app, store: ErrorStore) -> int:
    """Re-inject an app's error-store backlog through its junctions.

    Events re-inject in ORIGINAL-TIMESTAMP order (stable: store order
    breaks ties), not store order — failures are captured as they
    happen, so the store interleaves streams and retries out of event-
    time order, and a replay that followed store order would itself
    re-introduce the disorder recovery is supposed to repair (windows
    and patterns would fold the backlog in the wrong sequence).
    Consecutive same-origin runs re-inject as one batch.

    At-least-once: records whose origin stream no longer exists stay in
    the store; events that fail again during replay are re-captured by
    the same on-error path that stored them the first time. Returns the
    number of events re-injected.
    """
    records = store.drain(app.name)
    entries = []  # (ts, capture order, origin, Event)
    seq = 0
    for rec in records:
        if app.junctions.get(rec.origin) is None:
            store.store(app.name, rec)    # unroutable — keep for later
            log.warning("app '%s': error-store record for unknown stream "
                        "'%s' kept in store", app.name, rec.origin)
            continue
        for e in rec.to_events():
            entries.append((e.timestamp, seq, rec.origin, e))
            seq += 1
    entries.sort(key=lambda t: (t[0], t[1]))

    def inject(origin: str, events: list) -> None:
        handler = app.input_handlers.get(origin)
        if handler is not None and app.running:
            handler.send(events)
        else:
            with app.barrier:
                app.on_ingest(origin, events)
                app.junctions[origin].publish(events)

    replayed = 0
    batch_origin, batch = None, []
    for _, _, origin, e in entries:
        if origin != batch_origin and batch:
            inject(batch_origin, batch)
            batch = []
        batch_origin = origin
        batch.append(e)
        replayed += 1
    if batch:
        inject(batch_origin, batch)
    if replayed:
        log.info("app '%s': replayed %d event(s) from the error store "
                 "in original-timestamp order", app.name, replayed)
    return replayed
