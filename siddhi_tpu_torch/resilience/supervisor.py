"""Checkpoint supervision (PyTorch port of
siddhi_tpu/resilience/supervisor.py): periodic persist() on the scheduler, and
recovery that restores the newest restorable revision then replays the
error-store backlog.

The periodic persist rides the app's own Scheduler: in wall-clock mode
it fires on the scheduler thread (under the app barrier, like any timer
callback); in playback mode it fires synchronously as the virtual clock
passes each interval boundary — deterministic, so chaos tests can place
the crash exactly between two checkpoints.
"""
from __future__ import annotations

import logging
from typing import Optional

log = logging.getLogger("siddhi_tpu_torch.resilience")


class CheckpointSupervisor:
    """Supervises one app runtime: schedules persist() every
    ``interval_ms`` and drives restore + error-store replay on restart.

    Usage::

        sup = CheckpointSupervisor(rt, interval_ms=60_000).start()
        ...                               # crash happens
        rt2 = mgr.create_siddhi_app_runtime(ql)
        rt2.start()
        rev, replayed = CheckpointSupervisor(rt2).recover()
    """

    def __init__(self, app, interval_ms: Optional[int] = None,
                 error_store=None):
        self.app = app
        self.interval_ms = interval_ms
        self.error_store = error_store    # None -> the app's own store
        self.last_revision: Optional[str] = None
        self.checkpoints = 0              # successful periodic persists
        self.failures = 0                 # persist attempts that raised
        # wall-clock time of the last successful persist, for the obs
        # registry's siddhi.<app>.checkpoint.age_ms gauge (a stale
        # checkpoint is a recovery-window alarm)
        self.last_checkpoint_wall: Optional[float] = None
        self._stopped = False
        app._checkpoint_supervisor = self

    # -- periodic persist -------------------------------------------------
    def start(self, base_ms: Optional[int] = None
              ) -> "CheckpointSupervisor":
        """Arm the periodic checkpoint. In playback mode pass ``base_ms``
        (the virtual-clock origin) — before the first event the app
        clock still reads wall time, which would arm the timer far past
        any virtual timestamp."""
        if self.interval_ms:
            self._arm(self.app.current_time() if base_ms is None
                      else base_ms)
        return self

    def stop(self) -> None:
        self._stopped = True

    def _arm(self, base_ms: int) -> None:
        self.app.scheduler.notify_at(base_ms + self.interval_ms,
                                     self._fire)

    def _fire(self, due: int) -> None:
        if self._stopped or not self.app.running:
            return
        try:
            self.last_revision = self.app.persist()
            self.checkpoints += 1
            import time
            self.last_checkpoint_wall = time.time()
        except Exception:  # noqa: BLE001 — a failed persist must not
            # kill the scheduler; the next interval tries again
            self.failures += 1
            log.error("app '%s': scheduled persist failed",
                      self.app.name, exc_info=True)
        self._arm(due)

    # -- recovery ---------------------------------------------------------
    def recover(self, replay_errors: bool = True
                ) -> tuple[Optional[str], int]:
        """Restore the newest restorable revision, skipping corrupted
        ones (a truncated/tampered snapshot raises on deserialize and
        the supervisor falls back to the previous revision), then replay
        the error-store backlog through the restored runtime.

        Returns (restored_revision_or_None, events_replayed).
        """
        store = self.app._persistence_store()
        restored = None
        for rev in reversed(store.list_revisions(self.app.name)):
            try:
                self.app.restore_revision(rev)
                restored = rev
                break
            except Exception as exc:  # noqa: BLE001 — corrupt revision
                log.warning("app '%s': revision %s is not restorable "
                            "(%s); falling back to the previous one",
                            self.app.name, rev, exc)
        if restored is not None:
            self.last_revision = restored
        replayed = 0
        if replay_errors:
            from .errorstore import replay
            estore = self.error_store \
                if self.error_store is not None else self.app._error_store()
            replayed = replay(self.app, estore)
        return restored, replayed


class PoolCheckpointSupervisor:
    """Supervises one TenantPool (serving/pool.py): periodic whole-pool
    persists at fair-round boundaries, and crash recovery onto a FRESH
    pool of the same template.

    Pools have no scheduler thread of their own — the pool calls
    ``on_round`` at the end of every pump() round (under the pool lock,
    so the snapshot is consistent at the round boundary: states
    updated, delivery not necessarily run; the per-tenant error-store
    partitions cover the delivery tail, at-least-once). Deterministic
    by construction: chaos tests can place a crash exactly between two
    ``interval_rounds`` checkpoints.

    Usage::

        sup = PoolCheckpointSupervisor(pool, interval_rounds=4)
        ...                                   # crash happens
        pool2 = TenantPool(template, manager=mgr, ...)   # same manager
        rev, replayed = PoolCheckpointSupervisor(pool2).recover()
    """

    def __init__(self, pool, interval_rounds: Optional[int] = None,
                 interval_ms: Optional[int] = None):
        import time
        self.pool = pool
        self.interval_rounds = interval_rounds
        self.interval_ms = interval_ms
        self.last_revision: Optional[str] = None
        self.checkpoints = 0
        self.failures = 0
        self.last_checkpoint_wall: Optional[float] = None
        self._t0 = time.time()
        self._stopped = False
        pool._checkpoint_supervisor = self

    def on_round(self, rounds: int) -> None:
        """Round-boundary hook (called by TenantPool.pump under the
        pool lock — persist() re-enters the RLock safely)."""
        if self._stopped:
            return
        due = bool(self.interval_rounds) and \
            rounds % self.interval_rounds == 0
        if not due and self.interval_ms:
            import time
            last = self.last_checkpoint_wall or self._t0
            due = (time.time() - last) * 1000.0 >= self.interval_ms
        if due:
            self.checkpoint()

    def checkpoint(self) -> Optional[str]:
        try:
            self.last_revision = self.pool.persist()
            self.checkpoints += 1
            import time
            self.last_checkpoint_wall = time.time()
            return self.last_revision
        except Exception:  # noqa: BLE001 — a failed persist must not
            # kill the serving loop; the next interval tries again
            self.failures += 1
            log.error("pool '%s': scheduled persist failed",
                      self.pool.name, exc_info=True)
            return None

    def stop(self) -> None:
        self._stopped = True

    # -- recovery ---------------------------------------------------------
    def recover(self, replay_errors: bool = True
                ) -> tuple[Optional[str], int]:
        """Restore the newest restorable revision onto the pool
        (corrupted revisions are skipped, falling back to the previous
        one — the CheckpointSupervisor contract), then replay every
        tenant's error-store partition in original-timestamp order (the
        replay contract of resilience/errorstore.py, via
        TenantPool.replay_errors).

        Returns (restored_revision_or_None, events_replayed)."""
        store = self.pool.proto._persistence_store()
        restored = None
        for rev in reversed(store.list_revisions(self.pool.name)):
            try:
                self.pool.restore_revision(rev)
                restored = rev
                break
            except Exception as exc:  # noqa: BLE001 — corrupt revision
                log.warning("pool '%s': revision %s is not restorable "
                            "(%s); falling back to the previous one",
                            self.pool.name, rev, exc)
        if restored is not None:
            self.last_revision = restored
        replayed = 0
        if replay_errors:
            replayed = sum(self.pool.replay_errors().values())
            rec = getattr(self.pool, "_recovery", None)
            if rec is not None:
                rec["replayed"] = replayed
        return restored, replayed
