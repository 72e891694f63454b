"""Event-time robustness (port of siddhi_tpu/resilience/ordering.py):
per-stream watermarks and bounded-lateness reorder buffers on the ingest
path.

- ``ReorderBuffer``: a host-side buffer between ``InputHandler.send`` /
  ``send_arrays`` and the junction publish, as in the reference. The
  columnar lane keeps numpy segments and releases, stable-sorted by
  timestamp (the reference's ``sorted_key_view`` contract on numpy: a
  lexsort with an arrival-position tiebreak, pads last), the prefix at or
  below the watermark; a run of in-order chunks releases a prefix slice
  with no sort (the sorted-run fast path). The row lane keeps host Events.
- The watermark of a stream is its greatest event time less the
  lateness bound; releases follow it, and so does the app's clock
  (``SiddhiAppRuntime.on_event_time``). Late events (below the watermark
  at arrival) go by ``policy``: DROP, PROCESS, STREAM or STORE (the
  app's error store, resilience/errorstore.py, for a later replay).
- Capacity: over ``cap`` pending rows the oldest are released ahead of
  the watermark and counted (``forced``); ``dedup='true'`` drops exact
  duplicate rows in a release (``duplicates``).
- The device ring (``DeviceReorderRing``, kernel K10): where the
  reference's ``ring_eligible`` holds and a columnar chunk breaks the
  sorted run, the pending rows move to the device and each C-row slice
  of a chunk runs one ring step (``ring_step``): sort ring plus slice by
  (dead last, timestamp, arrival), release the prefix at or below the
  watermark (at least ``min_rel`` rows, all when ``final``) as a device
  batch, and compact the kept rows back in arrival order. The reference
  takes its ring only under ``SIDDHI_TPU_REORDER_RING=1``; the port
  reads no environment variable and takes it wherever it is eligible.
  Both lanes release the same rows. ``ring_step`` runs its plain PyTorch
  version ``ring_step_ref`` for CPU tensors and csrc/reorder_ring.cu for
  CUDA tensors.

Configuration::

    @app:watermark(lateness='200 ms')                  -- every stream
    @app:watermark(stream='S', lateness='50 ms')       -- one stream
    @watermark(lateness='100 ms', policy='DROP', cap='16384',
               dedup='true')                           -- on a definition
    define stream S (sym string, v int);
"""
from __future__ import annotations

import dataclasses
import logging
import re
from typing import Optional, Sequence

import numpy as np
import torch

from .. import _kernels

log = logging.getLogger("siddhi_tpu_torch.resilience")

INT64_MAX = np.iinfo(np.int64).max

RING_MAX_CAPACITY = 65536

LATE_POLICIES = ("DROP", "PROCESS", "STREAM", "STORE")

DEFAULT_REORDER_CAP = 65536

_TIME_RE = re.compile(
    r"(\d+)\s*(millisecond|milliseconds|ms|sec|second|seconds|s|"
    r"min|minute|minutes|hour|hours|h)?")
_UNIT_MS = {"millisecond": 1, "milliseconds": 1, "ms": 1,
            "sec": 1000, "second": 1000, "seconds": 1000, "s": 1000,
            "min": 60_000, "minute": 60_000, "minutes": 60_000,
            "hour": 3_600_000, "hours": 3_600_000, "h": 3_600_000}


def parse_lateness_ms(value) -> int:
    """'200 ms' / '2 sec' / bare ms int -> milliseconds; raises
    ValueError on negative or unparseable lateness."""
    s = str(value).strip().strip("'\"").strip()
    if s.startswith("-"):
        raise ValueError(f"lateness must be >= 0, got '{s}'")
    m = _TIME_RE.fullmatch(s)
    if not m:
        raise ValueError(
            f"cannot parse lateness '{s}' (expected e.g. '200 ms', "
            "'2 sec')")
    return int(m.group(1)) * _UNIT_MS[m.group(2) or "ms"]


@dataclasses.dataclass
class WatermarkConfig:
    """One stream's event-time contract (from ``@watermark`` /
    ``@app:watermark`` annotations)."""

    lateness_ms: int
    policy: str = "DROP"
    cap: int = DEFAULT_REORDER_CAP
    dedup: bool = False
    late_stream: Optional[str] = None  # STREAM policy side-output target


def config_from_annotation(ann) -> WatermarkConfig:
    """Shared parser for ``@watermark``/``@app:watermark`` annotations —
    the plan rule (`watermark-config`) and the runtime planner both call
    this, so parse-time validation and runtime behavior cannot drift.
    Raises ValueError with a user-facing message on any bad element."""
    def _el(key):
        v = ann.element(key)
        return None if v is None else str(v).strip().strip("'\"")

    lateness = _el("lateness")
    if lateness is None and ann.positional:
        lateness = str(ann.positional[0]).strip().strip("'\"")
    if lateness is None:
        raise ValueError(
            "@watermark needs a lateness bound, e.g. "
            "@watermark(lateness='200 ms')")
    lateness_ms = parse_lateness_ms(lateness)
    policy = (_el("policy") or "DROP").upper()
    if policy not in LATE_POLICIES:
        raise ValueError(
            f"unknown @watermark policy '{policy}' (expected one of "
            f"{', '.join(LATE_POLICIES)})")
    cap_s = _el("cap")
    cap = DEFAULT_REORDER_CAP
    if cap_s is not None:
        try:
            cap = int(cap_s)
        except ValueError:
            cap = 0
        if cap <= 0:
            raise ValueError(
                f"@watermark cap='{cap_s}' must be a positive integer")
    dedup_s = _el("dedup")
    dedup = False
    if dedup_s is not None:
        if dedup_s.lower() not in ("true", "false"):
            raise ValueError(
                f"@watermark dedup='{dedup_s}' must be true or false")
        dedup = dedup_s.lower() == "true"
    late_stream = _el("late.stream")
    if late_stream is not None and policy != "STREAM":
        raise ValueError(
            "@watermark late.stream only applies with policy='STREAM'")
    if policy == "STREAM" and late_stream is None:
        raise ValueError(
            "@watermark policy='STREAM' needs late.stream='<defined "
            "stream with the same schema>'")
    return WatermarkConfig(lateness_ms=lateness_ms, policy=policy,
                           cap=cap, dedup=dedup, late_stream=late_stream)


def sorted_key_view_np(keys: np.ndarray, live: np.ndarray):
    """The reference's ops/table.py ``sorted_key_view`` on numpy: live
    rows first (ascending key, position order within equal keys), dead
    rows last. -> (order, sorted keys, n_live)."""
    T = keys.shape[0]
    if np.issubdtype(keys.dtype, np.floating):
        big = np.asarray(np.inf, keys.dtype)
    else:
        big = np.asarray(np.iinfo(keys.dtype).max, keys.dtype)
    ks = np.where(live, keys, big)
    order = np.lexsort((np.arange(T, dtype=np.int32), ks,
                        (~live).astype(np.int8)))
    return order, ks[order], np.sum(live.astype(np.int32))


def _dedup_keep_mask(ts: np.ndarray, cols: Sequence[np.ndarray]):
    """Columnar duplicate detection over a release slice already in
    (timestamp, arrival) order: keep the first arrival of every
    identical (timestamp + all columns) row. One lexsort + adjacent
    compares — no per-event host loop."""
    n = ts.shape[0]
    seq = np.arange(n, dtype=np.int64)
    # lexsort: last key is primary. Group identical rows (ts + payload);
    # seq least-significant so the first arrival leads its group.
    order = np.lexsort(tuple([seq] + [np.ascontiguousarray(c)
                                      for c in cols] + [ts]))
    dup_sorted = np.zeros(n, dtype=bool)
    if n > 1:
        same = ts[order][1:] == ts[order][:-1]
        for c in cols:
            cs = c[order]
            same &= cs[1:] == cs[:-1]
        dup_sorted[1:] = same
    keep = np.ones(n, dtype=bool)
    keep[order] = ~dup_sorted
    return keep


class ReorderBuffer:
    """Bounded-lateness reorder buffer for ONE stream. Methods are
    called with the app barrier held (the InputHandler takes it), so a
    concurrent snapshot never observes a half-applied flush.

    Two lanes share the watermark/policy machinery:

    - columnar (``ingest_columns``): numpy segments, vectorized flush;
    - row (``ingest_rows``): host Event lists (the row path is
      per-event at ingest already). Mixing lanes on one stream coerces
      pending columnar segments to rows (rare; documented).
    """

    def __init__(self, stream_id: str, schema, conf: WatermarkConfig):
        self.stream_id = stream_id
        self.schema = schema
        self.conf = conf
        self.handler = None        # wired by the planner (InputHandler)
        self.late_junction = None  # wired for policy='STREAM'
        self.max_ts: Optional[int] = None  # event-time frontier
        self._lane: Optional[str] = None   # None | 'cols' | 'rows'
        self._pend_ts: list[np.ndarray] = []
        self._pend_cols: list[list[np.ndarray]] = []
        self._pend_rows: list = []
        self.depth = 0
        # sorted-run tracking: True while the pending columnar segments
        # form ONE globally ascending run (each appended chunk passed
        # the cheap bit-equality sortedness check and started at or
        # after the previous segment's tail) — the flush then releases
        # a pure prefix slice with no lexsort and no gather
        self._sorted_run = True
        # device reorder ring (kernel K10): activated on the first
        # columnar chunk that breaks the sorted run, when the stream is
        # eligible; deactivated when drained
        self._ring: Optional[DeviceReorderRing] = None
        self._ring_wm: Optional[int] = None
        self.counters = {
            "late": 0, "late_dropped": 0, "late_processed": 0,
            "late_streamed": 0, "late_stored": 0,
            "duplicates": 0, "forced": 0, "released": 0,
            "sorted_fast": 0, "ring_steps": 0,
        }

    # -- watermark -------------------------------------------------------
    @property
    def watermark(self) -> Optional[int]:
        """Max observed event time minus the lateness bound (None until
        the first event)."""
        if self.max_ts is None:
            return None
        return self.max_ts - self.conf.lateness_ms

    @property
    def lag_ms(self) -> int:
        """Distance between the stream's event-time frontier and its
        watermark (== the lateness bound once traffic flows)."""
        wm = self.watermark
        return 0 if wm is None else int(self.max_ts - wm)

    # -- ingest ----------------------------------------------------------
    def ingest_columns(self, ts, cols) -> None:
        ts = np.ascontiguousarray(ts, dtype=np.int64)
        cols = [np.ascontiguousarray(c) for c in cols]
        wm = self.watermark
        if wm is not None:
            late = ts < wm
            if late.any():
                keep = ~late
                self._route_late_cols(ts[late], [c[late] for c in cols],
                                      wm)
                ts = ts[keep]
                cols = [c[keep] for c in cols]
        if len(ts):
            mx = int(ts.max())
            self.max_ts = mx if self.max_ts is None else max(self.max_ts,
                                                             mx)
            if self._lane == "rows":
                self._pend_rows.extend(self._decode_rows(ts, cols))
                self.depth += len(ts)
            else:
                n = len(ts)
                chunk_sorted = n < 2 or bool((ts[1:] >= ts[:-1]).all())
                if self._ring is None and not self._pend_ts:
                    self._sorted_run = chunk_sorted
                else:
                    self._sorted_run = bool(
                        self._sorted_run and chunk_sorted
                        and self._ring is None
                        and int(ts[0]) >= int(self._pend_ts[-1][-1]))
                self._lane = "cols"
                self.depth += n
                if self._ring is not None or (
                        not self._sorted_run and self.ring_eligible()):
                    # device ring lane: sort + release on device; the
                    # append itself performs the watermark release, so
                    # the flush below is a no-op unless forced/final
                    self._ring_ingest(ts, cols)
                else:
                    self._pend_ts.append(ts)
                    self._pend_cols.append(cols)
        self._flush_and_advance()

    def ingest_rows(self, events) -> None:
        wm = self.watermark
        if wm is not None:
            late = [e for e in events if e.timestamp < wm]
            if late:
                events = [e for e in events if e.timestamp >= wm]
                self._route_late_rows(late, wm)
        if events:
            mx = max(e.timestamp for e in events)
            self.max_ts = mx if self.max_ts is None else max(
                self.max_ts, mx)
            if self._lane == "cols" and self.depth:
                # lane coercion: decode pending columnar segments so one
                # stable sort covers everything (mixed ingest is rare)
                if self._ring is not None:
                    t_host, c_host = self._ring_host_cols()
                    self._pend_rows = self._decode_rows(t_host, c_host)
                    self._ring = None
                    self._ring_wm = None
                else:
                    self._pend_rows = [
                        e for t, cs in zip(self._pend_ts, self._pend_cols)
                        for e in self._decode_rows(t, cs)]
                self._pend_ts, self._pend_cols = [], []
            self._lane = "rows"
            self._sorted_run = False
            self._pend_rows.extend(events)
            self.depth += len(events)
        self._flush_and_advance()

    # -- flush -----------------------------------------------------------
    def _flush_and_advance(self) -> None:
        forced = max(0, self.depth - self.conf.cap)
        self.flush(min_release=forced)
        app = self.handler.app
        wm = app.global_watermark()
        if wm is not None:
            app.on_event_time(wm)

    def flush(self, min_release: int = 0, final: bool = False) -> int:
        """Release every buffered event at or below the watermark (all
        of them when ``final``), stable-sorted by timestamp with buffer
        order preserved among equal timestamps. ``min_release`` forces
        that many oldest events out ahead of the watermark (capacity
        overflow — counted as ``forced``, never silent). Returns the
        number of events released."""
        if self._ring is not None:
            return self._flush_ring(min_release, final)
        if self.depth == 0:
            return 0
        wm = self.watermark
        if self._lane == "cols":
            if self._sorted_run and not (self._pend_rows):
                return self._flush_cols_sorted(wm, min_release, final)
            return self._flush_cols(wm, min_release, final)
        return self._flush_rows(wm, min_release, final)

    def _cut(self, sorted_ts: np.ndarray, wm, min_release: int,
             final: bool) -> int:
        n = sorted_ts.shape[0]
        if final:
            return n
        cut = 0 if wm is None else int(
            np.searchsorted(sorted_ts, wm, side="right"))
        if min_release > cut:
            self.counters["forced"] += min_release - cut
            log.warning(
                "stream '%s': reorder buffer over capacity (%d); "
                "force-releasing %d event(s) ahead of the watermark",
                self.stream_id, self.conf.cap, min_release - cut)
            cut = min(min_release, n)
        return cut

    def _stable_order(self, ts_all: np.ndarray):
        """Stable timestamp sort with an explicit arrival-position
        tiebreak: the reference's ops/table.py sorted_key_view on the
        numpy namespace (every buffered row is live; the pad-last clamp
        is inert)."""
        order, sorted_ts, _ = sorted_key_view_np(
            ts_all, np.ones(ts_all.shape[0], dtype=bool))
        return order, sorted_ts

    def _flush_cols_sorted(self, wm, min_release: int,
                           final: bool) -> int:
        """Sorted-prefix short-circuit (the common in-order-traffic
        path): the pending segments already form one globally ascending
        run — verified by cheap bit-equality comparisons at ingest — so
        the stable sort is the identity and the watermark release is a
        pure prefix of the segment list. No lexsort, no gather; slice
        views except one concatenate when the release spans segments.
        Bit-equal to _flush_cols by construction (for a sorted run,
        sorted_key_view's order is arange)."""
        total = self.depth
        if final:
            cut = total
        else:
            cut = 0
            if wm is not None:
                for seg in self._pend_ts:
                    if int(seg[0]) > wm:
                        break
                    if int(seg[-1]) <= wm:
                        cut += len(seg)
                    else:
                        cut += int(np.searchsorted(seg, wm,
                                                   side="right"))
                        break
            if min_release > cut:
                self.counters["forced"] += min_release - cut
                log.warning(
                    "stream '%s': reorder buffer over capacity (%d); "
                    "force-releasing %d event(s) ahead of the watermark",
                    self.stream_id, self.conf.cap, min_release - cut)
                cut = min(min_release, total)
        if cut == 0:
            return 0
        rel_t, rel_c, new_t, new_c = [], [], [], []
        k = cut
        for seg, cs in zip(self._pend_ts, self._pend_cols):
            if k <= 0:
                new_t.append(seg)
                new_c.append(cs)
            elif k >= len(seg):
                rel_t.append(seg)
                rel_c.append(cs)
                k -= len(seg)
            else:
                rel_t.append(seg[:k])
                rel_c.append([c[:k] for c in cs])
                new_t.append(seg[k:])
                new_c.append([c[k:] for c in cs])
                k = 0
        if len(rel_t) == 1:
            rel_ts, rel_cols = rel_t[0], list(rel_c[0])
        else:
            rel_ts = np.concatenate(rel_t)
            rel_cols = [np.concatenate([p[j] for p in rel_c])
                        for j in range(len(rel_c[0]))]
        if self.conf.dedup and cut > 1:
            keep = _dedup_keep_mask(rel_ts, rel_cols)
            ndup = int(cut - keep.sum())
            if ndup:
                self.counters["duplicates"] += ndup
                rel_ts = rel_ts[keep]
                rel_cols = [c[keep] for c in rel_cols]
        self._pend_ts, self._pend_cols = new_t, new_c
        if not new_t:
            self._lane = None
            self._sorted_run = True
        self.depth -= cut
        self.counters["released"] += int(rel_ts.shape[0])
        self.counters["sorted_fast"] += 1
        self._emit_cols(rel_ts, rel_cols, wm)
        return cut

    def _flush_cols(self, wm, min_release: int, final: bool) -> int:
        ts_all = self._pend_ts[0] if len(self._pend_ts) == 1 \
            else np.concatenate(self._pend_ts)
        order, sorted_ts = self._stable_order(ts_all)
        cut = self._cut(sorted_ts, wm, min_release, final)
        if cut == 0:
            return 0
        cols_all = [seg[0] if len(self._pend_cols) == 1
                    else np.concatenate(seg)
                    for seg in zip(*self._pend_cols)]  # lint: disable=per-row-encode-hazard (per-COLUMN segment transpose: #cols iterations, not #rows)
        rel_idx = order[:cut]
        rel_ts = ts_all[rel_idx]
        rel_cols = [c[rel_idx] for c in cols_all]
        if self.conf.dedup and cut > 1:
            keep = _dedup_keep_mask(rel_ts, rel_cols)
            ndup = int(cut - keep.sum())
            if ndup:
                self.counters["duplicates"] += ndup
                rel_ts = rel_ts[keep]
                rel_cols = [c[keep] for c in rel_cols]
        rem_idx = np.sort(order[cut:])  # arrival order preserved
        if rem_idx.size:
            self._pend_ts = [ts_all[rem_idx]]
            self._pend_cols = [[c[rem_idx] for c in cols_all]]
        else:
            self._pend_ts, self._pend_cols = [], []
            self._lane = None
            self._sorted_run = True  # drained: restart run tracking
        self.depth -= cut
        self.counters["released"] += int(rel_ts.shape[0])
        self._emit_cols(rel_ts, rel_cols, wm)
        return cut

    def _flush_rows(self, wm, min_release: int, final: bool) -> int:
        rows = self._pend_rows
        ts_all = np.fromiter((e.timestamp for e in rows), np.int64,
                             len(rows))
        order, sorted_ts = self._stable_order(ts_all)
        cut = self._cut(sorted_ts, wm, min_release, final)
        if cut == 0:
            return 0
        rel = [rows[i] for i in order[:cut]]
        if self.conf.dedup and cut > 1:
            seen = set()
            kept = []
            for e in rel:
                key = (e.timestamp, e.data, e.is_expired)
                if key in seen:
                    self.counters["duplicates"] += 1
                else:
                    seen.add(key)
                    kept.append(e)
            rel = kept
        self._pend_rows = [rows[i] for i in np.sort(order[cut:])]
        if not self._pend_rows:
            self._lane = None
            self._sorted_run = True  # drained: restart run tracking
        self.depth -= cut
        self.counters["released"] += len(rel)
        self._emit_rows(rel, wm)
        return cut

    # -- device reorder ring ---------------------------------------------
    def ring_capacity(self) -> int:
        """The ring's capacity: the buffer cap rounded to a batch bucket
        (the reference's static shape of its ring step)."""
        from ..core.runtime import bucket_capacity
        return bucket_capacity(max(8, int(self.conf.cap)))

    def ring_eligible(self) -> bool:
        """Device-ring preconditions (the reference's): packable
        primitive columns, no dedup (a host-only policy), and a cap of at
        most 65,536; and K10's column count."""
        from ..core.types import AttrType
        if self.conf.dedup:
            return False
        ok = (AttrType.INT, AttrType.LONG, AttrType.FLOAT,
              AttrType.DOUBLE, AttrType.BOOL, AttrType.STRING)
        if not all(t in ok for t in self.schema.types):
            return False
        if len(self.schema.types) > _kernels.RING_MAX_COLS:
            return False
        return self.ring_capacity() <= RING_MAX_CAPACITY

    def _ring_ingest(self, ts, cols) -> None:
        """Append a columnar chunk through the device ring: each
        C-sized slice runs one ring step (kernel K10) that sorts (ring +
        slice), releases the watermark prefix as a device EventBatch and
        compacts the retained rows back in arrival order. The caller
        already counted the rows into ``depth``."""
        if self._ring is None:
            self._ring = DeviceReorderRing(self.schema,
                                           self.ring_capacity(),
                                           self.handler.app.device)
            self._ring_wm = None
            # absorb pending host segments first (arrival order)
            pend = list(zip(self._pend_ts, self._pend_cols))
            self._pend_ts, self._pend_cols = [], []
            for t, cs in pend:
                self._ring_append(t, cs)
        self._ring_append(ts, cols)

    def _ring_append(self, ts, cols) -> None:
        ring = self._ring
        from ..core.types import np_dtype
        cols = [c if c.dtype == np_dtype(t) else c.astype(np_dtype(t))
                for t, c in zip(self.schema.types, cols)]
        C = ring.C
        cap = min(int(self.conf.cap), C)
        for s in range(0, len(ts), C):
            t = ts[s:s + C]
            cs = [c[s:s + C] for c in cols]
            over = ring.count + len(t) - cap
            self._ring_step(t, cs, min_release=max(0, over),
                            final=False)

    def _ring_step(self, ts, cols, min_release: int,
                   final: bool) -> int:
        """Run one device ring step; returns rows released. The only
        device-to-host read is the four scalars (cut, wm_cut, first,
        last): watermark arithmetic, forced-overflow accounting and the
        late policy all stay on the host."""
        ring = self._ring
        C = ring.C
        if ring.state is None:
            ring.state = ring.zero_state()
        k = 0 if ts is None else len(ts)
        in_ts = np.zeros((C,), np.int64)
        in_cols = [np.zeros((C,), dt) for dt in ring.np_dtypes]
        if k:
            in_ts[:k] = ts
            for b, c in zip(in_cols, cols):
                b[:k] = c
        wm = self.watermark
        wm_v = -(2 ** 62) if wm is None else int(wm)
        dev = ring.device
        new_state, batch, meta = ring_step(
            ring.state, torch.from_numpy(in_ts).to(dev),
            tuple(torch.from_numpy(c).to(dev) for c in in_cols),
            ring.count, k, wm_v, max(0, min_release), bool(final))
        ring.state = new_state
        self.counters["ring_steps"] += 1
        cut, wm_cut, first, last = meta.tolist()
        self._ring_wm = wm
        if min_release > wm_cut and not final:
            self.counters["forced"] += min_release - wm_cut
            log.warning(
                "stream '%s': reorder buffer over capacity (%d); "
                "force-releasing %d event(s) ahead of the watermark",
                self.stream_id, self.conf.cap, min_release - wm_cut)
        ring.count = ring.count + k - cut
        self.depth -= cut
        if cut:
            self.counters["released"] += cut
            self._emit_ring(batch, first, last, cut, wm)
        return cut

    def _flush_ring(self, min_release: int, final: bool) -> int:
        ring = self._ring
        if ring.count == 0:
            released = 0
        elif final or min_release > 0 or \
                self.watermark != self._ring_wm:
            released = self._ring_step(None, None,
                                       min_release=min_release,
                                       final=final)
        else:
            # the appends already released to the current watermark
            released = 0
        if ring.count == 0 and (final or self.depth == 0):
            # drained: drop back to the host lane (in-order traffic
            # resumes the sorted-prefix fast path)
            self._ring = None
            self._ring_wm = None
            self._lane = None
            self._sorted_run = True
        return released

    def _ring_host_cols(self):
        """Device ring state -> host (ts, cols) in arrival order
        (snapshots and rows-lane coercion)."""
        ring = self._ring
        if ring is None or ring.count == 0 or ring.state is None:
            return (np.zeros((0,), np.int64),
                    [np.zeros((0,), dt) for dt in
                     (ring.np_dtypes if ring else [])])
        sts, scols = ring.state
        k = ring.count
        return (sts[:k].cpu().numpy(),
                [c[:k].cpu().numpy() for c in scols])

    def _emit_ring(self, batch, first_ts: int, last_ts: int, cut: int,
                   wm) -> None:
        from ..obs.tracing import maybe_span
        with maybe_span(self.handler.app, "reorder", self.stream_id,
                        watermark=-1 if wm is None else int(wm),
                        released=cut, depth=self.depth, ring=1):
            self.handler._dispatch_device_batch(batch, first_ts,
                                                last_ts)

    def _emit_cols(self, ts, cols, wm) -> None:
        from ..obs.tracing import maybe_span
        with maybe_span(self.handler.app, "reorder", self.stream_id,
                        watermark=-1 if wm is None else int(wm),
                        released=int(ts.shape[0]), depth=self.depth):
            self.handler._dispatch_arrays(ts, cols)

    def _emit_rows(self, events, wm) -> None:
        from ..obs.tracing import maybe_span
        with maybe_span(self.handler.app, "reorder", self.stream_id,
                        watermark=-1 if wm is None else int(wm),
                        released=len(events), depth=self.depth):
            self.handler._dispatch_rows(events)

    # -- late-event policies ---------------------------------------------
    def _route_late_cols(self, ts, cols, wm: int) -> None:
        n = int(ts.shape[0])
        self.counters["late"] += n
        policy = self.conf.policy
        if policy == "DROP":
            self.counters["late_dropped"] += n
        elif policy == "PROCESS":
            self.counters["late_processed"] += n
            self.handler._dispatch_arrays(ts, cols)
        else:
            self._late_as_rows(self._decode_rows(ts, cols), wm)

    def _route_late_rows(self, events, wm: int) -> None:
        self.counters["late"] += len(events)
        policy = self.conf.policy
        if policy == "DROP":
            self.counters["late_dropped"] += len(events)
        elif policy == "PROCESS":
            self.counters["late_processed"] += len(events)
            self.handler._dispatch_rows(events)
        else:
            self._late_as_rows(events, wm)

    def _late_as_rows(self, events, wm: int) -> None:
        app = self.handler.app
        if self.conf.policy == "STREAM" and self.late_junction is not None:
            self.counters["late_streamed"] += len(events)
            self.late_junction.publish(events)
            return
        # STORE: capture in the error store for a replay (the replay
        # re-sorts by original timestamp, so recovery cannot re-introduce
        # disorder: resilience/errorstore.py)
        from .errorstore import ErroredEvent
        self.counters["late_stored"] += len(events)
        app._error_store().store(app.name, ErroredEvent.from_events(
            self.stream_id, events,
            f"late event: timestamp below watermark {wm} "
            f"(lateness {self.conf.lateness_ms} ms)",
            now=app.current_time()))

    def _decode_rows(self, ts: np.ndarray, cols) -> list:
        """Columnar slice -> host Events (STRING dictionary codes decode
        back to strings). Only late-policy side paths and lane coercion
        pay this; the flush hot path stays columnar."""
        from ..core.stream import Event
        from ..core.types import AttrType, GLOBAL_STRINGS
        pycols = []
        for t, c in zip(self.schema.types, cols):
            if t is AttrType.STRING:
                pycols.append([GLOBAL_STRINGS.decode(int(x)) for x in c])
            elif t is AttrType.BOOL:
                pycols.append([bool(x) for x in c])
            elif t in (AttrType.FLOAT, AttrType.DOUBLE):
                pycols.append([float(x) for x in c])
            else:
                pycols.append([int(x) for x in c])
        return [Event(int(t), tuple(vals))
                for t, vals in zip(ts.tolist(), zip(*pycols))] if pycols \
            else [Event(int(t), ()) for t in ts.tolist()]

    # -- checkpoint ------------------------------------------------------
    def snapshot_state(self) -> dict:
        """Pure-data snapshot (numpy + tuples only — the restricted
        snapshot unpickler admits nothing else). Device ring state
        lands as one extra host columnar segment in arrival order, so
        ring and host snapshots restore interchangeably. The pending
        segments are copied: a snapshot never changes after it is
        taken."""
        cols_segs = [(np.array(t, copy=True),
                      [np.array(c, copy=True) for c in cs])
                     for t, cs in zip(self._pend_ts, self._pend_cols)]
        lane = self._lane
        if self._ring is not None and self._ring.count:
            t_host, c_host = self._ring_host_cols()
            cols_segs.append((t_host, list(c_host)))
            lane = "cols"
        return {
            "lane": lane,
            "max_ts": self.max_ts,
            "cols": cols_segs,
            "rows": [(e.timestamp, tuple(e.data), e.is_expired)
                     for e in self._pend_rows],
            "counters": dict(self.counters),
        }

    def restore_state(self, snap: dict) -> None:
        from ..core.stream import Event
        self._lane = snap["lane"]
        self.max_ts = snap["max_ts"]
        self._pend_ts = [np.asarray(t, dtype=np.int64)
                         for t, _ in snap["cols"]]
        self._pend_cols = [[np.asarray(c) for c in cs]
                           for _, cs in snap["cols"]]
        self._pend_rows = [Event(ts, tuple(data), is_expired=exp)
                           for ts, data, exp in snap["rows"]]
        self.depth = sum(len(t) for t in self._pend_ts) + \
            len(self._pend_rows)
        self.counters.update(snap.get("counters", {}))
        self._ring = None
        self._ring_wm = None
        # re-derive the sorted-run flag honestly from the restored
        # segments (cheap one-pass bit-equality check)
        run = self._lane != "rows"
        prev = None
        for seg in self._pend_ts:
            if not len(seg):
                continue
            if (prev is not None and int(seg[0]) < prev) or \
                    not bool((seg[1:] >= seg[:-1]).all()):
                run = False
                break
            prev = int(seg[-1])
        self._sorted_run = run


class DeviceReorderRing:
    """One stream's ring on the device: ``ts`` and a column each of
    capacity C, and the live count on the host. Rows [0:count] are live,
    in arrival order (each ring step keeps that), so a snapshot is a
    plain slice."""

    def __init__(self, schema, C: int, device="cpu"):
        from ..core.types import np_dtype, torch_dtype
        self.schema = schema
        self.C = int(C)
        self.device = torch.device(device)
        self.np_dtypes = [np_dtype(t) for t in schema.types]
        self.torch_dtypes = [torch_dtype(t) for t in schema.types]
        self.count = 0
        self.state = None  # (ts, cols) on the device, zeroed at first use

    def zero_state(self):
        ts = torch.zeros((self.C,), dtype=torch.int64, device=self.device)
        cols = tuple(torch.zeros((self.C,), dtype=dt, device=self.device)
                     for dt in self.torch_dtypes)
        return (ts, cols)


# ---------------------------------------------------------------------------
# kernel K10 (the ring step) and its plain version
# ---------------------------------------------------------------------------


def _lexsort_live(keyed, dead):
    """jnp.lexsort((rows, keyed, dead)): by dead (live first), then key,
    then position; two stable argsorts."""
    o1 = torch.argsort(keyed, stable=True)
    o2 = torch.argsort(dead[o1], stable=True)
    return o1[o2]


def ring_step_ref(state, in_ts, in_cols, count: int, n_in: int, wm: int,
                  min_rel: int, final: bool):
    """Plain PyTorch version of kernel K10, the reference's
    ``_build_ring_step`` (siddhi_tpu/resilience/ordering.py:820-875)
    line by line: -> ((new ts, new cols), released batch of 2C rows,
    int64 tensor [cut, wm_cut, first, last])."""
    from ..core.event import EventBatch
    sts, scols = state
    C = sts.shape[0]
    R = 2 * C
    dev = sts.device
    rows = torch.arange(R, dtype=torch.int32, device=dev)
    ar = torch.arange(C, dtype=torch.int32, device=dev)
    live = torch.cat([ar < count, ar < n_in])
    ts_all = torch.cat([sts, in_ts])
    keyed = torch.where(live, ts_all,
                        torch.full_like(ts_all, int(INT64_MAX)))
    order = _lexsort_live(keyed, (~live).to(torch.int8))
    sorted_ts = keyed[order]
    n_live = count + n_in
    wm_t = torch.tensor([wm], dtype=torch.int64, device=dev)
    wm_cut = torch.clamp(torch.searchsorted(sorted_ts, wm_t, right=True)[0],
                         max=n_live).to(torch.int32)
    cut = torch.clamp(wm_cut, min=min(min_rel, n_live))
    if final:
        cut = torch.full_like(cut, n_live)
    cols_all = [torch.cat([s, c]) for s, c in zip(scols, in_cols)]
    rel_valid = rows < cut
    rel_ts_raw = ts_all[order]
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    first = torch.where(cut > 0, rel_ts_raw[0], zero)
    last = torch.where(cut > 0, rel_ts_raw[torch.clamp(cut - 1, min=0)],
                       zero)
    batch = EventBatch(
        ts=torch.where(rel_valid, rel_ts_raw, first),
        cols=tuple(c[order] for c in cols_all),
        nulls=tuple(torch.zeros((R,), dtype=torch.bool, device=dev)
                    for _ in cols_all),
        kind=torch.zeros((R,), dtype=torch.int32, device=dev),
        valid=rel_valid)
    # the kept rows, compacted back to arrival order (a stable sort on
    # the keep flag)
    rank = torch.zeros((R,), dtype=torch.int32, device=dev)
    rank[order] = rows
    keep = live & (rank >= cut)
    perm = torch.argsort((~keep).to(torch.int8), stable=True)
    new_ts = ts_all[perm][:C]
    new_cols = tuple(c[perm][:C] for c in cols_all)
    meta = torch.stack([cut.to(torch.int64), wm_cut.to(torch.int64), first,
                        last])
    return (new_ts, new_cols), batch, meta


def ring_args(state, in_ts, in_cols, count: int, n_in: int, wm: int,
              min_rel: int, final: bool):
    """K10's arguments: the new state's, the released batch's and the
    scratch's tensors (fresh) and ``_kernels.RingArgs`` pointing at
    them. -> (new state, batch, meta, args)."""
    from ..core.event import EventBatch
    from ..ops.table import search_levels
    sts, scols = state
    C = sts.shape[0]
    R = 2 * C
    dev = sts.device
    n_cols = len(scols)
    if n_cols > _kernels.RING_MAX_COLS:
        raise NotImplementedError(
            f"not ported yet: a reorder ring of more than "
            f"{_kernels.RING_MAX_COLS} attributes ({n_cols})")

    def e(n, dtype):
        return torch.empty((n,), dtype=dtype, device=dev)
    new_ts = e(C, torch.int64)
    new_cols = tuple(e(C, c.dtype) for c in scols)
    batch = EventBatch(ts=e(R, torch.int64),
                       cols=tuple(e(R, c.dtype) for c in scols),
                       nulls=tuple(e(R, torch.bool) for _ in scols),
                       kind=e(R, torch.int32), valid=e(R, torch.bool))
    meta = e(4, torch.int64)
    blocks = (R + 1023) // 1024
    sc = {"k1": e(R, torch.int64), "k2": e(R, torch.int64),
          "i1": e(R, torch.int32), "i2": e(R, torch.int32),
          "keys": e(R, torch.int64), "pad": e(R, torch.uint8),
          "order": e(R, torch.int32), "sk": e(R, torch.int64),
          "n_live": e(1, torch.int64), "counts": e(256 * blocks, torch.int32),
          "rank": e(R, torch.int32), "keep": e(R, torch.uint8),
          "kpre": e(R, torch.int64), "sums": e(blocks, torch.int64)}
    a = _kernels.RingArgs()
    a.C, a.n_cols, a.count, a.n_in = C, n_cols, int(count), int(n_in)
    a.wm, a.min_rel, a.final_ = int(wm), int(min_rel), int(bool(final))
    a.levels = search_levels(R)
    a.sts, a.in_ts = sts.data_ptr(), in_ts.data_ptr()
    a.new_ts, a.rel_ts = new_ts.data_ptr(), batch.ts.data_ptr()
    for k in range(n_cols):
        a.scols[k] = scols[k].data_ptr()
        a.in_cols[k] = in_cols[k].data_ptr()
        a.col_size[k] = scols[k].element_size()
        a.new_cols[k] = new_cols[k].data_ptr()
        a.rel_cols[k] = batch.cols[k].data_ptr()
        a.rel_nulls[k] = batch.nulls[k].data_ptr()
    a.rel_kind, a.rel_valid = batch.kind.data_ptr(), batch.valid.data_ptr()
    a.meta = meta.data_ptr()
    for f in ("k1", "k2", "i1", "i2", "keys", "pad", "order", "sk",
              "n_live", "counts"):
        setattr(a.sort, f, sc[f].data_ptr())
    for f in ("rank", "keep", "kpre", "sums"):
        setattr(a, f, sc[f].data_ptr())
    a._keep = (state, in_ts, in_cols, sc)   # alive until the launch is made
    return (new_ts, new_cols), batch, meta, a


def ring_step(state, in_ts, in_cols, count: int, n_in: int, wm: int,
              min_rel: int, final: bool):
    """Kernel K10: one reorder-ring step. A state on the CPU takes the
    plain version; on a CUDA device csrc/reorder_ring.cu runs (one call,
    a fixed sequence of launches, no host sync). -> (new state, released
    batch, meta [cut, wm_cut, first, last] on the device)."""
    dev = state[0].device
    if dev.type == "cpu":
        return ring_step_ref(state, in_ts, in_cols, count, n_in, wm,
                             min_rel, final)
    if dev.type != "cuda":
        raise ValueError(f"ring_step: unsupported device {dev}")
    new_state, batch, meta, args = ring_args(state, in_ts, in_cols, count,
                                             n_in, wm, min_rel, final)
    _kernels.load().reorder_ring(args,
                                 torch.cuda.current_stream(dev).cuda_stream)
    _kernels.count_launch("reorder_ring")
    return new_state, batch, meta
