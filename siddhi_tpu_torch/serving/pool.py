"""TenantPool: every tenant of one template as one slotted runtime on one
device (PyTorch port of siddhi_tpu/serving/pool.py).

One pool = one template (+ shared structural bindings) = one planned
set of query steps. Per-tenant states stack on a leading slot axis, and
each of the reference's ``jax.jit(jax.vmap(step))`` programs is here one
launch sequence over ALL slots, through the kernels' slot axis
(``blockIdx.y``, csrc/siddhi_kernels.h part_args):

- **chain** (filter/window/projection insert-into chains): a round's
  packed (slots, total) buffer decodes through K1[K]; filters and the
  projection run K2 over the slots' rows as one batch, each template
  parameter ``${name:type}`` a load of one value a slot and the emitted
  rows counted into one counter a slot; windows run K5[K] (a cron window
  K5's cron kind over the slots, K5c[K]: as in the reference's pool it
  is never fired, since a round feeds no TIMER row, and it buffers and
  counts its overflow);
- **pattern**: the NFA step runs K3[K] (the round-parallel engine, one
  pending table a slot) or K4[K] (the scan engine); a pattern with
  absent deadlines also runs K4[K]'s timer step every dispatch (the
  pool's round clock replaces the host scheduler);
- **join**: each side's chain (K2, K5[K]), then K7[K] crosses every
  slot's trigger rows with that slot's opposite window, the pairs lost
  at the cap counted in the slot's ``ovf``;
- **aggregation** (``define aggregation``): K11[K] folds every slot's
  rows into that slot's bucket tables of every duration (the
  group-by and argument expressions K2 first); ``materialize_tenant``
  reads one tenant's ``within ... per`` view. An aggregation node's
  state is the port's runtime layout with the slot axis in front,
  ``[slots, D, K]`` a field (the reference keeps ``{duration: state}``,
  ``[slots, K]`` a field; ``carry.pool_from_jax`` stacks it).

Selectors may hold min/max over expiring content, distinctCount and
unionSet: kernels C, D and H run over the slot axis between K6[K]'s two
parts. Order-by, offset and limit run kernel G[K] over every slot's
rows (ops/selector.py shape_chunk_slots); ``#pol2Cart`` is a K2 program
of the new columns and ``#log`` prints slot by slot; a template
parameter may stand in a filter before an aggregating selector (K2's
loads in K6's first program). As in the reference's pool, a query's
output rate limiter and a STRING order-by's host edge are not applied.

Ingest is the reference's FAIR ROUND-ROBIN: each tenant contributes at
most ``batch_max`` rows a round (the QoS plan, serving/qos.py, spends a
tenant's limit across its ingest streams in stream order), tenants take
in the order they were added, and every round ships ONE packed buffer
per ingest stream, all slots under one encoding (core/ingest.py
``widen_round``). Idle slots are stepped too: their row of the buffer is
zeros but for the round clock. ``advance_time`` and the hops between
queries run the stacked-batch flavour, as in the reference.

Slot layout: the axis starts small and doubles when tenants exceed it
(``_grow`` pads the new slots with zeros, not with an initial state);
``add_tenant`` writes the tenant's initial state and parameters into its
slot; ``remove_tenant`` leaves the state where it is. Free slots are
handed out LIFO. Admission rejects past ``max_tenants``, past the state
quota and past the ingest backlog with the reference's reasons.

A failing tenant callback is isolated: its events are counted, logged
and written to the tenant's error-store partition
(``tenant_partition``), and the other tenants' delivery goes on;
``replay_errors`` delivers a partition again in original-timestamp
order. Checkpoint and recovery: ``snapshot_tenant``/``restore_tenant``
(one slot), ``snapshot``/``persist``/``restore``/``restore_revision``
(the whole pool, onto a fresh pool of the same template), and the
round hook of resilience/supervisor.py's ``PoolCheckpointSupervisor``.
Migration, a device mesh, explain and the metrics registry raise
NotImplementedError ("not ported yet").
"""
from __future__ import annotations

import dataclasses
import logging
import math
import threading
import time
from collections import deque
from typing import Callable, Optional

import numpy as np
import torch

from .. import _kernels
from ..analysis.plan_rules import check_template_bindings
from ..core.event import EXPIRED, EventBatch, rows_from_batch
from ..core import aggregation as _aggregation
from ..core import ingest as _ingest
from ..core.ingest import PackedEncoder, layout
from ..core.runtime import (BATCH_BUCKETS, InsertIntoStreamHandler,
                            JoinQueryRuntime, PatternQueryRuntime,
                            SiddhiAppRuntime, _as_current, _chain_body,
                            _side_chain, bucket_capacity)
from ..core.stream import Event
from ..core.types import AttrType, GLOBAL_STRINGS, np_dtype
from ..lang import ast as A
from ..obs.slo import (FlightRecorder, SLOEngine,
                       config_from_annotation as _slo_from_ann,
                       objective_from_dials)
from ..ops.expr import CompileError
from ..ops.join import combined_schema
from ..ops import nfa as _nfa
from ..ops import nfa_parallel as _nfa_par
from ..ops.nfa_parallel import ParallelNfaEngine
from ..ops.slots import leaves, stacked, tree_map
from .qos import PoolQoS

# _kind slug -> the operator-class name used in quota accounting and
# the 429 per-class state-bytes breakdown
_CLASS_NAMES = {"chain": "chain", "pattern": "pattern", "join": "join",
                "agg": "aggregation"}

log = logging.getLogger("siddhi_tpu_torch.serving")

_DEFAULT_MAX_TENANTS = 1024
_DEFAULT_BATCH_MAX = 1024
_DEFAULT_PENDING_CAP = 1 << 20   # rows buffered per tenant before 429
# SLO sampling stride for pool rounds (@app:slo(every=) or the slo dial
# set it)
_POOL_DEFAULT_EVERY = 8
# the slot axis is a launch's blockIdx.y: the largest power of two there
POOL_MAX_SLOTS = 32768


def _not_ported(what: str):
    return NotImplementedError(f"not ported yet: {what}")


class AdmissionError(Exception):
    """Deploy/ingest rejected by admission control (HTTP 429 at the
    front door); ``.reason`` names the exhausted resource and
    ``.saturation`` carries the machine-readable cause (which resource,
    current pressure signals, a Retry-After estimate)."""

    def __init__(self, reason: str, saturation: Optional[dict] = None):
        super().__init__(reason)
        self.reason = reason
        self.saturation = saturation or {}


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class TenantPool:
    """Slotted runtime for every tenant of one template."""

    def __init__(self, template, shared: Optional[dict] = None,
                 manager=None, name: Optional[str] = None,
                 slots: int = 8, max_tenants: Optional[int] = None,
                 state_quota_bytes: Optional[int] = None,
                 batch_max: Optional[int] = None,
                 pending_cap: int = _DEFAULT_PENDING_CAP,
                 slo: Optional[dict] = None,
                 qos: Optional[dict] = None,
                 mesh=None,
                 device_round_cap: Optional[int] = None):
        from ..core.manager import SiddhiManager
        if mesh is not None:
            raise _not_ported("a tenant pool over a device mesh (mesh=)")
        if device_round_cap is not None:
            raise _not_ported("device_round_cap")
        self.template = template
        self.shared = dict(shared or {})
        self.name = name or f"pool_{template.key[:8]}"
        self.manager = manager or SiddhiManager()
        self.device = self.manager.device
        app_ast = template.instantiate(shared=self.shared,
                                       app_name=self.name)
        # prototype runtime: planned once, NEVER started — the pool runs
        # slotted steps over its operators. @app:cap and @app:slo are the
        # pool's own dials, read below: the prototype plans without them
        proto_ast = dataclasses.replace(app_ast, annotations=[
            a for a in app_ast.annotations
            if a.name.lower() not in ("cap", "slo")])
        self.proto = SiddhiAppRuntime(proto_ast, manager=None,
                                      device=self.device)
        # the prototype's store lookups go through the pool's manager:
        # tenant error partitions and pool checkpoints live in the shared
        # stores, where a fresh pool built after a crash finds them
        self.proto.manager = self.manager
        self._plan_topology()
        self._check_poolable()

        cap_ann = A.find_annotation(app_ast.annotations, "cap")
        if max_tenants is None:
            max_tenants = int(cap_ann.element("tenants")
                              or _DEFAULT_MAX_TENANTS) \
                if cap_ann else _DEFAULT_MAX_TENANTS
        if state_quota_bytes is None and cap_ann is not None:
            kb = cap_ann.element("tenant.state.kb")
            if kb is not None:
                state_quota_bytes = int(kb) * 1024 * max_tenants
        self.max_tenants = int(max_tenants)
        self.state_quota_bytes = state_quota_bytes
        if batch_max is None:
            batch_max = _DEFAULT_BATCH_MAX
        # fair-share row cap per tenant per round, bucketed, and capped
        # by the sort-heavy step limits of the template's queries
        for q in self.proto.queries.values():
            if q.max_step_capacity is not None:
                batch_max = min(batch_max, q.max_step_capacity)
        self.batch_max = bucket_capacity(int(batch_max))
        self.pending_cap = int(pending_cap)

        # -- QoS (serving/qos.py): dials merge constructor `qos={...}`
        # over `@app:cap(...)` elements; default dials plan exactly the
        # fixed batch_max round
        qos_dials: dict = {}
        if cap_ann is not None:
            for el, key in (("rate.eps", "rate_eps"),
                            ("rate.burst", "rate_burst"),
                            ("breaker.failures", "breaker_failures"),
                            ("breaker.reset.ms", "breaker_reset_ms"),
                            ("qos.max.defer", "max_defer")):
                v = cap_ann.element(el)
                if v is not None:
                    qos_dials[key] = float(v) if "rate" in el else int(v)
        qos_dials.update({k: v for k, v in dict(qos or {}).items()
                          if v is not None})
        try:
            self._qos = PoolQoS(qos_dials,
                                on_transition=self._on_breaker_transition)
        except ValueError as e:
            raise CompileError(f"pool '{self.name}' qos: {e}")

        self.slots = _pow2(max(1, min(int(slots), self.max_tenants)))
        self._slot_cap = _pow2(self.max_tenants)
        if self._slot_cap > POOL_MAX_SLOTS:
            # the slot is a launch's blockIdx.y (at most 65,535)
            raise _not_ported(f"a tenant pool of more than {POOL_MAX_SLOTS} "
                              f"slots (max_tenants {self.max_tenants})")
        # stacked per-query state: leading axis = tenant slot
        self._states = {qn: self._stack_init(qn, self.slots)
                        for qn in self._order}
        self._emitted = {qn: torch.zeros((self.slots,), dtype=torch.int64,
                                         device=self.device)
                         for qn in self._order}
        # per-tenant state bytes (quota accounting): one slot's slice of
        # every query state plus its emitted counter, per operator class
        self.state_bytes_by_class: dict[str, int] = {}
        total_bytes = 0
        for qn in self._order:
            b = 8 + sum(x.numel() * x.element_size() // self.slots
                        for x in leaves(self._states[qn]))
            cls = _CLASS_NAMES[self._kind[qn]]
            self.state_bytes_by_class[cls] = \
                self.state_bytes_by_class.get(cls, 0) + b
            total_bytes += b
        self.state_bytes_per_tenant = total_bytes

        self._tenants: dict[str, int] = {}
        # each tenant's bindings and QoS dials as given: a whole-pool
        # snapshot carries them to rebuild the admission bookkeeping
        self._bindings: dict[str, dict] = {}
        self._tenant_qos_raw: dict[str, dict] = {}
        self._free = list(range(self.slots - 1, -1, -1))
        # tid -> {ingest stream -> deque of (ts, cols, t_arrival)}
        self._pending: dict[str, dict] = {}
        self._pending_rows: dict[str, int] = {}
        # one sticky widen-only encoder per ingest stream: all slots of a
        # round share its encoding (one (slots, total) transfer a stream)
        self._encoders: dict[str, PackedEncoder] = {}
        self._ingest_stats = {"transfers": 0, "rows": 0, "cells": 0,
                              "bytes": 0, "rounds": 0}
        self._callbacks: dict[str, list[Callable]] = {}
        self._error_counts: dict[str, int] = {}
        self.batch_callbacks: list[Callable] = []
        self._bodies: dict = {}
        self._lock = threading.RLock()
        self._now = -(2 ** 62)
        self._rounds = 0
        self._dispatches = 0
        self._grows = 0
        self._running = False
        self._worker: Optional[threading.Thread] = None
        self._work = threading.Condition(self._lock)
        # -- SLO engine + saturation signals (obs/slo.py) -----------------
        slo_dials = dict(slo or {})
        flight_dir = slo_dials.pop("flight_dir", None)
        objective = None
        if slo_dials:
            objective = objective_from_dials(slo_dials)
        else:
            slo_ann = A.find_annotation(app_ast.annotations, "slo")
            if slo_ann is not None:
                try:
                    objective = _slo_from_ann(slo_ann)
                except ValueError as e:
                    raise CompileError(str(e))
        every = objective.every if objective is not None and \
            objective.every else _POOL_DEFAULT_EVERY
        # until plan_hash is ported, artifacts carry the template key
        self.flight = FlightRecorder(
            self.name, dirpath=flight_dir,
            identity_fn=lambda: {"app": self.name, "pool": self.name,
                                 "plan_hash": self.template.key})
        self.slo_engine = SLOEngine(
            self.name, objective=objective, every=every,
            recorder=self.flight, context_fn=self._flight_context)
        self._rejections: dict[str, int] = {}
        self._rejection_times: deque = deque(maxlen=512)
        # a PoolCheckpointSupervisor registers itself here; restore()
        # fills _recovery
        self._checkpoint_supervisor = None
        self._recovery: Optional[dict] = None
        self._last_pump_wall: Optional[float] = None
        self._round_ms_ema: Optional[float] = None

    # -- planning ---------------------------------------------------------

    def _plan_topology(self) -> None:
        """The query wiring from the prototype's junction graph: N named
        ingest streams in, queries in topological order, terminal streams
        (produced, never consumed) out. Every node gets a ``_kind``
        (chain/pattern/join/agg) and labeled inputs — chains and
        aggregations one ``("*", sid)``, patterns one
        ``("s:<sid>", sid)`` per distinct engine stream, joins
        ``("L", sid)``/``("R", sid)``."""
        p = self.proto
        self._q_in: dict[str, tuple] = {}
        self._q_out: dict[str, Optional[str]] = {}
        self._kind: dict[str, str] = {}
        produced: set[str] = set()
        consumers: dict[str, list[str]] = {}
        for qn, q in p.queries.items():
            if isinstance(q, PatternQueryRuntime):
                self._kind[qn] = "pattern"
                ins = tuple(
                    ("s:" + sid, sid) for sid in
                    sorted({s.stream_id for s in q.engine.slots}))
            elif isinstance(q, JoinQueryRuntime):
                self._kind[qn] = "join"
                ins = tuple(
                    (side, q.in_schemas[side].stream_id)
                    for side in ("L", "R")
                    if side not in q.side_tables)
            else:
                self._kind[qn] = "chain"
                ins = (("*", q.in_schema.stream_id),)
            self._q_in[qn] = ins
            for _lab, sid in ins:
                consumers.setdefault(sid, []).append(qn)
            out = None
            for h in q.output_handlers:
                if isinstance(h, InsertIntoStreamHandler):
                    out = h.junction.stream_id
                    produced.add(out)
            self._q_out[qn] = out
        self._aggs: dict = {}
        for aid, ar in p.aggregations.items():
            if aid in self._q_in:
                raise CompileError(
                    f"aggregation '{aid}' collides with a query name")
            self._kind[aid] = "agg"
            self._aggs[aid] = ar
            self._q_in[aid] = (("*", ar.in_schema.stream_id),)
            self._q_out[aid] = None
            consumers.setdefault(ar.in_schema.stream_id, []).append(aid)
        ingest = sorted(sid for sid in consumers if sid not in produced)
        self._ingest_streams = ingest
        # topological order (BFS from the ingest streams; a node places
        # once ALL its labeled inputs are available)
        avail = set(ingest)
        order: list[str] = []
        remaining = {qn: {sid for _lab, sid in ins}
                     for qn, ins in self._q_in.items()}
        while remaining:
            placed = [qn for qn, sids in remaining.items()
                      if sids <= avail]
            if not placed:
                break   # unreachable/cyclic queries — poolability rejects
            for qn in sorted(placed):
                order.append(qn)
                remaining.pop(qn)
                if self._q_out[qn]:
                    avail.add(self._q_out[qn])
        self._order = order
        self._unreachable = sorted(remaining)
        self._terminal = sorted(
            sid for sid in produced if sid not in consumers)

    # classes that cannot pool: (proto attr, what, why, nearest poolable
    # alternative)
    _UNPOOLABLE = (
        ("partitions", "partitions",
         "partition state fans out per key value, not per tenant slot",
         "key by an attribute inside a pooled filter/window chain"),
        ("named_windows", "named windows",
         "a named window is one shared instance crossing query (and "
         "tenant) boundaries",
         "give each query its own window(...) inside the template"),
        ("tables", "tables",
         "table state is shared mutable storage updated by host-side "
         "index rebuilds",
         "model reference data as a windowed stream and join it"),
        ("triggers", "triggers",
         "triggers fire on wall-clock schedules outside the fair round "
         "loop",
         "drive time with advance_time()/pump() rounds"),
    )

    def _check_poolable(self) -> None:
        p = self.proto
        problems = []
        for attr, what, why, alt in self._UNPOOLABLE:
            if getattr(p, attr, None):
                problems.append(f"{what} ({why}; nearest poolable "
                                f"alternative: {alt})")
        for qn, q in p.queries.items():
            if q.table_deps or getattr(q, "side_tables", None):
                problems.append(
                    f"query '{qn}' reads tables (shared mutable "
                    "storage; nearest poolable alternative: join "
                    "against a windowed stream)")
            elif self._q_out.get(qn) is None:
                problems.append(
                    f"query '{qn}' has a non-insert-into output "
                    "(nearest poolable alternative: insert into a "
                    "stream and attach per-tenant callbacks)")
        if not self._ingest_streams:
            problems.append("no ingest stream (every stream is "
                            "query-produced)")
        if self._unreachable:
            problems.append(
                f"unreachable queries {', '.join(self._unreachable)}")
        if problems:
            raise CompileError(
                f"template '{self.template.name}' is not poolable — "
                "slotted tenant execution covers filter/window/"
                "projection chains, patterns, joins, and incremental "
                "aggregations over named ingest streams; "
                "found: " + "; ".join(problems))
        # every window kind has the slot axis. As in the reference's
        # pool, a query's output rate limiter and a STRING order-by's host
        # edge are not applied (a tenant's rows arrive unlimited and, for
        # a STRING key, unordered), and a cron window is never fired: the
        # pool feeds no TIMER row, so it buffers each round's rows (K5c[K])
        # and counts its overflow

    @property
    def ingest_streams(self) -> tuple:
        return tuple(self._ingest_streams)

    def _resolve_stream(self, stream: Optional[str]) -> str:
        if stream is None:
            if len(self._ingest_streams) == 1:
                return self._ingest_streams[0]
            raise ValueError(
                f"pool '{self.name}' has {len(self._ingest_streams)} "
                f"ingest streams {self._ingest_streams} — "
                "send(..., stream=) must name one")
        if stream not in self._ingest_streams:
            raise KeyError(
                f"'{stream}' is not an ingest stream of pool "
                f"'{self.name}' (ingest: {self._ingest_streams})")
        return stream

    def _pick_slot(self) -> int:
        """Pop a free slot (LIFO)."""
        return self._free.pop()

    # -- state stacking ---------------------------------------------------
    # Slot-state layout per operator class (the reference's):
    #   chain   -> tuple(op state, ...)
    #   pattern -> {"nfa": pending-match table, "sel": tuple(op state)}
    #   join    -> {"sides": {"L": tuple, "R": tuple},
    #               "sel": tuple, "ovf": join-cap drop counter}
    #   agg     -> the aggregation runtime's state: every duration's
    #              bucket table stacked, [D, K] a field (the reference:
    #              {duration: bucket-table state})

    def _unstacked_init(self, qname: str):
        """One tenant's fresh state for one query (on the CPU)."""
        kind = self._kind[qname]
        if kind == "agg":
            return self._aggs[qname]._init_state("cpu")
        q = self.proto.queries[qname]
        sel = tuple(op.init_state() for op in q.operators)
        if kind == "pattern":
            return {"nfa": q.engine.init_state(), "sel": sel}
        if kind == "join":
            return {"sides": {s: tuple(op.init_state() for op in ops)
                              for s, ops in q.side_ops.items()},
                    "sel": sel,
                    "ovf": torch.zeros((), dtype=torch.int64)}
        return sel

    def _stack_init(self, qname: str, slots: int):
        return stacked(self._unstacked_init(qname), slots, self.device)

    @staticmethod
    def _ops_init_with_params(ops, vals: dict):
        states = []
        for op in ops:
            st = op.init_state()
            tps = getattr(op, "tparams", ())
            if tps:
                st = {"tparams": {
                    n: torch.from_numpy(np.asarray(
                        TenantPool._encode_param(vals[n][0], t),
                        dtype=np_dtype(t)))
                    for n, t in tps}}
            states.append(st)
        return tuple(states)

    def _tenant_init_states(self, qname: str, vals: dict):
        """One tenant's fresh state with its bound `${...}` values in
        place of the zeros."""
        kind = self._kind[qname]
        if kind == "agg":
            return self._unstacked_init(qname)
        q = self.proto.queries[qname]
        sel = self._ops_init_with_params(q.operators, vals)
        if kind == "pattern":
            return {"nfa": q.engine.init_state(), "sel": sel}
        if kind == "join":
            return {"sides": {
                        s: self._ops_init_with_params(ops, vals)
                        for s, ops in q.side_ops.items()},
                    "sel": sel,
                    "ovf": torch.zeros((), dtype=torch.int64)}
        return sel

    @staticmethod
    def _encode_param(value, t: AttrType):
        """A binding as its slot value: STRING as this process's
        dictionary code, BOOL as bool, the numbers as they are (INT
        wraps in int32, DOUBLE is f64: the declared type's dtype)."""
        if t is AttrType.STRING:
            return GLOBAL_STRINGS.encode(str(value))
        if t is AttrType.BOOL:
            return bool(value)
        return value

    # -- tenant lifecycle -------------------------------------------------

    def admit(self) -> tuple[bool, str]:
        """Admission control: (ok, reason)."""
        with self._lock:
            ok, reason, _cause = self._admit_check()
        return ok, reason

    def _admit_check(self) -> tuple[bool, str, str]:
        """(ok, human reason, machine cause)."""
        if len(self._tenants) >= self.max_tenants:
            return False, (f"pool '{self.name}' tenant slots exhausted "
                           f"(cap {self.max_tenants})"), "slots-exhausted"
        if self.state_quota_bytes is not None:
            need = (len(self._tenants) + 1) * self.state_bytes_per_tenant
            if need > self.state_quota_bytes:
                per_class = ", ".join(
                    f"{k}={v}" for k, v in
                    sorted(self.state_bytes_by_class.items()))
                return False, (
                    f"pool '{self.name}' per-tenant state quota "
                    f"exhausted ({need} > {self.state_quota_bytes} bytes "
                    f"at {self.state_bytes_per_tenant} bytes/tenant: "
                    f"{per_class})"), \
                    "state-quota"
        return True, "", ""

    # -- saturation signals (obs/slo.py) ----------------------------------

    def _retry_after_ms(self, pending_rows: int) -> int:
        """Backlog drain estimate: rounds needed at the fair-share rate
        times the EMA round duration — the 429's Retry-After hint."""
        rounds = max(1, math.ceil(pending_rows / max(1, self.batch_max)))
        per_round = self._round_ms_ema if self._round_ms_ema else 1.0
        return int(math.ceil(rounds * max(per_round, 1.0)))

    def _reject(self, cause: str, reason: str,
                tenant: Optional[str] = None, **info):
        """Count + flight-record an admission rejection, then raise
        AdmissionError carrying the saturation payload (caller holds the
        pool lock)."""
        self._rejections[cause] = self._rejections.get(cause, 0) + 1
        self._rejection_times.append(time.perf_counter())
        sat = {"cause": cause, **info, **self._saturation_locked()}
        if tenant is not None:
            sat["tenant"] = tenant
        self.flight.record("admission-reject", cause=cause,
                           tenant=tenant, reason=reason)
        raise AdmissionError(reason, saturation=sat)

    def _saturation_locked(self) -> dict:
        """Current pressure signals (host-side only; caller holds the
        lock): queue age, backlog, round-drain lag, rejection counts."""
        now = time.perf_counter()
        ages = [now - q[0][2] for qs in self._pending.values()
                for q in qs.values() if q]
        pending_total = sum(self._pending_rows.values())
        lag = 0.0
        if pending_total and self._last_pump_wall is not None:
            lag = (now - self._last_pump_wall) * 1000.0
        recent = sum(1 for t in self._rejection_times if now - t <= 60.0)
        return {
            "pending_rows": pending_total,
            "queue_age_ms_max": round(max(ages) * 1000.0, 1)
            if ages else 0.0,
            "drain_lag_ms": round(lag, 1),
            "round_ms_ema": round(self._round_ms_ema, 2)
            if self._round_ms_ema is not None else None,
            "rejections": dict(self._rejections),
            "rejections_last_60s": recent,
        }

    def saturation(self) -> dict:
        with self._lock:
            return self._saturation_locked()

    def _flight_context(self) -> dict:
        with self._lock:
            return {
                "pool": self.name, "slots": self.slots,
                "active": len(self._tenants), "rounds": self._rounds,
                "pending": dict(self._pending_rows),
                "saturation": self._saturation_locked(),
            }

    def add_tenant(self, tenant_id: str,
                   bindings: Optional[dict] = None,
                   qos: Optional[dict] = None) -> int:
        """Admit a tenant into a slot: validate bindings (the
        template-binding rule), write the tenant's initial state and
        parameter values into the slot. ``qos``: per-tenant dials
        (weight / priority / rate_eps / burst)."""
        with self._lock:
            if tenant_id in self._tenants:
                raise ValueError(
                    f"tenant '{tenant_id}' is already deployed in pool "
                    f"'{self.name}'")
            ok, reason, cause = self._admit_check()
            if not ok:
                self._reject(cause, reason, tenant=tenant_id,
                             active=len(self._tenants),
                             max_tenants=self.max_tenants,
                             state_bytes_per_tenant=
                             self.state_bytes_per_tenant,
                             state_bytes_by_class=dict(
                                 self.state_bytes_by_class))
            vals = check_template_bindings(self.proto.ast,
                                           dict(bindings or {}))
            self._qos.add_tenant(tenant_id, qos)
            if not self._free:
                self._grow()
            slot = self._pick_slot()
            for qn in self._order:
                init = tree_map(torch.as_tensor,
                                self._tenant_init_states(qn, vals))
                for full, iv in zip(leaves(self._states[qn]), leaves(init)):
                    full[slot] = iv.to(full.device)
                self._emitted[qn][slot] = 0
            self._tenants[tenant_id] = slot
            self._bindings[tenant_id] = dict(bindings or {})
            self._tenant_qos_raw[tenant_id] = dict(qos or {})
            self._pending[tenant_id] = self._fresh_queues()
            self._pending_rows[tenant_id] = 0
            self._error_counts[tenant_id] = 0
            return slot

    def remove_tenant(self, tenant_id: str) -> bool:
        """Free the tenant's slot (its state stays where it is until the
        slot is reassigned)."""
        with self._lock:
            slot = self._tenants.pop(tenant_id, None)
            if slot is None:
                return False
            self._free.append(slot)
            self._bindings.pop(tenant_id, None)
            self._tenant_qos_raw.pop(tenant_id, None)
            self._pending.pop(tenant_id, None)
            self._pending_rows.pop(tenant_id, None)
            self._callbacks.pop(tenant_id, None)
            self._error_counts.pop(tenant_id, None)
            self._qos.remove_tenant(tenant_id)
            return True

    def _grow(self) -> None:
        new_slots = self.slots * 2
        if new_slots > self._slot_cap:
            self._reject(
                "slots-exhausted",
                f"pool '{self.name}' tenant slots exhausted "
                f"(cap {self.max_tenants})",
                active=len(self._tenants),
                max_tenants=self.max_tenants)
        log.info("pool '%s': growing tenant axis %d -> %d slots",
                 self.name, self.slots, new_slots)

        def pad(x):
            return torch.cat([x, torch.zeros((self.slots,) + x.shape[1:],
                                             dtype=x.dtype,
                                             device=x.device)], dim=0)
        self._states = {qn: tree_map(pad, st)
                        for qn, st in self._states.items()}
        self._emitted = {qn: pad(e) for qn, e in self._emitted.items()}
        self._free.extend(range(new_slots - 1, self.slots - 1, -1))
        self.slots = new_slots
        self._grows += 1

    def _slot(self, tenant_id: str) -> int:
        slot = self._tenants.get(tenant_id)
        if slot is None:
            raise KeyError(f"no tenant '{tenant_id}' in pool "
                           f"'{self.name}'")
        return slot

    def tenant_partition(self, tenant_id: str) -> str:
        """Error-store partition key for one tenant."""
        return f"{self.name}/tenant/{tenant_id}"

    def add_callback(self, tenant_id: str, fn: Callable) -> None:
        """Per-tenant output callback: fn(events) with the tenant's rows
        of every terminal stream. A raising callback is isolated: its
        events are counted and logged; other tenants are unaffected."""
        with self._lock:
            self._slot(tenant_id)
            self._callbacks.setdefault(tenant_id, []).append(fn)

    # -- ingest (fair round-robin batching) -------------------------------

    def _fresh_queues(self) -> dict:
        return {sid: deque() for sid in self._ingest_streams}

    def send(self, tenant_id: str, ts, cols,
             stream: Optional[str] = None) -> None:
        """Queue one columnar chunk for a tenant (numpy ts + columns,
        STRING columns as dictionary codes). ``stream`` routes
        multi-ingest templates; single-stream templates may omit it.
        Dispatch happens in fair rounds via pump()/flush() or the
        background worker."""
        sid = self._resolve_stream(stream)
        ts = np.asarray(ts, dtype=np.int64)
        n = int(ts.shape[0])
        if n == 0:
            return
        cols = [np.ascontiguousarray(c) for c in cols]
        t_arr = time.perf_counter()
        with self._lock:
            self._slot(tenant_id)
            ok, retry_ms = self._qos.check_rate(tenant_id, n)
            if not ok:
                self._reject(
                    "rate-limited",
                    f"tenant '{tenant_id}' over its ingest rate "
                    f"limit ({n} rows rejected; retry in "
                    f"{retry_ms} ms)",
                    tenant=tenant_id, rows=n,
                    retry_after_ms=retry_ms)
            if self._pending_rows[tenant_id] + n > self.pending_cap:
                self._reject(
                    "ingest-backlog",
                    f"tenant '{tenant_id}' ingest backlog full "
                    f"({self._pending_rows[tenant_id]} rows pending, "
                    f"cap {self.pending_cap})",
                    tenant=tenant_id,
                    pending_rows=self._pending_rows[tenant_id],
                    pending_cap=self.pending_cap,
                    retry_after_ms=self._retry_after_ms(
                        self._pending_rows[tenant_id]))
            qs = self._pending.setdefault(tenant_id,
                                          self._fresh_queues())
            qs[sid].append((ts, cols, t_arr))
            self._pending_rows[tenant_id] += n
            self._work.notify()

    def _take(self, tenant_id: str, sid: str, limit: int):
        """Up to `limit` rows off a tenant's pending queue for ONE
        ingest stream (splitting a chunk re-queues the remainder at the
        head — order AND arrival stamp preserved). Returns
        (ts, cols, oldest_arrival)."""
        q = self._pending.get(tenant_id, {}).get(sid)
        if not q:
            return None
        ts_parts, col_parts, taken = [], [], 0
        t_oldest = None
        while q and taken < limit:
            ts, cols, t_arr = q.popleft()
            room = limit - taken
            if len(ts) > room:
                q.appendleft((ts[room:], [c[room:] for c in cols], t_arr))
                ts, cols = ts[:room], [c[:room] for c in cols]
            ts_parts.append(ts)
            col_parts.append(cols)
            taken += len(ts)
            if t_oldest is None:
                t_oldest = t_arr
        if not taken:
            return None
        self._pending_rows[tenant_id] -= taken
        ts = np.concatenate(ts_parts)
        cols = [np.concatenate([p[i] for p in col_parts])
                for i in range(len(col_parts[0]))]
        return ts, cols, t_oldest

    def pump(self) -> int:
        """One fair dispatch round: every tenant contributes up to its
        QoS limit (batch_max with default dials), one launch sequence a
        query advances all of them. Returns rows dispatched (0 = nothing
        pending). Every ``slo_engine.every``-th round synchronises after
        each query and attributes arrival->emit latency per tenant."""
        t_round0 = time.perf_counter()
        with self._lock:
            per_stream: dict[str, dict] = {}
            stamps: dict[str, float] = {}
            taken = 0
            last_ts = self._now
            # the DRR/priority plan; a tenant's limit spends across its
            # ingest streams in stream order
            limits = self._qos.plan_round(dict(self._pending_rows),
                                          self.batch_max)
            for tid, slot in self._tenants.items():
                limit = limits.get(tid, 0)
                if limit <= 0:
                    continue
                for sid in self._ingest_streams:
                    if limit <= 0:
                        break
                    got = self._take(tid, sid, limit)
                    if got is None:
                        continue
                    ts_a, cols_a, t_arr = got
                    n = len(ts_a)
                    limit -= n
                    per_stream.setdefault(sid, {})[slot] = (ts_a, cols_a)
                    stamps[tid] = min(stamps.get(tid, t_arr), t_arr)
                    taken += n
                    last_ts = max(last_ts, int(ts_a[-1]))
            if not taken:
                self._last_pump_wall = time.perf_counter()
                return 0
            self._now = max(self._now, last_ts)
            # ONE transfer per ingest stream: the packed (slots, total)
            # buffer
            stream_inputs = {
                sid: [self._ingest_entry(sid, per_slot)]
                for sid, per_slot in per_stream.items()}
            self._ingest_stats["rounds"] += 1
            sampled = self.slo_engine.tick("round")
            terminal, qtimes = self._dispatch(stream_inputs, self._now,
                                              sample=sampled)
            self._rounds += 1
            if self._checkpoint_supervisor is not None:
                # the periodic whole-pool checkpoint at the round
                # boundary: states updated, delivery not yet run (the
                # error-store replay covers the delivery, at-least-once)
                self._checkpoint_supervisor.on_round(self._rounds)
            if sampled and qtimes:
                self._slo_attribute(stamps, qtimes, taken)
            dur_ms = (time.perf_counter() - t_round0) * 1000.0
            self._round_ms_ema = dur_ms if self._round_ms_ema is None \
                else 0.8 * self._round_ms_ema + 0.2 * dur_ms
            self._last_pump_wall = time.perf_counter()
        self._deliver(terminal)
        return taken

    def _slo_attribute(self, stamps: dict, qtimes: dict,
                       taken: int) -> None:
        """Fold one sampled round's per-query completion times into the
        SLO windows (host wall math only)."""
        eng = self.slo_engine
        t_end = max(qtimes.values()) if qtimes else None
        oldest = min(stamps.values()) if stamps else None
        for tid, t_arr in stamps.items():
            for qn, t_q in qtimes.items():
                eng.observe((("tenant", tid), ("query", qn)),
                            (t_q - t_arr) * 1000.0)
            if t_end is not None:
                eng.observe((("tenant", tid),),
                            (t_end - t_arr) * 1000.0)
        if t_end is not None and oldest is not None:
            lat = (t_end - oldest) * 1000.0
            eng.observe((), lat)
            self.flight.record("round", rows=taken,
                               tenants=len(stamps),
                               lat_ms=round(lat, 3))

    def flush(self) -> int:
        """Drain every pending chunk through fair rounds."""
        total = 0
        while True:
            n = self.pump()
            if n == 0:
                return total
            total += n

    def advance_time(self, now_ms: int) -> None:
        """Drive time-based window boundaries (and pattern absent
        deadlines) with no traffic: one empty-batch dispatch per ingest
        stream at the given event time (all slots' rows invalid)."""
        with self._lock:
            self._now = max(self._now, int(now_ms))
            stream_inputs = {
                sid: [("b", self._stacked_batch({}, BATCH_BUCKETS[0],
                                                sid))]
                for sid in self._ingest_streams}
            terminal, _qt = self._dispatch(stream_inputs, self._now)
        self._deliver(terminal)

    # -- dispatch ---------------------------------------------------------

    def _ingest_entry(self, sid: str, per_slot: dict):
        """One ingest stream's round input as a dispatch entry:
        ``("p", (buf, enc, cap))``, one uint8 transfer for all slots.
        Updates the packed-ingest stats (rows vs padded cells)."""
        cap = bucket_capacity(
            max(len(r[0]) for r in per_slot.values()))
        st = self._ingest_stats
        st["transfers"] += 1
        st["rows"] += sum(len(t) for t, _c in per_slot.values())
        st["cells"] += self.slots * cap
        return self._pack_round(sid, per_slot, cap)

    def _pack_round(self, sid: str, per_slot: dict, cap: int):
        """Pack one ingest stream's round into ONE (slots, total) uint8
        buffer (core/ingest.py wire format, one row per slot), all rows
        under the encoder's round-wide encoding, and ship it in one
        copy. Empty slots stay all-zero except the `now` header slot:
        every row carries the round clock."""
        enc_ = self._encoders.get(sid)
        if enc_ is None:
            schema = self.proto.junctions[sid].schema
            enc_ = self._encoders[sid] = PackedEncoder(schema)
        chunks = list(per_slot.values())
        enc = enc_.widen_round(chunks)
        _H, _offs, total = layout(len(enc_.schema.types), enc, cap)
        big = np.zeros((self.slots, total), np.uint8)
        # round clock into EVERY slot's header (bytes 16:24 = now)
        big[:, 16:24] = np.frombuffer(np.int64(self._now).tobytes(),
                                      np.uint8)
        for slot, (ts_a, cols_a) in per_slot.items():
            enc_.encode_into(ts_a, cols_a, cap, self._now,
                             out=big[slot])
        self._ingest_stats["bytes"] += big.nbytes
        return ("p", (torch.from_numpy(big).to(self.device), enc, cap))

    def _stacked_batch(self, per_slot: dict, cap: int,
                       sid: str) -> EventBatch:
        """(slots, cap) stacked EventBatch from per-slot row chunks.
        Slots without rows are all padding."""
        schema = self.proto.junctions[sid].schema
        N = self.slots
        ts = np.zeros((N, cap), np.int64)
        valid = np.zeros((N, cap), np.bool_)
        kind = np.zeros((N, cap), np.int32)
        cols = [np.zeros((N, cap), np_dtype(t)) for t in schema.types]
        for slot, (t, cs) in per_slot.items():
            n = len(t)
            ts[slot, :n] = t
            valid[slot, :n] = True
            for i, c in enumerate(cs):
                cols[i][slot, :n] = c
        dev = self.device

        def put(x):
            return torch.from_numpy(x).to(dev)
        return EventBatch(
            ts=put(ts), cols=tuple(put(c) for c in cols),
            nulls=tuple(torch.zeros((N, cap), dtype=torch.bool, device=dev)
                        for _ in cols),
            kind=put(kind), valid=put(valid))

    def _body(self, qname: str, label: str) -> Callable:
        """The slotted step for one (query, input label): the same
        operators the separate runtimes step, over every slot at once.
        Signature ``(st, emitted, batch, now) -> (st, out)``; ``emitted``
        ([slots]) is increased in place."""
        key = (qname, label)
        fn = self._bodies.get(key)
        if fn is not None:
            return fn
        kind = self._kind[qname]
        if kind == "agg":
            ar = self._aggs[qname]

            def abody(st, emitted, batch, now):
                st = _aggregation.aggregation_step(ar, st, batch, now)
                # the reference counts the input rows (batch.count())
                emitted += batch.valid.sum(1, dtype=torch.int64)
                return st, None
            self._bodies[key] = abody
            return abody
        q = self.proto.queries[qname]
        rewrite = self._q_out.get(qname) is not None
        sel = _chain_body(q.operators)
        if label == "timer":
            eng = q.engine

            def tbody(st, emitted, batch, now):
                nfa_state, match = _nfa.timer_step(eng, st["nfa"], now)
                sel_states, out = sel(st["sel"], emitted, match, now)
                if rewrite:
                    out = _as_current(out)
                return {"nfa": nfa_state, "sel": sel_states}, out
            fn = tbody
        elif kind == "chain":
            def body(states, emitted, batch, now):
                states, out = sel(states, emitted, batch, now)
                if rewrite:
                    # insert-into kind rewrite, as in the separate runtimes
                    out = _as_current(out)
                return states, out
            fn = body
        elif kind == "pattern":
            eng, sid = q.engine, label[2:]

            def pbody(st, emitted, batch, now):
                if isinstance(eng, ParallelNfaEngine):
                    nfa_state, match = _nfa_par.parallel_step(
                        eng, sid, st["nfa"], batch)
                else:
                    nfa_state, match = _nfa.scan_step(eng, sid, st["nfa"],
                                                      batch)
                sel_states, out = sel(st["sel"], emitted, match, now)
                if rewrite:
                    out = _as_current(out)
                return {"nfa": nfa_state, "sel": sel_states}, out
            fn = pbody
        else:
            side = label
            opp = "R" if side == "L" else "L"
            side_step = _side_chain(q.side_ops[side])
            opp_window = q.side_ops[opp][-1] if q.side_ops[opp] else None
            cross = q.crosses[side]
            # a pool's prototype never sees a columnar send: no gate
            gate_alive = self.proto._columnar
            jschema = combined_schema("#j", q.in_schemas["L"],
                                      q.in_schemas["R"])
            dev = self.device

            def jbody(st, emitted, batch, now):
                sides = st["sides"]
                my, trig = side_step(sides[side], batch, now)
                if cross is not None:
                    opp_buf = opp_window.findable_buffer(sides[opp][-1],
                                                         dev)
                    joined, lost = cross.cross(trig, opp_buf,
                                               gate_alive=gate_alive)
                else:
                    joined = stacked(EventBatch.empty(jschema, 16),
                                     batch.ts.shape[0], dev)
                    lost = torch.zeros((), dtype=torch.int64, device=dev)
                sel_states, out = sel(st["sel"], emitted, joined, now)
                if rewrite:
                    out = _as_current(out)
                return ({"sides": {side: my, opp: sides[opp]},
                         "sel": sel_states, "ovf": st["ovf"] + lost}, out)
            fn = jbody
        self._bodies[key] = fn
        return fn

    def _run_step(self, qname: str, label: str, entry,
                  now_dev) -> Optional[EventBatch]:
        """Advance one query's stacked state over one dispatch entry;
        returns the stacked out batch."""
        if entry[0] == "p":
            buf, enc, cap = entry[1]
            sid = next(s for lab, s in self._q_in[qname] if lab == label)
            types = self.proto.junctions[sid].schema.types
            batch, now = _ingest.unpack_packed(types, enc, cap, buf)
        else:
            batch, now = entry[1], now_dev
        self._states[qname], out = self._body(qname, label)(
            self._states[qname], self._emitted[qname], batch, now)
        self._dispatches += 1
        return out

    def _dispatch(self, stream_inputs: dict, now: int,
                  sample: bool = False) -> tuple[dict, dict]:
        """Run the template's query graph over one stacked round;
        ``stream_inputs`` maps ingest stream -> list of entries
        (``("b", batch)`` / ``("p", (buf, enc, cap))``). Returns
        ({terminal stream id: [stacked out batches]} (device),
        {query: host completion time}). Patterns with absent deadlines
        also run their slotted timer step every dispatch. The completion
        times are only taken when ``sample`` is set: that branch
        synchronises the device after each query."""
        now_dev = torch.tensor(int(now), dtype=torch.int64,
                               device=self.device)
        stream_batches = {sid: list(entries)
                          for sid, entries in stream_inputs.items()}
        terminal: dict = {}
        qtimes: dict = {}
        for qname in self._order:
            outs = []
            for label, sid in self._q_in[qname]:
                for entry in stream_batches.get(sid, ()):
                    out = self._run_step(qname, label, entry, now_dev)
                    if out is not None:
                        outs.append(out)
            if self._kind[qname] == "pattern" and \
                    self.proto.queries[qname].engine.has_absent:
                self._states[qname], out = self._body(qname, "timer")(
                    self._states[qname], self._emitted[qname], None,
                    int(now))
                self._dispatches += 1
                outs.append(out)
            if sample and outs:
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                qtimes[qname] = time.perf_counter()
            tgt = self._q_out[qname]
            if not outs or tgt is None:
                continue
            if tgt in self._terminal:
                terminal.setdefault(tgt, []).extend(outs)
            else:
                stream_batches.setdefault(tgt, []).extend(
                    ("b", o) for o in outs)
        return terminal, qtimes

    # -- delivery ---------------------------------------------------------

    def _deliver(self, terminal: dict) -> None:
        for fn in self.batch_callbacks:
            fn(terminal)   # device batches, no host copy
        if not self._callbacks or not terminal:
            return
        # ONE device-to-host copy for every tenant
        host = {sid: [tree_map(lambda x: x.cpu(), o) for o in outs]
                for sid, outs in terminal.items()}
        with self._lock:
            targets = [(tid, self._tenants[tid], list(cbs))
                       for tid, cbs in self._callbacks.items()
                       if tid in self._tenants]
        for tid, slot, cbs in targets:
            per_sid = []
            for sid, outs in host.items():
                evs = []
                for out in outs:
                    evs.extend(self._decode_slot(sid, out, slot))
                if evs:
                    per_sid.append((sid, evs))
            if not per_sid:
                continue
            self._deliver_tenant(tid, cbs, per_sid)

    def _deliver_tenant(self, tid: str, cbs: list,
                        per_sid: list) -> None:
        """Deliver one tenant's decoded rows through its circuit breaker
        (serving/qos.py): OPEN short-circuits the events without running
        the callback, HALF_OPEN lets exactly one probe delivery through,
        and the outcome feeds the state machine."""
        with self._lock:
            gate = self._qos.breaker_gate(tid)
        if gate == "open":
            for sid, events in per_sid:
                self._short_circuit(tid, sid, events)
            return
        failed = False
        for sid, events in per_sid:
            for cb in cbs:
                try:
                    cb(events)
                except Exception as exc:  # noqa: BLE001 — isolate
                    failed = True
                    self._tenant_error(tid, sid, events, exc)
        with self._lock:
            self._qos.on_delivery(tid, ok=not failed)

    def _short_circuit(self, tid: str, sid: str, events: list) -> None:
        """OPEN-breaker path: the events go to the tenant's error-store
        partition (replayable), and its failing callback never runs."""
        with self._lock:
            self._qos.count_short_circuit(tid, len(events))
            self._error_counts[tid] = \
                self._error_counts.get(tid, 0) + len(events)
        self._store_errors(tid, sid, events,
                           "circuit-open: delivery short-circuited")
        log.warning("pool '%s': tenant '%s' circuit open: %d event(s) on "
                    "stream '%s' short-circuited", self.name, tid,
                    len(events), sid)

    def _store_errors(self, tid: str, sid: str, events: list,
                      cause: str) -> None:
        """One failed delivery into the tenant's error-store partition;
        a failing store is logged and does not stop the delivery of
        other tenants."""
        from ..resilience.errorstore import ErroredEvent
        try:
            self.proto._error_store().store(
                self.tenant_partition(tid),
                ErroredEvent.from_events(sid, events, cause, now=self._now))
        except Exception:  # noqa: BLE001 — isolation must not cascade
            log.exception("pool '%s': error-store write failed for "
                          "tenant '%s'", self.name, tid)

    def _on_breaker_transition(self, tid: str, prev: str,
                               state: str) -> None:
        self.flight.record("breaker-transition", tenant=tid,
                           prev=prev, state=state)
        log.warning("pool '%s': tenant '%s' circuit breaker %s -> %s",
                    self.name, tid, prev, state)

    def _decode_slot(self, sid: str, host_out, slot: int) -> list:
        types = self.proto.junctions[sid].schema.types
        row = EventBatch(
            ts=host_out.ts[slot], cols=tuple(c[slot]
                                             for c in host_out.cols),
            nulls=tuple(nl[slot] for nl in host_out.nulls),
            kind=host_out.kind[slot], valid=host_out.valid[slot])
        return [Event(ts, vals, is_expired=(kind == EXPIRED))
                for ts, kind, vals in rows_from_batch(types, row)]

    def _tenant_error(self, tid: str, sid: str, events: list,
                      exc: Exception) -> None:
        """Sink-failure isolation: the failing tenant's events land in
        its error-store partition; delivery to other tenants continues."""
        with self._lock:
            self._error_counts[tid] = \
                self._error_counts.get(tid, 0) + len(events)
        self._store_errors(tid, sid, events, f"{type(exc).__name__}: {exc}")
        log.warning("pool '%s': tenant '%s' callback failed on stream "
                    "'%s' (%d event(s) -> partition '%s'): %s",
                    self.name, tid, sid, len(events),
                    self.tenant_partition(tid), exc)

    # -- warmup -----------------------------------------------------------

    def warmup(self, caps=None, workers: Optional[int] = None) -> dict:
        """Build the kernels the pool launches (once per process, on a
        CUDA device) before the first tenant's traffic. The port plans
        every step at pool creation and compiles nothing per shape."""
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            _kernels.load()
        return {"kernels": self.device.type == "cuda",
                "warm_ms": round((time.perf_counter() - t0) * 1000.0, 3)}

    # -- background worker (service front door) ---------------------------

    def start(self) -> None:
        """Run the fair-batching drain loop on a daemon thread."""
        with self._lock:
            if self._running:
                return
            self._running = True
        self._worker = threading.Thread(
            target=self._drain_loop, daemon=True,
            name=f"tenantpool-{self.name}")
        self._worker.start()

    def _drain_loop(self) -> None:
        while True:
            with self._lock:
                while self._running and not any(
                        self._pending_rows.get(t, 0)
                        for t in self._tenants):
                    self._work.wait(timeout=0.5)
                if not self._running:
                    return
            try:
                self.pump()
            except Exception:  # noqa: BLE001 — keep serving other rounds
                log.exception("pool '%s': dispatch round failed",
                              self.name)

    def shutdown(self) -> None:
        with self._lock:
            self._running = False
            self._work.notify_all()
        if self._worker is not None:
            self._worker.join(timeout=5)
            self._worker = None

    # -- observability ----------------------------------------------------

    def statistics(self) -> dict:
        """The reference's keys for what is ported: ``pool``,
        ``tenants``, ``packed_ingest``, ``qos``, ``slo`` and, with a
        checkpoint supervisor or after a restore, ``recovery`` (one
        device read for every query's emitted counters)."""
        with self._lock:
            emitted = {qn: e.cpu().numpy()
                       for qn, e in self._emitted.items()}
            tenants = dict(self._tenants)
            pending = dict(self._pending_rows)
            errors = dict(self._error_counts)
            pool_stats = {
                "slots": self.slots, "active": len(tenants),
                "max_tenants": self.max_tenants,
                "batch_max": self.batch_max,
                "rounds": self._rounds, "dispatches": self._dispatches,
                "grows": self._grows,
                "state_bytes_per_tenant": self.state_bytes_per_tenant,
                "state_bytes_by_class":
                    dict(self.state_bytes_by_class),
            }
            ist = self._ingest_stats
            packed_ingest = {
                "enabled": True,
                "transfers_per_round":
                    round(ist["transfers"] / ist["rounds"], 3)
                    if ist["rounds"] else 0.0,
                "rows_packed": ist["rows"],
                "pad_frac":
                    round(1.0 - ist["rows"] / ist["cells"], 4)
                    if ist["cells"] else 0.0,
                "bytes": ist["bytes"],
                "rounds": ist["rounds"],
                "streams": len(self._ingest_streams),
            }
            saturation = self._saturation_locked()
            qos_rep = self._qos.report()
            qos_rep["throttled_429s"] = \
                self._rejections.get("rate-limited", 0)
        report: dict = {"pool": pool_stats, "tenants": {}}
        for tid, slot in tenants.items():
            per_q = {qn: int(emitted[qn][slot]) for qn in self._order}
            entry = {"slot": slot, "emitted": per_q,
                     "pending": pending.get(tid, 0),
                     "errors": errors.get(tid, 0)}
            if tid in qos_rep["tenants"]:
                q = qos_rep["tenants"][tid]
                entry["qos"] = {
                    "weight": q["weight"], "priority": q["priority"],
                    "breaker": q.get("breaker", {}).get("state"),
                }
            report["tenants"][tid] = entry
        report["packed_ingest"] = packed_ingest
        report["slo"] = self.slo_engine.evaluate(saturation=saturation)
        report["qos"] = qos_rep
        recovery = self._recovery_report()
        if recovery is not None:
            report["recovery"] = recovery
        return report

    def _recovery_report(self) -> Optional[dict]:
        """Checkpoint counts and ages (a stale checkpoint widens what a
        crash can lose), and the last restore's revision and replay."""
        sup, rec = self._checkpoint_supervisor, self._recovery
        if sup is None and rec is None:
            return None
        wall = time.time()
        out: dict = {}
        if sup is not None:
            out.update({
                "checkpoints": sup.checkpoints,
                "checkpoint_failures": sup.failures,
                "last_revision": sup.last_revision,
                "checkpoint_age_ms":
                    round((wall - sup.last_checkpoint_wall) * 1000.0, 1)
                    if sup.last_checkpoint_wall else None})
        if rec is not None:
            out.update({
                "restored_revision": rec.get("revision"),
                "restored_tenants": rec.get("tenants"),
                "replayed": rec.get("replayed"),
                "recovery_age_ms":
                    round((wall - rec["restored_wall"]) * 1000.0, 1)})
        return out

    def slo_report(self) -> dict:
        """The SLO/burn-rate view on its own: per-scope latency
        percentiles, attainment, burn rates, states, plus the pool's
        saturation signals."""
        return self.slo_engine.evaluate(saturation=self.saturation())

    # -- checkpoint and recovery ------------------------------------------

    def snapshot_tenant(self, tenant_id: str) -> bytes:
        """One tenant's state: its slot of every query's stacked state
        and emitted counter, serialized with the restricted snapshot
        pickler (core/persistence.py)."""
        from ..core.persistence import dump_strings, serialize
        with self._lock:
            slot = self._slot(tenant_id)
            return serialize({
                "pool": self.name,
                "template": self.template.key,
                "tenant": tenant_id,
                "queries": {qn: {"states": tree_map(lambda x: x[slot],
                                                    self._states[qn]),
                                 "emitted": self._emitted[qn][slot]}
                            for qn in self._order},
                "strings": dump_strings(),
            })

    def restore_tenant(self, tenant_id: str, data: bytes) -> None:
        """Write a ``snapshot_tenant`` back into the tenant's slot; every
        other slot of every state stays as it is, bit for bit."""
        from ..core.persistence import (check_port_payload, deserialize,
                                        load_strings)
        payload = deserialize(data)
        check_port_payload(payload, "pool")
        self._check_template(payload)
        with self._lock:
            slot = self._slot(tenant_id)
            load_strings(payload["strings"])
            for qn in self._order:
                snap = payload["queries"][qn]
                for full, x in zip(leaves(self._states[qn]),
                                   leaves(tree_map(torch.as_tensor,
                                                   snap["states"]))):
                    full[slot] = x.to(full.device)
                self._emitted[qn][slot] = int(snap["emitted"])

    def _check_template(self, payload: dict) -> None:
        if payload.get("template") != self.template.key:
            raise ValueError(
                f"snapshot is for template {payload.get('template')!r}, "
                f"pool '{self.name}' runs {self.template.key!r}")

    def snapshot(self) -> bytes:
        """The whole pool's state: every query's stacked state and
        emitted counters (every slot, free ones too), the slot map, each
        tenant's bindings and QoS dials, the round count and the clock,
        and the string dictionary."""
        from ..core.persistence import serialize
        with self._lock:
            return serialize(self._snapshot_payload())

    def _snapshot_payload(self) -> dict:
        from ..core.persistence import dump_strings
        return {
            "kind": "tenant-pool",
            "pool": self.name,
            "template": self.template.key,
            "shared": dict(self.shared),
            "slots": self.slots,
            "now": self._now,
            "rounds": self._rounds,
            "tenants": {
                tid: {"slot": slot,
                      "bindings": dict(self._bindings.get(tid, {})),
                      "qos": dict(self._tenant_qos_raw.get(tid, {}))}
                for tid, slot in self._tenants.items()},
            "queries": {qn: {"states": self._states[qn],
                             "emitted": self._emitted[qn]}
                        for qn in self._order},
            "strings": dump_strings(),
        }

    def persist(self) -> str:
        """Checkpoint to the manager's persistence store (the filesystem
        store writes a temporary file and renames it); -> the revision
        id."""
        from ..core.persistence import new_revision
        store = self.proto._persistence_store()
        rev = new_revision(self.name)
        store.save(self.name, rev, self.snapshot())
        return rev

    def restore(self, data: bytes) -> None:
        """Write a whole-pool snapshot onto this pool (a fresh one of the
        same template, after a crash): the stacked states as fresh
        tensors on the pool's device at the snapshot's slot count, the
        slot map, bindings and QoS dials; pending rows are dropped and
        circuit breakers restart CLOSED (a still-dead sink trips again
        within ``breaker.failures`` rounds). A reference (siddhi_tpu)
        pool snapshot is refused: convert it with
        ``carry.pool_snapshot_from_jax``."""
        from ..core.persistence import (check_port_payload, deserialize,
                                        load_strings)
        payload = deserialize(data)
        check_port_payload(payload, "pool")
        if payload.get("kind") != "tenant-pool":
            raise ValueError("snapshot is not a tenant-pool snapshot")
        self._check_template(payload)
        if dict(payload.get("shared") or {}) != self.shared:
            raise ValueError(
                "snapshot was taken with different shared structural "
                "bindings — that is a different planned step set")
        with self._lock:
            load_strings(payload["strings"])
            slots = int(payload["slots"])
            if slots > self._slot_cap:
                raise ValueError(
                    f"snapshot has {slots} slots, pool '{self.name}' "
                    f"holds at most {self._slot_cap}")
            if slots != self.slots:
                # the steps build their argument structs and scratch per
                # call; the cached step bodies are rebuilt all the same
                self._bodies.clear()
            self.slots = slots
            dev = self.device
            self._states = {
                qn: tree_map(lambda x: torch.as_tensor(x).to(dev, copy=True),
                             payload["queries"][qn]["states"])
                for qn in self._order}
            self._emitted = {
                qn: torch.as_tensor(payload["queries"][qn]["emitted"],
                                    dtype=torch.int64).to(dev, copy=True)
                for qn in self._order}
            self._now = max(self._now, int(payload.get("now", self._now)))
            self._rounds = int(payload.get("rounds", 0))
            self._tenants = {}
            self._bindings = {}
            self._tenant_qos_raw = {}
            self._pending = {}
            self._pending_rows = {}
            self._error_counts = {}
            q = self._qos
            self._qos = PoolQoS(
                {k: v for k, v in (
                    ("rate_eps", q.default_rate),
                    ("rate_burst", q.default_burst),
                    ("weight", q.default_weight),
                    ("priority", q.default_priority),
                    ("breaker_failures", q.breaker_failures),
                    ("breaker_reset_ms", q.breaker_reset_ms),
                    ("max_defer", q.max_defer)) if v is not None},
                on_transition=self._on_breaker_transition)
            used = set()
            for tid, entry in payload["tenants"].items():
                slot = int(entry["slot"])
                used.add(slot)
                self._tenants[tid] = slot
                self._bindings[tid] = dict(entry.get("bindings") or {})
                self._tenant_qos_raw[tid] = dict(entry.get("qos") or {})
                self._pending[tid] = self._fresh_queues()
                self._pending_rows[tid] = 0
                self._error_counts[tid] = 0
                self._qos.add_tenant(tid, self._tenant_qos_raw[tid])
            self._free = [s for s in range(self.slots - 1, -1, -1)
                          if s not in used]
            self._recovery = {
                "restored_wall": time.time(),
                "revision": None,       # restore_revision fills it
                "tenants": len(self._tenants),
                "replayed": 0,
            }

    def restore_revision(self, revision: str) -> None:
        data = self.proto._persistence_store().load(self.name, revision)
        if data is None:
            raise KeyError(f"no revision '{revision}' for pool "
                           f"'{self.name}'")
        self.restore(data)
        with self._lock:
            self._recovery["revision"] = revision

    def replay_errors(self, tenant_id: Optional[str] = None) -> dict:
        """Drain each tenant's ``<pool>/tenant/<id>`` error partition and
        deliver it again through the tenant's callbacks, in original-
        timestamp order (stable: store order breaks ties; the store
        interleaves rounds out of event-time order). Consecutive rows of
        one stream go as one delivery, through the tenant's circuit
        breaker, so a replay against a still-OPEN breaker lands the
        events back in the partition (at-least-once). A tenant with no
        callback keeps its backlog. -> {tenant: events replayed}."""
        store = self.proto._error_store()
        with self._lock:
            if tenant_id is not None:
                self._slot(tenant_id)
            tids = list(self._tenants) if tenant_id is None \
                else [tenant_id]
            cbs_of = {tid: list(self._callbacks.get(tid, ()))
                      for tid in tids}
        replayed: dict[str, int] = {}
        for tid in tids:
            part = self.tenant_partition(tid)
            records = store.drain(part)
            if not records:
                continue
            if not cbs_of[tid]:
                for rec in records:     # nowhere to deliver: keep
                    store.store(part, rec)
                continue
            entries = []
            for rec in records:
                for e in rec.to_events():
                    entries.append((e.timestamp, len(entries), rec.origin,
                                    e))
            entries.sort(key=lambda t: (t[0], t[1]))
            batch_origin, batch = None, []
            for _ts, _s, origin, e in entries:
                if origin != batch_origin and batch:
                    self._deliver_tenant(tid, cbs_of[tid],
                                         [(batch_origin, batch)])
                    batch = []
                batch_origin = origin
                batch.append(e)
            if batch:
                self._deliver_tenant(tid, cbs_of[tid],
                                     [(batch_origin, batch)])
            replayed[tid] = len(entries)
            log.info("pool '%s': replayed %d event(s) for tenant '%s' "
                     "in original-timestamp order", self.name,
                     len(entries), tid)
        return replayed

    def materialize_tenant(self, tenant_id: str, agg_id: str,
                           duration: str, start: Optional[int] = None,
                           end: Optional[int] = None):
        """One tenant's `within/per` view of a pooled incremental
        aggregation: the tenant's slot of one duration's bucket table,
        copied to the host, through the aggregation runtime's own
        projection (core/aggregation.py materialize_from) — equal to a
        separate runtime fed the same rows. -> (schema, buffer dict)."""
        with self._lock:
            ar = self._aggs.get(agg_id)
            if ar is None:
                raise KeyError(
                    f"no aggregation '{agg_id}' in pool '{self.name}' "
                    f"(aggregations: {sorted(self._aggs)})")
            slot = self._slot(tenant_id)
            d = ar.duration_key(duration)
            di = ar.durations.index(d)
            host = tree_map(lambda x: x[slot, di].cpu(),
                            self._states[agg_id])
        return ar.materialize_from(host, d, start, end)

    def request_migration(self, tenant_id: str, device: int, **kw):
        raise _not_ported("slot migration")

    def migrate_tenant(self, tenant_id: str, device: int, **kw):
        raise _not_ported("slot migration")

    def migration_log(self) -> list:
        raise _not_ported("slot migration")

    def mark_device_lost(self, device: int) -> dict:
        raise _not_ported("mark_device_lost (device evacuation)")

    def plan_hash(self) -> str:
        raise _not_ported("plan_hash")

    def explain(self, live: bool = True) -> dict:
        raise _not_ported("pool explain")

    def audit_programs(self, caps=None, **kw) -> dict:
        raise _not_ported("audit_programs")
