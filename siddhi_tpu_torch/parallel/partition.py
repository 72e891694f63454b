"""Partitioned query execution: ``partition with (attr of S) begin ...
end`` (PyTorch port of siddhi_tpu/parallel/partition.py).

Reference mapping:
- PartitionRuntimeImpl (partition/PartitionRuntimeImpl.java:75) — one
  runtime per partition block                      -> PartitionBlockRuntime
- PartitionStreamReceiver (partition/PartitionStreamReceiver.java:82-146)
  — computes the key per event and routes it to a lazily-created per-key
  clone of every inner query                        -> the key->slot table
  and the slot axis of the block's kernels
- ValuePartitionExecutor / RangePartitionExecutor
  (partition/executor/*.java)                       -> one K2 program of
  the key (or of the range conditions) over the whole batch
- PartitionStateHolder (util/snapshot/state/PartitionStateHolder.java:33)
  — per-key State maps                              -> operator states with
  a leading [K] slot axis

A step of the block, for one triggering batch:
  1. K2 evaluates the partition key (or every range condition) of each
     row; kernel K9p's route hashes the key and claims a slot in the
     block's bounded first-seen table (ops/keyed.py lookup_or_insert: 16
     probes, overflow counted), or picks the first range label that
     holds, and writes each slot's valid mask ``[K, B]``: slot k sees the
     batch masked to its own rows plus the TIMER rows (the reference's
     ``jax.vmap`` over the slots sees exactly that);
  2. each inner query runs its operator chain once over every slot: K2
     over the K * B rows, K5, K6, K4 and G with the slot axis as one more
     launch dimension (ops/slots.py; G[K] one block a slot), stream
     functions as outside a block; an inner stream's (``#S``) rows
     become CURRENT and reach their consumers in the same step,
     concatenated per slot in the order of the producers' plans;
  3. K9p's compaction turns each outer query's ``[K, N]`` output into
     ``min(K * N, 65536)`` rows in the order of a stable sort by
     timestamp (invalid rows keyed 2**62), i.e. (ts, slot, row), and
     adds the rows it keeps and drops to the query's ``emitted`` and
     ``lost`` counters on the device;
  4. K9p's due takes the minimum of the slots' timer dues per query; one
     device-to-host read brings every query's due to the scheduler;
  5. a query with an output rate limiter hands its decoded rows to the
     limiter on its port, as the reference's ``_dispatch`` does.

Work shape: as in the reference, every slot runs over the whole masked
batch, so an operator does K * B rows of work a step.

Bounded-state contract: at most K distinct keys are live; rows whose key
cannot claim a slot are dropped AND counted (``overflow``). Output
compaction beyond its capacity is likewise counted (``lost``).

Ordering note: outputs are sorted by timestamp; rows with equal
timestamps order by (slot, emission) rather than strict arrival
interleaving across keys (Siddhi interleaves per arrival). Within one
key the order is exact.
"""
from __future__ import annotations

import threading
from typing import Callable, Optional

import torch

from .. import _kernels
from ..core.event import TIMER, EventBatch, StreamSchema, rows_from_batch
from ..core.runtime import (PARTITION_SORT_HEAVY_CAP, QueryCallbackHandler,
                            QueryRuntime, _as_current, _chain_body,
                            _timer_batch, _tree_to, split_batch)
from ..core.stream import Event, Receiver
from ..core.types import AttrType, row_bytes
from ..obs.tracing import maybe_span
from ..ops.expr import VT, ProgramBuilder, expr_eval
from ..ops.keyed import hash_columns, lookup_or_insert
from ..ops.sentinels import NO_SLOT, POS_INF
from ..ops.slots import stacked
from ..ops.windows import WindowOp

# combined-output compaction bound: several key slots can emit in the same
# step (e.g. a timer flushing every slot's timeBatch window), so the cap
# scales with K instead of a single slot's capacity; beyond it rows are
# dropped AND counted in `lost`
OUT_COMPACT_CAP = 65536

I64 = torch.int64


class KeySpec:
    """How one partitioned stream's rows find their slot: ``kind``
    "value" (one key expression) or "range" (conditions, each with its
    label's slot), compiled into one K2 program whose outputs K9p's route
    reads."""

    def __init__(self, kind: str, exprs: list, label_slots=()):
        self.kind = kind
        self.label_slots = tuple(label_slots)
        b = ProgramBuilder()
        for ce in exprs:
            b.out(ce)
        self.program = b.build()
        self.key_type = exprs[0].type if kind == "value" else AttrType.BOOL


class BlockQueryPlan:
    """One query inside a partition block, compiled to an operator chain."""

    is_pattern = False

    def __init__(self, name: str, input_id: str, in_schema: StreamSchema,
                 operators: list, target: str, inner_target: bool,
                 out_type: str):
        self.name = name
        self.input_id = input_id          # '#I' for inner streams
        self.in_schema = in_schema
        self.operators = operators
        self.target = target              # '#I' when inner_target
        self.inner_target = inner_target
        self.out_type = out_type

    @property
    def out_schema(self) -> StreamSchema:
        return self.operators[-1].out_schema

    def init_state(self):
        return tuple(op.init_state() for op in self.operators)

    def has_timers(self) -> bool:
        return any(isinstance(op, WindowOp) and
                   op.next_due(op.init_state()) is not None
                   for op in self.operators)


class BlockPatternPlan:
    """A pattern/sequence query inside a partition block: the scan
    engine's pending table gains a leading [K] slot axis — each key
    instance owns an independent pending table (the reference clones
    whole query runtimes per key: PartitionRuntimeImpl.java:75,
    PartitionStreamReceiver.java:82-146)."""

    is_pattern = True

    def __init__(self, name: str, engine, sel_ops: list,
                 input_ids: set, in_schema: StreamSchema, target: str,
                 inner_target: bool, out_type: str):
        self.name = name
        self.engine = engine
        self.sel_ops = sel_ops
        self.input_ids = input_ids        # outer stream ids consumed
        self.input_id = next(iter(sorted(input_ids)))
        self.in_schema = in_schema
        self.operators = sel_ops          # for sort-heavy/overflow scans
        self.target = target
        self.inner_target = inner_target
        self.out_type = out_type

    @property
    def out_schema(self) -> StreamSchema:
        return self.sel_ops[-1].out_schema if self.sel_ops \
            else self.engine.match_schema

    def init_state(self):
        return (self.engine.init_state(),
                tuple(op.init_state() for op in self.sel_ops))

    def has_timers(self) -> bool:
        return self.engine.has_absent


class PartitionQueryPort:
    """Output surface of one partitioned query: handlers + callbacks
    (what ``app.queries[name]`` exposes for queries inside a partition)."""

    def __init__(self, block: "PartitionBlockRuntime", name: str,
                 out_schema: StreamSchema):
        self.block = block
        self.name = name
        self.out_schema = out_schema
        self.output_handlers: list = []
        self.callback_handler = QueryCallbackHandler()
        self.batch_callbacks: list[Callable] = []
        self.rate_limiter = None

    def set_rate_limiter(self, rl) -> None:
        """An output rate limiter on the query's rows (the reference's
        PartitionQueryPort.set_rate_limiter): handlers and callbacks see
        what it emits; ``batch_callbacks`` stay a tap before it."""
        rl.emit = self._emit_limited
        rl.start(self.block.app)
        self.rate_limiter = rl

    def _emit_limited(self, timestamp: int, rows) -> None:
        for h in self.output_handlers:
            h.handle(timestamp, rows)
        self.callback_handler.handle(timestamp, rows)

    def stats(self) -> dict:
        with self.block._lock:
            emitted = int(self.block._emitted[self.name].item())
        return {"emitted": emitted,
                "overflow": self.block.overflow_total()}

    def overflow_total(self) -> int:
        return self.block.overflow_total()


class BlockStreamReceiver(Receiver):
    """Junction subscriber feeding one outer stream into the block
    (= PartitionStreamReceiver)."""

    supports_packed = False

    def __init__(self, block: "PartitionBlockRuntime", stream_id: str):
        self.block = block
        self.stream_id = stream_id

    @property
    def max_step_capacity(self):
        return self.block.max_step_capacity

    def receive(self, events):
        self.block.process_stream_events(self.stream_id, events)

    def process_batch(self, batch, last_ts):
        self.block.process_stream_batch(self.stream_id, batch, last_ts)


def _tree_overflow_sum(tree) -> int:
    """Sum every 'overflow' entry of a state pytree (over its slots)."""
    total = 0
    if isinstance(tree, dict):
        for k, v in tree.items():
            if k == "overflow":
                total += int(torch.as_tensor(v).sum().item())
            else:
                total += _tree_overflow_sum(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            total += _tree_overflow_sum(v)
    return total


# ---------------------------------------------------------------------------
# kernel K9p (csrc/partition.cu) and its plain versions
# ---------------------------------------------------------------------------


def route_ref(spec: KeySpec, cols, nulls, batch: EventBatch, slot_tbl: dict,
              K: int):
    """Plain version of K9p's route (the reference's ``_slots_for`` and
    the slot masks of its vmap): -> (slots [B] int32, each slot's valid
    mask [K, B], slot_tbl'). ``cols``/``nulls``: the key program's
    outputs."""
    dev = batch.ts.device
    B = batch.ts.shape[0]
    is_timer = batch.kind == TIMER
    if spec.kind == "value":
        codes = hash_columns([cols[0]], [nulls[0]])
        active = batch.valid & ~is_timer
        slots, keys, used, ovf = lookup_or_insert(
            slot_tbl["keys"], slot_tbl["used"], codes, active)
        slot_tbl = {"keys": keys, "used": used,
                    "overflow": slot_tbl["overflow"] + ovf}
    else:
        # range partition: the first range whose condition holds (labels
        # shared across streams identify the instance); rows matching no
        # range are dropped (RangePartitionExecutor returns null -> no
        # instance)
        slots = torch.full((B,), int(NO_SLOT), dtype=torch.int32,
                           device=dev)
        for v, n, si in zip(cols, nulls, spec.label_slots):
            hit = v & ~n & (slots == int(NO_SLOT))
            slots = torch.where(hit, torch.full_like(slots, si), slots)
    ks = torch.arange(K, dtype=torch.int32, device=dev)[:, None]
    valid_k = batch.valid[None, :] & ((slots[None, :] == ks) |
                                      is_timer[None, :])
    return slots, valid_k, slot_tbl


def route(spec: KeySpec, batch: EventBatch, now, slot_tbl: dict, K: int):
    """K2 (the key or range program), then kernel K9p's route: -> (slots
    [B], each slot's valid mask [K, B], slot_tbl'). A CPU batch takes the
    plain version; a CUDA batch launches csrc/partition.cu."""
    cols, nulls, _valid = expr_eval(spec.program, batch, now=now)
    dev = batch.ts.device
    if dev.type == "cpu":
        return route_ref(spec, cols, nulls, batch, slot_tbl, K)
    if dev.type != "cuda":
        raise ValueError(f"partition_route: unsupported device {dev}")
    slots, valid_k, new, a = route_args(spec, cols, nulls, batch, slot_tbl,
                                        K)
    _kernels.load().partition_route(
        a, torch.cuda.current_stream(dev).cuda_stream)
    _kernels.count_launch("partition_route")
    return slots, valid_k, new


def route_args(spec: KeySpec, cols, nulls, batch: EventBatch, slot_tbl: dict,
               K: int):
    """K9p's route arguments: fresh tensors for the slots, the masks and
    the new table, the scratch, and ``_kernels.RouteArgs``. -> (slots,
    valid_k, slot_tbl', args)."""
    dev = batch.ts.device
    B = batch.ts.shape[0]
    a = _kernels.RouteArgs()
    a.B, a.K = B, K
    a.mode = 0 if spec.kind == "value" else 1
    a.kind, a.valid = batch.kind.data_ptr(), batch.valid.data_ptr()
    if spec.kind == "value":
        a.key_col, a.key_null = cols[0].data_ptr(), nulls[0].data_ptr()
        a.key_type = VT[spec.key_type]
    else:
        a.n_conds = len(cols)
        for i, (v, n, si) in enumerate(zip(cols, nulls, spec.label_slots)):
            a.cond_vals[i], a.cond_nulls[i] = v.data_ptr(), n.data_ptr()
            a.cond_slot[i] = si
    new = {"keys": torch.empty_like(slot_tbl["keys"]),
           "used": torch.empty_like(slot_tbl["used"]),
           "overflow": torch.empty_like(slot_tbl["overflow"])}
    a.keys, a.used = slot_tbl["keys"].data_ptr(), slot_tbl["used"].data_ptr()
    a.overflow = slot_tbl["overflow"].data_ptr()
    a.new_keys, a.new_used = new["keys"].data_ptr(), new["used"].data_ptr()
    a.new_overflow = new["overflow"].data_ptr()
    slots = torch.empty((B,), dtype=torch.int32, device=dev)
    valid_k = torch.empty((K, B), dtype=torch.bool, device=dev)
    a.slots, a.valid_k = slots.data_ptr(), valid_k.data_ptr()
    sc = {"hk": torch.empty((B,), dtype=I64, device=dev),
          "active": torch.empty((B,), dtype=torch.uint8, device=dev),
          "prb": torch.empty((B,), dtype=torch.int32, device=dev),
          "flags": torch.empty((B,), dtype=torch.uint8, device=dev),
          "claim": torch.empty((K,), dtype=torch.int32, device=dev)}
    for k, t in sc.items():
        setattr(a, k, t.data_ptr())
    a._keep = (batch, cols, nulls, slot_tbl, sc)   # alive until the launch
    return slots, valid_k, new, a


def compact_ref(out: EventBatch, out_cap: int, emitted, lost):
    """Plain version of K9p's compaction (the reference's
    ``_flatten_compact``): [K, N] per-slot outputs -> one [out_cap] batch,
    a stable sort by ts with invalid rows keyed 2**62, so equal
    timestamps keep (slot, row) order. ``emitted`` and ``lost`` (int64
    0-d) are increased by the rows kept and the valid rows dropped."""
    def fl(x):
        return x.reshape((-1,) + tuple(x.shape[2:]))

    valid = fl(out.valid)
    ts = fl(out.ts)
    key = torch.where(valid, ts, torch.full_like(ts, 2 ** 62))
    order = torch.argsort(key, stable=True)[:out_cap]
    picked = EventBatch(ts=ts[order],
                        cols=tuple(fl(c)[order] for c in out.cols),
                        nulls=tuple(fl(n)[order] for n in out.nulls),
                        kind=fl(out.kind)[order], valid=valid[order])
    kept = picked.valid.sum(dtype=I64)
    emitted += kept
    lost += valid.sum(dtype=I64) - kept
    return picked


def compact(out: EventBatch, out_cap: int, emitted, lost) -> EventBatch:
    """Kernel K9p's compaction, or its plain version for a CPU batch."""
    dev = out.ts.device
    if dev.type == "cpu":
        return compact_ref(out, out_cap, emitted, lost)
    if dev.type != "cuda":
        raise ValueError(f"partition_compact: unsupported device {dev}")
    picked, a = compact_args(out, out_cap, emitted, lost)
    _kernels.load().partition_compact(
        a, torch.cuda.current_stream(dev).cuda_stream)
    _kernels.count_launch("partition_compact")
    return picked


def compact_args(out: EventBatch, out_cap: int, emitted, lost):
    """K9p's compaction arguments: the output batch (fresh), the sort's
    scratch and ``_kernels.CompactArgs``. -> (output batch, args)."""
    dev = out.ts.device
    n = out.ts.numel()
    C = len(out.cols)
    # an output column may be the batch's, shared by the slots: the
    # kernel reads K * N rows
    out = EventBatch(*(tuple(x.contiguous() for x in v)
                       if isinstance(v, tuple) else v.contiguous()
                       for v in (out.ts, out.cols, out.nulls, out.kind,
                                 out.valid)))
    for x in (out.ts, out.kind, out.valid) + out.cols + out.nulls:
        if x.device != dev:
            raise ValueError("partition_compact: every output column must "
                             f"be a [K, N] tensor on {dev}")
    if C > _kernels.PART_MAX_COLS:
        raise NotImplementedError(
            f"not ported yet: a partitioned query output of more than "
            f"{_kernels.PART_MAX_COLS} attributes ({C})")
    a = _kernels.CompactArgs()
    a.n, a.out_cap, a.n_cols = n, out_cap, C

    def e(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)
    picked = EventBatch(
        ts=e((out_cap,), I64),
        cols=tuple(e((out_cap,) + tuple(c.shape[2:]), c.dtype)
                   for c in out.cols),
        nulls=tuple(e((out_cap,), torch.bool) for _ in out.cols),
        kind=e((out_cap,), torch.int32), valid=e((out_cap,), torch.bool))
    a.ts, a.kind, a.valid = (out.ts.data_ptr(), out.kind.data_ptr(),
                             out.valid.data_ptr())
    a.out_ts, a.out_kind, a.out_valid = (picked.ts.data_ptr(),
                                         picked.kind.data_ptr(),
                                         picked.valid.data_ptr())
    for k, (c, nl, pc, pn) in enumerate(zip(out.cols, out.nulls,
                                            picked.cols, picked.nulls)):
        a.cols[k], a.nulls[k] = c.data_ptr(), nl.data_ptr()
        a.out_cols[k], a.out_nulls[k] = pc.data_ptr(), pn.data_ptr()
        a.col_size[k] = row_bytes(c[0])   # [K, N] columns
    a.emitted, a.lost = emitted.data_ptr(), lost.data_ptr()
    blocks = (n + 1023) // 1024
    sc = {"vpref": e((n,), I64), "sums": e((blocks,), I64),
          "k0": e((n,), I64), "k1": e((n,), I64), "k2": e((n,), I64),
          "i0": e((n,), torch.int32), "i1": e((n,), torch.int32),
          "i2": e((n,), torch.int32), "inv_idx": e((out_cap,), torch.int32),
          "counts": e((256 * blocks,), torch.int32)}
    for k, t in sc.items():
        setattr(a, k, t.data_ptr())
    a._keep = (out, sc, emitted, lost)   # alive until the launch
    return picked, a


def min_due_ref(dues: list):
    """Plain version of K9p's due: each query's minimum over its slots'
    dues -> an int64 [Q] tensor."""
    return torch.stack([d.reshape(-1).min() for d in dues])


def min_due(dues: list):
    """Kernel K9p's due (the reference's ``jnp.min`` of each query's
    vmapped dues), or its plain version for CPU tensors."""
    dev = dues[0].device
    if dev.type == "cpu":
        return min_due_ref(dues)
    if dev.type != "cuda":
        raise ValueError(f"partition_due: unsupported device {dev}")
    if len(dues) > _kernels.PART_MAX_QUERIES:
        raise NotImplementedError(
            f"not ported yet: more than {_kernels.PART_MAX_QUERIES} timed "
            "queries in one partition")
    out, a = due_args(dues)
    _kernels.load().partition_due(a,
                                  torch.cuda.current_stream(dev).cuda_stream)
    _kernels.count_launch("partition_due")
    return out


def due_args(dues: list):
    """K9p's due arguments: the [Q] output (fresh) and
    ``_kernels.DueArgs``. -> (output, args)."""
    flat = [d.reshape(-1).contiguous() for d in dues]
    out = torch.empty((len(dues),), dtype=I64, device=flat[0].device)
    a = _kernels.DueArgs()
    a.n_q = len(flat)
    for q, d in enumerate(flat):
        a.dues[q], a.n[q] = d.data_ptr(), d.numel()
    a.out = out.data_ptr()
    a._keep = flat   # alive until the launch
    return out, a


def slot_batch(batch: EventBatch, valid_k) -> EventBatch:
    """The batch as each slot sees it: the columns shared by the K slots
    (views of slot stride 0, no copy), ``valid_k`` [K, B] the
    validity."""
    K = valid_k.shape[0]

    def rep(x):
        return x.unsqueeze(0).expand((K,) + tuple(x.shape))
    return EventBatch(rep(batch.ts), tuple(rep(c) for c in batch.cols),
                      tuple(rep(n) for n in batch.nulls), rep(batch.kind),
                      valid_k)


def _cat_rows(a: EventBatch, b: EventBatch) -> EventBatch:
    """Two slotted batches' rows, slot by slot."""
    def c(x, y):
        return torch.cat([x, y], dim=1)
    return EventBatch(c(a.ts, b.ts),
                      tuple(c(x, y) for x, y in zip(a.cols, b.cols)),
                      tuple(c(x, y) for x, y in zip(a.nulls, b.nulls)),
                      c(a.kind, b.kind), c(a.valid, b.valid))


class PartitionBlockRuntime:
    """All queries of one ``partition ... begin ... end`` block, executed
    as one step over every key slot per triggering input."""

    def __init__(self, app, name: str, n_slots: int,
                 key_specs: dict, plans: list):
        self.app = app
        self.name = name
        self.K = int(n_slots)
        # key_specs: stream_id -> KeySpec
        self.key_specs = key_specs
        self.plans = plans
        dev = app.device
        K = self.K
        self.slot_tbl = {
            "keys": torch.zeros((K,), dtype=I64, device=dev),
            "used": torch.zeros((K,), dtype=torch.bool, device=dev),
            "overflow": torch.zeros((), dtype=I64, device=dev),
        }
        self.qstates = {p.name: stacked(p.init_state(), K, dev)
                        for p in plans}
        self._emitted = {p.name: torch.zeros((), dtype=I64, device=dev)
                         for p in plans}
        self._lost = {p.name: torch.zeros((), dtype=I64, device=dev)
                      for p in plans}
        self.ports = {p.name: PartitionQueryPort(self, p.name, p.out_schema)
                      for p in plans}
        # each query's operator chain (core/runtime.py _chain_body); the
        # chains' own emitted counter is unused: a block counts the rows
        # its compaction keeps
        self._chains = {p.name: _chain_body(p.operators) for p in plans}
        self._chain_emitted = torch.zeros((), dtype=I64, device=dev)
        self._lock = threading.Lock()
        self._sched_due: dict[str, Optional[int]] = {p.name: None
                                                     for p in plans}
        self._has_timers = {p.name: p.has_timers() for p in plans}
        # the slot axis multiplies every per-step sort by K: cap harder
        # (see runtime.py SORT_HEAVY_CAP)
        self.max_step_capacity = PARTITION_SORT_HEAVY_CAP if any(
            getattr(op, "sort_heavy", False)
            for p in plans for op in p.operators) else None

    # -- the step ---------------------------------------------------------
    def _step(self, trigger: tuple, batch: EventBatch, now):
        """One step of the block (the caller holds the lock): -> (each
        outer query's compacted output, each timed query's due as one
        [Q] tensor and the query names, in that order)."""
        from ..ops.nfa import scan_step, timer_step
        kind, tid = trigger
        K = self.K
        if kind == "stream":
            _slots, valid_k, self.slot_tbl = route(
                self.key_specs[tid], batch, now, self.slot_tbl, K)
        else:   # a TIMER trigger: every slot observes it
            valid_k = batch.valid.unsqueeze(0).expand(
                (K,) + tuple(batch.valid.shape)).contiguous()
        bk = slot_batch(batch, valid_k)
        inner: dict = {}
        outs: dict = {}
        dues: dict = {}
        for p in self.plans:
            chain = self._chains[p.name]
            if p.is_pattern:
                if kind == "stream" and tid in p.input_ids:
                    nfa_state, sel_states = self.qstates[p.name]
                    nfa_state, b = scan_step(p.engine, tid, nfa_state, bk)
                elif kind == "timer" and p.name == tid:
                    nfa_state, sel_states = self.qstates[p.name]
                    nfa_state, b = timer_step(p.engine, nfa_state, now)
                else:
                    continue
                sel_states, b = chain(sel_states, self._chain_emitted, b,
                                      now)
                self.qstates[p.name] = (nfa_state, sel_states)
                if p.engine.has_absent:
                    dues[p.name] = p.engine.next_due(nfa_state)
                # as in the reference, a pattern's rows go to its port
                outs[p.name] = b
                continue
            if kind == "timer" and p.name == tid:
                b = bk
            elif kind == "stream" and p.input_id == tid:
                b = bk
            elif p.input_id in inner:
                b = inner[p.input_id]
            else:
                continue
            sts, b = chain(self.qstates[p.name], self._chain_emitted, b,
                           now)
            self.qstates[p.name] = sts
            ds = [op.next_due(s) for op, s in zip(p.operators, sts)
                  if isinstance(op, WindowOp)]
            ds = [d for d in ds if d is not None]
            if ds:
                due = ds[0]
                for d in ds[1:]:
                    due = torch.minimum(due, d)
                dues[p.name] = due
            if p.inner_target:
                cur = _as_current(b)
                inner[p.target] = _cat_rows(inner[p.target], cur) \
                    if p.target in inner else cur
            else:
                outs[p.name] = b
        flat_outs = {}
        for qn, ob in outs.items():
            out_cap = min(K * ob.ts.shape[1], OUT_COMPACT_CAP)
            flat_outs[qn] = compact(ob, out_cap, self._emitted[qn],
                                    self._lost[qn])
        names = list(dues)
        due_vec = min_due([dues[q] for q in names]) if names else None
        return flat_outs, names, due_vec

    # -- runtime ----------------------------------------------------------
    def process_stream_events(self, stream_id: str, events: list[Event]):
        schema = self.app.schemas[stream_id]
        for batch, last_ts in QueryRuntime.encode_chunks(
                schema, events, self.app.device, self.max_step_capacity):
            self.process_stream_batch(stream_id, batch, last_ts)

    def process_stream_batch(self, stream_id: str, batch: EventBatch,
                             timestamp: int, now: Optional[int] = None):
        cap = self.max_step_capacity
        if cap is not None and batch.capacity > cap:
            for sub in split_batch(batch, cap):
                self._run(("stream", stream_id), sub, timestamp, now)
            return
        self._run(("stream", stream_id), batch, timestamp, now)

    def _run(self, trigger, batch, timestamp, now=None):
        with maybe_span(self.app, "partition", self.name,
                        trigger=str(trigger)):
            if now is None:
                now = self.app.current_time()
            with self._lock:
                flat_outs, names, due_vec = self._step(trigger, batch,
                                                       int(now))
            for qn, out in flat_outs.items():
                self._dispatch(qn, out, timestamp)
            if names:
                # one device-to-host read for every query's due
                for qn, due in zip(names, due_vec.tolist()):
                    self._schedule(qn, int(due))

    def _dispatch(self, qname: str, out: EventBatch, timestamp: int):
        port = self.ports[qname]
        for cb in port.batch_callbacks:
            cb(out)
        if port.rate_limiter is not None:
            # every row through the limiter on the host; a STRING
            # order-by's host edge is not applied in a block, as in the
            # reference
            rows = rows_from_batch(port.out_schema.types, out)
            if rows:
                port.rate_limiter.process(timestamp, rows)
            return
        row_handlers = [h for h in port.output_handlers
                        if not h.handle_device_batch(out, timestamp)]
        if not (row_handlers or port.callback_handler.callbacks):
            return
        rows = rows_from_batch(port.out_schema.types, out)
        if not rows:
            return
        for h in row_handlers:
            h.handle(timestamp, rows)
        port.callback_handler.handle(timestamp, rows)

    # -- timers -----------------------------------------------------------
    def _schedule(self, qname: str, due: int):
        if due >= int(POS_INF):
            return
        cur = self._sched_due.get(qname)
        if cur is not None and cur <= due:
            return
        self._sched_due[qname] = due
        self.app.scheduler.notify_at(due, lambda d, q=qname:
                                     self._on_timer(q, d))

    def _on_timer(self, qname: str, due: int):
        self._sched_due[qname] = None
        if not self.app.running:
            return
        plan = next(p for p in self.plans if p.name == qname)
        now = max(due, self.app.current_time())
        # TIMER rows carry the advanced clock (see QueryRuntime._on_timer)
        batch = _timer_batch(plan.in_schema, now, self.app.device)
        self._run(("timer", qname), batch, due, now=now)

    # -- snapshot ---------------------------------------------------------
    def snapshot_state(self) -> dict:
        """The block's device state on the host, and each rate-limited
        query's limiter state under ``"rate"`` (host rows and times)."""
        with self._lock:
            snap = _tree_to({"slot_tbl": self.slot_tbl,
                             "qstates": self.qstates,
                             "emitted": self._emitted,
                             "lost": self._lost}, "cpu")
            snap["rate"] = {qn: p.rate_limiter.snapshot_state()
                            for qn, p in self.ports.items()
                            if p.rate_limiter is not None}
            return snap

    def restore_state(self, snap: dict) -> None:
        """Restore from ``snapshot_state()`` output (or from a reference
        block's state carried over by carry.block_from_jax)."""
        dev = self.app.device
        with self._lock:
            self.slot_tbl = _tree_to(snap["slot_tbl"], dev)
            self.qstates = _tree_to(snap["qstates"], dev)
            self._emitted = _tree_to(snap["emitted"], dev)
            self._lost = _tree_to(snap["lost"], dev)
            for qn in self._sched_due:
                self._sched_due[qn] = None
            for qn, rsnap in snap.get("rate", {}).items():
                port = self.ports.get(qn)
                if port is not None and port.rate_limiter is not None:
                    port.rate_limiter.restore_state(rsnap)

    def reschedule(self) -> None:
        """Re-arm per-query timers from restored [K]-stacked states: the
        windows' dues and an absent pattern's deadlines (the reference
        re-arms only the windows')."""
        per_plan: dict[str, list] = {}
        for p in self.plans:
            if not self._has_timers[p.name]:
                continue
            with self._lock:  # restore rebinds the stacked states
                qstates = self.qstates[p.name]
            if p.is_pattern:
                if p.engine.has_absent:
                    per_plan.setdefault(p.name, []).append(
                        p.engine.next_due(qstates[0]))
                continue
            for op, st in zip(p.operators, qstates):
                if isinstance(op, WindowOp):
                    d = op.next_due(st)
                    if d is not None:
                        per_plan.setdefault(p.name, []).append(d)
        if per_plan:
            names = list(per_plan)
            dues = [torch.stack([d.reshape(-1).min() for d in per_plan[q]])
                    for q in names]
            for qn, due in zip(names, min_due(dues).tolist()):
                self._schedule(qn, int(due))

    # -- introspection ----------------------------------------------------
    def overflow_total(self) -> int:
        with self._lock:  # vs restore/process rebinding mid-read
            tbl, qstates, losts = self.slot_tbl, self.qstates, self._lost
            total = int(tbl["overflow"].item())
            total += _tree_overflow_sum(qstates)
            total += sum(int(v.item()) for v in losts.values())
        return total

    def stats(self) -> dict:
        with self._lock:  # vs the step path rebinding counters
            emitted = {qn: int(v.item()) for qn, v in self._emitted.items()}
        return {"emitted": emitted, "overflow": self.overflow_total()}
