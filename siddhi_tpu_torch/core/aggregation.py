"""Incremental aggregation: ``define aggregation A from S select ...
group by ... aggregate by ts every sec ... year`` (PyTorch port of
siddhi_tpu/core/aggregation.py).

Reference mapping:
- AggregationRuntime (aggregation/AggregationRuntime.java:81)
- incremental decomposition avg -> sum and count
  (query/selector/attribute/aggregator/incremental/*.java)
- parser util/parser/AggregationParser.java:93
- query side IncrementalAggregateCompileCondition (within ... per ...)

Every duration aggregates each batch directly into a bounded keyed table
whose key is hash(bucket start, group values): the reference's design,
with no cascade from one duration into the next, so an out-of-order
event lands in its own bucket. Month and year buckets use the civil
calendar (days-from-civil integer arithmetic).

The step is kernel K11 (csrc/aggregation_step.cu, ``aggregation_step``):
every duration at once, the state stacked as [D, K] tensors (one row a
duration; ``states`` gives the reference's per-duration dicts as views).
A CPU batch takes its plain version, ``aggregation_step_ref``. Group-by
and argument expressions that are not bare columns run in one kernel K2
program first.

The query side (``from A within <start>, <end> per '<duration>' select
...``) materialises a duration's table as rows of (group attributes,
the defined aggregate outputs, AGG_TIMESTAMP) on the host, and the
on-demand executor (core/ondemand.py) selects over them.
"""
from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from .. import _kernels
from ..lang import ast as A
from ..ops.aggregators import _bare_column, _widen
from ..ops.expr import (DTYPE_VT, CompileError, ProgramBuilder,
                        SingleStreamScope, compile_expression, expr_eval)
from ..ops.keyed import (add, hash_columns, lookup_or_insert, maximum,
                         minimum, segment_starts)
from ..ops.selector import output_attribute_name
from .event import CURRENT, Attribute, EventBatch, StreamSchema
from .stream import Receiver
from .types import AttrType, torch_dtype

I64, F64 = torch.int64, torch.float64

DURATIONS = ("seconds", "minutes", "hours", "days", "months", "years")

_FIXED_MS = {"seconds": 1000, "minutes": 60_000, "hours": 3_600_000,
             "days": 86_400_000}

_AGG_LANES = {
    # name -> lane kinds; 'ncount' counts NON-NULL argument values so
    # all-null buckets materialize as null (Siddhi aggregator semantics)
    "sum": ("sum", "ncount"),
    "count": ("count",),
    "avg": ("sum", "ncount"),
    "min": ("min", "ncount"),
    "max": ("max", "ncount"),
}
# lane kinds, numbered as csrc/siddhi_kernels.h AggrLane
_LANE_KINDS = {"count": 0, "ncount": 1, "sum": 2, "min": 3, "max": 4}


def _fdiv(a, b):
    """jnp's ``//`` on int64: rounding toward negative infinity."""
    return torch.div(a, b, rounding_mode="floor")


def _civil_from_days(z):
    """Days since 1970-01-01 -> (year, month): the reference's Hinnant
    civil algorithm, term by term, floor division throughout."""
    z = z + 719468
    era = _fdiv(torch.where(z >= 0, z, z - 146096), 146097)
    doe = z - era * 146097
    yoe = _fdiv(doe - _fdiv(doe, 1460) + _fdiv(doe, 36524)
                - _fdiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100))
    mp = _fdiv(5 * doy + 2, 153)
    m = torch.where(mp < 10, mp + 3, mp - 9)
    y = torch.where(m <= 2, y + 1, y)
    return y, m


def _days_from_civil(y, m, d):
    y = torch.where(m <= 2, y - 1, y)
    era = _fdiv(torch.where(y >= 0, y, y - 399), 400)
    yoe = y - era * 400
    mp = torch.where(m > 2, m - 3, m + 9)
    doy = _fdiv(153 * mp + 2, 5) + d - 1
    doe = yoe * 365 + _fdiv(yoe, 4) - _fdiv(yoe, 100) + doy
    return era * 146097 + doe - 719468


def bucket_start(ts_ms, duration: str):
    """Bucket start timestamps (ms, int64, wrapping) of a duration."""
    if duration in _FIXED_MS:
        w = _FIXED_MS[duration]
        return _fdiv(ts_ms, w) * w
    y, m = _civil_from_days(_fdiv(ts_ms, 86_400_000))
    one = torch.ones_like(m)
    if duration == "months":
        d0 = _days_from_civil(y, m, one)
    elif duration == "years":
        d0 = _days_from_civil(y, one, one)
    else:
        raise CompileError(f"unknown duration '{duration}'")
    return d0 * 86_400_000


class AggregationRuntime(Receiver):
    """One ``define aggregation``: per-duration bounded bucket tables fed
    by kernel K11, queried via within/per."""

    supports_packed = False
    K = 4096  # (group, bucket) slots per duration

    def __init__(self, app, ad: A.AggregationDefinition,
                 in_schema: StreamSchema):
        self.app = app
        self.ad = ad
        self.aggregation_id = ad.aggregation_id
        self.in_schema = in_schema
        # `weeks` is parsed and dropped, as in the reference
        self.durations = [d for d in DURATIONS if d in ad.durations]
        if not self.durations:
            raise CompileError(
                f"aggregation '{ad.aggregation_id}' has no durations")
        scope = SingleStreamScope(in_schema,
                                  aliases=(getattr(ad.input, "alias",
                                                   None),))
        self.scope = scope
        # aggregate-by timestamp attribute (LONG) or arrival time
        self.ts_idx: Optional[int] = None
        if ad.aggregate_by is not None:
            self.ts_idx = in_schema.index_of(ad.aggregate_by.attribute)
            if in_schema.attributes[self.ts_idx].type is not AttrType.LONG:
                raise CompileError(
                    "aggregate by attribute must be LONG (epoch ms)")

        # group-by: plain variables (AggregationParser restriction)
        self.group_exprs = []
        self.group_attrs = []
        for g in (ad.selector.group_by or []):
            if not isinstance(g, A.Variable):
                raise CompileError(
                    "aggregation group by must be plain attributes")
            self.group_exprs.append(compile_expression(g, scope))
            self.group_attrs.append(Attribute(
                g.attribute, in_schema.type_of(g.attribute)))

        # select attrs: plain group attrs pass through; aggregator calls
        # decompose into add-only lanes
        self.outputs = []   # (name, kind, payload)
        self.lanes = []     # (agg_name, lane_kind, CompiledExpr|None, dtype)
        for i, oa in enumerate(ad.selector.attributes):
            name = output_attribute_name(oa, i)
            e = oa.expression
            if isinstance(e, A.Variable):
                if not any(isinstance(g, A.Variable) and
                           g.attribute == e.attribute
                           for g in (ad.selector.group_by or [])):
                    raise CompileError(
                        f"aggregation select attribute '{name}' must be "
                        "a group-by attribute or an aggregate")
                self.outputs.append((name, "group",
                                     in_schema.index_of(e.attribute)))
                continue
            if isinstance(e, A.AttributeFunction) and e.namespace is None \
                    and e.name.lower() in _AGG_LANES:
                fname = e.name.lower()
                arg = None
                if e.parameters:
                    arg = compile_expression(e.parameters[0], scope)
                elif fname != "count":
                    raise CompileError(f"{fname}() needs an argument")
                int_arg = arg is not None and arg.type in (AttrType.INT,
                                                           AttrType.LONG)
                lane_ids = []
                for kind in _AGG_LANES[fname]:
                    dt = I64 if kind in ("count", "ncount") or int_arg \
                        else F64
                    lane_ids.append(len(self.lanes))
                    self.lanes.append((fname, kind, arg, dt))
                out_t = AttrType.LONG if fname == "count" or (
                    fname != "avg" and int_arg) else AttrType.DOUBLE
                self.outputs.append((name, fname, (lane_ids, out_t)))
                continue
            raise CompileError(
                "aggregation select supports group attributes and "
                "sum/avg/count/min/max aggregates")
        if len(self.durations) > _kernels.AGGR_MAX_DUR or \
                len(self.group_exprs) > _kernels.AGGR_MAX_GROUPS or \
                len(self.lanes) > _kernels.AGGR_MAX_LANES:
            raise NotImplementedError(
                f"not ported yet: more than {_kernels.AGGR_MAX_GROUPS} "
                f"group-by attributes or {_kernels.AGGR_MAX_LANES} lanes "
                "in one aggregation")

        out_attrs = []
        for n, kind, payload in self.outputs:
            t = in_schema.attributes[payload].type if kind == "group" \
                else payload[1]
            out_attrs.append(Attribute(n, t))
        out_attrs.append(Attribute("AGG_TIMESTAMP", AttrType.LONG))
        self.out_schema = StreamSchema(ad.aggregation_id,
                                       tuple(out_attrs))

        # the group-by and argument expressions that are not bare
        # columns: one K2 program
        exprs = list(self.group_exprs) + [a for _f, k, a, _d in self.lanes
                                          if a is not None and k != "count"]
        self._computed = []
        for e in exprs:
            if _bare_column(e) is None and \
                    all(e is not c for c in self._computed):
                self._computed.append(e)
        self._program = None
        if self._computed:
            b = ProgramBuilder()
            for e in self._computed:
                b.out(e)
            self._program = b.build()

        self.state = self._init_state(app.device)
        self._lock = threading.Lock()

    def _init_state(self, device):
        """The tables of every duration, stacked: [D, K] each, overflow
        [D]."""
        K, D = self.K, len(self.durations)
        lanes = []
        for fname, kind, arg, dt in self.lanes:
            if kind == "min":
                init = torch.iinfo(I64).max if dt == I64 else float("inf")
            elif kind == "max":
                init = torch.iinfo(I64).min if dt == I64 else float("-inf")
            else:
                init = 0
            lanes.append(torch.full((D, K), init, dtype=dt, device=device))
        return {
            "keys": torch.zeros((D, K), dtype=I64, device=device),
            "used": torch.zeros((D, K), dtype=torch.bool, device=device),
            "bstart": torch.zeros((D, K), dtype=I64, device=device),
            "groups": tuple(torch.zeros((D, K),
                                        dtype=torch_dtype(a.type),
                                        device=device)
                            for a in self.group_attrs),
            "gnulls": tuple(torch.zeros((D, K), dtype=torch.bool,
                                        device=device)
                            for _ in self.group_attrs),
            "lanes": tuple(lanes),
            "overflow": torch.zeros((D,), dtype=I64, device=device),
        }

    @property
    def states(self) -> dict:
        """The reference's layout: {duration: that duration's state dict}
        (views of the stacked tensors)."""
        return {d: _row(self.state, i) for i, d in enumerate(self.durations)}

    # -- ingest -----------------------------------------------------------
    def receive(self, events):
        from .runtime import QueryRuntime
        for batch, last_ts in QueryRuntime.encode_chunks(
                self.in_schema, events, self.app.device):
            self.process_batch(batch, last_ts)

    def process_batch(self, batch: EventBatch, timestamp: int,
                      now=None) -> None:
        if now is None:
            now = self.app.current_time()
        with self._lock:
            self.state = aggregation_step(self, self.state, batch, now)

    # -- query side -------------------------------------------------------
    def duration_key(self, duration: str) -> str:
        """Normalize a ``per '...'`` duration spelling to the canonical
        DURATIONS key, validating it against this aggregation."""
        d = duration.lower().rstrip("'\" ")
        alias = {"sec": "seconds", "min": "minutes", "hour": "hours",
                 "day": "days", "month": "months", "year": "years"}
        d = alias.get(d, d)
        if d not in self.durations:
            raise CompileError(
                f"aggregation '{self.aggregation_id}' has no duration "
                f"'{duration}' (available: {self.durations})")
        return d

    def materialize(self, duration: str, start: Optional[int],
                    end: Optional[int]):
        """-> (schema, buffer dict) of the buckets in the duration's
        table, filtered to [start, end) (AGG_TIMESTAMP)."""
        from .runtime import _tree_to
        d = self.duration_key(duration)
        with self._lock:
            st = _tree_to(self.states[d], "cpu")
        return self.materialize_from(st, d, start, end)

    def materialize_from(self, st: dict, duration: str,
                         start: Optional[int], end: Optional[int]):
        """Materialize from ONE duration's state dict on the host."""
        self.duration_key(duration)
        valid = np.asarray(st["used"]).copy()
        bs = np.asarray(st["bstart"])
        if start is not None:
            valid &= bs >= start
        if end is not None:
            valid &= bs < end
        cols = []
        nulls = []
        for name, kind, payload in self.outputs:
            if kind == "group":
                # stored group columns follow group_attrs order
                gi = [a.name for a in self.group_attrs].index(
                    self.in_schema.attributes[payload].name)
                cols.append(np.asarray(st["groups"][gi]))
                nulls.append(np.asarray(st["gnulls"][gi]))
                continue
            lane_ids, out_t = payload
            lvs = [np.asarray(st["lanes"][i]) for i in lane_ids]
            if kind == "avg":
                s, nc = lvs
                cols.append(s / np.maximum(nc, 1))
                nulls.append(nc == 0)
            elif kind == "count":
                cols.append(lvs[0])
                nulls.append(np.zeros_like(valid))
            else:  # sum/min/max: null when no non-null values seen
                v, nc = lvs
                cols.append(np.where(nc == 0, np.zeros_like(v), v))
                nulls.append(nc == 0)
        cols.append(bs)
        nulls.append(np.zeros_like(valid))
        dev = self.app.device

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        buf = {"cols": tuple(t(c) for c in cols),
               "nulls": tuple(t(n) for n in nulls),
               "ts": t(bs), "valid": t(valid)}
        return self.out_schema, buf

    # -- state ------------------------------------------------------------
    def snapshot_state(self) -> dict:
        """{duration: state dict of CPU tensors}, the reference's layout."""
        from .runtime import _tree_to
        with self._lock:
            return {d: _tree_to(st, "cpu") for d, st in self.states.items()}

    def restore_state(self, snap: dict) -> None:
        """From ``snapshot_state()`` output (or a reference snapshot
        carried over by carry.aggregation_from_jax)."""
        per = [snap[d] for d in self.durations]
        dev = self.app.device

        def stack(get):
            return torch.stack([torch.as_tensor(get(s)) for s in per]).to(
                dev).contiguous()
        state = {k: stack(lambda s, k=k: s[k])
                 for k in ("keys", "used", "bstart", "overflow")}
        for k in ("groups", "gnulls", "lanes"):
            state[k] = tuple(stack(lambda s, k=k, i=i: s[k][i])
                             for i in range(len(per[0][k])))
        with self._lock:
            self.state = state


def _row(state: dict, i: int) -> dict:
    return {k: (tuple(t[i] for t in v) if isinstance(v, tuple) else v[i])
            for k, v in state.items()}


# ---------------------------------------------------------------------------
# kernel K11 and its plain version
# ---------------------------------------------------------------------------


def step_inputs(rt: AggregationRuntime, batch: EventBatch, now):
    """K2 (the computed group-by and argument expressions, if any), then
    each group column and each lane's argument as (values, nulls) (None
    for count's), and the aggregate-by column (None: the batch ts)."""
    computed = {}
    if rt._program is not None:
        pc, pn, _valid = expr_eval(rt._program, batch, now=now)
        computed = {id(e): (c, n) for e, c, n in zip(rt._computed, pc, pn)}

    def col_of(ce):
        i = _bare_column(ce)
        return (batch.cols[i], batch.nulls[i]) if i is not None \
            else computed[id(ce)]
    gcols = [col_of(ce) for ce in rt.group_exprs]
    args = [col_of(arg) if arg is not None and kind != "count" else None
            for _f, kind, arg, _dt in rt.lanes]
    ets = batch.cols[rt.ts_idx] if rt.ts_idx is not None else None
    return gcols, args, ets


def aggregation_step(rt: AggregationRuntime, state: dict, batch: EventBatch,
                     now) -> dict:
    """One step of every duration's table -> the new state. A CPU batch
    takes the plain version; a CUDA batch launches kernel K11."""
    gcols, args, ets = step_inputs(rt, batch, now)
    dev = batch.ts.device
    if dev.type == "cpu":
        return aggregation_step_ref(rt, state, batch, gcols, args, ets)
    if dev.type != "cuda":
        raise ValueError(f"aggregation_step: unsupported device {dev}")
    new, a = aggr_args(rt, state, batch, gcols, args, ets)
    _kernels.load().aggregation_step(
        a, torch.cuda.current_stream(dev).cuda_stream)
    _kernels.count_launch("aggregation_step")
    return new


def _contrib(kind: str, dt, arg):
    """A lane's [B] contributions of the rows with a slot: the reference's
    ``jnp.where(eff, v, identity)``."""
    if kind == "count":
        return None
    v, null = arg
    if kind == "ncount":
        return (~null).to(I64)
    v = _widen(v, F64) if dt == F64 else v.to(I64)
    if kind == "sum":
        ident = 0
    elif dt == F64:
        ident = float("inf") if kind == "min" else float("-inf")
    else:
        info = torch.iinfo(I64)
        ident = info.max if kind == "min" else info.min
    return torch.where(null, torch.full_like(v, ident), v)


def _combine(kind: str, dt, acc, c):
    if kind in ("count", "ncount") or (kind == "sum" and dt == I64):
        return acc + c                          # int64 wraps
    if kind == "sum":
        return add(acc, c)
    return minimum(acc, c) if kind == "min" else maximum(acc, c)


def aggregation_step_ref(rt: AggregationRuntime, state: dict,
                         batch: EventBatch, gcols, args, ets) -> dict:
    """Plain PyTorch version of kernel K11, per duration: the bucket
    starts, the hash of (bucket start, group values), the slot probe,
    and a fold of each slot's rows in row order. The fold runs rank by
    rank: the r-th row of every slot at once (each slot once a rank), so
    it applies each slot's rows in row order, bit-equal to the
    reference's serial scatter."""
    K = rt.K
    dev = batch.ts.device
    active = batch.valid & (batch.kind == CURRENT)
    ets = ets.to(I64) if ets is not None else batch.ts
    contribs = [_contrib(kind, dt, arg)
                for (_f, kind, _a, dt), arg in zip(rt.lanes, args)]
    out = {k: [] for k in ("keys", "used", "bstart", "overflow", "groups",
                           "gnulls", "lanes")}
    for di, d in enumerate(rt.durations):
        bs = bucket_start(ets, d)
        hk = hash_columns([bs] + [v for v, _ in gcols],
                          [torch.zeros_like(active)] + [n for _, n in gcols])
        slots, keys, used, ovf = lookup_or_insert(
            state["keys"][di], state["used"][di], hk, active)
        ok = active & (slots >= 0)
        key = torch.where(ok, slots.to(I64), torch.full_like(bs, K))
        order = torch.argsort(key, stable=True)
        sk = key[order]
        n = int(ok.sum())
        bstart = state["bstart"][di].clone()
        groups = [g[di].clone() for g in state["groups"]]
        gnulls = [g[di].clone() for g in state["gnulls"]]
        lanes = [lv[di].clone() for lv in state["lanes"]]
        if n:
            sk, order = sk[:n], order[:n]
            # the set lanes: the last row of each slot's run
            last = torch.ones((n,), dtype=torch.bool, device=dev)
            last[:-1] = sk[1:] != sk[:-1]
            lrow, lslot = order[last], sk[last]
            bstart[lslot] = bs[lrow]
            for g, gn, (v, nl) in zip(groups, gnulls, gcols):
                g[lslot] = v[lrow].to(g.dtype)
                gn[lslot] = nl[lrow]
            # each row's rank in its slot's run; the rows by (rank, slot),
            # so that rank r's rows are one slice
            rank = torch.arange(n, device=dev) - segment_starts(sk)
            by_rank = torch.argsort(rank, stable=True)
            off = 0
            for cnt in torch.bincount(rank).tolist():
                at = by_rank[off:off + cnt]
                off += cnt
                rows, tgt = order[at], sk[at]
                for l, ((_f, kind, _a, dt), c) in enumerate(
                        zip(rt.lanes, contribs)):
                    cr = torch.ones_like(rows) if c is None else c[rows]
                    lanes[l][tgt] = _combine(kind, dt, lanes[l][tgt], cr)
        out["keys"].append(keys)
        out["used"].append(used)
        out["bstart"].append(bstart)
        out["overflow"].append(state["overflow"][di] + ovf)
        out["groups"].append(groups)
        out["gnulls"].append(gnulls)
        out["lanes"].append(lanes)
    new = {k: torch.stack(out[k]) for k in ("keys", "used", "bstart",
                                            "overflow")}
    for k in ("groups", "gnulls", "lanes"):
        new[k] = tuple(torch.stack([per[i] for per in out[k]])
                       for i in range(len(out[k][0])))
    return new


def aggr_args(rt: AggregationRuntime, state: dict, batch: EventBatch, gcols,
              args, ets):
    """K11's arguments: fresh tensors for the new state, the scratch, and
    ``_kernels.AggrArgs``. -> (new state, args)."""
    dev = batch.ts.device
    B, K, D = batch.capacity, rt.K, len(rt.durations)
    tensors = [batch.ts, batch.kind, batch.valid] + [
        t for v, n in gcols for t in (v, n)] + [
        t for arg in args if arg is not None for t in arg]
    if ets is not None:
        tensors.append(ets)
    for t in tensors:
        if t.device != dev or not t.is_contiguous() or t.shape[0] != B:
            raise ValueError("aggregation_step: every input must be a "
                             f"contiguous [{B}] tensor on {dev}")
    a = _kernels.AggrArgs()
    a.B, a.K, a.D = B, K, D
    a.n_groups, a.n_lanes = len(gcols), len(rt.lanes)
    for i, d in enumerate(rt.durations):
        a.dur[i] = DURATIONS.index(d)
    a.ets = (ets if ets is not None else batch.ts).data_ptr()
    a.kind, a.valid = batch.kind.data_ptr(), batch.valid.data_ptr()
    for g, (v, n) in enumerate(gcols):
        a.gcol[g], a.gnull[g] = v.data_ptr(), n.data_ptr()
        a.gtype[g], a.gsize[g] = DTYPE_VT[v.dtype], v.element_size()
    for l, ((_f, kind, _a, dt), arg) in enumerate(zip(rt.lanes, args)):
        a.lane_kind[l] = _LANE_KINDS[kind]
        a.lane_f64[l] = dt == F64
        if arg is not None:
            a.arg[l], a.arg_null[l] = arg[0].data_ptr(), arg[1].data_ptr()
            a.arg_type[l] = DTYPE_VT[arg[0].dtype]
    new = {k: torch.empty_like(state[k])
           for k in ("keys", "used", "bstart", "overflow")}
    for k in ("groups", "gnulls", "lanes"):
        new[k] = tuple(torch.empty_like(t) for t in state[k])
    for k in ("keys", "used", "bstart", "overflow"):
        setattr(a, k, state[k].data_ptr())
        setattr(a, "new_" + k, new[k].data_ptr())
    for k in ("groups", "gnulls", "lanes"):
        for i, (old, t) in enumerate(zip(state[k], new[k])):
            getattr(a, k)[i] = old.data_ptr()
            getattr(a, "new_" + k)[i] = t.data_ptr()
    blocks = (B + 1023) // 1024

    def e(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)
    sc = {"bs": e((D, B), I64), "hk": e((D, B), I64),
          "active": e((D, B), torch.uint8), "slot": e((D, B), torch.int32),
          "prb": e((D, B), torch.int32), "flags": e((D, B), torch.uint8),
          "claim": e((D, K), torch.int32), "skey": e((D, B), torch.int32),
          "perm": e((D, B), torch.int32), "k1": e((D, B), torch.int32),
          "k2": e((D, B), torch.int32), "i1": e((D, B), torch.int32),
          "i2": e((D, B), torch.int32),
          "counts": e((D, 256 * blocks), torch.int32)}
    for k, t in sc.items():
        setattr(a, k, t.data_ptr())
    a._keep = (batch, gcols, args, ets, state, sc)  # alive until the launch
    return new, a
