"""Carry a reference (JAX package) process's state into the port.

``state_from_jax`` turns the numpy pytree of a reference
``QueryRuntime.snapshot_state()`` (``{"states": ..., "emitted": ...}``,
plus ``"nfa"`` for a pattern query) into the port's state for
``QueryRuntime.restore_state``: window buffers (``ts``, ``seq``, the
columns and null masks, ``valid``), the aggregators' group tables
(``keys``, ``used``, ``carry``, ``overflow``) and the counters come
across as they are, with a window's STRING columns optionally mapped to
the port's dictionary codes.
``table_from_jax`` does the same for a table's state, ``block_from_jax``
for a partition block's, ``aggregation_from_jax`` for an incremental
aggregation's per-duration tables, ``cron_window_from_jax`` for a cron
window's buffers, ``reorder_from_jax`` and ``ring_from_jax`` for a
stream's reorder buffer and its device ring, ``ratelimit_from_jax`` for
an output rate limiter's rows and counters, ``pool_from_jax`` for a
tenant pool's stacked states and ``emitted`` counters.
``snapshot_from_jax`` and ``pool_snapshot_from_jax`` turn a whole
reference snapshot (an app's or a pool's ``snapshot()``) into the port's,
through those converters, for ``restore``.
``strings_from_jax`` seeds the port's string dictionary so that its
codes match the reference process's: both packages give strings codes
in order of first sight, so dictionary-coded columns and string
constants only compare equal once the two tables agree.

None of them imports the reference: they take its plain values.
"""
from __future__ import annotations

import copy
from typing import Sequence

import numpy as np
import torch

from .core.types import GLOBAL_STRINGS


def _tree(tree, device):
    if isinstance(tree, dict):
        return {k: _tree(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree(v, device) for v in tree)
    return torch.from_numpy(np.array(tree, copy=True)).to(device)


_BUFFER_KEYS = {"ts", "seq", "cols", "nulls", "valid"}
# a session window's [K, S] member buffers keep no seq
_MEMBER_KEYS = {"ts", "cols", "nulls", "valid"}


def _remap_buffers(tree, string_cols, remap):
    """Window buffers in ``tree`` (the sort window's, the frequent and
    lossyFrequent tables' and the session window's member buffers among
    them, with or without a slot axis) with their STRING columns (flags
    in ``string_cols``, the stream's attribute order) passed through
    ``remap``."""
    if isinstance(tree, dict):
        if set(tree) in (_BUFFER_KEYS, _MEMBER_KEYS):
            cols = tuple(np.asarray(remap(np.asarray(c)), np.int32)
                         if is_str else c
                         for c, is_str in zip(tree["cols"], tuple(
                             string_cols) + (False,) * len(tree["cols"])))
            return {**tree, "cols": cols}
        return {k: _remap_buffers(v, string_cols, remap)
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_remap_buffers(v, string_cols, remap)
                          for v in tree)
    return tree


def state_from_jax(snapshot: dict, device, string_cols: Sequence = (),
                   remap=None, side_strings=None) -> dict:
    """A reference QueryRuntime snapshot -> the port's query state. A
    PatternQueryRuntime's snapshot also carries its NFA pending table
    (``"nfa"``: the same pytree, tuples of slot buffers included), for
    either engine: every field the scan engine writes (both deadline
    lanes, born, min_at, seq, the counters, the slots' ts and fill
    counts) comes across as it is.

    ``remap`` (reference codes array -> port codes array) is applied to
    the STRING columns of every window buffer, flagged by
    ``string_cols`` in the query input's attribute order. A group
    table's slots are hashes of dictionary codes and cannot be mapped:
    it carries over only where both packages gave the feed's strings the
    same codes. A JoinQueryRuntime's snapshot also carries both sides'
    window states (``"sides"``, STRING columns flagged per side by
    ``side_strings``: {"L": flags, "R": flags}) and its lost-pair count;
    a table's state comes across with ``table_from_jax``."""
    states = snapshot["states"]
    if remap is not None:
        states = _remap_buffers(states, tuple(string_cols), remap)
    state = {"states": _tree(states, device),
             "emitted": torch.tensor(int(np.asarray(snapshot["emitted"])),
                                     dtype=torch.int64, device=device)}
    if "nfa" in snapshot:
        state["nfa"] = _tree(snapshot["nfa"], device)
    if "sides" in snapshot:
        # a join: both sides' window states, each side's STRING columns
        # flagged by side_strings[side]
        sides = snapshot["sides"]
        if remap is not None:
            sides = {s: _remap_buffers(v, tuple((side_strings or {}).get(s, ())),
                                       remap) for s, v in sides.items()}
        state["sides"] = _tree(sides, device)
        state["join_overflow"] = torch.tensor(
            int(np.asarray(snapshot["join_overflow"])), dtype=torch.int64,
            device=device)
    return state


def block_from_jax(snapshot: dict, device, string_cols=None,
                   remap=None) -> dict:
    """A reference ``PartitionBlockRuntime.snapshot_state()`` (its slot
    table, every query's [K]-stacked state, ``emitted`` and ``lost``)
    -> the port's, for ``PartitionBlockRuntime.restore_state``. A
    pattern query's state, (pending table, selector states), comes
    across as it is, and so does every window kind's slotted state: the
    K5 kinds' buffers and scalars, the sort window's buffer, the
    frequent and lossyFrequent tables (keys, counts, buckets, total) and
    the session window's key table, [K, 64, 128] member buffers and
    session ends. ``remap`` is applied to the STRING columns of every
    window buffer (the session's members included), flagged per query
    by ``string_cols`` ({query name: flags in its input's attribute
    order}), as in state_from_jax. The block's slot table, the frequent
    tables' keys and the session's key table hold hashes of dictionary
    codes and carry over only where both packages gave the feed's
    strings the same codes. Each rate-limited query's limiter state
    (``"rate"``: host rows and times) comes across as ratelimit_from_jax
    carries it."""
    qstates = snapshot["qstates"]
    if remap is not None:
        qstates = {qn: _remap_buffers(st, tuple((string_cols or {}).get(
            qn, ())), remap) for qn, st in qstates.items()}
    return {"slot_tbl": _tree(snapshot["slot_tbl"], device),
            "qstates": _tree(qstates, device),
            "emitted": _tree(snapshot["emitted"], device),
            "lost": _tree(snapshot["lost"], device),
            "rate": {qn: ratelimit_from_jax(r)
                     for qn, r in snapshot.get("rate", {}).items()}}


def table_from_jax(tstate: dict, device, string_cols: Sequence = (),
                   remap=None) -> dict:
    """A reference table state (``TableRuntime.state``: columns, null
    masks, ts, seq, valid, next_seq, overflow) -> the port's, its STRING
    columns (flags ``string_cols``, the table's attribute order) passed
    through ``remap``. Assign it to ``app.tables[id].state``."""
    cols = tuple(np.asarray(remap(np.asarray(c)), np.int32)
                 if (remap is not None and is_str) else np.asarray(c)
                 for c, is_str in zip(
                     tstate["cols"], tuple(string_cols) +
                     (False,) * len(tstate["cols"])))
    return _tree({**tstate, "cols": cols}, device)


def aggregation_from_jax(snapshot: dict, device, string_cols: Sequence = (),
                         remap=None) -> dict:
    """A reference ``AggregationRuntime.snapshot_state()`` ({duration:
    keys, used, bstart, groups, gnulls, lanes, overflow}) -> the port's,
    for ``AggregationRuntime.restore_state``. ``remap`` is applied to
    the STRING group columns, flagged by ``string_cols`` in group-by
    order. The slot keys are hashes of dictionary codes and carry over
    only where both packages gave the strings the same codes."""
    out = {}
    for d, st in snapshot.items():
        groups = tuple(np.asarray(remap(np.asarray(g)), np.int32)
                       if (remap is not None and is_str) else np.asarray(g)
                       for g, is_str in zip(
                           st["groups"], tuple(string_cols) +
                           (False,) * len(st["groups"])))
        out[d] = _tree({**st, "groups": groups}, device)
    return out


def cron_window_from_jax(state: dict, device, string_cols: Sequence = (),
                         remap=None) -> dict:
    """A reference cron window's state (``CronWindowOp.init_state``'s
    pytree: the buffered batch ``cur``, the expired batch ``exp``,
    ``next_seq`` and ``overflow``) -> the port's, its STRING columns
    (flags ``string_cols``, the stream's attribute order) passed through
    ``remap``. It goes in the window's place of ``QueryRuntime.states``."""
    if remap is not None:
        state = _remap_buffers(state, tuple(string_cols), remap)
    return _tree({k: state[k] for k in ("cur", "exp", "next_seq",
                                        "overflow")}, device)


def _remap_cols(cols, string_cols, remap):
    return [np.asarray(remap(np.asarray(c)), np.int32)
            if (remap is not None and is_str) else np.array(c, copy=True)
            for c, is_str in zip(cols, tuple(string_cols) +
                                 (False,) * len(cols))]


def reorder_from_jax(snapshot: dict, string_cols: Sequence = (),
                     remap=None) -> dict:
    """A reference ``ReorderBuffer.snapshot_state()`` (the lane, the
    event-time frontier ``max_ts``, the pending columnar segments, with a
    device ring's rows as one more segment in arrival order, the pending
    rows and the counters) -> the port's, for
    ``ReorderBuffer.restore_state``: host values both, the segments'
    STRING columns (flags ``string_cols``) passed through ``remap``; the
    rows' strings are strings already."""
    return {"lane": snapshot["lane"], "max_ts": snapshot["max_ts"],
            "cols": [(np.array(t, np.int64, copy=True),
                      _remap_cols(cs, string_cols, remap))
                     for t, cs in snapshot["cols"]],
            "rows": [(int(ts), tuple(data), bool(exp))
                     for ts, data, exp in snapshot["rows"]],
            "counters": {k: int(v) for k, v in
                         snapshot.get("counters", {}).items()}}


def ring_from_jax(ring_state, count: int, device,
                  string_cols: Sequence = (), remap=None):
    """A reference ``DeviceReorderRing``'s state ((ts, cols) of capacity
    C, rows [0, count) live in arrival order) -> the port's ring state,
    for ``DeviceReorderRing.state`` with ``count``; every row comes
    across, the dead ones too."""
    ts, cols = ring_state
    cols = _remap_cols([np.asarray(c) for c in cols], string_cols, remap)
    return (torch.from_numpy(np.array(ts, np.int64, copy=True)).to(device),
            tuple(torch.from_numpy(c).to(device) for c in cols))


def ratelimit_from_jax(snapshot: dict) -> dict:
    """A reference output rate limiter's ``snapshot_state()`` (rows as
    (ts, kind, values) tuples, keyed by group key where it groups, and
    its counters and times: host values in both packages) -> the port's,
    for the limiter's ``restore_state``: a copy."""
    return copy.deepcopy(snapshot)


def pool_from_jax(states: dict, emitted: dict, device, kinds: dict) -> tuple:
    """A reference ``TenantPool``'s stacked per-query states
    (``pool._states``: {query: pytree with the leading slot axis}, the
    layout of serving/pool.py: a chain's tuple of operator states, a
    pattern's {"nfa", "sel"}, a join's {"sides", "sel", "ovf"}, an
    aggregation's {duration: state}) and its ``emitted`` counters
    ({query: [slots]}), as numpy values, with the pool's node kinds
    (``pool._kind``) -> the port's (``TenantPool._states``,
    ``TenantPool._emitted``): the same pytrees, every slot, free ones
    included, but an aggregation node's durations stacked after the slot
    axis ([slots, D, K] a field, the overflow [slots, D]). A template
    parameter of type STRING, or an aggregation's STRING group column,
    holds each package's own dictionary code."""
    return ({qn: _tree(_durations_stacked(st) if kinds[qn] == "agg"
                       else st, device)
             for qn, st in states.items()},
            {qn: _tree(e, device) for qn, e in emitted.items()})


def _durations_stacked(st: dict) -> dict:
    """A pool aggregation node's {duration: slotted state} as one state,
    the durations on axis 1 in the canonical order."""
    from .core.aggregation import DURATIONS
    per = [st[d] for d in DURATIONS if d in st]

    def stack(get):
        return np.stack([np.asarray(get(x)) for x in per], axis=1)
    out = {k: stack(lambda x, k=k: x[k])
           for k in ("keys", "used", "bstart", "overflow")}
    for k in ("groups", "gnulls", "lanes"):
        out[k] = tuple(stack(lambda x, k=k, i=i: x[k][i])
                       for i in range(len(per[0][k])))
    return out


def strings_from_jax(codes_to_str: Sequence) -> None:
    """Seed GLOBAL_STRINGS with the reference's table (code -> string,
    code 0 = null). Strings the port already holds must have the same
    code; a conflict raises ValueError, since codes could not agree."""
    table = GLOBAL_STRINGS
    with table._lock:
        for code, s in enumerate(codes_to_str):
            if code == 0:
                continue
            if code < len(table._to_str):
                if table._to_str[code] != s:
                    raise ValueError(
                        f"string code {code} is {table._to_str[code]!r} "
                        f"here but {s!r} in the reference table")
                continue
            if s in table._to_code:
                raise ValueError(
                    f"string {s!r} has code {table._to_code[s]} here but "
                    f"{code} in the reference table")
            table._to_str.append(s)
            table._to_code[s] = code


def _string_flags(schema) -> tuple:
    """A schema's (or a list of attributes') STRING flags."""
    from .core.types import AttrType
    types = schema.types if hasattr(schema, "types") else \
        [a.type for a in schema]
    return tuple(t is AttrType.STRING for t in types)


def _code_remap(codes_to_str: Sequence):
    """The reference's string table (code -> string) interned in the
    port's: -> a function of a reference code array giving the port's
    codes (code 0, null, stays 0)."""
    table = np.array([0] + [GLOBAL_STRINGS.encode(s)
                            for s in list(codes_to_str)[1:]], np.int64)

    def remap(a):
        return table[np.asarray(a, np.int64)]
    return remap


def _payload(payload):
    from .core.persistence import PORT_MARK, deserialize
    if isinstance(payload, (bytes, bytearray)):
        payload = deserialize(bytes(payload))
    if payload.get("port") == PORT_MARK:
        raise ValueError("this snapshot was taken by the port already: "
                         "restore it as it is")
    return payload


def snapshot_from_jax(payload, runtime) -> bytes:
    """A reference ``SiddhiAppRuntime.snapshot()`` (its bytes, or the
    payload the port's ``core.persistence.deserialize`` reads from them)
    -> the port's snapshot bytes of the same state for ``runtime``
    (a port runtime of the same app), ready for ``runtime.restore``.

    Every piece goes through its converter above: the queries'
    (state_from_jax; a join's sides, a pattern's table, a rate limiter's
    rows), the named windows', the tables', the partition blocks', the
    aggregations' and the reorder buffers'. The reference's strings are
    interned in the port's table and the STRING columns of every window
    buffer, table, group column and reorder segment are mapped to the
    port's codes; hashed codes (group tables, a block's slot table, a
    pattern table's STRING slots) carry over only where both tables gave
    the strings the same codes, as for the converters alone."""
    from .core.persistence import dump_strings, serialize
    payload = _payload(payload)
    dev = runtime.device
    remap = _code_remap(payload["strings"])
    queries = {}
    for n, snap in payload["queries"].items():
        q = runtime.queries.get(n)
        if q is None:
            continue
        side = {s: _string_flags(sc)
                for s, sc in getattr(q, "in_schemas", {}).items()}
        st = state_from_jax(snap, dev, _string_flags(q.in_schema), remap,
                            side_strings=side)
        if "rate" in snap:
            st["rate"] = ratelimit_from_jax(snap["rate"])
        queries[n] = st
    windows = {n: state_from_jax(s, dev, _string_flags(
                   runtime.named_windows[n].in_schema), remap)
               for n, s in payload.get("windows", {}).items()
               if n in runtime.named_windows}
    tables = {tid: table_from_jax(t, dev, _string_flags(
                  runtime.tables[tid].schema), remap)
              for tid, t in payload.get("tables", {}).items()
              if tid in runtime.tables}
    partitions = {}
    for n, s in payload.get("partitions", {}).items():
        b = runtime.partitions.get(n)
        if b is not None:
            partitions[n] = block_from_jax(s, dev, {
                p.name: _string_flags(p.in_schema) for p in b.plans}, remap)
    aggregations = {}
    for n, s in payload.get("aggregations", {}).items():
        a = runtime.aggregations.get(n)
        if a is not None:
            flags = _string_flags(a.group_attrs)
            aggregations[n] = aggregation_from_jax(s, dev, flags, remap)
    reorder = {sid: reorder_from_jax(s, _string_flags(
                   runtime.schemas[sid]), remap)
               for sid, s in payload.get("reorder", {}).items()
               if sid in runtime.schemas}
    return serialize({
        "app": payload.get("app", runtime.name),
        "playback_time": payload["playback_time"],
        "queries": queries, "windows": windows, "tables": tables,
        "partitions": partitions, "aggregations": aggregations,
        "reorder": reorder, "strings": dump_strings()})


def pool_snapshot_from_jax(payload, pool) -> bytes:
    """A reference ``TenantPool.snapshot()`` (bytes, or the payload the
    port's ``deserialize`` reads) -> the port's whole-pool snapshot bytes
    for ``pool`` (a port pool of the same template), ready for
    ``pool.restore``: the stacked states and ``emitted`` counters through
    pool_from_jax (an aggregation node's durations stacked), the slot
    map, bindings, QoS dials, rounds and clock as they are. The
    reference's strings are interned in the port's table; a STRING
    template parameter or group column in the states holds the
    reference's code, as pool_from_jax carries it."""
    from .core.persistence import dump_strings, serialize
    payload = _payload(payload)
    if payload.get("kind") != "tenant-pool":
        raise ValueError("snapshot is not a tenant-pool snapshot")
    _code_remap(payload["strings"])
    qs = payload["queries"]
    states, emitted = pool_from_jax(
        {qn: q["states"] for qn, q in qs.items()},
        {qn: q["emitted"] for qn, q in qs.items()}, "cpu", pool._kind)
    return serialize({
        **{k: payload[k] for k in ("kind", "template", "shared", "slots",
                                   "now", "rounds", "tenants")},
        "pool": pool.name,
        "queries": {qn: {"states": states[qn], "emitted": emitted[qn]}
                    for qn in qs},
        "strings": dump_strings()})
