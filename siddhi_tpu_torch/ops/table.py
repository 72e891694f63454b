"""In-memory tables as device column stores (PyTorch port of
siddhi_tpu/ops/table.py): kernel K8 of PERF.md, and the key view kernel
K7 shares.

Reference mapping:
- table/InMemoryTable.java:58-200 (add/delete/update/updateOrAdd/find/
  contains over an EventHolder)
- table/holder/ListEventHolder.java / IndexEventHolder.java:60-110 (one
  columnar buffer here, with primary-key upsert when @PrimaryKey is
  declared, and sorted probes for @Index attributes)
- util/parser/OperatorParser.java:62 (conditions over (event, table row)
  pairs)
- query/output/callback/{InsertIntoTable,DeleteTable,UpdateTable,
  UpdateOrInsertTable}Callback.java (TableOutputOp)

A table's state is a dict of tensors on the app's device. Every query
step that touches tables reads the current states and writes new ones,
under the tables' locks taken in a fixed order (core/runtime.py).
Capacity is fixed; rows beyond it are counted in ``overflow``.

Kernel K8 (csrc/table_step.cu) has four entry points, each with a plain
PyTorch version beside it that follows the reference function by
function; a wrapper takes the plain version for tensors on the CPU and
launches the kernel for CUDA tensors:
- ``table_write`` (``TableRuntime.insert`` with ``_scatter_rows``):
  primary-key replacement in place (duplicates within a batch resolved in
  row order, the later row winning), free slots in ascending index,
  ``seq``/``next_seq`` as the reference numbers them, overflow;
- ``table_match`` (``TableOutputOp.step_tables`` and the grid branch of
  ``TableFilterOp.step_tables``): per table row whether any acting event
  matches and the last one that does, per event whether any row matches,
  the SET values at (that event, the row);
- ``table_probe`` (``probe_touched``): an @Index probe through the
  sorted key view;
- ``table_buffer`` (``TableRuntime.buffer``): the seq-ordered view a
  join reads.

Conditions and SET expressions compile to ``PairProgram``s: programs of
the K2 interpreter whose loads read one of two sides (an event and a
table row here; a trigger row and an opposite row in ops/join.py).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Optional

import numpy as np
import torch

from .. import _kernels
from ..core.event import CURRENT, EventBatch, StreamSchema
from ..core.types import AttrType, flush_subnormal, np_dtype, torch_dtype
from ..lang import ast as A
from .expr import (VT, CompileError, ProgramBuilder, Scope, _widen,
                   compile_expression, expr_eval, run_program)
from .keyed import hash_columns
from .operators import Operator
from .sentinels import POS_INF

I64 = torch.int64


# ---------------------------------------------------------------------------
# two-sided programs
# ---------------------------------------------------------------------------

# the column of side 0 that is its rows' timestamps (eventTimestamp()
# in a join's ON, the trigger row's; in a table condition, the event's)
TS_COL = 0xFFFF


class PairProgram:
    """Compiled expressions as one K2-interpreter program whose loads
    read one of two sides: ``ins[k] = (side, column)`` for input k of the
    program, side 0 or 1 (column TS_COL: side 0's timestamps).
    ``keep``: the expressions are conditions (their conjunction is the
    result), else each is an output."""

    def __init__(self, ces, keep: bool, side_of):
        b = ProgramBuilder()
        for ce in ces:
            b.keep(ce) if keep else b.out(ce)
        self.prog = b.build()
        self.ins = tuple(side_of(k) for k in self.prog.inputs)
        self._dev: dict = {}

    def tensors(self, dev):
        """(code int32, consts int64, ins int32 = side << 16 | column) on
        ``dev``, built once per device."""
        t = self._dev.get(dev)
        if t is None:
            p = self.prog
            t = (torch.tensor(list(p.code) or [0], dtype=torch.int32,
                              device=dev),
                 torch.tensor(list(p.consts) or [0], dtype=I64, device=dev),
                 torch.tensor([s << 16 | c for s, c in self.ins] or [0],
                              dtype=torch.int32, device=dev))
            self._dev[dev] = t
        return t

    def run(self, sides, shape, dev, ts0=None):
        """Plain evaluation: ``sides[s][c]`` = (values, nulls) of column c
        of side s, ``ts0`` side 0's timestamps, each broadcastable to
        ``shape``. -> (keep, outs) as ``run_program`` gives them."""
        def load(key):
            s, c = self.ins[self.prog.inputs.index(key)]
            if c == TS_COL:
                return ts0, torch.zeros((), dtype=torch.bool, device=dev)
            return sides[s][c]
        return run_program(self.prog, load, shape, dev)

    @property
    def reads_ts(self) -> bool:
        return any(c == TS_COL for _s, c in self.ins)


def fill_prog(pp, prog: Optional[PairProgram], dev) -> None:
    """``_kernels.PairProg`` for ``prog`` on ``dev`` (n_code 0: none)."""
    if prog is None:
        pp.n_code = 0
        return
    code, consts, ins = prog.tensors(dev)
    pp.code, pp.consts, pp.ins = (code.data_ptr(), consts.data_ptr(),
                                  ins.data_ptr())
    pp.n_code = len(prog.prog.code)


def side_cols(cols, nulls, index=None):
    """[(values, nulls)] of one side, each reshaped by ``index`` (a
    slicing tuple such as ``(slice(None), None)``) for broadcasting, or
    gathered at ``index`` (a tensor)."""
    if index is None:
        return list(zip(cols, nulls))
    return [(c[index], n[index]) for c, n in zip(cols, nulls)]


def fill_side(sc, ts, kind, valid, cols, nulls) -> None:
    """Point a ``_kernels.SideCols`` at one side's tensors."""
    if len(cols) > _kernels.JOIN_MAX_COLS:
        raise NotImplementedError(
            f"not ported yet: a join or table side with more than "
            f"{_kernels.JOIN_MAX_COLS} attributes ({len(cols)})")
    sc.ts = ts.data_ptr() if ts is not None else None
    sc.kind = kind.data_ptr() if kind is not None else None
    sc.valid = valid.data_ptr() if valid is not None else None
    for k, (c, n) in enumerate(zip(cols, nulls)):
        sc.cols[k] = c.data_ptr()
        sc.nulls[k] = n.data_ptr()
        sc.col_size[k] = c.element_size()
    sc.n_cols = len(cols)


# ---------------------------------------------------------------------------
# sort keys: the reference's sort comparator as int64 order
# ---------------------------------------------------------------------------

# the pad value of each key type (sorted_key_view's ``big``)
_BIG = {AttrType.INT: 2 ** 31 - 1, AttrType.STRING: 2 ** 31 - 1,
        AttrType.LONG: 2 ** 63 - 1, AttrType.BOOL: 255,
        AttrType.FLOAT: float("inf"), AttrType.DOUBLE: float("inf")}


def encode_keys(values, t: AttrType):
    """Key values of type ``t`` as int64 whose signed order is the
    reference's sort comparator (jax's ``_sort_lt_comparator``): a float
    is canonicalised first (a zero, or a subnormal that compares equal to
    zero, becomes +0.0; every NaN the positive quiet NaN), then ordered
    totally by its bits. Ints and dictionary codes keep their value; a
    BOOL key is its uint8 0/1."""
    if t is AttrType.FLOAT or t is AttrType.DOUBLE:
        v = values
        v = torch.where(flush_subnormal(v) == 0, torch.zeros_like(v), v)
        v = torch.where(torch.isnan(v), torch.full_like(v, float("nan")), v)
        if t is AttrType.FLOAT:
            b = v.view(torch.int32).to(I64)
            return torch.where(b < 0, b ^ 0x7FFFFFFF, b)
        b = v.view(I64)
        return torch.where(b < 0, b ^ 0x7FFFFFFFFFFFFFFF, b)
    return values.to(I64)


def big_key(t: AttrType) -> int:
    """The encoded pad value of key type ``t``."""
    big = _BIG[t]
    if isinstance(big, float):
        return int(encode_keys(torch.tensor([big], dtype=torch_dtype(t)),
                               t)[0])
    return big


def search_levels(n: int) -> int:
    """jnp.searchsorted's bisection depth over ``n`` sorted values."""
    return int(np.ceil(np.log2(n + 1)))


def bisect(sorted_keys, values, side: str):
    """``jnp.searchsorted(sorted_keys, values, side)`` step for step
    (its default ``scan`` method: a fixed number of halvings, low = 0,
    high = n, the result high), so that it gives the reference's answer
    even where ``sorted_keys`` is not sorted (a live NaN key sorts above
    the +inf padding in the reference's key view)."""
    n = sorted_keys.shape[0]
    dev = values.device
    low = torch.zeros(values.shape, dtype=I64, device=dev)
    high = torch.full(values.shape, n, dtype=I64, device=dev)
    for _ in range(search_levels(n)):
        mid = (low + high) // 2
        a = sorted_keys[mid]
        go_left = (values <= a) if side == "left" else (values < a)
        low, high = torch.where(go_left, low, mid), \
            torch.where(go_left, mid, high)
    return high


def sorted_key_view(keys, live, t: AttrType):
    """Stable key-sorted view of a buffer's key column (``keys`` encoded
    by ``encode_keys``): live rows first, ascending key, buffer position
    within equal keys; padded rows last, their key the type's pad value.
    -> (order: sorted position -> buffer position, sorted keys, n_live).
    Shared by the table probe and the banded join probe."""
    ks = torch.where(live, keys, torch.full_like(keys, big_key(t)))
    o1 = torch.argsort(ks, stable=True)
    o2 = torch.argsort((~live[o1]).to(torch.int8), stable=True)
    order = o1[o2]
    return order, ks[order], live.sum(dtype=torch.int32)


def band_bounds(sorted_keys, n_live, values, op: str, act):
    """Per probe value ``[lo, hi)`` positional bands over a
    ``sorted_key_view``: the run of live rows with ``row_key OP value``.
    Inactive probes get empty bands. int32 results, as the reference's."""
    sk, v = sorted_keys, values
    zero = torch.zeros(v.shape, dtype=I64, device=v.device)
    nl = n_live.to(I64).expand(v.shape)
    if op == "==":
        lo, hi = bisect(sk, v, "left"), bisect(sk, v, "right")
    elif op == "<":
        lo, hi = zero, bisect(sk, v, "left")
    elif op == "<=":
        lo, hi = zero, bisect(sk, v, "right")
    elif op == ">":
        lo, hi = bisect(sk, v, "right"), nl
    else:  # '>='
        lo, hi = bisect(sk, v, "left"), nl
    lo = torch.minimum(lo, nl).to(torch.int32)
    hi = torch.minimum(hi, nl).to(torch.int32)
    return lo, torch.where(act, hi, lo)


# ---------------------------------------------------------------------------
# the table
# ---------------------------------------------------------------------------

class TableRuntime:
    """One `define table` instance, shared by every query that uses it."""

    def __init__(self, table_id: str, schema: StreamSchema,
                 capacity: int = 8192, pk_indices: Optional[list] = None,
                 index_indices: Optional[list] = None, device="cpu"):
        self.table_id = table_id
        self.schema = schema
        self.cap = int(capacity)
        self.pk = tuple(pk_indices or ())
        # @Index attributes (IndexEventHolder.java:60-110): conditions of
        # the form `T.attr OP <stream expr>` on them probe a sorted view
        self.indexes = tuple(index_indices or ())
        self.lock = threading.Lock()
        self.device = torch.device(device)
        self.state = self.init_state(self.device)

    def init_state(self, device="cpu") -> dict:
        T = self.cap
        return {
            "cols": tuple(torch.zeros((T,), dtype=torch_dtype(t),
                                      device=device)
                          for t in self.schema.types),
            "nulls": tuple(torch.zeros((T,), dtype=torch.bool, device=device)
                           for _ in self.schema.types),
            "ts": torch.zeros((T,), dtype=I64, device=device),
            "seq": torch.zeros((T,), dtype=I64, device=device),
            "valid": torch.zeros((T,), dtype=torch.bool, device=device),
            "next_seq": torch.zeros((), dtype=I64, device=device),
            "overflow": torch.zeros((), dtype=I64, device=device),
        }

    def insert(self, state: dict, batch: EventBatch, row_mask) -> dict:
        """Append the masked rows (with a primary key, a row whose key the
        table holds replaces that row in place)."""
        return table_write(self, state, batch, row_mask)

    def buffer(self, state: dict) -> dict:
        """The findable view, in seq order (a window buffer's layout)."""
        return table_buffer(state)


def _scatter_rows(table, state, batch, ok, dest, keep_seq):
    """``state`` with batch rows ``ok`` written at ``dest``; a later row
    wins where two share a destination (the reference's scatter on the
    CPU). ``keep_seq``: a replacement keeps the row's seq."""
    T = table.cap
    B = batch.capacity
    dev = batch.ts.device
    rows = torch.arange(B, dtype=I64, device=dev)
    d = torch.where(ok, dest.to(I64), torch.full_like(rows, T))
    # the last writer of each destination
    win = torch.full((T + 1,), -1, dtype=I64, device=dev)
    win.scatter_reduce_(0, d, torch.where(ok, rows, -1), "amax")
    win = win[:T]
    hit = win >= 0
    src = torch.clamp(win, min=0)
    cols = tuple(torch.where(hit, bc[src], tc)
                 for tc, bc in zip(state["cols"], batch.cols))
    nulls = tuple(torch.where(hit, bn[src], tn)
                  for tn, bn in zip(state["nulls"], batch.nulls))
    ts = torch.where(hit, batch.ts[src], state["ts"])
    if keep_seq:
        seq, next_seq = state["seq"], state["next_seq"]
    else:
        n_ok = torch.cumsum(ok.to(I64), 0) - 1
        seq = torch.where(hit, state["next_seq"] + n_ok[src], state["seq"])
        next_seq = state["next_seq"] + ok.sum(dtype=I64)
    valid = state["valid"] | hit
    return {**state, "cols": cols, "nulls": nulls, "ts": ts, "seq": seq,
            "valid": valid, "next_seq": next_seq}


def table_write_ref(table, state: dict, batch: EventBatch, row_mask) -> dict:
    """Plain PyTorch version of K8's write (``TableRuntime.insert``)."""
    T = table.cap
    adding = row_mask & batch.valid
    if table.pk:
        bkeys = hash_columns([batch.cols[i] for i in table.pk],
                             [batch.nulls[i] for i in table.pk])
        tkeys = hash_columns([state["cols"][i] for i in table.pk],
                             [state["nulls"][i] for i in table.pk])
        eq = (bkeys[:, None] == tkeys[None, :]) & adding[:, None] \
            & state["valid"][None, :]
        hit_row = torch.where(eq.any(1), torch.argmax(eq.to(torch.int8), 1),
                              torch.full_like(bkeys, T))
        replaces = hit_row < T
        state = _scatter_rows(table, state, batch, adding & replaces,
                              hit_row, keep_seq=True)
        adding = adding & ~replaces
    free = ~state["valid"]
    free_pos = torch.argsort((~free).to(torch.int8), stable=True)
    n_free = free.sum(dtype=I64)
    rank = torch.cumsum(adding.to(I64), 0) - 1
    ok = adding & (rank < n_free)
    dest = torch.where(ok, free_pos[torch.clamp(rank, 0, T - 1)],
                       torch.full_like(rank, T))
    state = _scatter_rows(table, state, batch, ok, dest, keep_seq=False)
    lost = (adding & ~ok).sum(dtype=I64)
    return {**state, "overflow": state["overflow"] + lost}


def table_buffer_ref(state: dict) -> dict:
    """Plain PyTorch version of K8's seq-ordered view."""
    key = torch.where(state["valid"], state["seq"],
                      torch.full_like(state["seq"], int(POS_INF)))
    order = torch.argsort(key, stable=True)
    return {"cols": tuple(c[order] for c in state["cols"]),
            "nulls": tuple(n[order] for n in state["nulls"]),
            "ts": state["ts"][order], "seq": state["seq"][order],
            "valid": state["valid"][order]}


def table_match_ref(table, state: dict, batch: EventBatch, acting,
                    cond: Optional[PairProgram],
                    sets: Optional[PairProgram] = None, set_cols=(),
                    delete: bool = False):
    """Plain PyTorch version of K8's condition pass over [B, T]: ``cond``
    at every (event, table row) pair (side 0 the events, side 1 the
    table), masked by ``acting`` (None: every event row) and the live
    rows. -> (state' with the touched rows deleted or given the SET
    values of their last matching event, any_hit [B])."""
    B, T = batch.capacity, table.cap
    dev = batch.ts.device
    if cond is not None:
        sides = (side_cols(batch.cols, batch.nulls, (slice(None), None)),
                 side_cols(state["cols"], state["nulls"], (None, slice(None))))
        grid, _ = cond.run(sides, (B, T), dev, batch.ts[:, None])
    else:
        grid = torch.ones((B, T), dtype=torch.bool, device=dev)
    if acting is not None:
        grid = grid & acting[:, None]
    grid = grid & state["valid"][None, :]
    any_hit = grid.any(1)
    if sets is None and not delete:
        return state, any_hit
    touched = grid.any(0)
    if delete:
        return {**state, "valid": state["valid"] & ~touched}, any_hit
    # per table row the LAST matching event gives the values
    last = (B - 1) - torch.argmax(grid.flip(0).to(torch.int8), 0)
    src = torch.where(touched, last, torch.zeros_like(last))
    sides = (side_cols(batch.cols, batch.nulls, src),
             side_cols(state["cols"], state["nulls"]))
    _keep, outs = sets.run(sides, (T,), dev, batch.ts[src])
    cols, nulls = list(state["cols"]), list(state["nulls"])
    for k, tidx in enumerate(set_cols):
        v, n = outs[k]
        cols[tidx] = torch.where(touched, v.to(cols[tidx].dtype), cols[tidx])
        nulls[tidx] = torch.where(touched, n, nulls[tidx])
    return {**state, "cols": tuple(cols), "nulls": tuple(nulls)}, any_hit


def probe_touched_ref(table, state: dict, probe: "IndexProbe",
                      batch: EventBatch, acting):
    """Plain PyTorch version of K8's index probe (``probe_touched``):
    -> (touched [T]: rows matched by any acting event, any_hit [B])."""
    T = table.cap
    B = batch.capacity
    dev = batch.ts.device
    kt = table.schema.types[probe.attr]
    keys = encode_keys(state["cols"][probe.attr], kt)
    live = state["valid"] & ~state["nulls"][probe.attr]
    order, sk, n_live = sorted_key_view(keys, live, kt)
    _k, outs = probe.value.run(
        (side_cols(batch.cols, batch.nulls), ()), (B,), dev, batch.ts)
    vv, vnull = outs[0]
    v = encode_keys(vv, kt)
    act = acting & ~vnull
    lo, hi = band_bounds(sk, n_live, v, probe.op, act)
    any_hit = act & (hi > lo)
    lo_m = torch.where(any_hit, lo, T).to(I64)
    hi_m = torch.where(any_hit, hi, T).to(I64)
    delta = torch.zeros((T + 1,), dtype=torch.int32, device=dev)
    delta.index_add_(0, lo_m, torch.ones_like(lo_m, dtype=torch.int32))
    delta.index_add_(0, hi_m, -torch.ones_like(hi_m, dtype=torch.int32))
    covered = torch.cumsum(delta, 0)[:T] > 0
    touched = torch.zeros((T,), dtype=torch.bool, device=dev)
    touched[order] = covered
    return touched & state["valid"], any_hit


# ---------------------------------------------------------------------------
# kernel K8 wrappers
# ---------------------------------------------------------------------------

def _cuda(what: str, dev) -> None:
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _fresh_state(state: dict) -> dict:
    return {"cols": tuple(torch.empty_like(c) for c in state["cols"]),
            "nulls": tuple(torch.empty_like(n) for n in state["nulls"]),
            **{k: torch.empty_like(state[k])
               for k in ("ts", "seq", "valid", "next_seq", "overflow")}}


def _fill_table(tb, st: dict) -> None:
    """Point a ``_kernels.TableBuf`` at a table state's tensors."""
    for k, (c, n) in enumerate(zip(st["cols"], st["nulls"])):
        tb.cols[k] = c.data_ptr()
        tb.nulls[k] = n.data_ptr()
    tb.ts, tb.seq, tb.valid = (st["ts"].data_ptr(), st["seq"].data_ptr(),
                               st["valid"].data_ptr())
    tb.next_seq = st["next_seq"].data_ptr()
    tb.overflow = st["overflow"].data_ptr()


def _table_args(table, state: dict, batch: Optional[EventBatch], dev):
    a = _kernels.TableArgs()
    if len(table.schema.types) > _kernels.JOIN_MAX_COLS:
        raise NotImplementedError(
            f"not ported yet: a table of more than {_kernels.JOIN_MAX_COLS} "
            f"attributes ({len(table.schema.types)})")
    _fill_table(a.t, state)
    for k, c in enumerate(state["cols"]):
        a.col_size[k] = c.element_size()
        a.col_type[k] = VT[table.schema.types[k]]
    a.n_cols = len(state["cols"])
    a.T = table.cap
    if batch is not None:
        fill_side(a.ev, batch.ts, batch.kind, batch.valid, batch.cols,
                  batch.nulls)
        a.B = batch.capacity
    return a


def _scratch(n, dtype, dev):
    return torch.empty((max(int(n), 1),), dtype=dtype, device=dev)


def table_write_args(table, state: dict, batch: EventBatch, row_mask):
    """K8 write's arguments: -> (the new state (fresh tensors), args)."""
    dev = batch.ts.device
    T, B = table.cap, batch.capacity
    new = _fresh_state(state)
    a = _table_args(table, state, batch, dev)
    _fill_table(a.o, new)
    mask = row_mask.contiguous()
    a.mask = mask.data_ptr()
    if len(table.pk) > _kernels.TABLE_MAX_PK:
        raise NotImplementedError(
            f"not ported yet: a primary key of more than "
            f"{_kernels.TABLE_MAX_PK} attributes")
    a.n_pk = len(table.pk)
    for k, i in enumerate(table.pk):
        a.pk[k] = i
    sc = {"hk": _scratch(B, I64, dev), "tk": _scratch(T, I64, dev),
          "hit": _scratch(B, I64, dev), "win": _scratch(T, I64, dev),
          "rank": _scratch(B, I64, dev), "free_pos": _scratch(T, I64, dev),
          "scal": _scratch(8, I64, dev),
          "adding": _scratch(B, torch.uint8, dev)}
    for k, t in sc.items():
        setattr(a, k, t.data_ptr())
    a._keep = (state, new, sc, mask, batch)
    return new, a


def table_write(table, state: dict, batch: EventBatch, row_mask) -> dict:
    """Kernel K8's write: append the rows of ``row_mask`` (primary-key
    rows replace in place). CPU tensors take the plain version."""
    dev = batch.ts.device
    if dev.type == "cpu":
        return table_write_ref(table, state, batch, row_mask)
    _cuda("table_write", dev)
    new, a = table_write_args(table, state, batch, row_mask)
    _kernels.load().table_write(a, _stream(dev))
    _kernels.count_launch("table_write")
    return new


def table_buffer_args(state: dict):
    """K8 view's arguments: -> (the view (fresh tensors), args)."""
    dev = state["ts"].device
    T = state["ts"].shape[0]
    out = {"cols": tuple(torch.empty_like(c) for c in state["cols"]),
           "nulls": tuple(torch.empty_like(n) for n in state["nulls"]),
           "ts": torch.empty_like(state["ts"]),
           "seq": torch.empty_like(state["seq"]),
           "valid": torch.empty_like(state["valid"])}
    a = _kernels.TableArgs()
    _fill_table(a.t, state)
    for k, c in enumerate(state["cols"]):
        a.col_size[k] = c.element_size()
        a.o.cols[k] = out["cols"][k].data_ptr()
        a.o.nulls[k] = out["nulls"][k].data_ptr()
    a.o.ts, a.o.seq, a.o.valid = (out["ts"].data_ptr(),
                                  out["seq"].data_ptr(),
                                  out["valid"].data_ptr())
    a.n_cols, a.T = len(state["cols"]), T
    sc = _sort_scratch(T, dev)
    _fill_sort(a.sort, sc)
    a._keep = (state, out, sc)
    return out, a


def table_buffer(state: dict) -> dict:
    """Kernel K8's seq-ordered view of a table (the rows a join finds).
    CPU tensors take the plain version."""
    dev = state["ts"].device
    if dev.type == "cpu":
        return table_buffer_ref(state)
    _cuda("table_buffer", dev)
    out, a = table_buffer_args(state)
    _kernels.load().table_buffer(a, _stream(dev))
    _kernels.count_launch("table_buffer")
    return out


def _sort_scratch(n: int, dev) -> dict:
    blocks = (n + 1023) // 1024
    return {"k1": _scratch(n, I64, dev), "k2": _scratch(n, I64, dev),
            "i1": _scratch(n, torch.int32, dev),
            "i2": _scratch(n, torch.int32, dev),
            "keys": _scratch(n, I64, dev),
            "pad": _scratch(n, torch.uint8, dev),
            "order": _scratch(n, torch.int32, dev),
            "sk": _scratch(n, I64, dev),
            "n_live": _scratch(1, I64, dev),
            "counts": _scratch(256 * blocks, torch.int32, dev)}


def _fill_sort(ks, sc: dict) -> None:
    for k in ("k1", "k2", "i1", "i2", "keys", "pad", "order", "sk",
              "n_live", "counts"):
        setattr(ks, k, sc[k].data_ptr())


def table_match_args(table, state: dict, batch: EventBatch, acting,
                     cond: Optional[PairProgram],
                     sets: Optional[PairProgram] = None, set_cols=(),
                     delete: bool = False):
    """K8 condition pass's arguments: -> ((state', any_hit), args)."""
    dev = batch.ts.device
    B = batch.capacity
    new = dict(state)
    if sets is not None or delete:
        new = {**state, "valid": torch.empty_like(state["valid"])}
        if sets is not None:
            cols, nulls = list(state["cols"]), list(state["nulls"])
            for tidx in set_cols:
                cols[tidx] = torch.empty_like(cols[tidx])
                nulls[tidx] = torch.empty_like(nulls[tidx])
            new["cols"], new["nulls"] = tuple(cols), tuple(nulls)
    any_hit = torch.empty((B,), dtype=torch.bool, device=dev)
    a = _table_args(table, state, batch, dev)
    _fill_table(a.o, new)
    fill_prog(a.cond, cond, dev)
    fill_prog(a.sets, sets, dev)
    a.has_cond = int(cond is not None)
    for k, tidx in enumerate(set_cols):
        a.set_col[k] = tidx
    a.n_sets = len(set_cols)
    mask = acting.contiguous() if acting is not None else None
    a.mask = mask.data_ptr() if mask is not None else None
    a.mode = 2 if sets is not None else (1 if delete else 0)
    a.any_hit = any_hit.data_ptr()
    a._keep = (state, new, any_hit, mask, batch)
    return (new, any_hit), a


def table_match(table, state: dict, batch: EventBatch, acting,
                cond: Optional[PairProgram],
                sets: Optional[PairProgram] = None, set_cols=(),
                delete: bool = False):
    """Kernel K8's condition pass (see ``table_match_ref``): -> (state',
    any_hit [B]). One warp a table row walks the events from the last
    (the last matching event gives the SET values), one warp an event
    walks the rows; the [B, T] grid is never built."""
    dev = batch.ts.device
    if dev.type == "cpu":
        return table_match_ref(table, state, batch, acting, cond, sets,
                               set_cols, delete)
    _cuda("table_match", dev)
    res, a = table_match_args(table, state, batch, acting, cond, sets,
                              set_cols, delete)
    _kernels.load().table_match(a, _stream(dev))
    _kernels.count_launch("table_match")
    return res


def probe_touched_args(table, state: dict, probe: "IndexProbe",
                       batch: EventBatch, acting):
    """K8 index probe's arguments: -> ((touched, any_hit), args)."""
    dev = batch.ts.device
    B, T = batch.capacity, table.cap
    kt = table.schema.types[probe.attr]
    touched = torch.empty((T,), dtype=torch.bool, device=dev)
    any_hit = torch.empty((B,), dtype=torch.bool, device=dev)
    a = _table_args(table, state, batch, dev)
    fill_prog(a.cond, probe.value, dev)
    mask = acting.contiguous()
    a.mask = mask.data_ptr()
    a.attr = probe.attr
    a.key_type = VT[kt]
    a.big = big_key(kt)
    a.op = ("==", "<", "<=", ">", ">=").index(probe.op)
    a.levels = search_levels(T)
    a.touched = touched.data_ptr()
    a.any_hit = any_hit.data_ptr()
    sc = _sort_scratch(T, dev)
    sc["delta"] = _scratch(T + 1, torch.int32, dev)
    sc["hk"] = _scratch(B, I64, dev)
    sc["adding"] = _scratch(B, torch.uint8, dev)
    _fill_sort(a.sort, sc)
    a.delta, a.hk, a.adding = (sc["delta"].data_ptr(), sc["hk"].data_ptr(),
                               sc["adding"].data_ptr())
    a._keep = (state, touched, any_hit, mask, batch, sc)
    return (touched, any_hit), a


def probe_touched(table, state: dict, probe: "IndexProbe",
                  batch: EventBatch, acting):
    """Kernel K8's index probe (see ``probe_touched_ref``), through the
    key view K7 sorts with. -> (touched [T], any_hit [B])."""
    dev = batch.ts.device
    if dev.type == "cpu":
        return probe_touched_ref(table, state, probe, batch, acting)
    _cuda("table_probe", dev)
    res, a = probe_touched_args(table, state, probe, batch, acting)
    _kernels.load().table_probe(a, _stream(dev))
    _kernels.count_launch("table_probe")
    return res


# ---------------------------------------------------------------------------
# scopes and operators
# ---------------------------------------------------------------------------

class TableOnScope(Scope):
    """Scope of table `on` conditions, SET values and IN-table
    expressions: table attributes resolve to ('T', idx), everything else
    to the event scope's key wrapped as ('S', key)."""

    def __init__(self, table_id: str, table_schema: StreamSchema,
                 event_scope: Scope, table_alias: Optional[str] = None):
        self.table_id = table_id
        self.table_schema = table_schema
        self.event_scope = event_scope
        self.table_alias = table_alias

    def resolve(self, var: A.Variable):
        ref = var.stream_ref
        if ref is not None and ref in (self.table_id, self.table_alias):
            idx = self.table_schema.index_of(var.attribute)
            return ("T", idx), self.table_schema.types[idx]
        if ref is None and var.attribute in self.table_schema.names:
            # a bare name binds to the event side when it has the
            # attribute (`delete T on symbol == T.symbol`: bare `symbol`
            # is the incoming event's, ExpressionParser.java:1330-1339);
            # the table column only when the event scope lacks it
            try:
                key, t = self.event_scope.resolve(var)
                return ("S", key), t
            except (CompileError, KeyError):
                idx = self.table_schema.index_of(var.attribute)
                return ("T", idx), self.table_schema.types[idx]
        key, t = self.event_scope.resolve(var)
        return ("S", key), t

    def clock_key(self, which: str):
        """The event's timestamp (the reference's grid env binds the
        batch's __ts__); the clock raises in grid_env."""
        return ("S", self.event_scope.clock_key(which))


def grid_env(key):
    """A table program's load key -> (side, column): events are side 0,
    table rows side 1 (the reference's [B, 1] / [1, T] grid env)."""
    if key[0] == "T":
        return 1, key[1]
    inner = key[1]
    if inner == ("ts",):
        return 0, TS_COL
    if inner == ("now",):
        raise NotImplementedError(
            "not ported yet: currentTimeMillis() in a table condition")
    if not (isinstance(inner, tuple) and inner[0] == "attr"):
        raise NotImplementedError(
            f"not ported yet: table condition variable {inner!r}")
    return 0, inner[1]


class TableOutputOp(Operator):
    """Terminal operator writing a query's output into a table: insert,
    delete, update, update-or-insert. The batch flows on unchanged."""

    needs_tables = True

    def table_ids(self):
        return (self.table.table_id,)

    def __init__(self, kind: str, table: TableRuntime,
                 on: Optional[A.Expression], set_clause,
                 event_scope: Scope, in_schema: StreamSchema):
        self.kind = kind
        self.table = table
        self.in_schema = in_schema
        self.cond = None
        set_ces, self.set_cols = [], []
        scope = TableOnScope(table.table_id, table.schema, event_scope)
        if on is not None:
            ce = compile_expression(on, scope)
            if ce.type is not AttrType.BOOL:
                raise CompileError("table ON condition must be BOOL")
            self.cond = PairProgram([ce], True, grid_env)
        for var, expr in (set_clause or []):
            tidx = table.schema.index_of(var.attribute)
            ce = compile_expression(expr, scope)
            tt = table.schema.types[tidx]
            if ce.type is not tt:
                # the SET value is written into the table column's dtype
                ce = _widen(ce, tt) if _widens(ce.type, tt) \
                    else _cast_set(ce, tt)
            set_ces.append(ce)
            self.set_cols.append(tidx)
        self.sets = PairProgram(set_ces, False, grid_env) if set_ces \
            else None
        # index rewrite (delete only: updates need each row's source
        # event, which the interval trick cannot give)
        self.index_probe = analyze_index_probe(on, table, event_scope) \
            if (kind == "delete" and on is not None) else None

    @property
    def out_schema(self):
        return self.in_schema

    def step_tables(self, state, batch: EventBatch, now, tstates: dict):
        tid = self.table.table_id
        tstate = tstates[tid]
        acting = batch.valid & (batch.kind == CURRENT)
        if self.kind == "insert":
            tstate = table_write(self.table, tstate, batch, acting)
        elif self.kind == "delete" and self.index_probe is not None:
            touched, _ = probe_touched(self.table, tstate, self.index_probe,
                                       batch, acting)
            tstate = {**tstate, "valid": tstate["valid"] & ~touched}
        elif self.kind == "delete":
            tstate, _ = table_match(self.table, tstate, batch, acting,
                                    self.cond, delete=True)
        else:
            tstate, any_hit = table_match(
                self.table, tstate, batch, acting, self.cond,
                self.sets if self.sets is not None else _NO_SETS,
                self.set_cols)
            if self.kind == "update_or_insert":
                tstate = table_write(self.table, tstate, batch,
                                     acting & ~any_hit)
        return state, batch, {**tstates, tid: tstate}


# an update with nothing to set still walks the rows (it writes no column)
_NO_SETS = PairProgram([], False, grid_env)


def _widens(src: AttrType, dst: AttrType) -> bool:
    order = (AttrType.INT, AttrType.LONG, AttrType.FLOAT, AttrType.DOUBLE)
    return src in order and dst in order and order.index(src) <= \
        order.index(dst)


def _cast_set(ce, t: AttrType):
    raise NotImplementedError(
        f"not ported yet: a SET value of type {ce.type} into a {t} "
        "table column")


@dataclasses.dataclass
class IndexProbe:
    """An index-rewritable condition `T.attr OP <stream expr>` on an
    @Index or @PrimaryKey attribute: the table's key column is sorted
    once and each event answered by two bisections, matched rows marked
    by interval prefix sums (IndexEventHolder's rewrite, done the
    columnar way). ``value`` is a PairProgram over the events (side 0)
    giving the probe value cast to the key's type."""

    attr: int
    op: str                      # attr OP value: '==','<','<=','>','>='
    value: PairProgram


def analyze_index_probe(on_ast, table: TableRuntime,
                        event_scope: Scope) -> Optional[IndexProbe]:
    """One comparison on an indexed attribute -> IndexProbe, else None
    (the [B, T] condition pass)."""
    if not isinstance(on_ast, A.Compare) or on_ast.op == "!=":
        return None
    indexed = set(table.indexes) | set(table.pk)
    if not indexed:
        return None

    def table_attr(e) -> Optional[int]:
        if not isinstance(e, A.Variable) or e.index is not None:
            return None
        if e.stream_ref == table.table_id:
            return table.schema.index_of(e.attribute) \
                if e.attribute in table.schema.names else None
        if e.stream_ref is None and e.attribute in table.schema.names:
            try:
                event_scope.resolve(e)
                return None     # a bare name binds to the event side
            except CompileError:
                return table.schema.index_of(e.attribute)
        return None

    la, ra = table_attr(on_ast.left), table_attr(on_ast.right)
    if (la is None) == (ra is None):
        return None              # exactly one table side
    if la is not None:
        attr, op, other = la, on_ast.op, on_ast.right
    else:
        flip = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "==": "=="}
        attr, op, other = ra, flip[on_ast.op], on_ast.left
    if attr not in indexed:
        return None
    try:
        ce = compile_expression(other, event_scope)
    except CompileError:
        return None
    if ce.type is AttrType.BOOL:
        return None
    # the probe compares in the KEY dtype: eligible only where casting
    # the stream value into it is exact (a DOUBLE 2.5 against an int key
    # must not truncate to 2)
    kt = table.schema.types[attr]
    key_dt, val_dt = np.dtype(np_dtype(kt)), np.dtype(np_dtype(ce.type))
    if np.promote_types(key_dt, val_dt) != key_dt:
        return None
    ce = _widen(ce, kt)
    return IndexProbe(attr, op, PairProgram([ce], False, _event_column))


def _event_column(key):
    """A probe value's load key (a column of the events) -> (0, col)."""
    if not isinstance(key, int):
        raise NotImplementedError(f"not ported yet: probe value key {key!r}")
    return 0, key


class InTableRewriter:
    """Extracts `expr IN table` subexpressions from a filter, replacing
    each with a bool column appended to the batch (``__in_<k>__``: its
    containment result, InConditionExpressionExecutor)."""

    def __init__(self, tables: dict, event_scope: Scope):
        self.tables = tables
        self.event_scope = event_scope
        self.found: list = []  # (TableRuntime, PairProgram, IndexProbe)

    def rewrite(self, expr: A.Expression) -> A.Expression:
        if isinstance(expr, A.InTable):
            tr = self.tables.get(expr.table_id)
            if tr is None:
                raise CompileError(f"undefined table '{expr.table_id}'")
            scope = TableOnScope(tr.table_id, tr.schema, self.event_scope)
            ce = compile_expression(expr.expr, scope)
            if ce.type is not AttrType.BOOL:
                raise CompileError("IN <table> expression must be BOOL")
            probe = analyze_index_probe(expr.expr, tr, self.event_scope)
            k = len(self.found)
            self.found.append((tr, PairProgram([ce], True, grid_env), probe))
            return A.Variable(attribute=f"__in_{k}__")
        if isinstance(expr, A.MathOp):
            return A.MathOp(expr.op, self.rewrite(expr.left),
                            self.rewrite(expr.right))
        if isinstance(expr, A.Compare):
            return A.Compare(expr.op, self.rewrite(expr.left),
                             self.rewrite(expr.right))
        if isinstance(expr, A.And):
            return A.And(self.rewrite(expr.left), self.rewrite(expr.right))
        if isinstance(expr, A.Or):
            return A.Or(self.rewrite(expr.left), self.rewrite(expr.right))
        if isinstance(expr, A.Not):
            return A.Not(self.rewrite(expr.expr))
        if isinstance(expr, A.IsNull) and expr.expr is not None:
            return A.IsNull(expr=self.rewrite(expr.expr))
        return expr


class InTableScope(Scope):
    """The rewritten filter's scope: ``__in_<k>__`` reads the k-th
    containment column, appended after the stream's ``n`` columns."""

    def __init__(self, base: Scope, n: int):
        self.base = base
        self.n = n

    def resolve(self, var: A.Variable):
        if var.stream_ref is None and var.attribute and \
                var.attribute.startswith("__in_") and \
                var.attribute.endswith("__"):
            return ("attr", self.n + int(var.attribute[5:-2])), \
                AttrType.BOOL
        return self.base.resolve(var)


class TableFilterOp(Operator):
    """A filter whose condition holds IN-table containment: each
    containment is a K8 pass (an index probe or the condition pass), then
    the condition runs through K2 over the batch with the containment
    columns appended."""

    needs_tables = True

    def table_ids(self):
        return tuple(tr.table_id for tr, _, _ in self.contains)

    def __init__(self, cond_ast: A.Expression, schema: StreamSchema,
                 tables: dict, event_scope: Scope):
        rewriter = InTableRewriter(tables, event_scope)
        rewritten = rewriter.rewrite(cond_ast)
        self.contains = rewriter.found
        cond = compile_expression(
            rewritten, InTableScope(event_scope, len(schema.types)))
        if cond.type is not AttrType.BOOL:
            raise CompileError("filter must be BOOL")
        b = ProgramBuilder()
        b.keep(cond)
        b.timer_pass = True
        self.prog = b.build()
        self.schema = schema

    @property
    def out_schema(self):
        return self.schema

    def step_tables(self, state, batch: EventBatch, now, tstates: dict):
        B = batch.capacity
        hits = []
        for tr, prog, probe in self.contains:
            tstate = tstates[tr.table_id]
            if probe is not None:
                _, any_hit = probe_touched(tr, tstate, probe, batch,
                                           batch.valid)
            else:
                _, any_hit = table_match(tr, tstate, batch, None, prog)
            hits.append(any_hit)
        zeros = torch.zeros((B,), dtype=torch.bool, device=batch.ts.device)
        ext = EventBatch(batch.ts, tuple(batch.cols) + tuple(hits),
                         tuple(batch.nulls) + (zeros,) * len(hits),
                         batch.kind, batch.valid)
        _c, _n, valid = expr_eval(self.prog, ext, now=now)
        return state, EventBatch(batch.ts, batch.cols, batch.nulls,
                                 batch.kind, valid), tstates


def expr_mentions_table(expr: A.Expression) -> bool:
    if isinstance(expr, A.InTable):
        return True
    if isinstance(expr, (A.MathOp, A.Compare, A.And, A.Or)):
        return expr_mentions_table(expr.left) or \
            expr_mentions_table(expr.right)
    if isinstance(expr, A.Not):
        return expr_mentions_table(expr.expr)
    if isinstance(expr, A.IsNull) and expr.expr is not None:
        return expr_mentions_table(expr.expr)
    return False
