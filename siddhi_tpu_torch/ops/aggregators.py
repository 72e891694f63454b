"""Attribute aggregators and the aggregating selector (PyTorch port of
siddhi_tpu/ops/aggregators.py): kernel K6 of PERF.md.

Reference mapping:
- query/selector/attribute/aggregator/*.java (sum, avg, count, min, max,
  minForever, maxForever, stdDev, and, or): per-event state machines
  with processAdd / processRemove / reset by event type;
- query/selector/QuerySelector.java:44: processGroupBy and, for batch
  windows, processInBatchGroupBy (only the last event, or the last per
  group, of a flush chunk is emitted);
- RESET clears every group's state (PartitionStateHolder.java:95).

An aggregator is a set of LANES, each an accumulator with an
associative combine (sum / min / max). A step over a batch:

  1. per-row signed lane contributions (CURRENT adds, EXPIRED removes);
  2. each row's group slot (hash of the group-by columns, open
     addressing in a [K] table) and reset segment (RESET rows so far);
  3. rows ordered by slot (stable), a segmented prefix scan per lane in
     the reference's own addition order, the slot's carry added in, the
     order undone: each row's running aggregate;
  4. the new [K] carries: each slot's contributions in its last reset
     segment, folded in row order;
  5. projection and having (kernel K2 over the input and aggregate
     columns), then the rows that qualify, ordered and cut by offset and
     limit; in batch mode the last qualifying row per (slot, flush chunk).

``aggregate_step`` (2-4 and the value functions) and ``aggregate_emit``
(5, after K2) are K6. For tensors on the CPU they run
``aggregate_step_ref`` and ``aggregate_emit_ref``, the plain PyTorch
versions, which follow the reference's ``AggregateOp.step`` line by line;
for CUDA tensors they launch csrc/aggregate_step.cu. Group-by keys and
aggregate arguments that are not bare columns, and the filters before
the selector, run in one K2 program first.

The stateful aggregators, whose state is not a [K] accumulator, keep a
table of their own in the query state: min()/max() over expiring content
(SlidingMinMaxAgg, kernel C), distinctCount() (DistinctCountAgg, kernel
D) and unionSet() (UnionSetAgg, kernel H, whose value is a
[B, 1 + SET_LANES] set column), all launched between K6's slot sort and
its lanes. With an order-by the emission keeps the qualifying rows in
row order and kernel G (ops/selector.py shape_chunk) orders, offsets and
limits them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import _kernels
from ..analysis.schema import aggregator_result_type
from ..core.event import (CURRENT, EXPIRED, RESET, Attribute, EventBatch,
                          StreamSchema)
from ..core.types import NUMERIC_TYPES, SET_EMPTY, SET_LANES, AttrType, \
    flush_subnormal, row_bytes, torch_dtype
from ..lang import ast as A
from .expr import (DTYPE_VT, OP_LOAD, CompiledExpr, CompileError,
                   ProgramBuilder, Scope, compile_expression, expr_eval)
from .keyed import (add, fma, hash_columns, lookup_or_insert, maximum,
                    minimum, segmented_cumsum, segmented_cummax,
                    segmented_cummin)
from .operators import Operator
from .slots import part_moves, per_slot, stack, unstack
from .selector import (AGGREGATOR_NAMES, compile_order_by, const_int,
                       output_attribute_name, shape_chunk, shape_output)

I64 = torch.int64
F64 = torch.float64


def not_ported(what: str):
    return NotImplementedError(f"not ported yet: {what}")


# ---------------------------------------------------------------------------
# lanes and aggregator specs
# ---------------------------------------------------------------------------

# lane ops and accumulator types, numbered as csrc/siddhi_kernels.h
LANE_SUM, LANE_MIN, LANE_MAX = 0, 1, 2
LANE_OPS = {"sum": LANE_SUM, "min": LANE_MIN, "max": LANE_MAX}


@dataclasses.dataclass
class Lane:
    op: str            # 'sum' | 'min' | 'max'
    dtype: torch.dtype

    def identity(self, dev="cpu"):
        if self.op == "sum":
            return torch.zeros((), dtype=self.dtype, device=dev)
        if self.dtype.is_floating_point:
            v = float("inf") if self.op == "min" else float("-inf")
        else:
            info = torch.iinfo(self.dtype)
            v = info.max if self.op == "min" else info.min
        return torch.tensor(v, dtype=self.dtype, device=dev)

    def combine(self, a, b):
        if self.op == "sum":
            return add(a, b)
        return minimum(a, b) if self.op == "min" else maximum(a, b)

    def segmented_scan(self, vals, seg_ids):
        if self.op == "sum":
            return segmented_cumsum(vals, seg_ids)
        if self.op == "min":
            return segmented_cummin(vals, seg_ids)
        return segmented_cummax(vals, seg_ids)


def _widen(values, dtype):
    """astype as the reference's compiled code does it: FLOAT -> DOUBLE
    reads a subnormal as zero."""
    if values.dtype == torch.float32 and dtype == F64:
        return flush_subnormal(values).to(F64)
    return values.to(dtype)


def _signed(x, is_add, is_remove):
    return torch.where(is_add, x, torch.where(is_remove, -x,
                                              torch.zeros_like(x)))


def _mul(x, y):
    if x.is_floating_point():
        return flush_subnormal(flush_subnormal(x) * flush_subnormal(y))
    return x * y


def _div(x, y):
    return flush_subnormal(flush_subnormal(x) / flush_subnormal(y))


def _sqrt(x):
    """IEEE square root, correctly rounded: torch's vectorised CPU sqrt
    can be one unit in the last place off, numpy's (the hardware's) and
    the card's are not."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.numpy()))
    return torch.sqrt(x)


class AggSpec:
    """One aggregator call in a select clause. ``KIND`` numbers it as
    csrc/aggregate_step.cu does."""

    name: str
    out_type: AttrType
    lanes: tuple
    KIND = -1

    def contribs(self, arg, is_add, is_remove):
        """Per-lane [B] contributions (identity where no effect); ``arg``
        is (values, nulls) or None."""
        raise NotImplementedError

    def value(self, lane_vals):
        """-> (values, nulls) from the running lane values."""
        raise NotImplementedError


class SumAgg(AggSpec):
    """sum(): (sum, count); null when the count is 0."""
    KIND = 0

    def __init__(self, arg_type: AttrType):
        if arg_type not in NUMERIC_TYPES:
            raise CompileError(f"sum() requires numeric input, got {arg_type}")
        self.name = "sum"
        self.out_type = aggregator_result_type("sum", arg_type)
        self.acc_dtype = torch_dtype(self.out_type)
        self.lanes = (Lane("sum", self.acc_dtype), Lane("sum", I64))

    def contribs(self, arg, is_add, is_remove):
        values, nulls = arg
        eff = (is_add | is_remove) & ~nulls
        x = torch.where(eff, _widen(values, self.acc_dtype),
                        torch.zeros((), dtype=self.acc_dtype,
                                    device=values.device))
        one = eff.to(I64)
        return (_mul(_signed(x, is_add, is_remove), eff.to(self.acc_dtype)),
                _signed(one, is_add, is_remove))

    def value(self, lane_vals):
        s, cnt = lane_vals
        return torch.where(cnt == 0, torch.zeros_like(s), s), cnt == 0


class AvgAgg(AggSpec):
    """avg(): sum / count as DOUBLE; null when the count is 0."""
    KIND = 1

    def __init__(self, arg_type: AttrType):
        if arg_type not in NUMERIC_TYPES:
            raise CompileError(f"avg() requires numeric input, got {arg_type}")
        self.name = "avg"
        self.out_type = aggregator_result_type("avg", arg_type)
        self.lanes = (Lane("sum", F64), Lane("sum", I64))

    def contribs(self, arg, is_add, is_remove):
        values, nulls = arg
        eff = (is_add | is_remove) & ~nulls
        x = torch.where(eff, _widen(values, F64),
                        torch.zeros((), dtype=F64, device=values.device))
        return (_signed(x, is_add, is_remove),
                _signed(eff.to(I64), is_add, is_remove))

    def value(self, lane_vals):
        s, cnt = lane_vals
        safe = torch.clamp(cnt, min=1).to(F64)
        return (torch.where(cnt == 0, torch.zeros_like(s), _div(s, safe)),
                cnt == 0)


class CountAgg(AggSpec):
    """count(): the event count, LONG, never null."""
    KIND = 2

    def __init__(self):
        self.name = "count"
        self.out_type = aggregator_result_type("count", None)
        self.lanes = (Lane("sum", I64),)

    def contribs(self, arg, is_add, is_remove):
        return (_signed((is_add | is_remove).to(I64), is_add, is_remove),)

    def value(self, lane_vals):
        (cnt,) = lane_vals
        return cnt, torch.zeros_like(cnt, dtype=torch.bool)


class StdDevAgg(AggSpec):
    """stdDev(): the population standard deviation from (sum, sum of
    squares, count), sqrt(max(E[x^2] - mean^2, 0)); null when the count
    is 0."""
    KIND = 3

    def __init__(self, arg_type: AttrType):
        if arg_type not in NUMERIC_TYPES:
            raise CompileError(
                f"stdDev() requires numeric input, got {arg_type}")
        self.name = "stdDev"
        self.out_type = aggregator_result_type("stddev", arg_type)
        self.lanes = (Lane("sum", F64), Lane("sum", F64), Lane("sum", I64))

    def contribs(self, arg, is_add, is_remove):
        values, nulls = arg
        eff = (is_add | is_remove) & ~nulls
        x = torch.where(eff, _widen(values, F64),
                        torch.zeros((), dtype=F64, device=values.device))
        return (_signed(x, is_add, is_remove),
                _signed(_mul(x, x), is_add, is_remove),
                _signed(eff.to(I64), is_add, is_remove))

    def value(self, lane_vals):
        s, ss, cnt = lane_vals
        n = torch.clamp(cnt, min=1).to(F64)
        mean = _div(s, n)
        # ss / n - mean * mean, contracted into one fused multiply-add
        # by the reference's compiler
        m = flush_subnormal(mean)
        var = maximum(flush_subnormal(fma(-m, m, _div(ss, n))),
                      torch.zeros_like(s))
        return (torch.where(cnt == 0, torch.zeros_like(s),
                            flush_subnormal(_sqrt(var))), cnt == 0)


class MinMaxAgg(AggSpec):
    """min()/max() over content that never expires (a running extreme
    with RESET segmentation)."""
    KIND = 4

    def __init__(self, arg_type: AttrType, is_max: bool):
        if arg_type not in NUMERIC_TYPES:
            raise CompileError("min()/max() requires numeric input")
        self.name = "max" if is_max else "min"
        self.out_type = aggregator_result_type(self.name, arg_type)
        self.dtype = torch_dtype(arg_type)
        self.lanes = (Lane("max" if is_max else "min", self.dtype),
                      Lane("sum", I64))

    def _eff(self, is_add, is_remove):
        return is_add

    def contribs(self, arg, is_add, is_remove):
        values, nulls = arg
        eff = self._eff(is_add, is_remove) & ~nulls
        x = torch.where(eff, values.to(self.dtype),
                        self.lanes[0].identity(values.device))
        return x, eff.to(I64)

    def value(self, lane_vals):
        m, cnt = lane_vals
        return torch.where(cnt == 0, torch.zeros_like(m), m), cnt == 0


class ForeverMinMaxAgg(MinMaxAgg):
    """minForever()/maxForever(): EXPIRED events tighten the extreme too."""
    KIND = 5

    def __init__(self, arg_type: AttrType, is_max: bool):
        super().__init__(arg_type, is_max)
        self.name = "maxForever" if is_max else "minForever"

    def _eff(self, is_add, is_remove):
        return is_add | is_remove


class BoolAgg(AggSpec):
    """and()/or() over BOOL: counts of true and false values."""
    KIND = 6

    def __init__(self, arg_type: AttrType, is_and: bool):
        if arg_type is not AttrType.BOOL:
            raise CompileError("and()/or() requires BOOL input")
        self.name = "and" if is_and else "or"
        self.is_and = is_and
        self.out_type = aggregator_result_type(self.name, arg_type)
        self.lanes = (Lane("sum", I64), Lane("sum", I64))

    def contribs(self, arg, is_add, is_remove):
        values, nulls = arg
        eff = (is_add | is_remove) & ~nulls
        t = (eff & values).to(I64)
        f = (eff & ~values).to(I64)
        return (_signed(t, is_add, is_remove), _signed(f, is_add, is_remove))

    def value(self, lane_vals):
        t, f = lane_vals
        v = (f == 0) if self.is_and else (t > 0)
        return v, torch.zeros_like(v)


def _tree_levels(w: int) -> int:
    return int(w).bit_length() - 1


class SlidingMinMaxAgg(AggSpec):
    """min()/max() over sliding-window content (with removals).

    Window expiry is FIFO (clones expire in arrival order), so a key's
    live values are a contiguous per-key sequence range [head, tail).
    Values land in a per-key ring of W; each row's extreme is a range
    query over an implicit segment tree built once a step over the rings
    ([K, 2W], index 1 the root, the ring at [W, 2W)). Live content beyond
    W drops off the extreme and is counted (``overflow``). ``run_ref`` is
    the plain version of kernel C (csrc/aggregate_step.cu
    siddhi_sliding_minmax), which aggregate_step launches on a CUDA
    batch between K6's slot sort and its lanes."""
    KIND = 7
    stateful = True

    def __init__(self, arg_type: AttrType, is_max: bool, grouped: bool):
        if arg_type not in NUMERIC_TYPES:
            raise CompileError("min()/max() requires numeric input")
        self.name = "max" if is_max else "min"
        self.is_max = is_max
        self.out_type = aggregator_result_type(self.name, arg_type)
        self.dtype = torch_dtype(arg_type)
        self.W = 256 if grouped else 4096      # ring capacity per key
        self.lanes = (Lane("max" if is_max else "min", self.dtype),
                      Lane("sum", I64))

    def init_table(self, K: int, device="cpu"):
        return {"ring": self.lanes[0].identity(device).expand(
                    K, self.W).clone(),
                "heads": torch.zeros((K,), dtype=I64, device=device),
                "tails": torch.zeros((K,), dtype=I64, device=device),
                "overflow": torch.zeros((), dtype=I64, device=device)}

    def run_ref(self, arg, ctx, tab):
        """Plain version of kernel C: the reference's
        ``SlidingMinMaxAgg.run``, the tree indexed in place of the
        reference's per-row gather of a key's whole tree. -> ((extreme,
        count) per row, table')."""
        B, K, W = ctx["B"], ctx["K"], self.W
        values, nulls = arg
        dev = values.device
        lane = self.lanes[0]
        ident = lane.identity(dev)
        slots = torch.clamp(ctx["slots"], 0, K - 1).to(I64)
        agg_row = ctx["agg_row"]
        is_add = ctx["is_add"] & agg_row & ~nulls
        is_remove = ctx["is_remove"] & agg_row & ~nulls
        # RESET clears all state: heads := tails, before the whole batch
        heads0 = torch.where(ctx["n_resets"] > 0, tab["tails"], tab["heads"])
        perm, inv_perm = ctx["perm"], ctx["inv_perm"]
        gseg = ctx["slot_sorted"].to(I64)
        add_rank = segmented_cumsum(is_add[perm].to(I64), gseg)[inv_perm]
        rem_rank = segmented_cumsum(is_remove[perm].to(I64), gseg)[inv_perm]
        tail_row = tab["tails"][slots] + add_rank
        head_row = heads0[slots] + rem_rank
        over = torch.clamp(tail_row - head_row - W, min=0)
        head_eff = head_row + over
        n_adds = torch.zeros((K,), dtype=I64, device=dev).index_add(
            0, slots, is_add.to(I64))
        n_rems = torch.zeros((K,), dtype=I64, device=dev).index_add(
            0, slots, is_remove.to(I64))
        new_tails = tab["tails"] + n_adds
        end_tail = new_tails[slots]
        # the batch's added values into the rings; of two adds of a key W
        # apart the later one stays, as the reference's in-order scatter
        # leaves it
        pos = torch.remainder(tail_row - 1, W)
        wr = is_add & (tail_row > end_tail - W)
        ring = tab["ring"].clone()
        ring.view(-1)[(slots * W + pos)[wr]] = values.to(self.dtype)[wr]
        levels, cur = [ring], ring
        for _ in range(_tree_levels(W)):
            cur = lane.combine(cur[:, 0::2], cur[:, 1::2])
            levels.append(cur)
        tree = torch.cat([ident.expand(K, 1)] + levels[::-1], dim=1)
        flat = tree.reshape(-1)
        base = slots * (2 * W)

        def rmq(a, b):
            res = ident.expand(B).clone()
            li, ri = a + W, b + W
            for _ in range(_tree_levels(W) + 1):
                take_l = (li < ri) & ((li & 1) == 1)
                vl = flat[base + torch.where(take_l, li, 1)]
                res = torch.where(take_l, lane.combine(res, vl), res)
                li = torch.where(take_l, li + 1, li)
                take_r = (li < ri) & ((ri & 1) == 1)
                vr = flat[base + torch.where(take_r, ri - 1, 1)]
                res = torch.where(take_r, lane.combine(res, vr), res)
                ri = torch.where(take_r, ri - 1, ri)
                li, ri = li >> 1, ri >> 1
            return res

        # the ring range may wrap: two non-wrapping leaf ranges
        span = torch.clamp(tail_row - head_eff, min=0)
        h = torch.remainder(head_eff, W)
        end = h + torch.clamp(span, max=W)
        res = lane.combine(rmq(h, torch.clamp(end, max=W)),
                           rmq(torch.zeros_like(h),
                               torch.clamp(end - W, min=0)))
        over_rows = agg_row & (end_tail - head_eff > W)
        if "row_part" in ctx:   # run_slots: a count a slot
            overflow_rows = torch.zeros_like(tab["overflow"]).index_add(
                0, ctx["row_part"], over_rows.to(I64))
        else:
            overflow_rows = over_rows.sum(dtype=I64)
        new_heads = torch.maximum(heads0 + n_rems, new_tails - W)
        return (res, span), {"ring": ring, "heads": new_heads,
                             "tails": new_tails,
                             "overflow": tab["overflow"] + overflow_rows}

    def run_slots(self, arg, ctxs: list, tab):
        """The plain version of kernel C over a slot axis (what
        aggregate_step_ref runs for a partition block's or a tenant
        pool's slots): ``run_ref`` in one call, bit-equal to it run once
        per slot: slot s's K keys become keys s * K .. s * K + K - 1 of
        one table of S * K keys, its B rows rows s * B .. of S * B, and
        each row's overflow goes to its own slot's count; ``ctxs`` are
        the slots' own contexts (agg_context), ``arg`` and ``tab``
        slotted. -> ((extreme, count) [S, B], table' slotted)."""
        S = len(ctxs)
        B, K = ctxs[0]["B"], ctxs[0]["K"]
        dev = arg[0].device
        part = torch.arange(S, dtype=I64, device=dev)
        slots = torch.stack([c["slots"].to(I64) for c in ctxs])   # [S, B]
        # a row keeps its own slot's clamp, and its segment: the rows
        # without a key (slot K) in a segment of their own a slot
        key = part[:, None] * K + torch.clamp(slots, 0, K - 1)
        seg = part[:, None] * (K + 1) + slots
        perm = torch.argsort(seg.reshape(-1), stable=True)
        n_resets = torch.stack([c["n_resets"] for c in ctxs])

        def cat(k):
            return torch.stack([c[k] for c in ctxs]).reshape(-1)
        ctx = {"B": S * B, "K": S * K, "slots": key.reshape(-1),
               "agg_row": cat("agg_row"), "is_add": cat("is_add"),
               "is_remove": cat("is_remove"),
               "n_resets": n_resets.repeat_interleave(K),
               "perm": perm, "inv_perm": torch.argsort(perm, stable=True),
               "slot_sorted": seg.reshape(-1)[perm],
               "row_part": part.repeat_interleave(B)}
        flat = {k: tab[k].reshape((S * K,) + tuple(tab[k].shape[2:]))
                for k in ("ring", "heads", "tails")}
        flat["overflow"] = tab["overflow"]
        (res, span), new = self.run_ref(
            (arg[0].reshape(-1), arg[1].reshape(-1)), ctx, flat)
        new = {k: (v if k == "overflow" else
                   v.reshape((S, K) + tuple(v.shape[1:])))
               for k, v in new.items()}
        return (res.reshape(S, B), span.reshape(S, B)), new

    def value(self, lane_vals):
        m, cnt = lane_vals
        return torch.where(cnt == 0, torch.zeros_like(m), m), cnt == 0


class DistinctCountAgg(AggSpec):
    """distinctCount(): the exact count of distinct values per group,
    with removals. One open-addressing table of D (group, value) pairs
    holds each pair's multiplicity; a row's 0<->1 transition (+1 on the
    first add, -1 on the last remove) feeds an ordinary sum lane over
    (group, reset) segments with a [K] carry. Pair slots are never
    freed: pairs beyond D are dropped and counted (``overflow``).
    ``run_ref`` is the plain version of kernel D (csrc/aggregate_step.cu
    siddhi_distinct_count), which aggregate_step launches on a CUDA batch
    between K6's slot sort and its lanes."""
    KIND = 8
    stateful = True
    D = 4096

    def __init__(self, arg_type: AttrType):
        if arg_type is None:
            raise CompileError("distinctCount() needs an argument")
        self.name = "distinctCount"
        self.out_type = aggregator_result_type("distinctcount", arg_type)
        self.lanes = (Lane("sum", I64),)

    def init_table(self, K: int, device="cpu"):
        return {"keys": torch.zeros((self.D,), dtype=I64, device=device),
                "used": torch.zeros((self.D,), dtype=torch.bool,
                                    device=device),
                "counts": torch.zeros((self.D,), dtype=I64, device=device),
                "carry": torch.zeros((K,), dtype=I64, device=device),
                "overflow": torch.zeros((), dtype=I64, device=device)}

    def run_ref(self, arg, ctx, tab):
        """Plain version of kernel D: the reference's
        ``DistinctCountAgg.run``. -> ((distinct count,) per row, table')."""
        B, K, D = ctx["B"], ctx["K"], self.D
        values, nulls = arg
        dev = values.device
        slots, agg_row = ctx["slots"], ctx["agg_row"]
        is_add, is_remove = ctx["is_add"], ctx["is_remove"]
        reset_seg, n_resets = ctx["reset_seg"], ctx["n_resets"]
        ph = hash_columns([slots.to(I64), values],
                          [torch.zeros_like(nulls), nulls])
        pslots, pkeys, pused, ovf = lookup_or_insert(tab["keys"], tab["used"],
                                                     ph, agg_row)
        tracked = agg_row & (pslots >= 0)
        one = torch.ones((B,), dtype=I64, device=dev)
        zero = torch.zeros((B,), dtype=I64, device=dev)
        sgn = torch.where(tracked & is_add, one,
                          torch.where(tracked & is_remove, -one, zero))
        ps_safe = torch.clamp(pslots, 0, D - 1).to(I64)
        pair_seg = torch.where(tracked, ps_safe, torch.full_like(ps_safe, D)) \
            * (B + 1) + reset_seg
        perm2 = torch.argsort(torch.clamp(pair_seg, 0, 2 ** 31 - 1).to(
            torch.int32), stable=True)
        inv2 = torch.argsort(perm2, stable=True)
        seg_s = pair_seg[perm2]
        run_s = segmented_cumsum(sgn[perm2], seg_s)
        carry_pair = torch.where((reset_seg == 0) & tracked,
                                 tab["counts"][ps_safe], zero)
        run = run_s[inv2] + carry_pair
        delta = torch.where(tracked & is_add & (run == 1), one,
                            torch.where(tracked & is_remove & (run == 0),
                                        -one, zero))
        # new pair counts: each pair's last running count in the LAST
        # reset segment (pairs untouched after a reset drop to 0)
        new_counts = torch.where(n_resets == 0, tab["counts"],
                                 torch.zeros_like(tab["counts"]))
        is_last_s = torch.ones((B,), dtype=torch.bool, device=dev)
        is_last_s[:-1] = seg_s[:-1] != seg_s[1:]
        pair_last = is_last_s[inv2] & tracked & (reset_seg == n_resets)
        new_counts[ps_safe[pair_last]] = run[pair_last]
        # the distinct count per row: the deltas scanned over (group, reset)
        pref = segmented_cumsum(delta[ctx["perm"]], ctx["seg_sorted"])
        slot_safe = torch.clamp(ctx["slot_sorted"], 0, K - 1).to(I64)
        cin = torch.where(ctx["segzero_sorted"], tab["carry"][slot_safe],
                          torch.zeros_like(pref))
        running = (cin + pref)[ctx["inv_perm"]]
        last_mask = (reset_seg == n_resets) & tracked
        base = torch.where(n_resets == 0, tab["carry"],
                           torch.zeros_like(tab["carry"]))
        new_carry = base.index_add(0, slots[last_mask].to(I64),
                                   delta[last_mask])
        return (running,), {"keys": pkeys, "used": pused,
                            "counts": new_counts, "carry": new_carry,
                            "overflow": tab["overflow"] + ovf}

    def value(self, lane_vals):
        (d,) = lane_vals
        return d, torch.zeros_like(d, dtype=torch.bool)


class UnionSetAgg(AggSpec):
    """unionSet(): the union of the rows' sets, with removals
    (UnionSetAttributeAggregatorExecutor.java:43 keeps a Set and a
    value -> count map for the expired decrement).

    A bounded table of SET_LANES (value, multiplicity) entries. A step
    merges the table (unless a reset wiped it) and every lane of the
    step's rows (+1 added, -1 removed, 0 otherwise) by value, sums each
    distinct value's multiplicities, and keeps the SET_LANES smallest
    live values (total > 0) by signed int64 order; the rest are counted
    (``overflow``). Every row of the step observes the end-of-step union
    (exact for batch windows, chunk-granular for sliding ones); the tag
    is the running max. Ungrouped only. ``run_ref`` is the plain version
    of kernel H (csrc/union_set.cu), which aggregate_step launches on a
    CUDA batch between K6's two parts."""
    KIND = 9
    stateful = True

    def __init__(self, arg_type: AttrType, grouped: bool):
        if arg_type is not AttrType.OBJECT:
            raise CompileError(
                "Parameter passed to unionSet aggregator should be a set "
                "object (createSet() result)")
        if grouped:
            raise CompileError(
                "unionSet() with group by is not supported yet")
        self.name = "unionSet"
        self.out_type = aggregator_result_type("unionset", arg_type)
        # the reference's one [K] lane: its carry rides along untouched
        self.lanes = (Lane("sum", I64),)
        # kernel H's compacted pairs' arrays, by device: (slots, pairs a
        # slot, arrays), grown only when a step keeps more (union_args)
        self.compact: dict = {}

    def init_table(self, K: int, device="cpu"):
        return {"vals": torch.full((SET_LANES,), SET_EMPTY, dtype=I64,
                                   device=device),
                "counts": torch.zeros((SET_LANES,), dtype=I64,
                                      device=device),
                "tag": torch.zeros((), dtype=I64, device=device),
                "overflow": torch.zeros((), dtype=I64, device=device)}

    def run_ref(self, arg, ctx, tab):
        """Plain version of kernel H: the reference's ``UnionSetAgg.run``.
        -> (([B, 1 + SET_LANES] union per row,), table')."""
        S = SET_LANES
        values, nulls = arg
        dev = values.device
        eff = ctx["agg_row"] & ~nulls & (ctx["reset_seg"] == ctx["n_resets"])
        one = torch.ones_like(ctx["reset_seg"])
        sgn_row = torch.where(eff & ctx["is_add"], one, torch.where(
            eff & ctx["is_remove"], -one, torch.zeros_like(one)))
        flat_vals = values[:, 1:].reshape(-1)
        flat_sgn = torch.where(flat_vals == SET_EMPTY,
                               torch.zeros_like(flat_vals),
                               sgn_row.repeat_interleave(S))
        keep_tab = ctx["n_resets"] == 0
        all_vals = torch.cat([torch.where(
            keep_tab, tab["vals"], torch.full_like(tab["vals"], SET_EMPTY)),
            flat_vals])
        all_sgn = torch.cat([torch.where(keep_tab, tab["counts"],
                                         torch.zeros_like(tab["counts"])),
                             flat_sgn])
        # distinct values in signed order and their total multiplicities
        v_s, order = torch.sort(all_vals)
        uniq, inv = torch.unique_consecutive(v_s, return_inverse=True)
        totals = torch.zeros(uniq.shape, dtype=I64, device=dev).index_add_(
            0, inv, all_sgn[order])
        live = (totals > 0) & (uniq != SET_EMPTY)
        n_live = live.sum(dtype=I64)
        kept_vals, kept_cnt = uniq[live][:S], totals[live][:S]
        new_vals = torch.full((S,), SET_EMPTY, dtype=I64, device=dev)
        new_cnt = torch.zeros((S,), dtype=I64, device=dev)
        new_vals[:kept_vals.shape[0]] = kept_vals
        new_cnt[:kept_cnt.shape[0]] = kept_cnt
        tag = torch.maximum(tab["tag"], torch.where(
            eff, values[:, 0], torch.zeros_like(values[:, 0])).max())
        new_tab = {"vals": new_vals, "counts": new_cnt, "tag": tag,
                   "overflow": tab["overflow"]
                   + torch.clamp(n_live - S, min=0)}
        running = torch.cat([tag[None], new_vals]).expand(
            values.shape[0], S + 1)
        return (running,), new_tab

    def value(self, lane_vals):
        (v,) = lane_vals
        return v, torch.zeros(v.shape[:1], dtype=torch.bool, device=v.device)


def make_agg_spec(name: str, arg_type: Optional[AttrType],
                  expired_possible: bool, grouped: bool = False,
                  fifo_expiry: bool = True) -> AggSpec:
    key = name.lower()
    if key == "sum":
        return SumAgg(arg_type)
    if key == "avg":
        return AvgAgg(arg_type)
    if key == "count":
        return CountAgg()
    if key == "stddev":
        return StdDevAgg(arg_type)
    if key in ("min", "max"):
        if expired_possible and not fifo_expiry:
            raise CompileError(
                f"{key}() over a window with non-FIFO expiry (sort/"
                "frequent/lossyFrequent) is not supported — the sliding "
                "extreme relies on arrival-order expiry")
        if expired_possible:
            return SlidingMinMaxAgg(arg_type, key == "max", grouped)
        return MinMaxAgg(arg_type, key == "max")
    if key in ("minforever", "maxforever"):
        return ForeverMinMaxAgg(arg_type, key == "maxforever")
    if key in ("and", "or"):
        return BoolAgg(arg_type, key == "and")
    if key == "distinctcount":
        return DistinctCountAgg(arg_type)
    if key == "unionset":
        return UnionSetAgg(arg_type, grouped)
    raise CompileError(f"unknown aggregator '{name}'")


# ---------------------------------------------------------------------------
# AST rewrite: aggregator calls -> placeholder variables
# ---------------------------------------------------------------------------


def extract_aggregators(expr: A.Expression, found: list) -> A.Expression:
    """Replace aggregator calls with __agg_<i>__ variables, collecting the
    (name, arg asts, star) list."""
    if isinstance(expr, A.AttributeFunction):
        if expr.namespace is None and expr.name.lower() in AGGREGATOR_NAMES:
            idx = len(found)
            found.append((expr.name, list(expr.parameters), expr.star))
            return A.Variable(attribute=f"__agg_{idx}__")
        return A.AttributeFunction(
            expr.namespace, expr.name,
            [extract_aggregators(p, found) for p in expr.parameters],
            expr.star)
    if isinstance(expr, A.MathOp):
        return A.MathOp(expr.op, extract_aggregators(expr.left, found),
                        extract_aggregators(expr.right, found))
    if isinstance(expr, A.Compare):
        return A.Compare(expr.op, extract_aggregators(expr.left, found),
                         extract_aggregators(expr.right, found))
    if isinstance(expr, A.And):
        return A.And(extract_aggregators(expr.left, found),
                     extract_aggregators(expr.right, found))
    if isinstance(expr, A.Or):
        return A.Or(extract_aggregators(expr.left, found),
                    extract_aggregators(expr.right, found))
    if isinstance(expr, A.Not):
        return A.Not(extract_aggregators(expr.expr, found))
    if isinstance(expr, A.IsNull) and expr.expr is not None:
        return A.IsNull(expr=extract_aggregators(expr.expr, found))
    return expr


def _agg_index(var: A.Variable) -> Optional[int]:
    a = var.attribute
    if a and a.startswith("__agg_") and a.endswith("__") \
            and var.stream_ref is None:
        return int(a[6:-2])
    return None


class AggScope(Scope):
    """The input scope, shifted by ``offset`` columns, plus the
    __agg_<i>__ placeholders as the columns after the ``n_in`` input
    columns: the layout of the batch K2 projects from."""

    def __init__(self, base: Scope, n_in: int, agg_types: list,
                 offset: int = 0):
        self.base = base
        self.n_in = n_in
        self.agg_types = agg_types
        self.offset = offset

    def resolve(self, var: A.Variable):
        i = _agg_index(var)
        if i is not None:
            return ("attr", self.offset + self.n_in + i), self.agg_types[i]
        key, t = self.base.resolve(var)
        if not (isinstance(key, tuple) and key[0] == "attr"):
            raise not_ported(f"selector reference {key!r} with aggregators")
        return ("attr", self.offset + key[1]), t

    def resolve_stream_isnull(self, is_null):
        return self.base.resolve_stream_isnull(is_null)

    def clock_key(self, which: str):
        return self.base.clock_key(which)


class HavingScope(Scope):
    """HAVING resolves output attribute names first, then the input scope
    and the aggregates (reference: having runs on the projected output
    but may reference input attributes). Layout: output columns, then
    the input columns, then the aggregates."""

    def __init__(self, out_schema: StreamSchema, base: AggScope):
        self.out_schema = out_schema
        self.base = base

    def resolve(self, var: A.Variable):
        if _agg_index(var) is None and var.stream_ref is None:
            try:
                idx = self.out_schema.index_of(var.attribute)
                return ("attr", idx), self.out_schema.types[idx]
            except KeyError:
                pass
        return self.base.resolve(var)

    def resolve_stream_isnull(self, is_null):
        return self.base.resolve_stream_isnull(is_null)

    def clock_key(self, which: str):
        return self.base.clock_key(which)


def _bare_column(ce: CompiledExpr) -> Optional[int]:
    """The input column an expression is, if it is one as it stands."""
    if len(ce.code) == 1 and ce.code[0][0] == OP_LOAD \
            and isinstance(ce.code[0][2], int):
        return ce.code[0][2]
    return None


# ---------------------------------------------------------------------------
# the aggregating selector
# ---------------------------------------------------------------------------


class AggregateOp(Operator):
    """Select clause with aggregators and/or group-by.

    batch_mode mirrors the reference's batchingEnabled (batch windows):
    only the last qualifying row (or the last per group, in first-seen
    group order) of a flush chunk is emitted. ``pre_filters`` (set by
    the query chain) are the filters between the window and the
    selector: they run in the K2 program that evaluates the keys and
    arguments."""

    sort_heavy = True

    def __init__(self, selector: A.Selector, in_schema: StreamSchema,
                 out_stream_id: str, scope: Scope, functions=None,
                 batch_mode: bool = False, expired_possible: bool = True,
                 current_on: bool = True, expired_on: bool = False,
                 key_capacity: int = 1024, fifo_expiry: bool = True):
        self.in_schema = in_schema
        self.batch_mode = batch_mode
        self.current_on = current_on
        self.expired_on = expired_on
        self.group_by = selector.group_by
        self.K = key_capacity if selector.group_by else 1
        self.pre_filters: list = []
        functions = functions or {}
        if selector.select_all:
            raise CompileError("select * cannot be combined with aggregation")
        self.key_exprs = [compile_expression(v, scope, functions)
                          for v in selector.group_by]
        found: list = []
        rewritten = [extract_aggregators(oa.expression, found)
                     for oa in selector.attributes]
        rewritten_having = (extract_aggregators(selector.having, found)
                            if selector.having is not None else None)
        self.agg_specs: list[AggSpec] = []
        self.agg_args: list[Optional[CompiledExpr]] = []
        grouped = bool(selector.group_by)
        for name, params, _star in found:
            if len(params) > 1:
                raise CompileError(f"{name}() takes at most one argument here")
            ce = compile_expression(params[0], scope, functions) \
                if params else None
            self.agg_specs.append(make_agg_spec(
                name, ce.type if ce is not None else None, expired_possible,
                grouped, fifo_expiry))
            self.agg_args.append(ce)
        n_in = len(in_schema.types)
        agg_types = [s.out_type for s in self.agg_specs]
        agg_scope = AggScope(scope, n_in, agg_types)
        self.compiled = [compile_expression(e, agg_scope, functions)
                         for e in rewritten]
        attrs = tuple(Attribute(output_attribute_name(oa, i), ce.type)
                      for i, (oa, ce) in enumerate(zip(selector.attributes,
                                                       self.compiled)))
        self._schema = StreamSchema(out_stream_id, attrs)
        self.having = None
        if rewritten_having is not None:
            hscope = HavingScope(self._schema, AggScope(
                scope, n_in, agg_types, offset=len(attrs)))
            self.having = compile_expression(rewritten_having, hscope,
                                             functions)
            if self.having.type is not AttrType.BOOL:
                raise CompileError("HAVING must be BOOL")
        # order by / limit / offset (STRING keys shape at the host edge)
        self.order_by, host_order = compile_order_by(selector, self._schema)
        self.limit = const_int(selector.limit, "limit")
        self.offset = const_int(selector.offset, "offset")
        if host_order:
            self.host_shape = (host_order, self.offset, self.limit)
            self.limit = self.offset = None
        else:
            self.host_shape = None
        self._progs = None

    @property
    def out_schema(self):
        return self._schema

    def init_state(self, device="cpu"):
        return {
            "keys": torch.zeros((self.K,), dtype=I64, device=device),
            "used": torch.zeros((self.K,), dtype=torch.bool, device=device),
            "carry": tuple(tuple(lane.identity(device).expand(self.K).clone()
                                 for lane in spec.lanes)
                           for spec in self.agg_specs),
            "tables": tuple(spec.init_table(self.K, device)
                            if getattr(spec, "stateful", False) else ()
                            for spec in self.agg_specs),
            "overflow": torch.zeros((), dtype=I64, device=device),
        }

    # -- the K2 programs of a step ------------------------------------------
    def _programs(self):
        """(pre program or None, the K2 outputs it gives each key and
        argument, projection program, having program or None)."""
        if self._progs is not None:
            return self._progs
        from .expr import ALL_KINDS
        exprs = list(self.key_exprs) + [a for a in self.agg_args
                                        if a is not None]
        computed = [e for e in exprs if _bare_column(e) is None]
        pre = None
        if computed or self.pre_filters:
            b = ProgramBuilder()
            for f in self.pre_filters:
                b.keep(f.cond)
            b.timer_pass = bool(self.pre_filters)
            for e in computed:
                b.out(e)
            pre = b.build()
        b = ProgramBuilder()
        for ce in self.compiled:
            b.out(ce)
        b.gate_bits = (int(self.current_on) << CURRENT) | \
            (int(self.expired_on) << EXPIRED)
        proj = b.build()
        hav = None
        if self.having is not None:
            b = ProgramBuilder()
            b.keep(self.having)
            b.gate_bits = ALL_KINDS
            hav = b.build()
        self._progs = (pre, computed, proj, hav)
        return self._progs

    def step(self, state, batch: EventBatch, now, emitted=None,
             tparams=None):
        """``tparams``: the template parameters that ``pre_filters``
        load (name -> values; a tenant pool's, one a slot)."""
        pre, computed, proj, hav = self._programs()
        cols, nulls = batch.cols, batch.nulls
        if pre is not None:
            pc, pn, valid = expr_eval(pre, batch, now=now, tparams=tparams)
            batch = EventBatch(batch.ts, batch.cols, batch.nulls, batch.kind,
                               valid)
            pre_out = {id(e): (c, n) for e, c, n in zip(computed, pc, pn)}

        def col_of(ce):
            i = _bare_column(ce)
            return (cols[i], nulls[i]) if i is not None else pre_out[id(ce)]

        key_cols = [col_of(e) for e in self.key_exprs]
        arg_cols = [col_of(a) if a is not None else None
                    for a in self.agg_args]
        slots, aggs, new_state = aggregate_step(
            self, state, key_cols, arg_cols, batch.kind, batch.valid)
        ext = EventBatch(batch.ts, tuple(cols) + tuple(v for v, _ in aggs),
                         tuple(nulls) + tuple(n for _, n in aggs),
                         batch.kind, batch.valid)
        out_cols, out_nulls, qual = expr_eval(proj, ext, now=now)
        if hav is not None:
            hb = EventBatch(batch.ts, tuple(out_cols) + ext.cols,
                            tuple(out_nulls) + ext.nulls, batch.kind, qual)
            _, _, qual = expr_eval(hav, hb, now=now)
        if not self.order_by:
            return new_state, aggregate_emit(self, slots, qual, batch,
                                             out_cols, out_nulls, emitted)
        # the qualifying rows in row order, then kernel G (G[K] with a
        # slot axis) orders, offsets and limits them (the reference's
        # lexsort ignores the emission order)
        out = aggregate_emit(self, slots, qual, batch, out_cols, out_nulls)
        return new_state, shape_chunk(out, self.order_by, self.offset,
                                      self.limit, emitted)


# ---------------------------------------------------------------------------
# kernel K6 and its plain version
# ---------------------------------------------------------------------------


def agg_context(op: AggregateOp, state, key_cols, kind, valid):
    """The plain version of K6's first part: group slots, reset segments
    and the slot order. -> (ctx, the new group table's keys and used,
    the overflow count): ``ctx`` is what a stateful aggregator's run
    reads (the reference's AggregateOp.step ctx)."""
    B = kind.shape[0]
    K = op.K
    dev = kind.device
    is_add = valid & (kind == CURRENT)
    is_remove = valid & (kind == EXPIRED)
    is_reset = valid & (kind == RESET)
    agg_row = is_add | is_remove
    overflow = state["overflow"]
    kfull = torch.full((B,), K, dtype=torch.int32, device=dev)
    if op.group_by:
        hkeys = hash_columns([c for c, _ in key_cols],
                             [n for _, n in key_cols])
        slots, new_keys, new_used, ov = lookup_or_insert(
            state["keys"], state["used"], hkeys, agg_row)
        agg_row = agg_row & ~(agg_row & (slots < 0))
        slots = torch.where(agg_row, slots, kfull)
        overflow = overflow + ov
    else:
        new_keys, new_used = state["keys"], state["used"]
        slots = torch.where(agg_row, torch.zeros_like(kfull), kfull)
    reset_seg = torch.cumsum(is_reset.to(I64), 0)
    n_resets = reset_seg[B - 1]
    perm = torch.argsort(slots, stable=True)
    inv_perm = torch.argsort(perm, stable=True)
    seg_sorted = (slots.to(I64) * (B + 1) + reset_seg)[perm]
    ctx = {"B": B, "K": K, "slots": slots, "agg_row": agg_row,
           "is_add": is_add, "is_remove": is_remove, "reset_seg": reset_seg,
           "n_resets": n_resets, "perm": perm, "inv_perm": inv_perm,
           "seg_sorted": seg_sorted, "slot_sorted": slots[perm],
           "segzero_sorted": (reset_seg == 0)[perm]}
    return ctx, new_keys, new_used, overflow


def aggregate_step_ref(op: AggregateOp, state, key_cols, arg_cols, kind,
                       valid):
    """Plain PyTorch version of K6's step (with kernels C, D and H): the
    reference's ``AggregateOp.step`` up to the projection. -> (slots [B]
    int32, [(values, nulls)] one per aggregator, state'). With a
    partition block's or a tenant pool's slot axis (``kind`` [slots, B],
    a state a slot) each slot runs on its own, as the reference's vmap
    computes it, but kernel C's lanes, which run over every slot in one
    call (``SlidingMinMaxAgg.run_slots``)."""
    if kind.dim() == 1:
        return _step_ref(op, state, arg_cols, kind,
                         agg_context(op, state, key_cols, kind, valid), {})
    S = kind.shape[0]
    parts = [agg_context(op, *unstack((state, key_cols, kind, valid), k))
             for k in range(S)]
    done = {}   # aggregator -> its (runnings, table') a slot
    for s, spec in enumerate(op.agg_specs):
        if isinstance(spec, SlidingMinMaxAgg):
            (res, span), ntab = spec.run_slots(
                arg_cols[s], [p[0] for p in parts], state["tables"][s])
            done[s] = [((res[k], span[k]), unstack(ntab, k))
                       for k in range(S)]
    return stack([_step_ref(op, unstack(state, k), unstack(arg_cols, k),
                            kind[k], parts[k],
                            {s: d[k] for s, d in done.items()})
                  for k in range(S)])


def _step_ref(op: AggregateOp, state, arg_cols, kind, part, done: dict):
    """aggregate_step_ref of one slot from its ``agg_context`` (``part``);
    ``done``: the stateful aggregators already run, by index."""
    ctx, new_keys, new_used, overflow = part
    K, slots, agg_row = op.K, ctx["slots"], ctx["agg_row"]
    is_add, is_remove = ctx["is_add"], ctx["is_remove"]
    perm, inv_perm = ctx["perm"], ctx["inv_perm"]
    seg_sorted, segzero_sorted = ctx["seg_sorted"], ctx["segzero_sorted"]
    reset_seg, n_resets = ctx["reset_seg"], ctx["n_resets"]
    dev = kind.device
    slot_safe = torch.clamp(ctx["slot_sorted"], 0, K - 1).to(I64)
    last_mask = (reset_seg == n_resets) & agg_row
    aggs, new_carries, new_tables = [], [], []
    for s, (spec, arg, carry, tab) in enumerate(zip(
            op.agg_specs, arg_cols, state["carry"], state["tables"])):
        if getattr(spec, "stateful", False):
            runnings, ntab = done[s] if s in done else \
                spec.run_ref(arg, ctx, tab)
            aggs.append(spec.value(tuple(runnings)))
            new_carries.append(carry)
            new_tables.append(ntab)
            continue
        new_tables.append(tab)
        contribs = spec.contribs(arg, is_add, is_remove)
        runnings, lane_carries = [], []
        for lane, contrib, cvec in zip(spec.lanes, contribs, carry):
            ident = lane.identity(dev)
            pref = lane.segmented_scan(contrib[perm], seg_sorted)
            cin = torch.where(segzero_sorted, cvec[slot_safe], ident)
            runnings.append(lane.combine(cin, pref)[inv_perm])
            base = torch.where(n_resets == 0, cvec, ident.expand(K))
            lane_carries.append(_fold_carry(lane, base, contrib, slots,
                                            last_mask))
        aggs.append(spec.value(tuple(runnings)))
        new_carries.append(tuple(lane_carries))
    new_state = {"keys": new_keys, "used": new_used,
                 "carry": tuple(new_carries), "tables": tuple(new_tables),
                 "overflow": overflow}
    return slots, aggs, new_state


def _fold_carry(lane: Lane, base, contrib, slots, mask):
    """base.at[slots[mask]].<op>(contrib[mask]): each slot's updates
    folded one after the other in row order, as the reference's scatter
    applies them (a float sum is not reassociated)."""
    K = base.shape[0]
    idx = slots[mask].to(I64)
    upd = contrib[mask]
    if lane.op == "sum" and not upd.is_floating_point():
        return base.index_add(0, idx, upd)
    order = torch.argsort(idx, stable=True)
    idx, upd = idx[order], upd[order]
    counts = torch.bincount(idx, minlength=K)
    start = torch.cumsum(counts, 0) - counts
    out = base.clone()
    n = int(counts.max()) if idx.numel() else 0
    for r in range(n):
        live = (counts > r).nonzero().squeeze(1)
        out[live] = lane.combine(out[live], upd[start[live] + r])
    return out


def aggregate_emit_ref(op: AggregateOp, slots, qualifying,
                       batch: EventBatch, out_cols, out_nulls, emitted=None):
    """Plain PyTorch version of K6's emission: the rows that qualify (slot
    in the table, and what K2 left valid: the current/expired gate and
    having), in batch mode the last per (slot, flush chunk), in emission
    order, cut by offset and limit. ``emitted`` (an int64 0-d tensor) is
    increased by the rows emitted."""
    B = batch.capacity
    dev = batch.ts.device
    qualifying = qualifying & (slots < op.K)
    rows = torch.arange(B, dtype=I64, device=dev)
    out_valid, emit_order = qualifying, rows
    if op.batch_mode:
        kind, valid = batch.kind, batch.valid
        last_valid = torch.cummax(torch.where(valid, rows, -1), 0).values
        prev_valid = torch.cat([torch.full((1,), -1, dtype=I64, device=dev),
                                last_valid[:-1]])
        prev_kind = torch.where(prev_valid >= 0,
                                kind[torch.clamp(prev_valid, min=0)],
                                torch.full_like(kind, -1))
        boundary = valid & ((prev_valid < 0) | (
            ((kind == EXPIRED) | (kind == RESET)) & (prev_kind == CURRENT)))
        chunk_id = torch.cumsum(boundary.to(I64), 0)
        assert (op.K + 1) * (B + 2) < 2 ** 31, (op.K, B)
        qkey = torch.where(qualifying, slots.to(I64) * (B + 1) + chunk_id,
                           torch.full_like(chunk_id, 2 ** 31 - 1)).to(
                               torch.int32)
        perm2 = torch.argsort(qkey, stable=True)
        qk_s = qkey[perm2]
        is_last_s = torch.ones((B,), dtype=torch.bool, device=dev)
        is_last_s[:-1] = qk_s[:-1] != qk_s[1:]
        first_s = segmented_cummin(rows[perm2].to(torch.int32), qk_s)
        out_valid = torch.zeros((B,), dtype=torch.bool, device=dev)
        out_valid[perm2] = is_last_s & (qk_s < 2 ** 31 - 1)
        emit_order = torch.zeros((B,), dtype=I64, device=dev)
        emit_order[perm2] = first_s.to(I64)
    out = EventBatch(ts=batch.ts, cols=tuple(out_cols),
                     nulls=tuple(out_nulls), kind=batch.kind,
                     valid=out_valid)
    if op.order_by:   # row order; kernel G shapes the chunk after
        return shape_output(out, None, None, rows)
    out = shape_output(out, op.offset, op.limit, emit_order)
    if emitted is not None:
        emitted += out.valid.sum(dtype=I64)
    return out


def aggregate_step(op: AggregateOp, state, key_cols, arg_cols, kind, valid):
    """Kernel K6, the step: group slots, reset segments, running
    aggregates and the new state. A batch on the CPU takes the plain
    version; a CUDA batch launches csrc/aggregate_step.cu. Inside a
    partition block or a tenant pool (``kind`` of shape [K, B], a state
    a slot) the plain version runs over the slot axis and the kernel once
    over every slot, counted as ``aggregate_step[K]``."""
    dev = kind.device
    slotted = kind.dim() == 2
    if dev.type == "cpu":
        return aggregate_step_ref(op, state, key_cols, arg_cols, kind, valid)
    if dev.type != "cuda":
        raise ValueError(f"aggregate_step: unsupported device {dev}")
    slots, aggs, new_state, args, stats = agg_args(op, state, key_cols,
                                                   arg_cols, kind, valid)
    k = _kernels.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    if not stats:
        k.aggregate_step(args, stream, 3)
    else:   # kernels C, D and H between the slot sort and the lanes
        k.aggregate_step(args, stream, 1)
        for spec, st in stats:
            stateful_launch(k, spec, args, st, stream, slotted)
        k.aggregate_step(args, stream, 2)
    _kernels.count_launch("aggregate_step[K]" if slotted
                          else "aggregate_step")
    return slots, aggs, new_state


def stateful_launch(k, spec, args, st, stream, slotted: bool = False) -> None:
    """Kernel C (min/max over expiring content), D (distinctCount) or H
    (unionSet) of one stateful aggregator, on K6's slot order (``args``
    after its part 1); with a partition block's or a tenant pool's slot
    axis, one launch sequence over every slot, counted with "[K]"."""
    tag = "[K]" if slotted else ""
    if isinstance(spec, UnionSetAgg):
        k.union_set(args, st, stream)
        _kernels.count_launch("union_set" + tag)
    elif isinstance(spec, SlidingMinMaxAgg):
        k.sliding_minmax(args, st, stream)
        _kernels.count_launch("sliding_minmax" + tag)
    else:
        k.distinct_count(args, st, stream)
        _kernels.count_launch("distinct_count" + tag)


def aggregate_emit(op: AggregateOp, slots, qualifying, batch: EventBatch,
                   out_cols, out_nulls, emitted=None):
    """Kernel K6, the emission (after K2's projection and having); once
    per slot inside a partition block or a tenant pool
    (``aggregate_emit[K]``). ``emitted``: a 0-d counter, or a pool's
    ``[slots]`` counters, each slot's rows added to its own."""
    dev = batch.ts.device
    slotted = batch.ts.dim() == 2
    if dev.type == "cpu":
        if slotted:
            S = batch.ts.shape[0]
            if emitted is not None and emitted.dim() == 0:
                emitted = emitted.expand(S)   # every slot adds to the one
            return per_slot(
                lambda sl, q, b, oc, on, e: aggregate_emit_ref(
                    op, sl, q, b, oc, on, e),
                S, slots, qualifying, batch, out_cols, out_nulls, emitted)
        return aggregate_emit_ref(op, slots, qualifying, batch, out_cols,
                                  out_nulls, emitted)
    if dev.type != "cuda":
        raise ValueError(f"aggregate_emit: unsupported device {dev}")
    out, args = emit_args(op, slots, qualifying, batch, out_cols, out_nulls,
                          emitted)
    _kernels.load().aggregate_emit(
        args, torch.cuda.current_stream(dev).cuda_stream)
    _kernels.count_launch("aggregate_emit[K]" if slotted
                          else "aggregate_emit")
    return out


def tree_levels(n: int):
    """The levels of the associative-scan tree over n elements: level 0
    is the elements, level l + 1 the pair sums of level l (floor(n_l / 2)
    of them), up to the first level with fewer than two.
    -> (offsets, sizes)."""
    offs, sizes, o = [], [], 0
    while True:
        offs.append(o)
        sizes.append(n)
        o += n
        if n < 2:
            return offs, sizes
        n //= 2


def agg_args(op: AggregateOp, state, key_cols, arg_cols, kind, valid):
    """K6's step arguments: fresh tensors for the slots, the aggregate
    columns and the new state, the scratch, and ``_kernels.AggArgs``.
    -> (slots, [(values, nulls)], state', args). Inside a partition
    block (``kind`` [K, B], a state a slot) every tensor gets the leading
    slot axis, ``n_part`` is the slot count and ``moves`` the slot
    strides (ops/slots.py part_moves)."""
    dev = kind.device
    slotted = kind.dim() == 2
    lead = (kind.shape[0],) if slotted else ()
    B, K = kind.shape[-1], op.K
    lim = _kernels
    specs = op.agg_specs
    n_lanes = sum(len(sp.lanes) for sp in specs)
    if len(key_cols) > lim.AGG_MAX_KEYS or len(specs) > lim.AGG_MAX_SPECS \
            or n_lanes > lim.AGG_MAX_LANES:
        raise NotImplementedError(
            "not ported yet: a selector with more than "
            f"{lim.AGG_MAX_KEYS} group-by keys, {lim.AGG_MAX_SPECS} "
            f"aggregators or {lim.AGG_MAX_LANES} accumulator lanes")
    offs, sizes = tree_levels(B)
    if len(offs) > lim.AGG_MAX_LEVELS:
        raise NotImplementedError(f"not ported yet: {B} rows in one step")

    def t(n, dtype):
        return torch.empty(lead + (max(int(n), 1),), dtype=dtype, device=dev)
    slots = t(B, torch.int32)
    aggs = [(torch.empty(lead + (B, 1 + SET_LANES), dtype=I64, device=dev)
             if sp.out_type is AttrType.OBJECT
             else t(B, torch_dtype(sp.out_type)), t(B, torch.bool))
            for sp in specs]
    stateful = [getattr(sp, "stateful", False) for sp in specs]
    new_state = {"keys": t(K, I64), "used": t(K, torch.bool),
                 "carry": tuple(carry if sf else
                                tuple(torch.empty_like(c) for c in carry)
                                for carry, sf in zip(state["carry"],
                                                     stateful)),
                 "tables": tuple({k: torch.empty_like(v)
                                  for k, v in tab.items()} if sf else tab
                                 for tab, sf in zip(state["tables"],
                                                    stateful)),
                 "overflow": torch.empty(lead, dtype=I64, device=dev)}
    total = offs[-1] + sizes[-1]
    sc = {"hk": t(B, I64), "probe": t(B, torch.int32),
          "flags": t(B, torch.uint8), "claim": t(K, torch.int32),
          "reset_seg": t(B, I64), "scal": t(8, I64),
          "skeys": t(B, torch.int32), "k1": t(B, torch.int32),
          "k2": t(B, torch.int32), "i1": t(B, torch.int32),
          "i2": t(B, torch.int32),
          "counts": t(256 * ((B + 1023) // 1024), torch.int32),
          "perm": t(B, torch.int32), "inv_perm": t(B, torch.int32),
          "seg_sorted": t(B, I64), "seg_start": t(B, I64),
          "slot_first": t(K + 1, torch.int32),
          "slot_last": t(K + 1, torch.int32), "tree": t(total, I64),
          "tree_seg": t(total, I64), "res": t(B, I64)}
    runs, stats = [], []
    a = _kernels.AggArgs()
    a.B, a.K, a.grouped = B, K, int(bool(op.group_by))
    a.n_keys, a.n_specs, a.n_lanes = len(key_cols), len(specs), n_lanes
    a.kind, a.valid = kind.data_ptr(), valid.data_ptr()
    for k, (c, n) in enumerate(key_cols):
        a.key_cols[k], a.key_nulls[k] = c.data_ptr(), n.data_ptr()
        a.key_type[k] = DTYPE_VT[c.dtype]
    lane = 0
    for s, (sp, arg, carry, ncarry, (ov, on)) in enumerate(zip(
            specs, arg_cols, state["carry"], new_state["carry"], aggs)):
        a.spec_kind[s] = sp.KIND
        a.spec_flag[s] = int(getattr(sp, "is_and", False))
        a.spec_lane0[s] = lane
        a.arg_type[s] = -1 if arg is None else DTYPE_VT[arg[0].dtype]
        if arg is not None:
            a.arg_cols[s], a.arg_nulls[s] = arg[0].data_ptr(), \
                arg[1].data_ptr()
        a.out_type[s] = DTYPE_VT[ov.dtype]
        a.out_vals[s], a.out_nulls[s] = ov.data_ptr(), on.data_ptr()
        if isinstance(sp, DistinctCountAgg):
            # the lane carries in the spec's table
            carry = (state["tables"][s]["carry"],)
            ncarry = (new_state["tables"][s]["carry"],)
        for ln, c, nc in zip(sp.lanes, carry, ncarry):
            r = t(B, ln.dtype)
            runs.append(r)
            a.lane_op[lane] = LANE_OPS[ln.op]
            a.lane_type[lane] = DTYPE_VT[ln.dtype]
            a.lane_spec[lane] = s
            a.carry[lane], a.new_carry[lane] = c.data_ptr(), nc.data_ptr()
            a.run[lane] = r.data_ptr()
            lane += 1
        if isinstance(sp, UnionSetAgg):
            ua, keep = union_args(sp, arg, state["tables"][s],
                                  new_state["tables"][s], (ov, on), B, dev,
                                  lead)
            stats.append((sp, ua))
            runs.append(keep)
        elif stateful[s]:
            st, keep = stat_args(sp, s, arg, state["tables"][s],
                                 new_state["tables"][s], B, K, dev, lead)
            stats.append((sp, st))
            runs.append(keep)
            if isinstance(sp, DistinctCountAgg):
                a.spec_contrib[s] = st.r2
    a.keys, a.used = state["keys"].data_ptr(), state["used"].data_ptr()
    a.overflow = state["overflow"].data_ptr()
    a.new_keys = new_state["keys"].data_ptr()
    a.new_used = new_state["used"].data_ptr()
    a.new_overflow = new_state["overflow"].data_ptr()
    a.slots = slots.data_ptr()
    for k, v in sc.items():
        setattr(a, k, v.data_ptr())
    for k, (o, n) in enumerate(zip(offs, sizes)):
        a.level_off[k], a.level_n[k] = o, n
    a.n_levels = len(offs)
    a.n_part = lead[0] if slotted else 1
    part_moves(a, (state, key_cols, arg_cols, kind, valid, slots, aggs,
                   new_state, runs, sc), dev)
    a._keep = (state, runs, sc)
    return (slots[..., :B], [(v[..., :B], n[..., :B]) for v, n in aggs],
            new_state, a, stats)


def stat_args(sp, s: int, arg, tab, ntab, B: int, K: int, dev,
              lead: tuple = ()):
    """Kernel C's or D's arguments for aggregator ``s``: its table, the
    new table's tensors and the scratch. -> (``_kernels.StatArgs``, the
    tensors to keep alive until the launch). With the slot axis
    (``lead`` = (slots,)), every table and scratch tensor has it and
    ``moves`` holds their slot strides, as K6's own arguments."""
    if isinstance(sp, DistinctCountAgg):
        assert sp.D * (B + 1) + B < 2 ** 31, (sp.D, B)   # pair_seg keys

    def t(n, dtype):
        return torch.empty(lead + (max(int(n), 1),), dtype=dtype,
                           device=dev)
    st = _kernels.StatArgs()
    st.spec = s
    st.arg, st.arg_null = arg[0].data_ptr(), arg[1].data_ptr()
    st.arg_type = DTYPE_VT[arg[0].dtype]
    sc = {"r0": t(B, I64), "r1": t(B, I64), "r2": t(B, I64),
          "r3": t(B, I64), "i0": t(B, torch.int32), "i1": t(B, torch.int32),
          "flags": t(B, torch.uint8), "pkeys": t(B, torch.int32),
          "perm2": t(B, torch.int32), "seg2": t(B, I64),
          "ksum": t(2 * K, I64), "count": t(1, I64)}
    if isinstance(sp, SlidingMinMaxAgg):
        st.W = sp.W
        sc["tree"] = torch.empty(lead + (K, 2 * sp.W), dtype=sp.dtype,
                                 device=dev)
        for f in ("ring", "heads", "tails"):
            setattr(st, f, tab[f].data_ptr())
            setattr(st, "new_" + f, ntab[f].data_ptr())
    else:
        st.D = sp.D
        sc["claim"] = t(sp.D, torch.int32)
        for f in ("keys", "used", "counts"):
            setattr(st, f, tab[f].data_ptr())
            setattr(st, "new_" + f, ntab[f].data_ptr())
    st.overflow = tab["overflow"].data_ptr()
    st.new_overflow = ntab["overflow"].data_ptr()
    for k, v in sc.items():
        setattr(st, k, v.data_ptr())
    st.n_part = lead[0] if lead else 1
    part_moves(st, (tab, ntab, sc, arg), dev)
    return st, (sc, arg)


def union_args(sp, arg, tab, ntab, out, B: int, dev, lead: tuple = ()):
    """Kernel H's arguments for unionSet() aggregator ``sp``: its table,
    the new table's tensors, its [B, 1 + SET_LANES] output and the
    scratch; with the slot axis (``lead`` = (slots,)) each of these a
    slot, and ``moves`` their slot strides. ``compacted()``, called by
    the launch after the step's sync, points at the kept pairs' arrays
    (m a slot, ``compact_arrays``).
    -> (``_kernels.UnionArgs``, the tensors to keep alive until the
    launch)."""
    S = SET_LANES
    n = S * (1 + B)
    P = lead[0] if lead else 1
    values, nulls = arg
    if values.shape[-2:] != (B, 1 + S) or values.stride(-1) != 1 or \
            values.stride(-2) != 1 + S:
        raise ValueError("union_set: the argument must be contiguous "
                         f"[{B}, {1 + S}] set rows")

    def t(m, dtype):
        return torch.empty(lead + (max(int(m), 1),), dtype=dtype,
                           device=dev)
    sc = {"keep": t(n, torch.uint8), "rank": t(n, I64),
          "sums": t((n + 1023) // 1024, I64), "kept": t(1, I64)}
    n_kept = torch.empty((P,), dtype=I64, pin_memory=dev.type == "cuda")
    u = _kernels.UnionArgs()
    u.B, u.n = B, n
    u.arg, u.arg_null = values.data_ptr(), nulls.data_ptr()
    for f in ("vals", "counts", "tag", "overflow"):
        setattr(u, f, tab[f].data_ptr())
        setattr(u, "new_" + f, ntab[f].data_ptr())
    u.out, u.out_null = out[0].data_ptr(), out[1].data_ptr()
    for k, v in sc.items():
        setattr(u, k, v.data_ptr())
    u.n_kept = n_kept.data_ptr()
    u.n_part = P
    part_moves(u, (arg, tab, ntab, out, sc), dev)

    def compacted() -> int:
        """m, the most pairs any slot kept (read after the sync)."""
        m = int(n_kept.max())
        arrs, srt = compact_arrays(sp, dev, P, m)
        for k, v in arrs.items():
            setattr(u, k, v.data_ptr())
        for k, v in srt.items():
            setattr(u.sort, k, v.data_ptr())
        return m
    u.compacted = compacted
    return u, (sc, n_kept, arg)


def compact_arrays(sp, dev, P: int, m: int) -> tuple:
    """Kernel H's arrays for P slots of m kept pairs each: the
    aggregator's own (``sp.compact``), kept from step to step and grown,
    to a multiple of 1,024 pairs a slot, only when a step keeps more, so
    that a step allocates nothing after its sync. -> (the compacted
    pairs' arrays, the sort's)."""
    have = sp.compact.get(dev)
    if have is not None and have[0] == P and have[1] >= m:
        return have[2]
    cap = max(1024, -(-m // 1024) * 1024)
    blocks = cap // 1024

    def f(k, dtype):
        return torch.empty((P * k,), dtype=dtype, device=dev)
    arrs = {"sgn": f(cap, I64), "total": f(cap, I64), "csum": f(cap, I64),
            "live": f(cap, torch.uint8), "lrank": f(cap, I64),
            "msums": f(blocks, I64)}
    srt = {"k1": f(cap, I64), "k2": f(cap, I64), "i1": f(cap, torch.int32),
           "i2": f(cap, torch.int32), "keys": f(cap, I64),
           "order": f(cap, torch.int32), "sk": f(cap, I64),
           "counts": f(256 * blocks, torch.int32)}
    sp.compact[dev] = (P, cap, (arrs, srt))
    return sp.compact[dev][2]


def emit_args(op: AggregateOp, slots, qualifying, batch: EventBatch,
              out_cols, out_nulls, emitted):
    """K6's emission arguments and its output batch (fresh tensors).
    -> (output batch, args); with the slot axis inside a partition
    block, as agg_args."""
    dev = batch.ts.device
    slotted = batch.ts.dim() == 2
    lead = (batch.ts.shape[0],) if slotted else ()
    B = batch.ts.shape[-1]
    n = len(out_cols)
    if n > _kernels.AGG_MAX_OUTS:
        raise NotImplementedError(
            f"not ported yet: a selector with more than "
            f"{_kernels.AGG_MAX_OUTS} output attributes ({n})")

    def t(m, dtype):
        return torch.empty(lead + (max(int(m), 1),), dtype=dtype, device=dev)
    out = EventBatch(ts=t(B, I64),
                     cols=tuple(torch.empty(c.shape, dtype=c.dtype, device=dev)
                                for c in out_cols),
                     nulls=tuple(t(B, torch.bool) for _ in out_cols),
                     kind=t(B, torch.int32), valid=t(B, torch.bool))
    sc = {"ovalid": t(B, torch.uint8), "emit_order": t(B, torch.int32),
          "pos": t(B, torch.int32), "flag": t(B, torch.int32),
          "qkeys": t(B, torch.int32), "k1": t(B, torch.int32),
          "k2": t(B, torch.int32), "i1": t(B, torch.int32),
          "i2": t(B, torch.int32), "perm2": t(B, torch.int32),
          "counts": t(256 * ((B + 1023) // 1024), torch.int32),
          "chunk": t(B, I64), "gstart": t(B, I64), "scal": t(4, I64)}
    a = _kernels.EmitArgs()
    a.B, a.K, a.batch_mode, a.n_cols = B, op.K, int(op.batch_mode), n
    # with an order-by: the qualifying rows in row order, unshaped and
    # uncounted (kernel G shapes and counts them)
    a.keep_order = int(bool(op.order_by))
    a.offset = -1 if op.offset is None or op.order_by else op.offset
    a.limit = -1 if op.limit is None or op.order_by else op.limit
    a.slots, a.qual = slots.data_ptr(), qualifying.data_ptr()
    a.ts, a.kind = batch.ts.data_ptr(), batch.kind.data_ptr()
    a.valid = batch.valid.data_ptr()
    for k, (c, nl, oc, on) in enumerate(zip(out_cols, out_nulls, out.cols,
                                            out.nulls)):
        a.cols[k], a.nulls[k] = c.data_ptr(), nl.data_ptr()
        a.col_size[k] = row_bytes(c[0] if slotted else c)
        a.out_cols[k], a.out_nulls[k] = oc.data_ptr(), on.data_ptr()
    a.out_ts, a.out_kind = out.ts.data_ptr(), out.kind.data_ptr()
    a.out_valid = out.valid.data_ptr()
    a.emitted = emitted.data_ptr() \
        if emitted is not None and not op.order_by else None
    for k, v in sc.items():
        setattr(a, k, v.data_ptr())
    a.n_part = lead[0] if slotted else 1
    # a pool's [slots] counters move with the slot; a 0-d one is shared
    part_moves(a, (slots, qualifying, batch, out_cols, out_nulls, out, sc,
                   emitted), dev)
    a._keep = (sc,)
    return out, a
