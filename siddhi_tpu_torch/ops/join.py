"""Stream joins: the banded equi-join probe and the [B, W] grid fallback
(PyTorch port of siddhi_tpu/ops/join.py): kernel K7 of PERF.md.

Reference mapping:
- query/input/stream/join/JoinProcessor.java:78-190: each window-output
  event of the trigger side (CURRENT and EXPIRED, its kind kept on the
  joined row) finds the opposite side's window content with the ON
  condition; outer joins emit one-sided rows when nothing matches; RESET
  rows pass one-sided; TIMER rows are consumed.
- JoinInputStreamParser.java:75: two SingleStreamRuntimes cross-wired.

Emission order is (trigger row, opposite buffer position), a trigger
row's one-sided or RESET row before its pairs. Pairs beyond JOIN_CAP
(``@cap(join.pairs)``) and probe candidates beyond ``@cap(
join.candidates)`` are counted, never silent.

Kernel K7 (csrc/join_cross.cu) has two entry points, each with its
plain version here, which follows the reference function by function
(the tests and chip_smoke.py hold the kernel against it; a wrapper takes
it for tensors on the CPU):
- ``join_probe`` / ``cross_probe_ref`` (``JoinCross._cross_probe``): the
  first ``L-expr == R-expr`` conjunct is the band key; the opposite
  buffer is sorted into the key view of ops/table.py
  (``sorted_key_view``), each trigger row finds its band by the
  reference's own bisection (``band_bounds``), bands expand into
  candidates where a residual conjunct or the sliding-window liveness
  gate must be evaluated, and survivors and one-sided rows are placed
  by prefix sums;
- ``join_grid`` / ``cross_grid_ref`` (``JoinCross._cross_grid``): any ON
  condition over every (trigger row, opposite row) pair; the kernel
  counts per row, takes a prefix over rows and places the pairs, and
  never builds the [B, W] grid.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from .. import _kernels
from ..core.event import (CURRENT, EXPIRED, RESET, Attribute, EventBatch,
                          StreamSchema)
from ..core.types import NUMERIC_TYPES, AttrType, promote
from ..lang import ast as A
from .expr import VT, CompileError, CompiledExpr, RowScope, Scope, _widen, \
    compile_expression
from .table import (TS_COL, PairProgram, band_bounds, big_key, encode_keys,
                    fill_prog, fill_side, search_levels, side_cols,
                    sorted_key_view)

I64 = torch.int64


class JoinSideScope(Scope):
    """Resolves variables to ('L'/'R', attr_idx) over the two sides."""

    def __init__(self, left_schema: StreamSchema, left_alias,
                 right_schema: StreamSchema, right_alias):
        # an alias REPLACES the stream name (the reference rejects the
        # original id once `as x` is used, JoinTestCase joinTest7)
        self.sides = {
            "L": (left_schema,
                  {left_alias} if left_alias else {left_schema.stream_id}),
            "R": (right_schema,
                  {right_alias} if right_alias
                  else {right_schema.stream_id}),
        }

    def resolve(self, var: A.Variable):
        ref = var.stream_ref
        if ref is not None:
            for tag, (schema, names) in self.sides.items():
                if ref in names:
                    try:
                        idx = schema.index_of(var.attribute)
                    except KeyError:
                        raise CompileError(
                            f"'{ref}' has no attribute "
                            f"'{var.attribute}'")
                    return (tag, idx), schema.types[idx]
            raise CompileError(f"unknown stream reference '{ref}' in join")
        hits = []
        for tag, (schema, _) in self.sides.items():
            if var.attribute in schema.names:
                hits.append((tag, schema))
        if len(hits) == 1:
            tag, schema = hits[0]
            idx = schema.index_of(var.attribute)
            return (tag, idx), schema.types[idx]
        raise CompileError(
            f"attribute '{var.attribute}' is "
            + ("ambiguous" if hits else "unknown") + " across join sides")

    def clock_key(self, which: str):
        """eventTimestamp() in an ON condition is the trigger row's (the
        reference's join env binds the trigger batch's __ts__ and no
        clock)."""
        if which == "now":
            raise NotImplementedError(
                "not ported yet: currentTimeMillis() in a join condition "
                "(the reference binds no clock there)")
        return ("ts",)


class JoinCombinedScope(RowScope):
    """Selector scope over the combined (left ++ right) joined batch."""

    def __init__(self, side_scope: JoinSideScope, left_n: int):
        self.side_scope = side_scope
        self.left_n = left_n

    def resolve(self, var: A.Variable):
        (tag, idx), t = self.side_scope.resolve(var)
        return ("attr", idx if tag == "L" else self.left_n + idx), t


def combined_schema(out_id: str, left: StreamSchema,
                    right: StreamSchema) -> StreamSchema:
    attrs = [Attribute(a.name, a.type) for a in left.attributes]
    attrs += [Attribute(a.name, a.type) for a in right.attributes]
    return StreamSchema(out_id, tuple(attrs))


# ---------------------------------------------------------------------------
# equi-conjunct analysis (probe eligibility)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class EquiKey:
    """One ``L-expr == R-expr`` conjunct usable as a band key, each side
    cast to ``key_type`` (the promotion the grid's compare applies, so
    probe equality is grid equality on the same cast values, lossy
    LONG -> DOUBLE included; STRING keys are dictionary codes, BOOL keys
    their 0/1 byte)."""

    left: CompiledExpr       # key values over the L side's columns
    right: CompiledExpr      # key values over the R side's columns
    key_type: Any


class _TagRecorder(Scope):
    """The join side scope, recording which sides ('L'/'R') an
    expression's variables resolve to."""

    def __init__(self, base: Scope):
        self.base = base
        self.tags: set = set()

    def resolve(self, var: A.Variable):
        key, t = self.base.resolve(var)
        self.tags.add(key[0])
        return key, t


def _flatten_and(e: A.Expression) -> list:
    if isinstance(e, A.And):
        return _flatten_and(e.left) + _flatten_and(e.right)
    return [e]


def _rebuild_and(conjs: list) -> A.Expression:
    out = conjs[0]
    for c in conjs[1:]:
        out = A.And(out, c)
    return out


def analyze_equi_join(on: A.Expression, side_scope: Scope):
    """First top-level ``==`` conjunct with one pure-L and one pure-R
    side -> ``(EquiKey, residual AST or None)``; ``(None, None)`` when
    the ON condition has no band key (the grid)."""
    conjs = _flatten_and(on)
    for i, c in enumerate(conjs):
        if not isinstance(c, A.Compare) or c.op != "==":
            continue
        try:
            lrec = _TagRecorder(side_scope)
            lce = compile_expression(c.left, lrec)
            rrec = _TagRecorder(side_scope)
            rce = compile_expression(c.right, rrec)
        except CompileError:
            continue
        if lrec.tags == {"L"} and rrec.tags == {"R"}:
            lk, rk = lce, rce
        elif lrec.tags == {"R"} and rrec.tags == {"L"}:
            lk, rk = rce, lce
        else:
            continue      # constant / single-side / mixed-side conjunct
        if lk.type in NUMERIC_TYPES and rk.type in NUMERIC_TYPES:
            kt = promote(lk.type, rk.type)
            lk, rk = _widen(lk, kt), _widen(rk, kt)
        elif lk.type is rk.type and lk.type in (AttrType.STRING,
                                                AttrType.BOOL):
            kt = lk.type
        else:
            continue
        residual = conjs[:i] + conjs[i + 1:]
        return EquiKey(lk, rk, kt), \
            (_rebuild_and(residual) if residual else None)
    return None, None


def equi_route_columns(on: A.Expression, side_scope: Scope):
    """``{'L': col_idx, 'R': col_idx}`` when the first top-level ``==``
    conjunct compares bare attributes of both sides (the reference's mesh
    router's key columns), else None."""
    for c in _flatten_and(on):
        if not isinstance(c, A.Compare) or c.op != "==":
            continue
        if not (isinstance(c.left, A.Variable)
                and isinstance(c.right, A.Variable)):
            continue
        try:
            (ltag, lidx), _lt = side_scope.resolve(c.left)
            (rtag, ridx), _rt = side_scope.resolve(c.right)
        except CompileError:
            continue
        if {ltag, rtag} == {"L", "R"}:
            return {ltag: lidx, rtag: ridx}
    return None


class JoinCross:
    """One trigger direction of a join: cross the trigger side's
    window-output batch with the opposite side's findable buffer."""

    def __init__(self, trigger_is_left: bool, left_schema: StreamSchema,
                 right_schema: StreamSchema, on: Optional[A.Expression],
                 side_scope: JoinSideScope, join_type: str,
                 join_cap: int = 1024,
                 opp_window_ms: Optional[int] = None,
                 cand_cap: Optional[int] = None):
        self.trigger_is_left = trigger_is_left
        # the opposite side is a sliding time window: a pair counts only
        # if the opposite row was alive at the trigger row's time
        # (coalesced timer steps may leave expired rows in the opposite
        # buffer)
        self.opp_window_ms = opp_window_ms
        self.left_schema = left_schema
        self.right_schema = right_schema
        self.join_type = join_type
        self.cap = join_cap
        # candidates of the probe's residual stage, before compaction to
        # JOIN_CAP: @cap(join.candidates), default 4x join.pairs
        self.cand_cap = int(cand_cap) if cand_cap else 4 * join_cap
        self.cond = None
        self.equi: Optional[EquiKey] = None
        self.residual = None
        self.kernel = "grid"   # the planner sets "probe" (core/runtime.py)
        self.route_cols = None
        tag = "L" if trigger_is_left else "R"

        def side_of(key):   # trigger side 0, opposite side 1
            if key == ("ts",):   # the reference binds the trigger's __ts__
                return 0, TS_COL
            return (0 if key[0] == tag else 1), key[1]
        if on is not None:
            cond = compile_expression(on, side_scope)
            if cond.type is not AttrType.BOOL:
                raise CompileError("join ON condition must be BOOL")
            self.cond = PairProgram([cond], True, side_of)
            self.route_cols = equi_route_columns(on, side_scope)
            equi, residual_ast = analyze_equi_join(on, side_scope)
            if equi is not None:
                self.equi = equi
                tk, ok = (equi.left, equi.right) if trigger_is_left \
                    else (equi.right, equi.left)
                self.tkey = PairProgram([tk], False, side_of)
                self.okey = PairProgram([ok], False, side_of)
                if self.tkey.reads_ts or self.okey.reads_ts:
                    raise NotImplementedError(
                        "not ported yet: eventTimestamp() in a join's "
                        "equality key")
                if residual_ast is not None:
                    self.residual = PairProgram(
                        [compile_expression(residual_ast, side_scope)],
                        True, side_of)
        # does the trigger side emit unmatched one-sided rows?
        self.outer = (
            join_type == "full_outer"
            or (join_type == "left_outer" and trigger_is_left)
            or (join_type == "right_outer" and not trigger_is_left))

    def cross(self, trig: EventBatch, opp_buf: dict,
              gate_alive: bool = False):
        """trig: the trigger side's window output [B]; opp_buf: the
        opposite side's findable buffer (ts/seq/cols/nulls/valid). ->
        (joined batch [JOIN_CAP], pairs lost: int64 0-d). Both kernels
        give identical rows, order and counts."""
        if self.kernel == "probe" and self.equi is not None:
            return join_probe(self, trig, opp_buf, gate_alive)
        return join_grid(self, trig, opp_buf, gate_alive)

    def need_residual(self, gate_alive: bool) -> bool:
        return self.residual is not None or (
            gate_alive and self.opp_window_ms is not None)

    def n_cols(self):
        return len(self.left_schema.types), len(self.right_schema.types)


# ---------------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------------

def _joinable(trig: EventBatch):
    return trig.valid & ((trig.kind == CURRENT) | (trig.kind == EXPIRED))


def _gather_out(cross: JoinCross, trig: EventBatch, opp_buf: dict, ti, oi,
                is_pair, valid_out) -> EventBatch:
    """The joined batch: left columns then right, the trigger side's at
    ``ti``, the opposite side's at ``oi`` (nulled where not a pair)."""
    n_l, n_r = cross.n_cols()
    cols, nulls = [], []
    for i in range(n_l + n_r):
        if cross.trigger_is_left:
            from_trigger, a = i < n_l, (i if i < n_l else i - n_l)
        else:
            from_trigger, a = i >= n_l, (i - n_l if i >= n_l else i)
        if from_trigger:
            cols.append(trig.cols[a][ti])
            nulls.append(trig.nulls[a][ti])
        else:
            cols.append(opp_buf["cols"][a][oi])
            nulls.append(opp_buf["nulls"][a][oi] | ~is_pair)
    return EventBatch(ts=trig.ts[ti], cols=tuple(cols), nulls=tuple(nulls),
                      kind=trig.kind[ti], valid=valid_out)


def _ss(sorted_seq, values, right: bool):
    """searchsorted over a non-decreasing sequence (any bisection gives
    the same answer there)."""
    return torch.searchsorted(sorted_seq, values.to(sorted_seq.dtype),
                              right=right)


def cross_grid_ref(cross: JoinCross, trig: EventBatch, opp_buf: dict,
                   gate_alive: bool = False):
    """Plain PyTorch version of K7's grid (``JoinCross._cross_grid``).
    The reference's [B, W] indicator rows are built only for the
    joinable trigger rows: every other row's is its lead flag repeated,
    so its counts and each output slot's position in it follow directly
    (the same numbers as the whole grid gives)."""
    B = trig.capacity
    W = opp_buf["seq"].shape[0]
    dev = trig.ts.device
    joinable = _joinable(trig)
    jrows = torch.nonzero(joinable)[:, 0]
    nj = jrows.shape[0]
    if cross.cond is not None:
        sides = (side_cols(trig.cols, trig.nulls, jrows[:, None]),
                 side_cols(opp_buf["cols"], opp_buf["nulls"],
                           (None, slice(None))))
        grid, _ = cross.cond.run(sides, (nj, W), dev, trig.ts[jrows][:, None])
    else:
        grid = torch.ones((nj, W), dtype=torch.bool, device=dev)
    pair = grid & opp_buf["valid"][None, :]
    if gate_alive and cross.opp_window_ms is not None:
        pair = pair & (opp_buf["ts"][None, :] + cross.opp_window_ms
                       >= trig.ts[jrows][:, None])
    npairs = torch.zeros((B,), dtype=torch.int32, device=dev)
    npairs[jrows] = pair.sum(1, dtype=torch.int32)
    lone = joinable & (npairs == 0) if cross.outer else \
        torch.zeros_like(joinable)
    reset = trig.valid & (trig.kind == RESET)
    lead = (lone | reset).to(torch.int32)
    counts = lead + npairs
    offs = torch.cumsum(counts, 0, dtype=torch.int32)
    total = offs[B - 1].to(I64)
    j = torch.arange(cross.cap, dtype=torch.int32, device=dev)
    r = torch.clamp(_ss(offs, j, True), 0, B - 1)
    start = offs[r] - counts[r]
    k = j - start
    # c: the slot's place in its row's indicators [lead, pair_0, ...]
    c = torch.where(k < lead[r], 0, W + 1).to(I64)
    pos = torch.full((B,), -1, dtype=I64, device=dev)
    pos[jrows] = torch.arange(nj, dtype=I64, device=dev)
    on_grid = pos[r] >= 0
    if nj and bool(on_grid.any()):
        inner = torch.cumsum(torch.cat([lead[jrows][:, None],
                                        pair.to(torch.int32)], 1), 1,
                             dtype=torch.int32)
        sl = torch.nonzero(on_grid)[:, 0]
        c[sl] = torch.searchsorted(inner[pos[r[sl]]], k[sl][:, None],
                                   right=True)[:, 0]
    valid_out = j < total
    is_pair = c > 0
    oi = torch.clamp(c - 1, 0, W - 1)
    out = _gather_out(cross, trig, opp_buf, r, oi, is_pair, valid_out)
    return out, torch.clamp(total - cross.cap, min=0)


def _keys(prog: PairProgram, cols, nulls, n, side, t, dev):
    sides = [(), ()]
    sides[side] = side_cols(cols, nulls)
    _k, outs = prog.run(sides, (n,), dev)
    v, null = outs[0]
    return encode_keys(v, t), null


def cross_probe_ref(cross: JoinCross, trig: EventBatch, opp_buf: dict,
                    gate_alive: bool = False):
    """Plain PyTorch version of K7's probe (``JoinCross._cross_probe``)."""
    B = trig.capacity
    W = opp_buf["seq"].shape[0]
    dev = trig.ts.device
    kt = cross.equi.key_type
    tkv, tknull = _keys(cross.tkey, trig.cols, trig.nulls, B, 0, kt, dev)
    okv, oknull = _keys(cross.okey, opp_buf["cols"], opp_buf["nulls"], W, 1,
                        kt, dev)
    live = opp_buf["valid"] & ~oknull
    order, sk, n_live = sorted_key_view(okv, live, kt)
    joinable = _joinable(trig)
    act = joinable & ~tknull     # null keys match nothing
    lo, hi = band_bounds(sk, n_live, tkv, "==", act)
    cnt = (hi - lo).to(I64)
    reset = trig.valid & (trig.kind == RESET)
    need = cross.need_residual(gate_alive)
    if need:
        CAND = cross.cand_cap
        coffs = torch.cumsum(cnt, 0)
        ctotal = coffs[B - 1]
        cj = torch.arange(CAND, dtype=torch.int32, device=dev)
        cr = torch.clamp(_ss(coffs, cj, True), 0, B - 1)
        ck = cj - (coffs[cr] - cnt[cr])
        cvalid = cj < ctotal
        cp = torch.clamp(lo[cr] + ck, 0, W - 1)
        coi = order[cp]
        s = cvalid
        if cross.residual is not None:
            sides = (side_cols(trig.cols, trig.nulls, cr),
                     side_cols(opp_buf["cols"], opp_buf["nulls"], coi))
            keep, _ = cross.residual.run(sides, (CAND,), dev, trig.ts[cr])
            s = s & keep
        if gate_alive and cross.opp_window_ms is not None:
            s = s & (opp_buf["ts"][coi] + cross.opp_window_ms
                     >= trig.ts[cr])
        surv = torch.zeros((B,), dtype=I64, device=dev).index_add_(
            0, cr, s.to(I64))
        cand_lost = torch.clamp(ctotal - CAND, min=0)
        S = torch.cumsum(s.to(I64), 0)
        soffs = torch.cumsum(surv, 0)
    else:
        surv = cnt
        cand_lost = torch.zeros((), dtype=I64, device=dev)
    matched = surv > 0
    lone = joinable & ~matched if cross.outer else torch.zeros_like(joinable)
    lead = (lone | reset).to(I64)
    tot = lead + surv
    offs = torch.cumsum(tot, 0)
    total = offs[B - 1]
    j = torch.arange(cross.cap, dtype=torch.int32, device=dev)
    r = torch.clamp(_ss(offs, j, True), 0, B - 1)
    start = offs[r] - tot[r]
    k = j - start
    valid_out = j < total
    is_pair = valid_out & (k >= lead[r])
    if need:
        m = (soffs[r] - surv[r]) + (k - lead[r])
        c = torch.clamp(_ss(S, m + 1, False), 0, cross.cand_cap - 1)
        oi = coi[c]
    else:
        p = torch.clamp(lo[r] + (k - lead[r]), 0, W - 1)
        oi = order[p]
    out = _gather_out(cross, trig, opp_buf, r, oi, is_pair, valid_out)
    return out, torch.clamp(total - cross.cap, min=0) + cand_lost


# ---------------------------------------------------------------------------
# kernel K7 wrappers
# ---------------------------------------------------------------------------

def join_args(cross: JoinCross, trig: EventBatch, opp_buf: dict,
              gate_alive: bool, probe: bool):
    """K7's arguments: the output batch and lost counter (fresh), the
    scratch, and ``_kernels.JoinArgs`` pointing at them. -> (out, lost,
    args)."""
    dev = trig.ts.device
    B, W, CAP = trig.capacity, opp_buf["seq"].shape[0], cross.cap
    n_l, n_r = cross.n_cols()
    if n_l + n_r > _kernels.JOIN_MAX_OUT:
        raise NotImplementedError(
            f"not ported yet: a join of more than {_kernels.JOIN_MAX_OUT} "
            f"attributes ({n_l + n_r})")
    for t in (trig.ts, opp_buf["ts"], *trig.cols, *opp_buf["cols"]):
        if t.device != dev:
            raise ValueError(f"join kernel: a side's tensors are on "
                             f"{t.device}, the trigger batch on {dev}")
    a = _kernels.JoinArgs()
    fill_side(a.trig, trig.ts, trig.kind, trig.valid, trig.cols, trig.nulls)
    fill_side(a.opp, opp_buf["ts"], None, opp_buf["valid"], opp_buf["cols"],
              opp_buf["nulls"])
    out_cols, out_nulls = [], []
    for i in range(n_l + n_r):
        if cross.trigger_is_left:
            from_trigger, c = i < n_l, (i if i < n_l else i - n_l)
        else:
            from_trigger, c = i >= n_l, (i - n_l if i >= n_l else i)
        src = trig.cols[c] if from_trigger else opp_buf["cols"][c]
        out_cols.append(torch.empty((CAP,), dtype=src.dtype, device=dev))
        out_nulls.append(torch.empty((CAP,), dtype=torch.bool, device=dev))
        a.out_from_trig[i], a.out_col[i] = int(from_trigger), c
        a.out_cols[i] = out_cols[-1].data_ptr()
        a.out_nulls[i] = out_nulls[-1].data_ptr()
        a.out_size[i] = src.element_size()
    out = EventBatch(ts=torch.empty((CAP,), dtype=I64, device=dev),
                     cols=tuple(out_cols), nulls=tuple(out_nulls),
                     kind=torch.empty((CAP,), dtype=torch.int32, device=dev),
                     valid=torch.empty((CAP,), dtype=torch.bool, device=dev))
    lost = torch.empty((), dtype=I64, device=dev)
    a.n_out = n_l + n_r
    a.out_ts, a.out_kind, a.out_valid = (out.ts.data_ptr(),
                                         out.kind.data_ptr(),
                                         out.valid.data_ptr())
    a.lost = lost.data_ptr()
    a.B, a.W, a.CAP = B, W, CAP
    a.outer = int(cross.outer)
    a.gate = int(gate_alive and cross.opp_window_ms is not None)
    a.win_ms = int(cross.opp_window_ms or 0)
    need = probe and cross.need_residual(gate_alive)
    CAND = cross.cand_cap if need else 1
    a.probe, a.need_resid, a.CAND = int(probe), int(need), CAND

    def scratch(n, dtype):
        return torch.empty((max(int(n), 1),), dtype=dtype, device=dev)
    sc = {"trig_keys": scratch(B, I64), "act": scratch(B, torch.uint8),
          "lo": scratch(B, torch.int32),
          "cnt": scratch(B, I64), "coffs": scratch(B, I64),
          "coi": scratch(CAND, torch.int32), "s": scratch(CAND, torch.uint8),
          "S": scratch(CAND, I64), "surv": scratch(B, I64),
          "soffs": scratch(B, I64), "tot": scratch(B, I64),
          "offs": scratch(B, I64), "lead": scratch(B, torch.uint8),
          "ti": scratch(CAP, torch.int32), "oi": scratch(CAP, torch.int32),
          "is_pair": scratch(CAP, torch.uint8),
          "psum": scratch((max(CAND, B) + 1023) // 1024, I64)}
    for k, t in sc.items():
        setattr(a, k, t.data_ptr())
    if probe:
        kt = cross.equi.key_type
        a.key_type, a.big = VT[kt], big_key(kt)
        a.levels = search_levels(W)
        fill_prog(a.tkey, cross.tkey, dev)
        fill_prog(a.okey, cross.okey, dev)
        fill_prog(a.resid, cross.residual, dev)
        blocks = (W + 1023) // 1024
        ks = {"k1": scratch(W, I64), "k2": scratch(W, I64),
              "i1": scratch(W, torch.int32), "i2": scratch(W, torch.int32),
              "keys": scratch(W, I64), "pad": scratch(W, torch.uint8),
              "order": scratch(W, torch.int32), "sk": scratch(W, I64),
              "n_live": scratch(1, I64),
              "counts": scratch(256 * blocks, torch.int32)}
        for k, t in ks.items():
            setattr(a.sort, k, t.data_ptr())
        sc["sort"] = ks
    else:
        fill_prog(a.cond, cross.cond, dev)
    a._keep = (trig, opp_buf, out, lost, sc)
    return out, lost, a


def _launch(name: str, cross, trig, opp_buf, gate_alive, probe: bool):
    dev = trig.ts.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    out, lost, args = join_args(cross, trig, opp_buf, gate_alive, probe)
    getattr(_kernels.load(), name)(
        args, torch.cuda.current_stream(dev).cuda_stream)
    _kernels.count_launch(name)
    return out, lost


def join_probe(cross: JoinCross, trig: EventBatch, opp_buf: dict,
               gate_alive: bool = False):
    """Kernel K7's banded probe. CPU tensors take ``cross_probe_ref``."""
    if trig.ts.device.type == "cpu":
        return cross_probe_ref(cross, trig, opp_buf, gate_alive)
    return _launch("join_probe", cross, trig, opp_buf, gate_alive, True)


def join_grid(cross: JoinCross, trig: EventBatch, opp_buf: dict,
              gate_alive: bool = False):
    """Kernel K7's grid. CPU tensors take ``cross_grid_ref``."""
    if trig.ts.device.type == "cpu":
        return cross_grid_ref(cross, trig, opp_buf, gate_alive)
    return _launch("join_grid", cross, trig, opp_buf, gate_alive, False)
