"""NFA pattern/sequence compiler and engine base (PyTorch port of
siddhi_tpu/ops/nfa.py).

Reference mapping (modules/siddhi-core/.../query/input/stream/state/):
- StreamPreStateProcessor.java:364-403 (processAndReturn: per pending
  partial match, set this state's slot, run the filter chain, forward on
  match; pattern keeps unmatched pendings, sequence kills them)
- StreamPostStateProcessor.java:64-85 (stateChanged, forward to the next
  state's pre-processor)
- StreamPreStateProcessor.addEveryState:219-241 ('every' re-arm)
- StreamPreStateProcessor.isExpired:118-129 (within pruning)
- CountPreStateProcessor / CountPostStateProcessor (count <m:n>)

The compiler (``NfaCompiler``), the scopes (``PatternScope``,
``MatchScope``) and the selector rewrites are the reference's, copied:
they are host code. The engine keeps ONE table of partial matches on the
device, as the reference does (struct-of-arrays tensors, capacity M):
each row holds its waiting state, its captured slot columns [M, cap],
fill counts, born counter and seq. ``NfaEngine`` here holds the compiled
states and that table; its per-event scan step (kernel K4 of PERF.md)
is not ported yet, and the round-parallel step (kernel K3) lives in
ops/nfa_parallel.py.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core.event import Attribute, StreamSchema
from ..core.types import AttrType, torch_dtype
from ..lang import ast as A
from .expr import CompileError, CompiledExpr, Scope, compile_expression
from .sentinels import POS_INF


# ---------------------------------------------------------------------------
# compile: AST state tree -> linear NFA
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SlotSpec:
    """One StateEvent slot (= one stream state element's capture)."""
    ref: Optional[str]          # e1 / e2 ... (event_ref)
    stream_id: str
    schema: StreamSchema
    cap: int                    # 1 for plain states, >1 for counting states


@dataclasses.dataclass
class NfaStateSpec:
    idx: int
    slot: int
    stream_id: str
    cond_ast: Optional[A.Expression]
    next_idx: int               # -1 => completing this state emits a match
    every_arm: int              # -1 or state idx re-armed on forward
    clear_from: int             # first slot cleared on re-arm
    is_start: bool = False
    always_armed: bool = False  # implicit empty pending at every event
    armed_once: bool = False    # explicit initial pending at t=0
    # sequence start refinements (StreamPreStateProcessor.init():178-194,
    # resetState():288-305 — see compile() for the per-shape mapping)
    rearm_each_round: bool = False   # every-scoped seq start: respawn an
    # empty pending at each event round when none is live
    suppress_when_next_busy: bool = False  # plain seq start before an
    # absent state: no new attempt while the wait is pending
    viol_push: bool = False     # absent start: a violating event re-arms
    # the deadline to ev_ts + waiting_ms instead of killing the row
    # (AbsentStreamPostStateProcessor.process:55 updateLastArrivalTime)
    viol_latch: bool = False    # no-`for` absent in an every-start group:
    # a violation latches the lane DEAD; the partner's next fill fails
    # and re-initializes a fresh group (partnerCanProceed every-branch:
    # lastArrivalTime reset + init())
    min_count: int = 1
    max_count: int = 1          # -1 == unbounded
    # logical and/or groups (LogicalPreStateProcessor.java:33): both sides
    # share an anchor (the left side's idx) where rows wait; `partner`
    # links the sides. Absent states (AbsentStreamPreStateProcessor
    # .java:35) kill on a matching event and complete on deadline.
    partner: int = -1
    logical_op: Optional[str] = None   # 'and' | 'or'
    anchor: int = -1                   # group anchor (== idx when plain)
    is_absent: bool = False
    waiting_ms: int = 0
    # which deadline lane this absent side arms: 0 = table['deadline'],
    # 1 = table['deadline2'] (only both-absent logical groups use lane 1)
    dl_field: int = 0
    cond: Optional[CompiledExpr] = None

    @property
    def is_counting(self) -> bool:
        return not (self.min_count == 1 and self.max_count == 1)


class NfaCompiler:
    """StateInputStream AST -> (slots, states). Linear chains of stream
    states with filters, counts <m:n>/+/*, and 'every' scopes; logical
    and/or and absent states are rejected for now (follow-up stage)."""

    def __init__(self, schemas: dict, state_type: str, count_cap: int = 16):
        self.schemas = schemas
        self.state_type = state_type
        self.count_cap = count_cap
        self.slots: list[SlotSpec] = []
        self.states: list[NfaStateSpec] = []

    def compile(self, root: A.StateElement):
        entry, exits = self._element(root)
        for e in exits:
            self.states[e].next_idx = -1
        for st in self.states:
            if st.anchor < 0:
                st.anchor = st.idx
        start = self.states[entry]
        start.is_start = True
        if start.partner >= 0:
            self.states[start.partner].is_start = True
        plain_start = start.partner < 0 and not start.is_absent
        # is the start state re-armed by an `every` scope?
        every_start = any(s.every_arm == entry for s in self.states)
        if self.state_type == "sequence":
            self._compile_sequence_start(start, plain_start, every_start)
        elif plain_start and (start.every_arm == start.idx or (
                start.idx in [self.states[e].every_arm
                              for e in range(len(self.states))]
                and self._single_state_scope(start))):
            start.always_armed = True
        else:
            start.armed_once = True
            # pattern-start standalone absents: a violating event pushes
            # the deadline (the scheduler re-creates the pending and fires
            # at the pushed lastScheduledTime —
            # AbsentStreamPreStateProcessor.process:163-179 initialize,
            # :216-223 reschedule)
            if start.is_absent and start.waiting_ms > 0 \
                    and start.partner < 0:
                start.viol_push = True
        if self.state_type != "sequence":
            # `X and not Y for t` absent sides in patterns never die on a
            # violation — it only pushes lastArrivalTime, delaying the
            # satisfied-marker fire (AbsentLogicalPreStateProcessor
            # .processAndReturn has no remove-on-stateChanged branch;
            # LogicalAbsent testQueryAbsent10 pins the late completion).
            # OR lanes and double-absent lanes DIE on violation instead
            # (testQueryAbsent30/32/46 pin the killed lane).
            for st in self.states:
                if st.is_absent and st.partner < 0:
                    continue
                if st.is_absent and st.waiting_ms > 0:
                    p = self.states[st.partner]
                    # ...but a group in FINAL position removes on
                    # violation (the absent's post IS thisLastProcessor,
                    # so isEventReturned triggers the remove —
                    # EveryAbsent testQueryAbsent46 pins the kill)
                    if st.logical_op == "and" and not p.is_absent and \
                            self.states[st.anchor].next_idx != -1:
                        st.viol_push = True
                elif st.is_absent and st.waiting_ms == 0:
                    p = self.states[st.partner]
                    if st.logical_op == "and" and not p.is_absent and \
                            every_start and st.is_start:
                        st.viol_latch = True
        # single-state every scopes collapse re-arm into always_armed
        for st in self.states:
            if st.is_start and any(
                    s.every_arm == st.idx and s.idx == st.idx
                    for s in self.states):
                if self.state_type != "sequence" and st.partner < 0 \
                        and not st.is_absent:
                    st.always_armed = True
                    st.armed_once = False
        return self.slots, self.states

    def _compile_sequence_start(self, start, plain_start: bool,
                                every_start: bool):
        """Sequence start arming (StreamPreStateProcessor.init():178-194):
        - plain non-every start: ONE initial pending, never re-armed
          (`initialized` latches; SequenceTestCase testQuery29/31)
        - plain start whose next state is absent: re-initialized each round
          unless the wait is pending (init() nextState-instanceof-Absent
          clause + resetState early return)
        - every-scoped starts: re-initialized at every event round
        - absent/logical starts: initial pending; violations push the
          deadline for every-scoped (and pattern-like) shapes, kill
          permanently for non-every sequences"""
        nxt = self.states[start.next_idx] \
            if 0 <= start.next_idx < len(self.states) else None
        if plain_start:
            if start.is_counting:
                if every_start:
                    # every-scoped counting starts re-init per round
                    # (CountPreStateProcessor.startStateReset:168) —
                    # always-armed keeps the parallel-engine fast path
                    start.always_armed = True
                else:
                    # ONE absorbing pending for the whole run
                    start.armed_once = True
            elif every_start:
                start.armed_once = True
                start.rearm_each_round = True
            elif nxt is not None and (
                    nxt.is_absent or (nxt.partner >= 0 and (
                        nxt.is_absent
                        or self.states[nxt.partner].is_absent))):
                start.always_armed = True
                start.suppress_when_next_busy = not every_start
            else:
                start.armed_once = True   # one-shot
        else:
            start.armed_once = True
            if every_start:
                start.rearm_each_round = True
            group = [start] + ([self.states[start.partner]]
                               if start.partner >= 0 else [])
            for st in group:
                if st.is_absent and st.waiting_ms > 0:
                    # standalone non-every sequence starts latch
                    # permanently (initialize suppressed); standalone
                    # every starts push; `X and not Y for t` lanes in
                    # NON-final position push exactly like patterns (no
                    # remove-on-stateChanged)
                    if st.partner < 0:
                        st.viol_push = every_start
                    else:
                        p = self.states[st.partner]
                        st.viol_push = (
                            st.logical_op == "and" and not p.is_absent
                            and self.states[st.anchor].next_idx != -1)

    def _single_state_scope(self, start) -> bool:
        return any(s.every_arm == start.idx and s.idx == start.idx
                   for s in self.states)

    # -- element walkers -------------------------------------------------
    def _element(self, el: A.StateElement):
        """Returns (entry_state_idx, [exit_state_idxs])."""
        if isinstance(el, A.AbsentStreamStateElement):
            if el.waiting_time_ms <= 0:
                raise CompileError(
                    "standalone absent patterns need 'for <time>' "
                    "(reference grammar: not X for t, or not X and Y)")
            idx, _ = self._stream(el, cap=1, min_c=1, max_c=1)
            self.states[idx].is_absent = True
            self.states[idx].waiting_ms = int(el.waiting_time_ms)
            return idx, [idx]
        if isinstance(el, A.StreamStateElement):
            return self._stream(el, cap=1, min_c=1, max_c=1)
        if isinstance(el, A.CountStateElement):
            mx = el.max_count
            cap = self.count_cap if mx == -1 else max(mx, 1)
            return self._stream(el.stream, cap=cap, min_c=el.min_count,
                                max_c=mx)
        if isinstance(el, A.NextStateElement):
            e1, x1 = self._element(el.state)
            e2, x2 = self._element(el.next)
            for x in x1:
                self.states[x].next_idx = e2
            return e1, x2
        if isinstance(el, A.EveryStateElement):
            entry, exits = self._element(el.state)
            scope_first_slot = self.states[entry].slot
            for x in exits:
                self.states[x].every_arm = entry
                self.states[x].clear_from = scope_first_slot
            return entry, exits
        if isinstance(el, A.LogicalStateElement):
            return self._logical(el)
        raise CompileError(f"unsupported state element {type(el).__name__}")

    def _logical(self, el: A.LogicalStateElement):
        """A and B / A or B / not A and B — two plain sides sharing an
        anchor (reference LogicalPreStateProcessor pairs)."""
        def side(s):
            if isinstance(s, A.AbsentStreamStateElement):
                idx, _ = self._stream(s, cap=1, min_c=1, max_c=1)
                self.states[idx].is_absent = True
                self.states[idx].waiting_ms = int(s.waiting_time_ms)
                return idx
            if isinstance(s, A.StreamStateElement):
                idx, _ = self._stream(s, cap=1, min_c=1, max_c=1)
                return idx
            raise CompileError(
                "logical (and/or) sides must be plain stream states")

        li = side(el.left)
        ri = side(el.right)
        ls, rs = self.states[li], self.states[ri]
        if el.op not in ("and", "or"):
            raise CompileError(f"unknown logical op '{el.op}'")
        for st in (ls, rs):
            if st.is_absent and st.waiting_ms <= 0 and (
                    (ls.is_absent and rs.is_absent) or el.op == "or"):
                raise CompileError(
                    "absent sides of 'or' / double-absent groups need "
                    "'for <time>' (AbsentLogicalPreStateProcessor)")
        if ls.is_absent and rs.is_absent:
            rs.dl_field = 1   # second deadline lane
        ls.partner, rs.partner = ri, li
        ls.logical_op = rs.logical_op = el.op
        ls.anchor = rs.anchor = li
        return li, [li]

    def _stream(self, el: A.StreamStateElement, cap, min_c, max_c):
        sin = el.stream
        schema = self.schemas.get(sin.stream_id)
        if schema is None:
            raise CompileError(f"undefined stream '{sin.stream_id}' in "
                               "pattern")
        conds = []
        for h in sin.handlers:
            if isinstance(h, A.Filter):
                conds.append(h.expression)
            else:
                raise CompileError(
                    "windows/stream functions inside pattern states are not "
                    "supported")
        cond = None
        if conds:
            cond = conds[0]
            for c in conds[1:]:
                cond = A.And(cond, c)
        slot = len(self.slots)
        self.slots.append(SlotSpec(el.event_ref, sin.stream_id, schema, cap))
        idx = len(self.states)
        self.states.append(NfaStateSpec(
            idx=idx, slot=slot, stream_id=sin.stream_id, cond_ast=cond,
            next_idx=-1, every_arm=-1, clear_from=0,
            min_count=min_c, max_count=max_c))
        return idx, [idx]


# ---------------------------------------------------------------------------
# pattern variable scope
# ---------------------------------------------------------------------------


class PatternScope(Scope):
    """Resolves e1.attr / e1[i].attr / bare stream-name.attr over the match
    slots. Used both for state conditions (where the state's own slot is the
    incoming event) and for the selector over the match batch.

    Unindexed references to counting slots resolve to index 0 with
    last-fallback semantics handled by the storage (reference
    ExpressionParser default index SiddhiConstants.UNKNOWN_STATE -> 0)."""

    def __init__(self, slots: list[SlotSpec], own_slot: Optional[int] = None):
        self.slots = slots
        self.own_slot = own_slot  # set for state filter conditions: bare
        # attribute names bind to the state's own stream first
        # (SingleInputStreamParser binds filter vars to the state's meta)

    def _find(self, var: A.Variable):
        ref = var.stream_ref
        if ref is not None:
            for j, s in enumerate(self.slots):
                if s.ref == ref:
                    return j
            matches = [j for j, s in enumerate(self.slots)
                       if s.stream_id == ref]
            if len(matches) == 1:
                return matches[0]
            if len(matches) > 1:
                raise CompileError(
                    f"ambiguous stream reference '{ref}' in pattern")
            raise CompileError(f"unknown event reference '{ref}'")
        if self.own_slot is not None and \
                var.attribute in self.slots[self.own_slot].schema.names:
            return self.own_slot
        # unprefixed: unique attribute across slots
        matches = [j for j, s in enumerate(self.slots)
                   if var.attribute in s.schema.names]
        if len(matches) == 1:
            return matches[0]
        raise CompileError(
            f"attribute '{var.attribute}' is "
            + ("ambiguous" if matches else "unknown") + " in pattern scope")

    def resolve(self, var: A.Variable):
        j = self._find(var)
        spec = self.slots[j]
        a = spec.schema.index_of(var.attribute)
        idx = var.index
        if idx is None:
            if self.own_slot == j:
                # inside a state's own condition the unindexed reference is
                # the incoming event (the slot position being filled)
                return ("slot_last", j, a, 0), spec.schema.types[a]
            idx = 0
        if idx == "last":
            idx = ("last", 0)
        if isinstance(idx, tuple):
            key = ("slot_last", j, a, idx[1])
        else:
            if not isinstance(idx, int) or idx < 0 or idx >= spec.cap:
                raise CompileError(
                    f"event index {idx!r} out of range for '{spec.ref}' "
                    f"(capacity {spec.cap})")
            key = ("slot", j, a, idx)
        return key, spec.schema.types[a]


def _slot_for(stream_ref, slots):
    """The SlotSpec a variable's stream reference binds to (or None)."""
    for sp in slots:
        if sp.ref == stream_ref or (
                sp.ref is None and sp.stream_id == stream_ref):
            return sp
    return None


def _map_children(expr, fn):
    """Rebuild a dataclass AST node with fn applied to every Expression
    child (single fields and lists)."""
    for f in getattr(expr, "__dataclass_fields__", {}):
        v = getattr(expr, f)
        if hasattr(v, "__dataclass_fields__") and isinstance(
                v, A.Expression):
            expr = dataclasses.replace(expr, **{f: fn(v)})
        elif isinstance(v, list) and v and isinstance(
                v[0], A.Expression):
            expr = dataclasses.replace(expr, **{f: [fn(x) for x in v]})
    return expr


def rewrite_last_refs(expr, slots):
    """Replace `e[last]` / `e[last - k]` select references with an
    ifThenElse chain over the slot's copy columns (highest non-null copy
    wins). Runs on the selector AST before compilation, so the match
    batch needs no per-row count column. Underflow (`last - k` before
    k+1 events matched) falls back to copy 0 — the reference returns
    null there; documented deviation."""
    if isinstance(expr, A.Variable) and expr.index is not None:
        idx = expr.index
        k = 0
        if idx == "last":
            k = 0
        elif isinstance(idx, tuple) and idx[0] == "last":
            k = int(idx[1])
        else:
            return expr
        slot = _slot_for(expr.stream_ref, slots)
        if slot is None or slot.cap <= 1:
            return dataclasses.replace(expr, index=0)

        def ref(j):
            return dataclasses.replace(expr, index=j)

        out = ref(0)
        for j in range(max(k, 0), slot.cap):
            # highest filled copy j selects copy j-k
            out = A.AttributeFunction(
                namespace=None, name="ifThenElse",
                parameters=[A.Not(A.IsNull(expr=ref(j))),
                            ref(j - k), out])
        return out
    return _map_children(expr, lambda v: rewrite_last_refs(v, slots))


def rewrite_oob_refs(expr, slots):
    """Replace e[i] references whose copy index exceeds the slot's count
    capacity with a typed NULL literal — the reference returns null there
    (StateMetaStreamEvent default-null beyond captured copies)."""
    if isinstance(expr, A.Variable) and isinstance(expr.index, int):
        sp = _slot_for(expr.stream_ref, slots)
        if sp is not None and expr.index >= sp.cap:
            try:
                t = sp.schema.types[sp.schema.index_of(expr.attribute)]
            except KeyError:
                t = AttrType.DOUBLE
            return A.Constant(value=None, type=t)
        return expr
    return _map_children(expr, lambda v: rewrite_oob_refs(v, slots))


class MatchScope(PatternScope):
    """Selector scope over the flattened match batch: e1[i].attr resolves to
    the corresponding flattened column."""

    def __init__(self, slots, col_index):
        super().__init__(slots)
        self.col_index = col_index

    def resolve(self, var: A.Variable):
        key, t = super().resolve(var)
        if key[0] == "slot":
            _, j, a, c = key
            return ("attr", self.col_index[(j, a, c)]), t
        raise CompileError(
            "e[last] references in select clauses are not supported yet")


# ---------------------------------------------------------------------------
# the device NFA
# ---------------------------------------------------------------------------


class NfaEngine:
    """Holds compiled states and the pending-match table."""

    def __init__(self, slots: list[SlotSpec], states: list[NfaStateSpec],
                 state_type: str, within_ms: Optional[int],
                 capacity: int = 128, out_capacity: int = 256):
        self.slots = slots
        self.states = states
        self.state_type = state_type
        self.within_ms = within_ms
        self.M = capacity
        self.OUT = out_capacity
        for st in states:
            if st.cond_ast is not None:
                st.cond = compile_expression(
                    st.cond_ast, PatternScope(slots, own_slot=st.slot))
                if st.cond.type is not AttrType.BOOL:
                    raise CompileError("pattern filter must be BOOL")
        self.has_absent = any(st.is_absent for st in states)

        # flattened match-batch schema: slot j attr a copy c
        attrs = []
        self.col_index: dict = {}
        for j, s in enumerate(slots):
            for a, att in enumerate(s.schema.attributes):
                for c in range(s.cap):
                    self.col_index[(j, a, c)] = len(attrs)
                    nm = (f"{s.ref or s.stream_id}_{att.name}"
                          + (f"_{c}" if s.cap > 1 else ""))
                    attrs.append(Attribute(nm, att.type))
        self.match_schema = StreamSchema("#match", tuple(attrs))

    # -- state pytree ----------------------------------------------------
    def init_state(self, device="cpu") -> dict:
        """The empty table, with the armed-once start's initial pending
        in row 0, on ``device``."""
        M = self.M

        def full(shape, value, dtype):
            return torch.full(shape, value, dtype=dtype, device=device)

        slots_buf = []
        for s in self.slots:
            slots_buf.append({
                "cols": tuple(full((M, s.cap), 0, torch_dtype(t))
                              for t in s.schema.types),
                "nulls": tuple(full((M, s.cap), True, torch.bool)
                               for _ in s.schema.types),
                "ts": full((M, s.cap), 0, torch.int64),
                "n": full((M,), 0, torch.int32),
            })
        state = full((M,), len(self.states), torch.int32)
        valid = full((M,), False, torch.bool)
        armed_once = [st.idx for st in self.states if st.armed_once]
        if armed_once:
            # explicit initial pending at the start state
            state[0] = armed_once[0]
            valid[0] = True
        return {
            "state": state,
            "valid": valid,
            "ts0": full((M,), 0, torch.int64),
            "has_ts0": full((M,), False, torch.bool),
            "born": full((M,), -1, torch.int64),
            "min_at": full((M,), -1, torch.int64),
            "deadline": full((M,), int(POS_INF), torch.int64),
            "deadline2": full((M,), int(POS_INF), torch.int64),
            "seq": torch.arange(M, dtype=torch.int64, device=device),
            "slots": tuple(slots_buf),
            "next_seq": torch.tensor(M, dtype=torch.int64, device=device),
            "counter": torch.tensor(0, dtype=torch.int64, device=device),
            "overflow": torch.tensor(0, dtype=torch.int64, device=device),
        }

    # -- the per-event scan engine (kernel K4) ---------------------------
    def make_stream_step(self, stream_id: str):
        raise NotImplementedError(
            "not ported yet: the scan NFA engine's stream step (K4)")

    def make_timer_step(self):
        raise NotImplementedError(
            "not ported yet: the scan NFA engine's timer step (K4)")

    def next_due(self, table):
        raise NotImplementedError(
            "not ported yet: the scan NFA engine's due times (K4)")

    def arm_start(self, table, ts):
        raise NotImplementedError(
            "not ported yet: the scan NFA engine's start deadlines (K4)")
