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
states, their shared condition program and that table, and runs the
reference's per-event scan over it: ``stream_step_ref`` and
``timer_step_ref`` are the plain PyTorch version, which follows the
reference's ``event_body`` and ``_advance_time`` function by function;
``scan_step`` and ``timer_step`` launch kernel K4 of PERF.md
(csrc/nfa_scan.cu) for CUDA tensors and take the plain version for CPU
tensors. The round-parallel step (kernel K3) lives in
ops/nfa_parallel.py.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .. import _kernels
from ..core.event import CURRENT, Attribute, EventBatch, StreamSchema
from ..core.types import AttrType, torch_dtype
from ..lang import ast as A
from .expr import (VT, CompileError, CompiledExpr, ProgramBuilder, Scope,
                   compile_expression, run_program)
from .sentinels import POS_INF
from .slots import part_moves, per_slot


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

    def clock_key(self, which: str):
        """The match batch's timestamp and the step's clock: the
        selector runs in kernel K2 over the match batch."""
        return (which,)

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


def load_descriptor(key) -> int:
    """A condition load as kernels K3 and K4 read it
    (csrc/siddhi_kernels.h): kind | slot << 1 | attr << 8 |
    copy-or-k << 16."""
    kind, j, a, ck = key
    return ({"slot": 0, "slot_last": 1}[kind] | (j << 1) | (a << 8)
            | (ck << 16))


def not_ported(what: str):
    return NotImplementedError(f"not ported yet: {what}")


def new_out(eng, dev) -> dict:
    """An empty match batch under construction (the reference's `out`)."""
    OUT = eng.OUT
    return {
        "cols": tuple(torch.zeros((OUT,), dtype=torch_dtype(t), device=dev)
                      for t in eng.match_schema.types),
        "nulls": tuple(torch.ones((OUT,), dtype=torch.bool, device=dev)
                       for _ in eng.match_schema.types),
        "ts": torch.zeros((OUT,), dtype=torch.int64, device=dev),
        "n": torch.zeros((), dtype=torch.int64, device=dev),
        "lost": torch.zeros((), dtype=torch.int64, device=dev),
    }


def match_batch(eng, out) -> EventBatch:
    dev = out["ts"].device
    return EventBatch(
        ts=out["ts"], cols=out["cols"], nulls=out["nulls"],
        kind=torch.zeros((eng.OUT,), dtype=torch.int32, device=dev),
        valid=torch.arange(eng.OUT, device=dev) < out["n"])


def _where(mask, value, x):
    """jnp.where with a Python scalar ``value`` of x's dtype."""
    return torch.where(mask, torch.as_tensor(value, dtype=x.dtype,
                                             device=x.device), x)


def _set_rows(x, d, ok, values):
    """x.at[d].set(values, mode="drop") for per-source destinations d
    (``ok`` marks the sources that land; ``values`` per source or one
    value). -> a new tensor."""
    x = x.clone()
    if values.dim() == 0:
        x[d[ok]] = values
    else:
        x[d[ok]] = values[ok]
    return x


def _set_row(x, d, ok, value):
    """x.at[d].set(value, mode="drop") for one destination row d (0-d),
    written only where ``ok`` (0-d bool) holds."""
    x = x.clone()
    rows = torch.arange(x.shape[0], device=x.device)
    sel = (rows == d) & ok
    shape = (-1,) + (1,) * (x.dim() - 1)
    return torch.where(sel.view(shape), value, x)


class NfaEngine:
    """Holds the compiled states, their shared condition program and the
    pending-match table; its per-event scan step is kernel K4 of PERF.md
    (``scan_step`` / ``timer_step`` below), the round-parallel step K3
    lives in ops/nfa_parallel.py."""

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
        # any absent deadline-fire that must re-arm an `every` scope?
        # (the reference compiles the re-arm appends into _advance_time
        # only then; the port keeps the same static branches)
        self._absent_rearms = any(
            st.is_absent and st.waiting_ms > 0 and
            (st.every_arm >= 0 or states[st.anchor].every_arm >= 0)
            for st in states)
        # waiting time keyed by the ANCHOR state rows wait at (standalone
        # absent states anchor themselves; logical groups anchor left)
        wait_of = [0] * (len(states) + 1)
        wait2_of = [0] * (len(states) + 1)
        for st in states:
            if st.is_absent and st.waiting_ms > 0:
                if st.dl_field == 0:
                    wait_of[st.anchor] = st.waiting_ms
                else:
                    wait2_of[st.anchor] = st.waiting_ms
        self._wait_of = tuple(wait_of)
        self._wait2_of = tuple(wait2_of)
        self._has_dl2 = any(w > 0 for w in wait2_of)

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

        # every state's condition lowered into ONE program (ops/expr.py
        # ProgramBuilder) that both kernels (K3, K4) and both plain
        # versions run; a load is a ("slot" | "slot_last", j, a, c-or-k)
        # key, read through the own-slot rule of _slot_env
        b = ProgramBuilder()
        self.cond_span = {st.idx: b.condition(st.cond)
                          for st in states if st.cond is not None}
        self.program = b.build()
        for key in self.program.inputs:
            if not (isinstance(key, tuple) and key[0] in ("slot",
                                                          "slot_last")
                    and key[3] < 2 ** 15):
                raise not_ported(f"pattern condition load {key!r}")
        self._device_program: dict = {}
        self._plans: dict = {}
        self._scratch: dict = {}
        self._check_limits()

    def _check_limits(self) -> None:
        """Plan-time limits of the engine's kernel (here K4)."""
        check_scan_limits(self)

    def device_program(self, dev):
        """The condition program as device tensors (code, constants, load
        descriptors), built once per device."""
        key = str(dev)
        prog = self._device_program.get(key)
        if prog is None:
            p = self.program
            prog = (torch.tensor(list(p.code) or [0], dtype=torch.int32,
                                 device=dev),
                    torch.tensor(list(p.consts) or [0], dtype=torch.int64,
                                 device=dev),
                    torch.tensor([load_descriptor(k) for k in p.inputs]
                                 or [0], dtype=torch.int32, device=dev))
            self._device_program[key] = prog
        return prog

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

    # -- the scan engine's steps (kernel K4, or its plain version) --------
    def make_stream_step(self, stream_id: str):
        """(table, batch, due=None) -> (table', match batch); ``due``, a
        0-d int64 tensor, receives next_due(table')."""
        def step(table, batch, due=None):
            return scan_step(self, stream_id, table, batch, due)
        return step

    def make_timer_step(self):
        """(table, now, due=None) -> (table', match batch): the deadline-
        only advance the scheduler fires when no event arrives in time."""
        def step(table, now, due=None):
            return timer_step(self, table, now, due)
        return step

    def scan_states(self, stream_id: str):
        """(consuming states, always-armed starts of this stream, persona
        sources per consuming state, every-scoped sequence starts)."""
        plan = self._plans.get(stream_id)
        if plan is None:
            consuming = [st for st in self.states
                         if st.stream_id == stream_id]
            # always-armed starts spawn only from THEIR OWN stream's events
            arm_starts = [st for st in self.states
                          if st.always_armed and st.stream_id == stream_id]
            # counting states whose forwarded persona answers state st
            persona_sources = {
                st.idx: [cs for cs in self.states
                         if cs.is_counting and cs.next_idx == st.idx]
                for st in consuming}
            rearm_starts = [st for st in self.states
                            if st.rearm_each_round] \
                if self.state_type == "sequence" else []
            plan = self._plans[stream_id] = (consuming, arm_starts,
                                             persona_sources, rearm_starts)
        return plan

    # -- per-event core (vectorised over the M pending rows) -------------
    def _slot_env(self, table, ev_cols, ev_nulls, own_slot: int):
        """Loader for condition evaluation (_slot_env :603): the own
        slot's 'current' view is the incoming event appended at position
        n; other slots read the table. ``("slot_last", j, a, k)`` gathers
        copy n-1-k, clipped to [0, cap-1]."""
        def load(key):
            kind, j, a, ck = key
            spec = self.slots[j]
            buf = table["slots"][j]
            if kind == "slot":
                vals = buf["cols"][a][:, ck]
                nulls = buf["nulls"][a][:, ck]
                if j == own_slot:
                    # the event lands at position n (post-append view)
                    at_n = buf["n"] == ck
                    vals = torch.where(at_n, ev_cols[a], vals)
                    nulls = torch.where(at_n, ev_nulls[a], nulls)
                return vals, nulls
            n_eff = buf["n"] + (1 if j == own_slot else 0)
            pos = torch.clamp(n_eff - 1 - ck, 0, spec.cap - 1).long()
            vals = torch.gather(buf["cols"][a], 1, pos[:, None])[:, 0]
            nulls = torch.gather(buf["nulls"][a], 1, pos[:, None])[:, 0]
            if j == own_slot and ck == 0:
                at_n = pos == torch.clamp(buf["n"], 0, spec.cap - 1)
                vals = torch.where(at_n, ev_cols[a], vals)
                nulls = torch.where(at_n, ev_nulls[a], nulls)
            return vals, nulls
        return load

    def _virtual_env(self, st, ev_cols, ev_nulls):
        """Loader for a start state's condition against an empty pending
        (_virtual_env :1533): the own slot's copy 0 (and last) is the
        event, everything else null."""
        def load(key):
            _kind, j, a, ck = key
            if j == st.slot and ck == 0:
                return ev_cols[a], ev_nulls[a]
            t = self.slots[j].schema.types[a]
            return (torch.zeros((), dtype=torch_dtype(t),
                                device=ev_cols[a].device),
                    torch.ones((), dtype=torch.bool,
                               device=ev_cols[a].device))
        return load

    def _cond(self, st, load, shape, dev):
        """The state's condition (True where it holds)."""
        span = self.cond_span.get(st.idx)
        if span is None:
            return torch.ones(shape, dtype=torch.bool, device=dev)
        keep, _ = run_program(self.program, load, shape, dev,
                              self.program.spans[span])
        return keep

    def _scope_arm_tables(self):
        """Per-state [len+1] tables: the enclosing every scope's re-arm
        entry and clear-from slot (the reference wires
        withinEveryPreStateProcessor into EVERY state of the scope, so a
        within-expiry ANYWHERE in the scope re-arms its start)."""
        n = len(self.states)
        arm_of = [-1] * (n + 1)
        clear_of = [0] * (n + 1)
        for x in self.states:
            if x.every_arm >= 0:
                for s in self.states:
                    if x.every_arm <= s.idx <= x.idx:
                        arm_of[s.idx] = x.every_arm
                        clear_of[s.idx] = x.clear_from
        return arm_of, clear_of

    def _lookup(self, values, state, dtype=torch.int32):
        """values[clip(state, 0, len(states))] for a per-state table."""
        idx = torch.clamp(state, 0, len(self.states)).long()
        return torch.tensor(values, dtype=dtype, device=state.device)[idx]

    def _event_body(self, plan, table, out, ev):
        """One event of the scan (event_body :654)."""
        consuming, arm_starts, persona_sources, rearm_starts = plan
        ev_ts, ev_kind, ev_valid, ev_cols, ev_nulls = ev
        M = self.M
        dev = ev_ts.device
        seq = self.state_type == "sequence"
        false = torch.zeros((M,), dtype=torch.bool, device=dev)

        # absent deadlines that passed strictly before this event
        # complete their states first (the reference's scheduler fires
        # between events; AbsentStreamPreStateProcessor.java:35)
        table, out = self._advance_time(table, out, ev_ts, ev_valid,
                                        strict=True)

        counter = table["counter"]
        live = table["valid"]

        if seq:
            # sequence stabilize (SequenceMultiProcessStreamReceiver
            # .stabilizeStates -> resetState): kill rows that survived one
            # full promoted round, except half-filled logical AND groups,
            # satisfied absent lanes, counting states and every-start
            # groups
            stale = live & (table["born"] <= counter - 2) & ev_valid
            exempt = false
            for st in self.states:
                if st.partner >= 0 and st.anchor == st.idx and \
                        st.logical_op == "and":
                    p = self.states[st.partner]
                    nl = table["slots"][st.slot]["n"] > 0
                    nr = table["slots"][p.slot]["n"] > 0
                    exempt = exempt | (
                        (table["state"] == st.anchor) & (nl ^ nr))
                    if st.is_absent or p.is_absent:
                        lane = table["deadline2"] if (
                            st.dl_field or (p.is_absent and p.dl_field)) \
                            else table["deadline"]
                        exempt = exempt | (
                            (table["state"] == st.anchor) & (lane == -1))
                if st.is_counting:
                    exempt = exempt | (table["state"] == st.idx)
                if st.rearm_each_round:
                    exempt = exempt | (table["state"] == st.anchor)
            live = live & ~(stale & ~exempt)
            table = {**table, "valid": live}
            # every-scoped sequence starts re-initialize an empty pending
            # at each round (resetState -> init())
            for st in rearm_starts:
                table = self._spawn_empty(table, st.anchor, counter,
                                          ev_valid)
            live = table["valid"]

        mature = live & (table["born"] < counter)

        # within expiry; rows expiring inside an `every` scope re-arm it
        # BEFORE the event is processed (expireEvents runs in
        # stabilizeStates), unless the row's own state is the target
        if self.within_ms is not None:
            expired = (mature & table["has_ts0"] &
                       ((ev_ts - table["ts0"]).abs() > self.within_ms)
                       & ev_valid)
            live = live & ~expired
            mature = mature & live
            if any(st.every_arm >= 0 for st in self.states):
                arm_of, clear_of = self._scope_arm_tables()
                r_arm = self._lookup(arm_of, table["state"])
                within_rearm = expired & (r_arm >= 0) & \
                    (r_arm != table["state"])
                table = {**table, "valid": live}
                table = self._append_rows(
                    table,
                    [("wrearm", within_rearm, r_arm,
                      self._lookup(clear_of, table["state"]))],
                    counter - 1)
                live = table["valid"]
                mature = live & (table["born"] < counter)

        is_current = ev_valid & (ev_kind == CURRENT)

        matched_any = false
        # a row completed through one OR side is consumed: the partner
        # side must not also fill it on the SAME event
        or_taken = false
        rearm_target = torch.full((M,), -1, dtype=torch.int32, device=dev)
        rearm_clear = torch.zeros((M,), dtype=torch.int32, device=dev)
        out_rows = false
        new_state = table["state"]
        new_valid = live
        new_min_at = table["min_at"]
        slots_upd = table["slots"]
        seq_kill = false
        dl1 = table["deadline"]
        dl2 = table["deadline2"]
        DEAD = -2  # or-side killed by an arrival

        pre_state = table["state"]  # all personas test pre-event state

        for st in consuming:
            own = st.slot
            # rows of a logical group wait at the group ANCHOR
            normal = mature & (pre_state == st.anchor)
            persona = false
            for cs in persona_sources[st.idx]:
                pn = table["slots"][cs.slot]["n"]
                persona = persona | (
                    mature & (pre_state == cs.idx) &
                    (pn >= cs.min_count) & (table["min_at"] < counter))
            at_state = (normal | persona) & is_current
            if not bool(at_state.any()):
                # no row tests this state: every branch below is a no-op
                continue
            cond_ok = self._cond(
                st, self._slot_env(table, ev_cols, ev_nulls, own), (M,),
                dev)
            hit = at_state & cond_ok
            if st.logical_op == "or":
                hit = hit & ~or_taken

            if st.is_absent:
                # a matching event violates the absence: it kills the row
                # ('and' groups, standalone absents), only this side
                # ('or' groups), latches the lane DEAD, or pushes the
                # deadline (viol_push)
                my_dl = dl2 if st.dl_field else dl1
                if st.waiting_ms > 0:
                    # only ARMED lanes are violable
                    viol = hit & (my_dl >= 0)
                else:
                    viol = hit
                if st.viol_latch:
                    if st.dl_field:
                        dl2 = _where(viol, DEAD, dl2)
                    else:
                        dl1 = _where(viol, DEAD, dl1)
                    continue
                if st.viol_push and st.waiting_ms > 0:
                    kill = false
                    pushed = ev_ts + st.waiting_ms
                    if st.dl_field:
                        dl2 = torch.where(viol, pushed, dl2)
                    else:
                        dl1 = torch.where(viol, pushed, dl1)
                else:
                    kill = viol
                grp_final = self.states[st.anchor].next_idx == -1
                if st.logical_op == "or" and not (seq and grp_final):
                    p = self.states[st.partner]
                    if st.dl_field:
                        dl2 = _where(kill, DEAD, dl2)
                    else:
                        dl1 = _where(kill, DEAD, dl1)
                    if p.is_absent:
                        other = dl1 if st.dl_field else dl2
                        both_dead = kill & (other == DEAD)
                        new_valid = new_valid & ~both_dead
                else:
                    # final-position sequence groups: the whole group dies
                    new_valid = new_valid & ~kill
                if seq and st.partner >= 0:
                    # any same-stream event that does NOT violate still
                    # consumes the pending (SEQUENCE branch)
                    seq_kill = seq_kill | (normal & is_current & ~cond_ok)
                continue

            # fill own slot at position n (persona rows have n=0 there)
            buf = slots_upd[own]
            cap = self.slots[own].cap
            n = buf["n"]
            if st.is_counting:
                can_fill = hit & (n < cap)
                if st.max_count != -1:
                    can_fill = can_fill & (n < st.max_count)
            else:
                can_fill = hit
                n = torch.zeros_like(n)  # plain slots always write pos 0
            pos = torch.clamp(n, 0, cap - 1)
            onehot = (torch.arange(cap, device=dev)[None, :] ==
                      pos[:, None]) & can_fill[:, None]
            new_cols = tuple(torch.where(onehot, ev_cols[a], col)
                             for a, col in enumerate(buf["cols"]))
            new_nulls = tuple(torch.where(onehot, ev_nulls[a], nl)
                              for a, nl in enumerate(buf["nulls"]))
            new_ts = torch.where(onehot, ev_ts, buf["ts"])
            filled_n = (buf["n"] + 1 if st.is_counting
                        else torch.ones_like(buf["n"]))
            new_n = torch.where(can_fill, filled_n, buf["n"])
            slots_upd = tuple(
                {"cols": new_cols, "nulls": new_nulls,
                 "ts": new_ts, "n": new_n} if j == own else b
                for j, b in enumerate(slots_upd))
            matched_any = matched_any | can_fill

            if st.is_counting:
                nn = new_n
                just_min = can_fill & (nn == st.min_count)
                maxed = can_fill & (nn == st.max_count) \
                    if st.max_count != -1 else false
                # persona rows moving INTO this counting state
                new_state = _where(can_fill, st.idx, new_state)
                new_min_at = torch.where(just_min, counter, new_min_at)
                if 0 <= st.next_idx < len(self.states):
                    nxt = self.states[self.states[st.next_idx].anchor]
                    if nxt.is_absent and nxt.waiting_ms > 0:
                        # each absorb at/after min re-forwards: the wait
                        # clock restarts at the latest absorb
                        arm_abs = can_fill & (nn >= st.min_count)
                        pushed = ev_ts + nxt.waiting_ms
                        if nxt.dl_field:
                            dl2 = torch.where(arm_abs, pushed, dl2)
                        else:
                            dl1 = torch.where(arm_abs, pushed, dl1)
                if st.next_idx == -1:
                    out_rows = out_rows | just_min
                    new_valid = new_valid & ~maxed
                else:
                    new_state = _where(maxed, st.next_idx, new_state)
                fwd = just_min
            else:
                anchor = self.states[st.anchor]
                if st.partner >= 0:
                    p = self.states[st.partner]
                    if st.logical_op == "or":
                        complete = hit  # either side completes an OR
                        or_taken = or_taken | complete
                    elif p.is_absent and p.waiting_ms > 0:
                        # 'X and not Y for t': completes only once the
                        # deadline passed
                        pdl = dl2 if p.dl_field else dl1
                        complete = hit & (pdl < ev_ts)
                    elif p.is_absent:
                        # 'X and not Y': latched lanes (DEAD) fail the
                        # fill and re-initialize a fresh group
                        pdl = dl2 if p.dl_field else dl1
                        if p.viol_latch:
                            blocked_latch = hit & (pdl == DEAD)
                            complete = hit & (pdl != DEAD)
                            new_valid = new_valid & ~blocked_latch
                            arm0 = st.every_arm if st.every_arm >= 0 \
                                else self.states[st.anchor].every_arm
                            if arm0 >= 0:
                                cl0 = st.clear_from \
                                    if st.every_arm >= 0 \
                                    else self.states[st.anchor].clear_from
                                rearm_target = _where(
                                    blocked_latch, arm0, rearm_target)
                                rearm_clear = _where(
                                    blocked_latch, cl0, rearm_clear)
                        else:
                            complete = hit
                    else:  # and, both present: partner slot filled?
                        pf = slots_upd[p.slot]["n"] > 0
                        complete = hit & pf
                else:
                    complete = hit
                if anchor.next_idx == -1:
                    out_rows = out_rows | complete
                    new_valid = new_valid & ~complete
                else:
                    new_state = _where(complete, anchor.next_idx, new_state)
                # completing rows leave the group: any armed absent lane
                # deadline dies with the wait
                dl1 = _where(complete, int(POS_INF), dl1)
                dl2 = _where(complete, int(POS_INF), dl2)
                fwd = complete
            arm = st.every_arm if st.every_arm >= 0 \
                else self.states[st.anchor].every_arm
            if arm >= 0:
                clear = st.clear_from if st.every_arm >= 0 \
                    else self.states[st.anchor].clear_from
                rearm_target = _where(fwd, arm, rearm_target)
                rearm_clear = _where(fwd, clear, rearm_clear)
            if seq and not st.is_counting:
                k = normal & is_current & ~cond_ok
                if st.partner >= 0:
                    # a filled logical side no longer holds the pending
                    k = k & (table["slots"][st.slot]["n"] == 0)
                seq_kill = seq_kill | k

        # ts0 bookkeeping (first captured event)
        got_first = matched_any & ~table["has_ts0"]
        ts0 = torch.where(got_first, ev_ts, table["ts0"])
        has_ts0 = table["has_ts0"] | got_first

        new_valid = new_valid & ~seq_kill

        born = table["born"]
        if seq:
            # any fill re-forwards the pending: promoted fresh next round
            born = torch.where(matched_any & is_current, counter, born)

        table2 = {**table, "state": new_state, "valid": new_valid,
                  "ts0": ts0, "has_ts0": has_ts0, "slots": slots_upd,
                  "min_at": new_min_at, "deadline": dl1,
                  "deadline2": dl2, "born": born}

        # every re-arms (cleared clones, born=now)
        do_rearm = (rearm_target >= 0) & is_current
        table2 = self._append_rows(
            table2, [("rearm", do_rearm, rearm_target, rearm_clear)],
            counter)

        # completed matches -> output buffer (seq order within event)
        out = self._emit(out, slots_upd, out_rows, ev_ts.expand(M),
                         table["seq"])

        # implicit always-armed start states (virtual empty pending)
        table2, out = self._virtual_start(table2, out, ev_ts, ev_kind,
                                          ev_valid, ev_cols, ev_nulls,
                                          counter, arm_starts)

        if self.has_absent:
            # rows newly waiting at an absent anchor start their clock at
            # this event's time
            w = self._lookup(self._wait_of, table2["state"], torch.int64)
            needs = table2["valid"] & (w > 0) & ev_valid & \
                (table2["deadline"] >= POS_INF)
            table2 = {**table2, "deadline": torch.where(
                needs, ev_ts + w, table2["deadline"])}
            if self._has_dl2:
                w2 = self._lookup(self._wait2_of, table2["state"], torch.int64)
                needs2 = table2["valid"] & (w2 > 0) & ev_valid & \
                    (table2["deadline2"] >= POS_INF)
                table2 = {**table2, "deadline2": torch.where(
                    needs2, ev_ts + w2, table2["deadline2"])}

        # event rounds advance only on real events
        table2 = {**table2,
                  "counter": counter + ev_valid.to(torch.int64)}
        return table2, out

    def stream_step_ref(self, stream_id: str, table: dict,
                        batch: EventBatch):
        """Plain PyTorch version of kernel K4's stream step (step :1061):
        the batch's events in order, each through _event_body. Padding
        rows are skipped: every part of the body is masked by the
        event's valid bit (and the round counter moves by it), so the
        reference's scan leaves the table as it is for them. ->
        (table', match batch); ``table`` is not changed."""
        plan = self.scan_states(stream_id)
        dev = batch.ts.device
        out = new_out(self, dev)
        valid = batch.valid.tolist()
        for i in range(batch.capacity):
            if not valid[i]:
                continue
            ev = (batch.ts[i], batch.kind[i], batch.valid[i],
                  tuple(c[i] for c in batch.cols),
                  tuple(nl[i] for nl in batch.nulls))
            table, out = self._event_body(plan, table, out, ev)
        table = {**table, "overflow": table["overflow"] + out["lost"]}
        return table, match_batch(self, out)

    def timer_step_ref(self, table: dict, now):
        """Plain PyTorch version of kernel K4's timer step (make_timer_step
        :1319): the non-strict deadline advance at ``now``."""
        dev = table["state"].device
        out = new_out(self, dev)
        now = torch.as_tensor(now, dtype=torch.int64).to(dev)
        table, out = self._advance_time(
            table, out, now, torch.ones((), dtype=torch.bool, device=dev),
            strict=False)
        table = {**table, "overflow": table["overflow"] + out["lost"]}
        return table, match_batch(self, out)

    # -- absent machinery ------------------------------------------------
    def _advance_time(self, table, out, now_ts, active, strict: bool):
        """Complete absent states whose deadline has passed (_advance_time
        :1087). Emission (and capture) timestamps are the deadlines
        themselves, matching the reference's scheduler-fired output
        times."""
        if not self.has_absent:
            return table, out
        M = self.M
        dev = now_ts.device
        seq = self.state_type == "sequence"
        false = torch.zeros((M,), dtype=torch.bool, device=dev)
        live = table["valid"]
        new_state = table["state"]
        new_valid = table["valid"]
        deadline = table["deadline"]
        deadline2 = table["deadline2"]
        out_rows = false
        adv_rows = false
        rearm_target = torch.full((M,), -1, dtype=torch.int32, device=dev)
        rearm_clear = torch.zeros((M,), dtype=torch.int32, device=dev)
        rearm_dl = torch.full((M,), int(POS_INF), dtype=torch.int64,
                              device=dev)
        rearm_dl2 = rearm_dl
        orfwd = false
        orfwd_target = rearm_target

        if self.within_ms is not None:
            # scheduler fires prune within-expired pendings BEFORE
            # collecting; re-arm the enclosing every scope unless the
            # row's own state is the re-arm target
            wexp = live & active & table["has_ts0"] & \
                ((now_ts - table["ts0"]).abs() > self.within_ms)
            live = live & ~wexp
            new_valid = new_valid & ~wexp
            if any(st.every_arm >= 0 for st in self.states):
                arm_of, clear_of = self._scope_arm_tables()
                r_arm = self._lookup(arm_of, table["state"])
                rearmw = wexp & (r_arm >= 0) & (r_arm != table["state"])
                rearm_target = torch.where(rearmw, r_arm, rearm_target)
                rearm_clear = torch.where(
                    rearmw, self._lookup(clear_of, table["state"]),
                    rearm_clear)

        def lane_passed(dl):
            armed = dl >= 0   # -1 satisfied / -2 or-side dead never fire
            p = (dl < now_ts) if strict else (dl <= now_ts)
            return armed & p

        # the plain version's shortcut: with no lane passed (and no lane
        # pair both satisfied) and nothing expired, no branch below fires
        moving = live & active & (lane_passed(deadline) |
                                  lane_passed(deadline2) |
                                  ((deadline == -1) & (deadline2 == -1)))
        if not bool(moving.any()) and \
                not bool((new_valid != table["valid"]).any()):
            return table, out

        for st in self.states:
            if not (st.is_absent and st.waiting_ms > 0):
                continue
            anchor = self.states[st.anchor]
            my_dl = deadline2 if st.dl_field else deadline
            at_anchor = table["state"] == st.anchor
            for cs in self.states:
                # counting rows whose forwarded persona waits at this
                # absent anchor fire with their captured count slots
                if cs.is_counting and 0 <= cs.next_idx < len(self.states) \
                        and self.states[cs.next_idx].anchor == st.anchor:
                    at_anchor = at_anchor | (
                        (table["state"] == cs.idx) &
                        (table["slots"][cs.slot]["n"] >= cs.min_count))
            rows = live & active & lane_passed(my_dl) & at_anchor
            if st.partner >= 0:
                p_state = self.states[st.partner]
                if p_state.is_absent and st.logical_op == "and":
                    # 'not A for t1 AND not B for t2': the group fires
                    # when BOTH lanes are done; a lane that passes first
                    # becomes satisfied (-1). Lane 0 owns the group.
                    if st.dl_field == 1:
                        continue
                    base = live & active & (table["state"] == st.anchor)
                    ok1 = lane_passed(deadline) | (deadline == -1)
                    ok2 = lane_passed(deadline2) | (deadline2 == -1)
                    rows = base & ok1 & ok2
                    deadline = _where(base & lane_passed(deadline) & ~ok2,
                                      -1, deadline)
                    deadline2 = _where(
                        base & lane_passed(deadline2) & ~ok1, -1,
                        deadline2)
                elif p_state.is_absent and st.logical_op == "or":
                    # 'not A for t OR not B for t': each lane's deadline
                    # completes the group on its own; the row survives
                    # until both lanes fired, and re-arms at the second
                    fire = rows
                    if seq:
                        # sequence addState dedup: the second lane's fire
                        # is consumed when the first already forwarded
                        fire = fire & ~orfwd & ~out_rows
                    other_dl = deadline if st.dl_field else deadline2
                    if anchor.next_idx == -1:
                        out_rows = out_rows | fire
                    else:
                        orfwd = orfwd | fire
                        orfwd_target = _where(fire, anchor.next_idx,
                                              orfwd_target)
                    # ALL passing rows mark the lane satisfied
                    if st.dl_field:
                        deadline2 = _where(rows, -1, deadline2)
                    else:
                        deadline = _where(rows, -1, deadline)
                    both_done = rows & (other_dl < 0)
                    new_valid = new_valid & ~both_done
                    arm = st.every_arm if st.every_arm >= 0 \
                        else anchor.every_arm
                    if arm >= 0:
                        clear = st.clear_from if st.every_arm >= 0 \
                            else anchor.clear_from
                        rearm_target = _where(both_done, arm, rearm_target)
                        rearm_clear = _where(both_done, clear, rearm_clear)
                        w_next = self._wait_of[arm]
                        if w_next > 0:
                            rearm_dl = torch.where(
                                both_done, my_dl + w_next, rearm_dl)
                    continue
                elif st.logical_op == "or":
                    # 'A or not B for t': the deadline side completes the
                    # group on its own (partner slot left null)
                    pass
                else:
                    # 'A and not B for t': the present partner must have
                    # filled; otherwise the absence is SATISFIED (-1) and
                    # the row only waits for the partner event
                    pn = table["slots"][p_state.slot]["n"]
                    blocked = rows & (pn == 0)
                    rows = rows & (pn > 0)
                    deadline = _where(blocked, -1, deadline)
            if anchor.next_idx == -1:
                out_rows = out_rows | rows
                new_valid = new_valid & ~rows
            else:
                if seq:
                    # sequence addState adds only when the next state's
                    # new list is empty (first wins)
                    nxt_a = self.states[anchor.next_idx].anchor
                    occupied = torch.any(
                        new_valid & (new_state == nxt_a) &
                        (table["born"] == table["counter"] - 1))
                    blocked = rows & occupied
                    new_valid = new_valid & ~blocked
                    rows = rows & ~blocked
                new_state = _where(rows, anchor.next_idx, new_state)
                adv_rows = adv_rows | rows
            deadline = _where(rows, int(POS_INF), deadline)
            deadline2 = _where(rows, int(POS_INF), deadline2)
            # `every`-scoped absents re-arm on the deadline fire; the next
            # wait rides the OLD deadline (fixed cadence D, D+w, ...)
            arm = st.every_arm if st.every_arm >= 0 else anchor.every_arm
            if arm >= 0:
                clear = st.clear_from if st.every_arm >= 0 \
                    else anchor.clear_from
                rearm_target = _where(rows, arm, rearm_target)
                rearm_clear = _where(rows, clear, rearm_clear)
                w_next = self._wait_of[arm]
                if w_next > 0:
                    base1 = torch.where(table["deadline"] >= 0,
                                        table["deadline"], now_ts)
                    rearm_dl = torch.where(rows, base1 + w_next, rearm_dl)
                w2_next = self._wait2_of[arm]
                if w2_next > 0:
                    # double-absent groups re-arm BOTH lanes
                    base2 = torch.where(table["deadline2"] >= 0,
                                        table["deadline2"], now_ts)
                    rearm_dl2 = torch.where(rows, base2 + w2_next,
                                            rearm_dl2)
        # emission timestamp = the lane that fired (min armed deadline)
        inf = torch.tensor(int(POS_INF), dtype=torch.int64, device=dev)
        d1 = torch.where(table["deadline"] >= 0, table["deadline"], inf)
        d2 = torch.where(table["deadline2"] >= 0, table["deadline2"], inf)
        out = self._emit(out, table["slots"], out_rows,
                         torch.minimum(d1, d2), table["seq"])
        born = table["born"]
        if seq:
            # a deadline fire forwards the pending: it must survive
            # exactly the next event round
            born = torch.where(adv_rows, table["counter"] - 1, born)
        table = {**table, "state": new_state, "valid": new_valid,
                 "deadline": deadline, "deadline2": deadline2,
                 "born": born}
        if self._absent_rearms or (
                self.within_ms is not None
                and any(st.every_arm >= 0 for st in self.states)):
            # born = counter-1: the deadline fired BETWEEN events, so the
            # re-armed clone is visible to the very next event
            table = self._append_rows(
                table, [("rearm", rearm_target >= 0, rearm_target,
                         rearm_clear)],
                table["counter"] - 1, deadline_src=rearm_dl,
                deadline2_src=rearm_dl2)
        if self._or_double_absent:
            # or-double-absent lane fires forward CLONES (slots kept, no
            # absent deadline); the original row waits for its other lane
            keep_all = torch.full((M,), len(self.slots), dtype=torch.int32,
                                  device=dev)
            table = self._append_rows(
                table, [("orfwd", orfwd, orfwd_target, keep_all)],
                table["counter"] - 1)
        return table, out

    @property
    def _or_double_absent(self) -> bool:
        return any(st.is_absent and st.logical_op == "or" and
                   st.partner >= 0 and self.states[st.partner].is_absent
                   for st in self.states)

    def next_due(self, table):
        """Earliest live absent deadline across both lanes (POS_INF when
        none; satisfied/dead markers < 0 never re-arm the scheduler)."""
        inf = torch.tensor(int(POS_INF), dtype=torch.int64,
                           device=table["deadline"].device)
        d1 = torch.where(table["valid"] & (table["deadline"] >= 0),
                         table["deadline"], inf).amin(-1)
        d2 = torch.where(table["valid"] & (table["deadline2"] >= 0),
                         table["deadline2"], inf).amin(-1)
        return torch.minimum(d1, d2)   # [K] dues inside a partition block

    def arm_start(self, table, now):
        """Arm start-state absent deadlines at app-start time (the
        reference schedules them in partitionCreated with the startup
        clock, NOT the first event's timestamp). The same few tensor
        operations on every device."""
        if not self.has_absent:
            return table
        now = int(now)
        w = self._lookup(self._wait_of, table["state"], torch.int64)
        needs = table["valid"] & (w > 0) & (table["deadline"] >= POS_INF)
        table = {**table, "deadline": torch.where(
            needs, now + w, table["deadline"])}
        if self._has_dl2:
            w2 = self._lookup(self._wait2_of, table["state"], torch.int64)
            needs2 = table["valid"] & (w2 > 0) & \
                (table["deadline2"] >= POS_INF)
            table = {**table, "deadline2": torch.where(
                needs2, now + w2, table["deadline2"])}
        return table

    @property
    def needs_start_arm(self) -> bool:
        """True when an armed-once start row waits on an absent deadline
        that must be based at app-start time."""
        return self.has_absent and any(
            st.armed_once and (
                (st.is_absent and st.waiting_ms > 0) or
                (st.partner >= 0 and
                 self.states[st.partner].is_absent and
                 self.states[st.partner].waiting_ms > 0))
            for st in self.states)

    # -- helpers ---------------------------------------------------------
    def _append_rows(self, table, appends, counter, deadline_src=None,
                     deadline2_src=None):
        """Place append-candidate rows into free table slots, free rows
        in ascending order (_append_rows :1372)."""
        M = self.M
        free = ~table["valid"]
        # free positions first, each group in row order (stable)
        free_pos = torch.argsort((~free).to(torch.uint8), stable=True)
        n_free = free.sum()
        total_lost = torch.zeros((), dtype=torch.int64,
                                 device=free.device)
        k = torch.zeros((), dtype=torch.int64, device=free.device)
        out_table = table
        for _name, mask, target_state, clear_from in appends:
            if not bool(mask.any()):
                continue   # nothing to place (the plain version's shortcut)
            cnt = torch.cumsum(mask.to(torch.int64), 0) - 1
            dest_rank = k + cnt
            ok = mask & (dest_rank < n_free)
            total_lost = total_lost + (mask & ~ok).sum()
            dest = free_pos[torch.clamp(dest_rank, 0, M - 1)]
            out_table = self._scatter_append(
                out_table, table, dest, ok, target_state, clear_from,
                counter, deadline_src=deadline_src,
                deadline2_src=deadline2_src)
            k = k + mask.sum()
        return {**out_table,
                "overflow": out_table["overflow"] + total_lost}

    def _scatter_append(self, table, src_table, dest, ok, target_state,
                        clear_from, counter, deadline_src=None,
                        deadline2_src=None):
        """Copy source rows (with slots >= clear_from cleared) into dest
        positions as fresh pendings (_scatter_append :1402)."""
        dev = ok.device
        inf = torch.tensor(int(POS_INF), dtype=torch.int64, device=dev)
        d = dest
        upd = {
            "state": _set_rows(table["state"], d, ok, target_state),
            "valid": _set_rows(table["valid"], d, ok,
                               torch.ones((), dtype=torch.bool,
                                          device=dev)),
            "born": _set_rows(table["born"], d, ok, counter),
            "min_at": _set_rows(table["min_at"], d, ok,
                                torch.tensor(-1, dtype=torch.int64,
                                             device=dev)),
            "deadline": _set_rows(
                table["deadline"], d, ok,
                inf if deadline_src is None else deadline_src),
            "deadline2": _set_rows(
                table["deadline2"], d, ok,
                inf if deadline2_src is None else deadline2_src),
            "seq": _set_rows(
                table["seq"], d, ok,
                table["next_seq"] + torch.cumsum(ok.to(torch.int64), 0)
                - 1),
            "next_seq": table["next_seq"] + ok.sum(),
        }
        new_slots = []
        any_kept_slot = torch.zeros_like(ok)
        for j, _spec in enumerate(self.slots):
            sbuf = src_table["slots"][j]
            tbuf = table["slots"][j]
            keep = ~(j >= clear_from)  # [M] bool (keep this slot?)
            k2 = keep[:, None]
            new_slots.append({
                "cols": tuple(
                    _set_rows(tc, d, ok, torch.where(
                        k2, sc, torch.zeros_like(sc)))
                    for tc, sc in zip(tbuf["cols"], sbuf["cols"])),
                "nulls": tuple(
                    _set_rows(tn, d, ok, torch.where(
                        k2, sn, torch.ones_like(sn)))
                    for tn, sn in zip(tbuf["nulls"], sbuf["nulls"])),
                "ts": _set_rows(tbuf["ts"], d, ok, torch.where(
                    k2, sbuf["ts"], torch.zeros_like(sbuf["ts"]))),
                "n": _set_rows(tbuf["n"], d, ok, torch.where(
                    keep, sbuf["n"], torch.zeros_like(sbuf["n"]))),
            })
            any_kept_slot = any_kept_slot | (keep & (sbuf["n"] > 0))
        # ts0 of the appended row: kept slots' first ts if any, else unset
        upd["ts0"] = _set_rows(table["ts0"], d, ok, torch.where(
            any_kept_slot, src_table["ts0"],
            torch.zeros_like(src_table["ts0"])))
        upd["has_ts0"] = _set_rows(table["has_ts0"], d, ok, any_kept_slot)
        return {**table, **upd, "slots": tuple(new_slots)}

    def _emit(self, out, slots_upd, out_rows, ts_vec, seq):
        """Scatter completed matches into the output buffer in seq order
        (_emit :1459). ts_vec: per-row emission timestamps [M]."""
        if not bool(out_rows.any()):
            return out
        M, OUT = self.M, self.OUT
        dev = out_rows.device
        inf = torch.tensor(int(POS_INF), dtype=torch.int64, device=dev)
        take = torch.argsort(torch.where(out_rows, seq, inf), stable=True)
        n_emit = out_rows.sum()
        dest = out["n"] + torch.arange(M, dtype=torch.int64, device=dev)
        ok = (torch.arange(M, device=dev) < n_emit) & (dest < OUT)
        lost = torch.clamp(n_emit - ok.sum(), min=0)
        cols = list(out["cols"])
        nulls = list(out["nulls"])
        for j, spec in enumerate(self.slots):
            buf = slots_upd[j]
            for a in range(len(spec.schema.types)):
                for c in range(spec.cap):
                    ci = self.col_index[(j, a, c)]
                    cols[ci] = _set_rows(cols[ci], dest, ok,
                                         buf["cols"][a][take, c])
                    nulls[ci] = _set_rows(nulls[ci], dest, ok,
                                          buf["nulls"][a][take, c])
        return {"cols": tuple(cols), "nulls": tuple(nulls),
                "ts": _set_rows(out["ts"], dest, ok, ts_vec[take]),
                "n": out["n"] + torch.minimum(n_emit, OUT - out["n"]),
                "lost": out["lost"] + lost}

    def _virtual_start(self, table, out, ev_ts, ev_kind, ev_valid, ev_cols,
                       ev_nulls, counter, starts):
        """Implicit always-armed start states (of THIS stream): test the
        event directly against an empty pending (_virtual_start :1487)."""
        for st in starts:
            ok = self._cond(st, self._virtual_env(st, ev_cols, ev_nulls),
                            (), ev_ts.device)
            hit = ok & ev_valid & (ev_kind == CURRENT)
            if st.suppress_when_next_busy and st.next_idx >= 0:
                # sequence start before an absent wait: no new attempt
                # while the wait is pending
                nxt_anchor = self.states[st.next_idx].anchor
                busy = torch.any(table["valid"] &
                                 (table["state"] == nxt_anchor))
                hit = hit & ~busy
            if st.is_counting:
                reached_min = st.min_count <= 1
                if st.next_idx == -1 and reached_min:
                    out = self._emit_virtual(out, st, ev_cols, ev_nulls,
                                             ev_ts, hit)
                # one absorbing row (its next-state persona activates via
                # min_at once min is reached)
                table = self._spawn_virtual(
                    table, st, ev_cols, ev_nulls, ev_ts, hit, counter,
                    as_state=st.idx, n0=1, min_reached=reached_min)
            elif st.next_idx == -1:
                out = self._emit_virtual(out, st, ev_cols, ev_nulls, ev_ts,
                                         hit)
            else:
                table = self._spawn_virtual(
                    table, st, ev_cols, ev_nulls, ev_ts, hit, counter,
                    as_state=st.next_idx, n0=1, min_reached=False)
        return table, out

    def _spawn_virtual(self, table, st, ev_cols, ev_nulls, ev_ts, hit,
                       counter, as_state: int, n0: int,
                       min_reached: bool = False):
        """Append one row capturing the event at st.slot
        (_spawn_virtual :1556)."""
        if not bool(hit):
            return table
        dev = ev_ts.device
        free = ~table["valid"]
        d = torch.argmax(free.to(torch.uint8))
        ok = hit & free.any()
        one = torch.ones((), dtype=torch.bool, device=dev)

        def i64(v):
            return torch.tensor(v, dtype=torch.int64, device=dev)
        slots = []
        for j, spec in enumerate(self.slots):
            buf = table["slots"][j]
            row = _set_row(torch.zeros(buf["ts"].shape, dtype=torch.bool,
                                       device=dev), d, ok, one)
            if j == st.slot:
                at0 = row & (torch.arange(spec.cap, device=dev) == 0)
                rest = row & (torch.arange(spec.cap, device=dev) >= n0)
                cols = tuple(torch.where(rest, torch.zeros_like(col),
                                         torch.where(at0, ev_cols[a], col))
                             for a, col in enumerate(buf["cols"]))
                nulls = tuple(torch.where(rest, one,
                                          torch.where(at0, ev_nulls[a], nl))
                              for a, nl in enumerate(buf["nulls"]))
                ts = torch.where(at0, ev_ts, buf["ts"])
                n = _set_row(buf["n"], d, ok,
                             torch.tensor(n0, dtype=torch.int32,
                                          device=dev))
            else:
                # cleared slot
                cols = tuple(torch.where(row, torch.zeros_like(c), c)
                             for c in buf["cols"])
                nulls = tuple(torch.where(row, one, nl)
                              for nl in buf["nulls"])
                ts = torch.where(row, torch.zeros_like(buf["ts"]),
                                 buf["ts"])
                n = _set_row(buf["n"], d, ok,
                             torch.tensor(0, dtype=torch.int32, device=dev))
            slots.append({"cols": cols, "nulls": nulls, "ts": ts, "n": n})
        return {**table,
                "state": _set_row(table["state"], d, ok,
                                  torch.tensor(as_state, dtype=torch.int32,
                                               device=dev)),
                "valid": _set_row(table["valid"], d, ok, one),
                "born": _set_row(table["born"], d, ok, counter),
                "seq": _set_row(table["seq"], d, ok, table["next_seq"]),
                "next_seq": table["next_seq"] + ok.to(torch.int64),
                "overflow": table["overflow"] + (hit & ~ok).to(torch.int64),
                "slots": tuple(slots),
                "ts0": _set_row(table["ts0"], d, ok, ev_ts),
                "has_ts0": _set_row(table["has_ts0"], d, ok, one),
                "min_at": _set_row(table["min_at"], d, ok,
                                   counter if min_reached else i64(-1)),
                "deadline": _set_row(table["deadline"], d, ok,
                                     i64(int(POS_INF)))}

    def _spawn_empty(self, table, anchor: int, counter, ev_valid):
        """Respawn an empty start pending when none is live (sequence
        every-start re-initialization: resetState -> init()). born is
        counter-1 so the spawned row is tested by THIS event
        (_spawn_empty :1614)."""
        dev = counter.device
        has = torch.any(table["valid"] & (table["state"] == anchor))
        free = ~table["valid"]
        d = torch.argmax(free.to(torch.uint8))
        ok = ev_valid & ~has & free.any()
        if not bool(ok):
            return table
        one = torch.ones((), dtype=torch.bool, device=dev)

        def i64(v):
            return torch.tensor(v, dtype=torch.int64, device=dev)
        slots = []
        for buf in table["slots"]:
            row = _set_row(torch.zeros(buf["ts"].shape, dtype=torch.bool,
                                       device=dev), d, ok, one)
            slots.append({
                "cols": tuple(torch.where(row, torch.zeros_like(c), c)
                              for c in buf["cols"]),
                "nulls": tuple(torch.where(row, one, nl)
                               for nl in buf["nulls"]),
                "ts": torch.where(row, torch.zeros_like(buf["ts"]),
                                  buf["ts"]),
                "n": _set_row(buf["n"], d, ok,
                              torch.tensor(0, dtype=torch.int32,
                                           device=dev))})
        return {**table,
                "state": _set_row(table["state"], d, ok,
                                  torch.tensor(anchor, dtype=torch.int32,
                                               device=dev)),
                "valid": _set_row(table["valid"], d, ok, one),
                "born": _set_row(table["born"], d, ok, counter - 1),
                "seq": _set_row(table["seq"], d, ok, table["next_seq"]),
                "next_seq": table["next_seq"] + ok.to(torch.int64),
                "min_at": _set_row(table["min_at"], d, ok, i64(-1)),
                "deadline": _set_row(table["deadline"], d, ok,
                                     i64(int(POS_INF))),
                "deadline2": _set_row(table["deadline2"], d, ok,
                                      i64(int(POS_INF))),
                "ts0": _set_row(table["ts0"], d, ok, i64(0)),
                "has_ts0": _set_row(table["has_ts0"], d, ok, ~one),
                "slots": tuple(slots)}

    def _emit_virtual(self, out, st, ev_cols, ev_nulls, ev_ts, hit):
        """One match straight from the event (_emit_virtual :1682)."""
        if not bool(hit):
            return out
        OUT = self.OUT
        room = hit & (out["n"] < OUT)
        cols = list(out["cols"])
        nulls = list(out["nulls"])
        spec = self.slots[st.slot]
        for a in range(len(spec.schema.types)):
            ci = self.col_index[(st.slot, a, 0)]
            cols[ci] = _set_row(cols[ci], out["n"], room, ev_cols[a])
            nulls[ci] = _set_row(nulls[ci], out["n"], room, ev_nulls[a])
        return {"cols": tuple(cols), "nulls": tuple(nulls),
                "ts": _set_row(out["ts"], out["n"], room, ev_ts),
                "n": out["n"] + room.to(torch.int64),
                "lost": out["lost"] + (hit & ~room).to(torch.int64)}


# ---------------------------------------------------------------------------
# kernel K4
# ---------------------------------------------------------------------------

_LOGICAL = {None: 0, "and": 1, "or": 2}


def check_scan_limits(eng: NfaEngine) -> None:
    """Plan-time limits of kernel K4 (csrc/siddhi_kernels.h): beyond
    them a pattern is not ported yet, on every device."""
    lim = _kernels
    states = eng.states
    slot_cols = sum(len(s.schema.types) for s in eng.slots)
    per_stream = {}
    for st in states:
        per_stream.setdefault(st.stream_id, []).append(st)
    M = eng.M
    checks = [
        ("pattern slots", len(eng.slots), lim.NFA_MAX_SLOTS),
        ("slot attributes", slot_cols, lim.NFA_MAX_SLOT_COLS),
        ("match columns", len(eng.match_schema.types),
         lim.NFA_MAX_MATCH_COLS),
        ("pattern states", len(states), lim.SCAN_MAX_STATES),
        ("absent states", sum(st.is_absent and st.waiting_ms > 0
                              for st in states), lim.SCAN_MAX_ABSENT),
        ("logical groups", len(_and_groups(eng)), lim.SCAN_MAX_GROUPS),
        ("counting states waiting at one absent state",
         max([len(_absent_personas(eng, st)) for st in states
              if st.is_absent] or [0]), lim.SCAN_MAX_PERSONAS),
        ("table rows", M, lim.SCAN_MAX_ROWS)]
    for sid, sts in per_stream.items():
        consuming, starts, personas, _r = eng.scan_states(sid)
        checks += [
            (f"states consuming '{sid}'", len(consuming),
             lim.SCAN_MAX_CONSUMING),
            (f"always-armed starts of '{sid}'", len(starts),
             lim.SCAN_MAX_STARTS),
            (f"attributes of '{sid}'", len(eng.slots[sts[0].slot].schema
                                           .types), lim.NFA_MAX_EV_COLS),
            ("counting states answering one state",
             max([len(v) for v in personas.values()] or [0]),
             lim.SCAN_MAX_PERSONAS)]
    for what, n, cap in checks:
        if n > cap:
            raise not_ported(f"a scan-engine pattern with more than {cap} "
                             f"{what} ({n})")
    if M < 32 or M & (M - 1):
        raise not_ported(f"a scan-engine table of {M} rows (a power of "
                         "two from 32 on)")


def _and_groups(eng):
    """The logical AND group anchors (the sequence stabilize exempts their
    half-filled rows)."""
    return [st for st in eng.states if st.partner >= 0 and
            st.anchor == st.idx and st.logical_op == "and"]


def _span(eng, idx: int):
    span = eng.cond_span.get(idx)
    if span is None:
        return 0, 0
    a, b = eng.program.spans[span]
    return a, b - a


def _personas(d, sources) -> None:
    d.n_personas = len(sources)
    for q, cs in enumerate(sources):
        d.persona_idx[q] = cs.idx
        d.persona_slot[q] = cs.slot
        d.persona_min[q] = cs.min_count


def _cons_desc(eng, d, st, persona_sources) -> None:
    states = eng.states
    anchor = states[st.anchor]
    d.idx, d.slot, d.anchor = st.idx, st.slot, st.anchor
    d.cap = eng.slots[st.slot].cap
    d.anchor_next, d.next_idx = anchor.next_idx, st.next_idx
    d.prog_start, d.prog_len = _span(eng, st.idx)
    d.logical = _LOGICAL[st.logical_op]
    d.has_partner = int(st.partner >= 0)
    d.grp_final = int(anchor.next_idx == -1)
    d.is_absent, d.waiting_ms = int(st.is_absent), st.waiting_ms
    d.dl_field = st.dl_field
    d.viol_latch, d.viol_push = int(st.viol_latch), int(st.viol_push)
    d.is_counting = int(st.is_counting)
    d.min_count, d.max_count = st.min_count, st.max_count
    if st.is_counting and 0 <= st.next_idx < len(states):
        nxt = states[states[st.next_idx].anchor]
        if nxt.is_absent and nxt.waiting_ms > 0:
            d.nxt_waiting_ms, d.nxt_dl_field = nxt.waiting_ms, nxt.dl_field
    if st.partner >= 0:
        p = states[st.partner]
        d.p_slot, d.p_is_absent = p.slot, int(p.is_absent)
        d.p_waits, d.p_dl_field = int(p.waiting_ms > 0), p.dl_field
        d.p_viol_latch = int(p.viol_latch)
    d.arm = st.every_arm if st.every_arm >= 0 else anchor.every_arm
    d.clear = st.clear_from if st.every_arm >= 0 else anchor.clear_from
    _personas(d, persona_sources[st.idx])


def _absent_desc(eng, d, st) -> None:
    states = eng.states
    anchor = states[st.anchor]
    d.anchor, d.anchor_next, d.dl_field = st.anchor, anchor.next_idx, \
        st.dl_field
    d.next_anchor = states[anchor.next_idx].anchor \
        if anchor.next_idx >= 0 else -1
    d.has_partner = int(st.partner >= 0)
    d.logical = _LOGICAL[st.logical_op]
    if st.partner >= 0:
        p = states[st.partner]
        d.p_is_absent, d.p_slot = int(p.is_absent), p.slot
    d.arm = st.every_arm if st.every_arm >= 0 else anchor.every_arm
    d.clear = st.clear_from if st.every_arm >= 0 else anchor.clear_from
    if d.arm >= 0:
        d.w_next, d.w2_next = eng._wait_of[d.arm], eng._wait2_of[d.arm]
    _personas(d, _absent_personas(eng, st))


def _absent_personas(eng, st) -> list:
    """Counting states whose rows wait at absent state st's anchor."""
    states = eng.states
    return [cs for cs in states
            if cs.is_counting and 0 <= cs.next_idx < len(states)
            and states[cs.next_idx].anchor == st.anchor]


def kernel_plan(eng: NfaEngine, stream_id: Optional[str]):
    """K4's static description of the engine for one stream's steps (or,
    with ``stream_id`` None, for its timer step) -> _kernels.ScanPlan."""
    states = eng.states
    P = _kernels.ScanPlan()
    P.within_ms = -1 if eng.within_ms is None else int(eng.within_ms)
    arm_of, clear_of = eng._scope_arm_tables()
    for i in range(len(states) + 1):
        P.wait_of[i], P.wait2_of[i] = eng._wait_of[i], eng._wait2_of[i]
        P.arm_of[i], P.clear_of[i] = arm_of[i], clear_of[i]
    if stream_id is not None:
        consuming, starts, persona_sources, rearm = \
            eng.scan_states(stream_id)
    else:
        consuming, starts, persona_sources, rearm = [], [], {}, []
    for d, st in zip(P.cons, consuming):
        _cons_desc(eng, d, st, persona_sources)
    absent = [st for st in states if st.is_absent and st.waiting_ms > 0]
    for d, st in zip(P.absent, absent):
        _absent_desc(eng, d, st)
    groups = _and_groups(eng)
    for g, st in zip(P.groups, groups):
        p = states[st.partner]
        g.anchor, g.slot_l, g.slot_r = st.anchor, st.slot, p.slot
        if st.is_absent or p.is_absent:
            g.lane = 2 if (st.dl_field or (p.is_absent and p.dl_field)) \
                else 1
    for d, st in zip(P.starts, starts):
        d.idx, d.slot, d.next_idx = st.idx, st.slot, st.next_idx
        d.nxt_anchor = states[st.next_idx].anchor if st.next_idx >= 0 \
            else -1
        d.prog_start, d.prog_len = _span(eng, st.idx)
        d.suppress = int(st.suppress_when_next_busy and st.next_idx >= 0)
        d.is_counting, d.min_count = int(st.is_counting), st.min_count
    for k, st in enumerate(rearm):
        P.rearm_anchor[k] = st.anchor
    x = ci = 0
    for j, spec in enumerate(eng.slots):
        P.slot_cap[j], P.slot_col0[j] = spec.cap, x
        P.slot_ncols[j], P.slot_ci0[j] = len(spec.schema.types), ci
        for t in spec.schema.types:
            P.col_type[x] = VT[t]
            x += 1
        ci += len(spec.schema.types) * spec.cap
    P.n_slots, P.n_states = len(eng.slots), len(states)
    P.n_cons, P.n_absent, P.n_groups = len(consuming), len(absent), \
        len(groups)
    P.n_starts, P.n_rearm = len(starts), len(rearm)
    P.M, P.OUT, P.n_match_cols = eng.M, eng.OUT, len(eng.match_schema.types)
    P.seqmode = int(eng.state_type == "sequence")
    P.has_absent = int(eng.has_absent)
    P.any_every = int(any(st.every_arm >= 0 for st in states))
    P.absent_rearms, P.has_dl2 = int(eng._absent_rearms), int(eng._has_dl2)
    P.or_double_absent = int(eng._or_double_absent)
    P.counting_mask = sum(1 << st.idx for st in states if st.is_counting)
    return P


def _device_plan(eng: NfaEngine, stream_id: Optional[str], dev):
    """kernel_plan's bytes in device memory, uploaded once per stream."""
    key = ("plan", stream_id, str(dev))
    t = eng._scratch.get(key)
    if t is None:
        raw = bytes(kernel_plan(eng, stream_id))
        t = torch.frombuffer(bytearray(raw), dtype=torch.uint8).to(dev)
        eng._scratch[key] = t
    return t


def _staging(eng: NfaEngine, dev, lead: tuple = ()) -> list:
    """The staging rows of K4's appends: the table's slot layout (one a
    slot inside a partition block: ``lead`` (K,))."""
    key = ("staging", str(dev), lead)
    s = eng._scratch.get(key)
    if s is None:
        M = eng.M
        s = eng._scratch[key] = [{
            "cols": tuple(torch.empty(lead + (M, sp.cap),
                                      dtype=torch_dtype(t), device=dev)
                          for t in sp.schema.types),
            "nulls": tuple(torch.empty(lead + (M, sp.cap), dtype=torch.bool,
                                       device=dev) for _ in sp.schema.types),
            "ts": torch.empty(lead + (M, sp.cap), dtype=torch.int64,
                              device=dev)}
            for sp in eng.slots]
    return s


def kernel_out(eng: NfaEngine, dev, lead: tuple = ()) -> dict:
    """The match batch's buffers for one step of kernel K3 or K4, which
    clears and closes them itself (no fill launches); ``lead`` (K,) for
    one a slot of a partition block."""
    OUT = eng.OUT

    def e(dtype):
        return torch.empty(lead + (OUT,), dtype=dtype, device=dev)
    return {"cols": tuple(e(torch_dtype(t)) for t in eng.match_schema.types),
            "nulls": tuple(e(torch.bool) for _ in eng.match_schema.types),
            "ts": e(torch.int64), "valid": e(torch.bool),
            "kind": e(torch.int32),
            "n": torch.empty(lead, dtype=torch.int64, device=dev)}


def check_table(eng: NfaEngine, table: dict, dev, what: str) -> None:
    """Kernels K3 and K4 take the table's tensors as they are: each must be
    contiguous, of its type and shape, on ``dev`` (with a leading slot
    axis inside a partition block)."""
    lead = tuple(table["state"].shape[:-1])
    M = eng.M
    want = {"state": torch.int32, "valid": torch.bool, "ts0": torch.int64,
            "has_ts0": torch.bool, "born": torch.int64,
            "min_at": torch.int64, "deadline": torch.int64,
            "deadline2": torch.int64, "seq": torch.int64}
    for k, dt in want.items():
        x = table[k]
        if x.device != dev or x.dtype != dt or x.shape != lead + (M,) or \
                not x.is_contiguous():
            raise ValueError(f"{what}: table['{k}'] must be a "
                             f"contiguous {dt}{list(lead + (M,))} on {dev}")
    for k in ("next_seq", "counter", "overflow"):
        x = table[k]
        if x.device != dev or x.dtype != torch.int64 or \
                x.shape != lead or not x.is_contiguous():
            raise ValueError(f"{what}: table['{k}'] must be an int64 "
                             f"{list(lead)} on {dev}")
    for spec, buf in zip(eng.slots, table["slots"]):
        n = buf["n"]
        if n.device != dev or n.dtype != torch.int32 or \
                n.shape != lead + (M,) or not n.is_contiguous():
            raise ValueError(f"{what}: slot fill counts must be contiguous "
                             f"int32{list(lead + (M,))} on {dev}")
        for x in list(buf["cols"]) + list(buf["nulls"]) + [buf["ts"]]:
            if x.device != dev or x.shape != lead + (M, spec.cap) or \
                    not x.is_contiguous():
                raise ValueError(f"{what}: slot columns must be contiguous "
                                 f"{list(lead + (M, spec.cap))} on {dev}")


def scan_args(eng: NfaEngine, stream_id: Optional[str], table: dict, batch,
              now: int, out: dict, due, dev):
    """K4's launch arguments: the table (updated in place), the batch (or,
    with ``batch`` None, the timer step at ``now``), the match batch's
    buffers and ``due`` (a 0-d int64 tensor, or None). Inside a partition
    block every tensor but the program carries the slot axis, ``n_part``
    is the slot count and ``moves`` the slot strides (ops/slots.py
    part_moves)."""
    lead = tuple(table["state"].shape[:-1])
    code, consts, loads = eng.device_program(dev)
    a = _kernels.ScanArgs()
    a.plan = _device_plan(eng, stream_id, dev).data_ptr()
    for k in ("state", "valid", "ts0", "has_ts0", "born", "min_at",
              "deadline", "deadline2", "seq", "next_seq", "counter",
              "overflow"):
        setattr(a, k, table[k].data_ptr())
    x = 0
    staging = _staging(eng, dev, lead)
    for j, (spec, tb, sb) in enumerate(zip(eng.slots, table["slots"],
                                           staging)):
        a.tab_ts[j], a.tab_n[j] = tb["ts"].data_ptr(), tb["n"].data_ptr()
        a.stg_ts[j] = sb["ts"].data_ptr()
        for c, nl, sc, sn in zip(tb["cols"], tb["nulls"], sb["cols"],
                                 sb["nulls"]):
            a.tab_cols[x], a.tab_nulls[x] = c.data_ptr(), nl.data_ptr()
            a.stg_cols[x], a.stg_nulls[x] = sc.data_ptr(), sn.data_ptr()
            x += 1
    if batch is not None:
        a.ev_ts, a.ev_kind, a.ev_valid = (batch.ts.data_ptr(),
                                          batch.kind.data_ptr(),
                                          batch.valid.data_ptr())
        for k, (c, nl) in enumerate(zip(batch.cols, batch.nulls)):
            a.ev_cols[k], a.ev_nulls[k] = c.data_ptr(), nl.data_ptr()
            a.ev_size[k] = c.element_size()
        a.n_ev_cols = len(batch.cols)
        a.n_events = batch.ts.shape[-1]
    a.n_part = lead[0] if lead else 1
    a.now = int(now)
    a.rows = eng.M
    for ci, (c, nl, t) in enumerate(zip(out["cols"], out["nulls"],
                                        eng.match_schema.types)):
        a.out_cols[ci], a.out_nulls[ci] = c.data_ptr(), nl.data_ptr()
        a.out_type[ci] = VT[t]
    a.out_ts, a.out_n = out["ts"].data_ptr(), out["n"].data_ptr()
    a.out_valid, a.out_kind = out["valid"].data_ptr(), out["kind"].data_ptr()
    a.due = None if due is None else due.data_ptr()
    a.code, a.consts, a.loads = (code.data_ptr(), consts.data_ptr(),
                                 loads.data_ptr())
    prog = eng.program
    a.n_code, a.n_consts, a.n_loads = (len(prog.code), len(prog.consts),
                                       len(prog.inputs))
    part_moves(a, (table, staging, batch, out, due), dev)
    return a


def _launch(eng, stream_id, table, batch, now, due, dev):
    """One launch of K4 on the current stream; the table is updated in
    place. -> the match batch."""
    check_table(eng, table, dev, "nfa_scan")
    if due is not None and (due.device != dev or due.dtype != torch.int64
                            or due.numel() != 1):
        raise ValueError(f"nfa_scan: due must be an int64 scalar on {dev}")
    lead = tuple(table["state"].shape[:-1])
    out = kernel_out(eng, dev, lead)
    args = scan_args(eng, stream_id, table, batch, now, out, due, dev)
    _kernels.load().nfa_scan(args, torch.cuda.current_stream(dev).cuda_stream)
    _kernels.count_launch("nfa_scan[K]" if lead else "nfa_scan")
    return EventBatch(ts=out["ts"], cols=out["cols"], nulls=out["nulls"],
                      kind=out["kind"], valid=out["valid"])


def scan_step(eng: NfaEngine, stream_id: str, table: dict, batch: EventBatch,
              due=None):
    """Kernel K4's stream step: the batch's events in order through the
    pending table. -> (table', match batch). A batch on the CPU takes the
    plain version (``table`` is left as it was). A CUDA batch launches the
    kernel once, with ``table`` updated in place and returned. ``due`` (a
    0-d int64 tensor, optional) receives next_due(table').

    Inside a partition block the table and the batch carry the slot axis
    (``[K, M]`` tables, ``[K, B]`` events): the plain version runs once
    per slot; the kernel runs one thread block per slot
    (``nfa_scan[K]``), and ``due`` is then a [K] tensor."""
    dev = batch.ts.device
    slotted = batch.ts.dim() == 2
    if dev.type == "cpu":
        if slotted:
            table, match = per_slot(
                lambda t, b: eng.stream_step_ref(stream_id, t, b),
                batch.ts.shape[0], table, batch)
        else:
            table, match = eng.stream_step_ref(stream_id, table, batch)
        if due is not None:
            due.copy_(eng.next_due(table))
        return table, match
    if dev.type != "cuda":
        raise ValueError(f"nfa_scan: unsupported device {dev}")
    shape = tuple(batch.ts.shape)
    for x in (batch.ts, batch.kind, batch.valid) + tuple(batch.cols) + \
            tuple(batch.nulls):
        # inside a block, each slot's rows contiguous (a shared column
        # has slot stride 0)
        if x.device != dev or tuple(x.shape) != shape or \
                not (x[0] if slotted else x).is_contiguous():
            raise ValueError("nfa_scan: every event column must be a "
                             f"{list(shape)} tensor on {dev}, contiguous "
                             "in a slot")
    return table, _launch(eng, stream_id, table, batch, 0, due, dev)


def timer_step(eng: NfaEngine, table: dict, now, due=None):
    """Kernel K4's timer step: the deadline advance at ``now`` (dl <= now),
    fired by the scheduler when no event arrives in time. -> (table',
    match batch), as scan_step."""
    dev = table["state"].device
    if dev.type == "cpu":
        if table["state"].dim() == 2:   # every slot of a partition block
            table, match = per_slot(lambda t: eng.timer_step_ref(t, now),
                                    table["state"].shape[0], table)
        else:
            table, match = eng.timer_step_ref(table, now)
        if due is not None:
            due.copy_(eng.next_due(table))
        return table, match
    if dev.type != "cuda":
        raise ValueError(f"nfa_scan: unsupported device {dev}")
    return table, _launch(eng, None, table, None, int(now), due, dev)
