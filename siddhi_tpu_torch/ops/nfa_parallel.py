"""Batch-parallel NFA engine (PyTorch port of siddhi_tpu/ops/nfa_parallel.py):
the fast path for pattern and sequence queries, kernel K3 of PERF.md.

Each pending row's trajectory through a batch is independent of every
other row's (the reference's StateEvents never interact:
StreamPreStateProcessor.java:364-403), so a sub-batch of at most PB
events is consumed by advancing every row, in parallel, through the
states that consume the stream, in chain order: at each state a row
takes the FIRST eligible event that meets the state's condition;
counting states (A<m:n>) absorb every match they have room for; the
always-armed start state spawns one candidate row per event (a second
population) that advances the same way; matches are emitted in
(event, seq) order and the surviving spawns are folded into free table
rows.

``parallel_step`` is the step. For tensors on the CPU it runs
``parallel_step_ref``, the plain PyTorch version, which follows the
reference's ``sub_step`` (:633-715) and ``step`` (:717-759) one function
at a time: a [rows, events] grid per state, an argmax for the first
match, a lexsort of the emissions and a stable argsort of the free rows.
(Each round evaluates its grid over the rows that stand at its state
only, gathered and scattered back: every round is row-local, so the
rows it skips would not change.) For CUDA tensors it launches kernel K3
(csrc/nfa_parallel.cu) once per sub-batch: no grid, no library sort,
no host sync between sub-batches, and the table is updated in place.

Supported shapes (``parallel_supported``, the reference's, copied):
linear chains of stream/count states, pattern and sequence, 'every'
only where it collapses to an always-armed start, `within`,
cross-state predicates. Everything else runs on the scan engine
(ops/nfa.py, kernel K4).
"""
from __future__ import annotations

import torch

from .. import _kernels
from ..core.event import CURRENT, EventBatch
from ..core.types import torch_dtype
from ..lang import ast as A
from .expr import VT
from .nfa import (NfaEngine, NfaStateSpec, POS_INF, SlotSpec, check_table,
                  kernel_out, match_batch, new_out, not_ported)

BIG = 2 ** 30
_NO_EMIT_KEY = 2 ** 62


def _cond_refs_own_indexed(st: NfaStateSpec, slots: list[SlotSpec]) -> bool:
    """Does the state's condition reference its OWN slot with an explicit
    event index (self-referential Kleene, e.g. A[v > e1[last].v]+)?"""
    own = slots[st.slot]
    names = {own.ref, own.stream_id} - {None}
    found = []

    def walk(e):
        if isinstance(e, A.Variable):
            if e.stream_ref in names and e.index is not None:
                found.append(e)
        for f in getattr(e, "__dataclass_fields__", {}):
            v = getattr(e, f)
            if isinstance(v, A.Expression):
                walk(v)
            elif isinstance(v, list):
                for x in v:
                    if isinstance(x, A.Expression):
                        walk(x)

    if st.cond_ast is not None:
        walk(st.cond_ast)
    return bool(found)


def parallel_supported(slots: list[SlotSpec],
                       states: list[NfaStateSpec],
                       state_type: str = "pattern") -> bool:
    """Can the batch-parallel engine run this compiled chain?"""
    # logical groups and absent states run on the scan engine
    if any(st.partner >= 0 or st.is_absent for st in states):
        return False
    # sequences with armed-once starts need the scan engine's per-round
    # pending lifecycle (one-shot starts, cross-stream staleness —
    # SequenceMultiProcessStreamReceiver.stabilizeStates); counting-start
    # sequences keep the parallel path (their absorb lifecycle is exempt)
    if state_type == "sequence" and any(
            st.armed_once or st.rearm_each_round for st in states):
        return False
    # rows-at-state reachability (which states ever hold table rows)
    reach = set()
    for st in states:
        if st.armed_once:
            reach.add(st.idx)
        if st.always_armed:
            if st.is_counting:
                reach.add(st.idx)
            elif st.next_idx >= 0:
                reach.add(st.next_idx)
    changed = True
    while changed:
        changed = False
        for st in states:
            if st.idx in reach and st.next_idx >= 0 \
                    and st.next_idx not in reach:
                reach.add(st.next_idx)
                changed = True
    for st in states:
        if st.every_arm >= 0:
            # live re-arm edge? dead iff no rows ever reach this state, or
            # it is a min==1 counting state entered only with n>=1 rows
            if st.idx in reach and not (
                    st.is_counting and st.min_count == 1
                    and not st.armed_once):
                return False
        if st.is_counting:
            if _cond_refs_own_indexed(st, slots):
                return False
            if st.next_idx >= 0 and \
                    states[st.next_idx].stream_id == st.stream_id:
                return False
    return True


class ParallelNfaEngine(NfaEngine):
    """Same table, match schema and outputs as NfaEngine; only the
    per-stream step is rebuilt round-parallel, in sub-batches of at most
    PB events. The states' conditions run from the base engine's shared
    program (NfaEngine.program), as in kernel K4."""

    PB = 4096

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        # final counting slots: copies at and past emit_n emit as null
        self.final_counting = [
            any(st.next_idx == -1 and st.slot == j and st.is_counting
                for st in self.states) for j in range(len(self.slots))]

    def _check_limits(self) -> None:
        """Plan-time limits of kernel K3."""
        lim = _kernels
        slot_cols = sum(len(s.schema.types) for s in self.slots)
        for what, n, cap in (
                ("pattern slots", len(self.slots), lim.NFA_MAX_SLOTS),
                ("slot attributes", slot_cols, lim.NFA_MAX_SLOT_COLS),
                ("match columns", len(self.match_schema.types),
                 lim.NFA_MAX_MATCH_COLS),
                ("pattern states", len(self.states), 31),
                ("table rows and events", self.M + self.PB,
                 lim.NFA_MAX_ROWS)):
            if n > cap:
                raise not_ported(f"a parallel pattern with more than {cap} "
                                 f"{what} ({n})")
        for st in self.states:
            consuming = [s for s in self.states
                         if s.stream_id == st.stream_id]
            if len(consuming) > lim.NFA_MAX_STATES or \
                    len(self.slots[st.slot].schema.types) > \
                    lim.NFA_MAX_EV_COLS or \
                    len(self._personas(st)) > lim.NFA_MAX_PERSONAS:
                raise not_ported(
                    f"a parallel pattern stream '{st.stream_id}' beyond the "
                    "kernel's state, attribute or persona limits")

    def _personas(self, st: NfaStateSpec) -> list:
        """Counting states whose rows also answer state st."""
        return [cs for cs in self.states
                if cs.is_counting and cs.next_idx == st.idx]

    def stream_plan(self, stream_id: str):
        """(consuming states in chain order, always-armed start or None)
        for a step over ``stream_id``."""
        consuming = [st for st in self.states if st.stream_id == stream_id]
        starts = [st for st in self.states
                  if st.always_armed and st.stream_id == stream_id]
        return consuming, (starts[0] if starts else None)

    def make_stream_step(self, stream_id: str):
        """(table, EventBatch) -> (table', match batch)."""
        def step(table, batch):
            return parallel_step(self, stream_id, table, batch)
        return step


# ---------------------------------------------------------------------------
# the plain version (the reference's steps, in PyTorch)
# ---------------------------------------------------------------------------


def _first_true(mask):
    """[P, B] bool -> ([P] first-true index (0 if none), [P] any)."""
    j = torch.argmax(mask.to(torch.uint8), dim=1).to(torch.int32)
    return j, mask.any(dim=1)


def _tree(fn, *trees):
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _tree(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, tuple):
        return tuple(_tree(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _take(pop, idx):
    return _tree(lambda x: x[idx], pop)


def _put(pop, idx, sub):
    def put(full, part):
        full = full.clone()
        full[idx] = part
        return full
    return _tree(put, pop, sub)


def _empty_pop(eng, P: int, dev):
    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=dev)
    slots = []
    for s in eng.slots:
        slots.append({
            "cols": tuple(full((P, s.cap), 0, torch_dtype(t))
                          for t in s.schema.types),
            "nulls": tuple(full((P, s.cap), True, torch.bool)
                           for _ in s.schema.types),
            "ts": full((P, s.cap), 0, torch.int64),
            "n": full((P,), 0, torch.int32),
        })
    return {
        "state": full((P,), len(eng.states), torch.int32),
        "valid": full((P,), False, torch.bool),
        "last": full((P,), -1, torch.int32),
        "ts0": full((P,), 0, torch.int64),
        "has_ts0": full((P,), False, torch.bool),
        "min_prev": full((P,), False, torch.bool),
        "minrel": full((P,), BIG, torch.int32),
        "seq": full((P,), 0, torch.int64),
        "emit_at": full((P,), -1, torch.int32),
        "emit_n": full((P,), 0, torch.int32),
        "slots": tuple(slots),
    }


def _grid_loader(eng, pop, ev, own_slot: int):
    """Env of [P, B]-broadcastable columns (_env_grid): row captures
    [P, 1] against event values [1, B]; the own slot's current view is
    the incoming event."""
    _ev_ts, _kind, _valid, ev_cols, ev_nulls = ev

    def load(key):
        kind, j, a, ck = key
        spec = eng.slots[j]
        buf = pop["slots"][j]
        n = buf["n"]
        if kind == "slot":
            vals = buf["cols"][a][:, ck][:, None]
            nulls = buf["nulls"][a][:, ck][:, None]
            if j == own_slot:
                at_n = (n == ck)[:, None]
                vals = torch.where(at_n, ev_cols[a][None, :], vals)
                nulls = torch.where(at_n, ev_nulls[a][None, :], nulls)
            return vals, nulls
        if j == own_slot and ck == 0:
            return ev_cols[a][None, :], ev_nulls[a][None, :]
        n_eff = n + (1 if j == own_slot else 0)
        pos = torch.clamp(n_eff - 1 - ck, 0, spec.cap - 1).long()[:, None]
        return (torch.gather(buf["cols"][a], 1, pos),
                torch.gather(buf["nulls"][a], 1, pos))
    return load


def _virtual_loader(eng, start, ev):
    """[B] env for start-state spawn conditions (_virtual_env_b): the own
    slot is the event, everything else null."""
    _ev_ts, _kind, _valid, ev_cols, ev_nulls = ev
    dev = ev_cols[0].device if ev_cols else None

    def load(key):
        _kind_, j, a, ck = key
        if j == start.slot and ck == 0:
            return ev_cols[a], ev_nulls[a]
        t = eng.slots[j].schema.types[a]
        return (torch.zeros((), dtype=torch_dtype(t), device=dev),
                torch.ones((), dtype=torch.bool, device=dev))
    return load


def _eligible(eng, pop, is_cur, idx_b, ev_ts):
    elig = is_cur[None, :] & (idx_b[None, :] > pop["last"][:, None])
    if eng.within_ms is not None:
        ok = torch.abs(ev_ts[None, :] - pop["ts0"][:, None]) <= eng.within_ms
        elig = elig & (~pop["has_ts0"][:, None] | ok)
    return elig


def _with_slot(pop, j: int, buf):
    return {**pop, "slots": tuple(buf if k == j else b
                                  for k, b in enumerate(pop["slots"]))}


def _capture_at(eng, pop, slot_j: int, pos, ev, j, mask):
    """Capture event j (per-row index) into slot_j at per-row pos."""
    ev_ts, _kind, _valid, ev_cols, ev_nulls = ev
    spec = eng.slots[slot_j]
    buf = pop["slots"][slot_j]
    pos = torch.clamp(pos, 0, spec.cap - 1)
    onehot = (torch.arange(spec.cap, device=pos.device)[None, :]
              == pos[:, None]) & mask[:, None]
    jl = j.long()
    cols = tuple(torch.where(onehot, c[jl][:, None], col)
                 for c, col in zip(ev_cols, buf["cols"]))
    nulls = tuple(torch.where(onehot, nl[jl][:, None], nu)
                  for nl, nu in zip(ev_nulls, buf["nulls"]))
    ts = torch.where(onehot, ev_ts[jl][:, None], buf["ts"])
    return _with_slot(pop, slot_j, {"cols": cols, "nulls": nulls, "ts": ts,
                                    "n": buf["n"]})


def _at_rows(eng, pop, st):
    """(normal, persona): rows at state st, and rows of a counting state
    past its minimum that answer st too."""
    normal = pop["valid"] & (pop["state"] == st.idx)
    persona = torch.zeros_like(normal)
    for cs in eng._personas(st):
        persona = persona | (
            pop["valid"] & (pop["state"] == cs.idx) &
            (pop["slots"][cs.slot]["n"] >= cs.min_count) & pop["min_prev"])
    return normal, persona


def _state_round(eng, pop, st, ev, is_cur, idx_b, B, seqmode):
    ev_ts = ev[0]
    dev = ev_ts.device
    normal, persona = _at_rows(eng, pop, st)
    at_rows = normal | persona
    P = at_rows.shape[0]
    cond_ok = eng._cond(st, _grid_loader(eng, pop, ev, st.slot), (P, B),
                        dev)
    elig = _eligible(eng, pop, is_cur, idx_b, ev_ts)

    if st.is_counting:
        return _counting_round(eng, pop, st, at_rows, persona,
                               elig & cond_ok, ev)

    if seqmode:
        # sequence: a NORMAL row's fate is decided by its first eligible
        # event (advance on match, die on mismatch); PERSONA rows test
        # every event and are never sequence-killed
        j0, has0 = _first_true(elig)
        cond_at = torch.gather(cond_ok, 1, j0.long()[:, None])[:, 0]
        jm, hasm = _first_true(elig & cond_ok)
        adv = (normal & has0 & cond_at) | (persona & hasm)
        kill = normal & has0 & ~cond_at
        j = torch.where(persona, jm, j0)
    else:
        j, has = _first_true(elig & cond_ok)
        adv = at_rows & has
        kill = torch.zeros_like(adv)

    pop = _capture_at(eng, pop, st.slot, torch.zeros_like(j), ev, j, adv)
    buf = pop["slots"][st.slot]
    pop = _with_slot(pop, st.slot, {
        **buf, "n": torch.where(adv, torch.ones_like(buf["n"]), buf["n"])})
    got_first = adv & ~pop["has_ts0"]
    pop = {**pop,
           "ts0": torch.where(got_first, ev_ts[j.long()], pop["ts0"]),
           "has_ts0": pop["has_ts0"] | got_first,
           "last": torch.where(adv, j, pop["last"])}
    if st.next_idx == -1:
        pop = {**pop,
               "emit_at": torch.where(adv, j, pop["emit_at"]),
               "emit_n": torch.where(adv, torch.ones_like(pop["emit_n"]),
                                     pop["emit_n"]),
               "valid": pop["valid"] & ~adv & ~kill}
    else:
        pop = {**pop,
               "state": torch.where(adv, torch.full_like(pop["state"],
                                                         st.next_idx),
                                    pop["state"]),
               "valid": pop["valid"] & ~kill}
    return pop


def _counting_round(eng, pop, st, at_rows, persona, cand, ev):
    """Absorb ALL eligible matching events into the counting slot in one
    pass (cumulative-sum placement)."""
    ev_ts, _kind, _valid, ev_cols, ev_nulls = ev
    spec = eng.slots[st.slot]
    buf = pop["slots"][st.slot]
    n = torch.where(persona, torch.zeros_like(buf["n"]), buf["n"])
    cap_limit = spec.cap if st.max_count == -1 \
        else min(st.max_count, spec.cap)
    room = torch.clamp(cap_limit - n, min=0)
    cand = cand & at_rows[:, None]
    csum = torch.cumsum(cand.to(torch.int32), dim=1, dtype=torch.int32)
    take = cand & (csum <= room[:, None])
    k = torch.where(at_rows, take.sum(dim=1, dtype=torch.int32),
                    torch.zeros_like(n))
    absorbed = at_rows & (k > 0)

    # place the r-th taken event at slot position n + r - 1
    cols = [c.clone() for c in buf["cols"]]
    nulls = [x.clone() for x in buf["nulls"]]
    ts = buf["ts"].clone()
    for c in range(spec.cap):
        want = (c + 1) - n  # the rank that lands at position c
        sel = take & (csum == want[:, None])
        j_c, has_c = _first_true(sel)
        put = has_c & at_rows
        jl = j_c.long()
        for a in range(len(spec.schema.types)):
            cols[a][:, c] = torch.where(put, ev_cols[a][jl], cols[a][:, c])
            nulls[a][:, c] = torch.where(put, ev_nulls[a][jl],
                                         nulls[a][:, c])
        ts[:, c] = torch.where(put, ev_ts[jl], ts[:, c])
    new_n = n + k
    pop = _with_slot(pop, st.slot, {
        "cols": tuple(cols), "nulls": tuple(nulls), "ts": ts,
        "n": torch.where(at_rows, new_n, buf["n"])})

    # first absorbed event (ts0 / last bookkeeping)
    j_first, _ = _first_true(take)
    j_last_rank = torch.clamp(k, min=1)
    j_last, _ = _first_true(take & (csum == j_last_rank[:, None]))
    got_first = absorbed & ~pop["has_ts0"]
    state = pop["state"]
    pop = {**pop,
           "ts0": torch.where(got_first, ev_ts[j_first.long()], pop["ts0"]),
           "has_ts0": pop["has_ts0"] | got_first,
           "last": torch.where(absorbed, j_last, pop["last"]),
           "state": torch.where(absorbed, torch.full_like(state, st.idx),
                                state)}

    # min crossing: rank (min_count - n) among taken events
    crossed = absorbed & (n < st.min_count) & (new_n >= st.min_count)
    min_rank = st.min_count - n
    j_min, _ = _first_true(take & (csum == min_rank[:, None]))
    pop = {**pop, "minrel": torch.where(crossed, j_min, pop["minrel"])}

    maxed = absorbed & (st.max_count != -1) & (new_n >= st.max_count)
    if st.next_idx == -1:
        pop = {**pop,
               "emit_at": torch.where(crossed, j_min, pop["emit_at"]),
               "emit_n": torch.where(
                   crossed, torch.full_like(pop["emit_n"], st.min_count),
                   pop["emit_n"]),
               "valid": pop["valid"] & ~maxed}
    else:
        pop = {**pop,
               "state": torch.where(maxed, torch.full_like(
                   pop["state"], st.next_idx), pop["state"])}
    return pop


def _advance_rounds(eng, pop, ev, consuming, B: int):
    """One pass over the consuming states IN CHAIN ORDER advances every
    row as far as it can go in this batch (_advance_rounds :251). Each
    round's grid covers the rows at its state only."""
    ev_ts, ev_kind, ev_valid, _cols, _nulls = ev
    dev = ev_ts.device
    idx_b = torch.arange(B, dtype=torch.int32, device=dev)
    is_cur = ev_valid & (ev_kind == CURRENT)
    seqmode = eng.state_type == "sequence"
    for st in consuming:
        normal, persona = _at_rows(eng, pop, st)
        rows = torch.nonzero(normal | persona).squeeze(1)
        if rows.numel() == 0:
            continue
        sub = _state_round(eng, _take(pop, rows), st, ev, is_cur, idx_b, B,
                           seqmode)
        pop = _put(pop, rows, sub)
    return pop


def _spawn_pop(eng, start, ev, B: int, next_seq):
    """One candidate row per event for the always-armed start state
    (_spawn_pop :433-521). -> (pop, n_spawned)."""
    ev_ts, ev_kind, ev_valid, ev_cols, ev_nulls = ev
    dev = ev_ts.device
    ok = eng._cond(start, _virtual_loader(eng, start, ev), (B,), dev)
    hit = ok & ev_valid & (ev_kind == CURRENT)

    pop = _empty_pop(eng, B, dev)
    idx = torch.arange(B, dtype=torch.int32, device=dev)
    rank = torch.cumsum(hit.to(torch.int64), dim=0) - 1
    none = torch.full((B,), -1, dtype=torch.int32, device=dev)
    big = torch.full((B,), BIG, dtype=torch.int32, device=dev)
    false = torch.zeros((B,), dtype=torch.bool, device=dev)

    if start.is_counting:
        min_now = start.min_count <= 1
        maxed_now = start.max_count != -1 and 1 >= start.max_count
        spawns = hit          # all hits become rows (seq consumed)
        if start.next_idx == -1:
            as_state = start.idx
            emit_at = torch.where(hit, idx, none) if min_now else none
            alive = false if maxed_now else hit
        else:
            as_state = start.next_idx if maxed_now else start.idx
            emit_at = none
            alive = hit
        minrel = torch.where(hit, idx, big) if min_now else big
    elif start.next_idx == -1:
        # single-state pattern: every hit emits, no row persists
        spawns = false
        as_state = start.idx
        minrel = big
        emit_at = torch.where(hit, idx, none)
        alive = false
    else:
        spawns = hit
        as_state = start.next_idx
        minrel = big
        emit_at = none
        alive = hit
    n0 = hit.to(torch.int32)

    # own slot captures its event (identity gather)
    slot_bufs = []
    for j, buf in enumerate(pop["slots"]):
        if j == start.slot:
            cols = tuple(col.clone() for col in buf["cols"])
            nulls = tuple(nl.clone() for nl in buf["nulls"])
            ts = buf["ts"].clone()
            for a in range(len(cols)):
                cols[a][:, 0] = torch.where(hit, ev_cols[a], cols[a][:, 0])
                nulls[a][:, 0] = torch.where(hit, ev_nulls[a],
                                             nulls[a][:, 0])
            ts[:, 0] = torch.where(hit, ev_ts, ts[:, 0])
            slot_bufs.append({"cols": cols, "nulls": nulls, "ts": ts,
                              "n": n0})
        else:
            slot_bufs.append(buf)

    n_spawned = spawns.to(torch.int64).sum()
    # emit-only rows get post-spawn seqs (they sort after real spawns at
    # the same event, matching the scan engine's emit order)
    seq = torch.where(spawns, next_seq + rank,
                      next_seq + n_spawned + idx.to(torch.int64))
    pop.update({
        "state": torch.where(hit, torch.full_like(pop["state"], as_state),
                             pop["state"]),
        "valid": alive,
        "last": torch.where(hit, idx, pop["last"]),
        "born_rel": torch.where(hit, idx, torch.zeros_like(idx)),
        "ts0": torch.where(hit, ev_ts, pop["ts0"]),
        "has_ts0": hit,
        "minrel": minrel,
        "seq": seq,
        "emit_at": emit_at,
        "emit_n": (emit_at >= 0).to(torch.int32),
        "slots": tuple(slot_bufs),
    })
    return pop, n_spawned


def _collect_emissions(eng, out, pops):
    """Scatter (emit_at, seq)-ordered emissions from the populations into
    the output buffers (in place)."""
    OUT = eng.OUT
    key = torch.cat([torch.where(p["emit_at"] >= 0,
                                 p["emit_at"].to(torch.int64),
                                 torch.full_like(p["seq"], _NO_EMIT_KEY))
                     for p in pops])
    seq = torch.cat([p["seq"] for p in pops])
    # lexsort((seq, key)): two stable sorts, the minor key first
    o1 = torch.argsort(seq, stable=True)
    order = o1[torch.argsort(key[o1], stable=True)]
    T = key.shape[0]
    dev = key.device
    n_emit = (key < _NO_EMIT_KEY).sum()
    dest = out["n"] + torch.arange(T, dtype=torch.int64, device=dev)
    ok = (torch.arange(T, device=dev) < n_emit) & (dest < OUT)
    d = dest[ok]
    for j, spec in enumerate(eng.slots):
        for a in range(len(spec.schema.types)):
            for c in range(spec.cap):
                ci = eng.col_index[(j, a, c)]
                vs, ns = [], []
                for pop in pops:
                    buf = pop["slots"][j]
                    nl = buf["nulls"][a][:, c]
                    if eng.final_counting[j]:
                        nl = nl | (c >= pop["emit_n"])
                    vs.append(buf["cols"][a][:, c])
                    ns.append(nl)
                out["cols"][ci][d] = torch.cat(vs)[order][ok]
                out["nulls"][ci][d] = torch.cat(ns)[order][ok]
    out["ts"][d] = torch.cat([p["emit_ts"] for p in pops])[order][ok]
    out["lost"] = out["lost"] + torch.clamp(n_emit - ok.sum(), min=0)
    out["n"] = out["n"] + torch.minimum(n_emit, OUT - out["n"])


def _fold_spawns(eng, table, pop2, counter, sub_off: int):
    """Append surviving spawned rows into free table rows (in seq order);
    overflow counted (_fold_spawns :577-624)."""
    M = eng.M
    free = ~table["valid"]
    free_pos = torch.argsort((~free).to(torch.uint8), stable=True)
    n_free = free.sum()
    want = pop2["valid"]
    rank = torch.cumsum(want.to(torch.int64), dim=0) - 1
    ok = want & (rank < n_free)
    lost = (want & ~ok).sum()
    d = free_pos[torch.clamp(rank, 0, M - 1)][ok]

    def put(field, values):
        x = table[field].clone()
        x[d] = values[ok] if values.dim() else values
        return x

    min_at = torch.where(pop2["minrel"] < BIG,
                         counter + (sub_off + pop2["minrel"].to(torch.int64)),
                         torch.full_like(table["min_at"][:1], -1))
    slots = []
    for tb, pb in zip(table["slots"], pop2["slots"]):
        def put_rows(t, p):
            t = t.clone()
            t[d] = p[ok]
            return t
        slots.append({
            "cols": tuple(put_rows(tc, pc)
                          for tc, pc in zip(tb["cols"], pb["cols"])),
            "nulls": tuple(put_rows(tn, pn)
                           for tn, pn in zip(tb["nulls"], pb["nulls"])),
            "ts": put_rows(tb["ts"], pb["ts"]),
            "n": put_rows(tb["n"], pb["n"]),
        })
    return {**table,
            "state": put("state", pop2["state"]),
            "valid": put("valid", torch.ones_like(want)),
            "born": put("born", counter + (sub_off + pop2["born_rel"].to(
                torch.int64))),
            "seq": put("seq", pop2["seq"]),
            "ts0": put("ts0", pop2["ts0"]),
            "has_ts0": put("has_ts0", pop2["has_ts0"]),
            "min_at": put("min_at", min_at),
            "deadline": put("deadline", torch.tensor(
                int(POS_INF), dtype=torch.int64, device=d.device)),
            "slots": tuple(slots),
            "overflow": table["overflow"] + lost}


def _sub_step_ref(eng, consuming, start, table, out, ev, sub_off: int):
    ev_ts, _kind, ev_valid, _cols, _nulls = ev
    B = ev_ts.shape[0]
    dev = ev_ts.device
    counter = table["counter"]
    M = eng.M

    # P1: the persistent table as a population. min<0:n> counting states
    # reach their minimum at birth — their rows answer the next state
    # without any absorbed event (min_at stays -1)
    min_prev = table["min_at"] >= 0
    for cs in eng.states:
        if cs.is_counting and cs.min_count == 0:
            min_prev = min_prev | (table["state"] == cs.idx)
    pop1 = {
        "state": table["state"],
        "valid": table["valid"],
        "last": torch.full((M,), -1, dtype=torch.int32, device=dev),
        "ts0": table["ts0"],
        "has_ts0": table["has_ts0"],
        "min_prev": min_prev,
        "minrel": torch.full((M,), BIG, dtype=torch.int32, device=dev),
        "seq": table["seq"],
        "emit_at": torch.full((M,), -1, dtype=torch.int32, device=dev),
        "emit_n": torch.zeros((M,), dtype=torch.int32, device=dev),
        "slots": table["slots"],
    }
    pop1 = _advance_rounds(eng, pop1, ev, consuming, B)

    pops = [pop1]
    n_spawned = None
    if start is not None:
        pop2, n_spawned = _spawn_pop(eng, start, ev, B, table["next_seq"])
        pop2["min_prev"] = torch.zeros((B,), dtype=torch.bool, device=dev)
        if len(consuming) > 1 or start.is_counting:
            pop2 = _advance_rounds(eng, pop2, ev, consuming, B)
        pops.append(pop2)

    # emission timestamps (per-row gather of emit event ts)
    for pop in pops:
        pop["emit_ts"] = ev_ts[torch.clamp(pop["emit_at"], 0, B - 1).long()]
    _collect_emissions(eng, out, pops)

    # within pruning at batch end (monotonic time: a row that exceeded
    # `within` during this batch can never match again)
    def prune(pop):
        if eng.within_ms is None:
            return pop
        inf = int(POS_INF)
        any_valid = ev_valid.any()
        tsmax = torch.where(ev_valid, ev_ts, torch.full_like(ev_ts,
                                                             -inf)).max()
        tsmin = torch.where(ev_valid, ev_ts, torch.full_like(ev_ts,
                                                             inf)).min()
        dist = torch.maximum(torch.abs(tsmax - pop["ts0"]),
                             torch.abs(tsmin - pop["ts0"]))
        dead = pop["has_ts0"] & any_valid & (dist > eng.within_ms)
        return {**pop, "valid": pop["valid"] & ~dead}

    pop1 = prune(pop1)
    table = {
        **table,
        "state": pop1["state"],
        "valid": pop1["valid"],
        "ts0": pop1["ts0"],
        "has_ts0": pop1["has_ts0"],
        "min_at": torch.where(
            pop1["minrel"] < BIG,
            counter + (sub_off + pop1["minrel"].to(torch.int64)),
            table["min_at"]),
        "slots": pop1["slots"],
    }
    if start is not None:
        table = _fold_spawns(eng, table, prune(pop2), counter, sub_off)
        table = {**table, "next_seq": table["next_seq"] + n_spawned}
    return {**table, "counter": counter + B}


def _sub_batches(eng, B: int):
    PB = min(eng.PB, B)
    if B % PB:
        raise ValueError(f"batch capacity {B} is not a multiple of the "
                         f"sub-batch size {PB}")
    return PB, B // PB


def parallel_step_ref(eng: ParallelNfaEngine, stream_id: str, table: dict,
                      batch: EventBatch):
    """Plain PyTorch version of kernel K3 over a whole batch (step
    :717-759). -> (new table, match batch); ``table`` is not changed."""
    consuming, start = eng.stream_plan(stream_id)
    B = batch.capacity
    out = new_out(eng, batch.ts.device)
    PB, n_sub = _sub_batches(eng, B)
    for k in range(n_sub):
        o = k * PB
        ev = (batch.ts[o:o + PB], batch.kind[o:o + PB],
              batch.valid[o:o + PB],
              tuple(c[o:o + PB] for c in batch.cols),
              tuple(n[o:o + PB] for n in batch.nulls))
        table = _sub_step_ref(eng, consuming, start, table, out, ev, o)
    table = {**table, "overflow": table["overflow"] + out["lost"]}
    return table, match_batch(eng, out)


# ---------------------------------------------------------------------------
# kernel K3
# ---------------------------------------------------------------------------


def _scratch(eng, dev, PB: int):
    """Population 2 and the per-row emission fields of one sub-batch,
    allocated once per device and sub-batch size (the sub-steps of every
    step reuse them, one after the other on the stream)."""
    key = (str(dev), PB)
    s = eng._scratch.get(key)
    if s is None:
        def e(shape, dtype):
            return torch.empty(shape, dtype=dtype, device=dev)
        s = {"state": e((PB,), torch.int32), "valid": e((PB,), torch.bool),
             "last": e((PB,), torch.int32),
             "born_rel": e((PB,), torch.int32),
             "ts0": e((PB,), torch.int64), "has_ts0": e((PB,), torch.bool),
             "minrel": e((PB,), torch.int32), "seq": e((PB,), torch.int64),
             "emit_at": e((eng.M + PB,), torch.int32),
             "emit_n": e((eng.M + PB,), torch.int32),
             "span": e((4,), torch.int64),
             "slots": tuple({
                 "cols": tuple(e((PB, sp.cap), torch_dtype(t))
                               for t in sp.schema.types),
                 "nulls": tuple(e((PB, sp.cap), torch.bool)
                                for _ in sp.schema.types),
                 "ts": e((PB, sp.cap), torch.int64),
                 "n": e((PB,), torch.int32)} for sp in eng.slots)}
        eng._scratch[key] = s
    return s


def _state_desc(eng, d, st) -> None:
    d.idx, d.slot, d.next_idx = st.idx, st.slot, st.next_idx
    d.is_counting = int(st.is_counting)
    d.min_count, d.max_count = st.min_count, st.max_count
    cap = eng.slots[st.slot].cap
    d.cap_limit = cap if st.max_count == -1 else min(st.max_count, cap)
    span = eng.cond_span.get(st.idx)
    if span is None:
        d.prog_start, d.prog_len = 0, 0
    else:
        a, b = eng.program.spans[span]
        d.prog_start, d.prog_len = a, b - a
    personas = eng._personas(st)
    d.n_personas = len(personas)
    for q, cs in enumerate(personas):
        d.persona_idx[q] = cs.idx
        d.persona_slot[q] = cs.slot
        d.persona_min[q] = cs.min_count


def nfa_params(eng, stream_id: str, table, batch, out, PB: int):
    """K3's kernel arguments for every sub-batch of one step; a launch
    then sets only the event pointers and ``sub_off``."""
    dev = batch.ts.device
    consuming, start = eng.stream_plan(stream_id)
    s = _scratch(eng, dev, PB)
    code, consts, loads = eng.device_program(dev)
    p = _kernels.NfaParams()
    for k in ("state", "valid", "ts0", "has_ts0", "born", "min_at",
              "deadline", "seq", "next_seq", "counter", "overflow"):
        setattr(p, k, table[k].data_ptr())
    x = 0
    for j, spec in enumerate(eng.slots):
        tb, sb = table["slots"][j], s["slots"][j]
        p.slot_cap[j], p.slot_col0[j] = spec.cap, x
        p.slot_ncols[j] = len(spec.schema.types)
        p.slot_final_counting[j] = int(eng.final_counting[j])
        p.tab_ts[j], p.tab_n[j] = tb["ts"].data_ptr(), tb["n"].data_ptr()
        p.p2_ts[j], p.p2_n[j] = sb["ts"].data_ptr(), sb["n"].data_ptr()
        for a, t in enumerate(spec.schema.types):
            p.col_type[x] = VT[t]
            p.tab_cols[x] = tb["cols"][a].data_ptr()
            p.tab_nulls[x] = tb["nulls"][a].data_ptr()
            p.p2_cols[x] = sb["cols"][a].data_ptr()
            p.p2_nulls[x] = sb["nulls"][a].data_ptr()
            x += 1
    for k in ("state", "valid", "last", "born_rel", "ts0", "has_ts0",
              "minrel", "seq"):
        setattr(p, "p2_" + k, s[k].data_ptr())
    p.emit_at, p.emit_n = s["emit_at"].data_ptr(), s["emit_n"].data_ptr()
    p.span = s["span"].data_ptr()
    for ci, (c, n, t) in enumerate(zip(out["cols"], out["nulls"],
                                       eng.match_schema.types)):
        p.out_cols[ci], p.out_nulls[ci] = c.data_ptr(), n.data_ptr()
        p.out_type[ci] = VT[t]
    p.out_ts, p.out_n = out["ts"].data_ptr(), out["n"].data_ptr()
    p.out_valid, p.out_kind = (out["valid"].data_ptr(),
                               out["kind"].data_ptr())
    p.code, p.consts, p.loads = (code.data_ptr(), consts.data_ptr(),
                                 loads.data_ptr())
    p.within_ms = -1 if eng.within_ms is None else int(eng.within_ms)
    for d, st in zip(p.states, consuming):
        _state_desc(eng, d, st)
    if start is not None:
        _state_desc(eng, p.start, start)
    schema = eng.slots[consuming[0].slot].schema
    for a, t in enumerate(schema.types):
        p.ev_type[a] = VT[t]
    p.n_slots, p.n_consuming = len(eng.slots), len(consuming)
    p.has_start = int(start is not None)
    p.advance_pop2 = int(start is not None and (
        len(consuming) > 1 or start.is_counting))
    p.seqmode = int(eng.state_type == "sequence")
    p.n_states = len(eng.states)
    p.M, p.B, p.OUT = eng.M, PB, eng.OUT
    p.n_match_cols = len(eng.match_schema.types)
    p.min0_mask = sum(1 << cs.idx for cs in eng.states
                      if cs.is_counting and cs.min_count == 0)
    return p


def set_events(p, batch, o: int) -> None:
    """Point K3's arguments at the sub-batch of ``batch`` from row o (the
    step's first sub-batch clears the match batch, its last one writes
    the match batch's valid mask)."""
    def at(x):
        return x.data_ptr() + o * x.element_size()
    p.ev_ts, p.ev_kind, p.ev_valid = (at(batch.ts), at(batch.kind),
                                      at(batch.valid))
    for a, (c, n) in enumerate(zip(batch.cols, batch.nulls)):
        p.ev_cols[a], p.ev_nulls[a] = at(c), at(n)
    p.sub_off = o
    p.first_sub = int(o == 0)
    p.last_sub = int(o + p.B >= batch.capacity)


def parallel_step(eng: ParallelNfaEngine, stream_id: str, table: dict,
                  batch: EventBatch):
    """Kernel K3: one step of the round-parallel NFA over a batch.

    -> (table', match batch). A batch on the CPU takes the plain version
    (``table`` is left as it was). A CUDA batch launches the kernel once
    per sub-batch of PB events, with ``table`` updated in place and
    returned; the emissions lost to a full match batch are added to its
    overflow counter inside the kernel."""
    dev = batch.ts.device
    if dev.type == "cpu":
        return parallel_step_ref(eng, stream_id, table, batch)
    if dev.type != "cuda":
        raise ValueError(f"nfa_parallel: unsupported device {dev}")
    check_table(eng, table, dev, "nfa_parallel")
    B = batch.capacity
    for x in (batch.ts, batch.kind, batch.valid) + tuple(batch.cols) + \
            tuple(batch.nulls):
        if x.device != dev or x.shape != (B,) or not x.is_contiguous():
            raise ValueError("nfa_parallel: every event column must be a "
                             f"contiguous [{B}] tensor on {dev}")
    PB, n_sub = _sub_batches(eng, B)
    out = kernel_out(eng, dev)
    p = nfa_params(eng, stream_id, table, batch, out, PB)
    lib = _kernels.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    for k in range(n_sub):
        set_events(p, batch, k * PB)
        lib.nfa_parallel_step(p, stream)
        _kernels.count_launch("nfa_parallel")
    return table, EventBatch(ts=out["ts"], cols=out["cols"],
                             nulls=out["nulls"], kind=out["kind"],
                             valid=out["valid"])
