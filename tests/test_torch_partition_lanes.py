"""The stateful aggregator lanes inside a partition block (kernels C, D
and H with the block's slot axis; their plain versions once per slot on
the CPU) against the reference's partition runtime, on the CPU.

Each app's selector holds max/min over a length window's expiring
content (kernel C), distinctCount (D) and unionSet with sizeOfSet (H).
The feeds (checks.partition_feed, the module's symbol prefix, a NaN
price on a few rows) push each lane's bounds: more keys than slots (the
rows of keys without a slot are dropped and counted), a grouped ring
past its 256 live values, a union past its 32 lanes. After every send
the rows so far (in order, floats by their bits), each query's
``stats()`` (emitted and overflow) and the whole block state (the slot
table, every query's slotted state with the lanes' tables, emitted and
lost) equal the reference's, tolerance 0. The slot layout the host
hands kernels C, D and H (their StatArgs and UnionArgs moves, built as
for the card from each captured slotted step) reaches every slot's
tables and scratch."""
import ctypes

import numpy as np
import pytest
import torch

import siddhi_tpu as J
import siddhi_tpu_torch as T
from siddhi_tpu.core.types import GLOBAL_STRINGS as JSTR
from siddhi_tpu_torch import checks as C
from siddhi_tpu_torch.core.types import GLOBAL_STRINGS as TSTR
from siddhi_tpu_torch.ops import aggregators as G
from test_torch_partition_layout import check_moves
from test_torch_window import align_strings, leaves

torch.set_num_threads(1)

PREFIX = "lq"
TABLES = {J: JSTR, T: TSTR}

APPS = {
    # six keys at four slots: two keys' rows find no slot
    "keys past the slot table": (C.PART_STREAM + """
    @slots('4')
    partition with (sym of S) begin
      @info(name = 'q')
      from S#window.length(5)
      select sym, max(price) as hi, min(price) as lo,
             distinctCount(stage) as ds,
             sizeOfSet(unionSet(createSet(stage))) as ns
      insert all events into Out;
    end;
""", 6, (0, 16, 32, 160, 288, 300)),
    # two keys, 300 live rows each in a grouped ring of 256; the union of
    # the window's volumes past its 32 lanes (unionSet takes no group by:
    # a query of its own)
    "ring and union past their bounds": (C.PART_STREAM + """
    @slots('2')
    partition with (sym of S) begin
      @info(name = 'q')
      from S#window.length(300)
      select sym, max(volume) as hi, min(price) as lo,
             distinctCount(volume) as dv
      group by sym
      insert into Out;
      @info(name = 'u')
      from S#window.length(300)
      select sym, sizeOfSet(unionSet(createSet(volume))) as nv
      insert into Out2;
    end;
""", 2, (0, 128, 256, 384, 512, 640, 768, 784)),
}


def replay(pkg, name):
    text, n_syms, cuts = APPS[name]
    kw = {"device": "cpu"} if pkg is T else {}
    rt = pkg.SiddhiManager(**kw).create_siddhi_app_runtime(text)
    rows = []
    rt.add_callback("Out", pkg.StreamCallback(
        lambda evs: rows.extend(
            (e.timestamp, e.is_expired,
             tuple(x.hex() if isinstance(x, float) else x for x in e.data))
            for e in evs)))
    rt.start()
    ts, cols, _cuts = C.partition_feed(cuts[-1], TABLES[pkg].encode,
                                       n_syms=n_syms, prefix=PREFIX)
    cols[1][[i for i in (5, 77, 201, 502) if i < len(ts)]] = np.nan
    h = rt.get_input_handler("S")
    seen = []
    for a, b in zip(cuts[:-1], cuts[1:]):
        h.send_arrays(ts[a:b], [c[a:b] for c in cols])
        blocks = {n: dict(leaves({k: v for k, v in
                                  blk.snapshot_state().items()
                                  if k != "rate"}))
                  for n, blk in rt.partitions.items()}
        seen.append((list(rows), {n: q.stats()
                                  for n, q in rt.queries.items()}, blocks))
    rt.shutdown()
    return rt, seen


@pytest.fixture(scope="module", autouse=True)
def symbols():
    align_strings([f"{PREFIX}{i:02d}" for i in range(6)])


@pytest.mark.parametrize("name", sorted(APPS))
def test_lanes_in_a_block_equal_the_reference(name):
    _rj, sj = replay(J, name)
    _rt, st = replay(T, name)
    assert len(sj) == len(st)
    for send, ((rj, qj, bj), (rt_, qt, bt)) in enumerate(zip(sj, st)):
        assert rt_ == rj, send
        assert qt == qj, send
        assert bj.keys() == bt.keys()
        for n in bj:
            assert bj[n].keys() == bt[n].keys(), (send, n)
            for k in bj[n]:
                assert (bj[n][k] == bt[n][k]).all(), (send, n, k)
    rows, stats, _b = st[-1]
    assert rows and stats["q"]["emitted"] > 0
    assert all(q["overflow"] > 0 for q in stats.values()), stats


def test_the_selectors_run_the_stateful_lanes():
    for name, (text, _n, _c) in APPS.items():
        rt = T.SiddhiManager(device="cpu").create_siddhi_app_runtime(text)
        found = {type(sp) for blk in rt.partitions.values()
                 for plan in blk.plans for op in plan.operators
                 if isinstance(op, G.AggregateOp) for sp in op.agg_specs}
        assert {G.SlidingMinMaxAgg, G.DistinctCountAgg,
                G.UnionSetAgg} <= found, name
        rt.shutdown()



_STEPS: list = []


def lane_steps():
    """The slotted K6 steps with lanes of one run of every app."""
    if not _STEPS:
        k_agg = G.aggregate_step

        def capture(op, state, kc, ac, kind, valid):
            if kind.dim() == 2 and any(getattr(sp, "stateful", False)
                                       for sp in op.agg_specs):
                _STEPS.append((op, state, kc, ac, kind, valid))
            return k_agg(op, state, kc, ac, kind, valid)
        G.aggregate_step = capture
        try:
            for name in APPS:
                replay(T, name)
        finally:
            G.aggregate_step = k_agg
    return _STEPS


def test_sliding_plain_over_every_slot_in_one_call():
    """SlidingMinMaxAgg.run_slots (the plain version of kernel C over the
    slot axis in one call, which aggregate_step_ref runs for a block's or
    a pool's slots) gives run_ref's results slot by slot, bit for bit."""
    from siddhi_tpu_torch.ops.slots import stack, unstack
    n = 0
    for op, state, kc, ac, kind, valid in lane_steps():
        S = kind.shape[0]
        ctxs = [G.agg_context(op, unstack(state, k), unstack(kc, k),
                              kind[k], valid[k])[0] for k in range(S)]
        for s, sp in enumerate(op.agg_specs):
            if not isinstance(sp, G.SlidingMinMaxAgg):
                continue
            arg, tab = ac[s], state["tables"][s]
            got = sp.run_slots(arg, ctxs, tab)
            want = stack([sp.run_ref(unstack(arg, k), ctxs[k],
                                     unstack(tab, k)) for k in range(S)])
            for x, y in zip(leaves(got), leaves(want)):
                assert x[0] == y[0] and np.array_equal(x[1], y[1]), x[0]
            n += 1
    assert n >= 8


def test_slotted_plain_step_is_each_slot_alone():
    """aggregate_step_ref over the slot axis (kernel C's lanes in one call
    over every slot) equals it run on each slot alone, bit for bit."""
    from siddhi_tpu_torch.ops.slots import per_slot
    for op, state, kc, ac, kind, valid in lane_steps()[::5]:
        got = G.aggregate_step_ref(op, state, kc, ac, kind, valid)
        want = per_slot(lambda *a: G.aggregate_step_ref(op, *a),
                        kind.shape[0], state, kc, ac, kind, valid)
        for x, y in zip(leaves(got), leaves(want)):
            assert x[0] == y[0] and np.array_equal(x[1], y[1]), x[0]


def test_union_keeps_its_compacted_arrays():
    """Kernel H's compacted pairs' arrays are the aggregator's own: a step
    that keeps no more pairs a slot than the last allocates nothing; more
    pairs, or another slot count, grow them (to whole 1,024s a slot)."""
    sp = G.UnionSetAgg(T.core.types.AttrType.OBJECT, grouped=False)
    dev = torch.device("cpu")
    a1 = G.compact_arrays(sp, dev, 4, 10)
    assert G.compact_arrays(sp, dev, 4, 1024) is a1
    assert a1[0]["sgn"].numel() == 4 * 1024
    a2 = G.compact_arrays(sp, dev, 4, 1025)
    assert a2 is not a1 and a2[0]["sgn"].numel() == 4 * 2048
    assert a2[1]["counts"].numel() == 4 * 256 * 2
    assert G.compact_arrays(sp, dev, 4, 3) is a2
    a3 = G.compact_arrays(sp, dev, 8, 3)
    assert a3 is not a2 and a3[0]["msums"].numel() == 8
    # union_args points its struct at them after the count
    for op, state, kc, ac, kind, valid in lane_steps():
        _sl, _aggs, _new, _a, stats = G.agg_args(op, state, kc, ac, kind,
                                                 valid)
        for spec, ua in stats:
            if isinstance(spec, G.UnionSetAgg):
                ctypes.memset(ua.n_kept, 0, 8 * ua.n_part)
                assert ua.compacted() == 0
                arrs, srt = spec.compact[dev][2]
                assert ua.sgn == arrs["sgn"].data_ptr()
                assert ua.sort.keys == srt["keys"].data_ptr()
                return
    raise AssertionError("no unionSet step captured")


def test_lane_kernels_reach_every_slot():
    """K6[K]'s captured steps of each app: kernels C's, D's and H's
    argument structs, built as for the card, with part_args replayed for
    every slot (tests/test_torch_partition_layout.py check_moves): each
    word that points at a slotted table, output or scratch tensor lands
    on that tensor's slot k. H's host count array is the one pointer
    that stays."""
    kinds = set()
    for op, state, kc, ac, kind, valid in lane_steps()[::7]:
        _sl, aggs, new, a, stats = G.agg_args(op, state, kc, ac, kind,
                                              valid)
        assert a.n_part == kind.shape[0] > 1
        # K6[K]'s own struct: D's contributions (spec_contrib) included
        check_moves(a, (state, kc, ac, kind, valid, aggs, new, a._keep))
        lanes = [s for s, sp in enumerate(op.agg_specs)
                 if getattr(sp, "stateful", False)]
        keeps = [k for k in a._keep[1] if isinstance(k, tuple)]
        for s, (sp, st), keep in zip(lanes, stats, keeps):
            assert st.n_part == a.n_part
            held = (keep[0], keep[-1])   # the scratch and the argument
            n, _shared = check_moves(st, (state["tables"][s],
                                          new["tables"][s], held,
                                          aggs[s]))
            assert n > 0
            kinds.add(type(sp))
            if isinstance(sp, G.UnionSetAgg):
                assert st.n_kept == keep[1].data_ptr()
    assert kinds == {G.SlidingMinMaxAgg, G.DistinctCountAgg,
                     G.UnionSetAgg}
