"""Tenant pools of the incremental-aggregation class (siddhi_tpu_torch/
serving/pool.py: kernel K11[K], its plain version on the CPU, after K1[K]
and K2) against the reference's TenantPool, on the CPU.

Three templates: the reference's own AGG_TPL (tests/test_pool_classes.py,
copied), checks.POOL_AGG_TEMPLATE (the query guide's six-duration
aggregation beside a per-tenant alert filter: one ingest stream fanned
out to both, the packed-buffer flavour) and an upstream filter query
feeding an aggregation with min/max lanes (the stacked-batch flavour).
Five tenants join while rounds run (slots 2 -> 4 -> 8) on
checks.agg_trades_feed (one seed a tenant, event times up to 2 s out of
order), ``batch_max`` 64, then churn: a tenant leaves and a new one takes
its slot. After every fair round the whole stacked states (idle slots
included, carried through ``carry.pool_from_jax``), the ``emitted``
counters and each tenant's callback rows equal the reference pool's,
bit for bit. Then ``materialize_tenant`` for every tenant and duration
gives the reference's rows, values by their bits; the per-class state
bytes and the unknown-aggregation KeyError are the reference's; and a
reference pool's states carried into a fresh port pool read the same.
K11[K]'s argument struct, built as for the card from captured slotted
steps, moves every pointer to each slot's batch, state and scratch.
Symbols carry this module's prefix and are interned in both string
tables in one order first."""
import numpy as np
import pytest
import torch

import jax

from siddhi_tpu_torch import carry
from siddhi_tpu_torch.core import aggregation as AG
from siddhi_tpu_torch.checks import (POOL_AGG_TEMPLATE, agg_trades_feed,
                                     pool_agg_bindings)
from siddhi_tpu_torch.core.types import GLOBAL_STRINGS as TSTR
from test_torch_partition_layout import check_moves
from test_torch_pool_chain import Pair, host_leaves
from test_torch_window import align_strings

torch.set_num_threads(1)

PFX = "pg"
N_SYMS = 8

# tests/test_pool_classes.py AGG_TPL
AGG_TPL = """
define stream T (sym long, price double, ats long);
@info(name='q')
from T select sym, price insert into Out;
define aggregation Agg
from T
select sym, sum(price) as tp, count() as n
group by sym
aggregate by ats every seconds, minutes;
"""

# an upstream filter feeding the aggregation: its rows arrive as the
# filter's stacked out batch
FILTERED_TPL = """
define stream TradeStream (symbol string, price double, volume long, timestamp long);
define stream BigTrades (symbol string, price double, volume long, timestamp long);
@info(name='big')
from TradeStream[volume > ${min_vol:long}]
select symbol, price, volume, timestamp insert into BigTrades;
define aggregation BigAgg
from BigTrades
select symbol, sum(price) as total, count() as n, max(price) as hi,
       min(volume) as lo
group by symbol
aggregate by timestamp every sec ... hour;
"""

TEMPLATES = {
    "agg_tpl": (AGG_TPL, "Agg", lambda i: {}),
    "metering": (POOL_AGG_TEMPLATE, "TradeAggregation", pool_agg_bindings),
    "filtered": (FILTERED_TPL, "BigAgg",
                 lambda i: {"min_vol": 100 * (i % 5)}),
}
STATE_BYTES = {"agg_tpl": {"aggregation": 409624, "chain": 8},
               "metering": {"aggregation": 1327160, "chain": 16},
               "filtered": {"aggregation": 958496, "chain": 16}}
N_TENANTS, ROWS = 5, 240


def feed(name, seed):
    ts, (sym, price, vol, stamp) = agg_trades_feed(
        ROWS, TSTR.encode, seed=seed, n_syms=N_SYMS, prefix=PFX)
    if name == "agg_tpl":
        return ts, [(sym % N_SYMS).astype(np.int64), price, stamp]
    return ts, [sym, price, vol, stamp]


def chunks(rng, ts, cols):
    at = 0
    while at < len(ts):
        n = int(rng.integers(1, 90))
        yield ts[at:at + n], [c[at:at + n] for c in cols]
        at += n


@pytest.fixture(scope="module", autouse=True)
def symbols():
    align_strings([f"{PFX}{i:02d}" for i in range(N_SYMS)])


@pytest.fixture(scope="module", params=sorted(TEMPLATES))
def pooled(request):
    name = request.param
    text, _agg, binds = TEMPLATES[name]
    rng = np.random.default_rng(7)
    pair = Pair(text, slots=2, max_tenants=8, batch_max=64)
    feeds = {}
    rounds = 0
    for i in range(N_TENANTS):
        tid = f"a{i}"
        pair.add(tid, binds(i))
        feeds[tid] = list(chunks(rng, *feed(name, 30 + i)))
        for tid2, fs in feeds.items():
            if fs:
                pair.send(tid2, *fs.pop(0))
        rounds += pair.pump() > 0
    for tid, fs in feeds.items():
        for ts, cols in fs:
            pair.send(tid, ts, cols)
    rounds += pair.flush()
    # churn: a2 leaves, a9 takes its slot (LIFO) with a feed of its own
    slot2 = pair.t._tenants["a2"]
    pair.remove("a2")
    slot9 = pair.add("a9", binds(9))
    ts, cols = feed(name, 99)
    for c in chunks(rng, ts + 40_000, cols):
        pair.send("a9", *c)
    rounds += pair.flush()
    return name, pair, rounds, slot2, slot9


def bits(x):
    a = np.asarray(x)
    return a.view(np.int64) if a.dtype == np.float64 else a


def test_states_emitted_and_rows_after_every_round(pooled):
    name, pair, rounds, slot2, slot9 = pooled
    assert rounds >= 6 and slot9 == slot2
    assert pair.t.slots == 8 and pair.t._grows == 2
    stats, jst = pair.t.statistics(), pair.j.statistics()
    for tid, entry in stats["tenants"].items():
        assert entry["emitted"] == jst["tenants"][tid]["emitted"], tid
        assert entry["emitted"][TEMPLATES[name][1]] > 0, tid
    assert pair.t.state_bytes_by_class == pair.j.state_bytes_by_class == \
        STATE_BYTES[name]
    assert pair.t.state_bytes_per_tenant == pair.j.state_bytes_per_tenant


def test_materialize_tenant_equals_the_reference(pooled):
    name, pair, _r, _s2, _s9 = pooled
    agg = TEMPLATES[name][1]
    durations = pair.t._aggs[agg].durations
    assert durations == list(pair.j._aggs[agg].durations)
    for tid in pair.t._tenants:
        for d in durations:
            sj, bj = pair.j.materialize_tenant(tid, agg, d)
            st, bt = pair.t.materialize_tenant(tid, agg, d)
            assert [a.name for a in st.attributes] == \
                [a.name for a in sj.attributes]
            vj, vt = np.asarray(bj["valid"]), bt["valid"].numpy()
            assert np.array_equal(vj, vt) and vt.any(), (tid, d)
            for k in ("cols", "nulls"):
                for x, y in zip(bj[k], bt[k]):
                    assert np.array_equal(bits(x), bits(y.numpy())), \
                        (tid, d, k)
    # a window of one duration's buckets: the within bounds
    tid = next(iter(pair.t._tenants))
    _s, bj = pair.j.materialize_tenant(tid, agg, "seconds",
                                       1_767_225_600_000, 1_767_225_610_000)
    _s, bt = pair.t.materialize_tenant(tid, agg, "sec",
                                       1_767_225_600_000, 1_767_225_610_000)
    assert np.array_equal(np.asarray(bj["valid"]), bt["valid"].numpy())


def test_unknown_aggregation_and_tenant(pooled):
    _name, pair, _r, _s2, _s9 = pooled
    msgs = []
    for pool in (pair.j, pair.t):
        with pytest.raises(KeyError) as e:
            pool.materialize_tenant("a0", "Nope", "seconds")
        msgs.append(str(e.value))
        with pytest.raises(KeyError):
            pool.materialize_tenant("nobody", TEMPLATES[_name][1],
                                    "seconds")
    assert msgs[0] == msgs[1] and "no aggregation 'Nope'" in msgs[1]


def test_pool_from_jax_carries_the_aggregation_node(pooled):
    name, pair, _r, _s2, _s9 = pooled
    agg = TEMPLATES[name][1]
    states, emitted = carry.pool_from_jax(
        jax.tree_util.tree_map(np.asarray, pair.j._states),
        {qn: np.asarray(e) for qn, e in pair.j._emitted.items()}, "cpu",
        pair.j._kind)
    S, D, K = states[agg]["keys"].shape
    assert (S, D) == (pair.j.slots, len(pair.j._aggs[agg].durations))
    # the reference's {duration: state}: the port's duration axis
    durations = pair.t._aggs[agg].durations
    for i, d in enumerate(durations):
        st = {k: (tuple(x[:, i] for x in v) if isinstance(v, tuple)
                  else v[:, i])
              for k, v in pair.t._states[agg].items()}
        want = jax.tree_util.tree_map(np.asarray, pair.j._states[agg][d])
        for x, y in zip(host_leaves(want), host_leaves(st)):
            assert np.array_equal(x, y), d
    # a fresh port pool given the carried states reads as the reference
    fresh = Pair(TEMPLATES[name][0], slots=pair.t.slots, max_tenants=8,
                 batch_max=64).t
    for tid, slot in sorted(pair.t._tenants.items(), key=lambda x: x[1]):
        fresh._tenants[tid] = slot
    fresh._states, fresh._emitted = states, emitted
    for tid in pair.t._tenants:
        for d in pair.t._aggs[agg].durations:
            _s, bj = pair.j.materialize_tenant(tid, agg, d)
            _s, bf = fresh.materialize_tenant(tid, agg, d)
            for x, y in zip(bj["cols"], bf["cols"]):
                assert np.array_equal(bits(x), bits(y.numpy())), (tid, d)


def test_k11_slot_moves_reach_every_slot():
    """The pool's aggregation steps, each flavour (the packed round
    buffer and an upstream query's batch): K11[K]'s struct built as for
    the card, part_args replayed for every slot (check_moves)."""
    calls = []
    k_step = AG.aggregation_step

    def capture(rt, state, batch, now):
        if batch.ts.dim() == 2:
            calls.append((rt, state, batch, now))
        return k_step(rt, state, batch, now)
    AG.aggregation_step = capture
    try:
        for name in ("metering", "filtered"):
            text, _agg, binds = TEMPLATES[name]
            pair = Pair(text, slots=4, max_tenants=4, batch_max=64)
            for i in range(3):
                pair.add(f"m{i}", binds(i))
                pair.send(f"m{i}", *feed(name, 60 + i))
            pair.flush()
    finally:
        AG.aggregation_step = k_step
    assert len(calls) >= 4
    for rt, state, batch, now in calls:
        gcols, args, ets = AG.step_inputs(rt, batch, now)
        new, a = AG.aggr_args(rt, state, batch, gcols, args, ets)
        assert a.n_part == batch.ts.shape[0] == 4
        assert a.D == len(rt.durations) and a.B == batch.ts.shape[1]
        n, _shared = check_moves(a, (batch, gcols, args, ets, state, new,
                                     a._keep[-1]))
        assert n > 0
