"""The stateful aggregator lanes in a tenant pool's chain (kernels C, D
and H over the pool's slot axis; their plain versions once per slot on
the CPU) against the reference's TenantPool, on the CPU.

checks.POOL_LANES_TEMPLATE is TENANT_TEMPLATE's filter and a
length(256) window with max/min over the window's expiring content,
distinctCount and unionSet with sizeOfSet in the selector. Six tenants join while
rounds run (slots 2 -> 4 -> 8), 700 rows each in uneven chunks, a NaN
value on some rows, ``batch_max`` 128; after every fair round each
tenant's callback rows, the whole stacked states (free slots included,
the lanes' tables with them, carried through ``carry.pool_from_jax``)
and the ``emitted`` counters equal the reference pool's, bit for bit.
Then churn: a tenant leaves and one with other bindings takes the freed
slot. The unions overflow their 32 lanes in both packages alike."""
import numpy as np
import pytest
import torch

from siddhi_tpu_torch.checks import (POOL_LANES_TEMPLATE, tenant_bindings,
                                     tenant_data)
from siddhi_tpu_torch.ops import aggregators as G
from test_torch_pool_chain import Pair, chunks

torch.set_num_threads(1)


def feed(seed: int):
    ts, (v, k) = tenant_data(700, seed=seed)
    v[::97] = np.nan
    return ts, [v, k]


@pytest.fixture(scope="module")
def lanes():
    rng = np.random.default_rng(5)
    pair = Pair(POOL_LANES_TEMPLATE, slots=2, max_tenants=8, batch_max=128)
    feeds = {}
    rounds = 0
    for i in range(6):
        tid = f"l{i}"
        pair.add(tid, tenant_bindings(i))
        feeds[tid] = list(chunks(rng, *feed(200 + i)))
        for tid2, fs in feeds.items():
            if fs:
                pair.send(tid2, *fs.pop(0))
        rounds += pair.pump() > 0
    for tid, fs in feeds.items():
        for ts, cols in fs:
            pair.send(tid, ts, cols)
    rounds += pair.flush()
    slot2 = pair.t._tenants["l2"]
    pair.remove("l2")
    slot9 = pair.add("l9", {"lo": 30.5, "hi": 170.25})
    ts, cols = feed(9)
    for c in chunks(rng, ts + 1000, cols):
        pair.send("l9", *c)
    rounds += pair.flush()
    return pair, rounds, slot2, slot9


def test_lanes_rows_states_and_emitted_after_every_round(lanes):
    pair, rounds, slot2, slot9 = lanes
    assert rounds >= 8 and slot9 == slot2
    assert pair.t.slots == 8 and pair.t._grows == 2
    for i in (0, 1, 3, 4, 5, 9):
        rows = pair.rows.get(("t", f"l{i}"), [])
        assert rows and rows == pair.rows.get(("j", f"l{i}"), [])
    stats, jst = pair.t.statistics(), pair.j.statistics()
    assert stats["pool"]["state_bytes_per_tenant"] == \
        jst["pool"]["state_bytes_per_tenant"]
    assert stats["pool"]["state_bytes_by_class"] == \
        jst["pool"]["state_bytes_by_class"]
    for tid, entry in stats["tenants"].items():
        assert entry["emitted"] == jst["tenants"][tid]["emitted"]


def test_the_pool_runs_the_stateful_lanes(lanes):
    pair = lanes[0]
    (op,) = [op for op in pair.t.proto.queries["q"].operators
             if isinstance(op, G.AggregateOp)]
    assert [type(sp) for sp in op.agg_specs] == [
        G.SlidingMinMaxAgg, G.SlidingMinMaxAgg, G.DistinctCountAgg,
        G.UnionSetAgg]
    # every live tenant's union overflowed its lanes
    (st,) = [s for s in pair.t._states["q"] if "tables" in s]
    union = st["tables"][3]["overflow"]
    for tid, slot in pair.t._tenants.items():
        assert int(union[slot]) > 0, tid
