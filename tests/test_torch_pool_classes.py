"""Tenant pools of the pattern, join and absent-pattern classes
(siddhi_tpu_torch/serving/pool.py: K3[K], K4[K] and its timer step,
K7[K], K5[K]; their plain versions on the CPU) against the reference's
TenantPool and against the port's own separate runtimes, on the CPU.

The reference bench's pattern and join class templates and a small
absent pattern over the same ``S (k long, v double)`` run 5 tenants
from ``slots=2`` (two doublings) on ``class_feeds`` (one seed a tenant),
``batch_max`` 128, in two halves with ``advance_time`` between them;
after every fair round each tenant's callback rows, the whole stacked
states (free slots included) and the ``emitted`` counters equal the
reference pool's, bit for bit. Each tenant's rows also equal those of a
separate runtime of the template, fed that tenant's rows in the pool's
round chunks (the pattern and join in order; the absent matches, which
a pool fires at its rounds and a playback runtime at its clock, as a
multiset; each ``advance_time`` becomes an event at that time that
neither starts nor ends a match). The per-tenant state bytes are the reference's."""
import collections

import numpy as np
import pytest
import torch

import siddhi_tpu_torch as T
from siddhi_tpu_torch.checks import (POOL_ABSENT_TEMPLATE,
                                     POOL_JOIN_TEMPLATE,
                                     POOL_PATTERN_TEMPLATE, class_feeds)
from siddhi_tpu_torch.serving import Template
from test_torch_pool_chain import Pair, norm

torch.set_num_threads(1)

TEMPLATES = {"pattern": POOL_PATTERN_TEMPLATE, "join": POOL_JOIN_TEMPLATE,
             "absent": POOL_ABSENT_TEMPLATE}
STATE_BYTES = {"pattern": 466976, "join": 4512, "absent": 14624}
CLASS = {"pattern": "pattern", "join": "join", "absent": "pattern"}
N_TENANTS, ROWS, HALF = 5, 300, 150


def run(name):
    pair = Pair(TEMPLATES[name], slots=2, max_tenants=8, batch_max=128)
    feeds = {}
    for i in range(N_TENANTS):
        tid = f"c{i}"
        pair.add(tid)
        feeds[tid] = class_feeds(pair.t.ingest_streams, ROWS, seed=17 + i)
    # each tenant's round chunks, in dispatch order, for the separate
    # runtimes
    taken = collections.defaultdict(list)
    orig = pair.t._take

    def take(tid, sid, limit):
        got = orig(tid, sid, limit)
        if got is not None:
            taken[tid].append((sid, got[0], got[1]))
        return got

    def tick(now):
        pair.advance_time(now)
        for tid in feeds:
            taken[tid].append((None, now, None))
    pair.t._take = take
    last = 0
    for lo, hi in ((0, HALF), (HALF, ROWS)):
        for tid, fs in feeds.items():
            for sid, (ts, cols) in fs.items():
                pair.send(tid, ts[lo:hi], [c[lo:hi] for c in cols],
                          stream=sid)
                last = max(last, int(ts[hi - 1]))
        pair.flush()
        tick(last + 600)
    tick(last + 5000)
    return pair, taken


@pytest.fixture(scope="module", params=sorted(TEMPLATES))
def pooled(request):
    name = request.param
    pair, taken = run(name)
    return name, pair, taken


def test_rows_states_and_emitted_match_the_reference_pool(pooled):
    name, pair, _taken = pooled
    assert pair.t.slots == 8 and pair.t._grows == 2
    counts = [len(pair.rows.get(("t", f"c{i}"), []))
              for i in range(N_TENANTS)]
    assert sum(counts) > 0, counts
    for i in range(N_TENANTS):
        assert pair.rows.get(("t", f"c{i}"), []) == \
            pair.rows.get(("j", f"c{i}"), [])
    assert pair.t.state_bytes_per_tenant == \
        pair.j.state_bytes_per_tenant == STATE_BYTES[name]
    assert pair.t.state_bytes_by_class == pair.j.state_bytes_by_class == \
        {CLASS[name]: STATE_BYTES[name]}
    stats, jst = pair.t.statistics(), pair.j.statistics()
    for tid, entry in stats["tenants"].items():
        assert entry["emitted"] == jst["tenants"][tid]["emitted"]


def test_each_tenant_matches_a_separate_runtime(pooled):
    name, pair, taken = pooled
    tpl = Template(TEMPLATES[name])
    for i in range(N_TENANTS):
        tid = f"c{i}"
        text = "@app:playback\n" + tpl.instantiate_static(
            {}, app_name=f"sep_{name}_{i}")
        rt = T.SiddhiManager(device="cpu").create_siddhi_app_runtime(text)
        rows = []
        rt.add_callback("Out", T.StreamCallback(lambda evs: rows.extend(
            (e.timestamp, e.is_expired, tuple(norm(x) for x in e.data))
            for e in evs)))
        rt.start()
        for sid, ts, cols in taken[tid]:
            if sid is not None:
                rt.get_input_handler(sid).send_arrays(ts, cols)
            elif name == "absent":
                # the pool's advance_time: an event at that time that
                # neither starts (v <= 800) nor ends (k < 0) a match
                rt.get_input_handler("S").send_arrays(
                    np.array([ts], np.int64),
                    [np.array([-1], np.int64), np.array([0.0])])
        rt.shutdown()
        pooled_rows = pair.rows.get(("t", tid), [])
        if name == "absent":
            assert collections.Counter(rows) == \
                collections.Counter(pooled_rows), tid
        else:
            assert rows == pooled_rows, tid
