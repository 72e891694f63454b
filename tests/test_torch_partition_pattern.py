"""Pattern queries inside partition blocks (the scan engine, kernel K4's
plain version, with a [K] slot axis on its pending tables) against the
reference, on the CPU.

- the two non-mesh cases of tests/test_partition_pattern.py: per-key
  isolation of ``every e1 -> e2``, and the per-customer absence of
  AbsentPatternTestCase.testQueryAbsent43 fired by the clock;
- seeded random feeds (numpy) over several keys through the stream
  step (``every e1 -> e2 within``), the absent path (``e1 -> not ... for``)
  and its timer step, the clock advanced between sends so that the
  scheduler fires the block's TIMER steps.

Rows (in order), ``stats()`` and the whole block state after the feed
are equal to the reference's, bit for bit. Feed strings carry this
module's prefix and are interned in both string tables in one order."""
import numpy as np
import pytest
import torch

import siddhi_tpu as J
import siddhi_tpu_torch as T
from test_torch_window import align_strings, leaves

torch.set_num_threads(1)

PFX = "pp_"
KEYS = [PFX + c for c in "abcdefgh"]

ISOLATION_APP = """@app:playback
define stream S (sym string, stage int);
partition with (sym of S) begin
  @info(name='pq')
  from every e1=S[stage == 1] -> e2=S[stage == 2]
  select e1.sym as sym, e2.stage as st
  insert into Out;
end;
"""

ABSENT_APP = """@app:playback
define stream C (cid string);
partition with (cid of C) begin
  from e1=C -> not C[cid == e1.cid] for 1 sec
  select e1.cid as cid insert into Out;
end;
"""

WITHIN_APP = """@app:playback
define stream S (sym string, stage int, v double);
@slots('8')
partition with (sym of S) begin
  @info(name='pq')
  from every e1=S[stage == 1] -> e2=S[stage == 2 and v > e1.v]
       within 300 milliseconds
  select e1.sym as sym, e1.v as v1, e2.v as v2
  insert into Out;
end;
"""

ABSENT_EVERY_APP = """@app:playback
define stream S (sym string, v int);
@slots('16')
partition with (sym of S) begin
  @info(name='pq')
  from every (e1=S[v > 3] -> not S[v < 2] for 200 milliseconds)
  select e1.sym as sym, e1.v as v
  insert into Out;
end;
"""


@pytest.fixture(scope="module", autouse=True)
def aligned_symbols():
    align_strings(KEYS)


def drive(pkg, app, actions):
    """``actions``: ("send", stream, ts, row) or ("clock", ts). -> (rows,
    stats, block states)."""
    kw = {"device": "cpu"} if pkg is T else {}
    rt = pkg.SiddhiManager(**kw).create_siddhi_app_runtime(app)
    got = []
    rt.add_callback("Out", pkg.StreamCallback(
        fn=lambda evs: got.extend(
            (e.timestamp, tuple(e.data)) for e in evs)))
    rt.start()
    for act in actions:
        if act[0] == "send":
            _, sid, ts, row = act
            rt.get_input_handler(sid).send(pkg.Event(ts, tuple(row)))
        else:
            with rt.barrier:
                rt.on_ingest_ts(act[1])
    rt.shutdown()
    stats = {n: q.stats() for n, q in rt.queries.items()}
    blocks = {name: dict(leaves({k: v for k, v in b.snapshot_state().items()
                                 if k != "rate"}))
              for name, b in rt.partitions.items()}
    return got, stats, blocks


def assert_same(app, actions):
    rj, sj, bj = drive(J, app, actions)
    rt, st, bt = drive(T, app, actions)
    assert rt == rj
    assert st == sj
    assert bj.keys() == bt.keys()
    for name in bj:
        assert bj[name].keys() == bt[name].keys()
        for k in bj[name]:
            a, b = bj[name][k], bt[name][k]
            assert a.shape == b.shape and (a == b).all(), f"{name}{k}"
    return rt


def test_partitioned_pattern_per_key_isolation():
    # interleaved per-key chains: a stage-2 of key X must only complete
    # X's own pending, never another key's
    sends = [("a", 1), ("b", 1), ("b", 2), ("c", 2), ("a", 2), ("a", 1)]
    actions = [("send", "S", 1000 + i, (PFX + k, st))
               for i, (k, st) in enumerate(sends)]
    rows = assert_same(ISOLATION_APP, actions)
    assert [r[1] for r in rows] == [(PFX + "b", 2), (PFX + "a", 2)]


def test_partitioned_absent_pattern_fires_per_key():
    T0 = 1_500_000_000_000
    actions = [("send", "C", T0, (PFX + "a",)),
               ("send", "C", T0 + 1, (PFX + "b",)),
               # b re-arrives inside its wait -> b's absence violated
               ("send", "C", T0 + 500, (PFX + "b",)),
               ("clock", T0 + 1600)]
    rows = assert_same(ABSENT_APP, actions)
    assert [r[1] for r in rows] == [(PFX + "a",)]


def _feed(seed, n, row_fn, gap_hi, clock_every):
    rng = np.random.default_rng(seed)
    ts = 1_000_000
    actions = []
    for i in range(n):
        ts += int(rng.integers(1, gap_hi))
        actions.append(("send", "S", ts, row_fn(rng)))
        if (i + 1) % clock_every == 0:
            ts += int(rng.integers(50, 400))
            actions.append(("clock", ts))
    actions.append(("clock", ts + 1000))
    return actions


@pytest.mark.parametrize("seed", [1, 2])
def test_random_feed_stream_step_within(seed):
    def row(rng):
        return (KEYS[int(rng.integers(0, 6))], int(rng.integers(1, 3)),
                float(np.round(rng.uniform(0, 100), 3)))
    actions = _feed(seed, 90, row, 40, 15)
    rows = assert_same(WITHIN_APP, actions)
    assert rows


@pytest.mark.parametrize("seed", [3, 4])
def test_random_feed_absent_and_timer(seed):
    def row(rng):
        return (KEYS[int(rng.integers(0, 8))], int(rng.integers(0, 8)))
    actions = _feed(seed, 80, row, 60, 10)
    rows = assert_same(ABSENT_EVERY_APP, actions)
    assert rows


def test_random_feed_overflowing_slots():
    # more keys than @slots('8'): the ninth key's rows drop, counted
    def row(rng):
        return (KEYS[int(rng.integers(0, 8))] if rng.random() < 0.8
                else PFX + "z" + str(int(rng.integers(0, 4))),
                int(rng.integers(1, 3)),
                float(np.round(rng.uniform(0, 100), 3)))
    align_strings([PFX + "z" + str(i) for i in range(4)])
    actions = _feed(5, 60, row, 30, 20)
    assert_same(WITHIN_APP, actions)
    _rows, stats, _b = drive(T, WITHIN_APP, actions)
    assert stats["pq"]["overflow"] > 0


def test_pattern_into_an_inner_stream_reaches_only_its_port():
    """ROADMAP Queue 3: in the reference a pattern query inside a block
    hands its rows to its own port, never to an inner stream's
    consumers; the port keeps that."""
    app = """@app:playback
    define stream S (sym string, stage int);
    partition with (sym of S) begin
      @info(name='pq')
      from every e1=S[stage == 1] -> e2=S[stage == 2]
      select e1.sym as sym insert into #P;
      from #P select sym insert into Out;
    end;
    """
    got = {}
    for pkg in (J, T):
        kw = {"device": "cpu"} if pkg is T else {}
        rt = pkg.SiddhiManager(**kw).create_siddhi_app_runtime(app)
        out, port = [], []
        rt.add_callback("Out", pkg.StreamCallback(
            fn=lambda evs, o=out: o.extend(tuple(e.data) for e in evs)))
        rt.add_callback("pq", pkg.QueryCallback(
            fn=lambda t, i, r, o=port: o.extend(tuple(e.data)
                                                for e in (i or []))))
        rt.start()
        h = rt.get_input_handler("S")
        for i, (k, st) in enumerate([("a", 1), ("a", 2), ("b", 1),
                                     ("b", 2)]):
            h.send(pkg.Event(1000 + i, (PFX + k, st)))
        rt.shutdown()
        got[pkg] = (out, port)
    assert got[T] == got[J]
    assert got[T][0] == [] and len(got[T][1]) == 2
