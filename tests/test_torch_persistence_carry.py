"""A reference snapshot carried into the port (siddhi_tpu_torch/carry.py
snapshot_from_jax and pool_snapshot_from_jax), on the CPU: the
reference runs, takes ``snapshot()``, and runs on; the port's runtime
(or pool) of the same text restores the carried snapshot and takes the
same sends; its rows equal the reference's continuation (floats by
their bits), and a carried pool's stacked states and counters equal the
reference pool's after every round, bit for bit.

The apps: windows, a grouped aggregate, a table, a named window and an
incremental aggregation in one app; a pattern and a join; a reorder
buffer holding events (test_torch_persistence_carry_2.py: a partition
block with a rate-limited port, and the cron pool of
test_torch_pool_cron.py). The feeds' strings carry this
module's prefix and are interned in both string tables in one order
first, so their codes agree (group tables and slot tables are hashes of
codes)."""
import pytest
import torch

import siddhi_tpu as J
import siddhi_tpu_torch as T
from siddhi_tpu_torch import carry
from siddhi_tpu_torch.core.persistence import deserialize
from test_torch_persistence import rows
from test_torch_window import align_strings

torch.set_num_threads(1)

PFX = "pcar_"
SYMS = [PFX + s for s in ("a", "b", "c", "d")]


@pytest.fixture(scope="module", autouse=True)
def strings():
    align_strings(SYMS)


def sym(i):
    return SYMS[i % len(SYMS)]


def build(pkg, ql, outs):
    mgr = pkg.SiddhiManager(device="cpu") if pkg is T else pkg.SiddhiManager()
    rt = mgr.create_siddhi_app_runtime(ql)
    got = {o: [] for o in outs}
    for o, g in got.items():
        rt.add_callback(o, pkg.StreamCallback(fn=g.extend))
    rt.start()
    return rt, got


def feed(pkg, rt, sends):
    for sid, ts, data in sends:
        rt.get_input_handler(sid).send(pkg.Event(ts, tuple(data)))


def carried(ql, before, after, outs=("Out",), final=None):
    """The reference runs ``before``, snapshots, runs ``after``; a port
    runtime restores the carried snapshot and runs ``after``. -> (port
    rows, reference rows after the snapshot, port runtime, reference
    runtime), both shut down (``final`` runs on each first)."""
    jrt, jgot = build(J, ql, outs)
    feed(J, jrt, before)
    data = jrt.snapshot()
    cut = {o: len(g) for o, g in jgot.items()}
    trt, tgot = build(T, ql, outs)
    trt.restore(carry.snapshot_from_jax(deserialize(data), trt))
    for pkg, rt in ((J, jrt), (T, trt)):
        feed(pkg, rt, after)
        if final:
            final(pkg, rt)
        rt.shutdown()
    return ({o: rows(g) for o, g in tgot.items()},
            {o: rows(g[cut[o]:]) for o, g in jgot.items()}, trt, jrt)


def test_windows_groups_tables_named_windows_aggregations():
    ql = """
        @app:playback
        define stream S (sym string, v int, p double);
        define stream Q (sym string);
        define table Tb (sym string, v int);
        define window Wn (sym string, v int) length(3);
        define aggregation Agg from S select sym, sum(p) as tp
            group by sym aggregate every seconds;
        @info(name = 'w') from S#window.length(5)
        select sym, sum(v) as t, max(p) as mp group by sym insert into Out;
        @info(name = 'tb') from S select sym, v insert into Tb;
        @info(name = 'rd') from Q[Tb.sym == sym in Tb] select sym
        insert into Hit;
        @info(name = 'nw') from S select sym, v insert into Wn;
        @info(name = 'cr') from S#window.time(50) select sym, count() as n
        insert all events into Tm;
    """
    before = [("S", 1000 + 7 * i, (sym(i), i, 0.5 * i)) for i in range(12)]
    after = [("S", 1100 + 7 * i, (sym(i + 1), 20 + i, 1.5 * i))
             for i in range(8)] + [("Q", 1200, (sym(0),)),
                                   ("Q", 1201, (PFX + "zz",))]
    results = {}

    def final(pkg, rt):
        results[pkg] = (sorted(rt.query("from Wn select sym, v")),
                        sorted(rt.query(
                            "from Agg within 0L, 100000L per 'seconds' "
                            "select sym, tp")))
    t, j, _trt, _jrt = carried(ql, before, after,
                               outs=("Out", "Hit", "Tm"), final=final)
    assert t == j and t["Out"] and t["Hit"] and t["Tm"]
    assert results[T] == results[J] and results[T][1]


def test_pattern_and_join():
    ql = """
        @app:playback
        define stream A (sym string, v int);
        define stream B (sym string, v int);
        @info(name = 'p') from every e1=A[v > 2] -> e2=B[sym == e1.sym]
        select e1.sym as s, e1.v as a, e2.v as b insert into Out;
        @info(name = 'j') from A#window.length(4) as x
        join B#window.length(4) as y on x.sym == y.sym
        select x.v as a, y.v as b insert into J;
    """
    before = [("A", 1000 + i, (sym(i), i)) for i in range(6)] + \
        [("B", 1010, (sym(1), 50))]
    after = [("B", 1020 + i, (sym(i), 60 + i)) for i in range(4)] + \
        [("A", 1030, (sym(2), 9)), ("B", 1031, (sym(2), 70))]
    t, j, _trt, _jrt = carried(ql, before, after, outs=("Out", "J"))
    assert t == j and t["Out"] and t["J"]


def test_a_reorder_buffer_holding_events():
    ql = """
        @app:watermark(lateness='100')
        define stream S (sym string, v int);
        @info(name = 'q') from S select sym, v insert into Out;
    """
    before = [("S", 1000 + 10 * i, (sym(i), i)) for i in range(8)]
    after = [("S", 1200 + 10 * i, (sym(i), 100 + i)) for i in range(4)]
    t, j, _trt, _jrt = carried(ql, before, after)
    # the buffered rows of the snapshot come out after it, in order
    assert t == j and [r[0] for r in t["Out"]][:1] == [1000]


def test_a_port_snapshot_is_not_carried():
    trt, _ = build(T, "@app:playback define stream S (v int); "
                   "@info(name='q') from S select v insert into Out;",
                   ("Out",))
    with pytest.raises(ValueError, match="already"):
        carry.snapshot_from_jax(trt.snapshot(), trt)
    trt.shutdown()
