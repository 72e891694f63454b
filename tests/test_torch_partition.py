"""Partition blocks (parallel/partition.py: kernel K9p, and K5, K6 and K2
with the slot axis; their plain versions on the CPU) against the
reference, on the CPU.

Every app and feed of tests/test_partition.py but the mesh cases (a
device mesh is not ported) goes through the reference's SiddhiManager
and the port's: value-key routing, per-key running sums behind an
unpartitioned query, two queries on one stream, inner-stream chaining,
group by inside a block, key overflow, range instances, unmatched rows
dropped, length and time windows with expiry. The rows each output
stream receives (timestamp, kind, values, floats by their bits, in
order), every query's ``stats()`` and the whole block state after the
feed (the slot table, every query's [K]-stacked state, ``emitted`` and
``lost``) are equal, bit for bit (tolerance 0). The planner's errors
are the reference's: a duplicate query name and more range labels than
slots raise the same CompileError.

The feeds' strings carry this module's prefix and are interned in both
packages' string tables in one order first, so their dictionary codes,
and so the key hashes and the slots they claim, agree."""
import struct

import numpy as np
import pytest
import torch

import siddhi_tpu as J
import siddhi_tpu_torch as T
from siddhi_tpu.core.types import GLOBAL_STRINGS as JSTR
from siddhi_tpu_torch.core.types import GLOBAL_STRINGS as TSTR
from test_torch_window import align_strings, leaves

torch.set_num_threads(1)

PLAYBACK = "@app:playback "
PFX = "pt_"


def norm(v):
    if isinstance(v, float):
        return ("f", struct.pack("<d", v))
    return v


def p(s):
    return PFX + s


# (name, app, sends, output stream, partitioned query names) — the apps
# of tests/test_partition.py, the feeds' strings prefixed
CASES = {
    "basic_routing": ("""
        define stream streamA (symbol string, price int);
        partition with (symbol of streamA)
        begin
          @info(name = 'query1')
          from streamA select symbol, price insert into StockQuote;
        end;
     """, [("streamA", 1000, (p("IBM"), 700)),
           ("streamA", 1001, (p("WSO2"), 60)),
           ("streamA", 1002, (p("WSO2"), 60))], "StockQuote"),
    "per_key_running_sum": ("""
        define stream cseEventStreamOne (symbol string, price float,
                                         volume int);
        @info(name = 'query')
        from cseEventStreamOne select symbol, price, volume
        insert into cseEventStream;
        partition with (symbol of cseEventStream)
        begin
          @info(name = 'query1')
          from cseEventStream[700 > price]
          select symbol, sum(price) as price, volume
          insert into OutStockStream;
        end;
     """, [("cseEventStreamOne", 1000, (p("IBM"), 75.6, 100)),
           ("cseEventStreamOne", 1001, (p("WSO2"), 70005.6, 100)),
           ("cseEventStreamOne", 1002, (p("IBM"), 75.6, 100)),
           ("cseEventStreamOne", 1003, (p("ORACLE"), 75.6, 100))],
        "OutStockStream"),
    "two_queries_same_stream": ("""
        define stream streamA (symbol string, price int);
        partition with (symbol of streamA)
        begin
          @info(name = 'query1')
          from streamA select symbol, price insert into StockQuote;
          @info(name = 'query2')
          from streamA select symbol, price insert into StockQuote;
        end;
     """, [("streamA", 1000, (p("IBM"), 700)),
           ("streamA", 1001, (p("WSO2"), 60))], "StockQuote"),
    "inner_stream_chaining": ("""
        define stream S (symbol string, price float);
        partition with (symbol of S)
        begin
          from S select symbol, price + 5 as price insert into #P;
          from #P select symbol, sum(price) as total insert into Out;
        end;
     """, [("S", 1000, (p("IBM"), 10.0)), ("S", 1001, (p("WSO2"), 20.0)),
           ("S", 1002, (p("IBM"), 30.0))], "Out"),
    "group_by_inside_partition": ("""
        define stream S (region string, symbol string, v int);
        partition with (region of S)
        begin
          from S select region, symbol, sum(v) as total
          group by symbol insert into Out;
        end;
     """, [("S", 1000, (p("EU"), p("IBM"), 1)),
           ("S", 1001, (p("US"), p("IBM"), 10)),
           ("S", 1002, (p("EU"), p("IBM"), 2)),
           ("S", 1003, (p("EU"), p("WSO2"), 5))], "Out"),
    "key_overflow_counted": ("""
        define stream S (symbol string, v int);
        @slots('2')
        partition with (symbol of S)
        begin
          @info(name = 'pq')
          from S select symbol, sum(v) as total insert into Out;
        end;
     """, [("S", 1000 + i, (p(sym), 1))
           for i, sym in enumerate(["A", "B", "C", "D", "A"])], "Out"),
    "range_instances": ("""
        define stream S (symbol string, price float);
        partition with (price < 100 as 'low' or
                        price >= 100 as 'high' of S)
        begin
          from S select symbol, count() as c insert into Out;
        end;
     """, [("S", 1000, (p("A"), 50.0)), ("S", 1001, (p("B"), 150.0)),
           ("S", 1002, (p("C"), 60.0))], "Out"),
    "unmatched_rows_drop": ("""
        define stream S (symbol string, price float);
        partition with (price < 100 as 'low' of S)
        begin
          from S select symbol, count() as c insert into Out;
        end;
     """, [("S", 1000, (p("A"), 50.0)), ("S", 1001, (p("B"), 150.0)),
           ("S", 1002, (p("C"), 60.0))], "Out"),
    "per_key_length_window": ("""
        define stream S (symbol string, v int);
        partition with (symbol of S)
        begin
          from S#window.length(2) select symbol, sum(v) as total
          insert into Out;
        end;
     """, [("S", 1000, (p("A"), 1)), ("S", 1001, (p("A"), 2)),
           ("S", 1002, (p("B"), 10)), ("S", 1003, (p("A"), 4))], "Out"),
    "per_key_time_window_expiry": ("""
        define stream S (symbol string, v int);
        partition with (symbol of S)
        begin
          from S#window.time(1 sec) select symbol, sum(v) as total
          insert into Out;
        end;
     """, [("S", 1000, (p("A"), 1)), ("S", 1100, (p("B"), 10)),
           ("S", 1200, (p("A"), 2)), ("S", 2500, (p("A", ), 5)),
           ("S", 2600, (p("B"), 20))], "Out"),
}

# what tests/test_partition.py asserts of each feed (the port is held
# to these too, beside the reference's own rows)
EXPECTED = {
    "basic_routing": [(p("IBM"), 700), (p("WSO2"), 60), (p("WSO2"), 60)],
    "two_queries_same_stream": 4,
    "group_by_inside_partition": [
        (p("EU"), p("IBM"), 1), (p("US"), p("IBM"), 10),
        (p("EU"), p("IBM"), 3), (p("EU"), p("WSO2"), 5)],
    "key_overflow_counted": [(p("A"), 1), (p("B"), 1), (p("A"), 2)],
    "unmatched_rows_drop": [(p("A"), 1), (p("C"), 2)],
    "per_key_time_window_expiry": [
        (p("A"), 1), (p("B"), 10), (p("A"), 3), (p("A"), 5), (p("B"), 20)],
}


def _strings():
    out = []
    for _app, sends, _o in CASES.values():
        for _sid, _ts, row in sends:
            for v in row:
                if isinstance(v, str) and v not in out:
                    out.append(v)
    return out


@pytest.fixture(scope="module", autouse=True)
def aligned_symbols():
    align_strings(_strings())


class Replay:
    """One case in one package: its rows, its queries' stats and its
    blocks' states after the feed."""

    def __init__(self, pkg, app, sends, out, state_after=None):
        kw = {"device": "cpu"} if pkg is T else {}
        rt = pkg.SiddhiManager(**kw).create_siddhi_app_runtime(
            PLAYBACK + app)
        self.rt = rt
        self.rows = []
        rt.add_callback(out, pkg.StreamCallback(
            lambda evs: self.rows.extend(
                (e.timestamp, e.is_expired, tuple(norm(x) for x in e.data))
                for e in evs)))
        rt.start()
        for sid, ts, data in sends:
            rt.get_input_handler(sid).send(pkg.Event(ts, tuple(data)))
        rt.shutdown()
        self.stats = {n: q.stats() for n, q in rt.queries.items()}
        self.blocks = {
            name: dict(leaves({k: v for k, v in b.snapshot_state().items()
                               if k != "rate"}))
            for name, b in rt.partitions.items()}


_REF: dict = {}


def reference(case) -> Replay:
    if case not in _REF:
        _REF[case] = Replay(J, *CASES[case])
    return _REF[case]


@pytest.mark.parametrize("case", sorted(CASES))
def test_case_equals_the_reference(case):
    want = reference(case)
    got = Replay(T, *CASES[case])
    assert got.rows == want.rows
    assert got.stats == want.stats
    assert got.blocks.keys() == want.blocks.keys()
    for name in want.blocks:
        sj, st = want.blocks[name], got.blocks[name]
        assert sj.keys() == st.keys(), name
        for k in sj:
            assert sj[k].shape == st[k].shape and (sj[k] == st[k]).all(), \
                f"{name}{k} differs"


@pytest.mark.parametrize("case", sorted(EXPECTED))
def test_case_rows_as_the_reference_suite_asserts(case):
    got = Replay(T, *CASES[case])
    data = [tuple(x[1] if isinstance(x, tuple) else x for x in r[2])
            for r in got.rows]
    want = EXPECTED[case]
    if isinstance(want, int):
        assert len(data) == want
    else:
        assert data == want


def test_overflow_count_is_the_reference_suites():
    got = Replay(T, *CASES["key_overflow_counted"])
    # C and D find no slot; A and B keep flowing
    assert got.stats["pq"]["overflow"] == 2


def test_sums_as_the_reference_suite_asserts():
    def vals(case, i):
        return [round(struct.unpack("<d", r[2][i][1])[0], 4)
                for r in Replay(T, *CASES[case]).rows]
    assert vals("per_key_running_sum", 1) == [75.6, 151.2, 75.6]
    assert vals("inner_stream_chaining", 1) == [15.0, 25.0, 50.0]
    assert [r[2][1] for r in Replay(T, *CASES["range_instances"]).rows] \
        == [1, 1, 2]
    assert [r[2][1] for r in
            Replay(T, *CASES["per_key_length_window"]).rows] == [1, 3, 10, 6]


PLAN_ERRORS = {
    "duplicate query name": """
        define stream S (symbol string, v int);
        partition with (symbol of S)
        begin
          @info(name = 'dup') from S select sum(v) as t insert into A;
          @info(name = 'dup') from S select v insert into B;
        end;
    """,
    "range labels": """
        @slots('2')
        partition with (v < 10 as 'small' or v < 100 as 'mid'
                        or v >= 100 as 'big' of S)
        begin
          @info(name = 'q') from S select v insert into Out;
        end;
        define stream S (v int);
    """,
}


@pytest.mark.parametrize("what", sorted(PLAN_ERRORS))
def test_plan_errors_are_the_references(what):
    from siddhi_tpu.ops.expr import CompileError as JErr
    from siddhi_tpu_torch.ops.expr import CompileError as TErr
    text = PLAYBACK + PLAN_ERRORS[what]
    with pytest.raises(JErr, match=what) as ej:
        J.SiddhiManager().create_siddhi_app_runtime(text)
    with pytest.raises(TErr, match=what) as et:
        T.SiddhiManager(device="cpu").create_siddhi_app_runtime(text)
    assert str(et.value) == str(ej.value)


def test_partition_mesh_is_not_ported():
    with pytest.raises(NotImplementedError,
                       match="not ported yet: partition_mesh"):
        T.SiddhiManager(device="cpu").create_siddhi_app_runtime(
            PLAYBACK + CASES["basic_routing"][0], partition_mesh=object())


def test_string_tables_agree_on_the_feeds():
    for s in _strings():
        assert JSTR.encode(s) == TSTR.encode(s)
    assert np.int32(TSTR.encode(p("IBM"))) > 0
