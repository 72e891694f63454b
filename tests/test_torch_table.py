"""In-memory tables (kernel K8, and K7 reading a table; their plain
versions on the CPU) against the reference. The same sends go through
both packages; the rows the output stream receives (floats by their
bits, in order), the statistics and every table's whole state (columns,
null masks, ts, seq, valid, next_seq, overflow) after every send are
equal, bit for bit:
- ``stock_table`` at a reduced size (64 symbols, 3 rounds of 256-row
  sends), also against its numpy oracle (last writer wins per symbol);
- the comparison apps of checks.TABLE_APPS (insert, delete through the
  condition pass and through @Index, update with and without SET,
  update or insert, primary-key duplicates in one batch, IN-table
  filters through the condition pass and an index, a table past its
  capacity);
- the scenarios of the reference's tests/test_table.py and
  tests/test_index.py;
- a reference table state carried into the port (carry.py).
Join planning errors raise in both packages."""
import numpy as np
import pytest
import torch

import siddhi_tpu as J
import siddhi_tpu_torch as T
from siddhi_tpu_torch.checks import (STOCK_TABLE_APP, TABLE_APPS,
                                     join_symbols, stock_table_feed,
                                     stock_table_oracle, table_shape_feed)
from test_torch_join_shapes import (TABLES, MultiRun, compare_runs, norm,
                                    replay_both)
from test_torch_window import align_strings

torch.set_num_threads(1)

PREFIX = "TB"


@pytest.fixture(scope="module", autouse=True)
def _strings():
    align_strings(join_symbols(64, PREFIX))


def test_stock_table_equals_the_reference_and_its_oracle():
    runs = {pkg: MultiRun(pkg, STOCK_TABLE_APP, out="OutputStream")
            for pkg in (J, T)}
    feeds = {pkg: stock_table_feed(64, 3, 256, TABLES[pkg].encode,
                                   prefix=PREFIX) for pkg in (J, T)}
    for i in range(len(feeds[J])):
        for pkg, r in runs.items():
            stream, ts, cols = feeds[pkg][i]
            r.send_arrays(stream, ts, cols)
        compare_runs(runs[J], runs[T], f"send {i} ({feeds[J][i][0]})")
    rt = runs[T].rt
    assert {v["kernel"] for v in rt.join_kernels.values()} == {"probe"}
    assert len(runs[T].rows) == 3 * 256
    assert int(rt.tables["StockTable"].state["valid"].sum()) == 64
    assert rt.queries["lookup"].overflow == 0
    sym, qty, price, vol = stock_table_oracle(feeds[J])
    want = [(TABLES[J].decode(int(s)), int(q), norm(float(p)), int(v))
            for s, q, p, v in zip(sym, qty, price, vol)]
    assert [r[1] for r in runs[J].rows] == want


@pytest.mark.parametrize("app", sorted(TABLE_APPS))
def test_table_app_equals_the_reference(app, monkeypatch):
    feed = table_shape_feed(80, seed=sorted(TABLE_APPS).index(app))
    _rj, rt = replay_both(TABLE_APPS[app], feed, monkeypatch)
    if app == "over_capacity":
        assert int(rt.rt.tables["T"].state["overflow"]) > 0
    if app == "delete_index":
        assert rt.rt.queries["del"].operators[-1].index_probe is not None
    if app == "in_index":
        assert rt.rt.queries["q"].operators[0].contains[0][2] is not None


# -- the reference's tests/test_table.py scenarios -------------------------

_BASE = """
    @app:playback
    define stream StockStream (symbol string, price float, volume long);
    define stream OpStream (symbol string, price float, volume long);
    define table StockTable (symbol string, price float, volume long);
    @info(name = 'fill')
    from StockStream select symbol, price, volume insert into StockTable;
"""
_FILL = [("StockStream", [(1000, ("IBM", 10.0, 100)),
                          (1001, ("WSO2", 20.0, 200)),
                          (1002, ("GOOG", 30.0, 300))])]
SCENARIOS = {
    "insert_and_contents": ("", [], {("IBM", 10.0, 100), ("WSO2", 20.0, 200),
                                     ("GOOG", 30.0, 300)}),
    "delete_bare_name_on_condition": (
        """@info(name = 'del') from OpStream select symbol, price, volume
        delete StockTable on symbol == StockTable.symbol;""",
        [("OpStream", [(2000, ("WSO2", 0.0, 0))])],
        {("IBM", 10.0, 100), ("GOOG", 30.0, 300)}),
    "update_bare_name_set_and_on": (
        """@info(name = 'upd') from OpStream select symbol, price, volume
        update StockTable set StockTable.price = price
        on StockTable.symbol == symbol;""",
        [("OpStream", [(2000, ("IBM", 99.5, 0))])],
        {("IBM", 99.5, 100), ("WSO2", 20.0, 200), ("GOOG", 30.0, 300)}),
    "update_default_set_clause": (
        """@info(name = 'upd') from OpStream select symbol, price, volume
        update StockTable on StockTable.symbol == symbol;""",
        [("OpStream", [(2000, ("GOOG", 77.0, 700))])],
        {("IBM", 10.0, 100), ("WSO2", 20.0, 200), ("GOOG", 77.0, 700)}),
    "update_or_insert": (
        """@info(name = 'uoi') from OpStream select symbol, price, volume
        update or insert into StockTable set StockTable.volume = volume
        on StockTable.symbol == symbol;""",
        [("OpStream", [(2000, ("IBM", 0.0, 111))]),
         ("OpStream", [(2001, ("MSFT", 40.0, 400))])],
        {("IBM", 10.0, 111), ("WSO2", 20.0, 200), ("GOOG", 30.0, 300),
         ("MSFT", 40.0, 400)}),
}


@pytest.mark.parametrize("case", sorted(SCENARIOS))
def test_reference_table_scenario(case, monkeypatch):
    extra, sends, want = SCENARIOS[case]
    _rj, rt = replay_both(_BASE + extra, _FILL + sends, monkeypatch)
    got = set(rt.rt.query("from StockTable select symbol, price, volume"))
    assert {(s, round(p, 4), v) for s, p, v in got} == want


@pytest.mark.parametrize("index", [True, False])
def test_in_table_filter_equals_the_reference(index, monkeypatch):
    idx = "@Index('k')" if index else ""
    app = f"""
        @app:playback
        {idx}
        define table T (k int);
        define stream Fill (k int);
        define stream S (k int, v int);
        from Fill select k insert into T;
        @info(name='q') from S[T.k == k in T] select k, v insert into O;
    """
    feed = [("Fill", [(1000 + i, (k,))]) for i, k in enumerate([2, 5, 9])]
    feed += [("S", [(2000 + i, (k, i))])
             for i, k in enumerate([1, 2, 5, 7, 9, 9])]
    monkeypatch.delenv("SIDDHI_TPU_JOIN_KERNEL", raising=False)
    runs = [MultiRun(pkg, app, out="O") for pkg in (J, T)]
    for stream, rows in feed:
        for r in runs:
            r.send(stream, rows)
        compare_runs(*runs, stream)
    assert [r[1] for r in runs[1].rows] == [(2, 1), (5, 2), (9, 4), (9, 5)]


@pytest.mark.parametrize("what", ["two tables", "unidirectional",
                                  "table handlers", "store"])
def test_join_planning_errors_raise_in_both(what):
    tables = """
        define stream S (k string, a int);
        define table T (k string, a int);
        define table U (k string, a int);
    """
    q = {"two tables": "from T join U on T.k == U.k select T.k insert into O;",
         "unidirectional": "from S unidirectional join T on S.k == T.k "
                           "select S.k insert into O;",
         "table handlers": "from S join T[a > 1] on S.k == T.k "
                           "select S.k insert into O;",
         "store": ""}[what]
    text = tables + q
    if what == "store":
        text = """define stream S (k string);
            @Store(type='rdbms') define table T (k string);"""
    with pytest.raises(Exception):
        J.SiddhiManager().create_siddhi_app_runtime(text)
    with pytest.raises((NotImplementedError, Exception)) as e:
        T.SiddhiManager(device="cpu").create_siddhi_app_runtime(text)
    if what == "store":
        assert e.type is NotImplementedError


def test_a_carried_table_state_steps_on_equal(monkeypatch):
    """The reference's table state after the load and a round of
    stock_table, carried into the port (carry.table_from_jax, STRING
    codes mapped through both string tables; the queries' states with
    carry.state_from_jax), then the rest of the feed through both from
    there."""
    from siddhi_tpu_torch.carry import state_from_jax, table_from_jax
    monkeypatch.delenv("SIDDHI_TPU_JOIN_KERNEL", raising=False)
    feeds = {pkg: stock_table_feed(64, 3, 256, TABLES[pkg].encode,
                                   prefix=PREFIX) for pkg in (J, T)}
    rj = MultiRun(J, STOCK_TABLE_APP, out="OutputStream")
    for stream, ts, cols in feeds[J][:3]:
        rj.send_arrays(stream, ts, cols)
    rt = MultiRun(T, STOCK_TABLE_APP, out="OutputStream")
    import jax
    jstate = jax.device_get(rj.rt.tables["StockTable"].state)

    def remap(codes):
        return np.array([TABLES[T].encode(TABLES[J].decode(int(c)))
                         for c in codes], np.int32)
    table = rt.rt.tables["StockTable"]
    table.state = table_from_jax(jstate, "cpu", (True, False, False), remap)
    for name in ("upsert", "lookup"):   # the queries' counters
        rt.rt.queries[name].restore_state(state_from_jax(
            rj.rt.queries[name].snapshot_state(), "cpu"))
    rt.rt.on_ingest_ts(int(feeds[T][2][1][-1]))
    rj.rows.clear()
    for i in range(3, len(feeds[J])):
        for pkg, r in ((J, rj), (T, rt)):
            stream, ts, cols = feeds[pkg][i]
            r.send_arrays(stream, ts, cols)
        compare_runs(rj, rt, f"carried, send {i}")
    assert rt.rows
