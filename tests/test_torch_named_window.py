"""Named windows (``define window``) against the reference, on the CPU:
the same app text and feed through both packages; the rows the output
callbacks receive, every query's and every named window's whole state
after every send (window buffers with STRING columns as their strings),
and on-demand reads, equal bit for bit.

- one shared window instance fed by ``insert into`` from two queries;
- the definition's output event type (current, expired, all) filtering
  what its consumers see (the window kinds of kernels K5 and A as named
  windows, with their timers under playback, are in
  test_torch_named_window_2.py);
- consumers: a plain projection, a grouped aggregation (EXPIRED rows
  subtract, the window's fifo expiry), a join against the window (the
  window's junction with the join's default empty window);
- on-demand reads through the window's findable buffer, with ``on``,
  aggregates, group by, order and limit;
- a reference window's state carried across with
  ``carry.state_from_jax`` that then goes on;
- the reference's own cases: tests/test_store.py TestNamedWindows and
  ``test_select_from_named_window``, and the named-window app of
  tests/test_persistence.py (its feed and query, without persist);
- what the port does not run yet raises: a named window inside a
  partition (a cron named window in an app with @watermark
  policy='STORE' runs since the error store is ported, held against
  the reference); writes to a window are refused as in the
  reference."""
import numpy as np
import pytest
import torch

import siddhi_tpu as J
import siddhi_tpu_torch as T
from siddhi_tpu_torch.carry import state_from_jax
from siddhi_tpu_torch.core.types import GLOBAL_STRINGS as TSTR
from test_torch_join_shapes import TABLES, MultiRun, _flags, leaves, norm
from test_torch_window import align_strings

torch.set_num_threads(1)

SYMS = ("NWA", "NWB", "NWC")


class NamedRun(MultiRun):
    """MultiRun with the named windows' states, and on-demand reads."""

    def state(self) -> dict:
        out = super().state()
        for wid, w in sorted(self.rt.named_windows.items()):
            snap = w.snapshot_state()
            out.update(leaves(snap["states"], f"window/{wid}",
                              _flags(w.in_schema), TABLES[self.pkg]))
        return out

    def query(self, q):
        return [tuple(norm(v) for v in r) for r in self.rt.query(q)]


def compare(rj, rt, what):
    assert rj.rows == rt.rows, what
    sj, st = rj.state(), rt.state()
    assert sj.keys() == st.keys(), (what, set(sj) ^ set(st))
    for k in sj:
        assert sj[k].shape == st[k].shape and (sj[k] == st[k]).all(), \
            f"{what}: state {k} differs"


def replay(text, sends, reads=(), out="Out"):
    """``sends``: (stream, [(ts, row), ...]) in order; compared after
    each, then every on-demand read in ``reads``. -> the two runs."""
    align_strings([s for s in SYMS if s not in TSTR._to_code])
    runs = NamedRun(J, text, out), NamedRun(T, text, out)
    for i, (stream, rows) in enumerate(sends):
        for r in runs:
            r.send(stream, rows)
        compare(*runs, f"send {i} ({stream})")
    for q in reads:
        assert runs[1].query(q) == runs[0].query(q), q
    return runs


def sym_feed(n: int, seed: int, t0: int = 1_000, gap=(1, 30),
             stream: str = "S"):
    rng = np.random.default_rng(seed)
    sends, t = [], t0
    for size in n:
        rows = []
        for _ in range(size):
            t += int(rng.integers(*gap))
            rows.append((t, (SYMS[int(rng.integers(0, 3))],
                             int(rng.integers(-5, 50)))))
        sends.append((stream, rows))
    return sends


PLAYBACK = "@app:playback "


def test_shared_window_feeds_consumer():
    text = PLAYBACK + """
        define stream S (sym string, v int);
        define window W (sym string, v int) length(2) output all events;
        @info(name = 'feed') from S select sym, v insert into W;
        @info(name = 'consume') from W select sym, sum(v) as t
        insert all events into Out;
    """
    rj, rt = replay(text, [("S", [(1000 + i, ("NWA", v))])
                           for i, v in enumerate([1, 2, 4])])
    assert [r[1][1] for r in rt.rows] == [1, 3, 2, 6]


def test_two_feeders_share_instance():
    text = PLAYBACK + """
        define stream A (sym string, v int);
        define stream B (sym string, v int);
        define window W (sym string, v int) length(2) output all events;
        @info(name = 'fa') from A select sym, v insert into W;
        @info(name = 'fb') from B select sym, v insert into W;
        @info(name = 'c') from W select sym, v
        insert all events into Out;
    """
    rj, rt = replay(text, [("A", [(1000, ("NWA", 1))]),
                           ("B", [(1001, ("NWB", 2))]),
                           ("A", [(1002, ("NWA", 3))])])
    assert [r[1][1] for r in rt.rows] == [1, 2, 1, 3]


@pytest.mark.parametrize("out_type", ["current", "expired", "all"])
def test_output_event_types(out_type):
    text = PLAYBACK + f"""
        define stream S (sym string, v int);
        define window W (sym string, v int) length(3)
        output {out_type} events;
        @info(name = 'feed') from S select sym, v insert into W;
        @info(name = 'c') from W select sym, v insert all events into Out;
    """
    replay(text, sym_feed((5, 9, 2), seed=1), reads=("from W select v",))


def test_grouped_consumer_with_timers():
    """A time window's expiry by the scheduler's timers between sends and
    inside them; the grouped average subtracts the EXPIRED rows."""
    text = PLAYBACK + """
        define stream S (sym string, v int);
        define window W (sym string, v int) time(200 millisec);
        @info(name = 'feed') from S select sym, v insert into W;
        @info(name = 'agg') from W select sym, avg(v) as a, count() as n
        group by sym insert all events into Out;
    """
    replay(text, sym_feed((6, 20, 1, 40, 7), seed=2, gap=(1, 90)),
           reads=("from W select sym, v",
                  "from W select sym, sum(v) as t group by sym "
                  "order by sym"))


def test_join_against_window():
    """A join side that reads the named window is the window's junction
    with the join's default empty window (the reference's plan): the
    window's output rows trigger against Q's length window."""
    text = PLAYBACK + """
        define stream S (sym string, v int);
        define stream Q (sym string, k int);
        define window W (sym string, v int) length(4) output all events;
        @info(name = 'feed') from S select sym, v insert into W;
        @info(name = 'j') from Q#window.length(5) join W on Q.sym == W.sym
        select Q.sym as s, k, v insert all events into Out;
    """
    sends = []
    for a, b in zip(sym_feed((2, 4, 3), seed=4, t0=1_000, stream="Q"),
                    sym_feed((3, 5, 2), seed=3, t0=1_005)):
        sends += [a, b]
    rj, rt = replay(text, sends)
    assert rt.rows


@pytest.mark.parametrize("q", [
    "from W select v",
    "from W on v > 10 select sym, v",
    "from W select sym, max(v) as m, count() as c group by sym order by sym",
    "from W on sym == 'NWB' select avg(v) as a",
    "from W select sym, v order by v desc limit 2 offset 1",
])
def test_on_demand_reads(q):
    text = PLAYBACK + """
        define stream S (sym string, v int);
        define window W (sym string, v int) length(6);
        @info(name = 'f') from S select sym, v insert into W;
    """
    replay(text, sym_feed((4, 9), seed=6), reads=(q,))


def test_select_from_named_window():
    """tests/test_store.py test_select_from_named_window."""
    text = PLAYBACK + """
        define stream S (sym string, v int);
        define window W (sym string, v int) length(2);
        @info(name = 'f') from S select sym, v insert into W;
    """
    rj, rt = replay(text, [("S", [(1000 + i, ("NWA", v))])
                           for i, v in enumerate([1, 2, 3])],
                    reads=("from W select v",))
    assert sorted(rt.rt.query("from W select v")) == [(2,), (3,)]


def test_persistence_window_app():
    """tests/test_persistence.py test_named_window_contents_survive_restore
    without the snapshot: the fourth event evicts v=1."""
    text = """
        @app:playback
        define stream S (sym string, v int);
        define window W (sym string, v int) length(3);
        @info(name = 'f') from S select sym, v insert into W;
    """
    rj, rt = replay(text, [("S", [(1000 + i, ("NWA", v))])
                           for i, v in enumerate([1, 2, 3])] +
                    [("S", [(2000, ("NWA", 9))])],
                    reads=("from W select v",))
    assert sorted(rt.rt.query("from W select v")) == [(2,), (3,), (9,)]


def test_carried_window_goes_on():
    """A reference named window's state after two sends, carried into the
    port with carry.state_from_jax, then both take the rest of the feed
    (a length window: the scheduler's pending timers are not state)."""
    text = PLAYBACK + """
        define stream S (sym string, v int);
        define window W (sym string, v int) length(4);
        @info(name = 'feed') from S select sym, v insert into W;
        @info(name = 'agg') from W select sym, count() as n
        insert all events into Out;
    """
    sends = sym_feed((5, 9, 12, 3), seed=7, gap=(1, 40))
    align_strings([s for s in SYMS if s not in TSTR._to_code])
    rj, rt = NamedRun(J, text), NamedRun(T, text)
    for stream, rows in sends[:2]:
        rj.send(stream, rows)
    for name in ("feed", "agg"):
        rt.rt.queries[name].restore_state(state_from_jax(
            rj.rt.queries[name].snapshot_state(), "cpu"))
    jw, tw = (r.rt.named_windows["W"] for r in (rj, rt))
    tw.restore_state(state_from_jax(jw.snapshot_state(), "cpu",
                                    string_cols=(True, False)))
    rt.rows = list(rj.rows)
    compare(rj, rt, "carried")
    for i, (stream, rows) in enumerate(sends[2:]):
        for r in (rj, rt):
            r.send(stream, rows)
        compare(rj, rt, f"send {i + 2}")


@pytest.mark.parametrize("text, err", [
    ("@app:watermark(lateness='1 sec', policy='STORE') "
     "define stream S (a int); define window W (a int) "
     "cron('*/5 * * * * ?'); from S insert into W;", None),
    ("define stream S (a int); define window W (a int) length(2); "
     "partition with (a of S) begin from S select a insert into W; end;",
     "not ported yet"),
])
def test_unported_named_windows_raise(text, err):
    """What the port lacks says so. A cron named window in an app whose
    late events go to the error store (policy='STORE'), ported since,
    runs under playback past two firings with one late row: its error
    record equals the reference's, and its rows equal the reference's
    query over a query-level cron window (the reference never fires a
    cron named window: test_torch_cron.py, ROADMAP Queue 3)."""
    if err is None:
        read = (" @info(name = 'q') from W select a "
                "insert all events into Out;")
        query = text.split("define window")[0] + (
            "@info(name = 'q') from S#window.cron('*/5 * * * * ?') "
            "select a insert all events into Out;")
        sends = [(1000 + 700 * i, i) for i in range(8)] + [(1200, -1)] + \
            [(7000 + 900 * i, 10 + i) for i in range(8)]
        got = {k: _store_run(pkg, t, sends) for k, pkg, t in (
            ("port", T, text + read), ("ref", J, text + read),
            ("ref query", J, query))}
        assert got["port"][1] == got["ref"][1] == got["ref query"][1]
        assert got["port"][1][0][:2] == ("S", [(1200, (-1,), False)])
        assert got["port"][0] == got["ref query"][0]
        assert len(got["port"][0]) == 18 and got["ref"][0] == []
        return
    with pytest.raises(NotImplementedError, match=err):
        T.SiddhiManager(device="cpu").create_siddhi_app_runtime(text)


def _store_run(pkg, text, sends):
    """``text`` under playback, one send a row of ``sends`` into S. ->
    (Out's rows, the error store's records of the app)."""
    kw = {"device": "cpu"} if pkg is T else {}
    rt = pkg.SiddhiManager(**kw).create_siddhi_app_runtime(
        "@app:playback " + text)
    got = []
    rt.add_callback("Out", pkg.StreamCallback(fn=lambda evs: got.extend(
        (e.timestamp, tuple(e.data), e.is_expired) for e in evs)))
    rt.start()
    for ts, a in sends:
        rt.get_input_handler("S").send(pkg.Event(ts, (a,)))
    recs = [(x.origin, x.events, x.cause)
            for x in rt._error_store().peek(rt.name)]
    rt.shutdown()
    return got, recs


def test_window_writes_refused():
    text = """
        define stream S (a int);
        define window W (a int) length(2);
        from S select a insert into W;
    """
    for pkg in (J, T):
        kw = {"device": "cpu"} if pkg is T else {}
        rt = pkg.SiddhiManager(**kw).create_siddhi_app_runtime(text)
        with pytest.raises(Exception, match="not windows"):
            rt.query("delete W on a > 1")
