"""Output rate limiters (core/ratelimit.py) against the reference, on
the CPU:

- the reference's cases (tests/test_ratelimit.py): first, last and all
  every N events (one grouped), first, last and all every T, snapshot
  every T; rows equal to the reference's and to its expectations;
- each limiter on a second feed with gaps past the interval, and each
  kind on a join query and a pattern query;
- a limiter's state carried from the reference (carry.ratelimit_from_jax)
  into a query that then goes on;
- a limiter inside a partition block still raises (the reference runs
  it)."""
import pytest
import torch

import siddhi_tpu as J
import siddhi_tpu_torch as T
from siddhi_tpu_torch.carry import ratelimit_from_jax

torch.set_num_threads(1)


def _run(pkg, ql, sends, out="Out"):
    kw = {"device": "cpu"} if pkg is T else {}
    rt = pkg.SiddhiManager(**kw).create_siddhi_app_runtime(ql)
    got = []
    rt.add_callback(out, pkg.StreamCallback(fn=lambda e: got.extend(
        (x.timestamp, tuple(x.data), x.is_expired) for x in e)))
    rt.start()
    for sid, ts, data in sends:
        rt.get_input_handler(sid).send(pkg.Event(ts, tuple(data)))
    rt.shutdown()
    return got


def both(ql, sends, out="Out"):
    got, want = _run(T, ql, sends, out), _run(J, ql, sends, out)
    assert got == want
    return got


SENDS = [("S", 1000 + i * 100, ("a" if i % 2 == 0 else "b", i))
         for i in range(6)]
GAPS = [("S", 1000, ("a", 1)), ("S", 1100, ("a", 2)), ("S", 2500, ("a", 3)),
        ("S", 2600, ("b", 4)), ("S", 4700, ("b", 7)), ("S", 9000, ("a", 8))]
APP = """@app:playback
    define stream S (sym string, v int);
    @info(name = 'q')
    from S select {sel} {gb}
    output {rate}
    insert into Out;"""
TIMED = [("S", 1000, ("a", 1)), ("S", 1100, ("a", 2)), ("S", 2500, ("a", 3))]

# (rate, grouped, the reference test's feed, its expected v column or
# None where it checks a prefix)
CASES = {
    "first every 3 events": ("first every 3 events", False, SENDS, [0, 3]),
    "last every 3 events": ("last every 3 events", False, SENDS, [2, 5]),
    "all every 3 events": ("all every 3 events", False, SENDS,
                           [0, 1, 2, 3, 4, 5]),
    "first every 3 events, grouped": ("first every 3 events", True, SENDS,
                                      None),
    "first every 1 sec": ("first every 1 sec", False, TIMED, [1, 3]),
    "last every 1 sec": ("last every 1 sec", False, TIMED, None),
    "all every 1 sec": ("all every 1 sec", False, TIMED, None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_reference_cases(case):
    rate, grouped, sends, want_v = CASES[case]
    ql = APP.format(sel="sym, v", gb="group by sym" if grouped else "",
                    rate=rate)
    got = both(ql, sends)
    if want_v is not None:
        assert [r[1][1] for r in got] == want_v
    if case == "first every 3 events, grouped":
        assert sorted(r[1][1] for r in got) == [0, 1]
    if case == "last every 1 sec":
        assert [r[1][1] for r in got][:1] == [2]
    if case == "all every 1 sec":
        assert [r[1][1] for r in got][:2] == [1, 2]


def test_the_reference_snapshot_case():
    ql = APP.format(sel="sym, sum(v) as t", gb="group by sym",
                    rate="snapshot every 1 sec")
    got = both(ql, [("S", 1000, ("a", 1)), ("S", 1100, ("a", 2)),
                    ("S", 2500, ("b", 7))])
    assert got[0][1] == ("a", 3)


RATES = ["first every 2 events", "last every 2 events",
         "all every 2 events", "first every 1 sec", "last every 1 sec",
         "all every 1 sec", "snapshot every 1 sec"]


@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("grouped", [False, True])
def test_each_limiter_over_gaps(rate, grouped):
    sel = "sym, sum(v) as t" if "snapshot" in rate else "sym, v"
    ql = APP.format(sel=sel, gb="group by sym" if grouped else "",
                    rate=rate)
    both(ql, GAPS)


JOIN = """@app:playback
    define stream L (sym string, v int);
    define stream R (sym string, w int);
    @info(name = 'j')
    from L#window.length(4) join R#window.length(4) on L.sym == R.sym
    select L.sym as sym, L.v as v, R.w as w
    output {rate}
    insert into Out;"""
PATTERN = """@app:playback
    define stream L (sym string, v int);
    define stream R (sym string, w int);
    @info(name = 'p')
    from every e1=L -> e2=R[sym == e1.sym]
    select e1.sym as sym, e1.v as v, e2.w as w
    output {rate}
    insert into Out;"""
TWO = [(("L", "R")[i % 2], 1000 + 250 * i, ("ab"[(i // 2) % 2], i))
       for i in range(24)]


@pytest.mark.parametrize("rate", RATES[:6])
@pytest.mark.parametrize("app", ["join", "pattern"])
def test_join_and_pattern_queries(app, rate):
    ql = (JOIN if app == "join" else PATTERN).format(rate=rate)
    assert both(ql, TWO)


def test_a_limiter_feeding_a_named_window():
    """A limited query's rows enter a named window as CURRENT events
    (the window's insert-into handler takes host rows)."""
    ql = """@app:playback
        define stream S (sym string, v int);
        define window W (sym string, v int) length(3);
        @info(name = 'q') from S select sym, v
        output last every 2 events insert into W;
        @info(name = 'r') from W select sym, sum(v) as t group by sym
        insert all events into Out;"""
    assert both(ql, GAPS)


def test_a_carried_limiter_state_goes_on():
    """The reference's last-every-3-events limiter after four rows (its
    counters and held rows) carried into the port's query; the next rows
    give the reference's output."""
    ql = APP.format(sel="sym, v", gb="group by sym",
                    rate="last every 3 events")
    rts, gots = {}, {}
    for pkg in (J, T):
        kw = {"device": "cpu"} if pkg is T else {}
        rt = pkg.SiddhiManager(**kw).create_siddhi_app_runtime(ql)
        got = gots[pkg] = []
        rt.add_callback("Out", pkg.StreamCallback(fn=lambda e, g=got: g.extend(
            (x.timestamp, tuple(x.data)) for x in e)))
        rt.start()
        rts[pkg] = rt
    feed = [("S", 1000 + 100 * i, ("ab"[i % 3 == 0], i)) for i in range(12)]
    for sid, ts, data in feed[:4]:
        rts[J].get_input_handler(sid).send(J.Event(ts, data))
    snap = rts[J].queries["q"].rate_limiter.snapshot_state()
    rts[T].queries["q"].rate_limiter.restore_state(ratelimit_from_jax(snap))
    gots[J].clear()
    for sid, ts, data in feed[4:]:
        for pkg, rt in rts.items():
            rt.get_input_handler(sid).send(pkg.Event(ts, data))
    assert gots[T] == gots[J] and gots[J]


def test_a_limiter_inside_a_partition_still_raises():
    """tests/test_ratelimit.py TestPartitionRateLimit: the reference runs
    it ([3, 11]); the port does not yet."""
    ql = """@app:playback
        define stream S (sym string, v int);
        partition with (sym of S)
        begin
          @info(name = 'q')
          from S select sym, sum(v) as t
          output last every 2 events
          insert into Out;
        end;"""
    sends = [("S", 1000, ("a", 1)), ("S", 1001, ("a", 2)),
             ("S", 1002, ("b", 5)), ("S", 1003, ("b", 6))]
    assert [r[1][1] for r in _run(J, ql, sends)] == [3, 11]
    with pytest.raises(NotImplementedError,
                       match="output rate limiting inside a partition"):
        T.SiddhiManager(device="cpu").create_siddhi_app_runtime(ql)
