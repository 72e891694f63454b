"""Incremental aggregation against the reference, on the CPU (continued
from test_torch_aggregation.py, whose helpers it uses): the whole
per-duration state after every send, bit for bit, and the ``within ...
per`` rows, over

- an order-sensitive float feed: runs of [1, 1e16, -1e16] in both
  orders, NaNs of both signs with payloads, +-0.0, infinities, float64
  subnormals and FLOAT subnormals, many rows a bucket (the reference's
  scatter applies a bucket's rows in row order);
- a feed of more keys than the 4,096 slots of a duration's table (the
  rows of the keys left out counted as overflow, equal in both);
- DOUBLE, LONG and BOOL group keys (float keys hash their bits: -0.0 and
  +0.0, and NaN payloads, are different groups), nulls among them;
- the reference's own cases: tests/test_store.py
  TestIncrementalAggregation (four cases), tests/test_parser.py's
  aggregation app (``weeks`` parsed and dropped), and the aggregation
  apps of tests/test_persistence.py and tests/test_restore_fresh.py
  (their feeds and queries, without persist; the symbols carry the
  module's prefix "A2", so that both string tables give them one code
  whatever other modules interned first)."""
import struct

import numpy as np
import pytest
import torch

import siddhi_tpu as J
import siddhi_tpu_torch as T
from test_torch_aggregation import AggRun, aligned, compare_states

torch.set_num_threads(1)


def _f64(bits: int) -> float:
    return struct.unpack("<d", struct.pack("<Q", bits))[0]


SPECIALS = (1.0, 1e16, -1e16, 0.0, -0.0, float("inf"), float("-inf"),
            _f64(0x7FF8000000000011), _f64(0xFFF8000000000022),
            _f64(0x7FF8000000000123), 1e-310, -3e-320, 2.3e-308,
            -2.25e-308, 0.1, -0.3)

FLOAT_APP = """
@app:playback
define stream S (g int, d double, f float, ts long);
define aggregation A from S
select g, sum(d) as s, avg(d) as a, min(d) as mn, max(d) as mx,
       sum(f) as sf, avg(f) as af, min(f) as mf, max(f) as xf, count() as n
group by g
aggregate by ts every sec, min, hour;
"""
FLOAT_SELECT = "g, s, a, mn, mx, sf, af, mf, xf, n, AGG_TIMESTAMP"


def float_feed(seed: int = 31):
    rng = np.random.default_rng(seed)
    sends = []
    t = 0
    for n in (16, 128, 90, 1024, 5):
        rows = []
        for k in range(n):
            t += 1
            if k % 7 < 3:    # [1, 1e16, -1e16] patterns, either way round
                d = (1.0, 1e16, -1e16)[k % 7] * (1 if (k // 7) % 2 else -1)
            else:
                d = SPECIALS[int(rng.integers(0, len(SPECIALS)))]
            f = float(np.float32(rng.choice(
                [1e-40, -1e-41, 3.5, -0.0, float("nan"), 1e30])))
            vals = [int(rng.integers(0, 3)), d, f,
                    1_700_000_000_000 + int(rng.integers(0, 2_500))]
            if rng.random() < 0.1:
                vals[1] = None
            if rng.random() < 0.1:
                vals[2] = None
            rows.append((t, tuple(vals)))
        sends.append(rows)
    return sends


def replay(text, sends, stream="S", agg="A"):
    aligned(sorted({v for rows in sends for _t, r in rows for v in r
                    if isinstance(v, str)}))
    runs = AggRun(J, text, agg), AggRun(T, text, agg)
    for i, rows in enumerate(sends):
        for r in runs:
            r.send(stream, rows)
        compare_states(runs[0].ar, runs[1].ar, f"send {i}")
    return runs


def test_float_order_feed():
    rj, rt = replay(FLOAT_APP, float_feed())
    for per in ("seconds", "minutes", "hours"):
        q = f"from A within 0L per '{per}' select {FLOAT_SELECT}"
        assert rt.query(q) == rj.query(q)
        assert rt.query(q)


OVERFLOW_APP = """
@app:playback
define stream S (room int, v double, ts long);
define aggregation A from S
select room, count() as n, sum(v) as s, max(room) as mr
group by room
aggregate by ts every sec, min;
"""


def test_overflow_feed():
    """8,192 keys in one send, then more: the seconds table overflows in
    both packages by the same rows (the minutes table holds its 411
    keys)."""
    rng = np.random.default_rng(41)
    runs = AggRun(J, OVERFLOW_APP), AggRun(T, OVERFLOW_APP)
    base = 1_700_000_000_000
    for i, n in enumerate((8192, 1024, 1024)):
        ts = base + np.arange(n, dtype=np.int64) + 10_000 * i
        room = rng.integers(0, 3, n).astype(np.int32)
        v = rng.normal(size=n)
        ets = base + rng.permutation(n).astype(np.int64) * 1000 + 7 * i
        for r in runs:
            r.rt.get_input_handler("S").send_arrays(ts, [room, v, ets])
        compare_states(runs[0].ar, runs[1].ar, f"send {i}")
    ovf = runs[1].ar.state["overflow"]
    assert int(ovf[0]) > 4096 and int(ovf[1]) == 0
    for per in ("seconds", "minutes"):
        q = f"from A within 0L per '{per}' select room, n, s, mr, " \
            "AGG_TIMESTAMP"
        assert runs[1].query(q) == runs[0].query(q)


KEYS_APP = """
@app:playback
define stream S (k double, j long, b bool, c string, v long, ts long);
define aggregation A from S
select k, j, b, c, sum(v) as s, count() as n, min(v) as mn
group by k, j, b, c
aggregate by ts every sec ... year;
"""
KEY_SYMS = ("AKX", "AKY")


def test_group_key_types():
    aligned(KEY_SYMS)
    rng = np.random.default_rng(51)
    keys = (0.0, -0.0, 1.5, float("nan"), _f64(0x7FF8000000000042),
            _f64(0xFFF8000000000001), float("-inf"))
    sends = []
    t = 0
    for n in (16, 200, 60):
        rows = []
        for _ in range(n):
            t += 1
            vals = [keys[int(rng.integers(0, len(keys)))],
                    int(rng.choice([-2 ** 63, -1, 0, 2 ** 40])),
                    bool(rng.integers(0, 2)),
                    KEY_SYMS[int(rng.integers(0, 2))],
                    int(rng.integers(-100, 100)),
                    int(rng.integers(-10 ** 11, 10 ** 11))]
            for c in range(5):
                if rng.random() < 0.08:
                    vals[c] = None
            rows.append((t, tuple(vals)))
        sends.append(rows)
    rj, rt = replay(KEYS_APP, sends)
    for per in ("seconds", "days", "years"):
        q = f"from A per '{per}' select k, j, b, c, s, n, mn, AGG_TIMESTAMP"
        assert rt.query(q) == rj.query(q)


# -- the reference's own cases -----------------------------------------------

STORE_QL = """
@app:playback
define stream Trades (symbol string, price double, ts long);
define aggregation TradeAgg
from Trades
select symbol, avg(price) as ap, sum(price) as tp,
       count() as n, max(price) as mx
group by symbol
aggregate by ts every seconds, minutes, hours;
"""
STORE_ROWS = [(100 + i, r) for i, r in enumerate([
    ("A2IBM", 10.0, 1_000), ("A2IBM", 20.0, 1_500), ("A2WSO2", 5.0, 1_200),
    ("A2IBM", 40.0, 2_300)])]


@pytest.mark.parametrize("late, q, expect", [
    (None, "from TradeAgg within 0L, 10000L per 'seconds' "
     "select symbol, ap, n, AGG_TIMESTAMP",
     [("A2IBM", 15.0, 2, 1000), ("A2IBM", 40.0, 1, 2000),
      ("A2WSO2", 5.0, 1, 1000)]),
    (None, "from TradeAgg within 0L, 100000L per 'minutes' "
     "select symbol, tp, mx", [("A2IBM", 70.0, 40.0), ("A2WSO2", 5.0, 5.0)]),
    ((200, ("A2IBM", 30.0, 1_800)), "from TradeAgg within 1000L, 2000L per "
     "'seconds' select symbol, n", None),
    (None, "from TradeAgg within 2000L, 3000L per 'seconds' "
     "select symbol, n", [("A2IBM", 1)]),
], ids=["seconds_buckets", "minutes_rollup", "out_of_order", "within"])
def test_store_incremental_cases(late, q, expect):
    aligned(("A2IBM", "A2WSO2"))
    runs = AggRun(J, STORE_QL, "TradeAgg"), AggRun(T, STORE_QL, "TradeAgg")
    for r in runs:
        r.send("Trades", STORE_ROWS)
        if late is not None:
            r.send("Trades", [late])
    compare_states(runs[0].ar, runs[1].ar, q)
    got = runs[1].rt.query(q)
    assert got == runs[0].rt.query(q)
    if expect is not None:
        assert sorted(got) == expect
    else:
        assert ("A2IBM", 3) in got


def test_parser_app_durations():
    text = """
        @app:playback
        define stream S (symbol string, price float, ts long);
        define aggregation StockAgg
        from S
        select symbol, avg(price) as avgPrice, sum(price) as total
        group by symbol
        aggregate by ts every sec ... year;
    """
    runs = replay(text, [[(1, ("A2IBM", 2.5, 1_000)),
                          (2, ("A2IBM", 3.25, 1_700)),
                          (3, ("A2WSO2", 1.0, 90_000_000))]], agg="StockAgg")
    assert runs[1].ar.durations == ["seconds", "minutes", "hours", "days",
                                    "months", "years"]
    for per in runs[1].ar.durations:
        q = f"from StockAgg per '{per}' select symbol, avgPrice, total, " \
            "AGG_TIMESTAMP"
        assert runs[1].query(q) == runs[0].query(q)


BUCKETS_APP = """
@app:playback
define stream T (sym string, p double, ts long);
define aggregation Agg from T
select sym, sum(p) as tp group by sym
aggregate by ts every seconds;
"""


@pytest.mark.parametrize("sends, expect", [
    # tests/test_persistence.py test_aggregation_buckets_survive_restore,
    # without the snapshot: every send counts
    ([[(100, ("A2a", 2.0, 1000))], [(101, ("A2a", 3.0, 1500))],
      [(102, ("A2a", 10.0, 1600))]], [("A2a", 15.0)]),
    # tests/test_restore_fresh.py test_aggregation_restore_is_fresh
    ([[(100, ("A2a", 2.0, 1000)), (101, ("A2a", 3.0, 1500))],
      [(110, ("A2a", 5.0, 1600))]], [("A2a", 10.0)]),
], ids=["persistence", "restore_fresh"])
def test_persistence_apps(sends, expect):
    runs = replay(BUCKETS_APP, sends, stream="T", agg="Agg")
    q = "from Agg within 0L, 10000L per 'seconds' select sym, tp"
    assert runs[1].rt.query(q) == runs[0].rt.query(q) == expect
