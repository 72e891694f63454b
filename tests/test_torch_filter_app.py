"""The slice end to end: the same app text and the same feed go through
the reference's SiddhiManager and the port's (on the CPU); the rows the
callbacks receive (timestamp, kind, values, nulls) and the stats()
counters are equal, bit for bit. Also the state carry-over from a
reference process into the port."""
import struct
import subprocess
import sys
import pathlib

import numpy as np
import pytest
import torch

import siddhi_tpu as J
import siddhi_tpu_torch as T
from siddhi_tpu.core.types import GLOBAL_STRINGS as JSTR
from siddhi_tpu_torch.carry import state_from_jax, strings_from_jax
from siddhi_tpu_torch.checks import FILTER_APP, filter_feed
from siddhi_tpu_torch.core.types import GLOBAL_STRINGS as TSTR

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent


def norm(v):
    """A row value compared bit for bit (floats by their bits)."""
    if isinstance(v, float):
        return ("f", struct.pack("<d", v))
    return v


class Run:
    """One app in one package, with a stream callback on every output
    stream and a query callback on every query."""

    def __init__(self, pkg, text, outs):
        kw = {"device": "cpu"} if pkg is T else {}
        self.rt = pkg.SiddhiManager(**kw).create_siddhi_app_runtime(text)
        self.rows = {o: [] for o in outs}
        self.qrows = {q: [] for q in self.rt.queries}
        for o in outs:
            self.rt.add_callback(o, pkg.StreamCallback(self.rows[o].extend))
        for q in self.rt.queries:
            self.rt.add_callback(q, pkg.QueryCallback(
                lambda ts, i, r, q=q: self.qrows[q].append(
                    (ts, [(e.timestamp, e.is_expired, e.data) for e in i or []],
                     [(e.timestamp, e.is_expired, e.data)
                      for e in r or []]))))
        self.rt.start()

    def stream_rows(self, out):
        return [(e.timestamp, e.is_expired, tuple(norm(v) for v in e.data))
                for e in self.rows[out]]

    def query_rows(self, q):
        return [(ts, [(t, k, tuple(norm(v) for v in d)) for t, k, d in i],
                 [(t, k, tuple(norm(v) for v in d)) for t, k, d in r])
                for ts, i, r in self.qrows[q]]

    def stats(self):
        return {q: self.rt.queries[q].stats() for q in self.rt.queries}


def assert_same(j: Run, t: Run, outs):
    for o in outs:
        assert j.stream_rows(o) == t.stream_rows(o), o
    for q in j.rt.queries:
        assert j.query_rows(q) == t.query_rows(q), q
    assert j.stats() == t.stats()


def codes(table, names):
    return np.array([table.encode(s) for s in names], np.int32)


def test_filter_app_one_bucket():
    """FILTER_APP over one 65,536-row send (one full bucket)."""
    j, t = Run(J, FILTER_APP, ["OutputStream"]), Run(T, FILTER_APP,
                                                      ["OutputStream"])
    jts, jcols = filter_feed(65536, JSTR.encode)
    tts, tcols = filter_feed(65536, TSTR.encode)
    j.rt.get_input_handler("StockStream").send_arrays(jts, jcols)
    t.rt.get_input_handler("StockStream").send_arrays(tts, tcols)
    assert_same(j, t, ["OutputStream"])
    assert t.stats()["q"]["emitted"] == int((tcols[1] > 100).sum()) > 30000


MATH_APP = """
@app:playback
define stream S (sym string, price float, volume long, qty int, ok bool,
                 w double);
@info(name = 'm')
from S[volume % 7 != 3 and not (price < 20.0)]
select sym, price * 2 as p2, volume / qty as r, qty % 5 as md,
       w / 3.0 as w3, price + w as pw, ok or qty > 500 as flag,
       volume - 2147483648L * qty as big, price % 2.0f as pm
insert into Out;
"""


def math_feed(n, table, seed):
    rng = np.random.default_rng(seed)
    ts = 1_000 + np.cumsum(rng.integers(0, 3, n)).astype(np.int64)
    sym = codes(table, ["A", "B", "C"])[rng.integers(0, 3, n)]
    price = (rng.standard_normal(n) * 80 + 50).astype(np.float32)
    price[::97] = np.float32(np.nan)
    price[::89] = np.float32(-0.0)
    vol = rng.integers(-10**12, 10**12, n)
    vol[::13] = -(2 ** 63)
    qty = rng.integers(-3, 1000, n).astype(np.int32)
    qty[::11] = 0
    qty[::17] = -1
    ok = rng.integers(0, 2, n).astype(np.bool_)
    w = rng.standard_normal(n) * 1e6
    w[::31] = np.inf
    return ts, [sym, price, vol, qty, ok, w]


@pytest.mark.parametrize("sends", [[4096], [1000, 3000, 17]])
def test_math_projection_app(sends):
    j, t = Run(J, MATH_APP, ["Out"]), Run(T, MATH_APP, ["Out"])
    n = sum(sends)
    jts, jc = math_feed(n, JSTR, 5)
    tts, tc = math_feed(n, TSTR, 5)
    s = 0
    for k in sends:
        j.rt.get_input_handler("S").send_arrays(jts[s:s + k],
                                                [c[s:s + k] for c in jc])
        t.rt.get_input_handler("S").send_arrays(tts[s:s + k],
                                                [c[s:s + k] for c in tc])
        s += k
    assert_same(j, t, ["Out"])
    assert t.stats()["m"]["emitted"] > 0


CHAIN_APP = """
@app:playback
define stream S (sym string, price float, volume long);
@info(name = 'a')
from S[price > 50.0]
select sym, price, volume
insert into Mid;
@info(name = 'b')
from Mid[volume < 500]
select sym, price * 1.5f as p, volume * 2 as v2
insert into Out;
"""


@pytest.mark.parametrize("outs", [["Out"], ["Mid", "Out"]])
def test_insert_into_chain(outs):
    """Two filter queries chained by insert-into: device batches hop
    from one to the other (and host rows, once Mid has a callback)."""
    j, t = Run(J, CHAIN_APP, outs), Run(T, CHAIN_APP, outs)
    jts, jc = filter_feed(8192, JSTR.encode, seed=3)
    tts, tc = filter_feed(8192, TSTR.encode, seed=3)
    for s in range(0, 8192, 3000):
        j.rt.get_input_handler("S").send_arrays(
            jts[s:s + 3000], [c[s:s + 3000] for c in jc])
        t.rt.get_input_handler("S").send_arrays(
            tts[s:s + 3000], [c[s:s + 3000] for c in tc])
    assert_same(j, t, outs)
    assert t.stats()["b"]["emitted"] > 0


NULL_APP = """
@app:playback
define stream S (sym string, price float, volume long, qty int);
@info(name = 'n')
from S[price is null or price > 10.0 or sym == 'X']
select sym, price + 1.0f as p1, volume * qty as vq, qty / 2 as h,
       price is null as pn, sym is null as sn
insert into Out;
"""


def test_row_path_with_nulls():
    """InputHandler.send with Event rows holding None values."""
    rng = np.random.default_rng(8)
    rows = []
    for k in range(300):
        sym = [None, "X", "Y", "Z"][int(rng.integers(0, 4))]
        price = None if rng.random() < 0.2 else float(
            np.float32(rng.standard_normal() * 20))
        vol = None if rng.random() < 0.2 else int(rng.integers(-50, 50))
        qty = None if rng.random() < 0.2 else int(rng.integers(-5, 5))
        rows.append((2_000 + k // 3, (sym, price, vol, qty)))
    j, t = Run(J, NULL_APP, ["Out"]), Run(T, NULL_APP, ["Out"])
    for k in range(0, len(rows), 7):
        chunk = rows[k:k + 7]
        j.rt.get_input_handler("S").send([J.Event(ts, d) for ts, d in chunk])
        t.rt.get_input_handler("S").send([T.Event(ts, d) for ts, d in chunk])
    j.rt.get_input_handler("S").send(("X", None, 3, None))
    t.rt.get_input_handler("S").send(("X", None, 3, None))
    assert_same(j, t, ["Out"])
    assert any(v is None for e in t.rows["Out"] for v in e.data)


def test_state_carried_over_from_reference():
    """A reference runtime's snapshot restored into the port gives the
    same emitted counter, and both go on counting alike."""
    j = Run(J, FILTER_APP, ["OutputStream"])
    jts, jc = filter_feed(20000, JSTR.encode, seed=4)
    tts, tc = filter_feed(20000, TSTR.encode, seed=4)
    j.rt.get_input_handler("StockStream").send_arrays(jts[:12000],
                                                      [c[:12000] for c in jc])
    snap = j.rt.queries["q"].snapshot_state()
    t = Run(T, FILTER_APP, ["OutputStream"])
    t.rt.queries["q"].restore_state(state_from_jax(snap, "cpu"))
    assert t.stats() == j.stats()
    j.rt.get_input_handler("StockStream").send_arrays(jts[12000:],
                                                      [c[12000:] for c in jc])
    t.rt.get_input_handler("StockStream").send_arrays(tts[12000:],
                                                      [c[12000:] for c in tc])
    assert t.stats() == j.stats()
    assert j.stream_rows("OutputStream")[-len(t.rows["OutputStream"]):] == \
        t.stream_rows("OutputStream")


CARRY_STRINGS = r"""
import numpy as np
import siddhi_tpu as J
import siddhi_tpu_torch as T
from siddhi_tpu.core.types import GLOBAL_STRINGS as JSTR
from siddhi_tpu_torch.carry import state_from_jax, strings_from_jax
from siddhi_tpu_torch.core.types import GLOBAL_STRINGS as TSTR

APP = '''@app:playback
define stream S (sym string, v int);
@info(name = 'q') from S[sym == 'WSO2'] select sym, v insert into O;'''
for s in ("IBM", "GOOG", "WSO2", "MSFT"):   # reference's order of sight
    JSTR.encode(s)
jrt = J.SiddhiManager().create_siddhi_app_runtime(APP)
jrt.start()
codes = np.array([JSTR.encode(s) for s in ("WSO2", "IBM", "WSO2")], np.int32)
jrt.get_input_handler("S").send_arrays(np.arange(3, dtype=np.int64),
                                       [codes, np.arange(3, dtype=np.int32)])
strings_from_jax(list(JSTR._to_str))
trt = T.SiddhiManager(device="cpu").create_siddhi_app_runtime(APP)
trt.queries["q"].restore_state(state_from_jax(
    jrt.queries["q"].snapshot_state(), "cpu"))
trt.start()
got = []
trt.add_callback("O", T.StreamCallback(got.extend))
# the reference's codes, sent as they are, now mean the same strings
trt.get_input_handler("S").send_arrays(np.arange(3, 6, dtype=np.int64),
                                       [codes, np.arange(3, dtype=np.int32)])
assert [e.data for e in got] == [("WSO2", 0), ("WSO2", 2)], got
assert trt.queries["q"].stats()["emitted"] == 4
assert TSTR.encode("MSFT") == JSTR.encode("MSFT")
try:
    strings_from_jax([None, "other"])
except ValueError:
    print("OK")
"""


def test_strings_carried_over_from_reference():
    r = subprocess.run([sys.executable, "-c", CARRY_STRINGS], cwd=ROOT,
                       capture_output=True, text=True, timeout=120,
                       env={**__import__("os").environ,
                            "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().endswith("OK")


@pytest.mark.parametrize("text", [
    "define stream S (a int); from S#window.sort(2, a) select a "
    "insert into O;",
    "define stream S (a int); from S select distinctCount(a) as s "
    "insert into O;",
    "define stream S (a int); @Store(type='rdbms') define table T (a int);"
    " from S insert into T;",
    "define stream S (a int); from S select a order by a insert into O;",
    "define stream S (a int); from S select coalesce(a, 1) as b insert into O;",
    "@app:statistics('true') define stream S (a int);"
    " from S select a insert into O;",
    "define stream S (a int); partition with (a of S) begin from S"
    " select a output last every 2 events insert into O; end;",
    "define stream S (a int); define window W (a int) length(5);"
    " from S insert into W;",
    "@app:watermark(lateness='1 sec', policy='STORE')"
    " define stream S (a int); from S select a insert into O;",
    "define stream S (a int); @Store(type='rdbms') @Cache(size='16')"
    " define table T (a int); from S insert into T;",
])
def test_unported_parts_raise(text):
    """What the port lacks says so; the sort window, distinctCount,
    order-by, function calls and named windows, ported since, deploy and
    give the reference's rows (a named window's on its own junction)."""
    if "sort(2, a)" in text or "distinctCount" in text or "order by" in text \
            or "coalesce" in text or "define window" in text:
        rows = {}
        for pkg in (J, T):
            kw = {"device": "cpu"} if pkg is T else {}
            rt = pkg.SiddhiManager(**kw).create_siddhi_app_runtime(text)
            got = rows[pkg] = []
            rt.add_callback("W" if "define window" in text else "O",
                            pkg.StreamCallback(
                lambda evs, got=got: got.extend(
                    (e.timestamp, tuple(e.data)) for e in evs)))
            rt.start()
            rt.get_input_handler("S").send_arrays(
                1_700_000_000_000 + np.arange(5, dtype=np.int64),
                [np.array([3, 1, 3, 2, 0], np.int32)])
        assert rows[T] == rows[J] and rows[T]
        return
    with pytest.raises(NotImplementedError, match="not ported yet"):
        T.SiddhiManager(device="cpu").create_siddhi_app_runtime(text)


def test_validate_and_shutdown():
    mgr = T.SiddhiManager(device="cpu")
    mgr.validate_siddhi_app(FILTER_APP)
    assert not mgr.app_runtimes
    mgr.validate_siddhi_app(
        "define stream S (a int); from S#window.cron('*/5 * * * * ?') "
        "select a insert into O;")
    assert not mgr.app_runtimes
    with pytest.raises(NotImplementedError,
                       match="not ported yet: @watermark policy='STORE'"):
        mgr.validate_siddhi_app(
            "@app:watermark(lateness='1 sec', policy='STORE') "
            "define stream S (a int); from S select a insert into O;")
    rt = mgr.create_siddhi_app_runtime(FILTER_APP)
    rt.start()
    mgr.shutdown()
    assert not rt.running and not mgr.app_runtimes
    with pytest.raises(RuntimeError, match="not running"):
        rt.get_input_handler("StockStream").send(("IBM", 1.0, 1))
