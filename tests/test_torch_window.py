"""Windows and aggregation (kernels K5 and K6, their plain versions on
the CPU) against the reference, on the CPU: the same app text and the
same feed go through the reference's SiddhiManager and the port's. The
rows the callbacks receive (timestamp, kind, values: floats by their
bits, in order), the statistics (emitted rows, overflow counts) and the
whole query state after every send (window buffers, group tables,
carries, counters) are equal, bit for bit (tolerance 0).

- ``window_agg`` (bench.py's app, verbatim) and the grouped sliding time
  window of ``window_time_grouped`` at small sizes (span 200 ms, a
  256-row window, 48 symbols; sends of at most 1,024 rows), also
  against their numpy oracles (``ap`` within 1e-12 relative, the rest
  exact);
- steps from a reference state carried into the port (carry.py);
- row-mode sends with the scheduler's timers between them;
- the windows that are not ported yet raise "not ported yet" with
  their names; those ported since, min/max/distinctCount over a length
  window and an order-by, deploy and equal the reference.

The comparison apps of checks.WINDOW_APPS run in
test_torch_window_apps.py and test_torch_window_apps2.py, with the
helpers of this file. STRING columns hold dictionary codes: window
buffers compare them as the strings they stand for, and each module
aligns both packages' string tables (a module fixture) before it
interns its own group-by symbols, so that codes, and the group tables'
slots, agree."""
import struct

import numpy as np
import pytest
import torch

import siddhi_tpu as J
import siddhi_tpu_torch as T
from siddhi_tpu.core.types import GLOBAL_STRINGS as JSTR
from siddhi_tpu_torch.carry import state_from_jax
from siddhi_tpu_torch.checks import (WINDOW_AGG_APP, time_symbols,
                                     window_agg_feed, window_agg_oracle,
                                     window_time_app, window_time_feed,
                                     window_time_oracle)
from siddhi_tpu_torch.core.types import GLOBAL_STRINGS as TSTR

TABLES = {J: JSTR, T: TSTR}

# The parity tests run many small tensor operations, for which torch's
# intra-op thread pool only adds contention between the suite's parallel
# workers (each worker imports every test module, so this holds for all
# of the port's tests): one thread each ran them 2.6 times faster on an
# 8-core host under six workers.
torch.set_num_threads(1)


def align_strings(names) -> None:
    """Pad both string tables to one length, then intern ``names`` in
    both in the same order: they get the same codes, so group tables
    keyed by them (hashes of codes) compare equal."""
    for table in (JSTR, TSTR):
        for s in names:
            assert s not in table._to_code, s
    while len(JSTR) < len(TSTR):
        JSTR.encode(f"__pad_j{len(JSTR)}")
    while len(TSTR) < len(JSTR):
        TSTR.encode(f"__pad_t{len(TSTR)}")
    for s in names:
        assert JSTR.encode(s) == TSTR.encode(s), s


def norm(v):
    if isinstance(v, float):
        return ("f", struct.pack("<d", v))
    return v


BUFFER_KEYS = {"ts", "seq", "cols", "nulls", "valid"}


def leaves(tree, path="", strings=(), table=None):
    """(path, array) of every state tensor, floats as their bits; in a
    window buffer the STRING columns (flags ``strings``) as the strings
    their codes stand for in ``table``."""
    if isinstance(tree, dict):
        if set(tree) == BUFFER_KEYS and table is not None:
            tree = {**tree, "cols": tuple(
                np.array([table.decode(int(c)) for c in np.asarray(col)],
                         dtype=object) if is_str else col
                for col, is_str in zip(tree["cols"], strings))}
        for k in sorted(tree):
            yield from leaves(tree[k], f"{path}/{k}", strings, table)
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{path}/{i}", strings, table)
    elif isinstance(tree, np.ndarray) and tree.dtype == object:
        yield path, tree
    else:
        a = tree.numpy() if isinstance(tree, torch.Tensor) \
            else np.asarray(tree)
        if a.dtype.kind == "f":
            a = a.view(np.int64 if a.itemsize == 8 else np.int32)
        yield path, a


class Run:
    """One app in one package: a stream callback on the output stream,
    the input handler of its one input stream."""

    def __init__(self, pkg, text, out="Out", stream="S"):
        self.pkg = pkg
        kw = {"device": "cpu"} if pkg is T else {}
        self.rt = pkg.SiddhiManager(**kw).create_siddhi_app_runtime(text)
        self.q = self.rt.queries["q"]
        self.rows = []
        self.rt.add_callback(out, pkg.StreamCallback(
            lambda evs: self.rows.extend(
                (e.timestamp, e.is_expired, tuple(norm(x) for x in e.data))
                for e in evs)))
        self.rt.start()
        self.h = self.rt.get_input_handler(stream)

    def state(self) -> dict:
        strings = tuple(t.value == "string" for t in self.q.in_schema.types)
        return dict(leaves(self.q.snapshot_state()["states"], "", strings,
                           TABLES[self.pkg]))


def assert_same_state(rj: Run, rt: Run, what: str) -> None:
    sj, st = rj.state(), rt.state()
    assert sj.keys() == st.keys(), what
    for k in sj:
        assert sj[k].shape == st[k].shape and (sj[k] == st[k]).all(), \
            f"{what}: state {k} differs"
    assert rj.q.stats() == rt.q.stats(), what


def run_both(text, sends, feed, **kw):
    """``sends`` (a list of (start, end)) of ``feed(encode)`` through both
    packages, comparing rows, statistics and states after each send.
    -> the two Runs."""
    runs = {pkg: Run(pkg, text, **kw) for pkg in (J, T)}
    data = {pkg: feed(TABLES[pkg].encode) for pkg in runs}
    for a, b in sends:
        for pkg, r in runs.items():
            ts, cols = data[pkg]
            r.h.send_arrays(ts[a:b], [c[a:b] for c in cols])
        assert runs[T].rows == runs[J].rows, f"rows after send {a}:{b}"
        assert_same_state(runs[J], runs[T], f"after send {a}:{b}")
    return runs[J], runs[T]


def _floats(rows, i):
    return np.array([struct.unpack("<d", r[2][i][1])[0] for r in rows])


# ---------------------------------------------------------------------------
# window_agg and window_time_grouped at small sizes
# ---------------------------------------------------------------------------

TIME_SYMS = time_symbols(48, prefix="W")
TIME_APP = window_time_app("200 milliseconds", 256)
AGG_SENDS = [(0, 1024), (1024, 1900), (1900, 2748)]
TIME_SENDS = [(0, 700), (700, 1724), (1724, 2748)]


def agg_feed(encode):
    return window_agg_feed(2748, encode)


def time_feed(encode):
    return window_time_feed(2748, encode, n_syms=48, prefix="W")


@pytest.fixture(scope="module", autouse=True)
def aligned_symbols():
    align_strings(TIME_SYMS)


@pytest.fixture(scope="module")
def agg_runs():
    return run_both(WINDOW_AGG_APP, AGG_SENDS, agg_feed,
                    out="OutputStream", stream="StockStream")


@pytest.fixture(scope="module")
def time_runs():
    return run_both(TIME_APP, TIME_SENDS, time_feed, out="OutputStream",
                    stream="StockStream")


def test_window_agg_equals_the_reference(agg_runs):
    rj, rt = agg_runs
    assert len(rt.rows) == 2 and rt.q.stats()["overflow"] == 0


def test_window_agg_equals_its_oracle(agg_runs):
    _rj, rt = agg_runs
    _ts, (_sym, price, vol) = agg_feed(TSTR.encode)
    ap, sv = window_agg_oracle(price, vol)
    got_ap = _floats(rt.rows, 0)
    assert np.array_equal([r[2][1] for r in rt.rows], sv)
    assert np.all(np.abs(got_ap - ap) <= 1e-12 * np.abs(ap))


def test_window_time_grouped_equals_the_reference(time_runs):
    rj, rt = time_runs
    assert len(rt.rows) == 2748 and rt.q.stats()["overflow"] == 0


def test_window_time_grouped_equals_its_oracle(time_runs):
    _rj, rt = time_runs
    ts, (sym, price, vol) = time_feed(TSTR.encode)
    o_sym, ap, sv, n = window_time_oracle(ts, sym, price, vol, span_ms=200)
    rows = rt.rows
    assert [r[0] for r in rows] == list(ts)
    assert [r[2][0] for r in rows] == [TSTR.decode(c) for c in o_sym]
    assert np.array_equal([r[2][2] for r in rows], sv)
    assert np.array_equal([r[2][3] for r in rows], n)
    got = _floats(rows, 1)
    assert np.all(np.abs(got - ap) <= 1e-12 * np.abs(ap))


@pytest.mark.parametrize("app", ["window_agg", "window_time_grouped"])
def test_steps_from_a_carried_reference_state(app):
    """The reference runs two sends; its snapshot is carried into a fresh
    port runtime (carry.state_from_jax, the STRING window columns mapped
    through the strings they stand for); the third send then gives equal
    rows and states."""
    text, sends, feed = {
        "window_agg": (WINDOW_AGG_APP, AGG_SENDS, agg_feed),
        "window_time_grouped": (TIME_APP, TIME_SENDS, time_feed),
    }[app]
    rj = Run(J, text, out="OutputStream", stream="StockStream")
    rt = Run(T, text, out="OutputStream", stream="StockStream")
    jts, jcols = feed(JSTR.encode)
    tts, tcols = feed(TSTR.encode)
    for a, b in sends[:2]:
        rj.h.send_arrays(jts[a:b], [c[a:b] for c in jcols])
    snap = rj.q.snapshot_state()
    rt.q.restore_state(state_from_jax(
        snap, "cpu", string_cols=(True, False, False),
        remap=np.vectorize(lambda c: TSTR.encode(JSTR.decode(c)),
                           otypes=[np.int32])))
    rt.rt.on_ingest_ts(int(jts[sends[1][1] - 1]))
    assert_same_state(rj, rt, "carried")
    rj.rows.clear()
    a, b = sends[2]
    rj.h.send_arrays(jts[a:b], [c[a:b] for c in jcols])
    rt.h.send_arrays(tts[a:b], [c[a:b] for c in tcols])
    assert rt.rows == rj.rows and len(rt.rows) > 0
    assert_same_state(rj, rt, "after the carried step")


UNPORTED_WINDOWS = {
    "externalTime(ts, 1 sec)": "externalTime", "timeLength(1 sec, 10)":
    "timeLength", "delay(1 sec)": "delay", "batch()": "batch",
    "sort(2, price)": "sort", "frequent(2)": "frequent",
    "lossyFrequent(0.1)": "lossyFrequent",
    "externalTimeBatch(ts, 1 sec)": "externalTimeBatch",
    "session(1 sec)": "session", "cron('*/5 * * * * ?')": "cron",
    "hopping(1 sec, 500 milliseconds)": "hopping",
    "hoping(1 sec, 500 milliseconds)": "hoping",
}


# the names of UNPORTED_WINDOWS that the port has now: each deploys and
# its sends equal the reference's
PORTED_WINDOWS = {"externalTime", "timeLength", "delay", "batch", "sort",
                  "externalTimeBatch", "hopping", "hoping", "frequent",
                  "lossyFrequent", "session", "cron"}


def _ts_price_feed(encode, gap_ms: int = 50):
    """60 events ``gap_ms`` apart (at 50 ms three seconds: the one-second
    windows expire and flush), the timestamp also as the ts attribute."""
    rng = np.random.default_rng(17)
    ts = 1_700_000_000_000 + gap_ms * np.arange(60, dtype=np.int64)
    return ts, [ts.copy(), rng.uniform(0, 200, 60).astype(np.float32)]


def _ts_price_app(from_clause: str, select: str) -> str:
    return f"""@app:playback
        define stream S (ts long, price float);
        @info(name = 'q')
        from S{from_clause} select {select} insert all events into Out;"""


@pytest.mark.parametrize("window", sorted(UNPORTED_WINDOWS))
def test_unported_window_kinds_say_so(window):
    """The kinds still to port say so; the ones ported since deploy and
    two sends equal the reference's, rows and states."""
    name = UNPORTED_WINDOWS[window]
    if name in PORTED_WINDOWS:
        # the cron window fires every 5 s: a feed 200 ms apart spans two
        # firings
        gap = 200 if name == "cron" else 50
        rj, rt = run_both(_ts_price_app(f"#window.{window}", "ts, price"),
                          [(0, 30), (30, 60)],
                          lambda enc: _ts_price_feed(enc, gap))
        assert rt.rows
        return
    text = f"""define stream S (ts long, price float);
        from S#window.{window} select price insert into Out;"""
    with pytest.raises(NotImplementedError,
                       match=f"not ported yet: window '{name}'"):
        T.SiddhiManager(device="cpu").create_siddhi_app_runtime(text)


@pytest.mark.parametrize("select,name", [
    ("distinctCount(price)", "distinctCount"),
    ("max(price)", "max"),
    ("min(price)", "min")])
def test_stateful_aggregators_say_so(select, name):
    """Ported since: over a length window each equals the reference."""
    rj, rt = run_both(_ts_price_app("#window.length(4)", f"{select} as v"),
                      [(0, 30), (30, 60)], _ts_price_feed)
    assert rt.rows


def test_order_by_says_so():
    """Ported since (kernel G): the same app deploys, and two sends equal
    the reference's rows and states."""
    rj, rt = run_both(_ts_price_app("#window.length(4)",
                                    "ts, sum(price) as v order by v"),
                      [(0, 30), (30, 60)], _ts_price_feed)
    assert rt.rows
