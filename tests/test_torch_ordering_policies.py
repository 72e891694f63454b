"""Watermark policies, dedup, capacity, configuration and gauges against
the reference, on the CPU (tests/test_ordering.py's cases, through both
packages): the rows, the reorder counters of the reference's host lane
(test_torch_ordering.counters) and the per-stream gauges equal;
``policy='STORE'`` raises in the port (the error store is not ported);
a reference buffer's pending events carried across
(carry.reorder_from_jax) and released by the port's final flush."""
import numpy as np
import pytest
import torch

import siddhi_tpu as J
import siddhi_tpu_torch as T
from siddhi_tpu.ops.expr import CompileError as JCompileError
from siddhi_tpu_torch.carry import reorder_from_jax
from siddhi_tpu_torch.ops.expr import CompileError
from siddhi_tpu_torch.resilience.ordering import (ReorderBuffer,
                                                  WatermarkConfig,
                                                  parse_lateness_ms)
from test_ordering import TS0, WINDOW_APP, _mk_chunks, _shuffle_within
from test_torch_ordering import RING_ENV, Run, counters

torch.set_num_threads(1)


def _policy_app(policy, extra=""):
    return f"""
        @app:watermark(lateness='16', policy='{policy}'{extra})
        define stream S (v int);
        define stream LateS (v int);
        @info(name = 'q') from S select v insert into Out;
    """


def _straggler(pkg, text, outs=("Out",)):
    r = Run(pkg, text, outs)
    ts = TS0 + np.arange(64, dtype=np.int64) * 4
    r.cols("S", ts, [np.arange(64, dtype=np.int32)])
    r.cols("S", np.array([TS0 + 2], np.int64), [np.array([-1], np.int32)])
    c = counters(r.rt)
    r.close()
    return r.got, c


@pytest.mark.parametrize("policy", ["DROP", "PROCESS"])
def test_late_policies(policy):
    got, c = _straggler(T, _policy_app(policy))
    assert (got, c) == _straggler(J, _policy_app(policy))
    assert c["late"] == 1
    if policy == "DROP":
        assert c["late_dropped"] == 1 and len(got["Out"]) == 64
    else:
        assert c["late_processed"] == 1 and len(got["Out"]) == 65


def test_stream_side_output():
    text = _policy_app("STREAM", extra=", late.stream='LateS'")
    got, c = _straggler(T, text, ("Out", "LateS"))
    assert (got, c) == _straggler(J, text, ("Out", "LateS"))
    assert c["late_streamed"] == 1
    assert got["LateS"] == [(TS0 + 2, (-1,), False)]


def test_store_policy_is_not_ported_yet():
    with pytest.raises(NotImplementedError, match="policy='STORE'"):
        T.SiddhiManager(device="cpu").create_siddhi_app_runtime(
            _policy_app("STORE"))


def _row_drop(pkg):
    r = Run(pkg, _policy_app("DROP"))
    r.rows("S", [(TS0 + 4 * i, (i,)) for i in range(32)])
    r.rows("S", [(TS0 + 1, (-1,))])
    c = counters(r.rt)
    r.close()
    return r.got, c


def test_row_path_late_drop():
    got, c = _row_drop(T)
    assert (got, c) == _row_drop(J)
    assert c["late_dropped"] == 1 and len(got["Out"]) == 32


DEDUP = """
    @app:watermark(lateness='16', dedup='true')
    define stream S (v int);
    @info(name = 'q') from S select v insert into Out;
"""


@pytest.mark.parametrize("case", ["duplicates", "equal timestamps",
                                  "rows"])
def test_dedup(case):
    def run(pkg):
        r = Run(pkg, DEDUP)
        if case == "duplicates":
            ts = TS0 + np.arange(32, dtype=np.int64) * 4
            idx = np.repeat(np.arange(32), 1 + (np.arange(32) % 4 == 0))
            r.cols("S", ts[idx], [np.arange(32, dtype=np.int32)[idx]])
        elif case == "equal timestamps":
            r.cols("S", np.array([TS0, TS0, TS0 + 4], np.int64),
                   [np.array([1, 2, 3], np.int32)])
        else:
            r.rows("S", [(TS0 + 4 * (i // 2), (i // 2 % 3,))
                         for i in range(40)])
        r.close()    # the final flush releases (and dedups) the rest
        return r.got, counters(r.rt)
    got, c = run(T)
    assert (got, c) == run(J)
    if case == "duplicates":
        assert c["duplicates"] == 8
        assert [g[1][0] for g in got["Out"]] == list(range(32))
    elif case == "equal timestamps":
        assert c["duplicates"] == 0


@pytest.mark.parametrize("lane", ["columns", "rows"])
def test_capacity_overflow_counted_never_silent(lane, monkeypatch):
    monkeypatch.delenv(RING_ENV, raising=False)
    text = """
        @app:watermark(lateness='100000', cap='32')
        define stream S (v int);
        @info(name = 'q') from S select v insert into Out;
    """

    def run(pkg):
        r = Run(pkg, text)
        ts = TS0 + np.arange(96, dtype=np.int64)
        if lane == "columns":
            r.cols("S", ts, [np.arange(96, dtype=np.int32)])
        else:
            r.rows("S", [(int(t), (i,)) for i, t in enumerate(ts)])
        buf = r.rt._reorder["S"]
        mid = (buf.depth, len(r.got["Out"]), counters(r.rt))
        r.close()
        return r.got, mid
    got, mid = run(T)
    assert (got, mid) == run(J)
    assert mid[0] == 32 and mid[2]["forced"] == 64 and mid[1] == 64
    assert len(got["Out"]) == 96


def test_equal_timestamps_preserve_buffer_order():
    text = """
        @app:watermark(lateness='8')
        define stream S (v int);
        @info(name = 'q') from S select v insert into Out;
    """

    def run(pkg):
        r = Run(pkg, text)
        r.cols("S", np.full(16, TS0, np.int64),
               [np.arange(16, dtype=np.int32)])
        return r.close().got["Out"]
    got = run(T)
    assert got == run(J)
    assert [g[1][0] for g in got] == list(range(16))


def test_watermark_lag_and_gauges():
    """The watermark is None before traffic (gauge -1); after a send,
    the greatest ts less the lateness; statistics() and the per-stream
    gauges equal the reference's."""
    runs = {pkg: Run(pkg, WINDOW_APP) for pkg in (J, T)}
    rt = runs[T].rt
    buf = rt._reorder["S"]
    assert buf.watermark is None and buf.lag_ms == 0
    assert rt.stream_gauges()[f"siddhi.{rt.name}.stream.S.watermark"] == -1
    for pkg, r in runs.items():
        r.cols("S", np.array([TS0 + 100], np.int64),
               [np.zeros(1, np.int32), np.zeros(1, np.int32)])
    assert buf.watermark == TS0 + 100 - 64 and buf.lag_ms == 64
    assert rt.global_watermark() == buf.watermark
    jrt = runs[J].rt
    jflat, jrep = jrt._collect_observability()
    mine = {k.split(".stream.", 1)[1]: v
            for k, v in rt.stream_gauges().items()}
    theirs = {k.split(".stream.", 1)[1]: v for k, v in jflat.items()
              if ".stream.S." in k and (".watermark" in k or
                                        ".reorder." in k)}
    assert mine == theirs and len(mine) == 3 + len(buf.counters)
    assert rt.statistics()["reorder"] == jrep["reorder"]
    for r in runs.values():
        r.close()


class TestWatermarkValidation:
    @pytest.mark.parametrize("text,match", [
        ("@app:watermark(lateness='10', policy='TELEPORT')", "polic"),
        ("@app:watermark(lateness='-5')", "lateness"),
        ("@app:watermark(stream='Nope', lateness='10')", "undefined stream"),
        ("@app:watermark(lateness='10', policy='STREAM')", "late.stream"),
    ])
    def test_bad_configs_rejected(self, text, match):
        app = text + """
            define stream S (v int);
            from S select v insert into Out;"""
        for pkg, err in ((J, JCompileError), (T, CompileError)):
            kw = {"device": "cpu"} if pkg is T else {}
            with pytest.raises(err, match=match):
                pkg.SiddhiManager(**kw).create_siddhi_app_runtime(app)

    def test_late_stream_schema_mismatch_rejected(self):
        app = """
            define stream Late (v string);
            @watermark(lateness='10', policy='STREAM', late.stream='Late')
            define stream S (v int);
            from S select v insert into Out;"""
        with pytest.raises(CompileError, match="schema"):
            T.SiddhiManager(device="cpu").create_siddhi_app_runtime(app)

    def test_per_stream_annotation_overrides_app_default(self):
        rt = T.SiddhiManager(device="cpu").create_siddhi_app_runtime("""
            @app:watermark(lateness='10')
            @watermark(lateness='500', policy='PROCESS')
            define stream S (v int);
            define stream T (v int);
            from S select v insert into Out;
            from T select v insert into Out2;
        """)
        assert rt._reorder["S"].conf.lateness_ms == 500
        assert rt._reorder["S"].conf.policy == "PROCESS"
        assert rt._reorder["T"].conf.lateness_ms == 10
        assert rt._playback

    def test_parse_lateness_units(self):
        assert parse_lateness_ms("200 ms") == 200
        assert parse_lateness_ms("'2 sec'") == 2000
        assert parse_lateness_ms(5) == 5
        for bad in ("-1 sec", "soon"):
            with pytest.raises(ValueError):
                parse_lateness_ms(bad)


@pytest.mark.parametrize("mixed", [False, True])
def test_sorted_fast_path(mixed, monkeypatch):
    """In-order chunks release through the sorted-run fast path
    (``sorted_fast``); a disordered chunk in the middle takes the sort
    and the run recovers after it, bit-equal to the ordered run."""
    monkeypatch.delenv(RING_ENV, raising=False)

    def run(pkg, shuffle_mid):
        r = Run(pkg, WINDOW_APP)
        rng = np.random.default_rng(3)
        for i, (ts, cols) in enumerate(_mk_chunks(9, 384, 64)):
            if shuffle_mid and i == 2:
                ts, cols = _shuffle_within(ts, cols, rng, 48)
            r.cols("S", ts, cols)
        c = counters(r.rt)
        r.close()
        return r.got["Out"], c
    got, c = run(T, mixed)
    assert (got, c) == run(J, mixed)
    assert c["sorted_fast"] > 0
    if mixed:
        ordered, co = run(T, False)
        assert got == ordered and co["sorted_fast"] > c["sorted_fast"]


def test_buffer_unit_stable_sort_and_watermark():
    """tests/test_ordering.py's unit case on the port's buffer."""
    class _App:
        _playback = True
        _reorder = {}

        def global_watermark(self):
            return None

        def on_event_time(self, t):
            pass

    class _Handler:
        app = _App()

        def __init__(self):
            self.rows = []

        def _dispatch_rows(self, events):
            self.rows.extend(events)

    buf = ReorderBuffer("S", None, WatermarkConfig(lateness_ms=10))
    h = _Handler()
    buf.handler = h
    buf.ingest_rows([T.Event(105, (1,)), T.Event(101, (2,)),
                     T.Event(103, (3,)), T.Event(120, (4,))])
    assert [e.timestamp for e in h.rows] == [101, 103, 105]
    assert buf.depth == 1
    buf.flush(final=True)
    assert [e.timestamp for e in h.rows] == [101, 103, 105, 120]


@pytest.mark.parametrize("lane", ["columns", "rows"])
def test_a_carried_buffer_is_released_by_the_final_flush(lane):
    """tests/test_ordering.py's snapshot case, across the packages: the
    reference buffer's 16 pending events (all within the lateness)
    carried into the port's buffer, which releases them, sorted, at
    shutdown; the port's own snapshot restores the same way."""
    text = """
        @app:watermark(lateness='1000')
        define stream S (v int);
        @info(name = 'q') from S select v insert into Out;
    """
    jr = Run(J, text)
    order = np.random.default_rng(1).permutation(16)
    ts = (TS0 + np.arange(16, dtype=np.int64))[order]
    if lane == "columns":
        jr.cols("S", ts, [np.arange(16, dtype=np.int32)[order]])
    else:
        jr.rows("S", [(int(t), (int(v),)) for t, v in
                      zip(ts, np.arange(16)[order])])
    snap = jr.rt._reorder["S"].snapshot_state()
    assert jr.rt._reorder["S"].depth == 16
    tr = Run(T, text)
    tr.rt._reorder["S"].restore_state(reorder_from_jax(snap))
    assert tr.rt._reorder["S"].depth == 16
    again = Run(T, text)
    again.rt._reorder["S"].restore_state(
        tr.rt._reorder["S"].snapshot_state())
    tr.close()
    again.close()
    jr.close()
    assert tr.got["Out"] == again.got["Out"] == jr.got["Out"]
    assert [g[1][0] for g in tr.got["Out"]] == list(range(16))
