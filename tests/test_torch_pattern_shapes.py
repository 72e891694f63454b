"""Pattern queries of other shapes on the round-parallel NFA (kernel
K3's plain version) against the reference, on the CPU, as in
test_torch_pattern.py: a step that emits more matches than the match
batch holds, a sequence-mode chain, an armed-once two-stream chain and
single-state patterns.
Rows in order, overflow counters and the whole NFA table must be equal.
Also a pattern query whose steps are capped below the chunk size."""
import pytest
import torch

import siddhi_tpu as J
import siddhi_tpu_torch as T
from siddhi_tpu_torch.checks import (COUNT_APP, PAIR_APP, SEQ5_APP, SEQ_APP,
                                     SINGLE_APP, SINGLE_COUNT_APP, Seq5Feed,
                                     out_overflow_stages, two_stream_feed)
from siddhi_tpu_torch.core.runtime import _tree_to
from test_torch_pattern import TABLES, Run, assert_tables_equal

torch.set_num_threads(1)

def test_out_overflow_feed():
    """One step emits more than the 16,384-row match batch holds: the
    rows kept, their order and the lost count are the reference's."""
    runs = [Run(pkg, PAIR_APP) for pkg in (J, T)]
    for run in runs:
        feed = Seq5Feed(TABLES[run.pkg].encode)
        run.send_arrays("T", *feed.next(20480, stages=out_overflow_stages()))
    j, t = runs
    assert j.rows() == t.rows() and len(t.rows()) == 16384
    assert j.q.overflow_total() == t.q.overflow_total() > 0
    assert_tables_equal(j.table(), t.table(), j.string_slots())


def two_stream_case(app: str, n: int, seed: int):
    runs = [Run(pkg, app) for pkg in (J, T)]
    for run in runs:
        stream, ts, (sym, price, vol) = two_stream_feed(
            n, TABLES[run.pkg].encode, seed)
        k = 0
        while k < n:   # runs of one stream, sent as rows, in order
            e = k
            while e < n and stream[e] == stream[k]:
                e += 1
            run.send_rows(stream[k], [
                (int(ts[i]), (TABLES[run.pkg].decode(sym[i]),
                              float(price[i]), int(vol[i])))
                for i in range(k, e)])
            k = e
    j, t = runs
    assert j.rows() == t.rows()
    assert j.q.overflow_total() == t.q.overflow_total()
    assert_tables_equal(j.table(), t.table(), j.string_slots())
    return t


def test_sequence_mode_chain():
    t = two_stream_case(SEQ_APP, 100, seed=21)
    assert len(t.rows()) > 10


def test_armed_once_two_stream_chain():
    t = two_stream_case(COUNT_APP, 60, seed=5)
    assert len(t.rows()) == 1   # armed once: one match, then done


@pytest.mark.parametrize("app", [SINGLE_APP, SINGLE_COUNT_APP],
                         ids=["plain start", "counting start"])
def test_single_state_pattern(app):
    """A one-state chain: spawns that only emit (their seqs follow the
    real spawns'), or a counting start that emits at its minimum."""
    t = two_stream_case(app, 120, seed=3)
    assert len(t.rows()) > 20


CHAIN_APP = """
    @app:playback
    define stream S (sym string, stage int, v int);
    @info(name = 'head')
    from S[v >= 0] select sym, stage, v insert into T;
""" + SEQ5_APP.split("@app:playback")[1].split(
    "define stream T (sym string, stage int, v int);")[1]


@pytest.mark.parametrize("path", ["packed", "rows", "chained"])
def test_step_capacity_cap_keeps_rows_and_table(path):
    """A pattern query capped at 4,096-row steps (the junction chunks
    columnar sends to it, the row path encodes to it, a chained device
    batch is split for it) emits what the uncapped one does and keeps
    the same pending table; only `born` and `min_at`, which the
    reference derives from the step's offsets, may differ."""
    runs = []
    for cap in (None, 4096):
        rt = T.SiddhiManager(device="cpu").create_siddhi_app_runtime(
            CHAIN_APP if path == "chained" else SEQ5_APP)
        q = rt.queries["q"]
        q.max_step_capacity = cap
        got = []
        rt.add_callback("Out", T.StreamCallback(got.extend))
        rt.start()
        ts, (sym, stage, v) = Seq5Feed(TABLES[T].encode).next(4500)
        if path == "rows":
            rt.get_input_handler("T").send([
                T.Event(int(t), (TABLES[T].decode(s), int(g), int(x)))
                for t, s, g, x in zip(ts, sym, stage, v)])
        else:
            rt.get_input_handler("S" if path == "chained" else "T") \
                .send_arrays(ts, [sym, stage, v])
        runs.append(([(e.timestamp, e.data) for e in got],
                     _tree_to(q.nfa_state, "cpu")))
    (rows0, t0), (rows1, t1) = runs
    assert rows0 == rows1 and len(rows0) > 400
    for k in t0:
        if k not in ("born", "min_at", "counter", "slots"):
            assert torch.equal(t0[k], t1[k]), k
    for s0, s1 in zip(t0["slots"], t1["slots"]):
        for a, b in zip(s0["cols"] + s0["nulls"] + (s0["ts"], s0["n"]),
                        s1["cols"] + s1["nulls"] + (s1["ts"], s1["n"])):
            assert torch.equal(a, b)
