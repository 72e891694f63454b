"""Watermarks and reorder buffers (resilience/ordering.py) against the
reference, on the CPU: the disorder-equivalence sweep of
tests/test_ordering.py (a time window, a lengthBatch window, a pattern,
a partition, a join; disorder within and across chunks; in-order input;
the row path). Each app and feed runs through both packages: the rows,
and the reorder counters (those of the reference's host lane: the port
takes the device ring, kernel K10, wherever it is eligible, so its
``ring_steps`` counts where the reference's default lane counts none),
equal; and the port's disordered run equals its ordered run. Policies,
dedup, capacity and configuration are in test_torch_ordering_policies.py,
the ring against the reference's ring in test_torch_ordering_ring.py,
the partition and join apps of the sweep in test_torch_ordering_2.py.
Helpers for those files are here."""
import os
import sys

import numpy as np
import pytest
import torch

import siddhi_tpu as J
import siddhi_tpu_torch as T

sys.path.insert(0, os.path.dirname(__file__))
from test_ordering import (JOIN_APP, LENGTH_BATCH_APP, PARTITION_APP,  # noqa
                           PATTERN_APP, TS0, WINDOW_APP, _mk_chunks,
                           _shuffle_within)

torch.set_num_threads(1)

RING_ENV = "SIDDHI_TPU_REORDER_RING"


def counters(rt, stream="S", host_lane=True) -> dict:
    """A stream's reorder counters; ``host_lane``: without ring_steps,
    for a comparison with the reference's default (host) lane."""
    c = dict(rt._reorder[stream].counters)
    if host_lane:
        c.pop("ring_steps")
    return c


class Run:
    """One app in one package: a callback on each output stream, sends
    by stream, the app shut down (final flush) by ``close``."""

    def __init__(self, pkg, text, outs=("Out",)):
        self.pkg = pkg
        kw = {"device": "cpu"} if pkg is T else {}
        self.rt = pkg.SiddhiManager(**kw).create_siddhi_app_runtime(text)
        self.got = {o: [] for o in outs}
        for o, g in self.got.items():
            self.rt.add_callback(o, pkg.StreamCallback(
                fn=lambda evs, g=g: g.extend(
                    (e.timestamp, tuple(e.data), e.is_expired)
                    for e in evs)))
        self.rt.start()

    def cols(self, stream, ts, cols):
        self.rt.get_input_handler(stream).send_arrays(ts, cols)

    def rows(self, stream, events):
        h = self.rt.get_input_handler(stream)
        h.send([self.pkg.Event(e[0], tuple(e[1])) for e in events])

    def close(self):
        self.rt.shutdown()
        return self


def run_single(pkg, ql, seed, disorder, n=256, chunk=64, skew=48):
    """tests/test_ordering.py _run_single in one package. -> (rows, the
    host lane's counters)."""
    r = Run(pkg, ql)
    rng = np.random.default_rng(seed + 1)
    for ts, cols in _mk_chunks(seed, n, chunk):
        if disorder:
            ts, cols = _shuffle_within(ts, cols, rng, skew)
        r.cols("S", ts, cols)
    c = counters(r.rt)
    r.close()
    return r.got["Out"], c


@pytest.mark.parametrize("ql", [WINDOW_APP, LENGTH_BATCH_APP, PATTERN_APP],
                         ids=["time-window", "length-batch", "pattern"])
def test_disorder_equivalence_single_stream(ql, monkeypatch):
    monkeypatch.delenv(RING_ENV, raising=False)
    ordered, co = run_single(T, ql, seed=11, disorder=False)
    shuffled, cs = run_single(T, ql, seed=11, disorder=True)
    assert len(ordered) > 0 and shuffled == ordered
    assert (ordered, co) == run_single(J, ql, seed=11, disorder=False)
    assert (shuffled, cs) == run_single(J, ql, seed=11, disorder=True)


def _cross_chunk(pkg, shuffled):
    r = Run(pkg, WINDOW_APP)
    n, chunk = 256, 64
    ts = TS0 + np.arange(n, dtype=np.int64) * 4
    rng = np.random.default_rng(3)
    cols = [rng.integers(0, 8, n).astype(np.int32),
            rng.integers(0, 1000, n).astype(np.int32)]
    if shuffled:
        ts, cols = _shuffle_within(ts, cols, np.random.default_rng(9), 48)
    for s in range(0, n, chunk):
        r.cols("S", ts[s:s + chunk], [c[s:s + chunk] for c in cols])
    c = counters(r.rt)
    r.close()
    return r.got["Out"], c


def test_disorder_equivalence_cross_chunk_shuffle(monkeypatch):
    monkeypatch.delenv(RING_ENV, raising=False)
    ordered, shuffled = _cross_chunk(T, False), _cross_chunk(T, True)
    assert len(ordered[0]) > 0 and shuffled[0] == ordered[0]
    assert ordered == _cross_chunk(J, False)
    assert shuffled == _cross_chunk(J, True)


def test_in_order_input_bit_equal_to_unbuffered():
    plain = WINDOW_APP.replace("@app:watermark(lateness='64')",
                               "@app:playback")

    def run(pkg, ql):
        r = Run(pkg, ql)
        for ts, cols in _mk_chunks(7, 256, 64):
            r.cols("S", ts, cols)
        return r.close().got["Out"]
    got = run(T, WINDOW_APP)
    assert got == run(T, plain) == run(J, WINDOW_APP) and got


def _row_run(pkg, order):
    r = Run(pkg, LENGTH_BATCH_APP)
    events = [(TS0 + 4 * i, (i % 8, i)) for i in range(96)]
    if not order:
        events = [events[i] for i in np.argsort(
            np.arange(96) * 4 + np.random.default_rng(2).integers(
                0, 12, 96), kind="stable")]
    h = r.rt.get_input_handler("S")
    for ts, data in events:
        h.send(pkg.Event(ts, data))
    c = counters(r.rt)
    r.close()
    return r.got["Out"], c


def test_row_path_disorder_equivalence():
    ordered, shuffled = _row_run(T, True), _row_run(T, False)
    assert len(ordered[0]) > 0 and shuffled[0] == ordered[0]
    assert ordered == _row_run(J, True)
    assert shuffled == _row_run(J, False)
