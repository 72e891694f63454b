"""The second-wave windows on kernel K5's frame (kernel A; the plain
versions on the CPU) against the reference, on the CPU: the comparison
apps of checks.WINDOW2_APPS for externalTime, timeLength (time and length
each bind), delay, batch() and batch(7), hopping and its second name
hoping, with min/max/avg/distinctCount over them; a join side on an
externalTime window; steps from a carried reference state. The feed
(checks.window2_feed) has NaN, -0.0, infinities and the integer extremes
in its columns; the sends cross each kind's boundaries. After every
send the rows (timestamp, kind, values: floats by their bits, in
order), the statistics and the whole query state are equal, bit for bit
(tolerance 0). Helpers: test_torch_window.py, test_torch_join_shapes.py.

The externalTimeBatch apps are in test_torch_window2_etb.py, the sort
window in test_torch_window2_sort.py."""
import numpy as np
import pytest

import siddhi_tpu as J
import siddhi_tpu_torch as T
from siddhi_tpu.core.types import GLOBAL_STRINGS as JSTR
from siddhi_tpu_torch.carry import state_from_jax
from siddhi_tpu_torch.checks import (EXT_JOIN_APP, TS0, WINDOW2_APPS,
                                     time_symbols, window2_feed)
from siddhi_tpu_torch.core.types import GLOBAL_STRINGS as TSTR
from test_torch_join_shapes import MultiRun, compare_runs
from test_torch_window import Run, align_strings, assert_same_state, run_both

APPS = ["externalTime, grouped", "timeLength", "delay", "batch()",
        "batch(7)", "hopping", "hoping"]
SENDS = [(0, 100), (100, 356), (356, 600)]
JOIN_KEYS = ("X0", "X1", "X2", "X3")


@pytest.fixture(scope="module", autouse=True)
def aligned_symbols():
    align_strings(time_symbols(16, prefix="C") + list(JOIN_KEYS))


def feed(encode):
    return window2_feed(600, encode, seed=3, prefix="C")


@pytest.mark.parametrize("app", APPS)
def test_window2_app_equals_the_reference(app):
    rj, rt = run_both(WINDOW2_APPS[app], SENDS, feed)
    assert rt.rows


def test_join_side_on_external_time_equals_the_reference():
    """A join whose left side is an externalTime window: both sides'
    windows, the pairs and the lost-pair count after every send."""
    runs = [MultiRun(J, EXT_JOIN_APP), MultiRun(T, EXT_JOIN_APP)]
    rng = np.random.default_rng(9)
    for k in range(4):
        t = TS0 + 20 * k + np.arange(24, dtype=np.int64)
        lk = rng.integers(0, 4, 24)
        a = rng.integers(0, 9, 24)
        rk = rng.integers(0, 4, 24)
        b = rng.standard_normal(24)
        for r in runs:
            r.send("L", [(int(t[i]), (JOIN_KEYS[lk[i]], int(t[i]),
                                      int(a[i]))) for i in range(24)])
            r.send("R", [(int(t[i]) + 1, (JOIN_KEYS[rk[i]], int(t[i]) + 1,
                                          float(b[i]))) for i in range(24)])
        compare_runs(*runs, f"send {k}")
    assert runs[1].rows


@pytest.mark.parametrize("app", ["externalTime, grouped", "hopping"])
def test_steps_from_a_carried_reference_state(app):
    """The reference runs two sends; its snapshot (the window's buffers
    and counters, the group table, the stateful aggregators' rings and
    pair table) is carried into a fresh port runtime
    (carry.state_from_jax, STRING window columns mapped through the
    strings they stand for); the third send then gives equal rows and
    states."""
    text = WINDOW2_APPS[app]
    rj, rt = Run(J, text), Run(T, text)
    jts, jcols = feed(JSTR.encode)
    tts, tcols = feed(TSTR.encode)
    for a, b in SENDS[:2]:
        rj.h.send_arrays(jts[a:b], [c[a:b] for c in jcols])
    snap = rj.q.snapshot_state()
    strings = tuple(t.value == "string" for t in rj.q.in_schema.types)
    rt.q.restore_state(state_from_jax(
        snap, "cpu", string_cols=strings,
        remap=np.vectorize(lambda c: TSTR.encode(JSTR.decode(c)),
                           otypes=[np.int32])))
    rt.rt.on_ingest_ts(int(jts[SENDS[1][1] - 1]))
    assert_same_state(rj, rt, "carried")
    rj.rows.clear()
    a, b = SENDS[2]
    rj.h.send_arrays(jts[a:b], [c[a:b] for c in jcols])
    rt.h.send_arrays(tts[a:b], [c[a:b] for c in tcols])
    assert rt.rows == rj.rows and len(rt.rows) > 0
    assert_same_state(rj, rt, "after the carried step")
