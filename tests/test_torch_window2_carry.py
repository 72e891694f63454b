"""Second-wave windows stepping on from a carried reference state
(kernels A, C and D; the plain versions on the CPU): externalTime with
min/max/avg/distinctCount, grouped, and hopping. Rows and whole states
are equal, bit for bit (tolerance 0). Helpers: test_torch_window.py."""
import numpy as np
import pytest
import torch

import siddhi_tpu as J
import siddhi_tpu_torch as T
from siddhi_tpu.core.types import GLOBAL_STRINGS as JSTR
from siddhi_tpu_torch.carry import state_from_jax
from siddhi_tpu_torch.checks import WINDOW2_APPS, time_symbols, window2_feed
from siddhi_tpu_torch.core.types import GLOBAL_STRINGS as TSTR
from test_torch_window import Run, align_strings, assert_same_state

torch.set_num_threads(1)

SENDS = [(0, 100), (100, 356), (356, 600)]


@pytest.fixture(scope="module", autouse=True)
def aligned_symbols():
    align_strings(time_symbols(16, prefix="CC"))


def feed(encode):
    return window2_feed(600, encode, seed=3, prefix="CC")


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
