"""The scan engine's absent shapes (checks.SCAN_APPS: an every-scoped
absent start, an AND group with an absent partner, an OR of two absent
lanes in mid chain) through kernel K4's plain version against the
reference, on the CPU (one shape a file: this file, _shapes3.py and
_shapes4.py; test_torch_scan_shapes2.py and _shapes5.py have the others).

Each app gets a seeded three-stream feed, sent as rows in runs of one
stream (at most 16 events a send), through both SiddhiManagers: rows in
order, overflow counters and the whole pending table must be equal. Then,
from the reference's live table carried over (carry.state_from_jax), one
stream step, one timer step and arm_start equal the reference engine's,
bit for bit."""
import pytest
import torch

import siddhi_tpu as J
import siddhi_tpu_torch as T
from siddhi_tpu_torch.checks import SCAN_APPS, three_stream_feed
from test_torch_pattern import TABLES
from test_torch_scan import Run, assert_runs_equal, steps_equal

torch.set_num_threads(1)

N = 320      # events sent before the compared step
STEP = 48    # events of the compared step


def send_runs(run, stream, ts, cols, lo, hi):
    """Events lo..hi as row sends, one stream a send, 16 at most."""
    k = lo
    while k < hi:
        e = k
        while e < hi and stream[e] == stream[k] and e - k < 16:
            e += 1
        run.send_rows(stream[k], [
            (int(ts[i]), (TABLES[run.pkg].decode(cols[0][i]),
                          float(cols[1][i]), int(cols[2][i])))
            for i in range(k, e)])
        k = e


SHAPES = ["every absent", "and, absent partner", "or of two absents"]


def build_shape(name):
    """Both packages after N events of the app's feed. -> (name, runs,
    each package's feed)."""
    runs = [Run(pkg, SCAN_APPS[name]) for pkg in (J, T)]
    feeds = [three_stream_feed(N + STEP, TABLES[pkg].encode, seed=3,
                               gap_ms=4) for pkg in (J, T)]
    for run, (stream, ts, cols) in zip(runs, feeds):
        send_runs(run, stream, ts, cols, 0, N)
    return name, runs, feeds


def check_runs(shape):
    name, (j, t), _feeds = shape
    assert type(j.q.engine).__name__ == type(t.q.engine).__name__ == \
        "NfaEngine", name
    assert_runs_equal(j, t)
    assert len(t.rows()) > 10, name


def check_steps(shape):
    """The next events of the first state's stream, as one step, then a
    timer step and arm_start."""
    _name, (j, t), ((stream, ts, jcols), (_s, _t, tcols)) = shape
    sid = t.q.engine.states[0].stream_id
    sel = [i for i in range(N, N + STEP) if stream[i] == sid]
    steps_equal(j, t, sid, ts[sel], [c[sel] for c in jcols],
                [c[sel] for c in tcols])


# one shape a file: the every-scoped start here, the AND and the OR
# groups in test_torch_scan_shapes3.py and _shapes4.py
@pytest.fixture(scope="module", params=SHAPES[:1])
def shape(request):
    return build_shape(request.param)


def test_shape_runs_like_the_reference(shape):
    check_runs(shape)


def test_shape_steps_from_a_live_table(shape):
    check_steps(shape)
