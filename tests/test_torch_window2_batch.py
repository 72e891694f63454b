"""The second-wave windows delay, batch() and batch(7) (kernel A; the
plain versions on the CPU) against the reference, on the CPU, as in
test_torch_window2.py (rows, statistics and whole states after every
send, bit for bit, tolerance 0); and a join whose side is an
externalTime window (both sides' windows, the pairs and the lost-pair
count after every send). Helpers: test_torch_window.py,
test_torch_join_shapes.py."""
import numpy as np
import pytest
import torch

import siddhi_tpu as J
import siddhi_tpu_torch as T
from siddhi_tpu_torch.checks import (EXT_JOIN_APP, TS0, WINDOW2_APPS,
                                     time_symbols, window2_feed)
from test_torch_join_shapes import MultiRun, compare_runs
from test_torch_window import align_strings, run_both

torch.set_num_threads(1)

APPS = ["delay", "batch()", "batch(7)"]
SENDS = [(0, 100), (100, 356), (356, 600)]
JOIN_KEYS = ("X0", "X1", "X2", "X3")


@pytest.fixture(scope="module", autouse=True)
def aligned_symbols():
    align_strings(time_symbols(16, prefix="CB") + list(JOIN_KEYS))


def feed(encode):
    return window2_feed(600, encode, seed=3, prefix="CB")


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
