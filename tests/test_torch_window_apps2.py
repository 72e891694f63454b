"""The comparison apps of checks.WINDOW_APPS against the reference, on
the CPU, second half: lengthBatch in stream-current mode and RESET-heavy
(a flush every two events), timeBatch with a start time and in
stream-current mode (timer flushes between sends); and the two overflow
feeds: a time window holding more rows than its @cap(window.size), and
more distinct keys (1,500) than the 1,024-slot group table. Rows,
statistics (overflow counts included) and states after every send are
equal, bit for bit (tolerance 0). Helpers: test_torch_window.py."""
import pytest
import torch

from siddhi_tpu_torch.checks import (KEYS_OVERFLOW_APP, WINDOW_APPS,
                                     WINDOW_OVERFLOW_APP, time_symbols,
                                     window_feed)
from test_torch_window import align_strings, run_both

torch.set_num_threads(1)

APPS = ["lengthBatch, stream current", "lengthBatch, reset heavy",
        "timeBatch, start time", "timeBatch, stream current"]
SENDS = [(0, 100), (100, 228), (228, 340)]


@pytest.fixture(scope="module", autouse=True)
def aligned_symbols():
    align_strings(time_symbols(1500, prefix="B"))


@pytest.mark.parametrize("app", APPS)
def test_window_app_equals_the_reference(app):
    rj, rt = run_both(WINDOW_APPS[app], SENDS,
                      lambda enc: window_feed(340, enc, seed=3, prefix="B"))
    assert rt.rows


def test_window_overflow_equals_the_reference():
    rj, rt = run_both(WINDOW_OVERFLOW_APP, SENDS,
                      lambda enc: window_feed(340, enc, seed=4, gap_ms=1,
                                              prefix="B"))
    assert rt.q.stats()["overflow"] > 0


def test_key_table_overflow_equals_the_reference():
    rj, rt = run_both(KEYS_OVERFLOW_APP, [(0, 1024), (1024, 2048)],
                      lambda enc: window_feed(2048, enc, seed=5,
                                              n_syms=1500, prefix="B"))
    assert rt.q.stats()["overflow"] > 0
