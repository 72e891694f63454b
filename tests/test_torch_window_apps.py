"""The comparison apps of checks.WINDOW_APPS (kernels K5 and K6, their
plain versions on the CPU) against the reference, on the CPU, first
half: the sliding windows (time, length, length(0)) and lengthBatch
grouped with min/max/and/or. Three sends of at most 128 rows of
checks.window_feed (16 symbols, equal timestamps included); after each
send the rows (timestamp, kind, values: floats by their bits, in
order), the statistics and the whole query state are equal, bit for bit
(tolerance 0). Helpers: test_torch_window.py."""
import pytest
import torch

from siddhi_tpu_torch.checks import WINDOW_APPS, time_symbols, window_feed
from test_torch_window import align_strings, run_both

torch.set_num_threads(1)

APPS = ["time, grouped, all events", "length, having", "length(0), expired",
        "lengthBatch, grouped", "time, offset and limit"]
SENDS = [(0, 100), (100, 228), (228, 340)]


@pytest.fixture(scope="module", autouse=True)
def aligned_symbols():
    align_strings(time_symbols(16, prefix="A"))


@pytest.mark.parametrize("app", APPS)
def test_window_app_equals_the_reference(app):
    rj, rt = run_both(WINDOW_APPS[app], SENDS,
                      lambda enc: window_feed(340, enc, seed=3, prefix="A"))
    assert rt.rows
