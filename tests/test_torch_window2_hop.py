"""The hopping window and its second name hoping (kernel A; the plain
versions on the CPU) against the reference, on the CPU, as in
test_torch_window2.py (rows, statistics and whole states after every
send, bit for bit, tolerance 0). Helpers: test_torch_window.py."""
import pytest
import torch

from siddhi_tpu_torch.checks import WINDOW2_APPS, time_symbols, window2_feed
from test_torch_window import align_strings, run_both

torch.set_num_threads(1)

APPS = ["hopping", "hoping"]
SENDS = [(0, 100), (100, 356), (356, 600)]


@pytest.fixture(scope="module", autouse=True)
def aligned_symbols():
    align_strings(time_symbols(16, prefix="CH"))


def feed(encode):
    return window2_feed(600, encode, seed=3, prefix="CH")


@pytest.mark.parametrize("app", APPS)
def test_window2_app_equals_the_reference(app):
    rj, rt = run_both(WINDOW2_APPS[app], SENDS, feed)
    assert rt.rows
