"""The second-wave windows on kernel K5's frame (kernel A; the plain
versions on the CPU) against the reference, on the CPU: the comparison
apps of checks.WINDOW2_APPS for externalTime (with min/max/avg/
distinctCount, grouped) and timeLength (time and length each bind). The
feed (checks.window2_feed) has NaN, -0.0, infinities and the integer
extremes in its columns; the sends cross each kind's boundaries. After
every send the rows (timestamp, kind, values: floats by their bits, in
order), the statistics and the whole query state are equal, bit for bit
(tolerance 0). Helpers: test_torch_window.py.

The other kinds of the second wave: delay, batch() and batch(7) and a
join side on an externalTime window in test_torch_window2_batch.py,
hopping and hoping in test_torch_window2_hop.py, steps from a carried
reference state in test_torch_window2_carry.py, the externalTimeBatch
apps in test_torch_window2_etb*.py, the sort window in
test_torch_window2_sort.py."""
import pytest
import torch

from siddhi_tpu_torch.checks import WINDOW2_APPS, time_symbols, window2_feed
from test_torch_window import align_strings, run_both

torch.set_num_threads(1)

APPS = ["externalTime, grouped", "timeLength"]
SENDS = [(0, 100), (100, 356), (356, 600)]


@pytest.fixture(scope="module", autouse=True)
def aligned_symbols():
    align_strings(time_symbols(16, prefix="C"))


def feed(encode):
    return window2_feed(600, encode, seed=3, prefix="C")


@pytest.mark.parametrize("app", APPS)
def test_window2_app_equals_the_reference(app):
    rj, rt = run_both(WINDOW2_APPS[app], SENDS, feed)
    assert rt.rows
