"""min() and max() over expiring content (kernel C; its plain version on
the CPU) over a time window, ungrouped, against the reference, on the
CPU, as test_torch_sliding_agg.py runs its other apps: rows, statistics
and whole states after every send, bit for bit."""
import pytest
import torch

from siddhi_tpu_torch.checks import time_symbols
from test_torch_sliding_agg import check_app
from test_torch_window import align_strings

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def aligned_symbols():
    align_strings(time_symbols(16, prefix="M3"))


@pytest.mark.parametrize("app", ["min/max over time, ungrouped"])
def test_stateful_aggregator_app_equals_the_reference(app):
    check_app(app, "M3")
