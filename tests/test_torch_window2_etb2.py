"""externalTimeBatch (kernel A; the plain version on the CPU) against the
reference, on the CPU, with a timeout on a feed with quiet gaps (the
scheduler's TIMER rows flush the pending batch early), as
test_torch_window2_etb.py runs its other parameters: sends of 40 rows;
after every send rows, statistics and the whole state are equal, bit
for bit."""
import pytest
import torch

from siddhi_tpu_torch.checks import time_symbols
from test_torch_window import align_strings
from test_torch_window2_etb import check_app

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def aligned_symbols():
    align_strings(time_symbols(16, prefix="E2"))


@pytest.mark.parametrize("app", ["externalTimeBatch, timeout"])
def test_external_time_batch_app_equals_the_reference(app):
    check_app(app, "E2")
