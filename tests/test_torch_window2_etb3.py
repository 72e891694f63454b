"""externalTimeBatch (kernel A; the plain version on the CPU) against the
reference, on the CPU, with replace.with.batchtime (the emitted copies
carry the batch end), as test_torch_window2_etb.py runs its other
parameters: sends of 40 rows; after every send rows, statistics and
the whole state are equal, bit for bit."""
import pytest
import torch

from siddhi_tpu_torch.checks import time_symbols
from test_torch_window import align_strings
from test_torch_window2_etb import check_app

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def aligned_symbols():
    align_strings(time_symbols(16, prefix="E3"))


@pytest.mark.parametrize("app", ["externalTimeBatch, replace batch time"])
def test_external_time_batch_app_equals_the_reference(app):
    check_app(app, "E3")
