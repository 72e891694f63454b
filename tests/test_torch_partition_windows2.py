"""externalTimeBatch (kernel A[K], with a timeout), the sort window
(B[K]), frequent and lossyFrequent (E[K]) inside a partition block
against the reference's partition runtime, on the CPU: rows, stats and
whole block states after every send and after the clock's advance,
tolerance 0 (test_torch_partition_windows.py has the feed, the apps and
the comparison)."""
import pytest
import torch

from test_torch_partition_windows import APPS, check_app, names
from test_torch_window import align_strings

torch.set_num_threads(1)

PREFIX = "wb"
KINDS = ("externalTimeBatch", "sort", "frequent", "lossyFrequent")


@pytest.fixture(scope="module", autouse=True)
def symbols():
    align_strings(names(PREFIX))


@pytest.mark.parametrize("kind", KINDS)
def test_window_kinds_in_a_block_equal_the_reference(kind):
    check_app(APPS[kind], PREFIX)
