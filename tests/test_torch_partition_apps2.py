"""The other four apps of checks.PARTITION_APPS through the reference
and the port, as test_torch_partition_apps.py holds the first four."""
import pytest
import torch

from siddhi_tpu_torch import checks as C
from test_torch_partition_apps import HALVES, aligned, check_app

torch.set_num_threads(1)

NAMES = HALVES[1]
assert sorted(HALVES[0] + HALVES[1]) == sorted(C.PARTITION_APPS)


@pytest.fixture(scope="module", autouse=True)
def symbols():
    aligned("pr")


@pytest.mark.parametrize("name", NAMES)
def test_partition_app_equals_the_reference(name):
    rows, stats = check_app(name, "pr")
    assert rows and stats["q"]["emitted"] > 0
    assert ("overflow" in name) == (stats["q"]["overflow"] > 0)
