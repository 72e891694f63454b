"""Joins (kernel K7, its plain versions on the CPU) against the reference
on part 2 of the comparison apps of checks.JOIN_APPS, under both join
kernels, as test_torch_join_shapes.py runs part 1 (rows, statistics, the
lost-pair count and both sides' window states after every send, bit for
bit)."""
import pytest
import torch

from test_torch_join_shapes import (PARTS, align_shape_keys,
                                    check_join_app)

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _strings():
    align_shape_keys()


@pytest.mark.parametrize("kernel", ["probe", "grid"])
@pytest.mark.parametrize("app", PARTS[1])
def test_join_app_equals_the_reference(app, kernel, monkeypatch):
    check_join_app(app, kernel, monkeypatch)
