"""The scan engine's OR of two absent lanes in mid chain
(checks.SCAN_APPS) through kernel K4's plain version against the
reference, on the CPU, as test_torch_scan_shapes.py does for the
every-scoped absent start: rows, overflow counters and the whole
pending table; then one stream step, one timer step and arm_start from
the reference's live table."""
import pytest
import torch

from test_torch_scan_shapes import SHAPES, build_shape, check_runs, \
    check_steps

torch.set_num_threads(1)


@pytest.fixture(scope="module", params=SHAPES[2:])
def shape(request):
    return build_shape(request.param)


def test_shape_runs_like_the_reference(shape):
    check_runs(shape)


def test_shape_steps_from_a_live_table(shape):
    check_steps(shape)
