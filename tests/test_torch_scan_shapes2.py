"""The scan engine's other shapes (checks.SCAN_APPS: an OR group and a
self-referring counting state here; a sequence with stabilize kills
and a `within` expiry that re-arms in test_torch_scan_shapes5.py)
through kernel K4's plain version against the reference, on the CPU,
as test_torch_scan_shapes.py does for the absent shapes."""
import pytest
import torch

from siddhi_tpu_torch.checks import SCAN_APPS
from test_torch_scan_shapes import SHAPES, build_shape, check_runs, \
    check_steps

torch.set_num_threads(1)

OTHERS = sorted(set(SCAN_APPS) - set(SHAPES))


# two shapes a file: the last two in test_torch_scan_shapes5.py
@pytest.fixture(scope="module", params=OTHERS[:2])
def shape(request):
    return build_shape(request.param)


def test_shape_runs_like_the_reference(shape):
    check_runs(shape)


def test_shape_steps_from_a_live_table(shape):
    check_steps(shape)
