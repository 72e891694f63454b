"""The rest of the scan engine's known failures
(ref_corpus/known_failures.txt, where the reference differs from Java),
replayed through the port on the CPU as test_torch_scan_corpus.py
replays the others: the port's rows and counts equal the reference's."""
import pytest
import torch

from test_torch_scan_corpus import KNOWN_PARTS, check_known

torch.set_num_threads(1)


@pytest.mark.parametrize("cid", KNOWN_PARTS[1])
def test_known_failure_replays_like_the_reference(cid):
    """Where the reference differs from Java, the port equals the
    reference."""
    check_known(cid)
