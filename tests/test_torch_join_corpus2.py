"""The second half of the reference corpus's join cases, replayed
through the port on the CPU under both join kernels, as
test_torch_join_corpus.py replays the first: rows equal the reference's
and the Java suite's expected rows."""
import pytest
import torch

from test_torch_join_corpus import HALVES, check_case

torch.set_num_threads(1)


@pytest.mark.parametrize("kernel", ["probe", "grid"])
@pytest.mark.parametrize("cid", HALVES[1])
def test_join_case_replays_like_the_reference(cid, kernel, monkeypatch):
    check_case(cid, kernel, monkeypatch)
