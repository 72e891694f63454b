"""bench.py's kleene app against the reference and checks.kleene_oracle,
as test_torch_kleene.py, at one chunk of 8,192 events a stream: most
runs find the 4,096-row pattern table full, and the overflow equals the
oracle's count of lost runs."""
import pytest
import torch

from test_torch_kleene import check_kleene

torch.set_num_threads(1)


@pytest.mark.parametrize("m,n_chunks,seed,lost", [(8192, 1, 11, 1)])
def test_kleene_equals_the_reference_and_its_oracle(m, n_chunks, seed,
                                                    lost):
    check_kleene(m, n_chunks, seed, lost)
