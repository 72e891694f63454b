"""bench.py's kleene (its app and feed, checks.KLEENE_APP and
kleene_chunks: `every e1=A[v > 10]+, e2=B[v > e1.v] within 10 sec`, K3's
counting states) through the port on the CPU against the reference and
against the independent numpy oracle of checks.py: at 1,024-row and
8-row chunks no run is lost; at 8,192-row chunks the 4,096-row pattern
table fills, and the oracle, which models that bound, gives the same
rows and the same lost count. The card runs the same at the bench's
65,536-row chunks (chip_smoke.py)."""
import pytest
import torch

import siddhi_tpu as J
import siddhi_tpu_torch as T
from siddhi_tpu_torch.checks import KLEENE_APP, kleene_chunks, kleene_oracle

torch.set_num_threads(1)


def run(pkg, chunks):
    kw = {"device": "cpu"} if pkg is T else {}
    rt = pkg.SiddhiManager(**kw).create_siddhi_app_runtime(KLEENE_APP)
    rows = []
    rt.add_callback("Out", pkg.StreamCallback(
        lambda evs: rows.extend((e.timestamp, *e.data) for e in evs)))
    rt.start()
    for ta, a, tb, b in chunks:
        rt.get_input_handler("A").send_arrays(ta, [a])
        rt.get_input_handler("B").send_arrays(tb, [b])
    stats = rt.queries["q"].stats()
    rt.shutdown()
    return rows, stats


# the 8,192-row case, which fills the pattern table, runs in
# test_torch_kleene2.py
@pytest.mark.parametrize("m,n_chunks,seed,lost", [(1024, 2, 11, 0),
                                                  (8, 24, 5, 0)])
def test_kleene_equals_the_reference_and_its_oracle(m, n_chunks, seed,
                                                    lost):
    check_kleene(m, n_chunks, seed, lost)


def check_kleene(m, n_chunks, seed, lost) -> None:
    chunks = kleene_chunks(n_chunks, m, seed)
    got, stats = run(T, chunks)
    want, _ = run(J, chunks)
    rows, n_lost = kleene_oracle(chunks)
    assert got == want == rows and rows
    assert stats["overflow"] == n_lost and (n_lost > 0) == bool(lost)
