"""bench.py's seq2 (its app and feed, checks.SEQ2_APP and seq2_chunks)
through the port on the CPU against the reference and against the
independent numpy oracle of checks.py: at 1,024-row chunks the one
start (the pattern has no `every`) finds its payment, at 8,192-row
chunks it expires first and nothing matches. The card runs the same at
the bench's 65,536-row chunks (chip_smoke.py)."""
import pytest
import torch

import siddhi_tpu as J
import siddhi_tpu_torch as T
from siddhi_tpu_torch.checks import SEQ2_APP, seq2_chunks, seq2_oracle

torch.set_num_threads(1)


def run(pkg, chunks):
    kw = {"device": "cpu"} if pkg is T else {}
    rt = pkg.SiddhiManager(**kw).create_siddhi_app_runtime(SEQ2_APP)
    rows = []
    rt.add_callback("Out", pkg.StreamCallback(
        lambda evs: rows.extend(tuple(e.data) for e in evs)))
    rt.start()
    for ts, oid, amt, pts, pid, poid in chunks:
        rt.get_input_handler("OrderS").send_arrays(ts, [oid, amt])
        rt.get_input_handler("PayS").send_arrays(pts, [pid, poid])
    return rows, rt.queries["q"].stats()


@pytest.mark.parametrize("m,seed,n_rows", [(1024, 10, 1), (8, 13, 1),
                                           (8192, 10, 0)])
def test_seq2_equals_the_reference_and_its_oracle(m, seed, n_rows):
    chunks = seq2_chunks(3, m, seed)
    got, stats = run(T, chunks)
    want, _ = run(J, chunks)
    assert got == want == seq2_oracle(chunks)
    assert len(got) == n_rows and stats["overflow"] == 0
