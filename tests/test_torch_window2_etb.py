"""externalTimeBatch (kernel A; the plain version on the CPU) against
the reference, on the CPU, with each of its parameters: a start constant,
a start attribute (the first event's value), a timeout on a feed with
quiet gaps (the scheduler's TIMER rows flush the pending batch early)
and replace.with.batchtime. Sends of 40 rows cross the batch boundaries
and the gaps; after every send rows, statistics and the whole state are
equal, bit for bit. Also the one-second bars of window_ext_bars at a
small size against their numpy oracle. Helpers: test_torch_window.py."""
import numpy as np
import pytest
import torch

from siddhi_tpu_torch.checks import (WINDOW2_APPS, WINDOW_BARS_APP,
                                     time_symbols, trades_feed,
                                     window2_feed, window_bars_oracle)
from siddhi_tpu_torch.core.types import GLOBAL_STRINGS as TSTR
from test_torch_window import align_strings, run_both

torch.set_num_threads(1)

# the timeout and replace.with.batchtime apps run in
# test_torch_window2_etb2.py and test_torch_window2_etb3.py
APPS = ["externalTimeBatch, start constant",
        "externalTimeBatch, start attribute"]
SENDS = [(a, a + 40) for a in range(0, 600, 40)]


@pytest.fixture(scope="module", autouse=True)
def aligned_symbols():
    align_strings(time_symbols(16, prefix="E") + time_symbols(64, "EB"))


@pytest.mark.parametrize("app", APPS)
def test_external_time_batch_app_equals_the_reference(app):
    check_app(app, "E")


def check_app(app: str, prefix: str) -> None:
    rj, rt = run_both(WINDOW2_APPS[app], SENDS, lambda enc: window2_feed(
        600, enc, seed=4, prefix=prefix, quiet_every=40))
    assert rt.rows


def test_bars_equal_their_oracle():
    """window_ext_bars' two queries at 12,000 events (64 symbols) in
    sends of 4,096: the bars and the breadth equal the numpy oracle."""
    from siddhi_tpu_torch import SiddhiManager
    ts, cols = trades_feed(12000, TSTR.encode, n_syms=64, prefix="EB")
    rt = SiddhiManager(device="cpu").create_siddhi_app_runtime(
        WINDOW_BARS_APP)
    outs = {q: [] for q in ("bars", "breadth")}
    for q, o in outs.items():
        rt.queries[q].batch_callbacks.append(o.append)
    rt.start()
    h = rt.get_input_handler("Trades")
    for a in range(0, 12000, 4096):
        h.send_arrays(ts[a:a + 4096], [c[a:a + 4096] for c in cols])

    def got(q):
        n = len(rt.queries[q].out_schema.types)
        return [torch.cat([b.cols[i][b.valid] for b in outs[q]]).numpy()
                for i in range(n)]
    bars, breadth = window_bars_oracle(*cols)
    assert all(np.array_equal(g, w) for g, w in zip(got("bars"), bars))
    assert all(np.array_equal(g, w) for g, w in zip(got("breadth"),
                                                     breadth))
    assert len(bars[0]) > 0 and rt.queries["bars"].stats()["overflow"] == 0
