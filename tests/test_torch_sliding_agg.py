"""The stateful aggregators (kernels C and D; their plain versions on the
CPU) against the reference, on the CPU: min() and max() over expiring
content (SlidingMinMaxAgg: per-key rings, a segment tree a step) and
distinctCount() (DistinctCountAgg: the (group, value) pair table) over
time, length, externalTime and batch windows, grouped and ungrouped,
on int, long, float and double arguments with NaN, -NaN, +-0.0,
infinities and the integer extremes; RESET-heavy batches (the ring and
pair-table overflows and nulls are in test_torch_sliding_agg2.py).
After every send the rows
(floats by their bits), the statistics (overflow counts included) and
the whole state (rings, heads, tails, pair keys, counts and carries)
are equal, bit for bit. Also window_ext_grouped at a small size against
its numpy oracle. Helpers: test_torch_window.py."""
import numpy as np
import pytest
import torch

import siddhi_tpu_torch as T
from siddhi_tpu_torch.checks import (WINDOW2_APPS, WINDOW_EXT_APP,
                                     time_symbols, trades_feed,
                                     window2_feed, window_ext_oracle)
from siddhi_tpu_torch.core.types import GLOBAL_STRINGS as TSTR
from test_torch_window import align_strings, run_both

torch.set_num_threads(1)

# "min/max over time, ungrouped" runs in test_torch_sliding_agg3.py
APPS = ["min/max over length, grouped", "distinctCount over lengthBatch"]
SENDS = [(0, 100), (100, 356), (356, 600)]


@pytest.fixture(scope="module", autouse=True)
def aligned_symbols():
    align_strings(time_symbols(16, prefix="M") + time_symbols(64, "MX"))


@pytest.mark.parametrize("app", APPS)
def test_stateful_aggregator_app_equals_the_reference(app):
    check_app(app, "M")


def check_app(app: str, prefix: str) -> None:
    rj, rt = run_both(WINDOW2_APPS[app], SENDS, lambda enc: window2_feed(
        600, enc, seed=6, prefix=prefix))
    assert rt.rows


def test_external_time_grouped_equals_its_oracle():
    """window_ext_grouped's app at 12,000 events (64 symbols) in sends of
    4,096: symbol, high, low and count exact, the average within 1e-12
    relative of the numpy oracle's."""
    ts, cols = trades_feed(12000, TSTR.encode, n_syms=64, prefix="MX")
    rt = T.SiddhiManager(device="cpu").create_siddhi_app_runtime(
        WINDOW_EXT_APP)
    outs = []
    rt.queries["q"].batch_callbacks.append(outs.append)
    rt.start()
    h = rt.get_input_handler("Trades")
    for a in range(0, 12000, 4096):
        h.send_arrays(ts[a:a + 4096], [c[a:a + 4096] for c in cols])
    got = [torch.cat([b.cols[i][b.valid] for b in outs]).numpy()
           for i in range(5)]
    sym, hi, lo, ap, n = window_ext_oracle(*cols[:3])
    assert np.array_equal(got[0], sym) and np.array_equal(got[4], n)
    assert np.array_equal(got[1].view(np.int32), hi.view(np.int32))
    assert np.array_equal(got[2].view(np.int32), lo.view(np.int32))
    assert np.all(np.abs(got[3] - ap) <= 1e-12 * np.abs(ap))
    assert rt.queries["q"].stats()["overflow"] == 0
