"""The sort window (kernel B; the plain version on the CPU) against the
reference, on the CPU: int, long, float and double keys, each asc and
desc, two keys each, on a feed with NaN, -NaN, +-0.0, infinities and the
integer extremes (the reference's quirks kept: a NaN key evicts buffer
slot 0; `desc` negates, so the integer minimum wraps and -0.0 flips);
after every send rows, statistics and the whole state are equal, bit for
bit. Also window_sort at a small size against its heap oracle. Helpers:
test_torch_window.py."""
import numpy as np
import pytest
import torch

from siddhi_tpu_torch.checks import (WINDOW2_APPS, WINDOW_SORT_APP,
                                     time_symbols, trades_feed,
                                     window2_feed, window_sort_oracle)
from siddhi_tpu_torch.core.types import GLOBAL_STRINGS as TSTR
from test_torch_window import align_strings, run_both

torch.set_num_threads(1)

APPS = ["sort int desc, long asc", "sort double asc, float desc",
        "sort long desc, int asc", "sort float asc, double desc"]
SENDS = [(0, 100), (100, 356), (356, 600)]


@pytest.fixture(scope="module", autouse=True)
def aligned_symbols():
    align_strings(time_symbols(16, prefix="S") + time_symbols(32, "SO"))


@pytest.mark.parametrize("app", APPS)
def test_sort_app_equals_the_reference(app):
    rj, rt = run_both(WINDOW2_APPS[app], SENDS, lambda enc: window2_feed(
        600, enc, seed=5, prefix="S"))
    assert rt.rows


def test_sort_equals_its_oracle():
    """window_sort's app at 3,000 events in sends of 1,024: CURRENT rows
    and the evicted EXPIRED rows equal the heap oracle's, in order."""
    from siddhi_tpu_torch import SiddhiManager
    ts, cols = trades_feed(3000, TSTR.encode, n_syms=32, prefix="SO")
    rt = SiddhiManager(device="cpu").create_siddhi_app_runtime(
        WINDOW_SORT_APP)
    outs = []
    rt.queries["q"].batch_callbacks.append(outs.append)
    rt.start()
    h = rt.get_input_handler("Trades")
    for a in range(0, 3000, 1024):
        h.send_arrays(ts[a:a + 1024], [c[a:a + 1024] for c in cols])
    got = [torch.cat([b.cols[i][b.valid] for b in outs]).numpy()
           for i in range(3)]
    kind = torch.cat([b.kind[b.valid] for b in outs]).numpy()
    exp, sym, price, vol = window_sort_oracle(*cols[1:])
    assert np.array_equal(kind == 1, exp) and exp.sum() == 2000
    assert np.array_equal(got[0], sym) and np.array_equal(got[2], vol)
    assert np.array_equal(got[1].view(np.int32), price.view(np.int32))
