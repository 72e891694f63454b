"""chip_smoke.py's watermark_sensors path at a small size, on the CPU:
window_time_grouped's app under ``@app:watermark(lateness='200 ms')``,
its feed delivered out of order (a seeded 0-200 ms delay an event, and
stragglers 500-1,000 ms late), four sends, then the final flush. The
port's rows and reorder counters equal the reference's; its rows equal
checks.window_time_oracle over the events that were not late, in
timestamp order; the late count equals the feed's own
(checks.watermark_late_mask); nothing is forced; every disordered send
and the final flush ran a ring step."""
import numpy as np
import pytest
import torch

import siddhi_tpu as J
import siddhi_tpu_torch as T
from siddhi_tpu_torch.checks import (time_symbols, watermark_late_mask,
                                     watermark_sensors_app,
                                     watermark_sensors_feed,
                                     window_time_oracle)
from test_torch_join_shapes import TABLES
from test_torch_ordering import RING_ENV, Run, counters
from test_torch_window import align_strings

torch.set_num_threads(1)

PREFIX = "WS"
N_SYMS = 48
N, SEND = 8192, 2048
APP = watermark_sensors_app(span="200 milliseconds", cap=256)


@pytest.fixture(scope="module", autouse=True)
def aligned_symbols():
    align_strings(time_symbols(N_SYMS, PREFIX))


def _run(pkg):
    r = Run(pkg, APP, ("OutputStream",))
    ts, cols = watermark_sensors_feed(N, TABLES[pkg].encode, n_syms=N_SYMS,
                                      prefix=PREFIX, straggle=0.004)
    for a in range(0, N, SEND):
        r.cols("StockStream", ts[a:a + SEND], [c[a:a + SEND] for c in cols])
    r.rt.flush_watermarks(final=True)
    c = counters(r.rt, "StockStream", host_lane=pkg is J)
    r.close()
    return r.got["OutputStream"], c, (ts, cols)


@pytest.fixture(scope="module")
def runs():
    import os
    os.environ.pop(RING_ENV, None)
    return _run(T), _run(J)


def test_rows_and_counters_equal_the_reference(runs):
    (got, c, _f), (want, cj, _g) = runs
    assert got == want and got
    assert {k: v for k, v in c.items() if k != "ring_steps"} == cj


def test_rows_equal_the_in_order_oracle(runs):
    got, c, (ts, cols) = runs[0]
    cuts = np.arange(0, N + 1, SEND)
    late = watermark_late_mask(ts, cuts)
    assert c["late"] == c["late_dropped"] == int(late.sum()) > 0
    assert c["forced"] == 0
    assert c["ring_steps"] == N // SEND + 1
    keep = ~late
    order = np.argsort(ts[keep], kind="stable")
    ts_k = ts[keep][order]
    sym, price, vol = (c_[keep][order] for c_ in cols)
    osym, ap, sv, n = window_time_oracle(ts_k, sym, price, vol, 200)
    assert [r[0] for r in got] == ts_k.tolist()
    assert [TABLES[T].encode(r[1][0]) for r in got] == osym.tolist()
    assert np.allclose([r[1][1] for r in got], ap, rtol=1e-12)
    assert [r[1][2] for r in got] == sv.tolist()
    assert [r[1][3] for r in got] == n.tolist()
