"""chip_smoke.py's cron_trades path at a small size, on the CPU, against
the reference and the numpy oracle (checks.cron_trades_oracle):

- the cron named window's report (a grouped sum over each 5 s batch)
  against the oracle, and against the reference running the same query
  over a query-level cron window (the reference never fires a cron named
  window: test_torch_cron.py);
- the trigger's rows (every 5,000 ms of event time from the arming
  point) and the ``output last every 5 sec`` rows equal to the
  reference's and the oracle's;
- no window overflow, and the named window's K5c steps (arrivals and
  firings) counted."""
import numpy as np
import pytest
import torch

import siddhi_tpu as J
import siddhi_tpu_torch as T
from siddhi_tpu_torch.checks import (CRON_TRADES_APP, cron_trades_cuts,
                                     cron_trades_feed, cron_trades_oracle,
                                     time_symbols)
from siddhi_tpu_torch.ops import windows as TW
from siddhi_tpu_torch.ops.windows2 import CronWindowOp
from test_torch_join_shapes import TABLES
from test_torch_window import align_strings

torch.set_num_threads(1)

PREFIX = "CTR"
N_SYMS = 16
N = 13_000   # 26 s of trades: five firings and a partial period

# the reference's counterpart of the report: the same grouped sum over a
# query-level cron window (it fires; a cron named window does not there)
UNNAMED = CRON_TRADES_APP.replace(
    "from StockEventWindow\n", "from StockEventStream#window.cron("
    "'*/5 * * * * ?')\n")


@pytest.fixture(scope="module", autouse=True)
def aligned_symbols():
    align_strings(time_symbols(N_SYMS, PREFIX))


def _run(pkg, text):
    kw = {"device": "cpu"} if pkg is T else {}
    rt = pkg.SiddhiManager(**kw).create_siddhi_app_runtime(text)
    out = {s: [] for s in ("ReportStream", "TickStream", "AvgStream")}
    for s, got in out.items():
        rt.add_callback(s, pkg.StreamCallback(fn=lambda evs, g=got: g.append(
            [(e.timestamp, tuple(e.data), e.is_expired) for e in evs])))
    rt.start()
    ts, cols = cron_trades_feed(N, TABLES[pkg].encode, n_syms=N_SYMS,
                                prefix=PREFIX)
    cuts = cron_trades_cuts(ts)
    h = rt.get_input_handler("StockEventStream")
    for a, b in zip(cuts[:-1], cuts[1:]):
        h.send_arrays(ts[a:b], [c[a:b] for c in cols])
    stats = {q: (e["emitted"], e["overflow"])
             for q, e in rt.statistics().items() if q in rt.queries}
    rt.shutdown()
    return rt, out, stats, (ts, cols, cuts)


@pytest.fixture(scope="module")
def runs():
    steps = []
    real = TW.window_step

    def tap(op, state, batch, now):
        if isinstance(op, CronWindowOp):
            steps.append(bool((batch.kind == 2).any()))
        return real(op, state, batch, now)
    TW.window_step = tap
    try:
        rt = _run(T, CRON_TRADES_APP)
    finally:
        TW.window_step = real
    return {"T": rt, "J": _run(J, CRON_TRADES_APP),
            "J_unnamed": _run(J, UNNAMED), "steps": steps}


def _flat(out):
    return [r for lst in out for r in lst]


def test_report_equals_the_oracle_and_the_reference_query_window(runs):
    rt, out, stats, (ts, cols, cuts) = runs["T"]
    sym, price = cols[0], cols[1]
    rep_sym, rep_sum, _ticks, _last = cron_trades_oracle(ts, sym, price,
                                                         cuts)
    got = _flat(out["ReportStream"])
    assert len(got) == len(rep_sym) > 0
    codes = np.array([TABLES[T].encode(r[1][0]) for r in got], np.int32)
    assert np.array_equal(codes, rep_sym)
    sums = np.array([r[1][1] for r in got])
    assert np.allclose(sums, rep_sum, rtol=1e-12, atol=1e-9)
    # the reference's rows of the same query over a query-level window
    assert got == _flat(runs["J_unnamed"][1]["ReportStream"])
    # the reference's named window never fires
    assert _flat(runs["J"][1]["ReportStream"]) == []


def test_ticks_and_last_rows_equal_the_reference_and_the_oracle(runs):
    rt, out, stats, (ts, cols, cuts) = runs["T"]
    _s, _p, ticks, flushes = cron_trades_oracle(ts, cols[0], cols[1], cuts)
    jout = runs["J"][1]
    assert out["TickStream"] == jout["TickStream"]
    got_ticks = [r[1] for r in _flat(out["TickStream"])]
    assert got_ticks == [(int(t), int(t) - 5000) for t in ticks]
    assert out["AvgStream"] == jout["AvgStream"]
    assert len(out["AvgStream"]) == len(flushes) > 1
    for got, (fts, fsym, fap) in zip(out["AvgStream"], flushes):
        assert [r[0] for r in got] == fts.tolist()
        assert [TABLES[T].encode(r[1][0]) for r in got] == fsym.tolist()
        assert np.allclose([r[1][1] for r in got], fap, rtol=1e-12)


def test_counters_and_k5c_steps(runs):
    _rt, _out, stats, (ts, _c, cuts) = runs["T"]
    jstats = runs["J"][2]
    for q in ("fill", "tick", "lastavg"):
        assert stats[q] == jstats[q]
    assert all(ovf == 0 for _em, ovf in stats.values())
    steps = runs["steps"]
    n_fires = len(cuts) - 2
    assert sum(steps) >= n_fires and len(steps) - sum(steps) == \
        len(cuts) - 1
