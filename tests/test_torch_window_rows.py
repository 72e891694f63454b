"""Windows and aggregation (kernels K5 and K6; their plain versions on
the CPU) against the reference with events sent one row at a time with
gaps between them: the scheduler fires the windows' timers (TIMER rows)
as the clock moves, in both packages alike. Rows and whole states equal,
bit for bit. Helpers: test_torch_window.py."""
import numpy as np
import pytest
import torch

import siddhi_tpu as J
import siddhi_tpu_torch as T
from siddhi_tpu_torch.checks import time_symbols
from test_torch_window import Run, align_strings, assert_same_state

torch.set_num_threads(1)

ROW_SYMS = time_symbols(3, prefix="WR")


@pytest.fixture(scope="module", autouse=True)
def aligned_symbols():
    align_strings(ROW_SYMS)


ROW_APPS = {
    "timeBatch timers": """
        @app:playback
        define stream S (sym string, price float, volume long, flag bool);
        @info(name = 'q') @cap(window.size='64')
        from S#window.timeBatch(20 milliseconds)
        select sym, sum(volume) as sv, count() as n
        group by sym
        insert all events into Out;
    """,
    "time window timers": """
        @app:playback
        define stream S (sym string, price float, volume long, flag bool);
        @info(name = 'q') @cap(window.size='64')
        from S#window.time(15 milliseconds)
        select sym, avg(price) as ap, count() as n
        insert all events into Out;
    """,
    # null values in every argument and in the group key
    "nulls": """
        @app:playback
        define stream S (sym string, price float, volume long, flag bool);
        @info(name = 'q')
        from S#window.length(6)
        select sym, sum(price) as sp, avg(volume) as av, count() as n,
               stdDev(price) as sd, maxForever(volume) as mx, or(flag) as o
        group by sym
        insert all events into Out;
    """,
}


@pytest.mark.parametrize("app", sorted(ROW_APPS))
def test_row_sends_and_timers_equal_the_reference(app):
    """Events sent one row at a time with gaps between them: the
    scheduler fires the windows' timers (TIMER rows) as the clock moves,
    in both packages alike (the "nulls" app: a fifth of the values
    null)."""
    runs = {pkg: Run(pkg, ROW_APPS[app]) for pkg in (J, T)}
    rng = np.random.default_rng(31)
    t = 1_700_000_000_000
    for k in range(60):
        t += int(rng.integers(0, 12))
        row = (ROW_SYMS[int(rng.integers(0, 3))],
               float(np.float32(rng.uniform(0, 200))),
               int(rng.integers(1, 100)), bool(k % 2))
        if app == "nulls":
            row = tuple(None if rng.random() < 0.2 else v for v in row)
        for pkg, r in runs.items():
            r.h.send(pkg.Event(t, row))
        if k % 10 == 9:
            t += 40
            for r in runs.values():
                with r.rt.barrier:
                    r.rt.on_ingest_ts(t)
    assert runs[T].rows == runs[J].rows and runs[T].rows
    if app == "nulls":
        assert any(v is None for r in runs[T].rows for v in r[2])
    assert_same_state(runs[J], runs[T], "after the row sends")
