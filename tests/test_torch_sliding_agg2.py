"""The stateful aggregators (kernels C and D; their plain versions on the
CPU) against the reference, on the CPU, second half: a key with more live
rows than its 256-value ring; more (group, value) pairs than the
4,096-slot pair table (pair slots are never freed); nulls in row sends.
After every send rows, statistics (overflow counts included) and the
whole state are equal, bit for bit. Helpers: test_torch_window.py."""
import numpy as np
import pytest
import torch

import siddhi_tpu as J
import siddhi_tpu_torch as T
from siddhi_tpu_torch.checks import (PAIRS_OVERFLOW_APP, RING_OVERFLOW_APP,
                                     WINDOW2_APPS, time_symbols,
                                     window2_feed)
from siddhi_tpu_torch.core.types import GLOBAL_STRINGS as TSTR
from test_torch_window import Run, align_strings, assert_same_state, run_both

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def aligned_symbols():
    align_strings(time_symbols(16, prefix="N"))


def test_ring_overflow_equals_the_reference():
    """Two keys, a length(1200) window: about 600 live rows a key against
    its ring of 256; the dropped extremes are counted alike."""
    rj, rt = run_both(RING_OVERFLOW_APP, [(0, 800), (800, 1600),
                                          (1600, 2400)],
                      lambda enc: window2_feed(2400, enc, seed=6, n_syms=2,
                                               prefix="N"))
    assert rt.q.stats()["overflow"] > 0


def test_pair_table_overflow_equals_the_reference():
    """16 groups times up to 1,000 volumes: more pairs over the app's life
    than the 4,096 pair slots (which are never freed); the rest are
    counted alike."""
    rj, rt = run_both(PAIRS_OVERFLOW_APP, [(0, 2000), (2000, 4000),
                                           (4000, 6000)],
                      lambda enc: window2_feed(6000, enc, seed=7,
                                               prefix="N"))
    assert rt.q.stats()["overflow"] > 0


def test_nulls_in_row_sends_equal_the_reference():
    """Rows sent one at a time, a fifth of the values null: nulls are
    neither an extreme nor a distinct value."""
    text = WINDOW2_APPS["min/max over length, grouped"]
    runs = {pkg: Run(pkg, text) for pkg in (J, T)}
    ts, cols = window2_feed(120, TSTR.encode, seed=8, prefix="N",
                            specials=False)
    rng = np.random.default_rng(8)
    for i in range(120):
        row = [TSTR.decode(int(cols[0][i]))] + [c[i].item()
                                                for c in cols[1:]]
        row = [None if k > 0 and rng.random() < 0.2 else v
               for k, v in enumerate(row)]
        for pkg, r in runs.items():
            r.h.send(pkg.Event(int(ts[i]), list(row)))
    assert runs[T].rows == runs[J].rows and runs[T].rows
    assert any(v is None for r in runs[T].rows for v in r[2])
    assert_same_state(runs[J], runs[T], "after the row sends")
