"""The frequent and lossyFrequent windows (kernel E; its plain version on
the CPU) against the reference, on the CPU.

- The reference's own cases (tests/test_windows2.py: frequent's single
  slot and its dropped row, lossyFrequent passing a frequent key): the
  same rows from both packages, and the rows those tests expect.
- The comparison apps of checks.KEYED_APPS for the two windows: frequent
  at N = 1 (no key attributes: every attribute keys), 2 and 64 (keyed by
  two attributes), with expired events only; lossyFrequent at (0.1,
  0.01) and at (0.05, 0.005) past its 32 slots (insert overflow counted).
  The feed (checks.window2_feed) has NaN, -0.0, infinities and the
  integer extremes in its columns. After every send the rows (floats by
  their bits, in order), the statistics and the whole state are equal,
  bit for bit (tolerance 0).
- The fraud app of chip_smoke.py (frequent(2, cardNo) and (64, cardNo)
  over the purchases of 30 or more; lossyFrequent(0.1, 0.01)) at a small
  size: equal to the reference and to checks.freq_oracle; the sends fill
  the table, and frequent(2) drops rows.
Helpers: test_torch_window.py."""
import numpy as np
import pytest
import torch

import siddhi_tpu as J
import siddhi_tpu_torch as T
from siddhi_tpu_torch.checks import (KEYED_APPS, KEYED_OVERFLOW, LOSSY_APP,
                                     card_symbols, fraud_app, freq_oracle,
                                     keyed_feed, purchase_feed, time_symbols)
from siddhi_tpu_torch.core.types import GLOBAL_STRINGS as TSTR
from test_torch_window import align_strings, run_both

torch.set_num_threads(1)

APPS = ["frequent 1, no key", "frequent 2 by sym", "frequent 64 by sym, qty",
        "frequent 3, expired", "lossyFrequent 0.1, 0.01",
        "lossyFrequent 0.05, 0.005, past its slots"]
PREFIX = "FQ"
CARDS = 300


@pytest.fixture(scope="module", autouse=True)
def aligned_symbols():
    align_strings(time_symbols(16, prefix=PREFIX)
                  + card_symbols(CARDS, "FC"))


@pytest.mark.parametrize("app", APPS)
def test_keyed_app_equals_the_reference(app):
    _ts, _cols, cuts = keyed_feed(app, TSTR.encode, 7, PREFIX)
    rj, rt = run_both(KEYED_APPS[app], list(zip(cuts[:-1], cuts[1:])),
                      lambda enc: keyed_feed(app, enc, 7, PREFIX)[:2])
    assert rt.rows
    assert (rt.q.stats()["overflow"] > 0) == (app in KEYED_OVERFLOW)


def _rows(pkg, text, sends):
    kw = {"device": "cpu"} if pkg is T else {}
    rt = pkg.SiddhiManager(**kw).create_siddhi_app_runtime(text)
    got = []
    rt.add_callback("Out", pkg.StreamCallback(
        lambda evs: got.extend((e.data[0], e.data[1]) for e in evs)))
    rt.start()
    for ts, row in sends:
        rt.get_input_handler("S").send(pkg.Event(timestamp=ts, data=row))
    rt.shutdown()
    return got


QL = """@app:playback
    define stream S (sym string, v int);
    @info(name = 'q')
    from S#window.{window}
    select sym, v
    insert {what} into Out;"""
REFERENCE_CASES = {
    "single slot": ("frequent(1, sym)", "all events",
                    [(1000, ("a", 1)), (1001, ("b", 2)), (1002, ("b", 3))],
                    [("a", 1), ("a", 1), ("b", 2), ("b", 3)]),
    "dropped": ("frequent(1, sym)", "all events",
                [(1000, ("a", 1)), (1001, ("a", 2)), (1002, ("b", 3))],
                [("a", 1), ("a", 2)]),
    "lossy passes": ("lossyFrequent(0.5, 0.1, sym)", "",
                     [(1000 + i, ("a", i)) for i in range(5)],
                     [("a", i) for i in range(5)]),
}


@pytest.mark.parametrize("case", sorted(REFERENCE_CASES))
def test_reference_case_equals_the_reference(case):
    window, what, sends, want = REFERENCE_CASES[case]
    text = QL.format(window=window, what=what)
    got = _rows(T, text, sends)
    assert got == _rows(J, text, sends) == want


@pytest.mark.parametrize("app", ["frequent 2", "frequent 64", "lossy"])
def test_fraud_app_equals_the_reference_and_its_oracle(app):
    """3,000 purchases over 300 cards in sends of 1,024 (the first fills
    the table and drops rows): rows equal the reference's and the
    oracle's, in order; lossyFrequent's overflow equals the oracle's."""
    n = {"frequent 2": 2, "frequent 64": 64}.get(app)
    text = fraud_app(n) if n else LOSSY_APP
    sends = [(0, 1024), (1024, 2048), (2048, 3000)]
    rj, rt = run_both(text, sends, lambda enc: purchase_feed(
        3000, enc, n_cards=CARDS, prefix="FC"), out="PotentialFraud",
        stream="Purchase")
    _ts, (card, price) = purchase_feed(3000, TSTR.encode, n_cards=CARDS,
                                       prefix="FC")
    want, ovf = freq_oracle(card, price, n or 2,
                            lossy=None if n else (0.1, 0.01))
    got = [(card_code(r[2][0]), r[2][1][1]) for r in rt.rows]
    assert [(c, float(np.frombuffer(p, np.float64)[0])) for c, p in got] \
        == [(c, p) for _e, c, p in want]
    assert rt.q.stats()["overflow"] == ovf
    if n:   # the table filled (zeroed keys expired) ...
        assert any(e for e, _c, _p in want)
    if n == 2:   # ... and rows were dropped
        assert sum(1 for e, _c, _p in want if not e) < (price >= 30).sum()


def card_code(name: str) -> int:
    return TSTR.encode(name)
