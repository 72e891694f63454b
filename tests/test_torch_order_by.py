"""Order-by, having, limit and offset (kernel G and K2; the plain
versions on the CPU) against the reference, on the CPU.

- The lexsort traps (checks.ORDER_TRAP_APP): zeros of both signs, NaN
  of both signs and the infinities on DOUBLE and FLOAT keys, the INT and
  LONG extremes, BOOL, asc and desc. Rows equal the reference's, and the
  orders equal jnp.lexsort's: for v = [0.0, -0.0, NaN, inf, -inf, 1.0,
  -NaN, 0.0], (arange, v) gives [4 0 1 7 5 3 2 6] and (arange, -v)
  [3 5 0 1 7 4 2 6] (the zeros tie, the NaNs last both ways); an INT
  column [INT_MIN, 0, 5, -5] desc gives [0 2 1 3] (INT_MIN wraps).
- The order-by apps of checks.KEYED_APPS (plain and aggregating
  selectors, every key type, offset alone, limit alone and both, having
  with and without an order) over checks.window2_feed: rows, statistics
  and whole states equal after every send, bit for bit (tolerance 0).
- A STRING key moves the ordering, with offset and limit, to the host
  edge: tests/test_small_gaps.py's apps, and window_top10's app at a
  small size against the reference and checks.top10_oracle, with its
  all-device variant and the stateless top-100 (checks.hi_oracle).
- A STRING order feeding a table output is refused by both packages.
Helpers: test_torch_window.py."""
import numpy as np
import pytest
import torch

import siddhi_tpu as J
import siddhi_tpu_torch as T
from siddhi_tpu_torch.checks import (HI_APP, KEYED_APPS, ORDER_TRAP_APP,
                                     TOP10_APP, TOP10_HI_APP, TS0, hi_oracle,
                                     order_trap_feed, time_symbols,
                                     top10_oracle, trades_feed,
                                     window2_feed)
from siddhi_tpu_torch.core.types import GLOBAL_STRINGS as TSTR
from test_torch_window import align_strings, run_both

torch.set_num_threads(1)

APPS = [a for a in KEYED_APPS if a.startswith(("order", "having"))]
SENDS = [(0, 100), (100, 228), (228, 356)]
PREFIX = "OB"


@pytest.fixture(scope="module", autouse=True)
def aligned_symbols():
    align_strings(time_symbols(16, prefix=PREFIX)
                  + time_symbols(64, prefix="OT"))


@pytest.mark.parametrize("app", APPS)
def test_order_app_equals_the_reference(app):
    rj, rt = run_both(KEYED_APPS[app], SENDS, lambda enc: window2_feed(
        356, enc, seed=11, prefix=PREFIX))
    assert rt.rows


TRAPS = {"d": [4, 0, 1, 7, 5, 3, 2, 6], "d desc": [3, 5, 0, 1, 7, 4, 2, 6],
         "f": [4, 0, 1, 7, 5, 3, 2, 6], "f desc": [3, 5, 0, 1, 7, 4, 2, 6],
         "i desc": None, "i": None, "l desc": None, "l": None,
         "b desc, d": None, "b, i desc": None}


@pytest.mark.parametrize("key", sorted(TRAPS))
def test_lexsort_traps_equal_the_reference(key):
    rj, rt = run_both(ORDER_TRAP_APP.format(key=key), [(0, 8)],
                      lambda enc: order_trap_feed())
    perm = [r[0] - TS0 for r in rt.rows]
    assert sorted(perm) == list(range(8))
    if TRAPS[key] is not None:
        assert perm == TRAPS[key]
    if key == "i desc":   # [INT_MIN, 0, 5, -5] desc: [0 2 1 3]
        assert [p for p in perm if p < 4] == [0, 2, 1, 3]


def _rows(pkg, text, sends):
    kw = {"device": "cpu"} if pkg is T else {}
    rt = pkg.SiddhiManager(**kw).create_siddhi_app_runtime(text)
    got = []
    rt.add_callback("O", pkg.StreamCallback(
        lambda evs: got.extend(tuple(e.data) for e in evs)))
    rt.start()
    for ts, row in sends:
        rt.get_input_handler("S").send(pkg.Event(timestamp=ts, data=row))
    rt.shutdown()
    return got


STRING_CASES = {
    "order and limit": ("""@app:playback
        define stream S (sym string, v int);
        @info(name='q')
        from S#window.lengthBatch(4)
        select sym, v order by sym limit 3 insert into O;""",
        [(1000 + i, (s, i)) for i, s in
         enumerate(["zeta", "alpha", "mike", "beta"])],
        [("alpha", 1), ("beta", 3), ("mike", 2)]),
    "desc with offset": ("""@app:playback
        define stream S (sym string);
        @info(name='q')
        from S#window.lengthBatch(3)
        select sym order by sym desc offset 1 insert into O;""",
        [(1000 + i, (s,)) for i, s in enumerate(["a", "c", "b"])],
        [("b",), ("a",)]),
    "aggregated, then a number": ("""@app:playback
        define stream S (sym string, v int);
        @info(name='q')
        from S#window.lengthBatch(6)
        select sym, sum(v) as t group by sym
        order by sym desc, t limit 2 insert into O;""",
        [(1000 + i, (s, i)) for i, s in
         enumerate(["b", "a", "c", "a", "b", "d"])],
        [("d", 5), ("c", 2)]),
}


@pytest.mark.parametrize("case", sorted(STRING_CASES))
def test_string_order_at_the_host_edge(case):
    text, sends, want = STRING_CASES[case]
    assert _rows(T, text, sends) == _rows(J, text, sends) == want


def test_string_order_into_a_table_is_refused():
    text = """define stream S (sym string, v int);
        define table Tb (sym string, v int);
        from S select sym, v order by sym insert into Tb;"""
    for pkg in (J, T):
        kw = {"device": "cpu"} if pkg is T else {}
        with pytest.raises(Exception, match="order by on a STRING"):
            pkg.SiddhiManager(**kw).create_siddhi_app_runtime(text)


@pytest.mark.parametrize("app", ["top10", "top10 by hi", "hi"])
def test_window_top10_equals_the_reference_and_its_oracle(app):
    """window_top10's three queries at 6,000 trades over 64 symbols,
    batches of 2,000, sends of 1,000: rows equal the reference's and
    the oracle's."""
    text = {"top10": TOP10_APP, "top10 by hi": TOP10_HI_APP,
            "hi": HI_APP}[app].replace("65536", "2000")
    out = "Hi" if app == "hi" else "Top"
    sends = [(a, a + 1000) for a in range(0, 6000, 1000)]

    def feed(enc):
        return trades_feed(6000, enc, n_syms=64, prefix="OT")
    rj, rt = run_both(text, sends, feed, out=out, stream="Trades")
    _ts, (_ets, sym, price, vol) = feed(TSTR.encode)
    got = [(TSTR.encode(r[2][0]),) + tuple(
        float(np.frombuffer(x[1], np.float64)[0]) if isinstance(x, tuple)
        else x for x in r[2][1:]) for r in rt.rows]
    if app == "hi":
        want = hi_oracle(sym, price, vol, 1000)
        assert got == [(c, p, v) for c, p, v in want]
        return
    names = {int(c): TSTR.decode(int(c)) for c in np.unique(sym)}
    want = top10_oracle(sym, price, vol, 2000, by_hi=app.endswith("hi"),
                        names=names)
    assert got == [(c, v, h) for batch in want for c, v, h in batch]
