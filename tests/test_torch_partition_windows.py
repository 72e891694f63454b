"""Every window kind inside a partition block (the second wave's K5
kinds, kernel A[K]; the sort window, B[K]; frequent and lossyFrequent,
E[K]; session, F[K]) against the reference's partition runtime, on the
CPU, where each runs its plain version over the block's slot axis.

Each app holds one window kind at ``@slots('8')``; the feed
(``window_feed``: ten symbols, so two keys find no slot and their rows
are dropped and counted; an event clock ``ets`` that steps back now and
then; a NaN price) goes in uneven sends, and the clock is then driven
200 ms past the last event so that the timed kinds (timeLength, delay,
hopping, externalTimeBatch's timeout, session's gap) fire their timer
steps. After every send and after the clock's advance the rows so far
(in order, floats by their bits), each query's ``stats()`` and the
whole block state (the slot table, every query's slotted state, emitted
and lost) equal the reference's, tolerance 0. The apps are split over
this file (five K5 kinds) and test_torch_partition_windows2.py
(externalTimeBatch, sort, frequent, lossyFrequent) and _windows3.py
(session, with the slotted plain versions against ``per_slot``);
_windows4.py carries reference block states into the port mid-feed.
Each module's feed strings carry its own prefix and are interned in
both tables in one order first."""
import numpy as np
import pytest
import torch

import siddhi_tpu as J
import siddhi_tpu_torch as T
from siddhi_tpu.core.types import GLOBAL_STRINGS as JSTR
from siddhi_tpu_torch.core.types import GLOBAL_STRINGS as TSTR
from test_torch_window import align_strings, leaves

torch.set_num_threads(1)

TABLES = {J: JSTR, T: TSTR}
TS0 = 1_000_000
N_SYMS = 10
N_CARDS = 5

W_STREAM = """
    @app:playback
    define stream S (sym string, ets long, price double, card string);
"""


def block(query: str, slots: int = 8) -> str:
    return W_STREAM + f"""
    @slots('{slots}')
    partition with (sym of S) begin
      @info(name = 'q') @cap(window.size='64')
      {query}
    end;
"""


# kernel A[K]: the second wave's K5 kinds
APPS_A = {
    "externalTime": block("""from S#window.externalTime(ets, 30 milliseconds)
      select sym, sum(price) as sp, count() as n
      insert all events into Out;"""),
    "timeLength": block("""from S#window.timeLength(20 milliseconds, 3)
      select sym, ets, price insert all events into Out;"""),
    "delay": block("""from S#window.delay(15 milliseconds)
      select sym, ets, price insert into Out;"""),
    "batch": block("""from S#window.batch(2)
      select sym, sum(price) as sp, count() as n
      insert all events into Out;"""),
    "externalTimeBatch": block(
        """from S#window.externalTimeBatch(ets, 40 milliseconds, 0,
                                              50 milliseconds)
      select sym, count() as n, max(ets) as me
      insert all events into Out;"""),
    "hopping": block("""from S#window.hopping(60 milliseconds,
                                              40 milliseconds)
      select sym, ets, price insert into Out;"""),
}
# kernels B[K], E[K] and F[K]
APPS_BEF = {
    "sort": block("""from S#window.sort(3, price, 'asc', ets, 'desc')
      select sym, ets, price insert all events into Out;"""),
    "frequent": block("""from S[price >= 20]#window.frequent(2, card)
      select sym, card, price insert all events into Out;"""),
    "lossyFrequent": block(
        """from S#window.lossyFrequent(0.3, 0.1, card)
      select sym, card, price insert all events into Out;"""),
    "session": block("""from S#window.session(25 milliseconds, card)
      select sym, card, count() as n, sum(price) as sp
      group by card
      insert all events into Out;"""),
}
APPS = {**APPS_A, **APPS_BEF}
CUTS = (0, 1, 9, 60, 61, 180, 230, 300)


def window_feed(n: int, encode, prefix: str, seed: int = 51):
    """(ts, [sym, ets, price, card]): arrival gaps of 1-5 ms from TS0;
    ets the arrival time stepped back 0-3 ms at random; ten symbols and
    five cards uniform; price ~ U(0, 100) to the cent, row 7 NaN."""
    rng = np.random.default_rng(seed)
    syms = np.array([encode(f"{prefix}{i:02d}") for i in range(N_SYMS)],
                    np.int32)
    cards = np.array([encode(f"{prefix}c{i}") for i in range(N_CARDS)],
                     np.int32)
    ts = TS0 + np.cumsum(rng.integers(1, 6, n)).astype(np.int64)
    ets = ts - rng.integers(0, 4, n)
    price = np.round(rng.uniform(0, 100, n), 2)
    price[7] = np.nan
    return ts, [syms[rng.integers(0, N_SYMS, n)], ets, price,
                cards[rng.integers(0, N_CARDS, n)]]


def names(prefix: str) -> list:
    return [f"{prefix}{i:02d}" for i in range(N_SYMS)] + \
        [f"{prefix}c{i}" for i in range(N_CARDS)]


def row_of(e):
    return (e.timestamp, e.is_expired,
            tuple(x.hex() if isinstance(x, float) else x for x in e.data))


def block_state(rt) -> dict:
    return {n: dict(leaves({k: v for k, v in b.snapshot_state().items()
                            if k != "rate"}))
            for n, b in rt.partitions.items()}


def replay(pkg, text, prefix, cuts=CUTS):
    """-> [(rows so far, stats, block states)] after every send and after
    the clock's last advance."""
    kw = {"device": "cpu"} if pkg is T else {}
    rt = pkg.SiddhiManager(**kw).create_siddhi_app_runtime(text)
    rows = []
    rt.add_callback("Out", pkg.StreamCallback(
        lambda evs: rows.extend(row_of(e) for e in evs)))
    rt.start()
    ts, cols = window_feed(cuts[-1], TABLES[pkg].encode, prefix)
    h = rt.get_input_handler("S")
    seen = []

    def look():
        seen.append((list(rows), {n: q.stats()
                                  for n, q in rt.queries.items()},
                     block_state(rt)))
    for a, b in zip(cuts[:-1], cuts[1:]):
        h.send_arrays(ts[a:b], [c[a:b] for c in cols])
        look()
    with rt.barrier:
        rt.on_ingest_ts(int(ts[-1]) + 200)
    look()
    rt.shutdown()
    return seen


def check_app(text, prefix):
    sj = replay(J, text, prefix)
    st = replay(T, text, prefix)
    assert len(sj) == len(st)
    for step, ((rj, qj, bj), (rt_, qt, bt)) in enumerate(zip(sj, st)):
        assert rt_ == rj, step
        assert qt == qj, step
        assert bj.keys() == bt.keys()
        for n in bj:
            assert bj[n].keys() == bt[n].keys(), (step, n)
            for k in bj[n]:
                assert (bj[n][k] == bt[n][k]).all(), (step, n, k)
    rows, stats, _b = st[-1]
    assert rows, "no rows"
    assert stats["q"]["overflow"] > 0, stats
    return st


PREFIX = "wa"


@pytest.fixture(scope="module", autouse=True)
def symbols():
    align_strings(names(PREFIX))


@pytest.mark.parametrize("kind", sorted(set(APPS_A) -
                                         {"externalTimeBatch"}))
def test_k5_kinds_in_a_block_equal_the_reference(kind):
    check_app(APPS_A[kind], PREFIX)
