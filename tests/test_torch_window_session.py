"""The session window (kernel F; its plain version on the CPU) against
the reference, on the CPU.

- The reference's own cases (tests/test_windows2.py: a session closed by
  the gap, per-key isolation, a close by the timer with a grouped sum, a
  new session of the same key): the same rows from both packages.
- The comparison apps of checks.KEYED_APPS for the session window: keyed
  and without a key, aggregated, sessions carried across sends and
  closed by the event clock and by TIMER rows (quiet gaps in the feed),
  and 80 keys past the 64-slot table with 3 keys past the 128 members
  (both overflows counted equal). After every send rows, statistics and
  the whole state are equal, bit for bit (tolerance 0).
- Two sessions of one key in one send: the reference drops the first
  (its close time is the later session's), and so does the port.
- chip_smoke.py's window_session app at a small size: equal to the
  reference and to checks.session_oracle (each user's rows in order, the
  member overflow counted equal), with the last sessions closed by a
  TIMER.
Helpers: test_torch_window.py."""
import numpy as np
import pytest
import torch

import siddhi_tpu as J
import siddhi_tpu_torch as T
from siddhi_tpu.core.types import GLOBAL_STRINGS as JSTR
from siddhi_tpu_torch.checks import (CLICK_APP, KEYED_APPS,
                                     KEYED_OVERFLOW, click_feed, keyed_feed,
                                     session_oracle, time_symbols,
                                     user_symbols)
from siddhi_tpu_torch.core.types import GLOBAL_STRINGS as TSTR
from test_torch_window import Run, align_strings, assert_same_state, \
    run_both

torch.set_num_threads(1)

APPS = ["session by sym", "session, no key", "session aggregated",
        "session past its slots and members"]
PREFIX = "SE"
USERS = 8


@pytest.fixture(scope="module", autouse=True)
def aligned_symbols():
    align_strings(time_symbols(80, prefix=PREFIX)
                  + user_symbols(USERS, "SU") + ["SEU1", "SEU2", "SEU3"])


@pytest.mark.parametrize("app", APPS)
def test_keyed_app_equals_the_reference(app):
    _ts, _cols, cuts = keyed_feed(app, TSTR.encode, 8, PREFIX)
    sends = list(zip(cuts[:-1], cuts[1:]))

    def feed(enc):
        ts, cols, _cuts = keyed_feed(app, enc, 8, PREFIX)
        return ts, cols
    rj, rt = run_both(KEYED_APPS[app], sends, feed)
    assert rt.rows
    assert (rt.q.stats()["overflow"] > 0) == (app in KEYED_OVERFLOW)


QL = """@app:playback
    define stream S (user string, v int);
    @info(name = 'q')
    from S#window.session(1 sec, user)
    select {select}
    insert {what} into Out;"""
REFERENCE_CASES = {
    "close by gap": ("user, v", "all events",
                     [(1000, ("SEU1", 1)), (1500, ("SEU1", 2)),
                      (4000, ("SEU2", 3))]),
    "per-key isolation": ("user, v", "all events",
                          [(1000, ("SEU1", 1)), (1100, ("SEU2", 2)),
                           (1200, ("SEU1", 3)), (5000, ("SEU3", 4))]),
    "timer close": ("user, sum(v) as t", "expired events",
                    [(1000, ("SEU1", 5)), (1200, ("SEU1", 7)),
                     (9000, ("SEU2", 1))]),
    "new session, same key": ("user, v", "all events",
                              [(1000, ("SEU1", 1)), (3000, ("SEU1", 2)),
                               (9000, ("SEU2", 3))]),
}


def _rows(pkg, text, sends):
    kw = {"device": "cpu"} if pkg is T else {}
    rt = pkg.SiddhiManager(**kw).create_siddhi_app_runtime(text)
    got = []
    rt.add_callback("Out", pkg.StreamCallback(
        lambda evs: got.extend((e.timestamp, tuple(e.data)) for e in evs)))
    rt.start()
    for ts, row in sends:
        rt.get_input_handler("S").send(pkg.Event(timestamp=ts, data=row))
    rt.shutdown()
    return got


@pytest.mark.parametrize("case", sorted(REFERENCE_CASES))
def test_reference_case_equals_the_reference(case):
    select, what, sends = REFERENCE_CASES[case]
    text = QL.format(select=select, what=what)
    got = _rows(T, text, sends)
    assert got == _rows(J, text, sends) and got


def test_two_sessions_of_a_key_in_one_send():
    """SEU1 at 1,000 and 3,000 ms in one send (gap 1 s): the first
    session's close time is taken from the later one, so it does not
    close in the step, and it is not the slot's final session: the
    reference drops it (never emitted EXPIRED); so does the port."""
    text = QL.format(select="user, v", what="all events")
    runs = {pkg: Run(pkg, text) for pkg in (J, T)}
    for pkg, tab in ((J, JSTR), (T, TSTR)):
        h = runs[pkg].h
        h.send_arrays(np.array([1000, 3000], np.int64),
                      [np.array([tab.encode("SEU1")] * 2, np.int32),
                       np.array([1, 2], np.int32)])
        h.send_arrays(np.array([3500], np.int64),
                      [np.array([tab.encode("SEU2")], np.int32),
                       np.array([3], np.int32)])
    assert runs[T].rows == runs[J].rows
    assert [r[2][1] for r in runs[T].rows] == [1, 2, 3]
    assert_same_state(runs[J], runs[T], "after the sends")


def test_click_app_equals_the_reference_and_its_oracle():
    """window_session's app: 3,000 clicks of 8 users in sends of 1,024,
    then a TIMER past the last session's end: rows equal the reference's,
    each user's (clicks, dwell) rows equal the oracle's."""
    n, sends = 3000, [(0, 1024), (1024, 2048), (2048, 3000)]

    def feed(enc):
        return click_feed(n, enc, n_users=USERS, prefix="SU")
    rj, rt = run_both(CLICK_APP, sends, feed, out="Sessions",
                      stream="Click")
    ts, (user, dwell) = feed(TSTR.encode)
    flush = int(ts[-1]) + 10 * 5000
    for r in (rj, rt):
        with r.rt.barrier:
            r.rt.on_ingest_ts(flush)
    assert rt.rows == rj.rows
    assert_same_state(rj, rt, "after the flush")
    want, ovf = session_oracle([(ts[a:b], user[a:b], dwell[a:b])
                                for a, b in sends], flush_at=flush)
    got = {}
    for _t, _e, (u, c, d) in rt.rows:
        got.setdefault(TSTR.encode(u), []).append((c, d))
    # sessions merged by the close-time quirk may pass their 128 members
    # (as the symbols' codes place the users): the rows past them are
    # counted, as the oracle counts them
    assert got == want and ovf == rt.q.stats()["overflow"]
