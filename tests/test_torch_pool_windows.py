"""Every window kind with a slot axis in a tenant pool's chain against
the reference's TenantPool, on the CPU: checks.POOL_WINDOWS_TEMPLATE
holds one query a kernel, each behind a ``${...}`` filter (externalTime,
kernel A[K]; the sort window, B[K]; frequent, E[K]; session, F[K]). Six tenants join while rounds run (eight slots from the
start: a new slot count would recompile every reference step),
150 rows each (``pool_windows_feed``, its users' names with the
module's prefix, interned in both string tables in one order first) in
chunks of 100, ``batch_max``
128; after every fair round, and after ``advance_time`` (the pool
discards a chain's due, as the reference's does, so the sessions close
only on rounds and advances), each tenant's callback rows, the whole
stacked states (free slots included, carried through
``carry.pool_from_jax``) and the ``emitted`` counters equal the
reference pool's, bit for bit. Then churn: a tenant leaves and one with
other bindings takes the freed slot and its state is fresh."""
import numpy as np
import pytest
import torch

from siddhi_tpu_torch.checks import (POOL_WINDOW_USERS,
                                     POOL_WINDOWS_TEMPLATE,
                                     pool_windows_bindings,
                                     pool_windows_feed, user_symbols)
from siddhi_tpu_torch.core.types import GLOBAL_STRINGS as TSTR
from siddhi_tpu_torch.ops import windows2 as W2
from test_torch_pool_chain import Pair, chunks
from test_torch_window import align_strings

torch.set_num_threads(1)

PREFIX = "pw"


def feed(seed: int):
    return pool_windows_feed(150, TSTR.encode, seed, PREFIX)


@pytest.fixture(scope="module")
def windows():
    align_strings(user_symbols(POOL_WINDOW_USERS, PREFIX))
    rng = np.random.default_rng(7)
    pair = Pair(POOL_WINDOWS_TEMPLATE, slots=8, max_tenants=8,
                batch_max=128)
    feeds = {}
    rounds = 0
    for i in range(6):
        tid = f"w{i}"
        pair.add(tid, pool_windows_bindings(i))
        feeds[tid] = list(chunks(rng, *feed(300 + i), lo=100,
                                 hi=101))
        for tid2, fs in feeds.items():
            if fs:
                pair.send(tid2, *fs.pop(0))
        rounds += pair.pump() > 0
    for tid, fs in feeds.items():
        for ts, cols in fs:
            pair.send(tid, ts, cols)
    rounds += pair.flush()
    last = max(int(feed(300 + i)[0][-1]) for i in range(6))
    pair.advance_time(last + 100)
    slot2 = pair.t._tenants["w2"]
    pair.remove("w2")
    slot9 = pair.add("w9", {"lo": 150.5, "hi": 850.25})
    ts, cols = feed(9)
    for c in chunks(rng, ts + 2000, cols, lo=100, hi=101):
        pair.send("w9", *c)
    rounds += pair.flush()
    pair.advance_time(int(ts[-1]) + 2100)
    return pair, rounds, slot2, slot9


def test_window_rows_states_and_emitted_after_every_round(windows):
    pair, rounds, slot2, slot9 = windows
    assert rounds >= 8 and slot9 == slot2
    assert pair.t.slots == 8
    for i in (0, 1, 3, 4, 5, 9):
        rows = pair.rows.get(("t", f"w{i}"), [])
        assert rows and rows == pair.rows.get(("j", f"w{i}"), [])
    stats, jst = pair.t.statistics(), pair.j.statistics()
    for tid, entry in stats["tenants"].items():
        assert entry["emitted"] == jst["tenants"][tid]["emitted"]


def test_the_pool_runs_every_new_kind(windows):
    pair = windows[0]
    kinds = {type(op) for q in pair.t.proto.queries.values()
             for op in q.operators}
    assert {W2.ExternalTimeWindowOp, W2.SortWindowOp, W2.FrequentWindowOp,
            W2.SessionWindowOp} <= kinds
    # every tenant's sessions reached its callback (the only rows that
    # lead with a string)
    for tid in pair.t._tenants:
        assert any(isinstance(d[0], str)
                   for _ts, _e, d in pair.rows[("t", tid)]), tid
