"""Pattern queries on the scan engine (kernel K4's plain version) against
the reference, on the CPU.

The absent-pattern app of the slice (checks.TIMEOUT_APP, a request not
answered within 100 ms raises an alert) goes through the reference's
SiddhiManager and the port's with the same seeded feed, in 1,024-row
columnar sends: the rows the callbacks receive (timestamp and values, in
order), the overflow counters and the whole pending table after each
send are equal, and the rows equal an independent numpy oracle. Timer
steps fire between the sends there, from each package's scheduler.

Also, one step at a time from a live table that carry.state_from_jax
brings across: the port's stream step, timer step and arm_start equal the
reference engine's (table, match batch and next_due, bit for bit); feeds
that overflow the 128-row table and the 256-row match batch, and the
planner's choice over the reference corpus, are in test_torch_scan2.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import siddhi_tpu as J
import siddhi_tpu_torch as T
from siddhi_tpu.core.event import batch_from_columns as jbatch
from siddhi_tpu_torch.checks import TIMEOUT_APP, timeout_feed, timeout_oracle
from siddhi_tpu_torch.core.event import batch_from_columns as tbatch
from siddhi_tpu_torch.core.runtime import _tree_to
from siddhi_tpu_torch.ops import nfa as tnfa
from test_torch_pattern import (TABLES, _np, assert_tables_equal, bits,
                                carried, norm)
torch.set_num_threads(1)


class Run:
    """One app in one package, with a stream callback on ``out``."""

    def __init__(self, pkg, text, out="Out"):
        self.pkg = pkg
        kw = {"device": "cpu"} if pkg is T else {}
        self.rt = pkg.SiddhiManager(**kw).create_siddhi_app_runtime(text)
        self.q = self.rt.queries["q"]
        self.got = []
        self.rt.add_callback(out, pkg.StreamCallback(self.got.extend))
        self.rt.start()

    def rows(self):
        return [(e.timestamp, tuple(norm(v) for v in e.data))
                for e in self.got]

    def send_arrays(self, stream, ts, cols):
        self.rt.get_input_handler(stream).send_arrays(ts, cols)

    def send_rows(self, stream, events):
        self.rt.get_input_handler(stream).send(
            [self.pkg.Event(t, d) for t, d in events])

    def table(self):
        if self.pkg is J:
            return self.q.snapshot_state()["nfa"]
        return _tree_to(self.q.nfa_state, "cpu")

    def snapshot(self):
        return self.q.snapshot_state()

    def string_slots(self):
        return [[t.name == "STRING" for t in s.schema.types]
                for s in self.q.engine.slots]


def send_all(runs, stream, ts, cols, size):
    for run in runs:
        for s in range(0, len(ts), size):
            run.send_arrays(stream, ts[s:s + size],
                            [c[s:s + size] for c in cols])


def assert_runs_equal(j, t):
    assert j.rows() == t.rows()
    assert j.q.overflow_total() == t.q.overflow_total()
    assert_tables_equal(j.table(), t.table(), j.string_slots())


# ---------------------------------------------------------------------------
# absent_timeout end to end
# ---------------------------------------------------------------------------

N_TIMEOUT = 8192


@pytest.fixture(scope="module")
def timeout_runs():
    """Both packages after N_TIMEOUT events of the feed in 1,024-row sends
    (the port also counts its match batches); the feed's next 1,024 events
    are left for a step from the live table."""
    runs = [Run(pkg, TIMEOUT_APP, out="Timeouts") for pkg in (J, T)]
    runs[1].batches = []
    runs[1].q.batch_callbacks.append(
        lambda out: runs[1].batches.append(int(out.valid.sum())))
    ts, cols = timeout_feed(N_TIMEOUT + 1024, seed=5)
    tables = []
    for s in range(0, N_TIMEOUT, 1024):
        for run in runs:
            run.send_arrays("Ev", ts[s:s + 1024],
                            [c[s:s + 1024] for c in cols])
        tables.append(([r.table() for r in runs],
                       [len(r.got) for r in runs]))
    return runs, ts, cols, tables


def test_timeout_rows_and_tables_equal_the_reference(timeout_runs):
    (j, t), _ts, _cols, tables = timeout_runs
    assert j.rows() == t.rows()
    for (jt, tt), (nj, nt) in tables:
        assert nj == nt
        assert_tables_equal(jt, tt, j.string_slots())
    assert j.q.overflow_total() == t.q.overflow_total() == 0


def test_timeout_rows_equal_the_oracle(timeout_runs):
    (_j, t), ts, cols, _tables = timeout_runs
    rid, svc, due, live = timeout_oracle(
        ts[:N_TIMEOUT], *(c[:N_TIMEOUT] for c in cols))
    assert t.rows() == [(int(d), (int(r), int(s)))
                        for d, r, s in zip(due, rid, svc)]
    assert len(rid) > N_TIMEOUT // 10
    assert int(t.q.nfa_state["valid"].sum()) == live
    assert t.q.stats() == {"emitted": len(rid), "overflow": 0}


def test_timeout_timer_steps_fire_between_sends(timeout_runs):
    """Matches arrive in more batches than there were sends: the timer
    path runs on the main path, not only in tests."""
    (_j, t), _ts, _cols, _tables = timeout_runs
    sends = N_TIMEOUT // 1024
    assert len(t.batches) > sends and max(t.batches) <= 256


# ---------------------------------------------------------------------------
# one step at a time, from a live table carried over from the reference
# ---------------------------------------------------------------------------

def match_leaves(pkg, eng, m):
    """A match batch's columns as numpy (STRING columns as strings)."""
    out = []
    for c, n, typ in zip(m.cols, m.nulls, eng.match_schema.types):
        c = _np(c)
        if typ.name == "STRING":
            c = np.array([TABLES[pkg].decode(x) for x in c], dtype=object)
        else:
            c = bits(c)
        out += [c, _np(n)]
    return out + [_np(m.ts), _np(m.valid)]


def assert_matches_equal(jeng, jm, teng, tm):
    for a, b in zip(match_leaves(J, jeng, jm), match_leaves(T, teng, tm)):
        assert np.array_equal(a, b)


def steps_equal(jrun, trun, stream, ts, jcols, tcols, arm_at=None):
    """The reference engine and the port's plain K4 from the reference's
    current table: one stream step over the events (ts, each package's
    columns), then a timer step at the table's next due, then arm_start.
    -> matches of the stream step."""
    jeng, teng = jrun.q.engine, trun.q.engine
    snap = jrun.snapshot()
    jt = jnp_tree(snap["nfa"])
    tt = carried(jrun, snap)["nfa"]
    cap = 1 << max(4, (len(ts) - 1).bit_length())
    jb = jbatch(jrun.rt.schemas[stream], ts, jcols, capacity=cap)
    tb = tbatch(trun.rt.schemas[stream], ts, tcols, capacity=cap)
    jt, jm = jeng.make_stream_step(stream)(jt, jb, jnp.int64(int(ts[-1])))
    n_match = int(np.asarray(jm.valid).sum())
    due = torch.zeros((), dtype=torch.int64)
    tt, tm = tnfa.scan_step(teng, stream, tt, tb, due)
    assert_tables_equal(np_tree(jt), tt, jrun.string_slots())
    assert_matches_equal(jeng, jm, teng, tm)
    jdue = int(jeng.next_due(jt))
    assert int(due) == jdue
    now = jdue if jdue < 2 ** 62 else int(ts[-1]) + 1000
    jt, jm = jeng.make_timer_step()(jt, jnp.int64(now))
    tt, tm = tnfa.timer_step(teng, tt, now, due)
    assert_tables_equal(np_tree(jt), tt, jrun.string_slots())
    assert_matches_equal(jeng, jm, teng, tm)
    assert int(due) == int(jeng.next_due(jt))
    at = now + 7 if arm_at is None else arm_at
    assert_tables_equal(np_tree(jeng.arm_start(jt, jnp.int64(at))),
                        teng.arm_start(tt, at), jrun.string_slots())
    return n_match


def jnp_tree(tree):
    if isinstance(tree, dict):
        return {k: jnp_tree(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(jnp_tree(v) for v in tree)
    return jnp.asarray(tree)


def np_tree(tree):
    if isinstance(tree, dict):
        return {k: np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(np_tree(v) for v in tree)
    return np.asarray(tree)


def test_timeout_steps_from_a_live_table(timeout_runs):
    (jr, tr), ts, cols, _tables = timeout_runs
    assert int(np.asarray(jr.table()["valid"]).sum()) > 10
    part = [c[N_TIMEOUT:] for c in cols]
    assert steps_equal(jr, tr, "Ev", ts[N_TIMEOUT:], part, part) > 100
