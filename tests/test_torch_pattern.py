"""Pattern queries on the round-parallel NFA (kernel K3's plain version)
against the reference, on the CPU: the same app text and the same feed
go through the reference's SiddhiManager and the port's; the rows the
callbacks receive (timestamp, values, bit for bit, in order), the
overflow counters and the whole NFA pending table after each phase are
equal. STRING columns hold each package's own dictionary codes, so they
are compared as the strings they stand for.

Also: a table carried over from the reference (carry.py) goes on
equally; parallel_step_ref is held against the reference's step on a
carried table; and over the whole reference corpus the port's compiler
and parallel_supported agree with the reference's."""
import functools
import json
import pathlib
import struct

import numpy as np
import pytest
import torch

import siddhi_tpu as J
import siddhi_tpu_torch as T
from siddhi_tpu.core.event import Attribute as JAttribute
from siddhi_tpu.core.event import StreamSchema as JStreamSchema
from siddhi_tpu.core.types import GLOBAL_STRINGS as JSTR
from siddhi_tpu.lang import ast as JA
from siddhi_tpu.lang.parser import parse as jparse
from siddhi_tpu.ops import nfa as jnfa
from siddhi_tpu.ops import nfa_parallel as jpar
from siddhi_tpu_torch.carry import state_from_jax
from siddhi_tpu_torch.checks import SEQ5_APP, Seq5Feed
from siddhi_tpu_torch.core.event import Attribute as TAttribute
from siddhi_tpu_torch.core.event import StreamSchema as TStreamSchema
from siddhi_tpu_torch.core.event import batch_from_columns, rows_from_batch
from siddhi_tpu_torch.core.runtime import _tree_to
from siddhi_tpu_torch.core.types import GLOBAL_STRINGS as TSTR
from siddhi_tpu_torch.lang import ast as TA
from siddhi_tpu_torch.lang.parser import parse as tparse
from siddhi_tpu_torch.ops import nfa as tnfa
from siddhi_tpu_torch.ops import nfa_parallel as tpar

torch.set_num_threads(1)

CORPUS = pathlib.Path(__file__).parent / "ref_corpus"
TABLES = {J: JSTR, T: TSTR}


def norm(v):
    """A row value compared bit for bit (floats by their bits)."""
    if isinstance(v, float):
        return ("f", struct.pack("<d", v))
    return v


class Run:
    """One app in one package, with a stream callback on Out."""

    def __init__(self, pkg, text):
        self.pkg = pkg
        kw = {"device": "cpu"} if pkg is T else {}
        self.rt = pkg.SiddhiManager(**kw).create_siddhi_app_runtime(text)
        self.q = self.rt.queries["q"]
        self.got = []
        self.rt.add_callback("Out", pkg.StreamCallback(self.got.extend))
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
        """The NFA pending table as numpy arrays."""
        if self.pkg is J:
            return self.q.snapshot_state()["nfa"]
        return _tree_to(self.q.nfa_state, "cpu")

    def string_slots(self):
        return [[t.name == "STRING" for t in s.schema.types]
                for s in self.q.engine.slots]


def _np(x):
    return x.numpy() if hasattr(x, "numpy") and not isinstance(
        x, np.ndarray) else np.asarray(x)


def bits(a):
    a = np.asarray(a)
    if a.dtype == np.float32:
        return a.view(np.int32)
    if a.dtype == np.float64:
        return a.view(np.int64)
    return a


def decode(table, codes):
    return np.array([table.decode(c) for c in np.asarray(codes).ravel()],
                    dtype=object).reshape(np.asarray(codes).shape)


def assert_tables_equal(jt, tt, strings):
    """Every leaf of the two NFA tables equal, bit for bit (STRING slot
    columns as strings)."""
    assert set(jt) == set(tt), (set(jt) ^ set(tt))
    for k in jt:
        if k == "slots":
            continue
        j, t = np.asarray(jt[k]), _np(tt[k])
        assert j.dtype == t.dtype and j.shape == t.shape, k
        assert np.array_equal(bits(j), bits(t)), k
    for s, (js, ts) in enumerate(zip(jt["slots"], tt["slots"])):
        for k in ("ts", "n"):
            j, t = np.asarray(js[k]), _np(ts[k])
            assert j.dtype == t.dtype and np.array_equal(j, t), (s, k)
        for a, (jc, tc) in enumerate(zip(js["cols"], ts["cols"])):
            j, t = np.asarray(jc), _np(tc)
            assert j.dtype == t.dtype and j.shape == t.shape, (s, a)
            if strings[s][a]:
                assert np.array_equal(decode(JSTR, j), decode(TSTR, t)), \
                    (s, a)
            else:
                assert np.array_equal(bits(j), bits(t)), (s, a)
        for a, (jn, tn) in enumerate(zip(js["nulls"], ts["nulls"])):
            assert np.array_equal(np.asarray(jn), _np(tn)), (s, a, "nulls")


def carried(run_j: Run, snap: dict) -> dict:
    """A reference snapshot for the port: carry.state_from_jax, with the
    STRING slot columns' codes mapped through the strings they stand for
    (the two packages give strings codes independently)."""
    snap = {**snap, "nfa": dict(snap["nfa"])}
    slots = []
    for buf, strs in zip(snap["nfa"]["slots"], run_j.string_slots()):
        cols = tuple(
            np.vectorize(lambda c: TSTR.encode(JSTR.decode(c)),
                         otypes=[np.int32])(np.asarray(c)) if s
            else np.asarray(c) for c, s in zip(buf["cols"], strs))
        slots.append({**buf, "cols": cols})
    snap["nfa"]["slots"] = tuple(slots)
    return state_from_jax(snap, "cpu")


# ---------------------------------------------------------------------------
# seq5: the bench feed, row-mode sends, and the table-overflow feed
# ---------------------------------------------------------------------------

PHASES = ("bench send 1", "bench send 2", "row sends", "table overflow")


def seq5_phases(pkg):
    """seq5's sends in order: two sends of 8,192 rows of the bench feed
    (seed 12; two sub-batches each), two row-mode sends, then 8,192
    stage-1 events, which fill the 4,096-row table and overflow it."""
    feed = Seq5Feed(TABLES[pkg].encode)
    out = [("arrays", feed.next(8192)), ("arrays", feed.next(8192))]
    ts, (sym, stage, v) = feed.next(6)
    rows = [(int(t), (TABLES[pkg].decode(s), int(g), int(x)))
            for t, s, g, x in zip(ts, sym, stage, v)]
    out.append(("rows", (rows[:2], rows[2:])))
    out.append(("arrays", feed.next(8192, stages=[1] * 8192)))
    return out


def run_seq5(pkg, start=None, first_phase=0):
    """Run seq5's phases (from ``first_phase`` on, after restoring the
    port from ``start``); -> one record per phase."""
    run = Run(pkg, SEQ5_APP)
    if start is not None:
        run.q.restore_state(start)
    records = []
    for kind, data in seq5_phases(pkg)[first_phase:]:
        if kind == "arrays":
            run.send_arrays("T", *data)
        else:
            for part in data:
                run.send_rows("T", part)
        records.append({"rows": run.rows(), "table": run.table(),
                        "overflow": run.q.overflow_total(),
                        "stats": run.q.stats(),
                        "snapshot": run.q.snapshot_state()})
    return run, records


@pytest.fixture(scope="module")
def seq5():
    return run_seq5(J), run_seq5(T)


def test_seq5_rows_in_order(seq5):
    (_j, jrec), (_t, trec) = seq5
    for phase, j, t in zip(PHASES, jrec, trec):
        assert j["rows"] == t["rows"], phase
    assert len(trec[1]["rows"]) == 3269   # the reference's count, seed 12


def test_seq5_overflow_and_stats(seq5):
    (_j, jrec), (_t, trec) = seq5
    for phase, j, t in zip(PHASES, jrec, trec):
        assert j["overflow"] == t["overflow"], phase
        assert j["stats"] == t["stats"], phase
    assert trec[1]["overflow"] == 0


def test_seq5_table_bit_equal(seq5):
    (jrun, jrec), (_t, trec) = seq5
    for phase, j, t in zip(PHASES, jrec, trec):
        assert_tables_equal(j["table"], t["table"], jrun.string_slots())
    assert int(np.asarray(trec[1]["table"]["valid"]).sum()) == 13


def test_table_overflow_feed(seq5):
    """8,192 stage-1 events: the table fills and the rest is counted."""
    (_j, jrec), (_t, trec) = seq5
    assert trec[3]["overflow"] - trec[2]["overflow"] == \
        jrec[3]["overflow"] - jrec[2]["overflow"] > 0
    assert np.asarray(trec[3]["table"]["valid"]).all()


def test_seq5_carried_over_from_reference(seq5):
    """The port restored from the reference's state after the first send
    goes on exactly as the reference does."""
    (jrun, jrec), _ = seq5
    trun, trec = run_seq5(T, carried(jrun, jrec[0]["snapshot"]),
                          first_phase=1)
    before = len(jrec[0]["rows"])
    for phase, j, t in zip(PHASES[1:], jrec[1:], trec):
        assert j["rows"][before:] == t["rows"], phase
        assert j["overflow"] == t["overflow"], phase
        assert_tables_equal(j["table"], t["table"], jrun.string_slots())


def test_parallel_step_ref_against_reference_step(seq5):
    """parallel_step_ref on the reference's table after send 1, over the
    events of send 2, gives the reference's table after send 2 and its
    rows."""
    (jrun, jrec), _ = seq5
    trun = Run(T, SEQ5_APP)
    table = carried(jrun, jrec[0]["snapshot"])["nfa"]
    ts, cols = seq5_phases(T)[1][1]
    batch = batch_from_columns(trun.rt.schemas["T"], ts, cols,
                               capacity=8192)
    eng = trun.q.engine
    table2, match = tpar.parallel_step_ref(eng, "T", table, batch)
    assert_tables_equal(jrec[1]["table"], _tree_to(table2, "cpu"),
                        jrun.string_slots())
    _states, out = trun.q._chain(trun.q.states, trun.q._emitted_dev, match,
                                 0)
    got = [(t, tuple(norm(v) for v in d))
           for t, _k, d in rows_from_batch(trun.q.out_schema.types, out)]
    assert got == jrec[1]["rows"][len(jrec[0]["rows"]):]


# ---------------------------------------------------------------------------
# compile only: the port's compiler and engine choice over the corpus
# ---------------------------------------------------------------------------

SPEC_FIELDS = ("idx", "slot", "stream_id", "next_idx", "every_arm",
               "clear_from", "is_start", "always_armed", "armed_once",
               "rearm_each_round", "suppress_when_next_busy", "viol_push",
               "viol_latch", "min_count", "max_count", "partner",
               "logical_op", "anchor", "is_absent", "waiting_ms",
               "dl_field")


def compile_pattern(pkg_parse, A, Schema, Attr, nfa, par, app_text):
    """-> [(slots, states, parallel?) per pattern query], or the
    exception's type name."""
    try:
        app = pkg_parse("@app:playback " + app_text)
        schemas = {sid: Schema(sid, tuple(Attr(a.name, a.type)
                                          for a in sd.attributes))
                   for sid, sd in app.stream_definitions.items()}
        out = []
        for el in app.execution_elements:
            if isinstance(el, A.Query) and \
                    isinstance(el.input, A.StateInputStream):
                slots, states = nfa.NfaCompiler(
                    schemas, el.input.state_type).compile(el.input.state)
                out.append((
                    [(s.ref, s.stream_id, s.cap) for s in slots],
                    [tuple(getattr(st, f) for f in SPEC_FIELDS)
                     for st in states],
                    par.parallel_supported(slots, states,
                                           el.input.state_type)))
        return out
    except Exception as exc:  # noqa: BLE001 — compared across packages
        return type(exc).__name__


CORPUS_FILES = sorted(p.name for p in CORPUS.glob("*.json")
                      if p.name.startswith(("pattern", "sequence")))


@functools.lru_cache(maxsize=None)
def corpus_choices(fname: str):
    cases = json.loads((CORPUS / fname).read_text())["cases"]
    out = {}
    for c in cases:
        j = compile_pattern(jparse, JA, JStreamSchema, JAttribute, jnfa,
                            jpar, c["app"])
        t = compile_pattern(tparse, TA, TStreamSchema, TAttribute, tnfa,
                            tpar, c["app"])
        out[c["name"]] = (j, t)
    return out


@pytest.mark.parametrize("fname", CORPUS_FILES)
def test_compiler_and_engine_choice_match_reference(fname):
    for name, (j, t) in corpus_choices(fname).items():
        if isinstance(j, list):
            j = [(s, [tuple(getattr(v, "name", v) for v in st)
                      for st in sts], p) for s, sts, p in j]
            t = [(s, [tuple(getattr(v, "name", v) for v in st)
                      for st in sts], p) for s, sts, p in t]
        assert j == t, name


def test_thirteen_corpus_cases_pick_the_parallel_engine():
    picked = sorted(
        f"{fname[:-5]}.{name}" for fname in CORPUS_FILES
        for name, (_j, t) in corpus_choices(fname).items()
        if isinstance(t, list) and any(p for _s, _st, p in t))
    assert len(picked) == 13, picked
