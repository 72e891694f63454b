"""Joins (kernel K7, its plain versions on the CPU) against the reference
on the comparison apps of checks.JOIN_APPS: inner, left, right and full
outer joins, unidirectional, a windowless side, a residual conjunct, a
non-equi ON, no ON, an expression key, JOIN_CAP and candidate overflow,
an aggregating selector (the float-key traps are in
test_torch_join_traps.py). The same row sends go through both packages
under both join kernels (SIDDHI_TPU_JOIN_KERNEL=probe and =grid); the
rows the output stream receives (floats by their bits, in order), the
statistics, the join's lost-pair count and both sides' window states
after every send are equal, bit for bit.

The apps run in three parts (here, test_torch_join_shapes2.py and
test_torch_join_shapes3.py). The helpers here (``MultiRun``,
``compare_runs``, ``replay_both``) also serve the port's other join and
table test files."""
import struct

import numpy as np
import pytest
import torch

import siddhi_tpu as J
import siddhi_tpu_torch as T
from siddhi_tpu.core.types import GLOBAL_STRINGS as JSTR
from siddhi_tpu_torch.checks import (FLOAT_KEY_APPS, JOIN_APPS,
                                     JOIN_SHAPE_KEYS, join_shape_feed)
from siddhi_tpu_torch.core.types import GLOBAL_STRINGS as TSTR
from test_torch_window import align_strings

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _strings():
    """The feed's keys get one code in both packages: the aggregating
    app's group table holds hashes of codes."""
    align_shape_keys()


def align_shape_keys() -> None:
    """align_strings(JOIN_SHAPE_KEYS) once a process: the three parts'
    modules may run in one worker."""
    if all(k in JSTR._to_code and k in TSTR._to_code
           and JSTR.encode(k) == TSTR.encode(k) for k in JOIN_SHAPE_KEYS):
        return
    align_strings(JOIN_SHAPE_KEYS)


TABLES = {J: JSTR, T: TSTR}
KERNEL_ENV = "SIDDHI_TPU_JOIN_KERNEL"


def norm(v):
    if isinstance(v, float):
        return ("f", struct.pack("<d", v))
    return v


BUFFER_KEYS = {"ts", "seq", "cols", "nulls", "valid"}
TABLE_KEYS = {"ts", "seq", "cols", "nulls", "valid", "next_seq",
              "overflow"}


def leaves(tree, path, strings, table):
    """(path, array) of every tensor of a state tree, floats as their
    bits; in a buffer or table state the STRING columns (flags
    ``strings``) as the strings their codes stand for."""
    if isinstance(tree, dict):
        if set(tree) in (BUFFER_KEYS, TABLE_KEYS):
            tree = {**tree, "cols": tuple(
                np.array([table.decode(int(c)) for c in np.asarray(col)],
                         dtype=object) if s else col
                for col, s in zip(tree["cols"], strings))}
        for k in sorted(tree):
            yield from leaves(tree[k], f"{path}/{k}", strings, table)
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{path}/{i}", strings, table)
    elif isinstance(tree, np.ndarray) and tree.dtype == object:
        yield path, tree
    else:
        a = tree.numpy() if isinstance(tree, torch.Tensor) \
            else np.asarray(tree)
        if a.dtype.kind == "f":
            a = a.view(np.int64 if a.itemsize == 8 else np.int32)
        yield path, a


def _flags(schema):
    return tuple(t.value == "string" for t in schema.types)


class MultiRun:
    """One app in one package: a stream callback on ``out``, row sends to
    any input stream, and the whole state: every query's (a join's two
    sides and lost pairs too) and every table's."""

    def __init__(self, pkg, text, out="Out"):
        self.pkg = pkg
        kw = {"device": "cpu"} if pkg is T else {}
        self.rt = pkg.SiddhiManager(**kw).create_siddhi_app_runtime(text)
        self.rows = []
        if out in self.rt.junctions:
            self.rt.add_callback(out, pkg.StreamCallback(
                lambda evs: self.rows.extend(
                    (e.timestamp, tuple(norm(x) for x in e.data))
                    for e in evs)))
        self.rt.start()

    def send(self, stream, rows):
        ev = [self.pkg.Event(timestamp=ts, data=tuple(r)) for ts, r in rows]
        self.rt.get_input_handler(stream).send(ev)

    def send_arrays(self, stream, ts, cols):
        self.rt.get_input_handler(stream).send_arrays(ts, cols)

    def state(self) -> dict:
        table = TABLES[self.pkg]
        out = {}
        for name, q in sorted(self.rt.queries.items()):
            snap = q.snapshot_state()
            sel = q.operators[0]
            in_schema = getattr(q, "in_schema", None)
            if "sides" in snap:
                for side, schema in q.in_schemas.items():
                    out.update(leaves(snap["sides"][side],
                                      f"{name}/sides/{side}",
                                      _flags(schema), table))
                out[f"{name}/join_overflow"] = np.asarray(
                    snap["join_overflow"])
                out.update(leaves(snap["states"], f"{name}/states", (),
                                  table))
            else:
                flags = _flags(in_schema) if in_schema is not None else ()
                out.update(leaves(snap["states"], f"{name}/states", flags,
                                  table))
            out[f"{name}/emitted"] = np.asarray(snap["emitted"])
            del sel
        for tid, t in sorted(self.rt.tables.items()):
            out.update(leaves(t.state, f"table/{tid}", _flags(t.schema),
                              table))
        return out

    def stats(self) -> dict:
        return {n: q.stats() for n, q in self.rt.queries.items()}


def compare_runs(rj: MultiRun, rt: MultiRun, what: str) -> None:
    assert rj.rows == rt.rows, what
    sj, st = rj.state(), rt.state()
    assert sj.keys() == st.keys(), (what, set(sj) ^ set(st))
    for k in sj:
        assert sj[k].shape == st[k].shape and (sj[k] == st[k]).all(), \
            f"{what}: state {k} differs"
    assert rj.stats() == rt.stats(), what


def replay_both(text, feed, monkeypatch, kernel=None, check_every=1):
    """``feed`` (a list of (stream, rows)) through both packages, under
    join kernel ``kernel`` (None: the planner's pick), comparing after
    every ``check_every``-th send. -> the two runs."""
    if kernel is None:
        monkeypatch.delenv(KERNEL_ENV, raising=False)
    else:
        monkeypatch.setenv(KERNEL_ENV, kernel)
    runs = [MultiRun(J, text), MultiRun(T, text)]
    for i, (stream, rows) in enumerate(feed):
        for r in runs:
            r.send(stream, rows)
        if (i + 1) % check_every == 0 or i == len(feed) - 1:
            compare_runs(*runs, f"send {i} ({stream})")
    return runs


# the comparison apps, in three parts: this file runs the first, and
# test_torch_join_shapes2.py and _shapes3.py the others
SHAPE_APPS = sorted(set(JOIN_APPS) - set(FLOAT_KEY_APPS))
PARTS = [SHAPE_APPS[0:5], SHAPE_APPS[5:9], SHAPE_APPS[9:]]


def check_join_app(app, kernel, monkeypatch) -> None:
    feed = join_shape_feed(app, 90, seed=sorted(JOIN_APPS).index(app))
    rj, rt = replay_both(JOIN_APPS[app], feed, monkeypatch, kernel)
    assert rt.rows, "the feed joined nothing"
    if app == "join_cap" or (app == "candidate_cap" and kernel == "probe"):
        assert rt.rt.queries["q"].overflow > 0


@pytest.mark.parametrize("kernel", ["probe", "grid"])
@pytest.mark.parametrize("app", PARTS[0])
def test_join_app_equals_the_reference(app, kernel, monkeypatch):
    check_join_app(app, kernel, monkeypatch)
