"""Function calls in every context a program runs in, against the
reference on the CPU (checks.FUNC_APPS): a filter and a projection
(kernel K2), having over an aggregating selector and aggregator
arguments (K2, K6), a grouped selector, a pattern condition on each
engine (K3, K4), a join's ON (K7), a table's update-or-insert ON and a
stream-table join's ON (K8), and an on-demand query. The same row sends
go through both packages; the rows (floats by their bits, in order) and
the statistics are equal. The group-by keys themselves are attribute
references in the grammar, so no function reaches them.

One known divergence is read around, not hidden: a NaN that a sliding
window's sum lane adds and later removes comes out of the reference with
either sign, as XLA's CPU code happens to order the add's operands in
each compiled step (ROADMAP Queue 3); in aggregator_argument's
aggregated columns a NaN therefore equals a NaN of either sign, and
every other bit is compared."""
import pytest
import torch

import siddhi_tpu as J
import siddhi_tpu_torch as T
from siddhi_tpu_torch.checks import FUNC_APPS, FUNC_SYMS, func_app_sends
from siddhi_tpu_torch.ops.nfa import NfaEngine
from siddhi_tpu_torch.ops.nfa_parallel import ParallelNfaEngine
from test_torch_join_shapes import MultiRun, norm
from test_torch_window import align_strings

torch.set_num_threads(1)

PLAYBACK = "@app:playback "
KEYS = FUNC_SYMS[:3]
NAN_BITS = {b"\x00\x00\x00\x00\x00\x00\xf8\x7f",
            b"\x00\x00\x00\x00\x00\x00\xf8\xff"}


def nan_sign_free(rows):
    """Rows with a quiet NaN of either sign as one value."""
    return [(ts, tuple(("f", "nan") if isinstance(x, tuple)
                       and x[1] in NAN_BITS else x for x in data))
            for ts, data in rows]


@pytest.fixture(scope="module", autouse=True)
def _strings():
    """The feed's symbols get one code in both packages (group tables
    hash codes)."""
    from siddhi_tpu.core.types import GLOBAL_STRINGS as JSTR
    from siddhi_tpu_torch.core.types import GLOBAL_STRINGS as TSTR
    if not all(k in JSTR._to_code and k in TSTR._to_code
               and JSTR.encode(k) == TSTR.encode(k) for k in KEYS):
        align_strings(KEYS)


@pytest.mark.parametrize("name", sorted(FUNC_APPS))
def test_functions_in_context_equal_the_reference(name):
    text = PLAYBACK + FUNC_APPS[name]
    rj, rt = MultiRun(J, text), MultiRun(T, text)
    for i, (stream, rows) in enumerate(func_app_sends(name)):
        rj.send(stream, rows)
        rt.send(stream, rows)
        if name == "aggregator_argument":
            assert nan_sign_free(rt.rows) == nan_sign_free(rj.rows), \
                f"{name}: send {i}"
        else:
            assert rt.rows == rj.rows, f"{name}: send {i}"
        assert rt.stats() == rj.stats(), f"{name}: send {i}"
    assert rt.rows, f"{name}: the feed gave no rows"
    if name.startswith("pattern"):
        engine = rt.rt.queries["q"].engine
        want = ParallelNfaEngine if name == "pattern_parallel" else NfaEngine
        assert type(engine) is want, type(engine)
    if name == "table":
        q = "from T on math:abs(v) > 1L select s, maximum(v, 2L) as m, " \
            "coalesce(d, 0.0) as d"
        got, want = ([tuple(norm(x) for x in r) for r in run.rt.query(q)]
                     for run in (rt, rj))
        assert sorted(got, key=repr) == sorted(want, key=repr) and got


CLOCK_APPS = {
    "aggregating selector and having": """
        define stream S (a int, b double);
        @info(name = 'q') from S#window.length(3)
        select a, eventTimestamp() as ts, currentTimeMillis() as now,
               count() as n
        having eventTimestamp() > 0L insert into Out;""",
    "pattern selector": """
        define stream S (a int, b double);
        @info(name = 'q') from every e1=S[a > 0] -> e2=S[a > e1.a]
        select e1.a as a1, e2.a as a2, eventTimestamp() as ts,
               currentTimeMillis() as now insert into Out;""",
    "join selector": """
        define stream L (a int, b double); define stream R (a int, b double);
        @info(name = 'q') from L#window.length(3) join R#window.length(3)
        on L.a == R.a select L.a as la, R.b as rb, eventTimestamp() as ts
        insert into Out;""",
    # K7: the trigger row's timestamp in a residual conjunct and in a grid
    "join residual": """
        define stream L (a int, b double); define stream R (a int, b double);
        @info(name = 'q') from L#window.length(3) join R#window.length(3)
        on L.a == R.a and eventTimestamp() % 2L == 0L
        select L.a as la, R.b as rb insert into Out;""",
    "join grid": """
        define stream L (a int, b double); define stream R (a int, b double);
        @info(name = 'q') from L#window.length(3) join R#window.length(3)
        on eventTimestamp() > 1010L select L.a as la, R.b as rb
        insert into Out;""",
    # K8: the event's timestamp in an update-or-insert ON, a SET value
    # and a stream-table join's ON
    "table conditions": """
        define stream L (a int, b double); define stream R (a int, b double);
        define table Tb (a int, b double, t long);
        from L select a, b, eventTimestamp() as t update or insert into Tb
        on Tb.a == a and Tb.t < eventTimestamp();
        @info(name = 'q') from R join Tb on Tb.a == R.a
        and Tb.t <= eventTimestamp() select R.a as ra, Tb.t as tt
        insert into Out;"""}


@pytest.mark.parametrize("name", sorted(CLOCK_APPS))
def test_clock_functions_in_selectors_equal_the_reference(name):
    """eventTimestamp() and currentTimeMillis() in the selectors that run
    in K2 over a batch: an aggregating one with having, a pattern's over
    its match batch, a join's over the joined rows (playback clock);
    eventTimestamp() in a join's ON (the trigger row's) and in a table's
    conditions (the event's)."""
    text = PLAYBACK + CLOCK_APPS[name]
    rj, rt = MultiRun(J, text), MultiRun(T, text)
    streams = ["S"] if "S (" in CLOCK_APPS[name] else ["L", "R"]
    for k in range(8):
        for s in streams:
            rows = [(1000 + 10 * k + r + (5 if s == "R" else 0),
                     (r % 3, float(k))) for r in range(4)]
            rj.send(s, rows)
            rt.send(s, rows)
    assert rt.rows == rj.rows and rt.rows
