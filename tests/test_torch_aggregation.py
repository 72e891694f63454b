"""Incremental aggregation (kernel K11's plain version, on the CPU)
against the reference: the same app text and the same feed go through the
reference's SiddhiManager and the port's.

- ``bucket_start`` of every duration equals the reference's, exactly,
  over seeded int64 timestamps: negative ones, leap days, the first and
  last millisecond of buckets, and the int64 extremes;
- the whole per-duration state (keys, used, bucket starts, group values
  and nulls, every lane, overflow) after every send, bit for bit: all
  five aggregators over INT, LONG and DOUBLE arguments with nulls, a
  STRING and an INT group key, every duration, event times out of order
  and before 1970;
- the ``within ... per`` rows of every duration, and the on-demand
  executor's selection, filter, order and limit over them;
- a reference state carried across with ``carry.aggregation_from_jax``
  that then goes on.

The float-order, overflow and group-key feeds and the replays of the
reference's own cases are in test_torch_aggregation_2.py. STRING group
columns hold dictionary codes and the slot keys hash them: the module
aligns both string tables first (test_torch_window.align_strings)."""
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import siddhi_tpu as J
import siddhi_tpu_torch as T
from siddhi_tpu.core.aggregation import bucket_start as j_bucket_start
from siddhi_tpu.core.types import GLOBAL_STRINGS as JSTR
from siddhi_tpu_torch.carry import aggregation_from_jax
from siddhi_tpu_torch.core.aggregation import DURATIONS
from siddhi_tpu_torch.core.aggregation import bucket_start as t_bucket_start
from siddhi_tpu_torch.core.types import GLOBAL_STRINGS as TSTR
from test_torch_join_shapes import leaves
from test_torch_window import align_strings

torch.set_num_threads(1)

SYMS = ("AGA", "AGB", "AGC")
APP = """
@app:playback
define stream S (sym string, room int, i int, l long, d double, ts long);
define aggregation A from S
select sym, room, sum(i) as si, avg(i) as ai, count() as n, min(i) as mi,
       max(i) as xi, sum(l) as sl, avg(l) as al, min(l) as ml, max(l) as xl,
       sum(d) as sd, avg(d) as ad, min(d) as md, max(d) as xd
group by sym, room
aggregate by ts every sec ... year;
"""
SELECT = ("sym, room, si, ai, n, mi, xi, sl, al, ml, xl, sd, ad, md, xd, "
          "AGG_TIMESTAMP")
SEND_SIZES = (16, 100, 700, 3, 1024, 40)


def aligned(names) -> None:
    """Give ``names`` one code in both string tables (group slots hash
    the codes): test_torch_window.align_strings for those new to both."""
    fresh = [n for n in names if n not in JSTR._to_code
             and n not in TSTR._to_code]
    if fresh:
        align_strings(fresh)
    for n in names:
        assert JSTR.encode(n) == TSTR.encode(n), n


def norm(v):
    if isinstance(v, float):
        return ("f", struct.pack("<d", v))
    return v


def snapshot_leaves(ar) -> dict:
    return dict(leaves(ar.snapshot_state(), "", (), None))


def compare_states(ja, ta, what: str) -> None:
    sj, st = snapshot_leaves(ja), snapshot_leaves(ta)
    assert sj.keys() == st.keys(), what
    for k in sj:
        assert sj[k].shape == st[k].shape and (sj[k] == st[k]).all(), \
            f"{what}: {k} differs"


# -- bucket_start ------------------------------------------------------------

def _civil_ms(y, m, d):
    return int(np.datetime64(f"{y:04d}-{m:02d}-{d:02d}", "ms").astype(
        np.int64))


def bucket_inputs(seed: int = 3) -> np.ndarray:
    rng = np.random.default_rng(seed)
    ts = [rng.integers(-10 ** 13, 10 ** 13, 600),
          rng.integers(-2 ** 62, 2 ** 62, 200),
          rng.integers(-10 ** 9, 10 ** 9, 200)]
    special = [0, -1, 1, 2 ** 63 - 1, -2 ** 63, -2 ** 63 + 1, 2 ** 63 - 2]
    for y, m, d in ((2000, 2, 29), (2000, 3, 1), (1900, 2, 28),
                    (1900, 3, 1), (2100, 2, 28), (2100, 3, 1),
                    (1969, 12, 31), (1970, 1, 1), (2026, 1, 1),
                    (1600, 2, 29), (1, 1, 1), (2400, 2, 29)):
        t = _civil_ms(y, m, d)
        special += [t - 1, t, t + 1, t + 86_399_999, t + 86_400_000]
    ts.append(np.array(special, np.int64))
    base = np.concatenate(ts).astype(np.int64)
    # the first and last millisecond of each sampled bucket, every duration
    edges = []
    for dur in DURATIONS:
        b = np.asarray(j_bucket_start(jnp.asarray(base[:300]), dur))
        edges += [b, b - 1]
    return np.concatenate([base] + edges)


@pytest.mark.parametrize("duration", DURATIONS)
def test_bucket_start_equals_reference(duration):
    ts = bucket_inputs()
    ref = np.asarray(j_bucket_start(jnp.asarray(ts), duration))
    got = t_bucket_start(torch.from_numpy(ts), duration).numpy()
    assert (got == ref).all(), ts[got != ref][:5]


# -- the whole state after every send -----------------------------------------

def feed(seed: int = 21):
    """Row sends of SEND_SIZES rows: nulls in every argument, event times
    out of order across centuries (before 1970 too) and bunched around
    2026-01-01 (many rows a bucket)."""
    rng = np.random.default_rng(seed)
    sends = []
    t = 1_000
    for k, n in enumerate(SEND_SIZES):
        rows = []
        for _ in range(n):
            t += int(rng.integers(0, 3))
            if k % 2:
                ets = int(rng.integers(-3 * 10 ** 12, 3 * 10 ** 12))
            else:
                ets = 1_767_225_600_000 + int(rng.integers(-90_000, 90_000))
            vals = [SYMS[int(rng.integers(0, 3))], int(rng.integers(0, 4)),
                    int(rng.integers(-2 ** 31, 2 ** 31)),
                    int(rng.integers(-2 ** 62, 2 ** 62)),
                    float(rng.normal() * 10.0 ** rng.integers(-3, 6)), ets]
            for c in range(5):
                if rng.random() < 0.12:
                    vals[c] = None
            rows.append((t, tuple(vals)))
        sends.append(rows)
    return sends


class AggRun:
    def __init__(self, pkg, text=APP, agg="A"):
        self.pkg = pkg
        kw = {"device": "cpu"} if pkg is T else {}
        self.rt = pkg.SiddhiManager(**kw).create_siddhi_app_runtime(text)
        self.rt.start()
        self.ar = self.rt.aggregations[agg]

    def send(self, stream, rows):
        self.rt.get_input_handler(stream).send(
            [self.pkg.Event(timestamp=ts, data=r) for ts, r in rows])

    def query(self, q):
        return [tuple(norm(v) for v in r) for r in self.rt.query(q)]


@pytest.fixture(scope="module")
def runs():
    aligned(SYMS)
    rj, rt = AggRun(J), AggRun(T)
    for i, rows in enumerate(feed()):
        for r in (rj, rt):
            r.send("S", rows)
        compare_states(rj.ar, rt.ar, f"send {i}")
    return rj, rt


def test_states_equal_after_every_send(runs):
    rj, rt = runs
    compare_states(rj.ar, rt.ar, "end")
    assert int(rt.ar.state["used"].sum()) > 500


@pytest.mark.parametrize("per", DURATIONS + ("sec", "min", "hour", "day",
                                             "month", "year"))
def test_within_per_rows(runs, per):
    rj, rt = runs
    for within in ("within 1767225600000L, 1767225660000L",
                   "within -5000000000000L, 5000000000000L",
                   "within 0L"):
        q = f"from A {within} per '{per}' select {SELECT}"
        assert rt.query(q) == rj.query(q), q
    q = f"from A per '{per}' select {SELECT}"
    assert rt.query(q) == rj.query(q)


@pytest.mark.parametrize("q", [
    "from A within 0L, 2000000000000L per 'hours' select sym, sum(n) as tn "
    "group by sym order by sym",
    "from A per 'days' select room, max(xd) as m, avg(ad) as a, count() "
    "as c group by room order by room desc limit 3",
    "from A on n > 1 within 1767225600000L per 'seconds' select sym, room, "
    "n, AGG_TIMESTAMP order by AGG_TIMESTAMP limit 10 offset 2",
    "from A per 'months' select * order by sd",
])
def test_on_demand_over_rows(runs, q):
    rj, rt = runs
    assert rt.query(q) == rj.query(q)


@pytest.mark.parametrize("q, err", [
    ("from A select sym", "per"),
    ("from A within 0L per 'weeks' select sym", "no duration"),
    ("from A within 0L per 'fortnights' select sym", "no duration"),
])
def test_query_errors(runs, q, err):
    rj, rt = runs
    for r in (rj, rt):
        with pytest.raises(Exception, match=err):
            r.rt.query(q)


def test_carried_state_goes_on():
    """A reference state after three sends, carried into a fresh port
    runtime, then both take the rest of the feed."""
    aligned(SYMS)
    sends = feed(seed=22)
    rj, rt = AggRun(J), AggRun(T)
    for rows in sends[:3]:
        rj.send("S", rows)
    snap = rj.ar.snapshot_state()
    rt.ar.restore_state(aggregation_from_jax(snap, "cpu",
                                             string_cols=(True, False)))
    compare_states(rj.ar, rt.ar, "carried")
    for i, rows in enumerate(sends[3:]):
        for r in (rj, rt):
            r.send("S", rows)
        compare_states(rj.ar, rt.ar, f"send {i + 3}")
    q = f"from A within 0L per 'minutes' select {SELECT}"
    assert rt.query(q) == rj.query(q)


@pytest.mark.parametrize("text, err", [
    ("define aggregation A from Nope select count() as n "
     "aggregate every sec;", "undefined stream"),
    ("define stream S (a int, t int); define aggregation A from S "
     "select count() as n aggregate by t every sec;", "LONG"),
    ("define stream S (a int, t long); define aggregation A from S "
     "select a, count() as n group by a + 1 aggregate by t every sec;",
     "found"),   # the grammar takes attribute names only
    ("define stream S (a int, t long); define aggregation A from S "
     "select a + 1 as b, count() as n group by a aggregate by t every sec;",
     "group attributes"),
    ("define stream S (a int, b int, t long); define aggregation A from S "
     "select b, count() as n group by a aggregate by t every sec;",
     "group-by attribute"),
])
def test_planning_errors(text, err):
    for pkg in (J, T):
        kw = {"device": "cpu"} if pkg is T else {}
        with pytest.raises(Exception, match=err):
            pkg.SiddhiManager(**kw).create_siddhi_app_runtime(text)
