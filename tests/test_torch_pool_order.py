"""Order by, offset and limit (kernel G[K]), stream functions, a template
parameter before an aggregating selector and output rate limiting in a
tenant pool's chain against the reference's TenantPool, on the CPU,
where G[K] runs its plain version over the pool's slot axis.

checks.POOL_RADAR_TEMPLATE (``#pol2Cart`` then the eight highest
returns by ``cartZ desc, id``; the four farthest of a ``length(64)``
window with its maximum, ``${min_rho}`` gating both) runs 8 tenants,
each with its own gate (``pool_radar_bindings``), 300 rows of
``radar_feed`` each in chunks of 100, ``batch_max`` 128; after every
fair round each tenant's rows, the whole stacked states (free slots
included, carried through ``carry.pool_from_jax``) and the ``emitted``
counters equal the reference pool's, bit for bit, but pol2Cart's cartX
and cartY, which are XLA's cos and sin, within 2 ulp (ROADMAP Queue 3).
Three more templates against the reference pool: a rate-limited query,
whose limiter the reference pool does not apply (every row that passes
the filter arrives, in one round), a STRING order key, whose host edge
it does not apply either (the rows unordered, no limit), and ``#log``,
whose lines each round prints are the reference's as a multiset (the
reference's debug callback under vmap runs its slots in an order that
varies from run to run; the port prints slot by slot). The kept
differences are in ROADMAP Queue 3."""
import contextlib
import io
import struct

import jax
import numpy as np
import pytest
import torch

from siddhi_tpu_torch.checks import (POOL_RADAR_TEMPLATE,
                                     pool_radar_bindings, radar_feed)
from siddhi_tpu_torch.core.types import GLOBAL_STRINGS as TSTR
from test_torch_pool_chain import Pair, chunks
from test_torch_streamfn import ulp
from test_torch_window import align_strings

torch.set_num_threads(1)

PREFIX = "pro"
TENANTS = 8
ROWS = 300


def unpack(v):
    return struct.unpack("<d", v[1])[0]


def near(got, want, what):
    """Two tenants' rows: Near's (four values) with cartX and cartY
    within 2 ulp, everything else equal."""
    assert len(got) == len(want), what
    for (tg, eg, dg), (tw, ew, dw) in zip(got, want):
        assert (tg, eg, len(dg)) == (tw, ew, len(dw)), what
        if len(dg) == 4:
            assert (dg[0], dg[3]) == (dw[0], dw[3]), what
            assert all(ulp(unpack(a), unpack(b)) <= 2
                       for a, b in zip(dg[1:3], dw[1:3])), what
        else:
            assert dg == dw, what


class RadarPair(Pair):
    def check(self):
        rows, self.rows = self.rows, {}
        try:
            super().check()   # states and emitted counters, bit for bit
        finally:
            self.rows = rows
        for tid in {k[1] for k in rows}:
            near(rows.get(("t", tid), []), rows.get(("j", tid), []), tid)


@pytest.fixture(scope="module")
def radar():
    rng = np.random.default_rng(5)
    pair = RadarPair(POOL_RADAR_TEMPLATE, slots=8, max_tenants=8,
                     batch_max=128)
    rounds = 0
    feeds = {}
    for i in range(TENANTS):
        tid = f"r{i}"
        pair.add(tid, pool_radar_bindings(i))
        feeds[tid] = list(chunks(rng, *radar_feed(ROWS, seed=100 + i),
                                 lo=100, hi=101))
    while any(feeds.values()):
        for tid, fs in feeds.items():
            if fs:
                pair.send(tid, *fs.pop(0))
        rounds += pair.pump() > 0
    rounds += pair.flush()
    return pair, rounds


def test_pool_radar_rows_states_and_emitted_after_every_round(radar):
    pair, rounds = radar
    assert rounds >= 3
    for i in range(TENANTS):
        rows = pair.rows[("t", f"r{i}")]
        near_rows = [r for r in rows if len(r[2]) == 4]
        far_rows = [r for r in rows if len(r[2]) == 3]
        assert near_rows and far_rows
    stats, jst = pair.t.statistics(), pair.j.statistics()
    for tid, entry in stats["tenants"].items():
        assert entry["emitted"] == jst["tenants"][tid]["emitted"]


def test_each_tenants_gate_and_limits_hold(radar):
    """Each tenant's Near rows come from returns past its own
    ``min_rho``, at most 8 of a round's chunk (100 rows, 100 ms)."""
    pair = radar[0]
    for i in range(TENANTS):
        ts, (ids, _th, rho, _z) = radar_feed(ROWS, seed=100 + i)
        gate = pool_radar_bindings(i)["min_rho"]
        rows = [r for r in pair.rows[("t", f"r{i}")] if len(r[2]) == 4]
        assert all(rho[r[2][0]] > gate for r in rows)
        per_ts = {}
        for r in rows:
            per_ts[r[0] // 100] = per_ts.get(r[0] // 100, 0) + 1
        assert max(per_ts.values()) <= 8


SIMPLE = """
define stream S (k string, v double);
@info(name='q')
from S[v > ${lo:double}]BODY
insert into Out;
"""
TEMPLATES = {
    # the reference pool never reads a query's rate limiter
    "limiter": SIMPLE.replace("BODY",
                              " select k, v output last every 4 events"),
    # nor applies a STRING order-by's host edge
    "string_key": SIMPLE.replace("BODY",
                                 " select k, v order by k desc limit 2"),
}


def simple_feed(n: int, encode, seed: int):
    rng = np.random.default_rng(seed)
    keys = np.array([encode(f"{PREFIX}{i}") for i in range(5)], np.int32)
    ts = 1_000 + np.arange(n, dtype=np.int64)
    return ts, [keys[rng.integers(0, 5, n)], rng.uniform(0, 4, n)]


@pytest.fixture(scope="module", autouse=True)
def symbols():
    align_strings([f"{PREFIX}{i}" for i in range(5)])


@pytest.mark.parametrize("which", sorted(TEMPLATES))
def test_what_the_reference_pool_does_not_apply(which):
    pair = Pair(TEMPLATES[which], slots=2, max_tenants=2, batch_max=128)
    fed = {}
    for i, tid in enumerate(("a", "b")):
        pair.add(tid, {"lo": 1.0 + i})
        fed[tid] = simple_feed(16, TSTR.encode, seed=i)
        pair.send(tid, *fed[tid])
    assert pair.flush() == 1
    for i, tid in enumerate(("a", "b")):
        rows = pair.rows[("t", tid)]
        v = fed[tid][1][1]
        assert len(rows) == int((v > 1.0 + i).sum()) > 4


LOG = SIMPLE.replace("BODY", "#log('pool') select k, v")


def test_log_in_a_pool_prints_the_references_lines_each_round():
    pair = Pair(LOG, slots=4, max_tenants=4, batch_max=8)
    for i in range(3):
        pair.add(f"g{i}", {"lo": 0.5 * i})
        pair.send(f"g{i}", *simple_feed(20, TSTR.encode, seed=10 + i))
    printed = []
    while True:
        lines = {}
        for tag, pool in pair.pools():
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                n = pool.pump()
                jax.effects_barrier()
            lines[tag] = buf.getvalue().splitlines()
        pair.check()
        if not n:
            break
        assert sorted(lines["t"]) == sorted(lines["j"]) and lines["t"]
        printed.append(lines["t"])
    assert printed
