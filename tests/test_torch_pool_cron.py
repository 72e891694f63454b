"""A tenant pool with a cron window (kernel K5c[K], K5's cron kind over
the slot axis through siddhi_tpu_torch/ops/windows.py window_step; its
plain version on the CPU windows2.py cron_slots_ref) against the
reference's TenantPool, on the CPU.

checks.pool_cron_template(64): a cron window behind each tenant's
``${lo:double}`` filter into Buffered, beside a grouped lengthBatch(256)
sum into Out. Six tenants, 64 rows each a round, ``batch_max`` 64,
eight slots from the start; after every fair round and after
``advance_time`` each tenant's callback rows, the whole stacked states
(free slots included, carried through ``carry.pool_from_jax``) and the
``emitted`` counters equal the reference pool's, bit for bit. As in the
reference's pool, the cron window is never fired (the pool feeds no
TIMER row): Buffered gets no row in either package, and every tenant's
buffer equals a numpy oracle, the newest 64 rows that passed its filter
with the rest counted as overflow. The firing branch, which a pool never
runs, is held against the plain version of one stream, slot by slot."""
import numpy as np
import pytest
import torch

import siddhi_tpu as J
import siddhi_tpu_torch as T
from siddhi_tpu_torch.checks import (cron_buffer_oracle, pool_cron_bindings,
                                     pool_cron_feed, pool_cron_template)
from siddhi_tpu_torch.core.event import (CURRENT, TIMER, Attribute,
                                         EventBatch, StreamSchema)
from siddhi_tpu_torch.core.types import AttrType
from siddhi_tpu_torch.ops import windows2 as W2
from siddhi_tpu_torch.ops.windows import window_step
from siddhi_tpu_torch.ops.slots import per_slot, stacked
from siddhi_tpu.serving import TemplateRegistry as JRegistry
from siddhi_tpu_torch.serving import TemplateRegistry as TRegistry
from test_torch_pool_chain import Pair, host_leaves

torch.set_num_threads(1)

CAP = 64
ROWS = 64          # a tenant's rows a round
TENANTS = 6
TEXT = pool_cron_template(CAP)


class CronPair(Pair):
    """A Pair whose pools come from the given managers (``mgrs``: {"j":,
    "t":}, new ones by default) under one name, so that a second pair of
    the same managers finds the first one's revisions and error
    partitions; it also counts the valid rows each pool's rounds put on
    each terminal stream (``batch_callbacks``, before any decode)."""

    def __init__(self, text=TEXT, mgrs=None, name="pool_cron", **kw):
        self.mgrs = mgrs or {"j": J.SiddhiManager(),
                             "t": T.SiddhiManager(device="cpu")}
        self.j = J.TenantPool(JRegistry(self.mgrs["j"]).resolve(text),
                              manager=self.mgrs["j"], name=name, **kw)
        self.t = T.TenantPool(TRegistry(self.mgrs["t"]).resolve(text),
                              manager=self.mgrs["t"], name=name, **kw)
        self.rows = {}
        self.terminal = {"j": {}, "t": {}}
        for tag, pool in self.pools():
            pool.batch_callbacks.append(
                lambda term, tag=tag: self._count(tag, term))

    def _count(self, tag, terminal):
        for sid, outs in terminal.items():
            n = sum(int(np.asarray(o.valid).sum()) for o in outs)
            self.terminal[tag][sid] = self.terminal[tag].get(sid, 0) + n


def tenant_feed(i: int, r: int):
    """Tenant i's rows of round r (round r's clock for every tenant)."""
    return pool_cron_feed(ROWS, seed=1000 * i + r, t0=10_000 + r * ROWS)


def run_rounds(pair, rounds, first=0, tids=None):
    for r in range(first, first + rounds):
        for i, tid in enumerate(tids or sorted(pair.t._tenants)):
            pair.send(tid, *tenant_feed(i, r))
        assert pair.pump() == ROWS * len(tids or pair.t._tenants)


@pytest.fixture(scope="module")
def cron():
    pair = CronPair(slots=8, max_tenants=8, batch_max=ROWS)
    for i in range(TENANTS):
        pair.add(f"c{i}", pool_cron_bindings(i))
    run_rounds(pair, 6)
    pair.advance_time(10_000 + 6 * ROWS + 5_000)
    return pair


def test_rows_states_and_emitted_after_every_round(cron):
    stats, jst = cron.t.statistics(), cron.j.statistics()
    for tid, entry in stats["tenants"].items():
        assert entry["emitted"] == jst["tenants"][tid]["emitted"]
        # every tenant's lengthBatch closed a batch of 256 (one row a
        # group of each)
        assert entry["emitted"]["sums"] > 0
    for tid in cron.t._tenants:
        assert cron.rows[("t", tid)] == cron.rows[("j", tid)]


def test_no_cron_row_is_delivered(cron):
    for tag in ("j", "t"):
        assert cron.terminal[tag].get("Buffered", 0) == 0
        assert cron.terminal[tag]["Out"] > 0
    for tid in cron.t._tenants:
        # a Buffered row would lead with a double
        assert all(isinstance(d[0], int) for _ts, _e, d in
                   cron.rows[("t", tid)])
    assert cron.t.statistics()["tenants"]["c0"]["emitted"]["buffered"] == 0


def test_cron_buffers_equal_the_oracle(cron):
    st = cron.t._states["buffered"][1]
    for i in range(TENANTS):
        slot = cron.t._tenants[f"c{i}"]
        feeds = [tenant_feed(i, r) for r in range(6)]
        ts = np.concatenate([f[0] for f in feeds])
        v = np.concatenate([f[1][0] for f in feeds])
        k = np.concatenate([f[1][1] for f in feeds])
        wts, wseq, wv, wk, wovf = cron_buffer_oracle(
            ts, v, k, pool_cron_bindings(i)["lo"], CAP)
        cur = st["cur"]
        assert bool(cur["valid"][slot].all())
        assert np.array_equal(cur["ts"][slot].numpy(), wts)
        assert np.array_equal(cur["seq"][slot].numpy(), wseq)
        assert np.array_equal(cur["cols"][0][slot].numpy(), wv)
        assert np.array_equal(cur["cols"][1][slot].numpy(), wk)
        assert int(st["overflow"][slot]) == wovf > 0
        assert not bool(st["exp"]["valid"][slot].any())


SCHEMA = StreamSchema("In", (Attribute("v", AttrType.DOUBLE),
                             Attribute("k", AttrType.LONG)))


@pytest.mark.parametrize("expired", [True, False])
def test_the_firing_branch_slot_by_slot(expired):
    """The plain version of K5c[K] over every slot at once equals the
    one-stream step on each slot alone, through flushes (TIMER rows),
    overflow and nulls."""
    op = W2.CronWindowOp(SCHEMA, "*/1 * * * * ?", cap=16,
                         expired_enabled=expired)
    K, B = 5, 8
    rng = np.random.default_rng(1)
    st = stacked(op.init_state(), K)
    for step in range(12):
        batch = EventBatch(
            torch.from_numpy(rng.integers(0, 1000, (K, B))),
            (torch.from_numpy(rng.random((K, B))),
             torch.from_numpy(rng.integers(0, 9, (K, B)))),
            tuple(torch.from_numpy(rng.random((K, B)) < 0.1)
                  for _ in range(2)),
            torch.from_numpy(np.where(rng.random((K, B)) < 0.1, TIMER,
                                      CURRENT).astype(np.int32)),
            torch.from_numpy(rng.random((K, B)) < 0.8))
        got = window_step(op, st, batch, 777)
        want = per_slot(lambda s, b: op.step_ref(s, b, 777), K, st, batch)
        a, b = (host_leaves((st_, (o.ts, o.cols, o.nulls, o.kind, o.valid)))
                for st_, o in (got, want))
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y), step
        st = got[0]
    assert int(st["overflow"].sum()) > 0
