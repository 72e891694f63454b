"""A reference snapshot carried into the port, continued
(test_torch_persistence_carry.py's harness): a partition block with a
rate-limited port, and a reference tenant pool's whole snapshot through
``carry.pool_snapshot_from_jax`` onto a fresh port pool of the cron
template, held state by state against the reference pool after every
round. The feeds' strings carry this module's prefix."""
import pytest
import torch

import siddhi_tpu_torch as T
from siddhi_tpu_torch import carry
from siddhi_tpu_torch.checks import pool_cron_bindings, pool_cron_feed
from siddhi_tpu_torch.core.persistence import deserialize
from test_torch_persistence_carry import carried
from test_torch_pool_cron import CronPair
from test_torch_window import align_strings

torch.set_num_threads(1)

PFX = "pcar2_"
SYMS = [PFX + s for s in ("a", "b", "c", "d")]


@pytest.fixture(scope="module", autouse=True)
def strings():
    align_strings(SYMS)


def sym(i):
    return SYMS[i % len(SYMS)]


def test_partition_with_a_rate_limited_port():
    ql = """
        @app:playback
        define stream S (sym string, v int);
        partition with (sym of S) begin
          @info(name = 'pq') from S#window.length(3)
          select sym, sum(v) as t output last every 2 events
          insert into Out;
        end;
    """
    before = [("S", 1000 + i, (sym(i), i)) for i in range(9)]
    after = [("S", 1100 + i, (sym(i + 2), 10 + i)) for i in range(9)]
    t, j, trt, jrt = carried(ql, before, after)
    assert t == j and t["Out"]


def test_a_reference_pool_snapshot():
    """The cron pool: the reference pool runs three rounds and
    snapshots; a fresh port pool restores it and both take two more,
    held state by state after each."""
    src = CronPair(slots=8, max_tenants=8, batch_max=64)
    for i in range(4):
        src.add(f"c{i}", pool_cron_bindings(i))

    def round_(pair, r):
        for i in range(4):
            pair.send(f"c{i}", *pool_cron_feed(64, seed=i * 10 + r,
                                               t0=30_000 + 64 * r))
        pair.pump()
    for r in range(3):
        round_(src, r)
    data = src.j.snapshot()
    fresh = CronPair(mgrs={"j": src.mgrs["j"],
                           "t": T.SiddhiManager(device="cpu")},
                     slots=2, max_tenants=8, batch_max=64)
    fresh.j = src.j
    fresh.t.restore(carry.pool_snapshot_from_jax(deserialize(data),
                                                 fresh.t))
    fresh.check()
    assert fresh.t._tenants == src.j._tenants and fresh.t._rounds == 3
    for r in range(3, 5):
        round_(fresh, r)
    assert int(fresh.t._emitted["sums"].sum()) > 0
