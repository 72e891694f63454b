"""Checkpoint and recovery of a tenant pool (siddhi_tpu_torch/serving/
pool.py snapshot_tenant, restore_tenant, snapshot, persist, restore,
restore_revision, replay_errors and resilience/supervisor.py's
PoolCheckpointSupervisor) against the reference's TenantPool, on the
CPU, over test_torch_pool_cron.py's template (a cron window, kernel
K5c[K], and a grouped lengthBatch sum, K5[K] and K6[K]).

Six tenants, 128 rows each a round, ``batch_max`` 128: the lengthBatch
closes every second round. Tenant c2's callback raises on its first
delivery (round 2), so those rows land in its error-store partition. A
PoolCheckpointSupervisor(interval_rounds=4) persists after round 4,
where it stops; rounds 5-8 run on. Then a fresh pool of the same template and manager,
two slots wide, ``recover``s onto the round-4 revision (eight slots),
replays c2's partition in original-timestamp order through its healed
callback, and takes rounds 5-8: after every round its rows, whole
stacked states and ``emitted`` counters equal the fresh reference
pool's, and at the end the uninterrupted pool's, bit for bit. Last, one
tenant's slot is snapshotted, moved on a round and restored: its slot
equals the snapshot and every other slot stays as it was."""
import numpy as np
import pytest
import torch

import siddhi_tpu_torch as T
import siddhi_tpu as J
from siddhi_tpu_torch.checks import pool_cron_bindings, pool_cron_feed
from test_torch_pool_chain import host_leaves, norm
from test_torch_pool_cron import CronPair

torch.set_num_threads(1)

ROWS = 128
TENANTS = 6
BAD = "c2"


def tenant_feed(i: int, r: int):
    return pool_cron_feed(ROWS, seed=2000 * i + r, t0=20_000 + r * ROWS)


def attach(pair, tid, fails=0):
    """Per-package callbacks recording the tenant's rows; the first
    ``fails`` deliveries raise."""
    for tag, pool in pair.pools():
        left = [fails]

        def cb(evs, tag=tag, tid=tid, left=left):
            if left[0]:
                left[0] -= 1
                raise RuntimeError("sink down")
            pair.rows.setdefault((tag, tid), []).extend(
                (e.timestamp, e.is_expired, tuple(norm(x) for x in e.data))
                for e in evs)
        pool.add_callback(tid, cb)


def rounds(pair, first, n):
    for r in range(first, first + n):
        for i in range(TENANTS):
            pair.send(f"c{i}", *tenant_feed(i, r))
        assert pair.pump() == ROWS * TENANTS


def states_of(pool):
    """Copies of every stacked state and counter (restore_tenant writes
    the live tensors in place)."""
    return {qn: [x.copy() for x in host_leaves(pool._states[qn])]
            for qn in pool._order}, \
        {qn: pool._emitted[qn].numpy().copy() for qn in pool._order}


@pytest.fixture(scope="module")
def recovery():
    live = CronPair(slots=8, max_tenants=8, batch_max=ROWS)
    for i in range(TENANTS):
        for _tag, pool in live.pools():
            pool.add_tenant(f"c{i}", pool_cron_bindings(i))
        attach(live, f"c{i}", fails=1 if f"c{i}" == BAD else 0)
    sups = {tag: (J if tag == "j" else T).PoolCheckpointSupervisor(
        pool, interval_rounds=4) for tag, pool in live.pools()}
    rounds(live, 0, 4)
    for sup in sups.values():   # the crash point: rounds 5-8 run on as
        sup.stop()              # the uninterrupted pools
    stored = {tag: [(r.origin, r.events) for r in pool.proto._error_store()
                    .peek(pool.tenant_partition(BAD))]
              for tag, pool in live.pools()}
    rounds(live, 4, 4)
    # the crash: a fresh pool of the same template and managers
    fresh = CronPair(mgrs=live.mgrs, slots=2, max_tenants=8,
                     batch_max=ROWS)
    restored = {}
    for tag, pool in fresh.pools():
        sup = (J if tag == "j" else T).PoolCheckpointSupervisor(pool)
        restored[tag] = sup.recover(replay_errors=False)
    fresh.check()
    for i in range(TENANTS):
        attach(fresh, f"c{i}")
    replayed = {tag: pool.replay_errors() for tag, pool in fresh.pools()}
    fresh.check()
    n_replayed = len(fresh.rows.get(("t", BAD), []))
    rounds(fresh, 4, 4)
    return live, fresh, sups, stored, restored, replayed, n_replayed


def test_supervisor_checkpoints_at_the_round_boundary(recovery):
    live, _fresh, sups, *_ = recovery
    for tag, pool in live.pools():
        assert sups[tag].checkpoints == 1 and sups[tag].failures == 0
        revs = pool.proto._persistence_store().list_revisions(pool.name)
        assert len(revs) == 1 and sups[tag].last_revision == revs[-1]
    rec = live.t.statistics()["recovery"]
    assert rec["checkpoints"] == 1 and rec["checkpoint_failures"] == 0


def test_failed_deliveries_land_in_the_tenant_partition(recovery):
    live, _fresh, _sups, stored, *_ = recovery
    assert stored["t"] == stored["j"]
    (origin, events), = stored["t"]
    assert origin == "Out" and len(events) > 0
    assert live.t.statistics()["tenants"][BAD]["errors"] == len(events)


def test_recover_restores_the_round_4_revision(recovery):
    live, fresh, _sups, _stored, restored, *_ = recovery
    for tag, pool in live.pools():
        revs = pool.proto._persistence_store().list_revisions(pool.name)
        assert restored[tag] == (revs[0], 0)
    assert fresh.t.slots == 8 and fresh.t._rounds == 8
    rec = fresh.t.statistics()["recovery"]
    assert rec["restored_tenants"] == TENANTS
    assert rec["restored_revision"] == restored["t"][0]


def test_replay_in_original_timestamp_order(recovery):
    _live, fresh, _sups, stored, _restored, replayed, n = recovery
    assert replayed["t"] == replayed["j"] == {BAD: n}
    events = stored["t"][0][1]
    assert n == len(events)
    got = fresh.rows[("t", BAD)][:n]
    assert got == fresh.rows[("j", BAD)][:n]
    want = sorted(events, key=lambda e: e[0])
    assert [(ts, exp) for ts, exp, _d in got] == \
        [(ts, exp) for ts, _d, exp in want]
    assert [d for _ts, _e, d in got] == \
        [tuple(norm(x) for x in d) for _ts, d, _e in want]


def test_the_recovered_pool_continues_as_the_uninterrupted_one(recovery):
    live, fresh, *_ = recovery
    a, b = states_of(live.t), states_of(fresh.t)
    for qn in live.t._order:
        assert len(a[0][qn]) == len(b[0][qn])
        for x, y in zip(a[0][qn], b[0][qn]):
            assert x.dtype == y.dtype and np.array_equal(x, y), qn
        assert np.array_equal(a[1][qn], b[1][qn]), qn
    for i in range(TENANTS):
        tid = f"c{i}"
        tail = [r for r in live.rows[("t", tid)] if r[0] >= 20_000 +
                4 * ROWS]
        skip = len(fresh.rows[("t", tid)]) - len(tail)
        assert tail and fresh.rows[("t", tid)][skip:] == tail, tid


def test_restore_tenant_leaves_the_other_slots_alone(recovery):
    _live, fresh, *_ = recovery
    snaps = {tag: pool.snapshot_tenant("c1") for tag, pool in fresh.pools()}
    at_snap = states_of(fresh.t)
    rounds(fresh, 8, 1)
    moved = states_of(fresh.t)
    for tag, pool in fresh.pools():
        pool.restore_tenant("c1", snaps[tag])
    fresh.check()
    back = states_of(fresh.t)
    slot = fresh.t._tenants["c1"]
    changed = False
    for qn in fresh.t._order:
        for x0, x1, x2 in zip(at_snap[0][qn], moved[0][qn], back[0][qn]):
            others = np.arange(x1.shape[0]) != slot
            assert np.array_equal(x2[others], x1[others]), qn
            assert np.array_equal(x2[slot], x0[slot]), qn
            changed |= not np.array_equal(x1[slot], x0[slot])
        e0, e1, e2 = at_snap[1][qn], moved[1][qn], back[1][qn]
        assert e2[slot] == e0[slot]
        assert np.array_equal(np.delete(e2, slot), np.delete(e1, slot))
    assert changed


def test_a_reference_snapshot_is_refused(recovery):
    _live, fresh, *_ = recovery
    with pytest.raises(ValueError, match="carry.pool_snapshot_from_jax"):
        fresh.t.restore(fresh.j.snapshot())
