"""Tenant pools of the chain class (siddhi_tpu_torch/serving/pool.py:
K1[K], K2 with template parameters, K5[K]; their plain versions on the
CPU) against the reference's TenantPool, on the CPU.

The headline template (the reference bench's TENANT_TEMPLATE) runs 6
tenants from ``slots=2`` (two doublings), 700 rows a tenant in uneven
chunks, ``batch_max`` 128; after EVERY fair round each tenant's callback
rows (timestamp, kind, values, floats by their bits), the whole stacked
states (free slots included, carried through ``carry.pool_from_jax``)
and the ``emitted`` counters are equal, bit for bit. Then churn: a
tenant leaves and one with other bindings takes the freed slot. Two more
templates: STRING, BOOL, INT and LONG parameters with a parameter in the
select; and a two-query template (a filter into ``Mid``, then a
timeBatch window) whose hop runs the stacked-batch flavour, driven by
``advance_time`` with no traffic. The admission errors (slots exhausted,
state quota, ingest backlog) carry the reference's causes and reasons.
The plain versions of K1[K] and of K2's parameter load are held against
the reference's vmapped decode and step on the same buffer and batch.

The string bindings carry this module's prefix and are interned in both
packages' string tables in one order first, so their codes agree."""
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import siddhi_tpu as J
import siddhi_tpu_torch as T
from siddhi_tpu.core.ingest import unpack_buffer as j_unpack
from siddhi_tpu.core.types import GLOBAL_STRINGS as JSTR
from siddhi_tpu.serving import AdmissionError as JAdm
from siddhi_tpu.serving import TemplateRegistry as JRegistry
from siddhi_tpu_torch import carry
from siddhi_tpu_torch.checks import (TENANT_TEMPLATE, tenant_bindings,
                                     tenant_data)
from siddhi_tpu_torch.core.event import EventBatch
from siddhi_tpu_torch.core.ingest import unpack_packed, unpack_packed_ref
from siddhi_tpu_torch.core.types import GLOBAL_STRINGS as TSTR
from siddhi_tpu_torch.serving import AdmissionError as TAdm
from siddhi_tpu_torch.serving import TemplateRegistry as TRegistry
from test_torch_window import align_strings

torch.set_num_threads(1)

PFX = "pc_"
WHO = [PFX + s for s in ("alpha", "beta", "gamma")]

TYPED = """
define stream In (s string, n int, b bool, v double);
@info(name='q')
from In[s == ${who:string} and n > ${lim:int} and b == ${flag:bool}]
select s, n, v, ${tag:long} as tag, v * ${scale:double} as sv
insert into Out;
"""

TWO_QUERIES = """
define stream In (v double, k long);
@info(name='f')
from In[v > ${lo:double}] select v, k insert into Mid;
@info(name='w')
from Mid#window.timeBatch(50) select v, k insert into Out;
"""


def norm(v):
    if isinstance(v, float):
        return ("f", struct.pack("<d", v))
    return v


def host_leaves(tree):
    """Every tensor of a state pytree as numpy, floats as their bits."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in host_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in host_leaves(v)]
    a = tree.numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)
    if a.dtype.kind == "f":
        a = a.view(np.int64 if a.itemsize == 8 else np.int32)
    return [a]


class Pair:
    """One template as a reference pool and a port pool (CPU), each
    tenant's callback rows recorded per package."""

    def __init__(self, text, **kw):
        self.j = JRegistry(J.SiddhiManager()).pool(text, warm=False, **kw)
        self.t = TRegistry(T.SiddhiManager(device="cpu")).pool(
            text, warm=False, **kw)
        self.rows = {}

    def pools(self):
        return (("j", self.j), ("t", self.t))

    def add(self, tid, bindings=None):
        slots = []
        for tag, pool in self.pools():
            slots.append(pool.add_tenant(tid, bindings))
            pool.add_callback(tid, lambda evs, tag=tag, tid=tid:
                              self.rows.setdefault((tag, tid), []).extend(
                                  (e.timestamp, e.is_expired,
                                   tuple(norm(x) for x in e.data))
                                  for e in evs))
        assert slots[0] == slots[1]
        return slots[1]

    def remove(self, tid):
        assert self.j.remove_tenant(tid) == self.t.remove_tenant(tid)

    def send(self, tid, ts, cols, stream=None):
        for _tag, pool in self.pools():
            pool.send(tid, ts, cols, stream=stream)

    def pump(self):
        n = [pool.pump() for _tag, pool in self.pools()]
        assert n[0] == n[1]
        self.check()
        return n[1]

    def flush(self):
        rounds = 0
        while self.pump():
            rounds += 1
        return rounds

    def advance_time(self, now):
        for _tag, pool in self.pools():
            pool.advance_time(now)
        self.check()

    def check(self):
        j, t = self.j, self.t
        assert t.slots == j.slots and t._free == j._free
        assert t._tenants == j._tenants
        assert t._now == j._now
        tids = {k[1] for k in self.rows}
        for tid in tids:
            assert self.rows.get(("t", tid), []) == \
                self.rows.get(("j", tid), []), tid
        states, emitted = carry.pool_from_jax(
            jax.tree_util.tree_map(np.asarray, j._states),
            {qn: np.asarray(e) for qn, e in j._emitted.items()}, "cpu",
            j._kind)
        for qn in j._order:
            a, b = host_leaves(states[qn]), host_leaves(t._states[qn])
            assert len(a) == len(b), qn
            for x, y in zip(a, b):
                assert x.shape == y.shape and x.dtype == y.dtype, qn
                assert np.array_equal(x, y), qn
            assert np.array_equal(emitted[qn].numpy(),
                                  t._emitted[qn].numpy()), qn


def chunks(rng, ts, cols, lo=1, hi=300):
    at = 0
    while at < len(ts):
        n = int(rng.integers(lo, hi))
        yield ts[at:at + n], [c[at:at + n] for c in cols]
        at += n


@pytest.fixture(scope="module")
def headline():
    """TENANT_TEMPLATE: 6 tenants joining while rounds run (slots 2 -> 4
    -> 8), 700 rows each in uneven chunks, then churn; every round
    checked."""
    rng = np.random.default_rng(3)
    pair = Pair(TENANT_TEMPLATE, slots=2, max_tenants=8, batch_max=128)
    feeds = {}
    rounds = 0
    for i in range(6):
        tid = f"t{i}"
        pair.add(tid, tenant_bindings(i))
        ts, cols = tenant_data(700, seed=100 + i)
        feeds[tid] = list(chunks(rng, ts, cols))
        for tid2, fs in feeds.items():
            if fs:
                pair.send(tid2, *fs.pop(0))
        rounds += pair.pump() > 0
    for tid, fs in feeds.items():
        for ts, cols in fs:
            pair.send(tid, ts, cols)
    rounds += pair.flush()
    before = {tid: list(pair.rows.get(("t", tid), []))
              for tid in feeds}
    # churn: t2 leaves, t9 (other bindings) takes its slot (LIFO)
    slot2 = pair.t._tenants["t2"]
    pair.remove("t2")
    slot9 = pair.add("t9", {"lo": 30.5, "hi": 170.25})
    ts, cols = tenant_data(700, seed=9)
    for c in chunks(rng, ts + 1000, cols):
        pair.send("t9", *c)
    pair.send("t0", ts + 5000, cols)
    rounds += pair.flush()
    return pair, rounds, before, slot2, slot9


def test_headline_rows_states_and_emitted_after_every_round(headline):
    pair, rounds, before, _s2, _s9 = headline
    assert rounds >= 8
    assert pair.t.slots == 8 and pair.t._grows == 2
    for tid, rows in before.items():
        assert len(rows) == 512   # two full lengthBatch(256) windows
    stats = pair.t.statistics()
    jst = pair.j.statistics()
    for key in ("slots", "active", "max_tenants", "batch_max", "rounds",
                "dispatches", "grows", "state_bytes_per_tenant",
                "state_bytes_by_class"):
        assert stats["pool"][key] == jst["pool"][key], key
    for tid, entry in stats["tenants"].items():
        ref = jst["tenants"][tid]
        for key in ("slot", "emitted", "pending", "errors"):
            assert entry[key] == ref[key], (tid, key)
    for key in ("transfers_per_round", "rows_packed", "pad_frac", "bytes",
                "rounds", "streams"):
        assert stats["packed_ingest"][key] == jst["packed_ingest"][key], key
    assert stats["pool"]["state_bytes_per_tenant"] == 17952


def test_churn_reuses_the_freed_slot(headline):
    pair, _r, _b, slot2, slot9 = headline
    assert slot9 == slot2
    assert "t2" not in pair.t._tenants
    assert len(pair.rows[("t", "t9")]) > 0
    assert pair.rows[("t", "t9")] == pair.rows[("j", "t9")]


@pytest.fixture(scope="module")
def typed():
    align_strings(WHO + [PFX + "other"])
    rng = np.random.default_rng(4)
    pair = Pair(TYPED, slots=2, max_tenants=4, batch_max=128)
    binds = [{"who": WHO[0], "lim": 10, "flag": True, "tag": 2 ** 40,
              "scale": 0.5},
             {"who": WHO[1], "lim": -5, "flag": False, "tag": -7,
              "scale": 3},
             {"who": WHO[2], "lim": 2 ** 31 - 1, "flag": True, "tag": 0,
              "scale": -1.25}]
    codes = np.array([TSTR.encode(s) for s in WHO + [PFX + "other"]],
                     np.int32)
    assert [JSTR.encode(s) for s in WHO + [PFX + "other"]] == \
        codes.tolist()
    for i, b in enumerate(binds):
        pair.add(f"u{i}", b)
    for rnd in range(3):
        for i in range(3):
            n = int(rng.integers(20, 200))
            ts = 2000 + rnd * 1000 + np.arange(n, dtype=np.int64)
            cols = [codes[rng.integers(0, 4, n)],
                    rng.integers(-20, 40, n).astype(np.int32),
                    rng.integers(0, 2, n).astype(bool),
                    rng.uniform(-5, 5, n)]
            pair.send(f"u{i}", ts, cols)
        pair.flush()
    return pair


def test_string_bool_int_params_and_a_select_param(typed):
    pair = typed
    for i in range(3):
        rows = pair.rows.get(("t", f"u{i}"), [])
        assert rows == pair.rows.get(("j", f"u{i}"), [])
    assert sum(len(pair.rows.get(("t", f"u{i}"), [])) for i in range(3)) \
        > 20
    # the parameters' slot values: STRING as the port's code, BOOL,
    # INT wrapping in int32, LONG, DOUBLE as f64
    tp = {**pair.t._states["q"][0]["tparams"],
          **pair.t._states["q"][1]["tparams"]}
    assert tp["who"].dtype == torch.int32 and tp["flag"].dtype == torch.bool
    assert tp["lim"].dtype == torch.int32 and tp["tag"].dtype == torch.int64
    assert int(tp["lim"][pair.t._tenants["u2"]]) == 2 ** 31 - 1
    assert tp["who"][pair.t._tenants["u1"]] == TSTR.encode(WHO[1])


@pytest.fixture(scope="module")
def two_queries():
    rng = np.random.default_rng(5)
    pair = Pair(TWO_QUERIES, slots=4, max_tenants=4, batch_max=16)
    for i in range(3):
        pair.add(f"w{i}", {"lo": 10.0 * i})
    for rnd in range(4):
        for i in range(3):
            n = int(rng.integers(1, 16))
            ts = 3000 + rnd * 40 + np.sort(rng.integers(0, 40, n))
            pair.send(f"w{i}", ts.astype(np.int64),
                      [rng.uniform(0, 50, n),
                       rng.integers(0, 9, n, dtype=np.int64)])
        pair.pump()
    pair.advance_time(3000 + 4 * 40 + 10)    # no traffic: windows flush
    pair.advance_time(3000 + 4 * 40 + 200)
    return pair


def test_two_query_hop_and_advance_time(two_queries):
    pair = two_queries
    assert pair.t._order == ["f", "w"]
    total = sum(len(pair.rows.get(("t", f"w{i}"), [])) for i in range(3))
    assert total > 0
    for i in range(3):
        assert pair.rows.get(("t", f"w{i}"), []) == \
            pair.rows.get(("j", f"w{i}"), [])


def _reject(pool, fn):
    try:
        fn(pool)
    except (JAdm, TAdm) as e:
        sat = {k: e.saturation.get(k) for k in (
            "cause", "tenant", "active", "max_tenants",
            "state_bytes_per_tenant", "state_bytes_by_class",
            "pending_rows", "pending_cap", "rows")}
        return e.reason, sat
    return None


@pytest.mark.parametrize("case", ["slots", "quota", "backlog"])
def test_admission_errors_are_the_reference_ones(case):
    kw = {"slots": 2, "max_tenants": 4, "batch_max": 16}
    if case == "slots":
        kw["max_tenants"] = 2
    if case == "backlog":
        kw["pending_cap"] = 100
    if case == "quota":
        kw["state_quota_bytes"] = 2 * 17952 + 100
    out = []
    for reg in (JRegistry(J.SiddhiManager()),
                TRegistry(T.SiddhiManager(device="cpu"))):
        pool = reg.pool(TENANT_TEMPLATE, warm=False, **kw)
        pool.add_tenant("a", tenant_bindings(0))
        pool.add_tenant("b", tenant_bindings(1))
        ts, cols = tenant_data(60)
        pool.send("a", ts, cols)
        if case == "backlog":
            got = _reject(pool, lambda p: p.send("a", ts, cols))
        else:
            got = _reject(pool, lambda p: p.add_tenant("c",
                                                      tenant_bindings(2)))
        out.append((got, pool.admit(), pool.saturation()["rejections"]))
    assert out[0][0] is not None
    assert out[0] == out[1]


def test_k1_slotted_plain_version_against_the_reference():
    """K1[K]'s plain version on a round buffer of 4 slots (two idle,
    their rows zeros but for the round clock) against the reference's
    vmapped unpack_buffer on the same bytes."""
    pair = Pair(TENANT_TEMPLATE, slots=4, max_tenants=4, batch_max=128)
    per_slot = {}
    for slot, (n, seed) in {0: (100, 1), 2: (37, 2)}.items():
        ts, cols = tenant_data(n, seed=seed)
        per_slot[slot] = (ts + 11 * slot, cols)
    pair.j._now = pair.t._now = int(per_slot[0][0][-1])
    _k, (jbuf, jenc, cap) = pair.j._pack_round("In", per_slot, 128)
    _k, (tbuf, tenc, cap2) = pair.t._pack_round("In", per_slot, 128)
    assert jenc == tenc and cap == cap2
    big = np.array(jbuf)
    assert np.array_equal(big, tbuf.numpy())
    schema = pair.j.proto.junctions["In"].schema
    jb, jnow = jax.vmap(lambda b: j_unpack(schema, jenc, cap, b))(
        jnp.asarray(big))
    tb, tnow = unpack_packed(pair.t.proto.junctions["In"].schema.types,
                             tenc, cap, torch.from_numpy(big))
    for x, y in zip(host_leaves((jb.ts, jb.cols, jb.nulls, jb.kind,
                                 jb.valid)),
                    host_leaves((tb.ts, tb.cols, tb.nulls, tb.kind,
                                 tb.valid))):
        assert np.array_equal(x, y)
    assert int(tnow) == int(np.asarray(jnow)[0]) == pair.t._now
    # and slot by slot, the un-slotted plain version
    one, _now = unpack_packed_ref(
        pair.t.proto.junctions["In"].schema.types, tenc, cap,
        torch.from_numpy(big[2].copy()))
    assert torch.equal(one.ts, tb.ts[2]) and torch.equal(one.valid,
                                                          tb.valid[2])


def test_k2_parameter_load_against_the_reference_step(typed):
    """The typed template's step over a [4, 64] slotted batch, each slot
    with its own parameters (K2's parameter load, its plain version),
    against the reference's vmapped step on the same batch and states."""
    pair = typed
    rng = np.random.default_rng(6)
    K, B = pair.t.slots, 64
    codes = np.array([TSTR.encode(s) for s in WHO], np.int32)
    cols = [codes[rng.integers(0, 3, (K, B))],
            rng.integers(-20, 40, (K, B)).astype(np.int32),
            rng.integers(0, 2, (K, B)).astype(bool),
            rng.uniform(-5, 5, (K, B))]
    ts = 9000 + np.arange(K * B, dtype=np.int64).reshape(K, B)
    valid = rng.uniform(size=(K, B)) < 0.8
    zeros = [np.zeros((K, B), bool) for _ in cols]
    kind = np.zeros((K, B), np.int32)
    jbatch = J.core.event.EventBatch(
        ts=jnp.asarray(ts), cols=tuple(jnp.asarray(c) for c in cols),
        nulls=tuple(jnp.asarray(z) for z in zeros), kind=jnp.asarray(kind),
        valid=jnp.asarray(valid))
    tbatch = EventBatch(ts=torch.from_numpy(ts),
                        cols=tuple(torch.from_numpy(c) for c in cols),
                        nulls=tuple(torch.from_numpy(z) for z in zeros),
                        kind=torch.from_numpy(kind),
                        valid=torch.from_numpy(valid))
    core = pair.j._core_body("q", "*")
    jst, jem, jout = jax.vmap(core, in_axes=(0, 0, 0, None))(
        pair.j._states["q"], jnp.zeros((K,), jnp.int64), jbatch,
        jnp.int64(9500))
    tem = torch.zeros((K,), dtype=torch.int64)
    _tst, tout = pair.t._body("q", "*")(pair.t._states["q"], tem, tbatch,
                                        torch.tensor(9500))
    assert np.array_equal(np.asarray(jem), tem.numpy())
    assert int(tem.sum()) > 0
    for x, y in zip(host_leaves((jout.ts, jout.cols, jout.nulls,
                                 jout.kind, jout.valid)),
                    host_leaves((tout.ts, tout.cols, tout.nulls,
                                 tout.kind, tout.valid))):
        assert np.array_equal(x, y)


def test_unported_options_raise():
    reg = TRegistry(T.SiddhiManager(device="cpu"))
    with pytest.raises(NotImplementedError, match="not ported yet"):
        reg.pool(TENANT_TEMPLATE, warm=False, mesh=object())
    pool = reg.pool(TENANT_TEMPLATE, warm=False, slots=2)
    pool.add_tenant("a", tenant_bindings(0))
    # checkpoint, recovery and the error partitions are ported since
    # (test_torch_pool_persist.py)
    for call in (lambda: pool.migrate_tenant("a", 1),
                 lambda: pool.mark_device_lost(0),
                 lambda: pool.plan_hash(), lambda: pool.explain(),
                 lambda: pool.audit_programs()):
        with pytest.raises(NotImplementedError, match="not ported yet"):
            call()
    # order-by in a pool plans now: kernel G[K] over the slot axis
    # (test_torch_pool_order.py holds it against the reference)
    TRegistry(T.SiddhiManager(device="cpu")).pool("""
        define stream S (k string, v double);
        @info(name='q')
        from S#window.length(3) select k, v order by v
        insert into Out;""",
        warm=False)
