"""Kernel K9p's plain versions against the reference's own functions, and
a partition block carried from the reference into the port (carry.py
block_from_jax), on the CPU.

- route: ``parallel.partition.route_ref`` (the slots, the first-seen
  slot table and its overflow) against the reference's
  ``PartitionBlockRuntime._slots_for``, for a value key past its slots
  and for range conditions with unmatched rows, on one seeded batch;
- compaction: ``compact_ref`` against ``_flatten_compact`` at K * N =
  131,072 rows, 91,000 or so valid with many equal timestamps, so that
  65,536 are kept in (ts, slot, row) order and the rest are counted in
  ``lost``;
- carry: two blocks (a length window with avg, a ``within`` pattern) run
  half their feed in the reference; the block's state (slot table,
  [K]-stacked query states, emitted, lost) comes into the port, and
  both packages' next rows and final states are equal.

Tolerance 0 throughout (floats by their bits). The raw key codes of the
route test are the same integers in both packages; the carry feed's
strings carry this module's prefix and are interned in both tables in
one order first."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import siddhi_tpu as J
import siddhi_tpu_torch as T
from siddhi_tpu.core.event import EventBatch as JBatch
from siddhi_tpu.parallel.partition import (PartitionBlockRuntime as JBlock,
                                           _flatten_compact)
from siddhi_tpu_torch import checks as C
from siddhi_tpu_torch.carry import block_from_jax
from siddhi_tpu_torch.core.event import EventBatch as TBatch
from siddhi_tpu_torch.ops.expr import expr_eval
from siddhi_tpu_torch.parallel.partition import compact_ref, route_ref
from test_torch_window import align_strings, leaves

torch.set_num_threads(1)

PFX = "pk"


def _apps(text):
    """(reference runtime, port runtime) of one app, not started."""
    return (J.SiddhiManager().create_siddhi_app_runtime(text),
            T.SiddhiManager(device="cpu").create_siddhi_app_runtime(text))


def _batch(rng, B, codes, price):
    ts = np.sort(rng.integers(0, 50, B)).astype(np.int64)
    kind = np.where(rng.random(B) < 0.02, 2, 0).astype(np.int32)  # TIMER
    valid = rng.random(B) < 0.9
    cols = [codes, price, rng.integers(1, 99, B).astype(np.int64),
            rng.integers(0, 4, B).astype(np.int32)]
    nulls = [rng.random(B) < 0.03 for _ in cols]
    jb = JBatch(ts=jnp.asarray(ts), cols=tuple(jnp.asarray(c) for c in cols),
                nulls=tuple(jnp.asarray(n) for n in nulls),
                kind=jnp.asarray(kind), valid=jnp.asarray(valid))
    tb = TBatch(ts=torch.from_numpy(ts),
                cols=tuple(torch.from_numpy(c) for c in cols),
                nulls=tuple(torch.from_numpy(n) for n in nulls),
                kind=torch.from_numpy(kind), valid=torch.from_numpy(valid))
    return jb, tb


@pytest.mark.parametrize("app", ["value key, length window",
                                 "range key, time window"])
def test_route_equals_the_references_slots_for(app):
    text = C.PARTITION_APPS[app].replace("@slots('8')", "@slots('32')")
    jrt, trt = _apps(text)
    jblk, tblk = jrt.partitions["partition_1"], trt.partitions["partition_1"]
    K = tblk.K
    assert K == jblk.K
    rng = np.random.default_rng(7)
    B = 2048
    codes = rng.integers(1, 60, B).astype(np.int32)   # 59 keys, 32 slots
    price = np.round(rng.uniform(0, 100, B), 2)
    jb, tb = _batch(rng, B, codes, price)
    jtbl = jblk.slot_tbl
    ttbl = tblk.slot_tbl
    for step in range(2):   # a fresh table, then the one the step left
        jslots, jtbl = JBlock._slots_for(None, jblk.key_specs["S"], jb,
                                         jnp.int64(5), jtbl)
        spec = tblk.key_specs["S"]
        cols, nulls, _v = expr_eval(spec.program, tb, now=5)
        tslots, _vk, ttbl = route_ref(spec, cols, nulls, tb, ttbl, K)
        assert np.array_equal(np.asarray(jslots), tslots.numpy()), step
        for k in ("keys", "used", "overflow"):
            assert np.array_equal(np.asarray(jtbl[k]), ttbl[k].numpy()), k
    if app.startswith("value"):
        assert int(ttbl["overflow"]) > 0
    else:
        assert (tslots.numpy() == -1).any()


def test_compaction_equals_the_references_flatten_compact():
    rng = np.random.default_rng(8)
    K, N = 64, 2048
    ts = rng.integers(0, 300, (K, N)).astype(np.int64)
    valid = rng.random((K, N)) < 0.7
    kind = rng.integers(0, 2, (K, N)).astype(np.int32)
    cols = [rng.integers(-9, 9, (K, N)).astype(np.int32),
            rng.standard_normal((K, N))]
    nulls = [rng.random((K, N)) < 0.1 for _ in cols]
    cap = min(K * N, 65536)
    jpick, jlost = _flatten_compact(JBatch(
        ts=jnp.asarray(ts), cols=tuple(jnp.asarray(c) for c in cols),
        nulls=tuple(jnp.asarray(n) for n in nulls), kind=jnp.asarray(kind),
        valid=jnp.asarray(valid)), cap)
    emitted = torch.zeros((), dtype=torch.int64)
    lost = torch.zeros((), dtype=torch.int64)
    tpick = compact_ref(TBatch(
        ts=torch.from_numpy(ts), cols=tuple(torch.from_numpy(c) for c in cols),
        nulls=tuple(torch.from_numpy(n) for n in nulls),
        kind=torch.from_numpy(kind), valid=torch.from_numpy(valid)), cap,
        emitted, lost)
    for j, t in zip([jpick.ts, *jpick.cols, *jpick.nulls, jpick.kind,
                     jpick.valid],
                    [tpick.ts, *tpick.cols, *tpick.nulls, tpick.kind,
                     tpick.valid]):
        a, b = np.asarray(j), t.numpy()
        if a.dtype.kind == "f":
            a, b = a.view(np.int64), b.view(np.int64)
        assert np.array_equal(a, b)
    assert int(lost) == int(jlost) > 0
    assert int(emitted) == cap == int(np.asarray(jpick.valid).sum())


CARRY_APPS = ["value key, length window", "pattern, within"]


@pytest.fixture(scope="module")
def carry_symbols():
    names = [f"{PFX}{i:02d}" for i in range(6)]
    align_strings(names)
    return names


@pytest.mark.parametrize("app", CARRY_APPS)
def test_block_carried_from_the_reference(app, carry_symbols):
    from siddhi_tpu.core.types import GLOBAL_STRINGS as JSTR
    from siddhi_tpu_torch.core.types import GLOBAL_STRINGS as TSTR
    jrt, trt = _apps(C.PARTITION_APPS[app])
    ts, cols_j, cuts = C.partition_feed(400, JSTR.encode, prefix=PFX)
    _ts, cols_t, _cuts = C.partition_feed(400, TSTR.encode, prefix=PFX)
    assert np.array_equal(cols_j[0], cols_t[0])   # the codes agree
    half = cuts[len(cuts) // 2]
    rows = {J: [], T: []}
    for pkg, rt in ((J, jrt), (T, trt)):
        rt.add_callback("Out", pkg.StreamCallback(
            lambda evs, r=rows[pkg]: r.extend(
                (e.timestamp, e.is_expired, tuple(
                    (x.hex() if isinstance(x, float) else x) for x in e.data))
                for e in evs)))
        rt.start()
    hj, ht = jrt.get_input_handler("S"), trt.get_input_handler("S")
    sends = list(zip(cuts[:-1], cuts[1:]))
    for a, b in sends:
        if b <= half:
            hj.send_arrays(ts[a:b], [c[a:b] for c in cols_j])
    blk = trt.partitions["partition_1"]
    blk.restore_state(block_from_jax(
        jrt.partitions["partition_1"].snapshot_state(), "cpu"))
    blk.reschedule()
    with trt.barrier:   # the port's clock where the reference's stands
        trt.on_ingest_ts(int(ts[half - 1]))
    rows[J].clear()
    for a, b in sends:
        if b > half:
            hj.send_arrays(ts[a:b], [c[a:b] for c in cols_j])
            ht.send_arrays(ts[a:b], [c[a:b] for c in cols_t])
    jrt.shutdown()
    trt.shutdown()
    assert rows[T] == rows[J] and rows[T]
    sj = dict(leaves({k: v for k, v in jrt.partitions[
        "partition_1"].snapshot_state().items() if k != "rate"}))
    st = dict(leaves(trt.partitions["partition_1"].snapshot_state()))
    assert sj.keys() == st.keys()
    for k in sj:
        assert (sj[k] == st[k]).all(), k
    assert trt.queries["q"].stats() == jrt.queries["q"].stats()
