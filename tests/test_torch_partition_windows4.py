"""A reference partition block's state carried into the port mid-feed
(carry.block_from_jax, then ``reschedule``), for the slotted states of
the sort window (kernel B[K]), frequent and lossyFrequent (E[K]), the
session window (F[K], whose open sessions re-arm the block's timer) and
delay (A[K], a timed K5 kind): both packages then take the rest of the
feed and the clock's advance, and give equal rows (in order, floats by
their bits), equal stats and equal block states, on the CPU, tolerance
0."""
import pytest
import torch

import siddhi_tpu as J
import siddhi_tpu_torch as T
from siddhi_tpu_torch.carry import block_from_jax
from test_torch_partition_windows import (APPS, CUTS, TABLES, block_state,
                                          names, row_of, window_feed)
from test_torch_window import align_strings

torch.set_num_threads(1)

PREFIX = "wd"
HALF = 4   # sends before the carry


@pytest.fixture(scope="module", autouse=True)
def symbols():
    align_strings(names(PREFIX))


@pytest.mark.parametrize("kind", ("sort", "frequent", "lossyFrequent",
                                  "session", "delay"))
def test_block_state_carried_from_the_reference(kind):
    rts = {J: J.SiddhiManager().create_siddhi_app_runtime(APPS[kind]),
           T: T.SiddhiManager(device="cpu").create_siddhi_app_runtime(
               APPS[kind])}
    rows = {J: [], T: []}
    feeds = {}
    for pkg, rt in rts.items():
        rt.add_callback("Out", pkg.StreamCallback(
            lambda evs, r=rows[pkg]: r.extend(row_of(e) for e in evs)))
        rt.start()
        feeds[pkg] = window_feed(CUTS[-1], TABLES[pkg].encode, PREFIX)
    ts = feeds[J][0]
    sends = list(zip(CUTS[:-1], CUTS[1:]))
    hj = rts[J].get_input_handler("S")
    for a, b in sends[:HALF]:
        hj.send_arrays(ts[a:b], [c[a:b] for c in feeds[J][1]])
    blk = rts[T].partitions["partition_1"]
    blk.restore_state(block_from_jax(
        rts[J].partitions["partition_1"].snapshot_state(), "cpu"))
    blk.reschedule()
    with rts[T].barrier:   # the port's clock where the reference's stands
        rts[T].on_ingest_ts(int(ts[sends[HALF - 1][1] - 1]))
    rows[J].clear()
    for a, b in sends[HALF:]:
        for pkg, rt in rts.items():
            rt.get_input_handler("S").send_arrays(
                ts[a:b], [c[a:b] for c in feeds[pkg][1]])
        assert rows[T] == rows[J], (a, b)
    for rt in rts.values():
        with rt.barrier:
            rt.on_ingest_ts(int(ts[-1]) + 200)
    assert rows[T] == rows[J] and rows[T]
    sj, st = block_state(rts[J]), block_state(rts[T])
    for rt in rts.values():
        rt.shutdown()
    for n in sj:
        assert sj[n].keys() == st[n].keys()
        for k in sj[n]:
            assert (sj[n][k] == st[n][k]).all(), (n, k)
    assert rts[T].queries["q"].stats() == rts[J].queries["q"].stats()
