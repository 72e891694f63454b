"""unionSet against the reference on the CPU (test_torch_sets.py's
second half): removals (sliding length and externalTime windows),
resets (lengthBatch and externalTimeBatch), exactly 32 and 33 distinct
values, and a reference unionSet state carried into the port
(carry.state_from_jax); rows, statistics and states equal after every
send."""
import numpy as np
import pytest
import torch

import siddhi_tpu as J
import siddhi_tpu_torch as T
from siddhi_tpu_torch.carry import state_from_jax
from siddhi_tpu_torch.core.types import SET_LANES
from test_torch_join_shapes import MultiRun
from test_torch_sets import PLAYBACK, overflow, replay

torch.set_num_threads(1)


# -- unionSet: removals, resets, the 32-lane edge -------------------------------

def _numbers(n, distinct, seed, per_send=1):
    """Sends of ``per_send`` rows (v, t): v drawn from ``distinct``
    values, t the row's time."""
    rng = np.random.default_rng(seed)
    rows = [(1000 + k, (int(v), 1000 + k)) for k, v in enumerate(
        rng.integers(-distinct // 2, distinct - distinct // 2, n))]
    return [rows[k:k + per_send] for k in range(0, n, per_send)]


@pytest.mark.parametrize("window,distinct", [
    ("length(5)", 12), ("length(40)", 40), ("lengthBatch(6)", 9),
    ("lengthBatch(40)", 40), ("externalTime(t, 30)", 20),
    ("externalTimeBatch(t, 25)", 36)])
def test_union_set_with_removals_and_resets(window, distinct):
    """Sliding windows remove (-1), batch windows reset; states (the
    table's values, counts, tag and overflow) equal after every send."""
    rj, rt = replay(f"""
        define stream S (v long, t long);
        from S select createSet(v) as vs, t insert into P;
        @info(name = 'q')
        from P#window.{window}
        select unionSet(vs) as u, sizeOfSet(unionSet(vs)) as n
        insert all events into Out;""",
        _numbers(90, distinct, seed=3, per_send=6))
    assert rt.rows and overflow(rt) == overflow(rj)


@pytest.mark.parametrize("distinct", [32, 33])
def test_union_set_at_its_lane_count(distinct):
    """Exactly SET_LANES distinct values fit; one more is counted."""
    sends = [[(1000 + k, (k * 7 - 100,))] for k in range(distinct)]
    rj, rt = replay(f"""
        define stream S (v long);
        from S select createSet(v) as vs insert into P;
        from P#window.lengthBatch({distinct})
        select unionSet(vs) as u, sizeOfSet(unionSet(vs)) as n
        insert into Out;""", sends)
    (_ts, (u, n)), = rt.rows
    assert n == SET_LANES and len(u) == SET_LANES
    assert u == frozenset(k * 7 - 100 for k in range(SET_LANES))
    # two unionSet() aggregators, each counting its own overflow
    assert overflow(rt) == overflow(rj) == 2 * (distinct - SET_LANES)


def test_union_set_state_carried_from_the_reference():
    """The reference's unionSet table (vals, counts, tag, overflow) comes
    across with carry.state_from_jax, and the next step agrees."""
    text = PLAYBACK + """
        define stream P (v long, t long);
        from P select createSet(v) as vs insert into Q;
        @info(name = 'q')
        from Q#window.length(20)
        select unionSet(vs) as u insert into Out;"""
    rj, rt = MultiRun(J, text), MultiRun(T, text)
    sends = _numbers(60, 50, seed=8)
    for rows in sends[:40]:
        rj.send("P", rows)
    qj, qt = rj.rt.queries["q"], rt.rt.queries["q"]
    qt.restore_state(state_from_jax(qj.snapshot_state(), "cpu"))
    rt.rt.on_ingest_ts(sends[39][0][0])
    rj.rows.clear()
    for rows in sends[40:]:
        rj.send("P", rows)
        rt.send("P", rows)
    assert rt.rows == rj.rows and len(rt.rows) == 20
    sj, st = rj.state(), rt.state()
    for k in sj:
        if k.startswith("q/"):
            assert (sj[k] == st[k]).all(), k
