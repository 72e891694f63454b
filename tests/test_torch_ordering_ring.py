"""The device reorder ring (kernel K10; its plain version on the CPU)
against the reference, on the CPU:

- tests/test_ordering.py's ring cases (a time window and a lengthBatch
  window under cap='64', disordered): the port takes the ring wherever
  it is eligible; the reference only under SIDDHI_TPU_REORDER_RING=1.
  Run both ways, the reference's rows equal the port's; with the
  variable set, every counter too (``ring_steps`` included);
- forced overflow through the ring, counted as the reference counts it;
- a ring's pending rows through snapshot_state and restore_state (the
  reference's, carried with carry.reorder_from_jax, and the port's own);
- K10's plain version against the reference's jitted ``_build_ring_step``
  on synthetic arguments (a ring that is empty and one that is full,
  ``final``, a forced ``min_rel``, equal timestamps, no watermark) and
  on the steps of an app run, captured; whole outputs (the released
  batch past the cut, the new ring past its count) equal, tolerance 0;
- a reference ring's state carried across (carry.ring_from_jax) that
  then steps on in the port as in the reference."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import siddhi_tpu as J
import siddhi_tpu_torch as T
from siddhi_tpu.core.types import AttrType as JType
from siddhi_tpu.resilience.ordering import ring_step_for
from siddhi_tpu_torch.carry import reorder_from_jax, ring_from_jax
from siddhi_tpu_torch.resilience import ordering as TO
from test_ordering import (LENGTH_BATCH_APP, TS0, WINDOW_APP, _mk_chunks,
                           _shuffle_within)
from test_torch_ordering import RING_ENV, Run, counters

torch.set_num_threads(1)

RING_APPS = {name: ql.replace("@app:watermark(lateness='64')",
                              "@app:watermark(lateness='64', cap='64')")
             for name, ql in (("time-window", WINDOW_APP),
                              ("length-batch", LENGTH_BATCH_APP))}


def _ring_run(pkg, ql, all_counters):
    r = Run(pkg, ql)
    rng = np.random.default_rng(17)
    for ts, cols in _mk_chunks(13, 256, 64):
        ts, cols = _shuffle_within(ts, cols, rng, 48)
        r.cols("S", ts, cols)
    c = counters(r.rt, host_lane=not all_counters)
    r.close()
    return r.got["Out"], c


@pytest.mark.parametrize("app", sorted(RING_APPS))
def test_ring_disorder_equals_the_reference_both_ways(app, monkeypatch):
    ql = RING_APPS[app]
    monkeypatch.setenv(RING_ENV, "1")
    got, c = _ring_run(T, ql, True)
    assert (got, c) == _ring_run(J, ql, True)
    assert c["ring_steps"] > 0 and got
    monkeypatch.delenv(RING_ENV)
    host = _ring_run(J, ql, False)
    assert (got, {k: v for k, v in c.items() if k != "ring_steps"}) == host


FORCED = """
    @app:watermark(lateness='100000', cap='32')
    define stream S (v int);
    @info(name = 'q') from S select v insert into Out;
"""


def test_ring_forced_overflow_counted_never_silent(monkeypatch):
    monkeypatch.setenv(RING_ENV, "1")

    def run(pkg):
        r = Run(pkg, FORCED)
        order = np.random.default_rng(9).permutation(96)
        ts = (TS0 + np.arange(96, dtype=np.int64))[order]
        r.cols("S", ts, [np.arange(96, dtype=np.int32)[order]])
        buf = r.rt._reorder["S"]
        mid = (buf._ring is not None, buf.depth, len(r.got["Out"]),
               counters(r.rt, host_lane=False))
        r.close()
        return r.got["Out"], mid
    got, mid = run(T)
    assert (got, mid) == run(J)
    assert mid[:3] == (True, 32, 64) and mid[3]["forced"] == 64
    assert sorted(g[1][0] for g in got) == list(range(96))


def test_ring_snapshot_restore_keeps_buffered_events(monkeypatch):
    monkeypatch.setenv(RING_ENV, "1")
    text = FORCED
    order = np.random.default_rng(5).permutation(24)
    ts = (TS0 + np.arange(24, dtype=np.int64))[order]
    vals = np.arange(24, dtype=np.int32)[order]
    snaps = {}
    for pkg in (J, T):
        r = Run(pkg, text)
        r.cols("S", ts, [vals])
        buf = r.rt._reorder["S"]
        assert buf._ring is not None and buf.depth == 24
        snaps[pkg] = buf.snapshot_state()
        r.close()
    outs = []
    for snap in (reorder_from_jax(snaps[J]), snaps[T]):
        r = Run(T, text)
        r.rt._reorder["S"].restore_state(snap)
        assert r.rt._reorder["S"].depth == 24
        outs.append(r.close().got["Out"])
    assert outs[0] == outs[1]
    assert [g[1][0] for g in outs[0]] == list(range(24))
    assert [g[0] for g in outs[0]] == sorted(g[0] for g in outs[0])


# -- K10's plain version against the reference's step ------------------------

TYPES = (JType.INT, JType.LONG, JType.FLOAT, JType.DOUBLE, JType.BOOL,
         JType.STRING)
NP = (np.int32, np.int64, np.float32, np.float64, np.bool_, np.int32)


def ref_step(state, in_ts, in_cols, count, n_in, wm, min_rel, final):
    """The reference's jitted ring step on numpy arguments. -> numpy
    ((ts, cols), batch fields, meta)."""
    C = len(in_ts)
    step = ring_step_for(TYPES[:len(in_cols)], C)
    sts, scols = state

    def own(a):
        # the step donates the ring: a buffer of its own, never one that
        # aliases a numpy array (the reference's zero_state says why)
        return jnp.copy(jnp.asarray(a))
    (nts, ncols), b, meta = step(
        own(sts), tuple(own(c) for c in scols),
        jnp.asarray(in_ts), tuple(jnp.asarray(c) for c in in_cols),
        np.int32(count), np.int32(n_in), np.int64(wm), np.int32(min_rel),
        np.bool_(final))
    b = jax.device_get(b)
    return ((np.asarray(nts), [np.asarray(c) for c in ncols]),
            [np.asarray(b.ts)] + [np.asarray(c) for c in b.cols] +
            [np.asarray(n) for n in b.nulls] +
            [np.asarray(b.kind), np.asarray(b.valid)],
            [int(x) for x in jax.device_get(meta)])


def port_step(state, in_ts, in_cols, count, n_in, wm, min_rel, final):
    t = lambda a: torch.from_numpy(np.array(a, copy=True))  # noqa: E731
    (nts, ncols), b, meta = TO.ring_step(
        (t(state[0]), tuple(t(c) for c in state[1])), t(in_ts),
        tuple(t(c) for c in in_cols), count, n_in, wm, min_rel, final)
    return ((nts.numpy(), [c.numpy() for c in ncols]),
            [b.ts.numpy()] + [c.numpy() for c in b.cols] +
            [n.numpy() for n in b.nulls] + [b.kind.numpy(),
                                            b.valid.numpy()],
            meta.tolist())


def _bits(a):
    a = np.asarray(a)
    if a.dtype.kind == "f":
        return a.view(np.int64 if a.itemsize == 8 else np.int32)
    return a


def hold(args, what):
    got, want = port_step(*args), ref_step(*args)
    assert got[2] == want[2], f"{what}: meta"
    assert np.array_equal(got[0][0], want[0][0]), f"{what}: ring ts"
    for i, (g, w) in enumerate(zip(got[0][1], want[0][1])):
        assert np.array_equal(_bits(g), _bits(w)), f"{what}: ring col {i}"
    for i, (g, w) in enumerate(zip(got[1], want[1])):
        assert g.dtype == w.dtype or (g.dtype == np.int32 and
                                      w.dtype == np.int32), what
        assert np.array_equal(_bits(g), _bits(w)), f"{what}: batch {i}"
    return got


def _synthetic(rng, C, count, n_in, spread=500):
    sts = TS0 + rng.integers(0, spread, C)
    scols = [rng.integers(-9, 9, C).astype(d) if d != np.bool_
             else rng.random(C) < 0.5 for d in NP]
    in_ts = TS0 + rng.integers(0, spread, C)
    in_cols = [rng.integers(-9, 9, C).astype(d) if d != np.bool_
               else rng.random(C) < 0.5 for d in NP]
    return (sts, scols), in_ts, in_cols, count, n_in


@pytest.mark.parametrize("C", [8, 128])
def test_k10_plain_equals_the_reference_step(C):
    rng = np.random.default_rng(C)
    cases = {
        "random": dict(count=C // 3, n_in=C // 2, wm=TS0 + 250),
        "empty ring": dict(count=0, n_in=C - 1, wm=TS0 + 100),
        "full ring": dict(count=C, n_in=C, wm=TS0 + 400),
        "final": dict(count=C // 2, n_in=C // 4, wm=TS0, final=True),
        "forced min_rel": dict(count=C - 2, n_in=C, wm=TS0 - 5,
                               min_rel=C // 2 + 3),
        "no watermark": dict(count=C // 2, n_in=C // 2, wm=-(2 ** 62)),
        "ties": dict(count=C, n_in=C, wm=TS0 + 1, spread=3),
        "nothing": dict(count=0, n_in=0, wm=TS0 + 10),
    }
    for name, kw in cases.items():
        state, in_ts, in_cols, count, n_in = _synthetic(
            rng, C, kw["count"], kw["n_in"], kw.get("spread", 500))
        hold((state, in_ts, in_cols, count, n_in, kw["wm"],
              kw.get("min_rel", 0), kw.get("final", False)), name)


def test_k10_captured_steps_equal_the_reference(monkeypatch):
    """Every ring step of a disordered run of the time-window ring app,
    and of its final flush, captured with its arguments."""
    captured = []
    real = TO.ring_step

    def tap(state, in_ts, in_cols, count, n_in, wm, min_rel, final):
        captured.append(((state[0].numpy().copy(),
                          [c.numpy().copy() for c in state[1]]),
                         in_ts.numpy().copy(),
                         [c.numpy().copy() for c in in_cols], count, n_in,
                         wm, min_rel, final))
        return real(state, in_ts, in_cols, count, n_in, wm, min_rel, final)
    with monkeypatch.context() as m:
        m.setattr(TO, "ring_step", tap)
        _ring_run(T, RING_APPS["time-window"], True)
    assert len(captured) >= 5 and captured[-1][-1] is True
    for i, args in enumerate(captured):
        hold(args, f"step {i}")


def test_a_carried_reference_ring_steps_on():
    """A reference ring state after two steps, carried into the port:
    the next steps equal the reference's."""
    rng = np.random.default_rng(21)
    C = 128
    state, in_ts, in_cols, count, n_in = _synthetic(rng, C, 0, 100)
    wm = TS0 + 200
    for k in range(2):
        (sts, scols), _b, meta = ref_step(state, in_ts, in_cols, count,
                                          n_in, wm, 0, False)
        count = count + n_in - meta[0]
        state = (sts, scols)
        _s, in_ts, in_cols, _c, n_in = _synthetic(rng, C, 0, 60)
        wm += 150
    carried = ring_from_jax(state, count, "cpu")
    state = (carried[0].numpy(), [c.numpy() for c in carried[1]])
    for k in range(3):
        got = hold((state, in_ts, in_cols, count, n_in, wm, 0, k == 2),
                   f"carried step {k}")
        count = count + n_in - got[2][0]
        state = got[0]
        _s, in_ts, in_cols, _c, n_in = _synthetic(rng, C, 0, 50)
        wm += 150
