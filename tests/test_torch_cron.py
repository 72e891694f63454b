"""The cron window (kernel K5c; its plain version on the CPU) and its
schedule against the reference, on the CPU.

- utils/cron.py: the next fire time of Quartz expressions equal to the
  reference's, and the reference's own parser case;
- the reference's case (tests/test_windows2.py TestCronWindow): rows
  equal, with the EXPIRED half (at the firing's clock) and a grouped sum;
- a cron named window (``define window W (...) cron('...')``) fed by
  ``insert into`` and read by a grouped sum;
- K5c's plain version against the reference's jitted
  ``CronWindowOp.step``, whole outputs and states, tolerance 0: on
  synthetic steps (a firing with nothing pending, a buffer past its
  capacity, expired rows off) and on the steps of an app run, captured;
- a reference window state carried across (carry.cron_window_from_jax)
  that then goes on in the port;
- a cron window inside a partition is refused, as in the reference."""
import datetime as dt

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import siddhi_tpu as J
import siddhi_tpu_torch as T
from siddhi_tpu.core.event import EventBatch as JBatch
from siddhi_tpu.core.event import Attribute as JAttr
from siddhi_tpu.core.event import StreamSchema as JSchema
from siddhi_tpu.core.types import AttrType as JType
from siddhi_tpu.ops.windows2 import CronWindowOp as JCron
from siddhi_tpu.utils.cron import CronSchedule as JSchedule
from siddhi_tpu_torch.carry import cron_window_from_jax
from siddhi_tpu_torch.core.event import TIMER, Attribute, EventBatch, \
    StreamSchema
from siddhi_tpu_torch.core.types import AttrType
from siddhi_tpu_torch.ops import windows as TW
from siddhi_tpu_torch.ops.windows2 import CronWindowOp
from siddhi_tpu_torch.utils.cron import CronSchedule
from test_torch_window import align_strings, leaves

torch.set_num_threads(1)

PREFIX = "CRN"
SYMS = [f"{PREFIX}{i}" for i in range(3)]


@pytest.fixture(scope="module", autouse=True)
def aligned_symbols():
    align_strings(SYMS)


EXPRS = ["0/1 * * * * ?", "*/5 * * * * ?", "0 30 9 * * ?",
         "0 0/15 8-17 ? * MON-FRI", "10,20,40 * * 1,15 * ?",
         "0 0 0 29 2 ? 2028-2032"]


@pytest.mark.parametrize("expr", EXPRS)
def test_next_fire_equals_the_reference(expr):
    rng = np.random.default_rng(len(expr))
    js, ts = JSchedule(expr), CronSchedule(expr)
    def fire(sched, t):
        try:
            return sched.next_fire(t)
        except ValueError as e:   # CronError: none within four years
            return str(e)
    for base in [0, 1_700_000_000_000] + list(
            rng.integers(0, 4_000_000_000_000, 40)):
        t = int(base)
        for _ in range(3):
            nj, nt = fire(js, t), fire(ts, t)
            assert nt == nj
            if isinstance(nt, str):
                break
            t = nt


def test_the_reference_parser_case():
    s = CronSchedule("0 30 9 * * ?")
    t0 = int(dt.datetime(2026, 7, 1, 8, 0,
                         tzinfo=dt.timezone.utc).timestamp() * 1000)
    nf = s.next_fire(t0)
    d = dt.datetime.fromtimestamp(nf / 1000, tz=dt.timezone.utc)
    assert (d.hour, d.minute, d.second) == (9, 30, 0)
    assert (d.year, d.month, d.day) == (2026, 7, 1)
    d2 = dt.datetime.fromtimestamp(s.next_fire(nf) / 1000,
                                   tz=dt.timezone.utc)
    assert (d2.day, d2.hour) == (2, 9)


def _rows(pkg, text, sends, out="Out"):
    kw = {"device": "cpu"} if pkg is T else {}
    rt = pkg.SiddhiManager(**kw).create_siddhi_app_runtime(text)
    got = []
    rt.add_callback(out, pkg.StreamCallback(fn=lambda evs: got.extend(
        (e.timestamp, tuple(e.data), e.is_expired) for e in evs)))
    rt.start()
    for sid, ts, data in sends:
        rt.get_input_handler(sid).send(pkg.Event(ts, tuple(data)))
    stats = {q: {k: v for k, v in e.items() if k in ("emitted", "overflow")}
             for q, e in rt.statistics().items() if q in rt.queries}
    rt.shutdown()
    return got, stats


CASE = [("S", 1000, (SYMS[0], 1)), ("S", 1200, (SYMS[0], 2)),
        ("S", 2500, (SYMS[1], 3)), ("S", 3500, (SYMS[0], 4)),
        ("S", 3600, (SYMS[1], 5)), ("S", 6100, (SYMS[2], 6))]


@pytest.mark.parametrize("select,what", [
    ("sym, v", "current events"), ("sym, v", "all events"),
    ("sym, v", "expired events"), ("sym, sum(v) as t", "all events")])
def test_the_reference_case(select, what):
    """test_windows2.py TestCronWindow.test_cron_flush_in_playback, with
    the EXPIRED half and a grouped sum: each firing emits the previous
    batch EXPIRED at its clock, then the buffered batch."""
    text = f"""@app:playback
        define stream S (sym string, v int);
        @info(name = 'q')
        from S#window.cron('0/1 * * * * ?')
        select {select} {"group by sym" if "sum" in select else ""}
        insert {what} into Out;"""
    got, st = _rows(T, text, CASE)
    want, sj = _rows(J, text, CASE)
    assert got == want and got
    assert st["q"] == sj["q"]
    if what == "current events" and select == "sym, v":
        assert [r[1][1] for r in got] == [1, 2, 3, 4, 5]


NAMED = """@app:playback
    define stream S (sym string, v int);
    define window W (sym string, v int) cron('*/2 * * * * ?');
    @info(name = 'fill') from S insert into W;
    @info(name = 'q') from W select sym, sum(v) as t group by sym
    insert all events into Out;"""
# the same query over a query-level cron window
UNNAMED = """@app:playback
    define stream S (sym string, v int);
    @info(name = 'q') from S#window.cron('*/2 * * * * ?')
    select sym, sum(v) as t group by sym
    insert all events into Out;"""
NAMED_SENDS = [("S", 1000 + 300 * i, (SYMS[i % 3], i)) for i in range(30)]


def test_cron_named_window_fires_as_a_query_window_does():
    """A cron named window read by a grouped sum gives the rows of the
    same query over a query-level cron window, in the reference and in
    the port."""
    got, st = _rows(T, NAMED, NAMED_SENDS)
    want, sj = _rows(J, UNNAMED, NAMED_SENDS)
    assert got == want and len(got) > 20
    assert st["q"] == sj["q"]
    assert _rows(T, UNNAMED, NAMED_SENDS)[0] == want


def test_the_reference_never_fires_a_cron_named_window():
    """The reference's fault the port does not keep: its _arm_cron arms
    app.queries and the triggers, not the named windows, so a cron named
    window buffers and never emits there (ROADMAP Queue 3)."""
    assert _rows(J, NAMED, NAMED_SENDS)[0] == []


# -- K5c's plain version against the reference's step -----------------------

TYPES = (AttrType.STRING, AttrType.FLOAT, AttrType.LONG)
T_SCHEMA = StreamSchema("S", tuple(Attribute(f"a{i}", t)
                                   for i, t in enumerate(TYPES)))
J_SCHEMA = JSchema("S", tuple(JAttr(f"a{i}", JType(t.value))
                              for i, t in enumerate(TYPES)))


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_to_torch(v) for v in tree)
    return torch.from_numpy(np.array(tree, copy=True))


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_to_jax(v) for v in tree)
    return jnp.asarray(tree.numpy())


def _batch_to_jax(b: EventBatch):
    return JBatch(jnp.asarray(b.ts.numpy()),
                  tuple(jnp.asarray(c.numpy()) for c in b.cols),
                  tuple(jnp.asarray(n.numpy()) for n in b.nulls),
                  jnp.asarray(b.kind.numpy()), jnp.asarray(b.valid.numpy()))


def _leaf_dict(tree, path):
    return dict(leaves(tree, path))


def _same(a: dict, b: dict, what: str):
    assert a.keys() == b.keys(), what
    for k in a:
        assert a[k].shape == b[k].shape and (a[k] == b[k]).all(), \
            f"{what}: {k} differs"


_J_STEPS: dict = {}


def j_step(cap, expired):
    key = (cap, expired)
    if key not in _J_STEPS:
        op = JCron(J_SCHEMA, "*/5 * * * * ?", cap=cap,
                   expired_enabled=expired)
        _J_STEPS[key] = (op, jax.jit(op.step))
    return _J_STEPS[key]


def hold_step(op: CronWindowOp, state, batch: EventBatch, now: int):
    """One step of the port's plain version and of the reference's
    jitted step on the same arguments; whole outputs and states equal.
    -> the port's new state."""
    jop, jfn = j_step(op.cap, op.expired_enabled)
    js, jo = jfn(_to_jax(state), _batch_to_jax(batch), jnp.int64(now))
    ts_, to = TW.window_step(op, state, batch, now)
    _same(_leaf_dict(_to_torch(jax.device_get(js)), "state"),
          _leaf_dict(ts_, "state"), f"state at {now}")
    jo = jax.device_get(jo)
    for f in ("ts", "cols", "nulls", "kind", "valid"):
        _same(_leaf_dict(_to_torch(getattr(jo, f)), f),
              _leaf_dict(getattr(to, f), f), f"output at {now}")
    return ts_


def _arrivals(rng, t0, n, B):
    ts = torch.zeros(B, dtype=torch.int64)
    ts[:n] = torch.from_numpy(t0 + np.sort(rng.integers(0, 900, n)))
    cols = (torch.from_numpy(rng.integers(1, 9, B).astype(np.int32)),
            torch.from_numpy(rng.uniform(-5, 5, B).astype(np.float32)),
            torch.from_numpy(rng.integers(-9, 9, B).astype(np.int64)))
    nulls = tuple(torch.from_numpy(rng.random(B) < 0.2) for _ in cols)
    valid = torch.arange(B) < n
    kind = torch.zeros(B, dtype=torch.int32)
    return EventBatch(ts, cols, nulls, kind, valid)


def _timer(t, B=16):
    ts = torch.zeros(B, dtype=torch.int64)
    ts[0] = t
    kind = torch.zeros(B, dtype=torch.int32)
    kind[0] = TIMER
    return EventBatch(ts, tuple(torch.zeros(B, dtype=dt) for dt in (
        torch.int32, torch.float32, torch.int64)),
        tuple(torch.zeros(B, dtype=torch.bool) for _ in range(3)), kind,
        torch.arange(B) < 1)


@pytest.mark.parametrize("cap,expired", [(16, True), (64, True),
                                         (16, False)])
def test_k5c_plain_equals_the_reference_step(cap, expired):
    """Synthetic steps: a firing with nothing pending, arrivals within
    and past the capacity (overflow counted), firings that rotate, a
    firing right after one, and a TIMER row inside an arrival batch."""
    rng = np.random.default_rng(cap + expired)
    op = CronWindowOp(T_SCHEMA, "*/5 * * * * ?", cap=cap,
                      expired_enabled=expired)
    st = op.init_state()
    t = 10_000
    plan = ["fire", "arr:5", "arr:9", "fire", "fire", f"arr:{cap + 24}",
            "fire", "arr:3", "mixed", "arr:0", "fire", "fire"]
    for p in plan:
        if p == "fire":
            st = hold_step(op, st, _timer(t), t)
        elif p == "mixed":
            b = _arrivals(rng, t, 6, 16)
            b.kind[2] = TIMER
            st = hold_step(op, st, b, t + 3)
        else:
            st = hold_step(op, st, _arrivals(rng, t, int(p[4:]), 128), t)
        t += 1000
    assert int(st["overflow"]) > 0


def test_k5c_captured_steps_equal_the_reference():
    """Every K5c step of an app run (arrivals from ``insert into`` a cron
    named window and the scheduler's firings), captured with its
    arguments and replayed through the reference's step."""
    text = """@app:playback
        define stream S (sym string, price float, volume long);
        define window W (sym string, price float, volume long)
            cron('*/1 * * * * ?');
        @info(name = 'fill') from S insert into W;
        @info(name = 'q') from W select sym, price insert into Out;"""
    captured = []
    real = TW.window_step

    def tap(op, state, batch, now):
        if isinstance(op, CronWindowOp):
            captured.append((op, state, batch, int(now)))
        return real(op, state, batch, now)
    rt = T.SiddhiManager(device="cpu").create_siddhi_app_runtime(text)
    TW.window_step = tap
    try:
        rt.start()
        rng = np.random.default_rng(4)
        h = rt.get_input_handler("S")
        t = 1_700_000_000_500
        for k in range(6):
            n = int(rng.integers(1, 40))
            ts = t + np.sort(rng.integers(0, 700, n)).astype(np.int64)
            h.send_arrays(ts, [rng.integers(1, 9, n).astype(np.int32),
                               rng.uniform(0, 9, n).astype(np.float32),
                               rng.integers(0, 99, n).astype(np.int64)])
            t += 900
        rt.shutdown()
    finally:
        TW.window_step = real
    assert len(captured) >= 8
    assert any(bool((b.kind == TIMER).any()) for _o, _s, b, _n in captured)
    for op, state, batch, now in captured:
        # the op's schema is the window's; the reference op is built on
        # the same types
        hold_step(op, state, batch, now)


def test_a_carried_reference_state_goes_on():
    """Two sends and a firing in the reference; its cron window's state
    (cur, exp, next_seq, overflow) carried into the port; the next sends
    give the same rows in both."""
    text = """@app:playback
        define stream S (sym string, v int);
        @info(name = 'q')
        from S#window.cron('0/1 * * * * ?')
        select sym, v insert all events into Out;"""
    sends = [("S", 1000 + 250 * i, (SYMS[i % 3], i)) for i in range(16)]
    runs = {}
    for pkg in (J, T):
        kw = {"device": "cpu"} if pkg is T else {}
        rt = pkg.SiddhiManager(**kw).create_siddhi_app_runtime(text)
        got = []
        rt.add_callback("Out", pkg.StreamCallback(fn=lambda evs, g=got: g.extend(
            (e.timestamp, tuple(e.data), e.is_expired) for e in evs)))
        rt.start()
        runs[pkg] = (rt, got)
    rj, gj = runs[J]
    for sid, ts, data in sends[:7]:
        rj.get_input_handler(sid).send(J.Event(ts, tuple(data)))
    rt_, gt = runs[T]
    snap = rj.queries["q"].snapshot_state()
    q = rt_.queries["q"]
    carried = cron_window_from_jax(snap["states"][0], "cpu")
    q.restore_state({"states": (carried,) + tuple(q.states[1:]),
                     "emitted": torch.tensor(int(snap["emitted"]))})
    # the clock and the schedule where the reference's stand (a restore
    # re-arms the host timers from the clock)
    rt_._cron_armed = True
    rt_._playback_time = rj._playback_time
    q.arm_host_timers(rj._playback_time)
    gj.clear()
    for sid, ts, data in sends[7:]:
        for pkg, (rt, _g) in runs.items():
            rt.get_input_handler(sid).send(pkg.Event(ts, tuple(data)))
    assert gt == gj and gj


def test_cron_inside_a_partition_is_refused():
    text = """define stream S (sym string, v int);
        partition with (sym of S) begin
          from S#window.cron('*/5 * * * * ?') select sym, v insert into O;
        end;"""
    for pkg in (J, T):
        kw = {"device": "cpu"} if pkg is T else {}
        with pytest.raises(Exception, match="cron windows inside "
                                            "partitions"):
            pkg.SiddhiManager(**kw).create_siddhi_app_runtime(text)
