"""Tenant QoS (siddhi_tpu_torch/serving/qos.py) against the reference's
(siddhi_tpu/serving/qos.py) under one fake clock, on the CPU: the DRR
``plan_round`` over seeded backlogs with weights and priority classes,
``check_rate`` and its retry times, the breakers' transitions, the
reports, and the dial errors; then a pool's rate-limit 429 and its
breaker short-circuiting, against the reference pool."""
import numpy as np
import pytest
import torch

import siddhi_tpu as J
import siddhi_tpu_torch as T
from siddhi_tpu.serving import qos as JQ
from siddhi_tpu.serving import AdmissionError as JAdm
from siddhi_tpu.serving import TemplateRegistry as JRegistry
from siddhi_tpu_torch.serving import qos as TQ
from siddhi_tpu_torch.serving import AdmissionError as TAdm
from siddhi_tpu_torch.serving import TemplateRegistry as TRegistry

torch.set_num_threads(1)


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def pair(defaults, **kw):
    """(reference PoolQoS, port PoolQoS, their shared clock, the
    transitions each saw)."""
    clock = Clock()
    seen = ([], [])
    j = JQ.PoolQoS(defaults, clock=clock,
                   on_transition=lambda *a: seen[0].append(a))
    t = TQ.PoolQoS(defaults, clock=clock,
                   on_transition=lambda *a: seen[1].append(a))
    return j, t, clock, seen


PROFILES = [
    {},
    {"weight": 3.0},
    {"weight": 0.5, "priority": "low"},
    {"priority": "high", "rate_eps": 50.0},
    {"rate.eps": 10, "burst": 25},
]


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
@pytest.mark.parametrize("max_defer", [0, 2, 4])
def test_plan_round_over_seeded_backlogs(seed, max_defer):
    rng = np.random.default_rng(seed)
    j, t, _clock, _seen = pair({"max_defer": max_defer})
    tids = [f"t{i}" for i in range(12)]
    for i, tid in enumerate(tids):
        prof = PROFILES[int(rng.integers(0, len(PROFILES)))]
        j.add_tenant(tid, prof)
        t.add_tenant(tid, prof)
    pending = {tid: int(rng.integers(0, 3000)) for tid in tids}
    for rnd in range(40):
        if rnd == 20:
            j.remove_tenant("t3")
            t.remove_tenant("t3")
            pending.pop("t3")
        for tid in pending:
            pending[tid] += int(rng.integers(0, 400)) * (rnd % 3 == 0)
        bm = int(rng.choice([128, 256, 1024]))
        a = j.plan_round(dict(pending), bm)
        b = t.plan_round(dict(pending), bm)
        assert a == b
        for tid, take in a.items():
            pending[tid] -= take
        assert t.credits() == j.credits()
    assert t.report() == j.report()
    assert t.deferrals == j.deferrals


def test_check_rate_and_retry_times():
    j, t, clock, _seen = pair({"rate_eps": 100.0, "rate_burst": 150})
    for q in (j, t):
        q.add_tenant("a")
        q.add_tenant("b", {"rate_eps": 7, "burst": 3})
        q.add_tenant("c", {"rate_eps": None})
    rng = np.random.default_rng(5)
    for _ in range(200):
        clock.t += float(rng.uniform(0, 0.05))
        tid = ("a", "b", "c")[int(rng.integers(0, 3))]
        n = int(rng.integers(1, 200))
        assert t.check_rate(tid, n) == j.check_rate(tid, n)
    assert t.report() == j.report()


def test_token_bucket_alone():
    clock = Clock()
    jb, tb = JQ.TokenBucket(5.0, 2.0, clock), TQ.TokenBucket(5.0, 2.0, clock)
    for step, n in ((0.0, 1), (0.0, 1), (0.0, 1), (0.1, 1), (0.3, 5),
                    (1.0, 5), (0.01, 1), (2.0, 2)):
        clock.t += step
        assert tb.try_take(n) == jb.try_take(n)
        assert tb.tokens == jb.tokens


@pytest.mark.parametrize("outcomes", [
    "ffffsfff", "fsfsfsff", "ffffffffff", "sssfffss"])
def test_breaker_transitions(outcomes):
    j, t, clock, seen = pair({"breaker.failures": 3,
                              "breaker.reset.ms": 500})
    for q in (j, t):
        q.add_tenant("a")
    for k, o in enumerate(outcomes):
        clock.t += 0.2
        ga, gb = j.breaker_gate("a"), t.breaker_gate("a")
        assert ga == gb
        if ga == "open":
            j.count_short_circuit("a", k + 1)
            t.count_short_circuit("a", k + 1)
            continue
        j.on_delivery("a", ok=o == "s")
        t.on_delivery("a", ok=o == "s")
    assert seen[0] == seen[1]
    assert t.report() == j.report()


def test_breaker_alone():
    clock = Clock()
    jb = JQ.CircuitBreaker(2, 100, clock)
    tb = TQ.CircuitBreaker(2, 100, clock)
    for act in ("f", "f", "g", "t", "g", "s", "f", "g", "f", "f", "g",
                "t", "t", "g", "f", "g"):
        if act == "t":
            clock.t += 0.06
        elif act == "g":
            assert tb.gate() == jb.gate()
        elif act == "f":
            tb.record_failure(), jb.record_failure()
        else:
            tb.record_success(), jb.record_success()
        assert tb.as_dict() == jb.as_dict()


@pytest.mark.parametrize("defaults,tenant", [
    ({"priority": "urgent"}, None),
    ({"rate_eps": -1}, None),
    ({"breaker_failures": 0}, None),
    ({}, {"weight": 0}),
    ({}, {"color": "red"}),
    ({}, {"priority": "LOW", "weight": 2}),
])
def test_dial_errors(defaults, tenant):
    out = []
    for mod in (JQ, TQ):
        try:
            q = mod.PoolQoS(defaults)
            q.add_tenant("a", tenant)
            if q.profile("a").bucket is not None:
                q.check_rate("a", 1)
            out.append(("ok", q.describe()))
        except ValueError as e:
            out.append(("error", str(e)))
    assert out[0] == out[1]


TPL = """
define stream In (v double, k long);
@info(name='q')
from In[v > ${lo:double}] select v, k insert into Out;
"""


def test_pool_rate_limit_and_breaker_against_the_reference():
    """A pool's 429 for an over-rate send (its reason text), and a
    breaker that trips on a failing callback and short-circuits the
    next deliveries, in both pools. The QoS clocks are the real ones: the
    rate is low enough that no token accrues between two sends."""
    pools = (JRegistry(J.SiddhiManager()).pool(
        TPL, warm=False, slots=2, qos={"rate_eps": 0.001, "rate_burst": 50,
                                       "breaker_failures": 2,
                                       "breaker_reset_ms": 10 ** 9}),
             TRegistry(T.SiddhiManager(device="cpu")).pool(
        TPL, warm=False, slots=2, qos={"rate_eps": 0.001, "rate_burst": 50,
                                       "breaker_failures": 2,
                                       "breaker_reset_ms": 10 ** 9}))
    out = []
    for pool, adm in zip(pools, (JAdm, TAdm)):
        got = []
        pool.add_tenant("a", {"lo": 1.0})
        pool.add_tenant("b", {"lo": 1.0})

        def bad(evs):
            raise RuntimeError("sink down")
        pool.add_callback("a", bad)
        pool.add_callback("b", lambda evs: got.extend(
            (e.timestamp, tuple(e.data)) for e in evs))
        ts = 1000 + np.arange(20, dtype=np.int64)
        cols = [np.linspace(0, 5, 20), np.arange(20, dtype=np.int64)]
        for r in range(2):
            for tid in ("a", "b"):
                pool.send(tid, ts[10 * r:10 * r + 10],
                          [c[10 * r:10 * r + 10] for c in cols])
            pool.flush()
        pool.send("a", ts[:20], cols)
        with pytest.raises(adm) as e:
            pool.send("a", ts[:20], cols)
        pool.flush()
        stats = pool.statistics()
        q = stats["qos"]
        # the retry time is the real clock's: its digits are left out
        out.append((e.value.reason.split("retry in")[0],
                    e.value.saturation["cause"],
                    stats["tenants"]["a"]["errors"],
                    q["short_circuited"], q["throttled_429s"],
                    q["tenants"]["a"]["breaker"]["state"],
                    q["tenants"]["a"]["breaker"]["trips"], got))
    assert out[0] == out[1]
    assert out[1][5] == "OPEN" and out[1][3] > 0
