"""The pool's SLO engine and flight recorder (siddhi_tpu_torch/obs/slo.py)
against the reference's (siddhi_tpu/obs/slo.py), on the CPU.

The engines see one seeded span sequence with explicit wall times and
are evaluated at the same instants: percentiles, attainment, fast and
slow burn rates, the OK -> WARN -> PAGE -> OK transitions, the breach
count and the PAGE dump's artifact (its keys, identity, context and
spans) agree. The objective parsers agree on values and on error texts.
Then a chain pool in each package, with ``@app:slo(...)`` and with the
``slo={...}`` dial, reports the same scopes, sample counts, burn rates
and states after the same rounds, and dumps an artifact of the same
shape into the dial's ``flight_dir``. Latencies measured on the host's
clock differ between packages, so the pool comparison uses a bound that
every sample breaks."""
import json
import os

import numpy as np
import pytest
import torch

import siddhi_tpu as J
import siddhi_tpu_torch as T
from siddhi_tpu.obs import slo as JS
from siddhi_tpu.serving import TemplateRegistry as JRegistry
from siddhi_tpu_torch.checks import (TENANT_TEMPLATE, tenant_bindings,
                                     tenant_data)
from siddhi_tpu_torch.lang import ast as TA
from siddhi_tpu_torch.lang.parser import parse as t_parse
from siddhi_tpu_torch.obs import slo as TS
from siddhi_tpu_torch.serving import TemplateRegistry as TRegistry

torch.set_num_threads(1)

DIALS = {"p99_ms": "100 ms", "target": 0.99, "window_ms": "1 hour",
         "fast_ms": "5 min", "warn_burn": 2.0, "page_burn": 14.4}
T0 = 1_700_000_000_000.0


def engines(tmp_path, dials=DIALS, every=4):
    """(reference engine, port engine), each with its own recorder
    writing under ``tmp_path``."""
    out = []
    for tag, mod in (("j", JS), ("t", TS)):
        rec = mod.FlightRecorder(
            "slo_eng", dirpath=str(tmp_path / tag),
            identity_fn=lambda: {"app": "a", "pool": "p", "plan_hash": "h"})
        out.append(mod.SLOEngine("slo_eng", mod.objective_from_dials(dials),
                                 every=every, recorder=rec,
                                 context_fn=lambda: {"rounds": 3}))
    return out


def spans(seed, n, bad_frac, t_lo, t_hi):
    """n seeded (scope, wall ms, latency ms) samples, a ``bad_frac``
    share of them above the 100 ms bound."""
    rng = np.random.default_rng(seed)
    scopes = [(), (("tenant", "slo_a"),), (("tenant", "slo_b"),),
              (("tenant", "slo_a"), ("query", "q"))]
    out = []
    for i in range(n):
        lab = scopes[int(rng.integers(0, len(scopes)))]
        t = float(rng.uniform(t_lo, t_hi))
        lat = float(rng.uniform(101, 900) if rng.random() < bad_frac
                    else rng.uniform(0.5, 99))
        out.append((lab, t, lat))
    return out


def strip(rep):
    return {k: v for k, v in rep.items()
            if k not in ("flight_artifact", "flight_artifacts")}


def test_engine_report_and_transitions(tmp_path):
    j, t = engines(tmp_path)
    assert j.objective.as_dict() == t.objective.as_dict()
    phases = [  # (seed, samples, bad share, evaluate at)
        (1, 400, 0.0, T0 + 10_000),
        (2, 400, 0.03, T0 + 20_000),
        (3, 300, 0.6, T0 + 30_000),
        (4, 0, 0.0, T0 + 40_000),
        (5, 400, 0.0, T0 + 30_000 + 6 * 60_000),
        (6, 200, 0.0, T0 + 3 * 3_600_000),
    ]
    t_lo = T0
    seen = []
    for seed, n, bad, at in phases:
        for lab, tw, lat in spans(seed, n, bad, t_lo, at):
            j.observe(lab, lat, t_wall_ms=tw, rows=7)
            t.observe(lab, lat, t_wall_ms=tw, rows=7)
        t_lo = at
        rj, rt = j.evaluate(now_ms=at, saturation={"x": 1}), \
            t.evaluate(now_ms=at, saturation={"x": 1})
        assert strip(rj) == strip(rt)
        assert ("flight_artifact" in rj) == ("flight_artifact" in rt)
        seen.append(rt["state"])
    assert seen[:3] == ["OK", "WARN", "PAGE"] and seen[-1] == "OK"
    assert j.breaches == t.breaches >= 1
    # one dump an evaluation that pages, whatever the number of scopes
    assert len(j.recorder.dumps) == len(t.recorder.dumps) == 1
    aj, at_ = (json.load(open(e.recorder.dumps[0])) for e in (j, t))
    assert sorted(aj) == sorted(at_)
    assert (aj["name"], aj["reason"]) == (at_["name"], at_["reason"])
    assert aj["context"] == at_["context"]
    drop = [{k: v for k, v in s.items() if k != "t_wall_ms"}
            for s in aj["spans"]]
    assert drop == [{k: v for k, v in s.items() if k != "t_wall_ms"}
                    for s in at_["spans"]]


def test_engine_stride_and_window_reservoir(tmp_path):
    j, t = engines(tmp_path, every=3)
    ticks = [(e.tick("round"), e.tick(("q", 1))) for e in (j, t)
             for _ in range(10)]
    assert ticks[:10] == ticks[10:]
    for e in (j, t):
        for i in range(JS.WINDOW_CAP + 50):
            e.observe((), float(i % 250), t_wall_ms=T0 + i)
    rj = j.evaluate(now_ms=T0 + JS.WINDOW_CAP + 60)
    rt = t.evaluate(now_ms=T0 + JS.WINDOW_CAP + 60)
    assert strip(rj) == strip(rt)
    assert rt["scopes"]["total"]["count"] == JS.WINDOW_CAP + 50
    assert rt["scopes"]["total"]["window_count"] == JS.WINDOW_CAP


@pytest.mark.parametrize("dials", [
    {"p50_ms": 5, "target": 0.9, "every": 2},
    {"p99_ms": "2 sec", "p50_ms": "250 ms"},
    {"target": 0.9},
    {"p99_ms": 10, "target": 1.5},
    {"p99_ms": "ten ms"},
    {"p99_ms": -1},
])
def test_objective_from_dials(dials):
    def run(mod):
        try:
            o = mod.objective_from_dials(dict(dials))
            return ("ok", o.as_dict(), o.every)
        except ValueError as e:
            return ("err", str(e))
    assert run(JS) == run(TS)


@pytest.mark.parametrize("ann", [
    "p99='250 ms', target='0.95', every='16'",
    "p50='10 ms', window='30 min', fast='1 min'",
    "p99='1 sec', warn.burn='3', page.burn='10'",
    "target='0.99'",
    "p99='1 sec', fast='2 hours'",
    "p99='1 sec', warn.burn='20'",
    "p99='1 sec', every='0'",
])
def test_objective_from_annotation(ann):
    text = f"@app:slo({ann})\ndefine stream S (v double);\n" \
           "from S select v insert into O;"

    def run(parse, find, mod):
        a = find(parse(text, validate=False).annotations, "slo")
        try:
            o = mod.config_from_annotation(a)
            return ("ok", o.as_dict(), o.every)
        except ValueError as e:
            return ("err", str(e))
    from siddhi_tpu.lang import ast as JA
    from siddhi_tpu.lang.parser import parse as j_parse
    assert run(j_parse, JA.find_annotation, JS) == \
        run(t_parse, TA.find_annotation, TS)


def drive(pool):
    ts, cols = tenant_data(300, seed=5)
    for i, tid in enumerate(("slo_a", "slo_b")):
        pool.add_tenant(tid, tenant_bindings(i))
    for tid in ("slo_a", "slo_b"):
        pool.send(tid, ts[:200], [c[:200] for c in cols])
    pool.flush()
    for tid in ("slo_a", "slo_b"):
        pool.send(tid, ts[200:], [c[200:] for c in cols])
    pool.flush()
    return pool.slo_report()


def shape(rep):
    """What a pool's report must share with the reference's: the
    latencies themselves are host wall times."""
    scopes = {name: {k: (v if k not in ("p50_ms", "p95_ms", "p99_ms")
                         else "ms") for k, v in e.items()}
              for name, e in rep["scopes"].items()}
    return (rep["every"], rep["objective"], rep["state"], rep["breaches"],
            scopes, sorted(rep["saturation"]))


@pytest.mark.parametrize("route", ["annotation", "dial"])
def test_pool_slo_against_reference(tmp_path, monkeypatch, route):
    # the annotation route dumps into the default directory, under the
    # working directory
    monkeypatch.chdir(tmp_path)
    kw = {"slots": 2, "batch_max": 128, "warm": False}
    text = TENANT_TEMPLATE
    if route == "annotation":
        text = "@app:slo(p99='0.000001 ms', every='2')\n" + text
    reps, arts = [], []
    for tag, reg in (("j", JRegistry(J.SiddhiManager())),
                     ("t", TRegistry(T.SiddhiManager(device="cpu")))):
        if route == "dial":
            kw["slo"] = {"p99_ms": 1e-6, "every": 1,
                         "flight_dir": str(tmp_path / tag)}
        pool = reg.pool(text, **kw)
        reps.append(drive(pool))
        arts.append(list(pool.flight.dumps))
        key = pool.template.key
        pool.shutdown()
    assert shape(reps[0]) == shape(reps[1])
    assert reps[1]["state"] == "PAGE" and reps[1]["breaches"] >= 1
    assert {"total", "tenant=slo_a", "tenant=slo_a,query=q"} <= \
        set(reps[1]["scopes"])
    assert len(arts[0]) == len(arts[1]) == 1
    where = tmp_path / ("t" if route == "dial" else TS.DEFAULT_FLIGHT_DIR)
    assert os.path.abspath(arts[1][0]).startswith(str(where))
    aj, at_ = (json.load(open(a[0])) for a in arts)
    assert sorted(aj) == sorted(at_)
    assert sorted(aj["context"]) == sorted(at_["context"])
    # until plan_hash is ported, the port's artifact names the template
    assert at_["context"]["plan_hash"] == key
    assert [s["kind"] for s in aj["spans"]] == \
        [s["kind"] for s in at_["spans"]]


def test_plain_app_rejects_pool_dials():
    """@app:slo and @app:cap are a pool's dials: a plain app in the port
    raises for them, as for every annotation it does not honour."""
    for ann in ("@app:slo(p99='250 ms')", "@app:cap(tenants='4')"):
        with pytest.raises(NotImplementedError, match="not ported yet"):
            T.SiddhiManager(device="cpu").create_siddhi_app_runtime(
                ann + "\ndefine stream S (v double);\n"
                "from S select v insert into O;")
