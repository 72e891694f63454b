"""Triggers (``define trigger``) against the reference, on the CPU: the
three forms (``at every <t>``, a cron expression, ``at 'start'``) under
playback, their (triggered_time) rows through a projection and a
filter, a trigger joined into an app's streams, and the arming point
(the first event time less 1)."""
import numpy as np
import pytest
import torch

import siddhi_tpu as J
import siddhi_tpu_torch as T

torch.set_num_threads(1)


def _rows(pkg, text, sends, outs):
    kw = {"device": "cpu"} if pkg is T else {}
    rt = pkg.SiddhiManager(**kw).create_siddhi_app_runtime(text)
    got = {o: [] for o in outs}
    for o, g in got.items():
        rt.add_callback(o, pkg.StreamCallback(fn=lambda evs, g=g: g.extend(
            (e.timestamp, tuple(e.data), e.is_expired) for e in evs)))
    rt.start()
    for sid, ts, data in sends:
        if isinstance(ts, np.ndarray):
            rt.get_input_handler(sid).send_arrays(ts, data)
        else:
            rt.get_input_handler(sid).send(pkg.Event(ts, tuple(data)))
    rt.shutdown()
    return got


TRIGGERS = """@app:playback
    define stream S (v int);
    define trigger TEvery at every 700 milliseconds;
    define trigger TCron at '*/2 * * * * ?';
    define trigger TStart at 'start';
    @info(name = 'e') from TEvery select triggered_time as t,
        triggered_time % 1000 as frac insert into OutEvery;
    @info(name = 'c') from TCron[triggered_time % 4000 == 0]
        select triggered_time insert into OutCron;
    @info(name = 's') from TStart select triggered_time insert into OutStart;
    @info(name = 'q') from S select v insert into OutS;"""
OUTS = ("OutEvery", "OutCron", "OutStart", "OutS", "TEvery", "TCron",
        "TStart")


@pytest.mark.parametrize("first", [1000, 1_700_000_000_123])
def test_the_three_forms_equal_the_reference(first):
    sends = [("S", first + 450 * i, (i,)) for i in range(24)]
    got = _rows(T, TRIGGERS, sends, OUTS)
    want = _rows(J, TRIGGERS, sends, OUTS)
    assert got == want
    assert got["TEvery"] and got["TCron"] and got["OutCron"]
    # 'start' fires once, at the arming point: the first event time less 1
    assert got["TStart"] == [(first - 1, (first - 1,), False)]
    # every <t>: from the arming point on, while the clock reaches it
    every = [r[0] for r in got["TEvery"]]
    assert every == list(range(first - 1 + 700, sends[-1][1] + 1, 700))


def test_columnar_sends_fire_between_chunks():
    """A columnar send is one step: the triggers due inside its span fire
    after it (and those due before its first event, before it)."""
    text = TRIGGERS
    ts = 5000 + 40 * np.arange(200, dtype=np.int64)
    sends = [("S", ts[a:a + 50], [np.arange(a, a + 50, dtype=np.int32)])
             for a in range(0, 200, 50)]
    got = _rows(T, text, sends, OUTS)
    want = _rows(J, text, sends, OUTS)
    assert got == want and got["TEvery"]


def test_a_trigger_joined_with_a_stream():
    """A trigger's stream as one side of a join over a length window."""
    text = """@app:playback
        define stream S (v int);
        define trigger Tick at every 1 sec;
        @info(name = 'j')
        from Tick#window.length(1) join S#window.length(3)
        select Tick.triggered_time as t, S.v as v
        insert into Out;"""
    sends = [("S", 1000 + 300 * i, (i,)) for i in range(15)]
    got = _rows(T, text, sends, ("Out",))
    want = _rows(J, text, sends, ("Out",))
    assert got == want and got["Out"]


def test_script_functions_still_raise():
    text = """define function f[python] return int { return 1; };
        define stream S (v int); from S select v insert into O;"""
    with pytest.raises(NotImplementedError, match="not ported yet"):
        T.SiddhiManager(device="cpu").create_siddhi_app_runtime(text)
