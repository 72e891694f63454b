"""Named windows against the reference, on the CPU (continued from
test_torch_named_window.py, whose helpers it uses): the window kinds of
kernels K5 and A as named windows, under playback with their timers, a
grouped consumer and on-demand reads; rows, whole states after every
send and reads equal bit for bit."""
import pytest
import torch

from test_torch_named_window import PLAYBACK, replay, sym_feed

torch.set_num_threads(1)


WINDOW_KINDS = {
    "length": "length(4)",
    "time": "time(100 millisec)",
    "lengthBatch": "lengthBatch(3)",
    "timeBatch": "timeBatch(100 millisec)",
    "externalTime": "externalTime(et, 100 millisec)",
    "timeLength": "timeLength(100 millisec, 3)",
    "batch": "batch()",
    "externalTimeBatch": "externalTimeBatch(et, 100 millisec)",
    "delay": "delay(50 millisec)",
}


@pytest.mark.parametrize("kind", sorted(WINDOW_KINDS))
def test_window_kinds(kind):
    text = PLAYBACK + f"""
        define stream S (sym string, v int, et long);
        define window W (sym string, v int, et long) {WINDOW_KINDS[kind]}
        output all events;
        @info(name = 'feed') from S select sym, v, et insert into W;
        @info(name = 'c') from W select sym, sum(v) as t, count() as n
        group by sym insert all events into Out;
    """
    sends = [(s, [(t, (a, b, t)) for t, (a, b) in rows])
             for s, rows in sym_feed((4, 11, 1, 8, 25), seed=5, gap=(1, 40))]
    reads = ["from W select sym, v, et"]
    if kind not in ("lengthBatch", "timeBatch", "batch",
                    "externalTimeBatch", "delay"):
        reads.append("from W on v > 10 select sym, count() as c "
                     "group by sym order by sym")
    replay(text, sends, reads=reads)


def test_timer_steps_equal_the_reference():
    """checks.WINDOW_NAMED_APP at 4,096-row columnar sends: the named
    window runs as many steps in the port as in the reference (its event
    steps and the TIMER steps its host-bounded timers fire, one a
    millisecond from the due up to the clock), with the same clocks."""
    import siddhi_tpu as J
    import siddhi_tpu_torch as T
    from siddhi_tpu_torch import checks as C
    ts, (room, temp) = C.window_named_feed(4 * 4096)
    steps = {}
    for pkg in (J, T):
        kw = {"device": "cpu"} if pkg is T else {}
        rt = pkg.SiddhiManager(**kw).create_siddhi_app_runtime(
            C.WINDOW_NAMED_APP)
        wq = rt.named_windows["OneMinTempWindow"]
        got = steps[pkg] = []

        def step(batch, timestamp, now=None, skip_due=False,
                 _orig=wq.process_batch, _got=got):
            _got.append(now)
            return _orig(batch, timestamp, now=now, skip_due=skip_due)
        wq.process_batch = step
        rt.start()
        h = rt.get_input_handler("TempStream")
        for s in range(0, len(ts), 4096):
            h.send_arrays(ts[s:s + 4096],
                          [room[s:s + 4096], temp[s:s + 4096]])
        rt.shutdown()
    assert steps[T] == steps[J]
    assert len(steps[T]) > 2 * 4 + 20   # TIMER steps between the sends
