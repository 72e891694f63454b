"""The stream functions (ops/streamfn.py: #pol2Cart, #log) against the
reference, on the CPU: pol2Cart's appended cartX, cartY (within 2 ulp:
cos and sin are math-library functions) and cartZ (bit-equal) with
nulls, the appended attributes read downstream in the same chain, the
reference's own cases of tests/test_io_ext.py, #log's printed lines
(compared per send as a set of lines, as the reference prints them
asynchronously), and an extension stream function, which raises "not
ported yet"."""
import struct

import numpy as np
import pytest
import torch

import siddhi_tpu as J
import siddhi_tpu_torch as T

torch.set_num_threads(1)

PLAYBACK = "@app:playback "


def run(pkg, app, sends, out="Out", stream="S"):
    kw = {"device": "cpu"} if pkg is T else {}
    rt = pkg.SiddhiManager(**kw).create_siddhi_app_runtime(PLAYBACK + app)
    got = []
    rt.add_callback(out, pkg.StreamCallback(
        fn=lambda evs: got.extend((e.timestamp, e.data) for e in evs)))
    rt.start()
    h = rt.get_input_handler(stream)
    for rows in sends:
        h.send([pkg.Event(ts, row) for ts, row in rows])
    rt.shutdown()
    return got


def ulp(a: float, b: float) -> int:
    if a != a and b != b:
        return 0

    def o(x):
        i = struct.unpack("<q", struct.pack("<d", x))[0]
        return -(i & 0x7FFFFFFFFFFFFFFF) if i < 0 else i
    return abs(o(a) - o(b))


def _radar(n, seed):
    rng = np.random.default_rng(seed)
    rows = []
    for k in range(n):
        theta = float(rng.uniform(-4, 4))
        rho = float(rng.uniform(0, 100))
        z = float(np.float32(rng.standard_normal()))
        row = [k, theta, rho, z]
        if k % 7 == 3:
            row[1 + k % 3] = None
        rows.append((1000 + k, tuple(row)))
    return [rows[i:i + 16] for i in range(0, n, 16)]


POLAR = """
    define stream S (id int, theta double, rho double, z float);
    from S[rho is null or rho > 5.0]#pol2Cart(theta, rho, z)
    select id, cartX, cartY, cartZ insert into Out;"""


def test_pol2cart_equals_the_reference():
    sends = _radar(160, seed=1)
    got, want = run(T, POLAR, sends), run(J, POLAR, sends)
    assert len(got) == len(want) > 100
    worst = 0
    for (gts, g), (wts, w) in zip(got, want):
        assert gts == wts and g[0] == w[0]
        for gx, wx in zip(g[1:3], w[1:3]):
            assert (gx is None) == (wx is None), (g, w)
            if gx is not None:
                worst = max(worst, ulp(gx, wx))
        assert struct.pack("<d", g[3]) == struct.pack("<d", w[3]) \
            if w[3] is not None else g[3] is None
    assert worst <= 2


def test_pol2cart_then_filter_and_math():
    """The appended attributes read downstream in the same chain (a
    filter after the stream function, math in the projection)."""
    app = """
        define stream S (theta double, rho double);
        from S#pol2Cart(theta, rho)[cartX > 1.0]
        select cartX, math:abs(cartY) as ay, theta insert into Out;"""
    sends = [[(1000, (0.0, 2.0)), (1001, (0.0, 0.5)), (1002, (3.0, 4.0)),
              (1003, (-0.5, 3.0))]]
    got, want = run(T, app, sends), run(J, app, sends)
    assert len(got) == len(want) == 2
    for (_t, g), (_u, w) in zip(got, want):
        assert all(ulp(a, b) <= 2 for a, b in zip(g, w))


def test_io_ext_stream_function_cases():
    """tests/test_io_ext.py's TestStreamFunctions, through the port."""
    got = run(T, """
        define stream S (theta double, rho double);
        @info(name = 'q')
        from S#pol2Cart(theta, rho)
        select theta, rho, cartX, cartY insert into Out;""",
              [[(1000, (0.0, 2.0))]])
    ((_ts, d),) = got
    assert round(d[2], 6) == 2.0 and round(d[3], 6) == 0.0
    got = run(T, """
        define stream S (v int);
        @info(name = 'q')
        from S#log('checkpoint') select v insert into Out;""",
              [[(1000, (7,))]])
    assert [d[0] for _ts, d in got] == [7]
    got = run(T, """
        define stream S (theta double, rho double);
        @info(name = 'q')
        from S#pol2Cart(theta, rho)[cartX > 1.0]
        select cartX insert into Out;""",
              [[(1000, (0.0, 2.0))], [(1001, (0.0, 0.5))]])
    assert len(got) == 1


LOG_APP = """
    define stream S (v int, sym string, x double);
    from S#log('INFO', 'checkpoint') select v insert into Out;"""


def _log_sends():
    rng = np.random.default_rng(6)
    return [[(1000 + 16 * s + k, (int(rng.integers(-9, 9)),
                                  ["IBM", "WSO2"][k % 2],
                                  float(rng.standard_normal())))
             for k in range(16)] for s in range(3)]


@pytest.mark.parametrize("priority,message", [("INFO", "checkpoint"),
                                              (None, "only a message")])
def test_log_lines_equal_the_reference(capsys, priority, message):
    args = f"'{priority}', '{message}'" if priority else f"'{message}'"
    app = LOG_APP.replace("'INFO', 'checkpoint'", args)
    lines = {}
    for pkg in (J, T):
        capsys.readouterr()
        per_send = []
        kw = {"device": "cpu"} if pkg is T else {}
        rt = pkg.SiddhiManager(**kw).create_siddhi_app_runtime(
            PLAYBACK + app)
        rt.start()
        h = rt.get_input_handler("S")
        for rows in _log_sends():
            h.send([pkg.Event(ts, row) for ts, row in rows])
            if pkg is J:
                import jax
                jax.effects_barrier()
            per_send.append(set(capsys.readouterr().out.splitlines()))
        rt.shutdown()
        lines[pkg] = per_send
    assert lines[T] == lines[J]
    assert all(len(s) == 16 for s in lines[T])
    assert next(iter(lines[T][0])).startswith(
        f"[{priority or 'INFO'}] {message}, StreamEvent{{ timestamp=")


def test_extension_stream_function_not_ported():
    app = """define stream S (v int);
        from S#custom:thing(v) select v insert into Out;"""
    with pytest.raises(NotImplementedError, match="not ported yet"):
        T.SiddhiManager(device="cpu").create_siddhi_app_runtime(app)
