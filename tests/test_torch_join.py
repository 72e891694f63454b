"""bench.py's join configurations (kernel K7 and the time windows' K5,
their plain versions on the CPU) against the reference, at a reduced
size: the bench's app verbatim and its feed (seed 9), 4 sends of 1,024
rows per side, StockStream then TwitterStream, with 1,024 symbols
(``join``) and 8,192 symbols (``join_eq``, about 0.125 matches an
event). After every send the rows (floats by their bits, in order), the
statistics, the pairs lost and both sides' window states are equal, bit
for bit. Also:
- the numpy oracle of checks.py (the one chip_smoke.py holds the card's
  run to) equals the reference's rows;
- the grid-pinned run (SIDDHI_TPU_JOIN_KERNEL=grid) gives the probe
  run's rows;
- a reference state carried into the port (carry.py) steps on equal."""
import pytest
import torch

import siddhi_tpu as J
import siddhi_tpu_torch as T
from siddhi_tpu_torch.carry import state_from_jax
from siddhi_tpu_torch.checks import (JOIN_APP, JOIN_EQ_SYMS, JOIN_SYMS,
                                     join_feed, join_oracle, join_symbols)
from test_torch_join_shapes import (KERNEL_ENV, TABLES, MultiRun,
                                    compare_runs, norm)
from test_torch_window import align_strings

torch.set_num_threads(1)

SENDS, ROWS = 4, 1024
CONFIGS = {"join": (JOIN_SYMS, "JA"), "join_eq": (JOIN_EQ_SYMS, "JB")}


@pytest.fixture(scope="module", autouse=True)
def _strings():
    for n, prefix in CONFIGS.values():
        align_strings(join_symbols(n, prefix))


def _feed(config, pkg):
    n, prefix = CONFIGS[config]
    return join_feed(n, SENDS, ROWS, TABLES[pkg].encode, prefix=prefix)


def _run(pkg, config):
    r = MultiRun(pkg, JOIN_APP, out="OutputStream")
    for ts, sym, price, tweets in _feed(config, pkg):
        r.send_arrays("StockStream", ts, [sym, price])
        r.send_arrays("TwitterStream", ts, [sym, tweets])
    return r


_RUNS: dict = {}


def _both(config, monkeypatch):
    """Both packages over the config's feed, compared after every send
    (shared by this module's tests)."""
    if config not in _RUNS:
        monkeypatch.delenv(KERNEL_ENV, raising=False)
        rj = MultiRun(J, JOIN_APP, out="OutputStream")
        rt = MultiRun(T, JOIN_APP, out="OutputStream")
        for i, (fj, ft) in enumerate(zip(_feed(config, J), _feed(config, T))):
            for (ts, sym, price, tweets), r in ((fj, rj), (ft, rt)):
                r.send_arrays("StockStream", ts, [sym, price])
            compare_runs(rj, rt, f"{config} send {i} StockStream")
            for (ts, sym, price, tweets), r in ((fj, rj), (ft, rt)):
                r.send_arrays("TwitterStream", ts, [sym, tweets])
            compare_runs(rj, rt, f"{config} send {i} TwitterStream")
        _RUNS[config] = (rj, rt)
    return _RUNS[config]


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_join_config_equals_the_reference(config, monkeypatch):
    rj, rt = _both(config, monkeypatch)
    assert rt.rows and rt.rt.queries["q"].overflow == 0
    assert {v["kernel"] for v in rt.rt.join_kernels.values()} == {"probe"}


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_the_oracle_equals_the_reference(config, monkeypatch):
    rj, _rt = _both(config, monkeypatch)
    sym, price, tweets = join_oracle(_feed(config, J))
    want = [(TABLES[J].decode(int(s)), norm(float(p)), int(t))
            for s, p, t in zip(sym, price, tweets)]
    assert [r[1] for r in rj.rows] == want


def test_grid_run_gives_the_probe_runs_rows(monkeypatch):
    _rj, rt = _both("join", monkeypatch)
    monkeypatch.setenv(KERNEL_ENV, "grid")
    g = _run(T, "join")
    assert {v["kernel"] for v in g.rt.join_kernels.values()} == {"grid"}
    assert g.rows == rt.rows
    assert g.rt.queries["q"].stats() == rt.rt.queries["q"].stats()


def test_a_carried_reference_state_steps_on_equal(monkeypatch):
    """Two sends through the reference, its state carried into the port
    (both sides' windows, the selector, the counters), then the last two
    sends through both from there."""
    monkeypatch.delenv(KERNEL_ENV, raising=False)
    feeds = {pkg: _feed("join", pkg) for pkg in (J, T)}
    rj = MultiRun(J, JOIN_APP, out="OutputStream")
    for ts, sym, price, tweets in feeds[J][:2]:
        rj.send_arrays("StockStream", ts, [sym, price])
        rj.send_arrays("TwitterStream", ts, [sym, tweets])
    rt = MultiRun(T, JOIN_APP, out="OutputStream")
    snap = rj.rt.queries["q"].snapshot_state()
    carried = state_from_jax(snap, "cpu")
    rt.rt.queries["q"].restore_state(carried)
    # the playback clock, as the reference's last send left it
    rt.rt.on_ingest_ts(int(feeds[T][1][0][-1]))
    rj.rows.clear()
    for i in (2, 3):
        for pkg, r in ((J, rj), (T, rt)):
            ts, sym, price, tweets = feeds[pkg][i]
            r.send_arrays("StockStream", ts, [sym, price])
        compare_runs(rj, rt, f"carried, send {i} StockStream")
        for pkg, r in ((J, rj), (T, rt)):
            ts, sym, price, tweets = feeds[pkg][i]
            r.send_arrays("TwitterStream", ts, [sym, tweets])
        compare_runs(rj, rt, f"carried, send {i} TwitterStream")
    assert rt.rows
