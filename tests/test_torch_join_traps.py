"""Joins (kernel K7, its plain versions on the CPU) against the reference
on the float-key traps of checks.FLOAT_KEY_APPS: +-0.0, NaN of both
signs and with payloads, +-inf, subnormals, a live key equal to the
pad value, LONG against DOUBLE (the lossy cast of the band key), under
both join kernels, rows and both sides' states bit for bit after every
send; where the reference's own probe and grid disagree (NaN keys), each
port kernel follows the reference's kernel of its name. Also the
planner's kernel pick and its environment override."""
import pytest
import torch

import siddhi_tpu_torch as T
from siddhi_tpu_torch.checks import (FLOAT_KEY_APPS, JOIN_APPS,
                                     join_shape_feed)
from test_torch_join_shapes import KERNEL_ENV, MultiRun, replay_both

torch.set_num_threads(1)


@pytest.mark.parametrize("kernel", ["probe", "grid"])
@pytest.mark.parametrize("app", sorted(FLOAT_KEY_APPS))
def test_float_key_traps_equal_the_reference(app, kernel, monkeypatch):
    """Each kernel equals the reference's kernel of the same name on the
    trap keys (where the reference's probe and grid disagree, on NaN
    keys, each port kernel follows its own)."""
    feed = join_shape_feed(app, 120, seed=7)
    replay_both(FLOAT_KEY_APPS[app], feed, monkeypatch, kernel)


NAN_APP = """
    @app:playback
    define stream L (k double, a int);
    define stream R (k double, b int);
    @info(name = 'q') from L#window.length(1) join R#window.length(1)
    on L.k == R.k select L.k as lk, a, R.k as rk, b insert into Out;
"""


def test_probe_and_grid_disagree_on_nan_keys_in_the_reference(monkeypatch):
    """The reference's probe matches a NaN key with a NaN key where no
    padding follows it in the key view (its sort comparator orders every
    NaN as one value, above +inf, the padding's key), its grid never does
    (IEEE ==). The port keeps both (ROADMAP Queue 3)."""
    feed = [("L", [(1, (float("nan"), 1))]), ("R", [(2, (-float("nan"), 2))])]
    rows = {}
    for kernel in ("probe", "grid"):
        rj, rt = replay_both(NAN_APP, feed, monkeypatch, kernel)
        rows[kernel] = rt.rows
    assert len(rows["probe"]) == 1 and rows["grid"] == []


def test_planner_picks_and_the_env_override(monkeypatch):
    monkeypatch.delenv(KERNEL_ENV, raising=False)
    rt = MultiRun(T, JOIN_APPS["residual"]).rt
    assert {v["kernel"] for v in rt.join_kernels.values()} == {"probe"}
    assert {v["cause"] for v in rt.join_kernels.values()} == \
        {"no-cost-table"}
    rt = MultiRun(T, JOIN_APPS["non_equi"]).rt
    assert {v["cause"] for v in rt.join_kernels.values()} == \
        {"no-equi-conjunct"}
    monkeypatch.setenv(KERNEL_ENV, "grid")
    rt = MultiRun(T, JOIN_APPS["residual"]).rt
    assert {v["kernel"] for v in rt.join_kernels.values()} == {"grid"}
