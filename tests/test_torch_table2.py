"""The reference's tests/test_index.py scenarios on the port (kernel K8;
its plain versions on the CPU): a delete through an @Index probe equals
the reference and the condition pass, for every comparison; conditions
the index cannot serve fall back to the condition pass. Helpers:
test_torch_join_shapes.py."""
import numpy as np
import pytest
import torch

import siddhi_tpu_torch as T
from test_torch_join_shapes import replay_both

torch.set_num_threads(1)


def _index_app(index: bool, op: str):
    idx = "@Index('k')" if index else ""
    return f"""
        @app:playback
        {idx}
        define table T (k int, v string);
        define stream Fill (k int, v string);
        define stream Del (kk int);
        @info(name='fill') from Fill select k, v insert into T;
        @info(name='del') from Del delete T on T.k {op} kk;
    """


@pytest.mark.parametrize("op", ["==", "<", "<=", ">", ">="])
def test_indexed_delete_equals_the_reference_and_the_scan(op, monkeypatch):
    rng = np.random.default_rng(3)
    fill = [("Fill", [(1000 + i, (int(k), f"s{k}"))])
            for i, k in enumerate(rng.integers(0, 20, 40))]
    dels = [("Del", [(2000 + j, (int(k),))])
            for j, k in enumerate(rng.integers(0, 20, 5))]
    left = {}
    for index in (True, False):
        _rj, rt = replay_both(_index_app(index, op), fill + dels, monkeypatch)
        assert (rt.rt.queries["del"].operators[-1].index_probe
                is not None) == index
        left[index] = sorted(rt.rt.query("from T select k, v"))
    assert left[True] == left[False]


def test_index_falls_back_to_the_condition_pass():
    for cond in ("T.v == x", "T.k == x and T.v > 0"):
        rt = T.SiddhiManager(device="cpu").create_siddhi_app_runtime(f"""
            @Index('k') define table T (k int, v int);
            define stream D (x int);
            @info(name='del') from D delete T on {cond};""")
        assert rt.queries["del"].operators[-1].index_probe is None
    rt = T.SiddhiManager(device="cpu").create_siddhi_app_runtime("""
        @PrimaryKey('k') define table T (k int);
        define stream D (x int);
        @info(name='del') from D delete T on T.k == x;""")
    assert rt.queries["del"].operators[-1].index_probe is not None
