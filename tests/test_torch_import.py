"""The port stands alone: siddhi_tpu_torch imports and runs the filter
app, a pattern app, a windowed aggregation, the join app and
stock_table (with an on-demand query) with jax and siddhi_tpu blocked,
neither the package nor
chip_smoke.py imports them, and the manager never falls back to the CPU
on its own."""
import ast
import pathlib
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "siddhi_tpu")

BLOCKED_RUN = r"""
import importlib.abc, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "siddhi_tpu"):
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Block())
import numpy as np
from siddhi_tpu_torch import SiddhiManager, StreamCallback
from siddhi_tpu_torch.checks import FILTER_APP, filter_feed
from siddhi_tpu_torch.core.types import GLOBAL_STRINGS

rt = SiddhiManager(device="cpu").create_siddhi_app_runtime(FILTER_APP)
rows = []
rt.add_callback("OutputStream", StreamCallback(rows.extend))
rt.start()
ts, cols = filter_feed(4096, GLOBAL_STRINGS.encode)
rt.get_input_handler("StockStream").send_arrays(ts, cols)
assert len(rows) == int((cols[1] > np.float32(100.0)).sum()) > 0

# a pattern app: seq5 over one send of 2,048 bench rows
from siddhi_tpu_torch.checks import SEQ5_APP, Seq5Feed
rt = SiddhiManager(device="cpu").create_siddhi_app_runtime(SEQ5_APP)
matches = []
rt.add_callback("Out", StreamCallback(matches.extend))
rt.start()
rt.get_input_handler("T").send_arrays(*Seq5Feed(GLOBAL_STRINGS.encode)
                                      .next(2048))
assert len(matches) == 368, len(matches)   # the reference's count

# a window and aggregators: window_agg over 2,048 bench rows
from siddhi_tpu_torch.checks import WINDOW_AGG_APP, window_agg_feed
rt = SiddhiManager(device="cpu").create_siddhi_app_runtime(WINDOW_AGG_APP)
flushes = []
rt.add_callback("OutputStream", StreamCallback(flushes.extend))
rt.start()
rt.get_input_handler("StockStream").send_arrays(
    *window_agg_feed(2048, GLOBAL_STRINGS.encode))
assert len(flushes) == 2, len(flushes)

# joins, tables and on-demand queries: the join app and stock_table
import siddhi_tpu_torch.core.ondemand, siddhi_tpu_torch.ops.join
import siddhi_tpu_torch.ops.table, siddhi_tpu_torch.carry
from siddhi_tpu_torch.checks import (JOIN_APP, STOCK_TABLE_APP, join_feed,
                                     stock_table_feed)
rt = SiddhiManager(device="cpu").create_siddhi_app_runtime(JOIN_APP)
joined = []
rt.add_callback("OutputStream", StreamCallback(joined.extend))
rt.start()
for ts, sym, price, tweets in join_feed(64, 2, 256, GLOBAL_STRINGS.encode):
    rt.get_input_handler("StockStream").send_arrays(ts, [sym, price])
    rt.get_input_handler("TwitterStream").send_arrays(ts, [sym, tweets])
assert joined
rt = SiddhiManager(device="cpu").create_siddhi_app_runtime(STOCK_TABLE_APP)
looked = []
rt.add_callback("OutputStream", StreamCallback(looked.extend))
rt.start()
for stream, ts, cols in stock_table_feed(32, 1, 64, GLOBAL_STRINGS.encode):
    rt.get_input_handler(stream).send_arrays(ts, cols)
assert len(looked) == 64, len(looked)
assert len(rt.query("from StockTable select symbol")) == 32
loaded = [m for m in sys.modules
          if m.split(".")[0] in ("jax", "jaxlib", "siddhi_tpu")]
assert not loaded, loaded
print("OK", len(rows))
"""


def test_port_runs_with_jax_and_reference_blocked():
    r = subprocess.run([sys.executable, "-c", BLOCKED_RUN], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.startswith("OK ")


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in
    list((ROOT / "siddhi_tpu_torch").rglob("*.py"))
    + [ROOT / "chip_smoke.py"]))
def test_no_jax_or_reference_import(path):
    bad = [m for m in _imports(ROOT / path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_manager_without_cuda_raises(monkeypatch):
    from siddhi_tpu_torch import SiddhiManager
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SiddhiManager()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SiddhiManager(device="cuda:0")
    assert SiddhiManager(device="cpu").device.type == "cpu"
