"""The scan engine (kernel K4's plain version) against the reference, on
the CPU: feeds that overflow the 128-row table and the 256-row match
batch (rows, overflow counters and the pending table equal); and over
the reference corpus, the port's planner picks the scan engine, at 128
rows and 256 matches, exactly where the reference's does. Helpers:
test_torch_scan.py."""
import json
import pathlib

import pytest
import torch

import siddhi_tpu as J
import siddhi_tpu_torch as T
from siddhi_tpu_torch.checks import (TABLE_OVERFLOW_APP, TIMEOUT_APP,
                                     timeout_burst_feed, timeout_feed)
from test_torch_scan import Run, assert_runs_equal, send_all

torch.set_num_threads(1)

CORPUS = pathlib.Path(__file__).parent / "ref_corpus"


@pytest.mark.parametrize("what", ["table", "match batch"])
def test_overflow_feeds_equal_the_reference(what):
    """More live requests than the 128-row table holds; more deadlines
    fired in one step than the 256-row match batch holds."""
    if what == "table":
        runs = [Run(pkg, TABLE_OVERFLOW_APP, out="Timeouts")
                for pkg in (J, T)]
        ts, cols = timeout_feed(1024, seed=6, p_answer=0.5)
    else:
        runs = [Run(pkg, TIMEOUT_APP, out="Timeouts") for pkg in (J, T)]
        ts, cols = timeout_burst_feed()
    send_all(runs, "Ev", ts, cols, 1024)
    j, t = runs
    assert_runs_equal(j, t)
    assert t.q.overflow_total() > 0
    if what == "match batch":
        assert len(t.rows()) == 256


# ---------------------------------------------------------------------------
# the planner's choice over the reference corpus
# ---------------------------------------------------------------------------

CORPUS_FILES = sorted(p.name for p in CORPUS.glob("*.json")
                      if p.name.startswith(("pattern", "sequence")))


def engines(pkg, app):
    kw = {"device": "cpu"} if pkg is T else {}
    try:
        rt = pkg.SiddhiManager(**kw).create_siddhi_app_runtime(
            "@app:playback " + app)
    except NotImplementedError as exc:
        return str(exc)
    return sorted((name, type(q.engine).__name__, q.engine.M, q.engine.OUT)
                  for name, q in rt.queries.items() if hasattr(q, "engine"))


@pytest.mark.parametrize("fname", CORPUS_FILES)
def test_planner_picks_the_scan_engine_where_the_reference_does(fname):
    cases = json.loads((CORPUS / fname).read_text())["cases"]
    for c in cases:
        if c.get("expect_error"):
            continue
        t = engines(T, c["app"])
        if isinstance(t, str):
            assert "not ported yet" in t, (c["name"], t)
            continue
        assert t == engines(J, c["app"]), c["name"]
        for _name, kind, M, OUT in t:
            assert (kind, M, OUT) in (("NfaEngine", 128, 256),
                                      ("ParallelNfaEngine", 4096, 16384))
