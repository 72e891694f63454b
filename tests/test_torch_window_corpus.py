"""Replay the reference corpus's window cases through the port, on the
CPU: the 39 cases of tests/ref_corpus/window_{LengthBatch,Length,
TimeBatch,Time}WindowTestCase.json, with test_torch_pattern_corpus's
replay (the reference's own app text and events under @app:playback
with a virtual clock, checked against the expected rows of the Java
test suite). They split four ways:
- against the Java rows: the cases below that run;
- the cases that expect a deploy error: both packages raise one;
- none needs what the port does not have yet (lengthWindowTest4, with
  max, min, distinctCount and stdDev over a length window, replays like
  Java since the stateful aggregators are ported);
- the corpus's one known window failure (lengthBatchWindowTest14, a
  join) gives the reference's rows.
Also: CountPattern testQuery17-20, pattern queries whose selectors
aggregate (kernel K6 over the scan engine's matches), replay with rows
equal to the reference's."""
import json

import pytest
import torch

from siddhi_tpu_torch import SiddhiManager
from test_torch_pattern_corpus import (DIR, _is_ordered_subset, _rows_match,
                                       replay)
from test_torch_scan_corpus import CASES as SCAN_CASES
from test_torch_scan_corpus import replay_reference

torch.set_num_threads(1)

FILES = ("LengthBatch", "Length", "TimeBatch", "Time")


def _cases() -> dict:
    out = {}
    for k in FILES:
        stem = f"window_{k}WindowTestCase"
        for c in json.loads((DIR / f"{stem}.json").read_text())["cases"]:
            out[f"{stem}.{c['name']}"] = c
    return out


CASES = _cases()
KNOWN = {ln.split("|")[0].strip()
         for ln in (DIR / "known_failures.txt").read_text().splitlines()
         if ln.startswith("window_")}
ERRORS = sorted(c for c in CASES if CASES[c].get("expect_error"))
JAVA = sorted(set(CASES) - set(ERRORS) - KNOWN)


def test_the_split_covers_the_window_cases():
    assert len(CASES) == 39
    assert KNOWN & set(CASES) == {
        "window_LengthBatchWindowTestCase.lengthBatchWindowTest14"}
    assert len(JAVA) == 21 and len(ERRORS) == 17


@pytest.mark.parametrize("cid", JAVA)
def test_window_case_replays_like_java(cid):
    case = CASES[cid]
    state = replay(case)
    if case["expected_in"] is not None:
        assert state["in"] == case["expected_in"], state["in_rows"]
    if case["expected_removed"] is not None:
        assert state["rm"] == case["expected_removed"], state["rm_rows"]
    if case["event_arrived"] is not None:
        assert (state["in"] > 0 or state["rm"] > 0) == case["event_arrived"]
    exp_rows = case["expected_in_rows"]
    if case["expected_in"] == 0 or case["event_arrived"] is False:
        exp_rows = None
    if exp_rows:
        got = state["in_rows"]
        if case["row_mode"] == "exact":
            assert len(got) == len(exp_rows) and all(
                _rows_match(list(g), e) for g, e in zip(got, exp_rows)), \
                f"rows {got} != {exp_rows}"
        else:
            assert _is_ordered_subset(got, exp_rows), \
                f"rows {got} missing expected {exp_rows}"


@pytest.mark.parametrize("cid", ERRORS)
def test_window_case_that_expects_an_error_raises(cid):
    from siddhi_tpu_torch.ops.expr import CompileError
    with pytest.raises(CompileError):
        SiddhiManager(device="cpu").create_siddhi_app_runtime(
            "@app:playback " + CASES[cid]["app"])


@pytest.mark.parametrize("cid", sorted(KNOWN & set(CASES)))
def test_known_window_failure_gives_the_reference_rows(cid):
    got, want = replay(CASES[cid]), replay_reference(CASES[cid])
    assert (got["in"], got["rm"]) == (want["in"], want["rm"])
    assert got["in_rows"] == want["in_rows"]
    assert got["rm_rows"] == want["rm_rows"]


@pytest.mark.parametrize("k", [17, 18, 19, 20])
def test_aggregating_pattern_selector_equals_the_reference(k):
    case = SCAN_CASES[f"pattern_CountPatternTestCase.testQuery{k}"]
    got, want = replay(case), replay_reference(case)
    assert got["in_rows"] == want["in_rows"] and got["in_rows"]
    assert got["rm_rows"] == want["rm_rows"]
