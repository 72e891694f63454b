"""Replay the reference corpus's cases of the second-wave windows
through the port, on the CPU: the 36 cases of tests/ref_corpus/
window_{ExternalTimeBatch,TimeLength,Sort,ExternalTime}WindowTestCase
.json, with test_torch_pattern_corpus's replay (the reference's own app
text and events under @app:playback with a virtual clock, checked
against the expected rows of the Java test suite). They split four
ways:
- against the Java rows: the cases below that run;
- the cases that expect a deploy error: both packages raise one;
- none needs what the port does not have yet, and none is among the
  corpus's known failures (the split test holds both)."""
import json

import pytest
import torch

from siddhi_tpu_torch import SiddhiManager
from test_torch_pattern_corpus import (DIR, _is_ordered_subset, _rows_match,
                                       replay)

torch.set_num_threads(1)

FILES = ("ExternalTimeBatch", "TimeLength", "Sort", "ExternalTime")


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
         if ln.startswith("window_")} & set(CASES)
ERRORS = sorted(c for c in CASES if CASES[c].get("expect_error"))
JAVA = sorted(set(CASES) - set(ERRORS))


def test_the_split_covers_the_window_cases():
    assert len(CASES) == 36 and not KNOWN
    assert len(JAVA) + len(ERRORS) == 36


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
