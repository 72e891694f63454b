"""Replay the reference corpus's join cases through the port, on the
CPU: the 17 cases of tests/ref_corpus/join_{Join,OuterJoin}TestCase.json
(the reference's own app text and events under @app:playback with a
virtual clock), each under both join kernels
(SIDDHI_TPU_JOIN_KERNEL=probe and =grid), as the reference's
tests/test_join_probe.py sweeps them:
- the port's rows (in and removed, in order) equal the reference's
  under the same kernel, and they equal the Java test suite's expected
  rows where the reference's do (no join case is a known failure);
- the cases that expect a deploy error raise in both packages."""
import json

import pytest
import torch

import siddhi_tpu as J
from siddhi_tpu_torch import SiddhiManager
from test_torch_pattern_corpus import (DIR, _is_ordered_subset, _rows_match,
                                       replay)
from test_torch_scan_corpus import replay_reference

torch.set_num_threads(1)

FILES = ("Join", "OuterJoin")
KERNEL_ENV = "SIDDHI_TPU_JOIN_KERNEL"


def _cases() -> dict:
    out = {}
    for k in FILES:
        stem = f"join_{k}TestCase"
        for c in json.loads((DIR / f"{stem}.json").read_text())["cases"]:
            out[f"{stem}.{c['name']}"] = c
    return out


CASES = _cases()
KNOWN = {ln.split("|")[0].strip()
         for ln in (DIR / "known_failures.txt").read_text().splitlines()
         if ln.startswith("join_")}
ERRORS = sorted(c for c in CASES if CASES[c].get("expect_error"))
RUNS = sorted(set(CASES) - set(ERRORS))


def test_the_split_covers_the_join_cases():
    assert len(CASES) == 17 and len(ERRORS) == 5 and not KNOWN


def check_java(case, state) -> None:
    """The Java suite's expectations, as test_corpus.py checks them."""
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


# the cases in two halves: the second runs in test_torch_join_corpus2.py
HALVES = [RUNS[:len(RUNS) // 2], RUNS[len(RUNS) // 2:]]


@pytest.mark.parametrize("kernel", ["probe", "grid"])
@pytest.mark.parametrize("cid", HALVES[0])
def test_join_case_replays_like_the_reference(cid, kernel, monkeypatch):
    check_case(cid, kernel, monkeypatch)


def check_case(cid, kernel, monkeypatch) -> None:
    monkeypatch.setenv(KERNEL_ENV, kernel)
    case = CASES[cid]
    got, want = replay(case), replay_reference(case)
    assert (got["in"], got["rm"]) == (want["in"], want["rm"])
    assert got["in_rows"] == want["in_rows"]
    assert got["rm_rows"] == want["rm_rows"]
    if cid not in KNOWN:
        check_java(case, got)


@pytest.mark.parametrize("cid", ERRORS)
def test_join_case_that_expects_an_error_raises_in_both(cid):
    text = "@app:playback " + CASES[cid]["app"]
    with pytest.raises(Exception):
        J.SiddhiManager().create_siddhi_app_runtime(text)
    with pytest.raises(Exception):
        SiddhiManager(device="cpu").create_siddhi_app_runtime(text)
