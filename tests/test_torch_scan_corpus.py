"""Replay the reference corpus's pattern and sequence cases that run on
the scan engine (kernel K4's plain version) through the port, on the CPU.

The cases, their JSON and the replay rules are tests/ref_corpus's, as in
test_torch_pattern_corpus.py: the reference's own app text and events
under @app:playback with a virtual clock, checked against the expected
rows of the Java test suite. The 338 cases are every pattern and
sequence case whose planner does not pick the round-parallel engine.
They split two ways:
- against the Java rows: all but the ones below, the three partition
  blocks among them (AbsentPatternTestCase.testQueryAbsent43,
  AbsentWithEveryPatternTestCase.testQuery8 and
  LogicalAbsentPatternTestCase.testQueryAbsent68: the scan engine per
  key slot, parallel/partition.py);
- the six known failures (ref_corpus/known_failures.txt), where the
  reference differs from Java: against the reference's own replay, rows
  and counts equal. The aggregating selectors
  of CountPattern testQuery17-20 run on the port's K6 (ops/aggregators.py)
  and are held against Java like the rest."""
import json
import pathlib

import pytest
import torch

import siddhi_tpu as J
from test_torch_pattern_corpus import (DIR, FUNCTION_CASES, PARALLEL_CASES,
                                       T0, _is_ordered_subset, _rows_match,
                                       replay)

torch.set_num_threads(1)

def _known_failures() -> set:
    lines = (pathlib.Path(DIR) / "known_failures.txt").read_text()
    return {ln.split("|")[0].strip() for ln in lines.splitlines()
            if ln.strip() and not ln.startswith("#")
            and ln.startswith(("pattern", "sequence"))}


KNOWN = _known_failures()


def _scan_cases() -> dict:
    out = {}
    for f in sorted(pathlib.Path(DIR).glob("*.json")):
        if not f.name.startswith(("pattern", "sequence")):
            continue
        for c in json.loads(f.read_text())["cases"]:
            cid = f"{f.stem}.{c['name']}"
            if cid not in PARALLEL_CASES and cid not in FUNCTION_CASES:
                out[cid] = c
    return out


CASES = _scan_cases()
# the cases whose app is a partition block
PARTITION_CASES = (
    "pattern_absent_AbsentPatternTestCase.testQueryAbsent43",
    "pattern_absent_AbsentWithEveryPatternTestCase.testQuery8",
    "pattern_absent_LogicalAbsentPatternTestCase.testQueryAbsent68")
JAVA = sorted(set(CASES) - KNOWN)


def test_the_split_covers_the_scan_cases():
    assert len(CASES) == 338
    assert len(KNOWN) == 6 and KNOWN <= set(CASES)
    assert sorted(KNOWN_PARTS[0] + KNOWN_PARTS[1]) == sorted(KNOWN)
    assert set(PARTITION_CASES) <= set(JAVA)


@pytest.mark.parametrize("cid", JAVA)
def test_scan_case_replays_like_java(cid):
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


def replay_reference(case) -> dict:
    """The same replay through the reference's SiddhiManager."""
    rt = J.SiddhiManager().create_siddhi_app_runtime(
        "@app:playback " + case["app"])
    state = {"in": 0, "rm": 0, "in_rows": [], "rm_rows": []}

    def on_query(_ts, in_events, rm_events):
        if in_events:
            state["in"] += len(in_events)
            state["in_rows"] += [tuple(e.data) for e in in_events]
        if rm_events:
            state["rm"] += len(rm_events)
            state["rm_rows"] += [tuple(e.data) for e in rm_events]

    def on_stream(events):
        state["in"] += len(events)
        state["in_rows"] += [tuple(e.data) for e in events]

    targets = case["callbacks"] or list(rt.queries)
    q_targets = [t for t in targets if t in rt.queries]
    if q_targets:
        for t in q_targets:
            rt.add_callback(t, J.QueryCallback(fn=on_query))
    else:
        for t in targets:
            rt.add_callback(t, J.StreamCallback(fn=on_stream))
    rt.start()
    with rt.barrier:
        rt.on_ingest_ts(T0)
    clock = T0
    for act in case["actions"]:
        if act[0] == "send":
            _, sid, row = act
            rt.get_input_handler(sid).send(J.Event(clock, tuple(row)))
            clock += 1
        elif act[0] == "sleep":
            clock += act[1]
            with rt.barrier:
                rt.on_ingest_ts(clock)
        elif act[0] == "wait_in":
            _, sleep_ms, retries = act
            for _ in range(retries):
                clock += sleep_ms
                with rt.barrier:
                    rt.on_ingest_ts(clock)
                if state["in"] == 1:
                    break
        elif act[0] == "wait_count":
            _, sleep_ms, want, which, timeout_ms = act
            for _ in range(max(timeout_ms // max(sleep_ms, 1), 1)):
                if state["in" if which == "in" else "rm"] >= want:
                    break
                clock += sleep_ms
                with rt.barrier:
                    rt.on_ingest_ts(clock)
    rt.shutdown()
    return state


# the known failures in two parts: the sequences' but one run in
# test_torch_scan_corpus2.py
KNOWN_PARTS = [sorted(c for c in KNOWN if c.startswith("pattern")
                      or c.endswith("testQueryAbsent48")),
               sorted(c for c in KNOWN if c.startswith("sequence")
                      and not c.endswith("testQueryAbsent48"))]


@pytest.mark.parametrize("cid", KNOWN_PARTS[0])
def test_known_failure_replays_like_the_reference(cid):
    """Where the reference differs from Java, the port equals the
    reference."""
    check_known(cid)


def check_known(cid) -> None:
    case = CASES[cid]
    got, want = replay(case), replay_reference(case)
    assert (got["in"], got["rm"]) == (want["in"], want["rm"])
    assert got["in_rows"] == want["in_rows"]
    assert got["rm_rows"] == want["rm_rows"]
