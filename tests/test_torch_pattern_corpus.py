"""Replay the reference corpus's pattern cases that run on the
round-parallel engine (kernel K3) through the port, on the CPU.

The cases, their JSON and the replay rules are tests/ref_corpus's
(test_corpus.py replays them through the reference): the reference's own
app text and events under @app:playback with a virtual clock, checked
against the expected rows of the Java test suite. The 13 cases are the
ones whose planner picks ParallelNfaEngine in the reference
(test_torch_pattern.py checks that the port's parallel_supported picks
the same ones); CountPattern testQuery14, whose having calls
instanceOfFloat(), replays the same way.
"""
import json
import pathlib

import pytest
import torch

from siddhi_tpu_torch import Event, QueryCallback, SiddhiManager, \
    StreamCallback

torch.set_num_threads(1)

DIR = pathlib.Path(__file__).parent / "ref_corpus"
T0 = 1_500_000_000_000

PARALLEL_CASES = (
    [f"pattern_CountPatternTestCase.testQuery{k}" for k in range(1, 9)]
    + ["pattern_EveryPatternTestCase.testQuery1",
       "pattern_EveryPatternTestCase.testQuery2",
       "pattern_WithinPatternTestCase.testQuery1",
       "pattern_WithinPatternTestCase.testQuery2"])
# its having calls instanceOfFloat()
FUNCTION_CASES = ["pattern_CountPatternTestCase.testQuery14"]


def _case(cid: str) -> dict:
    stem, name = cid.split(".")
    cases = json.loads((DIR / f"{stem}.json").read_text())["cases"]
    return next(c for c in cases if c["name"] == name)


def _rows_match(got, exp):
    if len(got) != len(exp):
        return False
    for g, e in zip(got, exp):
        if isinstance(e, float):
            if g != pytest.approx(e, rel=1e-5, abs=1e-6):
                return False
        elif g != e:
            return False
    return True


def _is_ordered_subset(got_rows, exp_rows):
    i = 0
    for g in got_rows:
        if i < len(exp_rows) and _rows_match(list(g), exp_rows[i]):
            i += 1
    return i == len(exp_rows)


def replay(case) -> dict:
    """test_corpus.py's replay, through the port's SiddhiManager."""
    rt = SiddhiManager(device="cpu").create_siddhi_app_runtime(
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
            rt.add_callback(t, QueryCallback(fn=on_query))
    else:
        for t in targets:
            rt.add_callback(t, StreamCallback(fn=on_stream))
    rt.start()
    with rt.barrier:
        rt.on_ingest_ts(T0)
    clock = T0
    for act in case["actions"]:
        if act[0] == "send":
            _, sid, row = act
            rt.get_input_handler(sid).send(Event(clock, tuple(row)))
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


def check_case(cid):
    """Replay one case and hold it to the Java rows."""
    case = _case(cid)
    assert not case.get("expect_error")
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


@pytest.mark.parametrize("cid", PARALLEL_CASES)
def test_parallel_case_replays_like_the_reference(cid):
    check_case(cid)


@pytest.mark.parametrize("cid", FUNCTION_CASES)
def test_function_case_replays_like_the_reference(cid):
    check_case(cid)
