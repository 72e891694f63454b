"""``@watermark`` annotation parsing (port of the host helpers of
siddhi_tpu/resilience/ordering.py).

Only ``config_from_annotation`` and what it needs are carried: the
``watermark-config`` plan rule (analysis/plan_rules.py) calls it at
parse time. Reorder buffers are not ported yet; the planner raises
NotImplementedError for an app that asks for them.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional

LATE_POLICIES = ("DROP", "PROCESS", "STREAM", "STORE")

DEFAULT_REORDER_CAP = 65536

_TIME_RE = re.compile(
    r"(\d+)\s*(millisecond|milliseconds|ms|sec|second|seconds|s|"
    r"min|minute|minutes|hour|hours|h)?")
_UNIT_MS = {"millisecond": 1, "milliseconds": 1, "ms": 1,
            "sec": 1000, "second": 1000, "seconds": 1000, "s": 1000,
            "min": 60_000, "minute": 60_000, "minutes": 60_000,
            "hour": 3_600_000, "hours": 3_600_000, "h": 3_600_000}


def parse_lateness_ms(value) -> int:
    """'200 ms' / '2 sec' / bare ms int -> milliseconds; raises
    ValueError on negative or unparseable lateness."""
    s = str(value).strip().strip("'\"").strip()
    if s.startswith("-"):
        raise ValueError(f"lateness must be >= 0, got '{s}'")
    m = _TIME_RE.fullmatch(s)
    if not m:
        raise ValueError(
            f"cannot parse lateness '{s}' (expected e.g. '200 ms', "
            "'2 sec')")
    return int(m.group(1)) * _UNIT_MS[m.group(2) or "ms"]


@dataclasses.dataclass
class WatermarkConfig:
    """One stream's event-time contract (from ``@watermark`` /
    ``@app:watermark`` annotations)."""

    lateness_ms: int
    policy: str = "DROP"
    cap: int = DEFAULT_REORDER_CAP
    dedup: bool = False
    late_stream: Optional[str] = None  # STREAM policy side-output target


def config_from_annotation(ann) -> WatermarkConfig:
    """Shared parser for ``@watermark``/``@app:watermark`` annotations —
    the plan rule (`watermark-config`) and the runtime planner both call
    this, so parse-time validation and runtime behavior cannot drift.
    Raises ValueError with a user-facing message on any bad element."""
    def _el(key):
        v = ann.element(key)
        return None if v is None else str(v).strip().strip("'\"")

    lateness = _el("lateness")
    if lateness is None and ann.positional:
        lateness = str(ann.positional[0]).strip().strip("'\"")
    if lateness is None:
        raise ValueError(
            "@watermark needs a lateness bound, e.g. "
            "@watermark(lateness='200 ms')")
    lateness_ms = parse_lateness_ms(lateness)
    policy = (_el("policy") or "DROP").upper()
    if policy not in LATE_POLICIES:
        raise ValueError(
            f"unknown @watermark policy '{policy}' (expected one of "
            f"{', '.join(LATE_POLICIES)})")
    cap_s = _el("cap")
    cap = DEFAULT_REORDER_CAP
    if cap_s is not None:
        try:
            cap = int(cap_s)
        except ValueError:
            cap = 0
        if cap <= 0:
            raise ValueError(
                f"@watermark cap='{cap_s}' must be a positive integer")
    dedup_s = _el("dedup")
    dedup = False
    if dedup_s is not None:
        if dedup_s.lower() not in ("true", "false"):
            raise ValueError(
                f"@watermark dedup='{dedup_s}' must be true or false")
        dedup = dedup_s.lower() == "true"
    late_stream = _el("late.stream")
    if late_stream is not None and policy != "STREAM":
        raise ValueError(
            "@watermark late.stream only applies with policy='STREAM'")
    if policy == "STREAM" and late_stream is None:
        raise ValueError(
            "@watermark policy='STREAM' needs late.stream='<defined "
            "stream with the same schema>'")
    return WatermarkConfig(lateness_ms=lateness_ms, policy=policy,
                           cap=cap, dedup=dedup, late_stream=late_stream)
