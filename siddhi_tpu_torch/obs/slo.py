"""``@app:slo`` annotation parsing (port of the host helpers of
siddhi_tpu/obs/slo.py).

Only ``config_from_annotation`` and the objective it returns are
carried: the ``slo-config`` plan rule (analysis/plan_rules.py) calls it
at parse time. The SLO engine itself is not ported yet; the planner
raises NotImplementedError for an app that asks for it.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional

FAST_WINDOW_MS = 5 * 60 * 1000       # fast burn window (5 min)
SLOW_WINDOW_MS = 60 * 60 * 1000      # slow burn window / SLO window (1 h)
DEFAULT_TARGET = 0.99
DEFAULT_WARN_BURN = 2.0
DEFAULT_PAGE_BURN = 14.4             # the classic 30d-budget page rate

_TIME = re.compile(
    r"(\d+(?:\.\d+)?)\s*(millisecond|milliseconds|ms|sec|second|seconds|"
    r"s|min|minute|minutes|hour|hours|h)?")
_UNIT_MS = {"millisecond": 1, "milliseconds": 1, "ms": 1,
            "sec": 1000, "second": 1000, "seconds": 1000, "s": 1000,
            "min": 60_000, "minute": 60_000, "minutes": 60_000,
            "hour": 3_600_000, "hours": 3_600_000, "h": 3_600_000}


def _time_ms(value, role: str) -> float:
    """'250 ms' / '5 sec' / bare ms number -> milliseconds (ValueError
    on anything else — the ``slo-config`` plan rule's to surface)."""
    if isinstance(value, (int, float)) and not isinstance(value, bool):
        ms = float(value)
    else:
        m = _TIME.fullmatch(str(value).strip().strip("'\""))
        if not m:
            raise ValueError(
                f"{role}: cannot parse time '{value}' "
                "(expected e.g. '250 ms', '5 sec', '1 min')")
        ms = float(m.group(1)) * _UNIT_MS[m.group(2) or "ms"]
    if ms <= 0:
        raise ValueError(f"{role}: must be positive, got {value!r}")
    return ms


@dataclasses.dataclass(frozen=True)
class SLOObjective:
    """One latency objective: bound(s) + target attainment + burn
    windows. ``p99_ms`` is the burn-rate bound; ``p50_ms`` is an
    additional reported bound (attainment only, no paging)."""

    p99_ms: Optional[float] = None
    p50_ms: Optional[float] = None
    target: float = DEFAULT_TARGET
    window_ms: float = SLOW_WINDOW_MS     # slow burn / SLO window
    fast_ms: float = FAST_WINDOW_MS       # fast burn window
    warn_burn: float = DEFAULT_WARN_BURN
    page_burn: float = DEFAULT_PAGE_BURN
    every: Optional[int] = None           # sampling stride override

    @property
    def bound_ms(self) -> Optional[float]:
        return self.p99_ms if self.p99_ms is not None else self.p50_ms

    @property
    def budget(self) -> float:
        return max(1e-9, 1.0 - self.target)

    def as_dict(self) -> dict:
        d = {"target": self.target,
             "window_ms": self.window_ms, "fast_ms": self.fast_ms,
             "warn_burn": self.warn_burn, "page_burn": self.page_burn}
        if self.p99_ms is not None:
            d["p99_ms"] = self.p99_ms
        if self.p50_ms is not None:
            d["p50_ms"] = self.p50_ms
        return d


def config_from_annotation(ann) -> SLOObjective:
    """``@app:slo(p99='250 ms', target='0.99', window='1 hour',
    fast='5 min', warn.burn='2', page.burn='14.4', every='64')`` ->
    SLOObjective. Raises ValueError on any bad value — shared by the
    ``slo-config`` plan rule (parse time) and the planner backstop
    (validate=False / hand-built ASTs) so validation cannot drift from
    planner behavior (the watermark-config pattern)."""
    def num(key, role, lo=None):
        v = ann.element(key)
        if v is None:
            return None
        try:
            f = float(str(v).strip().strip("'\""))
        except ValueError:
            raise ValueError(f"@app:slo {role}: cannot parse '{v}'")
        if lo is not None and f <= lo:
            raise ValueError(f"@app:slo {role}: must be > {lo}, got {v}")
        return f

    p99 = ann.element("p99")
    p50 = ann.element("p50")
    if p99 is None and p50 is None:
        raise ValueError(
            "@app:slo needs a latency bound: p99='...' and/or p50='...'")
    kw: dict = {}
    if p99 is not None:
        kw["p99_ms"] = _time_ms(p99, "@app:slo p99")
    if p50 is not None:
        kw["p50_ms"] = _time_ms(p50, "@app:slo p50")
    target = num("target", "target", lo=0.0)
    if target is not None:
        if not (0.0 < target < 1.0):
            raise ValueError(
                f"@app:slo target: must be in (0, 1), got {target}")
        kw["target"] = target
    w = ann.element("window")
    if w is not None:
        kw["window_ms"] = _time_ms(w, "@app:slo window")
    f = ann.element("fast")
    if f is not None:
        kw["fast_ms"] = _time_ms(f, "@app:slo fast")
    if kw.get("fast_ms", FAST_WINDOW_MS) > kw.get("window_ms",
                                                  SLOW_WINDOW_MS):
        raise ValueError(
            "@app:slo fast window must not exceed the slow window")
    wb = num("warn.burn", "warn.burn", lo=0.0)
    pb = num("page.burn", "page.burn", lo=0.0)
    if wb is not None:
        kw["warn_burn"] = wb
    if pb is not None:
        kw["page_burn"] = pb
    if kw.get("warn_burn", DEFAULT_WARN_BURN) > \
            kw.get("page_burn", DEFAULT_PAGE_BURN):
        raise ValueError("@app:slo warn.burn must not exceed page.burn")
    ev = ann.element("every")
    if ev is not None:
        try:
            n = int(str(ev).strip().strip("'\""))
        except ValueError:
            n = 0
        if n <= 0:
            raise ValueError(
                f"@app:slo every: must be a positive integer, got '{ev}'")
        kw["every"] = n
    return SLOObjective(**kw)
