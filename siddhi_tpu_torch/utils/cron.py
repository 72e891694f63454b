"""Quartz-style cron expression evaluation (host side): a copy of
siddhi_tpu/utils/cron.py, which imports no backend.

The reference's cron window and cron trigger delegate to the Quartz
scheduler (CronWindowProcessor.java:156-185, trigger/CronTrigger.java).
Here the schedule computation is a small pure-Python next-fire calculator;
firing goes through the app Scheduler (wall clock or playback replay).

Supported syntax per field: ``*``, ``?``, ``N``, ``A-B``, ``*/S``,
``A-B/S``, ``A/S`` and comma lists; fields are
``sec min hour day-of-month month day-of-week [year]`` (6 or 7 fields,
Quartz order). Month 1-12; day-of-week 1-7 with 1 = Sunday (Quartz
convention), names (SUN-SAT, JAN-DEC) accepted. L/W/# specials are not
supported.
"""
from __future__ import annotations

import calendar
import datetime as _dt

_MONTHS = {m: i + 1 for i, m in enumerate(
    "JAN FEB MAR APR MAY JUN JUL AUG SEP OCT NOV DEC".split())}
_DOWS = {d: i + 1 for i, d in enumerate(
    "SUN MON TUE WED THU FRI SAT".split())}


class CronError(ValueError):
    pass


def _parse_field(text: str, lo: int, hi: int, names=None) -> frozenset:
    def val(tok: str) -> int:
        tok = tok.strip().upper()
        if names and tok in names:
            return names[tok]
        try:
            v = int(tok)
        except ValueError:
            raise CronError(f"bad cron token '{tok}'")
        if not lo <= v <= hi:
            raise CronError(f"cron value {v} out of range [{lo},{hi}]")
        return v

    out = set()
    for part in text.split(","):
        part = part.strip()
        step, had_step = 1, False
        if "/" in part:
            part, s = part.split("/", 1)
            try:
                step = int(s)
            except ValueError:
                raise CronError(f"bad cron step '{s}'")
            had_step = True
            if step <= 0:
                raise CronError("cron step must be positive")
        if part in ("*", "?", ""):
            a, b = lo, hi
        elif "-" in part and not part.lstrip("-").isdigit():
            a_s, b_s = part.split("-", 1)
            a, b = val(a_s), val(b_s)
        else:
            a = val(part)
            b = hi if had_step else a  # Quartz: "N/S" = from N, step S
        if b < a:
            raise CronError(f"inverted cron range '{part}'")
        out.update(range(a, b + 1, step))
    return frozenset(out)


class CronSchedule:
    """Parsed cron expression with a next-fire computer."""

    def __init__(self, expr: str):
        fields = expr.split()
        if len(fields) not in (6, 7):
            raise CronError(
                f"cron expression needs 6-7 fields, got {len(fields)}: "
                f"'{expr}'")
        self.expr = expr
        self.sec = _parse_field(fields[0], 0, 59)
        self.min = _parse_field(fields[1], 0, 59)
        self.hour = _parse_field(fields[2], 0, 23)
        self.dom = _parse_field(fields[3], 1, 31)
        self.mon = _parse_field(fields[4], 1, 12, _MONTHS)
        self.dow = _parse_field(fields[5], 1, 7, _DOWS)
        self.year = _parse_field(fields[6], 1970, 2199) if len(fields) == 7 \
            else None
        self._dom_any = fields[3] in ("*", "?")
        self._dow_any = fields[5] in ("*", "?")

    def _day_matches(self, d: _dt.date) -> bool:
        dom_ok = d.day in self.dom
        dow_ok = (d.isoweekday() % 7) + 1 in self.dow  # 1 = Sunday
        if self._dom_any and self._dow_any:
            return True
        if self._dom_any:
            return dow_ok
        if self._dow_any:
            return dom_ok
        return dom_ok or dow_ok  # Quartz ORs when both are restricted

    def next_fire(self, after_ms: int) -> int:
        """Smallest fire time strictly after after_ms (UTC), in ms.
        Raises CronError if none within ~4 years."""
        t = _dt.datetime.fromtimestamp(after_ms // 1000 + 1,
                                       tz=_dt.timezone.utc)
        secs = sorted(self.sec)
        mins = sorted(self.min)
        hours = sorted(self.hour)
        day = t.date()
        first = True
        for _ in range(366 * 4 + 2):
            if day.month in self.mon and \
                    (self.year is None or day.year in self.year) and \
                    self._day_matches(day):
                h0, m0, s0 = (t.hour, t.minute, t.second) if first \
                    else (0, 0, 0)
                for h in hours:
                    if h < h0:
                        continue
                    for m in mins:
                        if h == h0 and m < m0:
                            continue
                        for s in secs:
                            if h == h0 and m == m0 and s < s0:
                                continue
                            fire = _dt.datetime(
                                day.year, day.month, day.day, h, m, s,
                                tzinfo=_dt.timezone.utc)
                            return int(fire.timestamp() * 1000)
            day = day + _dt.timedelta(days=1)
            first = False
        raise CronError(f"cron '{self.expr}' never fires")
