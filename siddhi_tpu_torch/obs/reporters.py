"""Metric reporter names (port of the parse-time surface of
siddhi_tpu/obs/reporters.py). The ``statistics-reporter`` plan rule
(analysis/plan_rules.py) validates ``@app:statistics(reporter=...)``
against this tuple; the periodic reporters are not ported yet."""

REPORTER_NAMES = ("console", "log", "file", "jsonl")

DEFAULT_INTERVAL_MS = 60_000
