"""SLO engine: per-tenant / per-query ingest-to-emit latency attribution,
multi-window burn-rate alerting, saturation signals and a flight
recorder (PyTorch port of siddhi_tpu/obs/slo.py; host code, copied).

Measurement model: on an asynchronous device the only honest
ingest->emit number is host wall time around work that is provably
finished, so the engine samples with a stride (``every``: the owner's
choice, ``@app:slo(every=)`` or the pool's ``slo`` dial; the first span
always samples) and the caller synchronises the device on the sampled
branch only. ``TenantPool`` (serving/pool.py)
stamps every queued chunk with its arrival time and, on a sampled fair
round, synchronises after each query's launches and attributes
``arrival -> query emitted`` per (tenant, query), per tenant and for the
pool.

Burn rates follow the multi-window model: an objective is a latency
bound (``p99='250 ms'``) plus a target attainment (``target='0.99'``);
a sample is bad when it exceeds the bound, the budget is
``1 - target`` and ``burn = bad_fraction / budget`` over the fast
(default 5 min) and slow (default 1 h) windows. WARN at
``min(burn_fast, burn_slow) >= warn.burn`` (2), PAGE at ``>=
page.burn`` (14.4). Entering PAGE dumps the flight recorder's ring of
recent spans, admission rejections and state transitions as a JSON
artifact in the recorder's directory (the pool's ``slo={'flight_dir':
...}`` dial), by default ``.siddhi_cache/flightrec`` under the working
directory.

``config_from_annotation`` also serves the ``slo-config`` plan rule
(analysis/plan_rules.py) at parse time. An app runtime's own SLO
engine (``@app:slo`` on a plain app: the ingest spans), its metrics
publication and the migration split (``percentiles_since``) are not
ported yet: the planner raises NotImplementedError for ``@app:slo`` on
an app; pools use the engine.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import threading
import time
from collections import deque
from typing import Callable, Optional

DEFAULT_FLIGHT_DIR = os.path.join(".siddhi_cache", "flightrec")

FAST_WINDOW_MS = 5 * 60 * 1000       # fast burn window (5 min)
SLOW_WINDOW_MS = 60 * 60 * 1000      # slow burn window / SLO window (1 h)
DEFAULT_TARGET = 0.99
DEFAULT_WARN_BURN = 2.0
DEFAULT_PAGE_BURN = 14.4             # the classic 30d-budget page rate

# bounded per-scope reservoir (same windowed model as obs/metrics
# Histogram; scopes are per tenant/query so the cap bounds memory at
# O(scopes * cap))
WINDOW_CAP = 4096

OK, WARN, PAGE = "OK", "WARN", "PAGE"
_STATE_NUM = {OK: 0, WARN: 1, PAGE: 2}

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


def objective_from_dials(dials: dict) -> SLOObjective:
    """Pool-level ``slo={...}`` dial -> SLOObjective (constructor-style
    keys; time-ish values accept '250 ms' strings too)."""
    kw: dict = {}
    for key in ("p99_ms", "p50_ms", "window_ms", "fast_ms"):
        if key in dials and dials[key] is not None:
            kw[key] = _time_ms(dials[key], f"slo dial {key}")
    for key in ("target", "warn_burn", "page_burn"):
        if key in dials and dials[key] is not None:
            kw[key] = float(dials[key])
    if "target" in kw and not (0.0 < kw["target"] < 1.0):
        raise ValueError(
            f"slo dial target must be in (0, 1), got {kw['target']}")
    if "every" in dials and dials["every"] is not None:
        kw["every"] = max(1, int(dials["every"]))
    if kw.get("p99_ms") is None and kw.get("p50_ms") is None:
        raise ValueError(
            "slo dial needs a latency bound: p99_ms and/or p50_ms")
    return SLOObjective(**kw)


class FlightRecorder:
    """Bounded ring of recent observability events (sampled spans,
    admission rejections, state transitions) that ``dump()`` serializes
    — with a caller-supplied context snapshot — into a JSON artifact.

    The ring records host-side dicts only: no device reads, no locks
    beyond its own. ``dump()`` writes tmp+rename (the filesystem error
    store's atomicity contract) and returns the artifact path; callers
    put that path in log lines and assertion messages so a failed run
    is diagnosable after the process is gone."""

    CAP = 256

    # artifact identity keys: EVERY dump's context carries them (None
    # when unknown) so an artifact is always attributable to its app /
    # pool / plan without guessing from the filename
    IDENTITY_KEYS = ("app", "pool", "plan_hash")

    def __init__(self, name: str, cap: int = CAP,
                 dirpath: Optional[str] = None,
                 identity_fn: Optional[Callable[[], dict]] = None):
        self.name = name
        self.dirpath = dirpath
        # identity_fn() -> {"app": ..., "pool": ..., "plan_hash": ...}
        # evaluated at dump time (plan hashes can change on live graph
        # edits); owners set it after construction when the identity is
        # not known yet (SiddhiAppRuntime / TenantPool wiring)
        self.identity_fn = identity_fn
        self._ring: deque = deque(maxlen=max(1, int(cap)))
        self._lock = threading.Lock()
        self._seq = 0
        self.dumps: list[str] = []

    def _identity(self) -> dict:
        ident = {k: None for k in self.IDENTITY_KEYS}
        if self.identity_fn is not None:
            try:
                got = self.identity_fn() or {}
                ident.update({k: got[k] for k in self.IDENTITY_KEYS
                              if k in got})
            except Exception:  # noqa: BLE001 — identity is best-effort
                pass           # at dump time; the dump must still land
        return ident

    def record(self, kind: str, **data) -> None:
        entry = {"t_wall_ms": int(time.time() * 1000), "kind": kind}
        entry.update(data)
        with self._lock:
            self._ring.append(entry)

    def snapshot(self) -> list:
        with self._lock:
            return list(self._ring)

    def dump(self, reason: str, context: Optional[dict] = None,
             path: Optional[str] = None) -> str:
        """Write the artifact; returns its path. Artifact schema
        (docs/observability.md): ``{name, reason, dumped_at_ms, spans:
        [ring entries oldest-first], context: {app, pool, plan_hash,
        ...}}`` — the identity triple is ALWAYS present (None when
        unknown) so every artifact is attributable to its app/pool and
        the plan that produced it, no matter which path triggered the
        dump (PAGE transition, deploy failure, chaos failure)."""
        with self._lock:
            self._seq += 1
            seq = self._seq
            spans = list(self._ring)
        if path is None:
            d = self.dirpath or DEFAULT_FLIGHT_DIR
            os.makedirs(d, exist_ok=True)
            slug = re.sub(r"[^A-Za-z0-9._-]", "_", f"{self.name}.{reason}")
            path = os.path.join(
                d, f"{slug}.{int(time.time() * 1000)}.{seq}.json")
        payload = {"name": self.name, "reason": reason,
                   "dumped_at_ms": int(time.time() * 1000),
                   "spans": spans,
                   "context": {**self._identity(), **(context or {})}}
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=1, sort_keys=True, default=str)
        os.replace(tmp, path)
        with self._lock:
            self.dumps.append(path)
        return path


class _Window:
    """Bounded (wall_ms, latency_ms) reservoir for one scope."""

    __slots__ = ("samples", "count", "sum")

    def __init__(self):
        self.samples: deque = deque(maxlen=WINDOW_CAP)
        self.count = 0      # cumulative, survives reservoir wrap
        self.sum = 0.0

    def add(self, t_ms: float, lat_ms: float) -> None:
        self.samples.append((t_ms, lat_ms))
        self.count += 1
        self.sum += lat_ms

    def in_window(self, now_ms: float, window_ms: float) -> list:
        lo = now_ms - window_ms
        return [v for t, v in self.samples if t >= lo]


def _percentiles(vals: list) -> dict:
    s = sorted(vals)
    n = len(s)
    if not n:
        return {}
    return {"p50_ms": round(s[n // 2], 3),
            "p95_ms": round(s[min(n - 1, (n * 95) // 100)], 3),
            "p99_ms": round(s[min(n - 1, (n * 99) // 100)], 3)}


def scope_name(labels: tuple) -> str:
    """``()`` -> 'total'; ``(("tenant","t1"),("query","q"))`` ->
    'tenant=t1,query=q' — the statistics()['slo']['scopes'] key."""
    if not labels:
        return "total"
    return ",".join(f"{k}={v}" for k, v in labels)


class SLOEngine:
    """Latency objective tracking for one tenant pool.

    Hot-path contract: ``observe()`` appends one tuple to a bounded
    deque under the engine lock — no device work. The sampled sync that
    makes a latency honest lives at the call site (the pool's round
    drain), on the sampled branch only. ``evaluate()`` runs at
    collection time.

    Scope keys are label tuples: ``()`` is the pool aggregate,
    ``(("tenant", tid),)`` and ``(("tenant", tid), ("query", q))`` the
    attribution axes."""

    def __init__(self, name: str, objective: Optional[SLOObjective],
                 every: int,
                 recorder: Optional[FlightRecorder] = None,
                 context_fn: Optional[Callable[[], dict]] = None):
        self.name = name
        self.objective = objective
        self.every = max(1, int(every))
        self.recorder = recorder
        self.context_fn = context_fn
        # RLock: a statistics() walk may run while a dispatch thread
        # observes
        self._lock = threading.RLock()
        self._windows: dict[tuple, _Window] = {}
        self._ticks: dict = {}
        self._states: dict[tuple, str] = {}
        self.breaches = 0          # transitions into PAGE

    # -- stride sampling --------------------------------------------------
    def tick(self, site) -> bool:
        """True on the sampled stride for ``site`` (first call always —
        short runs must still report)."""
        with self._lock:
            n = self._ticks.get(site, 0)
            self._ticks[site] = n + 1
        return n % self.every == 0

    # -- recording --------------------------------------------------------
    def observe(self, labels: tuple, lat_ms: float,
                t_wall_ms: Optional[float] = None, rows: int = 0) -> None:
        """One latency sample for a scope. ``labels`` is a tuple of
        (name, value) pairs (possibly empty = aggregate); ``t_wall_ms``
        defaults to now (tests inject explicit times for deterministic
        window math)."""
        t = time.time() * 1000.0 if t_wall_ms is None else float(t_wall_ms)
        with self._lock:
            w = self._windows.get(labels)
            if w is None:
                w = self._windows[labels] = _Window()
            w.add(t, float(lat_ms))
        if self.recorder is not None:
            self.recorder.record("span", scope=scope_name(labels),
                                 lat_ms=round(lat_ms, 3), rows=rows)

    # -- evaluation -------------------------------------------------------
    def _scope_entry(self, w: _Window, now_ms: float) -> dict:
        obj = self.objective
        slow_ms = obj.window_ms if obj else SLOW_WINDOW_MS
        vals = w.in_window(now_ms, slow_ms)
        entry = {"count": w.count, "window_count": len(vals),
                 **_percentiles(vals)}
        if obj is None or not vals:
            return entry
        bound = obj.bound_ms
        bad_slow = sum(1 for v in vals if v > bound)
        fast_vals = w.in_window(now_ms, obj.fast_ms)
        bad_fast = sum(1 for v in fast_vals if v > bound)
        frac_slow = bad_slow / len(vals)
        frac_fast = bad_fast / len(fast_vals) if fast_vals else 0.0
        burn_slow = frac_slow / obj.budget
        burn_fast = frac_fast / obj.budget
        # round before thresholding: 1 - target is not exactly
        # representable (0.02/0.01 must compare as exactly 2.0)
        burn = round(min(burn_fast, burn_slow), 9)
        state = PAGE if burn >= obj.page_burn else \
            WARN if burn >= obj.warn_burn else OK
        entry.update({
            "attainment": round(1.0 - frac_slow, 5),
            "burn_fast": round(burn_fast, 3),
            "burn_slow": round(burn_slow, 3),
            "state": state,
        })
        if obj.p50_ms is not None and "p50_ms" in entry:
            entry["p50_attained"] = entry["p50_ms"] <= obj.p50_ms
        return entry

    def evaluate(self, now_ms: Optional[float] = None,
                 saturation: Optional[dict] = None) -> dict:
        """The SLO report: per-scope percentiles, attainment, fast/slow
        burn rates and WARN/PAGE states. Detects state transitions; a
        transition into PAGE auto-dumps the flight recorder (once per
        transition, not per scrape)."""
        now = time.time() * 1000.0 if now_ms is None else float(now_ms)
        with self._lock:
            snapshot = list(self._windows.items())
        scopes: dict = {}
        transitions: list = []
        worst = OK
        for labels, w in snapshot:
            entry = self._scope_entry(w, now)
            sname = scope_name(labels)
            scopes[sname] = entry
            st = entry.get("state")
            if st is not None:
                if _STATE_NUM[st] > _STATE_NUM[worst]:
                    worst = st
                with self._lock:
                    prev = self._states.get(labels, OK)
                    if st != prev:
                        self._states[labels] = st
                        transitions.append((sname, prev, st))
        paged = [t for t in transitions if t[2] == PAGE]
        if self.recorder is not None:
            for sname, prev, st in transitions:
                self.recorder.record("slo-state", scope=sname,
                                     frm=prev, to=st)
        report = {"name": self.name, "every": self.every,
                  "objective": self.objective.as_dict()
                  if self.objective else None,
                  "state": worst if self.objective else None,
                  "breaches": self.breaches,
                  "scopes": scopes}
        if saturation is not None:
            report["saturation"] = saturation
        if paged:
            self.breaches += len(paged)
            report["breaches"] = self.breaches
            if self.recorder is not None:
                ctx = {"slo": {k: v for k, v in report.items()
                               if k != "saturation"},
                       "paged_scopes": [s for s, _p, _t in paged]}
                if saturation is not None:
                    ctx["saturation"] = saturation
                if self.context_fn is not None:
                    try:
                        ctx["runtime"] = self.context_fn()
                    except Exception:  # noqa: BLE001 — context is
                        pass           # best-effort at dump time
                report["flight_artifact"] = self.recorder.dump(
                    "slo-breach", context=ctx)
        if self.recorder is not None and self.recorder.dumps:
            report["flight_artifacts"] = list(self.recorder.dumps)
        return report
