"""Tenant QoS: rate limits, priority classes, weighted-fair scheduling,
and per-tenant circuit breakers (PyTorch port of
siddhi_tpu/serving/qos.py; host code, copied).

The whole layer is HOST-SIDE policy over the unchanged device steps:
a round's per-tenant take limits, a 429 before a chunk is queued, a
short-circuited callback. Every dial degrades to the plain fair round
at its default:

- **Rate limits** — a token bucket per tenant (``rate.eps`` events/s,
  ``burst`` tokens of headroom). An over-rate ``send`` is rejected with
  an AdmissionError whose saturation payload carries cause
  ``rate-limited`` and the bucket's own ``retry_after_ms`` (time until
  the chunk's tokens accrue) — the service maps it to HTTP 429 with a
  Retry-After header. No rate configured -> no bucket -> no check.

- **Weighted fairness** — deficit round robin replaces the fixed
  batch_max-per-tenant round: each backlogged tenant accrues a quantum
  of ``batch_max * weight / max_weight_in_class`` credits per round and
  takes ``min(credits, pending, batch_max)`` rows, so over any run of
  rounds the rows dispatched per tenant converge to the weight ratio
  even when one tenant's backlog is unbounded (credits reset when a
  tenant's queue empties — classic DRR). All weights equal (the
  default) -> every quantum is batch_max -> bit-identical takes to the
  pre-QoS fair round.

- **Priority classes** — ``high | normal | low`` drain in order under
  backlog: a class is deferred (takes nothing this round) while any
  strictly-higher class still has residual backlog, but never more
  than ``max_defer`` consecutive rounds, so a starved class's p99 stays
  bounded at ``(max_defer + 1) x`` its fair-share round cadence.

- **Circuit breakers** — a tenant whose callback keeps failing trips
  OPEN after ``breaker.failures`` consecutive failed deliveries; while
  OPEN its output rows are counted and logged WITHOUT running the
  callback (the pool stops paying for a dead sink; the reference also
  keeps them in the tenant's error-store partition, which is not ported
  yet); after ``breaker.reset.ms`` one
  HALF_OPEN probe delivery is allowed — success closes the breaker,
  failure re-opens it. Transitions land in ``statistics()['qos']`` and
  the flight recorder.

The port has no kill switch: the pool always plans its rounds here,
and with default dials the plan is exactly the fixed ``batch_max``
round.
"""
from __future__ import annotations

import math
import time
from typing import Callable, Optional

# class rank: lower drains first under backlog
PRIORITIES = {"high": 0, "normal": 1, "low": 2}

# consecutive rounds a lower class may be deferred while a higher class
# drains; bounds priority starvation (docs/serving.md "QoS dials")
DEFAULT_MAX_DEFER = 4

_BREAKER_STATES = ("CLOSED", "HALF_OPEN", "OPEN")


class TokenBucket:
    """Per-tenant ingest rate limiter: ``rate`` tokens/s refill toward a
    ``burst`` ceiling; a chunk of n rows takes n tokens or is rejected
    with the milliseconds until those n tokens will have accrued (the
    429's Retry-After)."""

    def __init__(self, rate: float, burst: float,
                 clock: Callable[[], float] = time.monotonic):
        if rate <= 0:
            raise ValueError(f"rate.eps must be > 0 (got {rate})")
        self.rate = float(rate)
        self.burst = max(float(burst), 1.0)
        self.clock = clock
        self.tokens = self.burst
        self._t_last = clock()

    def _refill(self) -> None:
        now = self.clock()
        self.tokens = min(self.burst,
                          self.tokens + (now - self._t_last) * self.rate)
        self._t_last = now

    def try_take(self, n: int) -> tuple[bool, int]:
        """(accepted, retry_after_ms). Oversized chunks (n > burst) are
        admitted whenever the bucket is full — the debt goes negative
        and refills before the next chunk passes, so a tenant whose
        chunking is coarser than its burst is throttled to the same
        average rate instead of being unservable."""
        self._refill()
        if self.tokens >= min(float(n), self.burst):
            self.tokens -= float(n)
            return True, 0
        need = min(float(n), self.burst) - self.tokens
        return False, max(1, int(math.ceil(need / self.rate * 1000.0)))


class CircuitBreaker:
    """Per-tenant callback breaker: CLOSED -> (``threshold`` consecutive
    delivery failures) -> OPEN -> (``reset_ms`` cooldown) -> HALF_OPEN
    probe -> CLOSED on success / OPEN on failure."""

    def __init__(self, threshold: int, reset_ms: int,
                 clock: Callable[[], float] = time.monotonic,
                 on_transition: Optional[Callable] = None):
        if threshold < 1:
            raise ValueError("breaker.failures must be >= 1")
        self.threshold = int(threshold)
        self.reset_ms = int(reset_ms)
        self.clock = clock
        self.on_transition = on_transition
        self.state = "CLOSED"
        self.failures = 0           # consecutive failures while CLOSED
        self.trips = 0              # CLOSED/HALF_OPEN -> OPEN count
        self.short_circuited = 0    # events routed around the callback
        self._opened_at: Optional[float] = None

    def _move(self, state: str) -> None:
        if state == self.state:
            return
        prev, self.state = self.state, state
        if state == "OPEN":
            self.trips += 1
            self._opened_at = self.clock()
        if self.on_transition is not None:
            self.on_transition(prev, state)

    def gate(self) -> str:
        """Pre-delivery decision: ``closed`` (deliver normally),
        ``probe`` (HALF_OPEN trial delivery), ``open`` (short-circuit).
        Calling gate() when the cooldown has elapsed IS the transition
        to HALF_OPEN — at most one probe is in flight per cooldown."""
        if self.state == "OPEN":
            elapsed_ms = (self.clock() - self._opened_at) * 1000.0
            if elapsed_ms >= self.reset_ms:
                self._move("HALF_OPEN")
                return "probe"
            return "open"
        if self.state == "HALF_OPEN":
            # a probe already went out and has not resolved; keep
            # short-circuiting until record_* settles it
            return "open"
        return "closed"

    def record_success(self) -> None:
        self.failures = 0
        self._move("CLOSED")

    def record_failure(self) -> None:
        if self.state == "HALF_OPEN":
            self._move("OPEN")
            return
        self.failures += 1
        if self.failures >= self.threshold:
            self._move("OPEN")

    def as_dict(self) -> dict:
        return {"state": self.state, "failures": self.failures,
                "trips": self.trips,
                "short_circuited": self.short_circuited,
                "threshold": self.threshold, "reset_ms": self.reset_ms}


class TenantQoS:
    """One tenant's resolved QoS profile (per-tenant dials merged over
    the pool defaults)."""

    __slots__ = ("weight", "priority", "bucket", "breaker")

    def __init__(self, weight: float, priority: str,
                 bucket: Optional[TokenBucket],
                 breaker: Optional[CircuitBreaker]):
        self.weight = weight
        self.priority = priority
        self.bucket = bucket
        self.breaker = breaker


def _get(d: dict, *names, default=None):
    for n in names:
        if d.get(n) is not None:
            return d[n]
    return default


class PoolQoS:
    """The pool's QoS state: per-tenant profiles, DRR credits, class
    deferral counters. All methods are called under the pool lock."""

    def __init__(self, defaults: Optional[dict] = None,
                 clock: Callable[[], float] = time.monotonic,
                 on_transition: Optional[Callable] = None):
        d = dict(defaults or {})
        self.clock = clock
        self.on_transition = on_transition   # fn(tenant, prev, state)
        self.default_rate = _get(d, "rate_eps", "rate.eps")
        self.default_burst = _get(d, "rate_burst", "burst", "rate.burst")
        self.default_weight = float(_get(d, "weight", default=1.0))
        self.default_priority = self._check_priority(
            _get(d, "priority", default="normal"))
        self.breaker_failures = _get(d, "breaker_failures",
                                     "breaker.failures")
        self.breaker_reset_ms = int(_get(d, "breaker_reset_ms",
                                         "breaker.reset.ms",
                                         default=30_000))
        self.max_defer = int(_get(d, "max_defer", "max.defer",
                                  default=DEFAULT_MAX_DEFER))
        self._tenants: dict[str, TenantQoS] = {}
        self._deficit: dict[str, float] = {}
        self._defer: dict[int, int] = {}     # class rank -> deferred rounds
        self.deferrals: dict[str, int] = {}  # priority name -> total
        self.short_circuited = 0

    @staticmethod
    def _check_priority(p: str) -> str:
        p = str(p).lower()
        if p not in PRIORITIES:
            raise ValueError(
                f"unknown priority class '{p}' "
                f"(expected one of {', '.join(sorted(PRIORITIES))})")
        return p

    # -- tenant lifecycle -------------------------------------------------

    def add_tenant(self, tid: str, qos: Optional[dict] = None) -> None:
        q = dict(qos or {})
        unknown = set(q) - {"weight", "priority", "rate_eps", "rate.eps",
                            "burst", "rate_burst", "rate.burst"}
        if unknown:
            raise ValueError(
                f"unknown qos dial(s) {', '.join(sorted(unknown))} "
                "(expected weight / priority / rate_eps / burst)")
        weight = float(_get(q, "weight", default=self.default_weight))
        if weight <= 0:
            raise ValueError(f"qos weight must be > 0 (got {weight})")
        priority = self._check_priority(
            _get(q, "priority", default=self.default_priority))
        rate = _get(q, "rate_eps", "rate.eps", default=self.default_rate)
        burst = _get(q, "burst", "rate_burst", "rate.burst",
                     default=self.default_burst)
        bucket = None
        if rate is not None:
            bucket = TokenBucket(float(rate),
                                 float(burst if burst is not None
                                       else 2 * float(rate)),
                                 clock=self.clock)
        breaker = None
        if self.breaker_failures is not None:
            def transition(prev, state, _tid=tid):
                if self.on_transition is not None:
                    self.on_transition(_tid, prev, state)
            breaker = CircuitBreaker(int(self.breaker_failures),
                                     self.breaker_reset_ms,
                                     clock=self.clock,
                                     on_transition=transition)
        self._tenants[tid] = TenantQoS(weight, priority, bucket, breaker)
        self._deficit[tid] = 0.0

    def remove_tenant(self, tid: str) -> None:
        self._tenants.pop(tid, None)
        self._deficit.pop(tid, None)

    def profile(self, tid: str) -> Optional[TenantQoS]:
        return self._tenants.get(tid)

    # -- rate limiting ----------------------------------------------------

    def check_rate(self, tid: str, n: int) -> tuple[bool, int]:
        prof = self._tenants.get(tid)
        if prof is None or prof.bucket is None:
            return True, 0
        return prof.bucket.try_take(n)

    # -- weighted-fair scheduling (DRR + class deferral) ------------------

    def plan_round(self, pending: dict[str, int],
                   batch_max: int) -> dict[str, int]:
        """Per-tenant take limits for one fair round. ``pending`` maps
        tenant -> queued rows; only backlogged tenants get an entry.

        Classes drain in priority order: a class with a backlogged
        strictly-higher class above it defers (takes 0) for at most
        ``max_defer`` consecutive rounds. Within a class, DRR credits
        hold the weight ratio exactly over any run of rounds."""
        by_rank: dict[int, list[str]] = {}
        for tid, rows in pending.items():
            if rows <= 0:
                continue
            prof = self._tenants.get(tid)
            rank = PRIORITIES[prof.priority] if prof else \
                PRIORITIES["normal"]
            by_rank.setdefault(rank, []).append(tid)
        takes: dict[str, int] = {}
        residual_above = 0
        for rank in sorted(by_rank):
            members = by_rank[rank]
            if residual_above > 0 and \
                    self._defer.get(rank, 0) < self.max_defer:
                # a higher class is still draining: sit this round out
                self._defer[rank] = self._defer.get(rank, 0) + 1
                for tid in members:
                    takes[tid] = 0
                    prof = self._tenants.get(tid)
                    name = prof.priority if prof else "normal"
                    self.deferrals[name] = self.deferrals.get(name, 0) + 1
                residual_above += sum(pending[t] for t in members)
                continue
            self._defer[rank] = 0
            w_max = max((self._tenants[t].weight for t in members
                         if t in self._tenants), default=1.0)
            for tid in members:
                prof = self._tenants.get(tid)
                w = prof.weight if prof else 1.0
                self._deficit[tid] = self._deficit.get(tid, 0.0) \
                    + batch_max * (w / w_max)
                take = int(min(self._deficit[tid], pending[tid],
                               batch_max))
                takes[tid] = take
                self._deficit[tid] -= take
                if pending[tid] - take <= 0:
                    # queue drained: credits do not bank across idle
                    # periods (classic DRR)
                    self._deficit[tid] = 0.0
                residual_above += pending[tid] - take
        return takes

    # -- circuit breakers -------------------------------------------------

    def breaker_gate(self, tid: str) -> str:
        prof = self._tenants.get(tid)
        if prof is None or prof.breaker is None:
            return "closed"
        return prof.breaker.gate()

    def on_delivery(self, tid: str, ok: bool) -> None:
        prof = self._tenants.get(tid)
        if prof is None or prof.breaker is None:
            return
        if ok:
            prof.breaker.record_success()
        else:
            prof.breaker.record_failure()

    def count_short_circuit(self, tid: str, n: int) -> None:
        self.short_circuited += n
        prof = self._tenants.get(tid)
        if prof is not None and prof.breaker is not None:
            prof.breaker.short_circuited += n

    # -- observability ----------------------------------------------------

    def credits(self) -> dict[str, float]:
        return {tid: round(v, 3) for tid, v in self._deficit.items()}

    def describe(self) -> dict:
        """Static configuration view (rides pool explain decisions —
        per-tenant weights/priorities are live facts, dials are plan)."""
        return {
            "scheduler": "deficit-round-robin",
            "max_defer": self.max_defer,
            "default_weight": self.default_weight,
            "default_priority": self.default_priority,
            "default_rate_eps": self.default_rate,
            "breaker_failures": self.breaker_failures,
            "breaker_reset_ms": self.breaker_reset_ms
            if self.breaker_failures is not None else None,
        }

    def report(self) -> dict:
        tenants = {}
        for tid, prof in self._tenants.items():
            entry = {
                "weight": prof.weight,
                "priority": prof.priority,
                "rate_eps": prof.bucket.rate if prof.bucket else None,
                "burst": prof.bucket.burst if prof.bucket else None,
                "credits": round(self._deficit.get(tid, 0.0), 3),
            }
            if prof.breaker is not None:
                entry["breaker"] = prof.breaker.as_dict()
            tenants[tid] = entry
        return {
            "enabled": True,
            **self.describe(),
            "tenants": tenants,
            "deferrals": dict(self.deferrals),
            "short_circuited": self.short_circuited,
        }
