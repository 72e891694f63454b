"""Static schema model for the query-dataflow type checker.

A ``Schema`` is the static twin of ``core/event.py StreamSchema``: the
``(name, AttrType)`` shape of one stream, table, window or trigger, with
one extension — an attribute's type may be ``None`` ("unknown"), which
is how the checker degrades gracefully around constructs it cannot type
statically (extension stream processors, aggregation references, UDFs
without declared return types). Unknown types propagate and suppress
downstream diagnostics instead of guessing.

This module also centralizes the *operator typing rules* the runtime
applies piecemeal at compile time, so the static pass and the executors
share one table instead of drifting apart:

- numeric promotion / coercion / comparability live in
  ``core/types.py`` (``promote``, ``can_coerce``, ``comparable``);
- aggregator result types (``avg -> DOUBLE``, ``count -> LONG``, …)
  live here in ``aggregator_result_type`` and are consumed by
  ``ops/aggregators.py`` when it builds the real AggSpec executors.

Everything here is import-light (stdlib + core.types, no jax) so the
lint CLI can type-check ``.siddhi`` files without touching a device
runtime.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

from ..core.types import AttrType, NUMERIC_TYPES

# ---------------------------------------------------------------------------
# Schema
# ---------------------------------------------------------------------------

# how a schema became known — definitions are authoritative, inferred
# schemas come from insert-into propagation
DEFINED = "defined"
INFERRED = "inferred"
BUILTIN = "builtin"


@dataclasses.dataclass(frozen=True)
class Schema:
    """Static shape of one stream-like source. ``types[i] is None``
    means "statically unknown" and suppresses dependent checks."""

    stream_id: str
    attrs: tuple[tuple[str, Optional[AttrType]], ...]
    source: str = DEFINED
    line: Optional[int] = None  # definition/first-producer source line

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(n for n, _ in self.attrs)

    @property
    def types(self) -> tuple[Optional[AttrType], ...]:
        return tuple(t for _, t in self.attrs)

    @property
    def fully_known(self) -> bool:
        return all(t is not None for _, t in self.attrs)

    def get(self, name: str) -> Optional[AttrType]:
        """Type of attribute `name`; KeyError when absent (first match
        wins, like StreamSchema.index_of)."""
        for n, t in self.attrs:
            if n == name:
                return t
        raise KeyError(name)

    def has(self, name: str) -> bool:
        return any(n == name for n, _ in self.attrs)

    def render(self) -> str:
        body = ", ".join(
            f"{n} {t.value if t is not None else '?'}" for n, t in self.attrs)
        return f"({body})"


def schema_from_attribute_defs(stream_id: str, attribute_defs: Iterable,
                               source: str = DEFINED,
                               line: Optional[int] = None) -> Schema:
    """Schema from a definition's list of lang.ast.AttributeDef."""
    return Schema(stream_id,
                  tuple((a.name, a.type) for a in attribute_defs),
                  source=source, line=line)


# ---------------------------------------------------------------------------
# Aggregator typing rules
# ---------------------------------------------------------------------------

# the aggregator names ops/selector.py recognizes in select clauses;
# re-declared here (strings only) so the static pass does not import the
# jax-heavy executor module — ops/selector.py asserts equality in tier-1
AGGREGATOR_NAMES = frozenset({
    "sum", "avg", "count", "distinctcount", "min", "max", "minforever",
    "maxforever", "stddev", "and", "or", "unionset",
})

# input-domain of each aggregator: the static twin of the constructor
# checks in ops/aggregators.py (SumAgg raises on non-numeric, BoolAgg on
# non-BOOL, UnionSetAgg on non-OBJECT). None = any input accepted.
AGGREGATOR_INPUT: dict[str, Optional[tuple[AttrType, ...]]] = {
    "sum": NUMERIC_TYPES, "avg": NUMERIC_TYPES, "stddev": NUMERIC_TYPES,
    "min": NUMERIC_TYPES, "max": NUMERIC_TYPES,
    "minforever": NUMERIC_TYPES, "maxforever": NUMERIC_TYPES,
    "and": (AttrType.BOOL,), "or": (AttrType.BOOL,),
    "unionset": (AttrType.OBJECT,),
    "count": None, "distinctcount": None,
}


def aggregator_result_type(name: str,
                           arg: Optional[AttrType]) -> Optional[AttrType]:
    """Result type of aggregator `name` over an argument of type `arg`.

    The single source of truth for aggregator result typing:
    ``ops/aggregators.py`` AggSpec constructors call this, and the
    static type checker mirrors it at parse time. Returns None when the
    result cannot be determined (unknown arg for an arg-dependent
    aggregator, or an unknown aggregator name).
    """
    key = name.lower()
    if key == "count":
        return AttrType.LONG
    if key == "distinctcount":
        return AttrType.LONG
    if key in ("avg", "stddev"):
        return AttrType.DOUBLE
    if key == "sum":
        if arg in (AttrType.INT, AttrType.LONG):
            return AttrType.LONG
        if arg in (AttrType.FLOAT, AttrType.DOUBLE):
            return AttrType.DOUBLE
        return None
    if key in ("min", "max", "minforever", "maxforever"):
        return arg if arg in NUMERIC_TYPES else None
    if key in ("and", "or"):
        return AttrType.BOOL
    if key == "unionset":
        return AttrType.OBJECT
    return None


def aggregator_accepts(name: str, arg: Optional[AttrType]) -> bool:
    """Whether `arg` is in the aggregator's input domain (unknown args
    are always accepted — the checker never guesses)."""
    if arg is None:
        return True
    domain = AGGREGATOR_INPUT.get(name.lower())
    return domain is None or arg in domain


# ---------------------------------------------------------------------------
# Insert-into compatibility
# ---------------------------------------------------------------------------

OK = "ok"
COERCE = "coerce"      # numeric widening the runtime still rejects today,
                       # but is semantically sound — warning severity
MISMATCH = "mismatch"  # non-coercible dtype pair — definite error
UNKNOWN = "unknown"    # one side statically unknown — no diagnosis


def insert_compat(src: Optional[AttrType],
                  dst: Optional[AttrType]) -> str:
    """Classify one (produced, declared) attribute-type pair of an
    insert-into edge."""
    from ..core.types import can_coerce
    if src is None or dst is None:
        return UNKNOWN
    if src is dst:
        return OK
    if can_coerce(src, dst):
        return COERCE
    return MISMATCH
