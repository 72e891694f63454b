"""SiddhiQL query object model (AST).

Python equivalent of the reference's query-api module
(modules/siddhi-query-api/src/main/java/io/siddhi/query/api/ — SiddhiApp,
definitions, Query, input streams, state elements, expressions, Partition,
OnDemandQuery). Plain dataclasses; built by lang/parser.py or directly by
users (the reference's builder API is public too).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Union

from ..core.types import AttrType

# --------------------------------------------------------------------------
# Annotations
# --------------------------------------------------------------------------


@dataclasses.dataclass
class Annotation:
    name: str
    elements: dict[str, str] = dataclasses.field(default_factory=dict)
    positional: list[str] = dataclasses.field(default_factory=list)
    nested: list["Annotation"] = dataclasses.field(default_factory=list)

    def element(self, key: Optional[str] = None, default=None):
        if key is None:
            # positional single value: @Async(true) style
            if self.positional:
                return self.positional[0]
            if len(self.elements) == 1:
                return next(iter(self.elements.values()))
            return default
        for k, v in self.elements.items():
            if k.lower() == key.lower():
                return v
        return default


def find_annotation(annotations, name):
    for a in annotations:
        if a.name.lower() == name.lower():
            return a
    return None


# --------------------------------------------------------------------------
# Expressions
# --------------------------------------------------------------------------


@dataclasses.dataclass
class Expression:
    pass


@dataclasses.dataclass
class Constant(Expression):
    value: Any
    type: AttrType
    is_time: bool = False  # written with time suffix (5 sec etc.), LONG millis


@dataclasses.dataclass
class Variable(Expression):
    attribute: str
    stream_ref: Optional[str] = None    # stream id / alias / event ref
    is_inner: bool = False
    is_fault: bool = False
    index: Optional[Union[int, str]] = None  # event index in pattern collections; 'last' / ('last', n)
    function_ref: Optional[str] = None  # second #name part (aggregation refs)


@dataclasses.dataclass
class AttributeFunction(Expression):
    namespace: Optional[str]
    name: str
    parameters: list[Expression] = dataclasses.field(default_factory=list)
    star: bool = False  # f(*)


@dataclasses.dataclass
class MathOp(Expression):
    op: str  # '+', '-', '*', '/', '%'
    left: Expression
    right: Expression


@dataclasses.dataclass
class Compare(Expression):
    op: str  # '<', '<=', '>', '>=', '==', '!='
    left: Expression
    right: Expression


@dataclasses.dataclass
class And(Expression):
    left: Expression
    right: Expression


@dataclasses.dataclass
class Or(Expression):
    left: Expression
    right: Expression


@dataclasses.dataclass
class Not(Expression):
    expr: Expression


@dataclasses.dataclass
class IsNull(Expression):
    expr: Optional[Expression] = None
    stream_ref: Optional[str] = None    # `e1 is null` stream/state reference
    stream_index: Optional[Union[int, str]] = None
    is_inner: bool = False
    is_fault: bool = False


@dataclasses.dataclass
class InTable(Expression):
    expr: Expression
    table_id: str


@dataclasses.dataclass
class TemplateParam(Expression):
    """A `${name:type}` tenant-template placeholder (serving/template.py).

    Unlike a Constant, the value is NOT baked into the compiled program:
    it lowers to a runtime read of a per-tenant parameter carried in the
    operator's state pytree, so every tenant of one template shares the
    SAME jitted step and only the stacked parameter array differs.
    `type` is the declared AttrType (None for an untyped `${name}`
    placeholder that leaked past structural substitution — rejected by
    the `template-binding` plan rule)."""
    name: str
    type: Optional[AttrType] = None


# --------------------------------------------------------------------------
# Definitions
# --------------------------------------------------------------------------


@dataclasses.dataclass
class AttributeDef:
    name: str
    type: AttrType


@dataclasses.dataclass
class StreamDefinition:
    stream_id: str
    attributes: list[AttributeDef]
    annotations: list[Annotation] = dataclasses.field(default_factory=list)
    is_inner: bool = False
    is_fault: bool = False
    line: Optional[int] = None  # 1-based source line (parser-populated)


@dataclasses.dataclass
class TableDefinition:
    table_id: str
    attributes: list[AttributeDef]
    annotations: list[Annotation] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class FunctionOperation:
    namespace: Optional[str]
    name: str
    parameters: list[Expression] = dataclasses.field(default_factory=list)
    star: bool = False


@dataclasses.dataclass
class WindowDefinition:
    window_id: str
    attributes: list[AttributeDef]
    window: FunctionOperation = None
    output_event_type: str = "all"  # 'current' | 'expired' | 'all'
    annotations: list[Annotation] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class TriggerDefinition:
    trigger_id: str
    at_every_ms: Optional[int] = None   # EVERY <time>
    at_cron: Optional[str] = None       # cron string; 'start' for AT 'start'
    annotations: list[Annotation] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class FunctionDefinition:
    function_id: str
    language: str
    return_type: AttrType
    body: str


@dataclasses.dataclass
class AggregationDefinition:
    aggregation_id: str
    input: "SingleInputStream" = None
    selector: "Selector" = None
    aggregate_by: Optional[Variable] = None
    durations: list[str] = dataclasses.field(default_factory=list)  # 'seconds'..'years'
    annotations: list[Annotation] = dataclasses.field(default_factory=list)


# --------------------------------------------------------------------------
# Input streams
# --------------------------------------------------------------------------


@dataclasses.dataclass
class StreamHandler:
    pass


@dataclasses.dataclass
class Filter(StreamHandler):
    expression: Expression


@dataclasses.dataclass
class StreamFunction(StreamHandler):
    namespace: Optional[str]
    name: str
    parameters: list[Expression] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class WindowHandler(StreamHandler):
    namespace: Optional[str]
    name: str
    parameters: list[Expression] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class InputStream:
    pass


@dataclasses.dataclass
class SingleInputStream(InputStream):
    stream_id: str
    is_inner: bool = False
    is_fault: bool = False
    alias: Optional[str] = None
    handlers: list[StreamHandler] = dataclasses.field(default_factory=list)

    @property
    def window(self) -> Optional[WindowHandler]:
        for h in self.handlers:
            if isinstance(h, WindowHandler):
                return h
        return None


@dataclasses.dataclass
class JoinInputStream(InputStream):
    left: SingleInputStream
    right: SingleInputStream
    join_type: str = "inner"  # inner|left_outer|right_outer|full_outer
    on: Optional[Expression] = None
    within: Optional[Expression] = None
    per: Optional[Expression] = None
    unidirectional: Optional[str] = None  # 'left' | 'right' | None


# ---- pattern / sequence state elements ----


@dataclasses.dataclass
class StateElement:
    within_ms: Optional[int] = None


@dataclasses.dataclass
class StreamStateElement(StateElement):
    stream: SingleInputStream = None
    event_ref: Optional[str] = None  # e1=...


@dataclasses.dataclass
class AbsentStreamStateElement(StreamStateElement):
    waiting_time_ms: int = 0  # not ... for <t>


@dataclasses.dataclass
class CountStateElement(StateElement):
    stream: StreamStateElement = None
    min_count: int = 1
    max_count: int = -1  # -1 == unbounded (ANY)


@dataclasses.dataclass
class LogicalStateElement(StateElement):
    left: StateElement = None
    op: str = "and"  # 'and' | 'or'
    right: StateElement = None


@dataclasses.dataclass
class NextStateElement(StateElement):
    state: StateElement = None
    next: StateElement = None


@dataclasses.dataclass
class EveryStateElement(StateElement):
    state: StateElement = None


@dataclasses.dataclass
class StateInputStream(InputStream):
    state_type: str = "pattern"  # 'pattern' | 'sequence'
    state: StateElement = None
    within_ms: Optional[int] = None


@dataclasses.dataclass
class AnonymousInputStream(InputStream):
    query: "Query" = None


# --------------------------------------------------------------------------
# Selector / output
# --------------------------------------------------------------------------


@dataclasses.dataclass
class OutputAttribute:
    expression: Expression
    rename: Optional[str] = None  # AS name


@dataclasses.dataclass
class OrderByAttribute:
    variable: Variable
    order: str = "asc"


@dataclasses.dataclass
class Selector:
    select_all: bool = False
    attributes: list[OutputAttribute] = dataclasses.field(default_factory=list)
    group_by: list[Variable] = dataclasses.field(default_factory=list)
    having: Optional[Expression] = None
    order_by: list[OrderByAttribute] = dataclasses.field(default_factory=list)
    limit: Optional[Expression] = None
    offset: Optional[Expression] = None


@dataclasses.dataclass
class OutputStream:
    pass


@dataclasses.dataclass
class InsertIntoStream(OutputStream):
    target: str
    output_event_type: str = "current"  # current|expired|all
    is_inner: bool = False
    is_fault: bool = False


@dataclasses.dataclass
class ReturnStream(OutputStream):
    output_event_type: str = "current"


@dataclasses.dataclass
class DeleteStream(OutputStream):
    target: str
    on: Expression = None
    output_event_type: str = "current"


@dataclasses.dataclass
class UpdateStream(OutputStream):
    target: str
    on: Expression = None
    set_clause: list[tuple[Variable, Expression]] = dataclasses.field(default_factory=list)
    output_event_type: str = "current"


@dataclasses.dataclass
class UpdateOrInsertStream(OutputStream):
    target: str
    on: Expression = None
    set_clause: list[tuple[Variable, Expression]] = dataclasses.field(default_factory=list)
    output_event_type: str = "current"


@dataclasses.dataclass
class OutputRate:
    pass


@dataclasses.dataclass
class EventOutputRate(OutputRate):
    events: int = 1
    type: str = "all"  # all|first|last


@dataclasses.dataclass
class TimeOutputRate(OutputRate):
    ms: int = 0
    type: str = "all"


@dataclasses.dataclass
class SnapshotOutputRate(OutputRate):
    ms: int = 0


# --------------------------------------------------------------------------
# Execution elements
# --------------------------------------------------------------------------


@dataclasses.dataclass
class Query:
    input: InputStream = None
    selector: Selector = dataclasses.field(default_factory=Selector)
    output: OutputStream = None
    output_rate: Optional[OutputRate] = None
    annotations: list[Annotation] = dataclasses.field(default_factory=list)
    line: Optional[int] = None  # 1-based source line (parser-populated)

    @property
    def name(self) -> Optional[str]:
        a = find_annotation(self.annotations, "info")
        return a.element("name") if a else None


@dataclasses.dataclass
class PartitionType:
    stream_id: str


@dataclasses.dataclass
class ValuePartitionType(PartitionType):
    expression: Expression = None


@dataclasses.dataclass
class RangePartitionType(PartitionType):
    ranges: list[tuple[Expression, str]] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Partition:
    partition_types: list[PartitionType] = dataclasses.field(default_factory=list)
    queries: list[Query] = dataclasses.field(default_factory=list)
    annotations: list[Annotation] = dataclasses.field(default_factory=list)
    line: Optional[int] = None  # 1-based source line (parser-populated)


@dataclasses.dataclass
class OnDemandQuery:
    """Store query (reference: query-api OnDemandQuery / StoreQuery)."""
    input_id: Optional[str] = None
    alias: Optional[str] = None
    on: Optional[Expression] = None
    within: Optional[tuple[Expression, Optional[Expression]]] = None
    per: Optional[Expression] = None
    selector: Selector = dataclasses.field(default_factory=Selector)
    output: Optional[OutputStream] = None  # None == find/select


# --------------------------------------------------------------------------
# Tree walkers — shared by the static analyzers (analysis/plan_rules.py,
# analysis/typecheck.py) and anything else that needs a generic traversal.
# --------------------------------------------------------------------------


def walk_expressions(e):
    """Depth-first walk over an expression tree (dataclass fields)."""
    if not isinstance(e, Expression):
        return
    yield e
    for f in dataclasses.fields(e):
        v = getattr(e, f.name)
        if isinstance(v, Expression):
            yield from walk_expressions(v)
        elif isinstance(v, list):
            for item in v:
                yield from walk_expressions(item)


def iter_state_elements(el):
    """Every StateElement in a pattern/sequence tree, self included."""
    if el is None:
        return
    yield el
    if isinstance(el, NextStateElement):
        yield from iter_state_elements(el.state)
        yield from iter_state_elements(el.next)
    elif isinstance(el, EveryStateElement):
        yield from iter_state_elements(el.state)
    elif isinstance(el, LogicalStateElement):
        yield from iter_state_elements(el.left)
        yield from iter_state_elements(el.right)
    elif isinstance(el, CountStateElement):
        yield from iter_state_elements(el.stream)


def iter_state_streams(el):
    """Every SingleInputStream referenced by a state tree."""
    for sub in iter_state_elements(el):
        if isinstance(sub, StreamStateElement) and sub.stream is not None:
            yield sub.stream


def iter_query_inputs(q: "Query"):
    """Every SingleInputStream a query reads from (joins/patterns/anon
    streams flattened)."""
    inp = q.input
    if isinstance(inp, SingleInputStream):
        yield inp
    elif isinstance(inp, JoinInputStream):
        yield inp.left
        yield inp.right
    elif isinstance(inp, StateInputStream):
        yield from iter_state_streams(inp.state)
    elif isinstance(inp, AnonymousInputStream) and inp.query is not None:
        yield from iter_query_inputs(inp.query)


def iter_queries(app: "SiddhiApp"):
    """Every query of an app, partition-nested ones included."""
    for el in app.execution_elements:
        if isinstance(el, Query):
            yield el
        elif isinstance(el, Partition):
            yield from el.queries


@dataclasses.dataclass
class SiddhiApp:
    annotations: list[Annotation] = dataclasses.field(default_factory=list)
    stream_definitions: dict[str, StreamDefinition] = dataclasses.field(default_factory=dict)
    table_definitions: dict[str, TableDefinition] = dataclasses.field(default_factory=dict)
    window_definitions: dict[str, WindowDefinition] = dataclasses.field(default_factory=dict)
    trigger_definitions: dict[str, TriggerDefinition] = dataclasses.field(default_factory=dict)
    function_definitions: dict[str, FunctionDefinition] = dataclasses.field(default_factory=dict)
    aggregation_definitions: dict[str, AggregationDefinition] = dataclasses.field(default_factory=dict)
    execution_elements: list[Union[Query, Partition]] = dataclasses.field(default_factory=list)

    @property
    def name(self) -> Optional[str]:
        a = find_annotation(self.annotations, "name")
        if a:
            return a.element()
        return None
