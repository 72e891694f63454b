"""App-wide schema & dtype inference: a static type checker over the
query dataflow graph.

``plan_rules.py`` answers "does this stream exist / does this window
take two parameters"; this pass answers everything *type-shaped*. It

1. builds the stream dataflow graph of a parsed app — queries,
   partitions, joins, patterns, insert-into edges;
2. topologically propagates schemas so implicitly-defined streams
   (insert-into targets) get inferred ``(name, AttrType)`` schemas; and
3. statically types every expression by mirroring the rules
   ``ops/expr.py`` / ``ops/selector.py`` / ``ops/aggregators.py`` apply
   at compile time: Java numeric promotion in arithmetic, comparability
   in comparisons (STRING vs numeric is an error — device strings are
   int32 dictionary codes), BOOL-typed filter/having conditions,
   aggregator result types (``avg -> DOUBLE``, ``count -> LONG``, …),
   and alias-scoped resolution for join sides and pattern ``e1=``
   references (subsuming the single-stream-only attribute check PR 1's
   ``plan_rules.check_attributes`` shipped with).

Error-severity issues are definite compile-time rejections (the runtime
planner or the expression compiler would raise the same way later, or
worse, an XLA shape error would) and make ``check_app`` raise
``CompileError`` from inside ``lang.parser.parse``. Warning-severity
issues (dead dataflow, float64-in-hot-path, coercible insert widths)
flow through the PR 1 ``Finding``/baseline machinery via
``tools/lint.py --plan`` so they are suppressible and baselined.

The checker *never guesses*: anything it cannot type statically
(extension stream processors, aggregation references, UDF results
without declared types) becomes an unknown that propagates and
suppresses dependent diagnostics. A clean pass is a claim, a silent
pass is not.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from ..core.types import AttrType, NUMERIC_TYPES, comparable, promote
from ..lang import ast as A
from .findings import Finding
from .schema import (AGGREGATOR_NAMES, COERCE, INFERRED, MISMATCH, Schema,
                     aggregator_accepts, aggregator_result_type,
                     insert_compat, schema_from_attribute_defs)

ERROR = "error"
WARNING = "warning"

_BOOL = AttrType.BOOL
_STRING = AttrType.STRING
_DOUBLE = AttrType.DOUBLE
_LONG = AttrType.LONG


@dataclasses.dataclass(frozen=True)
class TypeIssue:
    code: str
    severity: str
    where: str            # query name / stream id anchor
    message: str
    line: Optional[int] = None

    def render(self) -> str:
        return f"{self.where}: {self.severity} [{self.code}] {self.message}"


@dataclasses.dataclass
class TypeReport:
    issues: list[TypeIssue]
    schemas: dict[str, Schema]       # every known stream-like schema,
                                     # inferred implicit streams included

    @property
    def errors(self) -> list[TypeIssue]:
        return [i for i in self.issues if i.severity == ERROR]

    @property
    def warnings(self) -> list[TypeIssue]:
        return [i for i in self.issues if i.severity == WARNING]


class _Unresolved(Exception):
    """Definite resolution failure inside a scope (code + message)."""

    def __init__(self, code: str, message: str):
        super().__init__(message)
        self.code = code
        self.message = message


def _output_attribute_name(oa: A.OutputAttribute, i: int) -> str:
    # = ops/selector.py output_attribute_name (kept import-light here)
    if oa.rename:
        return oa.rename
    if isinstance(oa.expression, A.Variable):
        return oa.expression.attribute
    return f"_{i}"


# ---------------------------------------------------------------------------
# scopes: the static twins of ops/expr.py SingleStreamScope,
# ops/join.py JoinSideScope and ops/nfa.py PatternScope
# ---------------------------------------------------------------------------


def _skippable(var: A.Variable) -> bool:
    """Variables the static pass never types: compiler placeholders,
    aggregation references (StockAgg.avgPrice#...), fault/inner columns."""
    if var.attribute is None:            # bare stream ref (IS NULL forms)
        return True
    if var.function_ref is not None:
        return True
    if var.attribute.startswith("__"):
        return True
    if var.is_fault or var.is_inner:
        return True
    return False


class _SingleScope:
    """One input stream; accepts the stream id and its alias (an alias
    does not shadow the id for single streams — SingleStreamScope)."""

    def __init__(self, checker: "TypeChecker", schema: Optional[Schema],
                 refs: set):
        self.checker = checker
        self.schema = schema
        self.refs = refs

    def resolve(self, var: A.Variable) -> Optional[AttrType]:
        if _skippable(var):
            return None
        ref = var.stream_ref
        if ref is not None and ref not in self.refs:
            if ref in self.checker.table_ids:
                return None     # table-scoped: planner territory
            raise _Unresolved(
                "unresolved-reference",
                f"unknown stream reference '{ref}' (expected "
                f"{sorted(self.refs)})")
        if var.index is not None:
            return None         # indexed refs only exist in patterns
        if self.schema is None:
            return None
        if not self.schema.has(var.attribute):
            raise _Unresolved(
                "undefined-attribute",
                f"'{var.attribute}' is not an attribute of stream "
                f"'{self.schema.stream_id}' {self.schema.render()}")
        return self.schema.get(var.attribute)


class _JoinScope:
    """Two sides; an alias REPLACES the side's stream id (JoinSideScope:
    the reference rejects the original id once `as x` is used)."""

    def __init__(self, checker: "TypeChecker",
                 left: Optional[Schema], left_name: str,
                 right: Optional[Schema], right_name: str):
        self.checker = checker
        self.sides = ((left, left_name), (right, right_name))
        self.incomplete = left is None or right is None

    def resolve(self, var: A.Variable) -> Optional[AttrType]:
        if _skippable(var) or var.index is not None:
            return None
        ref = var.stream_ref
        if ref is not None:
            for schema, name in self.sides:
                if ref == name:
                    if schema is None:
                        return None
                    if not schema.has(var.attribute):
                        raise _Unresolved(
                            "undefined-attribute",
                            f"'{ref}' has no attribute '{var.attribute}'")
                    return schema.get(var.attribute)
            if ref in self.checker.table_ids:
                return None
            if self.incomplete:
                return None
            raise _Unresolved("unresolved-reference",
                              f"unknown stream reference '{ref}' in join")
        if self.incomplete:
            return None
        hits = [s for s, _ in self.sides if s.has(var.attribute)]
        if len(hits) == 1:
            return hits[0].get(var.attribute)
        if hits:
            raise _Unresolved(
                "unresolved-reference",
                f"attribute '{var.attribute}' is ambiguous across join "
                "sides (qualify it)")
        raise _Unresolved(
            "undefined-attribute",
            f"attribute '{var.attribute}' is unknown across join sides")


@dataclasses.dataclass
class _Slot:
    ref: Optional[str]          # e1= event reference
    stream_id: str
    schema: Optional[Schema]
    stream: A.SingleInputStream


class _PatternScope:
    """Match-slot resolution, mirroring ops/nfa.py PatternScope: event
    refs first, then unique stream-id matches; bare attributes bind to
    the state's own stream first, else must be unique across slots."""

    def __init__(self, checker: "TypeChecker", slots: list[_Slot],
                 own_slot: Optional[int] = None):
        self.checker = checker
        self.slots = slots
        self.own_slot = own_slot
        self.incomplete = any(s.schema is None for s in slots)

    def _find(self, var: A.Variable) -> Optional[int]:
        ref = var.stream_ref
        if ref is not None:
            for j, s in enumerate(self.slots):
                if s.ref == ref:
                    return j
            matches = [j for j, s in enumerate(self.slots)
                       if s.stream_id == ref]
            if len(matches) == 1:
                return matches[0]
            if len(matches) > 1:
                raise _Unresolved(
                    "unresolved-reference",
                    f"ambiguous stream reference '{ref}' in pattern")
            if ref in self.checker.table_ids:
                return None
            raise _Unresolved("unresolved-reference",
                              f"unknown event reference '{ref}'")
        own = self.own_slot
        if own is not None and self.slots[own].schema is not None \
                and self.slots[own].schema.has(var.attribute):
            return own
        if self.incomplete:
            return None
        matches = [j for j, s in enumerate(self.slots)
                   if s.schema.has(var.attribute)]
        if len(matches) == 1:
            return matches[0]
        if matches:
            raise _Unresolved(
                "unresolved-reference",
                f"attribute '{var.attribute}' is ambiguous in pattern "
                "scope (qualify it with an event reference)")
        raise _Unresolved(
            "undefined-attribute",
            f"attribute '{var.attribute}' is unknown in pattern scope")

    def resolve(self, var: A.Variable) -> Optional[AttrType]:
        if _skippable(var):
            return None
        j = self._find(var)
        if j is None:
            return None
        spec = self.slots[j]
        if spec.schema is None:
            return None
        if not spec.schema.has(var.attribute):
            raise _Unresolved(
                "undefined-attribute",
                f"'{spec.ref or spec.stream_id}' has no attribute "
                f"'{var.attribute}'")
        # indexed (e1[2].x / e1[last].x) refs share the attribute's type
        return spec.schema.get(var.attribute)


class _OutputChainScope:
    """HAVING scope: the selector's own output attributes first, the
    input scope second (ops/selector.py OutputScope + ChainScope)."""

    def __init__(self, out_schema: Optional[Schema], inner):
        self.out_schema = out_schema
        self.inner = inner

    def resolve(self, var: A.Variable) -> Optional[AttrType]:
        if _skippable(var):
            return None
        if self.out_schema is not None and var.stream_ref is None \
                and var.index is None and self.out_schema.has(var.attribute):
            return self.out_schema.get(var.attribute)
        return self.inner.resolve(var)


# ---------------------------------------------------------------------------
# the checker
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _QueryInfo:
    query: A.Query
    name: str
    partition_index: Optional[int]   # index into app.execution_elements


class TypeChecker:
    def __init__(self, app: A.SiddhiApp):
        self.app = app
        self.issues: list[TypeIssue] = []
        self.table_ids = set(app.table_definitions)
        # id -> Schema | None (known id, statically unknown schema)
        self.sources: dict[str, Optional[Schema]] = {}
        for sid, sd in app.stream_definitions.items():
            self.sources[sid] = schema_from_attribute_defs(
                sid, sd.attributes, line=sd.line)
            for ann in sd.annotations:
                if ann.name.lower() == "onerror" and \
                        (ann.element("action") or "").upper() == "STREAM":
                    # shadow fault stream: attrs + _error STRING
                    self.sources["!" + sid] = Schema(
                        "!" + sid,
                        self.sources[sid].attrs + (("_error", _STRING),),
                        source="builtin")
        for tid, td in app.table_definitions.items():
            self.sources[tid] = schema_from_attribute_defs(
                tid, td.attributes)
        for wid, wd in app.window_definitions.items():
            self.sources[wid] = schema_from_attribute_defs(
                wid, wd.attributes)
        for tid in app.trigger_definitions:
            self.sources[tid] = Schema(
                tid, (("triggered_time", _LONG),), source="builtin")
        for aid in app.aggregation_definitions:
            self.sources[aid] = None   # duration-bucketed: planner types it
        self.infos = list(self._collect())
        # per-query settled output schema (index into self.infos)
        self.out_schemas: list[Optional[Schema]] = [None] * len(self.infos)
        # app-scope implicit insert targets -> producer info indices
        self.producers: dict[str, list[int]] = {}
        for i, qi in enumerate(self.infos):
            t = self._stream_target(qi.query)
            if t is not None:
                self.producers.setdefault(t, []).append(i)

    # -- graph collection ----------------------------------------------
    def _collect(self):
        qn = 0
        for ei, el in enumerate(self.app.execution_elements):
            if isinstance(el, A.Query):
                qn += 1
                yield _QueryInfo(el, el.name or f"query{qn}", None)
            elif isinstance(el, A.Partition):
                pname = f"partition{qn + 1}"
                for i, q in enumerate(el.queries):
                    yield _QueryInfo(q, q.name or f"{pname}.query{i + 1}",
                                     ei)
                qn += len(el.queries)

    @staticmethod
    def _stream_target(q: A.Query) -> Optional[str]:
        out = q.output
        if isinstance(out, A.InsertIntoStream) and not out.is_inner \
                and not out.is_fault:
            return out.target
        return None

    # -- issue emission -------------------------------------------------
    def _emitter(self, qi: Optional[_QueryInfo],
                 where: Optional[str] = None) -> Callable:
        anchor = where or (qi.name if qi else "app")
        line = qi.query.line if qi else None

        def emit(code: str, message: str, severity: str = ERROR):
            issue = TypeIssue(code=code, severity=severity, where=anchor,
                              message=message, line=line)
            if issue not in self.issues:
                self.issues.append(issue)
        return emit

    @staticmethod
    def _no_emit(code: str, message: str, severity: str = ERROR):
        pass

    # -- expression typing ---------------------------------------------
    def type_expr(self, e: A.Expression, scope, emit,
                  agg: bool = False) -> Optional[AttrType]:
        te = lambda x: self.type_expr(x, scope, emit, agg)  # noqa: E731

        if isinstance(e, A.Constant):
            if e.value is None:
                return e.type if isinstance(e.type, AttrType) else _DOUBLE
            return e.type

        if isinstance(e, A.Variable):
            try:
                return scope.resolve(e)
            except _Unresolved as u:
                emit(u.code, u.message)
                return None

        if isinstance(e, A.TemplateParam):
            # tenant-template placeholder: types as its declared
            # `${name:type}` type, so a binding position that contradicts
            # the surrounding expression (e.g. `price > ${t:string}`)
            # fails right here through the shared comparability tables.
            # Untyped placeholders type as unknown; the template-binding
            # plan rule rejects them with a dedicated message.
            return e.type if isinstance(e.type, AttrType) else None

        if isinstance(e, A.MathOp):
            l, r = te(e.left), te(e.right)
            bad = False
            for t in (l, r):
                if t is not None and t not in NUMERIC_TYPES:
                    emit("non-numeric-math",
                         f"'{e.op}' requires numeric operands, got "
                         f"{t.value.upper()}")
                    bad = True
            if bad or l is None or r is None:
                return None
            return promote(l, r)

        if isinstance(e, A.Compare):
            l, r = te(e.left), te(e.right)
            if l is not None and r is not None:
                if not comparable(l, r):
                    if (l is _STRING) != (r is _STRING):
                        other = r if l is _STRING else l
                        emit("string-numeric-compare",
                             f"cannot compare STRING with "
                             f"{other.value.upper()}: device strings are "
                             "int32 dictionary codes — the comparison "
                             "would relate codes, not text")
                    else:
                        emit("incomparable-types",
                             f"cannot compare {l.value.upper()} with "
                             f"{r.value.upper()}")
                elif l is _STRING and e.op not in ("==", "!="):
                    emit("string-ordering",
                         f"ordering comparison '{e.op}' on STRING is not "
                         "supported on device (dictionary codes are not "
                         "lexicographic)")
            return _BOOL

        if isinstance(e, (A.And, A.Or)):
            for t, side in ((te(e.left), "left"), (te(e.right), "right")):
                if t is not None and t is not _BOOL:
                    word = "AND" if isinstance(e, A.And) else "OR"
                    emit("non-bool-logical",
                         f"{word} requires BOOL operands, {side} side is "
                         f"{t.value.upper()}")
            return _BOOL

        if isinstance(e, A.Not):
            t = te(e.expr)
            if t is not None and t is not _BOOL:
                emit("non-bool-logical",
                     f"NOT requires a BOOL operand, got {t.value.upper()}")
            return _BOOL

        if isinstance(e, A.IsNull):
            if e.expr is not None:
                te(e.expr)
            return _BOOL

        if isinstance(e, A.InTable):
            # inner expression may be table-scoped; table vars resolve
            # to unknown in every scope, so this stays silent for them
            te(e.expr)
            return _BOOL

        if isinstance(e, A.AttributeFunction):
            return self._type_function(e, scope, emit, agg)

        return None

    def _type_function(self, e: A.AttributeFunction, scope, emit,
                       agg: bool) -> Optional[AttrType]:
        params = [self.type_expr(p, scope, emit, agg) for p in e.parameters]
        key = e.name.lower()

        if e.namespace is not None:
            if e.namespace.lower() == "math":
                return self._type_math(key, params, emit)
            return None            # extension function: planner resolves

        if agg and key in AGGREGATOR_NAMES:
            arg = params[0] if params else None
            if not e.star and not aggregator_accepts(key, arg):
                emit("aggregator-input",
                     f"aggregator '{e.name}' cannot take a "
                     f"{arg.value.upper()} argument")
                return aggregator_result_type(key, None)
            return aggregator_result_type(key, arg)

        if key in ("convert", "cast"):
            if len(e.parameters) == 2 and \
                    isinstance(e.parameters[1], A.Constant):
                try:
                    return AttrType.from_name(str(e.parameters[1].value))
                except ValueError:
                    return None
            return None
        if key == "coalesce":
            return self._fold_shared_type(params)
        if key == "ifthenelse":
            if len(params) != 3:
                return None
            cond, a, b = params
            if cond is not None and cond is not _BOOL:
                emit("non-bool-logical",
                     "ifThenElse() condition must be BOOL, got "
                     f"{cond.value.upper()}")
            return self._fold_shared_type([a, b])
        if key in ("maximum", "minimum"):
            for t in params:
                if t is not None and t not in NUMERIC_TYPES:
                    emit("non-numeric-math",
                         f"{e.name}() requires numeric arguments, got "
                         f"{t.value.upper()}")
                    return None
            return self._fold_shared_type(params)
        if key == "default":
            return self._fold_shared_type(params)
        if key == "uuid":
            return _STRING
        if key in ("eventtimestamp", "currenttimemillis"):
            return _LONG
        if key.startswith("instanceof"):
            return _BOOL
        if key == "createset":
            return AttrType.OBJECT
        if key == "sizeofset":
            return AttrType.INT
        fd = self.app.function_definitions.get(e.name)
        if fd is not None:
            return fd.return_type
        return None                # unknown/extension: planner's call

    @staticmethod
    def _type_math(key: str, params, emit) -> Optional[AttrType]:
        unary = ("abs", "ceil", "floor", "sqrt", "exp", "ln", "log10",
                 "sin", "cos", "tan", "asin", "acos", "atan", "signum",
                 "round")
        if key in unary and len(params) == 1:
            t = params[0]
            if t is not None and t not in NUMERIC_TYPES:
                emit("non-numeric-math",
                     f"math:{key}() requires a numeric argument, got "
                     f"{t.value.upper()}")
                return None
            return t if key == "abs" else _DOUBLE
        if key == "power" and len(params) == 2:
            return _DOUBLE
        return None

    @staticmethod
    def _fold_shared_type(params) -> Optional[AttrType]:
        """coalesce/default/ifThenElse branch typing: numeric operands
        promote, otherwise all must share a type; unknown poisons."""
        t: Optional[AttrType] = None
        for p in params:
            if p is None:
                return None
            if t is None:
                t = p
            elif p in NUMERIC_TYPES and t in NUMERIC_TYPES:
                t = promote(t, p)
            elif p is not t:
                return None       # runtime raises; arity rules cover it
        return t

    # -- input contexts -------------------------------------------------
    def _chain_schema(self, sin: A.SingleInputStream,
                      base: Optional[Schema]) -> Optional[Schema]:
        """Schema after a stream's handler chain (filters/windows keep
        it; stream functions may rewrite it — log keeps, pol2Cart
        appends, extensions are unknown)."""
        schema = base
        for h in sin.handlers:
            if not isinstance(h, A.StreamFunction):
                continue
            fname = (f"{h.namespace}:{h.name}"
                     if h.namespace else h.name).lower()
            if fname == "log":
                continue
            if fname == "pol2cart" and schema is not None:
                extra = [("cartX", _DOUBLE), ("cartY", _DOUBLE)]
                if len(h.parameters) == 3:
                    extra.append(("cartZ", _DOUBLE))
                schema = Schema(schema.stream_id,
                                schema.attrs + tuple(extra), INFERRED)
            else:
                return None
        return schema

    def _input_schema_for(self, sin: A.SingleInputStream,
                          qi: _QueryInfo) -> Optional[Schema]:
        if sin.is_fault:
            return self.sources.get("!" + sin.stream_id)
        if sin.is_inner:
            if qi.partition_index is None:
                return None
            inner = self._inner_schemas.get(qi.partition_index, {})
            return inner.get("#" + sin.stream_id)
        return self.sources.get(sin.stream_id) \
            or self._implicit.get(sin.stream_id)

    def _pattern_slots(self, st: A.StateInputStream,
                       qi: _QueryInfo) -> list[_Slot]:
        slots = []
        for el in A.iter_state_elements(st.state):
            if isinstance(el, A.StreamStateElement) and el.stream is not None:
                base = self._input_schema_for(el.stream, qi)
                slots.append(_Slot(ref=el.event_ref,
                                   stream_id=el.stream.stream_id,
                                   schema=self._chain_schema(el.stream, base),
                                   stream=el.stream))
        return slots

    # -- per-query output schema (pure: no emission) --------------------
    def _query_out_schema(self, qi: _QueryInfo) -> Optional[Schema]:
        q = qi.query
        target = getattr(q.output, "target", None) or "::return"
        sel = q.selector
        inp = q.input

        if isinstance(inp, A.SingleInputStream):
            schema = self._chain_schema(
                inp, self._input_schema_for(inp, qi))
            if sel.select_all:
                if schema is None:
                    return None
                return Schema(target, schema.attrs, INFERRED, qi.query.line)
            refs = {inp.stream_id}
            if inp.alias:
                refs.add(inp.alias)
            scope = _SingleScope(self, schema, refs)
        elif isinstance(inp, A.JoinInputStream):
            l = self._chain_schema(inp.left,
                                   self._input_schema_for(inp.left, qi))
            r = self._chain_schema(inp.right,
                                   self._input_schema_for(inp.right, qi))
            if sel.select_all:
                if l is None or r is None:
                    return None
                return Schema(target, l.attrs + r.attrs, INFERRED,
                              qi.query.line)
            scope = _JoinScope(
                self, l, inp.left.alias or inp.left.stream_id,
                r, inp.right.alias or inp.right.stream_id)
        elif isinstance(inp, A.StateInputStream):
            slots = self._pattern_slots(inp, qi)
            if sel.select_all:
                # select * flattens (slot, attr, copy); copies only
                # exceed 1 under counting states, which we do not model
                # — mirror the cap==1 flattening (ops/nfa.py NfaEngine)
                if any(isinstance(el, A.CountStateElement)
                       for el in A.iter_state_elements(inp.state)) \
                        or any(s.schema is None for s in slots):
                    return None
                attrs = []
                for s in slots:
                    for n, t in s.schema.attrs:
                        attrs.append((f"{s.ref or s.stream_id}_{n}", t))
                return Schema(target, tuple(attrs), INFERRED,
                              qi.query.line)
            scope = _PatternScope(self, slots)
        else:
            return None            # anonymous inputs: planner rejects

        attrs = []
        for i, oa in enumerate(sel.attributes):
            t = self.type_expr(oa.expression, scope, self._no_emit,
                               agg=True)
            attrs.append((_output_attribute_name(oa, i), t))
        return Schema(target, tuple(attrs), INFERRED, qi.query.line)

    # -- schema fixpoint ------------------------------------------------
    def infer(self) -> None:
        self._implicit: dict[str, Schema] = {}
        self._inner_schemas: dict[int, dict[str, Schema]] = {}
        for _ in range(len(self.infos) + 2):
            changed = False
            inner_next: dict[int, dict[str, Schema]] = {}
            for i, qi in enumerate(self.infos):
                out = self._query_out_schema(qi)
                if out != self.out_schemas[i]:
                    self.out_schemas[i] = out
                    changed = True
                # inner (#) insert targets live per partition, first
                # producer wins (mirrors the planner's ordered map)
                o = qi.query.output
                if qi.partition_index is not None and \
                        isinstance(o, A.InsertIntoStream) and o.is_inner \
                        and out is not None:
                    inner_next.setdefault(qi.partition_index, {}) \
                        .setdefault("#" + o.target, out)
            # app-scope implicit streams: first producer in query order
            implicit_next: dict[str, Schema] = {}
            for target, idxs in self.producers.items():
                if target in self.sources:
                    continue       # explicitly defined: not implicit
                for i in idxs:
                    if self.out_schemas[i] is not None:
                        implicit_next[target] = Schema(
                            target, self.out_schemas[i].attrs, INFERRED,
                            self.infos[i].query.line)
                        break
            if implicit_next != self._implicit or \
                    inner_next != self._inner_schemas:
                changed = True
            self._implicit = implicit_next
            self._inner_schemas = inner_next
            if not changed:
                break

    # -- check pass ------------------------------------------------------
    def check(self) -> None:
        for ei, el in enumerate(self.app.execution_elements):
            if isinstance(el, A.Partition):
                self._check_partition_keys(el, ei)
        for i, qi in enumerate(self.infos):
            self._check_query(qi, self.out_schemas[i])
        self._check_insert_edges()
        self._check_dataflow()
        self._check_float64()

    def _check_partition_keys(self, part: A.Partition, ei: int) -> None:
        emit = self._emitter(None, f"partition{ei + 1}")
        for pt in part.partition_types:
            schema = self.sources.get(pt.stream_id)
            scope = _SingleScope(self, schema, {pt.stream_id})
            if isinstance(pt, A.ValuePartitionType) and \
                    pt.expression is not None:
                self.type_expr(pt.expression, scope, emit)
            elif isinstance(pt, A.RangePartitionType):
                for cond, _label in pt.ranges:
                    t = self.type_expr(cond, scope, emit)
                    if t is not None and t is not _BOOL:
                        emit("non-bool-filter",
                             "partition range condition must be BOOL, "
                             f"got {t.value.upper()}")

    def _check_query(self, qi: _QueryInfo,
                     out_schema: Optional[Schema]) -> None:
        q = qi.query
        emit = self._emitter(qi)
        sel = q.selector
        inp = q.input
        scope = None

        def check_filters(sin: A.SingleInputStream, base: Optional[Schema],
                          fscope, label: str):
            schema = base
            for h in sin.handlers:
                if isinstance(h, A.Filter):
                    t = self.type_expr(h.expression, fscope, emit)
                    if t is not None and t is not _BOOL:
                        emit("non-bool-filter",
                             f"{label} filter condition must be BOOL, "
                             f"got {t.value.upper()}")
                elif isinstance(h, A.StreamFunction):
                    schema = self._chain_schema(
                        A.SingleInputStream(sin.stream_id,
                                            handlers=[h]), schema)
                    if isinstance(fscope, _SingleScope):
                        fscope = _SingleScope(self, schema, fscope.refs)
            return fscope

        if isinstance(inp, A.SingleInputStream):
            base = self._input_schema_for(inp, qi)
            refs = {inp.stream_id}
            if inp.alias:
                refs.add(inp.alias)
            scope = check_filters(
                inp, base, _SingleScope(self, base, refs), "stream")
            scope = _SingleScope(self, self._chain_schema(inp, base),
                                 scope.refs)
        elif isinstance(inp, A.JoinInputStream):
            for sin, label in ((inp.left, "left"), (inp.right, "right")):
                base = self._input_schema_for(sin, qi)
                refs = {sin.stream_id}
                if sin.alias:
                    refs.add(sin.alias)
                check_filters(sin, base, _SingleScope(self, base, refs),
                              label)
            scope = _JoinScope(
                self,
                self._chain_schema(inp.left,
                                   self._input_schema_for(inp.left, qi)),
                inp.left.alias or inp.left.stream_id,
                self._chain_schema(inp.right,
                                   self._input_schema_for(inp.right, qi)),
                inp.right.alias or inp.right.stream_id)
            if inp.on is not None:
                t = self.type_expr(inp.on, scope, emit)
                if t is not None and t is not _BOOL:
                    emit("non-bool-filter",
                         "join ON condition must be BOOL, got "
                         f"{t.value.upper()}")
        elif isinstance(inp, A.StateInputStream):
            slots = self._pattern_slots(inp, qi)
            for j, slot in enumerate(slots):
                sscope = _PatternScope(self, slots, own_slot=j)
                for h in slot.stream.handlers:
                    if isinstance(h, A.Filter):
                        t = self.type_expr(h.expression, sscope, emit)
                        if t is not None and t is not _BOOL:
                            emit("non-bool-filter",
                                 f"pattern condition on "
                                 f"'{slot.ref or slot.stream_id}' must "
                                 f"be BOOL, got {t.value.upper()}")
            scope = _PatternScope(self, slots)
        else:
            return

        if not sel.select_all:
            for oa in sel.attributes:
                self.type_expr(oa.expression, scope, emit, agg=True)
        for g in sel.group_by:
            self.type_expr(g, scope, emit)
        if sel.having is not None:
            hscope = _OutputChainScope(out_schema, scope)
            t = self.type_expr(sel.having, hscope, emit, agg=True)
            if t is not None and t is not _BOOL:
                emit("non-bool-having",
                     f"HAVING must be BOOL, got {t.value.upper()}")
        if out_schema is not None:
            for ob in sel.order_by:
                v = ob.variable
                if v is not None and v.attribute is not None \
                        and not _skippable(v) \
                        and not out_schema.has(v.attribute):
                    emit("undefined-attribute",
                         f"order by '{v.attribute}' is not an output "
                         "attribute")

    # -- insert-into edges ----------------------------------------------
    def _check_insert_edges(self) -> None:
        for target, idxs in self.producers.items():
            decl = self.app.stream_definitions.get(target) \
                or self.app.window_definitions.get(target)
            if target in self.table_ids:
                continue           # store semantics: name-matched upsert
            if decl is not None:
                dschema = schema_from_attribute_defs(
                    target, decl.attributes)
                for i in idxs:
                    self._check_insert_against(self.infos[i],
                                               self.out_schemas[i],
                                               dschema, "stream"
                                               if target in
                                               self.app.stream_definitions
                                               else "window")
            elif target in self.sources:
                # trigger / other builtin-schema target
                dschema = self.sources[target]
                if dschema is not None:
                    for i in idxs:
                        self._check_insert_against(
                            self.infos[i], self.out_schemas[i], dschema,
                            "stream")
            else:
                self._check_implicit_conflicts(target, idxs)
        # inner streams: conflicting producers inside one partition
        for ei, el in enumerate(self.app.execution_elements):
            if not isinstance(el, A.Partition):
                continue
            seen: dict[str, tuple] = {}
            for i, qi in enumerate(self.infos):
                if qi.partition_index != ei:
                    continue
                o = qi.query.output
                if not (isinstance(o, A.InsertIntoStream) and o.is_inner):
                    continue
                out = self.out_schemas[i]
                if out is None or not out.fully_known:
                    continue
                prev = seen.get(o.target)
                if prev is not None and prev != out.types:
                    self._emitter(qi)(
                        "implicit-schema-conflict",
                        f"inner stream '#{o.target}' schema mismatch "
                        "between producers")
                seen.setdefault(o.target, out.types)

    def _check_insert_against(self, qi: _QueryInfo,
                              out: Optional[Schema], decl: Schema,
                              kind: str) -> None:
        if out is None:
            return
        emit = self._emitter(qi)
        if len(out.attrs) != len(decl.attrs):
            emit("insert-arity",
                 f"inserts {len(out.attrs)} attribute(s) into {kind} "
                 f"'{decl.stream_id}' defined with {len(decl.attrs)} "
                 f"{decl.render()}")
            return
        for (name, src), (dname, dst) in zip(out.attrs, decl.attrs):
            compat = insert_compat(src, dst)
            if compat == MISMATCH:
                emit("insert-type",
                     f"output '{name}' is {src.value.upper()} but "
                     f"{kind} '{decl.stream_id}' declares '{dname}' as "
                     f"{dst.value.upper()} (not coercible)")
            elif compat == COERCE:
                emit("insert-coerce",
                     f"output '{name}' is {src.value.upper()}, widened "
                     f"into '{dname}' {dst.value.upper()} of {kind} "
                     f"'{decl.stream_id}' — the runtime rejects "
                     "mismatched insert-into; align the types",
                     WARNING)

    def _check_implicit_conflicts(self, target: str, idxs: list[int]):
        first: Optional[tuple] = None
        first_qi: Optional[_QueryInfo] = None
        for i in idxs:
            out = self.out_schemas[i]
            if out is None or not out.fully_known:
                continue
            if first is None:
                first, first_qi = out.types, self.infos[i]
            elif out.types != first:
                self._emitter(self.infos[i])(
                    "implicit-schema-conflict",
                    f"insert into implicit stream '{target}' with schema "
                    f"{out.render()} conflicts with the schema inferred "
                    f"from query '{first_qi.name}' "
                    f"{self._implicit[target].render()}")

    # -- dead dataflow ---------------------------------------------------
    def _consumed_ids(self) -> set:
        consumed: set = set()
        for qi in self.infos:
            for sin in A.iter_query_inputs(qi.query):
                consumed.add(sin.stream_id)   # fault input implies base
        for el in self.app.execution_elements:
            if isinstance(el, A.Partition):
                for pt in el.partition_types:
                    consumed.add(pt.stream_id)
        for ad in self.app.aggregation_definitions.values():
            if ad.input is not None:
                consumed.add(ad.input.stream_id)
        for sid, sd in self.app.stream_definitions.items():
            if any(a.name.lower() == "sink" for a in sd.annotations):
                consumed.add(sid)
        return consumed

    def _check_dataflow(self) -> None:
        consumed = self._consumed_ids()
        produced = set(self.producers)
        for sid, sd in self.app.stream_definitions.items():
            if sd.is_inner or sd.is_fault:
                continue
            has_source = any(a.name.lower() == "source"
                             for a in sd.annotations)
            if sid not in consumed and sid not in produced \
                    and not has_source:
                self._emitter(None, f"stream {sid}")(
                    "dead-stream",
                    f"defined stream '{sid}' is never consumed or "
                    "produced by any query, partition, aggregation, "
                    "source or sink", WARNING)
        for target, idxs in self.producers.items():
            if target in consumed:
                continue
            decl = self.app.stream_definitions.get(target)
            if decl is not None and any(
                    a.name.lower() == "sink" for a in decl.annotations):
                continue
            if target in self.table_ids or \
                    target in self.app.window_definitions:
                continue           # tables/named windows are stores
            self._emitter(self.infos[idxs[0]])(
                "dead-output",
                f"output stream '{target}' feeds no sink or downstream "
                "query (only host callbacks could observe it)", WARNING)

    # -- float64 hot-path ------------------------------------------------
    def _check_float64(self) -> None:
        consumed = self._consumed_ids()
        for sid, sd in self.app.stream_definitions.items():
            if sid not in consumed:
                continue
            dbl = [a.name for a in sd.attributes
                   if a.type is AttrType.DOUBLE]
            if dbl:
                self._emitter(None, f"stream {sid}")(
                    "float64-hot-path",
                    f"DOUBLE attribute(s) {', '.join(dbl)} of stream "
                    f"'{sid}' enter the jitted hot path as float64 — "
                    "half throughput on TPU; prefer float/long unless "
                    "Java-double parity is required "
                    "(docs/tpu_hygiene.md)", WARNING)
        for target, schema in sorted(self._implicit.items()):
            dbl = [n for n, t in schema.attrs if t is AttrType.DOUBLE]
            if dbl:
                self._emitter(None, f"stream {target}")(
                    "float64-hot-path",
                    f"inferred attribute(s) {', '.join(dbl)} of implicit "
                    f"stream '{target}' are DOUBLE — downstream "
                    "consumers inherit float64 on the hot path "
                    "(docs/tpu_hygiene.md)", WARNING)

    # -- driver ----------------------------------------------------------
    def run(self) -> TypeReport:
        self.infer()
        self.check()
        schemas = {k: v for k, v in self.sources.items() if v is not None}
        schemas.update(self._implicit)
        for ei, inner in self._inner_schemas.items():
            for k, v in inner.items():
                schemas[f"partition{ei}:{k}"] = v
        return TypeReport(issues=self.issues, schemas=schemas)


# ---------------------------------------------------------------------------
# public facade
# ---------------------------------------------------------------------------


def analyze_app(app: A.SiddhiApp) -> TypeReport:
    """Full static type analysis: inferred schemas + all issues."""
    return TypeChecker(app).run()


def check_app(app: A.SiddhiApp) -> None:
    """Parser hook: raise CompileError on error-severity type issues."""
    errors = analyze_app(app).errors
    if errors:
        from ..ops.expr import CompileError
        raise CompileError("; ".join(i.render() for i in errors))


def findings_from_issues(issues, path: str) -> list[Finding]:
    """Adapt TypeIssues (and plan_rules PlanIssues) to the Finding model
    so `tools/lint.py --plan` reuses the baseline/suppression machinery.
    Identity stays line-independent (rule::path::message)."""
    out = []
    for i in issues:
        out.append(Finding(rule=i.code, severity=i.severity, path=path,
                           line=getattr(i, "line", None) or 1, col=0,
                           message=f"{i.where}: {i.message}"))
    return out
