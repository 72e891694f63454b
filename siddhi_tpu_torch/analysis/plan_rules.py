"""Static query-plan validation over the SiddhiQL object model.

Runs right after parsing (lang/parser.parse calls check_app) so broken
plans fail with a `file-less` compile error naming the query and the
construct, instead of surfacing later as an XLA shape error deep inside
a jitted step. The checks mirror what the runtime planner would reject
anyway — undefined streams, window/aggregator arity — plus dead-plan
diagnostics (states that can never fire) the planner silently accepts.

Severity model: ``error`` issues are definite planner rejections and
make ``check_app`` raise CompileError; ``warning`` issues (dead states,
constant-false filters, non-positive `within`) are advisory and only
surfaced through ``validate_app``.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Iterator, Optional

from ..lang import ast as A

ERROR = "error"
WARNING = "warning"


@dataclasses.dataclass(frozen=True)
class PlanIssue:
    code: str
    severity: str
    where: str       # query name / partition / definition anchor
    message: str

    def render(self) -> str:
        return f"{self.where}: {self.severity} [{self.code}] {self.message}"


# parameter-count envelopes for the built-in windows, mirroring
# core/runtime.py make_window (min, max); max None == unbounded
WINDOW_ARITY: dict[str, tuple[int, Optional[int]]] = {
    "time": (1, 1), "length": (1, 1), "lengthbatch": (1, 2),
    "hopping": (2, 2), "hoping": (2, 2), "timebatch": (1, 3),
    "externaltimebatch": (2, 5), "externaltime": (2, 2),
    "timelength": (2, 2), "delay": (1, 1), "batch": (0, 1),
    "cron": (1, 1), "session": (1, 2), "sort": (1, None),
    "frequent": (1, None), "lossyfrequent": (1, None),
}

# windows whose first parameter must be a stream attribute, not a constant
_ATTR_FIRST_WINDOWS = {"externaltime", "externaltimebatch"}

# on-error action envelopes (core/stream.py @OnError routing and
# core/io.py connector policies)
ONERROR_STREAM_ACTIONS = ("LOG", "STREAM", "STORE")
ONERROR_SINK_ACTIONS = ("RETRY", "WAIT", "STORE", "LOG", "STREAM")
ONERROR_SOURCE_ACTIONS = ("RETRY", "WAIT")

# @app:statistics(interval=...) time strings — keep in sync with
# core/runtime.py _time_str_ms (the planner's parser of record)
_TIME_STR = re.compile(
    r"(\d+)\s*(millisecond|milliseconds|ms|sec|second|seconds|s|"
    r"min|minute|minutes|hour|hours|h)?")

# aggregator arity over ops/selector.py AGGREGATOR_NAMES: (min, max)
AGGREGATOR_ARITY: dict[str, tuple[int, int]] = {
    "sum": (1, 1), "avg": (1, 1), "count": (0, 1),
    "distinctcount": (1, 1), "min": (1, 1), "max": (1, 1),
    "minforever": (1, 1), "maxforever": (1, 1), "stddev": (1, 1),
    "and": (1, 1), "or": (1, 1), "unionset": (1, 1),
}


# shared AST walkers (lang/ast.py) under the historical local names
_iter_exprs = A.walk_expressions
_iter_state_elements = A.iter_state_elements
_state_streams = A.iter_state_streams
_query_inputs = A.iter_query_inputs


def iter_template_param_uses(q: A.Query):
    """Yield ``(where, param, allowed)`` for every `${name:type}`
    placeholder a query's expressions contain. ``allowed`` is True only
    in the positions the runtime can carry as per-tenant parameters
    (ops/expr.py tparam machinery): filter conditions without table
    references, and non-aggregating select/having — everything else
    (window/stream-function arguments, join ON, pattern conditions,
    group-by, table-output clauses, aggregating selectors) is structural
    and must be bound at the pool level instead."""
    from ..ops.selector import selector_needs_aggregation
    from ..ops.table import expr_mentions_table

    def params(expr):
        if expr is None:
            return ()
        return tuple(e for e in A.walk_expressions(expr)
                     if isinstance(e, A.TemplateParam))

    plain = isinstance(q.input, A.SingleInputStream)
    for sin in A.iter_query_inputs(q):
        for h in sin.handlers:
            if isinstance(h, A.Filter):
                ok = plain and not expr_mentions_table(h.expression)
                where = "filter condition" if ok else \
                    ("table-reference filter" if plain
                     else "join/pattern stream filter")
                for p in params(h.expression):
                    yield where, p, ok
            else:
                kind = "window" if isinstance(h, A.WindowHandler) \
                    else "stream-function"
                for e in h.parameters:
                    for p in params(e):
                        yield f"{kind} '{h.name}' parameter", p, False
    if isinstance(q.input, A.JoinInputStream):
        for p in params(q.input.on):
            yield "join ON condition", p, False
    needs_agg = selector_needs_aggregation(q.selector)
    sel_ok = plain and not needs_agg
    sel_where = "select/having" if sel_ok else \
        ("aggregating select/having" if plain else "select/having")
    for oa in q.selector.attributes:
        for p in params(oa.expression):
            yield sel_where, p, sel_ok
    for p in params(q.selector.having):
        yield sel_where, p, sel_ok
    for attr in ("on",):
        e = getattr(q.output, attr, None)
        for p in params(e):
            yield "table-output ON clause", p, False
    for pair in getattr(q.output, "set_clause", None) or ():
        for e in pair:
            for p in params(e):
                yield "table-output SET clause", p, False


class PlanValidator:
    def __init__(self, app: A.SiddhiApp,
                 allow_template_params: bool = False):
        self.app = app
        self.allow_template_params = allow_template_params
        self.issues: list[PlanIssue] = []
        # every id events can be consumed from at app scope
        self.defined: set[str] = set()
        self.defined |= set(app.stream_definitions)
        self.defined |= set(app.table_definitions)
        self.defined |= set(app.window_definitions)
        self.defined |= set(app.trigger_definitions)
        self.defined |= set(app.aggregation_definitions)
        # insert-into targets implicitly define streams (junction_for)
        for q in self._all_queries():
            out = q.output
            if isinstance(out, A.InsertIntoStream) and not out.is_inner \
                    and not out.is_fault:
                self.defined.add(out.target)

    def _all_queries(self) -> Iterator[A.Query]:
        for el in self.app.execution_elements:
            if isinstance(el, A.Query):
                yield el
            elif isinstance(el, A.Partition):
                yield from el.queries

    def add(self, code, severity, where, message):
        self.issues.append(PlanIssue(code=code, severity=severity,
                                     where=where, message=message))

    # -- checks --------------------------------------------------------
    def validate(self) -> list[PlanIssue]:
        self.check_app_statistics()
        self.check_slo()
        self.check_watermarks()
        self.check_template_params()
        self.check_shareable_prefixes()
        for sid, sd in self.app.stream_definitions.items():
            self.check_on_error_actions(sid, sd)
        qn = 0
        for el in self.app.execution_elements:
            if isinstance(el, A.Query):
                qn += 1
                self.check_query(el, el.name or f"query{qn}",
                                 inner_scope=None)
            elif isinstance(el, A.Partition):
                self.check_partition(el, f"partition{qn + 1}")
                qn += len(el.queries)
        return self.issues

    def check_shareable_prefixes(self) -> None:
        """``shareable-prefix``: queries reading the same stream with an
        identical leading filter prefix (canonical signature,
        plan/canon.py — the SAME detector the optimizer's CSE pass
        uses) are advisory-flagged when the plan optimizer is DISABLED
        (``SIDDHI_TPU_OPT=0`` / ``SIDDHI_TPU_OPT_CSE=0``): the fan-out
        would evaluate the shared work once per query instead of once
        per chunk. With the optimizer on (the default) the prefix IS
        shared and nothing fires."""
        import os
        if os.environ.get("SIDDHI_TPU_OPT", "1") != "0" and \
                os.environ.get("SIDDHI_TPU_OPT_CSE", "1") != "0":
            return
        from ..plan.canon import canonical_expr
        qn = 0
        by_stream: dict[str, list] = {}
        for el in self.app.execution_elements:
            if not isinstance(el, A.Query):
                qn += len(el.queries) if isinstance(el, A.Partition) \
                    else 1
                continue
            qn += 1
            name = el.name or f"query{qn}"
            sin = el.input
            if not isinstance(sin, A.SingleInputStream):
                continue
            sigs = []
            for h in sin.handlers:
                if not isinstance(h, A.Filter):
                    break  # stateless-shareable prefix = leading filters
                sigs.append(canonical_expr(h.expression))
            if sigs:
                by_stream.setdefault(sin.stream_id, []).append(
                    (name, tuple(sigs)))
        for sid in sorted(by_stream):
            entries = by_stream[sid]
            by_first: dict[str, list] = {}
            for name, sigs in entries:
                by_first.setdefault(sigs[0], []).append(name)
            for sig in sorted(by_first):
                names = by_first[sig]
                if len(names) < 2:
                    continue
                self.add(
                    "shareable-prefix", WARNING, ", ".join(names),
                    f"queries on stream '{sid}' share an identical "
                    "filter prefix that is evaluated once per query "
                    "with the plan optimizer disabled — enable "
                    "SIDDHI_TPU_OPT (CSE shares one evaluation per "
                    "chunk, docs/performance.md)")

    def check_app_statistics(self) -> None:
        """Unknown ``@app:statistics`` reporter names / unparseable
        intervals are definite runtime rejections — fail at parse time
        with the offending value named (same pattern as
        `on-error-action`; reporter surface in obs/reporters.py)."""
        sa = A.find_annotation(self.app.annotations, "statistics")
        if sa is None:
            return
        from ..obs.reporters import REPORTER_NAMES
        rep = sa.element("reporter")
        if rep is not None and \
                rep.strip("'\"").lower() not in REPORTER_NAMES:
            self.add(
                "statistics-reporter", ERROR, "app",
                f"unknown @app:statistics reporter '{rep}' (expected "
                f"one of {', '.join(REPORTER_NAMES)})")
        interval = sa.element("interval")
        if interval is not None and \
                not _TIME_STR.fullmatch(str(interval).strip()):
            self.add(
                "statistics-interval", ERROR, "app",
                f"cannot parse @app:statistics interval '{interval}' "
                "(expected e.g. '5 sec', '500 ms', '1 min')")

    def check_template_params(self) -> None:
        """``template-binding``: `${name:type}` placeholder hygiene.

        Outside template mode any placeholder is an unbound literal —
        the app was deployed directly instead of through the tenant
        serving front door (serving/template.py), a definite planner
        rejection. In template mode (``parse(..., template=True)``)
        placeholders are the point, but they must be typed, appear only
        in positions the runtime can parameterize per tenant (filter
        conditions, non-aggregating select/having — see
        iter_template_param_uses), and declare ONE type per name."""
        declared: dict[str, object] = {}
        qn = 0
        for el in self.app.execution_elements:
            queries = [el] if isinstance(el, A.Query) else list(el.queries)
            in_partition = isinstance(el, A.Partition)
            for q in queries:
                qn += 1
                name = q.name or f"query{qn}"
                for where, p, allowed in iter_template_param_uses(q):
                    ph = f"${{{p.name}}}" if p.type is None else \
                        f"${{{p.name}:{p.type.value}}}"
                    if not self.allow_template_params:
                        self.add(
                            "template-binding", ERROR, name,
                            f"unbound placeholder {ph} — tenant templates "
                            "deploy through the serving front door "
                            "(serving/template.py), or bind the value "
                            "statically before deploying")
                        continue
                    if p.type is None:
                        self.add(
                            "template-binding", ERROR, name,
                            f"structural placeholder {ph} survived "
                            "substitution — bind it via the template's "
                            "shared bindings")
                        continue
                    if in_partition:
                        self.add(
                            "template-binding", ERROR, name,
                            f"placeholder {ph} inside a partition is not "
                            "supported (partitions already vmap the key "
                            "axis)")
                    elif not allowed:
                        self.add(
                            "template-binding", ERROR, name,
                            f"placeholder {ph} in a {where} is structural "
                            "— only filter conditions and non-aggregating "
                            "select/having can carry per-tenant "
                            "parameters; bind it via shared bindings")
                    prev = declared.get(p.name)
                    if prev is None:
                        declared[p.name] = p.type
                    elif prev is not p.type:
                        self.add(
                            "template-binding", ERROR, name,
                            f"placeholder '${{{p.name}}}' declared with "
                            f"conflicting types {prev.value} and "
                            f"{p.type.value}")

    def check_slo(self) -> None:
        """``slo-config``: ``@app:slo(...)`` latency-objective hygiene.
        Missing bound, unparseable time strings, target outside (0, 1),
        fast window exceeding the slow window, warn.burn above
        page.burn and bad strides are definite runtime rejections —
        fail at parse time with the offending value named (shared
        parser in obs/slo.py so validation cannot drift from planner
        behavior — the watermark-config pattern)."""
        ann = A.find_annotation(self.app.annotations, "slo")
        if ann is None:
            return
        from ..obs.slo import config_from_annotation
        try:
            config_from_annotation(ann)
        except ValueError as e:
            self.add("slo-config", ERROR, "app", str(e))

    def check_watermarks(self) -> None:
        """``@app:watermark`` / per-stream ``@watermark`` annotations:
        unknown late policy, negative/unparseable lateness, bad cap or
        dedup values, and watermark targets naming undefined streams
        are definite runtime rejections — fail at parse time with the
        offending value named (same pattern as ``on-error-action``;
        shared parser in resilience/ordering.py so validation cannot
        drift from planner behavior)."""
        from ..resilience.ordering import config_from_annotation
        for ann in self.app.annotations:
            if ann.name.lower() != "watermark":
                continue
            conf = None
            try:
                conf = config_from_annotation(ann)
            except ValueError as e:
                self.add("watermark-config", ERROR, "app", str(e))
            tgt = ann.element("stream")
            if tgt is not None:
                t = str(tgt).strip().strip("'\"")
                if t not in self.app.stream_definitions:
                    self.add(
                        "watermark-config", ERROR, "app",
                        f"@app:watermark targets undefined stream '{t}'")
            self._check_late_stream(conf, "app", None)
        for sid, sd in self.app.stream_definitions.items():
            ann = A.find_annotation(sd.annotations, "watermark")
            if ann is None:
                continue
            conf = None
            try:
                conf = config_from_annotation(ann)
            except ValueError as e:
                self.add("watermark-config", ERROR, f"stream {sid}",
                         str(e))
            self._check_late_stream(conf, f"stream {sid}", sid)

    def _check_late_stream(self, conf, where: str,
                           sid: Optional[str]) -> None:
        """policy='STREAM' side-outputs late events with their original
        attributes: the late.stream target must be a defined stream
        and, when the source stream is known, schema-identical."""
        if conf is None or conf.late_stream is None:
            return
        lsd = self.app.stream_definitions.get(conf.late_stream)
        if lsd is None:
            self.add(
                "watermark-config", ERROR, where,
                f"@watermark late.stream '{conf.late_stream}' is not a "
                "defined stream")
            return
        if sid is not None:
            src = self.app.stream_definitions[sid]
            if [a.type for a in lsd.attributes] != \
                    [a.type for a in src.attributes]:
                self.add(
                    "watermark-config", ERROR, where,
                    f"@watermark late.stream '{conf.late_stream}' "
                    f"schema does not match stream '{sid}'")

    def check_on_error_actions(self, sid: str, sd) -> None:
        """Unknown @OnError / connector `on.error` action values are
        definite runtime rejections — fail at parse time with the
        stream and action named (extends the PR 1 plan rules)."""
        for ann in sd.annotations:
            nm = ann.name.lower()
            if nm == "onerror":
                action = (ann.element("action") or "LOG").upper()
                if action not in ONERROR_STREAM_ACTIONS:
                    self.add(
                        "on-error-action", ERROR, f"stream {sid}",
                        f"unknown @OnError action '{action}' (expected "
                        f"one of {', '.join(ONERROR_STREAM_ACTIONS)})")
            elif nm in ("sink", "source"):
                action = ann.element("on.error")
                if action is None:
                    continue
                valid = ONERROR_SINK_ACTIONS if nm == "sink" \
                    else ONERROR_SOURCE_ACTIONS
                if action.upper() not in valid:
                    self.add(
                        "on-error-action", ERROR, f"stream {sid}",
                        f"unknown {nm} on.error action '{action}' "
                        f"(expected one of {', '.join(valid)})")

    def check_partition(self, part: A.Partition, pname: str):
        for pt in part.partition_types:
            if pt.stream_id not in self.defined:
                self.add("undefined-stream", ERROR, pname,
                         f"partition key references undefined stream "
                         f"'{pt.stream_id}'")
        # inner (#) streams live in the partition's own scope
        inner = {q.output.target for q in part.queries
                 if isinstance(q.output, A.InsertIntoStream)
                 and q.output.is_inner}
        for i, q in enumerate(part.queries):
            self.check_query(q, q.name or f"{pname}.query{i + 1}",
                             inner_scope=inner)

    def check_query(self, q: A.Query, name: str,
                    inner_scope: Optional[set]):
        for sin in _query_inputs(q):
            self.check_input_stream(sin, name, inner_scope)
        if isinstance(q.input, A.StateInputStream):
            self.check_state_machine(q.input, name)
        if isinstance(q.input, A.AnonymousInputStream) \
                and q.input.query is not None:
            iq = q.input.query
            if isinstance(iq.input, A.StateInputStream):
                self.check_state_machine(iq.input, name)
        self.check_selector(q.selector, name)

    def check_input_stream(self, sin: A.SingleInputStream, qname: str,
                           inner_scope: Optional[set]):
        sid = sin.stream_id
        if sin.is_fault:
            return  # !stream junctions materialize from @OnError wiring
        if sin.is_inner:
            if inner_scope is not None and sid not in inner_scope:
                self.add("undefined-stream", ERROR, qname,
                         f"inner stream '#{sid}' is never produced inside "
                         "this partition")
            return
        if sid not in self.defined:
            self.add("undefined-stream", ERROR, qname,
                     f"undefined stream '{sid}' (not defined, not a "
                     "table/window/trigger/aggregation, and no query "
                     "inserts into it)")
        for h in sin.handlers:
            if isinstance(h, A.WindowHandler):
                self.check_window(h, qname)
            elif isinstance(h, A.Filter):
                self.check_filter(h, qname)

    def check_window(self, h: A.WindowHandler, qname: str):
        if h.namespace is not None:
            return  # namespaced -> extension lookup, arity unknown here
        key = h.name.lower()
        spec = WINDOW_ARITY.get(key)
        if spec is None:
            return  # unknown names resolve via extensions at plan time
        lo, hi = spec
        n = len(h.parameters)
        if n < lo or (hi is not None and n > hi):
            want = f"{lo}" if hi == lo else \
                (f"{lo}+" if hi is None else f"{lo}-{hi}")
            self.add("window-arity", ERROR, qname,
                     f"window '{h.name}' takes {want} parameter(s), "
                     f"got {n}")
        elif key in _ATTR_FIRST_WINDOWS and h.parameters \
                and not isinstance(h.parameters[0], A.Variable):
            self.add("window-arity", ERROR, qname,
                     f"window '{h.name}' first parameter must be a stream "
                     "attribute (the event timestamp)")

    def check_filter(self, h: A.Filter, qname: str):
        e = h.expression
        if isinstance(e, A.Constant) and e.value is False:
            self.add("dead-filter", WARNING, qname,
                     "filter condition is constant false — the query can "
                     "never emit")

    def check_selector(self, sel: A.Selector, qname: str):
        for oa in sel.attributes:
            self._check_agg_arity(oa.expression, qname)
        if sel.having is not None:
            self._check_agg_arity(sel.having, qname)

    def _check_agg_arity(self, expr, qname: str):
        for e in _iter_exprs(expr):
            if not isinstance(e, A.AttributeFunction):
                continue
            if e.namespace is not None or e.star:
                continue
            spec = AGGREGATOR_ARITY.get(e.name.lower())
            if spec is None:
                continue
            lo, hi = spec
            n = len(e.parameters)
            if n < lo or n > hi:
                want = f"{lo}" if hi == lo else f"{lo}-{hi}"
                self.add("aggregator-arity", ERROR, qname,
                         f"aggregator '{e.name}' takes {want} "
                         f"argument(s), got {n}")

    def check_state_machine(self, sin: A.StateInputStream, qname: str):
        if sin.within_ms is not None and sin.within_ms <= 0:
            self.add("nonpositive-within", WARNING, qname,
                     f"within {sin.within_ms} ms can never be satisfied")
        for el in _iter_state_elements(sin.state):
            if isinstance(el, A.CountStateElement):
                mn, mx = el.min_count, el.max_count
                if mx != -1 and mn > mx:
                    self.add("dead-state", ERROR, qname,
                             f"count state <{mn}:{mx}> can never fire "
                             "(min > max)")
                elif mx == 0 and mn == 0:
                    self.add("dead-state", WARNING, qname,
                             "count state <0:0> matches nothing — the "
                             "state is vacuous")
            if el.within_ms is not None and el.within_ms <= 0:
                self.add("nonpositive-within", WARNING, qname,
                         f"state within {el.within_ms} ms can never be "
                         "satisfied")

    # NOTE: the conservative single-stream undefined-attribute check
    # that used to live here (PR 1 `check_attributes`) is subsumed by
    # the app-wide static type checker (analysis/typecheck.py), which
    # resolves attributes alias-scoped across joins, patterns and
    # inferred implicit-stream schemas. The parser runs both passes.


def validate_app(app: A.SiddhiApp,
                 allow_template_params: bool = False) -> list[PlanIssue]:
    """Run every plan check; returns all issues (errors + warnings)."""
    return PlanValidator(
        app, allow_template_params=allow_template_params).validate()


def check_app(app: A.SiddhiApp,
              allow_template_params: bool = False) -> None:
    """Raise CompileError on error-severity plan issues (parser hook)."""
    errors = [i for i in validate_app(
        app, allow_template_params=allow_template_params)
        if i.severity == ERROR]
    if errors:
        from ..ops.expr import CompileError
        raise CompileError("; ".join(i.render() for i in errors))


# -- tenant-template binding validation (serving/, front-door deploys) -----

def template_placeholders(app: A.SiddhiApp) -> dict:
    """``{name: AttrType}`` for every typed `${name:type}` placeholder in
    a template-mode app AST (first declaration wins; conflicts are the
    template-binding rule's to reject)."""
    out: dict = {}
    for el in app.execution_elements:
        queries = [el] if isinstance(el, A.Query) else list(el.queries)
        for q in queries:
            for _where, p, _allowed in iter_template_param_uses(q):
                if p.type is not None and p.name not in out:
                    out[p.name] = p.type
    return out


def _literal_type(value):
    """The AttrType a Python binding value carries as a literal."""
    from ..core.types import AttrType
    if isinstance(value, bool):          # before int: bool is an int
        return AttrType.BOOL
    if isinstance(value, int):
        return AttrType.INT if -2**31 <= value < 2**31 else AttrType.LONG
    if isinstance(value, float):
        return AttrType.DOUBLE
    if isinstance(value, str):
        return AttrType.STRING
    return None


def check_template_bindings(app: A.SiddhiApp, bindings: dict) -> dict:
    """Validate one tenant's bindings against a template app's typed
    placeholders — the runtime half of the ``template-binding`` rule:

    - unknown placeholder: a binding names no declared placeholder
    - unbound placeholder: a declared placeholder has no binding
    - type contradiction: the binding's literal type does not coerce
      into the declared type under the PR 3 promotion/coercion tables
      (core/types.can_coerce — the same lattice the typechecker uses)

    Raises CompileError listing every violation; returns
    ``{name: (value, AttrType)}`` ready for the pool's parameter slots.
    """
    from ..core.types import can_coerce
    from ..ops.expr import CompileError
    declared = template_placeholders(app)
    problems = []
    for k in sorted(bindings):
        if k not in declared:
            problems.append(
                f"unknown placeholder '{k}' (template declares: "
                f"{', '.join(sorted(declared)) or 'none'})")
    out = {}
    for name in sorted(declared):
        t = declared[name]
        if name not in bindings:
            problems.append(
                f"unbound placeholder '${{{name}:{t.value}}}' — no "
                "binding supplied")
            continue
        value = bindings[name]
        lt = _literal_type(value)
        if lt is None or not can_coerce(lt, t):
            got = type(value).__name__ if lt is None else lt.value.upper()
            problems.append(
                f"binding '{name}'={value!r} has literal type {got} "
                f"which does not coerce to the declared "
                f"{t.value.upper()}")
            continue
        out[name] = (value, t)
    if problems:
        raise CompileError(
            "template-binding: " + "; ".join(problems))
    return out
