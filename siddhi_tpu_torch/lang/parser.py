"""SiddhiQL recursive-descent parser: source text -> query object model.

Hand-written equivalent of the reference's generated ANTLR4 parser plus
SiddhiQLBaseVisitorImpl (modules/siddhi-query-compiler/.../internal/
SiddhiQLBaseVisitorImpl.java, 3,073 LoC). Grammar shape follows
SiddhiQL.g4 (app rule :34, query :180, join :192, patterns :200-289,
sequences :291-340, query_section :363, query_output :394-400, output_rate
:420-423, expression precedence :459-476).

Also handles ${var} substitution from environment / system properties, the
equivalent of SiddhiCompiler.updateVariables (SiddhiCompiler.java:219).
"""
from __future__ import annotations

import os
import re

from ..core.types import AttrType
from . import ast as A
from .tokens import TIME_UNITS, SiddhiParserException, Token, tokenize

_OUTPUT_BOUNDARY_KWS = {
    "select", "insert", "delete", "update", "return", "output", "group",
    "having", "order", "limit", "offset",
}


def update_variables(text: str) -> str:
    """Replace ${name} with system property / environment value
    (reference: SiddhiCompiler.updateVariables, SiddhiCompiler.java:219)."""

    def repl(m):
        name = m.group(1)
        val = os.environ.get(name)
        if val is None:
            raise SiddhiParserException(
                f"No system or environment property found for ${{{name}}}")
        return val

    return re.sub(r"\$\{(\w+)\}", repl, text)


class Parser:
    def __init__(self, text: str):
        self.text = text
        self.toks = tokenize(text)
        self.pos = 0

    # ------------------------------------------------------------------ #
    # token helpers
    # ------------------------------------------------------------------ #
    def peek(self, off: int = 0) -> Token:
        i = min(self.pos + off, len(self.toks) - 1)
        return self.toks[i]

    def at_kw(self, *kws: str, off: int = 0) -> bool:
        t = self.peek(off)
        return t.kind == "KW" and t.value in kws

    def at_op(self, *ops: str, off: int = 0) -> bool:
        t = self.peek(off)
        return t.kind == "OP" and t.value in ops

    def next(self) -> Token:
        t = self.toks[self.pos]
        if t.kind != "EOF":
            self.pos += 1
        return t

    def accept_kw(self, *kws: str):
        if self.at_kw(*kws):
            return self.next()
        return None

    def accept_op(self, *ops: str):
        if self.at_op(*ops):
            return self.next()
        return None

    def expect_kw(self, *kws: str) -> Token:
        if not self.at_kw(*kws):
            self.fail(f"expected {'/'.join(kws).upper()}")
        return self.next()

    def expect_op(self, op: str) -> Token:
        if not self.at_op(op):
            self.fail(f"expected '{op}'")
        return self.next()

    def fail(self, msg: str):
        t = self.peek()
        raise SiddhiParserException(
            f"{msg}, found {t.kind}:{t.text!r} at line {t.line}:{t.col}")

    def name(self) -> str:
        """id | keyword (grammar `name` rule)."""
        t = self.peek()
        if t.kind in ("ID", "KW"):
            self.next()
            return t.text
        self.fail("expected identifier")

    # ------------------------------------------------------------------ #
    # entry points
    # ------------------------------------------------------------------ #
    def parse_app(self) -> A.SiddhiApp:
        app = A.SiddhiApp()
        while self.at_op("@") and self._is_app_annotation():
            app.annotations.append(self.parse_app_annotation())
        # definitions & execution elements in any order (the reference's rule
        # forces definitions first, but its visitor tolerates interleave;
        # we accept any order and let the planner validate).
        while self.peek().kind != "EOF":
            if self.accept_op(";"):
                continue
            annotations = []
            while self.at_op("@"):
                if self._is_app_annotation():
                    app.annotations.append(self.parse_app_annotation())
                else:
                    annotations.append(self.parse_annotation())
            if self.peek().kind == "EOF":
                break
            if self.at_kw("define"):
                self._parse_definition(app, annotations)
            elif self.at_kw("partition"):
                app.execution_elements.append(self.parse_partition(annotations))
            elif self.at_kw("from"):
                app.execution_elements.append(self.parse_query(annotations))
            else:
                self.fail("expected definition, query or partition")
        return app

    def parse_single_query(self) -> A.Query:
        annotations = []
        while self.at_op("@"):
            annotations.append(self.parse_annotation())
        q = self.parse_query(annotations)
        self.accept_op(";")
        if self.peek().kind != "EOF":
            self.fail("unexpected trailing input")
        return q

    def parse_expression_only(self) -> A.Expression:
        e = self.parse_expression()
        if self.peek().kind != "EOF":
            self.fail("unexpected trailing input")
        return e

    def parse_on_demand_query(self) -> A.OnDemandQuery:
        q = A.OnDemandQuery()
        if self.at_kw("from"):
            self.next()
            q.input_id = self.name()
            if self.accept_kw("as"):
                q.alias = self.name()
            if self.accept_kw("on"):
                q.on = self.parse_expression()
            if self.accept_kw("within"):
                start = self.parse_expression()
                end = None
                if self.accept_op(","):
                    end = self.parse_expression()
                q.within = (start, end)
            if self.accept_kw("per"):
                q.per = self.parse_expression()
            if self.at_kw("select"):
                q.selector = self.parse_query_section()
            else:
                q.selector = A.Selector(select_all=True)
            if self.at_kw("delete", "update", "insert"):
                q.output = self._parse_store_output()
        else:
            if self.at_kw("select"):
                q.selector = self.parse_query_section()
            q.output = self._parse_store_output()
        self.accept_op(";")
        if self.peek().kind != "EOF":
            self.fail("unexpected trailing input")
        return q

    def _parse_store_output(self):
        if self.accept_kw("insert"):
            self.expect_kw("into")
            return A.InsertIntoStream(target=self.name())
        if self.accept_kw("delete"):
            target = self.name()
            self.expect_kw("on")
            return A.DeleteStream(target=target, on=self.parse_expression())
        if self.accept_kw("update"):
            if self.accept_kw("or"):
                self.expect_kw("insert")
                self.expect_kw("into")
                target = self.name()
                set_clause = self._parse_set_clause()
                self.expect_kw("on")
                return A.UpdateOrInsertStream(target=target, on=self.parse_expression(),
                                              set_clause=set_clause)
            target = self.name()
            set_clause = self._parse_set_clause()
            self.expect_kw("on")
            return A.UpdateStream(target=target, on=self.parse_expression(),
                                  set_clause=set_clause)
        self.fail("expected store query output")

    # ------------------------------------------------------------------ #
    # annotations
    # ------------------------------------------------------------------ #
    def _is_app_annotation(self) -> bool:
        # '@' app ':' name
        return (self.at_op("@") and self.at_kw("app", off=1)
                and self.at_op(":", off=2))

    def parse_app_annotation(self) -> A.Annotation:
        self.expect_op("@")
        self.expect_kw("app")
        self.expect_op(":")
        name = self.name()
        ann = A.Annotation(name=name)
        if self.accept_op("("):
            self._parse_annotation_body(ann)
        return ann

    def parse_annotation(self) -> A.Annotation:
        self.expect_op("@")
        name = self.name()
        ann = A.Annotation(name=name)
        if self.accept_op("("):
            self._parse_annotation_body(ann)
        return ann

    def _parse_annotation_body(self, ann: A.Annotation):
        if self.accept_op(")"):
            return
        while True:
            if self.at_op("@"):
                ann.nested.append(self.parse_annotation())
            else:
                key = None
                # property_name '=' property_value | property_value
                save = self.pos
                if self.peek().kind in ("ID", "KW", "STRING"):
                    parts = []
                    if self.peek().kind == "STRING":
                        parts.append(self.next().value)
                    else:
                        parts.append(self.name())
                        while self.at_op(".", "-", ":"):
                            parts.append(self.next().value)
                            parts.append(self.name())
                    if self.accept_op("="):
                        key = "".join(str(p) for p in parts)
                    else:
                        self.pos = save
                val = self._parse_property_value()
                if key is None:
                    ann.positional.append(val)
                else:
                    ann.elements[key] = val
            if self.accept_op(","):
                continue
            self.expect_op(")")
            break

    def _parse_property_value(self) -> str:
        t = self.peek()
        if t.kind == "STRING":
            self.next()
            return t.value
        if t.kind in ("INT", "LONG", "FLOAT", "DOUBLE"):
            self.next()
            return t.text
        if t.kind in ("ID", "KW"):
            # bare words (true/false/identifiers) tolerated
            return self.name()
        if t.kind == "OP" and t.value in ("-", "+"):
            self.next()
            num = self.next()
            return t.value + num.text
        self.fail("expected annotation value")

    # ------------------------------------------------------------------ #
    # definitions
    # ------------------------------------------------------------------ #
    def _parse_definition(self, app: A.SiddhiApp, annotations):
        line = self.peek().line
        self.expect_kw("define")
        if self.accept_kw("stream"):
            is_inner, is_fault, sid = self._parse_source_name()
            attrs = self._parse_attr_list()
            app.stream_definitions[sid] = A.StreamDefinition(
                stream_id=sid, attributes=attrs, annotations=annotations,
                is_inner=is_inner, is_fault=is_fault, line=line)
        elif self.accept_kw("table"):
            _, _, tid = self._parse_source_name()
            attrs = self._parse_attr_list()
            app.table_definitions[tid] = A.TableDefinition(
                table_id=tid, attributes=attrs, annotations=annotations)
        elif self.accept_kw("window"):
            _, _, wid = self._parse_source_name()
            attrs = self._parse_attr_list()
            fn = self._parse_function_operation()
            out_type = "all"
            if self.accept_kw("output"):
                out_type = self._parse_output_event_type()
            app.window_definitions[wid] = A.WindowDefinition(
                window_id=wid, attributes=attrs, window=fn,
                output_event_type=out_type, annotations=annotations)
        elif self.accept_kw("trigger"):
            tid = self.name()
            self.expect_kw("at")
            td = A.TriggerDefinition(trigger_id=tid, annotations=annotations)
            if self.accept_kw("every"):
                td.at_every_ms = self._parse_time_value()
            else:
                s = self.peek()
                if s.kind != "STRING":
                    self.fail("expected cron string or EVERY time")
                self.next()
                td.at_cron = s.value
            app.trigger_definitions[tid] = td
        elif self.accept_kw("function"):
            fid = self.name()
            self.expect_op("[")
            lang = self.name()
            self.expect_op("]")
            self.expect_kw("return")
            rtype = self._parse_attr_type()
            body = self.peek()
            if body.kind != "SCRIPT":
                self.fail("expected function body { ... }")
            self.next()
            app.function_definitions[fid] = A.FunctionDefinition(
                function_id=fid, language=lang, return_type=rtype,
                body=body.value)
        elif self.accept_kw("aggregation"):
            aid = self.name()
            self.expect_kw("from")
            stream = self._parse_standard_stream()
            selector = self.parse_query_section(group_only=True)
            self.expect_kw("aggregate")
            agg_by = None
            if self.accept_kw("by"):
                agg_by = self._parse_attribute_reference()
            self.expect_kw("every")
            durations = self._parse_aggregation_durations()
            app.aggregation_definitions[aid] = A.AggregationDefinition(
                aggregation_id=aid, input=stream, selector=selector,
                aggregate_by=agg_by, durations=durations,
                annotations=annotations)
        else:
            self.fail("expected STREAM/TABLE/WINDOW/TRIGGER/FUNCTION/AGGREGATION")

    _DURATION_ORDER = ["seconds", "minutes", "hours", "days", "weeks",
                       "months", "years"]

    def _parse_aggregation_durations(self) -> list[str]:
        first = self.expect_kw(*self._DURATION_ORDER).value
        if self.accept_op("..."):
            last = self.expect_kw(*self._DURATION_ORDER).value
            i0 = self._DURATION_ORDER.index(first)
            i1 = self._DURATION_ORDER.index(last)
            if i1 < i0:
                self.fail("invalid aggregation duration range")
            return self._DURATION_ORDER[i0:i1 + 1]
        durations = [first]
        while self.accept_op(","):
            durations.append(self.expect_kw(*self._DURATION_ORDER).value)
        return durations

    def _parse_source_name(self):
        is_inner = bool(self.accept_op("#"))
        is_fault = bool(self.accept_op("!")) if not is_inner else False
        return is_inner, is_fault, self.name()

    def _parse_attr_list(self) -> list[A.AttributeDef]:
        self.expect_op("(")
        attrs = []
        while True:
            nm = self.name()
            attrs.append(A.AttributeDef(name=nm, type=self._parse_attr_type()))
            if not self.accept_op(","):
                break
        self.expect_op(")")
        return attrs

    def _parse_attr_type(self) -> AttrType:
        t = self.expect_kw("string", "int", "long", "float", "double", "bool",
                           "object")
        return AttrType.from_name(t.value)

    def _parse_output_event_type(self) -> str:
        if self.accept_kw("all"):
            self.expect_kw("events")
            return "all"
        if self.accept_kw("expired"):
            self.expect_kw("events")
            return "expired"
        self.accept_kw("current")
        self.expect_kw("events")
        return "current"

    # ------------------------------------------------------------------ #
    # queries
    # ------------------------------------------------------------------ #
    def parse_query(self, annotations=None) -> A.Query:
        q = A.Query(annotations=annotations or [], line=self.peek().line)
        self.expect_kw("from")
        q.input = self.parse_query_input()
        if self.at_kw("select"):
            q.selector = self.parse_query_section()
        else:
            q.selector = A.Selector(select_all=True)
        if self.at_kw("output"):
            q.output_rate = self.parse_output_rate()
        q.output = self.parse_query_output()
        return q

    # ---- input classification -------------------------------------- #
    def parse_query_input(self) -> A.InputStream:
        if self.at_op("(") and self.at_kw("from", off=1):
            return self._parse_anonymous_stream()
        kind = self._classify_input()
        if kind == "pattern":
            return self._parse_state_stream(seq=False)
        if kind == "sequence":
            return self._parse_state_stream(seq=True)
        if kind == "join":
            return self._parse_join_stream()
        return self._parse_standard_stream()

    def _classify_input(self) -> str:
        """Scan the from-clause and decide standard/join/pattern/sequence.

        Pattern/sequence signals (`->`, state-ref `=` bindings, `every`,
        `not`, separator commas) count inside parenthesized GROUPS too —
        `from (every e1=A -> e2=B) within 1 sec` is a pattern
        (SiddhiQL.g4 every_pattern_source_chain nests freely) — but not
        inside `[...]` filter expressions or `name(...)` call argument
        lists, where the same tokens mean something else."""
        saw_binding = saw_every = saw_not = saw_join = saw_comma = False
        stack: list = []  # frames: 'group' | 'call' | 'expr'
        i = self.pos
        toks = self.toks
        while i < len(toks):
            t = toks[i]
            if t.kind == "EOF":
                break
            in_state = not any(f != "group" for f in stack)
            if t.kind == "OP":
                if t.value == "[":
                    stack.append("expr")
                elif t.value == "(":
                    prev = toks[i - 1] if i > self.pos else None
                    is_call = prev is not None and (
                        prev.kind == "ID"
                        or (prev.kind == "KW" and prev.value not in (
                            "from", "every", "not", "and", "or")))
                    stack.append("call" if is_call else "group")
                elif t.value in (")", "]"):
                    if not stack:
                        break
                    stack.pop()
                elif in_state:
                    if t.value == "->":
                        return "pattern"
                    if t.value == ",":
                        if not stack:
                            # a top-level comma inside a join input only
                            # occurs in `within start, end`
                            # (SiddhiQL.g4 within_time_range), which
                            # always follows the JOIN keyword
                            return "join" if saw_join else "sequence"
                        saw_comma = True  # sequence sep inside a group
                    if (t.value == "=" and i > self.pos
                            and toks[i - 1].kind in ("ID", "KW")):
                        saw_binding = True
            elif t.kind == "KW" and in_state:
                if not stack and t.value in _OUTPUT_BOUNDARY_KWS:
                    break
                if t.value == "join":
                    saw_join = True
                if t.value == "every":
                    saw_every = True
                if t.value == "not":
                    saw_not = True
            i += 1
        if saw_join:
            return "join"
        if saw_comma and (saw_binding or saw_every or saw_not):
            return "sequence"
        if saw_binding or saw_every or saw_not:
            return "pattern"
        return "standard"

    # ---- standard stream -------------------------------------------- #
    def _parse_standard_stream(self) -> A.SingleInputStream:
        is_inner, is_fault, sid = self._parse_source_name()
        s = A.SingleInputStream(stream_id=sid, is_inner=is_inner,
                                is_fault=is_fault)
        s.handlers = self._parse_stream_handlers(allow_window=True)
        return s

    def _parse_stream_handlers(self, allow_window: bool) -> list:
        handlers = []
        while True:
            if self.at_op("["):
                self.next()
                expr = self.parse_expression()
                self.expect_op("]")
                handlers.append(A.Filter(expression=expr))
            elif self.at_op("#"):
                # '#' [expr] filter | '#window.' fn | '#' fn | '#ns:fn'
                if self.at_op("[", off=1):
                    self.next()
                    self.next()
                    expr = self.parse_expression()
                    self.expect_op("]")
                    handlers.append(A.Filter(expression=expr))
                    continue
                self.next()
                if self.at_kw("window") and self.at_op(".", off=1):
                    self.next()
                    self.next()
                    fn = self._parse_function_operation()
                    handlers.append(A.WindowHandler(
                        namespace=fn.namespace, name=fn.name,
                        parameters=fn.parameters))
                    if not allow_window:
                        self.fail("window not allowed here")
                else:
                    fn = self._parse_function_operation()
                    handlers.append(A.StreamFunction(
                        namespace=fn.namespace, name=fn.name,
                        parameters=fn.parameters))
            else:
                break
        return handlers

    def _parse_function_operation(self) -> A.FunctionOperation:
        ns = None
        nm = self.name()
        if self.accept_op(":"):
            ns = nm
            nm = self.name()
        self.expect_op("(")
        params = []
        star = False
        if not self.at_op(")"):
            if self.accept_op("*"):
                star = True
            else:
                params.append(self.parse_expression())
                while self.accept_op(","):
                    params.append(self.parse_expression())
        self.expect_op(")")
        return A.FunctionOperation(namespace=ns, name=nm, parameters=params,
                                   star=star)

    # ---- join stream ------------------------------------------------- #
    def _parse_join_stream(self) -> A.JoinInputStream:
        left = self._parse_join_source()
        unidirectional = None
        if self.accept_kw("unidirectional"):
            unidirectional = "left"
        join_type = self._parse_join_type()
        right = self._parse_join_source()
        if self.accept_kw("unidirectional"):
            if unidirectional:
                self.fail("unidirectional on both sides")
            unidirectional = "right"
        on = within = per = None
        if self.accept_kw("on"):
            on = self.parse_expression()
        if self.accept_kw("within"):
            within = self.parse_expression()
            if self.accept_op(","):
                within = (within, self.parse_expression())
        if self.accept_kw("per"):
            per = self.parse_expression()
        return A.JoinInputStream(left=left, right=right, join_type=join_type,
                                 on=on, within=within, per=per,
                                 unidirectional=unidirectional)

    def _parse_join_type(self) -> str:
        if self.accept_kw("left"):
            self.expect_kw("outer")
            self.expect_kw("join")
            return "left_outer"
        if self.accept_kw("right"):
            self.expect_kw("outer")
            self.expect_kw("join")
            return "right_outer"
        if self.accept_kw("full"):
            self.expect_kw("outer")
            self.expect_kw("join")
            return "full_outer"
        if self.accept_kw("outer"):
            self.expect_kw("join")
            return "full_outer"
        self.accept_kw("inner")
        self.expect_kw("join")
        return "inner"

    def _parse_join_source(self) -> A.SingleInputStream:
        is_inner, is_fault, sid = self._parse_source_name()
        s = A.SingleInputStream(stream_id=sid, is_inner=is_inner,
                                is_fault=is_fault)
        s.handlers = self._parse_stream_handlers(allow_window=True)
        if self.accept_kw("as"):
            s.alias = self.name()
        return s

    # ---- pattern / sequence ------------------------------------------ #
    def _parse_state_stream(self, seq: bool) -> A.StateInputStream:
        elem = self._parse_state_chain(seq)
        within = None
        if self.accept_kw("within"):
            within = self._parse_time_value()
        return A.StateInputStream(
            state_type="sequence" if seq else "pattern", state=elem,
            within_ms=within)

    def _parse_state_chain(self, seq: bool) -> A.StateElement:
        sep = "," if seq else "->"
        left = self._parse_state_term(seq)
        while self.accept_op(sep):
            right = self._parse_state_term(seq)
            left = A.NextStateElement(state=left, next=right)
        return left

    def _parse_state_term(self, seq: bool) -> A.StateElement:
        if self.accept_kw("every"):
            if self.accept_op("("):
                inner = self._parse_state_chain(seq)
                self.expect_op(")")
                inner = self._apply_postfix(inner, seq)
                return A.EveryStateElement(state=inner)
            return A.EveryStateElement(state=self._parse_state_source(seq))
        if self.at_op("(") and not self._paren_is_source():
            self.next()
            inner = self._parse_state_chain(seq)
            self.expect_op(")")
            return self._apply_postfix(inner, seq)
        return self._parse_state_source(seq)

    def _paren_is_source(self) -> bool:
        # '(' could also open a grouped chain; sources never start with '('
        return False

    def _parse_state_source(self, seq: bool) -> A.StateElement:
        left = self._parse_stateful_source(seq)
        if self.at_kw("and", "or"):
            op = self.next().value
            right = self._parse_stateful_source(seq)
            return A.LogicalStateElement(left=left, op=op, right=right)
        return left

    def _parse_stateful_source(self, seq: bool) -> A.StateElement:
        if self.accept_kw("not"):
            # absent: NOT basic_source (FOR time)?
            src = self._parse_basic_source()
            waiting = 0
            if self.accept_kw("for"):
                waiting = self._parse_time_value()
            return A.AbsentStreamStateElement(stream=src, event_ref=None,
                                              waiting_time_ms=waiting)
        event_ref = None
        if (self.peek().kind in ("ID", "KW") and self.at_op("=", off=1)
                and not self.at_kw("not")):
            event_ref = self.name()
            self.expect_op("=")
        src = self._parse_basic_source()
        elem: A.StateElement = A.StreamStateElement(stream=src,
                                                    event_ref=event_ref)
        return self._apply_postfix(elem, seq)

    def _apply_postfix(self, elem: A.StateElement, seq: bool) -> A.StateElement:
        """Kleene postfix: <m:n> (patterns+sequences), * + ? (sequences)."""
        if self.at_op("<") and self.peek(1).kind == "INT" or (
                self.at_op("<") and self.at_op(":", off=1)):
            self.next()
            mn, mx = 1, -1
            if self.peek().kind == "INT":
                mn = self.next().value
                if self.accept_op(":"):
                    mx = self.next().value if self.peek().kind == "INT" else -1
                else:
                    mx = mn
            else:
                self.expect_op(":")
                mn = 0
                mx = self.next().value if self.peek().kind == "INT" else -1
            self.expect_op(">")
            return A.CountStateElement(stream=elem, min_count=mn, max_count=mx)
        if seq:
            if self.accept_op("*"):
                return A.CountStateElement(stream=elem, min_count=0, max_count=-1)
            if self.accept_op("+"):
                return A.CountStateElement(stream=elem, min_count=1, max_count=-1)
            if self.accept_op("?"):
                return A.CountStateElement(stream=elem, min_count=0, max_count=1)
        return elem

    def _parse_basic_source(self) -> A.SingleInputStream:
        is_inner, is_fault, sid = self._parse_source_name()
        s = A.SingleInputStream(stream_id=sid, is_inner=is_inner,
                                is_fault=is_fault)
        s.handlers = self._parse_stream_handlers(allow_window=False)
        return s

    # ---- anonymous stream -------------------------------------------- #
    def _parse_anonymous_stream(self) -> A.AnonymousInputStream:
        self.expect_op("(")
        self.expect_kw("from")
        q = A.Query()
        q.input = self.parse_query_input()
        if self.at_kw("select"):
            q.selector = self.parse_query_section()
        else:
            q.selector = A.Selector(select_all=True)
        if self.at_kw("output"):
            q.output_rate = self.parse_output_rate()
        self.expect_kw("return")
        out_type = "current"
        if self.at_kw("all", "expired", "current"):
            out_type = self._parse_output_event_type()
        q.output = A.ReturnStream(output_event_type=out_type)
        self.expect_op(")")
        return A.AnonymousInputStream(query=q)

    # ---- selector ---------------------------------------------------- #
    def parse_query_section(self, group_only: bool = False) -> A.Selector:
        self.expect_kw("select")
        sel = A.Selector()
        if self.accept_op("*"):
            sel.select_all = True
        else:
            while True:
                expr = self.parse_expression()
                rename = None
                if self.accept_kw("as"):
                    rename = self.name()
                sel.attributes.append(A.OutputAttribute(expression=expr,
                                                        rename=rename))
                if not self.accept_op(","):
                    break
        if self.at_kw("group"):
            self.next()
            self.expect_kw("by")
            while True:
                sel.group_by.append(self._parse_attribute_reference())
                if not self.accept_op(","):
                    break
        if group_only:
            return sel
        if self.accept_kw("having"):
            sel.having = self.parse_expression()
        if self.at_kw("order"):
            self.next()
            self.expect_kw("by")
            while True:
                v = self._parse_attribute_reference()
                order = "asc"
                if self.accept_kw("asc"):
                    order = "asc"
                elif self.accept_kw("desc"):
                    order = "desc"
                sel.order_by.append(A.OrderByAttribute(variable=v, order=order))
                if not self.accept_op(","):
                    break
        if self.accept_kw("limit"):
            sel.limit = self.parse_expression()
        if self.accept_kw("offset"):
            sel.offset = self.parse_expression()
        return sel

    # ---- output ------------------------------------------------------ #
    def parse_output_rate(self) -> A.OutputRate:
        self.expect_kw("output")
        if self.accept_kw("snapshot"):
            self.expect_kw("every")
            return A.SnapshotOutputRate(ms=self._parse_time_value())
        rtype = "all"
        if self.at_kw("all", "last", "first"):
            rtype = self.next().value
        self.expect_kw("every")
        if self.peek().kind == "INT" and self.at_kw("events", off=1):
            n = self.next().value
            self.next()
            return A.EventOutputRate(events=n, type=rtype)
        return A.TimeOutputRate(ms=self._parse_time_value(), type=rtype)

    def parse_query_output(self) -> A.OutputStream:
        if self.accept_kw("insert"):
            out_type = "current"
            if self.at_kw("all", "expired", "current"):
                out_type = self._parse_output_event_type()
            self.expect_kw("into")
            is_inner, is_fault, target = self._parse_source_name()
            return A.InsertIntoStream(target=target,
                                      output_event_type=out_type,
                                      is_inner=is_inner, is_fault=is_fault)
        if self.accept_kw("delete"):
            _, _, target = self._parse_source_name()
            out_type = "current"
            if self.accept_kw("for"):
                out_type = self._parse_output_event_type()
            self.expect_kw("on")
            return A.DeleteStream(target=target, on=self.parse_expression(),
                                  output_event_type=out_type)
        if self.accept_kw("update"):
            if self.accept_kw("or"):
                self.expect_kw("insert")
                self.expect_kw("into")
                _, _, target = self._parse_source_name()
                out_type = "current"
                if self.accept_kw("for"):
                    out_type = self._parse_output_event_type()
                set_clause = self._parse_set_clause()
                self.expect_kw("on")
                return A.UpdateOrInsertStream(
                    target=target, on=self.parse_expression(),
                    set_clause=set_clause, output_event_type=out_type)
            _, _, target = self._parse_source_name()
            out_type = "current"
            if self.accept_kw("for"):
                out_type = self._parse_output_event_type()
            set_clause = self._parse_set_clause()
            self.expect_kw("on")
            return A.UpdateStream(target=target, on=self.parse_expression(),
                                  set_clause=set_clause,
                                  output_event_type=out_type)
        if self.accept_kw("return"):
            out_type = "current"
            if self.at_kw("all", "expired", "current"):
                out_type = self._parse_output_event_type()
            return A.ReturnStream(output_event_type=out_type)
        self.fail("expected INSERT/DELETE/UPDATE/RETURN")

    def _parse_set_clause(self):
        set_clause = []
        if self.accept_kw("set"):
            while True:
                v = self._parse_attribute_reference()
                self.expect_op("=")
                set_clause.append((v, self.parse_expression()))
                if not self.accept_op(","):
                    break
        return set_clause

    # ---- partition --------------------------------------------------- #
    def parse_partition(self, annotations=None) -> A.Partition:
        line = self.peek().line
        self.expect_kw("partition")
        self.expect_kw("with")
        self.expect_op("(")
        p = A.Partition(annotations=annotations or [], line=line)
        while True:
            p.partition_types.append(self._parse_partition_with())
            if not self.accept_op(","):
                break
        self.expect_op(")")
        self.expect_kw("begin")
        while True:
            if self.accept_op(";"):
                continue
            if self.accept_kw("end"):
                break
            annos = []
            while self.at_op("@"):
                annos.append(self.parse_annotation())
            p.queries.append(self.parse_query(annos))
        return p

    def _parse_partition_with(self) -> A.PartitionType:
        save = self.pos
        # try: attribute OF stream  (value partition)
        try:
            expr = self.parse_expression()
            if self.at_kw("of") and not self.at_kw("as"):
                if isinstance(expr, A.Variable) and expr.stream_ref is None:
                    self.next()
                    return A.ValuePartitionType(stream_id=self.name(),
                                               expression=expr)
        except SiddhiParserException:
            pass
        self.pos = save
        # range partition: expr AS 'label' (OR expr AS 'label')* OF stream
        ranges = []
        while True:
            cond = self.parse_expression()
            self.expect_kw("as")
            label = self.peek()
            if label.kind != "STRING":
                self.fail("expected range label string")
            self.next()
            ranges.append((cond, label.value))
            if not self.accept_kw("or"):
                break
        self.expect_kw("of")
        return A.RangePartitionType(stream_id=self.name(), ranges=ranges)

    # ------------------------------------------------------------------ #
    # expressions (precedence per SiddhiQL.g4 math_operation :459-476)
    # ------------------------------------------------------------------ #
    def parse_expression(self) -> A.Expression:
        return self._parse_or()

    def _parse_or(self) -> A.Expression:
        left = self._parse_and()
        while self.at_kw("or"):
            self.next()
            left = A.Or(left=left, right=self._parse_and())
        return left

    def _parse_and(self) -> A.Expression:
        left = self._parse_in()
        while self.at_kw("and"):
            self.next()
            left = A.And(left=left, right=self._parse_in())
        return left

    def _parse_in(self) -> A.Expression:
        left = self._parse_equality()
        while self.at_kw("in"):
            self.next()
            left = A.InTable(expr=left, table_id=self.name())
        return left

    def _parse_equality(self) -> A.Expression:
        left = self._parse_relational()
        while self.at_op("==", "!="):
            op = self.next().value
            left = A.Compare(op=op, left=left, right=self._parse_relational())
        return left

    def _parse_relational(self) -> A.Expression:
        left = self._parse_additive()
        while self.at_op(">", "<", ">=", "<="):
            op = self.next().value
            left = A.Compare(op=op, left=left, right=self._parse_additive())
        return left

    def _parse_additive(self) -> A.Expression:
        left = self._parse_multiplicative()
        while self.at_op("+", "-"):
            op = self.next().value
            left = A.MathOp(op=op, left=left,
                            right=self._parse_multiplicative())
        return left

    def _parse_multiplicative(self) -> A.Expression:
        left = self._parse_unary()
        while self.at_op("*", "/", "%"):
            op = self.next().value
            left = A.MathOp(op=op, left=left, right=self._parse_unary())
        return left

    def _parse_unary(self) -> A.Expression:
        if self.at_kw("not"):
            self.next()
            return A.Not(expr=self._parse_unary())
        if self.at_op("-", "+"):
            sign = self.next().value
            t = self.peek()
            if t.kind in ("INT", "LONG", "FLOAT", "DOUBLE"):
                return self._parse_primary_number(sign)
            inner = self._parse_unary()
            zero = A.Constant(value=0, type=AttrType.INT)
            return A.MathOp(op=sign, left=zero, right=inner)
        return self._parse_postfix()

    def _parse_postfix(self) -> A.Expression:
        e = self._parse_primary()
        if self.at_kw("is") and self.at_kw("null", off=1):
            self.next()
            self.next()
            if isinstance(e, A.Variable) and e.attribute is None:
                return A.IsNull(stream_ref=e.stream_ref,
                                stream_index=e.index,
                                is_inner=e.is_inner, is_fault=e.is_fault)
            return A.IsNull(expr=e)
        return e

    def _parse_primary_number(self, sign: str = "") -> A.Expression:
        t = self.next()
        mult = -1 if sign == "-" else 1
        if t.kind == "INT":
            # time value? INT followed by a time unit keyword
            if self.peek().kind == "KW" and self.peek().value in (
                    "years", "months", "weeks", "days", "hours", "minutes",
                    "seconds", "milliseconds"):
                ms = self._finish_time_value(t.value)
                return A.Constant(value=mult * ms, type=AttrType.LONG,
                                  is_time=True)
            return A.Constant(value=mult * t.value, type=AttrType.INT)
        if t.kind == "LONG":
            return A.Constant(value=mult * t.value, type=AttrType.LONG)
        if t.kind == "FLOAT":
            return A.Constant(value=mult * t.value, type=AttrType.FLOAT)
        if t.kind == "DOUBLE":
            return A.Constant(value=mult * t.value, type=AttrType.DOUBLE)
        self.fail("expected number")

    # canonical unit -> millis, derived from the lexer's table
    _TIME_UNIT_MS = {canon: ms for canon, ms in TIME_UNITS.values()}

    def _finish_time_value(self, first_count: int) -> int:
        unit = self.next().value
        total = first_count * self._TIME_UNIT_MS[unit]
        while (self.peek().kind == "INT" and self.peek(1).kind == "KW"
               and self.peek(1).value in self._TIME_UNIT_MS):
            cnt = self.next().value
            unit = self.next().value
            total += cnt * self._TIME_UNIT_MS[unit]
        return total

    def _parse_time_value(self) -> int:
        t = self.peek()
        if t.kind != "INT":
            self.fail("expected time value")
        self.next()
        if not (self.peek().kind == "KW" and self.peek().value in self._TIME_UNIT_MS):
            self.fail("expected time unit")
        return self._finish_time_value(t.value)

    def _parse_primary(self) -> A.Expression:
        t = self.peek()
        if t.kind == "OP" and t.value == "(":
            self.next()
            e = self.parse_expression()
            self.expect_op(")")
            return e
        if t.kind in ("INT", "LONG", "FLOAT", "DOUBLE"):
            return self._parse_primary_number()
        if t.kind == "STRING":
            self.next()
            return A.Constant(value=t.value, type=AttrType.STRING)
        if t.kind == "KW" and t.value in ("true", "false"):
            self.next()
            return A.Constant(value=(t.value == "true"), type=AttrType.BOOL)
        if t.kind == "KW" and t.value == "null":
            self.next()
            return A.Constant(value=None, type=AttrType.OBJECT)
        if t.kind == "TPARAM":
            self.next()
            return self._template_param(t)
        # function / attribute reference / stream reference
        if t.kind in ("ID", "KW") or self.at_op("#", "!"):
            return self._parse_ref_or_function()
        self.fail("expected expression")

    # declared `${name:type}` placeholder types (tenant templates)
    _TPARAM_TYPES = {
        "int": AttrType.INT, "long": AttrType.LONG,
        "float": AttrType.FLOAT, "double": AttrType.DOUBLE,
        "bool": AttrType.BOOL, "string": AttrType.STRING,
    }

    def _template_param(self, t: Token) -> A.TemplateParam:
        body = str(t.value)
        name, _, typename = body.partition(":")
        name = name.strip()
        typename = typename.strip().lower()
        if not name.isidentifier():
            self.fail(f"bad template placeholder name '${{{body}}}'")
        if not typename:
            # untyped: a structural placeholder that survived
            # substitution — the template-binding plan rule rejects it
            return A.TemplateParam(name=name, type=None)
        at = self._TPARAM_TYPES.get(typename)
        if at is None:
            self.fail(
                f"unknown template placeholder type '{typename}' in "
                f"'${{{body}}}' (expected one of "
                f"{', '.join(sorted(self._TPARAM_TYPES))})")
        return A.TemplateParam(name=name, type=at)

    def _parse_ref_or_function(self) -> A.Expression:
        is_inner = bool(self.accept_op("#"))
        is_fault = bool(self.accept_op("!")) if not is_inner else False
        nm = self.name()
        # namespaced function  ns:fn(...)
        if self.at_op(":") and not is_inner and not is_fault:
            self.next()
            fn = self.name()
            self.expect_op("(")
            params, star = self._parse_call_args()
            return A.AttributeFunction(namespace=nm, name=fn,
                                       parameters=params, star=star)
        if self.at_op("(") and not is_inner and not is_fault:
            self.next()
            params, star = self._parse_call_args()
            return A.AttributeFunction(namespace=None, name=nm,
                                       parameters=params, star=star)
        # attribute/stream reference
        index = None
        if self.at_op("["):
            self.next()
            index = self._parse_attribute_index()
            self.expect_op("]")
        function_ref = None
        if self.at_op("#"):
            self.next()
            function_ref = self.name()
            if self.at_op("["):
                self.next()
                self._parse_attribute_index()
                self.expect_op("]")
        if self.accept_op("."):
            attr = self.name()
            return A.Variable(attribute=attr, stream_ref=nm,
                              is_inner=is_inner, is_fault=is_fault,
                              index=index, function_ref=function_ref)
        if index is not None or is_inner or is_fault or function_ref:
            # bare stream reference (only valid inside `is null`)
            return A.Variable(attribute=None, stream_ref=nm,
                              is_inner=is_inner, is_fault=is_fault,
                              index=index, function_ref=function_ref)
        return A.Variable(attribute=nm)

    def _parse_call_args(self):
        params, star = [], False
        if not self.at_op(")"):
            if self.accept_op("*"):
                star = True
            else:
                params.append(self.parse_expression())
                while self.accept_op(","):
                    params.append(self.parse_expression())
        self.expect_op(")")
        return params, star

    def _parse_attribute_index(self):
        if self.at_kw("last"):
            self.next()
            if self.accept_op("-"):
                n = self.next()
                return ("last", n.value)
            return "last"
        t = self.next()
        if t.kind != "INT":
            self.fail("expected attribute index")
        return t.value

    def _parse_attribute_reference(self) -> A.Variable:
        e = self._parse_ref_or_function()
        if not isinstance(e, A.Variable):
            self.fail("expected attribute reference")
        return e


# -------------------------------------------------------------------------- #
# public facade (= SiddhiCompiler)
# -------------------------------------------------------------------------- #


def parse(text: str, validate: bool = True,
          template: bool = False) -> A.SiddhiApp:
    """Parse a SiddhiQL app and statically validate the plan.

    Validation raises CompileError here — at compile time, with the
    query name and construct — for plans the runtime planner would
    otherwise reject later as shape errors deep inside a jitted step:
    undefined streams, window/aggregator arity, states that can never
    fire (analysis/plan_rules.py), plus everything type-shaped — schema
    inference over the dataflow graph, expression dtypes, insert-into
    schema compatibility (analysis/typecheck.py). ``validate=False``
    skips both (the planner still applies its own checks).

    ``template=True`` parses a tenant template (serving/template.py):
    typed `${name:type}` placeholders stay in the AST as TemplateParam
    nodes (per-tenant runtime parameters) instead of being rejected as
    unbound, and `${name}` env substitution is skipped — structural
    placeholders are the Template's to bind, not the environment's."""
    app = Parser(text if template else update_variables(text)).parse_app()
    if validate:
        from ..analysis.plan_rules import check_app
        from ..analysis.typecheck import check_app as check_types
        check_app(app, allow_template_params=template)
        check_types(app)
    return app


def parse_query(text: str) -> A.Query:
    return Parser(update_variables(text)).parse_single_query()


def parse_expression(text: str) -> A.Expression:
    return Parser(text).parse_expression_only()


def parse_on_demand_query(text: str) -> A.OnDemandQuery:
    return Parser(update_variables(text)).parse_on_demand_query()
