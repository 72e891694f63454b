"""Query selector: projection and the current/expired output gate
(PyTorch port of the non-aggregating part of siddhi_tpu/ops/selector.py).

Reference: query/selector/QuerySelector.java:44 (processNoGroupBy —
per-event AttributeProcessor evaluation and type gating). Group-by,
aggregators, having, order-by, limit and offset are not ported yet and
raise NotImplementedError.
"""
from __future__ import annotations

from ..analysis.schema import AGGREGATOR_NAMES
from ..core.event import CURRENT, EXPIRED, Attribute, EventBatch, StreamSchema
from ..lang import ast as A
from .expr import (CompiledExpr, ProgramBuilder, Scope, compile_expression,
                   expr_eval)
from .operators import Operator


def has_aggregators(expr: A.Expression) -> bool:
    if isinstance(expr, A.AttributeFunction):
        if expr.namespace is None and expr.name.lower() in AGGREGATOR_NAMES:
            return True
        return any(has_aggregators(p) for p in expr.parameters)
    if isinstance(expr, A.MathOp) or isinstance(expr, A.Compare):
        return has_aggregators(expr.left) or has_aggregators(expr.right)
    if isinstance(expr, (A.And, A.Or)):
        return has_aggregators(expr.left) or has_aggregators(expr.right)
    if isinstance(expr, A.Not):
        return has_aggregators(expr.expr)
    if isinstance(expr, A.IsNull) and expr.expr is not None:
        return has_aggregators(expr.expr)
    return False


def selector_needs_aggregation(selector: A.Selector) -> bool:
    if selector.group_by:
        return True
    if any(has_aggregators(oa.expression) for oa in selector.attributes):
        return True
    if selector.having is not None and has_aggregators(selector.having):
        return True
    return False


def output_attribute_name(oa: A.OutputAttribute, i: int) -> str:
    if oa.rename:
        return oa.rename
    if isinstance(oa.expression, A.Variable):
        return oa.expression.attribute
    return f"_{i}"


class ProjectOp(Operator):
    """Stateless select clause: projection + current/expired gating."""

    def __init__(self, selector: A.Selector, in_schema: StreamSchema,
                 out_stream_id: str, scope: Scope, functions=None,
                 current_on: bool = True, expired_on: bool = False):
        for what, present in (("having", selector.having is not None),
                              ("order by", bool(selector.order_by)),
                              ("limit", selector.limit is not None),
                              ("offset", selector.offset is not None)):
            if present:
                raise NotImplementedError(
                    f"selector not ported yet: {what}")
        self.in_schema = in_schema
        self.current_on = current_on
        self.expired_on = expired_on
        if selector.select_all:
            self._passthrough = True
            self._schema = StreamSchema(out_stream_id, in_schema.attributes)
            self.compiled: list[CompiledExpr] = []
        else:
            self._passthrough = False
            self.compiled = [
                compile_expression(oa.expression, scope, functions)
                for oa in selector.attributes
            ]
            attrs = tuple(
                Attribute(output_attribute_name(oa, i), ce.type)
                for i, (oa, ce) in enumerate(zip(selector.attributes,
                                                 self.compiled)))
            self._schema = StreamSchema(out_stream_id, attrs)
        self._prog = None

    @property
    def passthrough(self) -> bool:
        return self._passthrough

    def lower(self, builder: ProgramBuilder) -> None:
        for ce in self.compiled:
            builder.out(ce)
        builder.gate_bits = (int(self.current_on) << CURRENT) | \
            (int(self.expired_on) << EXPIRED)

    def step(self, state, batch: EventBatch, now):
        if self._prog is None:
            b = ProgramBuilder()
            self.lower(b)
            self._prog = b.build()
        return state, project(self, self._prog, batch, None)

    @property
    def out_schema(self):
        return self._schema


def project(op: ProjectOp, prog, batch: EventBatch, emitted) -> EventBatch:
    """Run a step program that ends in ``op`` and build its output batch
    (the input columns as they are for ``select *``)."""
    cols, nulls, valid = expr_eval(prog, batch, emitted)
    if op.passthrough:
        cols, nulls = batch.cols, batch.nulls
    return EventBatch(ts=batch.ts, cols=cols, nulls=nulls, kind=batch.kind,
                      valid=valid)
