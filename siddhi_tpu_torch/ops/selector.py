"""Query selector: projection, the current/expired output gate, and
the chunk shaping of offset and limit (PyTorch port of
siddhi_tpu/ops/selector.py; the aggregating selector is
ops/aggregators.py).

Reference: query/selector/QuerySelector.java:44 (processNoGroupBy —
per-event AttributeProcessor evaluation and type gating; offset and
limit over a chunk). Order-by, and having, order-by, limit and offset
on a selector without aggregators, are not ported yet and raise
NotImplementedError.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..analysis.schema import AGGREGATOR_NAMES
from ..core.event import CURRENT, EXPIRED, Attribute, EventBatch, StreamSchema
from ..lang import ast as A
from .expr import (CompiledExpr, CompileError, ProgramBuilder, Scope,
                   compile_expression, expr_eval)
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


def const_int(expr, what: str) -> Optional[int]:
    if expr is None:
        return None
    if not isinstance(expr, A.Constant) or not isinstance(expr.value, int):
        raise CompileError(f"{what} must be an integer constant")
    return int(expr.value)


def compile_order_by(selector: A.Selector, schema: StreamSchema):
    """-> (device_order, host_order) as the reference splits them (any
    STRING key moves the whole ordering, offset and limit to the host).
    Checked as the reference checks it; ordering itself is not ported
    yet, so a non-empty order-by raises NotImplementedError."""
    order_by = []
    for ob in selector.order_by:
        schema.index_of(ob.variable.attribute)
        if ob.order.lower() not in ("asc", "desc"):
            raise CompileError(f"unknown order '{ob.order}'")
        order_by.append(ob)
    if order_by:
        raise NotImplementedError("selector not ported yet: order by")
    return [], []


def shape_output(out: EventBatch, offset: Optional[int],
                 limit: Optional[int], emit_order=None) -> EventBatch:
    """Offset and limit over a chunk's valid rows, after the rows are put
    in ``emit_order`` (row indices; one stable argsort, invalid rows
    last) (QuerySelector.offsetEventChunk / limitEventChunk)."""
    if emit_order is not None:
        primary = torch.where(out.valid, emit_order.to(torch.int32),
                              torch.full_like(emit_order, 2 ** 31 - 1,
                                              dtype=torch.int32))
        perm = torch.argsort(primary, stable=True)
        out = EventBatch(ts=out.ts[perm],
                         cols=tuple(c[perm] for c in out.cols),
                         nulls=tuple(n[perm] for n in out.nulls),
                         kind=out.kind[perm], valid=out.valid[perm])
    if offset is not None or limit is not None:
        rank = torch.cumsum(out.valid.to(torch.int64), 0) - 1
        keep = out.valid
        if offset is not None:
            keep = keep & (rank >= offset)
        if limit is not None:
            keep = keep & (rank < (offset or 0) + limit)
        out = out.mask(keep)
    return out


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


class OutputScope(Scope):
    """Scope over a selector's own output attributes (a table output's
    conditions and SET values read them; reference ops/selector.py
    OutputScope)."""

    def __init__(self, schema: StreamSchema):
        self.schema = schema

    def resolve(self, var: A.Variable):
        if var.index is not None:
            raise CompileError(
                f"indexed reference '{var.attribute}' is not an output "
                "attribute")
        idx = self.schema.index_of(var.attribute)
        return ("attr", idx), self.schema.types[idx]
