"""On-demand (store) queries: ``runtime.query("from T select ...")``
(PyTorch port of siddhi_tpu/core/ondemand.py, over in-memory tables).

Reference mapping:
- util/parser/OnDemandQueryParser.java:87: parse and dispatch per kind
- query/{Find,Select,Delete,Update,UpdateOrInsert,Insert}
  OnDemandQueryRuntime

Execution: the device does the data-parallel part (the condition mask
and each expression over the table's seq-ordered view, through kernels
K8 ``table_buffer`` and K2); the host does the control-plane part
(group by, aggregates over the matching rows, order, limit, offset).
On-demand queries are interactive and rare: the reference too runs them
on the caller's thread.

Supported: select (projection, group by, sum/avg/count/min/max/
distinctCount, order by, limit, offset), delete, update, update or
insert, insert of constants, against in-memory tables; select against
named windows (their findable buffer) and incremental aggregations
(``within`` / ``per``: the duration's table materialised on the host,
core/aggregation.py). On-demand queries on @Store tables raise "not
ported yet".
"""
from __future__ import annotations

import numpy as np
import torch

from ..lang import ast as A
from ..ops.expr import (CompileError, ProgramBuilder, SingleStreamScope,
                        compile_expression, expr_eval)
from ..ops.selector import output_attribute_name
from .event import EventBatch
from .types import AttrType, GLOBAL_STRINGS

_AGGS = {"sum", "avg", "count", "min", "max", "distinctcount"}
_SEQ_PAD = 2 ** 62


def _find_agg(expr):
    """(name, argument) of an aggregator call, or None."""
    if isinstance(expr, A.AttributeFunction) and \
            expr.namespace is None and expr.name.lower() in _AGGS:
        arg = expr.parameters[0] if expr.parameters else None
        return expr.name.lower(), arg
    return None


def _has_agg(expr) -> bool:
    if _find_agg(expr):
        return True
    for f in getattr(expr, "__dataclass_fields__", {}):
        v = getattr(expr, f)
        if isinstance(v, A.Expression) and _has_agg(v):
            return True
        if isinstance(v, list) and any(
                isinstance(x, A.Expression) and _has_agg(x) for x in v):
            return True
    return False


def _batch_of_buffer(buf: dict) -> EventBatch:
    cap = buf["valid"].shape[0]
    dev = buf["valid"].device
    return EventBatch(ts=buf["ts"], cols=tuple(buf["cols"]),
                      nulls=tuple(buf["nulls"]),
                      kind=torch.zeros((cap,), dtype=torch.int32, device=dev),
                      valid=buf["valid"])


def _decode(values, nulls, typ, key_tag="od", row_ids=None):
    out = []
    for r, (v, nl) in enumerate(zip(values, nulls)):
        if nl:
            out.append(None)
        elif typ is AttrType.STRING:
            rid = int(row_ids[r]) if row_ids is not None else r
            out.append(GLOBAL_STRINGS.decode(
                int(v), uuid_key=("od", key_tag, rid)))
        elif typ is AttrType.BOOL:
            out.append(bool(v))
        elif typ in (AttrType.FLOAT, AttrType.DOUBLE):
            out.append(float(v))
        else:
            out.append(int(v))
    return out


def _eval(ce, batch: EventBatch, now):
    """One compiled expression over the view through K2 -> (values,
    nulls) tensors. ``now``: the app's clock (currentTimeMillis())."""
    b = ProgramBuilder()
    b.out(ce)
    cols, nulls, _valid = expr_eval(b.build(), batch, now=now)
    return cols[0], nulls[0]


def _seq_order(state: dict):
    key = torch.where(state["valid"], state["seq"],
                      torch.full_like(state["seq"], _SEQ_PAD))
    return torch.argsort(key, stable=True)


class OnDemandExecutor:
    """Per-app executor of store queries."""

    def __init__(self, app):
        self.app = app

    def _source(self, q: A.OnDemandQuery):
        app = self.app
        tid = q.input_id
        if tid is None and q.output is not None:
            tid = getattr(q.output, "target", None)
        t = app.tables.get(tid)
        if t is not None:
            return t, t.schema, t.buffer(t.state)
        w = app.named_windows.get(tid)
        if w is not None:
            with w._lock:
                return None, w.in_schema, w.operators[0].findable_buffer(
                    w.states[0], device=app.device)
        a = app.aggregations.get(tid)
        if a is not None:
            if q.per is None:
                raise CompileError(
                    "querying an aggregation needs `per '<duration>'`")
            per = q.per.value if isinstance(q.per, A.Constant) else None
            if per is None:
                raise CompileError("per must be a constant duration")
            start = end = None
            if q.within is not None:
                s, e = q.within
                if not isinstance(s, A.Constant) or \
                        (e is not None and not isinstance(e, A.Constant)):
                    raise CompileError(
                        "within bounds must be constant epoch-ms longs")
                start = int(s.value)
                end = int(e.value) if e is not None else None
            schema, buf = a.materialize(str(per), start, end)
            return None, schema, buf
        raise CompileError(
            f"on-demand query: '{tid}' is not a defined table, window, "
            "or aggregation")

    def execute(self, q):
        if isinstance(q, str):
            from ..lang.parser import parse_on_demand_query
            q = parse_on_demand_query(q)
        table, schema, buf = self._source(q)
        scope = SingleStreamScope(schema, aliases=(q.alias,))
        batch = _batch_of_buffer(buf)
        out = q.output
        # write outputs carry their own ON clause (`delete T on ...`)
        cond_ast = getattr(out, "on", None) if out is not None else None
        if cond_ast is None:
            cond_ast = q.on
        mask = batch.valid
        if cond_ast is not None:
            cond = compile_expression(cond_ast, scope)
            if cond.type is not AttrType.BOOL:
                raise CompileError("on-demand ON condition must be BOOL")
            b = ProgramBuilder()
            b.keep(cond)
            _c, _n, mask = expr_eval(b.build(), batch,
                                      now=self.app.current_time())
        if out is None or isinstance(out, A.ReturnStream):
            return self._select(q, schema, scope, batch, mask, buf)
        if table is None:
            raise CompileError(
                "on-demand writes target tables, not windows")
        if isinstance(out, A.DeleteStream):
            return self._delete(table, mask)
        if isinstance(out, (A.UpdateStream, A.UpdateOrInsertStream)):
            upsert = isinstance(out, A.UpdateOrInsertStream)
            return self._update(q, table, schema, scope, batch, mask,
                                upsert)
        if isinstance(out, A.InsertIntoStream):
            return self._insert(q, table, schema)
        raise CompileError(
            f"unsupported on-demand output {type(out).__name__}")

    # -- select ------------------------------------------------------------
    def _select(self, q, schema, scope, batch, mask, buf):
        sel = q.selector
        idx = np.nonzero(mask.cpu().numpy())[0]
        # a stable per-row identity: uuid() cells survive re-reads
        row_ids = buf["seq"].cpu().numpy()[idx] if "seq" in buf else None

        def eval_rows(expr, pos=0):
            ce = compile_expression(expr, scope)
            v, n = _eval(ce, batch, self.app.current_time())
            return _decode(v.cpu().numpy()[idx], n.cpu().numpy()[idx],
                           ce.type, key_tag=(q.input_id, pos, repr(expr)),
                           row_ids=row_ids)

        if sel.select_all or not sel.attributes:
            names = [a.name for a in schema.attributes]
            cols = [eval_rows(A.Variable(attribute=n), p)
                    for p, n in enumerate(names)]
            rows = [tuple(col[i] for col in cols) for i in range(len(idx))]
            return self._order_limit(q, rows, names)

        has_agg = bool(sel.group_by) or any(
            _has_agg(oa.expression) for oa in sel.attributes)
        names = [output_attribute_name(oa, i)
                 for i, oa in enumerate(sel.attributes)]
        if not has_agg:
            cols = [eval_rows(oa.expression, p)
                    for p, oa in enumerate(sel.attributes)]
            rows = [tuple(col[i] for col in cols) for i in range(len(idx))]
            return self._order_limit(q, rows, names)

        # group by and aggregates, on the host over the matching rows
        gb_cols = [eval_rows(g) for g in sel.group_by]
        n = len(idx)
        groups: dict = {}
        for i in range(n):
            k = tuple(col[i] for col in gb_cols) if gb_cols else ()
            groups.setdefault(k, []).append(i)
        plans = []
        for p, oa in enumerate(sel.attributes):
            agg = _find_agg(oa.expression)
            if agg is not None:
                name, arg = agg
                vals = eval_rows(arg, p) if arg is not None else [1] * n
                plans.append(("agg", name, vals))
            else:
                plans.append(("plain", None, eval_rows(oa.expression, p)))
        rows = []
        for _k, members in groups.items():
            row = []
            for kind, aname, vals in plans:
                if kind == "plain":
                    row.append(vals[members[0]])
                    continue
                vs = [vals[i] for i in members if vals[i] is not None]
                if aname == "count":
                    row.append(len(members))
                elif not vs:
                    row.append(None)
                elif aname == "sum":
                    row.append(sum(vs))
                elif aname == "avg":
                    row.append(sum(vs) / len(vs))
                elif aname == "min":
                    row.append(min(vs))
                elif aname == "max":
                    row.append(max(vs))
                else:   # distinctcount
                    row.append(len(set(vs)))
            rows.append(tuple(row))
        return self._order_limit(q, rows, names)

    def _order_limit(self, q, rows, names):
        sel = q.selector
        for ob in reversed(sel.order_by):
            try:
                i = names.index(ob.variable.attribute)
            except ValueError:
                raise CompileError(
                    f"order by '{ob.variable.attribute}' is not in the "
                    "selection")
            rows.sort(key=lambda r: (r[i] is None, r[i]),
                      reverse=(ob.order == "desc"))
        off = int(sel.offset.value) if sel.offset is not None else 0
        lim = int(sel.limit.value) if sel.limit is not None else None
        return rows[off:off + lim] if lim is not None else rows[off:]

    # -- writes --------------------------------------------------------------
    @staticmethod
    def _unorder(table, mask):
        """The view is in seq order: the mask back in slot order."""
        inv = torch.argsort(_seq_order(table.state), stable=True)
        return mask[inv]

    def _delete(self, table, mask):
        with table.lock:
            n = int(mask.sum())
            table.state = {**table.state,
                           "valid": table.state["valid"]
                           & ~self._unorder(table, mask)}
        return n

    def _update(self, q, table, schema, scope, batch, mask, upsert):
        sets = q.output.set_clause
        if not sets:
            raise CompileError("on-demand update needs a SET clause")
        any_match = bool(mask.any())
        if any_match or not upsert:
            with table.lock:
                st = dict(table.state)
                inv = torch.argsort(_seq_order(st), stable=True)
                phys = mask[inv]
                cols, nulls = list(st["cols"]), list(st["nulls"])
                for var, expr in sets:
                    ci = schema.index_of(var.attribute)
                    v, nl = _eval(compile_expression(expr, scope), batch,
                                  self.app.current_time())
                    cols[ci] = torch.where(phys, v[inv].to(cols[ci].dtype),
                                           cols[ci])
                    nulls[ci] = torch.where(phys, nl[inv], nulls[ci])
                st["cols"], st["nulls"] = tuple(cols), tuple(nulls)
                table.state = st
                return int(mask.sum())
        # update or insert with no match: a row of the SET constants
        row = [None] * len(schema.attributes)
        for var, expr in sets:
            if not isinstance(expr, A.Constant):
                raise CompileError(
                    "update-or-insert insert path needs constant SET "
                    "values")
            row[schema.index_of(var.attribute)] = expr.value
        self._insert_row(table, schema, row)
        return 1

    def _insert(self, q, table, schema):
        sel = q.selector
        if sel.select_all or not sel.attributes:
            raise CompileError("on-demand insert needs a value selection")
        row = []
        for oa in sel.attributes:
            if not isinstance(oa.expression, A.Constant):
                raise CompileError(
                    "on-demand insert selection must be constants")
            row.append(oa.expression.value)
        self._insert_row(table, schema, row)
        return 1

    def _insert_row(self, table, schema, row):
        from .event import batch_from_rows
        batch = batch_from_rows(schema, [tuple(row)],
                                [self.app.current_time()], 8,
                                device=self.app.device)
        with table.lock:
            table.state = table.insert(table.state, batch, batch.valid)
