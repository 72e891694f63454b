"""Stream functions (PyTorch port of siddhi_tpu/ops/streamfn.py):
handlers that transform the event stream itself.

Reference mapping:
- StreamFunctionProcessor (query/processor/stream/
  AbstractStreamProcessor.java:51): a processor may append attributes to
  the stream's schema;
- LogStreamProcessor: ``#log([priority,] message)`` logs every event and
  passes it through;
- Pol2CartStreamFunctionProcessor: ``#pol2Cart(theta, rho[, z])``
  appends cartX, cartY[, cartZ].

``AppendColumnsOp`` runs one kernel K2 program whose outputs are the new
columns; the batch's own columns pass through as they are (a step never
writes into a batch's tensors). ``LogOp`` decodes the valid rows on the
host after the step and prints them, slot by slot inside a partition
block or a tenant pool. Extension stream functions (the
reference's ``make_operator``, which builds JAX operators) raise
NotImplementedError ("not ported yet").
"""
from __future__ import annotations

import numpy as np

from ..core.event import Attribute, EventBatch, StreamSchema
from ..core.types import AttrType, GLOBAL_STRINGS, np_dtype
from ..lang import ast as A
from .expr import (OP_MATH, OP_MUL, MATH_FNS, VT, CompiledExpr, CompileError,
                   ProgramBuilder, _as, compile_expression, expr_eval)
from .operators import Operator


class StreamFunctionOp(Operator):
    """A stream function's step: (state, batch, now) -> (state, batch)."""


class AppendColumnsOp(StreamFunctionOp):
    """Append computed attributes to every event (input attributes stay,
    new ones follow): one K2 program projects the new columns."""

    def __init__(self, in_schema: StreamSchema,
                 new_cols: list):  # [(name, AttrType, CompiledExpr)]
        self.in_schema = in_schema
        self._schema = StreamSchema(
            in_schema.stream_id,
            in_schema.attributes + tuple(
                Attribute(n, t) for n, t, _ in new_cols))
        b = ProgramBuilder()
        for _name, t, ce in new_cols:
            b.out(_as(ce, t))
        self.prog = b.build()

    @property
    def out_schema(self):
        return self._schema

    def step(self, state, batch: EventBatch, now):
        cols, nulls, _valid = expr_eval(self.prog, batch, now=now)
        return state, EventBatch(batch.ts, tuple(batch.cols) + tuple(cols),
                                 tuple(batch.nulls) + tuple(nulls),
                                 batch.kind, batch.valid)


def log_lines(prefix: str, types, ts, valid, cols) -> list:
    """The reference's log lines for a batch on the host: each valid row
    as ``<prefix>, StreamEvent{ timestamp=<ts>, data=[...] }``, the
    values as numpy scalars of the column's dtype (null placeholders
    included, as the reference prints them), STRING codes decoded."""
    lines = []
    for i in np.nonzero(np.asarray(valid))[0]:
        vals = []
        for t, c in zip(types, cols):
            v = np.asarray(c)[i]
            vals.append(GLOBAL_STRINGS.decode(int(v))
                        if t is AttrType.STRING else v)
        lines.append(f"{prefix}, StreamEvent{{ timestamp={ts[i]}, "
                     f"data={vals} }}")
    return lines


class LogOp(StreamFunctionOp):
    """#log(['priority',] 'message'): print every valid event of the step
    (decoded on the host after it), then pass the batch through."""

    def __init__(self, schema: StreamSchema, priority: str, message: str):
        self.schema = schema
        self.priority = priority
        self.message = message

    @property
    def out_schema(self):
        return self.schema

    def step(self, state, batch: EventBatch, now):
        """With a partition block's or a tenant pool's slot axis ([K, B])
        each slot's rows print after the slot before, as the reference's
        ``jax.debug.callback`` under ``jax.vmap`` calls its callback once
        a slot, in slot order."""
        for t in self.schema.types:
            np_dtype(t)   # an OBJECT column cannot be printed
        ts, valid = batch.ts.cpu().numpy(), batch.valid.cpu().numpy()
        cols = [c.cpu().numpy() for c in batch.cols]
        prefix = f"[{self.priority}] {self.message}"
        if valid.ndim == 1:
            slots = [(ts, valid, cols)]
        else:
            slots = [(ts[k], valid[k], [c[k] for c in cols])
                     for k in range(valid.shape[0])]
        for t_k, v_k, c_k in slots:
            for line in log_lines(prefix, self.schema.types, t_k, v_k, c_k):
                print(line)
        return state, batch


def _cart(rho: CompiledExpr, theta: CompiledExpr, fn: str) -> CompiledExpr:
    """rho * cos(theta) or rho * sin(theta), in DOUBLE."""
    d = AttrType.DOUBLE
    r, t = _as(rho, d), _as(theta, d)
    return CompiledExpr(d, r.code + t.code + (
        (OP_MATH, VT[d], MATH_FNS.index(fn)), (OP_MUL, VT[d], 0)))


def make_stream_function(h, schema: StreamSchema, scope, functions,
                         name: str) -> Operator:
    """Planner dispatch for a StreamFunction handler (reference:
    SingleInputStreamParser.java:216-243)."""
    fname = (f"{h.namespace}:{h.name}" if h.namespace else h.name).lower()
    params = h.parameters

    if fname == "log":
        consts = []
        for p in params:
            if not isinstance(p, A.Constant):
                raise CompileError(
                    f"query '{name}': log() parameters must be constant "
                    "strings (dynamic messages are not supported)")
            consts.append(str(p.value))
        priority, message = "INFO", ""
        if len(consts) == 1:
            message = consts[0]
        elif len(consts) >= 2:
            priority, message = consts[0].upper(), consts[1]
        return LogOp(schema, priority, message)

    if fname == "pol2cart":
        if len(params) not in (2, 3):
            raise CompileError("pol2Cart() takes 2-3 parameters "
                               "(theta, rho [, z])")
        ces = [compile_expression(p, scope, functions) for p in params]
        theta, rho = ces[0], ces[1]
        for ce in ces:
            if ce.type not in (AttrType.INT, AttrType.LONG, AttrType.FLOAT,
                               AttrType.DOUBLE):
                raise CompileError("pol2Cart() parameters must be numeric")
        new_cols = [("cartX", AttrType.DOUBLE, _cart(rho, theta, "cos")),
                    ("cartY", AttrType.DOUBLE, _cart(rho, theta, "sin"))]
        if len(ces) == 3:
            new_cols.append(("cartZ", AttrType.DOUBLE, ces[2]))
        return AppendColumnsOp(schema, new_cols)

    raise NotImplementedError(
        f"not ported yet: stream function '{fname}' (extension stream "
        "functions build JAX operators)")
