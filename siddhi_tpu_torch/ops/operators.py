"""Operator protocol (PyTorch port of siddhi_tpu/ops/operators.py).

An operator is a plain class whose ``step(state, batch, now)`` maps
tensors to ``(state', batch')``. The reference traces an operator chain
into one XLA program per query; here a chain of filters and a
projection is lowered into one kernel K2 program (``lower``) and runs
as one launch (core/runtime.py ``_chain_body``). ``step`` runs one
operator on its own, through the same kernel.
"""
from __future__ import annotations

from typing import Any

from ..core.event import EventBatch
from .expr import (CompiledExpr, ProgramBuilder, expr_eval, tparam_env,
                   tparam_init_state)


class Operator:
    """Stateless by default."""

    def init_state(self) -> Any:
        return ()

    def step(self, state, batch: EventBatch, now):
        raise NotImplementedError

    def lower(self, builder: ProgramBuilder) -> None:
        """Append this operator's part of a step's K2 program."""
        raise NotImplementedError(
            f"not ported yet: {type(self).__name__} in a device step")

    @property
    def out_schema(self):
        raise NotImplementedError


class FilterOp(Operator):
    """Drop events whose condition is not TRUE
    (reference: query/processor/filter/FilterProcessor.java:32).
    TIMER events pass through untouched so downstream scheduling operators
    still observe time."""

    def __init__(self, cond: CompiledExpr, schema, tparams: tuple = ()):
        self.cond = cond
        self.schema = schema
        # `${name:type}` tenant-template params the condition reads: the
        # values live in this operator's state, so a tenant pool stacks
        # them on its slot axis (serving/pool.py)
        self.tparams = tuple(tparams)
        self._prog = None

    def init_state(self):
        return tparam_init_state(self.tparams) if self.tparams else ()

    def lower(self, builder: ProgramBuilder) -> None:
        builder.keep(self.cond)
        builder.timer_pass = True

    def step(self, state, batch: EventBatch, now):
        if self._prog is None:
            b = ProgramBuilder()
            self.lower(b)
            self._prog = b.build()
        env: dict = {}
        if self.tparams:
            tparam_env(env, self.tparams, state)
        _cols, _nulls, valid = expr_eval(self._prog, batch, now=now,
                                         tparams=env)
        return state, EventBatch(batch.ts, batch.cols, batch.nulls,
                                 batch.kind, valid)

    @property
    def out_schema(self):
        return self.schema
