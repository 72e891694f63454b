"""Columnar event model (PyTorch port of siddhi_tpu/core/event.py).

Reference mapping:
- Event (ts + Object[] data)                  -> one row of an EventBatch
- StreamEvent type CURRENT/EXPIRED/TIMER/RESET (event/stream/StreamEvent.java:37)
                                              -> the `kind` column
- ComplexEventChunk (mutable linked list)     -> an EventBatch (fixed capacity,
                                                 validity mask)
- MetaStreamEvent (compile-time schema)       -> StreamSchema

An EventBatch is a plain dataclass of tensors on one device:
struct-of-arrays columns plus timestamp / kind / validity lanes, all of
one capacity B. Invalid rows are padding; operators treat them as
absent. Per-column null masks carry Java null semantics through
arithmetic (see ops/expr.py). Steps never write into a batch's tensors,
so two batches may share a tensor.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Sequence

import numpy as np
import torch

from .types import (AttrType, GLOBAL_STRINGS, col_zeros, decode_set,
                    np_dtype, null_value)

# Event kinds (match reference ComplexEvent.Type ordinal semantics)
CURRENT = 0
EXPIRED = 1
TIMER = 2
RESET = 3


@dataclasses.dataclass(frozen=True)
class Attribute:
    name: str
    type: AttrType


@dataclasses.dataclass(frozen=True)
class StreamSchema:
    """Compile-time stream shape (= MetaStreamEvent)."""

    stream_id: str
    attributes: tuple[Attribute, ...]

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(a.name for a in self.attributes)

    @property
    def types(self) -> tuple[AttrType, ...]:
        return tuple(a.type for a in self.attributes)

    def index_of(self, name: str) -> int:
        for i, a in enumerate(self.attributes):
            if a.name == name:
                return i
        raise KeyError(f"stream '{self.stream_id}' has no attribute '{name}'")

    def type_of(self, name: str) -> AttrType:
        return self.attributes[self.index_of(name)].type


@dataclasses.dataclass
class EventBatch:
    """A fixed-capacity micro-batch of events for one stream.

    cols[i] is the data column for attribute i; nulls[i] its null mask.
    Rows where ``valid`` is False are padding and carry no meaning.
    """

    ts: torch.Tensor
    cols: tuple
    nulls: tuple
    kind: torch.Tensor
    valid: torch.Tensor

    def __post_init__(self):
        self.cols = tuple(self.cols)
        self.nulls = tuple(self.nulls)

    @property
    def capacity(self) -> int:
        return self.ts.shape[0]

    @classmethod
    def empty(cls, schema: StreamSchema, capacity: int,
              device="cpu") -> "EventBatch":
        cols = tuple(col_zeros(t, capacity, device) for t in schema.types)
        nulls = tuple(torch.zeros((capacity,), dtype=torch.bool,
                                  device=device) for _ in schema.types)
        return cls(
            ts=torch.zeros((capacity,), dtype=torch.int64, device=device),
            cols=cols,
            nulls=nulls,
            kind=torch.zeros((capacity,), dtype=torch.int32, device=device),
            valid=torch.zeros((capacity,), dtype=torch.bool, device=device),
        )

    def mask(self, keep) -> "EventBatch":
        """Invalidate rows where ``keep`` is False (no compaction)."""
        return EventBatch(self.ts, self.cols, self.nulls, self.kind,
                          self.valid & keep)


def _from_numpy(ts, cols, nulls, kind, valid, device) -> EventBatch:
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return EventBatch(ts=t(ts), cols=tuple(t(c) for c in cols),
                      nulls=tuple(t(n) for n in nulls), kind=t(kind),
                      valid=t(valid))


def batch_from_rows(
    schema: StreamSchema,
    rows: Sequence[Sequence[Any]],
    timestamps: Sequence[int],
    capacity: int,
    kinds: Sequence[int] | None = None,
    device="cpu",
) -> EventBatch:
    """Host-side: build a padded EventBatch from Python rows.

    Strings are interned into GLOBAL_STRINGS; None becomes (null mask, in-band
    placeholder).
    """
    n = len(rows)
    assert n <= capacity, (n, capacity)
    ts = np.zeros((capacity,), dtype=np.int64)
    ts[:n] = np.asarray(timestamps, dtype=np.int64)
    kind = np.zeros((capacity,), dtype=np.int32)
    if kinds is not None:
        kind[:n] = np.asarray(kinds, dtype=np.int32)
    valid = np.zeros((capacity,), dtype=np.bool_)
    valid[:n] = True

    cols = []
    nulls = []
    for i, t in enumerate(schema.types):
        nul = np.zeros((capacity,), dtype=np.bool_)
        if t is AttrType.OBJECT:   # set rows: sent empty or null only
            col = col_zeros(t, capacity).numpy()
            for r, row in enumerate(rows):
                if row[i] is not None:
                    raise NotImplementedError(
                        "not ported yet: an OBJECT value sent as a row")
                nul[r] = True
            cols.append(col)
            nulls.append(nul)
            continue
        dt = np_dtype(t)
        col = np.full((capacity,), null_value(t), dtype=dt)
        for r, row in enumerate(rows):
            v = row[i]
            if v is None:
                nul[r] = True
            elif t is AttrType.STRING:
                col[r] = GLOBAL_STRINGS.encode(v)
            elif t is AttrType.BOOL:
                col[r] = bool(v)
            else:
                col[r] = dt(v)
        cols.append(col)
        nulls.append(nul)
    return _from_numpy(ts, cols, nulls, kind, valid, device)


def batch_from_columns(
    schema: StreamSchema,
    ts,
    cols: Sequence,
    capacity: int | None = None,
    device="cpu",
) -> EventBatch:
    """Columnar ingest without packing: build an EventBatch straight from
    numpy arrays (no per-row Python). STRING columns must already be
    dictionary codes (GLOBAL_STRINGS.encode)."""
    ts = np.asarray(ts, dtype=np.int64)
    n = ts.shape[0]
    capacity = capacity or n
    assert n <= capacity, (n, capacity)
    if len(cols) != len(schema.types):
        raise ValueError(
            f"stream '{schema.stream_id}' expects {len(schema.types)} data "
            f"columns, got {len(cols)}")
    out_ts = np.zeros((capacity,), dtype=np.int64)
    out_ts[:n] = ts
    valid = np.zeros((capacity,), dtype=np.bool_)
    valid[:n] = True
    out_cols, out_nulls = [], []
    for t, c in zip(schema.types, cols):
        dt = np_dtype(t)
        col = np.zeros((capacity,), dtype=dt)
        col[:n] = np.asarray(c, dtype=dt)
        out_cols.append(col)
        out_nulls.append(np.zeros((capacity,), dtype=np.bool_))
    return _from_numpy(out_ts, out_cols, out_nulls,
                       np.zeros((capacity,), dtype=np.int32), valid, device)


_UUID_BATCH_NONCE = itertools.count()


def rows_from_batch(schema_types: Sequence[AttrType], batch) -> list:
    """Host-side: decode an EventBatch into (timestamp, kind,
    tuple(values)) rows, in row order, skipping padding.

    The batch is copied to the host once; only its valid rows are turned
    into Python values (one ``tolist`` per column instead of a Python
    loop over every padded row)."""
    nonce = next(_UUID_BATCH_NONCE)
    valid = batch.valid.cpu().numpy()
    idx = np.flatnonzero(valid)
    if idx.size == 0:
        return []

    def host(x):
        return x.cpu().numpy()[idx]

    ts = host(batch.ts).tolist()
    kind = host(batch.kind).tolist()
    columns = []
    for i, t in enumerate(schema_types):
        vals = host(batch.cols[i])
        nul = host(batch.nulls[i])
        if t is AttrType.OBJECT:   # set rows -> frozensets
            vals = [decode_set(v) for v in vals]
        elif t is AttrType.STRING:
            vals = [GLOBAL_STRINGS.decode(v, uuid_key=(nonce, ts[k],
                                                       int(idx[k]), i))
                    for k, v in enumerate(vals.tolist())]
        elif t is AttrType.BOOL:
            vals = [bool(v) for v in vals.tolist()]
        elif t in (AttrType.FLOAT, AttrType.DOUBLE):
            vals = [float(v) for v in vals.tolist()]
        else:
            vals = [int(v) for v in vals.tolist()]
        if nul.any():
            vals = [None if nl else v for v, nl in zip(vals, nul.tolist())]
        columns.append(vals)
    values = zip(*columns) if columns else [()] * len(ts)
    return [(t, k, tuple(v)) for t, k, v in zip(ts, kind, values)]
