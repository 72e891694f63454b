"""Query selector: projection, having, the current/expired output gate,
and the chunk shaping of order-by, offset and limit (PyTorch port of
siddhi_tpu/ops/selector.py; the aggregating selector is
ops/aggregators.py).

Reference: query/selector/QuerySelector.java:44 (processNoGroupBy —
per-event AttributeProcessor evaluation, type gating, having, then the
chunk's order, offset and limit).

The projection and having are kernel K2 programs. ``shape_chunk`` is
kernel G (csrc/order_by.cu): the reference's ``shape_output`` with its
``jnp.lexsort`` (selector.py:104), a stable sort of the chunk's rows by
(valid first, the order keys, the row index), then offset and limit by
the running count of valid rows. For tensors on the CPU it runs
``shape_chunk_ref``, the plain version (chained stable sorts, last key
first); for CUDA tensors it launches the kernel. A partition block's or
a tenant pool's ``[K, B]`` batch runs ``shape_chunk_slots`` instead
(kernel G[K]: each slot shaped on its own, as the reference's
``jax.vmap`` does). An order-by with a
STRING key (dictionary codes are not lexicographic) moves the whole
ordering, with its offset and limit, to the host edge
(core/runtime.py ``_host_shape_rows``), as in the reference.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import _kernels
from ..analysis.schema import AGGREGATOR_NAMES
from ..core.event import CURRENT, EXPIRED, Attribute, EventBatch, StreamSchema
from ..core.types import AttrType, flush_subnormal
from ..lang import ast as A
from .expr import (ALL_KINDS, DTYPE_VT, CompiledExpr, CompileError,
                   ProgramBuilder, RowScope, Scope, collect_template_params,
                   compile_expression, expr_eval, tparam_env,
                   tparam_init_state)
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
    """-> (device_order, host_order), each [(column, 'asc' | 'desc')]:
    STRING keys order at the host edge (dictionary codes are not
    lexicographic; rows are decoded there anyway), so an order-by with
    a STRING key moves the whole ordering, with offset and limit, to the
    host row path. Device orderings run kernel G."""
    order_by = []
    host = False
    for ob in selector.order_by:
        idx = schema.index_of(ob.variable.attribute)
        if ob.order.lower() not in ("asc", "desc"):
            raise CompileError(f"unknown order '{ob.order}'")
        if schema.types[idx] is AttrType.STRING:
            host = True
        order_by.append((idx, ob.order.lower()))
    return ([], order_by) if host else (order_by, [])


def shape_output(out: EventBatch, offset: Optional[int],
                 limit: Optional[int], emit_order=None) -> EventBatch:
    """Offset and limit over a chunk's valid rows, after the rows are put
    in ``emit_order`` (row indices; one stable argsort, invalid rows
    last) (QuerySelector.offsetEventChunk / limitEventChunk): the
    aggregating selector's emission order (kernel K6)."""
    if emit_order is not None:
        primary = torch.where(out.valid, emit_order.to(torch.int32),
                              torch.full_like(emit_order, 2 ** 31 - 1,
                                              dtype=torch.int32))
        out = _permute(out, torch.argsort(primary, stable=True))
    if offset is not None or limit is not None:
        out = out.mask(_rank_keep(out.valid, offset, limit))
    return out


def _permute(out: EventBatch, perm) -> EventBatch:
    return EventBatch(ts=out.ts[perm], cols=tuple(c[perm] for c in out.cols),
                      nulls=tuple(n[perm] for n in out.nulls),
                      kind=out.kind[perm], valid=out.valid[perm])


def _rank_keep(valid, offset: Optional[int], limit: Optional[int]):
    """The valid rows whose rank r among the valid rows has
    offset <= r < offset + limit."""
    rank = torch.cumsum(valid.to(torch.int64), 0) - 1
    keep = valid
    if offset is not None:
        keep = keep & (rank >= offset)
    if limit is not None:
        keep = keep & (rank < (offset or 0) + limit)
    return keep


_CANON_NAN = {torch.float32: 0x7FC00000, torch.float64: 0x7FF8000000000000}
_INT_OF = {torch.float32: torch.int32, torch.float64: torch.int64}


def sort_key(values, desc: bool):
    """A key column as int64 whose order is the reference's lexsort order
    for it: BOOL as int64; ``desc`` negates in the key's own width (an
    INT or LONG minimum wraps to itself, a float's sign flips); floats
    then by jax's sort comparator: zeros and subnormals (which compare
    equal to zero) as +0.0, every NaN one value above +inf."""
    v = values
    if v.dtype == torch.bool:
        v = v.to(torch.int64)
    if desc:
        v = -v
    if not v.is_floating_point():
        return v.to(torch.int64)
    v = torch.where(flush_subnormal(v) == 0, torch.zeros_like(v), v)
    ib = _INT_OF[v.dtype]
    b = v.view(ib)
    b = torch.where(torch.isnan(v),
                    torch.full_like(b, _CANON_NAN[v.dtype]), b)
    mag = torch.iinfo(ib).max
    return torch.where(b < 0, b ^ mag, b).to(torch.int64)


def shape_chunk_ref(out: EventBatch, order_by, offset: Optional[int],
                    limit: Optional[int], emitted=None) -> EventBatch:
    """Plain version of kernel G: the reference's ``shape_output``
    without an emission order. With ``order_by`` the rows are sorted
    stably by (valid first, the keys, the row index), as ``jnp.lexsort``
    does: chained stable sorts, the last key first; then the valid rows
    of rank r are kept where offset <= r < offset + limit. ``emitted``
    (an int64 0-d tensor) is increased by the rows kept."""
    if order_by:
        perm = torch.arange(out.capacity, dtype=torch.int64,
                            device=out.ts.device)
        for idx, direction in reversed(order_by):
            k = sort_key(out.cols[idx][perm], direction == "desc")
            perm = perm[torch.sort(k, stable=True).indices]
        dead = (~out.valid[perm]).to(torch.uint8)
        perm = perm[torch.sort(dead, stable=True).indices]
        out = _permute(out, perm)
    if offset is not None or limit is not None:
        out = out.mask(_rank_keep(out.valid, offset, limit))
    if emitted is not None:
        emitted += out.valid.sum(dtype=torch.int64)
    return out


def shape_chunk(out: EventBatch, order_by, offset: Optional[int],
                limit: Optional[int], emitted=None) -> EventBatch:
    """Kernel G: order-by, offset and limit over one chunk's rows. A
    batch on the CPU takes the plain version; a CUDA batch launches
    csrc/order_by.cu (the key passes of a stable radix sort, the
    valid pass, the gather, the ranks; no host sync). A batch with a
    partition block's or a tenant pool's slot axis ([K, B]) runs kernel
    G[K], ``shape_chunk_slots``."""
    if out.ts.dim() == 2:
        return shape_chunk_slots(out, order_by, offset, limit, emitted)
    dev = out.ts.device
    if dev.type == "cpu":
        return shape_chunk_ref(out, order_by, offset, limit, emitted)
    if dev.type != "cuda":
        raise ValueError(f"shape_chunk: unsupported device {dev}")
    res, args = order_args(out, order_by, offset, limit, emitted)
    _kernels.load().order_by(args, torch.cuda.current_stream(dev).cuda_stream)
    _kernels.count_launch("order_by")
    return res



def _order_struct(out: EventBatch, order_by, offset, limit):
    """``_kernels.OrderArgs`` with the shaping's column count, keys,
    offset and limit (kernels G and G[K] alike)."""
    if len(out.cols) > _kernels.ORDER_MAX_COLS or \
            len(order_by) > _kernels.ORDER_MAX_KEYS:
        raise NotImplementedError(
            f"not ported yet: order by over more than "
            f"{_kernels.ORDER_MAX_COLS} attributes or "
            f"{_kernels.ORDER_MAX_KEYS} keys")
    a = _kernels.OrderArgs()
    a.n_cols, a.n_keys = len(out.cols), len(order_by)
    a.offset = -1 if offset is None else offset
    a.limit = -1 if limit is None else limit
    for k, (idx, direction) in enumerate(order_by):
        a.key_col[k] = idx
        a.key_type[k] = DTYPE_VT[out.cols[idx].dtype]
        a.key_desc[k] = int(direction == "desc")
    return a


def order_args(out: EventBatch, order_by, offset, limit, emitted):
    """Kernel G's arguments: the shaped batch's tensors (fresh), the
    scratch, and ``_kernels.OrderArgs``. -> (shaped batch, args)."""
    dev = out.ts.device
    B, C = out.capacity, len(out.cols)
    a = _order_struct(out, order_by, offset, limit)
    if emitted is not None and (emitted.device != dev
                                or emitted.dtype != torch.int64):
        raise ValueError("shape_chunk: emitted must be an int64 scalar "
                         f"tensor on {dev}")

    def t(n, dtype):
        return torch.empty((int(n),), dtype=dtype, device=dev)
    res = EventBatch(ts=t(B, torch.int64),
                     cols=tuple(t(B, c.dtype) for c in out.cols),
                     nulls=tuple(t(B, torch.bool) for _ in out.cols),
                     kind=t(B, torch.int32), valid=t(B, torch.bool))
    blocks = (B + 1023) // 1024
    sc = {"k1": t(B, torch.int64), "k2": t(B, torch.int64),
          "i1": t(B, torch.int32), "i2": t(B, torch.int32),
          "counts": t(256 * blocks, torch.int32),
          "rank": t(B, torch.int64), "sums": t(blocks, torch.int64)}
    a.B = B
    a.ts, a.kind, a.valid = (out.ts.data_ptr(), out.kind.data_ptr(),
                             out.valid.data_ptr())
    for k, (c, n, rc, rn) in enumerate(zip(out.cols, out.nulls, res.cols,
                                           res.nulls)):
        if c.shape != (B,) or not c.is_contiguous() or c.device != dev:
            raise ValueError("shape_chunk: every column must be a "
                             f"contiguous [{B}] tensor on {dev}")
        a.cols[k], a.nulls[k] = c.data_ptr(), n.data_ptr()
        a.col_size[k] = c.element_size()
        a.out_cols[k], a.out_nulls[k] = rc.data_ptr(), rn.data_ptr()
    a.out_ts, a.out_kind, a.out_valid = (res.ts.data_ptr(),
                                         res.kind.data_ptr(),
                                         res.valid.data_ptr())
    a.emitted = emitted.data_ptr() if emitted is not None else None
    for k, v in sc.items():
        setattr(a, k, v.data_ptr())
    a._keep = (out, sc)
    return res, a


def shape_chunk_slots_ref(out: EventBatch, order_by, offset: Optional[int],
                          limit: Optional[int], emitted=None) -> EventBatch:
    """Plain version of kernel G[K]: the reference's ``shape_output``
    under ``jax.vmap``, every slot of a ``[K, B]`` batch shaped on its
    own, all in one call: chained stable sorts along the row axis (the
    last key first, then the dead flag), one gather of every column, and
    each slot's own ranks of its valid rows through offset and limit.
    Without ``order_by`` the rows keep their places. ``emitted`` (0-d,
    or ``[K]``) is increased by the rows kept."""
    K, B = out.ts.shape
    if order_by:
        perm = torch.arange(B, dtype=torch.int64,
                            device=out.ts.device).expand(K, B)
        for idx, direction in reversed(order_by):
            k = sort_key(out.cols[idx].gather(1, perm), direction == "desc")
            perm = perm.gather(1, torch.sort(k, dim=1, stable=True).indices)
        dead = (~out.valid.gather(1, perm)).to(torch.uint8)
        perm = perm.gather(1, torch.sort(dead, dim=1, stable=True).indices)

        def take(x):
            return x.gather(1, perm.reshape(perm.shape + (1,) * (
                x.dim() - 2)).expand(perm.shape + x.shape[2:]))
        out = EventBatch(ts=take(out.ts), cols=tuple(map(take, out.cols)),
                         nulls=tuple(map(take, out.nulls)),
                         kind=take(out.kind), valid=take(out.valid))
    if offset is not None or limit is not None:
        rank = torch.cumsum(out.valid.to(torch.int64), 1) - 1
        keep = out.valid
        if offset is not None:
            keep = keep & (rank >= offset)
        if limit is not None:
            keep = keep & (rank < (offset or 0) + limit)
        out = out.mask(keep)
    if emitted is not None:   # one counter, or a pool's one a slot
        emitted += out.valid.sum(tuple(range(emitted.dim(), 2)),
                                 dtype=torch.int64)
    return out


def shape_chunk_slots(out: EventBatch, order_by, offset: Optional[int],
                      limit: Optional[int], emitted=None) -> EventBatch:
    """Kernel G[K]: order-by, offset and limit over every slot of a
    ``[K, B]`` batch (a partition block's inner chain, a tenant pool's
    chain step). A batch on the CPU takes ``shape_chunk_slots_ref``; a
    CUDA batch launches csrc/order_by.cu's slotted path, one block a
    slot, and counts it as ``order_by[K]``."""
    dev = out.ts.device
    if dev.type == "cpu":
        return shape_chunk_slots_ref(out, order_by, offset, limit, emitted)
    if dev.type != "cuda":
        raise ValueError(f"shape_chunk_slots: unsupported device {dev}")
    res, args = order_slot_args(out, order_by, offset, limit, emitted)
    _kernels.load().order_by(args, torch.cuda.current_stream(dev).cuda_stream)
    _kernels.count_launch("order_by[K]")
    return res


def order_slot_args(out: EventBatch, order_by, offset, limit, emitted):
    """Kernel G[K]'s arguments: the shaped ``[K, B]`` batch (fresh,
    contiguous), the scratch of the sort in global memory (only where a
    slot's rows do not fit the block's shared memory,
    ``_kernels.ORDER_SHARED_ROWS``) and ``_kernels.OrderArgs`` with the
    slot count and every input's slot stride (0 for a column the slots
    share, the block's ``expand``-ed input). -> (shaped batch, args)."""
    dev = out.ts.device
    K, B = out.ts.shape
    a = _order_struct(out, order_by, offset, limit)
    if emitted is not None and (
            emitted.device != dev or emitted.dtype != torch.int64
            or emitted.shape not in ((), (K,)) or not emitted.is_contiguous()):
        raise ValueError("shape_chunk_slots: emitted must be an int64 "
                         f"scalar or [{K}] tensor on {dev}")

    def rows(x):
        """x as a [K, B] view whose rows are contiguous; its slot stride."""
        if x.dim() != 2:
            raise NotImplementedError(
                "not ported yet: order by, offset or limit over a set "
                "column in a partition block or a tenant pool")
        if x.shape != (K, B) or x.device != dev:
            raise ValueError("shape_chunk_slots: every column must be a "
                             f"[{K}, {B}] tensor on {dev}")
        if B > 1 and x.stride(1) != 1:
            x = x.contiguous()
        return x, x.stride(0)

    def t(dtype):
        return torch.empty((K, B), dtype=dtype, device=dev)
    res = EventBatch(ts=t(torch.int64), cols=tuple(t(c.dtype)
                                                   for c in out.cols),
                     nulls=tuple(t(torch.bool) for _ in out.cols),
                     kind=t(torch.int32), valid=t(torch.bool))
    a.B, a.K = B, K
    keep = []
    for name in ("ts", "kind", "valid"):
        x, stride = rows(getattr(out, name))
        keep.append(x)
        setattr(a, name, x.data_ptr())
        setattr(a, name + "_stride", stride)
    for k, (c, n, rc, rn) in enumerate(zip(out.cols, out.nulls, res.cols,
                                           res.nulls)):
        (c, cs), (n, ns) = rows(c), rows(n)
        keep += [c, n]
        a.cols[k], a.nulls[k] = c.data_ptr(), n.data_ptr()
        a.col_stride[k], a.null_stride[k] = cs, ns
        a.col_size[k] = c.element_size()
        a.out_cols[k], a.out_nulls[k] = rc.data_ptr(), rn.data_ptr()
    a.out_ts, a.out_kind, a.out_valid = (res.ts.data_ptr(),
                                         res.kind.data_ptr(),
                                         res.valid.data_ptr())
    if emitted is not None:
        a.emitted = emitted.data_ptr()
        a.emitted_stride = 0 if emitted.dim() == 0 else 1
    sc = {}
    if order_by and B > _kernels.ORDER_SHARED_ROWS:
        n, blocks = K * B, (B + 1023) // 1024
        sc = {"k1": torch.empty((n,), dtype=torch.int64, device=dev),
              "k2": torch.empty((n,), dtype=torch.int64, device=dev),
              "i1": torch.empty((n,), dtype=torch.int32, device=dev),
              "i2": torch.empty((n,), dtype=torch.int32, device=dev),
              "counts": torch.empty((K * 256 * blocks,), dtype=torch.int32,
                                    device=dev)}
        for k, v in sc.items():
            setattr(a, k, v.data_ptr())
    a._keep = (out, keep, sc, emitted)   # alive until the launch
    return res, a


class ProjectOp(Operator):
    """Stateless select clause (no aggregators): projection + gating +
    having + order/offset/limit. The projection is one kernel K2
    program (with the filters before it); having a second, over the
    projected columns (and, for pattern selectors, the match batch's
    columns after them); order-by, offset and limit kernel G."""

    def __init__(self, selector: A.Selector, in_schema: StreamSchema,
                 out_stream_id: str, scope: Scope, functions=None,
                 current_on: bool = True, expired_on: bool = False,
                 having_in_scope: Optional[Scope] = None):
        self.in_schema = in_schema
        self.current_on = current_on
        self.expired_on = expired_on
        # `${name:type}` tenant-template params in select/having: the
        # values ride this operator's state (see FilterOp)
        self.tparams = collect_template_params(
            *[oa.expression for oa in selector.attributes],
            selector.having)
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
        self.having = None
        self._having_in = having_in_scope is not None
        if selector.having is not None:
            # pattern/sequence HAVING may also reference match slots
            # (e1[1].price): the reference compiles it over the output
            # attributes, then the state meta (SelectorParser)
            hscope = ProjectHavingScope(self._schema, having_in_scope)
            self.having = compile_expression(selector.having, hscope,
                                             functions)
            if self.having.type is not AttrType.BOOL:
                raise CompileError("HAVING must be BOOL")
        self.order_by, host_order = compile_order_by(selector, self._schema)
        self.limit = const_int(selector.limit, "limit")
        self.offset = const_int(selector.offset, "offset")
        if host_order:
            # the host edge applies the ordering AND offset/limit
            self.host_shape = (host_order, self.offset, self.limit)
            self.limit = self.offset = None
        else:
            self.host_shape = None
        self.sort_heavy = bool(self.order_by)
        self._prog = None
        self._having_prog = None

    def init_state(self):
        return tparam_init_state(self.tparams) if self.tparams else ()

    @property
    def passthrough(self) -> bool:
        return self._passthrough

    @property
    def shapes(self) -> bool:
        """Whether the chunk is shaped after the projection (having,
        order-by, offset or limit)."""
        return self.having is not None or self.shapes_chunk

    @property
    def shapes_chunk(self) -> bool:
        return bool(self.order_by) or self.offset is not None \
            or self.limit is not None

    def lower(self, builder: ProgramBuilder) -> None:
        for ce in self.compiled:
            builder.out(ce)
        builder.gate_bits = (int(self.current_on) << CURRENT) | \
            (int(self.expired_on) << EXPIRED)

    def having_program(self):
        """The K2 program of the having clause: a keep over every row of
        kind (the projection gated them)."""
        if self._having_prog is None:
            b = ProgramBuilder()
            b.keep(self.having)
            b.gate_bits = ALL_KINDS
            self._having_prog = b.build()
        return self._having_prog

    def step(self, state, batch: EventBatch, now):
        if self._prog is None:
            b = ProgramBuilder()
            self.lower(b)
            self._prog = b.build()
        env: dict = {}
        if self.tparams:
            tparam_env(env, self.tparams, state)
        return state, project(self, self._prog, batch, None, now, env)

    @property
    def out_schema(self):
        return self._schema


def project(op: ProjectOp, prog, batch: EventBatch, emitted,
            now=None, tparams=None) -> EventBatch:
    """Run a step program that ends in ``op`` and build its output batch
    (the input columns as they are for ``select *``), then its having
    (K2) and its order-by, offset and limit (kernel G). ``emitted`` is
    increased by the rows of the final batch. ``tparams``: the template
    parameters the programs load (name -> values)."""
    shapes = op.shapes
    cols, nulls, valid = expr_eval(prog, batch, None if shapes else emitted,
                                   now, tparams)
    if op.passthrough:
        cols, nulls = batch.cols, batch.nulls
    out = EventBatch(ts=batch.ts, cols=cols, nulls=nulls, kind=batch.kind,
                     valid=valid)
    if op.having is not None:
        hcols, hnulls = tuple(cols), tuple(nulls)
        if op._having_in:
            hcols, hnulls = hcols + tuple(batch.cols), \
                hnulls + tuple(batch.nulls)
        _, _, valid = expr_eval(
            op.having_program(),
            EventBatch(batch.ts, hcols, hnulls, batch.kind, valid),
            None if op.shapes_chunk else emitted, now, tparams)
        out = EventBatch(ts=batch.ts, cols=cols, nulls=nulls,
                         kind=batch.kind, valid=valid)
    if op.shapes_chunk:
        out = shape_chunk(out, op.order_by, op.offset, op.limit, emitted)
    return out


class OutputScope(RowScope):
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


class ProjectHavingScope(RowScope):
    """HAVING over a plain selector: the output attributes first; for a
    pattern selector then the match batch's columns, which follow the
    output columns in the batch the having program reads (reference:
    ChainScope(OutputScope, _HavingInputScope))."""

    def __init__(self, out_schema: StreamSchema,
                 in_scope: Optional[Scope] = None):
        self.out = OutputScope(out_schema)
        self.n_out = len(out_schema.types)
        self.in_scope = in_scope

    def resolve(self, var: A.Variable):
        try:
            return self.out.resolve(var)
        except (CompileError, KeyError):
            if self.in_scope is None:
                raise
        key, t = self.in_scope.resolve(var)
        if not (isinstance(key, tuple) and key[0] == "attr"):
            raise CompileError(f"having reference {key!r}")
        return ("attr", self.n_out + key[1]), t
