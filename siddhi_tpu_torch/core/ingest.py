"""Packed columnar ingest (PyTorch port of siddhi_tpu/core/ingest.py).

The host half is the reference's, copied: ``PackedEncoder`` packs one
chunk into ONE uint8 buffer (int64 header + adaptively narrowed lanes,
``layout``), so a chunk costs one host-to-device copy and the device
rebuilds validity, kinds and null masks from the header row count.

The device half is kernel K1, ``unpack_packed``: a hand-written CUDA
kernel (csrc/unpack_packed.cu) that decodes the buffer into an
EventBatch in one launch. It replaces the reference's jitted
``unpack_buffer`` (siddhi_tpu/core/ingest.py:397, with ``_bitcast_lane``
:390). The reference compiles one XLA program per encoding tuple; here
the tuple travels as a small lane-descriptor array in the kernel's
arguments, so a new encoding never rebuilds anything.
``unpack_packed_ref`` is the same function in plain PyTorch: the
wrapper runs it for a buffer that lies on the CPU, and the tests and
chip_smoke.py hold the kernel against it.

The reference's double-buffered ``IngestPipeline`` is not ported yet:
chunks are encoded and dispatched one after the other.
"""
from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch

from .. import _kernels
from .event import EventBatch, StreamSchema
from .types import AttrType, flush_subnormal, torch_dtype

_INT_FAMILY = (AttrType.INT, AttrType.STRING, AttrType.LONG)

# lane byte-width per row for each encoding code
_CODE_BYTES = {"c": 0, "aff": 0, "d8": 1, "d16": 2, "d32": 4,
               "f32": 4, "f64": 8, "raw64": 8}
# widening order within each family (sticky codes only move right)
_ORDER = ("c", "aff", "b1", "f32", "f64", "d8", "d16", "d32", "raw64")
_RANK = {c: i for i, c in enumerate(_ORDER)}


def _pad8(x: int) -> int:
    return (x + 7) & ~7


def _lane_bytes(code: str, capacity: int) -> int:
    if code == "b1":
        return capacity // 8
    return _CODE_BYTES[code] * capacity


def layout(n_cols: int, enc: tuple, capacity: int):
    """(header bytes, per-lane byte offsets, total buffer bytes).

    enc = (ts_code, col_code...). Header int64 slots:
    [0]=n, [1]=base_ts, [2]=now, [3]=ts_stride, [4+i]=col i base."""
    H = (4 + n_cols) * 8
    offs = []
    o = H
    for code in enc:
        offs.append(o)
        o += _pad8(_lane_bytes(code, capacity))
    return H, offs, o


def initial_encoding(schema: StreamSchema) -> tuple:
    """The sticky encoding a fresh PackedEncoder starts from (affine
    timestamps, every column constant)."""
    return ("aff",) + ("c",) * len(schema.types)


def _int_code(span: int) -> str:
    if span < 2 ** 8:
        return "d8"
    if span < 2 ** 16:
        return "d16"
    if span < 2 ** 32:
        return "d32"
    return "raw64"


class PackedEncoder:
    """Per-stream sticky encoding chooser: codes only widen across chunks.

    In the reference each distinct encoding tuple is a separate XLA
    compile; here the tuple is runtime data of the decode kernel, and
    stickiness only keeps the wire format stable. A caller column that
    already matches the lane dtype and C layout is bitcast-viewed
    straight into the packed buffer; coercions and per-lane copies are
    counted in ``stats``. Every chunk gets a new zeroed host buffer."""

    def __init__(self, schema: StreamSchema):
        self.schema = schema
        self._ts_code = "aff"
        self._col_codes = ["c"] * len(schema.types)
        self.stats = {"chunks": 0, "rows": 0, "coerced_arrays": 0,
                      "view_lanes": 0, "copied_lanes": 0}

    def _widen(self, cur: str, cand: str) -> str:
        return cand if _RANK[cand] > _RANK[cur] else cur

    def _conform(self, arr, want) -> np.ndarray:
        """Zero-copy fast path: an already-conformant numpy column
        (dtype + C-contiguity match) passes through untouched; anything
        else pays one counted coercion copy."""
        if isinstance(arr, np.ndarray) and arr.dtype == want and \
                arr.flags.c_contiguous:
            return arr
        self.stats["coerced_arrays"] += 1
        return np.ascontiguousarray(arr, dtype=want)

    def _choose_codes(self, ts: np.ndarray, cols: Sequence):
        """Sticky code-choosing pass over one chunk: widens ``_ts_code``
        / ``_col_codes`` and returns the conformed columns (so callers
        never conform twice). Returns (n, conformed cols, ts span code).
        The span code is returned rather than folded immediately: the
        caller folds it only once the chunk's final ts code is known."""
        n = int(ts.shape[0])
        types = self.schema.types
        if n >= 2:
            stride = int(ts[1]) - int(ts[0])
            is_aff = bool(np.all(np.diff(ts) == stride))
        else:
            is_aff = True
        tmin = int(ts.min()) if n else 0
        span_code = _int_code(int(ts.max()) - tmin) if n else "d8"
        ts_cand = "aff" if is_aff else span_code
        self._ts_code = self._widen(self._ts_code, ts_cand)
        conf = []
        for i, t in enumerate(types):
            if t in _INT_FAMILY:
                want = np.int64 if t is AttrType.LONG else np.int32
                c = self._conform(cols[i], want)
                lo = int(c.min()) if n else 0
                hi = int(c.max()) if n else 0
                cand = "c" if lo == hi else _int_code(hi - lo)
            elif t is AttrType.FLOAT:
                c = self._conform(cols[i], np.float32)
                u = c.view(np.uint32)
                cand = "c" if (n and (u == u[0]).all()) or n == 0 else "f32"
            elif t is AttrType.DOUBLE:
                c = self._conform(cols[i], np.float64)
                u = c.view(np.uint64)
                cand = "c" if (n and (u == u[0]).all()) or n == 0 else "f64"
            elif t is AttrType.BOOL:
                c = self._conform(cols[i], np.bool_)
                cand = "c" if (n == 0 or (c == c[0]).all()) else "b1"
            else:
                raise TypeError(f"cannot pack column type {t}")
            self._col_codes[i] = self._widen(self._col_codes[i], cand)
            conf.append(c)
        return n, conf, span_code

    @property
    def encoding(self) -> tuple:
        """The current sticky encoding tuple (the lane codes the next
        assembled chunk will be packed with)."""
        return (self._ts_code,) + tuple(self._col_codes)

    def widen_round(self, chunks: Sequence) -> tuple:
        """Pool-round pre-pass: sticky-widen the shared codes over EVERY
        slot's (ts, cols) chunk BEFORE any buffer is assembled, so all
        rows of one packed (slots, total) round buffer share ONE
        encoding tuple. Folds every chunk's ts span once the round's
        final ts code is known — chunk A (affine) widened before chunk B
        flips the code off 'aff' must still ship deltas wide enough for
        A's span. Returns the settled encoding tuple."""
        spans = []
        for ts, cols in chunks:
            ts = self._conform(np.asarray(ts, np.int64), np.int64)
            _n, _c, span = self._choose_codes(ts, cols)
            spans.append(span)
        if self._ts_code != "aff":
            for span in spans:
                self._ts_code = self._widen(self._ts_code, span)
        return self.encoding

    def encode_into(self, ts: np.ndarray, cols: Sequence, capacity: int,
                    now: int, out: np.ndarray) -> int:
        """Assemble one chunk into a caller-owned pre-zeroed buffer (one
        row of a pool round's (slots, total) buffer) under the CURRENT
        sticky codes — the caller ran ``widen_round`` over the whole
        round first, so this never widens. Returns n."""
        assert capacity % 8 == 0, capacity
        ts = self._conform(ts, np.int64)
        return self._assemble(ts, cols, capacity, now, out)

    def encode(self, ts: np.ndarray, cols: Sequence, capacity: int,
               now: int):
        """-> (buf np.uint8[total], enc tuple, n)."""
        assert capacity % 8 == 0, capacity
        ts = self._conform(ts, np.int64)
        n, conf, span_code = self._choose_codes(ts, cols)
        if self._ts_code != "aff":
            # once on a delta code, the width must cover THIS chunk's span
            # even when the chunk itself is affine (offsets would wrap)
            self._ts_code = self._widen(self._ts_code, span_code)
        enc = self.encoding
        _H, _offs, total = layout(len(self.schema.types), enc, capacity)
        buf = np.zeros((total,), np.uint8)
        self._assemble(ts, conf, capacity, now, buf)
        return buf, enc, n

    def _assemble(self, ts: np.ndarray, cols: Sequence, capacity: int,
                  now: int, buf: np.ndarray) -> int:
        """Write header + lanes for one chunk under the CURRENT sticky
        codes (already wide enough for this chunk's spans). ``cols`` may
        be raw caller arrays; they are conformed here if needed."""
        n = int(ts.shape[0])
        types = self.schema.types
        self.stats["chunks"] += 1
        self.stats["rows"] += n

        ts_code = self._ts_code
        if n >= 2:
            stride = int(ts[1]) - int(ts[0])
        else:
            stride = 0
        tmin = int(ts.min()) if n else 0
        base_ts = (int(ts[0]) if n else 0) if ts_code == "aff" else tmin

        ncols = []
        bases = []
        for i, t in enumerate(types):
            code = self._col_codes[i]
            if t in _INT_FAMILY:
                want = np.int64 if t is AttrType.LONG else np.int32
                c = self._conform(cols[i], want)
                lo = int(c.min()) if n else 0
                base = lo   # constant value when code == "c", else delta
            elif t is AttrType.FLOAT:
                c = self._conform(cols[i], np.float32)
                base = int(np.int64(np.float64(c[0]).view(np.int64))) \
                    if (code == "c" and n) else 0
            elif t is AttrType.DOUBLE:
                c = self._conform(cols[i], np.float64)
                base = int(c[:1].view(np.int64)[0]) if (code == "c" and n) \
                    else 0
            else:  # BOOL
                c = self._conform(cols[i], np.bool_)
                base = int(c[0]) if (code == "c" and n) else 0
            ncols.append((code, c))
            bases.append(base)

        enc = (ts_code,) + tuple(code for code, _ in ncols)
        H, offs, total = layout(len(types), enc, capacity)
        assert buf.nbytes == total, (buf.nbytes, total)
        hdr = buf[:H].view(np.int64)
        hdr[0] = n
        hdr[1] = base_ts
        hdr[2] = now
        hdr[3] = stride
        for i, b in enumerate(bases):
            hdr[4 + i] = b

        stats = self.stats

        def put(o: int, arr: np.ndarray, lane: int, view: bool):
            """Write one lane; ``view`` marks a direct bitcast view of
            the (conformed) caller array — no intermediate temp."""
            raw = arr.view(np.uint8)
            buf[o:o + raw.nbytes] = raw
            stats["view_lanes" if view else "copied_lanes"] += 1

        # ts lane
        ts_lane = _pad8(_lane_bytes(ts_code, capacity))
        if ts_code == "raw64":
            put(offs[0], ts, ts_lane, view=True)
        elif ts_code != "aff":
            dt = {"d8": np.uint8, "d16": np.uint16,
                  "d32": np.uint32}[ts_code]
            put(offs[0], (ts - base_ts).astype(dt), ts_lane, view=False)

        for i, ((code, c), base) in enumerate(zip(ncols, bases)):
            o = offs[1 + i]
            if code == "c":
                continue
            lane = _pad8(_lane_bytes(code, capacity))
            if code == "b1":
                bits = np.zeros((capacity,), np.bool_)
                bits[:n] = c
                put(o, np.packbits(bits, bitorder="little"), lane,
                    view=False)
            elif code in ("f32", "f64"):
                put(o, c, lane, view=True)
            elif code == "raw64":
                if c.dtype == np.int64:
                    put(o, c, lane, view=True)
                else:
                    put(o, c.astype(np.int64), lane, view=False)
            else:  # d8/d16/d32 deltas
                dt = {"d8": np.uint8, "d16": np.uint16,
                      "d32": np.uint32}[code]
                if _CODE_BYTES[code] < c.dtype.itemsize:
                    # the span fits the column's native dtype (e.g. d16
                    # from int32): subtract without the int64 temp
                    put(o, (c - c.dtype.type(base)).astype(dt), lane,
                        view=False)
                else:
                    put(o, (c.astype(np.int64) - base).astype(dt), lane,
                        view=False)
        return n


# -- kernel K1: packed buffer -> EventBatch ----------------------------------

# lane codes and output types as the CUDA kernel numbers them
# (csrc/siddhi_kernels.h LaneCode / OutType)
LANE_CODES = {"c": 0, "aff": 1, "d8": 2, "d16": 3, "d32": 4, "f32": 5,
              "f64": 6, "raw64": 7, "b1": 8}
_OUT_TYPES = {AttrType.INT: 0, AttrType.STRING: 0, AttrType.LONG: 1,
              AttrType.FLOAT: 2, AttrType.DOUBLE: 3, AttrType.BOOL: 4}


@functools.lru_cache(maxsize=256)
def lane_descriptors(types: tuple, enc: tuple, capacity: int) -> tuple:
    """((code, output type, byte offset), ...) for the kernel: lane 0 is
    the timestamp lane, lane 1+i column i."""
    _H, offs, _total = layout(len(types), enc, capacity)
    rows = [(LANE_CODES[enc[0]], _OUT_TYPES[AttrType.LONG], offs[0])]
    for i, t in enumerate(types):
        rows.append((LANE_CODES[enc[1 + i]], _OUT_TYPES[t], offs[1 + i]))
    return tuple(rows)


def _lane(buf, offset: int, capacity: int, width: int, dtype):
    """Bitcast view of one lane (the reference's _bitcast_lane)."""
    return buf[offset:offset + capacity * width].view(dtype)


def _delta(buf, offset: int, capacity: int, code: str):
    """Unsigned d8/d16/d32 deltas widened to int64 (torch has no
    unsigned view for every width, so mask the signed one)."""
    w = {"d8": 1, "d16": 2, "d32": 4}[code]
    if w == 1:
        return buf[offset:offset + capacity].to(torch.int64)
    signed = _lane(buf, offset, capacity, w,
                   torch.int16 if w == 2 else torch.int32)
    return signed.to(torch.int64) & ((1 << (8 * w)) - 1)


def narrow_f64(d):
    """float64 -> float32 as the reference's (x86) conversion: subnormals
    flushed in and out, a NaN keeps its sign and payload top, quiet."""
    u = d.view(torch.int64)
    nan = (((u >> 63) & 1) << 31 | 0x7FC00000 | ((u >> 29) & 0x7FFFFF))
    nan = nan.to(torch.int32).view(torch.float32)
    f = flush_subnormal(flush_subnormal(d).to(torch.float32))
    return torch.where(torch.isnan(d), nan, f)


def unpack_packed_ref(types: tuple, enc: tuple, capacity: int, buf):
    """Plain PyTorch version of kernel K1: (EventBatch, now).

    Rows >= n are padding and get ts = base_ts; nulls are all false (the
    packed path carries no nulls); one null lane is shared by every
    column, as the kernel writes it."""
    C = len(types)
    H, offs, _total = layout(C, enc, capacity)
    hdr = buf[:H].view(torch.int64)
    n, base_ts, now, stride = hdr[0], hdr[1], hdr[2], hdr[3]
    rows = torch.arange(capacity, dtype=torch.int64, device=buf.device)
    valid = rows < n

    ts_code = enc[0]
    if ts_code == "aff":
        ts = base_ts + stride * rows
    elif ts_code == "raw64":
        ts = _lane(buf, offs[0], capacity, 8, torch.int64)
    else:
        ts = base_ts + _delta(buf, offs[0], capacity, ts_code)
    ts = torch.where(valid, ts, base_ts)

    cols = []
    for i, t in enumerate(types):
        code = enc[1 + i]
        o = offs[1 + i]
        base = hdr[4 + i]
        if t in _INT_FAMILY:
            if code == "c":
                col = base.expand(capacity)
            elif code == "raw64":
                col = _lane(buf, o, capacity, 8, torch.int64)
            else:
                col = base + _delta(buf, o, capacity, code)
            col = col.to(torch_dtype(t))
        elif t is AttrType.FLOAT:
            if code == "c":
                col = narrow_f64(base.view(torch.float64)).expand(capacity)
            else:
                col = _lane(buf, o, capacity, 4, torch.float32)
        elif t is AttrType.DOUBLE:
            if code == "c":
                col = base.view(torch.float64).expand(capacity)
            else:
                col = _lane(buf, o, capacity, 8, torch.float64)
        else:  # BOOL
            if code == "c":
                col = (base != 0).expand(capacity)
            else:
                bytes_ = buf[o:o + capacity // 8].to(torch.int32)
                idx = torch.arange(capacity, device=buf.device)
                col = ((bytes_[idx >> 3] >> (idx & 7)) & 1).to(torch.bool)
        cols.append(col.contiguous())

    nulls = torch.zeros((capacity,), dtype=torch.bool, device=buf.device)
    batch = EventBatch(
        ts=ts,
        cols=tuple(cols),
        nulls=(nulls,) * C,
        kind=torch.zeros((capacity,), dtype=torch.int32, device=buf.device),
        valid=valid,
    )
    return batch, now


def unpack_params(types: tuple, enc: tuple, capacity: int, buf,
                  out: EventBatch):
    """K1's kernel arguments: decode ``buf`` into ``out``'s tensors. A
    tenant pool's (slots, total) round buffer decodes into [slots,
    capacity] tensors: ``n_part`` slots, the strides in ``moves``
    (ops/slots.py part_moves)."""
    from ..ops.slots import part_moves
    p = _kernels.UnpackParams()
    p.buf, p.nulls = buf.data_ptr(), out.nulls[0].data_ptr()
    p.kind, p.valid = out.kind.data_ptr(), out.valid.data_ptr()
    p.capacity = capacity
    desc = lane_descriptors(types, enc, capacity)
    p.n_lanes = len(desc)
    for lane, (code, out_type, offset), col in zip(p.lanes, desc,
                                                   (out.ts,) + out.cols):
        lane.code, lane.out_type, lane.offset = code, out_type, offset
        lane.out = col.data_ptr()
    p.n_part = buf.shape[0] if buf.dim() == 2 else 1
    part_moves(p, (buf, out), buf.device)
    return p


def unpack_packed(types: tuple, enc: tuple, capacity: int, buf):
    """Kernel K1: decode one packed chunk into (EventBatch, now).

    A buffer on the CPU takes the plain version; a CUDA buffer launches
    the kernel (one thread per row, every lane in one launch).

    A tenant pool's round is a (slots, total) buffer, one chunk a slot,
    all under one encoding (the reference's vmap of unpack_buffer,
    serving/pool.py): it decodes into a [slots, capacity] batch, the
    plain version once per slot, the kernel once with a row of blocks a
    slot (``unpack_packed[K]``). Every slot's header carries the same
    round clock; ``now`` is slot 0's."""
    slotted = buf.dim() == 2
    if buf.device.type == "cpu":
        if slotted:
            from ..ops.slots import per_slot
            batch, now = per_slot(
                lambda b: unpack_packed_ref(types, enc, capacity, b),
                buf.shape[0], buf)
            return batch, now[0]
        return unpack_packed_ref(types, enc, capacity, buf)
    _H, _offs, total = layout(len(types), enc, capacity)
    if buf.device.type != "cuda":
        raise ValueError(f"unpack_packed: unsupported device {buf.device}")
    if buf.dtype != torch.uint8 or buf.dim() not in (1, 2) or \
            not buf.is_contiguous() or buf.shape[-1] != total:
        raise ValueError(
            f"unpack_packed: expected a contiguous uint8[{total}] buffer, "
            f"or one a slot, got {buf.dtype}{list(buf.shape)}")
    if capacity % 8 or len(types) + 1 > _kernels.MAX_LANES:
        raise ValueError(
            f"unpack_packed: capacity {capacity} must be a multiple of 8 "
            f"and the stream at most {_kernels.MAX_LANES - 1} columns "
            "wide")
    dev = buf.device
    shape = (buf.shape[0], capacity) if slotted else (capacity,)
    ts = torch.empty(shape, dtype=torch.int64, device=dev)
    cols = [torch.empty(shape, dtype=torch_dtype(t), device=dev)
            for t in types]
    nulls = torch.empty(shape, dtype=torch.bool, device=dev)
    kind = torch.empty(shape, dtype=torch.int32, device=dev)
    valid = torch.empty(shape, dtype=torch.bool, device=dev)
    batch = EventBatch(ts=ts, cols=tuple(cols), nulls=(nulls,) * len(types),
                       kind=kind, valid=valid)
    _kernels.load().unpack_packed(
        unpack_params(types, enc, capacity, buf, batch),
        torch.cuda.current_stream(dev).cuda_stream)
    _kernels.count_launch("unpack_packed[K]" if slotted else "unpack_packed")
    row = buf[0] if slotted else buf
    return batch, row[16:24].view(torch.int64)[0]


class PackedChunk:
    """One device-resident packed chunk, shared by every subscriber of a
    junction (transferred once)."""

    __slots__ = ("buf", "enc", "capacity", "n", "last_ts", "ts_min")

    def __init__(self, buf, enc: tuple, capacity: int, n: int,
                 last_ts: int, ts_min=None):
        self.buf = buf              # ONE uint8 tensor on the app's device
        self.enc = enc              # encoding tuple (kernel lane data)
        self.capacity = capacity
        self.n = n
        self.last_ts = last_ts
        self.ts_min = ts_min        # host-known earliest ts (timer bounds)

    @classmethod
    def build(cls, encoder: PackedEncoder, ts, cols, capacity: int,
              now: int, device="cpu"):
        buf, enc, n = encoder.encode(ts, cols, capacity, now)
        dev = torch.from_numpy(buf).to(device)
        return cls(dev, enc, capacity, n, int(ts[-1]),
                   ts_min=int(ts.min()) if len(ts) else None)
