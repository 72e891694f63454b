"""Attribute type system (PyTorch port of siddhi_tpu/core/types.py).

Mirrors the reference's attribute types (reference:
modules/siddhi-query-api/.../definition/Attribute.java — STRING, INT, LONG,
FLOAT, DOUBLE, BOOL, OBJECT) but maps them to device dtypes:

- INT    -> int32   (Java int, wrapping arithmetic)
- LONG   -> int64   (Java long)
- FLOAT  -> float32
- DOUBLE -> float64
- BOOL   -> bool
- STRING -> int32 dictionary codes (host-side interning; see StringTable)
- OBJECT -> host-only (cannot cross to device; gated at plan time)

Java-style binary numeric promotion (JLS 5.6.2) is used for arithmetic and
comparisons, matching the typed executor selection in the reference's
ExpressionParser (modules/siddhi-core/.../util/parser/ExpressionParser.java:206).
"""
from __future__ import annotations

import enum
import threading

import numpy as np
import torch


class AttrType(enum.Enum):
    STRING = "string"
    INT = "int"
    LONG = "long"
    FLOAT = "float"
    DOUBLE = "double"
    BOOL = "bool"
    OBJECT = "object"

    @classmethod
    def from_name(cls, name: str) -> "AttrType":
        return cls(name.lower())


NUMERIC_TYPES = (AttrType.INT, AttrType.LONG, AttrType.FLOAT, AttrType.DOUBLE)

_NP_DTYPES = {
    AttrType.STRING: np.int32,   # dictionary code
    AttrType.INT: np.int32,
    AttrType.LONG: np.int64,
    AttrType.FLOAT: np.float32,
    AttrType.DOUBLE: np.float64,
    AttrType.BOOL: np.bool_,
}


def np_dtype(t: AttrType):
    if t is AttrType.OBJECT:
        raise TypeError("OBJECT attributes cannot be placed on device")
    return _NP_DTYPES[t]


_TORCH_DTYPES = {
    AttrType.STRING: torch.int32,
    AttrType.INT: torch.int32,
    AttrType.LONG: torch.int64,
    AttrType.FLOAT: torch.float32,
    AttrType.DOUBLE: torch.float64,
    AttrType.BOOL: torch.bool,
}


def torch_dtype(t: AttrType):
    """The tensor dtype of an attribute's device column."""
    if t is AttrType.OBJECT:
        raise TypeError("OBJECT attributes cannot be placed on device")
    return _TORCH_DTYPES[t]


# Shared promotion lattice (exported: ops/expr.py applies it at compile
# time, analysis/typecheck.py mirrors it statically — one table, not two)
PROMOTION_ORDER = {
    AttrType.INT: 0,
    AttrType.LONG: 1,
    AttrType.FLOAT: 2,
    AttrType.DOUBLE: 3,
}
_PROMOTION_ORDER = PROMOTION_ORDER  # backward-compat alias


def promote(a: AttrType, b: AttrType) -> AttrType:
    """Java binary numeric promotion: the wider of the two operand types."""
    if a not in PROMOTION_ORDER or b not in PROMOTION_ORDER:
        raise TypeError(f"cannot apply numeric promotion to {a} and {b}")
    order = max(PROMOTION_ORDER[a], PROMOTION_ORDER[b])
    for t, o in PROMOTION_ORDER.items():
        if o == order:
            return t
    raise AssertionError


def can_coerce(src: AttrType, dst: AttrType) -> bool:
    """Whether a value of `src` widens losslessly-enough into a `dst`
    column under the promotion lattice (int->long->float->double).
    Equal types always coerce; non-numeric types only to themselves."""
    if src is dst:
        return True
    if src in PROMOTION_ORDER and dst in PROMOTION_ORDER:
        return PROMOTION_ORDER[src] <= PROMOTION_ORDER[dst]
    return False


def comparable(a: AttrType, b: AttrType) -> bool:
    """Whether `a <op> b` has device compare semantics: numeric pairs
    promote; STRING/BOOL compare only against themselves (STRING travels
    as int32 dictionary codes — comparing a code against a number is
    meaningless, so STRING vs numeric is rejected, never coerced)."""
    if a in NUMERIC_TYPES and b in NUMERIC_TYPES:
        return True
    return a is b and a in (AttrType.STRING, AttrType.BOOL)


# interned marker object for uuid() sentinel codes (identity-compared)
UUID_MARKER = "\x00uuid\x00"
# per-process namespace: uuid() values are unique across processes and
# stable across repeated decodes of the same row within one process
import uuid as _uuid_mod  # noqa: E402

_UUID_SALT = _uuid_mod.uuid4()


class StringTable:
    """Global host-side string interning: string <-> int32 dictionary code.

    The reference manipulates java.lang.String values directly inside the
    per-event executor trees; on the device, strings travel as dictionary codes and
    only equality / group-by / join-key semantics are preserved on device
    (which is all the reference's hot paths use them for). Decoding happens in
    host callbacks.

    Code 0 is reserved for null.
    """

    NULL_CODE = 0

    def __init__(self):
        self._lock = threading.Lock()
        self._to_code: dict[str, int] = {}
        self._to_str: list = [None]  # code 0 -> null

    def encode(self, s) -> int:
        if s is None:
            return self.NULL_CODE
        s = str(s)
        code = self._to_code.get(s)
        if code is None:
            with self._lock:
                code = self._to_code.get(s)
                if code is None:
                    code = len(self._to_str)
                    self._to_str.append(s)
                    self._to_code[s] = code
        return code

    def decode(self, code: int, uuid_key=None):
        s = self._to_str[int(code)]
        if s == UUID_MARKER:
            # uuid() columns carry a sentinel code on device; the host
            # boundary materializes the UUID (UUIDFunctionExecutor.java
            # generates per-event UUIDs). With a uuid_key (timestamp/row/
            # column coordinates) the value is a salted deterministic
            # uuid5 so REPEATED decodes of the same emitted/stored row
            # agree across delivery paths; without one it is random.
            import uuid as _uuid
            if uuid_key is None:
                return str(_uuid.uuid4())
            return str(_uuid.uuid5(_UUID_SALT, repr(uuid_key)))
        return s

    def __len__(self):
        return len(self._to_str)


# Single process-wide table: codes are stable across apps/runtimes, which
# makes snapshots and cross-app streams trivially consistent.
GLOBAL_STRINGS = StringTable()


# ---------------------------------------------------------------------------
# SET values (createSet/unionSet/sizeOfSet): a set is a fixed-width int64
# vector [1 + SET_LANES] — lane 0 a type tag, lanes 1.. the encoded
# elements, empty lanes SET_EMPTY. Columns of AttrType.OBJECT carrying
# sets are 2D [rows, 1 + SET_LANES] on device and decode to frozensets.
# ---------------------------------------------------------------------------
SET_LANES = 32
SET_EMPTY = -(2 ** 62)
_SET_TAGS = {}
_SET_TAG_OF = {}


def set_tag_of(t: AttrType) -> int:
    order = [AttrType.INT, AttrType.LONG, AttrType.FLOAT, AttrType.DOUBLE,
             AttrType.BOOL, AttrType.STRING]
    if t not in order:
        raise ValueError(f"createSet() not supported for type {t}")
    return order.index(t) + 1


def decode_set(arr) -> frozenset:
    """Host boundary: [1 + SET_LANES] int64 -> frozenset."""
    import struct

    tag = int(arr[0])
    out = []
    for v in arr[1:]:
        v = int(v)
        if v == SET_EMPTY:
            continue
        if tag in (3, 4):        # FLOAT / DOUBLE bit patterns
            out.append(struct.unpack("<d", struct.pack("<q", v))[0])
        elif tag == 5:
            out.append(bool(v))
        elif tag == 6:
            out.append(GLOBAL_STRINGS.decode(v))
        else:
            out.append(v)
    return frozenset(out)


def flush_subnormal(x):
    """A float tensor with subnormals read as the zero of their sign: the
    reference's XLA backends flush subnormal operands and results of
    float arithmetic, compares and conversions (ints pass through)."""
    if not x.is_floating_point():
        return x
    tiny = torch.finfo(x.dtype).tiny
    return torch.where(x.abs() < tiny, torch.copysign(torch.zeros_like(x), x),
                       x)


def col_zeros(t: AttrType, cap: int, device="cpu"):
    """Zero column of device shape for one attribute: [cap] for
    primitives, [cap, 1 + SET_LANES] int64 for SET-carrying OBJECT."""
    if t is AttrType.OBJECT:
        return torch.full((cap, 1 + SET_LANES), SET_EMPTY,
                          dtype=torch.int64, device=device)
    return torch.zeros((cap,), dtype=torch_dtype(t), device=device)


def row_bytes(col) -> int:
    """The bytes of one row of a device column: its element size, or a
    set column's 1 + SET_LANES int64 lanes (264)."""
    n = 1
    for d in col.shape[1:]:
        n *= d
    return col.element_size() * n


def null_value(t: AttrType):
    """The in-band placeholder stored in the data column where null; the
    actual null signal is the per-column null mask."""
    if t is AttrType.STRING:
        return StringTable.NULL_CODE
    if t is AttrType.BOOL:
        return False
    return np_dtype(t)(0)
