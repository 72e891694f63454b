"""Expression compiler (PyTorch port of siddhi_tpu/ops/expr.py).

The reference compiles each expression to a jnp closure over whole
columns, and a query's closures trace into one XLA program. Here each
expression compiles to a flat, typed postfix program, and the programs
of one filter+project query step are assembled into ONE ``ExprProgram``
that kernel K2 (``expr_eval``, csrc/expr_eval.cu) runs for every row in
one launch: it writes the keep mask and every projected column and its
null mask. ``expr_eval_ref`` evaluates the same program with plain
tensor ops; the wrapper runs it for tensors on the CPU, and the tests
and chip_smoke.py hold the kernel against it.

Java/Siddhi semantics preserved exactly (the reference's, kept by both
the kernel and the plain version):
- binary numeric promotion (int<long<float<double), fixed at plan time
  by promote() and lowered to explicit OP_CAST widenings
- wrapping int arithmetic; math on null -> null; divide/modulo by zero
  -> null (all numeric types); integer division/remainder truncate
  toward zero (Java `/` `%`), MIN / -1 == MIN and MIN % -1 == 0
- compare with null operand -> FALSE, never null
- and/or treat null as false; not(null) -> TRUE
- float results bit-equal to the reference's compiled code on the CPU,
  which is not plain IEEE: subnormals flushed to zero (operands and
  results of + - * /, compare operands, the FLOAT -> DOUBLE widening;
  fmod keeps them), NaN bits as x86 makes them, and the reference
  compiler's rewrites of literal operands (x / c as x * (1/c); x * 1,
  x + 0, x - 0 as x; x * -1 as a sign flip; % by +-2^k) applied here
  at plan time
- constant subexpressions fold at plan time in plain IEEE, at any depth
  (the reference folds them in numpy or in XLA's constant folder, both
  unflushed), and the zero test of a constant divisor runs there too;
  only code that runs per row flushes (a subnormal constant divisor of
  % therefore gives NaN, not null)

Ported nodes: Constant (null literal included), Variable, MathOp,
Compare, And, Or, Not, IsNull(expr) and the built-in function calls
(_compile_function: new ops of the same interpreter; the math-library
functions are held to 2 ulp of the reference's XLA code, everything
else bit for bit). Registered and script functions, whose bodies are
user Python over jnp arrays, and tenant template parameters raise
NotImplementedError ("not ported yet").
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch

from .. import _kernels
from ..core.types import (AttrType, GLOBAL_STRINGS, NUMERIC_TYPES,
                          PROMOTION_ORDER, SET_EMPTY, SET_LANES, UUID_MARKER,
                          comparable, flush_subnormal, np_dtype, promote,
                          set_tag_of, torch_dtype)
from ..lang import ast as A


class CompileError(Exception):
    pass


# value types and opcodes, numbered as csrc/siddhi_kernels.h numbers them
VT = {AttrType.INT: 0, AttrType.LONG: 1, AttrType.FLOAT: 2,
      AttrType.DOUBLE: 3, AttrType.BOOL: 4, AttrType.STRING: 5}
VT_TYPE = {v: k for k, v in VT.items()}
# a column's ValType from its dtype (STRING codes are int32: INT)
DTYPE_VT = {torch.int32: VT[AttrType.INT], torch.int64: VT[AttrType.LONG],
            torch.float32: VT[AttrType.FLOAT],
            torch.float64: VT[AttrType.DOUBLE], torch.bool: VT[AttrType.BOOL]}
(OP_LOAD, OP_CONST, OP_NULLC, OP_CAST, OP_ADD, OP_SUB, OP_MUL, OP_DIV,
 OP_MOD, OP_EQ, OP_NE, OP_GT, OP_GE, OP_LT, OP_LE, OP_AND, OP_OR, OP_NOT,
 OP_ISNULL, OP_KEEP, OP_OUT, OP_ZNULL, OP_NEG) = range(23)
# the function calls (see _compile_function)
(OP_CONVERT, OP_COALESCE, OP_DEFAULT, OP_IFELSE, OP_MAXIMUM, OP_MINIMUM,
 OP_MATH, OP_POW, OP_SETELEM, OP_SETSIZE) = range(23, 33)
# set values in a program: VT_SET a createSet() singleton (the slot holds
# the encoded element), VT_SETREF a loaded [rows, 1 + SET_LANES] column
# (OUT copies its row), VT_SETSIZE a load of such a column's size
VT_SET, VT_SETREF, VT_SETSIZE = 6, 7, 8
# OP_MATH's arg: the function, numbered as csrc/expr_interp.cuh numbers it
MATH_FNS = ("abs", "ceil", "floor", "signum", "round", "sqrt", "exp", "ln",
            "log10", "sin", "cos", "tan", "asin", "acos", "atan")
# the math-library functions: not bit-equal to the reference's XLA code
# (held to 2 ulp), and folded with the C library as XLA's constant
# folder folds them
LIBRARY_FNS = frozenset(MATH_FNS[5:])
# the stack effect of each opcode that does not push one value from none
_POPS = {OP_CAST: 0, OP_NOT: 0, OP_ISNULL: 0, OP_ZNULL: 0, OP_NEG: 0,
         OP_CONVERT: 0, OP_MATH: 0, OP_SETELEM: 0, OP_SETSIZE: 0,
         OP_IFELSE: 2}
MATH_OPS = {"+": OP_ADD, "-": OP_SUB, "*": OP_MUL, "/": OP_DIV, "%": OP_MOD}
CMP_OPS = {"==": OP_EQ, "!=": OP_NE, ">": OP_GT, ">=": OP_GE, "<": OP_LT,
           "<=": OP_LE}
# OP_MOD's arg: the divisor is a literal +-2^k (k >= 0), or another
# non-zero constant
MOD_POW2, MOD_CONST = 1, 2
TIMER_KIND = 2
ALL_KINDS = 0b1111


def const_bits(value, t: AttrType) -> int:
    """A non-null constant as the kernel's raw 64-bit slot: INT/STRING
    sign-extended int32, LONG, BOOL 0/1, FLOAT float32 bits, DOUBLE
    float64 bits."""
    v = np.asarray(value, dtype=np_dtype(t))
    if t is AttrType.FLOAT:
        return int(v.view(np.uint32))
    if t is AttrType.DOUBLE:
        return int(v.view(np.int64))
    return int(v)


def bits_value(bits: int, t: AttrType):
    """Inverse of const_bits: the constant as a numpy scalar."""
    if t is AttrType.FLOAT:
        return np.uint32(bits & 0xFFFFFFFF).view(np.float32)
    if t is AttrType.DOUBLE:
        return np.int64(bits).view(np.float64)
    return np.asarray(bits, dtype=np_dtype(t))[()]


@dataclasses.dataclass
class CompiledExpr:
    """One compiled expression: its result type and its postfix code,
    a tuple of (opcode, value type, arg). OP_CONST carries the constant's
    raw bits as its arg until the program is assembled. A constant
    expression also keeps its value (a numpy scalar, None when null).
    ``nonneg``: the reference's XLA code takes the value for non-negative
    (see _compile_compare), NaN or not."""
    type: AttrType
    code: tuple
    const_value: Any = None
    is_const: bool = False
    nonneg: bool = False


def _const(t: AttrType, value) -> CompiledExpr:
    if value is None:
        return CompiledExpr(t, ((OP_NULLC, VT[t], 0),), None, True)
    value = np.asarray(value, dtype=np_dtype(t))[()]
    return CompiledExpr(t, ((OP_CONST, VT[t], const_bits(value, t)),),
                        value, True,
                        t in NUMERIC_TYPES and bool(value >= 0))


# the env keys a load resolves: ('attr', i) is column i of the batch a
# step runs over; ('slot', j, a, c) and ('slot_last', j, a, k) read a
# pattern row's capture (ops/nfa.py PatternScope), resolved per (row,
# event) by kernel K3 (ops/nfa_parallel.py)
LOAD_KEYS = ("attr", "slot", "slot_last", "L", "R", "T", "S")


class Scope:
    """Variable resolution at compile time: maps a Variable to an env key
    and type (one of LOAD_KEYS)."""

    def resolve(self, var: A.Variable) -> tuple[Any, AttrType]:
        raise NotImplementedError

    def resolve_stream_isnull(self, is_null: A.IsNull):
        raise CompileError("stream is null not supported in this context")

    def clock_key(self, which: str):
        """The load key of the row's timestamp (``which`` 'ts':
        eventTimestamp()) or of the step's clock ('now':
        currentTimeMillis()). Only kernel K2's programs load them; the
        reference binds neither in a pattern condition."""
        fn = "eventTimestamp()" if which == "ts" else "currentTimeMillis()"
        raise NotImplementedError(f"not ported yet: {fn} in this context")


class RowScope(Scope):
    """A scope whose programs run in kernel K2 over one batch: the row's
    timestamp is the batch's ``ts`` and the clock the step's ``now``, as
    the reference's env_from_batch binds ``__ts__`` and its steps
    ``__now__``."""

    def clock_key(self, which: str):
        return (which,)


class SingleStreamScope(RowScope):
    """One input stream: variables resolve to ('attr', index)."""

    def __init__(self, schema, aliases=()):
        self.schema = schema
        self.aliases = {a for a in aliases if a}

    def resolve(self, var: A.Variable):
        ref = var.stream_ref
        if ref is not None and ref != self.schema.stream_id and ref not in self.aliases:
            raise CompileError(
                f"unknown stream reference '{ref}' (expected "
                f"'{self.schema.stream_id}')")
        idx = self.schema.index_of(var.attribute)
        return ("attr", idx), self.schema.types[idx]


def _num(e: CompiledExpr, what: str) -> None:
    if e.type not in NUMERIC_TYPES:
        raise CompileError(f"{what} requires a numeric operand, got {e.type}")


# ---------------------------------------------------------------------------
# the reference's float semantics, shared by constant folding and
# expr_eval_ref (csrc/expr_eval.cu implements the same rules)
# ---------------------------------------------------------------------------

# per float dtype: (same-width int dtype, quiet bit, x86 "indefinite"
# NaN, sign bit), the ints as signed values of that width
_FLOAT_BITS = {torch.float32: (torch.int32, 0x00400000, -0x00400000,
                               -(2 ** 31)),
               torch.float64: (torch.int64, 0x0008000000000000,
                               -0x0008000000000000, -(2 ** 63))}


def nan_rule(r, x, y):
    """NaN results as the reference's x86 CPU makes them: a NaN operand
    propagates (the first one first, made quiet); an invalid operation
    on numbers gives the negative 'indefinite' NaN."""
    ib, quiet, indefinite, _sign = _FLOAT_BITS[r.dtype]

    def quieted(v):
        return (v.view(ib) | quiet).view(r.dtype)
    default = torch.tensor(indefinite, dtype=ib, device=r.device).view(
        r.dtype)
    return torch.where(torch.isnan(x), quieted(x), torch.where(
        torch.isnan(y), quieted(y), torch.where(torch.isnan(r), default, r)))


def float_math(op: int, x, y, flush: bool = True, pow2: bool = False):
    """+ - * / % on one float dtype, divisor already non-zero. With
    ``flush`` (the reference's compiled XLA code), subnormal operands and
    results of + - * / read as zero; fmod never flushes. ``pow2``: %
    by a literal +-2^k (k >= 0), which the reference's compiled code
    does not run through fmod: a subnormal dividend gives a zero of its
    sign, an infinite one a quiet NaN of its sign."""
    if op == OP_MOD:
        r = torch.where(torch.isinf(x), torch.full_like(x, float("nan")),
                        torch.fmod(x, y))
        r = nan_rule(r, x, y)
        if pow2:
            sign = torch.where(torch.isinf(x),
                               torch.full_like(x, float("nan")),
                               torch.zeros_like(x)).copysign(x)
            r = torch.where(torch.isinf(x) | (flush_subnormal(x) == 0),
                            sign, r)
        return r
    if flush:
        x, y = flush_subnormal(x), flush_subnormal(y)
    r = {OP_ADD: torch.add, OP_SUB: torch.sub, OP_MUL: torch.mul,
         OP_DIV: torch.div}[op](x, y)
    r = nan_rule(r, x, y)
    return flush_subnormal(r) if flush else r


def int_math(op: int, x, y):
    """Java + - * / % on one int dtype, divisor already non-zero:
    wrapping, truncating, MIN / -1 == MIN and MIN % -1 == 0 (the
    hardware division would trap)."""
    if op in (OP_ADD, OP_SUB, OP_MUL):
        return {OP_ADD: torch.add, OP_SUB: torch.sub, OP_MUL: torch.mul}[op](
            x, y)
    neg1 = y == -1
    safe = torch.where(neg1, torch.ones_like(y), y)
    if op == OP_DIV:
        return torch.where(neg1, torch.neg(x),
                           torch.div(x, safe, rounding_mode="trunc"))
    return torch.where(neg1, torch.zeros_like(x), torch.fmod(x, safe))


def widen(v, t: AttrType, flush: bool = True):
    """Numeric widening to ``t`` (astype). FLOAT -> DOUBLE reads a
    subnormal as zero (with ``flush``) and keeps a NaN's sign and
    payload, as x86 does."""
    dt = torch_dtype(t)
    if v.dtype == torch.float32 and dt == torch.float64:
        u = v.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        nan = (((u >> 31) << 63) | 0x7FF8000000000000
               | ((u & 0x7FFFFF) << 29)).view(torch.float64)
        w = (flush_subnormal(v) if flush else v).to(dt)
        return torch.where(torch.isnan(v), nan, w)
    return v.to(dt)


def convert(v, frm: AttrType, to: AttrType):
    """OP_CONVERT, the reference's ``astype`` where it is not a widening:
    int narrowing wraps; FLOAT/DOUBLE -> INT/LONG truncates and saturates,
    NaN giving 0; DOUBLE -> FLOAT rounds, subnormal results read as zero
    and a NaN keeps its sign and high payload bits; BOOL is 0 or 1."""
    dt = torch_dtype(to)
    if not v.is_floating_point():
        if to in (AttrType.INT, AttrType.LONG):
            return v.to(dt)
        return widen(v.to(torch.int64), to)
    if to is AttrType.FLOAT:   # from DOUBLE
        u = v.view(torch.int64)
        nan = (((u >> 63) << 31) | 0x7FC00000
               | ((u >> 29) & 0x3FFFFF)).to(torch.int32).view(torch.float32)
        return torch.where(torch.isnan(v), nan,
                           flush_subnormal(flush_subnormal(v).to(dt)))
    if to is AttrType.DOUBLE:
        return widen(v, to)
    bits = 31 if to is AttrType.INT else 63
    x = v.to(torch.float64)
    hi, lo = x >= 2.0 ** bits, x < -(2.0 ** bits)
    safe = torch.where(hi | lo | torch.isnan(x), torch.zeros_like(x), x)
    r = safe.to(dt)
    r = torch.where(hi, torch.full_like(r, 2 ** bits - 1), r)
    return torch.where(lo, torch.full_like(r, -(2 ** bits)), r)


_LIB = {"sqrt": torch.sqrt, "exp": torch.exp, "ln": torch.log,
        "log10": torch.log10, "sin": torch.sin, "cos": torch.cos,
        "tan": torch.tan, "asin": torch.asin, "acos": torch.acos,
        "atan": torch.atan}


# the library functions whose operand the reference's XLA code reads
# flushed (sqrt, ln, log10, atan) and those whose result it flushes (exp);
# sin, cos, tan and acos keep subnormals; asin gives a zero of the
# operand's sign below twice the smallest normal (XLA computes it as
# 2 atan2(x, 1 + sqrt(1 - x^2)), whose halved result flushes)
FLUSH_IN = frozenset(("sqrt", "ln", "log10", "atan"))
FLUSH_OUT = frozenset(("exp",))
ASIN_ZERO = 2 * 2.2250738585072014e-308


def math_fn(fn: str, x):
    """OP_MATH on one operand of its result type (the operand of every
    function but abs already widened to DOUBLE), as the reference's XLA
    code computes it: abs is a sign bit; ceil, floor, round and signum
    read a subnormal operand as zero, signum keeps a NaN and a zero's
    sign, round halves to even; the library functions flush as FLUSH_IN,
    FLUSH_OUT and ASIN_ZERO say (their values are the library's, within
    2 ulp of the reference's)."""
    if fn == "abs":
        return torch.abs(x)
    fx = flush_subnormal(x)
    if fn == "ceil":
        return torch.ceil(fx)
    if fn == "floor":
        return torch.floor(fx)
    if fn == "round":
        return torch.round(fx)
    if fn == "signum":
        return torch.where(torch.isnan(x) | (fx == 0), fx,
                           torch.ones_like(fx).copysign(fx))
    r = _LIB[fn](fx if fn in FLUSH_IN else x)
    if fn == "asin":
        r = torch.where(x.abs() < ASIN_ZERO, torch.zeros_like(x).copysign(x),
                        r)
    return flush_subnormal(r) if fn in FLUSH_OUT else r


def power(x, y):
    """OP_POW: math:power over DOUBLE operands; the result flushed, as
    the reference's XLA code flushes it."""
    return flush_subnormal(torch.pow(x, y))


def set_element(v, t: AttrType):
    """OP_SETELEM: a createSet() element as its int64 lane (FLOAT widened
    and flushed, then its bits; DOUBLE its bits; the rest sign-extended)."""
    if t is AttrType.FLOAT:
        return widen(v, AttrType.DOUBLE).view(torch.int64)
    if t is AttrType.DOUBLE:
        return v.view(torch.int64)
    return v.to(torch.int64)


def set_rows(elem, tag: int):
    """[rows, 1 + SET_LANES] set rows of one element each (SET_EMPTY for
    an empty set)."""
    out = torch.full(elem.shape + (1 + SET_LANES,), SET_EMPTY,
                     dtype=torch.int64, device=elem.device)
    out[..., 0] = tag
    out[..., 1] = elem
    return out


def set_size(rows):
    """sizeOfSet(): the non-empty lanes of each set row."""
    return (rows[..., 1:] != SET_EMPTY).sum(-1, dtype=torch.int32)


# ---------------------------------------------------------------------------
# main compile dispatch
# ---------------------------------------------------------------------------


def compile_expression(expr: A.Expression, scope: Scope,
                       functions: Optional[dict] = None) -> CompiledExpr:

    def comp(e: A.Expression) -> CompiledExpr:
        if isinstance(e, A.Constant):
            t = e.type
            if e.value is None:
                # NULL literal: typed when the AST says so, DOUBLE otherwise
                nt = t if isinstance(t, AttrType) else AttrType.DOUBLE
                np_dtype(nt)  # an OBJECT-typed null raises, as in the reference
                return _const(nt, None)
            if t is AttrType.OBJECT:
                raise NotImplementedError(
                    "expression not ported yet: OBJECT literal")
            value = GLOBAL_STRINGS.encode(e.value) \
                if t is AttrType.STRING else e.value
            return _const(t, value)

        if isinstance(e, A.Variable):
            if e.attribute is None:
                raise CompileError(f"bare stream reference '{e.stream_ref}' "
                                   "only valid in IS NULL")
            key, t = scope.resolve(e)
            if not (isinstance(key, tuple) and key[0] in LOAD_KEYS):
                raise NotImplementedError(
                    f"expression not ported yet: variable key {key!r}")
            if t is AttrType.OBJECT and key[0] == "attr":
                # a set column: kernel K2 copies or counts its row
                return CompiledExpr(t, ((OP_LOAD, VT_SETREF, key[1]),))
            if t not in VT:
                raise NotImplementedError(
                    f"expression not ported yet: {t} attribute "
                    f"'{e.attribute}'")
            return CompiledExpr(t, ((OP_LOAD, VT[t],
                                     key[1] if key[0] == "attr" else key),))

        if isinstance(e, A.TemplateParam):
            raise NotImplementedError(
                f"expression not ported yet: template parameter "
                f"'${{{e.name}}}'")

        if isinstance(e, A.MathOp):
            return _compile_math(e, comp)

        if isinstance(e, A.Compare):
            return _compile_compare(e, comp)

        if isinstance(e, (A.And, A.Or)):
            l, r = comp(e.left), comp(e.right)
            word = "AND" if isinstance(e, A.And) else "OR"
            _require_bool(l, word), _require_bool(r, word)
            op = OP_AND if isinstance(e, A.And) else OP_OR
            if l.is_const and r.is_const:
                a, b = _truth(l), _truth(r)
                return _const(AttrType.BOOL, (a and b) if op == OP_AND
                              else (a or b))
            return CompiledExpr(AttrType.BOOL,
                                l.code + r.code + ((op, VT[AttrType.BOOL], 0),))

        if isinstance(e, A.Not):
            x = comp(e.expr)
            _require_bool(x, "NOT")
            if x.is_const:
                return _const(AttrType.BOOL, not _truth(x))
            return CompiledExpr(AttrType.BOOL,
                                x.code + ((OP_NOT, VT[AttrType.BOOL], 0),))

        if isinstance(e, A.IsNull):
            if e.expr is None:
                return scope.resolve_stream_isnull(e)
            x = comp(e.expr)
            if x.is_const:
                return _const(AttrType.BOOL, x.const_value is None)
            return CompiledExpr(AttrType.BOOL,
                                x.code + ((OP_ISNULL, VT[AttrType.BOOL], 0),))

        if isinstance(e, A.InTable):
            raise CompileError("IN <table> must be planned by the query "
                               "planner (table containment)")

        if isinstance(e, A.AttributeFunction):
            return _compile_function(e, comp, scope, functions or {})

        raise CompileError(f"cannot compile expression {e!r}")

    return comp(expr)


def _require_bool(e: CompiledExpr, what: str):
    if e.type is not AttrType.BOOL:
        raise CompileError(
            f"{what} requires BOOL operands, got {e.type} "
            "(reference: AndConditionExpressionExecutor type check)")


def _truth(e: CompiledExpr) -> bool:
    """A BOOL constant as AND/OR/NOT read it (null is FALSE)."""
    return e.const_value is not None and bool(e.const_value)


def _scalar(e: CompiledExpr):
    return torch.tensor(e.const_value, dtype=torch_dtype(e.type))


def _widen(e: CompiledExpr, t: AttrType) -> CompiledExpr:
    """e widened to t (the reference's astype): a constant folds,
    unflushed (see _fold_math)."""
    if e.type is t:
        return e
    if e.is_const:
        if e.const_value is None:
            return _const(t, None)
        return _const(t, widen(_scalar(e), t, flush=False).item())
    return CompiledExpr(t, e.code + ((OP_CAST, VT[t], VT[e.type]),))


def _fold_math(op: int, t: AttrType, l: CompiledExpr, r: CompiledExpr):
    """Constant math, as the reference computes it: in plain IEEE, with
    no flush, at any depth. Two literals meet in numpy; a constant that
    went through a jnp op is a constant of the XLA program, and XLA folds
    constant subtrees at compile time on the host, unflushed (the flush
    only applies to code that runs)."""
    if l.const_value is None or r.const_value is None:
        return _const(t, None)
    x, y = _scalar(l), _scalar(r)
    if op in (OP_DIV, OP_MOD) and y.item() == 0:
        return _const(t, None)
    if t in (AttrType.FLOAT, AttrType.DOUBLE):
        v = float_math(op, x, y, flush=False)
    else:
        v = int_math(op, x, y)
    return _const(t, v.item())


def _same(code: tuple, op: int, t: AttrType, arg: int = 0) -> CompiledExpr:
    return CompiledExpr(t, code + ((op, VT[t], arg),))


def _compile_math(e: A.MathOp, comp) -> CompiledExpr:
    l, r = comp(e.left), comp(e.right)
    _num(l, f"'{e.op}'"), _num(r, f"'{e.op}'")
    t = promote(l.type, r.type)
    if e.op not in MATH_OPS:
        raise AssertionError(e.op)
    op = MATH_OPS[e.op]
    l, r = _widen(l, t), _widen(r, t)
    if l.is_const and r.is_const:
        return _fold_math(op, t, l, r)
    if (l.is_const and l.const_value is None) or \
            (r.is_const and r.const_value is None):
        return _const(t, None)   # a null operand: null for every row
    if op in (OP_DIV, OP_MOD) and r.is_const and r.const_value == 0:
        # the zero test of a constant divisor runs at compile time,
        # unflushed: by zero, null for every row
        return _const(t, None)
    if t in (AttrType.FLOAT, AttrType.DOUBLE):
        # the reference compiler's algebraic rewrites: A / c -> A * (1/c),
        # A * 1 -> A, A * -1 -> -A, A + 0 -> A, A - 0 -> A (unflushed)
        if op == OP_DIV and r.is_const:
            one = torch.ones((), dtype=torch_dtype(t))
            r = _const(t, torch.div(one, _scalar(r)).item())
            op = OP_MUL
        if op == OP_MOD and r.is_const:
            mant, exp = math.frexp(abs(float(r.const_value)))
            if mant == 0.5 and exp >= 1:   # |c| = 2^k, k >= 0
                return _same(l.code + r.code, OP_MOD, t, MOD_POW2)
            # a non-zero constant divisor: no null at run time, and a
            # subnormal one reads as zero there (fmod's own zero test
            # runs flushed), which gives NaN for every row
            return _same(l.code + r.code, OP_MOD, t, MOD_CONST)
        for a, c in ((l, r), (r, l)):
            if not c.is_const or (c is l and op == OP_SUB):
                continue
            cv = c.const_value
            if op == OP_MUL and cv in (1, -1):
                return _same(a.code, OP_ZNULL if cv == 1 else OP_NEG, t)
            if op in (OP_ADD, OP_SUB) and cv == 0:
                return _same(a.code, OP_ZNULL, t)
    out = _same(l.code + r.code, op, t)
    # x * x of one column: one operand twice, which XLA's simplifier
    # takes for >= 0
    out.nonneg = op == OP_MUL and l.code == r.code and len(l.code) == 1
    return out


def _compile_compare(e: A.Compare, comp) -> CompiledExpr:
    l, r = comp(e.left), comp(e.right)
    op = e.op
    if not comparable(l.type, r.type):
        # STRING columns are int32 dictionary codes on device, so a
        # STRING vs numeric comparison would relate codes, not text
        if (l.type is AttrType.STRING) != (r.type is AttrType.STRING):
            other = r.type if l.type is AttrType.STRING else l.type
            raise CompileError(
                f"cannot compare STRING with {other}: device strings "
                "are int32 dictionary codes — the comparison would "
                "relate codes, not text")
        raise CompileError(f"cannot compare {l.type} with {r.type}")
    if op not in CMP_OPS:
        raise AssertionError(op)
    if l.type in NUMERIC_TYPES and r.type in NUMERIC_TYPES:
        t = promote(l.type, r.type)
        l, r = _widen(l, t), _widen(r, t)
    elif op not in ("==", "!=") and l.type is AttrType.STRING:
        # comparable() guarantees same-type STRING/BOOL here
        raise CompileError(
            "ordering comparison on STRING is not supported on device")
    if l.is_const and r.is_const:
        if l.const_value is None or r.const_value is None:
            return _const(AttrType.BOOL, False)
        x, y = _scalar(l), _scalar(r)
        return _const(AttrType.BOOL, bool(_CMP_FN[CMP_OPS[op]](x, y)))
    # XLA's simplifier: a value it takes for non-negative (abs, exp, x * x,
    # selects of such, constants >= 0) compared with a literal zero,
    # `>= 0` (or `0 <=`) is TRUE and `< 0` (or `0 >`) FALSE, NaN or not;
    # the reference's compare then drops null rows
    for x, zero, true_op, false_op in ((l, r, ">=", "<"), (r, l, "<=", ">")):
        if x.nonneg and not x.is_const and zero.is_const \
                and zero.const_value is not None and zero.const_value == 0 \
                and not np.signbit(zero.const_value):
            if op == false_op:
                return _const(AttrType.BOOL, False)
            if op == true_op:
                return CompiledExpr(AttrType.BOOL, x.code + (
                    (OP_ISNULL, VT[AttrType.BOOL], 0),
                    (OP_NOT, VT[AttrType.BOOL], 0)))
    return CompiledExpr(AttrType.BOOL, l.code + r.code
                        + ((CMP_OPS[op], VT[l.type], 0),))


_CMP_FN = {OP_EQ: torch.eq, OP_NE: torch.ne, OP_GT: torch.gt,
           OP_GE: torch.ge, OP_LT: torch.lt, OP_LE: torch.le}


# ---------------------------------------------------------------------------
# built-in scalar functions (reference: _compile_function, _compile_math_ns;
# executor/function/*.java). Each call lowers to typed postfix code; a call
# whose arguments are all constant folds at plan time, as the reference's
# numpy constants and XLA's constant folder compute it (unflushed).
# ---------------------------------------------------------------------------

_CONVERT_TARGETS = {
    "int": AttrType.INT, "long": AttrType.LONG, "float": AttrType.FLOAT,
    "double": AttrType.DOUBLE, "bool": AttrType.BOOL, "string": AttrType.STRING,
}
_INSTANCE_OF = {"instanceofinteger": AttrType.INT,
                "instanceoflong": AttrType.LONG,
                "instanceoffloat": AttrType.FLOAT,
                "instanceofdouble": AttrType.DOUBLE,
                "instanceofboolean": AttrType.BOOL,
                "instanceofstring": AttrType.STRING}


def _as(e: CompiledExpr, t: AttrType) -> CompiledExpr:
    """e as type t, the reference's ``astype``: a widening is OP_CAST,
    any other numeric or BOOL -> numeric change OP_CONVERT (narrowing
    wraps, float -> int saturates with NaN -> 0, DOUBLE -> FLOAT rounds
    and flushes). A constant folds in numpy, as the reference's numpy
    constants convert."""
    if e.type is t:
        return e
    if e.type in NUMERIC_TYPES and t in NUMERIC_TYPES and \
            PROMOTION_ORDER[e.type] < PROMOTION_ORDER[t]:
        return _widen(e, t)
    if e.is_const:
        if e.const_value is None:
            return _const(t, None)
        with np.errstate(all="ignore"):
            return _const(t, np.asarray(e.const_value).astype(np_dtype(t))[()])
    return CompiledExpr(t, e.code + ((OP_CONVERT, VT[t], VT[e.type]),))


def _no_set(e: CompiledExpr, name: str) -> None:
    if e.type is AttrType.OBJECT:
        raise NotImplementedError(f"not ported yet: {name}() over a set")


def _shared_type(params, name: str, what: str) -> AttrType:
    """The reference's promotion of coalesce's arguments or of
    ifThenElse's and default's branches: numeric types promote, any
    other type must match."""
    t = params[0].type
    for p in params[1:]:
        if p.type in NUMERIC_TYPES and t in NUMERIC_TYPES:
            t = promote(t, p.type)
        elif p.type != t:
            raise CompileError(f"{name}() {what} must share a type")
    return t


def _set_result(e: CompiledExpr):
    """A set-valued expression's representation: (VT_SET, tag) for a
    createSet() singleton, (VT_SETREF, None) for a loaded set column."""
    op, vt, _arg = e.code[-1]
    if op == OP_SETELEM:
        return VT_SET, set_tag_of(VT_TYPE[vt])
    return VT_SETREF, None


def _compile_function(e: A.AttributeFunction, comp, scope,
                      functions) -> CompiledExpr:
    name = f"{e.namespace}:{e.name}" if e.namespace else e.name
    key = name.lower()
    if key in functions:
        raise NotImplementedError(
            f"not ported yet: registered or script function '{name}()'")
    params = [comp(p) for p in e.parameters]

    if key in ("convert", "cast"):
        if len(params) != 2:
            raise CompileError(f"{name}() requires 2 arguments")
        target = e.parameters[1]
        if not isinstance(target, A.Constant):
            raise CompileError(f"{name}() target type must be a constant")
        tname = str(target.value).lower()
        if tname not in _CONVERT_TARGETS:
            raise CompileError(f"unknown {name}() target '{tname}'")
        t = _CONVERT_TARGETS[tname]
        src = params[0]
        if (t is AttrType.STRING) != (src.type is AttrType.STRING):
            raise CompileError(
                f"{name}() to/from STRING is host-side only; not "
                "supported on the device path yet")
        if t is AttrType.BOOL and src.type is not AttrType.BOOL:
            raise CompileError(f"{name}() numeric->BOOL not supported")
        _no_set(src, name)
        return _as(src, t)

    if key == "coalesce":
        if not params:
            raise CompileError("coalesce() requires arguments")
        for p in params:
            _no_set(p, name)
        t = _shared_type(params, name, "arguments")
        out = _as(params[0], t)
        for p in params[1:]:
            out = _select2(OP_COALESCE, t, out, _as(p, t))
        return out

    if key == "default":
        if len(params) != 2:
            raise CompileError("default() requires 2 arguments")
        src, dflt = params
        _no_set(src, name)
        t = _shared_type(params, name, "arguments")
        return _select2(OP_DEFAULT, t, _as(src, t), _as(dflt, t))

    if key == "ifthenelse":
        if len(params) != 3:
            raise CompileError("ifThenElse() requires 3 arguments")
        cond, a, b = params
        _require_bool(cond, "ifThenElse condition")
        _no_set(a, name), _no_set(b, name)
        t = _shared_type([a, b], name, "branches")
        a, b = _as(a, t), _as(b, t)
        if cond.is_const:   # a null condition takes the else branch
            return a if _truth(cond) else b
        return CompiledExpr(t, cond.code + a.code + b.code
                            + ((OP_IFELSE, VT[t], 0),),
                            nonneg=a.nonneg and b.nonneg)

    if key in ("maximum", "minimum"):
        if not params:
            raise CompileError(f"{name}() requires arguments")
        t = params[0].type
        for p in params:
            _num(p, name)
            t = promote(t, p.type)
        op = OP_MAXIMUM if key == "maximum" else OP_MINIMUM
        args = [_as(p, t) for p in params]
        if all(a.is_const for a in args):
            return _fold_extreme(op, t, args)
        code = args[0].code
        for a in args[1:]:
            code = code + a.code + ((op, VT[t], 0),)
        return CompiledExpr(t, code + ((OP_ZNULL, VT[t], 0),),
                            nonneg=all(a.nonneg for a in args))

    if key == "uuid":
        # the sentinel code; each row decodes to a fresh UUID at the host
        # edge (core/types.py StringTable.decode)
        if params:
            raise CompileError("uuid() takes no arguments")
        return _const(AttrType.STRING, GLOBAL_STRINGS.encode(UUID_MARKER))

    if key == "createset":
        if len(params) != 1:
            raise CompileError(
                "createSet() function has to have exactly 1 parameter")
        src = params[0]
        _no_set(src, name)
        set_tag_of(src.type)   # the element types the reference allows
        return CompiledExpr(AttrType.OBJECT, src.code
                            + ((OP_SETELEM, VT[src.type], 0),))

    if key == "sizeofset":
        if len(params) != 1:
            raise CompileError(
                "sizeOfSet() function has to have exactly 1 parameter")
        src = params[0]
        if src.type is not AttrType.OBJECT:
            raise CompileError(
                "sizeOfSet() parameter should be a set object "
                "(createSet()/unionSet() result)")
        if _set_result(src)[0] == VT_SETREF:
            return CompiledExpr(AttrType.INT,
                                ((OP_LOAD, VT_SETSIZE, src.code[-1][2]),))
        return CompiledExpr(AttrType.INT, src.code
                            + ((OP_SETSIZE, VT[AttrType.INT], 0),))

    if key in ("eventtimestamp", "currenttimemillis"):
        if params:
            raise CompileError(f"{name}() takes no arguments")
        which = "ts" if key == "eventtimestamp" else "now"
        return CompiledExpr(AttrType.LONG, ((OP_LOAD, VT[AttrType.LONG],
                                             scope.clock_key(which)),))

    if key.startswith("instanceof"):
        target = _INSTANCE_OF.get(key)
        if target is None:
            raise CompileError(f"unknown function '{name}'")
        if len(params) != 1:
            raise CompileError(f"{name}() requires 1 argument")
        src = params[0]
        # statically typed columns: the type matches AND the value is
        # not null
        if src.type is not target:
            return _const(AttrType.BOOL, False)
        if src.is_const:
            return _const(AttrType.BOOL, src.const_value is not None)
        return CompiledExpr(AttrType.BOOL, src.code + (
            (OP_ISNULL, VT[AttrType.BOOL], 0), (OP_NOT, VT[AttrType.BOOL], 0)))

    if key.startswith("math:"):
        return _compile_math_ns(key[5:], name, params)

    raise CompileError(f"unknown function '{name}'")


def _select2(op: int, t: AttrType, l: CompiledExpr,
             r: CompiledExpr) -> CompiledExpr:
    """coalesce's step (the first non-null) or default(l, r) (r where l
    is null), both operands already of type t."""
    if l.is_const:
        if l.const_value is not None:
            return l
        if op == OP_DEFAULT or r.is_const:
            return r
    return CompiledExpr(t, l.code + r.code + ((op, VT[t], 0),),
                        nonneg=l.nonneg and r.nonneg)


def _fold_extreme(op: int, t: AttrType, args) -> CompiledExpr:
    """maximum()/minimum() of constants, the reference's fold in numpy:
    pick = (c > v & ~c.null) | null, unflushed."""
    v, null = args[0].const_value, args[0].const_value is None
    for a in args[1:]:
        if a.const_value is None:
            continue
        if null or (a.const_value > v if op == OP_MAXIMUM
                    else a.const_value < v):
            v = a.const_value
        null = False
    return _const(t, None if null else v)


def _compile_math_ns(fn_name: str, display: str, params) -> CompiledExpr:
    if fn_name in MATH_FNS and len(params) == 1:
        src = params[0]
        _num(src, display)
        out_t = src.type if fn_name == "abs" else AttrType.DOUBLE
        x = _as(src, out_t)
        if x.is_const:
            if x.const_value is None:
                return _const(out_t, None)
            return _const(out_t, fold_math(fn_name, x.const_value, out_t))
        return CompiledExpr(out_t, x.code + (
            (OP_MATH, VT[out_t], MATH_FNS.index(fn_name)),),
            nonneg=fn_name in ("abs", "exp"))
    if fn_name == "power" and len(params) == 2:
        a, b = params
        _num(a, display), _num(b, display)
        a, b = _as(a, AttrType.DOUBLE), _as(b, AttrType.DOUBLE)
        if a.is_const and b.is_const:
            if a.const_value is None or b.const_value is None:
                return _const(AttrType.DOUBLE, None)
            with np.errstate(all="ignore"):
                return _const(AttrType.DOUBLE, np.power(
                    np.float64(a.const_value), np.float64(b.const_value)))
        return CompiledExpr(AttrType.DOUBLE, a.code + b.code
                            + ((OP_POW, VT[AttrType.DOUBLE], 0),))
    raise CompileError(f"unknown function '{display}'")


def fold_math(fn: str, x, t: AttrType):
    """A math:* function of a constant, as XLA's constant folder computes
    it on the host (unflushed; the C library's functions)."""
    if fn == "abs":
        return np.abs(np.asarray(x, dtype=np_dtype(t)))[()]
    x = float(x)
    if fn == "signum":   # XLA's folder gives +0.0 for either zero
        return x if math.isnan(x) else (
            0.0 if x == 0 else math.copysign(1.0, x))
    if fn in ("ceil", "floor", "round"):
        if not math.isfinite(x):
            return x
        r = {"ceil": math.ceil, "floor": math.floor, "round": round}[fn](x)
        return math.copysign(float(r), x)
    if fn == "asin" and abs(x) <= 1:
        # XLA expands asin before it folds it
        return 2 * math.atan2(x, 1 + math.sqrt((1 - x) * (1 + x)))
    lib = {"sqrt": math.sqrt, "exp": math.exp, "ln": math.log,
           "log10": math.log10, "sin": math.sin, "cos": math.cos,
           "tan": math.tan, "asin": math.asin, "acos": math.acos,
           "atan": math.atan}[fn]
    try:
        return lib(x)
    except OverflowError:
        return math.inf
    except ValueError:
        if x == 0 and fn in ("ln", "log10"):
            return -math.inf
        return -math.nan


# ---------------------------------------------------------------------------
# program assembly: the filters and projections of one step -> one program
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ExprProgram:
    """The K2 program of one query step.

    ``code`` holds one int32 word per instruction (op | type << 8 |
    arg << 16), ``consts`` the constant pool (raw 64-bit slots),
    ``inputs`` what the program loads (LOAD arg i reads inputs[i]: an
    int is a batch column, a tuple a pattern slot key), ``out_types``
    the projected columns. ``spans`` marks where each condition built
    with ``ProgramBuilder.condition`` starts and ends in ``code``.
    ``timer_pass``: TIMER rows pass the filters; ``gate_bits``: bit k
    set means rows of kind k pass the selector's current/expired gate."""
    code: tuple
    consts: tuple
    const_types: tuple
    inputs: tuple
    out_types: tuple
    timer_pass: bool
    gate_bits: int
    depth: int
    spans: tuple = ()

    def __post_init__(self):
        lim = _kernels
        for what, n, cap in (("instructions", len(self.code), lim.MAX_CODE),
                             ("constants", len(self.consts), lim.MAX_CONSTS),
                             ("input columns", len(self.inputs), lim.MAX_COLS),
                             ("output columns", len(self.out_types),
                              lim.MAX_OUTS),
                             ("stack depth", self.depth, lim.MAX_STACK)):
            if n > cap:
                raise NotImplementedError(
                    f"not ported yet: a query step with more than {cap} "
                    f"{what} ({n}) in one device program")
        params = _kernels.ExprParams()
        params.n_code = len(self.code)
        params.code[:len(self.code)] = self.code
        params.consts[:len(self.consts)] = self.consts
        params.timer_pass = int(self.timer_pass)
        params.gate_bits = self.gate_bits
        params.now_input = self.inputs.index(("now",)) \
            if ("now",) in self.inputs else -1
        # kernel arguments with the program filled in; a launch sets only
        # the pointers and the row count (the owning query step holds its
        # lock while it launches)
        object.__setattr__(self, "params", params)


class ProgramBuilder:
    """Assembles compiled expressions into one ExprProgram: filter
    conditions end in OP_KEEP, projections in OP_OUT."""

    def __init__(self):
        self.code: list = []
        self.consts: list = []
        self.const_types: list = []
        self.inputs: list = []
        self.out_types: list = []
        self.timer_pass = False
        self.gate_bits = ALL_KINDS
        self.depth = 0
        self.spans: list = []

    def _emit(self, op: int, vt: int, arg: int) -> None:
        self.code.append(op | (vt << 8) | (arg << 16))

    def _add(self, ce: CompiledExpr) -> None:
        sp = 0
        for op, vt, arg in ce.code:
            if op == OP_LOAD:
                if arg not in self.inputs:
                    self.inputs.append(arg)
                arg = self.inputs.index(arg)
            elif op == OP_CONST:
                key = (arg, vt)
                pool = list(zip(self.consts, self.const_types))
                if key not in pool:
                    self.consts.append(arg)
                    self.const_types.append(vt)
                    pool.append(key)
                arg = pool.index(key)
            if op in (OP_LOAD, OP_CONST, OP_NULLC):
                sp += 1
            else:
                sp -= _POPS.get(op, 1)
            self.depth = max(self.depth, sp)
            self._emit(op, vt, arg)

    def keep(self, ce: CompiledExpr) -> None:
        self._add(ce)
        self._emit(OP_KEEP, VT[AttrType.BOOL], 0)

    def out(self, ce: CompiledExpr) -> None:
        self._add(ce)
        k = len(self.out_types)
        if ce.type is AttrType.OBJECT:   # a set row: its tag rides in arg
            vt, tag = _set_result(ce)
            self._emit(OP_OUT, vt, k | ((tag or 0) << 8))
        else:
            self._emit(OP_OUT, VT[ce.type], k)
        self.out_types.append(ce.type)

    def condition(self, ce: CompiledExpr) -> int:
        """A condition program of its own (it ends in OP_KEEP), sharing
        this builder's constants and loads. -> its index in ``spans``."""
        start = len(self.code)
        self.keep(ce)
        self.spans.append((start, len(self.code)))
        return len(self.spans) - 1

    def build(self) -> ExprProgram:
        return ExprProgram(tuple(self.code), tuple(self.consts),
                           tuple(self.const_types), tuple(self.inputs),
                           tuple(self.out_types), self.timer_pass,
                           self.gate_bits, self.depth, tuple(self.spans))


# ---------------------------------------------------------------------------
# kernel K2 and its plain version
# ---------------------------------------------------------------------------


def _decode(word: int):
    return word & 0xFF, (word >> 8) & 0xFF, word >> 16


def run_program(prog: ExprProgram, load, shape: tuple, dev, span=None):
    """Evaluate ``prog`` (or its condition ``span``, a (start, end) pair
    of ``prog.spans``) with plain tensor ops, the way kernels K2 and K3
    run it. ``load(key)`` -> (values, nulls) of ``prog.inputs[arg]``,
    any shape that broadcasts to ``shape``. Every operand is cast to the
    program's promote() dtype explicitly, so torch's own scalar
    promotion never applies. -> (keep mask [shape], {output index:
    (values, nulls) [shape]})."""
    false = torch.zeros((), dtype=torch.bool, device=dev)
    stack: list = []
    keep = torch.ones(shape, dtype=torch.bool, device=dev)
    outs: dict = {}
    code = prog.code if span is None else prog.code[span[0]:span[1]]
    for word in code:
        op, vt, arg = _decode(word)
        t = VT_TYPE.get(vt)
        if op == OP_LOAD:
            v, n = load(prog.inputs[arg])
            stack.append((set_size(v) if vt == VT_SETSIZE else v, n))
        elif op == OP_CONST:
            v = bits_value(prog.consts[arg], VT_TYPE[prog.const_types[arg]])
            stack.append((torch.tensor(v, dtype=torch_dtype(t), device=dev),
                          false))
        elif op == OP_NULLC:
            stack.append((torch.zeros((), dtype=torch_dtype(t), device=dev),
                          ~false))
        elif op == OP_CAST:
            v, n = stack.pop()
            stack.append((widen(v, t), n))
        elif op in (OP_ZNULL, OP_NEG):
            v, n = stack.pop()
            if op == OP_NEG:   # a sign-bit flip, NaNs included
                ib, _q, _nan, sign = _FLOAT_BITS[v.dtype]
                v = (v.view(ib) ^ sign).view(v.dtype)
            stack.append((torch.where(n, torch.zeros_like(v), v), n))
        elif op in (OP_ADD, OP_SUB, OP_MUL, OP_DIV, OP_MOD):
            (rv, rn), (lv, ln) = stack.pop(), stack.pop()
            nulls = ln | rn
            zero = None
            if op in (OP_DIV, OP_MOD):
                zero = flush_subnormal(rv) == 0
                if arg != MOD_CONST:
                    nulls = nulls | zero
                rv = torch.where(zero, torch.ones_like(rv), rv)
            if t in (AttrType.FLOAT, AttrType.DOUBLE):
                v = float_math(op, lv, rv, pow2=arg == MOD_POW2)
                if arg == MOD_CONST:   # fmod by a (flushed) zero: NaN
                    nan = nan_rule(torch.full_like(lv, float("nan")), lv,
                                   torch.zeros_like(lv))
                    v = torch.where(zero, nan, v)
            else:
                v = int_math(op, lv, rv)
            stack.append((torch.where(nulls, torch.zeros_like(v), v), nulls))
        elif op in (OP_EQ, OP_NE, OP_GT, OP_GE, OP_LT, OP_LE):
            (rv, rn), (lv, ln) = stack.pop(), stack.pop()
            c = _CMP_FN[op](flush_subnormal(lv), flush_subnormal(rv))
            stack.append((c & ~(ln | rn), false))
        elif op in (OP_AND, OP_OR):
            (rv, rn), (lv, ln) = stack.pop(), stack.pop()
            a, b = lv & ~ln, rv & ~rn
            stack.append(((a & b) if op == OP_AND else (a | b), false))
        elif op == OP_NOT:
            v, n = stack.pop()
            stack.append((~(v & ~n), false))
        elif op == OP_ISNULL:
            _v, n = stack.pop()
            stack.append((n.clone(), false))
        elif op == OP_CONVERT:
            v, n = stack.pop()
            stack.append((convert(v, VT_TYPE[arg], t), n))
        elif op in (OP_COALESCE, OP_DEFAULT):
            (rv, rn), (lv, ln) = stack.pop(), stack.pop()
            take = ln & ~rn if op == OP_COALESCE else ln
            stack.append((torch.where(take, rv, lv), ln & rn))
        elif op == OP_IFELSE:
            (bv, bn), (av, an), (cv, cn) = stack.pop(), stack.pop(), \
                stack.pop()
            take = cv & ~cn
            stack.append((torch.where(take, av, bv),
                          torch.where(take, an, bn)))
        elif op in (OP_MAXIMUM, OP_MINIMUM):
            (rv, rn), (lv, ln) = stack.pop(), stack.pop()
            fn = torch.gt if op == OP_MAXIMUM else torch.lt
            pick = (fn(flush_subnormal(rv), flush_subnormal(lv)) & ~rn) | ln
            stack.append((torch.where(pick & ~rn, rv, lv), ln & rn))
        elif op in (OP_MATH, OP_POW):
            if op == OP_MATH:
                v, n = stack.pop()
                v = math_fn(MATH_FNS[arg], v)
            else:
                (yv, yn), (xv, n) = stack.pop(), stack.pop()
                v, n = power(xv, yv), n | yn
            stack.append((torch.where(n, torch.zeros_like(v), v), n))
        elif op == OP_SETELEM:
            v, n = stack.pop()
            e = set_element(v, t)
            stack.append((torch.where(n, torch.full_like(e, SET_EMPTY), e),
                          false))
        elif op == OP_SETSIZE:
            v, n = stack.pop()
            stack.append(((v != SET_EMPTY).to(torch.int32), n))
        elif op == OP_KEEP:
            v, n = stack.pop()
            keep = keep & v & ~n
        else:  # OP_OUT
            v, n = stack.pop()
            if vt in (VT_SET, VT_SETREF):
                if vt == VT_SET:
                    v = set_rows(v.expand(shape), arg >> 8)
                    arg &= 0xFF
                v = v.expand(shape + (1 + SET_LANES,))
            else:
                v = v.to(torch_dtype(t)).expand(shape)
            outs[arg] = (v.contiguous(), n.expand(shape).contiguous())
    return keep, outs


def batch_input(batch, key, now=None):
    """(values, nulls or None) of one K2 input: a batch column, the
    row timestamps (("ts",)) or the step's clock (("now",), a 0-d int64
    tensor on the batch's device). None: never null."""
    if key == ("ts",):
        return batch.ts, None
    if key == ("now",):
        if now is None:
            raise ValueError("a program that reads currentTimeMillis() "
                             "needs the step's now")
        return torch.as_tensor(now, dtype=torch.int64,
                               device=batch.ts.device).reshape(()), None
    return batch.cols[key], batch.nulls[key]


def expr_eval_ref(prog: ExprProgram, batch, emitted=None, now=None):
    """Plain PyTorch version of kernel K2: (out cols, out nulls, valid),
    evaluated over whole columns (run_program). ``emitted`` (an int64
    0-d tensor) is increased by the number of rows kept."""
    false = torch.zeros((), dtype=torch.bool, device=batch.ts.device)

    def load(key):
        v, n = batch_input(batch, key, now)
        return v, false if n is None else n
    keep, outs = run_program(prog, load, (batch.capacity,), batch.ts.device)
    kind = batch.kind
    if prog.timer_pass:
        keep = keep | (kind == TIMER_KIND)
    gate = ((prog.gate_bits >> kind.to(torch.int64)) & 1).to(torch.bool)
    valid = batch.valid & keep & gate
    if emitted is not None:
        emitted += valid.sum(dtype=torch.int64)
    cols = tuple(outs[i][0] for i in range(len(prog.out_types)))
    nulls = tuple(outs[i][1] for i in range(len(prog.out_types)))
    return cols, nulls, valid


def expr_params(prog: ExprProgram, batch, cols, nulls, valid, emitted,
                ins=None):
    """K2's kernel arguments: ``prog.params`` (program already filled
    in) pointed at this batch and these output tensors. ``ins``: the
    inputs' (values, nulls or None), by default the batch's columns."""
    p = prog.params
    if ins is None:
        ins = [batch_input(batch, k) for k in prog.inputs]
    for k, (c, n) in enumerate(ins):
        p.in_cols[k] = c.data_ptr()
        p.in_nulls[k] = None if n is None else n.data_ptr()
    for k, (c, n) in enumerate(zip(cols, nulls)):
        p.out_cols[k] = c.data_ptr()
        p.out_nulls[k] = n.data_ptr()
    p.kind, p.valid = batch.kind.data_ptr(), batch.valid.data_ptr()
    p.out_valid = valid.data_ptr()
    p.emitted = emitted.data_ptr() if emitted is not None else None
    p.rows = batch.capacity
    return p


def expr_eval(prog: ExprProgram, batch, emitted=None, now=None):
    """Kernel K2: run one step's program over a batch, in one launch.

    -> (out cols, out nulls, out valid). A batch on the CPU takes the
    plain version; a CUDA batch launches the kernel. ``emitted``: an
    int64 0-d tensor on the batch's device, increased by the rows kept
    (one atomic add per thread block), or None. ``now``: the step's
    clock (an int or a 0-d int64 tensor), read by currentTimeMillis().
    A partition block's slotted batch (``[K, rows]`` columns) runs as
    one batch of K * rows rows: the program is row-wise."""
    if batch.ts.dim() == 2:
        from .slots import flat
        K = batch.ts.shape[0]
        cols, nulls, valid = expr_eval(prog, flat(batch), emitted, now)

        def back(x):
            return x.reshape((K, -1) + tuple(x.shape[1:]))
        return (tuple(back(c) for c in cols), tuple(back(n) for n in nulls),
                back(valid))
    dev = batch.ts.device
    if dev.type == "cpu":
        return expr_eval_ref(prog, batch, emitted, now)
    if dev.type != "cuda":
        raise ValueError(f"expr_eval: unsupported device {dev}")
    B = batch.capacity
    ins = [batch_input(batch, k, now) for k in prog.inputs]
    for x in [batch.kind, batch.valid] + [c for c, _ in ins] \
            + [n for _, n in ins if n is not None]:
        rows = x.shape[:1] if x.dim() else (B,)
        if x.device != dev or rows != (B,) or not x.is_contiguous():
            raise ValueError(
                "expr_eval: every input must be a contiguous [capacity] "
                f"tensor on {dev}, got {x.dtype}{list(x.shape)} on {x.device}")
    if batch.kind.dtype != torch.int32 or batch.valid.dtype != torch.bool:
        raise ValueError("expr_eval: kind must be int32 and valid bool")
    for _c, n in ins:
        if n is not None and n.dtype != torch.bool:
            raise ValueError("expr_eval: null masks must be bool")
    if emitted is not None and (emitted.device != dev
                                or emitted.dtype != torch.int64
                                or emitted.numel() != 1):
        raise ValueError("expr_eval: emitted must be an int64 scalar "
                         f"tensor on {dev}")
    cols = tuple(torch.empty((B, 1 + SET_LANES), dtype=torch.int64,
                             device=dev) if t is AttrType.OBJECT else
                 torch.empty((B,), dtype=torch_dtype(t), device=dev)
                 for t in prog.out_types)
    nulls = tuple(torch.empty((B,), dtype=torch.bool, device=dev)
                  for _ in prog.out_types)
    valid = torch.empty((B,), dtype=torch.bool, device=dev)
    p = expr_params(prog, batch, cols, nulls, valid, emitted, ins)
    _kernels.load().expr_eval(p, torch.cuda.current_stream(dev).cuda_stream)
    _kernels.count_launch("expr_eval")
    return cols, nulls, valid
