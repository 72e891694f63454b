"""Inputs shared by chip_smoke.py and the parity tests: the filter
bench feed, packed-ingest cases that reach every lane code, and random
columns with nulls and trap values for the expression kernel, all made
from a seed with numpy."""
from __future__ import annotations

import numpy as np

from .core.types import AttrType

FILTER_APP = """
    @app:playback
    define stream StockStream (symbol string, price float, volume long);
    @info(name = 'q')
    from StockStream[price > 100.0]
    select symbol, price
    insert into OutputStream;
"""

SYMS = ("IBM", "WSO2", "GOOG", "MSFT")
TS0 = 1_700_000_000_000


def filter_feed(n: int, encode, seed: int = 7):
    """The filter bench's feed (bench.py bench_filter): timestamps
    TS0 + arange, symbols uniform over SYMS, price ~ U(0, 200) float32,
    volume ~ U[1, 1000) int64. ``encode`` maps a symbol to its
    dictionary code. -> (ts, [symbol codes, price, volume])."""
    rng = np.random.default_rng(seed)
    syms = np.array([encode(s) for s in SYMS], np.int32)
    ts = TS0 + np.arange(n, dtype=np.int64)
    sym = syms[rng.integers(0, len(syms), n)]
    price = rng.uniform(0, 200, n).astype(np.float32)
    vol = rng.integers(1, 1000, n, dtype=np.int64)
    return ts, [sym, price, vol]


# -- kernel K1: packed-ingest cases -----------------------------------------

INGEST_TYPES = (AttrType.INT, AttrType.LONG, AttrType.STRING,
                AttrType.FLOAT, AttrType.DOUBLE, AttrType.BOOL)

# ts code and per-column spans: "c" constant, or the span of the deltas
INGEST_SPANS = {
    "c": ("aff", ["c"] * 6),
    "d8": ("d8", [200, 100, 50, "f", "d", "b"]),
    "d16": ("d16", [60_000, 40_000, 300, "f", "d", "b"]),
    "d32": ("d32", [2 ** 31, 2 ** 31, 70_000, "f", "d", "b"]),
    "raw64": ("raw64", [2 ** 32 - 1, 2 ** 62, 2 ** 20, "f", "d", "b"]),
}


def ingest_chunk(case: str, n: int, rng):
    """One chunk of INGEST_TYPES columns whose encoding reaches the
    lane codes named by ``case`` (for n >= 2). -> (ts, cols)."""
    ts_code, spans = INGEST_SPANS[case]
    base = TS0 + int(rng.integers(0, 1000))
    if ts_code == "aff":
        ts = base + 3 * np.arange(n, dtype=np.int64)
    else:
        top = {"d8": 255, "d16": 65_000, "d32": 2 ** 32 - 2,
               "raw64": 2 ** 40}[ts_code]
        ts = base + np.sort(rng.integers(0, top, n)).astype(np.int64)
        ts[0], ts[-1] = base, base + top
        if n > 2:
            ts[1] = base + 1   # never an arithmetic progression
    cols = []
    for t, span in zip(INGEST_TYPES, spans):
        if span == "c":
            v = {AttrType.INT: -7, AttrType.LONG: 2 ** 40 + 3,
                 AttrType.STRING: 5, AttrType.FLOAT: 1.5,
                 AttrType.DOUBLE: -2.25, AttrType.BOOL: True}[t]
            dt = {AttrType.INT: np.int32, AttrType.LONG: np.int64,
                  AttrType.STRING: np.int32, AttrType.FLOAT: np.float32,
                  AttrType.DOUBLE: np.float64, AttrType.BOOL: np.bool_}[t]
            cols.append(np.full(n, v, dt))
        elif span == "f":
            f = rng.standard_normal(n).astype(np.float32) * 1e3
            f[:4] = [np.nan, -0.0, np.inf, 3.4e38][:min(4, n)]
            cols.append(f)
        elif span == "d":
            d = rng.standard_normal(n) * 1e100
            d[:3] = [np.nan, -0.0, -np.inf][:min(3, n)]
            cols.append(d)
        elif span == "b":
            cols.append(rng.integers(0, 2, n).astype(np.bool_))
        else:
            lo = -(2 ** 31) if t is not AttrType.LONG else -(2 ** 61)
            v = lo + rng.integers(0, span, n, dtype=np.int64)
            v[0], v[-1] = lo, lo + span - 1
            cols.append(v.astype(np.int64 if t is AttrType.LONG
                                 else np.int32))
    return ts, cols


# -- kernel K2: expression cases -------------------------------------------

EXPR_SCHEMA = (("i", AttrType.INT), ("j", AttrType.INT),
               ("l", AttrType.LONG), ("m", AttrType.LONG),
               ("f", AttrType.FLOAT), ("g", AttrType.FLOAT),
               ("d", AttrType.DOUBLE), ("e", AttrType.DOUBLE),
               ("b", AttrType.BOOL), ("c", AttrType.BOOL),
               ("s", AttrType.STRING), ("t", AttrType.STRING))
EXPR_STRINGS = ("IBM", "WSO2", "GOOG")

_PAIRS = [("i", "j"), ("i", "l"), ("l", "m"), ("i", "f"), ("l", "f"),
          ("f", "g"), ("f", "d"), ("i", "d"), ("l", "d"), ("d", "e")]


def math_cases() -> list:
    """Every math operator over every type pairing, plus literal traps:
    division and modulo by zero and by -1, wrapping INT/LONG overflow."""
    out = [f"{a} {op} {b}" for op in ("+", "-", "*", "/", "%")
           for a, b in _PAIRS]
    out += ["i / 0", "i % 0", "l / 0L", "l % 0L", "f / 0.0f", "d % 0.0",
            "i / -1", "i % -1", "l / -1L", "l % -1L",
            "i * 65536", "i + 2147483647", "l * 4294967296L",
            "l - 9223372036854775807L", "f * 2.5f", "d / 3.0",
            "f - 100.0", "(i + j) * (l - m) / (f + 1.5f) % d"]
    out += rewrite_cases()
    return out


def rewrite_cases() -> list:
    """Literal operands the reference's compiler rewrites or folds:
    A / c -> A * (1/c), A * 1, A * -1, A + 0, A - 0; constant-only
    subexpressions fold at compile time."""
    return ["f / 3.0f", "d / 3.0", "d / 10", "f / -1.0f", "f / 1",
            "i / 1.0", "f * 1.0f", "1.0 * d", "d * -1.0", "f + 0.0f",
            "0.0 + d", "d - 0.0", "d - -0.0", "0.0 - d", "f * 0.0f",
            "2 + 3", "2.5f * 2", "(1.0 + 2.0) * d", "d / (1.0 + 2.0)",
            "7 / 2", "-7 % 2", "1.0 / 0.0", "d / (2.0 - 2.0)",
            "2147483647 + 1", "3.0f % 0.0f", "f % 2.0f", "d % 4",
            "f % -2.0f", "d % 1.0", "d % 0.5"]


def compare_cases() -> list:
    """The six compares over numeric pairs, STRING and BOOL equality,
    BOOL ordering, and literal compares (FLOAT vs DOUBLE literal)."""
    out = [f"{a} {op} {b}" for op in ("==", "!=", ">", ">=", "<", "<=")
           for a, b in _PAIRS[::2] + [("i", "j"), ("f", "g")]]
    out += ["s == t", "s != t", "s == 'IBM'", "'WSO2' != s", "b == c",
            "b != c", "b > c", "b <= true", "f > 100.0", "f == 0.0f",
            "d >= -0.0", "l < 3", "i != 2147483647", "1 < 2",
            "'IBM' == 'IBM'", "2.5f > 2.5", "f > 1.0 / 3.0"]
    return out


def logic_cases() -> list:
    return ["b and c", "b or c", "not b", "i is null", "not (d is null)",
            "(f > 1.0f) and (i < 2) or not c", "s is null or t is null",
            "not ((l % 0L) is null)", "(i / j) is null", "true and false",
            "not true", "(1 / 0) is null", "b or not (1 < 2)"]


def expr_cases() -> list:
    return math_cases() + compare_cases() + logic_cases()


def filter_cases() -> list:
    """BOOL expressions used as filter conditions (null -> dropped)."""
    return compare_cases()[::7] + logic_cases()


def expr_columns(rows: int, seed: int):
    """Random EXPR_SCHEMA columns with ~1/8 nulls and trap values:
    INT/LONG MIN/MAX, -1 and 0 (divisors), NaN, +-0.0, +-inf, huge
    floats. STRING columns are indices into EXPR_STRINGS (the caller
    maps them to dictionary codes). -> (cols, nulls, kind, valid)."""
    rng = np.random.default_rng(seed)
    traps = {
        AttrType.INT: [-(2 ** 31), 2 ** 31 - 1, -1, 0, 1, 7],
        AttrType.LONG: [-(2 ** 63), 2 ** 63 - 1, -1, 0, 3, 2 ** 40],
        AttrType.FLOAT: [np.nan, -0.0, 0.0, np.inf, -np.inf, 3.4e38,
                         100.0, 1e-3],
        AttrType.DOUBLE: [np.nan, -0.0, 0.0, np.inf, -np.inf, 1e300,
                          100.0, -1.0],
    }
    cols, nulls = [], []
    for _name, t in EXPR_SCHEMA:
        if t is AttrType.INT:
            v = rng.integers(-4, 5, rows).astype(np.int32)
        elif t is AttrType.LONG:
            v = rng.integers(-(2 ** 40), 2 ** 40, rows)
            v[rng.random(rows) < 0.3] %= 5
        elif t is AttrType.FLOAT:
            v = (rng.standard_normal(rows) * 150).astype(np.float32)
        elif t is AttrType.DOUBLE:
            v = rng.standard_normal(rows) * 1e3
        elif t is AttrType.BOOL:
            v = rng.integers(0, 2, rows).astype(np.bool_)
        else:
            v = rng.integers(0, len(EXPR_STRINGS), rows).astype(np.int32)
        if t in traps:
            tv = np.array(traps[t], dtype=v.dtype)
            pick = rng.random(rows) < 0.25
            v[pick] = tv[rng.integers(0, len(tv), int(pick.sum()))]
        cols.append(v)
        nulls.append(rng.random(rows) < 0.125)
    kind = rng.choice(np.array([0, 0, 0, 1, 2], np.int32), rows)
    valid = rng.random(rows) < 0.9
    return cols, nulls, kind, valid
