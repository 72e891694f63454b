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
            "f % -2.0f", "d % 1.0", "d % 0.5",
            # a subnormal constant divisor: NaN, not null; nested constant
            # subexpressions fold unflushed (ROADMAP Queue 3, repaired)
            "f % 1e-40f", "d % (1e-310 + 0.0)", "(1e-39f + 0.0f) * 1.0f",
            "(1e-39f + 1e-39f) * 2.0f", "f * (1e-39f + 0.0f)"]


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


# -- kernel K2's function calls (slice 8) -------------------------------------

def function_cases() -> list:
    """Every built-in and math:* function over EXPR_SCHEMA columns, with
    nulls from the columns and from division by zero, and constant
    arguments that fold at plan time."""
    conv = [f"convert({a}, '{t}')" for a in ("i", "l", "f", "d", "b")
            for t in ("int", "long", "float", "double")]
    conv += ["cast(d, 'float')", "cast(f, 'double')", "convert(s, 'string')",
             "convert(b, 'bool')", "convert(d / e, 'int')",
             "convert(3.7, 'int')", "convert(-3e9, 'int')",
             "cast(1e300, 'float')"]
    sel = ["coalesce(i, l)", "coalesce(i / j, l, d)", "coalesce(f, g)",
           "coalesce(s, t)", "coalesce(d / e, -1.0)", "coalesce(i / 0, j)",
           "coalesce(i / j, m / l)", "default(i / j, 0)", "default(f, d)",
           "default(s, t)", "default(d / 0.0, e)", "default(l / m, i / j)",
           "ifThenElse(b, i, l)", "ifThenElse(i > j, f, d)",
           "ifThenElse(b and c, s, t)", "ifThenElse(d > e, 'HIGH', 'LOW')",
           "ifThenElse(i / j > 0, d, e)", "ifThenElse(b, i / j, m / l)",
           "ifThenElse(true, i, j)"]
    ext = ["maximum(i, j)", "maximum(f, g, d)", "minimum(l, m)",
           "minimum(d, e, f)", "maximum(i / j, l, d / e)",
           "minimum(d / e, f, i / j)", "maximum(d, 1e-310)",
           "minimum(-0.0, d, 0.0)", "maximum(f, 1.0e-40f, g)",
           "maximum(1, 2.5)", "minimum(i / 0, j / 0)"]
    inst = ["instanceOfInteger(i)", "instanceOfLong(i / j)",
            "instanceOfLong(l / m)", "instanceOfFloat(f)",
            "instanceOfDouble(d / e)", "instanceOfBoolean(b)",
            "instanceOfString(s)", "instanceOfDouble(i)"]
    math = [f"math:{fn}({a})" for fn in ("abs", "ceil", "floor", "signum",
                                         "round")
            for a in ("i", "l", "f", "d", "d / e")]
    math += [f"math:{fn}({a})" for fn in ("sqrt", "exp", "ln", "log10",
                                          "sin", "cos", "tan", "asin",
                                          "acos", "atan")
             for a in ("d", "d / 1000.0", "f", "l")]
    math += ["math:power(d, e / 1000.0)", "math:power(f, 2)",
             "math:power(i, j)", "math:power(d / e, 0.5)", "math:sqrt(2)",
             "math:sin(1)", "math:ln(0.0)", "math:round(2.5)",
             "math:signum(-0.0)", "math:abs(-2147483648)"]
    sets = [f"createSet({a})" for a in ("i", "l", "f", "d", "b", "s",
                                        "d / e")]
    sets += [f"sizeOfSet(createSet({a}))" for a in ("i", "d / e", "s")]
    return conv + sel + ext + inst + math + sets + ["eventTimestamp()"]


def function_columns(rows: int, seed: int):
    """expr_columns with subnormals among the FLOAT and DOUBLE traps, as
    the function cases need them. -> (cols, nulls, kind, valid)."""
    cols, nulls, kind, valid = expr_columns(rows, seed)
    rng = np.random.default_rng(seed + 1)
    sub = {AttrType.FLOAT: np.array([1e-40, -1e-40, 1.17e-38, 0.5, 2.5],
                                    np.float32),
           AttrType.DOUBLE: np.array([5e-324, -1e-310, 2.5, -2.5, 0.5,
                                      4.5e15 + 0.5, -745.5, 710.0])}
    for k, (_n, t) in enumerate(EXPR_SCHEMA):
        if t in sub:
            pick = rng.random(rows) < 0.1
            cols[k][pick] = sub[t][rng.integers(0, len(sub[t]),
                                                int(pick.sum()))]
    return cols, nulls, kind, valid


# Function calls in every context a program runs in: each app's query
# 'q' reads stream S (FUNC_STREAM), or L and R, or the table T.
FUNC_STREAM = """
    define stream S (s string, i int, j int, l long, f float, d double,
                     b bool);"""
FUNC_APPS = {
    # kernel K2: a filter and a projection
    "filter_project": FUNC_STREAM + """
        @info(name = 'q')
        from S[instanceOfDouble(d) and maximum(f, d) > 0.0
               and coalesce(i / j, 1) != 0]
        select s, convert(l, 'int') as li, cast(d, 'float') as df,
               coalesce(l / i, -1L) as q, default(d / convert(i, 'double'),
               0.0) as r, ifThenElse(d > 1.0, 'HIGH', 'LOW') as hl,
               minimum(f, d) as mn, maximum(i, j, l) as mx,
               math:abs(d - f) as ad, math:round(d) as rd,
               math:floor(f) as fl, math:signum(i) as sg,
               eventTimestamp() as ts
        insert into Out;""",
    # K2's having program over an aggregating selector (K6)
    "having": FUNC_STREAM + """
        @info(name = 'q')
        from S#window.lengthBatch(8)
        select s, sum(l) as total, max(d) as top
        group by s
        having coalesce(total, 0L) > -5L and instanceOfDouble(top)
               and math:abs(top) >= 0.0
        insert into Out;""",
    # aggregator arguments (K2's pre-program, then K6)
    "aggregator_argument": FUNC_STREAM + """
        @info(name = 'q')
        from S#window.length(10)
        select sum(convert(l, 'double')) as sd, max(math:abs(i)) as mx,
               avg(coalesce(d / f, 0.0)) as av,
               min(ifThenElse(b, i, j)) as mn, count() as n
        insert into Out;""",
    # grouped (the group-by keys are attribute references in the grammar)
    "group_by": FUNC_STREAM + """
        @info(name = 'q')
        from S#window.length(20)
        select s, sum(maximum(i, j)) as m, min(math:floor(d)) as fl,
               convert(sum(l), 'int') as si
        group by s
        insert into Out;""",
    # a pattern on the round-parallel engine (kernel K3)
    "pattern_parallel": FUNC_STREAM + """
        @info(name = 'q')
        from every e1=S[math:abs(i) > 2] -> e2=S[maximum(e1.i, i) == i
                                               and coalesce(e1.s, 'x') == s]
        within 50 milliseconds
        select e1.i as a, e2.i as b, convert(e2.d, 'int') as c,
               minimum(e1.d, e2.d) as m
        insert into Out;""",
    # a pattern on the scan engine (kernel K4: a logical OR state)
    "pattern_scan": FUNC_STREAM + """
        @info(name = 'q')
        from every e1=S[ifThenElse(b, i, j) > 1]
             -> e2=S[math:round(d) > e1.d] or e3=S[instanceOfInteger(i)
                                                and j == e1.j]
        within 50 milliseconds
        select e1.i as a, e2.d as d2, e3.i as c
        insert into Out;""",
    # a join's ON condition (kernel K7)
    "join": """
        define stream L (k int, d double, s string);
        define stream R (k int, d double, s string);
        @info(name = 'q')
        from L#window.length(6) join R#window.length(5)
        on maximum(L.k, 0) == R.k and math:abs(L.d - R.d) < 50.0
           and eventTimestamp() % 3L != 0L
        select L.k as lk, R.d as rd, coalesce(L.d, R.d) as cd,
               ifThenElse(L.d > R.d, L.s, R.s) as hi
        insert into Out;""",
    # a table's conditions (kernel K8): an update-or-insert ON and a
    # stream-table join's ON
    "table": """
        define stream S (s string, i int, l long, d double);
        define stream Q (s string, k long);
        @cap('64') define table T (s string, v long, d double);
        @info(name = 'w')
        from S select s, convert(i, 'long') as v, math:abs(d) as d
        update or insert into T
        on T.s == s and coalesce(T.v, 0L) >= minimum(v, 0L)
           and eventTimestamp() > 0L;
        @info(name = 'q')
        from Q join T on T.s == Q.s and T.v > convert(Q.k, 'long') - 3L
           and eventTimestamp() % 2L == 0L
        select Q.s as s, T.v as v, maximum(T.d, 1.0) as m
        insert into Out;""",
}
# the feed's symbols (a prefix of their own: a test module aligns the two
# packages' codes for them)
FUNC_SYMS = ("FN_IBM", "FN_WSO2", "FN_GOOG", None)


def func_feed(n: int, seed: int):
    """Rows of FUNC_STREAM (1 ms apart from 1000): small ints with zeros
    (null divisions), NaN, +-0.0 and +-inf among the floats, nulls. ->
    [(ts, row)]."""
    rng = np.random.default_rng(seed)
    specials = [float("nan"), -0.0, 0.0, float("inf"), float("-inf")]
    rows = []
    for k in range(n):
        d = float(rng.standard_normal() * 50)
        f = float(np.float32(rng.standard_normal() * 10))
        if rng.random() < 0.15:
            d = specials[int(rng.integers(len(specials)))]
        row = [FUNC_SYMS[int(rng.integers(4))], int(rng.integers(-4, 5)),
               int(rng.integers(-3, 4)), int(rng.integers(-50, 50)), f, d,
               bool(rng.random() < 0.5)]
        if rng.random() < 0.1:
            row[int(rng.integers(1, 7))] = None
        rows.append((1000 + k, tuple(row)))
    return rows


def func_app_sends(name: str) -> list:
    """FUNC_APPS[name]'s feed as row sends: [(stream, [(ts, row)])]."""
    if name == "join":
        rng = np.random.default_rng(5)
        out = []
        for k in range(12):
            side = "L" if k % 2 == 0 else "R"
            rows = [(1000 + 8 * k + r, (int(rng.integers(-2, 4)),
                                        float(rng.standard_normal() * 40),
                                        FUNC_SYMS[int(rng.integers(3))]))
                    for r in range(8)]
            out.append((side, rows))
        return out
    if name == "table":
        rows = func_feed(96, seed=4)
        out = []
        for k in range(0, 96, 12):
            out.append(("S", [(ts, (r[0] or FUNC_SYMS[0], r[1], r[3], r[5]))
                              for ts, r in rows[k:k + 12]]))
            out.append(("Q", [(ts + 1000, (r[0] or FUNC_SYMS[1], r[3]))
                              for ts, r in rows[k:k + 6]]))
        return out
    rows = func_feed(160, seed=sorted(FUNC_APPS).index(name))
    return [("S", rows[k:k + 16]) for k in range(0, 160, 16)]


# -- kernel K3: pattern apps and feeds ---------------------------------------

# the reference bench's north-star app (bench.py SEQ5_APP)
SEQ5_APP = """
    @app:playback
    define stream T (sym string, stage int, v int);
    @info(name = 'q')
    from every e1=T[stage == 1] -> e2=T[stage == 2 and sym == e1.sym]
      -> e3=T[stage == 3 and sym == e1.sym]
      -> e4=T[stage == 4 and sym == e1.sym]
      -> e5=T[stage == 5 and sym == e1.sym]
    within 60 sec
    select e1.sym as sym, e1.v as v1, e5.v as v5
    insert into Out;
"""

# one stage-2 event completes every pending row: a feed can emit more
# matches in one step than the match batch holds
PAIR_APP = """
    @app:playback
    define stream T (sym string, stage int, v int);
    @info(name = 'q')
    from every e1=T[stage == 1] -> e2=T[stage == 2]
    select e1.v as v1, e2.v as v2
    insert into Out;
"""

_TWO_STREAMS = """
    @app:playback
    define stream S1 (symbol string, price float, volume int);
    define stream S2 (symbol string, price float, volume int);
"""

# armed once, two streams, a counting state whose rows answer the next
# state (the shape of the reference corpus's CountPattern testQuery6)
COUNT_APP = _TWO_STREAMS + """
    @info(name = 'q')
    from e1=S1[price > 20] <2:5> -> e2=S2[price > e1[1].price]
    select e1[0].price as p0, e1[1].price as p1, e1[4].price as p4,
           e2.price as p2
    insert into Out;
"""

# sequence mode (the first eligible event decides), a counting start,
# two streams
SEQ_APP = _TWO_STREAMS + """
    @info(name = 'q')
    from every e1=S1[price > 20]<1:4>, e2=S2[price > e1[0].price],
         e3=S1[price > 5]
    select e1[0].price as p0, e1[1].price as p1, e2.price as p2,
           e3.volume as v3
    insert into Out;
"""


class Seq5Feed:
    """bench.py bench_seq5's feed: symbols uniform over SYMS, stage in
    U[1, 6), v in U[0, 1000), one rng for the whole run (seed 12) and a
    clock that only moves forward from TS0, 1 ms a row. ``encode`` maps a
    symbol to its dictionary code."""

    def __init__(self, encode, seed: int = 12, ts0: int = TS0):
        self.rng = np.random.default_rng(seed)
        self.syms = np.array([encode(s) for s in SYMS], np.int32)
        self.clock = ts0

    def next(self, m: int, stages=None):
        """-> (ts, [sym codes, stage, v]) of the next m rows; ``stages``
        replaces the random stages (the v and sym draws stay)."""
        ts = self.clock + np.arange(m, dtype=np.int64)
        self.clock += m
        sym = self.syms[self.rng.integers(0, len(self.syms), m)]
        stage = self.rng.integers(1, 6, m).astype(np.int32)
        v = self.rng.integers(0, 1000, m).astype(np.int32)
        if stages is not None:
            stage = np.asarray(stages, np.int32)
        return ts, [sym, stage, v]


def out_overflow_stages(pb: int = 4096) -> np.ndarray:
    """Stages for PAIR_APP that emit more than 16,384 matches in one
    step of five sub-batches: fill the table, fire it with the
    sub-batch's own spawns, fill, fire, fire."""
    fill = [1] * pb
    fire = [1] * (pb - 1) + [2]
    return np.array(fill + fire + fill + fire + fire, np.int32)


def two_stream_feed(n: int, encode, seed: int):
    """Random (stream, row) events for COUNT_APP and SEQ_APP: price in
    U(0, 60) float32 (about a third at or under 20), volume U[0, 100).
    -> (stream per event, ts, [symbol codes, price, volume])."""
    rng = np.random.default_rng(seed)
    syms = np.array([encode(s) for s in SYMS], np.int32)
    stream = np.where(rng.random(n) < 0.5, "S1", "S2")
    ts = TS0 + np.arange(n, dtype=np.int64)
    cols = [syms[rng.integers(0, len(syms), n)],
            rng.uniform(0, 60, n).astype(np.float32),
            rng.integers(0, 100, n).astype(np.int32)]
    return stream, ts, cols

# the counting chain with an always-armed start: one spawned row per
# matching S1 event, each absorbing up to five (chip_smoke.py's scale
# version of COUNT_APP)
COUNT_EVERY_APP = _TWO_STREAMS + """
    @info(name = 'q')
    from every e1=S1[price > 20] <1:5> -> e2=S2[price > e1[1].price]
    select e1[0].price as p0, e1[1].price as p1, e2.price as p2
    insert into Out;
"""

# a start state with no condition and a final counting state (a match
# is emitted at the minimum, its copies past the count null)
FINAL_COUNT_APP = _TWO_STREAMS + """
    @info(name = 'q')
    from every e1=S2 -> e2=S1[price > 20] <2:3>
    select e1.price as p1, e2[0].price as q0, e2[1].price as q1,
           e2[2].price as q2
    insert into Out;
"""

# a counting state whose minimum is 0: its rows answer the next state
# from birth
COUNT0_APP = _TWO_STREAMS + """
    @info(name = 'q')
    from e1=S1[price > 20] <0:5> -> e2=S2[price > 10]
    select e1[0].price as p0, e1[1].price as p1, e2.price as p2
    insert into Out;
"""

# single-state patterns: every hit emits at once (a plain start), or at
# its minimum with its copies past the count null (a counting start)
SINGLE_APP = _TWO_STREAMS + """
    @info(name = 'q')
    from every e1=S1[price > 30]
    select e1.symbol as s, e1.price as p
    insert into Out;
"""

SINGLE_COUNT_APP = _TWO_STREAMS + """
    @info(name = 'q')
    from every e1=S1[price > 20] <1:3>
    select e1[0].price as p0, e1[1].price as p1, e1[2].price as p2
    insert into Out;
"""


# -- kernel K4: the scan engine's apps and feeds ------------------------------

# a request/response timeout alert, the canonical absent pattern: a
# request not answered within 100 ms raises an alert at its deadline
TIMEOUT_APP = """
    @app:playback
    define stream Ev (rid long, kind int, svc int);
    @info(name = 'q')
    from every e1=Ev[kind == 0] -> not Ev[kind == 1 and rid == e1.rid]
         for 100 milliseconds
    select e1.rid as rid, e1.svc as svc
    insert into Timeouts;
"""

TIMEOUT_MS = 100


def timeout_feed(n: int, seed: int = 5, p_answer: float = 0.95):
    """TIMEOUT_APP's feed: request i (kind 0, rid i, svc ~ U[0, 16)) sits
    at slot 2i; with probability ``p_answer`` its response (kind 1, same
    rid) sits at slot 2i + U[1, 130] + 0.5. The events are merged by slot and
    the first n kept; event k has ts TS0 + k (1 ms apart).
    -> (ts, [rid int64, kind int32, svc int32])."""
    rng = np.random.default_rng(seed)
    svc = rng.integers(0, 16, n).astype(np.int32)
    answered = rng.random(n) < p_answer
    delay = rng.integers(1, 131, n)
    rid = np.arange(n, dtype=np.int64)
    slot = np.concatenate([2.0 * rid, 2.0 * rid[answered]
                           + delay[answered] + 0.5])
    order = np.argsort(slot, kind="stable")[:n]
    rids = np.concatenate([rid, rid[answered]])[order]
    kind = np.concatenate([np.zeros(n, np.int32),
                           np.ones(int(answered.sum()), np.int32)])[order]
    ts = TS0 + np.arange(n, dtype=np.int64)
    return ts, [rids, kind, svc[rids]]


def timeout_oracle(ts, rid, kind, svc, wait_ms: int = TIMEOUT_MS):
    """TIMEOUT_APP's alerts, independently of the engine, for a feed sent
    through send_arrays: request e alerts at t + wait iff no response
    with its rid arrives at or before t + wait, and that deadline lies
    before the last event's ts (a deadline at or after it has not fired
    yet). Alerts come in request order. -> (alert rids, svcs, ts, number
    of requests still waiting at the end)."""
    req = kind == 0
    resp_ts = np.full(int(rid.max()) + 1 if len(rid) else 0,
                      np.iinfo(np.int64).max, np.int64)
    r = ~req
    np.minimum.at(resp_ts, rid[r], ts[r])
    t_req, r_req = ts[req], rid[req]
    due = t_req + wait_ms
    unanswered = resp_ts[r_req] > due
    last = ts[-1]
    fired = unanswered & (due < last)
    live = (due >= last) & (resp_ts[r_req] > last)
    return r_req[fired], svc[req][fired], due[fired], int(live.sum())


def timeout_burst_feed(bursts: int = 3, size: int = 128, gap_ms: int = 150):
    """TIMEOUT_APP events that fire more deadlines in one step than the
    256-row match batch holds: ``bursts`` runs of ``size`` unanswered
    requests, 1 ms apart, each followed ``gap_ms`` later by a response
    to no request (rid -1), which fires the run's deadlines at once.
    -> (ts, [rid, kind, svc])."""
    ts, rid, kind = [], [], []
    t = TS0
    for b in range(bursts):
        for i in range(size):
            ts.append(t)
            rid.append(b * size + i)
            kind.append(0)
            t += 1
        t += gap_ms
        ts.append(t)
        rid.append(-1)
        kind.append(1)
        t += 1
    n = len(ts)
    return (np.array(ts, np.int64), [np.array(rid, np.int64),
                                     np.array(kind, np.int32),
                                     (np.arange(n) % 16).astype(np.int32)])


_THREE_STREAMS = _TWO_STREAMS + """
    define stream S3 (symbol string, price float, volume int);
"""

# the scan engine's shapes beside TIMEOUT_APP, on three streams: an
# every-scoped absent start that re-arms on its deadline; an AND group
# with an absent partner; an OR group; an OR of two absent lanes in mid
# chain (both deadline lanes, forwarded clones); a sequence whose
# every-scoped start re-arms each round, with an AND group (stabilize
# kills); a counting state whose condition reads its own slot; and a
# `within` expiry that re-arms its every scope
SCAN_APPS = {
    "every absent": _THREE_STREAMS + """
    @info(name = 'q')
    from every not S1[price > 50] for 30 milliseconds -> e2=S2[price > 40]
    select e2.symbol as s, e2.price as p
    insert into Out;
""",
    "and, absent partner": _THREE_STREAMS + """
    @info(name = 'q')
    from every e1=S1[price > 30] -> not S2[price > e1.price]
         for 20 milliseconds and e3=S3[price > 30]
    select e1.symbol as s, e1.price as p1, e3.price as p3
    insert into Out;
""",
    "or": _THREE_STREAMS + """
    @info(name = 'q')
    from every e1=S1[price > 30] -> e2=S2[price > e1.price]
         or e3=S3[volume > 80]
    select e1.price as p1, e2.price as p2, e3.volume as v3
    insert into Out;
""",
    "or of two absents": _THREE_STREAMS + """
    @info(name = 'q')
    from every e1=S1[price > 50] -> (not S2[price > e1.price]
         for 20 milliseconds or not S3[price > e1.price] for 30 milliseconds)
         -> e4=S1[price > 55]
    select e1.price as p1, e4.price as p4
    insert into Out;
""",
    "sequence": _THREE_STREAMS + """
    @info(name = 'q')
    from every e1=S1[price > 20], e2=S2[price > e1.price]
         and e3=S3[price > 10]
    select e1.price as p1, e2.price as p2, e3.price as p3
    insert into Out;
""",
    "self-referring count": _THREE_STREAMS + """
    @info(name = 'q')
    from every e1=S1[price > 40] -> e2=S2[price >= e2[0].price]<2:4>
         -> e3=S1[price > e2[1].price]
    select e1.price as p1, e2[0].price as q0, e2[1].price as q1,
           e2[3].price as q3, e3.price as p3
    insert into Out;
""",
    "within re-arm": _THREE_STREAMS + """
    @info(name = 'q')
    from every (e1=S1[price > 20] -> e2=S2[price > e1.price])
         within 10 milliseconds
    select e1.price as p1, e2.price as p2
    insert into Out;
""",
}

# a 5-second wait: with half the requests unanswered
# (timeout_feed(p_answer=0.5)), live requests outgrow the 128-row table
TABLE_OVERFLOW_APP = TIMEOUT_APP.replace("100 milliseconds",
                                         "5000 milliseconds")


def three_stream_feed(n: int, encode, seed: int, gap_ms: int = 1):
    """Random (stream, row) events over S1, S2, S3 for SCAN_APPS: price
    in U(0, 60) float32, volume U[0, 100); the clock moves 1 to
    ``gap_ms`` ms an event. -> (stream per event, ts, [symbol codes,
    price, volume])."""
    rng = np.random.default_rng(seed)
    syms = np.array([encode(s) for s in SYMS], np.int32)
    stream = np.array(["S1", "S2", "S3"])[rng.integers(0, 3, n)]
    ts = TS0 + np.cumsum(rng.integers(1, gap_ms + 1, n)).astype(np.int64)
    cols = [syms[rng.integers(0, len(syms), n)],
            rng.uniform(0, 60, n).astype(np.float32),
            rng.integers(0, 100, n).astype(np.int32)]
    return stream, ts, cols


# -- kernels K5 and K6: windows and aggregation -----------------------------

# bench.py bench_window_agg's app, verbatim: a tumbling count window and a
# global aggregate, one output row per flush (the last of the chunk)
WINDOW_AGG_APP = """
        @app:playback
        define stream StockStream (symbol string, price float, volume long);
        @info(name = 'q')
        from StockStream#window.lengthBatch(1000)
        select avg(price) as ap, sum(volume) as sv
        insert into OutputStream;
    """


def window_time_app(span: str = "1 min", cap: int = 65536) -> str:
    """The sliding, grouped aggregation of Siddhi's documentation
    (TimeWindowTestCase): one output row per event. The tests cut its
    span and window capacity; the shapes stay."""
    return f"""
    @app:playback
    define stream StockStream (symbol string, price float, volume long);
    @info(name='q') @cap(window.size='{cap}')
    from StockStream#window.time({span})
    select symbol, avg(price) as ap, sum(volume) as sv, count() as n
    group by symbol
    insert into OutputStream;
"""


WINDOW_TIME_APP = window_time_app()
WINDOW_TIME_MS = 60_000
WINDOW_TIME_SYMS = 512


def window_agg_feed(n: int, encode, seed: int = 8):
    """bench_window_agg's feed: as filter_feed, seed 8."""
    return filter_feed(n, encode, seed=seed)


def window_agg_oracle(price, volume, length: int = 1000):
    """WINDOW_AGG_APP's rows, independently of the engine: one per
    complete batch of ``length`` events, (mean price as float64, volume
    sum). -> (ap, sv)."""
    k = len(price) // length
    p = price[:k * length].astype(np.float64).reshape(k, length)
    v = volume[:k * length].reshape(k, length)
    return p.mean(axis=1), v.sum(axis=1)


def time_symbols(n_syms: int, prefix: str = "K") -> list:
    return [f"{prefix}{i:04d}" for i in range(n_syms)]


def window_time_feed(n: int, encode, seed: int = 10,
                     n_syms: int = WINDOW_TIME_SYMS, prefix: str = "K"):
    """WINDOW_TIME_APP's feed: symbols drawn uniformly from ``n_syms``,
    timestamps TS0 + k (1 ms apart), price ~ U(0, 200) float32, volume ~
    U[1, 1000) int64. -> (ts, [symbol codes, price, volume])."""
    rng = np.random.default_rng(seed)
    syms = np.array([encode(s) for s in time_symbols(n_syms, prefix)],
                    np.int32)
    ts = TS0 + np.arange(n, dtype=np.int64)
    sym = syms[rng.integers(0, n_syms, n)]
    price = rng.uniform(0, 200, n).astype(np.float32)
    vol = rng.integers(1, 1000, n, dtype=np.int64)
    return ts, [sym, price, vol]


def window_time_oracle(ts, sym, price, volume, span_ms: int = WINDOW_TIME_MS):
    """WINDOW_TIME_APP's rows, independently of the engine: one per
    event, over the events of its symbol still in the window. An event at
    t leaves at the first event whose ts reaches t + span (its EXPIRED row
    precedes that event's CURRENT row), so event i's window is the
    same-symbol events j <= i with ts[j] + span > ts[i].
    -> (symbol codes, ap, sv, n), in event order."""
    n = len(ts)
    first = np.searchsorted(ts, ts - span_ms, side="right")
    ap = np.empty(n, np.float64)
    sv = np.empty(n, np.int64)
    cnt = np.empty(n, np.int64)
    for s in np.unique(sym):
        idx = np.flatnonzero(sym == s)
        cp = np.concatenate([[0.0], np.cumsum(price[idx].astype(np.float64))])
        cv = np.concatenate([[0], np.cumsum(volume[idx])])
        lo = np.searchsorted(idx, first[idx], side="left")
        hi = np.arange(1, len(idx) + 1)
        cnt[idx] = hi - lo
        sv[idx] = cv[hi] - cv[lo]
        ap[idx] = (cp[hi] - cp[lo]) / (hi - lo)
    return sym, ap, sv, cnt


# comparison apps for K5 and K6: every window kind, the aggregator kinds
# and the selector's options, over one stream
_CMP_STREAM = """
    @app:playback
    define stream S (sym string, price float, volume long, flag bool);
"""
WINDOW_APPS = {
    "time, grouped, all events": _CMP_STREAM + """
        @info(name = 'q') @cap(window.size='256')
        from S#window.time(40 milliseconds)
        select sym, avg(price) as ap, sum(volume) as sv, count() as n,
               stdDev(price) as sd
        group by sym
        insert all events into Out;
    """,
    "length, having": _CMP_STREAM + """
        @info(name = 'q')
        from S#window.length(50)
        select sym, sum(price) as sp, count() as n,
               minForever(price) as mn, maxForever(volume) as mx
        group by sym
        having n > 1
        insert all events into Out;
    """,
    "length(0), expired": _CMP_STREAM + """
        @info(name = 'q')
        from S[volume > 100]#window.length(0)
        select sym, sum(volume) as sv
        insert expired events into Out;
    """,
    "lengthBatch, grouped": _CMP_STREAM + """
        @info(name = 'q')
        from S#window.lengthBatch(64)
        select sym, avg(price) as ap, max(price) as mx, min(volume) as mn,
               count() as n, and(flag) as a, or(flag) as o
        group by sym
        insert into Out;
    """,
    "lengthBatch, stream current": _CMP_STREAM + """
        @info(name = 'q')
        from S#window.lengthBatch(8, true)[price > 20.0]
        select sym, sum(volume) as sv, count() as n
        group by sym
        insert all events into Out;
    """,
    "lengthBatch, reset heavy": _CMP_STREAM + """
        @info(name = 'q')
        from S#window.lengthBatch(2)
        select avg(price) as ap, sum(volume) as sv, count() as n,
               stdDev(price) as sd
        insert all events into Out;
    """,
    "timeBatch, start time": _CMP_STREAM + """
        @info(name = 'q') @cap(window.size='256')
        from S#window.timeBatch(30 milliseconds, 5)
        select sym, sum(volume) as sv, avg(price) as ap, count() as n
        group by sym
        insert all events into Out;
    """,
    "timeBatch, stream current": _CMP_STREAM + """
        @info(name = 'q') @cap(window.size='256')
        from S#window.timeBatch(25 milliseconds, true)
        select sym, price, volume
        insert all events into Out;
    """,
    "time, offset and limit": _CMP_STREAM + """
        @info(name = 'q') @cap(window.size='256')
        from S#window.time(20 milliseconds)
        select sym, sum(price) as sp, count() as n
        group by sym
        having sp > 100.0
        limit 3 offset 1
        insert into Out;
    """,
}

# more events inside the time span than @cap(window.size) rows: the
# window drops the oldest and counts them
WINDOW_OVERFLOW_APP = _CMP_STREAM + """
    @info(name = 'q') @cap(window.size='64')
    from S#window.time(500 milliseconds)
    select sym, sum(volume) as sv, count() as n
    group by sym
    insert into Out;
"""

# more distinct keys than the 1,024-slot group table: overflowed rows are
# counted and left out
KEYS_OVERFLOW_APP = _CMP_STREAM + """
    @info(name = 'q')
    from S#window.length(4096)
    select sym, sum(volume) as sv, count() as n
    group by sym
    insert into Out;
"""


def window_feed(n: int, encode, seed: int, n_syms: int = 16,
                gap_ms: int = 3, prefix: str = "K"):
    """Events for the comparison apps: symbols uniform over ``n_syms``,
    timestamps rising by U[0, gap_ms] ms (equal timestamps included),
    price ~ U(0, 200) float32 with a few exact repeats, volume ~
    U[1, 1000) int64, flag ~ Bernoulli(0.5). -> (ts, [sym codes, price,
    volume, flag])."""
    rng = np.random.default_rng(seed)
    syms = np.array([encode(s) for s in time_symbols(n_syms, prefix)],
                    np.int32)
    ts = TS0 + np.cumsum(rng.integers(0, gap_ms + 1, n)).astype(np.int64)
    sym = syms[rng.integers(0, n_syms, n)]
    price = rng.uniform(0, 200, n).astype(np.float32)
    price[rng.random(n) < 0.1] = np.float32(50.0)
    vol = rng.integers(1, 1000, n, dtype=np.int64)
    flag = rng.random(n) < 0.5
    return ts, [sym, price, vol, flag]


# -- kernels K7 and K8: joins and tables --------------------------------------

# bench.py's join app (``_run_join_inner``), verbatim at the bench's
# capacities: two one-second sliding windows joined on the symbol
JOIN_APP = """
    @app:playback
    define stream StockStream (symbol string, price float);
    define stream TwitterStream (symbol string, tweets int);
    @info(name = 'q') @cap(window.size='1024', join.pairs='131072')
    from StockStream#window.time(1 sec) join TwitterStream#window.time(1 sec)
    on StockStream.symbol == TwitterStream.symbol
    select StockStream.symbol, price, tweets
    insert into OutputStream;
"""
JOIN_SYMS = 1024        # bench.py bench_join
JOIN_EQ_SYMS = 8192     # bench.py bench_join_eq
JOIN_SPAN_MS = 1000


def join_symbols(n_syms: int, prefix: str = "SYM") -> list:
    return [f"{prefix}{i:05d}" for i in range(n_syms)]


def join_feed(n_syms: int, sends: int, rows: int, encode, seed: int = 9,
              prefix: str = "SYM"):
    """The join bench's feed (bench.py ``_run_join_inner``): per send i
    both sides get timestamps TS0 + i * rows + arange(rows) and the same
    symbols, uniform over ``n_syms``; StockStream a price ~ U(0, 200)
    float32, TwitterStream tweets ~ U[0, 50) int32. -> a list of sends
    (ts, symbol codes, price, tweets), StockStream's sent first."""
    rng = np.random.default_rng(seed)
    syms = np.array([encode(s) for s in join_symbols(n_syms, prefix)],
                    np.int32)
    out = []
    for i in range(sends):
        ts = TS0 + np.arange(rows, dtype=np.int64) + i * rows
        sym = syms[rng.integers(0, len(syms), rows)]
        price = rng.uniform(0, 200, rows).astype(np.float32)
        tweets = rng.integers(0, 50, rows).astype(np.int32)
        out.append((ts, sym, price, tweets))
    return out


def join_oracle(sends, span_ms: int = JOIN_SPAN_MS, cap: int = 1024):
    """The join's rows, in emission order, for sends made StockStream then
    TwitterStream, each in one columnar step. The opposite window at the
    start of a step holds the newest rows (up to ``cap``) of those with
    ts + span > the app's clock; a trigger row's pairs are the opposite
    rows of its symbol with ts + span >= its own ts, in buffer (arrival)
    order. Only CURRENT rows reach the output.
    -> (symbol codes, price, tweets)."""
    sides = {"S": [], "T": []}       # arrived (ts, sym, value) arrays
    out_sym, out_price, out_tw = [], [], []
    clock = None

    def content(side):
        if not sides[side] or clock is None:
            return (np.zeros(0, np.int64), np.zeros(0, np.int32),
                    np.zeros(0))
        ts = np.concatenate([a[0] for a in sides[side]])
        sym = np.concatenate([a[1] for a in sides[side]])
        val = np.concatenate([a[2] for a in sides[side]])
        keep = np.nonzero(ts + span_ms > clock)[0][-cap:]
        return ts[keep], sym[keep], val[keep]

    for ts, sym, price, tweets in sends:
        for side, val in (("S", price), ("T", tweets)):
            opp = "T" if side == "S" else "S"
            o_ts, o_sym, o_val = content(opp)
            for i in range(len(ts)):
                hit = np.nonzero((o_sym == sym[i])
                                 & (o_ts + span_ms >= ts[i]))[0]
                if not len(hit):
                    continue
                out_sym.append(np.full(len(hit), sym[i], np.int32))
                if side == "S":
                    out_price.append(np.full(len(hit), price[i], np.float32))
                    out_tw.append(o_val[hit].astype(np.int32))
                else:
                    out_price.append(o_val[hit].astype(np.float32))
                    out_tw.append(np.full(len(hit), tweets[i], np.int32))
            sides[side].append((ts, sym, val))
            clock = int(ts[-1])
    cat = lambda parts, dt: np.concatenate(parts) if parts else \
        np.zeros(0, dt)  # noqa: E731
    return cat(out_sym, np.int32), cat(out_price, np.float32), \
        cat(out_tw, np.int32)


# the stock table: Siddhi's documented table usage (an upsert keyed by a
# primary key, read by a stream-table join)
STOCK_TABLE_APP = """
    @app:playback
    define stream StockStream (symbol string, price float, volume long);
    define stream CheckStockStream (symbol string, qty int);
    @PrimaryKey('symbol')
    define table StockTable (symbol string, price float, volume long);
    @info(name = 'upsert') from StockStream select symbol, price, volume
    update or insert into StockTable
      set StockTable.price = price, StockTable.volume = volume
      on StockTable.symbol == symbol;
    @info(name = 'lookup') @cap(join.pairs='16384')
    from CheckStockStream join StockTable
      on CheckStockStream.symbol == StockTable.symbol
    select CheckStockStream.symbol as symbol, qty,
           StockTable.price as price, StockTable.volume as volume
    insert into OutputStream;
"""
STOCK_SYMS = 8000


def stock_table_feed(n_syms: int, rounds: int, rows: int, encode,
                     seed: int = 11, prefix: str = "STK"):
    """stock_table's feed: one load send of the ``n_syms`` distinct
    symbols into StockTable, then ``rounds`` of a StockStream send and a
    CheckStockStream send of ``rows`` rows each, symbols uniform over the
    table's; timestamps 1 ms apart across both streams; price ~ U(0, 200)
    float32, volume ~ U[1, 10^6) int64, qty ~ U[1, 1000) int32.
    -> a list of (stream, ts, columns)."""
    rng = np.random.default_rng(seed)
    syms = np.array([encode(s) for s in join_symbols(n_syms, prefix)],
                    np.int32)
    t = TS0

    def span(n):
        nonlocal t
        ts = t + np.arange(n, dtype=np.int64)
        t += n
        return ts

    def stock(sym):
        n = len(sym)
        return [sym, rng.uniform(0, 200, n).astype(np.float32),
                rng.integers(1, 10 ** 6, n, dtype=np.int64)]

    out = [("StockStream", span(n_syms), stock(syms.copy()))]
    for _ in range(rounds):
        out.append(("StockStream", span(rows),
                    stock(syms[rng.integers(0, n_syms, rows)])))
        out.append(("CheckStockStream", span(rows),
                    [syms[rng.integers(0, n_syms, rows)],
                     rng.integers(1, 1000, rows).astype(np.int32)]))
    return out


def stock_table_oracle(feed):
    """Last writer wins per symbol in event order, read at each check
    send: -> (symbol codes, qty, price, volume) of the output rows, one
    per check row, in order."""
    price, volume = {}, {}
    out = [[], [], [], []]
    for stream, _ts, cols in feed:
        if stream == "StockStream":
            for s, p, v in zip(*cols):
                price[int(s)], volume[int(s)] = p, v
        else:
            sym, qty = cols
            out[0].append(sym)
            out[1].append(qty)
            out[2].append(np.array([price[int(s)] for s in sym], np.float32))
            out[3].append(np.array([volume[int(s)] for s in sym], np.int64))
    return tuple(np.concatenate(o) for o in out)


# comparison apps for K7: every join type, unidirectional, a windowless
# side, a residual conjunct, a non-equi ON, float-key traps, null keys,
# JOIN_CAP and candidate overflow, an aggregating selector. Streams L and
# R; `Out` collects the rows. Fed by join_shape_feed (row sends).
_JOIN_LR = """
    @app:playback
    define stream L (k string, a int, x double);
    define stream R (k string, b int, y double);
"""
_JOIN_SEL = "select L.k as lk, a, x, R.k as rk, b, y"
JOIN_APPS = {
    "inner_length": _JOIN_LR + f"""
        @info(name = 'q') from L#window.length(6) join R#window.length(5)
        on L.k == R.k {_JOIN_SEL} insert all events into Out;""",
    "left_outer_time": _JOIN_LR + f"""
        @info(name = 'q') @cap(window.size='64')
        from L#window.time(40) left outer join
        R#window.time(30) on L.k == R.k {_JOIN_SEL}
        insert all events into Out;""",
    "right_outer": _JOIN_LR + f"""
        @info(name = 'q') from L#window.length(4) right outer join
        R#window.length(7) on L.k == R.k {_JOIN_SEL} insert into Out;""",
    "full_outer_batch": _JOIN_LR + f"""
        @info(name = 'q') @cap(window.size='64')
        from L#window.lengthBatch(4) full outer join
        R#window.timeBatch(25) on L.k == R.k {_JOIN_SEL}
        insert all events into Out;""",
    "unidirectional": _JOIN_LR + f"""
        @info(name = 'q') from L#window.length(5) unidirectional join
        R#window.length(5) on L.k == R.k {_JOIN_SEL} insert into Out;""",
    "windowless": _JOIN_LR + f"""
        @info(name = 'q') from L join R#window.length(6)
        on L.k == R.k {_JOIN_SEL} insert into Out;""",
    "residual": _JOIN_LR + f"""
        @info(name = 'q') @cap(window.size='64')
        from L#window.length(8) join R#window.time(50)
        on L.k == R.k and a < b and x != y {_JOIN_SEL} insert into Out;""",
    "non_equi": _JOIN_LR + f"""
        @info(name = 'q') from L#window.length(4) join R#window.length(4)
        on L.a < R.b {_JOIN_SEL} insert into Out;""",
    "no_on": _JOIN_LR + f"""
        @info(name = 'q') from L#window.length(3) join R#window.length(2)
        {_JOIN_SEL} insert into Out;""",
    "expression_key": _JOIN_LR + f"""
        @info(name = 'q') from L#window.length(6) join R#window.length(6)
        on L.a + 1 == R.b {_JOIN_SEL} insert into Out;""",
    "join_cap": _JOIN_LR + f"""
        @info(name = 'q') @cap(join.pairs='8')
        from L#window.length(8) join R#window.length(8)
        on L.k == R.k {_JOIN_SEL} insert all events into Out;""",
    "candidate_cap": _JOIN_LR + f"""
        @info(name = 'q') @cap(join.pairs='64', join.candidates='6')
        from L#window.length(8) join R#window.length(8)
        on L.k == R.k and a != b {_JOIN_SEL} insert into Out;""",
    "aggregating": _JOIN_LR + """
        @info(name = 'q') from L#window.length(6) join R#window.length(6)
        on L.k == R.k select L.k as k, sum(b) as sb, count() as n
        group by L.k insert into Out;""",
}

# float-key traps: +-0.0, NaN of both signs, +-inf, subnormals, a live
# key equal to the pad value, LONG against DOUBLE (the lossy cast)
_FK = """
    @app:playback
    define stream L (k {lt}, a int);
    define stream R (k {rt}, b int);
    @info(name = 'q') from L#window.length(8) join R#window.length(8)
    on L.k == R.k select L.k as lk, a, R.k as rk, b insert into Out;
"""
FLOAT_KEY_APPS = {
    "double_keys": _FK.format(lt="double", rt="double"),
    "float_keys": _FK.format(lt="float", rt="float"),
    "long_double_keys": _FK.format(lt="long", rt="double"),
    "int_keys": _FK.format(lt="int", rt="int"),
}
JOIN_APPS.update(FLOAT_KEY_APPS)

_NAN_BITS = (0x7FF8000000000123, -0x0007FFFFFFFFFABD)


def float_key_values(t: str) -> list:
    """The trap keys of a key type (python values; NaNs with payloads)."""
    import struct
    if t == "double":
        nans = [struct.unpack("<d", struct.pack("<q", b))[0]
                for b in _NAN_BITS]
        return [0.0, -0.0, *nans, float("inf"), float("-inf"), 5e-324,
                -5e-324, 2.2e-308, 1.0, 2.0, float(2 ** 53 + 1)]
    if t == "float":
        return [0.0, -0.0, float("nan"), -float("nan"), float("inf"),
                float("-inf"), 1e-45, -1e-45, 1.0, 2.0]
    if t == "long":
        return [0, 1, 2, -1, 2 ** 53, 2 ** 53 + 1, 2 ** 63 - 1, -(2 ** 63)]
    return [0, 1, -1, 2 ** 31 - 1, -(2 ** 31), 7]


JOIN_SHAPE_KEYS = ("JIBM", "JWSO2", "JGOOG", "JMSFT")


def join_shape_feed(app: str, n: int, seed: int):
    """Row sends for a JOIN_APPS app: ``n`` events alternating between L
    and R in sends of 1 to 5 events, timestamps rising by 0 to 7 ms;
    keys over the four symbols of JOIN_SHAPE_KEYS with some nulls (the
    float-key apps: their trap keys); ints with nulls. -> a list of
    (stream, [(ts, row)])."""
    rng = np.random.default_rng(seed)
    fk = app in FLOAT_KEY_APPS
    if fk:
        kinds = {"double_keys": ("double", "double"),
                 "float_keys": ("float", "float"),
                 "long_double_keys": ("long", "double"),
                 "int_keys": ("int", "int")}[app]
        vals = {s: float_key_values(t) for s, t in zip("LR", kinds)}
        if app == "long_double_keys":   # the same numbers on both sides
            vals["R"] = [float(v) for v in vals["L"]]
    keys = JOIN_SHAPE_KEYS
    t = TS0
    out, done = [], 0
    while done < n:
        side = "L" if len(out) % 2 == 0 else "R"
        m = int(rng.integers(1, 6))
        rows = []
        for _ in range(m):
            t += int(rng.integers(0, 8))
            if fk:
                k = vals[side][int(rng.integers(0, len(vals[side])))]
                rows.append((t, (k, int(rng.integers(0, 9)))))
                continue
            k = None if rng.random() < 0.1 else \
                keys[int(rng.integers(0, len(keys)))]
            v = None if rng.random() < 0.1 else int(rng.integers(0, 9))
            rows.append((t, (k, v, float(rng.integers(0, 4)) / 2)))
        out.append((side, rows))
        done += m
    return out


# comparison apps for K8: inserts, deletes through the condition pass and
# an @Index probe, updates with and without SET, update or insert,
# primary-key duplicates in one batch, IN-table filters through the
# condition pass and an index, a table past its capacity. Streams S
# (writes), D (deletes and updates), C (reads); `Out` collects C's rows.
_TABLE_STREAMS = """
    @app:playback
    define stream S (k string, a int, x double);
    define stream D (k string, a int, x double);
    define stream C (k string, a int);
"""
_FILL = "@info(name = 'fill') from S select k, a, x insert into T;"
_READ = """@info(name = 'q') from C join T on C.k == T.k
    select C.k as k, C.a as ca, T.a as ta, T.x as tx insert into Out;"""
TABLE_APPS = {
    "insert_read": _TABLE_STREAMS + f"""
        @cap('64') define table T (k string, a int, x double);
        {_FILL} {_READ}""",
    "delete_grid": _TABLE_STREAMS + f"""
        @cap('64') define table T (k string, a int, x double);
        {_FILL} {_READ}
        @info(name = 'del') from D delete T on T.k == k and T.a < a;""",
    "delete_bare_name": _TABLE_STREAMS + f"""
        @cap('64') define table T (k string, a int, x double);
        {_FILL} {_READ}
        @info(name = 'del') from D delete T on k == T.k;""",
    "delete_index": _TABLE_STREAMS + f"""
        @Index('a') @cap('64') define table T (k string, a int, x double);
        {_FILL} {_READ}
        @info(name = 'del') from D delete T on T.a >= a;""",
    "update_set": _TABLE_STREAMS + f"""
        @cap('64') define table T (k string, a int, x double);
        {_FILL} {_READ}
        @info(name = 'upd') from D update T
          set T.x = T.x + x, T.a = a on T.k == k;""",
    "update_noset": _TABLE_STREAMS + f"""
        @cap('64') define table T (k string, a int, x double);
        {_FILL} {_READ}
        @info(name = 'upd') from D select k, a, x update T on T.k == k;""",
    "upsert_pk": _TABLE_STREAMS + f"""
        @PrimaryKey('k') @cap('64') define table T (k string, a int, x double);
        {_READ}
        @info(name = 'ups') from S select k, a, x update or insert into T
          set T.a = a, T.x = x on T.k == k;""",
    "pk_duplicates": _TABLE_STREAMS + f"""
        @PrimaryKey('k') @cap('64') define table T (k string, a int, x double);
        {_FILL} {_READ}""",
    "in_grid": _TABLE_STREAMS + """
        @cap('64') define table T (k string, a int, x double);
        @info(name = 'fill') from S select k, a, x insert into T;
        @info(name = 'q') from C[(T.k == k and T.a > a) in T]
        select k, a insert into Out;""",
    "in_index": _TABLE_STREAMS + """
        @Index('k') @cap('64') define table T (k string, a int, x double);
        @info(name = 'fill') from S select k, a, x insert into T;
        @info(name = 'q') from C[(T.k == k) in T] select k, a insert into Out;""",
    "over_capacity": _TABLE_STREAMS + f"""
        @cap('6') define table T (k string, a int, x double);
        {_FILL} {_READ}""",
}


def table_shape_feed(n: int, seed: int, n_keys: int = 6):
    """Row sends for a TABLE_APPS app: ``n`` events over S, D and C in
    sends of 1 to 6 events (repeated keys within a send included),
    timestamps rising by 0 to 3 ms, keys over ``n_keys`` symbols, some
    null ints. -> a list of (stream, [(ts, row)])."""
    rng = np.random.default_rng(seed)
    keys = [f"T{i}" for i in range(n_keys)]
    t = TS0
    out, done = [], 0
    while done < n:
        stream = ("S", "S", "D", "C")[int(rng.integers(0, 4))]
        m = int(rng.integers(1, 7))
        rows = []
        for _ in range(m):
            t += int(rng.integers(0, 4))
            k = keys[int(rng.integers(0, n_keys))]
            a = None if rng.random() < 0.1 else int(rng.integers(0, 9))
            if stream == "C":
                rows.append((t, (k, a)))
            else:
                rows.append((t, (k, a, float(rng.integers(0, 8)) / 4)))
        out.append((stream, rows))
        done += m
    return out


# -- kernel K6 on special values (the repairs of its sum and min/max lanes)

SPECIAL_AGG_APP = """
    @app:playback
    define stream S (k string, v double);
    @info(name = 'q') from S select k, sum(v) as s, min(v) as mn,
    max(v) as mx group by k insert into Out;
"""


def special_agg_feed(seed: int, encode):
    """The feed that showed K6's two faults: 300 normals with NaN, -NaN,
    +-0.0, +-5e-324 and +-inf, keyed by nine groups (seed 0 gave a sum
    lane's NaN sign, seed 3 a min/max lane's -0.0 at a group's first
    row). -> (ts, [key codes, v])."""
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.standard_normal(300) * 100,
                        [np.nan, -np.nan, 0.0, -0.0, 5e-324, -5e-324,
                         np.inf, -np.inf]])
    x = rng.permutation(x)
    seg = np.sort(rng.integers(0, 9, len(x)))
    keys = np.array([encode(f"SPECIAL{i}") for i in range(9)], np.int32)
    return TS0 + np.arange(len(x), dtype=np.int64), [keys[seg], x]


# -- the second-wave windows (K5, the sort window) and the
# stateful aggregators (kernels C and D) -------------------------------------

# trades carrying an exchange timestamp (ets); the three paths of
# chip_smoke.py read this stream
TRADES_STREAM = """
    @app:playback
    define stream Trades (ets long, symbol string, price float, volume long);
"""
# Siddhi's documented externalTime usage: the rolling one-minute high and
# low of each ticker on the exchange's own clock
WINDOW_EXT_APP = TRADES_STREAM + """
    @info(name = 'q') @cap(window.size='65536')
    from Trades#window.externalTime(ets, 1 min)
    select symbol, max(price) as hi, min(price) as lo, avg(price) as ap,
           count() as n
    group by symbol
    insert into Out;
"""
# one-second bars per ticker and the market's breadth (distinct tickers
# a bar), both on the exchange's clock
WINDOW_BARS_APP = TRADES_STREAM + """
    @info(name = 'bars')
    from Trades#window.externalTimeBatch(ets, 1 sec)
    select symbol, max(price) as hi, min(price) as lo, sum(volume) as vol,
           count() as n
    group by symbol
    insert into Bars;
    @info(name = 'breadth')
    from Trades#window.externalTimeBatch(ets, 1 sec)
    select distinctCount(symbol) as syms, count() as n
    insert into Breadth;
"""
# the 1,000 cheapest quotes (ties: the larger volume stays)
WINDOW_SORT_APP = TRADES_STREAM + """
    @info(name = 'q')
    from Trades#window.sort(1000, price, 'asc', volume, 'desc')
    select symbol, price, volume
    insert all events into Out;
"""
WINDOW_EXT_MS = 60_000
WINDOW_BAR_MS = 1_000
WINDOW_SORT_L = 1_000


def trades_feed(n: int, encode, n_syms: int = 512, seed: int = 12,
                prefix: str = "T"):
    """Trades: arrival timestamps 1 ms apart from TS0; ets non-decreasing
    from TS0 with gaps drawn from {0, 1, 2} ms (ties occur); symbols
    uniform over ``n_syms``; price ~ U(0, 200) float32; volume ~
    U[1, 1000) int64. -> (ts, [ets, symbol codes, price, volume])."""
    rng = np.random.default_rng(seed)
    syms = np.array([encode(s) for s in time_symbols(n_syms, prefix)],
                    np.int32)
    ts = TS0 + np.arange(n, dtype=np.int64)
    gaps = rng.integers(0, 3, n).astype(np.int64)
    gaps[0] = 0
    ets = TS0 + np.cumsum(gaps)
    sym = syms[rng.integers(0, n_syms, n)]
    price = rng.uniform(0, 200, n).astype(np.float32)
    vol = rng.integers(1, 1000, n, dtype=np.int64)
    return ts, [ets, sym, price, vol]


def window_ext_oracle(ets, sym, price, span_ms: int = WINDOW_EXT_MS):
    """The grouped externalTime window, independently: event i's window
    is its symbol's rows j <= i with ets[j] > cummax(ets)[i] - span.
    -> (symbol, hi, lo, ap, n) per event, in event order."""
    from collections import deque
    n = len(ets)
    rt = np.maximum.accumulate(ets)
    p = price.astype(np.float64).tolist()
    e = ets.tolist()
    s = sym.tolist()
    hi = np.empty(n, np.float32)
    lo = np.empty(n, np.float32)
    ap = np.empty(n, np.float64)
    cnt = np.empty(n, np.int64)
    live, mx, mn, tot = {}, {}, {}, {}
    for i in range(n):
        k = s[i]
        if k not in live:
            live[k], mx[k], mn[k], tot[k] = deque(), deque(), deque(), 0.0
        q, qx, qn = live[k], mx[k], mn[k]
        limit = int(rt[i]) - span_ms
        while q and e[q[0]] <= limit:
            j = q.popleft()
            tot[k] -= p[j]
            if qx and qx[0] == j:
                qx.popleft()
            if qn and qn[0] == j:
                qn.popleft()
        v = p[i]
        q.append(i)
        tot[k] += v
        while qx and p[qx[-1]] <= v:
            qx.pop()
        qx.append(i)
        while qn and p[qn[-1]] >= v:
            qn.pop()
        qn.append(i)
        hi[i] = p[qx[0]]
        lo[i] = p[qn[0]]
        cnt[i] = len(q)
        ap[i] = tot[k] / len(q)
    return sym.copy(), hi, lo, ap, cnt


def window_bars_oracle(ets, sym, price, vol, bar_ms: int = WINDOW_BAR_MS):
    """One-second bars on the exchange clock, independently: bar
    (ets - ets[0]) // bar_ms; every bar but the last is flushed (at the
    next bar's first event): per symbol in the bar's first-seen order its
    high, low, volume and count; and the bar's distinct symbols and
    count. -> ((symbol, hi, lo, vol, n), (syms, n))."""
    bar = (ets - ets[0]) // bar_ms
    starts = np.flatnonzero(np.r_[True, bar[1:] != bar[:-1]])
    ends = np.r_[starts[1:], len(bar)]
    out = ([], [], [], [], [])
    breadth = ([], [])
    for a, b in zip(starts[:-1], ends[:-1]):
        s, p, v = sym[a:b], price[a:b], vol[a:b]
        keys, first, inv = np.unique(s, return_index=True,
                                     return_inverse=True)
        order = np.argsort(first, kind="stable")
        hi = np.full(len(keys), -np.inf, np.float32)
        lo = np.full(len(keys), np.inf, np.float32)
        np.maximum.at(hi, inv, p)
        np.minimum.at(lo, inv, p)
        sv = np.bincount(inv, weights=None, minlength=len(keys))
        vs = np.zeros(len(keys), np.int64)
        np.add.at(vs, inv, v)
        for col, x in zip(out, (keys, hi, lo, vs, sv.astype(np.int64))):
            col.append(x[order])
        breadth[0].append(len(keys))
        breadth[1].append(b - a)
    return (tuple(np.concatenate(c) for c in out),
            (np.array(breadth[0], np.int64), np.array(breadth[1], np.int64)))


def window_sort_oracle(sym, price, vol, length: int = WINDOW_SORT_L):
    """The sort window, independently: a heap of the kept events; once an
    arrival makes length + 1, the largest (price, -volume, arrival) is
    evicted. -> the output rows in order: (is_expired, symbol, price,
    volume) columns."""
    import heapq
    heap = []
    out_e, out_i = [], []
    p = price.astype(np.float64).tolist()
    v = vol.tolist()
    for i in range(len(p)):
        heapq.heappush(heap, (-p[i], v[i], -i))
        out_e.append(False)
        out_i.append(i)
        if len(heap) > length:
            j = -heapq.heappop(heap)[2]
            out_e.append(True)
            out_i.append(j)
    idx = np.array(out_i, np.int64)
    return np.array(out_e), sym[idx], price[idx], vol[idx]


# the comparison apps of kernels A-D on the card and in the parity tests:
# every new kind with its parameters, sort on each key type and order,
# min/max over the sliding windows on int/long/float/double with special
# values, distinctCount with resets and past its pair table, the ring
# overflow
_W2_STREAM = """
    @app:playback
    define stream S (sym string, price float, volume long, flag bool,
                     ets long, qty int, score double);
"""
W2_START = TS0 + 3
WINDOW2_APPS = {
    "externalTime, grouped": _W2_STREAM + """
        @info(name = 'q') @cap(window.size='256')
        from S#window.externalTime(ets, 40 milliseconds)
        select sym, max(price) as hp, min(price) as lp, max(qty) as hq,
               min(volume) as lv, max(score) as hs, min(score) as ls,
               avg(price) as ap, distinctCount(qty) as dq
        group by sym
        insert all events into Out;
    """,
    "timeLength": _W2_STREAM + """
        @info(name = 'q')
        from S#window.timeLength(30 milliseconds, 20)
        select sym, min(score) as ls, max(qty) as hq, count() as n
        insert all events into Out;
    """,
    "delay": _W2_STREAM + """
        @info(name = 'q') @cap(window.size='256')
        from S#window.delay(10 milliseconds)
        select sym, price, volume, ets
        insert into Out;
    """,
    "batch()": _W2_STREAM + """
        @info(name = 'q') @cap(window.size='256')
        from S#window.batch()
        select sym, sum(volume) as sv, distinctCount(qty) as d,
               count() as n
        group by sym
        insert all events into Out;
    """,
    "batch(7)": _W2_STREAM + """
        @info(name = 'q') @cap(window.size='256')
        from S#window.batch(7)
        select max(price) as hp, min(qty) as lq, distinctCount(sym) as d,
               count() as n
        insert all events into Out;
    """,
    "externalTimeBatch, start constant": _W2_STREAM + f"""
        @info(name = 'q') @cap(window.size='256')
        from S#window.externalTimeBatch(ets, 20 milliseconds, {W2_START})
        select sym, max(price) as hp, min(score) as ls, sum(volume) as sv,
               count() as n
        group by sym
        insert all events into Out;
    """,
    "externalTimeBatch, start attribute": _W2_STREAM + """
        @info(name = 'q') @cap(window.size='256')
        from S#window.externalTimeBatch(ets, 20 milliseconds, volume)
        select sym, ets, volume
        insert all events into Out;
    """,
    "externalTimeBatch, timeout": _W2_STREAM + f"""
        @info(name = 'q') @cap(window.size='256')
        from S#window.externalTimeBatch(ets, 20 milliseconds, {W2_START},
                                        15 milliseconds)
        select sym, count() as n, distinctCount(sym) as d
        insert all events into Out;
    """,
    "externalTimeBatch, replace batch time": _W2_STREAM + f"""
        @info(name = 'q') @cap(window.size='256')
        from S#window.externalTimeBatch(ets, 20 milliseconds, {W2_START},
                                        15 milliseconds, true)
        select sym, ets, price
        insert all events into Out;
    """,
    "hopping": _W2_STREAM + """
        @info(name = 'q') @cap(window.size='256')
        from S#window.hopping(30 milliseconds, 10 milliseconds)
        select sym, count() as n, max(price) as hp
        insert all events into Out;
    """,
    "hoping": _W2_STREAM + """
        @info(name = 'q') @cap(window.size='256')
        from S#window.hoping(25 milliseconds, 15 milliseconds)
        select sym, price, ets
        insert all events into Out;
    """,
    "sort int desc, long asc": _W2_STREAM + """
        @info(name = 'q')
        from S#window.sort(5, qty, 'desc', volume)
        select sym, qty, volume
        insert all events into Out;
    """,
    "sort double asc, float desc": _W2_STREAM + """
        @info(name = 'q')
        from S#window.sort(7, score, 'asc', price, 'desc')
        select sym, score, price, sum(volume) as sv
        insert all events into Out;
    """,
    "sort long desc, int asc": _W2_STREAM + """
        @info(name = 'q')
        from S#window.sort(6, volume, 'desc', qty, 'asc')
        select sym, volume, qty
        insert all events into Out;
    """,
    "sort float asc, double desc": _W2_STREAM + """
        @info(name = 'q')
        from S#window.sort(4, price, 'asc', score, 'desc')
        select sym, price, score
        insert all events into Out;
    """,
    "min/max over time, ungrouped": _W2_STREAM + """
        @info(name = 'q') @cap(window.size='256')
        from S#window.time(30 milliseconds)
        select max(score) as hs, min(score) as ls, max(qty) as hq,
               min(qty) as lq, max(volume) as hv, min(price) as lp
        insert all events into Out;
    """,
    "min/max over length, grouped": _W2_STREAM + """
        @info(name = 'q')
        from S#window.length(40)
        select sym, max(score) as hs, min(qty) as lq, max(volume) as hv,
               distinctCount(score) as ds
        group by sym
        insert all events into Out;
    """,
    "distinctCount over lengthBatch": _W2_STREAM + """
        @info(name = 'q')
        from S#window.lengthBatch(9)
        select sym, distinctCount(qty) as dq, distinctCount(sym) as ds
        group by sym
        insert all events into Out;
    """,
}
# a key with more live rows than its ring (W = 256): the extreme drops
# the oldest and counts them
RING_OVERFLOW_APP = _W2_STREAM + """
    @info(name = 'q')
    from S#window.length(1200)
    select sym, max(price) as hp, min(score) as ls
    group by sym
    insert into Out;
"""
# more (group, value) pairs over the app's life than the pair table's
# D = 4,096 slots: the rest are counted
PAIRS_OVERFLOW_APP = _W2_STREAM + """
    @info(name = 'q')
    from S#window.length(3000)
    select sym, distinctCount(volume) as d
    group by sym
    insert into Out;
"""
# a join side on an externalTime window
EXT_JOIN_APP = """
    @app:playback
    define stream L (k string, ets long, a int);
    define stream R (k string, ets long, b double);
    @info(name = 'q')
    from L#window.externalTime(ets, 30 milliseconds) join
         R#window.length(8) on L.k == R.k
    select L.k as lk, a, b, L.ets as le
    insert all events into Out;
"""

_I32_EXT = (np.iinfo(np.int32).min, np.iinfo(np.int32).max)
_I64_EXT = (np.iinfo(np.int64).min, np.iinfo(np.int64).max)


def window2_feed(n: int, encode, seed: int, n_syms: int = 16,
                 gap_ms: int = 3, prefix: str = "K", specials: bool = True,
                 quiet_every: int = 0, n_vols: int = 1000):
    """Events for WINDOW2_APPS: checks.window_feed's columns (symbols,
    timestamps rising by U[0, gap_ms] ms, price, volume, flag), ets =
    the timestamp, qty ~ U[-20, 20] int32, score ~ N(0, 100) float64;
    with ``specials``, qty takes the int32 extremes, volume the int64
    extremes, score NaN, -NaN, +-0.0 and +-inf, price NaN and +-0.0, a
    few rows each; ``quiet_every`` > 0 adds a 60 ms gap every that many
    rows (timers fire in it). -> (ts, [sym, price, volume, flag, ets,
    qty, score])."""
    ts, (sym, price, vol, flag) = window_feed(n, encode, seed, n_syms,
                                              gap_ms, prefix)
    rng = np.random.default_rng(seed + 1000)
    if quiet_every:
        ts = ts + 60 * (np.arange(n) // quiet_every)
    vol = rng.integers(1, n_vols + 1, n, dtype=np.int64)
    qty = rng.integers(-20, 21, n).astype(np.int32)
    score = rng.standard_normal(n) * 100
    if specials:
        def put(col, vals):
            idx = rng.choice(n, size=len(vals) * 3, replace=False)
            col[idx] = np.repeat(np.asarray(vals, col.dtype), 3)
        put(qty, _I32_EXT)
        put(vol, _I64_EXT)
        put(score, [np.nan, -np.nan, 0.0, -0.0, np.inf, -np.inf])
        put(price, [np.nan, 0.0, -0.0])
    return ts, [sym, price, vol, flag, ts.copy(), qty, score]


# bench.py's seq2 app (bench_seq2), verbatim: an order, then its payment
# within 5 s, without `every`
SEQ2_APP = """
        @app:playback
        define stream OrderS (oid int, amt float);
        define stream PayS (pid int, oid int);
        @info(name = 'q')
        from e1=OrderS[amt > 10.0] -> e2=PayS[oid == e1.oid] within 5 sec
        select e1.oid as o, e2.pid as p
        insert into Out;
"""


def seq2_chunks(n_chunks: int, m: int, seed: int = 10):
    """bench_seq2's feed: chunk i is m orders (oid ~ U[0, 1000), amt ~
    U(0, 100) float32) at TS0 + i * m + k, then m payments (pid k, the
    k-th order's oid) m ms later. -> [(order ts, oid, amt, pay ts, pid,
    pay oid)] in send order."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_chunks):
        ts = TS0 + np.arange(m, dtype=np.int64) + i * m
        oid = rng.integers(0, 1000, m).astype(np.int32)
        amt = rng.uniform(0, 100, m).astype(np.float32)
        out.append((ts, oid, amt, ts + m, np.arange(m, dtype=np.int32),
                    oid.copy()))
    return out


def seq2_oracle(chunks, within_ms: int = 5000):
    """seq2 independently: without `every` the pattern starts once, at
    the first order with amt > 10; the first payment after it with its
    oid, within 5 s of it, completes it; once 5 s have passed the start
    is spent and nothing more matches. -> [(o, p)] (at most one row)."""
    first = None
    for ts, oid, amt, pts, pid, poid in chunks:
        if first is None:
            k = np.flatnonzero(amt > np.float32(10.0))
            if len(k):
                first = (int(ts[k[0]]), int(oid[k[0]]))
        if first is not None:
            t0, o = first
            hit = np.flatnonzero((poid == o) & (pts - t0 <= within_ms))
            if len(hit):
                return [(o, int(pid[hit[0]]))]
            if int(pts[-1]) - t0 > within_ms:
                return []
    return []


# bench.py's kleene app (bench_kleene), verbatim: every run of A events
# above 10, then a B above the run's first value, within 10 s
KLEENE_APP = """
        @app:playback
        define stream A (v int);
        define stream B (v int);
        @info(name = 'q')
        from every e1=A[v > 10]+, e2=B[v > e1.v] within 10 sec
        select count(e1.v) as n, e2.v as bv
        insert into Out;
"""


def kleene_chunks(n_chunks: int, m: int, seed: int = 11):
    """bench_kleene's feed: chunk i is m A events (v ~ U[0, 100)) at TS0
    + i * m + k, then m B events (v ~ U[0, 100)) m ms later. -> [(A ts,
    A v, B ts, B v)] in send order."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_chunks):
        ts = TS0 + np.arange(m, dtype=np.int64) + i * m
        a = rng.integers(0, 100, m).astype(np.int32)
        b = rng.integers(0, 100, m).astype(np.int32)
        out.append((ts, a, ts + m, b))
    return out


def kleene_oracle(chunks, rows: int = 4096, sub: int = 4096,
                  within_ms: int = 10_000):
    """kleene independently, with the pattern table's bounds. Every A
    above 10 starts a run; an unindexed `e1.v` is the run's first value
    (e1[0]). A run ends at the first B above its first value within 10 s
    of its first A, as one row: the B's timestamp, the running count of
    rows so far (`count(e1.v)`, no window), the B's value. The runs live
    in a table of `rows` rows, and the events are taken `sub` at a time
    (the round-parallel engine's sub-batch): after each sub-batch a run
    whose first A lies more than 10 s from the sub-batch's first or last
    event is dropped, and the runs started in it take the free rows in
    arrival order, the rest counted as lost. -> ([(ts, n, bv)], lost)."""
    ts0 = np.zeros(0, np.int64)
    first = np.zeros(0, np.int64)
    out, lost = [], 0

    def live(t, keep_ts0):
        lo, hi = int(t.min()), int(t.max())
        return np.maximum(np.abs(hi - keep_ts0), np.abs(lo - keep_ts0)) \
            <= within_ms

    for ta, a, tb, b in chunks:
        step = min(sub, len(ta))
        for o in range(0, len(ta), step):
            t, v = ta[o:o + step], a[o:o + step].astype(np.int64)
            keep = live(t, ts0)
            ts0, first = ts0[keep], first[keep]
            new = v > 10
            s_ts, s_v = t[new], v[new]
            keep = live(t, s_ts)
            s_ts, s_v = s_ts[keep], s_v[keep]
            free = rows - len(ts0)
            lost += max(0, len(s_ts) - free)
            ts0 = np.concatenate([ts0, s_ts[:free]])
            first = np.concatenate([first, s_v[:free]])
        step = min(sub, len(tb))
        for o in range(0, len(tb), step):
            t, v = tb[o:o + step], b[o:o + step].astype(np.int64)
            ok = (v[None, :] > first[:, None]) & \
                (np.abs(t[None, :] - ts0[:, None]) <= within_ms)
            hit = ok.any(axis=1)
            for j in np.sort(ok.argmax(axis=1)[hit]):
                out.append((int(t[j]), len(out) + 1, int(v[j])))
            keep = ~hit & live(t, ts0)
            ts0, first = ts0[keep], first[keep]
    return out, lost


# -- kernels E, F and G: the keyed windows and order-by ----------------------

# Siddhi's documented fraud query: the cards among the two most frequent
# of the purchases of 30 or more (frequent window, Misra-Gries); and
# lossyFrequent(0.1, 0.01) over the same stream, keyed by the card
PURCHASE_STREAM = """
    @app:playback
    define stream Purchase (cardNo string, price double);
"""


def fraud_app(n: int = 2) -> str:
    return PURCHASE_STREAM + f"""
    @info(name = 'q')
    from Purchase[price >= 30]#window.frequent({n}, cardNo)
    select cardNo, price
    insert all events into PotentialFraud;
"""


LOSSY_APP = PURCHASE_STREAM + """
    @info(name = 'q')
    from Purchase[price >= 30]#window.lossyFrequent(0.1, 0.01, cardNo)
    select cardNo, price
    insert all events into PotentialFraud;
"""
FRAUD_CARDS = 4096


def card_symbols(n: int, prefix: str = "CARD") -> list:
    return [f"{prefix}{i:05d}" for i in range(n)]


def purchase_feed(n: int, encode, n_cards: int = FRAUD_CARDS, seed: int = 21,
                  prefix: str = "CARD"):
    """Purchases 1 ms apart from TS0: the card by Zipf-skewed use (rank
    ~ Zipf(1.3), folded into ``n_cards``), price ~ U(0, 100) in cents
    (float64). -> (ts, [card codes, price])."""
    rng = np.random.default_rng(seed)
    cards = np.array([encode(s) for s in card_symbols(n_cards, prefix)],
                     np.int32)
    rank = (rng.zipf(1.3, n) - 1) % n_cards
    price = np.round(rng.uniform(0, 100, n), 2)
    return TS0 + np.arange(n, dtype=np.int64), [cards[rank], price]


def freq_oracle(card, price, n: int = 2, lossy=None):
    """frequent(n, cardNo) (or, with ``lossy`` = (support, error),
    lossyFrequent over 32 slots) over the purchases of 30 or more,
    independently: a slot table walked row by row; a new key takes the
    lowest free slot. frequent: a full table decrements every count and
    frees the zeroed keys (emitted EXPIRED, in slot order, before the
    row); the row is admitted if that freed a slot. lossyFrequent: a key
    passes while its count is at least (support - error) of the rows so
    far; every ceil(1/error) rows the slots with count + bucket <= the
    bucket are pruned (emitted after the row); a key finding no slot is
    counted. -> ([(expired, card, price)], overflow)."""
    keep = price >= 30.0
    card, price = card[keep].tolist(), price[keep].tolist()
    size = 32 if lossy else n
    keys = [None] * size
    counts = [0] * size
    buckets = [0] * size
    vals = [None] * size
    where = {}
    out, ovf, total = [], 0, 0
    if lossy:
        support, error = lossy
        width = int(-(-1.0 // error)) or 1
        thresh = support - error
    for c, p in zip(card, price):
        if not lossy:
            s = where.get(c)
            if s is not None:
                counts[s] += 1
                vals[s] = (c, p)
                out.append((False, c, p))
                continue
            if len(where) == size:
                freed = []
                for j in range(size):
                    counts[j] -= 1
                    if counts[j] <= 0:
                        freed.append(j)
                for j in freed:
                    out.append((True,) + vals[j])
                    del where[keys[j]]
                    keys[j] = None
                    counts[j] = 0
                if not freed:
                    continue
            s = keys.index(None)
            keys[s], counts[s], vals[s] = c, 1, (c, p)
            where[c] = s
            out.append((False, c, p))
            continue
        total += 1
        bucket = (total + width - 1) // width
        s = where.get(c)
        if s is not None:
            counts[s] += 1
            vals[s] = (c, p)
        elif None in keys:
            s = keys.index(None)
            keys[s], counts[s], buckets[s], vals[s] = c, 1, bucket - 1, (c, p)
            where[c] = s
        else:
            ovf += 1
        if s is not None and float(counts[s]) >= thresh * float(total):
            out.append((False, c, p))
        if total % width == 0:
            for j in range(size):
                if keys[j] is not None and counts[j] + buckets[j] <= bucket:
                    out.append((True,) + vals[j])
                    del where[keys[j]]
                    keys[j] = None
    return out, ovf


# Siddhi's documented session usage: per-user web sessions
CLICK_APP = """
    @app:playback
    define stream Click (user string, dwell long);
    @info(name = 'q')
    from Click#window.session(5 sec, user)
    select user, count() as clicks, sum(dwell) as dwell
    group by user
    insert all events into Sessions;
"""
SESSION_USERS = 48
SESSION_GAP_MS = 5000


def user_symbols(n: int, prefix: str = "USER") -> list:
    return [f"{prefix}{i:03d}" for i in range(n)]


def click_feed(n: int, encode, n_users: int = SESSION_USERS, seed: int = 22,
               prefix: str = "USER"):
    """Clicks: each user clicks in bursts of U[20, 120] events U[1, 20]
    ms apart, with silences of U[6, 30] s between bursts, from TS0 plus
    U[0, 30) s; the users' clicks merged by time (ties by user). dwell ~
    U[1, 60000) ms. -> (ts, [user codes, dwell]), n events."""
    rng = np.random.default_rng(seed)
    codes = np.array([encode(s) for s in user_symbols(n_users, prefix)],
                     np.int32)
    per = n // n_users + 200
    ts_all, user_all = [], []
    for u in range(n_users):
        gaps = rng.integers(1, 21, per).astype(np.int64)
        burst = np.cumsum(rng.integers(20, 121, per // 20 + 2))
        starts = burst[burst < per]
        gaps[starts] = rng.integers(6000, 30001, len(starts))
        gaps[0] = rng.integers(0, 30000)
        ts_all.append(TS0 + np.cumsum(gaps))
        user_all.append(np.full(per, u, np.int32))
    ts = np.concatenate(ts_all)
    user = np.concatenate(user_all)
    o = np.lexsort((user, ts))[:n]
    return ts[o], [codes[user[o]], rng.integers(1, 60000, n,
                                                dtype=np.int64)]


# numpy's model of the reference's slot table (ops/keyed.py)
_GOLDEN = -7046029254386353131
_M1 = -4658895280553007687
_M2 = -7723592293110705685
_HASH_SEED = 1469598103934665603


def np_hash(codes):
    """hash_columns of one int32 column without nulls."""
    with np.errstate(over="ignore"):
        h = np.full(codes.shape, _HASH_SEED, np.int64)
        h = h ^ (codes.astype(np.int64) + np.int64(_GOLDEN))
        h = (h ^ (h >> 30)) * np.int64(_M1)
        h = (h ^ (h >> 27)) * np.int64(_M2)
        return h ^ (h >> 31)


def np_lookup_or_insert(tkeys, used, keys, active, probes: int = 16):
    """lookup_or_insert in rounds: a free probed slot is claimed by the
    lowest pending row; -> (slots or -1, tkeys', used', lost)."""
    K, B = len(tkeys), len(keys)
    tkeys, used = tkeys.copy(), used.copy()
    slot = np.abs(keys) % K
    placed = ~active
    res = np.full(B, -1, np.int64)
    rows = np.arange(B)
    for _ in range(probes):
        pend = ~placed
        if not pend.any():
            break
        match = pend & used[slot] & (tkeys[slot] == keys)
        want = pend & ~used[slot]
        claim = np.full(K, B)
        np.minimum.at(claim, slot[want], rows[want])
        win = want & (claim[slot] == rows)
        tkeys[slot[win]] = keys[win]
        used[slot[win]] = True
        match |= pend & used[slot] & (tkeys[slot] == keys)
        res[match] = slot[match]
        placed |= match
        slot = np.where(placed, slot, (slot + 1) % K)
    return res, tkeys, used, int((active & (res < 0)).sum())


# the runtime's step capacities (core/runtime.py BATCH_BUCKETS): a step's
# padding rows count in the session window's scatter
STEP_BUCKETS = (16, 128, 1024, 8192, 65536, 262144, 1048576)


def _session_steps(chunks, gap: int, flush_at=None):
    """The steps a playback session query takes over ``chunks``: each
    chunk, and the TIMER steps of the runtime's scheduler around them (a
    chunk arms a timer at its first ts + gap; a timer fired at ``now``
    steps a 16-row batch whose one row is that TIMER and re-arms at now
    + 1; timers due before a chunk's first ts fire before it at their
    due, those due by its last ts after it at its last ts). A chunk
    steps at its bucket's capacity (the runtime's STEP_BUCKETS), the
    rows past it padding. A TIMER step's rows are not current; padding
    rows carry ts NEG_INF. -> [(ts, user, dwell, current)]."""
    NEG = -(2 ** 62)
    steps = []
    sched = None
    prev_last = None

    def timer(now):
        ts = np.full(16, NEG, np.int64)
        ts[0] = now
        steps.append((ts, np.zeros(16, np.int32), np.zeros(16, np.int64),
                      np.zeros(16, bool)))

    def fire(upto, clock):
        nonlocal sched
        while sched is not None and sched <= upto:
            now = max(sched, clock)
            sched = None
            timer(now)
            sched = now + 1
    for ts, user, dwell in chunks:
        first, last = int(ts[0]), int(ts[-1])
        if prev_last is not None:
            fire(first - 1, prev_last)
        n = len(ts)
        cap = next(b for b in STEP_BUCKETS if b >= n)
        pad = cap - n
        steps.append((np.concatenate([ts, np.full(pad, NEG, np.int64)]),
                      np.concatenate([user, np.zeros(pad, np.int32)]),
                      np.concatenate([dwell, np.zeros(pad, np.int64)]),
                      np.arange(cap) < n))
        due = int(ts.min()) + gap
        if sched is None or sched > due:
            sched = due
        fire(last, last)
        prev_last = last
    if flush_at is not None:
        fire(flush_at, flush_at)
    return steps


def session_oracle(chunks, gap: int = SESSION_GAP_MS, K: int = 64,
                   S: int = 128, flush_at=None):
    """The session window of CLICK_APP, modelled in numpy step by step as
    the reference computes it (SessionWindowOp.step), then its grouped
    count() and sum(dwell), by user. Per step: the rows by key slot
    (stable); a session breaks where a row reaches the previous member's
    ts + gap (the first row of a slot: the carried session's end); a
    session's close time is the largest last-member ts of its own and
    every LATER session in slot order, plus gap, and it closes where the
    running clock reaches it; the non-final sessions of a slot that do
    not close are dropped, as in the reference; a slot's final session
    stays open with at most S members. The steps are the runtime's: the
    chunks and the scheduler's TIMER steps (``_session_steps``);
    ``flush_at``: the clock moved there after the chunks. -> ({user:
    [(clicks, dwell)]}, kovf + member
    overflow); each user's rows in order, EXPIRED rows subtracting (the
    sum of an empty group is null)."""
    NEG, POS = -(2 ** 62), 2 ** 62
    tkeys = np.zeros(K, np.int64)
    used = np.zeros(K, bool)
    bts = np.zeros((K, S), np.int64)
    buser = np.zeros((K, S), np.int64)
    bdw = np.zeros((K, S), np.int64)
    bval = np.zeros((K, S), bool)
    count = np.zeros(K, np.int64)
    end = np.full(K, POS, np.int64)
    opn = np.zeros(K, bool)
    ovf = 0
    emitted = []     # (expired, user, dwell) in emission order
    for ts, user, dwell, cur in _session_steps(chunks, gap, flush_at):
        B = len(ts)
        rt = np.maximum.accumulate(ts)
        rt_max = rt[-1]
        slots, tkeys, used, kovf = np_lookup_or_insert(
            tkeys, used, np_hash(user), cur)
        routed = cur & (slots >= 0)
        order = np.argsort(np.where(routed, slots, 2 ** 31 - 1),
                           kind="stable")
        inv = np.empty(B, np.int64)
        inv[order] = np.arange(B)
        s_slot = np.where(routed, slots, -1)[order]
        s_ts, s_val = ts[order], routed[order]
        same = np.zeros(B, bool)
        same[1:] = (s_slot[1:] == s_slot[:-1]) & s_val[1:] & s_val[:-1]
        prev = np.concatenate([[0], s_ts[:-1]])
        cs = np.clip(s_slot, 0, K - 1)
        bound = s_val & np.where(same, s_ts >= prev + gap,
                                 ~opn[cs] | (s_ts >= end[cs]))
        first = s_val & ~same
        brk = (first | bound).astype(np.int64)
        seg_start = np.maximum.accumulate(np.where(
            np.concatenate([[True], s_slot[1:] != s_slot[:-1]]),
            np.arange(B), 0))
        csum = np.cumsum(brk)
        sid = csum - np.where(seg_start > 0, csum[seg_start - 1], 0) - 1
        fidx = np.maximum.accumulate(np.where(first, np.arange(B), -1))
        cont = (first & ~bound)[np.clip(fidx, 0, None)] & (fidx >= 0)
        joins = s_val & (sid == 0) & cont
        key = s_slot.astype(np.int64) * (B + 1) + sid
        last = np.concatenate([key[:-1] != key[1:], [True]]) & s_val
        lrev = np.maximum.accumulate(np.where(last, s_ts, NEG)[::-1])[::-1]
        close_s = np.where(s_val, lrev + gap, POS)
        close_ts = close_s[inv]
        closes = (close_s <= rt_max)[inv] & routed
        close_row = np.clip(np.searchsorted(rt, close_s, "left")[inv], 0,
                            B - 1)
        row_sid = np.where(routed, sid[inv], -1)
        rj = joins[inv] & routed
        sc = np.clip(slots, 0, K - 1)
        ext = np.full(K, np.iinfo(np.int64).min)
        np.maximum.at(ext, sc, np.where(rj, close_ts, NEG))
        has_ext = np.zeros(K, bool)
        np.logical_or.at(has_ext, sc, rj)
        sl_close_ts = np.where(has_ext, ext, end)
        sl_closes = opn & (sl_close_ts <= rt_max)
        sl_row = np.clip(np.searchsorted(rt, sl_close_ts, "left"), 0, B - 1)
        b_exp = closes & np.where(rj, sl_closes[sc], True)
        # emission: carried members, the batch's closing rows, currents
        e_row = np.concatenate([np.repeat(sl_row, S),
                                np.where(b_exp, close_row, 0),
                                np.arange(B)])
        e_ph = np.concatenate([np.zeros(K * S + B, np.int64),
                               np.full(B, 2)])
        e_ok = np.concatenate([(bval & sl_closes[:, None]).ravel(), b_exp,
                               routed])
        e_user = np.concatenate([buser.ravel(), user, user])
        e_dw = np.concatenate([bdw.ravel(), dwell, dwell])
        e_exp = np.arange(K * S + 2 * B) < K * S + B
        o = np.argsort(np.where(e_ok, e_row * 4 + e_ph, 2 ** 31 - 1),
                       kind="stable")[:int(e_ok.sum())]
        emitted += zip(e_exp[o].tolist(), e_user[o].tolist(),
                       e_dw[o].tolist())
        # the new state
        final = np.full(K, np.iinfo(np.int64).min)
        np.maximum.at(final, sc, np.where(routed, row_sid, -1))
        keep = opn & ~sl_closes
        stays = routed & ~closes & (row_sid == final[sc])
        base = np.where(keep, count, 0)
        st_s = stays[order].astype(np.int64)
        c2 = np.cumsum(st_s)
        rank = (c2 - np.where(seg_start > 0, c2[seg_start - 1], 0))[inv]
        pos = base[sc] + rank - 1
        in_cap = stays & (pos < S)
        ovf += kovf + int((stays & ~in_cap).sum())
        for arr in (bts, buser, bdw, bval):
            arr[~keep] = 0
        last_other = np.max(np.where(~in_cap, np.arange(B), -1))
        at00 = np.flatnonzero(in_cap & (sc == 0) & (pos == 0))
        c00 = (bts[0, 0], buser[0, 0], bdw[0, 0], bval[0, 0])
        k_, p_ = sc[in_cap], pos[in_cap]
        bts[k_, p_], buser[k_, p_] = ts[in_cap], user[in_cap]
        bdw[k_, p_], bval[k_, p_] = dwell[in_cap], True
        if last_other > (at00[0] if len(at00) else -1):
            bts[0, 0], buser[0, 0], bdw[0, 0], bval[0, 0] = c00
        nst = np.zeros(K, np.int64)
        np.add.at(nst, sc, stays.astype(np.int64))
        count = np.minimum(base + nst, S)
        st_end = np.full(K, np.iinfo(np.int64).min)
        np.maximum.at(st_end, sc, np.where(stays, close_ts, NEG))
        any_st = np.zeros(K, bool)
        np.logical_or.at(any_st, sc, stays)
        end = np.where(st_end > NEG, st_end, np.where(keep, end, POS))
        opn = (keep | any_st) & (end < POS)
    agg = {}
    rows = {}
    for exp, u, d in emitted:
        n, s = agg.get(u, (0, 0))
        n, s = (n - 1, s - d) if exp else (n + 1, s + d)
        agg[u] = (n, s)
        rows.setdefault(u, []).append((n, s if n else None))
    return rows, ovf


# the day's ten largest tickers by volume, per 65,536-trade batch: the
# STRING second key orders at the host edge; the same with a DOUBLE
# second key (all on the card); and a stateless top-100 by price
TOP10_APP = TRADES_STREAM + """
    @info(name = 'q')
    from Trades#window.lengthBatch(65536)
    select symbol, sum(volume) as vol, max(price) as hi
    group by symbol
    having vol > 0
    order by vol desc, symbol
    limit 10
    insert into Top;
"""
TOP10_HI_APP = TOP10_APP.replace("order by vol desc, symbol",
                                 "order by vol desc, hi")
HI_APP = TRADES_STREAM + """
    @info(name = 'q')
    from Trades[price > 0]
    select symbol, price, volume
    order by price desc
    limit 100
    insert into Hi;
"""


def top10_oracle(sym, price, vol, batch: int = 65536, by_hi: bool = False,
                 names=None):
    """Per full batch of ``batch`` trades: each symbol's sum(volume) and
    max(price), the ten largest by volume, ties by the symbol's name
    (``names``: code -> name) or, with ``by_hi``, by hi and then the
    symbol's last row in the batch. -> [[(code, vol, hi)] per batch]."""
    out = []
    for a in range(0, len(sym) - batch + 1, batch):
        s, p, v = sym[a:a + batch], price[a:a + batch], vol[a:a + batch]
        rows = []
        for c in np.unique(s):
            m = s == c
            last = int(np.flatnonzero(m)[-1])
            rows.append((int(c), int(v[m].sum()), float(p[m].max()), last))
        if by_hi:
            rows.sort(key=lambda r: (-r[1], r[2], r[3]))
        else:
            rows.sort(key=lambda r: (-r[1], names[r[0]]))
        out.append([r[:3] for r in rows if r[1] > 0][:10])
    return out


def hi_oracle(sym, price, vol, send: int):
    """Per send: the trades with price > 0, by price descending (ties in
    row order), the first 100. -> [(code, price, vol)]."""
    out = []
    for a in range(0, len(sym), send):
        p = price[a:a + send]
        idx = np.flatnonzero(p > 0)
        idx = idx[np.argsort(-p[idx].astype(np.float64), kind="stable")][:100]
        out += [(int(sym[a + i]), float(p[i]), int(vol[a + i]))
                for i in idx]
    return out


# bench.py's chain3 and fanout apps, verbatim
CHAIN3_APP = """
    @app:playback
    define stream S (sym string, v int, price float);
    @info(name = 'q1')
    from S[v > 3] select sym, v, price insert into S1;
    @info(name = 'q2')
    from S1[price > 10.0] select sym, v, price insert into S2;
    @info(name = 'q3')
    from S2[v < 900] select sym, v, price insert into OutS;
"""
FANOUT_APP = """
    @app:playback
    define stream S (sym string, price float, qty long, bid float,
                     ask float, vol long);
    @info(name = 'q1')
    from S[price * qty > 500.0 and ask - bid < 5.0][vol > 10]
        select sym, price insert into O1;
    @info(name = 'q2')
    from S[price * qty > 500.0 and ask - bid < 5.0][vol > 10]
        select sym, price insert into O2;
    @info(name = 'q3')
    from S[price * qty > 500.0 and ask - bid < 5.0][vol > 10]
        select sym, ask - bid as spread insert into O3;
    @info(name = 'q4')
    from S[price * qty > 500.0 and ask - bid < 5.0][vol > 10]
        select sym, vol insert into O4;
"""


def chain3_feed(n: int, encode, seed: int = 13):
    """bench.py's chain3 feed: sym over SYMS, v ~ U[0, 1000) int32,
    price ~ U(0, 200) float32. -> (ts, [sym, v, price])."""
    rng = np.random.default_rng(seed)
    syms = np.array([encode(s) for s in SYMS], np.int32)
    return TS0 + np.arange(n, dtype=np.int64), [
        syms[rng.integers(0, len(syms), n)],
        rng.integers(0, 1000, n).astype(np.int32),
        rng.uniform(0, 200, n).astype(np.float32)]


def chain3_oracle(sym, v, price):
    """The three filters in a row: -> the kept rows' indices."""
    return np.flatnonzero((v > 3) & (price > np.float32(10.0)) & (v < 900))


def fanout_feed(n: int, encode, seed: int = 23):
    """bench.py's fanout feed. -> (ts, [sym, price, qty, bid, ask, vol])."""
    rng = np.random.default_rng(seed)
    syms = np.array([encode(s) for s in SYMS], np.int32)
    return TS0 + np.arange(n, dtype=np.int64), [
        syms[rng.integers(0, len(syms), n)],
        rng.uniform(0, 200, n).astype(np.float32),
        rng.integers(1, 100, n, dtype=np.int64),
        rng.uniform(0, 100, n).astype(np.float32),
        rng.uniform(0, 100, n).astype(np.float32),
        rng.integers(1, 1000, n, dtype=np.int64)]


def fanout_oracle(sym, price, qty, bid, ask, vol):
    """The shared filter: price * qty (FLOAT times LONG: float32) above
    500, ask - bid below 5, vol above 10. -> (kept indices, spread)."""
    keep = (price * qty.astype(np.float32) > 500.0) & \
        ((ask - bid) < np.float32(5.0)) & (vol > 10)
    return np.flatnonzero(keep), (ask - bid)


# the comparison apps of kernels E, F and G (chip_smoke.py holds each
# kernel against its plain version at every step; the parity tests hold
# the port against the reference): frequent at N = 1, 2 and 64, with and
# without key attributes, with expired events only; lossyFrequent at two
# (support, error) pairs, one past its 32 slots; session with and
# without a key, aggregated, and past its 64 key slots and 128 members;
# order-by on INT, LONG, FLOAT, DOUBLE and BOOL keys, asc and desc, with
# offset, limit and having, on plain and aggregating selectors. Their
# feeds: window2_feed with KEYED_FEEDS[app]'s arguments.
KEYED_APPS = {
    "frequent 1, no key": _W2_STREAM + """
        @info(name = 'q')
        from S#window.frequent(1)
        select sym, qty, score
        insert all events into Out;
    """,
    "frequent 2 by sym": _W2_STREAM + """
        @info(name = 'q')
        from S#window.frequent(2, sym)
        select sym, price, volume
        insert all events into Out;
    """,
    "frequent 64 by sym, qty": _W2_STREAM + """
        @info(name = 'q')
        from S#window.frequent(64, sym, qty)
        select sym, qty, score, flag
        insert all events into Out;
    """,
    "frequent 3, expired": _W2_STREAM + """
        @info(name = 'q')
        from S#window.frequent(3, sym)
        select sym, score
        insert expired events into Out;
    """,
    "lossyFrequent 0.1, 0.01": _W2_STREAM + """
        @info(name = 'q')
        from S#window.lossyFrequent(0.1, 0.01, sym)
        select sym, price, qty
        insert all events into Out;
    """,
    "lossyFrequent 0.05, 0.005, past its slots": _W2_STREAM + """
        @info(name = 'q')
        from S#window.lossyFrequent(0.05, 0.005, sym, qty)
        select sym, qty, volume
        insert all events into Out;
    """,
    "session by sym": _W2_STREAM + """
        @info(name = 'q')
        from S#window.session(30 milliseconds, sym)
        select sym, price, volume, ets
        insert all events into Out;
    """,
    "session, no key": _W2_STREAM + """
        @info(name = 'q')
        from S#window.session(2 milliseconds)
        select sym, qty
        insert all events into Out;
    """,
    "session aggregated": _W2_STREAM + """
        @info(name = 'q')
        from S#window.session(20 milliseconds, sym)
        select sym, count() as n, sum(volume) as sv, max(score) as hs
        group by sym
        insert all events into Out;
    """,
    "session past its slots and members": _W2_STREAM + """
        @info(name = 'q')
        from S#window.session(50 milliseconds, sym)
        select sym, qty
        insert all events into Out;
    """,
    "order int desc, long asc": _W2_STREAM + """
        @info(name = 'q')
        from S
        select sym, qty, volume
        order by qty desc, volume
        limit 7 offset 2
        insert into Out;
    """,
    "order float asc": _W2_STREAM + """
        @info(name = 'q')
        from S
        select sym, price, score
        order by price
        offset 3
        insert into Out;
    """,
    "order double desc, bool asc": _W2_STREAM + """
        @info(name = 'q')
        from S
        select sym, score, flag
        order by score desc, flag
        limit 11
        insert into Out;
    """,
    "order long desc, double asc, having": _W2_STREAM + """
        @info(name = 'q')
        from S
        select volume, score, qty
        having qty > -10
        order by volume desc, score
        insert into Out;
    """,
    "order bool desc, float desc": _W2_STREAM + """
        @info(name = 'q')
        from S
        select flag, price, ets
        order by flag desc, price desc
        limit 20 offset 5
        insert into Out;
    """,
    "order aggregated": _W2_STREAM + """
        @info(name = 'q')
        from S#window.lengthBatch(50)
        select sym, sum(volume) as sv, max(score) as hs, count() as n
        group by sym
        having n > 1
        order by hs desc, sv
        limit 6
        insert into Out;
    """,
    "having, limit": _W2_STREAM + """
        @info(name = 'q')
        from S[qty != 0]
        select sym, qty, price
        having price > 20
        limit 5 offset 1
        insert into Out;
    """,
}
# window2_feed's arguments for each app (the rest: its defaults):
# timers fire in quiet gaps for the sessions; 80 keys overflow the
# session's 64 slots, 3 keys a gap of 50 ms its 128 members
KEYED_FEEDS = {
    "session by sym": {"quiet_every": 100},
    "session, no key": {"quiet_every": 150},
    "session aggregated": {"quiet_every": 120},
    "session past its slots and members": {"n_syms": 80},
}
KEYED_OVERFLOW = {"lossyFrequent 0.05, 0.005, past its slots",
                  "session past its slots and members"}

# the lexsort traps: zeros of both signs, NaN of both signs and the
# infinities (ties keep row order; NaN above +inf both ways), the INT
# and LONG extremes (desc wraps the minimum to itself)
ORDER_TRAP_APP = """
    @app:playback
    define stream S (d double, f float, i int, l long, b bool);
    @info(name = 'q')
    from S#window.lengthBatch(8)
    select d, f, i, l, b
    order by {key}
    insert into Out;
"""
ORDER_TRAP_VALUES = [0.0, -0.0, float("nan"), float("inf"), float("-inf"),
                     1.0, -float("nan"), 0.0]
ORDER_TRAP_INTS = [-2 ** 31, 0, 5, -5, 2 ** 31 - 1, 7, 0, -2 ** 31]
ORDER_TRAP_LONGS = [-2 ** 63, 0, 5, -5, 2 ** 63 - 1, 7, -2 ** 63, 1]


def order_trap_feed():
    """The eight trap rows, 1 ms apart. -> (ts, [d, f, i, l, b])."""
    d = np.array(ORDER_TRAP_VALUES, np.float64)
    d[6] = -np.abs(d[6])      # a NaN with its sign bit set
    f = d.astype(np.float32)
    return TS0 + np.arange(8, dtype=np.int64), [
        d, f, np.array(ORDER_TRAP_INTS, np.int32),
        np.array(ORDER_TRAP_LONGS, np.int64),
        np.array([True, False, True, False, False, True, True, False])]


def keyed_feed(app: str, encode, seed: int, prefix: str = "K"):
    """The feed and the send cuts of KEYED_APPS[app]: window2_feed with
    KEYED_FEEDS[app]'s arguments, 356 events in sends of 100, 128 and
    128; for the session past its slots and members, 228 events over 80
    keys (past the 64 slots), then 192 of one key at most 1 ms apart (a
    session past its 128 members). -> (ts, cols, cuts)."""
    if app == "session past its slots and members":
        ts, cols = window2_feed(228, encode, seed=seed, prefix=prefix,
                                n_syms=80)
        ts2, cols2 = window2_feed(192, encode, seed=seed + 1, prefix=prefix,
                                  n_syms=1, gap_ms=1)
        return (np.concatenate([ts, ts2 - ts2[0] + ts[-1] + 1]),
                [np.concatenate([a, b]) for a, b in zip(cols, cols2)],
                (0, 100, 228, 420))
    ts, cols = window2_feed(356, encode, seed=seed, prefix=prefix,
                            **KEYED_FEEDS.get(app, {}))
    return ts, cols, (0, 100, 228, 356)


# -- slice 8's paths: functions, polar, distinct_symbols, log ------------------

# market-data normalisation, the everyday use of Siddhi's functions; the
# nulls come from the query itself (lots is 0 in 10 % of rows)
FUNCTIONS_APP = """
    @app:playback
    define stream Trade (symbol string, price double, volume long,
                         lots int, bid float, ask float);
    @info(name = 'q')
    from Trade[instanceOfDouble(price) and maximum(bid, ask) > 0.0]
    select symbol, convert(volume, 'int') as vol32,
           cast(price, 'float') as pf,
           coalesce(volume / lots, -1L) as per_lot,
           default(price / convert(lots, 'double'), 0.0) as px_lot,
           ifThenElse(price > 100.0, 'HIGH', 'LOW') as band,
           minimum(bid, ask) as lo, maximum(bid, ask, price) as hi,
           math:abs(ask - bid) as spread, math:sqrt(price) as sq,
           math:round(price) as rp, math:ln(price) as lnp,
           eventTimestamp() as ts
    insert into Norm;
"""
FUNC_SYMBOLS = 512


def func_symbols(n: int = FUNC_SYMBOLS, prefix: str = "F") -> list:
    return [f"{prefix}{i:04d}" for i in range(n)]


def trade_feed(n: int, encode, seed: int = 31, prefix: str = "F"):
    """FUNCTIONS_APP's feed: 1 ms apart from TS0, FUNC_SYMBOLS symbols
    uniform, price ~ U(1, 200), volume ~ U[1, 10^6), lots ~ U[1, 100)
    with 10 % zeros, bid ~ U(0.5, 200) float32 and ask = bid + U(0, 1),
    both negated in 5 % of rows (the filter drops those). -> (ts,
    [symbol codes, price, volume, lots, bid, ask])."""
    rng = np.random.default_rng(seed)
    syms = np.array([encode(s) for s in func_symbols(prefix=prefix)],
                    np.int32)
    ts = TS0 + np.arange(n, dtype=np.int64)
    sym = syms[rng.integers(0, len(syms), n)]
    price = rng.uniform(1, 200, n)
    volume = rng.integers(1, 1_000_000, n, dtype=np.int64)
    lots = rng.integers(1, 100, n).astype(np.int32)
    lots[rng.random(n) < 0.1] = 0
    bid = rng.uniform(0.5, 200, n).astype(np.float32)
    ask = (bid + rng.uniform(0, 1, n).astype(np.float32)).astype(np.float32)
    neg = rng.random(n) < 0.05
    bid[neg], ask[neg] = -bid[neg], -ask[neg]
    return ts, [sym, price, volume, lots, bid, ask]


def functions_oracle(ts, cols, encode):
    """FUNCTIONS_APP in numpy: the kept rows' columns, each as the
    reference computes it (sq and lnp: numpy's sqrt and log, which the
    port's library functions are held to within 4 ulp). -> dict of
    arrays (and ``null_per_lot``/``null_px_lot``, all False: both
    defaults fill their nulls)."""
    sym, price, volume, lots, bid, ask = cols
    keep = np.maximum(bid, ask) > 0
    sym, price, volume, lots, bid, ask = (c[keep] for c in cols)
    zero = lots == 0
    safe = np.where(zero, 1, lots).astype(np.int64)
    with np.errstate(all="ignore"):
        px_lot = np.where(zero, 0.0, price / lots.astype(np.float64))
    hi = np.where(ask > bid, ask, bid).astype(np.float64)
    hi = np.where(price > hi, price, hi)
    return {
        "ts": ts[keep], "symbol": sym,
        "vol32": volume.astype(np.int32),
        "pf": price.astype(np.float32),
        "per_lot": np.where(zero, -1, volume // safe),
        "px_lot": px_lot,
        "band": np.where(price > 100.0, encode("HIGH"),
                         encode("LOW")).astype(np.int32),
        "lo": np.where(ask < bid, ask, bid),
        "hi": hi,
        "spread": np.abs(ask - bid),
        "sq": np.sqrt(price), "rp": np.round(price), "lnp": np.log(price),
    }


# Siddhi's documented pol2Cart usage: polar sensor readings to Cartesian
# tracks; the filter reads only the feed's own values
POLAR_APP = """
    @app:playback
    define stream Radar (id int, theta double, rho double, z double);
    @info(name = 'q')
    from Radar[rho > 5.0]#pol2Cart(theta, rho, z)
    select id, cartX, cartY, cartZ, math:atan(cartY / cartX) as bearing
    insert into Track;
"""


def radar_feed(n: int, seed: int = 32):
    """Radar returns 1 ms apart from TS0: id = k, theta ~ U(-pi, pi),
    rho ~ U(0, 100) (5 % at or under 5, dropped), z ~ N(0, 30). -> (ts,
    [id, theta, rho, z])."""
    rng = np.random.default_rng(seed)
    ts = TS0 + np.arange(n, dtype=np.int64)
    return ts, [np.arange(n, dtype=np.int32), rng.uniform(-np.pi, np.pi, n),
                rng.uniform(0, 100, n), rng.standard_normal(n) * 30]


def polar_oracle(ts, cols):
    """POLAR_APP in numpy: the kept rows' id, cartX, cartY, cartZ and
    bearing (numpy's cos, sin and arctan)."""
    ids, theta, rho, z = cols
    keep = rho > 5.0
    x = rho[keep] * np.cos(theta[keep])
    y = rho[keep] * np.sin(theta[keep])
    return {"ts": ts[keep], "id": ids[keep], "cartX": x, "cartY": y,
            "cartZ": z[keep], "bearing": np.arctan(y / x)}


# Siddhi's documented unionSet query, verbatim (the stream as its
# documentation defines stockStream); the window's capacity annotation
# holds one send's rows (the default, 4,096, would drop most of them)
DISTINCT_CAP = 65536
DISTINCT_APP = """
    @app:playback
    define stream stockStream (symbol string, price float, volume long);
    from stockStream select createSet(symbol) as initialSet
    insert into initStream;
    @info(name = 'q') @cap(window.size='65536')
    from initStream#window.timeBatch(10 sec)
    select unionSet(initialSet) as distinctSymbols,
           sizeOfSet(unionSet(initialSet)) as n
    insert into distinctStockStream;
"""


def distinct_feed(n: int, encode, n_syms: int, seed: int = 33,
                  prefix: str = "U"):
    """Quotes 1 ms apart from TS0 over ``n_syms`` symbols: Zipf(1.3)-
    skewed for 24 symbols (every send's set fits its 32 lanes), uniform
    otherwise; price ~ U(0, 200) float32, volume ~ U[1, 1000). -> (ts,
    [symbol codes, price, volume])."""
    rng = np.random.default_rng(seed)
    syms = np.array([encode(s) for s in time_symbols(n_syms, prefix)],
                    np.int32)
    if n_syms <= 32:
        pick = (rng.zipf(1.3, n) - 1) % n_syms
    else:
        pick = rng.integers(0, n_syms, n)
    ts = TS0 + np.arange(n, dtype=np.int64)
    return ts, [syms[pick], rng.uniform(0, 200, n).astype(np.float32),
                rng.integers(1, 1000, n, dtype=np.int64)]


def distinct_oracle(ts, cols, send: int, W: int = DISTINCT_CAP,
                    S: int = 32, T: int = 10_000):
    """DISTINCT_APP in numpy, step by step as the reference computes it
    at the path's send size. The time batch's first step sets its next
    flush a period after its clock (the send's last ts) and keeps its
    rows; a later step whose clock has reached the next flush emits
    every row the window holds plus the send's, after a RESET, and the
    period advances (the timer steps after it find the window empty).
    Every step counts the pool's rows beyond the window's W (the
    reference keeps the newest W for its expired batch, flush or not).
    A flush emits one row, the union of its rows' symbols: the
    reference's unionSet keeps the S smallest values (the dictionary
    codes, by signed order) and counts the rest, once a step for each of
    the query's two unionSet() aggregators. -> ([(ts, codes kept, n)],
    the unionSet overflow, the window's overflow)."""
    sym = cols[0].astype(np.int64)
    cur = np.zeros(0, np.int64)
    next_emit = None
    rows, u_over, w_over = [], 0, 0
    for a in range(0, len(ts), send):
        idx = np.arange(a, min(a + send, len(ts)))
        now = int(ts[idx[-1]])
        if next_emit is None:
            next_emit = now + T
        pool = np.concatenate([cur, idx])
        w_over += max(len(pool) - W, 0)
        if now >= next_emit:
            d = np.unique(sym[pool])
            rows.append((int(ts[pool[-1]]), d[:S], int(min(len(d), S))))
            u_over += 2 * max(len(d) - S, 0)
            cur = np.zeros(0, np.int64)
            while next_emit <= now:
                next_emit += T
        else:
            cur = pool[-W:]
    return rows, u_over, w_over


LOG_APP = """
    @app:playback
    define stream S (v int, x double);
    @info(name = 'q')
    from S#log('INFO', 'checkpoint') select v insert into Out;
"""


def log_feed(n: int, seed: int = 34):
    rng = np.random.default_rng(seed)
    ts = TS0 + np.arange(n, dtype=np.int64)
    return ts, [rng.integers(-100, 100, n).astype(np.int32),
                rng.standard_normal(n)]


def log_oracle(ts, cols) -> list:
    """LOG_APP's printed lines for one send, as the reference prints
    them (the values as numpy scalars)."""
    v, x = cols
    return [f"[INFO] checkpoint, StreamEvent{{ timestamp={ts[i]}, "
            f"data={[v[i], x[i]]} }}" for i in range(len(ts))]


def emitted_columns(batches) -> tuple:
    """The valid rows of output batches, in order, on the host: (ts,
    [column arrays], [null masks])."""
    ts, cols, nulls = [], None, None
    for b in batches:
        v = b.valid.cpu().numpy()
        ts.append(b.ts.cpu().numpy()[v])
        if cols is None:
            cols, nulls = [[] for _ in b.cols], [[] for _ in b.cols]
        for k, (c, n) in enumerate(zip(b.cols, b.nulls)):
            cols[k].append(c.cpu().numpy()[v])
            nulls[k].append(n.cpu().numpy()[v])
    return (np.concatenate(ts), [np.concatenate(c) for c in cols],
            [np.concatenate(n) for n in nulls])


def ulp_gap(a, b) -> int:
    """The largest distance in float64 units in the last place between
    two arrays (NaN against NaN: 0)."""
    def ordered(x):
        i = np.asarray(x, np.float64).view(np.int64).astype(object)
        return np.where(i < 0, -(i & 0x7FFFFFFFFFFFFFFF), i)
    if len(a) == 0:
        return 0
    d = np.abs(ordered(a) - ordered(b))
    d[np.isnan(a) & np.isnan(b)] = 0
    return int(d.max())


# -- partition blocks (parallel/partition.py: K9p; K4, K5 and K6 with the
# slot axis) -------------------------------------------------------------

PART_STREAM = """
    @app:playback
    define stream S (sym string, price double, volume long, stage int);
"""

# small blocks over one feed, each through a different part of the slot
# axis: value and range keys, K5's kinds, K6 plain and grouped, inner
# streams, key overflow, timers, the scan engine's stream and timer steps
PARTITION_APPS = {
    "value key, length window": PART_STREAM + """
    @slots('8')
    partition with (sym of S) begin
      @info(name = 'q')
      from S#window.length(3)
      select sym, avg(price) as ap, sum(volume) as sv, count() as n,
             stdDev(price) as sd
      insert all events into Out;
    end;
""",
    "range key, time window": PART_STREAM + """
    partition with (price < 30 as 'lo' or price < 70 as 'mid' or
                    price >= 70 as 'hi' of S) begin
      @info(name = 'q')
      from S#window.time(40 milliseconds)
      select sym, sum(price) as sp, count() as n
      insert all events into Out;
    end;
""",
    "inner stream, group by": PART_STREAM + """
    @slots('8')
    partition with (sym of S) begin
      from S[price > 20] select sym, stage, price * 2 as p2, volume
      insert into #I;
      @info(name = 'q')
      from #I select sym, stage, sum(p2) as t, count() as n
      group by stage insert into Out;
    end;
""",
    "key overflow, two queries": PART_STREAM + """
    @slots('4')
    partition with (sym of S) begin
      @info(name = 'q')
      from S[price > 50] select sym, price, volume insert into Out;
      from S select sym, volume * 2 as v2 insert into Out2;
    end;
""",
    "timeBatch, timers": PART_STREAM + """
    @slots('8')
    partition with (sym of S) begin
      @info(name = 'q')
      from S#window.timeBatch(50 milliseconds)
      select sym, sum(volume) as sv, count() as n insert into Out;
    end;
""",
    "lengthBatch, all events": PART_STREAM + """
    @slots('8')
    partition with (sym of S) begin
      @info(name = 'q')
      from S#window.lengthBatch(4)
      select sym, avg(price) as ap, count() as n insert all events into Out;
    end;
""",
    "pattern, within": PART_STREAM + """
    @slots('8')
    partition with (sym of S) begin
      @info(name = 'q')
      from every e1=S[stage == 1] -> e2=S[stage == 2 and price > e1.price]
           within 60 milliseconds
      select e1.sym as sym, e1.price as p1, e2.price as p2
      insert into Out;
    end;
""",
    "absent, timer step": PART_STREAM + """
    @slots('8')
    partition with (sym of S) begin
      @info(name = 'q')
      from every e1=S[stage == 1] -> not S[stage == 3] for 30 milliseconds
      select e1.sym as sym, e1.volume as v
      insert into Out;
    end;
""",
}


def partition_feed(n: int, encode, n_syms: int = 6, seed: int = 41,
                   prefix: str = "PA"):
    """PARTITION_APPS' feed: timestamps from TS0 with gaps of 1-5 ms;
    symbols uniform over ``n_syms``; price ~ U(0, 100) to the cent;
    volume ~ U[1, 1000); stage ~ U[0, 4). -> (ts, [sym codes, price,
    volume, stage], send cuts of uneven sizes)."""
    rng = np.random.default_rng(seed)
    syms = np.array([encode(f"{prefix}{i:02d}") for i in range(n_syms)],
                    np.int32)
    ts = TS0 + np.cumsum(rng.integers(1, 6, n)).astype(np.int64)
    sym = syms[rng.integers(0, n_syms, n)]
    price = np.round(rng.uniform(0, 100, n), 2)
    vol = rng.integers(1, 1000, n, dtype=np.int64)
    stage = rng.integers(0, 4, n).astype(np.int32)
    cuts = [0]
    while cuts[-1] < n:
        cuts.append(min(n, cuts[-1] + int(rng.integers(1, 300))))
    return ts, [sym, price, vol, stage], tuple(cuts)


# the Siddhi query guide's partition example: a per-symbol running
# average through an inner stream
PARTITION_AVG_APP = """
    @app:playback
    define stream StockStream (symbol string, price float, volume long);
    @slots('1024')
    partition with (symbol of StockStream) begin
      @info(name = 'avg')
      from StockStream#window.length(10)
      select symbol, avg(price) as avgPrice, volume
      insert into #AvgStream;
      @info(name = 'q')
      from #AvgStream[avgPrice > 75]
      select symbol, avgPrice, volume
      insert into OutStream;
    end;
"""


def _slot_steps(codes, send: int, K: int):
    """The block's slot table over sends of ``send`` rows (one step
    each): -> (each row's slot or -1, the rows that found none)."""
    tkeys = np.zeros(K, np.int64)
    used = np.zeros(K, bool)
    slots = np.full(len(codes), -1, np.int64)
    lost = 0
    for s in range(0, len(codes), send):
        keys = np_hash(codes[s:s + send])
        res, tkeys, used, ov = np_lookup_or_insert(
            tkeys, used, keys, np.ones(len(keys), bool))
        slots[s:s + send] = res
        lost += ov
    return slots, lost


def partition_avg_oracle(ts, sym, price, vol, send: int = 8192,
                         K: int = 1024, length: int = 10):
    """PARTITION_AVG_APP independently: the slot table per send (rows of
    a symbol without a slot are dropped and counted), then each kept
    row's symbol's average over its last ``length`` prices (float32
    widened, summed in float64 with math.fsum), the rows whose average
    is above 75. -> (ts, sym, avg, volume of the rows out, overflow)."""
    import math
    from collections import deque
    slots, lost = _slot_steps(sym, send, K)
    wins: dict = {}
    keep = []
    avgs = []
    p64 = price.astype(np.float64)
    for i in np.flatnonzero(slots >= 0):
        w = wins.setdefault(int(sym[i]), deque(maxlen=length))
        w.append(p64[i])
        a = math.fsum(w) / len(w)
        if a > 75:
            keep.append(i)
            avgs.append(a)
    keep = np.array(keep, np.int64)
    return ts[keep], sym[keep], np.array(avgs), vol[keep], lost


PARTITION_FRAUD_APP = """
    @app:playback
    define stream Txn (card string, amount double);
    @slots('2048')
    partition with (card of Txn) begin
      @info(name = 'q')
      from every e1=Txn[amount < 10] -> e2=Txn[amount > 1000]
           within 10 min
      select e1.card, e2.amount
      insert into Alert;
    end;
"""
FRAUD_TXN_CARDS = 1024


def txn_feed(n: int, encode, n_cards: int = FRAUD_TXN_CARDS, seed: int = 42,
             prefix: str = "TX"):
    """Card transactions: timestamps from TS0 with gaps of 1-2,000 ms
    (strictly increasing); the card by Zipf-skewed use (rank ~
    Zipf(1.3) folded into ``n_cards``, as window_frequent's); the amount
    under 10 for 1 % of rows, over 1,000 for 1 %, else in [10, 1000], to
    the cent. -> (ts, [card codes, amount])."""
    rng = np.random.default_rng(seed)
    cards = np.array([encode(s) for s in card_symbols(n_cards, prefix)],
                     np.int32)
    ts = TS0 + np.cumsum(rng.integers(1, 2001, n)).astype(np.int64)
    rank = (rng.zipf(1.3, n) - 1) % n_cards
    u = rng.random(n)
    amount = np.where(u < 0.01, rng.uniform(0.01, 9.99, n),
                      np.where(u < 0.02, rng.uniform(1000.01, 5000, n),
                               rng.uniform(10, 1000, n)))
    return ts, [cards[rank], np.round(amount, 2)]


def fraud_oracle(ts, card, amount, send: int = 4096, K: int = 2048,
                 within_ms: int = 600_000):
    """PARTITION_FRAUD_APP independently: the slot table per send; per
    card, every amount under 10 opens a pending match, and the next
    amount over 1,000 of that card completes each pending match at most
    ``within_ms`` old, in the order they opened. -> (ts, card, amount of
    the rows out, overflow, the most pending matches of a card, the most
    matches of a card in one send)."""
    slots, lost = _slot_steps(card, send, K)
    pend: dict = {}
    rows = []
    max_pend = max_step = 0
    step_count: dict = {}
    step = -1
    for i in np.flatnonzero(slots >= 0):
        c = int(card[i])
        p = pend.setdefault(c, [])
        if i // send != step:
            step, step_count = i // send, {}
        if amount[i] > 1000:
            live = [t for t in p if ts[i] - t <= within_ms]
            for _t in live:
                rows.append(i)
            step_count[c] = step_count.get(c, 0) + len(live)
            max_step = max(max_step, step_count[c])
            p.clear()
        elif amount[i] < 10:
            p[:] = [t for t in p if ts[i] - t <= within_ms]
            p.append(ts[i])
            max_pend = max(max_pend, len(p))
    rows = np.array(rows, np.int64)
    return ts[rows], card[rows], amount[rows], lost, max_pend, max_step


# AbsentPatternTestCase.testQueryAbsent43's shape: per-customer absence
PARTITION_ABSENT_APP = """
    @app:playback
    define stream CustomerStream (customerId string);
    @slots('2048')
    partition with (customerId of CustomerStream) begin
      @info(name = 'q')
      from e1=CustomerStream
           -> not CustomerStream[customerId == e1.customerId] for 1 sec
      select e1.customerId insert into OutputStream;
    end;
"""


def customer_feed(n: int, encode, n_cust: int = 1024, seed: int = 43,
                  prefix: str = "CU"):
    """Customer visits: timestamps from TS0 with gaps of 1-40 ms; the
    customer by Zipf-skewed use (Zipf(1.3) folded into ``n_cust``).
    -> (ts, [customer codes])."""
    rng = np.random.default_rng(seed)
    cust = np.array([encode(f"{prefix}{i:05d}") for i in range(n_cust)],
                    np.int32)
    ts = TS0 + np.cumsum(rng.integers(1, 41, n)).astype(np.int64)
    rank = (rng.zipf(1.3, n) - 1) % n_cust
    return ts, [cust[rank]]


def absent_oracle(ts, cust, send: int = 4096, K: int = 2048,
                  wait_ms: int = 1000):
    """PARTITION_ABSENT_APP independently, the clock then driven past
    every deadline: a customer with a slot alerts at its first visit +
    ``wait_ms`` unless it visits again by then. -> (alert ts, customer)
    sorted by (ts, customer), and the overflow."""
    slots, lost = _slot_steps(cust, send, K)
    first: dict = {}
    again: set = set()
    for i in np.flatnonzero(slots >= 0):
        c = int(cust[i])
        if c not in first:
            first[c] = int(ts[i])
        elif c not in again and ts[i] - first[c] <= wait_ms:
            again.add(c)
    out = sorted((t + wait_ms, c) for c, t in first.items() if c not in again)
    return (np.array([t for t, _ in out], np.int64),
            np.array([c for _, c in out], np.int32), lost)


# ---------------------------------------------------------------------------
# incremental aggregation (kernel K11) and named windows
# ---------------------------------------------------------------------------

# The Siddhi query guide's incremental-aggregation example, word for word
# (`sec ... year` parses as the six durations and `weeks`, which is
# dropped).
AGG_TRADES_APP = """
define stream TradeStream (symbol string, price double, volume long, timestamp long);
define aggregation TradeAggregation
from TradeStream
select symbol, avg(price) as avgPrice, sum(price) as total
group by symbol
aggregate by timestamp every sec ... year;
"""
AGG_TRADES_SYMS = 64
AGG_MIDNIGHT = 1_767_225_600_000          # 2026-01-01T00:00:00Z
AGG_SPAN_MS = 32_768
AGG_JITTER_MS = 2_000
# the within bounds of the reads: every bucket of the feed, years included
AGG_WITHIN = (1_700_000_000_000, 1_800_000_000_000)
AGG_DURATIONS = ("seconds", "minutes", "hours", "days", "months", "years")


def agg_trades_feed(n: int, encode, seed: int = 11,
                    n_syms: int = AGG_TRADES_SYMS, prefix: str = "TR"):
    """AGG_TRADES_APP's feed: ``n`` trades over AGG_SPAN_MS ms centred on
    2026-01-01T00:00:00Z, so every duration has two buckets a symbol.
    Arrival ts (the event ts) climb through the span, n / span rows a
    millisecond; ``timestamp`` is the arrival ts less a seeded jitter of
    0-AGG_JITTER_MS ms, so the events arrive out of order. Symbols
    uniform over ``n_syms``, price ~ U(1, 500), volume ~ U[1, 1000).
    -> (ts, [symbol codes, price, volume, timestamp])."""
    rng = np.random.default_rng(seed)
    syms = np.array([encode(f"{prefix}{i:02d}") for i in range(n_syms)],
                    np.int32)
    ts = (AGG_MIDNIGHT - AGG_SPAN_MS // 2
          + np.arange(n, dtype=np.int64) * AGG_SPAN_MS // n)
    sym = syms[rng.integers(0, n_syms, n)]
    price = rng.uniform(1.0, 500.0, n)
    vol = rng.integers(1, 1000, n, dtype=np.int64)
    stamp = ts - rng.integers(0, AGG_JITTER_MS + 1, n, dtype=np.int64)
    return ts, [sym, price, vol, stamp]


def civil_bucket(ts, duration: str):
    """Bucket starts by numpy's calendar (datetime64), independently of
    the engine's integer civil arithmetic."""
    unit = {"seconds": "s", "minutes": "m", "hours": "h", "days": "D",
            "months": "M", "years": "Y"}[duration]
    t = np.asarray(ts, np.int64).astype("datetime64[ms]")
    return t.astype(f"datetime64[{unit}]").astype("datetime64[ms]").astype(
        np.int64)


def agg_oracle(keys, stamps, values, duration: str) -> dict:
    """A numpy group-by of ``values`` by (key, bucket of ``stamps``):
    {(key, bucket start): (count, sum, min, max)}."""
    bs = civil_bucket(stamps, duration)
    pairs = np.stack([np.asarray(keys, np.int64), bs], 1)
    uniq, inv = np.unique(pairs, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    cnt = np.bincount(inv, minlength=len(uniq))
    tot = np.bincount(inv, weights=values, minlength=len(uniq))
    lo = np.full(len(uniq), np.inf)
    hi = np.full(len(uniq), -np.inf)
    np.minimum.at(lo, inv, values)
    np.maximum.at(hi, inv, values)
    return {(int(k), int(b)): (int(c), float(s), float(m), float(x))
            for (k, b), c, s, m, x in zip(uniq, cnt, tot, lo, hi)}


# The Siddhi query guide's named-window usage, in shape (under playback,
# so that the window's clock is the events').
WINDOW_NAMED_APP = """
@app:playback
define stream TempStream (roomNo int, temp double);
define window OneMinTempWindow (roomNo int, temp double) time(1 min);
from TempStream select * insert into OneMinTempWindow;
from OneMinTempWindow
select roomNo, avg(temp) as avgTemp
group by roomNo
insert into RoomAvgStream;
"""
WINDOW_NAMED_ROOMS = 512
WINDOW_NAMED_MS = 60_000
# the feed's spacing: a minute holds 4,000 readings, within the window's
# default capacity of 4,096 rows (core/runtime.py DEFAULT_TIME_CAP)
WINDOW_NAMED_GAP_MS = 15
WINDOW_NAMED_READ = "from OneMinTempWindow on temp > 30.0 select roomNo, temp"


def window_named_feed(n: int, seed: int = 12,
                      n_rooms: int = WINDOW_NAMED_ROOMS,
                      gap_ms: int = WINDOW_NAMED_GAP_MS):
    """WINDOW_NAMED_APP's feed: readings ``gap_ms`` apart from TS0, rooms
    uniform over ``n_rooms``, temp ~ U(10, 40). -> (ts, [rooms, temp])."""
    rng = np.random.default_rng(seed)
    ts = TS0 + np.arange(n, dtype=np.int64) * gap_ms
    room = rng.integers(0, n_rooms, n).astype(np.int32)
    temp = rng.uniform(10.0, 40.0, n)
    return ts, [room, temp]


def window_named_oracle(ts, room, temp, span_ms: int = WINDOW_NAMED_MS):
    """WINDOW_NAMED_APP independently: one RoomAvgStream row an event, the
    mean temp of its room's events still in the window (event i's window:
    the same-room events j <= i with ts[j] + span > ts[i]); and the
    on-demand read WINDOW_NAMED_READ after the last event: the events
    with ts + span > the last ts and temp > 30, in arrival order.
    -> (rooms, avg temps, read rooms, read temps)."""
    _room, avg, _sv, _cnt = window_time_oracle(
        ts, room, temp, np.zeros(len(ts), np.int64), span_ms)
    live = (ts + span_ms > ts[-1]) & (temp > 30.0)
    return room, avg, room[live], temp[live]


# Kernel K11 against its plain version: every aggregator over INT, LONG,
# DOUBLE and FLOAT arguments, a STRING and an INT group key, every
# duration.
K11_CHECK_APP = """
define stream S (sym string, room int, i int, l long, d double, f float,
                 ts long);
define aggregation A from S
select sym, room, sum(i) as si, avg(i) as ai, count() as n, min(i) as mi,
       max(i) as xi, sum(l) as sl, avg(l) as al, min(l) as ml, max(l) as xl,
       sum(d) as sd, avg(d) as ad, min(d) as md, max(d) as xd,
       sum(f) as sf, min(f) as mf, max(f) as xf
group by sym, room
aggregate by ts every sec ... year;
"""
K11_SYMS = ("KA", "KB", "KC")
_F64_SPECIALS = (1.0, 1e16, -1e16, 0.0, -0.0, np.inf, -np.inf, 1e-310,
                 -3e-320, 2.3e-308, -2.25e-308)
_NAN_BITS64 = (0x7FF8000000000011, 0xFFF8000000000022, 0x7FF8000000000123)


def k11_check_feed(kind: str, n: int, capacity: int, encode, seed: int):
    """One batch of K11_CHECK_APP's stream as numpy columns: 'mixed'
    (nulls in every argument, event times out of order across decades,
    before 1970 too, and bunched around 2026-01-01), 'order' (runs of
    [1, 1e16, -1e16] either way round, NaNs of both signs, +-0.0,
    infinities, subnormals; a few buckets) or 'overflow' (every row its
    own second: more keys than a table's 4,096 slots).
    -> (ts, cols, nulls) of ``capacity`` rows, the first ``n`` valid."""
    rng = np.random.default_rng(seed)
    syms = np.array([encode(s) for s in K11_SYMS], np.int32)
    ts = np.sort(rng.integers(0, 10 ** 6, capacity)).astype(np.int64)
    d = rng.normal(size=capacity) * 10.0 ** rng.integers(-3, 6, capacity)
    if kind == "mixed":
        ets = np.where(rng.random(capacity) < 0.5,
                       rng.integers(-3 * 10 ** 12, 3 * 10 ** 12, capacity),
                       AGG_MIDNIGHT + rng.integers(-90_000, 90_000,
                                                   capacity))
    elif kind == "order":
        ets = AGG_MIDNIGHT + rng.integers(0, 2_500, capacity)
        k = np.arange(capacity)
        pat = np.array([1.0, 1e16, -1e16])[k % 3] * np.where(
            (k // 3) % 2 == 1, 1.0, -1.0)
        spec = np.array(_F64_SPECIALS + tuple(
            np.array(_NAN_BITS64, np.uint64).view(np.float64)))
        d = np.where(k % 7 < 3, pat,
                     spec[rng.integers(0, len(spec), capacity)])
    else:
        ets = AGG_MIDNIGHT + rng.permutation(capacity).astype(np.int64) * 1000
    f = rng.choice(np.array([1e-40, -1e-41, 3.5, -0.0, np.nan, 1e30, 0.25],
                            np.float32), capacity)
    cols = [syms[rng.integers(0, len(syms), capacity)],
            rng.integers(0, 4, capacity).astype(np.int32),
            rng.integers(-2 ** 31, 2 ** 31, capacity).astype(np.int32),
            rng.integers(-2 ** 62, 2 ** 62, capacity).astype(np.int64),
            d.astype(np.float64), f, ets.astype(np.int64)]
    null_p = 0.0 if kind == "overflow" else 0.12
    nulls = [rng.random(capacity) < null_p for _ in cols[:6]] + \
        [np.zeros(capacity, bool)]
    return ts, cols, nulls


# ---------------------------------------------------------------------------
# event time and schedules: cron_trades and watermark_sensors
# ---------------------------------------------------------------------------

# cron_trades: trading-desk reports on wall-clock boundaries, Siddhi's
# query-guide cron-window example in shape (a named cron window fed by
# `insert into`, a grouped sum over it), a periodic trigger through a
# projection, and a one-minute average limited to its last row per
# symbol every 5 s
CRON_TRADES_APP = """
@app:playback
define stream StockEventStream (symbol string, price float, volume long);
define window StockEventWindow (symbol string, price float, volume long)
    cron('*/5 * * * * ?');
define trigger FiveSecTrigger at every 5 sec;
@info(name = 'fill')
from StockEventStream insert into StockEventWindow;
@info(name = 'report')
from StockEventWindow
select symbol, sum(price) as totalPrice
group by symbol
insert into ReportStream;
@info(name = 'tick')
from FiveSecTrigger
select triggered_time, triggered_time - 5000 as periodStart
insert into TickStream;
@info(name = 'lastavg') @cap(window.size='32768')
from StockEventStream#window.time(1 min)
select symbol, avg(price) as avgPrice
group by symbol
output last every 5 sec
insert into AvgStream;
"""
CRON_TRADES_PERIOD_MS = 5000
# trades 2 ms apart: a 5 s firing holds 2,500 rows, within the named
# window's 4,096 (core/runtime.py DEFAULT_TIME_CAP); a minute 30,000,
# within the time window's @cap
CRON_TRADES_GAP_MS = 2
CRON_TRADES_SYMS = 512


def cron_trades_feed(n: int, encode, seed: int = 13,
                     n_syms: int = CRON_TRADES_SYMS, prefix: str = "T"):
    """CRON_TRADES_APP's feed: trades 2 ms apart from TS0 + 1 (TS0 is on
    a 5 s boundary, so no trade falls on a firing), symbols uniform over
    ``n_syms``, price ~ U(0, 200) float32, volume ~ U[1, 1000) int64.
    -> (ts, [symbol codes, price, volume])."""
    rng = np.random.default_rng(seed)
    syms = np.array([encode(s) for s in time_symbols(n_syms, prefix)],
                    np.int32)
    ts = TS0 + 1 + CRON_TRADES_GAP_MS * np.arange(n, dtype=np.int64)
    sym = syms[rng.integers(0, n_syms, n)]
    price = rng.uniform(0, 200, n).astype(np.float32)
    vol = rng.integers(1, 1000, n, dtype=np.int64)
    return ts, [sym, price, vol]


def cron_trades_cuts(ts, period_ms: int = CRON_TRADES_PERIOD_MS):
    """The send boundaries: one send a 5 s period of trades. A columnar
    send is one step, and timers fire only before and after it, so a
    firing can only split the feed between sends. -> cut indices, 0
    first and len(ts) last."""
    k = (ts - TS0) // period_ms
    inner = np.flatnonzero(k[1:] != k[:-1]) + 1
    return np.concatenate([[0], inner, [len(ts)]]).astype(np.int64)


def cron_trades_oracle(ts, sym, price, cuts,
                       period_ms: int = CRON_TRADES_PERIOD_MS,
                       span_ms: int = 60_000):
    """CRON_TRADES_APP independently, for sends cut at ``cuts``:

    - report: the cron window fires on each period boundary; the firing
      on send k's arrival emits send k-1's trades CURRENT (after send
      k-2's EXPIRED, which take the group sums back to zero), each row
      the running float64 sum of its symbol's prices in that batch;
    - ticks: the trigger, armed at the first ts less 1, fires every
      5,000 ms of event time up to the last ts;
    - last: ``output last every 5 sec`` as the limiter runs: armed when
      rows come, at the clock (the send's last ts) + 5 s, fired when the
      clock passes it (before a send: its first ts less 1; after it: its
      last ts); a flush emits the last row of each symbol since the
      previous flush, in order of the symbol's first row there, each
      row's average over the symbol's trades of the last minute.
    -> (report symbols, report sums, ticks, [(row ts, symbols, averages)
    a flush])."""
    rep_sym, rep_sum = [], []
    for k in range(1, len(cuts) - 1):
        a, b = cuts[k - 1], cuts[k]
        s, p = sym[a:b], price[a:b].astype(np.float64)
        run = np.empty(b - a, np.float64)
        for u in np.unique(s):
            idx = np.flatnonzero(s == u)
            run[idx] = np.cumsum(p[idx])
        rep_sym.append(s)
        rep_sum.append(run)
    base = int(ts[0]) - 1
    n_ticks = (int(ts[-1]) - base) // period_ms
    ticks = base + period_ms * np.arange(1, n_ticks + 1, dtype=np.int64)
    _s, ap, _sv, _n = window_time_oracle(ts, sym, price,
                                         np.zeros(len(ts), np.int64),
                                         span_ms)
    flushes = []
    due, start = None, 0

    def flush(end):
        s = sym[start:end]
        _u, first = np.unique(s, return_index=True)
        _u2, rlast = np.unique(s[::-1], return_index=True)
        lastp = (end - start - 1) - rlast
        order = np.argsort(first, kind="stable")
        li = start + lastp[order]
        flushes.append((ts[li], sym[li], ap[li]))
    for k in range(len(cuts) - 1):
        a, b = cuts[k], cuts[k + 1]
        if due is not None and due <= int(ts[a]) - 1:
            flush(a)
            due, start = None, a
        if due is None:
            due = int(ts[b - 1]) + period_ms
        if due <= int(ts[b - 1]):
            flush(b)
            due, start = None, b
    return (np.concatenate(rep_sym), np.concatenate(rep_sum), ticks,
            flushes)


def watermark_sensors_app(lateness: str = "200 ms", span: str = "1 min",
                          cap: int = 65536) -> str:
    """window_time_grouped's app (window_time_app) under
    ``@app:watermark(lateness=...)``, policy DROP: the reorder buffer
    re-sorts each send before the window sees it."""
    return window_time_app(span, cap).replace(
        "@app:playback", f"@app:watermark(lateness='{lateness}')")


WATERMARK_LATENESS_MS = 200


def watermark_sensors_feed(n: int, encode, seed: int = 14,
                           n_syms: int = WINDOW_TIME_SYMS,
                           prefix: str = "K",
                           max_delay: int = WATERMARK_LATENESS_MS,
                           straggle: float = 0.001):
    """window_time_feed's events in the order a fleet of producers
    delivers them: each event delayed by a seeded 0-``max_delay`` ms,
    and a ``straggle`` share of them by 500-1,000 ms (late past the
    lateness bound). -> (ts, [symbol codes, price, volume]) in arrival
    order."""
    ts, cols = window_time_feed(n, encode, n_syms=n_syms, prefix=prefix)
    rng = np.random.default_rng(seed)
    delay = rng.integers(0, max_delay + 1, n)
    strag = rng.random(n) < straggle
    delay[strag] = rng.integers(500, 1001, int(strag.sum()))
    order = np.argsort(ts + delay, kind="stable")
    return ts[order], [c[order] for c in cols]


def watermark_late_mask(ts, cuts, lateness_ms: int = WATERMARK_LATENESS_MS):
    """The late events of a feed sent in sends cut at ``cuts``: an event
    is late iff its ts is below the greatest ts of the earlier sends less
    the lateness (the watermark when its send arrives)."""
    late = np.zeros(len(ts), bool)
    mx = None
    for a, b in zip(cuts[:-1], cuts[1:]):
        if mx is not None:
            late[a:b] = ts[a:b] < mx - lateness_ms
        m = int(ts[a:b].max())
        mx = m if mx is None else max(mx, m)
    return late
