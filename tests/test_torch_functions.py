"""Kernel K2's function calls (plain version) against the reference's
_compile_function and _compile_math_ns, on the CPU: every case of
checks.function_cases over columns with nulls, NaN, +-inf, +-0.0,
subnormals and the INT/LONG extremes (one jitted reference program for
all of them, shared by the module), the maximum/minimum, coalesce and
ifThenElse traps, constant folding, the clock functions under playback,
uuid() and the function cases of tests/test_filter.py.

Every column is bit-equal to the reference's, values and null masks,
except the math-library functions (math:sqrt, exp, ln, log10, sin, cos,
tan, asin, acos, atan, power), which are held to 2 ulp (NaN equal to
NaN): XLA's CPU library is its own (ROADMAP Queue 3). Two further
divergences are pinned: math:power of a subnormal base, where XLA's
result is far from the true value (those rows are held to numpy's
power instead), and sizeOfSet(), whose reference column is int64 under
its declared INT (the port's is int32; the values are equal)."""
import functools
import re
import uuid

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import siddhi_tpu as J
import siddhi_tpu.core.event as jev
import siddhi_tpu.core.types as jtypes
import siddhi_tpu.lang.parser as jparser
import siddhi_tpu.ops.expr as jexpr
import siddhi_tpu_torch as T
import siddhi_tpu_torch.core.event as tev
import siddhi_tpu_torch.core.types as ttypes
import siddhi_tpu_torch.lang.parser as tparser
import siddhi_tpu_torch.ops.expr as texpr
from siddhi_tpu_torch.checks import (EXPR_SCHEMA, EXPR_STRINGS,
                                     function_cases, function_columns)

torch.set_num_threads(1)

ROWS = 512
CASES = function_cases()
LIBRARY = re.compile(r"math:(sqrt|exp|ln|log10|sin|cos|tan|asin|acos|atan|"
                     r"power)\((?![\d.,\s-]+\))")
# rows of each library case that differ from the reference (<= 2 ulp)
DIFFERING: dict = {}

JS = jev.StreamSchema("S", tuple(
    jev.Attribute(n, jtypes.AttrType[t.name]) for n, t in EXPR_SCHEMA))
TS = tev.StreamSchema("S", tuple(tev.Attribute(n, t) for n, t in EXPR_SCHEMA))


def batch_pair(cols, nulls, kind, valid, strings=EXPR_STRINGS):
    """The same columns as a reference and a port EventBatch; STRING
    columns (indices into ``strings``) carry each package's own codes."""
    jcols, tcols = [], []
    for c, (_n, t) in zip(cols, EXPR_SCHEMA):
        if t.name == "STRING":
            jc = np.array([jtypes.GLOBAL_STRINGS.encode(strings[k])
                           for k in c], np.int32)
            tc = np.array([ttypes.GLOBAL_STRINGS.encode(strings[k])
                           for k in c], np.int32)
        else:
            jc = tc = np.ascontiguousarray(c)
        jcols.append(jc)
        tcols.append(tc)
    ts = 1000 + np.arange(len(kind), dtype=np.int64)
    jb = jev.EventBatch(ts, [jnp.asarray(c) for c in jcols],
                        [jnp.asarray(n) for n in nulls], jnp.asarray(kind),
                        jnp.asarray(valid))
    tb = tev.EventBatch(torch.from_numpy(ts),
                        [torch.from_numpy(c.copy()) for c in tcols],
                        [torch.from_numpy(n.copy()) for n in nulls],
                        torch.from_numpy(kind.copy()),
                        torch.from_numpy(valid.copy()))
    return jb, tb


@functools.lru_cache(maxsize=None)
def batches():
    return batch_pair(*function_columns(ROWS, seed=9))


def reference_eval(texts, jb):
    """Every expression in ``texts`` over ``jb`` in ONE jitted reference
    program. -> [(values, nulls)] as numpy."""
    scope = jexpr.SingleStreamScope(JS)
    ces = [jexpr.compile_expression(jparser.parse_expression(e), scope)
           for e in texts]

    @jax.jit
    def run(b):
        env = jexpr.env_from_batch(b)
        env["__now__"] = jnp.int64(0)
        out = []
        for ce in ces:
            c = ce.fn(env)
            shape = b.ts.shape + jnp.shape(c.values)[1:] \
                if jnp.ndim(c.values) == 2 else b.ts.shape
            out.append((jnp.broadcast_to(c.values, shape),
                        jnp.broadcast_to(c.nulls, b.ts.shape)))
        return out
    return [(np.asarray(v), np.asarray(n)) for v, n in run(jb)]


@functools.lru_cache(maxsize=None)
def reference_results():
    with np.errstate(all="ignore"):
        return dict(zip(CASES, reference_eval(CASES, batches()[0])))


def port_eval(text, tb):
    ce = texpr.compile_expression(tparser.parse_expression(text),
                                  texpr.SingleStreamScope(TS))
    b = texpr.ProgramBuilder()
    b.out(ce)
    cols, nulls, _valid = texpr.expr_eval_ref(b.build(), tb)
    return cols[0].numpy(), nulls[0].numpy()


def bits(a) -> np.ndarray:
    a = np.asarray(a)
    if a.dtype == np.float32:
        return a.view(np.int32)
    if a.dtype == np.float64:
        return a.view(np.int64)
    return a


def ulps(a, b) -> np.ndarray:
    """|a - b| in units in the last place of float64 (NaN vs NaN: 0)."""
    def ordered(x):
        i = x.view(np.int64).astype(object)
        return np.where(i < 0, -(i & 0x7FFFFFFFFFFFFFFF), i)
    d = np.abs(ordered(a) - ordered(b)).astype(np.float64)
    d[np.isnan(a) & np.isnan(b)] = 0
    return d


def assert_bit_equal(j, t, what):
    assert j.shape == t.shape, (what, j.shape, t.shape)
    diff = np.flatnonzero((bits(j) != bits(t)).reshape(j.shape[0], -1)
                          .any(axis=1))
    assert diff.size == 0, (what, int(diff[0]), j[diff[0]], t[diff[0]])


@pytest.mark.parametrize("text", CASES)
def test_function_equals_the_reference(text):
    jv, jn = reference_results()[text]
    tv, tn = port_eval(text, batches()[1])
    assert (jn == tn).all(), f"{text}: null masks differ"
    if text.startswith("sizeOfSet"):
        # the reference's column is int64 under its declared INT
        assert tv.dtype == np.int32 and jv.dtype == np.int64
        assert (jv == tv).all(), text
        return
    assert jv.dtype == tv.dtype, (text, jv.dtype, tv.dtype)
    if not LIBRARY.search(text):
        assert_bit_equal(jv, tv, text)
        return
    d = ulps(jv, tv)
    if text.startswith("math:power("):
        # a subnormal base: XLA's power is far off; hold numpy's instead
        tb = batches()[1]
        base = np.asarray(port_eval(text.split("(", 1)[1].split(",")[0],
                                    tb)[0], np.float64)
        sub = (base != 0) & (np.abs(base) < np.finfo(np.float64).tiny)
        expo = port_eval(text[len("math:power("):-1].split(", ", 1)[1],
                         tb)[0].astype(np.float64)
        with np.errstate(all="ignore"):
            want = np.power(base, expo)
        assert (ulps(want[sub & ~tn], tv[sub & ~tn]) <= 2).all(), text
        d[sub] = 0
    assert d.max() <= 2, (text, float(d.max()),
                          int(np.argmax(d)), jv[np.argmax(d)],
                          tv[np.argmax(d)])
    DIFFERING[text] = int((d > 0).sum())


def test_library_functions_differ_in_few_rows():
    """The count of rows, of the library cases' 512, that differ from
    the reference (all within 2 ulp): at most half of them per case."""
    for text in CASES:
        if LIBRARY.search(text) and text not in DIFFERING:
            test_function_equals_the_reference(text)
    assert DIFFERING, "no library case ran"
    worst = max(DIFFERING.values())
    assert worst <= ROWS // 2, sorted(DIFFERING.items(), key=lambda kv: -kv[1])


# -- traps: maximum/minimum, coalesce, ifThenElse -----------------------------

def _trap_batches():
    """Rows of special values in every argument position: NaN, +-0.0, a
    subnormal, a number and a null, for d, e, f (and the ints)."""
    special = np.array([np.nan, -0.0, 0.0, 5e-324, 1.0, -2.0, np.inf],
                       np.float64)
    k = len(special) + 1          # the last choice is a null
    grid = np.array(np.meshgrid(*[np.arange(k)] * 3)).reshape(3, -1)
    n = grid.shape[1]
    cols, nulls, kind, valid = function_columns(n, seed=2)
    names = [nm for nm, _t in EXPR_SCHEMA]
    for pos, name in zip(grid, ("d", "e", "f")):
        c = names.index(name)
        vals = special[np.minimum(pos, k - 2)]
        cols[c] = vals.astype(cols[c].dtype)
        nulls[c] = pos == k - 1
    for name in ("i", "j", "l", "m"):
        c = names.index(name)
        nulls[c] = np.arange(n) % 5 == 0
    return batch_pair(cols, nulls, np.zeros(n, np.int32),
                      np.ones(n, np.bool_))


TRAPS = ["maximum(d, e)", "maximum(d, e, f)", "minimum(d, e, f)",
         "maximum(f, d)", "minimum(e, d)", "maximum(d, e, f, i)",
         "minimum(i, l, d)", "maximum(i, j)", "minimum(l, m, i)",
         "coalesce(d, e, f)", "coalesce(i, l, d)", "coalesce(f, i)",
         "coalesce(j, m)", "default(d, e)", "default(i, f)",
         "ifThenElse(d > e, 'HIGH', 'LOW')", "ifThenElse(d > e, s, t)",
         "ifThenElse(d > e, i, d)", "ifThenElse(d is null, e, f)",
         "math:abs(d)", "math:signum(d)", "math:round(f)", "math:ceil(e)",
         "convert(d, 'float')", "convert(f, 'long')", "createSet(d)",
         "createSet(f)"]


@functools.lru_cache(maxsize=None)
def trap_results():
    jb, tb = _trap_batches()
    with np.errstate(all="ignore"):
        return dict(zip(TRAPS, reference_eval(TRAPS, jb))), tb


@pytest.mark.parametrize("text", TRAPS)
def test_function_traps_bit_equal(text):
    ref, tb = trap_results()
    jv, jn = ref[text]
    tv, tn = port_eval(text, tb)
    assert (jn == tn).all(), text
    assert_bit_equal(jv, tv, text)


# XLA's simplifier takes abs, exp, x * x of one column, selects of such and
# constants >= 0 for non-negative: compared with a literal +0, `>= 0` is
# TRUE and `< 0` FALSE even for NaN (or INT_MIN's abs); the port's
# compiler applies the same rewrite
NONNEG = ["math:abs(d) >= 0.0", "math:abs(d) < 0", "0 <= math:abs(f)",
          "0.0 > math:exp(d)", "d * d >= 0.0", "math:abs(i) < 0",
          "ifThenElse(b, math:abs(d), 2.0) >= 0.0",
          "coalesce(math:abs(d), 1.0) >= 0",
          "maximum(math:abs(d), math:exp(e)) >= 0.0",
          "math:abs(d) * 2.0 >= 0.0", "math:sqrt(math:abs(d)) >= 0.0",
          "math:abs(d) > 0.0", "math:abs(d) >= -0.0",
          "(d + 1.0) * (d + 1.0) >= 0.0", "f * f >= 0", "i * i < 0",
          "0L <= math:abs(l)", "minimum(math:abs(d), 0.0) >= 0.0",
          "default(math:abs(d), 3.0) < 0.0", "math:abs(i) >= 0.0"]


@functools.lru_cache(maxsize=None)
def nonneg_results():
    with np.errstate(all="ignore"):
        return dict(zip(NONNEG, reference_eval(NONNEG, batches()[0])))


@pytest.mark.parametrize("text", NONNEG)
def test_non_negative_compares_as_the_reference(text):
    jv, jn = nonneg_results()[text]
    tv, tn = port_eval(text, batches()[1])
    assert (jn == tn).all(), text
    assert_bit_equal(jv, tv, text)


# -- constant folding ------------------------------------------------------------

CONSTANTS = ["convert(3.7, 'int')", "convert(-3e9, 'int')",
             "convert(1e20, 'long')", "cast(1e300, 'float')",
             "convert(true, 'double')", "math:sqrt(2)", "math:exp(1)",
             "math:ln(10)", "math:log10(2)", "math:sin(1)", "math:cos(2)",
             "math:tan(0.5)", "math:asin(0.3)", "math:acos(0.3)",
             "math:atan(3)", "math:power(2, 0.5)", "math:power(10, -3)",
             "math:round(-2.5)", "math:round(3.5)", "math:ceil(-0.5)",
             "math:floor(0.5)", "math:signum(-0.0)", "math:signum(-3)",
             "math:abs(-7)", "maximum(1, 2.5)", "minimum(3L, 2)",
             "coalesce(1, 2L)", "default(2.5f, 1.0)",
             "ifThenElse(false, 1, 2.0)", "instanceOfLong(5L)",
             "math:sqrt(-1.0) is null", "math:ln(0.0)"]


@functools.lru_cache(maxsize=None)
def constant_results():
    jb, _tb = batches()
    with np.errstate(all="ignore"):
        return dict(zip(CONSTANTS, reference_eval(CONSTANTS, jb)))


@pytest.mark.parametrize("text", CONSTANTS)
def test_constant_folds_to_the_reference_bits(text):
    """A call whose arguments are constant folds at plan time, to the
    bits the reference's numpy constants and XLA's constant folder give
    (the math library folds with the C library, as XLA's folder does)."""
    ce = texpr.compile_expression(tparser.parse_expression(text),
                                  texpr.SingleStreamScope(TS))
    assert ce.is_const, text
    jv, jn = constant_results()[text]
    tv, tn = port_eval(text, batches()[1])
    assert (jn == tn).all(), text
    assert_bit_equal(jv, tv, text)


# -- through the apps: clocks, uuid(), the reference's filter cases ---------------

def _rows(pkg, app, sends, out="Out"):
    kw = {"device": "cpu"} if pkg is T else {}
    rt = pkg.SiddhiManager(**kw).create_siddhi_app_runtime(app)
    got = []
    rt.add_callback(out, pkg.StreamCallback(
        fn=lambda evs: got.extend((e.timestamp, e.data) for e in evs)))
    rt.start()
    h = rt.get_input_handler("S")
    for ts, row in sends:
        h.send(pkg.Event(ts, row))
    rt.shutdown()
    return got


def test_clocks_under_playback_equal_the_reference():
    """currentTimeMillis() is the step's clock (the playback clock) and
    eventTimestamp() the row's, in a filter, a projection and having."""
    app = """@app:playback
        define stream S (a int, b double);
        from S[currentTimeMillis() >= eventTimestamp()]
        select a, currentTimeMillis() as now, eventTimestamp() as ts,
               eventTimestamp() - currentTimeMillis() as lag
        having now > 1000L
        insert into Out;"""
    sends = [(1000 + 7 * k, (k, k * 0.5)) for k in range(12)]
    got = _rows(T, app, sends)
    assert got == _rows(J, app, sends)
    assert [r[1][1] for r in got] == [ts for ts, _ in sends][1:]


def test_uuid_rows_are_fresh_and_well_formed():
    app = """define stream S (a int);
        from S select uuid() as u, uuid() as v, a insert into Out;"""
    got = _rows(T, app, [(1000 + k, (k,)) for k in range(50)])
    seen = set()
    for _ts, (u, v, _a) in got:
        for x in (u, v):
            assert str(uuid.UUID(x)) == x
            seen.add(x)
    assert len(seen) == 100


def test_filter_function_cases_replay():
    """tests/test_filter.py's function cases (test_functions,
    test_send_event_objects), through both packages."""
    app = """define stream S (a int, b int);
        from S select coalesce(a, b) as c, ifThenElse(a > b, a, b) as mx,
                      maximum(a, b) as mx2, minimum(a, b) as mn,
                      convert(a, 'double') as ad
        insert into Out;"""
    sends = [(1000, (5, 3)), (1001, (None, 7))]
    got = _rows(T, app, sends)
    assert got == _rows(J, app, sends)
    assert [d for _ts, d in got] == [(5, 5, 5, 3, 5.0), (7, 7, 7, 7, None)]
    app = """define stream S (a int);
        from S select a, eventTimestamp() as ts insert into Out;"""
    assert _rows(T, app, [(12345, (9,))]) == [(12345, (9, 12345))]


@pytest.mark.parametrize("text,error", [
    ("convert(s, 'int')", J.ops.expr.CompileError),
    ("convert(i, 'bool')", J.ops.expr.CompileError),
    ("convert(i, 'short')", J.ops.expr.CompileError),
    ("coalesce(i, s)", J.ops.expr.CompileError),
    ("ifThenElse(i, 1, 2)", J.ops.expr.CompileError),
    ("maximum(s, i)", J.ops.expr.CompileError),
    ("math:power(i)", J.ops.expr.CompileError),
    ("nosuch(i)", J.ops.expr.CompileError),
    ("sizeOfSet(i)", J.ops.expr.CompileError),
    ("createSet(i, l)", J.ops.expr.CompileError)])
def test_compile_errors_as_the_reference(text, error):
    with pytest.raises(error):
        jexpr.compile_expression(jparser.parse_expression(text),
                                 jexpr.SingleStreamScope(JS))
    with pytest.raises(texpr.CompileError):
        texpr.compile_expression(tparser.parse_expression(text),
                                 texpr.SingleStreamScope(TS))


def test_script_and_pattern_clock_raise_not_ported():
    """A registered or script function, and eventTimestamp() in a
    pattern condition (the reference binds no row timestamp there)."""
    with pytest.raises(NotImplementedError, match="not ported yet"):
        texpr.compile_expression(
            tparser.parse_expression("f(i)"), texpr.SingleStreamScope(TS),
            {"f": object()})
    app = """@app:playback
        define stream S (a int);
        from every e1=S[eventTimestamp() > 0] -> e2=S[a > e1.a]
        select e1.a as a1 insert into Out;"""
    with pytest.raises(NotImplementedError, match="not ported yet"):
        T.SiddhiManager(device="cpu").create_siddhi_app_runtime(app)
