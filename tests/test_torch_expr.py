"""Kernel K2's plain version against the reference expression compiler:
every ported node, type pairing and trap case (ops/expr.py) gives
bit-equal values and null masks to the JAX compile_expression (run under
jax.jit on the CPU), tolerance 0; filters and whole filter+project steps
give equal keep masks and columns."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import siddhi_tpu.core.event as jev
import siddhi_tpu.core.types as jtypes
import siddhi_tpu.lang.ast as JA
import siddhi_tpu.lang.parser as jparser
import siddhi_tpu.ops.expr as jexpr
import siddhi_tpu.ops.operators as jops
import siddhi_tpu.ops.selector as jsel
import siddhi_tpu_torch.core.event as tev
import siddhi_tpu_torch.core.runtime as truntime
import siddhi_tpu_torch.core.types as ttypes
import siddhi_tpu_torch.lang.ast as TA
import siddhi_tpu_torch.lang.parser as tparser
import siddhi_tpu_torch.ops.expr as texpr
import siddhi_tpu_torch.ops.operators as tops
import siddhi_tpu_torch.ops.selector as tsel
from siddhi_tpu_torch.checks import (EXPR_SCHEMA, EXPR_STRINGS, expr_cases,
                                     expr_columns, filter_cases)

torch.set_num_threads(1)

ROWS = 512


def _schemas():
    js = jev.StreamSchema("S", tuple(
        jev.Attribute(n, jtypes.AttrType[t.name]) for n, t in EXPR_SCHEMA))
    ts = tev.StreamSchema("S", tuple(
        tev.Attribute(n, t) for n, t in EXPR_SCHEMA))
    return js, ts


JS, TS = _schemas()


@functools.lru_cache(maxsize=None)
def batches(seed: int = 9):
    """The same random columns as a JAX and a port EventBatch; STRING
    columns carry each package's own dictionary codes."""
    cols, nulls, kind, valid = expr_columns(ROWS, seed)
    jcols, tcols = [], []
    for c, (_n, t) in zip(cols, EXPR_SCHEMA):
        if t.name == "STRING":
            jc = np.array([jtypes.GLOBAL_STRINGS.encode(EXPR_STRINGS[k])
                           for k in c], np.int32)
            tc = np.array([ttypes.GLOBAL_STRINGS.encode(EXPR_STRINGS[k])
                           for k in c], np.int32)
        else:
            jc = tc = c
        jcols.append(jc)
        tcols.append(tc)
    ts = np.arange(ROWS, dtype=np.int64)
    jb = jev.EventBatch(ts, [jnp.asarray(c) for c in jcols],
                        [jnp.asarray(n) for n in nulls], jnp.asarray(kind),
                        jnp.asarray(valid))
    tb = tev.EventBatch(torch.from_numpy(ts),
                        [torch.from_numpy(c.copy()) for c in tcols],
                        [torch.from_numpy(n.copy()) for n in nulls],
                        torch.from_numpy(kind.copy()),
                        torch.from_numpy(valid.copy()))
    return jb, tb


def bits(a) -> np.ndarray:
    a = np.asarray(a)
    if a.dtype == np.float32:
        return a.view(np.int32)
    if a.dtype == np.float64:
        return a.view(np.int64)
    return a


def assert_bit_equal(j, t, what):
    j, t = np.asarray(j), t.numpy()
    assert j.dtype == t.dtype, (what, j.dtype, t.dtype)
    diff = np.flatnonzero(bits(j) != bits(t))
    assert diff.size == 0, (what, int(diff[0]), j[diff[0]], t[diff[0]])


def jax_eval(expr_ast):
    ce = jexpr.compile_expression(expr_ast, jexpr.SingleStreamScope(JS))
    jb, _ = batches()

    @jax.jit
    def run(b):
        c = ce.fn(jexpr.env_from_batch(b))
        return (jnp.broadcast_to(c.values, b.ts.shape),
                jnp.broadcast_to(c.nulls, b.ts.shape))
    return run(jb)


def port_eval(expr_ast):
    ce = texpr.compile_expression(expr_ast, texpr.SingleStreamScope(TS))
    b = texpr.ProgramBuilder()
    b.out(ce)
    _, tb = batches()
    cols, nulls, _valid = texpr.expr_eval_ref(b.build(), tb)
    return cols[0], nulls[0]


@pytest.mark.parametrize("text", expr_cases())
def test_expression_bit_equal(text):
    jv, jn = jax_eval(jparser.parse_expression(text))
    tv, tn = port_eval(tparser.parse_expression(text))
    assert_bit_equal(jv, tv, f"{text}: values")
    assert_bit_equal(jn, tn, f"{text}: nulls")


@pytest.mark.parametrize("type_name", ["INT", "LONG", "FLOAT", "DOUBLE",
                                       "BOOL", "STRING"])
def test_typed_null_literal(type_name):
    """A NULL literal the AST types (the reference rewrites out-of-range
    e[i].attr to one): null in math, compares and IS NULL."""
    other = {"INT": "i", "LONG": "l", "FLOAT": "f", "DOUBLE": "d",
             "BOOL": "b", "STRING": "s"}[type_name]
    for mod, AST, types in ((jparser, JA, jtypes), (tparser, TA, ttypes)):
        pass
    for build in (
            lambda A, T, v: A.IsNull(expr=A.Constant(None, T)),
            lambda A, T, v: A.Compare(left=v, op="==",
                                      right=A.Constant(None, T)),
            lambda A, T, v: A.Not(expr=A.IsNull(expr=A.Constant(None, T)))):
        jt = jtypes.AttrType[type_name]
        tt = ttypes.AttrType[type_name]
        jv, jn = jax_eval(build(JA, jt, JA.Variable(attribute=other)))
        tv, tn = port_eval(build(TA, tt, TA.Variable(attribute=other)))
        assert_bit_equal(jv, tv, type_name)
        assert_bit_equal(jn, tn, type_name)
    if type_name not in ("BOOL", "STRING"):
        expr = lambda A, T: A.MathOp(  # noqa: E731
            left=A.Variable(attribute=other), op="+",
            right=A.Constant(None, T))
        jv, jn = jax_eval(expr(JA, jtypes.AttrType[type_name]))
        tv, tn = port_eval(expr(TA, ttypes.AttrType[type_name]))
        assert_bit_equal(jv, tv, type_name)
        assert_bit_equal(jn, tn, type_name)


@pytest.mark.parametrize("text", filter_cases())
def test_filter_keep_mask_equal(text):
    jcond = jexpr.compile_expression(jparser.parse_expression(text),
                                     jexpr.SingleStreamScope(JS))
    tcond = texpr.compile_expression(tparser.parse_expression(text),
                                     texpr.SingleStreamScope(TS))
    jb, tb = batches()
    _, jout = jax.jit(lambda b: jops.FilterOp(jcond, JS).step((), b, 0))(jb)
    _, tout = tops.FilterOp(tcond, TS).step((), tb, 0)
    assert_bit_equal(jout.valid, tout.valid, text)


STEPS = [
    ("f > 100.0", "s, f", "current"),
    ("i / j > 0", "i / j as q, l % m as r, d * e as p", "all"),
    ("not (b and c) or s == 'IBM'", "*", "expired"),
    ("l < 3", "f + d as x, i is null as n, b or c as o", "current"),
    ("d is null", "s, t, s == t as eq", "all"),
]


@pytest.mark.parametrize("cond,select,out", STEPS)
def test_filter_project_step_equal(cond, select, out):
    """One whole step: the JAX FilterOp+ProjectOp chain under jax.jit
    against the port's single lowered program (one K2 program)."""
    qtext = (f"from S[{cond}] select {select} insert {out} events "
             "into O;")
    jq, tq = jparser.parse_query(qtext), tparser.parse_query(qtext)
    cur, exp = out in ("current", "all"), out in ("expired", "all")
    jscope, tscope = jexpr.SingleStreamScope(JS), texpr.SingleStreamScope(TS)
    jf = jops.FilterOp(jexpr.compile_expression(
        jq.input.handlers[0].expression, jscope), JS)
    jp = jsel.ProjectOp(jq.selector, JS, "O", jscope, current_on=cur,
                        expired_on=exp)
    tf = tops.FilterOp(texpr.compile_expression(
        tq.input.handlers[0].expression, tscope), TS)
    tp = tsel.ProjectOp(tq.selector, TS, "O", tscope, current_on=cur,
                        expired_on=exp)
    jb, tb = batches()

    @jax.jit
    def jstep(b):
        _, b = jf.step((), b, 0)
        return jp.step((), b, 0)[1]

    jout = jstep(jb)
    emitted = torch.zeros((), dtype=torch.int64)
    _, tout = truntime._chain_body([tf, tp])((), emitted, tb, 0)
    assert_bit_equal(jout.valid, tout.valid, "valid")
    assert int(emitted) == int(np.asarray(jout.valid).sum())
    for k, (jc, tc) in enumerate(zip(jout.cols, tout.cols)):
        if tp.out_schema.types[k].name == "STRING":
            continue   # codes differ per package; compared decoded below
        assert_bit_equal(jc, tc, f"col {k}")
    for k, (jn, tn) in enumerate(zip(jout.nulls, tout.nulls)):
        assert_bit_equal(jn, tn, f"nulls {k}")
    jrows = jev.rows_from_batch(jp.out_schema.types, jax.device_get(jout))
    trows = tev.rows_from_batch(tp.out_schema.types, tout)
    assert [repr(r) for r in jrows] == [repr(r) for r in trows]


@pytest.mark.parametrize("text,error", [
    ("s > t", "CompileError"), ("s == 3", "CompileError"),
    ("i + b", "CompileError"), ("not i", "CompileError"),
    ("b and i", "CompileError"), ("i / 2147483648", "OverflowError"),
])
def test_rejected_expressions_raise_same_error(text, error):
    for mod, scope in ((jexpr, jexpr.SingleStreamScope(JS)),
                       (texpr, texpr.SingleStreamScope(TS))):
        parser = jparser if mod is jexpr else tparser
        with pytest.raises(Exception) as ei:
            mod.compile_expression(parser.parse_expression(text), scope)
        assert type(ei.value).__name__ == error, (mod.__name__, ei.value)


def test_functions_are_not_ported_yet():
    """The built-in functions compile (tests/test_torch_functions.py holds
    them to the reference); a registered or script function, whose body
    is user Python over jnp arrays, still raises."""
    ce = texpr.compile_expression(tparser.parse_expression("coalesce(i, j)"),
                                  texpr.SingleStreamScope(TS))
    assert ce.type is ttypes.AttrType.INT
    with pytest.raises(NotImplementedError, match="not ported yet"):
        texpr.compile_expression(tparser.parse_expression("f(i, j)"),
                                 texpr.SingleStreamScope(TS), {"f": object()})


SUBNORMAL_CASES = ["x + y", "x - y", "x * y", "x / y", "x % y", "x > y",
                   "x == y", "x * 1.0f", "x + 0.0f", "x / 4.0f", "x * -1.0f",
                   "x < 1.0", "x + 1.0", "x / 1e-300", "x % 2.0f",
                   "x % 1.0f", "x % -4", "x % 3.0f"]


@pytest.mark.parametrize("text", SUBNORMAL_CASES)
def test_subnormals_flush_like_the_reference(text):
    """The reference's XLA CPU code runs with subnormals flushed to zero
    (operands and results of + - * /, compare operands, FLOAT -> DOUBLE;
    not fmod), and its compiler rewrites x * 1, x + 0, x / c; the port
    matches it bit for bit on subnormal inputs."""
    tiny = np.array([1e-40, -1e-40, 1e-39, 3e-39, 0.0, -0.0, 1e-38,
                     np.nan, -np.inf, 2.0, 1.2e-38, -1.1e-38], np.float32)
    other = np.array([0.0, 1e-40, -1e-39, 1e-39, 1e-40, 2.0, -1e-38,
                      1.0, 3e-39, np.nan, -1.1e-38, 1.2e-38], np.float32)
    n = tiny.size
    nul = np.zeros(n, np.bool_)
    kind, valid = np.zeros(n, np.int32), np.ones(n, np.bool_)
    js = jev.StreamSchema("T", (
        jev.Attribute("x", jtypes.AttrType.FLOAT),
        jev.Attribute("y", jtypes.AttrType.FLOAT)))
    tsch = tev.StreamSchema("T", (
        tev.Attribute("x", ttypes.AttrType.FLOAT),
        tev.Attribute("y", ttypes.AttrType.FLOAT)))
    jb = jev.EventBatch(np.arange(n), [tiny, other], [nul, nul], kind, valid)
    tb = tev.EventBatch(torch.arange(n), [torch.from_numpy(tiny),
                                          torch.from_numpy(other)],
                        [torch.from_numpy(nul)] * 2, torch.from_numpy(kind),
                        torch.from_numpy(valid))
    jce = jexpr.compile_expression(jparser.parse_expression(text),
                                   jexpr.SingleStreamScope(js))

    @jax.jit
    def run(b):
        c = jce.fn(jexpr.env_from_batch(b))
        return (jnp.broadcast_to(c.values, b.ts.shape),
                jnp.broadcast_to(c.nulls, b.ts.shape))
    jv, jn = run(jb)
    tce = texpr.compile_expression(tparser.parse_expression(text),
                                   texpr.SingleStreamScope(tsch))
    pb = texpr.ProgramBuilder()
    pb.out(tce)
    cols, nulls, _v = texpr.expr_eval_ref(pb.build(), tb)
    assert_bit_equal(jv, cols[0], text)
    assert_bit_equal(jn, nulls[0], text)


# constant subexpressions at any depth fold in plain IEEE (no flush),
# as the reference's numpy and XLA constant folding compute them
NESTED_CONST_CASES = [
    "(1e-39f + 0.0f) * 1.0f", "(1e-39f + 0.0f) + 1e-39f",
    "(1e-39f * 1.0f) * 1.0f", "(1e-39f + 1e-39f) * 2.0f",
    "((1e-39f + 0.0f) + 0.0f) * 1.0f", "(1e-39f + 0.0f) - 1e-40f",
    "(1e-39f + 0.0f) / 2.0f", "(1e-39f + 0.0f) * -1.0f",
    "(2.0f * 1e-39f) % 1e-40f", "(1e-39f + 0.0f) > 0.0f",
    "(1e-39f + 0.0f) == 0.0f", "(1e-39f + 0.0f) + 0.0",
    "1e-39f / 1.0f", "1.0f / 3e38f", "1e-39f / 1e-39f",
    "(5.0f + 0.0f) % (1e-40f + 0.0f)", "(1.0f / 1e-40f) is null",
    "d + (1e-39f + 0.0f)", "d * ((1e-39f + 0.0f) + 0.0)",
    "i / (1e-40f + 0.0f)", "f / (1e-40f + 0.0f)", "5.0 / (3.0 + 0.0)",
]


@pytest.mark.parametrize("text", NESTED_CONST_CASES)
def test_nested_constants_fold_like_the_reference(text):
    jv, jn = jax_eval(jparser.parse_expression(text))
    tv, tn = port_eval(tparser.parse_expression(text))
    assert_bit_equal(jv, tv, f"{text}: values")
    assert_bit_equal(jn, tn, f"{text}: nulls")


# a subnormal constant divisor passes the reference's zero test (run on
# the constant, unflushed) and then reads as zero in the % that runs:
# NaN for every row, never null
SUBNORMAL_DIVISOR_CASES = ["f % 1e-40f", "f % -1e-40f", "d % 1e-310",
                           "l % 1e-40f", "i % 1e-40f", "f % (1e-40f + 0.0f)",
                           "d % (1e-310 + 0.0)", "f % (1e-40f * 1.0f)"]


@pytest.mark.parametrize("text", SUBNORMAL_DIVISOR_CASES)
def test_subnormal_constant_divisor_gives_nan(text):
    jv, jn = jax_eval(jparser.parse_expression(text))
    tv, tn = port_eval(tparser.parse_expression(text))
    assert_bit_equal(jv, tv, f"{text}: values")
    assert_bit_equal(jn, tn, f"{text}: nulls")
    assert torch.isnan(tv[~tn]).all() and not tn.all()   # nulls: x's own


QUEUE3_APP = """
@app:playback
define stream S (x float);
@info(name = 'q')
from S select x % 1e-40f as r, (1e-39f + 0.0f) * 1.0f as q
insert into O;
"""


def test_queue3_example_app_matches_the_reference():
    """The two repaired faults through both packages' SiddhiManager:
    r is NaN (not null) and q keeps the subnormal 1e-39f."""
    import siddhi_tpu as J
    import siddhi_tpu_torch as T
    got = {}
    for pkg in (J, T):
        kw = {"device": "cpu"} if pkg is T else {}
        rt = pkg.SiddhiManager(**kw).create_siddhi_app_runtime(QUEUE3_APP)
        rows = []
        rt.add_callback("O", pkg.StreamCallback(rows.extend))
        rt.start()
        rt.get_input_handler("S").send([pkg.Event(1, (3.5,)),
                                        pkg.Event(2, (1e-39,))])
        got[pkg] = [e.data for e in rows]
    for (jr, jq), (tr, tq) in zip(got[J], got[T]):
        assert np.isnan(jr) and np.isnan(tr)
        assert tq == jq == 1.0000002153053333e-39
    assert len(got[T]) == len(got[J]) == 2
