"""Canonical expression signatures (port of siddhi_tpu/plan/canon.py).

Only ``canonical_expr`` is carried: the ``shareable-prefix`` plan rule
(analysis/plan_rules.py) keys on it. The plan optimizer that also uses
it in the reference is not ported yet.

``canonical_expr`` renders a SiddhiQL AST expression into a stable
string such that two expressions with the SAME canonical string are
guaranteed to evaluate to bit-identical results over the same input
batch: commutative and/or chains flatten and sort, ``==``/``!=`` sort
their operands, ordered comparisons normalise to ``<``/``<=``, and
binary ``+``/``*`` sort their operands. Unknown node types render with
a unique marker so they can never collide.
"""
from __future__ import annotations

from ..lang import ast as A

_ORDERED_FLIP = {">": "<", ">=": "<="}


def _flatten(e, cls):
    """Flatten a left/right tree of one commutative boolean class."""
    if isinstance(e, cls):
        yield from _flatten(e.left, cls)
        yield from _flatten(e.right, cls)
    else:
        yield e


def canonical_expr(e) -> str:
    """Stable canonical rendering (see module docstring). Total over
    the expression AST: unknown nodes get an identity-unique marker."""
    if e is None:
        return "none"
    if isinstance(e, A.Constant):
        t = e.type.value if e.type is not None else "?"
        return f"c[{t}]{e.value!r}"
    if isinstance(e, A.Variable):
        idx = "" if e.index is None else f"@{e.index}"
        fr = "" if e.function_ref is None else f"#{e.function_ref}"
        ref = e.stream_ref or ""
        inner = "#" if e.is_inner else ("!" if e.is_fault else "")
        return f"v[{inner}{ref}]{e.attribute}{idx}{fr}"
    if isinstance(e, A.AttributeFunction):
        ns = e.namespace or ""
        args = "*" if e.star else \
            ",".join(canonical_expr(p) for p in e.parameters)
        return f"f:{ns}:{e.name.lower()}({args})"
    if isinstance(e, A.MathOp):
        left, right = canonical_expr(e.left), canonical_expr(e.right)
        if e.op in ("+", "*") and right < left:
            left, right = right, left
        return f"({left}{e.op}{right})"
    if isinstance(e, A.Compare):
        left, right = canonical_expr(e.left), canonical_expr(e.right)
        op = e.op
        if op in ("==", "!=") and right < left:
            left, right = right, left
        elif op in _ORDERED_FLIP:
            op = _ORDERED_FLIP[op]
            left, right = right, left
        return f"({left}{op}{right})"
    if isinstance(e, (A.And, A.Or)):
        cls = type(e)
        word = "and" if cls is A.And else "or"
        parts = sorted(canonical_expr(p) for p in _flatten(e, cls))
        return "(" + f" {word} ".join(parts) + ")"
    if isinstance(e, A.Not):
        return f"not({canonical_expr(e.expr)})"
    if isinstance(e, A.IsNull):
        if e.expr is not None:
            return f"isnull({canonical_expr(e.expr)})"
        return (f"isnull[{e.stream_ref}@{e.stream_index}"
                f"{'#' if e.is_inner else ''}]")
    if isinstance(e, A.InTable):
        return f"in[{e.table_id}]({canonical_expr(e.expr)})"
    if isinstance(e, A.TemplateParam):
        t = e.type.value if e.type is not None else "?"
        return f"tp[{t}]{e.name}"
    # conservative: unknown node types never collide, never share
    return f"opaque:{type(e).__name__}:{id(e):x}"
