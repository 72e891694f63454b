"""Table helpers (port of the host part of siddhi_tpu/ops/table.py).

Only ``expr_mentions_table`` is carried: the plan rules and the planner
use it to tell table-referencing filters apart. Device tables are not
ported yet; the planner raises NotImplementedError for them."""
from __future__ import annotations

from ..lang import ast as A


def expr_mentions_table(expr: A.Expression) -> bool:
    if isinstance(expr, A.InTable):
        return True
    if isinstance(expr, (A.MathOp, A.Compare, A.And, A.Or)):
        return expr_mentions_table(expr.left) or \
            expr_mentions_table(expr.right)
    if isinstance(expr, A.Not):
        return expr_mentions_table(expr.expr)
    if isinstance(expr, A.IsNull) and expr.expr is not None:
        return expr_mentions_table(expr.expr)
    return False
