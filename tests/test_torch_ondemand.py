"""On-demand queries over in-memory tables (core/ondemand.py, with the
table view of kernel K8 and K2 on the CPU) against the reference: the
same table contents, the same query texts; the results (rows in order,
floats by their bits; or the number of rows a write touched) and the
table's whole state after each query are equal. On-demand queries on
named windows and aggregations are in test_torch_named_window.py and
test_torch_aggregation.py."""
import pytest
import torch

import siddhi_tpu as J
import siddhi_tpu_torch as T
from test_torch_join_shapes import MultiRun, compare_runs, norm

torch.set_num_threads(1)

APP = """
    @app:playback
    define stream S (sym string, price double, vol long, n int);
    @PrimaryKey('sym')
    define table ST (sym string, price double, vol long, n int);
    @info(name = 'fill') from S select sym, price, vol, n insert into ST;
"""
ROWS = [("IBM", 10.5, 100, 1), ("WSO2", 20.25, 200, 2),
        ("GOOG", 30.0, 300, 1), ("MSFT", 40.75, None, 3),
        ("ORCL", None, 500, 2), ("SAP", 5.5, 600, 3)]

QUERIES = [
    "from ST select *",
    "from ST on price > 15.0 select sym, price",
    "from ST on vol is null select sym, n",
    "from ST select sym, price * 2 as p2, vol + n as vn order by p2 desc",
    "from ST select n, sum(price) as sp, count() as c, max(vol) as mv "
    "group by n order by n",
    "from ST select avg(price) as ap, min(vol) as mv, distinctCount(n) as d",
    "from ST select sym order by sym limit 3 offset 1",
    "from ST as t on t.n == 2 select t.sym, t.vol",
    "delete ST on ST.sym == 'GOOG'",
    "from ST select sym",
    "update ST set ST.price = 99.5 on ST.sym == 'IBM'",
    "update ST set ST.vol = 7 on ST.n >= 2",
    "update or insert into ST set ST.sym = 'NEW', ST.n = 9 "
    "on ST.sym == 'NEW'",
    "update or insert into ST set ST.n = 4 on ST.sym == 'SAP'",
    "select 'CSCO' as sym, 1.25 as price, 10L as vol, 5 as n insert into ST",
    "from ST select *",
    "delete ST on ST.price < 20.0",
    "from ST select * order by sym",
]


def _norm_result(res):
    if isinstance(res, list):
        return [tuple(norm(x) for x in r) for r in res]
    return res


def test_on_demand_queries_equal_the_reference():
    runs = [MultiRun(pkg, APP) for pkg in (J, T)]
    for r in runs:
        r.send("S", [(1000 + i, row) for i, row in enumerate(ROWS)])
    compare_runs(*runs, "fill")
    for q in QUERIES:
        got = [_norm_result(r.rt.query(q)) for r in runs]
        assert got[0] == got[1], q
        compare_runs(*runs, q)


def test_on_demand_queries_on_windows_raise_not_ported():
    rt = T.SiddhiManager(device="cpu").create_siddhi_app_runtime(APP)
    rt.start()
    with pytest.raises(Exception, match="not a defined table"):
        rt.query("from W select *")
