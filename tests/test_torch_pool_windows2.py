"""The timed K5 kinds with a slot axis in a tenant pool's chain against
the reference's TenantPool, on the CPU: timeLength, delay and hopping
(A[K]), each behind a ``${...}`` filter (test_torch_pool_windows.py has
externalTime, sort, frequent and session; _windows3.py batch,
externalTimeBatch and lossyFrequent). Four tenants on eight slots, 150
rows each (``checks.pool_windows_feed``, the module's own user names)
in chunks of 50, ``batch_max`` 128; after every fair round and after
``advance_time`` (timed kinds advance only on rounds and advances in a
pool, as in the reference), each tenant's rows, the whole stacked
states and the ``emitted`` counters equal the reference pool's, bit for
bit."""
import numpy as np
import torch

from siddhi_tpu_torch.checks import (POOL_WINDOW_USERS,
                                     pool_windows_bindings,
                                     pool_windows_feed, user_symbols)
from siddhi_tpu_torch.core.types import GLOBAL_STRINGS as TSTR
from siddhi_tpu_torch.ops import windows2 as W2
from test_torch_pool_chain import Pair, chunks
from test_torch_window import align_strings

torch.set_num_threads(1)

PREFIX = "pv"
STREAM = """
define stream S (ets long, k long, v double, user string);
"""
TEMPLATE = STREAM + """
@info(name='tl')
from S[v > ${lo:double}]#window.timeLength(40 milliseconds, 4)
select k, v
insert all events into TlOut;
@info(name='dl')
from S[v > ${lo:double}]#window.delay(20 milliseconds)
select k, v
insert into DlOut;
@info(name='hop')
from S[v > ${lo:double}]#window.hopping(60 milliseconds, 30 milliseconds)
select k, v
insert into HopOut;
"""


def run_pool(template, prefix, kinds, advance=True):
    """Four tenants of ``template`` in both packages (Pair checks rows,
    states and emitted after every round); -> the pair."""
    align_strings(user_symbols(POOL_WINDOW_USERS, prefix))
    rng = np.random.default_rng(11)
    pair = Pair(template, slots=8, max_tenants=8, batch_max=128)
    ops = {type(op) for q in pair.t.proto.queries.values()
           for op in q.operators}
    assert set(kinds) <= ops
    feeds = {}
    last = 0
    for i in range(4):
        tid = f"v{i}"
        pair.add(tid, {k: v for k, v in pool_windows_bindings(i).items()
                       if "${" + k in template})
        ts, cols = pool_windows_feed(150, TSTR.encode, 400 + i, prefix)
        last = max(last, int(ts[-1]))
        feeds[tid] = list(chunks(rng, ts, cols, lo=50, hi=51))
    rounds = 0
    while any(feeds.values()):
        for tid, fs in feeds.items():
            if fs:
                pair.send(tid, *fs.pop(0))
        rounds += pair.flush()
    if advance:
        pair.advance_time(last + 200)
    assert rounds >= 3
    for i in range(4):
        rows = pair.rows.get(("t", f"v{i}"), [])
        assert rows and rows == pair.rows.get(("j", f"v{i}"), [])
    stats, jst = pair.t.statistics(), pair.j.statistics()
    for tid, entry in stats["tenants"].items():
        assert entry["emitted"] == jst["tenants"][tid]["emitted"]
    return pair


def test_timed_kinds_in_a_pool_equal_the_reference():
    run_pool(TEMPLATE, PREFIX, (W2.TimeLengthWindowOp, W2.DelayWindowOp,
                                W2.HoppingWindowOp))
