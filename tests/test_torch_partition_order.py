"""Order by, offset and limit (kernel G[K]), stream functions and output
rate limiting inside a partition block against the reference's
partition runtime, on the CPU, where G[K] runs its plain version
(ops/selector.py shape_chunk_slots_ref) over the block's slot axis.

checks.PARTITION_TOP_APP at ``@slots('64')`` (its projection's top three
of each lengthBatch(16), its running averages ordered after K6[K] with
``limit 2 offset 1`` and ``output last every 5 sec``) takes
``trades_feed``'s values for 120 tickers, skewed (so the last ones
find no slot and their rows are dropped and counted), 0-120 ms apart,
in uneven sends;
the clock is then driven past the last limiter period. After every send
and after the clock's advance the rows of both outputs, each query's
``stats()``, the whole block state and the limiter's state equal the
reference's, tolerance 0. Also, each against the reference: a STRING
order key (the reference's block leaves the rows unordered, with no
offset or limit: ROADMAP Queue 3, kept), offset and limit alone, a
an event-count limiter,
``#pol2Cart`` and ``#log`` (the printed lines captured), and a
rate-limited block whose state (the limiter's kept row included) is
carried from the reference mid-feed through carry.block_from_jax. (A
template parameter reaches only a tenant pool: the reference refuses an
unbound one in an app.)"""
import contextlib
import io

import jax
import numpy as np
import pytest
import torch

import siddhi_tpu as J
import siddhi_tpu_torch as T
from siddhi_tpu.core.types import GLOBAL_STRINGS as JSTR
from siddhi_tpu_torch import carry
from siddhi_tpu_torch.checks import PARTITION_TOP_APP, TS0, trades_feed
from siddhi_tpu_torch.core.types import GLOBAL_STRINGS as TSTR
from test_torch_partition_windows import block_state, row_of
from test_torch_streamfn import ulp
from test_torch_window import align_strings

torch.set_num_threads(1)

PREFIX = "PO"
N_SYMS = 120
N = 420
# uneven sends of 17 to 128 rows (one batch shape, one compile)
CUTS = (0, 20, 60, 120, 180, 230, 300, 420)
# sends of at most 16 rows (one shape)
SMALL_CUTS = (0, 1, 9, 25, 26, 42)
TABLES = {J: JSTR, T: TSTR}
TOP_APP = PARTITION_TOP_APP.replace("@slots('1024')", "@slots('64')")


def feed(encode, n: int = N):
    """trades_feed's prices and volumes; the tickers drawn with weight
    1 / (rank + 1) from all N_SYMS (about 90 distinct in 420 rows, past
    the block's 64 slots whatever their codes: the busiest fill several
    batches of 16, the last ones find no slot); 0-120 ms apart (a
    limiter period ends about every 80 rows)."""
    _ts, (_e, _s, price, vol) = trades_feed(n, encode, N_SYMS, seed=15,
                                            prefix=PREFIX)
    codes = np.array([encode(f"{PREFIX}{i:04d}") for i in range(N_SYMS)],
                     np.int32)
    rng = np.random.default_rng(15)
    w = 1.0 / np.arange(1, N_SYMS + 1)
    sym = codes[rng.choice(N_SYMS, n, p=w / w.sum())]
    ts = TS0 + np.cumsum(rng.integers(0, 121, n)).astype(np.int64)
    return ts, [ts - rng.integers(0, 3, n), sym, price, vol]


@pytest.fixture(scope="module", autouse=True)
def symbols():
    align_strings([f"{PREFIX}{i:04d}" for i in range(N_SYMS)])


def runtime(pkg, text):
    kw = {"device": "cpu"} if pkg is T else {}
    return pkg.SiddhiManager(**kw).create_siddhi_app_runtime(text)


def rate_states(rt) -> dict:
    return {n: b.snapshot_state()["rate"] for n, b in rt.partitions.items()}


def replay(pkg, text, outs, cuts=CUTS, advance=6000):
    """-> [(rows of each output so far, stats, block states, limiter
    states)] after every send and after the clock's last advance."""
    rt = runtime(pkg, text)
    rows = {o: [] for o in outs}
    for o in outs:
        rt.add_callback(o, pkg.StreamCallback(
            lambda evs, o=o: rows[o].extend(row_of(e) for e in evs)))
    rt.start()
    ts, cols = feed(TABLES[pkg].encode, cuts[-1])
    h = rt.get_input_handler("Trades")
    seen = []

    def look():
        seen.append(({o: list(r) for o, r in rows.items()},
                     {n: q.stats() for n, q in rt.queries.items()},
                     block_state(rt), rate_states(rt)))
    for a, b in zip(cuts[:-1], cuts[1:]):
        h.send_arrays(ts[a:b], [c[a:b] for c in cols])
        look()
    with rt.barrier:
        rt.on_ingest_ts(int(ts[-1]) + advance)
    look()
    rt.shutdown()
    return seen


def same_states(bj, bt, step):
    assert bj.keys() == bt.keys()
    for n in bj:
        assert bj[n].keys() == bt[n].keys(), (step, n)
        for k in bj[n]:
            assert (bj[n][k] == bt[n][k]).all(), (step, n, k)


def check(text, outs, **kw):
    sj, st = replay(J, text, outs, **kw), replay(T, text, outs, **kw)
    assert len(sj) == len(st)
    for step, ((rj, qj, bj, lj), (rt_, qt, bt, lt)) in enumerate(zip(sj,
                                                                     st)):
        assert rt_ == rj, step
        assert qt == qj, step
        same_states(bj, bt, step)
        assert lt == lj, step
    return st


def test_partition_top_equals_the_reference_after_every_send():
    st = check(TOP_APP, ("TopTrades", "AvgTop"))
    rows, stats, _b, rates = st[-1]
    assert len(rows["TopTrades"]) > 10 and len(rows["AvgTop"]) >= 2
    assert stats["top3"]["overflow"] > 0
    assert any(st[k][3]["partition_1"] for k in range(len(st)))


BLOCK = """
    @app:playback
    define stream Trades (ets long, symbol string, price float, volume long);
    @slots('64')
    partition with (symbol of Trades) begin
      {queries}
    end;
"""



# one query a case, each in a block of its own
SHAPED = {
    # a STRING key: the reference's block applies no host edge (its rows
    # unordered, no offset or limit)
    "string_key": """from Trades#window.lengthBatch(4)
      select symbol, ets, price order by symbol desc, price limit 2""",
    # offset and limit alone, on the row order
    "offset_limit": """from Trades[price > 20.0] select symbol, price, volume
      limit 3 offset 1""",
    # an event-count limiter
    "limiter": """from Trades select symbol, price order by price desc
      limit 2 output last every 3 events""",
}


@pytest.mark.parametrize("case", sorted(SHAPED))
def test_shaped_block_queries_equal_the_reference(case):
    st = check(BLOCK.format(queries=f"@info(name = 'q') {SHAPED[case]} "
                            "insert all events into Out;"), ("Out",),
               cuts=SMALL_CUTS)
    assert st[-1][0]["Out"]


def test_a_string_key_leaves_a_blocks_rows_unordered():
    """As the reference's block does: the rows of ``order by symbol desc,
    price limit 2`` are those of the query without its order-by and
    limit."""
    q = """@info(name = 'q')
      from Trades#window.lengthBatch(4)
      select symbol, ets, price {shape} insert into Out;"""
    got = replay(T, BLOCK.format(queries=q.format(
        shape="order by symbol desc, price limit 2")), ("Out",),
        cuts=SMALL_CUTS)[-1][0]
    plain = replay(T, BLOCK.format(queries=q.format(shape="")), ("Out",),
                   cuts=SMALL_CUTS)[-1][0]
    assert got == plain and len(got["Out"]) > 2


POLAR_BLOCK = """
    @app:playback
    define stream Trades (ets long, symbol string, price float, volume long);
    @slots('64')
    partition with (symbol of Trades) begin
      @info(name = 'q')
      from Trades#log('trade')#pol2Cart(price, volume)
      select symbol, price, cartX, cartY order by price desc limit 1
      insert into Out;
    end;
"""


def logged(pkg, text, cuts):
    """-> (rows, each send's printed lines) of ``text`` over ``cuts``."""
    rt = runtime(pkg, text)
    rows = []
    rt.add_callback("Out", pkg.StreamCallback(
        lambda evs: rows.extend(row_of(e) for e in evs)))
    rt.start()
    ts, cols = feed(TABLES[pkg].encode, cuts[-1])
    h = rt.get_input_handler("Trades")
    lines = []
    for a, b in zip(cuts[:-1], cuts[1:]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            h.send_arrays(ts[a:b], [c[a:b] for c in cols])
            jax.effects_barrier()
        lines.append(buf.getvalue().splitlines())
    rt.shutdown()
    return rows, lines


def test_pol2cart_and_log_in_a_block_equal_the_reference():
    """The reference's ``jax.debug.callback`` under vmap prints a slot's
    rows together, the slots in an order that varies from run to run
    (its callbacks are unordered); the port prints slot by slot in slot
    order: each send's lines are the reference's as a multiset (ROADMAP
    Queue 3, kept)."""
    cuts = SMALL_CUTS
    (rj, lj), (rt_, lt) = logged(J, POLAR_BLOCK, cuts), \
        logged(T, POLAR_BLOCK, cuts)
    # pol2Cart's cos and sin are XLA's, within 2 ulp (ROADMAP Queue 3)
    assert len(rt_) == len(rj) and rj
    for (tt, et, dt), (tj, ej, dj) in zip(rt_, rj):
        assert (tt, et, dt[:2]) == (tj, ej, dj[:2])
        assert all(ulp(float.fromhex(a), float.fromhex(b)) <= 2
                   for a, b in zip(dt[2:], dj[2:]))
    assert [sorted(x) for x in lt] == [sorted(x) for x in lj]
    assert all(lt)
    assert lt == logged(T, POLAR_BLOCK, cuts)[1]


def test_a_rate_limited_block_carried_from_the_reference_goes_on():
    """The reference's block state at the first send boundary where its
    event-count limiter holds a kept row (which one
    depends on the dictionary codes, so on what the process interned
    before), carried into a fresh port runtime through
    carry.block_from_jax: the port then goes on to the rows, block state
    and limiter state of the reference's own run."""
    text = BLOCK.format(
        queries=f"@info(name = 'q') {SHAPED['limiter']} insert into Out;")
    runs, snap, cut, mark = {}, None, None, None
    for pkg in (J, T):
        rt = runtime(pkg, text)
        rows = []
        rt.add_callback("Out", pkg.StreamCallback(
            lambda evs, rows=rows: rows.extend(row_of(e) for e in evs)))
        rt.start()
        (blk,) = rt.partitions.values()
        if pkg is T:
            assert snap is not None, "the limiter never held a row"
            blk.restore_state(carry.block_from_jax(
                jax.tree_util.tree_map(np.asarray, snap), "cpu"))
        ts, cols = feed(TABLES[pkg].encode)
        h = rt.get_input_handler("Trades")
        for n in range(cut or 0, len(CUTS) - 1):
            if pkg is J and snap is None and n >= 1:
                st = blk.snapshot_state()
                if st["rate"]["q"]["last"]:
                    snap, cut, mark = st, n, len(rows)
            a, b = CUTS[n], CUTS[n + 1]
            h.send_arrays(ts[a:b], [c[a:b] for c in cols])
        runs[pkg] = (rows, block_state(rt), blk.snapshot_state()["rate"])
        rt.shutdown()
    (rj, bj, lj), (rt_, bt, lt) = runs[J], runs[T]
    assert rt_ == rj[mark:] and rt_
    same_states(bj, bt, "carried")
    assert lt == lj
