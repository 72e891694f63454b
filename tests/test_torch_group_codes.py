"""The group table's probe bound, on the CPU. K6's group table has 1,024
slots and places a key within 16 probes of its hash, a hash of the key's
dictionary code. For some ranges of codes 512 keys do not all fit: the
rows of the keys left out are counted as overflow. That bound is the
reference's own. At such a code range:

- the port counts the same overflowed rows as the reference, with the
  same rows and the same whole state after every send (bit for bit);
- the port's plain version gives the same rows and state with one torch
  thread and with four, so the count depends on the codes only, not on
  the thread pool.

The bars query of checks.WINDOW_BARS_APP (externalTimeBatch, grouped by
512 symbols) on the trades feed. Helpers: test_torch_window.py."""
import pytest
import torch

import siddhi_tpu as J
import siddhi_tpu_torch as T
from siddhi_tpu.core.types import GLOBAL_STRINGS as JSTR
from siddhi_tpu_torch.checks import TRADES_STREAM, time_symbols, trades_feed
from siddhi_tpu_torch.core.types import GLOBAL_STRINGS as TSTR
from siddhi_tpu_torch.ops.keyed import hash_columns, lookup_or_insert
from test_torch_window import Run, align_strings, run_both

torch.set_num_threads(1)

SYMS = 512
PREFIX = "G"
BARS_APP = TRADES_STREAM + """
    @info(name = 'q')
    from Trades#window.externalTimeBatch(ets, 1 sec)
    select symbol, max(price) as hi, min(price) as lo, sum(volume) as vol,
           count() as n
    group by symbol
    insert into Bars;
"""
SENDS = [(0, 2000), (2000, 4000), (4000, 6000)]


def left_out(base: int) -> int:
    """Keys of codes base .. base + 511 that one insert into an empty
    1,024-slot table leaves out (the port's own hash and probe)."""
    codes = torch.arange(base, base + SYMS, dtype=torch.int32)
    h = hash_columns([codes], [torch.zeros(SYMS, dtype=torch.bool)])
    _s, _k, _u, ovf = lookup_or_insert(
        torch.zeros(1024, dtype=torch.int64),
        torch.zeros(1024, dtype=torch.bool), h,
        torch.ones(SYMS, dtype=torch.bool))
    return int(ovf)


@pytest.fixture(scope="module", autouse=True)
def bad_codes():
    """Pad both string tables to the first code range, from the tables'
    next code, at which 512 keys do not fit, then intern the module's
    symbols there in both. -> their first code."""
    align_strings([])
    base = len(TSTR)
    while left_out(base) < 2:
        base += 1
    for table, tag in ((JSTR, "j"), (TSTR, "t")):
        while len(table) < base:
            table.encode(f"__pad_{tag}{len(table)}")
    syms = time_symbols(SYMS, PREFIX)
    align_strings(syms)
    assert [TSTR.encode(s) for s in syms] == list(range(base, base + SYMS))
    return base


def feed(encode):
    return trades_feed(6000, encode, n_syms=SYMS, seed=4, prefix=PREFIX)


def test_group_table_overflow_equals_the_reference(bad_codes):
    """Rows, statistics and states after every send equal the
    reference's, with overflowed rows counted alike."""
    _rj, rt = run_both(BARS_APP, SENDS, feed, out="Bars", stream="Trades")
    assert rt.q.stats()["overflow"] > 0


def test_group_table_overflow_does_not_depend_on_threads(bad_codes):
    """The port's plain version, once with one torch thread and once with
    four: equal rows and whole states after every send."""
    saved = torch.get_num_threads()
    runs = {}
    try:
        for n in (1, 4):
            torch.set_num_threads(n)
            runs[n] = Run(T, BARS_APP, out="Bars", stream="Trades")
        ts, cols = feed(TSTR.encode)
        for a, b in SENDS:
            states = {}
            for n, r in runs.items():
                torch.set_num_threads(n)
                r.h.send_arrays(ts[a:b], [c[a:b] for c in cols])
                states[n] = r.state()
            assert runs[1].rows == runs[4].rows, f"rows after send {a}:{b}"
            assert states[1].keys() == states[4].keys()
            for k in states[1]:
                assert (states[1][k] == states[4][k]).all(), \
                    f"state {k} after send {a}:{b}"
            assert runs[1].q.stats() == runs[4].q.stats()
    finally:
        torch.set_num_threads(saved)
    assert runs[1].q.stats()["overflow"] > 0
