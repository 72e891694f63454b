"""checks.PARTITION_APPS (the partition blocks chip_smoke.py holds the
slotted kernels against) through the reference and the port, on the
CPU: the same feed (checks.partition_feed at 400 events, in uneven
sends, the clock then driven a second past the last event so that the
blocks' timers fire) gives equal rows (in order, floats by their bits),
equal ``stats()`` and equal block states (the slot table, every query's
[K]-stacked state, emitted and lost), tolerance 0. The first half of
HALVES runs here, the second in test_torch_partition_apps2.py. Feed
strings carry the module's prefix and are interned in both tables in
one order first."""
import pytest
import torch

import siddhi_tpu as J
import siddhi_tpu_torch as T
from siddhi_tpu.core.types import GLOBAL_STRINGS as JSTR
from siddhi_tpu_torch import checks as C
from siddhi_tpu_torch.core.types import GLOBAL_STRINGS as TSTR
from test_torch_window import align_strings, leaves

torch.set_num_threads(1)

CUTS = (0, 1, 9, 60, 61, 180, 230, 300, 400)
TABLES = {J: JSTR, T: TSTR}


def replay(pkg, text, prefix):
    kw = {"device": "cpu"} if pkg is T else {}
    rt = pkg.SiddhiManager(**kw).create_siddhi_app_runtime(text)
    rows = []
    rt.add_callback("Out", pkg.StreamCallback(
        lambda evs: rows.extend(
            (e.timestamp, e.is_expired,
             tuple(x.hex() if isinstance(x, float) else x for x in e.data))
            for e in evs)))
    rt.start()
    ts, cols, _cuts = C.partition_feed(CUTS[-1], TABLES[pkg].encode,
                                       prefix=prefix)
    h = rt.get_input_handler("S")
    for a, b in zip(CUTS[:-1], CUTS[1:]):
        h.send_arrays(ts[a:b], [c[a:b] for c in cols])
    with rt.barrier:
        rt.on_ingest_ts(int(ts[-1]) + 1000)
    rt.shutdown()
    blocks = {n: dict(leaves({k: v for k, v in b.snapshot_state().items()
                              if k != "rate"}))
              for n, b in rt.partitions.items()}
    return rows, {n: q.stats() for n, q in rt.queries.items()}, blocks


def check_app(name, prefix):
    text = C.PARTITION_APPS[name]
    rj, sj, bj = replay(J, text, prefix)
    rt, st, bt = replay(T, text, prefix)
    assert rt == rj
    assert st == sj
    assert bj.keys() == bt.keys()
    for n in bj:
        assert bj[n].keys() == bt[n].keys()
        for k in bj[n]:
            assert (bj[n][k] == bt[n][k]).all(), f"{n}{k}"
    return rt, st


def aligned(prefix):
    align_strings([f"{prefix}{i:02d}" for i in range(6)])


# the eight apps in two halves of about equal time on one core
HALVES = (["timeBatch, timers", "key overflow, two queries",
           "inner stream, group by", "pattern, within"],
          ["absent, timer step", "range key, time window",
           "lengthBatch, all events", "value key, length window"])
NAMES = HALVES[0]


@pytest.fixture(scope="module", autouse=True)
def symbols():
    aligned("pq")


@pytest.mark.parametrize("name", NAMES)
def test_partition_app_equals_the_reference(name):
    rows, stats = check_app(name, "pq")
    assert rows and stats["q"]["emitted"] > 0
    assert ("overflow" in name) == (stats["q"]["overflow"] > 0)
