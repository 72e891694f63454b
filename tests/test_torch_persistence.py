"""Checkpoint and restore of a whole app (siddhi_tpu_torch/core/
persistence.py, SiddhiAppRuntime.snapshot/restore/persist and the
revision methods) against the reference, on the CPU.

The reference's tests/test_persistence.py cases, each run in both
packages: run, persist, build a fresh runtime of the same app from the
same manager, restore, continue. The port's continuation equals the
reference's continuation and the tail of an uninterrupted port run,
row for row (floats by their bits). Then what the port adds: a
snapshot is a copy that later sends do not change (the regression of a
query snapshot that aliased the live emitted counter on the CPU), the
restricted unpickler refuses a payload that holds a torch tensor, and a
reference payload is refused with a pointer to the carry converter.
test_torch_persistence_timers.py holds the re-armed timers."""
import pickle
import struct

import pytest
import torch

import siddhi_tpu as J
import siddhi_tpu_torch as T
from siddhi_tpu_torch.core import persistence as TP

torch.set_num_threads(1)

PLAYBACK = "@app:playback "
PFX = "ps_"

WINDOW_APP = PLAYBACK + """
    @app:name('papp')
    define stream S (symbol string, v int);
    @info(name = 'q')
    from S#window.length(3) select symbol, sum(v) as total
    insert into Out;
"""

SENDS = [("S", 1000 + i, (PFX + sym, i + 1)) for i, sym in enumerate(
    ["A", "B", "A", "C", "B", "A", "C", "A"])]


def norm(v):
    if isinstance(v, float):
        return ("f", struct.pack("<d", v))
    return v


def rows(events):
    return [(e.timestamp, tuple(norm(x) for x in e.data), e.is_expired)
            for e in events]


def manager(pkg, store=None):
    mgr = pkg.SiddhiManager(device="cpu") if pkg is T else pkg.SiddhiManager()
    if store is not None:
        mgr.set_persistence_store(store)
    return mgr


def build(pkg, ql, mgr, out="Out"):
    rt = mgr.create_siddhi_app_runtime(ql)
    got = []
    rt.add_callback(out, pkg.StreamCallback(fn=lambda evs: got.extend(evs)))
    rt.start()
    return rt, got


def feed(pkg, rt, sends):
    for sid, ts, data in sends:
        rt.get_input_handler(sid).send(pkg.Event(ts, tuple(data)))


def kill_and_resume(ql, before, after, out="Out", store_of=None,
                    pkgs=(J, T)):
    """-> {package: (continuation rows, uninterrupted rows after the
    cut)} with the continuation restored from the last revision."""
    res = {}
    for pkg in pkgs:
        rt, got = build(pkg, ql, manager(pkg), out)
        feed(pkg, rt, before)
        cut = len(got)
        feed(pkg, rt, after)
        rt.shutdown()
        mgr = manager(pkg, store_of(pkg) if store_of
                      else pkg.InMemoryPersistenceStore())
        rt1, _ = build(pkg, ql, mgr, out)
        feed(pkg, rt1, before)
        rev = rt1.persist()
        rt1.shutdown()
        rt2, got2 = build(pkg, ql, mgr, out)
        assert rt2.restore_last_revision() == rev
        feed(pkg, rt2, after)
        rt2.shutdown()
        res[pkg] = (rows(got2), rows(got[cut:]))
    return res


def assert_resumed(res):
    t_cont, t_tail = res[T]
    j_cont, j_tail = res[J]
    assert t_cont == t_tail
    assert t_cont == j_cont
    assert j_cont == j_tail


class TestPersistRestore:
    def test_window_kill_and_resume_bit_equal(self):
        res = kill_and_resume(WINDOW_APP, SENDS[:4], SENDS[4:])
        assert_resumed(res)
        assert len(res[T][0]) == 4

    def test_pattern_state_survives_restore(self):
        app = PLAYBACK + """
            @app:name('pat')
            define stream A (sym string, v int);
            define stream B (sym string, v int);
            @info(name = 'q')
            from e1=A[v > 10] -> e2=B[v > e1.v]
            select e1.v as v1, e2.v as v2
            insert into Out;
        """
        res = kill_and_resume(app, [("A", 1000, (PFX + "x", 20))],
                              [("B", 1100, (PFX + "y", 25))])
        assert_resumed(res)
        assert [r[1] for r in res[T][0]] == [(20, 25)]

    def test_table_contents_survive_restore(self):
        app = PLAYBACK + """
            @app:name('tbl')
            define stream S (symbol string, v int);
            define stream Q (symbol string);
            define table T (symbol string, v int);
            @info(name = 'ins')
            from S select symbol, v insert into T;
            @info(name = 'rd')
            from Q[T.symbol == symbol in T] select symbol insert into Out;
        """
        res = kill_and_resume(app, [("S", 1000, (PFX + "IBM", 5))],
                              [("Q", 1100, (PFX + "IBM",)),
                               ("Q", 1200, (PFX + "WSO2",))])
        assert_resumed(res)
        assert [r[1] for r in res[T][0]] == [(PFX + "IBM",)]

    def test_partition_state_survives_restore(self):
        app = PLAYBACK + """
            @app:name('part')
            define stream S (symbol string, v int);
            partition with (symbol of S)
            begin
              @info(name = 'pq')
              from S select symbol, sum(v) as total insert into Out;
            end;
        """
        res = kill_and_resume(
            app, [("S", 1000, (PFX + "A", 1)), ("S", 1001, (PFX + "B", 10))],
            [("S", 1100, (PFX + "A", 2)), ("S", 1101, (PFX + "B", 20))])
        assert_resumed(res)
        assert [r[1] for r in res[T][0]] == [(PFX + "A", 3), (PFX + "B", 30)]

    def test_filesystem_store_roundtrip(self, tmp_path):
        def store_of(pkg):
            return pkg.FileSystemPersistenceStore(
                str(tmp_path / ("t" if pkg is T else "j")))
        res = kill_and_resume(WINDOW_APP, SENDS[:4], SENDS[4:],
                              store_of=store_of)
        assert_resumed(res)
        for d in ("t", "j"):
            files = [f.name for f in (tmp_path / d / "papp").iterdir()]
            assert len(files) == 1 and files[0].endswith(".snapshot")

    def test_restore_revision_by_id_and_clear(self):
        got = {}
        for pkg in (J, T):
            store = pkg.InMemoryPersistenceStore()
            mgr = manager(pkg, store)
            rt1, _ = build(pkg, WINDOW_APP, mgr)
            feed(pkg, rt1, SENDS[:2])
            rev1 = rt1.persist()
            feed(pkg, rt1, SENDS[2:4])
            rev2 = rt1.persist()
            assert rev1 < rev2
            rt1.shutdown()
            rt2, got2 = build(pkg, WINDOW_APP, mgr)
            rt2.restore_revision(rev1)   # the older revision
            feed(pkg, rt2, SENDS[2:4])
            rt2.shutdown()
            got[pkg] = rows(got2)
            rt2.clear_all_revisions()
            assert store.get_last_revision("papp") is None
        assert got[T] == got[J] and len(got[T]) == 2

    def test_missing_revision_raises(self):
        for pkg in (J, T):
            rt, _ = build(pkg, WINDOW_APP,
                          manager(pkg, pkg.InMemoryPersistenceStore()))
            with pytest.raises(KeyError):
                rt.restore_revision("nope")
            assert rt.restore_last_revision() is None
            rt.shutdown()


def test_partition_absent_deadlines():
    """A partition block's absent pattern across a restore: key pt_a's
    deadline falls after the snapshot, and only another key's rows
    follow it, so the alert comes from the block's timer step; the rows
    after the restore are the uninterrupted run's (the port alone: the
    reference's partitioned scan engine compiles for 15 s on one core).
    (The restored block also re-arms its slots' deadlines from the
    restored tables, which a wall-clock app with no later event needs;
    under playback the next step arms them too.)"""
    app = PLAYBACK + """
        @app:name('pab')
        define stream A (k string, v int);
        define stream B (k string, v int);
        partition with (k of A, k of B) begin
          @info(name = 'q')
          from e1=A -> not B[v == e1.v] for 100 milliseconds
          select e1.k as k, e1.v as v
          insert into Out;
        end;
    """
    before = [("A", 1000, ("pt_a", 1)), ("A", 1010, ("pt_b", 2)),
              ("B", 1020, ("pt_b", 2))]
    after = [("B", 1300, ("pt_z", 9)), ("B", 1500, ("pt_z", 8))]
    cont, tail = kill_and_resume(app, before, after, pkgs=(T,))[T]
    assert cont == tail == [(1100, ("pt_a", 1), False)]


def bare_runtime(pkg, text):
    """A runtime without a manager (its stores are its own)."""
    if pkg is T:
        from siddhi_tpu_torch.core.runtime import SiddhiAppRuntime
        return SiddhiAppRuntime(T.parse(text), device="cpu")
    from siddhi_tpu.core.runtime import SiddhiAppRuntime
    return SiddhiAppRuntime(J.parse(text))


class TestManagerlessRuntime:
    def test_persist_restore_without_manager(self):
        for pkg in (J, T):
            rt = bare_runtime(pkg, """
                @app:playback
                define stream S (v int);
                @info(name = 'q')
                from S select sum(v) as t insert into Out;
            """)
            rt.start()
            rt.get_input_handler("S").send([(5,)])
            rev = rt.persist()
            rt.get_input_handler("S").send([(7,)])
            rt.restore_revision(rev)
            got = []
            rt.add_callback("Out", pkg.StreamCallback(
                fn=lambda e: got.extend(e)))
            rt.get_input_handler("S").send([(1,)])
            rt.shutdown()
            assert [e.data for e in got] == [(6,)]
            assert rt.restore_last_revision() == rev


class TestStateHolders:
    def test_named_window_contents_survive_restore(self):
        out = {}
        for pkg in (J, T):
            rt = bare_runtime(pkg, f"""
                @app:playback
                define stream S (sym string, v int);
                define window W (sym string, v int) length(3);
                @info(name = 'f') from S select sym, v insert into W;
            """)
            rt.start()
            h = rt.get_input_handler("S")
            for i, v in enumerate([1, 2, 3]):
                h.send(pkg.Event(1000 + i, (PFX + "a", v)))
            rev = rt.persist()
            h.send(pkg.Event(2000, (PFX + "a", 9)))  # evicts v=1 after it
            rt.restore_revision(rev)
            out[pkg] = sorted(rt.query("from W select v"))
            rt.shutdown()
        assert out[T] == out[J] == [(1,), (2,), (3,)]

    def test_aggregation_buckets_survive_restore(self):
        out = {}
        for pkg in (J, T):
            rt = bare_runtime(pkg, """
                @app:playback
                define stream T (sym string, p double, ts long);
                define aggregation Agg from T
                select sym, sum(p) as tp group by sym
                aggregate by ts every seconds;
            """)
            rt.start()
            h = rt.get_input_handler("T")
            h.send(pkg.Event(100, (PFX + "a", 2.0, 1000)))
            h.send(pkg.Event(101, (PFX + "a", 3.0, 1500)))
            rev = rt.persist()
            h.send(pkg.Event(102, (PFX + "a", 10.0, 1600)))   # after it
            rt.restore_revision(rev)
            out[pkg] = rt.query("from Agg within 0L, 10000L per 'seconds' "
                                "select sym, tp")
            rt.shutdown()
        assert out[T] == out[J] == [(PFX + "a", 5.0)]

    def test_rate_limiter_counters_survive_restore(self):
        out = {}
        for pkg in (J, T):
            rt = bare_runtime(pkg, """
                @app:playback
                define stream S (v int);
                @info(name = 'q') from S select v
                output last every 3 events
                insert into Out;
            """)
            got = []
            rt.add_callback("Out", pkg.StreamCallback(
                fn=lambda e: got.extend(e)))
            rt.start()
            h = rt.get_input_handler("S")
            h.send(pkg.Event(1000, (1,)))
            h.send(pkg.Event(1001, (2,)))
            rev = rt.persist()     # the counter at 2 of 3
            h.send(pkg.Event(1002, (3,)))   # emits, the counter resets
            assert [e.data[0] for e in got] == [3]
            got.clear()
            rt.restore_revision(rev)    # back to 2 of 3
            h.send(pkg.Event(1003, (4,)))   # the 3rd again: emits
            rt.shutdown()
            out[pkg] = [e.data[0] for e in got]
        assert out[T] == out[J] == [4]


class TestSnapshotIsACopy:
    def test_query_snapshot_does_not_follow_later_sends(self):
        """The regression: ``snapshot_state()["emitted"]`` was the live
        counter on the CPU (``.cpu()`` of a CPU tensor is the tensor)."""
        rt, _ = build(T, PLAYBACK + """
            define stream S (v int);
            @info(name = 'q') from S[v > 0] select v insert into Out;
        """, manager(T))
        h = rt.get_input_handler("S")
        for i in range(5):
            h.send(T.Event(1000 + i, (1,)))
        q = rt.queries["q"]
        snap = q.snapshot_state()
        before = TP.to_host(snap)
        for i in range(5):
            h.send(T.Event(2000 + i, (1,)))
        assert int(snap["emitted"]) == 5
        assert q.stats()["emitted"] == 10
        # a restored state is fresh: the snapshot stays as it was after
        # it is restored twice and the runtime goes on
        q.restore_state(snap)
        q.restore_state(snap)
        for i in range(3):
            h.send(T.Event(3000 + i, (1,)))
        rt.shutdown()
        assert q.stats()["emitted"] == 8
        assert int(snap["emitted"]) == 5
        assert pickle.dumps(TP.to_host(snap)) == pickle.dumps(before)

    def test_every_runtime_kind_snapshots_copies(self):
        rt, _ = build(T, PLAYBACK + """
            define stream S (sym string, v int);
            define stream R (sym string, v int);
            @info(name = 'w') from S#window.length(4) select sym, sum(v) as t
            insert into Out;
            @info(name = 'p') from e1=S -> e2=R[v > e1.v] select e1.v as a
            insert into P;
            @info(name = 'j') from S#window.length(4) as a
            join R#window.length(4) as b on a.sym == b.sym
            select a.v as x, b.v as y insert into J;
        """, manager(T))
        sends = [("S", 1000, (PFX + "j", 1)), ("R", 1001, (PFX + "j", 5)),
                 ("S", 1002, (PFX + "k", 2))]
        feed(T, rt, sends)
        payload = rt._snapshot_locked()
        host = pickle.dumps(TP.to_host(payload))
        feed(T, rt, [(s, ts + 100, d) for s, ts, d in sends])
        rt.shutdown()
        assert pickle.dumps(TP.to_host(payload)) == host


class TestPayloads:
    def test_unpickler_refuses_a_torch_tensor(self):
        data = pickle.dumps({"format": TP.SNAPSHOT_FORMAT, "port": "torch",
                             "x": torch.zeros(3)})
        with pytest.raises(pickle.UnpicklingError, match="non-data"):
            TP.deserialize(data)

    def test_serialize_writes_numpy_only(self):
        data = TP.serialize({"x": torch.arange(4), "y": (torch.ones(2,
                                                        dtype=torch.bool),)})
        payload = TP.deserialize(data)
        assert payload["port"] == "torch"
        assert payload["x"].tolist() == [0, 1, 2, 3]
        assert payload["y"][0].dtype.kind == "b"

    def test_a_reference_snapshot_is_refused(self):
        rt = build(J, WINDOW_APP, manager(J))[0]
        feed(J, rt, SENDS[:3])
        data = rt.snapshot()
        rt.shutdown()
        trt = build(T, WINDOW_APP, manager(T))[0]
        with pytest.raises(ValueError, match="carry.snapshot_from_jax"):
            trt.restore(data)
        trt.shutdown()
