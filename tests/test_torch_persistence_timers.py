"""A restored runtime re-arms its timers (siddhi_tpu_torch/core/
runtime.py SiddhiAppRuntime._rearm and the query runtimes'
``reschedule``), on the CPU: a time window's expiry, an absent
pattern's deadline, a cron window's firings and a periodic trigger's
phase. The port's continuation after a restore equals an uninterrupted
port run, and the reference's continuation where the reference re-arms
them too; where it does not (a trigger's phase) the test shows the
reference's behaviour, which the port does not copy (ROADMAP Queue 3)."""
import torch

import siddhi_tpu as J
import siddhi_tpu_torch as T
from test_torch_persistence import (PLAYBACK, assert_resumed, build, feed,
                                    kill_and_resume, manager, rows)

torch.set_num_threads(1)


class TestTimersRearmed:
    """A restored runtime re-arms its timers: the port's continuation
    equals an uninterrupted port run (and the reference's, where the
    reference re-arms them too)."""

    def test_time_window_expiry(self):
        app = PLAYBACK + """
            @app:name('tw')
            define stream S (v int);
            @info(name = 'q')
            from S#window.time(100) select v, sum(v) as t
            insert all events into Out;
        """
        sends = [("S", 1000 + 30 * i, (i,)) for i in range(10)]
        res = kill_and_resume(app, sends[:5], sends[5:])
        assert_resumed(res)
        # the expired rows (made current by the insert) come after it
        assert len(res[T][0]) > 5

    def test_absent_pattern_deadline(self):
        app = PLAYBACK + """
            @app:name('ab')
            define stream A (v int);
            define stream B (v int);
            @info(name = 'q')
            from e1=A[v > 0] -> not B[v == e1.v] for 100 milliseconds
            select e1.v as v
            insert into Out;
        """
        before = [("A", 1000, (1,)), ("A", 1010, (2,))]
        after = [("B", 1050, (2,)), ("A", 1300, (3,)), ("A", 1500, (4,))]
        res = kill_and_resume(app, before, after)
        assert_resumed(res)
        assert [r[1] for r in res[T][0]][:1] == [(1,)]

    CRON_APP = PLAYBACK + """
        @app:name('cr')
        define stream S (v int);
        define trigger Tick at every 700 milliseconds;
        @info(name = 'q')
        from S#window.cron('*/1 * * * * ?') select v, count() as n
        insert into Out;
        @info(name = 't')
        from Tick select triggered_time as at insert into Ticks;
    """
    CRON_SENDS = [("S", 10_000 + 450 * i, (i,)) for i in range(12)]

    @classmethod
    def cron_runs(cls, pkg, cut=6):
        """-> (continuation, uninterrupted rows after the cut), each the
        Out rows and the Ticks rows, the continuation restored from a
        snapshot taken after ``cut`` sends."""
        runs = []
        for restart in (False, True):
            rt, got = build(pkg, cls.CRON_APP, manager(pkg))
            ticks = []
            rt.add_callback("Ticks", pkg.StreamCallback(fn=ticks.extend))
            feed(pkg, rt, cls.CRON_SENDS[:cut])
            n, m = len(got), len(ticks)
            if restart:
                snap = rt.snapshot()
                rt.shutdown()
                rt, got = build(pkg, cls.CRON_APP, manager(pkg))
                ticks = []
                rt.add_callback("Ticks", pkg.StreamCallback(fn=ticks.extend))
                rt.restore(snap)
                n = m = 0
            feed(pkg, rt, cls.CRON_SENDS[cut:])
            rt.shutdown()
            runs.append((rows(got[n:]), rows(ticks[m:])))
        return runs[1], runs[0]

    def test_cron_window_and_trigger(self):
        cont, tail = self.cron_runs(T)
        assert cont[0] and cont[1]
        assert cont == tail

    def test_the_reference_loses_the_phase_after_a_restore(self):
        """Not kept: the reference's restore arms its cron windows and
        triggers again at the first event after it (its
        ``_arm_cron_once``), so a periodic trigger restarts its period
        there; the port re-arms each trigger at its snapshotted fire."""
        cont, tail = self.cron_runs(J)
        assert cont[1] != tail[1]
