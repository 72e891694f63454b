"""The disorder-equivalence sweep of tests/test_ordering.py, continued
(see test_torch_ordering.py): the partition app and the join, through
both packages, rows and reorder counters equal, disordered runs equal to
ordered ones."""
import numpy as np
import pytest
import torch

import siddhi_tpu as J
import siddhi_tpu_torch as T
from test_ordering import JOIN_APP, PARTITION_APP, _mk_chunks, \
    _shuffle_within
from test_torch_ordering import RING_ENV, Run, counters, run_single

torch.set_num_threads(1)


def test_disorder_equivalence_partition(monkeypatch):
    monkeypatch.delenv(RING_ENV, raising=False)
    ql = PARTITION_APP
    ordered, co = run_single(T, ql, seed=11, disorder=False)
    shuffled, cs = run_single(T, ql, seed=11, disorder=True)
    assert len(ordered) > 0 and shuffled == ordered
    assert (ordered, co) == run_single(J, ql, seed=11, disorder=False)
    assert (shuffled, cs) == run_single(J, ql, seed=11, disorder=True)


def _join_run(pkg, disorder):
    r = Run(pkg, JOIN_APP)
    rng = np.random.default_rng(5)
    lchunks = _mk_chunks(21, 256, 64, lo=0, hi=8)
    rchunks = _mk_chunks(22, 256, 64, lo=0, hi=8)
    for (lts, lcols), (rts, rcols) in zip(lchunks, rchunks):
        rts = rts + 2
        if disorder:
            lts, lcols = _shuffle_within(lts, lcols, rng, 48)
            rts, rcols = _shuffle_within(rts, rcols, rng, 48)
        r.cols("L", lts, lcols)
        r.cols("R", rts, rcols)
    c = (counters(r.rt, "L"), counters(r.rt, "R"))
    r.close()
    return r.got["Out"], c


def test_disorder_equivalence_join(monkeypatch):
    monkeypatch.delenv(RING_ENV, raising=False)
    ordered = _join_run(T, False)
    shuffled = _join_run(T, True)
    assert len(ordered[0]) > 0 and shuffled[0] == ordered[0]
    assert ordered == _join_run(J, False)
    assert shuffled == _join_run(J, True)


