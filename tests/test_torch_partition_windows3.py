"""The session window (kernel F[K]) inside a partition block against the
reference's partition runtime, on the CPU (rows, stats and whole block
states after every send and after the clock's advance, which fires the
sessions' gaps; tolerance 0), and the slotted plain versions of kernels
B, E and F, each against ``per_slot`` of its one-slot plain version on
every captured slotted step of the block apps, bit for bit: the sort
and frequent windows' plain versions walk every slot at once
(``sort_window_slots_ref``, ``freq_window_slots_ref``) and session's
runs its stages along the row axis (``session_slots_ref``), which
chip_smoke.py holds B[K], E[K] and F[K] against at 1,024 slots. The slot
layout the host hands kernels A[K], B[K], E[K] and F[K] (their argument
structs built as for the card from each captured step, part_args
replayed for every slot) reaches every slot's state, output and
scratch."""
import numpy as np
import pytest
import torch

import siddhi_tpu_torch as T
from siddhi_tpu_torch.ops import windows as W
from siddhi_tpu_torch.ops import windows2 as W2
from siddhi_tpu_torch.ops import slots
from siddhi_tpu_torch.ops.slots import per_slot
from test_torch_partition_layout import check_moves
from test_torch_partition_windows import APPS, check_app, names, replay
from test_torch_window import align_strings

torch.set_num_threads(1)

PREFIX = "wc"


@pytest.fixture(scope="module", autouse=True)
def symbols():
    align_strings(names(PREFIX))


def test_session_in_a_block_equals_the_reference():
    check_app(APPS["session"], PREFIX)


_STEPS: dict = {}


def slotted_steps():
    """The slotted window steps of one port run of each block app:
    {kind: [(op, state, batch, now)]}."""
    if not _STEPS:
        taps = [(W2, "sort_window_step"), (W2, "freq_window_step"),
                (W2, "session_step"), (W, "window_step")]
        saved = [getattr(m, t) for m, t in taps]

        def tap(fn):
            def f(op, state, batch, now):
                if batch.ts.dim() == 2:
                    _STEPS.setdefault(op.kind_name, []).append(
                        (op, state, batch, now))
                return fn(op, state, batch, now)
            return f
        for (m, t), fn in zip(taps, saved):
            setattr(m, t, tap(fn))
        try:
            for text in APPS.values():
                replay(T, text, PREFIX)
        finally:
            for (m, t), fn in zip(taps, saved):
                setattr(m, t, fn)
    return _STEPS


def bits(x):
    a = x.numpy()
    return a.view(np.int64 if a.itemsize == 8 else np.int32) \
        if a.dtype.kind == "f" else a


def same(got, want):
    """Two (state, output batch) results, every tensor bit for bit."""
    for i, (x, y) in enumerate(zip(slots.leaves(got), slots.leaves(want),
                                   strict=True)):
        assert x.dtype == y.dtype and x.shape == y.shape, i
        assert np.array_equal(bits(x), bits(y)), i


@pytest.mark.parametrize("kind,plain", [
    ("sort", W2.sort_window_slots_ref),
    ("frequent", W2.freq_window_slots_ref),
    ("lossyFrequent", W2.freq_window_slots_ref),
    ("session", W2.session_step_ref)])
def test_slotted_plain_version_is_each_slot_alone(kind, plain):
    steps = slotted_steps()[kind]
    assert len(steps) >= 7
    walked = 0
    for op, state, batch, now in steps:
        got = plain(op, state, batch, now)
        want = per_slot(lambda st, b: op.step_ref(st, b, now),
                        batch.ts.shape[0], state, batch)
        same(got, want)
        walked += int((batch.valid & (batch.kind == 0)).any(1).sum())
    assert walked > 0


@pytest.mark.parametrize("kind", sorted(APPS))
def test_slot_moves_reach_every_slot(kind):
    """Each kind's captured slotted steps, their argument structs built as
    for the card (K5's for A[K], SortArgs, FreqArgs, SessArgs), with
    part_args replayed for every slot: each word that points at a
    slotted state, output or scratch tensor lands on that tensor's slot
    k; the block's shared input columns stay."""
    n = 0
    for op, state, batch, now in slotted_steps()[kind][:4]:
        nowt = torch.as_tensor(now, dtype=torch.int64)
        if kind == "session":
            new, out, a = W2.session_args(op, state, batch)
        elif kind == "sort":
            new, out, a = W2.sort_args(op, state, batch, nowt)
        elif kind in ("frequent", "lossyFrequent"):
            new, out, a = W2.freq_args(op, state, batch, nowt)
        else:
            new, out, a = W.window_args(op, state, batch, nowt)
        assert a.n_part == batch.ts.shape[0] > 1
        placed, shared = check_moves(a, (state, batch, new, out, a._keep))
        assert placed > 0 and shared > 0
        n += 1
    assert n > 0
