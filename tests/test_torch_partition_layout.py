"""The slot layout that the host hands K4, K5 and K6 inside a partition
block (ops/slots.py part_moves, read by siddhi_kernels.h part_args), on
the CPU: every slotted launch of checks.PARTITION_APPS is captured, its
argument struct built as for the card, and the kernel's pointer moves
replayed on the struct's bytes. For every slot k, each word that points
at a slotted tensor must then point at that tensor's slot k, the block's
shared batch columns (slot stride 0) included. The words are found by
scanning the whole struct, apart from the walk of its fields that the
table is built from."""
import ctypes

import numpy as np
import pytest
import torch

import siddhi_tpu_torch as T
from siddhi_tpu_torch import checks as C
from siddhi_tpu_torch.core.types import GLOBAL_STRINGS as TSTR
from siddhi_tpu_torch.ops import aggregators as G
from siddhi_tpu_torch.ops import nfa as N
from siddhi_tpu_torch.ops import windows as W
from siddhi_tpu_torch.ops.slots import leaves
from siddhi_tpu_torch.parallel import partition as P

torch.set_num_threads(1)

CUTS = (0, 1, 9, 60, 61, 180, 230, 300, 400)


def captured(text):
    """Each slotted kernel call of one run of ``text``: [(kind, args)]."""
    calls = []
    saved = (W.window_step, G.aggregate_step, G.aggregate_emit,
             N.scan_step, N.timer_step, P.compact)
    k_win, k_agg, k_emit, k_scan, k_timer, k_compact = saved

    def window_step(op, state, batch, now):
        if batch.ts.dim() == 2:
            calls.append(("window", (op, state, batch, now)))
        return k_win(op, state, batch, now)

    def aggregate_step(op, state, kc, ac, kind, valid):
        if kind.dim() == 2:
            calls.append(("agg", (op, state, kc, ac, kind, valid)))
        return k_agg(op, state, kc, ac, kind, valid)

    def aggregate_emit(op, slots, qual, batch, oc, on, emitted=None):
        if batch.ts.dim() == 2:
            calls.append(("emit", (op, slots, qual, batch, oc, on,
                                   None if emitted is None
                                   else emitted.clone())))
        return k_emit(op, slots, qual, batch, oc, on, emitted)

    def scan_step(eng, sid, table, batch, due=None):
        if batch.ts.dim() == 2:
            calls.append(("scan", (eng, sid, leaves_clone(table), batch)))
        return k_scan(eng, sid, table, batch, due)

    def timer_step(eng, table, now, due=None):
        if table["state"].dim() == 2:
            calls.append(("scan", (eng, None, leaves_clone(table), None)))
        return k_timer(eng, table, now, due)

    def compact(out, cap, emitted, lost):
        calls.append(("compact", (out, cap, emitted.clone(), lost.clone())))
        return k_compact(out, cap, emitted, lost)

    (W.window_step, G.aggregate_step, G.aggregate_emit, N.scan_step,
     N.timer_step, P.compact) = (window_step, aggregate_step, aggregate_emit,
                                 scan_step, timer_step, compact)
    try:
        rt = T.SiddhiManager(device="cpu").create_siddhi_app_runtime(text)
        rt.start()
        ts, cols, _cuts = C.partition_feed(CUTS[-1], TSTR.encode,
                                           prefix="pl")
        h = rt.get_input_handler("S")
        for a, b in zip(CUTS[:-1], CUTS[1:]):
            h.send_arrays(ts[a:b], [c[a:b] for c in cols])
        with rt.barrier:
            rt.on_ingest_ts(int(ts[-1]) + 1000)
        rt.shutdown()
    finally:
        (W.window_step, G.aggregate_step, G.aggregate_emit, N.scan_step,
         N.timer_step, P.compact) = saved
    return calls


def leaves_clone(tree):
    if isinstance(tree, dict):
        return {k: leaves_clone(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(leaves_clone(v) for v in tree)
    return tree.clone()


def built(kind, call):
    """The launch's struct, as its wrapper builds it on the card, and the
    pytrees of its slotted tensors."""
    dev = torch.device("cpu")
    if kind == "window":
        op, state, batch, now = call
        new, out, a = W.window_args(op, state, batch, W._i64(now, dev))
        return a, (state, batch, new, out, a._keep)
    if kind == "agg":
        op, state, kc, ac, kd, v = call
        slots, aggs, new, a, _st = G.agg_args(op, state, kc, ac, kd, v)
        return a, (state, kc, ac, kd, v, slots, aggs, new, a._keep)
    if kind == "emit":
        op, slots, qual, batch, oc, on, emitted = call
        out, a = G.emit_args(op, slots, qual, batch, oc, on, emitted)
        return a, (slots, qual, batch, oc, on, out, a._keep)
    eng, sid, table, batch = call
    lead = tuple(table["state"].shape[:-1])
    out = N.kernel_out(eng, dev, lead)
    a = N.scan_args(eng, sid, table, batch, 0, out, None, dev)
    return a, (table, batch, out, N._staging(eng, dev, lead))


def check_moves(a, slotted):
    """part_args replayed for every slot of ``a``'s launch."""
    K = a.n_part
    words = np.frombuffer(ctypes.string_at(ctypes.addressof(a),
                                           ctypes.sizeof(a)),
                          dtype=np.uint64)
    tensors = {t.data_ptr(): t for t in leaves(slotted)
               if t.dim() and t.numel()}
    n = a.n_moves
    moves = np.ctypeslib.as_array(
        ctypes.cast(a.moves, ctypes.POINTER(ctypes.c_int64)),
        (2 * n,)).reshape(n, 2) if n else np.zeros((0, 2), np.int64)
    assert len(set(moves[:, 0])) == n and (moves[:, 0] % 8 == 0).all()
    at = [(i, tensors[int(w)]) for i, w in enumerate(words)
          if int(w) in tensors]
    assert at
    shared = 0
    for k in range(K):
        moved = words.astype(object)
        for off, st in moves:
            moved[off // 8] += k * int(st)
        for i, t in at:
            assert moved[i] == t[k].data_ptr(), (i, k, list(t.shape))
            shared += k > 0 and t.stride(0) == 0
    return len(at), shared


# the apps whose blocks run K4, K5 or K6 (the key overflow app's run
# only K2 and K9p)
KERNEL_APPS = [n for n in C.PARTITION_APPS if "key overflow" not in n]


@pytest.mark.parametrize("name", KERNEL_APPS)
def test_slot_moves_reach_every_slot(name):
    calls = [c for c in captured(C.PARTITION_APPS[name])
             if c[0] != "compact"]
    assert calls
    kinds, n_shared = set(), 0
    for kind, call in calls[:12]:
        a, slotted = built(kind, call)
        assert a.n_part > 1
        _n, shared = check_moves(a, slotted)
        n_shared += shared
        kinds.add(kind)
    # the block's input batch reaches its first operator unshared only
    # through the valid masks
    assert n_shared > 0, kinds


def test_compaction_reads_shared_columns_as_rows():
    """A block query that passes the input batch's ts on (no window):
    K9p's compaction gets a column the slots share (stride 0) and reads
    it as K * N rows, the values of the plain version's."""
    calls = [c for c in captured(C.PARTITION_APPS["key overflow, two "
                                                   "queries"])
             if c[0] == "compact"]
    assert calls
    shared = 0
    for _kind, (out, cap, emitted, lost) in calls:
        _picked, a = P.compact_args(out, cap, emitted.clone(),
                                    lost.clone())
        kept = a._keep[0]
        for x, k in zip([out.ts, *out.cols, *out.nulls, out.kind,
                         out.valid],
                        [kept.ts, *kept.cols, *kept.nulls, kept.kind,
                         kept.valid]):
            shared += x.stride(0) == 0
            assert k.is_contiguous() and torch.equal(k, x)
        assert a.ts == kept.ts.data_ptr() and a.n == out.ts.numel()
    assert shared > 0

