"""Kernel G[K]'s plain version (ops/selector.py shape_chunk_slots_ref)
against the reference's shape_output (siddhi_tpu/ops/selector.py:88)
under ``jax.vmap``, as a partition block's run_block and a tenant pool's
chain step apply it, function against function, on the CPU: ``[K, B]``
batches made from a seed with numpy (test_torch_order_keys.chunk: every
key type with its traps, zeros of both signs, subnormals, NaN of both
signs, the infinities, the INT and LONG extremes, ties; a slot whose
rows are all dead) shaped by one key asc and desc, by two keys, with
offset alone, limit alone and both, and by offset and limit without a
key (the rows keep their places). The shaped batches (every slot, dead
rows included: timestamps, kinds, valid flags, every column and null
mask, floats by their bits) and each slot's kept count are equal, bit
for bit (tolerance 0). Columns that every slot shares (a block's input,
``expand``-ed) shape as their copies do, and G[K]'s arguments carry
each input's slot stride."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from siddhi_tpu.core.event import EventBatch as JBatch
from siddhi_tpu.ops.selector import shape_output
from siddhi_tpu_torch import _kernels
from siddhi_tpu_torch.core.event import EventBatch as TBatch
from siddhi_tpu_torch.ops.selector import (order_slot_args, shape_chunk,
                                           shape_chunk_slots_ref)
from test_torch_order_keys import SHAPES, TYPES, as_bits, chunk

torch.set_num_threads(1)

K = 5
DEAD = 2   # the slot whose rows are all dead


def slotted(seed: int):
    """K chunks of test_torch_order_keys.chunk stacked on a slot axis,
    slot DEAD with no valid row. -> (reference batch, port batch)."""
    parts = [chunk(seed * K + k) for k in range(K)]
    ts = np.stack([p[0] for p in parts])
    cols = [np.stack([p[1][i] for p in parts]) for i in range(5)]
    nulls = [np.stack([p[2][i] for p in parts]) for i in range(5)]
    kind = np.stack([p[3] for p in parts])
    valid = np.stack([p[4] for p in parts])
    valid[DEAD] = False
    return batches(ts, cols, nulls, kind, valid)


def batches(ts, cols, nulls, kind, valid):
    j = JBatch(ts=jnp.asarray(ts), cols=tuple(jnp.asarray(c) for c in cols),
               nulls=tuple(jnp.asarray(n) for n in nulls),
               kind=jnp.asarray(kind), valid=jnp.asarray(valid))
    t = TBatch(ts=torch.from_numpy(ts), cols=tuple(torch.from_numpy(c)
                                                   for c in cols),
               nulls=tuple(torch.from_numpy(n) for n in nulls),
               kind=torch.from_numpy(kind), valid=torch.from_numpy(valid))
    return j, t


def reference(j, order, offset, limit):
    """shape_output under jax.vmap over the slot axis."""
    return jax.vmap(lambda b: shape_output(b, order, offset, limit))(j)


def assert_same(jo, to):
    for name in ("ts", "kind", "valid"):
        assert np.array_equal(np.asarray(getattr(jo, name)),
                              getattr(to, name).numpy()), name
    for k, (jc, tc, jn, tn) in enumerate(zip(jo.cols, to.cols, jo.nulls,
                                             to.nulls)):
        assert np.array_equal(as_bits(jc), as_bits(tc.numpy())), k
        assert np.array_equal(np.asarray(jn), tn.numpy()), k


def check(j, t, order, offset, limit):
    """Both counters' layouts: one for every slot and one a slot."""
    jo = reference(j, order, offset, limit)
    one = torch.zeros((), dtype=torch.int64)
    each = torch.full((K,), 3, dtype=torch.int64)
    assert_same(jo, shape_chunk_slots_ref(t, order, offset, limit, one))
    assert_same(jo, shape_chunk(t, order, offset, limit, each))
    kept = np.asarray(jo.valid).sum(1)
    assert int(one) == int(kept.sum())
    assert each.tolist() == (kept + 3).tolist()
    assert kept[DEAD] == 0
    return jo


@pytest.mark.parametrize("direction", ["asc", "desc"])
@pytest.mark.parametrize("key", TYPES)
def test_one_key_equals_the_reference_in_every_slot(key, direction):
    """Asc takes offset alone and both, desc neither and limit alone."""
    j, t = slotted(seed=TYPES.index(key))
    order = [(TYPES.index(key), direction)]
    for offset, limit in SHAPES[1::2] if direction == "asc" \
            else SHAPES[::2]:
        check(j, t, order, offset, limit)


@pytest.mark.parametrize("first,second", [
    ("bool", "double"), ("float", "long"), ("int", "float"),
    ("double", "int")])
def test_two_keys_equal_the_reference_in_every_slot(first, second):
    j, t = slotted(seed=11)
    order = [(TYPES.index(first), "desc"), (TYPES.index(second), "asc")]
    check(j, t, order, 2, 20)
    check(j, t, order, None, None)


@pytest.mark.parametrize("offset,limit", SHAPES[1:])
def test_offset_and_limit_without_a_key_keep_the_rows_in_place(offset,
                                                               limit):
    j, t = slotted(seed=13)
    jo = check(j, t, [], offset, limit)
    assert np.array_equal(np.asarray(jo.ts), t.ts.numpy())


def test_columns_every_slot_shares_shape_as_their_copies():
    """A block's input columns are one [B] tensor every slot reads (an
    ``expand``-ed view, slot stride 0) and only the valid masks are the
    slots' own: shaped as copies of them, and G[K]'s arguments carry
    stride 0 for the shared inputs, B for the slots' own."""
    ts, cols, nulls, kind, valid = chunk(17)
    B = len(ts)
    rng = np.random.default_rng(17)
    vk = rng.random((K, B)) < 0.3
    vk[DEAD] = False

    def rep(x):
        return np.broadcast_to(x, (K,) + x.shape).copy()
    j, _ = batches(rep(ts), [rep(c) for c in cols], [rep(n) for n in nulls],
                   rep(kind), vk)

    def exp(x):
        return torch.from_numpy(x).unsqueeze(0).expand((K,) + x.shape)
    t = TBatch(ts=exp(ts), cols=tuple(exp(c) for c in cols),
               nulls=tuple(exp(n) for n in nulls), kind=exp(kind),
               valid=torch.from_numpy(vk))
    order = [(3, "desc"), (0, "asc")]
    check(j, t, order, 1, 4)
    _res, a = order_slot_args(t, order, 1, 4, None)
    assert (a.K, a.B, a.n_keys) == (K, B, 2)
    assert (a.ts_stride, a.kind_stride, a.valid_stride) == (0, 0, B)
    assert list(a.col_stride[:5]) == [0] * 5
    assert list(a.null_stride[:5]) == [0] * 5
    # a slot's rows fit its block's shared memory: no global scratch
    assert not a._keep[2] and B <= _kernels.ORDER_SHARED_ROWS
    assert not a.k1


@pytest.mark.parametrize("B,order,scratch", [
    (_kernels.ORDER_SHARED_ROWS, [(0, "asc")], False),
    (_kernels.ORDER_SHARED_ROWS + 1, [(0, "asc")], True),
    (_kernels.ORDER_SHARED_ROWS + 1, [], False)])
def test_the_scratch_pointer_picks_the_sort_branch(B, order, scratch):
    """G[K] sorts in global memory exactly when its arguments carry the
    scratch (k1 non-NULL): past ORDER_SHARED_ROWS rows a slot, and only
    with an order key; the scratch holds every slot's rows."""
    z = torch.zeros((2, B), dtype=torch.int64)
    t = TBatch(ts=z, cols=(z,), nulls=(z.bool(),), kind=z.int(),
               valid=z.bool())
    _res, a = order_slot_args(t, order, None, 3, None)
    assert bool(a.k1) == scratch and bool(a._keep[2]) == scratch
    if scratch:
        assert [v.numel() for k, v in sorted(a._keep[2].items())
                if k != "counts"] == [2 * B] * 4
