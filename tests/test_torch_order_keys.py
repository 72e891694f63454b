"""Kernel G's plain version (ops/selector.py shape_chunk_ref) against
the reference's own shape_output (siddhi_tpu/ops/selector.py:88, its
jnp.lexsort), function against function, on the CPU: the same chunk
(made from a seed with numpy: every key type, each with its traps:
zeros of both signs, subnormals, NaN of both signs, the infinities, the
INT and LONG extremes; repeated values for ties; a third of the rows
invalid) shaped by one key asc and desc, by two keys, with offset
alone, limit alone and both. The shaped chunks (timestamps, kinds,
valid flags, every column and null mask, floats by their bits) are
equal, bit for bit (tolerance 0), and so are the emitted counts."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from siddhi_tpu.core.event import EventBatch as JBatch
from siddhi_tpu.ops.selector import shape_output
from siddhi_tpu_torch.core.event import EventBatch as TBatch
from siddhi_tpu_torch.ops.selector import shape_chunk_ref

torch.set_num_threads(1)

B = 96
TYPES = ("int", "long", "float", "double", "bool")
SHAPES = [(None, None), (5, None), (None, 7), (3, 11)]


def chunk(seed: int):
    """Five columns (int32, int64, float32, float64, bool) with traps."""
    rng = np.random.default_rng(seed)
    i32 = rng.integers(-4, 5, B).astype(np.int32)
    i32[rng.choice(B, 6, replace=False)] = [np.iinfo(np.int32).min] * 3 + \
        [np.iinfo(np.int32).max] * 3
    i64 = rng.integers(-4, 5, B).astype(np.int64)
    i64[rng.choice(B, 6, replace=False)] = [np.iinfo(np.int64).min] * 3 + \
        [np.iinfo(np.int64).max] * 3
    f64 = rng.choice([-1.5, 0.0, 2.0, 3.25], B)
    traps = [0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf, 5e-324, -5e-324,
             1e-310]
    f64[rng.choice(B, 18, replace=False)] = traps * 2
    f64 = np.where(np.arange(B) % 17 == 3, -np.abs(np.nan), f64)
    f32 = f64.astype(np.float32)
    f32[rng.choice(B, 4, replace=False)] = np.float32(1e-40)   # subnormal
    b = rng.random(B) < 0.5
    valid = rng.random(B) < 0.67
    ts = 1_700_000_000_000 + np.arange(B, dtype=np.int64)
    kind = rng.integers(0, 2, B).astype(np.int32)
    nulls = [rng.random(B) < 0.1 for _ in range(5)]
    return ts, [i32, i64, f32, f64, b], nulls, kind, valid


def both(seed: int):
    ts, cols, nulls, kind, valid = chunk(seed)
    j = JBatch(ts=jnp.asarray(ts), cols=tuple(jnp.asarray(c) for c in cols),
               nulls=tuple(jnp.asarray(n) for n in nulls),
               kind=jnp.asarray(kind), valid=jnp.asarray(valid))
    t = TBatch(ts=torch.from_numpy(ts), cols=tuple(torch.from_numpy(c)
                                                   for c in cols),
               nulls=tuple(torch.from_numpy(n) for n in nulls),
               kind=torch.from_numpy(kind), valid=torch.from_numpy(valid))
    return j, t


def as_bits(x):
    a = np.asarray(x)
    if a.dtype.kind == "f":
        return a.view(np.int64 if a.itemsize == 8 else np.int32)
    return a


def assert_same(jo, to):
    for name, jx, tx in (("ts", jo.ts, to.ts), ("kind", jo.kind, to.kind),
                         ("valid", jo.valid, to.valid)):
        assert np.array_equal(np.asarray(jx), tx.numpy()), name
    for k, (jc, tc, jn, tn) in enumerate(zip(jo.cols, to.cols, jo.nulls,
                                             to.nulls)):
        assert np.array_equal(as_bits(jc), as_bits(tc.numpy())), k
        assert np.array_equal(np.asarray(jn), tn.numpy()), k


@pytest.mark.parametrize("offset,limit", SHAPES)
@pytest.mark.parametrize("direction", ["asc", "desc"])
@pytest.mark.parametrize("key", TYPES)
def test_one_key_equals_the_reference(key, direction, offset, limit):
    j, t = both(seed=TYPES.index(key))
    order = [(TYPES.index(key), direction)]
    emitted = torch.zeros((), dtype=torch.int64)
    to = shape_chunk_ref(t, order, offset, limit, emitted)
    jo = shape_output(j, order, offset, limit)
    assert_same(jo, to)
    assert int(emitted) == int(np.asarray(jo.valid).sum())


@pytest.mark.parametrize("first,second", [
    (f, s) for f in ("bool", "float", "int") for s in TYPES if s != f])
def test_two_keys_equal_the_reference(first, second):
    j, t = both(seed=7)
    order = [(TYPES.index(first), "desc"), (TYPES.index(second), "asc")]
    to = shape_chunk_ref(t, order, 2, 20)
    assert_same(shape_output(j, order, 2, 20), to)
