"""Kernel K1's plain version against the reference decode: the JAX
unpack_buffer (under jax.jit on the CPU, as the reference's own tests
run it) and the port's unpack_packed_ref decode the same PackedEncoder
buffers bit for bit, for every lane code, every column type, capacities
16 and 1024, and sticky encodings widening across chunks."""
import functools

import jax
import numpy as np
import pytest
import torch

import siddhi_tpu.core.event as jev
import siddhi_tpu.core.ingest as jing
import siddhi_tpu_torch.core.event as tev
import siddhi_tpu_torch.core.ingest as ting
from siddhi_tpu_torch.checks import INGEST_SPANS, INGEST_TYPES, ingest_chunk

torch.set_num_threads(1)

NAMES = [f"a{i}" for i in range(len(INGEST_TYPES))]


def schemas():
    js = jev.StreamSchema("S", tuple(
        jev.Attribute(n, jing.AttrType[t.name])
        for n, t in zip(NAMES, INGEST_TYPES)))
    ts_ = tev.StreamSchema("S", tuple(
        tev.Attribute(n, t) for n, t in zip(NAMES, INGEST_TYPES)))
    return js, ts_


def bits(a: np.ndarray) -> np.ndarray:
    if a.dtype == np.float32:
        return a.view(np.int32)
    if a.dtype == np.float64:
        return a.view(np.int64)
    return a


def assert_same_decode(js, enc, capacity, buf):
    jbatch, jnow = jax.jit(functools.partial(
        jing.unpack_buffer, js, enc, capacity))(buf)
    tbatch, tnow = ting.unpack_packed_ref(
        INGEST_TYPES, enc, capacity, torch.from_numpy(buf.copy()))
    pairs = [(jbatch.ts, tbatch.ts), (jbatch.kind, tbatch.kind),
             (jbatch.valid, tbatch.valid), (jnow, tnow)]
    pairs += list(zip(jbatch.cols, tbatch.cols))
    pairs += list(zip(jbatch.nulls, tbatch.nulls))
    for k, (j, t) in enumerate(pairs):
        j, t = np.asarray(j), t.numpy()
        assert j.dtype == t.dtype and j.shape == t.shape, (k, j.dtype,
                                                           t.dtype)
        assert np.array_equal(bits(j), bits(t)), (k, enc)


@pytest.mark.parametrize("capacity", [16, 1024])
@pytest.mark.parametrize("case", sorted(INGEST_SPANS))
def test_every_lane_code_decodes_bit_equal(case, capacity):
    js, ts_ = schemas()
    rng = np.random.default_rng(capacity + len(case))
    ts, cols = ingest_chunk(case, capacity - 3, rng)
    jbuf, jenc, jn = jing.PackedEncoder(js).encode(ts, cols, capacity, 42)
    tbuf, tenc, tn = ting.PackedEncoder(ts_).encode(ts, cols, capacity, 42)
    assert jenc == tenc and jn == tn
    assert jenc[0] == INGEST_SPANS[case][0]
    assert np.array_equal(np.asarray(jbuf), tbuf)   # same wire bytes
    assert_same_decode(js, jenc, capacity, np.asarray(jbuf))


def test_all_codes_are_covered():
    js, _ = schemas()
    seen = set()
    for case in INGEST_SPANS:
        ts, cols = ingest_chunk(case, 64, np.random.default_rng(1))
        _b, enc, _n = jing.PackedEncoder(js).encode(ts, cols, 64, 0)
        seen.update(enc)
    assert seen == set(ting.LANE_CODES)


def test_sticky_encodings_widen_across_chunks():
    """One encoder per package over a chunk sequence whose spans grow
    and shrink: codes only widen, and every chunk decodes equal."""
    js, ts_ = schemas()
    jenc_, tenc_ = jing.PackedEncoder(js), ting.PackedEncoder(ts_)
    rng = np.random.default_rng(3)
    codes = []
    for case, n, cap in (("c", 5, 16), ("d8", 100, 1024), ("c", 16, 16),
                         ("d16", 1000, 1024), ("d8", 7, 16),
                         ("raw64", 1021, 1024), ("c", 1, 16)):
        ts, cols = ingest_chunk(case, n, rng)
        jbuf, jenc, _ = jenc_.encode(ts, cols, cap, int(ts[-1]))
        tbuf, tenc, _ = tenc_.encode(ts, cols, cap, int(ts[-1]))
        assert jenc == tenc
        assert np.array_equal(np.asarray(jbuf), tbuf)
        assert_same_decode(js, jenc, cap, np.asarray(jbuf))
        codes.append(jenc)
    rank = {c: i for i, c in enumerate(jing._ORDER)}
    for a, b in zip(codes, codes[1:]):
        assert all(rank[y] >= rank[x] for x, y in zip(a, b)), (a, b)
    assert codes[-1][0] == "raw64"


def test_lane_descriptors_follow_layout():
    enc = ("d16", "d8", "raw64", "c", "f32", "f64", "b1")
    desc = ting.lane_descriptors(INGEST_TYPES, enc, 1024)
    _h, offs, _t = ting.layout(len(INGEST_TYPES), enc, 1024)
    assert [d[2] for d in desc] == offs
    assert [d[0] for d in desc] == [ting.LANE_CODES[c] for c in enc]
