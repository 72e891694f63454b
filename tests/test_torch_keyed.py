"""The port's keyed-state helpers (siddhi_tpu_torch/ops/keyed.py, the
plain versions kernel K6 is held against) against the reference's
siddhi_tpu/ops/keyed.py under jax.jit on the CPU, bit for bit
(tolerance 0: float results are compared by their bits):

- hash_columns over every column type, nulls included;
- lookup_or_insert: slots, the table after the claims, overflow, with
  same-key races and a full table;
- cumsum_fast in jax.lax.associative_scan's own addition order (a feed
  where torch.cumsum's order differs in the last bit), and the
  segmented sum, min and max scans;
- minimum/maximum on NaNs of either sign, signed zeros and subnormals;
- a scatter's updates applied in row order (1e16, 1, -1e16), and the
  fused multiply-add the reference's compiler makes of stdDev's
  E[x^2] - mean^2."""
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import siddhi_tpu  # noqa: F401  (x64 on)
from siddhi_tpu.ops import keyed as jk
from siddhi_tpu_torch.ops import keyed as tk

torch.set_num_threads(1)


def bits(a):
    a = np.asarray(a)
    if a.dtype == np.float64:
        return a.view(np.int64)
    if a.dtype == np.float32:
        return a.view(np.int32)
    return a


def same(j, t) -> bool:
    j, t = np.asarray(j), t.numpy() if isinstance(t, torch.Tensor) else t
    return j.shape == t.shape and j.dtype == t.dtype and \
        bool((bits(j) == bits(t)).all())


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


RNG = np.random.default_rng(20)
N = 400
COLS = [RNG.integers(-3, 3, N).astype(np.int32),
        RNG.integers(-(2 ** 62), 2 ** 62, N),
        RNG.standard_normal(N).astype(np.float32),
        RNG.standard_normal(N),
        RNG.random(N) < 0.5]
COLS[2][:4] = [0.0, -0.0, np.nan, 1e-45]
COLS[3][:4] = [0.0, -0.0, np.nan, 5e-324]
NULLS = [RNG.random(N) < 0.2 for _ in COLS]


def test_hash_columns_equals_the_reference():
    j = jax.jit(jk.hash_columns)([jnp.asarray(c) for c in COLS],
                                 [jnp.asarray(n) for n in NULLS])
    assert same(j, tk.hash_columns([T(c) for c in COLS],
                                   [T(n) for n in NULLS]))


def _probe_cases():
    keys = np.asarray(jax.jit(jk.hash_columns)(
        [jnp.asarray(RNG.integers(0, 40, 300).astype(np.int32))],
        [jnp.zeros(300, bool)]))
    return {
        # 40 keys, many rows per key racing for the same new slot
        "same-key races": (64, keys, RNG.random(300) < 0.8),
        # more distinct keys than slots: the probe runs out, overflow
        "full table": (16, RNG.integers(-(2 ** 62), 2 ** 62, 300),
                       np.ones(300, bool)),
        # keys whose home slots collide (multiples of K), |INT64_MIN|
        "colliding homes": (32, np.concatenate([
            np.arange(0, 64 * 20, 64), [np.iinfo(np.int64).min, -32, 32]]),
            np.ones(23, bool)),
    }


@pytest.mark.parametrize("case", sorted(_probe_cases()))
def test_lookup_or_insert_equals_the_reference(case):
    K, keys, active = _probe_cases()[case]
    tab = RNG.integers(-5, 5, K)
    used = np.zeros(K, bool)
    used[::7] = True          # a table with occupants already
    j = jax.jit(jk.lookup_or_insert)(jnp.asarray(tab), jnp.asarray(used),
                                     jnp.asarray(keys), jnp.asarray(active))
    t = tk.lookup_or_insert(T(tab), T(used), T(keys), T(active))
    for a, b in zip(j, t):
        assert same(a, b)
    if case == "full table":
        assert int(t[3]) > 0


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 17, 100, 1023, 4096])
def test_cumsum_fast_adds_in_the_reference_order(n):
    x = RNG.standard_normal(n) * 10.0 ** RNG.integers(-5, 17, n)
    j = jax.jit(jk.cumsum_fast)(jnp.asarray(x))
    assert same(j, tk.cumsum_fast(T(x)))
    ints = RNG.integers(-(2 ** 62), 2 ** 62, n)   # wrapping int lanes
    assert same(jax.jit(jk.cumsum_fast)(jnp.asarray(ints)),
                tk.cumsum_fast(T(ints)))


def test_a_naive_cumsum_differs_in_the_last_bit():
    x = np.array([1e16, 1.0, 1.0, 1.0, -1e16, 3.0, 0.1, 0.2])
    j = np.asarray(jax.jit(jk.cumsum_fast)(jnp.asarray(x)))
    assert same(j, tk.cumsum_fast(T(x)))
    assert not same(j, torch.cumsum(T(x), 0))


# finite values (+0.0 included): the reference's NaN sign where a sum
# lane meets NaN or inf - inf, and its zero at a segment's first row of
# a min/max lane that holds -0.0 or a subnormal, are not reproduced
# (ROADMAP.md, Queue 3)
SCAN_VALS = np.concatenate([RNG.standard_normal(300) * 100,
                            [0.0, 0.0, 1e300, -1e300, 5e-300]])


@pytest.mark.parametrize("scan", ["segmented_cumsum", "segmented_cummin",
                                  "segmented_cummax"])
def test_segmented_scans_equal_the_reference(scan):
    x = RNG.permutation(SCAN_VALS)
    seg = np.sort(RNG.integers(0, 9, len(x)))
    j = jax.jit(getattr(jk, scan))(jnp.asarray(x), jnp.asarray(seg))
    assert same(j, getattr(tk, scan)(T(x), T(seg)))


def _specials(dtype):
    nans = np.array([0x7FF8000000000123, -0x0007FFFFFFFFFABD,
                     0x7FF0000000000123], np.int64).view(np.float64)
    v = np.concatenate([[0.0, -0.0, 1.0, -1.0, np.inf, -np.inf, 5e-324,
                         -5e-324, np.nan, -np.nan], nans])
    with np.errstate(invalid="ignore"):
        v = v.astype(dtype)
    if dtype == np.float32:
        v[6:8] = [1e-45, -1e-45]
    return np.repeat(v, len(v)), np.tile(v, len(v))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_minimum_maximum_equal_xla(dtype):
    a, b = _specials(dtype)
    mn, mx = jax.jit(lambda a, b: (jnp.minimum(a, b), jnp.maximum(a, b)))(
        a, b)
    assert same(mn, tk.minimum(T(a), T(b)))
    assert same(mx, tk.maximum(T(a), T(b)))


def test_scatter_updates_apply_in_row_order():
    """base.at[tgt].add/min/max folds each slot's updates one after the
    other in row order: the port's carry fold (aggregators._fold_carry)
    does the same."""
    from siddhi_tpu_torch.ops.aggregators import Lane, _fold_carry
    tgt = np.array([0, 0, 0, 1, 1, 2, 2, 2, 3])
    upd = np.array([1e16, 1.0, -1e16, 1.0, 1e-320, np.nan, -np.nan, 1.0,
                    -0.0])
    mask = np.ones(len(tgt), bool)
    mask[4] = False
    folded = {}
    for op in ("add", "min", "max"):
        base = np.array([0.0, 2.0, 0.5, 0.0]) if op == "add" else \
            np.array([3.0, -0.0, np.inf, 0.0])
        j = jax.jit(lambda b, t, u, m, op=op: getattr(
            b.at[jnp.where(m, t, 4)], op)(u, mode="drop"))(
                base, tgt, upd, mask)
        lane = Lane({"add": "sum"}.get(op, op), torch.float64)
        t = _fold_carry(lane, T(base), T(upd), T(tgt), T(mask))
        assert same(j, t), op
        folded[op] = np.asarray(j)
    # 0 + 1e16 + 1 - 1e16 in row order loses the 1
    assert folded["add"][0] == 0.0 and folded["add"][1] == 3.0


def test_fused_multiply_add_is_rounded_once():
    a = RNG.uniform(0, 400, 2000)
    c = a * a * RNG.uniform(0.999, 1.001, 2000)
    got = tk.fma(T(-a), T(a), T(c)).numpy()
    want = np.array([float(Fraction(z) - Fraction(x) * Fraction(x))
                     for x, z in zip(a, c)])
    assert same(want, got)


def _special_feed(seed):
    """The feed that showed both faults: 300 normals with NaN, -NaN,
    +-0.0, +-5e-324 and +-inf, in segments of a sorted id (ROADMAP's
    search: seed 0 gave the NaN sign of a sum lane at element 211, seed
    3 the -0.0 at a segment's first element of a min/max lane)."""
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.standard_normal(300) * 100,
                        [np.nan, -np.nan, 0.0, -0.0, 5e-324, -5e-324,
                         np.inf, -np.inf]])
    x = rng.permutation(x)
    return x, np.sort(rng.integers(0, 9, len(x)))


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("scan", ["cumsum_fast", "segmented_cumsum",
                                  "segmented_cummin", "segmented_cummax"])
def test_scans_on_special_values_equal_the_reference(scan, seed):
    """NaN of either sign, both infinities, -0.0 and subnormals: the
    reference's tree takes the NaN of each add's second operand, and its
    interleave adds +0.0 to every result (jax's _interleave)."""
    x, seg = _special_feed(seed)
    if scan == "cumsum_fast":
        j = jax.jit(jk.cumsum_fast)(jnp.asarray(x))
        t = tk.cumsum_fast(T(x))
    else:
        j = jax.jit(getattr(jk, scan))(jnp.asarray(x), jnp.asarray(seg))
        t = getattr(tk, scan)(T(x), T(seg))
    assert same(j, t)
