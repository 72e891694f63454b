"""Keyed device state: open-addressing hash table and segmented prefix
scans (PyTorch port of siddhi_tpu/ops/keyed.py).

Keys are 64-bit mixes of the group-by columns (dictionary codes for
strings, bit patterns for floats). A key gets a stable slot in a
fixed-capacity table; slot state lives in dense [K] tensors.

These are the plain versions kernel K6 (csrc/aggregate_step.cu) is held
against; they reproduce the reference's results bit for bit:
- ``cumsum_fast`` adds in ``jax.lax.associative_scan``'s own tree order
  (pair-reduce, recurse, fill the even elements), not torch.cumsum's,
  with the NaN of each add's left element first, as the reference's
  compiled tree picks it;
- every level of ``associative_scan`` interleaves its two halves the
  way jax does (``_interleave``): each half padded with zeros and the
  two added, so a float result passes through ``+ 0.0`` (-0.0 and
  subnormals come out as +0.0, a NaN keeps its bits);
- float adds and subtractions flush subnormal operands and results, as
  the reference's compiled CPU code does, and give their NaN bits by one
  explicit rule (``_nan_pick``), so that the plain version gives the same
  bits on the card as on the CPU;
- ``minimum``/``maximum`` are XLA's: NaN-propagating with its own
  choice between two NaNs, -0.0 below +0.0, subnormals read as zeros of
  their sign.
"""
from __future__ import annotations

import torch

from ..core.types import flush_subnormal
from .sentinels import NO_SLOT

_GOLDEN = -7046029254386353131          # 0x9E3779B97F4A7C15
_M1 = -4658895280553007687
_M2 = -7723592293110705685
HASH_SEED = 1469598103934665603
NULL_LANE = -987654321987654321


def mix64(h, v):
    """splitmix64-style mixing of an int64 lane into a running hash
    (wrapping int64 arithmetic, arithmetic shifts)."""
    h = h ^ (v + _GOLDEN)
    h = (h ^ (h >> 30)) * _M1
    h = (h ^ (h >> 27)) * _M2
    return h ^ (h >> 31)


def key_lane(values, null):
    """One group-by column as the int64 lane the hash mixes: float bits,
    ints widened, a null as NULL_LANE."""
    if values.dtype == torch.float64:
        lane = values.view(torch.int64)
    elif values.dtype == torch.float32:
        lane = values.view(torch.int32).to(torch.int64)
    else:
        lane = values.to(torch.int64)
    return torch.where(null, torch.full_like(lane, NULL_LANE), lane)


def hash_columns(cols, nulls):
    """[B] int64 key from parallel lists of value tensors and null masks."""
    B = cols[0].shape[0]
    h = torch.full((B,), HASH_SEED, dtype=torch.int64, device=cols[0].device)
    for values, null in zip(cols, nulls):
        h = mix64(h, key_lane(values, null))
    return h


def lookup_or_insert(table_keys, used, keys, active, max_probes: int = 16):
    """Open-addressing insert/lookup with linear probing, in rounds.

    table_keys [K] int64, used [K] bool, keys [B] int64, active [B] bool.
    -> (slots [B] int32, NO_SLOT where the probe ran out; table_keys';
    used'; overflow count, int64 0-d). Each round every pending row
    matches its key at its probed slot, races to claim the slot when it
    is free (the lowest row index wins), re-checks after the claims land
    (two rows inserting the same new key resolve here), else moves on."""
    K = table_keys.shape[0]
    B = keys.shape[0]
    dev = keys.device
    rows = torch.arange(B, dtype=torch.int32, device=dev)
    slot = torch.remainder(torch.abs(keys), K).to(torch.int64)
    placed = ~active
    result = torch.full((B,), int(NO_SLOT), dtype=torch.int32, device=dev)
    table_keys, used = table_keys.clone(), used.clone()
    for _ in range(max_probes):
        pending = ~placed
        if not bool(pending.any()):
            break        # every later round changes nothing
        occ = used[slot]
        match = pending & occ & (table_keys[slot] == keys)
        want = pending & ~occ
        claim = torch.full((K,), B, dtype=torch.int32, device=dev)
        claim.scatter_reduce_(0, torch.where(want, slot, 0),
                              torch.where(want, rows, B), "amin")
        winner = want & (claim[slot] == rows)
        table_keys[slot[winner]] = keys[winner]
        used[slot[winner]] = True
        match = match | (pending & used[slot] & (table_keys[slot] == keys))
        result = torch.where(match, slot.to(torch.int32), result)
        placed = placed | match
        slot = torch.where(placed, slot, torch.remainder(slot + 1, K))
    overflow = (active & (result == int(NO_SLOT))).sum(dtype=torch.int64)
    return result, table_keys, used, overflow


# ---------------------------------------------------------------------------
# the reference's arithmetic
# ---------------------------------------------------------------------------


_QUIET = {torch.float32: (torch.int32, 0x00400000, -0x00400000),
          torch.float64: (torch.int64, 0x0008000000000000,
                          -0x0008000000000000)}


def _nan_pick(r, a, b):
    """NaN results as the port's float lanes make them on every device,
    the bits the x86 CPU gives ``a + b`` and ``a - b`` in torch: a NaN
    ``b`` propagates first, then a NaN ``a`` (made quiet); an invalid
    operation on numbers gives the negative indefinite NaN."""
    ib, quiet, indefinite = _QUIET[r.dtype]

    def quieted(v):
        return (v.view(ib) | quiet).view(r.dtype)
    default = torch.tensor(indefinite, dtype=ib, device=r.device).view(
        r.dtype)
    return torch.where(torch.isnan(b), quieted(b), torch.where(
        torch.isnan(a), quieted(a), torch.where(torch.isnan(r), default, r)))


def add(a, b):
    """a + b as the reference's compiled code adds: ints wrap, floats
    flush subnormal operands and results; NaN bits by ``_nan_pick``."""
    if not a.is_floating_point():
        return a + b
    r = flush_subnormal(a) + flush_subnormal(b)
    return flush_subnormal(_nan_pick(r, a, b.expand_as(r)))


def sub(a, b):
    if not a.is_floating_point():
        return a - b
    r = flush_subnormal(a) - flush_subnormal(b)
    return flush_subnormal(_nan_pick(r, a, b.expand_as(r)))


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _two_prod(a, b):
    """a * b = p + e exactly (Dekker's product with Veltkamp's split)."""
    p = a * b

    def split(x):
        c = x * 134217729.0          # 2^27 + 1
        hi = c - (c - x)
        return hi, x - hi
    ah, al = split(a)
    bh, bl = split(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def fma(a, b, c):
    """a * b + c rounded once, for float64 tensors: the reference's
    compiled code contracts a multiply and an add into one fused
    operation where it can (stdDev's E[x^2] - mean^2). Boldo and
    Melquiond's emulation: the exact product and sum, their tail added
    with rounding to odd, then one rounding to nearest."""
    uh, ul = _two_prod(a, b)
    th, tl = _two_sum(c, uh)
    v, err = _two_sum(tl, ul)
    odd = (v.view(torch.int64) & 1) == 1
    toward = torch.where(err > 0, torch.full_like(v, float("inf")),
                         torch.full_like(v, float("-inf")))
    v = torch.where((err != 0) & ~odd, torch.nextafter(v, toward), v)
    exact = th + v
    plain = a * b + c
    return torch.where(torch.isfinite(exact), exact, plain)


def minimum(a, b):
    """XLA's minimum on the CPU, operand order included: subnormals read
    as zeros of their sign; of the operands, the one whose sign bit is
    clear goes first (``a`` if both have it); a NaN first operand is the
    result, else the smaller with -0.0 < +0.0, else the second operand
    (a NaN second operand propagates so)."""
    if not a.is_floating_point():
        return torch.minimum(a, b)
    fa, fb = flush_subnormal(a), flush_subnormal(b)
    neg = torch.signbit(fa)
    x, y = torch.where(neg, fb, fa), torch.where(neg, fa, fb)
    return torch.where(torch.isnan(x) | (x < y), x, y)


def maximum(a, b):
    """XLA's maximum on the CPU: as ``minimum``, with the operand whose
    sign bit is set first and the larger one kept."""
    if not a.is_floating_point():
        return torch.maximum(a, b)
    fa, fb = flush_subnormal(a), flush_subnormal(b)
    neg = torch.signbit(fa)
    x, y = torch.where(neg, fa, fb), torch.where(neg, fb, fa)
    return torch.where(torch.isnan(x) | (x > y), x, y)


# ---------------------------------------------------------------------------
# segmented prefix scans (rows sorted so that equal seg_ids are adjacent)
# ---------------------------------------------------------------------------


def _plus_zero(v):
    """A float result of jax's ``_interleave``: v + 0.0, the zero of the
    other half's padding (ints and bools pass unchanged)."""
    if not v.is_floating_point():
        return v
    return add(v, torch.zeros_like(v))


def associative_scan(fn, elems):
    """``jax.lax.associative_scan(fn, elems)`` along axis 0, in its own
    order: combine adjacent pairs, scan those, then fill the even
    elements, and interleave the two halves by padding and adding
    (``_plus_zero``). ``elems`` is a tuple of tensors; -> a tuple."""
    n = elems[0].shape[0]
    if n < 2:
        return elems
    reduced = fn(tuple(e[0:n - 1:2] for e in elems),
                 tuple(e[1::2] for e in elems))
    odd = associative_scan(fn, reduced)
    if n % 2 == 0:
        even = fn(tuple(e[:-1] for e in odd), tuple(e[2::2] for e in elems))
    else:
        even = fn(odd, tuple(e[2::2] for e in elems))
    out = []
    for e, ev, od in zip(elems, even, odd):
        r = torch.empty_like(e)
        r[0] = e[0]
        r[2::2] = ev
        r[1::2] = od
        out.append(_plus_zero(r))
    return tuple(out)


def cumsum_fast(vals):
    """Inclusive prefix sum in the reference's associative-scan order,
    each add taking its operands swapped (right element first): of two
    NaN elements the left one's propagates, as in the reference's
    compiled tree."""
    return associative_scan(lambda a, b: (add(b[0], a[0]),), (vals,))[0]


def segment_starts(seg_ids):
    """Index of the first element of each element's run of equal ids."""
    n = seg_ids.shape[0]
    idx = torch.arange(n, dtype=torch.int64, device=seg_ids.device)
    boundary = torch.ones((n,), dtype=torch.bool, device=seg_ids.device)
    boundary[1:] = seg_ids[1:] != seg_ids[:-1]
    return torch.cummax(torch.where(boundary, idx, 0), 0).values


def segmented_cumsum(vals, seg_ids):
    """Inclusive prefix sum within runs of equal seg_ids: the global
    prefix less the prefix just before the run."""
    cs = cumsum_fast(vals)
    seg_start = segment_starts(seg_ids)
    before = torch.where(seg_start > 0, cs[torch.clamp(seg_start - 1, min=0)],
                         torch.zeros_like(cs))
    return sub(cs, before)


def segmented_cummin(vals, seg_ids):
    return _segmented_scan(vals, seg_ids, minimum)


def segmented_cummax(vals, seg_ids):
    return _segmented_scan(vals, seg_ids, maximum)


def _segmented_scan(vals, seg_ids, op):
    def combine(a, b):
        av, aseg = a
        bv, bseg = b
        return (torch.where(aseg == bseg, op(av, bv), bv),
                torch.maximum(aseg, bseg))

    return associative_scan(combine, (vals, seg_ids))[0]
