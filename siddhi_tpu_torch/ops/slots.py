"""The slot axis of a partition block (siddhi_tpu/parallel/partition.py
runs its inner queries under ``jax.vmap`` over K key slots).

Inside a block every operator state and every batch carries a leading
``[K]`` axis: slot k's state is ``state[k]``, slot k's batch the rows
``[k, :]`` of each column. The kernels K4, K5 and K6 take that axis as
one more launch dimension (one thread block, or one row of blocks, per
slot). Their plain versions are the un-slotted plain versions run once
per slot, which is what the reference's vmap computes; the helpers here
split a slotted pytree into slots and stack the per-slot results back.

The kernels' slot layout is the host's: ``part_moves`` hands a launch
the byte stride of every slotted tensor it points at, so a column that
all slots share (the batch's, ``expand``-ed) costs no copy.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.event import EventBatch


def tree_map(fn, tree):
    """``fn`` over every tensor of a nested dict/tuple/list/EventBatch."""
    if isinstance(tree, EventBatch):
        return EventBatch(fn(tree.ts), tuple(fn(c) for c in tree.cols),
                          tuple(fn(n) for n in tree.nulls), fn(tree.kind),
                          fn(tree.valid))
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if tree is None:
        return None
    return fn(tree)


def unstack(tree, k: int):
    """Slot ``k`` of a slotted pytree."""
    return tree_map(lambda x: x[k], tree)


def stack(trees: list):
    """Per-slot pytrees of one structure -> one slotted pytree."""
    first = trees[0]
    if isinstance(first, EventBatch):
        return EventBatch(
            torch.stack([t.ts for t in trees]),
            tuple(torch.stack([t.cols[i] for t in trees])
                  for i in range(len(first.cols))),
            tuple(torch.stack([t.nulls[i] for t in trees])
                  for i in range(len(first.nulls))),
            torch.stack([t.kind for t in trees]),
            torch.stack([t.valid for t in trees]))
    if isinstance(first, dict):
        return {k: stack([t[k] for t in trees]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(stack([t[i] for t in trees])
                           for i in range(len(first)))
    if first is None:
        return None
    return torch.stack([torch.as_tensor(t) for t in trees])


def stacked(state, K: int, device=None):
    """An un-slotted state broadcast to K slots (fresh, contiguous)."""
    def rep(x):
        x = torch.as_tensor(x)
        if device is not None:
            x = x.to(device)
        return x.unsqueeze(0).expand((K,) + tuple(x.shape)).clone()
    return tree_map(rep, state)


def per_slot(fn, K: int, *trees):
    """The plain version of a slotted kernel: ``fn`` once per slot over
    slot k of each of ``trees`` (None passes through), the results
    stacked."""
    outs = [fn(*(unstack(t, k) if t is not None else None for t in trees))
            for k in range(K)]
    return stack(outs)


def flat(batch: EventBatch) -> EventBatch:
    """A slotted batch as one batch of K * rows rows (a view)."""
    def f(x):
        return x.reshape((-1,) + tuple(x.shape[2:]))
    return tree_map(f, batch)


def leaves(tree) -> list:
    """The tensors of a nested dict/tuple/list/EventBatch."""
    out: list = []
    tree_map(lambda x: out.append(x) if isinstance(x, torch.Tensor)
             else None, tree)
    return out


_PTR_WORDS: dict = {}   # a ctypes struct type -> its pointers' word indices
_MOVES: dict = {}       # (device, move table bytes) -> the table on it


def _ptr_words(ctype, base: int = 0) -> list:
    """The 8-byte word index of every pointer field of a ctypes struct
    (pointer arrays and nested structs included)."""
    out = []
    for name, ft in ctype._fields_:
        off = base + getattr(ctype, name).offset
        if ft is ctypes.c_void_p:
            out.append(off // 8)
        elif issubclass(ft, ctypes.Array) and ft._type_ is ctypes.c_void_p:
            out.extend(off // 8 + i for i in range(ft._length_))
        elif issubclass(ft, ctypes.Structure):
            out.extend(_ptr_words(ft, off))
    return out


def part_moves(args, slotted, dev) -> None:
    """Set a K4, K5 or K6 launch's slot layout (siddhi_kernels.h
    part_args): ``args.moves``, for every pointer of ``args`` into a
    tensor of ``slotted`` (pytrees whose tensors carry the leading slot
    axis), the pointer's byte offset in the struct and the tensor's slot
    stride in bytes; a stride of 0 (a shared column) is left out. The
    table lives on ``dev``, one per distinct layout. One slot, or none,
    needs no table."""
    if args.n_part <= 1:
        args.moves, args.n_moves = None, 0
        return
    stride: dict = {}
    for x in leaves(slotted):
        if x.dim() == 0 or x.numel() == 0:
            continue
        p, st = x.data_ptr(), x.stride(0) * x.element_size()
        if stride.setdefault(p, st) != st:
            raise ValueError("part_moves: two slot strides for one tensor "
                             f"address ({stride[p]} and {st} bytes)")
    t = type(args)
    if t not in _PTR_WORDS:
        _PTR_WORDS[t] = np.asarray(_ptr_words(t), dtype=np.int64)
    widx = _PTR_WORDS[t]
    words = np.frombuffer(ctypes.string_at(ctypes.addressof(args),
                                           ctypes.sizeof(args)),
                          dtype=np.uint64)[widx]
    ptrs = np.fromiter(stride, dtype=np.uint64, count=len(stride))
    strides = np.fromiter(stride.values(), dtype=np.int64, count=len(stride))
    order = np.argsort(ptrs)
    ptrs = np.append(ptrs[order], np.uint64(0))
    strides = np.append(strides[order], np.int64(0))
    at = np.searchsorted(ptrs[:-1], words)   # len(ptrs) - 1: no tensor
    hit = (ptrs[at] == words) & (strides[at] != 0)
    table = np.stack([8 * widx[hit], strides[at][hit]], axis=1)
    key = (str(dev), table.tobytes())
    if key not in _MOVES:
        _MOVES[key] = torch.from_numpy(table.reshape(-1).copy()).to(dev) \
            if len(table) else None
    moves = _MOVES[key]
    args.moves = None if moves is None else moves.data_ptr()
    args.n_moves = len(table)

