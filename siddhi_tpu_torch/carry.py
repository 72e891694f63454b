"""Carry a reference (JAX package) process's state into the port.

``state_from_jax`` turns the numpy pytree of a reference
``QueryRuntime.snapshot_state()`` (``{"states": ..., "emitted": ...}``,
plus ``"nfa"`` for a pattern query) into the port's state for
``QueryRuntime.restore_state``.
``strings_from_jax`` seeds the port's string dictionary so that its
codes match the reference process's: both packages give strings codes
in order of first sight, so dictionary-coded columns and string
constants only compare equal once the two tables agree.

Neither function imports the reference: they take its plain values.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .core.types import GLOBAL_STRINGS


def _tree(tree, device):
    if isinstance(tree, dict):
        return {k: _tree(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree(v, device) for v in tree)
    return torch.from_numpy(np.array(tree, copy=True)).to(device)


def state_from_jax(snapshot: dict, device) -> dict:
    """A reference QueryRuntime snapshot -> the port's query state. A
    PatternQueryRuntime's snapshot also carries its NFA pending table
    (``"nfa"``: the same pytree, tuples of slot buffers included), for
    either engine: every field the scan engine writes (both deadline
    lanes, born, min_at, seq, the counters, the slots' ts and fill
    counts) comes across as it is."""
    state = {"states": _tree(snapshot["states"], device),
             "emitted": torch.tensor(int(np.asarray(snapshot["emitted"])),
                                     dtype=torch.int64, device=device)}
    if "nfa" in snapshot:
        state["nfa"] = _tree(snapshot["nfa"], device)
    return state


def strings_from_jax(codes_to_str: Sequence) -> None:
    """Seed GLOBAL_STRINGS with the reference's table (code -> string,
    code 0 = null). Strings the port already holds must have the same
    code; a conflict raises ValueError, since codes could not agree."""
    table = GLOBAL_STRINGS
    with table._lock:
        for code, s in enumerate(codes_to_str):
            if code == 0:
                continue
            if code < len(table._to_str):
                if table._to_str[code] != s:
                    raise ValueError(
                        f"string code {code} is {table._to_str[code]!r} "
                        f"here but {s!r} in the reference table")
                continue
            if s in table._to_code:
                raise ValueError(
                    f"string {s!r} has code {table._to_code[s]} here but "
                    f"{code} in the reference table")
            table._to_str.append(s)
            table._to_code[s] = code
