"""Build, load and count the hand-written CUDA kernels of the port.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into
its own shared library with a plain C interface, and called through
ctypes: the sources include no PyTorch header, so a build takes seconds
and not the minutes a PyTorch extension build takes. All sources
compile at once, one ``nvcc`` process each, into
``siddhi_tpu_torch/_build/`` (git-ignored) at first use; a library is
rebuilt when its source or the shared header changes.

Kernel arguments travel as one C struct each (``csrc/siddhi_kernels.h``),
mirrored here with ctypes. A launcher returns ``cudaGetLastError()``;
the wrappers raise when it is not ``cudaSuccess`` (0).

``LAUNCHES`` counts launches per kernel: each wrapper adds one where it
launches its kernel and nowhere else, so a run can show that the main
path went through the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "_build"
SOURCES = {"unpack_packed": "unpack_packed.cu", "expr_eval": "expr_eval.cu",
           "nfa_parallel": "nfa_parallel.cu", "nfa_scan": "nfa_scan.cu",
           "window_step": "window_step.cu", "window_seq": "window_seq.cu",
           "aggregate_step": "aggregate_step.cu",
           "join_cross": "join_cross.cu", "table_step": "table_step.cu",
           "session_step": "session_step.cu", "order_by": "order_by.cu",
           "union_set": "union_set.cu", "partition": "partition.cu",
           "aggregation_step": "aggregation_step.cu",
           "reorder_ring": "reorder_ring.cu"}
ARCH = "-gencode=arch=compute_90a,code=sm_90a"

# entry points counted apart: the aggregate step's emission; K7's probe
# and grid; K8's write, condition pass, index probe and seq-ordered view;
# K9p's route, compaction and due; and the launches of K4, K5 and K6 with
# a partition block's slot axis ("[K]"); K11's bucket step; K5's cron
# kind (K5c); the reorder ring's step (K10); the launches of K1, K3 and
# K7 with a tenant pool's slot axis, and K2's that load per-slot
# template parameters or count per slot ("[K]": K4, K5 and K6 count a
# pool's as a partition block's); kernels C, D and H with either slot
# axis, and K11 with a tenant pool's; kernels B, E, F and G with either
# slot axis; K5's cron kind over a tenant pool's slot axis (K5c[K])
ENTRY_POINTS = ("unpack_packed", "expr_eval", "nfa_parallel", "nfa_scan",
                "window_step", "sort_window", "aggregate_step",
                "sliding_minmax", "distinct_count", "aggregate_emit",
                "join_probe", "join_grid", "table_write", "table_match",
                "table_probe", "table_buffer", "freq_window",
                "session_window", "order_by", "union_set",
                "partition_route", "partition_compact", "partition_due",
                "nfa_scan[K]", "window_step[K]", "aggregate_step[K]",
                "aggregate_emit[K]", "aggregation_step", "cron_window",
                "reorder_ring", "unpack_packed[K]", "expr_eval[K]",
                "nfa_parallel[K]", "join_probe[K]", "join_grid[K]",
                "sliding_minmax[K]", "distinct_count[K]", "union_set[K]",
                "aggregation_step[K]", "sort_window[K]", "freq_window[K]",
                "session_window[K]", "order_by[K]", "cron_window[K]")
LAUNCHES = {name: 0 for name in ENTRY_POINTS}


def count_launch(name: str) -> None:
    LAUNCHES[name] += 1


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# -- argument structs (csrc/siddhi_kernels.h) -------------------------------

MAX_LANES = 64
MAX_COLS = 32
MAX_OUTS = 32
MAX_CODE = 384
MAX_CONSTS = 48
MAX_STACK = 16


class LaneDesc(ctypes.Structure):
    _fields_ = [("offset", ctypes.c_int64), ("out", ctypes.c_void_p),
                ("code", ctypes.c_int32), ("out_type", ctypes.c_int32)]


class UnpackParams(ctypes.Structure):
    _fields_ = [("buf", ctypes.c_void_p), ("nulls", ctypes.c_void_p),
                ("kind", ctypes.c_void_p), ("valid", ctypes.c_void_p),
                ("capacity", ctypes.c_int32), ("n_lanes", ctypes.c_int32),
                ("lanes", LaneDesc * MAX_LANES),
                ("n_part", ctypes.c_int64), ("moves", ctypes.c_void_p),
                ("n_moves", ctypes.c_int64)]


NFA_MAX_SLOTS = 8
NFA_MAX_SLOT_COLS = 32
NFA_MAX_EV_COLS = 16
NFA_MAX_STATES = 8
NFA_MAX_PERSONAS = 2
NFA_MAX_MATCH_COLS = 64
NFA_MAX_ROWS = 16384


class ExprParams(ctypes.Structure):
    _fields_ = [("in_cols", ctypes.c_void_p * MAX_COLS),
                ("in_nulls", ctypes.c_void_p * MAX_COLS),
                ("out_cols", ctypes.c_void_p * MAX_OUTS),
                ("out_nulls", ctypes.c_void_p * MAX_OUTS),
                ("kind", ctypes.c_void_p), ("valid", ctypes.c_void_p),
                ("out_valid", ctypes.c_void_p), ("emitted", ctypes.c_void_p),
                ("consts", ctypes.c_int64 * MAX_CONSTS),
                ("code", ctypes.c_int32 * MAX_CODE),
                ("n_code", ctypes.c_int32), ("rows", ctypes.c_int32),
                ("timer_pass", ctypes.c_int32),
                ("gate_bits", ctypes.c_int32),
                ("now_input", ctypes.c_int32),
                ("tparam_mask", ctypes.c_uint32),
                ("slot_rows", ctypes.c_int32),
                ("emit_rows", ctypes.c_int32), ("pad_", ctypes.c_int32)]


_P = ctypes.c_void_p
_I32 = ctypes.c_int32


class NfaStateDesc(ctypes.Structure):
    _fields_ = [(f, _I32) for f in (
        "idx", "slot", "next_idx", "is_counting", "min_count", "max_count",
        "cap_limit", "prog_start", "prog_len", "n_personas")] + [
        ("persona_idx", _I32 * NFA_MAX_PERSONAS),
        ("persona_slot", _I32 * NFA_MAX_PERSONAS),
        ("persona_min", _I32 * NFA_MAX_PERSONAS)]


class NfaParams(ctypes.Structure):
    _fields_ = [(f, _P) for f in (
        "state", "valid", "ts0", "has_ts0", "born", "min_at", "deadline",
        "seq", "next_seq", "counter", "overflow")] + [
        ("tab_cols", _P * NFA_MAX_SLOT_COLS),
        ("tab_nulls", _P * NFA_MAX_SLOT_COLS),
        ("tab_ts", _P * NFA_MAX_SLOTS), ("tab_n", _P * NFA_MAX_SLOTS),
        ("p2_cols", _P * NFA_MAX_SLOT_COLS),
        ("p2_nulls", _P * NFA_MAX_SLOT_COLS),
        ("p2_ts", _P * NFA_MAX_SLOTS), ("p2_n", _P * NFA_MAX_SLOTS)] + [
        (f, _P) for f in (
            "p2_state", "p2_valid", "p2_last", "p2_born_rel", "p2_ts0",
            "p2_has_ts0", "p2_minrel", "p2_seq", "emit_at", "emit_n",
            "span", "ev_ts", "ev_kind", "ev_valid")] + [
        ("ev_cols", _P * NFA_MAX_EV_COLS),
        ("ev_nulls", _P * NFA_MAX_EV_COLS),
        ("out_cols", _P * NFA_MAX_MATCH_COLS),
        ("out_nulls", _P * NFA_MAX_MATCH_COLS),
        ("out_ts", _P), ("out_n", _P), ("out_valid", _P), ("out_kind", _P),
        ("code", _P), ("consts", _P), ("loads", _P),
        ("within_ms", ctypes.c_int64),
        ("states", NfaStateDesc * NFA_MAX_STATES),
        ("start", NfaStateDesc),
        ("slot_cap", _I32 * NFA_MAX_SLOTS),
        ("slot_col0", _I32 * NFA_MAX_SLOTS),
        ("slot_ncols", _I32 * NFA_MAX_SLOTS),
        ("slot_final_counting", _I32 * NFA_MAX_SLOTS),
        ("col_type", _I32 * NFA_MAX_SLOT_COLS),
        ("ev_type", _I32 * NFA_MAX_EV_COLS),
        ("out_type", _I32 * NFA_MAX_MATCH_COLS)] + [
        (f, _I32) for f in (
            "n_slots", "n_consuming", "has_start", "advance_pop2", "seqmode",
            "n_states", "M", "B", "OUT", "sub_off", "n_match_cols",
            "first_sub", "last_sub")] + [
        ("min0_mask", ctypes.c_uint32),
        ("n_part", ctypes.c_int64), ("moves", _P), ("n_moves", ctypes.c_int64)]


SCAN_MAX_ROWS = 256
SCAN_MAX_STATES = 16
SCAN_MAX_CONSUMING = 8
SCAN_MAX_ABSENT = 8
SCAN_MAX_PERSONAS = 4
SCAN_MAX_STARTS = 2
SCAN_MAX_GROUPS = 4

_I64 = ctypes.c_int64
_PERSONAS = [("n_personas", _I32),
             ("persona_idx", _I32 * SCAN_MAX_PERSONAS),
             ("persona_slot", _I32 * SCAN_MAX_PERSONAS),
             ("persona_min", _I32 * SCAN_MAX_PERSONAS)]


class ScanStateDesc(ctypes.Structure):
    _fields_ = [("waiting_ms", _I64), ("nxt_waiting_ms", _I64)] + [
        (f, _I32) for f in (
            "idx", "slot", "cap", "anchor", "anchor_next", "next_idx",
            "prog_start", "prog_len", "logical", "has_partner", "grp_final",
            "is_absent", "dl_field", "viol_latch", "viol_push",
            "is_counting", "min_count", "max_count", "nxt_dl_field",
            "p_slot", "p_is_absent", "p_waits", "p_dl_field",
            "p_viol_latch", "arm", "clear")] + _PERSONAS


class ScanAbsentDesc(ctypes.Structure):
    _fields_ = [("w_next", _I64), ("w2_next", _I64)] + [
        (f, _I32) for f in (
            "anchor", "anchor_next", "next_anchor", "dl_field",
            "has_partner", "logical", "p_is_absent", "p_slot", "arm",
            "clear")] + _PERSONAS


class ScanGroupDesc(ctypes.Structure):
    _fields_ = [(f, _I32) for f in ("anchor", "slot_l", "slot_r", "lane")]


class ScanStartDesc(ctypes.Structure):
    _fields_ = [(f, _I32) for f in (
        "idx", "slot", "next_idx", "nxt_anchor", "prog_start", "prog_len",
        "suppress", "is_counting", "min_count")]


class ScanPlan(ctypes.Structure):
    _fields_ = [
        ("within_ms", _I64),
        ("wait_of", _I64 * (SCAN_MAX_STATES + 1)),
        ("wait2_of", _I64 * (SCAN_MAX_STATES + 1)),
        ("arm_of", _I32 * (SCAN_MAX_STATES + 1)),
        ("clear_of", _I32 * (SCAN_MAX_STATES + 1)),
        ("cons", ScanStateDesc * SCAN_MAX_CONSUMING),
        ("absent", ScanAbsentDesc * SCAN_MAX_ABSENT),
        ("groups", ScanGroupDesc * SCAN_MAX_GROUPS),
        ("starts", ScanStartDesc * SCAN_MAX_STARTS),
        ("rearm_anchor", _I32 * SCAN_MAX_STATES),
        ("slot_cap", _I32 * NFA_MAX_SLOTS),
        ("slot_col0", _I32 * NFA_MAX_SLOTS),
        ("slot_ncols", _I32 * NFA_MAX_SLOTS),
        ("slot_ci0", _I32 * NFA_MAX_SLOTS),
        ("col_type", _I32 * NFA_MAX_SLOT_COLS)] + [
        (f, _I32) for f in (
            "n_slots", "n_states", "n_cons", "n_absent", "n_groups",
            "n_starts", "n_rearm", "M", "OUT", "n_match_cols", "seqmode",
            "has_absent", "any_every", "absent_rearms", "has_dl2",
            "or_double_absent")] + [("counting_mask", ctypes.c_uint32)]


class ScanArgs(ctypes.Structure):
    _fields_ = [(f, _P) for f in (
        "plan", "state", "valid", "ts0", "has_ts0", "born", "min_at",
        "deadline", "deadline2", "seq", "next_seq", "counter",
        "overflow")] + [
        ("tab_cols", _P * NFA_MAX_SLOT_COLS),
        ("tab_nulls", _P * NFA_MAX_SLOT_COLS),
        ("tab_ts", _P * NFA_MAX_SLOTS), ("tab_n", _P * NFA_MAX_SLOTS),
        ("stg_cols", _P * NFA_MAX_SLOT_COLS),
        ("stg_nulls", _P * NFA_MAX_SLOT_COLS),
        ("stg_ts", _P * NFA_MAX_SLOTS),
        ("ev_ts", _P), ("ev_kind", _P), ("ev_valid", _P),
        ("ev_cols", _P * NFA_MAX_EV_COLS),
        ("ev_nulls", _P * NFA_MAX_EV_COLS),
        ("now", _I64), ("n_events", _I32), ("rows", _I32),
        ("out_cols", _P * NFA_MAX_MATCH_COLS),
        ("out_nulls", _P * NFA_MAX_MATCH_COLS),
        ("out_type", _I32 * NFA_MAX_MATCH_COLS)] + [
        (f, _P) for f in ("out_ts", "out_n", "out_valid", "out_kind", "due",
                          "code", "consts", "loads")] + [
        (f, _I32) for f in ("n_code", "n_consts", "n_loads", "n_ev_cols")] + [
        ("ev_size", _I32 * NFA_MAX_EV_COLS), ("n_part", _I64),
        ("moves", _P), ("n_moves", _I64)]


WIN_MAX_COLS = 16


class WinBuf(ctypes.Structure):
    _fields_ = [("ts", _P), ("seq", _P), ("cols", _P * WIN_MAX_COLS),
                ("nulls", _P * WIN_MAX_COLS), ("valid", _P)]


class WindowArgs(ctypes.Structure):
    _fields_ = [("batch", WinBuf), ("batch_kind", _P), ("a", WinBuf),
                ("e", WinBuf), ("na", WinBuf), ("ne", WinBuf)] + [
        (f, _P) for f in (
            "next_seq", "overflow", "next_emit", "now", "o_next_seq",
            "o_overflow", "o_next_emit", "start", "flushed", "sched",
            "last_ext", "o_start", "o_flushed", "o_sched",
            "o_last_ext")] + [
        ("out", WinBuf), ("out_kind", _P)] + [
        (f, _P) for f in (
            "b_seq", "rt", "cur_rows", "scal", "keys", "k1", "k2", "i1",
            "i2", "order", "counts", "cand_src", "cand_ts", "cand_kind",
            "keep", "rank_pos", "rank_of", "pflag")] + [
        ("col_size", _I32 * WIN_MAX_COLS)] + [
        (f, _I32) for f in (
            "n_cols", "kind", "B", "W", "EB", "N", "P", "S",
            "expired_enabled", "stream_current", "has_start", "ts_idx",
            "start_attr", "has_timeout", "replace_ts")] + [
        (f, _I64) for f in ("length", "span_ms", "start_time", "timeout_ms",
                            "hop_ms", "n_part")] + [
        ("moves", _P), ("n_moves", _I64)]


SORT_MAX_KEYS = 8


class SortArgs(ctypes.Structure):
    _fields_ = [("batch", WinBuf), ("batch_kind", _P), ("a", WinBuf),
                ("na", WinBuf), ("ev", WinBuf)] + [
        (f, _P) for f in ("next_seq", "now", "o_next_seq")] + [
        ("out", WinBuf), ("out_kind", _P), ("mask", _P), ("pos", _P),
        ("rows", _P), ("col_size", _I32 * WIN_MAX_COLS)] + [
        (f, _I32) for f in ("n_cols", "B", "W", "L", "expired_enabled",
                            "n_keys")] + [
        ("key_col", _I32 * SORT_MAX_KEYS), ("key_desc", _I32 * SORT_MAX_KEYS),
        ("key_type", _I32 * SORT_MAX_KEYS), ("n_part", _I64),
        ("moves", _P), ("n_moves", _I64)]


class FreqArgs(ctypes.Structure):
    _fields_ = [("batch", WinBuf), ("batch_kind", _P), ("a", WinBuf),
                ("na", WinBuf)] + [
        (f, _P) for f in (
            "keys", "counts", "buckets", "o_keys", "o_counts", "o_buckets",
            "next_seq", "total", "overflow", "o_next_seq", "o_total",
            "o_overflow", "now")] + [
        ("out", WinBuf), ("out_kind", _P)] + [
        (f, _P) for f in ("hk", "dmask", "vbefore", "cbefore", "scal")] + [
        ("col_size", _I32 * WIN_MAX_COLS), ("key_col", _I32 * WIN_MAX_COLS),
        ("key_type", _I32 * WIN_MAX_COLS)] + [
        (f, _I32) for f in ("n_cols", "n_keys", "B", "N", "lossy",
                            "expired_enabled")] + [
        ("width", _I64), ("thresh", ctypes.c_double), ("n_part", _I64),
        ("moves", _P), ("n_moves", _I64)]


class SessArgs(ctypes.Structure):
    _fields_ = [("batch", WinBuf), ("batch_kind", _P), ("buf", WinBuf),
                ("nbuf", WinBuf)] + [
        (f, _P) for f in (
            "keys", "used", "count", "end", "open", "next_seq", "overflow",
            "o_keys", "o_used", "o_count", "o_end", "o_open", "o_next_seq",
            "o_overflow")] + [
        ("out", WinBuf), ("out_kind", _P)] + [
        (f, _P) for f in (
            "hk", "cur", "slots", "prb", "flags", "claim", "rt", "order",
            "s_a", "s_b", "s_c", "s_f", "r_close_ts", "r_close_row", "r_pos",
            "r_flags", "sl_close_row", "sl_flags", "ekey", "eorder", "k1",
            "k2", "i1", "i2", "counts", "scal", "rkey", "rk1", "rk2", "ri1",
            "ri2", "rcounts")] + [
        ("col_size", _I32 * WIN_MAX_COLS)] + [
        (f, _I32) for f in ("n_cols", "B", "K", "S", "M", "has_key",
                            "key_col", "key_type", "expired_enabled",
                            "pad_")] + [
        ("gap", _I64), ("n_part", _I64), ("moves", _P), ("n_moves", _I64)]


ORDER_MAX_COLS = 32
ORDER_MAX_KEYS = 8
# G[K] sorts a slot's rows in its block's shared memory up to this many
# (csrc/order_by.cu; 12 bytes a row of a power-of-two size); past it,
# in global memory. The one place this is decided: the kernel takes the
# global branch exactly when OrderArgs.k1 is given.
ORDER_SHARED_ROWS = 16384


class OrderArgs(ctypes.Structure):
    _fields_ = [(f, _I32) for f in ("B", "n_cols", "n_keys", "pad_")] + [
        ("offset", _I64), ("limit", _I64),
        ("ts", _P), ("kind", _P), ("valid", _P),
        ("cols", _P * ORDER_MAX_COLS), ("nulls", _P * ORDER_MAX_COLS),
        ("col_size", _I32 * ORDER_MAX_COLS),
        ("key_col", _I32 * ORDER_MAX_KEYS),
        ("key_type", _I32 * ORDER_MAX_KEYS),
        ("key_desc", _I32 * ORDER_MAX_KEYS),
        ("out_ts", _P), ("out_kind", _P), ("out_valid", _P),
        ("out_cols", _P * ORDER_MAX_COLS), ("out_nulls", _P * ORDER_MAX_COLS),
        ("emitted", _P)] + [
        (f, _P) for f in ("k1", "k2", "i1", "i2", "counts", "rank",
                          "sums")] + [
        ("K", _I32), ("pad2_", _I32),
        ("ts_stride", _I64), ("kind_stride", _I64), ("valid_stride", _I64),
        ("col_stride", _I64 * ORDER_MAX_COLS),
        ("null_stride", _I64 * ORDER_MAX_COLS), ("emitted_stride", _I64)]


AGG_MAX_KEYS = 8
AGG_MAX_SPECS = 16
AGG_MAX_LANES = 48
AGG_MAX_LEVELS = 40
AGG_MAX_OUTS = 32


class AggArgs(ctypes.Structure):
    _fields_ = [(f, _I32) for f in (
        "B", "K", "grouped", "n_keys", "n_specs", "n_lanes")] + [
        ("kind", _P), ("valid", _P),
        ("key_cols", _P * AGG_MAX_KEYS), ("key_nulls", _P * AGG_MAX_KEYS),
        ("key_type", _I32 * AGG_MAX_KEYS),
        ("spec_kind", _I32 * AGG_MAX_SPECS),
        ("spec_flag", _I32 * AGG_MAX_SPECS),
        ("spec_lane0", _I32 * AGG_MAX_SPECS),
        ("arg_type", _I32 * AGG_MAX_SPECS),
        ("arg_cols", _P * AGG_MAX_SPECS), ("arg_nulls", _P * AGG_MAX_SPECS),
        ("out_type", _I32 * AGG_MAX_SPECS),
        ("out_vals", _P * AGG_MAX_SPECS), ("out_nulls", _P * AGG_MAX_SPECS),
        ("lane_op", _I32 * AGG_MAX_LANES),
        ("lane_type", _I32 * AGG_MAX_LANES),
        ("lane_spec", _I32 * AGG_MAX_LANES),
        ("carry", _P * AGG_MAX_LANES), ("new_carry", _P * AGG_MAX_LANES),
        ("run", _P * AGG_MAX_LANES)] + [
        (f, _P) for f in (
            "keys", "used", "overflow", "new_keys", "new_used",
            "new_overflow", "slots", "hk", "probe", "flags", "claim",
            "reset_seg", "scal", "skeys", "k1", "k2", "i1", "i2", "counts",
            "perm", "inv_perm", "seg_sorted", "seg_start", "slot_first",
            "slot_last", "tree", "tree_seg", "res")] + [
        ("level_off", _I64 * AGG_MAX_LEVELS),
        ("level_n", _I64 * AGG_MAX_LEVELS), ("n_levels", _I32),
        ("spec_contrib", _P * AGG_MAX_SPECS), ("n_part", _I64),
        ("moves", _P), ("n_moves", _I64)]


class StatArgs(ctypes.Structure):
    _fields_ = [(f, _I32) for f in ("spec", "W", "D")] + [
        ("arg", _P), ("arg_null", _P), ("arg_type", _I32), ("pad_", _I32)] + [
        (f, _P) for f in (
            "ring", "heads", "tails", "new_ring", "new_heads", "new_tails",
            "tree", "keys", "used", "counts", "new_keys", "new_used",
            "new_counts", "overflow", "new_overflow", "r0", "r1", "r2", "r3",
            "i0", "i1", "flags", "claim", "pkeys", "perm2", "seg2", "ksum",
            "count")] + [("n_part", _I64), ("moves", _P), ("n_moves", _I64)]


class EmitArgs(ctypes.Structure):
    _fields_ = [(f, _I32) for f in ("B", "K", "batch_mode", "n_cols",
                                    "keep_order", "pad_")] + [
        ("offset", _I64), ("limit", _I64)] + [
        (f, _P) for f in ("slots", "qual", "ts", "kind", "valid")] + [
        ("cols", _P * AGG_MAX_OUTS), ("nulls", _P * AGG_MAX_OUTS),
        ("col_size", _I32 * AGG_MAX_OUTS),
        ("out_ts", _P), ("out_kind", _P), ("out_valid", _P),
        ("out_cols", _P * AGG_MAX_OUTS), ("out_nulls", _P * AGG_MAX_OUTS)] + [
        (f, _P) for f in (
            "emitted", "ovalid", "emit_order", "pos", "flag", "qkeys", "k1",
            "k2", "i1", "i2", "perm2", "counts", "chunk", "gstart", "scal")] + [
        ("n_part", _I64), ("moves", _P), ("n_moves", _I64)]


JOIN_MAX_COLS = 16
JOIN_MAX_OUT = 32
TABLE_MAX_PK = 8


class PairProg(ctypes.Structure):
    _fields_ = [("code", _P), ("consts", _P), ("ins", _P),
                ("n_code", _I32), ("pad_", _I32)]


class SideCols(ctypes.Structure):
    _fields_ = [("ts", _P), ("kind", _P), ("valid", _P),
                ("cols", _P * JOIN_MAX_COLS), ("nulls", _P * JOIN_MAX_COLS),
                ("col_size", _I32 * JOIN_MAX_COLS),
                ("n_cols", _I32), ("pad_", _I32)]


class KeySortScratch(ctypes.Structure):
    _fields_ = [(f, _P) for f in ("k1", "k2", "i1", "i2", "keys", "pad",
                                  "order", "sk", "n_live", "counts")]


class UnionArgs(ctypes.Structure):
    _fields_ = [("B", _I32), ("pad_", _I32), ("n", _I64)] + [
        (f, _P) for f in ("arg", "arg_null", "vals", "counts", "tag",
                          "overflow", "new_vals", "new_counts", "new_tag",
                          "new_overflow", "out", "out_null")] + [
        (f, _P) for f in ("keep", "rank", "sums", "kept", "n_kept")] + [
        ("sort", KeySortScratch)] + [
        (f, _P) for f in ("sgn", "total", "csum", "live", "lrank",
                          "msums")] + [
        ("n_part", _I64), ("moves", _P), ("n_moves", _I64)]


class JoinArgs(ctypes.Structure):
    _fields_ = [("trig", SideCols), ("opp", SideCols),
                ("cond", PairProg), ("tkey", PairProg), ("okey", PairProg),
                ("resid", PairProg)] + [
        (f, _I32) for f in ("probe", "outer", "need_resid", "gate",
                            "key_type", "levels")] + [
        ("big", _I64), ("win_ms", _I64)] + [
        (f, _I32) for f in ("B", "W", "CAP", "CAND", "n_out")] + [
        ("out_from_trig", _I32 * JOIN_MAX_OUT),
        ("out_col", _I32 * JOIN_MAX_OUT), ("out_size", _I32 * JOIN_MAX_OUT),
        ("out_ts", _P), ("out_kind", _P), ("out_valid", _P),
        ("out_cols", _P * JOIN_MAX_OUT), ("out_nulls", _P * JOIN_MAX_OUT),
        ("lost", _P), ("sort", KeySortScratch)] + [
        (f, _P) for f in ("trig_keys", "act", "lo", "cnt", "coffs", "coi", "s",
                          "S", "surv", "soffs", "tot", "offs", "lead", "ti",
                          "oi", "is_pair", "psum")] + [
        ("n_part", _I64), ("moves", _P), ("n_moves", _I64)]


class TableBuf(ctypes.Structure):
    _fields_ = [("cols", _P * JOIN_MAX_COLS), ("nulls", _P * JOIN_MAX_COLS)]\
        + [(f, _P) for f in ("ts", "seq", "valid", "next_seq", "overflow")]


class TableArgs(ctypes.Structure):
    _fields_ = [("t", TableBuf), ("o", TableBuf), ("ev", SideCols),
                ("col_size", _I32 * JOIN_MAX_COLS),
                ("col_type", _I32 * JOIN_MAX_COLS)] + [
        (f, _I32) for f in ("n_cols", "T", "B", "n_pk")] + [
        ("pk", _I32 * TABLE_MAX_PK), ("mask", _P),
        ("cond", PairProg), ("sets", PairProg)] + [
        (f, _I32) for f in ("has_cond", "mode", "n_sets")] + [
        ("set_col", _I32 * JOIN_MAX_COLS)] + [
        (f, _I32) for f in ("attr", "key_type", "op", "levels")] + [
        ("big", _I64), ("touched", _P), ("any_hit", _P), ("delta", _P),
        ("sort", KeySortScratch)] + [
        (f, _P) for f in ("hk", "tk", "hit", "win", "rank", "free_pos",
                          "scal", "adding")]


# -- build -------------------------------------------------------------------

PART_MAX_LABELS = 16
PART_MAX_COLS = 32
PART_MAX_QUERIES = 32


class RouteArgs(ctypes.Structure):
    _fields_ = [(f, _I32) for f in ("B", "K", "mode", "n_conds")] + [
        ("kind", _P), ("valid", _P), ("key_col", _P), ("key_null", _P),
        ("key_type", _I32), ("pad_", _I32),
        ("cond_vals", _P * PART_MAX_LABELS),
        ("cond_nulls", _P * PART_MAX_LABELS),
        ("cond_slot", _I32 * PART_MAX_LABELS)] + [
        (f, _P) for f in ("keys", "used", "overflow", "new_keys", "new_used",
                          "new_overflow", "slots", "valid_k", "hk", "active",
                          "prb", "flags", "claim")]


class CompactArgs(ctypes.Structure):
    _fields_ = [(f, _I32) for f in ("n", "out_cap", "n_cols", "pad_")] + [
        ("ts", _P), ("kind", _P), ("valid", _P),
        ("cols", _P * PART_MAX_COLS), ("nulls", _P * PART_MAX_COLS),
        ("col_size", _I32 * PART_MAX_COLS),
        ("out_ts", _P), ("out_kind", _P), ("out_valid", _P),
        ("out_cols", _P * PART_MAX_COLS), ("out_nulls", _P * PART_MAX_COLS),
        ("emitted", _P), ("lost", _P)] + [
        (f, _P) for f in ("vpref", "sums", "k0", "k1", "k2", "i0", "i1",
                          "i2", "inv_idx", "counts")]


class DueArgs(ctypes.Structure):
    _fields_ = [("n_q", _I32), ("pad_", _I32),
                ("dues", _P * PART_MAX_QUERIES),
                ("n", _I64 * PART_MAX_QUERIES), ("out", _P)]


AGGR_MAX_DUR = 6
AGGR_MAX_GROUPS = 8
AGGR_MAX_LANES = 40


class AggrArgs(ctypes.Structure):
    _fields_ = [(f, _I32) for f in ("B", "K", "D", "n_groups",
                                    "n_lanes")] + [
        ("dur", _I32 * AGGR_MAX_DUR),
        ("ets", _P), ("kind", _P), ("valid", _P),
        ("gcol", _P * AGGR_MAX_GROUPS), ("gnull", _P * AGGR_MAX_GROUPS),
        ("gtype", _I32 * AGGR_MAX_GROUPS), ("gsize", _I32 * AGGR_MAX_GROUPS),
        ("arg", _P * AGGR_MAX_LANES), ("arg_null", _P * AGGR_MAX_LANES),
        ("arg_type", _I32 * AGGR_MAX_LANES),
        ("lane_kind", _I32 * AGGR_MAX_LANES),
        ("lane_f64", _I32 * AGGR_MAX_LANES),
        ("keys", _P), ("used", _P), ("bstart", _P), ("overflow", _P),
        ("groups", _P * AGGR_MAX_GROUPS), ("gnulls", _P * AGGR_MAX_GROUPS),
        ("lanes", _P * AGGR_MAX_LANES),
        ("new_keys", _P), ("new_used", _P), ("new_bstart", _P),
        ("new_overflow", _P),
        ("new_groups", _P * AGGR_MAX_GROUPS),
        ("new_gnulls", _P * AGGR_MAX_GROUPS),
        ("new_lanes", _P * AGGR_MAX_LANES)] + [
        (f, _P) for f in ("bs", "hk", "active", "slot", "prb", "flags",
                          "claim", "skey", "perm", "k1", "k2", "i1", "i2",
                          "counts")] + [
        ("n_part", _I64), ("moves", _P), ("n_moves", _I64)]


RING_MAX_COLS = 16


class RingArgs(ctypes.Structure):
    _fields_ = [(f, _I32) for f in ("C", "n_cols", "count", "n_in")] + [
        ("wm", _I64)] + [
        (f, _I32) for f in ("min_rel", "final_", "levels", "pad_")] + [
        ("sts", _P), ("scols", _P * RING_MAX_COLS),
        ("in_ts", _P), ("in_cols", _P * RING_MAX_COLS),
        ("col_size", _I32 * RING_MAX_COLS),
        ("new_ts", _P), ("new_cols", _P * RING_MAX_COLS),
        ("rel_ts", _P), ("rel_cols", _P * RING_MAX_COLS),
        ("rel_nulls", _P * RING_MAX_COLS), ("rel_kind", _P),
        ("rel_valid", _P), ("meta", _P), ("sort", KeySortScratch)] + [
        (f, _P) for f in ("rank", "keep", "kpre", "sums")]


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").exists():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "siddhi_tpu_torch need the CUDA toolkit")
    return found


def _digest(src: Path) -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.h")) + sorted(CSRC.glob("*.cuh")) + [src]:
        h.update(p.read_bytes())
    h.update(ARCH.encode())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> dict:
    """Compile every kernel source that is not built yet, all ``nvcc``
    processes at once. -> {kernel: path of its shared library}."""
    BUILD.mkdir(parents=True, exist_ok=True)
    libs, procs = {}, []
    for name, src in SOURCES.items():
        path = CSRC / src
        lib = BUILD / f"lib{name}_{_digest(path)}.so"
        libs[name] = lib
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), ARCH, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-I", str(CSRC), "-o", str(tmp),
               str(path)]
        if verbose:
            cmd.insert(1, "-Xptxas=-v")
        procs.append((name, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    errors = []
    for name, lib, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{name}: nvcc exit {proc.returncode}\n{out}")
            continue
        if verbose and out:
            print(out.rstrip())
        os.replace(tmp, lib)
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return libs


class _Kernels:
    def __init__(self, libs: dict):
        self.unpack_lib = ctypes.CDLL(str(libs["unpack_packed"]))
        self.unpack_lib.siddhi_unpack_packed.argtypes = [
            ctypes.POINTER(UnpackParams), ctypes.c_void_p]
        self.unpack_lib.siddhi_unpack_packed.restype = ctypes.c_int
        self.expr_lib = ctypes.CDLL(str(libs["expr_eval"]))
        self.expr_lib.siddhi_expr_eval.argtypes = [
            ctypes.POINTER(ExprParams), ctypes.c_void_p]
        self.expr_lib.siddhi_expr_eval.restype = ctypes.c_int
        self.nfa_lib = ctypes.CDLL(str(libs["nfa_parallel"]))
        self.nfa_lib.siddhi_nfa_parallel_step.argtypes = [
            ctypes.POINTER(NfaParams), ctypes.c_void_p]
        self.nfa_lib.siddhi_nfa_parallel_step.restype = ctypes.c_int
        self.scan_lib = ctypes.CDLL(str(libs["nfa_scan"]))
        self.scan_lib.siddhi_nfa_scan.argtypes = [
            ctypes.POINTER(ScanArgs), ctypes.c_void_p]
        self.scan_lib.siddhi_nfa_scan.restype = ctypes.c_int
        self.win_lib = ctypes.CDLL(str(libs["window_step"]))
        self.win_lib.siddhi_window_step.argtypes = [
            ctypes.POINTER(WindowArgs), ctypes.c_void_p]
        self.win_lib.siddhi_window_step.restype = ctypes.c_int
        self.seq_lib = ctypes.CDLL(str(libs["window_seq"]))
        self.seq_lib.siddhi_sort_window.argtypes = [
            ctypes.POINTER(SortArgs), ctypes.c_void_p]
        self.seq_lib.siddhi_sort_window.restype = ctypes.c_int
        self.seq_lib.siddhi_freq_window.argtypes = [
            ctypes.POINTER(FreqArgs), ctypes.c_void_p]
        self.seq_lib.siddhi_freq_window.restype = ctypes.c_int
        self.sess_lib = ctypes.CDLL(str(libs["session_step"]))
        self.sess_lib.siddhi_session_window.argtypes = [
            ctypes.POINTER(SessArgs), ctypes.c_void_p]
        self.sess_lib.siddhi_session_window.restype = ctypes.c_int
        self.order_lib = ctypes.CDLL(str(libs["order_by"]))
        self.order_lib.siddhi_order_by.argtypes = [
            ctypes.POINTER(OrderArgs), ctypes.c_void_p]
        self.order_lib.siddhi_order_by.restype = ctypes.c_int
        self.agg_lib = ctypes.CDLL(str(libs["aggregate_step"]))
        self.agg_lib.siddhi_aggregate_step.argtypes = [
            ctypes.POINTER(AggArgs), ctypes.c_void_p, ctypes.c_int32]
        self.agg_lib.siddhi_aggregate_emit.argtypes = [
            ctypes.POINTER(EmitArgs), ctypes.c_void_p]
        for fn in ("siddhi_sliding_minmax", "siddhi_distinct_count"):
            getattr(self.agg_lib, fn).argtypes = [
                ctypes.POINTER(AggArgs), ctypes.POINTER(StatArgs),
                ctypes.c_void_p]
        for fn in ("siddhi_aggregate_step", "siddhi_aggregate_emit",
                   "siddhi_sliding_minmax", "siddhi_distinct_count"):
            getattr(self.agg_lib, fn).restype = ctypes.c_int

        self.join_lib = ctypes.CDLL(str(libs["join_cross"]))
        for fn in ("siddhi_join_probe", "siddhi_join_grid"):
            getattr(self.join_lib, fn).argtypes = [
                ctypes.POINTER(JoinArgs), ctypes.c_void_p]
            getattr(self.join_lib, fn).restype = ctypes.c_int
        self.union_lib = ctypes.CDLL(str(libs["union_set"]))
        self.union_lib.siddhi_union_count.argtypes = [
            ctypes.POINTER(AggArgs), ctypes.POINTER(UnionArgs),
            ctypes.c_void_p]
        self.union_lib.siddhi_union_finish.argtypes = [
            ctypes.POINTER(AggArgs), ctypes.POINTER(UnionArgs),
            ctypes.c_int64, ctypes.c_void_p]
        for fn in ("siddhi_union_count", "siddhi_union_finish"):
            getattr(self.union_lib, fn).restype = ctypes.c_int
        self.part_lib = ctypes.CDLL(str(libs["partition"]))
        for fn, st in (("siddhi_partition_route", RouteArgs),
                       ("siddhi_partition_compact", CompactArgs),
                       ("siddhi_partition_due", DueArgs)):
            getattr(self.part_lib, fn).argtypes = [ctypes.POINTER(st),
                                                   ctypes.c_void_p]
            getattr(self.part_lib, fn).restype = ctypes.c_int
        self.aggr_lib = ctypes.CDLL(str(libs["aggregation_step"]))
        self.aggr_lib.siddhi_aggregation_step.argtypes = [
            ctypes.POINTER(AggrArgs), ctypes.c_void_p]
        self.aggr_lib.siddhi_aggregation_step.restype = ctypes.c_int
        self.ring_lib = ctypes.CDLL(str(libs["reorder_ring"]))
        self.ring_lib.siddhi_reorder_ring.argtypes = [
            ctypes.POINTER(RingArgs), ctypes.c_void_p]
        self.ring_lib.siddhi_reorder_ring.restype = ctypes.c_int
        self.table_lib = ctypes.CDLL(str(libs["table_step"]))
        for fn in ("siddhi_table_write", "siddhi_table_match",
                   "siddhi_table_probe", "siddhi_table_buffer"):
            getattr(self.table_lib, fn).argtypes = [
                ctypes.POINTER(TableArgs), ctypes.c_void_p]
            getattr(self.table_lib, fn).restype = ctypes.c_int

    @staticmethod
    def _check(name: str, err: int) -> None:
        if err != 0:
            raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")

    def unpack_packed(self, params: UnpackParams, stream: int) -> None:
        self._check("unpack_packed", self.unpack_lib.siddhi_unpack_packed(
            ctypes.byref(params), stream))

    def expr_eval(self, params: ExprParams, stream: int) -> None:
        self._check("expr_eval", self.expr_lib.siddhi_expr_eval(
            ctypes.byref(params), stream))

    def nfa_parallel_step(self, params: NfaParams, stream: int) -> None:
        self._check("nfa_parallel", self.nfa_lib.siddhi_nfa_parallel_step(
            ctypes.byref(params), stream))

    def nfa_scan(self, args: ScanArgs, stream: int) -> None:
        self._check("nfa_scan", self.scan_lib.siddhi_nfa_scan(
            ctypes.byref(args), stream))

    def window_step(self, args: WindowArgs, stream: int) -> None:
        self._check("window_step", self.win_lib.siddhi_window_step(
            ctypes.byref(args), stream))

    def sort_window(self, args: SortArgs, stream: int) -> None:
        self._check("sort_window", self.seq_lib.siddhi_sort_window(
            ctypes.byref(args), stream))

    def freq_window(self, args: FreqArgs, stream: int) -> None:
        self._check("freq_window", self.seq_lib.siddhi_freq_window(
            ctypes.byref(args), stream))

    def session_window(self, args: SessArgs, stream: int) -> None:
        self._check("session_window", self.sess_lib.siddhi_session_window(
            ctypes.byref(args), stream))

    def order_by(self, args: OrderArgs, stream: int) -> None:
        self._check("order_by", self.order_lib.siddhi_order_by(
            ctypes.byref(args), stream))

    def aggregate_step(self, args: AggArgs, stream: int,
                       part: int = 3) -> None:
        self._check("aggregate_step", self.agg_lib.siddhi_aggregate_step(
            ctypes.byref(args), stream, part))

    def sliding_minmax(self, args: AggArgs, st: StatArgs,
                       stream: int) -> None:
        self._check("sliding_minmax", self.agg_lib.siddhi_sliding_minmax(
            ctypes.byref(args), ctypes.byref(st), stream))

    def distinct_count(self, args: AggArgs, st: StatArgs,
                       stream: int) -> None:
        self._check("distinct_count", self.agg_lib.siddhi_distinct_count(
            ctypes.byref(args), ctypes.byref(st), stream))

    def union_set(self, args: AggArgs, ua: "UnionArgs", stream: int) -> None:
        """Kernel H: every slot's kept pairs counted (the step's one host
        sync), the compacted arrays sized by the largest count
        (``ua.compacted``, ops/aggregators.py union_args), then the
        union."""
        self._check("union_set", self.union_lib.siddhi_union_count(
            ctypes.byref(args), ctypes.byref(ua), stream))
        m = ua.compacted()
        self._check("union_set", self.union_lib.siddhi_union_finish(
            ctypes.byref(args), ctypes.byref(ua), m, stream))

    def aggregate_emit(self, args: EmitArgs, stream: int) -> None:
        self._check("aggregate_emit", self.agg_lib.siddhi_aggregate_emit(
            ctypes.byref(args), stream))

    def join_probe(self, args: JoinArgs, stream: int) -> None:
        self._check("join_probe", self.join_lib.siddhi_join_probe(
            ctypes.byref(args), stream))

    def join_grid(self, args: JoinArgs, stream: int) -> None:
        self._check("join_grid", self.join_lib.siddhi_join_grid(
            ctypes.byref(args), stream))

    def table_write(self, args: TableArgs, stream: int) -> None:
        self._check("table_write", self.table_lib.siddhi_table_write(
            ctypes.byref(args), stream))

    def table_match(self, args: TableArgs, stream: int) -> None:
        self._check("table_match", self.table_lib.siddhi_table_match(
            ctypes.byref(args), stream))

    def table_probe(self, args: TableArgs, stream: int) -> None:
        self._check("table_probe", self.table_lib.siddhi_table_probe(
            ctypes.byref(args), stream))

    def table_buffer(self, args: TableArgs, stream: int) -> None:
        self._check("table_buffer", self.table_lib.siddhi_table_buffer(
            ctypes.byref(args), stream))

    def partition_route(self, args: RouteArgs, stream: int) -> None:
        self._check("partition_route", self.part_lib.siddhi_partition_route(
            ctypes.byref(args), stream))

    def partition_compact(self, args: CompactArgs, stream: int) -> None:
        self._check("partition_compact",
                    self.part_lib.siddhi_partition_compact(
                        ctypes.byref(args), stream))

    def partition_due(self, args: DueArgs, stream: int) -> None:
        self._check("partition_due", self.part_lib.siddhi_partition_due(
            ctypes.byref(args), stream))


    def aggregation_step(self, args: AggrArgs, stream: int) -> None:
        self._check("aggregation_step", self.aggr_lib.siddhi_aggregation_step(
            ctypes.byref(args), stream))

    def reorder_ring(self, args: RingArgs, stream: int) -> None:
        self._check("reorder_ring", self.ring_lib.siddhi_reorder_ring(
            ctypes.byref(args), stream))


_LOADED = None
_LOCK = threading.Lock()


def load(verbose: bool = False) -> _Kernels:
    """The built kernels (built on first call)."""
    global _LOADED
    with _LOCK:
        if _LOADED is None:
            _LOADED = _Kernels(build(verbose=verbose))
        return _LOADED
