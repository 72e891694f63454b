#!/usr/bin/env python3
"""Smoke run of siddhi_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, each of which stops the run with a non-zero exit on failure:

1. device: CUDA must be there; prints the device, the build and
   ``nvidia-smi``'s name and power limit;
2. build the port's CUDA kernels from csrc/ (fifteen sources, one nvcc
   each, all at once) and hold kernel K1 (packed-ingest decode) against its plain
   PyTorch version on the card, bit for bit, for every lane code at
   capacities 16, 1024, 65536;
3. hold kernel K2 (expression evaluation) against its plain version on
   the card, bit for bit, over random columns with nulls and trap
   values, for every opcode and the repaired constant-folding cases,
   and every built-in function of checks.function_cases (the
   math-library functions within 2 ulp);
4. run the filter bench app through SiddhiManager/send_arrays on the
   card: 1,048,576 events in 16 sends of 65,536 rows, checked against a
   numpy oracle in count and order; the launch counters must show that
   K1 and K2 ran on that path; then time each kernel per chunk;
5. hold kernel K3 (the round-parallel NFA step) against its plain
   version on the card, bit for bit (the whole pending table and the
   match batch after one step): seq5 at a 65,536-row chunk from a table
   that holds live rows, two-stream counting chains (armed once,
   minimum 0, always armed, a final counting state), a sequence-mode
   chain, single-state patterns, a feed that overflows the table and one
   that overflows the match batch;
6. run seq5, the north-star pattern app, through SiddhiManager,
   send_arrays and batch_callbacks: 1,048,576 events in 16 sends of
   65,536 rows of the reference bench's feed, checked against an
   independent numpy oracle in count, order and values, with no
   overflow and no lost match; the launch counters must show K1, K3 on
   every sub-batch, and K2 on that path; then events/s, per-chunk
   latency at 65,536 and 1,024 rows, and K3's time against its plain
   version and its byte bound;
7. hold kernel K4 (the scan NFA engine's stream and timer steps)
   against its plain version on the card, bit for bit (the whole table,
   the match batch, overflow and next_due after a stream step and after
   a timer step at a due), each from a live table: absent_timeout at
   2,048 events, the scan shapes of checks.SCAN_APPS (an every-scoped
   absent, AND and OR groups, an OR of two absent lanes, a sequence
   with stabilize kills, a self-referring counting state, a `within`
   re-arm), a feed that overflows the 128-row table and one that
   overflows the 256-row match batch;
8. run absent_timeout (a request unanswered within 100 ms alerts)
   through SiddhiManager, send_arrays and batch_callbacks: 1,048,576
   events in 1,024 sends of 1,024 rows, checked against an independent
   numpy oracle in count, order and values, with overflow 0 and no
   step above 256 matches; the launch counters must show K1 on every
   send, K4 on every send and every timer step the scheduler fired, K2
   on every step; then events/s, per-send latency, K4's time against
   its plain version and its byte bound, and a torch.profiler split;
9. hold kernels K5 (the window step) and K6 (the aggregate step and
   emission) against their plain versions on the card, bit for bit, at
   every step of each comparison app of checks.WINDOW_APPS (every
   window kind and aggregator kind, having, offset and limit), a
   RESET-heavy feed, a time window over its capacity, more keys than
   the 1,024-slot group table, both main configurations at 65,536-row
   sends, and (K6) the two special-value feeds of its repaired NaN and
   zero lanes;
10. and 11. run window_agg (bench.py's lengthBatch(1000) app, verbatim)
   and window_time_grouped (a one-minute sliding window grouped by 512
   symbols) through SiddhiManager, send_arrays and batch_callbacks:
   1,048,576 events in 16 sends of 65,536 rows each, checked against
   independent numpy oracles (exact columns exact, averages within
   1e-12 relative); the launch counters must show K1 on every send and
   K5 and K6 on every step; then events/s, per-send latency at 65,536
   and 1,024 rows, a torch.profiler split, and K5's and K6's time per
   step against their plain versions, their byte bounds and (K5)
   torch.sort of the same emission keys;
12. hold kernels K7 (join_probe, join_grid) and K8 (table_write,
   table_match, table_probe, table_buffer) against their plain versions
   on the card, bit for bit, at every launch: each app of
   checks.JOIN_APPS under both K7 entry points (every join type,
   unidirectional, windowless sides, residual and non-equi ON, the
   float-key traps, null keys, JOIN_CAP and candidate overflow), each app
   of checks.TABLE_APPS (inserts, deletes through the condition pass and
   an index, updates with and without SET, update or insert, primary-key
   duplicates, IN-table filters, a table past its capacity), and the main
   configurations at 8,192-row sends from live states;
13. to 15. run bench.py's join app (`join`, 1,024 symbols; `join_eq`,
   8,192) through SiddhiManager, send_arrays and batch_callbacks:
   1,048,576 events in 64 sends of 8,192 rows a side, checked against
   the numpy oracle with 0 pairs lost; the launch counters must show K1
   on every send and K5, K7 and K2 on every side step; then events/s,
   per-send latency at 8,192 and 1,024 rows, a torch.profiler split and
   K7's time against its plain version, its byte bound and torch.sort +
   torch.searchsorted; and `join` pinned to the grid over its first 16
   sends a side, whose rows must equal the probe run's;
16. run stock_table (a primary-keyed table kept by an update-or-insert
   query and read by a stream-table join): a load of 8,000 symbols and
   64 rounds of 8,192-row upsert and lookup sends, checked against its
   numpy oracle with 0 pairs lost and 0 table overflow; the launch
   counters must show K1, K8's condition pass and write, K8's view, K5,
   K7 and K2 on every step of theirs; then events/s, latency, a profiler
   split and K8's time against its plain version, its byte bound and
   torch.argsort of the seq keys;
17. hold kernels A (K5's second-wave kinds), B (the sort window), C
   (min/max over expiring content) and D (distinctCount) against their
   plain versions on the card, bit for bit, state and output, at every
   step of each app of checks.WINDOW2_APPS (every new window kind with
   its parameters, TIMER flushes included; sort on int, long, float and
   double keys, asc and desc; min/max and distinctCount over time,
   length, externalTime and batch windows) on a feed with NaN, +-0.0,
   infinities and the integer extremes, a key past its ring, more pairs
   than the pair table, nulls, a join side on an externalTime window,
   and the three apps below at their own send sizes, overflow 0;
18. to 20. run window_ext_grouped (externalTime, 1 min, min/max/avg per
   ticker; 64 sends of 16,384 rows), window_ext_bars (externalTimeBatch
   bars and distinctCount breadth; 16 sends of 65,536) and window_sort
   (sort(1000); 4 sends of 65,536) through SiddhiManager, send_arrays
   and batch_callbacks, each against its numpy oracle with overflow 0;
   the launch counters must show K1 and the path's kernels on every
   step; then events/s, latency at the path's send size and at 1,024
   rows (overflow still 0) and each new kernel's time against its plain version and its bound;
21. run bench.py's seq2 (its app and feed) at the bench's sizes, 4
   chunks of 65,536 orders and payments, and at 1,024-row chunks, each
   against its numpy oracle, with K1 on every send and K3; then
   events/s and latency;
22. the same for bench.py's kleene (K3's counting states), whose oracle
   models the 4,096-row pattern table that the bench's chunks fill;
23. hold kernels E (frequent and lossyFrequent), F (session) and G
   (order-by, offset and limit) against their plain versions on the
   card, bit for bit, state, output and the emitted counter, at every
   step of each app of checks.KEYED_APPS (frequent at N = 1, 2 and 64,
   with and without key attributes, expired events only; lossyFrequent
   at two (support, error) pairs, one past its 32 slots; session keyed
   and not, aggregated, closing by the event clock and by TIMER rows,
   past its 64 slots and 128 members; order-by on INT, LONG, FLOAT,
   DOUBLE and BOOL keys, asc and desc, with offset, limit and having,
   plain and aggregating), the lexsort traps, and the new paths' apps
   at 65,536-row sends;
24. run window_frequent (Siddhi's fraud query, frequent(2, cardNo);
   then frequent(64, cardNo) and lossyFrequent(0.1, 0.01, cardNo)):
   262,144 purchases of 4,096 Zipf-skewed cards in 4 sends of 65,536,
   each against its numpy oracle (lossyFrequent's insert overflow equal
   to the oracle's); K1, K2 and E on every send;
25. run window_session (per-user sessions, count and sum by user):
   1,048,576 clicks of 48 users in 16 sends of 65,536, then a TIMER,
   against its numpy oracle (the reference's step modelled, its member
   overflow equal); K1 and F, K6, K2 on every step;
26. run window_top10 (the ten largest tickers by volume per batch,
   ordered at the host edge by a STRING key; the same all on the card;
   a stateless top-100 by price): 1,048,576 trades in 16 sends of
   65,536, against their numpy oracles; G on every step of the two
   device orderings; each path reports events/s, latency at 65,536 and
   1,024 rows and its new kernel's time against its plain version, its
   bound and (G) chained stable torch.sort and the gathers;
27. run bench.py's chain3 and fanout (K1, K2): 4 sends of 65,536
   against their numpy oracles, with events/s and latency;
28. hold K2's function ops, kernel H (unionSet) and set rows through K5
   and K6 against their plain versions on the card at every launch:
   each app of checks.FUNC_APPS (functions in every context: filter,
   projection, having, aggregator arguments, grouping, both pattern
   engines, a join's ON, a table's ON), the set family's cases, and the
   new paths' apps at two 65,536-row sends;
29. run functions (market-data normalisation: every everyday function
   in a filter and a projection), polar (#pol2Cart and a bearing) and
   distinct_symbols (Siddhi's unionSet query over a 10 s timeBatch, on
   24 Zipf-skewed and 512 symbols) end to end: 1,048,576 events in 16
   sends of 65,536 each, against numpy oracles (sqrt, ln, cos, sin and
   atan within 4 ulp; unionSet and window overflow equal to the
   oracle's; the 24-symbol run's frozensets through a row callback);
   the launch counters must show each path's kernels (K1, K2; K5, K6
   and H for distinct_symbols); then events/s, latency at 65,536 and
   1,024 rows, K2's time on the functions chunk and H's at its path's
   shape against their plain versions, bounds and (H) torch.sort with
   torch.unique_consecutive;
30. run log (#log over 3 sends of 16 rows): each send's printed lines
   equal the oracle's;
31. hold kernel K9p (a partition block's route, compaction and due) and
   the launches of K4, K5 and K6 with the slot axis against their plain
   versions on the card, bit for bit, at every launch: each app of
   checks.PARTITION_APPS (value and range keys, inner streams, group by
   inside a block, key overflow, windows with timers, a pattern and an
   absent pattern), a flush that overflows the compaction, and the
   partition paths' apps at 64 slots;
32. run partition_avg (the Siddhi query guide's partition example, a
   per-symbol running average through an inner stream, 512 symbols at
   1,024 slots): 1,048,576 trades in 128 sends of 8,192, against its
   numpy oracle row for row with the overflow; K9p, K5 and K6 with the
   slot axis and K2 on every step; then events/s, latency, and K9p's,
   K5's and K6's times at the step's shape against their plain versions,
   bounds and (K9p) torch.sort;
33. and 34. run partition_fraud (every small purchase then a large one
   within 10 min, per card, 1,024 Zipf-skewed cards at 2,048 slots):
   262,144 transactions in 64 sends of 4,096 against its numpy oracle
   in order; then the per-customer absence of
   AbsentPatternTestCase.testQueryAbsent43 over 65,536 visits, driven
   past its deadlines by a TIMER, against its oracle; K9p and K4 with
   the slot axis on every step; K4's time at the fraud step's shape;
36. hold kernel K11 (an incremental aggregation's bucket step) against
   its plain version on the card, bit for bit, the whole per-duration
   state after every step: every aggregator over INT, LONG, DOUBLE and
   FLOAT arguments with nulls, a STRING and an INT group key and every
   duration (checks.K11_CHECK_APP), an order-sensitive float feed and a
   feed of more keys than the table's 4,096 slots;
37. run aggregation_trades (the Siddhi query guide's incremental
   aggregation, word for word): 1,048,576 trades of 64 symbols in 16
   sends of 65,536, out of order across 2026-01-01T00:00:00Z; one
   `within ... per` read a duration against a numpy group-by, the
   unplaced buckets' rows equal to the overflow; K11 on every step;
   then events/s, send latency, the reads' host time, and K11's time
   at the path's shape (every captured step held against its plain
   version) against its bound and index_add_ of one int lane;
38. run window_named (the query guide's named-window usage: a
   one-minute time window fed by one query, a per-room average reading
   it): 1,048,576 readings of 512 rooms in 16 sends of 65,536 against a
   numpy oracle, then an on-demand read of the window against it; K1,
   K2, K5 and K6 on the path;
40. hold kernels K10 (the reorder ring's step) and K5c (the cron
   window's step) against their plain versions on the card, bit for bit,
   every output written: K10 at C = 8, 1,024 and 65,536 on an empty and
   a full ring, a final step, a forced min_rel, equal timestamps, no
   watermark and no rows, over every column type with the float traps;
   K5c at capacities 16 and 4,096 with a firing with nothing pending and
   a buffer past its capacity;
41. run cron_trades (a cron('*/5 * * * * ?') named window fed by insert
   into and read by a grouped sum, a 5 s trigger through a projection, a
   one-minute average with output last every 5 sec): 1,048,576 trades of
   512 symbols 2 ms apart, a send a 5 s period (420 sends, 419
   firings), against checks.cron_trades_oracle: each firing's report
   rows, the trigger's rows, each limiter flush; no overflow; K5c on
   every send and firing, K1, K2, K5, K6 on the path; K5c's time at a
   firing against its plain version and its bound;
42. run watermark_sensors (window_time_grouped under
   @app:watermark(lateness='200 ms')): window_time_feed's 1,048,576
   events delivered out of order (0-200 ms delays, 0.1 % stragglers
   500-1,000 ms late) in 16 sends of 65,536 and the final flush; the rows
   equal the in-order oracle over the events that were not late, the
   late count the feed's own, forced 0; K10 on every send; K10's time
   against its plain version, its bound and torch.sort(stable=True)
   with the gathers;
44. tenants_pool: the reference bench's `tenants` arm (checks.
   TENANT_TEMPLATE: a filter on two tenant parameters, lengthBatch(256),
   a projection) through TemplateRegistry(SiddhiManager()).pool(...) at
   64, 256 and 1,024 tenants x 2,048 rows, batch_max 1,024, one warm
   pass and 3 timed passes (1 at 1,024 tenants): events/s, the rounds,
   each round's p50/p99; 8 sampled tenants' rows equal separate
   runtimes with the same bindings (fed the same round chunks), bit for
   bit; K1[K], K2 with its parameter loads and K5[K] launch on the timed
   passes, and at 1,024 tenants the first round's launches of each are
   held against their plain versions (tolerance 0) and timed;
45. to 47. pool_pattern, pool_join and pool_absent: 64 tenants x 1,024
   rows a stream of checks.class_feeds(seed=17), batch_max 256 (bucketed
   to 1,024, as in the reference): the class templates and a small
   absent pattern (fired by advance_time rounds); 8 sampled tenants
   against separate runtimes (the absent matches as multisets); K3[K],
   K7[K] (its grid entry point too, on the same arguments) with the
   join sides' K5[K], and K4[K]'s stream and timer steps launch, and
   the first rounds' launches are held against their plain versions
   over every slot and timed (K4[K]'s stream step from the warm pass's
   second launch on: the first one's plain version took 129 s on an
   H100);
48. to 50. pool_aggregation, partition_lanes and pool_lanes: a pool's
   aggregation class (K11[K]) and the stateful lanes (C[K], D[K],
   H[K]) in a partition block and a pool, sampled symbols and tenants
   against separate runtimes, the captured steps against their plain
   versions over every slot;
51. to 54. every window kind over a slot axis (window_slot_phases):
   partition_trades (trades_feed's 512 symbols at 1,024 slots, 128
   sends of 8,192, one block with externalTime, externalTimeBatch,
   timeLength, hopping, delay, batch and sort: A[K], B[K]),
   partition_purchases (about 1,000 merchants' frequent and
   lossyFrequent card screens: E[K]), partition_sessions (CLICK_APP
   per user at 1,024 slots: F[K]) and pool_windows (64 tenants of
   POOL_WINDOWS_TEMPLATE: all four); each kernel must launch, sampled
   keys (against blocks of one range each) and tenants (against
   separate runtimes) equal bit for bit, one captured step of every
   window kind held against its plain version over every slot and
   timed, with each path's seconds on a line of its own;
55. and 56. order by, offset and limit over a slot axis (G[K],
   order_slot_phases): partition_top (checks.PARTITION_TOP_APP,
   trades_feed's 512 symbols at 1,024 slots, 128 sends of 8,192: each
   ticker's top three trades of every lengthBatch(16), its running
   averages ordered after K6[K] with offset and limit and a rate limiter
   on the port) and pool_radar (checks.POOL_RADAR_TEMPLATE, 64 tenants
   x 1,024 rows a round, 8 rounds: pol2Cart, a template parameter before
   an aggregating selector, G[K] over the pool's slot axis); G[K] must
   launch, sampled keys (against a block of their ranges) and tenants
   (against separate runtimes) equal bit for bit, the first G[K]
   launches of each query held against the plain version over every
   slot and timed, each path's seconds on a line of its own;
57. to 59. checkpoint and recovery (checkpoint_phases): checkpoint_seq5
   (seq5, 1,048,576 events in 16 sends of 65,536, persisted after send
   8 to a FileSystemPersistenceStore and restored into a fresh runtime
   of the same manager for sends 9-16), checkpoint_partition
   (partition_avg, 1,024 slots, 128 sends of 8,192, persisted after send
   64) and pool_cron (checks.POOL_CRON_TEMPLATE, 256 tenants x 1,024
   rows a round, 8 rounds: a PoolCheckpointSupervisor persists after
   round 4, one tenant's callback fails in round 3, a fresh pool
   recovers and replays, then rounds 5-8; K5c[K], K5's cron kind over
   the pool's slot axis, must launch). Each continuation's rows and
   whole state equal an uninterrupted run's bit for bit, the kernels of
   each path launch after the restore, the pool's cron buffers equal a
   numpy oracle and no cron row is delivered; the captured K5c[K]
   launches, and four firing steps made from the first (TIMER rows in
   half the slots, expired rows on and off), are held against the
   plain version over every slot, and the first is timed; each phase prints its seconds, the snapshot bytes, persist
   and restore ms and the state's device-to-host rate beside a pinned
   copy of as many bytes;
60. print the kernel table as one JSON line, the card's name and power
   limit, and the result line.

`python3 chip_smoke.py --k5-time` times K5 alone (window_agg's and
window_time_grouped's step) and prints one JSON line: run from another
tree's root, a copy of this script times that tree's K5.

Imports neither JAX nor the reference package.
"""
import gc
import json
import subprocess
import sys
import time
from typing import Optional

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM published HBM3 rate
# 32-bit operations a second outside the tensor cores (the H100 SXM's
# published float32 rate; the interpreter's compares and masks are of
# that width)
OPS_PER_S = 67e12


def bound_of(n_bytes: int, n_ops: int):
    """The least time for a function: its bytes over the memory rate or
    its operations over the peak rate, the larger. -> (ms, "bytes" or
    "operations")."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else \
        (by_ops, "operations")
# the join and table paths: rows a send, sends a side (join, join_eq),
# the grid pass's sends, stock_table's rounds
SEND_ROWS, JOIN_SENDS, GRID_SENDS, STOCK_ROUNDS = 8192, 64, 16, 64
# the keyed windows', the top-10's and chain3's and fanout's sends
KEYED_SEND = 65536
# slice 10's sends (aggregation_trades, window_named) and the largest
# batch of K11's check against its plain version
AGG_SEND = 65536


_T0 = time.perf_counter()


def _mark(section: str) -> None:
    """The script's elapsed time at the start of a section of main()."""
    print(f"[section {section} at {time.perf_counter() - _T0:.1f} s]",
          flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, reps: int = 50, warmup: int = 5) -> float:
    """Mean device time of fn() over reps launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bits(t: torch.Tensor) -> torch.Tensor:
    """A tensor's raw bits as integers (bit-exact comparison, NaN too)."""
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    if t.dtype == torch.float64:
        return t.view(torch.int64)
    return t


def compare(name: str, got, want) -> float:
    """Fail unless every tensor pair is bit-equal; -> max abs error."""
    err = 0.0
    if len(got) != len(want):
        fail(f"{name}: {len(got)} outputs, the plain version {len(want)}")
    for k, (g, w) in enumerate(zip(got, want)):
        if g.shape != w.shape or g.dtype != w.dtype:
            fail(f"{name}: output {k} is {g.dtype}{list(g.shape)}, plain "
                 f"version {w.dtype}{list(w.shape)}")
        g, w = g.reshape(-1), w.reshape(-1)
        same = bits(g) == bits(w)
        if not bool(same.all()):
            bad = int((~same).nonzero()[0, 0])
            fail(f"{name}: output {k} differs at row {bad}: kernel "
                 f"{g[bad].item()!r}, plain version {w[bad].item()!r}")
        if g.dtype != torch.bool:
            both = ~(torch.isnan(g.double()) & torch.isnan(w.double()))
            d = (g.double() - w.double()).abs()[both & torch.isfinite(
                g.double())]
            err = max(err, float(d.max()) if d.numel() else 0.0)
    return err


def tree_leaves(tree) -> list:
    """The tensors of a nested dict/tuple state, in a fixed order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_clone(tree):
    if isinstance(tree, dict):
        return {k: tree_clone(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_clone(v) for v in tree)
    return tree.clone()


def k3_against_plain(dev) -> float:
    """Phase 5: one step of kernel K3 against its plain version, from the
    same table, on the card; the whole table and the match batch must be
    bit-equal: seq5 and kleene at their 65,536-row sends, the overflow
    feeds, the counting and sequence chains. -> max abs error (0)."""
    from siddhi_tpu_torch import SiddhiManager, _kernels
    from siddhi_tpu_torch.checks import (COUNT0_APP, COUNT_APP,
                                         COUNT_EVERY_APP, FINAL_COUNT_APP,
                                         PAIR_APP, SEQ5_APP, SEQ_APP,
                                         SINGLE_APP, SINGLE_COUNT_APP,
                                         Seq5Feed, out_overflow_stages,
                                         two_stream_feed)
    from siddhi_tpu_torch.core.event import batch_from_columns
    from siddhi_tpu_torch.core.types import GLOBAL_STRINGS
    from siddhi_tpu_torch.ops.nfa_parallel import (parallel_step,
                                                   parallel_step_ref)
    mgr = SiddhiManager()
    err = 0.0

    def step(what, q, stream, ts, cols, cap):
        """One step of q's engine over these events: kernel and plain
        version from clones of q's table; q keeps the kernel's table."""
        nonlocal err
        batch = batch_from_columns(q.app.schemas[stream], ts, cols,
                                   capacity=cap, device=dev)
        saved = dict(_kernels.LAUNCHES)
        tk, mk = parallel_step(q.engine, stream, tree_clone(q.nfa_state),
                               batch)
        _kernels.LAUNCHES.update(saved)   # not a launch of a main path
        tr, mr = parallel_step_ref(q.engine, stream,
                                   tree_clone(q.nfa_state), batch)
        err = max(err, compare(f"K3 {what}: table", tree_leaves(tk),
                               tree_leaves(tr)))
        err = max(err, compare(
            f"K3 {what}: match batch", [mk.ts, *mk.cols, *mk.nulls,
                                        mk.kind, mk.valid],
            [mr.ts, *mr.cols, *mr.nulls, mr.kind, mr.valid]))
        q.nfa_state = tk
        live = int(tk["valid"].sum())
        print(f"K3 {what}: bit-equal to its plain version ({len(ts)} "
              f"events, {int(mk.valid.sum())} matches, {live} rows live, "
              f"overflow {int(tk['overflow'])})", flush=True)
        return tk, mk

    def app(text):
        rt = mgr.create_siddhi_app_runtime(text)
        rt.start()
        return rt, rt.queries["q"]

    # seq5 at a 65,536-row chunk, from a table with live rows
    rt, q = app(SEQ5_APP)
    feed = Seq5Feed(GLOBAL_STRINGS.encode)
    for _ in range(3):
        rt.get_input_handler("T").send_arrays(*feed.next(65536))
    if int(q.nfa_state["valid"].sum()) == 0:
        fail("K3 seq5: no live rows before the compared chunk")
    step("seq5 65,536-row chunk from a live table", q, "T",
         *feed.next(65536), 65536)
    rt.shutdown()

    # the table-overflow feed: 8,192 stage-1 events
    rt, q = app(SEQ5_APP)
    tk, _ = step("table overflow (8,192 stage-1 events)", q, "T",
                 *Seq5Feed(GLOBAL_STRINGS.encode).next(
                     8192, stages=[1] * 8192), 8192)
    if int(tk["overflow"]) == 0:
        fail("K3 table-overflow feed did not overflow the table")
    rt.shutdown()

    # the out-overflow feed: more matches in one step than OUT holds
    rt, q = app(PAIR_APP)
    tk, mk = step("match-batch overflow", q, "T",
                  *Seq5Feed(GLOBAL_STRINGS.encode).next(
                      20480, stages=out_overflow_stages()), 65536)
    if int(tk["overflow"]) == 0 or int(mk.valid.sum()) != q.engine.OUT:
        fail("K3 out-overflow feed lost no match")
    rt.shutdown()

    # two-stream chains: counting (armed once, and always armed at scale)
    # and sequence mode, a step per stream in turn
    for what, text, n in (("counting chain, armed once", COUNT_APP, 2048),
                          ("counting chain, minimum 0", COUNT0_APP, 2048),
                          ("counting chain, every", COUNT_EVERY_APP, 65536),
                          ("final counting state", FINAL_COUNT_APP, 65536),
                          ("sequence-mode chain", SEQ_APP, 65536)):
        rt, q = app(text)
        stream, ts, cols = two_stream_feed(n, GLOBAL_STRINGS.encode, seed=9)
        for part, blk in enumerate(np.array_split(np.arange(n), 8)):
            sid = ("S1", "S2")[part % 2]
            sel = blk[stream[blk] == sid]
            cap = 1 << max(3, int(len(sel) - 1).bit_length())
            step(f"{what}, {sid}", q, sid, ts[sel],
                 [c[sel] for c in cols], cap)
        rt.shutdown()

    # single-state patterns over S1 (the only stream they consume)
    for what, text in (("single state", SINGLE_APP),
                       ("single counting state", SINGLE_COUNT_APP)):
        rt, q = app(text)
        _stream, ts, cols = two_stream_feed(16384, GLOBAL_STRINGS.encode,
                                            seed=4)
        for blk in np.array_split(np.arange(16384), 2):
            step(what, q, "S1", ts[blk], [c[blk] for c in cols], 8192)
        rt.shutdown()

    # kleene (bench.py's app and feed) at its 65,536-row sends: an A step
    # into a full table, then a B step
    from siddhi_tpu_torch.checks import KLEENE_APP, kleene_chunks
    rt, q = app(KLEENE_APP)
    (ta, a, tb, b), (ta2, a2, tb2, b2) = kleene_chunks(2, 65536)
    rt.get_input_handler("A").send_arrays(ta, [a])
    rt.get_input_handler("B").send_arrays(tb, [b])
    step("kleene, A", q, "A", ta2, [a2], 65536)
    step("kleene, B", q, "B", tb2, [b2], 65536)
    rt.shutdown()
    return err


def seq5_oracle(ts, sym, stage, within_ms=60_000):
    """seq5's matches, independently of the port: for each stage-1 event
    e1, the first same-symbol stage-2 event after it, the first stage-3
    after that, and so on to e5, kept when e5 is within `within_ms` of
    e1; ordered by (e5, e1). -> (e1 indices, e5 indices)."""
    idx = np.arange(len(ts))
    firsts, lasts = [], []
    for s in np.unique(sym):
        e1 = idx[(sym == s) & (stage == 1)]
        cur, ok = e1.copy(), np.ones(len(e1), bool)
        for k in range(2, 6):
            at = idx[(sym == s) & (stage == k)]
            j = np.searchsorted(at, cur, side="right")
            ok &= j < len(at)
            cur = np.where(j < len(at), at[np.minimum(j, len(at) - 1)], cur)
        ok &= ts[cur] - ts[e1] <= within_ms
        firsts.append(e1[ok])
        lasts.append(cur[ok])
    e1, e5 = np.concatenate(firsts), np.concatenate(lasts)
    order = np.lexsort((e1, e5))
    return e1[order], e5[order]


def profile_sends(h, data):
    """Device time per kernel over the sends of `data` (a list of (ts,
    cols)), under torch.profiler. -> ({kernel: ms per send}, busy share
    of the wall time), or ("not measured", nan) when the profiler sees no
    device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    sends = len(data)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for ts, cols in data:
            h.send_arrays(ts, cols)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out = {}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue   # host ops: their kernels are listed on their own
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0)
        if us > 0:
            out[evt.key[:60]] = round(us / 1e3 / sends, 5)
    if not out:
        return "not measured", float("nan")
    return out, sum(out.values()) * sends / (wall * 1e3)


def seq5_phase(dev, card: str, k3_err: float) -> dict:
    """Phase 6: seq5 end to end on the card, checked against the numpy
    oracle, with the launch counters; then its timings. -> K3's entry of
    the kernel table."""
    import ctypes

    from siddhi_tpu_torch import SiddhiManager, _kernels
    from siddhi_tpu_torch.checks import SEQ5_APP, Seq5Feed
    from siddhi_tpu_torch.core.event import batch_from_columns
    from siddhi_tpu_torch.core.types import GLOBAL_STRINGS
    from siddhi_tpu_torch.ops.nfa_parallel import (kernel_out, nfa_params,
                                                   parallel_step_ref,
                                                   set_events)
    N, SEND = 1 << 20, 65536
    mgr = SiddhiManager(device="cuda")
    # warm the allocator on another instance of the app
    warm = mgr.create_siddhi_app_runtime(SEQ5_APP.replace("'q'", "'w'"))
    warm.start()
    warm.get_input_handler("T").send_arrays(
        *Seq5Feed(GLOBAL_STRINGS.encode, seed=3).next(SEND))
    torch.cuda.synchronize()
    warm.shutdown()

    rt = mgr.create_siddhi_app_runtime(SEQ5_APP)
    q = rt.queries["q"]
    if rt.device.type != "cuda":
        fail(f"the seq5 runtime is on {rt.device}, not the card")
    outs = []
    q.batch_callbacks.append(outs.append)
    rt.start()
    h = rt.get_input_handler("T")
    feed = Seq5Feed(GLOBAL_STRINGS.encode)   # bench_seq5's: seed 12, TS0
    sends = [feed.next(SEND) for _ in range(N // SEND)]
    _kernels.reset_launches()
    t0 = time.perf_counter()
    for ts, cols in sends:
        h.send_arrays(ts, cols)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_kernels.LAUNCHES)
    want = {"unpack_packed": N // SEND, "expr_eval": N // SEND,
            "nfa_parallel": N // q.engine.PB}
    for k, n in want.items():
        if launches[k] != n:
            fail(f"seq5 path: kernel {k} launched {launches[k]} times, "
                 f"expected {n} (one per chunk; K3 one per sub-batch)")

    ts = np.concatenate([s[0] for s in sends])
    sym, stage, v = (np.concatenate([s[1][i] for s in sends])
                     for i in range(3))
    e1, e5 = seq5_oracle(ts, sym, stage)
    got = [torch.cat([o.cols[i][o.valid] for o in outs]).cpu().numpy()
           for i in range(3)]
    got_ts = torch.cat([o.ts[o.valid] for o in outs]).cpu().numpy()
    stats = q.stats()
    if stats["overflow"] != 0:
        fail(f"seq5: overflow {stats['overflow']} (table or match batch); "
             "the oracle assumes none")
    if len(got[0]) != len(e1) or stats["emitted"] != len(e1):
        fail(f"seq5: {len(got[0])} matches ({stats['emitted']} counted), "
             f"the oracle {len(e1)}")
    if not (np.array_equal(got[0], sym[e1]) and np.array_equal(got[1], v[e1])
            and np.array_equal(got[2], v[e5])
            and np.array_equal(got_ts, ts[e5])):
        bad = int(np.flatnonzero((got[1] != v[e1]) | (got[2] != v[e5])
                                 | (got[0] != sym[e1]))[:1].sum())
        fail(f"seq5: matches differ from the numpy oracle (first at {bad})")
    eps = N / wall
    print(f"seq5: {N} events in {N // SEND} sends of {SEND}; {len(e1)} "
          f"matches equal the numpy oracle in count, order and values; "
          f"overflow 0, lost 0; {eps:.0f} events/s, device batches only "
          f"({card})", flush=True)
    print(f"launches on the seq5 path: {launches}", flush=True)

    # per-chunk latency, send -> matches visible (as bench_seq5 times it)
    def latency(m, reps):
        h.send_arrays(*feed.next(m))   # warm this bucket
        torch.cuda.synchronize()
        lat = []
        for _ in range(reps):
            c0 = time.perf_counter()
            h.send_arrays(*feed.next(m))
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - c0) * 1e3)
        return np.percentile(lat, 50), np.percentile(lat, 99)

    p50, p99 = latency(SEND, 8)
    p50k, p99k = latency(1024, 64)
    print(f"seq5 latency per chunk: {SEND} rows p50 {p50:.3f} ms, p99 "
          f"{p99:.3f} ms; 1,024 rows p50 {p50k:.3f} ms, p99 {p99k:.3f} ms "
          f"({card})", flush=True)
    breakdown, busy = profile_sends(h, [feed.next(SEND) for _ in range(4)])
    print(f"seq5, where a {SEND}-row send's device time goes (torch."
          f"profiler, 4 sends, ms per send): {breakdown}; the card is busy "
          f"{busy:.3f} of the profiled wall time ({card})", flush=True)

    # K3's device time over one 65,536-row chunk (16 sub-batches), the
    # launches alone, each repetition from the same live table
    eng = q.engine
    ts_c, cols_c = feed.next(SEND)
    batch = batch_from_columns(rt.schemas["T"], ts_c, cols_c,
                               capacity=SEND, device=dev)
    table = q.nfa_state
    saved = tree_clone(table)
    live_before = int(table["valid"].sum())
    out = kernel_out(eng, dev)
    p = nfa_params(eng, "T", table, batch, out, eng.PB)
    params = []
    for k in range(SEND // eng.PB):
        pk = type(p)()
        ctypes.memmove(ctypes.byref(pk), ctypes.byref(p), ctypes.sizeof(p))
        set_events(pk, batch, k * eng.PB)
        params.append(pk)
    lib = _kernels.load()
    stream = torch.cuda.current_stream().cuda_stream
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    total, reps = 0.0, 20
    for r in range(reps + 2):
        for dst, src in zip(tree_leaves(table), tree_leaves(saved)):
            dst.copy_(src)
        torch.cuda.synchronize()
        start.record()
        for pk in params:
            lib.nfa_parallel_step(pk, stream)
        end.record()
        torch.cuda.synchronize()
        if r >= 2:
            total += start.elapsed_time(end)
    k3_chunk = total / reps
    n_match = int(out["n"])
    live_after = int(table["valid"].sum())
    # the plain version over the same chunk and table
    t_plain = []
    for _ in range(3):
        src = tree_clone(saved)
        torch.cuda.synchronize()
        c0 = time.perf_counter()
        parallel_step_ref(eng, "T", src, batch)
        torch.cuda.synchronize()
        t_plain.append((time.perf_counter() - c0) * 1e3)
    plain_chunk = min(t_plain)

    # the byte bound: the chunk's event columns read once, the live rows
    # read and written once, the matches written once
    ev_bytes = sum(x.element_size() for x in
                   (batch.ts, batch.kind, batch.valid, *batch.cols,
                    *batch.nulls)) * SEND
    row_bytes = sum(x[0].numel() * x.element_size()
                    for x in tree_leaves(table) if x.dim() >= 1)
    match_bytes = sum(c.element_size() + 1 for c in out["cols"]) + 8
    nbytes = ev_bytes + (live_before + live_after) * row_bytes + \
        n_match * match_bytes
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    sub = SEND // eng.PB
    print(f"nfa_parallel (K3): {k3_chunk:.5f} ms per {SEND}-row chunk, "
          f"{k3_chunk / sub:.5f} ms per {eng.PB}-event sub-batch; plain "
          f"version {plain_chunk:.3f} ms per chunk; bound {bound:.5f} ms "
          f"({nbytes} bytes at 3.35 TB/s: {ev_bytes} event bytes, "
          f"{live_before}+{live_after} live rows of {row_bytes} B, "
          f"{n_match} matches of {match_bytes} B); {card}", flush=True)
    for dst, src in zip(tree_leaves(table), tree_leaves(saved)):
        dst.copy_(src)
    rt.shutdown()
    print(json.dumps({"seq5": {
        "events_per_s_device_batches": eps, "p50_ms_65536": p50,
        "p99_ms_65536": p99, "p50_ms_1024": p50k, "p99_ms_1024": p99k,
        "k3_ms_per_chunk": k3_chunk, "k3_ms_per_sub_batch": k3_chunk / sub,
        "k3_plain_ms_per_chunk": plain_chunk, "k3_bound_ms": bound,
        "matches": len(e1), "device_ms_per_send": breakdown,
        "busy_share": busy, "card": card}}), flush=True)
    return {"name": "nfa_parallel", "route": "cuda",
            "source": "siddhi_tpu_torch/csrc/nfa_parallel.cu",
            "replaces": "siddhi_tpu/ops/nfa_parallel.py:626",
            "launches": launches["nfa_parallel"], "max_abs_err": k3_err,
            "ms": k3_chunk, "plain_ms": plain_chunk, "bound_ms": bound,
            "bound_by": "bytes", "library_ms": None}

def k4_against_plain(dev) -> float:
    """Phase 7: kernel K4 against its plain version on the card, from the
    same live table: one stream step, then a timer step at the table's
    next due; the whole table (overflow included), the match batch and
    next_due must be bit-equal. -> max abs error (0)."""
    from siddhi_tpu_torch import SiddhiManager, _kernels
    from siddhi_tpu_torch.checks import (SCAN_APPS, TABLE_OVERFLOW_APP,
                                         TIMEOUT_APP, three_stream_feed,
                                         timeout_burst_feed, timeout_feed)
    from siddhi_tpu_torch.core.event import batch_from_columns
    from siddhi_tpu_torch.core.types import GLOBAL_STRINGS
    from siddhi_tpu_torch.ops.nfa import POS_INF, scan_step, timer_step
    mgr = SiddhiManager()
    err = 0.0

    def match_leaves(m):
        return [m.ts, *m.cols, *m.nulls, m.kind, m.valid]

    def step(what, q, stream, ts, cols):
        """One step of q's engine over these events, then a timer step at
        the next due: kernel and plain version from clones of q's table;
        q keeps the kernel's table."""
        nonlocal err
        eng = q.engine
        cap = 1 << max(4, int(len(ts) - 1).bit_length())
        batch = batch_from_columns(q.app.schemas[stream], ts, cols,
                                   capacity=cap, device=dev)
        saved = dict(_kernels.LAUNCHES)
        due_k = torch.zeros((), dtype=torch.int64, device=dev)
        tk, mk = scan_step(eng, stream, tree_clone(q.nfa_state), batch, due_k)
        _kernels.LAUNCHES.update(saved)   # not a launch of a main path
        tr, mr = eng.stream_step_ref(stream, tree_clone(q.nfa_state), batch)
        err = max(err, compare(f"K4 {what}: table", tree_leaves(tk),
                               tree_leaves(tr)))
        err = max(err, compare(f"K4 {what}: match batch", match_leaves(mk),
                               match_leaves(mr)))
        err = max(err, compare(f"K4 {what}: next_due", [due_k],
                               [eng.next_due(tr)]))
        due = int(due_k)
        fired = "no deadline armed"
        if due < int(POS_INF):
            t_due = torch.zeros((), dtype=torch.int64, device=dev)
            saved = dict(_kernels.LAUNCHES)
            tk, tm = timer_step(eng, tk, due, t_due)
            _kernels.LAUNCHES.update(saved)
            tr, rm = eng.timer_step_ref(tr, due)
            err = max(err, compare(f"K4 {what}: timer table",
                                   tree_leaves(tk), tree_leaves(tr)))
            err = max(err, compare(f"K4 {what}: timer match batch",
                                   match_leaves(tm), match_leaves(rm)))
            err = max(err, compare(f"K4 {what}: timer next_due", [t_due],
                                   [eng.next_due(tr)]))
            fired = f"timer at the due fired {int(tm.valid.sum())}"
        q.nfa_state = tk
        print(f"K4 {what}: bit-equal to its plain version ({len(ts)} events, "
              f"{int(mk.valid.sum())} matches; {fired}; "
              f"{int(tk['valid'].sum())} rows live, overflow "
              f"{int(tk['overflow'])})", flush=True)
        return tk, mk

    def app(text):
        rt = mgr.create_siddhi_app_runtime(text)
        rt.start()
        return rt, rt.queries["q"]

    # absent_timeout at 2,048 events, from the table two sends left
    rt, q = app(TIMEOUT_APP)
    ts, cols = timeout_feed(4096, seed=5)
    h = rt.get_input_handler("Ev")
    for s in range(0, 2048, 1024):
        h.send_arrays(ts[s:s + 1024], [c[s:s + 1024] for c in cols])
    if int(q.nfa_state["valid"].sum()) == 0:
        fail("K4 absent_timeout: no live rows before the compared step")
    step("absent_timeout, 2,048 events from a live table", q, "Ev",
         ts[2048:], [c[2048:] for c in cols])
    rt.shutdown()

    # the scan shapes, over three streams: 240 events through the app,
    # then steps of one stream each from its live table
    for name in sorted(SCAN_APPS):
        rt, q = app(SCAN_APPS[name])
        stream, ts, cols = three_stream_feed(480, GLOBAL_STRINGS.encode,
                                             seed=9, gap_ms=4)
        k = 0
        while k < 240:
            e = k
            while e < 240 and stream[e] == stream[k]:
                e += 1
            rt.get_input_handler(stream[k]).send_arrays(
                ts[k:e], [c[k:e] for c in cols])
            k = e
        for part, blk in enumerate(np.array_split(np.arange(240, 480), 6)):
            sid = ("S1", "S2", "S3")[part % 3]
            sel = blk[stream[blk] == sid]
            if len(sel):
                step(f"{name}, {sid}", q, sid, ts[sel],
                     [c[sel] for c in cols])
        rt.shutdown()

    # more live requests than the 128-row table holds
    rt, q = app(TABLE_OVERFLOW_APP)
    tk, _ = step("table overflow", q, "Ev",
                 *timeout_feed(1024, seed=6, p_answer=0.5))
    if int(tk["overflow"]) == 0:
        fail("K4 table-overflow feed did not overflow the table")
    rt.shutdown()

    # more deadlines fired in one step than the 256-row match batch holds
    rt, q = app(TIMEOUT_APP)
    tk, mk = step("match-batch overflow", q, "Ev", *timeout_burst_feed())
    if int(tk["overflow"]) == 0 or int(mk.valid.sum()) != q.engine.OUT:
        fail("K4 match-batch overflow feed lost no match")
    rt.shutdown()
    return err


def timeout_phase(dev, card: str, k4_err: float) -> dict:
    """Phase 8: absent_timeout end to end on the card, checked against the
    numpy oracle, with the launch counters; then its timings. -> K4's
    entry of the kernel table."""
    from siddhi_tpu_torch import SiddhiManager, _kernels
    from siddhi_tpu_torch.checks import (TIMEOUT_APP, timeout_feed,
                                         timeout_oracle)
    from siddhi_tpu_torch.core.event import batch_from_columns
    from siddhi_tpu_torch.ops.nfa import kernel_out, scan_args
    N, SEND = 1 << 20, 1024
    mgr = SiddhiManager(device="cuda")
    # warm the allocator and the kernels on another instance of the app
    warm = mgr.create_siddhi_app_runtime(TIMEOUT_APP.replace("'q'", "'w'"))
    warm.start()
    wts, wcols = timeout_feed(4 * SEND, seed=3)
    for s in range(0, 4 * SEND, SEND):
        warm.get_input_handler("Ev").send_arrays(
            wts[s:s + SEND], [c[s:s + SEND] for c in wcols])
    torch.cuda.synchronize()
    warm.shutdown()

    rt = mgr.create_siddhi_app_runtime(TIMEOUT_APP)
    q = rt.queries["q"]
    if rt.device.type != "cuda":
        fail(f"the absent_timeout runtime is on {rt.device}, not the card")
    outs = []
    q.batch_callbacks.append(outs.append)
    rt.start()
    h = rt.get_input_handler("Ev")
    # the run's feed, then 80 more sends for latency, profile and timing
    ts_all, cols_all = timeout_feed(N + 80 * SEND, seed=5)

    def chunk(k):
        s = k * SEND
        return ts_all[s:s + SEND], [c[s:s + SEND] for c in cols_all]

    sends = [chunk(k) for k in range(N // SEND)]
    _kernels.reset_launches()
    t0 = time.perf_counter()
    for ts, cols in sends:
        h.send_arrays(ts, cols)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_kernels.LAUNCHES)
    steps = len(outs)
    timers = steps - N // SEND
    want = {"unpack_packed": N // SEND, "nfa_scan": steps,
            "expr_eval": steps}
    for k, n in want.items():
        if launches[k] != n:
            fail(f"absent_timeout path: kernel {k} launched {launches[k]} "
                 f"times, expected {n} (K1 one per send; K4 and K2 one "
                 "per stream or timer step)")
    if timers <= 0:
        fail("absent_timeout path: the scheduler fired no timer step")

    rid, svc, due, live = timeout_oracle(ts_all[:N],
                                         *(c[:N] for c in cols_all))
    got = [torch.cat([o.cols[i][o.valid] for o in outs]).cpu().numpy()
           for i in range(2)]
    got_ts = torch.cat([o.ts[o.valid] for o in outs]).cpu().numpy()
    per_step = max(int(o.valid.sum()) for o in outs)
    stats = q.stats()
    if stats["overflow"] != 0 or per_step > q.engine.OUT:
        fail(f"absent_timeout: overflow {stats['overflow']}, largest step "
             f"{per_step} matches; the oracle assumes no loss")
    if len(got[0]) != len(rid) or stats["emitted"] != len(rid):
        fail(f"absent_timeout: {len(got[0])} alerts ({stats['emitted']} "
             f"counted), the oracle {len(rid)}")
    if not (np.array_equal(got[0], rid) and np.array_equal(got[1], svc)
            and np.array_equal(got_ts, due)):
        fail("absent_timeout: alerts differ from the numpy oracle")
    n_live = int(q.nfa_state["valid"].sum())
    if n_live != live:
        fail(f"absent_timeout: {n_live} rows live, the oracle {live}")
    eps = N / wall
    print(f"absent_timeout: {N} events in {N // SEND} sends of {SEND}; "
          f"{len(rid)} alerts equal the numpy oracle in count, order and "
          f"values; {live} requests still waiting, as the table's live "
          f"rows; overflow 0, at most {per_step} matches a step; {timers} "
          f"timer steps; {eps:.0f} events/s, device batches only ({card})",
          flush=True)
    print(f"launches on the absent_timeout path: {launches}", flush=True)

    # per-send latency, send -> alerts visible
    k_next = N // SEND
    h.send_arrays(*chunk(k_next))
    torch.cuda.synchronize()
    lat = []
    for k in range(k_next + 1, k_next + 65):
        c0 = time.perf_counter()
        h.send_arrays(*chunk(k))
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - c0) * 1e3)
    p50, p99 = np.percentile(lat, 50), np.percentile(lat, 99)
    print(f"absent_timeout latency per {SEND}-row send: p50 {p50:.3f} ms, "
          f"p99 {p99:.3f} ms ({card})", flush=True)
    k_next += 65
    breakdown, busy = profile_sends(h, [chunk(k) for k in
                                        range(k_next, k_next + 4)])
    k_next += 4
    print(f"absent_timeout, where a {SEND}-row send's device time goes "
          f"(torch.profiler, 4 sends, ms per send): {breakdown}; the card is "
          f"busy {busy:.3f} of the profiled wall time ({card})", flush=True)

    # K4's device time over one chunk, the launch alone, each repetition
    # from the same live table
    eng = q.engine
    ts_c, cols_c = chunk(k_next)
    batch = batch_from_columns(rt.schemas["Ev"], ts_c, cols_c,
                               capacity=SEND, device=dev)
    table = q.nfa_state
    saved = tree_clone(table)
    live_before = int(table["valid"].sum())
    out = kernel_out(eng, dev)
    due_t = torch.zeros((), dtype=torch.int64, device=dev)
    args = scan_args(eng, "Ev", table, batch, 0, out, due_t, dev)
    lib = _kernels.load()
    stream = torch.cuda.current_stream().cuda_stream
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    total, reps = 0.0, 20
    for r in range(reps + 2):
        for dst, src in zip(tree_leaves(table), tree_leaves(saved)):
            dst.copy_(src)
        torch.cuda.synchronize()
        start.record()
        lib.nfa_scan(args, stream)
        end.record()
        torch.cuda.synchronize()
        if r >= 2:
            total += start.elapsed_time(end)
    k4_chunk = total / reps
    n_match = int(out["n"])
    live_after = int(table["valid"].sum())
    t_plain = []
    for _ in range(2):
        src = tree_clone(saved)
        torch.cuda.synchronize()
        c0 = time.perf_counter()
        eng.stream_step_ref("Ev", src, batch)
        torch.cuda.synchronize()
        t_plain.append((time.perf_counter() - c0) * 1e3)
    plain_chunk = min(t_plain)
    for dst, src in zip(tree_leaves(table), tree_leaves(saved)):
        dst.copy_(src)

    # the byte bound: the chunk's events read once, the live rows read
    # and written once, the matches written once
    ev_bytes = sum(x.element_size() for x in
                   (batch.ts, batch.kind, batch.valid, *batch.cols,
                    *batch.nulls)) * SEND
    row_bytes = sum(x[0].numel() * x.element_size()
                    for x in tree_leaves(table) if x.dim() >= 1)
    match_bytes = sum(c.element_size() + 1 for c in out["cols"]) + 8
    nbytes = ev_bytes + (live_before + live_after) * row_bytes + \
        n_match * match_bytes
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"nfa_scan (K4): {k4_chunk:.5f} ms per {SEND}-row chunk, "
          f"{k4_chunk / SEND * 1e3:.4f} us per event; plain version "
          f"{plain_chunk:.1f} ms per chunk; bound {bound:.6f} ms ({nbytes} "
          f"bytes at 3.35 TB/s: {ev_bytes} event bytes, {live_before}+"
          f"{live_after} live rows of {row_bytes} B, {n_match} matches of "
          f"{match_bytes} B); {card}", flush=True)
    rt.shutdown()
    print(json.dumps({"absent_timeout": {
        "events_per_s_device_batches": eps, "p50_ms_1024": p50,
        "p99_ms_1024": p99, "k4_ms_per_chunk": k4_chunk,
        "k4_us_per_event": k4_chunk / SEND * 1e3,
        "k4_plain_ms_per_chunk": plain_chunk, "k4_bound_ms": bound,
        "alerts": len(rid), "timer_steps": timers, "launches": launches,
        "device_ms_per_send": breakdown, "busy_share": busy,
        "card": card}}), flush=True)
    return {"name": "nfa_scan", "route": "cuda",
            "source": "siddhi_tpu_torch/csrc/nfa_scan.cu",
            "replaces": "siddhi_tpu/ops/nfa.py:638",
            "launches": launches["nfa_scan"], "max_abs_err": k4_err,
            "ms": k4_chunk, "plain_ms": plain_chunk, "bound_ms": bound,
            "bound_by": "bytes", "library_ms": None}



# -- kernels K5 and K6: windows and aggregation ----------------------------

class KernelCheck:
    """While installed, every window step (K5) and aggregate step and
    emission (K6) the runtime makes on the card also runs the plain
    version on the same inputs; kernel and plain results must be
    bit-equal (tolerance 0). The runtime goes on with the kernel's."""

    def __init__(self):
        from siddhi_tpu_torch.ops import aggregators as G
        from siddhi_tpu_torch.ops import windows as W
        from siddhi_tpu_torch.ops import windows2 as W2
        self.G, self.W, self.W2 = G, W, W2
        self.err = 0.0
        self.steps = {"window_step": 0, "sort_window": 0,
                      "aggregate_step": 0, "aggregate_emit": 0}
        self.shapes = set()

    def __enter__(self):
        G, W, W2 = self.G, self.W, self.W2
        self.saved = (W.window_step, G.aggregate_step, G.aggregate_emit,
                      W2.sort_window_step)
        k_win, k_agg, k_emit, k_sort = self.saved

        def sort_window_step(op, state, batch, now):
            ks, ko = k_sort(op, state, batch, now)
            rs, ro = W2.sort_window_step_ref(op, state, batch, now)
            what = f"sort window B={batch.capacity}"
            self.err = max(self.err, compare(
                what + " state", tree_leaves(ks), tree_leaves(rs)))
            self.err = max(self.err, compare(
                what + " output", [ko.ts, *ko.cols, *ko.nulls, ko.kind,
                                   ko.valid],
                [ro.ts, *ro.cols, *ro.nulls, ro.kind, ro.valid]))
            self.steps["sort_window"] += 1
            self.shapes.add(("K5s", op.L, batch.capacity))
            return ks, ko

        def window_step(op, state, batch, now):
            ks, ko = k_win(op, state, batch, now)
            rs, ro = W.window_step_ref(op, state, batch, now)
            what = f"K5 {type(op).__name__} B={batch.capacity}"
            self.err = max(self.err, compare(
                what + " state", tree_leaves(ks), tree_leaves(rs)))
            self.err = max(self.err, compare(
                what + " output", [ko.ts, *ko.cols, *ko.nulls, ko.kind,
                                   ko.valid],
                [ro.ts, *ro.cols, *ro.nulls, ro.kind, ro.valid]))
            self.steps["window_step"] += 1
            self.shapes.add(("K5", type(op).__name__, batch.capacity))
            return ks, ko

        def aggregate_step(op, state, key_cols, arg_cols, kind, valid):
            k = k_agg(op, state, key_cols, arg_cols, kind, valid)
            r = G.aggregate_step_ref(op, state, key_cols, arg_cols, kind,
                                     valid)
            self.err = max(self.err, compare(
                f"K6 step B={kind.shape[0]}", tree_leaves(k),
                tree_leaves(r)))
            self.steps["aggregate_step"] += 1
            self.shapes.add(("K6", len(op.agg_specs), kind.shape[0]))
            return k

        def aggregate_emit(op, slots, qual, batch, oc, on, emitted=None):
            e_ref = emitted.clone() if emitted is not None else None
            ko = k_emit(op, slots, qual, batch, oc, on, emitted)
            ro = G.aggregate_emit_ref(op, slots, qual, batch, oc, on, e_ref)
            self.err = max(self.err, compare(
                f"K6 emission B={batch.capacity}",
                [ko.ts, *ko.cols, *ko.nulls, ko.kind, ko.valid]
                + ([emitted] if emitted is not None else []),
                [ro.ts, *ro.cols, *ro.nulls, ro.kind, ro.valid]
                + ([e_ref] if e_ref is not None else [])))
            self.steps["aggregate_emit"] += 1
            return ko

        W.window_step, G.aggregate_step, G.aggregate_emit = \
            window_step, aggregate_step, aggregate_emit
        W2.sort_window_step = sort_window_step
        return self

    def __exit__(self, *exc):
        W, G, W2 = self.W, self.G, self.W2
        W.window_step, G.aggregate_step, G.aggregate_emit, \
            W2.sort_window_step = self.saved
        return False


def k56_against_plain(dev) -> float:
    """Phase 9: kernels K5 and K6 against their plain versions on the
    card, bit for bit, at every step of: each comparison app of
    checks.WINDOW_APPS (the four window kinds, length(0), stream-current
    and start-time modes, having, offset and limit, the aggregator kinds),
    a RESET-heavy feed (lengthBatch(2)), a time window over its capacity
    (overflow), more distinct keys than the 1,024-slot table (overflow),
    and both main configurations at the main path's shapes (three
    65,536-row sends of window_agg, two of window_time_grouped, whose
    window holds about 60,000 rows). -> max abs error (0)."""
    from siddhi_tpu_torch import SiddhiManager, _kernels
    from siddhi_tpu_torch.checks import (KEYS_OVERFLOW_APP, WINDOW_AGG_APP,
                                         WINDOW_APPS, WINDOW_OVERFLOW_APP,
                                         WINDOW_TIME_APP, window_agg_feed,
                                         window_feed, window_time_feed)
    from siddhi_tpu_torch.core.types import GLOBAL_STRINGS
    mgr = SiddhiManager()
    saved = dict(_kernels.LAUNCHES)
    apps = [(name, text, dict(seed=3)) for name, text in WINDOW_APPS.items()]
    apps += [("window over its capacity", WINDOW_OVERFLOW_APP,
              dict(seed=4, gap_ms=1)),
             ("more keys than the table", KEYS_OVERFLOW_APP,
              dict(seed=5, n_syms=1500))]
    with KernelCheck() as chk:
        for name, text, kw in apps:
            rt = mgr.create_siddhi_app_runtime(text)
            rt.start()
            h = rt.get_input_handler("S")
            n = 4096 if "keys" in name else 600
            ts, cols = window_feed(n, GLOBAL_STRINGS.encode, **kw)
            cuts = (0, 1024, 2048, 3072, 4096) if n == 4096 else \
                (0, 100, 356, 600)
            for a, b in zip(cuts[:-1], cuts[1:]):
                h.send_arrays(ts[a:b], [c[a:b] for c in cols])
            q = rt.queries["q"]
            st = q.stats()
            if "over" in name or "more keys" in name:
                if st["overflow"] == 0:
                    fail(f"K5/K6 feed '{name}' did not overflow")
            rt.shutdown()
            print(f"K5/K6 {name}: bit-equal to their plain versions "
                  f"({n} events; emitted {st['emitted']}, overflow "
                  f"{st['overflow']}; steps so far {chk.steps})", flush=True)
        for name, text, feed, stream, sends in (
                ("window_agg", WINDOW_AGG_APP, window_agg_feed,
                 "StockStream", 3),
                ("window_time_grouped", WINDOW_TIME_APP, window_time_feed,
                 "StockStream", 2)):
            rt = mgr.create_siddhi_app_runtime(text)
            rt.start()
            h = rt.get_input_handler(stream)
            ts, cols = feed(sends * 65536, GLOBAL_STRINGS.encode)
            for k in range(sends):
                s = slice(k * 65536, (k + 1) * 65536)
                h.send_arrays(ts[s], [c[s] for c in cols])
            st = rt.queries["q"].stats()
            rt.shutdown()
            print(f"K5/K6 {name}, {sends} sends of 65,536 rows: bit-equal to "
                  f"their plain versions (emitted {st['emitted']}, overflow "
                  f"{st['overflow']})", flush=True)
        # the repaired lanes: NaN of either sign and both infinities in a
        # sum lane, -0.0 and subnormals at a group's first row of min/max
        from siddhi_tpu_torch.checks import SPECIAL_AGG_APP, special_agg_feed
        for seed in (0, 3):
            rt = mgr.create_siddhi_app_runtime(SPECIAL_AGG_APP)
            rt.start()
            ts, cols = special_agg_feed(seed, GLOBAL_STRINGS.encode)
            rt.get_input_handler("S").send_arrays(ts, cols)
            rt.shutdown()
        print("K6 on special values (the feeds of seeds 0 and 3): bit-equal "
              "to its repaired plain version", flush=True)
    _kernels.LAUNCHES.update(saved)   # not launches of a main path
    print(f"K5/K6 shapes held against the plain versions: "
          f"{sorted(chk.shapes, key=str)}", flush=True)
    return chk.err


def window_phase(dev, card: str, which: str) -> dict:
    """Phases 10 and 11: window_agg or window_time_grouped end to end on
    the card through SiddhiManager, send_arrays and batch_callbacks:
    1,048,576 events in 16 sends of 65,536 rows, checked against the
    numpy oracle of checks.py, with the launch counters; then events/s,
    per-send latency at 65,536 and 1,024 rows, the profiler's split, and
    K5's and K6's device time per step against their plain versions and
    their byte bounds. -> the path's numbers."""
    from siddhi_tpu_torch import SiddhiManager, _kernels
    from siddhi_tpu_torch import checks as C
    from siddhi_tpu_torch.core.types import GLOBAL_STRINGS
    from siddhi_tpu_torch.ops import aggregators as G
    from siddhi_tpu_torch.ops import windows as W
    N, SEND = 1 << 20, 65536
    if which == "window_agg":
        text, feed = C.WINDOW_AGG_APP, C.window_agg_feed
    else:
        text, feed = C.WINDOW_TIME_APP, C.window_time_feed
    mgr = SiddhiManager(device="cuda")
    warm = mgr.create_siddhi_app_runtime(text.replace("'q'", "'w'"))
    warm.start()
    wts, wcols = feed(2 * SEND, GLOBAL_STRINGS.encode, seed=3)
    for k in range(2):
        s = slice(k * SEND, (k + 1) * SEND)
        warm.get_input_handler("StockStream").send_arrays(
            wts[s], [c[s] for c in wcols])
    torch.cuda.synchronize()
    warm.shutdown()

    rt = mgr.create_siddhi_app_runtime(text)
    q = rt.queries["q"]
    if rt.device.type != "cuda":
        fail(f"the {which} runtime is on {rt.device}, not the card")
    outs = []
    q.batch_callbacks.append(outs.append)
    rt.start()
    h = rt.get_input_handler("StockStream")
    # the run's feed, then more sends for latency, profile and timing
    extra = 9 * SEND + 70 * 1024
    ts_all, cols_all = feed(N + extra, GLOBAL_STRINGS.encode)
    sends = [(ts_all[s:s + SEND], [c[s:s + SEND] for c in cols_all])
             for s in range(0, N, SEND)]
    _kernels.reset_launches()
    t0 = time.perf_counter()
    for ts, cols in sends:
        h.send_arrays(ts, cols)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_kernels.LAUNCHES)
    steps = len(outs)
    want = {"unpack_packed": N // SEND, "window_step": steps,
            "aggregate_step": steps, "aggregate_emit": steps}
    for k, n in want.items():
        if launches[k] != n or n == 0:
            fail(f"{which} path: kernel {k} launched {launches[k]} times, "
                 f"expected {n} (K1 one per send; K5 and K6 one per step)")
    if launches["expr_eval"] == 0:
        fail(f"{which} path: K2 never launched")

    ts_run = ts_all[:N]
    sym, price, vol = (c[:N] for c in cols_all)
    got = [torch.cat([o.cols[i][o.valid] for o in outs]).cpu().numpy()
           for i in range(len(q.out_schema.types))]
    stats = q.stats()
    if stats["overflow"] != 0:
        fail(f"{which}: overflow {stats['overflow']}; the oracle assumes none")
    if which == "window_agg":
        ap, sv = C.window_agg_oracle(price, vol)
        g_ap, g_sv = got
        ok = len(g_ap) == len(ap) and np.array_equal(g_sv, sv)
        rel = float(np.max(np.abs(g_ap - ap) / np.abs(ap))) if ok else None
        rows = len(ap)
    else:
        o_sym, ap, sv, n = C.window_time_oracle(ts_run, sym, price, vol)
        g_sym, g_ap, g_sv, g_n = got
        ok = len(g_ap) == len(ap) and np.array_equal(g_sym, o_sym) and \
            np.array_equal(g_sv, sv) and np.array_equal(g_n, n)
        rel = float(np.max(np.abs(g_ap - ap) / np.abs(ap))) if ok else None
        rows = len(ap)
    if not ok or rel > 1e-12 or stats["emitted"] != rows:
        fail(f"{which}: {len(got[0])} rows ({stats['emitted']} counted), "
             f"the oracle {rows}; exact columns equal: {ok}; ap relative "
             f"error {rel}")
    eps = N / wall
    print(f"{which}: {N} events in {N // SEND} sends of {SEND}; {rows} rows "
          f"equal the numpy oracle (exact columns exact, ap within "
          f"{rel:.3g} relative, limit 1e-12); overflow 0; {eps:.0f} "
          f"events/s, device batches only ({card})", flush=True)
    print(f"launches on the {which} path: {launches}", flush=True)

    k_next = N

    def chunk(m):
        nonlocal k_next
        s = slice(k_next, k_next + m)
        k_next += m
        return ts_all[s], [c[s] for c in cols_all]

    def latency(m, reps):
        h.send_arrays(*chunk(m))   # warm this bucket
        torch.cuda.synchronize()
        lat = []
        for _ in range(reps):
            c0 = time.perf_counter()
            h.send_arrays(*chunk(m))
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - c0) * 1e3)
        return float(np.percentile(lat, 50)), float(np.percentile(lat, 99))

    p50, p99 = latency(SEND, 8)
    p50k, p99k = latency(1024, 64)
    print(f"{which} latency per send: {SEND} rows p50 {p50:.3f} ms, p99 "
          f"{p99:.3f} ms; 1,024 rows p50 {p50k:.3f} ms, p99 {p99k:.3f} ms "
          f"({card})", flush=True)
    breakdown, busy = profile_sends(h, [chunk(1024) for _ in range(4)])
    print(f"{which}, where a 1,024-row send's device time goes (torch."
          f"profiler, 4 sends, ms per send): {breakdown}; the card is busy "
          f"{busy:.3f} of the profiled wall time ({card})", flush=True)

    # K5 and K6 at this path's shapes: one 65,536-row step from the live
    # state, the launches alone (arguments built once: the step reads its
    # inputs and writes fresh state, so a repeat is the same work)
    from siddhi_tpu_torch.core.event import batch_from_columns
    ts_c, cols_c = sends[-1]
    batch = batch_from_columns(rt.schemas["StockStream"], ts_c, cols_c,
                               capacity=SEND, device=dev)
    wop, aop = q.operators[0], q.operators[-1]
    wst, ast = q.states[0], q.states[-1]
    now = torch.tensor(int(ts_c[-1]), dtype=torch.int64, device=dev)
    _ws, wout, wargs = W.window_args(wop, wst, batch, now)
    lib = _kernels.load()
    stream = torch.cuda.current_stream().cuda_stream
    lib.window_step(wargs, stream)
    pre, computed, proj, hav = aop._programs()
    if pre is not None:
        fail(f"{which}: keys and arguments are bare columns, no K2 before K6")

    def col(ce):
        i = G._bare_column(ce)
        return wout.cols[i], wout.nulls[i]
    key_cols = [col(ke) for ke in aop.key_exprs]
    arg_cols = [col(a) if a is not None else None for a in aop.agg_args]
    slots, aggs, _as, aargs, _st = G.agg_args(aop, ast, key_cols, arg_cols,
                                              wout.kind, wout.valid)
    lib.aggregate_step(aargs, stream)
    from siddhi_tpu_torch.core.event import EventBatch
    from siddhi_tpu_torch.ops.expr import expr_eval
    ext = EventBatch(wout.ts, tuple(wout.cols) + tuple(v for v, _ in aggs),
                     tuple(wout.nulls) + tuple(n for _, n in aggs),
                     wout.kind, wout.valid)
    oc, on, qual = expr_eval(proj, ext)
    eout, eargs = G.emit_args(aop, slots, qual, wout, oc, on, None)
    k5_ms = cuda_ms(lambda: lib.window_step(wargs, stream), reps=20)
    k6_step_ms = cuda_ms(lambda: lib.aggregate_step(aargs, stream), reps=20)
    k6_emit_ms = cuda_ms(lambda: lib.aggregate_emit(eargs, stream), reps=20)
    k6_ms = k6_step_ms + k6_emit_ms
    k5_plain = cuda_ms(lambda: W.window_step_ref(wop, wst, batch, now),
                       reps=2, warmup=1)
    k6_plain = cuda_ms(lambda: (
        G.aggregate_step_ref(aop, ast, key_cols, arg_cols, wout.kind,
                             wout.valid),
        G.aggregate_emit_ref(aop, slots, qual, wout, oc, on)), reps=2,
        warmup=1)
    keys = wargs._keep[3]["keys"].clone()   # K5's own emission keys
    lib_ms = cuda_ms(lambda: torch.sort(keys, stable=True), reps=20)
    _kernels.LAUNCHES.update(launches)   # timing launches: not the path's

    def nbytes(tensors):
        return sum(t.numel() * t.element_size() for t in tensors)
    W_ = wst["buf" if "buf" in wst else "cur"]
    state_in = [t for k in ("buf", "cur", "exp") if k in wst
                for t in (wst[k]["ts"], wst[k]["seq"], *wst[k]["cols"],
                          *wst[k]["nulls"], wst[k]["valid"])]
    k5_bytes = nbytes([batch.ts, batch.kind, batch.valid, *batch.cols,
                       *batch.nulls]) + 2 * nbytes(state_in) + \
        nbytes([wout.ts, wout.kind, wout.valid, *wout.cols, *wout.nulls])
    carries = [c for spec in ast["carry"] for c in spec]
    inputs = [c for kc in key_cols for c in kc] + \
        [c for ac in arg_cols if ac is not None for c in ac]
    k6_bytes = nbytes([wout.kind, wout.valid, *inputs]) \
        + 2 * nbytes([ast["keys"], ast["used"], *carries]) \
        + nbytes([slots, *[t for a in aggs for t in a]]) \
        + nbytes([slots, qual, wout.ts, wout.kind, wout.valid, *oc, *on]) \
        + nbytes([eout.ts, eout.kind, eout.valid, *eout.cols, *eout.nulls])
    k5_bound = k5_bytes / HBM_BYTES_PER_S * 1e3
    k6_bound = k6_bytes / HBM_BYTES_PER_S * 1e3
    print(f"window_step (K5), {which}: {k5_ms:.5f} ms a 65,536-row step "
          f"(output {wout.capacity} rows, window {W_['seq'].shape[0]} rows); "
          f"plain version {k5_plain:.3f} ms; torch.sort(stable=True) of the "
          f"emission keys {lib_ms:.5f} ms; bound {k5_bound:.5f} ms "
          f"({k5_bytes} bytes at 3.35 TB/s); {card}", flush=True)
    print(f"aggregate_step (K6), {which}: {k6_ms:.5f} ms a step "
          f"({k6_step_ms:.5f} step + {k6_emit_ms:.5f} emission, "
          f"{wout.capacity} rows, "
          f"K {aop.K}); plain version {k6_plain:.3f} ms; bound "
          f"{k6_bound:.5f} ms ({k6_bytes} bytes at 3.35 TB/s); {card}",
          flush=True)
    rt.shutdown()
    del outs
    gc.collect()
    res = {"events_per_s_device_batches": eps, "p50_ms_65536": p50,
           "p99_ms_65536": p99, "p50_ms_1024": p50k, "p99_ms_1024": p99k,
           "rows": rows,
           "ap_max_rel_err": rel, "launches": launches,
           "k5_ms": k5_ms, "k5_plain_ms": k5_plain, "k5_bound_ms": k5_bound,
           "k5_library_ms": lib_ms, "k6_ms": k6_ms,
           "k6_step_ms": k6_step_ms, "k6_emit_ms": k6_emit_ms,
           "k6_plain_ms": k6_plain, "k6_bound_ms": k6_bound,
           "device_ms_per_send": breakdown, "busy_share": busy,
           "card": card}
    print(json.dumps({which: res}), flush=True)
    return res


def k5_time(dev, rounds: int = 5) -> dict:
    """K5's device time a 65,536-row step of window_agg and
    window_time_grouped, from a live state (two sends in: the time
    window holds its full minute), the launches alone: `rounds` means of
    50 launches each. `python3 chip_smoke.py --k5-time` prints it and
    nothing else; it uses only what K5 has had since it was ported, so
    a copy of this script run from another tree's root times that
    tree's K5, and two trees compare within one call."""
    from siddhi_tpu_torch import SiddhiManager, _kernels
    from siddhi_tpu_torch import checks as C
    from siddhi_tpu_torch.core.event import batch_from_columns
    from siddhi_tpu_torch.core.types import GLOBAL_STRINGS
    from siddhi_tpu_torch.ops import windows as W
    lib = _kernels.load()
    stream = torch.cuda.current_stream().cuda_stream
    mgr = SiddhiManager(device="cuda")
    res = {}
    for which, text, feed in (
            ("window_agg", C.WINDOW_AGG_APP, C.window_agg_feed),
            ("window_time_grouped", C.WINDOW_TIME_APP, C.window_time_feed)):
        rt = mgr.create_siddhi_app_runtime(text)
        rt.start()
        h = rt.get_input_handler("StockStream")
        ts, cols = feed(3 * 65536, GLOBAL_STRINGS.encode)
        for k in range(2):
            s = slice(k * 65536, (k + 1) * 65536)
            h.send_arrays(ts[s], [c[s] for c in cols])
        q = rt.queries["q"]
        s = slice(2 * 65536, 3 * 65536)
        batch = batch_from_columns(rt.schemas["StockStream"], ts[s],
                                   [c[s] for c in cols], capacity=65536,
                                   device=dev)
        now = torch.tensor(int(ts[s][-1]), dtype=torch.int64, device=dev)
        _ns, _out, wargs = W.window_args(q.operators[0], q.states[0], batch,
                                         now)
        res[which] = [cuda_ms(lambda: lib.window_step(wargs, stream),
                              reps=50) for _ in range(rounds)]
        rt.shutdown()
    return res


# -- kernels A (K5's second-wave kinds), B (the sort window), C
# (min/max over expiring content) and D (distinctCount) ---------------------

def _send_all(h, ts, cols, cuts):
    for a, b in zip(cuts[:-1], cuts[1:]):
        h.send_arrays(ts[a:b], [c[a:b] for c in cols])


# the second-wave paths' send sizes: window_ext_grouped sends 16,384 rows,
# since a key's ring (256 values) must hold its live rows (about 117)
# plus the adds of one send to it (128 a key at 65,536-row sends: the
# ring overflows)
WAVE2_SEND = {"window_ext_grouped": 16384, "window_ext_bars": 65536,
              "window_sort": 65536}


def _overflows(rt, qs) -> dict:
    """Each query's overflow count, with its parts (window, group table,
    aggregator tables), where it is not 0."""
    out = {}
    for qn in qs:
        st = rt.queries[qn].stats()
        if st["overflow"] != 0:
            sts = rt.queries[qn].states
            out[qn] = (st["overflow"], [int(x["overflow"]) for x in sts
                       if isinstance(x, dict) and "overflow" in x] +
                       [int(t["overflow"]) for x in sts if isinstance(x, dict)
                        for t in x.get("tables", ()) if t])
    return out


def wave2_against_plain(dev) -> float:
    """Kernels A-D against their plain versions on the card, bit for bit,
    state and output, at every step of: each comparison app of
    checks.WINDOW2_APPS (externalTime; timeLength where time and length
    each bind; delay; batch with L = 0 and L > 0; externalTimeBatch with
    a start constant, a start attribute, a timeout on a feed with quiet
    gaps, so that TIMER flushes fire, and replace.with.batchtime;
    hopping under both names; sort on int, long, float and double keys,
    asc and desc; min/max and distinctCount over time, length,
    externalTime and batch windows, grouped and ungrouped), on a feed
    with NaN, -NaN, +-0.0, +-inf and the integer extremes; a key past
    its 256-row ring; more (group, value) pairs than the 4,096-slot pair
    table; nulls (row sends); a join side on an externalTime window;
    and the three main apps at their main paths' send sizes (WAVE2_SEND:
    five sends of 16,384 rows for window_ext_grouped, past its one-minute
    window, so that the window is full and expires), overflow 0.
    -> max abs error (0)."""
    from siddhi_tpu_torch import Event, SiddhiManager, _kernels
    from siddhi_tpu_torch import checks as C
    from siddhi_tpu_torch.core.types import GLOBAL_STRINGS
    enc = GLOBAL_STRINGS.encode
    mgr = SiddhiManager()
    saved = dict(_kernels.LAUNCHES)
    with KernelCheck() as chk:
        for name, text in C.WINDOW2_APPS.items():
            rt = mgr.create_siddhi_app_runtime(text)
            rt.start()
            h = rt.get_input_handler("S")
            timers = "timeout" in name or "replace" in name
            ts, cols = C.window2_feed(600, enc, seed=3, quiet_every=40
                                      if timers else 0)
            cuts = tuple(range(0, 601, 40)) if timers else (0, 100, 356, 600)
            _send_all(h, ts, cols, cuts)
            st = rt.queries["q"].stats()
            rt.shutdown()
            print(f"kernels A-D, {name}: bit-equal to their plain versions "
                  f"(600 events; emitted {st['emitted']}, overflow "
                  f"{st['overflow']}; steps so far {chk.steps})", flush=True)
        for name, text, kw, cuts in (
                ("a key past its ring", C.RING_OVERFLOW_APP,
                 dict(n=2400, seed=6, n_syms=2), (0, 800, 1600, 2400)),
                ("more pairs than the pair table", C.PAIRS_OVERFLOW_APP,
                 dict(n=6000, seed=7, n_vols=1000), (0, 2000, 4000, 6000))):
            rt = mgr.create_siddhi_app_runtime(text)
            rt.start()
            ts, cols = C.window2_feed(encode=enc, **kw)
            _send_all(rt.get_input_handler("S"), ts, cols, cuts)
            st = rt.queries["q"].stats()
            rt.shutdown()
            if st["overflow"] == 0:
                fail(f"kernels C/D feed '{name}' did not overflow")
            print(f"kernels C/D, {name}: bit-equal to their plain versions "
                  f"(overflow {st['overflow']})", flush=True)
        # nulls: rows sent one at a time, a fifth of the values null
        rt = mgr.create_siddhi_app_runtime(
            C.WINDOW2_APPS["min/max over length, grouped"])
        rt.start()
        h = rt.get_input_handler("S")
        ts, cols = C.window2_feed(120, enc, seed=8, specials=False)
        rng = np.random.default_rng(8)
        for i in range(120):
            row = [GLOBAL_STRINGS.decode(int(cols[0][i]))] + \
                [c[i].item() for c in cols[1:]]
            row = [None if k > 0 and rng.random() < 0.2 else v
                   for k, v in enumerate(row)]
            h.send(Event(int(ts[i]), row))
        rt.shutdown()
        print("kernels C/D with nulls (120 row sends): bit-equal to their "
              "plain versions", flush=True)
        # a join side on an externalTime window
        rt = mgr.create_siddhi_app_runtime(C.EXT_JOIN_APP)
        rt.start()
        rng = np.random.default_rng(9)
        keys = np.array([enc(f"J{i}") for i in range(4)], np.int32)
        for k in range(3):
            t = C.TS0 + k * 100 + np.arange(64, dtype=np.int64)
            rt.get_input_handler("L").send_arrays(
                t, [keys[rng.integers(0, 4, 64)], t.copy(),
                    rng.integers(0, 9, 64).astype(np.int32)])
            rt.get_input_handler("R").send_arrays(
                t + 1, [keys[rng.integers(0, 4, 64)], t + 1,
                        rng.standard_normal(64)])
        rt.shutdown()
        print("kernel A on a join side (externalTime): bit-equal to its "
              "plain version", flush=True)
        for name, text, sends, qs in (
                ("window_ext_grouped", C.WINDOW_EXT_APP, 5, ("q",)),
                ("window_ext_bars", C.WINDOW_BARS_APP, 2,
                 ("bars", "breadth")),
                ("window_sort", C.WINDOW_SORT_APP, 1, ("q",))):
            send = WAVE2_SEND[name]
            rt = mgr.create_siddhi_app_runtime(text)
            rt.start()
            ts, cols = C.trades_feed(sends * send, enc, seed=5)
            _send_all(rt.get_input_handler("Trades"), ts, cols,
                      tuple(range(0, sends * send + 1, send)))
            st = {q: rt.queries[q].stats() for q in qs}
            ovf = _overflows(rt, qs)
            rt.shutdown()
            if ovf:
                fail(f"kernels A-D, {name} at its main path's sends: "
                     f"overflow {ovf}")
            print(f"kernels A-D, {name}, {sends} sends of {send} rows (its "
                  f"main path's): bit-equal to their plain versions, "
                  f"overflow 0 ({st})", flush=True)
    _kernels.LAUNCHES.update(saved)   # not launches of a main path
    print(f"kernels A-D: shapes held against the plain versions: "
          f"{sorted((x for x in chk.shapes if x[0] != 'K6'), key=str)}; "
          f"steps {chk.steps}", flush=True)
    return chk.err


def _nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _buf_tensors(buf):
    return [buf["ts"], buf["seq"], *buf["cols"], *buf["nulls"], buf["valid"]]


def wave2_phase(dev, card: str, which: str, N: int = 0,
                SEND: int = 0) -> dict:
    """window_ext_grouped (kernels A and C), window_ext_bars (A and D, and
    K6's batch-mode min/max) or window_sort (B) end to end on the card
    through SiddhiManager, send_arrays and batch_callbacks: 1,048,576
    events in 16 sends of 65,536 rows (window_ext_grouped: 64 sends of
    16,384; window_sort: 262,144 events in 4 sends),
    checked against the independent numpy oracle of checks.py, overflow
    0; the launch counters must show K1 on every send and the path's
    kernels on every step; then events/s, per-send latency at the path's
    send size and at 1,024 rows (overflow still 0), and each of the path's new kernels' device time at this
    path's shapes against its plain version and its bound."""
    from siddhi_tpu_torch import SiddhiManager, _kernels
    from siddhi_tpu_torch import checks as C
    from siddhi_tpu_torch.core.event import batch_from_columns
    from siddhi_tpu_torch.core.types import GLOBAL_STRINGS
    from siddhi_tpu_torch.ops import aggregators as G
    from siddhi_tpu_torch.ops import windows as W
    from siddhi_tpu_torch.ops import windows2 as W2
    N = N or ((1 << 18) if which == "window_sort" else (1 << 20))
    SEND = SEND or WAVE2_SEND[which]
    text, qs = {"window_ext_grouped": (C.WINDOW_EXT_APP, ("q",)),
                "window_ext_bars": (C.WINDOW_BARS_APP, ("bars", "breadth")),
                "window_sort": (C.WINDOW_SORT_APP, ("q",))}[which]
    enc = GLOBAL_STRINGS.encode
    mgr = SiddhiManager(device="cuda")
    wtext = text
    for qn in qs:
        wtext = wtext.replace(f"'{qn}'", f"'w{qn}'")
    warm = mgr.create_siddhi_app_runtime(wtext)
    warm.start()
    wts, wcols = C.trades_feed(2 * SEND, enc, seed=3)
    _send_all(warm.get_input_handler("Trades"), wts, wcols, (0, SEND,
                                                             2 * SEND))
    torch.cuda.synchronize()
    warm.shutdown()

    rt = mgr.create_siddhi_app_runtime(text)
    if rt.device.type != "cuda":
        fail(f"the {which} runtime is on {rt.device}, not the card")
    outs = {qn: [] for qn in qs}
    for qn in qs:
        rt.queries[qn].batch_callbacks.append(outs[qn].append)
    rt.start()
    h = rt.get_input_handler("Trades")
    extra = 10 * 65536 + 70 * 1024
    ts_all, cols_all = C.trades_feed(N + extra, enc)
    _kernels.reset_launches()
    t0 = time.perf_counter()
    for s in range(0, N, SEND):
        h.send_arrays(ts_all[s:s + SEND], [c[s:s + SEND] for c in cols_all])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_kernels.LAUNCHES)
    steps = {qn: len(outs[qn]) for qn in qs}
    total = sum(steps.values())
    want = {"unpack_packed": N // SEND * len(qs), "aggregate_step": 0
            if which == "window_sort" else total}
    if which == "window_ext_grouped":
        want.update(window_step=total, sliding_minmax=2 * total)
    elif which == "window_ext_bars":
        want.update(window_step=total, distinct_count=steps["breadth"])
    else:
        want.update(sort_window=total, window_step=0)
    for k, n in want.items():
        if launches[k] != n or (n == 0 and k not in ("aggregate_step",
                                                     "window_step")):
            fail(f"{which} path: kernel {k} launched {launches[k]} times, "
                 f"expected {n} (steps {steps})")
    if which != "window_sort" and launches["expr_eval"] == 0:
        fail(f"{which} path: K2 never launched")
    ets, sym, price, vol = (c[:N] for c in cols_all)

    def got(qn):
        q = rt.queries[qn]
        o = outs[qn]
        return ([torch.cat([b.cols[i][b.valid] for b in o]).cpu().numpy()
                 for i in range(len(q.out_schema.types))],
                torch.cat([b.kind[b.valid] for b in o]).cpu().numpy())
    stats = {qn: rt.queries[qn].stats() for qn in qs}
    ovf = _overflows(rt, qs)
    if ovf:
        fail(f"{which}: overflow (query: count, [window, group table, "
             f"aggregator tables]) {ovf}; the oracle assumes none")
    detail = ""
    if which == "window_ext_grouped":
        o_sym, hi, lo, ap, n = C.window_ext_oracle(ets, sym, price)
        (g_sym, g_hi, g_lo, g_ap, g_n), _k = got("q")
        ok = len(g_ap) == len(ap) and np.array_equal(g_sym, o_sym) and \
            np.array_equal(bits_np(g_hi), bits_np(hi)) and \
            np.array_equal(bits_np(g_lo), bits_np(lo)) and \
            np.array_equal(g_n, n)
        rel = float(np.max(np.abs(g_ap - ap) / np.abs(ap))) if ok else None
        ok = ok and rel <= 1e-12
        rows = len(ap)
        detail = f"ap within {rel} relative (limit 1e-12)"
    elif which == "window_ext_bars":
        (o_bars, o_br) = C.window_bars_oracle(ets, sym, price, vol)
        g_bars, _k = got("bars")
        g_br, _k2 = got("breadth")
        ok = all(len(a) == len(b) and np.array_equal(bits_np(a), bits_np(b))
                 for a, b in zip(g_bars, o_bars)) and \
            all(np.array_equal(a, b) for a, b in zip(g_br, o_br))
        rows = len(o_bars[0]) + len(o_br[0])
        detail = (f"{len(o_bars[0])} bar rows, {len(o_br[0])} breadth rows; "
                  f"distinct symbols a bar up to {int(o_br[0].max())}")
    else:
        o_exp, o_sym, o_price, o_vol = C.window_sort_oracle(sym, price, vol)
        (g_sym, g_price, g_vol), g_kind = got("q")
        ok = len(g_kind) == len(o_exp) and \
            np.array_equal(g_kind == 1, o_exp) and \
            np.array_equal(g_sym, o_sym) and \
            np.array_equal(bits_np(g_price), bits_np(o_price)) and \
            np.array_equal(g_vol, o_vol)
        rows = len(o_exp)
    emitted = sum(st["emitted"] for st in stats.values())
    if not ok or emitted != rows:
        fail(f"{which}: rows differ from the numpy oracle ({emitted} "
             f"emitted, the oracle {rows}; {detail})")
    eps = N / wall
    print(f"{which}: {N} events in {N // SEND} sends of {SEND}; {rows} rows "
          f"equal the numpy oracle (exact columns exact; {detail}); "
          f"overflow 0; {eps:.0f} events/s, device batches only ({card})",
          flush=True)
    print(f"launches on the {which} path: {launches}", flush=True)

    k_next = N

    def chunk(m):
        nonlocal k_next
        s = slice(k_next, k_next + m)
        k_next += m
        return ts_all[s], [c[s] for c in cols_all]

    def latency(m, reps):
        h.send_arrays(*chunk(m))
        torch.cuda.synchronize()
        lat = []
        for _ in range(reps):
            c0 = time.perf_counter()
            h.send_arrays(*chunk(m))
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - c0) * 1e3)
        return float(np.percentile(lat, 50)), float(np.percentile(lat, 99))

    # at the path's own send size (window_ext_grouped's rings overflow at
    # 65,536 rows), then 1,024; the configuration holds: overflow 0
    p50, p99 = latency(SEND, 4 if which == "window_sort" else 8)
    p50k, p99k = latency(1024, 64)
    ovf = _overflows(rt, qs)
    if ovf:
        fail(f"{which}: overflow after the latency sends {ovf}")
    print(f"{which} latency per send: {SEND} rows p50 {p50:.3f} ms, p99 "
          f"{p99:.3f} ms; 1,024 rows p50 {p50k:.3f} ms, p99 {p99k:.3f} ms; "
          f"overflow 0 ({card})", flush=True)

    # the path's new kernels at its shapes, from the live state: one step
    # of the path's send size, the launches alone (arguments built once)
    ts_c, cols_c = chunk(SEND)
    batch = batch_from_columns(rt.schemas["Trades"], ts_c, cols_c,
                               capacity=SEND, device=dev)
    now = torch.tensor(int(ts_c[-1]), dtype=torch.int64, device=dev)
    lib = _kernels.load()
    stream = torch.cuda.current_stream().cuda_stream
    res = {"events_per_s_device_batches": eps, "send": SEND,
           "p50_ms_send": p50, "p99_ms_send": p99, "p50_ms_1024": p50k,
           "p99_ms_1024": p99k,
           "rows": rows, "launches": launches, "card": card}
    row_bytes = sum(c.element_size() + 1 for c in batch.cols) + 8 + 4 + 1
    if which == "window_sort":
        q = rt.queries["q"]
        op, st = q.operators[0], q.states[0]
        _ns, sout, sargs = W2.sort_args(op, st, batch, now)
        b_ms = cuda_ms(lambda: lib.sort_window(sargs, stream), reps=3,
                       warmup=1)
        b_plain = cuda_ms(lambda: W2.sort_window_step_ref(op, st, batch, now),
                          reps=1, warmup=0)
        cur = int((batch.valid & (batch.kind == 0)).sum())
        n_bytes = SEND * row_bytes + 2 * _nbytes(_buf_tensors(st["buf"])) + \
            _nbytes([sout.ts, sout.kind, sout.valid, *sout.cols,
                     *sout.nulls])
        n_ops = cur * st["buf"]["seq"].shape[0] * (len(op.keys) + 2)
        bound, by = bound_of(n_bytes, n_ops)
        print(f"sort_window (kernel B): {b_ms:.3f} ms a {SEND}-row send "
              f"(buffer {op.L + 1} rows, one block walking the rows); "
              f"plain version {b_plain:.1f} ms; bound {bound:.5f} ms "
              f"({n_bytes} bytes, {n_ops} operations: {by}); {card}",
              flush=True)
        res.update(b_ms=b_ms, b_plain_ms=b_plain, b_bound_ms=bound,
                   b_bound_by=by)
    else:
        qn = "q" if which == "window_ext_grouped" else "breadth"
        q = rt.queries[qn]
        wop, aop = q.operators[0], q.operators[-1]
        wst, ast = q.states[0], q.states[-1]
        _ws, wout, wargs = W.window_args(wop, wst, batch, now)
        lib.window_step(wargs, stream)

        def col(ce):
            i = G._bare_column(ce)
            return wout.cols[i], wout.nulls[i]
        key_cols = [col(ke) for ke in aop.key_exprs]
        arg_cols = [col(a) if a is not None else None for a in aop.agg_args]
        _sl, _ag, _as, aargs, stats_k = G.agg_args(
            aop, ast, key_cols, arg_cols, wout.kind, wout.valid)
        lib.aggregate_step(aargs, stream, 1)
        ctx = G.agg_context(aop, ast, key_cols, wout.kind, wout.valid)[0]
        # the stateful aggregators: spec, kernel arguments, argument, table
        idx = [i for i, sp in enumerate(aop.agg_specs)
               if getattr(sp, "stateful", False)]
        specs = [(sp, st_, arg_cols[i], ast["tables"][i])
                 for i, (sp, st_) in zip(idx, stats_k)]
        kern = lib.sliding_minmax if which == "window_ext_grouped" \
            else lib.distinct_count
        x_ms = cuda_ms(lambda: [kern(aargs, st_, stream)
                                for _s, st_, _a, _t in specs], reps=20)
        x_plain = cuda_ms(lambda: [sp.run_ref(a_, ctx, t_)
                                   for sp, _st, a_, t_ in specs],
                          reps=2, warmup=1)
        Bo = wout.capacity
        tab_bytes = sum(_nbytes(list(t_.values())) for *_x, t_ in specs)
        arg_bytes = sum(_nbytes([a_[0], a_[1]]) for _s, _st, a_, _t in specs)
        x_bytes = arg_bytes + 2 * tab_bytes + Bo * (4 + 8 + 4 + 1) + \
            len(specs) * Bo * 16
        x_ops = len(specs) * Bo * 40
        x_bound, x_by = bound_of(x_bytes, x_ops)
        kname = "sliding_minmax (kernel C)" if which == "window_ext_grouped" \
            else "distinct_count (kernel D)"
        print(f"{kname}, {which}: {x_ms:.5f} ms a step ({len(specs)} "
              f"aggregators, {Bo} rows, K {aop.K}); plain version "
              f"{x_plain:.3f} ms; bound {x_bound:.5f} ms ({x_bytes} bytes: "
              f"{x_by}); {card}", flush=True)
        res.update(x_ms=x_ms, x_plain_ms=x_plain, x_bound_ms=x_bound,
                   x_bound_by=x_by)
        if which == "window_ext_grouped":
            a_ms = cuda_ms(lambda: lib.window_step(wargs, stream), reps=20)
            a_plain = cuda_ms(lambda: W.window_step_ref(wop, wst, batch, now),
                              reps=2, warmup=1)
            keys = wargs._keep[3]["keys"].clone()
            lib_ms = cuda_ms(lambda: torch.sort(keys, stable=True), reps=20)
            a_bytes = SEND * row_bytes + 2 * _nbytes(
                _buf_tensors(wst["buf"])) + _nbytes(
                [wout.ts, wout.kind, wout.valid, *wout.cols, *wout.nulls])
            a_bound, a_by = bound_of(a_bytes, 0)
            print(f"window_step (kernel A, externalTime), {which}: "
                  f"{a_ms:.5f} ms a {SEND}-row step (output {Bo} rows, "
                  f"window {wst['buf']['seq'].shape[0]} rows); plain "
                  f"version {a_plain:.3f} ms; torch.sort(stable=True) of the "
                  f"emission keys {lib_ms:.5f} ms; bound {a_bound:.5f} ms "
                  f"({a_bytes} bytes); {card}", flush=True)
            res.update(a_ms=a_ms, a_plain_ms=a_plain, a_bound_ms=a_bound,
                       a_library_ms=lib_ms)
    _kernels.LAUNCHES.update(launches)   # timing launches: not the path's
    rt.shutdown()
    del outs
    gc.collect()
    print(json.dumps({which: res}), flush=True)
    return res


def bits_np(a):
    """A float array as its bits (NaN payloads and -0.0 compare exactly);
    other arrays as they are."""
    if a.dtype.kind == "f":
        return a.view(np.int64 if a.itemsize == 8 else np.int32)
    return a


def seq2_phase(dev, card: str, m: int = 65536, n_chunks: int = 4) -> dict:
    """bench.py's seq2 (`bench_seq2`, its app and feed verbatim) end to
    end on the card at the bench's own sizes: 4 chunks of 65,536 orders
    and 65,536 payments (524,288 events), through SiddhiManager,
    send_arrays and batch_callbacks, checked against the independent
    numpy oracle of checks.py (at these sizes the one start, without
    `every`, expires before the first payment: no row), overflow 0; the
    same at 1,024-row chunks, where the oracle's one row must come; the
    launch counters must show K1 on every send and K3; then events/s and
    per-send latency at 65,536 and 1,024 rows. -> the path's numbers."""
    from siddhi_tpu_torch import SiddhiManager, _kernels
    from siddhi_tpu_torch import checks as C
    mgr = SiddhiManager(device="cuda")

    def run(text, chunks, qn="q"):
        rt = mgr.create_siddhi_app_runtime(text)
        if rt.device.type != "cuda":
            fail(f"the seq2 runtime is on {rt.device}, not the card")
        q = rt.queries[qn]
        outs = []
        q.batch_callbacks.append(outs.append)
        rt.start()
        ho, hp = rt.get_input_handler("OrderS"), rt.get_input_handler("PayS")
        t0 = time.perf_counter()
        for ts, oid, amt, pts, pid, poid in chunks:
            ho.send_arrays(ts, [oid, amt])
            hp.send_arrays(pts, [pid, poid])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rows = [(int(o.cols[0][k]), int(o.cols[1][k])) for o in outs
                for k in torch.nonzero(o.valid).flatten().tolist()]
        return rt, q, ho, hp, rows, wall

    warm = run(C.SEQ2_APP.replace("'q'", "'w'"), C.seq2_chunks(1, m, 3), "w")
    warm[0].shutdown()
    small = C.seq2_chunks(4, 1024)
    rt, q, _ho, _hp, rows, _w = run(C.SEQ2_APP, small)
    want = C.seq2_oracle(small)
    if rows != want or len(want) != 1 or q.stats()["overflow"] != 0:
        fail(f"seq2 at 1,024-row chunks: rows {rows}, the oracle {want} "
             f"({q.stats()})")
    rt.shutdown()
    chunks = C.seq2_chunks(n_chunks + 8 + 64, m)
    _kernels.reset_launches()
    rt, q, ho, hp, rows, wall = run(C.SEQ2_APP, chunks[:n_chunks])
    launches = dict(_kernels.LAUNCHES)
    want = C.seq2_oracle(chunks[:n_chunks])
    stats = q.stats()
    n_events = 2 * n_chunks * m
    if launches["unpack_packed"] != 2 * n_chunks or \
            launches["nfa_parallel"] == 0:
        fail(f"seq2 path: launches {launches}, expected K1 {2 * n_chunks} "
             f"(one per send) and K3")
    if rows != want or stats["overflow"] != 0 or stats["emitted"] != len(want):
        fail(f"seq2: rows {rows}, the oracle {want}; {stats}")
    eps = n_events / wall
    print(f"seq2: {n_events} events in {n_chunks} chunks of {m} orders and "
          f"{m} payments; rows {rows} equal the numpy oracle's (the one "
          f"start expires unmatched; at 1,024-row chunks its one row "
          f"{C.seq2_oracle(small)} came); overflow 0; {eps:.0f} events/s, "
          f"device batches only ({card})", flush=True)
    print(f"launches on the seq2 path: {launches}", flush=True)
    nxt = n_chunks

    def lat(rows_per_send, reps):
        nonlocal nxt
        out = []
        for _ in range(reps):
            ts, oid, amt, pts, pid, poid = chunks[nxt]
            nxt += 1
            for h, a, b in ((ho, ts, [oid, amt]), (hp, pts, [pid, poid])):
                a, b = a[:rows_per_send], [c[:rows_per_send] for c in b]
                c0 = time.perf_counter()
                h.send_arrays(a, b)
                torch.cuda.synchronize()
                out.append((time.perf_counter() - c0) * 1e3)
        return float(np.percentile(out, 50)), float(np.percentile(out, 99))
    p50, p99 = lat(m, 8)
    p50k, p99k = lat(1024, 64)
    print(f"seq2 latency per send: 65,536 rows p50 {p50:.3f} ms, p99 "
          f"{p99:.3f} ms; 1,024 rows p50 {p50k:.3f} ms, p99 {p99k:.3f} ms "
          f"({card})", flush=True)
    _kernels.LAUNCHES.update(launches)
    rt.shutdown()
    res = {"events_per_s_device_batches": eps, "p50_ms_65536": p50,
           "p99_ms_65536": p99, "p50_ms_1024": p50k, "p99_ms_1024": p99k,
           "launches": launches, "card": card}
    print(json.dumps({"seq2": res}), flush=True)
    return res


def kleene_phase(dev, card: str, m: int = 65536, n_chunks: int = 4) -> dict:
    """bench.py's kleene (`bench_kleene`, its app and feed verbatim: K3's
    counting states) end to end on the card at the bench's own sizes: 4
    chunks of 65,536 A and 65,536 B events (524,288 events), through
    SiddhiManager, send_arrays and batch_callbacks, checked against the
    independent numpy oracle of checks.py, which models the pattern
    table's 4,096 rows: the rows and the lost count must be the
    oracle's (at these sizes most runs find the table full); the same at
    1,024-row chunks, where nothing is lost; the launch counters must
    show K1 on every send and K3; then events/s and per-send latency at
    65,536 and 1,024 rows. -> the path's numbers."""
    from siddhi_tpu_torch import SiddhiManager, _kernels
    from siddhi_tpu_torch import checks as C
    mgr = SiddhiManager(device="cuda")

    def run(text, chunks, qn="q"):
        rt = mgr.create_siddhi_app_runtime(text)
        if rt.device.type != "cuda":
            fail(f"the kleene runtime is on {rt.device}, not the card")
        q = rt.queries[qn]
        outs = []
        q.batch_callbacks.append(outs.append)
        rt.start()
        ha, hb = rt.get_input_handler("A"), rt.get_input_handler("B")
        t0 = time.perf_counter()
        for ta, a, tb, b in chunks:
            ha.send_arrays(ta, [a])
            hb.send_arrays(tb, [b])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rows = [(int(o.ts[k]), int(o.cols[0][k]), int(o.cols[1][k]))
                for o in outs for k in torch.nonzero(o.valid).flatten().tolist()]
        return rt, q, ha, hb, rows, wall

    warm = run(C.KLEENE_APP.replace("'q'", "'w'"), C.kleene_chunks(1, m, 3),
               "w")
    warm[0].shutdown()
    small = C.kleene_chunks(4, 1024)
    rt, q, _ha, _hb, rows, _w = run(C.KLEENE_APP, small)
    want, lost = C.kleene_oracle(small)
    if rows != want or lost != 0 or q.stats()["overflow"] != 0:
        fail(f"kleene at 1,024-row chunks: {len(rows)} rows, the oracle "
             f"{len(want)} (equal: {rows == want}); {q.stats()}")
    rt.shutdown()
    n_small = len(want)
    chunks = C.kleene_chunks(n_chunks + 8 + 64, m)
    _kernels.reset_launches()
    rt, q, ha, hb, rows, wall = run(C.KLEENE_APP, chunks[:n_chunks])
    launches = dict(_kernels.LAUNCHES)
    want, lost = C.kleene_oracle(chunks[:n_chunks])
    stats = q.stats()
    n_events = 2 * n_chunks * m
    if launches["unpack_packed"] != 2 * n_chunks or \
            launches["nfa_parallel"] == 0:
        fail(f"kleene path: launches {launches}, expected K1 "
             f"{2 * n_chunks} (one per send) and K3")
    if rows != want or stats["overflow"] != lost or \
            stats["emitted"] != len(want):
        fail(f"kleene: {len(rows)} rows, the oracle {len(want)} (equal: "
             f"{rows == want}); lost {stats['overflow']}, the oracle {lost}")
    eps = n_events / wall
    print(f"kleene: {n_events} events in {n_chunks} chunks of {m} A and {m} "
          f"B events; {len(rows)} rows and {lost} runs lost to the full "
          f"4,096-row table equal the numpy oracle's (at 1,024-row chunks "
          f"{n_small} rows, none lost); {eps:.0f} events/s, device batches "
          f"only ({card})", flush=True)
    print(f"launches on the kleene path: {launches}", flush=True)
    nxt = n_chunks

    def lat(rows_per_send, reps):
        nonlocal nxt
        out = []
        for _ in range(reps):
            ta, a, tb, b = chunks[nxt]
            nxt += 1
            for h, t, v in ((ha, ta, a), (hb, tb, b)):
                c0 = time.perf_counter()
                h.send_arrays(t[:rows_per_send], [v[:rows_per_send]])
                torch.cuda.synchronize()
                out.append((time.perf_counter() - c0) * 1e3)
        return float(np.percentile(out, 50)), float(np.percentile(out, 99))
    p50, p99 = lat(m, 8)
    p50k, p99k = lat(1024, 64)
    print(f"kleene latency per send: 65,536 rows p50 {p50:.3f} ms, p99 "
          f"{p99:.3f} ms; 1,024 rows p50 {p50k:.3f} ms, p99 {p99k:.3f} ms "
          f"({card})", flush=True)
    _kernels.LAUNCHES.update(launches)
    rt.shutdown()
    res = {"events_per_s_device_batches": eps, "p50_ms_65536": p50,
           "p99_ms_65536": p99, "p50_ms_1024": p50k, "p99_ms_1024": p99k,
           "rows": len(rows), "lost": lost, "launches": launches,
           "card": card}
    print(json.dumps({"kleene": res}), flush=True)
    return res


# -- kernels K7 and K8: joins and tables --------------------------------------

class JoinTableCheck:
    """While installed, every K7 launch (join_probe, join_grid) and every
    K8 launch (table_write, table_match, table_probe, table_buffer) the
    runtime makes on the card also runs the plain version on the same
    inputs; outputs, valid masks, lost-pair counts and whole table states
    (next_seq and overflow included) must be bit-equal (tolerance 0). The
    runtime goes on with the kernel's results."""

    def __init__(self):
        from siddhi_tpu_torch.ops import join as JN
        from siddhi_tpu_torch.ops import table as TB
        self.JN, self.TB = JN, TB
        self.err = 0.0
        self.steps = {k: 0 for k in ("join_probe", "join_grid",
                                     "table_write", "table_match",
                                     "table_probe", "table_buffer")}

    def _eq(self, what, got, want):
        self.err = max(self.err, compare(what, tree_leaves(got),
                                         tree_leaves(want)))

    def __enter__(self):
        JN, TB = self.JN, self.TB
        self.saved = (JN.join_probe, JN.join_grid, TB.table_write,
                      TB.table_match, TB.probe_touched, TB.table_buffer)
        k_probe, k_grid, k_write, k_match, k_tprobe, k_buf = self.saved

        def batch(o):
            return [o.ts, list(o.cols), list(o.nulls), o.kind, o.valid]

        def join_probe(cross, trig, opp, gate=False):
            ko, kl = k_probe(cross, trig, opp, gate)
            ro, rl = JN.cross_probe_ref(cross, trig, opp, gate)
            self._eq(f"K7 join_probe B={trig.capacity}", [batch(ko), kl],
                     [batch(ro), rl])
            self.steps["join_probe"] += 1
            return ko, kl

        def join_grid(cross, trig, opp, gate=False):
            ko, kl = k_grid(cross, trig, opp, gate)
            ro, rl = JN.cross_grid_ref(cross, trig, opp, gate)
            self._eq(f"K7 join_grid B={trig.capacity}", [batch(ko), kl],
                     [batch(ro), rl])
            self.steps["join_grid"] += 1
            return ko, kl

        def table_write(table, state, b, mask):
            k = k_write(table, state, b, mask)
            self._eq("K8 table_write", k,
                     TB.table_write_ref(table, state, b, mask))
            self.steps["table_write"] += 1
            return k

        def table_match(table, state, b, acting, cond, sets=None,
                        set_cols=(), delete=False):
            k = k_match(table, state, b, acting, cond, sets, set_cols,
                        delete)
            r = TB.table_match_ref(table, state, b, acting, cond, sets,
                                   set_cols, delete)
            if sets is None and not delete:
                self._eq("K8 table_match (hits)", k[1], r[1])
            else:
                self._eq("K8 table_match", list(k), list(r))
            self.steps["table_match"] += 1
            return k

        def probe_touched(table, state, probe, b, acting):
            k = k_tprobe(table, state, probe, b, acting)
            self._eq("K8 table_probe", list(k), list(
                TB.probe_touched_ref(table, state, probe, b, acting)))
            self.steps["table_probe"] += 1
            return k

        def table_buffer(state):
            k = k_buf(state)
            self._eq("K8 table_buffer", k, TB.table_buffer_ref(state))
            self.steps["table_buffer"] += 1
            return k

        (JN.join_probe, JN.join_grid, TB.table_write, TB.table_match,
         TB.probe_touched, TB.table_buffer) = (
            join_probe, join_grid, table_write, table_match,
            probe_touched, table_buffer)
        return self

    def __exit__(self, *exc):
        JN, TB = self.JN, self.TB
        (JN.join_probe, JN.join_grid, TB.table_write, TB.table_match,
         TB.probe_touched, TB.table_buffer) = self.saved
        return False


class Router:
    """send_arrays over several streams of one app, in turn (the join
    paths alternate StockStream and TwitterStream)."""

    def __init__(self, rt, streams):
        self.hs = [rt.get_input_handler(s) for s in streams]
        self.i = 0

    def send_arrays(self, ts, cols):
        h = self.hs[self.i % len(self.hs)]
        self.i += 1
        h.send_arrays(ts, cols)


def k78_against_plain(dev) -> float:
    """Phase 12: kernels K7 and K8 against their plain versions on the
    card, bit for bit, at every launch of: each app of checks.JOIN_APPS
    under both K7 entry points (inner, left, right and full outer joins,
    unidirectional, a windowless side, a residual conjunct, a non-equi
    ON, no ON, an expression key, JOIN_CAP and candidate overflow, an
    aggregating selector, the float-key traps: +-0.0, NaN of both signs,
    +-inf, subnormals, LONG against DOUBLE), each app of checks.TABLE_APPS
    (insert, deletes through the condition pass and through @Index,
    updates with and without SET, update or insert, primary-key
    duplicates in one batch, IN-table filters, a table past its
    capacity), and the three main configurations at 8,192-row sends from
    live states (join, join_eq, the grid pass, stock_table).
    -> max abs error (0)."""
    import os
    from siddhi_tpu_torch import Event, SiddhiManager, _kernels
    from siddhi_tpu_torch import checks as C
    from siddhi_tpu_torch.core.types import GLOBAL_STRINGS
    saved = dict(_kernels.LAUNCHES)
    mgr = SiddhiManager(device="cuda")
    env = "SIDDHI_TPU_JOIN_KERNEL"
    with JoinTableCheck() as chk:
        for name in sorted(C.JOIN_APPS):
            for kernel in ("probe", "grid"):
                os.environ[env] = kernel
                rt = mgr.create_siddhi_app_runtime(C.JOIN_APPS[name])
                rt.start()
                for stream, rows in C.join_shape_feed(name, 90, seed=3):
                    rt.get_input_handler(stream).send(
                        [Event(ts, tuple(r)) for ts, r in rows])
                q = rt.queries["q"]
                if name == "join_cap" and q.overflow == 0:
                    fail("K7 feed 'join_cap' lost no pair")
                rt.shutdown()
        print(f"K7 against its plain version: {len(C.JOIN_APPS)} apps under "
              f"both entry points bit-equal (steps {chk.steps})", flush=True)
        os.environ.pop(env, None)
        for name in sorted(C.TABLE_APPS):
            rt = mgr.create_siddhi_app_runtime(C.TABLE_APPS[name])
            rt.start()
            for stream, rows in C.table_shape_feed(80, seed=3):
                rt.get_input_handler(stream).send(
                    [Event(ts, tuple(r)) for ts, r in rows])
            if name == "over_capacity" and \
                    int(rt.tables["T"].state["overflow"]) == 0:
                fail("K8 feed 'over_capacity' did not overflow")
            rt.shutdown()
        print(f"K8 against its plain version: {len(C.TABLE_APPS)} apps "
              f"bit-equal (steps {chk.steps})", flush=True)
        # the main configurations at their shapes, from live states
        for label, n_syms, kernel, sends in (
                ("join", C.JOIN_SYMS, None, 3),
                ("join_eq", C.JOIN_EQ_SYMS, None, 3),
                ("join on the grid", C.JOIN_SYMS, "grid", 2)):
            if kernel:
                os.environ[env] = kernel
            rt = mgr.create_siddhi_app_runtime(C.JOIN_APP)
            rt.start()
            r = Router(rt, ("StockStream", "TwitterStream"))
            for ts, sym, price, tweets in C.join_feed(
                    n_syms, sends, SEND_ROWS, GLOBAL_STRINGS.encode, seed=5):
                r.send_arrays(ts, [sym, price])
                r.send_arrays(ts, [sym, tweets])
            st = rt.queries["q"].stats()
            rt.shutdown()
            os.environ.pop(env, None)
            print(f"K7 {label}, {sends} sends of 8,192 rows a side: "
                  f"bit-equal (emitted {st['emitted']}, overflow "
                  f"{st['overflow']}; steps {chk.steps})", flush=True)
        rt = mgr.create_siddhi_app_runtime(C.STOCK_TABLE_APP)
        rt.start()
        for stream, ts, cols in C.stock_table_feed(
                C.STOCK_SYMS, 2, SEND_ROWS, GLOBAL_STRINGS.encode, seed=5):
            rt.get_input_handler(stream).send_arrays(ts, cols)
        # on-demand queries over the card's table (K8's view, K2)
        st = rt.tables["StockTable"].state
        want = int((st["valid"] & (st["cols"][2] > 500000)).sum())
        got = len(rt.query("from StockTable on volume > 500000L "
                           "select symbol, volume"))
        n_all = len(rt.query("from StockTable select *"))
        if got != want or n_all != C.STOCK_SYMS:
            fail(f"on-demand queries on the card: {got} rows (want {want}), "
                 f"{n_all} in all (want {C.STOCK_SYMS})")
        rt.shutdown()
        print(f"K7/K8 stock_table, a load and 2 rounds of 8,192-row sends: "
              f"bit-equal (steps {chk.steps}); on-demand queries over the "
              f"table equal its state", flush=True)
    if not all(chk.steps.values()):
        fail(f"an entry point of K7 or K8 was never compared: {chk.steps}")
    _kernels.LAUNCHES.update(saved)   # not launches of a main path
    return chk.err


def _join_kernel_times(rt, q, dev, ts_c, sym_c, price_c, kernel: str):
    """K7 at the path's shape: the StockStream side's window output for
    one more 8,192-row send against the live TwitterStream window. ->
    (ms, plain ms, library ms, bytes)."""
    from siddhi_tpu_torch import _kernels
    from siddhi_tpu_torch.core.event import batch_from_columns
    from siddhi_tpu_torch.ops import join as JN
    from siddhi_tpu_torch.ops import table as TB
    from siddhi_tpu_torch.ops import windows as W
    saved = dict(_kernels.LAUNCHES)
    batch = batch_from_columns(rt.schemas["StockStream"], ts_c,
                               [sym_c, price_c], capacity=SEND_ROWS,
                               device=dev)
    now = torch.tensor(int(ts_c[-1]), dtype=torch.int64, device=dev)
    _st, trig = W.window_step(q.side_ops["L"][-1], q.side_states["L"][-1],
                              batch, now)
    opp = q.side_ops["R"][-1].findable_buffer(q.side_states["R"][-1])
    cross = q.crosses["L"]
    probe = kernel == "probe"
    out, lost, args = JN.join_args(cross, trig, opp, True, probe)
    lib = _kernels.load()
    stream = torch.cuda.current_stream().cuda_stream
    launch = lib.join_probe if probe else lib.join_grid
    ms = cuda_ms(lambda: launch(args, stream), reps=20)
    ref = JN.cross_probe_ref if probe else JN.cross_grid_ref
    plain = cuda_ms(lambda: ref(cross, trig, opp, True), reps=2, warmup=1)
    okeys = TB.encode_keys(opp["cols"][0], cross.equi.key_type)
    tkeys = TB.encode_keys(trig.cols[0], cross.equi.key_type)

    def library():
        sk, _o = torch.sort(okeys, stable=True)
        torch.searchsorted(sk, tkeys, right=False)
        torch.searchsorted(sk, tkeys, right=True)
    lib_ms = cuda_ms(library, reps=20)
    _kernels.LAUNCHES.update(saved)

    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)
    n_bytes = nbytes([trig.ts, trig.kind, trig.valid, *trig.cols,
                      *trig.nulls, opp["ts"], opp["valid"], *opp["cols"],
                      *opp["nulls"], out.ts, out.kind, out.valid, *out.cols,
                      *out.nulls, lost])
    # the operations this run's inputs need: the probe sorts the window
    # (a pass a key byte and the dead-row pass), bisects twice a trigger
    # row, evaluates every candidate slot and places every output slot;
    # the grid compares and masks every (joinable row, window row) pair
    B, W = trig.capacity, opp["ts"].shape[0]
    if probe:
        passes = 8 if cross.equi.key_type.value in ("long", "double") else 4
        n_ops = W * (passes + 1) + 2 * B * TB.search_levels(W) + \
            (cross.cand_cap if cross.need_residual(True) else 0) + cross.cap
    else:
        joinable = int((trig.valid & ((trig.kind == 0) | (trig.kind == 1)))
                       .sum())
        n_ops = 2 * joinable * W + cross.cap
    return ms, plain, lib_ms, n_bytes, n_ops, B, W


def join_phase(dev, card: str, which: str, sends: int = JOIN_SENDS,
               kernel: str = "probe", probe_rows=None) -> dict:
    """Phases 13 to 15: bench.py's join app end to end on the card through
    SiddhiManager, send_arrays and batch_callbacks, ``sends`` sends of
    8,192 rows a side (StockStream then TwitterStream), the bench's feed
    with 1,024 symbols (join) or 8,192 (join_eq), checked against the
    numpy oracle of checks.py with no pair lost; the launch counters must
    show K1 on every send and K5, K7 and K2 on every side step; then
    events/s, per-send latency at 8,192 and 1,024 rows, a torch.profiler
    split, and K7's time per step against its plain version, its byte
    bound and torch.sort + torch.searchsorted. With kernel="grid" (the
    grid pass) the rows must equal ``probe_rows``. -> the path's numbers."""
    import os
    from siddhi_tpu_torch import SiddhiManager, _kernels
    from siddhi_tpu_torch import checks as C
    from siddhi_tpu_torch.core.types import GLOBAL_STRINGS
    env = "SIDDHI_TPU_JOIN_KERNEL"
    if kernel == "grid":
        os.environ[env] = "grid"
    else:
        os.environ.pop(env, None)
    n_syms = C.JOIN_SYMS if which != "join_eq" else C.JOIN_EQ_SYMS
    SEND = SEND_ROWS
    mgr = SiddhiManager(device="cuda")
    warm = mgr.create_siddhi_app_runtime(C.JOIN_APP.replace("'q'", "'w'"))
    warm.start()
    wr = Router(warm, ("StockStream", "TwitterStream"))
    for ts, sym, price, tweets in C.join_feed(n_syms, 2, SEND,
                                              GLOBAL_STRINGS.encode, seed=3):
        wr.send_arrays(ts, [sym, price])
        wr.send_arrays(ts, [sym, tweets])
    torch.cuda.synchronize()
    warm.shutdown()

    rt = mgr.create_siddhi_app_runtime(C.JOIN_APP)
    q = rt.queries["q"]
    picked = {v["kernel"] for v in rt.join_kernels.values()}
    if picked != {kernel}:
        fail(f"{which}: the planner picked {picked}, expected {kernel}")
    outs = []
    q.batch_callbacks.append(outs.append)
    rt.start()
    r = Router(rt, ("StockStream", "TwitterStream"))
    # the latency sends (5), the 1,024-row sends cut from more, the K7
    # timing's send
    extra = 5 + -(-37 * 1024 // SEND) + 1
    feed = C.join_feed(n_syms, sends + extra, SEND, GLOBAL_STRINGS.encode)
    _kernels.reset_launches()
    t0 = time.perf_counter()
    for ts, sym, price, tweets in feed[:sends]:
        r.send_arrays(ts, [sym, price])
        r.send_arrays(ts, [sym, tweets])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_kernels.LAUNCHES)
    k7 = "join_probe" if kernel == "probe" else "join_grid"
    steps = len(outs)
    want = {"unpack_packed": 2 * sends, "window_step": steps, k7: steps,
            "expr_eval": steps}
    for k, n in want.items():
        if launches[k] != n or n == 0:
            fail(f"{which} path: kernel {k} launched {launches[k]} times, "
                 f"expected {n} (K1 one per send; K5, K7 and K2 one per "
                 f"side step, {steps} steps)")
    rows = [torch.cat([o.cols[i][o.valid] for o in outs]).cpu().numpy()
            for i in range(3)]
    o_sym, o_price, o_tw = C.join_oracle(feed[:sends])
    ok = (len(rows[0]) == len(o_sym) and np.array_equal(rows[0], o_sym)
          and np.array_equal(rows[1].view(np.int32), o_price.view(np.int32))
          and np.array_equal(rows[2], o_tw))
    lost = q.overflow
    stats = q.stats()
    if not ok or lost != 0 or stats["emitted"] != len(o_sym):
        fail(f"{which}: {len(rows[0])} rows ({stats['emitted']} counted), "
             f"the oracle {len(o_sym)}; equal: {ok}; pairs lost {lost}")
    if probe_rows is not None:
        n = len(rows[0])
        if not all(np.array_equal(a, b[:n]) for a, b in zip(rows, probe_rows)):
            fail(f"{which}: the grid's rows differ from the probe run's")
    events = 2 * sends * SEND
    eps = events / wall
    print(f"{which}: {events} events in {sends} sends of {SEND} rows a side; "
          f"{len(o_sym)} rows equal the numpy oracle; 0 pairs lost; "
          f"{eps:.0f} events/s, device batches only ({card})", flush=True)
    print(f"launches on the {which} path: {launches}", flush=True)
    res = {"events_per_s_device_batches": eps, "rows": len(o_sym),
           "launches": launches, "card": card, "kernel": kernel}
    if kernel == "grid":
        rt.shutdown()
        os.environ.pop(env, None)
        res.update(_k7_times(rt, q, dev, feed[sends], kernel))
        print(json.dumps({which: res}), flush=True)
        return res
    k_next = sends

    def chunk(m):
        nonlocal k_next
        ts, sym, price, tweets = feed[k_next]
        k_next += 1
        return [(ts[:m], [sym[:m], price[:m]]), (ts[:m], [sym[:m], tweets[:m]])]

    def latency(m, reps):
        for d in chunk(m):
            r.send_arrays(*d)
        torch.cuda.synchronize()
        lat = []
        for _ in range(reps):
            for d in chunk(m):
                c0 = time.perf_counter()
                r.send_arrays(*d)
                torch.cuda.synchronize()
                lat.append((time.perf_counter() - c0) * 1e3)
        return float(np.percentile(lat, 50)), float(np.percentile(lat, 99))

    p50, p99 = latency(SEND, 4)
    res.update(p50_ms_8192=p50, p99_ms_8192=p99)
    # 1,024-row sends: the rest of the feed's sends, cut
    lat = []
    rows_left = [(ts[a:a + 1024], sym[a:a + 1024], price[a:a + 1024],
                  tweets[a:a + 1024])
                 for ts, sym, price, tweets in feed[k_next:]
                 for a in range(0, SEND, 1024)]
    for ts, sym, price, tweets in rows_left[:33]:
        for d in ((ts, [sym, price]), (ts, [sym, tweets])):
            c0 = time.perf_counter()
            r.send_arrays(*d)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - c0) * 1e3)
    lat = lat[2:]
    p50k, p99k = float(np.percentile(lat, 50)), float(np.percentile(lat, 99))
    res.update(p50_ms_1024=p50k, p99_ms_1024=p99k)
    print(f"{which} latency per send: 8,192 rows p50 {p50:.3f} ms, p99 "
          f"{p99:.3f} ms; 1,024 rows p50 {p50k:.3f} ms, p99 {p99k:.3f} ms "
          f"({card})", flush=True)
    prof = [(ts, c) for ts, sym, price, tweets in rows_left[33:37]
            for ts, c in ((ts, [sym, price]), (ts, [sym, tweets]))]
    breakdown, busy = profile_sends(r, prof)
    print(f"{which}, where a 1,024-row send's device time goes (torch."
          f"profiler, {len(prof)} sends, ms per send): {breakdown}; the "
          f"card is busy {busy:.3f} of the profiled wall time ({card})",
          flush=True)
    res.update(device_ms_per_send=breakdown, busy_share=busy)
    res.update(_k7_times(rt, q, dev, feed[-1], kernel))
    rt.shutdown()
    print(json.dumps({which: res}), flush=True)
    res["k7_rows"] = rows     # for the grid pass's comparison
    return res


def _k7_times(rt, q, dev, send, kernel) -> dict:
    ts, sym, price, _tw = send
    ms, plain, lib_ms, n_bytes, n_ops, B, W = _join_kernel_times(
        rt, q, dev, ts, sym, price, kernel)
    bound, bound_by = bound_of(n_bytes, n_ops)
    print(f"{'join_probe' if kernel == 'probe' else 'join_grid'} (K7): "
          f"{ms:.5f} ms a step (trigger {B} rows, opposite {W} rows); plain "
          f"version {plain:.3f} ms; torch.sort(stable=True) + 2 "
          f"torch.searchsorted {lib_ms:.5f} ms; bound {bound:.5f} ms by "
          f"{bound_by} ({n_bytes} bytes at 3.35 TB/s, {n_ops} operations "
          f"at 67 T/s)", flush=True)
    return {"k7_ms": ms, "k7_plain_ms": plain, "k7_library_ms": lib_ms,
            "k7_bound_ms": bound, "k7_bound_by": bound_by}


def stock_table_phase(dev, card: str) -> dict:
    """Phase 16: stock_table end to end on the card: a load send of its
    8,000 symbols, then 64 rounds of a 8,192-row StockStream send (the
    primary-keyed upsert) and a 8,192-row CheckStockStream send (the
    stream-table join), checked against the numpy oracle (last writer
    wins per symbol), 0 pairs lost and 0 table overflow, the table at
    8,000 rows; the launch counters must show K1 on every send, K8's
    condition pass and write on every upsert, K8's view, K5 (the empty
    window), K7 and K2 on every lookup; then events/s, per-send latency,
    a torch.profiler split and K8's time per upsert step against its
    plain version, its byte bound and torch.argsort of the seq keys."""
    from siddhi_tpu_torch import SiddhiManager, _kernels
    from siddhi_tpu_torch import checks as C
    from siddhi_tpu_torch.core.event import EventBatch, batch_from_columns
    from siddhi_tpu_torch.core.types import GLOBAL_STRINGS
    from siddhi_tpu_torch.ops import table as TB
    ROUNDS, SEND = STOCK_ROUNDS, SEND_ROWS
    mgr = SiddhiManager(device="cuda")
    warm = mgr.create_siddhi_app_runtime(C.STOCK_TABLE_APP)
    warm.start()
    for stream, ts, cols in C.stock_table_feed(C.STOCK_SYMS, 2, SEND,
                                               GLOBAL_STRINGS.encode, seed=3):
        warm.get_input_handler(stream).send_arrays(ts, cols)
    torch.cuda.synchronize()
    warm.shutdown()
    rt = mgr.create_siddhi_app_runtime(C.STOCK_TABLE_APP)
    q = rt.queries["lookup"]
    outs = []
    q.batch_callbacks.append(outs.append)
    rt.start()
    feed = C.stock_table_feed(C.STOCK_SYMS, ROUNDS + 12, SEND,
                              GLOBAL_STRINGS.encode)
    run = feed[:1 + 2 * ROUNDS]
    _kernels.reset_launches()
    t0 = time.perf_counter()
    for stream, ts, cols in run:
        rt.get_input_handler(stream).send_arrays(ts, cols)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_kernels.LAUNCHES)
    want = {"unpack_packed": 1 + 2 * ROUNDS, "table_match": 1 + ROUNDS,
            "table_write": 1 + ROUNDS, "table_buffer": ROUNDS,
            "join_probe": ROUNDS, "window_step": ROUNDS,
            "expr_eval": 1 + 2 * ROUNDS}
    for k, n in want.items():
        if launches[k] != n:
            fail(f"stock_table path: kernel {k} launched {launches[k]} times, "
                 f"expected {n}")
    rows = [torch.cat([o.cols[i][o.valid] for o in outs]).cpu().numpy()
            for i in range(4)]
    o = C.stock_table_oracle(run)
    ok = len(rows[0]) == len(o[0]) and all(
        np.array_equal(g.view(np.int32) if g.dtype == np.float32 else g,
                       w.view(np.int32) if w.dtype == np.float32 else w)
        for g, w in zip(rows, o))
    tstate = rt.tables["StockTable"].state
    n_rows, t_over = int(tstate["valid"].sum()), int(tstate["overflow"])
    lost = q.overflow
    if not ok or lost or t_over or n_rows != C.STOCK_SYMS:
        fail(f"stock_table: {len(rows[0])} rows, the oracle {len(o[0])}; "
             f"equal: {ok}; pairs lost {lost}; table rows {n_rows}, "
             f"overflow {t_over}")
    events = sum(len(ts) for _s, ts, _c in run)
    eps = events / wall
    print(f"stock_table: {events} events (a load of {C.STOCK_SYMS} and "
          f"{ROUNDS} rounds of {SEND}-row upsert and lookup sends); "
          f"{len(o[0])} rows equal the numpy oracle; 0 pairs lost, table "
          f"{n_rows} rows, overflow 0; {eps:.0f} events/s, device batches "
          f"only ({card})", flush=True)
    print(f"launches on the stock_table path: {launches}", flush=True)
    k = 1 + 2 * ROUNDS

    def send_pair(m):
        nonlocal k
        lat = []
        for _ in range(2):
            stream, ts, cols = feed[k]
            k += 1
            c0 = time.perf_counter()
            rt.get_input_handler(stream).send_arrays(ts[:m],
                                                     [c[:m] for c in cols])
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - c0) * 1e3)
        return lat
    send_pair(SEND)
    lat = [x for _ in range(4) for x in send_pair(SEND)]
    p50, p99 = float(np.percentile(lat, 50)), float(np.percentile(lat, 99))
    lat = [x for _ in range(4) for x in send_pair(1024)]
    p50k, p99k = float(np.percentile(lat, 50)), float(np.percentile(lat, 99))
    print(f"stock_table latency per send: 8,192 rows p50 {p50:.3f} ms, p99 "
          f"{p99:.3f} ms; 1,024 rows p50 {p50k:.3f} ms, p99 {p99k:.3f} ms "
          f"({card})", flush=True)
    r = Router(rt, ("StockStream", "CheckStockStream"))
    prof = []
    for _ in range(2):
        for _s in range(2):
            stream, ts, cols = feed[k]
            k += 1
            prof.append((ts[:1024], [c[:1024] for c in cols]))
    breakdown, busy = profile_sends(r, prof)
    print(f"stock_table, where a 1,024-row send's device time goes "
          f"(torch.profiler, {len(prof)} sends, ms per send): {breakdown}; "
          f"the card is busy {busy:.3f} of the profiled wall time ({card})",
          flush=True)

    # K8 at the path's shape: one 8,192-row upsert from the live table
    saved = dict(_kernels.LAUNCHES)
    op = rt.queries["upsert"].operators[-1]
    table = op.table
    state = tstate
    stream, ts, cols = feed[k]
    b = batch_from_columns(rt.schemas["StockStream"], ts, cols,
                           capacity=SEND, device=dev)
    acting = b.valid & (b.kind == 0)
    (mstate, hits), margs = TB.table_match_args(table, state, b, acting,
                                                op.cond, op.sets, op.set_cols)
    lib = _kernels.load()
    stream_c = torch.cuda.current_stream().cuda_stream
    lib.table_match(margs, stream_c)
    wstate, wargs = TB.table_write_args(table, mstate, b, acting & ~hits)
    lib.table_write(wargs, stream_c)
    bview, bargs = TB.table_buffer_args(wstate)
    ms_match = cuda_ms(lambda: lib.table_match(margs, stream_c), reps=10)
    ms_write = cuda_ms(lambda: lib.table_write(wargs, stream_c), reps=20)
    ms_buf = cuda_ms(lambda: lib.table_buffer(bargs, stream_c), reps=20)
    k8_ms = ms_match + ms_write + ms_buf

    def plain():
        s1, h1 = TB.table_match_ref(table, state, b, acting, op.cond,
                                    op.sets, op.set_cols)
        s2 = TB.table_write_ref(table, s1, b, acting & ~h1)
        TB.table_buffer_ref(s2)
    k8_plain = cuda_ms(plain, reps=2, warmup=1)
    key = torch.where(wstate["valid"], wstate["seq"],
                      torch.full_like(wstate["seq"], 2 ** 62))
    lib_ms = cuda_ms(lambda: torch.argsort(key, stable=True), reps=20)
    _kernels.LAUNCHES.update(saved)

    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)
    tab = lambda s: [*s["cols"], *s["nulls"], s["ts"], s["seq"],  # noqa
                     s["valid"]]
    ev = [b.ts, b.kind, b.valid, *b.cols, *b.nulls]
    k8_bytes = (nbytes(tab(state)) + nbytes(ev)          # match reads
                + nbytes([mstate["valid"], *[mstate["cols"][i]
                                             for i in op.set_cols],
                          *[mstate["nulls"][i] for i in op.set_cols], hits])
                + nbytes(tab(mstate)) + nbytes(tab(wstate))  # write
                + nbytes(tab(wstate)) + nbytes(tab(bview)))  # view
    # the operations: the condition pass over every (event, table row)
    # pair, a compare and a mask each (the function's [B, T] grid); the
    # view's eight key-byte passes and gather; the write's event rows
    k8_ops = 2 * SEND * table.cap + 9 * table.cap + SEND
    k8_bound, k8_by = bound_of(k8_bytes, k8_ops)
    print(f"table_step (K8), stock_table: {k8_ms:.5f} ms an upsert step "
          f"and view ({ms_match:.5f} condition pass + {ms_write:.5f} write "
          f"+ {ms_buf:.5f} view; {SEND} events, {table.cap}-row table); "
          f"plain version {k8_plain:.3f} ms; torch.argsort(stable=True) of "
          f"the seq keys {lib_ms:.5f} ms; bound {k8_bound:.5f} ms by {k8_by} "
          f"({k8_bytes} bytes at 3.35 TB/s, {k8_ops} operations at "
          f"67 T/s); {card}", flush=True)
    rt.shutdown()
    res = {"events_per_s_device_batches": eps, "rows": len(o[0]),
           "launches": launches, "p50_ms_8192": p50, "p99_ms_8192": p99,
           "p50_ms_1024": p50k, "p99_ms_1024": p99k,
           "device_ms_per_send": breakdown, "busy_share": busy,
           "k8_ms": k8_ms, "k8_match_ms": ms_match, "k8_write_ms": ms_write,
           "k8_buffer_ms": ms_buf, "k8_plain_ms": k8_plain,
           "k8_bound_ms": k8_bound, "k8_bound_by": k8_by,
           "k8_library_ms": lib_ms, "card": card}
    print(json.dumps({"stock_table": res}), flush=True)
    return res


class KeyedCheck:
    """While installed, every step of kernels E (frequent and
    lossyFrequent), F (session) and G (order-by, offset and limit) that
    the runtime makes on the card also runs the plain version on the
    same inputs; kernel and plain results (state, output and the emitted
    counter) must be bit-equal (tolerance 0). The runtime goes on with
    the kernel's."""

    def __init__(self):
        from siddhi_tpu_torch.ops import aggregators as G
        from siddhi_tpu_torch.ops import selector as S
        from siddhi_tpu_torch.ops import windows2 as W2
        self.G, self.S, self.W2 = G, S, W2
        self.err = 0.0
        self.steps = {"freq_window": 0, "session_window": 0, "order_by": 0}
        self.shapes = set()

    def _out(self, o):
        return [o.ts, *o.cols, *o.nulls, o.kind, o.valid]

    def __enter__(self):
        G, S, W2 = self.G, self.S, self.W2
        self.saved = (W2.freq_window_step, W2.session_step, S.shape_chunk,
                      G.shape_chunk)
        k_freq, k_sess, k_shape = self.saved[:3]

        def freq_window_step(op, state, batch, now):
            ks, ko = k_freq(op, state, batch, now)
            rs, ro = op.step_ref(state, batch, now)
            what = f"kernel E {op.kind_name} N={op.N} B={batch.capacity}"
            self.err = max(self.err, compare(
                what + " state", tree_leaves(ks), tree_leaves(rs)))
            self.err = max(self.err, compare(
                what + " output", self._out(ko), self._out(ro)))
            self.steps["freq_window"] += 1
            self.shapes.add(("E", op.kind_name, op.N, batch.capacity))
            return ks, ko

        def session_step(op, state, batch, now):
            ks, ko = k_sess(op, state, batch, now)
            rs, ro = op.step_ref(state, batch, now)
            what = f"kernel F B={batch.capacity}"
            self.err = max(self.err, compare(
                what + " state", tree_leaves(ks), tree_leaves(rs)))
            self.err = max(self.err, compare(
                what + " output", self._out(ko), self._out(ro)))
            self.steps["session_window"] += 1
            self.shapes.add(("F", batch.capacity))
            return ks, ko

        def shape_chunk(out, order_by, offset, limit, emitted=None):
            e_ref = emitted.clone() if emitted is not None else None
            ko = k_shape(out, order_by, offset, limit, emitted)
            ro = S.shape_chunk_ref(out, order_by, offset, limit, e_ref)
            self.err = max(self.err, compare(
                f"kernel G keys {order_by} offset {offset} limit {limit} "
                f"B={out.capacity}", self._out(ko) + (
                    [emitted] if emitted is not None else []),
                self._out(ro) + ([e_ref] if e_ref is not None else [])))
            self.steps["order_by"] += 1
            self.shapes.add(("G", len(order_by), out.capacity))
            return ko

        W2.freq_window_step, W2.session_step = freq_window_step, session_step
        S.shape_chunk = G.shape_chunk = shape_chunk
        return self

    def __exit__(self, *exc):
        G, S, W2 = self.G, self.S, self.W2
        W2.freq_window_step, W2.session_step, S.shape_chunk, \
            G.shape_chunk = self.saved
        return False


def keyed_against_plain(dev) -> float:
    """Kernels E, F and G against their plain versions on the card, bit
    for bit, state and output, at every step of each app of
    checks.KEYED_APPS (frequent at N = 1, 2 and 64, with and without key
    attributes, expired events only; lossyFrequent at two (support,
    error) pairs, one past its 32 slots; session keyed and not,
    aggregated, carried sessions closing by the event clock and by TIMER
    rows, 80 keys past the 64 slots and a session past its 128 members;
    order-by on INT, LONG, FLOAT, DOUBLE and BOOL keys, asc and desc,
    with offset, limit and having, plain and aggregating) on a feed with
    NaN, +-0.0, infinities and the integer extremes; the lexsort traps
    of checks.ORDER_TRAP_APP; and the three paths' apps at their sends of
    65,536 rows. -> max abs error (0)."""
    from siddhi_tpu_torch import SiddhiManager, _kernels
    from siddhi_tpu_torch import checks as C
    from siddhi_tpu_torch.core.types import GLOBAL_STRINGS
    enc = GLOBAL_STRINGS.encode
    mgr = SiddhiManager()
    saved = dict(_kernels.LAUNCHES)
    with KeyedCheck() as chk:
        for name, text in C.KEYED_APPS.items():
            rt = mgr.create_siddhi_app_runtime(text)
            rt.start()
            ts, cols, cuts = C.keyed_feed(name, enc, seed=3)
            _send_all(rt.get_input_handler("S"), ts, cols, cuts)
            st = rt.queries["q"].stats()
            rt.shutdown()
            if (st["overflow"] > 0) != (name in C.KEYED_OVERFLOW):
                fail(f"kernels E-G, {name}: overflow {st['overflow']}")
            print(f"kernels E-G, {name}: bit-equal to their plain versions "
                  f"({cuts[-1]} events; emitted {st['emitted']}, overflow "
                  f"{st['overflow']}; steps so far {chk.steps})", flush=True)
        for key in ("d", "d desc", "f desc", "i desc", "l desc", "b desc, d",
                    "b, i desc, l"):
            rt = mgr.create_siddhi_app_runtime(
                C.ORDER_TRAP_APP.format(key=key))
            rt.start()
            ts, cols = C.order_trap_feed()
            rt.get_input_handler("S").send_arrays(ts, cols)
            rt.shutdown()
        print("kernel G, the lexsort traps: bit-equal to its plain version",
              flush=True)
        # the three paths' apps, one 65,536-row send each (two for the
        # session, so that sessions carry)
        SEND = KEYED_SEND
        for name, text, stream, feed, sends in (
                ("window_frequent N=2", C.fraud_app(2), "Purchase",
                 C.purchase_feed, 1),
                ("window_frequent N=64", C.fraud_app(64), "Purchase",
                 C.purchase_feed, 1),
                ("window_frequent lossy", C.LOSSY_APP, "Purchase",
                 C.purchase_feed, 1),
                ("window_session", C.CLICK_APP, "Click", C.click_feed, 2),
                ("window_top10 by hi", C.TOP10_HI_APP, "Trades",
                 C.trades_feed, 1),
                ("window_top10 hi", C.HI_APP, "Trades", C.trades_feed, 1)):
            rt = mgr.create_siddhi_app_runtime(text)
            rt.start()
            ts, cols = feed(sends * SEND, enc)
            _send_all(rt.get_input_handler(stream), ts, cols,
                      tuple(range(0, sends * SEND + 1, SEND)))
            st = rt.queries["q"].stats()
            rt.shutdown()
            print(f"kernels E-G, {name}, {sends} send(s) of {SEND} rows: "
                  f"bit-equal to their plain versions ({st})", flush=True)
    _kernels.LAUNCHES.update(saved)   # not launches of a main path
    print(f"kernels E-G: shapes held against the plain versions: "
          f"{sorted(chk.shapes, key=str)}; steps {chk.steps}", flush=True)
    for k, n in chk.steps.items():
        if n == 0:
            fail(f"kernel {k} was never held against its plain version")
    return chk.err


def _latency(h, chunk, m, reps):
    h.send_arrays(*chunk(m))
    torch.cuda.synchronize()
    lat = []
    for _ in range(reps):
        c0 = time.perf_counter()
        h.send_arrays(*chunk(m))
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - c0) * 1e3)
    return float(np.percentile(lat, 50)), float(np.percentile(lat, 99))


def _chunker(ts_all, cols_all, start):
    k = [start]

    def chunk(m):
        s = slice(k[0], k[0] + m)
        k[0] += m
        return ts_all[s], [c[s] for c in cols_all]
    return chunk


def _out_bytes(o):
    return _nbytes([o.ts, o.kind, o.valid, *o.cols, *o.nulls])


def frequent_phase(dev, card: str, n_sends: int = 4) -> dict:
    """window_frequent: Siddhi's documented fraud query (frequent(2,
    cardNo) over the purchases of 30 or more, insert all events) end to
    end on the card through SiddhiManager, send_arrays and
    batch_callbacks: 262,144 purchases of 4,096 cards with Zipf-skewed
    use in 4 sends of 65,536, then the same feed through frequent(64,
    cardNo) and lossyFrequent(0.1, 0.01, cardNo); each checked against
    checks.freq_oracle (the rows in order; lossyFrequent's insert
    overflow equal to the oracle's, the others 0); the launch counters
    must show K1, K2 and kernel E on every send; then events/s,
    latency at 65,536 and 1,024 rows, and E's time against its plain
    version and its bound."""
    from siddhi_tpu_torch import SiddhiManager, _kernels
    from siddhi_tpu_torch import checks as C
    from siddhi_tpu_torch.core.event import batch_from_columns
    from siddhi_tpu_torch.core.types import GLOBAL_STRINGS
    from siddhi_tpu_torch.ops import windows2 as W2
    enc = GLOBAL_STRINGS.encode
    SEND = KEYED_SEND
    N = n_sends * SEND
    ts_all, cols_all = C.purchase_feed(N + 8 * SEND + 70 * 1024, enc)
    card_np, price_np = (c[:N] for c in cols_all)
    mgr = SiddhiManager(device="cuda")
    res = {"send": SEND, "card": card}
    for label, text, lossy in (("N=2", C.fraud_app(2), None),
                               ("N=64", C.fraud_app(64), None),
                               ("lossy", C.LOSSY_APP, (0.1, 0.01))):
        warm = mgr.create_siddhi_app_runtime(text.replace("'q'", "'w'"))
        warm.start()
        wts, wcols = C.purchase_feed(2 * SEND, enc, seed=5)
        _send_all(warm.get_input_handler("Purchase"), wts, wcols,
                  (0, SEND, 2 * SEND))
        torch.cuda.synchronize()
        warm.shutdown()
        rt = mgr.create_siddhi_app_runtime(text)
        q = rt.queries["q"]
        outs = []
        q.batch_callbacks.append(outs.append)
        rt.start()
        h = rt.get_input_handler("Purchase")
        _kernels.reset_launches()
        t0 = time.perf_counter()
        for s in range(0, N, SEND):
            h.send_arrays(ts_all[s:s + SEND],
                          [c[s:s + SEND] for c in cols_all])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_kernels.LAUNCHES)
        if launches["unpack_packed"] != n_sends or \
                launches["freq_window"] != n_sends or \
                launches["expr_eval"] < n_sends:
            fail(f"window_frequent {label}: launches {launches}")
        kind = torch.cat([b.kind[b.valid] for b in outs]).cpu().numpy()
        g_card = torch.cat([b.cols[0][b.valid] for b in outs]).cpu().numpy()
        g_price = torch.cat([b.cols[1][b.valid] for b in outs]).cpu().numpy()
        want, ovf = C.freq_oracle(card_np, price_np, 2 if label == "N=2"
                                  else 64, lossy=lossy)
        w_exp = np.array([e for e, _c, _p in want], bool)
        w_card = np.array([c for _e, c, _p in want], np.int32)
        w_price = np.array([p for _e, _c, p in want], np.float64)
        st = q.stats()
        if not (len(kind) == len(want) and np.array_equal(kind == 1, w_exp)
                and np.array_equal(g_card, w_card)
                and np.array_equal(bits_np(g_price), bits_np(w_price))) \
                or st["overflow"] != ovf:
            fail(f"window_frequent {label}: {len(kind)} rows, the oracle "
                 f"{len(want)}; overflow {st['overflow']}, the oracle {ovf}")
        eps = N / wall
        print(f"window_frequent {label}: {N} purchases in {n_sends} sends "
              f"of {SEND}; {len(want)} rows ({int(w_exp.sum())} expired) "
              f"equal the numpy oracle; overflow {ovf} (the oracle's); "
              f"{eps:.0f} events/s, device batches only ({card})",
              flush=True)
        print(f"launches on the window_frequent {label} path: {launches}",
              flush=True)
        r = {"events_per_s_device_batches": eps, "rows": len(want),
             "overflow": ovf, "launches": launches}
        chunk = _chunker(ts_all, cols_all, N + (0 if label == "N=2" else
                                                4 * SEND))
        if label == "N=2":
            p50, p99 = _latency(h, chunk, SEND, 4)
            p50k, p99k = _latency(h, chunk, 1024, 64)
            r.update(p50_ms_send=p50, p99_ms_send=p99, p50_ms_1024=p50k,
                     p99_ms_1024=p99k)
            print(f"window_frequent latency per send: {SEND} rows p50 "
                  f"{p50:.3f} ms, p99 {p99:.3f} ms; 1,024 rows p50 "
                  f"{p50k:.3f} ms, p99 {p99k:.3f} ms ({card})", flush=True)
        # kernel E at the path's shape: one 65,536-row step from the live
        # state (its input: the filter's output batch)
        ts_c, cols_c = chunk(SEND)
        batch = batch_from_columns(rt.schemas["Purchase"], ts_c, cols_c,
                                   capacity=SEND, device=dev)
        op, st0 = q.operators[1], q.states[1]
        now = torch.tensor(int(ts_c[-1]), dtype=torch.int64, device=dev)
        _ns, eout, eargs = W2.freq_args(op, st0, batch, now)
        lib = _kernels.load()
        stream = torch.cuda.current_stream().cuda_stream
        e_ms = cuda_ms(lambda: lib.freq_window(eargs, stream), reps=5,
                       warmup=1)
        e_plain = cuda_ms(lambda: op.step_ref(st0, batch, now), reps=1,
                          warmup=0)
        n_bytes = SEND * (8 + 4 + 1 + 4 + 1 + 8 + 1) + \
            2 * _nbytes(tree_leaves(st0)) + _out_bytes(eout)
        n_ops = SEND * op.N * 4
        bound, by = bound_of(n_bytes, n_ops)
        print(f"freq_window (kernel E, {op.kind_name}, N {op.N}): "
              f"{e_ms:.3f} ms a {SEND}-row step (output {eout.capacity} "
              f"rows; one warp walking the rows); plain version "
              f"{e_plain:.1f} ms; bound {bound:.5f} ms ({n_bytes} bytes, "
              f"{n_ops} operations: {by}); {card}", flush=True)
        r.update(e_ms=e_ms, e_plain_ms=e_plain, e_bound_ms=bound,
                 e_bound_by=by)
        _kernels.LAUNCHES.update(launches)
        res[label] = r
        rt.shutdown()
        del outs
        gc.collect()
    print(json.dumps({"window_frequent": res}), flush=True)
    return res


def session_phase(dev, card: str, n_sends: int = 16) -> dict:
    """window_session: Siddhi's documented session usage (per-user
    sessions with a 5 s gap, count() and sum(dwell) by user, insert all
    events) end to end on the card through SiddhiManager, send_arrays and
    batch_callbacks: 1,048,576 clicks of 48 users (bursts of 20-120
    clicks 1-20 ms apart, silences of 6-30 s) in 16 sends of 65,536,
    then a TIMER past the last session's end; checked against
    checks.session_oracle (each user's rows in order, the member
    overflow equal to the oracle's; every key placed: key overflow 0);
    the launch counters must show K1 on every send and kernel F, K6 and
    K2 on every step; then events/s, latency at 65,536 and 1,024 rows,
    and F's time against its plain version and its bound."""
    from siddhi_tpu_torch import SiddhiManager, _kernels
    from siddhi_tpu_torch import checks as C
    from siddhi_tpu_torch.core.event import batch_from_columns
    from siddhi_tpu_torch.core.types import GLOBAL_STRINGS
    from siddhi_tpu_torch.ops import windows2 as W2
    enc = GLOBAL_STRINGS.encode
    SEND = KEYED_SEND
    N = n_sends * SEND
    mgr = SiddhiManager(device="cuda")
    warm = mgr.create_siddhi_app_runtime(C.CLICK_APP.replace("'q'", "'w'"))
    warm.start()
    wts, wcols = C.click_feed(2 * SEND, enc, seed=5)
    _send_all(warm.get_input_handler("Click"), wts, wcols,
              (0, SEND, 2 * SEND))
    torch.cuda.synchronize()
    warm.shutdown()
    rt = mgr.create_siddhi_app_runtime(C.CLICK_APP)
    q = rt.queries["q"]
    outs = []
    q.batch_callbacks.append(outs.append)
    rt.start()
    h = rt.get_input_handler("Click")
    ts_all, cols_all = C.click_feed(N + 8 * SEND + 70 * 1024, enc)
    _kernels.reset_launches()
    t0 = time.perf_counter()
    for s in range(0, N, SEND):
        h.send_arrays(ts_all[s:s + SEND], [c[s:s + SEND] for c in cols_all])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    flush = int(ts_all[N - 1]) + 2 * C.SESSION_GAP_MS
    with rt.barrier:
        rt.on_ingest_ts(flush)
    torch.cuda.synchronize()
    launches = dict(_kernels.LAUNCHES)
    steps = len(outs)
    if launches["unpack_packed"] != n_sends or \
            launches["session_window"] != steps or steps <= n_sends or \
            launches["aggregate_step"] != steps or \
            launches["expr_eval"] < steps:
        fail(f"window_session: launches {launches}, steps {steps}")
    user = torch.cat([b.cols[0][b.valid] for b in outs]).cpu().numpy()
    clicks = torch.cat([b.cols[1][b.valid] for b in outs]).cpu().numpy()
    dwell = torch.cat([b.cols[2][b.valid] for b in outs]).cpu().numpy()
    dnull = torch.cat([b.nulls[2][b.valid] for b in outs]).cpu().numpy()
    got = {}
    for u, c, d, dn in zip(user.tolist(), clicks.tolist(), dwell.tolist(),
                           dnull.tolist()):
        got.setdefault(u, []).append((c, None if dn else d))
    chunks = [(ts_all[s:s + SEND], cols_all[0][s:s + SEND],
               cols_all[1][s:s + SEND]) for s in range(0, N, SEND)]
    want, ovf = C.session_oracle(chunks, flush_at=flush)
    st = q.stats()
    placed = int(q.states[0]["used"].sum())
    if placed != C.SESSION_USERS:
        fail(f"window_session: {placed} of {C.SESSION_USERS} users placed "
             f"in the 64-slot table (key overflow)")
    rows = sum(len(v) for v in want.values())
    if got != want or st["overflow"] != ovf:
        fail(f"window_session: rows differ from the oracle ({len(user)} "
             f"rows, the oracle {rows}; overflow {st['overflow']}, the "
             f"oracle {ovf})")
    eps = N / wall
    print(f"window_session: {N} clicks of {C.SESSION_USERS} users in "
          f"{n_sends} sends of {SEND}, {steps - n_sends} timer steps; "
          f"{rows} rows equal the numpy oracle (each user's rows in order); "
          f"every user placed (key overflow 0); overflow {ovf} (the "
          f"oracle's: members of sessions the reference's close-time quirk "
          f"merges); {eps:.0f} events/s, "
          f"device batches only ({card})", flush=True)
    print(f"launches on the window_session path: {launches}", flush=True)
    chunk = _chunker(ts_all, cols_all, N)
    p50, p99 = _latency(h, chunk, SEND, 4)
    p50k, p99k = _latency(h, chunk, 1024, 64)
    print(f"window_session latency per send: {SEND} rows p50 {p50:.3f} ms, "
          f"p99 {p99:.3f} ms; 1,024 rows p50 {p50k:.3f} ms, p99 "
          f"{p99k:.3f} ms ({card})", flush=True)
    ts_c, cols_c = chunk(SEND)
    batch = batch_from_columns(rt.schemas["Click"], ts_c, cols_c,
                               capacity=SEND, device=dev)
    op, st0 = q.operators[0], q.states[0]
    now = torch.tensor(int(ts_c[-1]), dtype=torch.int64, device=dev)
    _ns, fout, fargs = W2.session_args(op, st0, batch)
    lib = _kernels.load()
    stream = torch.cuda.current_stream().cuda_stream
    f_ms = cuda_ms(lambda: lib.session_window(fargs, stream), reps=20)
    f_plain = cuda_ms(lambda: op.step_ref(st0, batch, now), reps=3,
                      warmup=1)
    n_bytes = SEND * (8 + 4 + 1 + 4 + 1 + 8 + 1) + \
        2 * _nbytes(tree_leaves(st0)) + _out_bytes(fout)
    bound, by = bound_of(n_bytes, SEND * 64)
    print(f"session_window (kernel F): {f_ms:.4f} ms a {SEND}-row step "
          f"(output {fout.capacity} rows); plain version {f_plain:.3f} ms; "
          f"bound {bound:.5f} ms ({n_bytes} bytes: {by}); {card}",
          flush=True)
    _kernels.LAUNCHES.update(launches)
    res = {"events_per_s_device_batches": eps, "send": SEND,
           "p50_ms_send": p50, "p99_ms_send": p99, "p50_ms_1024": p50k,
           "p99_ms_1024": p99k, "rows": rows, "overflow": ovf,
           "users_placed": placed, "timer_steps": steps - n_sends,
           "launches": launches, "f_ms": f_ms, "f_plain_ms": f_plain,
           "f_bound_ms": bound, "f_bound_by": by, "card": card}
    rt.shutdown()
    del outs
    gc.collect()
    print(json.dumps({"window_session": res}), flush=True)
    return res


def top10_phase(dev, card: str, n_sends: int = 16) -> dict:
    """window_top10: the ten largest tickers by volume per 65,536-trade
    batch (lengthBatch, sum and max by symbol, having, order by vol desc
    then the symbol: a STRING key, so the ordering runs at the host edge,
    read through a row StreamCallback), the same ordered by vol desc then
    hi (all on the card, kernel G), and a stateless top-100 by price
    (kernel G on the projection), each end to end on the card: 1,048,576
    trades of 512 symbols in 16 sends of 65,536, checked against
    checks.top10_oracle and checks.hi_oracle; the launch counters must
    show K1 on every send and G on every step of the two device
    orderings; then events/s, latency, and G's time against its plain
    version, its bound and the library call (chained stable torch.sort
    and the gathers)."""
    from siddhi_tpu_torch import SiddhiManager, StreamCallback, _kernels
    from siddhi_tpu_torch import checks as C
    from siddhi_tpu_torch.core.event import batch_from_columns
    from siddhi_tpu_torch.core.types import GLOBAL_STRINGS
    from siddhi_tpu_torch.ops import selector as S
    enc = GLOBAL_STRINGS.encode
    SEND = KEYED_SEND
    N = n_sends * SEND
    ts_all, cols_all = C.trades_feed(N + 8 * SEND + 70 * 1024, enc)
    _ets, sym, price, vol = (c[:N] for c in cols_all)
    names = {int(c): GLOBAL_STRINGS.decode(int(c)) for c in np.unique(sym)}
    mgr = SiddhiManager(device="cuda")
    res = {"send": SEND, "card": card}
    for label, text in (("top10", C.TOP10_APP), ("top10 by hi",
                                                 C.TOP10_HI_APP),
                        ("hi", C.HI_APP)):
        text = text.replace("65536", str(SEND))   # a batch a send
        warm = mgr.create_siddhi_app_runtime(text.replace("'q'", "'w'"))
        warm.start()
        wts, wcols = C.trades_feed(2 * SEND, enc, seed=5)
        _send_all(warm.get_input_handler("Trades"), wts, wcols,
                  (0, SEND, 2 * SEND))
        torch.cuda.synchronize()
        warm.shutdown()
        rt = mgr.create_siddhi_app_runtime(text)
        q = rt.queries["q"]
        rows_cb, outs = [], []
        if label == "top10":
            rt.add_callback("Top", StreamCallback(lambda evs: rows_cb.extend(
                (enc(e.data[0]), e.data[1], e.data[2]) for e in evs)))
        else:
            q.batch_callbacks.append(outs.append)
        rt.start()
        h = rt.get_input_handler("Trades")
        _kernels.reset_launches()
        t0 = time.perf_counter()
        for s in range(0, N, SEND):
            h.send_arrays(ts_all[s:s + SEND],
                          [c[s:s + SEND] for c in cols_all])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_kernels.LAUNCHES)
        want_g = 0 if label == "top10" else n_sends
        if launches["unpack_packed"] != n_sends or \
                launches["order_by"] != want_g:
            fail(f"window_top10 {label}: launches {launches}")
        if label == "hi":
            want = C.hi_oracle(sym, price, vol, SEND)
            got = list(zip(
                torch.cat([b.cols[0][b.valid] for b in outs]).tolist(),
                torch.cat([b.cols[1][b.valid] for b in outs]).tolist(),
                torch.cat([b.cols[2][b.valid] for b in outs]).tolist()))
        else:
            want = [r for batch in C.top10_oracle(
                sym, price, vol, SEND, by_hi=label.endswith("hi"),
                names=names) for r in batch]
            if label == "top10":
                got = [(c, v, float(np.float32(h_))) for c, v, h_ in rows_cb]
            else:
                got = list(zip(
                    torch.cat([b.cols[0][b.valid] for b in outs]).tolist(),
                    torch.cat([b.cols[1][b.valid] for b in outs]).tolist(),
                    torch.cat([b.cols[2][b.valid] for b in outs]).tolist()))
        if got != want:
            fail(f"window_top10 {label}: {len(got)} rows differ from the "
                 f"oracle's {len(want)}")
        eps = N / wall
        print(f"window_top10 {label}: {N} trades in {n_sends} sends of "
              f"{SEND}; {len(want)} rows equal the numpy oracle; "
              f"{eps:.0f} events/s ({'row callback' if label == 'top10' else 'device batches only'}; {card})", flush=True)
        print(f"launches on the window_top10 {label} path: {launches}",
              flush=True)
        r = {"events_per_s": eps, "rows": len(want), "launches": launches}
        chunk = _chunker(ts_all, cols_all, N)
        p50, p99 = _latency(h, chunk, SEND, 4)
        p50k, p99k = _latency(h, chunk, 1024, 64)
        r.update(p50_ms_send=p50, p99_ms_send=p99, p50_ms_1024=p50k,
                 p99_ms_1024=p99k)
        print(f"window_top10 {label} latency per send: {SEND} rows p50 "
              f"{p50:.3f} ms, p99 {p99:.3f} ms; 1,024 rows p50 {p50k:.3f} "
              f"ms, p99 {p99k:.3f} ms ({card})", flush=True)
        if label == "hi":
            # kernel G at the stateless top-100's shape: the projection's
            # 65,536 rows, nearly all valid, one FLOAT key
            ts_c, cols_c = chunk(SEND)
            batch = batch_from_columns(rt.schemas["Trades"], ts_c, cols_c,
                                       capacity=SEND, device=dev)
            from siddhi_tpu_torch.core.event import EventBatch
            proj = EventBatch(batch.ts, (batch.cols[1], batch.cols[2],
                                         batch.cols[3]),
                              (batch.nulls[1], batch.nulls[2],
                               batch.nulls[3]), batch.kind,
                              batch.valid & (batch.cols[2] > 0))
            ob = [(1, "desc")]
            emitted = torch.zeros((), dtype=torch.int64, device=dev)
            gout, gargs = S.order_args(proj, ob, None, 100, emitted)
            lib = _kernels.load()
            stream = torch.cuda.current_stream().cuda_stream
            g_ms = cuda_ms(lambda: lib.order_by(gargs, stream), reps=50)
            g_plain = cuda_ms(lambda: S.shape_chunk_ref(proj, ob, None, 100),
                              reps=5)
            kw = S.sort_key(proj.cols[1], True)
            dead = (~proj.valid).to(torch.uint8)

            def library():
                p1 = torch.sort(kw, stable=True).indices
                p2 = p1[torch.sort(dead[p1], stable=True).indices]
                return [proj.ts[p2], *(c[p2] for c in proj.cols),
                        *(n[p2] for n in proj.nulls), proj.kind[p2],
                        proj.valid[p2]]
            g_lib = cuda_ms(library, reps=20)
            n_bytes = 2 * _out_bytes(proj)
            bound, by = bound_of(n_bytes, SEND * 10)
            print(f"order_by (kernel G): {g_ms:.4f} ms a {SEND}-row chunk "
                  f"(one FLOAT key desc, limit 100); plain version "
                  f"{g_plain:.3f} ms; chained torch.sort(stable=True) and "
                  f"the gathers {g_lib:.4f} ms; bound {bound:.5f} ms "
                  f"({n_bytes} bytes: {by}); {card}", flush=True)
            r.update(g_ms=g_ms, g_plain_ms=g_plain, g_library_ms=g_lib,
                     g_bound_ms=bound, g_bound_by=by)
        _kernels.LAUNCHES.update(launches)
        res[label] = r
        rt.shutdown()
        del outs, rows_cb
        gc.collect()
    print(json.dumps({"window_top10": res}), flush=True)
    return res


def chain_phase(dev, card: str, which: str, n_sends: int = 4) -> dict:
    """bench.py's chain3 (three queries chained by insert into) or fanout
    (four queries on one stream), their apps and feeds verbatim, end to
    end on the card through SiddhiManager, send_arrays and
    batch_callbacks: 262,144 events in 4 sends of 65,536, checked against
    the numpy oracles of checks.py; the launch counters must show K1 and
    K2; then events/s and latency at 65,536 and 1,024 rows."""
    from siddhi_tpu_torch import SiddhiManager, _kernels
    from siddhi_tpu_torch import checks as C
    from siddhi_tpu_torch.core.types import GLOBAL_STRINGS
    enc = GLOBAL_STRINGS.encode
    SEND = KEYED_SEND
    N = n_sends * SEND
    text, feed, qs = {
        "chain3": (C.CHAIN3_APP, C.chain3_feed, ("q3",)),
        "fanout": (C.FANOUT_APP, C.fanout_feed, ("q1", "q2", "q3", "q4"))
    }[which]
    ts_all, cols_all = feed(N + 9 * SEND + 70 * 1024, enc)
    mgr = SiddhiManager(device="cuda")
    warm = mgr.create_siddhi_app_runtime(text.replace("OutS", "OutW"))
    warm.start()
    warm.get_input_handler("S").send_arrays(ts_all[:SEND],
                                            [c[:SEND] for c in cols_all])
    torch.cuda.synchronize()
    warm.shutdown()
    rt = mgr.create_siddhi_app_runtime(text)
    outs = {qn: [] for qn in qs}
    for qn in qs:
        rt.queries[qn].batch_callbacks.append(outs[qn].append)
    rt.start()
    h = rt.get_input_handler("S")
    _kernels.reset_launches()
    t0 = time.perf_counter()
    for s in range(0, N, SEND):
        h.send_arrays(ts_all[s:s + SEND], [c[s:s + SEND] for c in cols_all])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_kernels.LAUNCHES)
    if launches["unpack_packed"] == 0 or launches["expr_eval"] == 0:
        fail(f"{which}: launches {launches}")
    cols = [c[:N] for c in cols_all]

    def got(qn, i):
        return torch.cat([b.cols[i][b.valid] for b in outs[qn]]).cpu().numpy()
    if which == "chain3":
        keep = C.chain3_oracle(*cols)
        ok = all(np.array_equal(bits_np(got("q3", i)), bits_np(cols[i][keep]))
                 for i in range(3))
        rows = len(keep)
    else:
        keep, spread = C.fanout_oracle(*cols)
        sym, price, vol = cols[0], cols[1], cols[5]
        ok = all(np.array_equal(got(qn, 0), sym[keep]) for qn in qs) and \
            np.array_equal(bits_np(got("q1", 1)), bits_np(price[keep])) and \
            np.array_equal(bits_np(got("q2", 1)), bits_np(price[keep])) and \
            np.array_equal(bits_np(got("q3", 1)), bits_np(spread[keep])) \
            and np.array_equal(got("q4", 1), vol[keep])
        rows = 4 * len(keep)
    if not ok:
        fail(f"{which}: rows differ from the numpy oracle")
    eps = N / wall
    chunk = _chunker(ts_all, cols_all, N)
    p50, p99 = _latency(h, chunk, SEND, 8)
    p50k, p99k = _latency(h, chunk, 1024, 64)
    print(f"{which}: {N} events in {n_sends} sends of {SEND}; {rows} rows "
          f"equal the numpy oracle; {eps:.0f} events/s, device batches "
          f"only; latency {SEND} rows p50 {p50:.3f} ms, p99 {p99:.3f} ms; "
          f"1,024 rows p50 {p50k:.3f} ms, p99 {p99k:.3f} ms ({card})",
          flush=True)
    print(f"launches on the {which} path: {launches}", flush=True)
    _kernels.LAUNCHES.update(launches)
    rt.shutdown()
    return {"events_per_s_device_batches": eps, "rows": rows,
            "p50_ms_send": p50, "p99_ms_send": p99, "p50_ms_1024": p50k,
            "p99_ms_1024": p99k, "launches": launches, "card": card}



# -- slice 8: function calls, stream functions, the set family -----------------

# the K2 entry points of the modules that call it by name
_K2_USERS = ("ops.expr", "ops.selector", "ops.aggregators", "ops.operators",
             "ops.table", "ops.streamfn", "core.runtime", "core.ondemand")


def library_program(prog) -> bool:
    """Whether a K2 program runs a math-library function (held to 2 ulp
    against its plain version; every other op bit for bit)."""
    from siddhi_tpu_torch.ops import expr as E
    lib = {E.MATH_FNS.index(f) for f in E.LIBRARY_FNS}
    for word in prog.code:
        op, arg = word & 0xFF, word >> 16
        if op == E.OP_POW or (op == E.OP_MATH and arg in lib):
            return True
    return False


def compare_ulp(name: str, got, want, lib: bool):
    """compare(), except that with ``lib`` the float64 outputs may differ
    by 2 ulp. -> (max abs error, largest ulp gap)."""
    if not lib:
        return compare(name, got, want), 0
    from siddhi_tpu_torch.checks import ulp_gap
    exact_g, exact_w, gap = [], [], 0
    for g, w in zip(got, want):
        if g.dtype == torch.float64 and g.shape == w.shape:
            gap = max(gap, ulp_gap(g.reshape(-1).cpu().numpy(),
                                   w.reshape(-1).cpu().numpy()))
        else:
            exact_g.append(g)
            exact_w.append(w)
    if gap > 2:
        fail(f"{name}: a math-library output is {gap} ulp from the plain "
             "version's")
    return compare(name, exact_g, exact_w), gap


class FuncCheck:
    """While installed, every K2 launch the runtime makes on the card also
    runs the plain version on the same inputs; outputs, null masks, the
    valid mask and the emitted counter must be bit-equal, except the
    float64 outputs of a program with a math-library function, which
    may differ by 2 ulp (the largest gap is kept). The runtime goes on
    with the kernel's."""

    def __init__(self):
        import importlib
        from siddhi_tpu_torch.ops import expr as E
        self.E = E
        self.mods = [importlib.import_module(f"siddhi_tpu_torch.{m}")
                     for m in _K2_USERS]
        self.err, self.ulp, self.steps = 0.0, 0, 0

    def __enter__(self):
        E = self.E
        k_eval = E.expr_eval

        def expr_eval(prog, batch, emitted=None, now=None, tparams=None):
            e_ref = emitted.clone() if emitted is not None else None
            kc, kn, kv = k_eval(prog, batch, emitted, now, tparams)
            rc, rn, rv = E.expr_eval_ref(prog, batch, e_ref, now, tparams)
            err, gap = compare_ulp(
                f"K2 B={batch.capacity}",
                [*kc, *kn, kv] + ([emitted] if emitted is not None else []),
                [*rc, *rn, rv] + ([e_ref] if e_ref is not None else []),
                library_program(prog))
            self.err, self.ulp = max(self.err, err), max(self.ulp, gap)
            self.steps += 1
            return kc, kn, kv

        self.saved = k_eval
        for m in self.mods:
            if hasattr(m, "expr_eval"):
                m.expr_eval = expr_eval
        return self

    def __exit__(self, *exc):
        for m in self.mods:
            if hasattr(m, "expr_eval"):
                m.expr_eval = self.saved
        return False


def func_against_plain(dev) -> dict:
    """K2's function ops, and kernels H, K5 and K6 with set rows, against
    their plain versions on the card, at every launch: each app of
    checks.FUNC_APPS (functions in a filter and a projection, having,
    aggregator arguments, a grouped selector, a pattern condition on
    each engine, a join's ON, a table's ON and an update-or-insert) on
    checks.func_feed; the reference's set-family cases (createSet of
    every element type, unionSet over a sliding length window with
    removals, over lengthBatch resets, past its 32 lanes); and the new
    paths' apps (functions, polar, distinct_symbols on both feeds) at
    two 65,536-row sends. -> {"k2_err", "k2_ulp", "h_err"}."""
    from siddhi_tpu_torch import Event, SiddhiManager, _kernels
    from siddhi_tpu_torch import checks as C
    from siddhi_tpu_torch.core.types import GLOBAL_STRINGS
    enc = GLOBAL_STRINGS.encode
    mgr = SiddhiManager()
    saved = dict(_kernels.LAUNCHES)
    sets = {
        "createSet of each type": """
            define stream S (s string, i int, j int, l long, f float,
                             d double, b bool);
            from S select createSet(i) as ci, createSet(l) as cl,
                          createSet(f) as cf, createSet(d) as cd,
                          createSet(b) as cb, createSet(s) as cs,
                          sizeOfSet(createSet(d / f)) as n
            insert into P;
            @info(name = 'q') from P#window.lengthBatch(7)
            select unionSet(cd) as u, sizeOfSet(unionSet(cf)) as m,
                   unionSet(cs) as us
            insert into Out;""",
        "unionSet over length(5)": C.FUNC_STREAM + """
            from S select createSet(l) as vs insert into P;
            @info(name = 'q') from P#window.length(5)
            select unionSet(vs) as u insert all events into Out;""",
        "unionSet past 32 lanes": C.FUNC_STREAM + """
            from S select createSet(l) as vs insert into P;
            @info(name = 'q') from P#window.lengthBatch(64)
            select unionSet(vs) as u, sizeOfSet(unionSet(vs)) as n
            insert into Out;"""}
    rows = C.func_feed(400, seed=7)
    feeds = {n: C.func_app_sends(n) for n in C.FUNC_APPS}
    feeds.update({n: [("S", rows[a:a + 100]) for a in range(0, 400, 100)]
                  for n in sets})
    apps = [(n, "@app:playback " + t) for n, t in
            list(C.FUNC_APPS.items()) + list(sets.items())]
    with FuncCheck() as fchk, KernelCheck() as kchk, JoinTableCheck() as jchk:
        for name, text in apps:
            rt = mgr.create_siddhi_app_runtime(text)
            rt.start()
            for stream, sends in feeds[name]:
                rt.get_input_handler(stream).send(
                    [Event(ts, row) for ts, row in sends])
            rt.shutdown()
            print(f"K2 functions, {name}: bit-equal to the plain version "
                  f"(launches held so far {fchk.steps}, largest library "
                  f"ulp {fchk.ulp}; K5/K6/H {kchk.steps})", flush=True)
        SEND = KEYED_SEND
        for name, text, stream, feed in (
                ("functions", C.FUNCTIONS_APP, "Trade",
                 lambda n: C.trade_feed(n, enc)),
                ("polar", C.POLAR_APP, "Radar", C.radar_feed),
                ("distinct_symbols 24", C.DISTINCT_APP, "stockStream",
                 lambda n: C.distinct_feed(n, enc, 24)),
                ("distinct_symbols 512", C.DISTINCT_APP, "stockStream",
                 lambda n: C.distinct_feed(n, enc, 512))):
            rt = mgr.create_siddhi_app_runtime(text)
            rt.start()
            ts, cols = feed(2 * SEND)
            _send_all(rt.get_input_handler(stream), ts, cols,
                      (0, SEND, 2 * SEND))
            rt.shutdown()
            print(f"{name}, 2 sends of {SEND}: K2, K5, K6 and H equal to "
                  f"their plain versions (largest library ulp "
                  f"{fchk.ulp})", flush=True)
    _kernels.LAUNCHES.update(saved)
    if fchk.steps == 0 or kchk.steps["aggregate_step"] == 0:
        fail("K2 or K6 was never held against its plain version")
    return {"k2_err": max(fchk.err, jchk.err), "k2_ulp": fchk.ulp,
            "h_err": kchk.err}


def _path_run(text, stream, ts_all, cols_all, N, SEND, qname="q"):
    """One path end to end: a warm-up runtime, then the measured one with
    a batch callback. -> (runtime, outputs, wall seconds, launches)."""
    from siddhi_tpu_torch import SiddhiManager, _kernels
    mgr = SiddhiManager(device="cuda")
    warm = mgr.create_siddhi_app_runtime(text)
    warm.start()
    _send_all(warm.get_input_handler(stream), ts_all[N:], 
              [c[N:] for c in cols_all], (0, SEND, 2 * SEND))
    torch.cuda.synchronize()
    warm.shutdown()
    rt = mgr.create_siddhi_app_runtime(text)
    outs = []
    rt.queries[qname].batch_callbacks.append(outs.append)
    rt.start()
    h = rt.get_input_handler(stream)
    _kernels.reset_launches()
    t0 = time.perf_counter()
    for s in range(0, N, SEND):
        h.send_arrays(ts_all[s:s + SEND], [c[s:s + SEND] for c in cols_all])
    torch.cuda.synchronize()
    return rt, outs, time.perf_counter() - t0, dict(_kernels.LAUNCHES)


def _report(name, N, SEND, n_sends, rows, eps, launches, card, extra=""):
    print(f"{name}: {N} events in {n_sends} sends of {SEND}; {rows} rows "
          f"equal the numpy oracle{extra}; {eps:.0f} events/s, device "
          f"batches only ({card})", flush=True)
    print(f"launches on the {name} path: {launches}", flush=True)


def functions_phase(dev, card: str, n_sends: int = 16) -> dict:
    """functions: market-data normalisation (checks.FUNCTIONS_APP: a
    filter and a projection of every everyday function, the nulls made by
    the query from zero lots) end to end on the card through
    SiddhiManager, send_arrays and batch_callbacks: 1,048,576 trades of
    512 symbols in 16 sends of 65,536, every column against
    checks.functions_oracle bit for bit (sqrt and ln within 4 ulp of
    numpy's); the launch counters must show K1 and K2 on every send; then
    events/s, latency at 65,536 and 1,024 rows, and K2's time on the
    path's chunk against its plain version and its bound."""
    from siddhi_tpu_torch import _kernels
    from siddhi_tpu_torch import checks as C
    from siddhi_tpu_torch.core.event import batch_from_columns
    from siddhi_tpu_torch.core.types import GLOBAL_STRINGS
    from siddhi_tpu_torch.ops.expr import (expr_eval, expr_eval_ref,
                                           expr_params)
    enc = GLOBAL_STRINGS.encode
    SEND = KEYED_SEND
    N = n_sends * SEND
    ts_all, cols_all = C.trade_feed(N + 10 * SEND + 70 * 1024, enc)
    rt, outs, wall, launches = _path_run(C.FUNCTIONS_APP, "Trade", ts_all,
                                         cols_all, N, SEND)
    if launches["unpack_packed"] != n_sends or \
            launches["expr_eval"] < n_sends:
        fail(f"functions: launches {launches}")
    ots, ocols, onulls = C.emitted_columns(outs)
    want = C.functions_oracle(ts_all[:N], [c[:N] for c in cols_all], enc)
    names = ["symbol", "vol32", "pf", "per_lot", "px_lot", "band", "lo",
             "hi", "spread", "sq", "rp", "lnp"]
    if not np.array_equal(ots, want["ts"]) or \
            not np.array_equal(ocols[-1], want["ts"]) or \
            any(n.any() for n in onulls):
        fail(f"functions: {len(ots)} rows, the oracle {len(want['ts'])}")
    gaps = {}
    for k, n in enumerate(names):
        if n in ("sq", "lnp"):
            gaps[n] = C.ulp_gap(ocols[k], want[n])
            if gaps[n] > 4:
                fail(f"functions: {n} is {gaps[n]} ulp from numpy's")
        elif not np.array_equal(bits_np(ocols[k]), bits_np(want[n])):
            fail(f"functions: column {n} differs from the numpy oracle")
    eps = N / wall
    _report("functions", N, SEND, n_sends, len(ots), eps, launches, card,
            f" (sqrt {gaps['sq']} ulp, ln {gaps['lnp']} ulp from numpy's)")
    h = rt.get_input_handler("Trade")
    chunk = _chunker(ts_all, cols_all, N)
    p50, p99 = _latency(h, chunk, SEND, 8)
    p50k, p99k = _latency(h, chunk, 1024, 64)
    print(f"functions latency per send: {SEND} rows p50 {p50:.3f} ms, p99 "
          f"{p99:.3f} ms; 1,024 rows p50 {p50k:.3f} ms, p99 {p99k:.3f} ms "
          f"({card})", flush=True)
    # K2 at the path's shape: the query's one program over a 65,536-row
    # chunk (kernel arguments built once)
    ts_c, cols_c = chunk(SEND)
    batch = batch_from_columns(rt.schemas["Trade"], ts_c, cols_c,
                               capacity=SEND, device=dev)
    prog = rt.queries["q"].program
    emitted = torch.zeros((), dtype=torch.int64, device=dev)
    oc, on, ov = expr_eval(prog, batch, emitted)
    lib = _kernels.load()
    stream = torch.cuda.current_stream().cuda_stream
    p2 = expr_params(prog, batch, oc, on, ov, emitted)
    k2_ms = cuda_ms(lambda: lib.expr_eval(p2, stream), reps=200)
    k2_plain = cuda_ms(lambda: expr_eval_ref(prog, batch, None), reps=20)
    in_bytes = sum(batch.cols[i].element_size() + 1 if isinstance(i, int)
                   else 8 for i in prog.inputs)
    out_bytes = sum(o.element_size() + 1 for o in oc)
    n_bytes = SEND * (in_bytes + 4 + 1 + out_bytes + 1) + 8
    n_ops = SEND * len(prog.code)
    bound, by = bound_of(n_bytes, n_ops)
    print(f"expr_eval (K2, the functions program: {len(prog.code)} "
          f"instructions): {k2_ms:.5f} ms per {SEND}-row chunk, plain "
          f"version {k2_plain:.4f} ms, bound {bound:.5f} ms ({n_bytes} "
          f"bytes, {n_ops} operations: {by}); {card}", flush=True)
    _kernels.LAUNCHES.update(launches)
    rt.shutdown()
    del outs
    gc.collect()
    return {"events_per_s_device_batches": eps, "rows": len(ots),
            "p50_ms_send": p50, "p99_ms_send": p99, "p50_ms_1024": p50k,
            "p99_ms_1024": p99k, "launches": launches, "k2_ms": k2_ms,
            "k2_plain_ms": k2_plain, "k2_bound_ms": bound,
            "k2_bound_by": by, "ulp": gaps, "card": card}


def polar_phase(dev, card: str, n_sends: int = 16) -> dict:
    """polar: Siddhi's documented pol2Cart usage (checks.POLAR_APP:
    radar returns over 5 m to Cartesian tracks and a bearing) end to end
    on the card: 1,048,576 returns in 16 sends of 65,536 against
    checks.polar_oracle (ids and cartZ bit for bit; cartX, cartY and the
    bearing within 4 ulp of numpy's); K1 and K2 on every send; events/s
    and latency."""
    from siddhi_tpu_torch import _kernels
    from siddhi_tpu_torch import checks as C
    SEND = KEYED_SEND
    N = n_sends * SEND
    ts_all, cols_all = C.radar_feed(N + 9 * SEND + 70 * 1024)
    rt, outs, wall, launches = _path_run(C.POLAR_APP, "Radar", ts_all,
                                         cols_all, N, SEND)
    if launches["unpack_packed"] != n_sends or \
            launches["expr_eval"] < 2 * n_sends:
        fail(f"polar: launches {launches}")
    ots, ocols, _on = C.emitted_columns(outs)
    want = C.polar_oracle(ts_all[:N], [c[:N] for c in cols_all])
    if not (np.array_equal(ots, want["ts"])
            and np.array_equal(ocols[0], want["id"])
            and np.array_equal(bits_np(ocols[3]), bits_np(want["cartZ"]))):
        fail(f"polar: {len(ots)} rows, the oracle {len(want['ts'])}")
    gaps = {n: C.ulp_gap(ocols[k], want[n])
            for k, n in ((1, "cartX"), (2, "cartY"), (4, "bearing"))}
    if max(gaps.values()) > 4:
        fail(f"polar: ulp gaps {gaps} past 4")
    eps = N / wall
    _report("polar", N, SEND, n_sends, len(ots), eps, launches, card,
            f" (ulp from numpy's: {gaps})")
    h = rt.get_input_handler("Radar")
    chunk = _chunker(ts_all, cols_all, N)
    p50, p99 = _latency(h, chunk, SEND, 8)
    p50k, p99k = _latency(h, chunk, 1024, 64)
    print(f"polar latency per send: {SEND} rows p50 {p50:.3f} ms, p99 "
          f"{p99:.3f} ms; 1,024 rows p50 {p50k:.3f} ms, p99 {p99k:.3f} ms "
          f"({card})", flush=True)
    _kernels.LAUNCHES.update(launches)
    rt.shutdown()
    return {"events_per_s_device_batches": eps, "rows": len(ots),
            "p50_ms_send": p50, "p99_ms_send": p99, "p50_ms_1024": p50k,
            "p99_ms_1024": p99k, "launches": launches, "ulp": gaps,
            "card": card}


def _union_overflow(q) -> int:
    st = q.states[-1]
    return sum(int(t["overflow"]) for t in st["tables"] if "vals" in t)


def distinct_phase(dev, card: str, n_sends: int = 16) -> dict:
    """distinct_symbols: Siddhi's documented unionSet query (createSet
    per quote, unionSet and sizeOfSet over a 10 s timeBatch) end to end
    on the card: two feeds of 1,048,576 quotes in 16 sends of 65,536, 24
    Zipf-skewed symbols (every set fits its 32 lanes: overflow 0) and
    512 uniform (the overflow counted), each against
    checks.distinct_oracle (the emitted rows' times, sets and sizes; the
    unionSet and window overflow); the 24-symbol run also through a row
    callback, whose frozensets the host edge decodes; K1, K2, K5, K6 and
    H on every step; then events/s, latency at 65,536 and 1,024 rows
    (the latter's quotes 16 ms apart, so that each send closes a
    batch), and H's time at the path's shape against its plain version,
    its bound and torch.sort with torch.unique_consecutive."""
    from siddhi_tpu_torch import StreamCallback, _kernels
    from siddhi_tpu_torch import checks as C
    from siddhi_tpu_torch.core.types import GLOBAL_STRINGS, SET_EMPTY
    enc = GLOBAL_STRINGS.encode
    SEND = KEYED_SEND
    N = n_sends * SEND
    res = {"card": card}
    for n_syms in (24, 512):
        label = f"distinct_symbols {n_syms}"
        ts_all, cols_all = C.distinct_feed(N + 8 * SEND, enc, n_syms)
        rt, outs, wall, launches = _path_run(
            C.DISTINCT_APP, "stockStream", ts_all, cols_all, N, SEND)
        if launches["unpack_packed"] != n_sends or \
                launches["window_step"] < n_sends or \
                launches["union_set"] < 2 * n_sends or \
                launches["aggregate_step"] < n_sends or \
                launches["aggregate_emit"] < n_sends:
            fail(f"{label}: launches {launches}")
        q = rt.queries["q"]
        want, u_over, w_over = C.distinct_oracle(
            ts_all[:N], [c[:N] for c in cols_all], SEND)
        ots, ocols, onulls = C.emitted_columns(outs)
        got_sets = [np.sort(r[1:][r[1:] != SET_EMPTY]) for r in ocols[0]]
        ok = len(ots) == len(want) and all(
            t == w[0] and np.array_equal(s, w[1]) and int(n) == w[2]
            for t, s, n, w in zip(ots, got_sets, ocols[1], want))
        wov = int(q.states[0]["overflow"])
        uov = _union_overflow(q)
        if not ok or uov != u_over or wov != w_over or \
                any(n.any() for n in onulls):
            fail(f"{label}: {len(ots)} rows, the oracle {len(want)}; "
                 f"unionSet overflow {uov} (oracle {u_over}), window "
                 f"overflow {wov} (oracle {w_over})")
        eps = N / wall
        _report(label, N, SEND, n_sends, len(ots), eps, launches, card,
                f"; unionSet overflow {uov} and window overflow {wov}, the "
                "oracle's")
        r = {"events_per_s_device_batches": eps, "rows": len(ots),
             "union_overflow": uov, "window_overflow": wov,
             "launches": launches}
        if n_syms == 24:
            # the host edge: a row callback decodes the frozensets
            rows = []
            rt2 = rt.manager.create_siddhi_app_runtime(C.DISTINCT_APP)
            rt2.add_callback("distinctStockStream", StreamCallback(
                lambda evs: rows.extend(e.data for e in evs)))
            rt2.start()
            _send_all(rt2.get_input_handler("stockStream"), ts_all[:N],
                      [c[:N] for c in cols_all],
                      tuple(range(0, N + 1, SEND)))
            rt2.shutdown()
            names = [frozenset(GLOBAL_STRINGS.decode(int(c)) for c in w[1])
                     for w in want]
            if [d[0] for d in rows] != names or \
                    [d[1] for d in rows] != [w[2] for w in want]:
                fail(f"{label}: the decoded rows differ from the oracle")
            print(f"{label}: {len(rows)} rows through a row callback, the "
                  "decoded frozensets equal the oracle's", flush=True)
            # latency: 65,536-row sends, then 1,024-row sends 16 ms apart
            h = rt.get_input_handler("stockStream")
            chunk = _chunker(ts_all, cols_all, N)
            p50, p99 = _latency(h, chunk, SEND, 4)
            lts, lcols = C.distinct_feed(70 * 1024, enc, n_syms, seed=9)
            lts = int(ts_all[-1]) + 16 * (
                np.arange(len(lts), dtype=np.int64) + 1)
            p50k, p99k = _latency(h, _chunker(lts, lcols, 0), 1024, 64)
            r.update(p50_ms_send=p50, p99_ms_send=p99, p50_ms_1024=p50k,
                     p99_ms_1024=p99k)
            print(f"{label} latency per send: {SEND} rows p50 {p50:.3f} "
                  f"ms, p99 {p99:.3f} ms; 1,024 rows p50 {p50k:.3f} ms, "
                  f"p99 {p99k:.3f} ms ({card})", flush=True)
        else:
            r.update(_h_times(rt, dev, card, int(ts_all[N - 1])))
        _kernels.LAUNCHES.update(launches)
        rt.shutdown()
        del outs
        gc.collect()
        res[label] = r
    return res


def _h_times(rt, dev, card, last_ts: int) -> dict:
    """Kernel H alone at the path's shape: one unionSet step over a flush
    of the 512-symbol feed (its K6 part 1 run once), against its plain
    version, its bound and the nearest library calls (torch.sort of the
    same pair values, then torch.unique_consecutive with counts)."""
    from siddhi_tpu_torch import _kernels
    from siddhi_tpu_torch import checks as C
    from siddhi_tpu_torch.core.types import GLOBAL_STRINGS, SET_LANES
    from siddhi_tpu_torch.ops import aggregators as G
    captured = []
    k_agg = G.aggregate_step

    def capture(op, state, key_cols, arg_cols, kind, valid):
        captured.append((op, tree_clone(state), key_cols, arg_cols, kind,
                         valid))
        return k_agg(op, state, key_cols, arg_cols, kind, valid)
    G.aggregate_step = capture
    try:
        h = rt.get_input_handler("stockStream")
        ts, cols = C.distinct_feed(2 * KEYED_SEND, GLOBAL_STRINGS.encode,
                                   512, seed=13)
        ts = ts + (last_ts + 1 - C.TS0)
        _send_all(h, ts, cols, (0, KEYED_SEND, 2 * KEYED_SEND))
        torch.cuda.synchronize()
    finally:
        G.aggregate_step = k_agg
    op, state, key_cols, arg_cols, kind, valid = max(
        captured, key=lambda c: int(c[5].sum()))
    B = kind.shape[0]
    s = next(i for i, sp in enumerate(op.agg_specs)
             if isinstance(sp, G.UnionSetAgg))
    spec, arg = op.agg_specs[s], arg_cols[s]
    _slots, aggs, new_state, args, stats = G.agg_args(op, state, key_cols,
                                                      arg_cols, kind, valid)
    lib = _kernels.load()
    stream = torch.cuda.current_stream().cuda_stream
    lib.aggregate_step(args, stream, 1)
    ua = next(st for sp, st in stats if sp is spec)
    h_ms = cuda_ms(lambda: lib.union_set(args, ua, stream), reps=20)
    ctx = G.agg_context(op, state, key_cols, kind, valid)[0]
    tab = state["tables"][s]
    h_plain = cuda_ms(lambda: spec.run_ref(arg, ctx, tab), reps=5)
    n = SET_LANES * (1 + B)
    pairs = torch.cat([tab["vals"], arg[0][:, 1:].reshape(-1)])

    def library():
        v, _ = torch.sort(pairs)
        return torch.unique_consecutive(v, return_counts=True)
    lib_ms = cuda_ms(library, reps=20)
    n_bytes = 2 * B * (1 + SET_LANES) * 8 + B * (4 + 1 + 8 + 1 + 1) + \
        4 * SET_LANES * 8 + 32
    n_ops = 8 * 2 * n   # eight digit passes over n keys, rank and scatter
    bound, by = bound_of(n_bytes, n_ops)
    print(f"union_set (kernel H): {h_ms:.4f} ms a {B}-row step ({n} "
          f"(value, sign) pairs, {int(valid.sum())} rows of the flush); "
          f"plain version {h_plain:.3f} ms; torch.sort + "
          f"torch.unique_consecutive {lib_ms:.4f} ms; bound {bound:.5f} ms "
          f"({n_bytes} bytes, {n_ops} operations: {by}); {card}",
          flush=True)
    return {"h_ms": h_ms, "h_plain_ms": h_plain, "h_library_ms": lib_ms,
            "h_bound_ms": bound, "h_bound_by": by, "h_rows": B}


def h_time(dev, card: str, rounds: int = 5) -> list:
    """Kernel H's device time at distinct_symbols' 512-symbol shape
    (_h_times, 20 launches each), ``rounds`` times, each on a new flush
    of the feed. `python3 chip_smoke.py --h-time` prints it and nothing
    else; it uses only what H has had since it was ported, so a copy of
    this script run from another tree's root times that tree's H, and
    two trees compare within one call."""
    from siddhi_tpu_torch import checks as C
    from siddhi_tpu_torch.core.types import GLOBAL_STRINGS
    SEND = KEYED_SEND
    N = 4 * SEND
    ts_all, cols_all = C.distinct_feed(N + 2 * SEND, GLOBAL_STRINGS.encode,
                                       512)
    rt, _outs, _wall, _l = _path_run(C.DISTINCT_APP, "stockStream", ts_all,
                                     cols_all, N, SEND)
    last = int(ts_all[N - 1])
    out = []
    for _ in range(rounds):
        out.append(_h_times(rt, dev, card, last)["h_ms"])
        last += 2 * SEND   # past the quotes _h_times sent, 1 ms apart
    rt.shutdown()
    return out


def log_phase(dev, card: str, n_sends: int = 3, rows: int = 16) -> dict:
    """log: #log('INFO', 'checkpoint') over 3 sends of 16 rows on the
    card; each send's printed lines (a set: the reference prints
    asynchronously) equal checks.log_oracle's, and the rows pass
    through."""
    import contextlib
    import io
    from siddhi_tpu_torch import SiddhiManager, _kernels
    from siddhi_tpu_torch import checks as C
    ts, cols = C.log_feed(n_sends * rows)
    rt = SiddhiManager().create_siddhi_app_runtime(C.LOG_APP)
    outs = []
    rt.queries["q"].batch_callbacks.append(outs.append)
    rt.start()
    h = rt.get_input_handler("S")
    _kernels.reset_launches()
    for k in range(n_sends):
        s = slice(k * rows, (k + 1) * rows)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            h.send_arrays(ts[s], [c[s] for c in cols])
            torch.cuda.synchronize()
        got = set(buf.getvalue().splitlines())
        if got != set(C.log_oracle(ts[s], [c[s] for c in cols])):
            fail(f"log: send {k} printed {sorted(got)[:2]}...")
    launches = dict(_kernels.LAUNCHES)
    ots, ocols, _n = C.emitted_columns(outs)
    if not (np.array_equal(ots, ts) and np.array_equal(ocols[0], cols[0])):
        fail("log: the rows did not pass through")
    print(f"log: {n_sends} sends of {rows} rows; every send's printed "
          f"lines equal the oracle's; launches {launches} ({card})",
          flush=True)
    rt.shutdown()
    return {"launches": launches}


# ---------------------------------------------------------------------------
# slice 9: partition blocks (kernel K9p; K4, K5 and K6 with the slot axis)
# ---------------------------------------------------------------------------


def _bl(o):
    """An EventBatch as its tensors, in a fixed order."""
    return [o.ts, *o.cols, *o.nulls, o.kind, o.valid]


def _slot_bytes(o):
    """The bytes a slotted batch holds: a column the slots share (slot
    stride 0: the block's input batch) once, the valid masks in full."""
    return _nbytes([x[0] if x.dim() and x.stride(0) == 0 else x
                    for x in _bl(o)])


def _timed(fn, reps: int, warmup: int = 0):
    """cuda_ms(fn), and fn()'s last result (a plain version's, held
    against the kernel's on the same arguments)."""
    box = [None]
    ms = cuda_ms(lambda: box.__setitem__(0, fn()), reps=reps, warmup=warmup)
    return ms, box[0]


def _launch_ms(prep, launch, reps: int) -> float:
    """Mean device time of launch() alone (CUDA events around it), with
    prep() (a restore of the state it updates in place) before each."""
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for a, b in ev:
        prep()
        a.record()
        launch()
        b.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in ev) / reps


class PartitionCheck:
    """While installed, every launch of kernel K9p (route, compaction,
    due) and every launch of K4, K5 and K6 with a partition block's slot
    axis also runs the plain version on the same inputs (the un-slotted
    plain version once per slot, ops/slots.py per_slot); kernel and plain
    results (the slot table and masks, the compacted batch and its
    emitted and lost counters, the dues, every slot's state and output)
    must be bit-equal (tolerance 0). The runtime goes on with the
    kernel's. Launches without the slot axis pass through unchecked."""

    def __init__(self):
        from siddhi_tpu_torch.ops import aggregators as G
        from siddhi_tpu_torch.ops import nfa as N
        from siddhi_tpu_torch.ops import windows as W
        from siddhi_tpu_torch.parallel import partition as P
        self.G, self.N, self.W, self.P = G, N, W, P
        self.err = 0.0
        self.steps = {k: 0 for k in (
            "partition_route", "partition_compact", "partition_due",
            "nfa_scan[K]", "window_step[K]", "aggregate_step[K]",
            "aggregate_emit[K]")}
        self.shapes = set()
        self.lost = 0

    def _cmp(self, what, got, want):
        self.err = max(self.err, compare(what, got, want))

    def __enter__(self):
        G, N, W, P = self.G, self.N, self.W, self.P
        from siddhi_tpu_torch.ops.expr import expr_eval
        from siddhi_tpu_torch.ops.slots import per_slot
        self.saved = (P.route, P.compact, P.min_due, W.window_step,
                      G.aggregate_step, G.aggregate_emit, N.scan_step,
                      N.timer_step)
        (k_route, k_compact, k_due, k_win, k_agg, k_emit, k_scan,
         k_timer) = self.saved

        def route(spec, batch, now, tbl, K):
            ks, kv, kt = k_route(spec, batch, now, tbl, K)
            cols, nulls, _v = expr_eval(spec.program, batch, now=now)
            rs, rv, rt_ = P.route_ref(spec, cols, nulls, batch, tbl, K)
            self._cmp(f"K9p route {spec.kind} K={K} B={batch.capacity}",
                      [ks, kv] + tree_leaves(kt), [rs, rv] + tree_leaves(rt_))
            self.steps["partition_route"] += 1
            self.shapes.add(("route", spec.kind, K, batch.capacity))
            return ks, kv, kt

        def compact(out, cap, emitted, lost):
            e_ref, l_ref = emitted.clone(), lost.clone()
            l0 = int(lost.item())
            ko = k_compact(out, cap, emitted, lost)
            ro = P.compact_ref(out, cap, e_ref, l_ref)
            self._cmp(f"K9p compaction {list(out.ts.shape)} -> {cap}",
                      _bl(ko) + [emitted, lost], _bl(ro) + [e_ref, l_ref])
            self.lost += int(lost.item()) - l0
            self.steps["partition_compact"] += 1
            self.shapes.add(("compact", tuple(out.ts.shape), cap))
            return ko

        def min_due(dues):
            k = k_due(dues)
            self._cmp(f"K9p due over {len(dues)} queries", [k],
                      [P.min_due_ref(dues)])
            self.steps["partition_due"] += 1
            return k

        def window_step(op, state, batch, now):
            if batch.ts.dim() != 2:
                return k_win(op, state, batch, now)
            K = batch.ts.shape[0]
            ks, ko = k_win(op, state, batch, now)
            rs, ro = per_slot(lambda st, b: W.window_step_ref(op, st, b, now),
                              K, state, batch)
            what = f"K5[K] {type(op).__name__} {list(batch.ts.shape)}"
            self._cmp(what + " state", tree_leaves(ks), tree_leaves(rs))
            self._cmp(what + " output", _bl(ko), _bl(ro))
            self.steps["window_step[K]"] += 1
            self.shapes.add(("K5", type(op).__name__, K, batch.ts.shape[1]))
            return ks, ko

        def aggregate_step(op, state, key_cols, arg_cols, kind, valid):
            if kind.dim() != 2:
                return k_agg(op, state, key_cols, arg_cols, kind, valid)
            k = k_agg(op, state, key_cols, arg_cols, kind, valid)
            r = G.aggregate_step_ref(op, state, key_cols, arg_cols, kind,
                                     valid)
            self._cmp(f"K6[K] step {list(kind.shape)}", tree_leaves(k),
                      tree_leaves(r))
            self.steps["aggregate_step[K]"] += 1
            self.shapes.add(("K6", len(op.agg_specs), tuple(kind.shape)))
            return k

        def aggregate_emit(op, slots, qual, batch, oc, on, emitted=None):
            if batch.ts.dim() != 2:
                return k_emit(op, slots, qual, batch, oc, on, emitted)
            e_ref = emitted.clone() if emitted is not None else None
            ko = k_emit(op, slots, qual, batch, oc, on, emitted)
            ro = per_slot(lambda sl, q, b, c, n: G.aggregate_emit_ref(
                op, sl, q, b, c, n, e_ref), batch.ts.shape[0], slots, qual,
                batch, oc, on)
            self._cmp(f"K6[K] emission {list(batch.ts.shape)}",
                      _bl(ko) + ([emitted] if emitted is not None else []),
                      _bl(ro) + ([e_ref] if e_ref is not None else []))
            self.steps["aggregate_emit[K]"] += 1
            return ko

        def scan_step(eng, sid, table, batch, due=None):
            if batch.ts.dim() != 2:
                return k_scan(eng, sid, table, batch, due)
            before = tree_clone(table)
            kt, km = k_scan(eng, sid, table, batch, due)
            rt_, rm = per_slot(lambda t, b: eng.stream_step_ref(sid, t, b),
                               batch.ts.shape[0], before, batch)
            what = f"K4[K] stream step {list(batch.ts.shape)}"
            self._cmp(what + " table", tree_leaves(kt), tree_leaves(rt_))
            self._cmp(what + " matches", _bl(km), _bl(rm))
            self.steps["nfa_scan[K]"] += 1
            self.shapes.add(("K4", tuple(batch.ts.shape)))
            return kt, km

        def timer_step(eng, table, now, due=None):
            if table["state"].dim() != 2:
                return k_timer(eng, table, now, due)
            before = tree_clone(table)
            kt, km = k_timer(eng, table, now, due)
            rt_, rm = per_slot(lambda t: eng.timer_step_ref(t, now),
                               table["state"].shape[0], before)
            what = f"K4[K] timer step K={table['state'].shape[0]}"
            self._cmp(what + " table", tree_leaves(kt), tree_leaves(rt_))
            self._cmp(what + " matches", _bl(km), _bl(rm))
            self.steps["nfa_scan[K]"] += 1
            return kt, km

        P.route, P.compact, P.min_due = route, compact, min_due
        W.window_step = window_step
        G.aggregate_step, G.aggregate_emit = aggregate_step, aggregate_emit
        N.scan_step, N.timer_step = scan_step, timer_step
        return self

    def __exit__(self, *exc):
        G, N, W, P = self.G, self.N, self.W, self.P
        (P.route, P.compact, P.min_due, W.window_step, G.aggregate_step,
         G.aggregate_emit, N.scan_step, N.timer_step) = self.saved
        return False


def partition_against_plain(dev) -> float:
    """Kernel K9p (route, compaction, due) and the slotted launches of
    K4, K5 and K6 against their plain versions on the card, bit for bit
    (slot tables and masks, compacted batches with their emitted and
    lost counters, every slot's state and output), at every launch:
    each app of checks.PARTITION_APPS at 4 to 8 slots (value and range
    keys, length, time, timeBatch and lengthBatch windows, K6 plain and
    grouped, an inner stream, two queries on one stream, key overflow,
    a `within` pattern, an absent pattern fired by the scheduler's
    TIMER steps) over 1,200 events in uneven sends, the clock then
    driven a second past the last; a timeBatch flush of 32 slots whose
    131,072 rows overflow the compaction's 65,536 (lost counted); and
    the partition_avg (two sends of 8,192), partition_fraud and
    per-customer absence apps (two sends of 1,024) at 64 slots. -> max
    abs error (0)."""
    from siddhi_tpu_torch import SiddhiManager, _kernels
    from siddhi_tpu_torch import checks as C
    from siddhi_tpu_torch.core.types import GLOBAL_STRINGS
    enc = GLOBAL_STRINGS.encode
    mgr = SiddhiManager()
    saved = dict(_kernels.LAUNCHES)
    with PartitionCheck() as chk:
        for name, text in C.PARTITION_APPS.items():
            rt = mgr.create_siddhi_app_runtime(text)
            rt.start()
            ts, cols, cuts = C.partition_feed(1200, enc)
            _send_all(rt.get_input_handler("S"), ts, cols, cuts)
            with rt.barrier:
                rt.on_ingest_ts(int(ts[-1]) + 1000)
            st = {n: q.stats() for n, q in rt.queries.items()}
            rt.shutdown()
            if ("overflow" in name) != (st["q"]["overflow"] > 0):
                fail(f"K9p {name}: overflow {st['q']['overflow']}")
            print(f"K9p and K4/K5/K6 with slots, {name}: bit-equal to their "
                  f"plain versions ({len(cuts) - 1} sends; {st}; checked "
                  f"so far {chk.steps})", flush=True)
        # a compaction past its 65,536 rows: 32 slots flush 131,072 rows
        rt = mgr.create_siddhi_app_runtime(C.PART_STREAM + """
            @slots('32')
            partition with (sym of S) begin
              @info(name = 'q') @cap(window.size='8192')
              from S#window.timeBatch(1 sec) select sym, price
              insert into Out;
            end;""")
        rt.start()
        n = 131072
        _ts, cols, _cuts = C.partition_feed(n, enc, n_syms=32, seed=44,
                                            prefix="PB")
        ts = C.TS0 + (np.arange(n, dtype=np.int64) * 500) // n
        lost0 = chk.lost
        _send_all(rt.get_input_handler("S"), ts, cols,
                  tuple(range(0, n + 1, 8192)))
        with rt.barrier:
            rt.on_ingest_ts(int(ts[-1]) + 3000)
        st = rt.queries["q"].stats()
        rt.shutdown()
        if chk.lost - lost0 <= 0:
            fail(f"K9p: the timeBatch flush lost no row ({st})")
        print(f"K9p compaction past its cap: bit-equal, {chk.lost - lost0} "
              f"rows lost and counted ({st})", flush=True)
        # the two main paths' apps at 64 slots, a few sends each
        for name, text, stream, feed, send, n_sends in (
                ("partition_avg", C.PARTITION_AVG_APP.replace(
                    "@slots('1024')", "@slots('64')"), "StockStream",
                 lambda m: _avg_feed(m, enc, n_syms=48), 8192, 2),
                ("partition_fraud", C.PARTITION_FRAUD_APP.replace(
                    "@slots('2048')", "@slots('64')"), "Txn",
                 lambda m: C.txn_feed(m, enc, n_cards=48), 1024, 2),
                ("partition_absent", C.PARTITION_ABSENT_APP.replace(
                    "@slots('2048')", "@slots('64')"), "CustomerStream",
                 lambda m: C.customer_feed(m, enc, n_cust=48), 1024, 2)):
            rt = mgr.create_siddhi_app_runtime(text)
            rt.start()
            ts, cols = feed(send * n_sends)
            _send_all(rt.get_input_handler(stream), ts, cols,
                      tuple(range(0, send * n_sends + 1, send)))
            with rt.barrier:
                rt.on_ingest_ts(int(ts[-1]) + 2000)
            st = rt.queries["q"].stats()
            rt.shutdown()
            print(f"K9p and K4/K5/K6 with slots, {name} at 64 slots, "
                  f"{n_sends} sends of {send}: bit-equal ({st})", flush=True)
    _kernels.LAUNCHES.update(saved)   # not launches of a main path
    print(f"K9p, K4/K5/K6 with slots: shapes held against the plain "
          f"versions: {sorted(chk.shapes, key=str)}; launches checked "
          f"{chk.steps}", flush=True)
    for k, n in chk.steps.items():
        if n == 0:
            fail(f"kernel {k} was never held against its plain version")
    return chk.err


def _avg_feed(n: int, encode, n_syms: int = 512):
    """partition_avg's feed: checks.trades_feed without its exchange
    clock. -> (ts, [symbol codes, price, volume])."""
    from siddhi_tpu_torch import checks as C
    ts, (_ets, sym, price, vol) = C.trades_feed(n, encode, n_syms=n_syms)
    return ts, [sym, price, vol]


class _Capture:
    """While installed, keeps the arguments of the first call of each
    wrapped function (one step of a path, for timing its kernels at the
    path's own shape) in ``args``, and of its first ``limit`` calls in
    ``kept`` (steps that return new state leave their arguments as they
    were)."""

    def __init__(self, targets, limit: int = 1):
        self.targets = targets      # [(module, attribute, predicate)]
        self.limit = limit
        self.args, self.kept = {}, {}

    def __enter__(self):
        self.saved = [getattr(m, a) for m, a, _p in self.targets]
        for (m, a, pred), f in zip(self.targets, self.saved):
            def wrap(*args, _f=f, _a=a, _p=pred):
                kept = self.kept.setdefault(_a, [])
                if len(kept) < self.limit and _p(*args):
                    kept.append(args)
                    self.args.setdefault(_a, args)
                return _f(*args)
            setattr(m, a, wrap)
        return self

    def __exit__(self, *exc):
        for (m, a, _p), f in zip(self.targets, self.saved):
            setattr(m, a, f)
        return False


def _k9p_times(dev, cap) -> dict:
    """K9p's route and compaction at a path's shape (their arguments
    built once, the launches alone timed with CUDA events), their plain
    versions on the same arguments, each held against the kernel's
    results bit for bit (slots, masks and table; the compacted batch with
    its emitted and lost counters), the library call (a stable
    torch.sort of the keys and the gathers), and the bytes and
    operations of their bound. -> the times and the max abs error."""
    from siddhi_tpu_torch import _kernels
    from siddhi_tpu_torch.ops.expr import expr_eval
    from siddhi_tpu_torch.parallel import partition as P
    lib = _kernels.load()
    stream = torch.cuda.current_stream().cuda_stream
    spec, batch, now, tbl, K = cap["route"]
    cols, nulls, _v = expr_eval(spec.program, batch, now=now)
    ks, kv, kt, ra = P.route_args(spec, cols, nulls, batch, tbl, K)
    out, out_cap, emitted, lost = cap["compact"]
    e0, l0 = emitted.clone(), lost.clone()
    ek, lk = e0.clone(), l0.clone()
    kp, ca = P.compact_args(out, out_cap, ek, lk)
    lib.partition_compact(ca, stream)   # the launch held against the plain
    kcount = [ek.clone(), lk.clone()]
    route_ms = cuda_ms(lambda: lib.partition_route(ra, stream), reps=50)
    compact_ms = cuda_ms(lambda: lib.partition_compact(ca, stream), reps=10)
    route_plain, (rs, rv, rt_) = _timed(
        lambda: P.route_ref(spec, cols, nulls, batch, tbl, K), 3, 1)

    def plain_compact():
        e, l_ = e0.clone(), l0.clone()
        return P.compact_ref(out, out_cap, e, l_), e, l_
    compact_plain, (rp, re_, rl) = _timed(plain_compact, 3, 1)
    shape = f"{list(out.ts.shape)} -> {out_cap}"
    err = compare(f"K9p route at the path's shape (K={K}, "
                  f"B={batch.capacity})", [ks, kv] + tree_leaves(kt),
                  [rs, rv] + tree_leaves(rt_))
    err = max(err, compare(f"K9p compaction at the path's shape {shape}",
                           _bl(kp) + kcount, _bl(rp) + [re_, rl]))

    def library():
        fl = out.ts.reshape(-1)
        key = torch.where(out.valid.reshape(-1), fl,
                          torch.full_like(fl, 2 ** 62))
        order = torch.sort(key, stable=True).indices[:out_cap]
        return [x.reshape(-1)[order] for x in _bl(out)]
    lib_ms = cuda_ms(library, reps=10)
    B = batch.ts.shape[0]
    n = out.ts.numel()
    nv = int(out.valid.sum())
    row = sum(c[0, 0].element_size() + 1 for c in out.cols) + 8 + 4 + 1
    # route: the key, kind and valid of B rows, the table, the slots and
    # the K x B masks; compaction: the K * N rows' valid flags, the valid
    # rows' ts, out_cap rows read and written
    n_bytes = B * (cols[0].element_size() + 1 + 4 + 1 + 4) + 9 * K * 2 + \
        K * B + n + 8 * nv + 2 * out_cap * row
    n_ops = B * 16 + K * B + n
    bound, by = bound_of(n_bytes, n_ops)
    return {"ms": route_ms + compact_ms, "route_ms": route_ms,
            "compact_ms": compact_ms,
            "plain_ms": route_plain + compact_plain, "library_ms": lib_ms,
            "bound_ms": bound, "bound_by": by, "n_bytes": n_bytes,
            "shape": (K, B, n, out_cap), "valid": nv, "err": err}


def partition_avg_phase(dev, card: str, n_sends: int = 128) -> dict:
    """partition_avg: the Siddhi query guide's partition example (a
    per-symbol length(10) average through an inner stream, the averages
    above 75 out; checks.PARTITION_AVG_APP) end to end on the card
    through SiddhiManager, send_arrays and batch_callbacks: 1,048,576
    trades of 512 symbols (interned first) in 128 sends of 8,192 rows,
    each a step of 1,024 slots x 8,192 rows for every operator. Every
    row against checks.partition_avg_oracle (symbol, volume, timestamp
    exact; the average within 1e-12 relative of the exact mean) and the
    overflow equal to the oracle's slot table; the launch counters must
    show K9p's route and compaction, K5 and K6 with the slot axis, and
    K2 on every step. Then events/s, latency of a send, and each
    kernel's time at the path's shape (K9p's route and compaction, K5's
    and K6's step and emission with the slot axis, on one step's
    captured arguments) against its plain version on the same
    arguments, whose results must equal the kernel's bit for bit, its
    bound and (K9p) the library's sort."""
    from siddhi_tpu_torch import SiddhiManager, _kernels
    from siddhi_tpu_torch import checks as C
    from siddhi_tpu_torch.core.types import GLOBAL_STRINGS
    from siddhi_tpu_torch.ops import aggregators as G
    from siddhi_tpu_torch.ops import windows as W
    from siddhi_tpu_torch.parallel import partition as P
    enc = GLOBAL_STRINGS.encode
    SEND = 8192
    N = n_sends * SEND
    ts_all, cols_all = _avg_feed(N + 24 * SEND, enc)
    mgr = SiddhiManager()
    warm = mgr.create_siddhi_app_runtime(C.PARTITION_AVG_APP)
    warm.start()
    _send_all(warm.get_input_handler("StockStream"), ts_all[N:],
              [c[N:] for c in cols_all], (0, SEND, 2 * SEND))
    torch.cuda.synchronize()
    warm.shutdown()
    del warm
    rt = mgr.create_siddhi_app_runtime(C.PARTITION_AVG_APP)
    outs = []
    rt.queries["q"].batch_callbacks.append(outs.append)
    rt.start()
    h = rt.get_input_handler("StockStream")
    _kernels.reset_launches()
    t0 = time.perf_counter()
    for s in range(0, N, SEND):
        h.send_arrays(ts_all[s:s + SEND], [c[s:s + SEND] for c in cols_all])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_kernels.LAUNCHES)
    for k in ("partition_route", "partition_compact", "window_step[K]",
              "aggregate_step[K]", "aggregate_emit[K]"):
        if launches[k] != n_sends:
            fail(f"partition_avg: {k} launched {launches[k]} times, the "
                 f"steps {n_sends}")
    if launches["expr_eval"] < 2 * n_sends:
        fail(f"partition_avg: launches {launches}")
    ots, ocols, onulls = C.emitted_columns(outs)
    wts, wsym, wavg, wvol, wlost = C.partition_avg_oracle(
        ts_all[:N], *[c[:N] for c in cols_all], send=SEND,
        K=rt.partitions["partition_1"].K)
    if len(ots) != len(wts) or not np.array_equal(ots, wts) or \
            not np.array_equal(ocols[0], wsym) or \
            not np.array_equal(ocols[2], wvol) or any(n.any() for n in onulls):
        fail(f"partition_avg: {len(ots)} rows, the oracle {len(wts)}")
    rel = float(np.max(np.abs(ocols[1] - wavg) / np.abs(wavg)))
    if rel > 1e-12:
        fail(f"partition_avg: an average {rel} from the exact mean")
    st = rt.queries["q"].stats()
    if st != {"emitted": len(wts), "overflow": wlost}:
        fail(f"partition_avg: stats {st}, the oracle {len(wts)} rows, "
             f"overflow {wlost}")
    eps = N / wall
    _report("partition_avg", N, SEND, n_sends, len(ots), eps, launches, card,
            f" (averages within {rel:.2e} of the exact mean; overflow "
            f"{wlost} as the oracle's slot table)")
    chunk = _chunker(ts_all, cols_all, N)
    with _Capture([(P, "route", lambda *a: True),
                   (P, "compact", lambda *a: True),
                   (W, "window_step", lambda *a: a[2].ts.dim() == 2),
                   (G, "aggregate_step", lambda *a: a[4].dim() == 2),
                   (G, "aggregate_emit",
                    lambda *a: a[3].ts.dim() == 2)]) as cap:
        p50, p99 = _latency(h, chunk, SEND, 8)
    print(f"partition_avg latency per send: {SEND} rows p50 {p50:.3f} ms, "
          f"p99 {p99:.3f} ms ({card})", flush=True)
    # each kernel at the path's shape, on one step's captured arguments:
    # the launches timed, then held against the plain version's results
    # on the same arguments (bit for bit)
    k9 = _k9p_times(dev, cap.args)
    lib = _kernels.load()
    stream = torch.cuda.current_stream().cuda_stream
    from siddhi_tpu_torch.ops.slots import per_slot
    wop, wst, wb, wnow = cap.args["window_step"]
    wns, wout, wargs = W.window_args(wop, wst, wb, W._i64(wnow, dev))
    k5_ms = cuda_ms(lambda: lib.window_step(wargs, stream), reps=5)
    k5_plain, (rws, rwo) = _timed(lambda: per_slot(
        lambda s_, b_: W.window_step_ref(wop, s_, b_, wnow),
        wb.ts.shape[0], wst, wb), 1)
    err = max(k9["err"], compare(
        f"K5[K] at the path's shape {list(wb.ts.shape)}",
        tree_leaves(wns) + _bl(wout), tree_leaves(rws) + _bl(rwo)))
    del rws, rwo
    aop, ast, kc, ac, akind, avalid = cap.args["aggregate_step"]
    asl, aag, ans, aargs, _st = G.agg_args(aop, ast, kc, ac, akind, avalid)
    k6_ms = cuda_ms(lambda: lib.aggregate_step(aargs, stream, 3), reps=5)
    k6_plain, ra = _timed(lambda: G.aggregate_step_ref(aop, ast, kc, ac,
                                                       akind, avalid), 1)
    err = max(err, compare(f"K6[K] step at the path's shape "
                           f"{list(akind.shape)}",
                           tree_leaves((asl, aag, ans)), tree_leaves(ra)))
    del ra
    eop, esl, eq, eb, eoc, eon, eem = cap.args["aggregate_emit"]
    ek = eem.clone() if eem is not None else None
    er = eem.clone() if eem is not None else None
    eout, eargs = G.emit_args(eop, esl, eq, eb, eoc, eon, ek)
    lib.aggregate_emit(eargs, stream)   # the launch held against the plain
    ekept = [ek.clone()] if ek is not None else []
    emit_ms = cuda_ms(lambda: lib.aggregate_emit(eargs, stream), reps=5)

    def plain_emit():
        e = er.clone() if er is not None else None
        return per_slot(lambda sl, q, b, c, n: G.aggregate_emit_ref(
            eop, sl, q, b, c, n, e), eb.ts.shape[0], esl, eq, eb, eoc,
            eon), e
    emit_plain, (reo, ree) = _timed(plain_emit, 1)
    err = max(err, compare(f"K6[K] emission at the path's shape "
                           f"{list(eb.ts.shape)}", _bl(eout) + ekept,
                           _bl(reo) + ([ree] if ree is not None else [])))
    del reo
    print(f"K9p, K5[K] and K6[K] (step and emission) at partition_avg's "
          f"shapes: bit-equal to their plain versions on the same "
          f"arguments (max abs error {err})", flush=True)
    Kw, Bw = wb.ts.shape
    # the block's batch columns are shared by the slots: read once
    win_bytes = _slot_bytes(wb) + _nbytes(_bl(wout)) + \
        2 * _nbytes(tree_leaves(wst))
    k5_bound, k5_by = bound_of(win_bytes, Kw * (wargs.N + wargs.P))
    # the library's yardstick: a batched stable sort of the emission's
    # keys (the output's ts) along the row axis
    k5_lib = cuda_ms(lambda: torch.sort(wout.ts, dim=1, stable=True),
                     reps=5)
    agg_bytes = _nbytes([akind, avalid]) + \
        _nbytes([t for c in (kc + [a for a in ac if a is not None])
                 for t in c]) + 2 * _nbytes(tree_leaves(ast)) + \
        akind.numel() * (8 + 1) * len(aop.agg_specs)
    k6_bound, k6_by = bound_of(agg_bytes, akind.numel() * 8)
    # the emission: the qualifying flags, the slots and the rows in, the
    # rows out
    emit_bytes = _nbytes([esl, eq]) + _slot_bytes(eb) + \
        _nbytes(list(eoc) + list(eon)) + _nbytes(_bl(eout))
    emit_bound, emit_by = bound_of(emit_bytes, eb.ts.numel() * 8)
    torch.cuda.synchronize()
    print(f"K9p at partition_avg's step ({k9['shape'][0]} slots, "
          f"{k9['shape'][1]} rows routed, {k9['shape'][2]} rows compacted "
          f"to {k9['shape'][3]}): route {k9['route_ms']:.4f} ms + compaction "
          f"{k9['compact_ms']:.4f} ms, plain version {k9['plain_ms']:.3f} ms, "
          f"torch.sort(stable) + gathers {k9['library_ms']:.4f} ms, bound "
          f"{k9['bound_ms']:.5f} ms ({k9['bound_by']}); {card}", flush=True)
    print(f"window_step[K] (K5, length(10), {Kw} slots x {Bw} rows): "
          f"{k5_ms:.3f} ms, plain version (once per slot) {k5_plain:.1f} ms, "
          f"bound {k5_bound:.4f} ms ({k5_by}), torch.sort(dim=1, stable) "
          f"{k5_lib:.4f} ms; aggregate_step[K] (K6, avg, "
          f"{list(akind.shape)}): {k6_ms:.3f} ms, plain version "
          f"{k6_plain:.1f} ms, bound {k6_bound:.4f} ms ({k6_by}); "
          f"aggregate_emit[K] ({list(eb.ts.shape)}): {emit_ms:.3f} ms, "
          f"plain version {emit_plain:.1f} ms, bound {emit_bound:.4f} ms "
          f"({emit_by}); {card}", flush=True)
    _kernels.LAUNCHES.update(launches)
    rt.shutdown()
    del outs, cap
    gc.collect()
    return {"events_per_s_device_batches": eps, "rows": len(ots),
            "p50_ms_send": p50, "p99_ms_send": p99, "launches": launches,
            "k9": k9, "k5_ms": k5_ms, "k5_plain_ms": k5_plain,
            "k5_bound_ms": k5_bound, "k5_bound_by": k5_by,
            "k5_library_ms": k5_lib, "k6_ms": k6_ms,
            "k6_plain_ms": k6_plain, "k6_bound_ms": k6_bound,
            "k6_bound_by": k6_by, "emit_ms": emit_ms,
            "emit_plain_ms": emit_plain, "emit_bound_ms": emit_bound,
            "emit_bound_by": emit_by, "err": err, "card": card}


def partition_fraud_phase(dev, card: str, n_sends: int = 64,
                          absent_sends: int = 16) -> dict:
    """partition_fraud: a per-card pattern (checks.PARTITION_FRAUD_APP:
    every small purchase followed by a large one within 10 min) end to
    end on the card through SiddhiManager, send_arrays and
    batch_callbacks: 262,144 transactions of 1,024 Zipf-skewed cards in
    64 sends of 4,096, at 2,048 slots, every alert against
    checks.fraud_oracle in order (timestamp, card, amount exact; the
    oracle's slot table, no pending table or match batch past its
    capacity). Then the per-customer absence of
    AbsentPatternTestCase.testQueryAbsent43 (checks.PARTITION_ABSENT_APP)
    over 65,536 visits of 1,024 customers in 16 sends of 4,096, the
    clock then driven 2 s past the last visit so that the scheduler's
    TIMER step fires every pending deadline; its alerts against
    checks.absent_oracle (a deadline fires in the step that passes it,
    so the rows compare sorted by (timestamp, customer); each output
    batch is in timestamp order). The launch counters must show K9p's
    route, compaction and due, K4 with the slot axis (stream and timer
    steps) and K2. Then events/s, latency of a send, and K4's time with
    the slot axis at the fraud step's shape against its plain version
    (whose table and matches must equal the kernel's, bit for bit, on
    the same table and batch) and its bound; the absence's latency of a
    send and K9p's due at its shape, held against its plain version."""
    from siddhi_tpu_torch import SiddhiManager, _kernels
    from siddhi_tpu_torch import checks as C
    from siddhi_tpu_torch.core.types import GLOBAL_STRINGS
    from siddhi_tpu_torch.ops import nfa as NF
    enc = GLOBAL_STRINGS.encode
    SEND = 4096
    N = n_sends * SEND
    ts_all, cols_all = C.txn_feed(N + 16 * SEND, enc)
    mgr = SiddhiManager()
    rt = mgr.create_siddhi_app_runtime(C.PARTITION_FRAUD_APP)
    outs = []
    rt.queries["q"].batch_callbacks.append(outs.append)
    rt.start()
    h = rt.get_input_handler("Txn")
    h.send_arrays(ts_all[N:N + SEND], [c[N:N + SEND] for c in cols_all])
    torch.cuda.synchronize()
    rt.shutdown()
    # the measured run: a fresh runtime (the warm one's table is not the
    # oracle's)
    rt = mgr.create_siddhi_app_runtime(C.PARTITION_FRAUD_APP)
    outs = []
    rt.queries["q"].batch_callbacks.append(outs.append)
    rt.start()
    h = rt.get_input_handler("Txn")
    _kernels.reset_launches()
    t0 = time.perf_counter()
    for s in range(0, N, SEND):
        h.send_arrays(ts_all[s:s + SEND], [c[s:s + SEND] for c in cols_all])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_kernels.LAUNCHES)
    for k in ("partition_route", "nfa_scan[K]", "partition_compact"):
        if launches[k] != n_sends:
            fail(f"partition_fraud: {k} launched {launches[k]} times, the "
                 f"steps {n_sends}")
    ots, ocols, onulls = C.emitted_columns(outs)
    wts, wcard, wamt, wlost, max_pend, max_step = C.fraud_oracle(
        ts_all[:N], *[c[:N] for c in cols_all], send=SEND,
        K=rt.partitions["partition_1"].K)
    if max_pend >= 32 or max_step >= 64:
        fail(f"partition_fraud: the feed needs {max_pend} pending rows, "
             f"{max_step} matches a step (32, 64)")
    if not (np.array_equal(ots, wts) and np.array_equal(ocols[0], wcard)
            and np.array_equal(bits_np(ocols[1]), bits_np(wamt))
            and not any(n.any() for n in onulls)):
        fail(f"partition_fraud: {len(ots)} alerts, the oracle {len(wts)}")
    st = rt.queries["q"].stats()
    if st != {"emitted": len(wts), "overflow": wlost}:
        fail(f"partition_fraud: stats {st}, the oracle {len(wts)}, "
             f"{wlost}")
    eps = N / wall
    _report("partition_fraud", N, SEND, n_sends, len(ots), eps, launches,
            card, f" (overflow {wlost}; at most {max_pend} pending matches "
            f"of a card, {max_step} matches of a card in a send)")
    chunk = _chunker(ts_all, cols_all, N)
    with _Capture([(NF, "scan_step", lambda *a: a[3].ts.dim() == 2)]) as cap:
        p50, p99 = _latency(h, chunk, SEND, 8)
    print(f"partition_fraud latency per send: {SEND} rows p50 {p50:.3f} ms, "
          f"p99 {p99:.3f} ms ({card})", flush=True)
    # K4 with the slot axis at the fraud step's shape, on one step's
    # captured batch and a copy of the block's table: one launch held
    # against the plain version on the same table and batch (bit for
    # bit), then the launch alone timed, the table restored before each
    # (K4 updates it in place)
    from siddhi_tpu_torch.ops.slots import per_slot
    eng, sid, table, batch = cap.args["scan_step"][:4]
    lib = _kernels.load()
    stream = torch.cuda.current_stream().cuda_stream
    pre = tree_clone(table)
    work = tree_clone(pre)
    lead = tuple(work["state"].shape[:-1])
    kout = NF.kernel_out(eng, dev, lead)
    sargs = NF.scan_args(eng, sid, work, batch, 0, kout, None, dev)
    lib.nfa_scan(sargs, stream)
    k4_plain, (rt_, rm) = _timed(lambda: per_slot(
        lambda t, b: eng.stream_step_ref(sid, t, b), batch.ts.shape[0],
        tree_clone(pre), batch), 1)
    kmatch = [kout["ts"], *kout["cols"], *kout["nulls"], kout["kind"],
              kout["valid"]]
    err = compare(f"K4[K] stream step at the path's shape "
                  f"{list(batch.ts.shape)}",
                  tree_leaves(work) + kmatch, tree_leaves(rt_) + _bl(rm))
    print(f"K4[K] at partition_fraud's shape: bit-equal to its plain "
          f"version on the same table and batch (max abs error {err})",
          flush=True)
    del rt_, rm
    wl, pl = tree_leaves(work), tree_leaves(pre)

    def restore():
        for w, p_ in zip(wl, pl):
            w.copy_(p_)
    k4_ms = _launch_ms(restore, lambda: lib.nfa_scan(sargs, stream), reps=3)
    # the batch's columns are the block's, shared by the slots: read once
    k4_bytes = _slot_bytes(batch) + 2 * _nbytes(tree_leaves(table)) + \
        _nbytes([kout["ts"], kout["valid"], kout["kind"], *kout["cols"],
                 *kout["nulls"]])
    Kf, Bf = batch.ts.shape
    k4_bound, k4_by = bound_of(k4_bytes, Kf * Bf * len(eng.program.code))
    print(f"nfa_scan[K] (K4, {Kf} slots x {Bf} events, {eng.M} rows a "
          f"slot): {k4_ms:.3f} ms, plain version (once per slot) "
          f"{k4_plain:.1f} ms, bound {k4_bound:.5f} ms ({k4_by}); {card}",
          flush=True)
    _kernels.LAUNCHES.update(launches)
    rt.shutdown()
    del outs, cap
    gc.collect()

    # the per-customer absence, fired by the scheduler's TIMER step
    AS = 4096
    NA = absent_sends * AS
    ts_a, cols_a = C.customer_feed(NA + 9 * AS, enc)
    # the latency sends: the same feed's tail, 3 s past the alerts' clock
    ts_x, cols_x = ts_a[NA:] + 3000, [c[NA:] for c in cols_a]
    ts_a, cols_a = ts_a[:NA], [c[:NA] for c in cols_a]
    rt = mgr.create_siddhi_app_runtime(C.PARTITION_ABSENT_APP)
    outs = []
    rt.queries["q"].batch_callbacks.append(outs.append)
    rt.start()
    h = rt.get_input_handler("CustomerStream")
    _kernels.reset_launches()
    t0 = time.perf_counter()
    for s in range(0, NA, AS):
        h.send_arrays(ts_a[s:s + AS], [c[s:s + AS] for c in cols_a])
    with rt.barrier:
        rt.on_ingest_ts(int(ts_a[-1]) + 2000)
    torch.cuda.synchronize()
    wall_a = time.perf_counter() - t0
    la = dict(_kernels.LAUNCHES)
    if la["partition_route"] != absent_sends or \
            la["nfa_scan[K]"] <= absent_sends or la["partition_due"] == 0:
        fail(f"partition_absent: launches {la} (a timer step is a K4 launch "
             f"beyond the {absent_sends} stream steps)")
    for o in outs:
        v = o.valid.cpu().numpy()
        t = o.ts.cpu().numpy()[v]
        if (np.diff(t) < 0).any():
            fail("partition_absent: an output batch is not in ts order")
    ots, ocols, _on = C.emitted_columns(outs)
    wts, wcust, wlost = C.absent_oracle(ts_a, cols_a[0], send=AS,
                                        K=rt.partitions["partition_1"].K)
    order = np.lexsort((ocols[0], ots))
    if not (np.array_equal(ots[order], wts)
            and np.array_equal(ocols[0][order], wcust)):
        fail(f"partition_absent: {len(ots)} alerts, the oracle {len(wts)}")
    st = rt.queries["q"].stats()
    if st != {"emitted": len(wts), "overflow": wlost}:
        fail(f"partition_absent: stats {st}, the oracle {len(wts)}, "
             f"{wlost}")
    eps_a = NA / wall_a
    _report("partition_absent", NA, AS, absent_sends, len(ots), eps_a, la,
            card, " (sorted by timestamp and customer; the last deadlines "
            "fired by the scheduler's TIMER step)")
    from siddhi_tpu_torch.parallel import partition as P
    with _Capture([(P, "min_due", lambda *a: True)]) as cap:
        p50a, p99a = _latency(h, _chunker(ts_x, cols_x, 0), AS, 8)
    print(f"partition_absent latency per send: {AS} rows p50 {p50a:.3f} ms, "
          f"p99 {p99a:.3f} ms ({card})", flush=True)
    # K9p's due at this block's shape (2,048 slot dues of one query)
    (dues,) = cap.args["min_due"]
    dout, dargs = P.due_args(dues)
    due_ms = cuda_ms(lambda: lib.partition_due(dargs, stream), reps=50)
    due_plain, rdue = _timed(lambda: P.min_due_ref(dues), 20)
    err = max(err, compare("K9p due at the path's shape", [dout], [rdue]))
    print(f"K9p due ({sum(d.numel() for d in dues)} slot dues): "
          f"{due_ms:.5f} ms, plain version {due_plain:.4f} ms ({card})",
          flush=True)
    rt.shutdown()
    del outs, cap
    gc.collect()
    return {"events_per_s_device_batches": eps, "rows": len(wts),
            "p50_ms_send": p50, "p99_ms_send": p99, "launches": launches,
            "absent_launches": la, "absent_events_per_s": eps_a,
            "absent_p50_ms_send": p50a, "absent_p99_ms_send": p99a,
            "due_ms": due_ms, "due_plain_ms": due_plain,
            "k4_ms": k4_ms, "k4_plain_ms": k4_plain, "k4_bound_ms": k4_bound,
            "k4_bound_by": k4_by, "err": err, "card": card}



# ---------------------------------------------------------------------------
# slice 10: incremental aggregation (kernel K11) and named windows
# ---------------------------------------------------------------------------


def _k11_step(ar, state, batch, now, what: str):
    """One K11 step and its plain version on the same arguments, the
    whole new state held bit for bit. -> (the kernel's new state, the
    max abs error)."""
    from siddhi_tpu_torch import _kernels
    from siddhi_tpu_torch.core import aggregation as AG
    gcols, args, ets = AG.step_inputs(ar, batch, now)
    new, a = AG.aggr_args(ar, state, batch, gcols, args, ets)
    _kernels.load().aggregation_step(
        a, torch.cuda.current_stream().cuda_stream)
    ref = AG.aggregation_step_ref(ar, state, batch, gcols, args, ets)
    return new, compare(what, tree_leaves(new), tree_leaves(ref))


def aggregation_against_plain(dev) -> float:
    """Kernel K11 against its plain version on the card, the whole
    per-duration state (keys, used, bucket starts, group values and
    nulls, every lane, overflow) bit for bit after every step: every
    aggregator over INT, LONG, DOUBLE and FLOAT arguments with nulls, a
    STRING and an INT group key (nulls too) and every duration
    (checks.K11_CHECK_APP) on the 'mixed' feed at 16-, 1,024- and
    16,384-row batches with invalid and EXPIRED rows among them, the
    order-sensitive float feed and a feed of more keys than the 4,096
    slots. -> the max abs error (0: bit-equal)."""
    from siddhi_tpu_torch import SiddhiManager
    from siddhi_tpu_torch import checks as C
    from siddhi_tpu_torch.core.event import EventBatch
    from siddhi_tpu_torch.core.types import GLOBAL_STRINGS
    err, steps = 0.0, 0
    # the synthetic feeds at up to 16,384 rows: the plain version folds
    # rank by rank, and a year's slot holds thousands of their rows; the
    # path's own 65,536-row steps are held in aggregation_phase
    big = AGG_SEND // 4
    for kind, sizes in (("mixed", ((16, 11), (1024, 700), (big, big),
                                   (1024, 1024), (big, big * 5 // 8))),
                        ("order", ((16, 16), (1024, 1024), (big, big))),
                        ("overflow", ((8192, 8192), (8192, 8192),
                                      (big, big * 15 // 16)))):
        rt = SiddhiManager().create_siddhi_app_runtime(C.K11_CHECK_APP)
        ar = rt.aggregations["A"]
        state = ar.state
        for i, (cap, n) in enumerate(sizes):
            ts, cols, nulls = C.k11_check_feed(
                kind, n, cap, GLOBAL_STRINGS.encode, seed=100 + i)
            t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
            valid = np.arange(cap) < n
            kinds = np.zeros(cap, np.int32)
            if kind == "mixed":
                valid[::17] = False
                kinds[5::13] = 1    # EXPIRED rows do not aggregate
            batch = EventBatch(ts=t(ts), cols=[t(c) for c in cols],
                               nulls=[t(m) for m in nulls], kind=t(kinds),
                               valid=t(valid))
            state, e = _k11_step(ar, state, batch, 0,
                                 f"K11 {kind} step {i} ({cap} rows)")
            err = max(err, e)
            steps += 1
        ovf = [int(x) for x in state["overflow"]]
        if kind == "overflow" and ovf[0] == 0:
            fail(f"K11 overflow feed: no overflow ({ovf})")
        rt.shutdown()
    torch.cuda.synchronize()
    print(f"K11 aggregation_step: bit-equal to its plain version over "
          f"{steps} steps (mixed, float-order and overflow feeds, every "
          f"duration; the whole state after every step)", flush=True)
    return err


def aggregation_phase(dev, card: str, n_sends: int = 16) -> dict:
    """aggregation_trades: the Siddhi query guide's incremental
    aggregation (checks.AGG_TRADES_APP, word for word) end to end on the
    card through SiddhiManager and send_arrays: 1,048,576 trades of 64
    symbols (interned first) in 16 sends of 65,536, event times out of
    order by up to 2 s across 2026-01-01T00:00:00Z. K11 must launch on
    every step. Then one ``within ... per`` read a duration, every row
    against a numpy group-by (checks.agg_oracle: the bucket by numpy's
    calendar; the count exact from the state's ncount lane, the total
    and the average within 1e-9 relative of numpy's, which sums in
    another order), and the rows of the buckets the table did not place
    equal to the reported overflow. K11's time at the path's shape (a
    captured step's arguments), every captured step held against the
    plain version bit for bit, the bound and index_add_ of one int
    lane."""
    from siddhi_tpu_torch import SiddhiManager, _kernels
    from siddhi_tpu_torch import checks as C
    from siddhi_tpu_torch.core import aggregation as AG
    from siddhi_tpu_torch.core.types import GLOBAL_STRINGS
    enc = GLOBAL_STRINGS.encode
    SEND = AGG_SEND
    N = n_sends * SEND
    ts_all, cols_all = C.agg_trades_feed(N, enc)
    mgr = SiddhiManager()
    warm = mgr.create_siddhi_app_runtime(C.AGG_TRADES_APP)
    warm.start()
    _send_all(warm.get_input_handler("TradeStream"), ts_all, cols_all,
              (0, SEND, 2 * SEND))
    torch.cuda.synchronize()
    warm.shutdown()
    rt = mgr.create_siddhi_app_runtime(C.AGG_TRADES_APP)
    rt.start()
    ar = rt.aggregations["TradeAggregation"]
    h = rt.get_input_handler("TradeStream")
    captured = []
    step = AG.aggregation_step

    def capture(*a):
        captured.append(a)
        return step(*a)
    AG.aggregation_step = capture
    _kernels.reset_launches()
    lat = []
    try:
        t0 = time.perf_counter()
        for s in range(0, N, SEND):
            c0 = time.perf_counter()
            h.send_arrays(ts_all[s:s + SEND],
                          [c[s:s + SEND] for c in cols_all])
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - c0) * 1e3)
        wall = time.perf_counter() - t0
    finally:
        AG.aggregation_step = step
    launches = dict(_kernels.LAUNCHES)
    if launches["aggregation_step"] != n_sends or len(captured) != n_sends:
        fail(f"aggregation_trades: K11 launched "
             f"{launches['aggregation_step']} times, the steps {n_sends}")
    sym, price, _vol, stamp = cols_all
    lo, hi = C.AGG_WITHIN
    q_ms, n_rows, lost_all = [], 0, []
    rel = 0.0
    for di, d in enumerate(ar.durations):
        c0 = time.perf_counter()
        rows = rt.query(f"from TradeAggregation within {lo}L, {hi}L per "
                        f"'{d}' select symbol, total, avgPrice, "
                        "AGG_TIMESTAMP")
        q_ms.append((time.perf_counter() - c0) * 1e3)
        orc = C.agg_oracle(sym, stamp, price, d)
        st = {k: v for k, v in ar.states[d].items()}
        used = st["used"].cpu().numpy()
        counts = {(int(g), int(b)): int(c) for g, b, c in zip(
            st["groups"][0].cpu().numpy()[used],
            st["bstart"].cpu().numpy()[used],
            st["lanes"][1].cpu().numpy()[used])}
        got = {}
        for symbol, total, avg, bstart in rows:
            key = (enc(symbol), int(bstart))
            if key in got or key not in orc:
                fail(f"aggregation_trades {d}: bucket {key} not in the "
                     "oracle (or twice)")
            got[key] = (total, avg)
        for key, (total, avg) in got.items():
            cnt, tot = orc[key][0], orc[key][1]
            if counts.get(key) != cnt:
                fail(f"aggregation_trades {d}: bucket {key} count "
                     f"{counts.get(key)}, the oracle {cnt}")
            r = max(abs(total - tot) / abs(tot),
                    abs(avg - tot / cnt) / abs(tot / cnt))
            if not r <= 1e-9:
                fail(f"aggregation_trades {d}: bucket {key} total {total} "
                     f"avg {avg}, the oracle {tot} over {cnt}")
            rel = max(rel, r)
        lost = sum(v[0] for k, v in orc.items() if k not in got)
        ovf = int(st["overflow"])
        if lost != ovf or len(got) != len(counts):
            fail(f"aggregation_trades {d}: {len(got)} rows of "
                 f"{len(orc)} buckets, the unplaced buckets' rows {lost}, "
                 f"the reported overflow {ovf}")
        n_rows += len(got)
        lost_all.append(lost)
    eps = N / wall
    p50, p99 = float(np.percentile(lat, 50)), float(np.percentile(lat, 99))
    print(f"aggregation_trades: {N} events in {n_sends} sends of {SEND}; "
          f"{n_rows} bucket rows over {ar.durations} equal the numpy "
          f"group-by (counts exact, totals and averages within {rel:.2e} "
          f"relative; overflow {lost_all} as the unplaced buckets' rows); "
          f"{eps:.0f} events/s, send p50 {p50:.3f} ms, p99 {p99:.3f} ms; "
          f"the reads' host time {[round(x, 3) for x in q_ms]} ms ({card})",
          flush=True)
    print(f"launches on the aggregation_trades path: {launches}", flush=True)
    # every captured step held against the plain version, then K11's
    # time at a mid-run step's arguments
    err = 0.0
    for i, (rt_, st_, b_, now_) in enumerate(captured):
        _new, e = _k11_step(rt_, st_, b_, now_,
                            f"K11 at aggregation_trades' step {i}")
        err = max(err, e)
    lib = _kernels.load()
    stream = torch.cuda.current_stream().cuda_stream
    rt_, st_, b_, now_ = captured[n_sends // 2]
    gcols, args, ets = AG.step_inputs(rt_, b_, now_)
    _new, a = AG.aggr_args(rt_, st_, b_, gcols, args, ets)
    k11_ms = cuda_ms(lambda: lib.aggregation_step(a, stream), reps=20)
    plain_ms, _r = _timed(lambda: AG.aggregation_step_ref(
        rt_, st_, b_, gcols, args, ets), 1)
    # the library yardstick: index_add_ of one int lane (ncount) over
    # every duration's table, at the slots the kernel placed
    D, K, B = len(rt_.durations), rt_.K, b_.capacity
    slot = torch.empty((D, B), dtype=torch.int32, device=dev)
    sa = _kernels.AggrArgs.from_buffer_copy(a)
    sa.slot = slot.data_ptr()
    lib.aggregation_step(sa, stream)
    offs = torch.arange(D, device=dev, dtype=torch.int64)[:, None] * K
    idx = torch.where(slot >= 0, slot.to(torch.int64) + offs,
                      torch.full_like(offs, D * K).expand(D, B)).reshape(-1)
    ones = torch.ones_like(idx)
    table = torch.zeros(D * K + 1, dtype=torch.int64, device=dev)
    lib_ms = cuda_ms(lambda: table.index_add_(0, idx, ones), reps=20)
    # bytes: each column the step reads once (the event times, kind,
    # valid, the group columns, each lane's argument: its null mask alone
    # for an ncount lane, nothing for count's), a column several lanes
    # share counted once, the state in and out; ops: a row's bucket start
    # (the civil arithmetic), its hash and its probe compares, a duration
    # each
    reads = [ets if ets is not None else b_.ts, b_.kind, b_.valid]
    reads += [x for c in gcols for x in c]
    for (_f, kind, _a, _dt), arg in zip(rt_.lanes, args):
        if arg is not None:
            reads += [arg[1]] if kind == "ncount" else list(arg)
    col_bytes = _nbytes({(t.data_ptr(), t.nbytes): t
                         for t in reads}.values())
    n_bytes = col_bytes + 2 * _nbytes(tree_leaves(st_))
    n_ops = D * B * 64
    bound, by = bound_of(n_bytes, n_ops)
    torch.cuda.synchronize()
    print(f"aggregation_step (K11, {D} durations x {K} slots, {B} rows): "
          f"{k11_ms:.4f} ms a step, plain version {plain_ms:.1f} ms, "
          f"index_add_ of one int lane {lib_ms:.4f} ms, bound "
          f"{bound:.5f} ms ({by}; {n_bytes} bytes); every captured step "
          f"bit-equal to the plain version; {card}", flush=True)
    _kernels.LAUNCHES.update(launches)
    rt.shutdown()
    del captured
    gc.collect()
    return {"events_per_s": eps, "p50_ms_send": p50, "p99_ms_send": p99,
            "launches": launches, "query_ms": q_ms, "k11_ms": k11_ms,
            "k11_plain_ms": plain_ms, "k11_library_ms": lib_ms,
            "k11_bound_ms": bound, "k11_bound_by": by, "err": err,
            "overflow": lost_all}


def window_named_phase(dev, card: str, n_sends: int = 16) -> dict:
    """window_named: the Siddhi query guide's named-window usage in shape
    (checks.WINDOW_NAMED_APP: a one-minute time window fed by one query
    and read by a per-room average) end to end on the card: 1,048,576
    readings of 512 rooms, 15 ms apart (4,000 live rows, within the
    window's 4,096), in 16 sends of 65,536 through send_arrays, every
    RoomAvgStream row against checks.window_named_oracle (rooms and order
    exact, averages within 1e-9 relative), the window and the group
    table without overflow, then the on-demand read WINDOW_NAMED_READ
    against the oracle in count, order and values. K1, K2, K5 and K6
    must launch on the path. Every window step (K5) and aggregate step
    and emission (K6) of the first three sends, their timer steps among
    them, is captured on the path and held against the plain versions on
    the same arguments afterwards, tolerance 0."""
    from siddhi_tpu_torch import SiddhiManager, _kernels
    from siddhi_tpu_torch import checks as C
    from siddhi_tpu_torch.ops import aggregators as G
    from siddhi_tpu_torch.ops import windows as W
    SEND = AGG_SEND
    N = n_sends * SEND
    ts_all, cols_all = C.window_named_feed(N + 2 * SEND)
    mgr = SiddhiManager()
    warm = mgr.create_siddhi_app_runtime(C.WINDOW_NAMED_APP)
    warm.start()
    _send_all(warm.get_input_handler("TempStream"), ts_all[N:],
              [c[N:] for c in cols_all], (0, SEND, 2 * SEND))
    torch.cuda.synchronize()
    warm.shutdown()
    rt = mgr.create_siddhi_app_runtime(C.WINDOW_NAMED_APP)
    outs = []
    rt.queries["query_2"].batch_callbacks.append(outs.append)
    rt.start()
    h = rt.get_input_handler("TempStream")
    # the steps of the first three sends, kept with their arguments (the
    # emission's running count copied before the kernel adds to it)
    taps = (W, "window_step"), (G, "aggregate_step"), (G, "aggregate_emit")
    saved = [getattr(m, f) for m, f in taps]
    steps, tapping = [], [True]

    def tap(fname, fn):
        def wrap(*a):
            if tapping[0]:
                if fname == "aggregate_emit" and len(a) > 6 and \
                        a[6] is not None:
                    a = a[:6] + (a[6].clone(),)
                steps.append((fname, a))
            return fn(*a)
        return wrap
    for (m, f), fn in zip(taps, saved):
        setattr(m, f, tap(f, fn))
    _kernels.reset_launches()
    lat = []
    try:
        t0 = time.perf_counter()
        for k, s in enumerate(range(0, N, SEND)):
            tapping[0] = k < 3
            c0 = time.perf_counter()
            h.send_arrays(ts_all[s:s + SEND],
                          [c[s:s + SEND] for c in cols_all])
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - c0) * 1e3)
        wall = time.perf_counter() - t0
    finally:
        for (m, f), fn in zip(taps, saved):
            setattr(m, f, fn)
    launches = dict(_kernels.LAUNCHES)
    for k in ("unpack_packed", "expr_eval", "window_step", "aggregate_step",
              "aggregate_emit"):
        if launches[k] < n_sends:
            fail(f"window_named: {k} launched {launches[k]} times in "
                 f"{n_sends} sends")
    room, temp = (c[:N] for c in cols_all)
    w_room, w_avg, r_room, r_temp = C.window_named_oracle(ts_all[:N], room,
                                                          temp)
    ots, ocols, onulls = C.emitted_columns(outs)
    if len(ots) != N or not np.array_equal(ots, ts_all[:N]) or \
            not np.array_equal(ocols[0], w_room) or \
            any(n.any() for n in onulls):
        fail(f"window_named: {len(ots)} rows, the oracle {N}")
    rel = float(np.max(np.abs(ocols[1] - w_avg) / np.abs(w_avg)))
    if not rel <= 1e-9:
        fail(f"window_named: an average {rel} from the oracle's")
    wq = rt.named_windows["OneMinTempWindow"]
    ovf = (wq.overflow_total(), rt.queries["query_2"].stats()["overflow"])
    if ovf != (0, 0):
        fail(f"window_named: overflow (window, group table) {ovf}")
    c0 = time.perf_counter()
    rows = rt.query(C.WINDOW_NAMED_READ)
    read_ms = (time.perf_counter() - c0) * 1e3
    if rows != list(zip(r_room.tolist(), r_temp.tolist())):
        fail(f"window_named: the on-demand read gave {len(rows)} rows, the "
             f"oracle {len(r_room)}")
    with KernelCheck() as chk:
        for fname, a in steps:
            getattr(W if fname == "window_step" else G, fname)(*a)
    torch.cuda.synchronize()
    shapes = sorted({(f, a[2].capacity if f == "window_step" else
                      a[4].shape[0] if f == "aggregate_step" else
                      a[3].capacity) for f, a in steps})
    if chk.steps["window_step"] < 3 or chk.steps["aggregate_emit"] < 3 or \
            len({b for f, b in shapes if f == "window_step"}) < 2:
        fail(f"window_named: the captured steps {chk.steps} ({shapes}) do "
             "not hold three sends and their timer steps")
    print(f"K5/K6 at window_named's first three sends: {chk.steps} steps "
          f"bit-equal to their plain versions (kernel, rows: {shapes})",
          flush=True)
    del steps
    eps = N / wall
    p50, p99 = float(np.percentile(lat, 50)), float(np.percentile(lat, 99))
    print(f"window_named: {N} events in {n_sends} sends of {SEND}; {N} "
          f"rows equal the numpy oracle (averages within {rel:.2e}); the "
          f"on-demand read's {len(rows)} rows equal the oracle's "
          f"({read_ms:.3f} ms host); overflow 0; {eps:.0f} events/s, send "
          f"p50 {p50:.3f} ms, p99 {p99:.3f} ms ({card})", flush=True)
    print(f"launches on the window_named path: {launches}", flush=True)
    _kernels.LAUNCHES.update(launches)
    rt.shutdown()
    del outs
    gc.collect()
    return {"events_per_s": eps, "p50_ms_send": p50, "p99_ms_send": p99,
            "read_ms": read_ms, "launches": launches, "err": chk.err}


# -- slice 11: event time and schedules ---------------------------------------

# the ring's columns in K10's check: every type a ring packs (the STRING
# codes as int32)
_RING_DTYPES = (torch.int32, torch.int64, torch.float32, torch.float64,
                torch.bool, torch.int32)


def _ring_inputs(rng, dev, C, count, n_in, spread=500):
    """A ring of C rows (``count`` live) and C arrivals (``n_in`` live):
    timestamps within ``spread`` ms, every column type with the float
    traps (NaN, -0.0, infinities)."""
    def cols():
        out = []
        for dt in _RING_DTYPES:
            if dt.is_floating_point:
                v = rng.choice(np.array([0.5, -0.0, np.nan, np.inf, -2.0,
                                         1e-30]), C)
                out.append(torch.from_numpy(v).to(dt).to(dev))
            elif dt == torch.bool:
                out.append(torch.from_numpy(rng.random(C) < 0.5).to(dev))
            else:
                out.append(torch.from_numpy(rng.integers(-9, 9, C)).to(
                    dt).to(dev))
        return tuple(out)
    sts = torch.from_numpy(TS0_RING + rng.integers(0, spread, C)).to(dev)
    in_ts = torch.from_numpy(TS0_RING + rng.integers(0, spread, C)).to(dev)
    return (sts, cols()), in_ts, cols(), count, n_in


TS0_RING = 1_700_000_000_000


def _ring_compare(what, k, r):
    (ks, kc), kb, km = k
    (rs, rc), rb, rm = r
    return compare(what, [ks, *kc, *_bl(kb), km], [rs, *rc, *_bl(rb), rm])


def event_time_against_plain(dev) -> float:
    """Phase 40: kernels K10 (the reorder ring's step) and K5c (the cron
    window's step) against their plain versions on the card, bit for
    bit, every output written (the released batch past the cut, the new
    ring past its count; the cron window's whole output and both
    buffers): K10 at C = 8, 1,024 and 65,536 on a ring that is empty, one
    that is full, a final step, a forced min_rel, equal timestamps, no
    watermark and no rows, over every column type with the float traps;
    K5c at capacities 16 and 4,096: a firing with nothing pending,
    arrivals past the capacity (overflow), firings that rotate, a TIMER
    row among arrivals, expired rows off. -> max abs error (0)."""
    from siddhi_tpu_torch.core.event import (TIMER, Attribute, EventBatch,
                                             StreamSchema,
                                             batch_from_columns)
    from siddhi_tpu_torch.core.types import AttrType
    from siddhi_tpu_torch.ops import windows as W
    from siddhi_tpu_torch.ops.windows2 import CronWindowOp
    from siddhi_tpu_torch.resilience import ordering as O
    err, n10, n5c = 0.0, 0, 0
    rng = np.random.default_rng(40)
    for C in (8, 1024, 65536):
        cases = {"random": (C // 3, C // 2, 250, 0, False, 500),
                 "empty ring": (0, C - 1, 100, 0, False, 500),
                 "full ring": (C, C, 400, 0, False, 500),
                 "final": (C // 2, C // 4, 0, 0, True, 500),
                 "forced min_rel": (C - 2, C, -5, C // 2 + 3, False, 500),
                 "no watermark": (C // 2, C // 2, None, 0, False, 500),
                 "ties": (C, C, 1, 0, False, 3),
                 "nothing": (0, 0, 10, 0, False, 500)}
        for name, (count, n_in, dwm, min_rel, final, spread) in \
                cases.items():
            state, in_ts, in_cols, count, n_in = _ring_inputs(
                rng, dev, C, count, n_in, spread)
            wm = -(2 ** 62) if dwm is None else TS0_RING + dwm
            args = (state, in_ts, in_cols, count, n_in, wm, min_rel, final)
            err = max(err, _ring_compare(f"K10 {name} C={C}",
                                         O.ring_step(*args),
                                         O.ring_step_ref(*args)))
            n10 += 1
    schema = StreamSchema("S", (Attribute("sym", AttrType.STRING),
                                Attribute("price", AttrType.FLOAT),
                                Attribute("volume", AttrType.LONG)))
    for cap, expired in ((16, True), (4096, True), (4096, False)):
        op = CronWindowOp(schema, "*/5 * * * * ?", cap=cap,
                          expired_enabled=expired)
        st = op.init_state(dev)
        t = TS0_RING
        plan = ["fire", "arr:5", "arr:900", "fire", "fire",
                f"arr:{cap + 1000}", "fire", "mixed", "arr:0", "fire"]
        for p in plan:
            if p == "fire":
                batch = batch_from_columns(
                    schema, np.array([t], np.int64),
                    [np.zeros(1, np.int32), np.zeros(1, np.float32),
                     np.zeros(1, np.int64)], capacity=16, device=dev)
                batch.kind[0] = TIMER
            else:
                m = 6 if p == "mixed" else int(p[4:])
                B = max(16, 1 << max(m - 1, 1).bit_length())
                batch = batch_from_columns(
                    schema, t + np.sort(rng.integers(0, 900, m)),
                    [rng.integers(1, 9, m).astype(np.int32),
                     rng.choice(np.array([1.5, np.nan, -0.0], np.float32),
                                m),
                     rng.integers(0, 99, m)], capacity=B, device=dev)
                if p == "mixed":
                    batch.kind[2] = TIMER
            ks, ko = W.window_step(op, st, batch, t + 3)
            rs, ro = W.window_step_ref(op, st, batch, t + 3)
            err = max(err, compare(f"K5c {p} cap={cap}",
                                   tree_leaves(ks) + _bl(ko),
                                   tree_leaves(rs) + _bl(ro)))
            st = ks
            t += 1000
            n5c += 1
        if cap == 4096 and int(st["overflow"]) == 0:
            fail("K5c: the overflowing feed did not overflow")
    torch.cuda.synchronize()
    print(f"K10 reorder_ring: bit-equal to its plain version in {n10} "
          f"steps (C = 8, 1,024, 65,536; empty, full, final, forced, "
          f"ties); K5c cron_window: bit-equal in {n5c} steps (capacities "
          f"16 and 4,096, overflow, nothing pending)", flush=True)
    return err


def cron_trades_phase(dev, card: str) -> dict:
    """cron_trades: trading-desk reports on wall-clock boundaries
    (checks.CRON_TRADES_APP: a cron('*/5 * * * * ?') named window fed by
    `insert into` and read by a grouped sum, a 5 s trigger through a
    projection, a one-minute average with `output last every 5 sec`):
    1,048,576 trades of 512 symbols 2 ms apart, sent a 5 s period a send
    (a columnar send is one step, and timers fire only between sends),
    420 sends and 419 firings. Each firing's report rows against
    checks.cron_trades_oracle (symbols and order exact, sums within
    1e-9), the trigger's rows every 5,000 ms from the arming point, the
    limiter's rows flush by flush, no window or group overflow. K5c must
    launch on every send and firing, K1, K2, K5 and K6 on the path. The
    steps of the first four sends are held against the plain versions
    as they run (KernelCheck, tolerance 0); then K5c's time on a firing
    step against its plain version and its bound."""
    from siddhi_tpu_torch import SiddhiManager, StreamCallback, _kernels
    from siddhi_tpu_torch import checks as C
    from siddhi_tpu_torch.core.types import GLOBAL_STRINGS
    from siddhi_tpu_torch.ops import windows as W
    N = 1 << 20
    ts, cols = C.cron_trades_feed(N, GLOBAL_STRINGS.encode)
    cuts = C.cron_trades_cuts(ts)
    rep_sym, rep_sum, ticks, flushes = C.cron_trades_oracle(
        ts, cols[0], cols[1], cuts)
    mgr = SiddhiManager()
    warm = mgr.create_siddhi_app_runtime(C.CRON_TRADES_APP)
    warm.start()
    _send_all(warm.get_input_handler("StockEventStream"), ts, cols,
              cuts[:4])
    torch.cuda.synchronize()
    warm.shutdown()
    rt = mgr.create_siddhi_app_runtime(C.CRON_TRADES_APP)
    outs, tick_rows, avg_lists = [], [], []
    rt.queries["report"].batch_callbacks.append(outs.append)
    rt.add_callback("TickStream", StreamCallback(
        lambda evs: tick_rows.extend(e.data for e in evs)))
    rt.add_callback("AvgStream", StreamCallback(
        lambda evs: avg_lists.append([(e.timestamp, e.data) for e in evs])))
    rt.start()
    h = rt.get_input_handler("StockEventStream")
    # the firing steps of K5c, kept with their arguments for the timing
    firing = []
    real = W.window_step

    def keep(op, state, batch, now):
        if op.LAUNCH == "cron_window" and len(firing) < 2 and \
                batch.capacity == 16 and bool(state["cur"]["valid"].any()):
            firing.append((op, state, batch, int(now)))
        return real(op, state, batch, now)
    _kernels.reset_launches()
    n_sends = len(cuts) - 1
    with KernelCheck() as chk:
        for k in range(4):
            h.send_arrays(ts[cuts[k]:cuts[k + 1]],
                          [c[cuts[k]:cuts[k + 1]] for c in cols])
    torch.cuda.synchronize()
    W.window_step = keep
    lat = []
    try:
        t0 = time.perf_counter()
        for k in range(4, n_sends):
            a, b = cuts[k], cuts[k + 1]
            c0 = time.perf_counter()
            h.send_arrays(ts[a:b], [c[a:b] for c in cols])
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - c0) * 1e3)
        wall = time.perf_counter() - t0
    finally:
        W.window_step = real
    launches = dict(_kernels.LAUNCHES)
    n_fires = n_sends - 1
    if launches["cron_window"] < n_sends + n_fires:
        fail(f"cron_trades: K5c launched {launches['cron_window']} times "
             f"for {n_sends} sends and {n_fires} firings")
    for k in ("unpack_packed", "expr_eval", "window_step",
              "aggregate_step", "aggregate_emit"):
        if launches[k] < n_sends:
            fail(f"cron_trades: {k} launched {launches[k]} times in "
                 f"{n_sends} sends")
    if chk.steps["window_step"] < 8:
        fail(f"cron_trades: the first sends held {chk.steps}")
    ots, ocols, _on = C.emitted_columns(outs)
    if len(ots) != len(rep_sym) or not np.array_equal(ocols[0], rep_sym):
        fail(f"cron_trades: {len(ots)} report rows, the oracle "
             f"{len(rep_sym)}")
    gap = float(np.max(np.abs(ocols[1] - rep_sum)))
    if not gap <= 1e-9:
        fail(f"cron_trades: a report sum {gap} from the oracle's")
    want_ticks = [(int(t), int(t) - 5000) for t in ticks]
    if tick_rows != want_ticks:
        fail(f"cron_trades: {len(tick_rows)} trigger rows, the oracle "
             f"{len(want_ticks)}")
    if len(avg_lists) != len(flushes):
        fail(f"cron_trades: {len(avg_lists)} limiter flushes, the oracle "
             f"{len(flushes)}")
    for got, (fts, fsym, fap) in zip(avg_lists, flushes):
        gsym = np.array([GLOBAL_STRINGS.encode(r[1][0]) for r in got])
        gap_a = np.abs(np.array([r[1][1] for r in got]) - fap) / fap
        if [r[0] for r in got] != fts.tolist() or \
                not np.array_equal(gsym, fsym) or not gap_a.max() <= 1e-12:
            fail("cron_trades: a limiter flush differs from the oracle's")
    ovf = {q: rt.queries[q].stats()["overflow"] for q in
           ("report", "lastavg")}
    ovf["window"] = rt.named_windows["StockEventWindow"].overflow_total()
    if any(ovf.values()):
        fail(f"cron_trades: overflow {ovf}")
    eps = (N - int(cuts[4])) / wall
    p50, p99 = float(np.percentile(lat, 50)), float(np.percentile(lat, 99))
    # K5c alone on a firing step: the launch with its arguments built once
    # (it writes only its fresh outputs), then the plain version
    op, state, batch, now = firing[-1]
    _ns, _o, args = W.window_args(op, state, batch,
                                  torch.tensor(now, dtype=torch.int64,
                                               device=dev))
    lib = _kernels.load()
    stream = torch.cuda.current_stream().cuda_stream
    k5c_ms = cuda_ms(lambda: lib.window_step(args, stream), reps=100)
    k5c_plain, (rs, ro) = _timed(
        lambda: W.window_step_ref(op, state, batch, now), reps=10)
    ks, ko = real(op, state, batch, now)
    err = max(chk.err, compare("K5c at a cron_trades firing",
                               tree_leaves(ks) + _bl(ko),
                               tree_leaves(rs) + _bl(ro)))
    nbytes = _nbytes(_buf_tensors(state["cur"]) + _buf_tensors(state["exp"])
                     + _bl(batch) + _bl(ko) + _buf_tensors(ks["cur"]) +
                     _buf_tensors(ks["exp"]))
    bound, by = bound_of(nbytes, 0)
    print(f"cron_trades: {N} trades in {n_sends} sends (a 5 s period "
          f"each), {n_fires} firings; {len(ots)} report rows equal the "
          f"oracle (sums within {gap:.1e}), {len(tick_rows)} trigger rows "
          f"and {len(avg_lists)} limiter flushes equal it; overflow 0; "
          f"{eps:.0f} events/s, send p50 {p50:.3f} ms, p99 {p99:.3f} ms "
          f"({card})", flush=True)
    print(f"K5c cron_window at a firing (W = {op.cap}, {int(state['cur']['valid'].sum())} "
          f"rows pending): {k5c_ms:.5f} ms, plain version {k5c_plain:.4f} "
          f"ms, bound {bound:.6f} ms ({nbytes} bytes at 3.35 TB/s); "
          f"{card}", flush=True)
    print(f"launches on the cron_trades path: {launches}", flush=True)
    _kernels.LAUNCHES.update(launches)
    rt.shutdown()
    del outs, firing
    gc.collect()
    return {"events_per_s": eps, "p50_ms_send": p50, "p99_ms_send": p99,
            "launches": launches, "err": err, "k5c_ms": k5c_ms,
            "k5c_plain_ms": k5c_plain, "k5c_bound_ms": bound,
            "k5c_bound_by": by}


def watermark_sensors_phase(dev, card: str, n_sends: int = 16) -> dict:
    """watermark_sensors: producers that deliver with bounded skew.
    window_time_grouped's app under @app:watermark(lateness='200 ms'),
    policy DROP (checks.watermark_sensors_app); window_time_feed's
    1,048,576 events of 512 symbols in the order
    checks.watermark_sensors_feed delivers them (a seeded 0-200 ms delay
    an event, 0.1 % stragglers 500-1,000 ms late), 16 sends of 65,536,
    then flush_watermarks(final=True). Every disordered send runs K10
    (C = 65,536: 131,072-row steps), whose released batch reaches the
    query without K1. The rows must equal checks.window_time_oracle over
    the events that were not late, in timestamp order (averages within
    1e-12 relative); the late count the feed's own
    (checks.watermark_late_mask); forced 0. The ring steps of the first
    three sends are held against the plain version afterwards,
    tolerance 0; then K10's time on the second send's step against its
    plain version, its bound, and torch.sort(stable=True) of the key with
    the gathers."""
    from siddhi_tpu_torch import SiddhiManager, _kernels
    from siddhi_tpu_torch import checks as C
    from siddhi_tpu_torch.core.types import GLOBAL_STRINGS
    from siddhi_tpu_torch.resilience import ordering as O
    SEND = AGG_SEND
    N = n_sends * SEND
    ts, cols = C.watermark_sensors_feed(N, GLOBAL_STRINGS.encode)
    cuts = np.arange(0, N + 1, SEND)
    late = C.watermark_late_mask(ts, cuts)
    keep = ~late
    order = np.argsort(ts[keep], kind="stable")
    ts_k = ts[keep][order]
    sym, price, vol = (c[keep][order] for c in cols)
    osym, ap, sv, cnt = C.window_time_oracle(ts_k, sym, price, vol)
    app = C.watermark_sensors_app()
    mgr = SiddhiManager()
    warm = mgr.create_siddhi_app_runtime(app)
    warm.start()
    _send_all(warm.get_input_handler("StockStream"), ts, cols, cuts[:3])
    torch.cuda.synchronize()
    warm.shutdown()
    rt = mgr.create_siddhi_app_runtime(app)
    outs = []
    rt.queries["q"].batch_callbacks.append(outs.append)
    rt.start()
    h = rt.get_input_handler("StockStream")
    steps = []
    real = O.ring_step

    def tap(*a):
        if len(steps) < 3:
            steps.append(a)
        return real(*a)
    O.ring_step = tap
    _kernels.reset_launches()
    lat = []
    try:
        t0 = time.perf_counter()
        for a, b in zip(cuts[:-1], cuts[1:]):
            c0 = time.perf_counter()
            h.send_arrays(ts[a:b], [c[a:b] for c in cols])
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - c0) * 1e3)
        rt.flush_watermarks(final=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        O.ring_step = real
    launches = dict(_kernels.LAUNCHES)
    buf = rt._reorder["StockStream"]
    cnt_ = dict(buf.counters)
    if launches["reorder_ring"] < n_sends or cnt_["ring_steps"] != \
            n_sends + 1:
        fail(f"watermark_sensors: K10 launched {launches['reorder_ring']} "
             f"times, {cnt_['ring_steps']} ring steps, in {n_sends} sends")
    for k in ("window_step", "aggregate_step", "aggregate_emit",
              "expr_eval"):
        if launches[k] < n_sends:
            fail(f"watermark_sensors: {k} launched {launches[k]} times")
    if cnt_["late"] != int(late.sum()) or cnt_["late_dropped"] != \
            cnt_["late"] or cnt_["forced"] != 0:
        fail(f"watermark_sensors: counters {cnt_}, the feed's late count "
             f"{int(late.sum())}")
    ots, ocols, onulls = C.emitted_columns(outs)
    if len(ots) != len(ts_k) or not np.array_equal(ots, ts_k) or \
            not np.array_equal(ocols[0], osym) or \
            not np.array_equal(ocols[2], sv) or \
            not np.array_equal(ocols[3], cnt):
        fail(f"watermark_sensors: {len(ots)} rows, the oracle {len(ts_k)}")
    rel = float(np.max(np.abs(ocols[1] - ap) / np.abs(ap)))
    if not rel <= 1e-12:
        fail(f"watermark_sensors: an average {rel} from the oracle's")
    err = 0.0
    for i, a in enumerate(steps):
        err = max(err, _ring_compare(f"K10 at watermark_sensors step {i}",
                                     real(*a), O.ring_step_ref(*a)))
    eps = N / wall
    p50, p99 = float(np.percentile(lat, 50)), float(np.percentile(lat, 99))
    # K10 alone on the second send's step, its arguments built once
    state, in_ts, in_cols, count, n_in, wm, min_rel, final = steps[1]
    _s, kb, _m, args = O.ring_args(*steps[1])
    lib = _kernels.load()
    stream = torch.cuda.current_stream().cuda_stream
    k10_ms = cuda_ms(lambda: lib.reorder_ring(args, stream), reps=50)
    k10_plain = cuda_ms(lambda: O.ring_step_ref(*steps[1]), reps=10,
                        warmup=2)
    sts, scols = state
    ts_all = torch.cat([sts, in_ts])
    cols_all = [torch.cat([s, c]) for s, c in zip(scols, in_cols)]

    def library():
        o = torch.sort(ts_all, stable=True).indices
        return [ts_all[o]] + [c[o] for c in cols_all]
    lib_ms = cuda_ms(library, reps=50)
    C_ = sts.shape[0]
    row = 8 + sum(c.element_size() for c in scols)
    nbytes = 3 * C_ * row + 2 * C_ * (row + len(scols) + 4 + 1) + 32
    bound, by = bound_of(nbytes, 0)
    print(f"watermark_sensors: {N} events in {n_sends} disordered sends "
          f"then the final flush; {len(ots)} rows equal the in-order "
          f"oracle (averages within {rel:.2e}); {cnt_['late']} late "
          f"dropped, as the feed's own count; forced 0; "
          f"{cnt_['ring_steps']} ring steps; {eps:.0f} events/s, send p50 "
          f"{p50:.3f} ms, p99 {p99:.3f} ms ({card})", flush=True)
    print(f"K10 reorder_ring at C = {C_} ({count} ring rows, {n_in} "
          f"arrivals): {k10_ms:.5f} ms, plain version {k10_plain:.4f} ms, "
          f"torch.sort(stable=True) + gathers {lib_ms:.5f} ms, bound "
          f"{bound:.6f} ms ({nbytes} bytes at 3.35 TB/s); {card}",
          flush=True)
    print(f"launches on the watermark_sensors path: {launches}", flush=True)
    _kernels.LAUNCHES.update(launches)
    rt.shutdown()
    del outs, steps
    gc.collect()
    return {"events_per_s": eps, "p50_ms_send": p50, "p99_ms_send": p99,
            "launches": launches, "err": err, "k10_ms": k10_ms,
            "k10_plain_ms": k10_plain, "k10_bound_ms": bound,
            "k10_bound_by": by, "k10_library_ms": lib_ms}


# ---------------------------------------------------------------------------
# tenant serving pools (K1[K], K2's parameter load, K5[K], K3[K], K4[K],
# K7[K])
# ---------------------------------------------------------------------------

# the reference bench's `tenants` configuration: the headline chain arm's
# tenant counts, rows a tenant and batch_max; the class arms'
POOL_TENANTS = (64, 256, 1024)
POOL_ROWS, POOL_BATCH_MAX, POOL_PASSES = 2048, 1024, 3
CLASS_TENANTS, CLASS_ROWS, CLASS_BATCH_MAX = 64, 1024, 256
# the tenants whose pooled rows are held against separate runtimes
POOL_SAMPLED = 8


class PoolCapture:
    """While installed, the arguments of the first ``limit`` launches of
    each of a tenant pool's slotted kernels (K1[K], K2 with per-slot
    parameters or counters, K5[K], K3[K], K4[K] stream and timer steps,
    K7[K]) are kept, after the first ``skip[kind]`` launches of a kind:
    the tensors a launch updates in place cloned first. The runtime goes
    on with the kernels' results; ``_pool_check`` then holds each kept
    launch against its plain version on the same arguments."""

    def __init__(self, limit: int, skip: Optional[dict] = None):
        from siddhi_tpu_torch.core import ingest as I
        from siddhi_tpu_torch.core import runtime as R
        from siddhi_tpu_torch.ops import join as J
        from siddhi_tpu_torch.ops import nfa as N
        from siddhi_tpu_torch.ops import nfa_parallel as NP
        from siddhi_tpu_torch.ops import selector as S
        from siddhi_tpu_torch.ops import windows as W
        self.mods = (I, R, S, W, NP, N, J)
        self.limit = limit
        self.skip = dict(skip or {})
        self.rec = {k: [] for k in ("K1", "K2", "K5", "K3", "K4", "K4t",
                                    "K7")}

    def _keep(self, kind, args) -> None:
        if self.skip.get(kind, 0) > 0:
            self.skip[kind] -= 1
        elif len(self.rec[kind]) < self.limit:
            self.rec[kind].append(args)

    def __enter__(self):
        I, R, S, W, NP, N, J = self.mods
        self.saved = (I.unpack_packed, R.expr_eval, S.expr_eval,
                      W.window_step, NP.parallel_step, N.scan_step,
                      N.timer_step, J.join_probe, J.join_grid)
        (k1, k2r, k2s, k5, k3, k4, k4t, k7p, k7g) = self.saved

        def unpack(types, enc, cap, buf):
            if buf.dim() == 2:
                self._keep("K1", (types, enc, cap, buf))
            return k1(types, enc, cap, buf)

        def k2(fn):
            def expr_eval(prog, batch, emitted=None, now=None,
                          tparams=None):
                if batch.ts.dim() == 2 and (
                        tparams or (emitted is not None
                                    and emitted.dim() == 1)):
                    self._keep("K2", (prog, batch, None if emitted is None
                                      else emitted.clone(), now, tparams))
                return fn(prog, batch, emitted, now, tparams)
            return expr_eval

        def window_step(op, state, batch, now):
            if batch.ts.dim() == 2:
                self._keep("K5", (op, tree_clone(state), batch, now))
            return k5(op, state, batch, now)

        def parallel_step(eng, sid, table, batch):
            if batch.ts.dim() == 2:
                self._keep("K3", (eng, sid, tree_clone(table), batch))
            return k3(eng, sid, table, batch)

        def scan_step(eng, sid, table, batch, due=None):
            if batch.ts.dim() == 2:
                self._keep("K4", (eng, sid, tree_clone(table), batch))
            return k4(eng, sid, table, batch, due)

        def timer_step(eng, table, now, due=None):
            if table["state"].dim() == 2:
                self._keep("K4t", (eng, tree_clone(table), now))
            return k4t(eng, table, now, due)

        def k7(fn, name):
            def cross(cross, trig, opp, gate_alive=False):
                if trig.ts.dim() == 2:
                    self._keep("K7", (name, cross, trig, tree_clone(opp),
                                      gate_alive))
                return fn(cross, trig, opp, gate_alive)
            return cross

        I.unpack_packed = unpack
        R.expr_eval, S.expr_eval = k2(k2r), k2(k2s)
        W.window_step = window_step
        NP.parallel_step = parallel_step
        N.scan_step, N.timer_step = scan_step, timer_step
        J.join_probe, J.join_grid = k7(k7p, "join_probe"), k7(k7g,
                                                              "join_grid")
        return self

    def __exit__(self, *exc):
        I, R, S, W, NP, N, J = self.mods
        (I.unpack_packed, R.expr_eval, S.expr_eval, W.window_step,
         NP.parallel_step, N.scan_step, N.timer_step, J.join_probe,
         J.join_grid) = self.saved
        return False


def _pool_launch_ms(kind: str, args) -> float:
    """A pool kernel's device time on one kept launch's arguments: the
    argument struct built once, then the raw launches alone between CUDA
    events (a table the launch updates in place restored before each)."""
    from siddhi_tpu_torch import _kernels
    from siddhi_tpu_torch.core import ingest as I
    from siddhi_tpu_torch.core.event import EventBatch
    from siddhi_tpu_torch.core.types import torch_dtype
    from siddhi_tpu_torch.ops import join as J
    from siddhi_tpu_torch.ops import nfa as N
    from siddhi_tpu_torch.ops import nfa_parallel as NP
    from siddhi_tpu_torch.ops import windows as W
    from siddhi_tpu_torch.ops.expr import batch_input, expr_params
    from siddhi_tpu_torch.ops.slots import flat
    lib = _kernels.load()
    stream = torch.cuda.current_stream().cuda_stream
    dev = torch.device("cuda")

    def prep():
        pass
    if kind == "K1":
        types, enc, cap, buf = args
        shape = (buf.shape[0], cap)
        e = lambda dt: torch.empty(shape, dtype=dt, device=dev)  # noqa
        nl = e(torch.bool)
        out = EventBatch(ts=e(torch.int64),
                         cols=tuple(e(torch_dtype(t)) for t in types),
                         nulls=(nl,) * len(types), kind=e(torch.int32),
                         valid=e(torch.bool))
        p = I.unpack_params(types, enc, cap, buf, out)
        keep = (out, p)
        launch = lambda: lib.unpack_packed(keep[1], stream)  # noqa: E731
    elif kind == "K2":
        prog, batch, em0, now, tp = args
        rows = batch.ts.shape[1]
        fb = flat(batch)
        B = fb.ts.shape[0]
        em = None if em0 is None else em0.clone()
        ins = [batch_input(fb, k, now, tp) for k in prog.inputs]
        cols = tuple(torch.empty((B,), dtype=torch_dtype(t), device=dev)
                     for t in prog.out_types)
        nulls = tuple(torch.empty((B,), dtype=torch.bool, device=dev)
                      for _ in prog.out_types)
        valid = torch.empty((B,), dtype=torch.bool, device=dev)
        p = expr_params(prog, fb, cols, nulls, valid, em, ins, rows)
        keep = (fb, ins, cols, nulls, valid, em, p)
        launch = lambda: lib.expr_eval(keep[-1], stream)  # noqa: E731
    elif kind == "K5":
        op, state, batch, now = args
        keep = W.window_args(op, state, batch, W._i64(now, dev))
        launch = lambda: lib.window_step(keep[2], stream)  # noqa: E731
    elif kind == "K7":
        name, cross, trig, opp, gate = args
        keep = J.join_args(cross, trig, opp, gate, name == "join_probe")
        launch = lambda: getattr(lib, name)(keep[2], stream)  # noqa: E731
    else:
        table = args[2] if kind != "K4t" else args[1]
        work = tree_clone(table)
        src, dst = tree_leaves(table), tree_leaves(work)

        def prep():
            for d, s_ in zip(dst, src):
                d.copy_(s_)
        lead = tuple(table["state"].shape[:-1])
        if kind == "K3":
            eng, sid, _t, batch = args
            PB = min(eng.PB, batch.ts.shape[-1])
            out = N.kernel_out(eng, dev, lead)
            p = NP.nfa_params(eng, sid, work, batch, out, PB, lead)

            def launch():
                for o in range(0, batch.ts.shape[-1], PB):
                    NP.set_events(p, batch, o)
                    lib.nfa_parallel_step(p, stream)
        else:
            eng = args[0]
            sid, batch, now = (args[1], args[3], 0) if kind == "K4" \
                else (None, None, int(args[2]))
            out = N.kernel_out(eng, dev, lead)
            p = N.scan_args(eng, sid, work, batch, now, out, None, dev)
            launch = lambda: lib.nfa_scan(p, stream)  # noqa: E731
        keep = (work, out, p)
    ms = _launch_ms(prep, launch, reps=10)
    del keep
    return ms


def _pool_check(kind: str, rec, what: str) -> dict:
    """Every kept launch of ``kind`` (PoolCapture) against its plain
    version on the same arguments, every slot, bit for bit; then the
    kernel's time on the last one's arguments (the state it updates in
    place restored before each launch), the plain version's (the last
    check's), the bound (each input read once, each output written once,
    at the HBM rate) and the one library call that computes the same
    function, where there is one. -> {err, ms, plain_ms, bound_ms, bound_by, library_ms,
    checked}."""
    from siddhi_tpu_torch.core import ingest as I
    from siddhi_tpu_torch.ops import join as J
    from siddhi_tpu_torch.ops import nfa_parallel as NP
    from siddhi_tpu_torch.ops import windows as W
    from siddhi_tpu_torch.ops.expr import expr_eval, expr_eval_ref
    from siddhi_tpu_torch.ops.slots import flat, per_slot
    if not rec:
        fail(f"{what}: no {kind} launch was captured on the pool's path")
    err = 0.0

    def run(args, plain: bool):
        """One launch (or its plain version) -> the tensors it gives,
        in order."""
        if kind == "K1":
            types, enc, cap, buf = args
            if plain:
                b, now = per_slot(lambda x: I.unpack_packed_ref(
                    types, enc, cap, x), buf.shape[0], buf)
                now = now[0]
            else:
                b, now = I.unpack_packed(types, enc, cap, buf)
            return [b.ts, *b.cols, b.nulls[0], b.kind, b.valid,
                    now.reshape(1)]
        if kind == "K2":
            prog, batch, em0, now, tp = args
            em = None if em0 is None else em0.clone()
            if plain:
                K, rows = batch.ts.shape
                cols, nulls, valid = expr_eval_ref(
                    prog, flat(batch), em, now, tp, rows)
                cols = tuple(c.reshape((K, -1) + tuple(c.shape[1:]))
                             for c in cols)
                nulls = tuple(n.reshape(K, -1) for n in nulls)
                valid = valid.reshape(K, -1)
            else:
                cols, nulls, valid = expr_eval(prog, batch, em, now, tp)
            return [*cols, *nulls, valid] + ([em] if em is not None else [])
        if kind == "K5":
            op, state, batch, now = args
            if plain:
                st, o = per_slot(lambda s, b: W.window_step_ref(op, s, b,
                                                                now),
                                 batch.ts.shape[0], state, batch)
            else:
                st, o = W.window_step(op, state, batch, now)
            return tree_leaves(st) + _bl(o)
        if kind == "K3":
            eng, sid, table, batch = args
            t = tree_clone(table)
            if plain:
                t, m = per_slot(lambda x, b: NP.parallel_step_ref(
                    eng, sid, x, b), batch.ts.shape[0], t, batch)
            else:
                t, m = NP.parallel_step(eng, sid, t, batch)
            return tree_leaves(t) + _bl(m)
        if kind in ("K4", "K4t"):
            from siddhi_tpu_torch.ops import nfa as N
            if kind == "K4":
                eng, sid, table, batch = args
                t = tree_clone(table)
                if plain:
                    t, m = per_slot(lambda x, b: eng.stream_step_ref(
                        sid, x, b), batch.ts.shape[0], t, batch)
                else:
                    t, m = N.scan_step(eng, sid, t, batch)
            else:
                eng, table, now = args
                t = tree_clone(table)
                if plain:
                    t, m = per_slot(lambda x: eng.timer_step_ref(x, now),
                                    table["state"].shape[0], t)
                else:
                    t, m = N.timer_step(eng, t, now)
            return tree_leaves(t) + _bl(m)
        name, cross, trig, opp, gate = args
        if plain:
            ref = J.cross_probe_ref if name == "join_probe" \
                else J.cross_grid_ref
            o, lost = per_slot(lambda t, b: ref(cross, t, b, gate),
                               trig.ts.shape[0], trig, opp)
        else:
            o, lost = getattr(J, name)(cross, trig, opp, gate)
        return _bl(o) + [lost]

    plain_ms = 0.0
    if kind == "K7":   # the grid entry point too, on the same arguments
        for i, args in enumerate(rec):
            g = ("join_grid",) + tuple(args[1:])
            err = max(err, compare(f"{what} K7[K] join_grid on launch {i}",
                                   run(g, False), run(g, True)))
    for i, args in enumerate(rec):
        got = run(args, False)
        t0 = time.perf_counter()
        want = run(args, True)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = max(err, compare(f"{what} {kind} launch {i}", got, want))
        print(f"{what}: {kind} launch {i}'s plain version took "
              f"{plain_ms:.1f} ms", flush=True)
    args = rec[-1]
    ms = _pool_launch_ms(kind, args)
    outs = run(args, False)
    lib_ms = None
    if kind == "K1":
        types, enc, cap, buf = args
        n_bytes = buf.nbytes + _nbytes(outs)
    elif kind == "K2":
        prog, batch, _em, _now, _tp = args
        ins = [batch.cols[k] if isinstance(k, int) else batch.ts
               for k in prog.inputs
               if isinstance(k, int) or k == ("ts",)]
        ins += [batch.nulls[k] for k in prog.inputs if isinstance(k, int)]
        n_bytes = _nbytes(ins + [batch.kind, batch.valid]) + \
            _nbytes(outs)
    elif kind == "K5":
        op, state, batch, _now = args
        n_bytes = 2 * _nbytes(tree_leaves(state)) + _nbytes(_bl(batch)) + \
            _nbytes(outs[len(tree_leaves(state)):])
        key = outs[len(tree_leaves(state))]   # the output's ts
        lib_ms = cuda_ms(lambda: torch.sort(key, dim=1, stable=True),
                         reps=10)
    elif kind in ("K3", "K4", "K4t"):
        # the events, each row's liveness, the live rows of the table
        # (read and written), the matches written
        table = args[2] if kind != "K4t" else args[1]
        batch = args[3] if kind != "K4t" else None
        lv = tree_leaves(table)
        M = table["state"].shape[-1]
        row_bytes_ = sum(x.numel() * x.element_size() // x.shape[0] // M
                         for x in lv if x.dim() >= 2 and x.shape[1] == M)
        live = int(table["valid"].sum())
        n_out = outs[-1].numel()   # the match batch's valid mask
        n_match = int(outs[-1].sum())
        match_row = _nbytes(outs[len(lv):]) // max(n_out, 1)
        n_bytes = (_nbytes(_bl(batch)) if batch is not None else 0) + \
            _nbytes([table["valid"], table["state"]]) + \
            2 * live * row_bytes_ + n_match * match_row
    else:
        name, cross, trig, opp, gate = args
        n_bytes = _nbytes(_bl(trig)) + _nbytes(
            [opp["ts"], opp["valid"], *opp["cols"], *opp["nulls"]]) + \
            _nbytes(outs)
        # the library's yardstick: a batched stable sort of the opposite
        # windows' keys along the row axis, and a batched searchsorted of
        # the trigger rows' keys into them
        okey = opp["cols"][0].to(torch.int64)
        tkey = trig.cols[0].to(torch.int64).contiguous()
        lib_ms = cuda_ms(lambda: torch.searchsorted(
            torch.sort(okey, dim=1, stable=True)[0], tkey), reps=10)
    bound, by = bound_of(n_bytes, 0)
    return {"err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "library_ms": lib_ms, "checked": len(rec),
            "bytes": n_bytes}


def _pool_rows(pool, tids, got: dict) -> None:
    """Per-tenant callbacks that keep each tenant's rows (ts, kind,
    values) in ``got``."""
    for tid in tids:
        pool.add_callback(tid, lambda evs, tid=tid: got.setdefault(
            tid, []).extend((e.timestamp, e.is_expired, tuple(e.data))
                            for e in evs))


def _separate_rows(template_text: str, bindings: dict, chunks: list,
                   name: str) -> list:
    """A separate runtime of the template with the tenant's bindings
    (instantiate_static), fed the tenant's round chunks in order ->
    its rows of Out."""
    return _sep_runtime(template_text, bindings, chunks, name, "Out")[0]


def _sep_runtime(template_text: str, bindings: dict, chunks: list,
                 name: str, out_stream: str):
    """_separate_rows' runtime -> (its rows of ``out_stream``, the
    runtime, shut down)."""
    from siddhi_tpu_torch import SiddhiManager, StreamCallback
    from siddhi_tpu_torch.serving import Template
    text = Template(template_text).instantiate_static(bindings,
                                                      app_name=name)
    rt = SiddhiManager().create_siddhi_app_runtime(text)
    rows = []
    rt.add_callback(out_stream, StreamCallback(lambda evs: rows.extend(
        (e.timestamp, e.is_expired, tuple(e.data)) for e in evs)))
    rt.start()
    for sid, ts, cols in chunks:
        rt.get_input_handler(sid).send_arrays(ts, cols)
    torch.cuda.synchronize()
    rt.shutdown()
    return rows, rt


class _TakeLog:
    """Keeps the sampled tenants' round chunks (what each round took) so
    a separate runtime can be fed the same."""

    def __init__(self, pool, tids):
        self.pool, self.tids, self.log = pool, set(tids), {}
        self.orig = pool._take

        def take(tid, sid, limit):
            got = self.orig(tid, sid, limit)
            if got is not None and tid in self.tids:
                self.log.setdefault(tid, []).append((sid, got[0], got[1]))
            return got
        pool._take = take

    def stop(self):
        self.pool._take = self.orig


def _pool_pass(pool, tids, feeds: dict, shift: int, sync_rounds: list):
    """Every tenant sends its feed (timestamps moved ``shift`` ms on),
    then the pool drains in fair rounds, each timed to the device's
    end."""
    for tid in tids:
        for sid, (ts, cols) in feeds.items():
            pool.send(tid, ts + shift, cols, stream=sid)
    _pool_drain(pool, sync_rounds)


def _pool_drain(pool, sync_rounds: list) -> None:
    """Fair rounds until nothing is pending, each timed to the device's
    end."""
    while True:
        t0 = time.perf_counter()
        n = pool.pump()
        torch.cuda.synchronize()
        if n == 0:
            return
        sync_rounds.append((time.perf_counter() - t0) * 1e3)


def tenants_pool_phase(dev, card: str) -> dict:
    """tenants_pool: the reference bench's headline `tenants` arm, the
    chain template (checks.TENANT_TEMPLATE: a filter on two tenant
    parameters, lengthBatch(256), a projection) at 64, 256 and 1,024
    tenants x 2,048 rows, batch_max 1,024, each tenant with
    checks.tenant_bindings, through TemplateRegistry(SiddhiManager())
    .pool(...). One warm pass, then 3 timed passes (events/s, rounds,
    each round's p50/p99 to the device's end). In the warm pass at
    every count, 8 sampled tenants' pooled rows equal separate runtimes
    of the template with the same bindings, fed the same round chunks,
    bit for bit; at 1,024 tenants the first round's K1[K], K2 and K5[K]
    launches are held against their plain versions (tolerance 0) and
    timed, and one timed pass runs (the depth cut for time). K1[K], K2
    with its parameter loads (expr_eval[K]) and K5[K] must launch on the
    timed passes."""
    from siddhi_tpu_torch import SiddhiManager, _kernels
    from siddhi_tpu_torch import checks as C
    from siddhi_tpu_torch.serving import TemplateRegistry
    out = {"per_n": {}, "launches": {k: 0 for k in _kernels.LAUNCHES}}
    ts, cols = C.tenant_data(POOL_ROWS)
    span = int(ts[-1] - ts[0]) + 1
    for n in POOL_TENANTS:
        t_n = time.perf_counter()
        reg = TemplateRegistry(SiddhiManager())
        pool = reg.pool(C.TENANT_TEMPLATE, slots=n, max_tenants=n,
                        batch_max=POOL_BATCH_MAX)
        tids = [f"t{i}" for i in range(n)]
        for i, tid in enumerate(tids):
            pool.add_tenant(tid, C.tenant_bindings(i))
        sampled = tids[:: max(1, n // POOL_SAMPLED)][:POOL_SAMPLED]
        got: dict = {}
        _pool_rows(pool, sampled, got)
        takes = _TakeLog(pool, sampled)
        rounds: list = []
        last = n == POOL_TENANTS[-1]
        passes = 1 if last else POOL_PASSES
        cap = PoolCapture(1) if last else None
        if cap is not None:
            with cap:
                _pool_pass(pool, tids, {"In": (ts, cols)}, 0, rounds)
        else:
            _pool_pass(pool, tids, {"In": (ts, cols)}, 0, rounds)
        takes.stop()
        pool._callbacks.clear()
        for i, tid in enumerate(sampled):
            sep = _separate_rows(C.TENANT_TEMPLATE,
                                 C.tenant_bindings(tids.index(tid)),
                                 takes.log[tid], f"sep_chain_{n}_{i}")
            if sep != got.get(tid, []) or not sep:
                fail(f"tenants_pool {n}: tenant {tid}'s pooled rows "
                     f"({len(got.get(tid, []))}) differ from a separate "
                     f"runtime's ({len(sep)})")
        # the timed passes: counts from 0, then read
        _kernels.reset_launches()
        rounds = []
        t0 = time.perf_counter()
        for p in range(1, passes + 1):
            _pool_pass(pool, tids, {"In": (ts, cols)}, p * span, rounds)
        wall = time.perf_counter() - t0
        launches = dict(_kernels.LAUNCHES)
        for k in ("unpack_packed[K]", "expr_eval[K]", "window_step[K]"):
            if launches[k] == 0:
                fail(f"tenants_pool {n}: {k} did not launch on the "
                     f"pool's path ({launches})")
            out["launches"][k] += launches[k]
        events = n * POOL_ROWS * passes
        st = pool.statistics()
        eps = events / wall
        p50, p99 = (float(np.percentile(rounds, q)) for q in (50, 99))
        out["per_n"][n] = {"eps": eps, "rounds": len(rounds),
                           "round_p50_ms": p50, "round_p99_ms": p99,
                           "pad_frac": st["packed_ingest"]["pad_frac"]}
        print(f"tenants_pool {n} tenants x {POOL_ROWS} rows, batch_max "
              f"{POOL_BATCH_MAX}: {eps:.0f} events/s over {passes} "
              f"passes ({len(rounds)} rounds, a round p50 {p50:.3f} ms, "
              f"p99 {p99:.3f} ms to the device's end); {len(sampled)} "
              f"sampled tenants equal separate runtimes bit for bit; "
              f"state {pool.state_bytes_per_tenant} bytes a tenant; "
              f"launches {launches}; {card}", flush=True)
        if cap is not None:
            for kind, key in (("K1", "k1"), ("K2", "k2"), ("K5", "k5")):
                r = _pool_check(kind, cap.rec[kind],
                                f"tenants_pool {n}")
                out[key] = r
                print(f"tenants_pool {n}: {kind} launches of the first "
                      f"round ({r['checked']}) bit-equal to the plain "
                      f"version; {r['ms']:.4f} ms a launch, plain "
                      f"{r['plain_ms']:.2f} ms, bound {r['bound_ms']:.5f} "
                      f"ms ({r['bytes']} bytes), library "
                      f"{r['library_ms']} ms", flush=True)
            del cap
        pool.shutdown()
        reg.shutdown()
        gc.collect()
        print(f"[tenants_pool {n}: {time.perf_counter() - t_n:.1f} s]",
              flush=True)
    return out


def _class_phase(dev, card: str, what: str, template: str, streams,
                 checks: tuple, advance: bool = False,
                 skip: Optional[dict] = None) -> dict:
    """One operator class's pool: 64 tenants x 1,024 rows a stream,
    batch_max 256, checks.class_feeds(seed=17) (the reference bench's
    class arm); one warm pass (the first rounds' kernels captured, 8
    sampled tenants held against separate runtimes), then 3 timed passes
    whose launches are read; each pass moves the timestamps on, and with
    ``advance`` every pass ends with an advance_time round 2 s past its
    last event; ``skip`` passes over the first launches of a kernel in
    the capture (PoolCapture). -> events/s, rounds, launches and each
    captured kernel's check and times."""
    from siddhi_tpu_torch import SiddhiManager, _kernels
    from siddhi_tpu_torch import checks as C
    from siddhi_tpu_torch.serving import TemplateRegistry
    n = CLASS_TENANTS
    reg = TemplateRegistry(SiddhiManager())
    pool = reg.pool(template, slots=n, max_tenants=n,
                    batch_max=CLASS_BATCH_MAX, name=what)
    tids = [f"t{i}" for i in range(n)]
    for tid in tids:
        pool.add_tenant(tid)
    feeds = C.class_feeds(streams, CLASS_ROWS, seed=17)
    span = max(int(ts[-1]) for ts, _c in feeds.values()) - C.TS0 + 4
    span += 2000 + 1000
    sampled = tids[:: n // POOL_SAMPLED][:POOL_SAMPLED]
    got: dict = {}
    _pool_rows(pool, sampled, got)
    takes = _TakeLog(pool, sampled)
    cap = PoolCapture(2, skip)
    rounds: list = []

    def one_pass(p):
        _pool_pass(pool, tids, feeds, p * span, rounds)
        if advance:
            last = C.TS0 + p * span + span - 3000 + 2000
            pool.advance_time(last)
            for tid in sampled:
                takes.log.setdefault(tid, []).append((None, last, None))
            torch.cuda.synchronize()
    with cap:
        one_pass(0)
    takes.stop()
    pool._callbacks.clear()
    for i, tid in enumerate(sampled):
        chunks = []
        for sid, ts, cols in takes.log.get(tid, []):
            if sid is None:   # advance_time: an event that neither
                # starts (v <= 800) nor ends (k < 0) a match
                chunks.append(("S", np.array([ts], np.int64),
                               [np.array([-1], np.int64),
                                np.array([0.0])]))
            else:
                chunks.append((sid, ts, cols))
        sep = _separate_rows("@app:playback\n" + template, {}, chunks,
                             f"sep_{what}_{i}")
        mine = got.get(tid, [])
        same = sorted(sep) == sorted(mine) if advance else sep == mine
        if not same:
            fail(f"{what}: tenant {tid}'s pooled rows ({len(mine)}) differ "
                 f"from a separate runtime's ({len(sep)})")
    n_rows = sum(len(v) for v in got.values())
    _kernels.reset_launches()
    rounds = []
    t0 = time.perf_counter()
    for p in range(1, POOL_PASSES + 1):
        one_pass(p)
    wall = time.perf_counter() - t0
    launches = dict(_kernels.LAUNCHES)
    events = n * CLASS_ROWS * len(streams) * POOL_PASSES
    eps = events / wall
    p50, p99 = (float(np.percentile(rounds, q)) for q in (50, 99))
    print(f"{what} {n} tenants x {CLASS_ROWS} rows a stream {list(streams)}"
          f", batch_max {CLASS_BATCH_MAX}: {eps:.0f} events/s over "
          f"{POOL_PASSES} passes ({len(rounds)} rounds, a round p50 "
          f"{p50:.3f} ms, p99 {p99:.3f} ms); {len(sampled)} sampled tenants "
          f"({n_rows} rows in the warm pass) equal separate runtimes"
          f"{' as multisets' if advance else ' bit for bit'}; state "
          f"{pool.state_bytes_per_tenant} bytes a tenant; launches "
          f"{launches}; {card}", flush=True)
    res = {"eps": eps, "rounds": len(rounds), "round_p50_ms": p50,
           "round_p99_ms": p99, "launches": launches}
    for kind, must in checks:
        if launches[must] == 0:
            fail(f"{what}: {must} did not launch on the pool's path "
                 f"({launches})")
        r = _pool_check(kind, cap.rec[kind], what)
        res[kind] = r
        print(f"{what}: {kind} launches of the first rounds "
              f"({r['checked']}) bit-equal to the plain version; "
              f"{r['ms']:.4f} ms a launch, plain {r['plain_ms']:.2f} ms, "
              f"bound {r['bound_ms']:.5f} ms ({r['bytes']} bytes), library "
              f"{r['library_ms']} ms", flush=True)
    del cap
    pool.shutdown()
    reg.shutdown()
    gc.collect()
    return res


def pool_phases(dev, card: str) -> dict:
    """The four pool phases: tenants_pool, pool_pattern, pool_join and
    pool_absent, each timed on a line of its own."""
    from siddhi_tpu_torch import checks as C
    out = {}
    for key, name, fn in (
            ("tenants", "tenants_pool", lambda: tenants_pool_phase(dev,
                                                                   card)),
            ("pattern", "pool_pattern", lambda: _class_phase(
                dev, card, "pool_pattern", C.POOL_PATTERN_TEMPLATE, ("S",),
                (("K3", "nfa_parallel[K]"), ("K2", "expr_eval[K]")))),
            ("join", "pool_join", lambda: _class_phase(
                dev, card, "pool_join", C.POOL_JOIN_TEMPLATE, ("L", "R"),
                (("K7", "join_probe[K]"), ("K5", "window_step[K]")))),
            # K4[K]'s stream step is held from the warm pass's second
            # launch on: the plain version of the first, a full round
            # from an empty table, took 129 s of the run on an H100 (the
            # depth cut for time; partition_fraud holds K4[K] at full
            # rounds)
            ("absent", "pool_absent", lambda: _class_phase(
                dev, card, "pool_absent", C.POOL_ABSENT_TEMPLATE, ("S",),
                (("K4", "nfa_scan[K]"), ("K4t", "nfa_scan[K]")),
                advance=True, skip={"K4": 1}))):
        t0 = time.perf_counter()
        out[key] = fn()
        print(f"[{name}: {time.perf_counter() - t0:.1f} s]", flush=True)
    return out


# -- the aggregation kernels over a slot axis (K11[K], C[K], D[K], H[K]) -----

POOL_AGG_TENANTS, POOL_AGG_ROWS, POOL_AGG_BATCH_MAX = 256, 4096, 1024
POOL_AGG_SHIFT = 40_000   # ms a timed pass moves the feed on
LANES_SEND, LANES_SENDS = 8192, 128
POOL_LANES_TENANTS, POOL_LANES_ROWS = 64, 2048


def _tensor_at(tensors, ptr: int):
    """The tensor of ``tensors`` whose data starts at ``ptr``."""
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.data_ptr() == ptr:
            return t
    fail(f"no kept tensor at {ptr:#x}")


def _k11k_check(rec, what: str, card: str) -> dict:
    """Every kept K11[K] step (a tenant pool's aggregation class) against
    its plain version on the same arguments, the whole slotted state
    (every slot, every duration) bit for bit; then the kernel's time on
    the last one's arguments, the plain version's, the bound (each input
    column read once, the state read and written) and index_add_ of one
    int lane over every slot's and duration's table at the slots the
    kernel placed (no one call computes the step: its float lanes fold
    in row order)."""
    from siddhi_tpu_torch import _kernels
    from siddhi_tpu_torch.core import aggregation as AG
    if not rec:
        fail(f"{what}: no K11[K] step was captured on the pool's path")
    lib = _kernels.load()
    stream = torch.cuda.current_stream().cuda_stream
    err = 0.0
    for i, (ar, st, b, now) in enumerate(rec):
        _new, e = _k11_step(ar, st, b, now, f"{what} K11[K] step {i}")
        err = max(err, e)
    ar, st, b, now = rec[-1]
    gcols, args, ets = AG.step_inputs(ar, b, now)
    _new, a = AG.aggr_args(ar, st, b, gcols, args, ets)
    ms = cuda_ms(lambda: lib.aggregation_step(a, stream), reps=10)
    plain_ms, _r = _timed(lambda: AG.aggregation_step_ref(
        ar, st, b, gcols, args, ets), 1)
    S, B = b.ts.shape
    D, K = len(ar.durations), ar.K
    slot = a._keep[-1]["slot"]        # [S, D, B], the kernel's placement
    offs = torch.arange(S * D, device=slot.device,
                        dtype=torch.int64).reshape(S, D, 1) * K
    placed = (slot >= 0) & (slot < K)
    idx = torch.where(placed, slot.to(torch.int64) + offs,
                      torch.full_like(offs, S * D * K).expand(S, D, B)
                      ).reshape(-1)
    ones = torch.ones_like(idx)
    table = torch.zeros(S * D * K + 1, dtype=torch.int64,
                        device=slot.device)
    lib_ms = cuda_ms(lambda: table.index_add_(0, idx, ones), reps=10)
    reads = [ets if ets is not None else b.ts, b.kind, b.valid]
    reads += [x for c in gcols for x in c]
    for (_f, kind, _a, _dt), arg in zip(ar.lanes, args):
        if arg is not None:
            reads += [arg[1]] if kind == "ncount" else list(arg)
    col_bytes = _nbytes({(t.data_ptr(), t.nbytes): t
                         for t in reads}.values())
    n_bytes = col_bytes + 2 * _nbytes(tree_leaves(st))
    bound, by = bound_of(n_bytes, S * D * B * 64)
    torch.cuda.synchronize()
    print(f"{what}: aggregation_step[K] (K11[K], {S} slots x {D} durations "
          f"x {K} table slots, {B} rows a slot): {len(rec)} captured steps "
          f"bit-equal to the plain version over every slot; {ms:.4f} ms a "
          f"step, plain version {plain_ms:.1f} ms, index_add_ of one int "
          f"lane {lib_ms:.4f} ms, bound {bound:.5f} ms ({by}; {n_bytes} "
          f"bytes); {card}", flush=True)
    return {"err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "library_ms": lib_ms, "checked": len(rec)}


def _lanes_check(args, what: str, card: str) -> dict:
    """One captured K6[K] step whose selector holds the stateful lanes:
    the whole step (K6[K]'s two parts, kernels C, D and H between them)
    against its plain version over every slot (aggregate_step_ref, as
    the runtime runs it on the CPU), bit for bit; then each of C[K],
    D[K] and H[K] launched alone on the step's arguments (after K6's
    part 1), its outputs (the lanes or union it writes and its new
    table) held against its plain version over every slot on the same
    arguments (C's in one call over the slot axis,
    SlidingMinMaxAgg.run_slots, as aggregate_step_ref runs it; D's and
    H's once per slot), and timed; H[K] also against batched
    torch.sort(dim=1) of every slot's pair values with one
    torch.unique_consecutive over the sorted rows laid end to end. ->
    {lane kind: {err, ms, plain_ms, bound_ms, bound_by, library_ms}}."""
    from siddhi_tpu_torch import _kernels
    from siddhi_tpu_torch.ops import aggregators as G
    from siddhi_tpu_torch.ops.slots import stack, unstack
    lib = _kernels.load()
    stream = torch.cuda.current_stream().cuda_stream
    op, state, kc, ac, kind, valid = args
    S, B = kind.shape
    slots, aggs, new, a, stats = G.agg_args(op, state, kc, ac, kind, valid)
    lib.aggregate_step(a, stream, 1)
    for sp, st in stats:
        getattr(lib, {G.SlidingMinMaxAgg: "sliding_minmax",
                      G.DistinctCountAgg: "distinct_count",
                      G.UnionSetAgg: "union_set"}[type(sp)])(a, st, stream)
    lib.aggregate_step(a, stream, 2)
    t0 = time.perf_counter()
    ref = G.aggregate_step_ref(op, state, kc, ac, kind, valid)
    torch.cuda.synchronize()
    step_plain = (time.perf_counter() - t0) * 1e3
    err = compare(f"{what}: K6[K] with its lanes at {[S, B]}",
                  tree_leaves((slots, aggs, new)), tree_leaves(ref))
    del ref
    ctxs = [G.agg_context(op, unstack(state, k), unstack(kc, k), kind[k],
                          valid[k])[0] for k in range(S)]
    runs = [t for t in a._keep[1] if isinstance(t, torch.Tensor)]
    # a column the block's slots share (stride 0) is read once
    kv = sum(x[0].nbytes if x.stride(0) == 0 else x.nbytes
             for x in (kind, valid))
    out = {}
    for s, (sp, st) in zip([i for i, x in enumerate(op.agg_specs)
                            if getattr(x, "stateful", False)], stats):
        name = {G.SlidingMinMaxAgg: "sliding_minmax",
                G.DistinctCountAgg: "distinct_count",
                G.UnionSetAgg: "union_set"}[type(sp)]
        fn = getattr(lib, name)
        ms = cuda_ms(lambda: fn(a, st, stream), reps=5, warmup=1)
        arg, tab, ntab = ac[s], state["tables"][s], new["tables"][s]
        l0 = a.spec_lane0[s]

        def plain():
            if isinstance(sp, G.SlidingMinMaxAgg):
                (res, span), ntab_ = sp.run_slots(arg, ctxs, tab)
                return [((res[k], span[k]), None) for k in range(S)] + \
                    [(None, ntab_)]
            return [sp.run_ref(unstack(arg, k), ctxs[k], unstack(tab, k))
                    for k in range(S)]
        plain_ms, outs = _timed(plain, 1)
        if isinstance(sp, G.SlidingMinMaxAgg):
            want_tab = outs.pop()[1]
        else:
            want_tab = stack([o[1] for o in outs])
        if isinstance(sp, G.UnionSetAgg):
            got = [aggs[s][0], aggs[s][1]]
            want = [stack([o[0][0] for o in outs]),
                    torch.zeros_like(aggs[s][1])]
            lane_bytes = 2 * arg[0].nbytes + arg[1].nbytes + aggs[s][1].nbytes
        else:
            n_lanes = 2 if isinstance(sp, G.SlidingMinMaxAgg) else 1
            got = [_tensor_at(runs, a.run[l0 + i]) for i in range(n_lanes)]
            want = [stack([o[0][i] for o in outs]) for i in range(n_lanes)]
            lane_bytes = arg[0][..., :B].nbytes + arg[1][..., :B].nbytes + \
                _nbytes(got)
        err_l = compare(f"{what}: {name}[K] alone at {[S, B]}",
                        got + tree_leaves(ntab),
                        want + tree_leaves(want_tab))
        n_bytes = lane_bytes + kv + 2 * _nbytes(tree_leaves(tab))
        bound, by = bound_of(n_bytes, 0)
        lib_ms = None
        if isinstance(sp, G.UnionSetAgg):
            pairs = torch.cat([tab["vals"],
                               arg[0][..., 1:].reshape(S, -1)], dim=1)

            def library():
                v, _ = torch.sort(pairs, dim=1)
                return torch.unique_consecutive(v.reshape(-1),
                                                return_counts=True)
            lib_ms = cuda_ms(library, reps=5, warmup=1)
        r = out.setdefault(name, {"err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                                  "bound_ms": 0.0, "bound_by": by,
                                  "library_ms": lib_ms, "bytes": 0, "n": 0})
        # two of a kind (max and min) add up: one row per kernel
        r["err"] = max(r["err"], err_l, err)
        r["ms"] += ms
        r["plain_ms"] += plain_ms
        r["bound_ms"] += bound
        r["bytes"] += n_bytes
        r["n"] += 1
        del outs, want_tab
    torch.cuda.synchronize()
    for name, r in out.items():
        print(f"{what}: {name}[K] ({r['n']} aggregator(s), {S} slots x {B} "
              f"rows) bit-equal to its plain version over every slot; "
              f"{r['ms']:.4f} ms a step, plain version {r['plain_ms']:.1f} "
              f"ms, bound {r['bound_ms']:.5f} ms ({r['bound_by']}; "
              f"{r['bytes']} bytes)"
              + (f", batched torch.sort + torch.unique_consecutive "
                 f"{r['library_ms']:.4f} ms" if r["library_ms"] else "")
              + f"; the whole K6[K] step bit-equal too, its plain version "
              f"{step_plain:.1f} ms; {card}", flush=True)
    gc.collect()
    return out


def partition_lanes_phase(dev, card: str, n_sends: int = LANES_SENDS) -> dict:
    """partition_lanes: partition_avg's stream, block and feed (512
    symbols, 128 sends of 8,192, every operator over 1,024 slots x 8,192
    rows) with the stateful lanes in the selector
    (checks.PARTITION_LANES_APP: max and min over the length(10) window's
    expiring content, distinctCount, unionSet with sizeOfSet) end to end
    through SiddhiManager, send_arrays and batch_callbacks. K9p, K5[K],
    K6[K], C[K] (twice a step), D[K] and H[K] must launch on every step.
    Eight sampled symbols' rows equal a separate runtime of the query
    alone on the card (checks.PARTITION_LANES_KEY_APP), fed each send's
    rows of that symbol as one send, bit for bit. Then a mid-run step's
    captured K6[K] arguments: the whole step, and C[K], D[K] and H[K]
    alone, against their plain versions over every slot
    (_lanes_check)."""
    from siddhi_tpu_torch import SiddhiManager, _kernels
    from siddhi_tpu_torch import checks as C
    from siddhi_tpu_torch.core.types import GLOBAL_STRINGS
    from siddhi_tpu_torch.ops import aggregators as G
    enc = GLOBAL_STRINGS.encode
    SEND = LANES_SEND
    N = n_sends * SEND
    ts_all, cols_all = _avg_feed(N + 10 * SEND, enc)
    mgr = SiddhiManager()
    warm = mgr.create_siddhi_app_runtime(C.PARTITION_LANES_APP)
    warm.start()
    _send_all(warm.get_input_handler("StockStream"), ts_all[N:],
              [c[N:] for c in cols_all], (0, SEND, 2 * SEND))
    torch.cuda.synchronize()
    warm.shutdown()
    del warm
    rt = mgr.create_siddhi_app_runtime(C.PARTITION_LANES_APP)
    outs = []
    rt.queries["q"].batch_callbacks.append(outs.append)
    rt.start()
    h = rt.get_input_handler("StockStream")
    _kernels.reset_launches()
    t0 = time.perf_counter()
    for s in range(0, N, SEND):
        h.send_arrays(ts_all[s:s + SEND], [c[s:s + SEND] for c in cols_all])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_kernels.LAUNCHES)
    want = {"partition_route": n_sends, "partition_compact": n_sends,
            "window_step[K]": n_sends, "aggregate_step[K]": n_sends,
            "aggregate_emit[K]": n_sends, "sliding_minmax[K]": 2 * n_sends,
            "distinct_count[K]": n_sends, "union_set[K]": n_sends}
    for k, v in want.items():
        if launches[k] != v:
            fail(f"partition_lanes: {k} launched {launches[k]} times, "
                 f"the path's {v} ({launches})")
    ots, ocols, onulls = C.emitted_columns(outs)
    rt.queries["q"].batch_callbacks.clear()
    del outs
    eps = N / wall
    st = rt.queries["q"].stats()
    # sampled symbols (of those the block placed) against the query
    # alone, fed each send's rows of the symbol as one send
    codes = np.unique(ocols[0])
    sampled = codes[:: max(1, len(codes) // 8)][:8]
    for code in sampled:
        sep = mgr.create_siddhi_app_runtime(C.PARTITION_LANES_KEY_APP)
        souts = []
        sep.queries["q"].batch_callbacks.append(souts.append)
        sep.start()
        sh = sep.get_input_handler("StockStream")
        for s in range(0, N, SEND):
            m = cols_all[0][s:s + SEND] == code
            if m.any():
                sh.send_arrays(ts_all[s:s + SEND][m],
                               [c[s:s + SEND][m] for c in cols_all])
        torch.cuda.synchronize()
        sep.shutdown()
        wts, wcols, wnulls = C.emitted_columns(souts)
        mine = ocols[0] == code
        if not mine.any() or not np.array_equal(ots[mine], wts) or any(
                not np.array_equal(bits_np(c[mine]), bits_np(w))
                for c, w in zip(ocols + onulls, wcols + wnulls)):
            fail(f"partition_lanes: symbol {GLOBAL_STRINGS.decode(int(code))}"
                 f"'s {int(mine.sum())} rows differ from the query alone "
                 f"({len(wts)})")
    print(f"partition_lanes: {N} events in {n_sends} sends of {SEND}; "
          f"{len(ots)} rows, {len(sampled)} sampled symbols' rows equal the "
          f"query alone bit for bit; stats {st}; {eps:.0f} events/s, device "
          f"batches only ({card})", flush=True)
    print(f"launches on the partition_lanes path: {launches}", flush=True)
    chunk = _chunker(ts_all, cols_all, N)
    with _Capture([(G, "aggregate_step",
                    lambda *a: a[4].dim() == 2)]) as cap:
        p50, p99 = _latency(h, chunk, SEND, 4)
    print(f"partition_lanes latency per send: {SEND} rows p50 {p50:.3f} ms, "
          f"p99 {p99:.3f} ms ({card})", flush=True)
    lanes = _lanes_check(cap.args["aggregate_step"], "partition_lanes", card)
    _kernels.LAUNCHES.update(launches)
    rt.shutdown()
    del cap
    gc.collect()
    return {"events_per_s_device_batches": eps, "rows": len(ots),
            "p50_ms_send": p50, "p99_ms_send": p99, "launches": launches,
            "lanes": lanes, "card": card}


def pool_aggregation_phase(dev, card: str) -> dict:
    """pool_aggregation: SaaS per-tenant metering (checks.POOL_AGG_TEMPLATE:
    the query guide's six-duration aggregation of AGG_TRADES_APP word for
    word, beside an alert filter at each tenant's own floor,
    checks.pool_agg_bindings) for 256 tenants x 4,096 trades a pass
    (checks.agg_trades_feed, 64 symbols, event times 0-2 s out of order,
    a seed a tenant), batch_max 1,024: a round is 256 slots x 1,024 rows,
    the bucket tables 256 x 6 durations x 4,096 slots. One warm pass (its
    first two rounds' K1[K], K2 and K11[K] launches kept), then 3 timed
    passes, each moving the feed 40 s on. Eight sampled tenants' alert
    rows, and their six durations' materialize_tenant tables, equal a
    separate runtime each on the card, fed the tenant's round chunks, bit
    for bit. K1[K], K2 with its parameter loads and K11[K] must launch on
    the timed passes; the kept launches are held against their plain
    versions over every slot and timed."""
    from siddhi_tpu_torch import SiddhiManager, _kernels
    from siddhi_tpu_torch import checks as C
    from siddhi_tpu_torch.core import aggregation as AG
    from siddhi_tpu_torch.core.types import GLOBAL_STRINGS
    from siddhi_tpu_torch.serving import TemplateRegistry
    n, R, bm = POOL_AGG_TENANTS, POOL_AGG_ROWS, POOL_AGG_BATCH_MAX
    agg = "TradeAggregation"
    reg = TemplateRegistry(SiddhiManager())
    pool = reg.pool(C.POOL_AGG_TEMPLATE, slots=n, max_tenants=n,
                    batch_max=bm, name="pool_aggregation")
    tids = [f"t{i}" for i in range(n)]
    feeds = {}
    for i, tid in enumerate(tids):
        pool.add_tenant(tid, C.pool_agg_bindings(i))
        feeds[tid] = C.agg_trades_feed(R, GLOBAL_STRINGS.encode,
                                       seed=1000 + i)
    per_tenant = pool.state_bytes_per_tenant
    print(f"pool_aggregation: state {per_tenant} bytes a tenant "
          f"({pool.state_bytes_by_class}), {per_tenant * n} bytes for "
          f"{n} tenants ({card})", flush=True)
    sampled = tids[:: n // POOL_SAMPLED][:POOL_SAMPLED]
    got: dict = {}
    for tid in sampled:
        pool.add_callback(tid, lambda evs, tid=tid: got.setdefault(
            tid, []).extend((e.timestamp, e.is_expired, tuple(e.data))
                            for e in evs))
    takes = _TakeLog(pool, sampled)

    def send_pass(p):
        for tid in tids:
            ts, (sym, price, vol, stamp) = feeds[tid]
            sh = p * POOL_AGG_SHIFT
            pool.send(tid, ts + sh, [sym, price, vol, stamp + sh])
    rounds: list = []
    cap = PoolCapture(2)
    tap = _Capture([(AG, "aggregation_step",
                     lambda ar, st, b, now: b.ts.dim() == 2)], limit=2)
    send_pass(0)
    with cap, tap:
        _pool_drain(pool, rounds)
    takes.stop()
    pool._callbacks.clear()
    for i, tid in enumerate(sampled):
        rows, sep = _sep_runtime(C.POOL_AGG_TEMPLATE,
                                 C.pool_agg_bindings(tids.index(tid)),
                                 takes.log[tid], f"sep_agg_{i}", "Alerts")
        if rows != got.get(tid, []) or not rows:
            fail(f"pool_aggregation: tenant {tid}'s alert rows "
                 f"({len(got.get(tid, []))}) differ from a separate "
                 f"runtime's ({len(rows)})")
        ar = sep.aggregations[agg]
        for d in ar.durations:
            _s, want = ar.materialize(d, None, None)
            _s, mine = pool.materialize_tenant(tid, agg, d)
            compare(f"pool_aggregation: tenant {tid}'s {d} table",
                    [*mine["cols"], *mine["nulls"], mine["valid"]],
                    [*want["cols"], *want["nulls"], want["valid"]])
            if not bool(mine["valid"].any()):
                fail(f"pool_aggregation: tenant {tid}'s {d} table is empty")
    warm_rounds = len(rounds)
    _kernels.reset_launches()
    rounds = []
    t0 = time.perf_counter()
    for p in range(1, POOL_PASSES + 1):
        send_pass(p)
        _pool_drain(pool, rounds)
    wall = time.perf_counter() - t0
    launches = dict(_kernels.LAUNCHES)
    for k in ("unpack_packed[K]", "expr_eval[K]", "aggregation_step[K]"):
        if launches[k] == 0:
            fail(f"pool_aggregation: {k} did not launch on the pool's path "
                 f"({launches})")
    events = n * R * POOL_PASSES
    eps = events / wall
    p50, p99 = (float(np.percentile(rounds, q)) for q in (50, 99))
    print(f"pool_aggregation {n} tenants x {R} trades, batch_max {bm}: "
          f"{eps:.0f} events/s over {POOL_PASSES} passes ({len(rounds)} "
          f"rounds, a round p50 {p50:.3f} ms, p99 {p99:.3f} ms to the "
          f"device's end; warm pass {warm_rounds} rounds); {len(sampled)} "
          f"sampled tenants' alerts and six duration tables equal separate "
          f"runtimes bit for bit; launches {launches}; {card}", flush=True)
    res = {"eps": eps, "rounds": len(rounds), "round_p50_ms": p50,
           "round_p99_ms": p99, "launches": launches,
           "state_bytes_per_tenant": per_tenant}
    res["k11"] = _k11k_check(tap.kept.get("aggregation_step", []),
                             "pool_aggregation", card)
    for kind in ("K1", "K2"):
        r = _pool_check(kind, cap.rec[kind], "pool_aggregation")
        res[kind] = r
        print(f"pool_aggregation: {kind} launches of the first rounds "
              f"({r['checked']}) bit-equal to the plain version; "
              f"{r['ms']:.4f} ms a launch, plain {r['plain_ms']:.2f} ms, "
              f"bound {r['bound_ms']:.5f} ms ({r['bytes']} bytes)",
              flush=True)
    del cap, tap
    pool.shutdown()
    reg.shutdown()
    gc.collect()
    return res


def pool_lanes_phase(dev, card: str) -> dict:
    """pool_lanes: the lanes in a pool chain (checks.POOL_LANES_TEMPLATE:
    TENANT_TEMPLATE's filter, a length(256) window, max/min, distinctCount
    and unionSet with sizeOfSet) for 64 tenants x 2,048 rows
    (checks.tenant_data, checks.tenant_bindings), batch_max 1,024: two
    passes, the second's first K6[K] step kept; 8 sampled tenants' rows equal
    separate runtimes, bit for bit; C[K], D[K] and H[K] must launch; the
    kept step held against its plain version over every slot
    (_lanes_check)."""
    from siddhi_tpu_torch import SiddhiManager, _kernels
    from siddhi_tpu_torch import checks as C
    from siddhi_tpu_torch.ops import aggregators as G
    from siddhi_tpu_torch.serving import TemplateRegistry
    n = POOL_LANES_TENANTS
    reg = TemplateRegistry(SiddhiManager())
    pool = reg.pool(C.POOL_LANES_TEMPLATE, slots=n, max_tenants=n,
                    batch_max=POOL_BATCH_MAX, name="pool_lanes")
    tids = [f"t{i}" for i in range(n)]
    for i, tid in enumerate(tids):
        pool.add_tenant(tid, C.tenant_bindings(i))
    ts, cols = C.tenant_data(POOL_LANES_ROWS)
    sampled = tids[:: n // POOL_SAMPLED][:POOL_SAMPLED]
    got: dict = {}
    _pool_rows(pool, sampled, got)
    takes = _TakeLog(pool, sampled)
    _kernels.reset_launches()
    rounds: list = []
    span = int(ts[-1] - ts[0]) + 1
    t0 = time.perf_counter()
    _pool_pass(pool, tids, {"In": (ts, cols)}, 0, rounds)
    # the second pass's first step, its windows full, is kept
    with _Capture([(G, "aggregate_step",
                    lambda *a: a[4].dim() == 2)]) as cap:
        _pool_pass(pool, tids, {"In": (ts, cols)}, span, rounds)
    wall = time.perf_counter() - t0
    launches = dict(_kernels.LAUNCHES)
    takes.stop()
    for k in ("sliding_minmax[K]", "distinct_count[K]", "union_set[K]",
              "aggregate_step[K]", "aggregate_emit[K]", "expr_eval[K]",
              "window_step[K]", "unpack_packed[K]"):
        if launches[k] == 0:
            fail(f"pool_lanes: {k} did not launch on the pool's path "
                 f"({launches})")
    for i, tid in enumerate(sampled):
        sep = _separate_rows(C.POOL_LANES_TEMPLATE,
                             C.tenant_bindings(tids.index(tid)),
                             takes.log[tid], f"sep_lanes_{i}")
        if sep != got.get(tid, []) or not sep:
            fail(f"pool_lanes: tenant {tid}'s pooled rows "
                 f"({len(got.get(tid, []))}) differ from a separate "
                 f"runtime's ({len(sep)})")
    eps = 2 * n * POOL_LANES_ROWS / wall
    print(f"pool_lanes {n} tenants x {POOL_LANES_ROWS} rows, batch_max "
          f"{POOL_BATCH_MAX}: {eps:.0f} events/s in two passes ({len(rounds)} "
          f"rounds); {len(sampled)} sampled tenants equal separate runtimes "
          f"bit for bit; launches {launches}; {card}", flush=True)
    lanes = _lanes_check(cap.args["aggregate_step"], "pool_lanes", card)
    pool.shutdown()
    reg.shutdown()
    del cap
    gc.collect()
    return {"eps": eps, "launches": launches, "lanes": lanes}


# -- every window kind over a slot axis (A[K], B[K], E[K], F[K]) -----------

# the four paths' shapes: the block's slots, rows a send, sends; the
# pool's tenants and rows a tenant a pass
WIN_SLOTS, WIN_SEND, WIN_SENDS = 1024, 8192, 128
POOL_WIN_TENANTS, POOL_WIN_ROWS, POOL_WIN_PASSES = 64, 1024, 3
WIN_SAMPLED = 8
# A[K]'s six K5 kinds (ops/windows2.py KIND), the sort window, kernel E,
# kernel F: their wrappers, the launch counters and the reference line
WIN_KERNELS = {
    "A": ("window_step[K]", "window_step.cu",
          "siddhi_tpu/ops/windows2.py:85"),
    "B": ("sort_window[K]", "window_seq.cu",
          "siddhi_tpu/ops/windows2.py:443"),
    "E": ("freq_window[K]", "window_seq.cu",
          "siddhi_tpu/ops/windows2.py:569"),
    "F": ("session_window[K]", "session_step.cu",
          "siddhi_tpu/ops/windows2.py:1168"),
}


class _StepCapture:
    """While installed, keeps the first slotted stream step of every
    window (A[K]: one a K5 kind, 5-10; B[K], E[K], F[K]: one an operator
    kind) that the path runs after ``skip`` such steps of it: {(kernel,
    kind name): (op, state, batch, now)}."""

    def __init__(self, skip: int = 0):
        self.skip, self.seen, self.kept = skip, {}, {}

    def __enter__(self):
        from siddhi_tpu_torch.ops import windows as W
        from siddhi_tpu_torch.ops import windows2 as W2
        self.targets = [(W, "window_step", "A"),
                        (W2, "sort_window_step", "B"),
                        (W2, "freq_window_step", "E"),
                        (W2, "session_step", "F")]
        self.saved = [getattr(m, a) for m, a, _k in self.targets]
        for (m, a, kern), f in zip(self.targets, self.saved):
            def wrap(op, state, batch, now, _f=f, _k=kern):
                # a stream step (a timer step's batch is a row or two)
                if batch.ts.dim() == 2 and batch.ts.shape[1] > 64 and (
                        _k != "A" or 5 <= op.KIND <= 10):
                    key = (_k, op.kind_name)
                    n = self.seen.get(key, 0)
                    self.seen[key] = n + 1
                    if n == self.skip:
                        self.kept[key] = (op, state, batch, now)
                return _f(op, state, batch, now)
            setattr(m, a, wrap)
        return self

    def __exit__(self, *exc):
        for (m, a, _k), f in zip(self.targets, self.saved):
            setattr(m, a, f)
        return False


def _win_step_check(kern: str, args, what: str) -> dict:
    """One captured slotted window step: the kernel launched alone on the
    step's arguments (its wrapper's argument builder, fresh outputs, so
    a launch can repeat), its new state and output batch held against the
    plain version over every slot (A[K], F[K]: the one-slot plain version
    once a slot; B[K], E[K]: their walks over the slot axis in one call,
    which tests/test_torch_partition_windows3.py holds to the one-slot
    version), bit for bit, and timed, with the plain version's time, the
    bound (the batch's columns the slots share once, their valid masks,
    the state read, the new state and the output written; B and E also
    their walks' compares) and the nearest library call: A[K], F[K] a
    batched stable torch.sort of the step's emission keys along the row
    axis, B[K] the same of the sort key, E[K] none."""
    from siddhi_tpu_torch import _kernels
    from siddhi_tpu_torch.ops import windows as W
    from siddhi_tpu_torch.ops import windows2 as W2
    from siddhi_tpu_torch.ops.slots import per_slot
    lib = _kernels.load()
    stream = torch.cuda.current_stream().cuda_stream
    op, state, batch, now = args
    K, B = batch.ts.shape
    nowt = torch.as_tensor(now, dtype=torch.int64, device=batch.ts.device)
    if kern == "A":
        new, out, a = W.window_args(op, state, batch, nowt)
        launch = lib.window_step

        def plain():
            return per_slot(lambda st, b: W.window_step_ref(op, st, b, now),
                            K, state, batch)
    elif kern == "B":
        new, out, a = W2.sort_args(op, state, batch, nowt)
        launch = lib.sort_window

        def plain():
            return W2.sort_window_slots_ref(op, state, batch, now)
    elif kern == "E":
        new, out, a = W2.freq_args(op, state, batch, nowt)
        launch = lib.freq_window

        def plain():
            return W2.freq_window_slots_ref(op, state, batch, now)
    else:
        new, out, a = W2.session_args(op, state, batch)
        launch = lib.session_window

        def plain():
            return W2.session_step_ref(op, state, batch, now)
    launch(a, stream)
    plain_ms, (pst, pout) = _timed(plain, 1)
    name = f"{what}: {WIN_KERNELS[kern][0]} ({op.kind_name}) at {[K, B]}"
    err = compare(name, tree_leaves(new) + _bl(out),
                  tree_leaves(pst) + _bl(pout))
    del pst, pout
    ms = cuda_ms(lambda: launch(a, stream), reps=5, warmup=1)
    n_bytes = _slot_bytes(batch) + _nbytes(tree_leaves(state)) + \
        _nbytes(tree_leaves(new)) + _nbytes(_bl(out))
    walked = int((batch.valid & (batch.kind == 0)).sum())
    n_ops = 0
    if kern == "B":   # a row's insert and the comparator over L + 1 rows
        n_ops = walked * (op.L + 1) * (2 * len(op.keys) + 3)
    elif kern == "E":   # a row's votes over the table
        n_ops = walked * op.N * 4
    bound, by = bound_of(n_bytes, n_ops)
    lib_ms = None
    if kern in ("A", "F"):
        keys = a._keep[3]["keys" if kern == "A" else "ekey"]
        lib_ms = cuda_ms(lambda: torch.sort(keys, dim=1, stable=True),
                         reps=5, warmup=1)
    elif kern == "B":
        idx, _order = op.keys[0]
        kcol = batch.cols[idx].contiguous()
        lib_ms = cuda_ms(lambda: torch.sort(kcol, dim=1, stable=True),
                         reps=5, warmup=1)
    torch.cuda.synchronize()
    print(f"{name}: bit-equal to its plain version over every slot; "
          f"{ms:.4f} ms a step, plain version {plain_ms:.1f} ms, bound "
          f"{bound:.5f} ms ({by}; {n_bytes} bytes, {n_ops} operations)"
          + (f", library {lib_ms:.4f} ms" if lib_ms is not None else ""),
          flush=True)
    del new, out, a
    gc.collect()
    return {"err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "library_ms": lib_ms}


def _win_checks(cap: _StepCapture, what: str, need) -> dict:
    """_win_step_check of every captured step -> {kernel: the row of the
    kernel's slowest kind (its time, bound and plain version's; the
    largest error)}; fails unless each kernel of ``need`` was captured."""
    rows: dict = {}
    for (kern, kind), args in sorted(cap.kept.items()):
        r = _win_step_check(kern, args, what)
        cur = rows.get(kern)
        if cur is None or r["ms"] > cur["ms"]:
            r["err"] = max(r["err"], cur["err"] if cur else 0.0)
            r["kind"] = kind
            rows[kern] = r
        else:
            cur["err"] = max(cur["err"], r["err"])
    for kern in need:
        if kern not in rows:
            fail(f"{what}: no slotted {WIN_KERNELS[kern][0]} step was "
                 "captured on the path")
    cap.kept.clear()
    return rows


def _win_block(what: str, kerns, n_sends: int) -> dict:
    """_block_against_separate's need, capture and check for a path of
    window kernels (WIN_KERNELS keys): each launches on every send; one
    slotted step of each window, mid-run, against its plain version
    (_win_checks)."""
    return {"need": tuple((WIN_KERNELS[k][0], n_sends) for k in kerns),
            "capture": _StepCapture(skip=n_sends // 2),
            "check": lambda cap: _win_checks(cap, what, kerns)}


def _block_against_separate(what: str, stream: str, stream_text: str,
                            key: str, queries_text: str, queries, feed,
                            n_sends: int, send: int, card: str,
                            need, capture, check,
                            warm_sends: int = 2) -> dict:
    """A partition path end to end: ``partition with (key of stream)``
    at ``@slots`` WIN_SLOTS around ``queries_text`` through
    SiddhiManager, send_arrays and batch_callbacks, ``n_sends`` sends of
    ``send`` rows of ``feed`` (ts, columns); each (launch counter,
    least launches) pair of ``need`` must be met. Then ``WIN_SAMPLED`` keys that the block
    placed (the first column of the first query's rows) against a
    separate runtime of the same queries in a block of one range a key,
    ``key == 'name' as 'k0' or ...`` (a range's slot sees only its key's
    rows and steps on every send and at the block's timer dues, as the
    key's slot does in the big block: a query outside a block arms its
    timers otherwise), fed the same sends: each key's rows of each query
    equal the big block's rows of the key, bit for bit. ``capture`` (a
    context manager installed around the sends) keeps kernel launches,
    and ``check`` holds them against their plain versions -> rows.
    -> the rows, times, launches and timer steps."""
    from siddhi_tpu_torch import SiddhiManager, _kernels
    from siddhi_tpu_torch import checks as C
    from siddhi_tpu_torch.core.types import GLOBAL_STRINGS
    ts_all, cols_all = feed
    N = n_sends * send
    block_text = stream_text + f"""
    @slots('{WIN_SLOTS}')
    partition with ({key} of {stream}) begin
    {queries_text}
    end;
"""
    mgr = SiddhiManager()
    warm = mgr.create_siddhi_app_runtime(block_text)
    warm.start()
    _send_all(warm.get_input_handler(stream), ts_all[N:],
              [c[N:] for c in cols_all],
              tuple(range(0, warm_sends * send + 1, send)))
    torch.cuda.synchronize()
    warm.shutdown()
    del warm
    gc.collect()
    rt = mgr.create_siddhi_app_runtime(block_text)
    outs = {q: [] for q in queries}
    for q in queries:
        rt.queries[q].batch_callbacks.append(outs[q].append)
    (blk,) = rt.partitions.values()
    timers = {}
    on_timer = blk._on_timer

    def count_timer(qname, due):
        timers[qname] = timers.get(qname, 0) + 1
        on_timer(qname, due)
    blk._on_timer = count_timer
    rt.start()
    h = rt.get_input_handler(stream)
    _kernels.reset_launches()
    with capture as cap:
        t0 = time.perf_counter()
        for s in range(0, N, send):
            h.send_arrays(ts_all[s:s + send],
                          [c[s:s + send] for c in cols_all])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(_kernels.LAUNCHES)
    for k, least in need:
        if launches[k] < least:
            fail(f"{what}: {k} launched {launches[k]} times on "
                 f"{n_sends} sends ({launches})")
    stats = {q: rt.queries[q].stats() for q in queries}
    rt.shutdown()
    eps = N / wall
    block_rows = {q: C.emitted_columns(outs[q]) for q in queries}
    del outs
    n_rows = sum(len(r[0]) for r in block_rows.values())
    codes = np.unique(block_rows[queries[0]][1][0])
    sampled = codes[:: max(1, len(codes) // WIN_SAMPLED)][:WIN_SAMPLED]
    names = [GLOBAL_STRINGS.decode(int(c)) for c in sampled]
    ranges = " or ".join(f"{key} == '{n}' as 'k{i}'"
                         for i, n in enumerate(names))
    sep = mgr.create_siddhi_app_runtime(stream_text + f"""
    partition with ({ranges} of {stream}) begin
    {queries_text}
    end;
""")
    souts = {q: [] for q in queries}
    for q in queries:
        sep.queries[q].batch_callbacks.append(souts[q].append)
    sep.start()
    sh = sep.get_input_handler(stream)
    for s in range(0, N, send):
        sh.send_arrays(ts_all[s:s + send], [c[s:s + send] for c in cols_all])
    torch.cuda.synchronize()
    sep.shutdown()
    seen = 0
    for q in queries:
        bt, bc, bn = block_rows[q]
        st, sc, sn = C.emitted_columns(souts[q])
        for code, name in zip(sampled, names):
            mine, theirs = bc[0] == code, sc[0] == code
            seen += int(theirs.sum())
            if not np.array_equal(bt[mine], st[theirs]) or any(
                    not np.array_equal(bits_np(x[mine]), bits_np(y[theirs]))
                    for x, y in zip(bc + bn, sc + sn)):
                fail(f"{what}: key {name}'s rows of query {q} "
                     f"({int(mine.sum())}) differ from its range's "
                     f"({int(theirs.sum())})")
    del sep, souts
    del block_rows
    gc.collect()
    if not seen:
        fail(f"{what}: the sampled keys have no rows")
    print(f"{what}: {N} events in {n_sends} sends of {send}; {n_rows} rows; "
          f"{len(sampled)} sampled keys' rows of every query equal a block "
          f"of their ranges bit for bit; timer steps {timers} "
          f"({sum(timers.values()) / n_sends:.2f} a send); stats {stats}; "
          f"{eps:.0f} events/s, device batches only ({card})", flush=True)
    print(f"launches on the {what} path: {launches}", flush=True)
    rows = check(cap)
    _kernels.LAUNCHES.update(launches)
    return {"eps": eps, "launches": launches, "timers": timers,
            "rows": rows}


def _trades_queries() -> str:
    """partition_trades' queries: WINDOW_EXT_APP's rolling high, low and
    average over externalTime, WINDOW_BARS_APP's one-second bars over
    externalTimeBatch, timeLength, hopping, delay, batch, and each
    symbol's ten cheapest quotes (sort)."""
    return """
      @info(name = 'ext') @cap(window.size='512')
      from Trades#window.externalTime(ets, 1 min)
      select symbol, max(price) as hi, min(price) as lo, avg(price) as ap,
             count() as n
      group by symbol
      insert into ExtOut;
      @info(name = 'bars') @cap(window.size='512')
      from Trades#window.externalTimeBatch(ets, 1 sec)
      select symbol, max(price) as hi, min(price) as lo, sum(volume) as vol,
             count() as n
      group by symbol
      insert into Bars;
      @info(name = 'recent')
      from Trades#window.timeLength(10 sec, 16)
      select symbol, price, volume
      insert all events into Recent;
      @info(name = 'hops') @cap(window.size='512')
      from Trades#window.hopping(20 sec, 10 sec)
      select symbol, price, volume
      insert into Hops;
      @info(name = 'late') @cap(window.size='512')
      from Trades#window.delay(5 sec)
      select symbol, price, volume
      insert into Late;
      @info(name = 'chunks') @cap(window.size='512')
      from Trades#window.batch()
      select symbol, count() as n, sum(volume) as vol
      insert into Chunks;
      @info(name = 'cheap')
      from Trades#window.sort(10, price, 'asc', volume, 'desc')
      select symbol, price, volume
      insert all events into Cheapest;
"""


TRADES_QUERIES = ("ext", "bars", "recent", "hops", "late", "chunks", "cheap")


def partition_trades_phase(dev, card: str) -> dict:
    """partition_trades: checks.TRADES_STREAM with trades_feed (512
    symbols, ets from TS0 in steps of 0-2 ms), ``partition with (symbol
    of Trades)`` at ``@slots`` WIN_SLOTS, one block of seven queries
    (_trades_queries: six K5 kinds, A[K], and the sort window, B[K]),
    WIN_SENDS sends of WIN_SEND rows; the spans fire about one timer
    step a send of each timed query (timeLength 10 s, hopping every 10
    s, delay 5 s; a send spans 8.192 s). Sampled symbols against blocks
    of their own, one captured step of every kind against its plain
    version (_block_against_separate)."""
    from siddhi_tpu_torch import checks as C
    from siddhi_tpu_torch.core.types import GLOBAL_STRINGS
    N = WIN_SENDS * WIN_SEND
    feed = C.trades_feed(N + 4 * WIN_SEND, GLOBAL_STRINGS.encode)
    return _block_against_separate(
        "partition_trades", "Trades", C.TRADES_STREAM, "symbol",
        _trades_queries(), TRADES_QUERIES, feed, WIN_SENDS, WIN_SEND, card,
        **_win_block("partition_trades", ("A", "B"), WIN_SENDS))


def _block_queries(app: str) -> str:
    """The queries between a partition's ``begin`` and ``end``."""
    return app.split("begin", 1)[1].rsplit("end;", 1)[0]


def partition_purchases_phase(dev, card: str) -> dict:
    """partition_purchases: per-merchant repeat-card screening
    (checks.PARTITION_PURCHASES_APP's queries: ``[price >= 30]
    #window.frequent(2, cardNo)`` and ``#window.lossyFrequent(0.1, 0.01,
    cardNo)``, as FREQUENT_APP and LOSSY_APP, inside ``partition with
    (merchant of Purchase)`` at ``@slots`` WIN_SLOTS), about 1,000
    merchants, cards Zipf(1.3) over 4,096 (merchant_purchase_feed),
    WIN_SENDS sends of WIN_SEND; E[K] twice a send. Sampled merchants
    against blocks of their own (_block_against_separate)."""
    from siddhi_tpu_torch import checks as C
    from siddhi_tpu_torch.core.types import GLOBAL_STRINGS
    N = WIN_SENDS * WIN_SEND
    feed = C.merchant_purchase_feed(N + 4 * WIN_SEND, GLOBAL_STRINGS.encode)
    return _block_against_separate(
        "partition_purchases", "Purchase", C.PURCHASE_MERCHANT_STREAM,
        "merchant", _block_queries(C.PARTITION_PURCHASES_APP),
        ("freq", "lossy"), feed, WIN_SENDS, WIN_SEND, card,
        **_win_block("partition_purchases", ("E",), WIN_SENDS))


def partition_sessions_phase(dev, card: str) -> dict:
    """partition_sessions: CLICK_APP's stream and selector inside
    ``partition with (user of Click)`` at ``@slots`` WIN_SLOTS
    (checks.PARTITION_SESSIONS_APP's query), click_feed at 1,000 users,
    WIN_SENDS sends of WIN_SEND clicks: 1,024 x 64 x 128 member rows of
    session state on the card; F[K] every send and on the gaps' timer
    steps. Sampled users against blocks of their own
    (_block_against_separate)."""
    from siddhi_tpu_torch import checks as C
    from siddhi_tpu_torch.core.types import GLOBAL_STRINGS
    N = WIN_SENDS * WIN_SEND
    feed = C.click_feed(N + 4 * WIN_SEND, GLOBAL_STRINGS.encode,
                        n_users=C.PARTITION_SESSION_USERS)
    stream = C.PARTITION_SESSIONS_APP.split("@slots", 1)[0]
    return _block_against_separate(
        "partition_sessions", "Click", stream, "user",
        _block_queries(C.PARTITION_SESSIONS_APP), ("q",), feed, WIN_SENDS,
        WIN_SEND, card,
        **_win_block("partition_sessions", ("F",), WIN_SENDS))


# POOL_WINDOWS_TEMPLATE's output streams, told apart in a tenant's rows by
# their first value's type and their width
POOL_WIN_STREAMS = {"ExtOut": (float, 3), "TopOut": (float, 2),
                    "HeavyOut": (int, 2), "SessOut": (str, 3)}


def _by_stream(rows) -> dict:
    out = {s: [] for s in POOL_WIN_STREAMS}
    kinds = {v: s for s, v in POOL_WIN_STREAMS.items()}
    for r in rows:
        out[kinds[(type(r[2][0]), len(r[2]))]].append(r)
    # a session's rows compare user by user: the pool closes the sessions
    # a gap between rounds ends at the next round's first row, a separate
    # runtime at their timers, each user's in the same order
    out["SessOut"] = sorted(out["SessOut"], key=lambda r: r[2][0])
    return out


def pool_windows_phase(dev, card: str) -> dict:
    """pool_windows: checks.POOL_WINDOWS_TEMPLATE (externalTime, sort,
    frequent and session, each behind a ``${...}``
    filter) for POOL_WIN_TENANTS tenants x POOL_WIN_ROWS rows a pass
    (checks.pool_windows_feed, class_feeds' (k, v)), batch_max 1,024,
    POOL_WIN_PASSES passes; A[K], B[K], E[K] and F[K] must launch. The
    sampled tenants' rows of each stream equal separate runtimes fed the
    tenant's round chunks (sessions user by user), bit for bit; one
    captured step of each window against its plain version over every
    slot (_win_checks)."""
    from siddhi_tpu_torch import SiddhiManager, StreamCallback, _kernels
    from siddhi_tpu_torch import checks as C
    from siddhi_tpu_torch.core.types import GLOBAL_STRINGS
    from siddhi_tpu_torch.serving import Template, TemplateRegistry
    n = POOL_WIN_TENANTS
    reg = TemplateRegistry(SiddhiManager())
    pool = reg.pool(C.POOL_WINDOWS_TEMPLATE, slots=n, max_tenants=n,
                    batch_max=POOL_BATCH_MAX, name="pool_windows")
    tids = [f"t{i}" for i in range(n)]
    for i, tid in enumerate(tids):
        pool.add_tenant(tid, C.pool_windows_bindings(i))
    ts, cols = C.pool_windows_feed(POOL_WIN_ROWS, GLOBAL_STRINGS.encode)
    sampled = tids[:: n // WIN_SAMPLED][:WIN_SAMPLED]
    got: dict = {}
    _pool_rows(pool, sampled, got)
    takes = _TakeLog(pool, sampled)
    _kernels.reset_launches()
    rounds: list = []
    span = int(ts[-1] - ts[0]) + 1000
    t0 = time.perf_counter()
    with _StepCapture(skip=1) as cap:
        for p in range(POOL_WIN_PASSES):
            _pool_pass(pool, tids, {"S": (ts, cols)}, p * span, rounds)
    wall = time.perf_counter() - t0
    launches = dict(_kernels.LAUNCHES)
    takes.stop()
    for kern in WIN_KERNELS:
        k = WIN_KERNELS[kern][0]
        if launches[k] == 0:
            fail(f"pool_windows: {k} did not launch on the pool's path "
                 f"({launches})")
    for i, tid in enumerate(sampled):
        # on the clock of the rows it is sent, as the pool's rounds are
        text = "@app:playback\n" + Template(
            C.POOL_WINDOWS_TEMPLATE).instantiate_static(
                C.pool_windows_bindings(tids.index(tid)),
                app_name=f"sep_w{i}")
        sep = SiddhiManager().create_siddhi_app_runtime(text)
        rows = []
        for s in POOL_WIN_STREAMS:
            sep.add_callback(s, StreamCallback(lambda evs: rows.extend(
                (e.timestamp, e.is_expired, tuple(e.data)) for e in evs)))
        sep.start()
        for sid, t, c in takes.log[tid]:
            sep.get_input_handler(sid).send_arrays(t, c)
        torch.cuda.synchronize()
        sep.shutdown()
        mine, theirs = _by_stream(got.get(tid, [])), _by_stream(rows)
        for s in POOL_WIN_STREAMS:
            if mine[s] != theirs[s] or not theirs[s]:
                fail(f"pool_windows: tenant {tid}'s pooled rows of {s} "
                     f"({len(mine[s])}) differ from a separate runtime's "
                     f"({len(theirs[s])})")
    eps = POOL_WIN_PASSES * n * POOL_WIN_ROWS / wall
    print(f"pool_windows {n} tenants x {POOL_WIN_ROWS} rows, batch_max "
          f"{POOL_BATCH_MAX}: {eps:.0f} events/s in {POOL_WIN_PASSES} "
          f"passes ({len(rounds)} rounds, p50 "
          f"{float(np.percentile(rounds, 50)):.3f} ms); {len(sampled)} "
          f"sampled tenants equal separate runtimes bit for bit (every "
          f"stream; sessions user by user); launches {launches}; {card}",
          flush=True)
    rows = _win_checks(cap, "pool_windows", tuple(WIN_KERNELS))
    pool.shutdown()
    reg.shutdown()
    gc.collect()
    return {"eps": eps, "launches": launches, "rows": rows}


def window_slot_phases(dev, card: str) -> dict:
    """The four window paths over a slot axis, each timed on a line of
    its own. -> {path: result}."""
    out = {}
    for name, fn in (("partition_trades", partition_trades_phase),
                     ("partition_purchases", partition_purchases_phase),
                     ("partition_sessions", partition_sessions_phase),
                     ("pool_windows", pool_windows_phase)):
        t0 = time.perf_counter()
        out[name] = fn(dev, card)
        print(f"[{name}: {time.perf_counter() - t0:.1f} s]", flush=True)
    return out


# -- order by, offset and limit over a slot axis (G[K]) -----------------------

TOP_SYMS, TOP_SEND, TOP_SENDS = 512, 8192, 128
RADAR_TENANTS, RADAR_ROWS, RADAR_ROUNDS = 64, 1024, 8
ORDER_KEPT = 2   # G[K] launches kept a query, the first ones


class _OrderCapture:
    """While installed, the arguments of the first ORDER_KEPT G[K]
    launches of each query shape (ops/selector.py shape_chunk_slots:
    (batch, order, offset, limit, the emitted counter before the launch))
    are kept, by (order, offset, limit)."""

    def __enter__(self):
        from siddhi_tpu_torch.ops import selector as S
        self.S, self.kept = S, {}
        self.orig = S.shape_chunk_slots

        def tap(out, order_by, offset, limit, emitted=None):
            key = (tuple(order_by), offset, limit)
            got = self.kept.setdefault(key, [])
            if len(got) < ORDER_KEPT:
                got.append((out, list(order_by), offset, limit,
                            None if emitted is None else emitted.clone()))
            return self.orig(out, order_by, offset, limit, emitted)
        S.shape_chunk_slots = tap
        return self

    def __exit__(self, *exc):
        self.S.shape_chunk_slots = self.orig
        return False


def _order_checks(cap: _OrderCapture, what: str) -> dict:
    """Every kept G[K] launch against shape_chunk_slots_ref on the same
    arguments, every slot, dead rows and the emitted counters included,
    bit for bit; then, on the last launch of each shape, the kernel's
    time (its argument struct built once), the plain version's, the
    bound (the batch's inputs read once, a column the slots share once,
    and the [K, B] output written once, at the HBM rate), the design's
    own sort traffic beside it (a key word and a row index a row for
    each key, read and written: not part of the bound) and the
    library's: chained
    stable torch.sort(dim=1) of the key words (made outside the timing)
    and the dead flags, and the gathers of every column. -> the row of
    the shape whose launch is the slowest (its error the largest of
    all)."""
    from siddhi_tpu_torch import _kernels
    from siddhi_tpu_torch.ops import selector as S
    lib = _kernels.load()
    stream = torch.cuda.current_stream().cuda_stream
    if not cap.kept:
        fail(f"{what}: no G[K] launch was captured on the path")
    row, err, n = None, 0.0, 0
    for key, kept in cap.kept.items():
        for i, (out, ob, off, lim, em) in enumerate(kept):
            ek = None if em is None else em.clone()
            ep = None if em is None else em.clone()
            got = S.shape_chunk_slots(out, ob, off, lim, ek)
            want = S.shape_chunk_slots_ref(out, ob, off, lim, ep)
            err = max(err, compare(
                f"{what}: order_by[K] {ob} offset {off} limit {lim} "
                f"launch {i}", _bl(got) + ([ek] if ek is not None else []),
                _bl(want) + ([ep] if ep is not None else [])))
            n += 1
        out, ob, off, lim, em = kept[-1]
        K, B = out.ts.shape
        res, a = S.order_slot_args(out, ob, off, lim, None)
        ms = cuda_ms(lambda: lib.order_by(a, stream), reps=5, warmup=1)
        plain_ms = cuda_ms(lambda: S.shape_chunk_slots_ref(out, ob, off,
                                                           lim),
                           reps=3, warmup=1)
        words = [S.sort_key(out.cols[c], d == "desc") for c, d in ob]
        dead = (~out.valid).to(torch.uint8)

        def library():
            perm = None
            for w in reversed(words + [dead]):
                w = w if perm is None else w.gather(1, perm)
                p = torch.sort(w, dim=1, stable=True).indices
                perm = p if perm is None else perm.gather(1, p)
            return [x.gather(1, perm) for x in _bl(out)]
        lib_ms = cuda_ms(library, reps=3, warmup=1)
        n_bytes = _slot_bytes(out) + _nbytes(_bl(res))
        bound, by = bound_of(n_bytes, 0)
        sort_bytes = len(ob) * K * B * 2 * (8 + 4)
        sort_ms, _by = bound_of(sort_bytes, 0)
        branch = "global memory" if a.k1 else "shared memory"
        print(f"{what}: order_by[K] {ob} offset {off} limit {lim} at "
              f"{[K, B]} ({branch}): {len(kept)} launches bit-equal to the "
              f"plain version over every slot; {ms:.4f} ms a launch, plain "
              f"version {plain_ms:.3f} ms, chained torch.sort(dim=1, "
              f"stable=True) and the gathers {lib_ms:.4f} ms, bound "
              f"{bound:.5f} ms ({by}; {n_bytes} bytes); the sort's own "
              f"traffic (a key word and a row index a row a key, read and "
              f"written once) {sort_ms:.5f} ms more ({sort_bytes} bytes)",
              flush=True)
        r = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
             "bound_by": by, "library_ms": lib_ms, "shape": [K, B],
             "branch": branch, "sort_ms": sort_ms}
        if row is None or ms > row["ms"]:
            row = r
        del res, a
    cap.kept.clear()
    gc.collect()
    row.update(err=err, checked=n)
    return row


def partition_top_phase(dev, card: str) -> dict:
    """partition_top: checks.PARTITION_TOP_APP (each ticker's three best
    trades of every lengthBatch(16), its running averages over
    length(32) ordered after K6[K], ``limit 2 offset 1``, ``output last
    every 5 sec`` on its port) at ``@slots`` WIN_SLOTS (1,024),
    trades_feed's 512 symbols, TOP_SENDS sends of TOP_SEND; order_by[K]
    twice a send.
    Sampled symbols against a block of their ranges
    (_block_against_separate), the first G[K] launches of both queries
    against the plain version over every slot (_order_checks)."""
    from siddhi_tpu_torch import checks as C
    from siddhi_tpu_torch.core.types import GLOBAL_STRINGS
    N = TOP_SENDS * TOP_SEND
    feed = C.trades_feed(N + 4 * TOP_SEND, GLOBAL_STRINGS.encode, TOP_SYMS)
    text = C.PARTITION_TOP_APP
    stream = text.split("@slots", 1)[0]
    r = _block_against_separate(
        "partition_top", "Trades", stream, "symbol", _block_queries(text),
        ("top3", "avg"), feed, TOP_SENDS, TOP_SEND, card,
        (("order_by[K]", 2 * TOP_SENDS), ("aggregate_step[K]", TOP_SENDS)),
        capture=_OrderCapture(),
        check=lambda cap: {"G": _order_checks(cap, "partition_top")})
    return r


def pool_radar_phase(dev, card: str) -> dict:
    """pool_radar: checks.POOL_RADAR_TEMPLATE (pol2Cart, then the eight
    highest returns by cartZ desc, id; the four farthest of length(64)
    with max(rho), a ``${min_rho}`` gate before each) for RADAR_TENANTS
    tenants, each its own gate (pool_radar_bindings), RADAR_ROWS rows of
    radar_feed a tenant a round, RADAR_ROUNDS rounds, batch_max 1,024;
    order_by[K], K2's parameter loads, K6[K] and C[K] must launch. The
    sampled tenants' rows of both streams equal separate runtimes fed
    the tenant's round chunks, bit for bit; the first G[K] launches of
    both queries against the plain version over every slot."""
    from siddhi_tpu_torch import SiddhiManager, StreamCallback, _kernels
    from siddhi_tpu_torch import checks as C
    from siddhi_tpu_torch.serving import Template, TemplateRegistry
    n = RADAR_TENANTS
    reg = TemplateRegistry(SiddhiManager())
    pool = reg.pool(C.POOL_RADAR_TEMPLATE, slots=n, max_tenants=n,
                    batch_max=POOL_BATCH_MAX, name="pool_radar")
    tids = [f"t{i}" for i in range(n)]
    for i, tid in enumerate(tids):
        pool.add_tenant(tid, C.pool_radar_bindings(i))
    sampled = tids[:: n // WIN_SAMPLED][:WIN_SAMPLED]
    got: dict = {}
    _pool_rows(pool, sampled, got)
    takes = _TakeLog(pool, sampled)
    _kernels.reset_launches()
    rounds: list = []
    t0 = time.perf_counter()
    with _OrderCapture() as cap:
        for r in range(RADAR_ROUNDS):
            for i, tid in enumerate(tids):
                ts, cols = C.radar_feed(RADAR_ROWS, seed=1000 * r + i)
                pool.send(tid, ts + r * RADAR_ROWS, cols)
            _pool_drain(pool, rounds)
    wall = time.perf_counter() - t0
    launches = dict(_kernels.LAUNCHES)
    takes.stop()
    for k in ("order_by[K]", "expr_eval[K]", "aggregate_step[K]",
              "sliding_minmax[K]"):
        if launches[k] == 0:
            fail(f"pool_radar: {k} did not launch on the pool's path "
                 f"({launches})")
    for i, tid in enumerate(sampled):
        text = "@app:playback\n" + Template(
            C.POOL_RADAR_TEMPLATE).instantiate_static(
                C.pool_radar_bindings(tids.index(tid)),
                app_name=f"sep_r{i}")
        sep = SiddhiManager().create_siddhi_app_runtime(text)
        rows = {"Near": [], "Far": []}
        for sid in rows:
            sep.add_callback(sid, StreamCallback(
                lambda evs, sid=sid: rows[sid].extend(
                    (e.timestamp, e.is_expired, tuple(e.data))
                    for e in evs)))
        sep.start()
        for sid, t, c in takes.log[tid]:
            sep.get_input_handler(sid).send_arrays(t, c)
        torch.cuda.synchronize()
        sep.shutdown()
        mine = got.get(tid, [])
        for sid, width in (("Near", 4), ("Far", 3)):
            m = [x for x in mine if len(x[2]) == width]
            if m != rows[sid] or not m:
                fail(f"pool_radar: tenant {tid}'s pooled rows of {sid} "
                     f"({len(m)}) differ from a separate runtime's "
                     f"({len(rows[sid])})")
    eps = RADAR_ROUNDS * n * RADAR_ROWS / wall
    print(f"pool_radar {n} tenants x {RADAR_ROWS} rows a round, batch_max "
          f"{POOL_BATCH_MAX}: {eps:.0f} events/s in {RADAR_ROUNDS} rounds "
          f"({len(rounds)} pumps, p50 "
          f"{float(np.percentile(rounds, 50)):.3f} ms); {len(sampled)} "
          f"sampled tenants equal separate runtimes bit for bit (Near and "
          f"Far); launches {launches}; {card}", flush=True)
    rows = {"G": _order_checks(cap, "pool_radar")}
    pool.shutdown()
    reg.shutdown()
    gc.collect()
    return {"eps": eps, "launches": launches, "rows": rows}


def order_slot_phases(dev, card: str) -> dict:
    """The two G[K] paths, each timed on a line of its own. -> {path:
    result}."""
    out = {}
    for name, fn in (("partition_top", partition_top_phase),
                     ("pool_radar", pool_radar_phase)):
        t0 = time.perf_counter()
        out[name] = fn(dev, card)
        print(f"[{name}: {time.perf_counter() - t0:.1f} s]", flush=True)
    return out


# -- checkpoint and recovery (slice 16): K5c[K] ------------------------------

CKPT_SEND, CKPT_SENDS = 65536, 16              # checkpoint_seq5
CKPT_PART_SEND, CKPT_PART_SENDS = 8192, 128    # checkpoint_partition
CRON_TENANTS, CRON_ROWS, CRON_ROUNDS = 256, 1024, 8
CRON_FAIL_TENANT, CRON_FAIL_ROUND = "t3", 2    # round 3 (0-based 2)
CRON_SAMPLED, CRON_KEPT = 8, 2


def _named(app: str, name: str) -> str:
    """An app text under ``@app:name`` (a restore finds its revisions by
    the app's name)."""
    return f"@app:name('{name}')\n" + app


def _pinned_gbs(n_bytes: int) -> float:
    """A pinned device-to-host ``Tensor.copy_`` of ``n_bytes``: GB/s."""
    src = torch.empty(max(n_bytes, 1), dtype=torch.uint8, device="cuda")
    dst = torch.empty(max(n_bytes, 1), dtype=torch.uint8, pin_memory=True)
    dst.copy_(src, non_blocking=True)
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        dst.copy_(src, non_blocking=True)
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return n_bytes / best / 1e9


def _ckpt_report(what: str, card: str, data: bytes, state_bytes: int,
                 d2h_s: float, persist_ms: float, restore_ms: float) -> dict:
    """Print a checkpoint's sizes and times beside a pinned copy of the
    same bytes. -> its numbers."""
    gbs = state_bytes / d2h_s / 1e9
    pinned = _pinned_gbs(state_bytes)
    print(f"{what}: snapshot {len(data)} bytes ({state_bytes} bytes of "
          f"state arrays); persist {persist_ms:.3f} ms, restore "
          f"{restore_ms:.3f} ms; the state's device-to-host copy "
          f"{gbs:.3f} GB/s, a pinned Tensor.copy_ of as many bytes "
          f"{pinned:.3f} GB/s ({card})", flush=True)
    return {"bytes": len(data), "state_bytes": state_bytes,
            "persist_ms": persist_ms, "restore_ms": restore_ms,
            "d2h_gbs": gbs, "pinned_gbs": pinned}


def _app_checkpoint(what: str, app: str, stream: str, qname: str,
                    sends: list, cut: int, card: str, tmp: str,
                    need: tuple) -> dict:
    """One app's checkpoint path on the card: an uninterrupted runtime
    takes every send; another takes ``sends[:cut]``, persists to a
    FileSystemPersistenceStore under ``tmp`` and shuts down; a fresh
    runtime of the same manager restores the last revision and takes
    the rest. Its output rows (``qname``'s batches) and its whole state
    must equal the uninterrupted runtime's after the cut, bit for bit,
    and each kernel of ``need`` must launch after the restore."""
    from siddhi_tpu_torch import FileSystemPersistenceStore, SiddhiManager
    from siddhi_tpu_torch import _kernels
    from siddhi_tpu_torch import checks as C
    from siddhi_tpu_torch.core import persistence as P

    def started(rt):
        outs = []
        rt.queries[qname].batch_callbacks.append(outs.append)
        rt.start()
        return outs

    def send(rt, part):
        h = rt.get_input_handler(stream)
        for ts, cols in part:
            h.send_arrays(ts, cols)
        torch.cuda.synchronize()

    t_phase = time.perf_counter()
    ref = SiddhiManager().create_siddhi_app_runtime(app)
    ref_outs = started(ref)
    send(ref, sends[:cut])
    n_cut = len(ref_outs)
    send(ref, sends[cut:])
    want = C.emitted_columns(ref_outs[n_cut:])
    mgr = SiddhiManager()
    mgr.set_persistence_store(FileSystemPersistenceStore(tmp))
    rt = mgr.create_siddhi_app_runtime(app)
    started(rt)
    send(rt, sends[:cut])
    with rt.barrier:
        t0 = time.perf_counter()
        payload = rt._snapshot_locked()
        torch.cuda.synchronize()
        d2h_s = time.perf_counter() - t0
    state_bytes = _host_bytes(P.to_host(payload))
    t0 = time.perf_counter()
    rev = rt.persist()
    persist_ms = (time.perf_counter() - t0) * 1e3
    data = mgr.persistence_store.load(rt.name, rev)
    rt.shutdown()
    rt2 = mgr.create_siddhi_app_runtime(app)
    outs = started(rt2)
    t0 = time.perf_counter()
    if rt2.restore_last_revision() != rev:
        fail(f"{what}: restore_last_revision did not find {rev}")
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    _kernels.reset_launches()
    send(rt2, sends[cut:])
    launches = dict(_kernels.LAUNCHES)
    for k in need:
        if launches[k] == 0:
            fail(f"{what}: {k} did not launch after the restore "
                 f"({launches})")
    got = C.emitted_columns(outs)
    if len(got[0]) != len(want[0]) or not len(got[0]):
        fail(f"{what}: {len(got[0])} rows after the restore, the "
             f"uninterrupted run {len(want[0])}")
    compare(f"{what} rows", [torch.from_numpy(x) for x in
                             [got[0]] + got[1] + got[2]],
            [torch.from_numpy(x) for x in [want[0]] + want[1] + want[2]])
    a = P.to_host(rt2._snapshot_locked())
    b = P.to_host(ref._snapshot_locked())
    for k in ("queries", "partitions"):
        compare(f"{what} {k} state",
                [torch.as_tensor(x) for x in _np_leaves(a[k])],
                [torch.as_tensor(x) for x in _np_leaves(b[k])])
    for r in (rt2, ref):
        r.shutdown()
    res = _ckpt_report(what, card, data, state_bytes, d2h_s, persist_ms,
                       restore_ms)
    res.update(launches=launches, rows=len(got[0]),
               seconds=time.perf_counter() - t_phase)
    print(f"{what}: {len(sends)} sends, persisted after send {cut}; "
          f"the restored runtime's {len(got[0])} rows of sends "
          f"{cut + 1}-{len(sends)} and its whole state equal the "
          f"uninterrupted run's bit for bit; launches after the restore "
          f"{ {k: launches[k] for k in need} } ({card})", flush=True)
    print(f"[{what}: {res['seconds']:.1f} s]", flush=True)
    return res


def _host_bytes(tree) -> int:
    """The bytes of every numpy array of a host payload."""
    return sum(int(x.nbytes) for x in _np_leaves(tree))


def _np_leaves(tree) -> list:
    """The numpy arrays of a host payload, in a fixed order (floats
    compared by their bits by ``compare``)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _np_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _np_leaves(v)]
    return [tree] if isinstance(tree, np.ndarray) else []


def checkpoint_seq5_phase(dev, card: str, tmp: str) -> dict:
    """checkpoint_seq5: seq5 (checks.SEQ5_APP, the north star),
    1,048,576 events of the bench feed in 16 sends of 65,536, persisted
    after send 8 and restored into a fresh runtime for sends 9-16; K1,
    K2 and K3 must launch after the restore."""
    from siddhi_tpu_torch import checks as C
    from siddhi_tpu_torch.core.types import GLOBAL_STRINGS
    feed = C.Seq5Feed(GLOBAL_STRINGS.encode, seed=21)
    sends = [feed.next(CKPT_SEND) for _ in range(CKPT_SENDS)]
    return _app_checkpoint(
        "checkpoint_seq5", _named(C.SEQ5_APP, "checkpoint_seq5"), "T", "q",
        sends, CKPT_SENDS // 2, card, tmp,
        ("unpack_packed", "expr_eval", "nfa_parallel"))


def checkpoint_partition_phase(dev, card: str, tmp: str) -> dict:
    """checkpoint_partition: partition_avg (checks.PARTITION_AVG_APP,
    1,024 slots, trades_feed's 512 symbols), 128 sends of 8,192,
    persisted after send 64 and restored for sends 65-128; K9p's route
    and compaction, K5[K] and K6[K] must launch after the restore."""
    from siddhi_tpu_torch import checks as C
    from siddhi_tpu_torch.core.types import GLOBAL_STRINGS
    n = CKPT_PART_SEND * CKPT_PART_SENDS
    ts, cols = _avg_feed(n, GLOBAL_STRINGS.encode)
    sends = [(ts[s:s + CKPT_PART_SEND], [c[s:s + CKPT_PART_SEND]
                                         for c in cols])
             for s in range(0, n, CKPT_PART_SEND)]
    return _app_checkpoint(
        "checkpoint_partition",
        _named(C.PARTITION_AVG_APP, "checkpoint_partition"), "StockStream",
        "q", sends, CKPT_PART_SENDS // 2, card, tmp,
        ("partition_route", "partition_compact", "window_step[K]",
         "aggregate_step[K]", "aggregate_emit[K]"))


class _CronCapture:
    """While installed, keeps the arguments of the first ``CRON_KEPT``
    K5c[K] steps of the pool: K5's cron kind over the slot axis
    (ops/windows.py window_step on a CronWindowOp and a [K, B] batch)."""

    def __init__(self):
        from siddhi_tpu_torch.ops import windows as W
        self.mod, self.kept = W, []

    def __enter__(self):
        from siddhi_tpu_torch.ops.windows2 import CronWindowOp
        self.orig = self.mod.window_step

        def wrap(op, state, batch, now):
            if isinstance(op, CronWindowOp) and batch.ts.dim() == 2 and \
                    len(self.kept) < CRON_KEPT:
                self.kept.append((op, state, batch, now))
            return self.orig(op, state, batch, now)
        self.mod.window_step = wrap
        return self

    def __exit__(self, *exc):
        self.mod.window_step = self.orig
        return False


def _k5ck_check(kept, card: str) -> dict:
    """Each kept K5c[K] step launched again on its own arguments (a step
    leaves its arguments as they were) and held against the plain
    version over every slot, tolerance 0; then the firing branch, which
    a pool never runs: from the first kept step, a TIMER row in every
    other slot, expired rows on and off, two firings in a row (the
    second emits the first one's rotated buffer as EXPIRED), each held
    the same way. The first kept step is timed against the plain
    version and the bytes the step must move."""
    import copy
    from siddhi_tpu_torch.core.event import EXPIRED, TIMER, EventBatch
    from siddhi_tpu_torch.ops import windows as W
    from siddhi_tpu_torch.ops import windows2 as W2

    def flat(x):
        return tree_leaves(x[0]) + [x[1].ts, x[1].kind, x[1].valid] + \
            list(x[1].cols) + list(x[1].nulls)
    err = 0.0
    for i, (op, st, b, now) in enumerate(kept):
        err = max(err, compare(f"K5c[K] step {i}",
                               flat(W.window_step(op, st, b, now)),
                               flat(W2.cron_slots_ref(op, st, b, now))))
    op, st, b, now = kept[0]
    kind, valid = b.kind.clone(), b.valid.clone()
    kind[::2, 0], valid[::2, 0] = TIMER, True
    fb = EventBatch(b.ts, b.cols, b.nulls, kind, valid)
    n_fired = n_exp = 0
    for expired in (True, False):
        fop = copy.copy(op)
        fop.expired_enabled = expired
        s_ = st
        for j in range(2):
            got = W.window_step(fop, s_, fb, now)
            want = W2.cron_slots_ref(fop, s_, fb, now)
            err = max(err, compare(
                f"K5c[K] firing {j} (expired {'on' if expired else 'off'})",
                flat(got), flat(want)))
            n_fired += int(want[1].valid.any(1).sum())
            n_exp += int((want[1].valid & (want[1].kind == EXPIRED)).sum())
            s_ = got[0]
    if n_fired == 0 or n_exp == 0:
        fail(f"K5c[K]: the firing steps emitted {n_fired} slots' rows and "
             f"{n_exp} EXPIRED rows")
    from siddhi_tpu_torch import _kernels
    K, B = b.ts.shape
    W_ = op.cap
    # the launch alone, its arguments built once (a step writes fresh
    # tensors and leaves its inputs as they were)
    _new, _out, args = W.window_args(
        op, st, b, torch.as_tensor(now, dtype=torch.int64, device=b.ts.device))
    lib = _kernels.load()
    stream = torch.cuda.current_stream().cuda_stream
    for _ in range(3):
        lib.window_step(args, stream)
    ms = _launch_ms(lambda: None, lambda: lib.window_step(args, stream), 20)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        W2.cron_slots_ref(op, st, b, now)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) / 3 * 1e3
    col = sum(c[0, 0].element_size() for c in b.cols)
    nc = len(b.cols)
    buf_row = 8 + 8 + col + nc + 1          # ts, seq, cols, nulls, valid
    out_row = 8 + col + nc + 4 + 1          # ts, cols, nulls, kind, valid
    n_bytes = K * (2 * W_ * buf_row + B * out_row + 16      # read
                   + 2 * W_ * buf_row + 2 * W_ * out_row + 16)   # written
    bound_ms, bound_by = bound_of(n_bytes, 0)
    print(f"K5c[K] at pool_cron's shape ({K} slots, [{K}, {B}] batch, "
          f"[{K}, {W_}] buffers): {ms:.4f} ms, plain version "
          f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}; "
          f"{n_bytes} bytes); {len(kept)} captured steps and 4 firing "
          f"steps ({n_fired} slots' outputs, {n_exp} EXPIRED rows) equal "
          f"the plain version over every slot, tolerance 0 ({card})",
          flush=True)
    return {"err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def pool_cron_phase(dev, card: str, tmp: str) -> dict:
    """pool_cron: checks.POOL_CRON_TEMPLATE (a cron window behind each
    tenant's filter, never fired in a pool, and a grouped
    lengthBatch(256) sum), 256 tenants x 1,024 rows a round, batch_max
    1,024, 8 rounds. A PoolCheckpointSupervisor(interval_rounds=4)
    persists after round 4; tenant t3's callback raises in round 3. The
    pool is dropped; a fresh pool of the same template and manager
    deploys the tenants and callbacks and ``recover``s (restore, then
    the replay of t3's partition), then takes rounds 5-8. Held: every
    tenant's rows of rounds 5-8, the stacked states and emitted
    counters equal an uninterrupted pool's bit for bit; the replayed
    rows equal the uninterrupted pool's rows of the failed round, in
    timestamp order; each cron buffer equals the numpy oracle; no cron
    row is delivered; 8 sampled tenants' Out rows equal separate
    runtimes'; the first K5c[K] launches, and firing steps made from
    them, against the plain version over every slot, then timed."""
    from siddhi_tpu_torch import (FileSystemPersistenceStore,
                                  InMemoryErrorStore,
                                  PoolCheckpointSupervisor, SiddhiManager,
                                  _kernels)
    from siddhi_tpu_torch import checks as C
    from siddhi_tpu_torch.core import persistence as P
    from siddhi_tpu_torch.serving import TemplateRegistry, TenantPool
    t_phase = time.perf_counter()
    n = CRON_TENANTS
    tids = [f"t{i}" for i in range(n)]
    feeds = {tid: [C.pool_cron_feed(CRON_ROWS, seed=7 * i + r,
                                    t0=C.TS0 + r * CRON_ROWS)
                   for r in range(CRON_ROUNDS)]
             for i, tid in enumerate(tids)}
    buffered = {}

    def make(mgr, name, rows, fail_once=False):
        tpl = TemplateRegistry(mgr).resolve(C.POOL_CRON_TEMPLATE)
        pool = TenantPool(tpl, manager=mgr, name=name, slots=n,
                          max_tenants=n, batch_max=CRON_ROWS)
        pool.batch_callbacks.append(lambda term, name=name: buffered.update(
            {name: buffered.get(name, 0) + sum(
                int(o.valid.sum()) for o in term.get("Buffered", ()))}))
        failing = [fail_once]
        for i, tid in enumerate(tids):
            pool.add_tenant(tid, C.pool_cron_bindings(i))

            def cb(evs, tid=tid):
                if tid == CRON_FAIL_TENANT and failing[0] and \
                        pool._rounds == CRON_FAIL_ROUND + 1:
                    failing[0] = False
                    raise RuntimeError("sink down")
                rows.setdefault(tid, []).append(
                    (pool._rounds, [(e.timestamp, e.is_expired,
                                     tuple(e.data)) for e in evs]))
            pool.add_callback(tid, cb)
        return pool

    def round_(pool, r):
        for tid in tids:
            pool.send(tid, *feeds[tid][r])
        if pool.pump() != n * CRON_ROWS:
            fail("pool_cron: a round did not take every tenant's rows")
        torch.cuda.synchronize()

    # the uninterrupted pool, its sampled tenants' round chunks kept
    u_rows: dict = {}
    upool = make(SiddhiManager(), "pool_cron_u", u_rows)
    sampled = tids[:: n // CRON_SAMPLED][:CRON_SAMPLED]
    takes = _TakeLog(upool, sampled)
    for r in range(CRON_ROUNDS):
        round_(upool, r)
    takes.stop()
    # the pool that crashes after round 4
    mgr = SiddhiManager()
    mgr.set_persistence_store(FileSystemPersistenceStore(tmp))
    mgr.set_error_store(InMemoryErrorStore())
    a_rows: dict = {}
    apool = make(mgr, "pool_cron", a_rows, fail_once=True)
    sup = PoolCheckpointSupervisor(apool, interval_rounds=4)
    for r in range(4):
        round_(apool, r)
    if sup.checkpoints != 1 or sup.failures:
        fail(f"pool_cron: {sup.checkpoints} checkpoints, {sup.failures} "
             "failures after 4 rounds")
    failed = mgr.error_store.peek(apool.tenant_partition(CRON_FAIL_TENANT))
    if len(failed) != 1:
        fail(f"pool_cron: {len(failed)} error records for "
             f"{CRON_FAIL_TENANT}")
    t0 = time.perf_counter()
    payload = apool._snapshot_payload()
    host = P.to_host(payload)
    d2h_s = time.perf_counter() - t0
    state_bytes = _host_bytes(host)
    t0 = time.perf_counter()
    rev = apool.persist()
    persist_ms = (time.perf_counter() - t0) * 1e3
    data = mgr.persistence_store.load(apool.name, rev)
    apool.shutdown()
    del apool, payload, host
    gc.collect()
    # the fresh pool: tenants and callbacks first, then recover
    b_rows: dict = {}
    bpool = make(mgr, "pool_cron", b_rows)
    t0 = time.perf_counter()
    restored, replayed = PoolCheckpointSupervisor(bpool).recover()
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    if restored != rev or bpool._rounds != 4:
        fail(f"pool_cron: recover restored {restored} at round "
             f"{bpool._rounds}")
    rep = [row for _r, rs in b_rows.get(CRON_FAIL_TENANT, []) for row in rs]
    want_rep = sorted((row for r, rs in u_rows[CRON_FAIL_TENANT]
                       if r == CRON_FAIL_ROUND + 1 for row in rs),
                      key=lambda x: x[0])
    if replayed != len(want_rep) or rep != want_rep or not rep:
        fail(f"pool_cron: {replayed} replayed rows of {CRON_FAIL_TENANT}, "
             f"the failed round had {len(want_rep)}")
    b_rows.clear()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    with _CronCapture() as cap:
        for r in range(4, CRON_ROUNDS):
            round_(bpool, r)
    wall = time.perf_counter() - t0
    launches = dict(_kernels.LAUNCHES)
    for k in ("cron_window[K]", "unpack_packed[K]", "expr_eval[K]",
              "window_step[K]", "aggregate_step[K]", "aggregate_emit[K]"):
        if launches[k] == 0:
            fail(f"pool_cron: {k} did not launch after the recovery "
                 f"({launches})")
    for tid in tids:
        mine = [x for _r, rs in b_rows.get(tid, []) for x in rs]
        theirs = [x for r, rs in u_rows.get(tid, []) if r > 4 for x in rs]
        if mine != theirs or not mine:
            fail(f"pool_cron: tenant {tid}'s rows of rounds 5-8 "
                 f"({len(mine)}) differ from the uninterrupted pool's "
                 f"({len(theirs)})")
    for qn in upool._order:
        compare(f"pool_cron {qn} state", tree_leaves(bpool._states[qn]),
                tree_leaves(upool._states[qn]))
        compare(f"pool_cron {qn} emitted", [bpool._emitted[qn]],
                [upool._emitted[qn]])
    if buffered.get("pool_cron_u", 0) or buffered.get("pool_cron", 0):
        fail(f"pool_cron: cron rows delivered {buffered}")
    st = bpool._states["buffered"][1]
    cur = {k: (v.cpu().numpy() if not isinstance(v, tuple)
               else [c.cpu().numpy() for c in v])
           for k, v in st["cur"].items()}
    ovf = st["overflow"].cpu().numpy()
    for i, tid in enumerate(tids):
        slot = bpool._tenants[tid]
        ts = np.concatenate([f[0] for f in feeds[tid]])
        v = np.concatenate([f[1][0] for f in feeds[tid]])
        k = np.concatenate([f[1][1] for f in feeds[tid]])
        wts, wseq, wv, wk, wovf = C.cron_buffer_oracle(
            ts, v, k, C.pool_cron_bindings(i)["lo"], 4096)
        if not (cur["valid"][slot].all()
                and np.array_equal(cur["ts"][slot], wts)
                and np.array_equal(cur["seq"][slot], wseq)
                and np.array_equal(cur["cols"][0][slot].view(np.int64),
                                   wv.view(np.int64))
                and np.array_equal(cur["cols"][1][slot], wk)
                and int(ovf[slot]) == wovf):
            fail(f"pool_cron: tenant {tid}'s cron buffer differs from the "
                 f"oracle (overflow {int(ovf[slot])}, the oracle {wovf})")
    for tid in sampled:
        i = tids.index(tid)
        chunks = takes.log[tid]
        mine = [x for _r, rs in u_rows[tid] for x in rs]
        theirs = _separate_rows(C.POOL_CRON_TEMPLATE,
                                C.pool_cron_bindings(i), chunks,
                                f"sep_cron{i}")
        if mine != theirs or not mine:
            fail(f"pool_cron: tenant {tid}'s Out rows ({len(mine)}) differ "
                 f"from a separate runtime's ({len(theirs)})")
    eps = (CRON_ROUNDS - 4) * n * CRON_ROWS / wall
    ovf_min = int(ovf.min())
    print(f"pool_cron {n} tenants x {CRON_ROWS} rows a round, batch_max "
          f"{CRON_ROWS}: recovered at round 4 onto a fresh pool "
          f"({replayed} rows of {CRON_FAIL_TENANT}'s failed round replayed "
          f"in timestamp order), rounds 5-8 at {eps:.0f} events/s; every "
          f"tenant's rows, states and emitted counters equal the "
          f"uninterrupted pool's bit for bit; every cron buffer equals the "
          f"oracle (overflow at least {ovf_min} a tenant), no cron row "
          f"delivered; {len(sampled)} sampled tenants equal separate "
          f"runtimes; launches after the recovery "
          f"{ {k: v for k, v in launches.items() if v} } ({card})",
          flush=True)
    res = _ckpt_report("pool_cron", card, data, state_bytes, d2h_s,
                       persist_ms, restore_ms)
    res.update(launches=launches, eps=eps,
               k5ck=_k5ck_check(cap.kept, card))
    for pool in (upool, bpool):
        pool.shutdown()
    gc.collect()
    res["seconds"] = time.perf_counter() - t_phase
    print(f"[pool_cron: {res['seconds']:.1f} s]", flush=True)
    return res


def checkpoint_phases(dev, card: str) -> dict:
    """The three checkpoint paths, each persisting to a
    FileSystemPersistenceStore in a temporary directory of its own."""
    import tempfile
    out = {}
    for name, fn in (("checkpoint_seq5", checkpoint_seq5_phase),
                     ("checkpoint_partition", checkpoint_partition_phase),
                     ("pool_cron", pool_cron_phase)):
        with tempfile.TemporaryDirectory(prefix=f"{name}_") as tmp:
            out[name] = fn(dev, card, tmp)
    return out


def main() -> None:
    # -- 1. device ---------------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a "
             "CUDA card")
    from siddhi_tpu_torch import SiddhiManager, StreamCallback, _kernels
    from siddhi_tpu_torch.checks import (EXPR_SCHEMA, EXPR_STRINGS,
                                         FILTER_APP, INGEST_SPANS,
                                         INGEST_TYPES, expr_cases,
                                         expr_columns, filter_cases,
                                         filter_feed, function_cases,
                                         function_columns, ingest_chunk)
    from siddhi_tpu_torch.core.event import (Attribute, EventBatch,
                                             StreamSchema, rows_from_batch)
    from siddhi_tpu_torch.core.ingest import (PackedEncoder, layout,
                                              unpack_packed,
                                              unpack_packed_ref,
                                              unpack_params)
    from siddhi_tpu_torch.core.types import GLOBAL_STRINGS
    from siddhi_tpu_torch.lang.parser import parse_expression
    from siddhi_tpu_torch.ops.expr import (ProgramBuilder, SingleStreamScope,
                                           compile_expression, expr_eval,
                                           expr_eval_ref, expr_params)

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0].strip() if smi else f"{name}, power limit not read"
    print(f"device: {name} x{torch.cuda.device_count()}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}; {card}",
          flush=True)

    if "--k5-time" in sys.argv[1:]:   # K5 alone, for comparing trees
        _kernels.load()
        print(json.dumps({"k5_ms": k5_time(dev), "card": card}), flush=True)
        return
    if "--h-time" in sys.argv[1:]:   # H alone, for comparing trees
        _kernels.load()
        print(json.dumps({"h_ms": h_time(dev, card), "card": card}),
              flush=True)
        return

    # the group tables hash dictionary codes, and a table of 1,024 slots
    # places 512 keys within its 16 probes for most code ranges but not
    # all: the run interns the symbols of its two grouped 512-key paths
    # first (window_ext_*'s, then window_time_grouped's), so that their
    # codes, and the probes, do not depend on the order of the phases
    # (and the keyed paths' cards and users, after them)
    from siddhi_tpu_torch.checks import (FRAUD_CARDS, FRAUD_TXN_CARDS,
                                         SESSION_USERS, card_symbols,
                                         time_symbols, user_symbols)
    for sym in time_symbols(512, "T") + time_symbols(1500, "K") + \
            user_symbols(SESSION_USERS) + card_symbols(FRAUD_CARDS) + \
            card_symbols(FRAUD_TXN_CARDS, "TX") + \
            [f"CU{i:05d}" for i in range(1024)] + \
            [f"TR{i:02d}" for i in range(64)]:
        GLOBAL_STRINGS.encode(sym)

    _mark("2.")
    # -- 2. build, then K1 against its plain version -------------------------
    t0 = time.perf_counter()
    _kernels.load(verbose=True)
    print(f"kernels built in {time.perf_counter() - t0:.1f} s", flush=True)

    k1_err = 0.0
    rng = np.random.default_rng(11)
    for capacity in (16, 1024, 65536):
        for case in INGEST_SPANS:
            n = capacity - 3
            ts, cols = ingest_chunk(case, n, rng)
            schema = StreamSchema("S", tuple(
                Attribute(f"a{i}", t) for i, t in enumerate(INGEST_TYPES)))
            buf, enc, _n = PackedEncoder(schema).encode(ts, cols, capacity,
                                                        now=int(ts[-1]))
            want_codes = (INGEST_SPANS[case][0],)
            if enc[:1] != want_codes:
                fail(f"K1 case {case}: encoder chose {enc}")
            d = torch.from_numpy(buf).to(dev)
            got, _ = unpack_packed(INGEST_TYPES, enc, capacity, d)
            ref, _ = unpack_packed_ref(INGEST_TYPES, enc, capacity, d)
            k1_err = max(k1_err, compare(
                f"K1 {case}@{capacity} {enc}",
                [got.ts, *got.cols, *got.nulls, got.kind, got.valid],
                [ref.ts, *ref.cols, *ref.nulls, ref.kind, ref.valid]))
    torch.cuda.synchronize()
    print(f"K1 unpack_packed: bit-equal to its plain version for lane "
          f"cases {sorted(INGEST_SPANS)} at capacities 16/1024/65536",
          flush=True)

    _mark("3.")
    # -- 3. K2 against its plain version ---------------------------------------
    schema = StreamSchema("S", tuple(Attribute(n, t) for n, t in EXPR_SCHEMA))
    scope = SingleStreamScope(schema)
    codes = np.array([GLOBAL_STRINGS.encode(s) for s in EXPR_STRINGS],
                     np.int32)
    B = 65536
    cols, nulls, kind, valid = expr_columns(B, seed=5)
    cols = [codes[c] if t.value == "string" else c
            for c, (_n, t) in zip(cols, EXPR_SCHEMA)]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    batch = EventBatch(ts=t(np.arange(B, dtype=np.int64)),
                       cols=[t(c) for c in cols], nulls=[t(n) for n in nulls],
                       kind=t(kind), valid=t(valid))
    exprs = [compile_expression(parse_expression(e), scope)
             for e in expr_cases()]
    conds = [compile_expression(parse_expression(e), scope)
             for e in filter_cases()]
    k2_err, n_progs = 0.0, 0
    for k in range(0, len(exprs), 24):
        for gate in (0b0001, 0b0011, 0b1111):
            b = ProgramBuilder()
            b.keep(conds[(k // 24) % len(conds)])
            b.timer_pass = gate == 0b1111
            for ce in exprs[k:k + 24]:
                b.out(ce)
            b.gate_bits = gate
            prog = b.build()
            em_k = torch.zeros((), dtype=torch.int64, device=dev)
            em_r = torch.zeros((), dtype=torch.int64, device=dev)
            kc, kn, kv = expr_eval(prog, batch, em_k)
            rc, rn, rv = expr_eval_ref(prog, batch, em_r)
            k2_err = max(k2_err, compare(
                f"K2 program {k}/{gate:#06b}", [*kc, *kn, kv, em_k],
                [*rc, *rn, rv, em_r]))
            n_progs += 1
    for cond in conds:
        b = ProgramBuilder()
        b.keep(cond)
        b.timer_pass = True
        prog = b.build()
        k2_err = max(k2_err, compare(
            "K2 filter", [expr_eval(prog, batch)[2]],
            [expr_eval_ref(prog, batch)[2]]))
        n_progs += 1
    # the function calls (slice 8), twelve a program, over columns with
    # subnormals among the traps
    fcols, fnulls, fkind, fvalid = function_columns(B, seed=6)
    fcols = [codes[c] if t.value == "string" else c
             for c, (_n, t) in zip(fcols, EXPR_SCHEMA)]
    fbatch = EventBatch(ts=t(np.arange(B, dtype=np.int64)),
                        cols=[t(c) for c in fcols],
                        nulls=[t(n) for n in fnulls], kind=t(fkind),
                        valid=t(fvalid))
    fexprs = [compile_expression(parse_expression(e), scope)
              for e in function_cases()]
    k2_ulp = 0
    for k in range(0, len(fexprs), 12):
        b = ProgramBuilder()
        b.keep(conds[(k // 12) % len(conds)])
        for ce in fexprs[k:k + 12]:
            b.out(ce)
        prog = b.build()
        em_k = torch.zeros((), dtype=torch.int64, device=dev)
        em_r = torch.zeros((), dtype=torch.int64, device=dev)
        kc, kn, kv = expr_eval(prog, fbatch, em_k)
        rc, rn, rv = expr_eval_ref(prog, fbatch, em_r)
        err, gap = compare_ulp(f"K2 function program {k}",
                               [*kc, *kn, kv, em_k], [*rc, *rn, rv, em_r],
                               library_program(prog))
        k2_err, k2_ulp = max(k2_err, err), max(k2_ulp, gap)
        n_progs += 1
    torch.cuda.synchronize()
    print(f"K2 expr_eval: bit-equal to its plain version over "
          f"{len(exprs)} expressions, {len(conds)} filters and "
          f"{len(fexprs)} function calls (math-library functions within "
          f"{k2_ulp} ulp; {n_progs} programs, {B} rows)", flush=True)

    _mark("4.")
    # -- 4. the filter app through the public API, on the card -------------------
    N, SEND = 1 << 20, 65536
    ts, feed = filter_feed(N, GLOBAL_STRINGS.encode)
    mgr = SiddhiManager()
    rt = mgr.create_siddhi_app_runtime(FILTER_APP)
    got_rows = []
    rt.add_callback("OutputStream",
                    StreamCallback(lambda evs: got_rows.extend(evs)))
    rt.start()
    h = rt.get_input_handler("StockStream")
    q = rt.queries["q"]
    if rt.device.type != "cuda":
        fail(f"the app runtime is on {rt.device}, not the card")
    # warm the allocator and the kernels on one chunk of another app
    warm = mgr.create_siddhi_app_runtime(FILTER_APP.replace("'q'", "'w'"))
    warm.start()
    warm.get_input_handler("StockStream").send_arrays(
        ts[:SEND], [c[:SEND] for c in feed])
    torch.cuda.synchronize()

    _kernels.reset_launches()
    t0 = time.perf_counter()
    for s in range(0, N, SEND):
        h.send_arrays(ts[s:s + SEND], [c[s:s + SEND] for c in feed])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_kernels.LAUNCHES)
    for k in ("unpack_packed", "expr_eval"):
        if launches[k] == 0:
            fail(f"kernel {k} was never launched on the main path")
    keep = feed[1] > np.float32(100.0)
    want_ts = ts[keep]
    if len(got_rows) != int(keep.sum()):
        fail(f"app emitted {len(got_rows)} rows, the oracle {int(keep.sum())}")
    got_ts = np.array([e.timestamp for e in got_rows], np.int64)
    got_price = np.array([e.data[1] for e in got_rows], np.float32)
    got_sym = [e.data[0] for e in got_rows]
    want_sym = [GLOBAL_STRINGS.decode(c) for c in feed[0][keep]]
    if not (np.array_equal(got_ts, want_ts)
            and np.array_equal(got_price.view(np.int32),
                               feed[1][keep].view(np.int32))
            and got_sym == want_sym):
        fail("app rows differ from the numpy oracle")
    stats = q.stats()
    if stats != {"emitted": int(keep.sum()), "overflow": 0}:
        fail(f"stats() {stats} disagree with the oracle")
    eps = N / wall
    print(f"filter app: {N} events in {N // SEND} sends of {SEND}, "
          f"{len(got_rows)} rows match the numpy oracle; {eps:.0f} events/s "
          f"end to end with host row decode ({card})", flush=True)
    print(f"launches on the main path: {launches}", flush=True)

    # device-batch path (no host row decode): same app, batch callback only
    rt2 = mgr.create_siddhi_app_runtime(FILTER_APP.replace("'q'", "'q2'"))
    outs = []
    rt2.queries["q2"].batch_callbacks.append(outs.append)
    rt2.start()
    h2 = rt2.get_input_handler("StockStream")
    h2.send_arrays(ts[:SEND], [c[:SEND] for c in feed])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for s in range(0, N, SEND):
        h2.send_arrays(ts[s:s + SEND], [c[s:s + SEND] for c in feed])
    torch.cuda.synchronize()
    eps_dev = N / (time.perf_counter() - t0)
    if rt2.queries["q2"].stats()["emitted"] != \
            int(keep[:SEND].sum()) + int(keep.sum()):
        fail("device-batch path emitted count disagrees with the oracle")
    print(f"filter app, device batches only: {eps_dev:.0f} events/s "
          f"({card})", flush=True)

    # -- kernel times per 65,536-row chunk: the launch alone (arguments
    # built once, outputs reused), then the plain version on the card
    types = h.junction.schema.types
    enc_buf, enc, _ = PackedEncoder(h.junction.schema).encode(
        ts[:SEND], [c[:SEND] for c in feed], SEND, now=int(ts[SEND - 1]))
    dbuf = torch.from_numpy(enc_buf).to(dev)
    saved = dict(_kernels.LAUNCHES)
    chunk, _ = unpack_packed(types, enc, SEND, dbuf)
    prog = q.program
    emitted = torch.zeros((), dtype=torch.int64, device=dev)
    out_cols, out_nulls, out_valid = expr_eval(prog, chunk, emitted)
    # both kernels at the main path's own shapes and program, once more
    # against their plain versions (tolerance 0: bit-equal)
    ref, _ = unpack_packed_ref(types, enc, SEND, dbuf)
    k1_err = max(k1_err, compare(
        "K1 on a filter-app chunk",
        [chunk.ts, *chunk.cols, *chunk.nulls, chunk.kind, chunk.valid],
        [ref.ts, *ref.cols, *ref.nulls, ref.kind, ref.valid]))
    em_ref = torch.zeros((), dtype=torch.int64, device=dev)
    rc, rn, rv = expr_eval_ref(prog, chunk, em_ref)
    k2_err = max(k2_err, compare(
        "K2 with the filter app's program",
        [*out_cols, *out_nulls, out_valid, emitted], [*rc, *rn, rv, em_ref]))
    print("K1 and K2 at the main path's shapes: bit-equal to their plain "
          "versions (tolerance 0)", flush=True)
    lib = _kernels.load()
    stream = torch.cuda.current_stream().cuda_stream
    p1 = unpack_params(types, enc, SEND, dbuf, chunk)
    p2 = expr_params(prog, chunk, out_cols, out_nulls, out_valid, emitted)
    k1_ms = cuda_ms(lambda: lib.unpack_packed(p1, stream), reps=200)
    k2_ms = cuda_ms(lambda: lib.expr_eval(p2, stream), reps=200)
    k1_plain = cuda_ms(lambda: unpack_packed_ref(types, enc, SEND, dbuf),
                       reps=20)
    k2_plain = cuda_ms(lambda: expr_eval_ref(prog, chunk, None), reps=20)

    # host side of one chunk, for the same 65,536 rows: encode, copy to
    # the card, and the decode of the output rows for the callback
    def host_ms(fn, reps=10):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    enc_ms = host_ms(lambda: PackedEncoder(h.junction.schema).encode(
        ts[:SEND], [c[:SEND] for c in feed], SEND, now=int(ts[SEND - 1])))
    h2d_ms = host_ms(lambda: torch.from_numpy(enc_buf).to(dev))
    out_batch = q._chain((), emitted, chunk, 0)[1]
    dec_ms = host_ms(lambda: rows_from_batch(q.out_schema.types, out_batch))
    _kernels.LAUNCHES.update(saved)   # timing launches are not the path's
    print(f"host per {SEND}-row chunk: encode {enc_ms:.3f} ms, copy to "
          f"the card {h2d_ms:.3f} ms, output row decode {dec_ms:.3f} ms "
          f"({card})", flush=True)

    _H, _offs, total = layout(len(types), enc, SEND)
    col_bytes = sum(c.element_size() for c in chunk.cols) * SEND
    k1_bytes = total + SEND * (8 + 1 + 4 + 1) + col_bytes
    in_bytes = sum(chunk.cols[i].element_size() + 1 for i in prog.inputs)
    out_bytes = sum(o.element_size() + 1 for o in out_cols)
    k2_bytes = SEND * (in_bytes + 4 + 1 + out_bytes + 1) + 8
    rows = [
        ("unpack_packed", "siddhi_tpu_torch/csrc/unpack_packed.cu",
         "siddhi_tpu/core/ingest.py:397", k1_err, k1_ms, k1_plain, k1_bytes),
        ("expr_eval", "siddhi_tpu_torch/csrc/expr_eval.cu",
         "siddhi_tpu/ops/expr.py:184", k2_err, k2_ms, k2_plain, k2_bytes),
    ]
    table = []
    for kname, src, repl, err, ms, plain, nbytes in rows:
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        print(f"{kname}: {ms:.5f} ms per {SEND}-row chunk, plain version "
              f"{plain:.4f} ms, bound {bound:.5f} ms ({nbytes} bytes at "
              f"3.35 TB/s); {card}", flush=True)
        table.append({"name": kname, "route": "cuda", "source": src,
                      "replaces": repl, "launches": launches[kname],
                      "max_abs_err": err, "ms": ms, "plain_ms": plain,
                      "bound_ms": bound, "bound_by": "bytes",
                      "library_ms": None})
    rt.shutdown()
    rt2.shutdown()
    warm.shutdown()
    # the filter phase's half a million Event rows would otherwise stay
    # alive, and a full garbage collection over them lands in whichever
    # timed send triggers it
    got_rows.clear()
    del outs, out_batch, rt, rt2, warm
    gc.collect()

    _mark("5.")
    # -- 5. and 6. kernel K3 and seq5 -------------------------------------------
    k3_err = k3_against_plain(dev)
    table.append(seq5_phase(dev, card, k3_err))

    _mark("7.")
    # -- 7. and 8. kernel K4 and absent_timeout -----------------------------------
    k4_err = k4_against_plain(dev)
    table.append(timeout_phase(dev, card, k4_err))

    _mark("9.")
    # -- 9. to 11. kernels K5 and K6, window_agg, window_time_grouped --------
    k56_err = k56_against_plain(dev)
    runs = {w: window_phase(dev, card, w)
            for w in ("window_agg", "window_time_grouped")}
    for kname, src, repl, key in (
            ("window_step", "siddhi_tpu_torch/csrc/window_step.cu",
             "siddhi_tpu/ops/windows.py:113", "k5"),
            ("aggregate_step", "siddhi_tpu_torch/csrc/aggregate_step.cu",
             "siddhi_tpu/ops/aggregators.py:825", "k6")):
        # launches: both new paths; times: window_time_grouped's step
        r = runs["window_time_grouped"]
        table.append({
            "name": kname, "route": "cuda", "source": src, "replaces": repl,
            "launches": sum(x["launches"][kname] for x in runs.values()),
            "max_abs_err": k56_err, "ms": r[f"{key}_ms"],
            "plain_ms": r[f"{key}_plain_ms"], "bound_ms": r[f"{key}_bound_ms"],
            "bound_by": "bytes",
            "library_ms": r["k5_library_ms"] if key == "k5" else None})

    _mark("12.")
    # -- 12. to 16. kernels K7 and K8, the join paths, stock_table ----------
    k78_err = k78_against_plain(dev)
    jr = join_phase(dev, card, "join")
    jq = join_phase(dev, card, "join_eq")
    gr = join_phase(dev, card, "join on the grid", sends=GRID_SENDS,
                    kernel="grid",
                    probe_rows=jr.pop("k7_rows"))
    jq.pop("k7_rows")
    stk = stock_table_phase(dev, card)
    runs = (jr, jq, gr, stk)
    table.append({
        "name": "join_cross", "route": "cuda",
        "source": "siddhi_tpu_torch/csrc/join_cross.cu",
        "replaces": "siddhi_tpu/ops/join.py:421",
        "launches": sum(x["launches"][k] for x in runs
                        for k in ("join_probe", "join_grid")),
        "max_abs_err": k78_err, "ms": jr["k7_ms"],
        "plain_ms": jr["k7_plain_ms"], "bound_ms": jr["k7_bound_ms"],
        "bound_by": jr["k7_bound_by"], "library_ms": jr["k7_library_ms"]})
    table.append({
        "name": "table_step", "route": "cuda",
        "source": "siddhi_tpu_torch/csrc/table_step.cu",
        "replaces": "siddhi_tpu/ops/table.py:72",
        "launches": sum(stk["launches"][k] for k in (
            "table_write", "table_match", "table_probe", "table_buffer")),
        "max_abs_err": k78_err, "ms": stk["k8_ms"],
        "plain_ms": stk["k8_plain_ms"], "bound_ms": stk["k8_bound_ms"],
        "bound_by": stk["k8_bound_by"], "library_ms": stk["k8_library_ms"]})

    _mark("17.")
    # -- 17. to 20. kernels A-D: the second-wave windows and stateful
    # aggregators
    w2_err = wave2_against_plain(dev)
    w2 = {w: wave2_phase(dev, card, w) for w in (
        "window_ext_grouped", "window_ext_bars", "window_sort")}
    ext, bars, srt = (w2[k] for k in ("window_ext_grouped",
                                      "window_ext_bars", "window_sort"))
    table.append({
        "name": "window_step_wave2", "route": "cuda",
        "source": "siddhi_tpu_torch/csrc/window_step.cu",
        "replaces": "siddhi_tpu/ops/windows2.py:85",
        "launches": ext["launches"]["window_step"] +
        bars["launches"]["window_step"],
        "max_abs_err": w2_err, "ms": ext["a_ms"],
        "plain_ms": ext["a_plain_ms"], "bound_ms": ext["a_bound_ms"],
        "bound_by": "bytes", "library_ms": ext["a_library_ms"]})
    table.append({
        "name": "sort_window", "route": "cuda",
        "source": "siddhi_tpu_torch/csrc/window_seq.cu",
        "replaces": "siddhi_tpu/ops/windows2.py:443",
        "launches": srt["launches"]["sort_window"], "max_abs_err": w2_err,
        "ms": srt["b_ms"], "plain_ms": srt["b_plain_ms"],
        "bound_ms": srt["b_bound_ms"], "bound_by": srt["b_bound_by"],
        "library_ms": None})
    for kname, repl, r in (
            ("sliding_minmax", "siddhi_tpu/ops/aggregators.py:511", ext),
            ("distinct_count", "siddhi_tpu/ops/aggregators.py:306", bars)):
        table.append({
            "name": kname, "route": "cuda",
            "source": "siddhi_tpu_torch/csrc/aggregate_step.cu",
            "replaces": repl, "launches": r["launches"][kname],
            "max_abs_err": w2_err, "ms": r["x_ms"],
            "plain_ms": r["x_plain_ms"], "bound_ms": r["x_bound_ms"],
            "bound_by": r["x_bound_by"], "library_ms": None})

    _mark("21.")
    # -- 21. and 22. bench.py's seq2 and kleene on K3 --------------------------
    s2 = seq2_phase(dev, card)
    kl = kleene_phase(dev, card)
    for row in table:
        if row["name"] == "nfa_parallel":   # K3: seq5's, seq2's, kleene's
            row["launches"] += s2["launches"]["nfa_parallel"] + \
                kl["launches"]["nfa_parallel"]

    _mark("23.")
    # -- 23. to 27. kernels E, F and G: window_frequent, window_session,
    # window_top10; bench.py's chain3 and fanout
    keyed_err = keyed_against_plain(dev)
    fq = frequent_phase(dev, card)
    se = session_phase(dev, card)
    tp = top10_phase(dev, card)
    chain_phase(dev, card, "chain3")
    chain_phase(dev, card, "fanout")
    table.append({
        "name": "freq_window", "route": "cuda",
        "source": "siddhi_tpu_torch/csrc/window_seq.cu",
        "replaces": "siddhi_tpu/ops/windows2.py:569",
        "launches": sum(fq[k]["launches"]["freq_window"]
                        for k in ("N=2", "N=64", "lossy")),
        "max_abs_err": keyed_err, "ms": fq["N=2"]["e_ms"],
        "plain_ms": fq["N=2"]["e_plain_ms"],
        "bound_ms": fq["N=2"]["e_bound_ms"],
        "bound_by": fq["N=2"]["e_bound_by"], "library_ms": None})
    table.append({
        "name": "session_window", "route": "cuda",
        "source": "siddhi_tpu_torch/csrc/session_step.cu",
        "replaces": "siddhi_tpu/ops/windows2.py:1168",
        "launches": se["launches"]["session_window"],
        "max_abs_err": keyed_err, "ms": se["f_ms"],
        "plain_ms": se["f_plain_ms"], "bound_ms": se["f_bound_ms"],
        "bound_by": se["f_bound_by"], "library_ms": None})
    table.append({
        "name": "order_by", "route": "cuda",
        "source": "siddhi_tpu_torch/csrc/order_by.cu",
        "replaces": "siddhi_tpu/ops/selector.py:88",
        "launches": sum(tp[k]["launches"]["order_by"]
                        for k in ("top10", "top10 by hi", "hi")),
        "max_abs_err": keyed_err, "ms": tp["hi"]["g_ms"],
        "plain_ms": tp["hi"]["g_plain_ms"], "bound_ms": tp["hi"]["g_bound_ms"],
        "bound_by": tp["hi"]["g_bound_by"],
        "library_ms": tp["hi"]["g_library_ms"]})
    for row in table:   # K2 and K1 ran on every path; K6 on the session's
        if row["name"] == "aggregate_step":
            row["launches"] += se["launches"]["aggregate_step"] + \
                tp["top10"]["launches"]["aggregate_step"] + \
                tp["top10 by hi"]["launches"]["aggregate_step"]

    _mark("28.")
    # -- 28. to 30. slice 8: function calls (K2's new ops), kernel H, set
    # rows through K5 and K6; the functions, polar, distinct_symbols and
    # log paths
    f8 = func_against_plain(dev)
    fn = functions_phase(dev, card)
    po = polar_phase(dev, card)
    ds = distinct_phase(dev, card)
    log_phase(dev, card)
    ds24, ds512 = ds["distinct_symbols 24"], ds["distinct_symbols 512"]
    new_runs = (fn, po, ds24, ds512)
    for row in table:
        if row["name"] == "unpack_packed":
            row["launches"] += sum(r["launches"]["unpack_packed"]
                                   for r in new_runs)
        elif row["name"] == "expr_eval":
            # K2's time is now the functions path's program, on its chunk
            row["launches"] += sum(r["launches"]["expr_eval"]
                                   for r in new_runs)
            row["max_abs_err"] = max(row["max_abs_err"], f8["k2_err"])
            row["max_ulp"] = max(k2_ulp, f8["k2_ulp"])
            row.update(ms=fn["k2_ms"], plain_ms=fn["k2_plain_ms"],
                       bound_ms=fn["k2_bound_ms"],
                       bound_by=fn["k2_bound_by"])
        elif row["name"] == "window_step":
            row["launches"] += ds24["launches"]["window_step"] + \
                ds512["launches"]["window_step"]
        elif row["name"] == "aggregate_step":
            row["launches"] += ds24["launches"]["aggregate_step"] + \
                ds512["launches"]["aggregate_step"]
            row["max_abs_err"] = max(row["max_abs_err"], f8["h_err"])
    table.append({
        "name": "union_set", "route": "cuda",
        "source": "siddhi_tpu_torch/csrc/union_set.cu",
        "replaces": "siddhi_tpu/ops/aggregators.py:413",
        "launches": ds24["launches"]["union_set"] +
        ds512["launches"]["union_set"],
        "max_abs_err": f8["h_err"], "ms": ds512["h_ms"],
        "plain_ms": ds512["h_plain_ms"], "bound_ms": ds512["h_bound_ms"],
        "bound_by": ds512["h_bound_by"],
        "library_ms": ds512["h_library_ms"]})

    _mark("31.")
    # -- 31. to 34. slice 9: partition blocks (K9p; K4, K5 and K6 with the
    # slot axis); partition_avg, partition_fraud and the per-customer
    # absence
    k9_err = partition_against_plain(dev)
    pa = partition_avg_phase(dev, card)
    pf = partition_fraud_phase(dev, card)
    k9 = pa["k9"]
    part_err = max(k9_err, pa["err"], pf["err"])
    part_runs = (pa["launches"], pf["launches"], pf["absent_launches"])

    def part_launches(*names):
        return sum(r[k] for r in part_runs for k in names)
    for row in table:
        if row["name"] == "expr_eval":
            row["launches"] += part_launches("expr_eval")
    table.append({
        "name": "partition", "route": "cuda",
        "source": "siddhi_tpu_torch/csrc/partition.cu",
        "replaces": "siddhi_tpu/parallel/partition.py:332",
        "launches": part_launches("partition_route", "partition_compact",
                                  "partition_due"),
        "max_abs_err": part_err, "ms": k9["ms"] + pf["due_ms"],
        "plain_ms": k9["plain_ms"] + pf["due_plain_ms"],
        "bound_ms": k9["bound_ms"], "bound_by": k9["bound_by"],
        "library_ms": k9["library_ms"]})
    for kname, src, repl, pre, r in (
            ("nfa_scan[K]", "siddhi_tpu_torch/csrc/nfa_scan.cu",
             "siddhi_tpu/ops/nfa.py:638", "k4", pf),
            ("window_step[K]", "siddhi_tpu_torch/csrc/window_step.cu",
             "siddhi_tpu/ops/windows.py:113", "k5", pa),
            ("aggregate_step[K]", "siddhi_tpu_torch/csrc/aggregate_step.cu",
             "siddhi_tpu/ops/aggregators.py:825", "k6", pa),
            ("aggregate_emit[K]", "siddhi_tpu_torch/csrc/aggregate_step.cu",
             "siddhi_tpu/ops/aggregators.py:825", "emit", pa)):
        table.append({
            "name": kname, "route": "cuda", "source": src, "replaces": repl,
            "launches": part_launches(kname),
            "max_abs_err": part_err, "ms": r[f"{pre}_ms"],
            "plain_ms": r[f"{pre}_plain_ms"],
            "bound_ms": r[f"{pre}_bound_ms"],
            "bound_by": r[f"{pre}_bound_by"],
            "library_ms": r.get(f"{pre}_library_ms")})

    _mark("36.")
    # -- 36. to 38. slice 10: incremental aggregation (kernel K11) and
    # named windows; aggregation_trades and window_named
    k11_err = aggregation_against_plain(dev)
    ag = aggregation_phase(dev, card)
    wn = window_named_phase(dev, card)
    for row in table:   # K1, K2, K5 and K6 ran on the named-window path
        kname = {"unpack_packed": "unpack_packed",
                 "expr_eval": "expr_eval", "window_step": "window_step",
                 "aggregate_step": "aggregate_step"}.get(row["name"])
        if kname is not None:
            row["launches"] += wn["launches"][kname]
        if kname in ("window_step", "aggregate_step"):
            row["max_abs_err"] = max(row["max_abs_err"], wn["err"])
    table.append({
        "name": "aggregation_step", "route": "cuda",
        "source": "siddhi_tpu_torch/csrc/aggregation_step.cu",
        "replaces": "siddhi_tpu/core/aggregation.py:248",
        "launches": ag["launches"]["aggregation_step"],
        "max_abs_err": max(k11_err, ag["err"]), "ms": ag["k11_ms"],
        "plain_ms": ag["k11_plain_ms"], "bound_ms": ag["k11_bound_ms"],
        "bound_by": ag["k11_bound_by"],
        "library_ms": ag["k11_library_ms"]})

    _mark("40.")
    # -- 40. to 42. slice 11: event time and schedules (kernels K10 and
    # K5c); cron_trades and watermark_sensors
    et_err = event_time_against_plain(dev)
    ct = cron_trades_phase(dev, card)
    ws = watermark_sensors_phase(dev, card)
    for row in table:   # K1, K2, K5 and K6 ran on the new paths
        kname = row["name"]
        if kname in ("unpack_packed", "expr_eval", "window_step",
                     "aggregate_step"):
            row["launches"] += ct["launches"][kname] + \
                ws["launches"][kname]
    table.append({
        "name": "cron_window", "route": "cuda",
        "source": "siddhi_tpu_torch/csrc/window_step.cu",
        "replaces": "siddhi_tpu/ops/windows2.py:1393",
        "launches": ct["launches"]["cron_window"],
        "max_abs_err": max(et_err, ct["err"]), "ms": ct["k5c_ms"],
        "plain_ms": ct["k5c_plain_ms"], "bound_ms": ct["k5c_bound_ms"],
        "bound_by": ct["k5c_bound_by"], "library_ms": None})
    table.append({
        "name": "reorder_ring", "route": "cuda",
        "source": "siddhi_tpu_torch/csrc/reorder_ring.cu",
        "replaces": "siddhi_tpu/resilience/ordering.py:820",
        "launches": ws["launches"]["reorder_ring"],
        "max_abs_err": max(et_err, ws["err"]), "ms": ws["k10_ms"],
        "plain_ms": ws["k10_plain_ms"], "bound_ms": ws["k10_bound_ms"],
        "bound_by": ws["k10_bound_by"],
        "library_ms": ws["k10_library_ms"]})

    _mark("44.")
    # -- 44. to 47. tenant serving pools (K1[K], K2's parameter load,
    # K5[K], K3[K], K4[K], K7[K]); tenants_pool, pool_pattern, pool_join,
    # pool_absent
    pl = pool_phases(dev, card)
    tp, pp, pj, pa = pl["tenants"], pl["pattern"], pl["join"], pl["absent"]
    pool_err = max(tp["k1"]["err"], tp["k2"]["err"], tp["k5"]["err"],
                   pp["K3"]["err"], pp["K2"]["err"], pj["K7"]["err"],
                   pj["K5"]["err"], pa["K4"]["err"], pa["K4t"]["err"])

    def pool_launches(kname):
        return tp["launches"].get(kname, 0) + sum(
            r["launches"][kname] for r in (pp, pj, pa))
    for row in table:
        if row["name"] in ("window_step[K]", "nfa_scan[K]"):
            row["launches"] += pool_launches(row["name"])
            row["max_abs_err"] = max(row["max_abs_err"], pool_err)
        elif row["name"] in ("unpack_packed", "expr_eval"):
            row["launches"] += pool_launches(row["name"])
    for kname, repl, r in (
            ("unpack_packed[K]", "siddhi_tpu/serving/pool.py:1411",
             tp["k1"]),
            ("expr_eval[K]", "siddhi_tpu/serving/pool.py:1301", tp["k2"]),
            ("nfa_parallel[K]", "siddhi_tpu/serving/pool.py:1313",
             pp["K3"]),
            ("join_probe[K]", "siddhi_tpu/serving/pool.py:1345",
             pj["K7"])):
        src = {"unpack_packed[K]": "unpack_packed.cu",
               "expr_eval[K]": "expr_eval.cu",
               "nfa_parallel[K]": "nfa_parallel.cu",
               "join_probe[K]": "join_cross.cu"}[kname]
        table.append({
            "name": kname, "route": "cuda",
            "source": f"siddhi_tpu_torch/csrc/{src}", "replaces": repl,
            "launches": pool_launches(kname), "max_abs_err": r["err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]})

    _mark("48.")
    # -- 48. to 50. the aggregation kernels over a slot axis (K11[K],
    # C[K], D[K], H[K]); pool_aggregation, partition_lanes, pool_lanes
    pg = pool_aggregation_phase(dev, card)
    pln = partition_lanes_phase(dev, card)
    plp = pool_lanes_phase(dev, card)
    s13 = (pg["launches"], pln["launches"], plp["launches"])

    def s13_launches(*names):
        return sum(r.get(k, 0) for r in s13 for k in names)
    lane_err = max(r["err"] for ph in (pln, plp)
                   for r in ph["lanes"].values())
    for row in table:
        kname = row["name"]
        if kname == "partition":
            row["launches"] += s13_launches(
                "partition_route", "partition_compact", "partition_due")
        elif kname in ("expr_eval", "window_step[K]", "aggregate_step[K]",
                       "aggregate_emit[K]", "unpack_packed[K]",
                       "expr_eval[K]"):
            row["launches"] += s13_launches(kname)
        if kname == "aggregate_step[K]":
            row["max_abs_err"] = max(row["max_abs_err"], lane_err)
        elif kname in ("unpack_packed[K]", "expr_eval[K]"):
            row["max_abs_err"] = max(row["max_abs_err"],
                                     pg["K1" if kname[0] == "u"
                                        else "K2"]["err"])
    k11 = pg["k11"]
    table.append({
        "name": "aggregation_step[K]", "route": "cuda",
        "source": "siddhi_tpu_torch/csrc/aggregation_step.cu",
        "replaces": "siddhi_tpu/serving/pool.py:1291",
        "launches": s13_launches("aggregation_step[K]"),
        "max_abs_err": k11["err"], "ms": k11["ms"],
        "plain_ms": k11["plain_ms"], "bound_ms": k11["bound_ms"],
        "bound_by": k11["bound_by"], "library_ms": k11["library_ms"]})
    for kname, src, repl in (
            ("sliding_minmax[K]", "aggregate_step.cu",
             "siddhi_tpu/ops/aggregators.py:511"),
            ("distinct_count[K]", "aggregate_step.cu",
             "siddhi_tpu/ops/aggregators.py:306"),
            ("union_set[K]", "union_set.cu",
             "siddhi_tpu/ops/aggregators.py:413")):
        r, rp = pln["lanes"][kname[:-3]], plp["lanes"][kname[:-3]]
        table.append({
            "name": kname, "route": "cuda",
            "source": f"siddhi_tpu_torch/csrc/{src}", "replaces": repl,
            "launches": s13_launches(kname),
            "max_abs_err": max(r["err"], rp["err"]), "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})

    _mark("51.")
    # -- 51. to 54. every window kind over a slot axis (A[K], B[K], E[K],
    # F[K]); partition_trades, partition_purchases, partition_sessions,
    # pool_windows
    s14 = window_slot_phases(dev, card)

    def s14_launches(*names):
        return sum(r["launches"].get(k, 0) for r in s14.values()
                   for k in names)
    for row in table:
        kname = row["name"]
        if kname == "partition":
            row["launches"] += s14_launches(
                "partition_route", "partition_compact", "partition_due")
        elif kname in ("expr_eval", "expr_eval[K]", "aggregate_step[K]",
                       "aggregate_emit[K]", "unpack_packed[K]",
                       "sliding_minmax[K]", "distinct_count[K]"):
            row["launches"] += s14_launches(kname)
    for kern, (kname, src, repl) in WIN_KERNELS.items():
        rs = [ph["rows"][kern] for ph in s14.values() if kern in ph["rows"]]
        r = max(rs, key=lambda x: x["ms"])   # the path of its largest step
        table.append({
            "name": kname if kern != "A" else "window_step[K] (A[K])",
            "route": "cuda", "source": f"siddhi_tpu_torch/csrc/{src}",
            "replaces": repl, "launches": s14_launches(kname),
            "max_abs_err": max(x["err"] for x in rs), "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})

    _mark("55.")
    # -- 55. and 56. order by, offset and limit over a slot axis (G[K]);
    # partition_top, pool_radar
    s15 = order_slot_phases(dev, card)

    def s15_launches(*names):
        return sum(r["launches"].get(k, 0) for r in s15.values()
                   for k in names)
    for row in table:
        kname = row["name"]
        if kname == "partition":
            row["launches"] += s15_launches(
                "partition_route", "partition_compact", "partition_due")
        elif kname in ("expr_eval", "expr_eval[K]", "window_step[K]",
                       "aggregate_step[K]", "aggregate_emit[K]",
                       "unpack_packed[K]", "sliding_minmax[K]"):
            row["launches"] += s15_launches(kname)
    gk = [ph["rows"]["G"] for ph in s15.values()]
    g = max(gk, key=lambda x: x["ms"])   # the path of its slowest launch
    table.append({
        "name": "order_by[K]", "route": "cuda",
        "source": "siddhi_tpu_torch/csrc/order_by.cu",
        "replaces": "siddhi_tpu/ops/selector.py:88",
        "launches": s15_launches("order_by[K]"),
        "max_abs_err": max(x["err"] for x in gk), "ms": g["ms"],
        "plain_ms": g["plain_ms"], "bound_ms": g["bound_ms"],
        "bound_by": g["bound_by"], "library_ms": g["library_ms"]})

    _mark("57.")
    # -- 57. to 59. checkpoint and recovery (K5c[K]): checkpoint_seq5,
    # checkpoint_partition, pool_cron
    s16 = checkpoint_phases(dev, card)

    def s16_launches(*names):
        return sum(r["launches"].get(k, 0) for r in s16.values()
                   for k in names)
    for row in table:
        kname = row["name"]
        if kname == "partition":
            row["launches"] += s16_launches(
                "partition_route", "partition_compact", "partition_due")
        elif kname in ("unpack_packed", "expr_eval", "nfa_parallel",
                       "unpack_packed[K]", "expr_eval[K]",
                       "window_step[K]", "aggregate_step[K]",
                       "aggregate_emit[K]"):
            row["launches"] += s16_launches(kname)
    kc = s16["pool_cron"]["k5ck"]
    table.append({
        "name": "cron_window[K]", "route": "cuda",
        "source": "siddhi_tpu_torch/csrc/window_step.cu",
        "replaces": "siddhi_tpu/ops/windows2.py:1393",
        "launches": s16_launches("cron_window[K]"),
        "max_abs_err": kc["err"], "ms": kc["ms"],
        "plain_ms": kc["plain_ms"], "bound_ms": kc["bound_ms"],
        "bound_by": kc["bound_by"], "library_ms": None})

    _mark("60.")
    # -- 60. result -----------------------------------------------------------
    print(json.dumps({"kernels": table}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
