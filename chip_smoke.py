#!/usr/bin/env python3
"""Smoke run of siddhi_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, each of which stops the run with a non-zero exit on failure:

1. device: CUDA must be there; prints the device, the build and
   ``nvidia-smi``'s name and power limit;
2. build the port's CUDA kernels from csrc/ and hold kernel K1
   (packed-ingest decode) against its plain PyTorch version on the
   card, bit for bit, for every lane code at capacities 16, 1024, 65536;
3. hold kernel K2 (expression evaluation) against its plain version on
   the card, bit for bit, over random columns with nulls and trap
   values, for every opcode;
4. run the filter bench app through SiddhiManager/send_arrays on the
   card: 1,048,576 events in 16 sends of 65,536 rows, checked against a
   numpy oracle in count and order; the launch counters must show that
   both kernels ran on that path; then time each kernel per chunk;
5. print the kernel table as one JSON line, the card's name and power
   limit, and the result line.

Imports neither JAX nor the reference package.
"""
import json
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM published HBM3 rate


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
    for k, (g, w) in enumerate(zip(got, want)):
        if g.shape != w.shape or g.dtype != w.dtype:
            fail(f"{name}: output {k} is {g.dtype}{list(g.shape)}, plain "
                 f"version {w.dtype}{list(w.shape)}")
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
                                         filter_feed, ingest_chunk)
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
            gc, gn, gv = expr_eval(prog, batch, em_k)
            rc, rn, rv = expr_eval_ref(prog, batch, em_r)
            k2_err = max(k2_err, compare(
                f"K2 program {k}/{gate:#06b}", [*gc, *gn, gv, em_k],
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
    torch.cuda.synchronize()
    print(f"K2 expr_eval: bit-equal to its plain version over "
          f"{len(exprs)} expressions and {len(conds)} filters "
          f"({n_progs} programs, {B} rows)", flush=True)

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

    # -- 5. result ---------------------------------------------------------------
    print(json.dumps({"kernels": table}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
