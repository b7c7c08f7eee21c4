#!/usr/bin/env python3
"""Drive the PyTorch port (``workloads_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run loudly:

1. device: require CUDA; print the card's name and power limit
   (nvidia-smi) and turn TF32 off for float32 matmuls and convolutions;
2. build every CUDA kernel of the port from the sources in this
   checkout (one nvcc per source, all started together), print each
   kernel instance's registers and spills, and fail if the wgmma
   kernels (bf16 K2, K3 and K4 at head_dim 64 and 128) spill;
3. hold each kernel against its plain PyTorch version on the card, in
   bfloat16 and float32: K1 (paged attention) at the serving path's
   shapes and variants, each with one split, with the split count the
   host picks and with more splits than live pages, three launches in a
   row bit-identical; K2-K4 (flash attention forward, dq, dk/dv) over
   MHA and GQA, causal and full, windows within and across tiles,
   segment_ids, narrow heads (the mma.sync route), ragged sequence
   lengths around the 128-row tile and up to the training path's 2,047,
   and a repeat of the forward that must be bit-identical;
4. the serving path: a ``ServeEngine`` at the full width of the widest
   model the repo defines (d_model 2048, 16 heads, 8 layers, d_ff 8192,
   vocab 32768, bf16, page_size 64; depth uncut, random weights from a
   seed) serving a mixed stream of requests to the end three times, each
   decode step a replay of the engine's captured CUDA graph: at the
   defaults, with ``superstep_k=4, pipelined=True``, and with
   ``prefill_budget=64``; every request ``ok`` with its full token
   count, no page left in use, the three greedy streams identical, every
   kernel launch counted (K1 n_layers a decode step, and in a profiled
   chunk as many as the profiler's trace shows); one chunk through the
   graph and through the eager loop from the same state, bit-identical
   and timed; then one teacher-forced decode step through the kernel and
   through the plain version, at 8 rows and at 2 (where K1 splits each
   row's pages), in float32 and in bfloat16, the bf16 limit being the
   step's own bf16 precision floor measured in the same run;
4b. the request lifecycle at the same width (``lifecycle_phase``), short
   requests in 16-step chunks at the defaults and with ``superstep_k=4,
   pipelined=True``: a fault at each engine seam with its replays (bf16
   and float32: the kept prefix equal to the fault-free drain's, and in
   float32 the whole stream, or a first divergence on a near-tie), retry
   exhaustion, cancel and withdraw with a superstep in flight, a queued
   and a running request past their deadlines, a health pause, a retune
   walk k 4 -> 1 -> 2 -> 4 (bit-identical streams, one graph capture)
   and close; every scenario with 0 pages left, K1 n_layers a decode
   step dispatched, and its wall time, quarantines, tokens replayed and
   recovery times printed;
5. time each kernel, its plain version and the closest single PyTorch
   call with CUDA events at the main paths' shapes (K1 and its library
   call as CUDA graphs: they are shorter than a launch through Python),
   beside the bound the card's memory rate and peak arithmetic rate set;
   one more K1 line, batch 1 at the longest row the engine's table holds;
6. the training path, ``workloads_torch.train`` at the same model's full
   width (batch 8, seq 2048, flash attention, bf16 compute over float32
   master weights, AdamW with a bf16 first moment): steps on one fixed
   batch whose loss must fall, then steps on synthetic batches, with
   every kernel launch counted (K2 = K3 = K4 = n_layers a step; K2 twice
   that with remat); one teacher-forced step through the kernels and
   through the plain versions, loss and every gradient leaf, in float32
   and in bfloat16 against the step's bf16 floor; step time, tokens/s
   and MFU from CUDA events; a profiled step split by kernel name.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
the line before it holds the per-kernel numbers as JSON.  Without a CUDA
device, or without the rest of the repo beside it, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet, dense): device memory rate
# and tensor-core rates by operand type.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# Kernel against plain version, stated per working dtype.  Both compute in
# float32 from the same inputs and round the output once, so bf16 results
# differ by about one bf16 ulp (2^-8 = 3.9e-3 at magnitude 1); float32
# differs only by summation order and expf.
KERNEL_ATOL = {"bfloat16": 1e-2, "float32": 1e-4}
# Whole decode step at full width, kernel route against plain route, in
# float32, relative to the largest logit: only summation order differs.
# In bf16 the limit is measured, not set: the plain route in bf16 against
# the plain route in float32 on the same weights and tokens (the precision
# floor of the bf16 step), which the kernel's difference must not exceed.
STEP_F32_RTOL = 1e-4
# Flash kernels against their plain versions, as a share of the largest
# |value| compared: float32 differs by summation order; bf16 by a flipped
# bf16 rounding of p, ds or the output (one ulp is 2^-8 of the value).
FLASH_SHARE = {"bfloat16": 2.0**-7, "float32": 1e-5}
# The full-width training step in float32, kernel route against plain
# route: the loss within 1e-5 of itself and each gradient leaf within
# 1e-3 of its largest value (attention's summation order differs, and
# the backward carries the difference through 8 layers).  In bf16 the
# limit is measured: plain bf16 against plain float32 on the same
# parameters and tokens.
TRAIN_F32_LOSS_RTOL = 1e-5
# AdamW's learning rate for the training path.  The JAX package's default,
# 1e-3 with no warm-up, drove the full-width loss up on one fixed batch
# (14.99, 24.37, 45.45, 35.53, 100.77 over 5 steps on the H100); at 1e-4
# the same steps show the model learning.
TRAIN_LR = 1e-4
TRAIN_F32_GRAD_SHARE = 1e-3

FULL = dict(
    d_model=2048, n_heads=16, n_layers=8, d_ff=8192, vocab_size=32768,
    page_size=64, decode_prompt=32, decode_lens=(64, 512), slots=8,
    train_batch=8, train_seq=2048, lifecycle_new=(64, 192, 128), lifecycle_requests=12,
    lifecycle_chunk=16,
)
# The lifecycle phase's scheduled faults: the crossing of each engine seam
# that fires, mid-drain in both of its modes.
LIFECYCLE_FAULTS = {"prefill_dispatch": [2], "prefill_readback": [3],
                    "decode_dispatch": [3], "decode_readback": [4]}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def ptxas_report(log: str) -> list[tuple[str, str, int]]:
    """One row per kernel instance from ``ptxas -v``'s report: its name
    and template arguments (read from the mangled name), the report's
    registers-and-spills text, and its spill-store bytes."""
    import re

    rows, kernel, spills, stores = [], "?", "", 0
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"(?<=\d)((?:flash|paged)_\w+?_kernel)I((?:Li\d+E|13__nv_bfloat16|f)+)E",
                          line)
            if m:
                args = [n or ("bf16" if bf else "float")
                        for n, bf, _ in re.findall(r"Li(\d+)E|(13__nv_bfloat16)|(f)", m.group(2))]
                kernel = f"{m.group(1)}<{', '.join(args)}>"
            else:
                kernel = line.split("'")[1]
        elif "spill stores" in line:
            spills = line.split(":")[-1].strip()
            stores = int(re.search(r"(\d+) bytes spill stores", line).group(1))
        elif "Used" in line and "registers" in line:
            used = line.split(":")[-1].strip()
            rows.append((kernel, f"{used}; {spills}", stores))
    return rows


def cuda_ms(fn, iters: int, warmup: int = 5) -> float:
    """Mean milliseconds of fn() over ``iters`` calls, CUDA-event timed."""
    import torch

    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, launches: int, replays: int = 20) -> float:
    """Mean device milliseconds of fn(i), from ``launches`` calls captured
    into one CUDA graph and replayed: a kernel shorter than its launch
    through Python would otherwise be timed by the host's enqueue."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(i)  # builds, and allocates what the wrapper keeps per stream
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for i in range(launches):
            fn(i)
    return cuda_ms(lambda _: graph.replay(), replays, warmup=2) / launches


def paged_inputs(torch, *, batch, heads, kv_heads, head_dim, page_size,
                 lengths, layers, dtype, seed):
    """Random q and pools, and a shuffled table covering each row."""
    g = torch.Generator("cuda").manual_seed(seed)
    max_pages = max(1, -(-max(lengths) // page_size))
    n_pages = batch * max_pages + 1
    shape = (layers, n_pages, kv_heads, page_size, head_dim)
    k = torch.randn(shape, generator=g, device="cuda").to(dtype)
    v = torch.randn(shape, generator=g, device="cuda").to(dtype)
    q = torch.randn((batch, heads, head_dim), generator=g, device="cuda").to(dtype)
    perm = torch.randperm(n_pages - 1, generator=g, device="cuda")
    tables = perm[: batch * max_pages].reshape(batch, max_pages).to(torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return q, k, v, tables.contiguous(), lens


def check_kernel_cases(torch, pa):
    """Phase 3: K1 against its plain version, every case and dtype."""
    ragged = [544, 0, 1, 63, 64, 65, 300, 511]
    cases = [
        ("full MHA", dict(heads=16, kv_heads=16, head_dim=128, page_size=64,
                          lengths=ragged, layers=8), None),
        ("GQA G=4", dict(heads=16, kv_heads=4, head_dim=128, page_size=64,
                         lengths=ragged, layers=2), None),
        ("GQA G=8", dict(heads=16, kv_heads=2, head_dim=128, page_size=64,
                         lengths=ragged, layers=2), None),
        ("window 100", dict(heads=16, kv_heads=16, head_dim=128, page_size=64,
                            lengths=ragged, layers=2), 100),
        ("CLI hd=64", dict(heads=8, kv_heads=8, head_dim=64, page_size=16,
                           lengths=[80, 1, 0, 47, 16, 33, 64, 79], layers=4), None),
        ("tiny hd=16 G=2 window 5", dict(heads=4, kv_heads=2, head_dim=16,
                                         page_size=4, lengths=[12, 0, 1, 7],
                                         layers=2), 5),
    ]
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    for name, shape, window in cases:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, tables, lens = paged_inputs(
                torch, batch=len(shape["lengths"]), dtype=dtype, seed=1, **shape
            )
            layer = shape["layers"] - 1
            want = pa.paged_attention_reference(
                q, k, v, tables, lens, layer=layer, window=window
            )
            tol = KERNEL_ATOL[str(dtype).split(".")[1]]
            zero_rows = [i for i, n in enumerate(shape["lengths"]) if n == 0]
            # One split, the host's choice, and more splits than any row
            # has live pages (the last shares are empty).
            picked = pa.choose_splits(len(shape["lengths"]), shape["kv_heads"],
                                      tables.shape[1], sm_count, dtype)
            errs = {}
            for splits in (1, picked, tables.shape[1] + 3):
                runs = [pa.paged_attention(q, k, v, tables, lens, layer=layer,
                                           window=window, splits=splits)
                        for _ in range(3)]
                torch.cuda.synchronize()
                got = runs[0]
                errs[splits] = (got.float() - want.float()).abs().max().item()
                if not all(bool((got[i] == 0).all()) for i in zero_rows):
                    fail(f"K1 length-0 rows are not zero: {name} {dtype} splits {splits}")
                if not all(torch.equal(got, again) for again in runs[1:]):
                    fail(f"K1 launches in a row differ (tickets not reset or the merge "
                         f"follows arrival): {name} {dtype} splits {splits}")
            shown = ", ".join(f"{n} splits {e:.3e}" for n, e in errs.items())
            print(f"  K1 {name:24s} {str(dtype):15s} max_abs_err: {shown} (tol {tol:.0e}; "
                  f"host picks {picked}); length-0 rows zero, 3 launches bit-identical",
                  flush=True)
            if not max(errs.values()) <= tol:
                fail(f"K1 disagrees with its plain version: {name} {dtype}")


def profile_chunk(torch, engine, rng, f, pa):
    """Where one decode chunk's time goes: torch.profiler over one engine
    step with every slot decoding, read from its chrome trace (device
    kernels by name, their summed time against the step's wall time).
    K1's launch count over the step must equal the profiler's count of
    its kernel.  Returns (wall ms, device ms, K1 counted, K1 traced)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(f["slots"]):
        engine.submit(rng.integers(0, engine.config.vocab_size, f["decode_prompt"]),
                      3 * engine.chunk)
    engine.step()  # admission and a first chunk, outside the window
    torch.cuda.synchronize()
    before = pa.paged_attention.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        engine.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    counted = pa.paged_attention.launches - before
    trace = os.path.join(ROOT, "build", "workloads_torch", "decode_chunk_trace.json")
    prof.export_chrome_trace(trace)
    with open(trace) as fh:
        events = json.load(fh)["traceEvents"]
    by_name: dict[str, list] = {}
    for e in events:
        if e.get("cat") == "kernel":
            by_name.setdefault(e["name"], []).append(e["dur"] / 1e3)
    engine.run()
    traced = sum(len(v) for name, v in by_name.items() if "paged_decode_kernel" in name)
    busy_ms = sum(sum(v) for v in by_name.values())
    print(f"  K1 launches over the profiled chunk: counted {counted}, kernels in the "
          f"profiler's trace {traced}", flush=True)
    if busy_ms == 0:
        fail("profiled decode chunk: no kernel events in the trace (device time not "
             "measured, K1's count unchecked)")
    print(f"  profiled decode chunk ({engine.chunk} steps, {f['slots']} rows, CUDA graph "
          f"replays): wall {wall_ms:.3f} ms, device kernels {busy_ms:.3f} ms, device "
          f"idle share {1 - busy_ms / wall_ms:.3f}", flush=True)
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:8]
    for name, durs in top:
        print(f"    {sum(durs):9.3f} ms {len(durs):6d} launches  {name[:90]}",
              flush=True)
    if counted != traced or counted != engine.config.n_layers * engine.chunk:
        fail(f"K1 counted {counted} launches over the profiled chunk, the trace shows "
             f"{traced}, n_layers x chunk is {engine.config.n_layers * engine.chunk}")
    return wall_ms, busy_ms, counted, traced


def drain(torch, engine, requests, counters, label):
    """Serve ``requests`` to the end after one warm-up request (graph
    capture, first launches), with every kernel launch counted over the
    timed run.  Fails unless every request is ``ok`` with its full token
    count, no page is left in use, and K1 launched n_layers times a
    decode step.  Returns the streams and the run's numbers."""
    engine.submit(requests[0][0], 2)
    engine.run()
    chunks0, tokens0, over0, super0 = (engine.chunks_run, engine.generated_tokens,
                                       engine.tokens_overdecoded, engine.supersteps_run)
    rids = [engine.submit(p, n) for p, n in requests]
    reset_counts(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    served = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(counters)["paged_attention"]
    decode_steps = (engine.chunks_run - chunks0) * engine.chunk
    tokens = engine.generated_tokens - tokens0
    out = {"streams": [served.get(r) for r in rids], "wall": wall, "tokens": tokens,
           "tokens_per_s": tokens / wall, "decode_steps": decode_steps,
           "launches": launches, "overdecoded": engine.tokens_overdecoded - over0}
    print(f"  {label}: drained in {wall:.3f} s: {tokens} tokens, {decode_steps} decode "
          f"steps ({engine.supersteps_run - super0} supersteps, {out['overdecoded']} tokens "
          f"over-decoded), decode tokens/s {out['tokens_per_s']:.1f}, paged_attention "
          f"launches {launches}, pages in use after drain {engine.ctrl.used_pages}",
          flush=True)
    statuses = {r.rid: r.status for r in engine.completed}
    for rid, (_, n), toks in zip(rids, requests, out["streams"]):
        if statuses.get(rid) != "ok" or toks is None or len(toks) != n:
            fail(f"{label} {rid}: status {statuses.get(rid)}, "
                 f"{None if toks is None else len(toks)} tokens, wanted {n}")
        if not all(0 <= t < engine.config.vocab_size for t in toks):
            fail(f"{label} {rid}: token out of the vocabulary")
    if engine.ctrl.used_pages != 0:
        fail(f"{label}: {engine.ctrl.used_pages} pages still in use after the drain")
    if launches == 0 or launches != engine.config.n_layers * decode_steps:
        fail(f"{label}: paged_attention launched {launches} times, expected "
             f"n_layers x decode steps = {engine.config.n_layers * decode_steps}")
    return out


def graph_against_eager_chunk(torch, paged_mod, engine, rng, f):
    """One decode chunk from the same state through the engine's CUDA
    graph and through the eager loop (``paged_decode_chunk``): the tokens
    and the pools must be bit-identical.  Each is timed on the host's
    clock to a synchronise (the chunk's wall time, what a client waits),
    three times from the restored state.  Returns (graph ms, eager ms)."""
    for _ in range(f["slots"]):
        engine.submit(rng.integers(0, engine.config.vocab_size, f["decode_prompt"]),
                      2 * engine.chunk)
    engine._admit()  # prefill and first tokens; no chunk yet
    engine._cover_chunk()
    inputs = (engine._dev(engine._tables), engine._dev(engine._tokens),
              engine._dev(engine._positions), engine._dev(engine._occupied))
    saved = [p.clone() for p in engine.pools]

    def restore():
        for pool, copy in zip(engine.pools, saved):
            pool.copy_(copy)
        torch.cuda.synchronize()

    def graph_chunk():
        return engine._graph.run(*inputs, *engine._unbounded, engine.chunk)[0].clone()

    def eager_chunk():
        with torch.inference_mode():
            return paged_mod.paged_decode_chunk(
                engine.params, engine.pools, *inputs, None, 0.0, 0, 1.0, engine.config,
                engine.chunk, False)[0]

    results, times = {}, {}
    for name, fn in (("graph", graph_chunk), ("eager", eager_chunk)):
        restore()
        fn()  # the graph's capture, and first launches, outside the timing
        runs = []
        for _ in range(3):
            restore()
            t0 = time.perf_counter()
            toks = fn()
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3)
        results[name] = (toks, [p.clone() for p in engine.pools])
        times[name] = sum(runs) / len(runs)
    restore()
    engine.close()
    same_tokens = torch.equal(results["graph"][0], results["eager"][0])
    same_pools = all(torch.equal(a, b) for a, b in zip(results["graph"][1],
                                                       results["eager"][1]))
    print(f"  one chunk ({engine.chunk} steps, {f['slots']} rows) from the same state: "
          f"CUDA graph {times['graph']:.3f} ms, eager loop {times['eager']:.3f} ms "
          f"(host clock to a synchronise, mean of 3); tokens "
          f"{'bit-identical' if same_tokens else 'DIFFER'}, pools "
          f"{'bit-identical' if same_pools else 'DIFFER'}", flush=True)
    if not (same_tokens and same_pools):
        fail("the decode chunk through the CUDA graph differs from the eager loop")
    return times["graph"], times["eager"]


def teacher_forced_step(torch, paged_mod, pa, params, config, ps, lengths, splits=None):
    """Prefill rows of the given lengths, then run one decode step through
    the kernel (with the host's split count, or ``splits``) and, on a copy
    of the pools, through the plain version.  Returns (kernel logits,
    plain logits)."""
    cover = -(-max(lengths) // ps)
    n_pages = len(lengths) * cover
    with torch.inference_mode():
        pools = paged_mod.init_page_pools(config, n_pages, ps, "cuda")
        tables = torch.arange(n_pages, dtype=torch.int32, device="cuda").reshape(
            len(lengths), cover)
        g = torch.Generator("cuda").manual_seed(5)
        prompts = torch.randint(0, config.vocab_size, (len(lengths), cover * ps),
                                generator=g, device="cuda")
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        paged_mod.paged_prefill_chunk(
            params, pools, tables, prompts, lens, config, start_page=0,
            cover_pages=cover, emit=False,
        )
        tok = torch.randint(0, config.vocab_size, (len(lengths),), generator=g,
                            device="cuda")
        # One more column, the trash page, as the engine's tables carry.
        tables_dec = torch.cat(
            [tables, torch.full((len(lengths), 1), n_pages, dtype=torch.int32,
                                device="cuda")], dim=1).contiguous()
        ref_pools = (pools[0].clone(), pools[1].clone())

        def kernel(q, kp, vp, t, ln, layer):
            return pa.paged_attention(q, kp, vp, t, ln, layer=layer,
                                      window=config.attention_window, splits=splits)

        got, _ = paged_mod._decode_core(params, pools, tables_dec, tok,
                                        lens.long(), config, attention_fn=kernel)

        def plain(q, kp, vp, t, ln, layer):
            return pa.paged_attention_reference(q, kp, vp, t, ln, layer=layer,
                                                window=config.attention_window)

        want, _ = paged_mod._decode_core(params, ref_pools, tables_dec, tok,
                                         lens.long(), config, attention_fn=plain)
        torch.cuda.synchronize()
    return got, want


def lifecycle_phase(torch, params, config, f, counters, device="cuda") -> int:
    """Phase 4b: the request lifecycle at the serving path's width, with
    short requests (prompt ``decode_prompt``, ``max_new_tokens`` cycling
    ``lifecycle_new``) and 16-step chunks (so a request outlives a
    superstep), at the defaults and with ``superstep_k=4, pipelined``,
    each scenario on a fresh engine: a fault at each engine
    seam (bf16 and float32), retry exhaustion, cancel and withdraw with a
    superstep in flight, deadlines, the health bridge, a retune walk
    (superstep mode) and close.  Gates: statuses, pages, K1's count
    (n_layers x decode steps dispatched, dropped supersteps included),
    one graph capture an engine, streams against the fault-free drain.
    ``device="cpu"`` rehearses the scheduling and the gates on the plain
    route.  Returns K1's launches over the phase."""
    import queue
    import statistics
    from dataclasses import replace

    import numpy as np
    from tpu_device_plugin.api.constants import HEALTHY, UNHEALTHY
    from tpu_device_plugin.device import HealthEvent
    from workloads_torch.faults import FaultInjector
    from workloads_torch.model import cast_params, forward
    from workloads_torch.serve import ServeEngine

    cuda = device == "cuda"
    rng = np.random.default_rng(1)
    news = [f["lifecycle_new"][i % len(f["lifecycle_new"])]
            for i in range(f["lifecycle_requests"])]
    requests = [(rng.integers(0, config.vocab_size, f["decode_prompt"]).tolist(), n)
                for n in news]
    weights = {torch.bfloat16: params, torch.float32: cast_params(params, torch.float32)}
    configs = {dt: replace(config, dtype=dt) for dt in weights}
    base = dict(slots=f["slots"], page_size=f["page_size"], chunk=f["lifecycle_chunk"],
                device=device)
    L = config.n_layers
    reset_counts(counters)

    def serve(label, dtype, kw, reqs=requests, script=None, deadlines=None, **engine_kw):
        """Drain ``reqs`` on a new engine, taking ``script[step]`` actions
        before that step; record the tokens each request kept at its
        first requeue.  Gates what every scenario shares and prints the
        scenario's line."""
        engine = ServeEngine(weights[dtype], configs[dtype], **base, **kw, **engine_kw)
        kept: dict[str, int] = {}
        requeue = engine._requeue_or_fail

        def recording_requeue(req, exc, **kwa):
            kept.setdefault(req.rid, len(req.tokens))
            return requeue(req, exc, **kwa)

        engine._requeue_or_fail = recording_requeue
        rids = [engine.submit(p, n, deadline_s=(deadlines or {}).get(i))
                for i, (p, n) in enumerate(reqs)]
        before = counters["paged_attention"].launches
        served, step = {}, 0
        t0 = time.perf_counter()
        while not engine.idle:
            for action in (script or {}).get(step, ()):
                action(engine, rids, served)
            for req in engine.step():
                served[req.rid] = req.tokens
            if engine.paused:
                time.sleep(0.001)
            step += 1
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = counters["paged_attention"].launches - before
        rec = sorted(engine.fault_recovery_s)
        recovery = (f"median {statistics.median(rec) * 1e3:.3f} ms max {rec[-1] * 1e3:.3f} ms"
                    if rec else "none")
        captures = engine._graph.captures if engine._graph is not None else 0
        print(f"  lifecycle {label} [{mode}, {str(dtype).split('.')[1]}]: wall {wall:.3f} s, "
              f"{engine.generated_tokens} tokens, {engine.chunks_run * engine.chunk} decode "
              f"steps, quarantined {engine.steps_quarantined}, retried "
              f"{engine.requests_retried}, tokens_replayed {engine.tokens_replayed}, "
              f"fault_recovery_s {recovery}, K1 launches {launches}, graph captures "
              f"{captures}", flush=True)
        if engine.ctrl.used_pages or engine._committed_pages:
            fail(f"lifecycle {label} [{mode}]: {engine.ctrl.used_pages} pages in use, "
                 f"{engine._committed_pages} committed after the drain")
        if cuda and launches != L * engine.chunks_run * engine.chunk:
            fail(f"lifecycle {label} [{mode}]: K1 launched {launches} times, n_layers x "
                 f"decode steps dispatched is {L * engine.chunks_run * engine.chunk}")
        if cuda and captures != min(1, engine.chunks_run):
            fail(f"lifecycle {label} [{mode}]: {captures} graph captures after "
                 f"{engine.chunks_run} chunks")
        statuses = {r.rid: r for r in engine.completed}
        return {"engine": engine, "rids": rids, "streams": [served.get(r) for r in rids],
                "reqs": [statuses.get(r) for r in rids], "kept": kept, "wall": wall}

    def all_ok(label, run):
        for rid, req, (_, n) in zip(run["rids"], run["reqs"], requests):
            if req is None or req.status != "ok" or len(req.tokens) != n:
                fail(f"lifecycle {label} [{mode}] {rid}: "
                     f"{None if req is None else (req.status, req.error, len(req.tokens))}")

    def replay_gate(label, dtype, run, ref):
        """Each replayed request keeps the fault-free prefix it emitted
        before its requeue.  float32: its whole stream equals the
        fault-free one, or its first diverging token sits on a near-tie
        of the fault-free logits (top-2 gap within STEP_F32_RTOL of the
        largest |logit|).  bf16: the rest is printed."""
        kept_ok, after = 0, []
        for rid, got, want, (prompt, _) in zip(run["rids"], run["streams"], ref["streams"],
                                               requests):
            if rid not in run["kept"]:
                if got != want and dtype == torch.float32:
                    fail(f"lifecycle {label} [{mode}] {rid}: never requeued, yet its float32 "
                         f"stream differs from the fault-free drain")
                continue
            k = run["kept"][rid]
            if got[:k] != want[:k]:
                fail(f"lifecycle {label} [{mode}] {rid}: the {k} tokens kept before the "
                     f"requeue differ from the fault-free stream")
            kept_ok += 1
            same = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), len(got))
            after.append(same - k)
            if dtype == torch.float32 and same < len(got):
                with torch.inference_mode():
                    logits = forward(weights[dtype], torch.tensor([prompt + want[:same]],
                                                                  device=device),
                                     configs[dtype])[0, -1].float()
                top = torch.topk(logits, 2).values
                gap, tol = (top[0] - top[1]).item(), STEP_F32_RTOL * logits.abs().max().item()
                print(f"  lifecycle {label} [{mode}] {rid}: float32 replay diverges at token "
                      f"{same} (kept {k}); the fault-free top-2 logit gap there {gap:.3e}, "
                      f"limit {tol:.3e}", flush=True)
                if not gap <= tol:
                    fail(f"lifecycle {label} [{mode}] {rid}: float32 replay diverges off a "
                         f"near-tie")
        print(f"  lifecycle {label} [{mode}, {str(dtype).split('.')[1]}]: {kept_ok} replayed "
              f"requests kept their fault-free prefix; tokens equal to the fault-free stream "
              f"past it: {after}", flush=True)

    def health(state):
        def act(engine, rids, served):
            engine._health_events.put(HealthEvent(chip_id="chip-0", health=state, code=2))
        return act

    modes = {"defaults": {}, "superstep_k=4 pipelined": dict(superstep_k=4, pipelined=True)}
    for mode, kw in modes.items():
        ref = {dt: serve("fault-free", dt, kw) for dt in weights}
        for dt in weights:
            all_ok("fault-free", ref[dt])

        # Faults: each engine seam fires once mid-drain.
        for dt in weights:
            injector = FaultInjector(LIFECYCLE_FAULTS)
            # A quarantine charges every request in flight one retry.
            run = serve("faults", dt, kw, fault_injector=injector,
                        max_retries=len(LIFECYCLE_FAULTS))
            all_ok("faults", run)
            fired = sorted(r.seam for r in injector.fired)
            e = run["engine"]
            if fired != sorted(LIFECYCLE_FAULTS) or e.steps_quarantined != len(LIFECYCLE_FAULTS):
                fail(f"lifecycle faults [{mode}]: fired {fired}, {e.steps_quarantined} "
                     f"quarantined steps, wanted one of each of {sorted(LIFECYCLE_FAULTS)}")
            if not e.fault_recovery_s:
                fail(f"lifecycle faults [{mode}]: no recovery time recorded")
            replay_gate("faults", dt, run, ref[dt])
            del run, e

        # Retry exhaustion: decode_dispatch fires at every crossing.
        run = serve("retry exhaustion", torch.bfloat16, kw, reqs=requests[:1],
                    fault_injector=FaultInjector({"decode_dispatch": range(1, 1000)}))
        req = run["reqs"][0]
        e = run["engine"]
        if not (req.status == "failed" and "InjectedFault" in req.error
                and req.retries == e.max_retries + 1):
            fail(f"lifecycle retry exhaustion [{mode}]: {req.status}, {req.error}, "
                 f"retries {req.retries}")

        # Cancel a running and a queued request and withdraw a queued one
        # at step 2, with a superstep in flight in the superstep mode.
        taken = {}

        def cancel_withdraw(engine, rids, served):
            if kw and not engine._pending_super:
                fail(f"lifecycle cancel [{mode}]: no superstep in flight at step 2")
            if not (engine.cancel(rids[1]) and engine.cancel(rids[10])):
                fail(f"lifecycle cancel [{mode}]: a live request could not be cancelled")
            taken["withdrawn"] = engine.withdraw(rids[11])

        run = serve("cancel and withdraw", torch.bfloat16, kw, script={2: [cancel_withdraw]})
        want = ref[torch.bfloat16]["streams"]
        for i, (req, stream) in enumerate(zip(run["reqs"], want)):
            status = "withdrawn" if i == 11 else req.status
            expected = {1: "cancelled", 10: "cancelled", 11: "withdrawn"}.get(i, "ok")
            got = taken["withdrawn"].tokens if i == 11 else req.tokens
            if status != expected or got != stream[: len(got)] or (
                    expected == "ok" and got != stream):
                fail(f"lifecycle cancel and withdraw [{mode}] request {i}: {status} with "
                     f"{len(got)} tokens, wanted {expected} and the fault-free stream")
        if not 0 < len(run["reqs"][1].tokens) < requests[1][1]:
            fail(f"lifecycle cancel [{mode}]: the running request was not cut mid-stream")

        # Deadlines: one request expires queued, one while running.
        run = serve("deadlines", torch.bfloat16, kw, deadlines={1: 0.05, 9: 0.02})
        for i, req in enumerate(run["reqs"]):
            stream = want[i]
            if i == 9:
                good = req.status == "expired" and req.tokens == [] and req.t_admit is None
            elif i == 1:
                good = (req.status == "expired" and 0 < len(req.tokens) < requests[1][1]
                        and req.tokens == stream[: len(req.tokens)])
            else:
                good = req.status == "ok" and req.tokens == stream
            if not good:
                fail(f"lifecycle deadlines [{mode}] request {i}: {req.status}, "
                     f"{len(req.tokens)} tokens")

        # The health bridge: unhealthy at step 2, held at 3, healthy at 4.
        def held(engine, rids, served):
            if not engine.paused or engine._occupied.any() or not engine.pending:
                fail(f"lifecycle health [{mode}]: not paused with the work requeued")
            if any(r.retries for r in engine.pending):
                fail(f"lifecycle health [{mode}]: a health requeue charged a retry")

        run = serve("health pause", torch.bfloat16, kw, health_events=queue.Queue(),
                    script={2: [health(UNHEALTHY)], 3: [held], 4: [health(HEALTHY)]})
        all_ok("health pause", run)
        if not run["kept"] or any(r.retries for r in run["reqs"]):
            fail(f"lifecycle health [{mode}]: nothing requeued, or a retry charged")
        replay_gate("health pause", torch.bfloat16, run, ref[torch.bfloat16])

        # retune walks k 4 -> 1 -> 2 -> 4 mid-drain: no replay, one capture.
        if kw:
            walk = {2: 1, 4: 2, 6: 4}
            script = {s: [lambda engine, rids, served, k=k: engine.retune(superstep_k=k)]
                      for s, k in walk.items()}
            run = serve("retune 4-1-2-4", torch.bfloat16, kw, script=script)
            all_ok("retune", run)
            if run["engine"].retunes != len(walk) or run["streams"] != want:
                fail(f"lifecycle retune [{mode}]: {run['engine'].retunes} retunes; streams "
                     f"{'equal' if run['streams'] == want else 'DIFFER from'} the fault-free "
                     f"drain")

        # close with a superstep in flight.
        engine = ServeEngine(weights[torch.bfloat16], configs[torch.bfloat16], **base, **kw)
        for p, n in requests:
            engine.submit(p, n)
        engine.step()
        engine.step()
        in_flight = bool(engine._pending_super) if kw else bool(engine._occupied.any())
        engine.close()
        statuses = {r.status for r in engine.completed}
        print(f"  lifecycle close [{mode}]: work in flight at close {in_flight}; statuses "
              f"{statuses}; idle {engine.idle}; pages in use {engine.ctrl.used_pages}",
              flush=True)
        if not (in_flight and statuses == {"failed"} and engine.idle
                and engine.ctrl.used_pages == 0 and len(engine.completed) == len(requests)):
            fail(f"lifecycle close [{mode}]: not every request failed and reclaimed")
        del engine, run, ref
        if cuda:
            torch.cuda.empty_cache()
    return read_counts(counters)["paged_attention"]


def kernel_counters(pa, fa) -> dict:
    """Every kernel wrapper of the port by its kernel's name; each counts
    its launches in ``.launches``."""
    return {"paged_attention": pa.paged_attention, "flash_fwd": fa.flash_fwd,
            "flash_bwd_dq": fa.flash_bwd_dq, "flash_bwd_dkv": fa.flash_bwd_dkv}


def reset_counts(counters: dict) -> None:
    for wrapper in counters.values():
        wrapper.launches = 0


def read_counts(counters: dict) -> dict:
    return {name: wrapper.launches for name, wrapper in counters.items()}


def share(torch, got, want) -> float:
    """max |got - want| as a share of max |want|."""
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


def flash_inputs(torch, *, batch, seq, heads, kv_heads, hd, segments, dtype, seed):
    g = torch.Generator("cuda").manual_seed(seed)

    def randn(h):
        return torch.randn(batch, seq, h, hd, generator=g, device="cuda").to(dtype)

    q, k, v, dout = randn(heads), randn(kv_heads), randn(kv_heads), randn(heads)
    seg = None
    if segments:
        seg = torch.sort(torch.randint(0, 3, (batch, seq), generator=g, device="cuda"),
                         dim=1).values.to(torch.int32)
    return q, k, v, dout, seg


def flash_errors(torch, fa, q, k, v, dout, seg, causal, window):
    """K2, K3 and K4 once each against the plain forward and backward
    (the backward kernels take the plain forward's out and lse), as
    shares of the largest |value|: {K2 out, K2 lse (abs), K3 dq, K4 dk, K4 dv}."""
    out, lse = fa.flash_fwd(q, k, v, causal, window, seg)
    want_out, want_lse = fa.flash_forward_reference(q, k, v, causal, window, seg)
    delta = fa._delta(want_out, dout)
    dq = fa.flash_bwd_dq(q, k, v, dout, want_lse, delta, causal, window, seg)
    dk, dv = fa.flash_bwd_dkv(q, k, v, dout, want_lse, delta, causal, window, seg)
    want = fa.flash_backward_reference(q, k, v, want_out, dout, want_lse, causal, window,
                                       seg)
    torch.cuda.synchronize()
    # A gradient that is zero in exact arithmetic carries only rounding
    # noise (seq 1: one visible key, a constant softmax, so dq = dk = 0);
    # below 1e-3 of the call's largest gradient it is measured against that.
    top = max(w.float().abs().max().item() for w in want)
    grads = {}
    for name, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        scale = w.float().abs().max().item()
        scale = top if scale < 1e-3 * top else scale
        grads[name] = (g.float() - w.float()).abs().max().item() / scale
    return {"out": share(torch, out, want_out),
            "lse": (lse - want_lse).abs().max().item(), **grads}


def check_flash_cases(torch, fa):
    """Phase 3: K2, K3 and K4 against their plain versions."""
    cases = [
        ("MHA causal hd=128 S=300", dict(batch=2, seq=300, heads=4, kv_heads=4, hd=128,
                                         segments=False), True, None),
        ("GQA G=4 causal hd=64 S=257", dict(batch=1, seq=257, heads=16, kv_heads=4,
                                            hd=64, segments=False), True, None),
        ("GQA G=8 full hd=64 S=200", dict(batch=1, seq=200, heads=16, kv_heads=2, hd=64,
                                          segments=False), False, None),
        ("window 100 hd=128 S=1000", dict(batch=1, seq=1000, heads=4, kv_heads=4, hd=128,
                                          segments=False), True, 100),
        ("segment_ids causal hd=64", dict(batch=2, seq=190, heads=4, kv_heads=2, hd=64,
                                          segments=True), True, None),
        ("segment_ids full hd=16", dict(batch=2, seq=150, heads=4, kv_heads=4, hd=16,
                                        segments=True), False, None),
        ("tiny hd=16 G=2 window 5", dict(batch=2, seq=65, heads=4, kv_heads=2, hd=16,
                                         segments=False), True, 5),
        ("GQA G=4 causal hd=128 S=2047", dict(batch=1, seq=2047, heads=16, kv_heads=4,
                                              hd=128, segments=False), True, None),
        ("window 200 hd=64 S=700", dict(batch=1, seq=700, heads=8, kv_heads=8, hd=64,
                                        segments=False), True, 200),
    ] + [
        # Ragged lengths around the wgmma kernels' 128-row tile.
        (f"GQA G=2 causal hd={hd} S={seq}", dict(batch=2, seq=seq, heads=4, kv_heads=2,
                                                 hd=hd, segments=False), True, None)
        for seq, hd in ((127, 128), (128, 64), (129, 128), (1, 64))
    ]
    for name, shape, causal, window in cases:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, dout, seg = flash_inputs(torch, dtype=dtype, seed=2, **shape)
            errs = flash_errors(torch, fa, q, k, v, dout, seg, causal, window)
            limit = FLASH_SHARE[str(dtype).split(".")[1]]
            print(f"  K2-K4 {name:28s} {str(dtype):15s} share of max: out "
                  f"{errs['out']:.2e} dq {errs['dq']:.2e} dk {errs['dk']:.2e} dv "
                  f"{errs['dv']:.2e} (limit {limit:.1e}); lse abs {errs['lse']:.2e}",
                  flush=True)
            if not (max(errs[x] for x in ("out", "dq", "dk", "dv")) <= limit
                    and errs["lse"] <= 1e-4):
                fail(f"K2-K4 disagree with their plain versions: {name} {dtype}")
    # K2 sums each row's keys in one order: a repeat gives the same bits.
    q, k, v, _, seg = flash_inputs(torch, batch=2, seq=333, heads=8, kv_heads=2, hd=128,
                                   segments=True, dtype=torch.bfloat16, seed=2)
    first, again = fa.flash_fwd(q, k, v, True, None, seg), fa.flash_fwd(q, k, v, True, None, seg)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(first, again)):
        fail("K2 launched twice on the same inputs gave different bits")
    print("  K2 repeat on the same inputs (GQA G=4, segment_ids, hd=128, S=333): "
          "out and lse bit-identical", flush=True)


def flash_numbers(torch, fa, f) -> list[dict]:
    """Phase 5 for K2, K3 and K4 at the training path's attention shape
    (batch 8, 16 heads, seq 2047, head_dim 128, causal, bf16): each
    kernel, its plain version and the library call, CUDA-event timed,
    beside its bound.  Returns the kernels' records without launches."""
    B, S, H, hd = f["train_batch"], f["train_seq"] - 1, f["n_heads"], f["d_model"] // f["n_heads"]
    q, k, v, dout, _ = flash_inputs(torch, batch=B, seq=S, heads=H, kv_heads=H, hd=hd,
                                    segments=False, dtype=torch.bfloat16, seed=4)
    errs = flash_errors(torch, fa, q, k, v, dout, None, True, None)
    if not max(errs[x] for x in ("out", "dq", "dk", "dv")) <= FLASH_SHARE["bfloat16"]:
        fail(f"K2-K4 at the training shapes disagree with their plain versions: {errs}")
    out, lse = fa.flash_fwd(q, k, v)
    delta = fa._delta(out, dout)
    ms = {
        "flash_fwd": cuda_ms(lambda i: fa.flash_fwd(q, k, v), 10, 2),
        "flash_bwd_dq": cuda_ms(lambda i: fa.flash_bwd_dq(q, k, v, dout, lse, delta), 10, 2),
        "flash_bwd_dkv": cuda_ms(lambda i: fa.flash_bwd_dkv(q, k, v, dout, lse, delta),
                                 10, 2),
    }
    plain_fwd = cuda_ms(lambda i: fa.flash_forward_reference(q, k, v), 3, 1)
    # The plain backward computes dq, dk and dv in one pass: its time
    # stands beside K3 and K4 alike.
    plain_bwd = cuda_ms(lambda i: fa.flash_backward_reference(q, k, v, out, dout, lse), 3, 1)
    # Library yardstick (the port never calls it): one
    # scaled_dot_product_attention call, forward for K2 and its backward
    # for K3 and K4 together, on the same inputs in [B, H, S, hd].
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt, dot = (x.transpose(1, 2).contiguous() for x in (q, k, v, dout))
    lib_fwd = cuda_ms(lambda i: sdpa(qt, kt, vt, is_causal=True), 20)
    lib_out = sdpa(qt, kt, vt, is_causal=True).transpose(1, 2)
    lib_err = share(torch, lib_out, out)
    leaves = [x.detach().requires_grad_(True) for x in (qt, kt, vt)]
    lib_o = sdpa(*leaves, is_causal=True)
    lib_bwd = cuda_ms(lambda i: torch.autograd.grad(lib_o, leaves, dot, retain_graph=True),
                      10)
    del lib_o, leaves
    # Bounds from the work these inputs need: the causal mask leaves
    # S(S+1)/2 (q, k) pairs per head; each product is 2*hd flops a pair.
    pairs = S * (S + 1) // 2 * B * H
    elt = B * S * H * hd * 2  # one bf16 [B, S, H, hd] tensor, bytes
    rows = B * H * S * 4  # one float32 [B*H, S] row vector, bytes
    work = {  # flops, bytes read once and written once
        "flash_fwd": (2 * 2 * hd * pairs, 4 * elt + rows),
        "flash_bwd_dq": (3 * 2 * hd * pairs, 5 * elt + 2 * rows),
        "flash_bwd_dkv": (4 * 2 * hd * pairs, 6 * elt + 2 * rows),
    }
    plain = {"flash_fwd": plain_fwd, "flash_bwd_dq": plain_bwd, "flash_bwd_dkv": plain_bwd}
    library = {"flash_fwd": lib_fwd, "flash_bwd_dq": lib_bwd, "flash_bwd_dkv": lib_bwd}
    err = {"flash_fwd": errs["out"], "flash_bwd_dq": errs["dq"],
           "flash_bwd_dkv": max(errs["dk"], errs["dv"])}
    replaces = {"flash_fwd": "workloads/ops/attention.py:52",
                "flash_bwd_dq": "workloads/ops/attention.py:269",
                "flash_bwd_dkv": "workloads/ops/attention.py:333"}
    records = []
    for name, (flops, nbytes) in work.items():
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / PEAK_FLOPS["bfloat16"] * 1e3
        bound_ms, bound_by = max((bytes_ms, "bytes"), (ops_ms, "operations"))
        print(f"  {name} at B={B} H={H} S={S} hd={hd} causal bf16: kernel "
              f"{ms[name]:.4f} ms, plain {plain[name]:.3f} ms, library {library[name]:.4f} ms, "
              f"bound {bound_ms:.4f} ms by {bound_by} ({flops / 1e9:.1f} GFLOP, "
              f"{nbytes / 1e6:.1f} MB), {flops / ms[name] / 1e9:.1f} TFLOP/s achieved, "
              f"{bound_ms / ms[name]:.3f} of the bound, share of max vs plain "
              f"{err[name]:.2e}", flush=True)
        records.append({
            "name": name, "route": "cuda",
            "source": "workloads_torch/ops/csrc/flash_attention.cu",
            "replaces": replaces[name], "launches": None, "max_abs_err": err[name],
            "ms": ms[name], "plain_ms": plain[name], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library[name],
        })
    print(f"  library forward vs kernel share of max {lib_err:.2e}; plain and library "
          f"backward times cover dq, dk and dv together", flush=True)
    return records


def plain_flash_fn(torch, fa):
    """Causal flash attention through the plain forward and backward
    only, as an ``attention_fn`` for the training step's plain route."""
    class PlainFlash(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v):
            out, lse = fa.flash_forward_reference(q, k, v)
            ctx.save_for_backward(q, k, v, out, lse)
            return out

        @staticmethod
        def backward(ctx, dout):
            q, k, v, out, lse = ctx.saved_tensors
            return fa.flash_backward_reference(q, k, v, out, dout, lse)

    return PlainFlash.apply


def loss_and_grads(torch, model_mod, train_mod, params, tokens, config, attention_fn=None):
    leaves = train_mod.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss = model_mod.loss_fn(params, tokens, config, attention_fn)
        grads = torch.autograd.grad(loss, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    return loss.item(), grads


def profile_train_step(torch, step, params, state, tokens):
    """Where one training step's device time goes: torch.profiler over one
    step, read from its chrome trace (kernels by name, their summed time
    against the step's wall time)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(params, state, tokens)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    trace = os.path.join(ROOT, "build", "workloads_torch", "train_step_trace.json")
    prof.export_chrome_trace(trace)
    with open(trace) as fh:
        events = json.load(fh)["traceEvents"]
    by_name: dict[str, list] = {}
    for e in events:
        if e.get("cat") == "kernel":
            by_name.setdefault(e["name"], []).append(e["dur"] / 1e3)
    busy_ms = sum(sum(v) for v in by_name.values())
    if busy_ms == 0:
        print("  profiled train step: device time not measured (no kernel events)",
              flush=True)
        return
    print(f"  profiled train step: wall {wall_ms:.1f} ms, device kernels {busy_ms:.1f} ms, "
          f"device idle share {1 - busy_ms / wall_ms:.3f}", flush=True)
    ranked = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))
    # The 16 largest, and the port's own kernels wherever they rank.
    for rank, (name, durs) in enumerate(ranked):
        if rank < 16 or "flash_" in name or "paged_" in name:
            print(f"    {sum(durs):9.2f} ms {len(durs):6d} launches  {name[:100]}", flush=True)


def train_path(torch, model_mod, train_mod, fa, counters, f) -> dict:
    """Phase 6: the training path at full width.  Returns the kernels'
    launch counts over the main run (the fixed-batch and synthetic
    steps)."""
    from dataclasses import replace

    config = model_mod.ModelConfig(
        d_model=f["d_model"], n_heads=f["n_heads"], n_layers=f["n_layers"],
        d_ff=f["d_ff"], vocab_size=f["vocab_size"], max_seq_len=f["train_seq"],
        dtype=torch.bfloat16, attention_impl="flash",
    )
    B, L = f["train_batch"], config.n_layers
    (params, state), optimizer = train_mod.make_train_state(
        config, seed=0, device="cuda", optimizer=train_mod.AdamW(lr=TRAIN_LR))
    step = train_mod.make_train_step(config, optimizer)
    fixed = train_mod.synthetic_batch(config, B, seed=0, device="cuda")
    print(f"  batch {B} x {config.max_seq_len} tokens (forward at seq "
          f"{config.max_seq_len - 1}), {config.n_layers} layers, remat off, AdamW lr "
          f"{TRAIN_LR}", flush=True)

    # (a) the main run: 5 steps on one fixed batch, then 3 on new batches.
    reset_counts(counters)
    losses = []
    for _ in range(5):
        params, state, loss = step(params, state, fixed)
        losses.append(loss.item())
    for s in range(1, 4):
        params, state, loss = step(params, state,
                                   train_mod.synthetic_batch(config, B, seed=s, device="cuda"))
        losses.append(loss.item())
    torch.cuda.synchronize()
    launches = read_counts(counters)
    n_steps = len(losses)
    print(f"  losses, 5 steps on one batch then 3 new batches: "
          f"{[round(x, 5) for x in losses]}", flush=True)
    print(f"  launches over {n_steps} steps: {launches}", flush=True)
    if not all(x == x and abs(x) < 1e9 for x in losses):
        fail("non-finite training loss")
    if not losses[4] < losses[0]:
        fail(f"the loss did not fall over 5 steps on one batch: {losses[:5]}")
    want = {"paged_attention": 0, "flash_fwd": L * n_steps, "flash_bwd_dq": L * n_steps,
            "flash_bwd_dkv": L * n_steps}
    if launches != want:
        fail(f"training launches {launches}, expected {want}")
    remat_step = train_mod.make_train_step(replace(config, remat_layers=True), optimizer)
    reset_counts(counters)
    params, state, _ = remat_step(params, state, fixed)
    torch.cuda.synchronize()
    remat = read_counts(counters)
    print(f"  launches in one step with remat_layers: {remat}", flush=True)
    if remat != {**want, "flash_fwd": 2 * L, "flash_bwd_dq": L, "flash_bwd_dkv": L}:
        fail(f"remat step launches {remat}, expected K2 = {2 * L}, K3 = K4 = {L}")

    # (c) step time, tokens/s and MFU (CUDA events, after the warm-up above).
    iters = 3
    step_ms = cuda_ms(lambda i: step(params, state, fixed), iters, warmup=1)
    tokens = B * (config.max_seq_len - 1)
    flops = train_step_flops(config, B)
    mfu = flops / (step_ms / 1e3) / PEAK_FLOPS["bfloat16"]
    print(f"  training step {step_ms:.1f} ms (mean of {iters}), {tokens / step_ms * 1e3:.1f} "
          f"tokens/s, {flops / 1e12:.2f} TFLOP a step, MFU {mfu:.4f} of 989 TFLOP/s",
          flush=True)
    x = torch.randn(tokens, config.d_model, device="cuda")
    w = params["unembed"]
    unembed_ms = cuda_ms(lambda i: x @ w, 5, 1)
    print(f"  the float32 unembed product alone [{tokens}, {config.d_model}] @ "
          f"[{config.d_model}, {config.vocab_size}]: {unembed_ms:.2f} ms (TF32 off); "
          f"the step runs it and its two gradient products", flush=True)
    del x

    # (d) one profiled step.
    profile_train_step(torch, step, params, state, fixed)
    del state

    # (b) one teacher-forced step, kernel route against plain route, in
    # float32 and in bf16, with remat on both routes so that the dense
    # plain backward fits beside the activations; depth uncut.
    plain_fn = plain_flash_fn(torch, fa)
    tokens_b = train_mod.synthetic_batch(config, B, seed=9, device="cuda")
    cfg32 = replace(config, dtype=torch.float32, remat_layers=True)
    cfg16 = replace(config, remat_layers=True)
    loss_p32, g_p32 = loss_and_grads(torch, model_mod, train_mod, params, tokens_b, cfg32,
                                     plain_fn)
    loss_k32, g_k32 = loss_and_grads(torch, model_mod, train_mod, params, tokens_b, cfg32)
    f32_shares = [share(torch, a, b) for a, b in zip(g_k32, g_p32)]
    del g_k32
    loss_p16, g_p16 = loss_and_grads(torch, model_mod, train_mod, params, tokens_b, cfg16,
                                     plain_fn)
    floor = [((a - b).abs().max().item(), (a - b).square().mean().sqrt().item())
             for a, b in zip(g_p16, g_p32)]
    del g_p32
    loss_k16, g_k16 = loss_and_grads(torch, model_mod, train_mod, params, tokens_b, cfg16)
    got = [((a - b).abs().max().item(), (a - b).square().mean().sqrt().item())
           for a, b in zip(g_k16, g_p16)]
    del g_k16, g_p16
    names = ["embed", "unembed"] + [f"layers/{i}/{n}" for i, layer in
                                    enumerate(params["layers"]) for n in sorted(layer)]
    print(f"  teacher-forced step, depth {config.n_layers}: float32 loss kernel "
          f"{loss_k32:.7f} plain {loss_p32:.7f}; gradient leaves kernel vs plain, share of "
          f"max: largest {max(f32_shares):.2e} (limit {TRAIN_F32_GRAD_SHARE:.0e})",
          flush=True)
    print(f"  bf16 loss kernel {loss_k16:.7f} plain {loss_p16:.7f} (bf16 floor: plain bf16 "
          f"vs plain float32 {abs(loss_p16 - loss_p32):.3e}, kernel vs plain "
          f"{abs(loss_k16 - loss_p16):.3e})", flush=True)
    bad = []
    for name, (g_max, g_rms), (f_max, f_rms) in zip(names, got, floor):
        if not (g_max <= f_max and g_rms <= f_rms):
            bad.append(name)
    worst = max(range(len(names)), key=lambda i: got[i][0] / max(floor[i][0], 1e-30))
    print(f"  bf16 gradient leaves kernel vs plain within the floor (max and rms) for "
          f"{len(names) - len(bad)} of {len(names)}; closest: {names[worst]} max "
          f"{got[worst][0]:.3e} rms {got[worst][1]:.3e} against floor max "
          f"{floor[worst][0]:.3e} rms {floor[worst][1]:.3e}", flush=True)
    if not abs(loss_k32 - loss_p32) <= TRAIN_F32_LOSS_RTOL * abs(loss_p32):
        fail("float32 training loss through the kernels disagrees with the plain route")
    if not max(f32_shares) <= TRAIN_F32_GRAD_SHARE:
        fail("float32 gradients through the kernels disagree with the plain route")
    if not abs(loss_k16 - loss_p16) <= abs(loss_p16 - loss_p32):
        fail("bf16 training loss through the kernels differs from the plain route by more "
             "than bf16 differs from float32")
    if bad:
        fail(f"bf16 gradients through the kernels differ from the plain route by more than "
             f"bf16 differs from float32 for {bad}")
    return launches


def train_step_flops(config, batch: int) -> float:
    """Analytic FLOPs of one training step, as the JAX package's
    perfbench counts them: 3x the forward's matmul work (weights, the
    unembed, and causal attention at half the square)."""
    d, ff = config.d_model, config.d_ff
    kv_proj = 2 * d * (config.kv_heads * config.head_dim)
    layer_params = config.n_layers * (2 * d * d + kv_proj + 2 * d * ff)
    seq = config.max_seq_len - 1
    tokens = batch * seq
    fwd_dense = 2 * tokens * (layer_params + d * config.vocab_size)
    fwd_attn = config.n_layers * batch * (4 * seq * seq * d) * 0.5
    return 3 * (fwd_dense + fwd_attn)


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a GPU")
    sys.path.insert(0, ROOT)
    try:
        from workloads_torch import model as model_mod
        from workloads_torch import paged as paged_mod
        from workloads_torch import train as train_mod
        from workloads_torch.model import ModelConfig, cast_params, init_params
        from workloads_torch.ops import _build
        from workloads_torch.ops import attention as fa
        from workloads_torch.ops import paged_attention as pa
        from workloads_torch.serve import ServeEngine
    except ImportError as exc:
        fail(f"the port (workloads_torch/) is not beside chip_smoke.py: {exc}")

    # 1. device
    phase("device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("  TF32 off for float32 matmuls and cuDNN", flush=True)
    kind = torch.cuda.get_device_name(0)
    print(f"  torch {torch.__version__} cuda {torch.version.cuda} device {kind}",
          flush=True)

    # 2. build: one nvcc per source, all started together.
    phase("build")
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(_build.KERNELS)) as pool:
        seconds = list(pool.map(_build.build, _build.KERNELS))
    print(f"  built {len(_build.KERNELS)} sources in parallel in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    spilled = []
    for name, sec in zip(_build.KERNELS, seconds):
        print(f"  built {name} in {sec:.2f} s (0 when reused)", flush=True)
        for kernel, text, stores in ptxas_report(_build.build_log(name)):
            print(f"  ptxas {kernel}: {text}", flush=True)
            if "_wgmma_kernel" in kernel and stores:
                spilled.append(kernel)
    # The bf16 K2, K3 and K4 at head_dim 64 and 128 hold head_dim-wide
    # float32 accumulators in registers: a spill there is a design fault.
    if spilled:
        fail(f"ptxas spills in the wgmma kernels: {spilled}")

    # 3. kernel against plain
    phase("kernel against plain version")
    check_kernel_cases(torch, pa)
    check_flash_cases(torch, fa)
    counters = kernel_counters(pa, fa)

    # 4. the serving path at full width
    phase("serving path: ServeEngine at full width")
    f = FULL
    max_new = [f["decode_lens"][0], f["decode_lens"][1], 128, 256] * 3
    config = ModelConfig(
        d_model=f["d_model"], n_heads=f["n_heads"], n_layers=f["n_layers"],
        d_ff=f["d_ff"], vocab_size=f["vocab_size"],
        max_seq_len=f["decode_prompt"] + f["decode_lens"][1],
        dtype=torch.bfloat16,
    )
    params = cast_params(
        init_params(config, torch.Generator("cuda").manual_seed(0)), config.dtype
    )
    n_params = sum(
        w.numel() for w in [params["embed"], params["unembed"]]
        + [t for layer in params["layers"] for t in layer.values()]
    )
    import numpy as np

    rng = np.random.default_rng(0)
    requests = [(rng.integers(0, config.vocab_size, f["decode_prompt"]), n) for n in max_new]
    base = dict(slots=f["slots"], page_size=f["page_size"], chunk=f["page_size"],
                device="cuda")
    engine = ServeEngine(params, config, **base)
    print(f"  model {n_params / 1e6:.1f}M params, pool "
          f"{tuple(engine.pools[0].shape)} x2, {len(max_new)} requests, "
          f"prompt {f['decode_prompt']}, max_new_tokens {max_new}", flush=True)
    drains = {"defaults": drain(torch, engine, requests, counters, "drain at the defaults")}
    launches = drains["defaults"]["launches"]
    tokens_per_s = drains["defaults"]["tokens_per_s"]
    chunk_wall, chunk_busy, _, _ = profile_chunk(torch, engine, rng, f, pa)
    graph_chunk_ms, eager_chunk_ms = graph_against_eager_chunk(
        torch, paged_mod, ServeEngine(params, config, **base), rng, f)
    max_pages = engine.max_pages
    del engine
    for name, kw in (("superstep_k=4 pipelined", dict(superstep_k=4, pipelined=True)),
                     ("prefill_budget=64", dict(prefill_budget=64))):
        engine = ServeEngine(params, config, **base, **kw)
        drains[name] = drain(torch, engine, requests, counters, f"drain with {name}")
        del engine
        torch.cuda.empty_cache()
    for name, run in drains.items():
        if run["streams"] != drains["defaults"]["streams"]:
            fail(f"the greedy streams of the drain with {name} differ from the drain at "
                 f"the defaults")
    print(f"  the {len(drains)} drains' greedy streams are identical", flush=True)

    # One teacher-forced decode step, kernel route against plain route, in
    # float32 and in the serving dtype (same weights, bf16-valued, and
    # the same tokens): at 8 rows (K1 takes one split) and at 2 rows,
    # where K1 cuts each row's pages into the host's split count.
    from dataclasses import replace

    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    step_rows = {8: [32, 100, 200, 300, 400, 500, 543, 1], 2: [543, 300]}
    for rows, lengths in step_rows.items():
        width = -(-max(lengths) // f["page_size"]) + 1
        split_f32 = pa.choose_splits(rows, config.kv_heads, width, sm_count)
        splits_here = {dtype: pa.choose_splits(rows, config.kv_heads, width, sm_count, dtype)
                       for dtype in (torch.float32, torch.bfloat16)}
        steps = {}
        for dtype in (torch.float32, torch.bfloat16):
            step_params = params if dtype == config.dtype else cast_params(params, dtype)
            steps[dtype] = teacher_forced_step(torch, paged_mod, pa, step_params,
                                               replace(config, dtype=dtype), f["page_size"],
                                               lengths)
            del step_params
        got32, want32 = steps[torch.float32]
        got16, want16 = steps[torch.bfloat16]
        if split_f32 > 1:
            # Not a gate: the split route in bf16, which the host no longer
            # takes (ROADMAP Queue C), against the same floor.
            forced, _ = teacher_forced_step(torch, paged_mod, pa, params, config,
                                            f["page_size"], lengths, splits=split_f32)
            print(f"  bf16 decode step, {rows} rows, K1 forced to {split_f32} splits: kernel "
                  f"vs plain max {(forced - want16).abs().max().item():.4e} rms "
                  f"{(forced - want16).square().mean().sqrt().item():.4e} (floor max "
                  f"{(want16 - want32).abs().max().item():.4e} rms "
                  f"{(want16 - want32).square().mean().sqrt().item():.4e})", flush=True)
        scale = want32.abs().max().item()
        f32_err = (got32 - want32).abs().max().item()
        f32_tol = STEP_F32_RTOL * scale
        bf16_err = (got16 - want16).abs().max().item()
        bf16_floor = (want16 - want32).abs().max().item()
        bf16_rms = (got16 - want16).square().mean().sqrt().item()
        floor_rms = (want16 - want32).square().mean().sqrt().item()
        print(f"  teacher-forced decode step, {rows} rows (K1 splits: float32 "
              f"{splits_here[torch.float32]}, bf16 {splits_here[torch.bfloat16]}), max "
              f"|logit| {scale:.4e}: float32 kernel vs plain {f32_err:.4e} (limit "
              f"{f32_tol:.4e} = {STEP_F32_RTOL} x max); bfloat16 kernel vs plain max "
              f"{bf16_err:.4e} rms {bf16_rms:.4e} (limits: the bf16 floor, plain bf16 vs "
              f"plain float32, max {bf16_floor:.4e} rms {floor_rms:.4e})", flush=True)
        if not (torch.isfinite(got32).all() and torch.isfinite(got16).all()):
            fail("the teacher-forced decode step gave non-finite logits")
        if not f32_err <= f32_tol:
            fail(f"float32 decode step through the kernel disagrees with the plain route "
                 f"({rows} rows)")
        if not (bf16_err <= bf16_floor and bf16_rms <= floor_rms):
            fail(f"bfloat16 decode step through the kernel differs from the plain route by "
                 f"more than bf16 differs from float32 ({rows} rows, "
                 f"{splits_here[torch.bfloat16]} splits)")

    # 4b. the request lifecycle at the same width
    phase("serving path: request lifecycle at full width")
    t0 = time.perf_counter()
    lifecycle_launches = lifecycle_phase(torch, params, config, f, counters)
    print(f"  lifecycle phase: {time.perf_counter() - t0:.1f} s, K1 launches "
          f"{lifecycle_launches}", flush=True)

    # 5. numbers at the main path's shapes: 8 slots at the deepest
    # position a request of this run reaches (32 + 512 = 544 tokens).
    phase("numbers")
    B, H, hd, L = f["slots"], config.n_heads, config.head_dim, config.n_layers
    ps = f["page_size"]
    depth = f["decode_prompt"] + f["decode_lens"][1]
    q, k, v, live_tables, lens = paged_inputs(
        torch, batch=B, heads=H, kv_heads=config.kv_heads, head_dim=hd,
        page_size=ps, lengths=[depth] * B, layers=L, dtype=torch.bfloat16, seed=3,
    )
    # Tables as wide as the engine's: the live pages, then the pool's last
    # (unused) page as padding.
    pad = torch.full((B, max_pages - live_tables.shape[1]), k.shape[1] - 1,
                     dtype=torch.int32, device="cuda")
    tables = torch.cat([live_tables, pad], dim=1).contiguous()
    # Cycle the layer so each launch reads pages the last one did not
    # (8 layers x ~36 MB of live pages exceed the 50 MB L2).
    out_k = pa.paged_attention(q, k, v, tables, lens, layer=0)
    out_p = pa.paged_attention_reference(q, k, v, tables, lens, layer=0, window=None)
    main_err = (out_k.float() - out_p.float()).abs().max().item()
    # K1 now takes less time than a launch through Python does, so it and
    # the library call are timed as CUDA graphs of 8 x L launches.
    n_graph = 8 * L
    splits = pa.choose_splits(B, config.kv_heads, max_pages,
                              torch.cuda.get_device_properties(0).multi_processor_count,
                              torch.bfloat16)
    launches_before = pa.paged_attention.launches
    kernel_ms = graph_ms(
        lambda i: pa.paged_attention(q, k, v, tables, lens, layer=i % L), n_graph)
    # Beside the host's choice, the other side of it: a forced split where
    # it picks none, or none where it picks one.
    other = 2 if splits == 1 else 1
    other_ms = graph_ms(
        lambda i: pa.paged_attention(q, k, v, tables, lens, layer=i % L, splits=other),
        n_graph)
    pa.paged_attention.launches = launches_before  # timing launches are not the path's
    plain_ms = cuda_ms(
        lambda i: pa.paged_attention_reference(q, k, v, tables, lens,
                                               layer=i % L, window=None), 50)
    # Library yardstick: scaled_dot_product_attention over each layer's
    # gathered view (gathered beforehand; the port never calls it).
    T = max_pages * ps
    views = []
    for layer in range(L):
        def gathered(pool):
            g_ = pool[layer][tables.long()].permute(0, 2, 1, 3, 4)
            return g_.reshape(B, config.kv_heads, T, hd).contiguous()
        views.append((gathered(k), gathered(v)))
    mask = (torch.arange(T, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_out = sdpa(q[:, :, None], views[0][0], views[0][1], attn_mask=mask)[:, :, 0]
    lib_err = (lib_out.float() - out_p.float()).abs().max().item()
    library_ms = graph_ms(
        lambda i: sdpa(q[:, :, None], views[i % L][0], views[i % L][1],
                       attn_mask=mask), n_graph)
    # Bound: live K/V positions read once, q read once, out written once.
    elt = 2
    live = sum(min(depth, T) for _ in range(B))
    bytes_moved = (2 * live * config.kv_heads * hd + 2 * B * H * hd) * elt \
        + tables.numel() * 4 + B * 4
    flops = 4 * live * H * hd  # q.k and p.v per position per query head
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_FLOPS["bfloat16"] * 1e3
    bound_ms, bound_by = max((bytes_ms, "bytes"), (ops_ms, "operations"))
    print(f"  K1 at B={B} H={H} hd={hd} ps={ps} depth {depth}: kernel "
          f"{kernel_ms * 1e3:.2f} us with the host's {splits} splits ({other_ms * 1e3:.2f} "
          f"us with {other}), plain {plain_ms * 1e3:.2f} us, sdpa "
          f"{library_ms * 1e3:.2f} us (sdpa vs plain max_abs_err "
          f"{lib_err:.2e}), bound {bound_ms * 1e3:.2f} us by {bound_by} "
          f"({bytes_moved / 1e6:.2f} MB), {bytes_moved / kernel_ms / 1e6:.1f} "
          f"GB/s achieved, {bound_ms / kernel_ms:.3f} of the bound; kernel and sdpa timed "
          f"as CUDA graphs of {n_graph} launches", flush=True)
    # Not a gate: one row as long as the engine's table holds, where only
    # the split fills the card: the split count its shapes give (float32
    # pools take it; bf16 pools keep one split, ROADMAP Queue C) against 1.
    long_len = max_pages * ps
    q1, k1, v1, t1, l1 = paged_inputs(
        torch, batch=1, heads=H, kv_heads=config.kv_heads, head_dim=hd, page_size=ps,
        lengths=[long_len], layers=L, dtype=torch.bfloat16, seed=6,
    )
    long_splits = pa.choose_splits(1, config.kv_heads, max_pages,
                                   torch.cuda.get_device_properties(0).multi_processor_count)
    long_err = (pa.paged_attention(q1, k1, v1, t1, l1, layer=0, splits=long_splits).float()
                - pa.paged_attention_reference(q1, k1, v1, t1, l1, layer=0,
                                               window=None).float()).abs().max().item()
    long_ms = graph_ms(lambda i: pa.paged_attention(q1, k1, v1, t1, l1, layer=i % L,
                                                    splits=long_splits), n_graph)
    long_one_ms = graph_ms(
        lambda i: pa.paged_attention(q1, k1, v1, t1, l1, layer=i % L, splits=1), n_graph)
    pa.paged_attention.launches = launches_before
    long_bytes = 2 * long_len * config.kv_heads * hd * elt
    print(f"  K1 at B=1, one row of {long_len} positions: {long_ms * 1e3:.2f} us with the "
          f"shapes' {long_splits} splits, {long_one_ms * 1e3:.2f} us with 1 "
          f"({long_bytes / 1e6:.2f} MB of pages: {long_bytes / long_ms / 1e6:.1f} and "
          f"{long_bytes / long_one_ms / 1e6:.1f} GB/s), max_abs_err {long_err:.2e}",
          flush=True)
    del q1, k1, v1
    print(f"  card: {card}", flush=True)
    record = {
        "name": "paged_attention",
        "route": "cuda",
        "source": "workloads_torch/ops/csrc/paged_attention.cu",
        "replaces": "workloads/ops/paged_attention.py:56",
        "launches": launches + lifecycle_launches,
        "lifecycle_launches": lifecycle_launches,
        "max_abs_err": main_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
        "splits": splits,
        "decode_tokens_per_s": tokens_per_s,
        "drains": {name: {key: run[key] for key in
                          ("tokens_per_s", "decode_steps", "launches", "overdecoded")}
                   for name, run in drains.items()},
        "chunk_wall_ms": chunk_wall,
        "chunk_device_ms": chunk_busy,
        "chunk_graph_ms": graph_chunk_ms,
        "chunk_eager_ms": eager_chunk_ms,
        "card": card,
    }
    if not main_err <= KERNEL_ATOL["bfloat16"]:
        fail(f"K1 at the main path's shapes: max_abs_err {main_err}")
    del params, q, k, v, views, out_k, out_p, lib_out
    torch.cuda.empty_cache()
    flash_records = flash_numbers(torch, fa, f)
    torch.cuda.empty_cache()

    # 6. the training path at full width
    phase("training path: workloads_torch.train at full width")
    train_launches = train_path(torch, model_mod, train_mod, fa, counters, f)
    for rec in flash_records:
        rec["launches"] = train_launches[rec["name"]]
    print(f"  card: {card}", flush=True)
    print(json.dumps({"kernels": [record, *flash_records]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
