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
   bfloat16 and float32: K1 (paged attention) at the serving paths'
   shapes and variants (phase 4c's 8 rows to 896 positions over 17- and
   24-column tables among them), each with one split, with the split
   count the host picks and with more splits than live pages, three
   launches in a row bit-identical, and in bf16 each split count within
   one bf16 ulp of one split in every element; K2-K4 (flash attention forward, dq, dk/dv) over
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
   through the plain version, at 8 rows, at 2 (where K1 splits each
   row's pages, in bf16 too) and at 8 rows to phase 4c's depth, in float32 and in
   bfloat16, the bf16 limit being the step's own bf16 precision floor
   measured in the same run;
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
4c. the KV-cache hierarchy at the same width (``kv_phase``): 16
   conversations behind a shared 512-token system prompt, three turns
   each, through (a) no cache, (b) radix, (c) flat, (d) radix with the
   host-RAM tier in a 64-page pool, (e) (d) with the disk tier, and (a)
   and (e) with ``superstep_k=4, pipelined``: streams identical across
   arms ((a) against (b) held to the bf16 step floor if they part), the
   cache's saving, spills, reloads, demotions and disk reloads with no
   degraded put or get, 0 pages beside the index after each drain and 0
   after close, K1 n_layers a decode step dispatched, one capture an
   engine, the pools never moved; (a) and (e) in float32 token for
   token, (e) in a pool small enough to run every tier; fan-out (one
   prefill, the solo stream), a KV handoff between two engines (the
   decode engine forwards only the tails) and a preempt park (float32
   continuation exact, bf16 keeps its prefix); wall, tokens/s, prompt
   tokens, hits, spills, reloads, ms a page (a reload's copy split by
   pinned and pageable blobs) and turn TTFT printed per arm; K1 is held against its plain version at this phase's depth and
   table widths in phase 3, and a decode step at its depth gives the
   bf16 floor it holds (a) against (b) to;
4d. speculative decoding at the same width (``spec_phase``): the int8
   quantization of the same weights, made on the card, drafting at gamma
   4 for (b) spec on, (c) ``spec_lookahead=4``, (d) ``spec_superstep_k=4,
   pipelined``, (e) ``spec="auto"`` with its start-up calibration and (f)
   sampling, against (a) phase 4's plain drain; (g) float32 plain, spec
   on and ``spec_superstep_k=4``, whose streams must equal (a flip only
   at a near-tie, with its top-2 gap printed); every request ok, no page
   in use, K1 (gamma+1) x n_layers a round; one round through the
   graph and eager bit-identical in bf16 and float32; the draft steps of
   a teacher-forced round through K1 against plain; a profiled round
   (K1 counted against the trace) split by the phase probes, the
   dequantization's share of the draft phase; ``_spec_accept``'s
   marginal on the card; tokens/s, rounds, drafts proposed and
   accepted, peak memory and captures per cover printed per drain;
4f. the fleet and its control plane at the same width (``fleet_phase``,
   ``chip_smoke.FLEET``): two replicas over one copy of the weights
   behind the router: (h) two requests over the HTTP/SSE front end while
   the replicas capture their graphs, (a) ``make_fleet`` with observers
   and ledgers and (a') without on a seeded open-loop TrafficGen stream,
   (b) a replica crash with failover, (c) prefill/decode roles with the
   KV handoff, (d) the supervisor's respawn and canary, (e) the
   autoscaler 1 -> 2 -> 1, (f) the goodput controller's retune, (g) the
   journal and a restore, (i) float32 (a)-(d) and (g) against one plain
   engine; gates: one terminal status a request, no page left, K1
   n_layers a decode step on every engine an arm built and counted =
   traced on each replica, one capture a replica with and without
   observers, SSE tokens equal to the record, every ledger reconciled,
   the exposition and the merged trace well formed, event kinds in
   order; tokens/s against phase 4's drain, TTFT, router ms a step, the
   observers' overhead, failover, respawn and handoff times, replayed
   tokens and each arm's peak memory printed;
4g. device-time profiling and fast start at the same width
   (``profiling_phase``, ``chip_smoke.PROFILE``): (a) float32 drains
   observed with a ``DeviceTimeTable`` and a live ``SentryFeed`` and
   bare (streams equal, one capture each, K1 counted = traced in a
   profiled chunk beside the observer's device time for that step);
   (b) ``POST /profile?secs=2`` on a two-replica fleet behind
   ``FleetServer`` while SSE requests stream and a replica crashes and
   respawns (the trace within its byte budget names
   ``paged_decode_kernel``, the respawn captures once, a capture past
   the spent budget is refused with 409); (c) a snapshot of a warmed
   spec="auto" engine primes a fresh one (``calibration_reused`` > 0,
   float32 streams equal) and five respawns without it against five
   with it, respawn to rejoin as median, min and max; (d) the
   kernel-build cache: nvcc's build a miss in one process, found built
   a hit in a second; (e) perfbench's ``measure_serve_latency`` at the
   full scale, its keys on one line;
4h. perfbench's engine arms of the training-and-kernel slice at the
   ``tiny`` scale (``bench_engine_phase``): fault recovery, the five
   speculation arms (the engine arm at the phases arm's break-even),
   multi-LoRA, the prefix cache and the KV hierarchy, each holding the
   streams it compares equal and publishing its keys, then
   ``serve.serve_batch``'s float32 lock-step tokens against
   ``generate`` (K1 n_layers a step, no page kept);
4i. perfbench's seven fleet arms at the ``tiny`` scale
   (``bench_fleet_phase``): fleet throughput, the router's tax and
   failover, disaggregation, self-healing, autoscaling and preemption,
   KV-page scheduling, durable sessions and goodput control, every
   replica a ``ServeEngine`` on the one card; each arm's keys
   (``BENCH_FLEET_KEYS``), JAX's value checks and every compared stream
   whole (``tiny`` computes in float32; ``bench_fleet_gates``), K1
   launched and no flash kernel, each arm's seconds and peak device
   memory printed;
4j. tensor-parallel serving (``tp_phase``): phase 4's model, at 4 of
   its 8 layers (``WORLD_PHASE_LAYERS``, widths unchanged), and stream on
   a (1, 2) mesh, two ranks on the one card over gloo (NCCL refuses two
   ranks on one device; gloo stages each all-reduce through host memory,
   so the times say nothing of TP speed), each rank holding its cut of
   the weights and its kv heads of the pools and running K1 on them,
   every step eager (no CUDA graph under a mesh): float32 (a) plain, (b)
   ``superstep_k=4, pipelined``, (c) the int8 self-draft at gamma 4,
   (d) two adapters and the base, each rank's streams equal to the
   one-device engine's token for token, K1 launched on every rank in
   every arm, no page kept; one bf16 teacher-forced step within sqrt 2
   of the step's bf16 floor (max and rms from one device's float32 step;
   ``TP_BF16_FLOOR_FACTOR``) and the float32 step within ``STEP_F32_RTOL``; each rank's launches, peak
   memory and seconds printed;
4k. JAX's threefry keys (``prng_phase``, ``PRNG``): the threefry kernel
   against its plain version bit for bit in its three modes at (1,),
   (7,), (3, 5, 7), (8, 32768) and (2048, 32768) under PRNGKey(0),
   PRNGKey(42) and a split and a fold_in descendant of each; layer 0's
   w_up from PRNGKey(0) on the card within 4 ulp of the CPU's plain
   draw; phase 4's 12 requests in float32 at the serve CLI's sampling
   knobs under rng=PRNGKey(42): the graphed drain equal to the eager one
   and, on one request a slot, ``superstep_k=4, pipelined`` equal to k=1,
   token for token, K1 n_layers a decode step and threefry at least once;
   a sampled chunk from one state graphed and eager, bit-identical, both
   timed; the kernel's time at the sampled step's [8, 32768] beside its
   plain version's and its bound; the port's other draws on the card
   against the CPU's, bit for bit (``prng_draw_checks``): phase 6's
   ``train.synthetic_batch`` [8, 2048], perfbench's prompts in every
   seed form (``DRAW_PROMPT_SEEDS``), ``_prompts`` and 6f's bf16
   ``_rand_qkv`` at its shortest length;
5. time each kernel, its plain version and the closest single PyTorch
   call with CUDA events at the main paths' shapes (K1 and its library
   call as CUDA graphs: they are shorter than a launch through Python),
   beside the bound the card's memory rate and peak arithmetic rate set
   (the bf16 peak from ``perfbench.device_peak_flops``);
   two more K1 lines, batch 1 and 2 at the longest row the engine's
   table holds, with the host's split count and with one;
6. the training path, ``workloads_torch.train`` at the same model's full
   width (batch 8, seq 2048, flash attention, bf16 compute over float32
   master weights, AdamW with a bf16 first moment): steps on one fixed
   batch whose loss must fall, then steps on synthetic batches, with
   every kernel launch counted (K2 = K3 = K4 = n_layers a step; K2 twice
   that with remat); one teacher-forced step through the kernels and
   through the plain versions, loss and every gradient leaf, in float32
   and in bfloat16 against the step's bf16 floor; step time, tokens/s
   and MFU from CUDA events (``perfbench.train_step_flops`` over
   ``perfbench.device_peak_flops``); a profiled step split by kernel
   name; the attention route printed (the kernel table's pick, and the
   dense score matrix against the model's cap, which it passes, so the
   route is flash whatever the table says);
6e. the LoRA fine-tune at the same shape (``lora_train_path``);
6f. perfbench's ``measure_train``, ``measure_flash_vs_xla``,
   ``measure_window`` and ``measure_paged_decode`` at the full scale
   (``bench_kernel_phase``): K2-K4 and K1 launched; the attention
   chains' CUDA-graph replays counted in a profiled chain of replays
   (the wrappers count only the capture; a trace that drops records is
   taken again, up to 5 times) and one graphed chain equal
   to the eager chain bit for bit, from q x 2^-10 so that its links
   move q; the sweep's kernel picks through
   ``table_from_artifact`` and ``model._pick_kernel``; the arm's step
   time and MFU beside phase 6's;
6g. the training layouts (``train_parallel_phase``, ``TRAIN_PAR``): the
   same model at 4 of its 8 layers (``WORLD_PHASE_LAYERS``) on two gloo
   ranks of the one card, each arm three steps on one global batch of
   4 x 2049 tokens: (a) DP2 and (b) TP2 (``train.make_train_step(mesh=)``), (c) Ulysses and (d) ring over a
   2-rank "seq" axis (``train.make_seq_parallel_train_step``); gates per
   rank: the first float32 step's loss within 2^-16 of one device's,
   each later step's drop from the first within 2^-10 of one device's
   drop in float32 and 2^-8 in bf16 (they hold the gradient and the
   update), a control (TP2 without the enter hook) outside both, the
   bf16 per-token NLL through the arm's path within sqrt 2 of the bf16
   floor (max and rms from one device's float32, as phase 4j), the bf16
   loss falling, K2-K4 launched n_layers a step in (a)-(c) and not in
   (d); each rank's peak memory, seconds, and the ms of one all-reduce,
   all_to_all and ppermute beside the host round trip gloo makes of
   their tensors;
6h. the pipeline and expert layouts (``pp_ep_phase``, ``PP_EP``): the
   same model at 4 of its 8 layers (``WORLD_PHASE_LAYERS``) on two gloo
   ranks of the one card, each arm three float32
   and three bf16 steps on one global batch of 4 x 2049 tokens at 6g's
   learning rate: (e) PP2 (``pipeline.make_pipeline_train_step``, 2
   layers a stage, 4 microbatches of one row) against the sequential
   model on the same weights, (f) EP2 (``moe.make_moe_train_step``, 4
   experts, capacity factor 2.0, 2 experts a rank) against the whole MoE
   tree on one device; gates per rank: 6g's first float32 loss and drop
   gates, the bf16 loss falling, the replicated leaves (embed, unembed,
   and the MoE model's routers, norms and attention) bit-identical
   across the ranks, K2-K4 launched (M + S - 1) x L/S a step on a stage
   and n_layers a step on an expert rank; two controls (PP2 with the
   hand-off's backward cut, EP2 without the expert axis' f) each outside
   a drop gate; each rank's launches, peak memory, seconds, one
   hand-off's ms and one all-reduce of the combine's output;
6i. the vision CNN (``vision_phase``, ``VISION``): ``vision.main`` at
   its defaults (50 steps, batch 64, AdamW 1e-3) on the card, its loss
   falling; JAX's test procedure (30 steps on one batch of 64, the loss
   below 0.7 of the first); the card's PRNGKey(0) tree within 4 ulp of
   the CPU's, its images for seed 1 bit-identical and its labels equal;
   steps/s, the first and last loss, peak memory, the threefry launches
   of the CLI's draws (added to the threefry record's) and the seconds;
7. the sharing path (``busy_phase``, ``BUSY``), once the card is
   otherwise idle: ``workloads_torch.busy_probe`` pods time-slicing the
   one card under the cooperative chip lease, one chip, 6 s windows:
   (a) four matmul pods at replicas 4 (1024 x 1024 bf16), (b) four
   train pods at replicas 4 (BASELINE config #3), (c) two serving pods
   at replicas 2, whose decode runs K1; ``oversubscribe.run_pods`` under
   the Allocate environments the daemon gives that layout
   (``held_pod_envs``, held equal to the daemon's by a CPU test); the
   card's compute mode read first (an ``Exclusive_Process`` card fails
   the phase); gates: every pod exits 0, pods and chips as asked,
   aggregate busy fraction >= 0.90 (the JAX harness's pass condition),
   tokens in (b) and (c), K1 launched in every serving pod; each arm's
   busy fraction, tokens/s, each pod's bursts, K1 launches and peak
   memory, and seconds printed; then one burst of each workload built
   in this process after the pods, profiled, its host wall against its
   kernels' device time (``busy`` counts lease-held host time, as JAX's
   does: a launch-bound burst can be busy while the device idles); K1's
   record carries the serve burst's launches as ``busy_launches`` and
   the serving pods' as ``busy_pod_launches``.

Every launch count held against a profiler trace (phases 4, 4d, 4e,
4f, 4g, 6f) takes the trace again, up to ``TRACE_ATTEMPTS`` times, when
it comes up short: a trace can drop kernel records and never adds any,
so one complete trace proves the count and a trace over it fails.
Every phase's wall seconds are printed on a line of their own
(``-- phase seconds``), and the whole run's before the last two lines.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
the line before it holds the per-kernel numbers as JSON.  Without a CUDA
device, or without the rest of the repo beside it, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published device memory rate (NVIDIA data sheet).  The dense
# bf16 tensor-core peak the bounds and MFU use is the port's own table,
# ``workloads_torch.perfbench.device_peak_flops``.
HBM_BYTES_PER_S = 3.35e12

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
# (14.99, 24.37, 45.45, 35.53, 100.77 over 5 steps on the H100).  1e-4
# made the torch.Generator-drawn weights learn, but drove JAX's
# PRNGKey(0) weights up too (15.09, 15.68, 16.31, 16.74, 16.04; NVIDIA
# H100 80GB HBM3, 700 W), as it did phase 6g's batch (TRAIN_PAR_LR).
TRAIN_LR = 3e-5
TRAIN_F32_GRAD_SHARE = 1e-3
# A profiler trace can drop kernel records (a profiled adapted chunk once
# traced 470 of 512 K1 launches) and never adds any: a count checked
# against a trace takes the trace again, up to this many times, when it
# comes up short.
TRACE_ATTEMPTS = 5
# Phases 4j, 6g and 6h spawn two gloo ranks on the card and take the
# longest; they run at this depth of the model's 8 layers, widths
# unchanged, so the whole run ends inside its 20 minutes.
WORLD_PHASE_LAYERS = 4
T_START = time.perf_counter()

FULL = dict(
    d_model=2048, n_heads=16, n_layers=8, d_ff=8192, vocab_size=32768,
    page_size=64, decode_prompt=32, decode_lens=(64, 512), slots=8,
    train_batch=8, train_seq=2048, lifecycle_new=(64, 192, 128), lifecycle_requests=12,
    lifecycle_chunk=16,
)
# Phase 4c, the KV-cache hierarchy: 16 conversations behind one 512-token
# system prompt (8 pages), three turns of 64 user tokens and 64 generated
# ones; hits come in 2-page steps (prompt_bucket 128).  (d) runs a 64-page
# pool (256 MiB) with a 48-page host tier, (e) a 16-page host tier over
# the disk tier.  The float32 (e) arm serves 4 conversations, which need
# about 32 pages: a 20-page pool (160 MiB) over a 4-page host tier makes
# it spill, reload, demote and reload from disk.
KV = dict(max_seq_len=1024, page_size=64, prompt_bucket=128, slots=8, chunk=64, system=512,
          user=64, new=64, conversations=16, turns=3, n_pages=64, host_pages=48,
          disk_host_pages=16, f32_conversations=4, f32_n_pages=20, f32_host_pages=4,
          fanout=4, handoff=4)
# The lifecycle phase's scheduled faults: the crossing of each engine seam
# that fires, mid-drain in both of its modes.
LIFECYCLE_FAULTS = {"prefill_dispatch": [2], "prefill_readback": [3],
                    "decode_dispatch": [3], "decode_readback": [4]}


def prng_key(seed: int, device):
    """``prng.PRNGKey(seed)`` on ``device``: JAX's threefry key, so a seed
    gives the JAX package's weights and draws."""
    from workloads_torch import prng

    return prng.PRNGKey(seed, device=device)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# The phase in progress and when it began (``phase``, ``end_phase``).
_CURRENT_PHASE: list = []


def end_phase() -> None:
    """Print the phase in progress's wall seconds on a line of its own."""
    if _CURRENT_PHASE:
        name, t0 = _CURRENT_PHASE.pop()
        print(f"-- phase seconds {time.perf_counter() - t0:.1f}: {name}", flush=True)


def phase(name: str) -> None:
    end_phase()
    print(f"== {name}", flush=True)
    _CURRENT_PHASE.append((name, time.perf_counter()))


def ptxas_report(log: str) -> list[tuple[str, str, int]]:
    """One row per kernel instance from ``ptxas -v``'s report: its name
    and template arguments (read from the mangled name), the report's
    registers-and-spills text, and its spill-store bytes."""
    import re

    rows, kernel, spills, stores = [], "?", "", 0
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"(?<=\d)((?:flash|paged)_\w+?_kernel)I"
                          r"((?:Li\d+E|Lb[01]E|13__nv_bfloat16|f)+)E", line)
            if m:
                args = [n or {"0": "false", "1": "true"}.get(b) or ("bf16" if bf else "float")
                        for n, b, bf, _ in re.findall(r"Li(\d+)E|Lb([01])E|(13__nv_bfloat16)|(f)",
                                                      m.group(2))]
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
                 lengths, layers, dtype, seed, width=None):
    """Random q and pools, and a shuffled table covering each row
    (``width`` columns, by default as many as the longest row needs)."""
    g = torch.Generator("cuda").manual_seed(seed)
    max_pages = width or max(1, -(-max(lengths) // page_size))
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
    # Phase 4c decodes 8 rows to 896 positions (turn-3 prompts of 832
    # tokens plus 64 new) over tables as wide as its engines' max_pages:
    # 17 columns at the defaults, 24 with superstep_k=4 pipelined.
    kv_ragged = [896, 0, 1, 64, 577, 704, 833, 895]
    kv_widths = [-(-(KV["max_seq_len"] + KV["chunk"] * steps) // KV["page_size"])
                 for steps in (1, 4 * 2)]
    cases = [
        *((f"phase 4c, {w}-page tables", dict(heads=16, kv_heads=16, head_dim=128,
                                              page_size=64, lengths=kv_ragged, layers=8,
                                              width=w), None) for w in kv_widths),
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
        # Phase 7's serving pods: busy_probe's engine, 2 slots of a
        # 16-token prompt and 32 new tokens over 9-page tables.
        ("phase 7 serve hd=64 ps=8", dict(heads=4, kv_heads=4, head_dim=64, page_size=8,
                                          lengths=[47, 16], layers=2, width=9), None),
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
                                      tables.shape[1], sm_count)
            errs, outs = {}, {}
            for splits in (1, picked, tables.shape[1] + 3):
                runs = [pa.paged_attention(q, k, v, tables, lens, layer=layer,
                                           window=window, splits=splits)
                        for _ in range(3)]
                torch.cuda.synchronize()
                got = outs[splits] = runs[0]
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
            if dtype == torch.bfloat16:
                # Every share rounds p against the row's running max, so a
                # split differs from one split only by the order of float32
                # sums: at most one bf16 ulp in any element.
                counts = []
                for splits in sorted(set(outs) - {1}):
                    diff = (outs[splits].float() - outs[1].float()).abs()
                    over = int((diff > bf16_ulp(torch, outs[splits], outs[1])).sum())
                    counts.append(f"{splits} splits {int((diff > 0).sum())} differ, {over} by "
                                  f"more than one ulp")
                    if over:
                        fail(f"K1 bf16 at {splits} splits differs from one split by more than "
                             f"one bf16 ulp in {over} elements: {name}")
                print(f"  K1 {name:24s} bf16 against 1 split, of {outs[1].numel()} elements: "
                      + "; ".join(counts), flush=True)


def bf16_ulp(torch, a, b):
    """One bf16 ulp at the larger of |a| and |b|, elementwise."""
    larger = torch.maximum(a.float().abs(), b.float().abs())
    return torch.ldexp(torch.ones_like(larger), torch.frexp(larger).exponent - 8)


def profile_chunk(torch, engine, rng, f, pa, adapters=(None,)):
    """Where one decode chunk's time goes: torch.profiler over one engine
    step with every slot decoding, read from its chrome trace (device
    kernels by name, their summed time against the step's wall time).
    K1's launch count over the step must be n_layers x chunk and equal
    the profiler's count of its kernel.  A trace can drop kernel records
    and never adds any, so a trace short of the count is taken again on
    fresh requests, up to TRACE_ATTEMPTS times; a trace over it fails.
    The slots' requests take ``adapters`` round-robin.  Returns (wall
    ms, device ms, K1 counted, K1 traced, {kernel name: [ms, ...]}, the
    profiled step's ordinal among the engine steps this call took)."""
    from torch.profiler import ProfilerActivity, profile

    want = engine.config.n_layers * engine.chunk
    steps = 0
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        for i in range(f["slots"]):
            engine.submit(rng.integers(0, engine.config.vocab_size, f["decode_prompt"]),
                          3 * engine.chunk, adapter=adapters[i % len(adapters)])
        engine.step()  # admission and a first chunk, outside the window
        torch.cuda.synchronize()
        before = pa.paged_attention.launches
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            t0 = time.perf_counter()
            engine.step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        steps += 2
        profiled_step = steps
        counted = pa.paged_attention.launches - before
        trace = os.path.join(ROOT, "build", "workloads_torch", "decode_chunk_trace.json")
        prof.export_chrome_trace(trace)
        with open(trace) as fh:
            events = json.load(fh)["traceEvents"]
        by_name: dict[str, list] = {}
        for e in events:
            if e.get("cat") == "kernel":
                by_name.setdefault(e["name"], []).append(e["dur"] / 1e3)
        while not engine.idle:
            engine.step()
            steps += 1
        traced = sum(len(v) for name, v in by_name.items() if "paged_decode_kernel" in name)
        busy_ms = sum(sum(v) for v in by_name.values())
        print(f"  K1 launches over the profiled chunk (trace {attempt}): counted {counted}, "
              f"kernels in the profiler's trace {traced}", flush=True)
        if busy_ms == 0:
            fail("profiled decode chunk: no kernel events in the trace (device time not "
                 "measured, K1's count unchecked)")
        if counted != want or traced > counted:
            fail(f"K1 counted {counted} launches over the profiled chunk, the trace shows "
                 f"{traced}, n_layers x chunk is {want}")
        if traced == counted:
            break
    else:
        fail(f"none of {TRACE_ATTEMPTS} traces of a profiled chunk shows K1's {want} "
             f"launches")
    lora = " with adapters" if engine._stacked_adapters is not None else ""
    print(f"  profiled decode chunk{lora} ({engine.chunk} steps, {f['slots']} rows, CUDA "
          f"graph replays): wall {wall_ms:.3f} ms, device kernels {busy_ms:.3f} ms, device "
          f"idle share {1 - busy_ms / wall_ms:.3f}", flush=True)
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:8]
    for name, durs in top:
        print(f"    {sum(durs):9.3f} ms {len(durs):6d} launches  {name[:90]}",
              flush=True)
    return wall_ms, busy_ms, counted, traced, by_name, profiled_step


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


def teacher_forced_step(torch, paged_mod, pa, params, config, ps, lengths, width=None,
                        lora=None):
    """Prefill rows of the given lengths, then run one decode step through
    the kernel (with the host's split count) and, on a copy
    of the pools, through the plain version, over decode tables padded
    with the trash page to ``width`` columns (by default one); ``lora``
    adapts the prefill and both steps per row.  Returns (kernel logits,
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
            cover_pages=cover, emit=False, lora=lora,
        )
        tok = torch.randint(0, config.vocab_size, (len(lengths),), generator=g,
                            device="cuda")
        # Padding columns on the trash page, as the engine's tables carry.
        pad = (width or cover + 1) - cover
        tables_dec = torch.cat(
            [tables, torch.full((len(lengths), pad), n_pages, dtype=torch.int32,
                                device="cuda")], dim=1).contiguous()
        ref_pools = (pools[0].clone(), pools[1].clone())

        def kernel(q, kp, vp, t, ln, layer):
            return pa.paged_attention(q, kp, vp, t, ln, layer=layer,
                                      window=config.attention_window)

        got, _ = paged_mod._decode_core(params, pools, tables_dec, tok,
                                        lens.long(), config, attention_fn=kernel, lora=lora)

        def plain(q, kp, vp, t, ln, layer):
            return pa.paged_attention_reference(q, kp, vp, t, ln, layer=layer,
                                                window=config.attention_window)

        want, _ = paged_mod._decode_core(params, ref_pools, tables_dec, tok,
                                         lens.long(), config, attention_fn=plain, lora=lora)
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


def kv_phase(torch, params, config, kv, counters, bf16_floor, device="cuda") -> int:
    """Phase 4c: the KV-cache hierarchy at the serving path's width.
    ``kv["conversations"]`` conversations behind one shared system
    prompt, ``kv["turns"]`` turns each (a turn's prompt is the last one
    plus its reply and new user tokens, submitted after the last turn
    drains), served by arms (a) no cache, (b) radix, (c) flat, (d) radix
    with the host-RAM tier under a small pool, (e) (d) with the disk
    tier under a smaller host budget, and (a) and (e) again with
    ``superstep_k=4, pipelined``; then fan-out, a KV handoff between two
    engines and a preempt park.  Gates: statuses, pages after each drain
    and after close, streams across arms, the cache's saving, spills,
    reloads, demotions and disk reloads without a degraded put or get,
    K1 n_layers a decode step dispatched, one graph capture an engine and
    the pools' addresses unchanged; a float32 (a) and (e), the latter in a
    ``kv["f32_n_pages"]`` pool through every tier, token for token.
    ``device="cpu"`` rehearses it at a tiny width.  Returns K1's launches
    over the phase."""
    import shutil
    import statistics
    import tempfile
    from dataclasses import replace

    import numpy as np
    from workloads_torch import serve as serve_mod
    from workloads_torch.model import cast_params
    from workloads_torch.serve import ServeEngine

    cuda = device == "cuda"
    # A reload's host time by blob: a pinned blob (from host RAM) goes up
    # queued on the stream, a pageable one (read from disk) is copied
    # before write_page returns, behind whatever the stream runs first.
    # The engine's only write_page call is its reload's.
    plain_write_page, writes = serve_mod.write_page, {}

    def timed_write_page(pools, k, v, dst):
        t0 = time.perf_counter()
        out = plain_write_page(pools, k, v, dst)
        n, s = writes.get(k.is_pinned(), (0, 0.0))
        writes[k.is_pinned()] = (n + 1, s + time.perf_counter() - t0)
        return out

    serve_mod.write_page = timed_write_page
    configs = {torch.bfloat16: replace(config, max_seq_len=kv["max_seq_len"])}
    configs[torch.float32] = replace(configs[torch.bfloat16], dtype=torch.float32)
    weights = {torch.bfloat16: params}
    L, V, new = config.n_layers, config.vocab_size, kv["new"]
    rng = np.random.default_rng(0)
    system = rng.integers(0, V, kv["system"]).tolist()
    users = [[rng.integers(0, V, kv["user"]).tolist() for _ in range(kv["conversations"])]
             for _ in range(kv["turns"])]
    base = dict(slots=kv["slots"], page_size=kv["page_size"], prompt_bucket=kv["prompt_bucket"],
                chunk=kv["chunk"], device=device)
    offload = dict(prefix_cache=True, kv_offload=True, n_pages=kv["n_pages"],
                   kv_host_pages=kv["host_pages"])
    root = tempfile.mkdtemp(prefix="kv_phase_")
    disk = dict(offload, kv_host_pages=kv["disk_host_pages"])
    disk_f32 = dict(offload, n_pages=kv["f32_n_pages"], kv_host_pages=kv["f32_host_pages"],
                    kv_disk_dir=os.path.join(root, "f32"))
    reset_counts(counters)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def engine_for(dtype, kw):
        if dtype not in weights:
            weights[dtype] = cast_params(params, dtype)
        e = ServeEngine(weights[dtype], configs[dtype], **base, **kw)
        return e, [p.data_ptr() for p in e.pools], counters["paged_attention"].launches

    def finish(label, e, ptrs, before):
        """Gates every engine shares, then close: 0 pages in use."""
        launches = counters["paged_attention"].launches - before
        if cuda and launches != L * e.chunks_run * e.chunk:
            fail(f"kv {label}: K1 launched {launches} times, n_layers x decode steps "
                 f"dispatched is {L * e.chunks_run * e.chunk}")
        captures = e._graph.captures if e._graph is not None else 0
        if cuda and captures != min(1, e.chunks_run):
            fail(f"kv {label}: {captures} graph captures after {e.chunks_run} chunks")
        held = [[p.data_ptr() for p in e.pools]]
        if e._graph is not None:
            held.append([p.data_ptr() for p in e._graph.pools])
        if any(h != ptrs for h in held):
            fail(f"kv {label}: the pools moved (data_ptr changed)")
        e.close()
        if e.ctrl.used_pages:
            fail(f"kv {label}: {e.ctrl.used_pages} pages in use after close()")

    def drained(label, e, rids, served, want_new):
        for rid in rids:
            req = next((r for r in e.completed if r.rid == rid), None)
            if req is None or req.status != "ok" or len(served.get(rid, ())) != want_new:
                fail(f"kv {label} {rid}: {None if req is None else req.status}, "
                     f"{len(served.get(rid, ()))} tokens, wanted {want_new}")
        cached = e.prefix.cached_pages if e.prefix is not None else 0
        if e.ctrl.used_pages != cached:
            fail(f"kv {label}: {e.ctrl.used_pages} pages in use after the drain, the prefix "
                 f"index holds {cached}")

    def conversations(label, dtype, kw, n_conv):
        e, ptrs, before = engine_for(dtype, kw)
        writes.clear()
        prompts = [system + users[0][c] for c in range(n_conv)]
        out = {"prompts": [], "streams": [], "wall": 0.0, "ttft": []}
        for turn in range(kv["turns"]):
            rids = [e.submit(p, new) for p in prompts]
            sync()
            t0 = time.perf_counter()
            served = e.run()
            sync()
            out["wall"] += time.perf_counter() - t0
            drained(f"{label} turn {turn + 1}", e, rids, served, new)
            reqs = {r.rid: r for r in e.completed}
            out["ttft"].append(statistics.median(reqs[r].ttft_secs for r in rids))
            out["prompts"].append(prompts)
            out["streams"].append([served[r] for r in rids])
            if turn + 1 < kv["turns"]:
                prompts = [p + s + u for p, s, u in zip(prompts, out["streams"][-1],
                                                        users[turn + 1])]
        p = e.prefix
        get = (lambda n: getattr(p, n, 0)) if p is not None else (lambda n: 0)
        out.update(prefill_tokens=e.prefill_tokens, tokens=e.generated_tokens,
                   spills=get("spills"), reloads=get("reloads"), demotions=get("demotions"),
                   disk_reloads=get("disk_reloads"), hits=get("hits"), misses=get("misses"),
                   spill_s=e.kv_spill_s, reload_s=e.kv_reload_s,
                   put_s=e._kv_disk.put_s if e._kv_disk is not None else 0.0,
                   get_s=e._kv_disk.get_s if e._kv_disk is not None else 0.0,
                   degraded=(e._kv_disk.write_failures + e._kv_disk.read_corrupt)
                   if e._kv_disk is not None else 0,
                   pinned=writes.get(True, (0, 0.0)), pageable=writes.get(False, (0, 0.0)))
        per = lambda s, n: f"{s / n * 1e3:.3f}" if n else "-"  # noqa: E731
        print(f"  kv {label} [{str(dtype).split('.')[1]}, {n_conv} conversations x "
              f"{kv['turns']} turns]: wall {out['wall']:.3f} s, decode tokens/s "
              f"{out['tokens'] / out['wall']:.1f}, prompt tokens forwarded "
              f"{out['prefill_tokens']}, hits {out['hits']} misses {out['misses']}, spills "
              f"{out['spills']} reloads {out['reloads']} demotions {out['demotions']} disk "
              f"reloads {out['disk_reloads']}, kv_spill_s {out['spill_s']:.4f} "
              f"({per(out['spill_s'], out['spills'])} ms a page) kv_reload_s "
              f"{out['reload_s']:.4f} (copies up: {out['pinned'][0]} pinned blobs "
              f"{per(out['pinned'][1], out['pinned'][0])} ms a page, {out['pageable'][0]} "
              f"pageable {per(out['pageable'][1], out['pageable'][0])} ms a page), "
              f"disk writes {per(out['put_s'], out['demotions'])} and reads "
              f"{per(out['get_s'], out['disk_reloads'])} ms a page, "
              f"turn TTFT medians ms {[round(t * 1e3, 2) for t in out['ttft']]}", flush=True)
        finish(label, e, ptrs, before)
        return out

    def first_divergence(x, y):
        for turn, (sx, sy) in enumerate(zip(x["streams"], y["streams"])):
            for c, (a, b) in enumerate(zip(sx, sy)):
                if a != b:
                    i = next(i for i, (p, q) in enumerate(zip(a, b)) if p != q)
                    return turn, c, i
        return None

    def prefill_gap(tokens, warm):
        """max |logit| difference of one prompt's prefill without a cache
        and with the cached pages ``warm``'s admission wrote."""
        logits = []
        for kw in ({}, {"prefix_cache": True}):
            e = ServeEngine(params, configs[torch.bfloat16], **base, **kw)
            if kw:
                e.submit(warm, 1)
                e.run()
            seq = ("probe",)
            start = e._prefix_admit_pages(seq, tokens)
            logits.append(e._run_prefill(e._table_dev(seq), tokens, start).float())
            e.ctrl.release(seq)
            e.close()
        return (logits[0] - logits[1]).abs().max().item()

    bf16, f32 = torch.bfloat16, torch.float32
    n = kv["conversations"]
    runs = {
        "a": conversations("(a) no cache", bf16, {}, n),
        "b": conversations("(b) radix", bf16, {"prefix_cache": True}, n),
        "c": conversations("(c) flat", bf16, {"prefix_cache": "flat"}, n),
        "d": conversations("(d) radix + host RAM", bf16, offload, n),
        "e": conversations("(e) radix + host RAM + disk", bf16,
                           dict(disk, kv_disk_dir=os.path.join(root, "e")), n),
    }
    k4 = dict(superstep_k=4, pipelined=True)
    runs["a k4"] = conversations("(a) no cache, superstep_k=4 pipelined", bf16, k4, n)
    runs["e k4"] = conversations("(e) + disk, superstep_k=4 pipelined", bf16,
                                 dict(disk, kv_disk_dir=os.path.join(root, "e4"), **k4), n)
    for x, y in (("c", "b"), ("d", "b"), ("e", "b"), ("a k4", "a"), ("e k4", "e")):
        if runs[x]["streams"] != runs[y]["streams"]:
            fail(f"kv: the streams of arm {x} differ from arm {y}'s at (turn, conversation, "
                 f"token) {first_divergence(runs[x], runs[y])}")
    split = first_divergence(runs["a"], runs["b"])
    if split is None:
        print(f"  kv: the streams of (a) and (b), (c), (d), (e) are identical token for token, "
              f"and (a) and (e) with superstep_k=4 pipelined equal them", flush=True)
    else:
        turn, c, i = split
        tokens = runs["a"]["prompts"][turn][c] + runs["a"]["streams"][turn][c][:i]
        warm = runs["a"]["prompts"][turn - 1][c] if turn else system + users[0][c]
        gap = prefill_gap(tokens, warm)
        print(f"  kv: (a) and (b) first diverge at turn {turn + 1}, conversation {c}, token "
              f"{i}; teacher-forced max |dlogit| there {gap:.4e}, the bf16 step floor "
              f"{bf16_floor:.4e}", flush=True)
        if not gap <= bf16_floor:
            fail("kv: the cached prefix moves the logits past the bf16 step floor")
    a, b, d, e = runs["a"], runs["b"], runs["d"], runs["e"]
    if not (b["prefill_tokens"] < a["prefill_tokens"] and b["hits"] > 0):
        fail(f"kv: radix forwarded {b['prefill_tokens']} prompt tokens against "
             f"{a['prefill_tokens']} uncached, {b['hits']} hits")
    if not (d["spills"] > 0 and d["reloads"] > 0):
        fail(f"kv (d): {d['spills']} spills, {d['reloads']} reloads")

    def every_tier(label, r):
        if not (r["spills"] > 0 and r["reloads"] > 0 and r["demotions"] > 0
                and r["disk_reloads"] > 0) or r["degraded"]:
            fail(f"kv {label}: {r['spills']} spills, {r['reloads']} reloads, {r['demotions']} "
                 f"demotions, {r['disk_reloads']} disk reloads, {r['degraded']} degraded puts "
                 f"or gets")

    for key in ("e", "e k4"):
        every_tier(f"({key})", runs[key])
    print(f"  kv: prompt tokens forwarded, radix {b['prefill_tokens']} against "
          f"{a['prefill_tokens']} uncached; turn-2 TTFT median {b['ttft'][1] * 1e3:.2f} ms "
          f"radix, {a['ttft'][1] * 1e3:.2f} ms uncached; host seconds in spills "
          f"{runs['e k4']['spill_s']:.4f} with superstep_k=4 pipelined, "
          f"{e['spill_s']:.4f} at the defaults ((e) arms; turn-2 prompts of "
          f"{len(b['prompts'][1][0])} tokens)", flush=True)

    # float32: (a) and (e) on fewer conversations, token for token, (e)
    # in a pool small enough that every tier runs.
    fa_, fe = (conversations(label, f32, kw, kv["f32_conversations"]) for label, kw in
               (("(a) no cache", {}), (f"(e) radix + host RAM + disk, {kv['f32_n_pages']}-page "
                                       f"pool", disk_f32)))
    every_tier("float32 (e)", fe)
    if fa_["streams"] != fe["streams"]:
        fail(f"kv float32: (e) differs from (a) at {first_divergence(fa_, fe)}")
    print(f"  kv float32: (a) and (e) identical over {kv['f32_conversations']} conversations, "
          f"(e) through every tier", flush=True)

    # Fan-out: one prefill for the group, every member the solo stream.
    e_, ptrs, before = engine_for(bf16, {})
    prompt = system + users[0][0]
    rids = e_.submit_fanout(prompt, new, n_samples=kv["fanout"])
    served = e_.run()
    drained("fan-out", e_, rids, served, new)
    solo = a["streams"][0][0]
    print(f"  kv fan-out: {kv['fanout']} members, {e_.prefills_run} prefill run, streams "
          f"{'equal the solo stream' if all(served[r] == solo for r in rids) else 'DIFFER'}",
          flush=True)
    if e_.prefills_run != 1 or any(served[r] != solo for r in rids):
        fail("kv fan-out: not one prefill, or a member's stream differs from the solo one")
    finish("fan-out", e_, ptrs, before)

    # Handoff: a prefill engine exports, a decode engine imports and serves.
    prompts = [system + users[0][c] for c in range(kv["handoff"])]
    src, src_ptrs, src_before = engine_for(bf16, dict(prefix_cache=True, kv_offload=True))
    rids = [src.submit(p, 1) for p in prompts]
    drained("handoff prefill", src, rids, src.run(), 1)
    tickets = [src.export_kv(p) for p in prompts]
    finish("handoff prefill", src, src_ptrs, src_before)
    dst, ptrs, before = engine_for(bf16, dict(prefix_cache=True, kv_offload=True))
    for p, t in zip(prompts, tickets):
        dst.import_kv(p, t)
    rids = [dst.submit(p, new) for p in prompts]
    served = dst.run()
    drained("handoff decode", dst, rids, served, new)
    ps, bp = kv["page_size"], kv["prompt_bucket"] // kv["page_size"]
    distinct = len({tuple(p[: (i + 1) * ps]) for p in prompts for i in range(len(p) // ps)})
    starts = [min(len(p) // ps, (len(p) - 1) // ps // bp * bp) // bp * bp for p in prompts]
    tail = sum(len(p) - s * ps for p, s in zip(prompts, starts))
    # A page the first admission reloads is resident for the next.
    reloads = len({tuple(p[: (i + 1) * ps]) for p, s in zip(prompts, starts) for i in range(s)})
    out_s = src.kv_handoff_s + src.kv_spill_s
    print(f"  kv handoff: {src.kv_handoff_pages_out} pages out in {len(tickets)} tickets "
          f"({out_s / max(1, src.kv_handoff_pages_out) * 1e3:.3f} ms a page, spills included), "
          f"{dst.kv_handoff_pages_in} distinct pages in ({dst.kv_handoff_s / max(1, dst.kv_handoff_pages_in) * 1e3:.3f} ms a page), "
          f"{dst.prefix.reloads} reloaded ({dst.kv_reload_s / max(1, dst.prefix.reloads) * 1e3:.3f} "
          f"ms a page); the decode engine forwarded {dst.prefill_tokens} prompt tokens "
          f"(the tails past the grafted pages: {tail})", flush=True)
    if not (dst.kv_handoff_pages_in == distinct and src.kv_handoff_pages_out == sum(
            len(p) // ps for p in prompts)):
        fail(f"kv handoff: {src.kv_handoff_pages_out} pages out, {dst.kv_handoff_pages_in} in, "
             f"wanted every path's pages out and each of the {distinct} distinct pages in")
    if [served[r] for r in rids] != b["streams"][0][: len(prompts)]:
        fail("kv handoff: the decode engine's streams differ from a single engine's")
    if dst.prefill_tokens != tail or dst.prefix.reloads != reloads:
        fail(f"kv handoff: forwarded {dst.prefill_tokens} prompt tokens and reloaded "
             f"{dst.prefix.reloads} pages, wanted {tail} and {reloads}")
    finish("handoff decode", dst, ptrs, before)

    # Park: preempt a running turn-2 request under arm (d), resubmit.
    for dtype, prompt in ((bf16, d["prompts"][1][0]), (f32, fe["prompts"][1][0])):
        budget = 2 * new
        ref_e, ref_ptrs, ref_before = engine_for(dtype, offload)
        ref_rid = ref_e.submit(prompt, budget)
        ref_served = ref_e.run()
        drained("park reference", ref_e, [ref_rid], ref_served, budget)
        whole = ref_served[ref_rid]
        finish("park reference", ref_e, ref_ptrs, ref_before)
        e_, ptrs, before = engine_for(dtype, offload)
        rid = e_.submit(prompt, budget)
        e_.step()
        got = e_.preempt(rid)
        if got is None or not 0 < len(got.tokens) < budget:
            fail(f"kv park: preempt returned {got}")
        parked, kept = e_.pages_parked, list(got.tokens)
        rest = e_.submit(prompt + kept, budget - len(kept))
        served = e_.run()
        drained("park resume", e_, [rest], served, budget - len(kept))
        stream = kept + served[rest]
        same = next((i for i, (x, y) in enumerate(zip(stream, whole)) if x != y), len(whole))
        print(f"  kv park [{str(dtype).split('.')[1]}]: {parked} pages parked, "
              f"{e_.prefix.reloads} reloaded at the resume, {len(kept)} tokens kept; the "
              f"resumed stream equals the uninterrupted one for {same} of {len(whole)} tokens",
              flush=True)
        if parked == 0 or kept != whole[: len(kept)]:
            fail("kv park: nothing parked, or the kept tokens differ from the uninterrupted "
                 "stream")
        if dtype == f32 and stream != whole:
            fail("kv park: the float32 continuation differs from the uninterrupted stream")
        finish("park", e_, ptrs, before)
    weights.pop(f32, None)
    serve_mod.write_page = plain_write_page
    shutil.rmtree(root, ignore_errors=True)
    if cuda:
        torch.cuda.empty_cache()
    return read_counts(counters)["paged_attention"]


# Phase 4d, speculative decoding: the JAX CLI's --spec-int8-draft (the
# model's own int8 quantization drafting for it) at gamma 4; lookahead
# and chained supersteps at k 4; the float32 arm serves 8 requests of 64
# and 128 new tokens.  A float32 stream may part from the plain stream
# only where the target's top two logits lie within FLIP_GAP of the
# largest logit (a reordering of a near-tie, not a wrong token).
SPEC = dict(gamma=4, k=4, f32_requests=8, f32_new=(64, 128), temperature=0.8, top_k=50,
            top_p=0.95)
FLIP_GAP = 2.0**-20
SPEC_F32_RTOL = 1e-5


def profiled(torch, fn, name):
    """Run ``fn`` under torch.profiler; returns (result, wall ms, device
    kernel ms, {kernel name: [ms, ...]}) from its chrome trace."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    trace = os.path.join(ROOT, "build", "workloads_torch", f"{name}_trace.json")
    prof.export_chrome_trace(trace)
    with open(trace) as fh:
        events = json.load(fh)["traceEvents"]
    by_name: dict[str, list] = {}
    for e in events:
        if e.get("cat") == "kernel":
            by_name.setdefault(e["name"], []).append(e["dur"] / 1e3)
    busy_ms = sum(sum(v) for v in by_name.values())
    return out, wall_ms, busy_ms, by_name


def dense_logits(torch, params, config, seq):
    """The model's next-token logits after ``seq`` (a dense forward)."""
    from workloads_torch.model import forward

    tokens = torch.tensor([list(seq)], device=params["embed"].device)
    with torch.inference_mode():
        return forward(params, tokens, config)[0, -1].float()


def top2_gap(torch, params, config, prompt, tokens, pos):
    """The target's top-two logit gap before generated token ``pos`` (a
    dense forward over the prompt and the tokens before it), and the
    largest |logit| there."""
    logits = dense_logits(torch, params, config, list(prompt) + list(tokens[:pos]))
    top = torch.topk(logits, 2).values
    return (top[0] - top[1]).item(), logits.abs().max().item()


def spec_phase(torch, params, config, f, counters, requests, plain, bf16_floor,
               device="cuda", spec=SPEC) -> int:
    """Phase 4d: speculative decoding at full width.  The draft is
    ``quant.quantize_params(params)``, made on the card (the JAX CLI's
    --spec-int8-draft), gamma 4.  Drains of phase 4's 12 requests: (a)
    plain (``plain``, phase 4's drain at the defaults), (b) spec on, (c)
    ``spec_lookahead=4``, (d) ``spec_superstep_k=4, pipelined``, (e)
    ``spec="auto"`` with the start-up calibration, (f) sampling
    (temperature 0.8, top_k 50, top_p 0.95, spec on); (g) the same widths
    in float32 on 8 requests, plain, spec on and ``spec_superstep_k=4``.
    Gates: every request ``ok`` at full length and no page in use after
    each drain; K1 launched n_layers a plain decode step and (gamma+1) x
    draft layers a round; (g)'s spec streams equal its plain stream (a
    flip only at a top-2 gap under FLIP_GAP of the largest logit); one
    graphed round equal to the eager round from the same state, bit for
    bit, in bf16 and float32; one teacher-forced round's draft steps
    through K1 against the plain version (bf16 within ``bf16_floor``,
    float32 within 1e-5 of the largest logit); K1's count over a profiled
    round equal to the trace's; ``_spec_accept``'s marginal on the card.
    ``device="cpu"`` rehearses the drains and gates on the plain route
    (``spec`` may shrink (g)'s requests to a tiny model's context).
    Returns K1's launches over the drains."""
    from dataclasses import replace

    import numpy as np
    from workloads_torch import paged as paged_mod
    from workloads_torch.model import cast_params
    from workloads_torch.ops import paged_attention as pa
    from workloads_torch.quant import dequantize, is_quantized, quantize_params, tree_bytes
    from workloads_torch.serve import ServeEngine

    cuda = device == "cuda"
    g, k, L = spec["gamma"], spec["k"], config.n_layers

    def sync():
        if cuda:
            torch.cuda.synchronize()

    draft = quantize_params(params)
    t_bytes, d_bytes = tree_bytes(params), tree_bytes(draft)
    print(f"  int8 draft: tree_bytes {d_bytes / 1e9:.4f} GB against the bf16 target's "
          f"{t_bytes / 1e9:.4f} GB ({d_bytes / t_bytes:.3f})", flush=True)
    base = dict(slots=f["slots"], page_size=f["page_size"], chunk=f["page_size"], device=device)
    total = 0

    def spec_drain(label, engine, reqs, ref=None):
        """Serve ``reqs`` after one warm-up request (captures, and the
        calibration of spec="auto"); gate and print the drain."""
        nonlocal total
        engine.submit(reqs[0][0], 2)
        engine.run()
        names = ("chunks_run", "generated_tokens", "spec_rounds", "spec_drafts_proposed",
                 "spec_tokens_rejected", "tokens_overdecoded", "spec_mode_steps",
                 "plain_mode_steps")
        before = {n: getattr(engine, n, 0) for n in names}
        rids = [engine.submit(p, n) for p, n in reqs]
        reset_counts(counters)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        sync()
        t0 = time.perf_counter()
        served = engine.run()
        sync()
        wall = time.perf_counter() - t0
        d = {n: getattr(engine, n, 0) - before[n] for n in names}
        launches = read_counts(counters)["paged_attention"]
        total += launches
        plain_steps = d["chunks_run"] * engine.chunk
        d_layers = engine.draft_config.n_layers if engine.draft_params is not None else 0
        expected = L * plain_steps + d_layers * (g + 1) * d["spec_rounds"]
        row_rounds = d["spec_drafts_proposed"] // g if g else 0
        accepted = d["spec_drafts_proposed"] - d["spec_tokens_rejected"]
        peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else 0.0
        rate = d["generated_tokens"] / wall
        out = {"streams": [served.get(r) for r in rids], "wall": wall, "tokens_per_s": rate,
               "rounds": d["spec_rounds"], "proposed": d["spec_drafts_proposed"],
               "accepted": accepted, "launches": launches, "peak_gib": peak,
               "plain_steps": plain_steps}
        covers = (dict(engine._spec_graph.captures_by_cover)
                  if getattr(engine, "_spec_graph", None) is not None else {})
        vs = f" ({rate / ref:.3f} of (a))" if ref else ""
        print(f"  {label}: wall {wall:.3f} s, {d['generated_tokens']} tokens, tokens/s "
              f"{rate:.1f}{vs}; rounds {d['spec_rounds']}, drafts proposed "
              f"{d['spec_drafts_proposed']} accepted {accepted} "
              f"({accepted / max(d['spec_drafts_proposed'], 1):.3f}), tokens a row-round "
              f"{1 + accepted / max(row_rounds, 1):.3f}; plain decode steps {plain_steps}, "
              f"over-decoded {d['tokens_overdecoded']}; K1 launches {launches}; peak memory "
              f"{peak:.2f} GiB; spec graph captures by cover {covers}; pages in use after "
              f"drain {engine.ctrl.used_pages}", flush=True)
        statuses = {r.rid: r.status for r in engine.completed}
        for rid, (_, n), toks in zip(rids, reqs, out["streams"]):
            if statuses.get(rid) != "ok" or toks is None or len(toks) != n:
                fail(f"{label} {rid}: status {statuses.get(rid)}, "
                     f"{None if toks is None else len(toks)} tokens, wanted {n}")
            if not all(0 <= t < engine.config.vocab_size for t in toks):
                fail(f"{label} {rid}: token out of the vocabulary")
        if engine.ctrl.used_pages or engine._committed_pages:
            fail(f"{label}: {engine.ctrl.used_pages} pages in use (target and draft pools "
                 f"share the allocator), {engine._committed_pages} committed after the drain")
        if cuda and (launches == 0 or launches != expected):
            fail(f"{label}: K1 launched {launches} times, expected n_layers x plain steps + "
                 f"draft layers x (gamma+1) x rounds = {expected}")
        engine.close()
        return out

    if plain is None:  # the CPU rehearsal runs its own (a)
        plain = spec_drain("(a) plain", ServeEngine(params, config, **base), requests)
    runs = {}
    spec_kw = dict(draft_params=draft, draft_config=config, gamma=g)
    for label, kw in (("(b) spec on", {}),
                      ("(c) spec_lookahead=4", dict(spec_lookahead=k)),
                      ("(d) spec_superstep_k=4 pipelined", dict(spec_superstep_k=k,
                                                                pipelined=True)),
                      ("(e) spec=auto, start-up calibration", dict(spec="auto")),
                      ("(f) sampling, spec on", dict(
                          temperature=spec["temperature"], top_k=spec["top_k"],
                          top_p=spec["top_p"],
                          rng=prng_key(7, device)))):
        engine = ServeEngine(params, config, **base, **spec_kw, **kw)
        runs[label] = spec_drain(label, engine, requests, plain["tokens_per_s"])
        if label.startswith("(e)"):
            c = engine.spec_calibration
            print(f"  (e) calibrated threshold {c['threshold']:.0f} of {f['slots']} slots "
                  f"({'always' if c['threshold'] else 'never'} speculate): plain dispatch "
                  f"{c['plain_dispatch_ms']:.3f} ms for {c['plain_tokens_per_dispatch']:.0f} "
                  f"tokens, spec dispatch {c['spec_dispatch_ms']:.3f} ms for "
                  f"{c['spec_tokens_per_dispatch_assumed']:.2f} (assumed)", flush=True)
        del engine
        if cuda:
            torch.cuda.empty_cache()
    for label, run in runs.items():
        if label.startswith("(f)"):
            continue
        same = sum(a == b for a, b in zip(run["streams"], plain["streams"]))
        print(f"  {label}: {same} of {len(requests)} bf16 greedy streams equal (a)'s "
              f"(reported, not gated)", flush=True)

    # (g) float32: spec streams equal the plain stream token for token.
    params32 = cast_params(params, torch.float32)
    config32 = replace(config, dtype=torch.float32)
    draft32 = quantize_params(params32)
    rng = np.random.default_rng(11)
    reqs32 = [(rng.integers(0, config.vocab_size, f["decode_prompt"]).tolist(),
               spec["f32_new"][i % 2]) for i in range(spec["f32_requests"])]
    runs32 = {"plain": spec_drain("(g) float32 plain", ServeEngine(params32, config32, **base),
                                  reqs32)}
    for label, kw in (("spec on", {}), ("spec_superstep_k=4", dict(spec_superstep_k=k))):
        engine = ServeEngine(params32, config32, **base, draft_params=draft32,
                             draft_config=config32, gamma=g, **kw)
        runs32[label] = spec_drain(f"(g) float32 {label}", engine, reqs32,
                                   runs32["plain"]["tokens_per_s"])
        for i, (got, want) in enumerate(zip(runs32[label]["streams"],
                                            runs32["plain"]["streams"])):
            if got == want:
                continue
            pos = next(j for j, (a, b) in enumerate(zip(got, want)) if a != b)
            gap, scale = top2_gap(torch, params32, config32, reqs32[i][0], want, pos)
            print(f"  (g) float32 {label}: request {i} parts from the plain stream at "
                  f"token {pos}: target top-2 gap {gap:.4e}, {gap / scale:.3e} of the "
                  f"largest logit {scale:.4e}", flush=True)
            if not gap < FLIP_GAP * scale:
                fail(f"(g) float32 {label}: request {i} differs from the plain stream at "
                     f"token {pos} with a top-2 gap of {gap / scale:.3e} of the largest "
                     f"logit (a reordering needs < {FLIP_GAP:.3e})")
    print(f"  (g) float32: spec on and spec_superstep_k=4 streams equal the plain stream "
          f"(up to near-tie flips printed above)", flush=True)
    if not cuda:
        return total

    # One round from the same state, through the graph and eager, bf16
    # and float32; then the teacher-forced draft steps, K1 vs plain.
    for t_params, d_params, cfg in ((params, draft, config), (params32, draft32, config32)):
        graph_against_eager_round(torch, paged_mod, t_params, d_params, cfg, f, base)
    teacher_forced_round(torch, paged_mod, pa, draft, config, f, bf16_floor)
    teacher_forced_round(torch, paged_mod, pa, draft32, config32, f, None)
    del params32, draft32
    torch.cuda.empty_cache()
    profile_round(torch, paged_mod, pa, params, draft, config, f, base, dequantize,
                  is_quantized)
    spec_accept_on_card(torch, paged_mod)
    return total


def _round_state(torch, engine, f, rng):
    """Admit a full batch of phase 4's prompts and cover one round: the
    round's (tables, cur, pos, occupancy, cover) from the engine."""
    for _ in range(f["slots"]):
        engine.submit(rng.integers(0, engine.config.vocab_size, f["decode_prompt"]), 64)
    engine._admit()
    u = engine.gamma + 1
    for slot, req in engine._slot_req.items():
        table = engine._extend_evicting(engine._seq_id(slot, req),
                                        int(engine._positions[slot]) + u)
        engine._tables[slot, : len(table)] = table
    cover = engine._spec_cover(int(engine._positions.max()) + u)
    return (engine._dev(engine._tables), engine._dev(engine._tokens),
            engine._dev(engine._positions), engine._dev(engine._occupied), cover)


def graph_against_eager_round(torch, paged_mod, t_params, d_params, config, f, base):
    """One spec round from the same state through the engine's captured
    round and through ``paged.spec_chained_round`` eagerly: committed
    tokens, n and both pool pairs bit-identical; each timed on the host's
    clock to a synchronise, mean of 3."""
    import numpy as np
    from workloads_torch.serve import ServeEngine

    engine = ServeEngine(t_params, config, **base, draft_params=d_params,
                         draft_config=config, gamma=SPEC["gamma"])
    tables, cur, pos, occ, cover = _round_state(torch, engine, f, np.random.default_rng(3))
    pos = torch.where(occ, pos, 0)
    pools = (*engine.pools, *engine.d_pools)
    saved = [p.clone() for p in pools]
    budget, eos = engine._unbounded

    def restore():
        for p, s in zip(pools, saved):
            p.copy_(s)
        torch.cuda.synchronize()

    def graphed():
        c, n, *_ = engine._spec_graph.run(tables, cur, pos, occ, budget, eos, 1, cover)
        return c[0].clone(), n[0].clone()

    def eager():
        with torch.inference_mode():
            c, n, *_ = paged_mod.spec_chained_round(
                t_params, d_params, engine.pools, engine.d_pools, tables, cur, pos, occ,
                budget, eos, config, config, SPEC["gamma"], cover)
        return c, n

    results, times = {}, {}
    for name, fn in (("graph", graphed), ("eager", eager)):
        restore()
        fn()  # capture and first launches outside the timing
        runs = []
        for _ in range(3):
            restore()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3)
        results[name] = (*out, [p.clone() for p in pools])
        times[name] = sum(runs) / len(runs)
    restore()
    engine.close()
    same = (torch.equal(results["graph"][0], results["eager"][0])
            and torch.equal(results["graph"][1], results["eager"][1]))
    same_pools = all(torch.equal(a, b) for a, b in zip(results["graph"][2],
                                                       results["eager"][2]))
    dt = str(config.dtype).split(".")[1]
    print(f"  one spec round ({f['slots']} rows, gamma {SPEC['gamma']}, cover {cover} pages) "
          f"from the same state, {dt}: CUDA graph {times['graph']:.3f} ms, eager "
          f"{times['eager']:.3f} ms (host clock to a synchronise, mean of 3); committed and "
          f"n {'bit-identical' if same else 'DIFFER'}, target and draft pools "
          f"{'bit-identical' if same_pools else 'DIFFER'}", flush=True)
    if not (same and same_pools):
        fail(f"the spec round through the CUDA graph differs from the eager round ({dt})")


def teacher_forced_round(torch, paged_mod, pa, d_params, config, f, bf16_floor):
    """A round's gamma + 1 draft decode steps, teacher-forced on the same
    tokens from the same prefilled pools, through K1 and through the
    plain ``paged_attention_reference``: bf16 logits within the phase-4
    step's bf16 floor, float32 within SPEC_F32_RTOL of the largest."""
    g, ps = SPEC["gamma"], f["page_size"]
    lengths = [32, 100, 200, 300, 400, 500, 538, 1]
    cover = -(-(max(lengths) + g + 1) // ps)
    n_pages = len(lengths) * cover
    gen = torch.Generator("cuda").manual_seed(9)
    with torch.inference_mode():
        pools = paged_mod.init_page_pools(config, n_pages, ps, "cuda")
        tables = torch.arange(n_pages, dtype=torch.int32, device="cuda").reshape(
            len(lengths), cover)
        prompts = torch.randint(0, config.vocab_size, (len(lengths), cover * ps),
                                generator=gen, device="cuda")
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        paged_mod.paged_prefill_chunk(d_params, pools, tables, prompts, lens, config,
                                      start_page=0, cover_pages=cover, emit=False)
        toks = torch.randint(0, config.vocab_size, (g + 1, len(lengths)), generator=gen,
                             device="cuda")
        ref_pools = (pools[0].clone(), pools[1].clone())

        def kernel(q, kp, vp, t, ln, layer):
            return pa.paged_attention(q, kp, vp, t, ln, layer=layer,
                                      window=config.attention_window)

        def plain(q, kp, vp, t, ln, layer):
            return pa.paged_attention_reference(q, kp, vp, t, ln, layer=layer,
                                                window=config.attention_window)

        def steps(p, attention_fn):
            return torch.stack([
                paged_mod._decode_core(d_params, p, tables, toks[i], lens.long() + i, config,
                                       attention_fn)[0] for i in range(g + 1)])

        got, want = steps(pools, kernel), steps(ref_pools, plain)
        torch.cuda.synchronize()
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    rms = (got - want).square().mean().sqrt().item()
    dt = str(config.dtype).split(".")[1]
    if not torch.isfinite(got).all():
        fail(f"teacher-forced draft round ({dt}): non-finite logits")
    if bf16_floor is None:
        limit = SPEC_F32_RTOL * scale
        print(f"  teacher-forced round, {g + 1} int8-draft steps through K1 vs plain, "
              f"float32, rows to {max(lengths)} positions: max {err:.4e} (limit {limit:.4e} = "
              f"{SPEC_F32_RTOL} x max |logit| {scale:.4e})", flush=True)
        if not err <= limit:
            fail("float32 draft steps through K1 disagree with the plain route")
    else:
        print(f"  teacher-forced round, {g + 1} int8-draft steps through K1 vs plain, "
              f"bfloat16, rows to {max(lengths)} positions: max {err:.4e} rms {rms:.4e} "
              f"(limit: phase 4's bf16 step floor max {bf16_floor:.4e})", flush=True)
        if not err <= bf16_floor:
            fail("bfloat16 draft steps through K1 differ from the plain route by more than "
                 "the bf16 step floor")


def profile_round(torch, paged_mod, pa, params, draft, config, f, base, dequantize,
                  is_quantized):
    """One graphed engine round under the profiler (K1 counted against
    the trace's count), then the round's three phase probes (draft,
    verify, commit) each profiled eagerly from the same state, device ms
    and idle share; and the dequantization's share of the draft phase:
    its device time with the int8 draft against the same draft with
    every weight dequantized first."""
    import numpy as np
    from workloads_torch.serve import ServeEngine

    g = SPEC["gamma"]
    engine = ServeEngine(params, config, **base, draft_params=draft, draft_config=config,
                         gamma=g)
    rng = np.random.default_rng(4)
    for _ in range(f["slots"]):
        engine.submit(rng.integers(0, config.vocab_size, f["decode_prompt"]), 128)
    engine.step()
    engine.step()  # a first round replayed: captured outside the window
    want = (g + 1) * engine.draft_config.n_layers
    # A trace short of the count is taken again on the next round.
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        before = pa.paged_attention.launches
        _, wall, busy, by_name = profiled(torch, engine.step, "spec_round")
        counted = pa.paged_attention.launches - before
        traced = sum(len(v) for n, v in by_name.items() if "paged_decode_kernel" in n)
        print(f"  profiled spec round (CUDA graph replay, {f['slots']} rows, trace "
              f"{attempt}): wall {wall:.3f} ms, device kernels {busy:.3f} ms, idle share "
              f"{1 - busy / wall:.3f}; K1 counted {counted}, in the trace {traced}, "
              f"(gamma+1) x draft layers {want}", flush=True)
        if counted != want or traced > counted:
            fail(f"K1 over the profiled round: counted {counted}, traced {traced}, wanted "
                 f"{want}")
        if traced == counted:
            break
    else:
        fail(f"none of {TRACE_ATTEMPTS} traces of a profiled round shows K1's {want} launches")
    # The probes start where the next round would: every row decoding.
    for slot, req in engine._slot_req.items():
        table = engine._extend_evicting(engine._seq_id(slot, req),
                                        int(engine._positions[slot]) + g + 1)
        engine._tables[slot, : len(table)] = table
    tables, cur, pos = (engine._dev(engine._tables), engine._dev(engine._tokens),
                        engine._dev(engine._positions))
    cover = engine._spec_cover(int(engine._positions.max()) + g + 1)
    deq = {"embed": draft["embed"], "unembed": dequantize(draft["unembed"], torch.float32),
           "layers": [{n: (dequantize(w, config.dtype) if is_quantized(w) else w)
                       for n, w in layer.items()} for layer in draft["layers"]]}
    phases = {}
    with torch.inference_mode():
        (drafts, _, _), *times = profiled(torch, lambda: paged_mod.paged_spec_draft_phase(
            draft, engine.d_pools, tables, cur, pos, config, g, cover), "spec_draft")
        phases["draft"] = times
        _, *deq_times = profiled(torch, lambda: paged_mod.paged_spec_draft_phase(
            deq, engine.d_pools, tables, cur, pos, config, g, cover), "spec_draft_deq")
        block = torch.cat([cur[:, None], drafts], dim=1)
        (picks, _), *times = profiled(torch, lambda: paged_mod.paged_spec_verify_phase(
            params, engine.pools, tables, block, pos, config, cover), "spec_verify")
        phases["verify"] = times
        _, *times = profiled(torch, lambda: paged_mod.spec_commit_phase(drafts, picks),
                             "spec_commit")
        phases["commit"] = times
    engine.close()
    for name, (wall, busy, _) in phases.items():
        print(f"  phase probe {name} (eager, cover {cover}): wall {wall:.3f} ms, device "
              f"kernels {busy:.3f} ms, idle share {1 - busy / wall:.3f}", flush=True)
    d_busy, deq_busy = phases["draft"][1], deq_times[1]
    print(f"  draft phase device time: int8 draft {d_busy:.3f} ms, dequantized-first draft "
          f"{deq_busy:.3f} ms: the dequantization is {(d_busy - deq_busy) / d_busy:.3f} of "
          f"the draft phase", flush=True)
    top = sorted(phases["draft"][2].items(), key=lambda kv: -sum(kv[1]))[:8]
    for name, durs in top:
        print(f"    draft phase {sum(durs):9.3f} ms {len(durs):6d} launches  {name[:90]}",
              flush=True)


def spec_accept_on_card(torch, paged_mod):
    """``_spec_accept`` under a key on the card passes the CPU
    contract: 4000 draws, the first committed token's marginal within
    0.06 total variation of p, every acceptance length seen."""
    vocab, gamma, trials = 5, 2, 4000
    q_dist = torch.tensor([0.70, 0.10, 0.10, 0.05, 0.05], device="cuda")
    p_dist = torch.tensor([0.10, 0.40, 0.20, 0.20, 0.10], device="cuda")
    gen = torch.Generator("cuda").manual_seed(0)
    drafts = torch.multinomial(q_dist.expand(trials * gamma, vocab), 1, replacement=True,
                               generator=gen).reshape(trials, gamma)
    committed, n = paged_mod._spec_accept(drafts, q_dist.expand(trials, gamma, vocab),
                                          p_dist.expand(trials, gamma + 1, vocab),
                                          prng_key(0, "cuda"))
    counts = torch.bincount(committed[:, 0], minlength=vocab).float().cpu() / trials
    tv = (counts - p_dist.cpu()).abs().sum().item()
    seen = sorted(set(n.cpu().tolist()))
    print(f"  _spec_accept on the card: first-token marginal {counts.tolist()} against p "
          f"{p_dist.cpu().tolist()}, total variation {tv:.4f} (limit 0.06), acceptance "
          f"lengths seen {seen}", flush=True)
    if not (tv < 0.06 and seen == [0, 1, 2]):
        fail("_spec_accept's marginal on the card is not the target distribution")


# Phase 4e, multi-LoRA: four synthetic adapters at rank 8 on wqkv and wo
# (the JAX CLI's --lora-adapters 4 --lora-rank 8, seed 99) over phase 4's
# model, engine and 12 requests, round-robin over the base and the four
# adapters; (f) shares phase 4c's 512-token system prompt between the
# base and two adapters, four conversations each; (g) float32 on 8
# requests.
LORA = dict(n=4, rank=8, alpha=1.0, seed=99, gamma=4, k=4, budget=64, f32_requests=8,
            f32_new=(64, 128), prefix_per_salt=4, prefix_salts=3)


def adapted_logits(torch, params, config, stacked, aidx, alpha, seq):
    """The adapted model's next-token logits after ``seq`` (a dense block
    forward through ``generate.decode_block`` with ``lora=``)."""
    from workloads_torch.generate import decode_block, init_kv_cache

    device = params["embed"].device
    tokens = torch.tensor([list(seq)], device=device)
    with torch.inference_mode():
        cache = init_kv_cache(config, 1, tokens.shape[1], device)
        lora = (stacked, torch.tensor([aidx], dtype=torch.int32, device=device), alpha)
        logits, _ = decode_block(params, cache, tokens, 0, config, lora=lora)
    return logits[0, -1].float()


def lora_phase(torch, params, config, f, counters, requests, plain, bf16_floor,
               plain_chunk=None, device="cuda", lora=LORA) -> int:
    """Phase 4e: multi-LoRA serving at full width.  Drains of phase 4's 12
    requests round-robin over the base and the four adapters: (a) plain
    (``plain``, phase 4's drain without adapters), (b) adapters at the
    defaults, (c) ``superstep_k=4, pipelined``, (d) ``prefill_budget=64``,
    (e) spec on with the int8 self-draft at gamma 4; (f) the radix prefix
    cache at phase 4c's context, the base and two adapters behind one
    512-token system prompt; (g) float32 on 8 requests: the adapter engine
    plain, with ``superstep_k=4, pipelined``, with ``prefill_budget=64``
    and with spec on, and a plain engine over each merged model.
    Gates: every request ``ok`` at full length, no page in use after each
    drain, K1 n_layers a decode step and (gamma+1) x draft layers a
    round; (b)'s base requests bit-identical to (a)'s; one graph capture
    through (b)'s adapter churn; (f)'s hits per salt as the radix model
    predicts and no page shared across salts; (g)'s adapted streams equal
    the merged models' (a flip only at a top-2 gap the two routes' own
    logit difference covers, printed), its superstep and budget streams
    its plain ones token for token, and its spec streams too (a flip only
    at a near-tie, as phase 4d); the
    teacher-forced adapted decode step through K1 against plain (bf16
    within ``bf16_floor``, float32 within STEP_F32_RTOL); K1 counted =
    traced over a profiled adapted chunk, its LoRA launches by name beside
    (a)'s chunk (``plain_chunk``: phase 4's (wall ms, device ms, kernels
    by name)).  ``device="cpu"`` rehearses the drains
    and gates on the plain route.  Returns K1's launches over the
    drains."""
    from dataclasses import replace

    import numpy as np
    from workloads_torch import paged as paged_mod
    from workloads_torch.lora import merge_lora
    from workloads_torch.model import cast_params
    from workloads_torch.multi_lora import stack_adapters, synthetic_adapters
    from workloads_torch.ops import paged_attention as pa
    from workloads_torch.quant import quantize_params
    from workloads_torch.serve import ServeEngine

    cuda = device == "cuda"
    g, k, L = lora["gamma"], lora["k"], config.n_layers

    def sync():
        if cuda:
            torch.cuda.synchronize()

    if cuda and not (torch.backends.cuda.matmul.allow_tf32 is False
                     and torch.get_float32_matmul_precision() == "highest"):
        fail("TF32 is on for float32 matmuls: the LoRA factor products must not run in it")
    adapters = synthetic_adapters(config, lora["n"], rank=lora["rank"], seed=lora["seed"],
                                  device=device)
    names = [None] + sorted(adapters)
    per_layer = sum(ab["a"].numel() + ab["b"].numel() for ab in adapters[names[1]][0].values())
    one = per_layer * L * 4
    print(f"  {lora['n']} adapters at rank {lora['rank']} on "
          f"{sorted(adapters[names[1]][0])}: {per_layer} float32 a layer, "
          f"{one / 1e6:.2f} MB an adapter, {one * (lora['n'] + 1) / 1e6:.2f} MB stacked with "
          f"the base entry", flush=True)
    reqs = [(p, n, names[i % len(names)]) for i, (p, n) in enumerate(requests)]
    base = dict(slots=f["slots"], page_size=f["page_size"], chunk=f["page_size"], device=device)
    kw_lora = dict(adapters=adapters, lora_alpha=lora["alpha"])
    total = 0

    def lora_drain(label, engine, reqs, ref=None, warm=None, after_warm=None, ref_name="(a)"):
        """Serve ``reqs`` (prompt, new, adapter) after one warm-up request
        (``warm``, by default the first prompt under the last request's
        adapter: the graphs' captures); gate and print the drain."""
        nonlocal total
        prompt, adapter = warm or (reqs[0][0], reqs[-1][2])
        engine.submit(prompt, 2, adapter=adapter)
        engine.run()
        if after_warm is not None:
            after_warm()
        captures0 = engine._graph.captures if engine._graph is not None else 0
        fields = ("chunks_run", "generated_tokens", "spec_rounds", "spec_drafts_proposed",
                  "spec_tokens_rejected", "prefill_tokens")
        before = {n: getattr(engine, n) for n in fields}
        rids = [engine.submit(p, n, adapter=a) for p, n, a in reqs]
        reset_counts(counters)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        sync()
        t0 = time.perf_counter()
        served = engine.run()
        sync()
        wall = time.perf_counter() - t0
        d = {n: getattr(engine, n) - before[n] for n in fields}
        launches = read_counts(counters)["paged_attention"]
        total += launches
        plain_steps = d["chunks_run"] * engine.chunk
        d_layers = engine.draft_config.n_layers if engine.draft_params is not None else 0
        expected = L * plain_steps + d_layers * (g + 1) * d["spec_rounds"]
        accepted = d["spec_drafts_proposed"] - d["spec_tokens_rejected"]
        peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else 0.0
        rate = d["generated_tokens"] / wall
        captures = engine._graph.captures if engine._graph is not None else 0
        out = {"streams": [served.get(r) for r in rids], "wall": wall, "tokens_per_s": rate,
               "launches": launches, "peak_gib": peak, "captures": (captures0, captures),
               "prefill_tokens": d["prefill_tokens"]}
        vs = f" ({rate / ref:.3f} of {ref_name})" if ref else ""
        spec = ""
        if d["spec_rounds"]:
            spec = (f"; rounds {d['spec_rounds']}, drafts proposed "
                    f"{d['spec_drafts_proposed']} accepted {accepted} (acceptance "
                    f"{accepted / max(d['spec_drafts_proposed'], 1):.3f})")
        print(f"  {label}: wall {wall:.3f} s, {d['generated_tokens']} tokens, tokens/s "
              f"{rate:.1f}{vs}; plain decode steps {plain_steps}{spec}; prompt tokens "
              f"forwarded {d['prefill_tokens']}; K1 launches {launches}; peak memory "
              f"{peak:.2f} GiB; decode graph captures {captures0} after the first "
              f"dispatch, {captures} after the drain; pages in use after drain "
              f"{engine.ctrl.used_pages - (engine.prefix.cached_pages if engine.prefix else 0)}"
              f" beside the index", flush=True)
        statuses = {r.rid: r.status for r in engine.completed}
        for rid, (_, n, _), toks in zip(rids, reqs, out["streams"]):
            if statuses.get(rid) != "ok" or toks is None or len(toks) != n:
                fail(f"{label} {rid}: status {statuses.get(rid)}, "
                     f"{None if toks is None else len(toks)} tokens, wanted {n}")
            if not all(0 <= t < engine.config.vocab_size for t in toks):
                fail(f"{label} {rid}: token out of the vocabulary")
        pinned = engine.prefix.cached_pages if engine.prefix is not None else 0
        if engine.ctrl.used_pages != pinned or engine._committed_pages:
            fail(f"{label}: {engine.ctrl.used_pages} pages in use beside the index's "
                 f"{pinned}, {engine._committed_pages} committed after the drain")
        if cuda and (launches == 0 or launches != expected):
            fail(f"{label}: K1 launched {launches} times, expected n_layers x plain steps + "
                 f"draft layers x (gamma+1) x rounds = {expected}")
        if captures != captures0:
            fail(f"{label}: the adapter mix recaptured the decode graph ({captures0} -> "
                 f"{captures})")
        return out

    if plain is None:  # the CPU rehearsal runs its own (a)
        plain = lora_drain("(a) plain, no adapters", ServeEngine(params, config, **base),
                           [(p, n, None) for p, n in requests])
    runs = {}
    draft = quantize_params(params)
    for label, kw in (("(b) adapters, defaults", {}),
                      ("(c) adapters, superstep_k=4 pipelined",
                       dict(superstep_k=k, pipelined=True)),
                      ("(d) adapters, prefill_budget=64", dict(prefill_budget=lora["budget"])),
                      ("(e) adapters, spec on (int8 self-draft, gamma 4)",
                       dict(draft_params=draft, draft_config=config, gamma=g))):
        engine = ServeEngine(params, config, **base, **kw_lora, **kw)
        runs[label] = lora_drain(label, engine, reqs, plain["tokens_per_s"])
        engine.close()
        del engine
        if cuda:
            torch.cuda.empty_cache()
    del draft
    b = runs["(b) adapters, defaults"]
    base_rows = [i for i, (_, _, a) in enumerate(reqs) if a is None]
    same_base = [b["streams"][i] == plain["streams"][i] for i in base_rows]
    print(f"  (b): the base requests' bf16 streams equal (a)'s bit for bit in "
          f"{sum(same_base)} of {len(base_rows)}", flush=True)
    if not all(same_base):
        fail("(b): a base request's stream under the adapter engine differs from the plain "
             "drain's (zero deltas must be exact)")
    for label, run in runs.items():
        same = sum(x == y for x, y in zip(run["streams"], b["streams"]))
        print(f"  {label}: {same} of {len(reqs)} bf16 streams equal (b)'s (reported; float32 "
              f"is gated in (g))", flush=True)
    print(f"  decode tokens/s: (a) {plain['tokens_per_s']:.1f}, " + ", ".join(
        f"{label.split(')')[0]}) {run['tokens_per_s']:.1f}" for label, run in runs.items()),
        flush=True)

    # (f) the radix prefix cache: the base and two adapters behind one
    # 512-token system prompt, four conversations each, all submitted at
    # once.  Per salt the first admission misses and inserts the system
    # pages; every later one hits them (8 pages, 4 prompt buckets).
    kv = KV if cuda else lora["kv"]
    config_f = replace(config, max_seq_len=kv["max_seq_len"])
    rng = np.random.default_rng(0)
    system = rng.integers(0, config.vocab_size, kv["system"]).tolist()
    salts_names = names[: lora["prefix_salts"]]
    conv = [(system + rng.integers(0, config.vocab_size, kv["user"]).tolist(), kv["new"],
             salts_names[i % len(salts_names)])
            for i in range(lora["prefix_per_salt"] * len(salts_names))]
    engine = ServeEngine(params, config_f, slots=kv["slots"], page_size=kv["page_size"],
                         prompt_bucket=kv["prompt_bucket"], chunk=kv["chunk"], device=device,
                         prefix_cache=True, **kw_lora)
    per_salt: dict[str, list] = {}
    lookup = engine.prefix.lookup

    def counting_lookup(tokens, *args, salt="", **kw):
        got = lookup(tokens, *args, salt=salt, **kw)
        per_salt.setdefault(salt, []).append(len(got))
        return got

    engine.prefix.lookup = counting_lookup
    # The warm-up prompt holds no full page, so the index stays empty.
    run_f = lora_drain("(f) adapters, radix prefix cache, shared 512-token system prompt",
                       engine, conv, warm=(conv[0][0][:kv["page_size"] - 1], None),
                       after_warm=per_salt.clear)
    sys_pages = kv["system"] // kv["page_size"]
    bp = kv["prompt_bucket"] // kv["page_size"]
    want_hit = (len(conv[0][0]) - 1) // kv["page_size"] // bp * bp
    want_hit = min(want_hit, sys_pages // bp * bp)
    predicted = {engine._handoff_salt(a): [0] + [want_hit] * (lora["prefix_per_salt"] - 1)
                 for a in salts_names}
    got = {s: sorted(v) for s, v in per_salt.items()}
    print(f"  (f) pages hit per lookup, by salt: {got} (predicted "
          f"{ {s: sorted(v) for s, v in predicted.items()} }); prompt tokens forwarded "
          f"{run_f['prefill_tokens']}", flush=True)
    if got != {s: sorted(v) for s, v in predicted.items()}:
        fail(f"(f): hits per salt {got}, the radix model predicts {predicted}")
    pages_by_salt = {}
    for salt, root in engine.prefix._roots.items():
        stack, pages = list(root.children.values()), set()
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            if node.page is not None:
                pages.add(node.page)
        pages_by_salt[salt] = pages
    shared = [(a, b) for a in pages_by_salt for b in pages_by_salt
              if a < b and pages_by_salt[a] & pages_by_salt[b]]
    print(f"  (f) resident index pages by salt: "
          f"{ {s: len(p) for s, p in pages_by_salt.items()} }; shared across salts: "
          f"{shared or 'none'}", flush=True)
    if shared or len(pages_by_salt) != len(salts_names):
        fail(f"(f): pages shared across salts {shared}, roots {sorted(pages_by_salt)}")
    engine.close()
    if engine.ctrl.used_pages:
        fail(f"(f): {engine.ctrl.used_pages} pages in use after close")
    del engine

    # (g) float32: the adapted streams equal the merged models', and
    # speculation is lossless per tenant.
    params32 = cast_params(params, torch.float32)
    config32 = replace(config, dtype=torch.float32)
    stacked = stack_adapters([adapters[n] for n in names[1:]], config32)
    rng = np.random.default_rng(12)
    reqs32 = [(rng.integers(0, config.vocab_size, f["decode_prompt"]).tolist(),
               lora["f32_new"][i % 2], names[i % len(names)])
              for i in range(lora["f32_requests"])]
    plain32 = lora_drain("(g) float32 adapters, plain",
                         ServeEngine(params32, config32, **base, **kw_lora), reqs32)
    for label, kw in (("superstep_k=4 pipelined", dict(superstep_k=k, pipelined=True)),
                      ("prefill_budget=64", dict(prefill_budget=lora["budget"]))):
        run = lora_drain(f"(g) float32 adapters, {label}",
                         ServeEngine(params32, config32, **base, **kw_lora, **kw), reqs32,
                         plain32["tokens_per_s"], ref_name="(g) plain")
        if run["streams"] != plain32["streams"]:
            fail(f"(g) float32 adapters, {label}: the greedy streams differ from the plain "
                 f"drain's")
    print("  (g) float32: the superstep and budget drains' adapted streams equal the plain "
          "drain's token for token", flush=True)
    spec32 = lora_drain("(g) float32 adapters, spec on",
                        ServeEngine(params32, config32, **base, **kw_lora,
                                    draft_params=quantize_params(params32),
                                    draft_config=config32, gamma=g), reqs32,
                        plain32["tokens_per_s"], ref_name="(g) plain")

    def check_flip(label, i, got, want, logits_a, logits_b):
        """A stream that parts from its merged model's: the merged model's
        top-2 gap at the first difference must be inside what the two
        routes (activation-side delta, ``logits_a``; merged weight,
        ``logits_b``) differ by there, a reordering of a near-tie."""
        pos = next(j for j, (x, y) in enumerate(zip(got, want)) if x != y)
        seq = reqs32[i][0] + want[:pos]
        ref = logits_b(seq)
        top = torch.topk(ref, 2).values
        gap = (top[0] - top[1]).item()
        diff = (logits_a(seq) - ref).abs().max().item()
        print(f"  {label}: request {i} parts at token {pos}: top-2 gap {gap:.4e}, the two "
              f"routes' logits differ by {diff:.4e} there (largest logit "
              f"{ref.abs().max().item():.4e})", flush=True)
        if not gap <= 2 * diff:
            fail(f"{label}: request {i} parts at token {pos} with a top-2 gap of {gap:.4e} "
                 f"beyond the routes' logit difference {diff:.4e}")

    for i, (got, want) in enumerate(zip(spec32["streams"], plain32["streams"])):
        if got == want:
            continue
        # As phase 4d: speculation reorders only a near-tie of the target.
        pos = next(j for j, (x, y) in enumerate(zip(got, want)) if x != y)
        ref = adapted_logits(torch, params32, config32, stacked, names.index(reqs32[i][2]),
                             lora["alpha"], reqs32[i][0] + want[:pos])
        top = torch.topk(ref, 2).values
        gap, scale = (top[0] - top[1]).item(), ref.abs().max().item()
        print(f"  (g) spec on: request {i} parts from the plain adapted stream at token "
              f"{pos}: top-2 gap {gap:.4e}, {gap / scale:.3e} of the largest logit", flush=True)
        if not gap < FLIP_GAP * scale:
            fail(f"(g) float32 spec on: request {i} differs from the plain adapted stream at "
                 f"token {pos} with a top-2 gap of {gap / scale:.3e} of the largest logit")
    for name in names:
        rows = [i for i, r in enumerate(reqs32) if r[2] == name]
        if not rows:
            continue
        merged = params32 if name is None else merge_lora(params32, adapters[name],
                                                          lora["alpha"])
        m = lora_drain(f"(g) float32 plain engine over merge_lora(params, {name})",
                       ServeEngine(merged, config32, **base), [(reqs32[i][0], reqs32[i][1], None)
                                                               for i in rows])
        for i, want in zip(rows, m["streams"]):
            got = plain32["streams"][i]
            if got == want:
                continue
            aidx = names.index(name)
            check_flip(f"(g) adapter {name} vs merged", i, got, want,
                       lambda seq, a=aidx: adapted_logits(torch, params32, config32, stacked,
                                                          a, lora["alpha"], seq),
                       lambda seq, mp=merged: dense_logits(torch, mp, config32, seq))
        del merged
    print("  (g) float32: every adapter's stream equals its merged model's and the spec "
          "streams the plain ones (up to the near-tie flips printed above)", flush=True)
    if not cuda:
        return total

    # The teacher-forced adapted decode step, kernel against plain: 8 rows
    # at phase 4's lengths under the base and the four adapters.
    lengths = [32, 100, 200, 300, 400, 500, 543, 1]
    for dtype in (torch.float32, torch.bfloat16):
        p_ = params32 if dtype == torch.float32 else params
        cfg = replace(config, dtype=dtype)
        aidx = torch.tensor([i % len(names) for i in range(len(lengths))], dtype=torch.int32,
                            device="cuda")
        step_lora = (stack_adapters([adapters[n] for n in names[1:]], cfg), aidx,
                     lora["alpha"])
        got_, want_ = teacher_forced_step(torch, paged_mod, pa, p_, cfg, f["page_size"],
                                          lengths, lora=step_lora)
        err = (got_ - want_).abs().max().item()
        scale = want_.abs().max().item()
        limit = STEP_F32_RTOL * scale if dtype == torch.float32 else bf16_floor
        print(f"  teacher-forced adapted decode step, 8 rows, {str(dtype)[6:]}: kernel vs "
              f"plain max {err:.4e} (limit {limit:.4e}: "
              f"{'STEP_F32_RTOL x max' if dtype == torch.float32 else 'phase 4 bf16 floor'})",
              flush=True)
        if not (torch.isfinite(got_).all() and err <= limit):
            fail(f"the adapted decode step through K1 disagrees with the plain route "
                 f"({dtype})")
    del params32, stacked
    torch.cuda.empty_cache()

    # One profiled graphed chunk with adapters against (a)'s.
    engine = ServeEngine(params, config, **base, **kw_lora)
    wall, busy, _, _, kernels, _ = profile_chunk(torch, engine, np.random.default_rng(5), f,
                                                 pa, adapters=names)
    engine.close()
    if plain_chunk is not None:
        p_wall, p_busy, plain_kernels = plain_chunk
        print(f"  the adapted chunk against (a)'s: wall {wall:.3f} against {p_wall:.3f} ms "
              f"({wall / p_wall:.3f}x), device {busy:.3f} against {p_busy:.3f} ms "
              f"({busy / p_busy:.3f}x), idle share {1 - busy / wall:.3f} against "
              f"{1 - p_busy / p_wall:.3f}", flush=True)
        plain_n = {n: len(v) for n, v in plain_kernels.items()}
        extra = sorted(((len(v) - plain_n.get(n, 0), sum(v), n) for n, v in kernels.items()
                        if len(v) != plain_n.get(n, 0)), reverse=True)
        print(f"  LoRA launches in the profiled chunk against (a)'s, by kernel "
              f"({sum(e[0] for e in extra)} more launches in all):", flush=True)
        for n_extra, ms, name in extra[:12]:
            print(f"    {n_extra:+6d} launches ({ms:8.3f} ms in all)  {name[:90]}",
                  flush=True)
    return total


# Phase 4f, the fleet: phase 4's model and engine (slots 8, page_size 64,
# chunk 64) behind the router, two replicas on one card over one copy of
# the weights.  (a) and (a') serve the JAX --fleet CLI's kind of traffic:
# a seeded TrafficGen stream of 32 requests, bursty arrivals, Pareto
# prompt lengths of 16-512 tokens, 32-128 new tokens, open loop.  (b)-(h)
# serve 16 requests with 8-16 new tokens, except where a fault or a close
# must land mid-stream ((b), (d), (g): 64-128 new tokens, two chunks).
# (i) runs (a), (b), (c), (d) and (g) in float32 on 8 requests and holds
# every stream to one plain engine's.
FLEET = dict(replicas=2, requests=32, prompt=(16, 512), new=(32, 128), rate_rps=50.0,
             seed=7, short_requests=16, short_new=(8, 16), long_new=(64, 128),
             max_seq_len=640, f32_requests=8, probe=([1, 2, 3], 4))
FLEET_TERMINAL = ("ok", "cancelled", "expired", "failed")


def parse_exposition(text: str) -> int:
    """Check a Prometheus text exposition line by line (``# HELP`` and
    ``# TYPE`` comments, ``name{labels} value`` samples whose value
    parses as a float); returns the sample count."""
    import re

    comment = re.compile(r"# (HELP|TYPE) [a-zA-Z_:][a-zA-Z0-9_:]* \S")
    sample = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*(\{.*\})? (\S+)")
    samples = 0
    for line in text.splitlines():
        if not line:
            continue
        if line.startswith("#"):
            if not comment.match(line):
                fail(f"metrics exposition: bad comment line {line!r}")
            continue
        m = sample.fullmatch(line)
        if m is None:
            fail(f"metrics exposition: bad sample line {line!r}")
        try:
            float(m.group(2))
        except ValueError:
            fail(f"metrics exposition: bad value in {line!r}")
        samples += 1
    return samples


def in_order(kinds, wanted) -> bool:
    """``wanted`` appears in ``kinds`` as a subsequence."""
    it = iter(kinds)
    return all(any(k == w for k in it) for w in wanted)


def fleet_phase(torch, params, config, f, counters, plain, fl=FLEET, device="cuda") -> int:
    """Phase 4f: the fleet and its control plane at the serving path's
    width.  Arms: (h) two requests over the HTTP/SSE front end while (a)'s
    replicas capture their graphs; (a) ``make_fleet(n=2)`` with observers
    and ledgers, (a') without, on one open-loop stream; (b) a replica
    crash with failover; (c) prefill/decode roles with the KV handoff;
    (d) the supervisor's crash, respawn, canary and rejoin; (e) the
    autoscaler 1 -> 2 -> 1 under a burst; (f) the goodput controller
    retuning ``superstep_k``; (g) the journal, close mid-stream, restore;
    (i) float32 (a), (b), (c), (d) and (g) against one plain engine.
    Gates: one terminal status a request, no page left on any replica, K1
    n_layers a decode step on every engine an arm built (and counted =
    traced on each replica of (a)), one graph capture a replica in (a)
    and (a'), the SSE tokens equal to the record, every ledger
    reconciled, the exposition and the merged trace well formed, the
    controllers' event kinds in order, float32 streams equal to the
    plain engine's (a flip only at a top-2 gap under FLIP_GAP of the
    largest logit, as phases 4b and 4d).  ``device="cpu"`` rehearses the
    arms and gates on the plain route.  Returns K1's launches."""
    import statistics
    import tempfile
    import threading
    import urllib.request
    from dataclasses import replace

    import numpy as np
    from tpu_device_plugin.metrics import Registry
    from workloads_torch.autoscaler import FleetAutoscaler
    from workloads_torch.backoff import Backoff
    from workloads_torch.control import GoodputController
    from workloads_torch.faults import FaultInjector
    from workloads_torch.fleet import (DEAD, FleetServer, TrafficGen, drive_open_loop,
                                       make_fleet)
    from workloads_torch.ledger import ChipTimeLedger, FleetLedger
    from workloads_torch.model import cast_params
    from workloads_torch.obs import EngineObserver, FleetObserver, export_fleet_trace
    from workloads_torch.serve import ServeEngine
    from workloads_torch.supervisor import FleetSupervisor, make_engine_factory

    cuda = device == "cuda"
    n = fl["replicas"]
    L = config.n_layers
    cfg16 = replace(config, max_seq_len=fl["max_seq_len"])
    base = dict(slots=f["slots"], page_size=f["page_size"], chunk=f["page_size"])
    chip_ids = [f"chip-{i}" for i in range(n)]
    work = tempfile.mkdtemp(prefix="fleet_phase_")
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_counts(counters)
    t_phase = time.perf_counter()

    def traffic(count, new, seed=fl["seed"]):
        return TrafficGen(seed=seed, rate_rps=fl["rate_rps"], vocab=config.vocab_size,
                          min_prompt=fl["prompt"][0], max_prompt=fl["prompt"][1],
                          min_new=new[0], max_new=new[1]).schedule(count)

    def instrument(fleet):
        """Time every fleet step and every replica engine step (host
        clock), and collect the rids each fleet step finishes."""
        stats = {"fleet_s": 0.0, "replica_s": 0.0, "steps": 0, "finished": []}
        fleet_step = fleet.step

        def step():
            t0 = time.perf_counter()
            out = fleet_step()
            stats["fleet_s"] += time.perf_counter() - t0
            stats["steps"] += 1
            stats["finished"] += [fr.rid for fr in out]
            return out

        fleet.step = step
        for rep in fleet.replicas:
            engine_step = rep.engine.step

            def timed(engine_step=engine_step):
                t0 = time.perf_counter()
                out = engine_step()
                stats["replica_s"] += time.perf_counter() - t0
                return out

            rep.engine.step = timed
        return stats

    def recording(factory, built):
        def make(slot):
            engine = factory(slot)
            built.append(engine)
            return engine
        return make

    def settle(label, fleet, stats, built):
        """The gates every arm shares, over every request the fleet
        accepted; returns K1's launches over the arm."""
        finished = stats["finished"]
        if len(finished) != len(set(finished)):
            fail(f"fleet {label}: a request finished twice")
        for rid, fr in fleet._reqs.items():
            if not fr.done or fr.status not in FLEET_TERMINAL:
                fail(f"fleet {label} {rid}: no terminal status ({fr.status})")
            if rid not in finished:
                fail(f"fleet {label} {rid}: {fr.status} but never returned by a step")
            if fr.status != "ok" or len(fr.tokens) != fr.max_new_tokens:
                fail(f"fleet {label} {rid}: status {fr.status}, {len(fr.tokens)} tokens, "
                     f"wanted ok with {fr.max_new_tokens} ({fr.error})")
            if not all(0 <= t < config.vocab_size for t in fr.tokens):
                fail(f"fleet {label} {rid}: token out of the vocabulary")
        for rep in fleet.replicas:
            if rep.state == DEAD:
                continue
            e = rep.engine
            pinned = e.prefix.cached_pages if e.prefix is not None else 0
            if e._occupied.any() or e._committed_pages or rep.rids \
                    or e.ctrl.used_pages != pinned:
                fail(f"fleet {label}: replica {rep.index} leaks: {e.ctrl.used_pages} pages "
                     f"in use beside {pinned} cached, {e._committed_pages} committed, "
                     f"{len(rep.rids)} rids")
        launches = counters["paged_attention"].launches
        steps = sum(e.chunks_run for e in built) * base["chunk"]
        if cuda and launches != L * steps:
            fail(f"fleet {label}: K1 launched {launches} times, n_layers x decode steps "
                 f"over the arm's {len(built)} engines is {L * steps}")
        reset_counts(counters)
        return launches

    def submit_all(fleet, reqs):
        return [fleet.submit(p, nw) for p, nw in reqs]

    def close(fleet):
        fleet.close()
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    peaks = {}

    def arm_peak(label):
        """Print the arm's peak device memory and start the next arm's."""
        if cuda:
            peaks[label] = torch.cuda.max_memory_allocated() / 2**30
            print(f"  fleet {label}: peak device memory {peaks[label]:.2f} GiB", flush=True)
            torch.cuda.reset_peak_memory_stats()

    total = 0

    # (h) and (a): the observed fleet; two SSE requests are its warm-up and
    # stream while its replicas capture their graphs on the server's driver
    # thread (handler threads touch host state only, under the fleet's lock).
    sched = traffic(fl["requests"], fl["new"])
    registry = Registry()
    observers = [EngineObserver(name=str(i), replica=str(i)) for i in range(n)]
    fobs = FleetObserver()
    for o in observers:
        o.bind_registry(registry)
    fobs.bind_registry(registry)
    fleet = make_fleet(params, cfg16, n, engine_kw=base, chip_ids=chip_ids,
                       observers=observers, device=device, observer=fobs,
                       ledger=FleetLedger(), hang_timeout_s=None)
    ledgers = []
    for i, rep in enumerate(fleet.replicas):
        rep.engine.ledger = ChipTimeLedger(name=str(i))
        ledgers.append(rep.engine.ledger)
    built = [rep.engine for rep in fleet.replicas]
    stats = instrument(fleet)
    warm = [(list(sched[0][1]), 4), (list(sched[1][1]), 4)]
    server = FleetServer(fleet, 0)
    port = server.start()
    got: dict[int, tuple] = {}

    def client(i, prompt, new):
        body = json.dumps({"prompt": prompt, "max_new_tokens": new}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/generate", data=body,
                                     headers={"Content-Type": "application/json"})
        tokens, done = [], None
        with urllib.request.urlopen(req, timeout=600) as resp:
            for line in resp:
                if line.startswith(b"data: "):
                    ev = json.loads(line[6:])
                    tokens += ev.get("tokens", [])
                    if ev.get("done"):
                        done = ev
        got[i] = (tokens, done)

    threads = [threading.Thread(target=client, args=(i, p, nw)) for i, (p, nw) in
               enumerate(warm)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    server.stop()
    sse_s = time.perf_counter() - t0
    for i in range(len(warm)):
        if i not in got or got[i][1] is None:
            fail(f"fleet (h): SSE stream {i} did not end")
        tokens, done = got[i]
        fr = fleet._reqs[done["rid"]]
        if done["status"] != "ok" or tokens != fr.tokens or len(tokens) != warm[i][1]:
            fail(f"fleet (h): SSE stream {i} ({done['status']}, {len(tokens)} tokens) "
                 f"differs from the fleet's record ({fr.status}, {len(fr.tokens)})")
    captures = [rep.engine._graph.captures if rep.engine._graph is not None else 0
                for rep in fleet.replicas]
    print(f"  fleet (h) SSE front end: 2 streams in {sse_s:.3f} s while the replicas "
          f"captured ({captures} graphs), tokens equal to the fleet's record", flush=True)
    warm_rids = [fr.rid for fr in fleet._reqs.values()]
    tokens0 = fleet.generated_tokens
    stats.update(fleet_s=0.0, replica_s=0.0, steps=0)
    t0 = time.perf_counter()
    drive_open_loop(fleet, sched)
    if cuda:
        torch.cuda.synchronize()
    wall_a = time.perf_counter() - t0
    tps_a = (fleet.generated_tokens - tokens0) / wall_a
    rids = [r for r in fleet._reqs if r not in warm_rids]
    ttft = sorted(fleet._reqs[r].ttft_secs for r in rids)
    router_ms = (stats["fleet_s"] - stats["replica_s"]) / max(stats["steps"], 1) * 1e3
    captures_a = [rep.engine._graph.captures if rep.engine._graph is not None else 0
                  for rep in fleet.replicas]
    # K1 counted against traced on each replica: one profiled fleet step
    # each, the other replica drained so that only this one decodes (the
    # phase-4 check, per replica, through the fleet's own step).
    k1_traced = []
    if cuda:
        from torch.profiler import ProfilerActivity, profile

        rng = np.random.default_rng(3)
        for rep in fleet.replicas:
            others = [r.index for r in fleet.replicas if r is not rep]
            for o in others:
                fleet.drain(o)
            # A trace short of the count is taken again on fresh requests.
            for attempt in range(1, TRACE_ATTEMPTS + 1):
                for _ in range(f["slots"]):
                    fleet.submit(
                        rng.integers(0, config.vocab_size, f["decode_prompt"]).tolist(),
                        3 * base["chunk"])
                fleet.step()  # dispatch, admission and a first chunk
                torch.cuda.synchronize()
                before = counters["paged_attention"].launches
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                             acc_events=True) as prof:
                    fleet.step()
                    torch.cuda.synchronize()
                counted = counters["paged_attention"].launches - before
                trace = os.path.join(work, f"replica{rep.index}_chunk_trace.json")
                prof.export_chrome_trace(trace)
                with open(trace) as fh:
                    traced = sum(1 for e in json.load(fh)["traceEvents"]
                                 if e.get("cat") == "kernel"
                                 and "paged_decode_kernel" in e["name"])
                fleet.run()
                if counted != L * base["chunk"] or traced > counted:
                    fail(f"fleet (a) replica {rep.index}: K1 counted {counted} over a "
                         f"profiled chunk, traced {traced}, n_layers x chunk "
                         f"{L * base['chunk']}")
                if traced == counted:
                    break
                print(f"  fleet (a) replica {rep.index}: trace {attempt} shows {traced} of "
                      f"{counted} K1 launches; taken again", flush=True)
            else:
                fail(f"fleet (a) replica {rep.index}: none of {TRACE_ATTEMPTS} traces shows "
                     f"K1's {L * base['chunk']} launches")
            k1_traced.append((counted, traced))
            for o in others:
                fleet.resume(o)
    total += settle("(a)", fleet, stats, built)
    for led in ledgers:
        verdict = led.reconcile(expect_quiescent=True)
        if not verdict["ok"]:
            fail(f"fleet (a): ledger {led.name} does not reconcile: {verdict}")
    fverdict = fleet.ledger.reconcile(expect_quiescent=True)
    if not fverdict["ok"]:
        fail(f"fleet (a): the fleet ledger does not reconcile: {fverdict}")
    samples = parse_exposition(registry.render())
    trace_path = os.path.join(work, "fleet_trace.json")
    n_events, n_lanes = export_fleet_trace(trace_path, fobs, observers)
    with open(trace_path) as fh:
        trace = json.load(fh)
    pids = {e.get("pid") for e in trace["traceEvents"]}
    if n_lanes != n or len(pids) < n + 1:
        fail(f"fleet (a): the merged trace covers {n_lanes} replica lanes in "
             f"{len(pids)} processes, wanted {n} and the router")
    if cuda and captures_a != [1] * n:
        fail(f"fleet (a): graph captures a replica {captures_a}, wanted one each")
    snap = fleet.ledger.snapshot()
    print(f"  fleet (a) make_fleet(n={n}) observed, ledgers: {len(rids)} requests open "
          f"loop in {wall_a:.3f} s, {tps_a:.1f} tokens/s ({tps_a / plain:.3f} of phase 4's "
          f"plain drain {plain:.1f}), TTFT p50 {statistics.median(ttft) * 1e3:.1f} ms p99 "
          f"{ttft[min(len(ttft) - 1, int(0.99 * len(ttft)))] * 1e3:.1f} ms, router "
          f"{router_ms:.3f} ms a fleet step over {stats['steps']} steps, captures "
          f"{captures_a}, K1 counted/traced a replica {k1_traced}, ledgers reconciled "
          f"(goodput {snap['goodput_tokens']}, busy {snap['busy_fraction']:.3f}), "
          f"{samples} exposition samples, trace {n_events} events in {len(pids)} "
          f"processes", flush=True)
    close(fleet)
    del fleet, observers, fobs, ledgers, registry
    arm_peak("(h) and (a)")

    # (a'): the same fleet and stream without observers or ledgers.
    fleet = make_fleet(params, cfg16, n, engine_kw=base, chip_ids=chip_ids, device=device,
                       hang_timeout_s=None)
    built = [rep.engine for rep in fleet.replicas]
    stats = instrument(fleet)
    submit_all(fleet, warm)
    fleet.run()
    warm_rids = list(fleet._reqs)
    tokens0 = fleet.generated_tokens
    stats.update(fleet_s=0.0, replica_s=0.0, steps=0)
    t0 = time.perf_counter()
    drive_open_loop(fleet, sched)
    if cuda:
        torch.cuda.synchronize()
    wall_b = time.perf_counter() - t0
    tps_bare = (fleet.generated_tokens - tokens0) / wall_b
    rids = [r for r in fleet._reqs if r not in warm_rids]
    router_bare = (stats["fleet_s"] - stats["replica_s"]) / max(stats["steps"], 1) * 1e3
    captures_b = [rep.engine._graph.captures if rep.engine._graph is not None else 0
                  for rep in fleet.replicas]
    if captures_b != captures_a:
        fail(f"fleet (a'): graph captures {captures_b}, with observers {captures_a}")
    total += settle("(a')", fleet, stats, built)
    print(f"  fleet (a') the same without observers or ledgers: {wall_b:.3f} s, "
          f"{tps_bare:.1f} tokens/s ({tps_bare / plain:.3f} of phase 4's plain drain), "
          f"router {router_bare:.3f} ms a fleet step; observer and ledger overhead "
          f"{(tps_bare / tps_a - 1) * 100:+.2f}% tokens/s, captures {captures_b}",
          flush=True)
    close(fleet)
    del fleet
    arm_peak("(a')")
    print(f"  card note: {n} replicas share one card and step one after another; the "
          f"fleet adds routing, failover and control here, not throughput", flush=True)

    long_reqs = [(list(p), nw) for _, p, nw in traffic(fl["short_requests"],
                                                       fl["long_new"], seed=11)]
    short_reqs = [(list(p), nw) for _, p, nw in traffic(fl["short_requests"],
                                                        fl["short_new"], seed=13)]

    def arm_b(weights, cfg, reqs, label):
        fleet = make_fleet(weights, cfg, n, engine_kw=base, chip_ids=chip_ids,
                           device=device, hang_timeout_s=None,
                           fault_injector=FaultInjector({"replica_crash": 3}))
        built = [rep.engine for rep in fleet.replicas]
        stats = instrument(fleet)
        rids = submit_all(fleet, reqs)
        t0 = time.perf_counter()
        fleet.run()
        wall = time.perf_counter() - t0
        if fleet.replica_crashes != 1 or not fleet.failover_recovery_s:
            fail(f"fleet {label}: crashes {fleet.replica_crashes}, recoveries "
                 f"{fleet.failover_recovery_s}")
        launches = settle(label, fleet, stats, built)
        out = [list(fleet._reqs[r].tokens) for r in rids]
        print(f"  fleet {label} replica_crash on replica 0's second step: {wall:.3f} s, "
              f"failover recovery {[round(s * 1e3, 2) for s in fleet.failover_recovery_s]} "
              f"ms, requeues {fleet.failover_requeues}, tokens replayed "
              f"{fleet.tokens_replayed}", flush=True)
        close(fleet)
        arm_peak(label)
        return out, launches

    def arm_c(weights, cfg, reqs, label):
        kw = dict(base, prefix_cache=True, kv_offload=True)
        fleet = make_fleet(weights, cfg, n, engine_kw=kw, chip_ids=chip_ids, device=device,
                           hang_timeout_s=None, roles=("prefill", "decode"))
        built = [rep.engine for rep in fleet.replicas]
        stats = instrument(fleet)
        rids = submit_all(fleet, reqs)
        tokens0 = fleet.generated_tokens
        t0 = time.perf_counter()
        fleet.run()
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if fleet.kv_handoffs != len(reqs) or fleet.handoff_pages <= 0:
            fail(f"fleet {label}: {fleet.kv_handoffs} handoffs of {len(reqs)} prompts, "
                 f"{fleet.handoff_pages} pages")
        launches = settle(label, fleet, stats, built)
        # The engines' own handoff work (export_kv and import_kv, their
        # spills included) a page moved; the fleet's handoff window runs
        # from the ticket to the decode replica's adoption, queueing
        # behind that replica's decode included.
        host_s = sum(rep.engine.kv_handoff_s + rep.engine.kv_spill_s
                     for rep in fleet.replicas)
        per_page = host_s * 1e3 / fleet.handoff_pages
        window = statistics.median(fleet.handoff_s) * 1e3
        tps = (fleet.generated_tokens - tokens0) / wall
        out = [list(fleet._reqs[r].tokens) for r in rids]
        print(f"  fleet {label} roles prefill/decode, kv_offload: {wall:.3f} s, {tps:.1f} "
              f"tokens/s, {fleet.kv_handoffs} handoffs, {fleet.handoff_pages} pages, "
              f"export and import {per_page:.3f} ms a page, handoff window median "
              f"{window:.1f} ms (ticket to adoption), decode pages in "
              f"{fleet.replicas[1].engine.kv_handoff_pages_in}", flush=True)
        close(fleet)
        arm_peak(label)
        return out, launches, tps

    def arm_d(weights, cfg, reqs, label, oracle_probe):
        fleet = make_fleet(weights, cfg, n, engine_kw=base, chip_ids=chip_ids,
                           device=device, hang_timeout_s=None,
                           fault_injector=FaultInjector({"replica_crash": 3}))
        built = [rep.engine for rep in fleet.replicas]
        stats = instrument(fleet)
        kw = dict(base, rng=prng_key(4242, device))
        factory, oracle = make_engine_factory(
            weights, cfg, engine_kw=kw, probe=fl["probe"] if oracle_probe else None,
            device=device)
        sup = FleetSupervisor(fleet, recording(factory, built),
                              backoff=Backoff(base_s=0.05, max_s=0.5, seed=7),
                              probe=fl["probe"], probe_oracle=oracle)
        if oracle is None:
            oracle = sup.calibrate_probe()
        rids = submit_all(fleet, reqs)
        t0 = time.perf_counter()
        sup.run()
        healed = sup.wait_healed(timeout_s=120.0)
        wall = time.perf_counter() - t0
        kinds = [e.kind for e in sup.events]
        if not healed or sup.restarts_total != 1 or not in_order(
                kinds, ["death", "backoff", "probe", "rejoin"]):
            fail(f"fleet {label}: healed {healed}, restarts {sup.restarts_total}, events "
                 f"{kinds}")
        launches = settle(label, fleet, stats, built)
        out = [list(fleet._reqs[r].tokens) for r in rids]
        print(f"  fleet {label} supervisor: crash, respawn, canary against "
              f"{'the dense generate oracle' if oracle_probe else 'calibrate_probe'} "
              f"{oracle}, rejoin; {wall:.3f} s, respawn to rejoin {sup.restore_ms} ms, "
              f"events {kinds}", flush=True)
        close(fleet)
        arm_peak(label)
        return out, launches

    def arm_g(weights, cfg, reqs, label):
        jdir = os.path.join(work, f"journal-{label}")
        kw = dict(base, prefix_cache=True, kv_offload=True,
                  kv_disk_dir=os.path.join(work, f"disk-{label}"))
        fleet = make_fleet(weights, cfg, n, engine_kw=kw, chip_ids=chip_ids, device=device,
                           hang_timeout_s=None, journal_dir=jdir, journal_every=4)
        built = [rep.engine for rep in fleet.replicas]
        rids = submit_all(fleet, reqs)
        fleet.step()  # admission and one chunk: requests of two chunks stay live
        live = sum(1 for r in rids if not fleet._reqs[r].done)
        close(fleet)
        fresh = make_fleet(weights, cfg, n, engine_kw=kw, chip_ids=chip_ids, device=device,
                           hang_timeout_s=None, journal_dir=jdir)
        built += [rep.engine for rep in fresh.replicas]
        stats = instrument(fresh)
        restored = fresh.restore()
        t0 = time.perf_counter()
        fresh.run()
        wall = time.perf_counter() - t0
        if live == 0 or restored != len(reqs) or fresh.tokens_replayed <= 0:
            fail(f"fleet {label}: {live} live at close, {restored} restored, "
                 f"{fresh.tokens_replayed} tokens replayed")
        finished = set(stats["finished"])
        stats["finished"] += [r for r in rids if fresh._reqs[r].done and r not in finished]
        launches = settle(label, fresh, stats, built)
        out = [list(fresh._reqs[r].tokens) for r in rids]
        print(f"  fleet {label} journal every 4 steps: closed after 1 step with {live} "
              f"live sessions, restored {restored}, replayed {fresh.tokens_replayed} "
              f"tokens, finished in {wall:.3f} s", flush=True)
        close(fresh)
        arm_peak(label)
        return out, launches

    _, launches = arm_b(params, cfg16, long_reqs, "(b)")
    total += launches
    _, launches, tps_c = arm_c(params, cfg16, short_reqs, "(c)")
    total += launches
    print(f"  fleet tokens/s against phase 4's plain drain {plain:.1f}: (a) {tps_a:.1f} "
          f"({tps_a / plain:.3f}), (a') {tps_bare:.1f} ({tps_bare / plain:.3f}), (c) "
          f"{tps_c:.1f} ({tps_c / plain:.3f})", flush=True)
    _, launches = arm_d(params, cfg16, long_reqs, "(d)", oracle_probe=False)
    total += launches

    # (e) the autoscaler, 1 -> 2 replicas under a burst and back after idle.
    fleet = make_fleet(params, cfg16, 1, engine_kw=base, chip_ids=["chip-0"], device=device,
                       hang_timeout_s=None)
    built = [rep.engine for rep in fleet.replicas]
    stats = instrument(fleet)
    factory, _ = make_engine_factory(
        params, cfg16, engine_kw=dict(base, rng=prng_key(4242, device)),
        device=device)
    fast = Backoff(base_s=0.05, max_s=0.2, jitter=0.0)
    asc = FleetAutoscaler(fleet, recording(factory, built), min_replicas=1, max_replicas=2,
                          depth_high=1.0, window_s=0.5, down_consecutive=2, up_backoff=fast,
                          down_backoff=fast, probe=fl["probe"])
    asc.calibrate_probe()
    # A burst of three waves of slots' worth, two chunks a request: the
    # backlog beyond the replica's slots opens the breach at the first
    # poll, and the drained fleet clears it.
    burst = [(0.0, p, nw) for _, p, nw in traffic(3 * f["slots"], fl["long_new"], seed=19)]
    t0 = time.perf_counter()
    rejected = []
    drive_open_loop(asc, burst, on_reject=lambda *a: rejected.append(a))
    quiet = asc.wait_quiescent(timeout_s=60.0)
    wall = time.perf_counter() - t0
    kinds = [e.kind for e in asc.events]
    if asc.scale_ups < 1 or asc.scale_downs < 1 or len(fleet.alive) != 1 or not in_order(
            kinds, ["scale_up", "scale_down"]):
        fail(f"fleet (e): ups {asc.scale_ups} downs {asc.scale_downs} alive "
             f"{len(fleet.alive)} quiescent {quiet} events {kinds}")
    total += settle("(e)", fleet, stats, built)
    print(f"  fleet (e) autoscaler 1 -> 2 -> 1 under a burst of {len(burst)}: {wall:.3f} s, "
          f"ups {asc.scale_ups} downs {asc.scale_downs}, rejected {len(rejected)}, "
          f"recover {asc.recover_ms} ms, events {kinds}", flush=True)
    close(fleet)
    arm_peak("(e)")

    # (f) the goodput controller retunes superstep_k away from dead lanes.
    fleet = make_fleet(params, cfg16, n, engine_kw=dict(base, superstep_k=4),
                       chip_ids=chip_ids, device=device, hang_timeout_s=None,
                       ledger=FleetLedger())
    for i, rep in enumerate(fleet.replicas):
        rep.engine.ledger = ChipTimeLedger(name=str(i))
    built = [rep.engine for rep in fleet.replicas]
    stats = instrument(fleet)
    ctrl = GoodputController(fleet, min_sample_tokens=64,
                             retune_backoff=Backoff(base_s=0.05, max_s=0.2, jitter=0.0))
    tiny = [(list(p), 3) for _, p, _ in traffic(4 * f["slots"], fl["short_new"], seed=23)]
    t0 = time.perf_counter()
    drive_open_loop(ctrl, [(0.0, p, nw) for p, nw in tiny])
    wall = time.perf_counter() - t0
    ks = [rep.engine.superstep_k for rep in fleet.replicas]
    if ctrl.retunes_applied < 1 or min(ks) >= 4:
        fail(f"fleet (f): {ctrl.retunes_applied} retunes, superstep_k {ks}")
    total += settle("(f)", fleet, stats, built)
    caps = [rep.engine._graph.captures if rep.engine._graph is not None else 0
            for rep in fleet.replicas]
    print(f"  fleet (f) goodput controller: {ctrl.retunes_applied} retunes, superstep_k "
          f"4 -> {ks}, graph captures {caps}, {wall:.3f} s, events "
          f"{[e.kind for e in ctrl.events]}", flush=True)
    close(fleet)
    arm_peak("(f)")

    _, launches = arm_g(params, cfg16, long_reqs[:8], "(g)")
    total += launches

    # (i) float32: (a), (b), (c), (g) and (d) against one plain engine.
    w32 = cast_params(params, torch.float32)
    cfg32 = replace(cfg16, dtype=torch.float32)
    reqs32 = [(list(p), nw) for _, p, nw in traffic(fl["f32_requests"], fl["new"], seed=17)]
    plain_engine = ServeEngine(w32, cfg32, **base, device=device)
    prid = submit_all(plain_engine, reqs32)
    served = plain_engine.run()
    want = [served[r] for r in prid]
    total += counters["paged_attention"].launches
    reset_counts(counters)
    del plain_engine

    def hold(label, streams):
        """Each float32 stream equals the plain engine's; a flip only at
        a top-2 gap under FLIP_GAP of the largest logit."""
        for i, (got, ref) in enumerate(zip(streams, want)):
            if got == ref:
                continue
            pos = next((j for j, (a, b) in enumerate(zip(got, ref)) if a != b),
                       min(len(got), len(ref)))
            gap, scale = top2_gap(torch, w32, cfg32, reqs32[i][0], ref, pos)
            print(f"  fleet {label} float32 request {i}: first divergence at token {pos}, "
                  f"top-2 gap {gap:.3e} of max |logit| {scale:.3e}", flush=True)
            if len(got) != len(ref) or gap > FLIP_GAP * scale:
                fail(f"fleet {label}: float32 stream {i} differs from the plain engine's")

    fleet = make_fleet(w32, cfg32, n, engine_kw=base, chip_ids=chip_ids, device=device,
                       observers=[EngineObserver(name=str(i)) for i in range(n)],
                       hang_timeout_s=None, ledger=FleetLedger())
    built = [rep.engine for rep in fleet.replicas]
    stats = instrument(fleet)
    rids = submit_all(fleet, reqs32)
    fleet.run()
    total += settle("(i a)", fleet, stats, built)
    hold("(i a)", [list(fleet._reqs[r].tokens) for r in rids])
    close(fleet)
    arm_peak("(i a)")
    for arm, label in ((arm_b, "(i b)"), (arm_g, "(i g)")):
        streams, launches = arm(w32, cfg32, reqs32, label)
        hold(label, streams)
        total += launches
    streams, launches, _ = arm_c(w32, cfg32, reqs32, "(i c)")
    hold("(i c)", streams)
    total += launches
    streams, launches = arm_d(w32, cfg32, reqs32, "(i d)", oracle_probe=True)
    hold("(i d)", streams)
    total += launches
    print(f"  fleet (i) float32: (a), (b), (c), (d) and (g) equal the plain engine's "
          f"{len(want)} streams", flush=True)
    del w32
    import shutil

    shutil.rmtree(work, ignore_errors=True)
    peak = max(peaks.values(), default=0.0)
    print(f"  fleet phase: {time.perf_counter() - t_phase:.1f} s, K1 launches {total}, "
          f"peak memory {peak:.2f} GiB (the largest arm's)", flush=True)
    return total


# Phase 4g, device-time profiling and fast start at the serving path's
# width.  (a) float32 drains of 8 requests (64-128 new tokens), observed
# with a DeviceTimeTable and a SentryFeed and bare; (b) a two-replica
# fleet behind FleetServer with a supervisor, a bounded capture through
# POST /profile while 8 SSE requests (64-128 new tokens) stream and a
# replica crashes and respawns; (c) fast start on spec="auto" engines
# (the int8 self-draft of phase 4d, gamma 4): a float32 engine primed
# from a snapshot against the engine it came from, then five respawns
# without a snapshot and five with it, alternately, on one bf16 fleet;
# (d) the kernel-build cache across two processes; (e) perfbench's
# latency arm at the full scale.
PROFILE = dict(requests=8, new=(64, 128), f32_max_seq_len=256, capture_secs=2.0,
               capture_requests=8, capture_new=(64, 128), capture_max_bytes=512 * 2**20,
               respawns=5, respawn_requests=2, gamma=4, scale="full")

# The kernel-build cache's two processes: a small engine on the card whose
# first decode loads K1 from the directory given (built there by nvcc in
# the first process, found built in the second).
CACHE_PROBE = """
import json, sys
import torch
from workloads_torch.faststart import cache_stats
from workloads_torch import prng
from workloads_torch.model import ModelConfig, cast_params, init_params
from workloads_torch.serve import ServeEngine
cfg = ModelConfig(vocab_size=256, d_model=256, n_heads=2, n_layers=1, d_ff=512,
                  max_seq_len=64)
params = cast_params(init_params(cfg, prng.PRNGKey(0, device="cuda")), cfg.dtype)
engine = ServeEngine(params, cfg, slots=2, page_size=16, compile_cache_dir=sys.argv[1],
                     device="cuda")
rid = engine.submit([1, 2, 3], 8)
tokens = engine.run()[rid]
print(json.dumps({"hits": engine.compile_cache_hits, "misses": engine.compile_cache_misses,
                  "process": cache_stats(), "tokens": len(tokens)}))
"""


def cache_process(cache_dir: str):
    """Start one kernel-build-cache process (``CACHE_PROBE``) over
    ``cache_dir``; the caller waits for it."""
    return subprocess.Popen([sys.executable, "-c", CACHE_PROBE, cache_dir], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def cache_result(proc, label: str) -> dict:
    out, err = proc.communicate(timeout=600)
    if proc.returncode != 0:
        fail(f"kernel-build cache, {label}: exit {proc.returncode}\n{err[-4000:]}")
    return json.loads(out.strip().splitlines()[-1])


def http_json(method: str, port: int, path: str):
    """One request to the fleet's front end; returns (status, JSON body)."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", method=method,
                                 data=b"" if method == "POST" else None)
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def profiling_phase(torch, params, config, f, counters, pf=PROFILE, fl=FLEET,
                    device="cuda") -> int:
    """Phase 4g: device-time profiling and fast start at the serving
    path's width.  (a) float32 drains observed (a ``DeviceTimeTable``, a
    live ``SentryFeed``) and bare: streams equal, one graph capture an
    engine, K1 n_layers a decode step, and one profiled chunk
    (``profile_chunk``: K1 counted = traced) whose kernel time stands
    beside the observer's ``device_ms`` for that step and its
    ``device_busy_fraction``; (b) ``POST /profile?secs=2`` on a
    two-replica fleet behind ``FleetServer`` while SSE requests stream
    and a replica crashes and respawns (its graph captured under the
    active profile): the trace exists, is within the byte budget and
    names ``paged_decode_kernel``, ``GET /profile`` accounts it, and a
    capture started once the budget is spent is refused with 409; (c) a
    snapshot of a warmed spec="auto" engine primes a fresh one
    (``calibration_reused`` > 0, float32 streams equal to the unprimed
    engine's), then a supervisor respawns replicas of one fleet five
    times without the snapshot and five times with it, alternately,
    each respawn to rejoin timed; (d) ``enable_compile_cache`` on a
    fresh directory counts nvcc's build as a miss in one process and
    the library found built as a hit in a second; (e) perfbench's
    ``measure_serve_latency``.  ``device="cpu"`` rehearses (b), (c) and
    (e) on the plain route.  Returns K1's launches."""
    import statistics
    import tempfile
    import threading
    import urllib.error
    import urllib.request
    from dataclasses import replace

    import numpy as np
    from tpu_device_plugin.metrics import Registry
    from workloads_torch.backoff import Backoff
    from workloads_torch.faststart import EngineSnapshot
    from workloads_torch.faults import FaultInjector
    from workloads_torch.fleet import FleetServer, TrafficGen, make_fleet
    from workloads_torch.model import cast_params
    from workloads_torch.obs import EngineObserver
    from workloads_torch.ops import paged_attention as pa
    from workloads_torch.perfbench import BenchScale, measure_serve_latency
    from workloads_torch.profiler import (DeviceTimeTable, ProfileSession, RegressionSentry,
                                          SentryFeed, device_report)
    from workloads_torch.quant import quantize_params
    from workloads_torch.serve import ServeEngine
    from workloads_torch.supervisor import FleetSupervisor, make_engine_factory

    cuda = device == "cuda"
    L = config.n_layers
    base = dict(slots=f["slots"], page_size=f["page_size"], chunk=f["page_size"], device=device)
    chip_ids = ["chip-0", "chip-1"]
    work = tempfile.mkdtemp(prefix="profiling_phase_")
    t_phase = time.perf_counter()
    total = 0

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def captures(engine):
        return engine._graph.captures if engine._graph is not None else 0

    # (d) starts first: its nvcc build runs while (a)-(c) use the card.
    cache_dir = os.path.join(work, "kernel-cache")
    first = cache_process(cache_dir) if cuda else None

    # (a) profiling is inert: float32 drains observed and bare.
    w32 = cast_params(params, torch.float32)
    cfg32 = replace(config, dtype=torch.float32, max_seq_len=pf["f32_max_seq_len"])
    rng = np.random.default_rng(5)
    reqs = [(rng.integers(0, config.vocab_size, f["decode_prompt"]).tolist(), int(n))
            for n in rng.integers(pf["new"][0], pf["new"][1] + 1, pf["requests"])]
    obs = EngineObserver(name="4g", device_table=DeviceTimeTable())
    obs.bind_registry(Registry())
    sentry = RegressionSentry()
    for name, direction in (("tokens_per_sec", "down_bad"), ("host_sync_ms", "up_bad"),
                            ("ttft_p99_ms", "up_bad"), ("device_busy_fraction", "down_bad")):
        sentry.watch(name, None, 0.25, direction=direction)
    feed = SentryFeed(sentry)

    def serve(label, engine, poll=None):
        engine.submit(reqs[0][0], 2)  # warm-up: the graph's capture
        engine.run()
        rids = [engine.submit(p, n) for p, n in reqs]
        chunks0 = engine.chunks_run
        reset_counts(counters)
        sync()
        t0 = time.perf_counter()
        done = {}
        while not engine.idle:
            for req in engine.step():
                done[req.rid] = req
            if poll is not None:
                poll()
        sync()
        wall = time.perf_counter() - t0
        launches = counters["paged_attention"].launches
        steps = (engine.chunks_run - chunks0) * engine.chunk
        for rid, (_, n) in zip(rids, reqs):
            req = done.get(rid)
            if req is None or req.status != "ok" or len(req.tokens) != n:
                fail(f"profiling (a) {label} {rid}: "
                     f"{None if req is None else (req.status, len(req.tokens))}, wanted ok "
                     f"with {n} tokens")
        if cuda and launches != L * steps:
            fail(f"profiling (a) {label}: K1 launched {launches} times, n_layers x decode "
                 f"steps is {L * steps}")
        print(f"  profiling (a) {label}: {len(reqs)} float32 requests in {wall:.3f} s, "
              f"{sum(n for _, n in reqs) / wall:.1f} tokens/s, K1 {launches}, captures "
              f"{captures(engine)}", flush=True)
        return [list(done[r].tokens) for r in rids], launches

    observed = ServeEngine(w32, cfg32, **base, observer=obs)
    feed.attach(observed, obs)
    streams_on, launches = serve("observed, device table, sentry feed", observed, feed.poll)
    total += launches
    bare = ServeEngine(w32, cfg32, **base)
    streams_off, launches = serve("bare", bare)
    total += launches
    if streams_on != streams_off:
        fail("profiling (a): float32 streams differ with the profiling layer on and off")
    if cuda and (captures(observed), captures(bare)) != (1, 1):
        fail(f"profiling (a): graph captures {captures(observed)} observed, {captures(bare)} "
             f"bare, wanted one each")
    rep = device_report([obs])
    line = (f"  profiling (a) streams equal on and off; observer over the drain: "
            f"device_busy_fraction {obs.device_busy_fraction:.4f} (device {rep['device_ms']:.3f} "
            f"of {rep['wall_ms']:.3f} ms wall), {len(obs.device_table)} table entries, sentry "
            f"{sentry.state()['detectors']['tokens_per_sec']['samples']} windows, fired "
            f"{sentry.fired}")
    print(line, flush=True)
    if cuda:
        step0 = obs._step_index  # the index before profile_chunk's first step
        wall_ms, busy_ms, counted, _, _, ordinal = profile_chunk(torch, observed, rng, f, pa)
        index = step0 + ordinal - 1
        total += counted
        rec = next((r for r in obs.steps if r.index == index), None)
        if rec is None:
            fail("profiling (a): the profiled step has no StepRecord")
        print(f"  profiling (a) the profiled chunk: profiler kernels {busy_ms:.3f} ms of "
              f"{wall_ms:.3f} ms wall (busy {busy_ms / wall_ms:.4f}); the observer's "
              f"StepRecord: device_ms {rec.device_ms:.3f} of {rec.dur_secs * 1e3:.3f} ms wall "
              f"(busy {rec.device_ms / max(rec.dur_secs * 1e3, 1e-9):.4f})", flush=True)
    del observed, bare
    if cuda:
        torch.cuda.empty_cache()

    # (b) a bounded capture through the fleet's front end, with a respawn.
    cfg16 = replace(config, max_seq_len=fl["max_seq_len"])
    injector = FaultInjector()
    fleet = make_fleet(params, cfg16, 2, engine_kw=base, chip_ids=chip_ids, device=device,
                       hang_timeout_s=None, fault_injector=injector)
    built = [rep_.engine for rep_ in fleet.replicas]
    respawned = []
    factory, _ = make_engine_factory(
        params, cfg16, engine_kw=dict(base, rng=prng_key(4242, device)),
        device=device)

    def recording(slot):
        engine = factory(slot)
        built.append(engine)
        if slot is not None:  # not calibrate_probe's scratch engine
            respawned.append(engine)
        return engine

    reset_counts(counters)
    sup = FleetSupervisor(fleet, recording, backoff=Backoff(base_s=0.05, max_s=0.5, seed=7),
                          probe=fl["probe"])
    sup.calibrate_probe()
    session = ProfileSession(os.path.join(work, "profiles"), max_secs=30.0,
                             max_bytes=pf["capture_max_bytes"])
    server = FleetServer(fleet, 0, supervisor=sup, profiler=session)
    port = server.start()
    statuses: dict[str, int] = {}
    lock = threading.Lock()

    def client(prompt, new):
        body = json.dumps({"prompt": prompt, "max_new_tokens": new}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/generate", data=body,
                                     headers={"Content-Type": "application/json"})
        status = None
        try:
            with urllib.request.urlopen(req, timeout=600) as resp:
                for raw in resp:
                    if raw.startswith(b"data: "):
                        ev = json.loads(raw[6:])
                        if ev.get("done"):
                            status = ev["status"]
        except urllib.error.HTTPError as e:
            status = f"HTTP {e.code}: {e.read()[:200]!r}"
        with lock:
            statuses[status] = statuses.get(status, 0) + 1

    def stream(reqs_):
        threads = [threading.Thread(target=client, args=r) for r in reqs_]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        if any(t.is_alive() for t in threads):
            fail("profiling (b): an SSE stream did not end")

    sched = TrafficGen(seed=fl["seed"], rate_rps=fl["rate_rps"], vocab=config.vocab_size,
                       min_prompt=fl["prompt"][0], max_prompt=fl["prompt"][1],
                       min_new=pf["capture_new"][0], max_new=pf["capture_new"][1]
                       ).schedule(pf["capture_requests"])
    stream([(list(p), 4) for _, p, _ in sched[:2]])  # warm-up: the founders capture
    statuses.clear()
    code, started = http_json("POST", port, f"/profile?secs={pf['capture_secs']}")
    t_capture = time.perf_counter()
    if code != 200:
        fail(f"profiling (b): POST /profile answered {code}: {started}")
    injector.reset()
    injector.arm({"replica_crash": 3})
    stream([(list(p), n) for _, p, n in sched])
    deadline = time.monotonic() + 120.0
    while not (sup.healed and not session.active and session.captures) \
            and time.monotonic() < deadline:
        time.sleep(0.05)
    code, state = http_json("GET", port, "/profile")
    events = [(e.kind, e.t - t_capture) for e in sup.events]
    rejoin = next((t for k, t in events if k == "rejoin"), None)
    session.max_bytes = session.bytes_spent  # the operator's budget is now spent
    refused, body = http_json("POST", port, "/profile?secs=1")
    server.stop()
    if code != 200 or len(state["captures"]) != 1:
        fail(f"profiling (b): GET /profile answered {code} with {state}")
    capture = state["captures"][0]
    trace = os.path.join(capture["dir"], "trace.json")
    if not os.path.exists(trace):
        fail(f"profiling (b): no trace at {trace}")
    size = sum(os.path.getsize(os.path.join(r, n)) for r, _, ns in os.walk(capture["dir"])
               for n in ns)
    with open(trace) as fh:
        trace_events = json.load(fh)["traceEvents"]
    k1_traced = sum(1 for e in trace_events
                    if e.get("cat") == "kernel" and "paged_decode_kernel" in e.get("name", ""))
    kernels = sum(1 for e in trace_events if e.get("cat") == "kernel")
    threads_seen = len({e.get("tid") for e in trace_events if e.get("cat") == "cpu_op"})
    if statuses != {"ok": len(sched)} or sup.restarts_total != 1 or fleet.replica_crashes != 1:
        fail(f"profiling (b): statuses {statuses}, restarts {sup.restarts_total}, crashes "
             f"{fleet.replica_crashes}")
    if not in_order([k for k, _ in events], ["death", "backoff", "probe", "rejoin"]):
        fail(f"profiling (b): supervisor events {events}")
    if capture["bytes"] != size or size <= 0 or size > pf["capture_max_bytes"]:
        fail(f"profiling (b): the capture's {capture['bytes']} bytes, {size} on disk, budget "
             f"{pf['capture_max_bytes']}")
    if cuda and (k1_traced == 0 or [captures(e) for e in respawned] != [1]):
        fail(f"profiling (b): {k1_traced} paged_decode_kernel events in the trace, respawned "
             f"engines' captures {[captures(e) for e in respawned]}")
    if refused != 409 or "budget" not in body.get("error", ""):
        fail(f"profiling (b): a capture past the spent budget answered {refused}: {body}")
    launches = counters["paged_attention"].launches
    steps = sum(e.chunks_run for e in built) * base["chunk"]
    if cuda and launches != L * steps:
        fail(f"profiling (b): K1 launched {launches} times, n_layers x decode steps over the "
             f"arm's {len(built)} engines is {L * steps}")
    total += launches
    print(f"  profiling (b) POST /profile?secs={pf['capture_secs']} on {len(chip_ids)} "
          f"replicas while {len(sched)} SSE requests streamed and replica crash "
          f"{fleet.replica_crashes} respawned (events after the capture's start, s: "
          f"{[(k, round(t, 3)) for k, t in events]}; rejoin "
          f"{'inside' if rejoin is not None and rejoin < capture['secs'] else 'after'} the "
          f"capture): {capture['bytes']} bytes over {capture['secs']} s (budget "
          f"{pf['capture_max_bytes']}), {kernels} kernel events, {k1_traced} of them "
          f"paged_decode_kernel, operators on {threads_seen} threads, respawned captures "
          f"{[captures(e) for e in respawned]}; past the spent budget: {refused} "
          f"({body.get('error')})", flush=True)
    fleet.close()
    del fleet, built, respawned, trace_events
    if cuda:
        torch.cuda.empty_cache()

    print(f"  profiling (a) and (b): {time.perf_counter() - t_phase:.1f} s", flush=True)

    # (c) fast start: a float32 snapshot primes a fresh engine, then
    # respawns with and without a snapshot on one bf16 fleet.
    t_arm = time.perf_counter()
    d32 = quantize_params(w32)
    kw32 = dict(base, draft_params=d32, draft_config=cfg32, gamma=pf["gamma"], spec="auto")
    probe = fl["probe"]

    def warmed(engine):
        rid = engine.submit(*probe)
        return list(engine.run()[rid])

    def drain_reqs(engine):
        rids = [engine.submit(p, n) for p, n in reqs]
        served = engine.run()
        return [list(served[r]) for r in rids]

    reset_counts(counters)
    cold = ServeEngine(w32, cfg32, **kw32)
    oracle32 = warmed(cold)
    snap32 = EngineSnapshot.capture(cold, probe=probe, probe_oracle=oracle32)
    cold_streams = drain_reqs(cold)
    primed = ServeEngine(w32, cfg32, **kw32)
    if not snap32.prime(primed):
        fail("fast start (c): a snapshot of the same engine shape did not prime")
    if warmed(primed) != oracle32:
        fail("fast start (c): the primed engine's canary differs from the snapshot's oracle")
    primed_streams = drain_reqs(primed)
    if primed.calibration_reused < 1 or cold.calibration_reused != 0:
        fail(f"fast start (c): calibration_reused {primed.calibration_reused} primed, "
             f"{cold.calibration_reused} cold")
    if primed_streams != cold_streams:
        fail("fast start (c): float32 streams differ with the snapshot and without it")
    if cuda and (captures(cold), captures(primed)) != (1, 1):
        fail(f"fast start (c): captures {captures(cold)} cold, {captures(primed)} primed")
    total += counters["paged_attention"].launches
    print(f"  fast start (c) float32 spec=\"auto\": the snapshot (threshold "
          f"{snap32.spec_breakeven}) primed a fresh engine: calibration_reused "
          f"{primed.calibration_reused}, {len(reqs)} streams equal to the unprimed engine's, "
          f"one capture each; {time.perf_counter() - t_arm:.1f} s", flush=True)
    t_arm = time.perf_counter()
    del cold, primed, d32
    if cuda:
        torch.cuda.empty_cache()

    draft = quantize_params(params)
    spec_kw = dict(base, draft_params=draft, draft_config=cfg16, gamma=pf["gamma"],
                   spec="auto")
    injector = FaultInjector()
    fleet = make_fleet(params, cfg16, 2, engine_kw=spec_kw, chip_ids=chip_ids, device=device,
                       hang_timeout_s=None, fault_injector=injector)
    for i in range(2):  # warm-up: each founder captures and calibrates
        fleet.submit([1 + i], 2)
    fleet.run()
    factory, _ = make_engine_factory(
        params, cfg16, engine_kw=dict(spec_kw, rng=prng_key(4242, device)),
        device=device)
    use_snapshot = [False]
    spawned = []

    def respawn(slot):
        engine = factory(slot)
        if use_snapshot[0] and slot is not None and not snap.prime(engine):
            fail("fast start (c): the snapshot did not prime a respawn")
        spawned.append(engine)
        return engine

    sup = FleetSupervisor(fleet, respawn, backoff=Backoff(base_s=0.05, max_s=0.5, seed=7),
                          probe=probe, crash_loop_k=4 * pf["respawns"])
    oracle = sup.calibrate_probe()
    snap = EngineSnapshot.capture(fleet.replicas[0].engine, probe=probe, probe_oracle=oracle)
    rreqs = [(list(p), n) for _, p, n in TrafficGen(
        seed=11, rate_rps=fl["rate_rps"], vocab=config.vocab_size,
        min_prompt=fl["prompt"][0], max_prompt=fl["prompt"][1], min_new=fl["long_new"][0],
        max_new=fl["long_new"][1]).schedule(pf["respawn_requests"])]
    times = {False: [], True: []}
    reset_counts(counters)
    for i in range(2 * pf["respawns"]):
        use_snapshot[0] = bool(i % 2)
        n_spawned = len(spawned)
        injector.reset()
        injector.arm({"replica_crash": 3})
        rids = [fleet.submit(p, n) for p, n in rreqs]
        sup.run()
        healed = sup.wait_healed(timeout_s=120.0)
        new = spawned[n_spawned:]
        bad = [(r, fleet._reqs[r].status, len(fleet._reqs[r].tokens)) for r, (_, n) in
               zip(rids, rreqs) if fleet._reqs[r].status != "ok" or
               len(fleet._reqs[r].tokens) != n]
        reused = [e.calibration_reused for e in new]
        if not healed or len(sup.restore_s) != i + 1 or len(new) != 1 or bad \
                or reused != [int(use_snapshot[0])]:
            fail(f"fast start (c) respawn {i} (snapshot {use_snapshot[0]}): healed {healed}, "
                 f"restores {len(sup.restore_s)}, engines built {len(new)}, not ok {bad}, "
                 f"calibration_reused {reused}")
        times[use_snapshot[0]].append(sup.restore_s[-1] * 1e3)
    launches = counters["paged_attention"].launches
    if cuda and launches == 0:
        fail("fast start (c): the respawn fleet never launched K1")
    total += launches
    fleet.close()
    for key, label in ((False, "without a snapshot"), (True, "with the snapshot")):
        ms = times[key]
        print(f"  fast start (c) respawn to rejoin {label} (spec=\"auto\", {cfg16.dtype}, "
              f"{len(ms)} respawns): median {statistics.median(ms):.1f} ms, min "
              f"{min(ms):.1f}, max {max(ms):.1f}; each {[round(t, 1) for t in ms]}",
              flush=True)
    print(f"  fast start (c) respawns: {time.perf_counter() - t_arm:.1f} s", flush=True)
    del fleet, draft, spawned, w32
    if cuda:
        torch.cuda.empty_cache()

    # (e) one perfbench arm.
    reset_counts(counters)
    scale = BenchScale.named(pf["scale"])
    t0 = time.perf_counter()
    latency = measure_serve_latency(scale, device=device)
    launches = counters["paged_attention"].launches
    if cuda and launches == 0:
        fail("perfbench (e): measure_serve_latency never launched K1")
    total += launches
    print(f"  perfbench (e) measure_serve_latency at scale {pf['scale']!r} in "
          f"{time.perf_counter() - t0:.1f} s, K1 {launches}:", flush=True)
    print(json.dumps(latency), flush=True)
    # (d) the kernel-build cache across processes: the first has built
    # since the phase began; the second runs alone, after every timing.
    if cuda:
        miss = cache_result(first, "first process")
        hit = cache_result(cache_process(cache_dir), "second process")
        if (miss["misses"], hit["hits"], hit["misses"]) != (1, 1, 0):
            fail(f"kernel-build cache: first process {miss}, second {hit}, wanted one miss "
                 f"then one hit and no miss")
        print(f"  kernel-build cache (d) in {cache_dir}: first process {miss}, second "
              f"{hit}", flush=True)

    import shutil

    shutil.rmtree(work, ignore_errors=True)
    print(f"  profiling phase: {time.perf_counter() - t_phase:.1f} s, K1 launches {total}",
          flush=True)
    return total


def lora_train_path(torch, model_mod, train_mod, counters, f, device="cuda",
                    steps=4) -> dict:
    """Phase 6e: the LoRA fine-tune (``lora.make_lora_train_step``) at
    phase 6's shape, rank 8, AdamW at 1e-3 (the JAX CLI's optimizer),
    ``steps`` steps on one fixed batch, then one step over the int8
    base.  Gates: the loss falls, the base is bit-unchanged, only the
    adapter leaves move, K2/K3/K4 launch n_layers times a step; the int8
    step's loss is finite.  Returns the kernels' launches over the main
    steps."""
    from workloads_torch.lora import lora_init, make_lora_train_step
    from workloads_torch.quant import quantize_params

    cuda = device == "cuda"
    config = model_mod.ModelConfig(
        d_model=f["d_model"], n_heads=f["n_heads"], n_layers=f["n_layers"],
        d_ff=f["d_ff"], vocab_size=f["vocab_size"], max_seq_len=f["train_seq"],
        dtype=torch.bfloat16, attention_impl="flash",
    )
    B, L = f["train_batch"], config.n_layers
    base = model_mod.init_params(config, prng_key(0, device))
    kept = [t.clone() for t in train_mod.tree_leaves(base)]
    adapters = lora_init(config, 8, prng_key(1, device))
    start = [t.clone() for t in train_mod.tree_leaves(adapters)]
    optimizer = train_mod.AdamW(lr=1e-3, mu_dtype=torch.float32)
    state = optimizer.init(adapters)
    step = make_lora_train_step(config, optimizer, base)
    fixed = train_mod.synthetic_batch(config, B, seed=0, device=device)
    n_factors = sum(t.numel() for t in start)
    print(f"  LoRA rank 8 on {sorted(adapters[0])}, {n_factors} trained float32 values "
          f"over a frozen float32 base; batch {B} x {config.max_seq_len} tokens, AdamW lr "
          f"1e-3 (mu float32)", flush=True)
    reset_counts(counters)
    losses, times = [], []
    for _ in range(steps):
        if cuda:
            ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            ev0.record()
        adapters, state, loss = step(adapters, state, fixed)
        if cuda:
            ev1.record()
            torch.cuda.synchronize()
            times.append(ev0.elapsed_time(ev1))
        losses.append(loss.item())
    launches = read_counts(counters)
    print(f"  losses over {steps} steps on one batch: {[round(x, 5) for x in losses]}",
          flush=True)
    print(f"  launches over {steps} steps: {launches}", flush=True)
    if times:
        ms = sum(times[1:]) / len(times[1:])
        print(f"  LoRA step {ms:.1f} ms (CUDA events, mean of steps 2-{steps}), "
              f"{B * (config.max_seq_len - 1) / ms * 1e3:.1f} tokens/s", flush=True)
    if not all(x == x and abs(x) < 1e9 for x in losses):
        fail("non-finite LoRA loss")
    if not losses[-1] < losses[0]:
        fail(f"the LoRA loss did not fall over {steps} steps on one batch: {losses}")
    if not all(torch.equal(a, b) for a, b in zip(train_mod.tree_leaves(base), kept)):
        fail("the LoRA step changed the frozen base")
    moved = sum(not torch.equal(a, b) for a, b in zip(train_mod.tree_leaves(adapters), start))
    print(f"  base bit-unchanged; {moved} of {len(start)} adapter leaves moved", flush=True)
    if moved == 0:
        fail("no adapter leaf moved")
    if cuda:
        want = {"paged_attention": 0, "flash_fwd": L * steps, "flash_bwd_dq": L * steps,
                "flash_bwd_dkv": L * steps}
        if launches != want:
            fail(f"LoRA launches {launches}, expected {want}")
    del kept, state
    qbase = quantize_params(base)
    del base
    if cuda:
        torch.cuda.empty_cache()
    q_step = make_lora_train_step(config, optimizer, qbase)
    adapters, _, q_loss = q_step(adapters, optimizer.init(adapters), fixed)
    print(f"  one step over the int8 base: loss {q_loss.item():.5f}", flush=True)
    if not q_loss.item() == q_loss.item():
        fail("non-finite LoRA loss over the int8 base")
    return launches


# Phase 4h: perfbench's engine arms of this slice and the keys each must
# publish (their own checks hold the streams they compare equal).
BENCH_ENGINE_KEYS = {
    "measure_fault_recovery": (
        "fault_recovery_ms", "fault_recovery_ms_min", "fault_recovery_ms_max",
        "fault_recovery_requeued", "fault_injector_off_overhead_pct",
        "fault_injector_off_overhead_pct_min", "fault_injector_off_overhead_pct_max"),
    "measure_spec_serve": (
        "spec_serve_tokens_per_sec", "spec_pipelined_speedup",
        "spec_lookahead_speedup", "spec_serve_lookahead_tokens_per_sec"),
    "measure_spec_economics": (
        "spec_vs_plain_decode_b1", "spec_vs_plain_decode_b4", "spec_acceptance_rate",
        "spec_tokens_per_round", "spec_round_ms", "spec_round_readback_ms"),
    "measure_spec_phases": (
        "spec_breakeven_batch", "spec_phase_dominant", "spec_phase_tokens_per_round",
        "spec_draft_ms_b1", "spec_verify_ms_b1", "spec_commit_ms_b1",
        "spec_phase_plain_step_ms_b1", "spec_phase_ratio_b1"),
    "measure_spec_engine": (
        "spec_engine_vs_plain_b1", "spec_engine_vs_plain_b4", "spec_engine_best_k",
        "spec_engine_spec_steps_b1", "spec_engine_plain_steps_b1",
        "spec_engine_spec_steps_b4", "spec_engine_plain_steps_b4"),
    "measure_spec_superstep": (
        "spec_superstep_best_k", "spec_superstep_tokens_per_sec",
        "spec_superstep_speedup", "spec_superstep_overdecode_pct",
        "spec_superstep_tokens_per_sec_samples"),
    "measure_multi_lora": (
        "multi_lora_tokens_per_sec", "multi_lora_base_tokens_per_sec",
        "multi_lora_relative_throughput"),
    "measure_prefix_serve": (
        "prefix_serve_speedup", "prefix_prefill_tokens_saved_fraction"),
    "measure_kv_hierarchy": (
        "kv_multiturn_speedup", "kv_flat_hit_pages", "kv_radix_hit_pages",
        "kv_oversub_pool_pages", "kv_oversub_live_pages", "kv_offload_spills",
        "kv_offload_reloads", "kv_resident_pages_saved", "kv_offload_reload_ms"),
}


def bench_engine_phase(torch, pb, counters, scale_name="tiny", device="cuda",
                       arms=tuple(BENCH_ENGINE_KEYS)) -> dict:
    """Phase 4h: perfbench's fault, speculation, multi-LoRA, prefix and
    KV arms at ``scale_name`` on ``device`` (``measure_spec_engine`` takes
    the phases arm's ``spec_breakeven_batch``), each holding the streams
    it compares equal; then ``serve.serve_batch``'s float32 lock-step
    tokens against ``generate``.  Gates: every arm's keys, the lock-step
    tokens and pages, K1 launched (n_layers a lock-step decode step)
    and no flash kernel.  Returns the launch counts over the phase."""
    import numpy as np

    from workloads_torch.generate import generate
    from workloads_torch.model import ModelConfig, init_params
    from workloads_torch.paged import PagePool, init_page_pools
    from workloads_torch.serve import serve_batch

    cuda = device == "cuda"
    scale = pb.BenchScale.named(scale_name)
    reset_counts(counters)
    out: dict = {}
    for name in arms:
        t0 = time.perf_counter()
        if name == "measure_spec_engine":
            got = pb.measure_spec_engine(scale, out["spec_breakeven_batch"], device)
        else:
            got = getattr(pb, name)(scale, device)
        missing = [key for key in BENCH_ENGINE_KEYS[name] if key not in got]
        if missing:
            fail(f"perfbench {name} at the {scale_name} scale did not publish {missing}")
        print(f"  {name} ({time.perf_counter() - t0:.1f} s): "
              + ", ".join(f"{key} {got[key]}" for key in BENCH_ENGINE_KEYS[name]),
              flush=True)
        out.update(got)
    # The lock-step baseline, float32, against generate().
    config = ModelConfig(max_seq_len=64, n_layers=2, dtype=torch.float32)
    params = init_params(config, prng_key(0, device))
    prompts = torch.as_tensor(
        np.random.default_rng(1).integers(0, config.vocab_size, (2, 8)), device=device)
    ctrl = PagePool(n_pages=32, page_size=4)
    pools = init_page_pools(config, 32, 4, device)
    k1 = counters["paged_attention"].launches
    got, _ = serve_batch(params, config, prompts, 10, ctrl, pools)
    k1 = counters["paged_attention"].launches - k1
    want = generate(params, prompts, config, 10, device=device)
    print(f"  serve_batch float32, 2 rows x 10 tokens: equal to generate "
          f"{torch.equal(got, want)}, pages in use after {ctrl.used_pages}, K1 launches "
          f"{k1}", flush=True)
    if not torch.equal(got, want) or ctrl.used_pages:
        fail("serve_batch's lock-step tokens differ from generate's or it kept pages")
    if cuda:
        torch.cuda.synchronize()
    launches = read_counts(counters)
    print(f"  launches over the phase: {launches}", flush=True)
    if cuda and (k1 != config.n_layers * 9 or launches["paged_attention"] <= k1):
        fail(f"K1 launched {k1} times in the lock-step run (expected "
             f"{config.n_layers * 9}) and {launches['paged_attention']} over the phase")
    if any(launches[name] for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")):
        fail(f"the engine arms launched a flash kernel: {launches}")
    return launches


# Phase 4i: perfbench's fleet arms and the keys each must publish: JAX's
# tests/test_perfbench.py's (fleet, self-healing, KV-page scheduling), the
# keys of the arms that test leaves out, and the port's counts of the
# streams a replay kept whole.
BENCH_FLEET_KEYS = {
    "measure_fleet": (
        "fleet_replicas", "fleet_tokens_per_sec", "fleet_ttft_p50_ms", "fleet_ttft_p99_ms",
        "router_overhead_ms", "router_overhead_ms_min", "router_overhead_ms_max",
        "failover_recovery_ms", "failover_recovery_ms_min", "failover_recovery_ms_max",
        "failover_requeued", "failover_replay_streams_equal", "failover_replay_streams",
        "fleet_trace_overhead_pct", "fleet_slo_attainment_interactive",
        "fleet_slo_attainment_bulk"),
    "measure_disagg": (
        "disagg_handoffs", "disagg_handoff_pages", "disagg_handoff_ms",
        "disagg_vs_mixed_tokens_per_sec", "disagg_vs_mixed_tokens_per_sec_min",
        "disagg_vs_mixed_tokens_per_sec_max", "disagg_schedule_stats",
        "disagg_streams_equal"),
    "measure_selfheal": (
        "selfheal_restore_ms", "selfheal_restore_ms_min", "selfheal_restore_ms_max",
        "selfheal_capacity_recovered", "selfheal_goodput_retained", "selfheal_crash_loops",
        "selfheal_replay_streams_equal", "selfheal_replay_streams",
        "replica_restore_cold_ms", "replica_restore_warm_ms"),
    "measure_autoscale": (
        "autoscale_calm_rps", "autoscale_service_rps", "autoscale_scale_ups",
        "autoscale_scale_downs", "autoscale_scaled_back", "autoscale_recover_slo_ms",
        "autoscale_overprovision_chip_s", "autoscale_preempts",
        "autoscale_preempt_resume_ms", "autoscale_preempt_streams_equal"),
    "measure_kv_sched": (
        "kvsched_vs_replica_tokens_per_sec", "kvsched_vs_replica_tokens_per_sec_min",
        "kvsched_vs_replica_tokens_per_sec_max", "kvsched_busy_fraction",
        "kvsched_goodput_fraction", "kvsched_page_waste_pct", "kvsched_page_dispatches",
        "kvsched_offload_spills"),
    "measure_durability": (
        "durable_restore_ms", "durable_restore_ms_samples", "kv_disk_reload_ms",
        "kv_disk_reload_ms_samples", "durable_sessions_per_hbm_page",
        "durable_off_tokens_per_sec", "durable_replay_streams_equal"),
    "measure_goodput_ctrl": (
        "ctrl_vs_static_tokens_per_sec", "ctrl_vs_static_tokens_per_sec_samples",
        "ctrl_goodput_fraction", "ctrl_static_goodput_fraction", "ctrl_retunes_applied",
        "ctrl_overhead_pct", "ctrl_streams_equal"),
}


def bench_fleet_gates(got: dict) -> list[str]:
    """JAX's value assertions over the fleet arms' keys (its
    tests/test_perfbench.py), and the counts every arm that compares
    streams must report whole at the tiny scale, which computes in
    float32; returns the ones that fail."""
    checks = {
        "fleet_replicas == 4": got["fleet_replicas"] == 4,
        "fleet_tokens_per_sec > 0": got["fleet_tokens_per_sec"] > 0,
        "failover_recovery_ms > 0": got["failover_recovery_ms"] > 0,
        "failover_requeued >= 1": got["failover_requeued"] >= 1,
        "selfheal_restore_ms > 0": got["selfheal_restore_ms"] > 0,
        "selfheal_capacity_recovered == 1.0": got["selfheal_capacity_recovered"] == 1.0,
        "selfheal_goodput_retained == 1.0": got["selfheal_goodput_retained"] == 1.0,
        "selfheal_crash_loops == 1": got["selfheal_crash_loops"] == 1,
        "replica_restore_warm_ms > 0": got["replica_restore_warm_ms"] > 0,
        "replica_restore_cold_ms > 0": got["replica_restore_cold_ms"] > 0,
        "0 < kvsched_busy_fraction <= 1": 0.0 < got["kvsched_busy_fraction"] <= 1.0,
        "0 < kvsched_goodput_fraction <= 1": 0.0 < got["kvsched_goodput_fraction"] <= 1.0,
        "kvsched_page_dispatches > 0": got["kvsched_page_dispatches"] > 0,
        "kvsched_offload_spills >= 1": got["kvsched_offload_spills"] >= 1,
        "0 <= kvsched_page_waste_pct <= 100": 0.0 <= got["kvsched_page_waste_pct"] <= 100.0,
        "disagg_handoffs >= 1": got["disagg_handoffs"] >= 1,
        "autoscale_preempts >= 1": got["autoscale_preempts"] >= 1,
    }
    for equal, total in (("failover_replay_streams_equal", "failover_replay_streams"),
                         ("disagg_streams_equal", "disagg_streams"),
                         ("selfheal_replay_streams_equal", "selfheal_replay_streams"),
                         ("autoscale_preempt_streams_equal", "autoscale_preempt_streams"),
                         ("durable_replay_streams_equal", "durable_replay_streams"),
                         ("ctrl_streams_equal", "ctrl_streams")):
        checks[f"{equal} == {total}"] = got[equal] == got[total]
    return [name for name, ok in checks.items() if not ok]


def bench_fleet_phase(torch, pb, counters, scale_name="tiny", device="cuda",
                      arms=tuple(BENCH_FLEET_KEYS)) -> dict:
    """Phase 4i: perfbench's seven fleet arms at ``scale_name`` on
    ``device``, each holding the streams it compares (``tiny`` computes
    in float32, so every stream whole), each arm's seconds and peak
    device memory printed.  Gates: every arm's keys, JAX's value
    assertions (``bench_fleet_gates``), K1 launched and no flash kernel.
    Returns the launch counts over the phase."""
    cuda = device == "cuda"
    scale = pb.BenchScale.named(scale_name)
    reset_counts(counters)
    out: dict = {}
    for name in arms:
        got, secs, peak = pb._timed_arm(getattr(pb, name), scale, torch.device(device))
        missing = [key for key in BENCH_FLEET_KEYS[name] if key not in got]
        if missing:
            fail(f"perfbench {name} at the {scale_name} scale did not publish {missing}")
        mem = f"{peak:.2f} GiB" if peak is not None else "not measured (no card)"
        print(f"  {name} ({secs:.1f} s, peak device memory {mem}): "
              + ", ".join(f"{key} {got[key]}" for key in BENCH_FLEET_KEYS[name]),
              flush=True)
        out.update(got)
    if set(arms) == set(BENCH_FLEET_KEYS):
        failed = bench_fleet_gates(out)
        if failed:
            fail(f"perfbench's fleet arms at the {scale_name} scale: {failed}")
        print("  JAX's value assertions and the whole-stream counts hold", flush=True)
    if cuda:
        torch.cuda.synchronize()
    launches = read_counts(counters)
    print(f"  launches over the phase: {launches}", flush=True)
    if cuda and launches["paged_attention"] <= 0:
        fail(f"the fleet arms launched no K1: {launches}")
    if any(launches[name] for name in FLASH_KERNELS):
        fail(f"the fleet arms launched a flash kernel: {launches}")
    return launches


# Phase 4j, tensor-parallel serving: phase 4's model and 12-request
# stream on a ("data", "model") mesh of (1, 2), two ranks on the one card.
# NCCL refuses two ranks on one device ("Duplicate GPU detected"), so the
# world is gloo, which stages each all-reduce through host memory: its
# times say nothing of TP speed.  Arms, float32, each against the
# one-device engine token for token: (a) plain, (b) superstep_k=4
# pipelined, (c) the int8 self-draft at gamma 4, (d) two rank-8 adapters
# (seed 99) and the base round-robin; then one bf16 teacher-forced step.
TP = dict(ranks=2, gamma=4, superstep_k=4, lora_n=2, lora_rank=8, lora_seed=99,
          step_lengths=(32, 100, 200, 300, 400, 500, 543, 1), all_reduces=100,
          timeout_s=900)
# The bf16 step's limit: its max and rms distance from one device's float32
# step within this factor of one device's bf16 step's (the bf16 floor).
# A rank rounds its partial wo and w_down products to bf16 before the sum,
# one more rounding of each row-parallel product than one device makes: at
# most twice the rounding variance, so sqrt 2 of the floor.  (NVIDIA H100
# 80GB HBM3, 700 W: the TP step sat at 1.11 x the floor's max and 1.04 x
# its rms.)
TP_BF16_FLOOR_FACTOR = 2.0**0.5
TP_ARMS = ("(a) plain", "(b) superstep_k=4 pipelined", "(c) int8 self-draft gamma 4",
           "(d) two adapters and the base")


def tp_config(torch, f, dtype):
    from workloads_torch.model import ModelConfig

    return ModelConfig(d_model=f["d_model"], n_heads=f["n_heads"], n_layers=f["n_layers"],
                       d_ff=f["d_ff"], vocab_size=f["vocab_size"],
                       max_seq_len=f["decode_prompt"] + f["decode_lens"][1], dtype=dtype)


def tp_serve_arms(torch, f, tp, requests, device, mesh=None) -> dict:
    """Phase 4j's four float32 drains of ``requests`` ([(prompt, n)]) on
    one device (``mesh`` None) or on this rank of ``mesh``: per arm the
    streams, statuses, pages left in use, K1 launches and seconds."""
    from workloads_torch.model import init_params
    from workloads_torch.multi_lora import synthetic_adapters
    from workloads_torch.ops import paged_attention as pa
    from workloads_torch.quant import quantize_params
    from workloads_torch.serve import ServeEngine

    config = tp_config(torch, f, torch.float32)
    params = init_params(config, prng_key(0, device))
    adapters = synthetic_adapters(config, tp["lora_n"], rank=tp["lora_rank"],
                                  seed=tp["lora_seed"], device=device)
    tenants = [None] + sorted(adapters)
    arms = {TP_ARMS[0]: {}, TP_ARMS[1]: dict(superstep_k=tp["superstep_k"], pipelined=True),
            TP_ARMS[2]: dict(draft_params=quantize_params(params), draft_config=config,
                             gamma=tp["gamma"]),
            TP_ARMS[3]: dict(adapters=adapters)}
    base = dict(slots=f["slots"], page_size=f["page_size"], chunk=f["page_size"],
                device=device.type, mesh=mesh)
    out = {}
    for name, kw in arms.items():
        engine = ServeEngine(params, config, **base, **kw)
        lora = "adapters" in kw
        pa.paged_attention.launches = 0
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        rids = [engine.submit(p, n, adapter=tenants[i % len(tenants)] if lora else None)
                for i, (p, n) in enumerate(requests)]
        served = engine.run()
        if device.type == "cuda":
            torch.cuda.synchronize()
        status = {r.rid: r.status for r in engine.completed}
        out[name] = {"streams": [[int(t) for t in served.get(r, [])] for r in rids],
                     "statuses": [status.get(r) for r in rids],
                     "used_pages": engine.ctrl.used_pages, "k1": pa.paged_attention.launches,
                     "seconds": time.perf_counter() - t0}
        del engine
    return out


def tp_step(torch, f, tp, dtype, device, mesh=None):
    """One teacher-forced decode step of phase 4's model in ``dtype`` at
    ``tp["step_lengths"]``, through K1 on the card, on one device or on
    this rank of ``mesh`` (its cut of the weights and pools, the
    row-parallel all-reduce): the float32 logits, on the host."""
    from workloads_torch import paged, tp_serve
    from workloads_torch.model import cast_params, init_params

    config = tp_config(torch, f, dtype)
    params = cast_params(init_params(tp_config(torch, f, torch.float32),
                                     prng_key(0, device)), dtype)
    lengths, ps = list(tp["step_lengths"]), f["page_size"]
    cover = -(-max(lengths) // ps)
    n_pages = len(lengths) * cover
    reduce = None
    with torch.inference_mode():
        if mesh is None:
            pools = paged.init_page_pools(config, n_pages, ps, device)
        else:
            pools = tp_serve.init_shard_pools(config, n_pages, ps, mesh, device)
            params = tp_serve.shard_params(params, config, mesh)
            reduce = tp_serve.model_all_reduce(mesh)
        tables = torch.arange(n_pages, dtype=torch.int32, device=device).reshape(
            len(lengths), cover)
        g = torch.Generator(device).manual_seed(5)
        prompts = torch.randint(0, config.vocab_size, (len(lengths), cover * ps), generator=g,
                                device=device)
        lens = torch.tensor(lengths, dtype=torch.int32, device=device)
        paged.paged_prefill_chunk(params, pools, tables, prompts, lens, config, 0, cover,
                                  emit=False, reduce=reduce)
        tok = torch.randint(0, config.vocab_size, (len(lengths),), generator=g, device=device)
        tables_dec = torch.cat([tables, torch.full((len(lengths), 1), n_pages,
                                                   dtype=torch.int32, device=device)], 1)
        logits, _ = paged._decode_core(params, pools, tables_dec.contiguous(), tok,
                                       lens.long(), config, reduce=reduce)
    return logits.float().cpu()


def tp_rank(rank, world, store, out_path, f, tp, requests, device_type):
    """One rank of phase 4j: join the gloo world, build the (1, world)
    mesh, run the arms and the bf16 and float32 steps on its cut, and
    write what it saw to ``out_path``.  An exception ends the process
    with a non-zero code, which fails the phase."""
    import datetime
    import pickle

    import torch

    sys.path.insert(0, ROOT)
    from workloads_torch import tp_serve
    from workloads_torch.ops import paged_attention as pa
    from workloads_torch.train import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device_type == "cpu":
        torch.set_num_threads(1)  # the ranks share the host's cores
    t0 = time.perf_counter()
    torch.distributed.init_process_group(
        "gloo", store=torch.distributed.FileStore(store, world), rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=tp["timeout_s"]))
    mesh = make_mesh(world, model_parallel=world, device_type=device_type)
    device = tp_serve.mesh_device(mesh)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    arms = tp_serve_arms(torch, f, tp, requests, device, mesh)
    pa.paged_attention.launches = 0
    steps = {str(dtype): tp_step(torch, f, tp, dtype, device, mesh)
             for dtype in (torch.float32, torch.bfloat16)}
    step_k1 = pa.paged_attention.launches
    # One row-parallel all-reduce as a decode step makes it: [slots,
    # d_model] float32 over the model group, host clock to a synchronise.
    x = torch.ones((f["slots"], f["d_model"]), device=device)
    reduce = tp_serve.model_all_reduce(mesh)
    for _ in range(5):
        reduce(x)
    if cuda:
        torch.cuda.synchronize(device)
    t_ar = time.perf_counter()
    for _ in range(tp["all_reduces"]):
        reduce(x)
    if cuda:
        torch.cuda.synchronize(device)
    all_reduce_ms = (time.perf_counter() - t_ar) / tp["all_reduces"] * 1e3
    out = {"arms": arms, "steps": {k: v.numpy() for k, v in steps.items()},
           "step_k1": step_k1, "all_reduce_ms": all_reduce_ms,
           "backend": torch.distributed.get_backend(mesh.get_group("model")),
           "peak_gib": torch.cuda.max_memory_allocated(device) / 2**30 if cuda else None,
           "seconds": time.perf_counter() - t0}
    torch.distributed.destroy_process_group()
    with open(out_path, "wb") as fh:
        pickle.dump(out, fh)


def _max_rms(d) -> tuple[float, float]:
    import numpy as np

    return float(np.abs(d).max()), float(np.sqrt((d.astype(np.float64) ** 2).mean()))


def tp_gates(one: dict, ranks: list, f32_tol: float, card: bool = True) -> list[str]:
    """Phase 4j's gates over the one-device arms and steps (``one``) and
    each rank's results: each failure names its arm or step and rank.
    ``card``: K1 must have launched (off the card its plain version runs
    and counts nothing)."""
    failed = []
    for name in TP_ARMS:
        want = one["arms"][name]
        if any(s != "ok" for s in want["statuses"]):
            failed.append(f"{name} on one device: statuses {want['statuses']}")
        for r, got in enumerate(ranks):
            arm = got["arms"][name]
            bad = [i for i, (a, b) in enumerate(zip(arm["streams"], want["streams"])) if a != b]
            if bad or len(arm["streams"]) != len(want["streams"]):
                failed.append(f"{name} rank {r}: streams {bad} differ from one device's")
            if arm["statuses"] != want["statuses"]:
                failed.append(f"{name} rank {r}: statuses {arm['statuses']}")
            if arm["used_pages"] != 0:
                failed.append(f"{name} rank {r}: {arm['used_pages']} pages in use after drain")
            if card and arm["k1"] <= 0:
                failed.append(f"{name} rank {r}: K1 launched {arm['k1']} times")
    s32 = one["steps"]["torch.float32"]
    floor = _max_rms(one["steps"]["torch.bfloat16"] - s32)
    for r, got in enumerate(ranks):
        err32 = _max_rms(got["steps"]["torch.float32"] - s32)[0]
        err16 = _max_rms(got["steps"]["torch.bfloat16"] - s32)
        if not err32 <= f32_tol:
            failed.append(f"float32 step rank {r}: {err32:.4e} from one device's "
                          f"(limit {f32_tol:.4e})")
        if not all(e <= TP_BF16_FLOOR_FACTOR * fl for e, fl in zip(err16, floor)):
            failed.append(f"bf16 step rank {r}: max {err16[0]:.4e} rms {err16[1]:.4e} from "
                          f"one device's float32 step (limits: sqrt 2 x the bf16 floor, "
                          f"max {floor[0]:.4e} rms {floor[1]:.4e})")
    return failed


def tp_phase(torch, f, requests, tp=TP, device="cuda") -> int:
    """Phase 4j: tensor-parallel serving on ``tp["ranks"]`` gloo ranks of
    the one ``device``, each holding its cut of phase 4's weights and
    pools.  One device's arms and steps first, in this process; then the
    world, spawned, whose ranks must each exit 0 within the time limit
    (a rank that fails ends the phase and the run).  Returns the K1
    launches of every rank's arms."""
    t0 = time.perf_counter()
    dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    requests = [([int(t) for t in p], int(n)) for p, n in requests]
    one = {"arms": tp_serve_arms(torch, f, tp, requests, dev),
           "steps": {str(dt): tp_step(torch, f, tp, dt, dev).numpy()
                     for dt in (torch.float32, torch.bfloat16)}}
    s32, s16 = one["steps"]["torch.float32"], one["steps"]["torch.bfloat16"]
    floor = _max_rms(s16 - s32)
    f32_tol = STEP_F32_RTOL * float(abs(s32).max())
    arm_s = ", ".join(f"{n} {a['seconds']:.2f} s" for n, a in one["arms"].items())
    print(f"  one device: {arm_s}; the step's bf16 floor (one device's bf16 vs float32) "
          f"max {floor[0]:.4e} rms {floor[1]:.4e}", flush=True)
    t_world = time.perf_counter()
    ranks = spawn_world(tp_rank, tp, (f, tp, requests, device), "4j")
    world_s = time.perf_counter() - t_world
    for r, got in enumerate(ranks):
        mem = f"{got['peak_gib']:.2f} GiB" if got["peak_gib"] is not None else \
            "not measured (no card)"
        print(f"  rank {r} ({got['backend']}): K1 launches "
              + ", ".join(f"{n} {a['k1']}" for n, a in got["arms"].items())
              + f", steps {got['step_k1']}; peak device memory {mem}; "
              f"{got['seconds']:.1f} s in the rank; one all-reduce of [{f['slots']}, "
              f"{f['d_model']}] float32 {got['all_reduce_ms']:.4f} ms (mean of "
              f"{tp['all_reduces']})", flush=True)
        print(f"  rank {r} arm seconds: "
              + ", ".join(f"{n} {a['seconds']:.2f}" for n, a in got["arms"].items()),
              flush=True)
    lim = TP_BF16_FLOOR_FACTOR
    for r, got in enumerate(ranks):
        e32 = _max_rms(got["steps"]["torch.bfloat16"] - s32)
        e16 = _max_rms(got["steps"]["torch.bfloat16"] - s16)
        print(f"  rank {r} bf16 step vs one device's float32 step: max {e32[0]:.4e} rms "
              f"{e32[1]:.4e} (limits {lim:.4f} x the floor: {lim * floor[0]:.4e}, "
              f"{lim * floor[1]:.4e}); vs one device's bf16 step: max {e16[0]:.4e} rms "
              f"{e16[1]:.4e}; float32 step max "
              f"{_max_rms(got['steps']['torch.float32'] - s32)[0]:.4e} "
              f"(limit {f32_tol:.4e})", flush=True)
    failed = tp_gates(one, ranks, f32_tol, card=device == "cuda")
    if failed:
        fail(f"phase 4j: {failed}")
    tokens = sum(len(s) for s in one["arms"][TP_ARMS[0]]["streams"])
    print(f"  {tp['ranks']} ranks over gloo on one {device} device: every arm's float32 "
          f"streams ({tokens} tokens an arm) equal one device's on every rank, the bf16 "
          f"step within sqrt 2 of its floor; world {world_s:.1f} s, phase "
          f"{time.perf_counter() - t0:.1f} s (gloo stages each all-reduce through host "
          f"memory: these times say nothing of TP speed)", flush=True)
    return sum(a["k1"] for got in ranks for a in got["arms"].values())


FLASH_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def bench_kernel_phase(torch, pb, ks, model_mod, fa, counters, phase6=None,
                       scale_name="full", device="cuda", chain_links=8):
    """Phase 6f: perfbench's ``measure_train``, ``measure_flash_vs_xla``,
    ``measure_window`` and ``measure_paged_decode`` at ``scale_name``.
    The attention arms time CUDA-graph replays, which call no Python, so
    the wrappers count only the warm-ups and the captures: a profiled
    chain of ``chain_links`` replays must trace that many K2, K3 and K4
    launches (the dense chain none) in one of ``TRACE_ATTEMPTS`` traces,
    none tracing more, and a graphed chain must equal the
    eager chain bit for bit, its links moving q.  The kernel table round trip: the sweep's
    picks through ``kernel_pick_seq*`` and ``table_from_artifact`` come
    back the same, and ``model._pick_kernel`` under ``set_kernel_table``
    agrees at each swept length.  The train arm's step time and MFU are
    printed beside phase 6's ``phase6`` = (ms, mfu).  Returns (launch
    counts over the four arms, the train arm's keys)."""
    cuda = device == "cuda"
    scale = pb.BenchScale.named(scale_name)
    reset_counts(counters)
    t0 = time.perf_counter()
    train = pb.measure_train(scale, device)
    attn = pb.measure_flash_vs_xla(scale, device)
    window = pb.measure_window(scale, device)
    paged = pb.measure_paged_decode(scale, device)
    if cuda:
        torch.cuda.synchronize()
    launches = read_counts(counters)
    print(f"  four arms in {time.perf_counter() - t0:.1f} s; launches counted (eager "
          f"steps, warm-ups, captures; a replay counts none): {launches}", flush=True)
    mfu = train["mfu"]
    print(f"  measure_train: {train['train_step_ms']} ms a step (host clock, slope of "
          f"4 -> 12 chained steps), {train['train_tokens_per_sec']} tokens/s, MFU {mfu}",
          flush=True)
    if phase6 is not None:
        ms6, mfu6 = phase6
        print(f"  beside phase 6 (CUDA events, mean of 3): {ms6:.1f} ms, MFU {mfu6:.4f}; "
              f"the arm reads {100 * (train['train_step_ms'] / ms6 - 1):+.2f}%", flush=True)
    for seq, r in sorted(attn.items()):
        print(f"  flash vs dense fwd+bwd at B=1 H={scale.attn_heads} S={seq} hd=128: "
              f"flash {r['flash_ms']} ms, dense {r['xla_ms']} ms, speedup {r['speedup']} "
              f"(samples {r['speedup_samples']})", flush=True)
    print(f"  window at S={window['window_seq']}: full {window['flash_full_ms']} ms, "
          f"window {window['window_size']} {window['flash_window_ms']} ms, speedup "
          f"{window['flash_window_speedup']}", flush=True)
    print(f"  paged decode, {scale.batch} rows, chunk {scale.page_size}: "
          f"{paged['paged_decode_tokens_per_sec']} tokens/s "
          f"({paged['paged_decode_ms_per_token']} ms a token)", flush=True)
    if cuda:
        if not (mfu and 0.0 < mfu < 1.0):
            fail(f"measure_train's MFU on the card is {mfu}")
        if not all(launches[name] > 0 for name in FLASH_KERNELS):
            fail(f"the attention arms launched no flash kernel: {launches}")
        lo, hi = scale.serve_chunks
        want_k1 = scale.n_layers * scale.page_size * 4 * (lo + hi)
        if launches["paged_attention"] != want_k1:
            fail(f"K1 launched {launches['paged_attention']} times in measure_paged_decode, "
                 f"expected n_layers x chunk x {4 * (lo + hi)} chunks = {want_k1}")

    # The kernel table: the sweep's picks, through the artifact's keys.
    picks = ks.table_from_measurements({s: r["speedup"] for s, r in attn.items()})
    keys = {f"kernel_pick_seq{s}": impl for s, impl in picks.items()}
    if ks.table_from_artifact(keys) != picks:
        fail(f"table_from_artifact({keys}) is not the sweep's table {picks}")
    try:
        ks.set_kernel_table(picks)
        routed = {s: model_mod._pick_kernel(s) for s in picks}
    finally:
        ks.set_kernel_table(None)
    print(f"  kernel picks {keys}; model._pick_kernel under set_kernel_table: {routed}",
          flush=True)
    if routed != picks:
        fail(f"model._pick_kernel under the sweep's table {picks} routes {routed}")

    if cuda:
        seq = sorted(scale.attn_seqs)[len(scale.attn_seqs) // 2]
        q, k, v = pb._rand_qkv(seq, scale.attn_heads, device=device)
        # Each profiled chain traces at most its replays, and one of up
        # to TRACE_ATTEMPTS exactly them.
        for label, fn, want in (("flash", fa.flash_attention, chain_links),
                                ("dense", pb._dense_causal, 0)):
            run = pb._attention_chain(fn, q, k, v)
            run(1)
            expected = {name: want for name in FLASH_KERNELS}
            for attempt in range(1, TRACE_ATTEMPTS + 1):
                _, wall, busy, by_name = profiled(torch, lambda: run(chain_links),
                                                  f"attention_chain_{label}")
                traced = {name: sum(len(d) for kname, d in by_name.items() if name in kname)
                          for name in FLASH_KERNELS}
                print(f"  profiled {label} chain of {chain_links} graph replays at S={seq}, "
                      f"trace {attempt}: wall {wall:.3f} ms, device kernels {busy:.3f} ms, "
                      f"traced {traced}", flush=True)
                if busy == 0:
                    fail(f"profiled {label} chain: no kernel events in the trace")
                if any(traced[name] > want for name in FLASH_KERNELS):
                    fail(f"the {label} chain's {chain_links} replays traced {traced}, more "
                         f"than {want} of a flash kernel")
                if traced == expected:
                    break
            else:
                fail(f"none of {TRACE_ATTEMPTS} traces of the {label} chain's {chain_links} "
                     f"replays shows {want} of each flash kernel")
            del run
        # From JAX's bf16 q (every |value| at least 0.0055) a link's 1e-6
        # step stays under half a bf16 ulp, so the chains would be equal
        # doing nothing; from q scaled by 2^-10 (exact) the links move it.
        small = q * 2.0**-10
        graphed = pb._attention_chain(fa.flash_attention, small, k, v)(3).clone()
        eager = pb._attention_chain(fa.flash_attention, small, k, v, graph=False)(3)
        moved = int((graphed != small).sum())
        print(f"  graphed flash chain of 3 links from q x 2^-10 equals the eager chain bit for "
              f"bit: {torch.equal(graphed, eager)}; the links moved {moved} of "
              f"{small.numel()} values of q", flush=True)
        if not torch.equal(graphed, eager):
            fail("the graphed attention chain differs from the eager chain")
        if moved == 0:
            fail("the attention chain's links moved no value of q: equal chains prove nothing")
    return launches, train


# Phase 6g, the training layouts: phase 6's model (perfbench's ``full``)
# on two gloo ranks of the one card, three steps of each arm on one global
# batch of TRAIN_PAR["batch"] x TRAIN_PAR["max_seq_len"] tokens: (a) DP2
# on a (2, 1) mesh, (b) TP2 on (1, 2) with the model axis' enter/reduce
# hooks, (c) Ulysses over a 2-rank "seq" axis (the local attention K2-K4
# on 8 heads), (d) ring over the same axis (torch products, no kernel).
# NCCL refuses two ranks on one device, so gloo carries every collective
# through host memory: the times say nothing of parallel speed.  The
# control is (b) with the model axis' enter hook left out: its gradients
# upstream of every column-parallel product lack the other rank's part,
# and the later steps' loss gates must catch it.
TRAIN_PAR = dict(ranks=2, batch=4, max_seq_len=2049, steps=3, collective_iters=10,
                 timeout_s=600)
TRAIN_PAR_ARMS = {"(a) DP2": ("mesh", (2, 1)), "(b) TP2": ("mesh", (1, 2)),
                  "(c) Ulysses sp2": ("sp", "ulysses"), "(d) ring sp2": ("sp", "ring")}
TRAIN_PAR_CONTROL = {"(b0) TP2 without enter, control": ("no_enter", (1, 2))}
# AdamW's learning rate for phase 6g.  At 1e-4, three
# steps on this batch rose and fell back (bf16: 15.03, 15.91, 15.13; NVIDIA
# H100 80GB HBM3, 700 W); a smaller step falls from the first.
TRAIN_PAR_LR = 3e-5
# The first float32 step's loss on a rank against one device's, relative:
# only the collectives' and products' summation order differs.
TRAIN_PAR_F32_RTOL = 2.0**-16
# The later steps hold the gradient and the update: each step's drop from
# the first step's loss (loss_k - loss_1, k >= 2) against one device's
# drop, relative, in float32 and in bf16.  The first AdamW update is about
# lr x sign(g), which the summation order moves only where g is near 0.
# Read before these limits were set: at the CPU rehearsal's width the
# arms' drops within 5.0e-5 (float32) and 6.5e-4 (bf16) of one device's
# and the control's 1.7e-2 to 2.7e-2 off in both; at full width the bf16
# drops within 6.2e-4 (TP2, from losses printed to 5 decimals; NVIDIA H100
# 80GB HBM3, 700 W).
TRAIN_PAR_F32_DROP_RTOL = 2.0**-10
TRAIN_PAR_BF16_DROP_RTOL = 2.0**-8
# The bf16 per-token NLL's max and rms distance from one device's float32
# NLL, within this factor of one device's bf16 distance (the floor), as
# phase 4j's TP_BF16_FLOOR_FACTOR: a rank rounds its partial products once
# more than one device does.
TRAIN_PAR_FLOOR_FACTOR = 2.0**0.5


def train_par_config(torch, f, tp, dtype):
    from workloads_torch.model import ModelConfig

    return ModelConfig(d_model=f["d_model"], n_heads=f["n_heads"], n_layers=f["n_layers"],
                       d_ff=f["d_ff"], vocab_size=f["vocab_size"],
                       max_seq_len=tp["max_seq_len"], dtype=dtype, attention_impl="flash")


def token_nll(torch, params, tokens, config, attention_fn=None, reduce=None, enter=None):
    """Every position's next-token NLL [rows, seq-1] in float32, on the
    host: ``model.loss_fn`` before its mean."""
    from workloads_torch.model import forward

    with torch.no_grad():
        logits = forward(params, tokens[:, :-1], config, attention_fn, reduce, enter)
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, tokens[:, 1:].long()[..., None])[..., 0]
    return nll.float().cpu().numpy()


def train_par_one_device(torch, f, tp, device, lr):
    """One device's reference on the global batch: the per-token NLL at the
    initial weights in float32 and in bf16, and the losses of
    ``tp["steps"]`` steps in each."""
    from workloads_torch import train

    c32, c16 = (train_par_config(torch, f, tp, dt) for dt in (torch.float32, torch.bfloat16))
    tokens = train.synthetic_batch(c32, tp["batch"], seed=0, device=device)
    out = {}
    for label, config in (("f32", c32), ("bf16", c16)):
        (params, state), opt = train.make_train_state(config, seed=0, device=device,
                                                      optimizer=train.AdamW(lr=lr))
        out[f"nll_{label}"] = token_nll(torch, params, tokens, config)
        step = train.make_train_step(config, opt)
        losses = []
        for _ in range(tp["steps"]):
            params, state, loss = step(params, state, tokens)
            losses.append(loss.item())
        out[f"losses_{label}"] = losses
        del params, state, step
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def _timed_ms(torch, fn, iters, cuda) -> float:
    fn()
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    if cuda:
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def train_par_rank(rank, world, store, out_path, f, tp, lr, device_type):
    """One rank of phase 6g: join the gloo world, run each arm and the
    control (the bf16 per-token NLL through the arm's path at the initial
    weights, ``tp["steps"]`` float32 steps, as many bf16 steps with K2-K4
    counted), time one
    all-reduce, all_to_all and ppermute and the host copies gloo makes
    of their tensors, and write what it saw to ``out_path``.  An
    exception ends the process with a non-zero code."""
    import datetime
    import pickle

    import torch

    sys.path.insert(0, ROOT)
    from workloads_torch import distributed, train
    from workloads_torch.model import loss_fn
    from workloads_torch.ops import attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device_type == "cpu":
        torch.set_num_threads(1)  # the ranks share the host's cores
    t_rank = time.perf_counter()
    torch.distributed.init_process_group(
        "gloo", store=torch.distributed.FileStore(store, world), rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=tp["timeout_s"]))
    counters = {"flash_fwd": fa.flash_fwd, "flash_bwd_dq": fa.flash_bwd_dq,
                "flash_bwd_dkv": fa.flash_bwd_dkv}
    cuda = device_type == "cuda"
    arms = {}
    for name, (kind, arg) in {**TRAIN_PAR_ARMS, **TRAIN_PAR_CONTROL}.items():
        t0 = time.perf_counter()
        if kind != "sp":
            mesh = train.make_mesh(world, model_parallel=arg[1], device_type=device_type)
        else:
            mesh = train.make_sp_mesh(world, seq_parallel=world, device_type=device_type)
        device = distributed.mesh_device(mesh)
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        out = {}
        for label, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            config = train_par_config(torch, f, tp, dtype)
            tokens = train.synthetic_batch(config, tp["batch"], seed=0, device=device)
            optimizer = train.AdamW(lr=lr)
            (params, state), _ = train.make_train_state(config, seed=0, mesh=mesh,
                                                        optimizer=optimizer)
            enter, reduce = distributed.model_hooks(mesh)
            attention_fn = None
            if kind == "sp":
                attention_fn = train.seq_parallel_attention(config, mesh, arg)
                step = train.make_seq_parallel_train_step(config, mesh, optimizer, arg)
            elif kind == "no_enter":
                def no_enter(p, t, config=config, reduce=reduce):
                    return loss_fn(p, t, config, None, reduce, None)

                step = train.make_sharded_train_step(no_enter, mesh, optimizer)
            else:
                step = train.make_train_step(config, optimizer, mesh=mesh)
            n = tokens.shape[0] // dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))["data"]
            lo = mesh.get_coordinate()[mesh.mesh_dim_names.index("data")] * n
            out["rows"] = (lo, lo + n)
            rows = tokens[lo:lo + n]
            if label == "bf16":
                out["nll_bf16"] = token_nll(torch, params, rows, config, attention_fn,
                                            reduce, enter)
            reset_counts(counters)
            losses = []
            for _ in range(tp["steps"]):
                params, state, loss = step(params, state, tokens)
                losses.append(loss.item())
            if cuda:
                torch.cuda.synchronize(device)
            out[f"losses_{label}"] = losses
            if label == "bf16":
                out["launches"] = read_counts(counters)
            del params, state, step
            if cuda:
                torch.cuda.empty_cache()
        out["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30 if cuda else None
        out["seconds"] = time.perf_counter() - t0
        arms[name] = out
    # One collective of each kind at the arms' shapes, and the host round
    # trip (to the host and back) of its tensor, which gloo makes.
    mesh = train.make_sp_mesh(world, seq_parallel=world, device_type=device_type)
    device = distributed.mesh_device(mesh)
    seq = mesh.get_group("seq")
    B, S, H, hd, d = tp["batch"], tp["max_seq_len"] - 1, f["n_heads"], \
        f["d_model"] // f["n_heads"], f["d_model"]
    act = torch.ones((B, S, d), dtype=torch.bfloat16, device=device)
    span = torch.ones((B, S // world, H, hd), dtype=torch.bfloat16, device=device)
    iters = tp["collective_iters"]
    coll = {
        "all_reduce_ms": _timed_ms(torch, lambda: torch.distributed.all_reduce(act, group=seq),
                                iters, cuda),
        "all_to_all": _timed_ms(torch, lambda: distributed.all_to_all(span, seq, 2, 1),
                                iters, cuda),
        "ppermute": _timed_ms(torch, lambda: distributed.ppermute(span, seq), iters, cuda),
        "host_round_trip_act": _timed_ms(torch, lambda: act.cpu().to(device), iters, cuda),
        "host_round_trip_span": _timed_ms(torch, lambda: span.cpu().to(device), iters, cuda),
        "act_mib": act.numel() * act.element_size() / 2**20,
        "span_mib": span.numel() * span.element_size() / 2**20,
    }
    result = {"arms": arms, "collectives": coll, "seconds": time.perf_counter() - t_rank,
              "backend": torch.distributed.get_backend(seq)}
    torch.distributed.destroy_process_group()
    with open(out_path, "wb") as fh:
        pickle.dump(result, fh)


def _drops(losses: list) -> list:
    return [x - losses[0] for x in losses[1:]]


def train_par_loss_gates(name: str, r: int, arm: dict, one: dict) -> dict:
    """One rank's arm against one device's losses on the same batch, by
    gate: ``"f32 first"`` (the first float32 step's loss, a forward at
    the initial weights), ``"f32 drops"`` and ``"bf16 drops"`` (each later
    step's drop from the first step's loss, which holds the gradient and
    the update).  Returns the failed gates' messages."""
    failed = {}
    got, want = arm["losses_f32"][0], one["losses_f32"][0]
    if not abs(got - want) <= TRAIN_PAR_F32_RTOL * abs(want):
        failed["f32 first"] = (f"{name} rank {r}: float32 first-step loss {got!r} against "
                               f"one device's {want!r}")
    for label, rtol in (("f32", TRAIN_PAR_F32_DROP_RTOL), ("bf16", TRAIN_PAR_BF16_DROP_RTOL)):
        got, want = (_drops(a[f"losses_{label}"]) for a in (arm, one))
        rel = [abs(g - w) / abs(w) for g, w in zip(got, want)]
        if len(got) != len(want) or not all(x <= rtol for x in rel):
            failed[f"{label} drops"] = (
                f"{name} rank {r}: {label} losses {arm[f'losses_{label}']!r}, drops from the "
                f"first step {', '.join(f'{x:.2e}' for x in rel)} off one device's "
                f"{one[f'losses_{label}']!r} (limit {rtol:.2e})")
    return failed


def train_par_gates(one: dict, ranks: list, n_layers: int, steps: int,
                    card: bool = True) -> list[str]:
    """Phase 6g's gates over one device's reference (``one``) and each
    rank's arms; each failure names its arm and rank.  ``card``: K2-K4
    must have launched n_layers a bf16 step in (a)-(c) (off the card the
    plain versions run and count nothing).  The control must fail both
    drop gates (``train_par_loss_gates``): it shows that they see a
    wrong gradient."""
    import numpy as np

    failed = []
    for r, got in enumerate(ranks):
        for name in TRAIN_PAR_CONTROL:
            if name not in got["arms"]:
                failed.append(f"{name} rank {r}: the control did not run")
                continue
            caught = train_par_loss_gates(name, r, got["arms"][name], one)
            if not {"f32 drops", "bf16 drops"} <= set(caught):
                failed.append(f"{name} rank {r}: the control passed a drop gate (caught: "
                              f"{list(caught.values())})")
        for name, arm in got["arms"].items():
            if name in TRAIN_PAR_CONTROL:
                continue
            failed += train_par_loss_gates(name, r, arm, one).values()
            lo, hi = arm["rows"]
            floor = _max_rms(one["nll_bf16"][lo:hi] - one["nll_f32"][lo:hi])
            err = _max_rms(arm["nll_bf16"] - one["nll_f32"][lo:hi])
            if not all(e <= TRAIN_PAR_FLOOR_FACTOR * fl for e, fl in zip(err, floor)):
                failed.append(f"{name} rank {r}: bf16 per-token NLL max {err[0]:.4e} rms "
                              f"{err[1]:.4e} from one device's float32 (limits: sqrt 2 x the "
                              f"floor, max {floor[0]:.4e} rms {floor[1]:.4e})")
            if not np.all(np.isfinite(arm["losses_bf16"])) or \
                    not arm["losses_bf16"][-1] < arm["losses_bf16"][0]:
                failed.append(f"{name} rank {r}: bf16 losses {arm['losses_bf16']} did not fall")
            want = n_layers * steps if card and "ring" not in name else 0
            if any(v != want for v in arm["launches"].values()):
                failed.append(f"{name} rank {r}: K2-K4 launches {arm['launches']}, expected "
                              f"{want} each")
    return failed


def spawn_world(target, tp, args, label: str) -> list:
    """Run ``target(rank, world, store, out_path, *args)`` on
    ``tp["ranks"]`` spawned processes; each must exit 0 within
    ``tp["timeout_s"]`` (a rank that fails, or a world past its time,
    fails phase ``label`` and is killed).  Returns each rank's pickled
    result, in rank order."""
    import pickle
    import shutil
    import tempfile

    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix=f"chip_smoke_{label}_")
    ctx = mp.get_context("spawn")
    outs = [os.path.join(tmp, f"rank{r}.pkl") for r in range(tp["ranks"])]
    procs = [ctx.Process(target=target,
                         args=(r, tp["ranks"], os.path.join(tmp, "store"), outs[r], *args))
             for r in range(tp["ranks"])]
    t_world = time.perf_counter()
    for p in procs:
        p.start()
    try:
        while any(p.is_alive() for p in procs):
            dead = [(r, p.exitcode) for r, p in enumerate(procs)
                    if p.exitcode not in (None, 0)]
            if dead:
                fail(f"phase {label}: rank {dead[0][0]} exited with code {dead[0][1]}")
            if time.perf_counter() - t_world > tp["timeout_s"]:
                fail(f"phase {label}: the world did not finish in {tp['timeout_s']} s")
            time.sleep(0.2)
        codes = [p.exitcode for p in procs]
        if any(codes):
            fail(f"phase {label}: rank exit codes {codes}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(10)
    ranks = []
    for path in outs:
        with open(path, "rb") as fh:
            ranks.append(pickle.load(fh))
    shutil.rmtree(tmp, ignore_errors=True)
    return ranks


def train_parallel_phase(torch, f, tp=TRAIN_PAR, lr=TRAIN_PAR_LR, device="cuda") -> dict:
    """Phase 6g: the training layouts on ``tp["ranks"]`` gloo ranks of the
    one ``device``.  One device's reference first, in this process; then
    the world, spawned, whose ranks must each exit 0 within the time
    limit.  Returns K2-K4's launches summed over every rank's arms."""
    t0 = time.perf_counter()
    dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    one = train_par_one_device(torch, f, tp, dev, lr)
    floor = _max_rms(one["nll_bf16"] - one["nll_f32"])
    print(f"  one device, batch {tp['batch']} x {tp['max_seq_len']} tokens: float32 losses "
          f"{[round(x, 7) for x in one['losses_f32']]}, bf16 losses "
          f"{[round(x, 5) for x in one['losses_bf16']]}; "
          f"per-token NLL bf16 floor (bf16 vs float32) max {floor[0]:.4e} rms {floor[1]:.4e}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if device == "cuda":
        torch.cuda.empty_cache()
    t_world = time.perf_counter()
    ranks = spawn_world(train_par_rank, tp, (f, tp, lr, device), "6g")
    world_s = time.perf_counter() - t_world
    lim = TRAIN_PAR_FLOOR_FACTOR
    for r, got in enumerate(ranks):
        for name, arm in got["arms"].items():
            lo, hi = arm["rows"]
            err = _max_rms(arm["nll_bf16"] - one["nll_f32"][lo:hi])
            fl = _max_rms(one["nll_bf16"][lo:hi] - one["nll_f32"][lo:hi])
            mem = f"{arm['peak_gib']:.2f} GiB" if arm["peak_gib"] is not None else \
                "not measured (no card)"
            rel = {label: ", ".join(f"{abs(g - w) / abs(w):.2e}" for g, w in
                                    zip(*(_drops(a[f"losses_{label}"]) for a in (arm, one))))
                   for label in ("f32", "bf16")}
            first = abs(arm["losses_f32"][0] - one["losses_f32"][0]) / one["losses_f32"][0]
            print(f"  rank {r} {name}: rows {lo}-{hi}, float32 losses "
                  f"{[round(x, 7) for x in arm['losses_f32']]} (first {first:.2e} off one "
                  f"device's, limit {TRAIN_PAR_F32_RTOL:.2e}; drops {rel['f32']} off, limit "
                  f"{TRAIN_PAR_F32_DROP_RTOL:.2e}); bf16 losses "
                  f"{[round(x, 5) for x in arm['losses_bf16']]} (drops {rel['bf16']} off, "
                  f"limit {TRAIN_PAR_BF16_DROP_RTOL:.2e}); bf16 per-token NLL vs one "
                  f"device's float32 max {err[0]:.4e} rms {err[1]:.4e} (limits {lim:.4f} x the "
                  f"floor: {lim * fl[0]:.4e}, {lim * fl[1]:.4e}); launches over "
                  f"{tp['steps']} bf16 steps {arm['launches']}; peak device memory {mem}; "
                  f"{arm['seconds']:.1f} s", flush=True)
        c = got["collectives"]
        print(f"  rank {r} ({got['backend']}): one all-reduce of [{tp['batch']}, "
              f"{tp['max_seq_len'] - 1}, {f['d_model']}] bf16 ({c['act_mib']:.0f} MiB) "
              f"{c['all_reduce_ms']:.3f} ms beside its host round trip "
              f"{c['host_round_trip_act']:.3f} ms; one all_to_all of a [{tp['batch']}, "
              f"{(tp['max_seq_len'] - 1) // tp['ranks']}, {f['n_heads']}, "
              f"{f['d_model'] // f['n_heads']}] bf16 span ({c['span_mib']:.0f} MiB) "
              f"{c['all_to_all']:.3f} ms and one ppermute {c['ppermute']:.3f} ms, beside its "
              f"host round trip {c['host_round_trip_span']:.3f} ms (gloo stages both through "
              f"it); mean of {tp['collective_iters']}; {got['seconds']:.1f} s in the rank",
              flush=True)
    failed = train_par_gates(one, ranks, f["n_layers"], tp["steps"], card=device == "cuda")
    if failed:
        fail(f"phase 6g: {failed}")
    launches = {k: sum(got["arms"][name]["launches"][k] for got in ranks
                       for name in TRAIN_PAR_ARMS)
                for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    print(f"  {tp['ranks']} ranks over gloo on one {device} device: every arm's first "
          f"float32 loss within {TRAIN_PAR_F32_RTOL:.2e} of one device's, its float32 and "
          f"bf16 drops within {TRAIN_PAR_F32_DROP_RTOL:.2e} and {TRAIN_PAR_BF16_DROP_RTOL:.2e}"
          f", the control outside both; every arm's bf16 "
          f"per-token NLL within sqrt 2 of the floor, its bf16 loss falling; K2-K4 over "
          f"every rank's arms {launches}; world {world_s:.1f} s, phase "
          f"{time.perf_counter() - t0:.1f} s (gloo stages every collective through host "
          f"memory: these times say nothing of parallel speed)", flush=True)
    return launches


# Phase 6h, the pipeline and expert layouts: phase 6's model (at
# WORLD_PHASE_LAYERS of its layers) on two gloo ranks of the one card, as
# 6g, three float32 and three bf16 steps of each arm on one global batch
# of PP_EP["batch"] x PP_EP["max_seq_len"] tokens at TRAIN_PAR_LR: (e)
# PP2, the GPipe schedule over a ("data", "pipe") mesh, n_layers / 2 a
# stage, M = 4 microbatches of one row (K2-K4 on each
# stage's layers at every one of the M + S - 1 schedule steps); (f) EP2,
# the MoE model (MoEConfig(): 4 experts, capacity factor 2.0, so C =
# 1,024 at 2,048 positions) over a ("data", "expert", "model") mesh, 2
# experts a rank, attention whole on each rank (K2-K4 n_layers a step).
# The references run on one device in this process: the sequential
# model on the unstacked weights for (e), moe_loss_fn on the whole tree
# for (f).  Each control must fail a drop gate: (e0) PP2 with the
# hand-off's backward cut (activations handed on detached: the first
# stage gets no gradient), (f0) EP2 without the expert axis' f (each
# rank's dispatch-input and gate gradients hold its own experts' part).
PP_EP = dict(ranks=2, batch=4, max_seq_len=2049, steps=3, microbatches=4, handoff_iters=10,
             timeout_s=600)
PP_EP_ARMS = {"(e) PP2": "pp", "(f) EP2": "ep"}
PP_EP_CONTROLS = {"(e0) PP2 with the hand-off's backward cut, control": "pp",
                  "(f0) EP2 without f on the dispatch input, control": "ep"}


def pp_ep_init(torch, config, arm: str, device):
    """The arm's full tree from ``PRNGKey(0)`` on ``device``: the model's
    (``pp``, the pipeline's stages stack these draws) or the MoE model's
    (``ep``)."""
    from workloads_torch.model import init_params
    from workloads_torch.moe import MoEConfig, init_moe_model_params

    key = prng_key(0, device)
    if arm == "pp":
        return init_params(config, key)
    return init_moe_model_params(config, MoEConfig(), key)


def pp_ep_one_device(torch, f, tp, device, lr) -> dict:
    """One device's losses on the global batch, ``tp["steps"]`` float32 and
    as many bf16 steps: the sequential model (``pp``) and the whole MoE
    tree (``ep``)."""
    from workloads_torch import train
    from workloads_torch.moe import MoEConfig, make_moe_train_step

    out = {}
    for arm in ("pp", "ep"):
        ref = {}
        for label, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            config = train_par_config(torch, f, tp, dtype)
            tokens = train.synthetic_batch(config, tp["batch"], seed=0, device=device)
            optimizer = train.AdamW(lr=lr)
            params = pp_ep_init(torch, config, arm, device)
            state = optimizer.init(params)
            step = train.make_train_step(config, optimizer) if arm == "pp" else \
                make_moe_train_step(config, MoEConfig(), None, optimizer)
            losses = []
            for _ in range(tp["steps"]):
                params, state, loss = step(params, state, tokens)
                losses.append(loss.item())
            ref[f"losses_{label}"] = losses
            del params, state, step
            if device.type == "cuda":
                torch.cuda.empty_cache()
        out[arm] = ref
    return out


def _replicated_digests(torch, params, arm: str) -> dict:
    """sha256 of every leaf a rank holds whole (embed, unembed, and for the
    MoE model every layer's router, norms and attention)."""
    import hashlib

    named = {"embed": params["embed"], "unembed": params["unembed"]}
    if arm == "ep":
        for i, layer in enumerate(params["layers"]):
            named.update({f"layers/{i}/{k}": v for k, v in layer.items() if k != "moe"})
            named[f"layers/{i}/router"] = layer["moe"]["router"]
    return {name: hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()
            for name, t in named.items()}


def pp_ep_rank(rank, world, store, out_path, f, tp, lr, device_type):
    """One rank of phase 6h: join the gloo world, run each arm and control
    (``tp["steps"]`` float32 steps, then as many bf16 steps with K2-K4
    counted), digest the replicated leaves after each, time one hand-off
    of a microbatch's activations and one all-reduce of the combine's
    output, and write what it saw to ``out_path``.  An exception ends the
    process with a non-zero code."""
    import datetime
    import pickle
    from dataclasses import replace

    import torch

    sys.path.insert(0, ROOT)
    from workloads_torch import distributed, moe, pipeline, train
    from workloads_torch.ops import attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device_type == "cpu":
        torch.set_num_threads(1)  # the ranks share the host's cores
    t_rank = time.perf_counter()
    torch.distributed.init_process_group(
        "gloo", store=torch.distributed.FileStore(store, world), rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=tp["timeout_s"]))
    counters = {"flash_fwd": fa.flash_fwd, "flash_bwd_dq": fa.flash_bwd_dq,
                "flash_bwd_dkv": fa.flash_bwd_dkv}
    cuda = device_type == "cuda"
    m = tp["microbatches"]
    meshes = {"pp": pipeline.make_pp_mesh(world, pipe_parallel=world, device_type=device_type),
              "ep": moe.make_moe_mesh(world, expert_parallel=world, device_type=device_type)}
    moe_config = moe.MoEConfig()
    arms = {}
    for name, arm in {**PP_EP_ARMS, **PP_EP_CONTROLS}.items():
        control = name in PP_EP_CONTROLS
        mesh = meshes[arm]
        device = distributed.mesh_device(mesh)
        t0 = time.perf_counter()
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        out = {}
        for label, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            config = train_par_config(torch, f, tp, dtype)
            tokens = train.synthetic_batch(config, tp["batch"], seed=0, device=device)
            optimizer = train.AdamW(lr=lr)
            if arm == "pp":
                (params, state), _ = pipeline.make_pipeline_train_state(
                    config, mesh, seed=0, optimizer=optimizer)
                if control:
                    def detached(x, group):
                        return distributed.handoff(x.detach(), group)

                    def cut(p, t, config=config, mesh=mesh):
                        return pipeline.pipeline_loss_fn(p, t, config, mesh, m, detached)

                    step = train.make_sharded_train_step(cut, mesh, optimizer)
                else:
                    step = pipeline.make_pipeline_train_step(config, mesh, optimizer, m)
            else:
                (params, state), _ = moe.make_moe_train_state(
                    config, moe_config, mesh, seed=0, optimizer=optimizer)
                if control:
                    hooks = replace(moe.expert_hooks(mesh), enter=None)

                    def no_enter(p, t, config=config, mesh=mesh, hooks=hooks):
                        return moe.moe_loss_fn(p, t, config, moe_config, mesh, hooks)

                    step = train.make_sharded_train_step(no_enter, mesh, optimizer)
                else:
                    step = moe.make_moe_train_step(config, moe_config, mesh, optimizer)
            reset_counts(counters)
            losses = []
            for _ in range(tp["steps"]):
                params, state, loss = step(params, state, tokens)
                losses.append(loss.item())
            if cuda:
                torch.cuda.synchronize(device)
            out[f"losses_{label}"] = losses
            out[f"digests_{label}"] = _replicated_digests(torch, params, arm)
            if label == "bf16":
                out["launches"] = read_counts(counters)
            del params, state, step
            if cuda:
                torch.cuda.empty_cache()
        out["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30 if cuda else None
        out["seconds"] = time.perf_counter() - t0
        arms[name] = out
    # One hand-off of a microbatch's bf16 activations down the pipe, and
    # one all-reduce of the combine's bf16 output over the expert group.
    S, d = tp["max_seq_len"] - 1, f["d_model"]
    device = distributed.mesh_device(meshes["pp"])
    mb = torch.ones((tp["batch"] // m, S, d), dtype=torch.bfloat16, device=device)
    y = torch.ones((tp["batch"], S, d), dtype=torch.bfloat16, device=device)
    _, reduce = distributed.axis_hooks(meshes["ep"], "expert")
    pipe = meshes["pp"].get_group("pipe")
    iters = tp["handoff_iters"]
    coll = {"handoff_ms": _timed_ms(torch, lambda: distributed.handoff(mb, pipe), iters, cuda),
            "combine_ms": _timed_ms(torch, lambda: reduce(y), iters, cuda),
            "handoff_mib": mb.numel() * mb.element_size() / 2**20,
            "combine_mib": y.numel() * y.element_size() / 2**20}
    result = {"arms": arms, "collectives": coll, "seconds": time.perf_counter() - t_rank,
              "backend": torch.distributed.get_backend(pipe)}
    torch.distributed.destroy_process_group()
    with open(out_path, "wb") as fh:
        pickle.dump(result, fh)


def pp_ep_launches(arm: str, f, tp) -> int:
    """K2 (and K3, K4) a rank launches over ``tp["steps"]`` steps: the
    pipeline's stage runs its L/S layers at every one of the M + S - 1
    schedule steps, forward and backward; an expert rank all L layers'
    attention."""
    if arm == "pp":
        stages = tp["ranks"]
        return (tp["microbatches"] + stages - 1) * (f["n_layers"] // stages) * tp["steps"]
    return f["n_layers"] * tp["steps"]


def pp_ep_gates(one: dict, ranks: list, f, tp, card: bool = True) -> list[str]:
    """Phase 6h's gates over one device's references (``one[arm]``) and
    each rank's arms; each failure names its arm and rank.  Every arm:
    6g's first float32 loss and drop gates (``train_par_loss_gates``),
    the bf16 loss falling, the replicated leaves bit-identical across the
    ranks after the float32 and the bf16 steps, and (``card``) K2-K4
    launched ``pp_ep_launches`` times (off the card the plain versions
    run and count nothing).  Each control must fail a drop gate."""
    import numpy as np

    failed = []
    for r, got in enumerate(ranks):
        for name, arm in PP_EP_CONTROLS.items():
            if name not in got["arms"]:
                failed.append(f"{name} rank {r}: the control did not run")
                continue
            caught = train_par_loss_gates(name, r, got["arms"][name], one[arm])
            if not {"f32 drops", "bf16 drops"} & set(caught):
                failed.append(f"{name} rank {r}: the control passed both drop gates")
        for name, arm in PP_EP_ARMS.items():
            got_arm = got["arms"][name]
            failed += train_par_loss_gates(name, r, got_arm, one[arm]).values()
            losses = got_arm["losses_bf16"]
            if not np.all(np.isfinite(losses)) or not losses[-1] < losses[0]:
                failed.append(f"{name} rank {r}: bf16 losses {losses} did not fall")
            for label in ("f32", "bf16"):
                differ = [k for k, v in got_arm[f"digests_{label}"].items()
                          if v != ranks[0]["arms"][name][f"digests_{label}"][k]]
                if differ:
                    failed.append(f"{name} rank {r}: replicated leaves {differ} differ from "
                                  f"rank 0's after the {label} steps")
            want = pp_ep_launches(arm, f, tp) if card else 0
            if any(v != want for v in got_arm["launches"].values()):
                failed.append(f"{name} rank {r}: K2-K4 launches {got_arm['launches']}, "
                              f"expected {want} each")
    return failed


def pp_ep_phase(torch, f, tp=PP_EP, lr=TRAIN_PAR_LR, device="cuda") -> dict:
    """Phase 6h: the pipeline and expert layouts on ``tp["ranks"]`` gloo
    ranks of the one ``device``.  One device's references first, in this
    process; then the world, spawned.  Returns K2-K4's launches summed
    over every rank's arms."""
    t0 = time.perf_counter()
    dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    one = pp_ep_one_device(torch, f, tp, dev, lr)
    print(f"  one device, batch {tp['batch']} x {tp['max_seq_len']} tokens: sequential model "
          f"float32 losses {[round(x, 7) for x in one['pp']['losses_f32']]}, bf16 "
          f"{[round(x, 5) for x in one['pp']['losses_bf16']]}; MoE model float32 "
          f"{[round(x, 7) for x in one['ep']['losses_f32']]}, bf16 "
          f"{[round(x, 5) for x in one['ep']['losses_bf16']]}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if device == "cuda":
        torch.cuda.empty_cache()
    t_world = time.perf_counter()
    ranks = spawn_world(pp_ep_rank, tp, (f, tp, lr, device), "6h")
    world_s = time.perf_counter() - t_world
    for r, got in enumerate(ranks):
        for name, arm_name in {**PP_EP_ARMS, **PP_EP_CONTROLS}.items():
            arm, ref = got["arms"][name], one[arm_name]
            mem = f"{arm['peak_gib']:.2f} GiB" if arm["peak_gib"] is not None else \
                "not measured (no card)"
            rel = {label: ", ".join(f"{abs(g - w) / abs(w):.2e}" for g, w in
                                    zip(*(_drops(a[f"losses_{label}"]) for a in (arm, ref))))
                   for label in ("f32", "bf16")}
            first = abs(arm["losses_f32"][0] - ref["losses_f32"][0]) / ref["losses_f32"][0]
            print(f"  rank {r} {name}: float32 losses "
                  f"{[round(x, 7) for x in arm['losses_f32']]} (first {first:.2e} off one "
                  f"device's, limit {TRAIN_PAR_F32_RTOL:.2e}; drops {rel['f32']} off, limit "
                  f"{TRAIN_PAR_F32_DROP_RTOL:.2e}); bf16 losses "
                  f"{[round(x, 5) for x in arm['losses_bf16']]} (drops {rel['bf16']} off, "
                  f"limit {TRAIN_PAR_BF16_DROP_RTOL:.2e}); launches over {tp['steps']} bf16 "
                  f"steps {arm['launches']}; peak device memory {mem}; "
                  f"{arm['seconds']:.1f} s", flush=True)
        c = got["collectives"]
        mb = tp["batch"] // tp["microbatches"]
        print(f"  rank {r} ({got['backend']}): one hand-off of a [{mb}, "
              f"{tp['max_seq_len'] - 1}, {f['d_model']}] bf16 microbatch "
              f"({c['handoff_mib']:.0f} MiB) {c['handoff_ms']:.3f} ms; one all-reduce of the "
              f"combine's [{tp['batch']}, {tp['max_seq_len'] - 1}, {f['d_model']}] bf16 output "
              f"({c['combine_mib']:.0f} MiB) {c['combine_ms']:.3f} ms; mean of "
              f"{tp['handoff_iters']}; {got['seconds']:.1f} s in the rank", flush=True)
    failed = pp_ep_gates(one, ranks, f, tp, card=device == "cuda")
    if failed:
        fail(f"phase 6h: {failed}")
    launches = {k: sum(got["arms"][name]["launches"][k] for got in ranks
                       for name in PP_EP_ARMS)
                for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    print(f"  {tp['ranks']} ranks over gloo on one {device} device: each arm's first float32 "
          f"loss within {TRAIN_PAR_F32_RTOL:.2e} of one device's, its float32 and bf16 drops "
          f"within {TRAIN_PAR_F32_DROP_RTOL:.2e} and {TRAIN_PAR_BF16_DROP_RTOL:.2e}, its bf16 "
          f"loss falling, its replicated leaves bit-identical across the ranks; each control "
          f"outside a drop gate; K2-K4 over every rank's arms {launches}; world "
          f"{world_s:.1f} s, phase {time.perf_counter() - t0:.1f} s (gloo stages every "
          f"collective through host memory: these times say nothing of parallel speed)",
          flush=True)
    return launches


# Phase 7, the sharing path: pods (``workloads_torch.busy_probe``
# subprocesses) time-slicing the one card under the cooperative chip
# lease, the JAX bench's single-chip layouts (bench.py:242, :302, :342):
# one chip, one chip a tray, 6 s windows; (a) occupancy matmuls at 1024,
# (b) BASELINE config #3, four train pods at replicas 4, (c) two serving
# pods at replicas 2.  The pass condition is the JAX harness's own,
# ``oversubscribe.BASELINE_BUSY_FRACTION``.
# Phase 6i, the vision CNN: its CLI at its defaults (50 steps, batch 64,
# AdamW 1e-3), then JAX's tests/test_vision.py procedure (30 steps on one
# batch of 64 from seed 0, the loss below 0.7 of the first); the card's
# seeded tree within 4 ulp of the CPU's, its images for seed 1 the CPU's
# bit for bit and its labels the CPU's.
VISION = dict(steps=50, batch=64, image_seed=1, tree_ulps=4, fixed_steps=30, fixed_drop=0.7)


def vision_phase(torch, card: str, vs=VISION, device="cuda") -> int:
    """Phase 6i: ``vision.main`` on ``device`` with its step wrapped to
    record each loss and the time it ended.  Returns the threefry
    kernel's launches in the CLI's run (weights and batches draw through
    it on the card)."""
    import numpy as np

    from workloads_torch import prng, train, vision
    from workloads_torch.ops import threefry as tf

    cuda = device == "cuda"
    t_phase = time.perf_counter()
    config = vision.VisionConfig()
    # (a) the seeded tree and a batch, the card's against the CPU's.
    tree = vision.init_params(config, prng.PRNGKey(0, device=device))
    cpu_tree = vision.init_params(config, prng.PRNGKey(0, device="cpu"))
    worst = 0.0
    for name in sorted(tree):
        want = cpu_tree[name].numpy()
        got = tree[name].cpu().numpy()
        ulps = (np.abs(got.astype(np.float64) - want.astype(np.float64))
                / np.spacing(np.abs(want)))  # float32 ulps of the CPU's value
        worst = max(worst, float(ulps.max()))
    images, labels = vision.synthetic_batch(config, vs["batch"], seed=vs["image_seed"],
                                            device=device)
    cpu_images, cpu_labels = vision.synthetic_batch(config, vs["batch"],
                                                    seed=vs["image_seed"], device="cpu")
    same_images = torch.equal(images.cpu().view(torch.int32), cpu_images.view(torch.int32))
    same_labels = torch.equal(labels.cpu(), cpu_labels)
    print(f"  PRNGKey(0) tree on {device}: max {worst:.0f} ulp from the CPU's (limit "
          f"{vs['tree_ulps']}); images for seed {vs['image_seed']} [{vs['batch']}, 28, 28, 1] "
          f"{'bit-identical' if same_images else 'DIFFER'}, labels "
          f"{'equal' if same_labels else 'DIFFER'}", flush=True)
    if not worst <= vs["tree_ulps"]:
        fail(f"6i: the card's vision tree is {worst} ulp from the CPU's")
    if not (same_images and same_labels):
        fail("6i: the card's vision batch differs from the CPU's")
    del tree, cpu_tree

    # (b) the CLI at its defaults.
    losses, ends = [], []
    build = vision.make_train_step

    def recording(*args, **kwargs):
        step = build(*args, **kwargs)

        def run(*inputs):
            out = step(*inputs)
            losses.append(float(out[2]))
            ends.append(time.perf_counter())
            return out

        return run

    held = 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()  # what earlier phases still hold
    before = tf.threefry.launches
    vision.make_train_step = recording
    try:
        t0 = time.perf_counter()
        rc = vision.main(["--steps", str(vs["steps"]), "--batch-size", str(vs["batch"]),
                          "--device", device])
        wall = time.perf_counter() - t0
    finally:
        vision.make_train_step = build
    launches = tf.threefry.launches - before
    mem = (f"{(torch.cuda.max_memory_allocated() - held) / 2**30:.3f} GiB above the "
           f"{held / 2**30:.3f} GiB held before it" if cuda else "not measured (no card)")
    rate = (len(ends) - 1) / (ends[-1] - ends[0]) if len(ends) > 1 else float("nan")
    print(f"  vision.main --steps {vs['steps']} --batch-size {vs['batch']}: loss "
          f"{losses[0]:.5f} -> {losses[-1]:.5f} ({losses[-1] / losses[0]:.3f} of the first), "
          f"{rate:.1f} steps/s after the first step (host clock, each step read back), "
          f"{wall:.2f} s in all, peak device memory {mem}, threefry launches {launches}; "
          f"card: {card}", flush=True)
    if rc != 0 or len(losses) != vs["steps"] or not all(math.isfinite(x) for x in losses):
        fail(f"6i: vision.main returned {rc} with losses {losses}")
    if not losses[-1] < losses[0]:
        fail(f"6i: the vision CLI's loss did not fall: {losses[0]} -> {losses[-1]}")
    if cuda and launches == 0:
        fail("6i: the vision CLI drew nothing through the threefry kernel on the card")

    # (c) JAX's test procedure: one batch, 30 steps.
    (params, opt), optimizer = train.make_sharded_train_state(
        None, lambda: vision.init_params(config, prng.PRNGKey(0, device=device)),
        vision.param_specs(), optimizer=train.AdamW(lr=1e-3, mu_dtype=torch.float32))
    step = vision.make_train_step(config, None, optimizer)
    images, labels = vision.synthetic_batch(config, vs["batch"], seed=0, device=device)
    fixed = []
    for _ in range(vs["fixed_steps"]):
        params, opt, loss = step(params, opt, images, labels)
        fixed.append(float(loss))
    print(f"  {vs['fixed_steps']} steps on one batch of {vs['batch']} (JAX's "
          f"test_training_reduces_loss): {fixed[0]:.5f} -> {fixed[-1]:.5f} "
          f"({fixed[-1] / fixed[0]:.3f} of the first, limit {vs['fixed_drop']}); phase "
          f"{time.perf_counter() - t_phase:.1f} s; card: {card}", flush=True)
    if not fixed[-1] < vs["fixed_drop"] * fixed[0]:
        fail(f"6i: 30 steps on one batch took the loss from {fixed[0]} to {fixed[-1]}")
    return launches


BUSY = dict(n_chips=1, chips_per_tray=1, duration=6.0, in_process_burst_secs=0.25, arms={
    "(a) matmul": dict(workload="matmul", replicas=4, pods=4, matrix_dim=1024),
    "(b) train": dict(workload="train", replicas=4, pods=4, matrix_dim=1024),
    "(c) serve": dict(workload="serve", replicas=2, pods=2, matrix_dim=1024),
})


def held_pod_envs(n_pods: int, lease_dir: str) -> list[dict]:
    """The Allocate environments the daemon gives ``n_pods`` pods
    time-sliced on one chip (``tpu-0``) with its leases under
    ``lease_dir``; tests/test_torch_oversubscribe.py holds them equal to
    what ``oversubscribe._start_stack`` and ``_admit_pods`` return."""
    return [{"TPU_ALLOW_MULTIPLE_LIBTPU_LOAD": "1", "TPU_CHIPS_PER_PROCESS_BOUNDS": "1,1,1",
             "TPU_DEVICE_PLUGIN_SHARED": "1", "TPU_PROCESS_BOUNDS": "1,1,1",
             "TPU_SHARED_LEASE_DIR": lease_dir, "TPU_VISIBLE_CHIPS": "tpu-0",
             "TPU_VISIBLE_DEVICES": "0"} for _ in range(n_pods)]


def busy_gates(name: str, arm: dict, agg: dict, n_chips: int, threshold: float,
               card: bool) -> list[str]:
    """Phase 7's gates on one arm's aggregate (every pod's exit 0 is
    ``run_pods``'s own: it raises otherwise); on the card each serving
    pod must have launched K1."""
    failed = []
    if agg.get("pods") != arm["pods"] or agg.get("chips") != n_chips:
        failed.append(f"{name}: {agg.get('pods')} pods on {agg.get('chips')} chips, asked "
                      f"{arm['pods']} on {n_chips}")
    if not agg.get("aggregate_busy_fraction", 0.0) >= threshold:
        failed.append(f"{name}: aggregate busy fraction {agg.get('aggregate_busy_fraction')} "
                      f"under {threshold}")
    if arm["workload"] in ("train", "serve") and not agg.get("tokens", 0) > 0:
        failed.append(f"{name}: no tokens")
    if card and arm["workload"] == "serve":
        for i, pod in enumerate(agg.get("per_pod", [])):
            if not (pod.get("k1_launches") or 0) > 0:
                failed.append(f"{name}: pod {i} launched no K1 ({pod.get('k1_launches')})")
    return failed


def burst_device_share(torch, burst, card: bool, name: str) -> str:
    """One profiled burst's host-clock wall against the device time of
    the kernels it launched, from the same trace: the device share inside
    a "busy" burst (the profiler's host cost is in the wall)."""
    if not card:
        t0 = time.perf_counter()
        burst()
        return f"wall {(time.perf_counter() - t0) * 1e3:.1f} ms; device time not measured " \
               "(no card)"
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        burst()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    trace = os.path.join(ROOT, "build", "workloads_torch", f"busy_{name}_trace.json")
    prof.export_chrome_trace(trace)
    with open(trace) as fh:
        kernels = [e["dur"] / 1e3 for e in json.load(fh)["traceEvents"]
                   if e.get("cat") == "kernel"]
    os.remove(trace)
    kernel_ms = sum(kernels)
    return (f"profiled wall {wall_ms:.1f} ms, its {len(kernels)} kernels' device time "
            f"{kernel_ms:.1f} ms: device share {kernel_ms / wall_ms:.3f} of the wall")


def busy_phase(torch, counters, busy=BUSY, device="cuda") -> tuple[int, int]:
    """Phase 7: each arm's pods through ``oversubscribe.run_pods`` under
    the Allocate environments the daemon gives one chip (``held_pod_envs``;
    tests/test_torch_oversubscribe.py holds them equal to the daemon's),
    then one burst of each workload built in this process after the pods
    have exited, its wall against its device time.  Returns K1's launches
    in this process's serve burst and in the serving pods."""
    import shutil
    import tempfile

    from workloads_torch import busy_probe
    from workloads_torch import oversubscribe as ov

    t_phase = time.perf_counter()
    card = device == "cuda"
    if busy["n_chips"] != 1:
        fail("phase 7: the held environments are one chip's")
    if card:
        torch.cuda.empty_cache()
        smi = subprocess.run(["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        mode = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() \
            else f"unread (nvidia-smi exit {smi.returncode}: {smi.stderr.strip()})"
        print(f"  compute mode: {mode}", flush=True)
        if mode != "Default":
            fail(f"phase 7: the card's compute mode is {mode!r}: time-sliced pods need "
                 f"'Default' (Exclusive_Process refuses a second context)")
    failed = []
    pod_launches = 0
    for name, arm in busy["arms"].items():
        t0 = time.perf_counter()
        tmp = tempfile.mkdtemp(prefix="chip-smoke-busy-")
        try:
            agg = ov.run_pods(held_pod_envs(arm["pods"], os.path.join(tmp, "leases")),
                              tmp, busy["duration"], arm["matrix_dim"], device,
                              arm["workload"])
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        seconds = time.perf_counter() - t0
        pods = "; ".join(
            f"pod {i}: {p['bursts']} bursts, busy {p['busy_fraction']:.4f}, K1 launches "
            f"{p['k1_launches']}, peak device memory "
            + (f"{p['peak_memory_bytes'] / 2**30:.2f} GiB" if p["peak_memory_bytes"] is not None
               else "not measured (no card)")
            for i, p in enumerate(agg["per_pod"]))
        tokens = (f"{agg['tokens']} tokens, {agg['aggregate_tokens_per_sec']} tokens/s"
                  if "tokens" in agg else "no tokens (occupancy burst)")
        print(f"  {name}: {arm['pods']} {arm['workload']} pods at replicas {arm['replicas']} "
              f"on {busy['n_chips']} chip, {busy['duration']} s windows: aggregate busy "
              f"fraction {agg['aggregate_busy_fraction']:.4f} (pass at "
              f"{ov.BASELINE_BUSY_FRACTION}), {tokens}; {pods}; {seconds:.1f} s", flush=True)
        failed += busy_gates(name, arm, agg, busy["n_chips"], ov.BASELINE_BUSY_FRACTION, card)
        if arm["workload"] == "serve":
            pod_launches += sum(p["k1_launches"] or 0 for p in agg["per_pod"])
    if failed:
        fail(f"phase 7: {failed}")
    # The pods have exited: this process's own bursts, one at a time,
    # sized to a quarter of the pods' second (a profiled second of the
    # matmul burst would trace ~200k launches).
    launches = 0
    target = busy["in_process_burst_secs"]
    builders = {"matmul": lambda: busy_probe.make_burst_fn(1024, target, device=device),
                "train": lambda: busy_probe.make_train_burst_fn(target, device=device)[0],
                "serve": lambda: busy_probe.make_serve_burst_fn(target, device=device)[0]}
    for workload, build in builders.items():
        reset_counts(counters)
        burst = build()
        share_text = burst_device_share(torch, burst, card, workload)
        k1 = read_counts(counters)["paged_attention"]
        print(f"  in-process {workload} burst: {share_text}; K1 launches {k1} (building, "
              f"calibrating and the bursts)", flush=True)
        if workload == "serve":
            launches = k1
            if card and k1 == 0:
                fail("phase 7: the serve burst launched no K1")
        del burst
    if card:
        torch.cuda.empty_cache()
    print(f"  sharing phase: {time.perf_counter() - t_phase:.1f} s; busy counts lease-held "
          f"host time, as the JAX probe's does", flush=True)
    return launches, pod_launches


# Phase 4k, JAX's threefry keys on the card (workloads_torch/prng.py and the
# threefry kernel): the kernel against its plain version bit for bit at every
# shape below, in its three modes, under PRNGKey(0), PRNGKey(42) and a split
# and a fold_in descendant of each; layer 0's w_up from PRNGKey(0) on the card
# against the CPU's plain draw; then phase 4's 12 requests in float32, sampled
# at the serve CLI's knobs under rng=PRNGKey(42): the graphed drain against
# the eager one token for token, and superstep_k=4 pipelined against k=1 on
# one request a slot (with slot turnover the admission draws interleave with
# the chunk keys at other steps, in the JAX engine as here, so the streams
# differ by design), K1 and threefry launches counted a decode step.
PRNG = dict(shapes=((1,), (7,), (3, 5, 7), (8, 32768), (2048, 32768)), seeds=(0, 42),
            temperature=0.8, top_k=50, top_p=0.95, rng_seed=42, w_up_ulps=4,
            timing_launches=64)
# The threefry kernel's bound by operations: about 80 int32 operations an
# element (20 rounds of add, funnel-shift and xor, 5 key injections of two
# adds, the counter and the output) over the H100 SXM's INT32 rate, 64
# lanes an SM (Hopper white paper) on 132 SMs at the 1.98 GHz boost clock.
THREEFRY_OPS_PER_ELEMENT = 80
INT32_OPS_PER_S = 132 * 64 * 1.98e9


def threefry_bound_ms(elements: int, out_bytes: int) -> tuple[float, str]:
    """The least time for ``elements`` hashes writing ``out_bytes``: the
    larger of the operations over the INT32 rate and the bytes (the key
    read once, the output written once) over the memory rate."""
    ops_ms = elements * THREEFRY_OPS_PER_ELEMENT / INT32_OPS_PER_S * 1e3
    bytes_ms = (16 + out_bytes) / HBM_BYTES_PER_S * 1e3
    return max((ops_ms, "operations"), (bytes_ms, "bytes"))


def check_threefry_cases(torch, tf, prng, pr=PRNG) -> tuple[int, float]:
    """The kernel against ``threefry_reference`` on the same keys: pair,
    bits and the uniform of [tiny, 1) (Gumbel's range), bit for bit.
    These launches are not the path's.  Returns (cases, the largest
    |kernel - plain| of the uniforms)."""
    tiny = float(torch.finfo(torch.float32).tiny)
    cases, worst = 0, 0.0
    launches = tf.threefry.launches
    for seed in pr["seeds"]:
        base = prng.PRNGKey(seed, device="cuda")
        for label, key in ((f"PRNGKey({seed})", base),
                           (f"split(PRNGKey({seed}), 3)[1]", prng.split(base, 3)[1]),
                           (f"fold_in(PRNGKey({seed}), 7)", prng.fold_in(base, 7))):
            for shape in pr["shapes"]:
                n = 1
                for d in shape:
                    n *= d
                for mode in ("pair", "bits", "uniform"):
                    got = tf.threefry(key[None].contiguous(), n, mode=mode, minval=tiny)
                    want = tf.threefry_reference(key[None], n, mode=mode, minval=tiny)
                    torch.cuda.synchronize()
                    if mode == "uniform":
                        worst = max(worst, (got - want).abs().max().item())
                        got, want = got.view(torch.int32), want.view(torch.int32)
                    differ = int((got != want).sum().item())
                    if differ or got.shape != want.shape:
                        fail(f"threefry kernel {mode} under {label} at {shape}: {differ} "
                             f"elements differ from the plain version")
                    cases += 1
                    del got, want
            print(f"  threefry kernel = plain version bit for bit under {label}: pair, bits "
                  f"and uniform at {', '.join(map(str, pr['shapes']))}", flush=True)
    tf.threefry.launches = launches
    torch.cuda.empty_cache()
    return cases, worst


def sampled_drain(torch, engine, requests, counters, label):
    """Serve ``requests`` from a fresh engine (no warm-up request: it would
    draw keys the compared drain does not), every kernel launch counted.
    Fails unless every request is ``ok`` with its full count, no page is
    left in use, and K1 launched n_layers times a decode step.  Returns
    the streams, decode steps and launch counts."""
    rids = [engine.submit(p, n) for p, n in requests]
    reset_counts(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    served = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts(counters)
    steps = engine.chunks_run * engine.chunk
    streams = [served.get(r) for r in rids]
    statuses = {r.rid: r.status for r in engine.completed}
    for rid, (_, n), toks in zip(rids, requests, streams):
        if statuses.get(rid) != "ok" or toks is None or len(toks) != n:
            fail(f"4k {label} {rid}: status {statuses.get(rid)}, "
                 f"{None if toks is None else len(toks)} tokens, wanted {n}")
    if engine.ctrl.used_pages != 0:
        fail(f"4k {label}: {engine.ctrl.used_pages} pages still in use after the drain")
    k1 = counts["paged_attention"]
    if k1 == 0 or k1 != engine.config.n_layers * steps:
        fail(f"4k {label}: paged_attention launched {k1} times, expected n_layers x decode "
             f"steps = {engine.config.n_layers * steps}")
    print(f"  {label}: {sum(len(s) for s in streams)} tokens in {wall:.2f} s (graph capture "
          f"included), {steps} decode steps, K1 {k1} ({k1 / steps:.0f} a step), threefry "
          f"{counts['threefry']} ({counts['threefry'] / steps:.2f} a step)", flush=True)
    return {"streams": streams, "steps": steps, "counts": counts, "wall": wall}


def sampled_chunk_times(torch, paged_mod, prng, engine, rng, f):
    """One sampled decode chunk from the same state through the graph and
    through the eager loop, under one chunk key: tokens and pools
    bit-identical; each timed on the host's clock to a synchronise, mean
    of 3.  Returns (graph ms, eager ms)."""
    for _ in range(f["slots"]):
        engine.submit(rng.integers(0, engine.config.vocab_size, f["decode_prompt"]),
                      2 * engine.chunk)
    engine._admit()
    engine._cover_chunk()
    inputs = (engine._dev(engine._tables), engine._dev(engine._tokens),
              engine._dev(engine._positions), engine._dev(engine._occupied))
    key = engine._next_key()
    saved = [p.clone() for p in engine.pools]

    def restore():
        for pool, copy in zip(engine.pools, saved):
            pool.copy_(copy)
        torch.cuda.synchronize()

    def graph_chunk():
        return engine._graph.run(*inputs, *engine._unbounded, engine.chunk,
                                 keys=prng.split(key, engine.chunk))[0].clone()

    def eager_chunk():
        with torch.inference_mode():
            return paged_mod.paged_decode_chunk(
                engine.params, engine.pools, *inputs, key, engine.temperature, engine.top_k,
                engine.top_p, engine.config, engine.chunk, True)[0]

    results, times = {}, {}
    for name, fn in (("graph", graph_chunk), ("eager", eager_chunk)):
        restore()
        fn()
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
    same = torch.equal(results["graph"][0], results["eager"][0]) and all(
        torch.equal(a, b) for a, b in zip(results["graph"][1], results["eager"][1]))
    print(f"  one sampled chunk ({engine.chunk} steps, {f['slots']} rows, float32) from the "
          f"same state and key: CUDA graph {times['graph']:.3f} ms, eager loop "
          f"{times['eager']:.3f} ms (host clock to a synchronise, mean of 3); tokens and pools "
          f"{'bit-identical' if same else 'DIFFER'}", flush=True)
    if not same:
        fail("a sampled graphed chunk differs from the eager loop from the same state")
    return times["graph"], times["eager"]


def prng_phase(torch, f, requests, pa, pr=PRNG) -> dict:
    """Phase 4k.  Returns the threefry kernel's record (every key of the
    contract's kernel line) and the phase's K1 launches."""
    import numpy as np

    from workloads_torch import paged as paged_mod
    from workloads_torch import prng
    from workloads_torch.model import ModelConfig, init_params
    from workloads_torch.ops import threefry as tf
    from workloads_torch.serve import ServeEngine

    cases, worst = check_threefry_cases(torch, tf, prng, pr)
    config = ModelConfig(
        d_model=f["d_model"], n_heads=f["n_heads"], n_layers=f["n_layers"], d_ff=f["d_ff"],
        vocab_size=f["vocab_size"], max_seq_len=f["decode_prompt"] + f["decode_lens"][1],
        dtype=torch.float32,
    )
    # One seed, one model: the card's tree against the CPU's plain draw.
    params = init_params(config, prng.PRNGKey(0, device="cuda"))
    keys = prng.split(prng.PRNGKey(0, device="cpu"), 2 + config.n_layers)
    want = prng.normal(prng.split(keys[2], 6)[2], (config.d_model, config.d_ff)) * 0.02
    got = params["layers"][0]["w_up"].cpu()
    ulps = ((got.double() - want.double()).abs()
            / torch.from_numpy(np.spacing(want.abs().numpy())).double())
    print(f"  layer 0 w_up [{config.d_model}, {config.d_ff}] from PRNGKey(0): card against "
          f"the CPU's plain draw, max {ulps.max().item():.0f} ulp, "
          f"{(ulps > 0).double().mean().item():.4f} of the values apart (limit "
          f"{pr['w_up_ulps']} ulp)", flush=True)
    if not ulps.max().item() <= pr["w_up_ulps"]:
        fail("the card's init_params from PRNGKey(0) is not the CPU's within "
             f"{pr['w_up_ulps']} ulp")
    del keys, want, got, ulps
    before = tf.threefry.launches
    draws = prng_draw_checks(torch, f)
    tf.threefry.launches = before  # comparison draws are not the path's
    counters = {"paged_attention": pa.paged_attention, "threefry": tf.threefry}
    knobs = dict(temperature=pr["temperature"], top_k=pr["top_k"], top_p=pr["top_p"])
    base = dict(slots=f["slots"], page_size=f["page_size"], chunk=f["page_size"],
                device="cuda", **knobs)

    def engine(**kw):
        return ServeEngine(params, config, rng=prng.PRNGKey(pr["rng_seed"], device="cuda"),
                           **base, **kw)

    runs = {"graph": sampled_drain(torch, engine(), requests, counters,
                                   "(a) sampled drain, graphed")}
    eager = engine()
    eager._graph = None  # every step through paged_decode_chunk, eagerly
    runs["eager"] = sampled_drain(torch, eager, requests, counters,
                                  "(b) sampled drain, eager")
    del eager
    one_a_slot = requests[:f["slots"]]
    runs["k1"] = sampled_drain(torch, engine(), one_a_slot, counters,
                               f"(c) {f['slots']} requests, one a slot, k=1")
    runs["k4"] = sampled_drain(torch, engine(superstep_k=4, pipelined=True), one_a_slot,
                               counters, f"(d) {f['slots']} requests, superstep_k=4 pipelined")
    if runs["graph"]["streams"] != runs["eager"]["streams"]:
        fail("4k: the sampled graphed drain differs from the eager drain")
    if runs["k4"]["streams"] != runs["k1"]["streams"]:
        fail("4k: the sampled superstep_k=4 pipelined drain differs from k=1")
    print(f"  sampled streams: graphed = eager on {len(requests)} requests, superstep_k=4 "
          f"pipelined = k=1 on {len(one_a_slot)}, token for token (float32)", flush=True)
    for name in ("graph", "k1", "k4"):
        if runs[name]["counts"]["threefry"] < runs[name]["steps"]:
            fail(f"4k {name}: threefry launched {runs[name]['counts']['threefry']} times over "
                 f"{runs[name]['steps']} sampled decode steps")
    launches = runs["graph"]["counts"]["threefry"]
    chunk_graph_ms, chunk_eager_ms = sampled_chunk_times(torch, paged_mod, prng, engine(),
                                                         np.random.default_rng(0), f)
    # The kernel at the main path's shape, the sampled step's [slots, vocab]
    # uniform, as a CUDA graph of launches (it is shorter than a launch).
    shape = (f["slots"], config.vocab_size)
    n = shape[0] * shape[1]
    key = prng.PRNGKey(pr["rng_seed"], device="cuda")[None].contiguous()
    tiny = float(torch.finfo(torch.float32).tiny)
    before = tf.threefry.launches
    kernel_ms = graph_ms(lambda i: tf.threefry(key, n, mode="uniform", minval=tiny),
                         pr["timing_launches"])
    tf.threefry.launches = before
    plain_ms = cuda_ms(lambda i: tf.threefry_reference(key, n, mode="uniform", minval=tiny),
                       20)
    bound_ms, bound_by = threefry_bound_ms(n, 4 * n)
    print(f"  threefry kernel at [{shape[0]}, {shape[1]}] (uniform): {kernel_ms * 1e3:.2f} us "
          f"(a CUDA graph of {pr['timing_launches']} launches), plain {plain_ms * 1e3:.2f} us, "
          f"bound {bound_ms * 1e3:.2f} us by {bound_by} ({bound_ms / kernel_ms:.3f} of it); no "
          f"PyTorch call computes threefry2x32; {cases} kernel-vs-plain cases bit-identical; "
          f"launches on the sampled path {launches}", flush=True)
    del params
    torch.cuda.empty_cache()
    record = {
        "name": "threefry", "route": "cuda", "source": "workloads_torch/ops/csrc/threefry.cu",
        "replaces": "none: XLA's threefry2x32 (jax/_src/prng.py threefry_2x32), no "
                    "pl.pallas_call",
        "launches": launches, "max_abs_err": worst, "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "sampled_chunk_graph_ms": chunk_graph_ms, "sampled_chunk_eager_ms": chunk_eager_ms,
        "launches_a_step": launches / runs["graph"]["steps"], "draw_checks": draws,
    }
    k1 = sum(runs[name]["counts"]["paged_attention"] for name in runs)
    return {"record": record, "k1": k1}


# Phase 4k's draws, the card's against the CPU's: perfbench's prompt seed
# forms (PRNGKey(n), and fold_in(PRNGKey(a), b) for (a, b)), each as long
# as the engine phases' prompts.
DRAW_PROMPT_SEEDS = (1, 2, 5, 7, 11, 13, 77, 100, (11, 0), (11, 100), (23, 0), (23, 100))


def prng_draw_checks(torch, f, device="cuda", scale_name="full") -> int:
    """The port's draws on JAX's keys, drawn on ``device`` against the
    CPU's, bit for bit: ``train.synthetic_batch`` at phase 6's shape,
    perfbench's prompts in every seed form (``_prompt`` draws on the
    CPU, so its keys draw again on ``device``), ``_prompts`` at phase
    4's shape and ``_rand_qkv`` at the shortest attention length of
    perfbench's ``scale_name`` (6f's).  Returns the number of draws
    compared."""
    from workloads_torch import perfbench as pb
    from workloads_torch import prng, train
    from workloads_torch.model import ModelConfig

    compared = []

    def same(got, want, what):
        if got.dtype in (torch.bfloat16, torch.float32):
            got, want = (t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)
                         for t in (got, want))
        differ = int((got.cpu() != want).sum()) if got.shape == want.shape else -1
        if differ:
            fail(f"4k {what}: the draw on {device} differs from the CPU's "
                 f"({differ} elements; -1: shapes {tuple(got.shape)}, {tuple(want.shape)})")
        compared.append(what)

    config = ModelConfig(vocab_size=f["vocab_size"], max_seq_len=f["train_seq"])
    B = f["train_batch"]
    same(train.synthetic_batch(config, B, seed=0, device=device),
         train.synthetic_batch(config, B, seed=0, device="cpu"),
         f"synthetic_batch [{B}, {config.max_seq_len}] seed 0")
    length = f["decode_prompt"]
    for seed in DRAW_PROMPT_SEEDS:
        if isinstance(seed, int):
            key = prng.PRNGKey(seed, device=device)
        else:
            key = prng.fold_in(prng.PRNGKey(seed[0], device=device), seed[1])
        want = torch.tensor(pb._prompt(seed, length, f["vocab_size"]), dtype=torch.int32)
        same(prng.randint(key, (length,), 0, f["vocab_size"]), want, f"_prompt({seed})")
    same(pb._prompts(1, f["slots"], length, f["vocab_size"], device),
         pb._prompts(1, f["slots"], length, f["vocab_size"], "cpu"),
         f"_prompts(1, {f['slots']}, {length})")
    scale = pb.BenchScale.named(scale_name)
    seq = min(scale.attn_seqs)
    for name, got, want in zip("qkv", pb._rand_qkv(seq, scale.attn_heads, device=device),
                               pb._rand_qkv(seq, scale.attn_heads, device="cpu")):
        same(got, want, f"_rand_qkv({seq}, {scale.attn_heads}) {name} (bf16)")
    print(f"  draws on {device} = the CPU's bit for bit: synthetic_batch [{B}, "
          f"{config.max_seq_len}] (vocab {config.vocab_size}), {len(DRAW_PROMPT_SEEDS)} prompt "
          f"seed forms {list(DRAW_PROMPT_SEEDS)} at length {length}, _prompts(1, {f['slots']}, "
          f"{length}), _rand_qkv({seq}, {scale.attn_heads}) q, k and v in bf16", flush=True)
    return len(compared)


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


def flash_numbers(torch, fa, f, peak: float) -> list[dict]:
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
        ops_ms = flops / peak * 1e3
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


def train_path(torch, model_mod, train_mod, pb, fa, counters, f, peak: float):
    """Phase 6: the training path at full width.  Returns the kernels'
    launch counts over the main run (the fixed-batch and synthetic
    steps), the step's ms (CUDA events) and its MFU (the FLOPs of
    ``perfbench.train_step_flops`` over ``peak``)."""
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
    seq = config.max_seq_len - 1
    print(f"  batch {B} x {config.max_seq_len} tokens (forward at seq {seq}), "
          f"{config.n_layers} layers, remat off, AdamW lr {TRAIN_LR}; attention route: the "
          f"kernel table picks {model_mod._pick_kernel(seq)!r}, and the dense score matrix "
          f"would hold {4 * B * config.n_heads * seq * seq / 2**20:.0f} MiB against the "
          f"{model_mod._DENSE_SCORE_BYTES_CAP / 2**20:.0f} MiB cap", flush=True)

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
    flops = pb.train_step_flops(config, B)
    mfu = flops / (step_ms / 1e3) / peak
    print(f"  training step {step_ms:.1f} ms (mean of {iters}), {tokens / step_ms * 1e3:.1f} "
          f"tokens/s, {flops / 1e12:.2f} TFLOP a step, MFU {mfu:.4f} of "
          f"{peak / 1e12:.0f} TFLOP/s", flush=True)
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
    return launches, step_ms, mfu


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
        from workloads_torch import perfbench as pb
        from workloads_torch import train as train_mod
        from workloads_torch.model import ModelConfig, cast_params, init_params
        from workloads_torch.ops import _build
        from workloads_torch.ops import attention as fa
        from workloads_torch.ops import kernel_select as ks
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
    peak = pb.device_peak_flops()
    if peak is None:
        fail(f"{kind!r} is not in perfbench's peak table: no bound and no MFU without it")
    print(f"  dense bf16 peak {peak / 1e12:.1f} TFLOP/s (perfbench.device_peak_flops)",
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
        init_params(config, prng_key(0, "cuda")), config.dtype
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
    chunk_wall, chunk_busy, _, _, chunk_kernels, _ = profile_chunk(torch, engine, rng, f, pa)
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
    # the same tokens): at 8 rows (K1 takes one split), at 2 rows, where
    # K1 cuts each row's pages into the host's split count in both dtypes,
    # and at 8 rows as deep as phase 4c decodes (to 896 positions) over its engines'
    # 17-column tables; phase 4c holds its arms to that step's bf16 floor.
    from dataclasses import replace

    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    kv_width = -(-(KV["max_seq_len"] + KV["chunk"]) // KV["page_size"])
    step_rows = {"8 rows": ([32, 100, 200, 300, 400, 500, 543, 1], None),
                 "2 rows": ([543, 300], None),
                 "8 rows at phase 4c's depth": ([896, 833, 770, 704, 640, 577, 895, 1],
                                                kv_width)}
    floors = {}
    for label, (lengths, step_width) in step_rows.items():
        rows = len(lengths)
        width = step_width or -(-max(lengths) // f["page_size"]) + 1
        splits_here = pa.choose_splits(rows, config.kv_heads, width, sm_count)
        if label == "2 rows" and splits_here < 2:
            fail(f"the host keeps one K1 split for the 2-row step ({splits_here}): the split "
                 f"route in bf16 goes ungated")
        steps = {}
        for dtype in (torch.float32, torch.bfloat16):
            step_params = params if dtype == config.dtype else cast_params(params, dtype)
            steps[dtype] = teacher_forced_step(torch, paged_mod, pa, step_params,
                                               replace(config, dtype=dtype), f["page_size"],
                                               lengths, width=step_width)
            del step_params
        got32, want32 = steps[torch.float32]
        got16, want16 = steps[torch.bfloat16]
        scale = want32.abs().max().item()
        f32_err = (got32 - want32).abs().max().item()
        f32_tol = STEP_F32_RTOL * scale
        bf16_err = (got16 - want16).abs().max().item()
        bf16_floor = (want16 - want32).abs().max().item()
        bf16_rms = (got16 - want16).square().mean().sqrt().item()
        floor_rms = (want16 - want32).square().mean().sqrt().item()
        print(f"  teacher-forced decode step, {label} (K1 splits {splits_here} in both dtypes), "
              f"max |logit| {scale:.4e}: float32 kernel vs plain {f32_err:.4e} (limit "
              f"{f32_tol:.4e} = {STEP_F32_RTOL} x max); bfloat16 kernel vs plain max "
              f"{bf16_err:.4e} rms {bf16_rms:.4e} (limits: the bf16 floor, plain bf16 vs "
              f"plain float32, max {bf16_floor:.4e} rms {floor_rms:.4e})", flush=True)
        if not (torch.isfinite(got32).all() and torch.isfinite(got16).all()):
            fail("the teacher-forced decode step gave non-finite logits")
        if not f32_err <= f32_tol:
            fail(f"float32 decode step through the kernel disagrees with the plain route "
                 f"({label})")
        floors[label] = bf16_floor
        if label == "2 rows":
            # The split route's reading while each share started from -1e30
            # (rows 543 and 300, this width), beside this one.
            print(f"  2-row bf16 step at {splits_here} splits, rms {bf16_rms:.4e} against the "
                  f"floor's {floor_rms:.4e} (each share from -1e30 read rms 2.98e-02 against "
                  f"2.93e-02, outside)", flush=True)
        if not (bf16_err <= bf16_floor and bf16_rms <= floor_rms):
            fail(f"bfloat16 decode step through the kernel differs from the plain route by "
                 f"more than bf16 differs from float32 ({label}, {splits_here} splits)")

    # 4b. the request lifecycle at the same width
    phase("serving path: request lifecycle at full width")
    t0 = time.perf_counter()
    lifecycle_launches = lifecycle_phase(torch, params, config, f, counters)
    print(f"  lifecycle phase: {time.perf_counter() - t0:.1f} s, K1 launches "
          f"{lifecycle_launches}", flush=True)

    # 4c. the KV-cache hierarchy at the same width
    phase("serving path: KV-cache hierarchy at full width")
    t0 = time.perf_counter()
    kv_launches = kv_phase(torch, params, config, KV, counters,
                           floors["8 rows at phase 4c's depth"])
    print(f"  KV hierarchy phase: {time.perf_counter() - t0:.1f} s, K1 launches "
          f"{kv_launches}", flush=True)

    # 4d. speculative decoding at the same width
    phase("serving path: speculative decoding at full width")
    t0 = time.perf_counter()
    spec_launches = spec_phase(torch, params, config, f, counters, requests,
                               drains["defaults"], floors["8 rows"])
    print(f"  speculative decoding phase: {time.perf_counter() - t0:.1f} s, K1 launches "
          f"{spec_launches}; card: {card}", flush=True)

    # 4e. multi-LoRA serving at the same width
    phase("serving path: multi-LoRA at full width")
    t0 = time.perf_counter()
    lora_launches = lora_phase(torch, params, config, f, counters, requests,
                               drains["defaults"], floors["8 rows"],
                               (chunk_wall, chunk_busy, chunk_kernels))
    print(f"  multi-LoRA phase: {time.perf_counter() - t0:.1f} s, K1 launches "
          f"{lora_launches}; card: {card}", flush=True)

    # 4f. the fleet and its control plane at the same width
    phase("serving path: fleet and control plane at full width")
    t0 = time.perf_counter()
    fleet_launches = fleet_phase(torch, params, config, f, counters,
                                 drains["defaults"]["tokens_per_s"])
    print(f"  fleet phase: {time.perf_counter() - t0:.1f} s, K1 launches "
          f"{fleet_launches}; card: {card}", flush=True)

    # 4g. device-time profiling and fast start at the same width
    phase("serving path: device-time profiling and fast start at full width")
    t0 = time.perf_counter()
    profiling_launches = profiling_phase(torch, params, config, f, counters)
    print(f"  profiling phase: {time.perf_counter() - t0:.1f} s, K1 launches "
          f"{profiling_launches}; card: {card}", flush=True)

    # 4h. perfbench's engine arms of this slice, at the tiny scale
    phase("serving path: perfbench's fault, speculation, LoRA, prefix and KV arms (tiny)")
    t0 = time.perf_counter()
    bench_engine_launches = bench_engine_phase(torch, pb, counters)["paged_attention"]
    print(f"  perfbench engine arms: {time.perf_counter() - t0:.1f} s, K1 launches "
          f"{bench_engine_launches}; card: {card}", flush=True)

    # 4i. perfbench's fleet arms, at the tiny scale
    phase("serving path: perfbench's fleet, disaggregation, self-healing, autoscaling, "
          "KV-page scheduling, durability and goodput-control arms (tiny)")
    t0 = time.perf_counter()
    bench_fleet_launches = bench_fleet_phase(torch, pb, counters)["paged_attention"]
    print(f"  perfbench fleet arms: {time.perf_counter() - t0:.1f} s, K1 launches "
          f"{bench_fleet_launches}; card: {card}", flush=True)

    # 4j. tensor-parallel serving, two ranks on the one card, at half the
    # depth (widths unchanged), so the run keeps inside its time limit
    phase("serving path: tensor-parallel serving, 2 ranks over gloo on one card, float32 "
          "arms and a bf16 step, 4 of the model's 8 layers")
    t0 = time.perf_counter()
    tp_launches = tp_phase(torch, dict(f, n_layers=WORLD_PHASE_LAYERS), requests)
    print(f"  tensor-parallel phase: {time.perf_counter() - t0:.1f} s, K1 launches "
          f"{tp_launches} over both ranks; card: {card}", flush=True)

    # 4k. JAX's threefry keys on the card: the kernel, the seeded weights and
    # the sampled streams
    phase("serving path: JAX's threefry keys, the threefry kernel and sampled drains at "
          "full width")
    prng_out = prng_phase(torch, f, requests, pa)
    threefry_record = dict(prng_out["record"], card=card)
    print(f"  card: {card}", flush=True)

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
    splits = pa.choose_splits(B, config.kv_heads, max_pages, sm_count)
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
    ops_ms = flops / peak * 1e3
    bound_ms, bound_by = max((bytes_ms, "bytes"), (ops_ms, "operations"))
    print(f"  K1 at B={B} H={H} hd={hd} ps={ps} depth {depth}: kernel "
          f"{kernel_ms * 1e3:.2f} us with the host's {splits} splits ({other_ms * 1e3:.2f} "
          f"us with {other}), plain {plain_ms * 1e3:.2f} us, sdpa "
          f"{library_ms * 1e3:.2f} us (sdpa vs plain max_abs_err "
          f"{lib_err:.2e}), bound {bound_ms * 1e3:.2f} us by {bound_by} "
          f"({bytes_moved / 1e6:.2f} MB), {bytes_moved / kernel_ms / 1e6:.1f} "
          f"GB/s achieved, {bound_ms / kernel_ms:.3f} of the bound; kernel and sdpa timed "
          f"as CUDA graphs of {n_graph} launches", flush=True)
    # Not gates: 1 and 2 rows as long as the engine's table holds (640
    # positions), where only the split fills the card: the host's split
    # count against 1, each a CUDA graph of n_graph launches.
    long_len = max_pages * ps
    split_ms = []
    for rows in (1, 2):
        q1, k1, v1, t1, l1 = paged_inputs(
            torch, batch=rows, heads=H, kv_heads=config.kv_heads, head_dim=hd, page_size=ps,
            lengths=[long_len] * rows, layers=L, dtype=torch.bfloat16, seed=6,
        )
        long_splits = pa.choose_splits(rows, config.kv_heads, max_pages, sm_count)
        long_err = (pa.paged_attention(q1, k1, v1, t1, l1, layer=0).float()
                    - pa.paged_attention_reference(q1, k1, v1, t1, l1, layer=0,
                                                   window=None).float()).abs().max().item()
        long_ms = graph_ms(lambda i: pa.paged_attention(q1, k1, v1, t1, l1, layer=i % L),
                           n_graph)
        long_one_ms = graph_ms(
            lambda i: pa.paged_attention(q1, k1, v1, t1, l1, layer=i % L, splits=1), n_graph)
        long_bytes = 2 * rows * long_len * config.kv_heads * hd * elt
        print(f"  K1 bf16 at B={rows}, rows of {long_len} positions: {long_ms * 1e3:.2f} us with "
              f"the host's {long_splits} splits, {long_one_ms * 1e3:.2f} us with 1 "
              f"({long_bytes / 1e6:.2f} MB of pages: {long_bytes / long_ms / 1e6:.1f} and "
              f"{long_bytes / long_one_ms / 1e6:.1f} GB/s), max_abs_err {long_err:.2e}; CUDA "
              f"graphs of {n_graph} launches", flush=True)
        split_ms.append({"rows": rows, "positions": long_len, "splits": long_splits,
                         "ms": long_ms, "one_split_ms": long_one_ms, "max_abs_err": long_err})
        del q1, k1, v1
    pa.paged_attention.launches = launches_before
    print(f"  card: {card}", flush=True)
    record = {
        "name": "paged_attention",
        "route": "cuda",
        "source": "workloads_torch/ops/csrc/paged_attention.cu",
        "replaces": "workloads/ops/paged_attention.py:56",
        "launches": launches + lifecycle_launches + kv_launches + spec_launches
        + lora_launches + fleet_launches + profiling_launches + bench_engine_launches
        + bench_fleet_launches + tp_launches + prng_out["k1"],
        "lifecycle_launches": lifecycle_launches,
        "prng_launches": prng_out["k1"],
        "kv_launches": kv_launches,
        "spec_launches": spec_launches,
        "lora_launches": lora_launches,
        "fleet_launches": fleet_launches,
        "profiling_launches": profiling_launches,
        "bench_engine_launches": bench_engine_launches,
        "bench_fleet_launches": bench_fleet_launches,
        "tp_launches": tp_launches,
        "max_abs_err": main_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
        "splits": splits,
        "bf16_split_ms": split_ms,
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
    flash_records = flash_numbers(torch, fa, f, peak)
    torch.cuda.empty_cache()

    # 6. the training path at full width
    phase("training path: workloads_torch.train at full width")
    train_launches, train_ms, train_mfu = train_path(
        torch, model_mod, train_mod, pb, fa, counters, f, peak)
    torch.cuda.empty_cache()

    # 6e. the LoRA fine-tune at the same shape
    phase("training path: LoRA fine-tune (workloads_torch.lora) at full width")
    t0 = time.perf_counter()
    lora_train_launches = lora_train_path(torch, model_mod, train_mod, counters, f)
    print(f"  LoRA fine-tune phase: {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()

    # 6f. perfbench's training and kernel arms at the full scale
    phase("training path: perfbench's train, flash-vs-dense, window and paged decode "
          "arms at full width")
    t0 = time.perf_counter()
    bench_launches, _ = bench_kernel_phase(torch, pb, ks, model_mod, fa, counters,
                                           phase6=(train_ms, train_mfu))
    print(f"  perfbench kernel arms: {time.perf_counter() - t0:.1f} s; card: {card}",
          flush=True)
    record["launches"] += bench_launches["paged_attention"]
    record["bench_kernel_launches"] = bench_launches["paged_attention"]
    torch.cuda.empty_cache()

    # 6g. the training layouts, two ranks on the one card, at half the depth
    phase("training path: data-, tensor- and sequence-parallel steps, 2 gloo ranks on one "
          "card, full width, 4 of the model's 8 layers")
    t0 = time.perf_counter()
    train_par_launches = train_parallel_phase(torch, dict(f, n_layers=WORLD_PHASE_LAYERS))
    print(f"  training layouts phase: {time.perf_counter() - t0:.1f} s; card: {card}",
          flush=True)

    # 6h. the pipeline and expert layouts, two ranks on the one card, at half
    # the depth
    phase("training path: pipeline- and expert-parallel steps, 2 gloo ranks on one card, "
          "full width, 4 of the model's 8 layers")
    t0 = time.perf_counter()
    pp_ep_launches_ = pp_ep_phase(torch, dict(f, n_layers=WORLD_PHASE_LAYERS))
    print(f"  pipeline and expert layouts phase: {time.perf_counter() - t0:.1f} s; card: "
          f"{card}", flush=True)

    # 6i. the vision CNN
    phase("training path: the vision CNN (workloads_torch.vision) on the card")
    vision_launches = vision_phase(torch, card)
    threefry_record["launches"] += vision_launches
    threefry_record["vision_launches"] = vision_launches
    torch.cuda.empty_cache()

    # 7. the sharing path, once the card is otherwise idle
    phase("sharing path: oversubscribed pods time-slicing the card under the chip lease")
    busy_launches, busy_pod_launches = busy_phase(torch, counters)
    record["launches"] += busy_launches
    record["busy_launches"] = busy_launches
    record["busy_pod_launches"] = busy_pod_launches
    print(f"  card: {card}", flush=True)
    for rec in flash_records:
        rec["launches"] = (train_launches[rec["name"]] + lora_train_launches[rec["name"]]
                           + bench_launches[rec["name"]] + train_par_launches[rec["name"]]
                           + pp_ep_launches_[rec["name"]])
        rec["lora_launches"] = lora_train_launches[rec["name"]]
        rec["bench_launches"] = bench_launches[rec["name"]]
        rec["train_parallel_launches"] = train_par_launches[rec["name"]]
        rec["pipeline_expert_launches"] = pp_ep_launches_[rec["name"]]
    end_phase()
    print(f"  chip_smoke: {time.perf_counter() - T_START:.1f} s in all; card: {card}",
          flush=True)
    print(json.dumps({"kernels": [record, *flash_records, threefry_record]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
