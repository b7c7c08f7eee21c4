#!/usr/bin/env python3
"""Drive the PyTorch port (``workloads_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run loudly:

1. device: require CUDA; print the card's name and power limit
   (nvidia-smi) and turn TF32 off for float32 matmuls and convolutions;
2. build every CUDA kernel of the port from the sources in this
   checkout (one nvcc per source);
3. hold each kernel against its plain PyTorch version on the card, in
   bfloat16 and float32, at the serving path's shapes and its variants;
4. drive the main path: a ``ServeEngine`` at the full width of the
   widest model the repo defines (d_model 2048, 16 heads, 8 layers,
   d_ff 8192, vocab 32768, bf16, page_size 64; depth uncut, random
   weights from a seed) serving a mixed stream of requests to the
   end, with every kernel launch counted; then one teacher-forced
   decode step through the kernel and through the plain version, in
   float32 and in bfloat16, the bf16 limit being the step's own bf16
   precision floor measured in the same run;
5. time each kernel, its plain version and the closest single PyTorch
   call with CUDA events at the main path's shapes, beside the bound
   the card's memory rate and peak arithmetic rate set.

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

FULL = dict(
    d_model=2048, n_heads=16, n_layers=8, d_ff=8192, vocab_size=32768,
    page_size=64, decode_prompt=32, decode_lens=(64, 512), slots=8,
)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


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
    for name, shape, window in cases:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, tables, lens = paged_inputs(
                torch, batch=len(shape["lengths"]), dtype=dtype, seed=1, **shape
            )
            layer = shape["layers"] - 1
            got = pa.paged_attention(q, k, v, tables, lens, layer=layer, window=window)
            want = pa.paged_attention_reference(
                q, k, v, tables, lens, layer=layer, window=window
            )
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            tol = KERNEL_ATOL[str(dtype).split(".")[1]]
            zero_rows = [i for i, n in enumerate(shape["lengths"]) if n == 0]
            zeros_ok = all(bool((got[i] == 0).all()) for i in zero_rows)
            print(f"  K1 {name:24s} {str(dtype):15s} max_abs_err={err:.3e} "
                  f"tol={tol:.0e} length-0 rows zero={zeros_ok}", flush=True)
            if not (err <= tol) or not zeros_ok:
                fail(f"K1 disagrees with its plain version: {name} {dtype}")


def profile_chunk(torch, engine, rng, f):
    """Where one decode chunk's time goes: torch.profiler over one engine
    step with every slot decoding, read from its chrome trace (device
    kernels by name, their summed time against the step's wall time)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(f["slots"]):
        engine.submit(rng.integers(0, engine.config.vocab_size, f["decode_prompt"]),
                      3 * engine.chunk)
    engine.step()  # admission and a first chunk, outside the window
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        engine.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    trace = os.path.join(ROOT, "build", "workloads_torch", "decode_chunk_trace.json")
    prof.export_chrome_trace(trace)
    with open(trace) as fh:
        events = json.load(fh)["traceEvents"]
    by_name: dict[str, list] = {}
    for e in events:
        if e.get("cat") == "kernel":
            by_name.setdefault(e["name"], []).append(e["dur"] / 1e3)
    engine.run()
    busy_ms = sum(sum(v) for v in by_name.values())
    if busy_ms == 0:
        print("  profiled decode chunk: device time not measured (no kernel "
              "events in the trace)", flush=True)
        return
    print(f"  profiled decode chunk ({engine.chunk} steps, {f['slots']} rows): "
          f"wall {wall_ms:.3f} ms, device kernels {busy_ms:.3f} ms, device "
          f"idle share {1 - busy_ms / wall_ms:.3f}", flush=True)
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:8]
    for name, durs in top:
        print(f"    {sum(durs):9.3f} ms {len(durs):6d} launches  {name[:90]}",
              flush=True)


def teacher_forced_step(torch, paged_mod, pa, params, config, ps):
    """Prefill 8 rows of ragged length, then run one decode step through
    the kernel and, on a copy of the pools, through the plain version.
    Returns (kernel logits, plain logits)."""
    lengths = [32, 100, 200, 300, 400, 500, 543, 1]
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
        got, _ = paged_mod._decode_core(params, pools, tables_dec, tok,
                                        lens.long(), config)

        def plain(q, kp, vp, t, ln, layer):
            return pa.paged_attention_reference(q, kp, vp, t, ln, layer=layer,
                                                window=config.attention_window)

        want, _ = paged_mod._decode_core(params, ref_pools, tables_dec, tok,
                                         lens.long(), config, attention_fn=plain)
        torch.cuda.synchronize()
    return got, want


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a GPU")
    sys.path.insert(0, ROOT)
    try:
        from workloads_torch import paged as paged_mod
        from workloads_torch.model import ModelConfig, cast_params, init_params
        from workloads_torch.ops import _build
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

    # 2. build
    phase("build")
    for name in _build.KERNELS:
        print(f"  built {name} in {_build.build(name):.2f} s (0 when reused)",
              flush=True)
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}", flush=True)

    # 3. kernel against plain
    phase("kernel against plain version")
    check_kernel_cases(torch, pa)

    # 4. main path at full width
    phase("main path: ServeEngine at full width")
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
    engine = ServeEngine(
        params, config, slots=f["slots"], page_size=f["page_size"],
        chunk=f["page_size"], device="cuda",
    )
    print(f"  model {n_params / 1e6:.1f}M params, pool "
          f"{tuple(engine.pools[0].shape)} x2, {len(max_new)} requests, "
          f"prompt {f['decode_prompt']}, max_new_tokens {max_new}", flush=True)
    import numpy as np

    rng = np.random.default_rng(0)
    rids = [
        engine.submit(rng.integers(0, config.vocab_size, f["decode_prompt"]), n)
        for n in max_new
    ]
    pa.paged_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    served = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = pa.paged_attention.launches
    decode_steps = engine.chunks_run * engine.chunk
    tokens_per_s = engine.generated_tokens / wall
    statuses = {r.rid: r.status for r in engine.completed}
    print(f"  drained in {wall:.3f} s: {engine.generated_tokens} tokens, "
          f"{engine.chunks_run} chunks = {decode_steps} decode steps, "
          f"decode tokens/s {tokens_per_s:.1f}, "
          f"paged_attention launches {launches}, pages in use after drain "
          f"{engine.ctrl.used_pages}", flush=True)
    for rid, n in zip(rids, max_new):
        toks = served.get(rid)
        if statuses.get(rid) != "ok" or toks is None or len(toks) != n:
            fail(f"{rid}: status {statuses.get(rid)}, "
                 f"{None if toks is None else len(toks)} tokens, wanted {n}")
        if not all(0 <= t < config.vocab_size for t in toks):
            fail(f"{rid}: token out of the vocabulary")
    if engine.ctrl.used_pages != 0:
        fail(f"{engine.ctrl.used_pages} pages still in use after the drain")
    if launches == 0 or launches != config.n_layers * decode_steps:
        fail(f"paged_attention launched {launches} times, expected "
             f"n_layers x decode steps = {config.n_layers * decode_steps}")

    profile_chunk(torch, engine, rng, f)

    # One teacher-forced decode step, kernel route against plain route, in
    # float32 and in the serving dtype (same weights, bf16-valued, and
    # the same tokens).
    from dataclasses import replace

    steps = {}
    for dtype in (torch.float32, torch.bfloat16):
        step_params = params if dtype == config.dtype else cast_params(params, dtype)
        steps[dtype] = teacher_forced_step(torch, paged_mod, pa, step_params,
                                           replace(config, dtype=dtype), f["page_size"])
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
    print(f"  teacher-forced decode step, max |logit| {scale:.4e}: float32 kernel "
          f"vs plain {f32_err:.4e} (limit {f32_tol:.4e} = {STEP_F32_RTOL} x max); "
          f"bfloat16 kernel vs plain max {bf16_err:.4e} rms {bf16_rms:.4e} "
          f"(limits: the bf16 floor, plain bf16 vs plain float32, max "
          f"{bf16_floor:.4e} rms {floor_rms:.4e})", flush=True)
    if not (torch.isfinite(got32).all() and torch.isfinite(got16).all()):
        fail("the teacher-forced decode step gave non-finite logits")
    if not f32_err <= f32_tol:
        fail("float32 decode step through the kernel disagrees with the plain route")
    if not (bf16_err <= bf16_floor and bf16_rms <= floor_rms):
        fail("bfloat16 decode step through the kernel differs from the plain "
             "route by more than bf16 differs from float32")

    # 5. numbers at the main path's shapes: 8 slots at the deepest
    # position a request of this run reaches (32 + 512 = 544 tokens).
    phase("numbers")
    B, H, hd, L = f["slots"], config.n_heads, config.head_dim, config.n_layers
    ps = f["page_size"]
    depth = f["decode_prompt"] + f["decode_lens"][1]
    max_pages = engine.max_pages
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
    iters = 200
    launches_before = pa.paged_attention.launches
    kernel_ms = cuda_ms(
        lambda i: pa.paged_attention(q, k, v, tables, lens, layer=i % L), iters)
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
    library_ms = cuda_ms(
        lambda i: sdpa(q[:, :, None], views[i % L][0], views[i % L][1],
                       attn_mask=mask), iters)
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
          f"{kernel_ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, sdpa "
          f"{library_ms * 1e3:.2f} us (sdpa vs plain max_abs_err "
          f"{lib_err:.2e}), bound {bound_ms * 1e3:.2f} us by {bound_by} "
          f"({bytes_moved / 1e6:.2f} MB), {bytes_moved / kernel_ms / 1e6:.1f} "
          f"GB/s achieved", flush=True)
    print(f"  card: {card}", flush=True)
    record = {
        "name": "paged_attention",
        "route": "cuda",
        "source": "workloads_torch/ops/csrc/paged_attention.cu",
        "replaces": "workloads/ops/paged_attention.py:56",
        "launches": launches,
        "max_abs_err": main_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
        "decode_tokens_per_s": tokens_per_s,
        "card": card,
    }
    if not main_err <= KERNEL_ATOL["bfloat16"]:
        fail(f"K1 at the main path's shapes: max_abs_err {main_err}")
    print(json.dumps({"kernels": [record]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
