#!/usr/bin/env python3
"""The device time of one sampled decode chunk on the GPU, from several
checkouts of the repo, in turns, in one call.

    python3 chip_sampled_chunk.py TREE [TREE ...] [--reps N]

Each TREE is the root of a checkout (``.`` for this one).  The trees are
measured in the order given and then in reverse (A B B A), each in a
process of its own, all building their kernels into one directory
(``build/sampled_chunk/``: an unchanged source is built once).  Two
versions are compared only inside one call: two cards, or one card at two
moments, differ by more than most changes do.

What is measured: ``chip_smoke.FULL``'s model in bf16 (random weights
from seed 0) behind a ``ServeEngine`` of 8 slots, page_size and chunk 64,
sampling at the serve CLI's knobs (temperature 0.8, top_k 50, top_p
0.95), on the card's CUDA graph.  Each repetition admits 8 requests of
32 prompt tokens, runs one chunk outside the window (admission, the
graph's capture on the first), then profiles one engine step, a whole
chunk of 64 sampled decode steps: its wall time to a synchronise and its
device time, the kernels of the trace summed.  The sampler is what the
tree has: a ``prng`` key (``rng=``, JAX's threefry through the threefry
kernel) or, on trees before it, a ``torch.Generator`` (``generator=``,
``torch.multinomial``).  One JSON line a reading; the card's name and
power limit first.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
BUILD = os.path.join(ROOT, "build", "sampled_chunk")
KNOBS = dict(temperature=0.8, top_k=50, top_p=0.95)


def child(tree: str, reps: int) -> dict:
    """One tree's readings, in this process."""
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from workloads_torch.model import ModelConfig, cast_params, init_params
    from workloads_torch.ops import _build
    from workloads_torch.serve import ServeEngine

    try:
        from workloads_torch import prng
    except ImportError:
        prng = None
    _build.set_build_dir(BUILD)
    os.makedirs(BUILD, exist_ok=True)
    f = cs.FULL
    config = ModelConfig(d_model=f["d_model"], n_heads=f["n_heads"], n_layers=f["n_layers"],
                         d_ff=f["d_ff"], vocab_size=f["vocab_size"],
                         max_seq_len=f["decode_prompt"] + f["decode_lens"][1],
                         dtype=torch.bfloat16)
    if prng is not None:
        params = init_params(config, prng.PRNGKey(0, device="cuda"))
        sampler = {"rng": prng.PRNGKey(42, device="cuda")}
    else:
        params = init_params(config, torch.Generator("cuda").manual_seed(0))
        sampler = {"generator": torch.Generator("cuda").manual_seed(42)}
    params = cast_params(params, config.dtype)
    engine = ServeEngine(params, config, slots=f["slots"], page_size=f["page_size"],
                         chunk=f["page_size"], device="cuda", **KNOBS, **sampler)
    rng = np.random.default_rng(0)
    walls, busys, kernels = [], [], {}
    for _ in range(reps):
        for _ in range(f["slots"]):
            engine.submit(rng.integers(0, config.vocab_size, f["decode_prompt"]),
                          3 * engine.chunk)
        engine.step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            engine.step()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        trace = os.path.join(BUILD, f"trace-{os.getpid()}.json")
        prof.export_chrome_trace(trace)
        with open(trace) as fh:
            events = json.load(fh)["traceEvents"]
        os.unlink(trace)
        busy = 0.0
        for ev in events:
            if ev.get("cat") == "kernel":
                busy += ev["dur"] / 1e3
                kernels[ev["name"]] = kernels.get(ev["name"], 0.0) + ev["dur"] / 1e3 / reps
        if busy == 0.0:
            raise RuntimeError("the profiler's trace holds no kernel: device time not measured")
        busys.append(busy)
        while not engine.idle:
            engine.step()
    top = dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:8])
    return {"tree": tree, "sampler": "rng" if prng is not None else "generator",
            "wall_ms": walls, "device_ms": busys,
            "device_ms_median": statistics.median(busys), "top_kernels_ms": top}


def main(argv: list[str]) -> int:
    if argv[:1] == ["--child"]:
        print(json.dumps(child(argv[1], int(argv[2]))), flush=True)
        return 0
    reps = 5
    if "--reps" in argv:
        i = argv.index("--reps")
        reps = int(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    if smi.returncode != 0:
        print(f"nvidia-smi failed: {smi.stderr.strip()}", file=sys.stderr)
        return 1
    print(smi.stdout.strip().splitlines()[0], flush=True)
    for tree in argv + argv[::-1]:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", tree,
                               str(reps)], capture_output=True, text=True, cwd=ROOT)
        if proc.returncode != 0:
            print(f"{tree}: exit {proc.returncode}\n{proc.stderr[-4000:]}", file=sys.stderr)
            return 1
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
