"""Aggregate chip-busy measurement for oversubscribed sharing, the
PyTorch port of ``workloads/busy_probe.py``.

Each participating pod runs compute bursts under the cooperative chip
lease (``lease.py``) and appends its busy/wall accounting to a shared
stats file; the aggregate busy fraction is the busy time summed over a
chip's pods divided by the union of their measured windows, averaged
over chips.  ``busy`` counts lease-held host time, as the JAX probe's
does: a burst that ends in a host readback holds the lease until the
device has finished, so the count cannot close early, but eager launches
can leave the device idle inside a burst that counts as busy.

The bursts are the JAX probe's: chained ``tanh(x @ x)`` on a bf16
matrix (``make_burst_fn``), training steps of the flagship model at a
tiny scale (``make_train_burst_fn``, with ``step.aot_compile`` outside
the lease) and full requests through the serving engine
(``make_serve_burst_fn``, whose decode steps run the paged-attention
kernel K1 on a CUDA device).  Everything runs on ``device``: ``cuda``
unless the caller asks for ``cpu``.

Run standalone (one process simulates one pod):

    python -m workloads_torch.busy_probe --duration 10 --report /path/stats.jsonl
    python -m workloads_torch.busy_probe --device cpu --duration 2
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from contextlib import nullcontext

import torch

from . import lease, resolve_device


def _calibrate_steps(
    run_n, target_burst_secs: float, n_lo: int = 1, n_hi: int = 4
) -> int:
    """Steps per burst so one burst runs ~target_burst_secs of device
    time.  Per-step seconds come from the repo's median-slope estimator
    (perfbench.measure_slope_secs): the constant dispatch+readback
    round-trip cancels in the slope and the median defeats its jitter,
    instead of being mistaken for step cost (which would shrink bursts
    until the device idles through a readback per lease hold)."""
    from .perfbench import measure_slope_secs

    def chain(n: int) -> float:
        run_n(n)
        return 0.0

    per_step = measure_slope_secs(
        chain, n_lo=n_lo, n_hi=n_hi, repeats=3, min_window_secs=0.1, max_n=64
    )
    # Floor and cap: a jitter-dominated slope can collapse to the
    # estimator's 1e-9 floor, and an uncapped division would size a burst
    # that holds the chip lease for hours.  1e-6 s/step is faster than
    # any real step (each includes at least a dispatch), and 100k steps
    # bounds one burst to ~target regardless.
    per_step = max(per_step, 1e-6)
    return min(max(int(target_burst_secs / per_step), 1), 100_000)


def make_burst_fn(
    matrix_dim: int = 1024,
    target_burst_secs: float = 1.0,
    timed_section=nullcontext,
    device=None,
):
    """A compute burst of chained bf16 matmuls: each step is eight
    ``tanh(x @ x)`` on a ``[matrix_dim, matrix_dim]`` matrix on
    ``device`` (None means ``cuda``).

    The step count is slope-calibrated so one burst runs
    ~target_burst_secs, long enough that lease-handoff overhead and the
    per-burst readback stay a small fraction of the duty cycle, short
    enough that siblings still interleave every second or so.  Only the
    calibration runs under ``timed_section`` (the chip lease)."""
    device = resolve_device(device)

    def chained(x):
        for _ in range(8):
            x = torch.tanh(x @ x)
        return x

    x = torch.ones((matrix_dim, matrix_dim), dtype=torch.bfloat16, device=device)

    # The host readback is the synchronization: the burst holds the
    # lease until the device has finished its last step.
    def run_n(n: int):
        result = x
        for _ in range(n):
            result = chained(result)
        float(result[0, 0])

    with timed_section():
        steps_per_burst = _calibrate_steps(run_n, target_burst_secs)

    def burst():
        run_n(steps_per_burst)

    return burst


def make_train_burst_fn(target_burst_secs: float = 1.0, timed_section=nullcontext,
                        device=None):
    """A compute burst that is useful work: full training steps of the
    flagship transformer at a tiny scale (forward, backward, AdamW) on
    ``device``, so the oversubscription harness can report aggregate
    tokens/s next to chip-busy occupancy.

    Returns (burst, tokens_per_burst).  ``step.aot_compile`` prepares
    the step outside the lease (no kernel run); only the calibration
    runs under ``timed_section``."""
    from .model import ModelConfig
    from .train import make_train_state, make_train_step, synthetic_batch

    device = resolve_device(device)
    config = ModelConfig(
        d_model=256, n_heads=4, n_layers=2, d_ff=1024, vocab_size=2048,
        max_seq_len=128,
    )
    batch = 8
    (params, opt_state), optimizer = make_train_state(config, device=device)
    step = make_train_step(config, optimizer)
    tokens = synthetic_batch(config, batch, device=device)
    compiled = step.aot_compile(params, opt_state, tokens)
    tokens_per_step = batch * (config.max_seq_len - 1)
    state = [params, opt_state]

    # float(loss) is the host readback that synchronizes.
    def run_n(n: int):
        loss = None
        for _ in range(n):
            state[0], state[1], loss = compiled(state[0], state[1], tokens)
        float(loss)

    with timed_section():
        steps_per_burst = _calibrate_steps(run_n, target_burst_secs)

    def burst():
        run_n(steps_per_burst)

    return burst, steps_per_burst * tokens_per_step


def make_serve_burst_fn(target_burst_secs: float = 1.0, timed_section=nullcontext,
                        device=None):
    """A compute burst that is serving work: full requests through the
    continuous-batching engine (``serve.ServeEngine``: paged KV cache,
    chunked decode through K1 on a CUDA device, top-k sampling) at a
    tiny scale on ``device``, so the harness can report aggregate
    generated tokens/s under time-slicing.

    Returns (burst, tokens_per_burst).  K1's library is loaded outside
    the lease; warming the engine executes a request (and captures its
    decode graph on a CUDA device), so it runs under ``timed_section``
    with the calibration, or a late-starting pod would compute unleased
    inside a sibling's measured window.  The prompt comes from a numpy
    seed (the JAX probe draws it with threefry, which torch lacks)."""
    import numpy as np

    from .model import ModelConfig, cast_params, init_params
    from .serve import ServeEngine

    device = resolve_device(device)
    config = ModelConfig(
        d_model=256, n_heads=4, n_layers=2, d_ff=1024, vocab_size=2048,
        max_seq_len=64,
    )
    params = cast_params(
        init_params(config, torch.Generator(device).manual_seed(0)), config.dtype
    )
    prompt = [int(t) for t in np.random.default_rng(1).integers(0, config.vocab_size, 16)]
    new_tokens = 32
    engine = ServeEngine(
        params, config, slots=2, page_size=8, prompt_bucket=16, chunk=8,
        temperature=0.8, top_k=50, generator=torch.Generator(device).manual_seed(2),
        device=device,
    )
    if device.type == "cuda":
        from .ops import _build

        _build.load("paged_attention")

    # engine.run() ends on host-side token readbacks: real syncs.
    def run_n(n: int):
        for _ in range(n):
            engine.submit(prompt, new_tokens)
        engine.run()

    with timed_section():
        engine.submit(prompt, new_tokens)
        engine.run()
        # Calibrate at multiples of the slot count: odd request counts
        # cost the same waves as the next multiple, which would bias the
        # slope ~1.5x low and oversize the burst.
        requests_per_burst = _calibrate_steps(
            run_n, target_burst_secs, n_lo=2, n_hi=8
        )

    def burst():
        run_n(requests_per_burst)

    return burst, requests_per_burst * (new_tokens)


def _start_barrier(barrier_dir: str, count: int, timeout_secs: float):
    """Gate the measured window on every sibling pod being READY (built
    + calibrated): without it, one pod's lease-held calibration lands
    inside another's measured window and reads as idle chip time.  Each
    pod drops a ready-file and polls for ``count``; a straggler past the
    timeout releases the barrier rather than wedging the harness (the
    caller keeps the timeout BELOW the harness's own wedge deadline so a
    crashed sibling surfaces as the failure, not its healthy peers).

    The directory must be FRESH PER RUN (the oversubscribe harness
    passes a subdirectory of its own mkdtemp): stale ready-files from a
    previous run would release the barrier early."""
    os.makedirs(barrier_dir, exist_ok=True)
    open(os.path.join(barrier_dir, f"ready-{os.getpid()}"), "w").close()
    deadline = time.monotonic() + timeout_secs
    while time.monotonic() < deadline:
        ready = [f for f in os.listdir(barrier_dir) if f.startswith("ready-")]
        if len(ready) >= count:
            return
        time.sleep(0.05)


def run_probe(
    duration_secs: float,
    report_path: str | None,
    matrix_dim: int = 1024,
    workload: str = "matmul",
    barrier_dir: str | None = None,
    barrier_count: int = 0,
    device=None,
) -> dict:
    """One pod's measured window on ``device`` (None means ``cuda``).
    workload="matmul" runs the occupancy burst; "train" runs flagship
    train steps and "serve" full serving-engine requests, both adding a
    ``tokens`` count to the row so the aggregate can report useful
    throughput.  With ``barrier_dir``/``barrier_count`` the measured
    window starts only after every sibling finished building and
    calibrating (see _start_barrier)."""
    lease.hold_claim_leases()  # mixed-strategy lifetime declaration
    if workload == "train":
        burst, tokens_per_burst = make_train_burst_fn(
            timed_section=lease.chip_lease, device=device
        )
    elif workload == "serve":
        burst, tokens_per_burst = make_serve_burst_fn(
            timed_section=lease.chip_lease, device=device
        )
    elif workload == "matmul":
        burst = make_burst_fn(matrix_dim=matrix_dim, timed_section=lease.chip_lease,
                              device=device)
        tokens_per_burst = 0
    else:
        raise ValueError(
            f"workload must be 'matmul', 'train' or 'serve', got {workload!r}"
        )
    if barrier_dir and barrier_count:
        # Stay under oversubscribe's wedge deadline (duration*10 + 300s).
        _start_barrier(
            barrier_dir, barrier_count,
            timeout_secs=duration_secs * 10 + 180,
        )
    stats = lease.run_leased_bursts(burst, duration_secs)
    stats.update(
        {
            "pid": os.getpid(),
            "chips": sorted(lease.chip_ids_from_env()),
            "busy_fraction": stats["busy_secs"] / max(stats["wall_secs"], 1e-9),
            "t_end": time.time(),
        }
    )
    if tokens_per_burst:
        stats["tokens"] = stats["bursts"] * tokens_per_burst
    if report_path:
        with open(report_path, "a") as f:
            f.write(json.dumps(stats) + "\n")
    return stats


def aggregate(report_path: str) -> dict:
    """Aggregate busy fraction across all pods that appended to the report.

    Bursts hold an exclusive per-chip lease, so sibling pods' busy intervals
    on one chip are disjoint: per-chip busy = sum of its pods' busy seconds,
    per-chip fraction = busy / the union wall window of the pods that used it,
    and the aggregate (the BASELINE north-star number) is the mean fraction
    over chips.  Rows without chip attribution keep the original single-chip
    semantics (one shared bucket) — but only when the whole report lacks it:
    mixing them with attributed rows would double-count a chip as a phantom
    extra bucket, so then they are left out of the per-chip fractions (still
    counted in pods/busy totals).
    """
    rows = []
    with open(report_path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    if not rows:
        return {"pods": 0, "aggregate_busy_fraction": 0.0}
    any_attributed = any(r.get("chips") for r in rows)
    per_chip: dict[str, list[dict]] = {}
    for r in rows:
        chips = r.get("chips") or ([] if any_attributed else [""])
        for chip in chips:
            per_chip.setdefault(chip, []).append(r)
    chip_fractions = {}
    for chip, chip_rows in per_chip.items():
        busy = sum(r["busy_secs"] for r in chip_rows)
        ends = [r.get("t_end") for r in chip_rows]
        if all(e is not None for e in ends):
            # True union of the pods' measurement intervals: a gap where no
            # pod was probing the chip is unmeasured, not idle.
            intervals = sorted(
                (e - r["wall_secs"], e) for e, r in zip(ends, chip_rows)
            )
            window = 0.0
            cur_start, cur_end = intervals[0]
            for start, end in intervals[1:]:
                if start > cur_end:
                    window += cur_end - cur_start
                    cur_start, cur_end = start, end
                else:
                    cur_end = max(cur_end, end)
            window += cur_end - cur_start
        else:
            window = max(r["wall_secs"] for r in chip_rows)
        chip_fractions[chip] = min(busy / max(window, 1e-9), 1.0)
    wall = max(r["wall_secs"] for r in rows)
    busy = sum(r["busy_secs"] for r in rows)
    out = {
        "pods": len(rows),
        "chips": len(per_chip),
        "wall_secs": wall,
        "busy_secs": busy,
        "per_chip_busy_fraction": chip_fractions,
        "aggregate_busy_fraction": sum(chip_fractions.values()) / len(chip_fractions),
    }
    tokens = sum(r.get("tokens", 0) for r in rows)
    if tokens:
        # Useful throughput under time-slicing: total tokens over the
        # longest pod window — the number occupancy alone can fake but
        # this cannot.
        out["tokens"] = tokens
        out["aggregate_tokens_per_sec"] = round(tokens / max(wall, 1e-9), 1)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="chip-busy probe")
    parser.add_argument("--duration", type=float, default=10.0)
    parser.add_argument("--report", default="")
    parser.add_argument("--matrix-dim", type=int, default=1024)
    parser.add_argument("--workload", default="matmul", choices=["matmul", "train", "serve"],
                        help="burst content: occupancy matmuls, flagship train "
                        "steps, or serving-engine requests ('train'/'serve' report tokens)")
    parser.add_argument("--barrier-dir", default="",
                        help="start-barrier directory shared by sibling pods")
    parser.add_argument("--barrier-count", type=int, default=0,
                        help="pods that must be ready before measuring")
    parser.add_argument("--aggregate", action="store_true",
                        help="aggregate an existing report instead of probing")
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; pass cpu for the plain path)")
    args = parser.parse_args(argv)
    if args.aggregate:
        print(json.dumps(aggregate(args.report)))
        return 0
    device = resolve_device(args.device)
    from .ops.paged_attention import paged_attention

    paged_attention.launches = 0
    stats = run_probe(
        args.duration, args.report or None, args.matrix_dim, args.workload,
        args.barrier_dir or None, args.barrier_count, device,
    )
    print(json.dumps(stats))
    # For the harness, which keeps each pod's stderr in a file.
    print(f"busy_probe: K1 launches {paged_attention.launches}", file=sys.stderr, flush=True)
    if device.type == "cuda":
        print(f"busy_probe: peak device memory {torch.cuda.max_memory_allocated(device)} "
              "bytes", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
