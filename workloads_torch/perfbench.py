"""The serving half of the perf bench, on the card.

The PyTorch port of ``workloads/perfbench.py``'s harness and its serving
arms: the continuous-batching engine at ``BenchScale.named("full")``
(d_model 2048, 16 heads, 8 layers, d_ff 8192, vocab 32768, bf16) timed
end to end, each decode step a replay of the engine's CUDA graph
through the paged-attention kernel.

    python -m workloads_torch.perfbench --scale full [--pool-with PREV.json]

prints one JSON object: the arms' keys, the card's ``device_name`` and
``power_limit_w`` (``nvidia-smi``), and the scale.  The committed
artifact ``docs/bench-torch-latest.json`` (``profiler.
load_committed_artifact``) is two such processes, the second run with
``--pool-with`` the first's output, so that each published ``_min`` /
``_max`` spans two processes.

Methodology, JAX's: a throughput arm times a whole drain after a warm
request (graph capture and first launches off the clock); two arms that
are compared run alternately (``_interleaved_repeats``) and publish the
median per-pair ratio with its spread; every arm that compares two
configurations asserts their token streams equal before publishing a
number.  ``measure_serve`` takes the two-point slope over chunk counts
(``measure_slope_secs``), so admission and capture constants cancel.

Not ported here: the training, flash-vs-dense, decode, fleet,
disaggregation, self-heal, autoscale, speculation, KV, scheduling and
durability arms, and ``device_peak_flops`` (its table is a TPU's).
Seeds: weights from ``torch.Generator`` seed 0 (JAX's ``PRNGKey(0)``),
prompts from numpy seeds (JAX's ``PRNGKey(n)``), samplers from
``generator=`` seed 3 (JAX's ``rng=``).  Entry points run on the card
unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from . import resolve_device
from .model import ModelConfig, cast_params, init_params


def measure_slope_samples(
    run_chain,
    n_lo: int,
    n_hi: int,
    repeats: int = 3,
    min_window_secs: float = 0.25,
    max_n: int = 4096,
) -> tuple[float, list[float]]:
    """measure_slope_secs, additionally returning the per-repeat slope
    SAMPLES (floored at 1e-9 like the median) — callers pair two arms'
    samples index-for-index into per-repeat ratios, which persist in the
    bench artifact so the next run can pool a cross-process spread."""
    import statistics

    while True:
        run_chain(n_lo)  # warm: first launches, graph capture
        run_chain(n_hi)
        slopes, windows = [], []
        for _ in range(repeats):
            t0 = time.perf_counter()
            run_chain(n_lo)
            t_lo = time.perf_counter() - t0
            t0 = time.perf_counter()
            run_chain(n_hi)
            t_hi = time.perf_counter() - t0
            slopes.append((t_hi - t_lo) / (n_hi - n_lo))
            windows.append(t_hi - t_lo)
        if statistics.median(windows) >= min_window_secs or n_hi >= max_n:
            samples = [max(s, 1e-9) for s in slopes]
            return max(statistics.median(slopes), 1e-9), samples
        n_lo, n_hi = n_lo * 2, n_hi * 2


def measure_slope_secs(
    run_chain,
    n_lo: int,
    n_hi: int,
    repeats: int = 3,
    min_window_secs: float = 0.25,
    max_n: int = 4096,
) -> float:
    """Per-iteration seconds of ``run_chain(n)`` (which must execute n
    data-dependent iterations ending in one host readback), via the
    two-point slope: the constant (dispatch, readback, set-up) cancels.

    The estimate is the MEDIAN slope over ``repeats`` interleaved lo/hi
    pairs, and the chain lengths double until the median (t_hi - t_lo)
    window dwarfs the host's jitter.  Each (n_lo, n_hi) pair is warmed
    untimed first so one-time work never lands inside a timed window."""
    return measure_slope_samples(
        run_chain, n_lo, n_hi, repeats, min_window_secs, max_n
    )[0]


@dataclass(frozen=True)
class BenchScale:
    """Shape set for the perf bench; ``full`` is the repo's widest model
    (536.9M parameters, bf16), ``tiny`` exists so the harness itself is
    testable on the CPU.  The spec fields are JAX's, kept for the
    speculation arms still to port.  ``dtype`` is the port's: ``tiny``
    computes in float32, where a speculative and a plain step give the
    same greedy tokens, so that a spec="auto" calibration verdict timed
    on a loaded CPU cannot part the streams its arms compare."""

    d_model: int
    n_heads: int
    n_layers: int
    d_ff: int
    vocab: int
    seq: int
    batch: int
    attn_heads: int
    attn_seqs: tuple[int, ...]
    decode_prompt: int
    decode_lens: tuple[int, int]
    page_size: int
    serve_chunks: tuple[int, int]
    spec_phase_batches: tuple[int, ...]
    spec_engine_ks: tuple[int, ...]
    dtype: torch.dtype = torch.bfloat16

    @classmethod
    def named(cls, name: str) -> "BenchScale":
        if name == "full":
            return cls(
                d_model=2048, n_heads=16, n_layers=8, d_ff=8192, vocab=32768,
                seq=2048, batch=8, attn_heads=8,
                attn_seqs=(1024, 2048, 4096), decode_prompt=32,
                decode_lens=(64, 512), page_size=64, serve_chunks=(1, 8),
                spec_phase_batches=(1, 2, 4, 8),
                spec_engine_ks=(8, 16, 32),
            )
        if name == "tiny":
            return cls(
                d_model=64, n_heads=4, n_layers=2, d_ff=128, vocab=256,
                seq=128, batch=2, attn_heads=2,
                attn_seqs=(128,), decode_prompt=4, decode_lens=(4, 12),
                page_size=4, serve_chunks=(1, 3),
                spec_phase_batches=(1, 2), spec_engine_ks=(2,),
                dtype=torch.float32,
            )
        raise ValueError(f"unknown bench scale {name!r} (full|tiny)")


def derive_breakeven(batches: list[int], ratios: list[float]) -> float:
    """The measured break-even batch from per-batch spec/plain ratios:
    the occupancy at which speculation's tokens/sec crosses the plain
    path's, log2-interpolated between the last winning and first losing
    batch.  All batches winning reports the largest measured batch (a
    ">= max" floor, not a claim beyond the sweep); none winning reports
    0 (never speculate)."""
    import math

    if ratios[0] < 1.0:
        return 0.0
    if all(r >= 1.0 for r in ratios):
        return float(batches[-1])
    j = next(
        i for i in range(len(batches) - 1)
        if ratios[i] >= 1.0 and ratios[i + 1] < 1.0
    )
    x0, x1 = math.log2(batches[j]), math.log2(batches[j + 1])
    t = (ratios[j] - 1.0) / (ratios[j] - ratios[j + 1])
    return round(2 ** (x0 + t * (x1 - x0)), 2)


def _config(scale: BenchScale, max_seq_len: int) -> ModelConfig:
    return ModelConfig(
        vocab_size=scale.vocab, d_model=scale.d_model, n_heads=scale.n_heads,
        n_layers=scale.n_layers, d_ff=scale.d_ff, max_seq_len=max_seq_len,
        dtype=scale.dtype,
    )


def _params(config: ModelConfig, seed: int, device) -> dict:
    """Random weights from ``seed`` in the config's dtype, on ``device``."""
    return cast_params(
        init_params(config, torch.Generator(device).manual_seed(seed)),
        config.dtype,
    )


def _prompt(seed: int, length: int, vocab: int) -> list[int]:
    return [int(t) for t in np.random.default_rng(seed).integers(0, vocab, length)]


def _sampler(seed: int, device) -> torch.Generator:
    return torch.Generator(device).manual_seed(seed)


def measure_serve(scale: BenchScale, device=None) -> dict:
    """The COMPOSED serving path on the card: the continuous-batching
    engine end-to-end — paged pools, the paged-attention kernel, int8
    weight-only bases, temperature/top-k/top-p sampling, per-chunk host
    readbacks and page accounting included.  Slope over chunk counts, so
    admission/prefill/capture constants cancel and what remains is the
    sustained serve loop."""
    from .quant import quantize_params
    from .serve import ServeEngine

    device = resolve_device(device)
    batch, ps = scale.batch, scale.page_size
    chunk = ps
    lo, hi = scale.serve_chunks
    prompt_len = scale.decode_prompt
    config = _config(scale, prompt_len + 1 + hi * chunk)
    params = quantize_params(_params(config, 0, device))
    prompt = _prompt(1, prompt_len, config.vocab_size)
    peak_fraction = [0.0]

    def run_chunks(n_chunks: int) -> float:
        engine = ServeEngine(
            params, config, slots=batch, page_size=ps, chunk=chunk,
            # Page-aligned bucket covering the prompt.
            prompt_bucket=-(-prompt_len // ps) * ps,
            temperature=0.8, top_k=50, top_p=0.95,
            generator=_sampler(3, device),
            # Pipelined stepping: each chunk's readback overlaps the
            # next chunk's compute.
            pipelined=True, device=device,
        )
        for _ in range(batch):
            engine.submit(prompt, 1 + n_chunks * chunk)
        engine.run()
        peak_fraction[0] = engine.ctrl.peak_used / engine.ctrl.n_pages
        return float(engine.generated_tokens)

    secs_per_chunk = measure_slope_secs(
        run_chunks, n_lo=lo, n_hi=hi, min_window_secs=0.0, max_n=hi
    )
    per_token = secs_per_chunk / chunk
    tokens_per_sec = batch / per_token
    request_tokens = 1 + hi * chunk
    return {
        "serve_tokens_per_sec": round(tokens_per_sec, 1),
        "serve_requests_per_sec": round(tokens_per_sec / request_tokens, 3),
        "serve_request_tokens": request_tokens,
        "serve_pool_peak_fraction": round(peak_fraction[0], 4),
    }


def _interleaved_repeats(arm_a, arm_b, repeats: int = 3):
    """Run two measurement arms ROUND-ROBIN ``repeats`` times and return
    (a_samples, b_samples): back-to-back pairs under the same host
    drift.  Callers pair the samples into per-repeat ratios in whichever
    orientation their metric reads and publish the median with min/max
    spread."""
    a_s, b_s = [], []
    for _ in range(repeats):
        a_s.append(arm_a())
        b_s.append(arm_b())
    return a_s, b_s


def _pctl(samples: list[float], q: float) -> float:
    """Ceil-rank percentile: the smallest value with >= q of the mass at
    or below it."""
    import math

    ordered = sorted(samples)
    rank = min(len(ordered) - 1, math.ceil(q * len(ordered)) - 1)
    return ordered[rank]


def measure_serve_latency(scale: BenchScale, device=None) -> dict:
    """TTFT and end-to-end latency distribution through the SAME composed
    engine configuration measure_serve times for throughput — int8 base,
    sampling knobs, pipelined stepping — under a backpressured mixed
    stream (3x slots requests, all submitted up front): later waves
    queue behind earlier ones, so admission wait lands IN the TTFT tail
    exactly as a client would see it.  Host-side stamps come from the
    engine's own Request telemetry (submit / first observed token /
    retirement)."""
    from .quant import quantize_params
    from .serve import ServeEngine

    device = resolve_device(device)
    batch, ps = scale.batch, scale.page_size
    chunk = ps
    lo, hi = scale.serve_chunks
    prompt_len = scale.decode_prompt
    config = _config(scale, prompt_len + 1 + hi * chunk)
    params = quantize_params(_params(config, 0, device))
    prompt = _prompt(1, prompt_len, config.vocab_size)
    engine = ServeEngine(
        params, config, slots=batch, page_size=ps, chunk=chunk,
        prompt_bucket=-(-prompt_len // ps) * ps,
        temperature=0.8, top_k=50, top_p=0.95, generator=_sampler(3, device),
        pipelined=True, device=device,
    )
    engine.submit(prompt, 1 + hi * chunk)  # warm: capture, first launches
    engine.run()
    engine.drain_completed()
    n_req = 3 * batch
    for i in range(n_req):
        # Mixed generation lengths: the stream continuous batching is for.
        engine.submit(prompt, 1 + chunk * (1 + i % hi))
    engine.run()
    done = engine.drain_completed()
    ttfts = [r.ttft_secs * 1000 for r in done]
    e2es = [r.e2e_secs * 1000 for r in done]
    # Queue-wait percentiles (submission -> admission): the slice of the
    # TTFT tail that is BACKPRESSURE, not prefill.
    qwaits = [
        r.queue_wait_secs * 1000
        for r in done if r.queue_wait_secs is not None
    ]
    if len(ttfts) != n_req:
        raise RuntimeError(
            f"serve latency bench drained {len(ttfts)} finished requests, "
            f"expected {n_req} — the engine lost or duplicated requests"
        )
    return {
        "serve_latency_requests": n_req,
        "serve_ttft_p50_ms": round(_pctl(ttfts, 0.50), 2),
        "serve_ttft_p99_ms": round(_pctl(ttfts, 0.99), 2),
        "serve_e2e_p50_ms": round(_pctl(e2es, 0.50), 2),
        "serve_e2e_p99_ms": round(_pctl(e2es, 0.99), 2),
        "serve_queue_wait_p50_ms": round(_pctl(qwaits, 0.50), 2),
        "serve_queue_wait_p99_ms": round(_pctl(qwaits, 0.99), 2),
    }


def measure_interleave(scale: BenchScale, device=None) -> dict:
    """Chunked-prefill / decode interleaving economics: a mixed OPEN-LOOP
    stream — long prompts whose multi-chunk prefill sweeps
    head-of-line-block every occupied decode slot, with short prompts
    queued between them — served by the same engine shape twice:
    ``prefill_budget=None`` vs a one-bucket budget.  Interleaved
    repeats; published:

      - ``interleave_ttft_p99_ratio``: budgeted/unbudgeted SHORT-prompt
        TTFT p99 (median per-pair ratio with min/max; < 1.0 = the
        budget removed the long-prefill stalls from the tail),
      - ``interleave_decode_dip_pct``: the budgeted engine's decode
        token rate during prefill-burdened steps vs pure-decode steps,
      - ``interleave_budget_sweep``: {budget tokens/step: short TTFT
        p99 ms} across budgets (single-shot per budget).

    Greedy streams are asserted identical budgeted vs not — a latency
    win that changed tokens would be a lie."""
    import statistics

    from .serve import ServeEngine

    device = resolve_device(device)
    batch, ps = scale.batch, scale.page_size
    chunk = ps
    bucket = 2 * ps
    long_len, short_len = 6 * bucket, ps
    config = _config(scale, long_len + 1 + 2 * chunk)
    params = _params(config, 0, device)
    long_prompt = _prompt(1, long_len, config.vocab_size)
    short_prompt = _prompt(2, short_len, config.vocab_size)
    n_req = 4 * batch

    def serve(budget):
        engine = ServeEngine(
            params, config, slots=batch, page_size=ps, chunk=chunk,
            prompt_bucket=bucket, pipelined=True, prefill_budget=budget,
            device=device,
        )
        engine.submit(long_prompt, 1 + chunk)  # warm every shape
        engine.submit(short_prompt, 1 + 2 * chunk)
        engine.run()
        engine.drain_completed()
        shorts = []
        for i in range(n_req):
            # Every 4th request is a long prompt landing mid-stream —
            # the head-of-line blocker the budget exists to defuse.
            if i % 4 == 1:
                engine.submit(long_prompt, 1 + chunk)
            else:
                shorts.append(engine.submit(short_prompt, 1 + 2 * chunk))
        steps = []
        while not engine.idle:
            tok0 = engine.generated_tokens
            pd0 = engine.prefill_dispatches
            ch0 = engine.chunks_run
            t0 = time.perf_counter()
            retired = engine.step()
            # DECODE tokens only: each finished admission emits exactly
            # one fused first token, which is prefill output, not decode
            # rate; count first tokens by their t_first stamp landing
            # inside THIS step.
            firsts = sum(
                1
                for r in list(engine._slot_req.values()) + retired
                if r.t_first is not None and r.t_first >= t0
            )
            steps.append((
                (engine.generated_tokens - tok0) - firsts,
                engine.prefill_dispatches - pd0,
                engine.chunks_run - ch0,
            ))
        done = {r.rid: r for r in engine.drain_completed()}
        ttfts = [done[r].ttft_secs * 1000 for r in shorts]
        streams = {rid: list(done[rid].tokens) for rid in done}
        return _pctl(ttfts, 0.99), steps, streams

    budget = bucket  # one chunk per step: the headline budget

    def _assert_parity(streams, streams_off, label):
        if streams != streams_off:
            raise RuntimeError(
                f"interleave bench: {label} token streams diverged "
                "from unbudgeted — the latency numbers would be "
                "comparing different work"
            )

    off_s, on_s = [], []
    streams_off = None
    for rep in range(3):
        p99_off, _, streams_off = serve(None)
        p99_on, steps_on, streams_on = serve(budget)
        # EVERY repeat is parity-pinned, not just the last.
        _assert_parity(streams_on, streams_off, f"budgeted (rep {rep})")
        off_s.append(p99_off)
        on_s.append(p99_on)
    ratios = [
        round(on / max(off, 1e-9), 3) for on, off in zip(on_s, off_s)
    ]
    # Decode dip from the last budgeted run: decode-token rate of steps
    # where a decode chunk ACTUALLY dispatched alongside prefill work,
    # vs steps that were pure decode; prefill-only steps are excluded
    # from both sides.
    burdened = [t for t, pd, ch in steps_on if pd > 0 and ch > 0]
    pure = [t for t, pd, ch in steps_on if pd == 0 and ch > 0]
    dip_pct = None
    if burdened and pure:
        dip_pct = round(
            (1.0 - (statistics.mean(burdened) / statistics.mean(pure)))
            * 100.0, 1,
        )
    # The headline budget equals ``bucket`` — its sweep point reuses the
    # three measurements above.
    sweep = {str(bucket): round(statistics.median(on_s), 2)}
    for b in (2 * bucket, 4 * bucket):
        p99_b, _, streams_b = serve(b)
        _assert_parity(streams_b, streams_off, f"budget {b}")
        sweep[str(b)] = round(p99_b, 2)
    return {
        "interleave_requests": n_req,
        "interleave_prefill_budget": budget,
        "interleave_long_prompt_tokens": long_len,
        "interleave_ttft_p99_ratio": round(statistics.median(ratios), 3),
        "interleave_ttft_p99_ratio_min": round(min(ratios), 3),
        "interleave_ttft_p99_ratio_max": round(max(ratios), 3),
        "interleave_short_ttft_p99_ms_budgeted": round(
            statistics.median(on_s), 2
        ),
        "interleave_short_ttft_p99_ms_unbudgeted": round(
            statistics.median(off_s), 2
        ),
        "interleave_decode_dip_pct": dip_pct,
        "interleave_budget_sweep": sweep,
    }


def measure_superstep(scale: BenchScale, device=None) -> dict:
    """Decode supersteps (``ServeEngine(superstep_k=k)``: k chained decode
    chunks per dispatch): sweep k over the SAME greedy request stream
    and measure what amortizing the per-chunk host round-trip buys.

    Every swept run's streams are asserted BIT-IDENTICAL to the k=1
    oracle before any number is published.  Repeats run round-robin
    across the k values so host drift hits every arm equally, and every
    TIMED arm runs bare — a separate UNTIMED observer-instrumented k=1
    pass yields ``decode_host_sync_ms`` (the median per-decode-step
    host-sync stall supersteps exist to divide by k).  The best-k arm
    reports its over-decode percentage (dead device steps past
    retirement vs tokens emitted)."""
    import statistics

    from .obs import EngineObserver
    from .serve import ServeEngine

    device = resolve_device(device)
    ps = scale.page_size
    chunk = ps
    batch = min(4, scale.batch)
    prompt_len = scale.decode_prompt
    ks = [1, 2, 4, 8]
    # Several supersteps per request at the deepest k, so steady-state
    # dominates the window; +3 keeps retirement OFF the superstep
    # boundary and exercises the over-decode reconciliation.
    max_new = ks[-1] * chunk * 2 + 3
    config = _config(scale, prompt_len + max_new)
    params = _params(config, 0, device)
    prompt = _prompt(11, prompt_len, config.vocab_size)
    n_req = 2 * batch
    overdecode = {}

    def serve(k: int, observer=None):
        engine = ServeEngine(
            params, config, slots=batch, page_size=ps, chunk=chunk,
            prompt_bucket=-(-prompt_len // ps) * ps, superstep_k=k,
            observer=observer, device=device,
        )
        engine.submit(prompt, max_new)  # warm at full depth
        engine.run()
        engine.drain_completed()
        if observer is not None:
            observer.drain_steps()
        before = engine.generated_tokens
        over0 = engine.tokens_overdecoded
        t0 = time.perf_counter()
        for _ in range(n_req):
            engine.submit(prompt, max_new)
        streams = engine.run()
        rate = (engine.generated_tokens - before) / (
            time.perf_counter() - t0
        )
        overdecode[k] = (
            engine.tokens_overdecoded - over0,
            engine.generated_tokens - before,
        )
        return rate, streams

    def check_oracle(streams, oracle, k):
        if streams != oracle:
            raise RuntimeError(
                f"superstep k={k} streams diverged from the k=1 "
                "greedy oracle — a throughput sweep over different "
                "tokens is meaningless"
            )

    oracle = None
    rates: dict[int, list[float]] = {k: [] for k in ks}
    for _ in range(3):
        for k in ks:
            rate, streams = serve(k)
            if oracle is None:
                oracle = streams
            else:
                check_oracle(streams, oracle, k)
            rates[k].append(rate)
    # The per-decode-step host-sync stall, from a SEPARATE untimed
    # instrumented k=1 pass (the StepRecord.host_sync_ms telemetry).
    obs = EngineObserver()
    _, streams = serve(1, observer=obs)
    check_oracle(streams, oracle, 1)
    decode_syncs = [
        r.host_sync_ms for r in obs.drain_steps() if r.decode_dispatches
    ]
    medians = {k: statistics.median(rates[k]) for k in ks}
    best_k = max(ks, key=lambda k: medians[k])
    over, emitted = overdecode[best_k]
    out = {
        "superstep_ks": ks,
        "superstep_requests": n_req,
        "superstep_best_k": best_k,
        "superstep_tokens_per_sec": round(medians[best_k], 1),
        "superstep_speedup": round(medians[best_k] / medians[1], 3),
        "superstep_overdecode_pct": round(
            100.0 * over / max(over + emitted, 1), 2
        ),
        # Best-k per-repeat samples: run() pools them with the prior
        # artifact's via _publish_ratio_spread.
        "superstep_tokens_per_sec_samples": [
            round(s, 1) for s in rates[best_k]
        ],
    }
    for k in ks:
        out[f"superstep_tokens_per_sec_k{k}"] = round(medians[k], 1)
    if decode_syncs:
        out["decode_host_sync_ms"] = round(
            statistics.median(decode_syncs), 3
        )
    return out


def measure_obs_overhead(scale: BenchScale, device=None) -> dict:
    """Observability must be provably cheap: the SAME composed serve
    stream measure_serve times (int8 base, sampling knobs, pipelined
    stepping) runs observer-OFF vs observer-ON — the full treatment:
    step/span rings AND the Prometheus bridge pushing into a live
    Registry.  Interleaved repeats; the published ``obs_overhead_pct``
    is the median per-pair throughput loss percentage with min/max
    spread (negative = noise floor)."""
    import statistics

    from tpu_device_plugin.metrics import Registry

    from .obs import EngineObserver
    from .quant import quantize_params
    from .serve import ServeEngine

    device = resolve_device(device)
    batch, ps = scale.batch, scale.page_size
    chunk = ps
    hi = scale.serve_chunks[1]
    prompt_len = scale.decode_prompt
    config = _config(scale, prompt_len + 1 + hi * chunk)
    params = quantize_params(_params(config, 0, device))
    prompt = _prompt(1, prompt_len, config.vocab_size)
    n_req = 3 * batch

    def serve(observed: bool) -> float:
        obs = None
        if observed:
            obs = EngineObserver()
            obs.bind_registry(Registry())
        engine = ServeEngine(
            params, config, slots=batch, page_size=ps, chunk=chunk,
            prompt_bucket=-(-prompt_len // ps) * ps,
            temperature=0.8, top_k=50, top_p=0.95,
            generator=_sampler(3, device), pipelined=True, observer=obs,
            device=device,
        )
        engine.submit(prompt, 1 + hi * chunk)  # warm: capture, launches
        engine.run()
        before = engine.generated_tokens
        t0 = time.perf_counter()
        for i in range(n_req):
            engine.submit(prompt, 1 + chunk * (1 + i % hi))
        engine.run()
        return (engine.generated_tokens - before) / (
            time.perf_counter() - t0
        )

    off_s, on_s = _interleaved_repeats(
        lambda: serve(False), lambda: serve(True)
    )
    overheads = [
        (off - on) / max(off, 1e-9) * 100.0 for off, on in zip(off_s, on_s)
    ]
    return {
        "obs_overhead_pct": round(statistics.median(overheads), 2),
        "obs_overhead_pct_min": round(min(overheads), 2),
        "obs_overhead_pct_max": round(max(overheads), 2),
        "obs_on_tokens_per_sec": round(statistics.median(on_s), 1),
        "obs_off_tokens_per_sec": round(statistics.median(off_s), 1),
        "obs_requests": n_req,
    }


def measure_profiler(scale: BenchScale, device=None) -> dict:
    """The device-time profiling layer must be provably cheap and
    provably inert: the measure_obs_overhead stream runs profiler-OFF
    (bare engine) vs profiler-ON — the FULL treatment: an observer with
    a live ``DeviceTimeTable`` feeding ``StepRecord.device_ms``, the
    Prometheus bridge pushing the ``engine_device_seconds`` family into
    a live Registry, and a ``RegressionSentry`` fed windowed signals
    through a ``SentryFeed`` poll per step.  Every interleaved pair's
    token streams are asserted bit-identical; the published
    ``profiler_overhead_pct`` is the median per-pair throughput loss.
    The ON run also publishes the headline device split —
    ``device_busy_fraction`` / ``host_stall_fraction`` — and its
    calibration table (``profiler_device_time_table``), the artifact
    payload ``DeviceTimeTable.refresh_from_artifact`` and the live
    sentry baseline against."""
    import statistics

    from tpu_device_plugin.metrics import Registry

    from .obs import EngineObserver
    from .profiler import DeviceTimeTable, RegressionSentry, SentryFeed
    from .quant import quantize_params
    from .serve import ServeEngine

    device = resolve_device(device)
    batch, ps = scale.batch, scale.page_size
    chunk = ps
    hi = scale.serve_chunks[1]
    prompt_len = scale.decode_prompt
    config = _config(scale, prompt_len + 1 + hi * chunk)
    params = quantize_params(_params(config, 0, device))
    prompt = _prompt(1, prompt_len, config.vocab_size)
    # A longer timed stream than the other overhead arms: the layer's
    # per-step cost is near the noise floor, so the ratio needs more
    # timed steps per pair before the median stops chasing host drift.
    n_req = 8 * batch

    def serve(profiled: bool):
        obs = feed = None
        if profiled:
            obs = EngineObserver(device_table=DeviceTimeTable())
            obs.bind_registry(Registry())
            sentry = RegressionSentry()
            # Self-baselining watches (no recorder attached): the arm
            # prices the detector arithmetic, not incident handling.
            for name, direction in (
                ("tokens_per_sec", "down_bad"),
                ("host_sync_ms", "up_bad"),
                ("device_busy_fraction", "down_bad"),
            ):
                sentry.watch(name, None, 0.25, direction=direction)
            # Production cadence: polled every step, with the feed's
            # own windowing deciding when a full extraction runs.
            feed = SentryFeed(sentry)
        engine = ServeEngine(
            params, config, slots=batch, page_size=ps, chunk=chunk,
            prompt_bucket=-(-prompt_len // ps) * ps,
            temperature=0.8, top_k=50, top_p=0.95,
            generator=_sampler(3, device), pipelined=True, observer=obs,
            device=device,
        )
        if feed is not None:
            feed.attach(engine, obs)
        engine.submit(prompt, 1 + hi * chunk)  # warm: capture, launches
        engine.run()
        before = engine.generated_tokens
        rids = []
        t0 = time.perf_counter()
        for i in range(n_req):
            rids.append(engine.submit(prompt, 1 + chunk * (1 + i % hi)))
        # Drive by stepping (not run()) so the ON arm pays the sentry
        # feed at the production cadence — one poll per step.
        results = {}
        while not engine.idle:
            for req in engine.step():
                results[req.rid] = req.tokens
            if feed is not None:
                feed.poll()
        rate = (engine.generated_tokens - before) / (
            time.perf_counter() - t0
        )
        return rate, [list(results[r]) for r in rids], obs

    # 7 interleaved pairs (vs the default 3): the layer's true cost sits
    # near the noise floor.
    off_runs, on_runs = _interleaved_repeats(
        lambda: serve(False), lambda: serve(True), repeats=7
    )
    for (_, off_stream, _), (_, on_stream, _) in zip(off_runs, on_runs):
        if off_stream != on_stream:
            raise RuntimeError("token streams diverged profiler on/off")
    overheads = [
        (off - on) / max(off, 1e-9) * 100.0
        for (off, *_), (on, *_) in zip(off_runs, on_runs)
    ]
    obs = on_runs[-1][2]
    busy = obs.device_busy_fraction
    return {
        "profiler_overhead_pct": round(statistics.median(overheads), 2),
        "profiler_overhead_pct_min": round(min(overheads), 2),
        "profiler_overhead_pct_max": round(max(overheads), 2),
        "profiler_on_tokens_per_sec": round(
            statistics.median(r for r, *_ in on_runs), 1
        ),
        "profiler_off_tokens_per_sec": round(
            statistics.median(r for r, *_ in off_runs), 1
        ),
        "profiler_requests": n_req,
        "device_busy_fraction": round(busy, 4),
        "host_stall_fraction": round(1.0 - busy, 4),
        "profiler_device_time_table": obs.device_table.to_dict(),
    }


def measure_ledger(scale: BenchScale, device=None) -> dict:
    """The chip-time ledger must be provably cheap AND its books must
    describe a messy run exactly: a seeded mixed-length greedy stream
    with SPECULATION on (an int8 self-draft) and two scheduled seam
    faults (a spec dispatch and a prefill dispatch quarantine -> replay)
    runs ledger-OFF vs ledger-ON in interleaved repeats, every pair's
    token streams asserted bit-identical.  Published:
    ``ledger_overhead_pct`` (median per-pair throughput loss, min/max
    spread), ``ledger_goodput_fraction`` and the replay / spec-rejected
    waste shares of all charged device work.  Reconciliation (goodput +
    waste == tokens accounted, nothing pending) is asserted on every
    armed run."""
    import statistics

    from .faults import FaultInjector
    from .ledger import ChipTimeLedger
    from .quant import quantize_params
    from .serve import ServeEngine

    device = resolve_device(device)
    batch, ps = scale.batch, scale.page_size
    chunk = ps
    hi = scale.serve_chunks[1]
    prompt_len = scale.decode_prompt
    config = _config(scale, prompt_len + 1 + hi * chunk)
    params = _params(config, 0, device)
    draft = quantize_params(params)
    prompt = _prompt(1, prompt_len, config.vocab_size)
    n_req = 3 * batch

    def serve(ledgered: bool):
        led = ChipTimeLedger() if ledgered else None
        # Identical schedules both arms: the quarantine/replay path is
        # part of the measured stream, not a difference between arms.
        injector = FaultInjector(
            {"spec_dispatch": [4], "prefill_dispatch": [3]}
        )
        engine = ServeEngine(
            params, config, slots=batch, page_size=ps, chunk=chunk,
            prompt_bucket=-(-prompt_len // ps) * ps,
            draft_params=draft, draft_config=config, gamma=4,
            generator=_sampler(3, device), pipelined=True,
            fault_injector=injector, max_retries=4, ledger=led,
            device=device,
        )
        engine.submit(prompt, 1 + hi * chunk)  # warm: capture, launches
        engine.run()
        before = engine.generated_tokens
        rids = []
        t0 = time.perf_counter()
        for i in range(n_req):
            rids.append(
                engine.submit(prompt, 1 + chunk * (1 + i % hi))
            )
        out = engine.run()
        rate = (engine.generated_tokens - before) / (
            time.perf_counter() - t0
        )
        streams = [list(out[r]) for r in rids]
        if engine.steps_quarantined < 1:
            raise RuntimeError(
                "the scheduled faults must actually exercise the replay "
                "accounting"
            )
        if led is not None:
            verdict = led.reconcile(expect_quiescent=True)
            if not verdict["ok"]:
                raise RuntimeError(f"ledger does not reconcile: {verdict}")
        return rate, streams, led, engine.steps_quarantined

    off_runs, on_runs = _interleaved_repeats(
        lambda: serve(False), lambda: serve(True)
    )
    for (_, off_stream, *_), (_, on_stream, *_) in zip(off_runs, on_runs):
        if off_stream != on_stream:
            raise RuntimeError("token streams diverged ledger on/off")
    overheads = [
        (off - on) / max(off, 1e-9) * 100.0
        for (off, *_), (on, *_) in zip(off_runs, on_runs)
    ]
    led = on_runs[-1][2]
    accounted = max(led.tokens_accounted, 1)
    return {
        "ledger_overhead_pct": round(statistics.median(overheads), 2),
        "ledger_overhead_pct_min": round(min(overheads), 2),
        "ledger_overhead_pct_max": round(max(overheads), 2),
        "ledger_on_tokens_per_sec": round(
            statistics.median(r for r, *_ in on_runs), 1
        ),
        "ledger_off_tokens_per_sec": round(
            statistics.median(r for r, *_ in off_runs), 1
        ),
        "ledger_goodput_fraction": round(led.goodput_fraction, 4),
        "ledger_busy_fraction": round(led.busy_fraction, 4),
        "ledger_waste_replay_pct": round(
            led.waste_tokens["replay"] / accounted * 100.0, 2
        ),
        "ledger_waste_spec_rejected_pct": round(
            led.waste_tokens["spec_rejected"] / accounted * 100.0, 2
        ),
        "ledger_waste_overdecode_pct": round(
            led.waste_tokens["overdecode"] / accounted * 100.0, 2
        ),
        "ledger_requests": n_req,
        "ledger_quarantines": on_runs[-1][3],
    }


def measure_admission(scale: BenchScale, device=None) -> dict:
    """Admission throughput: serial (one batch-1 prefill dispatch + one
    first-token readback PER admitted request) vs BATCHED (one multi-row
    prefill sweep + one fused readback per step).

    Every request uses max_new_tokens=1, so each engine step is pure
    admission work (prefill + first token + retirement).  Both arms
    repeat interleaved and the speedup is the median of back-to-back
    pairs with min/max spread; dispatches-per-admitted-request comes
    from the engine's own telemetry, so the structural claim (R
    admissions -> 1 sweep, 1 readback) is reported alongside the
    wall-clock one."""
    import statistics

    from .serve import ServeEngine

    device = resolve_device(device)
    ps = scale.page_size
    prompt_len = scale.decode_prompt
    slots = max(8, scale.batch)  # R >= 4 concurrent admissions (8 here)
    waves = 4
    n_req = waves * slots
    config = _config(scale, -(-(prompt_len + 1 + ps) // ps) * ps)
    params = _params(config, 0, device)
    prompts = [
        _prompt(100 + i, prompt_len, config.vocab_size) for i in range(n_req)
    ]
    stats = {}

    def serve(batched: bool) -> float:
        engine = ServeEngine(
            params, config, slots=slots, page_size=ps,
            prompt_bucket=-(-prompt_len // ps) * ps,
            batched_admission=batched, device=device,
        )
        engine.submit(prompts[0], 1)  # warm: first launches
        engine.run()
        tokens0 = engine.prefill_tokens
        d0, r0 = engine.prefill_dispatches, engine.admission_readbacks
        t0 = time.perf_counter()
        for p in prompts:
            engine.submit(p, 1)
        engine.run()
        secs = time.perf_counter() - t0
        stats[batched] = {
            "dispatches": (engine.prefill_dispatches - d0) / n_req,
            "readbacks": (engine.admission_readbacks - r0) / n_req,
        }
        return (engine.prefill_tokens - tokens0) / secs

    serial_s, batched_s = _interleaved_repeats(
        lambda: serve(False), lambda: serve(True)
    )
    ratios = [b / max(s, 1e-9) for s, b in zip(serial_s, batched_s)]
    return {
        "admission_requests": n_req,
        "admission_slots": slots,
        "admission_prompt_tokens": prompt_len,
        "admission_tokens_per_sec_serial": round(
            statistics.median(serial_s), 1
        ),
        "admission_tokens_per_sec": round(statistics.median(batched_s), 1),
        "admission_speedup": round(statistics.median(ratios), 3),
        "admission_speedup_min": round(min(ratios), 3),
        "admission_speedup_max": round(max(ratios), 3),
        # The structural win, from engine telemetry: serial pays one
        # dispatch and one readback per admitted request; batched pays
        # ~1/slots of each.
        "admission_dispatches_per_request_serial": round(
            stats[False]["dispatches"], 3
        ),
        "admission_dispatches_per_request": round(
            stats[True]["dispatches"], 3
        ),
        "admission_readbacks_per_request_serial": round(
            stats[False]["readbacks"], 3
        ),
        "admission_readbacks_per_request": round(
            stats[True]["readbacks"], 3
        ),
    }


def _publish_ratio_spread(
    out: dict, key: str, samples: list[float], prior: dict | None
) -> None:
    """Persist a headline ratio's per-repeat samples and publish its
    min–max POOLED with the previous artifact's persisted samples — a
    separate process, so the range bounds cross-run drift.  When no
    prior samples exist the range is annotated as within-run."""
    samples = [round(float(s), 3) for s in samples]
    out[f"{key}_samples"] = samples
    prev = [
        s for s in ((prior or {}).get(f"{key}_samples") or [])
        if isinstance(s, (int, float))
    ]
    pooled = samples + prev
    if not pooled:
        return
    out[f"{key}_min"] = round(min(pooled), 3)
    out[f"{key}_max"] = round(max(pooled), 3)
    out[f"{key}_spread_scope"] = (
        "pooled-cross-run" if prev else "within-run"
    )


def measure_faststart(scale: BenchScale, device=None) -> dict:
    """Fast replica start economics (faststart.py), on a spec="auto"
    engine so the spawn path carries what fast start removes: the
    spec-breakeven calibration's dead timing dispatches.  Greedy, so
    every stream bit-compares.

      1. **Spawn ladder** — ``faststart_cold_ms`` is the arm's FIRST
         build + canary probe with the kernel-build cache pointed at a
         fresh directory; ``faststart_warm_ms`` is the same spawn with
         no snapshot (re-runs calibration); ``faststart_cache_hit_spawn_ms``
         is the snapshot-primed spawn (calibration skipped).  Every
         repeat's streams are ASSERTED bit-identical snapshot on/off and
         to the cold oracle; ``faststart_calibration_skipped`` counts the
         skips the arm observed (must be > 0).  Each spawn still
         captures its own decode graph: a snapshot carries none.
      2. **Supervised selfheal integration** — a 2-replica fleet with a
         scheduled mid-stream crash and a snapshot-armed
         ``make_engine_factory``: the death -> probed-rejoin window is
         ``faststart_selfheal_restore_ms``, and the respawned engine
         must have CONSUMED the snapshot.
      3. **Autoscaler integration** — one probed ``_try_scale_up``,
         snapshot hot (``faststart_scaleup_hot_ms``) vs cold
         (``faststart_scaleup_cold_ms``).

    The compile-cache counters count kernel libraries looked up in
    the arm; a library this process loaded before is not looked up
    again, so after the earlier arms they read 0."""
    import statistics
    import tempfile

    from .backoff import Backoff
    from .faststart import EngineSnapshot, cache_stats, enable_compile_cache
    from .faults import FaultInjector
    from .fleet import Fleet
    from .serve import ServeEngine
    from .supervisor import FleetSupervisor, make_engine_factory

    device = resolve_device(device)
    batch, ps = scale.batch, scale.page_size
    chunk = ps
    hi = scale.serve_chunks[1]
    prompt_len = scale.decode_prompt
    config = _config(scale, prompt_len + 1 + hi * chunk)
    draft_config = ModelConfig(
        vocab_size=scale.vocab, d_model=max(16, scale.d_model // 2),
        n_heads=max(2, scale.n_heads // 2), n_layers=1,
        d_ff=max(32, scale.d_ff // 2),
        max_seq_len=config.max_seq_len, dtype=scale.dtype,
    )
    params = _params(config, 0, device)
    draft = _params(draft_config, 7, device)
    engine_kw = dict(
        slots=batch, page_size=ps, chunk=chunk,
        prompt_bucket=-(-prompt_len // ps) * ps,
        draft_params=draft, draft_config=draft_config, gamma=3,
        spec="auto",
    )
    probe = ([1, 2, 3], 1 + chunk)
    # The kernel-build cache is process-global; enabling it here (fresh
    # directory) starts the hit/miss meters for the whole arm.
    enable_compile_cache(tempfile.mkdtemp(prefix="faststart-bench-"))
    cc0 = cache_stats()

    def timed_spawn(snapshot):
        """Build + inline-canary one engine (the supervisor's probe
        contract); returns (secs, tokens, calibration_reused, snap)."""
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine = ServeEngine(params, config, **engine_kw, device=device)
        if snapshot is not None and not snapshot.prime(engine):
            raise RuntimeError("faststart bench: snapshot failed to prime")
        rid = engine.submit(probe[0], probe[1])
        tokens = None
        while tokens is None and not engine.idle:
            for req in engine.step():
                if req.rid == rid:
                    tokens = [int(t) for t in req.tokens]
        secs = time.perf_counter() - t0
        reused = engine.calibration_reused
        snap = EngineSnapshot.capture(
            engine, probe=probe, probe_oracle=tokens,
        ) if snapshot is None else None
        engine.close()
        if tokens is None:
            raise RuntimeError("faststart bench: canary never finished")
        return secs, tokens, reused, snap

    # 1. Spawn ladder.  Cold carries the calibration dispatches; its
    # verdict becomes THE snapshot for everything below.
    cold_s, oracle, _, snap = timed_spawn(None)
    skipped = 0
    warm_samples: list[float] = []
    hot_samples: list[float] = []
    for _ in range(3):
        warm_s, warm_tokens, warm_reused, _ = timed_spawn(None)
        hot_s, hot_tokens, hot_reused, _ = timed_spawn(snap)
        if warm_tokens != oracle or hot_tokens != oracle:
            raise RuntimeError(
                "faststart bench: spawn streams diverged snapshot "
                "on/off — the snapshot must never change tokens"
            )
        if warm_reused != 0 or hot_reused != 1:
            raise RuntimeError(
                f"faststart bench: calibration reuse miscounted "
                f"(warm={warm_reused}, primed={hot_reused})"
            )
        skipped += hot_reused
        warm_samples.append(warm_s)
        hot_samples.append(hot_s)

    # 2. Supervised selfheal with the snapshot armed.  Replicas start
    # COLD-built so any calibration reuse observed after the heal is
    # attributable to the respawn alone.
    n_rep = 2
    factory, fac_oracle = make_engine_factory(
        params, config, engine_kw=engine_kw, snapshot=snap, device=device,
    )
    if fac_oracle != oracle:
        raise RuntimeError(
            "faststart bench: factory oracle != snapshot oracle"
        )
    injector = FaultInjector()
    engines = [ServeEngine(params, config, **engine_kw, device=device)
               for _ in range(n_rep)]
    fleet = Fleet(
        engines, chip_ids=[f"chip-{i}" for i in range(n_rep)],
        fault_injector=injector, hang_timeout_s=60.0,
    )
    for i in range(n_rep):  # warm (and calibrate) off the clock
        fleet.submit([1 + i], 1 + chunk)
    fleet.run()
    fleet.drain_completed()
    sup = FleetSupervisor(
        fleet, factory,
        backoff=Backoff(base_s=1e-3, max_s=5e-3, jitter=0.0),
        probe=probe, snapshot=snap,
        crash_loop_k=3, crash_loop_window_s=60.0,
    )
    injector.reset()
    injector.arm({"replica_crash": 2 * n_rep + 1})
    n_req = 2 * batch
    for i in range(n_req):
        fleet.submit([1 + (i % 7)], 1 + (i % hi) * chunk)
    sup.run()
    done = fleet.drain_completed()
    statuses = {fr.status for fr in done}
    if len(done) != n_req or statuses != {"ok"}:
        raise RuntimeError(
            f"faststart bench: {len(done)} finished with statuses "
            f"{statuses}, expected {n_req} ok"
        )
    if not sup.wait_healed(timeout_s=30.0) or len(sup.restore_s) != 1:
        raise RuntimeError(
            f"faststart bench: supervised heal failed "
            f"(restore windows: {len(sup.restore_s)})"
        )
    selfheal_skipped = sum(
        r.engine.calibration_reused for r in fleet.replicas
        if r.engine is not None
    )
    if selfheal_skipped < 1:
        raise RuntimeError(
            "faststart bench: respawned replica did not consume the "
            "snapshot (calibration-skip counter is 0 after the heal)"
        )
    skipped += selfheal_skipped
    selfheal_restore_s = sup.restore_s[0]
    fleet.close()

    # 3. Autoscaler scale-up, snapshot hot vs cold.
    from .autoscaler import FleetAutoscaler

    def timed_scaleup(snapshot):
        base = ServeEngine(params, config, **engine_kw, device=device)
        fl = Fleet([base], chip_ids=["chip-0"], hang_timeout_s=None)
        fl.submit([1], 1 + chunk)
        fl.run()
        fl.drain_completed()
        fac, _ = make_engine_factory(
            params, config, engine_kw=engine_kw, snapshot=snapshot,
            device=device,
        )
        asc = FleetAutoscaler(
            fl, fac, min_replicas=1, max_replicas=2,
            probe=probe, snapshot=snapshot,
            probe_oracle=None if snapshot is not None else list(oracle),
            up_backoff=Backoff(base_s=1e-3, max_s=5e-3, jitter=0.0),
        )
        t0 = time.perf_counter()
        if not asc._try_scale_up(time.perf_counter()):
            raise RuntimeError("faststart bench: scale-up refused")
        secs = time.perf_counter() - t0
        reused = sum(
            r.engine.calibration_reused for r in fl.replicas
            if r.engine is not None
        )
        fl.close()
        return secs, reused

    scaleup_cold_s, _ = timed_scaleup(None)
    scaleup_hot_s, hot_scale_reused = timed_scaleup(snap)
    if hot_scale_reused < 1:
        raise RuntimeError(
            "faststart bench: hot scale-up did not consume the snapshot"
        )
    skipped += hot_scale_reused

    cc1 = cache_stats()
    warm_ms = [s * 1000 for s in warm_samples]
    hot_ms = [s * 1000 for s in hot_samples]
    return {
        "faststart_cold_ms": round(cold_s * 1000, 2),
        "faststart_warm_ms": round(statistics.median(warm_ms), 2),
        "faststart_cache_hit_spawn_ms": round(
            statistics.median(hot_ms), 2
        ),
        "faststart_cache_hit_spawn_ms_min": round(min(hot_ms), 2),
        "faststart_cache_hit_spawn_ms_max": round(max(hot_ms), 2),
        "faststart_cache_hit_spawn_ms_samples": [
            round(s, 2) for s in hot_ms
        ],
        "faststart_calibration_skipped": skipped,
        "faststart_selfheal_restore_ms": round(
            selfheal_restore_s * 1000, 2
        ),
        "faststart_scaleup_cold_ms": round(scaleup_cold_s * 1000, 2),
        "faststart_scaleup_hot_ms": round(scaleup_hot_s * 1000, 2),
        "faststart_compile_cache_hits": cc1["hits"] - cc0["hits"],
        "faststart_compile_cache_misses": cc1["misses"] - cc0["misses"],
    }


def card_identity() -> dict:
    """The card's name and power limit as ``nvidia-smi`` reports them;
    raises when nvidia-smi cannot say."""
    import subprocess

    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60,
    )
    if proc.returncode != 0 or not proc.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {proc.stderr.strip()}")
    name, limit = proc.stdout.strip().splitlines()[0].rsplit(",", 1)
    return {"device_name": name.strip(), "power_limit_w": float(limit)}


def run(
    scale_name: str = "full", pool_with: dict | None = None, device=None,
) -> dict:
    """The serving arms as one flat dict, in JAX's order.  ``pool_with``
    is the previous artifact (when parseable): headline samples pool
    with its persisted ones so the published min–max spans >= 2
    processes.  On the card the dict carries the card's name and power
    limit."""
    device = resolve_device(device)
    scale = BenchScale.named(scale_name)
    out = {"perf_scale": scale_name}
    if device.type == "cuda":
        out.update(card_identity())
    else:
        out["device_name"] = "cpu"
    out.update(measure_serve(scale, device))
    out.update(measure_serve_latency(scale, device))
    out.update(measure_interleave(scale, device))
    sup = measure_superstep(scale, device)
    out.update(sup)
    _publish_ratio_spread(
        out, "superstep_tokens_per_sec",
        sup["superstep_tokens_per_sec_samples"], pool_with,
    )
    out.update(measure_obs_overhead(scale, device))
    out.update(measure_ledger(scale, device))
    out.update(measure_admission(scale, device))
    out.update(measure_profiler(scale, device))
    # LAST: measure_faststart points the process-global kernel-build
    # cache at a fresh directory.
    out.update(measure_faststart(scale, device))
    return out


def main(argv=None) -> int:
    import argparse
    import json

    parser = argparse.ArgumentParser(description="serving perf bench (PyTorch)")
    parser.add_argument("--scale", default="full", choices=["full", "tiny"])
    parser.add_argument("--pool-with", default=None, metavar="PATH",
                        help="an earlier run's JSON: pool the headline "
                        "samples with its persisted ones")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda; 'cpu' runs the "
                        "plain PyTorch path)")
    args = parser.parse_args(argv)
    prior = None
    if args.pool_with is not None:
        with open(args.pool_with, encoding="utf-8") as f:
            prior = json.load(f)
    print(json.dumps(run(args.scale, pool_with=prior, device=args.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
