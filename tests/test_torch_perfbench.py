"""The serving half of workloads_torch/perfbench.py on the CPU, ported
from the JAX package's tests/test_perfbench.py (the harness: slope,
break-even, ratio spread, BenchScale) and tests/test_serve_latency.py
(the engine's latency stamps and the latency arm), plus one
``run("tiny")`` of the slice's arms.

These check structure and arithmetic, not speed: a CPU timing is not a
device number.  The training, kernel and engine arms' cases
(``device_peak_flops``, ``train_step_flops``, ``mfu_sweep``, the kernel
table, ``serve_batch`` and their own ``run("tiny")``) are in
tests/test_torch_perfbench_kernels.py.
"""

import time

import pytest
import torch

from tests.test_torch_superstep import one_torch_thread  # noqa: F401
from workloads_torch.generate import generate
from workloads_torch.model import ModelConfig, init_params
from workloads_torch.perfbench import (
    BenchScale,
    _pctl,
    _publish_ratio_spread,
    derive_breakeven,
    measure_serve_latency,
    measure_slope_samples,
    measure_slope_secs,
    run,
)
from workloads_torch.profiler import _SENTRY_SIGNALS
from workloads_torch.serve import ServeEngine

# ==== tests/test_perfbench.py: the harness


def test_bench_scale_named():
    full, tiny = BenchScale.named("full"), BenchScale.named("tiny")
    assert full.seq > tiny.seq
    assert (full.d_model, full.n_heads, full.n_layers, full.d_ff, full.vocab) == (
        2048, 16, 8, 8192, 32768)
    with pytest.raises(ValueError):
        BenchScale.named("nope")


def test_measure_slope_cancels_constant_overhead():
    calls = []

    def run_chain(n):
        calls.append(n)
        time.sleep(0.05 + n * 0.02)  # constant 50ms + 20ms/iter

    secs = measure_slope_secs(run_chain, n_lo=2, n_hi=8, repeats=2,
                              min_window_secs=0.05)
    assert 0.015 < secs < 0.025  # slope recovers the per-iter cost
    assert calls[0] == 2 and calls[1] == 8  # warm pass precedes timing


def test_measure_slope_grows_until_window():
    seen = []

    def run_chain(n):
        seen.append(n)
        time.sleep(n * 0.004)

    # 4ms/iter: the first (2, 8) round gives a 24ms window < 60ms, so the
    # chain lengths must double at least once.
    secs = measure_slope_secs(run_chain, n_lo=2, n_hi=8, repeats=1,
                              min_window_secs=0.06)
    assert max(seen) >= 16
    assert 0.002 < secs < 0.006


def test_derive_breakeven():
    """The break-even derivation: log2 interpolation at the win->lose
    crossing, a floor at the largest measured batch when every batch
    wins, 0 when even batch 1 loses."""
    assert derive_breakeven([1, 2, 4, 8], [1.3, 1.1, 0.9, 0.7]) == 2.83
    assert derive_breakeven([1, 2, 4], [1.2, 1.0, 0.8]) == 2.0
    assert derive_breakeven([1, 2, 4, 8], [1.3, 1.2, 1.1, 1.05]) == 8.0
    assert derive_breakeven([1, 2], [0.9, 0.7]) == 0.0
    # Non-monotone noise: the FIRST crossing wins (conservative).
    assert derive_breakeven([1, 2, 4], [1.1, 0.9, 1.02]) < 2.0


def test_publish_ratio_spread_pools_across_runs():
    """Current samples pool with the prior artifact's persisted ones —
    a separate process — and the scope field says which kind of range
    was published."""
    out = {}
    _publish_ratio_spread(out, "r", [1.30, 1.35], None)
    assert out["r_samples"] == [1.3, 1.35]
    assert (out["r_min"], out["r_max"]) == (1.3, 1.35)
    assert out["r_spread_scope"] == "within-run"
    prior = {"r_samples": [1.2, 1.4, "junk"]}
    out = {}
    _publish_ratio_spread(out, "r", [1.30, 1.35], prior)
    assert (out["r_min"], out["r_max"]) == (1.2, 1.4)
    assert out["r_spread_scope"] == "pooled-cross-run"
    # The persisted samples are the CURRENT run's (next round pools them).
    assert out["r_samples"] == [1.3, 1.35]


def test_measure_slope_samples_returns_per_repeat_slopes():
    def run_chain(n):
        time.sleep(0.05 + n * 0.02)

    median, samples = measure_slope_samples(
        run_chain, n_lo=2, n_hi=8, repeats=3, min_window_secs=0.05
    )
    assert len(samples) == 3
    assert min(samples) <= median <= max(samples)
    assert all(0.01 < s < 0.04 for s in samples)


def test_entry_points_default_to_the_card(monkeypatch):
    """Without a card and without device="cpu" the bench refuses to
    run instead of timing the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        measure_serve_latency(BenchScale.named("tiny"))


# ==== tests/test_serve_latency.py

CONFIG = ModelConfig(max_seq_len=64, n_layers=2, dtype=torch.float32)


@pytest.fixture(scope="module")
def params():
    return init_params(CONFIG, torch.Generator().manual_seed(0))


def _stream_engine(params, slots: int):
    engine = ServeEngine(
        params, CONFIG, slots=slots, page_size=4, prompt_bucket=8, device="cpu"
    )
    # Warm first, so the measured stream sees steady state.
    engine.submit([9], 12)
    engine.run()
    engine.completed.clear()
    rids = [engine.submit([1 + i, 2, 3], 12) for i in range(6)]
    served = engine.run()
    return engine, rids, served


def test_latency_stamps_are_ordered_and_complete(params):
    engine, rids, _ = _stream_engine(params, slots=2)
    assert len(engine.completed) == len(rids)
    for req in engine.completed:
        assert req.t_submit is not None
        assert req.t_submit <= req.t_first <= req.t_done
        assert req.ttft_secs >= 0 and req.e2e_secs >= req.ttft_secs


def test_backpressure_lands_in_ttft_tail_not_in_tokens(params):
    """The same 6-request stream through slots=1 (everything queues) and
    slots=4 (the last wave queues): tokens must be identical, while in
    BOTH engines the queued requests' TTFT must dominate the
    immediately-admitted ones' — queue wait is IN the client-visible
    first-token latency, which is what serve_ttft_p99_ms surfaces."""
    eng1, rids1, served1 = _stream_engine(params, slots=1)
    eng4, rids4, served4 = _stream_engine(params, slots=4)
    for r1, r4 in zip(rids1, rids4):
        assert served1[r1] == served4[r4]
    for eng, rids in ((eng1, rids1), (eng4, rids4)):
        by_rid = {r.rid: r for r in eng.completed}
        ttfts = [by_rid[r].ttft_secs for r in rids]
        assert _pctl(ttfts, 0.99) > 4 * min(ttfts), (eng.slots, ttfts)
    # With one slot, arrival order IS service order: TTFT must be
    # monotonically non-decreasing along the submission order.
    by_rid1 = {r.rid: r for r in eng1.completed}
    ttft1 = [by_rid1[r].ttft_secs for r in rids1]
    assert all(a <= b * 1.5 for a, b in zip(ttft1, ttft1[1:])), ttft1
    assert ttft1[-1] > 3 * ttft1[0]


def test_at_admission_finish_gets_stamps_too(params):
    """max_new_tokens=1 retires at admission (never takes a slot): the
    stamps must still be complete, with t_done == t_first."""
    engine = ServeEngine(params, CONFIG, slots=1, page_size=4, prompt_bucket=8,
                         device="cpu")
    rid = engine.submit([5, 6], 1)
    served = engine.run()
    assert len(served[rid]) == 1
    (req,) = engine.completed
    assert req.rid == rid and req.t_done == req.t_first >= req.t_submit


def test_measure_serve_latency_fields_sane():
    out = measure_serve_latency(BenchScale.named("tiny"), device="cpu")
    assert out["serve_latency_requests"] == 6  # 3 x tiny batch
    for key in ("serve_ttft_p50_ms", "serve_ttft_p99_ms",
                "serve_e2e_p50_ms", "serve_e2e_p99_ms"):
        assert out[key] > 0
    assert out["serve_ttft_p50_ms"] <= out["serve_ttft_p99_ms"]
    assert out["serve_e2e_p50_ms"] <= out["serve_e2e_p99_ms"]
    assert out["serve_ttft_p99_ms"] <= out["serve_e2e_p99_ms"]


def test_pipelined_emission_lag_is_in_ttft(params):
    """Pipelined stepping defers emission by a chunk: the stamps must
    reflect OBSERVED emission, and parity still holds."""
    ref = generate(params, torch.tensor([[9, 8, 7]]), CONFIG, max_new_tokens=10,
                   device="cpu")
    for pipelined in (False, True):
        engine = ServeEngine(
            params, CONFIG, slots=2, page_size=4, prompt_bucket=8,
            pipelined=pipelined, device="cpu",
        )
        rid = engine.submit([9, 8, 7], 10)
        served = engine.run()
        assert served[rid] == [int(t) for t in ref[0]]
        (req,) = engine.completed
        assert req.t_submit <= req.t_first <= req.t_done


# ==== one run("tiny") of the slice's arms


@pytest.fixture(scope="module")
def tiny_run():
    """One run of every arm (the serving arms' keys are checked here);
    measure_faststart points the process-global kernel-build cache at a
    fresh directory, which is put back after."""
    import workloads_torch.faststart as faststart
    from workloads_torch.ops import _build

    build_dir, cache_dir = _build.BUILD_DIR, faststart._cache_dir
    try:
        yield run("tiny", pool_with={"superstep_tokens_per_sec_samples": [1.0, 2.0]},
                  device="cpu")
    finally:
        _build.set_build_dir(build_dir)
        faststart._cache_dir = cache_dir


def test_run_tiny_publishes_every_serving_key(tiny_run):
    want = {
        "serve_tokens_per_sec", "serve_ttft_p99_ms", "decode_host_sync_ms",
        "superstep_tokens_per_sec", "superstep_tokens_per_sec_samples",
        "superstep_tokens_per_sec_min", "superstep_tokens_per_sec_max",
        "obs_overhead_pct", "obs_overhead_pct_min", "obs_overhead_pct_max",
        "ledger_overhead_pct", "ledger_overhead_pct_min", "ledger_overhead_pct_max",
        "profiler_overhead_pct", "profiler_overhead_pct_min",
        "profiler_overhead_pct_max", "device_busy_fraction", "admission_speedup",
        "interleave_ttft_p99_ratio", "faststart_cache_hit_spawn_ms",
        "faststart_calibration_skipped", "profiler_device_time_table",
    }
    assert want <= set(tiny_run), sorted(want - set(tiny_run))
    assert tiny_run["perf_scale"] == "tiny" and tiny_run["device_name"] == "cpu"
    # Every key the sentry arms against is published.
    assert {key for _, key, _ in _SENTRY_SIGNALS} <= set(tiny_run)


def test_run_tiny_pools_the_prior_samples(tiny_run):
    samples = tiny_run["superstep_tokens_per_sec_samples"]
    assert len(samples) == 3
    assert tiny_run["superstep_tokens_per_sec_spread_scope"] == "pooled-cross-run"
    assert tiny_run["superstep_tokens_per_sec_min"] == min(samples + [1.0])
    assert tiny_run["superstep_tokens_per_sec_max"] == max(samples + [2.0])


def test_run_tiny_overheads_carry_their_spread(tiny_run):
    for key in ("obs_overhead_pct", "ledger_overhead_pct", "profiler_overhead_pct",
                "admission_speedup", "interleave_ttft_p99_ratio"):
        assert tiny_run[f"{key}_min"] <= tiny_run[key] <= tiny_run[f"{key}_max"], key
    assert 0.0 < tiny_run["device_busy_fraction"] <= 1.0
    assert tiny_run["host_stall_fraction"] == pytest.approx(
        1.0 - tiny_run["device_busy_fraction"])
    assert tiny_run["profiler_device_time_table"]


def test_run_tiny_fast_start_skipped_calibration(tiny_run):
    # 3 primed spawns + the self-heal respawn + the hot scale-up.
    assert tiny_run["faststart_calibration_skipped"] == 5
    assert tiny_run["ledger_quarantines"] >= 1
    assert tiny_run["admission_dispatches_per_request"] < (
        tiny_run["admission_dispatches_per_request_serial"])
