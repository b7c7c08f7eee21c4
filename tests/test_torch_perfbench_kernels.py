"""The training, kernel and engine arms of workloads_torch/perfbench.py
on the CPU, ported from the JAX package's tests/test_perfbench.py (the
FLOP accounting, the peak table, mfu_sweep's hardware FLOPs and one
end-to-end ``run("tiny")``), tests/test_workloads.py (the per-bucket
kernel table) and tests/test_serve.py (the lock-step ``serve_batch``),
plus the port's own chains: the attention chain and the paged decode
chunks the bench times.

These check structure and arithmetic, not speed: a CPU timing is not a
device number.  The run is its own module so that ``--dist loadfile``
gives it a worker of its own.
"""

import json
import os

import numpy as np
import pytest
import torch

from tests.test_torch_superstep import one_torch_thread  # noqa: F401
from workloads_torch import mfu_sweep
from workloads_torch import model as tmodel
from workloads_torch.generate import generate
from workloads_torch.model import ModelConfig, init_params
from workloads_torch.ops import kernel_select as ks
from workloads_torch.ops.attention import flash_attention
from workloads_torch.paged import PagePool, init_page_pools
from workloads_torch.perfbench import (
    BenchScale,
    _attention_chain,
    _attention_grad_step,
    _dense_causal,
    _paged_chunk_runner,
    _rand_qkv,
    device_peak_flops,
    run,
    train_step_flops,
)
from workloads_torch.serve import serve_batch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# ==== tests/test_perfbench.py: the accounting and the peak table


def test_train_step_flops_analytic():
    config = ModelConfig(
        vocab_size=100, d_model=8, n_heads=2, n_layers=3, d_ff=16,
        max_seq_len=5,
    )
    batch = 2
    s = 4  # max_seq_len - 1
    tokens = batch * s
    p_matmul = 3 * (4 * 8 * 8 + 2 * 8 * 16) + 8 * 100
    expected = 3 * (2 * tokens * p_matmul + 3 * batch * 4 * s * s * 8 * 0.5)
    assert train_step_flops(config, batch) == expected


def test_train_step_flops_gqa_counts_smaller_kv():
    base = dict(vocab_size=100, d_model=8, n_heads=4, n_layers=3, d_ff=16,
                max_seq_len=5)
    mha = ModelConfig(**base)
    gqa = ModelConfig(**base, n_kv_heads=2)
    # Same everything except the k/v projections, which halve.
    diff = train_step_flops(mha, 2) - train_step_flops(gqa, 2)
    s = 4
    tokens = 2 * s
    expected = 3 * 2 * tokens * 3 * (2 * 8 * (4 * 2) - 2 * 8 * (2 * 2))
    assert diff == expected


def _fake_card(monkeypatch, name):
    """The device name torch reports, or no card for None."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: name is not None)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: name)


@pytest.mark.parametrize("name, peak", [
    ("NVIDIA H100 80GB HBM3", 989e12),  # SXM
    ("NVIDIA H100 PCIe", 756.5e12),
    ("NVIDIA H100 NVL", 835.5e12),
    # Unknown cards yield None so MFU is omitted instead of reported
    # against a guessed peak; no TPU row carries over.
    ("NVIDIA A100-SXM4-80GB", None),
    ("TPU v5 lite", None),
    (None, None),  # no card: the CPU
])
def test_device_peak_flops_table(monkeypatch, name, peak):
    _fake_card(monkeypatch, name)
    assert device_peak_flops() == peak


def test_mfu_sweep_hardware_flops_accounting():
    """HFU accounting: flash recompute adds one forward-attention pass;
    remat adds one full layer-stack forward on top."""
    p = mfu_sweep.SweepPoint("x", d_model=8, n_heads=2, n_layers=3, d_ff=16,
                             vocab=100, seq=5, batch=2)
    config = p.config()
    s = 4
    fwd_attn = 3 * 2 * (4 * s * s * 8) * 0.5
    base = train_step_flops(config, 2)
    assert mfu_sweep.hardware_flops(config, 2) == base + fwd_attn

    r = mfu_sweep.SweepPoint("y", d_model=8, n_heads=2, n_layers=3, d_ff=16,
                             vocab=100, seq=5, batch=2, remat=True)
    rconfig = r.config()
    p_layers = 3 * (2 * 8 * 8 + 2 * 8 * (2 * 4) + 2 * 8 * 16)
    extra_layers_fwd = 2 * 2 * s * p_layers + fwd_attn
    assert mfu_sweep.hardware_flops(rconfig, 2) == base + fwd_attn + extra_layers_fwd
    # Registry sanity: every point builds a valid config, JAX's ten.
    assert len(mfu_sweep.POINTS) == 10
    for point in mfu_sweep.POINTS.values():
        assert point.config().attention_impl == "flash"


def test_mfu_sweep_records_a_failed_point_and_goes_on(monkeypatch, capsys):
    """A point that raises (out of memory, say) prints its error line and
    the sweep goes on to the next point."""
    def fake(point, device=None):
        if point.name == "b32":
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return {"point": point.name, "step_ms": 1.0}

    monkeypatch.setattr(mfu_sweep, "measure_point", fake)
    assert mfu_sweep.main(["--points", "base,b32,b16", "--device", "cpu"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["point"] for x in lines] == ["base", "b32", "b16"]
    assert lines[1]["error"].startswith("OutOfMemoryError: CUDA out of memory")
    assert "error" not in lines[0] and "error" not in lines[2]


def test_mfu_sweep_refuses_unknown_points_and_a_missing_card(monkeypatch):
    with pytest.raises(SystemExit):
        mfu_sweep.main(["--points", "base,nope", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mfu_sweep.main(["--points", "base"])


# ==== tests/test_workloads.py: the per-bucket kernel table


def _committed_picks():
    with open(os.path.join(ROOT, "docs", "bench-torch-latest.json"),
              encoding="utf-8") as f:
        return ks.table_from_artifact(json.load(f))


def test_h100_row_is_the_committed_artifacts_table(monkeypatch):
    """The H100 row of the kernel table is what the committed bench
    artifact measured, and the flash crossover is the smallest swept
    length from which flash wins at every longer one."""
    picks = _committed_picks()
    assert picks, "docs/bench-torch-latest.json carries no kernel_pick_seq*"
    _fake_card(monkeypatch, "NVIDIA H100 80GB HBM3")
    assert ks.kernel_table() == tuple(sorted(picks.items()))
    swept = sorted(picks)
    crossover = next(
        (s for i, s in enumerate(swept)
         if all(picks[t] == "flash" for t in swept[i:])),
        None,
    )
    want = crossover if crossover is not None else tmodel._FLASH_MIN_SEQ_DEFAULT
    assert tmodel.flash_min_seq() == want


def test_kernel_select_per_bucket_dispatch(monkeypatch):
    """A measured override wins, the H100 row covers the card, sequences
    past the largest bucket take flash, and unknown hardware falls back
    to the single crossover."""
    try:
        # No card: no table -> threshold fallback.
        _fake_card(monkeypatch, None)
        assert ks.kernel_table() is None
        assert ks.kernel_for_seq(1024, default_min_seq=2048) == "xla"
        assert ks.kernel_for_seq(2048, default_min_seq=2048) == "flash"
        # An unknown card: the same.
        _fake_card(monkeypatch, "NVIDIA A100-SXM4-80GB")
        assert ks.kernel_table() is None
        # The H100: its measured per-bucket picks.
        _fake_card(monkeypatch, "NVIDIA H100 80GB HBM3")
        for bucket, impl in _committed_picks().items():
            assert ks.kernel_for_seq(bucket, default_min_seq=1) == impl
            assert tmodel._pick_kernel(bucket) == impl
        assert ks.kernel_for_seq(1 << 20, default_min_seq=1) == "flash"
        # Injected measurement overrides everything.
        ks.set_kernel_table(
            ks.table_from_measurements({1024: 1.3, 2048: 0.9})
        )
        assert ks.kernel_for_seq(512, default_min_seq=1) == "flash"
        assert ks.kernel_for_seq(2000, default_min_seq=1) == "xla"
        assert tmodel._pick_kernel(2000) == "xla"
        # Artifact round trip: the bench's kernel_pick_seq* fields
        # rebuild the same table.
        art = {"kernel_pick_seq1024": "flash", "kernel_pick_seq2048": "xla",
               "kernel_pick_seqx": "flash", "unrelated": 1}
        assert ks.table_from_artifact(art) == {1024: "flash", 2048: "xla"}
        assert ks.table_from_artifact({"unrelated": 1}) is None
        with pytest.raises(ValueError):
            ks.set_kernel_table({128: "fast"})
    finally:
        ks.set_kernel_table(None)


# ==== tests/test_serve.py: the lock-step baseline

CONFIG = ModelConfig(max_seq_len=64, n_layers=2, dtype=torch.float32)


@pytest.fixture(scope="module")
def params():
    return init_params(CONFIG, torch.Generator().manual_seed(0))


def _randint(seed, shape):
    return torch.as_tensor(
        np.random.default_rng(seed).integers(0, CONFIG.vocab_size, shape)
    )


def test_paged_serve_matches_generate_greedy(params):
    prompts = _randint(1, (2, 8))
    ctrl = PagePool(n_pages=32, page_size=4)
    pools = init_page_pools(CONFIG, 32, 4, device="cpu")
    got, pools = serve_batch(params, CONFIG, prompts, 10, ctrl, pools)
    want = generate(params, prompts, CONFIG, max_new_tokens=10, device="cpu")
    assert torch.equal(got, want)
    assert ctrl.used_pages == 0  # the batch retired its pages


def test_pages_recycle_across_batches(params):
    ctrl = PagePool(n_pages=12, page_size=4)
    pools = init_page_pools(CONFIG, 12, 4, device="cpu")
    for seed in range(3):  # 3 batches through a pool sized for ~one
        prompts = _randint(seed, (2, 8))
        out, pools = serve_batch(params, CONFIG, prompts, 8, ctrl, pools)
        assert out.shape == (2, 8)
        assert ctrl.used_pages == 0


def test_serve_batch_releases_pages_when_a_step_raises(params):
    """Sampling without a generator raises before any page is taken; a
    pool that holds the prompts but not their growth raises mid-decode
    and gives back every page in its ``finally``."""
    ctrl = PagePool(n_pages=4, page_size=4)
    pools = init_page_pools(CONFIG, 4, 4, device="cpu")
    with pytest.raises(ValueError, match="requires a torch.Generator"):
        serve_batch(params, CONFIG, _randint(1, (2, 8)), 4, ctrl, pools,
                    temperature=0.8)
    assert ctrl.used_pages == 0
    with pytest.raises(RuntimeError, match="exhausted"):
        serve_batch(params, CONFIG, _randint(1, (2, 8)), 4, ctrl, pools)
    assert ctrl.used_pages == 0


def test_serve_batch_samples_from_its_generator(params):
    """Sampled lock-step streams follow the generator: the same seed
    gives the same tokens, and each is in the vocabulary."""
    outs = []
    for _ in range(2):
        ctrl = PagePool(n_pages=32, page_size=4)
        pools = init_page_pools(CONFIG, 32, 4, device="cpu")
        out, _ = serve_batch(params, CONFIG, _randint(1, (2, 8)), 6, ctrl, pools,
                             temperature=0.8, top_k=50, top_p=0.95,
                             generator=torch.Generator().manual_seed(3))
        outs.append(out)
    assert torch.equal(outs[0], outs[1])
    assert 0 <= int(outs[0].min()) and int(outs[0].max()) < CONFIG.vocab_size


# ==== the port's chains


@pytest.mark.parametrize("attn", ["flash", "dense"])
def test_attention_chain_equals_explicit_steps(attn):
    """``_attention_chain(n=3)`` is three explicit gradient links from q,
    and a second run starts from q again."""
    fn = flash_attention if attn == "flash" else _dense_causal
    q, k, v = _rand_qkv(48, 2, 16, dtype=torch.float32, device="cpu")
    want = q.clone()
    for _ in range(3):
        leaf = want.clone().requires_grad_(True)
        (g,) = torch.autograd.grad(fn(leaf, k, v).float().sum(), leaf)
        want = want + 1e-6 * g.to(want.dtype)
    chain = _attention_chain(fn, q, k, v)
    assert torch.equal(chain(3), want)
    assert not torch.equal(want, q)  # the links moved q
    assert torch.equal(chain(3), want)  # each run starts from q
    one = q.clone()
    _attention_grad_step(fn, one, k, v)
    assert torch.equal(chain(1), one)


def test_attention_chain_graph_needs_cuda_tensors():
    q, k, v = _rand_qkv(16, 1, 16, device="cpu")
    with pytest.raises(ValueError, match="CUDA graph needs CUDA tensors"):
        _attention_chain(flash_attention, q, k, v, graph=True)


def test_paged_chunks_are_the_greedy_stream():
    """The plain decode program the bench times: its tokens after the
    prefill's pick are generate()'s, chunk after chunk."""
    config = ModelConfig(max_seq_len=64, n_layers=2, dtype=torch.float32)
    p = init_params(config, torch.Generator().manual_seed(0))
    run_chunks = _paged_chunk_runner(
        p, config, batch=3, prompt_len=5, page_size=4, chunk=4, n_hi=3,
        device=torch.device("cpu"),
    )
    got = run_chunks(3)
    prompts = torch.as_tensor(
        np.random.default_rng(1).integers(0, config.vocab_size, (3, 5)))
    want = generate(p, prompts, config, max_new_tokens=13, device="cpu")
    assert torch.equal(got, want[:, 1:])
    assert torch.equal(run_chunks(1), want[:, 1:5])  # fresh tables each run


# ==== one run("tiny") of the slice's arms (tests/test_perfbench.py)


@pytest.fixture(scope="module")
def tiny_run():
    """One run of every arm; measure_faststart points the process-global
    kernel-build cache at a fresh directory, which is put back after."""
    import workloads_torch.faststart as faststart
    from workloads_torch.ops import _build

    build_dir, cache_dir = _build.BUILD_DIR, faststart._cache_dir
    try:
        yield run("tiny", device="cpu")
    finally:
        _build.set_build_dir(build_dir)
        faststart._cache_dir = cache_dir


def test_perfbench_tiny_end_to_end(tiny_run):
    """Every key of JAX's end-to-end test that this slice publishes, and
    its sanity bounds (values are CPU noise)."""
    out = tiny_run
    for key in (
        "train_step_ms",
        "train_tokens_per_sec",
        "mfu",
        "flash_vs_xla_speedup",
        "flash_vs_xla_detail",
        "decode_ms_per_token",
        "decode_tokens_per_sec",
        "paged_decode_tokens_per_sec",
        "paged_vs_contiguous_decode",
        "serve_tokens_per_sec",
        "serve_requests_per_sec",
        "serve_pool_peak_fraction",
        "superstep_best_k",
        "superstep_tokens_per_sec",
        "superstep_tokens_per_sec_k1",
        "superstep_tokens_per_sec_k8",
        "superstep_speedup",
        "superstep_overdecode_pct",
        "decode_host_sync_ms",
        "superstep_tokens_per_sec_samples",
        "superstep_tokens_per_sec_min",
        "superstep_tokens_per_sec_max",
        "obs_overhead_pct",
        "obs_on_tokens_per_sec",
        "obs_off_tokens_per_sec",
        "spec_breakeven_batch",
        "spec_phase_dominant",
        "spec_phase_tokens_per_round",
        "spec_draft_ms_b1",
        "spec_verify_ms_b1",
        "spec_commit_ms_b1",
        "spec_phase_ratio_b1",
        "spec_engine_vs_plain_b1",
        "spec_engine_vs_plain_b4",
        "spec_engine_best_k",
        "kv_multiturn_speedup",
        "kv_radix_vs_flat_hit_ratio",
        "kv_flat_hit_pages",
        "kv_radix_hit_pages",
        "kv_oversub_pool_pages",
        "kv_oversub_live_pages",
        "kv_offload_spills",
        "kv_offload_reloads",
        "kv_resident_pages_saved",
        "paged_vs_contiguous_decode_samples",
        "paged_vs_contiguous_decode_min",
        "decode_int8_speedup_samples",
        "flash_vs_xla_speedup_samples",
        "flash_window_speedup_samples",
    ):
        assert key in out, key
    assert 0.0 < out["serve_pool_peak_fraction"] <= 1.0
    # KV hierarchy: the tiny trace oversubscribes its pool, the offload
    # tier runs both directions (streams checked inside the arm), and
    # the tree never hits fewer pages than the flat index.
    assert out["kv_oversub_live_pages"] > out["kv_oversub_pool_pages"]
    assert out["kv_offload_spills"] >= 1
    assert out["kv_offload_reloads"] >= 1
    assert out["kv_offload_reload_ms"] > 0
    assert out["kv_radix_hit_pages"] >= out["kv_flat_hit_pages"]
    assert out["spec_phase_dominant"] in ("draft", "verify", "commit")
    assert out["spec_breakeven_batch"] >= 0.0
    assert out["superstep_best_k"] in out["superstep_ks"]
    assert out["superstep_tokens_per_sec"] > 0
    assert out["decode_host_sync_ms"] >= 0
    assert 0.0 <= out["superstep_overdecode_pct"] < 100.0
    for b in out["spec_phase_batches"]:
        assert f"spec_verify_ms_b{b}" in out
    # No spread pooling source passed -> within-run scope.
    assert out["paged_vs_contiguous_decode_spread_scope"] == "within-run"
    assert (
        out["paged_vs_contiguous_decode_min"] - 0.001
        <= out["paged_vs_contiguous_decode"]
        <= out["paged_vs_contiguous_decode_max"] + 0.001
    )
    assert out["mfu"] is None  # the CPU has no peak: omitted, not guessed
    assert out["train_step_ms"] >= 0
    assert set(out["flash_vs_xla_detail"]) == {"128"}
    assert out["device_name"] == "cpu"


def test_run_tiny_publishes_the_kernel_picks(tiny_run):
    """One kernel_pick_seq a swept length, the table the speedup gives,
    and table_from_artifact reads it back."""
    speedup = tiny_run["flash_vs_xla_detail"]["128"]["speedup"]
    assert tiny_run["kernel_pick_seq128"] == ("flash" if speedup >= 1.0 else "xla")
    assert ks.table_from_artifact(tiny_run) == {128: tiny_run["kernel_pick_seq128"]}
    assert tiny_run["flash_vs_xla_seq"] == 128
    assert tiny_run["window_seq"] == 256 and tiny_run["window_size"] == 128


def test_run_tiny_engine_arms(tiny_run):
    """The fault, speculation, LoRA and prefix arms: their counts, and
    every ratio inside its own spread."""
    out = tiny_run
    assert out["fault_recovery_ms"] > 0
    assert out["fault_recovery_requeued"] >= 1
    assert out["fault_requests"] == 4
    assert out["spec_econ_draft"] == "int8-self"
    assert 0.0 <= out["spec_acceptance_rate"] <= 1.0
    assert 1.0 <= out["spec_tokens_per_round"] <= 5.0
    assert out["spec_engine_best_k"] in BenchScale.named("tiny").spec_engine_ks
    assert out["spec_superstep_best_k"] in out["spec_superstep_ks"]
    assert out["spec_superstep_tokens_per_sec_spread_scope"] == "within-run"
    assert out["multi_lora_adapters"] == 4 and out["multi_lora_rank"] == 16
    assert 0.0 < out["prefix_prefill_tokens_saved_fraction"] < 1.0
    assert out["kv_offload_reload_ms_spread_scope"] == "within-run"
    for key in ("fault_injector_off_overhead_pct", "spec_pipelined_speedup",
                "spec_lookahead_speedup", "spec_engine_vs_plain_b1",
                "spec_engine_vs_plain_b4", "multi_lora_relative_throughput",
                "prefix_serve_speedup", "kv_multiturn_speedup"):
        assert out[f"{key}_min"] <= out[key] <= out[f"{key}_max"], key
