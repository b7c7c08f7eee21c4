"""chip_smoke.py's reading of nvcc's ptxas report, on which its build
phase fails a kernel that spills.  CPU-only: the report is text."""

import pytest

import chip_smoke

# Two entries as `nvcc -Xptxas -v` prints them for each kernel instance.
_ENTRY = """ptxas info    : Compiling entry function '{mangled}' for 'sm_90a'
ptxas info    : Function properties for {mangled}
    {stack} bytes stack frame, {stores} bytes spill stores, {loads} bytes spill loads
ptxas info    : Used {regs} registers, used 1 barriers
"""
_PREFIX = "_ZN51_GLOBAL__N__459cc6d3_18_flash_attention_cu_2c138979"


def _log(*entries):
    return "".join(_ENTRY.format(**e) for e in entries)


@pytest.mark.parametrize(
    "mangled, name",
    [
        (_PREFIX + "26flash_bwd_dkv_wgmma_kernelILi128ELi32EEEv14CUtensorMap_stS1_S1_S1_PKf",
         "flash_bwd_dkv_wgmma_kernel<128, 32>"),
        (_PREFIX + "25flash_bwd_dq_wgmma_kernelILi64EEEv14CUtensorMap_stS1_S1_S1_PKf",
         "flash_bwd_dq_wgmma_kernel<64>"),
        (_PREFIX + "21flash_fwd_bf16_kernelILi128EEEvPK13__nv_bfloat16S3_S3_PKiPS1_Pfiiiiif",
         "flash_fwd_bf16_kernel<128>"),
        (_PREFIX + "22flash_fwd_wgmma_kernelILi64EEEv14CUtensorMap_stS1_S1_PKiP13__nv_bfloat16"
         "Pfiiiiif", "flash_fwd_wgmma_kernel<64>"),
        (_PREFIX + "22flash_fwd_wgmma_kernelILi128EEEv14CUtensorMap_stS1_S1_PKiP13__nv_bfloat16"
         "Pfiiiiif", "flash_fwd_wgmma_kernel<128>"),
        ("_ZN46_GLOBAL__N__1_18_paged_attention_cu_219paged_decode_kernelI13__nv_bfloat16"
         "Li128ELi1EEEvNS_6ParamsE", "paged_decode_kernel<bf16, 128, 1>"),
        ("_ZN46_GLOBAL__N__1_18_paged_attention_cu_219paged_decode_kernelIfLi16ELi8EEEv"
         "NS_6ParamsE", "paged_decode_kernel<float, 16, 8>"),
        ("_ZN46_GLOBAL__N__1_18_paged_attention_cu_219paged_decode_kernelI13__nv_bfloat16"
         "Li128EEEvPKT_", "paged_decode_kernel<bf16, 128>"),
        ("_ZN46_GLOBAL__N__1_18_paged_attention_cu_219paged_decode_kernelIfLi64EEEvPKT_",
         "paged_decode_kernel<float, 64>"),
    ],
)
def test_ptxas_report_names_each_instance(mangled, name):
    rows = chip_smoke.ptxas_report(
        _log(dict(mangled=mangled, stack=0, stores=0, loads=0, regs=168)))
    assert rows == [(name, "Used 168 registers, used 1 barriers; 0 bytes stack frame, "
                           "0 bytes spill stores, 0 bytes spill loads", 0)]


def test_ptxas_report_reads_each_instances_own_spill_stores():
    log = _log(
        dict(mangled=_PREFIX + "26flash_bwd_dkv_wgmma_kernelILi128ELi64EEEv", stack=24,
             stores=28, loads=48, regs=168),
        dict(mangled=_PREFIX + "25flash_bwd_dq_wgmma_kernelILi128EEEv", stack=0, stores=0,
             loads=0, regs=168),
    )
    rows = chip_smoke.ptxas_report(log)
    assert [(name, stores) for name, _, stores in rows] == [
        ("flash_bwd_dkv_wgmma_kernel<128, 64>", 28), ("flash_bwd_dq_wgmma_kernel<128>", 0)]


def test_lora_phases_rehearse_on_the_cpu(capsys):
    """Phases 4e and 6e on the plain route at a tiny width, every CPU
    gate included: (b)'s base rows equal the plain drain's, (f)'s hits
    per salt are the radix model's prediction with no page shared
    across salts, (g)'s adapted streams equal the merged models', and
    the fine-tune's loss falls with the base unchanged."""
    import numpy as np
    import torch

    from workloads_torch import model as model_mod
    from workloads_torch import train as train_mod
    from workloads_torch.model import ModelConfig, cast_params, init_params
    from workloads_torch.ops import attention as fa
    from workloads_torch.ops import paged_attention as pa

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        f = dict(chip_smoke.FULL, slots=8, page_size=8, decode_prompt=8, d_model=64,
                 n_heads=4, n_layers=2, d_ff=128, vocab_size=256, train_batch=2,
                 train_seq=33)
        config = ModelConfig(d_model=64, n_heads=4, n_layers=2, d_ff=128, vocab_size=256,
                             max_seq_len=40, dtype=torch.bfloat16)
        params = cast_params(init_params(config, torch.Generator().manual_seed(0)),
                             config.dtype)
        rng = np.random.default_rng(0)
        requests = [(rng.integers(0, 256, 8), n) for n in [16, 32, 24, 20] * 3]
        counters = chip_smoke.kernel_counters(pa, fa)
        lora = dict(chip_smoke.LORA, f32_new=(8, 16),
                    kv=dict(max_seq_len=128, page_size=4, prompt_bucket=8, slots=8, chunk=4,
                            system=32, user=4, new=4))
        chip_smoke.lora_phase(torch, params, config, f, counters, requests, None, 1.0,
                              device="cpu", lora=lora)
        chip_smoke.lora_train_path(torch, model_mod, train_mod, counters, f, device="cpu",
                                   steps=3)
    finally:
        torch.set_num_threads(threads)
    out = capsys.readouterr().out
    assert "base requests' bf16 streams equal (a)'s bit for bit in 3 of 3" in out
    assert "'lora:1': [0, 8, 8, 8]" in out and "shared across salts: none" in out
    assert "base bit-unchanged" in out


def test_fleet_phase_rehearses_on_the_cpu(capsys):
    """Phase 4f on the plain route at a tiny width, every CPU gate
    included: one terminal status a request and no page left in every
    arm, the SSE tokens equal to the record, the ledgers reconciled, the
    exposition and the merged trace well formed, the supervisor's and
    autoscaler's events in order, a retune, a restore that replays, and
    the float32 arms equal to one plain engine's streams."""
    import torch

    from workloads_torch.model import ModelConfig, cast_params, init_params
    from workloads_torch.ops import attention as fa
    from workloads_torch.ops import paged_attention as pa

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        config = ModelConfig(vocab_size=256, d_model=64, n_heads=4, n_layers=2, d_ff=128,
                             max_seq_len=64, dtype=torch.bfloat16)
        params = cast_params(init_params(config, torch.Generator().manual_seed(0)),
                             config.dtype)
        f = dict(chip_smoke.FULL, slots=2, page_size=4, decode_prompt=8)
        fl = dict(chip_smoke.FLEET, prompt=(4, 24), new=(4, 12), long_new=(8, 16),
                  short_new=(2, 4), max_seq_len=48, requests=8, short_requests=6,
                  f32_requests=4)
        chip_smoke.fleet_phase(torch, params, config, f, chip_smoke.kernel_counters(pa, fa),
                               100.0, fl=fl, device="cpu")
    finally:
        torch.set_num_threads(threads)
    out = capsys.readouterr().out
    assert "tokens equal to the fleet's record" in out
    assert "events ['death', 'backoff', 'probe', 'rejoin']" in out
    assert "ups 1 downs 1" in out
    assert "(a), (b), (c), (d) and (g) equal the plain engine's 4 streams" in out


def test_exposition_parser_and_event_order():
    chip_smoke.parse_exposition('# HELP x_total a\n# TYPE x_total counter\nx_total{a="1"} 3\n'
                                'y NaN\n')
    with pytest.raises(SystemExit):
        chip_smoke.parse_exposition("x_total three\n")
    assert chip_smoke.in_order(["death", "backoff", "probe", "rejoin"], ["death", "rejoin"])
    assert not chip_smoke.in_order(["rejoin", "death"], ["death", "rejoin"])


def test_profiling_phase_rehearses_on_the_cpu(capsys):
    """Phase 4g on the plain route at a tiny width, every CPU gate
    included: (a)'s streams equal with the profiling layer on and off,
    (b)'s capture through POST /profile written, accounted and within
    its budget while a replica respawns, the refusal past the spent
    budget, (c)'s primed engine reusing the calibration with the
    unprimed engine's float32 streams and the alternated respawns with
    and without the snapshot, and (e)'s latency keys.  The model is
    float32 here: a respawn without a snapshot times its own spec="auto"
    calibration, and on a loaded CPU that verdict can flip, which in
    bf16 can part its canary from the oracle; in float32 a speculative
    and a plain step give the same greedy tokens."""
    import torch

    from workloads_torch.model import ModelConfig, cast_params, init_params
    from workloads_torch.ops import attention as fa
    from workloads_torch.ops import paged_attention as pa

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        config = ModelConfig(vocab_size=256, d_model=64, n_heads=4, n_layers=2, d_ff=128,
                             max_seq_len=64, dtype=torch.float32)
        params = cast_params(init_params(config, torch.Generator().manual_seed(0)),
                             config.dtype)
        f = dict(chip_smoke.FULL, slots=2, page_size=4, decode_prompt=8)
        fl = dict(chip_smoke.FLEET, prompt=(4, 24), long_new=(8, 16), max_seq_len=48)
        pf = dict(chip_smoke.PROFILE, requests=4, new=(4, 12), f32_max_seq_len=32,
                  capture_secs=1.0, capture_requests=6, capture_new=(8, 16), respawns=2,
                  respawn_requests=2, scale="tiny")
        chip_smoke.profiling_phase(torch, params, config, f, chip_smoke.kernel_counters(pa, fa),
                                   pf=pf, fl=fl, device="cpu")
    finally:
        torch.set_num_threads(threads)
    out = capsys.readouterr().out
    assert "profiling (a) streams equal on and off" in out
    assert "past the spent budget: 409" in out
    assert "calibration_reused 1, 4 streams equal" in out
    assert "respawn to rejoin with the snapshot" in out
    assert '"serve_ttft_p99_ms"' in out


def test_bench_phases_rehearse_on_the_cpu(capsys):
    """Phases 6f and 4h at the tiny scale on the plain route, every CPU
    gate included: the table round trip and the routing under it, the
    engine arms' keys and serve_batch against generate."""
    import torch

    from workloads_torch import model as model_mod
    from workloads_torch import perfbench as pb
    from workloads_torch.ops import attention as fa
    from workloads_torch.ops import kernel_select as ks
    from workloads_torch.ops import paged_attention as pa

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        counters = chip_smoke.kernel_counters(pa, fa)
        launches, train = chip_smoke.bench_kernel_phase(
            torch, pb, ks, model_mod, fa, counters, phase6=(20.0, 0.1),
            scale_name="tiny", device="cpu")
        chip_smoke.bench_engine_phase(
            torch, pb, counters, device="cpu",
            arms=("measure_fault_recovery", "measure_multi_lora",
                  "measure_prefix_serve", "measure_kv_hierarchy"))
    finally:
        torch.set_num_threads(threads)
    out = capsys.readouterr().out
    assert train["mfu"] is None and train["device_name"] == "cpu"
    assert ks.kernel_table() is None  # the phase put the table back
    assert "model._pick_kernel under set_kernel_table" in out
    assert "beside phase 6 (CUDA events, mean of 3): 20.0 ms" in out
    assert "measure_kv_hierarchy (" in out and "kv_offload_reload_ms" in out
    assert "serve_batch float32, 2 rows x 10 tokens: equal to generate True" in out
    assert set(launches) == {"paged_attention", *chip_smoke.FLASH_KERNELS}


def test_bench_fleet_phase_rehearses_on_the_cpu(capsys):
    """Phase 4i at the tiny scale on the plain route, every CPU gate
    included: each fleet arm's keys, JAX's value assertions over them
    and every compared stream whole (tiny computes in float32)."""
    import torch

    from workloads_torch import perfbench as pb
    from workloads_torch.ops import attention as fa
    from workloads_torch.ops import paged_attention as pa

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        launches = chip_smoke.bench_fleet_phase(
            torch, pb, chip_smoke.kernel_counters(pa, fa), device="cpu")
    finally:
        torch.set_num_threads(threads)
    out = capsys.readouterr().out
    for name in chip_smoke.BENCH_FLEET_KEYS:
        assert f"  {name} (" in out, name
    assert "peak device memory not measured (no card)" in out
    assert "JAX's value assertions and the whole-stream counts hold" in out
    assert set(launches) == {"paged_attention", *chip_smoke.FLASH_KERNELS}


def test_bench_fleet_gates_name_what_fails():
    good = {
        "fleet_replicas": 4, "fleet_tokens_per_sec": 1.0, "failover_recovery_ms": 1.0,
        "failover_requeued": 6, "selfheal_restore_ms": 1.0,
        "selfheal_capacity_recovered": 1.0, "selfheal_goodput_retained": 1.0,
        "selfheal_crash_loops": 1, "replica_restore_warm_ms": 1.0,
        "replica_restore_cold_ms": 1.0, "kvsched_busy_fraction": 0.9,
        "kvsched_goodput_fraction": 1.0, "kvsched_page_dispatches": 42,
        "kvsched_offload_spills": 3, "kvsched_page_waste_pct": 42.35, "disagg_handoffs": 8,
        "autoscale_preempts": 2, "failover_replay_streams_equal": 24,
        "failover_replay_streams": 24, "disagg_streams_equal": 16, "disagg_streams": 16,
        "selfheal_replay_streams_equal": 24,
        "selfheal_replay_streams": 24, "autoscale_preempt_streams_equal": 8,
        "autoscale_preempt_streams": 8, "durable_replay_streams_equal": 12,
        "durable_replay_streams": 12, "ctrl_streams_equal": 24, "ctrl_streams": 24,
    }
    assert chip_smoke.bench_fleet_gates(good) == []
    bad = dict(good, fleet_replicas=3, selfheal_crash_loops=0, ctrl_streams_equal=23)
    assert chip_smoke.bench_fleet_gates(bad) == [
        "fleet_replicas == 4", "selfheal_crash_loops == 1",
        "ctrl_streams_equal == ctrl_streams"]
