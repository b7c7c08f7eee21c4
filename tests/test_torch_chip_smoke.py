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
         "Li128ELi1ELb0EEEvNS_6ParamsE", "paged_decode_kernel<bf16, 128, 1, false>"),
        ("_ZN46_GLOBAL__N__1_18_paged_attention_cu_219paged_decode_kernelIfLi16ELi8ELb1EEEv"
         "NS_6ParamsE", "paged_decode_kernel<float, 16, 8, true>"),
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
    from workloads_torch import prng
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
        params = cast_params(init_params(config, prng.PRNGKey(0, device="cpu")),
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

    from workloads_torch import prng
    from workloads_torch.model import ModelConfig, cast_params, init_params
    from workloads_torch.ops import attention as fa
    from workloads_torch.ops import paged_attention as pa

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        config = ModelConfig(vocab_size=256, d_model=64, n_heads=4, n_layers=2, d_ff=128,
                             max_seq_len=64, dtype=torch.bfloat16)
        params = cast_params(init_params(config, prng.PRNGKey(0, device="cpu")),
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

    from workloads_torch import prng
    from workloads_torch.model import ModelConfig, cast_params, init_params
    from workloads_torch.ops import attention as fa
    from workloads_torch.ops import paged_attention as pa

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        config = ModelConfig(vocab_size=256, d_model=64, n_heads=4, n_layers=2, d_ff=128,
                             max_seq_len=64, dtype=torch.float32)
        params = cast_params(init_params(config, prng.PRNGKey(0, device="cpu")),
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
    except SystemExit:
        # chip_smoke.fail names the failing gates on stderr: make them the
        # failure's own message.
        pytest.fail(capsys.readouterr().err.strip())
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


# Phase 4j at a tiny width: two gloo ranks on the CPU.
TP_TINY = dict(d_model=64, n_heads=4, n_layers=2, d_ff=128, vocab_size=256, page_size=4,
               decode_prompt=8, decode_lens=(8, 16), slots=2)


def test_tp_phase_rehearses_on_the_cpu(capsys):
    """Phase 4j on a 2-rank gloo CPU world at a tiny width, every CPU
    gate included: each rank's float32 streams of the four arms equal
    one device's, no page kept, the bf16 step within sqrt 2 of its floor
    and the float32 step within STEP_F32_RTOL."""
    import numpy as np
    import torch

    f = dict(chip_smoke.FULL, **TP_TINY)
    rng = np.random.default_rng(0)
    requests = [(rng.integers(0, 256, 8), n) for n in (8, 16, 12, 6, 16)]
    tp = dict(chip_smoke.TP, step_lengths=(8, 13, 23, 1), timeout_s=300)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        launches = chip_smoke.tp_phase(torch, f, requests, tp=tp, device="cpu")
    finally:
        torch.set_num_threads(threads)
    out = capsys.readouterr().out
    for r in range(2):
        assert f"rank {r} (gloo): K1 launches" in out
        assert "] float32 " in out and f" ms (mean of {tp['all_reduces']})" in out
        assert f"rank {r} bf16 step vs one device's float32 step" in out
    assert "peak device memory not measured (no card)" in out
    assert "equal one device's on every rank, the bf16 step within sqrt 2 of its floor" in out
    assert launches == 0  # off the card K1's plain version runs, uncounted


def _tp_results(streams, k1=5, pages=0, s32=0.0, s16=0.0):
    import numpy as np

    arms = {name: {"streams": [list(s) for s in streams],
                   "statuses": ["ok"] * len(streams), "used_pages": pages, "k1": k1,
                   "seconds": 1.0} for name in chip_smoke.TP_ARMS}
    return {"arms": arms, "steps": {"torch.float32": np.full(4, s32),
                                    "torch.bfloat16": np.full(4, s16)}}


def test_tp_gates_name_what_fails():
    streams = [[1, 2, 3], [4, 5]]
    one = _tp_results(streams, s16=0.1)  # the bf16 floor: 0.1, max and rms
    good = _tp_results(streams, s32=0.001, s16=0.14)
    assert chip_smoke.tp_gates(one, [good, good], f32_tol=0.01) == []
    bad = _tp_results(streams, s32=0.02, s16=0.15)
    bad["arms"][chip_smoke.TP_ARMS[2]]["streams"][1] = [4, 6]
    bad["arms"][chip_smoke.TP_ARMS[3]]["k1"] = 0
    bad["arms"][chip_smoke.TP_ARMS[1]]["used_pages"] = 3
    failed = chip_smoke.tp_gates(one, [good, bad], f32_tol=0.01)
    assert failed == [
        "(b) superstep_k=4 pipelined rank 1: 3 pages in use after drain",
        "(c) int8 self-draft gamma 4 rank 1: streams [1] differ from one device's",
        "(d) two adapters and the base rank 1: K1 launched 0 times",
        "float32 step rank 1: 2.0000e-02 from one device's (limit 1.0000e-02)",
        "bf16 step rank 1: max 1.5000e-01 rms 1.5000e-01 from one device's float32 step "
        "(limits: sqrt 2 x the bf16 floor, max 1.0000e-01 rms 1.0000e-01)",
    ]
    # Off the card K1 counts nothing, and that is no failure.
    assert chip_smoke.tp_gates(one, [good, _tp_results(streams, k1=0, s16=0.1)], 0.01,
                               card=False) == []


# Phase 6g at a tiny width: 2 layers of d_model 64 and 4 heads at 33
# tokens, so the 2-rank seq axis cuts 32 positions.
TRAIN_PAR_TINY = dict(d_model=64, n_heads=4, n_layers=2, d_ff=128, vocab_size=256)


def test_train_parallel_phase_rehearses_on_the_cpu(capsys):
    """Phase 6g on a 2-rank gloo CPU world at a tiny width, every CPU
    gate included: each arm's first float32 loss within 2^-16 of one
    device's, its later steps' drops from it within 2^-10 (float32) and
    2^-8 (bf16) of one device's, the control (TP2 without the enter hook)
    outside both drop gates, its bf16 per-token NLL within sqrt 2
    of the floor and its bf16 loss falling (AdamW at 1e-3 here, so three
    steps move it)."""
    import torch

    f = dict(chip_smoke.FULL, **TRAIN_PAR_TINY)
    tp = dict(chip_smoke.TRAIN_PAR, max_seq_len=33, timeout_s=300)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        launches = chip_smoke.train_parallel_phase(torch, f, tp=tp, lr=1e-3, device="cpu")
    finally:
        torch.set_num_threads(threads)
    out = capsys.readouterr().out
    for r in range(2):
        for name in {**chip_smoke.TRAIN_PAR_ARMS, **chip_smoke.TRAIN_PAR_CONTROL}:
            assert f"rank {r} {name}: rows " in out
        assert f"rank {r} (gloo): one all-reduce of [4, 32, 64] bf16" in out
    assert "peak device memory not measured (no card)" in out
    assert "per-token NLL within sqrt 2 of the floor, its bf16 loss falling" in out
    # Off the card the flash wrappers run their plain versions, uncounted.
    assert launches == {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}


DRAWS_TINY = dict(vocab_size=256, train_seq=64, train_batch=2, decode_prompt=8, slots=2)


def test_prng_draw_checks_rehearse_on_the_cpu(capsys):
    """Phase 4k's draws, ``device="cpu"`` against the CPU at a tiny
    width: every draw and seed form runs and compares equal."""
    import torch

    f = dict(chip_smoke.FULL, **DRAWS_TINY)
    n = chip_smoke.prng_draw_checks(torch, f, device="cpu", scale_name="tiny")
    assert n == 1 + len(chip_smoke.DRAW_PROMPT_SEEDS) + 1 + 3
    out = capsys.readouterr().out
    assert "draws on cpu = the CPU's bit for bit: synthetic_batch [2, 64] (vocab 256)" in out
    assert "_rand_qkv(128, 2) q, k and v in bf16" in out


def test_prng_draw_checks_fail_on_a_parted_draw(monkeypatch, capsys):
    """A prompt whose list is not its key's draw fails the phase."""
    import torch

    from workloads_torch import perfbench as pb

    prompt = pb._prompt
    monkeypatch.setattr(pb, "_prompt", lambda seed, length, vocab: [
        (t + (seed == (23, 0))) % vocab for t in prompt(seed, length, vocab)])
    with pytest.raises(SystemExit):
        chip_smoke.prng_draw_checks(torch, dict(chip_smoke.FULL, **DRAWS_TINY),
                                    device="cpu", scale_name="tiny")
    assert "4k _prompt((23, 0)): the draw on cpu differs from the CPU's" in \
        capsys.readouterr().err


def test_vision_phase_rehearses_on_the_cpu(capsys):
    """Phase 6i on the CPU: the CLI at 5 steps, JAX's 30-step procedure,
    every gate (the tree and batch, trivially equal here; both losses
    falling)."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        launches = chip_smoke.vision_phase(torch, "cpu rehearsal",
                                           dict(chip_smoke.VISION, steps=5), device="cpu")
    finally:
        torch.set_num_threads(threads)
    out = capsys.readouterr().out
    assert "PRNGKey(0) tree on cpu: max 0 ulp from the CPU's (limit 4); images for seed 1 " \
        "[64, 28, 28, 1] bit-identical, labels equal" in out
    assert "vision.main --steps 5 --batch-size 64: loss " in out
    assert "peak device memory not measured (no card)" in out
    assert "30 steps on one batch of 64 (JAX's test_training_reduces_loss)" in out
    assert launches == 0  # off the card the hash runs its plain version, uncounted


def _par_rank(loss32=(5.0, 4.9, 4.8), nll16=0.1, losses=(3.0, 2.9, 2.8), launches=6):
    import numpy as np

    arms = {name: {"rows": (0, 2), "losses_f32": list(loss32), "losses_bf16": list(losses),
                   "nll_bf16": np.full((2, 4), nll16),
                   "launches": dict.fromkeys(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"),
                                             0 if "ring" in name else launches)}
            for name in {**chip_smoke.TRAIN_PAR_ARMS, **chip_smoke.TRAIN_PAR_CONTROL}}
    # The control's later steps stray from one device's, as a wrong
    # gradient makes them.
    control = arms[next(iter(chip_smoke.TRAIN_PAR_CONTROL))]
    control["losses_f32"] = [loss32[0]] + [x + 0.1 for x in loss32[1:]]
    control["losses_bf16"] = [losses[0]] + [x + 0.1 for x in losses[1:]]
    return {"arms": arms}


def test_train_parallel_gates_name_what_fails():
    import numpy as np

    one = {"losses_f32": [5.0, 4.9, 4.8], "losses_bf16": [3.0, 2.9, 2.8],
           "nll_f32": np.zeros((2, 4)), "nll_bf16": np.full((2, 4), 0.1)}
    good = _par_rank(nll16=0.14)
    assert chip_smoke.train_par_gates(one, [good, good], n_layers=2, steps=3) == []
    bad = _par_rank(loss32=(5.001, 4.9, 4.8), nll16=0.15)
    bad["arms"]["(b) TP2"]["losses_bf16"] = [3.0, 3.1, 3.2]
    bad["arms"]["(c) Ulysses sp2"]["launches"]["flash_bwd_dq"] = 0
    control = next(iter(chip_smoke.TRAIN_PAR_CONTROL))
    bad["arms"][control]["losses_bf16"] = [3.0, 2.9, 2.8]
    failed = chip_smoke.train_par_gates(one, [good, bad], n_layers=2, steps=3)
    assert failed[0].startswith(f"{control} rank 1: the control passed a drop gate")
    assert failed[1] == "(a) DP2 rank 1: float32 first-step loss 5.001 against one device's 5.0"
    assert failed[2].startswith("(a) DP2 rank 1: f32 losses [5.001, 4.9, 4.8], drops from the "
                                "first step 1.00e-02, 5.00e-03 off one device's [5.0, 4.9, 4.8] "
                                "(limit 9.77e-04)")
    assert "(a) DP2 rank 1: bf16 per-token NLL max 1.5000e-01 rms 1.5000e-01" in failed[3]
    assert any(m.startswith("(b) TP2 rank 1: bf16 losses [3.0, 3.1, 3.2], drops from the "
                            "first step 2.00e+00, 2.00e+00 off") for m in failed)
    assert "(b) TP2 rank 1: bf16 losses [3.0, 3.1, 3.2] did not fall" in failed
    assert any(m.startswith("(c) Ulysses sp2 rank 1: K2-K4 launches") for m in failed)
    del bad["arms"][control]
    assert f"{control} rank 1: the control did not run" in \
        chip_smoke.train_par_gates(one, [good, bad], n_layers=2, steps=3)
    # Off the card the kernels count nothing, and that is no failure.
    off = _par_rank(nll16=0.14, launches=0)
    assert chip_smoke.train_par_gates(one, [off, off], 2, 3, card=False) == []


def test_pp_ep_phase_rehearses_on_the_cpu(capsys):
    """Phase 6h on a 2-rank gloo CPU world at a tiny width, every CPU gate
    included: each arm's first float32 loss within 2^-16 of one device's,
    its later steps' drops within 2^-10 (float32) and 2^-8 (bf16) of one
    device's, its bf16 loss falling, its replicated leaves bit-identical
    across the ranks, and each control outside a drop gate (AdamW at 1e-3
    here, so three steps move it)."""
    import torch

    f = dict(chip_smoke.FULL, **TRAIN_PAR_TINY)
    tp = dict(chip_smoke.PP_EP, max_seq_len=33, timeout_s=300)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        launches = chip_smoke.pp_ep_phase(torch, f, tp=tp, lr=1e-3, device="cpu")
    finally:
        torch.set_num_threads(threads)
    out = capsys.readouterr().out
    for r in range(2):
        for name in {**chip_smoke.PP_EP_ARMS, **chip_smoke.PP_EP_CONTROLS}:
            assert f"rank {r} {name}: float32 losses " in out
        assert f"rank {r} (gloo): one hand-off of a [1, 32, 64] bf16 microbatch" in out
    assert "peak device memory not measured (no card)" in out
    assert "its replicated leaves bit-identical across the ranks; each control" in out
    # Off the card the flash wrappers run their plain versions, uncounted.
    assert launches == {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}


def _pp_ep_rank(loss32=(5.0, 4.9, 4.8), losses=(3.0, 2.9, 2.8), launches=None, digest="a"):
    f = dict(chip_smoke.FULL, **TRAIN_PAR_TINY)
    arms = {}
    for name, arm in {**chip_smoke.PP_EP_ARMS, **chip_smoke.PP_EP_CONTROLS}.items():
        n = chip_smoke.pp_ep_launches(arm, f, chip_smoke.PP_EP) if launches is None else launches
        arms[name] = {"losses_f32": list(loss32), "losses_bf16": list(losses),
                      "digests_f32": {"embed": digest}, "digests_bf16": {"embed": digest},
                      "launches": dict.fromkeys(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"),
                                                n)}
        if name in chip_smoke.PP_EP_CONTROLS:
            # A wrong gradient moves the later steps away from one device's.
            arms[name]["losses_f32"] = [loss32[0]] + [x + 0.1 for x in loss32[1:]]
    return {"arms": arms}


def test_pp_ep_gates_name_what_fails():
    f = dict(chip_smoke.FULL, **TRAIN_PAR_TINY)
    ref = {"losses_f32": [5.0, 4.9, 4.8], "losses_bf16": [3.0, 2.9, 2.8]}
    one = {"pp": ref, "ep": ref}
    tp = chip_smoke.PP_EP
    assert chip_smoke.pp_ep_launches("pp", f, tp) == (4 + 2 - 1) * 1 * 3
    assert chip_smoke.pp_ep_launches("ep", f, tp) == 2 * 3
    good = _pp_ep_rank()
    assert chip_smoke.pp_ep_gates(one, [good, good], f, tp) == []
    bad = _pp_ep_rank(digest="b")
    bad["arms"]["(e) PP2"]["losses_bf16"] = [3.0, 3.1, 3.2]
    bad["arms"]["(f) EP2"]["launches"]["flash_bwd_dkv"] = 0
    control = "(f0) EP2 without f on the dispatch input, control"
    bad["arms"][control]["losses_f32"] = [5.0, 4.9, 4.8]
    failed = chip_smoke.pp_ep_gates(one, [good, bad], f, tp)
    assert failed[0] == f"{control} rank 1: the control passed both drop gates"
    assert any(m.startswith("(e) PP2 rank 1: bf16 losses [3.0, 3.1, 3.2], drops") for m in failed)
    assert "(e) PP2 rank 1: bf16 losses [3.0, 3.1, 3.2] did not fall" in failed
    assert "(e) PP2 rank 1: replicated leaves ['embed'] differ from rank 0's after the f32 " \
           "steps" in failed
    assert any(m.startswith("(f) EP2 rank 1: K2-K4 launches") for m in failed)
    # Off the card the kernels count nothing, and that is no failure.
    off = _pp_ep_rank(launches=0)
    assert chip_smoke.pp_ep_gates(one, [off, off], f, tp, card=False) == []


BUSY_TINY = dict(chip_smoke.BUSY, duration=2.0, in_process_burst_secs=0.1,
                 arms={name: dict(arm, pods=2, replicas=2, matrix_dim=64)
                       for name, arm in chip_smoke.BUSY["arms"].items()})


def _busy_rehearsal(monkeypatch, busy):
    import torch

    from workloads_torch.ops import attention as fa
    from workloads_torch.ops import paged_attention as pa

    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the pods' torch threads
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return chip_smoke.busy_phase(torch, chip_smoke.kernel_counters(pa, fa), busy,
                                     device="cpu")
    finally:
        torch.set_num_threads(threads)


def test_busy_phase_rehearses_on_the_cpu(monkeypatch, capsys):
    """Phase 7 on the CPU with two pods an arm and 2 s windows, every
    gate included, the pods under the held Allocate environments."""
    # Off the card K1 counts nothing, in this process or in the pods.
    assert _busy_rehearsal(monkeypatch, BUSY_TINY) == (0, 0)
    out = capsys.readouterr().out
    for name, arm in BUSY_TINY["arms"].items():
        assert f"  {name}: 2 {arm['workload']} pods at replicas 2 on 1 chip, 2.0 s windows: " \
               "aggregate busy fraction " in out
    assert "pod 1: " in out and "K1 launches 0, peak device memory not measured (no card)" in out
    for workload in ("matmul", "train", "serve"):
        assert f"  in-process {workload} burst: wall " in out
    assert "device time not measured (no card)" in out
    assert "  sharing phase: " in out


def test_busy_gates_name_what_fails():
    arm = chip_smoke.BUSY["arms"]["(b) train"]
    good = {"pods": 4, "chips": 1, "aggregate_busy_fraction": 0.95, "tokens": 10}
    assert chip_smoke.busy_gates("(b)", arm, good, 1, 0.9, True) == []
    bad = {"pods": 3, "chips": 2, "aggregate_busy_fraction": 0.85}
    assert chip_smoke.busy_gates("(b)", arm, bad, 1, 0.9, True) == [
        "(b): 3 pods on 2 chips, asked 4 on 1",
        "(b): aggregate busy fraction 0.85 under 0.9",
        "(b): no tokens",
    ]
    matmul = chip_smoke.BUSY["arms"]["(a) matmul"]
    assert chip_smoke.busy_gates("(a)", matmul, dict(good, tokens=0), 1, 0.9, True) == []
    # On the card every serving pod must have launched K1; off it none can.
    serve = chip_smoke.BUSY["arms"]["(c) serve"]
    pods = dict(good, pods=2, per_pod=[{"k1_launches": 96}, {"k1_launches": 0}])
    assert chip_smoke.busy_gates("(c)", serve, pods, 1, 0.9, True) == [
        "(c): pod 1 launched no K1 (0)"]
    assert chip_smoke.busy_gates("(c)", serve, pods, 1, 0.9, False) == []
    unread = dict(pods, per_pod=[{"k1_launches": 96}, {"k1_launches": None}])
    assert chip_smoke.busy_gates("(c)", serve, unread, 1, 0.9, True) == [
        "(c): pod 1 launched no K1 (None)"]
