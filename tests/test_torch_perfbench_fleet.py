"""perfbench's fleet arms (workloads_torch/perfbench.py ``measure_fleet``,
``measure_disagg``, ``measure_selfheal``, ``measure_autoscale``,
``measure_kv_sched``, ``measure_durability``, ``measure_goodput_ctrl``)
at the tiny scale on the CPU, one by one.

Each arm runs once (a module fixture); its keys and the JAX package's
own value assertions (tests/test_perfbench.py) are checked, every
stream it compares is held whole (``tiny`` computes in float32), and
the fields that the schedule alone fixes are held to a frozen JAX
``tiny`` run, tests/test_torch_perfbench_fleet_golden.json, which
``python tests/test_torch_parity.py --write-goldens`` writes
(``write_perfbench_fleet_goldens()`` alone rewrites only it).  Left out
of the goldens: every time, rate, ratio, latency and busy share (a CPU
timing is not a device number, and the fleet ledger's busy time is a
wall clock); the autoscaler's calm rate, actuation counts, recovery and
overprovision, which follow the host's measured service rate; and every
``ctrl_*`` field, because JAX's own ``measure_goodput_ctrl`` at ``tiny``
computes in bf16 and parts its controlled and static streams on the CPU,
so it raises before it publishes (its keys and value checks are held
here all the same).

Also here: the replay check the arms that replay share
(``_hold_replay``), and each arm's refusal to run off the card unless
asked.  ``run()``'s pooled spreads of ``durable_restore_ms``,
``kv_disk_reload_ms`` and ``ctrl_vs_static_tokens_per_sec`` with a prior
artifact's samples are checked on the one ``run("tiny")`` of
tests/test_torch_perfbench.py, so that no third run is needed.  Imports
only workloads_torch, numpy and pytest.
"""

import json
import os

import pytest
import torch

from tests.test_torch_superstep import one_torch_thread  # noqa: F401
from workloads_torch import perfbench as pb

FLEET_GOLDEN = os.path.join(os.path.dirname(__file__), "test_torch_perfbench_fleet_golden.json")

ARMS = ("measure_fleet", "measure_disagg", "measure_selfheal", "measure_autoscale",
        "measure_kv_sched", "measure_durability", "measure_goodput_ctrl")

# The fields a tiny run's schedule fixes, by arm, held to JAX's.
GOLDEN_FIELDS = {
    "measure_fleet": ("fleet_replicas", "fleet_requests", "fleet_slo_requests_interactive",
                      "fleet_slo_requests_bulk", "failover_requeued"),
    "measure_disagg": ("disagg_replicas", "disagg_roles", "disagg_requests",
                       "disagg_schedule_stats", "disagg_handoffs"),
    "measure_selfheal": ("selfheal_replicas", "selfheal_requests", "selfheal_crash_loops"),
    "measure_autoscale": ("autoscale_replicas_min", "autoscale_replicas_max",
                          "autoscale_requests", "autoscale_spike_factor",
                          "autoscale_preempts"),
    "measure_kv_sched": ("kvsched_replicas", "kvsched_requests", "kvsched_page_waste_pct",
                         "kvsched_replica_sched_page_waste_pct", "kvsched_page_dispatches",
                         "kvsched_offload_spills"),
    "measure_durability": ("durable_replicas", "durable_requests",
                           "durable_sessions_per_hbm_page"),
}

# Every key an arm publishes at the tiny scale (JAX's, and the port's
# counts of the streams a replay kept whole).
KEYS = {
    "measure_fleet": (
        "fleet_replicas", "fleet_requests", "fleet_tokens_per_sec", "fleet_ttft_p50_ms",
        "fleet_ttft_p99_ms", "router_overhead_ms", "router_overhead_ms_min",
        "router_overhead_ms_max", "failover_recovery_ms", "failover_recovery_ms_min",
        "failover_recovery_ms_max", "failover_requeued", "failover_replay_streams_equal",
        "failover_replay_streams", "fleet_trace_overhead_pct", "fleet_trace_overhead_pct_min",
        "fleet_trace_overhead_pct_max", "fleet_trace_on_tokens_per_sec",
        "fleet_trace_off_tokens_per_sec", "fleet_slo_attainment_interactive",
        "fleet_slo_burn_rate_interactive", "fleet_slo_requests_interactive",
        "fleet_interactive_ttft_p99_ms", "fleet_interactive_tpot_p99_ms",
        "fleet_slo_attainment_bulk", "fleet_slo_burn_rate_bulk", "fleet_slo_requests_bulk",
        "fleet_bulk_ttft_p99_ms", "fleet_bulk_tpot_p99_ms"),
    "measure_disagg": (
        "disagg_replicas", "disagg_roles", "disagg_requests", "disagg_schedule_stats",
        "disagg_handoffs", "disagg_handoff_pages", "disagg_handoff_ms",
        "disagg_handoff_ms_min", "disagg_handoff_ms_max", "disagg_vs_mixed_tokens_per_sec",
        "disagg_vs_mixed_tokens_per_sec_min", "disagg_vs_mixed_tokens_per_sec_max",
        "disagg_attainment_interactive", "disagg_attainment_delta_interactive",
        "disagg_attainment_bulk", "disagg_attainment_delta_bulk", "disagg_streams_equal",
        "disagg_streams"),
    "measure_selfheal": (
        "selfheal_replicas", "selfheal_requests", "selfheal_restore_ms",
        "selfheal_restore_ms_min", "selfheal_restore_ms_max", "selfheal_capacity_recovered",
        "selfheal_goodput_retained", "selfheal_crash_loops", "selfheal_replay_streams_equal",
        "selfheal_replay_streams", "replica_restore_cold_ms", "replica_restore_warm_ms"),
    "measure_autoscale": (
        "autoscale_replicas_min", "autoscale_replicas_max", "autoscale_requests",
        "autoscale_spike_factor", "autoscale_calm_rps", "autoscale_service_rps",
        "autoscale_peak_rps", "autoscale_scale_ups", "autoscale_scale_downs",
        "autoscale_scaled_back", "autoscale_recover_slo_ms", "autoscale_recover_slo_ms_min",
        "autoscale_recover_slo_ms_max", "autoscale_overprovision_chip_s",
        "autoscale_preempts", "autoscale_preempt_resume_ms",
        "autoscale_preempt_streams_equal", "autoscale_preempt_streams"),
    "measure_kv_sched": (
        "kvsched_replicas", "kvsched_requests", "kvsched_tokens_per_sec",
        "kvsched_replica_sched_tokens_per_sec", "kvsched_vs_replica_tokens_per_sec",
        "kvsched_vs_replica_tokens_per_sec_min", "kvsched_vs_replica_tokens_per_sec_max",
        "kvsched_busy_fraction", "kvsched_goodput_fraction", "kvsched_page_waste_pct",
        "kvsched_replica_sched_page_waste_pct", "kvsched_page_dispatches",
        "kvsched_offload_spills"),
    "measure_durability": (
        "durable_replicas", "durable_requests", "durable_restore_ms", "durable_restore_ms_min",
        "durable_restore_ms_max", "durable_restore_ms_samples", "kv_disk_reload_ms",
        "kv_disk_reload_ms_samples", "durable_sessions_per_hbm_page",
        "durable_off_tokens_per_sec", "durable_replay_streams_equal",
        "durable_replay_streams"),
    "measure_goodput_ctrl": (
        "ctrl_replicas", "ctrl_requests", "ctrl_tokens_per_sec", "ctrl_static_tokens_per_sec",
        "ctrl_vs_static_tokens_per_sec", "ctrl_vs_static_tokens_per_sec_samples",
        "ctrl_goodput_fraction", "ctrl_static_goodput_fraction", "ctrl_retunes_applied",
        "ctrl_wfq_reweights", "ctrl_overhead_pct", "ctrl_overhead_pct_min",
        "ctrl_overhead_pct_max", "ctrl_overhead_pct_samples", "ctrl_streams_equal",
        "ctrl_streams"),
}

# (key, its total): every stream that the arm compares, whole at tiny.
WHOLE = {
    "measure_fleet": ("failover_replay_streams_equal", "failover_replay_streams"),
    "measure_disagg": ("disagg_streams_equal", "disagg_streams"),
    "measure_selfheal": ("selfheal_replay_streams_equal", "selfheal_replay_streams"),
    "measure_autoscale": ("autoscale_preempt_streams_equal", "autoscale_preempt_streams"),
    "measure_durability": ("durable_replay_streams_equal", "durable_replay_streams"),
    "measure_goodput_ctrl": ("ctrl_streams_equal", "ctrl_streams"),
}


@pytest.fixture(scope="module")
def arms():
    """Each arm once at the tiny scale on the CPU, by name."""
    scale = pb.BenchScale.named("tiny")
    return {name: getattr(pb, name)(scale, "cpu") for name in ARMS}


@pytest.fixture(scope="module")
def golden():
    with open(FLEET_GOLDEN, encoding="utf-8") as f:
        return json.load(f)


@pytest.mark.parametrize("name", ARMS)
def test_arm_publishes_its_keys(arms, name):
    got = arms[name]
    assert set(KEYS[name]) <= set(got), sorted(set(KEYS[name]) - set(got))


@pytest.mark.parametrize("name", sorted(WHOLE))
def test_arm_keeps_every_stream_whole_in_float32(arms, name):
    equal, total = WHOLE[name]
    assert arms[name][equal] == arms[name][total] > 0


@pytest.mark.parametrize("name", sorted(GOLDEN_FIELDS))
def test_arm_schedule_fields_equal_jax(arms, golden, name):
    want = golden[name]
    assert set(want) == set(GOLDEN_FIELDS[name])
    assert {k: arms[name][k] for k in GOLDEN_FIELDS[name]} == want


def test_fleet_values_hold_jax_assertions(arms):
    out = arms["measure_fleet"]
    assert out["fleet_replicas"] == 4
    assert out["fleet_tokens_per_sec"] > 0
    assert out["failover_recovery_ms"] > 0
    assert out["failover_requeued"] >= 1
    assert out["fleet_ttft_p50_ms"] <= out["fleet_ttft_p99_ms"]
    for key in ("router_overhead_ms", "fleet_trace_overhead_pct", "failover_recovery_ms"):
        assert out[f"{key}_min"] <= out[key] <= out[f"{key}_max"], key
    for name in ("interactive", "bulk"):
        assert 0.0 <= out[f"fleet_slo_attainment_{name}"] <= 1.0


def test_selfheal_values_hold_jax_assertions(arms):
    out = arms["measure_selfheal"]
    assert out["selfheal_restore_ms"] > 0
    assert out["selfheal_capacity_recovered"] == 1.0
    assert out["selfheal_goodput_retained"] == 1.0
    assert out["selfheal_crash_loops"] == 1
    assert out["replica_restore_warm_ms"] > 0
    assert out["replica_restore_cold_ms"] > 0


def test_disagg_moves_real_pages(arms):
    out = arms["measure_disagg"]
    assert out["disagg_roles"] == "prefill,decode,decode"
    assert out["disagg_handoffs"] >= 1 and out["disagg_handoff_pages"] >= 1
    assert out["disagg_handoff_ms_min"] <= out["disagg_handoff_ms"] <= out[
        "disagg_handoff_ms_max"]
    assert out["disagg_vs_mixed_tokens_per_sec"] > 0


def test_autoscale_scaled_and_preempted(arms):
    out = arms["measure_autoscale"]
    assert out["autoscale_scale_ups"] >= 1
    assert out["autoscale_recover_slo_ms"] >= 0
    assert out["autoscale_calm_rps"] == pytest.approx(
        max(1.0, 0.7 * out["autoscale_service_rps"]), abs=0.02)
    assert out["autoscale_preempts"] >= 1 and out["autoscale_preempt_resume_ms"] >= 0


def test_kv_sched_values_hold_jax_assertions(arms):
    out = arms["measure_kv_sched"]
    assert 0.0 < out["kvsched_busy_fraction"] <= 1.0
    assert 0.0 < out["kvsched_goodput_fraction"] <= 1.0
    assert out["kvsched_page_dispatches"] > 0
    assert out["kvsched_offload_spills"] >= 1
    assert 0.0 <= out["kvsched_page_waste_pct"] <= 100.0


def test_durability_restores_and_reloads(arms):
    out = arms["measure_durability"]
    assert len(out["durable_restore_ms_samples"]) == 3
    assert out["durable_restore_ms_min"] <= out["durable_restore_ms"] <= out[
        "durable_restore_ms_max"]
    assert out["kv_disk_reload_ms"] > 0 and out["durable_off_tokens_per_sec"] > 0


def test_goodput_ctrl_retunes_and_prices_its_polls(arms):
    out = arms["measure_goodput_ctrl"]
    assert out["ctrl_retunes_applied"] >= 1
    assert out["ctrl_goodput_fraction"] > out["ctrl_static_goodput_fraction"]
    assert len(out["ctrl_vs_static_tokens_per_sec_samples"]) == 3
    assert 0.0 <= out["ctrl_overhead_pct"] < 100.0
    assert "ctrl_parting_gap_max" not in out  # float32: no stream parts


@pytest.mark.parametrize("name", ARMS)
def test_entry_points_default_to_the_card(monkeypatch, name):
    """Without a card and without device="cpu" each fleet arm refuses
    to run instead of timing the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(pb, name)(pb.BenchScale.named("tiny"))


# ==== the replay check the arms that replay share

REF = {"a": [1, 2, 3, 4], "b": [5, 6, 7, 8]}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_replay_check_counts_whole_streams(dtype):
    assert pb._hold_replay({r: list(t) for r, t in REF.items()}, REF, {"a": 2}, dtype,
                           "x") == 2


def test_replay_check_keeps_bf16_streams_that_part_after_their_kept_tokens():
    got = {"a": [1, 2, 9, 9], "b": [5, 6, 7, 8]}
    assert pb._hold_replay(got, REF, {"a": 2}, torch.bfloat16, "x") == 1


def test_replay_check_holds_float32_streams_whole():
    got = {"a": [1, 2, 9, 9], "b": [5, 6, 7, 8]}
    with pytest.raises(RuntimeError, match="replay is supposed to be bit-identical"):
        pb._hold_replay(got, REF, {"a": 2}, torch.float32, "x")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("got", [
    {"a": [1, 2, 3], "b": [5, 6, 7, 8]},  # a token lost
    {"a": [1, 2, 3, 4], "b": [5, 6, 7, 8, 9]},  # a token too many
    {"a": [1, 7, 3, 4], "b": [5, 6, 7, 8]},  # a kept token changed
], ids=["lost", "extra", "kept-changed"])
def test_replay_check_raises_on_a_lost_or_changed_kept_token(dtype, got):
    with pytest.raises(RuntimeError, match="diverged|lost tokens"):
        pb._hold_replay(got, REF, {"a": 2}, dtype, "x")


def test_kept_at_requeue_records_the_first_requeue():
    class Req:
        def __init__(self, rid, n):
            self.rid, self.tokens = rid, [0] * n

    class FakeFleet:
        def _requeue_victims(self, victims, *, charge, error=None):
            return [v.rid for v in victims]

    fleet = FakeFleet()
    kept = pb._kept_at_requeue(fleet)
    assert fleet._requeue_victims([Req("a", 3), Req("b", 0)], charge=True) == ["a", "b"]
    fleet._requeue_victims([Req("a", 5)], charge=False)
    assert kept == {"a": 3, "b": 0}


# ==== the near-tie check of two runs whose programs differ


@pytest.fixture(scope="module")
def tiny_bf16():
    from workloads_torch.model import ModelConfig

    config = ModelConfig(vocab_size=256, d_model=64, n_heads=4, n_layers=2, d_ff=128,
                         max_seq_len=32, dtype=torch.bfloat16)
    return pb._params(config, 0, torch.device("cpu")), config


def test_top2_gap_and_floor_reads_the_float32_gap_and_the_bf16_floor(tiny_bf16):
    from dataclasses import replace

    params, config = tiny_bf16
    gap, limit = pb._top2_gap_and_floor(params, config, [1, 2, 3])
    assert gap >= 0 and limit > 0
    gap32, limit32 = pb._top2_gap_and_floor(
        params, replace(config, dtype=torch.float32), [1, 2, 3])
    assert gap32 == gap and limit32 == 0.0


def test_near_ties_count_whole_streams_and_take_a_parting_at_a_near_tie(
        tiny_bf16, monkeypatch):
    params, config = tiny_bf16
    seen = []

    def gap_and_floor(p, c, seq):
        seen.append(list(seq))
        return 0.01, 0.2

    monkeypatch.setattr(pb, "_top2_gap_and_floor", gap_and_floor)
    got = {"a": [1, 2, 3], "b": [4, 9, 9]}
    want = {"a": [1, 2, 3], "b": [4, 5, 6]}
    equal, partings = pb._hold_near_ties(params, config, got, want,
                                         {"a": [7], "b": [8, 8]}, "x")
    assert (equal, partings) == (1, [[0.01, 0.2]])
    assert seen == [[8, 8, 4]]  # the prompt and the tokens before the parting
    assert pb._parting_keys("p", partings) == {"p_parting_gap_max": 0.01,
                                               "p_parting_limit_min": 0.2}
    assert pb._parting_keys("p", []) == {}


def test_near_ties_refuse_a_parting_past_the_floor(tiny_bf16, monkeypatch):
    params, config = tiny_bf16
    monkeypatch.setattr(pb, "_top2_gap_and_floor", lambda p, c, seq: (0.5, 0.2))
    with pytest.raises(RuntimeError, match="not a near-tie"):
        pb._hold_near_ties(params, config, {"b": [4, 9]}, {"b": [4, 5]}, {"b": [8]}, "x")


def test_near_ties_refuse_a_changed_length_and_any_float32_parting(tiny_bf16):
    from dataclasses import replace

    params, config = tiny_bf16
    with pytest.raises(RuntimeError, match="streams diverged"):
        pb._hold_near_ties(params, config, {"b": [4, 5]}, {"b": [4, 5, 6]}, {"b": [8]}, "x")
    with pytest.raises(RuntimeError, match="streams diverged"):
        pb._hold_near_ties(params, replace(config, dtype=torch.float32), {"b": [4, 9]},
                           {"b": [4, 5]}, {"b": [8]}, "x")
