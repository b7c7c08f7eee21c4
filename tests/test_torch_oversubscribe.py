"""The port's oversubscription harness (workloads_torch.oversubscribe) on
the CPU: tests/test_oversubscribe.py's three cases at the JAX shapes and
threshold, with ``platform="cpu"`` (real gRPC admission through the
daemon's plugin, real subprocess pods of ``workloads_torch.busy_probe``
interleaving through the cooperative chip lease), the Allocate
environments chip_smoke.py's phase 7 holds for a card whose host cannot
run the daemon's API, and the refusal to put more chips than cards on
``cuda``.

The pods run one torch thread each (``OMP_NUM_THREADS=1``): busy time is
lease-held time, so threads change how much work a burst does, not the
fraction, and four pods of all the cores each would crowd the other
test workers.
"""

from __future__ import annotations

import json

import grpc
import pytest

import chip_smoke
from workloads_torch import busy_probe
from workloads_torch import oversubscribe as ov
from workloads_torch.oversubscribe import BASELINE_BUSY_FRACTION, run


@pytest.fixture(autouse=True)
def one_thread_pods(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def test_oversubscribed_pods_hit_busy_target():
    agg = run(
        n_chips=2,
        chips_per_tray=2,
        replicas=2,
        n_pods=4,
        duration_secs=3.0,
        matrix_dim=256,
        platform="cpu",
    )
    assert agg["pods"] == 4
    assert agg["chips"] == 2
    # Every pod leased exactly one chip, two pods per chip.
    assert set(agg["per_chip_busy_fraction"]) == {"tpu-0", "tpu-1"}
    assert agg["aggregate_busy_fraction"] >= BASELINE_BUSY_FRACTION
    assert len(agg["per_pod"]) == 4 and all(p["bursts"] >= 1 for p in agg["per_pod"])
    assert all(p["peak_memory_bytes"] is None for p in agg["per_pod"])
    assert all(p["k1_launches"] == 0 for p in agg["per_pod"])  # read; off the card none


def test_oversubscribed_serve_pods_report_tokens():
    """Serving pods time-slice too: the 'serve' workload runs full
    requests through the continuous-batching engine per burst and the
    aggregate carries generated tokens/s next to the busy fraction."""
    agg = run(
        n_chips=1,
        chips_per_tray=1,
        replicas=2,
        n_pods=2,
        duration_secs=3.0,
        platform="cpu",
        workload="serve",
    )
    assert agg["pods"] == 2 and agg["chips"] == 1
    assert agg["aggregate_busy_fraction"] >= BASELINE_BUSY_FRACTION
    assert agg["tokens"] > 0 and agg["aggregate_tokens_per_sec"] > 0


def test_aggregate_per_chip_union_window(tmp_path):
    """Per-chip busy fractions use the union wall window of the pods that
    used the chip, so staggered pod start-up does not deflate the metric."""
    report = tmp_path / "stats.jsonl"
    rows = [
        # chip-a: two pods, staggered by 2s, each 90% busy over 4s windows.
        {"chips": ["a"], "busy_secs": 2.0, "wall_secs": 4.0, "t_end": 104.0},
        {"chips": ["a"], "busy_secs": 3.4, "wall_secs": 4.0, "t_end": 106.0},
        # chip-b: one pod, fully busy.
        {"chips": ["b"], "busy_secs": 4.0, "wall_secs": 4.0, "t_end": 104.0},
    ]
    report.write_text("".join(json.dumps(r) + "\n" for r in rows))
    agg = busy_probe.aggregate(str(report))
    assert agg["pods"] == 3
    assert agg["chips"] == 2
    # chip-a union window: [100, 106] = 6s, busy 5.4 -> 0.9
    assert abs(agg["per_chip_busy_fraction"]["a"] - 0.9) < 1e-9
    assert agg["per_chip_busy_fraction"]["b"] == 1.0
    assert abs(agg["aggregate_busy_fraction"] - 0.95) < 1e-9


def _admitted(n_chips, chips_per_tray, replicas, n_pods, tmp):
    from tpu_device_plugin.api import pb, rpc

    plugin, manager, kubelet_server = ov._start_stack(n_chips, chips_per_tray, replicas, tmp)
    try:
        channel = grpc.insecure_channel(f"unix:{plugin.socket_path}")
        try:
            grpc.channel_ready_future(channel).result(timeout=5)
            return ov._admit_pods(rpc.DevicePluginStub(channel), pb, n_pods)
        finally:
            channel.close()
    finally:
        plugin.stop()
        kubelet_server.stop(grace=0.2).wait()
        manager.shutdown()


@pytest.mark.parametrize("arm", sorted(chip_smoke.BUSY["arms"]))
def test_held_pod_envs_equal_the_daemons_allocate(arm):
    """chip_smoke.py's held environments for each phase-7 layout are what
    the daemon's Allocate returns for it, lease directory aside."""
    import shutil
    import tempfile

    busy, spec = chip_smoke.BUSY, chip_smoke.BUSY["arms"][arm]
    tmp = tempfile.mkdtemp(prefix="tdp-")  # unix sockets: keep the path short
    try:
        got = _admitted(busy["n_chips"], busy["chips_per_tray"], spec["replicas"],
                        spec["pods"], tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    want = chip_smoke.held_pod_envs(spec["pods"], "LEASES")
    assert [dict(env, TPU_SHARED_LEASE_DIR="LEASES") for env in got] == want
    assert all(env["TPU_SHARED_LEASE_DIR"].startswith(tmp) for env in got)


def test_run_pods_refuses_more_chips_than_cards(tmp_path, monkeypatch):
    """One card is one chip: pods of two chips on one card (or of one
    chip on none) are refused before any pod starts."""
    import torch

    envs = [dict(env, TPU_VISIBLE_CHIPS=chip) for env, chip in
            zip(chip_smoke.held_pod_envs(2, str(tmp_path / "leases")), ("tpu-0", "tpu-1"))]
    for cards, pods in ((1, envs), (0, envs[:1])):
        monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
        with pytest.raises(ValueError, match=r"one card is one chip"):
            ov.run_pods(pods, str(tmp_path), platform="cuda")
        with pytest.raises(ValueError, match=r"one card is one chip"):
            ov.run_pods(pods, str(tmp_path))  # None means cuda
    assert list(tmp_path.iterdir()) == []
