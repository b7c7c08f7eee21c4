"""Multi-host bring-up and meshes (workloads_torch/distributed.py,
train.make_mesh): two real processes join one gloo process group from
the daemon-injected slice env and all-reduce across it, as the JAX
package's tests/test_distributed.py does with jax.distributed; the slice
env's validation comes from the daemon's parser; and make_mesh and
global_mesh keep the JAX package's rules on 2- and 4-rank gloo CPU
worlds (tests/torch_tp_world.py)."""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import textwrap

import pytest
import torch

from tests import torch_tp_world as tw

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = textwrap.dedent(
    """
    import torch
    from workloads_torch.distributed import global_mesh, initialize_from_slice_env

    assert initialize_from_slice_env(device="cpu") is True
    rank = torch.distributed.get_rank()
    n = torch.distributed.get_world_size()
    mesh = global_mesh(device_type="cpu")
    assert dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)) == {"data": n, "model": 1}
    x = torch.full((4,), float(rank))
    torch.distributed.all_reduce(x, group=mesh.get_group("data"))
    assert torch.equal(x, torch.full((4,), float(sum(range(n))))), x
    print(f"worker {rank}: all_reduce over {n} processes ok", flush=True)
    # Both ranks leave the group together: worker 0 hosts the TCP store,
    # and a peer that loses it mid-teardown aborts.
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    """
)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_slice_bringup():
    port = free_port()
    procs = []
    for worker_id in range(2):
        env = dict(os.environ)
        env.update({
            # Exactly what the daemon stamps into slice containers
            # (slice_topology.container_slice_env) + the coordinator.
            "TPU_WORKER_ID": str(worker_id),
            "TPU_TOPOLOGY": "2x2x2",
            "TPU_HOST_BOUNDS": "1,1,2",
            "TPU_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
        })
        procs.append(subprocess.Popen(
            [sys.executable, "-c", WORKER], cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=120)
            outs.append(out)
    finally:
        # A hung worker must not outlive the test.
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    for worker_id, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {worker_id} failed:\n{out}"
        assert f"worker {worker_id}: all_reduce over 2 processes ok" in out


def test_single_host_env_is_noop():
    from workloads_torch.distributed import initialize_from_slice_env, slice_process_info

    assert slice_process_info({}) is None
    assert initialize_from_slice_env(environ={}) is False
    # A 1-host slice needs no process group either.
    env = {"TPU_WORKER_ID": "0", "TPU_TOPOLOGY": "2x2x1", "TPU_HOST_BOUNDS": "1,1,1"}
    assert initialize_from_slice_env(environ=env) is False


def test_malformed_slice_env_fails_loud():
    """Validation comes from the daemon's parser."""
    from tpu_device_plugin.slice_topology import SliceConfigError
    from workloads_torch.distributed import slice_process_info

    with pytest.raises(SliceConfigError, match="invalid TPU_WORKER_ID"):
        slice_process_info({"TPU_WORKER_ID": "x", "TPU_TOPOLOGY": "2x2x2",
                            "TPU_HOST_BOUNDS": "1,1,2"})
    with pytest.raises(SliceConfigError, match="outside host grid"):
        slice_process_info({"TPU_WORKER_ID": "7", "TPU_TOPOLOGY": "2x2x2",
                            "TPU_HOST_BOUNDS": "1,1,2"})


def test_missing_coordinator_fails_loud():
    from workloads_torch.distributed import initialize_from_slice_env

    env = {"TPU_WORKER_ID": "1", "TPU_TOPOLOGY": "2x2x2", "TPU_HOST_BOUNDS": "1,1,2"}
    with pytest.raises(ValueError, match="coordinator"):
        initialize_from_slice_env(environ=env, device="cpu")


def test_partial_slice_env_fails_loud():
    """worker-id/host-bounds without topology is a misconfiguration, not a
    single-host container: silent False would hang the rest of the slice."""
    from tpu_device_plugin.slice_topology import SliceConfigError
    from workloads_torch.distributed import slice_process_info

    with pytest.raises(SliceConfigError, match="partial slice env"):
        slice_process_info({"TPU_WORKER_ID": "1", "TPU_HOST_BOUNDS": "1,1,2"})


@pytest.mark.parametrize("env, want", [
    ({"TPU_COORDINATOR_ADDRESS": "10.0.0.1:1234"}, "tcp://10.0.0.1:1234"),
    ({"TPU_WORKER_HOSTNAMES": "host-0,host-1"}, "tcp://host-0:8476"),
])
def test_process_group_from_the_slice_env(monkeypatch, env, want):
    """The coordinator (worker 0, port 8476 by default), rank and world
    size the process group is given, and the explicit backend."""
    from workloads_torch import distributed

    calls = []
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    env = dict(env, TPU_WORKER_ID="1", TPU_TOPOLOGY="2x2x2", TPU_HOST_BOUNDS="1,1,2")
    assert distributed.initialize_from_slice_env(environ=env, backend="gloo") is True
    assert calls == [("gloo", dict(init_method=want, rank=1, world_size=2))]


def test_backend_defaults_to_the_card(monkeypatch):
    """NCCL on the card, gloo only when the caller asks for the CPU; no
    card and no explicit CPU raises, nothing falls back."""
    from workloads_torch import distributed

    assert distributed.default_backend("cpu") == "gloo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert distributed.default_backend() == "nccl"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.default_backend()


def test_make_mesh_needs_a_world():
    from workloads_torch.train import make_mesh

    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="initialised torch.distributed world"):
        make_mesh(device_type="cpu")


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return {world: tw.run_world(world, ["meshes", "collectives"],
                                str(tmp_path_factory.mktemp(f"world{world}")), timeout=120)
            for world in (2, 4)}


@pytest.mark.parametrize("world", [2, 4])
def test_make_mesh_rules(worlds, world):
    """JAX's rules: model_parallel defaults to the largest of 4 and 2
    dividing the devices; too many devices or a non-divisor raise."""
    got = tw.result_of(worlds[world], "meshes")
    assert got["default"] == {"data": 1, "model": world}
    assert got["mp1"] == {"data": world, "model": 1}
    assert got["too_many"].startswith("ValueError") and "devices are visible" in got["too_many"]
    assert "not divisible by model_parallel=3" in got["indivisible"]
    if world == 4:
        assert got["dp2"] == {"data": 2, "model": 2}


@pytest.mark.parametrize("world", [2, 4])
def test_global_mesh_rules(worlds, world):
    got = tw.result_of(worlds[world], "meshes")
    assert got["global"] == {"data": world, "model": 1}
    assert got["global_bad"].startswith("ValueError") and f"!= {world} global" in got["global_bad"]
    assert got["global_model"].startswith("ValueError") and "model=3" in got["global_model"]


@pytest.mark.parametrize("world", [2, 4])
def test_collectives_over_the_mesh_axes(worlds, world):
    """An all-reduce over the world, over each model group (neighbouring
    ranks) and each data group, on every rank."""
    for rank in range(world):
        got = tw.result_of(worlds[world], "collectives", rank)
        assert got["world"] == [float(sum(range(1, world + 1)))] * 3
        first = rank - rank % 2
        assert got["model"] == [float(first + 1 + first + 2)] * 2
        data = [r + 1 for r in range(world) if r % 2 == rank % 2]
        assert got["data"] == [float(sum(data))] * 2
        assert got["shape"] == (world // 2, 2)
        assert got["coords"] == [rank // 2, rank % 2]


def test_a_dead_rank_is_named_with_its_signal_and_log(tmp_path):
    """The world harness (tests/torch_tp_world.py): a rank killed by a
    signal leaves a negative exit code and its log, and a test that
    reads its missing result fails with both, not with a KeyError."""
    world = tw.run_world(2, ["meshes", "last_rank_dies"], str(tmp_path), timeout=120)
    assert world.exitcodes == [0, -9] and not world.timed_out
    assert tw.result_of(world, "last_rank_dies", 0) == "alive"
    assert tw.result_of(world, "meshes", 1)["default"] == {"data": 1, "model": 2}
    with pytest.raises(pytest.fail.Exception) as failed:
        tw.result_of(world, "last_rank_dies", 1)
    message = str(failed.value)
    assert "exit codes [0, -9]" in message
    assert "--- rank 1 log tail ---" in message and "rank 1 about to die" in message


def test_run_worlds_makes_its_directories_before_its_threads():
    """Two first mktemps at once race on pytest's base directory, so
    run_worlds makes every world's directory on the calling thread."""
    import threading

    calls = []

    class Factory:
        def mktemp(self, name):
            calls.append((name, threading.current_thread() is threading.main_thread()))
            return f"/nonexistent/{name}"

    def fake_run_world(world, names, tmp, timeout, module):
        return tw.World({"names": names, "tmp": tmp})

    import unittest.mock

    with unittest.mock.patch.object(tw, "run_world", fake_run_world):
        out = tw.run_worlds(Factory(), (2, 4), lambda w: [f"s{w}"])
    assert calls == [("world2", True), ("world4", True)]
    assert out[4]["tmp"] == "/nonexistent/world4" and out[2]["names"] == ["s2"]
