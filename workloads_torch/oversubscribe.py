"""End-to-end oversubscription harness, the PyTorch port of
``workloads/oversubscribe.py``: the BASELINE north-star measurement.

Stands up the daemon's plugin server exactly as production does (time-sliced
shared resource, real unix socket, real kubelet registration), then plays the
role of kubelet + N pods:

  1. ListAndWatch streams the replica-expanded device list.
  2. For each pod, GetPreferredAllocation picks the least-shared replica and
     Allocate returns the container environment (TPU_VISIBLE_CHIPS, lease
     dir; tpu_device_plugin/sharing.py).
  3. Each pod is a real subprocess running ``workloads_torch.busy_probe`` under
     that environment on ``platform`` (the torch device type: ``cuda``
     unless asked for ``cpu``), interleaving compute bursts through the
     cooperative chip lease.
  4. The per-chip busy accounting is aggregated into the north-star number:
     aggregate chip-busy fraction (target >= 0.90, BASELINE.md).

``run`` is both halves; ``run_pods`` is the pod half alone (spawn, wait,
aggregate) for environments admitted elsewhere, and needs no gRPC: the
admission half loads it on first use.  One CUDA card is one chip: every
fake chip's pods would open the same card under a different lease, so
each chip would read ~1.0 busy; ``run_pods`` refuses more chips than
``torch.cuda.device_count()`` on ``cuda``.

    python -m workloads_torch.oversubscribe --chips 1 --chips-per-tray 1 \\
        --replicas 4 --pods 4 --duration 6 --platform cuda
    python -m workloads_torch.oversubscribe --chips 2 --replicas 2 --pods 4 \\
        --duration 3 --platform cpu

Prints ONE JSON line with the aggregate busy fraction and vs_baseline
(value / 0.90; >= 1.0 beats the target).
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

BASELINE_BUSY_FRACTION = 0.90

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _LazyModule:
    """A module imported on its first attribute access."""

    def __init__(self, name: str):
        self._name = name

    def __getattr__(self, attr):
        return getattr(importlib.import_module(self._name), attr)


grpc = _LazyModule("grpc")


def _start_stack(n_chips: int, chips_per_tray: int, replicas: int, tmp: str):
    """Daemon-side setup: fake kubelet registration server + shared plugin."""
    from tpu_device_plugin.api import pb, rpc
    from tpu_device_plugin.backend.fake import FakeChipManager
    from tpu_device_plugin.config import Config, Flags
    from tpu_device_plugin.plugin import TpuDevicePlugin
    from tpu_device_plugin.strategy import chip_units

    class _Kubelet(rpc.RegistrationServicer):
        def Register(self, request, context):  # noqa: N802
            return pb.Empty()

    kubelet_server = grpc.server(ThreadPoolExecutor(max_workers=2))
    rpc.add_registration_servicer(_Kubelet(), kubelet_server)
    kubelet_sock = os.path.join(tmp, "kubelet.sock")
    if kubelet_server.add_insecure_port(f"unix:{kubelet_sock}") == 0:
        raise RuntimeError(f"could not bind fake kubelet socket at {kubelet_sock}")
    kubelet_server.start()

    manager = FakeChipManager(n_chips=n_chips, chips_per_tray=chips_per_tray)
    manager.init()
    plugin = TpuDevicePlugin(
        config=Config(flags=Flags(backend="fake")),
        resource_name="google.com/shared-tpu",
        units_fn=lambda: chip_units(manager),
        chip_manager=manager,
        socket_path=os.path.join(tmp, "tpu-shared-tpu.sock"),
        kubelet_socket=kubelet_sock,
        replicas=replicas,
        lease_dir=os.path.join(tmp, "leases"),
    )
    plugin.start()
    return plugin, manager, kubelet_server


def _admit_pods(stub, pb, n_pods: int) -> list[dict]:
    """Kubelet-side admission: preferred allocation + Allocate per pod."""
    stream = stub.ListAndWatch(pb.Empty())
    advertised = [d.ID for d in next(iter(stream)).devices]
    stream.cancel()
    available = sorted(advertised)
    pod_envs = []
    for _ in range(n_pods):
        pref = stub.GetPreferredAllocation(
            pb.PreferredAllocationRequest(
                container_requests=[
                    pb.ContainerPreferredAllocationRequest(
                        available_deviceIDs=available, allocation_size=1
                    )
                ]
            )
        )
        chosen = list(pref.container_responses[0].deviceIDs)
        if len(chosen) != 1:
            raise RuntimeError(
                f"preferred allocation returned {chosen!r} for size 1 — "
                f"likely more pods than replicas ({len(available)} device(s) left)"
            )
        resp = stub.Allocate(
            pb.AllocateRequest(
                container_requests=[
                    pb.ContainerAllocateRequest(devicesIDs=chosen)
                ]
            )
        )
        pod_envs.append(dict(resp.container_responses[0].envs))
        available.remove(chosen[0])
    return pod_envs


_PEAK_MEMORY = re.compile(rb"busy_probe: peak device memory (\d+) bytes")
_K1_LAUNCHES = re.compile(rb"busy_probe: K1 launches (\d+)")


def run_pods(
    pod_envs: list[dict],
    tmp: str,
    duration_secs: float = 8.0,
    matrix_dim: int = 512,
    platform: str | None = None,
    workload: str = "matmul",
) -> dict:
    """The pod half of ``run``: one ``workloads_torch.busy_probe`` pod per
    Allocate environment in ``pod_envs`` on ``platform`` (None means
    ``cuda``), their reports, barrier and stderr files under ``tmp``;
    waits for them and returns ``busy_probe.aggregate`` of their report
    with ``harness_wall_secs`` and ``per_pod`` (each pod's pid, bursts,
    busy fraction, tokens, the paged-attention kernel's launches over the
    pod's life, and its peak device memory, None off the card).

    Raises if a pod fails or outlasts the wedge deadline (duration*10 +
    300 s; wedged pods are killed), and, on ``cuda``, if the environments
    name more chips than there are cards."""
    from . import busy_probe

    device = platform or "cuda"
    chips = {c for env in pod_envs for c in env.get("TPU_VISIBLE_CHIPS", "").split(",") if c}
    if device.startswith("cuda"):
        import torch

        cards = torch.cuda.device_count()
        if len(chips) > cards:
            raise ValueError(
                f"{len(chips)} chips on {device}, but torch sees {cards} CUDA "
                f"device(s): one card is one chip, and every chip's pods would open "
                f"the same card under their own lease, each chip reading ~1.0 busy"
            )
    report = os.path.join(tmp, "stats.jsonl")
    procs = []
    stderr_paths = []
    for i, env_overlay in enumerate(pod_envs):
        env = dict(os.environ)
        env.update(env_overlay)
        # Per-pod stderr files, not pipes: a chatty pod that filled a
        # 64KiB pipe would block mid-write while holding its chip lease,
        # wedging every sibling waiting on the flock.
        stderr_path = os.path.join(tmp, f"pod-{i}.stderr")
        stderr_paths.append(stderr_path)
        with open(stderr_path, "wb") as stderr_file:
            procs.append(
                subprocess.Popen(
                    [
                        sys.executable,
                        "-m",
                        "workloads_torch.busy_probe",
                        "--duration",
                        str(duration_secs),
                        "--matrix-dim",
                        str(matrix_dim),
                        "--workload",
                        workload,
                        "--barrier-dir",
                        os.path.join(tmp, "barrier"),
                        "--barrier-count",
                        str(len(pod_envs)),
                        "--report",
                        report,
                        "--device",
                        device,
                    ],
                    env=env,
                    stdout=subprocess.DEVNULL,
                    stderr=stderr_file,
                    cwd=ROOT,
                )
            )
    t0 = time.monotonic()
    failures = []
    wedged = []
    try:
        deadline = time.monotonic() + duration_secs * 10 + 300
        for i, (p, stderr_path) in enumerate(zip(procs, stderr_paths)):
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 1.0))
            except subprocess.TimeoutExpired:
                wedged.append(i)
                continue
            if p.returncode != 0:
                with open(stderr_path, "rb") as f:
                    failures.append(f.read().decode(errors="replace")[-2000:])
    finally:
        for p in procs:  # don't orphan wedged pods holding chip leases
            if p.poll() is None:
                p.kill()
                p.wait()
    if wedged:
        tails = []
        for i in wedged:
            with open(stderr_paths[i], "rb") as f:
                tails.append(f"pod {i}: {f.read().decode(errors='replace')[-2000:]}")
        raise RuntimeError(
            f"{len(wedged)} pod(s) timed out and were killed: " + "; ".join(tails)
        )
    if failures:
        raise RuntimeError(f"{len(failures)} pod(s) failed: {failures[0]}")
    harness_wall = time.monotonic() - t0
    agg = busy_probe.aggregate(report)
    with open(report) as f:
        rows = {r["pid"]: r for r in map(json.loads, filter(str.strip, f))}
    per_pod = []
    for p, stderr_path in zip(procs, stderr_paths):
        row = rows.get(p.pid, {})
        with open(stderr_path, "rb") as f:
            err = f.read()
        peak, k1 = _PEAK_MEMORY.search(err), _K1_LAUNCHES.search(err)
        per_pod.append({"pid": p.pid, "bursts": row.get("bursts"),
                        "busy_fraction": row.get("busy_fraction"),
                        "tokens": row.get("tokens", 0),
                        "k1_launches": int(k1.group(1)) if k1 else None,
                        "peak_memory_bytes": int(peak.group(1)) if peak else None})
    agg.update({"harness_wall_secs": round(harness_wall, 3), "per_pod": per_pod})
    return agg


def run(
    n_chips: int = 4,
    chips_per_tray: int = 4,
    replicas: int = 2,
    n_pods: int = 8,
    duration_secs: float = 8.0,
    matrix_dim: int = 512,
    platform: str | None = None,
    workload: str = "matmul",
) -> dict:
    """The whole harness: the daemon's plugin and a fake kubelet over
    gRPC admit ``n_pods`` onto ``n_chips`` x ``replicas`` time-sliced
    devices (``_start_stack``, ``_admit_pods``), then ``run_pods`` runs
    them on ``platform``."""
    from tpu_device_plugin.api import pb, rpc

    tmp = tempfile.mkdtemp(prefix="tpu-dp-oversub-")
    plugin, manager, kubelet_server = _start_stack(
        n_chips, chips_per_tray, replicas, tmp
    )
    try:
        channel = grpc.insecure_channel(f"unix:{plugin.socket_path}")
        try:
            grpc.channel_ready_future(channel).result(timeout=5)
            stub = rpc.DevicePluginStub(channel)
            pod_envs = _admit_pods(stub, pb, n_pods)
        finally:
            channel.close()
        agg = run_pods(pod_envs, tmp, duration_secs, matrix_dim, platform, workload)
    finally:
        plugin.stop()
        kubelet_server.stop(grace=0.2).wait()
        manager.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    agg.update(
        {
            "n_pods": n_pods,
            "n_chips": n_chips,
            "replicas_per_chip": replicas,
        }
    )
    return agg


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--chips", type=int, default=4)
    parser.add_argument("--chips-per-tray", type=int, default=4)
    parser.add_argument("--replicas", type=int, default=2)
    parser.add_argument("--pods", type=int, default=8)
    parser.add_argument("--duration", type=float, default=8.0)
    parser.add_argument("--matrix-dim", type=int, default=512)
    parser.add_argument("--workload", default="matmul", choices=["matmul", "train", "serve"],
                        help="pod burst content; 'train'/'serve' report aggregate "
                        "useful tokens/s next to the busy fraction")
    parser.add_argument(
        "--platform", "--device",
        dest="platform",
        default=None,
        help="torch device type the pods run on (default cuda; cpu for "
        "hardware-free runs)",
    )
    args = parser.parse_args(argv)
    agg = run(
        n_chips=args.chips,
        chips_per_tray=args.chips_per_tray,
        replicas=args.replicas,
        n_pods=args.pods,
        duration_secs=args.duration,
        matrix_dim=args.matrix_dim,
        platform=args.platform,
        workload=args.workload,
    )
    value = agg["aggregate_busy_fraction"]
    print(
        json.dumps(
            {
                "metric": "aggregate_chip_busy_fraction",
                "value": round(value, 4),
                "unit": "fraction",
                "vs_baseline": round(value / BASELINE_BUSY_FRACTION, 4),
                **{k: v for k, v in agg.items() if k != "aggregate_busy_fraction"},
            }
        )
    )
    return 0 if value >= BASELINE_BUSY_FRACTION else 1


if __name__ == "__main__":
    raise SystemExit(main())
