"""Multi-host bring-up: ``torch.distributed`` from the daemon-injected
slice env, ported from ``workloads/distributed.py``.

On a multi-host slice each host's device plugin stamps the global-slice
env into its Allocate responses (``TPU_WORKER_ID``, ``TPU_TOPOLOGY``,
``TPU_HOST_BOUNDS``: ``tpu_device_plugin/slice_topology.py``
``container_slice_env``); this module turns that env into a connected
process group: ``initialize_from_slice_env`` calls
``torch.distributed.init_process_group`` with worker 0 as the
coordinator, after which ``global_mesh`` lays the ``("data", "model")``
axes over every rank of the slice.

Where the JAX package is one controller per host whose collectives XLA
inserts, the port runs one process per device (SPMD, as under
``torchrun``) and calls its collectives itself (``tp_serve.py``).  The
backend is the caller's explicit choice: ``"nccl"`` by default on the
card, ``"gloo"`` on the CPU.  Nothing falls back from one to the other.

Hardware-free testing: the same code path runs N CPU processes over
gloo (``tests/test_torch_distributed.py`` spawns two and all-reduces
across them).
"""

from __future__ import annotations

import os

import torch

from . import resolve_device

DEFAULT_COORDINATOR_PORT = 8476


def slice_process_info(environ=None) -> tuple[int, int] | None:
    """(process_id, num_processes) from the daemon-injected slice env
    (TPU_TOPOLOGY + TPU_HOST_BOUNDS + TPU_WORKER_ID), or None when this
    container is not part of a declared multi-host slice.

    Parsing delegates to the daemon's own parser
    (``slice_topology.slice_info_from_env``), so malformed env raises its
    ``SliceConfigError``; the node-metadata fallback is off: a workload
    container must carry an explicit worker id."""
    from tpu_device_plugin.slice_topology import (
        SliceConfigError,
        slice_info_from_env,
    )

    env = os.environ if environ is None else environ
    info = slice_info_from_env(env=env, metadata_worker_id=None)
    if info is None:
        # A partial slice env must fail loud, not silently run
        # single-host while the slice's worker 0 blocks waiting for this
        # process to connect.
        present = [k for k in ("TPU_WORKER_ID", "TPU_HOST_BOUNDS") if k in env]
        if present and "TPU_TOPOLOGY" not in env:
            raise SliceConfigError(
                f"partial slice env: {', '.join(present)} set but "
                f"TPU_TOPOLOGY missing — the daemon injects all three "
                f"(slice_topology.container_slice_env)"
            )
        return None
    return info.worker_id, info.n_hosts


def default_backend(device=None) -> str:
    """``"nccl"`` for the card, ``"gloo"`` for the CPU; ``device`` None
    means ``cuda`` (``resolve_device``, which raises without a card)."""
    return "nccl" if resolve_device(device).type == "cuda" else "gloo"


def bind_local_device(device_type: str) -> None:
    """Make this rank's card the current CUDA device: ``LOCAL_RANK``
    (set by ``torchrun``), else the rank, modulo the cards the process
    sees (so several ranks may share one card).  A no-op for the CPU."""
    if device_type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", torch.distributed.get_rank()))
        torch.cuda.set_device(local % torch.cuda.device_count())


def initialize_from_slice_env(
    coordinator_address: str | None = None, environ=None, backend: str | None = None,
    device=None,
) -> bool:
    """Connect this process to the slice-wide process group.

    Returns True when a multi-host slice env was found and
    ``init_process_group`` ran; False on a single-host container (no
    initialisation needed).

    ``coordinator_address`` (``host:port``) defaults to
    ``$TPU_COORDINATOR_ADDRESS`` or worker 0's pod DNS name from
    ``$TPU_WORKER_HOSTNAMES`` (comma list) on port 8476; pass it
    explicitly when neither is set.  ``backend`` None means
    ``default_backend(device)``."""
    env = os.environ if environ is None else environ
    info = slice_process_info(env)
    if info is None:
        return False
    process_id, num_processes = info
    if num_processes <= 1:
        return False
    if coordinator_address is None:
        coordinator_address = env.get("TPU_COORDINATOR_ADDRESS")
    if coordinator_address is None:
        hostnames = env.get("TPU_WORKER_HOSTNAMES")
        if hostnames:
            coordinator_address = (
                f"{hostnames.split(',')[0]}:{DEFAULT_COORDINATOR_PORT}"
            )
    if coordinator_address is None:
        raise ValueError(
            "multi-host slice env present but no coordinator address: set "
            "TPU_COORDINATOR_ADDRESS or TPU_WORKER_HOSTNAMES, or pass "
            "coordinator_address="
        )
    torch.distributed.init_process_group(
        backend or default_backend(device),
        init_method=f"tcp://{coordinator_address}",
        rank=process_id,
        world_size=num_processes,
    )
    return True


def global_mesh(
    data: int | None = None, model: int = 1, axis_names=("data", "model"),
    device_type: str | None = None,
):
    """A ``DeviceMesh`` over every rank of the connected slice (all
    hosts), one rank per device.

    Defaults to all-data-parallel; pass ``model`` to carve a trailing
    tensor-parallel axis (ranks that are neighbours in the world share a
    model group, so its collectives stay within a host when ``model``
    divides the ranks a host runs).  ``device_type`` None means ``cuda``
    (``resolve_device``); pass ``"cpu"`` explicitly."""
    from torch.distributed.device_mesh import DeviceMesh

    device_type = resolve_device(device_type).type
    n = torch.distributed.get_world_size()
    if data is None:
        if n % model:
            raise ValueError(f"{n} global devices not divisible by model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} global devices")
    bind_local_device(device_type)
    grid = torch.arange(n).reshape(data, model)
    return DeviceMesh(device_type, grid, mesh_dim_names=tuple(axis_names))
