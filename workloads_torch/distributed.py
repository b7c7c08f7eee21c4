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


def mesh_device(mesh) -> torch.device:
    """The device this rank's tensors live on: the CPU for a ``"cpu"``
    mesh, else the current CUDA device (``make_mesh`` binds it)."""
    if mesh.device_type == "cpu":
        return torch.device("cpu")
    resolve_device(mesh.device_type)  # raises without a card
    return torch.device(mesh.device_type, torch.cuda.current_device())


def world_mesh(device=None) -> tuple:
    """(mesh, device) for a training entry point: ``train.make_mesh()``
    over the initialised world and this rank's device when a world of
    more than one rank is up, else (None, ``resolve_device(device)``)."""
    device = resolve_device(device)
    if not (torch.distributed.is_initialized() and torch.distributed.get_world_size() > 1):
        return None, device
    from .train import make_mesh

    mesh = make_mesh(device_type=device.type)
    return mesh, mesh_device(mesh)


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


# ---- differentiable collectives ------------------------------------------
#
# The training layouts run one process per device, so the collectives that
# XLA inserts from the JAX package's shardings are written out here, each
# a ``torch.autograd.Function`` with its gradient.  ``group`` is a mesh
# axis' process group (``DeviceMesh.get_group``); a rank's index along the
# axis is its rank in that group.
#
# On a gloo group, a CUDA tensor's point-to-point, all-to-all and
# all-gather exchanges are staged through host memory by an explicit copy
# (``_to_wire``): gloo has no CUDA path for ``send``/``recv``, and the
# others take the same route.  Gloo's all-reduce takes CUDA tensors and
# stages them itself.  NCCL takes CUDA tensors for all of them; nothing
# falls back from one backend to the other.


def _to_wire(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as it goes over ``group``: a host copy of a CUDA tensor on a
    gloo group, else ``x``."""
    staged = x.is_cuda and torch.distributed.get_backend(group) == "gloo"
    return x.cpu() if staged else x


def _group_size_index(group) -> tuple[int, int]:
    return torch.distributed.get_world_size(group), torch.distributed.get_rank(group)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.contiguous().clone()
    torch.distributed.all_reduce(out, group=group)
    return out


def _all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n, _ = _group_size_index(group)
    send = _to_wire(x.contiguous(), group)
    parts = [torch.empty_like(send) for _ in range(n)]
    torch.distributed.all_gather(parts, send, group=group)
    return torch.cat(parts, dim=dim).to(x.device)


def _span(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n, i = _group_size_index(group)
    return x.chunk(n, dim=dim)[i].contiguous()


class _Enter(torch.autograd.Function):
    """Megatron's ``f``: identity forward, all-reduce backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _Reduce(torch.autograd.Function):
    """Megatron's ``g``: all-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def axis_hooks(mesh, axis: str):
    """(enter, reduce): Megatron's ``f`` and ``g`` over mesh axis
    ``axis`` for a rank whose products each hold a part of a sum over
    that axis.  ``enter`` (the input of a product that reads only the
    rank's part) is the identity forward and sums the input's gradient
    over the axis' group backward; ``reduce`` (a partial sum) sums the
    ranks' parts forward and passes the gradient through backward.
    (None, None) for an axis of size 1."""
    dim = mesh.mesh_dim_names.index(axis)
    if mesh.size(dim) == 1:
        return None, None
    group = mesh.get_group(axis)
    return (lambda x: _Enter.apply(x, group)), (lambda x: _Reduce.apply(x, group))


def model_hooks(mesh):
    """(enter, reduce): the ``"model"`` axis' pair of hooks for a rank of
    ``mesh`` holding a ``param_specs`` cut of the weights under autograd
    (``axis_hooks``): ``enter`` takes the input of every column-parallel
    product, ``reduce`` the output of every row-parallel product.
    (None, None) for a model degree of 1."""
    return axis_hooks(mesh, "model")


class _Mean(torch.autograd.Function):
    """The mean over ``group`` forward, and the mean of the gradient over
    ``group`` backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group) / torch.distributed.get_world_size(group)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group) / torch.distributed.get_world_size(ctx.group), None


def group_mean(x: torch.Tensor, group) -> torch.Tensor:
    """The mean of ``x`` over the ranks of ``group``, on every rank, for
    a statistic whose every rank's loss reads the whole group's value
    (MoE's load-balancing means over a data-parallel batch).  Its
    gradient is the group's mean of each rank's gradient: the adjoint
    under a train step that then averages the ranks' gradients over the
    same group (``train.make_sharded_train_step``)."""
    return _Mean.apply(x, group)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.group, ctx.dims = group, (split_dim, concat_dim)
        return _all_to_all(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, grad):
        split_dim, concat_dim = ctx.dims
        return _all_to_all(grad, ctx.group, concat_dim, split_dim), None, None, None


def _all_to_all(x, group, split_dim, concat_dim):
    n, _ = _group_size_index(group)
    if x.shape[split_dim] % n:
        raise ValueError(f"dim {split_dim} of size {x.shape[split_dim]} does not split "
                         f"over {n} ranks")
    send = _to_wire(torch.stack(x.chunk(n, dim=split_dim)).contiguous(), group)
    recv = torch.empty_like(send)
    torch.distributed.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.to(x.device).unbind(0), dim=concat_dim)


def all_to_all(x: torch.Tensor, group, split_dim: int, concat_dim: int) -> torch.Tensor:
    """``jax.lax.all_to_all(x, axis, split_dim, concat_dim, tiled=True)``
    over ``group``: ``x`` cut into the group's size blocks along
    ``split_dim``, block j sent to rank j, and the blocks received
    concatenated along ``concat_dim`` in rank order.  Its gradient is
    the inverse exchange."""
    return _AllToAll.apply(x, group, split_dim, concat_dim)


def _shift(x: torch.Tensor, group, step: int, ring: bool) -> torch.Tensor:
    """Send ``x`` to the rank ``step`` ahead in ``group`` and return what
    the rank ``step`` behind sent: cyclically on a ``ring``, else along
    an open chain, where a rank with none ahead sends nothing and one
    with none behind receives zeros."""
    n, i = _group_size_index(group)
    if n == 1 and ring:
        return x
    to, frm = i + step, i - step
    if ring:
        to, frm = to % n, frm % n
    send = _to_wire(x.contiguous(), group)
    recv = torch.zeros_like(send)
    ops = []
    if 0 <= to < n:
        ops.append(torch.distributed.P2POp(
            torch.distributed.isend, send, torch.distributed.get_global_rank(group, to), group))
    if 0 <= frm < n:
        ops.append(torch.distributed.P2POp(
            torch.distributed.irecv, recv, torch.distributed.get_global_rank(group, frm), group))
    if ops:
        for work in torch.distributed.batch_isend_irecv(ops):
            work.wait()
    return recv.to(x.device)


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, ring):
        ctx.group, ctx.ring = group, ring
        return _shift(x, group, 1, ring)

    @staticmethod
    def backward(ctx, grad):
        return _shift(grad, ctx.group, -1, ctx.ring), None, None


def ppermute(x: torch.Tensor, group) -> torch.Tensor:
    """The ring step of ``jax.lax.ppermute`` with ``perm = [(i, (i + 1) %
    N)]``: send ``x`` to the next rank of ``group`` and receive the
    previous rank's.  Its gradient runs the reverse ring."""
    return _Shift.apply(x, group, True)


def handoff(x: torch.Tensor, group) -> torch.Tensor:
    """``jax.lax.ppermute`` with the open chain ``perm = [(i, i + 1) for i
    in range(N - 1)]``: send ``x`` to the next rank of ``group`` (the
    last rank sends nothing) and receive the previous rank's (the first
    rank receives zeros).  Its gradient is the reverse hand-off: each
    rank's gradient goes back to the rank it came from, and the last
    rank's ``x`` gets zeros.  Every rank of the group calls it with the
    same shape."""
    return _Shift.apply(x, group, False)


class _SeqSlice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _span(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        return _all_gather(grad, ctx.group, ctx.dim), None, None


class _SeqGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        return _span(grad, ctx.group, ctx.dim), None, None


def seq_slice(x: torch.Tensor, group, dim: int = 1, axis: str = "seq") -> torch.Tensor:
    """This rank's span of ``x`` along ``dim``, where every rank of
    ``group`` (mesh axis ``axis``) holds the same ``x``: the forward takes
    the span, the backward gathers every rank's gradient span, so the
    gradient of the whole ``x`` is on every rank.  Raises the JAX
    package's ``ValueError`` when the axis does not divide ``dim``."""
    n, _ = _group_size_index(group)
    if x.shape[dim] % n:
        raise ValueError(f"seq {x.shape[dim]} not divisible by mesh axis {axis!r} size {n}")
    return _SeqSlice.apply(x, group, dim)


def seq_gather(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    """Every rank's span of ``group`` concatenated along ``dim`` in rank
    order; the backward keeps this rank's span of the gradient."""
    return _SeqGather.apply(x, group, dim)
