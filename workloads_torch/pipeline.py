"""Pipeline parallelism: the GPipe schedule of ``workloads/pipeline.py``
over a ``"pipe"`` mesh axis, in PyTorch.

The model's layer stack is split into S contiguous stages whose stacked
weights (``[S, L/S, ...]`` leaves) are cut over the mesh's ``"pipe"``
axis; the batch is split into M microbatches that stream through the
stages.  One process per device, SPMD over a ``torch.distributed``
``DeviceMesh`` as ``train.py``: each rank holds its stage's layers and
runs the JAX ``lax.scan``'s M+S-1 schedule steps as a loop, handing its
output to the next stage with ``distributed.handoff`` (JAX's open-chain
``ppermute``; its gradient is the reverse hand-off, so every stage
before the last gets its gradient).  The last stage's outputs are
replicated over ``"pipe"`` by a masked all-reduce, Megatron's ``g``
(its gradient reaches the last stage once), and the embedded input
enters through ``f`` over ``"pipe"``: only stage 0 reads it, so its
gradient, and ``embed``'s, is summed over the stages.  The full step,
forward, backward and AdamW, runs on ``train.make_sharded_train_step``
over ``("data", "pipe")``: dp x pp.

Embedding and unembedding are replicated and computed outside the
pipelined region.  Bubble fraction is the GPipe (S-1)/(M+S-1); pick
M >= S.  As in the JAX program, every stage runs its blocks at every
schedule step and the bubble's products are masked out, so with
``attention_impl="flash"`` at a long sequence each stage launches K2
(M+S-1) x L/S times a forward and K3/K4 as often in the backward.
"""

from __future__ import annotations

import torch

from . import prng
from .model import (
    ModelConfig,
    _attention,
    _mesh_axis,
    _mlp,
    _rmsnorm,
    cross_entropy,
    init_params,
    weight,
)


def make_pp_mesh(n_devices: int, pipe_parallel: int = 2, device_type: str | None = None):
    """A ``("data", "pipe")`` mesh over the first ``n_devices`` ranks of the
    initialised world: batch data-parallel, layers staged.  ``device_type``
    None means ``cuda``; pass ``"cpu"`` for a CPU world."""
    from .train import _data_led_mesh

    return _data_led_mesh(n_devices, {"pipe": pipe_parallel}, device_type,
                          divisor="pipe_parallel")


def _check_block(config: ModelConfig) -> None:
    """The pipeline stacks one dense block kind over its stages."""
    if not config.plain_block:
        raise ValueError(
            "the pipeline runs the dense block with one window and plain RoPE on "
            "every layer: it has no expert layer and no per-layer pattern"
        )


def init_pipeline_params(config: ModelConfig, n_stages: int,
                         key: torch.Tensor) -> dict:
    """``model.init_params`` from ``key`` with the layer list stacked
    into ``[S, L/S, ...]`` leaves under ``"stages"`` (stage-major), ready
    to cut on the ``"pipe"`` axis."""
    _check_block(config)
    if config.n_layers % n_stages:
        raise ValueError(
            f"n_layers ({config.n_layers}) must divide into {n_stages} stages"
        )
    params = init_params(config, key)
    layers = params.pop("layers")
    per_stage = config.n_layers // n_stages
    params["stages"] = {
        name: torch.stack([layer[name] for layer in layers]).reshape(
            (n_stages, per_stage) + tuple(layers[0][name].shape))
        for name in layers[0]
    }
    return params


def pipeline_param_specs(config: ModelConfig) -> dict:
    """Stage-stacked leaves cut their leading dim on ``"pipe"``; ``embed``
    and ``unembed`` are replicated (``model.shard_tree``'s specs)."""
    names = ["ln1", "ln2", "wo", "w_up", "w_down"]
    names += ["wqkv"] if config.kv_heads == config.n_heads else ["wq", "wkv"]
    return {"embed": (), "unembed": (), "stages": {name: ("pipe",) for name in names}}


def _stage_blocks(local_layers: dict, x: torch.Tensor, config: ModelConfig) -> torch.Tensor:
    """Apply this stage's L/S transformer blocks (leaves ``[L/S, ...]``)."""
    for i in range(next(iter(local_layers.values())).shape[0]):
        layer = {name: leaf[i] for name, leaf in local_layers.items()}
        h = x + _attention(_rmsnorm(x, layer["ln1"]), layer, config)
        x = h + _mlp(_rmsnorm(h, layer["ln2"]), layer)
    return x


def _pipeline_local(stages: dict, x_mb: torch.Tensor, *, config: ModelConfig, n_stages: int,
                    n_microbatches: int, mesh, handoff=None) -> torch.Tensor:
    """This rank's schedule: ``stages`` leaves ``[1, L/S, ...]`` (its
    stage's cut), ``x_mb`` ``[M, mb, s, d]``.  Returns ``[M, mb, s, d]``,
    the last stage's outputs, replicated over ``"pipe"`` by a masked
    all-reduce.  ``handoff`` (default ``distributed.handoff``) passes a
    stage's output to the next."""
    from .distributed import axis_hooks
    from .distributed import handoff as pass_on

    pass_on = pass_on if handoff is None else handoff
    local_layers = {name: leaf[0] for name, leaf in stages.items()}
    _, reduce = axis_hooks(mesh, "pipe")
    group = None if reduce is None else mesh.get_group("pipe")
    stage = _mesh_axis(mesh, "pipe")[1]
    is_first = float(stage == 0)
    is_last = float(stage == n_stages - 1)
    state = torch.zeros_like(x_mb[0])
    ys = list(torch.zeros_like(x_mb).unbind(0))
    for t in range(n_microbatches + n_stages - 1):
        # Activations flow one stage down the chain; stage 0 instead picks
        # up the next microbatch (clamped index: past-the-end steps
        # reprocess the last microbatch, and their products never reach
        # collection).  At t = 0 every stage would hand on zeros.
        incoming = state if group is None or t == 0 else pass_on(state, group)
        xt = x_mb[min(t, n_microbatches - 1)]
        inp = is_first * xt + (1 - is_first) * incoming
        out = _stage_blocks(local_layers, inp, config)
        # The last stage banks microbatch t-(S-1) once the pipe has filled.
        # The masked update keeps every step's output in each rank's
        # graph, so every rank runs every hand-off's backward.
        idx = min(max(t - (n_stages - 1), 0), n_microbatches - 1)
        collect = is_last * float(t >= n_stages - 1)
        ys[idx] = collect * out + (1 - collect) * ys[idx]
        state = out
    ys = torch.stack(ys)
    # Only the last stage holds real outputs; g replicates them pipe-wide.
    return ys if reduce is None else reduce(is_last * ys)


def pipeline_forward(params: dict, tokens: torch.Tensor, config: ModelConfig, mesh,
                     n_microbatches: int, handoff=None) -> torch.Tensor:
    """Logits via the pipelined layer stack for this rank's rows:
    ``tokens`` ``[batch, T]`` (the whole batch on a mesh with one data
    rank; ``make_pipeline_train_step`` passes each data rank its rows),
    ``batch`` divisible by ``n_microbatches``.  ``handoff`` as
    ``_pipeline_local``."""
    _check_block(config)
    from .distributed import axis_hooks

    n_stages = _mesh_axis(mesh, "pipe")[0]
    batch, seq = tokens.shape
    if batch % n_microbatches:
        raise ValueError(
            f"batch {batch} not divisible by n_microbatches={n_microbatches}"
        )
    x = params["embed"].to(config.dtype)[tokens.long()]
    x_mb = x.reshape(n_microbatches, batch // n_microbatches, seq, -1)
    enter, _ = axis_hooks(mesh, "pipe")
    if enter is not None:
        x_mb = enter(x_mb)
    ys = _pipeline_local(params["stages"], x_mb, config=config, n_stages=n_stages,
                         n_microbatches=n_microbatches, mesh=mesh, handoff=handoff)
    ys = ys.reshape(batch, seq, -1)
    return ys.float() @ weight(params["unembed"], torch.float32)


def pipeline_loss_fn(params: dict, tokens: torch.Tensor, config: ModelConfig, mesh,
                     n_microbatches: int, handoff=None) -> torch.Tensor:
    """Causal LM loss through the pipeline (``model.loss_fn``'s contract)."""
    logits = pipeline_forward(params, tokens[:, :-1], config, mesh, n_microbatches, handoff)
    return cross_entropy(logits, tokens[:, 1:])


def make_pipeline_train_state(config: ModelConfig, mesh, seed: int = 0, optimizer=None):
    """((params, opt_state), optimizer): this rank's cut of
    ``init_pipeline_params`` from ``PRNGKey(seed)`` on the mesh's device,
    stages cut on ``"pipe"``
    (``train.make_sharded_train_state``; default optimizer ``AdamW()``)."""
    from .distributed import mesh_device
    from .train import make_sharded_train_state

    device = mesh_device(mesh)
    n_stages = _mesh_axis(mesh, "pipe")[0]
    return make_sharded_train_state(
        mesh,
        lambda: init_pipeline_params(config, n_stages, prng.PRNGKey(seed, device=device)),
        pipeline_param_specs(config),
        optimizer,
    )


def make_pipeline_train_step(config: ModelConfig, mesh, optimizer, n_microbatches: int = 4):
    """The full dp x pp training step: pipelined forward, backward through
    the schedule (the reverse hand-offs), AdamW update; the global batch
    is split over ``"data"`` (``train.make_sharded_train_step``)."""
    from .train import make_sharded_train_step

    return make_sharded_train_step(
        lambda p, t: pipeline_loss_fn(p, t, config, mesh, n_microbatches),
        mesh,
        optimizer,
    )
