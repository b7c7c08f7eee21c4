"""The training steps of ``workloads/train.py``, in PyTorch.

Forward, backward and an AdamW update:
``make_train_step(config, optimizer)`` returns
``step(params, opt_state, tokens) -> (params, opt_state, loss)``.
The parameters are the model's float32 master tree (``model.init_params``);
the forward computes in ``config.dtype`` (bf16 by default), and with
``attention_impl="flash"`` long sequences run the flash kernels K2 (forward)
and K3/K4 (backward).  Unlike the JAX step, which returns new arrays, the
update is applied in place to the parameter and moment tensors: at full
width that saves a second copy of the ~2 GB parameter tree.

The optimizer is ``optax.adamw(1e-3, mu_dtype=jnp.bfloat16)``, the JAX
package's default, written out on tensors (``adamw``): the first moment
is stored in bfloat16, the second in float32.  ``torch.optim.AdamW``
cannot store a bf16 moment and applies the decay in another order, so it
is not this optimizer.

The parallel layouts run one process per device over an initialised
``torch.distributed`` world (SPMD, as ``tp_serve.py`` serves): each rank
holds plain local tensors, cut from the full tree by ``model.param_specs``
(``make_sharded_train_state``), and the collectives that XLA inserts
from the JAX package's shardings are written out
(``distributed.model_hooks``, ``all_to_all``, ``ppermute``,
``seq_slice``/``seq_gather``).  ``make_mesh`` builds the ``("data",
"model")`` mesh, ``make_sp_mesh``/``make_usp_mesh`` the sequence-parallel
ones; ``make_sharded_train_step`` takes the global batch, keeps the
rank's rows and averages the gradients and the loss over ``"data"``;
``make_train_step(config, mesh=...)`` adds the model axis' hooks and
``make_seq_parallel_train_step`` ring, Ulysses or USP attention.
``pipeline.py`` (GPipe over ``"pipe"``), ``moe.py`` (experts over
``"expert"``) and ``vision.py`` (a CNN over ``"data"``) build their steps
on ``make_sharded_train_step`` too.  Its ``step.aot_compile`` stands for
JAX's ahead-of-time compile: eager PyTorch compiles nothing, so it
checks the batch's arity, runs no kernel and returns the step, for
``busy_probe.py``'s bursts to call before they take the chip lease.

    python -m workloads_torch.train --steps 20 --checkpoint-dir /ckpt
    python -m workloads_torch.train --device cpu --steps 3
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass

import torch
from torch.profiler import record_function

from . import prng, resolve_device
from .model import (
    ModelConfig,
    _mesh_axis,
    init_params,
    loss_fn,
    param_specs,
    shard_leaf,
    shard_tree,
)


def make_mesh(n_devices: int | None = None, model_parallel: int | None = None,
              device_type: str | None = None):
    """A ``("data", "model")`` ``DeviceMesh`` over the first ``n_devices``
    ranks of the initialised world (all of them by default), one rank
    per device.

    ``model_parallel`` defaults to the largest of 4 and 2 that divides
    the rank count (1 when neither does), as in the JAX package.
    ``device_type`` None means ``cuda`` (``resolve_device``; the rank's
    card is ``distributed.bind_local_device``'s); pass ``"cpu"``
    explicitly for a CPU world.  Every rank of the world
    calls this (it creates the axes' process groups)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from .distributed import bind_local_device

    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialised torch.distributed world "
            "(init_process_group, or distributed.initialize_from_slice_env)"
        )
    device_type = resolve_device(device_type).type
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n > world:
        raise ValueError(
            f"requested a {n_devices}-device mesh but only {world} devices are visible"
        )
    if model_parallel is None:
        model_parallel = 1
        for candidate in (4, 2):
            if n % candidate == 0:
                model_parallel = candidate
                break
    if model_parallel < 1 or n % model_parallel != 0:
        raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
    bind_local_device(device_type)
    grid = torch.arange(n).reshape(n // model_parallel, model_parallel)
    return DeviceMesh(device_type, grid, mesh_dim_names=("data", "model"))


def _data_led_mesh(n_devices: int | None, trailing: dict[str, int],
                   device_type: str | None = None, divisor: str | None = None):
    """A mesh with a leading ``"data"`` axis absorbing whatever the named
    trailing axes don't, over the first ``n_devices`` ranks of the world;
    shared by the sp/usp, pipeline, expert and data-only mesh builders.
    ``device_type`` as ``make_mesh``; ``divisor`` names the trailing
    axes' product in the indivisible refusal (default: the axes' names
    joined by ``*``)."""
    import math

    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from .distributed import bind_local_device

    if not dist.is_initialized():
        raise RuntimeError(
            "a mesh needs an initialised torch.distributed world "
            "(init_process_group, or distributed.initialize_from_slice_env)"
        )
    device_type = resolve_device(device_type).type
    world = dist.get_world_size()
    if n_devices is None:
        n_devices = world
    if n_devices <= 0:
        raise ValueError(f"n_devices must be positive, got {n_devices}")
    if world < n_devices:
        raise ValueError(
            f"requested a {n_devices}-device mesh but only "
            f"{world} devices are visible"
        )
    denom = math.prod(trailing.values())
    if n_devices % denom:
        axes = "*".join(trailing) if divisor is None else divisor
        raise ValueError(f"{n_devices} devices not divisible by {axes}={denom}")
    bind_local_device(device_type)
    grid = torch.arange(n_devices).reshape((n_devices // denom, *trailing.values()))
    return DeviceMesh(device_type, grid, mesh_dim_names=("data", *trailing.keys()))


def make_sp_mesh(n_devices: int | None = None, seq_parallel: int = 2,
                 model_parallel: int = 1, device_type: str | None = None):
    """A ``("data", "seq", "model")`` mesh for sequence-parallel training.

    The ``"seq"`` axis carries ring attention's k/v rotation (neighbouring
    ranks); ``"model"`` stays available for the Megatron cut (size 1 by
    default)."""
    return _data_led_mesh(n_devices, {"seq": seq_parallel, "model": model_parallel},
                          device_type)


def make_usp_mesh(n_devices: int | None = None, ring: int = 2, ulysses: int = 2,
                  model_parallel: int = 1, device_type: str | None = None):
    """A ``("data", "seq_r", "seq_u", "model")`` mesh for 2D (Ulysses x
    ring) sequence parallelism: ``"seq_u"`` (its all-to-alls move the
    most bytes at once) on neighbouring ranks, ``"seq_r"`` across them;
    ``"model"`` stays available for the Megatron cut (size 1 by
    default)."""
    return _data_led_mesh(
        n_devices, {"seq_r": ring, "seq_u": ulysses, "model": model_parallel}, device_type)


def tree_leaves(tree) -> list[torch.Tensor]:
    """The leaves of a tree in a fixed order.  A parameter tree (a dict
    with ``layers``): embed, unembed, then each layer's leaves by name;
    a list (an adapter tree, ``[layer]{target: {a, b}}``): element by
    element; any other dict: by sorted key."""
    if isinstance(tree, list):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    if not isinstance(tree, dict):
        return [tree]
    keys = ("embed", "unembed", "layers") if "layers" in tree else sorted(tree)
    return [leaf for k in keys for leaf in tree_leaves(tree[k])]


def tree_map(fn, tree):
    """A tree of the same structure (dicts and lists) with ``fn`` applied
    to every leaf."""
    if isinstance(tree, list):
        return [tree_map(fn, t) for t in tree]
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


@dataclass(frozen=True)
class AdamW:
    """The hyperparameters of ``optax.adamw(lr, mu_dtype=...)`` with optax's
    defaults (weight_decay 1e-4, not torch's 1e-2)."""

    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    eps_root: float = 0.0
    weight_decay: float = 1e-4
    mu_dtype: torch.dtype = torch.bfloat16

    def init(self, params: dict) -> dict:
        """Zero moments: mu in ``mu_dtype``, nu in the parameters' dtype."""
        return {
            "count": 0,
            "mu": tree_map(lambda p: torch.zeros_like(p, dtype=self.mu_dtype), params),
            "nu": tree_map(torch.zeros_like, params),
        }


@torch.no_grad()
def adamw(params: dict, grads: list[torch.Tensor], state: dict,
          optimizer: AdamW = AdamW()) -> dict:
    """One ``optax.adamw`` step, op for op: scale_by_adam, then
    add_decayed_weights, then scale by -lr, then apply.  Updates
    ``params`` and the moment tensors of ``state`` in place; ``grads``
    follow ``tree_leaves(params)``.  Returns the new state.

    The first moment is computed in float32 from the stored one and
    stored back in ``mu_dtype``; the bias corrections use the float32
    value.  As in the JAX package's jitted step, the decay term
    ``b1 * mu`` takes ``b1`` in the moment's dtype (bf16(0.9) =
    0.8984375, JAX's weak-typed scalar) and the product in float32."""
    o = optimizer
    count = state["count"] + 1
    b1_mu = torch.tensor(o.b1, dtype=o.mu_dtype).item()
    bc1 = 1 - torch.tensor(o.b1, dtype=torch.float32) ** count
    bc2 = 1 - torch.tensor(o.b2, dtype=torch.float32) ** count
    mus, nus = tree_leaves(state["mu"]), tree_leaves(state["nu"])
    for p, g, mu_store, nu in zip(tree_leaves(params), grads, mus, nus):
        g = g.to(p.dtype)
        mu = (1 - o.b1) * g + b1_mu * mu_store.float()
        nu.mul_(o.b2).add_((1 - o.b2) * (g * g))
        mu_hat = mu / bc1.to(p.device)
        nu_hat = nu / bc2.to(p.device)
        update = mu_hat / (torch.sqrt(nu_hat + o.eps_root) + o.eps)
        update = update + o.weight_decay * p
        p.add_(-o.lr * update)
        mu_store.copy_(mu)
    return {"count": count, "mu": state["mu"], "nu": state["nu"]}


def _axis_group(mesh, name: str):
    """The process group of mesh axis ``name``, or None when the axis is
    absent or of size 1 (nothing to exchange)."""
    if name not in mesh.mesh_dim_names or _mesh_axis(mesh, name)[0] == 1:
        return None
    return mesh.get_group(name)


def make_sharded_train_state(mesh, init_fn, specs, optimizer=None, abstract=False):
    """((params, opt_state), optimizer): this rank's cut of ``init_fn()``
    (the full tree, built from its seed on every rank) by ``specs`` (a
    tree of specs shaped like it, ``param_specs`` for the model; ``()``
    replicates; ``model.shard_tree``), and the
    optimizer's zero moments shaped like the local shards, as the JAX
    package's ``_opt_shardings_like`` places them.  Shared by the
    tensor-parallel and LoRA layouts.

    ``abstract=True`` returns the local shapes and dtypes as ``meta``
    tensors, a checkpoint-restore target that allocates nothing:
    ``init_fn`` then runs under ``FakeTensorMode``.

    Default optimizer: ``AdamW()``, the first moment in bfloat16 (JAX's
    ``optax.adamw(1e-3, mu_dtype=jnp.bfloat16)``)."""
    optimizer = AdamW() if optimizer is None else optimizer
    if abstract:
        from torch._subclasses.fake_tensor import FakeTensorMode

        with FakeTensorMode(allow_non_fake_inputs=True):
            local = shard_tree(init_fn(), specs, mesh)
        params = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"),
                          local)
        return (params, optimizer.init(params)), optimizer
    params = shard_tree(init_fn(), specs, mesh)
    return (params, optimizer.init(params)), optimizer


def make_sharded_train_step(loss_fn, mesh, optimizer, batch_specs=None, frozen=None):
    """The full train step for a ``loss_fn(params, *batch)`` on this rank:
    (params, opt_state, *batch) -> (params, opt_state, loss), params and
    moments updated in place.

    Each batch argument is the global batch, as the JAX step takes it;
    the rank keeps its slice by its ``batch_specs`` entry (default: one
    tokens array, rows over ``"data"``: ``("data", None)``).  Every
    gradient is averaged over the ``"data"`` group before the update, and
    the returned loss (a detached float32 scalar) is the mean over that
    group: the JAX step's global loss.  ``loss_fn`` computes on the
    rank's local tensors, with whatever collectives its layout needs
    (``make_train_step``'s model hooks, ``make_seq_parallel_train_step``'s
    attention).

    ``frozen`` (a tree of non-trained tensors, e.g. LoRA's base weights)
    is passed as ``loss_fn(params, frozen, *batch)`` and never enters
    autograd.  ``optimizer`` is an ``AdamW``.

    ``mesh=None`` is the one-device step: the whole batch, no exchange.

    Two profiler spans (``torch.profiler.record_function``) mark the
    step's phases: ``train.loss_grad`` around the loss and its gradients,
    ``train.optimizer`` around the update (the data-parallel reduce lies
    between them, in neither).

    ``step.aot_compile(params, opt_state, *batch)`` stands for JAX's
    ahead-of-time compile: it checks the batch's arity and returns
    ``run(params, opt_state, *batch)``, the step itself.  It runs no
    kernel and leaves ``params`` and ``opt_state`` as they are: a warm-up
    step would update them in place, and a CUDA graph capture would
    launch warm-up kernels, which is what a caller preparing the step
    before it takes its chip lease must not do."""
    if batch_specs is None:
        batch_specs = (("data", None),)
    batch_specs = tuple(batch_specs)
    data = None if mesh is None else _axis_group(mesh, "data")
    n_data = _mesh_axis(mesh, "data")[0] if data is not None else 1
    has_frozen = frozen is not None

    def check_arity(batch):
        if len(batch) != len(batch_specs):
            raise ValueError(
                f"expected {len(batch_specs)} batch arguments "
                f"(one per batch_specs entry), got {len(batch)}"
            )

    def step(params, opt_state, *batch):
        check_arity(batch)
        local = batch if mesh is None else tuple(
            shard_leaf(b, spec, mesh) for b, spec in zip(batch, batch_specs))
        args = (frozen, *local) if has_frozen else local
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        try:
            with record_function("train.loss_grad"):
                loss = loss_fn(params, *args)
                grads = list(torch.autograd.grad(loss, leaves))
        finally:
            for p in leaves:
                p.requires_grad_(False)
        loss = loss.detach()
        if data is not None:
            for g in grads:
                torch.distributed.all_reduce(g, group=data)
                g.div_(n_data)
            loss = loss.float().clone()
            torch.distributed.all_reduce(loss, group=data)
            loss.div_(n_data)
        with record_function("train.optimizer"):
            opt_state = adamw(params, grads, opt_state, optimizer)
        return params, opt_state, loss

    def aot_compile(params, opt_state, *batch):
        check_arity(batch)
        return step

    step.aot_compile = aot_compile
    return step


def make_train_state(config: ModelConfig, seed: int = 0, device=None,
                     optimizer: AdamW | None = None, *, mesh=None, abstract: bool = False):
    """((params, opt_state), optimizer): float32 master parameters from
    ``seed`` on ``device`` (None means ``cuda``) and zero moments.

    With a ``mesh``, the state is this rank's cut by ``param_specs``
    (``make_sharded_train_state``) on the mesh's device
    (``distributed.mesh_device``; ``device`` is not read), and
    ``abstract=True`` returns its shapes as ``meta`` tensors."""
    optimizer = AdamW() if optimizer is None else optimizer
    if mesh is None:
        if abstract:
            raise ValueError("abstract=True needs a mesh (make_sharded_train_state)")
        device = resolve_device(device)
        params = init_params(config, prng.PRNGKey(seed, device=device))
        return (params, optimizer.init(params)), optimizer
    from .distributed import mesh_device

    device = mesh_device(mesh)
    return make_sharded_train_state(
        mesh, lambda: init_params(config, prng.PRNGKey(seed, device=device)),
        param_specs(config), optimizer, abstract=abstract)


def _model_loss(config: ModelConfig, mesh, attention_fn=None):
    """``loss_fn`` on a rank's ``param_specs`` cut: the model axis'
    ``enter``/``reduce`` hooks (``distributed.model_hooks``), none for a
    model degree of 1 or no mesh."""
    from .distributed import model_hooks

    enter, reduce = (None, None) if mesh is None else model_hooks(mesh)

    def loss(params, tokens):
        return loss_fn(params, tokens, config, attention_fn, reduce, enter)

    return loss


def make_train_step(config: ModelConfig, optimizer: AdamW | None = None, *, mesh=None):
    """The full training step: (params, opt_state, tokens) ->
    (params, opt_state, loss), with params and moments updated in place
    and ``loss`` a detached float32 scalar tensor.

    With a ``mesh`` (``make_mesh``), the step of a rank holding its
    ``make_train_state(config, mesh=mesh)`` cut: the global ``tokens``
    split over ``"data"``, the weights over ``"model"``
    (``make_sharded_train_step``)."""
    optimizer = AdamW() if optimizer is None else optimizer
    return make_sharded_train_step(_model_loss(config, mesh), mesh, optimizer)


def make_seq_parallel_train_step(config: ModelConfig, mesh, optimizer,
                                 attention: str = "ring"):
    """The sequence-parallel training step: ``make_sharded_train_step``
    over ``loss_fn`` with ``seq_parallel_attention(config, mesh,
    attention)`` as its attention (and the model axis' hooks where the
    mesh cuts the weights)."""
    attention_fn = seq_parallel_attention(config, mesh, attention)
    return make_sharded_train_step(_model_loss(config, mesh, attention_fn), mesh, optimizer)


def seq_parallel_attention(config: ModelConfig, mesh, attention: str = "ring"):
    """The sequence-parallel step's attention: attention runs over the
    mesh's sequence axes, ``attention="ring"`` circulating k/v spans over
    ``"seq"`` (``ops/ring.py``), ``"ulysses"`` re-partitioning seq and
    heads around the local flash kernels K2-K4 (``ops/ulysses.py``; heads
    divisible by the axis), ``"usp"`` both over ``("seq_r", "seq_u")``
    (``ops/usp.py``, ``make_usp_mesh``).  Requires ``max_seq_len - 1``
    divisible by the total seq cut (the LM loss drops one position).

    As in the JAX package, the tokens split over ``"data"`` only and the
    sequence axes appear inside attention: each rank computes q, k and v
    over its rows' whole sequence, takes its span
    (``distributed.seq_slice``), runs the sequence-parallel attention and
    gathers the output (``seq_gather``).  Everything else is computed
    alike on every rank of the sequence axes, so their gradients agree
    without another reduction.  A model axis larger than 1 cuts the
    weights as ``make_train_step`` does.  Returns ``attention_fn(q, k,
    v)`` for ``model.loss_fn``; raises the JAX package's refusals."""
    from .distributed import seq_gather, seq_slice
    from .ops.ring import ring_attention
    from .ops.ulysses import ulysses_attention
    from .ops.usp import seq_join, seq_span, usp_attention

    if config.kv_heads != config.n_heads:
        raise ValueError(
            "sequence-parallel attention does not support grouped-query "
            f"configs yet (n_kv_heads={config.n_kv_heads}); the ring/"
            "ulysses shardings assume equal q and k/v head counts"
        )
    axis_names = set(mesh.mesh_dim_names)
    needed = {"seq_r", "seq_u"} if attention == "usp" else {"seq"}
    if attention in ("ring", "ulysses", "usp") and not needed <= axis_names:
        builder = "make_usp_mesh" if attention == "usp" else "make_sp_mesh"
        raise ValueError(
            f"attention={attention!r} needs mesh axes {sorted(needed)} "
            f"(build the mesh with {builder}); got {mesh.mesh_dim_names}"
        )
    if attention == "usp":
        n_seq = _mesh_axis(mesh, "seq_r")[0] * _mesh_axis(mesh, "seq_u")[0]
        n_uly = _mesh_axis(mesh, "seq_u")[0]
        if config.n_heads % n_uly:
            raise ValueError(
                f"usp attention needs n_heads ({config.n_heads}) divisible by "
                f"the seq_u axis ({n_uly})"
            )
    else:
        n_seq = _mesh_axis(mesh, "seq")[0]
    if (config.max_seq_len - 1) % n_seq:
        raise ValueError(
            f"max_seq_len-1 ({config.max_seq_len - 1}) must divide across the "
            f"seq sharding ({n_seq}); pick max_seq_len = k*{n_seq} + 1"
        )
    if attention in ("ring", "ulysses"):
        if attention == "ulysses" and config.n_heads % n_seq:
            raise ValueError(
                f"ulysses attention needs n_heads ({config.n_heads}) divisible "
                f"by the seq axis ({n_seq}); use attention='ring'"
            )
        core = ring_attention if attention == "ring" else ulysses_attention
        seq = _axis_group(mesh, "seq")

        def attention_fn(q, k, v):
            if seq is not None:
                q, k, v = (seq_slice(t, seq) for t in (q, k, v))
            out = core(q, k, v, mesh, axis="seq")
            return out if seq is None else seq_gather(out, seq)

    elif attention == "usp":

        def attention_fn(q, k, v):
            q, k, v = (seq_span(t, mesh) for t in (q, k, v))
            return seq_join(usp_attention(q, k, v, mesh), mesh)

    else:
        raise ValueError(f"unknown attention {attention!r} (ring|ulysses|usp)")
    return attention_fn


def synthetic_batch(config: ModelConfig, batch_size: int, seed: int = 0,
                    device=None) -> torch.Tensor:
    """JAX's ``synthetic_batch``: uniform random tokens [batch_size,
    max_seq_len] from ``randint(PRNGKey(seed), ..., 0, vocab_size)`` on
    ``device``, JAX's int32 values in int32 (``forward`` and
    ``cross_entropy`` index with ``.long()``, so no cast here)."""
    return prng.randint(prng.PRNGKey(seed, device=device),
                        (batch_size, config.max_seq_len), 0, config.vocab_size)


def _agreed_step(step: int | None, device) -> int | None:
    """The newest checkpoint step every rank of the world holds (the
    minimum of the ranks' newest), or None when one holds none."""
    t = torch.tensor([-1 if step is None else step], dtype=torch.int64, device=device)
    torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.MIN)
    return None if int(t) < 0 else int(t)


def main(argv=None) -> int:
    """``python -m workloads_torch.train --steps 50 --checkpoint-dir /ckpt``.

    Holds the mixed-strategy claim leases first (``lease.py``; a no-op
    without their env), then joins a multi-host slice from the
    daemon-injected env (``distributed.initialize_from_slice_env``, gloo
    for ``--device cpu``, NCCL on the card).  In a world of more than one
    process it trains on ``make_mesh()`` (each rank its cut, the global
    batch split over ``"data"``) and each rank checkpoints its own cut
    under ``--checkpoint-dir/rank<r>``; otherwise the one-device step
    runs.  Resumes from the newest checkpoint (under a mesh, the newest
    step every rank holds), so a preempted run restarts where it left
    off."""
    import argparse

    parser = argparse.ArgumentParser(description="train the flagship model")
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--seq-len", type=int, default=64)
    parser.add_argument("--layers", type=int, default=2)
    parser.add_argument("--checkpoint-dir", default=None)
    parser.add_argument("--checkpoint-every", type=int, default=10)
    parser.add_argument(
        "--profile-dir", default=None,
        help="write a torch.profiler chrome trace of the training loop here",
    )
    parser.add_argument(
        "--coordinator-address", default=None,
        help="host:port of worker 0 for multi-host slices (defaults to the "
        "daemon-injected slice env; ignored on single-host containers)",
    )
    parser.add_argument(
        "--device", default=None,
        help="torch device (default cuda; pass cpu for the plain path)",
    )
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    # Mixed-strategy pods declare their lifetime so the daemon releases
    # cross-view chip claims the moment this process exits (no-op when
    # the claim-lease env is absent).
    from . import lease
    from .distributed import initialize_from_slice_env, world_mesh

    lease.hold_claim_leases()
    if initialize_from_slice_env(coordinator_address=args.coordinator_address,
                                 device=device):
        n = torch.distributed.get_world_size()
        print(f"joined slice as worker {torch.distributed.get_rank()}/{n} "
              f"({n} global devices)", flush=True)
    mesh, device = world_mesh(device)

    config = ModelConfig(max_seq_len=args.seq_len, n_layers=args.layers)
    ckpt = None
    start = 0
    if args.checkpoint_dir:
        from .checkpoint import TrainCheckpointer

        ckpt_dir = args.checkpoint_dir
        if mesh is not None:
            ckpt_dir = os.path.join(ckpt_dir, f"rank{torch.distributed.get_rank()}")
        ckpt = TrainCheckpointer(ckpt_dir)
    latest = None if ckpt is None else ckpt.latest_step
    if mesh is not None and ckpt is not None:
        latest = _agreed_step(latest, device)
    if mesh is None:
        (params, opt_state), optimizer = make_train_state(config, device=device)
    if latest is not None:
        if mesh is None:
            like = (params, opt_state)
        else:
            # Restore onto an abstract target: no throwaway init, so a
            # restart never holds two copies of the state.
            like, optimizer = make_train_state(config, mesh=mesh, abstract=True)
        params, opt_state = ckpt.restore(latest, like=like, device=device)
        start = latest
        print(f"resumed from checkpoint step {start}")
        if start >= args.steps:
            ckpt.close()
            print(f"done: checkpoint step {start} >= --steps {args.steps}; "
                  f"nothing to do")
            return 0
    elif mesh is not None:
        (params, opt_state), optimizer = make_train_state(config, mesh=mesh)
    step = make_train_step(config, optimizer, mesh=mesh)

    profiler = contextlib.nullcontext()
    if args.profile_dir:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        profiler = profile(activities=activities)
    loss = float("nan")
    try:
        with profiler:
            for s in range(start + 1, args.steps + 1):
                tokens = synthetic_batch(config, args.batch_size, seed=s, device=device)
                params, opt_state, loss = step(params, opt_state, tokens)
                checkpoint_due = args.checkpoint_every > 0 and s % args.checkpoint_every == 0
                if ckpt and (checkpoint_due or s == args.steps):
                    ckpt.save(s, (params, opt_state))
                if s % 10 == 0 or s == args.steps:
                    print(f"step {s}: loss={float(loss):.4f}")
    finally:
        if ckpt:
            ckpt.close()
    if args.profile_dir:
        os.makedirs(args.profile_dir, exist_ok=True)
        name = "train_trace.json" if mesh is None else \
            f"train_trace.rank{torch.distributed.get_rank()}.json"
        trace = os.path.join(args.profile_dir, name)
        profiler.export_chrome_trace(trace)
        print(f"profile trace written to {trace}")
    if mesh is None:
        print(f"done: steps={args.steps} device={device} loss={float(loss):.4f}")
        return 0
    shape = dict(zip(mesh.mesh_dim_names, list(mesh.mesh.shape)))
    print(f"done: steps={args.steps} mesh={shape} loss={float(loss):.4f}", flush=True)
    # Every rank leaves together: worker 0 hosts the store.
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
