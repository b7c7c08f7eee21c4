"""Pipeline, expert-parallel and vision scenarios on gloo CPU worlds, for
tests/test_torch_pipeline.py, tests/test_torch_moe.py,
tests/test_torch_vision.py and the live JAX writers of their goldens
(tests/test_torch_parity.py's ``write_pipeline_goldens``,
``write_moe_goldens`` and ``write_vision_goldens``).

The layouts as data: ``PP_LAYOUTS`` (``("data", "pipe")`` meshes for
``pipeline.make_pipeline_train_step``), ``MOE_LAYOUTS`` (``("data",
"expert", "model")`` meshes for ``moe.make_moe_train_step``) and the
vision CNN's ``("data",)`` mesh.  Weights, tokens and images come from
numpy seeds, so the port's one-device model, every rank of a world and
the JAX package's meshed programs all see the same numbers.  The worlds
run through ``tests/torch_tp_world.py``'s ``run_worlds(...,
module=__name__)``, one world per rank count per test file.  Nothing
here imports JAX.
"""

from __future__ import annotations

import os
from dataclasses import replace

import numpy as np
from workloads_torch import prng
import torch

from tests import torch_train_world as trw

HERE = os.path.dirname(os.path.abspath(__file__))
PIPELINE_GOLDEN = os.path.join(HERE, "test_torch_pipeline_golden.npz")
MOE_GOLDEN = os.path.join(HERE, "test_torch_moe_golden.npz")
VISION_GOLDEN = os.path.join(HERE, "test_torch_vision_golden.npz")
STEPS = trw.STEPS

# ---- pipeline ---------------------------------------------------------------

# The JAX tests' pipeline model (tests/test_pipeline.py): the tiny float32
# model at 4 layers and 17 tokens, 8 rows in 4 microbatches.
PP_CONFIG = dict(trw.CONFIG, n_layers=4)
PP_BATCH, PP_MICRO = 8, 4
# name: (world, (data, pipe)).
PP_LAYOUTS = {"pp2": (2, (1, 2)), "dp2xpp2": (4, (2, 2)), "pp4": (4, (1, 4))}
# The layouts whose loss and gradients are taken on the whole batch.
PP_GRADS = ("pp2", "pp4")


def pp_config(**kw):
    from workloads_torch.model import ModelConfig

    return ModelConfig(dtype=torch.float32, **dict(PP_CONFIG, **kw))


def pp_numpy_layers() -> dict:
    """The sequential tree of the pipeline model (numpy, ``trw``'s law and seed)."""
    return trw.numpy_params(n_layers=PP_CONFIG["n_layers"])


def stack_stages(tree: dict, n_stages: int) -> dict:
    """A sequential tree (numpy or torch) -> the ``[S, L/S, ...]`` stage tree."""
    layers = tree["layers"]
    per = len(layers) // n_stages
    stack = np.stack if isinstance(layers[0]["wo"], np.ndarray) else torch.stack
    return {"embed": tree["embed"], "unembed": tree["unembed"],
            "stages": {name: stack([stack([layers[s * per + i][name] for i in range(per)])
                                    for s in range(n_stages)])
                       for name in layers[0]}}


def unstack_stages(tree: dict) -> dict:
    """The ``[S, L/S, ...]`` stage tree -> the sequential tree."""
    stages = tree["stages"]
    n_stages, per = next(iter(stages.values())).shape[:2]
    return {"embed": tree["embed"], "unembed": tree["unembed"],
            "layers": [{name: leaf[s, i] for name, leaf in stages.items()}
                       for s in range(n_stages) for i in range(per)]}


def pp_tokens(step: int) -> np.ndarray:
    """The pipeline's global batch of step ``step``: [8, 17] int32."""
    return np.random.default_rng(200 + step).integers(
        0, trw.VOCAB, (PP_BATCH, PP_CONFIG["max_seq_len"])).astype(np.int32)


def pp_port_params(n_stages: int, device="cpu") -> dict:
    from workloads_torch import convert

    return convert.params_from_jax(stack_stages(pp_numpy_layers(), n_stages), device=device)


def _pp_mesh(name: str):
    from workloads_torch.pipeline import make_pp_mesh

    world, (_, pipe) = PP_LAYOUTS[name]
    return make_pp_mesh(world, pipe_parallel=pipe, device_type="cpu")


def _coords(mesh) -> dict:
    return {"coords": list(mesh.get_coordinate()),
            "dims": dict(zip(mesh.mesh_dim_names, list(mesh.mesh.shape)))}


def _pp_grads(name: str):
    """``pipeline_loss_fn`` and its gradients on this rank's cut, at the
    initial weights, on the whole batch of step 0."""

    def scenario(ctx):
        from workloads_torch import train
        from workloads_torch.model import shard_tree
        from workloads_torch.pipeline import pipeline_loss_fn, pipeline_param_specs

        mesh = _pp_mesh(name)
        pipe = PP_LAYOUTS[name][1][1]
        config = pp_config()
        params = shard_tree(pp_port_params(pipe), pipeline_param_specs(config), mesh)
        leaves = train.tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss = pipeline_loss_fn(params, torch.as_tensor(pp_tokens(0)), config, mesh, PP_MICRO)
        by_leaf = dict(zip(map(id, leaves), torch.autograd.grad(loss, leaves)))
        grads = train.tree_map(lambda p: by_leaf[id(p)], params)
        return {"loss": loss.item(), "grads": trw.flat(grads), **_coords(mesh)}

    return scenario


def _pp_step_scenario(name: str, control: bool = False):
    """``STEPS`` dp x pp steps on the numpy weights, each on the batch of
    step 0 (a repeated batch, so the loss falls); ``control`` hands the
    activations on detached, so no gradient goes back up the pipe."""

    def scenario(ctx):
        from workloads_torch import train
        from workloads_torch.distributed import handoff
        from workloads_torch.pipeline import (
            make_pipeline_train_step,
            pipeline_loss_fn,
            pipeline_param_specs,
        )

        mesh = _pp_mesh(name)
        pipe = PP_LAYOUTS[name][1][1]
        config = pp_config()
        (params, opt), optimizer = train.make_sharded_train_state(
            mesh, lambda: pp_port_params(pipe), pipeline_param_specs(config))
        if control:
            def detached(x, group):
                return handoff(x.detach(), group)

            step = train.make_sharded_train_step(
                lambda p, t: pipeline_loss_fn(p, t, config, mesh, PP_MICRO, detached),
                mesh, optimizer)
        else:
            step = make_pipeline_train_step(config, mesh, optimizer, PP_MICRO)
        losses = []
        for _ in range(STEPS):
            params, opt, loss = step(params, opt, torch.as_tensor(pp_tokens(0)))
            losses.append(float(loss))
        return {"losses": losses, "params": trw.flat(params), **_coords(mesh)}

    return scenario


def s_pp_cut(ctx) -> dict:
    """The state's cut on ``"pipe"`` (a pp-only mesh over the world): each
    rank's stage leaves are its ``[1, L/S, ...]`` block of the full tree."""
    from workloads_torch.pipeline import (
        init_pipeline_params,
        make_pipeline_train_state,
        make_pp_mesh,
        pipeline_param_specs,
    )

    mesh = make_pp_mesh(ctx.world, pipe_parallel=ctx.world, device_type="cpu")
    config = pp_config()
    (params, _), _ = make_pipeline_train_state(config, mesh, seed=0)
    full = init_pipeline_params(config, ctx.world, prng.PRNGKey(0, device="cpu"))
    stage = ctx.rank
    return {"shapes": {name: tuple(leaf.shape) for name, leaf in params["stages"].items()},
            "full": {name: tuple(leaf.shape) for name, leaf in full["stages"].items()},
            "own_block": all(torch.equal(leaf, full["stages"][name][stage:stage + 1])
                             for name, leaf in params["stages"].items()),
            "replicated": all(torch.equal(params[k], full[k]) for k in ("embed", "unembed")),
            "specs": pipeline_param_specs(config)["stages"], **_coords(mesh)}


def _raises(fn) -> str | None:
    try:
        fn()
    except (ValueError, RuntimeError) as exc:
        return f"{type(exc).__name__}: {exc}"
    return None


def s_pp_refusals(ctx) -> dict:
    """What the pipeline refuses, as text (each on this rank alone)."""
    from workloads_torch.model import ModelConfig, shard_tree
    from workloads_torch.pipeline import (
        init_pipeline_params,
        make_pp_mesh,
        pipeline_loss_fn,
        pipeline_param_specs,
    )

    n = ctx.world
    mesh = make_pp_mesh(n, pipe_parallel=2, device_type="cpu")
    local = shard_tree(pp_port_params(2), pipeline_param_specs(pp_config()), mesh)
    return {
        "layers": _raises(lambda: init_pipeline_params(
            ModelConfig(n_layers=3), 2, prng.PRNGKey(0, device="cpu"))),
        "microbatches": _raises(lambda: pipeline_loss_fn(
            local, torch.zeros((6, PP_CONFIG["max_seq_len"]), dtype=torch.int64), pp_config(),
            mesh, 4)),
        "too_many": _raises(lambda: make_pp_mesh(n + 2, device_type="cpu")),
        "indivisible": _raises(lambda: make_pp_mesh(n, pipe_parallel=3, device_type="cpu")),
    }


# ---- MoE --------------------------------------------------------------------

# The tiny float32 model of tests/torch_train_world.py with its dense FFN
# swapped for 4 experts (MoEConfig's defaults: capacity factor 2.0, aux
# weight 0.01) at 17 tokens, one repeated batch of 4 rows
# (trw.numpy_tokens(0)).
MOE_SEED = 5
# name: (world, (data, expert, model)).
MOE_LAYOUTS = {"ep2": (2, (1, 2, 1)), "dp2": (2, (2, 1, 1)),
               "dp2xep2": (4, (2, 2, 1)), "ep2xtp2": (4, (1, 2, 2))}
MOE_CONTROLS = {"no_enter": "ep2", "local_aux": "dp2"}


def moe_config():
    from workloads_torch.moe import MoEConfig

    return MoEConfig()


def moe_numpy_params() -> dict:
    """``trw.numpy_params`` with each layer's FFN replaced by 4 experts and
    a router (N(0, 0.02) float32 from ``MOE_SEED``)."""
    tree = trw.numpy_params()
    rng = np.random.default_rng(MOE_SEED)
    d, f, e = trw.CONFIG["d_model"], trw.CONFIG["d_ff"], moe_config().n_experts

    def dense(*shape):
        return (0.02 * rng.standard_normal(shape)).astype(np.float32)

    for layer in tree["layers"]:
        del layer["w_up"], layer["w_down"]
        layer["moe"] = {"router": dense(d, e), "w_up": dense(e, d, f),
                        "w_down": dense(e, f, d)}
    return tree


# moe_ffn alone, at the JAX test's shapes (tests/test_moe.py): d_model 16,
# d_ff 32, 4 experts, x [2, 12, 16], capacity factor 1.0 (capacity 3).
FFN_SEED, FFN_SHAPE, FFN_DIMS, FFN_CAPACITY = 9, (2, 12, 16), (16, 32, 4), 1.0


def ffn_numpy() -> tuple:
    """(params, x) of ``moe_ffn`` alone, float32 numpy from ``FFN_SEED``:
    router and experts N(0, 0.02), x standard normal."""
    rng = np.random.default_rng(FFN_SEED)
    d, f, e = FFN_DIMS

    def dense(*shape):
        return (0.02 * rng.standard_normal(shape)).astype(np.float32)

    params = {"router": dense(d, e), "w_up": dense(e, d, f), "w_down": dense(e, f, d)}
    return params, rng.standard_normal(FFN_SHAPE).astype(np.float32)


def moe_port_params(device="cpu") -> dict:
    from workloads_torch import convert

    return convert.params_from_jax(moe_numpy_params(), device=device)


def moe_spec_of(name: str) -> tuple:
    """``moe_param_specs``' entry for a flat leaf name."""
    from workloads_torch.moe import moe_param_specs

    spec = moe_param_specs(trw.port_config())
    for part in name.split("/"):
        spec = spec[int(part)] if isinstance(spec, list) else spec[part]
    return spec


def moe_gather(ranks: list, expert: int, model: int) -> dict:
    """The full tree from data group 0's ranks (rank e * model + m): a leaf
    cut over ``"expert"`` joined over the expert ranks, one cut over
    ``"model"`` over the model ranks, along the cut axis."""
    out = {}
    for name, first in ranks[0]["params"].items():
        spec = moe_spec_of(name)
        if "expert" in spec:
            parts = [ranks[e * model]["params"][name] for e in range(expert)]
            out[name] = np.concatenate(parts, axis=spec.index("expert"))
        elif "model" in spec:
            parts = [ranks[m]["params"][name] for m in range(model)]
            out[name] = np.concatenate(parts, axis=spec.index("model"))
        else:
            out[name] = first
    return out


def moe_one_device_steps(steps: int = STEPS) -> dict:
    """The port's one-device MoE step on the same weights, each step on
    the batch of step 0 (``trw.numpy_tokens(0)``)."""
    from workloads_torch import train
    from workloads_torch.moe import make_moe_train_step

    params = moe_port_params()
    optimizer = train.AdamW()
    opt = optimizer.init(params)
    step = make_moe_train_step(trw.port_config(), moe_config(), None, optimizer)
    losses = []
    for _ in range(steps):
        params, opt, loss = step(params, opt, torch.as_tensor(trw.numpy_tokens(0)))
        losses.append(float(loss))
    return {"losses": losses, "params": trw.flat(params)}


def _moe_mesh(name: str):
    from workloads_torch.moe import make_moe_mesh

    world, (_, expert, model) = MOE_LAYOUTS[name]
    return make_moe_mesh(world, expert_parallel=expert, model_parallel=model,
                         device_type="cpu")


def _moe_step_scenario(name: str, control: str | None = None):
    """``STEPS`` dp x ep x tp steps; ``control`` "no_enter" leaves out the
    expert axis' ``f`` (dispatch input and gate), "local_aux" the data
    group's mean of the aux loss's statistics."""

    def scenario(ctx):
        from workloads_torch import train
        from workloads_torch.moe import (
            expert_hooks,
            make_moe_train_step,
            moe_loss_fn,
            moe_param_specs,
        )

        mesh = _moe_mesh(name)
        config, moe = trw.port_config(), moe_config()
        (params, opt), optimizer = train.make_sharded_train_state(
            mesh, moe_port_params, moe_param_specs(config))
        if control is None:
            step = make_moe_train_step(config, moe, mesh, optimizer)
        else:
            hooks = expert_hooks(mesh)
            hooks = replace(hooks, enter=None) if control == "no_enter" else \
                replace(hooks, mean=None)
            step = train.make_sharded_train_step(
                lambda p, t: moe_loss_fn(p, t, config, moe, mesh, hooks), mesh, optimizer)
        losses = []
        for _ in range(STEPS):
            params, opt, loss = step(params, opt, torch.as_tensor(trw.numpy_tokens(0)))
            losses.append(float(loss))
        return {"losses": losses, "params": trw.flat(params), **_coords(mesh)}

    return scenario


def s_moe_refusals(ctx) -> dict:
    from workloads_torch.moe import make_moe_mesh

    n = ctx.world
    mesh = make_moe_mesh(n, expert_parallel=2, device_type="cpu")
    return {
        "shape": dict(zip(mesh.mesh_dim_names, list(mesh.mesh.shape))),
        "indivisible": _raises(lambda: make_moe_mesh(n, expert_parallel=3, device_type="cpu")),
        "too_many": _raises(lambda: make_moe_mesh(n + 2, device_type="cpu")),
    }


# ---- vision -----------------------------------------------------------------

VISION_SEED, VISION_BATCH = 31, 16
VISION_TRAIN_STEPS = 30


def vision_numpy_params() -> dict:
    """The CNN's tree (HWIO kernels), N(0, 0.1) float32 from ``VISION_SEED``."""
    rng = np.random.default_rng(VISION_SEED)

    def normal(*shape):
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)

    return {"conv1": normal(3, 3, 1, 32), "conv2": normal(3, 3, 32, 64),
            "dense1": normal(14 * 14 * 64, 128), "dense2": normal(128, 10)}


def vision_numpy_batch(step: int, batch: int = VISION_BATCH) -> tuple:
    """Uniform images [batch, 28, 28, 1] float32 and their labels by
    ``synthetic_batch``'s rule over numpy probe templates."""
    rng = np.random.default_rng(300 + step)
    images = rng.uniform(size=(batch, 28, 28, 1)).astype(np.float32)
    templates = np.random.default_rng(715).standard_normal((28 * 28, 10)).astype(np.float32)
    labels = np.argmax((images.reshape(batch, -1) - 0.5) @ templates, axis=-1)
    return images, labels.astype(np.int32)


def vision_port_params(device="cpu") -> dict:
    from workloads_torch import convert

    return convert.params_from_jax(vision_numpy_params(), device=device)


def vision_steps(mesh=None, dtype=torch.float32, steps: int = STEPS) -> dict:
    """``steps`` steps of ``vision.make_train_step`` at AdamW(1e-3) with a
    float32 first moment (``optax.adamw(1e-3)``), on the numpy weights
    and batches: losses and the final parameters."""
    from workloads_torch import train, vision

    config = vision.VisionConfig(dtype=dtype)
    (params, opt), optimizer = train.make_sharded_train_state(
        mesh, vision_port_params, vision.param_specs(),
        optimizer=train.AdamW(lr=1e-3, mu_dtype=torch.float32))
    step = vision.make_train_step(config, mesh, optimizer)
    losses = []
    for s in range(steps):
        images, labels = (torch.as_tensor(a) for a in vision_numpy_batch(s))
        params, opt, loss = step(params, opt, images, labels)
        losses.append(float(loss))
    return {"losses": losses, "params": trw.flat(params)}


def s_vision_steps(ctx) -> dict:
    """The float32 CNN's steps on a ("data",) mesh over the world."""
    from workloads_torch.vision import make_data_mesh

    mesh = make_data_mesh("cpu")
    return {**vision_steps(mesh), **_coords(mesh)}


def s_vision_train(ctx) -> dict:
    """JAX's tests/test_vision.py::test_training_reduces_loss_on_data_mesh:
    the bf16 CNN from seed 0, 30 steps on one synthetic batch of 64 over
    a ("data",) mesh of the world, optax.adamw(1e-3)."""
    from workloads_torch import train, vision

    config = vision.VisionConfig()
    mesh = vision.make_data_mesh("cpu")
    (params, opt), optimizer = train.make_sharded_train_state(
        mesh, lambda: vision.init_params(config, prng.PRNGKey(0, device="cpu")),
        vision.param_specs(), optimizer=train.AdamW(lr=1e-3, mu_dtype=torch.float32))
    step = vision.make_train_step(config, mesh, optimizer)
    images, labels = vision.synthetic_batch(config, 64, seed=0, device="cpu")
    losses = []
    for _ in range(VISION_TRAIN_STEPS):
        params, opt, loss = step(params, opt, images, labels)
        losses.append(float(loss))
    return {"losses": losses, **_coords(mesh)}


# ---- the worlds' scenarios ---------------------------------------------------

SCENARIOS = {f"pp:grads:{n}": _pp_grads(n) for n in PP_GRADS}
SCENARIOS.update({f"pp:steps:{n}": _pp_step_scenario(n) for n in PP_LAYOUTS})
SCENARIOS.update({"pp:control": _pp_step_scenario("pp2", control=True),
                  "pp:cut": s_pp_cut, "pp:refusals": s_pp_refusals})
SCENARIOS.update({f"moe:steps:{n}": _moe_step_scenario(n) for n in MOE_LAYOUTS})
SCENARIOS.update({f"moe:control:{c}": _moe_step_scenario(n, control=c)
                  for c, n in MOE_CONTROLS.items()})
SCENARIOS.update({"moe:refusals": s_moe_refusals, "vision:steps": s_vision_steps,
                  "vision:train": s_vision_train})


def pipeline_scenarios(world: int) -> list[str]:
    """tests/test_torch_pipeline.py's scenarios of a world."""
    names = [f"pp:grads:{n}" for n in PP_GRADS if PP_LAYOUTS[n][0] == world]
    names += [f"pp:steps:{n}" for n, (w, _) in PP_LAYOUTS.items() if w == world]
    return names + (["pp:control", "pp:cut", "pp:refusals"] if world == 2 else ["pp:cut"])


def moe_scenarios(world: int) -> list[str]:
    """tests/test_torch_moe.py's scenarios of a world."""
    names = [f"moe:steps:{n}" for n, (w, _) in MOE_LAYOUTS.items() if w == world]
    names += [f"moe:control:{c}" for c, n in MOE_CONTROLS.items()
              if MOE_LAYOUTS[n][0] == world]
    return names + ["moe:refusals"]


def vision_scenarios(world: int) -> list[str]:
    """tests/test_torch_vision.py's scenarios of a world."""
    return ["vision:steps", "vision:train"]
