"""Training-layout scenarios on gloo CPU worlds, for
tests/test_torch_train_parallel.py, tests/test_torch_seq_parallel.py and
the live JAX writer of tests/test_torch_train_parallel_golden.npz
(tests/test_torch_parity.py's ``write_train_parallel_goldens``).

The layouts as data: ``LAYOUTS`` (data x model meshes for
``train.make_train_step(config, mesh=)``), ``SP_LAYOUTS`` (sequence-
parallel meshes and attention modes for
``train.make_seq_parallel_train_step``) and ``OPS`` (ring, Ulysses and
USP attention alone).  Weights, tokens and attention inputs come from
numpy seeds, so the port's one-device step, every rank of a world and
the JAX package's meshed step all see the same numbers.  The worlds run
through ``tests/torch_tp_world.py``'s ``run_world(..., module=__name__)``.
Nothing here imports JAX.
"""

from __future__ import annotations

import os

import numpy as np
import torch

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "test_torch_train_parallel_golden.npz")
VOCAB = 256
STEPS = 3
BATCH = 4
PARAM_SEED = 3
# The tiny float32 model (d_model 64, 4 heads, 2 layers, d_ff 128) at 17
# tokens: the loss's forward runs at seq 16, which 2 and 4 ranks cut.
CONFIG = dict(vocab_size=VOCAB, d_model=64, n_heads=4, n_layers=2, d_ff=128, max_seq_len=17)

# name: (world, (data, model)).
LAYOUTS = {"dp2": (2, (2, 1)), "tp2": (2, (1, 2)), "tp4": (4, (1, 4)),
           "dp2xtp2": (4, (2, 2))}
# name: (world, attention, mesh builder, its keywords): the JAX tests'
# sequence-parallel steps (tests/test_seq_parallel.py, test_ulysses.py,
# test_usp.py) at 2 and 4 ranks.
SP_LAYOUTS = {
    "ring_sp2": (2, "ring", "sp", dict(seq_parallel=2)),
    "ulysses_sp2": (2, "ulysses", "sp", dict(seq_parallel=2)),
    "ring_sp4": (4, "ring", "sp", dict(seq_parallel=4)),
    "ulysses_sp4": (4, "ulysses", "sp", dict(seq_parallel=4)),
    "ring_dp2_sp2": (4, "ring", "sp", dict(seq_parallel=2)),
    "usp_r2u2": (4, "usp", "usp", dict(ring=2, ulysses=2)),
}
# Attention alone: name: (world, mode, mesh keywords).  Inputs [2, 32, 4,
# 16] float32 (Ulysses over 4 ranks needs the 4 heads).
OPS = {
    "ring2": (2, "ring", dict(seq_parallel=2)),
    "ulysses2": (2, "ulysses", dict(seq_parallel=2)),
    "ring4": (4, "ring", dict(seq_parallel=4)),
    "ulysses4": (4, "ulysses", dict(seq_parallel=4)),
    "usp_r2u2": (4, "usp", dict(ring=2, ulysses=2)),
}
OPS_SHAPE = (2, 32, 4, 16)
LORA_RANK, LORA_SEED, LORA_STEPS = 4, 21, 4


def port_config(**kw):
    from workloads_torch.model import ModelConfig

    return ModelConfig(dtype=torch.float32, **dict(CONFIG, **kw))


def numpy_params(n_layers: int = CONFIG["n_layers"]) -> dict:
    """The JAX package's parameter tree and law (dense leaves N(0, 0.02),
    norm gains 1) as float32 numpy arrays from ``PARAM_SEED``."""
    rng = np.random.default_rng(PARAM_SEED)
    d, h, f = CONFIG["d_model"], CONFIG["n_heads"], CONFIG["d_ff"]
    hd = d // h

    def dense(*shape):
        return (0.02 * rng.standard_normal(shape)).astype(np.float32)

    tree = {"embed": dense(VOCAB, d), "unembed": dense(d, VOCAB), "layers": []}
    for _ in range(n_layers):
        tree["layers"].append({"ln1": np.ones(d, np.float32), "ln2": np.ones(d, np.float32),
                               "wqkv": dense(d, 3, h, hd), "wo": dense(h, hd, d),
                               "w_up": dense(d, f), "w_down": dense(f, d)})
    return tree


def numpy_tokens(step: int) -> np.ndarray:
    """The global batch of step ``step``: [BATCH, max_seq_len] int32."""
    return np.random.default_rng(100 + step).integers(
        0, VOCAB, (BATCH, CONFIG["max_seq_len"])).astype(np.int32)


def numpy_qkv(seed: int = 7, shape=OPS_SHAPE) -> tuple:
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32) for _ in range(3))


def port_params(device="cpu") -> dict:
    from workloads_torch import convert

    return convert.params_from_jax(numpy_params(), device=device)


def flat(tree, prefix: str = "") -> dict:
    """A parameter-shaped tree as {"embed": array, "layers/0/wo": ...}."""
    if isinstance(tree, list):
        out = {}
        for i, t in enumerate(tree):
            out.update(flat(t, f"{prefix}{i}/"))
        return out
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree.detach().cpu().numpy().copy()}


def spec_of(name: str) -> tuple:
    """``param_specs``' entry for a flat leaf name."""
    from workloads_torch.model import param_specs

    specs = param_specs(port_config())
    if "/" not in name:
        return specs[name]
    _, i, leaf = name.split("/")
    return specs["layers"][int(i)][leaf]


def gather_params(ranks: list, model: int) -> dict:
    """The full tree from the ``model`` ranks of data group 0 (ranks
    0..model-1): each leaf cut over ``"model"`` is joined along its cut
    axis in rank order."""
    out = {}
    for name, first in ranks[0]["params"].items():
        spec = spec_of(name)
        if "model" not in spec:
            out[name] = first
            continue
        out[name] = np.concatenate([ranks[r]["params"][name] for r in range(model)],
                                   axis=spec.index("model"))
    return out


# ---- one device ------------------------------------------------------------


def one_device_steps(config=None, steps: int = STEPS) -> dict:
    """The port's one-device ``make_train_step`` on the same weights and
    batches: per-step losses and the final parameters."""
    from workloads_torch import train

    config = port_config() if config is None else config
    params = port_params()
    optimizer = train.AdamW()
    opt = optimizer.init(params)
    step = train.make_train_step(config, optimizer)
    losses = []
    for s in range(steps):
        params, opt, loss = step(params, opt, torch.as_tensor(numpy_tokens(s)))
        losses.append(float(loss))
    return {"losses": losses, "params": flat(params)}


def dense_attention(q, k, v, causal: bool):
    """The port's dense core (``model.masked_attention``) and the
    gradients of sum(out**2) by q, k, v, float32 numpy."""
    from workloads_torch.model import masked_attention

    ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    seq = q.shape[1]
    ids = torch.arange(seq)
    mask = ids[None, :] <= ids[:, None] if causal else torch.ones(seq, seq, dtype=torch.bool)
    out = masked_attention(*ts, mask[None, None], q.shape[-1])
    grads = torch.autograd.grad(out.square().sum(), ts)
    return {"out": out.detach().numpy(), **{f"d{n}": g.numpy() for n, g in zip("qkv", grads)}}


# ---- scenarios a world runs -------------------------------------------------


def _meshed_steps(mesh, step_fn_of, config=None) -> dict:
    from workloads_torch import train
    from workloads_torch.model import param_specs

    config = port_config() if config is None else config
    (params, opt), optimizer = train.make_sharded_train_state(
        mesh, port_params, param_specs(config))
    step = step_fn_of(config, optimizer)
    losses = []
    for s in range(STEPS):
        params, opt, loss = step(params, opt, torch.as_tensor(numpy_tokens(s)))
        losses.append(float(loss))
    return {"losses": losses, "params": flat(params),
            "coords": list(mesh.get_coordinate()),
            "dims": dict(zip(mesh.mesh_dim_names, list(mesh.mesh.shape)))}


def _layout_scenario(name: str):
    def scenario(ctx):
        from workloads_torch.train import make_mesh, make_train_step

        _, (data, model) = LAYOUTS[name]
        mesh = make_mesh(data * model, model_parallel=model, device_type="cpu")
        return _meshed_steps(mesh, lambda c, o: make_train_step(c, o, mesh=mesh))

    return scenario


def s_control_no_enter(ctx) -> dict:
    """TP over the whole world with the model axis' ``enter`` hook left
    out (``reduce`` only): the gradients of every leaf upstream of a
    column-parallel product are then each rank's part alone."""
    from workloads_torch import train
    from workloads_torch.distributed import model_hooks
    from workloads_torch.model import loss_fn

    mesh = train.make_mesh(ctx.world, model_parallel=ctx.world, device_type="cpu")
    _, reduce = model_hooks(mesh)

    def step_of(config, optimizer):
        return train.make_sharded_train_step(
            lambda p, t: loss_fn(p, t, config, None, reduce, None), mesh, optimizer)

    return _meshed_steps(mesh, step_of)


def _sp_mesh(builder: str, kw: dict):
    from workloads_torch.train import make_sp_mesh, make_usp_mesh

    make = make_usp_mesh if builder == "usp" else make_sp_mesh
    return make(device_type="cpu", **kw)


def _sp_scenario(name: str):
    def scenario(ctx):
        from workloads_torch.train import make_seq_parallel_train_step

        _, attention, builder, kw = SP_LAYOUTS[name]
        mesh = _sp_mesh(builder, kw)
        return _meshed_steps(mesh, lambda c, o: make_seq_parallel_train_step(
            c, mesh, o, attention=attention))

    return scenario


def _op_scenario(name: str):
    """The op on this rank's span of the numpy inputs, causal and full:
    the joined output and the gradients of sum(out**2) by the whole q, k
    and v (through ``seq_slice``'s gathering backward)."""

    def scenario(ctx):
        from workloads_torch.distributed import seq_gather, seq_slice
        from workloads_torch.ops.ring import ring_attention
        from workloads_torch.ops.ulysses import ulysses_attention
        from workloads_torch.ops.usp import seq_join, seq_span, usp_attention

        _, mode, kw = OPS[name]
        mesh = _sp_mesh("usp" if mode == "usp" else "sp", kw)
        out = {}
        for causal in (True, False):
            ts = [torch.tensor(x, requires_grad=True) for x in numpy_qkv()]
            if mode == "usp":
                local = [seq_span(t, mesh) for t in ts]
                got = seq_join(usp_attention(*local, mesh, causal=causal), mesh)
            else:
                group = mesh.get_group("seq")
                local = [seq_slice(t, group) for t in ts]
                core = ring_attention if mode == "ring" else ulysses_attention
                got = seq_gather(core(*local, mesh, causal=causal), group)
            grads = torch.autograd.grad(got.square().sum(), ts)
            out["causal" if causal else "full"] = {
                "out": got.detach().numpy(), **{f"d{n}": g.numpy() for n, g in zip("qkv", grads)}}
        return out

    return scenario


def _raises(fn) -> str | None:
    try:
        fn()
    except (ValueError, RuntimeError) as exc:
        return f"{type(exc).__name__}: {exc}"
    return None


def s_sp_refusals(ctx) -> dict:
    """What the sequence-parallel meshes, step and attention refuse on
    this world, as text (each refusal is checked on this rank alone, so
    no collective is left half-entered)."""
    from workloads_torch.distributed import seq_slice
    from workloads_torch.ops.ulysses import ulysses_attention
    from workloads_torch.ops.usp import seq_span, usp_attention
    from workloads_torch.train import (
        AdamW,
        make_seq_parallel_train_step,
        make_sp_mesh,
        make_usp_mesh,
    )

    n = ctx.world
    sp = make_sp_mesh(seq_parallel=n, device_type="cpu")
    out = {
        "sp_zero": _raises(lambda: make_sp_mesh(0, device_type="cpu")),
        "usp_zero": _raises(lambda: make_usp_mesh(0, device_type="cpu")),
        "sp_indivisible": _raises(lambda: make_sp_mesh(seq_parallel=3, device_type="cpu")),
        "sp_too_many": _raises(lambda: make_sp_mesh(n + 2, device_type="cpu")),
        "sp_shape": dict(zip(sp.mesh_dim_names, list(sp.mesh.shape))),
        "gqa": _raises(lambda: make_seq_parallel_train_step(
            port_config(n_kv_heads=2), sp, AdamW())),
        "usp_on_sp": _raises(lambda: make_seq_parallel_train_step(
            port_config(), sp, AdamW(), attention="usp")),
        "bad_seq_len": _raises(lambda: make_seq_parallel_train_step(
            port_config(max_seq_len=16), sp, AdamW())),
        "ulysses_heads": _raises(lambda: make_seq_parallel_train_step(
            port_config(n_heads=3, d_model=48), sp, AdamW(), attention="ulysses")),
        "unknown": _raises(lambda: make_seq_parallel_train_step(
            port_config(), sp, AdamW(), attention="dense")),
        "seq_slice": _raises(lambda: seq_slice(torch.zeros(1, 31, 4, 16), sp.get_group("seq"))),
        "op_heads": _raises(lambda: ulysses_attention(
            *(torch.zeros(1, 8, n + 1, 16) for _ in range(3)), sp)),
    }
    if n == 4:
        usp = make_usp_mesh(device_type="cpu")
        out["usp_shape"] = dict(zip(usp.mesh_dim_names, list(usp.mesh.shape)))
        out["ring_on_usp"] = _raises(lambda: make_seq_parallel_train_step(
            port_config(), usp, AdamW(), attention="ring"))
        out["usp_heads"] = _raises(lambda: make_seq_parallel_train_step(
            port_config(n_heads=1, d_model=64), usp, AdamW(), attention="usp"))
        out["usp_seq"] = _raises(lambda: seq_span(torch.zeros(1, 30, 4, 16), usp))
        out["usp_op_heads"] = _raises(lambda: usp_attention(
            *(torch.zeros(1, 8, 3, 16) for _ in range(3)), usp))
    return out


def lora_steps(mesh=None) -> dict:
    """``LORA_STEPS`` LoRA fine-tune steps over the numpy base (rank
    ``LORA_RANK`` factors from ``LORA_SEED``, ``b`` non-zero so the first
    step's gradient reaches ``a``), optax.adamw(1e-3)'s float32 moments:
    losses, the adapters, and whether the base came out bit-unchanged."""
    from workloads_torch import lora, train

    config = port_config()
    base = port_params()
    before = flat(base)
    shapes = lora._layer_shapes(config)

    def init():
        rng = np.random.default_rng(LORA_SEED)
        adapters = []
        for _ in range(config.n_layers):
            entry = {}
            for target in lora._TARGETS:
                if target in shapes:
                    fan_in, fan_out = lora._fans(target, shapes[target])
                    entry[target] = {
                        "a": torch.tensor(rng.standard_normal((fan_in, LORA_RANK)),
                                          dtype=torch.float32) / fan_in**0.5,
                        "b": 0.01 * torch.tensor(rng.standard_normal((LORA_RANK, fan_out)),
                                                 dtype=torch.float32)}
            adapters.append(entry)
        return adapters

    optimizer = train.AdamW(lr=1e-3, mu_dtype=torch.float32)
    if mesh is None:
        adapters = init()
        opt = optimizer.init(adapters)
    else:
        (adapters, opt), _ = train.make_sharded_train_state(
            mesh, init, train.tree_map(lambda _: (), init()), optimizer)
    start = flat(adapters)
    step = lora.make_lora_train_step(config, optimizer, base, mesh=mesh)
    losses = []
    for s in range(LORA_STEPS):
        adapters, opt, loss = step(adapters, opt, torch.as_tensor(numpy_tokens(s)))
        losses.append(float(loss))
    after = flat(base)
    end = flat(adapters)
    return {"losses": losses, "adapters": end,
            "base_unchanged": all(np.array_equal(before[k], after[k]) for k in before),
            "adapters_moved": all(not np.array_equal(start[k], end[k]) for k in start)}


def s_lora(ctx) -> dict:
    """The LoRA fine-tune on a data-parallel mesh over the whole world."""
    from workloads_torch.train import make_mesh

    return lora_steps(make_mesh(ctx.world, model_parallel=1, device_type="cpu"))


def s_lora_cli(ctx) -> str:
    """``python -m workloads_torch.lora`` inside the world (its mesh
    over every rank): the CLI's output."""
    import contextlib
    import io

    from workloads_torch import lora

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        lora.main(["--device", "cpu", "--steps", "3", "--rank", "2", "--batch-size", "4",
                   "--seq-len", "16"])
    return out.getvalue()


def s_bench_step(ctx) -> dict:
    """``perfbench.time_train_step`` inside the world: it steps on
    ``make_mesh()`` (a (1, world) mesh here) and times the slope."""
    import unittest.mock

    from workloads_torch import perfbench, train

    made = []
    real = train.make_mesh

    def make_mesh(*a, **kw):
        made.append(real(*a, **kw))
        return made[-1]

    with unittest.mock.patch.object(train, "make_mesh", make_mesh):
        secs = perfbench.time_train_step(port_config(), BATCH, device="cpu")
    return {"secs": secs, "dims": [dict(zip(m.mesh_dim_names, list(m.mesh.shape)))
                                   for m in made]}


SCENARIOS = {f"steps:{n}": _layout_scenario(n) for n in LAYOUTS}
SCENARIOS.update({f"sp:{n}": _sp_scenario(n) for n in SP_LAYOUTS})
SCENARIOS.update({f"op:{n}": _op_scenario(n) for n in OPS})
SCENARIOS.update({"control_no_enter": s_control_no_enter, "sp_refusals": s_sp_refusals,
                  "lora": s_lora, "lora_cli": s_lora_cli, "bench_step": s_bench_step})


def train_scenarios(world: int) -> list[str]:
    """tests/test_torch_train_parallel.py's scenarios of a world."""
    names = [f"steps:{n}" for n, (w, _) in LAYOUTS.items() if w == world]
    return names + (["control_no_enter", "lora", "lora_cli", "bench_step"] if world == 2
                    else [])


def seq_scenarios(world: int) -> list[str]:
    """tests/test_torch_seq_parallel.py's scenarios of a world."""
    names = [f"op:{n}" for n, (w, _, _) in OPS.items() if w == world]
    names += [f"sp:{n}" for n, (w, *_) in SP_LAYOUTS.items() if w == world]
    return names + ["sp_refusals"]
