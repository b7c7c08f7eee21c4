"""LoRA (low-rank adaptation) fine-tuning, ported from ``workloads/lora.py``.

The base parameters stay frozen (and may be the int8 serving tree of
``quant.quantize_params``); only rank-r adapter factors train.  Adapters
are a separate tree, ``[layer]{target: {"a": [fan_in, r], "b": [r,
fan_out]}}``; the merge ``w + alpha * a @ b`` happens inside the step,
and autograd runs over the adapter leaves alone, so the base is never a
leaf and comes out bit-unchanged.  Optimizer state exists only for the
adapters.

``lora_init`` draws JAX's key stream (``prng``, threefry): one seed
gives the JAX package's factors, within ``prng.normal``'s few ulp.

Under a mesh (``mesh=``, as the JAX step's) the step goes through
``train.make_sharded_train_step`` with the base as its ``frozen``
argument: the adapters and the base are replicated, the global batch is
split over ``"data"`` and the adapters' gradients averaged over it.

    python -m workloads_torch.lora --steps 30 --rank 8
    python -m workloads_torch.lora --device cpu --steps 3 --int8-base
"""

from __future__ import annotations

import torch

from . import prng
from .model import ModelConfig, loss_fn, weight

# Which layer weights get adapters; their (fan_in, fan_out) split comes
# from the contraction-axis table quant.py owns.
_TARGETS = ("wqkv", "wq", "wkv", "wo")


def _fans(name: str, shape: tuple) -> tuple[int, int]:
    from .quant import CONTRACTION_AXES

    axes = CONTRACTION_AXES[name]
    axes = (axes,) if isinstance(axes, int) else axes
    # merge_lora reshapes (a @ b) [fan_in, fan_out] straight onto w's
    # shape, which is only right while the contraction axes are the
    # leading axes; a layout violating that must fail here.
    if tuple(axes) != tuple(range(len(axes))):
        raise ValueError(
            f"LoRA requires {name}'s contraction axes to be its leading "
            f"axes, got {tuple(axes)} for shape {shape}"
        )
    fan_in = fan_out = 1
    for i, s in enumerate(shape):
        if i in axes:
            fan_in *= s
        else:
            fan_out *= s
    return fan_in, fan_out


def _layer_shapes(config: ModelConfig) -> dict:
    """The product weights' shapes of one layer of ``model.init_params``."""
    d, h, hd = config.d_model, config.n_heads, config.head_dim
    shapes = {}
    if config.kv_heads == config.n_heads:
        shapes["wqkv"] = (d, 3, h, hd)
    else:
        shapes["wq"] = (d, h, hd)
        shapes["wkv"] = (d, 2, config.kv_heads, hd)
    shapes["wo"] = (h, hd, d)
    return shapes


def lora_init(
    config: ModelConfig, rank: int, key: torch.Tensor, targets=_TARGETS
) -> list:
    """Adapter tree: per layer, per target weight, ``{"a": [fan_in, r],
    "b": [r, fan_out]}`` float32 on the key's device, each ``a`` under
    the next ``split`` of ``key`` as the JAX package draws it.  ``b``
    starts at zero, so the adapted model is exactly the base at step 0."""
    if rank < 1:
        raise ValueError(f"rank must be >= 1, got {rank}")
    device = key.device
    shapes = _layer_shapes(config)
    adapters = []
    for _ in range(config.n_layers):
        entry = {}
        for name in targets:
            if name not in shapes:
                continue
            fan_in, fan_out = _fans(name, shapes[name])
            key, ka = prng.split(key).unbind(0)
            a = prng.normal(ka, (fan_in, rank))
            entry[name] = {
                "a": a * (1.0 / fan_in**0.5),
                "b": torch.zeros((rank, fan_out), dtype=torch.float32, device=device),
            }
        adapters.append(entry)
    return adapters


def merge_lora(params: dict, adapters: list, alpha: float = 1.0, dtype=None) -> dict:
    """The base tree with each adapted weight replaced by ``w + alpha *
    (a @ b)``, dequantizing int8 bases.  The base is read at float32 (so
    the sum happens at full precision) and the merged weight lands in
    ``dtype`` (default: the leaf's own floating dtype, float32 for an
    int8 leaf).  Differentiable in the factors."""
    if len(adapters) != len(params["layers"]):
        raise ValueError(
            f"adapter/layer count mismatch: {len(adapters)} adapters for "
            f"{len(params['layers'])} layers"
        )
    out = {k: v for k, v in params.items() if k != "layers"}
    layers = []
    for layer, entry in zip(params["layers"], adapters):
        new = dict(layer)
        for name, ab in entry.items():
            leaf = layer[name]
            target = dtype
            if target is None:
                target = (leaf.dtype if isinstance(leaf, torch.Tensor)
                          and leaf.dtype.is_floating_point else torch.float32)
            w = weight(leaf, torch.float32)
            delta = (ab["a"] @ ab["b"]).reshape(w.shape) * alpha
            new[name] = (w + delta).to(target)
        layers.append(new)
    out["layers"] = layers
    return out


def make_lora_train_step(config: ModelConfig, optimizer, base_params: dict,
                         alpha: float = 1.0, mesh=None):
    """The fine-tune step: (adapters, opt_state, tokens) -> (adapters,
    opt_state, loss), with the factors and moments updated in place and
    ``loss`` a detached float32 scalar.  The loss is ``loss_fn(merge_lora(
    base, adapters, alpha, dtype=config.dtype), tokens, config)``; the
    frozen base is an argument of the merge, never a leaf of autograd.
    ``optimizer`` is a ``train.AdamW`` (the JAX package's
    ``optax.adamw(1e-3)`` is ``AdamW(lr=1e-3, mu_dtype=torch.float32)``).

    The step is ``train.make_sharded_train_step(..., frozen=base_params)``
    on ``mesh``.  With a mesh (``train.make_mesh``; the adapters
    replicated, e.g. by ``make_sharded_train_state`` with ``()`` specs),
    each rank takes its rows of the global tokens, and the gradients and
    the loss are averaged over ``"data"``; ``mesh=None`` is one device."""
    from .train import make_sharded_train_step

    def adapter_loss(adapters, base, tokens):
        merged = merge_lora(base, adapters, alpha, dtype=config.dtype)
        return loss_fn(merged, tokens, config)

    return make_sharded_train_step(adapter_loss, mesh, optimizer, frozen=base_params)


def main(argv=None) -> int:
    """``python -m workloads_torch.lora --steps 30 --rank 8``: LoRA
    fine-tune of the flagship on synthetic data, optionally over an int8
    base.  Runs on the card; ``--device cpu`` for the CPU."""
    import argparse

    parser = argparse.ArgumentParser(description="LoRA fine-tune (PyTorch)")
    parser.add_argument("--steps", type=int, default=30)
    parser.add_argument("--rank", type=int, default=8)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--seq-len", type=int, default=64)
    parser.add_argument("--int8-base", action="store_true",
                        help="freeze the base in the int8 serving format")
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; pass cpu for the plain path)")
    args = parser.parse_args(argv)
    if args.steps < 1:
        parser.error("--steps must be >= 1")

    from .distributed import world_mesh
    from .model import init_params
    from .train import AdamW, make_sharded_train_state, synthetic_batch, tree_map

    config = ModelConfig(max_seq_len=args.seq_len)
    # As the JAX CLI: a mesh over the world when one is up (the adapters
    # replicated, the batch split over "data"), else one device.
    mesh, device = world_mesh(args.device)
    base = init_params(config, prng.PRNGKey(0, device=device))
    if args.int8_base:
        from .quant import quantize_params

        base = quantize_params(base)
    optimizer = AdamW(lr=1e-3, mu_dtype=torch.float32)

    def init():
        return lora_init(config, args.rank, prng.PRNGKey(1, device=device))

    if mesh is None:
        adapters = init()
        opt_state = optimizer.init(adapters)
    else:
        (adapters, opt_state), _ = make_sharded_train_state(
            mesh, init, tree_map(lambda _: (), init()), optimizer)
    step = make_lora_train_step(config, optimizer, base, mesh=mesh)
    first = last = None
    for s in range(1, args.steps + 1):
        tokens = synthetic_batch(config, args.batch_size, seed=s, device=device)
        adapters, opt_state, loss = step(adapters, opt_state, tokens)
        if first is None:
            first = float(loss)
        last = float(loss)
        if s % 10 == 0 or s == args.steps:
            print(f"step {s}: loss={last:.4f}")
    print(
        f"done: steps={args.steps} rank={args.rank} "
        f"int8_base={args.int8_base} device={device} loss {first:.4f} -> {last:.4f}"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
