"""A small convolutional classifier, the ``workloads/vision.py`` of the
JAX package in PyTorch: the example-pod workload that trains on a
shared accelerator (``examples/pods/pod-vision-train.yml``).

The parameter tree keeps the JAX package's layouts (HWIO convolution
kernels, NHWC activations), so a converted JAX tree
(``convert.params_from_jax``) loads as is; ``_conv`` runs
``F.conv2d`` on permuted views.  The step is
``train.make_sharded_train_step`` over a ``("data",)`` mesh (pure data
parallelism, the natural cut for a small CNN), or one device, and the
inputs are synthetic MNIST-shaped tensors: no download.  Weights, images
and probe templates draw from ``prng``'s threefry keys in the JAX
package's key schedule, so a seed gives JAX's tree and batches.

Architecture (small on purpose, the upstream MNIST net's shape): conv
3x3 x32 -> conv 3x3 x64 -> 2x2 maxpool -> dense 128 -> dense 10.

    python -m workloads_torch.vision --steps 50 --batch-size 64
    python -m workloads_torch.vision --device cpu --steps 3
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from . import prng, resolve_device
from .model import cross_entropy

# The probe templates' seed: one fixed task for every batch.
TEMPLATE_SEED = 715


@dataclass(frozen=True)
class VisionConfig:
    image_size: int = 28
    channels: int = 1
    n_classes: int = 10
    conv1: int = 32
    conv2: int = 64
    hidden: int = 128
    dtype: torch.dtype = torch.bfloat16


def init_params(config: VisionConfig, key: torch.Tensor) -> dict:
    """N(0, 0.1) float32 weights from the ``prng`` key ``key``, on its
    device: ``split(key, 4)``, one key a leaf in JAX's order."""
    k1, k2, k3, k4 = prng.split(key, 4)
    scale = 0.1
    pooled = config.image_size // 2
    flat = pooled * pooled * config.conv2
    return {
        # HWIO conv layout, jax.lax.conv_general_dilated's native order.
        "conv1": prng.normal(k1, (3, 3, config.channels, config.conv1)) * scale,
        "conv2": prng.normal(k2, (3, 3, config.conv1, config.conv2)) * scale,
        "dense1": prng.normal(k3, (flat, config.hidden)) * scale,
        "dense2": prng.normal(k4, (config.hidden, config.n_classes)) * scale,
    }


def param_specs() -> dict:
    """Replicated weights: a model this size is pure data parallelism."""
    return {"conv1": (), "conv2": (), "dense1": (), "dense2": ()}


def _conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A stride-1 "SAME" convolution: x NHWC, w HWIO -> NHWC."""
    out = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype).permute(3, 2, 0, 1), padding="same")
    return out.permute(0, 2, 3, 1)


def forward(params: dict, images: torch.Tensor, config: VisionConfig) -> torch.Tensor:
    """images ``[batch, H, W, C]`` float -> logits ``[batch, n_classes]``."""
    x = images.to(config.dtype)
    x = torch.relu(_conv(x, params["conv1"]))
    x = torch.relu(_conv(x, params["conv2"]))
    # 2x2 max pool, stride 2, VALID (jax.lax.reduce_window), then flatten
    # in NHWC order.
    x = F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
    x = x.reshape(x.shape[0], -1)
    x = torch.relu(x @ params["dense1"].to(x.dtype))
    # Final projection in float32 for a stable softmax/loss.
    return x.float() @ params["dense2"]


def loss_fn(params, images, labels, config: VisionConfig) -> torch.Tensor:
    return cross_entropy(forward(params, images, config), labels)


def synthetic_batch(config: VisionConfig, batch: int, seed: int = 0, device=None):
    """MNIST-shaped synthetic data with learnable, class-balanced labels:
    images ``uniform(PRNGKey(seed))`` in [0, 1) on ``device`` (None means
    ``cuda``), and each label the argmax over n_classes fixed random
    linear probes of the centred image (iid projections of iid pixels:
    near-uniform over classes, and linearly separable, so the loss
    falls).  The probe templates are ``normal(PRNGKey(TEMPLATE_SEED))``,
    the same for every batch.  As JAX's; returns (images ``[batch, H, W,
    C]`` float32, labels ``[batch]`` int64)."""
    images = prng.uniform(prng.PRNGKey(seed, device=device),
                          (batch, config.image_size, config.image_size, config.channels))
    templates = prng.normal(
        prng.PRNGKey(TEMPLATE_SEED, device=device),
        (config.image_size * config.image_size * config.channels, config.n_classes))
    # Centre the pixels first: positive-mean inputs would correlate every
    # probe through the shared DC component and skew the argmax toward
    # one class.
    labels = torch.argmax((images.reshape(batch, -1) - 0.5) @ templates, dim=-1)
    return images, labels


def make_train_step(config: VisionConfig, mesh, optimizer):
    """(params, opt_state, images, labels) -> (params, opt_state, loss):
    the global batch split over ``"data"`` (``mesh=None``: one device)."""
    from .train import make_sharded_train_step

    return make_sharded_train_step(
        lambda p, images, labels: loss_fn(p, images, labels, config),
        mesh,
        optimizer,
        batch_specs=(("data", None, None, None), ("data",)),
    )


def make_data_mesh(device_type: str | None = None):
    """A ``("data",)`` mesh over every rank of the initialised world."""
    from .train import _data_led_mesh

    return _data_led_mesh(None, {}, device_type)


def main(argv=None) -> int:
    """``python -m workloads_torch.vision --steps 50``, the example-pod
    entry.  Holds the claim leases first (``lease.py``; a no-op without
    their env); trains on a ``("data",)`` mesh over the world when one of
    more than one rank is up, else on one device; AdamW at 1e-3 with a
    float32 first moment (``optax.adamw(1e-3)``)."""
    import argparse

    parser = argparse.ArgumentParser(description="train the vision workload")
    parser.add_argument("--steps", type=int, default=50)
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument(
        "--device", default=None,
        help="torch device (default cuda; pass cpu for the plain path)",
    )
    args = parser.parse_args(argv)
    if args.steps < 1:
        parser.error("--steps must be >= 1")

    from . import lease

    lease.hold_claim_leases()  # mixed-strategy lifetime declaration

    from .distributed import mesh_device
    from .train import AdamW, make_sharded_train_state

    device = resolve_device(args.device)
    mesh = None
    if torch.distributed.is_initialized() and torch.distributed.get_world_size() > 1:
        mesh = make_data_mesh(device.type)
        device = mesh_device(mesh)
    config = VisionConfig()
    (params, opt_state), optimizer = make_sharded_train_state(
        mesh,
        lambda: init_params(config, prng.PRNGKey(0, device=device)),
        param_specs(),
        optimizer=AdamW(lr=1e-3, mu_dtype=torch.float32),
    )
    step = make_train_step(config, mesh, optimizer)
    first = last = None
    for s in range(1, args.steps + 1):
        images, labels = synthetic_batch(config, args.batch_size, seed=s, device=device)
        params, opt_state, loss = step(params, opt_state, images, labels)
        if first is None:
            first = float(loss)
        last = float(loss)
        if s % 10 == 0 or s == args.steps:
            print(f"step {s}: loss={last:.4f}")
    print(f"done: steps={args.steps} loss {first:.4f} -> {last:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
