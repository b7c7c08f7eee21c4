"""The single-device training step of ``workloads/train.py``, in PyTorch.

Forward, backward and an AdamW update on one device:
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

The mesh builders, the sequence-parallel step, claim leases and
multi-host initialisation of the JAX module are not ported here.

    python -m workloads_torch.train --steps 20 --checkpoint-dir /ckpt
    python -m workloads_torch.train --device cpu --steps 3
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass

import torch

from . import resolve_device
from .model import ModelConfig, init_params, loss_fn


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


def make_train_state(config: ModelConfig, seed: int = 0, device=None,
                     optimizer: AdamW | None = None):
    """((params, opt_state), optimizer): float32 master parameters from
    ``seed`` on ``device`` (None means ``cuda``) and zero moments."""
    device = resolve_device(device)
    optimizer = AdamW() if optimizer is None else optimizer
    params = init_params(config, torch.Generator(device).manual_seed(seed))
    return (params, optimizer.init(params)), optimizer


def make_train_step(config: ModelConfig, optimizer: AdamW | None = None):
    """The full training step: (params, opt_state, tokens) ->
    (params, opt_state, loss), with params and moments updated in place
    and ``loss`` a detached float32 scalar tensor."""
    optimizer = AdamW() if optimizer is None else optimizer

    def step(params, opt_state, tokens):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        try:
            loss = loss_fn(params, tokens, config)
            grads = torch.autograd.grad(loss, leaves)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        opt_state = adamw(params, list(grads), opt_state, optimizer)
        return params, opt_state, loss.detach()

    return step


def synthetic_batch(config: ModelConfig, batch_size: int, seed: int = 0,
                    device=None) -> torch.Tensor:
    """Uniform random tokens [batch_size, max_seq_len] int64 from a
    ``torch.Generator`` seeded with ``seed`` on ``device``."""
    device = resolve_device(device)
    g = torch.Generator(device).manual_seed(seed)
    return torch.randint(0, config.vocab_size, (batch_size, config.max_seq_len),
                         generator=g, device=device)


def main(argv=None) -> int:
    """``python -m workloads_torch.train --steps 50 --checkpoint-dir /ckpt``.

    Resumes from the newest checkpoint in --checkpoint-dir, so a
    preempted run restarts where it left off."""
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
        "--device", default=None,
        help="torch device (default cuda; pass cpu for the plain path)",
    )
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    config = ModelConfig(max_seq_len=args.seq_len, n_layers=args.layers)
    ckpt = None
    start = 0
    (params, opt_state), optimizer = make_train_state(config, device=device)
    if args.checkpoint_dir:
        from .checkpoint import TrainCheckpointer

        ckpt = TrainCheckpointer(args.checkpoint_dir)
    if ckpt is not None and ckpt.latest_step is not None:
        params, opt_state = ckpt.restore_latest(like=(params, opt_state))
        start = ckpt.latest_step
        print(f"resumed from checkpoint step {start}")
        if start >= args.steps:
            ckpt.close()
            print(f"done: checkpoint step {start} >= --steps {args.steps}; "
                  f"nothing to do")
            return 0
    step = make_train_step(config, optimizer)

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
        trace = os.path.join(args.profile_dir, "train_trace.json")
        profiler.export_chrome_trace(trace)
        print(f"profile trace written to {trace}")
    print(f"done: steps={args.steps} device={device} loss={float(loss):.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
