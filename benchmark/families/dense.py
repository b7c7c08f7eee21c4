"""The ``dense`` block family: the port's one dense decoder block (MHA or
GQA with ``head_dim = hidden_size // num_attention_heads``, one window
for every layer, RoPE over the whole head, RMSNorm, a tanh-GELU MLP).
A configuration file without a ``"family"`` key is of this family.

A block family is a module ``families/<name>.py`` that a configuration
names by its ``"family"`` key (``spec.family``).  It gives, for its
block, what its cells and their metrics' readers use:

- the port's side: ``port_config(cfg, dtype, **extra)``, the port's model
  config, and ``port_train_step(config, optimizer)``, its training step;
- the weights: ``make_params(cfg, seed, dtype, device)``, the tree both
  sides read, and ``leaf_items(params)``, its (path, tensor) leaves in a
  fixed order;
- the reference: ``served_logits(params, prompt, served, cfg, device,
  fp8=False)`` and ``loss_and_grads(params, tokens, cfg, leaves, fp8,
  rows)``;
- the work counts: ``span_flops(cfg, start, stop, logits)``,
  ``train_step_flops(cfg, batch, seq)``, ``flash_work(cfg, batch, seq,
  forwards)``, ``k1_work(cfg, position)`` as (operations, bytes), and the
  kernels' launches a step, ``k1_launches_per_step(cfg)`` and
  ``flash_launches_per_step(cfg, forwards)``.

This family binds the functions of ``weights.py``, ``reference/model.py``,
``work.py`` and ``serving.model_config``.
"""

from __future__ import annotations

from benchmark import serving, weights, work
from benchmark.reference import model as ref

port_config = serving.model_config
make_params = weights.make_params
leaf_items = weights.leaf_items
served_logits = ref.served_logits
loss_and_grads = ref.loss_and_grads
span_flops = work.span_flops
train_step_flops = work.train_step_flops
flash_work = work.flash_work


def port_train_step(config, optimizer):
    from workloads_torch.train import make_train_step

    return make_train_step(config, optimizer)


def k1_work(cfg: dict, position: int) -> tuple[int, int]:
    """(operations, bytes) K1 needs for one token decoded at ``position``."""
    return work.k1_flops(cfg, position), work.k1_bytes(cfg, position)


def k1_launches_per_step(cfg: dict) -> int:
    """K1 runs once a layer a decode step."""
    return cfg["num_hidden_layers"]


def flash_launches_per_step(cfg: dict, forwards: int) -> int:
    """Each layer runs K2 ``forwards`` times, K3 and K4 once, a step."""
    return cfg["num_hidden_layers"] * (forwards + 2)
