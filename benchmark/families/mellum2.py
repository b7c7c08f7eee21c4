"""The ``mellum2`` block family: Mellum2-12B-A2.5B-Instruct's decoder
(``configs/mellum2-12b-a2.5b.json``, the published ``config.json``'s
keys).  Each layer: grouped-query attention with ``head_dim`` apart from
``hidden_size / num_attention_heads``, over a ``sliding_window`` on
``sliding_attention`` layers (plain RoPE) and the full causal span on
``full_attention`` layers (YaRN RoPE, ``rope_parameters``); then a
dropless top-``num_experts_per_tok`` softmax router over
``num_experts`` SwiGLU experts of width ``moe_intermediate_size``, gates
renormalised (``norm_topk_prob``); RMSNorm before each; untied
embeddings.

It gives what ``families/dense.py`` lists for a serving cell: the port's
config (``port_config``), the seeded weights and their leaves, the
reference's served logits (``reference/mellum2.py``), the work counts of
a span and of K1, K1's launches a step; and for the expert layer's
readers ``expert_work``.  No Mellum2 training cell exists: the training
functions raise.
"""

from __future__ import annotations

import math

import torch

from benchmark import weights, work
from benchmark.reference import mellum2 as ref

served_logits = ref.served_logits
BF16 = work.BF16


def _no_training(*_args, **_kwargs):
    raise NotImplementedError("the mellum2 family serves only: no Mellum2 training cell exists")


port_train_step = loss_and_grads = train_step_flops = flash_work = _no_training
flash_launches_per_step = _no_training


def windows(cfg: dict) -> list:
    """Each layer's attention window (None: the full causal span)."""
    slide = cfg["sliding_window"] if cfg.get("use_sliding_window", True) else None
    return [slide if kind == "sliding_attention" else None for kind in cfg["layer_types"]]


def port_config(cfg: dict, dtype: torch.dtype, **extra):
    """The port's ``ModelConfig`` for this block at the cell's serving
    context (``max_seq_len``)."""
    from workloads_torch.model import ModelConfig, Yarn

    rope = cfg["rope_parameters"]
    full, slide = rope["full_attention"], rope["sliding_attention"]
    if full["rope_type"] != "yarn" or slide["rope_type"] != "default" \
            or full["rope_theta"] != slide["rope_theta"]:
        raise ValueError(f"the port runs YaRN full layers and plain sliding layers at one "
                         f"rope_theta, got {rope}")
    if len(cfg["layer_types"]) != cfg["num_hidden_layers"] or not cfg["norm_topk_prob"]:
        raise ValueError("the port runs every layer's kind from layer_types, with the "
                         "top-k gates renormalised (norm_topk_prob)")
    return ModelConfig(
        vocab_size=cfg["vocab_size"], d_model=cfg["hidden_size"],
        n_heads=cfg["num_attention_heads"], n_layers=cfg["num_hidden_layers"],
        d_ff=cfg["intermediate_size"], max_seq_len=cfg["max_seq_len"], dtype=dtype,
        n_kv_heads=cfg["num_key_value_heads"], head_dim=cfg["head_dim"],
        rope_theta=float(full["rope_theta"]), layer_windows=tuple(windows(cfg)),
        layer_rope=tuple("yarn" if k == "full_attention" else "default"
                         for k in cfg["layer_types"]),
        yarn=Yarn(full["factor"], full["original_max_position_embeddings"],
                  full["beta_fast"], full["beta_slow"], full["attention_factor"]),
        n_routed_experts=cfg["num_experts"], experts_per_token=cfg["num_experts_per_tok"],
        d_expert=cfg["moe_intermediate_size"], **extra)


def shapes(cfg: dict) -> list[tuple[str, tuple[int, ...]]]:
    """(path, shape) of every product weight, in the flat buffer's order."""
    d, h, kv, hd = (cfg["hidden_size"], cfg["num_attention_heads"],
                    cfg["num_key_value_heads"], cfg["head_dim"])
    e, f, v = cfg["num_experts"], cfg["moe_intermediate_size"], cfg["vocab_size"]
    out = [("embed", (v, d)), ("unembed", (d, v))]
    for i in range(cfg["num_hidden_layers"]):
        out += [(f"layers.{i}.wq", (d, h, hd)), (f"layers.{i}.wkv", (d, 2, kv, hd)),
                (f"layers.{i}.wo", (h, hd, d)), (f"layers.{i}.moe.router", (d, e)),
                (f"layers.{i}.moe.w_gate_up", (e, d, 2 * f)),
                (f"layers.{i}.moe.w_down", (e, f, d))]
    return out


def param_count(cfg: dict) -> int:
    """Every parameter: the products' weights and the two norm gains a
    layer (the port has no final norm)."""
    gains = 2 * cfg["num_hidden_layers"] * cfg["hidden_size"]
    return sum(math.prod(s) for _, s in shapes(cfg)) + gains


def make_params(cfg: dict, seed: int, dtype: torch.dtype, device) -> dict:
    """The parameter tree in ``dtype`` on ``device``: every product weight
    normal x 0.02 from the seed's ``weights`` stream, in a few large
    draws into one flat buffer that the leaves view, every norm gain 1.
    The port's config is built first, so a program that lacks this block
    refuses the cell before any weight is drawn."""
    port_config(cfg, dtype)
    total = sum(math.prod(s) for _, s in shapes(cfg))
    flat = torch.empty(total, dtype=dtype, device=device)
    g = weights.generator(seed, "weights", device)
    for start in range(0, total, weights._DRAW):
        flat[start:start + weights._DRAW].normal_(0.0, 0.02, generator=g)
    d, n_layers = cfg["hidden_size"], cfg["num_hidden_layers"]
    gains = torch.ones(2 * n_layers * d, dtype=dtype, device=device)
    params = {"layers": [{"ln1": gains[2 * i * d:(2 * i + 1) * d].detach(),
                          "ln2": gains[(2 * i + 1) * d:(2 * i + 2) * d].detach(), "moe": {}}
                         for i in range(n_layers)]}
    offset = 0
    for path, shape in shapes(cfg):
        n = math.prod(shape)
        leaf = flat[offset:offset + n].view(shape).detach()
        offset += n
        parts = path.split(".")
        if len(parts) == 1:
            params[path] = leaf
        elif parts[2] == "moe":
            params["layers"][int(parts[1])]["moe"][parts[3]] = leaf
        else:
            params["layers"][int(parts[1])][parts[2]] = leaf
    return params


def leaf_items(params: dict):
    """(path, tensor) of every leaf of a tree, in a fixed order."""
    yield "embed", params["embed"]
    yield "unembed", params["unembed"]
    for i, layer in enumerate(params["layers"]):
        for name in sorted(layer):
            if name == "moe":
                for sub in sorted(layer["moe"]):
                    yield f"layers.{i}.moe.{sub}", layer["moe"][sub]
            else:
                yield f"layers.{i}.{name}", layer[name]


def active_layer_params(cfg: dict) -> int:
    """Weights one token's products read in a layer: q, k, v, o, the
    router and its ``num_experts_per_tok`` experts' three matrices."""
    d, h, kv, hd = (cfg["hidden_size"], cfg["num_attention_heads"],
                    cfg["num_key_value_heads"], cfg["head_dim"])
    attention = d * (h + 2 * kv) * hd + h * hd * d
    experts = cfg["num_experts_per_tok"] * 3 * d * cfg["moe_intermediate_size"]
    return attention + d * cfg["num_experts"] + experts


def span_flops(cfg: dict, start: int, stop: int, logits: bool) -> float:
    """Forward FLOPs of the tokens at positions ``start .. stop - 1``: the
    active products, q.k and p.v over the keys each layer's window lets
    each see, and the unembed when their logits are computed."""
    n = stop - start
    if n <= 0:
        return 0.0
    heads, hd = cfg["num_attention_heads"], cfg["head_dim"]
    pairs = sum(work.causal_pairs(stop, w) - work.causal_pairs(start, w) for w in windows(cfg))
    unembed = 2 * cfg["hidden_size"] * cfg["vocab_size"] * n if logits else 0
    return (cfg["num_hidden_layers"] * 2 * active_layer_params(cfg) * n
            + 4 * pairs * heads * hd + unembed)


def k1_work(cfg: dict, position: int) -> tuple[int, int]:
    """(operations, bytes) K1 needs for one token decoded at ``position``,
    summed over the layers: each reads the live K and V of the keys its
    window lets the token see, in bf16, with q read and the output
    written once."""
    heads, kv, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    flops = nbytes = 0
    for w in windows(cfg):
        keys = work.keys_seen(position, w)
        flops += 4 * keys * heads * hd
        nbytes += (2 * keys * kv * hd + 2 * heads * hd) * BF16
    return flops, nbytes


def k1_launches_per_step(cfg: dict) -> int:
    """K1 runs once a layer a decode step."""
    return cfg["num_hidden_layers"]


def expert_work(cfg: dict) -> tuple[int, int]:
    """(operations of one routed row's SwiGLU products, bytes of one
    expert's three bf16 matrices read once)."""
    per = 3 * cfg["hidden_size"] * cfg["moe_intermediate_size"]
    return 2 * per, per * BF16
