"""A plain float32 reference of the Mellum2 block (Mellum2-12B-A2.5B's
``config.json``), written from the published description and nothing of
the port: no kernel, no cache, no batching.

``cfg`` holds the config's own keys (``hidden_size``,
``num_attention_heads``, ``num_key_value_heads``, ``head_dim``,
``layer_types``, ``sliding_window``, ``rope_parameters`` with a
``sliding_attention`` and a ``full_attention`` entry, ``num_experts``,
``num_experts_per_tok``, ``moe_intermediate_size``, ``norm_topk_prob``,
``rms_norm_eps``); ``params`` the port's tree: ``embed`` [V, d],
``unembed`` [d, V], and each layer's ``ln1``, ``ln2``, ``wq`` [d, H,
hd], ``wkv`` [d, 2, Hkv, hd], ``wo`` [H, hd, d] and ``moe`` with
``router`` [d, E], ``w_gate_up`` [E, d, 2f] (gate columns first) and
``w_down`` [E, f, d].

A layer: ``x + attn(rmsnorm(x))``, then ``x + experts(rmsnorm(x))``.
Attention is grouped-query, causal, and on ``sliding_attention`` layers
a position sees the ``sliding_window`` positions up to its own.  RoPE
rotates the two halves of each head (HF's ``rotate_half``): at
``rope_theta`` on sliding layers, and on full layers with YaRN's
frequencies (float64 here) and cos and sin scaled by its
``attention_factor``.  The experts: a softmax router, the top
``num_experts_per_tok``, their probabilities divided by their sum under
``norm_topk_prob``, and ``sum_e gate_e * down_e(silu(x gate_e) * (x
up_e))``, as a loop over the experts and the tokens routed to each.  No
final norm before the unembed (the port's departure).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def rmsnorm(x, gain, eps):
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * gain


def inv_freq(head_dim: int, rope: dict) -> torch.Tensor:
    """One rope_parameters entry's inverse frequencies [head_dim // 2],
    computed in float64."""
    theta = float(rope["rope_theta"])
    dims = torch.arange(0, head_dim, 2, dtype=torch.float64)
    base = theta ** (dims / head_dim)
    if rope["rope_type"] == "default":
        return 1.0 / base
    assert rope["rope_type"] == "yarn", rope

    def correction_dim(rotations):
        return head_dim * math.log(
            rope["original_max_position_embeddings"] / (rotations * 2 * math.pi)
        ) / (2 * math.log(theta))

    low = max(math.floor(correction_dim(rope["beta_fast"])), 0)
    high = min(math.ceil(correction_dim(rope["beta_slow"])), head_dim - 1)
    ramp = ((torch.arange(head_dim // 2, dtype=torch.float64) - low) / (high - low)).clamp(0, 1)
    extrapolated, interpolated = 1.0 / base, 1.0 / (rope["factor"] * base)
    return interpolated * ramp + extrapolated * (1 - ramp)


def rotate(x: torch.Tensor, positions: torch.Tensor, rope: dict) -> torch.Tensor:
    """x [seq, heads, hd] rotated by position: ``x cos + rotate_half(x) sin``."""
    hd = x.shape[-1]
    angles = positions.double()[:, None] * inv_freq(hd, rope)[None, :]
    emb = torch.cat([angles, angles], dim=-1)
    scale = rope.get("attention_factor", 1.0) if rope["rope_type"] == "yarn" else 1.0
    cos = (emb.cos() * scale).float()[:, None, :]
    sin = (emb.sin() * scale).float()[:, None, :]
    half = hd // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos + rotated * sin


def experts(h: torch.Tensor, moe: dict, cfg: dict) -> torch.Tensor:
    """The routed SwiGLU experts over h [seq, d], a loop over experts."""
    k, f = cfg["num_experts_per_tok"], cfg["moe_intermediate_size"]
    probs = torch.softmax(h @ moe["router"].float(), dim=-1)
    top, chosen = torch.topk(probs, k, dim=-1)
    if cfg["norm_topk_prob"]:
        top = top / top.sum(dim=-1, keepdim=True)
    out = torch.zeros_like(h)
    for e in range(cfg["num_experts"]):
        tokens, slots = torch.nonzero(chosen == e, as_tuple=True)
        if len(tokens) == 0:
            continue
        w = moe["w_gate_up"][e].float()
        gate, up = h[tokens] @ w[:, :f], h[tokens] @ w[:, f:]
        y = (F.silu(gate) * up) @ moe["w_down"][e].float()
        out.index_add_(0, tokens, y * top[tokens, slots][:, None])
    return out


def layer_forward(x: torch.Tensor, layer: dict, i: int, cfg: dict) -> torch.Tensor:
    seq = x.shape[0]
    heads, kv_heads, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                           cfg["head_dim"])
    eps = cfg["rms_norm_eps"]
    kind = cfg["layer_types"][i]
    h = rmsnorm(x, layer["ln1"].float(), eps)
    q = torch.einsum("sd,dhk->shk", h, layer["wq"].float())
    kv = torch.einsum("sd,dthk->tshk", h, layer["wkv"].float())
    positions = torch.arange(seq)
    rope = cfg["rope_parameters"][kind]
    q, k = rotate(q, positions, rope), rotate(kv[0], positions, rope)
    group = heads // kv_heads
    k, v = k.repeat_interleave(group, dim=1), kv[1].repeat_interleave(group, dim=1)
    scores = torch.einsum("shk,thk->hst", q, k) / math.sqrt(hd)
    allowed = positions[None, :] <= positions[:, None]
    if kind == "sliding_attention":
        allowed &= positions[None, :] > positions[:, None] - cfg["sliding_window"]
    probs = torch.softmax(scores.masked_fill(~allowed, float("-inf")), dim=-1)
    attn = torch.einsum("hst,thk->shk", probs, v)
    x = x + torch.einsum("shk,hkd->sd", attn, layer["wo"].float())
    return x + experts(rmsnorm(x, layer["ln2"].float(), eps), layer["moe"], cfg)


@torch.no_grad()
def logits(params: dict, tokens, cfg: dict) -> torch.Tensor:
    """[seq, vocab] float32 logits of one sequence, each position's
    prediction of the next token."""
    tokens = torch.as_tensor(tokens, dtype=torch.long)
    x = params["embed"].float()[tokens]
    for i, layer in enumerate(params["layers"]):
        x = layer_forward(x, layer, i, cfg)
    return x @ params["unembed"].float()
