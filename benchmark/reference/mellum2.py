"""The Mellum2 decoder in float32, layer by layer: the logits that decide
a Mellum2 serving cell's ``correct`` (``families/mellum2.py``).

Plain ``torch``: it imports nothing of the program and no JAX.  A layer's
weights are read in float32 when it runs, so the model is never held
twice.  Attention: grouped-query (each of ``num_key_value_heads`` k/v
heads serves its group of query heads), causal, on
``sliding_attention`` layers over the ``sliding_window`` positions up to
a query's own; RoPE on the two halves of each head, plain at
``rope_theta`` on sliding layers and YaRN on full layers (the
frequencies of HF ``transformers``' ``_compute_yarn_parameters`` with
``truncate``, computed in float64; cos and sin times
``attention_factor``).  The experts: softmax over the router's logits,
the top ``num_experts_per_tok``, divided by their sum under
``norm_topk_prob``, each token's ``sum gate * down(silu(x gate) * (x
up))`` as a loop over the experts and the tokens routed to each.  No
final norm (the port's departure).  With ``fp8`` every product's
operands are rounded to float8 e4m3 first (the control).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference.model import matmul, rmsnorm


def inv_freq(head_dim: int, rope: dict, device) -> torch.Tensor:
    """One ``rope_parameters`` entry's inverse frequencies, float64."""
    theta = float(rope["rope_theta"])
    base = theta ** (torch.arange(0, head_dim, 2, dtype=torch.float64, device=device)
                     / head_dim)
    if rope["rope_type"] == "default":
        return 1.0 / base
    if rope["rope_type"] != "yarn":
        raise ValueError(f"no rope_type {rope['rope_type']!r} in the reference")

    def correction_dim(rotations: float) -> float:
        return head_dim * math.log(rope["original_max_position_embeddings"]
                                   / (rotations * 2 * math.pi)) / (2 * math.log(theta))

    low = max(math.floor(correction_dim(rope["beta_fast"])), 0)
    high = min(math.ceil(correction_dim(rope["beta_slow"])), head_dim - 1)
    if low == high:
        high += 0.001
    dims = torch.arange(head_dim // 2, dtype=torch.float64, device=device)
    ramp = ((dims - low) / (high - low)).clamp(0, 1)
    return (1.0 / (rope["factor"] * base)) * ramp + (1.0 / base) * (1 - ramp)


def rotate(x: torch.Tensor, positions: torch.Tensor, rope: dict) -> torch.Tensor:
    """x [seq, heads, hd] rotated: ``x cos + rotate_half(x) sin``."""
    hd = x.shape[-1]
    angles = positions.double()[:, None] * inv_freq(hd, rope, x.device)[None, :]
    scale = rope["attention_factor"] if rope["rope_type"] == "yarn" else 1.0
    cos = (torch.cos(angles) * scale).float()[:, None, :]
    sin = (torch.sin(angles) * scale).float()[:, None, :]
    half = hd // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos[..., :half] - x2 * sin[..., :half],
                      x2 * cos[..., :half] + x1 * sin[..., :half]], dim=-1)


def experts(h: torch.Tensor, moe: dict, cfg: dict, fp8: bool = False) -> torch.Tensor:
    """The routed SwiGLU experts over h [seq, d]: a loop over experts."""
    k, f = cfg["num_experts_per_tok"], cfg["moe_intermediate_size"]
    probs = torch.softmax(matmul(h, moe["router"].float(), fp8), dim=-1)
    top, chosen = torch.topk(probs, k, dim=-1)
    if cfg["norm_topk_prob"]:
        top = top / top.sum(dim=-1, keepdim=True)
    out = torch.zeros_like(h)
    for e in range(cfg["num_experts"]):
        tokens, slots = torch.nonzero(chosen == e, as_tuple=True)
        if len(tokens) == 0:
            continue
        w = moe["w_gate_up"][e].float()
        x = h[tokens]
        y = matmul(F.silu(matmul(x, w[:, :f], fp8)) * matmul(x, w[:, f:], fp8),
                   moe["w_down"][e].float(), fp8)
        out.index_add_(0, tokens, y * top[tokens, slots][:, None])
    return out


def block(x: torch.Tensor, layer: dict, kind: str, cfg: dict, fp8: bool = False):
    """One layer over x [seq, d] at positions 0 .. seq-1."""
    seq, d = x.shape
    heads, kv_heads, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                           cfg["head_dim"])
    wq, wkv, wo = layer["wq"].float(), layer["wkv"].float(), layer["wo"].float()
    h = rmsnorm(x, layer["ln1"].float())
    q = matmul(h, wq.reshape(d, -1), fp8).reshape(seq, heads, hd)
    kv = matmul(h, wkv.reshape(d, -1), fp8).reshape(seq, 2, kv_heads, hd)
    positions = torch.arange(seq, device=x.device)
    rope = cfg["rope_parameters"][kind]
    q, k = rotate(q, positions, rope), rotate(kv[:, 0], positions, rope)
    group = heads // kv_heads
    k = k.repeat_interleave(group, dim=1).transpose(0, 1)  # [heads, seq, hd]
    v = kv[:, 1].repeat_interleave(group, dim=1).transpose(0, 1)
    scores = matmul(q.transpose(0, 1), k.transpose(-1, -2), fp8) / math.sqrt(hd)
    allowed = torch.ones(seq, seq, dtype=torch.bool, device=x.device).tril()
    if kind == "sliding_attention" and cfg.get("use_sliding_window", True):
        allowed &= ~torch.ones(seq, seq, dtype=torch.bool,
                               device=x.device).tril(-cfg["sliding_window"])
    probs = torch.softmax(scores.masked_fill(~allowed, float("-inf")), dim=-1)
    del scores
    attn = matmul(probs, v, fp8).transpose(0, 1).reshape(seq, heads * hd)
    del probs
    x = x + matmul(attn, wo.reshape(heads * hd, d), fp8)
    return x + experts(rmsnorm(x, layer["ln2"].float()), layer["moe"], cfg, fp8)


@torch.no_grad()
def served_logits(params: dict, prompt: list[int], served: list[int], cfg: dict,
                  device, fp8: bool = False) -> torch.Tensor:
    """[len(served), vocab] float32 logits at the positions that chose each
    served token: the whole sequence in one causal pass (the prompt, then
    every served token but the last)."""
    seq = torch.tensor(prompt + served[:-1], dtype=torch.int64, device=device)
    x = params["embed"].float()[seq]
    for layer, kind in zip(params["layers"], cfg["layer_types"]):
        x = block(x, layer, kind, cfg, fp8)
    return matmul(x[len(prompt) - 1:], params["unembed"].float(), fp8)
