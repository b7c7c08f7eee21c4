"""KV-cached autoregressive decoding, ported from ``workloads/generate.py``.

The JAX version runs the whole decode as one ``lax.scan`` under jit;
PyTorch runs eagerly, so the scan becomes a Python loop over positions
and the cache is updated IN PLACE (``decode_block`` writes the block's
k/v into the cache it was given and returns that same tensor).  The
numerics follow the JAX package operation for operation: the prefill
block and the serving engine's gathered-view prefill both go through
``decode_block``.

Sampling draws from an explicit ``torch.Generator``.  Its numbers differ
from ``jax.random``'s, so sampled streams are held to the filtered
distribution (``filter_logits``), not token for token; greedy decoding
is exact.
"""

from __future__ import annotations

import torch

from . import resolve_device
from .model import (
    ModelConfig,
    _mlp,
    _rmsnorm,
    apply_rope,
    masked_attention,
    project_qkv,
    rope_angles,
    weight,
)


def init_kv_cache(
    config: ModelConfig, batch: int, max_len: int, device=None
) -> torch.Tensor:
    """Per-layer (k, v) buffers: [layers, 2, batch, max_len, kv_heads,
    head_dim], on ``device`` (None means ``cuda``, ``resolve_device``)."""
    return torch.zeros(
        (config.n_layers, 2, batch, max_len, config.kv_heads, config.head_dim),
        dtype=config.dtype, device=resolve_device(device),
    )


def decode_block(
    params: dict, cache: torch.Tensor, tokens: torch.Tensor, pos: int,
    config: ModelConfig, unembed: str = "all", lora=None, reduce=None,
):
    """A block of ``s`` consecutive tokens through the cached model in
    one forward.  tokens: [batch, s] occupying positions
    ``pos .. pos+s-1``; returns (logits [batch, s, vocab], cache) where
    logits[:, i] predicts the token after position pos+i and ``cache``
    is the input tensor, updated in place.

    ``unembed``: "all" (every row), "last" ([batch, 1, vocab]), "hidden"
    (the final hidden states [batch, s, d_model]) or "none" (cache fill
    only, logits is None).

    ``lora=(stacked, idx, alpha)`` applies PER-ROW adapter deltas to the
    q/k/v and output projections (``multi_lora.py``); None is the plain
    model.  ``reduce`` (None: identity) takes the output of every ``wo``
    and ``w_down`` product, after the adapter's delta: the row-parallel
    all-reduce of a tensor-parallel rank (``tp_serve.py``)."""
    if unembed not in ("all", "last", "none", "hidden"):
        raise ValueError(
            f"unembed must be 'all', 'last', 'hidden' or 'none', got "
            f"{unembed!r}"
        )
    batch, s = tokens.shape
    max_len = cache.shape[3]
    pos = int(pos)
    if not 0 <= pos <= max_len - s:
        # jax's dynamic_update_slice would clamp the start silently.
        raise ValueError(
            f"block at positions {pos}..{pos + s - 1} does not fit a cache "
            f"of length {max_len}"
        )
    device = cache.device
    x = params["embed"].to(config.dtype)[tokens.long()]  # [b, s, d]
    k_pos = torch.arange(max_len, device=device)
    row_pos = pos + torch.arange(s, device=device)
    angles = rope_angles(row_pos, config.head_dim)
    # Row i attends to cache positions <= pos+i (its own slot included),
    # bounded below by the sliding window when the config sets one.
    mask = k_pos[None, :] <= row_pos[:, None]
    if config.attention_window is not None:
        mask &= k_pos[None, :] > row_pos[:, None] - config.attention_window
    mask = mask[None, None]  # [1, 1, s, max_len]
    if lora is not None:
        from .multi_lora import apply_qkv, apply_wo

        stacked, aidx, alpha = lora

    for i, layer in enumerate(params["layers"]):
        h = _rmsnorm(x, layer["ln1"])
        q, k, v = project_qkv(h, layer)  # [b, s, H|Hkv, hd]
        if lora is not None:
            q, k, v = apply_qkv(q, k, v, h, stacked[i], aidx, config, alpha, config.dtype)
        q, k = apply_rope(q, angles), apply_rope(k, angles)
        cache[i, 0, :, pos : pos + s] = k
        cache[i, 1, :, pos : pos + s] = v
        attn = masked_attention(q, cache[i, 0], cache[i, 1], mask, config.head_dim)
        proj = torch.einsum("bshk,hkd->bsd", attn, weight(layer["wo"], x.dtype))
        if lora is not None:
            proj = apply_wo(proj, attn, stacked[i], aidx, alpha)
        if reduce is not None:
            proj = reduce(proj)
        x = x + proj
        x = x + _mlp(_rmsnorm(x, layer["ln2"]), layer, reduce)

    if unembed == "none":
        return None, cache
    if unembed == "hidden":
        return x, cache
    if unembed == "last":
        x = x[:, -1:]
    return x.float() @ weight(params["unembed"], torch.float32), cache


def decode_step(
    params: dict, cache: torch.Tensor, token: torch.Tensor, pos: int,
    config: ModelConfig,
):
    """One token per row ([batch]) at position ``pos``; returns (logits
    [batch, vocab], cache)."""
    logits, cache = decode_block(params, cache, token[:, None], pos, config)
    return logits[:, 0], cache


def filter_logits(
    logits: torch.Tensor, temperature: float, top_k: int, top_p: float
) -> torch.Tensor:
    """Temperature-scaled float32 logits with top-k/nucleus masking
    (-inf outside the kept set) over [..., vocab] — the distribution
    ``sample_logits`` draws from.  Out-of-range knobs (top_k <= 0 or
    >= vocab, top_p <= 0 or >= 1) disable their truncation."""
    vocab = logits.shape[-1]
    lead = logits.shape[:-1]
    logits = logits.reshape(-1, vocab).float()
    logits = logits / max(float(temperature), 1e-3)
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values

    # top-k threshold: the k-th largest logit, disabled -> -inf.
    k_idx = min(max(int(top_k) - 1, 0), vocab - 1)
    kth = sorted_desc[:, k_idx]
    k_cut = kth if 0 < int(top_k) < vocab else torch.full_like(kth, -torch.inf)

    # nucleus threshold: smallest logit whose preceding cumulative mass
    # is < p (the top token is always kept), disabled -> -inf.
    probs = torch.softmax(sorted_desc, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    before = torch.roll(cum, 1, dims=-1)
    before[:, 0] = 0.0
    keep = before < float(top_p)
    p_cut = torch.where(keep, sorted_desc, torch.inf).min(dim=-1).values
    if not 0.0 < float(top_p) < 1.0:
        p_cut = torch.full_like(p_cut, -torch.inf)

    cutoff = torch.maximum(k_cut, p_cut)[:, None]
    # A Python scalar, not a tensor made on the host: a decode step that
    # samples is captured as a CUDA graph, where no host copy may run.
    logits = torch.where(logits >= cutoff, logits, float("-inf"))
    return logits.reshape(*lead, vocab)


def sample_logits(
    logits: torch.Tensor, generator: torch.Generator | None,
    temperature: float, top_k: int, top_p: float,
) -> torch.Tensor:
    """One decision per row of [batch, vocab] float32 logits: argmax
    without a generator, else a draw from ``filter_logits``'s
    distribution with ``generator``.  Returns [batch] int64."""
    if generator is None:
        return torch.argmax(logits, dim=-1)
    filtered = filter_logits(logits, temperature, top_k, top_p)
    probs = torch.softmax(filtered, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


@torch.inference_mode()
def generate(
    params: dict, prompt, config: ModelConfig, max_new_tokens: int,
    temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
    generator: torch.Generator | None = None, device=None,
) -> torch.Tensor:
    """Decode: prompt [batch, prompt_len] -> [batch, max_new_tokens].

    Greedy by default; ``temperature > 0`` samples and requires a
    ``generator``.  Runs on ``device`` (default ``cuda``; pass "cpu"
    explicitly), where ``params`` must already live."""
    device = resolve_device(device)
    if params["embed"].device.type != device.type:
        raise ValueError(
            f"params live on {params['embed'].device}, generate runs on "
            f"{device}: move them first"
        )
    prompt = torch.as_tensor(prompt, device=device).long()
    batch, prompt_len = prompt.shape
    if prompt_len < 1:
        raise ValueError("prompt must contain at least one token")
    if temperature > 0.0 and generator is None:
        raise ValueError("temperature > 0 requires a torch.Generator")
    total = prompt_len + max_new_tokens
    if total > config.max_seq_len:
        raise ValueError(
            f"prompt_len + max_new_tokens = {total} exceeds "
            f"max_seq_len {config.max_seq_len}"
        )
    sampler = generator if temperature > 0.0 else None
    cache = init_kv_cache(config, batch, total, device)
    tok = torch.zeros(batch, dtype=torch.long, device=device)
    outs = []
    # Inside the prompt, feed the ground-truth token; beyond it, the
    # previous pick.  outs[p] is the pick after consuming position p.
    for pos in range(total - 1):
        if pos < prompt_len:
            tok = prompt[:, pos]
        logits, cache = decode_step(params, cache, tok, pos, config)
        tok = sample_logits(logits, sampler, temperature, top_k, top_p)
        outs.append(tok)
    return torch.stack(outs, dim=1)[:, prompt_len - 1 :]
