"""Speculative decoding at batch 1, ported from ``workloads/speculative.py``.

A draft model proposes ``gamma`` tokens autoregressively, the target
scores the block ``[cur, d_1..d_gamma]`` in one cached forward
(``generate.decode_block``), and the longest prefix whose greedy picks
agree is committed plus the target's correction (or its bonus token
after a fully accepted block).  Every committed token is the target's
own argmax given its committed prefix, as scored by the block forward.

The JAX version is one ``lax.while_loop`` under jit; here the loop runs
on the host, one round an iteration, and reads each round's accepted
length back.  The caches are dense (``generate.init_kv_cache``) and
updated in place.  Stale entries past the commit point are harmless:
attention masks by position, and later rounds overwrite them before any
mask admits them.  The serving engine's batched, paged speculation is
``paged.paged_spec_round`` and its supersteps.
"""

from __future__ import annotations

import torch

from . import resolve_device
from .generate import decode_block, decode_step, init_kv_cache
from .model import ModelConfig


def _speculative_impl(
    target_params: dict, draft_params: dict, prompt: torch.Tensor,
    target_config: ModelConfig, draft_config: ModelConfig,
    max_new_tokens: int, gamma: int,
):
    batch, prompt_len = prompt.shape
    device = prompt.device
    max_len = prompt_len + max_new_tokens + gamma + 1  # room for overshoot
    t_cache = init_kv_cache(target_config, batch, max_len, device)
    d_cache = init_kv_cache(draft_config, batch, max_len, device)
    # Only the target's last row needs the unembed; the draft's prefill
    # only fills its cache.
    t_logits, t_cache = decode_block(
        target_params, t_cache, prompt, 0, target_config, unembed="last"
    )
    _, d_cache = decode_block(draft_params, d_cache, prompt, 0, draft_config, unembed="none")
    cur = torch.argmax(t_logits[:, -1], dim=-1)
    # A gamma+1 scratch tail: the largest write (n_out = max_new - 1,
    # j = gamma) lands inside the buffer.
    out = torch.zeros((batch, max_new_tokens + gamma + 1), dtype=torch.long, device=device)
    out[:, 0] = cur
    n_out, rounds = 1, 1
    while n_out < max_new_tokens:
        pos = prompt_len + n_out - 1  # cur sits at position pos
        # gamma+1 draft steps: the extra one writes the final proposal's
        # k/v, so a fully accepted round leaves no zero hole in the
        # draft cache.
        tok, proposals = cur, []
        for i in range(gamma + 1):
            logits, d_cache = decode_step(draft_params, d_cache, tok, pos + i, draft_config)
            tok = torch.argmax(logits, dim=-1)
            proposals.append(tok)
        drafts = torch.stack(proposals[:gamma], dim=1)  # [1, gamma]
        block = torch.cat([cur[:, None], drafts], dim=1)
        t_logits, t_cache = decode_block(target_params, t_cache, block, pos, target_config)
        picks = torch.argmax(t_logits, dim=-1)  # [1, gamma+1]
        agree = torch.cat(
            [drafts == picks[:, :-1], torch.zeros((1, 1), dtype=torch.bool, device=device)],
            dim=1,
        )
        n = int(torch.argmin(agree[0].to(torch.uint8)))
        committed = torch.cat([drafts[0, :n], picks[0, n : n + 1]])
        out[0, n_out : n_out + n + 1] = committed
        cur = committed[-1:]
        n_out += n + 1
        rounds += 1
    return out[:, :max_new_tokens], rounds


@torch.inference_mode()
def speculative_generate(
    target_params: dict, draft_params: dict, prompt, target_config: ModelConfig,
    draft_config: ModelConfig, max_new_tokens: int, gamma: int = 4, device=None,
):
    """Greedy speculative decode.  Returns (tokens [1, max_new_tokens],
    rounds): ``rounds`` counts target forwards (the prefill among them),
    max_new_tokens / (gamma + 1) when the draft always agrees and
    max_new_tokens when it never does.  Runs on ``device`` (default
    ``cuda``; pass "cpu" explicitly), where both trees must live."""
    device = resolve_device(device)
    prompt = torch.as_tensor(prompt, device=device).long()
    if prompt.shape[0] != 1:
        raise ValueError(
            "speculative decoding is batch-1 (acceptance lengths diverge "
            f"across rows); got batch {prompt.shape[0]}"
        )
    if prompt.shape[1] < 1:
        raise ValueError("prompt must contain at least one token")
    if gamma < 1:
        raise ValueError(f"gamma must be >= 1, got {gamma}")
    if target_config.vocab_size != draft_config.vocab_size:
        raise ValueError("target and draft must share a vocabulary")
    total = prompt.shape[1] + max_new_tokens + gamma + 1
    for name, config in (("target", target_config), ("draft", draft_config)):
        if total > config.max_seq_len:
            raise ValueError(
                f"prompt + max_new_tokens + gamma overshoot = {total} "
                f"exceeds {name} max_seq_len {config.max_seq_len}"
            )
    return _speculative_impl(
        target_params, draft_params, prompt, target_config, draft_config,
        max_new_tokens, gamma,
    )
