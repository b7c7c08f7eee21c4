"""Multi-LoRA serving, ported from ``workloads/multi_lora.py``: many
rank-r adapters over ONE shared base, served by one ``ServeEngine``.

* Adapters are STACKED per layer (``{"a": [n+1, fan_in, r], "b": [n+1,
  r, fan_out]}``), index 0 being the zero BASE entry, so the batched
  decode path gathers each row's factors by an index tensor: the
  adapter mix is data, and on the card a change of mix replays the same
  captured graph.
* The adapted weight is never materialised: the delta is applied on the
  activation side, ``x @ W + alpha * (x @ a_i) @ b_i``.
* Rounding follows the JAX package's places: ``_row_delta`` casts ``x``
  to float32 before both products, ``apply_qkv`` adds in float32 and
  rounds once to the compute dtype, and ``wo_row_delta`` scales by
  ``alpha`` before the caller's float32 add.  So a base row (zero
  factors) comes out bit-identical to an unadapted row, in bf16 too.

The factor products are float32 ``einsum`` calls, as in JAX (which runs
them outside any Pallas kernel).  On the card they must not run in TF32:
``torch.backends.cuda.matmul.allow_tf32`` stays False.
"""

from __future__ import annotations

import torch

from . import prng, resolve_device
from .model import ModelConfig


def synthetic_adapters(
    config: ModelConfig,
    n: int,
    rank: int = 8,
    scale: float = 0.1,
    seed: int = 0,
    prefix: str = "tenant",
    device=None,
) -> dict:
    """N trained-looking adapters for demos and tests: ``lora_init``'s
    zero ``b`` is replaced with scaled normals so each tenant changes the
    model.  Draws follow the JAX package's keys, ``PRNGKey(seed)`` for
    the ``b`` factors and ``PRNGKey(seed + 1000 + i)`` for adapter ``i``'s
    ``lora_init``, on ``device`` (None means ``cuda``)."""
    from .lora import lora_init

    device = resolve_device(device)
    key = prng.PRNGKey(seed, device=device)
    out = {}
    for i in range(n):
        ad = lora_init(config, rank, prng.PRNGKey(seed + 1000 + i, device=device))
        for layer in ad:
            for ab in layer.values():
                key, k = prng.split(key).unbind(0)
                ab["b"] = prng.normal(k, ab["b"].shape) * scale
        out[f"{prefix}-{i}"] = ad
    return out


def stack_adapters(adapters: list, config: ModelConfig) -> list:
    """[adapter][layer]{name: {a, b}} -> [layer]{name: {a: [n+1, fi, r],
    b: [n+1, r, fo]}} with the zero BASE adapter prepended at index 0.
    Every adapter must target the same weights at the same rank."""
    if not adapters:
        raise ValueError("stack_adapters needs at least one adapter")
    if config.n_routed_experts:
        raise ValueError("LoRA adapters have no expert layer: serve an expert config "
                         "without adapters")
    n_layers = len(adapters[0])
    for i, ad in enumerate(adapters):
        if len(ad) != n_layers:
            raise ValueError(
                f"adapter {i} has {len(ad)} layers, expected {n_layers}"
            )
    stacked = []
    for li in range(n_layers):
        names = set(adapters[0][li])
        entry = {}
        for i, ad in enumerate(adapters):
            if set(ad[li]) != names:
                raise ValueError(
                    f"adapter {i} targets {sorted(ad[li])} at layer {li}, "
                    f"expected {sorted(names)} (all adapters must target "
                    "the same weights)"
                )
        for name in sorted(names):
            a_list = [ad[li][name]["a"] for ad in adapters]
            b_list = [ad[li][name]["b"] for ad in adapters]
            shapes = {(tuple(a.shape), tuple(b.shape)) for a, b in zip(a_list, b_list)}
            if len(shapes) != 1:
                raise ValueError(
                    f"adapter factor shapes disagree for {name!r} at layer "
                    f"{li}: {sorted(shapes)} (same rank required)"
                )
            a = torch.stack([torch.zeros_like(a_list[0])] + list(a_list))
            b = torch.stack([torch.zeros_like(b_list[0])] + list(b_list))
            entry[name] = {"a": a, "b": b}
        stacked.append(entry)
    return stacked


def _row_delta(x: torch.Tensor, ab: dict, idx: torch.Tensor) -> torch.Tensor:
    """Per-row adapter delta: x [b, fan_in] (or [b, s, fan_in]) through
    each row's own (a, b) factors -> [b(, s), fan_out], in float32."""
    idx = idx.long()
    a = ab["a"][idx]  # [b, fan_in, r]
    b = ab["b"][idx]  # [b, r, fan_out]
    if x.ndim == 2:
        u = torch.einsum("bd,bdr->br", x.float(), a)
        return torch.einsum("br,brf->bf", u, b)
    u = torch.einsum("bsd,bdr->bsr", x.float(), a)
    return torch.einsum("bsr,brf->bsf", u, b)


def qkv_row_deltas(h: torch.Tensor, entry: dict, idx: torch.Tensor,
                   config: ModelConfig):
    """(dq, dk, dv), UNSCALED, for the layer's q/k/v projections from
    per-row adapters (fused ``wqkv`` or split ``wq``/``wkv``), in
    ``model.project_qkv``'s output shapes; None where the layer has no
    such target."""
    lead = h.shape[:-1]  # (b,) or (b, s)
    # Heads by the factors' width: a tensor-parallel rank's factors carry
    # its own heads only (``tp_serve.shard_adapters``).
    hd = config.head_dim
    if "wqkv" in entry:
        d = _row_delta(h, entry["wqkv"], idx).reshape(*lead, 3, -1, hd)
        d = d.movedim(len(lead), 0)
        return d[0], d[1], d[2]
    dq = dk = dv = None
    if "wq" in entry:
        dq = _row_delta(h, entry["wq"], idx).reshape(*lead, -1, hd)
    if "wkv" in entry:
        dkv = _row_delta(h, entry["wkv"], idx).reshape(*lead, 2, -1, hd)
        dkv = dkv.movedim(len(lead), 0)
        dk, dv = dkv[0], dkv[1]
    return dq, dk, dv


def wo_row_delta(attn: torch.Tensor, entry: dict, idx: torch.Tensor,
                 alpha: float):
    """Output-projection delta (alpha-scaled) from per-row adapters:
    attn [b(, s), H, hd] -> [b(, s), d_model]; None when wo is
    untargeted."""
    if "wo" not in entry:
        return None
    flat = attn.reshape(*attn.shape[:-2], attn.shape[-2] * attn.shape[-1])
    return _row_delta(flat, entry["wo"], idx) * alpha


def apply_qkv(q, k, v, h, entry, idx, config, alpha, dtype):
    """q/k/v with the per-row adapter deltas added (alpha-scaled) in
    float32 and rounded once to the compute dtype; untargeted
    projections pass through."""
    dq, dk, dv = qkv_row_deltas(h, entry, idx, config)

    def add(x, d):
        if d is None:
            return x
        return (x.float() + alpha * d).to(dtype)

    return add(q, dq), add(k, dk), add(v, dv)


def apply_wo(proj: torch.Tensor, attn: torch.Tensor, entry: dict, idx: torch.Tensor,
             alpha: float) -> torch.Tensor:
    """The output projection with its per-row delta: ``(proj.float() +
    wo_row_delta).to(proj.dtype)``, or ``proj`` when wo is untargeted."""
    d_wo = wo_row_delta(attn, entry, idx, alpha)
    if d_wo is None:
        return proj
    return (proj.float() + d_wo).to(proj.dtype)
