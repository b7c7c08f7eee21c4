"""The decoder-only transformer of ``workloads/model.py``, in PyTorch.

Plain functions over tensors, with the parameters as the same nested
dict as the JAX pytree (``embed``, ``unembed``, ``layers[i]`` with
``ln1``/``ln2``/``wo``/``w_up``/``w_down`` and either the fused MHA
``wqkv`` or the grouped-query ``wq`` + ``wkv``), so a converted JAX tree
(``workloads_torch.convert``) and a tree from ``init_params`` here load
the same way.  Layouts match the JAX package at every public function:
activations are ``[batch, seq, heads, head_dim]``.

Attention has the JAX package's two routes: ``native``, the dense
masked core that the serving engine's prefill runs, and ``flash``
(``ops.attention.flash_attention``, the CUDA kernels K2-K4 on the
card), which ``_attention`` takes for long sequences exactly where the
JAX package does.  ``loss_fn`` is the training loss
(``workloads_torch.train``).  The int8 weight representation comes
with a later slice.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.utils.checkpoint

from .ops import kernel_select


@dataclass(frozen=True)
class ModelConfig:
    vocab_size: int = 256
    d_model: int = 64
    n_heads: int = 4
    n_layers: int = 2
    d_ff: int = 128
    max_seq_len: int = 128
    dtype: torch.dtype = torch.bfloat16
    # "native": the dense masked core.  "flash": the flash kernels
    # (ops/attention.py) for long sequences, routed by _attention.
    attention_impl: str = "native"
    # Grouped-query attention: None = multi-head (kv heads == n_heads).
    n_kv_heads: int | None = None
    # Sliding-window attention: None = full causal span; a positive
    # window bounds each token's attention to the last ``window``
    # positions.
    attention_window: int | None = None
    # Recompute each transformer layer in the backward pass
    # (torch.utils.checkpoint, the counterpart of jax.checkpoint):
    # activations are recomputed instead of stored.
    remat_layers: bool = False

    def __post_init__(self):
        if self.attention_impl not in ("native", "flash"):
            raise ValueError(
                f"attention_impl must be 'native' or 'flash', got {self.attention_impl!r}"
            )
        if self.n_kv_heads is not None and (
            self.n_kv_heads < 1 or self.n_heads % self.n_kv_heads
        ):
            raise ValueError(
                f"n_kv_heads ({self.n_kv_heads}) must be a positive divisor "
                f"of n_heads ({self.n_heads})"
            )
        if self.attention_window is not None and self.attention_window < 1:
            raise ValueError(
                f"attention_window must be >= 1, got {self.attention_window}"
            )
        if self.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(
                f"dtype must be torch.float32 or torch.bfloat16, got "
                f"{self.dtype}"
            )

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads


def init_params(config: ModelConfig, generator: torch.Generator) -> dict:
    """A random parameter tree with the JAX package's tree and law:
    every dense leaf N(0, 0.02) in float32, norm gains 1.  The draws
    come from ``generator`` on its own device, so the tree lands there;
    cast with ``cast_params`` for bf16 serving.  (The values differ from
    ``jax.random``'s; parity tests convert the JAX tree instead.)"""
    device = generator.device
    scale = 0.02

    def dense(*shape):
        return torch.randn(
            shape, generator=generator, device=device, dtype=torch.float32
        ) * scale

    d, h, hd = config.d_model, config.n_heads, config.head_dim
    params = {
        "embed": dense(config.vocab_size, d),
        "unembed": dense(d, config.vocab_size),
        "layers": [],
    }
    for _ in range(config.n_layers):
        layer = {
            "ln1": torch.ones(d, device=device),
            "ln2": torch.ones(d, device=device),
        }
        if config.kv_heads == config.n_heads:
            layer["wqkv"] = dense(d, 3, h, hd)
        else:
            layer["wq"] = dense(d, h, hd)
            layer["wkv"] = dense(d, 2, config.kv_heads, hd)
        layer["wo"] = dense(h, hd, d)
        layer["w_up"] = dense(d, config.d_ff)
        layer["w_down"] = dense(config.d_ff, d)
        params["layers"].append(layer)
    return params


def cast_params(params: dict, dtype: torch.dtype) -> dict:
    """Every leaf in ``dtype`` (the JAX CLI's ``tree.map(astype)``)."""
    return {
        "embed": params["embed"].to(dtype),
        "unembed": params["unembed"].to(dtype),
        "layers": [
            {name: w.to(dtype) for name, w in layer.items()}
            for layer in params["layers"]
        ],
    }


def _rmsnorm(x: torch.Tensor, gain: torch.Tensor) -> torch.Tensor:
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x.float() * torch.rsqrt(var + 1e-6)).to(x.dtype) * gain.to(x.dtype)


def rope_angles(positions: torch.Tensor, head_dim: int) -> torch.Tensor:
    """Rotary angles for the given positions: [n_positions, head_dim//2]."""
    half = head_dim // 2
    exponent = torch.arange(half, dtype=torch.float32, device=positions.device)
    freqs = 1.0 / (10000.0 ** (exponent / half))
    return positions.float()[:, None] * freqs[None, :]


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate x [batch, seq, heads, head_dim] by angles [seq, head_dim//2]
    (seq may be 1 for broadcasting a single position)."""
    half = x.shape[-1] // 2
    cos = torch.cos(angles)[None, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[None, :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def masked_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
    head_dim: int,
) -> torch.Tensor:
    """The scale/mask/float32-softmax attention core over [batch, seq,
    heads, head_dim]; ``mask`` broadcasts to [batch, heads, s_q, s_k].
    k/v may carry fewer heads (grouped-query): each group of
    heads//kv_heads query heads reads one shared k/v head.  As in the JAX
    package the scale is sqrt(head_dim) in the input dtype, applied
    before the float32 softmax."""
    scale = torch.tensor(float(head_dim) ** 0.5, dtype=q.dtype)
    heads, kv_heads = q.shape[2], k.shape[2]
    if heads == kv_heads:
        logits = torch.einsum("bshk,bthk->bhst", q, k) / scale.to(q.device)
        logits = torch.where(mask, logits.float(), -1e30)
        weights = torch.softmax(logits, dim=-1).to(q.dtype)
        return torch.einsum("bhst,bthk->bshk", weights, v)
    group = heads // kv_heads
    batch, s_q = q.shape[:2]
    qg = q.reshape(batch, s_q, kv_heads, group, head_dim)
    logits = torch.einsum("bsngk,btnk->bngst", qg, k) / scale.to(q.device)
    if mask.ndim >= 4 and mask.shape[1] == heads:
        maskg = mask.reshape(mask.shape[0], kv_heads, group, *mask.shape[2:])
    else:
        maskg = mask[:, :, None] if mask.ndim >= 4 else mask
    logits = torch.where(maskg, logits.float(), -1e30)
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bngst,btnk->bsngk", weights, v)
    return out.reshape(batch, s_q, heads, head_dim)


def weight(entry, dtype: torch.dtype) -> torch.Tensor:
    """A weight leaf in compute dtype.  bf16 and f32 leaves only: the
    int8 serving representation is not ported yet."""
    if not isinstance(entry, torch.Tensor):
        raise TypeError(
            f"weight leaves must be tensors (int8 quantized weights are "
            f"not supported by the port yet), got {type(entry).__name__}"
        )
    return entry.to(dtype)


def project_qkv(x: torch.Tensor, layer: dict):
    """(q, k, v) from either the fused MHA projection (wqkv) or the split
    grouped-query pair (wq + wkv)."""
    if "wqkv" in layer:
        qkv = torch.einsum("bsd,dthk->tbshk", x, weight(layer["wqkv"], x.dtype))
        return qkv[0], qkv[1], qkv[2]
    q = torch.einsum("bsd,dhk->bshk", x, weight(layer["wq"], x.dtype))
    kv = torch.einsum("bsd,dthk->tbshk", x, weight(layer["wkv"], x.dtype))
    return q, kv[0], kv[1]


# Routing thresholds for attention_impl="flash", as in the JAX package:
# the dense core below the crossover sequence length, unless its
# [batch, heads, seq, seq] float32 score matrix would pass the cap.  The
# crossover is a hardware property to be measured per device kind; no
# H100 row is measured yet, so every kind takes the default.
_FLASH_MIN_SEQ_BY_KIND: tuple[tuple[str, int], ...] = ()
_FLASH_MIN_SEQ_DEFAULT = 2048
_DENSE_SCORE_BYTES_CAP = 256 << 20


def flash_min_seq() -> int:
    """The flash/dense crossover for the CUDA device of this process
    (the default for kinds not measured, and on the CPU)."""
    kind = kernel_select.device_kind()
    for marker, crossover in _FLASH_MIN_SEQ_BY_KIND:
        if kind is not None and marker in kind:
            return crossover
    return _FLASH_MIN_SEQ_DEFAULT


def _pick_kernel(seq: int) -> str:
    """Per-bucket flash/dense routing (ops/kernel_select.py), with
    ``flash_min_seq()`` as the fallback where no table applies."""
    return kernel_select.kernel_for_seq(seq, default_min_seq=flash_min_seq())


def _attention(
    x: torch.Tensor, layer: dict, config: ModelConfig, attention_fn=None
) -> torch.Tensor:
    batch, seq, _ = x.shape
    q, k, v = project_qkv(x, layer)
    angles = rope_angles(torch.arange(seq, device=x.device), config.head_dim)
    q, k = apply_rope(q, angles), apply_rope(k, angles)
    if attention_fn is not None:
        # An injected core computes full causal spans; training full-span
        # while serving windowed would be a train/serve mismatch.
        if config.attention_window is not None:
            raise ValueError(
                "attention_window is not supported with an injected attention_fn"
            )
        out = attention_fn(q, k, v)
    elif config.attention_impl == "flash" and (
        _pick_kernel(seq) == "flash"
        or 4 * batch * config.n_heads * seq * seq > _DENSE_SCORE_BYTES_CAP
    ):
        from .ops.attention import flash_attention

        out = flash_attention(q, k, v, window=config.attention_window)
    else:
        ids = torch.arange(seq, device=x.device)
        mask = ids[None, :] <= ids[:, None]
        if config.attention_window is not None:
            mask &= ids[None, :] > ids[:, None] - config.attention_window
        out = masked_attention(q, k, v, mask[None, None], config.head_dim)
    return torch.einsum("bshk,hkd->bsd", out, weight(layer["wo"], x.dtype))


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x)`` (the tanh approximation), op for op in x's
    dtype with each constant first rounded to that dtype, as JAX's weakly
    typed scalars are.  In bf16 every intermediate rounds where JAX's
    does, so the result is bit-identical; ``torch.nn.functional.gelu``
    computes in float32 and rounds once, which differs from JAX in many
    bf16 outputs."""
    def const(v: float) -> float:
        return torch.tensor(v, dtype=x.dtype).item()

    inner = const((2.0 / torch.pi) ** 0.5) * (x + const(0.044715) * x**3)
    return x * (0.5 * (1.0 + torch.tanh(inner)))


def _mlp(x: torch.Tensor, layer: dict) -> torch.Tensor:
    hidden = _gelu_tanh(x @ weight(layer["w_up"], x.dtype))
    return hidden @ weight(layer["w_down"], x.dtype)


def forward(
    params: dict, tokens: torch.Tensor, config: ModelConfig, attention_fn=None
) -> torch.Tensor:
    """Logits for next-token prediction.  tokens: [batch, seq] integer."""
    x = params["embed"].to(config.dtype)[tokens.long()]

    def layer_step(x, layer):
        x = x + _attention(_rmsnorm(x, layer["ln1"]), layer, config, attention_fn)
        return x + _mlp(_rmsnorm(x, layer["ln2"]), layer)

    for layer in params["layers"]:
        if config.remat_layers and torch.is_grad_enabled():
            x = torch.utils.checkpoint.checkpoint(
                layer_step, x, layer, use_reentrant=False
            )
        else:
            x = layer_step(x, layer)
    # Final projection in float32 for a stable softmax/loss.
    return x.float() @ weight(params["unembed"], torch.float32)


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token negative log-likelihood."""
    logprobs = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logprobs, -1, targets.long()[..., None])[..., 0]
    return nll.mean()


def loss_fn(
    params: dict, tokens: torch.Tensor, config: ModelConfig, attention_fn=None
) -> torch.Tensor:
    """Causal LM cross-entropy: predict tokens[:, 1:] from tokens[:, :-1]."""
    logits = forward(params, tokens[:, :-1], config, attention_fn)
    return cross_entropy(logits, tokens[:, 1:])
