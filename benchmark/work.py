"""The yardstick's arithmetic: published peaks, and the operations and
bytes that a model's tokens and a kernel's inputs need, from shapes alone.

Copied from the port's own sound counts and kept here so that no change
to the program moves them: the peaks from ``perfbench._PEAK_BF16_FLOPS``
and ``chip_smoke.HBM_BYTES_PER_S``, K1's bytes from ``chip_smoke.py``'s
kernel phase, the flash kernels' operations per causal pair from the
same phase, and the model's FLOPs from ``perfbench.train_step_flops``
with the attention window counted (``perfbench.fwd_attn_flops`` counts
full causal attention whatever the window).

``cfg`` is a configuration file's dict (``configs/<name>.json``).
"""

from __future__ import annotations

# NVIDIA's data sheet for the H100 SXM, dense rates without sparsity, at
# the full 700 W power limit.
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
BF16 = 2


def head_dim(cfg: dict) -> int:
    return cfg["hidden_size"] // cfg["num_attention_heads"]


def kv_heads(cfg: dict) -> int:
    return cfg.get("num_key_value_heads") or cfg["num_attention_heads"]


def layer_matmul_params(cfg: dict) -> int:
    """Weights of one layer's products: q, k, v, o and the two MLP
    matrices (norm gains are not products)."""
    d, hd = cfg["hidden_size"], head_dim(cfg)
    qkv = d * (cfg["num_attention_heads"] + 2 * kv_heads(cfg)) * hd
    return qkv + cfg["num_attention_heads"] * hd * d + 2 * d * cfg["intermediate_size"]


def keys_seen(position: int, window: int | None) -> int:
    """Keys a query at ``position`` (0-based) attends to, itself included."""
    return position + 1 if window is None else min(position + 1, window)


def causal_pairs(seq: int, window: int | None) -> int:
    """(query, key) pairs of one head over ``seq`` positions."""
    if window is None or window >= seq:
        return seq * (seq + 1) // 2
    return window * (window + 1) // 2 + (seq - window) * window


def span_flops(cfg: dict, start: int, stop: int, logits: bool) -> float:
    """Forward FLOPs of the tokens at positions ``start .. stop - 1``:
    their products, q.k and p.v over the keys each sees in every layer,
    and the unembed when their logits are computed."""
    n = stop - start
    if n <= 0:
        return 0.0
    layers = cfg["num_hidden_layers"]
    window = cfg.get("sliding_window")
    keys = (causal_pairs(stop, window) - causal_pairs(start, window))
    attn = 4 * keys * cfg["num_attention_heads"] * head_dim(cfg)
    unembed = 2 * cfg["hidden_size"] * cfg["vocab_size"] * n if logits else 0
    return layers * (2 * layer_matmul_params(cfg) * n + attn) + unembed


def train_step_flops(cfg: dict, batch: int, seq: int) -> float:
    """Model FLOPs of one training step on ``batch`` rows of ``seq``
    predicted positions: three times the forward's products (unembed
    included) and causal attention, the window counted, recompute not
    counted."""
    window = cfg.get("sliding_window")
    layers = cfg["num_hidden_layers"]
    tokens = batch * seq
    p = layers * layer_matmul_params(cfg) + cfg["hidden_size"] * cfg["vocab_size"]
    attn = layers * batch * 4 * causal_pairs(seq, window) * cfg["num_attention_heads"] \
        * head_dim(cfg)
    return 3 * (2 * tokens * p + attn)


def flash_work(cfg: dict, batch: int, seq: int, forwards: int = 1) -> list[tuple[float, float]]:
    """(operations, bytes) of the flash kernels K2, K3 and K4 for one
    step's attention over every layer.  Per causal pair and head: 2*2*hd
    operations in the forward (q.k, p.v), 3*2*hd in the dq kernel and
    4*2*hd in the dk/dv kernel (each recomputes the scores).  Bytes: each
    bf16 [batch, seq, heads, hd] input read once and output written once
    (q, k, v, out: 4; with dout and dq: 5; with dk, dv: 6) and the float32
    row statistics.  ``forwards`` counts the forward's runs (2 when layers
    are recomputed)."""
    layers, hd = cfg["num_hidden_layers"], head_dim(cfg)
    heads = cfg["num_attention_heads"]
    pairs = causal_pairs(seq, cfg.get("sliding_window")) * batch * heads
    elt = batch * seq * heads * hd * BF16
    rows = batch * heads * seq * 4
    per_layer = [(forwards * 4 * hd * pairs, forwards * (4 * elt + rows)),
                 (6 * hd * pairs, 5 * elt + 2 * rows), (8 * hd * pairs, 6 * elt + 2 * rows)]
    return [(layers * f, layers * b) for f, b in per_layer]


def k1_bytes(cfg: dict, position: int) -> int:
    """Bytes K1 needs for one decoded token at ``position`` in bf16:
    every layer reads the live K and V of the keys it sees once, reads q
    and writes the output once."""
    hd = head_dim(cfg)
    kv = 2 * keys_seen(position, cfg.get("sliding_window")) * kv_heads(cfg) * hd
    qo = 2 * cfg["num_attention_heads"] * hd
    return cfg["num_hidden_layers"] * (kv + qo) * BF16


def k1_flops(cfg: dict, position: int) -> float:
    return cfg["num_hidden_layers"] * 4 * keys_seen(position, cfg.get("sliding_window")) \
        * cfg["num_attention_heads"] * head_dim(cfg)


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of operations over
    the bf16 peak and bytes over the bandwidth."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S)


def roofline_share(bound: float, kernel_s: float) -> float | None:
    """Percent of the roofline: ``bound`` seconds over the kernels' time;
    None when no kernel time was read."""
    return 100.0 * bound / kernel_s if kernel_s > 0 else None
