"""Weight-only int8 quantization for serving, ported from
``workloads/quant.py``.

A quantized leaf is a plain dict ``{"q8": int8, "scale": float32}`` with
one scale per output channel, reduced over the contraction axes of the
consuming product (kept with keepdims, so dequantization broadcasts
back).  ``model.weight`` reads either representation.  Norm gains and
the embedding (a gather, not a product) stay in float.

On the card nothing fuses the dequantization into the product: each
read of a quantized weight materialises a copy in the compute dtype
before the product runs.

The arithmetic follows the JAX package's to the bit: the scale
``amax / 127`` is computed in the weight's own dtype and only then cast
to float32, and ``round(w / scale)`` rounds half to even.
"""

from __future__ import annotations

import torch

# The marker of a quantized leaf; model.weight keys on it.
QUANT_KEY = "q8"

# The per-layer product weights, each with the contraction axis or axes
# of its consuming product: the scale is reduced over them, so it lands
# per output channel.
CONTRACTION_AXES = {
    "wqkv": 0,      # [d, 3, H, hd] contracts d
    "wq": 0,        # [d, H, hd] contracts d
    "wkv": 0,       # [d, 2, Hkv, hd] contracts d
    "wo": (0, 1),   # [H, hd, d] contracts (H, hd)
    "w_up": 0,      # [d, ff] contracts d
    "w_down": 0,    # [ff, d] contracts ff
}


def quantize(w: torch.Tensor, axis=0) -> dict:
    """Symmetric per-output-channel int8: scale = max|w| / 127 reduced
    over ``axis`` (an int or a tuple), in w's dtype, then float32."""
    dims = axis if isinstance(axis, tuple) else (axis,)
    amax = w.abs().amax(dim=dims, keepdim=True)
    # A true division by a tensor: on CUDA a division by a Python scalar
    # multiplies by its reciprocal, which can round one ulp apart.
    scale = torch.where(amax > 0, amax / torch.full_like(amax, 127.0),
                        torch.ones_like(amax)).to(torch.float32)
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return {QUANT_KEY: q, "scale": scale}


def dequantize(entry: dict, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return entry[QUANT_KEY].to(dtype) * entry["scale"].to(dtype)


def is_quantized(entry) -> bool:
    return isinstance(entry, dict) and QUANT_KEY in entry


def quantize_params(params: dict) -> dict:
    """The parameter tree with every product weight (the layers'
    projections and the unembed) stored int8; norm gains and the
    embedding stay float.  New tensors; ``params`` is not changed.  A
    tree with expert layers (``moe``) raises: int8 serving has none."""
    if any("moe" in layer for layer in params["layers"]):
        raise ValueError("int8 weight-only serving has no expert layer: serve an "
                         "expert config's weights as they are")
    out = {k: v for k, v in params.items() if k not in ("layers", "unembed")}
    out["unembed"] = quantize(params["unembed"], axis=0)  # [d, vocab]
    out["layers"] = [
        {k: (quantize(v, axis=CONTRACTION_AXES[k]) if k in CONTRACTION_AXES else v)
         for k, v in layer.items()}
        for layer in params["layers"]
    ]
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def tree_bytes(tree) -> int:
    """Total bytes of a parameter tree's tensors: a quantized tree
    against its source shows what the weight stream saves."""
    return sum(leaf.numel() * leaf.element_size() for leaf in _leaves(tree))
