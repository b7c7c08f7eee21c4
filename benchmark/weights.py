"""Seeded inputs: the parameter tree, made on the device from ``--seed``.

The tree is the one ``workloads_torch/model.py`` documents: ``embed``
[vocab, d], ``unembed`` [d, vocab] and ``layers[i]`` with ``ln1``,
``ln2`` [d], the fused ``wqkv`` [d, 3, heads, hd] (with fewer kv heads,
``wq`` [d, heads, hd] and ``wkv`` [d, 2, kv_heads, hd]), ``wo`` [heads,
hd, d], ``w_up`` [d, d_ff] and ``w_down`` [d_ff, d].  Every product's weight is
normal x 0.02 and every norm gain 1, drawn by the benchmark's own
``torch.Generator`` on the device, in the type the cell runs them in, in
a few large calls into one flat buffer that the leaves view.  The same
seed gives the same tensors, which both the port and the reference read.
"""

from __future__ import annotations

import hashlib
import math

import torch

# At most this many elements a draw, so a single call never passes
# 32-bit indexing.
_DRAW = 1 << 30


def derive(seed: int, tag: str) -> int:
    """A 63-bit seed for one named stream of ``seed``."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def generator(seed: int, tag: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(derive(seed, tag))
    return g


def dense_shapes(cfg: dict) -> list[tuple[str, tuple[int, ...]]]:
    """(path, shape) of every product weight, in the flat buffer's order."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    hd, ff, v = d // h, cfg["intermediate_size"], cfg["vocab_size"]
    kv = cfg.get("num_key_value_heads") or h
    attn = ([("wqkv", (d, 3, h, hd))] if kv == h
            else [("wq", (d, h, hd)), ("wkv", (d, 2, kv, hd))])
    shapes = [("embed", (v, d)), ("unembed", (d, v))]
    for i in range(cfg["num_hidden_layers"]):
        shapes += [(f"layers.{i}.{name}", shape) for name, shape in attn]
        shapes += [(f"layers.{i}.wo", (h, hd, d)), (f"layers.{i}.w_up", (d, ff)),
                   (f"layers.{i}.w_down", (ff, d))]
    return shapes


def draw_dense(cfg: dict, seed: int, dtype: torch.dtype, device) -> torch.Tensor:
    """The flat buffer of every product weight, normal x 0.02."""
    total = sum(math.prod(s) for _, s in dense_shapes(cfg))
    flat = torch.empty(total, dtype=dtype, device=device)
    g = generator(seed, "weights", device)
    for start in range(0, total, _DRAW):
        flat[start:start + _DRAW].normal_(0.0, 0.02, generator=g)
    return flat


def make_params(cfg: dict, seed: int, dtype: torch.dtype, device) -> dict:
    """The parameter tree in ``dtype`` on ``device``; every leaf a view of
    one of two flat buffers (weights, gains), detached so autograd sees
    each as a leaf of its own."""
    flat = draw_dense(cfg, seed, dtype, device)
    d, n_layers = cfg["hidden_size"], cfg["num_hidden_layers"]
    gains = torch.ones(2 * n_layers * d, dtype=dtype, device=device)
    leaves = {}
    offset = 0
    for path, shape in dense_shapes(cfg):
        n = math.prod(shape)
        leaves[path] = flat[offset:offset + n].view(shape).detach()
        offset += n
    params = {"embed": leaves["embed"], "unembed": leaves["unembed"], "layers": []}
    for i in range(n_layers):
        layer = {"ln1": gains[2 * i * d:(2 * i + 1) * d].detach(),
                 "ln2": gains[(2 * i + 1) * d:(2 * i + 2) * d].detach()}
        prefix = f"layers.{i}."
        layer.update({path[len(prefix):]: t for path, t in leaves.items()
                      if path.startswith(prefix)})
        params["layers"].append(layer)
    return params


def leaf_items(params: dict):
    """(path, tensor) of every leaf of a tree, in a fixed order."""
    yield "embed", params["embed"]
    yield "unembed", params["unembed"]
    for i, layer in enumerate(params["layers"]):
        for name in sorted(layer):
            yield f"layers.{i}.{name}", layer[name]


def token_ids(seed: int, tag: str, n: int, vocab: int, device) -> torch.Tensor:
    """``n`` token ids uniform over the vocabulary, int64, from one named
    stream of ``seed``."""
    g = generator(seed, tag, device)
    return torch.randint(0, vocab, (n,), generator=g, device=device, dtype=torch.int64)
