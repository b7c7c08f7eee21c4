"""Parameters of the JAX package, as numpy arrays, into the port's tree.

``params_from_jax`` takes a numpy parameter tree of the JAX package
(leaves as numpy arrays, e.g. after ``jax.device_get``, cast with
``astype(config.dtype)`` as the JAX CLI does) and returns the same tree
of torch tensors: dicts and lists are mapped as they are nested, so the
model's tree (``workloads.model.init_params``, with int8 leaves or not),
the pipeline's ``[S, L/S, ...]`` stage tree, the MoE model's
``layers[i]["moe"]`` subtrees and the vision CNN's tree all convert.
bfloat16 leaves (``ml_dtypes.bfloat16``) are carried bit for bit: the
array is viewed as 16-bit integers and that buffer as
``torch.bfloat16``, so no value passes through a float conversion.

Nothing here imports jax; the function only needs the arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from . import resolve_device


def _is_bfloat16(a: np.ndarray) -> bool:
    return a.dtype.name == "bfloat16"


def tensor_from_numpy(a, device) -> torch.Tensor:
    """One leaf on ``device``: float32/int arrays copy as they are,
    bfloat16 arrays by their bits."""
    a = np.asarray(a)
    if _is_bfloat16(a):
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def _tree(tree, device):
    if isinstance(tree, dict):
        return {name: _tree(t, device) for name, t in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree(t, device) for t in tree]
    return tensor_from_numpy(tree, device)


def params_from_jax(tree, device=None) -> dict:
    """The port's parameter tree from the JAX package's numpy tree, on
    ``device`` (None means ``cuda``, ``resolve_device``), every dict and
    list mapped as nested.  Quantized leaves (the int8 tree of
    ``workloads.quant.quantize_params``, ``{"q8": int8, "scale":
    float32}``), in a layer or as ``unembed``, carry across as int8 and
    float32 tensors."""
    return _tree(tree, resolve_device(device))


def adapters_from_jax(adapters: dict, device=None) -> dict:
    """The engine's ``adapters=`` from the JAX package's numpy adapter
    trees, ``{name: [layer]{target: {"a": ..., "b": ...}}}``, bit for
    bit, on ``device`` (None means ``cuda``)."""
    return _tree(adapters, resolve_device(device))
