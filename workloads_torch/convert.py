"""Parameters of the JAX package, as numpy arrays, into the port's tree.

``params_from_jax`` takes the numpy tree of ``workloads.model.init_params``
(leaves as numpy arrays, e.g. after ``jax.device_get``, cast with
``astype(config.dtype)`` as the JAX CLI does) and returns the same tree
of torch tensors.  bfloat16 leaves (``ml_dtypes.bfloat16``) are carried
bit for bit: the array is viewed as 16-bit integers and that buffer as
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


def params_from_jax(tree, device=None) -> dict:
    """The port's parameter dict from the JAX package's numpy tree, on
    ``device`` (None means ``cuda``, ``resolve_device``)."""
    device = resolve_device(device)
    return {
        "embed": tensor_from_numpy(tree["embed"], device),
        "unembed": tensor_from_numpy(tree["unembed"], device),
        "layers": [
            {name: tensor_from_numpy(w, device) for name, w in layer.items()}
            for layer in tree["layers"]
        ],
    }
