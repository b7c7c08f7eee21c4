"""PyTorch port of the JAX serving and training workloads, for NVIDIA
Hopper (sm_90a).

Mirrors ``workloads/`` module for module (``model``, ``generate``,
``paged``, ``serve``, ``train``, ``checkpoint``, ``errors``, ``faults``,
``ops.paged_attention``, ``ops.attention``, ``ops.kernel_select``) and
imports nothing of it: the JAX package stays the reference, and this package
runs on a host with no JAX installed.  ``decode_graph`` has no JAX
counterpart: it is the port's stand-in for a jitted decode loop, the
serving engine's decode step as a CUDA graph.  ``prng`` is the port's
copy of JAX's threefry keys, so a seed gives the JAX package's weights
and draws.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no CUDA device and no explicit ``cpu`` they raise instead of moving
to the CPU on their own (``default_device``).
"""

from __future__ import annotations

import torch

from .errors import (  # noqa: F401
    EngineClosed,
    InvalidRequest,
    QueueFull,
    RequestTooLarge,
    ServeError,
)

__all__ = [
    "ServeError",
    "InvalidRequest",
    "RequestTooLarge",
    "QueueFull",
    "EngineClosed",
    "default_device",
    "resolve_device",
]


def default_device() -> torch.device:
    """``cuda`` when a CUDA device is present; otherwise a clear error.
    The CPU is never chosen implicitly: pass ``device="cpu"`` for it."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (CLI: "
            "--device cpu) to run the port's plain PyTorch path on the CPU"
        )
    return torch.device("cuda")


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device, or ``default_device()`` for None."""
    if device is None:
        return default_device()
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        return default_device()  # raises with the message above
    return device
