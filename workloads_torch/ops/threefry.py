"""Threefry-2x32 counter hashing: the hand-written CUDA kernel and its
plain PyTorch version.

The hash under every draw of ``workloads_torch.prng``, JAX's threefry2x32
(``jax/_src/prng.py``) with its partitionable counters: element ``e`` of
key ``e // per_key`` hashes the 64-bit counter ``base + e % per_key``,
split into (hi, lo) words as ``iota_2x32_shape`` does.  ``mode`` says
what comes back: ``"pair"`` both words ([n_keys, per_key, 2] int64, for
``split`` and ``fold_in``), ``"bits"`` their xor ([n_keys, per_key]
int64, 32-bit ``random_bits``), ``"uniform"`` float32 in
``[minval, maxval)`` by JAX's bit trick.  Words are int64 tensors
holding values in [0, 2^32).

``threefry`` launches ``csrc/threefry.cu`` on CUDA keys and runs
``threefry_reference`` on CPU keys; there is no other switch, and a
CUDA input the kernel does not take raises.  ``threefry.launches``
counts kernel launches.  The kernel replaces no TPU kernel (XLA's
threefry2x32 has no ``pl.pallas_call``): it folds the plain hash's
~160 elementwise launches into one, inside every sampled decode step.
All of it is integer arithmetic, so the kernel's bits equal the plain
version's exactly; its uniform uses IEEE-rounded multiply and add, so
those are equal too.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensor

from . import _build

MASK = 0xFFFFFFFF
MODES = {"pair": 0, "bits": 1, "uniform": 2}
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) & MASK) | (v >> (32 - r))


def threefry2x32_hash(k0, k1, x0, x1):
    """The threefry2x32 block on int64 tensors of 32-bit words (any
    broadcastable shapes): 20 rounds, the key injected every 4, as
    ``_threefry2x32_lowering`` unrolls it.  Returns (y0, y1)."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def _uniform_scale(minval: float, maxval: float) -> tuple[float, float]:
    """(minval, maxval - minval) as the float32 values JAX computes them."""
    lo = np.float32(minval)
    return float(lo), float(np.float32(maxval) - lo)


def threefry_reference(keys: torch.Tensor, per_key: int, *, mode: str, base: int = 0,
                       minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """The plain version, the kernel's specification (int64 arithmetic
    masked to 32 bits).  keys: [n_keys, 2]."""
    counts = base + torch.arange(per_key, dtype=torch.int64, device=keys.device)
    hi, lo = counts >> 32, counts & MASK
    y0, y1 = threefry2x32_hash(keys[:, :1], keys[:, 1:], hi[None], lo[None])
    if mode == "pair":
        return torch.stack([y0, y1], dim=-1)
    bits = y0 ^ y1
    if mode == "bits":
        return bits
    lo_f, scale = _uniform_scale(minval, maxval)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(floats * scale + lo_f, lo_f)


def _kernel_library():
    lib = _build.load("threefry")
    if not getattr(lib, "_tf_typed", False):
        ptr = ctypes.c_void_p
        lib.threefry_launch.argtypes = [
            ptr, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_ulonglong,  # keys, n, per, base
            ctypes.c_int, ptr, ctypes.c_float, ctypes.c_float, ptr,  # mode, out, min, scale, stream
        ]
        lib.threefry_launch.restype = ctypes.c_int
        lib.threefry_error_string.argtypes = [ctypes.c_int]
        lib.threefry_error_string.restype = ctypes.c_char_p
        lib._tf_typed = True
    return lib


def _empty_out(keys, per_key, mode):
    shape = (keys.shape[0], per_key, 2) if mode == "pair" else (keys.shape[0], per_key)
    dtype = torch.float32 if mode == "uniform" else torch.int64
    return torch.empty(shape, dtype=dtype, device=keys.device)


def _launch(keys, per_key, mode, base, minval, maxval):
    if keys.dtype != torch.int64 or not keys.is_contiguous():
        raise ValueError(f"keys must be contiguous int64, got {keys.dtype} "
                         f"(contiguous: {keys.is_contiguous()})")
    lib = _kernel_library()
    n_keys = keys.shape[0]
    out = _empty_out(keys, per_key, mode)
    if out.numel() == 0:
        return out
    lo_f, scale = _uniform_scale(minval, maxval)
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream(keys.device).cuda_stream
        err = lib.threefry_launch(keys.data_ptr(), n_keys, per_key, base, MODES[mode],
                                  out.data_ptr(), lo_f, scale, stream)
    if err:
        raise RuntimeError(f"threefry kernel launch failed: CUDA error {err} "
                           f"({lib.threefry_error_string(err).decode()})")
    threefry.launches += 1
    return out


def threefry(keys: torch.Tensor, per_key: int, *, mode: str, base: int = 0,
             minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """Hash ``per_key`` counters ``base ..`` under each of ``keys``
    ([n_keys, 2] int64 words).  CUDA keys launch the kernel; CPU keys run
    the plain version."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {sorted(MODES)}, got {mode!r}")
    if keys.ndim != 2 or keys.shape[1] != 2:
        raise ValueError(f"keys must be [n_keys, 2], got {tuple(keys.shape)}")
    if per_key < 0 or base < 0 or base + per_key > 2**62:
        raise ValueError(f"counters {base} + [0, {per_key}) leave [0, 2^62)")
    if isinstance(keys, FakeTensor):
        # Shapes only (``train.make_sharded_train_state(abstract=True)``):
        # a fake tensor holds no words to hash.
        return _empty_out(keys, per_key, mode)
    if keys.is_cuda:
        return _launch(keys, per_key, mode, base, minval, maxval)
    return threefry_reference(keys, per_key, mode=mode, base=base, minval=minval,
                              maxval=maxval)


threefry.launches = 0
