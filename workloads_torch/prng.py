"""JAX's threefry PRNG keys and samplers, in PyTorch.

The port's own copy of what the JAX package draws with from
``jax/_src/prng.py`` and ``jax/_src/random.py`` (JAX 0.9 with
``jax_threefry_partitionable``, its default): ``PRNGKey``, ``split``,
``fold_in``, ``random_bits``, ``uniform``, ``randint``, ``normal``,
``gumbel`` (JAX's default "low" mode) and ``categorical``.  A key is an
int64 tensor ``[2]`` holding two 32-bit words, on an explicit device;
keys are values, as JAX's are: nothing here changes a key in place, and
the same key gives the same numbers on the CPU and on the card.

A batch of keys ``[*B, 2]`` draws as ``jax.vmap`` over keys does: each
key hashes its own counters over ``shape`` and the result is
``[*B, *shape]`` (``split`` adds the trailing 2).  So the superstep's
``vmap(lambda r: split(r, chunk))(rngs)`` is ``split(rngs, chunk)``.

Every draw goes through one hash, ``ops.threefry.threefry``: the
hand-written kernel on CUDA keys, its plain int64 version on CPU keys.
Its counters are JAX's ``iota_2x32_shape`` (an element's row-major index
as (high, low) words); ``fold_in`` hashes the counter (0, data), which is
``threefry_2x32(key, threefry_seed(data))``'s layout.
Bits, keys and uniforms are integer arithmetic and equal JAX's exactly.
``normal`` runs XLA's own float32 erfinv polynomial (not
``torch.erfinv``, which lands up to 63 ulp from ``lax.erf_inv``) and
``gumbel`` two ``torch.log``s; both sit within a few ulp of JAX's.

``uniform`` and ``normal`` also draw bfloat16, by JAX's rule for a type
of fewer than 8 mantissa bits: only the low byte of ``bits1 ^ bits2``,
shifted right by one under 1.0's exponent, so a bf16 draw is one of 128
values.  ``_bf16_values`` computes those 128 once, on the CPU, op by op
as XLA rounds them (every bf16 operation rounded; the normal's erfinv in
float32), and a draw gathers from them by its 7 bits: equal to JAX's bit
for bit, and the same on the card as on the CPU.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from . import resolve_device
from .ops.threefry import MASK, threefry

_F32_TINY = float(np.finfo(np.float32).tiny)
_SQRT2_F32 = float(np.float32(np.sqrt(2)))
# XLA's float32 erf_inv (the chlo legalization's Giles polynomial): the
# coefficients for w < 5, then for w >= 5.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def _shape(shape) -> tuple[int, ...]:
    return (int(shape),) if isinstance(shape, int) else tuple(int(d) for d in shape)


def _check_key(key: torch.Tensor) -> None:
    if not isinstance(key, torch.Tensor) or key.dtype != torch.int64 or key.ndim < 1 \
            or key.shape[-1] != 2:
        raise TypeError(f"a PRNG key is an int64 tensor [..., 2], got {key!r}")


def PRNGKey(seed: int, device=None) -> torch.Tensor:  # noqa: N802 — JAX's name
    """``jax.random.PRNGKey(seed)``: the words (seed >> 32, seed & 0xFFFFFFFF)
    of an integer seed, as ``threefry_seed`` makes them with 32-bit
    integers (a seed in [-2^31, 2^31) gives (0, seed mod 2^32)).  On
    ``device`` (None means ``cuda``, ``resolve_device``)."""
    seed = int(seed)
    if not -(2**31) <= seed < 2**31:
        raise OverflowError(f"seed {seed} does not fit an int32, as jax.random.PRNGKey's "
                            f"32-bit seeds must")
    return torch.tensor([0, seed & MASK], dtype=torch.int64, device=resolve_device(device))


def _hash(key: torch.Tensor, shape, mode: str, base: int = 0, **kw) -> torch.Tensor:
    """``threefry`` over the counters of ``shape`` under each key of a
    batch ``[*B, 2]``; returns ``[*B, *shape(, 2)]``."""
    _check_key(key)
    shape = _shape(shape)
    batch = key.shape[:-1]
    out = threefry(key.reshape(-1, 2).contiguous(), math.prod(shape), mode=mode, base=base,
                   **kw)
    tail = (2,) if mode == "pair" else ()
    return out.reshape((*batch, *shape, *tail))


def split(key: torch.Tensor, num=2) -> torch.Tensor:
    """``jax.random.split(key, num)`` (``_threefry_split_foldlike``):
    key ``i`` is the hash of counter ``i``.  ``num`` is an int or a shape;
    returns ``[*B, *shape, 2]``."""
    return _hash(key, num, "pair")


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: the hash of the counter
    (0, data mod 2^32).  Returns ``[*B, 2]``."""
    return _hash(key, (), "pair", base=int(data) & MASK)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """32 random bits an element (JAX's partitionable ``bits1 ^ bits2``),
    int64 in [0, 2^32), ``[*B, *shape]``."""
    return _hash(key, shape, "bits")


def _check_dtype(dtype) -> None:
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"draws float32 or bfloat16, got {dtype}")


@functools.lru_cache(maxsize=None)
def _bf16_values(minval: float, maxval: float, normal: bool) -> torch.Tensor:
    """The 128 bf16 values a draw can take, by its 7 random bits, on the
    CPU: ``_uniform``'s ``(bits | 1.0) - 1``, times ``maxval - minval``,
    plus ``minval``, floored at ``minval``, each operation rounded to
    bf16; for ``normal`` then ``bf16(sqrt 2) * bf16(erf_inv)`` with the
    erfinv in float32 (XLA computes a bf16 erf_inv in float32)."""
    bf16 = torch.bfloat16
    mant = torch.arange(128, dtype=torch.int16) | 0x3F80
    floats = mant.view(bf16) - torch.tensor(1.0, dtype=bf16)
    lo, hi = torch.tensor(minval, dtype=bf16), torch.tensor(maxval, dtype=bf16)
    values = torch.maximum(floats * (hi - lo) + lo, lo)
    if normal:
        values = torch.tensor(math.sqrt(2), dtype=bf16) * erfinv_f32(values.float()).to(bf16)
    return values


def _bf16_draw(key: torch.Tensor, shape, minval: float, maxval: float, normal: bool
               ) -> torch.Tensor:
    """A bf16 draw: ``random_bits``' low byte (JAX's 8-bit draw, the
    truncation of ``bits1 ^ bits2``) shifted right by one picks one of
    ``_bf16_values``."""
    bits = random_bits(key, shape)
    values = _bf16_values(float(minval), float(maxval), normal).to(bits.device)
    return values[(bits & 0xFF) >> 1]


def uniform(key: torch.Tensor, shape=(), minval: float = 0.0, maxval: float = 1.0,
            dtype=torch.float32) -> torch.Tensor:
    """``jax.random.uniform`` over ``[minval, maxval)`` in ``dtype``
    (float32 or bfloat16): mantissa bits under 1.0's exponent, minus 1,
    scaled, floored at ``minval``."""
    _check_dtype(dtype)
    if dtype == torch.bfloat16:
        return _bf16_draw(key, shape, minval, maxval, normal=False)
    return _hash(key, shape, "uniform", minval=minval, maxval=maxval)


def _mul32(a: torch.Tensor, b) -> torch.Tensor:
    """(a * b) mod 2^32 for 32-bit words, exact in int64."""
    b = torch.as_tensor(b, dtype=torch.int64, device=a.device)
    low = (a & 0xFFFF) * b
    high = ((a >> 16) * (b & 0xFFFF)) & 0xFFFF
    return (low + (high << 16)) & MASK


def randint(key: torch.Tensor, shape, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint`` into int32 (JAX's default integer type with
    x64 off), op for op: two 32-bit draws from ``split(key)``, reduced
    modulo the span as ``(hi % span) * (2^32 % span) + lo % span``."""
    i32 = (-(2**31), 2**31 - 1)
    maxval_out_of_range = maxval > i32[1]
    lo = min(max(int(minval), i32[0]), i32[1])
    hi = min(max(int(maxval), i32[0]), i32[1])
    k1, k2 = split(key).unbind(-2)
    higher, lower = random_bits(k1, shape), random_bits(k2, shape)
    span = (hi - lo) & MASK
    if hi <= lo:
        span = 1
    elif maxval_out_of_range:
        span = (span + 1) & MASK
    multiplier = (2**16) % span if span else 2**16
    multiplier = (multiplier * multiplier) & MASK
    multiplier = multiplier % span if span else multiplier

    def rem(x):
        return x % span if span else x

    offset = rem((_mul32(rem(higher), multiplier) + rem(lower)) & MASK)
    out = lo + offset
    return (((out + 2**31) & MASK) - 2**31).to(torch.int32)


def erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv``: ``w = -log1p(-x*x)``, Giles' two
    polynomials split at ``w < 5``, times ``x``; ±1 map to ±inf.  Within
    2 ulp of ``lax.erf_inv`` on the CPU (its ``log1p`` rounds otherwise)."""
    w = -torch.log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)

    def coeff(i):
        return torch.where(lt, _ERFINV_LT5[i], _ERFINV_GE5[i])

    # Each Horner step as one rounding (XLA contracts it into an FMA):
    # the float32 product is exact in float64.
    p, w64 = coeff(0), w.double()
    for i in range(1, len(_ERFINV_LT5)):
        p = (coeff(i).double() + p.double() * w64).float()
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def normal(key: torch.Tensor, shape=(), dtype=torch.float32) -> torch.Tensor:
    """``jax.random.normal`` in ``dtype`` (float32 or bfloat16,
    ``_normal_real``): sqrt(2) times the erfinv of a uniform over
    (nextafter(-1, 0), 1) in that type."""
    _check_dtype(dtype)
    if dtype == torch.bfloat16:
        lo = float(torch.nextafter(torch.tensor(-1.0, dtype=torch.bfloat16),
                                   torch.tensor(0.0, dtype=torch.bfloat16)))
        return _bf16_draw(key, shape, lo, 1.0, normal=True)
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    return _SQRT2_F32 * erfinv_f32(uniform(key, shape, lo, 1.0))


def gumbel(key: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.gumbel`` in float32, mode "low":
    ``-log(-log(uniform(tiny, 1)))``."""
    return -torch.log(-torch.log(uniform(key, shape, _F32_TINY, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=-1)``: the Gumbel-max
    draw over the last axis of float32 logits, int64 indices.  One key
    [2] draws the noise for the whole tensor; a batch of keys [*B, 2]
    with logits [*B, vocab] draws each row under its own key, as
    ``jax.vmap`` over the keys does."""
    _check_key(key)
    noise = gumbel(key, logits.shape[key.ndim - 1:])
    return torch.argmax(noise + logits, dim=-1)
