"""Per-sequence-bucket attention kernel selection.  Port of
``workloads/ops/kernel_select.py``.

The flash/dense routing of ``model._attention`` consults a small
per-(sequence-bucket) dispatch table of measured winners, with three
layers of precedence:

  1. an injected override (``set_kernel_table``, e.g. from
     ``table_from_measurements`` over a fresh flash-vs-dense sweep);
  2. per-device-kind measured defaults (``_MEASURED_PICKS``, keyed by a
     substring of ``torch.cuda.get_device_name``).  It starts empty: no
     H100 sweep has been measured yet, and no TPU row carries over;
  3. the single-crossover fallback: the caller passes
     ``model.flash_min_seq()``'s value.

A lookup takes the smallest table bucket >= seq (buckets are ceilings);
sequences beyond the largest bucket pick "flash".  The table is routing,
not data: both cores compute the same function.
"""

from __future__ import annotations

import torch

IMPLS = ("flash", "xla")

# Measured per-device-kind winners: (device-name marker, ((bucket, impl), ...)).
_MEASURED_PICKS: tuple[tuple[str, tuple[tuple[int, str], ...]], ...] = ()

_override: tuple[tuple[int, str], ...] | None = None


def _validate(picks) -> tuple[tuple[int, str], ...]:
    table = []
    for bucket, impl in sorted(dict(picks).items()):
        if int(bucket) < 1:
            raise ValueError(f"bucket ceilings must be >= 1, got {bucket}")
        if impl not in IMPLS:
            raise ValueError(
                f"kernel impl must be one of {IMPLS}, got {impl!r}"
            )
        table.append((int(bucket), impl))
    return tuple(table)


def set_kernel_table(picks: dict[int, str] | None) -> None:
    """Install a measured {bucket_ceiling: "flash"|"xla"} override (or
    None to fall back to the per-device-kind defaults)."""
    global _override
    _override = None if picks is None else _validate(picks)


def device_kind() -> str | None:
    """The CUDA device's name, lower-cased; None without a CUDA device."""
    if not torch.cuda.is_available():
        return None
    return torch.cuda.get_device_name(0).lower()


def kernel_table() -> tuple[tuple[int, str], ...] | None:
    """The effective dispatch table: the injected override, else this
    device kind's measured defaults, else None (threshold fallback)."""
    if _override is not None:
        return _override
    kind = device_kind()
    if kind is None:
        return None
    for marker, picks in _MEASURED_PICKS:
        if marker in kind:
            return picks
    return None


def kernel_for_seq(seq: int, default_min_seq: int) -> str:
    """The measured winner for a sequence length: the smallest table
    bucket >= seq decides; past the largest bucket flash decides.
    Without any table the single-crossover rule applies against
    ``default_min_seq``."""
    table = kernel_table()
    if table is None:
        return "flash" if seq >= default_min_seq else "xla"
    for bucket, impl in table:
        if seq <= bucket:
            return impl
    return "flash"


def table_from_measurements(speedups: dict[int, float]) -> dict[int, str]:
    """{seq: flash_over_dense_speedup} -> a dispatch table: each measured
    length becomes a bucket picking the side that won there (ties to
    flash)."""
    return {
        int(seq): ("flash" if ratio >= 1.0 else "xla")
        for seq, ratio in speedups.items()
    }
