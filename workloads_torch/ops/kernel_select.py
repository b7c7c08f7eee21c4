"""Per-sequence-bucket attention kernel selection.  Port of
``workloads/ops/kernel_select.py``.

The flash/dense routing of ``model._attention`` consults a small
per-(sequence-bucket) dispatch table of measured winners, with three
layers of precedence:

  1. an injected override (``set_kernel_table``, e.g. from
     ``table_from_measurements`` over a fresh flash-vs-dense sweep
     (``perfbench.measure_flash_vs_xla``), or the committed artifact's
     ``kernel_pick_seq*`` fields through ``table_from_artifact``);
  2. per-device-kind measured defaults (``_MEASURED_PICKS``, keyed by a
     substring of the lower-cased ``torch.cuda.get_device_name``): the
     H100 SXM's row, from the committed artifact; no TPU row carries
     over, and a card not measured skips this layer rather than guess;
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
# NVIDIA H100 80GB HBM3 (SXM) at a 700 W power limit: the kernel_pick_seq*
# fields of docs/bench-torch-latest.json (perfbench.measure_flash_vs_xla,
# fwd+bwd at batch 1, 8 heads, head_dim 128, bf16; flash K2-K4 against
# the dense masked core, both as CUDA-graph chains), which flash wins at
# every swept length.  Re-measure with
# `python -m workloads_torch.perfbench --scale full` and read the table
# back with table_from_artifact.
_MEASURED_PICKS: tuple[tuple[str, tuple[tuple[int, str], ...]], ...] = (
    ("h100 80gb hbm3", ((1024, "flash"), (2048, "flash"), (4096, "flash"))),
)

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


def table_from_artifact(artifact: dict) -> dict[int, str] | None:
    """Rebuild the dispatch table from a committed bench artifact's
    ``kernel_pick_seq{N}`` fields (None when the artifact predates
    them) — the 'measured once' injection path for serving hosts."""
    picks = {}
    for key, val in artifact.items():
        if key.startswith("kernel_pick_seq") and val in IMPLS:
            try:
                picks[int(key[len("kernel_pick_seq"):])] = val
            except ValueError:
                continue
    return picks or None
