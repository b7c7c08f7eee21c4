"""MFU experiment sweep on the card: where does the non-MFU fraction go?

Port of ``workloads/mfu_sweep.py``.  Times the full training step
(``perfbench.time_train_step``: forward, backward, AdamW; on
``make_mesh()`` when a ``torch.distributed`` world is up, else on one
device)
across model shape, batch, sequence length and remat variants, and
reports per point MFU (useful model FLOPs / time / peak) and HFU
(hardware FLOPs including the flash backward's recompute and layer-remat
recompute / time / peak); the difference is the price of memory-saving
recompute, which MFU by convention does not credit.  Peaks come from
``perfbench.device_peak_flops`` (an H100 table); a card not in it
reports None for both.

    python -m workloads_torch.mfu_sweep [--points base,b16,...] [--device cpu]

prints one JSON line per point.  A point that fails (out of device
memory, say) prints its error and the sweep goes on: the failed point's
state is dropped and the allocator's cache emptied first, so the next
point starts from an empty card.

As the JAX CLI, it declares its claim leases
(``lease.hold_claim_leases``; a no-op without their env) before
sweeping.
"""

from __future__ import annotations

import gc
import json
from dataclasses import dataclass

import torch

from . import resolve_device
from .model import ModelConfig
from .perfbench import (
    device_peak_flops,
    fwd_attn_flops,
    layer_matmul_params,
    time_train_step,
    train_step_flops,
)


@dataclass(frozen=True)
class SweepPoint:
    name: str
    d_model: int = 2048
    n_heads: int = 16
    n_layers: int = 8
    d_ff: int = 8192
    vocab: int = 32768
    seq: int = 2048
    batch: int = 8
    remat: bool = False

    def config(self) -> ModelConfig:
        return ModelConfig(
            vocab_size=self.vocab, d_model=self.d_model, n_heads=self.n_heads,
            n_layers=self.n_layers, d_ff=self.d_ff, max_seq_len=self.seq,
            attention_impl="flash", remat_layers=self.remat,
        )


# The sweep: batch scaling, longer sequences, deeper/wider shapes, and
# remat trades (JAX's ten points).
POINTS = {
    "base": SweepPoint("base"),
    "b16": SweepPoint("b16", batch=16),
    "b32": SweepPoint("b32", batch=32),
    "seq4k_b4": SweepPoint("seq4k_b4", seq=4096, batch=4),
    "seq4k_b8": SweepPoint("seq4k_b8", seq=4096, batch=8),
    "deep_l16": SweepPoint("deep_l16", n_layers=16),
    "wide_d2560": SweepPoint(
        "wide_d2560", d_model=2560, n_heads=20, d_ff=10240
    ),
    "remat_b16": SweepPoint("remat_b16", batch=16, remat=True),
    "remat_b32": SweepPoint("remat_b32", batch=32, remat=True),
    "remat_seq4k_b8": SweepPoint("remat_seq4k_b8", seq=4096, batch=8, remat=True),
}


def hardware_flops(config: ModelConfig, batch: int) -> float:
    """train_step_flops plus the recompute the hardware actually executes:
    the flash backward recomputes attention probabilities (one extra
    forward-attention pass), and remat_layers recomputes each layer's
    whole forward once more in the backward.  Both terms reuse
    perfbench's accounting primitives — one source of truth."""
    extra = fwd_attn_flops(config, batch)  # flash bwd probability recompute
    if config.remat_layers:
        # One full extra forward of the layer stack (not the unembed).
        tokens = batch * (config.max_seq_len - 1)
        extra += 2 * tokens * layer_matmul_params(config) + fwd_attn_flops(
            config, batch
        )
    return train_step_flops(config, batch) + extra


def measure_point(point: SweepPoint, device=None) -> dict:
    device = resolve_device(device)
    config = point.config()
    secs = time_train_step(config, point.batch, device)
    peak = device_peak_flops() if device.type == "cuda" else None
    model_flops = train_step_flops(config, point.batch)
    hw_flops = hardware_flops(config, point.batch)
    step_tokens = point.batch * (config.max_seq_len - 1)
    return {
        "point": point.name,
        "batch": point.batch,
        "seq": config.max_seq_len,
        "layers": config.n_layers,
        "d_model": config.d_model,
        "remat": point.remat,
        "step_ms": round(secs * 1000, 3),
        "tokens_per_sec": round(step_tokens / secs, 1),
        "mfu": round(model_flops / secs / peak, 4) if peak else None,
        "hfu": round(hw_flops / secs / peak, 4) if peak else None,
    }


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description="MFU experiment sweep")
    parser.add_argument(
        "--points", default=",".join(POINTS),
        help="comma-separated subset of: " + ", ".join(POINTS),
    )
    parser.add_argument(
        "--device", default=None,
        help="torch device (default: cuda; 'cpu' runs the plain PyTorch path)",
    )
    args = parser.parse_args(argv)

    from . import lease

    lease.hold_claim_leases()  # mixed-strategy lifetime declaration

    names = [n for n in args.points.split(",") if n]
    unknown = [n for n in names if n not in POINTS]
    if unknown:
        parser.error(f"unknown points: {unknown}")
    # Resolved once, before the loop: no card is an error, not a point's.
    device = resolve_device(args.device)
    for name in names:
        try:
            result = measure_point(POINTS[name], device)
        except Exception as e:  # OOM etc: record, keep sweeping
            result = {"point": name, "error": f"{type(e).__name__}: {e}"[:300]}
        # The failed point's tensors die with its traceback (cleared at
        # the end of the except clause); collect them and hand their
        # blocks back so the next point starts from an empty card.
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
