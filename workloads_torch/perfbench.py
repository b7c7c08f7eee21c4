"""The perf bench on the card: training, kernels, one engine, the fleet.

The PyTorch port of ``workloads/perfbench.py``, every arm, at
``BenchScale.named("full")`` (d_model 2048, 16 heads, 8 layers, d_ff
8192, vocab 32768, bf16): the training step and its MFU
(``device_peak_flops``, an H100 table), flash attention (K2-K4) against
the dense core it replaces and its window skip, contiguous and paged
decode, the continuous-batching engine timed end to end (serving,
latency, prefill budget, supersteps, overheads, fault recovery,
admission, the prefix cache and the KV hierarchy, speculation,
multi-LoRA, fast start), and the fleet over it (throughput, the
router's tax, failover, disaggregation, self-healing, autoscaling, KV
page scheduling, durable sessions, goodput control), each engine decode
step a replay of its CUDA graph through the paged-attention kernel (K1).
All of a fleet's replicas share the one card and step one after
another.

    python -m workloads_torch.perfbench --scale full [--pool-with PREV.json]

prints one JSON object: the arms' keys, the card's ``device_name`` and
``power_limit_w`` (``nvidia-smi``), and the scale.  The committed
artifact ``docs/bench-torch-latest.json`` (``profiler.
load_committed_artifact``) is two such processes, the second run with
``--pool-with`` the first's output, so that each published ``_min`` /
``_max`` spans two processes.

Methodology, JAX's: a throughput arm times a whole drain after a warm
request (graph capture and first launches off the clock); two arms that
are compared run alternately (``_interleaved_repeats``) and publish the
median per-pair ratio with its spread; every arm that compares two
configurations asserts their token streams equal before publishing a
number.  ``measure_serve`` takes the two-point slope over chunk counts
(``measure_slope_secs``), so admission and capture constants cancel.

Where JAX chains n iterations in one jitted dispatch, the port replays a
CUDA graph n times and reads back once: the flash-vs-dense chains
(``_attention_chain``) and the paged decode chunks (``_time_paged_chunks``,
the engine's ``DecodeGraph``).  The contiguous ``generate`` and the
speculation phase probes stay eager, as the port's functions are, so on
the card they time the host's launches too.

float32 streams are held whole everywhere.  In bf16, arms that replay a
request (failover, self-healing, preemption, a restore) hold each stream
to the tokens kept before the replay and its length (``_hold_replay``),
and arms whose two runs take their greedy decisions from different
programs (a KV handoff's re-prefill, a speculative verify) let a stream
part only at a near-tie (``_hold_near_ties``): ROADMAP Queue C's known
floors.

Seeds: weights from ``prng.PRNGKey(0)`` and samplers from
``rng=PRNGKey(3)``, as the JAX package's (``prng`` is JAX's threefry);
prompts from ``randint(PRNGKey(n))``, or ``randint(fold_in(PRNGKey(a),
b))`` for the seed ``(a, b)``, the training batch from
``train.synthetic_batch``'s ``PRNGKey(0)`` and attention inputs from
``split(PRNGKey(seq), 3)``, all JAX's draws; traffic from the port's
``TrafficGen`` at JAX's seeds.
Entry points run on the card unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

from . import prng, resolve_device
from .model import ModelConfig, cast_params, init_params
from .ops import kernel_select

# Dense bf16 tensor-core peaks, FLOP/s, by a marker in the lower-cased
# device name: NVIDIA's H100 data sheet, half its with-sparsity figures.
# PCIe and NVL come before the bare "h100" of the SXM part ("NVIDIA H100
# 80GB HBM3") so that they match first.  MFU is reported against these;
# an unknown card, or the CPU, yields mfu=None rather than a number
# against a guessed peak.
_PEAK_BF16_FLOPS = (
    ("h100 pcie", 756.5e12),
    ("h100 nvl", 835.5e12),
    ("h100", 989e12),
)


def device_peak_flops() -> float | None:
    """The dense bf16 peak of this process's CUDA card, or None (no
    card, or a card not in the table)."""
    kind = kernel_select.device_kind()
    if kind is None:
        return None
    for marker, peak in _PEAK_BF16_FLOPS:
        if marker in kind:
            return peak
    return None


def measure_slope_samples(
    run_chain,
    n_lo: int,
    n_hi: int,
    repeats: int = 3,
    min_window_secs: float = 0.25,
    max_n: int = 4096,
) -> tuple[float, list[float]]:
    """measure_slope_secs, additionally returning the per-repeat slope
    SAMPLES (floored at 1e-9 like the median) — callers pair two arms'
    samples index-for-index into per-repeat ratios, which persist in the
    bench artifact so the next run can pool a cross-process spread."""
    import statistics

    while True:
        run_chain(n_lo)  # warm: first launches, graph capture
        run_chain(n_hi)
        slopes, windows = [], []
        for _ in range(repeats):
            t0 = time.perf_counter()
            run_chain(n_lo)
            t_lo = time.perf_counter() - t0
            t0 = time.perf_counter()
            run_chain(n_hi)
            t_hi = time.perf_counter() - t0
            slopes.append((t_hi - t_lo) / (n_hi - n_lo))
            windows.append(t_hi - t_lo)
        if statistics.median(windows) >= min_window_secs or n_hi >= max_n:
            samples = [max(s, 1e-9) for s in slopes]
            return max(statistics.median(slopes), 1e-9), samples
        n_lo, n_hi = n_lo * 2, n_hi * 2


def measure_slope_secs(
    run_chain,
    n_lo: int,
    n_hi: int,
    repeats: int = 3,
    min_window_secs: float = 0.25,
    max_n: int = 4096,
) -> float:
    """Per-iteration seconds of ``run_chain(n)`` (which must execute n
    data-dependent iterations ending in one host readback), via the
    two-point slope: the constant (dispatch, readback, set-up) cancels.

    The estimate is the MEDIAN slope over ``repeats`` interleaved lo/hi
    pairs, and the chain lengths double until the median (t_hi - t_lo)
    window dwarfs the host's jitter.  Each (n_lo, n_hi) pair is warmed
    untimed first so one-time work never lands inside a timed window."""
    return measure_slope_samples(
        run_chain, n_lo, n_hi, repeats, min_window_secs, max_n
    )[0]


@dataclass(frozen=True)
class BenchScale:
    """Shape set for the perf bench; ``full`` is the repo's widest model
    (536.9M parameters, bf16), ``tiny`` exists so the harness itself is
    testable on the CPU.  ``dtype`` is the port's: ``tiny``
    computes in float32, where a speculative and a plain step give the
    same greedy tokens, so that a spec="auto" calibration verdict timed
    on a loaded CPU cannot part the streams its arms compare."""

    d_model: int
    n_heads: int
    n_layers: int
    d_ff: int
    vocab: int
    seq: int
    batch: int
    attn_heads: int
    attn_seqs: tuple[int, ...]
    decode_prompt: int
    decode_lens: tuple[int, int]
    page_size: int
    serve_chunks: tuple[int, int]
    spec_phase_batches: tuple[int, ...]
    spec_engine_ks: tuple[int, ...]
    dtype: torch.dtype = torch.bfloat16

    @classmethod
    def named(cls, name: str) -> "BenchScale":
        if name == "full":
            return cls(
                d_model=2048, n_heads=16, n_layers=8, d_ff=8192, vocab=32768,
                seq=2048, batch=8, attn_heads=8,
                attn_seqs=(1024, 2048, 4096), decode_prompt=32,
                decode_lens=(64, 512), page_size=64, serve_chunks=(1, 8),
                spec_phase_batches=(1, 2, 4, 8),
                spec_engine_ks=(8, 16, 32),
            )
        if name == "tiny":
            return cls(
                d_model=64, n_heads=4, n_layers=2, d_ff=128, vocab=256,
                seq=128, batch=2, attn_heads=2,
                attn_seqs=(128,), decode_prompt=4, decode_lens=(4, 12),
                page_size=4, serve_chunks=(1, 3),
                spec_phase_batches=(1, 2), spec_engine_ks=(2,),
                dtype=torch.float32,
            )
        raise ValueError(f"unknown bench scale {name!r} (full|tiny)")


def derive_breakeven(batches: list[int], ratios: list[float]) -> float:
    """The measured break-even batch from per-batch spec/plain ratios:
    the occupancy at which speculation's tokens/sec crosses the plain
    path's, log2-interpolated between the last winning and first losing
    batch.  All batches winning reports the largest measured batch (a
    ">= max" floor, not a claim beyond the sweep); none winning reports
    0 (never speculate)."""
    import math

    if ratios[0] < 1.0:
        return 0.0
    if all(r >= 1.0 for r in ratios):
        return float(batches[-1])
    j = next(
        i for i in range(len(batches) - 1)
        if ratios[i] >= 1.0 and ratios[i + 1] < 1.0
    )
    x0, x1 = math.log2(batches[j]), math.log2(batches[j + 1])
    t = (ratios[j] - 1.0) / (ratios[j] - ratios[j + 1])
    return round(2 ** (x0 + t * (x1 - x0)), 2)


def _config(scale: BenchScale, max_seq_len: int) -> ModelConfig:
    return ModelConfig(
        vocab_size=scale.vocab, d_model=scale.d_model, n_heads=scale.n_heads,
        n_layers=scale.n_layers, d_ff=scale.d_ff, max_seq_len=max_seq_len,
        dtype=scale.dtype,
    )


def _params(config: ModelConfig, seed: int, device) -> dict:
    """Random weights from ``seed`` in the config's dtype, on ``device``."""
    return cast_params(
        init_params(config, prng.PRNGKey(seed, device=device)),
        config.dtype,
    )


def _prompt(seed: int | tuple[int, int], length: int, vocab: int) -> list[int]:
    """JAX's ``randint(PRNGKey(seed), (length,), 0, vocab)`` as a list;
    a seed ``(a, b)`` draws under ``fold_in(PRNGKey(a), b)``.  Drawn on
    the CPU: the result is host data."""
    if isinstance(seed, int):
        key = prng.PRNGKey(seed, device="cpu")
    else:
        a, b = seed
        key = prng.fold_in(prng.PRNGKey(a, device="cpu"), b)
    return prng.randint(key, (length,), 0, vocab).tolist()


def _sampler(seed: int, device) -> torch.Tensor:
    return prng.PRNGKey(seed, device=device)


def _model_config(scale: BenchScale) -> ModelConfig:
    return ModelConfig(
        vocab_size=scale.vocab,
        d_model=scale.d_model,
        n_heads=scale.n_heads,
        n_layers=scale.n_layers,
        d_ff=scale.d_ff,
        max_seq_len=scale.seq,
        dtype=scale.dtype,
        attention_impl="flash",
    )


def layer_matmul_params(config: ModelConfig) -> int:
    """Weight-matmul parameters touched per token across the layer stack
    (embed is a gather, not a matmul; unembed counted separately).  q and
    output projections are d*d each; k/v shrink by the grouped-query
    ratio when n_kv_heads < n_heads.  Single source for the FLOPs
    accounting here and in workloads_torch/mfu_sweep.py."""
    d, ff = config.d_model, config.d_ff
    kv_proj = 2 * d * (config.kv_heads * config.head_dim)
    return config.n_layers * (2 * d * d + kv_proj + 2 * d * ff)


def fwd_attn_flops(config: ModelConfig, batch: int) -> float:
    """Forward causal-attention FLOPs: q@k^T and p@v, 2*s*s*d MAC-pairs
    each, halved by the causal mask (and the kernel really does skip the
    masked blocks)."""
    s = config.max_seq_len - 1
    return config.n_layers * batch * (4 * s * s * config.d_model) * 0.5


def train_step_flops(config: ModelConfig, batch: int) -> float:
    """Analytic FLOPs of one training step (fwd + bwd counted as 3x the
    forward matmul work — the standard accounting; the flash backward's
    recompute means the hardware actually does slightly more, so the MFU
    reported from this is conservative)."""
    tokens = batch * (config.max_seq_len - 1)
    p_matmul = layer_matmul_params(config) + config.d_model * config.vocab_size
    fwd_dense = 2 * tokens * p_matmul
    return 3 * (fwd_dense + fwd_attn_flops(config, batch))


def time_train_step(config: ModelConfig, batch: int, device=None) -> float:
    """Steady-state per-step seconds of the FULL training step (forward,
    backward, AdamW) at (config, batch): the shared timing core for
    measure_train and mfu_sweep.  n steps chain on the device (each
    updates the parameters the next reads) and end in one readback of
    the loss; the two-point slope cancels the readback.

    As JAX's, it steps through ``make_sharded_train_step`` on
    ``make_mesh()`` when a ``torch.distributed`` world of more than one
    rank is up (each rank its ``param_specs`` cut, the batch split over
    ``"data"``; the mesh's device, ``device`` ignored); otherwise through
    the one-device step."""
    from .distributed import world_mesh
    from .train import make_train_state, make_train_step, synthetic_batch

    mesh, device = world_mesh(device)
    (params, opt_state), optimizer = make_train_state(config, device=device, mesh=mesh)
    step = make_train_step(config, optimizer, mesh=mesh)
    tokens = synthetic_batch(config, batch, device=device)
    state = [params, opt_state]

    def chain(n: int) -> float:
        for _ in range(n):
            state[0], state[1], loss = step(state[0], state[1], tokens)
        return float(loss)  # single readback; params chain on device

    return measure_slope_secs(chain, n_lo=4, n_hi=12)


def measure_train(scale: BenchScale, device=None) -> dict:
    """Steady-state full-train-step time and MFU at the bench scale (on
    the CPU, or a card not in the peak table, mfu is None)."""
    device = resolve_device(device)
    config = _model_config(scale)
    secs = time_train_step(config, scale.batch, device)
    flops = train_step_flops(config, scale.batch)
    peak = device_peak_flops() if device.type == "cuda" else None
    step_tokens = scale.batch * (config.max_seq_len - 1)
    return {
        "train_step_ms": round(secs * 1000, 3),
        "train_tokens_per_sec": round(step_tokens / secs, 1),
        "train_step_flops": flops,
        "mfu": round(flops / secs / peak, 4) if peak else None,
        "device_name": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
    }


def _attention_grad_step(attn_fn, q, k, v) -> None:
    """One link of the attention chain, in place: q <- q + 1e-6 *
    d/dq sum(attn_fn(q, k, v)), the gradient cast to q's dtype first
    (JAX's ``qq + 1e-6 * grad_q(qq, k, v).astype(qq.dtype)``).  The
    gradient feeds back into q, so links can be neither elided nor
    overlapped."""
    leaf = q.detach().requires_grad_(True)
    with torch.enable_grad():
        loss = attn_fn(leaf, k, v).float().sum()
        (grad,) = torch.autograd.grad(loss, leaf)
    with torch.no_grad():
        q.add_(1e-6 * grad.to(q.dtype))


def _attention_chain(attn_fn, q, k, v, graph: bool | None = None):
    """``run(n)``: n links of ``_attention_grad_step`` from ``q``; returns
    the chain's q buffer after them (overwritten by the next run).

    JAX runs the n links in one ``lax.fori_loop`` dispatch, which keeps
    dispatch out of the slope.  Its counterpart here (``graph``, the
    default on CUDA tensors) is a CUDA graph: one link (forward,
    backward, the update of q) captured once after a warm-up on a side
    stream, replayed n times.  A replay launches what the capture
    recorded and calls no Python, so the kernels' wrappers count the
    warm-up's and the capture's launches and none of the replays'.
    ``graph=False`` runs the links eagerly; a graph raises where the
    link cannot be captured."""
    graph = q.is_cuda if graph is None else graph
    buf = q.clone()
    if not graph:
        def run(n: int) -> torch.Tensor:
            buf.copy_(q)
            for _ in range(n):
                _attention_grad_step(attn_fn, buf, k, v)
            return buf

        return run
    if not q.is_cuda:
        raise ValueError(f"a CUDA graph needs CUDA tensors, got {q.device}")
    current = torch.cuda.current_stream(q.device)
    side = torch.cuda.Stream(q.device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        # Kernel builds, autograd's and the allocator's first calls.
        for _ in range(3):
            _attention_grad_step(attn_fn, buf, k, v)
    current.wait_stream(side)
    torch.cuda.synchronize(q.device)
    link = torch.cuda.CUDAGraph()
    with torch.cuda.graph(link):
        _attention_grad_step(attn_fn, buf, k, v)

    def run(n: int) -> torch.Tensor:
        buf.copy_(q)
        for _ in range(n):
            link.replay()
        return buf

    return run


def _time_attention_grad(attn_fn, q, k, v) -> tuple[float, list[float]]:
    """Per-call seconds of value+grad through ``attn_fn(q, k, v)`` —
    (median, per-repeat samples) — over ``_attention_chain``'s links,
    ending in one readback."""
    run = _attention_chain(attn_fn, q, k, v)
    return measure_slope_samples(
        lambda n: float(run(n)[0, 0, 0, 0]), n_lo=4, n_hi=16
    )


def _dense_causal(q, k, v):
    """The dense masked core flash attention replaces: ``model.
    masked_attention`` under a causal mask (plain torch products and a
    float32 softmax; JAX's dense side is XLA outside any Pallas kernel)."""
    from .model import masked_attention

    seq = q.shape[1]
    mask = torch.ones((seq, seq), dtype=torch.bool, device=q.device).tril()
    return masked_attention(q, k, v, mask[None, None], q.shape[3])


def measure_flash_vs_xla(scale: BenchScale, device=None) -> dict:
    """flash_attention (K2 forward, K3 + K4 backward on the card) vs the
    dense masked core it replaces, fwd+bwd, per sequence length.
    Identical chain/slope timing on both sides; per-repeat ratio samples
    ride along so the headline speedup carries a poolable spread.  The
    "xla" side keeps JAX's name: the dense route of the kernel table."""
    from .ops.attention import flash_attention

    device = resolve_device(device)
    head_dim = 128
    results = {}
    for seq in scale.attn_seqs:
        q, k, v = _rand_qkv(seq, scale.attn_heads, head_dim, device=device)
        t_flash, flash_s = _time_attention_grad(flash_attention, q, k, v)
        t_dense, dense_s = _time_attention_grad(_dense_causal, q, k, v)
        results[seq] = {
            "flash_ms": round(t_flash * 1000, 3),
            "xla_ms": round(t_dense * 1000, 3),
            "speedup": round(t_dense / t_flash, 3),
            "speedup_samples": [
                round(d / f, 3) for d, f in zip(dense_s, flash_s)
            ],
        }
    return results


def _rand_qkv(seq: int, heads: int, head_dim: int = 128,
              dtype=torch.bfloat16, device=None):
    """Standard-normal (q, k, v), each [1, seq, heads, head_dim] in
    ``dtype``, as JAX's: ``normal(kk, ..., dtype)`` for each ``kk`` of
    ``split(PRNGKey(seq), 3)``, drawn on ``device``."""
    keys = prng.split(prng.PRNGKey(seq, device=device), 3)
    return tuple(prng.normal(kk, (1, seq, heads, head_dim), dtype=dtype) for kk in keys)


def measure_window(scale: BenchScale, device=None) -> dict:
    """Sliding-window block-skip win: flash fwd+bwd at TWICE the longest
    attn_seqs length (the long-context regime windows exist for), full
    span vs a window of 1/8th the sequence."""
    from .ops.attention import flash_attention

    device = resolve_device(device)
    seq = max(scale.attn_seqs) * 2
    window = max(seq // 8, 128)
    q, k, v = _rand_qkv(seq, scale.attn_heads, device=device)

    def timed(w):
        return _time_attention_grad(
            lambda q, k, v: flash_attention(q, k, v, True, window=w), q, k, v
        )

    t_full, full_s = timed(None)
    t_win, win_s = timed(window)
    return {
        "window_seq": seq,
        "window_size": window,
        "flash_full_ms": round(t_full * 1000, 3),
        "flash_window_ms": round(t_win * 1000, 3),
        "flash_window_speedup": round(t_full / t_win, 3),
        "flash_window_speedup_samples": [
            round(f / w, 3) for f, w in zip(full_s, win_s)
        ],
    }


def _prompts(seed: int, batch: int, length: int, vocab: int, device) -> torch.Tensor:
    """[batch, length] tokens, JAX's ``randint(PRNGKey(seed), (batch,
    length), 0, vocab)`` drawn on ``device``, in int64 as the decode
    programs take them."""
    return prng.randint(prng.PRNGKey(seed, device=device), (batch, length), 0, vocab).long()


def measure_decode(scale: BenchScale, device=None) -> dict:
    """KV-cached greedy decode throughput of the contiguous ``generate``:
    tokens/s from the slope between two generation lengths (prefill and
    constant costs cancel).  Measured twice — compute-dtype weights and
    the int8 weight-only serving representation (quant.py).  JAX's
    ``generate`` is one jitted scan; the port's is an eager loop, so on
    the card this times each step's launches from the host too."""
    from .generate import generate
    from .quant import quantize_params

    device = resolve_device(device)
    config = _model_config(scale)
    # The cached decode path uses the dense core; attention_impl only
    # affects the parallel forward.  Serving weights are the compute dtype,
    # not the float32 training masters.
    params = _params(config, 0, device)
    lo, hi = scale.decode_lens

    def time_decode(p, batch: int) -> tuple[float, list[float]]:
        prompt = _prompts(1, batch, scale.decode_prompt, config.vocab_size, device)

        def run(n_new: int) -> float:
            out = generate(p, prompt, config, n_new, device=device)
            return float(out[0, -1])

        # max_n pins the chain lengths: growing them could push
        # prompt+n_new past max_seq_len.
        return measure_slope_samples(
            run, n_lo=lo, n_hi=hi, min_window_secs=0.0, max_n=hi
        )

    per_token, per_token_s = time_decode(params, scale.batch)
    # The int8 A/B runs at batch 1, where every decode step is a pure
    # weight stream: the regime weight-only quantization exists for.
    lat_fp, fp_s = time_decode(params, 1)
    lat_int8, int8_s = time_decode(quantize_params(params), 1)
    return {
        "decode_ms_per_token": round(per_token * 1000, 4),
        "decode_tokens_per_sec": round(scale.batch / per_token, 1),
        "decode_tokens_per_sec_samples": [
            round(scale.batch / s, 1) for s in per_token_s
        ],
        "decode_b1_ms_per_token": round(lat_fp * 1000, 4),
        "decode_b1_ms_per_token_int8": round(lat_int8 * 1000, 4),
        "decode_int8_speedup": round(lat_fp / lat_int8, 3),
        "decode_int8_speedup_samples": [
            round(f / i, 3) for f, i in zip(fp_s, int8_s)
        ],
    }


def _paged_chunk_runner(
    params, config: ModelConfig, *, batch: int, prompt_len: int,
    page_size: int, chunk: int, n_hi: int, device, graph: bool | None = None,
):
    """``run(n_chunks)``: a greedy batch prefilled into fresh page tables,
    then ``n_chunks`` decode chunks with pages extended per chunk; returns
    the emitted tokens [batch, n_chunks * chunk].  The chunk is the
    engine's own plain decode program: on the card (``graph``, the
    default there) replays of a ``DecodeGraph`` over the pools, as
    ``ServeEngine`` dispatches it; else ``paged_decode_chunk``.  The
    pools are allocated once: each run's prefill and decode write every
    position it reads."""
    from .decode_graph import DecodeGraph
    from .paged import (
        PagePool,
        init_page_pools,
        paged_decode_chunk,
        paged_prefill,
        table_array,
    )
    from .serve import _UNBOUNDED

    graph = device.type == "cuda" if graph is None else graph
    max_pages = -(-(prompt_len + 1 + n_hi * chunk) // page_size)
    n_pages = batch * max_pages
    prompt = _prompts(1, batch, prompt_len, config.vocab_size, device)
    lengths = torch.full((batch,), prompt_len, dtype=torch.int32, device=device)
    occupancy = torch.ones(batch, dtype=torch.bool, device=device)
    pools = init_page_pools(config, n_pages, page_size, device)
    decode = None
    if graph:
        decode = DecodeGraph(
            params, pools, config, slots=batch, max_pages=max_pages,
            max_steps=chunk, temperature=0.0, top_k=0,
            top_p=1.0, sampling=False,
        )
        unbounded = (
            torch.full((batch,), _UNBOUNDED, dtype=torch.int32, device=device),
            torch.full((batch,), -1, dtype=torch.int32, device=device),
        )

    def run(n_chunks: int) -> torch.Tensor:
        ctrl = PagePool(n_pages=n_pages, page_size=page_size)
        for b in range(batch):
            ctrl.allocate(b, prompt_len)
        tables = table_array(
            [ctrl.tables[b] for b in range(batch)], max_pages,
            fill=ctrl.trash, device=device,
        )
        logits, _ = paged_prefill(params, pools, tables, prompt, lengths, config)
        tok = torch.argmax(logits, dim=-1)
        positions = np.full(batch, prompt_len, np.int64)
        out = []
        for _ in range(n_chunks):
            for b in range(batch):
                ctrl.extend(b, int(positions[b]) + chunk)
            tables = table_array(
                [ctrl.tables[b] for b in range(batch)], max_pages,
                fill=ctrl.trash, device=device,
            )
            pos = torch.as_tensor(positions, device=device)
            if decode is None:
                toks, _ = paged_decode_chunk(
                    params, pools, tables, tok, pos, occupancy, None, 0.0, 0,
                    1.0, config, chunk, False,
                )
            else:
                # The graph's output buffer is rewritten by the next run.
                toks = decode.run(
                    tables, tok, pos, occupancy, *unbounded, chunk
                )[0].clone()
            tok = toks[:, -1]
            positions += chunk
            out.append(toks)
        return torch.cat(out, dim=1)

    return run


def _time_paged_chunks(
    params, config: ModelConfig, *, batch: int, prompt_len: int,
    page_size: int, chunk: int, n_lo: int, n_hi: int, device,
) -> tuple[float, list[float]]:
    """Steady-state seconds per decode chunk at ``batch`` — greedy, slope
    over CHUNK counts so prefill and constant dispatch costs cancel.  This
    is the engine's ACTUAL plain decode program (``_paged_chunk_runner``);
    the helper is shared by measure_paged_decode and measure_spec_phases
    so the break-even's plain baseline can never drift from the
    published paged number.  Returns (median secs/chunk, per-repeat
    samples)."""
    run = _paged_chunk_runner(
        params, config, batch=batch, prompt_len=prompt_len,
        page_size=page_size, chunk=chunk, n_hi=n_hi, device=device,
    )
    return measure_slope_samples(
        lambda n: float(run(n)[0, -1]), n_lo=n_lo, n_hi=n_hi,
        min_window_secs=0.0, max_n=n_hi,
    )


def measure_paged_decode(scale: BenchScale, device=None) -> dict:
    """Paged chunked decode (the block-table kernel K1, one dispatch per
    page-size chunk) at the same batch as measure_decode: paged must not
    cost throughput for its allocation-on-demand win.  Greedy, same
    weights/dtype discipline as measure_decode; per-token seconds from
    the slope over CHUNK counts.  On the card each chunk is graph
    replays while measure_decode's ``generate`` is an eager loop: their
    ratio compares the two programs as the port runs them."""
    device = resolve_device(device)
    config = _model_config(scale)
    params = _params(config, 0, device)
    batch, ps = scale.batch, scale.page_size
    chunk = ps
    lo, hi = scale.serve_chunks
    secs_per_chunk, chunk_s = _time_paged_chunks(
        params, config, batch=batch, prompt_len=scale.decode_prompt,
        page_size=ps, chunk=chunk, n_lo=lo, n_hi=hi, device=device,
    )
    per_token = secs_per_chunk / chunk
    return {
        "paged_decode_ms_per_token": round(per_token * 1000, 4),
        "paged_decode_tokens_per_sec": round(batch / per_token, 1),
        "paged_decode_tokens_per_sec_samples": [
            round(batch / (s / chunk), 1) for s in chunk_s
        ],
        "paged_page_size": ps,
    }


def measure_serve(scale: BenchScale, device=None) -> dict:
    """The COMPOSED serving path on the card: the continuous-batching
    engine end-to-end — paged pools, the paged-attention kernel, int8
    weight-only bases, temperature/top-k/top-p sampling, per-chunk host
    readbacks and page accounting included.  Slope over chunk counts, so
    admission/prefill/capture constants cancel and what remains is the
    sustained serve loop."""
    from .quant import quantize_params
    from .serve import ServeEngine

    device = resolve_device(device)
    batch, ps = scale.batch, scale.page_size
    chunk = ps
    lo, hi = scale.serve_chunks
    prompt_len = scale.decode_prompt
    config = _config(scale, prompt_len + 1 + hi * chunk)
    params = quantize_params(_params(config, 0, device))
    prompt = _prompt(1, prompt_len, config.vocab_size)
    peak_fraction = [0.0]

    def run_chunks(n_chunks: int) -> float:
        engine = ServeEngine(
            params, config, slots=batch, page_size=ps, chunk=chunk,
            # Page-aligned bucket covering the prompt.
            prompt_bucket=-(-prompt_len // ps) * ps,
            temperature=0.8, top_k=50, top_p=0.95,
            rng=_sampler(3, device),
            # Pipelined stepping: each chunk's readback overlaps the
            # next chunk's compute.
            pipelined=True, device=device,
        )
        for _ in range(batch):
            engine.submit(prompt, 1 + n_chunks * chunk)
        engine.run()
        peak_fraction[0] = engine.ctrl.peak_used / engine.ctrl.n_pages
        return float(engine.generated_tokens)

    secs_per_chunk = measure_slope_secs(
        run_chunks, n_lo=lo, n_hi=hi, min_window_secs=0.0, max_n=hi
    )
    per_token = secs_per_chunk / chunk
    tokens_per_sec = batch / per_token
    request_tokens = 1 + hi * chunk
    return {
        "serve_tokens_per_sec": round(tokens_per_sec, 1),
        "serve_requests_per_sec": round(tokens_per_sec / request_tokens, 3),
        "serve_request_tokens": request_tokens,
        "serve_pool_peak_fraction": round(peak_fraction[0], 4),
    }


def _interleaved_repeats(arm_a, arm_b, repeats: int = 3):
    """Run two measurement arms ROUND-ROBIN ``repeats`` times and return
    (a_samples, b_samples): back-to-back pairs under the same host
    drift.  Callers pair the samples into per-repeat ratios in whichever
    orientation their metric reads and publish the median with min/max
    spread."""
    a_s, b_s = [], []
    for _ in range(repeats):
        a_s.append(arm_a())
        b_s.append(arm_b())
    return a_s, b_s


def _pctl(samples: list[float], q: float) -> float:
    """Ceil-rank percentile: the smallest value with >= q of the mass at
    or below it."""
    import math

    ordered = sorted(samples)
    rank = min(len(ordered) - 1, math.ceil(q * len(ordered)) - 1)
    return ordered[rank]


def _hold_replay(streams: dict, ref: dict, kept: dict, dtype, label: str) -> int:
    """Hold the streams of a run that replayed (a requeue, a park, a
    restore) against the run without the fault; returns how many equal
    it whole.  float32 holds every stream whole (replay is bit-identical
    under greedy, JAX's check).  bf16 holds each replayed stream's
    tokens kept at its requeue (``kept``: rid -> count) and every
    stream's length: a bf16 replay re-prefills the emitted tokens in one
    block product, whose rows round otherwise than the one-token decode
    steps that first wrote them on the card, so its continuation may
    part at a near-tie (ROADMAP Queue C, known floors)."""
    if dtype == torch.float32 and streams != ref:
        raise RuntimeError(
            f"{label}: replayed streams diverged from the fault-free run — "
            "replay is supposed to be bit-identical"
        )
    if (
        {r: len(t) for r, t in streams.items()} != {r: len(t) for r, t in ref.items()}
        or any(list(streams[r][:k]) != list(ref[r][:k]) for r, k in kept.items())
    ):
        raise RuntimeError(
            f"{label}: a replayed stream lost tokens or changed the tokens "
            "it kept at its requeue"
        )
    return sum(list(streams[r]) == list(ref[r]) for r in ref)


def _top2_gap_and_floor(params, config: ModelConfig, seq) -> tuple[float, float]:
    """Before the token that follows ``seq`` (a dense forward): the
    model's top-two logit gap computed in float32 from the same weights,
    and twice the bf16 floor there, the largest |bf16 logit - float32
    logit|.  Two bf16 programs of the same function, each within the
    floor of the float32 logits, can order the top two otherwise only
    where the gap is under that."""
    from dataclasses import replace

    from .model import forward

    tokens = torch.tensor([list(seq)], device=params["embed"].device)
    with torch.inference_mode():
        l16 = forward(params, tokens, config)[0, -1].float()
        l32 = forward(params, tokens, replace(config, dtype=torch.float32))[0, -1]
    top = torch.topk(l32, 2).values
    return (top[0] - top[1]).item(), 2 * (l16 - l32).abs().max().item()


def _hold_near_ties(params, config: ModelConfig, streams: dict, ref: dict,
                    prompts: dict, label: str) -> tuple[int, list[list[float]]]:
    """Hold two runs whose every stream saw the same greedy decisions
    but whose bf16 logits came from different programs: a block
    prefill or verify against one-token decode steps (a KV handoff
    re-prefills the emitted token on the decode replica; speculation
    verifies a block).  float32 holds every stream whole.  bf16 holds
    every length, and a stream may part only at a near-tie: where the
    float32 top-two gap before its first parting token is within twice
    the bf16 floor (``_top2_gap_and_floor``; ROADMAP Queue C, known
    floors).  Returns (streams equal whole, [gap, limit] a parting)."""
    equal, partings = 0, []
    for rid, want in ref.items():
        got, want = list(streams[rid]), list(want)
        if got == want:
            equal += 1
            continue
        if config.dtype == torch.float32 or len(got) != len(want):
            raise RuntimeError(
                f"{label}: streams diverged — the two runs are supposed "
                "to give every token alike"
            )
        pos = next(j for j, (a, b) in enumerate(zip(got, want)) if a != b)
        gap, limit = _top2_gap_and_floor(
            params, config, list(prompts[rid]) + want[:pos]
        )
        if not gap <= limit:
            raise RuntimeError(
                f"{label}: a bf16 stream parted at token {pos} where the "
                f"top-two gap {gap:.4e} exceeds twice the bf16 floor "
                f"{limit:.4e} — not a near-tie"
            )
        partings.append([gap, limit])
    return equal, partings


def _parting_keys(prefix: str, partings: list[list[float]]) -> dict:
    """The largest top-two gap at a parting and the smallest limit, when
    a stream parted."""
    if not partings:
        return {}
    return {
        f"{prefix}_parting_gap_max": round(max(g for g, _ in partings), 6),
        f"{prefix}_parting_limit_min": round(min(lim for _, lim in partings), 6),
    }


def _kept_at_requeue(fleet) -> dict:
    """rid -> tokens a request had emitted when the fleet first requeued
    it for failover replay (filled as ``fleet`` runs)."""
    kept: dict = {}
    requeue = fleet._requeue_victims

    def recording(victims, **kw):
        for fr in victims:
            kept.setdefault(fr.rid, len(fr.tokens))
        return requeue(victims, **kw)

    fleet._requeue_victims = recording
    return kept


def _timed_arm(fn, scale, device, log=None) -> tuple[dict, float, float | None]:
    """Run one arm; returns (its keys, seconds, peak device memory in
    GiB since the arm began, None off the card), and prints the two to
    ``log`` when given."""
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    got = fn(scale, device)
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else None
    if log is not None:
        mem = f"{peak:.2f} GiB" if cuda else "not measured (no card)"
        print(f"perfbench {fn.__name__}: {secs:.1f} s, peak device memory {mem}",
              file=log, flush=True)
    return got, secs, peak


def _release(device) -> None:
    """Give a closed fleet's pools and captured graphs back to the card
    before the next build (an arm builds dozens of engines)."""
    import gc

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def measure_serve_latency(scale: BenchScale, device=None) -> dict:
    """TTFT and end-to-end latency distribution through the SAME composed
    engine configuration measure_serve times for throughput — int8 base,
    sampling knobs, pipelined stepping — under a backpressured mixed
    stream (3x slots requests, all submitted up front): later waves
    queue behind earlier ones, so admission wait lands IN the TTFT tail
    exactly as a client would see it.  Host-side stamps come from the
    engine's own Request telemetry (submit / first observed token /
    retirement)."""
    from .quant import quantize_params
    from .serve import ServeEngine

    device = resolve_device(device)
    batch, ps = scale.batch, scale.page_size
    chunk = ps
    lo, hi = scale.serve_chunks
    prompt_len = scale.decode_prompt
    config = _config(scale, prompt_len + 1 + hi * chunk)
    params = quantize_params(_params(config, 0, device))
    prompt = _prompt(1, prompt_len, config.vocab_size)
    engine = ServeEngine(
        params, config, slots=batch, page_size=ps, chunk=chunk,
        prompt_bucket=-(-prompt_len // ps) * ps,
        temperature=0.8, top_k=50, top_p=0.95, rng=_sampler(3, device),
        pipelined=True, device=device,
    )
    engine.submit(prompt, 1 + hi * chunk)  # warm: capture, first launches
    engine.run()
    engine.drain_completed()
    n_req = 3 * batch
    for i in range(n_req):
        # Mixed generation lengths: the stream continuous batching is for.
        engine.submit(prompt, 1 + chunk * (1 + i % hi))
    engine.run()
    done = engine.drain_completed()
    ttfts = [r.ttft_secs * 1000 for r in done]
    e2es = [r.e2e_secs * 1000 for r in done]
    # Queue-wait percentiles (submission -> admission): the slice of the
    # TTFT tail that is BACKPRESSURE, not prefill.
    qwaits = [
        r.queue_wait_secs * 1000
        for r in done if r.queue_wait_secs is not None
    ]
    if len(ttfts) != n_req:
        raise RuntimeError(
            f"serve latency bench drained {len(ttfts)} finished requests, "
            f"expected {n_req} — the engine lost or duplicated requests"
        )
    return {
        "serve_latency_requests": n_req,
        "serve_ttft_p50_ms": round(_pctl(ttfts, 0.50), 2),
        "serve_ttft_p99_ms": round(_pctl(ttfts, 0.99), 2),
        "serve_e2e_p50_ms": round(_pctl(e2es, 0.50), 2),
        "serve_e2e_p99_ms": round(_pctl(e2es, 0.99), 2),
        "serve_queue_wait_p50_ms": round(_pctl(qwaits, 0.50), 2),
        "serve_queue_wait_p99_ms": round(_pctl(qwaits, 0.99), 2),
    }


def measure_interleave(scale: BenchScale, device=None) -> dict:
    """Chunked-prefill / decode interleaving economics: a mixed OPEN-LOOP
    stream — long prompts whose multi-chunk prefill sweeps
    head-of-line-block every occupied decode slot, with short prompts
    queued between them — served by the same engine shape twice:
    ``prefill_budget=None`` vs a one-bucket budget.  Interleaved
    repeats; published:

      - ``interleave_ttft_p99_ratio``: budgeted/unbudgeted SHORT-prompt
        TTFT p99 (median per-pair ratio with min/max; < 1.0 = the
        budget removed the long-prefill stalls from the tail),
      - ``interleave_decode_dip_pct``: the budgeted engine's decode
        token rate during prefill-burdened steps vs pure-decode steps,
      - ``interleave_budget_sweep``: {budget tokens/step: short TTFT
        p99 ms} across budgets (single-shot per budget).

    Greedy streams are asserted identical budgeted vs not — a latency
    win that changed tokens would be a lie."""
    import statistics

    from .serve import ServeEngine

    device = resolve_device(device)
    batch, ps = scale.batch, scale.page_size
    chunk = ps
    bucket = 2 * ps
    long_len, short_len = 6 * bucket, ps
    config = _config(scale, long_len + 1 + 2 * chunk)
    params = _params(config, 0, device)
    long_prompt = _prompt(1, long_len, config.vocab_size)
    short_prompt = _prompt(2, short_len, config.vocab_size)
    n_req = 4 * batch

    def serve(budget):
        engine = ServeEngine(
            params, config, slots=batch, page_size=ps, chunk=chunk,
            prompt_bucket=bucket, pipelined=True, prefill_budget=budget,
            device=device,
        )
        engine.submit(long_prompt, 1 + chunk)  # warm every shape
        engine.submit(short_prompt, 1 + 2 * chunk)
        engine.run()
        engine.drain_completed()
        shorts = []
        for i in range(n_req):
            # Every 4th request is a long prompt landing mid-stream —
            # the head-of-line blocker the budget exists to defuse.
            if i % 4 == 1:
                engine.submit(long_prompt, 1 + chunk)
            else:
                shorts.append(engine.submit(short_prompt, 1 + 2 * chunk))
        steps = []
        while not engine.idle:
            tok0 = engine.generated_tokens
            pd0 = engine.prefill_dispatches
            ch0 = engine.chunks_run
            t0 = time.perf_counter()
            retired = engine.step()
            # DECODE tokens only: each finished admission emits exactly
            # one fused first token, which is prefill output, not decode
            # rate; count first tokens by their t_first stamp landing
            # inside THIS step.
            firsts = sum(
                1
                for r in list(engine._slot_req.values()) + retired
                if r.t_first is not None and r.t_first >= t0
            )
            steps.append((
                (engine.generated_tokens - tok0) - firsts,
                engine.prefill_dispatches - pd0,
                engine.chunks_run - ch0,
            ))
        done = {r.rid: r for r in engine.drain_completed()}
        ttfts = [done[r].ttft_secs * 1000 for r in shorts]
        streams = {rid: list(done[rid].tokens) for rid in done}
        return _pctl(ttfts, 0.99), steps, streams

    budget = bucket  # one chunk per step: the headline budget

    def _assert_parity(streams, streams_off, label):
        if streams != streams_off:
            raise RuntimeError(
                f"interleave bench: {label} token streams diverged "
                "from unbudgeted — the latency numbers would be "
                "comparing different work"
            )

    off_s, on_s = [], []
    streams_off = None
    for rep in range(3):
        p99_off, _, streams_off = serve(None)
        p99_on, steps_on, streams_on = serve(budget)
        # EVERY repeat is parity-pinned, not just the last.
        _assert_parity(streams_on, streams_off, f"budgeted (rep {rep})")
        off_s.append(p99_off)
        on_s.append(p99_on)
    ratios = [
        round(on / max(off, 1e-9), 3) for on, off in zip(on_s, off_s)
    ]
    # Decode dip from the last budgeted run: decode-token rate of steps
    # where a decode chunk ACTUALLY dispatched alongside prefill work,
    # vs steps that were pure decode; prefill-only steps are excluded
    # from both sides.
    burdened = [t for t, pd, ch in steps_on if pd > 0 and ch > 0]
    pure = [t for t, pd, ch in steps_on if pd == 0 and ch > 0]
    dip_pct = None
    if burdened and pure:
        dip_pct = round(
            (1.0 - (statistics.mean(burdened) / statistics.mean(pure)))
            * 100.0, 1,
        )
    # The headline budget equals ``bucket`` — its sweep point reuses the
    # three measurements above.
    sweep = {str(bucket): round(statistics.median(on_s), 2)}
    for b in (2 * bucket, 4 * bucket):
        p99_b, _, streams_b = serve(b)
        _assert_parity(streams_b, streams_off, f"budget {b}")
        sweep[str(b)] = round(p99_b, 2)
    return {
        "interleave_requests": n_req,
        "interleave_prefill_budget": budget,
        "interleave_long_prompt_tokens": long_len,
        "interleave_ttft_p99_ratio": round(statistics.median(ratios), 3),
        "interleave_ttft_p99_ratio_min": round(min(ratios), 3),
        "interleave_ttft_p99_ratio_max": round(max(ratios), 3),
        "interleave_short_ttft_p99_ms_budgeted": round(
            statistics.median(on_s), 2
        ),
        "interleave_short_ttft_p99_ms_unbudgeted": round(
            statistics.median(off_s), 2
        ),
        "interleave_decode_dip_pct": dip_pct,
        "interleave_budget_sweep": sweep,
    }


def measure_superstep(scale: BenchScale, device=None) -> dict:
    """Decode supersteps (``ServeEngine(superstep_k=k)``: k chained decode
    chunks per dispatch): sweep k over the SAME greedy request stream
    and measure what amortizing the per-chunk host round-trip buys.

    Every swept run's streams are asserted BIT-IDENTICAL to the k=1
    oracle before any number is published.  Repeats run round-robin
    across the k values so host drift hits every arm equally, and every
    TIMED arm runs bare — a separate UNTIMED observer-instrumented k=1
    pass yields ``decode_host_sync_ms`` (the median per-decode-step
    host-sync stall supersteps exist to divide by k).  The best-k arm
    reports its over-decode percentage (dead device steps past
    retirement vs tokens emitted)."""
    import statistics

    from .obs import EngineObserver
    from .serve import ServeEngine

    device = resolve_device(device)
    ps = scale.page_size
    chunk = ps
    batch = min(4, scale.batch)
    prompt_len = scale.decode_prompt
    ks = [1, 2, 4, 8]
    # Several supersteps per request at the deepest k, so steady-state
    # dominates the window; +3 keeps retirement OFF the superstep
    # boundary and exercises the over-decode reconciliation.
    max_new = ks[-1] * chunk * 2 + 3
    config = _config(scale, prompt_len + max_new)
    params = _params(config, 0, device)
    prompt = _prompt(11, prompt_len, config.vocab_size)
    n_req = 2 * batch
    overdecode = {}

    def serve(k: int, observer=None):
        engine = ServeEngine(
            params, config, slots=batch, page_size=ps, chunk=chunk,
            prompt_bucket=-(-prompt_len // ps) * ps, superstep_k=k,
            observer=observer, device=device,
        )
        engine.submit(prompt, max_new)  # warm at full depth
        engine.run()
        engine.drain_completed()
        if observer is not None:
            observer.drain_steps()
        before = engine.generated_tokens
        over0 = engine.tokens_overdecoded
        t0 = time.perf_counter()
        for _ in range(n_req):
            engine.submit(prompt, max_new)
        streams = engine.run()
        rate = (engine.generated_tokens - before) / (
            time.perf_counter() - t0
        )
        overdecode[k] = (
            engine.tokens_overdecoded - over0,
            engine.generated_tokens - before,
        )
        return rate, streams

    def check_oracle(streams, oracle, k):
        if streams != oracle:
            raise RuntimeError(
                f"superstep k={k} streams diverged from the k=1 "
                "greedy oracle — a throughput sweep over different "
                "tokens is meaningless"
            )

    oracle = None
    rates: dict[int, list[float]] = {k: [] for k in ks}
    for _ in range(3):
        for k in ks:
            rate, streams = serve(k)
            if oracle is None:
                oracle = streams
            else:
                check_oracle(streams, oracle, k)
            rates[k].append(rate)
    # The per-decode-step host-sync stall, from a SEPARATE untimed
    # instrumented k=1 pass (the StepRecord.host_sync_ms telemetry).
    obs = EngineObserver()
    _, streams = serve(1, observer=obs)
    check_oracle(streams, oracle, 1)
    decode_syncs = [
        r.host_sync_ms for r in obs.drain_steps() if r.decode_dispatches
    ]
    medians = {k: statistics.median(rates[k]) for k in ks}
    best_k = max(ks, key=lambda k: medians[k])
    over, emitted = overdecode[best_k]
    out = {
        "superstep_ks": ks,
        "superstep_requests": n_req,
        "superstep_best_k": best_k,
        "superstep_tokens_per_sec": round(medians[best_k], 1),
        "superstep_speedup": round(medians[best_k] / medians[1], 3),
        "superstep_overdecode_pct": round(
            100.0 * over / max(over + emitted, 1), 2
        ),
        # Best-k per-repeat samples: run() pools them with the prior
        # artifact's via _publish_ratio_spread.
        "superstep_tokens_per_sec_samples": [
            round(s, 1) for s in rates[best_k]
        ],
    }
    for k in ks:
        out[f"superstep_tokens_per_sec_k{k}"] = round(medians[k], 1)
    if decode_syncs:
        out["decode_host_sync_ms"] = round(
            statistics.median(decode_syncs), 3
        )
    return out


def measure_obs_overhead(scale: BenchScale, device=None) -> dict:
    """Observability must be provably cheap: the SAME composed serve
    stream measure_serve times (int8 base, sampling knobs, pipelined
    stepping) runs observer-OFF vs observer-ON — the full treatment:
    step/span rings AND the Prometheus bridge pushing into a live
    Registry.  Interleaved repeats; the published ``obs_overhead_pct``
    is the median per-pair throughput loss percentage with min/max
    spread (negative = noise floor)."""
    import statistics

    from tpu_device_plugin.metrics import Registry

    from .obs import EngineObserver
    from .quant import quantize_params
    from .serve import ServeEngine

    device = resolve_device(device)
    batch, ps = scale.batch, scale.page_size
    chunk = ps
    hi = scale.serve_chunks[1]
    prompt_len = scale.decode_prompt
    config = _config(scale, prompt_len + 1 + hi * chunk)
    params = quantize_params(_params(config, 0, device))
    prompt = _prompt(1, prompt_len, config.vocab_size)
    n_req = 3 * batch

    def serve(observed: bool) -> float:
        obs = None
        if observed:
            obs = EngineObserver()
            obs.bind_registry(Registry())
        engine = ServeEngine(
            params, config, slots=batch, page_size=ps, chunk=chunk,
            prompt_bucket=-(-prompt_len // ps) * ps,
            temperature=0.8, top_k=50, top_p=0.95,
            rng=_sampler(3, device), pipelined=True, observer=obs,
            device=device,
        )
        engine.submit(prompt, 1 + hi * chunk)  # warm: capture, launches
        engine.run()
        before = engine.generated_tokens
        t0 = time.perf_counter()
        for i in range(n_req):
            engine.submit(prompt, 1 + chunk * (1 + i % hi))
        engine.run()
        return (engine.generated_tokens - before) / (
            time.perf_counter() - t0
        )

    off_s, on_s = _interleaved_repeats(
        lambda: serve(False), lambda: serve(True)
    )
    overheads = [
        (off - on) / max(off, 1e-9) * 100.0 for off, on in zip(off_s, on_s)
    ]
    return {
        "obs_overhead_pct": round(statistics.median(overheads), 2),
        "obs_overhead_pct_min": round(min(overheads), 2),
        "obs_overhead_pct_max": round(max(overheads), 2),
        "obs_on_tokens_per_sec": round(statistics.median(on_s), 1),
        "obs_off_tokens_per_sec": round(statistics.median(off_s), 1),
        "obs_requests": n_req,
    }


def measure_profiler(scale: BenchScale, device=None) -> dict:
    """The device-time profiling layer must be provably cheap and
    provably inert: the measure_obs_overhead stream runs profiler-OFF
    (bare engine) vs profiler-ON — the FULL treatment: an observer with
    a live ``DeviceTimeTable`` feeding ``StepRecord.device_ms``, the
    Prometheus bridge pushing the ``engine_device_seconds`` family into
    a live Registry, and a ``RegressionSentry`` fed windowed signals
    through a ``SentryFeed`` poll per step.  Every interleaved pair's
    token streams are asserted bit-identical; the published
    ``profiler_overhead_pct`` is the median per-pair throughput loss.
    The ON run also publishes the headline device split —
    ``device_busy_fraction`` / ``host_stall_fraction`` — and its
    calibration table (``profiler_device_time_table``), the artifact
    payload ``DeviceTimeTable.refresh_from_artifact`` and the live
    sentry baseline against."""
    import statistics

    from tpu_device_plugin.metrics import Registry

    from .obs import EngineObserver
    from .profiler import DeviceTimeTable, RegressionSentry, SentryFeed
    from .quant import quantize_params
    from .serve import ServeEngine

    device = resolve_device(device)
    batch, ps = scale.batch, scale.page_size
    chunk = ps
    hi = scale.serve_chunks[1]
    prompt_len = scale.decode_prompt
    config = _config(scale, prompt_len + 1 + hi * chunk)
    params = quantize_params(_params(config, 0, device))
    prompt = _prompt(1, prompt_len, config.vocab_size)
    # A longer timed stream than the other overhead arms: the layer's
    # per-step cost is near the noise floor, so the ratio needs more
    # timed steps per pair before the median stops chasing host drift.
    n_req = 8 * batch

    def serve(profiled: bool):
        obs = feed = None
        if profiled:
            obs = EngineObserver(device_table=DeviceTimeTable())
            obs.bind_registry(Registry())
            sentry = RegressionSentry()
            # Self-baselining watches (no recorder attached): the arm
            # prices the detector arithmetic, not incident handling.
            for name, direction in (
                ("tokens_per_sec", "down_bad"),
                ("host_sync_ms", "up_bad"),
                ("device_busy_fraction", "down_bad"),
            ):
                sentry.watch(name, None, 0.25, direction=direction)
            # Production cadence: polled every step, with the feed's
            # own windowing deciding when a full extraction runs.
            feed = SentryFeed(sentry)
        engine = ServeEngine(
            params, config, slots=batch, page_size=ps, chunk=chunk,
            prompt_bucket=-(-prompt_len // ps) * ps,
            temperature=0.8, top_k=50, top_p=0.95,
            rng=_sampler(3, device), pipelined=True, observer=obs,
            device=device,
        )
        if feed is not None:
            feed.attach(engine, obs)
        engine.submit(prompt, 1 + hi * chunk)  # warm: capture, launches
        engine.run()
        before = engine.generated_tokens
        rids = []
        t0 = time.perf_counter()
        for i in range(n_req):
            rids.append(engine.submit(prompt, 1 + chunk * (1 + i % hi)))
        # Drive by stepping (not run()) so the ON arm pays the sentry
        # feed at the production cadence — one poll per step.
        results = {}
        while not engine.idle:
            for req in engine.step():
                results[req.rid] = req.tokens
            if feed is not None:
                feed.poll()
        rate = (engine.generated_tokens - before) / (
            time.perf_counter() - t0
        )
        return rate, [list(results[r]) for r in rids], obs

    # 7 interleaved pairs (vs the default 3): the layer's true cost sits
    # near the noise floor.
    off_runs, on_runs = _interleaved_repeats(
        lambda: serve(False), lambda: serve(True), repeats=7
    )
    for (_, off_stream, _), (_, on_stream, _) in zip(off_runs, on_runs):
        if off_stream != on_stream:
            raise RuntimeError("token streams diverged profiler on/off")
    overheads = [
        (off - on) / max(off, 1e-9) * 100.0
        for (off, *_), (on, *_) in zip(off_runs, on_runs)
    ]
    obs = on_runs[-1][2]
    busy = obs.device_busy_fraction
    return {
        "profiler_overhead_pct": round(statistics.median(overheads), 2),
        "profiler_overhead_pct_min": round(min(overheads), 2),
        "profiler_overhead_pct_max": round(max(overheads), 2),
        "profiler_on_tokens_per_sec": round(
            statistics.median(r for r, *_ in on_runs), 1
        ),
        "profiler_off_tokens_per_sec": round(
            statistics.median(r for r, *_ in off_runs), 1
        ),
        "profiler_requests": n_req,
        "device_busy_fraction": round(busy, 4),
        "host_stall_fraction": round(1.0 - busy, 4),
        "profiler_device_time_table": obs.device_table.to_dict(),
    }


def measure_ledger(scale: BenchScale, device=None) -> dict:
    """The chip-time ledger must be provably cheap AND its books must
    describe a messy run exactly: a seeded mixed-length greedy stream
    with SPECULATION on (an int8 self-draft) and two scheduled seam
    faults (a spec dispatch and a prefill dispatch quarantine -> replay)
    runs ledger-OFF vs ledger-ON in interleaved repeats, every pair's
    token streams asserted bit-identical.  Published:
    ``ledger_overhead_pct`` (median per-pair throughput loss, min/max
    spread), ``ledger_goodput_fraction`` and the replay / spec-rejected
    waste shares of all charged device work.  Reconciliation (goodput +
    waste == tokens accounted, nothing pending) is asserted on every
    armed run."""
    import statistics

    from .faults import FaultInjector
    from .ledger import ChipTimeLedger
    from .quant import quantize_params
    from .serve import ServeEngine

    device = resolve_device(device)
    batch, ps = scale.batch, scale.page_size
    chunk = ps
    hi = scale.serve_chunks[1]
    prompt_len = scale.decode_prompt
    config = _config(scale, prompt_len + 1 + hi * chunk)
    params = _params(config, 0, device)
    draft = quantize_params(params)
    prompt = _prompt(1, prompt_len, config.vocab_size)
    n_req = 3 * batch

    def serve(ledgered: bool):
        led = ChipTimeLedger() if ledgered else None
        # Identical schedules both arms: the quarantine/replay path is
        # part of the measured stream, not a difference between arms.
        injector = FaultInjector(
            {"spec_dispatch": [4], "prefill_dispatch": [3]}
        )
        engine = ServeEngine(
            params, config, slots=batch, page_size=ps, chunk=chunk,
            prompt_bucket=-(-prompt_len // ps) * ps,
            draft_params=draft, draft_config=config, gamma=4,
            rng=_sampler(3, device), pipelined=True,
            fault_injector=injector, max_retries=4, ledger=led,
            device=device,
        )
        engine.submit(prompt, 1 + hi * chunk)  # warm: capture, launches
        engine.run()
        before = engine.generated_tokens
        rids = []
        t0 = time.perf_counter()
        for i in range(n_req):
            rids.append(
                engine.submit(prompt, 1 + chunk * (1 + i % hi))
            )
        out = engine.run()
        rate = (engine.generated_tokens - before) / (
            time.perf_counter() - t0
        )
        streams = [list(out[r]) for r in rids]
        if engine.steps_quarantined < 1:
            raise RuntimeError(
                "the scheduled faults must actually exercise the replay "
                "accounting"
            )
        if led is not None:
            verdict = led.reconcile(expect_quiescent=True)
            if not verdict["ok"]:
                raise RuntimeError(f"ledger does not reconcile: {verdict}")
        return rate, streams, led, engine.steps_quarantined

    off_runs, on_runs = _interleaved_repeats(
        lambda: serve(False), lambda: serve(True)
    )
    for (_, off_stream, *_), (_, on_stream, *_) in zip(off_runs, on_runs):
        if off_stream != on_stream:
            raise RuntimeError("token streams diverged ledger on/off")
    overheads = [
        (off - on) / max(off, 1e-9) * 100.0
        for (off, *_), (on, *_) in zip(off_runs, on_runs)
    ]
    led = on_runs[-1][2]
    accounted = max(led.tokens_accounted, 1)
    return {
        "ledger_overhead_pct": round(statistics.median(overheads), 2),
        "ledger_overhead_pct_min": round(min(overheads), 2),
        "ledger_overhead_pct_max": round(max(overheads), 2),
        "ledger_on_tokens_per_sec": round(
            statistics.median(r for r, *_ in on_runs), 1
        ),
        "ledger_off_tokens_per_sec": round(
            statistics.median(r for r, *_ in off_runs), 1
        ),
        "ledger_goodput_fraction": round(led.goodput_fraction, 4),
        "ledger_busy_fraction": round(led.busy_fraction, 4),
        "ledger_waste_replay_pct": round(
            led.waste_tokens["replay"] / accounted * 100.0, 2
        ),
        "ledger_waste_spec_rejected_pct": round(
            led.waste_tokens["spec_rejected"] / accounted * 100.0, 2
        ),
        "ledger_waste_overdecode_pct": round(
            led.waste_tokens["overdecode"] / accounted * 100.0, 2
        ),
        "ledger_requests": n_req,
        "ledger_quarantines": on_runs[-1][3],
    }


def measure_fault_recovery(scale: BenchScale, device=None) -> dict:
    """Fault tolerance must be provably cheap AND provably fast: the
    composed serve stream (int8 base, pipelined stepping, greedy so
    replayed streams are bit-comparable) runs three ways —

      1. no injector at all (the baseline),
      2. an ARMED-BUT-INERT injector (every seam consults it, nothing
         fires): the production cost of carrying the seam checks,
         published as ``fault_injector_off_overhead_pct`` (interleaved
         repeats, median per-pair loss with min/max spread),
      3. one injected ``decode_dispatch`` fault mid-stream: the engine
         quarantines the step, requeues by replay, and the measured
         quarantine -> first-good-readback window is published as
         ``fault_recovery_ms`` (median over repeats with spread).

    The faulted run's token streams are checked against the baseline's
    before any number is published: in float32, equal (replay is
    bit-identical under greedy, JAX's check); in bf16 each replayed
    request's tokens kept at its requeue equal the baseline's and every
    stream has its full length.  A bf16 replay re-prefills the emitted
    tokens in one block product, whose rows round otherwise than the
    one-token decode steps that first wrote them on the card, so its
    continuation may part from the baseline at a near-tie (the port's
    replay contract, chip_smoke.py phase 4b); the streams that still
    equal the baseline are counted (``fault_replay_streams_equal``)."""
    import statistics

    from .faults import FaultInjector
    from .quant import quantize_params
    from .serve import ServeEngine

    device = resolve_device(device)
    batch, ps = scale.batch, scale.page_size
    chunk = ps
    hi = scale.serve_chunks[1]
    prompt_len = scale.decode_prompt
    config = _config(scale, prompt_len + 1 + hi * chunk)
    params = quantize_params(_params(config, 0, device))
    prompt = _prompt(1, prompt_len, config.vocab_size)
    n_req = 2 * batch

    def serve(injector, schedule=None):
        """One measured stream; returns (tokens/s, streams, engine, kept:
        {rid: tokens emitted at its first requeue}).  ``schedule`` arms
        the injector only AFTER warmup (reset + arm), so the scheduled
        fault lands at a deterministic mid-stream dispatch regardless of
        how many seams warmup crossed."""
        engine = ServeEngine(
            params, config, slots=batch, page_size=ps, chunk=chunk,
            prompt_bucket=-(-prompt_len // ps) * ps,
            pipelined=True, fault_injector=injector, max_retries=4,
            device=device,
        )
        kept: dict[str, int] = {}
        requeue = engine._requeue_or_fail

        def recording_requeue(req, exc, **kw):
            kept.setdefault(req.rid, len(req.tokens))
            return requeue(req, exc, **kw)

        engine._requeue_or_fail = recording_requeue
        engine.submit(prompt, 1 + hi * chunk)  # warm: capture, launches
        engine.run()
        if injector is not None:
            injector.reset()
            if schedule:
                injector.arm(schedule)
        before = engine.generated_tokens
        t0 = time.perf_counter()
        for i in range(n_req):
            engine.submit(prompt, 1 + chunk * (1 + i % hi))
        streams = engine.run()
        rate = (engine.generated_tokens - before) / (
            time.perf_counter() - t0
        )
        return rate, streams, engine, kept

    off_s, armed_s = _interleaved_repeats(
        lambda: serve(None)[0], lambda: serve(FaultInjector())[0]
    )
    overheads = [
        (off - on) / max(off, 1e-9) * 100.0
        for off, on in zip(off_s, armed_s)
    ]

    _, ref_streams, _, _ = serve(None)
    recoveries: list[float] = []
    retried = equal = 0
    for _ in range(3):
        injector = FaultInjector()
        _, streams, engine, kept = serve(
            injector, schedule={"decode_dispatch": [3]}
        )
        equal += _hold_replay(
            streams, ref_streams, kept, config.dtype, "fault-recovery bench"
        )
        if len(engine.fault_recovery_s) != 1 or engine.steps_quarantined != 1:
            raise RuntimeError(
                f"fault-recovery bench expected exactly one quarantine/"
                f"recovery, saw {engine.steps_quarantined}/"
                f"{len(engine.fault_recovery_s)}"
            )
        recoveries.extend(engine.fault_recovery_s)
        retried += engine.requests_retried
    rec_ms = [r * 1000 for r in recoveries]
    return {
        "fault_recovery_ms": round(statistics.median(rec_ms), 2),
        "fault_recovery_ms_min": round(min(rec_ms), 2),
        "fault_recovery_ms_max": round(max(rec_ms), 2),
        "fault_recovery_requeued": retried,
        "fault_replay_streams_equal": equal,
        "fault_replay_streams": 3 * len(ref_streams),
        "fault_injector_off_overhead_pct": round(
            statistics.median(overheads), 2
        ),
        "fault_injector_off_overhead_pct_min": round(min(overheads), 2),
        "fault_injector_off_overhead_pct_max": round(max(overheads), 2),
        "fault_baseline_tokens_per_sec": round(statistics.median(off_s), 1),
        "fault_armed_tokens_per_sec": round(statistics.median(armed_s), 1),
        "fault_requests": n_req,
    }


def measure_fleet(scale: BenchScale, device=None) -> dict:
    """Fleet serving economics, five questions measured on one composed
    engine shape (int8 base, pipelined stepping, greedy so streams
    compare), every replica's decode a replay of its own ``DecodeGraph``
    through K1:

      1. **Aggregate throughput + tail** — 4 replicas behind the
         router under the seeded open-loop generator (bursty arrivals,
         heavy-tailed prompts): ``fleet_tokens_per_sec`` and the pooled
         ``fleet_ttft_p50/p99_ms`` a client of the fleet would see.  On
         one card the replicas step one after another, so the fleet's
         rate is about one engine's.
      2. **Router tax** — the same closed-loop stream through a BARE
         engine vs a Fleet of ONE replica (interleaved repeats):
         ``router_overhead_ms`` a request (median per-pair with spread;
         can read negative at the noise floor).
      3. **Failover recovery** — one scheduled ``replica_crash`` at
         crossing ``2 * n_rep + 1`` under the closed-loop stream: the
         crash -> first-token-on-a-survivor window,
         ``failover_recovery_ms`` (median over three repeats with
         spread).  Every rid must reach one ``ok``; the crashed runs'
         streams are held against a fault-free run by ``_hold_replay``
         (whole in float32; in bf16 the tokens kept at the requeue and
         every length), the whole-equal ones counted in
         ``failover_replay_streams_equal``.
      4. **Per-class SLO attainment** — the generator's per-class
         arrival streams (``schedule_per_class``): attainment ratios,
         class TTFT/TPOT tails and end-of-run burn rates.
      5. **Fleet-trace overhead** — the closed-loop stream with the
         full fleet observability treatment (per-replica engine
         observers + fleet observer + SLO class tags, all pushing into
         a live Registry) vs bare, interleaved repeats:
         ``fleet_trace_overhead_pct``, every on/off pair's streams
         asserted equal (tracing and class tags never move a token)."""
    import statistics

    from tpu_device_plugin.metrics import Registry

    from .faults import FaultInjector
    from .fleet import Fleet, TrafficGen, drive_open_loop
    from .obs import EngineObserver, FleetObserver
    from .quant import quantize_params
    from .serve import ServeEngine

    device = resolve_device(device)
    batch, ps = scale.batch, scale.page_size
    chunk = ps
    hi = scale.serve_chunks[1]
    prompt_len = scale.decode_prompt
    config = _config(scale, prompt_len + 1 + hi * chunk)
    params = quantize_params(_params(config, 0, device))
    n_rep = 4
    n_req = 4 * batch
    gen = TrafficGen(
        seed=9, rate_rps=100.0, min_prompt=1, max_prompt=prompt_len,
        min_new=1 + chunk, max_new=1 + hi * chunk,
        vocab=config.vocab_size,
    )
    sched = gen.schedule(n_req)
    engine_kw = dict(
        slots=batch, page_size=ps, chunk=chunk,
        prompt_bucket=-(-prompt_len // ps) * ps, pipelined=True,
        device=device,
    )

    def build_fleet(n, injector=None, observed=False):
        observers = [None] * n
        fleet_obs = None
        if observed:
            # The full treatment a scrape-plus-trace deployment pays:
            # per-replica engine observers and the fleet observer, every
            # bridge pushing into a live Registry.
            reg = Registry()
            observers = [
                EngineObserver(name=str(i), replica=str(i))
                for i in range(n)
            ]
            for o in observers:
                o.bind_registry(reg)
            fleet_obs = FleetObserver()
            fleet_obs.bind_registry(reg)
        engines = [
            ServeEngine(params, config, observer=observers[i], **engine_kw)
            for i in range(n)
        ]
        fleet = Fleet(
            engines, chip_ids=[f"chip-{i}" for i in range(n)],
            fault_injector=injector, observer=fleet_obs,
            # Graph captures past the exempt first step must not read
            # as hangs.
            hang_timeout_s=60.0,
        )
        for i in range(n):  # warm every replica's capture, off the clock
            fleet.submit([1 + i], 1 + chunk)
        fleet.run()
        fleet.drain_completed()
        return fleet

    def open_loop():
        """One open-loop run; returns (rate, finished requests)."""
        fleet = build_fleet(n_rep)
        tokens0 = fleet.generated_tokens
        t0 = time.perf_counter()
        streams = drive_open_loop(fleet, sched, session_every=4)
        secs = time.perf_counter() - t0
        rate = (fleet.generated_tokens - tokens0) / secs
        if len(streams) != n_req:
            raise RuntimeError(
                f"fleet bench served {len(streams)} of {n_req} requests"
            )
        done = fleet.drain_completed()
        statuses = {fr.status for fr in done}
        if statuses != {"ok"}:
            raise RuntimeError(
                f"fleet bench expected every request ok, saw {statuses}"
            )
        fleet.close()
        return rate, done

    rate, done = open_loop()
    ttfts = [
        fr.ttft_secs * 1000 for fr in done if fr.ttft_secs is not None
    ]
    _release(device)

    # Router tax: bare engine vs a one-replica fleet, same closed-loop
    # stream (closed-loop so both arms measure the dispatch machinery,
    # not the arrival process).
    prompts = [(p, n) for _, p, n in sched]

    def bare() -> float:
        engine = ServeEngine(params, config, **engine_kw)
        engine.submit([1], 1 + chunk)
        engine.run()
        t0 = time.perf_counter()
        for p, n in prompts:
            engine.submit(p, n)
        engine.run()
        secs = time.perf_counter() - t0
        engine.close()
        del engine
        _release(device)
        return secs

    def fleet1() -> float:
        fleet = build_fleet(1)
        t0 = time.perf_counter()
        for p, n in prompts:
            fleet.submit(p, n)
        fleet.run()
        secs = time.perf_counter() - t0
        fleet.close()
        del fleet
        _release(device)
        return secs

    bare_s, fleet1_s = _interleaved_repeats(bare, fleet1)
    overhead_ms = [
        (f - b) / n_req * 1000 for b, f in zip(bare_s, fleet1_s)
    ]

    # Failover: a fault-free reference run, then crashed repeats held
    # against it.  CLOSED-loop (the generator's prompts submitted up
    # front) so the crash step finds in-flight work on the victim.
    def closed_loop(injector=None, schedule=None):
        """``schedule`` arms the injector only AFTER the warm run inside
        build_fleet (reset + arm), so the scheduled crash lands at a
        deterministic measured-stream step.  Returns (streams, kept at
        the requeue, crashes, recovery windows, charged requeues)."""
        fleet = build_fleet(n_rep, injector)
        kept = _kept_at_requeue(fleet)
        if injector is not None:
            injector.reset()
            if schedule:
                injector.arm(schedule)
        for i, (p, n) in enumerate(prompts):
            fleet.submit(p, n, session=f"sess-{i % 4}")
        streams = fleet.run()
        done = fleet.drain_completed()
        statuses = {fr.status for fr in done}
        if len(done) != n_req or statuses != {"ok"}:
            raise RuntimeError(
                f"fleet failover bench: {len(done)} finished with "
                f"statuses {statuses}, expected {n_req} ok"
            )
        out = (streams, kept, fleet.replica_crashes,
               list(fleet.failover_recovery_s), fleet.failover_requeues)
        fleet.close()
        del fleet
        _release(device)
        return out

    ref_streams = closed_loop()[0]
    recoveries: list[float] = []
    requeued = equal = 0
    for _ in range(3):
        # Crossing 2n+1 = fleet step 3, replica 0 — mid-stream, with
        # every slot occupied by the up-front submissions.
        streams, kept, crashes, windows, charged = closed_loop(
            FaultInjector(),
            schedule={"replica_crash": 2 * n_rep + 1},
        )
        equal += _hold_replay(
            streams, ref_streams, kept, config.dtype, "fleet failover bench"
        )
        if crashes != 1:
            raise RuntimeError(
                f"fleet failover bench expected exactly one crash, saw "
                f"{crashes}"
            )
        if len(windows) != 1:
            raise RuntimeError(
                f"fleet failover bench expected one recovery window, "
                f"saw {len(windows)} (the crash found no in-flight work)"
            )
        recoveries.extend(windows)
        requeued += charged
    rec_ms = [r * 1000 for r in recoveries]

    # Per-class SLO attainment: one independent seeded arrival process
    # per class at its weight share of the rate.
    classed = gen.schedule_per_class(n_req)
    fleet_slo = build_fleet(n_rep)
    streams = drive_open_loop(fleet_slo, classed, session_every=4)
    if len(streams) != len(classed):
        raise RuntimeError(
            f"fleet SLO bench served {len(streams)} of "
            f"{len(classed)} requests"
        )
    done = fleet_slo.drain_completed()
    attainment = fleet_slo.slo_attainment()
    burn = fleet_slo.slo_burn_rates()
    fleet_slo.close()
    del fleet_slo
    _release(device)
    by_class: dict[str, list] = {}
    for fr in done:
        if fr.slo_class is not None:
            by_class.setdefault(fr.slo_class, []).append(fr)
    slo_fields: dict = {}
    for name in ("interactive", "bulk"):
        spans = by_class.get(name, [])
        ratio = attainment.get(name)
        if ratio is not None:
            slo_fields[f"fleet_slo_attainment_{name}"] = round(ratio, 3)
            slo_fields[f"fleet_slo_burn_rate_{name}"] = round(
                burn.get(name, 0.0), 3
            )
            # Scored requests only (cancelled are excluded from the
            # attainment denominator).
            slo_fields[f"fleet_slo_requests_{name}"] = sum(
                1 for fr in spans if fr.slo_attained is not None
            )
        ttfts_c = [
            fr.ttft_secs * 1000 for fr in spans
            if fr.ttft_secs is not None
        ]
        tpots_c = [
            fr.tpot_secs * 1000 for fr in spans
            if fr.tpot_secs is not None
        ]
        if ttfts_c:
            slo_fields[f"fleet_{name}_ttft_p99_ms"] = round(
                _pctl(ttfts_c, 0.99), 2
            )
        if tpots_c:
            slo_fields[f"fleet_{name}_tpot_p99_ms"] = round(
                _pctl(tpots_c, 0.99), 2
            )

    # Fleet-trace overhead: the closed-loop stream bare vs under the
    # full observability treatment + SLO tags, interleaved repeats with
    # every pair's streams asserted equal.
    trace_streams: dict[bool, list] = {False: [], True: []}

    def traced_run(observed: bool) -> float:
        fleet = build_fleet(n_rep, observed=observed)
        tokens0 = fleet.generated_tokens
        t0 = time.perf_counter()
        for i, (p, n) in enumerate(prompts):
            fleet.submit(
                p, n, session=f"sess-{i % 4}",
                slo_class=(
                    ("interactive" if i % 4 else "bulk") if observed
                    else None
                ),
            )
        streams = fleet.run()
        secs = time.perf_counter() - t0
        rate = (fleet.generated_tokens - tokens0) / secs
        trace_streams[observed].append(streams)
        fleet.close()
        del fleet
        _release(device)
        return rate

    trace_off, trace_on = _interleaved_repeats(
        lambda: traced_run(False), lambda: traced_run(True)
    )
    for off_streams, on_streams in zip(
        trace_streams[False], trace_streams[True]
    ):
        if off_streams != on_streams:
            raise RuntimeError(
                "fleet-trace bench: streams diverged observer on vs "
                "off — fleet tracing + SLO classes are supposed to be "
                "inert"
            )
    trace_overheads = [
        (off - on) / max(off, 1e-9) * 100.0
        for off, on in zip(trace_off, trace_on)
    ]
    return {
        "fleet_replicas": n_rep,
        "fleet_requests": n_req,
        **slo_fields,
        "fleet_trace_overhead_pct": round(
            statistics.median(trace_overheads), 2
        ),
        "fleet_trace_overhead_pct_min": round(min(trace_overheads), 2),
        "fleet_trace_overhead_pct_max": round(max(trace_overheads), 2),
        "fleet_trace_on_tokens_per_sec": round(
            statistics.median(trace_on), 1
        ),
        "fleet_trace_off_tokens_per_sec": round(
            statistics.median(trace_off), 1
        ),
        "fleet_tokens_per_sec": round(rate, 1),
        "fleet_ttft_p50_ms": round(_pctl(ttfts, 0.50), 2),
        "fleet_ttft_p99_ms": round(_pctl(ttfts, 0.99), 2),
        "router_overhead_ms": round(statistics.median(overhead_ms), 3),
        "router_overhead_ms_min": round(min(overhead_ms), 3),
        "router_overhead_ms_max": round(max(overhead_ms), 3),
        "failover_recovery_ms": round(statistics.median(rec_ms), 2),
        "failover_recovery_ms_min": round(min(rec_ms), 2),
        "failover_recovery_ms_max": round(max(rec_ms), 2),
        "failover_requeued": requeued,
        "failover_replay_streams_equal": equal,
        "failover_replay_streams": 3 * n_req,
    }


def measure_disagg(scale: BenchScale, device=None) -> dict:
    """Disaggregated prefill/decode pools vs a mixed fleet, measured as
    INTERLEAVED repeats of the SAME seeded per-class open-loop stream
    (``schedule_per_class``) through two 3-replica fleets — all-mixed vs
    roles=[prefill, decode, decode] with SLO-class WFQ armed — with every
    pair's token streams held by ``_hold_near_ties`` before any number is
    published (the split moves WHERE work runs, never what a client
    receives).  float32 holds them whole.  The decode replica re-prefills
    the prompt's last page and the token the prefill replica emitted in
    one block, where the mixed fleet wrote that token's k/v in a
    one-token step, so in bf16 a stream may part at a near-tie
    (``disagg_streams_equal`` counts the whole ones):

      * ``disagg_handoff_ms`` — prefill-done -> first decode-pool token
        per handed-off stream (park + one gathered copy to the host on
        the prefill replica, graft + a page write on the decode
        replica's admission), pooled across repeats with min/max.
      * ``disagg_decode_dip_pct`` — the bulk class's TPOT tail stretch
        (p99/p50 - 1) on the disagg arm; ``disagg_mixed_decode_dip_pct``
        the same on the mixed arm.
      * ``disagg_interactive_ttft_p99_ms`` — the interactive class's
        TTFT tail on the disagg arm, beside the mixed arm's.
      * per-class attainment deltas (disagg minus mixed) and the
        throughput ratio ``disagg_vs_mixed_tokens_per_sec``.

    Every handoff ships real pages: the arm asserts >= 1 handoff and
    >= 1 ticket page grafted into a decode replica per disagg run.  On
    one card the three replicas step one after another, so the split
    moves no work off the card."""
    import statistics

    from .fleet import Fleet, TrafficGen, drive_open_loop
    from .quant import quantize_params
    from .serve import ServeEngine

    device = resolve_device(device)
    batch, ps = scale.batch, scale.page_size
    chunk = ps
    hi = scale.serve_chunks[1]
    prompt_len = max(scale.decode_prompt, 2 * ps)
    config = _config(scale, prompt_len + 1 + hi * chunk)
    params = quantize_params(_params(config, 0, device))
    n_rep = 3
    roles = ["prefill", "decode", "decode"]
    n_req = 4 * batch
    gen = TrafficGen(
        # min_prompt = one full page so every prompt has pages to hand
        # off; the Pareto tail reaches prompt_len.
        seed=13, rate_rps=100.0, min_prompt=ps, max_prompt=prompt_len,
        min_new=1 + chunk, max_new=1 + hi * chunk,
        vocab=config.vocab_size,
    )
    classed = gen.schedule_per_class(n_req)
    sched_stats = TrafficGen.schedule_stats(classed)

    def build_fleet(split: bool):
        engines = [
            ServeEngine(
                params, config, slots=batch, page_size=ps, chunk=chunk,
                # One-page buckets + a one-chunk budget: prompts run the
                # budgeted sweep (page-granular prefix hits, so a grafted
                # ticket always reloads).
                prompt_bucket=ps, prefill_budget=ps, pipelined=True,
                prefix_cache=True, kv_offload=True, device=device,
            )
            for _ in range(n_rep)
        ]
        fleet = Fleet(
            engines, chip_ids=[f"chip-{i}" for i in range(n_rep)],
            hang_timeout_s=60.0,
            roles=roles if split else None,
            wfq_weights=(
                {"interactive": 3.0, "bulk": 1.0} if split else None
            ),
        )
        # Warm every pool's capture AND the handoff path itself (one
        # multi-page prompt covers the gathered-spill shapes), off the
        # measured clock.
        for i in range(n_rep):
            fleet.submit([1 + i] * ps, 2, session=f"warm-{i}")
        fleet.submit(list(range(2, 2 + prompt_len)), 1 + chunk)
        fleet.run()
        fleet.drain_completed()
        return fleet

    def run_arm(split: bool) -> dict:
        fleet = build_fleet(split)
        handoffs0 = fleet.kv_handoffs
        pages0 = fleet.handoff_pages
        windows0 = len(fleet.handoff_s)
        tokens0 = fleet.generated_tokens
        t0 = time.perf_counter()
        streams = drive_open_loop(fleet, classed, session_every=4)
        secs = time.perf_counter() - t0
        if len(streams) != len(classed):
            raise RuntimeError(
                f"disagg bench served {len(streams)} of {len(classed)} "
                "requests"
            )
        done = fleet.drain_completed()
        statuses = {fr.status for fr in done}
        if statuses != {"ok"}:
            raise RuntimeError(
                f"disagg bench expected every request ok, saw {statuses}"
            )
        out = {
            "streams": streams,
            "prompts": {fr.rid: fr.prompt for fr in done},
            "rate": (fleet.generated_tokens - tokens0) / secs,
            "handoffs": fleet.kv_handoffs - handoffs0,
            "pages": fleet.handoff_pages - pages0,
            "handoff_ms": [
                s * 1000 for s in fleet.handoff_s[windows0:]
            ],
            "attainment": fleet.slo_attainment(),
        }
        for name in ("interactive", "bulk"):
            frs = [fr for fr in done if fr.slo_class == name]
            ttfts = [
                fr.ttft_secs * 1000 for fr in frs
                if fr.ttft_secs is not None
            ]
            tpots = [
                fr.tpot_secs * 1000 for fr in frs
                if fr.tpot_secs is not None
            ]
            out[f"{name}_ttft_p99_ms"] = (
                _pctl(ttfts, 0.99) if ttfts else None
            )
            out[f"{name}_tpot_p50_ms"] = (
                _pctl(tpots, 0.50) if tpots else None
            )
            out[f"{name}_tpot_p99_ms"] = (
                _pctl(tpots, 0.99) if tpots else None
            )
        if split:
            if out["handoffs"] < 1 or out["pages"] < 1:
                raise RuntimeError(
                    f"disagg bench moved no KV: {out['handoffs']} "
                    f"handoffs, {out['pages']} ticket pages grafted — "
                    "the split fleet is not actually handing off"
                )
        fleet.close()
        del fleet
        _release(device)
        return out

    mixed_runs, disagg_runs = _interleaved_repeats(
        lambda: run_arm(False), lambda: run_arm(True), repeats=2,
    )
    equal, partings = 0, []
    for m, d in zip(mixed_runs, disagg_runs):
        whole, parted = _hold_near_ties(
            params, config, d["streams"], m["streams"], m["prompts"],
            "disagg bench: split fleet against the mixed fleet",
        )
        equal += whole
        partings += parted

    def dip(run: dict) -> float | None:
        p50, p99 = run["bulk_tpot_p50_ms"], run["bulk_tpot_p99_ms"]
        if not p50 or p99 is None:
            return None
        return (p99 / p50 - 1.0) * 100.0

    handoff_ms = sorted(
        ms for r in disagg_runs for ms in r["handoff_ms"]
    )
    dips_d = [v for v in (dip(r) for r in disagg_runs) if v is not None]
    dips_m = [v for v in (dip(r) for r in mixed_runs) if v is not None]
    ttfts_d = [
        r["interactive_ttft_p99_ms"] for r in disagg_runs
        if r["interactive_ttft_p99_ms"] is not None
    ]
    ttfts_m = [
        r["interactive_ttft_p99_ms"] for r in mixed_runs
        if r["interactive_ttft_p99_ms"] is not None
    ]
    ratios = [
        d["rate"] / m["rate"]
        for d, m in zip(disagg_runs, mixed_runs)
    ]
    out = {
        "disagg_replicas": n_rep,
        "disagg_roles": ",".join(roles),
        "disagg_requests": len(classed),
        "disagg_schedule_stats": sched_stats,
        "disagg_handoffs": disagg_runs[-1]["handoffs"],
        "disagg_handoff_pages": disagg_runs[-1]["pages"],
        "disagg_handoff_ms": round(statistics.median(handoff_ms), 2),
        "disagg_handoff_ms_min": round(handoff_ms[0], 2),
        "disagg_handoff_ms_max": round(handoff_ms[-1], 2),
        "disagg_vs_mixed_tokens_per_sec": round(
            statistics.median(ratios), 3
        ),
        "disagg_vs_mixed_tokens_per_sec_min": round(min(ratios), 3),
        "disagg_vs_mixed_tokens_per_sec_max": round(max(ratios), 3),
        "disagg_streams_equal": equal,
        "disagg_streams": len(disagg_runs) * len(classed),
        **_parting_keys("disagg", partings),
    }
    if dips_d:
        out["disagg_decode_dip_pct"] = round(statistics.median(dips_d), 2)
        out["disagg_decode_dip_pct_min"] = round(min(dips_d), 2)
        out["disagg_decode_dip_pct_max"] = round(max(dips_d), 2)
    if dips_m:
        out["disagg_mixed_decode_dip_pct"] = round(
            statistics.median(dips_m), 2
        )
    if ttfts_d:
        out["disagg_interactive_ttft_p99_ms"] = round(
            statistics.median(ttfts_d), 2
        )
        out["disagg_interactive_ttft_p99_ms_min"] = round(min(ttfts_d), 2)
        out["disagg_interactive_ttft_p99_ms_max"] = round(max(ttfts_d), 2)
    if ttfts_m:
        out["disagg_mixed_interactive_ttft_p99_ms"] = round(
            statistics.median(ttfts_m), 2
        )
    for name in ("interactive", "bulk"):
        att_d = disagg_runs[-1]["attainment"].get(name)
        att_m = mixed_runs[-1]["attainment"].get(name)
        if att_d is not None:
            out[f"disagg_attainment_{name}"] = round(att_d, 3)
        if att_d is not None and att_m is not None:
            out[f"disagg_attainment_delta_{name}"] = round(
                att_d - att_m, 3
            )
    return out


def measure_selfheal(scale: BenchScale, device=None) -> dict:
    """Self-healing fleet economics, on the measure_fleet engine shape
    (int8 base, pipelined, greedy so streams compare):

      1. **Restore latency** — a scheduled ``replica_crash`` mid-stream
         with the ``FleetSupervisor`` armed: the death-detection ->
         probed-replacement-rejoined window is ``selfheal_restore_ms``
         (median over repeats with spread).  Each crashed run's streams
         are held against a fault-free run by ``_hold_replay`` (whole
         in float32; in bf16 the tokens kept at the requeue and every
         length; ``selfheal_replay_streams_equal`` counts the whole
         ones), while the robustness outcome publishes honestly: the
         fraction of pre-fault alive replicas back without operator
         intervention lands in ``selfheal_capacity_recovered``, and
         ``selfheal_goodput_retained`` is the ok fraction under the
         closed-loop load.
      2. **Cold vs warm restore** — ``replica_restore_cold_ms`` times
         the arm's FIRST engine build + canary probe, against
         ``replica_restore_warm_ms`` (the same build + probe again).
         JAX's cold number carries an XLA compile; here the kernels are
         already built (``ops/_build.py``'s cache), so cold carries the
         first cuBLAS calls at these shapes and the decode graph's
         capture, which every build pays again.
      3. **Crash-loop quarantine** — a scripted repeat-crash-on-restart
         (``crash_loop_schedule`` at the ``replica_respawn`` seam): the
         chip slot must QUARANTINE (``selfheal_crash_loops`` = 1), the
         replica must NOT rejoin, and the degraded fleet still serves
         every request ok on the survivors."""
    import statistics

    from .backoff import Backoff
    from .faults import FaultInjector, crash_loop_schedule
    from .fleet import Fleet, TrafficGen
    from .quant import quantize_params
    from .serve import ServeEngine
    from .supervisor import FleetSupervisor

    device = resolve_device(device)
    batch, ps = scale.batch, scale.page_size
    chunk = ps
    hi = scale.serve_chunks[1]
    prompt_len = scale.decode_prompt
    config = _config(scale, prompt_len + 1 + hi * chunk)
    params = quantize_params(_params(config, 0, device))
    n_rep = 3
    n_req = 3 * batch
    engine_kw = dict(
        slots=batch, page_size=ps, chunk=chunk,
        prompt_bucket=-(-prompt_len // ps) * ps, pipelined=True,
        device=device,
    )
    gen = TrafficGen(
        seed=11, rate_rps=100.0, min_prompt=1, max_prompt=prompt_len,
        min_new=1 + chunk, max_new=1 + hi * chunk,
        vocab=config.vocab_size,
    )
    prompts = [(p, n) for _, p, n in gen.schedule(n_req)]
    probe = ([1, 2, 3], 1 + chunk)

    def factory(slot):
        return ServeEngine(params, config, **engine_kw)

    # Cold vs warm restore: build + canary-probe a scratch engine twice
    # back to back.
    def timed_build_probe(oracle):
        t0 = time.perf_counter()
        engine = factory(None)
        # Inline canary, same contract as the supervisor's _probe.
        rid = engine.submit(probe[0], probe[1])
        tokens = None
        while tokens is None and not engine.idle:
            for req in engine.step():
                if req.rid == rid:
                    tokens = [int(t) for t in req.tokens]
        secs = time.perf_counter() - t0
        if tokens is None or (oracle is not None and tokens != oracle):
            raise RuntimeError("selfheal bench: scratch probe diverged")
        engine.close()
        return secs, tokens

    cold_s, oracle = timed_build_probe(None)
    warm_s, _ = timed_build_probe(oracle)
    _release(device)

    def closed_loop(injector=None, schedule=None, respawn=None):
        """Warm, then arm the scheduled crash relative to a known
        crossing point (the measure_fleet discipline) and serve the
        whole prompt set closed-loop under supervision.  Returns
        (streams, kept at the requeue, fleet, supervisor, finished)."""
        engines = [factory(None) for _ in range(n_rep)]
        fleet = Fleet(
            engines, chip_ids=[f"chip-{i}" for i in range(n_rep)],
            fault_injector=injector, hang_timeout_s=60.0,
        )
        for i in range(n_rep):  # warm every replica, off the clock
            fleet.submit([1 + i], 1 + chunk)
        fleet.run()
        fleet.drain_completed()
        sup = FleetSupervisor(
            fleet, factory,
            backoff=Backoff(base_s=1e-3, max_s=5e-3, jitter=0.0),
            probe=probe, probe_oracle=oracle,
            crash_loop_k=3, crash_loop_window_s=60.0,
            fault_injector=respawn,
        )
        kept = _kept_at_requeue(fleet)
        if injector is not None:
            injector.reset()
            if schedule:
                injector.arm(schedule)
        for i, (p, n) in enumerate(prompts):
            fleet.submit(p, n, session=f"sess-{i % 4}")
        streams = sup.run()
        done = fleet.drain_completed()
        statuses = {fr.status for fr in done}
        if len(done) != n_req or statuses != {"ok"}:
            raise RuntimeError(
                f"selfheal bench: {len(done)} finished with statuses "
                f"{statuses}, expected {n_req} ok"
            )
        return streams, kept, fleet, sup, done

    ref_streams, _, ref_fleet, _, _ = closed_loop()
    ref_fleet.close()
    del ref_fleet
    _release(device)

    restores: list[float] = []
    capacity: list[float] = []
    goodput: list[float] = []
    equal = 0
    for _ in range(3):
        # Crossing 2n+1 = fleet step 3, replica 0 — mid-stream with
        # every slot occupied by the up-front submissions.
        streams, kept, fleet, sup, done = closed_loop(
            FaultInjector(), schedule={"replica_crash": 2 * n_rep + 1},
        )
        equal += _hold_replay(
            streams, ref_streams, kept, config.dtype, "selfheal bench"
        )
        if fleet.replica_crashes != 1:
            raise RuntimeError(
                f"selfheal bench expected exactly one crash, saw "
                f"{fleet.replica_crashes}"
            )
        # Correctness lies hard-fail (streams/statuses above); degraded
        # robustness publishes honestly instead, as capacity < 1.0.
        healed = sup.wait_healed(timeout_s=30.0)
        alive = sum(1 for r in fleet.replicas if r.state == "active")
        capacity.append(alive / n_rep)
        goodput.append(
            sum(1 for fr in done if fr.status == "ok") / n_req
        )
        if healed:
            if len(sup.restore_s) != 1:
                raise RuntimeError(
                    f"selfheal bench expected one restore window, saw "
                    f"{len(sup.restore_s)}"
                )
            restores.extend(sup.restore_s)
        fleet.close()
        del fleet, sup
        _release(device)

    # Crash-loop: the resurrection itself dies twice on arrival (the
    # replica_respawn seam) after the initial crash — 3 failures in the
    # window trip quarantine, the slot stays out, survivors serve.
    streams, kept, fleet, sup, _ = closed_loop(
        FaultInjector(), schedule={"replica_crash": 2 * n_rep + 1},
        respawn=FaultInjector(crash_loop_schedule(2)),
    )
    sup.wait_healed(timeout_s=5.0)  # heals the healable; slot 0 cannot
    equal += _hold_replay(
        streams, ref_streams, kept, config.dtype,
        "selfheal bench (crash-loop arm)",
    )
    if sup.crash_loops != 1 or sup.states()["chip-0"] != "quarantined":
        raise RuntimeError(
            f"selfheal bench: scripted crash loop did not quarantine "
            f"(crash_loops={sup.crash_loops}, states={sup.states()})"
        )
    alive_degraded = sum(
        1 for r in fleet.replicas if r.state == "active"
    )
    if alive_degraded != n_rep - 1:
        raise RuntimeError(
            f"selfheal bench: quarantined slot rejoined anyway "
            f"({alive_degraded} of {n_rep} active)"
        )
    crash_loops = sup.crash_loops
    fleet.close()
    del fleet, sup
    _release(device)

    if not restores:
        # Zero healed repeats means there is no restore latency to
        # publish at all — that is a broken supervisor, not a number.
        raise RuntimeError(
            f"selfheal bench: no crashed repeat healed "
            f"(capacity fractions {capacity})"
        )
    rec_ms = [r * 1000 for r in restores]
    return {
        "selfheal_replicas": n_rep,
        "selfheal_requests": n_req,
        "selfheal_restore_ms": round(statistics.median(rec_ms), 2),
        "selfheal_restore_ms_min": round(min(rec_ms), 2),
        "selfheal_restore_ms_max": round(max(rec_ms), 2),
        "selfheal_capacity_recovered": round(
            statistics.median(capacity), 3
        ),
        "selfheal_goodput_retained": round(statistics.median(goodput), 3),
        "selfheal_crash_loops": crash_loops,
        "selfheal_replay_streams_equal": equal,
        "selfheal_replay_streams": 4 * n_req,
        "replica_restore_cold_ms": round(cold_s * 1000, 2),
        "replica_restore_warm_ms": round(warm_s * 1000, 2),
    }


def measure_autoscale(scale: BenchScale, device=None) -> dict:
    """Closed-loop autoscaling economics, on the measure_selfheal engine
    shape (pipelined, radix prefix cache + host offload so preemption
    can park pages, greedy so streams compare):

      1. **Step-load recovery** — a seeded TrafficGen STEP schedule
         (arrival rate x4 for a bounded window; the calm rate is
         calibrated to ~70% of this host's measured one-replica service
         rate) drives a fleet that starts at ONE replica with the
         ``FleetAutoscaler`` armed (1..N replicas, fast seeded-jitter
         cooldowns).  Every ok token stream is asserted equal to a
         FIXED-size oracle fleet of N replicas serving the same
         schedule; the robustness outcomes publish honestly:
         ``autoscale_recover_slo_ms`` (signal breach -> signal clear),
         ``autoscale_overprovision_chip_s`` (extra replica-seconds held
         while the signal was already clear) and the up/down actuation
         counts.  On one card every replica shares the card, so a
         scale-up adds slots but no device, and the overprovision counts
         each replica's seconds as a chip's.
      2. **Preemption-via-offload** — a fleet PINNED at its
         ``max_replicas`` serves one long bulk-class stream; an
         interactive burst then drives the degradation ladder to step
         2, which parks the bulk stream's prefix pages in the host tier
         and requeues it uncharged.  The parked stream must resume:
         held against an unpreempted run by ``_hold_replay`` (whole in
         float32; in bf16 the tokens kept at the park and every length;
         ``autoscale_preempt_streams_equal`` counts the whole ones),
         publishing ``autoscale_preempt_resume_ms`` (park -> first
         resumed token).  The ladder unparks the class when its signal
         clears; where the burst misses its TTFT target, as on one card
         at full width, that waits for the misses to leave the fleet's
         SLO window, and the resume window carries the wait."""
    import statistics

    from .autoscaler import FleetAutoscaler
    from .backoff import Backoff
    from .fleet import Fleet, TrafficGen, drive_open_loop
    from .serve import ServeEngine

    device = resolve_device(device)
    batch, ps = scale.batch, scale.page_size
    chunk = ps
    hi = scale.serve_chunks[1]
    prompt_len = scale.decode_prompt
    config = _config(scale, prompt_len + 1 + hi * chunk)
    params = _params(config, 0, device)
    n_max = 3
    n_req = 8 * batch
    engine_kw = dict(
        slots=batch, page_size=ps, chunk=chunk,
        prompt_bucket=-(-prompt_len // ps) * ps, pipelined=True,
        prefix_cache=True, kv_offload=True, device=device,
    )

    def factory(slot):
        return ServeEngine(params, config, **engine_kw)

    fast = Backoff(base_s=2e-3, max_s=2e-2, jitter=0.1, seed=7)

    def build_autoscaler(fleet, *, n_min, cap, **kw):
        asc = FleetAutoscaler(
            fleet, factory, min_replicas=n_min, max_replicas=cap,
            queue_wait_p99_target_s=0.25, depth_high=1.5,
            clear_fraction=0.4, window_s=1.0,
            up_backoff=fast, down_backoff=fast, down_consecutive=2,
            **kw,
        )
        asc.calibrate_probe()
        return asc

    # Calibrate the calm arrival rate to THIS host: one warm replica's
    # closed-loop service rate over a burn-in batch (requests/s), so the
    # x4 step overloads one replica on any machine.  The first pass pays
    # the graph capture and first launches and is NOT timed.
    cal = Fleet([factory(None)], hang_timeout_s=None)
    gen0 = TrafficGen(
        seed=13, rate_rps=1000.0, min_prompt=1, max_prompt=prompt_len,
        min_new=1 + chunk, max_new=1 + hi * chunk,
        vocab=config.vocab_size,
    )
    warm = [(p, nw) for _, p, nw in gen0.schedule(2 * batch)]
    for p, nw in warm:
        cal.submit(p, nw)
    cal.run()  # capture and first launches land here, off the clock
    # The fastest of several timed passes: on a CPU host shared with other
    # work, one pass slowed to a fifth of an idle pass's rate set a calm
    # rate whose x4 step never overloaded the replica.
    passes = []
    for _ in range(5):
        for p, nw in warm:
            cal.submit(p, nw)
        t0 = time.perf_counter()
        cal.run()
        passes.append(time.perf_counter() - t0)
    service_rps = len(warm) / max(min(passes), 1e-9)
    cal.close()
    del cal
    _release(device)
    calm_rps = max(1.0, 0.7 * service_rps)

    gen = TrafficGen(
        seed=13, rate_rps=calm_rps, min_prompt=1, max_prompt=prompt_len,
        min_new=1 + chunk, max_new=1 + hi * chunk,
        vocab=config.vocab_size,
    )
    calm_span = n_req / calm_rps
    profile = TrafficGen.step_profile(
        0.25 * calm_span, 0.25 * calm_span, 4.0
    )
    sched = gen.schedule(n_req, profile)
    stats = TrafficGen.schedule_stats(sched)

    def serve_fixed(n_rep: int) -> dict:
        fleet = Fleet(
            [factory(None) for _ in range(n_rep)],
            chip_ids=[f"chip-{i}" for i in range(n_rep)],
            hang_timeout_s=None,
        )
        for i in range(n_rep):  # warm every replica, off the clock
            fleet.submit([1 + i], 1 + chunk)
        fleet.run()
        fleet.drain_completed()
        streams = drive_open_loop(fleet, sched)
        done = fleet.drain_completed()
        statuses = {fr.status for fr in done}
        if len(done) != n_req or statuses != {"ok"}:
            raise RuntimeError(
                f"autoscale bench oracle: {len(done)} finished with "
                f"statuses {statuses}, expected {n_req} ok"
            )
        fleet.close()
        del fleet
        _release(device)
        return streams

    oracle = serve_fixed(n_max)

    fleet = Fleet([factory(None)], chip_ids=["chip-0"],
                  hang_timeout_s=None)
    fleet.submit([1], 1 + chunk)
    fleet.run()
    fleet.drain_completed()
    asc = build_autoscaler(fleet, n_min=1, cap=n_max)
    streams = drive_open_loop(asc, sched)
    done = fleet.drain_completed()
    statuses = {fr.status for fr in done}
    if len(done) != n_req or statuses != {"ok"}:
        raise RuntimeError(
            f"autoscale bench: {len(done)} finished with statuses "
            f"{statuses}, expected {n_req} ok"
        )
    # Positional compare: drive_open_loop fills its dict in schedule
    # order, and the two runs' rid serials differ by their warm-up
    # counts (1 vs n_max warm submissions).
    if list(streams.values()) != list(oracle.values()):
        raise RuntimeError(
            "autoscale bench: autoscaled streams diverged from the "
            "fixed-size oracle fleet — elasticity is supposed to be "
            "invisible to tokens"
        )
    scaled_back = asc.wait_quiescent(timeout_s=30.0)
    alive_end = len(fleet.alive)
    recover = list(asc.recover_s)
    overprov = asc.overprovision_chip_s
    ups, downs = asc.scale_ups, asc.scale_downs
    fleet.close()
    del fleet, asc
    _release(device)
    if ups < 1:
        raise RuntimeError(
            "autoscale bench: the x4 step never triggered a scale-up "
            f"(calm {calm_rps:.1f} rps vs service {service_rps:.1f} "
            "rps) — the spike must overload one replica"
        )
    if not recover:
        raise RuntimeError(
            "autoscale bench: the breach window never closed — there "
            "is no recovery latency to publish"
        )

    # ---- preemption-via-offload arm -------------------------------------
    # Capacity pinned (min == max == 1): the ladder is the only lever.
    long_new = 1 + hi * chunk
    bulk_prompts = [
        _prompt(77 + i, prompt_len, config.vocab_size)
        for i in range(min(2, batch))
    ]
    burst = [(p, nw) for _, p, nw in gen0.schedule(3 * batch)]

    def serve_preempt(autoscaled: bool):
        fleet = Fleet([factory(None)], chip_ids=["chip-0"],
                      hang_timeout_s=None)
        fleet.submit([1], 1 + chunk)
        fleet.run()
        fleet.drain_completed()
        kept: dict = {}
        preempt = fleet.preempt

        def recording_preempt(rid):
            pulled = preempt(rid)
            if pulled:
                kept.setdefault(rid, len(fleet._reqs[rid].tokens))
            return pulled

        fleet.preempt = recording_preempt
        asc = None
        if autoscaled:
            asc = build_autoscaler(
                fleet, n_min=1, cap=1, severe_factor=1.2,
                preempt_batch=batch,
            )
        for p in bulk_prompts:
            fleet.submit(p, long_new, slo_class="bulk")
        fleet.step()  # the bulk streams are mid-decode
        for p, nw in burst:
            fleet.submit(p, nw, slo_class="interactive")
        if asc is not None:
            # Two control polls against the live burst: rung 1
            # (brownout), then rung 2 (preempt) — the ladder fires WHILE
            # the bulk streams still hold slots, whatever this host's
            # step speed.
            asc.poll()
            asc.poll()
        driver = asc if asc is not None else fleet
        steps = 0
        while not fleet.idle:
            steps += 1
            if steps > 20000:
                raise RuntimeError(
                    "autoscale bench preempt arm failed to converge "
                    f"(ladder {getattr(asc, 'ladder_level', None)}, "
                    f"queue {fleet.queue_depth})"
                )
            driver.step()
            if not any(r.rids for r in fleet.replicas):
                # Only the parked class is queued.  The ladder unparks
                # it when its signal clears, and a burst that missed its
                # TTFT target holds the burn rate up until the misses
                # leave the SLO window (``Fleet.slo_window_s``, 60 s):
                # wait on the clock rather than spend the step budget
                # on empty steps.
                time.sleep(0.01)
        done = {fr.rid: fr for fr in fleet.drain_completed()}
        statuses = {fr.status for fr in done.values()}
        if statuses != {"ok"}:
            raise RuntimeError(
                f"autoscale bench preempt arm: statuses {statuses}, "
                "expected all ok"
            )
        out = (
            {rid: list(fr.tokens) for rid, fr in done.items()},
            fleet.preemptions,
            list(fleet.preempt_resume_s),
            kept,
        )
        fleet.close()
        del fleet, asc, driver
        _release(device)
        return out

    ref_streams, _, _, _ = serve_preempt(False)
    got_streams, preempts, resume_s, kept = serve_preempt(True)
    preempt_equal = _hold_replay(
        got_streams, ref_streams, kept, config.dtype,
        "autoscale bench preempt arm",
    )
    if preempts < 1 or not resume_s:
        raise RuntimeError(
            f"autoscale bench preempt arm: the ladder never preempted "
            f"({preempts} preemptions, {len(resume_s)} resume windows)"
        )

    rec_ms = [s * 1000 for s in recover]
    resume_ms = [s * 1000 for s in resume_s]
    return {
        "autoscale_replicas_min": 1,
        "autoscale_replicas_max": n_max,
        "autoscale_requests": n_req,
        "autoscale_spike_factor": 4.0,
        "autoscale_calm_rps": round(calm_rps, 2),
        "autoscale_service_rps": round(service_rps, 2),
        "autoscale_peak_rps": stats["peak_rps"],
        "autoscale_scale_ups": ups,
        "autoscale_scale_downs": downs,
        "autoscale_scaled_back": bool(scaled_back and alive_end == 1),
        "autoscale_recover_slo_ms": round(statistics.median(rec_ms), 2),
        "autoscale_recover_slo_ms_min": round(min(rec_ms), 2),
        "autoscale_recover_slo_ms_max": round(max(rec_ms), 2),
        "autoscale_overprovision_chip_s": round(overprov, 3),
        "autoscale_preempts": preempts,
        "autoscale_preempt_resume_ms": round(
            statistics.median(resume_ms), 2
        ),
        "autoscale_preempt_streams_equal": preempt_equal,
        "autoscale_preempt_streams": len(ref_streams),
    }


def measure_admission(scale: BenchScale, device=None) -> dict:
    """Admission throughput: serial (one batch-1 prefill dispatch + one
    first-token readback PER admitted request) vs BATCHED (one multi-row
    prefill sweep + one fused readback per step).

    Every request uses max_new_tokens=1, so each engine step is pure
    admission work (prefill + first token + retirement).  Both arms
    repeat interleaved and the speedup is the median of back-to-back
    pairs with min/max spread; dispatches-per-admitted-request comes
    from the engine's own telemetry, so the structural claim (R
    admissions -> 1 sweep, 1 readback) is reported alongside the
    wall-clock one."""
    import statistics

    from .serve import ServeEngine

    device = resolve_device(device)
    ps = scale.page_size
    prompt_len = scale.decode_prompt
    slots = max(8, scale.batch)  # R >= 4 concurrent admissions (8 here)
    waves = 4
    n_req = waves * slots
    config = _config(scale, -(-(prompt_len + 1 + ps) // ps) * ps)
    params = _params(config, 0, device)
    prompts = [
        _prompt(100 + i, prompt_len, config.vocab_size) for i in range(n_req)
    ]
    stats = {}

    def serve(batched: bool) -> float:
        engine = ServeEngine(
            params, config, slots=slots, page_size=ps,
            prompt_bucket=-(-prompt_len // ps) * ps,
            batched_admission=batched, device=device,
        )
        engine.submit(prompts[0], 1)  # warm: first launches
        engine.run()
        tokens0 = engine.prefill_tokens
        d0, r0 = engine.prefill_dispatches, engine.admission_readbacks
        t0 = time.perf_counter()
        for p in prompts:
            engine.submit(p, 1)
        engine.run()
        secs = time.perf_counter() - t0
        stats[batched] = {
            "dispatches": (engine.prefill_dispatches - d0) / n_req,
            "readbacks": (engine.admission_readbacks - r0) / n_req,
        }
        return (engine.prefill_tokens - tokens0) / secs

    serial_s, batched_s = _interleaved_repeats(
        lambda: serve(False), lambda: serve(True)
    )
    ratios = [b / max(s, 1e-9) for s, b in zip(serial_s, batched_s)]
    return {
        "admission_requests": n_req,
        "admission_slots": slots,
        "admission_prompt_tokens": prompt_len,
        "admission_tokens_per_sec_serial": round(
            statistics.median(serial_s), 1
        ),
        "admission_tokens_per_sec": round(statistics.median(batched_s), 1),
        "admission_speedup": round(statistics.median(ratios), 3),
        "admission_speedup_min": round(min(ratios), 3),
        "admission_speedup_max": round(max(ratios), 3),
        # The structural win, from engine telemetry: serial pays one
        # dispatch and one readback per admitted request; batched pays
        # ~1/slots of each.
        "admission_dispatches_per_request_serial": round(
            stats[False]["dispatches"], 3
        ),
        "admission_dispatches_per_request": round(
            stats[True]["dispatches"], 3
        ),
        "admission_readbacks_per_request_serial": round(
            stats[False]["readbacks"], 3
        ),
        "admission_readbacks_per_request": round(
            stats[True]["readbacks"], 3
        ),
    }


def measure_spec_serve(scale: BenchScale, device=None) -> dict:
    """Batched speculative serving, and what pipelining its rounds buys:
    SELF-draft (the target drafts for itself — acceptance ~100%, so the
    round count collapses to tokens/(gamma+1) and the measurement
    isolates the serving machinery rather than a particular draft's
    agreement rate), greedy, same request set with and without the round
    N+1-overlaps-round-N readback (pipelined=True), then lookahead
    supersteps against the per-round engine.  Graph capture and first
    launches are warmed by a full-depth request per arm."""
    import statistics

    from .serve import ServeEngine

    device = resolve_device(device)
    ps = scale.page_size
    gamma = 4
    prompt_len = scale.decode_prompt
    hi = scale.serve_chunks[1]
    max_new = max(hi * (gamma + 1), gamma + 2)
    config = _config(scale, prompt_len + max_new + gamma + 1)
    params = _params(config, 0, device)
    prompt = _prompt(7, prompt_len, config.vocab_size)
    n_req = 2 * scale.batch

    def serve(pipelined: bool, lookahead: int = 1) -> float:
        engine = ServeEngine(
            params, config, slots=min(4, scale.batch), page_size=ps,
            prompt_bucket=-(-prompt_len // ps) * ps,
            draft_params=params, draft_config=config, gamma=gamma,
            pipelined=pipelined, spec_lookahead=lookahead, device=device,
        )
        engine.submit(prompt, max_new)  # warm at full depth
        engine.run()
        before = engine.generated_tokens
        t0 = time.perf_counter()
        for _ in range(n_req):
            engine.submit(prompt, max_new)
        engine.run()
        return (engine.generated_tokens - before) / (
            time.perf_counter() - t0
        )

    plain_s, piped_s = _interleaved_repeats(
        lambda: serve(False), lambda: serve(True)
    )
    pair_ratios = [p / max(q, 1e-9) for q, p in zip(plain_s, piped_s)]
    # Lookahead supersteps (k rounds per dispatch) vs the per-round
    # engine: each round otherwise pays a full readback round-trip.
    lookahead = 8
    base_s, super_s = _interleaved_repeats(
        lambda: serve(False), lambda: serve(False, lookahead=lookahead)
    )
    super_ratios = [s / max(b, 1e-9) for b, s in zip(base_s, super_s)]
    return {
        "spec_serve_tokens_per_sec": round(statistics.median(plain_s), 1),
        "spec_serve_pipelined_tokens_per_sec": round(
            statistics.median(piped_s), 1
        ),
        "spec_pipelined_speedup": round(statistics.median(pair_ratios), 3),
        "spec_pipelined_speedup_min": round(min(pair_ratios), 3),
        "spec_pipelined_speedup_max": round(max(pair_ratios), 3),
        "spec_serve_lookahead": lookahead,
        "spec_serve_lookahead_tokens_per_sec": round(
            statistics.median(super_s), 1
        ),
        "spec_lookahead_speedup": round(statistics.median(super_ratios), 3),
        "spec_lookahead_speedup_min": round(min(super_ratios), 3),
        "spec_lookahead_speedup_max": round(max(super_ratios), 3),
        "spec_serve_gamma": gamma,
        "spec_serve_requests": n_req,
    }


def _spec_state(params, draft, config: ModelConfig, batch: int,
                prompt_len: int, page_size: int, device):
    """Prefilled target and draft pools with every page up to
    ``config.max_seq_len`` allocated up front (so a chain of rounds never
    needs the host): (pools, d_pools, tables, cur, pos)."""
    from .paged import PagePool, init_page_pools, paged_prefill, table_array

    cover = -(-config.max_seq_len // page_size)
    n_pages = batch * cover
    ctrl = PagePool(n_pages=n_pages, page_size=page_size)
    pools = init_page_pools(config, n_pages, page_size, device)
    d_pools = init_page_pools(config, n_pages, page_size, device)
    for b in range(batch):
        ctrl.allocate(b, config.max_seq_len)
    tables = table_array(
        [ctrl.tables[b] for b in range(batch)], cover, fill=ctrl.trash,
        device=device,
    )
    prompt = _prompts(1, batch, prompt_len, config.vocab_size, device)
    lengths = torch.full((batch,), prompt_len, dtype=torch.int32, device=device)
    logits, _ = paged_prefill(params, pools, tables, prompt, lengths, config)
    paged_prefill(draft, d_pools, tables, prompt, lengths, config)
    cur = torch.argmax(logits, dim=-1)
    pos = torch.full((batch,), prompt_len, dtype=torch.long, device=device)
    return pools, d_pools, tables, cur, pos


def measure_spec_economics(scale: BenchScale, device=None) -> dict:
    """Does speculation PAY on this card?  The draft here is REAL and
    CHEAPER: the int8-quantized model drafting for its own target
    (quantized self-speculation — the draft streams half the weight
    bytes per step, and acceptance is the measured int8/target argmax
    agreement).  Economics by the slope method over CHAINED rounds:
    paged_spec_round_chained keeps (cur, pos) on the device, so K rounds
    dispatch back-to-back with a single trailing readback.  The per-round
    readback tax is measured separately (the same rounds with a sync
    each) and reported as its own field.  The rounds run eagerly, so on
    the card each one also carries its launches from the host.

    spec_vs_plain_decode_bN > 1.0 means a batch-N greedy stream decodes
    faster through speculation than through the plain per-token path
    (``generate``, the measure_decode methodology)."""
    from .generate import generate
    from .paged import paged_spec_round_chained
    from .quant import quantize_params

    device = resolve_device(device)
    gamma = 4
    prompt_len = 32
    k_count = 12  # acceptance/readback-tax pass length (each round syncs)
    k_max = 48  # longest timed chain; the page budget must cover it
    ps = scale.page_size
    budget = prompt_len + (k_max + 1) * (gamma + 1) + gamma + 2
    config = _config(scale, -(-budget // ps) * ps)
    params = _params(config, 0, device)
    draft = quantize_params(params)
    cover = -(-config.max_seq_len // ps)

    def plain_per_token(batch: int) -> float:
        """Plain greedy decode steady-state secs/token-step at batch."""
        prompt = _prompts(1, batch, prompt_len, config.vocab_size, device)
        lo, hi = scale.decode_lens
        hi = min(hi, config.max_seq_len - prompt_len - 1)

        def run(n_new: int) -> float:
            out = generate(params, prompt, config, n_new, device=device)
            return float(out[0, -1])

        return measure_slope_secs(
            run, n_lo=min(lo, 32), n_hi=hi, min_window_secs=0.0, max_n=hi
        )

    def spec_round(pools, d_pools, tables, cur, pos, occ):
        _, n, cur, pos, _, _ = paged_spec_round_chained(
            params, draft, pools, d_pools, tables, cur, pos, occ, config,
            config, gamma, cover,
        )
        return n, cur, pos

    results = {}
    for batch in (1, 4):
        pools, d_pools, tables, cur, pos = _spec_state(
            params, draft, config, batch, prompt_len, ps, device
        )
        occ = torch.ones(batch, dtype=torch.bool, device=device)
        # Warm the first launches OUTSIDE every timed window.
        n, cur, pos = spec_round(pools, d_pools, tables, cur, pos, occ)
        n.cpu()
        # Counting + readback-tax pass: K rounds, each synced to host.
        accepted = []
        t0 = time.perf_counter()
        for _ in range(k_count):
            n, cur, pos = spec_round(pools, d_pools, tables, cur, pos, occ)
            accepted.append(n.cpu().numpy())
        synced_per_round = (time.perf_counter() - t0) / k_count
        acceptance = float(np.mean(accepted)) / gamma
        tokens_per_round = float(np.mean(accepted)) + 1.0

        def run_chain(k: int, _batch=batch) -> float:
            pools, d_pools, tables, cur, pos = _spec_state(
                params, draft, config, _batch, prompt_len, ps, device
            )
            occ = torch.ones(_batch, dtype=torch.bool, device=device)
            for _ in range(k):
                _, cur, pos = spec_round(pools, d_pools, tables, cur, pos, occ)
            return float(pos[0])  # the chain's only readback

        # Chains double (8/24 -> 16/48) until the timing window beats
        # host jitter; k_max bounds the doubling inside the page budget.
        round_secs = measure_slope_secs(
            run_chain, n_lo=8, n_hi=k_max // 2, min_window_secs=0.25,
            max_n=k_max,
        )
        plain_secs = plain_per_token(batch)
        spec_tps = batch * tokens_per_round / round_secs
        plain_tps = batch / plain_secs
        results[f"spec_vs_plain_decode_b{batch}"] = round(
            spec_tps / plain_tps, 3
        )
        if batch == 1:
            results.update({
                "spec_acceptance_rate": round(acceptance, 4),
                "spec_tokens_per_round": round(tokens_per_round, 2),
                "spec_round_ms": round(round_secs * 1000, 3),
                "spec_round_readback_ms": round(
                    max(synced_per_round - round_secs, 0.0) * 1000, 3
                ),
                "spec_plain_step_ms": round(plain_secs * 1000, 4),
            })
    results.update({
        "spec_econ_gamma": gamma,
        "spec_econ_draft": "int8-self",
    })
    return results


def measure_spec_phases(scale: BenchScale, device=None) -> dict:
    """WHY the speculative win flips sign with batch: a round's three
    phases — DRAFT (gamma+1 decode steps through the int8 self-draft),
    VERIFY (one target block forward), COMMIT (the accept bookkeeping) —
    timed in ISOLATION at each batch shape via chained calls
    (paged.paged_spec_draft_phase / paged_spec_verify_phase /
    spec_commit_phase mirror the fused round op for op), next to the
    engine's actual plain decode program (``_time_paged_chunks``) at the
    same batch.  From (tokens/round x plain_step / round) per batch the
    bench derives the measured break-even batch, the occupancy threshold
    ``ServeEngine(spec="auto")`` consumes (``spec_breakeven_batch``).
    The phase probes run eagerly while the plain program replays a CUDA
    graph on the card, so there each phase's time includes its launches
    from the host."""
    from .paged import (
        paged_spec_draft_phase,
        paged_spec_round_chained,
        paged_spec_verify_phase,
        spec_commit_phase,
    )
    from .quant import quantize_params

    device = resolve_device(device)
    gamma = 4
    prompt_len = 32
    k_count = 8  # synced acceptance-counting rounds (budget must cover)
    ps = scale.page_size
    batches = tuple(scale.spec_phase_batches)
    chunk_lo, chunk_hi = scale.serve_chunks
    budget = prompt_len + max(
        chunk_hi * ps + ps + 1, (k_count + 2) * (gamma + 1)
    )
    config = _config(scale, -(-budget // ps) * ps)
    params = _params(config, 0, device)
    draft = quantize_params(params)
    cover = -(-config.max_seq_len // ps)

    def state(batch: int):
        """Prefilled pools/tables with the full budget allocated: the
        phase chains hold positions FIXED (rewriting the same slots), so
        any chain length fits."""
        return _spec_state(params, draft, config, batch, prompt_len, ps, device)

    def plain_step_secs(batch: int) -> float:
        """Per-token seconds of the engine's ACTUAL plain decode program
        (measure_paged_decode's methodology), not the contiguous
        ``generate``: this break-even feeds ServeEngine(spec="auto")'s
        dispatch policy, so both sides of the ratio must be the programs
        the engine dispatches."""
        secs_per_chunk, _ = _time_paged_chunks(
            params, config, batch=batch, prompt_len=prompt_len,
            page_size=ps, chunk=ps, n_lo=chunk_lo, n_hi=chunk_hi,
            device=device,
        )
        return secs_per_chunk / ps

    out: dict = {
        "spec_phase_gamma": gamma,
        "spec_phase_batches": list(batches),
        "spec_phase_draft": "int8-self",
    }
    phase_ms: dict[str, dict[int, float]] = {
        "draft": {}, "verify": {}, "commit": {},
    }
    ratios: dict[int, float] = {}
    tokens_per_round = None
    for batch in batches:
        pools, d_pools, tables, cur, pos = state(batch)
        if tokens_per_round is None:
            # tokens/round from measured acceptance, counted once at the
            # smallest batch (acceptance is per-row draft/target
            # agreement — batch shape does not move it).
            occ = torch.ones(batch, dtype=torch.bool, device=device)
            accepted = []
            c, p = cur, pos
            for _ in range(k_count):
                _, n, c, p, _, _ = paged_spec_round_chained(
                    params, draft, pools, d_pools, tables, c, p, occ,
                    config, config, gamma, cover,
                )
                accepted.append(n.cpu().numpy())
            tokens_per_round = float(np.mean(accepted)) + 1.0
            # Fresh state: the counting pass advanced positions.
            pools, d_pools, tables, cur, pos = state(batch)

        boxes = {"d_pools": d_pools, "t_pools": pools, "cur": cur}

        def draft_chain(n: int) -> float:
            c = boxes["cur"]
            for _ in range(n):
                _, c, _ = paged_spec_draft_phase(
                    draft, boxes["d_pools"], tables, c, pos, config, gamma,
                    cover,
                )
            boxes["cur"] = c
            return float(c[0])

        vbox = {"block": torch.zeros((batch, gamma + 1), dtype=torch.long,
                                     device=device)}

        def verify_chain(n: int) -> float:
            b = vbox["block"]
            for _ in range(n):
                b, _ = paged_spec_verify_phase(
                    params, boxes["t_pools"], tables, b, pos, config, cover,
                )
            vbox["block"] = b
            return float(b[0, 0])

        picks0 = torch.zeros((batch, gamma + 1), dtype=torch.long, device=device)
        cbox = {"drafts": torch.zeros((batch, gamma), dtype=torch.long,
                                      device=device)}

        def commit_chain(n: int) -> float:
            d = cbox["drafts"]
            for _ in range(n):
                committed, _ = spec_commit_phase(d, picks0)
                d = committed[:, :gamma]
            cbox["drafts"] = d
            return float(d[0, 0])

        phase_ms["draft"][batch] = measure_slope_secs(
            draft_chain, n_lo=4, n_hi=12
        ) * 1000
        phase_ms["verify"][batch] = measure_slope_secs(
            verify_chain, n_lo=4, n_hi=12
        ) * 1000
        phase_ms["commit"][batch] = measure_slope_secs(
            commit_chain, n_lo=4, n_hi=12
        ) * 1000
        round_ms = sum(phase_ms[ph][batch] for ph in phase_ms)
        plain_ms = plain_step_secs(batch) * 1000
        # tokens/sec through speculation over tokens/sec plain, at this
        # batch: batch cancels, leaving tokens/round x plain/round.
        ratios[batch] = tokens_per_round * plain_ms / max(round_ms, 1e-9)
        out[f"spec_draft_ms_b{batch}"] = round(phase_ms["draft"][batch], 3)
        out[f"spec_verify_ms_b{batch}"] = round(phase_ms["verify"][batch], 3)
        out[f"spec_commit_ms_b{batch}"] = round(phase_ms["commit"][batch], 3)
        out[f"spec_phase_plain_step_ms_b{batch}"] = round(plain_ms, 4)
        out[f"spec_phase_ratio_b{batch}"] = round(ratios[batch], 3)
    out["spec_phase_tokens_per_round"] = round(tokens_per_round, 2)
    bs = list(batches)
    out["spec_breakeven_batch"] = derive_breakeven(bs, [ratios[b] for b in bs])
    # The phase that eats the win: largest absolute ms growth from the
    # smallest to the largest measured batch.
    out["spec_phase_dominant"] = max(
        phase_ms, key=lambda ph: phase_ms[ph][bs[-1]] - phase_ms[ph][bs[0]]
    )
    return out


def measure_spec_engine(scale: BenchScale, breakeven: float, device=None) -> dict:
    """ENGINE vs ENGINE: ``ServeEngine(spec="auto")`` — int8 self-draft,
    chained spec supersteps at the measured-best k from a swept candidate
    set — against the plain engine on the SAME request stream, at
    slots=1 (below break-even: auto speculates) and slots=4 (above: auto
    dispatches the plain decode program).  Greedy, pipelined on both
    sides; interleaved repeats, median-of-pairs with spread.  The
    engines' own mode telemetry rides along as proof of which program
    auto dispatched at each shape."""
    import statistics

    from .quant import quantize_params
    from .serve import ServeEngine

    device = resolve_device(device)
    gamma = 4
    ps = scale.page_size
    prompt_len = scale.decode_prompt
    ks = tuple(scale.spec_engine_ks)
    # Enough generation per request for several supersteps at the
    # deepest k (and several chunks for the plain arm).
    max_new = max(4 * (gamma + 1) * max(ks), 2 * ps)
    config = _config(scale, prompt_len + max_new + 1)
    params = _params(config, 0, device)
    draft = quantize_params(params)
    prompt = _prompt(7, prompt_len, config.vocab_size)
    bucket = -(-prompt_len // ps) * ps
    mode_steps: dict[int, tuple[int, int]] = {}

    def stream(engine, n_req: int) -> float:
        engine.submit(prompt, max_new)  # warm at full depth
        engine.run()
        before = engine.generated_tokens
        t0 = time.perf_counter()
        for _ in range(n_req):
            engine.submit(prompt, max_new)
        engine.run()
        return (engine.generated_tokens - before) / (
            time.perf_counter() - t0
        )

    def plain(slots: int) -> float:
        engine = ServeEngine(
            params, config, slots=slots, page_size=ps, chunk=ps,
            prompt_bucket=bucket, pipelined=True, device=device,
        )
        return stream(engine, 3 * slots)

    def auto(slots: int, k: int) -> float:
        engine = ServeEngine(
            params, config, slots=slots, page_size=ps, chunk=ps,
            prompt_bucket=bucket, pipelined=True, draft_params=draft,
            draft_config=config, gamma=gamma, spec="auto",
            spec_breakeven=breakeven, spec_superstep_k=k, device=device,
        )
        rate = stream(engine, 3 * slots)
        # Captured per call; the sweep keeps only the winning k's counts.
        mode_steps[slots] = (engine.spec_mode_steps, engine.plain_mode_steps)
        return rate

    # slots=1: sweep k, each candidate interleaved with its own plain runs.
    best = None
    for k in ks:
        plain_s, auto_s = _interleaved_repeats(
            lambda: plain(1), lambda: auto(1, k),
            repeats=2 if len(ks) > 1 else 3,
        )
        pairs = [a / max(p, 1e-9) for p, a in zip(plain_s, auto_s)]
        cand = {
            "k": k,
            "rate": statistics.median(auto_s),
            "plain": statistics.median(plain_s),
            "pairs": pairs,
            "mode_steps": mode_steps[1],
        }
        if best is None or cand["rate"] > best["rate"]:
            best = cand
    mode_steps[1] = best["mode_steps"]
    b4_plain_s, b4_auto_s = _interleaved_repeats(
        lambda: plain(4), lambda: auto(4, best["k"])
    )
    b4_pairs = [a / max(p, 1e-9) for p, a in zip(b4_plain_s, b4_auto_s)]
    return {
        "spec_engine_vs_plain_b1": round(statistics.median(best["pairs"]), 3),
        "spec_engine_vs_plain_b1_min": round(min(best["pairs"]), 3),
        "spec_engine_vs_plain_b1_max": round(max(best["pairs"]), 3),
        "spec_engine_vs_plain_b4": round(statistics.median(b4_pairs), 3),
        "spec_engine_vs_plain_b4_min": round(min(b4_pairs), 3),
        "spec_engine_vs_plain_b4_max": round(max(b4_pairs), 3),
        "spec_engine_tokens_per_sec_b1": round(best["rate"], 1),
        "spec_engine_plain_tokens_per_sec_b1": round(best["plain"], 1),
        "spec_engine_tokens_per_sec_b4": round(
            statistics.median(b4_auto_s), 1
        ),
        "spec_engine_plain_tokens_per_sec_b4": round(
            statistics.median(b4_plain_s), 1
        ),
        "spec_engine_best_k": best["k"],
        "spec_engine_breakeven": round(float(breakeven), 2),
        "spec_engine_gamma": gamma,
        # Auto-mode proof from the engine's own telemetry (last run per
        # shape): decode steps dispatched speculatively vs plainly.
        "spec_engine_spec_steps_b1": mode_steps.get(1, (0, 0))[0],
        "spec_engine_plain_steps_b1": mode_steps.get(1, (0, 0))[1],
        "spec_engine_spec_steps_b4": mode_steps.get(4, (0, 0))[0],
        "spec_engine_plain_steps_b4": mode_steps.get(4, (0, 0))[1],
    }


def measure_spec_superstep(scale: BenchScale, device=None) -> dict:
    """Speculative supersteps (ServeEngine(spec_superstep_k=k): k chained
    draft→verify→commit rounds per dispatch with device-side acceptance
    masks and retirement, one fused readback per k rounds): sweep k over
    the SAME greedy speculative request stream at slots 1 and 4.

    Every swept run's streams are checked BIT-IDENTICAL to the k=1 spec
    oracle at its slot shape before any number is published.  Repeats
    run round-robin across the k values so host drift hits every arm
    equally, and every TIMED arm runs bare — a separate UNTIMED
    observer-instrumented k=1 pass measures ``spec_round_readback_ms``
    (the per-spec-step host-sync stall, from the engine's own _host_sync
    accounting); run() merges this arm after measure_spec_economics, so
    this value supersedes the probe-derived one."""
    import statistics

    from .obs import EngineObserver
    from .quant import quantize_params
    from .serve import ServeEngine

    device = resolve_device(device)
    gamma = 4
    ps = scale.page_size
    prompt_len = scale.decode_prompt
    ks = [1, 2, 4]
    # Several supersteps per request at the deepest k; +3 keeps
    # retirement off the superstep boundary so the acceptance-mask
    # freeze and over-decode reconciliation are exercised.
    max_new = 2 * (gamma + 1) * max(ks) * 2 + 3
    config = _config(scale, prompt_len + max_new + 1)
    params = _params(config, 0, device)
    draft = quantize_params(params)
    prompt = _prompt(13, prompt_len, config.vocab_size)
    bucket = -(-prompt_len // ps) * ps
    overdecode: dict[tuple[int, int], tuple[int, int]] = {}

    def serve(k: int, slots: int, observer=None):
        engine = ServeEngine(
            params, config, slots=slots, page_size=ps, chunk=ps,
            prompt_bucket=bucket, draft_params=draft, draft_config=config,
            gamma=gamma, spec_superstep_k=k, observer=observer, device=device,
        )
        engine.submit(prompt, max_new)  # warm at full depth
        engine.run()
        engine.drain_completed()
        if observer is not None:
            observer.drain_steps()
        before = engine.generated_tokens
        over0 = engine.tokens_overdecoded
        n_req = 2 * slots
        t0 = time.perf_counter()
        for _ in range(n_req):
            engine.submit(prompt, max_new)
        streams = engine.run()
        rate = (engine.generated_tokens - before) / (
            time.perf_counter() - t0
        )
        overdecode[(k, slots)] = (
            engine.tokens_overdecoded - over0,
            engine.generated_tokens - before,
        )
        return rate, streams

    def check_oracle(streams, oracle, k, slots):
        if streams != oracle:
            raise RuntimeError(
                f"spec superstep k={k} slots={slots} streams diverged "
                "from the k=1 oracle — a throughput sweep over different "
                "tokens is meaningless"
            )

    rates: dict[tuple[int, int], list[float]] = {
        (k, s): [] for k in ks for s in (1, 4)
    }
    oracles: dict[int, dict] = {}
    for _ in range(3):
        for slots in (1, 4):
            for k in ks:
                rate, streams = serve(k, slots)
                if slots not in oracles:
                    oracles[slots] = streams
                else:
                    check_oracle(streams, oracles[slots], k, slots)
                rates[(k, slots)].append(rate)
    # The per-spec-step readback stall, from a SEPARATE untimed
    # instrumented k=1 pass (StepRecord.host_sync_ms over spec-mode
    # steps).
    obs = EngineObserver()
    _, streams = serve(1, 4, observer=obs)
    check_oracle(streams, oracles[4], 1, 4)
    spec_syncs = [
        r.host_sync_ms for r in obs.drain_steps()
        if r.mode == "spec" and not r.admitted
    ]
    med = {key: statistics.median(v) for key, v in rates.items()}
    best_k = max(ks, key=lambda k: med[(k, 4)])
    over, emitted = overdecode[(best_k, 4)]
    out = {
        "spec_superstep_ks": ks,
        "spec_superstep_gamma": gamma,
        "spec_superstep_best_k": best_k,
        "spec_superstep_tokens_per_sec": round(med[(best_k, 4)], 1),
        "spec_superstep_speedup": round(
            med[(best_k, 4)] / med[(1, 4)], 3
        ),
        "spec_superstep_overdecode_pct": round(
            100.0 * over / max(over + emitted, 1), 2
        ),
        # Best-k per-repeat samples: run() pools them with the prior
        # artifact's via _publish_ratio_spread.
        "spec_superstep_tokens_per_sec_samples": [
            round(s, 1) for s in rates[(best_k, 4)]
        ],
    }
    for k in ks:
        out[f"spec_superstep_tokens_per_sec_k{k}"] = round(med[(k, 4)], 1)
        out[f"spec_superstep_b1_tokens_per_sec_k{k}"] = round(med[(k, 1)], 1)
    if spec_syncs:
        out["spec_round_readback_ms"] = round(
            statistics.median(spec_syncs), 3
        )
    return out


def measure_multi_lora(scale: BenchScale, device=None) -> dict:
    """Multi-tenant LoRA serving overhead: the serve loop with requests
    round-robining across 4 rank-16 adapters (per-row activation deltas,
    one shared base weight stream) against the same loop serving the
    base only — the cost of multi-tenancy, measured."""
    import statistics

    from .multi_lora import synthetic_adapters
    from .serve import ServeEngine

    device = resolve_device(device)
    ps = scale.page_size
    chunk, hi = ps, scale.serve_chunks[1]
    prompt_len = scale.decode_prompt
    config = _config(scale, prompt_len + 1 + hi * chunk)
    params = _params(config, 0, device)
    n_adapters, rank = 4, 16
    adapters = synthetic_adapters(config, n_adapters, rank=rank, seed=11,
                                  device=device)
    prompt = _prompt(1, prompt_len, config.vocab_size)
    names = [None] + sorted(adapters)

    def serve(multi: bool) -> float:
        engine = ServeEngine(
            params, config, slots=scale.batch, page_size=ps, chunk=chunk,
            prompt_bucket=-(-prompt_len // ps) * ps,
            adapters=adapters if multi else None, device=device,
        )
        engine.submit(
            prompt, 1 + hi * chunk, adapter=names[1] if multi else None
        )
        engine.run()  # warm
        before = engine.generated_tokens
        t0 = time.perf_counter()
        for i in range(scale.batch):
            engine.submit(
                prompt, 1 + hi * chunk,
                adapter=names[i % len(names)] if multi else None,
            )
        engine.run()
        return (engine.generated_tokens - before) / (
            time.perf_counter() - t0
        )

    base_s, multi_s = _interleaved_repeats(
        lambda: serve(False), lambda: serve(True)
    )
    pair_ratios = [m / max(b, 1e-9) for b, m in zip(base_s, multi_s)]
    return {
        "multi_lora_adapters": n_adapters,
        "multi_lora_rank": rank,
        "multi_lora_tokens_per_sec": round(statistics.median(multi_s), 1),
        "multi_lora_base_tokens_per_sec": round(statistics.median(base_s), 1),
        "multi_lora_relative_throughput": round(
            statistics.median(pair_ratios), 3
        ),
        "multi_lora_relative_throughput_min": round(min(pair_ratios), 3),
        "multi_lora_relative_throughput_max": round(max(pair_ratios), 3),
    }


def measure_prefix_serve(scale: BenchScale, device=None) -> dict:
    """Cross-request prefix caching, measured IN the phase it deletes: a
    stream of requests sharing a long system prompt (8 pages — 512
    tokens at the full scale's page size) with distinct short suffixes
    and max_new_tokens=1, so the measured window is the prefill phase
    itself plus one sampled token.  Both arms repeat interleaved and the
    published speedup is the median of back-to-back pairs with its
    min/max spread."""
    import statistics

    from .serve import ServeEngine

    device = resolve_device(device)
    ps = scale.page_size
    prefix_len = 8 * ps
    suffix_len, n_req = 8, 2 * scale.batch
    chunk = ps
    config = _config(scale, prefix_len + suffix_len + 2 * chunk)
    params = _params(config, 0, device)
    prefix = _prompt(5, prefix_len, config.vocab_size)
    tokens_forwarded = {}

    def serve(cached: bool) -> float:
        engine = ServeEngine(
            params, config, slots=min(4, n_req), page_size=ps, chunk=chunk,
            prompt_bucket=2 * ps, prefix_cache=cached, device=device,
        )
        engine.submit(prefix + [1] * suffix_len, 1)  # warm + seed
        engine.run()
        before = engine.prefill_tokens
        t0 = time.perf_counter()
        for i in range(n_req):
            engine.submit(prefix + [2 + i] * suffix_len, 1)
        engine.run()
        secs = time.perf_counter() - t0
        tokens_forwarded[cached] = engine.prefill_tokens - before
        return secs

    un_s, ca_s = _interleaved_repeats(
        lambda: serve(False), lambda: serve(True)
    )
    ratios = [u / max(c, 1e-9) for u, c in zip(un_s, ca_s)]
    return {
        "prefix_serve_requests": n_req,
        "prefix_serve_prefix_tokens": prefix_len,
        "prefix_serve_uncached_secs": round(statistics.median(un_s), 4),
        "prefix_serve_cached_secs": round(statistics.median(ca_s), 4),
        "prefix_serve_speedup": round(statistics.median(ratios), 3),
        "prefix_serve_speedup_min": round(min(ratios), 3),
        "prefix_serve_speedup_max": round(max(ratios), 3),
        # 1 - computed/uncomputed prompt tokens: the compute the cache
        # deleted (the suffix + bucket-alignment remainder still runs).
        "prefix_prefill_tokens_saved_fraction": round(
            1.0 - tokens_forwarded[True] / max(tokens_forwarded[False], 1), 4
        ),
    }


def measure_kv_hierarchy(scale: BenchScale, device=None) -> dict:
    """The KV-cache hierarchy, measured on the traffic it exists for: a
    MULTI-TURN trace — conversations sharing a few-shot system template,
    every turn's prompt = the whole history — on a pool too small to
    keep every conversation resident.  Two questions, answered by
    distinct engines:

      * **radix vs flat under pressure** (same tight pool, NO offload,
        interleaved repeats): the flat chain index evicts LRU-first,
        which orphans chains behind a dropped middle block, while the
        radix tree evicts leaf-first — published as the hit-page counts
        of each arm and the wall-clock ratio ``kv_multiturn_speedup``.
      * **the offload tier under oversubscription** (same trace, same
        tight pool, ``kv_offload=True``): cold pages park in host RAM
        and reload on hit; every greedy stream is checked bit-identical
        to a roomy-pool engine's, and the published costs are the
        per-page ``kv_offload_reload_ms`` / spill ms plus
        ``kv_resident_pages_saved``."""
    import statistics

    from .serve import ServeEngine

    device = resolve_device(device)
    ps = scale.page_size
    prefix_len = 4 * ps  # the shared system/few-shot template
    tail, turns, new = ps, 3, 1  # max_new=1: the window IS prefill
    n_conv = max(3, scale.batch // 2)
    longest = prefix_len + turns * (tail + new)
    chunk = ps
    config = _config(scale, longest + 2 * chunk)
    params = _params(config, 0, device)
    system = _prompt(5, prefix_len, config.vocab_size)

    def serve(cache, n_pages=None, kv_offload=False):
        """Run the full multi-turn trace; returns (engine, streams,
        secs, peak_offloaded).  Turn tails derive from (conversation,
        turn), so every arm serves byte-identical traffic."""
        engine = ServeEngine(
            params, config, slots=min(2, n_conv), page_size=ps,
            chunk=chunk, prompt_bucket=2 * ps, n_pages=n_pages,
            prefix_cache=cache, kv_offload=kv_offload, device=device,
        )
        engine.submit(system + [1] * tail, new)  # warm, uncounted
        engine.run()
        history = [system + [100 + ci] * tail for ci in range(n_conv)]
        outs, peak_offloaded = [], 0
        t0 = time.perf_counter()
        for turn in range(turns):
            for ci in range(n_conv):
                rid = engine.submit(history[ci], new)
                toks = engine.run()[rid]
                outs.append(list(toks))
                history[ci] = (
                    history[ci] + list(toks)
                    + [200 + ci * turns + turn] * tail
                )
                if kv_offload:
                    peak_offloaded = max(
                        peak_offloaded, engine.prefix.offloaded_pages
                    )
        secs = time.perf_counter() - t0
        return engine, outs, secs, peak_offloaded

    # A pool that holds ONE conversation's worst case but nowhere near
    # every conversation's cached history — the pressure regime.
    probe = ServeEngine(
        params, config, slots=2, page_size=ps, chunk=chunk,
        prompt_bucket=2 * ps, device=device,
    )
    tight = probe._worst_case_pages(longest, new) + 2
    probe.close()
    live_pages = n_conv * (longest // ps)

    oracle_e, oracle, _, _ = serve(False)  # roomy, uncached: the oracle
    oracle_e.close()

    def check(outs, label):
        if outs != oracle:
            raise RuntimeError(f"{label} streams diverged from the oracle")

    flat_hits = radix_hits = 0
    reload_ms_samples, spill_ms_samples = [], []
    saved = 0
    reloads = spills = 0

    def flat_arm():
        nonlocal flat_hits
        e, outs, secs, _ = serve("flat", n_pages=tight)
        check(outs, "flat-cache")
        flat_hits = max(flat_hits, e.prefix.hits)
        e.close()
        return secs

    def radix_arm():
        # PURE radix — no offload, so the headline speedup and the
        # hit-page comparison credit the tree's structure alone.
        nonlocal radix_hits
        e, outs, secs, _ = serve(True, n_pages=tight)
        check(outs, "radix-cache")
        radix_hits = max(radix_hits, e.prefix.hits)
        e.close()
        return secs

    flat_s, radix_s = _interleaved_repeats(flat_arm, radix_arm)
    ratios = [f / max(r, 1e-9) for f, r in zip(flat_s, radix_s)]

    # The offload tier, measured on its own engines (same trace, same
    # tight pool): parity checked per repeat, per-page costs pooled.
    for _ in range(3):
        e, outs, _, peak = serve(True, n_pages=tight, kv_offload=True)
        check(outs, "offload")
        saved = max(saved, peak)
        reloads, spills = e.prefix.reloads, e.prefix.spills
        if e.prefix.reloads:
            reload_ms_samples.append(
                round(e.kv_reload_s / e.prefix.reloads * 1000, 3)
            )
        if e.prefix.spills:
            spill_ms_samples.append(
                round(e.kv_spill_s / e.prefix.spills * 1000, 3)
            )
        e.close()
    out = {
        "kv_multiturn_conversations": n_conv,
        "kv_multiturn_turns": turns,
        "kv_prefix_tokens": prefix_len,
        "kv_oversub_pool_pages": tight,
        "kv_oversub_live_pages": live_pages,
        "kv_flat_hit_pages": flat_hits,
        "kv_radix_hit_pages": radix_hits,
        "kv_radix_vs_flat_hit_ratio": round(
            radix_hits / max(flat_hits, 1), 3
        ),
        "kv_multiturn_speedup": round(statistics.median(ratios), 3),
        "kv_multiturn_speedup_min": round(min(ratios), 3),
        "kv_multiturn_speedup_max": round(max(ratios), 3),
        "kv_offload_spills": spills,
        "kv_offload_reloads": reloads,
        "kv_resident_pages_saved": saved,
    }
    if reload_ms_samples:
        out["kv_offload_reload_ms"] = round(
            statistics.median(reload_ms_samples), 3
        )
        out["kv_offload_reload_ms_samples"] = reload_ms_samples
    if spill_ms_samples:
        out["kv_offload_spill_ms"] = round(
            statistics.median(spill_ms_samples), 3
        )
    return out


def _publish_ratio_spread(
    out: dict, key: str, samples: list[float], prior: dict | None
) -> None:
    """Persist a headline ratio's per-repeat samples and publish its
    min–max POOLED with the previous artifact's persisted samples — a
    separate process, so the range bounds cross-run drift.  When no
    prior samples exist the range is annotated as within-run."""
    samples = [round(float(s), 3) for s in samples]
    out[f"{key}_samples"] = samples
    prev = [
        s for s in ((prior or {}).get(f"{key}_samples") or [])
        if isinstance(s, (int, float))
    ]
    pooled = samples + prev
    if not pooled:
        return
    out[f"{key}_min"] = round(min(pooled), 3)
    out[f"{key}_max"] = round(max(pooled), 3)
    out[f"{key}_spread_scope"] = (
        "pooled-cross-run" if prev else "within-run"
    )


def measure_kv_sched(scale: BenchScale, device=None) -> dict:
    """KV pages as the schedulable unit: the SAME seeded oversubscribed
    multi-tenant stream — tenants sharing system prefixes, demand far
    beyond the fleet's decode slots, page pools tight enough that cold
    radix pages spill to the host tier — dispatched PAGE-scheduled
    (``Fleet(page_scheduling=True)``: free pages + radix match depth +
    ledger goodput rank the replicas, admission capped by aggregate free
    pages) vs REPLICA-scheduled (the request-count router), as
    interleaved repeats.  Every pair's greedy streams are asserted equal
    (the schedule moves placement and interleaving, never a token):

      * ``kvsched_vs_replica_tokens_per_sec`` — the headline ratio
        (page-scheduled / replica-scheduled), median with min/max.
      * ``kvsched_busy_fraction`` / ``kvsched_goodput_fraction`` — the
        page arm's fleet-ledger verdict.  Its busy time is
        ``StepRecord.device_ms``, JAX's derivation (a step's wall less
        its host syncs), which reads a chunk on the card as less busy
        than the profiler's kernels do.
      * ``kvsched_page_waste_pct`` — mean fraction of the fleet's pages
        sitting FREE per step while work was pending, under page
        scheduling.
    """
    import statistics

    from .fleet import Fleet
    from .ledger import ChipTimeLedger, FleetLedger
    from .serve import ServeEngine

    device = resolve_device(device)
    batch, ps = scale.batch, scale.page_size
    chunk = ps
    hi = scale.serve_chunks[1]
    prefix_len = 2 * ps  # each tenant's shared system template
    tail_max = ps
    max_new = 1 + hi * chunk
    longest = prefix_len + tail_max + max_new
    config = _config(scale, longest + chunk)
    params = _params(config, 0, device)
    n_rep = 2
    n_tenants = 3
    n_req = 6 * batch  # far beyond n_rep * batch slots: oversubscribed
    vocab = config.vocab_size
    tenant_prefix = [_prompt((11, tid), prefix_len, vocab) for tid in range(n_tenants)]
    reqs = []
    for i in range(n_req):
        tid = i % n_tenants
        tail = _prompt((11, 100 + i), 1 + i % tail_max, vocab)
        new = 1 + chunk + (i * chunk) % (max_new - chunk)
        reqs.append((tid, tenant_prefix[tid] + tail, new))
    # Tight pools: just enough pages to keep the decode slots fed, so
    # tenant templates cached by the radix index MUST spill to the host
    # tier under the oversubscribed stream.
    pages_req = -(-longest // ps)
    n_pages = pages_req * batch
    host_pages = 8 * pages_req

    def build_fleet(page_sched: bool):
        engines = [
            ServeEngine(
                params, config, slots=batch, page_size=ps, chunk=chunk,
                prompt_bucket=ps, pipelined=True, n_pages=n_pages,
                prefix_cache=True, kv_offload=True,
                kv_host_pages=host_pages, ledger=ChipTimeLedger(),
                device=device,
            )
            for _ in range(n_rep)
        ]
        fleet = Fleet(
            engines, chip_ids=[f"chip-{i}" for i in range(n_rep)],
            hang_timeout_s=60.0, ledger=FleetLedger(),
            page_scheduling=page_sched,
        )
        for i in range(n_rep):  # warm each replica's capture off-clock
            fleet.submit([1 + i], 1 + chunk)
        fleet.run()
        fleet.drain_completed()
        return fleet

    streams_by_arm: dict[bool, list] = {False: [], True: []}
    waste_by_arm: dict[bool, list] = {False: [], True: []}
    ledger_snaps: list[dict] = []
    spills = 0
    page_dispatches = 0

    def run_arm(page_sched: bool) -> float:
        nonlocal spills, page_dispatches
        fleet = build_fleet(page_sched)
        rids = [
            fleet.submit(p, n, session=f"tenant-{tid}")
            for tid, p, n in reqs
        ]
        tokens0 = fleet.generated_tokens
        waste_samples: list[float] = []
        t0 = time.perf_counter()
        while True:
            with fleet._lock:
                if fleet.idle:
                    break
                fleet.step()
                if fleet.queue or any(r.rids for r in fleet.replicas):
                    free = sum(
                        r.free_pages() or 0 for r in fleet.replicas
                    )
                    total = sum(
                        r.total_pages() or 0 for r in fleet.replicas
                    )
                    if total:
                        waste_samples.append(free / total)
        secs = time.perf_counter() - t0
        rate = (fleet.generated_tokens - tokens0) / secs
        done = {fr.rid: fr for fr in fleet.drain_completed()}
        statuses = {fr.status for fr in done.values()}
        if len(done) != n_req or statuses != {"ok"}:
            raise RuntimeError(
                f"kvsched bench: {len(done)} of {n_req} finished with "
                f"statuses {statuses}, expected all ok"
            )
        streams_by_arm[page_sched].append(
            [list(done[rid].tokens) for rid in rids]
        )
        waste_by_arm[page_sched].append(
            statistics.mean(waste_samples) if waste_samples else 0.0
        )
        if page_sched:
            ledger_snaps.append(fleet.ledger.snapshot())
            page_dispatches += fleet.page_dispatches
            spills += sum(
                int(getattr(r.engine.prefix, "spills", 0) or 0)
                for r in fleet.replicas
            )
        fleet.close()
        del fleet
        _release(device)
        return rate

    # Throwaway pass: the measured stream's shapes take their first
    # launches, so the first interleaved pair prices scheduling.
    run_arm(False)
    streams_by_arm[False].clear()
    waste_by_arm[False].clear()
    paged_rates, plain_rates = _interleaved_repeats(
        lambda: run_arm(True), lambda: run_arm(False)
    )
    for paged_streams, plain_streams in zip(
        streams_by_arm[True], streams_by_arm[False]
    ):
        if paged_streams != plain_streams:
            raise RuntimeError(
                "kvsched bench: page-scheduled streams diverged from "
                "replica-scheduled — scheduling is supposed to move "
                "placement, never a token"
            )
    ratios = [p / r for p, r in zip(paged_rates, plain_rates)]
    return {
        "kvsched_replicas": n_rep,
        "kvsched_requests": n_req,
        "kvsched_tokens_per_sec": round(
            statistics.median(paged_rates), 1
        ),
        "kvsched_replica_sched_tokens_per_sec": round(
            statistics.median(plain_rates), 1
        ),
        "kvsched_vs_replica_tokens_per_sec": round(
            statistics.median(ratios), 3
        ),
        "kvsched_vs_replica_tokens_per_sec_min": round(min(ratios), 3),
        "kvsched_vs_replica_tokens_per_sec_max": round(max(ratios), 3),
        "kvsched_busy_fraction": round(statistics.median(
            [s["busy_fraction"] for s in ledger_snaps]
        ), 3),
        "kvsched_goodput_fraction": round(statistics.median(
            [s["goodput_fraction"] for s in ledger_snaps]
        ), 3),
        "kvsched_page_waste_pct": round(
            statistics.median(waste_by_arm[True]) * 100.0, 2
        ),
        "kvsched_replica_sched_page_waste_pct": round(
            statistics.median(waste_by_arm[False]) * 100.0, 2
        ),
        "kvsched_page_dispatches": page_dispatches,
        "kvsched_offload_spills": spills,
    }


def measure_goodput_ctrl(scale: BenchScale, device=None) -> dict:
    """Goodput-optimal control plane: the SAME seeded oversubscribed
    mixed-class stream run CONTROLLED (``GoodputController`` polling the
    fleet ledger between steps, retuning speculation as measured waste
    burn demands and re-weighting WFQ from per-class economics) vs
    STATIC (the same fleet, knobs frozen at their construction values),
    as interleaved repeats.  The fleet is built mis-calibrated on
    purpose: auto-spec engines whose draft is an independent full-width
    model (seed 99; acceptance ~ chance) and whose ``spec_breakeven``
    starts at the slot count, so every dispatch speculates and the
    ledger charges heavy ``spec_rejected`` waste.  The controller's
    hill-climb walks ``spec_breakeven`` down until the engines stop
    paying for speculation; the static arm burns the waste forever.

    Every pair's greedy streams are compared by ``_hold_near_ties``: in
    float32 they must be equal (greedy speculative decoding is exact,
    and a retune drains in-flight state before a knob moves).  The
    controlled arm stops speculating part of the way through while the
    static arm verifies every token in a block, so in bf16 a stream may
    part only at a near-tie of the target's top two logits, and keeps
    its length and ``ok``; ``ctrl_streams_equal`` counts the whole ones
    and ``ctrl_parting_gap_max`` / ``ctrl_parting_limit_min`` bound the
    partings.

      * ``ctrl_vs_static_tokens_per_sec`` — the headline ratio
        (controlled / static delivered-token rate), median with
        cross-run pooled min/max.
      * ``ctrl_goodput_fraction`` vs ``ctrl_static_goodput_fraction``
        — the fleet ledger's verdict on each arm (from
        ``StepRecord.device_ms``, JAX's derivation).
      * ``ctrl_retunes_applied`` — knob moves the hill-climb landed
        (median per controlled run).
      * ``ctrl_overhead_pct`` — the poll tax: a DEAD-BANDED controller
        (thresholds it can never cross) runs the tripled stream with
        its streams asserted equal to the bare fleet's, and the number
        is its metered poll seconds as a share of the run's wall clock.
    """
    import statistics

    from .backoff import Backoff
    from .control import GoodputController
    from .fleet import Fleet
    from .ledger import ChipTimeLedger, FleetLedger
    from .serve import ServeEngine

    device = resolve_device(device)
    batch, ps = scale.batch, scale.page_size
    chunk = ps
    gamma = 4
    max_new_hi = 1 + 3 * chunk
    prompt_max = 2 * ps
    longest = prompt_max + max_new_hi + (gamma + 1) * 2
    config = _config(scale, longest + 2 * chunk)
    params = _params(config, 0, device)
    # The mis-calibration: a draft that never trained with the target
    # (independent init) drafts tokens the verifier rejects at ~chance.
    bad_draft = _params(config, 99, device)
    n_rep = 2
    n_req = 4 * batch  # beyond n_rep * batch slots: oversubscribed
    reqs = []
    for i in range(n_req):
        plen = 1 + ps + (i * 7) % prompt_max
        prompt = _prompt((23, i), min(plen, prompt_max), config.vocab_size)
        new = 1 + chunk + (i % 3) * chunk
        cls = "interactive" if i % 3 else "bulk"
        reqs.append((prompt, new, cls))
    pages_req = -(-(longest + 2 * chunk) // ps)
    n_pages = pages_req * batch

    def build_fleet():
        engines = [
            ServeEngine(
                params, config, slots=batch, page_size=ps, chunk=chunk,
                prompt_bucket=ps, n_pages=n_pages,
                draft_params=bad_draft, draft_config=config,
                gamma=gamma, spec="auto",
                spec_breakeven=float(batch),  # always speculate
                ledger=ChipTimeLedger(), device=device,
            )
            for _ in range(n_rep)
        ]
        fleet = Fleet(
            engines, chip_ids=[f"chip-{i}" for i in range(n_rep)],
            hang_timeout_s=60.0, ledger=FleetLedger(),
            wfq_weights={"interactive": 2.0, "bulk": 1.0},
        )
        for i in range(n_rep):  # warm each replica's captures off-clock
            fleet.submit([1 + i], 1 + chunk)
        fleet.run()
        fleet.drain_completed()
        return fleet

    def build_controller(fleet, inert: bool) -> GoodputController:
        fast = Backoff(base_s=1e-6, max_s=1e-6, jitter=0.0)
        if inert:
            # Dead-banded: thresholds no measured signal can cross, and
            # a WFQ dead band no re-weight can clear — every poll reads
            # the ledger and holds, at the default backoff cadences.
            return GoodputController(
                fleet, min_sample_tokens=16,
                spec_reject_low=0.0, spec_reject_high=0.999,
                overdecode_low=0.0, overdecode_high=0.999,
                wfq_deadband=1e9,
            )
        return GoodputController(
            fleet, min_sample_tokens=16,
            spec_reject_low=0.01, spec_reject_high=0.2,
            retune_backoff=fast, wfq_backoff=fast,
        )

    streams_by_mode: dict[str, list] = {}
    goodput_by_mode: dict[str, list] = {}
    retunes: list[int] = []
    overhead_fracs: list[float] = []
    wfq_reweights = 0

    def run_arm(mode: str) -> float:
        nonlocal wfq_reweights
        fleet = build_fleet()
        ctrl = (
            None if mode in ("static", "bare")
            else build_controller(fleet, inert=(mode == "inert"))
        )
        # The overhead pair ("inert" vs "bare") runs the stream three
        # times over: the poll tax it prices sits near the noise floor.
        arm_reqs = reqs * (3 if mode in ("inert", "bare") else 1)
        rids = [
            fleet.submit(p, n, slo_class=cls) for p, n, cls in arm_reqs
        ]
        tokens0 = fleet.generated_tokens
        t0 = time.perf_counter()
        if ctrl is None:
            fleet.run()
        else:
            ctrl.run()
        secs = time.perf_counter() - t0
        rate = (fleet.generated_tokens - tokens0) / secs
        done = {fr.rid: fr for fr in fleet.drain_completed()}
        statuses = {fr.status for fr in done.values()}
        if len(done) != len(arm_reqs) or statuses != {"ok"}:
            raise RuntimeError(
                f"goodput_ctrl bench: {len(done)} of {len(arm_reqs)} "
                f"finished with statuses {statuses}, expected all ok"
            )
        streams_by_mode.setdefault(mode, []).append(
            [list(done[rid].tokens) for rid in rids]
        )
        goodput_by_mode.setdefault(mode, []).append(
            fleet.ledger.snapshot()["goodput_fraction"]
        )
        if mode == "controlled":
            if ctrl.retunes_applied == 0:
                raise RuntimeError(
                    "goodput_ctrl bench: the controlled arm applied no "
                    "retunes — the mis-calibrated spec stream is "
                    "supposed to trip the spec_rejected threshold"
                )
            retunes.append(ctrl.retunes_applied)
            wfq_reweights += ctrl.wfq_reweights
        if mode == "inert":
            if ctrl.retunes_applied:
                raise RuntimeError(
                    "goodput_ctrl bench: the dead-banded controller "
                    "actuated — the overhead arm must price polling "
                    "only"
                )
            # Polls are strictly additive to fleet.step(), so their
            # metered share of the run's wall clock IS the tax.
            overhead_fracs.append(ctrl.poll_s / secs * 100.0)
        fleet.close()
        del fleet, ctrl
        _release(device)
        return rate

    # Throwaway passes: one run per arm shape takes the first launches
    # of every path each arm dispatches (the static arm speculates all
    # run; the controlled arm also reaches the plain chunks), so the
    # first interleaved pair prices control.
    run_arm("controlled")
    run_arm("static")
    for mode in ("controlled", "static"):
        streams_by_mode[mode].clear()
        goodput_by_mode[mode].clear()
    retunes.clear()
    wfq_reweights = 0
    ctrl_rates, static_rates = _interleaved_repeats(
        lambda: run_arm("controlled"), lambda: run_arm("static")
    )
    equal, partings = 0, []
    prompts = dict(enumerate(p for p, _, _ in reqs))
    for ctrl_streams, static_streams in zip(
        streams_by_mode["controlled"], streams_by_mode["static"]
    ):
        whole, parted = _hold_near_ties(
            params, config, dict(enumerate(ctrl_streams)),
            dict(enumerate(static_streams)), prompts,
            "goodput_ctrl bench: controlled against static",
        )
        equal += whole
        partings += parted
    # Overhead pair: dead-banded controller vs bare fleet on the tripled
    # stream, streams asserted equal; the tax itself comes from the
    # controller's own poll_s meter (see run_arm).
    _interleaved_repeats(
        lambda: run_arm("inert"), lambda: run_arm("bare"), repeats=2,
    )
    for inert_streams, bare_streams in zip(
        streams_by_mode["inert"], streams_by_mode["bare"]
    ):
        if inert_streams != bare_streams:
            raise RuntimeError(
                "goodput_ctrl bench: controller-off streams diverged "
                "from the no-controller oracle"
            )
    ratios = [c / s for c, s in zip(ctrl_rates, static_rates)]
    return {
        "ctrl_replicas": n_rep,
        "ctrl_requests": n_req,
        "ctrl_tokens_per_sec": round(statistics.median(ctrl_rates), 1),
        "ctrl_static_tokens_per_sec": round(
            statistics.median(static_rates), 1
        ),
        "ctrl_vs_static_tokens_per_sec": round(
            statistics.median(ratios), 3
        ),
        "ctrl_vs_static_tokens_per_sec_samples": [
            round(r, 3) for r in ratios
        ],
        "ctrl_goodput_fraction": round(
            statistics.median(goodput_by_mode["controlled"]), 3
        ),
        "ctrl_static_goodput_fraction": round(
            statistics.median(goodput_by_mode["static"]), 3
        ),
        "ctrl_retunes_applied": int(statistics.median(retunes)),
        "ctrl_wfq_reweights": wfq_reweights,
        "ctrl_overhead_pct": round(statistics.median(overhead_fracs), 2),
        "ctrl_overhead_pct_min": round(min(overhead_fracs), 2),
        "ctrl_overhead_pct_max": round(max(overhead_fracs), 2),
        "ctrl_overhead_pct_samples": [
            round(o, 2) for o in overhead_fracs
        ],
        "ctrl_streams_equal": equal,
        "ctrl_streams": len(ctrl_rates) * n_req,
        **_parting_keys("ctrl", partings),
    }


def measure_durability(scale: BenchScale, device=None) -> dict:
    """Durable sessions: the SAME seeded greedy stream run two ways as
    interleaved repeats — an ORACLE arm on the plain engine (no disk
    tier, no journal) and a DURABLE arm (``kv_disk_dir`` +
    ``Fleet(journal_dir=...)``) that is KILLED mid-stream via
    ``close()`` after three steps and rebuilt in a fresh fleet from
    nothing but the journal and the per-page disk files.

    Every repeat holds the restored streams against the uninterrupted
    oracle by ``_hold_replay`` (whole in float32; in bf16 the journaled
    tokens and every length; ``durable_replay_streams_equal`` counts the
    whole ones) and asserts the kill landed mid-stream (>= 1 session had
    emitted tokens but not finished):

      * ``durable_restore_ms`` — wall time for ``Fleet.restore()`` to
        resurrect every journaled session into a cold fleet (median
        with min/max; the crash-recovery RTO).
      * ``kv_disk_reload_ms`` — per-page disk -> card reload latency
        (checksum verify + the copy up) during the restored run; the
        copy is from pageable memory.
      * ``durable_sessions_per_hbm_page`` — journaled sessions carried
        per pool page: the fan-out the disk tier buys over device
        memory alone.
      * ``durable_off_tokens_per_sec`` — the oracle arm's rate.
    """
    import os
    import shutil
    import statistics
    import tempfile

    from .fleet import Fleet
    from .serve import ServeEngine

    device = resolve_device(device)
    batch, ps = scale.batch, scale.page_size
    chunk = ps
    hi = scale.serve_chunks[1]
    prefix_len = 2 * ps  # shared system template: the disk tier dedups it
    tail_max = ps
    max_new = 1 + hi * chunk
    longest = prefix_len + tail_max + max_new
    config = _config(scale, longest + chunk)
    params = _params(config, 0, device)
    n_rep = 2
    n_req = 2 * batch
    sys_prefix = _prompt((23, 0), prefix_len, config.vocab_size)
    reqs = []
    for i in range(n_req):
        tail = _prompt((23, 100 + i), 1 + i % tail_max, config.vocab_size)
        # Budgets long enough that a 3-step kill is mid-stream for most.
        new = max_new - (i * chunk) % (2 * chunk)
        reqs.append((sys_prefix + tail, new))
    pages_req = -(-longest // ps)
    n_pages = pages_req * batch
    host_pages = 4 * pages_req
    fleet_hbm_pages = n_rep * n_pages

    def build_fleet(root: str | None, warm: bool):
        durable = root is not None
        engines = [
            ServeEngine(
                params, config, slots=batch, page_size=ps, chunk=chunk,
                prompt_bucket=ps, pipelined=True, n_pages=n_pages,
                prefix_cache=True,
                kv_offload=durable,
                kv_host_pages=host_pages if durable else None,
                kv_disk_dir=os.path.join(root, "kv") if durable else None,
                device=device,
            )
            for _ in range(n_rep)
        ]
        fleet = Fleet(
            engines, chip_ids=[f"chip-{i}" for i in range(n_rep)],
            hang_timeout_s=60.0,
            journal_dir=os.path.join(root, "journal") if durable else None,
        )
        if warm:  # the captures and first launches, off-clock
            for i in range(n_rep):
                fleet.submit([1 + i], 1 + chunk)
            fleet.run()
            fleet.drain_completed()
        return fleet

    def run_oracle() -> tuple[float, list[list[int]]]:
        fleet = build_fleet(None, warm=True)
        rids = [fleet.submit(p, n) for p, n in reqs]
        tokens0 = fleet.generated_tokens
        t0 = time.perf_counter()
        fleet.run()
        secs = time.perf_counter() - t0
        rate = (fleet.generated_tokens - tokens0) / secs
        done = {fr.rid: fr for fr in fleet.drain_completed()}
        statuses = {done[r].status for r in rids}
        if statuses != {"ok"}:
            raise RuntimeError(
                f"durability bench oracle: statuses {statuses}, "
                "expected all ok"
            )
        fleet.close()
        del fleet
        _release(device)
        return rate, [list(done[r].tokens) for r in rids]

    def run_durable(oracle_streams: list[list[int]]):
        root = tempfile.mkdtemp(prefix="bench-durable-")
        try:
            fleet = build_fleet(root, warm=True)
            rids = [fleet.submit(p, n) for p, n in reqs]
            with fleet._lock:
                for _ in range(3):  # mid-stream, then the process "dies"
                    if not fleet.idle:
                        fleet.step()
            fleet.close()  # journals live sessions before going dark
            del fleet
            _release(device)
            # A FRESH fleet — new engines, empty pools, empty radix —
            # rebuilt from nothing but what survived on disk.  No warm
            # pass: restore must work into a cold boot.
            fleet2 = build_fleet(root, warm=False)
            t0 = time.perf_counter()
            restored = fleet2.restore(os.path.join(root, "journal"))
            restore_s = time.perf_counter() - t0
            kept = {fr.rid: len(fr.tokens) for fr in fleet2.queue}
            mid = sum(1 for fr in fleet2.queue if fr.tokens)
            if restored < n_req or mid < 1:
                raise RuntimeError(
                    f"durability bench: restored {restored} sessions "
                    f"({mid} mid-stream) — the kill must land with "
                    "every session journaled and >= 1 mid-stream"
                )
            fleet2.run()
            done = {fr.rid: fr for fr in fleet2.drain_completed()}
            equal = _hold_replay(
                {r: list(done[r].tokens) for r in rids},
                dict(zip(rids, oracle_streams)), kept, config.dtype,
                "durability bench",
            )
            reads = sum(
                r.engine._kv_disk.reads for r in fleet2.replicas
            )
            get_s = sum(
                r.engine._kv_disk.get_s for r in fleet2.replicas
            )
            reload_ms = (get_s / reads) * 1000 if reads else 0.0
            fleet2.close()
            del fleet2
            _release(device)
            return restore_s * 1000, reload_ms, restored, equal
        finally:
            shutil.rmtree(root, ignore_errors=True)

    # Throwaway pass: the measured shapes' first launches (and the
    # restore path's), so the first interleaved pair prices durability.
    _, oracle_streams = run_oracle()
    run_durable(oracle_streams)
    restore_samples: list[float] = []
    reload_samples: list[float] = []
    restored_counts: list[float] = []
    off_rates: list[float] = []
    equal = 0

    def durable_arm() -> float:
        nonlocal equal
        restore_ms, reload_ms, restored, whole = run_durable(oracle_streams)
        restore_samples.append(restore_ms)
        reload_samples.append(reload_ms)
        restored_counts.append(restored)
        equal += whole
        return restore_ms

    def oracle_arm() -> float:
        rate, streams = run_oracle()
        if streams != oracle_streams:
            raise RuntimeError(
                "durability bench: durability-off streams drifted "
                "between repeats — the greedy oracle must be stable"
            )
        off_rates.append(rate)
        return rate

    _interleaved_repeats(durable_arm, oracle_arm)
    return {
        "durable_replicas": n_rep,
        "durable_requests": n_req,
        "durable_restore_ms": round(
            statistics.median(restore_samples), 2
        ),
        "durable_restore_ms_min": round(min(restore_samples), 2),
        "durable_restore_ms_max": round(max(restore_samples), 2),
        "durable_restore_ms_samples": [
            round(s, 2) for s in restore_samples
        ],
        "kv_disk_reload_ms": round(
            statistics.median(reload_samples), 3
        ),
        "kv_disk_reload_ms_samples": [
            round(s, 3) for s in reload_samples
        ],
        "durable_sessions_per_hbm_page": round(
            statistics.median(restored_counts) / fleet_hbm_pages, 4
        ),
        "durable_off_tokens_per_sec": round(
            statistics.median(off_rates), 1
        ),
        "durable_replay_streams_equal": equal,
        "durable_replay_streams": len(restore_samples) * n_req,
    }


def measure_faststart(scale: BenchScale, device=None) -> dict:
    """Fast replica start economics (faststart.py), on a spec="auto"
    engine so the spawn path carries what fast start removes: the
    spec-breakeven calibration's dead timing dispatches.  Greedy, so
    every stream bit-compares.

      1. **Spawn ladder** — ``faststart_cold_ms`` is the arm's FIRST
         build + canary probe with the kernel-build cache pointed at a
         fresh directory; ``faststart_warm_ms`` is the same spawn with
         no snapshot (re-runs calibration); ``faststart_cache_hit_spawn_ms``
         is the snapshot-primed spawn (calibration skipped).  Every
         repeat's streams are ASSERTED bit-identical snapshot on/off and
         to the cold oracle; ``faststart_calibration_skipped`` counts the
         skips the arm observed (must be > 0).  Each spawn still
         captures its own decode graph: a snapshot carries none.
      2. **Supervised selfheal integration** — a 2-replica fleet with a
         scheduled mid-stream crash and a snapshot-armed
         ``make_engine_factory``: the death -> probed-rejoin window is
         ``faststart_selfheal_restore_ms``, and the respawned engine
         must have CONSUMED the snapshot.
      3. **Autoscaler integration** — one probed ``_try_scale_up``,
         snapshot hot (``faststart_scaleup_hot_ms``) vs cold
         (``faststart_scaleup_cold_ms``).

    The compile-cache counters count kernel libraries looked up in
    the arm; a library this process loaded before is not looked up
    again, so after the earlier arms they read 0."""
    import statistics
    import tempfile

    from .backoff import Backoff
    from .faststart import EngineSnapshot, cache_stats, enable_compile_cache
    from .faults import FaultInjector
    from .fleet import Fleet
    from .serve import ServeEngine
    from .supervisor import FleetSupervisor, make_engine_factory

    device = resolve_device(device)
    batch, ps = scale.batch, scale.page_size
    chunk = ps
    hi = scale.serve_chunks[1]
    prompt_len = scale.decode_prompt
    config = _config(scale, prompt_len + 1 + hi * chunk)
    draft_config = ModelConfig(
        vocab_size=scale.vocab, d_model=max(16, scale.d_model // 2),
        n_heads=max(2, scale.n_heads // 2), n_layers=1,
        d_ff=max(32, scale.d_ff // 2),
        max_seq_len=config.max_seq_len, dtype=scale.dtype,
    )
    params = _params(config, 0, device)
    draft = _params(draft_config, 7, device)
    engine_kw = dict(
        slots=batch, page_size=ps, chunk=chunk,
        prompt_bucket=-(-prompt_len // ps) * ps,
        draft_params=draft, draft_config=draft_config, gamma=3,
        spec="auto",
    )
    probe = ([1, 2, 3], 1 + chunk)
    # The kernel-build cache is process-global; enabling it here (fresh
    # directory) starts the hit/miss meters for the whole arm.
    enable_compile_cache(tempfile.mkdtemp(prefix="faststart-bench-"))
    cc0 = cache_stats()

    def timed_spawn(snapshot):
        """Build + inline-canary one engine (the supervisor's probe
        contract); returns (secs, tokens, calibration_reused, snap)."""
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine = ServeEngine(params, config, **engine_kw, device=device)
        if snapshot is not None and not snapshot.prime(engine):
            raise RuntimeError("faststart bench: snapshot failed to prime")
        rid = engine.submit(probe[0], probe[1])
        tokens = None
        while tokens is None and not engine.idle:
            for req in engine.step():
                if req.rid == rid:
                    tokens = [int(t) for t in req.tokens]
        secs = time.perf_counter() - t0
        reused = engine.calibration_reused
        snap = EngineSnapshot.capture(
            engine, probe=probe, probe_oracle=tokens,
        ) if snapshot is None else None
        engine.close()
        if tokens is None:
            raise RuntimeError("faststart bench: canary never finished")
        return secs, tokens, reused, snap

    # 1. Spawn ladder.  Cold carries the calibration dispatches; its
    # verdict becomes THE snapshot for everything below.
    cold_s, oracle, _, snap = timed_spawn(None)
    skipped = 0
    warm_samples: list[float] = []
    hot_samples: list[float] = []
    for _ in range(3):
        warm_s, warm_tokens, warm_reused, _ = timed_spawn(None)
        hot_s, hot_tokens, hot_reused, _ = timed_spawn(snap)
        if warm_tokens != oracle or hot_tokens != oracle:
            raise RuntimeError(
                "faststart bench: spawn streams diverged snapshot "
                "on/off — the snapshot must never change tokens"
            )
        if warm_reused != 0 or hot_reused != 1:
            raise RuntimeError(
                f"faststart bench: calibration reuse miscounted "
                f"(warm={warm_reused}, primed={hot_reused})"
            )
        skipped += hot_reused
        warm_samples.append(warm_s)
        hot_samples.append(hot_s)

    # 2. Supervised selfheal with the snapshot armed.  Replicas start
    # COLD-built so any calibration reuse observed after the heal is
    # attributable to the respawn alone.
    n_rep = 2
    factory, fac_oracle = make_engine_factory(
        params, config, engine_kw=engine_kw, snapshot=snap, device=device,
    )
    if fac_oracle != oracle:
        raise RuntimeError(
            "faststart bench: factory oracle != snapshot oracle"
        )
    injector = FaultInjector()
    engines = [ServeEngine(params, config, **engine_kw, device=device)
               for _ in range(n_rep)]
    fleet = Fleet(
        engines, chip_ids=[f"chip-{i}" for i in range(n_rep)],
        fault_injector=injector, hang_timeout_s=60.0,
    )
    for i in range(n_rep):  # warm (and calibrate) off the clock
        fleet.submit([1 + i], 1 + chunk)
    fleet.run()
    fleet.drain_completed()
    sup = FleetSupervisor(
        fleet, factory,
        backoff=Backoff(base_s=1e-3, max_s=5e-3, jitter=0.0),
        probe=probe, snapshot=snap,
        crash_loop_k=3, crash_loop_window_s=60.0,
    )
    injector.reset()
    injector.arm({"replica_crash": 2 * n_rep + 1})
    n_req = 2 * batch
    for i in range(n_req):
        fleet.submit([1 + (i % 7)], 1 + (i % hi) * chunk)
    sup.run()
    done = fleet.drain_completed()
    statuses = {fr.status for fr in done}
    if len(done) != n_req or statuses != {"ok"}:
        raise RuntimeError(
            f"faststart bench: {len(done)} finished with statuses "
            f"{statuses}, expected {n_req} ok"
        )
    if not sup.wait_healed(timeout_s=30.0) or len(sup.restore_s) != 1:
        raise RuntimeError(
            f"faststart bench: supervised heal failed "
            f"(restore windows: {len(sup.restore_s)})"
        )
    selfheal_skipped = sum(
        r.engine.calibration_reused for r in fleet.replicas
        if r.engine is not None
    )
    if selfheal_skipped < 1:
        raise RuntimeError(
            "faststart bench: respawned replica did not consume the "
            "snapshot (calibration-skip counter is 0 after the heal)"
        )
    skipped += selfheal_skipped
    selfheal_restore_s = sup.restore_s[0]
    fleet.close()

    # 3. Autoscaler scale-up, snapshot hot vs cold.
    from .autoscaler import FleetAutoscaler

    def timed_scaleup(snapshot):
        base = ServeEngine(params, config, **engine_kw, device=device)
        fl = Fleet([base], chip_ids=["chip-0"], hang_timeout_s=None)
        fl.submit([1], 1 + chunk)
        fl.run()
        fl.drain_completed()
        fac, _ = make_engine_factory(
            params, config, engine_kw=engine_kw, snapshot=snapshot,
            device=device,
        )
        asc = FleetAutoscaler(
            fl, fac, min_replicas=1, max_replicas=2,
            probe=probe, snapshot=snapshot,
            probe_oracle=None if snapshot is not None else list(oracle),
            up_backoff=Backoff(base_s=1e-3, max_s=5e-3, jitter=0.0),
        )
        t0 = time.perf_counter()
        if not asc._try_scale_up(time.perf_counter()):
            raise RuntimeError("faststart bench: scale-up refused")
        secs = time.perf_counter() - t0
        reused = sum(
            r.engine.calibration_reused for r in fl.replicas
            if r.engine is not None
        )
        fl.close()
        return secs, reused

    scaleup_cold_s, _ = timed_scaleup(None)
    scaleup_hot_s, hot_scale_reused = timed_scaleup(snap)
    if hot_scale_reused < 1:
        raise RuntimeError(
            "faststart bench: hot scale-up did not consume the snapshot"
        )
    skipped += hot_scale_reused

    cc1 = cache_stats()
    warm_ms = [s * 1000 for s in warm_samples]
    hot_ms = [s * 1000 for s in hot_samples]
    return {
        "faststart_cold_ms": round(cold_s * 1000, 2),
        "faststart_warm_ms": round(statistics.median(warm_ms), 2),
        "faststart_cache_hit_spawn_ms": round(
            statistics.median(hot_ms), 2
        ),
        "faststart_cache_hit_spawn_ms_min": round(min(hot_ms), 2),
        "faststart_cache_hit_spawn_ms_max": round(max(hot_ms), 2),
        "faststart_cache_hit_spawn_ms_samples": [
            round(s, 2) for s in hot_ms
        ],
        "faststart_calibration_skipped": skipped,
        "faststart_selfheal_restore_ms": round(
            selfheal_restore_s * 1000, 2
        ),
        "faststart_scaleup_cold_ms": round(scaleup_cold_s * 1000, 2),
        "faststart_scaleup_hot_ms": round(scaleup_hot_s * 1000, 2),
        "faststart_compile_cache_hits": cc1["hits"] - cc0["hits"],
        "faststart_compile_cache_misses": cc1["misses"] - cc0["misses"],
    }


def card_identity() -> dict:
    """The card's name and power limit as ``nvidia-smi`` reports them;
    raises when nvidia-smi cannot say."""
    import subprocess

    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60,
    )
    if proc.returncode != 0 or not proc.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {proc.stderr.strip()}")
    name, limit = proc.stdout.strip().splitlines()[0].rsplit(",", 1)
    return {"device_name": name.strip(), "power_limit_w": float(limit)}


def run(
    scale_name: str = "full", pool_with: dict | None = None, device=None,
) -> dict:
    """The arms as one flat dict, in JAX's order.  ``pool_with`` is the
    previous artifact (when parseable): headline samples pool with its
    persisted ones so the published min–max spans >= 2 processes.  On
    the card the dict carries the card's name and power limit.  Each arm
    that drives a ``Fleet`` prints its seconds and peak device memory to
    stderr (``_timed_arm``)."""
    from .ops.kernel_select import table_from_measurements

    device = resolve_device(device)
    scale = BenchScale.named(scale_name)
    out = {"perf_scale": scale_name}
    out.update(measure_train(scale, device))
    if device.type == "cuda":
        out.update(card_identity())
    attn = measure_flash_vs_xla(scale, device)
    # Headline speedup: the largest sequence length measured both ways.
    top_seq = max(attn)
    out["flash_vs_xla_speedup"] = attn[top_seq]["speedup"]
    out["flash_vs_xla_seq"] = top_seq
    out["flash_vs_xla_detail"] = {
        str(s): r for s, r in sorted(attn.items())
    }
    # Per-bucket kernel winners (ops/kernel_select.py): each swept
    # length's measured flash-vs-dense verdict, reloadable through
    # table_from_artifact.
    for seq, impl in sorted(table_from_measurements(
        {s: r["speedup"] for s, r in attn.items()}
    ).items()):
        out[f"kernel_pick_seq{seq}"] = impl
    out.update(measure_window(scale, device))
    out.update(measure_decode(scale, device))
    out.update(measure_paged_decode(scale, device))
    # >= 1.0 means paging costs nothing for its on-demand allocation.
    out["paged_vs_contiguous_decode"] = round(
        out["paged_decode_tokens_per_sec"] / out["decode_tokens_per_sec"], 3
    )
    out.update(measure_serve(scale, device))
    out.update(measure_serve_latency(scale, device))
    out.update(measure_interleave(scale, device))
    sup = measure_superstep(scale, device)
    out.update(sup)
    _publish_ratio_spread(
        out, "superstep_tokens_per_sec",
        sup["superstep_tokens_per_sec_samples"], pool_with,
    )
    out.update(measure_obs_overhead(scale, device))
    out.update(measure_ledger(scale, device))
    out.update(measure_fault_recovery(scale, device))
    for fn in (measure_fleet, measure_disagg, measure_selfheal, measure_autoscale):
        out.update(_timed_arm(fn, scale, device, log=sys.stderr)[0])
    out.update(measure_admission(scale, device))
    out.update(measure_prefix_serve(scale, device))
    kvh = measure_kv_hierarchy(scale, device)
    out.update(kvh)
    if "kv_offload_reload_ms_samples" in kvh:
        _publish_ratio_spread(
            out, "kv_offload_reload_ms",
            kvh["kv_offload_reload_ms_samples"], pool_with,
        )
    out.update(_timed_arm(measure_kv_sched, scale, device, log=sys.stderr)[0])
    dur = _timed_arm(measure_durability, scale, device, log=sys.stderr)[0]
    out.update(dur)
    for key in ("durable_restore_ms", "kv_disk_reload_ms"):
        _publish_ratio_spread(out, key, dur[f"{key}_samples"], pool_with)
    out.update(measure_spec_serve(scale, device))
    out.update(measure_spec_economics(scale, device))
    phases = measure_spec_phases(scale, device)
    out.update(phases)
    out.update(measure_spec_engine(
        scale, breakeven=phases["spec_breakeven_batch"], device=device
    ))
    # AFTER measure_spec_economics: this arm's engine-measured
    # spec_round_readback_ms supersedes the probe-derived value above.
    sps = measure_spec_superstep(scale, device)
    out.update(sps)
    _publish_ratio_spread(
        out, "spec_superstep_tokens_per_sec",
        sps["spec_superstep_tokens_per_sec_samples"], pool_with,
    )
    out.update(measure_multi_lora(scale, device))
    ctrl = _timed_arm(measure_goodput_ctrl, scale, device, log=sys.stderr)[0]
    out.update(ctrl)
    _publish_ratio_spread(
        out, "ctrl_vs_static_tokens_per_sec",
        ctrl["ctrl_vs_static_tokens_per_sec_samples"], pool_with,
    )
    out.update(measure_profiler(scale, device))
    # LAST: measure_faststart points the process-global kernel-build
    # cache at a fresh directory.
    out.update(measure_faststart(scale, device))
    for key, samples in (
        ("flash_vs_xla_speedup", attn[top_seq]["speedup_samples"]),
        ("flash_window_speedup", out["flash_window_speedup_samples"]),
        ("decode_int8_speedup", out["decode_int8_speedup_samples"]),
        (
            "paged_vs_contiguous_decode",
            [
                round(p / d, 3)
                for p, d in zip(
                    out["paged_decode_tokens_per_sec_samples"],
                    out["decode_tokens_per_sec_samples"],
                )
            ],
        ),
    ):
        _publish_ratio_spread(out, key, samples, pool_with)
    return out


def main(argv=None) -> int:
    import argparse
    import json

    parser = argparse.ArgumentParser(description="perf bench (PyTorch)")
    parser.add_argument("--scale", default="full", choices=["full", "tiny"])
    parser.add_argument("--pool-with", default=None, metavar="PATH",
                        help="an earlier run's JSON: pool the headline "
                        "samples with its persisted ones")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda; 'cpu' runs the "
                        "plain PyTorch path)")
    args = parser.parse_args(argv)
    prior = None
    if args.pool_with is not None:
        with open(args.pool_with, encoding="utf-8") as f:
            prior = json.load(f)
    print(json.dumps(run(args.scale, pool_with=prior, device=args.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
