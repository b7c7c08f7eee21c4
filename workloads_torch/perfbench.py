"""The perf bench on the card: training, kernels and one engine.

The PyTorch port of ``workloads/perfbench.py``'s harness and of its
arms that drive the kernels and one engine, at
``BenchScale.named("full")`` (d_model 2048, 16 heads, 8 layers, d_ff
8192, vocab 32768, bf16): the training step and its MFU
(``device_peak_flops``, an H100 table), flash attention (K2-K4) against
the dense core it replaces and its window skip, contiguous and paged
decode, and the continuous-batching engine timed end to end (serving,
latency, prefill budget, supersteps, overheads, fault recovery,
admission, the prefix cache and the KV hierarchy, speculation,
multi-LoRA, fast start), each engine decode step a replay of its CUDA
graph through the paged-attention kernel (K1).

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

Not ported here: the arms that drive a ``Fleet`` (``measure_fleet``,
``measure_disagg``, ``measure_selfheal``, ``measure_autoscale``,
``measure_kv_sched``, ``measure_goodput_ctrl``, ``measure_durability``),
the next slice.  Seeds: weights from ``torch.Generator`` seed 0 (JAX's ``PRNGKey(0)``),
prompts from numpy seeds (JAX's ``PRNGKey(n)``), samplers from
``generator=`` seed 3 (JAX's ``rng=``).  Entry points run on the card
unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from . import resolve_device
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
        init_params(config, torch.Generator(device).manual_seed(seed)),
        config.dtype,
    )


def _prompt(seed: int, length: int, vocab: int) -> list[int]:
    return [int(t) for t in np.random.default_rng(seed).integers(0, vocab, length)]


def _sampler(seed: int, device) -> torch.Generator:
    return torch.Generator(device).manual_seed(seed)


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

    JAX builds a mesh here and steps through ``make_sharded_train_step``;
    the port steps on one device (``train.make_train_step``) until its
    parallel layouts land (ROADMAP item 16)."""
    from .train import make_train_state, make_train_step, synthetic_batch

    device = resolve_device(device)
    (params, opt_state), optimizer = make_train_state(config, device=device)
    step = make_train_step(config, optimizer)
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
    """Standard-normal (q, k, v), each [1, seq, heads, head_dim], from
    numpy seed ``seq`` (JAX's ``PRNGKey(seq)``)."""
    rng = np.random.default_rng(seq)
    return tuple(
        torch.from_numpy(
            rng.standard_normal((1, seq, heads, head_dim), dtype=np.float32)
        ).to(device=device, dtype=dtype)
        for _ in range(3)
    )


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
    """[batch, length] int64 tokens from numpy seed ``seed``."""
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.integers(0, vocab, (batch, length)), device=device)


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
            max_steps=chunk, generator=None, temperature=0.0, top_k=0,
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
            generator=_sampler(3, device),
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
        temperature=0.8, top_k=50, top_p=0.95, generator=_sampler(3, device),
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
            generator=_sampler(3, device), pipelined=True, observer=obs,
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
            generator=_sampler(3, device), pipelined=True, observer=obs,
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
            generator=_sampler(3, device), pipelined=True,
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
        if config.dtype == torch.float32 and streams != ref_streams:
            raise RuntimeError(
                "fault-recovery bench: replayed streams diverged from "
                "the baseline — replay is supposed to be bit-identical"
            )
        if (
            {r: len(t) for r, t in streams.items()}
            != {r: len(t) for r, t in ref_streams.items()}
            or any(streams[r][:k] != ref_streams[r][:k] for r, k in kept.items())
        ):
            raise RuntimeError(
                "fault-recovery bench: a replayed stream lost tokens or "
                "changed the tokens it kept at its requeue"
            )
        equal += sum(streams[r] == ref_streams[r] for r in ref_streams)
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
    the card the dict carries the card's name and power limit.

    The arms that drive a ``Fleet`` — ``measure_fleet``,
    ``measure_disagg``, ``measure_selfheal`` and ``measure_autoscale``
    (after the fault arm), ``measure_kv_sched`` and
    ``measure_durability`` (after the KV hierarchy) and
    ``measure_goodput_ctrl`` (after multi-LoRA) — are the next slice."""
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
    out.update(measure_admission(scale, device))
    out.update(measure_prefix_serve(scale, device))
    kvh = measure_kv_hierarchy(scale, device)
    out.update(kvh)
    if "kv_offload_reload_ms_samples" in kvh:
        _publish_ratio_spread(
            out, "kv_offload_reload_ms",
            kvh["kv_offload_reload_ms_samples"], pool_with,
        )
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
