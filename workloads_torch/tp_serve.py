"""Tensor-parallel serving, ported from ``workloads/tp_serve.py``: the
Megatron cut of ``model.param_specs`` applied to the decode path, so a
model too big for one device serves across the ``"model"`` axis of a
``("data", "model")`` ``DeviceMesh`` (``train.make_mesh``).

The JAX package is one controller whose collectives XLA inserts from the
shardings.  The port is SPMD over ``torch.distributed``: one process per
device, every process running the same program on its own cut of the
state, with the collectives written out:

* each rank holds plain local tensors: its slice of every leaf that
  ``param_specs`` cuts (``shard_params``; replicated leaves whole) and
  pools of ``[layers, pages, kv_heads / mp, page_size, head_dim]``
  (``POOL_SPEC``, the kv-heads cut), and runs the port's cores on those
  shapes: its q heads are ``n_heads / mp``, so the paged-attention
  kernel (K1) runs on each rank over the rank's own kv heads with no
  collective (``_tp_paged_attention``);
* one ``all_reduce`` over the model group follows each row-parallel
  product, the ``wo`` and ``w_down`` outputs (``model_all_reduce``,
  the cores' ``reduce`` hook), and nothing else is communicated:
  embedding, unembedding and norms are replicated, so every rank
  computes the same full logits and picks the same greedy token (and
  the same sampled one, under the same key: every rank takes one);
* multi-LoRA adapters are cut like the weights they adapt
  (``shard_adapters``): on the column-parallel projections each
  adapter's ``b`` keeps the rank's heads, on ``wo`` its ``a`` keeps the
  rank's input rows, and the delta joins the rank's partial product
  before the all-reduce.

No DTensor runs on the hot path: the kernels take local pointers, and
the mesh serves only for its process groups.  In bf16 each rank rounds
its partial ``wo``/``w_down`` product before the sum (as XLA's
partitioned product does), so bf16 logits differ from one device's by
rounding; float32 streams equal one device's token for token.

The programs below take the rank's own cut of the state
(``shard_serving_state``) and the single-device functions' other
arguments; every rank of the model group makes the same calls in the
same order.  ``ServeEngine(mesh=)`` (``serve.py``) drives the same cores
through the same ``reduce`` hook.
"""

from __future__ import annotations

import torch

from .distributed import mesh_device
from .generate import decode_block
from .model import ModelConfig, _mesh_axis, param_specs, shard_leaf, shard_tree
from .ops.paged_attention import paged_attention
from .paged import (
    _spec_round_core,
    _spec_superstep_chained_core,
    _spec_superstep_core,
    paged_decode_chunk,
    paged_decode_superstep,
    paged_prefill,
    paged_prefill_chunk,
)

# Pool cut: [layers, pages, KV_HEADS, page_size, head_dim], the kv-heads
# axis over "model" (JAX's _POOL_SPEC).
POOL_SPEC = (None, None, "model", None, None)


def _check_tp(config: ModelConfig, mesh) -> int:
    if config.n_routed_experts:
        raise ValueError(
            "tensor-parallel serving has no expert layer: serve an expert "
            "config on one device"
        )
    mp = _mesh_axis(mesh, "model")[0]
    if config.n_heads % mp or config.kv_heads % mp:
        raise ValueError(
            f"model-parallel degree {mp} must divide both n_heads "
            f"({config.n_heads}) and kv_heads ({config.kv_heads}) — "
            "attention shards over heads"
        )
    return mp


def _check_serving_mesh(mesh) -> None:
    data = _mesh_axis(mesh, "data")[0]
    if data != 1:
        shape = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
        raise ValueError(
            f"serving mesh must have data degree 1, got {shape} "
            "— shard the model axis only and replicate engines for more "
            "throughput"
        )


def model_all_reduce(mesh):
    """The row-parallel hook (the cores' ``reduce``): sum a rank's
    partial product with the other ranks' of its model group, in place,
    and return it; None when the model degree is 1 (nothing to sum)."""
    if _mesh_axis(mesh, "model")[0] == 1:
        return None
    group = mesh.get_group("model")

    def reduce(t: torch.Tensor) -> torch.Tensor:
        t = t.contiguous()
        torch.distributed.all_reduce(t, group=group)
        return t

    return reduce


def shard_params(params: dict, config: ModelConfig, mesh) -> dict:
    """This rank's cut of a full parameter tree (float or int8 leaves),
    by ``param_specs``."""
    return shard_tree(params, param_specs(config), mesh)


def init_shard_pools(config: ModelConfig, n_pages: int, page_size: int, mesh,
                     device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """This rank's zeroed (k, v) pools, [layers, n_pages + 1, kv_heads /
    mp, page_size, head_dim] each (the last page is the trash page), on
    ``device`` (None: ``mesh_device``)."""
    mp = _check_tp(config, mesh)
    device = mesh_device(mesh) if device is None else torch.device(device)
    shape = (config.n_layers, n_pages + 1, config.kv_heads // mp, page_size,
             config.head_dim)
    return (torch.zeros(shape, dtype=config.dtype, device=device),
            torch.zeros(shape, dtype=config.dtype, device=device))


def shard_adapters(stacked: list, config: ModelConfig, mesh) -> list:
    """This rank's cut of a stacked adapter tree
    (``multi_lora.stack_adapters``: per layer ``{target: {"a": [n+1,
    fan_in, r], "b": [n+1, r, fan_out]}}``).  Each factor is unflattened
    to its weight's axes and cut where ``param_specs`` cuts the weight:
    ``a`` over the contraction axes (only ``wo``'s heads are cut there),
    ``b`` over the output axes (the heads of ``wqkv``/``wq``/``wkv``)."""
    from .lora import _layer_shapes
    from .quant import CONTRACTION_AXES

    shapes = _layer_shapes(config)
    layer_spec = param_specs(config)["layers"][0]
    out = []
    for entry in stacked:
        cut = {}
        for name, ab in entry.items():
            axes = CONTRACTION_AXES[name]
            n_in = len(axes) if isinstance(axes, tuple) else 1
            w_shape, spec = shapes[name], layer_spec[name]
            a, b = ab["a"], ab["b"]
            a = a.reshape(a.shape[0], *w_shape[:n_in], a.shape[-1])
            a = shard_leaf(a, (None, *spec[:n_in], None), mesh)
            b = b.reshape(b.shape[0], b.shape[1], *w_shape[n_in:])
            b = shard_leaf(b, (None, None, *spec[n_in:]), mesh)
            cut[name] = {"a": a.reshape(a.shape[0], -1, a.shape[-1]),
                         "b": b.reshape(b.shape[0], b.shape[1], -1)}
        out.append(cut)
    return out


def shard_serving_state(params: dict, pools, config: ModelConfig, mesh):
    """Existing full serving state cut to this rank: params by
    ``param_specs``, pools by ``POOL_SPEC``; new tensors, so the full ones
    can be freed."""
    _check_tp(config, mesh)
    return (shard_params(params, config, mesh),
            tuple(shard_leaf(p, POOL_SPEC, mesh) for p in pools))


def _gather_data(t: torch.Tensor, mesh) -> torch.Tensor:
    """Concatenate every data group's rows of ``t`` along axis 0 on every
    rank.  Over gloo the rows go through host memory."""
    dp = _mesh_axis(mesh, "data")[0]
    if dp == 1:
        return t
    group = mesh.get_group("data")
    host = torch.distributed.get_backend(group) == "gloo"
    mine = t.cpu() if host else t.contiguous()
    parts = [torch.empty_like(mine) for _ in range(dp)]
    torch.distributed.all_gather(parts, mine, group=group)
    return torch.cat(parts).to(t.device)


def make_tp_generate(config: ModelConfig, mesh):
    """A tensor-parallel greedy decode: (params, prompt [batch,
    prompt_len], max_new_tokens) -> [batch, max_new_tokens] on every
    rank.

    ``params`` is the FULL tree on the rank's device (each call cuts it by
    ``param_specs``); the batch is split over the mesh's "data" axis and
    must divide by its degree; each rank's contiguous cache holds its
    kv-heads slice.  The loop, cache update and argmax are
    ``generate.generate``'s, with the row-parallel all-reduce added, so
    float32 tokens are the single-device tokens."""
    _check_tp(config, mesh)
    device = mesh_device(mesh)
    dp, d_index = _mesh_axis(mesh, "data")
    mp = _mesh_axis(mesh, "model")[0]
    reduce = model_all_reduce(mesh)

    @torch.inference_mode()
    def tp_generate(params: dict, prompt, max_new_tokens: int) -> torch.Tensor:
        prompt = torch.as_tensor(prompt, device=device).long()
        batch, prompt_len = prompt.shape
        if batch % dp:
            raise ValueError(
                f"batch {batch} must be divisible by the mesh's data degree {dp}"
            )
        total = prompt_len + max_new_tokens
        if total > config.max_seq_len:
            raise ValueError(
                f"prompt_len + max_new_tokens = {total} exceeds "
                f"max_seq_len {config.max_seq_len}"
            )
        local = shard_params(params, config, mesh)
        rows = prompt.chunk(dp)[d_index]
        cache = torch.zeros(
            (config.n_layers, 2, rows.shape[0], total, config.kv_heads // mp,
             config.head_dim), dtype=config.dtype, device=device)
        tok = torch.zeros(rows.shape[0], dtype=torch.long, device=device)
        outs = []
        for pos in range(total - 1):
            if pos < prompt_len:
                tok = rows[:, pos]
            logits, cache = decode_block(local, cache, tok[:, None], pos, config,
                                         reduce=reduce)
            tok = torch.argmax(logits[:, 0], dim=-1)
            outs.append(tok)
        return _gather_data(torch.stack(outs, dim=1)[:, prompt_len - 1:], mesh)

    return tp_generate


def _tp_paged_attention(config: ModelConfig, mesh):
    """The paged-attention kernel per model-axis shard: each rank holds
    its kv-head slice of the pools and computes its own q-head group
    (``n_heads / mp`` heads over ``kv_heads / mp``, the one-device
    grouping), so the call is K1 on local tensors with no collective."""
    _check_tp(config, mesh)

    def attention(q, k_pages, v_pages, tables, lengths, layer):
        return paged_attention(q, k_pages, v_pages, tables, lengths, layer=layer,
                               window=config.layer_window(layer))

    return attention


def make_tp_serve_programs(config: ModelConfig, mesh, chunk: int, sampling: bool):
    """Tensor-parallel (prefill, decode_chunk) over the rank's cut of the
    state: ``prefill(params, pools, tables, prompts, lengths, lora=None)``
    and ``decode_chunk(params, pools, tables, token, positions,
    occupancy, rng, temperature, top_k, top_p, lora=None)``, the
    single-device ``paged_prefill``/``paged_decode_chunk`` with the
    all-reduce hook.  ``lora=(stacked, idx, alpha)`` takes the rank's
    ``shard_adapters`` cut.

    The batch stays replicated (serving tensor parallelism shards the
    MODEL; more engines scale request throughput), so the mesh's "data"
    degree must be 1."""
    _check_tp(config, mesh)
    _check_serving_mesh(mesh)
    reduce = model_all_reduce(mesh)

    def tp_prefill(params, pools, tables, prompts, lengths, lora=None):
        return paged_prefill(params, pools, tables, prompts, lengths, config, lora=lora,
                             reduce=reduce)

    def tp_chunk(params, pools, tables, token, positions, occupancy, rng,
                 temperature, top_k, top_p, lora=None):
        return paged_decode_chunk(params, pools, tables, token, positions, occupancy,
                                  rng, temperature, top_k, top_p, config, chunk,
                                  sampling, lora=lora, reduce=reduce)

    return tp_prefill, tp_chunk


def make_tp_decode_superstep(config: ModelConfig, mesh, chunk: int, k: int,
                             sampling: bool):
    """Tensor-parallel plain-decode SUPERSTEP: ``call(params, pools,
    tables, token, positions, live, budget, eos, rngs, temperature,
    top_k, top_p, lora=None)``, ``paged.paged_decode_superstep`` (``k``
    chunks with device-side retirement) with the all-reduce hook; the
    per-row carry comes back as the single-device function returns it."""
    _check_tp(config, mesh)
    reduce = model_all_reduce(mesh)

    def call(params, pools, tables, token, positions, live, budget, eos, rngs,
             temperature, top_k, top_p, lora=None):
        return paged_decode_superstep(params, pools, tables, token, positions, live,
                                      budget, eos, rngs, temperature, top_k, top_p,
                                      config, chunk, k, sampling, lora=lora,
                                      reduce=reduce)

    return call


def make_tp_prefill_chunk(config: ModelConfig, mesh):
    """Tensor-parallel CHUNKED prefill for the batched-admission sweep:
    ``call(params, pools, tables, chunk_tokens, lengths, *, start_page,
    cover_pages, emit, lora=None, row_start=None)``, the single-device
    ``paged_prefill_chunk`` with the all-reduce hook."""
    _check_tp(config, mesh)
    reduce = model_all_reduce(mesh)

    def call(params, pools, tables, chunk_tokens, lengths, *, start_page, cover_pages,
             emit, lora=None, row_start=None):
        return paged_prefill_chunk(params, pools, tables, chunk_tokens, lengths, config,
                                   start_page, cover_pages, emit, row_start=row_start,
                                   lora=lora, reduce=reduce)

    return call


def make_tp_spec_program(t_config: ModelConfig, d_config: ModelConfig, mesh, gamma: int,
                         chained: bool = False, sampling: bool = False):
    """Tensor-parallel batched speculative round: draft and verify both
    run on the rank's cut (the draft's decode through K1 per shard, the
    target's dense verify under the same all-reduce hook).  Both models
    must meet the head-divisibility contract.

    Returns ``spec_round(t_params, d_params, t_pools, d_pools, tables,
    cur, positions, occupancy=None, *, cover_pages=None, t_lora=None,
    rng=None, temperature=0.0, top_k=0, top_p=1.0)`` ->
    (committed, n, t_pools, d_pools); with ``chained`` the occupancy mask
    is required and (new_cur, new_pos) come between n and the pools
    (``paged.paged_spec_round_chained``).  ``t_lora`` adapts the
    target's verify (the rank's ``shard_adapters`` cut); ``sampling``
    draws under ``rng`` (the same key on every rank)."""
    _check_tp(t_config, mesh)
    _check_tp(d_config, mesh)
    reduce = model_all_reduce(mesh)
    d_attention_fn = _tp_paged_attention(d_config, mesh)

    @torch.inference_mode()
    def spec_round(t_params, d_params, t_pools, d_pools, tables, cur, positions,
                   occupancy=None, *, cover_pages=None, t_lora=None, rng=None,
                   temperature=0.0, top_k=0, top_p=1.0):
        if chained and occupancy is None:
            raise ValueError("the chained speculative round takes an occupancy mask")
        out = _spec_round_core(
            t_params, d_params, t_pools, d_pools, tables, cur, positions, t_config,
            d_config, gamma, cover_pages, d_attention_fn,
            occupancy=occupancy if chained else None, sampling=sampling,
            rng=rng, temperature=temperature, top_k=top_k, top_p=top_p,
            t_lora=t_lora, reduce=reduce,
        )
        return (*out, t_pools, d_pools)

    return spec_round


def make_tp_spec_superstep(t_config: ModelConfig, d_config: ModelConfig, mesh,
                           gamma: int, k: int, sampling: bool = False,
                           retire: bool = False):
    """Tensor-parallel speculative SUPERSTEP: ``k`` chained rounds in one
    call on the rank's cut.  ``call(t_params, d_params, t_pools, d_pools,
    tables, cur, positions, occupancy, live=None, budget=None, eos=None,
    *, cover_pages=None, t_lora=None, rng=None, temperature=0.0,
    top_k=0, top_p=1.0)`` returns ``paged.paged_spec_superstep``'s
    outputs (``rng`` the dispatch's key), or with ``retire=True`` (live,
    budget and eos then required; ``rng`` one key a round, [k, 2])
    ``paged.paged_spec_superstep_chained``'s (the chained-retirement
    core of the engine's ``spec_superstep_k`` path)."""
    _check_tp(t_config, mesh)
    _check_tp(d_config, mesh)
    reduce = model_all_reduce(mesh)
    d_attention_fn = _tp_paged_attention(d_config, mesh)

    @torch.inference_mode()
    def call(t_params, d_params, t_pools, d_pools, tables, cur, positions, occupancy,
             live=None, budget=None, eos=None, *, cover_pages=None, t_lora=None,
             rng=None, temperature=0.0, top_k=0, top_p=1.0):
        samp = dict(sampling=sampling, temperature=temperature,
                    top_k=top_k, top_p=top_p, t_lora=t_lora, reduce=reduce)
        if retire:
            if live is None or budget is None or eos is None:
                raise ValueError("the retiring superstep takes live, budget and eos")
            out = _spec_superstep_chained_core(
                t_params, d_params, t_pools, d_pools, tables, cur, positions, occupancy,
                live, budget, eos, t_config, d_config, gamma, k, cover_pages,
                d_attention_fn, rngs=rng, **samp,
            )
        else:
            out = _spec_superstep_core(
                t_params, d_params, t_pools, d_pools, tables, cur, positions, occupancy,
                t_config, d_config, gamma, k, cover_pages, d_attention_fn, rng=rng, **samp,
            )
        return (*out, t_pools, d_pools)

    return call
