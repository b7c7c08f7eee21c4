"""Tensor-parallel serving scenarios on gloo CPU worlds, for
tests/test_torch_tp_serve.py, tests/test_torch_distributed.py and the
live JAX writer of tests/test_torch_tp_golden.npz
(tests/test_torch_parity.py).

The JAX package's TP cases (tests/test_tp_serve.py and the mesh cases of
test_batched_admission, test_prefix_cache, test_spec_lookahead,
test_spec_superstep and test_multi_lora) as data: a model configuration,
the mesh's model degree, the engine's keywords and a script of
submissions.  Weights and adapters come from numpy seeds, so the port's
one-device engine, the port's tensor-parallel engine on every rank and
the JAX package's TP engine all serve the same model.

``run_world`` spawns ``world`` processes (start method ``spawn``) that
join one gloo process group through a ``FileStore``; each runs the named
scenarios in order (``SCENARIOS``) and writes each result, or the error
that ended it, to a pickle file (written under a temporary name and
renamed into place, so a killed rank leaves no half-written result); a
rank that fails stops, and the world is killed when ``timeout`` passes,
so a hang fails instead of stalling.  Each rank's stdout and stderr go
to ``<tmp>/rank<r>.log`` (with ``faulthandler``'s traceback on a fatal
signal), and ``run_world`` keeps every rank's exit code, so a failure
message names how each rank ended and the tail of its log.
Nothing here imports JAX.
"""

from __future__ import annotations

import datetime
import faulthandler
import os
import pickle
import sys
import time
import traceback
from dataclasses import dataclass

import numpy as np
import torch

VOCAB = 256

# The JAX tests' model configurations, float32 (d_model 64, 4 heads,
# vocab 256 unless set).
CONFIGS = {
    "mha": dict(max_seq_len=64, n_layers=2),
    "mha96": dict(max_seq_len=96, n_layers=2),
    "gqa": dict(max_seq_len=64, n_layers=2, n_heads=4, n_kv_heads=2),
    "gqa_window": dict(max_seq_len=64, n_layers=2, n_heads=4, n_kv_heads=2,
                       attention_window=8),
    "draft": dict(max_seq_len=64, n_layers=1, d_model=32, n_heads=2, d_ff=64),
    "draft96": dict(max_seq_len=96, n_layers=1, d_model=32, n_heads=2, d_ff=64),
}
PARAM_SEEDS = {"mha": 0, "mha96": 0, "gqa": 1, "gqa_window": 1, "draft": 7, "draft96": 7}
ADAPTER_SEEDS = {"tenant-a": 11, "tenant-b": 12}
LORA_RANK, LORA_SCALE = 4, 0.3


def port_config(name: str, dtype=torch.float32):
    from workloads_torch.model import ModelConfig

    return ModelConfig(dtype=dtype, **CONFIGS[name])


def _dims(name: str) -> dict:
    c = dict(vocab_size=VOCAB, d_model=64, n_heads=4, n_layers=2, d_ff=128, n_kv_heads=None)
    c.update({k: v for k, v in CONFIGS[name].items() if k in c})
    c["kv_heads"] = c["n_kv_heads"] or c["n_heads"]
    c["head_dim"] = c["d_model"] // c["n_heads"]
    return c


def numpy_params(name: str) -> dict:
    """The models' parameter tree and law (dense leaves N(0, 0.02), norm
    gains 1) as float32 numpy arrays from the config's numpy seed."""
    c = _dims(name)
    rng = np.random.default_rng(PARAM_SEEDS[name])
    d, h, hd, kv = c["d_model"], c["n_heads"], c["head_dim"], c["kv_heads"]

    def dense(*shape):
        return (0.02 * rng.standard_normal(shape)).astype(np.float32)

    tree = {"embed": dense(VOCAB, d), "unembed": dense(d, VOCAB), "layers": []}
    for _ in range(c["n_layers"]):
        layer = {"ln1": np.ones(d, np.float32), "ln2": np.ones(d, np.float32)}
        if kv == h:
            layer["wqkv"] = dense(d, 3, h, hd)
        else:
            layer["wq"] = dense(d, h, hd)
            layer["wkv"] = dense(d, 2, kv, hd)
        layer["wo"] = dense(h, hd, d)
        layer["w_up"] = dense(d, c["d_ff"])
        layer["w_down"] = dense(c["d_ff"], d)
        tree["layers"].append(layer)
    return tree


def numpy_adapters(name: str = "mha") -> dict:
    """Two adapters over every LoRA target, ``[layer]{target: {a, b}}``
    float32 numpy: ``a`` as ``lora_init`` draws it, ``b`` scaled normals
    (the synthetic adapters' law), each from its own numpy seed."""
    from workloads_torch import lora

    config = port_config(name)
    shapes = lora._layer_shapes(config)
    out = {}
    for tenant, seed in ADAPTER_SEEDS.items():
        rng = np.random.default_rng(seed)
        layers = []
        for _ in range(config.n_layers):
            entry = {}
            for target in lora._TARGETS:
                if target not in shapes:
                    continue
                fan_in, fan_out = lora._fans(target, shapes[target])
                a = (rng.standard_normal((fan_in, LORA_RANK)) / fan_in**0.5).astype(np.float32)
                b = (LORA_SCALE * rng.standard_normal((LORA_RANK, fan_out))).astype(np.float32)
                entry[target] = {"a": a, "b": b}
            layers.append(entry)
        out[tenant] = layers
    return out


def _rng_requests(seed, n, p_lo, p_hi, new_hi):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        plen = int(rng.integers(p_lo, p_hi))
        new = int(rng.integers(2, new_hi))
        out.append(([int(t) for t in rng.integers(0, VOCAB, plen)], new))
    return out


def _mixed_requests(seed, n, p_hi):
    """tests/test_batched_admission.py's _mixed_requests."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        plen = int(rng.integers(3, p_hi))
        new = int(rng.integers(2, 25))
        out.append(([int(t) for t in rng.integers(0, VOCAB, plen)], new))
    return out


def _submits(requests, adapter=None):
    return [("submit", p, n, adapter) for p, n in requests] + [("run",)]


@dataclass(frozen=True)
class Case:
    """One engine scenario: ``config`` names CONFIGS, ``draft`` the draft
    config (None: no speculation), ``adapters`` serves the two LoRA
    tenants, ``kw`` the engine's keywords, ``script`` its calls in order:
    ("submit", prompt, max_new, adapter), ("fanout", prompt, max_new, n),
    ("deadline", prompt, max_new, seconds), ("run",).  ``golden``: the
    JAX TP engine's streams are frozen for it; ``meshes``: the model
    degrees (world sizes) it runs at."""

    config: str
    kw: dict
    script: tuple
    draft: str | None = None
    adapters: bool = False
    golden: bool = True
    meshes: tuple = (2,)


_ENGINE = dict(slots=2, page_size=4, prompt_bucket=12, chunk=4)
_SMALL = dict(slots=2, page_size=4, prompt_bucket=8)
_ENGINE_REQ = _rng_requests(5, 4, 3, 11, 20)
_SPEC_REQ = _rng_requests(31, 4, 3, 9, 20)
_PIPE_REQ = _rng_requests(41, 4, 3, 11, 20)
_LONG = [int(t) for t in np.random.default_rng(21).integers(0, VOCAB, 21)]
_LORA_LONG = [int(t) for t in np.random.default_rng(13).integers(0, VOCAB, 19)]
_SS_STREAMS = [([3, 1, 4, 1, 5], 17), ([2, 7], 9), ([9] * 11, 13)]
_SPEC_LORA = (("submit", [1, 2, 3, 4], 8, "tenant-a"), ("submit", [5, 6, 7], 8, None),
              ("submit", [1, 2, 3, 4], 8, "tenant-b"), ("run",))

CASES = {
    # tests/test_tp_serve.py
    "engine": Case("mha", _ENGINE, _submits(_ENGINE_REQ), meshes=(2, 4)),
    "chunked_long": Case("mha", dict(_ENGINE, prompt_bucket=8), _submits([(_LONG, 10)]),
                         meshes=(2, 4)),
    "fanout": Case("mha", dict(_ENGINE, slots=3), (("fanout", list(range(2, 12)), 6, 3),
                                                   ("run",)), meshes=(2, 4)),
    "spec": Case("mha", dict(_SMALL, gamma=3), _submits(_SPEC_REQ), draft="draft"),
    "pipelined_spec": Case("mha", dict(_SMALL, gamma=3, pipelined=True),
                           _submits([([1, 2, 3, 4], 10), ([5, 6], 14), ([7, 8, 9], 6)]),
                           draft="draft"),
    "unpipelined": Case("mha", _ENGINE, _submits(_PIPE_REQ), meshes=(2, 4)),
    "pipelined": Case("mha", dict(_ENGINE, pipelined=True), _submits(_PIPE_REQ),
                      meshes=(2, 4)),
    "gqa_window": Case("gqa_window", dict(_SMALL, chunk=4),
                       _submits([([1, 2, 3, 4], 10), ([5, 6], 6), ([7, 8, 9], 12)])),
    # tests/test_batched_admission.py: serial against batched admission
    "serial": Case("mha", dict(_SMALL, chunk=4, batched_admission=False),
                   _submits(_mixed_requests(41, 4, 16)), meshes=(2, 4)),
    "batched": Case("mha", dict(_SMALL, chunk=4, batched_admission=True),
                    _submits(_mixed_requests(41, 4, 16)), meshes=(2, 4)),
    # tests/test_prefix_cache.py: the second admission hits
    "prefix": Case("mha", dict(_SMALL, chunk=4, prefix_cache=True),
                   (("submit", list(range(2, 15)), 6, None), ("run",),
                    ("submit", list(range(2, 15)), 6, None), ("run",)), meshes=(2, 4)),
    # tests/test_spec_lookahead.py
    "lookahead": Case("mha96", dict(_SMALL, gamma=3, spec_lookahead=2),
                      _submits([([1, 2, 3, 4], 12), ([9, 8, 7], 8)]), draft="draft96"),
    "lookahead_sampling": Case(
        "mha96", dict(_SMALL, gamma=3, spec_lookahead=2, temperature=0.9, top_k=40),
        _submits([([2 + i, 5], 9) for i in range(3)]), draft="draft96", golden=False),
    # tests/test_spec_superstep.py
    "spec_superstep": Case("mha", dict(_SMALL, gamma=3, spec_superstep_k=3),
                           _submits(_SS_STREAMS), draft="draft"),
    # tests/test_multi_lora.py
    "multi_lora": Case("mha", dict(_SMALL, chunk=4),
                       (("submit", [1, 2, 3, 4], 8, "tenant-a"),
                        ("submit", [1, 2, 3, 4], 8, "tenant-b"),
                        ("submit", [9, 8, 7], 8, None),
                        ("submit", _LORA_LONG, 8, "tenant-b"), ("run",)),
                       adapters=True, meshes=(2, 4)),
    "spec_lora": Case("mha", dict(_SMALL, gamma=3), _SPEC_LORA, draft="draft",
                      adapters=True),
    "spec_lora_pipelined": Case("mha", dict(_SMALL, gamma=3, pipelined=True), _SPEC_LORA,
                                draft="draft", adapters=True),
    # The remaining decode modes under the mesh.
    "superstep": Case("mha", dict(_ENGINE, superstep_k=2, pipelined=True),
                      _submits(_ENGINE_REQ), meshes=(2, 4)),
    "prefill_budget": Case("mha", dict(_ENGINE, prefill_budget=8), _submits(_ENGINE_REQ),
                           meshes=(2, 4)),
    "spec_auto": Case("mha", dict(_SMALL, gamma=3, spec="auto"), _submits(_SPEC_REQ),
                      draft="draft"),
    "deadline": Case("mha", _ENGINE, (("deadline", [1, 2, 3], 8, 1e-9),
                                      ("submit", [4, 5, 6], 8, None), ("run",)),
                     golden=False),
}


def port_params(name: str, device="cpu", dtype=torch.float32) -> dict:
    from workloads_torch import convert
    from workloads_torch.model import cast_params

    return cast_params(convert.params_from_jax(numpy_params(name), device=device), dtype)


def port_engine(case: Case, mesh=None, device="cpu"):
    from workloads_torch import convert
    from workloads_torch.serve import ServeEngine

    kw = dict(case.kw)
    if case.draft is not None:
        kw.update(draft_params=port_params(case.draft, device),
                  draft_config=port_config(case.draft))
    if case.adapters:
        kw["adapters"] = convert.adapters_from_jax(numpy_adapters(case.config), device=device)
    return ServeEngine(port_params(case.config, device), port_config(case.config),
                       device=device, mesh=mesh, **kw)


def drive(engine, script) -> dict:
    """Run ``script`` on ``engine``; the streams of every submission in
    order, their statuses and the engine's counters."""
    rids, served, marks = [], {}, []
    for op in script:
        if op[0] == "submit":
            rids.append(engine.submit(op[1], op[2], adapter=op[3]))
        elif op[0] == "deadline":
            rids.append(engine.submit(op[1], op[2], deadline_s=op[3]))
        elif op[0] == "fanout":
            rids.extend(engine.submit_fanout(op[1], op[2], n_samples=op[3]))
        else:
            served.update(engine.run())
            marks.append(engine.prefill_tokens)
    status = {r.rid: r.status for r in engine.completed}
    return {"streams": [[int(t) for t in served.get(r, [])] for r in rids],
            "statuses": [status.get(r) for r in rids],
            "used_pages": engine.ctrl.used_pages, "prefills_run": engine.prefills_run,
            "prefill_tokens": marks, "spec_rounds": engine.spec_rounds,
            "prefill_sweeps": engine.prefill_sweeps,
            "mode_steps": (engine.spec_mode_steps, engine.plain_mode_steps)}


def run_case(name: str, mesh=None, device="cpu") -> dict:
    case = CASES[name]
    with torch.inference_mode():
        return drive(port_engine(case, mesh, device), case.script)


# ---- scenarios a world runs ----------------------------------------------


class Ctx:
    """A rank's view of its world: meshes by shape, built once and in
    the same order on every rank (each is a collective)."""

    def __init__(self, rank: int, world: int):
        self.rank, self.world = rank, world
        self._meshes: dict = {}

    def mesh(self, data: int, model: int):
        if (data, model) not in self._meshes:
            from workloads_torch.train import make_mesh

            self._meshes[(data, model)] = make_mesh(data * model, model_parallel=model,
                                                    device_type="cpu")
        return self._meshes[(data, model)]


def _engine_scenario(name: str):
    def scenario(ctx: Ctx):
        return run_case(name, ctx.mesh(1, ctx.world))

    return scenario


def _raises(fn) -> str | None:
    try:
        fn()
    except (ValueError, RuntimeError) as exc:
        return f"{type(exc).__name__}: {exc}"
    return None


def s_validations(ctx: Ctx) -> dict:
    """What each constructor refuses on this world's meshes."""
    from workloads_torch import tp_serve
    from workloads_torch.serve import ServeEngine

    out = {}
    mp_mesh = ctx.mesh(1, ctx.world)
    gqa = port_config("gqa")
    if ctx.world == 4:
        out["generate_heads"] = _raises(lambda: tp_serve.make_tp_generate(gqa, mp_mesh))
        out["draft_heads"] = _raises(lambda: port_engine(CASES["spec"], mp_mesh))
        dp_mesh = ctx.mesh(2, 2)
        out["data_degree"] = _raises(lambda: tp_serve.make_tp_serve_programs(
            port_config("mha"), dp_mesh, chunk=4, sampling=False))
        out["engine_data_degree"] = _raises(
            lambda: port_engine(CASES["engine"], dp_mesh))
    out["kv_offload"] = _raises(lambda: ServeEngine(
        port_params("mha"), port_config("mha"), prefix_cache=True, kv_offload=True,
        device="cpu", mesh=mp_mesh, **_SMALL))
    out["device"] = _raises(lambda: ServeEngine(
        port_params("mha"), port_config("mha"), device="cuda", mesh=mp_mesh, **_SMALL))
    out["default_mesh"] = _raises(lambda: __import__(
        "workloads_torch.train", fromlist=["make_mesh"]).make_mesh())
    return out


def s_param_specs(ctx: Ctx) -> dict:
    """param_specs of both layouts, and the leaves' shapes on this rank
    where the world's model degree divides the kv heads."""
    from workloads_torch import tp_serve
    from workloads_torch.model import param_specs

    out = {}
    for name in ("mha", "gqa"):
        config = port_config(name)
        out[name] = param_specs(config)
        if config.kv_heads % ctx.world == 0:
            local = tp_serve.shard_params(port_params(name), config, ctx.mesh(1, ctx.world))
            out[f"{name}_shapes"] = {k: tuple(v.shape) for k, v in local["layers"][0].items()}
    return out


# make_tp_generate's cases per world: (config, (data, model), prompt seed);
# the JAX test's dp x tp mesh (2, 4) and GQA mesh (4, 2) fit four ranks
# as (2, 2).
GENERATE_MESHES = {2: [("mha", (1, 2), 0)],
                   4: [("mha", (2, 2), 1), ("gqa", (2, 2), 2), ("mha", (1, 4), 1)]}


def s_generate(ctx: Ctx) -> dict:
    """make_tp_generate over (data, model) meshes against generate()."""
    from workloads_torch import tp_serve
    from workloads_torch.generate import generate

    out = {}
    for name, shape, seed in GENERATE_MESHES[ctx.world]:
        config = port_config(name)
        prompts = np.random.default_rng(seed).integers(0, VOCAB, (4, 8))
        params = port_params(name)
        got = tp_serve.make_tp_generate(config, ctx.mesh(*shape))(params, prompts, 12)
        want = generate(params, prompts, config, 12, device="cpu")
        out[f"{name}{shape}"] = (got.tolist(), want.tolist())
    return out


def s_programs(ctx: Ctx) -> dict:
    """Each tp_serve program on this rank's cut against its single-device
    function on the full state, from the same inputs: the tokens, and the
    largest difference of the rank's pools from its slice of the
    single-device pools."""
    from workloads_torch import paged, tp_serve
    from workloads_torch.model import shard_leaf

    mesh = ctx.mesh(1, ctx.world)
    config, d_config = port_config("mha"), port_config("draft")
    params, d_params = port_params("mha"), port_params("draft")
    ps, n_pages, slots, chunk = 4, 24, 2, 4
    out = {}

    def fresh():
        pools = paged.init_page_pools(config, n_pages, ps, "cpu")
        d_pools = paged.init_page_pools(d_config, n_pages, ps, "cpu")
        t_local = tp_serve.shard_serving_state(params, pools, config, mesh)
        d_local = tp_serve.shard_serving_state(d_params, d_pools, d_config, mesh)
        return pools, d_pools, t_local, d_local

    def pool_err(full, local):
        return max((shard_leaf(f, tp_serve.POOL_SPEC, mesh) - l).abs().max().item()
                   for f, l in zip(full, local))

    tables = torch.arange(slots * 12, dtype=torch.int32).reshape(slots, 12)
    prompts = torch.as_tensor(np.random.default_rng(3).integers(0, VOCAB, (slots, 8)))
    lengths = torch.tensor([8, 5], dtype=torch.int32)
    pos = lengths.long()
    occ = torch.ones(slots, dtype=torch.bool)
    tp_prefill, tp_chunk = tp_serve.make_tp_serve_programs(config, mesh, chunk, False)
    pc = tp_serve.make_tp_prefill_chunk(config, mesh)
    with torch.inference_mode():
        pools, d_pools, (lp, lpools), (ldp, ld_pools) = fresh()
        want, _ = paged.paged_prefill(params, pools, tables, prompts, lengths, config)
        got, _ = tp_prefill(lp, lpools, tables, prompts, lengths)
        out["prefill"] = (got.argmax(-1).tolist(), want.argmax(-1).tolist(),
                          pool_err(pools, lpools))
        tok = want.argmax(-1)
        want_t, _ = paged.paged_decode_chunk(params, pools, tables, tok, pos, occ, None, 0.0,
                                             0, 1.0, config, chunk, False)
        got_t, _ = tp_chunk(lp, lpools, tables, tok, pos, occ, None, 0.0, 0, 1.0)
        out["chunk"] = (got_t.tolist(), want_t.tolist(), pool_err(pools, lpools))
        sup = tp_serve.make_tp_decode_superstep(config, mesh, chunk, 2, False)
        live = occ.clone()
        budget = torch.tensor([5, 8], dtype=torch.int32)
        eos = torch.tensor([-1, -1], dtype=torch.int32)
        p2 = pos + chunk
        want_s = paged.paged_decode_superstep(params, pools, tables, want_t[:, -1], p2, live,
                                              budget, eos, None, 0.0, 0, 1.0, config, chunk,
                                              2, False)
        got_s = sup(lp, lpools, tables, want_t[:, -1], p2, live, budget, eos, None, 0.0, 0,
                    1.0)
        out["superstep"] = (got_s[0].tolist(), want_s[0].tolist(), pool_err(pools, lpools))
        # The chunked prefill program: two page-aligned chunks.
        pools, d_pools, (lp, lpools), (ldp, ld_pools) = fresh()
        long_prompts = torch.as_tensor(np.random.default_rng(4).integers(0, VOCAB, (slots, 16)))
        long_lengths = torch.tensor([14, 9], dtype=torch.int32)
        toks = []
        for start in (0, 2):
            sl = long_prompts[:, start * ps:(start + 2) * ps]
            w, _ = paged.paged_prefill_chunk(params, pools, tables, sl, long_lengths, config,
                                             start, start + 2, emit=start == 2)
            g, _ = pc(lp, lpools, tables, sl, long_lengths, start_page=start,
                      cover_pages=start + 2, emit=start == 2)
            toks.append((g, w))
        out["prefill_chunk"] = (toks[-1][0].argmax(-1).tolist(),
                                toks[-1][1].argmax(-1).tolist(), pool_err(pools, lpools))
        # Speculative programs after a prefill of both models.
        for label, chained, k, retire in (("spec_round", False, 1, False),
                                          ("spec_round_chained", True, 1, False),
                                          ("spec_superstep", None, 2, False),
                                          ("spec_superstep_retire", None, 2, True)):
            pools, d_pools, (lp, lpools), (ldp, ld_pools) = fresh()
            logits, _ = paged.paged_prefill(params, pools, tables, prompts, lengths, config)
            paged.paged_prefill(d_params, d_pools, tables, prompts, lengths, d_config)
            tp_prefill(lp, lpools, tables, prompts, lengths)
            tp_serve.make_tp_prefill_chunk(d_config, mesh)(
                ldp, ld_pools, tables, prompts, lengths, start_page=0, cover_pages=2,
                emit=False)
            cur = logits.argmax(-1)
            if chained is not None:
                prog = tp_serve.make_tp_spec_program(config, d_config, mesh, 3,
                                                     chained=chained)
                extra = (occ,) if chained else ()
                got = prog(lp, ldp, lpools, ld_pools, tables, cur, pos, *extra,
                           cover_pages=8)
                fn = paged.paged_spec_round_chained if chained else paged.paged_spec_round
                want = fn(params, d_params, pools, d_pools, tables, cur, pos, *extra,
                          config, d_config, 3, cover_pages=8)
            else:
                prog = tp_serve.make_tp_spec_superstep(config, d_config, mesh, 3, k,
                                                       retire=retire)
                if retire:
                    args = (occ, occ, torch.tensor([9, 4]), torch.tensor([-1, -1]))
                    got = prog(lp, ldp, lpools, ld_pools, tables, cur, pos, *args,
                               cover_pages=12)
                    want = paged.paged_spec_superstep_chained(
                        params, d_params, pools, d_pools, tables, cur, pos, *args, config,
                        d_config, 3, k, cover_pages=12)
                else:
                    got = prog(lp, ldp, lpools, ld_pools, tables, cur, pos, occ,
                               cover_pages=12)
                    want = paged.paged_spec_superstep(
                        params, d_params, pools, d_pools, tables, cur, pos, occ, config,
                        d_config, 3, k, cover_pages=12)
            out[label] = ([t.tolist() for t in got[:2]], [t.tolist() for t in want[:2]],
                          max(pool_err(pools, lpools), pool_err(d_pools, ld_pools)))
    return out


def s_bf16_step(ctx: Ctx) -> dict:
    """One teacher-forced decode step on the rank's cut, in float32 and
    in bf16 (the row-parallel products rounded to bf16 before the sum),
    each held as (max, rms) distance from one device's float32 step,
    beside one device's bf16 step's (the bf16 floor)."""
    from workloads_torch import paged, tp_serve

    mesh = ctx.mesh(1, ctx.world)
    ps, lengths = 4, [23, 9]
    cover = -(-max(lengths) // ps)
    tables = torch.arange(2 * cover, dtype=torch.int32).reshape(2, cover)
    tables = torch.cat([tables, torch.full((2, 1), 2 * cover, dtype=torch.int32)], 1)
    g = torch.Generator().manual_seed(5)
    prompts = torch.randint(0, VOCAB, (2, cover * ps), generator=g)
    tok = torch.randint(0, VOCAB, (2,), generator=g)
    lens = torch.tensor(lengths, dtype=torch.int32)
    logits = {}
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            config = port_config("mha", dtype)
            params = port_params("mha", dtype=dtype)
            for tp in (False, True):
                pools = paged.init_page_pools(config, 2 * cover, ps, "cpu")
                reduce = None
                if tp:
                    params_tp, pools = tp_serve.shard_serving_state(params, pools, config,
                                                                    mesh)
                    reduce = tp_serve.model_all_reduce(mesh)
                p = params_tp if tp else params
                paged.paged_prefill_chunk(p, pools, tables, prompts, lens, config, 0, cover,
                                          emit=False, reduce=reduce)
                out, _ = paged._decode_core(p, pools, tables, tok, lens.long(), config,
                                            reduce=reduce)
                logits[(dtype, tp)] = out.float()
    f32 = logits[(torch.float32, False)]

    def err(a, b):
        d = a - b
        return d.abs().max().item(), d.square().mean().sqrt().item()

    return {"f32_tp": err(logits[(torch.float32, True)], f32),
            "bf16_tp": err(logits[(torch.bfloat16, True)], f32),
            "floor": err(logits[(torch.bfloat16, False)], f32),
            "scale": f32.abs().max().item()}


def s_collectives(ctx: Ctx) -> dict:
    """An all-reduce over the world and over each mesh axis."""
    from workloads_torch import distributed

    mesh = distributed.global_mesh(model=2, device_type="cpu")
    x = torch.full((3,), float(ctx.rank + 1))
    torch.distributed.all_reduce(x)
    y = torch.full((2,), float(ctx.rank + 1))
    torch.distributed.all_reduce(y, group=mesh.get_group("model"))
    z = torch.full((2,), float(ctx.rank + 1))
    torch.distributed.all_reduce(z, group=mesh.get_group("data"))
    return {"world": x.tolist(), "model": y.tolist(), "data": z.tolist(),
            "shape": tuple(mesh.mesh.shape), "coords": list(mesh.get_coordinate())}


def s_meshes(ctx: Ctx) -> dict:
    """make_mesh's and global_mesh's rules on this world."""
    from workloads_torch import distributed
    from workloads_torch.train import make_mesh

    def shape(m):
        return dict(zip(m.mesh_dim_names, m.mesh.shape))

    out = {"default": shape(make_mesh(device_type="cpu")),
           "mp1": shape(make_mesh(model_parallel=1, device_type="cpu")),
           "too_many": _raises(lambda: make_mesh(ctx.world + 1, device_type="cpu")),
           "indivisible": _raises(lambda: make_mesh(model_parallel=3, device_type="cpu")),
           "global": shape(distributed.global_mesh(device_type="cpu")),
           "global_bad": _raises(lambda: distributed.global_mesh(data=3,
                                                                 device_type="cpu")),
           "global_model": _raises(lambda: distributed.global_mesh(model=3,
                                                                   device_type="cpu"))}
    if ctx.world == 4:
        out["dp2"] = shape(make_mesh(4, model_parallel=2, device_type="cpu"))
    return out


def s_last_rank_dies(ctx) -> str:
    """The harness's own check: the last rank prints a line and kills
    itself with SIGKILL; the others return."""
    import signal

    if ctx.rank == ctx.world - 1:
        print(f"rank {ctx.rank} about to die", flush=True)
        os.kill(os.getpid(), signal.SIGKILL)
    return "alive"


SCENARIOS = {f"case:{name}": _engine_scenario(name) for name in CASES}
SCENARIOS.update({"validations": s_validations, "param_specs": s_param_specs,
                  "generate": s_generate, "programs": s_programs, "bf16_step": s_bf16_step,
                  "collectives": s_collectives, "meshes": s_meshes,
                  "last_rank_dies": s_last_rank_dies})


def world_scenarios(world: int) -> list[str]:
    """The scenarios of a world of ``world`` ranks, in order."""
    names = [f"case:{n}" for n, c in CASES.items() if world in c.meshes]
    names += ["validations", "param_specs", "generate", "bf16_step"]
    return names + (["programs"] if world == 2 else [])


def _dump(path: str, obj) -> None:
    """Pickle ``obj`` to ``path`` atomically: a temporary name, then
    ``os.replace``."""
    part = f"{path}.part"
    with open(part, "wb") as f:
        pickle.dump(obj, f)
    os.replace(part, path)


def rank_main(rank: int, world: int, store: str, out_dir: str, names: list,
              module: str = __name__) -> None:
    """One rank: send stdout and stderr to ``<out_dir>/rank<rank>.log``,
    join the gloo world, run ``names`` from ``module``'s SCENARIOS, write
    each result as ``<out_dir>/<index>.<rank>.pkl``."""
    import importlib

    log = open(os.path.join(out_dir, f"rank{rank}.log"), "w", buffering=1)
    sys.stdout.flush()
    sys.stderr.flush()
    os.dup2(log.fileno(), 1)
    os.dup2(log.fileno(), 2)
    faulthandler.enable(file=log, all_threads=True)
    print(f"rank {rank}/{world} pid {os.getpid()}: {len(names)} scenarios", flush=True)
    torch.set_num_threads(1)
    scenarios = importlib.import_module(module).SCENARIOS
    torch.distributed.init_process_group(
        "gloo", store=torch.distributed.FileStore(store, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=120))
    ctx = Ctx(rank, world)
    try:
        for i, name in enumerate(names):
            t0 = time.perf_counter()
            try:
                result = ("ok", scenarios[name](ctx))
            except Exception:  # noqa: BLE001 — written for the test to report
                result = ("error", traceback.format_exc())
            secs = time.perf_counter() - t0
            print(f"{time.strftime('%H:%M:%S')} {name}: {result[0]} in {secs:.1f} s",
                  flush=True)
            _dump(os.path.join(out_dir, f"{i}.{rank}.pkl"), (name, secs, result))
            if result[0] == "error":
                print(result[1], flush=True)
                os._exit(1)  # the other ranks' collectives time out
    finally:
        torch.distributed.destroy_process_group()


class World(dict):
    """``run_world``'s results, {name: per-rank results}, with how the
    world ended: ``exitcodes`` per rank (negative: the signal that ended
    it; None: still running when killed at the timeout), ``timed_out``,
    the tail of each rank's log, and ``error``, the traceback of an
    exception that stopped the world's runner itself."""

    def __init__(self, results=(), exitcodes=(), timed_out=False, logs=None, error=None):
        super().__init__(results)
        self.exitcodes = list(exitcodes)
        self.timed_out = timed_out
        self.logs = logs or {}
        self.error = error

    def report(self) -> str:
        if self.error is not None:
            return f"the world's runner raised:\n{self.error}"
        lines = [f"exit codes {self.exitcodes}"
                 + (" (killed at the world's timeout)" if self.timed_out else "")]
        for rank, tail in sorted(self.logs.items()):
            lines.append(f"--- rank {rank} log tail ---\n{tail}")
        return "\n".join(lines)


def _tail(path: str, n: int = 4000) -> str:
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            f.seek(max(f.tell() - n, 0))
            return f.read().decode(errors="replace")
    except OSError as exc:
        return f"(no log: {exc})"


def run_world(world: int, names: list, tmp: str, timeout: float = 600.0,
              module: str = __name__) -> World:
    """Run ``names`` on a ``world``-rank gloo CPU world; returns a
    ``World`` of {name: [per-rank (seconds, ("ok", value) or ("error",
    text))]}, a name missing where its world died first, and a result
    file that cannot be read reported as that rank's error.  Every rank
    is stopped by the time this returns."""
    import torch.multiprocessing as mp

    os.makedirs(tmp, exist_ok=True)
    # A directory run before holds its store and results: neither may
    # leak into this world.
    for name in os.listdir(tmp):
        if name == "store" or name.endswith((".pkl", ".part", ".log")):
            os.remove(os.path.join(tmp, name))
    ctx = mp.get_context("spawn")
    store = os.path.join(tmp, "store")
    procs = [ctx.Process(target=rank_main, args=(r, world, store, tmp, list(names), module))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    killed = [False] * world
    try:
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.1))
    finally:
        for r, p in enumerate(procs):
            if p.is_alive():
                killed[r] = True
                p.kill()
                p.join(10)
    exitcodes = [None if k else p.exitcode for k, p in zip(killed, procs)]
    timed_out = any(killed)
    out = World(exitcodes=exitcodes, timed_out=timed_out,
                logs={r: _tail(os.path.join(tmp, f"rank{r}.log")) for r in range(world)})
    for i, name in enumerate(names):
        for r in range(world):
            path = os.path.join(tmp, f"{i}.{r}.pkl")
            if not os.path.exists(path):
                continue
            try:
                with open(path, "rb") as f:
                    _, secs, result = pickle.load(f)
            except Exception as exc:  # noqa: BLE001 — reported as the rank's failure
                secs, result = 0.0, ("error", f"unreadable result file {path}: {exc!r}")
            out.setdefault(name, [None] * world)[r] = (secs, result)
    return out


def run_worlds(tmp_path_factory, worlds, scenarios, timeout: float = 300.0,
               module: str = __name__) -> dict:
    """``run_world`` for each size in ``worlds``, side by side in threads
    (this process computes nothing meanwhile): {world: World}, with
    ``scenarios(world)`` the names a world runs.  The temporary
    directories are made first, one after the other: the first mktemp
    creates pytest's base directory, and two threads doing so at once
    race on it.  An exception in a thread becomes that world's
    ``World.error``, which every test of the world reports."""
    import threading

    tmps = {w: str(tmp_path_factory.mktemp(f"world{w}")) for w in worlds}
    out = {}

    def run(world):
        try:
            out[world] = run_world(world, scenarios(world), tmps[world], timeout, module)
        except Exception:  # noqa: BLE001 — every test of the world reports it
            out[world] = World(error=traceback.format_exc())

    threads = [threading.Thread(target=run, args=(w,)) for w in worlds]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


def result_of(results: World, name: str, rank: int = 0):
    """A scenario's value on ``rank``, or a failure naming what happened:
    the scenario's traceback, else how each rank of the world ended and
    the tail of its log."""
    import pytest

    if getattr(results, "error", None) is not None:
        pytest.fail(results.report())
    runs = results.get(name)
    if runs is None or runs[rank] is None:
        pytest.fail(f"scenario {name} has no result on rank {rank}: its world ended first; "
                    f"{results.report()}")
    _, (kind, value) = runs[rank]
    if kind == "error":
        pytest.fail(f"scenario {name} raised on rank {rank}:\n{value}\n{results.report()}")
    return value
