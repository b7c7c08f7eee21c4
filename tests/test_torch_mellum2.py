"""The Mellum2 block on the port's serving paths, against the plain float32
reference of ``tests/torch_mellum2_ref.py``, on the CPU at a tiny
Mellum2-shaped size: ``head_dim`` apart from ``d_model / n_heads``, a
GQA group of 4, three sliding layers then a full one with a window
shorter than the sequences, YaRN on the full layer, and 8 SwiGLU experts
at top-3 with renormalised gates.

Every comparison is of logits.  Both sides compute in float32 from the
same weights; they differ in the order of sums and in where the port
rounds its float32 rotary angles (the reference computes them in
float64), so the port's logits lie within ``TOL`` of the reference's.
Each fault of the mechanism (one expert fewer, gates not renormalised,
full attention on the sliding layers, plain RoPE or no attention factor
on the full layer) moves them by more than ``TOL``.
"""

import dataclasses

import pytest
import torch

from tests import torch_mellum2_ref as ref
from workloads_torch import model as tmodel
from workloads_torch import moe as tmoe
from workloads_torch import multi_lora, pipeline, prng, quant, tp_serve
from workloads_torch.generate import decode_block, init_kv_cache
from workloads_torch.model import ModelConfig, Yarn, rope_inv_freq
from workloads_torch.paged import (
    PagePool,
    _rowwise_block_core,
    init_page_pools,
    paged_decode_step,
    paged_prefill,
    paged_prefill_chunk,
    table_array,
)
from workloads_torch.serve import ServeEngine

# The published full-attention rope entry (the config's rope_parameters).
FULL_ROPE = {"rope_type": "yarn", "rope_theta": 500000, "factor": 16,
             "original_max_position_embeddings": 8192, "beta_fast": 32, "beta_slow": 1,
             "attention_factor": 1.2772588722239782}

CFG = {
    "vocab_size": 128, "hidden_size": 48, "num_attention_heads": 8,
    "num_key_value_heads": 2, "head_dim": 16,
    "layer_types": ["sliding_attention"] * 3 + ["full_attention"],
    "sliding_window": 6,
    "rope_parameters": {"full_attention": FULL_ROPE,
                        "sliding_attention": {"rope_type": "default", "rope_theta": 500000}},
    "num_experts": 8, "num_experts_per_tok": 3, "moe_intermediate_size": 16,
    "norm_topk_prob": True, "rms_norm_eps": 1e-6, "max_seq_len": 64,
}
# Float32 on both sides, sums in another order and angles rounded to
# float32 on the port's side: logits of magnitude ~1-3 agree to ~1e-6.
TOL = 1e-5
PAGE = 4
LENGTHS = (20, 13)  # prompt lengths, both longer than the window
DECODE = 10  # decoded positions after each prompt


def port_config(cfg: dict = CFG, **over) -> ModelConfig:
    kinds = cfg["layer_types"]
    full = cfg["rope_parameters"]["full_attention"]
    config = ModelConfig(
        vocab_size=cfg["vocab_size"], d_model=cfg["hidden_size"],
        n_heads=cfg["num_attention_heads"], n_layers=len(kinds),
        d_ff=cfg["moe_intermediate_size"], max_seq_len=cfg["max_seq_len"],
        dtype=torch.float32, n_kv_heads=cfg["num_key_value_heads"],
        head_dim=cfg["head_dim"], rope_theta=float(full["rope_theta"]),
        layer_windows=tuple(cfg["sliding_window"] if k == "sliding_attention" else None
                            for k in kinds),
        layer_rope=tuple("yarn" if k == "full_attention" else "default" for k in kinds),
        yarn=Yarn(full["factor"], full["original_max_position_embeddings"],
                  full["beta_fast"], full["beta_slow"], full["attention_factor"]),
        n_routed_experts=cfg["num_experts"], experts_per_token=cfg["num_experts_per_tok"],
        d_expert=cfg["moe_intermediate_size"])
    return dataclasses.replace(config, **over)


def _unrenormalised_route(x, router, top_k):
    probs = torch.softmax(x.float() @ router.float(), dim=-1)
    top, experts = torch.topk(probs, top_k, dim=-1)
    return top.to(x.dtype), experts


# Each fault: the config it serves, and a stand-in for moe.route or None.
FAULTS = {
    "top_k_minus_one": (lambda c: dataclasses.replace(
        c, experts_per_token=c.experts_per_token - 1), None),
    "no_renormalisation": (lambda c: c, _unrenormalised_route),
    "full_attention_on_sliding_layers": (lambda c: dataclasses.replace(
        c, layer_windows=(None,) * c.n_layers), None),
    "plain_rope_on_full_layers": (lambda c: dataclasses.replace(
        c, layer_rope=("default",) * c.n_layers), None),
    "no_attention_factor": (lambda c: dataclasses.replace(
        c, yarn=dataclasses.replace(c.yarn, attention_factor=1.0)), None),
}


def expert_params(config: ModelConfig, seed: int = 7, device="cpu") -> dict:
    """A seeded tree for an expert config in its dtype on ``device``:
    every product weight normal x 0.1, so attention is peaked and routing
    decided at a test's width; norm gains 1."""
    g = torch.Generator().manual_seed(seed)
    d, h, kv, hd = config.d_model, config.n_heads, config.kv_heads, config.head_dim
    e, f = config.n_routed_experts, config.d_expert

    def draw(*shape):
        return (torch.randn(shape, generator=g) * 0.1).to(device, config.dtype)

    def ones():
        return torch.ones(d, device=device, dtype=config.dtype)

    return {
        "embed": draw(config.vocab_size, d), "unembed": draw(d, config.vocab_size),
        "layers": [{"ln1": ones(), "ln2": ones(), "wq": draw(d, h, hd),
                    "wkv": draw(d, 2, kv, hd), "wo": draw(h, hd, d),
                    "moe": {"router": draw(d, e), "w_gate_up": draw(e, d, 2 * f),
                            "w_down": draw(e, f, d)}}
                   for _ in range(config.n_layers)],
    }


@pytest.fixture(scope="module")
def setup():
    config = port_config()
    params = expert_params(config)
    g = torch.Generator().manual_seed(3)
    seqs = [torch.randint(0, CFG["vocab_size"], (n + DECODE,), generator=g) for n in LENGTHS]
    refs = [ref.logits(params, s, CFG) for s in seqs]
    return config, params, seqs, refs


def _gap(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max())


def _paged_logits(params, config, seqs, route: str) -> list[torch.Tensor]:
    """Each row's logits at its prompt's last position and at every
    decoded position after it, through the paged pools: the prompt by
    ``paged_prefill`` or page-aligned ``paged_prefill_chunk`` calls, then
    one ``paged_decode_step`` a position, fed the sequence's own tokens."""
    total = max(len(s) for s in seqs)
    ctrl = PagePool(n_pages=len(seqs) * (-(-total // PAGE)), page_size=PAGE)
    pools = init_page_pools(config, ctrl.n_pages, PAGE, device="cpu")
    tables = table_array([ctrl.allocate(i, total) for i in range(len(seqs))],
                         -(-total // PAGE), device="cpu")
    width = -(-max(LENGTHS) // (2 * PAGE)) * 2 * PAGE
    prompts = torch.zeros((len(seqs), width), dtype=torch.long)
    for i, n in enumerate(LENGTHS):
        prompts[i, :n] = seqs[i][:n]
    lengths = torch.tensor(LENGTHS)
    out = [[] for _ in seqs]
    if route == "prefill":
        first, pools = paged_prefill(params, pools, tables, prompts, lengths, config)
        for i in range(len(seqs)):
            out[i].append(first[i])
    else:
        step = 2 * PAGE
        for start in range(0, width, step):
            logits, pools = paged_prefill_chunk(
                params, pools, tables, prompts[:, start:start + step], lengths, config,
                start // PAGE, (start + step) // PAGE, emit=True)
            for i, n in enumerate(LENGTHS):
                if start <= n - 1 < start + step:
                    out[i].append(logits[i])
    for d in range(DECODE - 1):
        pos = lengths + d
        tok = torch.stack([s[p] for s, p in zip(seqs, pos.tolist())])
        logits, pools = paged_decode_step(params, pools, tables, tok, pos, config)
        for i in range(len(seqs)):
            out[i].append(logits[i])
    return [torch.stack(rows) for rows in out]


def _expected(refs) -> list[torch.Tensor]:
    return [r[n - 1:n - 1 + DECODE] for r, n in zip(refs, LENGTHS)]


def test_yarn_frequencies_at_the_published_sizes():
    """HF's ``_compute_yarn_parameters`` (with truncate) at head_dim 128,
    theta 500,000, factor 16 over 8,192: dims 18 to 35 ramp."""
    yarn = Yarn(16, 8192, 32, 1, 1.2772588722239782)
    f = rope_inv_freq(128, 500000.0, yarn)
    got = [float(f[i]) for i in (0, 20, 40, 63)]
    assert got == pytest.approx([1.0, 0.0147339, 1.71405e-05, 1.53446e-07], rel=1e-5)
    assert torch.allclose(f.double(), ref.inv_freq(128, FULL_ROPE), rtol=1e-6, atol=0)


@pytest.mark.parametrize("tokens", [1, 7, 64])
def test_the_expert_layer_is_the_loop_reference(setup, tokens):
    config, params, _, _ = setup
    x = torch.randn(tokens, config.d_model, generator=torch.Generator().manual_seed(tokens))
    for layer in params["layers"]:
        got = tmoe.expert_ffn(x, layer["moe"], config)
        assert _gap(got, ref.experts(x, layer["moe"], CFG)) < TOL


@pytest.mark.parametrize("route", ["prefill", "chunked"])
def test_paged_prefill_then_decode_is_the_reference(setup, route):
    config, params, seqs, refs = setup
    for got, want in zip(_paged_logits(params, config, seqs, route), _expected(refs)):
        assert got.shape == want.shape
        assert _gap(got, want) < TOL


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_each_fault_fails_the_tolerance(setup, fault, monkeypatch):
    """The paged path under a fault against the reference."""
    config, params, seqs, refs = setup
    faulted, route = FAULTS[fault]
    if route is not None:
        monkeypatch.setattr(tmoe, "route", route)
    got = _paged_logits(params, faulted(config), seqs, "prefill")
    assert max(_gap(g, w) for g, w in zip(got, _expected(refs))) > TOL


def test_decode_block_is_the_reference(setup):
    """The contiguous-cache path (``generate``): the whole sequence in one
    block, then its last position again as a one-token block."""
    config, params, seqs, refs = setup
    seq, want = seqs[0], refs[0]
    cache = init_kv_cache(config, 1, len(seq), device="cpu")
    logits, cache = decode_block(params, cache, seq[None, :-1], 0, config)
    assert _gap(logits[0], want[:-1]) < TOL
    logits, _ = decode_block(params, cache, seq[None, -1:], len(seq) - 1, config)
    assert _gap(logits[0, 0], want[-1]) < TOL


def test_the_rowwise_block_is_the_reference(setup):
    """The speculative verify's block forward: each row's next 4 tokens at
    its own depth over the paged pools its prompt was prefilled into."""
    config, params, seqs, refs = setup
    total = max(len(s) for s in seqs)
    ctrl = PagePool(n_pages=2 * (-(-total // PAGE)), page_size=PAGE)
    pools = init_page_pools(config, ctrl.n_pages, PAGE, device="cpu")
    tables = table_array([ctrl.allocate(i, total) for i in range(2)], -(-total // PAGE),
                         device="cpu")
    prompts = torch.zeros((2, max(LENGTHS)), dtype=torch.long)
    for i, n in enumerate(LENGTHS):
        prompts[i, :n] = seqs[i][:n]
    _, pools = paged_prefill(params, pools, tables, prompts, torch.tensor(LENGTHS), config)
    block = torch.stack([s[n:n + 4] for s, n in zip(seqs, LENGTHS)])
    logits, _ = _rowwise_block_core(params, pools, tables, block, torch.tensor(LENGTHS),
                                    config)
    for i, n in enumerate(LENGTHS):
        assert _gap(logits[i], refs[i][n:n + 4]) < TOL


@pytest.mark.parametrize("mode", [
    {}, {"pipelined": True}, {"superstep_k": 2}, {"pipelined": True, "superstep_k": 2},
    {"batched_admission": False}, {"prefill_budget": 8},
])
def test_the_engine_serves_the_references_tokens(setup, mode):
    """``ServeEngine`` on the CPU: every served token's reference logit
    lies within TOL of the reference's best at its position."""
    config, params, seqs, _ = setup
    engine = ServeEngine(params, config, slots=2, page_size=PAGE, chunk=4,
                         prompt_bucket=8, device="cpu", **mode)
    prompts = [s[:n].tolist() for s, n in zip(seqs, LENGTHS)] + [seqs[0][:7].tolist()]
    rids = [engine.submit(p, DECODE) for p in prompts]
    served = engine.run()
    for rid, prompt in zip(rids, prompts):
        tokens = served[rid]
        assert len(tokens) == DECODE
        logits = ref.logits(params, prompt + tokens[:-1], CFG)[len(prompt) - 1:]
        chosen = logits.gather(-1, torch.tensor(tokens)[:, None])[:, 0]
        assert float((logits.max(dim=-1).values - chosen).max()) < TOL


@pytest.mark.parametrize("superstep_k", [1, 2])
@pytest.mark.parametrize("moe_counters", [True, False])
def test_the_expert_counters_count_the_decode_steps(setup, superstep_k, moe_counters):
    """Two rows decode two whole chunks: every step routes 2 rows x 3
    experts in each of 4 layers (counted on the host), and each layer
    call reads between 3 and 6 experts (counted on the device only with
    ``moe_counters``)."""
    config, params, seqs, _ = setup
    chunk = 4
    engine = ServeEngine(params, config, slots=2, page_size=PAGE, chunk=chunk,
                         prompt_bucket=16, device="cpu", superstep_k=superstep_k,
                         moe_counters=moe_counters)
    for s in seqs:
        engine.submit(s[:12].tolist(), 1 + 2 * chunk)
    engine.run()
    steps = engine.chunks_run * chunk
    assert steps == 2 * chunk
    k, layers = config.experts_per_token, config.n_layers
    assert engine.moe_decode_assignments == steps * 2 * k * layers
    calls = steps * layers
    if moe_counters:
        assert k * calls <= engine.moe_decode_expert_reads <= 2 * k * calls
    else:
        assert engine._moe_reads is None and engine.moe_decode_expert_reads == 0


def test_the_expert_counters_need_an_expert_config(setup):
    config, params, _, _ = setup
    dense = dataclasses.replace(config, n_routed_experts=0, experts_per_token=0)
    with pytest.raises(ValueError, match="moe_counters"):
        ServeEngine(params, dense, slots=1, page_size=PAGE, device="cpu", moe_counters=True)


def test_the_expert_layer_has_its_spans_on_the_eager_path(setup):
    config, params, seqs, _ = setup
    cache = init_kv_cache(config, 1, 8, device="cpu")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        decode_block(params, cache, seqs[0][None, :8], 0, config)
    names = [e.name for e in prof.events()]
    assert names.count("moe.route") == config.n_layers
    assert names.count("moe.experts") == config.n_layers


@pytest.mark.parametrize("path", ["tensor_parallel", "lora", "int8", "pipeline", "forward"])
def test_paths_without_the_expert_layer_refuse_it(setup, path):
    config, params, seqs, _ = setup
    calls = {
        "tensor_parallel": lambda: tp_serve._check_tp(config, None),
        "lora": lambda: multi_lora.stack_adapters([[]], config),
        "int8": lambda: quant.quantize_params(params),
        "pipeline": lambda: pipeline.init_pipeline_params(config, 2, prng.PRNGKey(0, device="cpu")),
        "forward": lambda: tmodel.forward(params, seqs[0][None], config),
    }
    with pytest.raises(ValueError, match="expert"):
        calls[path]()


@pytest.mark.parametrize("over", [
    {"layer_windows": (4, None)}, {"layer_rope": ("default", "ntk", "default", "yarn")},
    {"layer_rope": ("yarn",) * 4, "yarn": None}, {"experts_per_token": 9},
    {"head_dim": 15}, {"layer_windows": (0, 4, 4, None)},
])
def test_the_config_refuses_a_broken_pattern(over):
    with pytest.raises(ValueError):
        port_config(**over)


def test_the_dense_config_keeps_its_derived_head_dim():
    config = ModelConfig(d_model=64, n_heads=4, attention_window=5)
    assert config.head_dim == 16 and config.plain_block
    assert config.windows == [5] and config.rope_kinds == ["default"]
    assert [config.layer_window(i) for i in range(config.n_layers)] == [5, 5]
    mellum = port_config()
    assert mellum.head_dim == 16 != mellum.d_model // mellum.n_heads
    assert mellum.windows == [6, None] and mellum.rope_kinds == ["default", "yarn"]
    assert not mellum.plain_block
