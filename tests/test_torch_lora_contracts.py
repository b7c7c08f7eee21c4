"""The JAX package's contracts for LoRA, ported to the PyTorch port on
the CPU: its tests/test_lora.py (the fine-tune: zero-init identity,
frozen base, loss decrease, int8 base, the CLI on ``--device cpu``),
tests/test_multi_lora.py without its two tensor-parallel cases (stacking,
base rows, parity with the merged model, mixed batches, chunked prefill,
fan-out, salted prefix cache, speculation, validations), and the adapter
cases of test_batched_admission.py, test_disagg.py (the handoff under a
budget, supersteps and an adapter, between two engines: the fleet waits),
test_kv_hierarchy.py (the salt fuzz), test_superstep.py,
test_spec_superstep.py, test_spec_lookahead.py, test_spec_sampling.py
(held by distribution: sampled streams are not token-for-token with
``jax.random``) and test_serve_fuzz.py's adapter sweeps.

torch, numpy and the port only, so it runs in the fast tier.  Greedy
streams are held against ``generate`` over ``merge_lora``'d parameters
(float32, token for token).  The scripted runs against the JAX engine's
frozen counters are in tests/test_torch_lora.py.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tests.test_torch_superstep import one_torch_thread  # noqa: F401
from workloads_torch import prng
from workloads_torch.generate import filter_logits, generate
from workloads_torch.lora import lora_init, main, make_lora_train_step, merge_lora
from workloads_torch.model import ModelConfig, forward, init_params
from workloads_torch.multi_lora import stack_adapters, synthetic_adapters
from workloads_torch.paged import PagePool, RadixKV
from workloads_torch.quant import quantize_params
from workloads_torch.serve import ServeEngine
from workloads_torch.train import AdamW, synthetic_batch

CONFIG = ModelConfig(max_seq_len=64, n_layers=2, dtype=torch.float32)
DRAFT_CONFIG = ModelConfig(max_seq_len=64, n_layers=1, d_model=32, n_heads=2, d_ff=64,
                           dtype=torch.float32)
TRAIN_CONFIG = ModelConfig(max_seq_len=16, n_layers=2, dtype=torch.float32)


def _key(seed: int) -> torch.Tensor:
    return prng.PRNGKey(seed, device="cpu")


def _adapter(seed: int, rank: int = 4, scale: float = 0.3) -> list:
    return synthetic_adapters(CONFIG, 1, rank=rank, scale=scale, seed=seed,
                              device="cpu")["tenant-0"]


@pytest.fixture(scope="module")
def params():
    return init_params(CONFIG, _key(0))


@pytest.fixture(scope="module")
def adapters():
    return {"tenant-a": _adapter(1), "tenant-b": _adapter(2)}


@pytest.fixture(scope="module")
def draft():
    return init_params(DRAFT_CONFIG, _key(7))


def _engine(params, adapters, **kw):
    kw = {"slots": 2, "page_size": 4, "prompt_bucket": 8, "chunk": 4, **kw}
    return ServeEngine(params, CONFIG, device="cpu", adapters=adapters, **kw)


_MERGED: dict = {}


def _model_for(params, adapters, adapter):
    if adapter is None:
        return params
    key = (id(params), id(adapters[adapter]))
    if key not in _MERGED:
        _MERGED[key] = merge_lora(params, adapters[adapter], dtype=torch.float32)
    return _MERGED[key]


def _ref(model, prompt, new, config=CONFIG):
    return generate(model, torch.tensor([prompt]), config, new, device="cpu")[0].tolist()


# ---- tests/test_multi_lora.py ------------------------------------------


def test_stack_adapters_shape_and_base_row(adapters):
    stacked = stack_adapters([adapters["tenant-a"], adapters["tenant-b"]], CONFIG)
    assert len(stacked) == CONFIG.n_layers
    for entry in stacked:
        for ab in entry.values():
            assert ab["a"].shape[0] == 3  # base + 2 adapters
            assert not ab["a"][0].any() and not ab["b"][0].any()


def test_stack_adapters_validates_rank_and_targets(adapters):
    with pytest.raises(ValueError, match="same rank"):
        stack_adapters([adapters["tenant-a"], _adapter(3, rank=8)], CONFIG)
    other = _adapter(4)
    del other[0]["wqkv"]
    with pytest.raises(ValueError, match="same weights"):
        stack_adapters([adapters["tenant-a"], other], CONFIG)
    with pytest.raises(ValueError, match="at least one"):
        stack_adapters([], CONFIG)
    with pytest.raises(ValueError, match="layers"):
        stack_adapters([adapters["tenant-a"], adapters["tenant-b"][:1]], CONFIG)


def test_base_requests_match_plain_generate(params, adapters):
    """adapter=None rides the zero base entry: tokens are exactly the
    plain model's (the delta is an exact +0.0)."""
    engine = _engine(params, adapters)
    prompt = list(range(3, 12))
    rid = engine.submit(prompt, 10)
    assert engine.run()[rid] == _ref(params, prompt, 10)


def test_adapted_requests_match_merged_model(params, adapters):
    """Row-wise activation deltas equal the merged-weight model, and the
    two adapters genuinely diverge."""
    engine = _engine(params, adapters)
    prompt = [5, 3, 8, 2, 9, 1, 7]
    rids = {name: engine.submit(prompt, 12, adapter=name) for name in ("tenant-a", "tenant-b")}
    rid_base = engine.submit(prompt, 12)
    served = engine.run()
    for name, rid in rids.items():
        assert served[rid] == _ref(_model_for(params, adapters, name), prompt, 12), name
    assert served[rids["tenant-a"]] != served[rids["tenant-b"]]
    assert served[rid_base] != served[rids["tenant-a"]]
    assert engine.ctrl.used_pages == 0


def test_mixed_adapter_batch_matches_solo_runs(params, adapters):
    """Rows with different adapters in one batch emit what each request
    gets served alone: per-row gathers never leak across rows."""
    prompts = [([1, 2, 3, 4], "tenant-a"), ([1, 2, 3, 4], "tenant-b"), ([9, 8, 7], None),
               ([4, 4, 4, 4, 4], "tenant-a")]
    together = _engine(params, adapters, slots=4)
    rids = [together.submit(p, 8, adapter=a) for p, a in prompts]
    got = together.run()
    for rid, (p, a) in zip(rids, prompts):
        solo = _engine(params, adapters, slots=1)
        srid = solo.submit(p, 8, adapter=a)
        assert got[rid] == solo.run()[srid], (rid, a)


def test_chunked_prefill_long_prompt_with_adapter(params, adapters):
    engine = _engine(params, adapters)
    prompt = [int(t) for t in np.random.default_rng(7).integers(0, CONFIG.vocab_size, 21)]
    rid = engine.submit(prompt, 8, adapter="tenant-b")
    assert engine.run()[rid] == _ref(_model_for(params, adapters, "tenant-b"), prompt, 8)


def test_fanout_with_adapter(params, adapters):
    engine = _engine(params, adapters, slots=2)
    prompt = [2, 7, 1, 8, 2, 8]
    rids = engine.submit_fanout(prompt, 6, n_samples=2, adapter="tenant-a")
    served = engine.run()
    want = _ref(_model_for(params, adapters, "tenant-a"), prompt, 6)
    for rid in rids:
        assert served[rid] == want
    assert engine.prefills_run == 1


def test_prefix_cache_is_adapter_salted(params, adapters):
    """The same prompt under two adapters holds different k/v: cached
    pages never cross adapters, while repeats under one still hit."""
    engine = _engine(params, adapters, prefix_cache=True)
    prompt = list(range(1, 14))  # 3 full pages
    engine.submit(prompt, 6, adapter="tenant-a")
    engine.run()
    t1 = engine.prefill_tokens
    r2 = engine.submit(prompt, 6, adapter="tenant-b")
    served2 = engine.run()
    assert engine.prefill_tokens - t1 == len(prompt)
    t2 = engine.prefill_tokens
    r3 = engine.submit(prompt, 6, adapter="tenant-a")
    served3 = engine.run()
    assert engine.prefill_tokens - t2 < len(prompt)
    assert served3[r3] == _ref(_model_for(params, adapters, "tenant-a"), prompt, 6)
    assert served2[r2] == _ref(_model_for(params, adapters, "tenant-b"), prompt, 6)


@pytest.mark.parametrize("pipelined", [False, True])
def test_speculative_multi_lora_matches_merged_model(params, adapters, draft, pipelined):
    """The target verifies with each row's adapter (the draft guesses
    unadapted): every tenant gets its merged model's greedy tokens."""
    engine = ServeEngine(params, CONFIG, device="cpu", slots=2, page_size=4,
                         prompt_bucket=8, adapters=adapters, draft_params=draft,
                         draft_config=DRAFT_CONFIG, gamma=3, pipelined=pipelined)
    stream = [([1, 2, 3, 4], "tenant-a"), ([5, 6, 7], None), ([1, 2, 3, 4], "tenant-b")]
    rids = [engine.submit(p, 10, adapter=a) for p, a in stream]
    served = engine.run()
    for rid, (p, a) in zip(rids, stream):
        assert served[rid] == _ref(_model_for(params, adapters, a), p, 10), a
    assert engine.spec_rounds > 0
    assert engine.ctrl.used_pages == 0


def test_validations(params, adapters):
    with pytest.raises(ValueError, match="non-empty"):
        ServeEngine(params, CONFIG, device="cpu", adapters={})
    engine = _engine(params, adapters)
    from workloads_torch.errors import InvalidRequest

    with pytest.raises(InvalidRequest, match="unknown adapter"):
        engine.submit([1, 2], 4, adapter="nope")
    with pytest.raises(InvalidRequest, match="unknown adapter"):
        engine.submit_fanout([1, 2], 4, adapter="nope")
    assert not engine.pending
    plain = ServeEngine(params, CONFIG, device="cpu")
    with pytest.raises(InvalidRequest, match="base only"):
        plain.submit([1, 2], 4, adapter="tenant-a")


# ---- tests/test_lora.py ------------------------------------------------


def test_zero_init_is_identity():
    params = init_params(TRAIN_CONFIG, _key(0))
    adapters = lora_init(TRAIN_CONFIG, rank=4, key=prng.PRNGKey(1, device="cpu"))
    tokens = torch.arange(16).reshape(2, 8)
    base = forward(params, tokens, TRAIN_CONFIG)
    merged = forward(merge_lora(params, adapters), tokens, TRAIN_CONFIG)
    torch.testing.assert_close(merged, base, atol=1e-5, rtol=0)


def test_training_updates_only_adapters_and_loss_falls():
    params = init_params(TRAIN_CONFIG, _key(0))
    adapters = lora_init(TRAIN_CONFIG, rank=4, key=prng.PRNGKey(1, device="cpu"))
    optimizer = AdamW(lr=1e-2, mu_dtype=torch.float32)
    opt_state = optimizer.init(adapters)
    step = make_lora_train_step(TRAIN_CONFIG, optimizer, params)
    tokens = synthetic_batch(TRAIN_CONFIG, 8, seed=0, device="cpu")
    frozen_before = {k: v.clone() for k, v in params["layers"][0].items()}
    embed_before = params["embed"].clone()
    first = last = None
    for _ in range(20):
        adapters, opt_state, loss = step(adapters, opt_state, tokens)
        if first is None:
            first = float(loss)
        last = float(loss)
    assert last < first, (first, last)
    for k, v in frozen_before.items():  # the base is never a leaf
        assert torch.equal(params["layers"][0][k], v), k
        assert not params["layers"][0][k].requires_grad
    assert torch.equal(params["embed"], embed_before)
    assert float(adapters[0]["wqkv"]["b"].abs().max()) > 0


def test_int8_base_merge_and_step():
    params = init_params(TRAIN_CONFIG, _key(0))
    qbase = quantize_params(params)
    adapters = lora_init(TRAIN_CONFIG, rank=2, key=prng.PRNGKey(1, device="cpu"))
    tokens = torch.arange(16).reshape(2, 8)
    merged = forward(merge_lora(qbase, adapters), tokens, TRAIN_CONFIG)
    assert merged.shape == (2, 8, TRAIN_CONFIG.vocab_size)
    optimizer = AdamW(lr=1e-2, mu_dtype=torch.float32)
    step = make_lora_train_step(TRAIN_CONFIG, optimizer, qbase)
    q8 = qbase["layers"][0]["wqkv"]["q8"].clone()
    adapters, _, loss = step(adapters, optimizer.init(adapters),
                             synthetic_batch(TRAIN_CONFIG, 8, seed=0, device="cpu"))
    assert np.isfinite(float(loss))
    assert torch.equal(qbase["layers"][0]["wqkv"]["q8"], q8)


def test_gqa_targets_wq_wkv():
    gqa = ModelConfig(max_seq_len=16, n_layers=1, n_heads=4, n_kv_heads=2,
                      dtype=torch.float32)
    adapters = lora_init(gqa, rank=2, key=prng.PRNGKey(0, device="cpu"))
    assert set(adapters[0]) == {"wq", "wkv", "wo"}
    assert adapters[0]["wkv"]["a"].shape == (64, 2)
    assert adapters[0]["wkv"]["b"].shape == (2, 2 * 2 * 16)


def test_rank_validation():
    with pytest.raises(ValueError, match="rank"):
        lora_init(CONFIG, rank=0, key=prng.PRNGKey(0, device="cpu"))


def test_cli_entry(capsys):
    assert main(["--steps", "3", "--rank", "2", "--batch-size", "4", "--seq-len", "16",
                 "--device", "cpu"]) == 0
    assert main(["--steps", "3", "--rank", "2", "--batch-size", "4", "--seq-len", "16",
                 "--int8-base", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "int8_base=False" in out and "int8_base=True" in out


def test_merge_rejects_layer_count_mismatch():
    params = init_params(TRAIN_CONFIG, _key(0))
    adapters = lora_init(TRAIN_CONFIG, rank=2, key=prng.PRNGKey(1, device="cpu"))
    with pytest.raises(ValueError, match="mismatch"):
        merge_lora(params, adapters[:1])


def test_merge_dtype_follows_base():
    params = init_params(TRAIN_CONFIG, _key(0))
    bf16 = {"embed": params["embed"].bfloat16(), "unembed": params["unembed"].bfloat16(),
            "layers": [{k: v.bfloat16() for k, v in layer.items()} for layer in params["layers"]]}
    adapters = lora_init(TRAIN_CONFIG, rank=2, key=prng.PRNGKey(1, device="cpu"))
    assert merge_lora(bf16, adapters)["layers"][0]["wqkv"].dtype == torch.bfloat16
    assert merge_lora(quantize_params(params), adapters)["layers"][0]["wqkv"].dtype == \
        torch.float32


# ---- adapter cases of the other JAX engine tests -----------------------


def test_batched_matches_serial_multi_lora(params):
    """test_batched_admission.py: per-row adapter indices ride the sweep
    as data; every tenant gets its serial tokens, base rows in the same
    sweep as adapted ones included."""
    adapters = synthetic_adapters(CONFIG, 2, rank=4, seed=21, device="cpu")
    names = [None] + sorted(adapters)
    rng = np.random.default_rng(23)
    requests = [([int(t) for t in rng.integers(0, CONFIG.vocab_size, int(rng.integers(1, 20)))],
                 int(rng.integers(2, 10))) for _ in range(6)]
    out = {}
    for batched in (False, True):
        engine = _engine(params, adapters, slots=3, batched_admission=batched)
        rids = [engine.submit(p, n, adapter=names[i % 3]) for i, (p, n) in enumerate(requests)]
        served = engine.run()
        out[batched] = [served[r] for r in rids]
        assert engine.ctrl.used_pages == 0
    assert out[False] == out[True]
    for i, (p, n) in enumerate(requests):
        assert out[True][i] == _ref(_model_for(params, adapters, names[i % 3]), p, n)


def test_handoff_composes_with_budget_superstep_and_lora(params):
    """test_disagg.py at engine level: a prefill engine (prefill_budget,
    superstep_k) hands each prompt's pages to a decode engine under the
    request's adapter; the decode engine's streams equal one engine's
    serving the whole request, and adapted pages graft under their own
    salt."""
    adapters = {"tenant": synthetic_adapters(CONFIG, 1, rank=2, seed=5,
                                             device="cpu")["tenant-0"]}
    kw = dict(prefill_budget=8, superstep_k=2, prefix_cache=True, kv_offload=True)
    rng = np.random.default_rng(7)
    reqs = [([int(t) for t in rng.integers(0, CONFIG.vocab_size, int(rng.integers(9, 20)))], 6)
            for _ in range(6)]
    mixed = _engine(params, adapters, **kw)
    want = {}
    for i, (p, n) in enumerate(reqs):
        want[i] = mixed.submit(p, n, adapter="tenant" if i % 2 else None)
    served = mixed.run()
    src, dst = _engine(params, adapters, **kw), _engine(params, adapters, **kw)
    for i, (p, _) in enumerate(reqs):
        src.submit(p, 1, adapter="tenant" if i % 2 else None)
    src.run()
    grafted = 0
    for i, (p, _) in enumerate(reqs):
        a = "tenant" if i % 2 else None
        grafted += dst.import_kv(p, src.export_kv(p, adapter=a), adapter=a)
    assert grafted > 0
    rids = {i: dst.submit(p, n, adapter="tenant" if i % 2 else None)
            for i, (p, n) in enumerate(reqs)}
    got = dst.run()
    assert dst.prefix.reloads > 0
    for i in rids:
        assert got[rids[i]] == served[want[i]], i
    for e in (mixed, src, dst):
        e.close()
        assert e.ctrl.used_pages == 0


def test_radix_salt_partitions_lora_tenants_fuzz():
    """test_kv_hierarchy.py: under random insert/lookup interleavings a
    lookup under one salt never returns a page inserted under another."""
    rng = np.random.default_rng(17)
    ctrl = PagePool(n_pages=64, page_size=4)
    cache = RadixKV(ctrl)
    owner: dict[int, str] = {}
    salts = ["", "lora:1", "lora:2"]
    for i in range(40):
        salt = salts[int(rng.integers(3))]
        toks = [int(t) for t in rng.integers(0, 4, 8)]  # heavy overlap
        if rng.integers(2) and ctrl.free:
            seq = ("s", i)
            hit = cache.lookup(toks, 2, salt=salt)
            for p in hit:
                assert owner[p] == salt, (i, salt, owner[p])
            if hit:
                ctrl.adopt(seq, hit)
                ctrl.extend(seq, 8)
            else:
                if len(ctrl.free) < 2:
                    continue
                ctrl.allocate(seq, 8)
            cache.insert(toks, ctrl.tables[seq], salt=salt)
            for p in ctrl.tables[seq]:
                owner.setdefault(p, salt)
            ctrl.release(seq)
        else:
            for p in cache.lookup(toks, 2, salt=salt):
                assert owner[p] == salt, (i, salt, owner[p])
    cache.clear()
    assert ctrl.used_pages == 0


def test_engine_salts_park_export_and_import(params, adapters):
    """The engine's salts: a preempted adapted request parks under its
    adapter's salt (the resume hits; the base never does), and an
    exported adapted path grafts under the same adapter on another
    engine, where the base lookup of the same tokens misses."""
    engine = _engine(params, adapters, prefix_cache=True, kv_offload=True)
    prompt = list(range(1, 18))
    rid = engine.submit(prompt, 12, adapter="tenant-b")
    engine.step()
    engine.step()
    req = engine.preempt(rid)
    assert req is not None and req.adapter == "tenant-b"
    assert engine.pages_parked > 0
    assert engine._handoff_salt("tenant-b") == "lora:2" and engine._handoff_salt(None) == ""
    assert engine.prefix.match_depth(prompt, salt="lora:2") > 0
    assert engine.prefix.match_depth(prompt) == 0
    rid2 = engine.submit(req.prompt + req.tokens, 12 - len(req.tokens), adapter=req.adapter)
    rest = engine.run()[rid2]
    assert req.tokens + rest == _ref(_model_for(params, adapters, "tenant-b"), prompt, 12)
    blobs = engine.export_kv(prompt, adapter="tenant-b")
    other = _engine(params, adapters, prefix_cache=True, kv_offload=True)
    assert other.import_kv(prompt, blobs, adapter="tenant-b") == len(blobs)
    assert other.prefix.match_depth(prompt) == 0
    assert other.prefix.match_depth(prompt, salt="lora:2") == len(blobs)
    for e in (engine, other):
        e.close()
        assert e.ctrl.used_pages == 0


def test_superstep_fanout_prefix_and_lora_compose(params):
    """test_superstep.py: supersteps with the prefix cache, a fan-out
    group and an adapted request, each on its reference stream."""
    adapters = synthetic_adapters(CONFIG, 2, rank=4, scale=0.3, seed=3, device="cpu")
    streams = [([1, 2, 3, 4, 5], 9), ([7, 7, 7], 5), ([2, 9, 4, 1, 8, 8, 3], 12)]
    engine = _engine(params, adapters, superstep_k=2, prefix_cache=True)
    rids = [engine.submit(p, n) for p, n in streams]
    frids = engine.submit_fanout([6, 2, 6, 2, 6], 8, n_samples=2)
    name = sorted(adapters)[0]
    arid = engine.submit([1, 2, 3], 7, adapter=name)
    served = engine.run()
    for rid, (p, n) in zip(rids, streams):
        assert served[rid] == _ref(params, p, n)
    for rid in frids:
        assert served[rid] == _ref(params, [6, 2, 6, 2, 6], 8)
    assert served[arid] == _ref(_model_for(params, adapters, name), [1, 2, 3], 7)
    assert engine.ctrl.used_pages == engine.prefix.cached_pages


def test_spec_superstep_fanout_prefix_and_lora_compose(params, draft):
    """test_spec_superstep.py: the same with chained spec supersteps."""
    adapters = synthetic_adapters(CONFIG, 2, rank=4, scale=0.3, seed=3, device="cpu")
    streams = [([1, 2, 3, 4, 5], 9), ([7, 7, 7], 5), ([2, 9, 4, 1, 8, 8, 3], 12)]
    engine = _engine(params, adapters, spec_superstep_k=2, prefix_cache=True,
                     draft_params=draft, draft_config=DRAFT_CONFIG, gamma=3)
    rids = [engine.submit(p, n) for p, n in streams]
    frids = engine.submit_fanout([6, 2, 6, 2, 6], 8, n_samples=2)
    name = sorted(adapters)[0]
    arid = engine.submit([1, 2, 3], 7, adapter=name)
    served = engine.run()
    for rid, (p, n) in zip(rids, streams):
        assert served[rid] == _ref(params, p, n)
    for rid in frids:
        assert served[rid] == _ref(params, [6, 2, 6, 2, 6], 8)
    assert served[arid] == _ref(_model_for(params, adapters, name), [1, 2, 3], 7)
    assert engine.ctrl.used_pages == engine.prefix.cached_pages


def test_lookahead_composes_with_sampling_and_lora(params, draft):
    """test_spec_lookahead.py: lookahead x sampling x adapters keeps
    every budget, in-vocab tokens and a drained pool."""
    adapters = synthetic_adapters(CONFIG, 2, rank=4, scale=0.3, seed=3, device="cpu")
    engine = _engine(params, adapters, draft_params=draft, draft_config=DRAFT_CONFIG,
                     gamma=3, spec_lookahead=2, temperature=0.8, top_k=40,
                     rng=prng.PRNGKey(5, device="cpu"))
    names = [None] + sorted(adapters)
    rids = [engine.submit([1 + i, 2], 10, adapter=names[i % 3]) for i in range(4)]
    served = engine.run()
    for rid in rids:
        assert len(served[rid]) == 10
        assert all(0 <= t < CONFIG.vocab_size for t in served[rid])
    assert engine.ctrl.used_pages == 0


def test_sampling_spec_composes_with_lora_by_distribution(params, draft):
    """test_spec_sampling.py, by distribution: under spec sampling the
    ADAPTED target's filtered distribution drives acceptance, so the
    second token of an adapted request (drawn through a spec round, the
    draft unadapted) follows the merged model's filtered distribution
    given the first.  Each frequency within 4 standard errors (+1/n) of
    its probability; budgets and the drain hold per tenant."""
    adapters = synthetic_adapters(CONFIG, 2, rank=4, scale=0.3, seed=3, device="cpu")
    name = sorted(adapters)[1]
    temperature, top_k = 1.0, 3
    engine = _engine(params, adapters, slots=4, draft_params=draft,
                     draft_config=DRAFT_CONFIG, gamma=2, temperature=temperature,
                     top_k=top_k, rng=prng.PRNGKey(9, device="cpu"))
    prompt = [2, 4, 6]
    rids = [engine.submit(prompt, 2, adapter=name) for _ in range(400)]
    served = engine.run()
    assert engine.spec_rounds > 0 and engine.ctrl.used_pages == 0
    pairs = [served[r] for r in rids]
    assert all(len(p) == 2 for p in pairs)
    firsts = [p[0] for p in pairs]
    t1 = max(set(firsts), key=firsts.count)
    seconds = [p[1] for p in pairs if p[0] == t1]
    n = len(seconds)
    assert n >= 50
    merged = _model_for(params, adapters, name)
    with torch.no_grad():
        logits = forward(merged, torch.tensor([prompt + [t1]]), CONFIG)[0, -1]
    probs = torch.softmax(filter_logits(logits[None], temperature, top_k, 1.0), -1)[0]
    for tok in set(seconds) | set(torch.nonzero(probs).flatten().tolist()):
        p = float(probs[tok])
        f = seconds.count(tok) / n
        assert abs(f - p) <= 4 * (p * (1 - p) / n) ** 0.5 + 1 / n, (tok, f, p, n)


@pytest.mark.parametrize("seed", range(6))
def test_engine_feature_matrix_fuzz_with_adapters(params, draft, seed):
    """test_serve_fuzz.py's adapter sweeps: a random engine (slots, page
    size, prefix cache and host tier, pipelining, supersteps, budget,
    speculation with lookahead, chained supersteps or spec="auto") serving
    a random greedy stream over the base and two adapters, fan-out pairs
    and mid-stream eos included: every stream on its merged model's
    reference, the pool drained to the index's pins, and close() frees
    everything."""
    adapters = synthetic_adapters(CONFIG, 2, rank=4, scale=0.3, seed=3, device="cpu")
    rng = np.random.default_rng(seed)
    spec = bool(rng.integers(2))
    kw = dict(slots=int(rng.integers(1, 4)), page_size=int(rng.choice([4, 8])),
              prefix_cache=bool(rng.integers(2)), pipelined=bool(rng.integers(2)))
    kw["prompt_bucket"] = int(kw["page_size"] * rng.choice([2, 3]))
    if kw["prefix_cache"] and rng.integers(2):
        kw["kv_offload"] = True
        if rng.integers(2):
            kw["kv_host_pages"] = int(rng.integers(1, 9))
    kw["superstep_k"] = int(rng.choice([1, 1, 2, 4]))
    if rng.integers(2):
        kw["prefill_budget"] = int(rng.choice([1, kw["prompt_bucket"],
                                               2 * kw["prompt_bucket"]]))
    if spec:
        kw.update(draft_params=draft, draft_config=DRAFT_CONFIG, gamma=int(rng.integers(2, 5)))
        if rng.integers(2):
            kw["spec_superstep_k"] = int(rng.choice([1, 2, 4]))
        else:
            kw["spec_lookahead"] = int(rng.choice([1, 1, 2, 3]))
        if rng.integers(2):
            kw.update(spec="auto", spec_breakeven=float(rng.choice([0.0, 1.0, 1.5,
                                                                      kw["slots"]])))
    else:
        kw["chunk"] = int(kw["page_size"] * rng.choice([1, 2]))
    engine = ServeEngine(params, CONFIG, device="cpu", adapters=adapters, **kw)
    names = [None] + sorted(adapters)
    expected = {}
    for _ in range(int(rng.integers(3, 7))):
        plen = int(rng.integers(1, 25))
        prompt = [int(t) for t in rng.integers(0, CONFIG.vocab_size, plen)]
        new = int(rng.integers(1, min(24, CONFIG.max_seq_len - plen) + 1))
        adapter = names[int(rng.integers(len(names)))]
        if rng.integers(4) == 0 and new >= 2:
            for rid in engine.submit_fanout(prompt, new, n_samples=2, adapter=adapter):
                expected[rid] = (prompt, new, adapter, None)
        else:
            eos = None
            if rng.integers(4) == 0 and new >= 4:
                eos = _ref(_model_for(params, adapters, adapter), prompt, new)[new // 2]
            rid = engine.submit(prompt, new, eos_token=eos, adapter=adapter)
            expected[rid] = (prompt, new, adapter, eos)
    served = engine.run()
    assert set(served) == set(expected)
    for rid, (prompt, new, adapter, eos) in expected.items():
        ref = _ref(_model_for(params, adapters, adapter), prompt, new)
        got = list(served[rid])
        if eos is None:
            assert got == ref, (seed, rid, kw, adapter)
        else:
            ref = ref[: ref.index(eos) + 1]
            assert got[: len(ref)] == ref and eos in got, (seed, rid, kw, adapter, "eos")
    pinned = engine.prefix.cached_pages if engine.prefix is not None else 0
    assert engine.ctrl.used_pages == pinned, (seed, kw)
    engine.close()
    assert engine.ctrl.used_pages == 0
