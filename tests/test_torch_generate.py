"""The port's model and cached decoding (workloads_torch.model/generate),
torch only: the cached decode reproduces the dense forward, greedy
generate equals re-running the forward, sampling draws from the filtered
distribution, and entry points never fall back to the CPU on their own.
The cross-framework parity lives in test_torch_golden.py."""

import numpy as np
import pytest
import torch

import workloads_torch
from workloads_torch.generate import (
    decode_step,
    filter_logits,
    generate,
    init_kv_cache,
    sample_logits,
)
from workloads_torch.model import ModelConfig, cast_params, forward, init_params

CONFIG = ModelConfig(max_seq_len=32, n_layers=2, dtype=torch.float32)
# Same law and same function on both routes, float32: logits agree to
# summation order.
ATOL = 2e-4


def _params(config=CONFIG, seed=0):
    return init_params(config, torch.Generator().manual_seed(seed))


def _tokens(shape, seed=1, vocab=256):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, vocab, shape))


@pytest.mark.parametrize(
    "config",
    [
        CONFIG,
        ModelConfig(max_seq_len=32, n_layers=2, n_kv_heads=2, dtype=torch.float32),
        ModelConfig(max_seq_len=32, n_layers=2, attention_window=4,
                    dtype=torch.float32),
    ],
    ids=["mha", "gqa", "window"],
)
def test_cached_logits_match_dense_forward(config):
    """Feeding a sequence token by token through the cache reproduces the
    dense forward's logits at every position."""
    params = _params(config)
    tokens = _tokens((2, 10))
    dense = forward(params, tokens, config)
    cache = init_kv_cache(config, 2, 10, device="cpu")
    for pos in range(10):
        logits, cache = decode_step(params, cache, tokens[:, pos], pos, config)
        np.testing.assert_allclose(
            logits.numpy(), dense[:, pos].numpy(), atol=ATOL,
            err_msg=f"position {pos}",
        )


def test_generate_matches_step_by_step_dense():
    params = _params()
    prompt = _tokens((2, 5), seed=2)
    got = generate(params, prompt, CONFIG, max_new_tokens=6, device="cpu")
    assert got.shape == (2, 6)
    seq = prompt
    expected = []
    for _ in range(6):
        nxt = torch.argmax(forward(params, seq, CONFIG)[:, -1], dim=-1)
        expected.append(nxt)
        seq = torch.cat([seq, nxt[:, None]], dim=1)
    np.testing.assert_array_equal(got.numpy(), torch.stack(expected, 1).numpy())


def test_generate_rejects_bad_requests():
    params = _params()
    with pytest.raises(ValueError, match="exceeds"):
        generate(params, torch.zeros((1, 30), dtype=torch.long), CONFIG, 10,
                 device="cpu")
    with pytest.raises(ValueError, match="at least one token"):
        generate(params, torch.zeros((1, 0), dtype=torch.long), CONFIG, 4,
                 device="cpu")
    with pytest.raises(ValueError, match="Generator"):
        generate(params, torch.zeros((1, 3), dtype=torch.long), CONFIG, 4,
                 temperature=0.7, device="cpu")


def test_init_params_tree_and_law():
    """The JAX package's tree (MHA wqkv, GQA wq + wkv) with N(0, 0.02)
    dense leaves and unit norm gains."""
    params = _params(ModelConfig(d_model=64, n_heads=4, n_kv_heads=2))
    layer = params["layers"][0]
    assert set(layer) == {"ln1", "ln2", "wq", "wkv", "wo", "w_up", "w_down"}
    assert layer["wkv"].shape == (64, 2, 2, 16)
    assert set(_params()["layers"][0]) == {"ln1", "ln2", "wqkv", "wo", "w_up", "w_down"}
    big = params["embed"]
    assert abs(big.std().item() - 0.02) < 2e-3 and abs(big.mean().item()) < 2e-3
    assert torch.equal(layer["ln1"], torch.ones(64))
    assert cast_params(params, torch.bfloat16)["layers"][1]["w_up"].dtype == torch.bfloat16


def test_config_rejects_bad_values():
    with pytest.raises(ValueError, match="divisor"):
        ModelConfig(n_heads=4, n_kv_heads=3)
    with pytest.raises(ValueError, match="attention_window"):
        ModelConfig(attention_window=0)
    with pytest.raises(ValueError, match="dtype"):
        ModelConfig(dtype=torch.float16)


def test_filter_logits_truncations():
    logits = torch.from_numpy(
        np.random.default_rng(3).standard_normal((3, 50)).astype(np.float32)
    )
    kept_k = torch.isfinite(filter_logits(logits, 1.0, 5, 1.0)).sum(-1)
    assert kept_k.tolist() == [5, 5, 5]
    # Nucleus: the kept set is the smallest prefix of the sorted
    # distribution whose mass reaches p (the top token always kept).
    out = filter_logits(logits, 1.0, 0, 0.5)
    probs = torch.softmax(logits, -1)
    for row in range(3):
        kept = torch.isfinite(out[row])
        assert probs[row][kept].sum() >= 0.5
        dropped_top = probs[row][kept].min()
        assert probs[row][kept].sum() - dropped_top < 0.5
    # Disabled knobs keep everything; temperature scales.
    full = filter_logits(logits, 2.0, 0, 1.0)
    np.testing.assert_allclose(full.numpy(), (logits / 2.0).numpy())


def test_sample_logits_draws_from_the_filtered_distribution():
    """Empirical frequencies of a seeded draw match filter_logits'
    softmax (within 4 standard errors), and nothing outside the kept set
    is ever drawn."""
    logits = torch.tensor([[2.0, 1.0, 0.5, 0.0, -1.0, -3.0]])
    n = 20000
    gen = torch.Generator().manual_seed(11)
    draws = sample_logits(logits.expand(n, -1), gen, 1.0, 4, 1.0)
    counts = np.bincount(draws.numpy(), minlength=6) / n
    want = torch.softmax(filter_logits(logits, 1.0, 4, 1.0), -1)[0].numpy()
    assert counts[4:].sum() == 0
    se = np.sqrt(want * (1 - want) / n)
    assert np.all(np.abs(counts - want) <= 4 * se + 1e-12), (counts, want)
    # Greedy without a generator.
    assert sample_logits(logits, None, 1.0, 0, 1.0).tolist() == [0]


def test_entry_points_do_not_fall_back_to_cpu(monkeypatch):
    """Without a CUDA device and without an explicit device="cpu", the
    entry points raise instead of choosing the CPU on their own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        workloads_torch.default_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        workloads_torch.resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate(_params(), torch.zeros((1, 3), dtype=torch.long), CONFIG, 2)
    assert workloads_torch.resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("helper", ["init_kv_cache", "init_page_pools", "table_array",
                                    "params_from_jax"])
def test_buffer_helpers_do_not_default_to_cpu(monkeypatch, helper):
    """The helpers that allocate on a device take the entry points' rule:
    no device means cuda, and without CUDA they raise."""
    from workloads_torch import convert, paged

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {
        "init_kv_cache": lambda: init_kv_cache(CONFIG, 1, 4),
        "init_page_pools": lambda: paged.init_page_pools(CONFIG, 4, 4),
        "table_array": lambda: paged.table_array([[0, 1]], 2),
        "params_from_jax": lambda: convert.params_from_jax(
            {"embed": np.zeros((4, 2), np.float32),
             "unembed": np.zeros((2, 4), np.float32), "layers": []}),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[helper]()
