"""The port's int8 weight-only quantization (workloads_torch/quant.py and
the int8 branch of ``model.weight``) on the CPU.

torch, numpy and the port only, so it runs in the fast tier.  The JAX
package's ``quantize``, ``dequantize``, ``quantize_params`` and
``tree_bytes`` outputs are frozen in tests/test_torch_spec_golden.npz
(``quant/...``, written by ``write_spec_goldens()`` in
tests/test_torch_parity.py); the port must equal them bit for bit, in
float32 and in bfloat16, where the scale is computed in the weight's own
dtype before its cast to float32.  Then the JAX package's quantization
contracts (its tests/test_quant.py), ported, and the int8 read path:
a decode step with int8 weights equals the step with the weights
dequantized first, bit for bit.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tests.test_torch_golden import GOLDEN, params_to_torch, tiny_config
from tests.test_torch_spec import SPEC_CASE, SPEC_GOLDEN
from workloads_torch import prng
from workloads_torch import convert
from workloads_torch import generate as tgen
from workloads_torch import paged as tpaged
from workloads_torch.model import ModelConfig, init_params, weight
from workloads_torch.quant import (
    CONTRACTION_AXES,
    dequantize,
    is_quantized,
    quantize,
    quantize_params,
    tree_bytes,
)

# (name, shape, contraction axis): a [d, ff] product, wo's [H, hd, d]
# over (H, hd), and the fused [d, 3, H, hd] projection.
QUANT_SHAPES = (("dense", (64, 32), 0), ("wo", (4, 16, 64), (0, 1)),
                ("wqkv", (64, 3, 4, 16), 0))
BITS = {"f32": (torch.float32, np.uint32), "bf16": (torch.bfloat16, np.uint16)}


def quant_inputs() -> dict:
    """float32 matrices with a zero output channel each; the bf16 cases
    round them to bf16."""
    rng = np.random.default_rng(31)
    out = {}
    for name, shape, axis in QUANT_SHAPES:
        w = (0.02 * rng.standard_normal(shape)).astype(np.float32)
        zero = [slice(None)] * len(shape)
        zero[-1] = 0  # every output channel is on the last axis here
        w[tuple(zero)] = 0.0
        out[name] = w
    return out


def as_dtype(w: np.ndarray, name: str) -> torch.Tensor:
    return torch.from_numpy(w).to(BITS[name][0])


def bits(t: torch.Tensor) -> np.ndarray:
    """A tensor's raw bits (int8 stays int8)."""
    if t.dtype == torch.int8:
        return t.numpy()
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(np.uint16)
    return t.contiguous().view(torch.int32).numpy().view(np.uint32)


def port_quant(inp: dict, params: dict) -> dict:
    """The port's quantization outputs, keyed as the golden's."""
    out = {}
    for name, _, axis in QUANT_SHAPES:
        for dt in BITS:
            entry = quantize(as_dtype(inp[name], dt), axis)
            out[f"quant/{name}/{dt}/q8"] = bits(entry["q8"])
            out[f"quant/{name}/{dt}/scale"] = bits(entry["scale"])
            out[f"quant/{name}/{dt}/deq"] = bits(dequantize(entry, BITS[dt][0]))
    q = quantize_params(params)
    out["quant/params/unembed/q8"] = bits(q["unembed"]["q8"])
    out["quant/params/unembed/scale"] = bits(q["unembed"]["scale"])
    for i, layer in enumerate(q["layers"]):
        for k in CONTRACTION_AXES:
            if k in layer:
                out[f"quant/params/layers/{i}/{k}/q8"] = bits(layer[k]["q8"])
                out[f"quant/params/layers/{i}/{k}/scale"] = bits(layer[k]["scale"])
    out["quant/tree_bytes"] = np.asarray([tree_bytes(params), tree_bytes(q)], np.int64)
    return out


@pytest.fixture(scope="module")
def params():
    with np.load(GOLDEN) as f:
        flat = {k: f[k] for k in f.files if k.startswith("params_gqa")}
    return params_to_torch(flat, "params_gqa", torch.float32)


@pytest.fixture(scope="module")
def qgolden():
    with np.load(SPEC_GOLDEN) as f:
        return {k: f[k] for k in f.files if k.startswith("quant/")}


@pytest.fixture(scope="module")
def ported(params):
    return port_quant(quant_inputs(), params)


def test_quant_golden_keys_match(ported, qgolden):
    assert sorted(ported) == sorted(qgolden)


@pytest.mark.parametrize("name", [n for n, _, _ in QUANT_SHAPES])
@pytest.mark.parametrize("dt", sorted(BITS))
def test_quantize_matches_jax_bit_for_bit(ported, qgolden, name, dt):
    """q8, the float32 scale and the dequantized weight in the weight's
    dtype, bit for bit."""
    for part in ("q8", "scale", "deq"):
        key = f"quant/{name}/{dt}/{part}"
        np.testing.assert_array_equal(ported[key], qgolden[key], err_msg=key)


def test_quantize_params_matches_jax_bit_for_bit(ported, qgolden):
    """Every product weight of the tiny GQA tree and the unembed."""
    keys = [k for k in qgolden if k.startswith("quant/params/")]
    assert len(keys) == 2 + 2 * 2 * 5
    for key in keys:
        np.testing.assert_array_equal(ported[key], qgolden[key], err_msg=key)


def test_tree_bytes_matches_jax(ported, qgolden):
    np.testing.assert_array_equal(ported["quant/tree_bytes"], qgolden["quant/tree_bytes"])


def test_quantized_leaf_converts_from_jax_bit_for_bit(params):
    """``params_from_jax`` carries an int8 leaf across as int8 and
    float32 tensors, in a layer and as the unembed."""
    q = quantize_params(params)
    tree = {"embed": q["embed"].numpy(),
            "unembed": {k: v.numpy() for k, v in q["unembed"].items()},
            "layers": [{n: ({k: v.numpy() for k, v in w.items()} if is_quantized(w)
                            else w.numpy()) for n, w in layer.items()}
                       for layer in q["layers"]]}
    back = convert.params_from_jax(tree, device="cpu")
    for got, want in ((back["unembed"], q["unembed"]),
                      (back["layers"][1]["wo"], q["layers"][1]["wo"])):
        assert got["q8"].dtype == torch.int8 and got["scale"].dtype == torch.float32
        assert torch.equal(got["q8"], want["q8"]) and torch.equal(got["scale"], want["scale"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_decode_step_equals_the_dequantize_first_step(params, dtype):
    """One paged decode step with int8 weights equals the same step with
    every weight dequantized first (``weight`` reads either), bit for
    bit, logits and written pages."""
    from dataclasses import replace

    config = replace(tiny_config(SPEC_CASE), dtype=dtype)
    q = quantize_params(params)
    deq = {"embed": q["embed"], "unembed": dequantize(q["unembed"], torch.float32),
           "layers": [{n: (dequantize(w, dtype) if is_quantized(w) else w)
                       for n, w in layer.items()} for layer in q["layers"]]}
    tables = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    tok = torch.tensor([3, 17])
    pos = torch.tensor([5, 9])
    outs = []
    for tree in (q, deq):
        pools = tpaged.init_page_pools(config, 6, 4, device="cpu")
        with torch.inference_mode():
            logits, pools = tpaged.paged_decode_step(tree, pools, tables, tok, pos, config)
        outs.append((logits, pools))
    assert torch.equal(outs[0][0], outs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(outs[0][1], outs[1][1]))


# ---- the JAX package's quantization contracts (its tests/test_quant.py) --

CONFIG = ModelConfig(max_seq_len=32, n_layers=2, dtype=torch.float32)


def _init(config=CONFIG, seed=0):
    return init_params(config, prng.PRNGKey(seed, device="cpu"))


def test_roundtrip_error_bounded():
    w = torch.randn((64, 32), generator=torch.Generator().manual_seed(0))
    q = quantize(w)
    assert q["q8"].dtype == torch.int8
    # Symmetric int8: at most half a quantization step an element.
    err = (dequantize(q) - w).abs()
    assert bool((err <= q["scale"] / 2 + 1e-7).all())


def test_zero_channel_is_stable():
    w = torch.zeros((4, 8))
    w[0] = 1.0
    q = quantize(w, axis=-1)
    torch.testing.assert_close(dequantize(q), w, rtol=0, atol=0)


def test_quantize_params_tree_shape_and_bytes():
    params = _init()
    qparams = quantize_params(params)
    layer = qparams["layers"][0]
    assert is_quantized(layer["wqkv"]) and is_quantized(qparams["unembed"])
    assert not is_quantized(layer["ln1"])
    assert not is_quantized(qparams["embed"])
    # Product weights dominate this tree: int8 plus scales lands under
    # half the float32 original.
    assert tree_bytes(qparams) < 0.5 * tree_bytes(params)


def test_quantized_decode_logits_close_and_generate_runs():
    params = _init()
    qparams = quantize_params(params)
    tokens = torch.randint(0, CONFIG.vocab_size, (2, 8),
                           generator=torch.Generator().manual_seed(1))
    cache_f = tgen.init_kv_cache(CONFIG, 2, 8, device="cpu")
    cache_q = tgen.init_kv_cache(CONFIG, 2, 8, device="cpu")
    with torch.inference_mode():
        for pos in range(8):
            logits_f, cache_f = tgen.decode_step(params, cache_f, tokens[:, pos], pos, CONFIG)
            logits_q, cache_q = tgen.decode_step(qparams, cache_q, tokens[:, pos], pos, CONFIG)
            # int8 weights move logits by about the quantization noise,
            # far below the logits' own spread.
            denom = float(logits_f.abs().max()) or 1.0
            rel = float((logits_q - logits_f).abs().max()) / denom
            assert rel < 0.08, (pos, rel)
    out = tgen.generate(qparams, tokens[:, :4], CONFIG, max_new_tokens=6, device="cpu")
    assert out.shape == (2, 6)
    assert bool(((out >= 0) & (out < CONFIG.vocab_size)).all())


def test_gqa_tree_quantizes():
    gqa = ModelConfig(max_seq_len=32, n_layers=1, n_heads=4, n_kv_heads=2,
                      dtype=torch.float32)
    layer = quantize_params(_init(gqa))["layers"][0]
    assert is_quantized(layer["wq"]) and is_quantized(layer["wkv"])


def test_weight_reads_both_representations():
    w = torch.randn((8, 4), generator=torch.Generator().manual_seed(2))
    assert torch.equal(weight(w, torch.bfloat16), w.to(torch.bfloat16))
    q = quantize(w)
    assert torch.equal(weight(q, torch.float32), dequantize(q, torch.float32))
