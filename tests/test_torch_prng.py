"""JAX's threefry keys in the port (workloads_torch/prng.py and the
threefry kernel's plain version, workloads_torch/ops/threefry.py) on the
CPU.

torch, numpy and the port only, so it runs in the fast tier.  Everything
is held to draws frozen from JAX 0.9 (``jax_threefry_partitionable``, its
default) in tests/test_torch_prng_golden.npz, written by
``write_prng_goldens()`` in tests/test_torch_parity.py, which also holds
the same checks live in the slow tier:

* ``PRNGKey``, ``split``, ``fold_in``, ``random_bits``, ``uniform`` and
  ``randint`` over a grid of keys and shapes: bit-identical (integer
  arithmetic, and a uniform scaled by a power of two, as every range the
  port draws is, rounds the same with or without XLA's FMA);
* ``normal``: within 4 ulp of JAX's value (``lax.erf_inv`` on the CPU and
  the port's copy of XLA's polynomial differ by up to 2 ulp; ``log1p``
  rounds otherwise); ``gumbel``: within 4 ulp of max(|value|, 1) (two
  logs, each within an ulp of XLA's);
* ``init_params`` (MHA and GQA), ``lora_init`` through
  ``synthetic_adapters`` and ``init_moe_model_params`` from the seed:
  every leaf within 4 ulp of JAX's, the same tree;
* the serve CLI's prompts from ``PRNGKey(7)``: identical;
* the tiny float32 engine built from ``PRNGKey(0)`` alone, sampling at
  the CLI's defaults (temperature 0.8, top_k 50, top_p 0.95) under
  ``rng=PRNGKey(42)``: token for token JAX's streams at the defaults,
  serial admission, ``superstep_k=4, pipelined``, and sampled
  speculation with the int8 self-draft (spec on, ``spec_lookahead=2``,
  ``spec_superstep_k=2, pipelined``), and ``generate``/``serve_batch``
  sampled under ``PRNGKey(3)``.  A stream may part from JAX's only at a
  near-tie: where the port's draw of that token had the JAX token second
  and the two Gumbel-perturbed float32 values within ``FLIP_SHARE`` of
  max(|top value|, 1) (the noise sits within a few ulp of JAX's, the
  logits within float32 summation order).
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from tests.test_torch_superstep import one_torch_thread  # noqa: F401
from workloads_torch import prng
from workloads_torch.ops import threefry as tf

PRNG_GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "test_torch_prng_golden.npz")

SEEDS = (0, 1, 7, 42, -1, 2**31 - 1, -(2**31))
# The keys of the grid: (name, seed, derivation), built alike on both sides.
KEYS = (("k0", 0, None), ("k42", 42, None), ("k0_split3_2", 0, ("split", 3, 2)),
        ("k42_fold5", 42, ("fold", 5)))
SHAPES = ((), (1,), (7,), (3, 5, 7), (4, 129))
SPLIT_NUMS = (2, 3, (2, 3))
FOLD_DATA = (0, 1, 2, 12345, 2**32 - 1)
F32_TINY = float(np.finfo(np.float32).tiny)
UNIFORM_RANGES = ((0.0, 1.0), (F32_TINY, 1.0),
                  (float(np.nextafter(np.float32(-1.0), np.float32(0.0))), 1.0), (-2.0, 2.0))
RANDINT_RANGES = ((0, 10), (1, 9), (0, 32768), (-5, 5), (3, 3), (0, 2**31 - 1))
NORMAL_ULPS = 4
GUMBEL_ULPS = 4
PARAM_ULPS = 4
CATEGORICAL_SHAPE = (6, 300)

# The sampled engine: the tiny float32 width, weights from PRNGKey(0).
TINY = dict(vocab_size=256, d_model=64, n_heads=4, n_layers=2, d_ff=128, max_seq_len=64)
SAMPLE_KNOBS = dict(temperature=0.8, top_k=50, top_p=0.95)
ENGINE_KW = dict(slots=4, page_size=4, prompt_bucket=8, chunk=4, **SAMPLE_KNOBS)
ENGINE_SEED, GENERATE_SEED = 42, 3
MODES = {
    "defaults": ("plain", {}),
    "serial": ("plain", {"batched_admission": False}),
    "superstep4_piped": ("plain", {"superstep_k": 4, "pipelined": True}),
    "spec_int8": ("spec", {"gamma": 3}),
    "spec_int8_la2": ("spec", {"gamma": 3, "spec_lookahead": 2}),
    "spec_int8_super2_piped": ("spec", {"gamma": 3, "spec_superstep_k": 2, "pipelined": True}),
}
NEW_TOKENS = (12, 20, 7, 16, 9, 24, 5, 14)
# A parting is a near-tie: the port's top two perturbed values within this
# share of max(|top|, 1).
FLIP_SHARE = 2.0**-16
CLI_PROMPTS = dict(requests=12, prompt_len=24, vocab=32768)
ADAPTERS = dict(n=2, rank=4, seed=99)
MOE_EXPERTS = 2


def requests() -> list[tuple[list[int], int]]:
    rng = np.random.default_rng(5)
    return [([int(t) for t in rng.integers(0, TINY["vocab_size"], int(rng.integers(3, 13)))], n)
            for n in NEW_TOKENS]


def derive(p, name_seed_how, device="cpu"):
    """The grid key ``name_seed_how`` from package ``p`` (the port's
    ``prng`` or ``jax.random``)."""
    _, seed, how = name_seed_how
    key = p.PRNGKey(seed, device=device) if p is prng else p.PRNGKey(seed)
    if how is None:
        return key
    if how[0] == "split":
        return p.split(key, how[1])[how[2]]
    return p.fold_in(key, how[1])


def shape_id(shape) -> str:
    return "x".join(map(str, shape)) or "scalar"


def run_sampled(make_engine, mode: str) -> np.ndarray:
    """The sampled stream in ``mode`` on either engine
    (``make_engine(kind, **kw)``, kind "plain" or "spec"): tokens a
    request, -1 padded."""
    kind, kw = MODES[mode]
    engine = make_engine(kind, **ENGINE_KW, **kw)
    rids = [engine.submit(p, n) for p, n in requests()]
    done = engine.run()
    out = np.full((len(rids), max(NEW_TOKENS)), -1, np.int64)
    for i, rid in enumerate(rids):
        toks = [int(t) for t in done[rid]]
        out[i, :len(toks)] = toks
    return out


# ---- the port side --------------------------------------------------------


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def ulps(got: np.ndarray, want: np.ndarray, floor: float = 0.0) -> np.ndarray:
    """|got - want| in float32 ulps of max(|want|, floor)."""
    ref = np.maximum(np.abs(want.astype(np.float32)), np.float32(floor))
    return np.abs(got.astype(np.float64) - want.astype(np.float64)) / np.spacing(ref)


@pytest.fixture(scope="module")
def golden():
    with np.load(PRNG_GOLDEN) as f:
        return {k: f[k] for k in f.files}


def port_key(spec):
    return derive(prng, spec)


def tiny_config(n_kv_heads=None):
    from workloads_torch.model import ModelConfig

    return ModelConfig(**TINY, dtype=torch.float32, n_kv_heads=n_kv_heads)


def flat_tree(tree, prefix: str) -> dict:
    """{path: array} over a nested dict/list tree."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flat_tree(v, f"{prefix}/{k}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flat_tree(v, f"{prefix}/{i}"))
    else:
        out[prefix] = np.asarray(tree)
    return out


def tree_leaf_kept(name: str) -> bool:
    """Which leaves the golden keeps: the MHA tree and the adapters whole;
    of the GQA tree its own projections, of the MoE model its experts
    (their other leaves share MHA's keys)."""
    if name.startswith("params/gqa/"):
        return name.endswith(("/wq", "/wkv"))
    if name.startswith("moe/"):
        return "/moe/" in name
    return True


def port_trees() -> dict:
    """The port's seeded trees, flat: init_params (MHA, GQA), the
    synthetic adapters and the MoE model."""
    from workloads_torch.model import init_params
    from workloads_torch.moe import MoEConfig, init_moe_model_params
    from workloads_torch.multi_lora import synthetic_adapters

    key = prng.PRNGKey(0, device="cpu")
    out = {}
    out.update(flat_tree(_tree_np(init_params(tiny_config(), key)), "params/mha"))
    out.update(flat_tree(_tree_np(init_params(tiny_config(2), key)), "params/gqa"))
    out.update(flat_tree(_tree_np(synthetic_adapters(
        tiny_config(), ADAPTERS["n"], rank=ADAPTERS["rank"], seed=ADAPTERS["seed"],
        device="cpu")), "adapters"))
    out.update(flat_tree(_tree_np(init_moe_model_params(tiny_config(), MoEConfig(MOE_EXPERTS),
                                                        key)), "moe"))
    return out


def _tree_np(tree):
    if isinstance(tree, dict):
        return {k: _tree_np(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_np(v) for v in tree]
    return _np(tree)


class Recorder:
    """Wraps ``prng.categorical`` and keeps, for every draw, each row's
    top two Gumbel-perturbed values (indices and gap), so a parting can be
    traced to the draw that made it."""

    def __init__(self):
        self.draws = []
        self.inner = prng.categorical

    def __call__(self, key, logits):
        noise = prng.gumbel(key, logits.shape[key.ndim - 1:])
        top = torch.topk((noise + logits).reshape(-1, logits.shape[-1]), 2, dim=-1)
        self.draws.append((_np(top.indices), _np(top.values)))
        return self.inner(key, logits)

    def near_tie(self, picked: int, other: int) -> float | None:
        """The smallest gap, as a share of max(|top|, 1), among draws whose
        top two were (picked, other); None if there was none."""
        best = None
        for idx, val in self.draws:
            hit = (idx[:, 0] == picked) & (idx[:, 1] == other)
            if hit.any():
                share = ((val[hit, 0] - val[hit, 1])
                         / np.maximum(np.abs(val[hit, 0]), 1.0)).min()
                best = share if best is None else min(best, share)
        return best


def port_engine_factory(params, config):
    from workloads_torch.quant import quantize_params
    from workloads_torch.serve import ServeEngine

    draft = {}

    def make(kind: str, **kw):
        if kind == "spec":
            draft.setdefault("p", quantize_params(params))
            kw.update(draft_params=draft["p"], draft_config=config)
        return ServeEngine(params, config, device="cpu",
                           rng=prng.PRNGKey(ENGINE_SEED, device="cpu"), **kw)

    return make


@pytest.fixture(scope="module")
def seeded_params():
    from workloads_torch.model import init_params

    config = tiny_config()
    return init_params(config, prng.PRNGKey(0, device="cpu")), config


def hold_streams(got: np.ndarray, want: np.ndarray, recorder: Recorder, label: str):
    """Equal streams, or first partings each at a recorded near-tie."""
    assert got.shape == want.shape, label
    for i, (g, w) in enumerate(zip(got, want)):
        if (g == w).all():
            continue
        pos = int(np.argmax(g != w))
        share = recorder.near_tie(int(g[pos]), int(w[pos]))
        assert share is not None and share <= FLIP_SHARE, (
            f"{label}: request {i} parts from JAX at token {pos} ({g[pos]} against "
            f"{w[pos]}), top-two gap share {share} (limit {FLIP_SHARE}): not a near-tie")


# ---- keys and draws -------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_words_equal_jax(golden, seed):
    assert (_np(prng.PRNGKey(seed, device="cpu")) == golden[f"seed/{seed}"]).all()


def test_prngkey_refuses_a_seed_past_int32():
    with pytest.raises(OverflowError):
        prng.PRNGKey(2**31, device="cpu")


@pytest.mark.parametrize("spec", KEYS, ids=[k[0] for k in KEYS])
def test_grid_key_equals_jax(golden, spec):
    assert (_np(port_key(spec)) == golden[f"{spec[0]}/key"]).all()


@pytest.mark.parametrize("num", SPLIT_NUMS, ids=str)
@pytest.mark.parametrize("spec", KEYS, ids=[k[0] for k in KEYS])
def test_split_bit_identical(golden, spec, num):
    got = _np(prng.split(port_key(spec), num))
    assert (got == golden[f"{spec[0]}/split/{num}"]).all()


@pytest.mark.parametrize("data", FOLD_DATA)
@pytest.mark.parametrize("spec", KEYS, ids=[k[0] for k in KEYS])
def test_fold_in_bit_identical(golden, spec, data):
    want = golden[f"{spec[0]}/fold/{data}"]
    assert (_np(prng.fold_in(port_key(spec), data)) == want).all()


@pytest.mark.parametrize("shape", SHAPES, ids=shape_id)
@pytest.mark.parametrize("spec", KEYS, ids=[k[0] for k in KEYS])
def test_random_bits_bit_identical(golden, spec, shape):
    got = _np(prng.random_bits(port_key(spec), shape))
    assert got.shape == shape
    assert (got == golden[f"{spec[0]}/bits/{shape_id(shape)}"].astype(np.int64)).all()


@pytest.mark.parametrize("bounds", UNIFORM_RANGES, ids=str)
@pytest.mark.parametrize("shape", SHAPES, ids=shape_id)
@pytest.mark.parametrize("spec", KEYS, ids=[k[0] for k in KEYS])
def test_uniform_bit_identical(golden, spec, shape, bounds):
    got = _np(prng.uniform(port_key(spec), shape, *bounds))
    want = golden[f"{spec[0]}/uniform/{bounds}/{shape_id(shape)}"]
    assert got.dtype == np.float32 and got.shape == shape
    assert (got.view(np.int32) == want.view(np.int32)).all()


@pytest.mark.parametrize("bounds", RANDINT_RANGES, ids=str)
@pytest.mark.parametrize("shape", SHAPES, ids=shape_id)
@pytest.mark.parametrize("spec", KEYS, ids=[k[0] for k in KEYS])
def test_randint_bit_identical(golden, spec, shape, bounds):
    got = _np(prng.randint(port_key(spec), shape, *bounds))
    assert got.dtype == np.int32 and got.shape == shape
    assert (got == golden[f"{spec[0]}/randint/{bounds}/{shape_id(shape)}"]).all()


@pytest.mark.parametrize("shape", SHAPES, ids=shape_id)
@pytest.mark.parametrize("spec", KEYS, ids=[k[0] for k in KEYS])
def test_normal_within_4_ulp(golden, spec, shape):
    got = _np(prng.normal(port_key(spec), shape))
    want = golden[f"{spec[0]}/normal/{shape_id(shape)}"]
    assert got.shape == shape and np.isfinite(got).all()
    assert (ulps(got, want) <= NORMAL_ULPS).all()


@pytest.mark.parametrize("shape", SHAPES, ids=shape_id)
@pytest.mark.parametrize("spec", KEYS, ids=[k[0] for k in KEYS])
def test_gumbel_within_4_ulp_of_its_scale(golden, spec, shape):
    got = _np(prng.gumbel(port_key(spec), shape))
    want = golden[f"{spec[0]}/gumbel/{shape_id(shape)}"]
    assert got.shape == shape and np.isfinite(got).all()
    assert (ulps(got, want, floor=1.0) <= GUMBEL_ULPS).all()


def test_batched_split_is_jax_vmap(golden):
    keys = prng.split(prng.PRNGKey(0, device="cpu"), 4)
    assert (_np(prng.split(keys, 5)) == golden["vmap/split"]).all()


@pytest.mark.parametrize("spec", KEYS, ids=[k[0] for k in KEYS])
def test_categorical_equals_jax(golden, spec):
    logits = torch.from_numpy(golden["categorical/logits"])
    assert (_np(prng.categorical(port_key(spec), logits))
            == golden[f"{spec[0]}/categorical"]).all()


def test_categorical_over_a_batch_of_keys_is_jax_vmap(golden):
    logits = torch.from_numpy(golden["categorical/logits"])
    keys = prng.split(prng.PRNGKey(42, device="cpu"), logits.shape[0])
    assert (_np(prng.categorical(keys, logits)) == golden["vmap/categorical"]).all()


# ---- the kernel's plain version -------------------------------------------


def test_threefry_modes_agree_with_each_other():
    """The plain version's three outputs are one hash: bits are the pair's
    xor, uniforms the bits' mantissa trick."""
    keys = prng.split(prng.PRNGKey(9, device="cpu"), 3)
    pair = tf.threefry(keys, 50, mode="pair", base=7)
    bits = tf.threefry(keys, 50, mode="bits", base=7)
    uni = tf.threefry(keys, 50, mode="uniform", base=7)
    assert (bits == pair[..., 0] ^ pair[..., 1]).all()
    want = (((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0)
    assert torch.equal(uni, want)
    assert pair.shape == (3, 50, 2) and bits.dtype == torch.int64


def test_threefry_refuses_what_it_does_not_take():
    key = prng.PRNGKey(0, device="cpu")
    with pytest.raises(ValueError, match="mode"):
        tf.threefry(key[None], 4, mode="words")
    with pytest.raises(ValueError, match=r"\[n_keys, 2\]"):
        tf.threefry(key, 4, mode="bits")
    with pytest.raises(ValueError, match="counters"):
        tf.threefry(key[None], 4, mode="bits", base=-1)
    with pytest.raises(TypeError, match="PRNG key"):
        prng.split(key.to(torch.int32))


def test_a_fake_key_draws_shapes_only():
    """Under FakeTensorMode (a checkpoint's abstract restore target) the
    draws keep their shapes and compute nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(allow_non_fake_inputs=True):
        key = prng.PRNGKey(0, device="cpu")
        assert prng.normal(key, (3, 4)).shape == (3, 4)
        assert prng.split(key, 5).shape == (5, 2)


# ---- seeded trees, prompts and streams ------------------------------------


def test_seeded_trees_are_jaxs_within_4_ulp(golden):
    got = port_trees()
    for prefix in ("params/mha", "params/gqa", "adapters", "moe"):
        mine = sorted(k for k in got if k.startswith(prefix + "/"))
        assert mine == golden[f"treekeys/{prefix}"].tolist(), prefix
    want = {k[len("tree/"):]: v for k, v in golden.items() if k.startswith("tree/")}
    assert sorted(want) == sorted(k for k in got if tree_leaf_kept(k))
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert (ulps(g, w) <= PARAM_ULPS).all(), (name, ulps(g, w).max())


def test_cli_prompts_equal_jax(golden):
    from workloads_torch.serve import cli_prompts

    got = cli_prompts(**CLI_PROMPTS)
    lengths = golden["cli/lengths"]
    assert [len(p) for p in got] == list(lengths)
    assert np.concatenate([np.asarray(p) for p in got]).tolist() == golden["cli/tokens"].tolist()


@pytest.mark.parametrize("mode", MODES)
def test_sampled_engine_from_the_seed_follows_jax(golden, seeded_params, monkeypatch, mode):
    params, config = seeded_params
    recorder = Recorder()
    monkeypatch.setattr(prng, "categorical", recorder)
    got = run_sampled(port_engine_factory(params, config), mode)
    hold_streams(got, golden[f"stream/{mode}"], recorder, mode)


def test_sampled_generate_and_serve_batch_follow_jax(golden, seeded_params, monkeypatch):
    from workloads_torch.generate import generate
    from workloads_torch.paged import PagePool, init_page_pools
    from workloads_torch.serve import serve_batch

    params, config = seeded_params
    recorder = Recorder()
    monkeypatch.setattr(prng, "categorical", recorder)
    prompt = torch.from_numpy(golden["generate/prompt"])
    key = prng.PRNGKey(GENERATE_SEED, device="cpu")
    got = _np(generate(params, prompt, config, 10, rng=key, device="cpu", **SAMPLE_KNOBS))
    hold_streams(got, golden["generate/tokens"], recorder, "generate")
    ctrl = PagePool(64, 4)
    pools = init_page_pools(config, 64, 4, device="cpu")
    got, _ = serve_batch(params, config, prompt, 10, ctrl, pools, rng=key, **SAMPLE_KNOBS)
    hold_streams(_np(got), golden["serve_batch/tokens"], recorder, "serve_batch")

