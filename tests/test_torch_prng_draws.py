"""The last draws on JAX's keys in the port, on the CPU: bf16 ``uniform``
and ``normal`` (workloads_torch/prng.py), the training batch
(``train.synthetic_batch``), the vision workload's tree and batches, and
perfbench's prompts and attention inputs; then the train, LoRA and vision
CLIs from their seeds alone, held to the losses JAX's CLIs print.

torch, numpy and the port only, so it runs in the fast tier.  Everything
is held to values frozen from JAX 0.9 in
tests/test_torch_prng_draws_golden.npz, written by
``write_prng_draws_goldens()`` in tests/test_torch_parity.py, whose slow
``test_prng_draws_match_jax_live`` draws them again.

Tolerances:

* bf16 ``uniform`` and ``normal``, ``synthetic_batch``, the vision images,
  ``_prompt`` in every seed form, ``_prompts`` and ``_rand_qkv``: bit for
  bit (integer arithmetic, and 128 bf16 values rounded op by op as XLA
  rounds them);
* the vision tree and probe templates: within 4 ulp (float32 ``normal``,
  as tests/test_torch_prng.py holds it);
* the vision labels: equal, but where the port's float32 top-two scores
  lie within ``LABEL_GAP_FLOOR`` (a 784-term float32 product over
  templates within 4 ulp moves a score by under 3e-4); the test prints
  how many labels part;
* the CLIs' losses, recorded a step: the step-1 loss within the bf16
  floor, the sum of JAX's and the port's distances of the bf16 loss from
  the float32 one on the same weights and batch (each implementation's
  bf16 loss lies within its own distance of the float32 loss, and the
  two float32 losses agree to float32 summation order), and each later
  loss within ``CLI_LATER_FACTOR`` times it (three AdamW steps carry
  the bf16 differences on).  A control runs the same CLI on the
  ``torch.Generator`` batch the port drew before, and fails it.
"""

from __future__ import annotations

import contextlib
import hashlib
import importlib
import io
import os
from dataclasses import replace

import numpy as np
import pytest
import torch

from tests.test_torch_prng import KEYS, derive, shape_id, ulps
from tests.test_torch_superstep import one_torch_thread  # noqa: F401
from workloads_torch import perfbench, prng, train, vision

PRNG_DRAWS_GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "test_torch_prng_draws_golden.npz")

BF16_SHAPES = ((), (7,), (3, 5, 7), (1, 64, 4, 32))
BF16_UNIFORM_RANGES = ((0.0, 1.0), (-2.0, 2.0), (0.3, 1.7))
BATCH_SEEDS = (0, 1, 2, 3)
BATCH_VOCABS = (50, 256, 32768)
BATCH_SIZE, BATCH_SEQ = 3, 16
VISION_SMALL = dict(image_size=8, conv1=4, conv2=8, hidden=16)
# The full tree's leaves, one value in every VISION_STRIDE of each.
VISION_STRIDE = 97
VISION_IMAGE_SEEDS = (0, 1, 2)
VISION_IMAGE_BATCH = 8
VISION_LABEL_BATCH = 256
TREE_ULPS = 4
LABEL_GAP_FLOOR = 1e-3
# perfbench's seed forms: JAX's PRNGKey(n), and fold_in(PRNGKey(a), b)
# for (a, b).
PROMPT_SEEDS = (1, 2, 5, 7, 11, 13, 77, 101, 100, 104, (11, 0), (11, 3), (11, 100), (11, 107),
                (23, 0), (23, 5), (23, 100), (23, 111))
PROMPT_LENGTH, PROMPT_VOCAB = 24, 32768
PROMPTS = dict(seed=1, batch=4, length=9, vocab=256)
QKV = dict(seq=64, heads=2, head_dim=32)
# The CLIs at small arguments, as JAX's run them (the port's add
# --device cpu), and what the step-1 loss's bf16 floor is taken on.
CLIS = {
    "train": ["--steps", "3", "--batch-size", "2", "--seq-len", "16"],
    "lora": ["--steps", "3", "--rank", "2", "--batch-size", "4", "--seq-len", "16"],
    "vision": ["--steps", "3", "--batch-size", "16"],
}
CLI_STEP_FACTORIES = {"train": "make_train_step", "lora": "make_lora_train_step",
                     "vision": "make_train_step"}
CLI_LATER_FACTOR = 4


def seed_id(seed) -> str:
    return str(seed) if isinstance(seed, int) else f"{seed[0]}_{seed[1]}"


def vision_leaf_sample(leaf: np.ndarray) -> np.ndarray:
    return leaf.reshape(-1)[::VISION_STRIDE]


def images_digest(images: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(images, np.float32).tobytes()).hexdigest()


def cli_losses(package: str, which: str, argv: list) -> tuple[list, str]:
    """``{package}.{which}.main(argv)`` with the step it builds wrapped to
    record each step's loss: (the losses as floats, what it printed).
    ``package`` is ``workloads_torch`` here; the golden's writer runs it
    on the JAX package in a process of its own."""
    mod = importlib.import_module(f"{package}.{which}")
    name = CLI_STEP_FACTORIES[which]
    build = getattr(mod, name)
    losses = []

    def recording(*args, **kwargs):
        step = build(*args, **kwargs)

        def run(*inputs):
            out = step(*inputs)
            losses.append(float(out[2]))
            return out

        return run

    printed = io.StringIO()
    setattr(mod, name, recording)
    try:
        with contextlib.redirect_stdout(printed):
            assert mod.main(argv) == 0
    finally:
        setattr(mod, name, build)
    return losses, printed.getvalue()


def generator_batch(config, batch_size, seed=0, device=None):
    """``train.synthetic_batch`` as the port drew it before JAX's keys:
    ``torch.randint`` under ``torch.Generator(device).manual_seed(seed)``."""
    g = torch.Generator(device).manual_seed(seed)
    return torch.randint(0, config.vocab_size, (batch_size, config.max_seq_len),
                         generator=g, device=device)


def generator_vision_batch(config, batch, seed=0, device=None):
    """``vision.synthetic_batch`` as the port drew it before JAX's keys."""
    images = torch.rand((batch, config.image_size, config.image_size, config.channels),
                        generator=torch.Generator(device).manual_seed(seed), device=device)
    templates = torch.randn(
        (config.image_size * config.image_size * config.channels, config.n_classes),
        generator=torch.Generator(device).manual_seed(vision.TEMPLATE_SEED), device=device)
    return images, torch.argmax((images.reshape(batch, -1) - 0.5) @ templates, dim=-1)


@torch.no_grad()
def port_bf16_floor(which: str) -> float:
    """The port's distance of the step-1 loss in bf16 from the float32 one,
    on the weights and batch the CLI starts from."""
    from workloads_torch.model import ModelConfig, init_params, loss_fn

    if which == "vision":
        config = vision.VisionConfig()
        params = vision.init_params(config, prng.PRNGKey(0, device="cpu"))
        images, labels = vision.synthetic_batch(config, 16, seed=1, device="cpu")
        return abs(float(vision.loss_fn(params, images, labels, config))
                   - float(vision.loss_fn(params, images, labels,
                                          replace(config, dtype=torch.float32))))
    config = ModelConfig(max_seq_len=16)
    batch = 2 if which == "train" else 4
    params = init_params(config, prng.PRNGKey(0, device="cpu"))
    tokens = train.synthetic_batch(config, batch, seed=1, device="cpu")
    return abs(float(loss_fn(params, tokens, config))
               - float(loss_fn(params, tokens, replace(config, dtype=torch.float32))))


def cli_tolerances(golden, which: str) -> list:
    """The limit on |port - JAX| for each step's loss."""
    floor = float(golden[f"cli/{which}/bf16_floor"]) + port_bf16_floor(which)
    n = len(golden[f"cli/{which}/losses"])
    return [floor] + [CLI_LATER_FACTOR * floor] * (n - 1)


def cli_misses(golden, which: str, losses: list) -> list:
    """The steps whose loss lies outside its tolerance of JAX's."""
    want = golden[f"cli/{which}/losses"]
    assert len(losses) == len(want)
    return [i + 1 for i, (got, w, tol) in
            enumerate(zip(losses, want, cli_tolerances(golden, which)))
            if not abs(got - float(w)) <= tol]


@pytest.fixture(scope="module")
def golden():
    with np.load(PRNG_DRAWS_GOLDEN) as f:
        return {k: f[k] for k in f.files}


def _bf16_bits(t: torch.Tensor) -> np.ndarray:
    assert t.dtype == torch.bfloat16
    return t.view(torch.int16).numpy()


# ---- bf16 uniform and normal -------------------------------------------------


@pytest.mark.parametrize("rng", BF16_UNIFORM_RANGES, ids=str)
@pytest.mark.parametrize("shape", BF16_SHAPES, ids=shape_id)
@pytest.mark.parametrize("spec", KEYS, ids=lambda s: s[0])
def test_bf16_uniform_matches_jax(golden, spec, shape, rng):
    got = prng.uniform(derive(prng, spec), shape, *rng, dtype=torch.bfloat16)
    want = golden[f"{spec[0]}/uniform_bf16/{rng}/{shape_id(shape)}"]
    assert got.shape == want.shape
    assert np.array_equal(_bf16_bits(got), want)


@pytest.mark.parametrize("shape", BF16_SHAPES, ids=shape_id)
@pytest.mark.parametrize("spec", KEYS, ids=lambda s: s[0])
def test_bf16_normal_matches_jax(golden, spec, shape):
    got = prng.normal(derive(prng, spec), shape, dtype=torch.bfloat16)
    want = golden[f"{spec[0]}/normal_bf16/{shape_id(shape)}"]
    assert got.shape == want.shape
    assert np.array_equal(_bf16_bits(got), want)


def test_bf16_draws_take_128_values_and_float32_stays_the_default():
    """A bf16 draw is one of the 128 values its 7 bits pick; float32 is
    the default and other types are refused."""
    key = prng.PRNGKey(3, device="cpu")
    draws = prng.uniform(key, (4096,), dtype=torch.bfloat16)
    assert len(set(draws.float().tolist())) == 128
    assert float(draws.min()) == 0.0 and float(draws.max()) < 1.0
    assert torch.equal(prng.uniform(key, (5,)).view(torch.int32),
                       prng.uniform(key, (5,), dtype=torch.float32).view(torch.int32))
    assert prng.normal(key, (5,)).dtype == torch.float32
    for fn in (prng.uniform, prng.normal):
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            fn(key, (5,), dtype=torch.float16)


# ---- the training batch ------------------------------------------------------


@pytest.mark.parametrize("vocab", BATCH_VOCABS)
@pytest.mark.parametrize("seed", BATCH_SEEDS)
def test_synthetic_batch_matches_jax(golden, seed, vocab):
    from workloads_torch.model import ModelConfig

    config = ModelConfig(vocab_size=vocab, max_seq_len=BATCH_SEQ)
    got = train.synthetic_batch(config, BATCH_SIZE, seed=seed, device="cpu")
    want = golden[f"batch/{vocab}/{seed}"]
    assert got.dtype == torch.int32 and want.dtype == np.int32
    assert np.array_equal(got.numpy(), want)


# ---- the vision workload -----------------------------------------------------


def _vision_tree(config) -> dict:
    tree = vision.init_params(config, prng.PRNGKey(0, device="cpu"))
    return {k: v.numpy() for k, v in tree.items()}


@pytest.mark.parametrize("size", ["full", "small"])
def test_vision_init_params_match_jax(golden, size):
    """The full tree, a strided sample of each leaf; the small tree whole."""
    config = vision.VisionConfig(**(VISION_SMALL if size == "small" else {}))
    tree = _vision_tree(config)
    assert sorted(tree) == ["conv1", "conv2", "dense1", "dense2"]
    for name, leaf in tree.items():
        want = golden[f"vision/{size}/{name}"]
        assert leaf.dtype == np.float32
        assert list(leaf.shape) == list(golden[f"vision/{size}/{name}/shape"]), name
        got = vision_leaf_sample(leaf) if size == "full" else leaf
        assert got.shape == want.shape, name
        assert ulps(got, want).max() <= TREE_ULPS, name


def test_vision_templates_match_jax(golden):
    config = vision.VisionConfig()
    got = prng.normal(prng.PRNGKey(vision.TEMPLATE_SEED, device="cpu"),
                      (config.image_size ** 2 * config.channels, config.n_classes))
    assert ulps(got.numpy(), golden["vision/templates"]).max() <= TREE_ULPS


@pytest.mark.parametrize("seed", VISION_IMAGE_SEEDS)
def test_vision_images_match_jax(golden, seed):
    images, labels = vision.synthetic_batch(vision.VisionConfig(), VISION_IMAGE_BATCH,
                                            seed=seed, device="cpu")
    want = golden[f"vision/images/{seed}"]
    assert images.shape == want.shape and images.dtype == torch.float32
    assert np.array_equal(images.numpy().view(np.int32), want.view(np.int32))
    assert np.array_equal(labels.numpy(), golden[f"vision/labels/{seed}"])


def test_vision_labels_match_jax(golden):
    """A batch of 256: the images JAX's to the bit (by digest), the
    labels JAX's but at counted near-ties of the port's float32 scores."""
    config = vision.VisionConfig()
    images, labels = vision.synthetic_batch(config, VISION_LABEL_BATCH, seed=0, device="cpu")
    assert images_digest(images.numpy()) == str(golden["vision/label_batch/digest"])
    want = golden["vision/label_batch/labels"]
    templates = prng.normal(prng.PRNGKey(vision.TEMPLATE_SEED, device="cpu"),
                            (config.image_size ** 2 * config.channels, config.n_classes))
    scores = ((images.reshape(VISION_LABEL_BATCH, -1) - 0.5) @ templates).numpy()
    parted = np.flatnonzero(labels.numpy() != want)
    gaps = [scores[i, labels[i]] - scores[i, want[i]] for i in parted]
    print(f"vision labels: {len(parted)} of {VISION_LABEL_BATCH} part from JAX's, top-two "
          f"gaps {gaps} (floor {LABEL_GAP_FLOOR})")
    assert all(g <= LABEL_GAP_FLOOR for g in gaps)
    assert len(set(labels.tolist())) >= config.n_classes - 1


# ---- perfbench's prompts and attention inputs ---------------------------------


@pytest.mark.parametrize("seed", PROMPT_SEEDS, ids=seed_id)
def test_prompt_matches_jax(golden, seed):
    got = perfbench._prompt(seed, PROMPT_LENGTH, PROMPT_VOCAB)
    assert isinstance(got, list) and all(isinstance(t, int) for t in got)
    assert got == golden[f"prompt/{seed_id(seed)}"].tolist()


def test_prompts_match_jax(golden):
    p = PROMPTS
    got = perfbench._prompts(p["seed"], p["batch"], p["length"], p["vocab"], "cpu")
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), golden["prompts"])


@pytest.mark.parametrize("which", ["q", "k", "v"])
def test_rand_qkv_matches_jax(golden, which):
    got = perfbench._rand_qkv(QKV["seq"], QKV["heads"], QKV["head_dim"], device="cpu")
    i = "qkv".index(which)
    assert got[i].shape == (1, QKV["seq"], QKV["heads"], QKV["head_dim"])
    assert np.array_equal(_bf16_bits(got[i]), golden[f"qkv/{which}"])


# ---- the CLIs from their seeds ------------------------------------------------


@pytest.mark.parametrize("which", sorted(CLIS))
def test_cli_losses_match_jax(golden, which):
    losses, printed = cli_losses("workloads_torch", which, CLIS[which] + ["--device", "cpu"])
    tol = cli_tolerances(golden, which)
    print(f"{which} CLI: port {losses}, JAX {golden[f'cli/{which}/losses'].tolist()}, "
          f"limits {tol}")
    assert f"step {len(losses)}: loss=" in printed
    assert cli_misses(golden, which, losses) == []


@pytest.mark.parametrize("which", sorted(CLIS))
def test_cli_control_on_the_generator_batch_fails(golden, which, monkeypatch):
    """The same CLI on the batches the port drew from ``torch.Generator``
    leaves JAX's losses at step 1 already."""
    monkeypatch.setattr(train, "synthetic_batch", generator_batch)
    monkeypatch.setattr(vision, "synthetic_batch", generator_vision_batch)
    losses, _ = cli_losses("workloads_torch", which, CLIS[which] + ["--device", "cpu"])
    assert 1 in cli_misses(golden, which, losses)
