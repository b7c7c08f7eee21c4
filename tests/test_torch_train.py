"""The port's training slice (workloads_torch.model.loss_fn, .train,
.checkpoint) held against the JAX package's outputs, frozen in
tests/test_torch_train_golden.npz, plus its own contracts.

torch and numpy only, so it runs in the fast tier.  Parameters, tokens
and gradients-to-apply are drawn here from numpy seeds and handed to both
packages; ``python tests/test_torch_train_parity.py --write-goldens``
regenerates the fixture and runs the same comparisons live.  The flash
route is forced at these short sequences by lowering ``flash_min_seq``
in both packages, as tests/test_flash_attention.py does for JAX.

Tolerances, as a share of the largest |value| compared, leaf by leaf:

* float32 ``loss_fn`` and its gradients through the flash route: 2^-18
  (the two frameworks sum in different orders).  Readings: loss 1.1e-7,
  gradients at most 4.4e-7.
* bfloat16 ``loss_fn`` (GQA, window 5, flash route; JAX run with jit
  disabled so each operation rounds where the source says): the loss
  within 2^-22, and the gradients of the two leaves that the float32
  unembed reaches before any bf16 backward operation (``unembed``, the
  last layer's ``w_down``) within 2^-16.  Readings: 8.6e-8, 6.5e-8 and
  1.2e-7; the control, the port run in float32 on the same weights,
  misses them by 8.6e-7, 5.3e-3 and 9.1e-3 and must fail.  Every other
  gradient leaf passes back through bf16 operations (rmsnorm, gelu,
  rope, attention), whose backward torch's autograd and JAX's transpose
  rules round at different places: held at 2^-5, at which the two
  frameworks' bf16 gradients agree (readings 3.4e-3-2.0e-2, the same
  size as the float32 control's 5.6e-3-2.0e-2, so this limit tells
  bf16 from float32 apart for no leaf).
* three float32 ``make_train_step`` steps (flash route, bf16 first
  moment): losses within 2^-18, every parameter within 2^-14 of the
  largest |parameter|.  AdamW's first steps move each weight by about
  lr * sign(g), so a gradient near zero whose sign differs between the
  frameworks moves a weight by up to 2e-3; readings: losses equal,
  parameters at most 7.1e-6 of the largest.
* ``adamw`` against ``optax.adamw(1e-3, mu_dtype=bf16)`` (jitted) on
  the same gradients: parameters and the float32 second moment within
  1e-6 of their largest value, the bf16 first moment exactly.
  Readings: parameters at most 2.0e-7, nu 5.2e-9, mu 0; with b1 taken
  in float32 instead of JAX's bf16(0.9) the first moment misses.
"""

from __future__ import annotations

import os
import subprocess
import sys
from dataclasses import replace

import numpy as np
import pytest
import torch

import workloads_torch.model as tmodel
from tests.test_torch_flash import case_golden, load_golden, share
from workloads_torch import prng
from workloads_torch import train as ttrain
from workloads_torch.checkpoint import TrainCheckpointer
from workloads_torch.model import ModelConfig, loss_fn
from workloads_torch.ops import kernel_select

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
# name: dtype, kv heads, attention window
MODEL_CASES = {
    "f32_mha": ("f32", None, None),
    "bf16_gqa_win": ("bf16", 2, 5),
}
TRAIN_STEPS = 3
F32_LIMIT = 2.0**-18
BF16_LOSS_LIMIT = 2.0**-22
BF16_HEAD_GRAD_LIMIT = 2.0**-16  # leaves reached before any bf16 backward op
BF16_HEAD_GRADS = ("grad/unembed", "grad/layers/1/w_down")
BF16_GRAD_LIMIT = 2.0**-5
TRAIN_PARAM_LIMIT = 2.0**-14
ADAMW_LIMIT = 1e-6


def tiny_config(name: str, **kw) -> ModelConfig:
    """The tiny config (d_model 64, 4 heads, 2 layers, d_ff 128, vocab
    256) at 33 tokens, so the loss's forward runs at seq 32."""
    dt, kv, win = MODEL_CASES[name]
    return replace(ModelConfig(
        vocab_size=256, d_model=64, n_heads=4, n_layers=2, d_ff=128,
        max_seq_len=33, dtype=DTYPES[dt], n_kv_heads=kv, attention_window=win,
        attention_impl="flash",
    ), **kw)


def numpy_params(config) -> dict:
    """The JAX package's parameter tree and law (dense leaves N(0, 0.02),
    norm gains 1) as float32 numpy arrays from a numpy seed."""
    rng = np.random.default_rng(config.kv_heads)
    d, h, hd, f = config.d_model, config.n_heads, config.head_dim, config.d_ff

    def dense(*shape):
        return (0.02 * rng.standard_normal(shape)).astype(np.float32)

    tree = {"embed": dense(config.vocab_size, d), "unembed": dense(d, config.vocab_size),
            "layers": []}
    for _ in range(config.n_layers):
        layer = {"ln1": np.ones(d, np.float32), "ln2": np.ones(d, np.float32)}
        if config.kv_heads == h:
            layer["wqkv"] = dense(d, 3, h, hd)
        else:
            layer["wq"] = dense(d, h, hd)
            layer["wkv"] = dense(d, 2, config.kv_heads, hd)
        layer["wo"] = dense(h, hd, d)
        layer["w_up"] = dense(d, f)
        layer["w_down"] = dense(f, d)
        tree["layers"].append(layer)
    return tree


def numpy_tokens(config, step: int) -> np.ndarray:
    return np.random.default_rng(100 + step).integers(
        0, config.vocab_size, (2, config.max_seq_len)).astype(np.int32)


def flat(tree: dict) -> dict:
    """A parameter-shaped tree as {"embed": .., "layers/0/wo": ..}."""
    out = {"embed": tree["embed"], "unembed": tree["unembed"]}
    for i, layer in enumerate(tree["layers"]):
        for name, w in layer.items():
            out[f"layers/{i}/{name}"] = w
    return out


def leaf_names(tree: dict) -> list[str]:
    """The keys of ``flat`` in the order of ``train.tree_leaves``."""
    return ["embed", "unembed"] + [
        f"layers/{i}/{n}" for i, layer in enumerate(tree["layers"]) for n in sorted(layer)
    ]


def torch_tree(tree: dict) -> dict:
    return ttrain.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _np(t) -> np.ndarray:
    """A copy: the train step updates its tensors in place."""
    return t.detach().float().cpu().numpy().copy()


@pytest.fixture
def flash_everywhere(monkeypatch):
    monkeypatch.setattr(tmodel, "flash_min_seq", lambda: 1)


def port_loss_and_grads(name: str, **kw) -> dict:
    """loss_fn and d loss / d params through the port (flash route must
    be forced by the caller); ``kw`` overrides the case's config."""
    config = tiny_config(name, **kw)
    params = torch_tree(numpy_params(config))
    leaves = ttrain.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = loss_fn(params, torch.from_numpy(numpy_tokens(config, 0)), config)
    grads = torch.autograd.grad(loss, leaves)
    out = {"loss": np.asarray(loss.item(), np.float32)}
    out.update({f"grad/{k}": _np(g) for k, g in zip(leaf_names(params), grads)})
    return out


def model_limit(name: str, key: str) -> float:
    if MODEL_CASES[name][0] == "f32":
        return F32_LIMIT
    if key == "loss":
        return BF16_LOSS_LIMIT
    return BF16_HEAD_GRAD_LIMIT if key in BF16_HEAD_GRADS else BF16_GRAD_LIMIT


def model_mismatches(name: str, got: dict, want: dict) -> dict:
    bad = {}
    for key, w in want.items():
        if not (s := share(got[key], w)) <= model_limit(name, key):
            bad[key] = s
    return bad


def port_train_steps() -> dict:
    """Three float32 train steps (flash route must be forced)."""
    config = tiny_config("f32_mha", dtype=torch.float32)
    params = torch_tree(numpy_params(config))
    optimizer = ttrain.AdamW()
    state = optimizer.init(params)
    step = ttrain.make_train_step(config, optimizer)
    losses = []
    for s in range(TRAIN_STEPS):
        params, state, loss = step(params, state, torch.from_numpy(numpy_tokens(config, s)))
        losses.append(loss.item())
    out = {"losses": np.asarray(losses, np.float32)}
    out.update({f"params/{k}": _np(v) for k, v in flat(params).items()})
    return out


def train_mismatches(got: dict, want: dict) -> dict:
    bad = {}
    if not (s := share(got["losses"], want["losses"])) <= F32_LIMIT:
        bad["losses"] = s
    scale = max(np.abs(w).max() for k, w in want.items() if k.startswith("params/"))
    for key, w in want.items():
        if key.startswith("params/"):
            err = float(np.abs(got[key] - w).max() / scale)
            if not err <= TRAIN_PARAM_LIMIT:
                bad[key] = err
    return bad


ADAMW_SHAPES = {"embed": (7, 3), "unembed": (3, 7), "ln1": (3,), "w_up": (3, 5)}


def adamw_inputs() -> dict:
    """A small parameter-shaped tree and three steps of gradients, some
    tiny (|g| near eps) and some large."""
    rng = np.random.default_rng(7)
    inp = {f"p/{k}": (0.02 * rng.standard_normal(s)).astype(np.float32)
           for k, s in ADAMW_SHAPES.items()}
    for step in range(3):
        for k, s in ADAMW_SHAPES.items():
            scale = 10.0 ** rng.integers(-9, 2, s)
            inp[f"g{step}/{k}"] = (scale * rng.standard_normal(s)).astype(np.float32)
    return inp


def _adamw_tree(inp: dict, prefix: str) -> dict:
    return {"embed": torch.from_numpy(inp[f"{prefix}/embed"].copy()),
            "unembed": torch.from_numpy(inp[f"{prefix}/unembed"].copy()),
            "layers": [{"ln1": torch.from_numpy(inp[f"{prefix}/ln1"].copy()),
                        "w_up": torch.from_numpy(inp[f"{prefix}/w_up"].copy())}]}


def port_adamw() -> dict:
    inp = adamw_inputs()
    params = _adamw_tree(inp, "p")
    state = ttrain.AdamW().init(params)
    out = {}
    for step in range(3):
        grads = ttrain.tree_leaves(_adamw_tree(inp, f"g{step}"))
        state = ttrain.adamw(params, grads, state)
        for k, v in zip(("embed", "unembed", "ln1", "w_up"), ttrain.tree_leaves(params)):
            out[f"params{step}/{k}"] = _np(v)
    for which in ("mu", "nu"):
        for k, v in zip(("embed", "unembed", "ln1", "w_up"), ttrain.tree_leaves(state[which])):
            out[f"{which}/{k}"] = _np(v)
    return out


def adamw_mismatches(got: dict, want: dict) -> dict:
    bad = {}
    for key, w in want.items():
        s = share(got[key], w)
        if not (s == 0 if key.startswith("mu/") else s <= ADAMW_LIMIT):
            bad[key] = s
    return bad


@pytest.fixture(scope="module")
def golden():
    return load_golden()


@pytest.mark.parametrize("name", sorted(MODEL_CASES))
def test_loss_and_grads_match_jax_goldens(golden, flash_everywhere, name):
    want = case_golden(golden, f"model/{name}/")
    got = port_loss_and_grads(name)
    assert set(want) == set(got)
    assert not model_mismatches(name, got, want), model_mismatches(name, got, want)


def test_bf16_loss_limits_reject_the_float32_control(golden, flash_everywhere):
    """The port run in float32 on the same weights misses the bf16 loss
    and the gradients that reach no bf16 backward operation."""
    got = port_loss_and_grads("bf16_gqa_win", dtype=torch.float32)
    want = case_golden(golden, "model/bf16_gqa_win/")
    bad = model_mismatches("bf16_gqa_win", got, want)
    assert {"loss", *BF16_HEAD_GRADS} <= set(bad)


def test_three_train_steps_match_jax_goldens(golden, flash_everywhere):
    want = case_golden(golden, "train/")
    got = port_train_steps()
    assert set(want) == set(got)
    assert not train_mismatches(got, want), train_mismatches(got, want)


def test_adamw_matches_optax_goldens(golden):
    want = case_golden(golden, "adamw/")
    got = port_adamw()
    assert set(want) == set(got)
    assert not adamw_mismatches(got, want), adamw_mismatches(got, want)


def test_adamw_state_dtypes_and_weight_decay():
    """mu is stored in bf16 and nu in float32; with zero gradients only
    the decoupled weight decay moves a weight: p - lr * 1e-4 * p."""
    params = {"embed": torch.full((4,), 2.0), "unembed": torch.ones(2), "layers": []}
    state = ttrain.AdamW().init(params)
    assert state["mu"]["embed"].dtype == torch.bfloat16
    assert state["nu"]["embed"].dtype == torch.float32
    state = ttrain.adamw(params, [torch.zeros(4), torch.zeros(2)], state)
    assert state["count"] == 1
    torch.testing.assert_close(params["embed"], torch.full((4,), 2.0 - 1e-3 * 1e-4 * 2.0))


def test_flash_route_and_native_route_give_the_same_loss_in_f32(flash_everywhere):
    config = tiny_config("f32_mha", dtype=torch.float32)
    params = torch_tree(numpy_params(config))
    tokens = torch.from_numpy(numpy_tokens(config, 0))
    native = replace(config, attention_impl="native")
    results = []
    for cfg in (config, native):
        leaves = ttrain.tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss = loss_fn(params, tokens, cfg)
        results.append((loss.detach(), torch.autograd.grad(loss, leaves)))
        for p in leaves:
            p.requires_grad_(False)
    (l_flash, g_flash), (l_native, g_native) = results
    torch.testing.assert_close(l_flash, l_native, rtol=1e-6, atol=0)
    for a, b in zip(g_flash, g_native):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6 * b.abs().max().item())


def test_routing_follows_the_jax_conditions(monkeypatch):
    """Flash from flash_min_seq up, or when the dense score matrix would
    pass the cap; native otherwise and always for attention_impl native."""
    calls = []
    monkeypatch.setattr("workloads_torch.ops.attention.flash_attention",
                        lambda q, k, v, window=None: calls.append(q.shape) or q)
    config = tiny_config("f32_mha", dtype=torch.float32)
    params = torch_tree(numpy_params(config))
    tokens = torch.zeros(1, 21, dtype=torch.long)
    tmodel.forward(params, tokens, config)
    assert calls == []  # 21 < 2048 and 4*1*4*21*21 bytes is under the cap
    monkeypatch.setattr(tmodel, "flash_min_seq", lambda: 21)
    tmodel.forward(params, tokens, config)
    assert len(calls) == config.n_layers
    monkeypatch.setattr(tmodel, "flash_min_seq", lambda: 4096)
    monkeypatch.setattr(tmodel, "_DENSE_SCORE_BYTES_CAP", 4 * 4 * 21 * 21 - 1)
    tmodel.forward(params, tokens, config)
    assert len(calls) == 2 * config.n_layers
    tmodel.forward(params, tokens, replace(config, attention_impl="native"))
    assert len(calls) == 2 * config.n_layers


def test_remat_layers_gives_the_same_loss_and_grads(flash_everywhere):
    config = tiny_config("f32_mha", dtype=torch.float32)
    tokens = torch.from_numpy(numpy_tokens(config, 1))
    out = []
    for remat in (False, True):
        cfg = replace(config, remat_layers=remat)
        params = torch_tree(numpy_params(cfg))
        step = ttrain.make_train_step(cfg)
        params, _, loss = step(params, ttrain.AdamW().init(params), tokens)
        out.append((loss, ttrain.tree_leaves(params)))
    torch.testing.assert_close(out[0][0], out[1][0], rtol=0, atol=0)
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-7)


def test_model_config_validates_attention_impl():
    with pytest.raises(ValueError, match="attention_impl must be 'native' or 'flash'"):
        ModelConfig(attention_impl="ring")


def test_kernel_select_falls_back_to_the_crossover():
    """No measured row on this host (no card): the crossover passed in
    decides; an injected table overrides it."""
    assert kernel_select.kernel_table() is None
    assert kernel_select.kernel_for_seq(100, default_min_seq=2048) == "xla"
    assert kernel_select.kernel_for_seq(2048, default_min_seq=2048) == "flash"
    try:
        kernel_select.set_kernel_table(
            kernel_select.table_from_measurements({1024: 0.8, 2048: 1.6}))
        assert kernel_select.kernel_for_seq(100, 1) == "xla"
        assert kernel_select.kernel_for_seq(1500, 1) == "flash"
        assert kernel_select.kernel_for_seq(9000, 1 << 30) == "flash"
        with pytest.raises(ValueError, match="kernel impl must be one of"):
            kernel_select.set_kernel_table({10: "dense"})
    finally:
        kernel_select.set_kernel_table(None)
    assert tmodel.flash_min_seq() == 2048


def test_checkpoint_resume_equals_an_uninterrupted_run(tmp_path):
    config = ModelConfig(vocab_size=64, d_model=32, n_heads=2, n_layers=1, d_ff=64,
                         max_seq_len=9, dtype=torch.float32)
    step = ttrain.make_train_step(config)

    def batch(s):
        return ttrain.synthetic_batch(config, 2, seed=s, device="cpu")

    (params, state), _ = ttrain.make_train_state(config, seed=3, device="cpu")
    for s in range(4):
        params, state, _ = step(params, state, batch(s))
    straight = [p.clone() for p in ttrain.tree_leaves(params)]

    ckpt = TrainCheckpointer(str(tmp_path), max_to_keep=2)
    (params, state), _ = ttrain.make_train_state(config, seed=3, device="cpu")
    for s in range(2):
        params, state, _ = step(params, state, batch(s))
        ckpt.save(s + 1, (params, state))
    ckpt.wait()
    ckpt.close()
    resumed = TrainCheckpointer(str(tmp_path))
    assert resumed.latest_step == 2
    like = ttrain.make_train_state(config, seed=99, device="cpu")[0]
    params, state = resumed.restore_latest(like=like)
    assert state["count"] == 2 and state["mu"]["embed"].dtype == torch.bfloat16
    for s in range(2, 4):
        params, state, _ = step(params, state, batch(s))
    for a, b in zip(ttrain.tree_leaves(params), straight):
        assert torch.equal(a, b)
    assert sorted(os.listdir(tmp_path)) == ["step_1.pt", "step_2.pt"]


def test_checkpoint_keeps_max_to_keep_and_refuses_a_wrong_tree(tmp_path):
    ckpt = TrainCheckpointer(str(tmp_path), max_to_keep=2)
    assert ckpt.latest_step is None and ckpt.restore_latest(like={}) is None
    for s in (5, 10, 15):
        ckpt.save(s, {"w": torch.full((3,), float(s))})
    assert sorted(os.listdir(tmp_path)) == ["step_10.pt", "step_15.pt"]
    assert torch.equal(ckpt.restore_latest(like={"w": torch.zeros(3)})["w"],
                       torch.full((3,), 15.0))
    with pytest.raises(ValueError, match="does not match"):
        ckpt.restore_latest(like={"w": torch.zeros(4)})


def test_make_forward_fn_equals_forward():
    """``make_forward_fn(config)`` is ``forward`` with ``config`` bound:
    the same logits bit for bit, MHA and GQA."""
    for config in (ModelConfig(dtype=torch.float32),
                   ModelConfig(n_kv_heads=2, dtype=torch.float32)):
        params = tmodel.init_params(config, prng.PRNGKey(3, device="cpu"))
        tokens = torch.randint(0, config.vocab_size, (2, 9), generator=torch.Generator()
                               .manual_seed(4))
        fn = tmodel.make_forward_fn(config)
        assert fn.keywords == {"config": config}
        assert torch.equal(fn(params, tokens), tmodel.forward(params, tokens, config))


def test_synthetic_batch_is_seeded_and_in_vocab():
    config = ModelConfig(vocab_size=50, max_seq_len=12)
    a = ttrain.synthetic_batch(config, 3, seed=1, device="cpu")
    assert a.shape == (3, 12) and int(a.min()) >= 0 and int(a.max()) < 50
    assert torch.equal(a, ttrain.synthetic_batch(config, 3, seed=1, device="cpu"))
    assert not torch.equal(a, ttrain.synthetic_batch(config, 3, seed=2, device="cpu"))


def _state_tensors(params, opt_state):
    return [t for t in ttrain.tree_leaves(params) + ttrain.tree_leaves(opt_state)
            if isinstance(t, torch.Tensor)]


def _aot_case(seed=0):
    config = ModelConfig(d_model=32, n_heads=2, n_layers=2, d_ff=64, vocab_size=64,
                         max_seq_len=17)
    (params, opt_state), optimizer = ttrain.make_train_state(config, seed=seed, device="cpu")
    step = ttrain.make_train_step(config, optimizer)
    tokens = ttrain.synthetic_batch(config, 2, seed=seed, device="cpu")
    return params, opt_state, step, tokens


def test_aot_compile_leaves_the_state_bit_identical():
    """The eager aot_compile takes no step: parameters, both moments and
    the count are as they were, bit for bit."""
    params, opt_state, step, tokens = _aot_case()
    before = [t.clone() for t in _state_tensors(params, opt_state)]
    run = step.aot_compile(params, opt_state, tokens)
    assert callable(run) and opt_state["count"] == 0
    after = _state_tensors(params, opt_state)
    assert len(after) == len(before) and all(
        torch.equal(a, b) and a.dtype == b.dtype for a, b in zip(after, before))


def test_aot_compiled_run_equals_the_step_bit_for_bit():
    """Two steps through aot_compile's run equal two steps of the step
    itself on a copy of the same state: losses, parameters and moments."""
    params, opt_state, step, tokens = _aot_case()
    params_b, opt_b, step_b, tokens_b = _aot_case()
    run = step.aot_compile(params, opt_state, tokens)
    losses, losses_b = [], []
    for _ in range(2):
        params, opt_state, loss = run(params, opt_state, tokens)
        params_b, opt_b, loss_b = step_b(params_b, opt_b, tokens_b)
        losses.append(loss)
        losses_b.append(loss_b)
    assert all(torch.equal(a, b) for a, b in zip(losses, losses_b))
    assert opt_state["count"] == opt_b["count"] == 2
    assert all(torch.equal(a, b) for a, b in zip(_state_tensors(params, opt_state),
                                                 _state_tensors(params_b, opt_b)))


def test_aot_compile_checks_the_batch_arity_with_the_jax_text():
    params, opt_state, step, tokens = _aot_case()
    with pytest.raises(ValueError, match=r"^expected 1 batch arguments \(one per "
                                         r"batch_specs entry\), got 2$"):
        step.aot_compile(params, opt_state, tokens, tokens)


def test_train_cli_runs_on_cpu_and_resumes(tmp_path):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    ckpt_dir, profile_dir = tmp_path / "ckpt", tmp_path / "profile"
    cmd = [sys.executable, "-m", "workloads_torch.train", "--device", "cpu",
           "--steps", "3", "--checkpoint-dir", str(ckpt_dir), "--checkpoint-every", "2"]
    proc = subprocess.run(cmd + ["--profile-dir", str(profile_dir)], capture_output=True,
                          text=True, cwd=ROOT, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "done: steps=3 device=cpu" in proc.stdout
    assert (profile_dir / "train_trace.json").stat().st_size > 0
    cmd[cmd.index("3")] = "4"
    proc = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "resumed from checkpoint step 3" in proc.stdout


def test_train_golden_fixture_stays_small():
    assert os.path.getsize(os.path.join(ROOT, "tests", "test_torch_train_golden.npz")) < 2 << 20
