"""The reference against the port's plain paths on the CPU, in float32,
and its float8 control against both."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import weights
from benchmark.reference import model as ref
from benchmark.serving import model_config

from .tiny import TINY_CONFIG

REFERENCE = Path(__file__).resolve().parents[1] / "reference"


@pytest.fixture
def cfg():
    return dict(TINY_CONFIG)


def _port_config(cfg, dtype=torch.float32, **extra):
    return model_config(cfg, dtype, **extra)


@pytest.mark.parametrize("window, kv_heads", [(None, None), (5, None), (None, 2)])
def test_reference_logits_equal_the_port_forward(cfg, window, kv_heads):
    from workloads_torch.model import forward

    cfg.update(sliding_window=window, num_key_value_heads=kv_heads)
    params = weights.make_params(cfg, 11, torch.float32, "cpu")
    tokens = weights.token_ids(11, "t", 2 * 24, cfg["vocab_size"], "cpu").view(2, 24)
    port = forward(params, tokens, _port_config(cfg))
    mine = ref.unembed(params, ref.hidden(params, tokens, cfg))
    torch.testing.assert_close(mine, port, rtol=1e-4, atol=1e-5)


def test_served_logits_are_the_full_pass_at_the_served_positions(cfg):
    params = weights.make_params(cfg, 12, torch.float32, "cpu")
    prompt, served = [3, 1, 4, 1, 5], [9, 2, 6]
    logits = ref.served_logits(params, prompt, served, cfg, "cpu")
    full = ref.unembed(params, ref.hidden(params, torch.tensor([prompt + served[:-1]]), cfg))
    torch.testing.assert_close(logits, full[0, 4:])
    best = logits.argmax(dim=-1)
    assert ref.widest_gap(logits, best) == 0.0
    worst = logits.argmin(dim=-1)
    assert ref.widest_gap(logits, worst) == pytest.approx(
        float((logits.max(-1).values - logits.min(-1).values).max()))


def test_reference_loss_and_gradients_equal_the_port(cfg):
    from workloads_torch.model import loss_fn
    from workloads_torch.train import tree_leaves

    params = weights.make_params(cfg, 13, torch.float32, "cpu")
    batch = weights.token_ids(13, "b", 3 * 17, cfg["vocab_size"], "cpu").view(3, 17)
    leaves = [p.requires_grad_(True) for _, p in weights.leaf_items(params)]
    loss, grads = ref.loss_and_grads(params, batch, cfg, leaves)
    port_leaves = tree_leaves(params)
    port_loss = loss_fn(params, batch, _port_config(cfg))
    port_grads = dict(zip(map(id, port_leaves), torch.autograd.grad(port_loss, port_leaves)))
    assert loss == pytest.approx(float(port_loss.detach()), rel=1e-5)
    for p, g in zip(leaves, grads):
        torch.testing.assert_close(g, port_grads[id(p)], rtol=1e-4, atol=1e-6)


def test_reference_adamw_follows_the_port_optimizer(cfg):
    from workloads_torch.train import AdamW, adamw, tree_leaves

    opt = AdamW(mu_dtype=torch.float32)
    mine = weights.make_params(cfg, 14, torch.float32, "cpu")
    port = weights.make_params(cfg, 14, torch.float32, "cpu")
    leaves = [p for _, p in weights.leaf_items(mine)]
    adam = ref.AdamW(leaves, opt.lr, opt.b1, opt.b2, opt.eps, opt.weight_decay)
    state = opt.init(port)
    # The port's leaf order is the benchmark's.
    assert [p.shape for p in tree_leaves(port)] == [p.shape for p in leaves]
    for step in range(3):
        grads = [torch.randn(p.shape, generator=torch.Generator().manual_seed(step))
                 for p in leaves]
        adam.step(leaves, grads)
        state = adamw(port, grads, state, opt)
    for (_, a), (_, b) in zip(weights.leaf_items(mine), weights.leaf_items(port)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


def test_the_float8_control_departs_much_further_than_bf16(cfg):
    """At each position of the same sequence: the gap of the token that
    float8 puts first is wider than the one bf16 puts first."""
    from workloads_torch.model import forward

    cfg = {**cfg, "dtype": "bfloat16"}
    params = weights.make_params(cfg, 15, torch.bfloat16, "cpu")
    tokens = weights.token_ids(15, "c", 4 * 48, cfg["vocab_size"], "cpu").view(4, 48)
    exact = ref.unembed(params, ref.hidden(params, tokens, cfg)).flatten(0, 1)
    low = ref.unembed(params, ref.hidden(params, tokens, cfg, fp8=True), fp8=True)
    bf16 = forward(params, tokens, _port_config(cfg, torch.bfloat16)).flatten(0, 1)
    program_gap = ref.widest_gap(exact, bf16.argmax(-1))
    control_gap = ref.widest_gap(exact, low.flatten(0, 1).argmax(-1))
    assert control_gap > 3 * program_gap


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("name", ["__init__.py", "model.py"])
def test_the_reference_imports_nothing_of_the_program(name):
    names = _imports(REFERENCE / name)
    assert not names & {"workloads_torch", "workloads", "jax", "jaxlib", "flax", "benchmark"}


def test_loading_the_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, '.'); import benchmark.reference.model; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REFERENCE.parents[1],
                         capture_output=True, text=True, check=True).stdout
    loaded = set(ast.literal_eval(out.strip()))
    assert not loaded & {"workloads_torch", "workloads", "jax", "jaxlib", "flax"}


def test_the_float8_control_fails_the_training_comparison():
    """The reference in float8 in the program's place: its numbers read
    far above the float32 program's against the same reference."""
    from benchmark import training

    from .tiny import tiny_cell

    cell = tiny_cell("pythia-1.4b.train")
    run = training.TrainRun(cell, 21, 0.0, False, "cpu", "/unused")

    def reading(**kw):
        return training.reference_reading(cell.config, 21, run.batch, run.opt, 3, "cpu", **kw)

    exact = reading()
    run.setup()
    program = training.compare(exact, run.losses, run.grad_norms, run.change_norms)
    low = reading(fp8=True)
    control = training.compare(exact, low["losses"], low["grad_norms"], low["change_norms"])
    half = reading(rows_of=lambda t: [0])
    halved = training.compare(exact, half["losses"], half["grad_norms"], half["change_norms"])
    for name in ("loss_gap", "grad_gap"):
        assert control[name] > 3 * program[name], name
        assert halved[name] > 3 * program[name], name
