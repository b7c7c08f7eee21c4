"""Expert-parallel MoE (workloads_torch/moe.py): the routing math against a
per-token reference and JAX's frozen outputs, and the dp x ep x tp step
on gloo CPU worlds of 2 and 4 ranks (tests/torch_model_world.py's
MOE_LAYOUTS through tests/torch_tp_world.py's run_worlds), held against
the port's one-device step on the same numpy weights and batch and
against the JAX package's meshed step, frozen in
tests/test_torch_moe_golden.npz (tests/test_torch_parity.py's
write_moe_goldens).  JAX's tests/test_moe.py, test for test.

Tolerances, float32:

* ``moe_ffn`` against the per-token reference at 1e-5 absolute (JAX's
  test) and against JAX's y, aux and gradients at 1e-6 absolute;
* three AdamW steps of the tiny MoE model (2 layers, 4 experts) on one
  repeated batch of 4 x 17 tokens: each loss within 2^-20 of the
  one-device loss and of JAX's, relative, and the parameters gathered
  over the expert and model axes within 1e-5 of the largest |value| of
  the tree (tests/test_torch_train_parallel.py's measure); readings: EP2
  bit for bit, DP2 3.8e-6, EP2xTP2 6.9e-6;
* two controls must miss the parameter tolerance: EP2 without the
  expert axis' ``f`` (the dispatch input's and the gate's gradients are
  each rank's experts' part alone) and DP2 with each data rank's own aux
  loss (a mean of products where JAX's is a product of global means).
"""

from __future__ import annotations

import numpy as np
import pytest
from workloads_torch import prng
import torch

from tests import torch_model_world as mw
from tests import torch_tp_world as tw
from tests import torch_train_world as trw

WORLDS = (2, 4)
LOSS_RTOL = 2.0**-20
PARAM_RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return tw.run_worlds(tmp_path_factory, WORLDS, mw.moe_scenarios, module=mw.__name__)


@pytest.fixture(scope="module")
def golden():
    with np.load(mw.MOE_GOLDEN) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def one_device():
    return mw.moe_one_device_steps()


def ffn_inputs():
    from workloads_torch import convert

    params, x = mw.ffn_numpy()
    return convert.params_from_jax(params, device="cpu"), torch.as_tensor(x)


def reference_moe(params, x, cap):
    """Per-token loop: top-1 routing, first-come capacity, same maths."""
    from workloads_torch.model import _gelu_tanh

    b, s, d = x.shape
    n_experts = params["router"].shape[1]
    probs = torch.softmax(x.float() @ params["router"], dim=-1)
    y = np.zeros((b, s, d), np.float32)
    for bi in range(b):
        counts = [0] * n_experts
        for si in range(s):
            e = int(torch.argmax(probs[bi, si]))
            gate = float(probs[bi, si, e])
            if counts[e] >= cap:
                continue  # dropped: residual passes through unchanged
            counts[e] += 1
            h = _gelu_tanh(x[bi, si].float() @ params["w_up"][e])
            y[bi, si] = gate * (h @ params["w_down"][e]).numpy()
    return y


def test_moe_matches_per_token_reference(golden):
    from workloads_torch.moe import MoEConfig, expert_capacity, moe_ffn

    params, x = ffn_inputs()
    d, f, e = mw.FFN_DIMS
    moe = MoEConfig(n_experts=e, capacity_factor=mw.FFN_CAPACITY)
    cap = expert_capacity(x.shape[1], e, mw.FFN_CAPACITY)
    assert cap == 3
    got, aux = moe_ffn(params, x, moe)
    np.testing.assert_allclose(got.numpy(), reference_moe(params, x, cap), atol=1e-5)
    assert float(aux) > 0.0
    np.testing.assert_allclose(got.numpy(), golden["ffn/y"], atol=1e-6, rtol=0)
    np.testing.assert_allclose(float(aux), float(golden["ffn/aux"]), rtol=1e-6)


def test_capacity_drops_overflow_tokens():
    """With capacity 1 and a router forced onto expert 0, only the first
    token per sequence goes through the expert path."""
    from workloads_torch.moe import MoEConfig, init_moe_ffn_params, moe_ffn

    params = init_moe_ffn_params(prng.PRNGKey(0, device="cpu"), 8, 16, 2)
    # A huge bias toward expert 0 for every token (x is all ones, so any
    # positive weight in column 0 dominates the zeroed column 1).
    params["router"] = torch.zeros_like(params["router"])
    params["router"][0, 0] = 100.0
    x = torch.ones((1, 4, 8))
    y, _ = moe_ffn(params, x, MoEConfig(n_experts=2, capacity_factor=0.5))  # cap = 1
    assert y[0, 0].abs().sum() > 0  # first token processed
    np.testing.assert_allclose(y[0, 1:].numpy(), 0.0, atol=1e-6)  # rest dropped


def test_moe_ffn_differentiable(golden):
    """Finite gradients of sum(y**2) + aux, a non-zero router gradient (the
    gate values carry it), and JAX's gradients."""
    from workloads_torch import train
    from workloads_torch.moe import MoEConfig, moe_ffn

    params, x = ffn_inputs()
    moe = MoEConfig(n_experts=mw.FFN_DIMS[2], capacity_factor=mw.FFN_CAPACITY)
    leaves = train.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    y, aux = moe_ffn(params, x, moe)
    grads = dict(zip(sorted(params), torch.autograd.grad((y**2).sum() + aux, leaves)))
    for name, g in grads.items():
        assert torch.all(torch.isfinite(g)), name
        np.testing.assert_allclose(g.numpy(), golden[f"ffn/grads/{name}"], atol=1e-6, rtol=0,
                                   err_msg=name)
    assert grads["router"].abs().sum() > 0


def test_moe_loss_on_one_device_matches_jax(golden):
    from workloads_torch.moe import MoEConfig, moe_loss_fn

    loss = moe_loss_fn(mw.moe_port_params(), torch.as_tensor(trw.numpy_tokens(0)),
                       trw.port_config(), MoEConfig())
    assert abs(float(loss) - float(golden["loss"])) <= LOSS_RTOL * float(golden["loss"])


@pytest.mark.parametrize("world", WORLDS)
def test_moe_mesh_shape(worlds, world):
    """``make_moe_mesh(n, expert_parallel=2)`` over the world: the rest is
    data."""
    for rank in range(world):
        got = tw.result_of(worlds[world], "moe:refusals", rank)
        assert got["shape"] == {"data": world // 2, "expert": 2, "model": 1}


def layout_ranks(worlds, layout: str, name: str | None = None) -> list:
    world, _ = mw.MOE_LAYOUTS[layout]
    return [tw.result_of(worlds[world], name or f"moe:steps:{layout}", r)
            for r in range(world)]


def param_errs(ranks: list, layout: str, one_device: dict) -> dict:
    _, (_, expert, model) = mw.MOE_LAYOUTS[layout]
    full = mw.moe_gather(ranks, expert, model)
    largest = max(np.abs(v).max() for v in one_device["params"].values())
    assert set(full) == set(one_device["params"])
    out = {}
    for name, want in one_device["params"].items():
        assert full[name].shape == want.shape, name
        out[name] = float(np.abs(full[name] - want).max() / largest)
    return out


@pytest.mark.parametrize("layout", list(mw.MOE_LAYOUTS))
def test_moe_train_step_dp_ep_tp(worlds, one_device, golden, layout):
    """Three steps on a repeated batch: finite losses that fall, each
    within 2^-20 of the one-device step's and of JAX's meshed step's, the
    parameters gathered over the expert and model axes within 1e-5, the
    first loss the one-device ``moe_loss_fn``'s."""
    _, (data, expert, model) = mw.MOE_LAYOUTS[layout]
    ranks = layout_ranks(worlds, layout)
    for r, got in enumerate(ranks):
        assert got["dims"] == {"data": data, "expert": expert, "model": model}
        losses = got["losses"]
        assert np.all(np.isfinite(losses)) and losses[2] < losses[1] < losses[0]
        for a, b in zip(losses, one_device["losses"], strict=True):
            assert abs(a - b) <= LOSS_RTOL * abs(b), (r, a, b)
        for a, b in zip(losses, golden[f"steps/{layout}"], strict=True):
            assert abs(a - float(b)) <= LOSS_RTOL * abs(float(b)), (r, a, b)
    assert abs(ranks[0]["losses"][0] - float(golden["loss"])) <= \
        LOSS_RTOL * float(golden["loss"])
    worst = param_errs(ranks, layout, one_device)
    assert max(worst.values()) <= PARAM_RTOL, max(worst.items(), key=lambda kv: kv[1])


@pytest.mark.parametrize("layout", list(mw.MOE_LAYOUTS))
def test_moe_ranks_agree_bit_for_bit(worlds, layout):
    """The loss and the replicated leaves (embed, unembed, norms, routers)
    on every rank, and every leaf across the data replicas."""
    _, (data, expert, model) = mw.MOE_LAYOUTS[layout]
    ranks = layout_ranks(worlds, layout)
    per_data = expert * model
    for r, got in enumerate(ranks):
        assert got["losses"] == ranks[0]["losses"]
        for name, value in got["params"].items():
            if mw.moe_spec_of(name) == ():
                assert np.array_equal(value, ranks[0]["params"][name]), (r, name)
            assert np.array_equal(value, ranks[r % per_data]["params"][name]), (r, name)


def test_the_control_without_enter_fails(worlds, one_device):
    """EP2 without the expert axis' ``f``: each rank's gradient of the
    residual stream below an MoE layer, and of the router, holds only its
    own experts' part, so the replicated leaves part across the ranks and
    miss the parameter tolerance."""
    ranks = layout_ranks(worlds, "ep2", "moe:control:no_enter")
    worst = param_errs(ranks, "ep2", one_device)
    assert worst["embed"] > PARAM_RTOL and worst["layers/0/moe/router"] > PARAM_RTOL
    assert not np.array_equal(ranks[0]["params"]["embed"], ranks[1]["params"]["embed"])
    assert not all(abs(a - b) <= LOSS_RTOL * abs(b)
                   for a, b in zip(ranks[0]["losses"], one_device["losses"]))


def test_the_control_with_local_aux_losses_fails(worlds, one_device):
    """DP2 with each data rank's own aux loss (a product of its own
    means): the loss and the router's and experts' updates miss."""
    ranks = layout_ranks(worlds, "dp2", "moe:control:local_aux")
    worst = param_errs(ranks, "dp2", one_device)
    assert worst["layers/0/moe/router"] > PARAM_RTOL
    assert abs(ranks[0]["losses"][0] - one_device["losses"][0]) > \
        LOSS_RTOL * one_device["losses"][0]


def test_moe_mesh_rejects_indivisible(worlds):
    for rank in range(2):
        got = tw.result_of(worlds[2], "moe:refusals", rank)
        assert got["indivisible"] == "ValueError: 2 devices not divisible by ep*tp=3"
        assert got["too_many"] == ("ValueError: requested a 4-device mesh but only 2 devices "
                                   "are visible")


def test_moe_init_keys_independent_of_attention():
    """Regression: MoE weights must not replay the stream init_params
    consumed (router == wqkv prefix, bit for bit)."""
    from workloads_torch.model import ModelConfig
    from workloads_torch.moe import MoEConfig, init_moe_model_params

    config = ModelConfig(n_layers=2)
    params = init_moe_model_params(config, MoEConfig(4), prng.PRNGKey(0, device="cpu"))
    router = params["layers"][1]["moe"]["router"].ravel()
    wqkv = params["layers"][0]["wqkv"].ravel()[: router.numel()]
    assert not torch.equal(router, wqkv)
    w_up = params["layers"][0]["moe"]["w_up"].ravel()
    wo = params["layers"][0]["wo"].ravel()
    assert not torch.equal(w_up[: wo.numel()], wo)
    embed = params["embed"].ravel()
    first = params["layers"][0]["moe"]["router"].ravel()
    assert not torch.equal(first, embed[: first.numel()])
    assert "w_up" not in params["layers"][0] and "w_down" not in params["layers"][0]
    again = init_moe_model_params(config, MoEConfig(4), prng.PRNGKey(0, device="cpu"))
    assert torch.equal(again["layers"][1]["moe"]["w_down"],
                       params["layers"][1]["moe"]["w_down"])


def test_moe_specs_cut_experts_and_keep_the_attention_cut():
    from workloads_torch.model import ModelConfig, param_specs
    from workloads_torch.moe import moe_param_specs

    config = ModelConfig(n_layers=2)
    specs = moe_param_specs(config)
    for got, dense in zip(specs["layers"], param_specs(config)["layers"]):
        assert got["moe"] == {"router": (), "w_up": ("expert", None, None),
                              "w_down": ("expert", None, None)}
        assert got["wqkv"] == dense["wqkv"] and "w_up" not in got


def test_params_from_jax_maps_the_moe_tree():
    """``convert.params_from_jax`` maps each layer's ``"moe"`` subtree as
    nested: same keys, shapes and bits."""
    numpy_tree = mw.moe_numpy_params()
    got = mw.moe_port_params()
    for layer, want in zip(got["layers"], numpy_tree["layers"], strict=True):
        assert set(layer) == set(want) and set(layer["moe"]) == {"router", "w_up", "w_down"}
        for name, leaf in want["moe"].items():
            assert np.array_equal(layer["moe"][name].numpy(), leaf), name
