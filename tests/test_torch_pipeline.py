"""Pipeline parallelism (workloads_torch/pipeline.py): the GPipe schedule
on gloo CPU worlds of 2 and 4 ranks (tests/torch_model_world.py's
PP_LAYOUTS through tests/torch_tp_world.py's run_worlds), held against
the port's sequential model on the same numpy weights and batches and
against the JAX package's pipeline, frozen in
tests/test_torch_pipeline_golden.npz (tests/test_torch_parity.py's
write_pipeline_goldens).  JAX's tests/test_pipeline.py, test for test.

Tolerances, float32, the tiny model at 4 layers and 17 tokens, 8 rows in
4 microbatches:

* the loss within 1e-5 of the sequential model's and of JAX's, relative
  (readings: equal to the sequential loss bit for bit at pp2);
* every gradient leaf within 1e-5 of the sequential model's and of JAX's,
  absolute, as JAX's test holds it (readings: at most 8.1e-10 at pp2);
* three AdamW steps on one repeated batch: each loss within 2^-20 of the
  sequential model's, relative, and of JAX's, and the parameters
  gathered over the stages within 1e-5 of the largest |value| of the
  tree (tests/test_torch_train_parallel.py's measure);
* the control, the hand-off's backward cut (activations handed on
  detached), must miss the parameter tolerance at stage 0 and the loss
  tolerance after the first step.
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
GRAD_ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return tw.run_worlds(tmp_path_factory, WORLDS, mw.pipeline_scenarios, module=mw.__name__)


@pytest.fixture(scope="module")
def golden():
    with np.load(mw.PIPELINE_GOLDEN) as f:
        return {k: f[k] for k in f.files}


def sequential_grads() -> dict:
    """The port's sequential ``loss_fn`` and its gradients on the
    unstacked numpy weights and the batch of step 0."""
    from workloads_torch import convert, train
    from workloads_torch.model import loss_fn

    params = convert.params_from_jax(mw.pp_numpy_layers(), device="cpu")
    leaves = train.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = loss_fn(params, torch.as_tensor(mw.pp_tokens(0)), mw.pp_config())
    by_leaf = dict(zip(map(id, leaves), torch.autograd.grad(loss, leaves)))
    return {"loss": loss.item(), "grads": trw.flat(train.tree_map(lambda p: by_leaf[id(p)],
                                                                   params))}


@pytest.fixture(scope="module")
def sequential():
    return sequential_grads()


@pytest.fixture(scope="module")
def one_device():
    """The sequential model's ``STEPS`` one-device steps on the repeated batch."""
    from workloads_torch import convert, train

    params = convert.params_from_jax(mw.pp_numpy_layers(), device="cpu")
    optimizer = train.AdamW()
    opt = optimizer.init(params)
    step = train.make_train_step(mw.pp_config(), optimizer)
    losses = []
    for _ in range(mw.STEPS):
        params, opt, loss = step(params, opt, torch.as_tensor(mw.pp_tokens(0)))
        losses.append(float(loss))
    return {"losses": losses, "params": trw.flat(params)}


def ranks_of(worlds, name: str, world: int) -> list:
    return [tw.result_of(worlds[world], name, r) for r in range(world)]


def layout_ranks(worlds, layout: str, prefix: str = "pp:steps") -> list:
    world, _ = mw.PP_LAYOUTS[layout]
    return ranks_of(worlds, f"{prefix}:{layout}", world)


def sequential_tree(ranks: list, key: str, pipe: int) -> dict:
    """The flat sequential tree from data group 0's stage ranks: the
    ``stages/<leaf>`` blocks joined in stage order and unstacked into
    ``layers/<i>/<leaf>``."""
    flat = ranks[0][key]
    stages = {name.split("/", 1)[1]: np.concatenate([ranks[s][key][name] for s in range(pipe)])
              for name in flat if name.startswith("stages/")}
    tree = mw.unstack_stages({"embed": flat["embed"], "unembed": flat["unembed"],
                              "stages": stages})
    out = {"embed": tree["embed"], "unembed": tree["unembed"]}
    for i, layer in enumerate(tree["layers"]):
        out.update({f"layers/{i}/{name}": leaf for name, leaf in layer.items()})
    return out


def within(got, want, rtol) -> bool:
    return abs(got - want) <= rtol * abs(want)


def param_err(got, want, reference) -> float:
    largest = max(np.abs(v).max() for v in reference.values())
    return float(np.abs(got - want).max() / largest)


@pytest.mark.parametrize("layout", mw.PP_GRADS)
def test_pipeline_loss_matches_sequential(worlds, sequential, golden, layout):
    for got in layout_ranks(worlds, layout, "pp:grads"):
        assert within(got["loss"], sequential["loss"], 1e-5), (got["loss"], sequential["loss"])
        want = float(golden[f"grads/{layout}/loss"])
        assert within(got["loss"], want, 1e-5), (got["loss"], want)


@pytest.mark.parametrize("layout", mw.PP_GRADS)
def test_pipeline_gradients_match_sequential(worlds, sequential, golden, layout):
    """Every gradient leaf, gathered over the stages and unstacked, against
    the sequential model's; the replicated leaves' alike on every stage;
    the stage tree against JAX's frozen gradients where they are kept."""
    ranks = layout_ranks(worlds, layout, "pp:grads")
    pipe = mw.PP_LAYOUTS[layout][1][1]
    full = sequential_tree(ranks, "grads", pipe)
    assert set(full) == set(sequential["grads"])
    for name, want in sequential["grads"].items():
        np.testing.assert_allclose(full[name], want, atol=GRAD_ATOL, rtol=0, err_msg=name)
    for got in ranks:
        for name in ("embed", "unembed"):
            assert np.array_equal(got["grads"][name], ranks[0]["grads"][name]), name
    prefix = f"grads/{layout}/"
    kept = [k for k in golden if k.startswith(prefix) and k != prefix + "loss"]
    assert bool(kept) == (layout == mw.PP_GRADS[0])
    for key in kept:
        name = key[len(prefix):]
        if name.startswith("stages/"):
            got = np.concatenate([ranks[s]["grads"][name] for s in range(pipe)])
        else:
            got = ranks[0]["grads"][name]
        np.testing.assert_allclose(got, golden[key], atol=GRAD_ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("layout", list(mw.PP_LAYOUTS))
def test_pipeline_train_step_dp_pp(worlds, one_device, golden, layout):
    """Three dp x pp steps on a repeated batch: finite losses that fall,
    each within 2^-20 of the sequential model's one-device step and of
    JAX's; the parameters gathered over the stages within 1e-5."""
    ranks = layout_ranks(worlds, layout)
    _, (data, pipe) = mw.PP_LAYOUTS[layout]
    for r, got in enumerate(ranks):
        assert got["dims"] == {"data": data, "pipe": pipe}
        assert got["coords"] == [r // pipe, r % pipe]
        losses = got["losses"]
        assert np.all(np.isfinite(losses)) and losses[1] < losses[0] and losses[2] < losses[1]
        for a, b in zip(losses, one_device["losses"], strict=True):
            assert within(a, b, LOSS_RTOL), (r, a, b)
        for a, b in zip(losses, golden[f"steps/{layout}"], strict=True):
            assert within(a, float(b), LOSS_RTOL), (r, a, b)
    full = sequential_tree(ranks, "params", pipe)
    assert set(full) == set(one_device["params"])
    for name, want in one_device["params"].items():
        assert full[name].shape == want.shape, name
        assert param_err(full[name], want, one_device["params"]) <= PARAM_RTOL, name


@pytest.mark.parametrize("layout", list(mw.PP_LAYOUTS))
def test_pipeline_ranks_agree_bit_for_bit(worlds, layout):
    """The loss and the replicated leaves on every rank, and every leaf
    across the data replicas of one stage."""
    ranks = layout_ranks(worlds, layout)
    pipe = mw.PP_LAYOUTS[layout][1][1]
    for r, got in enumerate(ranks):
        assert got["losses"] == ranks[0]["losses"]
        for name, value in got["params"].items():
            if not name.startswith("stages/"):
                assert np.array_equal(value, ranks[0]["params"][name]), (r, name)
            assert np.array_equal(value, ranks[r % pipe]["params"][name]), (r, name)


def test_the_control_without_the_reverse_handoff_fails(worlds, one_device):
    """With the hand-off's backward cut, stage 0 gets no gradient from the
    loss (its layers move by the weight decay alone) and ``embed`` none
    either: the checks catch both."""
    ranks = [tw.result_of(worlds[2], "pp:control", r) for r in range(2)]
    full = sequential_tree(ranks, "params", 2)
    worst = {name: param_err(full[name], want, one_device["params"])
             for name, want in one_device["params"].items()}
    assert worst["layers/0/wqkv"] > PARAM_RTOL and worst["layers/1/w_up"] > PARAM_RTOL
    assert worst["embed"] > PARAM_RTOL
    assert ranks[0]["losses"][0] == one_device["losses"][0]
    assert not all(within(a, b, LOSS_RTOL)
                   for a, b in zip(ranks[0]["losses"][1:], one_device["losses"][1:]))


@pytest.mark.parametrize("world", WORLDS)
def test_pipeline_param_sharding_lands_on_pipe(worlds, world):
    """``make_pipeline_train_state`` on a pp-only mesh: every stage leaf is
    cut on "pipe" (spec ``("pipe",)``), the rank holding its
    ``[1, L/S, ...]`` block of the full tree; embed/unembed replicated."""
    for rank in range(world):
        got = tw.result_of(worlds[world], "pp:cut", rank)
        assert got["dims"] == {"data": 1, "pipe": world}
        assert set(got["specs"].values()) == {("pipe",)}
        assert got["own_block"] and got["replicated"]
        for name, shape in got["shapes"].items():
            assert shape == (1,) + got["full"][name][1:], name
            assert got["full"][name][:2] == (world, 4 // world), name


def test_pipeline_rejects_bad_shapes(worlds):
    """JAX's refusals, by their text."""
    for rank in range(2):
        got = tw.result_of(worlds[2], "pp:refusals", rank)
        assert got["layers"] == "ValueError: n_layers (3) must divide into 2 stages"
        assert got["microbatches"] == "ValueError: batch 6 not divisible by n_microbatches=4"
        assert got["too_many"] == ("ValueError: requested a 4-device mesh but only 2 devices "
                                   "are visible")
        assert got["indivisible"] == "ValueError: 2 devices not divisible by pipe_parallel=3"


def test_pipeline_specs_follow_gqa_tree():
    from workloads_torch.model import ModelConfig
    from workloads_torch.pipeline import pipeline_param_specs

    gqa = ModelConfig(n_heads=4, n_kv_heads=2, dtype=torch.float32)
    specs = pipeline_param_specs(gqa)["stages"]
    assert "wqkv" not in specs and {"wq", "wkv"} <= set(specs)
    mha = pipeline_param_specs(ModelConfig())
    assert mha["stages"]["wqkv"] == ("pipe",) and mha["embed"] == mha["unembed"] == ()


class RankView:
    """One rank's view of a mesh without a world: the axes' sizes and this
    rank's index on each (what the pipeline reads when no axis needs a
    collective)."""

    def __init__(self, names, sizes=None, index=None):
        self.mesh_dim_names = tuple(names)
        self.sizes = sizes or (1,) * len(names)
        self.index = index or (0,) * len(names)

    def size(self, dim):
        return self.sizes[dim]

    def get_local_rank(self, dim):
        return self.index[dim]


def test_one_stage_is_the_sequential_model():
    """On a 1 x 1 (data, pipe) view, ``pipeline_loss_fn`` and its gradients
    are the sequential model's within 1e-6, relative to each leaf's largest
    value; ``init_pipeline_params`` stacks ``init_params``' draws."""
    from workloads_torch import train
    from workloads_torch.model import init_params
    from workloads_torch.pipeline import init_pipeline_params, pipeline_loss_fn

    tree = mw.pp_port_params(1)
    leaves = train.tree_leaves(tree)
    for p in leaves:
        p.requires_grad_(True)
    loss = pipeline_loss_fn(tree, torch.as_tensor(mw.pp_tokens(0)), mw.pp_config(),
                            RankView(("data", "pipe")), mw.PP_MICRO)
    by_leaf = dict(zip(map(id, leaves), torch.autograd.grad(loss, leaves)))
    grads = trw.flat(train.tree_map(lambda p: by_leaf[id(p)], tree))
    want = sequential_grads()
    assert within(loss.item(), want["loss"], 1e-6)
    got = sequential_tree([{"grads": grads}], "grads", 1)
    for name, w in want["grads"].items():
        assert np.abs(got[name] - w).max() <= 1e-6 * np.abs(w).max(), name
    config = mw.pp_config()
    stacked = init_pipeline_params(config, 2, prng.PRNGKey(4, device="cpu"))
    flat = init_params(config, prng.PRNGKey(4, device="cpu"))
    for name, leaf in stacked["stages"].items():
        assert torch.equal(leaf[1, 0], flat["layers"][2][name]), name


def test_params_from_jax_maps_the_stage_tree():
    """``convert.params_from_jax`` maps the ``[S, L/S, ...]`` stage tree as
    nested: same keys, shapes and bits."""
    numpy_tree = mw.stack_stages(mw.pp_numpy_layers(), 2)
    got = mw.pp_port_params(2)
    assert set(got) == {"embed", "unembed", "stages"}
    assert set(got["stages"]) == set(numpy_tree["stages"])
    for name, leaf in numpy_tree["stages"].items():
        assert got["stages"][name].shape == leaf.shape == (2, 2) + leaf.shape[2:]
        assert np.array_equal(got["stages"][name].numpy(), leaf), name
