"""The data- and tensor-parallel training step (train.make_sharded_train_state,
make_sharded_train_step, make_train_step(mesh=)), LoRA under a mesh and
the two-process training CLI, on gloo CPU worlds of 2 and 4 ranks
(tests/torch_train_world.py's LAYOUTS through tests/torch_tp_world.py's
run_world), held against the port's one-device step on the same weights
and global batches and against the JAX package's meshed steps, frozen in
tests/test_torch_train_parallel_golden.npz (tests/test_torch_parity.py's
write_train_parallel_goldens).

Tolerances, float32, three AdamW steps of the tiny model (d_model 64, 4
heads, 2 layers) on a global batch of 4 x 17 tokens:

* each step's loss within 2^-20 of the one-device loss, relative, and
  within 2^-20 of JAX's; readings: DP2, TP2, TP4 and DP2xTP2 equal to one
  device's but step 2 of DP2 and DP2xTP2 (8.6e-8); JAX's step 2 8.6e-8
  from the port's one device;
* the parameters gathered from the model group within 1e-5 of the
  largest |value| of the tree (the norm gains, about 1); readings
  5.9e-6 (DP2) to 7.7e-6 (DP2xTP2): AdamW's first steps move a weight by
  about lr * g / (|g| + eps), so a gradient near eps whose rounding
  differs moves its weight by a few lr * 1e-3;
* every rank of a model group holds the replicated leaves and the loss
  bit for bit alike, and every rank of a data group its shards;
* the control, TP without the model axis' ``enter`` hook (the backward
  all-reduce of each column-parallel product's input), must miss the
  parameter tolerance.

The one-device step, ``loss_fn`` with no hooks and the one-device LoRA
step are bit for bit what they were before the hooks existed (a digest of
their float32 losses and gradients, frozen below).
"""

from __future__ import annotations

import hashlib
import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest
from workloads_torch import prng
import torch

from tests import torch_tp_world as tw
from tests import torch_train_world as trw

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = (2, 4)
LOSS_RTOL = 2.0**-20
PARAM_RTOL = 1e-5
LAYOUTS = list(trw.LAYOUTS)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return tw.run_worlds(tmp_path_factory, WORLDS, trw.train_scenarios, module=trw.__name__)


@pytest.fixture(scope="module")
def one_device():
    return trw.one_device_steps()


@pytest.fixture(scope="module")
def golden():
    with np.load(trw.GOLDEN) as f:
        return {k: f[k] for k in f.files}


def layout_ranks(worlds, layout: str) -> list:
    world, _ = trw.LAYOUTS[layout]
    return [tw.result_of(worlds[world], f"steps:{layout}", r) for r in range(world)]


def within(got, want, rtol) -> bool:
    return abs(got - want) <= rtol * abs(want)


def param_err(got, want, reference) -> float:
    """A leaf's largest difference as a share of the largest |value| of
    the reference's whole parameter tree (the norm gains, about 1)."""
    largest = max(np.abs(v).max() for v in reference["params"].values())
    return float(np.abs(got - want).max() / largest)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_layout_losses_match_one_device(worlds, one_device, layout):
    for rank, got in enumerate(layout_ranks(worlds, layout)):
        for s, (a, b) in enumerate(zip(got["losses"], one_device["losses"], strict=True)):
            assert within(a, b, LOSS_RTOL), (rank, s, a, b)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_layout_params_match_one_device(worlds, one_device, layout):
    _, (_, model) = trw.LAYOUTS[layout]
    full = trw.gather_params(layout_ranks(worlds, layout), model)
    assert set(full) == set(one_device["params"])
    for name, want in one_device["params"].items():
        assert full[name].shape == want.shape, name
        assert param_err(full[name], want, one_device) <= PARAM_RTOL, name


@pytest.mark.parametrize("layout", LAYOUTS)
def test_layout_losses_match_frozen_jax(worlds, golden, layout):
    want = golden[f"steps/{layout}"]
    for got in layout_ranks(worlds, layout):
        for a, b in zip(got["losses"], want, strict=True):
            assert within(a, float(b), LOSS_RTOL), (a, b)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_ranks_agree_bit_for_bit(worlds, layout):
    """The loss everywhere, the replicated leaves across each model group
    and every leaf across the ranks of one model index (data replicas)."""
    _, (data, model) = trw.LAYOUTS[layout]
    ranks = layout_ranks(worlds, layout)
    assert all(r["dims"] == {"data": data, "model": model} for r in ranks)
    for r, got in enumerate(ranks):
        assert got["coords"] == [r // model, r % model]
        assert got["losses"] == ranks[0]["losses"]
        for name, value in got["params"].items():
            if "model" not in trw.spec_of(name):
                assert np.array_equal(value, ranks[0]["params"][name]), (r, name)
            assert np.array_equal(value, ranks[r % model]["params"][name]), (r, name)


def test_the_control_without_enter_fails_the_gradient_check(worlds, one_device):
    """Without ``enter`` each rank's gradient of a leaf upstream of a
    column-parallel product (norm gains, the embedding) is its own
    heads' part alone, and the check catches it."""
    ranks = [tw.result_of(worlds[2], "control_no_enter", r) for r in range(2)]
    full = trw.gather_params(ranks, 2)
    worst = {name: param_err(full[name], want, one_device)
             for name, want in one_device["params"].items()}
    assert worst["layers/0/ln1"] > PARAM_RTOL
    assert worst["layers/0/wqkv"] > PARAM_RTOL
    assert not all(within(a, b, LOSS_RTOL)
                   for a, b in zip(ranks[0]["losses"], one_device["losses"]))


# ---- LoRA under a mesh ------------------------------------------------------


def test_lora_under_a_mesh_matches_one_device(worlds):
    """DP2: the loss falls, only the adapters move, the base comes out
    bit-unchanged, both ranks agree bit for bit, and the losses and
    adapters equal the one-device LoRA step's within the tolerances."""
    ranks = [tw.result_of(worlds[2], "lora", r) for r in range(2)]
    one = trw.lora_steps()
    for got in ranks:
        assert got["base_unchanged"] and got["adapters_moved"]
        assert got["losses"][-1] < got["losses"][0]
        assert got["losses"] == ranks[0]["losses"]
        for a, b in zip(got["losses"], one["losses"], strict=True):
            assert within(a, b, LOSS_RTOL), (a, b)
        for name, want in one["adapters"].items():
            assert np.array_equal(got["adapters"][name], ranks[0]["adapters"][name]), name
            assert param_err(got["adapters"][name], want, {"params": one["adapters"]}) \
                <= PARAM_RTOL, name


def test_lora_cli_builds_its_mesh_over_the_world(worlds):
    """The LoRA CLI inside a 2-rank world: make_mesh()'s (1, 2) mesh,
    replicated adapters, both ranks' losses alike and the one-device
    CLI's, whose losses a step are JAX's CLI's within
    tests/test_torch_prng_draws.py's tolerance.  (Whether they fall over
    these three steps, on three random batches, is no property of the
    CLI: JAX's own, and the port's from the same seeds, go 5.5435 ->
    5.5451 here.)"""
    from tests import test_torch_prng_draws as tdraws

    outs = [tw.result_of(worlds[2], "lora_cli", r) for r in range(2)]
    assert outs[0] == outs[1]
    one_losses, one = tdraws.cli_losses("workloads_torch", "lora",
                                        tdraws.CLIS["lora"] + ["--device", "cpu"])

    def losses(text):
        return re.search(r"loss (\S+) -> (\S+)", text).groups()

    assert "done: steps=3 rank=2" in outs[0]
    assert losses(outs[0]) == losses(one)
    with np.load(tdraws.PRNG_DRAWS_GOLDEN) as golden:
        assert tdraws.cli_misses(golden, "lora", one_losses) == []


def test_bench_train_step_runs_on_the_world_mesh(worlds):
    """perfbench.time_train_step in a 2-rank world steps on make_mesh()
    (data 1, model 2), as JAX's times its meshed step."""
    for rank in range(2):
        got = tw.result_of(worlds[2], "bench_step", rank)
        assert got["dims"] == [{"data": 1, "model": 2}]
        assert got["secs"] > 0


class RankView:
    """One rank's view of a ("data", "model") mesh without a world: the
    axes' sizes and this rank's index on each (all ``shard_leaf`` and the
    sharded state and step read when no axis needs a collective)."""

    mesh_dim_names = ("data", "model")

    def __init__(self, sizes=(1, 1), index=(0, 0)):
        self.sizes, self.index = sizes, index

    def size(self, dim):
        return self.sizes[dim]

    def get_local_rank(self, dim):
        return self.index[dim]


def test_sharded_step_counts_its_batch_arguments():
    from workloads_torch import train

    step = train.make_sharded_train_step(lambda p, t: t.sum(), RankView(), train.AdamW())
    with pytest.raises(ValueError, match=r"expected 1 batch arguments \(one per batch_specs "
                                         r"entry\), got 2"):
        step({}, {}, torch.zeros(2, 3), torch.zeros(2, 3))


# ---- the one-device paths are what they were --------------------------------

# loss_fn's float32 loss and gradients (dense and flash routes, no
# hooks), three one-device make_train_step steps (losses and parameters)
# and two one-device LoRA steps (losses and factors), on the tree before
# the hooks and the meshed steps existed.  Rewritten when ``lora_init``
# moved to JAX's key stream: its factors are other numbers; with the old
# ``torch.Generator`` factors put back, the digest was the old one,
# 8df381e84b890c02de1609e43856cde76163131adad7c2fc7368692a26bc2988.
PARENT_DIGEST = "6c121a7dcffe47ba66e28ee2b26512ff0a9836f9bb13db5f235a91ceff62a84d"


def one_device_digest() -> str:
    """A digest of the one-device float32 paths' bits; written against
    the API the tree had before the meshed steps (no mesh, no hooks)."""
    from dataclasses import replace

    import unittest.mock

    import workloads_torch.model as tmodel
    from workloads_torch import lora, train
    from workloads_torch.model import loss_fn

    h = hashlib.sha256()

    def add(t):
        h.update(t.detach().contiguous().numpy().tobytes())

    config = trw.port_config()
    tokens = torch.as_tensor(trw.numpy_tokens(0))
    for cfg in (config, replace(config, attention_impl="flash")):
        params = trw.port_params()
        leaves = train.tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        # The flash route at this short sequence, as tests/test_torch_train.py
        # forces it.
        with unittest.mock.patch.object(tmodel, "_pick_kernel", lambda seq: "flash"):
            loss = loss_fn(params, tokens, cfg)
        add(loss)
        for g in torch.autograd.grad(loss, leaves):
            add(g)
    one = trw.one_device_steps(config)
    add(torch.tensor(one["losses"]))
    for value in one["params"].values():
        add(torch.from_numpy(value))
    base = trw.port_params()
    adapters = lora.lora_init(config, 4, prng.PRNGKey(5, device="cpu"))
    for entry in adapters:
        for ab in entry.values():
            ab["b"].normal_(0, 0.01, generator=torch.Generator().manual_seed(6))
    optimizer = train.AdamW(lr=1e-3, mu_dtype=torch.float32)
    opt = optimizer.init(adapters)
    step = lora.make_lora_train_step(config, optimizer, base)
    for s in range(2):
        adapters, opt, loss = step(adapters, opt, torch.as_tensor(trw.numpy_tokens(s)))
        add(loss)
    for leaf in train.tree_leaves(adapters):
        add(leaf)
    return h.hexdigest()


def test_one_device_paths_are_the_ones_before_the_hooks():
    assert one_device_digest() == PARENT_DIGEST


def test_identity_hooks_change_no_bit():
    """``loss_fn`` with identity ``enter`` and ``reduce`` hooks computes
    its loss and gradients bit for bit as without them."""
    from workloads_torch import train
    from workloads_torch.model import loss_fn

    config = trw.port_config()
    tokens = torch.as_tensor(trw.numpy_tokens(1))
    outs = []
    for hooks in ((None, None), (lambda t: t, lambda t: t)):
        params = trw.port_params()
        leaves = train.tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss = loss_fn(params, tokens, config, None, hooks[1], hooks[0])
        outs.append((loss, *torch.autograd.grad(loss, leaves)))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


# ---- the two-process CLI ----------------------------------------------------


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_cli(*args, timeout: float = 240) -> list[str]:
    """``python -m workloads_torch.train --device cpu ...`` as the two
    workers of a slice, joined from the daemon-injected env over gloo;
    each worker's output."""
    port = free_port()
    procs = []
    for worker_id in range(2):
        env = dict(os.environ)
        env.update({"TPU_WORKER_ID": str(worker_id), "TPU_TOPOLOGY": "2x2x2",
                    "TPU_HOST_BOUNDS": "1,1,2",
                    "TPU_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
                    "OMP_NUM_THREADS": "1"})
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "workloads_torch.train", "--device", "cpu", *args],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    for worker_id, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {worker_id} failed:\n{out}"
    return outs


CLI_ARGS = ("--batch-size", "8", "--seq-len", "16", "--layers", "1")


def done_loss(out: str) -> str:
    return re.search(r"done: steps=\d+ mesh=\{'data': 1, 'model': 2\} loss=(\S+)", out).group(1)


def test_two_process_training_cli(tmp_path):
    """JAX's tests/test_distributed.py:151 on the port: `python -m
    workloads_torch.train` joins the slice from the env and runs the full
    step across two processes, on make_mesh()'s (1, 2) mesh; an
    interrupted run resumes from every rank's checkpoint with the loss of
    the run that was not interrupted."""
    outs = run_cli("--steps", "2", *CLI_ARGS)
    for worker_id, out in enumerate(outs):
        assert f"joined slice as worker {worker_id}/2" in out
        assert "done: steps=2" in out
    whole = run_cli("--steps", "3", *CLI_ARGS)
    ckpt = str(tmp_path / "ckpt")
    run_cli("--steps", "2", "--checkpoint-dir", ckpt, *CLI_ARGS)
    assert sorted(os.listdir(ckpt)) == ["rank0", "rank1"]
    resumed = run_cli("--steps", "3", "--checkpoint-dir", ckpt, *CLI_ARGS)
    for out, want in zip(resumed, whole):
        assert "resumed from checkpoint step 2" in out
        assert done_loss(out) == done_loss(want)


class _Leased(Exception):
    pass


@pytest.mark.parametrize("cli, argv", [
    ("train", ["--device", "cpu", "--steps", "1"]),
    ("mfu_sweep", ["--device", "cpu", "--points", "base"]),
])
def test_clis_hold_the_claim_leases_first(monkeypatch, cli, argv):
    """The training CLI and the MFU sweep declare their lifetime
    (``lease.hold_claim_leases``) before any step, as JAX's do."""
    import importlib

    from workloads_torch import lease

    def held(*_a, **_k):
        raise _Leased

    monkeypatch.setattr(lease, "hold_claim_leases", held)
    with pytest.raises(_Leased):
        importlib.import_module(f"workloads_torch.{cli}").main(argv)


def test_abstract_state_allocates_nothing_and_restores(tmp_path):
    """``make_sharded_train_state(abstract=True)``: meta tensors of the
    local shapes and dtypes, a checkpoint restores onto them on the given
    device; the mesh here is one rank's view of a (1, 2) cut, so the
    shapes are the cut's."""
    from workloads_torch import train
    from workloads_torch.checkpoint import TrainCheckpointer
    from workloads_torch.model import param_specs

    mesh = RankView(sizes=(1, 2), index=(0, 1))
    config = trw.port_config()
    (params, opt), _ = train.make_sharded_train_state(mesh, trw.port_params,
                                                      param_specs(config))
    (meta, meta_opt), _ = train.make_sharded_train_state(
        mesh, trw.port_params, param_specs(config), abstract=True)
    real = train.tree_leaves(params) + train.tree_leaves(opt["mu"]) + train.tree_leaves(opt["nu"])
    fake = train.tree_leaves(meta) + train.tree_leaves(meta_opt["mu"]) + \
        train.tree_leaves(meta_opt["nu"])
    assert all(f.device.type == "meta" for f in fake)
    assert [(t.shape, t.dtype) for t in fake] == [(t.shape, t.dtype) for t in real]
    assert params["layers"][0]["wqkv"].shape == (64, 3, 2, 16)
    ckpt = TrainCheckpointer(str(tmp_path))
    ckpt.save(4, (params, opt))
    got, got_opt = ckpt.restore(4, (meta, meta_opt), device="cpu")
    for a, b in zip(train.tree_leaves(got), train.tree_leaves(params)):
        assert a.device.type == "cpu" and torch.equal(a, b)
    with pytest.raises(ValueError, match="needs a device"):
        ckpt.restore(4, (meta, meta_opt))
    with pytest.raises(ValueError, match="abstract=True needs a mesh"):
        train.make_train_state(config, device="cpu", abstract=True)
