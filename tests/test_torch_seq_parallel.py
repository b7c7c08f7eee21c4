"""Sequence parallelism on gloo CPU worlds of 2 and 4 ranks: ring, Ulysses
and USP attention (workloads_torch/ops/ring.py, ulysses.py, usp.py) on a
rank's span, and the sequence-parallel training step
(train.make_seq_parallel_train_step over make_sp_mesh/make_usp_mesh),
held against the port's dense core and one-device step and against the
JAX package's runs on the same numpy inputs, frozen in
tests/test_torch_train_parallel_golden.npz.

Tolerances, float32:

* attention output within 2e-5 and the gradients of sum(out**2) within
  1e-4, absolute, of the dense core (``model.masked_attention``), causal
  and full: the JAX tests' own (tests/test_ring_attention.py,
  test_ulysses.py, test_usp.py); the same against JAX's frozen outputs,
  and Ulysses against ring and USP against both at 2e-5;
* the steps' losses within 2^-20 of the one-device dense step's,
  relative, and of JAX's frozen steps'; readings: equal to one device's
  but step 2 of DP2 x ring (8.6e-8); JAX's 8.6e-8 to 1.7e-7 from them;
  the gathered parameters within 1e-5 of the tree's largest |value|
  (readings 7.6e-6 to 7.7e-6), as tests/test_torch_train_parallel.py;
* every rank of the sequence axes holds the parameters bit for bit alike
  (nothing outside attention depends on the rank's span);
* every refusal of the JAX package, by its text.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tests import torch_tp_world as tw
from tests import torch_train_world as trw
from tests.test_torch_train_parallel import (
    LOSS_RTOL,
    PARAM_RTOL,
    golden,  # noqa: F401 — the module's fixture
    one_device,  # noqa: F401 — the module's fixture
    one_torch_thread,  # noqa: F401 — the module's fixture
    WORLDS,
    param_err,
    within,
)

OUT_ATOL = 2e-5
GRAD_ATOL = 1e-4
OPS = list(trw.OPS)
SP = list(trw.SP_LAYOUTS)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return tw.run_worlds(tmp_path_factory, WORLDS, trw.seq_scenarios, module=trw.__name__)


@pytest.fixture(scope="module")
def dense():
    q, k, v = trw.numpy_qkv()
    return {mask: trw.dense_attention(q, k, v, mask == "causal") for mask in ("causal", "full")}


def op_ranks(worlds, name: str) -> list:
    world, _, _ = trw.OPS[name]
    return [tw.result_of(worlds[world], f"op:{name}", r) for r in range(world)]


def assert_close(got: dict, want: dict, label: str) -> None:
    for key, value in want.items():
        atol = OUT_ATOL if key == "out" else GRAD_ATOL
        np.testing.assert_allclose(got[key], value, rtol=0, atol=atol, err_msg=f"{label} {key}")


@pytest.mark.parametrize("mask", ["causal", "full"])
@pytest.mark.parametrize("name", OPS)
def test_attention_matches_dense(worlds, dense, name, mask):
    """Every rank's joined output and whole-input gradients."""
    for rank, got in enumerate(op_ranks(worlds, name)):
        assert_close(got[mask], dense[mask], f"{name} rank {rank}")


@pytest.mark.parametrize("mask", ["causal", "full"])
@pytest.mark.parametrize("name", OPS)
def test_attention_matches_frozen_jax(worlds, golden, name, mask):  # noqa: F811
    want = {key: golden[f"op/{name}/{mask}/{key}"] for key in ("out", "dq", "dk", "dv")}
    assert_close(op_ranks(worlds, name)[0][mask], want, name)


@pytest.mark.parametrize("world", [2, 4])
def test_ulysses_matches_ring(worlds, world):
    ring, uly = op_ranks(worlds, f"ring{world}")[0], op_ranks(worlds, f"ulysses{world}")[0]
    for mask in ("causal", "full"):
        np.testing.assert_allclose(uly[mask]["out"], ring[mask]["out"], rtol=0, atol=OUT_ATOL)


def test_usp_matches_ring_and_ulysses(worlds):
    usp = op_ranks(worlds, "usp_r2u2")[0]
    for other in ("ring4", "ulysses4"):
        got = op_ranks(worlds, other)[0]
        for mask in ("causal", "full"):
            np.testing.assert_allclose(usp[mask]["out"], got[mask]["out"], rtol=0,
                                       atol=OUT_ATOL, err_msg=other)


def sp_ranks(worlds, name: str) -> list:
    world = trw.SP_LAYOUTS[name][0]
    return [tw.result_of(worlds[world], f"sp:{name}", r) for r in range(world)]


@pytest.mark.parametrize("name", SP)
def test_seq_parallel_step_matches_one_device(worlds, one_device, name):  # noqa: F811
    ranks = sp_ranks(worlds, name)
    for rank, got in enumerate(ranks):
        for s, (a, b) in enumerate(zip(got["losses"], one_device["losses"], strict=True)):
            assert within(a, b, LOSS_RTOL), (rank, s, a, b)
    for name_, want in one_device["params"].items():
        assert param_err(ranks[0]["params"][name_], want, one_device) <= PARAM_RTOL, name_


@pytest.mark.parametrize("name", SP)
def test_seq_parallel_step_matches_frozen_jax(worlds, golden, name):  # noqa: F811
    for got in sp_ranks(worlds, name):
        for a, b in zip(got["losses"], golden[f"sp/{name}"], strict=True):
            assert within(a, float(b), LOSS_RTOL), (a, b)


@pytest.mark.parametrize("name", SP)
def test_seq_parallel_ranks_agree_bit_for_bit(worlds, name):
    ranks = sp_ranks(worlds, name)
    _, _, builder, kw = trw.SP_LAYOUTS[name]
    dims = ranks[0]["dims"]
    if builder == "usp":
        assert dims == {"data": 1, "seq_r": kw["ring"], "seq_u": kw["ulysses"], "model": 1}
    else:
        assert dims == {"data": len(ranks) // kw["seq_parallel"], "seq": kw["seq_parallel"],
                        "model": 1}
    for got in ranks[1:]:
        assert got["losses"] == ranks[0]["losses"]
        for key, value in got["params"].items():
            assert np.array_equal(value, ranks[0]["params"][key]), key


# The JAX package's refusals (workloads/train.py, workloads/ops/*.py) on
# this world, by text.
REFUSALS = {
    "sp_zero": "ValueError: n_devices must be positive, got 0",
    "usp_zero": "ValueError: n_devices must be positive, got 0",
    "sp_indivisible": "ValueError: {n} devices not divisible by seq*model=3",
    "sp_too_many": "ValueError: requested a {n2}-device mesh but only {n} devices are visible",
    "gqa": "ValueError: sequence-parallel attention does not support grouped-query configs "
           "yet (n_kv_heads=2); the ring/ulysses shardings assume equal q and k/v head counts",
    "usp_on_sp": "ValueError: attention='usp' needs mesh axes ['seq_r', 'seq_u'] (build the "
                 "mesh with make_usp_mesh); got ('data', 'seq', 'model')",
    "bad_seq_len": "ValueError: max_seq_len-1 (15) must divide across the seq sharding ({n}); "
                   "pick max_seq_len = k*{n} + 1",
    "ulysses_heads": "ValueError: ulysses attention needs n_heads (3) divisible by the seq "
                     "axis ({n}); use attention='ring'",
    "unknown": "ValueError: unknown attention 'dense' (ring|ulysses|usp)",
    "seq_slice": "ValueError: seq 31 not divisible by mesh axis 'seq' size {n}",
    "op_heads": "ValueError: heads {n1} not divisible by mesh axis 'seq' size {n} (use ring "
                "attention for head counts the axis cannot split)",
}
USP_REFUSALS = {
    "ring_on_usp": "ValueError: attention='ring' needs mesh axes ['seq'] (build the mesh "
                   "with make_sp_mesh); got ('data', 'seq_r', 'seq_u', 'model')",
    "usp_heads": "ValueError: usp attention needs n_heads (1) divisible by the seq_u axis (2)",
    "usp_seq": "ValueError: seq 30 not divisible by seq_r*seq_u = 2*2",
    "usp_op_heads": "ValueError: heads 3 not divisible by seq_u size 2",
}


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("key", list(REFUSALS))
def test_refusals_keep_jax_text(worlds, world, key):
    got = tw.result_of(worlds[world], "sp_refusals")
    assert got[key] == REFUSALS[key].format(n=world, n1=world + 1, n2=world + 2)


@pytest.mark.parametrize("key", list(USP_REFUSALS))
def test_usp_refusals_keep_jax_text(worlds, key):
    assert tw.result_of(worlds[4], "sp_refusals")[key] == USP_REFUSALS[key]


@pytest.mark.parametrize("world", [2, 4])
def test_mesh_builders_keep_jax_shapes(worlds, world):
    got = tw.result_of(worlds[world], "sp_refusals")
    assert got["sp_shape"] == {"data": 1, "seq": world, "model": 1}
    if world == 4:
        assert got["usp_shape"] == {"data": 1, "seq_r": 2, "seq_u": 2, "model": 1}


def test_meshes_need_a_world():
    from workloads_torch.train import make_sp_mesh, make_usp_mesh

    assert not torch.distributed.is_initialized()
    for make in (make_sp_mesh, make_usp_mesh):
        with pytest.raises(RuntimeError, match="initialised torch.distributed world"):
            make(device_type="cpu")
