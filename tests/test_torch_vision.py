"""The conv-net example workload (workloads_torch/vision.py): shapes,
labels, training on a ("data",) mesh of a 2-rank gloo CPU world
(tests/torch_model_world.py through tests/torch_tp_world.py's
run_worlds), the CLI, and parity with the JAX package's CNN on numpy
weights and images, frozen in tests/test_torch_vision_golden.npz
(tests/test_torch_parity.py's write_vision_goldens).  JAX's
tests/test_vision.py, test for test, and the parity checks.

Tolerances:

* float32 logits within 1e-5 of JAX's largest |logit|, relative
  (reading 7.5e-7), the float32 loss within 2^-20;
* bf16 logits: the floor is JAX's bf16 logits' distance from its float32
  ones (max 1.9e-2, rms 6.5e-3 on 16 images); the port's bf16 logits
  within a quarter of it from JAX's bf16 ones (readings: max 2.8e-3, rms
  4.3e-4: torch's bf16 convolutions round otherwise than XLA's) and
  within sqrt 2 of it from JAX's float32 ones;
* three float32 steps on a 2-rank data mesh: each loss within 2^-20 of
  the one-device step's and of JAX's 2-device step's, the parameters
  within 1e-5 of the largest |value| (reading 3.0e-6).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tests import torch_model_world as mw
from tests import torch_tp_world as tw
from workloads_torch import prng

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
    return tw.run_worlds(tmp_path_factory, (2,), mw.vision_scenarios, module=mw.__name__)


@pytest.fixture(scope="module")
def golden():
    with np.load(mw.VISION_GOLDEN) as f:
        return {k: f[k] for k in f.files}


def test_forward_shapes_and_dtype():
    from workloads_torch.vision import VisionConfig, forward, init_params, synthetic_batch

    config = VisionConfig()
    params = init_params(config, prng.PRNGKey(0, device="cpu"))
    images, labels = synthetic_batch(config, batch=4, device="cpu")
    assert images.shape == (4, 28, 28, 1) and labels.shape == (4,)
    logits = forward(params, images, config)
    assert logits.shape == (4, config.n_classes)
    assert logits.dtype == torch.float32  # loss head stays float32
    assert params["conv1"].shape == (3, 3, 1, 32) and params["dense1"].shape == (14 * 14 * 64, 128)


def test_synthetic_labels_cover_classes():
    from workloads_torch.vision import VisionConfig, synthetic_batch

    config = VisionConfig()
    _, labels = synthetic_batch(config, batch=256, device="cpu")
    assert labels.min() >= 0 and labels.max() < config.n_classes
    # argmax over iid random probes is near-uniform: 256 samples must
    # populate (nearly) all 10 classes, not collapse to a couple.
    assert len(set(labels.tolist())) >= config.n_classes - 1
    again, _ = synthetic_batch(config, batch=256, seed=0, device="cpu")
    other, _ = synthetic_batch(config, batch=256, seed=1, device="cpu")
    assert torch.equal(again, synthetic_batch(config, batch=256, device="cpu")[0])
    assert not torch.equal(again, other)


def test_training_reduces_loss_on_data_mesh(worlds):
    """30 bf16 steps of the seed-0 CNN on one batch of 64, split over a
    ("data",) mesh of two ranks: the loss falls below 0.7 of the first,
    alike on both ranks."""
    ranks = [tw.result_of(worlds[2], "vision:train", r) for r in range(2)]
    for got in ranks:
        assert got["dims"] == {"data": 2}
        first, last = got["losses"][0], got["losses"][-1]
        assert last < first * 0.7, (first, last)
        assert got["losses"] == ranks[0]["losses"]


def test_cli_entry(capsys):
    from workloads_torch.vision import main

    assert main(["--steps", "3", "--batch-size", "16", "--device", "cpu"]) == 0
    assert "done: steps=3 loss " in capsys.readouterr().out


def test_cli_rejects_zero_steps(capsys):
    from workloads_torch.vision import main

    with pytest.raises(SystemExit) as exc:
        main(["--steps", "0"])
    assert exc.value.code != 0
    assert "--steps must be >= 1" in capsys.readouterr().err


class _Leased(Exception):
    pass


def test_cli_holds_the_claim_leases_first(monkeypatch):
    """As JAX's ``main``, before any step."""
    from workloads_torch import lease, vision

    def held(*_a, **_k):
        raise _Leased

    monkeypatch.setattr(lease, "hold_claim_leases", held)
    with pytest.raises(_Leased):
        vision.main(["--device", "cpu", "--steps", "1"])


def port_logits(dtype) -> np.ndarray:
    from workloads_torch.vision import VisionConfig, forward

    images, _ = mw.vision_numpy_batch(0)
    return forward(mw.vision_port_params(), torch.as_tensor(images),
                   VisionConfig(dtype=dtype)).numpy()


def test_float32_logits_and_loss_match_jax(golden):
    from workloads_torch.vision import VisionConfig, loss_fn

    want = golden["logits/f32"]
    got = port_logits(torch.float32)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    images, labels = (torch.as_tensor(a) for a in mw.vision_numpy_batch(0))
    loss = float(loss_fn(mw.vision_port_params(), images, labels,
                         VisionConfig(dtype=torch.float32)))
    assert abs(loss - float(golden["loss/f32"])) <= LOSS_RTOL * float(golden["loss/f32"])


def _max_rms(d) -> tuple[float, float]:
    return float(np.abs(d).max()), float(np.sqrt((d.astype(np.float64) ** 2).mean()))


def test_bf16_logits_within_the_floor(golden):
    floor = _max_rms(golden["logits/bf16"] - golden["logits/f32"])
    got = port_logits(torch.bfloat16)
    to_bf16 = _max_rms(got - golden["logits/bf16"])
    to_f32 = _max_rms(got - golden["logits/f32"])
    assert all(e <= fl / 4 for e, fl in zip(to_bf16, floor)), (to_bf16, floor)
    assert all(e <= 2.0**0.5 * fl for e, fl in zip(to_f32, floor)), (to_f32, floor)


def test_steps_on_the_data_mesh_match_one_device_and_jax(worlds, golden):
    one = mw.vision_steps()
    largest = max(np.abs(v).max() for v in one["params"].values())
    for rank in range(2):
        got = tw.result_of(worlds[2], "vision:steps", rank)
        for a, b, j in zip(got["losses"], one["losses"], golden["steps/dp2"], strict=True):
            assert abs(a - b) <= LOSS_RTOL * abs(b), (a, b)
            assert abs(a - float(j)) <= LOSS_RTOL * abs(float(j)), (a, j)
        for name, want in one["params"].items():
            assert np.abs(got["params"][name] - want).max() <= PARAM_RTOL * largest, name


def test_params_from_jax_maps_the_vision_tree():
    """``convert.params_from_jax`` maps the CNN's flat tree: same keys,
    HWIO shapes and bits."""
    numpy_tree = mw.vision_numpy_params()
    got = mw.vision_port_params()
    assert set(got) == set(numpy_tree) == {"conv1", "conv2", "dense1", "dense2"}
    for name, leaf in numpy_tree.items():
        assert np.array_equal(got[name].numpy(), leaf), name
