"""Live parity of the port's training slice against the JAX package:
flash attention forward and backward, ``loss_fn`` and its gradients,
three train steps and the AdamW update, on the inputs that
tests/test_torch_flash.py and tests/test_torch_train.py draw from numpy
seeds, compared at their tolerances.

Slow by the repo's rule (it imports jax and workloads); run it with
``JAX_PLATFORMS=cpu python -m pytest tests/test_torch_train_parity.py -m slow``.
The JAX side runs its Pallas kernels in interpret mode, as the JAX
package's own CPU tests do;

    python tests/test_torch_train_parity.py --write-goldens

regenerates tests/test_torch_train_golden.npz (a fixture of its own, so
tests/test_torch_golden.npz stays under its 1 MB cap).
"""

from __future__ import annotations

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import pytest  # noqa: E402

import workloads.model as jmodel  # noqa: E402
import workloads_torch.model as tmodel  # noqa: E402
from tests import test_torch_flash as tf  # noqa: E402
from tests import test_torch_train as tt  # noqa: E402
from workloads import train as jtrain  # noqa: E402
from workloads.ops import attention as jattn  # noqa: E402

JAX_DTYPES = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def _np(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.float32))


def jax_flash_outputs(name: str, inp: dict) -> dict:
    """flash_attention (Pallas interpret) out, the forward's lse, and the
    gradients of sum(out * dout) through both backward options."""
    _, _, _, _, _, causal, window, _, dt, block = tf.FLASH_CASES[name]
    dtype = JAX_DTYPES[dt]
    q, k, v, dout = (jnp.asarray(inp[n], dtype) for n in ("q", "k", "v", "dout"))
    seg = None if inp["segment_ids"] is None else jnp.asarray(inp["segment_ids"])
    _, lse = jattn._flash_forward(q, k, v, causal, True, block, block, window, seg)
    out = {"lse": _np(lse)}
    for impl, suffix in (("pallas", ""), ("xla", "_xla")):
        def f(q, k, v, impl=impl):
            return jattn.flash_attention(q, k, v, causal, True, block, block, impl,
                                         window, seg)

        o, vjp = jax.vjp(f, q, k, v)
        if impl == "pallas":
            out["out"] = _np(o)
        for g_name, g in zip(tf.GRADS, vjp(dout)):
            out[g_name + suffix] = _np(g)
    return out


def jax_config(name: str, dtype=None) -> jmodel.ModelConfig:
    dt, kv, win = tt.MODEL_CASES[name]
    return jmodel.ModelConfig(
        vocab_size=256, d_model=64, n_heads=4, n_layers=2, d_ff=128,
        max_seq_len=33, dtype=dtype or JAX_DTYPES[dt], n_kv_heads=kv,
        attention_window=win, attention_impl="flash",
    )


def jax_loss_and_grads(name: str) -> dict:
    """bf16 runs with jit disabled, so each operation rounds where the
    source says (tests/test_torch_parity.py says why)."""
    config = jax_config(name)
    params = jax.tree.map(jnp.asarray, tt.numpy_params(config))
    tokens = jnp.asarray(tt.numpy_tokens(config, 0))
    fn = jax.value_and_grad(jmodel.loss_fn)
    if config.dtype == jnp.float32:
        loss, grads = fn(params, tokens, config)
    else:
        with jax.disable_jit():
            loss, grads = fn(params, tokens, config)
    out = {"loss": np.asarray(float(loss), np.float32)}
    out.update({f"grad/{k}": _np(v) for k, v in tt.flat(grads).items()})
    return out


def jax_train_steps() -> dict:
    """The JAX package's jitted train step (optax.adamw(1e-3,
    mu_dtype=bf16)) on a one-device mesh, three steps."""
    config = jax_config("f32_mha", dtype=jnp.float32)
    params = jax.tree.map(jnp.asarray, tt.numpy_params(config))
    optimizer = optax.adamw(1e-3, mu_dtype=jnp.bfloat16)
    opt_state = optimizer.init(params)
    step = jtrain.make_train_step(config, jtrain.make_mesh(1, 1), optimizer)
    losses = []
    for s in range(tt.TRAIN_STEPS):
        params, opt_state, loss = step(params, opt_state,
                                       jnp.asarray(tt.numpy_tokens(config, s)))
        losses.append(float(loss))
    out = {"losses": np.asarray(losses, np.float32)}
    out.update({f"params/{k}": _np(v) for k, v in tt.flat(params).items()})
    return out


def jax_adamw() -> dict:
    inp = tt.adamw_inputs()
    names = list(tt.ADAMW_SHAPES)
    params = {k: jnp.asarray(inp[f"p/{k}"]) for k in names}
    optimizer = optax.adamw(1e-3, mu_dtype=jnp.bfloat16)
    state = optimizer.init(params)

    @jax.jit
    def update(params, state, grads):
        updates, state = optimizer.update(grads, state, params)
        return optax.apply_updates(params, updates), state

    out = {}
    for step in range(3):
        grads = {k: jnp.asarray(inp[f"g{step}/{k}"]) for k in names}
        params, state = update(params, state, grads)
        out.update({f"params{step}/{k}": _np(v) for k, v in params.items()})
    adam = state[0]
    out.update({f"mu/{k}": _np(v) for k, v in adam.mu.items()})
    out.update({f"nu/{k}": _np(v) for k, v in adam.nu.items()})
    return out


@pytest.fixture
def jax_flash_everywhere(monkeypatch):
    monkeypatch.setattr(jmodel, "flash_min_seq", lambda: 1)
    monkeypatch.setattr(tmodel, "flash_min_seq", lambda: 1)


@pytest.mark.parametrize("name", sorted(tf.FLASH_CASES))
def test_flash_matches_jax_live(name):
    inp = tf.make_flash_inputs(name)
    want = jax_flash_outputs(name, inp)
    got = tf.port_flash_outputs(name, inp)
    assert not tf.flash_mismatches(name, got, want), tf.flash_mismatches(name, got, want)


@pytest.mark.parametrize("name", sorted(tt.MODEL_CASES))
def test_loss_and_grads_match_jax_live(jax_flash_everywhere, name):
    want = jax_loss_and_grads(name)
    got = tt.port_loss_and_grads(name)
    assert not tt.model_mismatches(name, got, want), tt.model_mismatches(name, got, want)


def test_train_steps_match_jax_live(jax_flash_everywhere):
    got, want = tt.port_train_steps(), jax_train_steps()
    assert not tt.train_mismatches(got, want), tt.train_mismatches(got, want)


def test_adamw_matches_optax_live():
    got, want = tt.port_adamw(), jax_adamw()
    assert not tt.adamw_mismatches(got, want), tt.adamw_mismatches(got, want)


def _store(arrays: dict, key: str, a: np.ndarray, bf16: bool) -> None:
    """float32 as it is; a bf16 case's arrays as their bf16 bits (exact:
    they are bf16 values)."""
    if bf16:
        arrays[key + "@bf16"] = np.asarray(a, np.float32).astype(ml_dtypes.bfloat16).view(np.uint16)
    else:
        arrays[key] = np.asarray(a, np.float32)


def write_goldens(path: str = tf.GOLDEN) -> None:
    arrays = {}
    for name in sorted(tf.FLASH_CASES):
        out = jax_flash_outputs(name, tf.make_flash_inputs(name))
        bf16 = tf.FLASH_CASES[name][8] == "bf16"
        for k, v in out.items():
            _store(arrays, f"flash/{name}/{k}", v, bf16 and k != "lse")
    saved = jmodel.flash_min_seq
    jmodel.flash_min_seq = lambda: 1
    try:
        # Gradients of float32 master weights are float32 in both dtypes.
        for name in sorted(tt.MODEL_CASES):
            for k, v in jax_loss_and_grads(name).items():
                _store(arrays, f"model/{name}/{k}", v, False)
        for k, v in jax_train_steps().items():
            _store(arrays, f"train/{k}", v, False)
    finally:
        jmodel.flash_min_seq = saved
    for k, v in jax_adamw().items():
        _store(arrays, f"adamw/{k}", v, False)
    np.savez_compressed(path, **arrays)
    print(f"wrote {path}: {len(arrays)} arrays, {os.path.getsize(path)} bytes")


if __name__ == "__main__":
    if "--write-goldens" in sys.argv:
        write_goldens()
    else:
        print(__doc__)
