"""The port's flash attention (workloads_torch.ops.attention) held against
the JAX package's outputs, frozen in tests/test_torch_train_golden.npz.

torch and numpy only, so it runs in the fast tier.  On the CPU the port
runs its plain versions: ``flash_forward_reference`` walking k in the
JAX call's blocks, and ``flash_backward_reference``.  The fixture holds
what the JAX package computed on the same inputs (drawn here from numpy
seeds): ``flash_attention``'s output and the forward's lse with the
Pallas kernel in interpret mode, the gradients through the Pallas
backward kernels (``_flash_backward_pallas``) and through the dense
backward (``_flash_backward_xla``).  ``python
tests/test_torch_train_parity.py --write-goldens`` regenerates it;
that file runs the same comparisons live.

Tolerances, as a share of the largest |value| compared (rtol 0):

* float32: 2^-18 (3.8e-6) for every output; the two frameworks sum in
  different orders.  Readings: at most 5.5e-7.
* bfloat16 against the Pallas route (out, lse, the three gradients):
  2^-10 (9.8e-4): the port rounds p and ds where the Pallas kernels
  do, so an element differs only where a float32 sum-order difference
  flips a bf16 rounding.  Readings: at most 1.4e-4 (most outputs are
  bit-identical).  The controls must fail: the JAX package's own dense
  backward, which keeps p and ds in float32, misses the Pallas
  gradients by 3.0e-3-6.6e-3 of the largest value; and the forward
  with p kept in float32 misses by 2.6e-3-5.0e-3.
* bfloat16 ``bwd_impl="xla"``: the port's dense backward takes the
  Pallas roundings, so it is held to the Pallas gradients at the same
  limit, not to JAX's dense backward.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from workloads_torch.ops import attention as fa

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "test_torch_train_golden.npz")

# name: batch, seq, heads, kv_heads, head_dim, causal, window, segments,
# dtype, block (block_q = block_k of the JAX call).  Every seq is ragged
# against its block, and all but one walk several k blocks.
FLASH_CASES = {
    "mha_causal_f32": (2, 50, 2, 2, 16, True, None, False, "f32", 16),
    "gqa_causal_f32": (1, 70, 4, 2, 16, True, None, False, "f32", 32),
    "gqa8_full_f32": (1, 40, 8, 1, 16, False, None, False, "f32", 16),
    "window_f32": (1, 90, 2, 1, 32, True, 20, False, "f32", 32),
    "segments_causal_f32": (2, 48, 2, 2, 16, True, None, True, "f32", 16),
    "segments_full_f32": (1, 50, 2, 2, 16, False, None, True, "f32", 16),
    "one_block_f32": (1, 33, 2, 2, 16, True, None, False, "f32", 512),
    "mha_causal_bf16": (2, 50, 2, 2, 16, True, None, False, "bf16", 16),
    "gqa_window_bf16": (1, 90, 4, 2, 32, True, 20, False, "bf16", 32),
    "segments_full_bf16": (1, 50, 2, 2, 16, False, None, True, "bf16", 16),
}
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
F32_LIMIT = 2.0**-18
BF16_LIMIT = 2.0**-10
GRADS = ("dq", "dk", "dv")


def make_flash_inputs(name: str) -> dict:
    """q, k, v, dout (float32 numpy) and segment_ids (or None) of a case."""
    batch, seq, heads, kv_heads, hd, _, _, segments, _, _ = FLASH_CASES[name]
    rng = np.random.default_rng(sorted(FLASH_CASES).index(name))
    inp = {
        "q": rng.standard_normal((batch, seq, heads, hd)).astype(np.float32),
        "k": rng.standard_normal((batch, seq, kv_heads, hd)).astype(np.float32),
        "v": rng.standard_normal((batch, seq, kv_heads, hd)).astype(np.float32),
        "dout": rng.standard_normal((batch, seq, heads, hd)).astype(np.float32),
        "segment_ids": None,
    }
    if segments:
        # Packed documents: sorted ids, so each row holds a few runs.
        inp["segment_ids"] = np.sort(rng.integers(0, 3, (batch, seq)), axis=1).astype(np.int32)
    return inp


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def port_flash_outputs(name: str, inp: dict, f32_p: bool = False) -> dict:
    """What the port computes for a case: out, lse, and the gradients of
    sum(out * dout) through the default backward and through
    ``bwd_impl="xla"``.  ``f32_p`` runs the control forward that keeps p
    in float32 (the inputs rounded to the case dtype, then float32)."""
    _, seq, _, _, _, causal, window, _, dt, block = FLASH_CASES[name]
    dtype = DTYPES[dt]
    seg = None if inp["segment_ids"] is None else torch.from_numpy(inp["segment_ids"])
    q, k, v = (torch.from_numpy(inp[n]).to(dtype) for n in ("q", "k", "v"))
    dout = torch.from_numpy(inp["dout"]).to(dtype)
    out = {}
    if f32_p:
        o, lse = fa.flash_forward_reference(
            q.float(), k.float(), v.float(), causal, window, seg,
            block_k=fa._clamp_block(block, seq))
        out["out"], out["lse"] = _np(o.to(dtype)), _np(lse)
        return out
    _, lse = fa.flash_forward_reference(q, k, v, causal, window, seg,
                                        block_k=fa._clamp_block(block, seq))
    out["lse"] = _np(lse)
    for impl, suffix in (("pallas", ""), ("xla", "_xla")):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        o = fa.flash_attention(*leaves, causal=causal, block_q=block, block_k=block,
                               bwd_impl=impl, window=window, segment_ids=seg)
        grads = torch.autograd.grad(o, leaves, dout)
        if impl == "pallas":
            out["out"] = _np(o)
        for g_name, g in zip(GRADS, grads):
            out[g_name + suffix] = _np(g)
    return out


def share(got: np.ndarray, want: np.ndarray) -> float:
    """max |got - want| as a share of max |want|."""
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def flash_comparisons(name: str) -> list[tuple[str, str, float]]:
    """(port key, JAX key, limit) for a case.  bf16 holds both backward
    options to the Pallas gradients (module docstring)."""
    limit = F32_LIMIT if FLASH_CASES[name][8] == "f32" else BF16_LIMIT
    rows = [("out", "out", limit), ("lse", "lse", limit)]
    for g in GRADS:
        rows.append((g, g, limit))
        rows.append((g + "_xla", g + ("_xla" if limit == F32_LIMIT else ""), limit))
    return rows


def flash_mismatches(name: str, got: dict, want: dict) -> dict:
    return {
        (g, w): s for g, w, limit in flash_comparisons(name)
        if not (s := share(got[g], want[w])) <= limit
    }


def load_golden(path: str = GOLDEN) -> dict:
    """The fixture as float32 arrays; bf16 entries are stored as bits."""
    out = {}
    with np.load(path) as f:
        for key in f.files:
            a = f[key]
            if key.endswith("@bf16"):
                a = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).float().numpy()
                key = key[:-len("@bf16")]
            out[key] = a
    return out


def case_golden(golden: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in golden.items() if k.startswith(prefix)}


@pytest.fixture(scope="module")
def golden():
    return load_golden()


@pytest.mark.parametrize("name", sorted(FLASH_CASES))
def test_flash_matches_jax_goldens(golden, name):
    """out, lse and both backwards against the JAX package's outputs."""
    want = case_golden(golden, f"flash/{name}/")
    got = port_flash_outputs(name, make_flash_inputs(name))
    assert not flash_mismatches(name, got, want), flash_mismatches(name, got, want)


@pytest.mark.parametrize("name", [n for n in sorted(FLASH_CASES) if n.endswith("bf16")])
def test_flash_bf16_limit_rejects_controls(golden, name):
    """The bf16 limit tells the Pallas roundings apart: JAX's own dense
    backward (p and ds in float32) misses the Pallas gradients, and so
    does the forward with p kept in float32."""
    want = case_golden(golden, f"flash/{name}/")
    assert all(share(want[g + "_xla"], want[g]) > BF16_LIMIT for g in GRADS)
    control = port_flash_outputs(name, make_flash_inputs(name), f32_p=True)
    assert share(control["out"], want["out"]) > BF16_LIMIT


def test_cpu_runs_plain_versions_and_counts_no_launch():
    """CPU tensors take the plain versions; no kernel counter moves."""
    counters = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    before = [c.launches for c in counters]
    q = torch.randn(1, 20, 2, 16, requires_grad=True)
    fa.flash_attention(q, q.detach(), q.detach()).sum().backward()
    assert [c.launches for c in counters] == before
    assert q.grad is not None and torch.isfinite(q.grad).all()


def test_saves_no_seq_by_seq_tensor():
    """The autograd graph keeps (q, k, v, out, lse), never [seq, seq]."""
    seq = 40
    q = torch.randn(1, seq, 2, 16, requires_grad=True)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
        lambda t: saved.append(tuple(t.shape)) or t, lambda t: t
    ):
        fa.flash_attention(q, q, q)
    assert saved and all(s.count(seq) <= 1 for s in saved), saved


def test_flash_matches_dense_softmax_in_f32():
    """Independent check of the plain forward and backward: dense
    float32 softmax attention through autograd."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 37, 4, 16, generator=g, dtype=torch.float64)
               for _ in range(3))
    k, v = k[:, :, :2], v[:, :, :2]
    seg = torch.sort(torch.randint(0, 3, (2, 37), generator=g), dim=1).values
    for causal, window, segs in ((True, None, None), (False, None, seg), (True, 9, seg)):
        leaves = [x.float().requires_grad_(True) for x in (q, k, v)]
        got = fa.flash_attention(*leaves, causal=causal, block_k=16, window=window,
                                 segment_ids=segs)
        g_got = torch.autograd.grad(got.square().sum(), leaves)
        ref = [x.clone().requires_grad_(True) for x in (q, k, v)]
        kr, vr = (x.repeat_interleave(2, dim=2) for x in ref[1:])
        s = torch.einsum("bshk,bthk->bhst", ref[0], kr) / 4.0
        ids = torch.arange(37)
        mask = torch.ones(37, 37, dtype=torch.bool)
        if causal:
            mask &= ids[None, :] <= ids[:, None]
            if window:
                mask &= ids[None, :] > ids[:, None] - window
        mask = mask[None, None]
        if segs is not None:
            mask = mask & (segs[:, None, :, None] == segs[:, None, None, :])
        want = torch.einsum("bhst,bthk->bshk",
                            torch.softmax(s.masked_fill(~mask, -1e30), -1), vr)
        g_want = torch.autograd.grad(want.square().sum(), ref)
        torch.testing.assert_close(got.double(), want, atol=1e-5, rtol=0)
        for a, b in zip(g_got, g_want):
            torch.testing.assert_close(a.double(), b, atol=1e-4, rtol=0)


@pytest.mark.parametrize("kwargs, message", [
    (dict(bwd_impl="triton"), "bwd_impl must be 'pallas' or 'xla'"),
    (dict(causal=False, window=4), "window requires causal=True"),
    (dict(window=0), "window must be >= 1"),
    (dict(segment_ids=torch.zeros(1, 5, dtype=torch.int32)), "segment_ids shape"),
])
def test_validations_raise_with_the_jax_messages(kwargs, message):
    q = torch.randn(1, 8, 2, 16)
    with pytest.raises(ValueError, match=message):
        fa.flash_attention(q, q, q, **kwargs)


def test_gqa_heads_must_divide():
    q = torch.randn(1, 8, 3, 16)
    k = torch.randn(1, 8, 2, 16)
    with pytest.raises(ValueError, match="must be a multiple of kv heads"):
        fa.flash_attention(q, k, k)


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take():
    """The CUDA wrappers' checks run before any library is loaded, so
    they can be exercised with CPU tensors."""
    q = torch.randn(1, 8, 2, 24)
    with pytest.raises(ValueError, match="head_dim in"):
        fa._check_kernel_inputs(q, q, q, None)
    q = torch.randn(1, 8, 16, 16)
    with pytest.raises(ValueError, match="at most 8 query heads"):
        fa._check_kernel_inputs(q, q[:, :, :1], q[:, :, :1], None)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa._check_kernel_inputs(q.half(), q.half(), q.half(), None)
    with pytest.raises(ValueError, match="must share a dtype"):
        fa._check_kernel_inputs(q, q.bfloat16(), q, None)
