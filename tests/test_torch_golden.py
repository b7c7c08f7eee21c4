"""The PyTorch port (workloads_torch) held against the JAX package's
outputs, frozen in tests/test_torch_golden.npz.

torch and numpy only, so it runs in the fast tier.  The fixture holds the
tiny model's parameters (drawn by the JAX package's init_params and
rounded to bfloat16-representable values, so the float32 and bfloat16
cases share one stored copy), the inputs, and what the JAX package
computed from them.  ``python tests/test_torch_parity.py --write-goldens``
regenerates it; tests/test_torch_parity.py runs the same comparisons live.

Tolerances, with their reasons:

* float32: logits, attention outputs and written pages within
  atol = rtol = 1e-4 (the two frameworks sum in different orders; the
  values agree to ~1e-6), greedy token streams identical token for token.
* bfloat16, as a share of the largest |value| compared (rtol 0), since
  the tiny model's logits are only ~1e-2:
  - 2^-10 where the reference rounds to bf16 at the same places as the
    port: the dense forward, decode_block, the paged prefill's logits
    and pages, and paged attention against JAX's Pallas kernel
    (``attention``), whose softmax weights both round to bf16 before the
    p.v product.  The JAX side runs with jit disabled (tests/
    test_torch_parity.py says why).  Readings: the port is
    bit-identical (0); the port run in float32 misses JAX's bf16 output
    by 0.0030-0.0090 of the largest value, and that control must fail
    (``test_bf16_limits_reject_controls``).  The control that keeps the
    softmax weights in float32 (``attention_f32p``, the port's kernel
    before it followed the Pallas rounding) matches JAX's gathered-view
    route (``attention_xla``) bit for bit and misses the Pallas kernel
    by 0.0016-0.0033, so it must fail there
    (``test_attention_rounding_control_fails``).  ``python -m
    tests.test_torch_golden`` prints these readings.
  - 2^-6 against the paged decode step (``decode_logits``).  At its
    [batch, 1, d] shape, XLA and PyTorch sum rmsnorm's float32 mean in
    different orders, so one ulp can flip a bf16 rounding (no pairwise,
    halving or lane-strided order reproduces XLA's on the CPU).
    Readings: the port is within 0.0034-0.0061 of the largest value;
    zeros must fail.  The bf16 arithmetic of the decode step is held
    through the functions it shares with the rows above.
  Greedy bf16 streams are not compared, since near-ties flip.
* filter_logits: the same kept set and kept values within 1e-5.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from workloads_torch import convert
from workloads_torch import generate as tgen
from workloads_torch import paged as tpaged
from workloads_torch import serve as tserve
from workloads_torch.model import ModelConfig, forward
from workloads_torch.ops import paged_attention as tpa

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "test_torch_golden.npz")

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
# (dtype, kv heads, attention window): every case in f32 and bf16, MHA
# and GQA, with and without a window.
CASES = [
    (dt, kv, win)
    for dt in ("f32", "bf16")
    for kv in (None, 2)
    for win in (None, 5)
]
CASE_IDS = [f"{dt}-{'gqa' if kv else 'mha'}-{'win' if win else 'full'}"
            for dt, kv, win in CASES]

# Tolerances (see the module docstring).
F32_TOL = 1e-4
BF16_SAME_ROUNDING = 2.0**-10  # of max |want|
BF16_PALLAS_ROUTE = 2.0**-6  # of max |want|
# (port output, JAX output, bf16 limit): what each comparison holds.
COMPARISONS = [
    ("forward", "forward", BF16_SAME_ROUNDING),
    ("decode_block", "decode_block", BF16_SAME_ROUNDING),
    ("prefill_logits", "prefill_logits", BF16_SAME_ROUNDING),
    ("prefill_k", "prefill_k", BF16_SAME_ROUNDING),
    ("prefill_v", "prefill_v", BF16_SAME_ROUNDING),
    ("attention", "attention", BF16_SAME_ROUNDING),
    ("attention_f32p", "attention_xla", BF16_SAME_ROUNDING),
    ("decode_logits", "decode_logits", BF16_PALLAS_ROUTE),
]
FILTER_ATOL = 1e-5
FILTER_KNOBS = [(0.7, 20, 0.9), (1.0, 0, 0.5), (1.3, 5, 1.0), (0.0, 0, 1.0)]

# Shapes of each comparison.
ATTN_PAGE_SIZE, ATTN_PAGES, ATTN_LAYERS = 4, 12, 2
DECODE_PAGE_SIZE, DECODE_STEPS, DECODE_CHUNK = 4, 9, 6
PREFILL_PAGE_SIZE, PREFILL_LENGTHS = 16, (5, 20, 1)
ENGINE_REQUESTS = 5


def case_key(case) -> str:
    dt, kv, win = case
    return f"{dt}_{'gqa' if kv else 'mha'}_{'win' if win else 'full'}"


def tiny_config(case) -> ModelConfig:
    """The tiny config: d_model 64, 4 heads, 2 layers, d_ff 128, vocab 256."""
    dt, kv, win = case
    return ModelConfig(
        vocab_size=256, d_model=64, n_heads=4, n_layers=2, d_ff=128,
        max_seq_len=64, dtype=DTYPES[dt], n_kv_heads=kv, attention_window=win,
    )


def make_inputs() -> dict:
    """Every input of the comparisons, from numpy seeds."""
    rng = np.random.default_rng(1234)
    hd = 16
    inp = {
        "forward_tokens": rng.integers(0, 256, (2, 6)),
        "block1_tokens": rng.integers(0, 256, (2, 6)),
        "block2_tokens": rng.integers(0, 256, (2, 4)),
        "attn_q": rng.standard_normal((4, 4, hd)).astype(np.float32),
        "attn_lengths": np.asarray([0, 7, 12, 1], np.int32),
        "attn_tables": rng.permutation(ATTN_PAGES)[:12].reshape(4, 3).astype(np.int32),
        "decode_tokens": rng.integers(0, 256, (2, DECODE_STEPS + 1)),
        "prefill_tokens": rng.integers(0, 256, (3, 2 * PREFILL_PAGE_SIZE)),
        "filter_logits": (3.0 * rng.standard_normal((4, 256))).astype(np.float32),
    }
    for kv in (4, 2):
        shape = (ATTN_LAYERS, ATTN_PAGES, kv, ATTN_PAGE_SIZE, hd)
        inp[f"attn_k{kv}"] = rng.standard_normal(shape).astype(np.float32)
        inp[f"attn_v{kv}"] = rng.standard_normal(shape).astype(np.float32)
    for i in range(ENGINE_REQUESTS):
        plen = int(rng.integers(3, 11))
        inp[f"engine_prompt{i}"] = rng.integers(0, 256, plen)
        inp[f"engine_new{i}"] = np.asarray(int(rng.integers(2, 25)))
    return inp


def params_to_torch(flat: dict, prefix: str, dtype: torch.dtype) -> dict:
    """The port's parameter tree from the fixture's flat bfloat16 bits."""
    def leaf(name):
        bits = torch.from_numpy(flat[f"{prefix}/{name}"].view(np.int16).copy())
        return bits.view(torch.bfloat16).to(dtype)

    n_layers = 1 + max(
        int(k.split("/")[2]) for k in flat if k.startswith(f"{prefix}/layers/")
    )
    layers = []
    for i in range(n_layers):
        names = sorted({
            k.split("/")[3] for k in flat if k.startswith(f"{prefix}/layers/{i}/")
        })
        layers.append({n: leaf(f"layers/{i}/{n}") for n in names})
    return {"embed": leaf("embed"), "unembed": leaf("unembed"), "layers": layers}


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def torch_outputs(case, params: dict, inp: dict) -> dict:
    """What the port computes for one case, as numpy arrays keyed like
    the fixture (without the case prefix)."""
    config = tiny_config(case)
    dtype = config.dtype
    out = {}
    with torch.inference_mode():
        # Dense forward.
        out["forward"] = _np(forward(params, torch.from_numpy(inp["forward_tokens"]), config))
        # Cached block decode: a 6-token block, then a 4-token block.
        cache = tgen.init_kv_cache(config, 2, 10, device="cpu")
        _, cache = tgen.decode_block(
            params, cache, torch.from_numpy(inp["block1_tokens"]), 0, config,
            unembed="none",
        )
        logits, _ = tgen.decode_block(
            params, cache, torch.from_numpy(inp["block2_tokens"]), 6, config
        )
        out["decode_block"] = _np(logits)

        # Paged attention (plain version) on the stored pools.
        kv = config.kv_heads
        q = torch.from_numpy(inp["attn_q"]).to(dtype)
        kp = torch.from_numpy(inp[f"attn_k{kv}"]).to(dtype)
        vp = torch.from_numpy(inp[f"attn_v{kv}"]).to(dtype)
        tables = torch.from_numpy(inp["attn_tables"])
        lengths = torch.from_numpy(inp["attn_lengths"])
        out["attention"] = _np(tpa.paged_attention(
            q, kp, vp, tables, lengths, layer=1, window=config.attention_window,
        ))
        out["attention_f32p"] = _np(attention_f32p(
            q, kp, vp, tables, lengths, 1, config.attention_window
        ))

        # Teacher-forced paged decode, then a greedy chunk from there.
        ctrl = tpaged.PagePool(n_pages=16, page_size=DECODE_PAGE_SIZE)
        pools = tpaged.init_page_pools(config, 16, DECODE_PAGE_SIZE, device="cpu")
        toks = torch.from_numpy(inp["decode_tokens"])
        for b in range(2):
            ctrl.allocate(b, DECODE_STEPS + DECODE_CHUNK)
        tables = tpaged.table_array([ctrl.tables[b] for b in range(2)],
                                    ctrl.pages_needed(DECODE_STEPS + DECODE_CHUNK), device="cpu")
        step_logits = []
        for pos in range(DECODE_STEPS):
            lg, pools = tpaged.paged_decode_step(
                params, pools, tables, toks[:, pos], pos, config
            )
            step_logits.append(lg)
        out["decode_logits"] = _np(torch.stack(step_logits[-3:], dim=1))
        chunk, _ = tpaged.paged_decode_chunk(
            params, pools, tables, toks[:, DECODE_STEPS],
            torch.full((2,), DECODE_STEPS), torch.ones(2, dtype=torch.bool),
            None, 0.0, 0, 1.0, config, DECODE_CHUNK, False,
        )
        out["chunk_tokens"] = chunk.numpy().astype(np.int64)

        # Ragged two-chunk prefill at page size 16.
        ps = PREFILL_PAGE_SIZE
        ctrl = tpaged.PagePool(n_pages=8, page_size=ps)
        pools = tpaged.init_page_pools(config, 8, ps, device="cpu")
        for r, n in enumerate(PREFILL_LENGTHS):
            ctrl.allocate(r, n)
        tables = tpaged.table_array(
            [ctrl.tables[r] for r in range(3)], 2, fill=ctrl.trash, device="cpu"
        )
        lengths = torch.tensor(PREFILL_LENGTHS, dtype=torch.int32)
        prompts = torch.from_numpy(inp["prefill_tokens"])
        emitted = torch.zeros(3, config.vocab_size)
        for ci in range(2):
            lg, pools = tpaged.paged_prefill_chunk(
                params, pools, tables, prompts[:, ci * ps:(ci + 1) * ps],
                lengths, config, start_page=ci, cover_pages=ci + 1, emit=True,
            )
            ends_here = (lengths > ci * ps) & (lengths <= (ci + 1) * ps)
            emitted = torch.where(ends_here[:, None], lg, emitted)
        out["prefill_logits"] = _np(emitted)
        real = [p for r in range(3) for p in ctrl.tables[r]]
        out["prefill_k"] = _np(pools[0][:, real])
        out["prefill_v"] = _np(pools[1][:, real])

    # The serving engine on a mixed stream (greedy).
    engine = tserve.ServeEngine(
        params, config, slots=2, page_size=4, prompt_bucket=12, chunk=4,
        device="cpu",
    )
    rids = [
        engine.submit(inp[f"engine_prompt{i}"], int(inp[f"engine_new{i}"]))
        for i in range(ENGINE_REQUESTS)
    ]
    served = engine.run()
    out["engine_tokens"] = engine_array([served[r] for r in rids])
    assert engine.ctrl.used_pages == 0
    return out


def attention_f32p(q, k_pages, v_pages, tables, lengths, layer, window):
    """Control: paged attention with float32 softmax weights (one dense
    softmax over the gathered view, no rounding of p before p.v), which
    is what JAX's gathered-view route computes and what the port did
    before it followed the Pallas kernel's rounding."""
    batch, heads, hd = q.shape
    kv_heads, ps = k_pages.shape[2], k_pages.shape[3]
    t = tables.shape[1] * ps

    def view(pool):
        g = pool[layer][tables.long()].permute(0, 1, 3, 2, 4)
        return g.reshape(batch, t, kv_heads, hd).float()

    qg = q.reshape(batch, kv_heads, heads // kv_heads, hd).float()
    s = torch.einsum("bngk,btnk->bngt", qg, view(k_pages)) / hd**0.5
    ids = torch.arange(t)
    mask = ids[None, :] < lengths.long()[:, None]
    if window is not None:
        mask &= ids[None, :] >= (lengths.long() - window)[:, None]
    p = torch.softmax(torch.where(mask[:, None, None], s, tpa.NEG_INF), dim=-1)
    out = torch.einsum("bngt,btnk->bngk", p, view(v_pages))
    out = torch.where((lengths > 0)[:, None, None, None], out, 0.0)
    return out.reshape(batch, heads, hd).to(q.dtype)


def engine_array(streams) -> np.ndarray:
    """Token streams as one [n, 24] int64 array padded with -1."""
    arr = np.full((len(streams), 24), -1, np.int64)
    for i, s in enumerate(streams):
        arr[i, : len(s)] = s
    return arr


def filter_outputs(inp: dict) -> dict:
    logits = torch.from_numpy(inp["filter_logits"])
    return {
        f"filter_{i}": tgen.filter_logits(logits, t, k, p).numpy()
        for i, (t, k, p) in enumerate(FILTER_KNOBS)
    }


def mismatches(case, got: dict, want: dict) -> dict[tuple[str, str], float]:
    """Every comparison of one case that exceeds its limit, as
    {(port key, JAX key): error as a share of max |want|} in bf16 and
    {...: max abs error} in float32."""
    out = {}
    for got_key, want_key, bf16_limit in COMPARISONS:
        if want_key not in want:
            continue
        g, w = got[got_key], want[want_key]
        assert g.shape == w.shape, (got_key, g.shape, want_key, w.shape)
        err = np.abs(g - w)
        if case[0] == "f32":
            if not (err <= F32_TOL + F32_TOL * np.abs(w)).all():
                out[(got_key, want_key)] = float(err.max())
        else:
            share = float(err.max() / np.abs(w).max())
            if not share <= bf16_limit:
                out[(got_key, want_key)] = share
    return out


def compare(case, got: dict, want: dict) -> None:
    """Assert the port's outputs against the reference's, at the stated
    tolerances (float32 greedy streams exactly; bf16 streams skipped)."""
    assert not mismatches(case, got, want), (case_key(case), mismatches(case, got, want))
    # Length-0 rows are exact zeros on both sides.
    np.testing.assert_array_equal(got["attention"][0], 0.0)
    if case[0] == "f32":
        for key in ("chunk_tokens", "engine_tokens"):
            np.testing.assert_array_equal(
                got[key], want[key], err_msg=f"{case_key(case)} {key}"
            )


def compare_filter(got: dict, want: dict) -> None:
    for key in want:
        g, w = got[key], want[key]
        np.testing.assert_array_equal(np.isinf(g), np.isinf(w), err_msg=key)
        kept = ~np.isinf(w)
        np.testing.assert_allclose(g[kept], w[kept], atol=FILTER_ATOL, err_msg=key)


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as f:
        return {k: f[k] for k in f.files}


def _golden_inputs(golden) -> dict:
    return {k[len("input/"):]: v for k, v in golden.items() if k.startswith("input/")}


def test_golden_inputs_match_their_seed(golden):
    """The fixture's inputs are the ones make_inputs draws, so the live
    and frozen comparisons see the same data."""
    inp = make_inputs()
    stored = _golden_inputs(golden)
    assert set(stored) == set(inp)
    for k in inp:
        np.testing.assert_array_equal(stored[k], inp[k], err_msg=k)


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_port_matches_jax_goldens(golden, case):
    """Every comparison of one case against the JAX package's outputs."""
    layout = "gqa" if case[1] else "mha"
    params = params_to_torch(golden, f"params_{layout}", DTYPES[case[0]])
    got = torch_outputs(case, params, _golden_inputs(golden))
    compare(case, got, _case_outputs(golden, case))


def _case_outputs(golden, case) -> dict:
    prefix = case_key(case) + "/"
    return {k[len(prefix):]: v for k, v in golden.items() if k.startswith(prefix)}


@pytest.mark.parametrize("case", [c for c in CASES if c[0] == "bf16"],
                         ids=[i for c, i in zip(CASES, CASE_IDS) if c[0] == "bf16"])
def test_bf16_limits_reject_controls(golden, case):
    """The bf16 limits tell the port's bf16 arithmetic apart: the port
    run in float32 on the same weights misses every same-rounding
    comparison, and zeros miss every comparison."""
    layout = "gqa" if case[1] else "mha"
    params = params_to_torch(golden, f"params_{layout}", torch.float32)
    f32_case = ("f32",) + case[1:]
    got = torch_outputs(f32_case, params, _golden_inputs(golden))
    want = _case_outputs(golden, case)
    same_rounding = {
        (g, w) for g, w, limit in COMPARISONS
        if limit == BF16_SAME_ROUNDING and w in want
    }
    assert same_rounding <= set(mismatches(case, got, want))
    zeros = {k: np.zeros_like(v) for k, v in got.items()}
    assert len(mismatches(case, zeros, want)) == sum(w in want for _, w, _ in COMPARISONS)


@pytest.mark.parametrize("case", [c for c in CASES if c[0] == "bf16"],
                         ids=[i for c, i in zip(CASES, CASE_IDS) if c[0] == "bf16"])
def test_attention_rounding_control_fails(golden, case):
    """The float32-weight control misses JAX's Pallas kernel at the
    limit the port meets, so the limit tells the two roundings apart."""
    kv = case[1] or 4  # kv heads: the GQA cases have 2, MHA all 4
    dtype = DTYPES[case[0]]
    inp = _golden_inputs(golden)
    args = (torch.from_numpy(inp["attn_q"]).to(dtype),
            torch.from_numpy(inp[f"attn_k{kv}"]).to(dtype),
            torch.from_numpy(inp[f"attn_v{kv}"]).to(dtype),
            torch.from_numpy(inp["attn_tables"]),
            torch.from_numpy(inp["attn_lengths"]))
    want = _case_outputs(golden, case)["attention"]
    control = _np(attention_f32p(*args, 1, case[2]))
    port = _np(tpa.paged_attention(*args, layer=1, window=case[2]))
    scale = np.abs(want).max()
    assert np.abs(port - want).max() / scale <= BF16_SAME_ROUNDING
    assert np.abs(control - want).max() / scale > BF16_SAME_ROUNDING


def test_filter_logits_matches_jax_goldens(golden):
    want = {k: v for k, v in golden.items() if k.startswith("filter_")}
    assert len(want) == len(FILTER_KNOBS)
    compare_filter(filter_outputs(_golden_inputs(golden)), want)


def test_converter_carries_bf16_bits_exactly(golden):
    """convert.params_from_jax on the JAX package's bf16 numpy tree gives
    the fixture's bits exactly, and float32 leaves unchanged."""
    ml_dtypes = pytest.importorskip("ml_dtypes")
    flat = {k: v for k, v in golden.items() if k.startswith("params_gqa/")}
    tree = {
        "embed": flat["params_gqa/embed"].view(ml_dtypes.bfloat16),
        "unembed": flat["params_gqa/unembed"].view(ml_dtypes.bfloat16),
        "layers": [
            {k.split("/")[3]: v.view(ml_dtypes.bfloat16)
             for k, v in flat.items() if k.startswith(f"params_gqa/layers/{i}/")}
            for i in range(2)
        ],
    }
    got = convert.params_from_jax(tree, device="cpu")
    want = params_to_torch(golden, "params_gqa", torch.bfloat16)
    assert got["embed"].dtype == torch.bfloat16
    assert torch.equal(got["embed"].view(torch.int16), want["embed"].view(torch.int16))
    for g, w in zip(got["layers"], want["layers"]):
        assert set(g) == set(w)
        for name in g:
            assert torch.equal(g[name].view(torch.int16), w[name].view(torch.int16))
    f32 = convert.params_from_jax(
        {"embed": tree["embed"].astype(np.float32), "unembed": tree["unembed"],
         "layers": []}, device="cpu"
    )
    assert f32["embed"].dtype == torch.float32
    assert torch.equal(f32["embed"], want["embed"].float())


def test_golden_fixture_stays_small():
    assert os.path.getsize(GOLDEN) < 1 << 20


def print_bf16_readings() -> None:
    """Each bf16 comparison's error as a share of max |want|, for the
    port and for the port run in float32 (the control), case by case."""
    with np.load(GOLDEN) as f:
        golden = {k: f[k] for k in f.files}
    inp = _golden_inputs(golden)
    for case in CASES:
        if case[0] != "bf16":
            continue
        layout = "gqa" if case[1] else "mha"
        want = _case_outputs(golden, case)
        runs = {
            dtype: torch_outputs((dt,) + case[1:],
                                 params_to_torch(golden, f"params_{layout}", dtype), inp)
            for dt, dtype in DTYPES.items()
        }
        for got_key, want_key, limit in COMPARISONS:
            if want_key not in want:
                continue
            w = want[want_key]
            share = {dt: np.abs(run[got_key] - w).max() / np.abs(w).max()
                     for dt, run in runs.items()}
            print(f"{case_key(case):14s} {got_key:14s} vs {want_key:14s} "
                  f"limit {limit:.5f}  port {share[torch.bfloat16]:.5f}  "
                  f"float32 control {share[torch.float32]:.5f}")


if __name__ == "__main__":
    print_bf16_readings()
