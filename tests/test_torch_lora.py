"""The port's LoRA slice (workloads_torch: ``lora.py``, ``multi_lora.py``,
the engine's ``adapters=`` in every mode) on the CPU, against outputs
frozen from the JAX package in tests/test_torch_lora_golden.npz (written
by ``write_lora_goldens()`` in tests/test_torch_parity.py).

torch, numpy and the port only, so it runs in the fast tier.  Adapter
factors come from ``np.random.default_rng`` seeds (``numpy_adapter``) on
both sides, so the fixture holds no adapter arrays.  Two parts:

* scripted, clock-free engine runs (``golden_runs``) at the tiny MHA
  width (fused ``wqkv`` targets) in float32, greedy, serving the base and
  two adapters round-robin: a stream of six requests in four decode
  modes (``superstep_k`` 1 and 4, each plain and pipelined) crossed with
  batched, serial and budgeted admission; a radix prefix cache whose
  conversations under the base and both adapters share a system prompt
  (hits only within a salt); the flat index; fan-out under an adapter;
  ``export_kv``/``import_kv`` between two engines under each adapter; a
  preempt park; a fault at ``decode_dispatch`` and at
  ``prefill_dispatch`` with replay; and speculation with an int8
  self-draft at gamma 3 (spec on, pipelined, ``spec_lookahead`` 2,
  ``spec_superstep_k`` 2 plain and pipelined).  Greedy streams, terminal
  statuses and every step's counters must be equal;
* unit goldens: ``stack_adapters`` exactly; ``apply_qkv`` and
  ``wo_row_delta`` on the MHA and GQA layouts and ``merge_lora`` over a
  bf16 and an int8 base, in float32 at tests/test_torch_golden.py's
  tolerance (atol = rtol = 1e-4) and in bf16 within one bf16 ulp of the
  largest value (2^-8 of it: the float32 sums before the one rounding
  may differ in their last bit); one LoRA fine-tune step
  (``make_lora_train_step``, AdamW at 1e-3) in float32, loss within
  2^-18 of itself and the updated factors within 2^-14 of their largest
  value (tests/test_torch_train.py's limits for its train steps), and in
  bf16, loss within 2^-22 and the factors within 2^-14 wherever the
  factor's gradient passes 2^-5 of the largest (tests/test_torch_train.py's
  bf16 limits: below that floor the two autograds' rounding places may
  flip a gradient's sign, and AdamW's first step moves an element by
  lr * sign(g), so there the factors are held within 2 * lr).

The JAX package's contracts for these modules, ported, are in
tests/test_torch_lora_contracts.py.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from tests.test_torch_golden import F32_TOL, GOLDEN, params_to_torch, tiny_config
from tests.test_torch_spec import ALL_COUNTERS, _Run, spec_counters
from tests.test_torch_superstep import one_torch_thread  # noqa: F401
from tests.test_torch_train import numpy_params, numpy_tokens
from tests.test_torch_train import tiny_config as train_config
from workloads_torch import convert, lora, multi_lora
from workloads_torch.faults import FaultInjector
from workloads_torch.quant import quantize_params
from workloads_torch.serve import ServeEngine
from workloads_torch.model import loss_fn
from workloads_torch.train import AdamW, tree_leaves

LORA_GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "test_torch_lora_golden.npz")
LORA_CASE = ("f32", None, None)
ENGINE_KW = dict(slots=3, page_size=4, prompt_bucket=8, chunk=4)
RANK, SCALE, ALPHA = 4, 0.3, 1.0
ADAPTER_SEEDS = {"tenant-a": 11, "tenant-b": 12}
NAMES = (None, "tenant-a", "tenant-b")
DECODE = {
    "k1": {},
    "k1_piped": {"pipelined": True},
    "k4": {"superstep_k": 4},
    "k4_piped": {"superstep_k": 4, "pipelined": True},
}
SPEC_DECODE = {
    "on": {},
    "on_piped": {"pipelined": True},
    "la2": {"spec_lookahead": 2},
    "ss2": {"spec_superstep_k": 2},
    "ss2_piped": {"spec_superstep_k": 2, "pipelined": True},
}
ADMISSION = {
    "batched": {},
    "serial": {"batched_admission": False},
    "budget": {"prefill_budget": 8},
}
# Six requests: (prompt length, max_new_tokens, eos), served round-robin
# by the base and the two adapters; the eos ids sit mid-stream in the
# greedy streams, so three requests retire on eos.
TRAFFIC = ((13, 14, 95), (4, 9, None), (19, 12, None), (7, 16, 255), (2, 5, None),
           (10, 11, 31))
NEW = 6
# The crossing each seam's fault fires on, mid-stream in every mode.
SEAMS = {"decode_dispatch": 2, "prefill_dispatch": 2}


def numpy_adapter(config, seed: int, rank: int = RANK, scale: float = SCALE) -> list:
    """One adapter, ``[layer]{target: {a, b}}`` float32 numpy, from a
    numpy seed: ``a`` as ``lora_init`` draws it, ``b`` scaled normals
    (the synthetic adapters' law), so each tenant changes the model."""
    rng = np.random.default_rng(seed)
    shapes = lora._layer_shapes(config)
    out = []
    for _ in range(config.n_layers):
        entry = {}
        for name in lora._TARGETS:
            if name not in shapes:
                continue
            fan_in, fan_out = lora._fans(name, shapes[name])
            a = (rng.standard_normal((fan_in, rank)) / fan_in**0.5).astype(np.float32)
            b = (scale * rng.standard_normal((rank, fan_out))).astype(np.float32)
            entry[name] = {"a": a, "b": b}
        out.append(entry)
    return out


def numpy_adapters(config) -> dict:
    return {name: numpy_adapter(config, seed) for name, seed in ADAPTER_SEEDS.items()}


def lora_traffic():
    rng = np.random.default_rng(909)
    return [([int(t) for t in rng.integers(0, 256, n)], m, eos, NAMES[i % len(NAMES)])
            for i, (n, m, eos) in enumerate(TRAFFIC)]


def conv_traffic():
    """A 16-token system prompt and two turns of four conversations'
    user tokens (5 each); the conversations run under the base, tenant-a,
    tenant-b and tenant-a again, so within a turn only the second
    tenant-a conversation can hit the first one's pages."""
    rng = np.random.default_rng(73)
    system = [int(t) for t in rng.integers(0, 256, 16)]
    turns = [[[int(t) for t in rng.integers(0, 256, 5)] for _ in range(4)] for _ in range(2)]
    return system, turns, (None, "tenant-a", "tenant-b", "tenant-a")


def _submit(engine, run, requests):
    for prompt, new, eos, adapter in requests:
        run.rids.append(engine.submit(prompt, new, eos_token=eos, adapter=adapter))


def run_lora_scenario(make_engine, mode, scenario: str, injector_cls=FaultInjector):
    """One frozen run on either engine: ``make_engine(draft, **kwargs)``
    builds an engine serving the two adapters (``draft`` "self8": with
    the target's int8 tree as its draft; None: no draft).  Returns
    (tokens, counters, statuses, the seams that fired)."""
    decode, admission = mode
    spec = scenario == "spec"
    kw = {**ENGINE_KW, **(SPEC_DECODE if spec else DECODE)[decode], **ADMISSION[admission]}
    run, injector, engines = _Run(), None, []
    if scenario == "traffic":
        engine = make_engine(None, **kw)
        engines.append(engine)
        _submit(engine, run, lora_traffic())
        run.drive(engine)
    elif scenario == "spec":
        engine = make_engine("self8", **kw, gamma=3)
        engines.append(engine)
        _submit(engine, run, lora_traffic())
        run.drive(engine)
    elif scenario in ("radix", "flat"):
        system, turns, who = conv_traffic()
        engine = make_engine(None, **kw, prefix_cache=True if scenario == "radix" else "flat")
        engines.append(engine)
        prompts = [system + u for u in turns[0]]
        for turn in range(2):
            rids = [engine.submit(p, NEW, adapter=a) for p, a in zip(prompts, who)]
            run.rids += rids
            run.drive(engine)
            if turn == 0:
                prompts = [p + run.served.get(r, []) + u
                           for p, r, u in zip(prompts, rids, turns[1])]
    elif scenario == "fanout":
        system, turns, _ = conv_traffic()
        engine = make_engine(None, **kw, prefix_cache=True)
        engines.append(engine)
        run.rids += engine.submit_fanout(system + turns[0][0], NEW, n_samples=3,
                                         adapter="tenant-b")
        run.rids.append(engine.submit(system + turns[0][1], NEW, adapter="tenant-a"))
        run.rids.append(engine.submit(system + turns[0][0], NEW))
        run.drive(engine)
    elif scenario.startswith("fault_"):
        seam = scenario[len("fault_"):]
        injector = injector_cls({seam: [SEAMS[seam]]})
        engine = make_engine(None, **kw, fault_injector=injector)
        engines.append(engine)
        _submit(engine, run, lora_traffic())
        run.drive(engine)
    elif scenario == "park":
        system, turns, _ = conv_traffic()
        engine = make_engine(None, **kw, prefix_cache=True, kv_offload=True)
        engines.append(engine)
        taken = {}

        def park(engine, run):
            taken["req"] = engine.preempt(run.rids[0])

        run.script = {1: [park]}
        run.rids += [engine.submit(system + u, 16, adapter=a)
                     for u, a in zip(turns[0][:2], ("tenant-b", None))]
        run.drive(engine)
        req = taken["req"]
        assert req is not None and 0 < len(req.tokens) < 16 and req.adapter == "tenant-b"
        run.served[req.rid] = list(req.tokens)
        run.taken[req.rid] = "preempted"
        run.rids.append(engine.submit(req.prompt + req.tokens, 16 - len(req.tokens),
                                      adapter=req.adapter))
        run.drive(engine)
    elif scenario == "handoff":
        system, turns, who = conv_traffic()
        prompts = [system + u for u in turns[0][:3]]
        src = make_engine(None, **kw, prefix_cache=True, kv_offload=True)
        dst = make_engine(None, **kw, prefix_cache=True, kv_offload=True)
        engines += [src, dst]
        run.rids += [src.submit(p, 1, adapter=a) for p, a in zip(prompts, who)]
        run.drive(src)
        for p, a in zip(prompts, who):
            dst.import_kv(p, src.export_kv(p, adapter=a), adapter=a)
        run.rows += [spec_counters(src), spec_counters(dst)]
        run.rids += [dst.submit(p, NEW, adapter=a) for p, a in zip(prompts, who)]
        run.drive(dst)
    else:
        raise ValueError(scenario)
    tokens, counters, statuses, _ = run.result(engines)
    for engine in engines:
        engine.close()
        assert engine.ctrl.used_pages == 0 and engine._committed_pages == 0
    return tokens, counters, statuses, injector.fired if injector is not None else []


def golden_runs():
    """(key, mode, scenario) of every frozen run."""
    runs = [(f"traffic/{d}_{a}", (d, a), "traffic") for d in DECODE for a in ADMISSION]
    runs += [(f"radix/{d}_batched", (d, "batched"), "radix") for d in DECODE]
    runs += [(f"radix/k1_{a}", ("k1", a), "radix") for a in ("serial", "budget")]
    runs += [(f"flat/{d}_batched", (d, "batched"), "flat") for d in ("k1", "k4_piped")]
    runs += [(f"fanout/{d}_batched", (d, "batched"), "fanout") for d in DECODE]
    runs += [("fanout/k1_serial", ("k1", "serial"), "fanout")]
    runs += [(f"{name}/{d}_batched", (d, "batched"), name)
             for name in ("handoff", "park") for d in ("k1", "k4_piped")]
    runs += [(f"fault_decode_dispatch/{d}_batched", (d, "batched"), "fault_decode_dispatch")
             for d in DECODE]
    runs += [(f"fault_prefill_dispatch/k1_{a}", ("k1", a), "fault_prefill_dispatch")
             for a in ("batched", "serial")]
    runs += [(f"spec/{d}_batched", (d, "batched"), "spec") for d in SPEC_DECODE]
    runs += [(f"spec/on_{a}", ("on", a), "spec") for a in ("serial", "budget")]
    return runs


def port_params(params_golden, dtype=torch.float32):
    return params_to_torch(params_golden, "params_mha", dtype)


def port_engine_factory(params: dict, config, adapters: dict):
    """``make_engine`` for the port's engine on the CPU."""
    trees = {}

    def make(draft, **kw):
        extra = {}
        if draft == "self8":
            if "self8" not in trees:
                trees["self8"] = quantize_params(params)
            extra = dict(draft_params=trees["self8"], draft_config=config)
        return ServeEngine(params, config, device="cpu", adapters=adapters,
                           lora_alpha=ALPHA, **extra, **kw)

    return make


@pytest.fixture(scope="module")
def params_golden():
    with np.load(GOLDEN) as f:
        return {k: f[k] for k in f.files if k.startswith("params_")}


@pytest.fixture(scope="module")
def lgolden():
    with np.load(LORA_GOLDEN) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def make_port_engine(params_golden):
    config = tiny_config(LORA_CASE)
    adapters = convert.adapters_from_jax(numpy_adapters(config), device="cpu")
    return port_engine_factory(port_params(params_golden), config, adapters)


_RUNS = golden_runs()


@pytest.mark.parametrize("key, mode, scenario", _RUNS, ids=[r[0] for r in _RUNS])
def test_lora_engine_matches_jax_step_by_step(make_port_engine, lgolden, key, mode,
                                              scenario):
    """The port's greedy streams, terminal statuses and every step's
    counters (tokens, prefill work, supersteps, over-decode, spec rounds
    and rejections, quarantines, replays, prefix hits and misses, parks,
    handoff pages, pages in use) equal the JAX engine's serving the same
    adapters in the same mode and scenario; a seam fault fires once."""
    tokens, counters, statuses, fired = run_lora_scenario(make_port_engine, mode, scenario)
    if scenario.startswith("fault_"):
        assert [r.seam for r in fired] == [scenario[len("fault_"):]]
    np.testing.assert_array_equal(tokens, lgolden[f"{key}/tokens"])
    np.testing.assert_array_equal(statuses, lgolden[f"{key}/statuses"])
    np.testing.assert_array_equal(counters, lgolden[f"{key}/counters"])


def test_lora_goldens_cover_what_the_scenarios_do(lgolden):
    """The frozen runs exercise each mechanism: the same greedy streams
    in every decode and admission mode and under speculation (lossless
    per tenant), adapters that change the streams, salted hits (the
    second tenant-a conversation hits, the others miss on turn 1), a
    fan-out's single prefill, handoff pages in, a park and one
    quarantine a fault."""
    def last(key, name):
        return lgolden[f"{key}/counters"][-1][ALL_COUNTERS.index(name)]

    base = lgolden["traffic/k1_batched/tokens"]
    for d in DECODE:
        for a in ADMISSION:
            np.testing.assert_array_equal(lgolden[f"traffic/{d}_{a}/tokens"], base)
    for key, _, scenario in golden_runs():
        if scenario in ("spec", "fault_decode_dispatch", "fault_prefill_dispatch"):
            np.testing.assert_array_equal(lgolden[f"{key}/tokens"], base, err_msg=key)
    assert last("spec/on_batched", "spec_rounds") > 0
    assert list(lgolden["traffic/k1_batched/statuses"]) == ["ok"] * len(TRAFFIC)
    for d in DECODE:
        # The fan-out's members (tenant-b) emit one stream, the base
        # request on the same prompt another.
        fan = lgolden[f"fanout/{d}_batched/tokens"]
        assert (fan[0] == fan[1]).all() and (fan[0] == fan[2]).all()
        assert not (fan[0] == fan[4]).all()
        assert last(f"radix/{d}_batched", "hits") > 0
        assert last(f"fault_decode_dispatch/{d}_batched", "steps_quarantined") == 1
        assert last(f"fanout/{d}_batched", "requests_retired") == 5
    for d in ("k1", "k4_piped"):
        handoff = lgolden[f"handoff/{d}_batched/counters"]
        assert handoff[:, ALL_COUNTERS.index("kv_handoff_pages_in")].max() > 0
        assert last(f"park/{d}_batched", "pages_parked") > 0


def test_lora_golden_fixture_stays_small():
    assert os.path.getsize(LORA_GOLDEN) < 1_000_000


# ---- unit goldens ------------------------------------------------------

BF16_ULP = 2.0**-8  # of the largest |value|: one bf16 rounding apart
UNIT_IDX = np.asarray([0, 2, 1], np.int64)
LAYOUTS = {"mha": None, "gqa": 2}
TRAIN_LOSS_LIMIT = {"f32": 2.0**-18, "bf16": 2.0**-22}
TRAIN_FACTOR_LIMIT = 2.0**-14
BF16_GRAD_FLOOR = 2.0**-5  # of the largest |gradient| of the factor
TRAIN_LR = 1e-3


def unit_inputs(layout: str) -> dict:
    """Activations of the unit comparisons at the tiny width: h [3, 2,
    d], the projections q/k/v [3, 2, H|Hkv, hd] and an attention output
    [3, 2, H, hd]; rows take adapters 0 (base), 2 and 1."""
    config = tiny_config(("f32", LAYOUTS[layout], None))
    rng = np.random.default_rng(5150 + (LAYOUTS[layout] or 0))
    H, Hkv, hd, d = config.n_heads, config.kv_heads, config.head_dim, config.d_model
    return {
        "h": rng.standard_normal((3, 2, d)).astype(np.float32),
        "q": rng.standard_normal((3, 2, H, hd)).astype(np.float32),
        "k": rng.standard_normal((3, 2, Hkv, hd)).astype(np.float32),
        "v": rng.standard_normal((3, 2, Hkv, hd)).astype(np.float32),
        "attn": rng.standard_normal((3, 2, H, hd)).astype(np.float32),
    }


def bf16_round(a: np.ndarray) -> np.ndarray:
    """float32 values rounded to the nearest bf16 (so both dtypes start
    from the same values)."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _t(a, dtype):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def port_units(params_golden) -> dict:
    """What the port computes for the unit comparisons (float32 numpy)."""
    out = {}
    for layout, kv in LAYOUTS.items():
        config = tiny_config(("f32", kv, None))
        stacked = multi_lora.stack_adapters(
            list(convert.adapters_from_jax(numpy_adapters(config), device="cpu").values()),
            config)
        if layout == "mha":
            for li, entry in enumerate(stacked):
                for name, ab in entry.items():
                    for f in ("a", "b"):
                        out[f"stack/{li}/{name}/{f}"] = ab[f].numpy()
        inp = unit_inputs(layout)
        idx = torch.from_numpy(UNIT_IDX)
        for dt, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            x = {k: _t(bf16_round(v), dtype) for k, v in inp.items()}
            q, k, v = multi_lora.apply_qkv(x["q"], x["k"], x["v"], x["h"], stacked[0], idx,
                                           config, ALPHA, dtype)
            for name, t in (("q", q), ("k", k), ("v", v)):
                out[f"{layout}/{dt}/apply_qkv/{name}"] = t.float().numpy()
            out[f"{layout}/{dt}/wo_row_delta/3d"] = multi_lora.wo_row_delta(
                x["attn"], stacked[1], idx, ALPHA).numpy()
            out[f"{layout}/{dt}/wo_row_delta/2d"] = multi_lora.wo_row_delta(
                x["attn"][:, 0], stacked[1], idx, ALPHA).numpy()
    # merge_lora over the tiny MHA tree in bf16 and its int8 quantization.
    config = tiny_config(LORA_CASE)
    adapter = convert.adapters_from_jax(numpy_adapters(config), device="cpu")["tenant-a"]
    bases = {"bf16": port_params(params_golden, torch.bfloat16),
             "int8": quantize_params(port_params(params_golden))}
    for base, dtypes in (("bf16", (None, torch.float32)), ("int8", (None, torch.bfloat16))):
        for dtype in dtypes:
            merged = lora.merge_lora(bases[base], adapter, ALPHA, dtype=dtype)
            tag = "default" if dtype is None else str(dtype).split(".")[-1]
            for li, layer in enumerate(merged["layers"]):
                for name in adapter[li]:
                    out[f"merge/{base}/{tag}/{li}/{name}"] = layer[name].float().numpy()
                    out[f"merge/{base}/{tag}/{li}/{name}/dtype_bits"] = np.asarray(
                        torch.finfo(layer[name].dtype).bits)
    return out


def port_train_step(dt: str) -> dict:
    """One LoRA fine-tune step at the tiny MHA width (33 tokens a row)."""
    config = train_config("f32_mha", dtype={"f32": torch.float32, "bf16": torch.bfloat16}[dt],
                          attention_impl="native")
    base = {k: v for k, v in convert.params_from_jax(numpy_params(config),
                                                     device="cpu").items()}
    adapters = convert.adapters_from_jax({"x": numpy_adapter(config, 31)}, device="cpu")["x"]
    tokens = torch.from_numpy(numpy_tokens(config, 0))
    # The port's own gradients of the factors, for the bf16 floor.
    leaves = [t.clone().requires_grad_(True) for t in tree_leaves(adapters)]
    it = iter(leaves)
    copy = [{n: {f: next(it) for f in sorted(ab)} for n, ab in sorted(e.items())}
            for e in adapters]
    loss = loss_fn(lora.merge_lora(base, copy, ALPHA, dtype=config.dtype), tokens, config)
    grads = iter(torch.autograd.grad(loss, leaves))
    optimizer = AdamW(lr=TRAIN_LR, mu_dtype=torch.float32)
    state = optimizer.init(adapters)
    step = lora.make_lora_train_step(config, optimizer, base, ALPHA)
    adapters, state, loss = step(adapters, state, tokens)
    out = {"loss": np.asarray(loss.item(), np.float32)}
    for li, entry in enumerate(adapters):
        for name in sorted(entry):
            for f in ("a", "b"):
                out[f"{li}/{name}/{f}"] = entry[name][f].numpy().copy()
                out[f"grad/{li}/{name}/{f}"] = next(grads).numpy()
    return {f"train/{dt}/{k}": v for k, v in out.items()}


@pytest.fixture(scope="module")
def units(params_golden):
    out = port_units(params_golden)
    for dt in ("f32", "bf16"):
        out.update(port_train_step(dt))
    return out


def _unit_names():
    names = [f"stack/{li}/{n}/{f}" for li in range(2) for n in ("wo", "wqkv")
             for f in ("a", "b")]
    for layout in LAYOUTS:
        for dt in ("f32", "bf16"):
            names += [f"{layout}/{dt}/apply_qkv/{n}" for n in ("q", "k", "v")]
            names += [f"{layout}/{dt}/wo_row_delta/{s}" for s in ("3d", "2d")]
    for base, tags in (("bf16", ("default", "float32")), ("int8", ("default", "bfloat16"))):
        names += [f"merge/{base}/{tag}/{li}/{n}" for tag in tags for li in range(2)
                  for n in ("wqkv", "wo")]
    return names


def unit_limit(name: str, want: np.ndarray) -> float:
    """The absolute limit of one unit comparison (module docstring)."""
    if name.startswith("stack/"):
        return 0.0
    rounded_bf16 = ("/bf16/apply_qkv/" in name or name.startswith("merge/bf16/default")
                    or name.startswith("merge/int8/bfloat16"))
    if rounded_bf16:
        return BF16_ULP * float(np.abs(want).max())
    return F32_TOL + F32_TOL * float(np.abs(want).max())


@pytest.mark.parametrize("name", _unit_names())
def test_lora_units_match_jax(units, lgolden, name):
    """stack_adapters exactly; apply_qkv, wo_row_delta (both shapes)
    and merge_lora against the JAX package's, each at its limit
    (``unit_limit``), and in the merged tree's dtype."""
    got, want = units[name], lgolden[f"unit/{name}"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=unit_limit(name, want))
    if name.startswith("merge/"):
        assert units[f"{name}/dtype_bits"] == lgolden[f"unit/{name}/dtype_bits"]


def test_bf16_limit_would_catch_an_unrounded_add(units, lgolden):
    """A control for the bf16 limit: an apply_qkv that adds the delta in
    bf16 (two roundings) lands outside one ulp of JAX's somewhere."""
    config = tiny_config(LORA_CASE)
    stacked = multi_lora.stack_adapters(
        list(convert.adapters_from_jax(numpy_adapters(config), device="cpu").values()), config)
    inp = {k: _t(bf16_round(v), torch.bfloat16) for k, v in unit_inputs("mha").items()}
    dq, _, _ = multi_lora.qkv_row_deltas(inp["h"], stacked[0], torch.from_numpy(UNIT_IDX),
                                         config)
    wrong = (inp["q"] + (ALPHA * dq).to(torch.bfloat16)).float().numpy()
    want = lgolden["unit/mha/bf16/apply_qkv/q"]
    assert np.abs(wrong - want).max() > unit_limit("mha/bf16/apply_qkv/q", want)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_base_rows_are_bit_identical_to_unadapted(units, layout, dt):
    """Row 0 takes the zero base entry: apply_qkv hands its q/k/v back
    bit for bit (an exact +0.0 and one rounding of an exact value)."""
    inp = unit_inputs(layout)
    for name in ("q", "k", "v"):
        np.testing.assert_array_equal(units[f"{layout}/{dt}/apply_qkv/{name}"][0],
                                      bf16_round(inp[name])[0])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_lora_train_step_matches_jax(units, lgolden, dt):
    """One fine-tune step: the loss within its limit of JAX's, and the
    updated factors within 2^-14 of the largest factor value (in bf16,
    where the factor's gradient passes the bf16 gradient floor; below
    it within 2 * lr, one flipped first-step AdamW sign)."""
    prefix = f"train/{dt}/"
    got_loss, want_loss = float(units[prefix + "loss"]), float(lgolden["unit/" + prefix + "loss"])
    assert abs(got_loss - want_loss) <= TRAIN_LOSS_LIMIT[dt] * abs(want_loss)
    keys = [k for k in units if k.startswith(prefix) and "/grad/" not in k
            and not k.endswith("loss")]
    assert len(keys) == 2 * 2 * 2
    scale = max(float(np.abs(lgolden["unit/" + k]).max()) for k in keys)
    for k in keys:
        err = np.abs(units[k] - lgolden["unit/" + k])
        limit = np.full(err.shape, TRAIN_FACTOR_LIMIT * scale)
        if dt == "bf16":
            g = np.abs(units[k.replace(prefix, prefix + "grad/")])
            limit[g <= BF16_GRAD_FLOOR * g.max()] += 2 * TRAIN_LR
        assert (err <= limit).all(), (k, float(err.max()))
