"""Live parity: the PyTorch port (workloads_torch) against the JAX package
(workloads) on the same parameters and inputs, at the tiny config.

Slow by the repo's rule (it imports jax and workloads); run it with
``JAX_PLATFORMS=cpu python -m pytest tests/test_torch_parity.py -m slow``.
The JAX side runs its Pallas paged-attention kernel in interpret mode, as
the JAX package's own CPU tests do.  The comparisons and their tolerances
live in tests/test_torch_golden.py, which holds the port against the
frozen outputs of this file in the fast tier, and so do
tests/test_torch_superstep.py (the decode superstep) and
tests/test_torch_schedule.py (the engine's scheduling modes) against
tests/test_torch_superstep_golden.npz, and tests/test_torch_lifecycle.py
(the request lifecycle) against tests/test_torch_lifecycle_golden.npz,
and tests/test_torch_kv_hierarchy.py (the KV-cache hierarchy) against
tests/test_torch_kv_golden.npz, and tests/test_torch_spec.py (speculative
decoding) against tests/test_torch_spec_golden.npz, and
tests/test_torch_lora.py (multi-LoRA serving and the LoRA fine-tune step)
against tests/test_torch_lora_golden.npz, tests/test_torch_fleet.py
(the fleet and its control plane) against tests/test_torch_fleet_golden.npz,
and tests/test_torch_perfbench_fleet.py (perfbench's fleet arms) against
tests/test_torch_perfbench_fleet_golden.json, and
tests/test_torch_busy_probe.py (the busy probe's ``aggregate``) against
tests/test_torch_busy_golden.json;

    python tests/test_torch_parity.py --write-goldens

regenerates the fourteen fixtures from the JAX package (``write_fleet_goldens()``,
``write_perfbench_fleet_goldens()``, ``write_busy_goldens()``, ``write_tp_goldens()``,
``write_train_parallel_goldens()``, ``write_pipeline_goldens()``,
``write_moe_goldens()`` or ``write_vision_goldens()`` alone rewrites only
its own; the last three freeze tests/test_torch_pipeline.py's,
tests/test_torch_moe.py's and tests/test_torch_vision.py's JAX runs;
``write_tp_goldens`` holds tests/test_torch_tp_serve.py's frozen JAX
tensor-parallel streams, ``write_train_parallel_goldens`` the meshed
training steps, sequence-parallel steps and ring/Ulysses/USP attention
of tests/test_torch_train_parallel.py and tests/test_torch_seq_parallel.py).
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

os.environ.setdefault("JAX_PLATFORMS", "cpu")
# Eight CPU devices, as tests/conftest.py sets them, also when this file
# runs as a script: the tensor-parallel goldens shard over up to four.
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from tests.test_torch_golden import (  # noqa: E402
    CASE_IDS,
    CASES,
    DECODE_CHUNK,
    DECODE_PAGE_SIZE,
    DECODE_STEPS,
    ENGINE_REQUESTS,
    FILTER_KNOBS,
    GOLDEN,
    PREFILL_LENGTHS,
    PREFILL_PAGE_SIZE,
    case_key,
    compare,
    compare_filter,
    engine_array,
    filter_outputs,
    make_inputs,
    tiny_config,
    torch_outputs,
)
from tests.test_torch_kv_hierarchy import (  # noqa: E402
    DISK_DTYPES,
    DISK_KEY,
    DISK_SHAPE,
    KV_CASE,
    KV_GOLDEN,
)
from tests.test_torch_kv_hierarchy import golden_runs as kv_golden_runs  # noqa: E402
from tests.test_torch_kv_hierarchy import run_kv_scenario  # noqa: E402
from tests import test_torch_lora as tlora  # noqa: E402
from tests import test_torch_tp_serve as ttp  # noqa: E402
from tests import torch_tp_world as tw  # noqa: E402
from tests import torch_train_world as trw  # noqa: E402
from tests import torch_model_world as mw  # noqa: E402
from tests import test_torch_fleet as tfleet  # noqa: E402
from tests import test_torch_perfbench_fleet as tpbf  # noqa: E402
from tests import test_torch_busy_probe as tbusy  # noqa: E402
from tests.test_torch_lifecycle import (  # noqa: E402
    LIFECYCLE_GOLDEN,
    golden_runs,
    run_scenario,
)
from tests.test_torch_schedule import (  # noqa: E402
    ENGINE_KW,
    SCHEDULE_CASE,
    SCHEDULE_MODES,
    mode_key,
    mode_kwargs,
    schedule_requests,
    trace_engine,
)
from tests.test_torch_quant import QUANT_SHAPES, quant_inputs  # noqa: E402
from tests.test_torch_spec import (  # noqa: E402
    SPEC_CASE,
    SPEC_GOLDEN,
    UNIT_COVER,
    UNIT_GAMMA,
    port_engine_factory,
    run_spec_scenario,
    unit_inputs,
)
from tests.test_torch_spec import golden_runs as spec_golden_runs  # noqa: E402
from tests.test_torch_superstep import (  # noqa: E402
    SS_CASES,
    SS_CASE_IDS,
    SS_CHUNK,
    SS_EOS_STEP,
    SS_KS,
    SS_LIVE,
    SS_BUDGET,
    SS_START,
    SUPERSTEP_GOLDEN,
    port_superstep,
    superstep_inputs,
    superstep_mismatches,
    written_slots,
)
from workloads import busy_probe as jbusy  # noqa: E402
from workloads import durable as jdurable  # noqa: E402
from workloads import faults as jfaults  # noqa: E402
from workloads import generate as jgen  # noqa: E402
from workloads import lora as jlora  # noqa: E402
from workloads import mfu_sweep as jmfu  # noqa: E402
from workloads import model as jmodel  # noqa: E402
from workloads import moe as jmoe  # noqa: E402
from workloads import multi_lora as jmulti  # noqa: E402
from workloads import paged as jpaged  # noqa: E402
from workloads import perfbench as jperf  # noqa: E402
from workloads import pipeline as jpipe  # noqa: E402
from workloads import quant as jquant  # noqa: E402
from workloads import serve as jserve  # noqa: E402
from workloads import speculative as jspec  # noqa: E402
from workloads import tp_serve as jtp  # noqa: E402
from workloads import train as jtrain  # noqa: E402
from workloads import vision as jvision  # noqa: E402
from workloads.ops import paged_attention as jpa  # noqa: E402
from workloads_torch import busy_probe as tbusy_probe  # noqa: E402
from workloads_torch import convert  # noqa: E402
from workloads_torch import durable as tdurable  # noqa: E402
from workloads_torch import mfu_sweep as tmfu  # noqa: E402
from workloads_torch import model as tmodel  # noqa: E402
from workloads_torch import paged as tpaged  # noqa: E402
from workloads_torch import perfbench as tperf  # noqa: E402
from workloads_torch import serve as tserve  # noqa: E402

JAX_DTYPES = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def jax_config(case) -> jmodel.ModelConfig:
    dt, kv, win = case
    return jmodel.ModelConfig(
        vocab_size=256, d_model=64, n_heads=4, n_layers=2, d_ff=128,
        max_seq_len=64, dtype=JAX_DTYPES[dt], n_kv_heads=kv, attention_window=win,
    )


def jax_params_bf16(kv) -> dict:
    """The JAX package's init_params tree, rounded to bfloat16 (as numpy
    ml_dtypes arrays), so float32 cases run on bf16-representable
    weights and both dtypes share one stored copy."""
    tree = jmodel.init_params(jax_config(("f32", kv, None)), jax.random.PRNGKey(0))
    return jax.tree.map(lambda a: np.asarray(a).astype(ml_dtypes.bfloat16), tree)


def flat_bits(tree: dict, prefix: str) -> dict:
    """A params tree as flat ``prefix/name`` -> uint16 bit arrays."""
    out = {f"{prefix}/embed": tree["embed"].view(np.uint16),
           f"{prefix}/unembed": tree["unembed"].view(np.uint16)}
    for i, layer in enumerate(tree["layers"]):
        for name, w in layer.items():
            out[f"{prefix}/layers/{i}/{name}"] = w.view(np.uint16)
    return out


def _np(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.float32))


def jax_outputs(case, tree_bf16: dict, inp: dict) -> dict:
    """What the JAX package computes for one case (the keys of
    tests/test_torch_golden.torch_outputs, plus ``attention_xla`` from
    its gathered-view attention route).

    bfloat16 cases run with jit disabled, so each operation rounds to
    bf16 where the source says: under jit XLA fuses elementwise chains
    and drops intermediate roundings (the jitted bf16 forward differs
    from the eager one by as much as from float32).  They skip the
    greedy streams, which are compared in float32 only."""
    if case[0] == "f32":
        return _jax_outputs(jax_config(case), tree_bf16, inp, streams=True)
    with jax.disable_jit():
        return _jax_outputs(jax_config(case), tree_bf16, inp, streams=False)


def _jax_outputs(config, tree_bf16: dict, inp: dict, streams: bool) -> dict:
    params = jax.tree.map(lambda a: jnp.asarray(a, config.dtype), tree_bf16)
    out = {"forward": _np(jmodel.forward(params, jnp.asarray(inp["forward_tokens"]), config))}

    cache = jgen.init_kv_cache(config, 2, 10)
    _, cache = jgen.decode_block(
        params, cache, jnp.asarray(inp["block1_tokens"], jnp.int32),
        jnp.int32(0), config, unembed="none",
    )
    logits, _ = jgen.decode_block(
        params, cache, jnp.asarray(inp["block2_tokens"], jnp.int32),
        jnp.int32(6), config,
    )
    out["decode_block"] = _np(logits)

    kv = config.kv_heads
    args = (
        jnp.asarray(inp["attn_q"], config.dtype),
        jnp.asarray(inp[f"attn_k{kv}"], config.dtype),
        jnp.asarray(inp[f"attn_v{kv}"], config.dtype),
        jnp.asarray(inp["attn_tables"]), jnp.asarray(inp["attn_lengths"]),
    )
    out["attention"] = _np(jpa.paged_attention(
        *args, layer=1, window=config.attention_window, interpret=True
    ))
    out["attention_xla"] = _np(jpa._paged_attention_xla(
        *args, layer=1, window=config.attention_window
    ))

    ctrl = jpaged.PagePool(n_pages=16, page_size=DECODE_PAGE_SIZE)
    pools = jpaged.init_page_pools(config, 16, DECODE_PAGE_SIZE)
    toks = jnp.asarray(inp["decode_tokens"], jnp.int32)
    for b in range(2):
        ctrl.allocate(b, DECODE_STEPS + DECODE_CHUNK)
    tables = jpaged.table_array(
        [ctrl.tables[b] for b in range(2)],
        ctrl.pages_needed(DECODE_STEPS + DECODE_CHUNK),
    )
    step_logits = []
    for pos in range(DECODE_STEPS):
        lg, pools = jpaged.paged_decode_step(
            params, pools, tables, toks[:, pos], jnp.int32(pos), config
        )
        step_logits.append(lg)
    out["decode_logits"] = _np(jnp.stack(step_logits[-3:], axis=1))
    if streams:
        chunk, _ = jpaged.paged_decode_chunk(
            params, pools, tables, toks[:, DECODE_STEPS],
            jnp.full((2,), DECODE_STEPS, jnp.int32), jnp.ones(2, bool),
            jax.random.PRNGKey(0), jnp.float32(0.0), jnp.int32(0), jnp.float32(1.0),
            config=config, chunk=DECODE_CHUNK, sampling=False,
        )
        out["chunk_tokens"] = np.asarray(chunk).astype(np.int64)

    ps = PREFILL_PAGE_SIZE
    ctrl = jpaged.PagePool(n_pages=8, page_size=ps)
    pools = jpaged.init_page_pools(config, 8, ps)
    for r, n in enumerate(PREFILL_LENGTHS):
        ctrl.allocate(r, n)
    tables = jpaged.table_array([ctrl.tables[r] for r in range(3)], 2, fill=ctrl.trash)
    lengths = jnp.asarray(PREFILL_LENGTHS, jnp.int32)
    lengths_np = np.asarray(PREFILL_LENGTHS)
    prompts = jnp.asarray(inp["prefill_tokens"], jnp.int32)
    emitted = np.zeros((3, config.vocab_size), np.float32)
    for ci in range(2):
        lg, pools = jpaged.paged_prefill_chunk(
            params, pools, tables, prompts[:, ci * ps:(ci + 1) * ps], lengths,
            config=config, start_page=ci, cover_pages=ci + 1, emit=True,
        )
        ends_here = (lengths_np > ci * ps) & (lengths_np <= (ci + 1) * ps)
        emitted = np.where(ends_here[:, None], _np(lg), emitted)
    out["prefill_logits"] = emitted
    real = np.asarray([p for r in range(3) for p in ctrl.tables[r]])
    out["prefill_k"] = _np(pools[0][:, real])
    out["prefill_v"] = _np(pools[1][:, real])

    if streams:
        engine = jserve.ServeEngine(
            params, config, slots=2, page_size=4, prompt_bucket=12, chunk=4
        )
        rids = [
            engine.submit(inp[f"engine_prompt{i}"], int(inp[f"engine_new{i}"]))
            for i in range(ENGINE_REQUESTS)
        ]
        served = engine.run()
        out["engine_tokens"] = engine_array([served[r] for r in rids])
    return out


def jax_filter_outputs(inp: dict) -> dict:
    logits = jnp.asarray(inp["filter_logits"])
    return {
        f"filter_{i}": np.asarray(jgen.filter_logits(logits, t, k, p))
        for i, (t, k, p) in enumerate(FILTER_KNOBS)
    }


@pytest.fixture(scope="module")
def trees():
    return {None: jax_params_bf16(None), 2: jax_params_bf16(2)}


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_port_matches_jax_live(trees, case):
    """Every comparison of one case, live: logits, attention (Pallas
    interpret and the gathered-view reference), written pages, float32
    greedy chunk and engine streams."""
    inp = make_inputs()
    tree = trees[case[1]]
    want = jax_outputs(case, tree, inp)
    # The port's parameters come from the JAX tree through the converter
    # (numpy in the case's dtype, as the JAX CLI casts it).
    np_dtype = np.float32 if case[0] == "f32" else ml_dtypes.bfloat16
    params = convert.params_from_jax(
        jax.tree.map(lambda a: np.asarray(a).astype(np_dtype), tree), device="cpu"
    )
    got = torch_outputs(case, params, inp)
    compare(case, got, want)


def test_gelu_matches_jax_bit_for_bit_in_bf16():
    """The port's gelu rounds to bf16 where jax.nn.gelu does."""
    x = 3.0 * np.random.default_rng(0).standard_normal(200_000).astype(np.float32)
    want = _np(jax.nn.gelu(jnp.asarray(x, jnp.bfloat16)))
    got = tmodel._gelu_tanh(torch.from_numpy(x).to(torch.bfloat16)).float().numpy()
    np.testing.assert_array_equal(got, want)


def test_filter_logits_matches_jax_live():
    inp = make_inputs()
    compare_filter(filter_outputs(inp), jax_filter_outputs(inp))


def jax_superstep(case, tree_bf16: dict, inp: dict, eos, k: int) -> dict:
    """The JAX package's paged_decode_superstep from the stored state
    (bf16 with jit disabled, as ``jax_outputs`` runs it)."""
    config = jax_config(case)

    def run():
        params = jax.tree.map(lambda a: jnp.asarray(a, config.dtype), tree_bf16)
        kv = config.kv_heads
        pools = tuple(jnp.asarray(inp[f"pool_{n}{kv}"], config.dtype) for n in ("k", "v"))
        toks, tok, pos, live, budget, pools = jpaged.paged_decode_superstep(
            params, pools, jnp.asarray(inp["tables"]), jnp.asarray(inp["tokens"], jnp.int32),
            jnp.asarray(SS_START, jnp.int32), jnp.asarray(SS_LIVE),
            jnp.asarray(SS_BUDGET, jnp.int32), jnp.asarray(eos, jnp.int32),
            jax.random.split(jax.random.PRNGKey(0), k), jnp.float32(0.0), jnp.int32(0),
            jnp.float32(1.0), config=config, chunk=SS_CHUNK, k=k, sampling=False,
        )
        pos = np.asarray(pos).astype(np.int64)
        wk, wv = written_slots(tuple(torch.from_numpy(_np(p)) for p in pools),
                               inp["tables"], pos)
        return {"tokens": np.asarray(toks).astype(np.int64),
                "tok": np.asarray(tok).astype(np.int64), "pos": pos,
                "live": np.asarray(live), "budget": np.asarray(budget),
                "written_k": wk, "written_v": wv}

    if case[0] == "f32":
        return run()
    with jax.disable_jit():
        return run()


def superstep_eos(case, tree_bf16: dict, inp: dict) -> np.ndarray:
    """Each row's eos: the token its stream without eos emits at the step
    SS_EOS_STEP names (-1, no eos, for the other rows)."""
    free = jax_superstep(case, tree_bf16, inp, np.full(4, -1), 2)["tokens"]
    eos = np.full(4, -1, np.int64)
    for row, step in SS_EOS_STEP.items():
        eos[row] = free[row, step]
    return eos


def jax_engine_trace(mode, tree_bf16: dict) -> tuple[np.ndarray, np.ndarray]:
    config = jax_config(SCHEDULE_CASE)
    params = jax.tree.map(lambda a: jnp.asarray(a, config.dtype), tree_bf16)
    engine = jserve.ServeEngine(params, config, **ENGINE_KW, **mode_kwargs(mode))
    return trace_engine(engine, schedule_requests())


@pytest.mark.parametrize("k", SS_KS)
@pytest.mark.parametrize("case", SS_CASES, ids=SS_CASE_IDS)
def test_superstep_matches_jax_live(trees, case, k):
    inp = superstep_inputs()
    tree = trees[case[1]]
    eos = superstep_eos(case, tree, inp)
    want = jax_superstep(case, tree, inp, eos, k)
    np_dtype = np.float32 if case[0] == "f32" else ml_dtypes.bfloat16
    params = convert.params_from_jax(
        jax.tree.map(lambda a: np.asarray(a).astype(np_dtype), tree), device="cpu"
    )
    got = port_superstep(case, params, inp, eos, k, final_pos=want["pos"])
    assert not superstep_mismatches(case, got, want), superstep_mismatches(case, got, want)


@pytest.mark.parametrize("mode", SCHEDULE_MODES, ids=[mode_key(m) for m in SCHEDULE_MODES])
def test_engine_schedule_matches_jax_live(trees, mode):
    """The port's streams and per-step telemetry against the JAX engine in
    the same mode, and the JAX engine's streams on the golden run equal
    its default mode's (what the fast tier assumes)."""
    want_tokens, want_trace = jax_engine_trace(mode, trees[SCHEDULE_CASE[1]])
    params = convert.params_from_jax(
        jax.tree.map(lambda a: np.asarray(a).astype(np.float32), trees[SCHEDULE_CASE[1]]),
        device="cpu",
    )
    engine = tserve.ServeEngine(params, tiny_config(SCHEDULE_CASE), device="cpu",
                                **ENGINE_KW, **mode_kwargs(mode))
    tokens, telemetry = trace_engine(engine, schedule_requests())
    np.testing.assert_array_equal(tokens, want_tokens)
    np.testing.assert_array_equal(telemetry, want_trace)
    inp = make_inputs()
    config = jax_config(SCHEDULE_CASE)
    jparams = jax.tree.map(lambda a: jnp.asarray(a, config.dtype), trees[SCHEDULE_CASE[1]])
    runs = []
    for kw in ({}, mode_kwargs(mode)):
        jengine = jserve.ServeEngine(jparams, config, **ENGINE_KW, **kw)
        rids = [jengine.submit(inp[f"engine_prompt{i}"], int(inp[f"engine_new{i}"]))
                for i in range(ENGINE_REQUESTS)]
        served = jengine.run()
        runs.append(engine_array([served[r] for r in rids]))
    np.testing.assert_array_equal(runs[1], runs[0])


def jax_lifecycle_run(tree_bf16: dict, mode, scenario: str):
    """One lifecycle scenario on the JAX engine (tests/test_torch_lifecycle.py
    ``run_scenario``)."""
    config = jax_config(SCHEDULE_CASE)
    params = jax.tree.map(lambda a: jnp.asarray(a, config.dtype), tree_bf16)
    return run_scenario(lambda **kw: jserve.ServeEngine(params, config, **kw), mode, scenario)


_LIFECYCLE_RUNS = golden_runs()


@pytest.mark.parametrize("key, mode, scenario", _LIFECYCLE_RUNS,
                         ids=[r[0] for r in _LIFECYCLE_RUNS])
def test_lifecycle_matches_jax_live(trees, key, mode, scenario):
    """The port's streams, terminal statuses and per-step lifecycle
    counters against the JAX engine's in the same mode and scenario, and
    the same seams fired."""
    want = jax_lifecycle_run(trees[SCHEDULE_CASE[1]], mode, scenario)
    params = convert.params_from_jax(
        jax.tree.map(lambda a: np.asarray(a).astype(np.float32), trees[SCHEDULE_CASE[1]]),
        device="cpu",
    )
    config = tiny_config(SCHEDULE_CASE)
    got = run_scenario(lambda **kw: tserve.ServeEngine(params, config, device="cpu", **kw),
                       mode, scenario)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, w, err_msg=key)
    assert [(r.seam, r.crossing) for r in got[3]] == [(r.seam, r.crossing) for r in want[3]]


def jax_kv_run(tree_bf16: dict, mode, scenario: str):
    """One KV-hierarchy scenario on the JAX engine
    (tests/test_torch_kv_hierarchy.py ``run_kv_scenario``)."""
    config = jax_config(KV_CASE)
    params = jax.tree.map(lambda a: jnp.asarray(a, config.dtype), tree_bf16)
    return run_kv_scenario(lambda **kw: jserve.ServeEngine(params, config, **kw), mode, scenario,
                           injector_cls=jfaults.FaultInjector)


_KV_RUNS = kv_golden_runs()


@pytest.mark.parametrize("key, mode, scenario", _KV_RUNS, ids=[r[0] for r in _KV_RUNS])
def test_kv_matches_jax_live(trees, key, mode, scenario):
    """The port's streams, statuses and per-step KV counters against the
    JAX engine's in the same mode and scenario, and the same seams
    fired."""
    want = jax_kv_run(trees[KV_CASE[1]], mode, scenario)
    params = convert.params_from_jax(
        jax.tree.map(lambda a: np.asarray(a).astype(np.float32), trees[KV_CASE[1]]),
        device="cpu",
    )
    config = tiny_config(KV_CASE)
    got = run_kv_scenario(lambda **kw: tserve.ServeEngine(params, config, device="cpu", **kw),
                          mode, scenario)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, w, err_msg=key)
    assert [(r.seam, r.crossing) for r in got[3]] == [(r.seam, r.crossing) for r in want[3]]


_ML_DTYPES = {"bf16": ml_dtypes.bfloat16, "f32": np.float32}


def jax_disk_pages() -> dict:
    """One page in bf16 and in float32, written by the JAX package's
    ``KVDiskTier``: the file's bytes and the k/v bits."""
    rng = np.random.default_rng(5)
    out = {}
    for name, (_, bits) in DISK_DTYPES.items():
        k, v = (rng.standard_normal(DISK_SHAPE).astype(_ML_DTYPES[name]) for _ in range(2))
        with tempfile.TemporaryDirectory() as d:
            tier = jdurable.KVDiskTier(d)
            assert tier.put(DISK_KEY, ((k, v), None))
            with open(tier._path(DISK_KEY), "rb") as f:
                out[f"disk/{name}/file"] = np.frombuffer(f.read(), np.uint8)
        out[f"disk/{name}/k"], out[f"disk/{name}/v"] = k.view(bits), v.view(bits)
    return out


@pytest.mark.parametrize("name", sorted(DISK_DTYPES))
def test_disk_pages_cross_between_the_tiers_live(tmp_path, name):
    """A page the port's tier writes reads back through the JAX
    package's tier with its dtype and bits, and the other way round."""
    dtype, bits = DISK_DTYPES[name]
    pages = jax_disk_pages()
    k, v = (torch.from_numpy(pages[f"disk/{name}/{x}"].copy()).view(dtype) for x in "kv")
    port = tdurable.KVDiskTier(str(tmp_path / "port"))
    assert port.put(DISK_KEY, ((k, v), None))
    (jk, jv), draft = jdurable.KVDiskTier(str(tmp_path / "port")).get(DISK_KEY)
    assert draft is None and jk.dtype == np.dtype(_ML_DTYPES[name])
    np.testing.assert_array_equal(jk.view(bits), pages[f"disk/{name}/k"])
    np.testing.assert_array_equal(jv.view(bits), pages[f"disk/{name}/v"])
    os.makedirs(tmp_path / "jax")
    (tmp_path / "jax" / (DISK_KEY + ".kvpage")).write_bytes(pages[f"disk/{name}/file"].tobytes())
    (tk, tv), _ = tdurable.KVDiskTier(str(tmp_path / "jax")).get(DISK_KEY)
    assert tk.dtype == dtype and torch.equal(tk, k) and torch.equal(tv, v)


def jax_spec_factory(tree_bf16: dict):
    """``make_engine`` for the JAX engine at the spec case
    (tests/test_torch_spec.py ``run_spec_scenario``)."""
    from dataclasses import replace

    config = jax_config(SPEC_CASE)
    params = jax.tree.map(lambda a: jnp.asarray(a, config.dtype), tree_bf16)
    both = jquant.quantize_params(params)
    small = {"embed": params["embed"], "unembed": params["unembed"],
             "layers": params["layers"][:1]}
    trees = {"self8": (params, jquant.quantize_params(params), config),
             "both8": (both, both, config),
             "small": (params, small, replace(config, n_layers=1))}

    def make(draft: str, **kw):
        target, d_params, d_config = trees[draft]
        return jserve.ServeEngine(target, config, draft_params=d_params,
                                  draft_config=d_config, **kw)

    return make


def jax_spec_units(tree_bf16: dict, inp: dict) -> dict:
    """The JAX package's rowwise block, spec round and batch-1
    speculative decode on the unit inputs (tests/test_torch_spec.py
    ``port_units``)."""
    config = jax_config(SPEC_CASE)
    params = jax.tree.map(lambda a: jnp.asarray(a, config.dtype), tree_bf16)
    draft = jquant.quantize_params(params)

    def pools(a, b):
        return (jnp.asarray(inp[a]), jnp.asarray(inp[b]))

    tables, pos = jnp.asarray(inp["tables"]), jnp.asarray(inp["positions"], jnp.int32)
    out = {}
    logits, (k, v) = jpaged._rowwise_block_core(
        params, pools("pool0", "pool1"), tables[:, :UNIT_COVER],
        jnp.asarray(inp["block"], jnp.int32), pos, config)
    out["rowwise/logits"], out["rowwise/k"], out["rowwise/v"] = _np(logits), _np(k), _np(v)
    committed, n, t_pools, d_pools = jpaged._spec_round_core(
        params, draft, pools("pool0", "pool1"), pools("pool2", "pool3"), tables,
        jnp.asarray(inp["cur"], jnp.int32), pos, t_config=config, d_config=config,
        gamma=UNIT_GAMMA, cover_pages=UNIT_COVER)
    out["round/committed"] = _np(committed).astype(np.int64)
    out["round/n"] = _np(n).astype(np.int64)
    for name, p in zip(("t_k", "t_v", "d_k", "d_v"), (*t_pools, *d_pools)):
        out[f"round/{name}"] = _np(p)
    toks, rounds = jspec.speculative_generate(
        params, draft, jnp.asarray(inp["prompt"], jnp.int32), config, config, 12,
        gamma=UNIT_GAMMA)
    out["generate/tokens"] = _np(toks).astype(np.int64)
    out["generate/rounds"] = np.asarray(rounds)
    return {f"unit/{k}": v for k, v in out.items()}


_SPEC_RUNS = spec_golden_runs()


@pytest.mark.parametrize("key, mode, scenario", _SPEC_RUNS[::9],
                         ids=[r[0] for r in _SPEC_RUNS[::9]])
def test_spec_matches_jax_live(trees, key, mode, scenario):
    """Every ninth frozen speculative run, live: the port's streams,
    statuses, mode trace and per-step counters against the JAX
    engine's."""
    want = run_spec_scenario(jax_spec_factory(trees[SPEC_CASE[1]]), mode, scenario,
                             injector_cls=jfaults.FaultInjector)
    params = convert.params_from_jax(
        jax.tree.map(lambda a: np.asarray(a).astype(np.float32), trees[SPEC_CASE[1]]),
        device="cpu",
    )
    got = run_spec_scenario(port_engine_factory(params, tiny_config(SPEC_CASE)), mode,
                            scenario)
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g, w, err_msg=key)


def jax_quant_outputs(tree_bf16: dict) -> dict:
    """The JAX package's quantize/dequantize bits on the quant inputs in
    float32 and bf16, its int8 tree of the tiny GQA parameters, and
    tree_bytes (tests/test_torch_quant.py ``port_quant``)."""
    inp = quant_inputs()
    out = {}

    def bits(a):
        a = np.asarray(a)
        if a.dtype == np.int8:
            return a
        return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)

    for name, _, axis in QUANT_SHAPES:
        for dt, jdt in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
            entry = jquant.quantize(jnp.asarray(inp[name], jdt), axis)
            out[f"quant/{name}/{dt}/q8"] = bits(entry["q8"])
            out[f"quant/{name}/{dt}/scale"] = bits(entry["scale"])
            out[f"quant/{name}/{dt}/deq"] = bits(jquant.dequantize(entry, jdt))
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), tree_bf16)
    q = jquant.quantize_params(params)
    out["quant/params/unembed/q8"] = bits(q["unembed"]["q8"])
    out["quant/params/unembed/scale"] = bits(q["unembed"]["scale"])
    for i, layer in enumerate(q["layers"]):
        for k in jquant.CONTRACTION_AXES:
            if k in layer:
                out[f"quant/params/layers/{i}/{k}/q8"] = bits(layer[k]["q8"])
                out[f"quant/params/layers/{i}/{k}/scale"] = bits(layer[k]["scale"])
    out["quant/tree_bytes"] = np.asarray([jquant.tree_bytes(params), jquant.tree_bytes(q)],
                                         np.int64)
    return out


def jax_adapters(config) -> dict:
    """tests/test_torch_lora.py's numpy adapters as jax arrays."""
    return jax.tree.map(jnp.asarray, tlora.numpy_adapters(config))


def jax_lora_factory(tree_bf16: dict):
    """``make_engine`` for the JAX engine serving the two adapters
    (tests/test_torch_lora.py ``run_lora_scenario``)."""
    config = jax_config(tlora.LORA_CASE)
    params = jax.tree.map(lambda a: jnp.asarray(a, config.dtype), tree_bf16)
    adapters = jax_adapters(config)
    draft = jquant.quantize_params(params)

    def make(d, **kw):
        extra = dict(draft_params=draft, draft_config=config) if d == "self8" else {}
        return jserve.ServeEngine(params, config, adapters=adapters,
                                  lora_alpha=tlora.ALPHA, **extra, **kw)

    return make


def jax_lora_units(tree_bf16: dict) -> dict:
    """The JAX package's stack_adapters, apply_qkv, wo_row_delta and
    merge_lora on tests/test_torch_lora.py's unit inputs (``port_units``),
    op by op (no jit)."""
    out = {}
    idx = jnp.asarray(tlora.UNIT_IDX, jnp.int32)
    for layout, kv in tlora.LAYOUTS.items():
        config = jax_config(("f32", kv, None))
        ads = jax_adapters(config)
        stacked = jmulti.stack_adapters([ads[n] for n in sorted(ads)], config)
        if layout == "mha":
            for li, entry in enumerate(stacked):
                for name, ab in entry.items():
                    for f in ("a", "b"):
                        out[f"stack/{li}/{name}/{f}"] = _np(ab[f])
        inp = tlora.unit_inputs(layout)
        for dt, jdt in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
            x = {k: jnp.asarray(tlora.bf16_round(v), jdt) for k, v in inp.items()}
            q, k, v = jmulti.apply_qkv(x["q"], x["k"], x["v"], x["h"], stacked[0], idx,
                                       config, tlora.ALPHA, jdt)
            for name, t in (("q", q), ("k", k), ("v", v)):
                out[f"{layout}/{dt}/apply_qkv/{name}"] = _np(t)
            out[f"{layout}/{dt}/wo_row_delta/3d"] = _np(
                jmulti.wo_row_delta(x["attn"], stacked[1], idx, tlora.ALPHA))
            out[f"{layout}/{dt}/wo_row_delta/2d"] = _np(
                jmulti.wo_row_delta(x["attn"][:, 0], stacked[1], idx, tlora.ALPHA))
    config = jax_config(tlora.LORA_CASE)
    adapter = jax_adapters(config)["tenant-a"]
    f32 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), tree_bf16)
    bases = {"bf16": jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), tree_bf16),
             "int8": jquant.quantize_params(f32)}
    for base, dtypes in (("bf16", (None, jnp.float32)), ("int8", (None, jnp.bfloat16))):
        for dtype in dtypes:
            merged = jlora.merge_lora(bases[base], adapter, tlora.ALPHA, dtype=dtype)
            tag = "default" if dtype is None else jnp.dtype(dtype).name
            for li, layer in enumerate(merged["layers"]):
                for name in adapter[li]:
                    out[f"merge/{base}/{tag}/{li}/{name}"] = _np(layer[name])
                    out[f"merge/{base}/{tag}/{li}/{name}/dtype_bits"] = np.asarray(
                        jnp.finfo(layer[name].dtype).bits)
    return {f"unit/{k}": v for k, v in out.items()}


def jax_lora_train_step(dt: str) -> dict:
    """One step of the JAX package's make_lora_train_step (optax.adamw
    1e-3, a one-device mesh) on tests/test_torch_lora.py's inputs
    (``port_train_step``); bf16 with jit disabled, so each operation
    rounds where the source says."""
    from tests import test_torch_train as tt
    from dataclasses import replace

    config = replace(jax_config(("f32", None, None)), max_seq_len=33,
                     dtype=JAX_DTYPES[dt])
    base = jax.tree.map(jnp.asarray, tt.numpy_params(config))
    adapters = jax.tree.map(jnp.asarray, tlora.numpy_adapter(config, 31))
    optimizer = optax.adamw(1e-3)
    state = optimizer.init(adapters)
    step = jlora.make_lora_train_step(config, jtrain.make_mesh(1, 1), optimizer, base,
                                      tlora.ALPHA)
    tokens = jnp.asarray(tt.numpy_tokens(config, 0))
    if dt == "f32":
        adapters, state, loss = step(adapters, state, tokens)
    else:
        with jax.disable_jit():
            adapters, state, loss = step(adapters, state, tokens)
    out = {"loss": np.asarray(float(loss), np.float32)}
    for li, entry in enumerate(adapters):
        for name, ab in entry.items():
            for f in ("a", "b"):
                out[f"{li}/{name}/{f}"] = _np(ab[f])
    return {f"unit/train/{dt}/{k}": v for k, v in out.items()}


_LORA_RUNS = tlora.golden_runs()


@pytest.mark.parametrize("key, mode, scenario", _LORA_RUNS[::7],
                         ids=[r[0] for r in _LORA_RUNS[::7]])
def test_lora_matches_jax_live(trees, key, mode, scenario):
    """Every seventh frozen adapter run, live: the port's streams,
    statuses and per-step counters against the JAX engine's."""
    want = tlora.run_lora_scenario(jax_lora_factory(trees[None]), mode, scenario,
                                   injector_cls=jfaults.FaultInjector)
    config = tiny_config(tlora.LORA_CASE)
    params = convert.params_from_jax(
        jax.tree.map(lambda a: np.asarray(a).astype(np.float32), trees[None]), device="cpu")
    adapters = convert.adapters_from_jax(tlora.numpy_adapters(config), device="cpu")
    got = tlora.run_lora_scenario(tlora.port_engine_factory(params, config, adapters), mode,
                                  scenario)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, w, err_msg=key)


def jax_fleet_package():
    """The JAX package's control-plane modules under the names
    ``tests/test_torch_fleet.run_fleet_scenario`` uses."""
    import types

    from workloads import (autoscaler, backoff, control, durable, errors, faults, fleet,
                           ledger, obs, supervisor)

    return types.SimpleNamespace(
        autoscaler=autoscaler, backoff=backoff, control=control, durable=durable,
        errors=errors, faults=faults, fleet=fleet, ledger=ledger, obs=obs,
        supervisor=supervisor,
    )


def jax_fleet_factory(tree_bf16: dict):
    config = jax_config(tfleet.FLEET_CASE)
    params = jax.tree.map(lambda a: jnp.asarray(a, config.dtype), tree_bf16)

    def make(**kw):
        return jserve.ServeEngine(params, config, **{**tfleet.FLEET_KW, **kw})

    return make


def port_fleet_factory(tree_bf16: dict):
    params = convert.params_from_jax(
        jax.tree.map(lambda a: np.asarray(a).astype(np.float32), tree_bf16), device="cpu")
    config = tiny_config(tfleet.FLEET_CASE)

    def make(**kw):
        return tserve.ServeEngine(params, config, device="cpu", **{**tfleet.FLEET_KW, **kw})

    return make


def port_journal_restores_in_jax(tree_bf16: dict, want_tokens: np.ndarray) -> None:
    """The other direction of the cross-engine journal check: the port's
    fleet closes mid-stream, and the JAX fleet restores its journal and
    disk pages and continues every stream to the JAX fleet's tokens."""
    import shutil

    with tempfile.TemporaryDirectory() as tmp:
        tfleet.run_fleet_scenario(tfleet.port_package(), port_fleet_factory(tree_bf16),
                                  "journal", workdir=tmp)
        root = os.path.join(tmp, "restore")
        shutil.copytree(os.path.join(tmp, "at-close"), root)
        make = jax_fleet_factory(tree_bf16)
        kw = dict(prefix_cache=True, kv_offload=True, kv_disk_dir=os.path.join(root, "disk"))
        fl = jax_fleet_package().fleet.Fleet(
            [make(**kw) for _ in range(2)], chip_ids=["chip-0", "chip-1"],
            hang_timeout_s=None, journal_dir=os.path.join(root, "journal"))
        assert fl.restore() == len(want_tokens)
        fl.run()
        for i in range(len(want_tokens)):
            fr = fl._reqs[f"req-{i}"]
            assert fr.status == "ok"
            assert fr.tokens == [int(t) for t in want_tokens[i] if t >= 0], i
        fl.close()


@pytest.mark.parametrize("scenario", tfleet.FLEET_SCENARIOS)
def test_fleet_matches_jax_live(trees, scenario):
    """The port's fleet scenario against the JAX fleet's, live."""
    tree = trees[tfleet.FLEET_CASE[1]]
    want = tfleet.run_fleet_scenario(jax_fleet_package(), jax_fleet_factory(tree), scenario)
    got = tfleet.run_fleet_scenario(tfleet.port_package(), port_fleet_factory(tree), scenario)
    for name, value in got.items():
        np.testing.assert_array_equal(value, want[name], err_msg=f"{scenario}/{name}")
    if scenario == "journal":
        port_journal_restores_in_jax(tree, want["tokens"])


# ==== perfbench's FLOP accounting and the lock-step serve_batch


def _accounting(perf, sweep, config, batch):
    return (perf.layer_matmul_params(config), perf.fwd_attn_flops(config, batch),
            perf.train_step_flops(config, batch), sweep.hardware_flops(config, batch))


@pytest.mark.parametrize("name", sorted(jmfu.POINTS))
def test_flop_accounting_equals_jax_for_every_sweep_point(name):
    """The port's points are JAX's, and every accounting function gives
    JAX's value exactly (plain arithmetic, no tolerance)."""
    jp, tp = jmfu.POINTS[name], tmfu.POINTS[name]
    fields = ("name", "d_model", "n_heads", "n_layers", "d_ff", "vocab", "seq", "batch",
              "remat")
    assert [getattr(tp, f) for f in fields] == [getattr(jp, f) for f in fields]
    assert tmfu.POINTS.keys() == jmfu.POINTS.keys()
    assert (_accounting(tperf, tmfu, tp.config(), tp.batch)
            == _accounting(jperf, jmfu, jp.config(), jp.batch))


@pytest.mark.parametrize("scale", ["full", "tiny"])
@pytest.mark.parametrize("kv_heads", [None, 2])
def test_flop_accounting_equals_jax_for_both_bench_scales(scale, kv_heads):
    from dataclasses import replace

    jc = replace(jperf._model_config(jperf.BenchScale.named(scale)), n_kv_heads=kv_heads)
    tc = replace(tperf._model_config(tperf.BenchScale.named(scale)), n_kv_heads=kv_heads)
    batch = jperf.BenchScale.named(scale).batch
    assert (_accounting(tperf, tmfu, tc, batch)
            == _accounting(jperf, jmfu, jc, batch))
    assert (_accounting(tperf, tmfu, replace(tc, remat_layers=True), batch)
            == _accounting(jperf, jmfu, replace(jc, remat_layers=True), batch))


def test_serve_batch_matches_jax_float32_live():
    """Float32 lock-step tokens on the tiny config equal JAX's
    serve_batch token for token, and both pools give back every page."""
    jconfig = jmodel.ModelConfig(max_seq_len=64, n_layers=2, dtype=jnp.float32)
    tconfig = tmodel.ModelConfig(max_seq_len=64, n_layers=2, dtype=torch.float32)
    tree = jax.tree.map(np.asarray, jmodel.init_params(jconfig, jax.random.PRNGKey(0)))
    prompts = np.random.default_rng(1).integers(0, jconfig.vocab_size, (2, 8))
    jctrl = jpaged.PagePool(n_pages=32, page_size=4)
    want, _ = jserve.serve_batch(
        jax.tree.map(jnp.asarray, tree), jconfig, jnp.asarray(prompts, jnp.int32), 10,
        jctrl, jpaged.init_page_pools(jconfig, 32, 4))
    tctrl = tpaged.PagePool(n_pages=32, page_size=4)
    got, _ = tserve.serve_batch(
        convert.params_from_jax(tree, device="cpu"), tconfig, torch.as_tensor(prompts), 10,
        tctrl, tpaged.init_page_pools(tconfig, 32, 4, device="cpu"))
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert jctrl.used_pages == 0 and tctrl.used_pages == 0


def jax_perfbench_fleet_fields(name: str) -> dict:
    """The fields of one of JAX's fleet arms at the tiny scale that its
    schedule alone fixes (tests/test_torch_perfbench_fleet.py)."""
    out = getattr(jperf, name)(jperf.BenchScale.named("tiny"))
    return {k: out[k] for k in tpbf.GOLDEN_FIELDS[name]}


@pytest.mark.parametrize("name", sorted(tpbf.GOLDEN_FIELDS))
def test_perfbench_fleet_fields_match_jax_live(name):
    """The port's fleet arm at the tiny scale against JAX's, live, on
    the fields its schedule fixes."""
    got = getattr(tperf, name)(tperf.BenchScale.named("tiny"), "cpu")
    assert {k: got[k] for k in tpbf.GOLDEN_FIELDS[name]} == jax_perfbench_fleet_fields(name)


def _jax_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


def jax_tp_config(name: str) -> jmodel.ModelConfig:
    return jmodel.ModelConfig(dtype=jnp.float32, **tw.CONFIGS[name])


def jax_tp_case(name: str, mp: int) -> dict:
    """One engine case of tests/torch_tp_world.py on the JAX package's TP
    engine over a (1, mp) mesh of the CPU devices."""
    case = tw.CASES[name]
    kw = dict(case.kw)
    if case.draft is not None:
        kw.update(draft_params=_jax_tree(tw.numpy_params(case.draft)),
                  draft_config=jax_tp_config(case.draft))
    if case.adapters:
        kw["adapters"] = _jax_tree(tw.numpy_adapters(case.config))
    engine = jserve.ServeEngine(_jax_tree(tw.numpy_params(case.config)),
                                jax_tp_config(case.config),
                                mesh=jtrain.make_mesh(mp, model_parallel=mp), **kw)
    return tw.drive(engine, case.script)


def jax_tp_generate(name: str, shape: tuple, seed: int) -> list:
    data, model = shape
    prompts = np.random.default_rng(seed).integers(0, tw.VOCAB, (4, 8)).astype(np.int32)
    mesh = jtrain.make_mesh(data * model, model_parallel=model)
    got = jtp.make_tp_generate(jax_tp_config(name), mesh)(
        _jax_tree(tw.numpy_params(name)), jnp.asarray(prompts), 12)
    return np.asarray(got).tolist()


def jax_tp_goldens() -> dict:
    """The JAX TP engine's streams for every golden case and mesh, TP
    generate's tokens per mesh, and param_specs as tuples."""
    out = {"case": {}, "generate": {}, "param_specs": {}}
    for name, case in tw.CASES.items():
        if case.golden:
            for mp in case.meshes:
                out["case"][f"{name}/{mp}"] = jax_tp_case(name, mp)["streams"]
    for name, shape, seed in (m for ms in tw.GENERATE_MESHES.values() for m in ms):
        out["generate"][f"{name}{shape}"] = jax_tp_generate(name, shape, seed)
    for name in ("mha", "gqa"):
        specs = jmodel.param_specs(jax_tp_config(name))
        out["param_specs"][name] = jax.tree.map(
            tuple, specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return out


def test_tp_serve_matches_jax_live():
    """The frozen JAX TP streams, generate tokens and param_specs
    (tests/test_torch_tp_golden.npz) are what the JAX package computes
    now."""
    assert ttp.jsonable(jax_tp_goldens()) == ttp.load_tp_golden()


def write_tp_goldens(path: str = ttp.TP_GOLDEN) -> None:
    """Freeze the JAX package's tensor-parallel outputs for
    tests/test_torch_tp_serve.py: one JSON document in the npz."""
    doc = json.dumps(ttp.jsonable(jax_tp_goldens()), sort_keys=True)
    np.savez_compressed(path, tp=np.array(doc))
    print(f"wrote {path}: {os.path.getsize(path)} bytes")


def jax_train_parallel_config(**kw) -> jmodel.ModelConfig:
    return jmodel.ModelConfig(dtype=jnp.float32, **dict(trw.CONFIG, **kw))


def _jax_meshed_losses(mesh, step_of) -> np.ndarray:
    """``trw.STEPS`` steps of the JAX step ``step_of(config, optimizer)``
    on ``mesh`` from the numpy weights (placed by ``param_specs`` through
    ``make_sharded_train_state``, optax.adamw(1e-3, mu_dtype=bf16))."""
    config = jax_train_parallel_config()
    (params, opt), optimizer = jtrain.make_sharded_train_state(
        mesh, lambda: _jax_tree(trw.numpy_params()), jmodel.param_specs(config))
    step = step_of(config, optimizer)
    losses = []
    for s in range(trw.STEPS):
        params, opt, loss = step(params, opt, jnp.asarray(trw.numpy_tokens(s)))
        losses.append(float(loss))
    return np.asarray(losses, np.float32)


def _jax_op(mode: str, kw: dict, causal: bool) -> dict:
    from jax.sharding import Mesh

    from workloads.ops.ring import ring_attention
    from workloads.ops.ulysses import ulysses_attention
    from workloads.ops.usp import usp_attention

    q, k, v = (jnp.asarray(x) for x in trw.numpy_qkv())
    if mode == "usp":
        n = kw["ring"] * kw["ulysses"]
        mesh = Mesh(np.array(jax.devices()[:n]).reshape(kw["ring"], kw["ulysses"]),
                    ("seq_r", "seq_u"))

        def fn(q, k, v):
            return usp_attention(q, k, v, mesh, causal=causal)
    else:
        mesh = Mesh(np.array(jax.devices()[:kw["seq_parallel"]]), ("seq",))
        core = ring_attention if mode == "ring" else ulysses_attention

        def fn(q, k, v):
            return core(q, k, v, mesh, causal=causal)

    out = fn(q, k, v)
    grads = jax.grad(lambda q, k, v: jnp.sum(fn(q, k, v) ** 2), argnums=(0, 1, 2))(q, k, v)
    return {"out": np.asarray(out), **{f"d{n}": np.asarray(g) for n, g in zip("qkv", grads)}}


def jax_train_parallel_goldens() -> dict:
    """The JAX package's meshed training steps' per-step losses for every
    layout of tests/torch_train_world.py, its sequence-parallel steps'
    losses, and ring, Ulysses and USP attention's outputs and gradients
    (causal and full), on the CPU devices."""
    out = {}
    for name, (_, (data, model)) in trw.LAYOUTS.items():
        mesh = jtrain.make_mesh(data * model, model_parallel=model)
        out[f"steps/{name}"] = _jax_meshed_losses(
            mesh, lambda c, o, mesh=mesh: jtrain.make_train_step(c, mesh, o))
    for name, (world, attention, builder, kw) in trw.SP_LAYOUTS.items():
        make = jtrain.make_usp_mesh if builder == "usp" else jtrain.make_sp_mesh
        mesh = make(world, **kw)
        out[f"sp/{name}"] = _jax_meshed_losses(
            mesh, lambda c, o, mesh=mesh, a=attention: jtrain.make_seq_parallel_train_step(
                c, mesh, o, attention=a))
    for name, (_, mode, kw) in trw.OPS.items():
        for causal in (True, False):
            for key, value in _jax_op(mode, kw, causal).items():
                out[f"op/{name}/{'causal' if causal else 'full'}/{key}"] = value
    return out


def test_train_parallel_matches_jax_live():
    """The frozen JAX training layouts (tests/test_torch_train_parallel_golden.npz)
    are what the JAX package computes now, within the fast tier's
    tolerances (XLA's CPU reductions may reorder between versions)."""
    live = jax_train_parallel_goldens()
    with np.load(trw.GOLDEN) as f:
        frozen = {k: f[k] for k in f.files}
    assert set(live) == set(frozen)
    for key, value in live.items():
        np.testing.assert_allclose(value, frozen[key], rtol=2.0**-20, atol=1e-6, err_msg=key)


def write_train_parallel_goldens(path: str = trw.GOLDEN) -> None:
    """Freeze the JAX training layouts for tests/test_torch_train_parallel.py
    and tests/test_torch_seq_parallel.py."""
    arrays = jax_train_parallel_goldens()
    np.savez_compressed(path, **arrays)
    print(f"wrote {path}: {os.path.getsize(path)} bytes, {len(arrays)} arrays")


def _flat_np(tree, prefix: str) -> dict:
    """A JAX tree as flat ``prefix/a/b`` -> numpy arrays."""
    if isinstance(tree, (list, tuple)):
        tree = dict(enumerate(tree))
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_np(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


def _jax_steps(step, params, opt, batch_of) -> np.ndarray:
    losses = []
    for s in range(mw.STEPS):
        params, opt, loss = step(params, opt, *batch_of(s))
        losses.append(float(loss))
    return np.asarray(losses, np.float32)


def jax_pipeline_goldens() -> dict:
    """The JAX pipeline on tests/torch_model_world.py's numpy weights:
    ``pipeline_loss_fn`` on the pp-only meshes and its gradients (the
    stage tree) on the first, and three steps of ``make_pipeline_train_step`` on every
    layout's mesh, each on the batch of step 0."""
    config = jmodel.ModelConfig(dtype=jnp.float32, **mw.PP_CONFIG)
    layers = mw.pp_numpy_layers()
    tokens = jnp.asarray(mw.pp_tokens(0))
    out = {}
    for name in mw.PP_GRADS:
        world, (_, pipe) = mw.PP_LAYOUTS[name]
        mesh = jpipe.make_pp_mesh(world, pipe_parallel=pipe)
        tree = _jax_tree(mw.stack_stages(layers, pipe))
        loss, grads = jax.value_and_grad(lambda p, mesh=mesh: jpipe.pipeline_loss_fn(
            p, tokens, config, mesh, mw.PP_MICRO))(tree)
        out[f"grads/{name}/loss"] = np.float32(loss)
        if name == mw.PP_GRADS[0]:  # one layout's gradients keep the file under 1 MB
            out.update(_flat_np(grads, f"grads/{name}"))
    for name, (world, (_, pipe)) in mw.PP_LAYOUTS.items():
        mesh = jpipe.make_pp_mesh(world, pipe_parallel=pipe)
        (params, opt), optimizer = jtrain.make_sharded_train_state(
            mesh, lambda pipe=pipe: _jax_tree(mw.stack_stages(layers, pipe)),
            jpipe.pipeline_param_specs(config))
        step = jpipe.make_pipeline_train_step(config, mesh, optimizer, mw.PP_MICRO)
        out[f"steps/{name}"] = _jax_steps(step, params, opt, lambda s: (tokens,))
    return out


def jax_moe_goldens() -> dict:
    """The JAX MoE on tests/torch_model_world.py's numpy weights:
    ``moe_ffn`` alone (y, aux, and the gradients of sum(y**2) + aux),
    ``moe_loss_fn`` on the model tree, and three steps of
    ``make_moe_train_step`` on every layout's mesh, each on the batch of
    step 0."""
    ffn, x = mw.ffn_numpy()
    moe = jmoe.MoEConfig(n_experts=mw.FFN_DIMS[2], capacity_factor=mw.FFN_CAPACITY)
    ffn, x = _jax_tree(ffn), jnp.asarray(x)
    y, aux = jmoe.moe_ffn(ffn, x, moe)
    out = {"ffn/y": np.asarray(y), "ffn/aux": np.float32(aux)}

    def ffn_loss(p):
        y, aux = jmoe.moe_ffn(p, x, moe)
        return jnp.sum(y**2) + aux

    out.update(_flat_np(jax.grad(ffn_loss)(ffn), "ffn/grads"))
    config = jax_train_parallel_config()
    moe = jmoe.MoEConfig()
    tree = mw.moe_numpy_params()
    tokens = jnp.asarray(trw.numpy_tokens(0))
    out["loss"] = np.float32(jmoe.moe_loss_fn(_jax_tree(tree), tokens, config, moe))
    for name, (world, (_, expert, model)) in mw.MOE_LAYOUTS.items():
        mesh = jmoe.make_moe_mesh(world, expert_parallel=expert, model_parallel=model)
        (params, opt), optimizer = jtrain.make_sharded_train_state(
            mesh, lambda: _jax_tree(tree), jmoe.moe_param_specs(config))
        step = jmoe.make_moe_train_step(config, moe, mesh, optimizer)
        out[f"steps/{name}"] = _jax_steps(step, params, opt, lambda s: (tokens,))
    return out


def jax_vision_goldens() -> dict:
    """The JAX CNN on tests/torch_model_world.py's numpy weights and
    images: float32 and bf16 logits and the float32 loss on the batch of
    step 0, and three float32 steps of ``make_train_step`` on a 2-device
    ("data",) mesh at optax.adamw(1e-3), on the batches of steps 0-2."""
    from jax.sharding import Mesh

    tree = _jax_tree(mw.vision_numpy_params())
    images, labels = (jnp.asarray(a) for a in mw.vision_numpy_batch(0))
    f32 = jvision.VisionConfig(dtype=jnp.float32)
    out = {"logits/f32": np.asarray(jvision.forward(tree, images, f32)),
           "logits/bf16": np.asarray(jvision.forward(tree, images, jvision.VisionConfig())),
           "loss/f32": np.float32(jvision.loss_fn(tree, images, labels, f32))}
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    (params, opt), optimizer = jtrain.make_sharded_train_state(
        mesh, lambda: _jax_tree(mw.vision_numpy_params()), jvision.param_specs(),
        optimizer=optax.adamw(1e-3))
    step = jvision.make_train_step(f32, mesh, optimizer)
    out["steps/dp2"] = _jax_steps(step, params, opt, lambda s: tuple(
        jnp.asarray(a) for a in mw.vision_numpy_batch(s)))
    return out


_MODEL_GOLDENS = {mw.PIPELINE_GOLDEN: jax_pipeline_goldens, mw.MOE_GOLDEN: jax_moe_goldens,
                  mw.VISION_GOLDEN: jax_vision_goldens}


@pytest.mark.parametrize("path", sorted(_MODEL_GOLDENS), ids=os.path.basename)
def test_pipeline_moe_vision_match_jax_live(path):
    """The frozen JAX pipeline, MoE and vision outputs are what the JAX
    package computes now, within the fast tier's tolerances (XLA's CPU
    reductions may reorder between versions)."""
    live = _MODEL_GOLDENS[path]()
    with np.load(path) as f:
        frozen = {k: f[k] for k in f.files}
    assert set(live) == set(frozen)
    for key, value in live.items():
        np.testing.assert_allclose(value, frozen[key], rtol=2.0**-20, atol=1e-6, err_msg=key)


def test_pipeline_and_moe_ports_match_jax_live():
    """The port's one-device pipeline (a 1 x 1 view of the mesh) and MoE
    loss on the numpy weights against the JAX package's, computed live."""
    from tests.test_torch_pipeline import RankView
    from workloads_torch import moe as tmoe
    from workloads_torch import pipeline as tpipe

    want = jax_pipeline_goldens()
    tree = mw.pp_port_params(1)
    got = tpipe.pipeline_loss_fn(tree, torch.as_tensor(mw.pp_tokens(0)), mw.pp_config(),
                                 RankView(("data", "pipe")), mw.PP_MICRO)
    np.testing.assert_allclose(float(got), want["grads/pp2/loss"], rtol=1e-5)
    want = jax_moe_goldens()
    got = tmoe.moe_loss_fn(mw.moe_port_params(), torch.as_tensor(trw.numpy_tokens(0)),
                           trw.port_config(), tmoe.MoEConfig())
    np.testing.assert_allclose(float(got), want["loss"], rtol=2.0**-20)


def write_model_goldens() -> None:
    """``write_pipeline_goldens``, ``write_moe_goldens`` and
    ``write_vision_goldens``."""
    write_pipeline_goldens()
    write_moe_goldens()
    write_vision_goldens()


def _write(path: str, arrays: dict) -> None:
    np.savez_compressed(path, **arrays)
    print(f"wrote {path}: {os.path.getsize(path)} bytes, {len(arrays)} arrays")


def write_pipeline_goldens(path: str = mw.PIPELINE_GOLDEN) -> None:
    """Freeze the JAX pipeline for tests/test_torch_pipeline.py."""
    _write(path, jax_pipeline_goldens())


def write_moe_goldens(path: str = mw.MOE_GOLDEN) -> None:
    """Freeze the JAX MoE for tests/test_torch_moe.py."""
    _write(path, jax_moe_goldens())


def write_vision_goldens(path: str = mw.VISION_GOLDEN) -> None:
    """Freeze the JAX CNN for tests/test_torch_vision.py."""
    _write(path, jax_vision_goldens())


def jax_busy_aggregates(tmp: str) -> dict:
    """The JAX probe's ``aggregate`` over tests/test_torch_busy_probe.py's
    seeded reports."""
    os.makedirs(tmp, exist_ok=True)
    return {name: tbusy.aggregate_rows(jbusy.aggregate, rows, os.path.join(tmp, f"{name}.jsonl"))
            for name, rows in tbusy.busy_reports().items()}


def test_busy_aggregate_matches_jax_live(tmp_path):
    """The two packages' ``aggregate`` over the same seeded reports."""
    want = jax_busy_aggregates(str(tmp_path / "jax"))
    for name, rows in tbusy.busy_reports().items():
        got = tbusy.aggregate_rows(tbusy_probe.aggregate, rows, str(tmp_path / f"{name}.jsonl"))
        assert got == want[name], name


def write_busy_goldens(path: str = tbusy.BUSY_GOLDEN) -> None:
    """Freeze the JAX probe's ``aggregate`` over the seeded reports for
    tests/test_torch_busy_probe.py."""
    with tempfile.TemporaryDirectory() as tmp:
        out = jax_busy_aggregates(tmp)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(out, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {path}: {os.path.getsize(path)} bytes, {len(out)} reports")


def write_perfbench_fleet_goldens(path: str = tpbf.FLEET_GOLDEN) -> None:
    """Freeze the schedule-fixed fields of JAX's fleet arms at the tiny
    scale for tests/test_torch_perfbench_fleet.py."""
    import json

    fields = {name: jax_perfbench_fleet_fields(name) for name in sorted(tpbf.GOLDEN_FIELDS)}
    with open(path, "w", encoding="utf-8") as f:
        json.dump(fields, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {path}: {os.path.getsize(path)} bytes, {len(fields)} arms")


def write_fleet_goldens(path: str = tfleet.FLEET_GOLDEN) -> None:
    """Freeze the JAX fleet's scripted runs for tests/test_torch_fleet.py
    (streams, statuses, attempts, counters, event kinds, journal
    digests, TrafficGen's schedules) and the journal directory it left
    when it closed mid-stream; check that the port's journal restores
    into the JAX fleet."""
    tree = jax_params_bf16(tfleet.FLEET_CASE[1])
    pkg = jax_fleet_package()
    make = jax_fleet_factory(tree)
    arrays = tfleet.traffic_arrays(pkg)
    with tempfile.TemporaryDirectory() as tmp:
        for scenario in tfleet.FLEET_SCENARIOS:
            workdir = os.path.join(tmp, scenario)
            os.makedirs(workdir)
            out = tfleet.run_fleet_scenario(pkg, make, scenario, workdir=workdir)
            arrays.update({f"{scenario}/{k}": v for k, v in out.items()})
        root = os.path.join(tmp, "journal", "at-close")
        for dirpath, _, files in os.walk(root):
            for name in sorted(files):
                full = os.path.join(dirpath, name)
                with open(full, "rb") as f:
                    data = np.frombuffer(f.read(), np.uint8)
                arrays[f"cross/file/{os.path.relpath(full, root)}"] = data
    arrays["cross/rids"] = np.asarray([f"req-{i}" for i in range(len(arrays["journal/tokens"]))])
    port_journal_restores_in_jax(tree, arrays["journal/tokens"])
    np.savez_compressed(path, **arrays)
    print(f"wrote {path}: {os.path.getsize(path)} bytes, {len(arrays)} arrays")


def write_lora_goldens(path: str = tlora.LORA_GOLDEN) -> None:
    """Freeze the JAX engine's adapter scenarios (streams, statuses and
    per-step counters), the unit outputs and one LoRA fine-tune step a
    dtype for tests/test_torch_lora.py."""
    tree = jax_params_bf16(tlora.LORA_CASE[1])
    arrays = jax_lora_units(tree)
    for dt in ("f32", "bf16"):
        arrays.update(jax_lora_train_step(dt))
    make = jax_lora_factory(tree)
    for key, mode, scenario in tlora.golden_runs():
        tokens, counters, statuses, _ = tlora.run_lora_scenario(
            make, mode, scenario, injector_cls=jfaults.FaultInjector)
        arrays.update({f"{key}/tokens": tokens, f"{key}/counters": counters,
                       f"{key}/statuses": statuses})
    np.savez_compressed(path, **arrays)
    print(f"wrote {path}: {os.path.getsize(path)} bytes, {len(arrays)} arrays")


def write_spec_goldens(path: str = SPEC_GOLDEN) -> None:
    """Freeze the JAX engine's speculative scenarios (streams, statuses,
    mode traces and per-step counters) and the unit outputs for
    tests/test_torch_spec.py."""
    tree = jax_params_bf16(SPEC_CASE[1])
    arrays = jax_spec_units(tree, unit_inputs())
    arrays.update(jax_quant_outputs(tree))
    make = jax_spec_factory(tree)
    for key, mode, scenario in spec_golden_runs():
        tokens, counters, statuses, trace, _ = run_spec_scenario(
            make, mode, scenario, injector_cls=jfaults.FaultInjector)
        arrays.update({f"{key}/tokens": tokens, f"{key}/counters": counters,
                       f"{key}/statuses": statuses, f"{key}/trace": trace})
    np.savez_compressed(path, **arrays)
    print(f"wrote {path}: {os.path.getsize(path)} bytes, {len(arrays)} arrays")


def write_kv_goldens(path: str = KV_GOLDEN) -> None:
    """Freeze the JAX engine's KV-hierarchy scenarios (streams, statuses
    and per-step counters) and two pages its disk tier wrote for
    tests/test_torch_kv_hierarchy.py."""
    tree = jax_params_bf16(KV_CASE[1])
    arrays = jax_disk_pages()
    for key, mode, scenario in kv_golden_runs():
        tokens, counters, statuses, _ = jax_kv_run(tree, mode, scenario)
        arrays.update({f"{key}/tokens": tokens, f"{key}/counters": counters,
                       f"{key}/statuses": statuses})
    np.savez_compressed(path, **arrays)
    print(f"wrote {path}: {os.path.getsize(path)} bytes, {len(arrays)} arrays")


def write_lifecycle_goldens(path: str = LIFECYCLE_GOLDEN) -> None:
    """Freeze the JAX engine's lifecycle scenarios for
    tests/test_torch_lifecycle.py: streams, statuses and per-step
    counters."""
    tree = jax_params_bf16(SCHEDULE_CASE[1])
    arrays = {}
    for key, mode, scenario in golden_runs():
        tokens, counters, statuses, _ = jax_lifecycle_run(tree, mode, scenario)
        arrays.update({f"{key}/tokens": tokens, f"{key}/counters": counters,
                       f"{key}/statuses": statuses})
    np.savez_compressed(path, **arrays)
    print(f"wrote {path}: {os.path.getsize(path)} bytes, {len(arrays)} arrays")


def write_superstep_goldens(path: str = SUPERSTEP_GOLDEN) -> None:
    """Freeze the JAX package's superstep outputs and its engine's
    per-step scheduling telemetry for tests/test_torch_superstep.py and
    tests/test_torch_schedule.py."""
    inp = superstep_inputs()
    arrays = {f"superstep/input/{k}": np.asarray(v) for k, v in inp.items()}
    trees = {None: jax_params_bf16(None), 2: jax_params_bf16(2)}
    for case in SS_CASES:
        key = case_key(case)
        eos = superstep_eos(case, trees[case[1]], inp)
        arrays[f"superstep/{key}/eos"] = eos
        for k in SS_KS:
            out = jax_superstep(case, trees[case[1]], inp, eos, k)
            arrays.update({f"superstep/{key}/k{k}/{n}": v for n, v in out.items()})
    for mode in SCHEDULE_MODES:
        tokens, telemetry = jax_engine_trace(mode, trees[SCHEDULE_CASE[1]])
        arrays[f"schedule/{mode_key(mode)}/tokens"] = tokens
        arrays[f"schedule/{mode_key(mode)}/telemetry"] = telemetry
    np.savez_compressed(path, **arrays)
    print(f"wrote {path}: {os.path.getsize(path)} bytes, {len(arrays)} arrays")


def write_goldens(path: str = GOLDEN) -> None:
    """Freeze the JAX package's outputs for tests/test_torch_golden.py.
    Only unwindowed cases keep their written pages, so the fixture
    stays under 1 MB."""
    inp = make_inputs()
    arrays = {f"input/{k}": np.asarray(v) for k, v in inp.items()}
    trees = {None: jax_params_bf16(None), 2: jax_params_bf16(2)}
    for kv, tree in trees.items():
        arrays.update(flat_bits(tree, f"params_{'gqa' if kv else 'mha'}"))
    for case in CASES:
        out = jax_outputs(case, trees[case[1]], inp)
        if case[2] is not None:
            out.pop("prefill_k")
            out.pop("prefill_v")
        arrays.update({f"{case_key(case)}/{k}": v for k, v in out.items()})
    arrays.update(jax_filter_outputs(inp))
    np.savez_compressed(path, **arrays)
    print(f"wrote {path}: {os.path.getsize(path)} bytes, {len(arrays)} arrays")


if __name__ == "__main__":
    if sys.argv[1:] != ["--write-goldens"]:
        sys.exit("usage: python tests/test_torch_parity.py --write-goldens")
    write_goldens()
    write_superstep_goldens()
    write_lifecycle_goldens()
    write_kv_goldens()
    write_spec_goldens()
    write_lora_goldens()
    write_fleet_goldens()
    write_perfbench_fleet_goldens()
    write_busy_goldens()
    write_tp_goldens()
    write_train_parallel_goldens()
    write_model_goldens()
