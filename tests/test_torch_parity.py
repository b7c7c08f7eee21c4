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
(the request lifecycle) against tests/test_torch_lifecycle_golden.npz;

    python tests/test_torch_parity.py --write-goldens

regenerates the three fixtures from the JAX package.
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
from workloads import generate as jgen  # noqa: E402
from workloads import model as jmodel  # noqa: E402
from workloads import paged as jpaged  # noqa: E402
from workloads import serve as jserve  # noqa: E402
from workloads.ops import paged_attention as jpa  # noqa: E402
from workloads_torch import convert  # noqa: E402
from workloads_torch import model as tmodel  # noqa: E402
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
