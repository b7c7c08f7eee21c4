"""The port's engine scheduling (workloads_torch.serve: ``superstep_k``,
``pipelined``, ``prefill_budget``, ``batched_admission``) on the CPU.

torch, numpy and the port only, so it runs in the fast tier.  Two
comparisons with the JAX package, in every one of the 24 modes:

* the float32 greedy streams of the golden file's engine run
  (tests/test_torch_golden.npz, ``engine_tokens``, frozen from the JAX
  engine at its defaults, which the JAX package pins equal in every
  mode) for the float32 cases without and with GQA and a window, token
  for token;
* a stream with prompts of up to three prefill chunks
  (``schedule_requests``), whose tokens and per-step scheduling
  telemetry (the counters of ``TELEMETRY`` after each ``step()``) were
  frozen from the JAX engine in the same mode
  (tests/test_torch_superstep_golden.npz): scheduling must match, not
  only the tokens.

Then the JAX package's own contracts for these modes (its
tests/test_superstep.py, test_chunked_prefill.py, test_batched_admission.py
and test_serve.py), ported: fewer steps for the same tokens, the device
mask stops emission at eos, over-decode bounded and reconciled, page
pre-commitment never faults, close reclaims work in flight, the budget
bounds prefill dispatches and lets decode run beside a parked prefill,
serial and batched admission agree, and the validations.
"""

from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

from tests.test_torch_golden import (
    ENGINE_REQUESTS,
    GOLDEN,
    case_key,
    engine_array,
    params_to_torch,
    tiny_config,
)
from tests.test_torch_superstep import SUPERSTEP_GOLDEN, one_torch_thread  # noqa: F401
from workloads_torch import InvalidRequest
from workloads_torch.generate import generate
from workloads_torch.model import ModelConfig, init_params
from workloads_torch.serve import ServeEngine, main

# (superstep_k, pipelined, prefill_budget, batched_admission); the budget
# is one prompt bucket.
SCHEDULE_MODES = list(itertools.product((1, 2, 4), (False, True), (None, 12), (True, False)))
ENGINE_KW = dict(slots=2, page_size=4, prompt_bucket=12, chunk=4)
SCHEDULE_CASE = ("f32", 2, 5)
TELEMETRY = (
    "chunks_run", "supersteps_run", "tokens_overdecoded", "prefill_dispatches",
    "prefill_sweeps", "prefills_run", "prefill_tokens", "prefill_deferred_tokens",
    "admission_readbacks", "requests_admitted",
)


def mode_key(mode) -> str:
    k, piped, budget, batched = mode
    return (f"k{k}_{'piped' if piped else 'plain'}_{'budget' if budget else 'unbudgeted'}_"
            f"{'batched' if batched else 'serial'}")


def mode_kwargs(mode) -> dict:
    k, piped, budget, batched = mode
    return dict(superstep_k=k, pipelined=piped, prefill_budget=budget,
                batched_admission=batched)


def schedule_requests() -> list[tuple[np.ndarray, int]]:
    """Six requests whose prompts take one to three prefill chunks."""
    rng = np.random.default_rng(99)
    return [(rng.integers(0, 256, n), int(rng.integers(2, 21)))
            for n in (30, 5, 17, 3, 26, 9)]


def trace_engine(engine, requests) -> tuple[np.ndarray, np.ndarray]:
    """Submit every request, step to idle, and return (streams as
    ``engine_array``, the TELEMETRY counters after each step); works on
    the JAX engine and the port's alike."""
    rids = [engine.submit(p, n) for p, n in requests]
    served, rows = {}, []
    while not engine.idle:
        for req in engine.step():
            served[req.rid] = req.tokens
        rows.append([getattr(engine, name) for name in TELEMETRY])
    return engine_array([served[r] for r in rids]), np.asarray(rows, np.int64)


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as f:
        out = {k: f[k] for k in f.files if not k.startswith("bf16")}
    with np.load(SUPERSTEP_GOLDEN) as f:
        return out | {k: f[k] for k in f.files if k.startswith("schedule/")}


def _params(golden, case):
    return params_to_torch(golden, f"params_{'gqa' if case[1] else 'mha'}", torch.float32)


@pytest.mark.parametrize("mode", SCHEDULE_MODES, ids=[mode_key(m) for m in SCHEDULE_MODES])
def test_engine_streams_match_jax_in_every_mode(golden, mode):
    """The golden engine run, MHA and GQA with a window: the JAX engine's
    frozen greedy streams, token for token, and no page left in use."""
    for case in (("f32", None, None), SCHEDULE_CASE):
        engine = ServeEngine(_params(golden, case), tiny_config(case), device="cpu",
                             **ENGINE_KW, **mode_kwargs(mode))
        rids = [engine.submit(golden[f"input/engine_prompt{i}"],
                              int(golden[f"input/engine_new{i}"]))
                for i in range(ENGINE_REQUESTS)]
        served = engine.run()
        np.testing.assert_array_equal(engine_array([served[r] for r in rids]),
                                      golden[f"{case_key(case)}/engine_tokens"],
                                      err_msg=case_key(case))
        assert engine.ctrl.used_pages == 0 and engine.idle


@pytest.mark.parametrize("mode", SCHEDULE_MODES, ids=[mode_key(m) for m in SCHEDULE_MODES])
def test_engine_schedule_matches_jax_step_by_step(golden, mode):
    """Multi-chunk prompts: the streams and every step's TELEMETRY
    counters equal the JAX engine's in the same mode."""
    engine = ServeEngine(_params(golden, SCHEDULE_CASE), tiny_config(SCHEDULE_CASE),
                         device="cpu", **ENGINE_KW, **mode_kwargs(mode))
    tokens, telemetry = trace_engine(engine, schedule_requests())
    want = f"schedule/{mode_key(mode)}/"
    np.testing.assert_array_equal(tokens, golden[want + "tokens"])
    np.testing.assert_array_equal(telemetry, golden[want + "telemetry"])
    assert engine.ctrl.used_pages == 0 and engine._committed_pages == 0


def test_schedule_goldens_cover_what_the_modes_do(golden):
    """The frozen runs exercise each mode's mechanism: supersteps with
    over-decode, budget deferral, serial readbacks per admission."""
    def last(mode, name):
        return golden[f"schedule/{mode_key(mode)}/telemetry"][-1][TELEMETRY.index(name)]

    assert last((4, True, None, True), "supersteps_run") > 0
    assert last((4, True, None, True), "tokens_overdecoded") > 0
    assert last((1, False, 12, True), "prefill_deferred_tokens") > 0
    assert last((1, False, None, False), "admission_readbacks") == 6
    assert last((1, False, None, True), "admission_readbacks") < 6


# ---- the JAX package's contracts, ported ---------------------------------

CONFIG = ModelConfig(max_seq_len=64, n_layers=2, dtype=torch.float32)
STREAMS = [([3, 1, 4, 1, 5], 17), ([2, 7], 9), ([9] * 11, 13)]


@pytest.fixture(scope="module")
def params():
    return init_params(CONFIG, torch.Generator().manual_seed(0))


def _engine(params, **kw):
    kw = {"slots": 2, "page_size": 4, "prompt_bucket": 8, **kw}
    return ServeEngine(params, CONFIG, device="cpu", **kw)


def _ref(params, prompt, new):
    return generate(params, torch.tensor([prompt]), CONFIG, new, device="cpu")[0].tolist()


def _hygiene(engine):
    """No slot, page, commitment or mid-prefill admission left over."""
    assert not engine._occupied.any()
    assert engine._committed_pages == 0
    assert not engine._inflight_prefill
    assert engine.ctrl.used_pages == 0
    assert engine.idle


def test_superstep_fewer_steps_same_tokens(params):
    """One host readback per k chunks: k=4 drains the same stream in
    fewer step() calls than k=1, with generate()'s tokens."""
    ref = _ref(params, [5, 2, 9], 33)
    steps = {}
    for k in (1, 4):
        engine = _engine(params, slots=1, superstep_k=k)
        rid = engine.submit([5, 2, 9], 33)
        n_steps, served = 0, {}
        while not engine.idle:
            for req in engine.step():
                served[req.rid] = req.tokens
            n_steps += 1
        steps[k] = n_steps
        assert served[rid] == ref, k
    assert steps[4] < steps[1], steps


def test_superstep_device_mask_stops_emission_at_eos(params):
    """The retirement mask freezes a row the step it emits eos: the
    stream ends exactly at the eos token and the frozen rest counts as
    over-decode."""
    prompt = [4, 4, 8]
    full = _ref(params, prompt, 20)
    eos = full[6]
    engine = _engine(params, superstep_k=3)
    rid = engine.submit(prompt, 20, eos_token=eos)
    got = engine.run()[rid]
    assert got == full[: full.index(eos) + 1]
    assert engine.tokens_overdecoded > 0
    _hygiene(engine)


def test_superstep_overdecode_bounded_and_reconciled(params):
    """Over-decode is under one superstep per retiring row, and every
    occupied lane-step of a dispatch is an emitted token or over-decode."""
    k, chunk = 3, 4
    engine = _engine(params, chunk=chunk, superstep_k=k)
    rids = [engine.submit(p, n) for p, n in STREAMS]
    served = engine.run()
    span = k * chunk
    assert 0 < engine.tokens_overdecoded <= len(STREAMS) * span
    emitted_decode = sum(len(served[r]) for r in rids) - len(rids)
    assert emitted_decode + engine.tokens_overdecoded <= (
        engine.supersteps_run * span * engine.slots)
    _hygiene(engine)


@pytest.mark.parametrize("pipelined", [False, True], ids=["plain", "pipelined"])
def test_superstep_page_precommit_never_faults(params, pipelined):
    """A pool sized exactly to one request's commitment serves a request
    that ends at max_seq_len: pre-commitment stays inside it, and the
    table-column clamp never sends a write into a live page."""
    new = CONFIG.max_seq_len - 3
    probe = _engine(params, slots=1, superstep_k=4, pipelined=pipelined)
    tight = _engine(params, slots=1, superstep_k=4, pipelined=pipelined,
                    n_pages=probe._worst_case_pages(3, new))
    rid = tight.submit([5, 2, 9], new)
    assert tight.run()[rid] == _ref(params, [5, 2, 9], new)
    _hygiene(tight)


def test_pipelined_chunk_full_length_request(params):
    """Pipelined chunks, a request of the full context window with
    (max_new - 1) % chunk == 1, so the dead pipelined chunk lands at the
    window's edge: per-dispatch extension is one chunk past the
    position, and only the commitment carries the pipelined overshoot."""
    engine = ServeEngine(params, CONFIG, slots=1, page_size=16, prompt_bucket=16, chunk=16,
                         pipelined=True, device="cpu")
    prompt = list(range(1, 15))  # 14 + 50 == max_seq_len
    rid = engine.submit(prompt, 50)
    assert engine.run()[rid] == _ref(params, prompt, 50)
    _hygiene(engine)


def test_close_reclaims_superstep_and_prefill_in_flight(params):
    """close() with a pipelined superstep in flight and an admission
    parked mid-prefill: every request fails, every page comes back."""
    engine = _engine(params, superstep_k=3, pipelined=True, prefill_budget=8)
    running = engine.submit([5, 5], 40)
    engine.step()
    engine.step()
    assert engine._pending_super
    parked = engine.submit(list(range(1, 31)), 4)
    engine.step()
    assert engine._inflight_prefill
    engine.close()
    statuses = {r.rid: r.status for r in engine.completed}
    assert statuses == {running: "failed", parked: "failed"}
    assert not engine._pending_super
    _hygiene(engine)


def test_budget_bounds_chunk_dispatches_per_step(params):
    """At most max(1, budget // prompt_bucket) prefill dispatches a step,
    however much prefill is queued."""
    rng = np.random.default_rng(9)
    long = [int(t) for t in rng.integers(0, 256, 30)]
    for budget, per_step in ((8, 1), (16, 2), (1, 1)):
        engine = _engine(params, prefill_budget=budget)
        for _ in range(2):
            engine.submit(long, 4)
        while not engine.idle:
            before = engine.prefill_dispatches
            engine.step()
            assert engine.prefill_dispatches - before <= per_step, budget
        _hygiene(engine)


def test_budget_interleaves_decode_with_parked_prefill(params):
    """While a long admission sits parked mid-prefill, occupied slots
    keep decoding."""
    rng = np.random.default_rng(4)
    long = [int(t) for t in rng.integers(0, 256, 30)]
    short = [int(t) for t in rng.integers(0, 256, 3)]
    engine = _engine(params, prefill_budget=8)
    engine.submit(short, 20)
    engine.step()
    engine.submit(long, 4)
    interleaved = 0
    while not engine.idle:
        before = engine.chunks_run
        engine.step()
        if engine._inflight_prefill and engine.chunks_run > before:
            interleaved += 1
    assert interleaved > 0
    assert engine.prefill_deferred_tokens > 0
    _hygiene(engine)


def _mixed_requests(n, rng_seed, p_lo=3, p_hi=11):
    rng = np.random.default_rng(rng_seed)
    return [([int(t) for t in rng.integers(0, 256, int(rng.integers(p_lo, p_hi)))],
             int(rng.integers(2, 25))) for _ in range(n)]


@pytest.mark.parametrize(
    "requests, kw",
    [
        (_mixed_requests(7, 3, 3, 20), dict(slots=3, chunk=4)),
        (_mixed_requests(6, 31), dict(prompt_bucket=12, chunk=4, pipelined=True)),
    ],
    ids=["mixed-lengths", "pipelined"],
)
def test_batched_matches_serial(params, requests, kw):
    """Serial and batched admission emit the same greedy streams; the
    batched engine reads first tokens back fewer times."""
    outs, engines = [], []
    for batched in (False, True):
        engine = _engine(params, batched_admission=batched, **kw)
        rids = [engine.submit(p, n) for p, n in requests]
        served = engine.run()
        outs.append([served[r] for r in rids])
        engines.append(engine)
        _hygiene(engine)
    assert outs[0] == outs[1]
    serial, batched = engines
    assert serial.prefill_tokens == batched.prefill_tokens
    assert serial.prefills_run == batched.prefills_run == len(requests)
    assert batched.admission_readbacks < serial.admission_readbacks == len(requests)


def test_engine_pools_keep_their_storage(params):
    """Every prefill, decode dispatch and superstep updates the pools in
    place: a captured graph holds their addresses."""
    engine = _engine(params, superstep_k=2, pipelined=True, prefill_budget=8)
    ptrs = [p.data_ptr() for p in engine.pools]
    pools = engine.pools
    for p, n in STREAMS:
        engine.submit(p, n)
    while not engine.idle:
        engine.step()
        assert engine.pools is pools and [p.data_ptr() for p in pools] == ptrs


def test_sampled_superstep_stream_is_seeded(params):
    def run(seed):
        engine = _engine(params, superstep_k=2, pipelined=True, temperature=0.8, top_k=40,
                         generator=torch.Generator().manual_seed(seed))
        rids = [engine.submit([1 + i, 2], 10) for i in range(4)]
        served = engine.run()
        _hygiene(engine)
        return [served[r] for r in rids]

    first = run(5)
    assert all(len(s) == 10 and all(0 <= t < 256 for t in s) for s in first)
    assert run(5) == first


def test_scheduling_validations(params):
    with pytest.raises(ValueError, match="superstep_k"):
        _engine(params, superstep_k=0)
    with pytest.raises(ValueError, match="prefill_budget"):
        _engine(params, prefill_budget=0)
    # A rid parked mid-prefill is still in flight.
    engine = _engine(params, prefill_budget=8)
    long = list(range(1, 31))
    rid = engine.submit(long, 6)
    engine.step()
    assert engine._inflight_prefill
    with pytest.raises(InvalidRequest, match="already in flight"):
        engine.submit(long, 2, rid=rid)
    engine.run()
    _hygiene(engine)


def test_cli_scheduling_flags_on_cpu(capsys):
    assert main([
        "--requests", "3", "--slots", "2", "--prompt-len", "20", "--max-new-tokens", "8",
        "--superstep-k", "2", "--pipelined", "--prefill-budget", "16",
        "--temperature", "0", "--device", "cpu",
    ]) == 0
    out = capsys.readouterr().out
    assert "pages in use after drain: 0" in out and "supersteps" in out
