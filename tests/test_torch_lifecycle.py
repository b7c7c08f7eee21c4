"""The port's request lifecycle (workloads_torch.serve: cancel, withdraw,
preempt, deadlines, fault quarantine and replay, the health bridge,
retune, close) on the CPU.

torch, numpy, the port and the jax-free daemon modules
(``tpu_device_plugin.device``, ``tpu_device_plugin.api.constants``)
only, so it runs in the fast tier.  Two parts:

* scripted, clock-free scenarios (``LIFECYCLE_SCENARIOS``) on the
  multi-chunk stream of tests/test_torch_schedule.py, whose float32
  streams, terminal statuses and per-step counters (``TELEMETRY`` and
  ``LIFECYCLE``) were frozen from the JAX engine in the same mode
  (tests/test_torch_lifecycle_golden.npz, written by
  ``python tests/test_torch_parity.py --write-goldens``): a fault at each
  of the four engine seams in all 24 scheduling modes, and cancel,
  withdraw and preempt, health events, a retune walk and retry
  exhaustion at fixed steps in the four decode modes (superstep_k 1/2 x
  pipelined);
* the JAX package's lifecycle contracts, ported (its
  tests/test_serve_lifecycle.py, test_superstep.py, the solo cases of
  test_chunked_prefill.py and the superstep_k retunes of
  test_control.py).
"""

from __future__ import annotations

import itertools
import os
import queue
import re
import time

import numpy as np
import pytest
import torch

from tests.test_torch_golden import engine_array, tiny_config
from tests.test_torch_schedule import (
    ENGINE_KW,
    SCHEDULE_CASE,
    SCHEDULE_MODES,
    TELEMETRY,
    _params,
    golden,  # noqa: F401
    mode_key,
    mode_kwargs,
    schedule_requests,
)
from tests.test_torch_superstep import one_torch_thread  # noqa: F401
from tpu_device_plugin.api.constants import HEALTHY
from tpu_device_plugin.api.constants import UNHEALTHY as DAEMON_UNHEALTHY
from tpu_device_plugin.device import HealthEvent
from workloads_torch import prng
from workloads_torch import (
    EngineClosed,
    InvalidRequest,
    QueueFull,
    RequestTooLarge,
    ServeError,
)
from workloads_torch import faults
from workloads_torch.faults import ENGINE_SEAMS, FaultInjector, InjectedFault
from workloads_torch.generate import generate
from workloads_torch.model import ModelConfig, init_params
from workloads_torch.serve import UNHEALTHY, ServeEngine, main

LIFECYCLE_GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "test_torch_lifecycle_golden.npz")
LIFECYCLE = (
    "steps_quarantined", "requests_retried", "tokens_replayed", "requests_cancelled",
    "requests_expired", "requests_failed", "requests_preempted", "preempt_recompute_tokens",
    "retunes", "requests_retired", "generated_tokens",
)
# The seams the port crosses, and the crossing each fires on in the
# 24-mode scenario: the second admission sweep and the third decode
# dispatch and readback, mid-drain in every mode.
SEAM_CROSSING = {"prefill_dispatch": 2, "prefill_readback": 2, "decode_dispatch": 3,
                 "decode_readback": 3}
# (superstep_k, pipelined) with batched, unbudgeted admission.
DECODE_MODES = list(itertools.product((1, 2), (False, True)))
# Actions at fixed steps, by request index: taken before that step().
LIFECYCLE_SCENARIOS = {
    "cancel": {1: [("cancel", 5)], 2: [("cancel", 0)], 4: [("cancel", 2)]},
    "withdraw_preempt": {1: [("withdraw", 4)], 2: [("preempt", 1), ("preempt", 5)],
                         4: [("preempt", 2)]},
    "health": {2: [("health", ("chip-0", UNHEALTHY))], 3: [("health", ("", UNHEALTHY))],
               4: [("health", ("chip-0", HEALTHY))], 5: [("health", ("", HEALTHY))]},
    "retune": {1: [("retune", 1)], 3: [("retune", 2)], 5: [("retune", 1)], 7: [("retune", 2)]},
    "exhaust": {},
}


def decode_mode(k: int, piped: bool) -> tuple:
    return (k, piped, None, True)


def lifecycle_trace(engine, requests, script, k_max: int, health=None):
    """Submit every request, step to idle taking ``script``'s actions
    before their steps (health events go on ``health``), and return
    (streams as ``engine_array``, the TELEMETRY and LIFECYCLE counters
    after each step, each request's terminal status, or "withdrawn" /
    "preempted" for one handed back); works on the JAX engine and the
    port's alike."""
    rids = [engine.submit(p, n) for p, n in requests]
    served, taken, rows, step = {}, {}, [], 0
    while not engine.idle:
        for action, arg in script.get(step, ()):
            if action == "cancel":
                engine.cancel(rids[arg])
            elif action in ("withdraw", "preempt"):
                got = getattr(engine, action)(rids[arg])
                if got is not None:
                    taken[got.rid] = {"withdraw": "withdrawn", "preempt": "preempted"}[action]
                    served[got.rid] = list(got.tokens)
            elif action == "health":
                health.put(HealthEvent(chip_id=arg[0], health=arg[1], code=2))
            elif action == "retune":
                engine.retune(superstep_k=min(arg, k_max))
        for req in engine.step():
            served[req.rid] = req.tokens
        rows.append([getattr(engine, n) for n in TELEMETRY + LIFECYCLE])
        step += 1
    statuses = {r.rid: r.status for r in engine.completed}
    return (engine_array([served.get(r, []) for r in rids]), np.asarray(rows, np.int64),
            np.asarray([taken.get(r) or statuses.get(r, "live") for r in rids]))


def golden_runs():
    """(key, mode, scenario) of every frozen run: ``fault_<seam>`` in the
    24 modes, the other scenarios in the four decode modes."""
    runs = [(f"fault_{s}/{mode_key(m)}", m, f"fault_{s}")
            for s in SEAM_CROSSING for m in SCHEDULE_MODES]
    runs += [(f"{name}/{mode_key(decode_mode(*dm))}", decode_mode(*dm), name)
             for name in LIFECYCLE_SCENARIOS for dm in DECODE_MODES]
    return runs


def run_scenario(make_engine, mode, scenario: str):
    """One frozen run on either engine (``make_engine(**kwargs)`` builds
    it): (tokens, counters, statuses, the seams that fired)."""
    script, kw = LIFECYCLE_SCENARIOS.get(scenario, {}), {}
    if scenario.startswith("fault_"):
        seam = scenario[len("fault_"):]
        kw["fault_injector"] = FaultInjector({seam: [SEAM_CROSSING[seam]]})
    elif scenario == "exhaust":
        kw["fault_injector"] = FaultInjector({"decode_dispatch": range(1, 100)})
    elif scenario == "health":
        kw["health_events"] = queue.Queue()
    engine = make_engine(**ENGINE_KW, **mode_kwargs(mode), **kw)
    tokens, counters, statuses = lifecycle_trace(
        engine, schedule_requests(), script, mode[0], kw.get("health_events"))
    assert engine.ctrl.used_pages == 0 and engine._committed_pages == 0
    injector = kw.get("fault_injector")
    return tokens, counters, statuses, injector.fired if injector is not None else []


@pytest.fixture(scope="module")
def lgolden():
    with np.load(LIFECYCLE_GOLDEN) as f:
        return {k: f[k] for k in f.files}


_RUNS = golden_runs()


@pytest.mark.parametrize("key, mode, scenario", _RUNS, ids=[r[0] for r in _RUNS])
def test_lifecycle_matches_jax_step_by_step(golden, lgolden, key, mode, scenario):  # noqa: F811
    """The port's streams, terminal statuses and every step's counters
    equal the JAX engine's in the same mode and scenario; a seam fault
    fires exactly once."""
    params, config = _params(golden, SCHEDULE_CASE), tiny_config(SCHEDULE_CASE)
    tokens, counters, statuses, fired = run_scenario(
        lambda **kw: ServeEngine(params, config, device="cpu", **kw), mode, scenario)
    if scenario.startswith("fault_"):
        assert [r.seam for r in fired] == [scenario[len("fault_"):]]
    np.testing.assert_array_equal(tokens, lgolden[f"{key}/tokens"])
    np.testing.assert_array_equal(statuses, lgolden[f"{key}/statuses"])
    np.testing.assert_array_equal(counters, lgolden[f"{key}/counters"])


def test_lifecycle_goldens_cover_what_the_scenarios_do(golden, lgolden):  # noqa: F811
    """The frozen runs exercise each mechanism: a replay after every seam
    fault with the fault-free stream, every reclaim, a pause, a retune
    walk and retry exhaustion."""
    def last(key, name):
        return lgolden[f"{key}/counters"][-1][(TELEMETRY + LIFECYCLE).index(name)]

    clean = golden["schedule/k1_plain_unbudgeted_batched/tokens"]
    for seam in SEAM_CROSSING:
        for mode in SCHEDULE_MODES:
            key = f"fault_{seam}/{mode_key(mode)}"
            assert last(key, "steps_quarantined") == 1, key
            assert last(key, "tokens_replayed") > 0, key
            assert set(lgolden[f"{key}/statuses"]) == {"ok"}, key
            np.testing.assert_array_equal(lgolden[f"{key}/tokens"], clean, err_msg=key)
    for k, piped in DECODE_MODES:
        mk = mode_key(decode_mode(k, piped))
        assert list(lgolden[f"cancel/{mk}/statuses"]).count("cancelled") == 3
        assert {"withdrawn", "preempted"} <= set(lgolden[f"withdraw_preempt/{mk}/statuses"])
        assert last(f"withdraw_preempt/{mk}", "preempt_recompute_tokens") > 0
        assert last(f"health/{mk}", "requests_retried") > 0
        assert last(f"health/{mk}", "steps_quarantined") == 1
        np.testing.assert_array_equal(lgolden[f"health/{mk}/tokens"], clean)
        np.testing.assert_array_equal(lgolden[f"retune/{mk}/tokens"], clean)
        assert last(f"retune/{mk}", "retunes") == (4 if k == 2 else 0)
        assert "failed" in set(lgolden[f"exhaust/{mk}/statuses"])


# ---- the JAX package's lifecycle contracts, ported ------------------------

CONFIG = ModelConfig(max_seq_len=64, n_layers=2, dtype=torch.float32)
PROMPT = [1, 2, 3, 4, 5, 6, 7]
STREAMS = [([3, 1, 4, 1, 5], 17), ([2, 7], 9), ([9] * 11, 13)]


@pytest.fixture(scope="module")
def params():
    return init_params(CONFIG, prng.PRNGKey(0, device="cpu"))


def _engine(params, **kw):
    kw = {"slots": 2, "page_size": 4, "prompt_bucket": 8, **kw}
    return ServeEngine(params, CONFIG, device="cpu", **kw)


def _ref(params, prompt, new):
    return generate(params, torch.tensor([prompt]), CONFIG, new, device="cpu")[0].tolist()


def _statuses(engine):
    return {r.rid: r.status for r in engine.completed}


def _hygiene(engine):
    assert not engine._occupied.any()
    assert engine._committed_pages == 0
    assert not engine._inflight_prefill
    assert engine.ctrl.used_pages == 0
    assert engine.idle


def _park_one(params, **kw):
    """An engine with one long admission parked mid-prefill."""
    rng = np.random.default_rng(8)
    long = [int(t) for t in rng.integers(0, CONFIG.vocab_size, 30)]
    engine = _engine(params, prefill_budget=8, **kw)
    rid = engine.submit(long, 6)
    engine.step()
    assert engine._inflight_prefill
    return engine, rid, long


def test_error_taxonomy_types_and_messages(params):
    engine = _engine(params)
    with pytest.raises(RequestTooLarge, match="prompt length"):
        engine.submit([])
    with pytest.raises(ValueError, match="prompt length"):
        engine.submit([1] * CONFIG.max_seq_len)
    with pytest.raises(RequestTooLarge, match="exceeds max_seq_len"):
        engine.submit(PROMPT, CONFIG.max_seq_len)
    small = _engine(params, slots=1, n_pages=2)
    with pytest.raises(RequestTooLarge, match="never be admitted"):
        small.submit(PROMPT, 40)
    with pytest.raises(InvalidRequest, match="max_new_tokens"):
        engine.submit(PROMPT, 0)
    with pytest.raises(InvalidRequest, match="deadline_s"):
        engine.submit(PROMPT, 2, deadline_s=0)
    engine.submit(PROMPT, 2, rid="dup")
    with pytest.raises(InvalidRequest, match="already in flight"):
        engine.submit(PROMPT, 2, rid="dup")
    for exc in (InvalidRequest, RequestTooLarge, QueueFull, EngineClosed):
        assert issubclass(exc, ServeError)
    assert issubclass(RequestTooLarge, InvalidRequest)
    with pytest.raises(ValueError, match="max_retries"):
        _engine(params, max_retries=-1)
    with pytest.raises(ValueError, match="retry_backoff_s"):
        _engine(params, retry_backoff_s=-1.0)
    engine.run()


def test_queue_full_is_typed_and_counted(params):
    engine = _engine(params, slots=1, max_pending=2)
    engine.submit(PROMPT, 2)
    engine.submit(PROMPT, 2)
    with pytest.raises(QueueFull) as exc_info:
        engine.submit(PROMPT, 2)
    assert exc_info.value.request.status == "rejected"
    assert engine.queue_rejections == 1
    assert len(engine.run()) == 2
    assert set(_statuses(engine).values()) == {"ok"}


def test_cancel_queued_and_running(params):
    engine = _engine(params, slots=1, pipelined=True)
    r1 = engine.submit(PROMPT, 20)
    r2 = engine.submit(PROMPT, 20)
    engine.step()
    engine.step()
    assert engine.cancel(r2) is True  # still queued: never admitted
    assert engine.cancel(r1) is True  # running: drained, slot recycled
    assert engine.cancel(r1) is False  # already terminal
    assert engine.cancel("ghost") is False
    out = engine.run()
    assert _statuses(engine) == {r1: "cancelled", r2: "cancelled"}
    by_rid = {r.rid: r for r in engine.completed}
    assert by_rid[r2].tokens == [] and by_rid[r2].t_admit is None
    assert by_rid[r1].tokens == _ref(params, PROMPT, 20)[: len(by_rid[r1].tokens)]
    assert set(out) == {r1, r2}
    assert engine.requests_cancelled == 2
    _hygiene(engine)


def test_deadline_expires_queued_and_running(params):
    engine = _engine(params, slots=1)
    ra = engine.submit(PROMPT, 30)
    rb = engine.submit(PROMPT, 30, deadline_s=0.001)  # starves in the queue
    time.sleep(0.01)
    engine.run()
    assert _statuses(engine) == {ra: "ok", rb: "expired"}
    assert engine.requests_expired == 1

    engine2 = _engine(params, slots=1, pipelined=True)
    rc = engine2.submit(PROMPT, 40, deadline_s=0.05)
    t0 = time.perf_counter()
    while not engine2.idle and time.perf_counter() - t0 < 30:
        engine2.step()
    status = _statuses(engine2)[rc]
    # A fast host may finish all 40 tokens inside the deadline; either way
    # the status is single and everything drains.
    assert status in ("ok", "expired")
    if status == "expired":
        got = next(iter(engine2.completed)).tokens
        assert got == _ref(params, PROMPT, 40)[: len(got)]
    _hygiene(engine2)


def test_close_fails_inflight_and_is_idempotent(params):
    engine = _engine(params, slots=1)
    r1 = engine.submit(PROMPT, 30)
    r2 = engine.submit(PROMPT, 30)
    engine.step()
    engine.close()
    engine.close()
    assert engine.closed and engine.idle
    sts = {r.rid: (r.status, r.error) for r in engine.completed}
    for rid in (r1, r2):
        assert sts[rid][0] == "failed" and "EngineClosed" in sts[rid][1]
    assert engine.requests_failed == 2
    _hygiene(engine)
    with pytest.raises(EngineClosed):
        engine.submit(PROMPT, 2)
    with pytest.raises(EngineClosed):
        engine.step()
    for call in (engine.cancel, engine.withdraw, engine.preempt):
        with pytest.raises(EngineClosed):
            call(r1)
    with pytest.raises(EngineClosed):
        engine.retune(superstep_k=1)


def test_close_clears_the_finished_buffer(params):
    """A cancel's record waits for the next step(); close() must not
    leave it there, or the closed engine never reads idle."""
    engine = _engine(params, slots=1)
    rid = engine.submit(PROMPT, 30)
    engine.step()
    assert engine.cancel(rid) and not engine.idle
    engine.close()
    assert engine.idle and _statuses(engine) == {rid: "cancelled"}


def test_context_manager_closes(params):
    with _engine(params) as engine:
        rid = engine.submit(PROMPT, 4)
        engine.run()
        parked = engine.submit(PROMPT, 30)
        engine.step()
    assert engine.closed
    assert _statuses(engine) == {rid: "ok", parked: "failed"}
    _hygiene(engine)


@pytest.mark.parametrize("kw", [{}, {"pipelined": True}, {"superstep_k": 2},
                                {"superstep_k": 2, "pipelined": True},
                                {"batched_admission": False}, {"prefill_budget": 8}],
                         ids=["defaults", "pipelined", "k2", "k2-pipelined", "serial", "budget"])
def test_fault_replay_is_bit_identical_per_seam(params, kw):
    ref = _ref(params, PROMPT, 12)
    baseline = None
    for seam, crossing in (("prefill_dispatch", 1), ("prefill_readback", 1),
                           ("decode_dispatch", 2), ("decode_readback", 2)):
        engine = _engine(params, fault_injector=FaultInjector({seam: [crossing]}), **kw)
        r1 = engine.submit(PROMPT, 12)
        r2 = engine.submit(PROMPT[:3], 8)
        out = engine.run()
        assert out[r1] == ref, (seam, out[r1])
        baseline = baseline or out
        assert out == baseline, seam
        assert engine.steps_quarantined == 1, seam
        assert len(engine.fault_recovery_s) == 1, seam
        assert set(_statuses(engine).values()) == {"ok"}, seam
        assert engine.requests_retried >= 1 and engine.tokens_replayed > 0, seam
        _hygiene(engine)


def test_retry_budget_exhaustion_fails_terminally(params):
    engine = _engine(params, slots=1, max_retries=2,
                     fault_injector=FaultInjector({"decode_dispatch": list(range(1, 20))}))
    rid = engine.submit(PROMPT, 12)
    engine.run()
    req = {r.rid: r for r in engine.completed}[rid]
    assert req.status == "failed"
    assert req.retries == 3  # the budget and the final straw
    assert "InjectedFault" in req.error
    assert engine.requests_failed == 1
    _hygiene(engine)


def test_retry_backoff_doubles_until_a_good_readback(params):
    """``retry_backoff_s`` doubles with each fault in a row; a good
    readback resets the ladder and closes one recovery window."""
    engine = _engine(params, slots=1, max_retries=3, retry_backoff_s=0.01,
                     fault_injector=FaultInjector({"prefill_dispatch": [1, 2, 3]}))
    rid = engine.submit(PROMPT, 4)
    t0 = time.perf_counter()
    assert engine.run()[rid] == _ref(params, PROMPT, 4)
    assert time.perf_counter() - t0 >= 0.01 + 0.02 + 0.04
    assert engine.steps_quarantined == 3 and len(engine.fault_recovery_s) == 1
    assert engine._consecutive_faults == 0
    _hygiene(engine)


def test_injector_seams_are_exactly_the_seams_the_port_crosses():
    """Every seam the port's serve.py crosses is an engine seam of the
    copied injector, and every engine seam is crossed (speculation's
    since it was ported)."""
    src = open(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                            "workloads_torch", "serve.py"), encoding="utf-8").read()
    crossed = set(re.findall(r'_maybe_fault\("([a-z_]+)"\)', src))
    assert crossed == set(ENGINE_SEAMS)


def test_injected_fault_carries_seam_and_crossing():
    inj = FaultInjector({"decode_readback": 1})
    with pytest.raises(InjectedFault) as exc_info:
        inj.check("decode_readback")
    assert (exc_info.value.seam, exc_info.value.crossing) == ("decode_readback", 1)
    assert faults.self_check(verbose=False) == 0


def test_health_constant_is_the_daemons():
    assert UNHEALTHY == DAEMON_UNHEALTHY


def test_health_bridge_pauses_requeues_and_resumes(params):
    q = queue.Queue()
    engine = _engine(params, health_events=q, pipelined=True)
    rid = engine.submit(PROMPT, 12)
    engine.step()
    engine.step()
    q.put(HealthEvent(chip_id="chip-0", health=DAEMON_UNHEALTHY, code=2))
    engine.step()
    assert engine.paused
    assert not engine._occupied.any()  # the work in flight requeued
    assert engine.pending and engine.pending[0].rid == rid
    assert engine.pending[0].retries == 0  # no retry-budget charge
    engine.step()  # held: no admission
    assert not engine._occupied.any()
    q.put(HealthEvent(chip_id="chip-1", health=DAEMON_UNHEALTHY, code=0))
    engine.step()
    assert engine.paused
    q.put(HealthEvent(chip_id="chip-0", health=HEALTHY, code=2))
    engine.step()
    assert engine.paused  # chip-1 still down
    q.put(HealthEvent(chip_id="chip-1", health=HEALTHY, code=0))
    out = engine.run()
    assert not engine.paused
    assert out[rid] == _ref(params, PROMPT, 12)
    assert _statuses(engine)[rid] == "ok"
    assert engine.requests_retried >= 1
    _hygiene(engine)


def test_health_unattributed_events_mix_with_per_chip(params):
    """chip_id "" speaks for every chip: an unattributed all-clear lifts
    every mark, and only it lifts an unattributed fault."""
    q = queue.Queue()
    engine = _engine(params, health_events=q)
    rid = engine.submit(PROMPT, 8)
    q.put(HealthEvent(chip_id="chip-0", health=DAEMON_UNHEALTHY, code=2))
    engine.step()
    assert engine.paused
    q.put(HealthEvent(chip_id="", health=HEALTHY))
    engine.step()
    assert not engine.paused
    q.put(HealthEvent(chip_id="", health=DAEMON_UNHEALTHY, code=2))
    engine.step()
    assert engine.paused
    q.put(HealthEvent(chip_id="chip-0", health=HEALTHY, code=2))
    engine.step()
    assert engine.paused
    q.put(HealthEvent(chip_id="", health=HEALTHY))
    out = engine.run()
    assert not engine.paused
    assert out[rid] == _ref(params, PROMPT, 8)
    assert _statuses(engine)[rid] == "ok"


def test_bind_health_subscribes_and_close_unsubscribes(params):
    class FakeFanout:
        def __init__(self):
            self.q = queue.Queue()
            self.unsubscribed = None

        def subscribe(self):
            return self.q

        def unsubscribe(self, q):
            self.unsubscribed = q

    fanout = FakeFanout()
    engine = _engine(params)
    engine.bind_health(fanout)
    with pytest.raises(RuntimeError, match="already bound"):
        engine.bind_health(fanout)
    rid = engine.submit(PROMPT, 4)
    engine.run()
    engine.close()
    assert fanout.unsubscribed is fanout.q
    assert _statuses(engine)[rid] == "ok"


def test_withdraw_takes_only_queued_requests(params):
    engine = _engine(params, slots=1)
    r1 = engine.submit(PROMPT, 12)
    r2 = engine.submit(PROMPT, 12)
    engine.step()
    assert engine.withdraw(r1) is None  # running: cancel or preempt reach it
    got = engine.withdraw(r2)
    assert got.rid == r2 and got.status == "queued" and got.tokens == []
    assert engine.withdraw(r2) is None
    engine.run()
    assert _statuses(engine) == {r1: "ok"}
    assert engine.requests_preempted == 0
    _hygiene(engine)


@pytest.mark.parametrize("kw", [{}, {"pipelined": True}, {"superstep_k": 2, "pipelined": True}],
                         ids=["defaults", "pipelined", "k2-pipelined"])
def test_preempt_running_hands_back_a_replayable_request(params, kw):
    """A preempted running request leaves with its stream complete so
    far, no terminal status and its pages back; resubmitted as prompt +
    emitted, its greedy continuation completes the uninterrupted stream."""
    engine = _engine(params, **kw)
    rid = engine.submit(PROMPT, 20)
    for _ in range(3):
        engine.step()
    got = engine.preempt(rid)
    assert got is not None and got.rid == rid and got.status == "running"
    assert 0 < len(got.tokens) < 20
    assert engine.requests_preempted == 1
    assert engine.preempt_recompute_tokens == len(PROMPT) + len(got.tokens)
    assert engine.preempt(rid) is None
    ref = _ref(params, PROMPT, 20)
    assert got.tokens == ref[: len(got.tokens)]
    rest = engine.submit(PROMPT + got.tokens, 20 - len(got.tokens))
    assert got.tokens + engine.run()[rest] == ref
    _hygiene(engine)


def test_preempt_queued_and_mid_prefill(params):
    engine, rid, long = _park_one(params)
    queued = engine.submit(PROMPT, 4)
    assert engine.preempt(queued).tokens == []
    got = engine.preempt(rid)
    assert got.rid == rid and not engine._inflight_prefill
    # One budgeted chunk was swept: the resume recomputes it.
    assert engine.preempt_recompute_tokens == 8
    assert engine.requests_preempted == 2
    assert engine.run() == {}
    _hygiene(engine)


# ---- supersteps: reclaims and quarantine ----------------------------------


def test_superstep_cancel_and_deadline_reclaim(params):
    engine = _engine(params, superstep_k=2, pipelined=True)
    r1 = engine.submit([3, 1, 4], 30)
    r2 = engine.submit([2, 7], 30)
    engine.step()
    engine.step()  # a superstep is in flight
    assert engine._pending_super
    assert engine.cancel(r1)
    served = engine.run()
    statuses = _statuses(engine)
    assert statuses[r1] == "cancelled" and statuses[r2] == "ok"
    assert served[r1] == _ref(params, [3, 1, 4], 30)[: len(served[r1])]
    assert served[r2] == _ref(params, [2, 7], 30)
    _hygiene(engine)

    engine = _engine(params, slots=1, superstep_k=2)
    rd = engine.submit([1, 2, 3], 40, deadline_s=0.05)
    engine.step()
    time.sleep(0.08)
    engine.run()
    assert _statuses(engine)[rd] == "expired"
    _hygiene(engine)


@pytest.mark.parametrize("pipelined", [False, True], ids=["plain", "pipelined"])
@pytest.mark.parametrize("seam", ["decode_dispatch", "decode_readback"])
def test_superstep_quarantine_drops_and_replays_bit_identical(params, seam, pipelined):
    """A seam fault mid-superstep drops the whole superstep in flight and
    the replays resume bit-identically."""
    engine = _engine(params, superstep_k=2, pipelined=pipelined,
                     fault_injector=FaultInjector({seam: [2]}), max_retries=2)
    rids = [engine.submit(p, n) for p, n in STREAMS]
    served = engine.run()
    for rid, (p, n) in zip(rids, STREAMS):
        assert served[rid] == _ref(params, p, n), (seam, pipelined)
    assert engine.steps_quarantined == 1
    assert not engine._pending_super
    _hygiene(engine)


def test_health_pause_in_the_overlap_window_drops_the_superstep(params):
    """An unhealthy event read by the superstep loop's second poll, while
    the new superstep is in flight, drops it and requeues its rows."""
    q = queue.Queue()
    engine = _engine(params, superstep_k=2, pipelined=True, health_events=q)
    rid = engine.submit(PROMPT, 30)
    engine.step()
    poll = engine._poll_health
    calls = []

    def poll_once_more():
        calls.append(bool(engine._pending_super))
        if len(calls) == 2:  # the overlap window's poll
            q.put(HealthEvent(chip_id="chip-0", health=DAEMON_UNHEALTHY, code=2))
        return poll()

    engine._poll_health = poll_once_more
    engine.step()
    assert calls == [False, True] and engine.paused and not engine._pending_super
    engine._poll_health = poll
    q.put(HealthEvent(chip_id="chip-0", health=HEALTHY, code=2))
    assert engine.run()[rid] == _ref(params, PROMPT, 30)
    _hygiene(engine)


# ---- budgeted prefill: the solo reclaim cases -----------------------------


def test_cancel_mid_prefill_reclaims(params):
    engine, rid, _ = _park_one(params)
    assert engine.cancel(rid)
    assert not engine._inflight_prefill
    engine.run()
    assert _statuses(engine)[rid] == "cancelled"
    _hygiene(engine)


def test_deadline_mid_prefill_expires(params):
    rng = np.random.default_rng(13)
    long = [int(t) for t in rng.integers(0, CONFIG.vocab_size, 30)]
    engine = _engine(params, prefill_budget=8)
    rid = engine.submit(long, 6, deadline_s=0.001)
    engine.step()
    time.sleep(0.01)
    engine.run()
    assert _statuses(engine)[rid] == "expired"
    _hygiene(engine)


def _mixed_requests(n, rng_seed, p_lo=2, p_hi=31):
    rng = np.random.default_rng(rng_seed)
    return [([int(t) for t in rng.integers(0, CONFIG.vocab_size, int(rng.integers(p_lo, p_hi)))],
             int(rng.integers(2, 13))) for _ in range(n)]


def _serve(params, requests, budget, **kw):
    engine = _engine(params, prefill_budget=budget, **kw)
    rids = [engine.submit(p, n) for p, n in requests]
    served = engine.run()
    _hygiene(engine)
    return [served[r] for r in rids], engine


def test_fault_mid_prefill_replays_bit_identical(params):
    requests = _mixed_requests(4, rng_seed=14)
    base, _ = _serve(params, requests, None)
    got, engine = _serve(params, requests, 8, max_retries=2,
                         fault_injector=FaultInjector({"prefill_dispatch": [2]}))
    assert engine.steps_quarantined == 1
    assert got == base


def test_fault_mid_prefill_exhausted_retries_fail_terminally(params):
    rng = np.random.default_rng(15)
    long = [int(t) for t in rng.integers(0, CONFIG.vocab_size, 30)]
    engine = _engine(params, prefill_budget=8, max_retries=1,
                     fault_injector=FaultInjector({"prefill_dispatch": list(range(1, 50))}))
    rid = engine.submit(long, 6)
    engine.run()
    assert _statuses(engine)[rid] == "failed"
    _hygiene(engine)


def test_health_pause_requeues_mid_prefill_without_charge(params):
    q = queue.Queue()
    engine, rid, long = _park_one(params, health_events=q)
    q.put(HealthEvent(chip_id="chip-0", health=DAEMON_UNHEALTHY, code=2))
    engine.step()
    assert engine.paused
    assert not engine._inflight_prefill
    assert engine.pending and engine.pending[0].rid == rid
    assert engine.pending[0].retries == 0
    engine.step()
    assert not engine._inflight_prefill  # held
    q.put(HealthEvent(chip_id="chip-0", health=HEALTHY, code=2))
    served = engine.run()
    _hygiene(engine)
    base, _ = _serve(params, [(long, 6)], None)
    assert served[rid] == base[0]


# ---- retune ----------------------------------------------------------------


def test_retune_validates_and_counts_only_real_changes(params):
    engine = _engine(params, superstep_k=2)
    assert engine.retune(superstep_k=2) == {}
    assert engine.retune() == {}
    assert engine.retunes == 0
    for bad in (4, 0):
        with pytest.raises(ValueError, match="superstep_k"):
            engine.retune(superstep_k=bad)
    assert engine.retune(superstep_k=1) == {"superstep_k": (2, 1)}
    assert engine.retunes == 1
    engine.close()
    with pytest.raises(EngineClosed):
        engine.retune(superstep_k=2)


@pytest.mark.parametrize("pipelined", [False, True], ids=["plain", "pipelined"])
def test_retune_superstep_k_step_mid_stream_bit_identical(params, pipelined):
    """k 4 -> 2 -> 1 -> 4 mid-flight, never above the construction
    ceiling: streams equal generate()'s throughout; the retune's drain
    retirements surface through the next step()."""
    engine = _engine(params, superstep_k=4, pipelined=pipelined)
    reqs = [([3, 4, 5, 6], 18), ([7, 8], 14), ([9, 9, 9], 25)]
    rids = [engine.submit(p, n) for p, n in reqs]
    out = {}
    for k in (2, 1, 4):
        for _ in range(2):
            for fr in engine.step():
                out[fr.rid] = fr.tokens
        assert set(engine.retune(superstep_k=k)) == {"superstep_k"}
        assert not engine._pending_super and engine._super_chained is None
    with pytest.raises(ValueError):
        engine.retune(superstep_k=8)
    out.update(engine.run())
    assert engine.retunes == 3
    for rid, (prompt, new) in zip(rids, reqs):
        assert out[rid] == _ref(params, prompt, new), rid
    _hygiene(engine)


def test_cli_lifecycle_flags_on_cpu(capsys):
    assert main([
        "--requests", "6", "--slots", "2", "--prompt-len", "8", "--max-new-tokens", "16",
        "--superstep-k", "2", "--pipelined", "--temperature", "0", "--device", "cpu",
        "--inject-fault", "decode_readback:2", "--inject-fault", "prefill_dispatch:1",
        "--max-retries", "3", "--deadline-s", "60",
    ]) == 0
    out = capsys.readouterr().out
    assert "pages in use after drain: 0" in out
    assert "statuses={'ok': 6} quarantined_steps=2" in out
    for bad in ("spec_bogus:1", "decode_dispatch", "replica_crash:1"):
        with pytest.raises(SystemExit):
            main(["--device", "cpu", "--inject-fault", bad])
