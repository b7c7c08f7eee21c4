"""The JAX package's fleet contracts, ported to the PyTorch port on the
CPU: its tests/test_fleet.py (router, failover, drains, live add and
remove, the HTTP/SSE front end, health), the fleet cases of
test_disagg.py (roles and the KV handoff, WFQ, per-class schedules; the
engine cases came with the KV hierarchy), the journal and restore cases
of test_durable.py, and the fleet sweeps of test_serve_fuzz.py.

Each section is the JAX test file's text with its imports pointed at
``workloads_torch`` and its engines built on ``device="cpu"``; where a
helper's name would clash across sections it is renamed, as the section
heading says.  torch, numpy and the port only (plus the jax-free parts
of the device plugin that the JAX tests import), so it runs in the fast
tier.  The scripted runs against frozen JAX fleet runs are in
tests/test_torch_fleet.py.
"""

from __future__ import annotations

import dataclasses
import json
import numpy as np
import os
import pytest
import time
import torch

from tpu_device_plugin.api.constants import HEALTHY, UNHEALTHY
from tpu_device_plugin.device import HealthEvent
from workloads_torch import prng
from workloads_torch.durable import KVDiskTier, SessionJournal, _pack_blob, _unpack_blob, atomic_write_bytes, atomic_write_json
from workloads_torch.errors import EngineClosed, InvalidRequest, QueueFull
from workloads_torch.faults import REPLICA_SEAMS, FaultInjector
from workloads_torch.fleet import DEAD, DRAINING, Fleet, FleetServer, Router, TrafficGen, drive_open_loop, FleetRequest, KVHandoff
from workloads_torch.generate import generate as _port_generate
from workloads_torch.lora import merge_lora
from workloads_torch.model import ModelConfig, init_params
from workloads_torch.multi_lora import synthetic_adapters
from workloads_torch.paged import RadixKV, read_page, read_pages
from workloads_torch.serve import ServeEngine as _PortEngine
from workloads_torch.supervisor import make_engine_factory as _port_make_engine_factory
from tests.test_torch_superstep import one_torch_thread  # noqa: F401


class ServeEngine(_PortEngine):
    """The port's engine on the CPU: the JAX contracts build engines
    with no device, and the port's default is the card."""

    def __init__(self, *args, device="cpu", **kw):
        super().__init__(*args, device=device, **kw)


def generate(*args, device="cpu", **kw):
    return _port_generate(*args, device=device, **kw)


def make_engine_factory(*args, device="cpu", **kw):
    return _port_make_engine_factory(*args, device=device, **kw)


# ==== tests/test_fleet.py
CONFIG = ModelConfig(max_seq_len=64, n_layers=2, dtype=torch.float32)
PARAMS = init_params(CONFIG, prng.PRNGKey(0, device="cpu"))
TERMINAL = {"ok", "cancelled", "expired", "failed"}


def _engine(**kw):
    base = dict(slots=2, page_size=4, prompt_bucket=8)
    base.update(kw)
    return ServeEngine(PARAMS, CONFIG, **base)


def _fleet(n=2, *, engine_kw=None, **fleet_kw):
    fleet_kw.setdefault(
        "chip_ids", [f"chip-{i}" for i in range(n)]
    )
    # Wall-clock watchdog off by default: a loaded CI host's XLA compile
    # times must never read as replica hangs.  The watchdog has its own
    # dedicated test below.
    fleet_kw.setdefault("hang_timeout_s", None)
    return Fleet(
        [_engine(**(engine_kw or {})) for _ in range(n)], **fleet_kw
    )


def _oracle(prompt, new):
    return [int(t) for t in np.asarray(generate(
        PARAMS, torch.tensor([prompt]), CONFIG,
        max_new_tokens=new,
    )[0])]


def _prompts(seed, n, lo=1, hi=20, new_lo=2, new_hi=16):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        plen = int(rng.integers(lo, hi))
        prompt = [int(t) for t in rng.integers(0, CONFIG.vocab_size, plen)]
        out.append((prompt, int(rng.integers(new_lo, new_hi))))
    return out


def _run_collecting(
    fleet, expected, *, max_steps=600, mid_step=None, terminal=None,
):
    """Step to convergence, asserting one terminal status per rid."""
    terminal = dict(terminal or {})
    steps = 0
    while not fleet.idle:
        steps += 1
        assert steps < max_steps, (fleet.states(), "failed to converge")
        if mid_step is not None:
            mid_step(steps)
        for fr in fleet.step():
            assert fr.rid not in terminal, (fr.rid, "double terminal")
            assert fr.status in TERMINAL, (fr.rid, fr.status)
            terminal[fr.rid] = fr.status
    assert set(terminal) >= set(expected), set(expected) - set(terminal)
    return terminal


def _assert_no_leaks(fleet):
    for rep in fleet.replicas:
        if rep.state == DEAD:
            continue
        e = rep.engine
        assert not e._occupied.any(), rep.index
        assert e._committed_pages == 0, rep.index
        assert not e._groups, rep.index
        pinned = e.prefix.cached_pages if e.prefix is not None else 0
        assert e.ctrl.used_pages == pinned, rep.index
        assert not rep.rids, rep.index


# ---- basic serving -------------------------------------------------------


def test_fleet_serves_bit_identical_to_dense_oracle():
    fleet = _fleet(2)
    reqs = _prompts(0, 6)
    rids = [fleet.submit(p, n) for p, n in reqs]
    served = fleet.run()
    for rid, (prompt, new) in zip(rids, reqs):
        assert served[rid] == _oracle(prompt, new), rid
    # Both replicas actually took work (least-loaded spreads).
    assert all(r.engine.requests_admitted > 0 for r in fleet.replicas)
    assert fleet.requests_ok == 6
    _assert_no_leaks(fleet)
    fleet.close()
    assert all(r.state == DEAD for r in fleet.replicas)


def test_router_least_loaded_and_session_affinity():
    router = Router(affinity_slack=8)
    fleet = _fleet(3, router=router)
    reqs = _prompts(1, 9, new_lo=4)
    # Three sessions, three requests each: affinity must pin a session
    # to one replica (slack is generous), least-loaded must spread the
    # three sessions across replicas.
    placed: dict[str, set[int]] = {}
    rids = {}
    for i, (p, n) in enumerate(reqs):
        sess = f"s{i % 3}"
        rid = fleet.submit(p, n, session=sess)
        rids[rid] = (p, n, sess)
    fleet.step()  # one dispatch pass places everything queued
    for rid, (_p, _n, sess) in rids.items():
        fr = fleet._reqs[rid]
        if fr.replica is not None:
            placed.setdefault(sess, set()).add(fr.replica)
    for sess, replicas in placed.items():
        assert len(replicas) == 1, (sess, replicas)
    assert len({next(iter(v)) for v in placed.values()}) == 3
    assert router.affinity_hits >= 6
    served = fleet.run()
    for rid, (p, n, _s) in rids.items():
        assert served.get(rid, fleet._reqs[rid].tokens) == _oracle(p, n)
    fleet.close()


def test_fleet_bounded_admission_and_validation():
    fleet = _fleet(1, max_pending=2)
    fleet.submit([1, 2], 2)
    fleet.submit([3, 4], 2)
    with pytest.raises(QueueFull):
        fleet.submit([5, 6], 2)
    assert fleet.queue_rejections == 1
    with pytest.raises(InvalidRequest):
        fleet.submit([1], 0)
    with pytest.raises(Exception):
        fleet.submit([], 2)
    rid = "dup"
    fleet.run()
    fleet.submit([1], 1, rid=rid)
    with pytest.raises(InvalidRequest):
        fleet.submit([2], 1, rid=rid)
    fleet.run()
    fleet.close()
    with pytest.raises(EngineClosed):
        fleet.submit([1], 1)
    with pytest.raises(EngineClosed):
        fleet.step()
    fleet.close()  # idempotent


def test_fleet_cancel_and_deadline_one_terminal_each():
    fleet = _fleet(2)
    reqs = _prompts(2, 5, new_lo=8, new_hi=16)
    rids = [fleet.submit(p, n) for p, n in reqs]
    # Cancel one while still router-queued, one after dispatch.
    assert fleet.cancel(rids[0]) is True
    early = {fr.rid: fr.status for fr in fleet.step()}
    assert fleet.cancel(rids[1]) is True
    assert fleet.cancel("nope") is False
    expired_rid = fleet.submit([7, 7, 7], 12, deadline_s=1e-4)
    time.sleep(0.002)
    terminal = _run_collecting(
        fleet, rids + [expired_rid], terminal=early
    )
    assert terminal[rids[0]] == "cancelled"
    assert terminal[rids[1]] == "cancelled"
    assert terminal[expired_rid] == "expired"
    for rid, (p, n) in list(zip(rids, reqs))[2:]:
        assert fleet._reqs[rid].tokens == _oracle(p, n)
    # Cancelling an already-terminal rid is a no-op, not a second status.
    assert fleet.cancel(rids[0]) is False
    _assert_no_leaks(fleet)
    fleet.close()


# ---- failover: crash / hang / slow --------------------------------------


def test_replica_crash_fails_over_bit_identically():
    """The headline acceptance contract: N=4 under the open-loop
    generator, a replica crash mid-stream — every rid one terminal
    status, ok streams bit-identical to the single-engine oracle,
    survivors leak-free, recovery latency recorded."""
    n = 4
    # Crossing 2n+1 = fleet step 3, replica 0 — mid-stream, in-flight.
    injector = FaultInjector({"replica_crash": 2 * n + 1})
    fleet = _fleet(n, fault_injector=injector, max_failovers=2)
    reqs = _prompts(3, 12, lo=4, hi=20, new_lo=8, new_hi=16)
    rids = [fleet.submit(p, nw) for p, nw in reqs]
    terminal = _run_collecting(fleet, rids)
    assert fleet.replica_crashes == 1
    assert fleet.replicas[0].state == DEAD
    assert fleet.failover_requeues >= 1
    assert len(fleet.failover_recovery_s) == 1
    assert fleet.failover_recovery_s[0] > 0
    for rid, (p, nw) in zip(rids, reqs):
        fr = fleet._reqs[rid]
        ref = _oracle(p, nw)
        if terminal[rid] == "ok":
            assert fr.tokens == ref, (rid, fr.failovers, fr.segments)
        else:
            assert fr.tokens == ref[: len(fr.tokens)], rid
    # At least one ok stream actually crossed the failover (segments>1).
    crossed = [
        r for r in rids
        if fleet._reqs[r].segments > 1 and terminal[r] == "ok"
    ]
    assert crossed, "crash failed over no in-flight request"
    _assert_no_leaks(fleet)
    fleet.close()


def test_replica_hang_counts_separately_and_fails_over():
    injector = FaultInjector({"replica_hang": 3})  # step 2, replica 0
    fleet = _fleet(2, fault_injector=injector)
    reqs = _prompts(4, 6, new_lo=6)
    rids = [fleet.submit(p, n) for p, n in reqs]
    terminal = _run_collecting(fleet, rids)
    assert fleet.replica_hangs == 1 and fleet.replica_crashes == 0
    assert fleet.replicas[0].state == DEAD
    for rid, (p, n) in zip(rids, reqs):
        if terminal[rid] == "ok":
            assert fleet._reqs[rid].tokens == _oracle(p, n)
    _assert_no_leaks(fleet)
    fleet.close()


def test_slow_auto_drain_never_takes_the_last_dispatchable_replica():
    """A 1-replica fleet under persistent replica_slow must keep
    serving degraded — auto-draining the only dispatchable replica
    would park the queue forever."""
    injector = FaultInjector({"replica_slow": [1, 2, 3, 4, 5, 6]})
    fleet = _fleet(
        1, fault_injector=injector, slow_readback_s=0.0,
        slow_drain_after=2,
    )
    reqs = _prompts(13, 4, new_lo=4)
    rids = [fleet.submit(p, n) for p, n in reqs]
    terminal = _run_collecting(fleet, rids)
    assert fleet.replicas[0].state == "active"
    assert all(terminal[r] == "ok" for r in rids)
    _assert_no_leaks(fleet)
    fleet.close()


def test_harvested_complete_stream_finishes_ok_not_replayed():
    """A replica dying between emitting a stream's last token and
    retiring the request leaves a bit-complete harvest: the fleet must
    finish it 'ok' — a zero-budget replay would InvalidRequest a
    stream the client already received in full."""
    from workloads_torch.fleet import FleetRequest

    fleet = _fleet(2)
    fr = FleetRequest(rid="r-done", prompt=[1, 2], max_new_tokens=3)
    fr.tokens = [5, 6, 7]  # complete
    fleet._reqs[fr.rid] = fr
    finished = fleet._requeue_victims([fr], charge=True)
    assert [f.rid for f in finished] == ["r-done"]
    assert fr.status == "ok" and fr.failovers == 0
    assert not fleet.queue
    # EOS-terminated harvest counts as complete too.
    fr2 = FleetRequest(
        rid="r-eos", prompt=[1], max_new_tokens=8, eos_token=9,
    )
    fr2.tokens = [4, 9]
    fleet._reqs[fr2.rid] = fr2
    finished = fleet._requeue_victims([fr2], charge=True)
    assert fr2.status == "ok" and not fleet.queue
    fleet.close()


def test_replica_slow_auto_drains_not_kills():
    injector = FaultInjector(
        {"replica_slow": [1, 3, 5]}  # replica 0's first three steps
    )
    fleet = _fleet(
        2, fault_injector=injector, slow_readback_s=0.0,
        slow_drain_after=3,
    )
    reqs = _prompts(5, 6, new_lo=6)
    rids = [fleet.submit(p, n) for p, n in reqs]
    terminal = _run_collecting(fleet, rids)
    assert fleet.replicas[0].state == DRAINING  # degraded, not dead
    assert fleet.replica_crashes == 0 and fleet.replica_hangs == 0
    assert all(terminal[r] == "ok" for r in rids)
    for rid, (p, n) in zip(rids, reqs):
        assert fleet._reqs[rid].tokens == _oracle(p, n)
    # A drained replica takes no new work until resumed.
    admitted0 = fleet.replicas[0].engine.requests_admitted
    rid = fleet.submit([9, 9], 4)
    fleet.step()
    assert fleet.replicas[0].engine.requests_admitted == admitted0
    assert fleet._reqs[rid].status in ("running", "ok")
    fleet.resume(0)
    assert fleet.replicas[0].state == "active"
    fleet.run()
    _assert_no_leaks(fleet)
    fleet.close()


def test_hang_watchdog_exempts_warmup_and_kills_wedged_steps():
    """The wall-clock watchdog must not mistake one-time XLA compiles
    for a wedge (a replica's FIRST step is exempt), but a genuinely
    wedged later step kills the replica and fails its work over."""
    # Warm-up exemption: first steps are compile-dominated and far
    # exceed a tight timeout, yet no replica may die for it.
    fleet = _fleet(2, hang_timeout_s=0.05)
    for p, n in _prompts(11, 4, new_lo=4):
        fleet.submit(p, n)
    fleet.step()
    assert fleet.replica_hangs == 0
    assert all(r.state != DEAD for r in fleet.replicas)
    fleet.close()

    # Kill path: compiles warmed off the clock, then one wedged step.
    # (A failover replay can compile a fresh prefill bucket on the
    # survivor, which a tight watchdog may legitimately also count as
    # a hang — so replica 0's death is pinned exactly, the rest of the
    # fleet's fate only via the lifecycle invariants.)
    fleet = _fleet(2, hang_timeout_s=None)
    for p, n in _prompts(11, 4, new_lo=4):
        fleet.submit(p, n)
    fleet.run()
    fleet.drain_completed()
    fleet.hang_timeout_s = 0.5
    real_step = fleet.replicas[0].engine.step

    def wedged_step():
        time.sleep(0.8)
        return real_step()

    fleet.replicas[0].engine.step = wedged_step
    reqs = _prompts(12, 4, new_lo=6)
    rids = [fleet.submit(p, n) for p, n in reqs]
    terminal = _run_collecting(fleet, rids)
    assert fleet.replica_hangs >= 1 and fleet.replica_crashes == 0
    assert fleet.replicas[0].state == DEAD
    for rid, (p, n) in zip(rids, reqs):
        fr, ref = fleet._reqs[rid], _oracle(p, n)
        if terminal[rid] == "ok":
            assert fr.tokens == ref, rid
        else:
            assert fr.tokens == ref[: len(fr.tokens)], rid
    if fleet.replicas[1].state != DEAD:
        assert any(s == "ok" for s in terminal.values())
        _assert_no_leaks(fleet)
    fleet.close()


def test_failover_budget_exhaustion_fails_terminally():
    """Every replica dies: requests charged past max_failovers (or left
    with no live replica) fail terminally — never spin, never double."""
    injector = FaultInjector({"replica_crash": [3, 4]})  # step 2: both die
    fleet = _fleet(2, fault_injector=injector, max_failovers=1)
    reqs = _prompts(6, 4, new_lo=8)
    rids = [fleet.submit(p, n) for p, n in reqs]
    terminal = _run_collecting(fleet, rids)
    assert all(r.state == DEAD for r in fleet.replicas)
    assert set(terminal.values()) <= {"failed", "ok"}
    assert any(s == "failed" for s in terminal.values())
    for rid, (p, n) in zip(rids, reqs):
        fr = fleet._reqs[rid]
        ref = _oracle(p, n)
        assert fr.tokens == ref[: len(fr.tokens)], rid  # true prefix
    fleet.close()


# ---- health: fleet-scope HealthFanout contracts --------------------------


def test_health_drain_is_uncharged_and_bit_identical():
    """A HealthFanout Unhealthy on one chip drains exactly that
    replica: its work fails over to survivors WITHOUT charging
    failover budgets, streams stay oracle-identical, and the replica
    resumes on recovery."""
    fleet = _fleet(2)
    reqs = _prompts(7, 6, new_lo=8, new_hi=16)
    rids = [fleet.submit(p, n) for p, n in reqs]
    early = {fr.rid: fr.status for fr in fleet.step()}  # dispatch + step
    assert any(r for r in fleet.replicas[0].rids)
    fleet.deliver_health([HealthEvent(chip_id="chip-0", health=UNHEALTHY)])
    early.update((fr.rid, fr.status) for fr in fleet.step())
    assert fleet.replicas[0].paused
    assert fleet.replicas[1].dispatchable
    # Drained, not charged: requeues counted on the drain side only.
    assert fleet.failover_requeues == 0
    assert fleet.drain_requeues >= 1
    assert not fleet.replicas[0].rids  # nothing stranded on the sick one
    terminal = _run_collecting(fleet, rids, terminal=early)
    assert all(terminal[r] == "ok" for r in rids)
    for rid, (p, n) in zip(rids, reqs):
        assert fleet._reqs[rid].tokens == _oracle(p, n), rid
    assert fleet.replicas[0].state == "active"  # drained, never dead
    # Recovery: the replica serves again.
    fleet.deliver_health([HealthEvent(chip_id="chip-0", health=HEALTHY)])
    rid = fleet.submit([3, 1], 4, session=None)
    fleet.run()
    assert not fleet.replicas[0].paused
    assert fleet._reqs[rid].status == "ok"
    _assert_no_leaks(fleet)
    fleet.close()


def test_health_mixed_attribution_never_strands_the_fleet():
    """The PR-4 all-chips contract at N engines: per-chip events drain
    exactly the named replica; an unattributed Unhealthy pauses every
    replica (work parks in place — nowhere to fail over to); a
    per-chip Healthy cannot clear the unattributed mark; the
    unattributed all-clear lifts every mark on every replica."""
    fleet = _fleet(3)
    # Long enough that nothing can finish before the fleet-wide pause
    # (>= 14 tokens needs >= 4 decode chunks; only 2 steps run first).
    reqs = _prompts(8, 6, new_lo=14, new_hi=16)
    rids = [fleet.submit(p, n) for p, n in reqs]
    fleet.step()
    # Per-chip: only replica 1 pauses.
    fleet.deliver_health([HealthEvent(chip_id="chip-1", health=UNHEALTHY)])
    fleet.step()
    assert [r.paused for r in fleet.replicas] == [False, True, False]
    # Unattributed Unhealthy: everyone pauses; nothing bounces (no
    # dispatchable survivor) and nothing reaches a terminal status.
    fleet.deliver_health([HealthEvent(chip_id="", health=UNHEALTHY)])
    drains_before = fleet.drain_requeues
    fleet.step()
    fleet.step()
    assert all(r.paused for r in fleet.replicas)
    assert fleet.drain_requeues == drains_before
    assert not any(fleet._reqs[r].done for r in rids)
    # A per-chip recovery cannot clear the unattributed mark.
    fleet.deliver_health([HealthEvent(chip_id="chip-0", health=HEALTHY)])
    fleet.step()
    assert all(r.paused for r in fleet.replicas)
    # The unattributed all-clear lifts every mark — fleet-wide resume.
    fleet.deliver_health([HealthEvent(chip_id="", health=HEALTHY)])
    terminal = _run_collecting(fleet, rids)
    assert not any(r.paused for r in fleet.replicas)
    assert all(terminal[r] == "ok" for r in rids)
    for rid, (p, n) in zip(rids, reqs):
        assert fleet._reqs[rid].tokens == _oracle(p, n), rid
    assert fleet.replica_crashes == 0 and fleet.failover_requeues == 0
    _assert_no_leaks(fleet)
    fleet.close()


def test_health_events_via_fanout_subscription():
    """bind_health routes a real fanout-shaped subscription through the
    same per-chip delivery (duck-typed fanout: subscribe/unsubscribe)."""
    import queue as _queue

    class _FakeFanout:
        def __init__(self):
            self.q = _queue.Queue()
            self.unsubscribed = False

        def subscribe(self):
            return self.q

        def unsubscribe(self, q):
            self.unsubscribed = True

    fanout = _FakeFanout()
    fleet = _fleet(2)
    fleet.bind_health(fanout)
    rid = fleet.submit(list(range(1, 6)), 8)
    fleet.step()
    fanout.q.put(HealthEvent(chip_id="chip-0", health=UNHEALTHY))
    fleet.step()
    assert fleet.replicas[0].paused and not fleet.replicas[1].paused
    fanout.q.put(HealthEvent(chip_id="chip-0", health=HEALTHY))
    fleet.run()
    assert fleet._reqs[rid].status == "ok"
    fleet.close()
    assert fanout.unsubscribed


# ---- membership: drain / remove / add -----------------------------------


def test_graceful_drain_remove_and_live_add():
    fleet = _fleet(2)
    reqs = _prompts(9, 6, new_lo=8)
    rids = [fleet.submit(p, n) for p, n in reqs]
    fleet.step()
    fleet.drain(0)
    assert fleet.replicas[0].state == DRAINING
    with pytest.raises(RuntimeError):
        fleet.remove(0)  # still holds work, not forced
    # In-flight work finishes ON the draining replica (graceful).
    on_drained = set(fleet.replicas[0].rids)
    terminal = _run_collecting(fleet, rids)
    assert all(terminal[r] == "ok" for r in rids)
    assert fleet.drain_requeues == 0 and fleet.failover_requeues == 0
    assert on_drained  # it really had work to finish
    fleet.remove(0)
    assert fleet.replicas[0].state == DEAD
    assert fleet.replicas[0].engine.closed
    # Live add: a fresh engine joins and takes work immediately.
    idx = fleet.add_replica(_engine(), chip_id="chip-2")
    assert idx == 2
    more = _prompts(10, 4, new_lo=4)
    rids2 = [fleet.submit(p, n) for p, n in more]
    fleet.run()
    assert fleet.replicas[2].engine.requests_admitted > 0
    for rid, (p, n) in zip(rids2, more):
        assert fleet._reqs[rid].status == "ok"
        assert fleet._reqs[rid].tokens == _oracle(p, n)
    _assert_no_leaks(fleet)
    fleet.close()


def test_forced_remove_fails_over_uncharged():
    fleet = _fleet(2)
    reqs = _prompts(11, 5, new_lo=10, new_hi=16)
    rids = [fleet.submit(p, n) for p, n in reqs]
    fleet.step()
    assert fleet.replicas[0].rids  # it holds in-flight work
    fleet.remove(0, force=True)
    assert fleet.replicas[0].state == DEAD
    terminal = _run_collecting(fleet, rids)
    assert all(terminal[r] == "ok" for r in rids)
    assert fleet.failover_requeues == 0  # operator action: uncharged
    assert fleet.drain_requeues >= 1
    for rid, (p, n) in zip(rids, reqs):
        assert fleet._reqs[rid].tokens == _oracle(p, n), rid
    _assert_no_leaks(fleet)
    fleet.close()


def test_engine_withdraw_is_statusless():
    """The router's reclaim seam on the engine: a withdrawn pending
    request keeps its lifecycle open (no terminal status, no counter),
    while running requests refuse to withdraw."""
    engine = _engine()
    rid_q = engine.submit([1, 2, 3], 4)
    rid_run = engine.submit([4, 5], 4)
    req = engine.withdraw(rid_q)
    assert req is not None and req.rid == rid_q
    assert req.status == "queued" and not req.done
    assert engine.requests_cancelled == 0
    assert len(engine.completed) == 0
    engine.step()  # rid_run admits
    assert engine.withdraw(rid_run) is None
    assert engine.withdraw("unknown") is None
    engine.run()
    engine.close()
    with pytest.raises(EngineClosed):
        engine.withdraw("x")


# ---- traffic generator and open-loop drive ------------------------------


def test_trafficgen_is_seeded_bursty_and_heavy_tailed():
    gen = TrafficGen(seed=3, rate_rps=200.0, max_prompt=24, vocab=64)
    a, b = gen.schedule(200), gen.schedule(200)
    assert a == b  # deterministic per seed
    assert a != TrafficGen(seed=4, rate_rps=200.0, vocab=64).schedule(200)
    offsets = [t for t, _, _ in a]
    assert offsets == sorted(offsets)
    plens = [len(p) for _, p, _ in a]
    # Heavy tail: mass at the floor AND excursions to the cap.
    assert min(plens) == 1 and max(plens) == 24
    assert sorted(plens)[len(plens) // 2] < 8
    gaps = [b - a for a, b in zip(offsets, offsets[1:])]
    # Bursty: the largest gap dwarfs the median one.
    assert max(gaps) > 5 * sorted(gaps)[len(gaps) // 2]
    for _, p, n in a:
        assert all(0 <= t < 64 for t in p)
        assert 1 <= n <= gen.max_new


def test_open_loop_drive_serves_the_schedule():
    fleet = _fleet(2)
    gen = TrafficGen(
        seed=1, rate_rps=500.0, max_prompt=16, max_new=8,
        vocab=CONFIG.vocab_size,
    )
    served = drive_open_loop(
        fleet, gen.schedule(10), session_every=3
    )
    assert len(served) == 10
    assert fleet.requests_ok == 10
    by_rid = {fr.rid: fr for fr in fleet.completed}
    for rid, tokens in served.items():
        fr = by_rid[rid]
        assert tokens == _oracle(fr.prompt, fr.max_new_tokens), rid
    _assert_no_leaks(fleet)
    fleet.close()


# ---- HTTP/SSE front end --------------------------------------------------


def test_sse_front_end_streams_real_tokens():
    import urllib.error
    import urllib.request

    fleet = _fleet(2)
    server = FleetServer(fleet, 0)
    port = server.start()
    try:
        prompt, new = [5, 4, 3, 2, 1], 7
        body = json.dumps({
            "prompt": prompt, "max_new_tokens": new, "session": "s1",
        }).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/generate", data=body,
            headers={"Content-Type": "application/json"},
        )
        tokens, final = [], None
        with urllib.request.urlopen(req, timeout=30) as resp:
            assert resp.headers["Content-Type"] == "text/event-stream"
            for line in resp:
                if not line.startswith(b"data: "):
                    continue
                ev = json.loads(line[6:])
                if ev.get("done"):
                    final = ev
                    break
                tokens.extend(ev["tokens"])
        assert final is not None and final["status"] == "ok"
        assert final["n_tokens"] == len(tokens)
        assert tokens == _oracle(prompt, new)
        with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/healthz", timeout=10
        ) as resp:
            health = json.loads(resp.read())
        assert health["ok"] is True
        assert set(health["replicas"]) == {"0", "1"}
        assert all(
            v["state"] == "active" for v in health["replicas"].values()
        )
        # Validation maps to 400, not a wedged stream.
        bad = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/generate",
            data=json.dumps({"prompt": []}).encode(),
            headers={"Content-Type": "application/json"},
        )
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(bad, timeout=10)
        assert err.value.code == 400
    finally:
        server.stop()
        fleet.close()


# ---- chaos smoke (make fleet-check) -------------------------------------


def _run_fleet_chaos(seed: int) -> None:
    """One seeded chaos round: open-loop-style traffic over N=2..4
    replicas with randomized replica crashes/hangs/slow steps, engine
    seam faults, health drains, cancels and deadlines — the lifecycle
    invariants must hold throughout."""
    rng = np.random.default_rng(seed + 9000)
    n = int(rng.integers(2, 5))
    fleet_inj = FaultInjector.random(
        seed=seed, rate=0.03, seams=REPLICA_SEAMS,
        max_fires=int(rng.integers(1, n)),  # never kills every replica
    )
    engines = []
    for i in range(n):
        eng_inj = (
            FaultInjector.random(seed=seed * 7 + i, rate=0.02, max_fires=2)
            if rng.integers(2) else None
        )
        engines.append(_engine(
            slots=int(rng.integers(1, 3)),
            prefix_cache=bool(rng.integers(2)),
            pipelined=bool(rng.integers(2)),
            fault_injector=eng_inj, max_retries=2,
        ))
    fleet = Fleet(
        engines, chip_ids=[f"chip-{i}" for i in range(n)],
        fault_injector=fleet_inj, max_failovers=2,
        slow_readback_s=0.0,
        # Deterministic chaos: hangs come from the injected seam, not
        # the load-dependent wall-clock watchdog.
        hang_timeout_s=None,
    )
    expected = {}
    for p, nw in _prompts(seed, int(rng.integers(5, 9)), new_lo=2):
        deadline = 0.05 if rng.integers(6) == 0 else None
        sess = f"s{int(rng.integers(3))}" if rng.integers(2) else None
        try:
            rid = fleet.submit(p, nw, deadline_s=deadline, session=sess)
        except QueueFull:
            continue
        expected[rid] = (p, nw)

    def mid(step):
        live = [r for r in expected if not fleet._reqs[r].done]
        if live and rng.integers(10) == 0:
            fleet.cancel(str(rng.choice(live)))
        if rng.integers(12) == 0:
            alive = fleet.alive
            if len(alive) > 1:
                fleet.deliver_health([HealthEvent(
                    chip_id=alive[0].chip_id, health=UNHEALTHY,
                )])
        if rng.integers(12) == 0:
            fleet.deliver_health([HealthEvent(chip_id="", health=HEALTHY)])

    terminal = _run_collecting(fleet, expected, mid_step=mid)
    assert set(terminal) == set(expected)
    for rid, (p, nw) in expected.items():
        fr = fleet._reqs[rid]
        ref = _oracle(p, nw)
        if terminal[rid] == "ok":
            assert fr.tokens == ref, (seed, rid, fr.failovers)
        else:
            assert fr.tokens == ref[: len(fr.tokens)], (seed, rid)
    _assert_no_leaks(fleet)
    fleet.close()


def test_fleet_chaos_smoke():
    """ONE cheap seeded chaos round — the `make fleet-check` smoke."""
    _run_fleet_chaos(1)


# ---- capacity-aware admission: dispatchable semantics (PR 13) ------------


def test_admission_bound_counts_dispatchable_replicas_only():
    """The capacity-aware bound scales with replicas that accept NEW
    work — DRAINING and health-paused replicas still finish in-flight
    work but buy no fresh queue budget, and the QueueFull message
    names the dispatchable count (the autoscaler's brownout builds on
    this bound)."""
    fleet = _fleet(3, max_pending_per_replica=2)
    assert fleet.dispatchable_count == 3
    assert fleet.admission_bound == 6
    # A drain drops the bound immediately...
    fleet.drain(2)
    assert fleet.dispatchable_count == 2
    assert fleet.admission_bound == 4
    # ...and so does a health pause (previously only deaths did).
    fleet.deliver_health([
        HealthEvent(chip_id="chip-1", health=UNHEALTHY)
    ])
    fleet.step()
    assert fleet.replicas[1].paused
    assert fleet.dispatchable_count == 1
    assert fleet.admission_bound == 2
    fleet.submit([1, 2], 2)
    fleet.submit([3, 4], 2)
    with pytest.raises(QueueFull) as exc:
        fleet.submit([5, 6], 2)
    msg = str(exc.value)
    assert "capacity-aware" in msg
    assert "1 dispatchable" in msg
    # Recovery on both axes restores the bound.
    fleet.deliver_health([HealthEvent(chip_id="", health=HEALTHY)])
    fleet.step()
    fleet.resume(2)
    assert fleet.admission_bound == 6
    fleet.run()
    _assert_no_leaks(fleet)
    fleet.close()


def test_admission_factor_tightens_any_bound_never_unbounded():
    """The brownout knob: a factor < 1 tightens static and
    capacity-aware bounds alike (floored at 1), and an unbounded
    fleet stays unbounded — there is nothing to tighten."""
    fleet = _fleet(2, max_pending=8)
    assert fleet.admission_bound == 8
    fleet.admission_factor = 0.5
    assert fleet.admission_bound == 4
    fleet.admission_factor = 0.01
    assert fleet.admission_bound == 1  # never zero
    fleet.close()
    unbounded = _fleet(1)
    unbounded.admission_factor = 0.5
    assert unbounded.admission_bound is None
    unbounded.close()


# ---- TrafficGen step-load / ramp schedules (PR 13) -----------------------


def test_trafficgen_step_schedule_is_seeded_and_compresses_the_window():
    gen = TrafficGen(seed=3, rate_rps=100.0, max_prompt=24, vocab=64)
    base = gen.schedule(200)
    span = base[-1][0]
    profile = TrafficGen.step_profile(0.25 * span, 0.25 * span, 4.0)
    a = gen.schedule(200, profile)
    b = gen.schedule(200, profile)
    # Bit-identical across runs for a fixed seed.
    assert a == b
    assert a != TrafficGen(
        seed=4, rate_rps=100.0, max_prompt=24, vocab=64
    ).schedule(200, profile)
    # Prompts and budgets are PROFILE-INDEPENDENT: only arrival times
    # move (the rng draw sequence never forks).
    assert [(p, n) for _, p, n in a] == [(p, n) for _, p, n in base]
    offsets = [t for t, _, _ in a]
    assert offsets == sorted(offsets)
    # The x4 window really compresses arrivals: the spike's mean gap
    # is well under the calm prefix's.
    lo, hi = 0.25 * span, 0.5 * span
    in_win = [t for t in offsets if lo <= t < hi]
    before = [t for t in offsets if t < lo]
    assert len(in_win) >= 3 and len(before) >= 3

    def mean_gap(ts):
        return (ts[-1] - ts[0]) / max(1, len(ts) - 1)

    assert mean_gap(in_win) < 0.6 * mean_gap(before), (
        mean_gap(in_win), mean_gap(before),
    )
    # Validation is loud.
    with pytest.raises(ValueError):
        TrafficGen.step_profile(0.0, 0.0, 4.0)
    with pytest.raises(ValueError):
        TrafficGen.step_profile(0.0, 1.0, 0.0)
    with pytest.raises(ValueError):
        gen.schedule(5, lambda t: 0.0)


def test_trafficgen_ramp_schedule_monotonically_tightens_gaps():
    gen = TrafficGen(
        seed=5, rate_rps=50.0, burst_factor=1.0, max_prompt=8, vocab=64,
    )
    base = gen.schedule(300)
    span = base[-1][0]
    ramp = TrafficGen.ramp_profile(0.0, span, 8.0)
    a = gen.schedule(300, ramp)
    assert a == gen.schedule(300, ramp)  # seeded determinism
    offsets = [t for t, _, _ in a]
    thirds = len(offsets) // 3
    first = offsets[thirds - 1] - offsets[0]
    last = offsets[-1] - offsets[-thirds]
    # The same arrival count takes much less time at the ramp's top.
    assert last < first, (first, last)
    with pytest.raises(ValueError):
        TrafficGen.ramp_profile(0.0, 0.0, 2.0)
    with pytest.raises(ValueError):
        TrafficGen.ramp_profile(0.0, 1.0, 0.0)


def test_trafficgen_classed_schedules_preserve_mix_under_rate_changes():
    """The class draw is positional on its own rng: a step or ramp
    profile changes arrival TIMES, never the class sequence — so the
    autoscaler bench's spike serves exactly the calm trace's class
    assignment."""
    gen = TrafficGen(seed=11, rate_rps=100.0, max_prompt=16, vocab=64)
    calm = gen.schedule_classed(150)
    span = calm[-1][0]
    profile = TrafficGen.step_profile(0.2 * span, 0.3 * span, 4.0)
    stepped = gen.schedule_classed(150, profile)
    assert [c for _, _, _, c in stepped] == [c for _, _, _, c in calm]
    assert [(p, n) for _, p, n, _ in stepped] == [
        (p, n) for _, p, n, _ in calm
    ]
    # And the mix respects the configured weights (3:1 default).
    counts = TrafficGen.schedule_stats(stepped)["class_counts"]
    assert set(counts) == {"interactive", "bulk"}
    assert counts["interactive"] > counts["bulk"]


def test_trafficgen_schedule_stats_report():
    gen = TrafficGen(seed=7, rate_rps=200.0, max_prompt=12, vocab=64)
    sched = gen.schedule(100)
    stats = TrafficGen.schedule_stats(sched, window_s=0.5)
    assert stats["arrivals"] == 100
    assert stats["span_s"] > 0
    assert stats["mean_rps"] > 0
    assert stats["peak_rps"] >= stats["mean_rps"] * 0.5
    assert stats["prompt_tokens"] == sum(len(p) for _, p, _ in sched)
    assert stats["budget_tokens"] == sum(n for _, _, n in sched)
    assert "class_counts" not in stats  # unclassed schedule
    assert TrafficGen.schedule_stats([])["arrivals"] == 0
    with pytest.raises(ValueError):
        TrafficGen.schedule_stats(sched, window_s=0.0)


# ---- FleetServer operator endpoints (PR 13) ------------------------------


def _post(port, path):
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=b"", method="POST"
    )
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_fleet_server_operator_drain_undrain_over_http():
    fleet = _fleet(2)
    server = FleetServer(fleet, 0)
    port = server.start()
    try:
        code, body = _post(port, "/drain/1")
        assert code == 200 and body["state"] == DRAINING
        assert fleet.replicas[1].state == DRAINING
        code, body = _post(port, "/undrain/1")
        assert code == 200 and body["state"] == "active"
        assert fleet.replicas[1].state == "active"
        # Bad inputs answer, loudly, without killing the handler.
        code, _ = _post(port, "/drain/9")
        assert code == 404
        code, _ = _post(port, "/drain/x")
        assert code == 400
        # No supervisor: /clear is a conflict, not a crash.
        code, body = _post(port, "/clear/chip-0")
        assert code == 409 and "supervisor" in body["error"]
    finally:
        server.stop()
        fleet.close()


def test_fleet_server_clear_lifts_quarantine_over_http():
    from workloads_torch.backoff import Backoff
    from workloads_torch.supervisor import FleetSupervisor

    fleet = _fleet(2)
    factory, oracle = make_engine_factory(
        PARAMS, CONFIG, engine_kw=dict(slots=2, page_size=4, prompt_bucket=8),
        probe=([1, 2, 3], 4),
    )
    sup = FleetSupervisor(
        fleet, factory, backoff=Backoff(base_s=1e-3, max_s=8e-3, jitter=0.0),
        probe=([1, 2, 3], 4), probe_oracle=oracle,
    )
    sup.quarantine("chip-1", reason="operator test")
    server = FleetServer(fleet, 0, supervisor=sup)
    port = server.start()
    try:
        code, _ = _post(port, "/clear/nope")
        assert code == 404
        code, body = _post(port, "/clear/chip-1")
        assert code == 200
        assert sup.slot_for("chip-1").state != "quarantined"
    finally:
        server.stop()
        fleet.close()


# ---- dispatch_score: the one routing seam --------------------------------


def test_dispatch_score_pins_both_pre_unification_views():
    """Replica.dispatch_score IS the router's scalar: the request-count
    view must equal load() exactly, and the page-scheduled view
    page_load() + goodput_penalty() — pinned so the unification can
    never drift from the two pre-existing scoring paths."""
    from workloads_torch.ledger import ChipTimeLedger

    fleet = _fleet(2)
    for p, n in _prompts(5, 4, new_lo=6, new_hi=10):
        fleet.submit(p, n)
    fleet.step()  # dispatch + begin prefill: non-trivial loads
    for rep in fleet.replicas:
        assert rep.dispatch_score() == rep.load()
        assert rep.goodput_penalty() == 0  # no ledger armed: no bias
        assert rep.dispatch_score(page_scheduling=True) == rep.page_load()
    # A ledger mid-burn adds its handicap to the PAGE view only.
    led = ChipTimeLedger(name="x")
    led.tokens_accounted = 100
    led.goodput_tokens = 25
    rep = fleet.replicas[0]
    rep.engine.ledger = led
    assert rep.goodput_penalty() == 3  # (1 - 0.25) * 4 penalty pages
    assert rep.dispatch_score(page_scheduling=True) == (
        rep.page_load() + 3
    )
    assert rep.dispatch_score() == rep.load()  # request view unbiased
    fleet.run()
    fleet.close()


def test_goodput_penalty_steers_marginal_dispatch_to_clean_replica():
    """Page-scheduled routing reads the ledger: with otherwise-equal
    page loads, the replica burning its chip-time on waste carries the
    handicap and LOSES the marginal dispatch it would have tie-won by
    index — and the stream itself is unaffected."""
    from workloads_torch.ledger import ChipTimeLedger

    fleet = _fleet(2, page_scheduling=True)
    wasteful = fleet.replicas[0].engine
    wasteful.ledger = ChipTimeLedger(name="w")
    wasteful.ledger.tokens_accounted = 100  # zero goodput: full handicap
    rid = fleet.submit([1, 2, 3], 24)
    fleet.step()
    assert fleet._reqs[rid].replica == 1, "handicap ignored by router"
    out = fleet.run()
    assert out[rid] == _oracle([1, 2, 3], 24)
    fleet.close()


# ==== tests/test_disagg.py (renamed here: _engine -> _disagg_engine, _fleet -> _disagg_fleet, _prompts -> _disagg_prompts, _assert_no_leaks -> _disagg_assert_no_leaks)
def _disagg_engine(**kw):
    base = dict(
        slots=2, page_size=4, prompt_bucket=4,
        prefix_cache=True, kv_offload=True,
    )
    base.update(kw)
    return ServeEngine(PARAMS, CONFIG, **base)


def _disagg_fleet(n, roles=None, *, engine_kw=None, **fleet_kw):
    fleet_kw.setdefault("chip_ids", [f"chip-{i}" for i in range(n)])
    fleet_kw.setdefault("hang_timeout_s", None)
    return Fleet(
        [_disagg_engine(**(engine_kw or {})) for _ in range(n)],
        roles=roles, **fleet_kw,
    )


def _disagg_prompts(seed, n, lo=4, hi=24, new_lo=3, new_hi=12):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        plen = int(rng.integers(lo, hi))
        prompt = [int(t) for t in rng.integers(0, CONFIG.vocab_size, plen)]
        out.append((prompt, int(rng.integers(new_lo, new_hi))))
    return out


def _disagg_assert_no_leaks(fleet):
    for rep in fleet.replicas:
        if rep.state == DEAD:
            continue
        e = rep.engine
        assert not e._occupied.any(), rep.index
        assert e._committed_pages == 0, rep.index
        pinned = e.prefix.cached_pages if e.prefix is not None else 0
        assert e.ctrl.used_pages == pinned, rep.index
        assert not rep.rids, rep.index


# ---- validation ----------------------------------------------------------


def test_roles_validation():
    with pytest.raises(ValueError, match="roles"):
        _disagg_fleet(2, roles=["prefill"])  # length mismatch
    with pytest.raises(ValueError, match="roles"):
        _disagg_fleet(2, roles=["prefill", "verbs"])  # unknown role
    with pytest.raises(ValueError, match="wfq_weights"):
        _disagg_fleet(1, wfq_weights={"interactive": 0.0})
    fleet = _disagg_fleet(2, roles=["prefill", "decode"])
    assert fleet.roles() == {0: "prefill", 1: "decode"}
    assert fleet.disaggregated
    idx = fleet.add_replica(_disagg_engine(), "chip-2", role="decode")
    assert fleet.roles()[idx] == "decode"
    fleet.close()
    plain = _disagg_fleet(2)
    assert not plain.disaggregated
    assert plain.roles() == {0: "mixed", 1: "mixed"}
    plain.close()


# ---- the headline parity pin --------------------------------------------


def test_disagg_streams_bit_identical_to_mixed_and_oracle():
    """THE acceptance pin: the same seeded stream through a
    prefill/decode split fleet (WFQ armed) and an all-mixed fleet
    produces bit-identical greedy streams — and both match the dense
    oracle — while the split fleet actually hands off: tickets carry
    pages, decode replicas graft and reload them, and every handoff
    records its prefill-done -> first-decode-token window."""
    reqs = _disagg_prompts(3, 8, lo=9, hi=24)  # >= 2 full pages: pages move

    def run(roles, wfq=None):
        fleet = _disagg_fleet(3, roles, wfq_weights=wfq)
        for i, (p, nw) in enumerate(reqs):
            fleet.submit(p, nw, slo_class="interactive" if i % 2 else "bulk")
        streams = fleet.run()
        return streams, fleet

    mixed, mfleet = run(None)
    split, sfleet = run(
        ["prefill", "decode", "decode"],
        wfq={"interactive": 3.0, "bulk": 1.0},
    )
    assert split == mixed
    for rid, (p, nw) in zip(
        sorted(split, key=lambda r: int(r.split("-")[1])), reqs
    ):
        assert split[rid] == _oracle(p, nw), rid
    assert mfleet.kv_handoffs == 0
    assert sfleet.kv_handoffs == len(reqs)
    assert sfleet.handoff_pages > 0  # ticket pages actually grafted
    assert len(sfleet.handoff_s) == len(reqs)
    assert all(s > 0 for s in sfleet.handoff_s)
    # The prefill pool exported, the decode pool adopted + reloaded.
    assert sfleet.replicas[0].engine.kv_handoff_pages_out > 0
    decode_in = sum(
        sfleet.replicas[i].engine.kv_handoff_pages_in for i in (1, 2)
    )
    decode_reloads = sum(
        sfleet.replicas[i].engine.prefix.reloads for i in (1, 2)
    )
    assert decode_in > 0 and decode_reloads > 0
    # WFQ charged only fresh prompts, by class.
    assert sum(sfleet.wfq_dispatches.values()) == len(reqs)
    _disagg_assert_no_leaks(mfleet)
    _disagg_assert_no_leaks(sfleet)
    mfleet.close()
    sfleet.close()


def test_disagg_without_offload_degrades_bit_identical():
    """Roles on engines WITHOUT a prefix cache: export returns None,
    tickets ship empty, and the decode pool re-prefills — the split
    degrades to the replay path with identical tokens."""
    reqs = _disagg_prompts(5, 5)
    kw = dict(prefix_cache=False, kv_offload=False)
    mixed = _disagg_fleet(2, engine_kw=kw)
    split = _disagg_fleet(2, ["prefill", "decode"], engine_kw=kw)
    for p, nw in reqs:
        mixed.submit(p, nw)
    for p, nw in reqs:
        split.submit(p, nw)
    assert mixed.run() == split.run()
    assert split.kv_handoffs == len(reqs)
    assert split.handoff_pages == 0  # nothing to ship, still correct
    _disagg_assert_no_leaks(split)
    mixed.close()
    split.close()


def test_handoff_composes_with_budget_superstep_and_lora():
    """prefill_budget + superstep_k + a LoRA adapter on a split fleet:
    still bit-identical to the mixed fleet (the adapter salt rides the
    ticket)."""
    from workloads_torch.multi_lora import synthetic_adapters

    adapters = synthetic_adapters(CONFIG, 1, rank=2, seed=5, device="cpu")
    adapters = {"tenant": adapters["tenant-0"]}
    kw = dict(
        prompt_bucket=8, prefill_budget=8, superstep_k=2,
        adapters=adapters,
    )
    reqs = _disagg_prompts(7, 6, lo=9, hi=20)

    def run(roles):
        fleet = _disagg_fleet(2, roles, engine_kw=kw)
        for i, (p, nw) in enumerate(reqs):
            fleet.submit(p, nw, adapter="tenant" if i % 2 else None)
        out = fleet.run()
        _disagg_assert_no_leaks(fleet)
        fleet.close()
        return out

    assert run(None) == run(["prefill", "decode"])


# ---- lifecycle composition ----------------------------------------------


def _run_until_ticket(fleet, rid):
    """Step until the rid's handoff ticket sits in the router queue."""
    for _ in range(200):
        fleet.step()
        fr = fleet._reqs[rid]
        if fr.handoff is not None and any(q is fr for q in fleet.queue):
            return fr
    raise AssertionError("no handoff ticket appeared")


def test_cancel_mid_handoff():
    fleet = _disagg_fleet(2, ["prefill", "decode"])
    p, nw = _disagg_prompts(11, 1, lo=9)[0]
    rid = fleet.submit(p, nw)
    # A second stream keeps the fleet busy so cancel's surfacing step
    # has work to return.
    other = fleet.submit([5] * 10, 6)
    fr = _run_until_ticket(fleet, rid)
    assert fleet.cancel(rid)
    assert fr.status == "cancelled"
    assert fr.handoff is None  # the ticket's blobs freed with it
    assert rid not in fleet._handoff_at
    fleet.run()
    assert fleet._reqs[other].status == "ok"
    _disagg_assert_no_leaks(fleet)
    fleet.close()


def test_deadline_expires_mid_handoff():
    fleet = _disagg_fleet(2, ["prefill", "decode"])
    p, nw = _disagg_prompts(13, 1, lo=9)[0]
    rid = fleet.submit(p, nw, deadline_s=0.05)
    fr = _run_until_ticket(fleet, rid)
    import time as _time

    _time.sleep(0.06)
    fleet.run()
    assert fr.status == "expired"
    assert fr.handoff is None
    _disagg_assert_no_leaks(fleet)
    fleet.close()


def test_prefill_crash_after_export_ticket_survives():
    """The exporter dying AFTER the spill cannot strand the ticket:
    its blobs are host RAM, independent of the dead engine — the
    decode pool grafts them and the stream completes bit-identically."""
    fleet = _disagg_fleet(2, ["prefill", "decode"])
    p, nw = _disagg_prompts(17, 1, lo=9, new_lo=6)[0]
    rid = fleet.submit(p, nw)
    fr = _run_until_ticket(fleet, rid)
    assert fr.handoff.blobs  # the ticket really carries pages
    fleet._fail_replica(
        fleet.replicas[0], RuntimeError("injected"), "crash"
    )
    assert fleet.replicas[0].state == DEAD
    fleet.run()
    assert fr.status == "ok"
    assert fr.tokens == _oracle(p, nw)
    assert fleet.replicas[1].engine.kv_handoff_pages_in > 0
    _disagg_assert_no_leaks(fleet)
    fleet.close()


def test_decode_pool_death_degrades_to_mixed_dispatch():
    """A dead decode pool must not strand tickets OR fresh prompts:
    dispatch degrades to the surviving prefill replica as mixed — the
    budget cap lifts (no live handoff target), streams complete
    bit-identically."""
    fleet = _disagg_fleet(2, ["prefill", "decode"])
    reqs = _disagg_prompts(19, 4, lo=9, new_lo=5)
    rids = [fleet.submit(p, nw) for p, nw in reqs]
    fleet._fail_replica(
        fleet.replicas[1], RuntimeError("injected"), "crash"
    )
    fleet.run()
    for rid, (p, nw) in zip(rids, reqs):
        fr = fleet._reqs[rid]
        assert fr.status == "ok", (rid, fr.error)
        assert fr.tokens == _oracle(p, nw)
    # No handoffs happened: the cap only arms with a live target.
    assert fleet.kv_handoffs == 0
    _disagg_assert_no_leaks(fleet)
    fleet.close()


def test_decode_pool_death_after_ticket_still_serves_it():
    """The harder ordering: the ticket exists FIRST, then the whole
    decode pool dies — the ticketed continuation degrades back onto
    the prefill replica (its own index still holds the pages) and
    completes bit-identically."""
    fleet = _disagg_fleet(2, ["prefill", "decode"])
    p, nw = _disagg_prompts(23, 1, lo=9, new_lo=6)[0]
    rid = fleet.submit(p, nw)
    fr = _run_until_ticket(fleet, rid)
    fleet._fail_replica(
        fleet.replicas[1], RuntimeError("injected"), "crash"
    )
    fleet.run()
    assert fr.status == "ok"
    assert fr.tokens == _oracle(p, nw)
    _disagg_assert_no_leaks(fleet)
    fleet.close()


def test_supervisor_resurrects_pool_role():
    """A resurrected pool member rejoins ITS pool: the supervisor
    carries the dead slot's role through the respawn."""
    from workloads_torch.backoff import Backoff
    from workloads_torch.supervisor import FleetSupervisor

    fleet = _disagg_fleet(2, ["prefill", "decode"])
    factory, oracle = make_engine_factory(
        PARAMS, CONFIG, engine_kw=dict(
            slots=2, page_size=4, prompt_bucket=4,
            prefix_cache=True, kv_offload=True,
        ), probe=([1, 2, 3], 4),
    )
    sup = FleetSupervisor(
        fleet, factory,
        backoff=Backoff(base_s=1e-3, max_s=1e-3, jitter=0.0),
        probe=([1, 2, 3], 4), probe_oracle=oracle,
    )
    assert sup.slot_for("chip-0").role == "prefill"
    fleet._fail_replica(
        fleet.replicas[0], RuntimeError("injected"), "crash"
    )
    assert sup.wait_healed(30.0), sup.states()
    new_idx = sup.slot_for("chip-0").index
    assert fleet.replicas[new_idx].role == "prefill"
    fleet.close()


# ---- router load scoring (satellite) ------------------------------------


def test_load_weights_midprefill_backlog():
    """A parked mid-prefill row weighs its REMAINING prompt tokens in
    prompt-bucket units — a long prompt two chunks in no longer looks
    as cheap as a finishing decode row — and the router therefore
    routes the next prompt AWAY from the replica chewing a long
    prefill."""
    kw = dict(prompt_bucket=4, prefill_budget=4)
    fleet = _disagg_fleet(2, engine_kw=kw)
    long_prompt = [7] * 32  # 8 bucket-units of sweep work
    fleet.submit(long_prompt, 4)
    fleet.step()  # dispatch + first budgeted chunk; the rest parks
    rep0 = fleet.replicas[0]
    assert rep0.engine._inflight_prefill  # genuinely parked mid-prefill
    # 32 prompt tokens at budget 4/step: >= 6 bucket-units remain.
    assert rep0.load() >= 6
    # The old scalar would have said 1 — equal to one queued request —
    # and least-loaded would have tied; now the short prompt must land
    # on the idle replica.
    rid2 = fleet.submit([9] * 4, 3)
    fleet.step()
    fr2 = fleet._reqs[rid2]
    assert fr2.replica == 1 or fr2.status == "ok"
    assert rid2 in fleet.replicas[1].rids or fr2.status == "ok"
    fleet.run()
    _disagg_assert_no_leaks(fleet)
    fleet.close()


def test_heterogeneous_page_size_split_fleet_stays_oracle_true():
    """A split fleet whose pools disagree on page_size: every handoff
    ticket is refused at import (shape guard) and the continuation
    re-prefills — streams still bit-identical to the oracle."""
    engines = [
        _disagg_engine(page_size=8, prompt_bucket=8),
        _disagg_engine(page_size=4, prompt_bucket=4),
    ]
    fleet = Fleet(
        engines, chip_ids=["chip-0", "chip-1"], hang_timeout_s=None,
        roles=["prefill", "decode"],
    )
    reqs = _disagg_prompts(37, 4, lo=9, new_lo=4)
    rids = [fleet.submit(p, nw) for p, nw in reqs]
    fleet.run()
    for rid, (p, nw) in zip(rids, reqs):
        fr = fleet._reqs[rid]
        assert fr.status == "ok"
        assert fr.tokens == _oracle(p, nw)
    assert fleet.kv_handoffs == len(reqs)
    assert fleet.handoff_pages == 0  # every graft refused, none wedged
    _disagg_assert_no_leaks(fleet)
    fleet.close()


def test_handoff_ticket_survives_engine_closed_race():
    """A decode replica closing between the dispatchable check and the
    submit must NOT consume the ticket: the requeued request keeps it
    for the next dispatch onto a live replica."""
    from workloads_torch.errors import EngineClosed

    fleet = _disagg_fleet(2, ["prefill", "decode"])
    p, nw = _disagg_prompts(41, 1, lo=9, new_lo=6)[0]
    rid = fleet.submit(p, nw)
    fr = _run_until_ticket(fleet, rid)
    ticket = fr.handoff
    pages0 = fleet.handoff_pages
    fleet.replicas[1].engine.close()  # dies under the router
    with pytest.raises(EngineClosed):
        fleet._dispatch_to(fr, fleet.replicas[1])
    assert fr.handoff is ticket  # still attached
    assert fleet.handoff_pages == pages0  # nothing counted as served
    fleet.close()


def test_load_requests_keeps_request_units():
    """The autoscaler's depth signal reads load_requests() — one unit
    per request regardless of prompt length — while the router's
    load() weighs mid-prefill backlog; one long prompt must never read
    as dozens of queued requests to the scaling loop."""
    kw = dict(prompt_bucket=4, prefill_budget=4)
    fleet = _disagg_fleet(1, engine_kw=kw)
    fleet.submit([7] * 32, 4)
    fleet.step()
    rep = fleet.replicas[0]
    assert rep.load() >= 6  # router: bucket-weighted
    assert rep.load_requests() == 1  # autoscaler: request-count
    fleet.run()
    fleet.close()


# ---- WFQ (tentpole) ------------------------------------------------------


def _fr(rid, cls, prompt_len=4, tokens=()):
    fr = FleetRequest(
        rid, [1] * prompt_len, 8, None, slo_class=cls,
    )
    fr.tokens = list(tokens)
    return fr


def test_wfq_orders_by_weight_and_respects_continuations():
    fleet = _disagg_fleet(1, wfq_weights={"a": 3.0, "b": 1.0})
    fresh = [_fr(f"a{i}", "a") for i in range(4)] + [
        _fr(f"b{i}", "b") for i in range(4)
    ]
    cont = [_fr("c0", "b", tokens=[5])]
    order = [fr.rid for fr in fleet._wfq_order(cont + fresh)]
    # Continuations first; then finish-tag order: 'a' (weight 3) takes
    # 3 of the first 4 slots, 'b' lands at its virtual finish of 1.
    assert order[0] == "c0"
    assert order[1:] == ["a0", "a1", "a2", "b0", "a3", "b1", "b2", "b3"]
    # Finish tags weigh COST against weight: a 4-bucket 'a' prompt
    # finishes at 4/3, so the 1-bucket 'b' (finish 1) beats it to the
    # first slot DESPITE 'a' holding 3x the weight — and 'a' still
    # beats b1 (finish 2).
    big = [_fr(f"A{i}", "a", prompt_len=16) for i in range(2)] + [
        _fr(f"B{i}", "b") for i in range(2)
    ]
    order2 = [fr.rid for fr in fleet._wfq_order(big)]
    assert order2 == ["B0", "A0", "B1", "A1"]
    fleet.close()


def test_wfq_idle_class_banks_no_credit():
    """A class that idled while another was served re-enters at the
    CURRENT virtual time — it cannot monopolize dispatch to 'catch
    up' on credit it never queued for."""
    fleet = _disagg_fleet(1, wfq_weights={"a": 1.0, "b": 1.0})
    for i in range(6):  # six one-dispatch batches, as the loop would run
        fleet._wfq_charge(_fr(f"a{i}", "a"), fleet._wfq_v)
        fleet._wfq_v = fleet._wfq_vtime["a"]
    assert fleet._wfq_vtime["a"] == pytest.approx(6.0)
    order = [
        fr.rid for fr in fleet._wfq_order(
            [_fr("b0", "b"), _fr("a6", "a"), _fr("b1", "b")]
        )
    ]
    # 'b' starts at v_now (not 0), so it alternates instead of draining
    # every 'b' before 'a' gets another slot.
    assert order == ["a6", "b0", "b1"] or order == ["b0", "a6", "b1"]
    fleet.close()


def test_wfq_dispatch_split_on_one_replica():
    """End-to-end: a starved 1-replica fleet under WFQ serves the
    heavy class ~3x as often among the first dispatches, and every
    stream still finishes ok with oracle tokens."""
    fleet = _disagg_fleet(
        1, engine_kw=dict(slots=1), wfq_weights={"hi": 3.0, "lo": 1.0},
        slo_classes=None,
    )
    # slo classes: reuse defaults for validation; tag via wfq-only
    # classes is fine — wfq_weights classes need not be SLO classes.
    reqs = _disagg_prompts(29, 8, lo=4, hi=8, new_lo=2, new_hi=4)
    rids = []
    for i, (p, nw) in enumerate(reqs):
        rids.append(fleet.submit(
            p, nw, slo_class="interactive" if i < 4 else "bulk",
        ))
    fleet.wfq_weights = {"interactive": 3.0, "bulk": 1.0}
    fleet.run()
    assert fleet.wfq_dispatches["interactive"] == 4
    assert fleet.wfq_dispatches["bulk"] == 4
    for rid, (p, nw) in zip(rids, reqs):
        assert fleet._reqs[rid].tokens == _oracle(p, nw)
    _disagg_assert_no_leaks(fleet)
    fleet.close()


# ---- per-class traffic (satellite) --------------------------------------


def test_schedule_per_class_deterministic_and_independent():
    gen = TrafficGen(
        seed=5, rate_rps=50.0, class_mix=(("interactive", 3.0), ("bulk", 1.0)),
    )
    a = gen.schedule_per_class(16)
    b = gen.schedule_per_class(16)
    assert a == b  # deterministic per seed
    # Reordering the mix cannot move a token of either class.
    flipped = dataclasses.replace(
        gen, class_mix=(("bulk", 1.0), ("interactive", 3.0)),
    )
    assert flipped.schedule_per_class(16) == a
    # Each class's sub-stream IS its standalone process at its share.
    import zlib

    share = 3.0 / 4.0
    solo = dataclasses.replace(
        gen,
        seed=(gen.seed << 16) ^ zlib.crc32(b"interactive"),
        rate_rps=gen.rate_rps * share,
    ).schedule(12)  # round(16 * 0.75)
    sub = [(t, p, n) for t, p, n, c in a if c == "interactive"]
    assert sorted(sub) == sorted(solo)
    # And the class draw is genuinely per-process: bulk arrivals exist.
    stats = TrafficGen.schedule_stats(a)
    assert stats["class_counts"] == {"bulk": 4, "interactive": 12}
    assert set(stats["class_mean_rps"]) == {"bulk", "interactive"}
    assert all(
        r is None or 0 < r < 1e6
        for r in stats["class_mean_rps"].values()
    )
    # A single-arrival class has no span: its rate reads None, not
    # the absurd 1/epsilon.
    one = TrafficGen.schedule_stats([(0.5, [1], 2, "solo")])
    assert one["class_mean_rps"] == {"solo": None}
    with pytest.raises(ValueError, match="class_mix"):
        dataclasses.replace(gen, class_mix=()).schedule_per_class(4)


# ---- smoke for make disagg-check ----------------------------------------


def test_disagg_check_smoke():
    """ONE seeded two-pool round — the `make disagg-check` tripwire:
    a prefill+decode split serves a seeded stream bit-identically to
    the mixed fleet AND the dense oracle, with real page movement
    (export -> graft -> reload), every handoff window recorded, and no
    page/slot leaks on either pool."""
    reqs = _disagg_prompts(31, 6, lo=9, hi=24, new_lo=4)

    def run(roles):
        fleet = _disagg_fleet(2, roles, wfq_weights=(
            {"interactive": 3.0, "bulk": 1.0} if roles else None
        ))
        for i, (p, nw) in enumerate(reqs):
            fleet.submit(p, nw, slo_class="interactive" if i % 2 else "bulk")
        streams = fleet.run()
        _disagg_assert_no_leaks(fleet)
        return streams, fleet

    mixed, mf = run(None)
    split, sf = run(["prefill", "decode"])
    assert split == mixed
    for rid, (p, nw) in zip(
        sorted(split, key=lambda r: int(r.split("-")[1])), reqs
    ):
        assert split[rid] == _oracle(p, nw)
    assert sf.kv_handoffs == len(reqs)
    assert sf.handoff_pages > 0
    assert len(sf.handoff_s) == len(reqs)
    assert sf.replicas[1].engine.prefix.grafts > 0
    assert sf.replicas[1].engine.prefix.reloads > 0
    mf.close()
    sf.close()


# ==== tests/test_durable.py
# ---- session journal -----------------------------------------------------


def test_journal_rotation_and_epochs_survive_restart(tmp_path):
    """Epochs are monotonic ACROSS writers (the kvsched claim-epoch
    discipline): a fresh-process journal over the same directory can
    never stamp an epoch a reader has already seen."""
    j1 = SessionJournal(str(tmp_path))
    assert j1.write([{"rid": "a"}]) == 0
    assert j1.write([{"rid": "a"}, {"rid": "b"}]) == 1
    records, reason = j1.load()
    assert reason == "ok" and [r["rid"] for r in records] == ["a", "b"]
    # The previous generation is the FIRST write, kept beside it.
    assert os.path.exists(j1.prev_path)
    j2 = SessionJournal(str(tmp_path))  # "fresh process"
    assert j2.write([{"rid": "c"}]) == 2
    assert j2.load()[0] == [{"rid": "c"}]


def test_journal_torn_write_falls_back_one_generation(tmp_path):
    inj = FaultInjector({"journal_torn_write": 2})
    j = SessionJournal(str(tmp_path), injector=inj)
    j.write([{"rid": "good"}])
    j.write([{"rid": "torn"}])  # crossing 2: dies mid-write
    assert j.writes == 1 and j.torn_writes == 1
    records, reason = j.load()
    assert reason == "fallback" and records == [{"rid": "good"}]


def test_journal_absent_and_doubly_corrupt(tmp_path):
    j = SessionJournal(str(tmp_path))
    assert j.load() == (None, "absent")
    j.write([{"rid": "x"}])
    j.write([{"rid": "y"}])
    for path in (j.path, j.prev_path):
        with open(path, "w", encoding="utf-8") as f:
            f.write('{"version": 1, "records"')  # torn prefix
    assert j.load() == (None, "corrupt")


# ---- restart bit-identity ------------------------------------------------


def _reqs():
    """The bench arm's shape at test scale: a shared system template
    (the disk tier dedups it) + per-request tails, budgets staggered so
    a 3-step kill lands genuinely mid-stream."""
    # numpy draws stand in for the JAX test's jax.random ones (the port
    # has no threefry); the shape of the stream is the same.
    rng = np.random.default_rng(23)
    prefix = [int(t) for t in rng.integers(0, CONFIG.vocab_size, 8)]
    reqs = []
    for i in range(4):
        tail = [int(t) for t in rng.integers(0, CONFIG.vocab_size, 1 + i % 4)]
        reqs.append((prefix + tail, 13 - (i * 4) % 8))
    return reqs


def _mk_fleet(params, root):
    """Two-replica fleet; ``root=None`` builds the durability-off
    oracle (no disk tier, no journal — the pay-for-what-you-use pin is
    that its streams are the reference)."""
    durable = root is not None
    engines = [
        ServeEngine(
            params, CONFIG, slots=2, page_size=4, chunk=4,
            prompt_bucket=4, pipelined=True, n_pages=14,
            prefix_cache=True,
            kv_offload=durable,
            kv_host_pages=28 if durable else None,
            kv_disk_dir=os.path.join(root, "kv") if durable else None,
        )
        for _ in range(2)
    ]
    return Fleet(
        engines, chip_ids=["chip-0", "chip-1"], hang_timeout_s=60.0,
        journal_dir=os.path.join(root, "journal") if durable else None,
    )


def test_durable_check_smoke(tmp_path):
    """The acceptance pin, end to end: kill a journaled fleet
    mid-stream, rebuild a FRESH fleet from nothing but the journal +
    per-page disk files, and every restored stream must be
    bit-identical to the uninterrupted durability-OFF oracle — then
    fresh submissions keep working (the rid counter fast-forwarded
    past every restored rid)."""
    params = init_params(CONFIG, prng.PRNGKey(0, device="cpu"))
    reqs = _reqs()

    oracle = _mk_fleet(params, None)
    rids = [oracle.submit(p, n) for p, n in reqs]
    oracle.run()
    done = {fr.rid: fr for fr in oracle.drain_completed()}
    assert {done[r].status for r in rids} == {"ok"}
    ref = [list(done[r].tokens) for r in rids]
    oracle.close()

    root = str(tmp_path)
    fleet = _mk_fleet(params, root)
    rids = [fleet.submit(p, n) for p, n in reqs]
    with fleet._lock:
        for _ in range(3):  # mid-stream, then the process "dies"
            if not fleet.idle:
                fleet.step()
    fleet.close()  # journals live sessions before going dark
    assert fleet.journal_writes >= 1
    assert os.listdir(os.path.join(root, "kv"))  # pages parked on disk

    fleet2 = _mk_fleet(params, root)
    restored = fleet2.restore()
    assert restored == len(reqs) and fleet2.sessions_restored == restored
    # The kill must land genuinely mid-stream, or this test silently
    # degrades to restoring completed sessions.
    assert sum(1 for fr in fleet2.queue if fr.tokens) >= 1
    assert fleet2.tokens_replayed > 0
    fleet2.run()
    done = {fr.rid: fr for fr in fleet2.drain_completed()}
    assert [list(done[r].tokens) for r in rids] == ref

    # Fresh work composes: no rid collision with the resurrected ones.
    fresh = fleet2.submit(reqs[0][0], 2)
    assert fresh not in rids
    fleet2.run()
    tokens, done, status = fleet2.poll(fresh)
    assert done and status == "ok" and len(tokens) == 2
    fleet2.close()


def test_restore_is_boot_time_only_and_cold_start_is_zero(tmp_path):
    params = init_params(CONFIG, prng.PRNGKey(0, device="cpu"))
    fleet = _mk_fleet(params, str(tmp_path))
    assert fleet.restore() == 0  # absent journal: cold start, no raise
    fleet.submit([1, 2, 3], 2)
    with pytest.raises(RuntimeError, match="boot-time"):
        fleet.restore()
    fleet.close()


def test_completed_sessions_restore_as_history_without_redispatch(tmp_path):
    """Terminal journal records come back pollable with their exact
    tokens but move no terminal counters (they were the dead process's
    work); a journaled-complete live stream finishes without a single
    new dispatch."""
    params = init_params(CONFIG, prng.PRNGKey(0, device="cpu"))
    reqs = _reqs()
    root = str(tmp_path)
    fleet = _mk_fleet(params, root)
    rids = [fleet.submit(p, n) for p, n in reqs]
    fleet.run()  # everything completes, THEN the process dies
    ref = {r: fleet.poll(r)[0] for r in rids}
    fleet.close()

    fleet2 = _mk_fleet(params, root)
    assert fleet2.restore() == len(reqs)
    for r in rids:
        tokens, done, status = fleet2.poll(r)
        assert done and status == "ok" and tokens == ref[r]
    assert not fleet2.queue  # nothing left to dispatch...
    assert fleet2.generated_tokens == 0  # ...and nothing re-decoded
    fleet2.close()


# ==== tests/test_serve_fuzz.py (renamed here: TERMINAL -> SERVE_FUZZ_TERMINAL, _run_fleet_chaos -> _serve_fuzz_run_fleet_chaos)
DRAFT_CONFIG = ModelConfig(
    max_seq_len=64, n_layers=1, d_model=32, n_heads=2, d_ff=64,
    dtype=torch.float32,
)


def _assert_kv_reclaimed(engine, seed, kw) -> None:
    """close() must reclaim EVERY page the KV hierarchy holds: resident
    cache pins release to the pool and offloaded host pages drop with
    the index that owns them — the no-leak contract for the offload
    tier (cancel/deadline/quarantine paths exercise the same clear()
    seam mid-run)."""
    engine.close()
    assert engine.ctrl.used_pages == 0, (seed, kw)
    if engine.prefix is not None:
        assert engine.prefix.cached_pages == 0, (seed, kw)
        assert getattr(engine.prefix, "offloaded_pages", 0) == 0, (seed, kw)


# ---- fault-tolerance chaos arm ------------------------------------------
#
# Randomized cancels, deadlines and injected seam faults interleaved with
# normal traffic (spec="auto" included), asserting the lifecycle
# invariants: every accepted rid reaches EXACTLY one terminal status, no
# page/slot/commitment leak survives the stream, and every emitted token
# is a true prefix of the dense reference's greedy stream — replays after
# a quarantine are bit-identical, so even a request that faulted twice
# must finish with the uninterrupted stream.  Greedy-only: sampled
# replays are distributionally (not bitwise) equivalent, so they have no
# pathwise oracle.  Deterministic seeds — failures reproduce.

SERVE_FUZZ_TERMINAL = {"ok", "cancelled", "expired", "failed"}


# ---- fleet chaos arm -----------------------------------------------------
#
# Randomized replica crashes/hangs/slow-steps, health drains, live
# drains/adds/removes and cancels/deadlines interleaved with open-loop
# traffic across N=2..4 replicas (per-engine seam faults riding along),
# asserting the fleet-scope lifecycle invariants: every accepted rid
# reaches EXACTLY one terminal status fleet-wide, completed greedy
# streams are bit-identical to the single-engine dense oracle THROUGH
# cross-replica failover replays, interrupted streams are true
# prefixes, and no surviving replica leaks a slot/page/commitment.
# Deterministic seeds — failures reproduce.


def _serve_fuzz_run_fleet_chaos(seed: int, params, adapters) -> None:
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="fuzz-durable-")
    try:
        _run_fleet_chaos_impl(seed, params, adapters, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _run_fleet_chaos_impl(seed: int, params, adapters, root: str) -> None:
    import os

    from tpu_device_plugin.api.constants import HEALTHY, UNHEALTHY
    from tpu_device_plugin.device import HealthEvent
    from workloads_torch.errors import QueueFull
    from workloads_torch.faults import REPLICA_SEAMS, FaultInjector
    from workloads_torch.fleet import DEAD, Fleet

    rng = np.random.default_rng(seed + 77000)
    n = int(rng.integers(2, 5))
    use_adapters = bool(rng.integers(2))
    # Durable sessions under chaos (workloads/durable.py): on half the
    # seeds the fleet journals sessions (replicas with kv_offload also
    # share one --kv-disk-dir, durable seams riding the per-engine
    # injectors) and a SCHEDULED process restart lands mid-loop — the
    # fleet is torn down, a FRESH one rebuilt from nothing but the
    # journal + disk pages, and the same seeded stream continues.  All
    # the oracle pins below then hold ACROSS process death.
    durable = bool(rng.integers(2))
    journal_dir = os.path.join(root, "journal") if durable else None
    restart_at = int(rng.integers(3, 10)) if durable else None
    fleet_inj = FaultInjector.random(
        seed=seed, rate=0.03, seams=REPLICA_SEAMS,
        max_fires=int(rng.integers(1, n)),  # >= 1 replica always survives
    )
    engines = []
    engine_kws = []  # the restart rebuilds the same replica shapes
    for i in range(n):
        kw = dict(
            slots=int(rng.integers(1, 3)),
            page_size=int(rng.choice([4, 8])),
            prefix_cache=bool(rng.integers(2)),
            pipelined=bool(rng.integers(2)),
        )
        # The KV handoff's transfer fabric (disaggregated fleets
        # export/graft through the host tier when armed; degrade to
        # replay re-prefill when not — both must stay oracle-true).
        if kw["prefix_cache"] and rng.integers(2):
            kw["kv_offload"] = True
            if durable:
                # One shared directory — chain-key filenames make the
                # sharing the dedup, including across the restart.
                kw["kv_disk_dir"] = os.path.join(root, "kv")
        kw["prompt_bucket"] = int(kw["page_size"] * rng.choice([2, 3]))
        if rng.integers(2):
            kw["prefill_budget"] = int(
                rng.choice([1, kw["prompt_bucket"]])
            )
        engine_kws.append(kw)
        engines.append(ServeEngine(
            params, CONFIG,
            adapters=adapters if use_adapters else None,
            fault_injector=(
                # Default seams, so kv_disk_write_fail /
                # kv_disk_read_corrupt degrade paths fire under chaos.
                FaultInjector.random(
                    seed=seed * 13 + i, rate=0.02, max_fires=2
                ) if rng.integers(2) else None
            ),
            max_retries=2, **kw,
        ))
    # Fast-start snapshots under chaos (workloads_torch/faststart.py): on
    # half the seeds every engine is primed with a snapshot captured
    # from replica 0 — heterogeneous per-replica configs mean some
    # primes legitimately REJECT (fingerprint mismatch → cold path);
    # either way the oracle pins below assert streams are unchanged.
    if rng.integers(2):
        from workloads_torch.faststart import EngineSnapshot

        snap = EngineSnapshot.capture(engines[0])
        for eng in engines:
            snap.prime(eng)
    # Fleet-scope chip-time ledger under chaos (workloads/ledger.py):
    # per-replica ledgers + the fleet roll-up, randomized on — the
    # failover/cancel/handoff taxonomy must still balance fleet-wide
    # at the bottom (and the oracle pins below imply inertness).  Not
    # under the scheduled restart: the ledger is per-process state, so
    # a mid-run teardown legitimately splits its books.
    fleet_ledger = None
    if rng.integers(2) and not durable:
        from workloads_torch.ledger import ChipTimeLedger, FleetLedger

        fleet_ledger = FleetLedger()
        for i, eng in enumerate(engines):
            eng.ledger = ChipTimeLedger(name=str(i))
    # Disaggregated prefill/decode pools on half the seeds: random
    # per-replica roles (any combination is legal — a missing pool
    # degrades to mixed dispatch), so crashes/hangs/health drains land
    # on exporters mid-handoff, on decode pools holding tickets, and
    # on degenerate all-prefill fleets alike.
    roles = None
    if rng.integers(2):
        roles = [
            str(rng.choice(["prefill", "decode", "mixed"]))
            for _ in range(n)
        ]
    max_pending = int(rng.choice([4, 32]))
    page_sched = bool(rng.integers(2))
    fleet = Fleet(
        engines, chip_ids=[f"chip-{i}" for i in range(n)],
        fault_injector=fleet_inj, max_failovers=2, slow_readback_s=0.0,
        # Injected replica_hang gives deterministic hang coverage; the
        # wall-clock watchdog would turn host-load-dependent XLA compile
        # times into nondeterministic replica kills.
        hang_timeout_s=None,
        max_pending=max_pending,
        roles=roles,
        ledger=fleet_ledger,
        # Page-granular dispatch on half the seeds: placement may move,
        # tokens must not (the kvsched degrade contract under chaos).
        page_scheduling=page_sched,
        journal_dir=journal_dir,
        journal_every=int(rng.choice([2, 5])) if durable else None,
    )
    # Goodput controller riding the fleet chaos (workloads/control.py):
    # randomized ON whenever the fleet ledger is armed (so never across
    # the scheduled restart — the controller, like the ledger, is
    # per-process state).  These draftless superstep-1 replicas give it
    # nothing to retune, which is itself the pin: the control loop
    # polls through failovers, health drains and live resizes without
    # actuating, and every oracle below holds bit-identically —
    # attach-but-inert is free under chaos.
    controller = None
    if fleet_ledger is not None and rng.integers(2):
        from workloads_torch.backoff import Backoff
        from workloads_torch.control import GoodputController

        instant = Backoff(base_s=1e-6, max_s=1e-6, jitter=0.0)
        controller = GoodputController(
            fleet, min_sample_tokens=16,
            retune_backoff=instant, wfq_backoff=instant,
        )
    names = [None] + (sorted(adapters) if use_adapters else [])
    expected = {}
    terminal_frs: dict = {}  # rid -> FleetRequest (survives the restart)
    pending_submits = []
    for _ in range(int(rng.integers(5, 10))):
        plen = int(rng.integers(1, 25))
        prompt = [int(t) for t in rng.integers(0, CONFIG.vocab_size, plen)]
        new = int(rng.integers(2, min(24, CONFIG.max_seq_len - plen) + 1))
        adapter = names[int(rng.integers(len(names)))]
        deadline = 0.05 if rng.integers(6) == 0 else None
        pending_submits.append((prompt, new, adapter, deadline))
    merged_cache: dict = {}

    def model_for(adapter):
        if adapter is None:
            return params
        if adapter not in merged_cache:
            merged_cache[adapter] = merge_lora(
                params, adapters[adapter], dtype=torch.float32
            )
        return merged_cache[adapter]

    terminal: dict[str, str] = {}
    steps = 0
    added = False
    while pending_submits or not fleet.idle:
        steps += 1
        assert steps < 900, (seed, fleet.states(), "failed to converge")
        # Open-loop-ish trickle: a couple of submissions per step.
        for _ in range(min(len(pending_submits), int(rng.integers(1, 3)))):
            prompt, new, adapter, deadline = pending_submits.pop()
            sess = f"s{int(rng.integers(3))}" if rng.integers(2) else None
            try:
                rid = fleet.submit(
                    prompt, new, adapter=adapter, deadline_s=deadline,
                    session=sess,
                )
            except QueueFull:
                continue
            expected[rid] = (prompt, new, adapter)
        live = [r for r in expected if r not in terminal]
        if live and rng.integers(10) == 0:
            fleet.cancel(str(rng.choice(live)))
        if rng.integers(15) == 0:
            alive = fleet.alive
            if len(alive) > 1:
                fleet.deliver_health([HealthEvent(
                    chip_id=alive[int(rng.integers(len(alive)))].chip_id,
                    health=UNHEALTHY,
                )])
        if rng.integers(15) == 0:
            fleet.deliver_health([
                HealthEvent(chip_id="", health=HEALTHY)
            ])
        if rng.integers(20) == 0:
            drainable = [
                r.index for r in fleet.replicas if r.state == "active"
            ]
            if len(drainable) > 1:
                fleet.drain(int(rng.choice(drainable)))
        if not added and rng.integers(25) == 0:
            fleet.add_replica(ServeEngine(
                params, CONFIG, slots=2, page_size=4, prompt_bucket=8,
                adapters=adapters if use_adapters else None,
            ), chip_id=f"chip-{n}")
            added = True
        for fr in (
            controller.step() if controller is not None
            else fleet.step()
        ):
            assert fr.rid not in terminal, (seed, fr.rid, "double terminal")
            assert fr.status in SERVE_FUZZ_TERMINAL, (seed, fr.rid, fr.status)
            terminal[fr.rid] = fr.status
            terminal_frs[fr.rid] = fr
        if restart_at is not None and steps >= restart_at:
            # The scheduled process death: close() journals live
            # sessions, then a FRESH fleet (same replica shapes, empty
            # pools, empty radix) is rebuilt from what survived on
            # disk and the SAME seeded stream continues.  Terminal
            # non-ok rids are deliberately absent from the journal
            # (nothing to resume) — `terminal_frs` keeps their streams
            # for the oracle pins below; every still-live rid must
            # terminalize exactly once in the new process, or the
            # one-terminal-per-rid / set-equality asserts fail.
            restart_at = None
            fleet.close()
            engines = [
                ServeEngine(
                    params, CONFIG,
                    adapters=adapters if use_adapters else None,
                    max_retries=2, **kw,
                )
                for kw in engine_kws
            ]
            fleet = Fleet(
                engines, chip_ids=[f"chip-{i}" for i in range(n)],
                max_failovers=2, slow_readback_s=0.0,
                hang_timeout_s=None, max_pending=max_pending,
                roles=roles, page_scheduling=page_sched,
                journal_dir=journal_dir,
            )
            fleet.restore()
            added = True  # chip-n may exist; don't re-add post-restart
    assert set(terminal) == set(expected), (
        seed, set(expected) ^ set(terminal),
    )
    for rid, (prompt, new, adapter) in expected.items():
        fr = fleet._reqs.get(rid) or terminal_frs[rid]
        ref = [int(t) for t in np.asarray(generate(
            model_for(adapter), torch.tensor([prompt]), CONFIG,
            max_new_tokens=new,
        )[0])]
        if terminal[rid] == "ok":
            # Bit-identical through cross-replica failover replays.
            assert fr.tokens == ref, (seed, rid, fr.failovers, fr.segments)
        else:
            assert fr.tokens == ref[: len(fr.tokens)], (
                seed, rid, terminal[rid],
            )
    for rep in fleet.replicas:
        if rep.state == DEAD:
            continue
        e = rep.engine
        assert not e._occupied.any(), (seed, rep.index)
        assert e._committed_pages == 0, (seed, rep.index)
        assert not e._groups, (seed, rep.index)
        pinned = e.prefix.cached_pages if e.prefix is not None else 0
        assert e.ctrl.used_pages == pinned, (seed, rep.index)
        assert not rep.rids, (seed, rep.index)
    if fleet_ledger is not None:
        # Every rid terminal fleet-wide, so the roll-up must be fully
        # classified: goodput + waste == all charged device work, with
        # goodput cross-checked against the ok streams.
        verdict = fleet_ledger.reconcile(expect_quiescent=True)
        assert verdict["ok"], (seed, verdict)
        ok_tokens = sum(
            len(r.tokens) for r in fleet.completed if r.status == "ok"
        )
        assert fleet_ledger.goodput_tokens == ok_tokens, (seed, verdict)
    if controller is not None:
        assert controller.polls == steps, (seed, controller.states())
        # Nothing here is retunable (no drafts, superstep ceilings at
        # 1): the control loop must have observed without actuating.
        assert controller.retunes_applied == 0, (seed, controller.states())
    fleet.close()


def test_fleet_chaos_fuzz():
    params = init_params(CONFIG, prng.PRNGKey(0, device="cpu"))
    adapters = synthetic_adapters(CONFIG, 2, rank=4, scale=0.3, seed=3, device="cpu")
    for seed in range(4):
        _serve_fuzz_run_fleet_chaos(seed, params, adapters)


# ---- supervised (self-healing) fleet chaos arm ---------------------------
#
# The fleet chaos arm with the FleetSupervisor armed: randomized replica
# crashes/hangs (and, on some seeds, scripted repeat-crash-on-restart
# respawn schedules) interleaved with cancels/deadlines/health events.
# The added contracts: the fleet CONVERGES BACK to full capacity without
# operator help (every non-quarantined slot serving; a scripted crash
# loop must instead quarantine its slot), resurrected replicas pass the
# bit-identical half-open probe before rejoining, and all the fleet
# invariants still hold — exactly one terminal status per rid, ok
# streams bit-identical to the dense oracle, interrupted streams true
# prefixes, no slot/page/commitment leak on any live replica.


def _run_supervised_chaos(seed: int, params, adapters) -> None:
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="fuzz-durable-sup-")
    try:
        _run_supervised_chaos_impl(seed, params, adapters, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _run_supervised_chaos_impl(seed: int, params, adapters, root) -> None:
    import os

    from tpu_device_plugin.api.constants import HEALTHY, UNHEALTHY
    from tpu_device_plugin.device import HealthEvent
    from workloads_torch.backoff import Backoff
    from workloads_torch.errors import QueueFull
    from workloads_torch.faults import FaultInjector, crash_loop_schedule
    from workloads_torch.fleet import DEAD, Fleet
    from workloads_torch.supervisor import QUARANTINED, FleetSupervisor

    rng = np.random.default_rng(seed + 91000)
    n = int(rng.integers(2, 5))
    use_adapters = bool(rng.integers(2))
    engine_kw = dict(
        slots=int(rng.integers(1, 3)),
        page_size=int(rng.choice([4, 8])),
        prefix_cache=bool(rng.integers(2)),
        pipelined=bool(rng.integers(2)),
        adapters=adapters if use_adapters else None,
    )
    engine_kw["prompt_bucket"] = int(
        engine_kw["page_size"] * rng.choice([2, 3])
    )
    # Durable sessions under supervision: on half the seeds the fleet
    # journals (the supervisor checkpoints on deaths + wall cadence),
    # kv_offload replicas share one disk dir via the engine factory,
    # and a SCHEDULED full-process restart (fresh fleet + fresh
    # supervisor from the journal) lands mid-loop — convergence and
    # every oracle pin below must hold across it.
    durable = bool(rng.integers(2))
    journal_dir = os.path.join(root, "journal") if durable else None
    restart_at = int(rng.integers(3, 12)) if durable else None
    if durable and engine_kw["prefix_cache"]:
        engine_kw["kv_offload"] = True
        engine_kw["kv_disk_dir"] = os.path.join(root, "kv")
    fleet_inj = FaultInjector.random(
        seed=seed, rate=0.03,
        seams=("replica_crash", "replica_hang"),
        # The injector can kill at most n-1 replicas in total, but the
        # supervisor keeps resurrecting — live capacity recovers anyway.
        max_fires=int(rng.integers(1, n)),
    )
    engines = [
        ServeEngine(params, CONFIG, **engine_kw) for _ in range(n)
    ]
    mppr = int(rng.choice([3, 16]))
    page_sched = bool(rng.integers(2))
    fleet = Fleet(
        engines, chip_ids=[f"chip-{i}" for i in range(n)],
        fault_injector=fleet_inj, max_failovers=2,
        hang_timeout_s=None,
        max_pending_per_replica=mppr,
        # Page-granular dispatch on half the seeds: supervised
        # resurrection must stay stream-invariant either way.
        page_scheduling=page_sched,
        journal_dir=journal_dir,
    )
    # Fast-start snapshot on half the seeds: the factory primes every
    # resurrection with warmed state captured from replica 0 (same
    # engine_kw, so the fingerprint matches) and the supervisor carries
    # it — respawn streams must stay bit-identical snapshot on/off.
    snapshot = None
    if rng.integers(2):
        from workloads_torch.faststart import EngineSnapshot

        snapshot = EngineSnapshot.capture(
            engines[0], probe=([1, 2, 3], 4),
        )
    factory, oracle = make_engine_factory(
        params, CONFIG, engine_kw=engine_kw, probe=([1, 2, 3], 4),
        snapshot=snapshot,
    )
    crash_loop = bool(rng.integers(2))

    def mk_sup(target, injector):
        return FleetSupervisor(
            target, factory,
            backoff=Backoff(base_s=1e-3, max_s=8e-3, jitter=0.0),
            probe=([1, 2, 3], 4), probe_oracle=oracle,
            snapshot=snapshot,
            crash_loop_k=3, crash_loop_window_s=60.0,
            fault_injector=injector,
            journal_every_s=1e-3 if durable else None,
        )

    sup = mk_sup(
        fleet,
        FaultInjector(crash_loop_schedule(2)) if crash_loop else None,
    )
    names = [None] + (sorted(adapters) if use_adapters else [])
    merged_cache: dict = {}

    def model_for(adapter):
        if adapter is None:
            return params
        if adapter not in merged_cache:
            merged_cache[adapter] = merge_lora(
                params, adapters[adapter], dtype=torch.float32
            )
        return merged_cache[adapter]

    pending_submits = []
    for _ in range(int(rng.integers(5, 10))):
        plen = int(rng.integers(1, 25))
        prompt = [int(t) for t in rng.integers(0, CONFIG.vocab_size, plen)]
        new = int(rng.integers(2, min(24, CONFIG.max_seq_len - plen) + 1))
        adapter = names[int(rng.integers(len(names)))]
        deadline = 0.05 if rng.integers(6) == 0 else None
        pending_submits.append((prompt, new, adapter, deadline))
    expected = {}
    terminal: dict[str, str] = {}
    terminal_frs: dict = {}  # rid -> FleetRequest (survives the restart)
    steps = 0
    while pending_submits or not fleet.idle:
        steps += 1
        assert steps < 1500, (seed, fleet.states(), "failed to converge")
        for _ in range(min(len(pending_submits), int(rng.integers(1, 3)))):
            prompt, new, adapter, deadline = pending_submits.pop()
            sess = f"s{int(rng.integers(3))}" if rng.integers(2) else None
            try:
                rid = fleet.submit(
                    prompt, new, adapter=adapter, deadline_s=deadline,
                    session=sess,
                )
            except QueueFull:
                continue  # capacity-aware shedding did its job
            expected[rid] = (prompt, new, adapter)
        live = [r for r in expected if r not in terminal]
        if live and rng.integers(10) == 0:
            fleet.cancel(str(rng.choice(live)))
        if rng.integers(15) == 0:
            alive = fleet.alive
            if len(alive) > 1:
                ev = HealthEvent(
                    chip_id=alive[int(rng.integers(len(alive)))].chip_id,
                    health=UNHEALTHY,
                )
                fleet.deliver_health([ev])
                sup.note_health([ev])  # the supervisor honors the mark
        if rng.integers(15) == 0:
            ev = HealthEvent(chip_id="", health=HEALTHY)
            fleet.deliver_health([ev])
            sup.note_health([ev])
        for fr in sup.step():
            assert fr.rid not in terminal, (seed, fr.rid, "double terminal")
            assert fr.status in SERVE_FUZZ_TERMINAL, (seed, fr.rid, fr.status)
            terminal[fr.rid] = fr.status
            terminal_frs[fr.rid] = fr
        if restart_at is not None and steps >= restart_at:
            # The scheduled full-process death: close() journals live
            # sessions, then a FRESH fleet AND supervisor rebuild from
            # the journal + disk pages and the same stream continues
            # (the dead process's quarantines/backoffs are gone with
            # it — slot history is process state, sessions are not).
            restart_at = None
            fleet.close()
            engines = [
                ServeEngine(params, CONFIG, **engine_kw)
                for _ in range(n)
            ]
            fleet = Fleet(
                engines, chip_ids=[f"chip-{i}" for i in range(n)],
                max_failovers=2, hang_timeout_s=None,
                max_pending_per_replica=mppr,
                page_scheduling=page_sched,
                journal_dir=journal_dir,
            )
            fleet.restore()
            sup = mk_sup(fleet, None)
    # Lift any lingering health marks so deferred resurrections can
    # proceed, then the fleet must converge BACK to full capacity.
    ev = HealthEvent(chip_id="", health=HEALTHY)
    fleet.deliver_health([ev])
    sup.note_health([ev])
    fleet.step()
    assert sup.wait_healed(30.0), (seed, sup.states(), fleet.states())
    serving = sum(1 for s in sup.slots if s.state == "serving")
    active = sum(1 for r in fleet.replicas if r.state == "active")
    assert active >= serving, (seed, sup.states(), fleet.states())
    if crash_loop and sup.crash_loops:
        # A scripted crash loop that actually tripped must have
        # quarantined its slot — quarantine IS the converged state.
        assert sup.quarantined, (seed, sup.states())
        for chip in sup.quarantined:
            slot = sup.slot_for(chip)
            assert slot.state == QUARANTINED and slot.index is None
    assert set(terminal) == set(expected), (
        seed, set(expected) ^ set(terminal),
    )
    for rid, (prompt, new, adapter) in expected.items():
        fr = fleet._reqs.get(rid) or terminal_frs[rid]
        ref = [int(t) for t in np.asarray(generate(
            model_for(adapter), torch.tensor([prompt]), CONFIG,
            max_new_tokens=new,
        )[0])]
        if terminal[rid] == "ok":
            # Bit-identical through failovers AND resurrections.
            assert fr.tokens == ref, (seed, rid, fr.failovers, fr.segments)
        else:
            assert fr.tokens == ref[: len(fr.tokens)], (
                seed, rid, terminal[rid],
            )
    for rep in fleet.replicas:
        if rep.state == DEAD:
            continue
        e = rep.engine
        assert not e._occupied.any(), (seed, rep.index)
        assert e._committed_pages == 0, (seed, rep.index)
        assert not e._groups, (seed, rep.index)
        pinned = e.prefix.cached_pages if e.prefix is not None else 0
        assert e.ctrl.used_pages == pinned, (seed, rep.index)
        assert not rep.rids, (seed, rep.index)
    fleet.close()


def test_supervised_fleet_chaos_fuzz():
    params = init_params(CONFIG, prng.PRNGKey(0, device="cpu"))
    adapters = synthetic_adapters(CONFIG, 2, rank=4, scale=0.3, seed=3, device="cpu")
    for seed in range(3):
        _run_supervised_chaos(seed, params, adapters)


# ==== the port's CLI: python -m workloads_torch.serve --fleet N


def test_cli_fleet_supervised_failover_trace_and_ledger(tmp_path, capsys):
    """``--fleet 2 --supervise`` with a replica crash: the supervisor
    heals the slot, the ledger reconciles, and the merged trace covers
    the resurrected replica's lane and validates."""
    from tools.trace_export import validate_file
    from workloads_torch.serve import main

    trace = tmp_path / "fleet.json"
    assert main([
        "--device", "cpu", "--requests", "8", "--slots", "2", "--prompt-len", "12",
        "--max-new-tokens", "10", "--temperature", "0", "--fleet", "2", "--supervise",
        "--inject-fault", "replica_crash:7", "--trace-out", str(trace),
        "--slo-mix", "interactive:2,bulk:1", "--ledger",
        "--postmortem-dir", str(tmp_path / "pm"),
    ]) == 0
    out = capsys.readouterr().out
    assert "failover: crashes=1" in out
    assert "selfheal: restarts=1" in out
    assert "reconcile_ok=True" in out
    assert "covering 3 replica lanes" in out
    assert "slo: " in out
    validate_file(str(trace))


def test_cli_fleet_roles_wfq_over_http_and_journal(tmp_path, capsys):
    from workloads_torch.serve import main

    argv = [
        "--device", "cpu", "--requests", "6", "--slots", "2", "--prompt-len", "12",
        "--max-new-tokens", "8", "--temperature", "0", "--fleet", "2",
        "--roles", "prefill,decode", "--kv-offload", "--wfq", "interactive:3,bulk:1",
        "--slo-mix", "interactive:2,bulk:1", "--http-port", "0",
        "--journal-dir", str(tmp_path / "j"), "--journal-every", "3",
    ]
    assert main(argv) == 0
    out = capsys.readouterr().out
    assert "SSE streams closed: statuses={'ok': 6}" in out
    assert "disagg: handoffs=" in out
    assert (tmp_path / "j" / "journal.json").exists()
    # The next start restores the journal before its own traffic.
    assert main(argv) == 0
    assert "journal restored:" in capsys.readouterr().out


def test_cli_fleet_autoscale_and_control(capsys):
    from workloads_torch.serve import main

    assert main([
        "--device", "cpu", "--requests", "6", "--slots", "2", "--prompt-len", "8",
        "--max-new-tokens", "8", "--temperature", "0", "--fleet", "1",
        "--autoscale", "1:2", "--control", "--ledger", "--supervise",
    ]) == 0
    out = capsys.readouterr().out
    assert "autoscaler armed: replicas in [1, 2]" in out
    assert "controller armed:" in out
    assert "autoscale: ups=" in out and "control: retunes=" in out


@pytest.mark.parametrize("argv, match", [
    (["--journal-dir", "x"], "--journal-dir checkpoints fleet sessions"),
    (["--fleet", "2", "--journal-every", "2"], "--journal-every paces"),
    (["--fleet", "2", "--journal-dir", "x", "--journal-every", "0"],
     "--journal-every must be >= 1"),
    (["--fleet", "2", "--restart-backoff-s", "0"], "--restart-backoff-s must be > 0"),
    (["--fleet", "2", "--restart-backoff-s", "2", "--restart-backoff-max-s", "1"],
     "--restart-backoff-max-s must be >="),
    (["--fleet", "2", "--max-restarts", "-1"], "--max-restarts must be >= 0"),
    (["--slo-mix", "bulk"], "--slo-mix tags fleet traffic"),
    (["--autoscale", "1:2"], "--autoscale resizes a fleet"),
    (["--fleet", "2", "--autoscale", "x"], "--autoscale wants MIN:MAX"),
    (["--fleet", "2", "--autoscale", "3:1"], "--autoscale wants 1 <= MIN <= MAX"),
    (["--fleet", "4", "--autoscale", "1:2"], "--fleet 4 must sit inside"),
    (["--control", "--ledger"], "--control retunes a fleet"),
    (["--fleet", "2", "--control"], "--control reads the chip-time ledger"),
    (["--http-port", "0"], "--http-port needs --fleet"),
    (["--roles", "prefill,decode"], "--roles splits a FLEET"),
    (["--wfq", "bulk:1"], "--wfq orders the FLEET"),
    (["--supervise"], "--supervise needs --fleet"),
    (["--inject-fault", "decode_dispatch@1:3"], "targets a fleet member"),
    (["--inject-fault", "replica_crash:1"], "is a fleet-level seam"),
    (["--fleet", "2", "--roles", "prefill"], "--roles wants one role per replica"),
    (["--fleet", "2", "--roles", "prefill,bogus"], "--roles values must be from"),
    (["--fleet", "2", "--wfq", "bulk:x"], "--wfq wants CLASS[:WEIGHT] pairs"),
    (["--fleet", "2", "--wfq", "bulk:-1"], "--wfq wants a class name with a positive"),
    (["--fleet", "2", "--slo-mix", "bogus:1"], "--slo-mix class must be one of"),
    (["--fleet", "2", "--inject-fault", "decode_dispatch@5:1"], "targets replica 5"),
    (["--fleet", "2", "--inject-fault", "replica_crash@1:1"], "only engine seams"),
    (["--fleet", "2", "--inject-fault", "replica_respawn:1"], "it needs --supervise"),
    (["--fleet", "2", "--inject-fault", "scale_spawn_fail:1"], "it needs --autoscale"),
    (["--fleet", "2", "--inject-fault", "bogus:1"], "unknown seams in --inject-fault"),
    (["--metrics-port", "70000"], "--metrics-port must be in [0, 65535]"),
])
def test_cli_fleet_validations(argv, match, capsys):
    """The fleet flags keep the JAX CLI's validations and messages."""
    from workloads_torch.serve import main

    with pytest.raises(SystemExit):
        main(["--device", "cpu", "--requests", "2", "--max-new-tokens", "4", *argv])
    assert match in capsys.readouterr().err


def test_restore_never_remints_a_rid_that_ended_before_the_restart(tmp_path):
    """A session that expired (or was cancelled, or failed) before the
    process died is journaled as history, so the restored fleet mints
    new rids past it and every rid keeps one terminal status.  The JAX
    package's journal leaves such sessions out, and its restored fleet
    hands the expired request's rid to the next submission."""
    jdir = str(tmp_path / "j")
    fleet = _fleet(2, journal_dir=jdir)
    ok = fleet.submit([1, 2, 3], 4)
    gone = fleet.submit([4, 5, 6], 4, deadline_s=1e-9)
    fleet.run()
    assert fleet._reqs[ok].status == "ok" and fleet._reqs[gone].status == "expired"
    fleet.close()
    fresh = _fleet(2, journal_dir=jdir)
    assert fresh.restore() == 2
    assert fresh._reqs[gone].status == "expired"
    rid = fresh.submit([7, 8], 3)
    assert rid not in (ok, gone)
    fresh.run()
    assert fresh._reqs[rid].status == "ok" and fresh._reqs[gone].status == "expired"
    fresh.close()
