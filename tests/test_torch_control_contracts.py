"""The JAX package's control-plane contracts, ported to the PyTorch port
on the CPU: its tests/test_supervisor.py (resurrection, backoff, the
canary, crash-loop quarantine, health marks, capacity-aware admission),
test_autoscaler.py (scale up and down, the degradation ladder, preempt
order, the front end), test_control.py (retunes on real engines, the
controller on a real fleet) and test_control_units.py (the goodput
controller's hill-climb, hysteresis and WFQ re-weighting on fakes, and
``FleetLedger.class_economics``).

Each section is the JAX test file's text with its imports pointed at
``workloads_torch`` and its engines built on ``device="cpu"``; where a
helper's name would clash across sections it is renamed, as the section
heading says.  torch, numpy and the port only (plus the jax-free parts
of the device plugin that the JAX tests import), so it runs in the fast
tier.
"""

from __future__ import annotations

import json
import numpy as np
import pytest
import time
import torch

from tpu_device_plugin.api.constants import HEALTHY, UNHEALTHY
from tpu_device_plugin.device import HealthEvent
from types import SimpleNamespace
from workloads_torch.autoscaler import FleetAutoscaler
from workloads_torch.backoff import Backoff
from workloads_torch.control import GoodputController, ControlSignals
from workloads_torch.errors import QueueFull, EngineClosed
from workloads_torch.faults import FaultInjector, crash_loop_schedule
from workloads_torch.fleet import DEAD, Fleet, DRAINING, FleetServer, TrafficGen
from workloads_torch.generate import generate as _port_generate
from workloads_torch.ledger import ChipTimeLedger, FleetLedger
from workloads_torch.model import ModelConfig, init_params
from workloads_torch.serve import ServeEngine as _PortEngine
from workloads_torch.supervisor import BACKOFF, QUARANTINED, SERVING, FleetSupervisor, make_engine_factory as _port_make_engine_factory
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


# ==== tests/test_supervisor.py
CONFIG = ModelConfig(max_seq_len=64, n_layers=2, dtype=torch.float32)
PARAMS = init_params(CONFIG, torch.Generator().manual_seed(0))
ENGINE_KW = dict(slots=2, page_size=4, prompt_bucket=8)
PROBE = ([1, 2, 3], 4)

# Tiny, jitter-free backoff so tests converge in milliseconds while the
# schedule stays exactly predictable.
FAST = Backoff(base_s=1e-3, factor=2.0, max_s=8e-3, jitter=0.0)


def _engine(**kw):
    base = dict(ENGINE_KW)
    base.update(kw)
    return ServeEngine(PARAMS, CONFIG, **base)


def _fleet(n=2, **fleet_kw):
    fleet_kw.setdefault("chip_ids", [f"chip-{i}" for i in range(n)])
    fleet_kw.setdefault("hang_timeout_s", None)
    return Fleet([_engine() for _ in range(n)], **fleet_kw)


def _supervised(n=2, *, fleet_kw=None, **sup_kw):
    fleet = _fleet(n, **(fleet_kw or {}))
    factory, oracle = make_engine_factory(
        PARAMS, CONFIG, engine_kw=ENGINE_KW, probe=PROBE
    )
    sup_kw.setdefault("backoff", FAST)
    sup_kw.setdefault("probe", PROBE)
    sup_kw.setdefault("probe_oracle", oracle)
    return FleetSupervisor(fleet, factory, **sup_kw), fleet


def _oracle(prompt, new):
    return [int(t) for t in np.asarray(generate(
        PARAMS, torch.tensor([prompt]), CONFIG,
        max_new_tokens=new,
    )[0])]


def _prompts(seed, n, new_lo=4, new_hi=12):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        plen = int(rng.integers(1, 20))
        prompt = [int(t) for t in rng.integers(0, CONFIG.vocab_size, plen)]
        out.append((prompt, int(rng.integers(new_lo, new_hi))))
    return out


def _assert_no_leaks(fleet):
    for rep in fleet.replicas:
        if rep.state == DEAD:
            continue
        e = rep.engine
        assert not e._occupied.any(), rep.index
        assert e._committed_pages == 0, rep.index
        pinned = e.prefix.cached_pages if e.prefix is not None else 0
        assert e.ctrl.used_pages == pinned, rep.index
        assert not rep.rids, rep.index


# ---- backoff policy ------------------------------------------------------


def test_backoff_escalates_caps_and_jitters_deterministically():
    b = Backoff(base_s=0.5, factor=2.0, max_s=4.0, jitter=0.0)
    assert [b.delay(k) for k in range(5)] == [0.5, 1.0, 2.0, 4.0, 4.0]
    j = Backoff(base_s=0.5, factor=2.0, max_s=4.0, jitter=0.2, seed=3)
    # Jitter is additive within [0, jitter*delay], pure per (seed,
    # attempt): same inputs, same delay; a different seed decorrelates.
    for k in range(6):
        d = j.delay(k)
        base = b.delay(k)
        assert base <= d <= base * 1.2, (k, d)
        assert d == j.delay(k)
    other = Backoff(base_s=0.5, factor=2.0, max_s=4.0, jitter=0.2, seed=4)
    assert [j.delay(k) for k in range(6)] != [
        other.delay(k) for k in range(6)
    ]
    # Huge attempts stay at the cap instead of overflowing.
    assert b.delay(10_000) == 4.0
    # Interruptible: a pre-set event returns immediately, flagged.
    import threading

    ev = threading.Event()
    ev.set()
    slow = Backoff(base_s=30.0, max_s=30.0, jitter=0.0)
    t0 = time.monotonic()
    assert slow.sleep(0, interrupt=ev) is True
    assert time.monotonic() - t0 < 1.0
    for bad in (
        lambda: Backoff(base_s=0.0),
        lambda: Backoff(factor=0.5),
        lambda: Backoff(base_s=2.0, max_s=1.0),
        lambda: Backoff(jitter=1.5),
        lambda: Backoff().delay(-1),
    ):
        with pytest.raises(ValueError):
            bad()


# ---- resurrection --------------------------------------------------------


def test_crash_resurrects_capacity_and_streams_bit_identical():
    """The headline acceptance contract: a mid-stream replica crash
    with the supervisor armed — the fleet returns to its pre-fault
    alive count without operator intervention, ok streams stay
    bit-identical to the dense oracle, restore time is recorded, and
    the resurrected replica really serves."""
    n = 2
    sup, fleet = _supervised(
        n, fleet_kw=dict(
            fault_injector=FaultInjector({"replica_crash": 3}),
        ),
    )
    reqs = _prompts(0, 6, new_lo=6)
    rids = [fleet.submit(p, nw) for p, nw in reqs]
    sup.run()
    terminal = {fr.rid: fr.status for fr in fleet.completed}
    assert fleet.replica_crashes == 1
    assert sup.wait_healed(20.0), sup.states()
    alive = [r for r in fleet.replicas if r.state == "active"]
    assert len(alive) == n  # pre-fault capacity, no operator involved
    assert sup.restarts_total == 1
    assert len(sup.restore_ms) == 1 and sup.restore_ms[0] > 0
    assert sup.states() == {"chip-0": SERVING, "chip-1": SERVING}
    for rid, (p, nw) in zip(rids, reqs):
        fr = fleet._reqs[rid]
        ref = _oracle(p, nw)
        if terminal.get(rid) == "ok":
            assert fr.tokens == ref, rid
        else:
            assert fr.tokens == ref[: len(fr.tokens)], rid
    # The respawned replica takes real traffic.
    new_idx = sup.slot_for("chip-0").index
    admitted0 = fleet.replicas[new_idx].engine.requests_admitted
    more = _prompts(1, 4, new_lo=2)
    rids2 = [fleet.submit(p, nw, session="pin") for p, nw in more]
    sup.run()
    assert sum(
        r.engine.requests_admitted for r in fleet.replicas
        if r.state != DEAD
    ) > admitted0
    for rid, (p, nw) in zip(rids2, more):
        assert fleet._reqs[rid].tokens == _oracle(p, nw)
    _assert_no_leaks(fleet)
    fleet.close()


def test_restart_backoff_escalates_per_failure_and_is_deterministic():
    """Failed restarts push the next attempt out exponentially (capped)
    on a schedule that replays exactly for the same (policy seed, chip
    slot) — pinned with a fake clock and an always-failing factory."""
    t = [0.0]

    def run_schedule():
        fleet = _fleet(2, fault_injector=FaultInjector(
            {"replica_crash": 3}
        ))
        boom_factory = lambda slot: (_ for _ in ()).throw(  # noqa: E731
            RuntimeError("no chip")
        )
        sup = FleetSupervisor(
            fleet, boom_factory,
            backoff=Backoff(base_s=1.0, factor=2.0, max_s=8.0,
                            jitter=0.1, seed=5),
            probe=PROBE, probe_oracle=[0],
            crash_loop_k=99, crash_loop_window_s=1e9,
            clock=lambda: t[0],
        )
        for p, nw in _prompts(2, 4):
            fleet.submit(p, nw)
        t[0] = 0.0
        delays = []
        while len(delays) < 5:
            if not fleet.idle:
                fleet.step()
            sup.poll(now=t[0])
            slot = sup.slot_for("chip-0")
            if slot.state == BACKOFF and (
                not delays or slot.next_due - t[0] != delays[-1]
            ):
                if slot.next_due > t[0]:
                    delays.append(slot.next_due - t[0])
                    t[0] = slot.next_due  # jump to the attempt
        fleet.close()
        return delays

    first = run_schedule()
    # Escalates ~2x per consecutive failure (jitter <= 10% never breaks
    # monotonicity at factor 2) and hits the cap band.
    for a, b in zip(first, first[1:-1]):
        assert b > a, first
    assert first[0] <= 1.1 and first[-1] >= 8.0, first
    assert run_schedule() == first  # deterministic replay


def test_probe_divergence_keeps_the_replacement_out():
    """Half-open means half-open: a respawned engine whose canary
    stream diverges from the oracle is discarded (a failed restart),
    and only a bit-identical probe rejoins."""
    # crash_loop_k raised from the default 3: sup.run() drives the
    # survivors for many CPU-bound steps while the 1-8 ms backoff
    # expires, so three failed canaries land inside it and the slot
    # goes to crash-loop quarantine before the good factory returns
    # (the JAX test fails so on a CPU host too).  Crash-loop quarantine
    # has its own contract below.
    sup, fleet = _supervised(
        2, fleet_kw=dict(
            fault_injector=FaultInjector({"replica_crash": 3}),
        ),
        crash_loop_k=1000,
    )
    bad_params = init_params(CONFIG, torch.Generator().manual_seed(9))
    good_factory = sup.engine_factory
    sup.engine_factory = lambda slot: ServeEngine(
        bad_params, CONFIG, **ENGINE_KW
    )
    for p, nw in _prompts(3, 4):
        fleet.submit(p, nw)
    sup.run()
    deadline = time.monotonic() + 20
    while sup.restart_failures == 0 and time.monotonic() < deadline:
        sup.step()
        time.sleep(0.002)
    assert sup.restart_failures >= 1
    assert sup.slot_for("chip-0").state != SERVING
    assert "probe" in (sup.slot_for("chip-0").reason or "")
    assert sum(1 for r in fleet.replicas if r.state == "active") == 1
    # The good factory heals it — probe passes bit-identically.
    sup.engine_factory = good_factory
    assert sup.wait_healed(20.0), sup.states()
    assert sup.restarts_total == 1
    fleet.close()


def test_crash_loop_quarantines_until_manual_clear_then_rejoins():
    """The make selfheal-check story, pinned step by step: a scripted
    repeat-crash-on-restart (replica_respawn schedule) trips the
    sliding-window detector -> the slot QUARANTINES (no rejoin, no
    further attempts) -> an operator clear() forgives it -> the
    half-open probe rejoins the replica."""
    sup, fleet = _supervised(
        2,
        fleet_kw=dict(fault_injector=FaultInjector({"replica_crash": 3})),
        crash_loop_k=3, crash_loop_window_s=60.0,
        fault_injector=FaultInjector(crash_loop_schedule(2)),
    )
    reqs = _prompts(4, 5, new_lo=6)
    rids = [fleet.submit(p, nw) for p, nw in reqs]
    sup.run()
    deadline = time.monotonic() + 20
    while (
        sup.slot_for("chip-0").state != QUARANTINED
        and time.monotonic() < deadline
    ):
        sup.step()
        time.sleep(0.002)
    slot = sup.slot_for("chip-0")
    # Death + 2 respawn crashes = 3 window failures = quarantine.
    assert slot.state == QUARANTINED, sup.states()
    assert sup.crash_loops == 1
    assert sup.restart_failures == 2
    assert "crash loop" in slot.reason
    assert sup.quarantined == ["chip-0"]
    # Quarantined means OUT: no rejoin however long we step.
    for _ in range(10):
        sup.step()
    assert sum(1 for r in fleet.replicas if r.state == "active") == 1
    assert sup.restarts_total == 0
    # Every request still finished ok on the survivor, oracle-true.
    for rid, (p, nw) in zip(rids, reqs):
        fr = fleet._reqs[rid]
        if fr.status == "ok":
            assert fr.tokens == _oracle(p, nw), rid
    # Manual clear -> half-open probe -> rejoin (the respawn schedule
    # is exhausted, so the next attempt survives).
    sup.clear("chip-0")
    assert sup.wait_healed(20.0), sup.states()
    assert sup.restarts_total == 1
    assert sup.states() == {"chip-0": SERVING, "chip-1": SERVING}
    _assert_no_leaks(fleet)
    fleet.close()


def test_max_restarts_budget_exhaustion_quarantines():
    sup, fleet = _supervised(
        2,
        fleet_kw=dict(
            fault_injector=FaultInjector({"replica_crash": 3}),
        ),
        max_restarts=1,
    )
    for p, nw in _prompts(5, 6, new_lo=8):
        fleet.submit(p, nw)
    sup.run()
    assert sup.wait_healed(20.0)
    assert sup.restarts_total == 1  # first death: within budget
    # The REPLACEMENT dies too (an escaped exception is a crash): the
    # per-slot budget is spent, so the slot quarantines instead of
    # burning restarts forever.
    idx = sup.slot_for("chip-0").index

    def boom():
        raise RuntimeError("chip fell off the bus")

    fleet.replicas[idx].engine.step = boom
    fleet.submit([1, 2], 2)
    sup.run()
    for _ in range(5):
        sup.step()
    slot = sup.slot_for("chip-0")
    assert slot.state == QUARANTINED, sup.states()
    assert "budget" in slot.reason
    assert sup.restarts_total == 1  # no second resurrection
    fleet.close()


def test_single_replica_fleet_parks_queue_through_resurrection():
    """The all-dead edge: when the fleet's ONLY replica crashes
    mid-stream with a supervisor armed, the queue PARKS for the
    replacement (the revival seam) instead of failing terminally with
    'no live replicas remain' — and the replayed stream is
    bit-identical.  Without supervision the loud failure stays."""
    sup, fleet = _supervised(
        1, fleet_kw=dict(
            fault_injector=FaultInjector({"replica_crash": 2}),
        ),
    )
    reqs = _prompts(20, 3, new_lo=8, new_hi=12)
    rids = [fleet.submit(p, nw) for p, nw in reqs]
    deadline = time.monotonic() + 40
    while (
        any(not fleet._reqs[r].done for r in rids)
        and time.monotonic() < deadline
    ):
        sup.step()
        if sup._parked():
            time.sleep(0.001)
    assert fleet.replica_crashes == 1
    assert sup.restarts_total == 1
    for rid, (p, nw) in zip(rids, reqs):
        fr = fleet._reqs[rid]
        assert fr.status == "ok", (rid, fr.status, fr.error)
        assert fr.tokens == _oracle(p, nw), rid
    # A fleet-wide wipeout with NO revival pending still fails loudly.
    fleet.revival_hook = None
    _assert_no_leaks(fleet)
    fleet.close()


# ---- health marks --------------------------------------------------------


def test_health_mark_defers_resurrection_until_cleared():
    """A chip carrying a HealthFanout Unhealthy mark gets no new
    engine: resurrection defers (counted, not escalated) until the
    mark lifts — a sick chip is not a place to put a fresh replica."""
    sup, fleet = _supervised(
        2, fleet_kw=dict(
            fault_injector=FaultInjector({"replica_crash": 3}),
        ),
    )
    sup.note_health([HealthEvent(chip_id="chip-0", health=UNHEALTHY)])
    for p, nw in _prompts(7, 4):
        fleet.submit(p, nw)
    sup.run()
    for _ in range(5):
        sup.step()
        time.sleep(0.003)
    assert fleet.replica_crashes == 1
    assert sup.restarts_total == 0
    assert sup.health_deferrals >= 1
    assert sup.slot_for("chip-0").state == BACKOFF  # deferred, not failed
    assert sup.restart_failures == 0
    # The all-clear lifts the mark; resurrection proceeds.
    sup.note_health([HealthEvent(chip_id="", health=HEALTHY)])
    assert sup.wait_healed(20.0), sup.states()
    assert sup.restarts_total == 1
    fleet.close()


# ---- capacity-aware load shedding ---------------------------------------


def test_capacity_aware_bound_sheds_while_degraded_and_recovers():
    """With max_pending_per_replica the fleet-wide admission bound
    tracks the ACTIVE replica count: full fleet 2x2=4, degraded 1x2=2
    (typed QueueFull sheds the overflow), healed back to 4."""
    sup, fleet = _supervised(
        2,
        fleet_kw=dict(
            fault_injector=FaultInjector({"replica_crash": 3}),
            max_pending_per_replica=2,
        ),
        backoff=Backoff(base_s=5.0, max_s=5.0, jitter=0.0),  # stay down
    )
    assert fleet.admission_bound == 4
    for p, nw in _prompts(8, 4, new_lo=6):
        fleet.submit(p, nw)
    sup.run()  # the crash fires mid-run; requests finish on survivors
    assert fleet.replica_crashes == 1
    assert fleet.admission_bound == 2  # scaled down with capacity
    fleet.submit([1, 2], 4)
    fleet.submit([3, 4], 4)
    with pytest.raises(QueueFull) as exc:
        fleet.submit([5, 6], 4)
    assert "capacity-aware" in str(exc.value)
    assert fleet.queue_rejections == 1
    # Heal now (collapse the deliberate backoff) -> bound restored.
    sup.slot_for("chip-0").next_due = 0.0
    assert sup.wait_healed(20.0), sup.states()
    assert fleet.admission_bound == 4
    fleet.submit([5, 6], 4)  # fits again
    sup.run()
    _assert_no_leaks(fleet)
    fleet.close()


def test_static_max_pending_converts_to_capacity_aware_on_arming():
    fleet = _fleet(2, max_pending=8)
    factory, oracle = make_engine_factory(
        PARAMS, CONFIG, engine_kw=ENGINE_KW, probe=PROBE
    )
    FleetSupervisor(
        fleet, factory, backoff=FAST, probe=PROBE, probe_oracle=oracle
    )
    assert fleet.max_pending is None
    assert fleet.max_pending_per_replica == 4
    assert fleet.admission_bound == 8  # unchanged at full capacity
    fleet.close()


# ---- membership / operator surface --------------------------------------


def test_adopt_forget_and_observer_counters():
    from tpu_device_plugin.metrics import PREFIX, Registry
    from workloads_torch.obs import SupervisorObserver

    reg = Registry()
    obs = SupervisorObserver(name="t")
    obs.bind_registry(reg)
    sup, fleet = _supervised(
        2, fleet_kw=dict(
            # With 3 replicas stepping in index order, crossing 2 is
            # step 1 replica 1 (chip-1) and crossing 4 is step 2
            # replica 2 (chip-2): the forgotten chip and the adopted
            # chip both die.
            fault_injector=FaultInjector({"replica_crash": [2, 4]}),
        ),
        observer=obs,
    )
    # A third replica joins live; adopt() brings it under supervision,
    # forget() stands down for chip-1 (its death then stays dead).
    idx = fleet.add_replica(_engine(), chip_id="chip-2")
    sup.adopt("chip-2", idx)
    sup.forget("chip-1")
    for p, nw in _prompts(9, 6, new_lo=6):
        fleet.submit(p, nw)
    sup.run()  # both scheduled crashes fire (chip-1 and chip-2 die)
    assert sup.wait_healed(20.0), sup.states()
    assert sup.slot_for("chip-0").state == SERVING  # never died
    assert sup.slot_for("chip-1").state == "forgotten"  # stayed down
    assert sup.slot_for("chip-2").state == SERVING  # adopted + healed
    assert sup.restarts_total == 1
    text = reg.render()
    assert f"{PREFIX}_supervisor_restarts_total" in text
    assert 'state="serving",supervisor="t"} 2' in text
    assert f"{PREFIX}_supervisor_restore_seconds_count" in text
    obs.unbind_registry()
    fleet.close()


# ---- the make selfheal-check smoke --------------------------------------


def test_selfheal_smoke():
    """ONE seeded supervisor chaos round — the `make selfheal-check`
    tripwire: scripted crash -> resurrection; scripted crash-loop ->
    quarantine -> manual clear -> probed rejoin; streams oracle-true
    throughout, no leaks, full capacity at the end."""
    sup, fleet = _supervised(
        2,
        fleet_kw=dict(fault_injector=FaultInjector({"replica_crash": 3})),
        crash_loop_k=3, crash_loop_window_s=60.0,
        fault_injector=FaultInjector(crash_loop_schedule(2)),
    )
    reqs = _prompts(11, 6, new_lo=6)
    rids = [fleet.submit(p, nw) for p, nw in reqs]
    sup.run()
    deadline = time.monotonic() + 30
    while (
        sup.slot_for("chip-0").state != QUARANTINED
        and time.monotonic() < deadline
    ):
        sup.step()
        time.sleep(0.002)
    assert sup.slot_for("chip-0").state == QUARANTINED
    assert sup.crash_loops == 1
    sup.clear("chip-0")
    assert sup.wait_healed(30.0), sup.states()
    assert sup.restarts_total == 1
    assert sum(1 for r in fleet.replicas if r.state == "active") == 2
    for rid, (p, nw) in zip(rids, reqs):
        fr = fleet._reqs[rid]
        ref = _oracle(p, nw)
        if fr.status == "ok":
            assert fr.tokens == ref, rid
        else:
            assert fr.tokens == ref[: len(fr.tokens)], rid
    _assert_no_leaks(fleet)
    fleet.close()


# ==== tests/test_autoscaler.py (renamed here: FAST -> AUTOSCALER_FAST, _fleet -> _autoscaler_fleet, _prompts -> _autoscaler_prompts, _assert_no_leaks -> _autoscaler_assert_no_leaks)
TERMINAL = {"ok", "cancelled", "expired", "failed"}
AUTOSCALER_FAST = Backoff(base_s=1e-3, max_s=8e-3, jitter=0.0)


def _autoscaler_fleet(n=1, *, engine_kw=None, **fleet_kw):
    fleet_kw.setdefault("chip_ids", [f"chip-{i}" for i in range(n)])
    fleet_kw.setdefault("hang_timeout_s", None)
    return Fleet(
        [_engine(**(engine_kw or {})) for _ in range(n)], **fleet_kw
    )


def _autoscaler(fleet, *, engine_kw=None, factory=None, **kw):
    ekw = dict(ENGINE_KW)
    ekw.update(engine_kw or {})
    if factory is None:
        def factory(slot):
            return ServeEngine(PARAMS, CONFIG, **ekw)
    kw.setdefault("min_replicas", 1)
    kw.setdefault("max_replicas", 3)
    kw.setdefault("up_backoff", AUTOSCALER_FAST)
    kw.setdefault("down_backoff", AUTOSCALER_FAST)
    kw.setdefault("down_consecutive", 2)
    kw.setdefault("depth_high", 1.0)
    kw.setdefault("queue_wait_p99_target_s", 0.2)
    kw.setdefault("window_s", 0.5)
    return FleetAutoscaler(fleet, factory, **kw)


def _autoscaler_prompts(seed, n, lo=1, hi=20, new_lo=4, new_hi=16):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        plen = int(rng.integers(lo, hi))
        prompt = [int(t) for t in rng.integers(0, CONFIG.vocab_size, plen)]
        out.append((prompt, int(rng.integers(new_lo, new_hi))))
    return out


def _autoscaler_assert_no_leaks(fleet):
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


# ---- validation ----------------------------------------------------------


def test_autoscaler_validates_its_knobs():
    fleet = _autoscaler_fleet(1)
    for bad in (
        dict(min_replicas=0),
        dict(min_replicas=3, max_replicas=2),
        dict(queue_wait_p99_target_s=0.0),
        dict(depth_high=0),
        dict(burn_high=0),
        dict(clear_fraction=1.0),
        dict(clear_fraction=0.0),
        dict(severe_factor=1.0),
        dict(window_s=0),
        dict(down_consecutive=0),
        dict(brownout_factor=1.0),
        dict(brownout_factor=0.0),
        dict(preempt_batch=0),
        dict(probe=([], 4)),
        dict(probe=([1], 0)),
        dict(probe_max_steps=0),
    ):
        with pytest.raises(ValueError):
            _autoscaler(fleet, **bad)
    fleet.close()


# ---- the closed loop -----------------------------------------------------


def test_scales_up_under_pressure_then_back_down_bit_identical():
    """The headline loop: queue pressure scales 1 -> N (probed joins),
    the drained fleet scales back to the floor, and every stream is
    bit-identical to the dense oracle — elasticity is invisible to
    tokens."""
    fleet = _autoscaler_fleet(1)
    asc = _autoscaler(fleet)
    asc.calibrate_probe()
    fleet.submit([1], 2)
    asc.run()  # warm, off the pressure clock
    reqs = _autoscaler_prompts(3, 12)
    rids = [fleet.submit(p, n) for p, n in reqs]
    served = asc.run()
    assert asc.scale_ups >= 1, asc.decisions
    assert len(fleet.alive) >= 2
    for rid, (prompt, new) in zip(rids, reqs):
        assert served[rid] == _oracle(prompt, new), rid
    # The spike is over: the loop must converge back to the floor.
    assert asc.wait_quiescent(20.0), (
        asc.states(), asc.decisions, fleet.states(),
    )
    assert len(fleet.alive) == 1
    assert asc.scale_downs >= 1
    assert asc.recover_s, "the breach window never closed"
    assert asc.overprovision_chip_s >= 0.0
    # Removed replicas are really gone (closed, not leaked).
    for rep in fleet.replicas:
        if rep.state == DEAD:
            assert rep.engine.closed
    _autoscaler_assert_no_leaks(fleet)
    fleet.close()


def test_never_scales_past_max_replicas():
    fleet = _autoscaler_fleet(1)
    asc = _autoscaler(fleet, max_replicas=2)
    asc.calibrate_probe()
    for p, n in _autoscaler_prompts(5, 14):
        fleet.submit(p, n)
    asc.run()
    assert asc.scale_ups <= 1
    assert sum(1 for r in fleet.replicas if r.state != DEAD) <= 2
    fleet.close()


def test_hysteresis_gates_scaling_with_a_fake_clock():
    """Deterministic cooldown gating: one scale-up per up-cooldown
    however often the breached signal polls, scale-down only after
    down_consecutive clear polls AND the down-gate, and never below
    min_replicas."""
    fleet = _autoscaler_fleet(1)
    asc = _autoscaler(
        fleet,
        up_backoff=Backoff(base_s=10.0, max_s=10.0, jitter=0.0),
        down_backoff=Backoff(base_s=10.0, max_s=10.0, jitter=0.0),
        down_consecutive=2,
        clock=lambda: 0.0,
    )
    asc.calibrate_probe()
    fleet.submit([1], 2)
    fleet.run()  # warm the engine compiles
    # Build queue pressure WITHOUT stepping: three queued requests on
    # one replica breach depth_high=1.
    for p, n in _autoscaler_prompts(7, 3):
        fleet.submit(p, n)
    asc.poll(now=100.0)
    assert asc.scale_ups == 1 and len(fleet.alive) == 2
    # Same breach, inside the up-cooldown: no second spawn.
    asc.poll(now=105.0)
    assert asc.scale_ups == 1
    # Past the gate: the second spawn lands.
    asc.poll(now=111.0)
    assert asc.scale_ups == 2 and len(fleet.alive) == 3
    # Serve everything; the signal clears.
    fleet.run()
    # One clear poll is not enough (down_consecutive=2)...
    asc.poll(now=130.0)
    assert asc.scale_downs == 0
    # ...the second clear poll drains the least-loaded replica.
    asc.poll(now=131.0)
    assert asc.scale_downs == 1
    assert DRAINING in {r.state for r in fleet.replicas}
    # The next down waits out the down-gate however clear the signal.
    asc.poll(now=132.0)
    asc.poll(now=133.0)
    assert asc.scale_downs == 1
    asc.poll(now=145.0)
    asc.poll(now=146.0)
    assert asc.scale_downs == 2
    # Retirements complete; the floor holds through further polls.
    for t in range(160, 260, 10):
        asc.poll(now=float(t))
    assert len(fleet.alive) == 1
    assert asc.scale_downs == 2  # min_replicas floor
    _autoscaler_assert_no_leaks(fleet)
    fleet.close()


def test_spawn_failure_consults_seam_and_escalates_the_up_gate():
    inj = FaultInjector({"scale_spawn_fail": [1, 2]})
    fleet = _autoscaler_fleet(1)
    asc = _autoscaler(
        fleet, fault_injector=inj,
        up_backoff=Backoff(base_s=10.0, max_s=100.0, jitter=0.0),
        clock=lambda: 0.0,
    )
    asc.calibrate_probe()
    fleet.submit([1], 2)
    fleet.run()
    for p, n in _autoscaler_prompts(9, 3):
        fleet.submit(p, n)
    asc.poll(now=10.0)  # first attempt: seam fires
    assert asc.spawn_failures == 1 and asc.scale_ups == 0
    assert inj.crossings["scale_spawn_fail"] == 1
    # Inside the escalated gate: no retry.
    asc.poll(now=15.0)
    assert asc.spawn_failures == 1
    # Past delay(0)=10: second attempt, seam fires again, gate doubles.
    asc.poll(now=21.0)
    assert asc.spawn_failures == 2 and asc.scale_ups == 0
    asc.poll(now=30.0)  # inside delay(1)=20
    assert asc.spawn_failures == 2
    asc.poll(now=42.0)  # past it: the third attempt succeeds
    assert asc.scale_ups == 1 and len(fleet.alive) == 2
    assert asc.spawn_failures == 2
    # Ladder engaged while capacity could not arrive (breach + no
    # growth): the brownout step recorded itself.
    assert asc.brownouts >= 1
    fleet.run()
    _autoscaler_assert_no_leaks(fleet)
    fleet.close()


def test_probe_divergence_keeps_the_replica_out():
    """A factory whose engines compute different tokens must never
    join: the canary diverges, the spawn counts as a failure."""
    bad_params = torch.utils._pytree.tree_map(lambda w: w * 1.5, PARAMS)

    def bad_factory(slot):
        return ServeEngine(bad_params, CONFIG, **ENGINE_KW)

    fleet = _autoscaler_fleet(1)
    asc = _autoscaler(fleet, factory=bad_factory, clock=lambda: 0.0)
    # Oracle from the GOOD fleet's weights.
    asc._probe_oracle = _oracle([1, 2, 3], 4)
    fleet.submit([1], 2)
    fleet.run()
    for p, n in _autoscaler_prompts(11, 3):
        fleet.submit(p, n)
    asc.poll(now=10.0)
    assert asc.scale_ups == 0
    assert asc.spawn_failures == 1
    assert len(fleet.alive) == 1
    ev = [e for e in asc.events if e.kind == "spawn_failed"]
    assert ev and "diverged" in ev[-1].detail
    fleet.run()
    fleet.close()


def test_never_drains_the_last_dispatchable_replica():
    """Two replicas, one health-paused: however clear the signal, the
    lone dispatchable replica is not drained (and the paused one is
    not a candidate)."""
    from tpu_device_plugin.api.constants import UNHEALTHY
    from tpu_device_plugin.device import HealthEvent

    fleet = _autoscaler_fleet(2)
    asc = _autoscaler(fleet, min_replicas=1, clock=lambda: 0.0)
    fleet.submit([1], 2)
    fleet.run()
    fleet.deliver_health([
        HealthEvent(chip_id="chip-0", health=UNHEALTHY)
    ])
    fleet.step()  # apply the pause
    assert fleet.replicas[0].paused
    assert fleet.dispatchable_count == 1
    for t in range(0, 100, 5):
        asc.poll(now=float(t))
    assert asc.scale_downs == 0
    assert fleet.replicas[1].state == "active"
    fleet.close()


# ---- the degradation ladder ---------------------------------------------


def test_brownout_tightens_admission_bound_and_names_it():
    """Ladder step 1 at pinned capacity: the capacity-aware bound
    tightens to brownout_factor and QueueFull says so; recovery
    restores it."""
    fleet = _autoscaler_fleet(1, max_pending_per_replica=4)
    asc = _autoscaler(
        fleet, min_replicas=1, max_replicas=1,  # capacity cannot grow
        brownout_factor=0.5, clock=lambda: 0.0,
    )
    fleet.submit([1], 2)
    fleet.run()
    assert fleet.admission_bound == 4
    for p, n in _autoscaler_prompts(13, 2):
        fleet.submit(p, n)
    asc.poll(now=10.0)  # breach, cannot grow -> brownout
    assert asc.ladder_level == 1 and asc.brownouts == 1
    assert fleet.admission_factor == 0.5
    assert fleet.admission_bound == 2
    with pytest.raises(QueueFull) as exc:
        fleet.submit([9, 9], 2)
    assert "brownout" in str(exc.value)
    assert "dispatchable" in str(exc.value)
    # Serve the queue; clear polls walk the ladder back down.
    fleet.run()
    asc.poll(now=20.0)
    assert asc.ladder_level == 0
    assert fleet.admission_factor == 1.0
    assert fleet.admission_bound == 4
    _autoscaler_assert_no_leaks(fleet)
    fleet.close()


def test_preemption_parks_bulk_and_resumes_exact_continuation():
    """Ladder step 2: a running bulk stream is preempted — prefix
    pages pushed to the host tier, rid requeued UNCHARGED with its
    class parked — and resumes as an exact continuation once the
    interactive burst passes."""
    engine_kw = dict(prefix_cache=True, kv_offload=True)
    fleet = _autoscaler_fleet(1, engine_kw=engine_kw)
    asc = _autoscaler(
        fleet, engine_kw=engine_kw, min_replicas=1, max_replicas=1,
        severe_factor=1.2, preempt_batch=2, clock=lambda: 0.0,
    )
    fleet.submit([1], 2)
    fleet.run()
    prompt = [5, 4, 3, 2, 1, 9, 8, 7]
    new = 40
    rid_bulk = fleet.submit(prompt, new, slo_class="bulk")
    fleet.step()  # bulk is mid-decode
    for p, n in _autoscaler_prompts(17, 5):
        fleet.submit(p, n, slo_class="interactive")
    asc.poll(now=10.0)  # rung 1
    asc.poll(now=11.0)  # rung 2: preempt
    assert asc.ladder_level == 2
    assert fleet.preemptions >= 1
    fr = fleet._reqs[rid_bulk]
    assert fr.status == "queued" and fr.preemptions == 1
    assert fr.failovers == 0  # uncharged
    eng = fleet.replicas[0].engine
    assert eng.requests_preempted >= 1
    assert eng.pages_parked >= 1
    assert eng.prefix.offloaded_pages >= 1
    # While parked, the class is excluded from dispatch.
    assert "bulk" in fleet.parked_classes
    fleet.step()
    assert fr.status == "queued"
    # Drive with the control loop: the burst drains, the ladder steps
    # down, the bulk stream unparks and finishes.
    deadline = time.monotonic() + 30.0
    while not fleet.idle and time.monotonic() < deadline:
        asc.step()
    assert fleet.idle, (asc.states(), fleet.states())
    assert fr.status == "ok"
    assert fr.tokens == _oracle(prompt, new)
    assert not fleet.parked_classes
    assert fleet.preempt_resume_s  # the resume window closed
    assert asc.preemptions_total >= 1
    _autoscaler_assert_no_leaks(fleet)
    fleet.close()


# ---- supervisor interplay ------------------------------------------------


def test_supervised_scale_ups_are_adopted_and_downs_forgotten():
    """With a supervisor armed: a scaled-up replica is adopted (its
    later crash is healed), and a scaled-down slot is forgotten (its
    deliberate retirement is NOT resurrected)."""
    fleet = _autoscaler_fleet(1)
    factory, oracle = make_engine_factory(
        PARAMS, CONFIG, engine_kw=ENGINE_KW, probe=([1, 2, 3], 4)
    )
    sup = FleetSupervisor(
        fleet, factory, backoff=AUTOSCALER_FAST, probe=([1, 2, 3], 4),
        probe_oracle=oracle,
    )
    asc = _autoscaler(
        fleet, factory=factory, supervisor=sup, probe_oracle=oracle,
        clock=lambda: 0.0,
    )
    fleet.submit([1], 2)
    fleet.run()
    for p, n in _autoscaler_prompts(19, 3):
        fleet.submit(p, n)
    asc.poll(now=10.0)
    assert asc.scale_ups == 1
    new_index = len(fleet.replicas) - 1
    chip = fleet.replicas[new_index].chip_id
    assert chip.startswith("scale-")
    assert sup.slot_for(chip).state == "serving"  # adopted
    fleet.run()
    # Crash the adopted replica: the SUPERVISOR heals it.
    fleet.replicas[new_index].engine.close()
    fleet.submit([2, 3], 4)
    deadline = time.monotonic() + 20.0
    while not fleet.idle and time.monotonic() < deadline:
        sup.step()
        time.sleep(0.002)
    assert sup.wait_healed(20.0), sup.states()
    assert sup.restarts_total >= 1
    # Now scale down: the retired slot must be FORGOTTEN, and the
    # supervisor must not resurrect it.
    restarts_before = sup.restarts_total
    for t in range(20, 60, 1):
        asc.poll(now=float(t))
        sup.poll()
        if asc.scale_downs and not asc._retiring:
            break
    assert asc.scale_downs >= 1
    forgotten = [
        s for s in sup.slots if s.state == "forgotten"
    ]
    assert forgotten, sup.states()
    for _ in range(50):
        sup.poll()
    assert sup.restarts_total == restarts_before
    fleet.close()


# ---- observability -------------------------------------------------------


def test_events_and_observer_counters_land_on_the_registry():
    from tpu_device_plugin.metrics import PREFIX, Registry
    from workloads_torch.obs import AutoscalerObserver

    reg = Registry()
    obs = AutoscalerObserver(name="t")
    obs.bind_registry(reg)
    fleet = _autoscaler_fleet(1)
    asc = _autoscaler(fleet, observer=obs, clock=lambda: 0.0)
    asc.calibrate_probe()
    fleet.submit([1], 2)
    fleet.run()
    for p, n in _autoscaler_prompts(23, 3):
        fleet.submit(p, n)
    asc.poll(now=10.0)
    fleet.run()
    asc.poll(now=30.0)
    asc.poll(now=31.0)
    kinds = {e.kind for e in asc.events}
    assert "breach" in kinds and "scale_up" in kinds
    assert "recovered" in kinds
    text = reg.render()
    assert f"{PREFIX}_autoscaler_scale_ups_total" in text
    assert f"{PREFIX}_autoscaler_replicas_live" in text
    assert f"{PREFIX}_autoscaler_decisions_total" in text
    assert 'action="scale_up"' in text
    obs.unbind_registry()
    fleet.close()


def test_fleet_server_reports_autoscaler_state():
    import urllib.request

    fleet = _autoscaler_fleet(1)
    asc = _autoscaler(fleet, clock=lambda: 0.0)
    server = FleetServer(fleet, 0, autoscaler=asc)
    port = server.start()
    try:
        with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/healthz", timeout=10
        ) as resp:
            health = json.loads(resp.read())
        assert health["autoscaler"]["ladder_level"] == 0
        assert health["autoscaler"]["min_replicas"] == 1
    finally:
        server.stop()
        fleet.close()


# ---- the make autoscale-check smoke -------------------------------------


def test_autoscale_check_smoke():
    """The `make autoscale-check` tripwire: a seeded step-load burst
    scales the fleet 1 -> N and back, the SLO-recovery window closes,
    ok streams are bit-identical to the dense oracle, and no
    page/slot/host-blob leaks remain anywhere."""
    engine_kw = dict(prefix_cache=True, kv_offload=True)
    fleet = _autoscaler_fleet(1, engine_kw=engine_kw)
    asc = _autoscaler(fleet, engine_kw=engine_kw, max_replicas=3)
    asc.calibrate_probe()
    fleet.submit([1], 2)
    asc.run()  # warm
    gen = TrafficGen(
        seed=29, rate_rps=500.0, max_prompt=16, min_new=4, max_new=12,
        vocab=CONFIG.vocab_size,
    )
    reqs = [(p, n) for _, p, n in gen.schedule(12)]
    rids = [fleet.submit(p, n) for p, n in reqs]
    served = asc.run()
    assert asc.scale_ups >= 1, asc.decisions
    for rid, (prompt, new) in zip(rids, reqs):
        assert served[rid] == _oracle(prompt, new), rid
    assert asc.wait_quiescent(20.0), (asc.states(), fleet.states())
    assert len(fleet.alive) == 1
    assert asc.recover_s
    assert asc.ladder_level == 0
    assert fleet.admission_factor == 1.0
    assert not fleet.parked_classes
    for rep in fleet.replicas:
        if rep.state != DEAD and rep.engine.prefix is not None:
            # No host-blob leaks: the offload tier only holds what the
            # index owns.
            assert rep.engine.prefix.offloaded_pages >= 0
    _autoscaler_assert_no_leaks(fleet)
    fleet.close()


# ---- resize chaos fuzz ---------------------------------------------------


@pytest.mark.slow
def test_autoscaler_resize_chaos_fuzz():
    """Crashes, spawn failures and health drains injected DURING
    resizes (supervisor + autoscaler armed together): the fleet must
    keep every invariant — exactly one terminal status per rid, ok
    streams bit-identical to the dense oracle (through failovers,
    resurrections, scale-ups/downs and preemptions), interrupted
    streams true prefixes, ladder fully unwound at the end, no leaks
    on any live replica."""
    from tpu_device_plugin.api.constants import HEALTHY, UNHEALTHY
    from tpu_device_plugin.device import HealthEvent

    for seed in range(2):
        rng = np.random.default_rng(seed + 411000)
        engine_kw = dict(
            slots=int(rng.integers(1, 3)),
            page_size=4, prompt_bucket=8,
            prefix_cache=bool(rng.integers(2)),
        )
        if engine_kw["prefix_cache"] and rng.integers(2):
            engine_kw["kv_offload"] = True
        fleet = Fleet(
            [ServeEngine(PARAMS, CONFIG, **engine_kw)],
            chip_ids=["chip-0"], hang_timeout_s=None,
            fault_injector=FaultInjector.random(
                seed=seed, rate=0.02,
                seams=("replica_crash", "replica_hang"),
                max_fires=2,
            ),
            max_failovers=3,
            # A short burn window: chaos-induced SLO misses must decay
            # within the test's horizon or the breach (and therefore
            # the ladder) would outlive the load by the default 60 s.
            slo_window_s=2.0,
        )
        factory, oracle = make_engine_factory(
            PARAMS, CONFIG, engine_kw=engine_kw, probe=([1, 2, 3], 4)
        )
        sup = FleetSupervisor(
            fleet, factory, backoff=AUTOSCALER_FAST, probe=([1, 2, 3], 4),
            probe_oracle=oracle,
        )
        asc = FleetAutoscaler(
            fleet, factory, min_replicas=1, max_replicas=3,
            supervisor=sup, probe_oracle=oracle,
            up_backoff=AUTOSCALER_FAST, down_backoff=AUTOSCALER_FAST, down_consecutive=2,
            depth_high=1.0, queue_wait_p99_target_s=0.2, window_s=0.5,
            severe_factor=1.5, preempt_batch=2,
            fault_injector=FaultInjector.random(
                seed=seed + 7, rate=0.3, seams=("scale_spawn_fail",),
            ),
        )
        fleet.submit([1], 2)
        asc.run()  # warm
        classes = [None, "interactive", "bulk"]
        pending = []
        for _ in range(int(rng.integers(8, 14))):
            plen = int(rng.integers(1, 20))
            prompt = [
                int(t) for t in rng.integers(0, CONFIG.vocab_size, plen)
            ]
            new = int(rng.integers(2, 16))
            pending.append((
                prompt, new, classes[int(rng.integers(3))],
            ))
        expected = {}
        terminal = {}
        deadline = time.monotonic() + 120.0
        while pending or not fleet.idle:
            assert time.monotonic() < deadline, (
                seed, fleet.states(), asc.states(), asc.last_signals,
            )
            if not pending:
                # Load is drained; the remaining work is waiting out
                # signal windows (burn/queue-wait decay with WALL
                # time) — don't spin a million no-op steps.
                time.sleep(0.001)
            for _ in range(min(len(pending), int(rng.integers(1, 4)))):
                prompt, new, cls = pending.pop()
                try:
                    rid = fleet.submit(prompt, new, slo_class=cls)
                except QueueFull:
                    continue  # the brownout/bound did its job
                expected[rid] = (prompt, new)
            if rng.integers(15) == 0:
                alive = fleet.alive
                if len(alive) > 1:
                    ev = HealthEvent(
                        chip_id=alive[
                            int(rng.integers(len(alive)))
                        ].chip_id,
                        health=UNHEALTHY,
                    )
                    fleet.deliver_health([ev])
                    sup.note_health([ev])
            if rng.integers(12) == 0:
                ev = HealthEvent(chip_id="", health=HEALTHY)
                fleet.deliver_health([ev])
                sup.note_health([ev])
            for fr in asc.step():
                assert fr.rid not in terminal, (seed, fr.rid)
                assert fr.status in TERMINAL, (seed, fr.rid, fr.status)
                terminal[fr.rid] = fr.status
        ev = HealthEvent(chip_id="", health=HEALTHY)
        fleet.deliver_health([ev])
        sup.note_health([ev])
        fleet.step()
        # The controller must unwind fully once the load is gone.
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline and (
            asc.ladder_level or asc._retiring
        ):
            asc.step()
        assert asc.ladder_level == 0, (seed, asc.states())
        assert fleet.admission_factor == 1.0
        assert not fleet.parked_classes
        assert set(terminal) == set(expected), (
            seed, set(expected) ^ set(terminal),
        )
        for rid, (prompt, new) in expected.items():
            fr = fleet._reqs[rid]
            ref = _oracle(prompt, new)
            if terminal[rid] == "ok":
                assert fr.tokens == ref, (
                    seed, rid, fr.failovers, fr.preemptions,
                )
            else:
                assert fr.tokens == ref[: len(fr.tokens)], (
                    seed, rid, terminal[rid],
                )
        _autoscaler_assert_no_leaks(fleet)
        fleet.close()


# ---- waste-budget SLO (the GoodputController's autoscaler seam) ----------


def test_waste_budget_validates_its_range():
    fleet = _autoscaler_fleet(1)
    for bad in (0.0, 1.0, -0.2, 1.5):
        with pytest.raises(ValueError):
            _autoscaler(fleet, waste_budget=bad)
    fleet.close()


def test_waste_budget_holds_scale_up_until_waste_clears():
    """Don't scale up into measured waste: while the (controller-fed)
    waste fraction exceeds the budget, a breached signal buys a
    waste_hold — counted once per open window — and the ladder
    engages instead; the moment waste returns inside the budget the
    ordinary probed scale-up proceeds."""
    fleet = _autoscaler_fleet(1)
    asc = _autoscaler(
        fleet, waste_budget=0.3,
        up_backoff=Backoff(base_s=10.0, max_s=10.0, jitter=0.0),
        clock=lambda: 0.0,
    )
    assert asc.states()["waste_budget"] == 0.3
    asc.calibrate_probe()
    fleet.submit([1], 2)
    fleet.run()  # warm the engine compiles
    for p, n in _autoscaler_prompts(7, 3):  # breach depth_high without stepping
        fleet.submit(p, n)
    asc.waste_fraction_hint = 0.8  # the controller's smoothed view
    asc.poll(now=100.0)
    assert asc.scale_ups == 0 and len(fleet.alive) == 1
    assert asc.waste_holds == 1
    assert asc.decisions.get("waste_hold") == 1
    assert asc.ladder_level >= 1  # the ladder attacks the spike instead
    assert any(ev.kind == "waste_hold" for ev in asc.events)
    # The same open window re-polled (past the up-gate): still held,
    # still ONE hold counted.
    asc.poll(now=111.0)
    assert asc.scale_ups == 0 and asc.waste_holds == 1
    assert asc.states()["waste_fraction"] == 0.8
    # Waste back inside the budget: capacity may grow again.
    asc.waste_fraction_hint = 0.1
    asc.poll(now=122.0)
    assert asc.scale_ups == 1 and len(fleet.alive) == 2
    assert asc.waste_holds == 1
    asc.run()
    _autoscaler_assert_no_leaks(fleet)
    fleet.close()


def test_waste_headroom_relaxes_the_scale_down_streak():
    """Eager scale-down: waste comfortably inside the budget collapses
    the down_consecutive streak to a single clear poll — capacity
    above the floor under goodput headroom is pure overprovision."""
    fleet = _autoscaler_fleet(2)
    asc = _autoscaler(
        fleet, waste_budget=0.5, down_consecutive=3, max_replicas=2,
    )
    asc.calibrate_probe()
    fleet.submit([1], 2)
    fleet.run()
    # Clear signal, but waste OUTSIDE the headroom band (> budget *
    # clear_fraction = 0.25): the full 3-poll streak still applies.
    asc.waste_fraction_hint = 0.4
    asc.poll(now=100.0)
    assert asc.scale_downs == 0
    # Waste drops into the headroom band: the very next clear poll
    # drains a replica without waiting out the streak.
    asc.waste_fraction_hint = 0.05
    asc.poll(now=101.0)
    assert asc.scale_downs == 1
    assert asc.wait_quiescent(20.0), asc.states()
    assert len(fleet.alive) == 1
    _autoscaler_assert_no_leaks(fleet)
    fleet.close()


# ==== tests/test_control.py (renamed here: FAST -> CONTROL_FAST, _assert_no_leaks -> _control_assert_no_leaks)
DRAFT_CONFIG = ModelConfig(
    max_seq_len=64, n_layers=1, d_model=32, n_heads=2, d_ff=64,
    dtype=torch.float32,
)
# An UNCORRELATED draft: near-chance acceptance, so always-speculate
# engines burn heavy spec_rejected waste — the seeded spike the
# controller exists to retune away.  Greedy spec decoding stays exact
# regardless of draft quality, so oracle parity still pins every
# stream.
BAD_DRAFT = init_params(DRAFT_CONFIG, torch.Generator().manual_seed(99))
CONTROL_FAST = Backoff(base_s=1e-6, max_s=1e-6, jitter=0.0)


def _spec_engine(**kw):
    base = dict(ENGINE_KW)
    base.update(kw)
    return ServeEngine(
        PARAMS, CONFIG, draft_params=BAD_DRAFT, draft_config=DRAFT_CONFIG,
        gamma=3, spec="auto", **base,
    )


def _plain_engine(**kw):
    base = dict(ENGINE_KW)
    base.update(kw)
    return ServeEngine(PARAMS, CONFIG, **base)


def _controller(fleet, **kw):
    kw.setdefault("min_sample_tokens", 16)
    kw.setdefault("spec_reject_low", 0.02)
    kw.setdefault("spec_reject_high", 0.2)
    kw.setdefault("retune_backoff", CONTROL_FAST)
    kw.setdefault("wfq_backoff", CONTROL_FAST)
    return GoodputController(fleet, **kw)


def _control_assert_no_leaks(fleet):
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


# ---- ServeEngine.retune: the actuation seam ------------------------------


def test_retune_validates_and_counts_only_real_changes():
    eng = _spec_engine(
        spec_breakeven=2.0, superstep_k=2, spec_superstep_k=2,
    )
    # No-op retunes return {} and never count (no drain, no churn).
    assert eng.retune(spec_breakeven=2.0) == {}
    assert eng.retune(superstep_k=2, spec_superstep_k=2) == {}
    assert eng.retunes == 0
    # The k knobs are bounded by their construction-time ceilings.
    with pytest.raises(ValueError, match="superstep_k"):
        eng.retune(superstep_k=4)
    with pytest.raises(ValueError, match="superstep_k"):
        eng.retune(superstep_k=0)
    with pytest.raises(ValueError, match="spec_superstep_k"):
        eng.retune(spec_superstep_k=3)
    with pytest.raises(ValueError, match="spec_breakeven"):
        eng.retune(spec_breakeven=-1.0)
    # A real change reports {knob: (old, new)} and counts once.
    assert eng.retune(superstep_k=1, spec_breakeven=0.5) == {
        "superstep_k": (2, 1), "spec_breakeven": (2.0, 0.5),
    }
    assert eng.retunes == 1
    eng.close()
    with pytest.raises(EngineClosed):
        eng.retune(spec_breakeven=1.0)
    # Breakeven shifts need spec="auto": other modes never consult the
    # threshold, so accepting one would fake an actuation.
    plain = _plain_engine()
    with pytest.raises(ValueError, match="auto"):
        plain.retune(spec_breakeven=1.0)
    plain.close()


def test_retune_breakeven_shift_mid_stream_bit_identical():
    """The spec_down/spec_up transition: breakeven slots -> 0 flips the
    engine from always-speculate to never mid-flight (draining the
    in-flight rounds), and back up again — streams stay oracle-exact
    across both switches."""
    eng = _spec_engine(spec_breakeven=2.0)
    reqs = [([5, 6, 7], 20), ([1, 2], 16), ([9], 12)]
    rids = [eng.submit(p, n) for p, n in reqs]
    out = {}
    for _ in range(3):
        for fr in eng.step():
            out[fr.rid] = fr.tokens
    assert eng.retune(spec_breakeven=0.0) == {
        "spec_breakeven": (2.0, 0.0),
    }
    for _ in range(3):
        for fr in eng.step():
            out[fr.rid] = fr.tokens
    assert eng.retune(spec_breakeven=2.0) == {
        "spec_breakeven": (0.0, 2.0),
    }
    for rid, toks in eng.run().items():
        out[rid] = toks
    assert eng.retunes == 2
    assert eng.spec_rounds > 0, "never speculated below the threshold"
    assert eng.chunks_run > 0, "never decoded plainly at breakeven 0"
    for rid, (prompt, new) in zip(rids, reqs):
        assert list(out[rid]) == _oracle(prompt, new), rid
    eng.close()


def test_retune_superstep_k_step_mid_stream_bit_identical():
    """The super_down/super_up transition on the plain fused path:
    k 4 -> 2 -> 4 mid-flight, never above the construction ceiling,
    streams oracle-exact throughout."""
    eng = _plain_engine(superstep_k=4)
    reqs = [([3, 4, 5, 6], 18), ([7, 8], 14)]
    rids = [eng.submit(p, n) for p, n in reqs]
    out = {}
    for _ in range(2):
        for fr in eng.step():
            out[fr.rid] = fr.tokens
    assert eng.retune(superstep_k=2) == {"superstep_k": (4, 2)}
    for _ in range(2):
        for fr in eng.step():
            out[fr.rid] = fr.tokens
    # Back UP to (never past) the constructed ceiling.
    assert eng.retune(superstep_k=4) == {"superstep_k": (2, 4)}
    with pytest.raises(ValueError):
        eng.retune(superstep_k=8)
    for rid, toks in eng.run().items():
        out[rid] = toks
    for rid, (prompt, new) in zip(rids, reqs):
        assert list(out[rid]) == _oracle(prompt, new), rid
    eng.close()


def test_retune_spec_superstep_k_step_mid_stream_bit_identical():
    """The fused-speculative-round transition: spec_superstep_k
    2 -> 1 -> 2 mid-flight on an always-speculating engine, streams
    oracle-exact."""
    eng = _spec_engine(spec_breakeven=2.0, spec_superstep_k=2)
    reqs = [([11, 12, 13], 16), ([14], 12)]
    rids = [eng.submit(p, n) for p, n in reqs]
    out = {}
    for _ in range(2):
        for fr in eng.step():
            out[fr.rid] = fr.tokens
    assert eng.retune(spec_superstep_k=1) == {
        "spec_superstep_k": (2, 1),
    }
    for _ in range(2):
        for fr in eng.step():
            out[fr.rid] = fr.tokens
    assert eng.retune(spec_superstep_k=2) == {
        "spec_superstep_k": (1, 2),
    }
    for rid, toks in eng.run().items():
        out[rid] = toks
    for rid, (prompt, new) in zip(rids, reqs):
        assert list(out[rid]) == _oracle(prompt, new), rid
    eng.close()


def test_retained_pages_fractional_for_fanout_shared_pages():
    """Preemption-score input: a fork-shared page retains 1/refcount
    per holder, so summing retained_pages over a fan-out group counts
    every unique page exactly once; 0.0 before admission and after
    retirement."""
    eng = _plain_engine(slots=2)
    assert eng.retained_pages("nope") == 0.0
    r1, r2 = eng.submit_fanout([21, 22, 23, 24, 25, 26], 8, 2)
    eng.step()  # admit + prefill: prompt pages now shared
    a, b = eng.retained_pages(r1), eng.retained_pages(r2)
    assert a > 0 and b > 0
    union = set()
    for seq, table in eng.ctrl.tables.items():
        if (
            isinstance(seq, tuple) and len(seq) == 3
            and seq[0] == "slot" and seq[2] in (r1, r2)
        ):
            union.update(table)
    assert a + b == pytest.approx(len(union))
    # Shared prompt pages count HALF per child: each child retains
    # strictly less than the pages its table lists.
    tables = [
        t for s, t in eng.ctrl.tables.items()
        if isinstance(s, tuple) and len(s) == 3
        and s[0] == "slot" and s[2] == r1
    ]
    assert a < len(tables[0])
    eng.run()
    assert eng.retained_pages(r1) == 0.0
    assert eng.retained_pages(r2) == 0.0
    eng.close()


# ---- scored preemption ---------------------------------------------------


def test_preempt_candidates_order_and_scored_preempt_exact_resume():
    """The ladder's victim scoring: ascending goodput-per-retained-
    page — a dispatched-but-unadmitted rid (0 pages, nothing lost)
    parks first, then the stream delivering the fewest tokens per
    retained page; the scored preempt itself resumes as an EXACT
    continuation."""
    fleet = Fleet(
        [_plain_engine(slots=2)], chip_ids=["chip-0"],
        hang_timeout_s=None,
    )
    # A: long prompt (many retained pages), B: short prompt (few) —
    # comparable emissions, so A scores lower goodput-per-page than B.
    reqs = {
        "A": (list(range(30, 42)), 20),
        "B": ([43, 44], 20),
        "C": ([45, 46, 47], 6),  # third on 2 slots: queued, 0 pages
    }
    rids = {
        k: fleet.submit(p, n, slo_class="bulk")
        for k, (p, n) in reqs.items()
    }
    out = {}
    for _ in range(2):  # prefill + one decode chunk: nothing finished
        for fr in fleet.step():
            out[fr.rid] = list(fr.tokens)
    rep = fleet.replicas[0]
    eng = rep.engine

    def retained(k):
        # Fleet rids map to engine-level requests; retained_pages is
        # keyed by the ENGINE rid (what preempt_candidates passes).
        ereq = rep.rids[rids[k]]
        return eng.retained_pages(getattr(ereq, "rid", rids[k]))

    pages = {k: retained(k) for k in ("A", "B")}
    assert pages["A"] > pages["B"] > 0
    assert retained("C") == 0.0
    cands = fleet.preempt_candidates("bulk")
    assert cands[0] == rids["C"], "the free victim must park first"
    assert cands[1:] == [rids["A"], rids["B"]]
    assert fleet.preempt_candidates("interactive") == []
    # Park the scored head and drain: the preempted stream must come
    # back bit-identical (uncharged continuation), like every other.
    assert fleet.preempt(cands[0])
    for rid, toks in fleet.run().items():
        out[rid] = list(toks)
    for k, (prompt, new) in reqs.items():
        assert out[rids[k]] == _oracle(prompt, new), k
    _control_assert_no_leaks(fleet)
    fleet.close()


def test_autoscaler_preempt_walks_the_scored_order():
    """FleetAutoscaler._preempt_some consumes Fleet.preempt_candidates
    head-first: with preempt_batch=1 exactly the lowest-scored victim
    parks."""
    fleet = Fleet(
        [_plain_engine(slots=2)], chip_ids=["chip-0"],
        hang_timeout_s=None,
    )

    def factory(slot):
        return _plain_engine()

    asc = FleetAutoscaler(
        fleet, factory, min_replicas=1, max_replicas=1,
        up_backoff=CONTROL_FAST, down_backoff=CONTROL_FAST, preempt_batch=1,
        window_s=0.5,
    )
    reqs = {
        "A": (list(range(50, 62)), 20),
        "B": ([63, 64], 20),
    }
    rids = {
        k: fleet.submit(p, n, slo_class="bulk")
        for k, (p, n) in reqs.items()
    }
    out = {}
    for _ in range(2):
        for fr in fleet.step():
            out[fr.rid] = list(fr.tokens)
    expect = fleet.preempt_candidates("bulk")[0]
    assert asc._preempt_some(0.0) == 1
    assert asc.preemptions_total == 1
    # The scored head was the one parked: it left its replica's rids.
    assert expect not in fleet.replicas[0].rids
    other = [r for r in rids.values() if r != expect][0]
    assert other in fleet.replicas[0].rids
    for rid, toks in fleet.run().items():
        out[rid] = list(toks)
    for k, (prompt, new) in reqs.items():
        assert out[rids[k]] == _oracle(prompt, new), k
    _control_assert_no_leaks(fleet)
    fleet.close()


# ---- the controller on real fleets ---------------------------------------


def _spike_fleet(n=1, **engine_kw):
    engine_kw.setdefault("spec_breakeven", 2.0)  # slots: always spec
    return Fleet(
        [
            _spec_engine(ledger=ChipTimeLedger(name=str(i)), **engine_kw)
            for i in range(n)
        ],
        chip_ids=[f"chip-{i}" for i in range(n)],
        hang_timeout_s=None,
        ledger=FleetLedger(),
    )


def _spike_reqs(seed, n, new=14):
    rng = np.random.default_rng(seed)
    return [
        (
            [int(t) for t in rng.integers(0, CONFIG.vocab_size, 1 + i % 5)],
            new,
        )
        for i in range(n)
    ]


def test_controller_retunes_away_spec_waste_streams_exact():
    """The tentpole loop on a real fleet: a bad draft at
    always-speculate burns spec_rejected waste, the controller walks
    the breakeven down until speculation stops, and every stream is
    still bit-identical to the dense oracle."""
    fleet = _spike_fleet(1)
    ctrl = _controller(fleet)
    reqs = _spike_reqs(3, 6)
    rids = [ctrl.submit(p, n, slo_class="bulk") for p, n in reqs]
    out = ctrl.run()
    assert ctrl.samples >= 1
    assert ctrl.retunes_applied >= 1, ctrl.states()
    eng = fleet.replicas[0].engine
    assert eng.spec_breakeven < 2.0, "breakeven never walked down"
    assert eng.retunes >= 1
    assert ctrl.spec_rejected_fraction_ewma is not None
    assert any(ev.kind == "retune" for ev in ctrl.events)
    for rid, (prompt, new) in zip(rids, reqs):
        assert list(out[rid]) == _oracle(prompt, new), rid
    _control_assert_no_leaks(fleet)
    fleet.close()


def test_controller_off_and_inert_streams_identical_to_bare():
    """Inert-by-default pin: the same workload on a bare fleet and on
    a controller-attached fleet with dead-band-everything thresholds
    yields identical streams and zero actuations — attaching the
    controller is free until the signal demands otherwise."""
    def run(controlled):
        fleet = _spike_fleet(1)
        reqs = _spike_reqs(7, 4)
        if controlled:
            ctrl = _controller(
                fleet,
                spec_reject_low=0.0, spec_reject_high=0.999,
                overdecode_low=0.0, overdecode_high=0.999,
                wfq_deadband=1e9,
            )
            rids = [ctrl.submit(p, n) for p, n in reqs]
            out = ctrl.run()
            assert ctrl.retunes_applied == 0
            assert ctrl.wfq_reweights == 0
            assert ctrl.polls > 0 and ctrl.samples > 0
        else:
            ctrl = None
            rids = [fleet.submit(p, n) for p, n in reqs]
            out = fleet.run()
        eng = fleet.replicas[0].engine
        assert eng.retunes == 0
        assert eng.spec_breakeven == 2.0
        streams = [list(out[r]) for r in rids]
        fleet.close()
        return streams

    assert run(controlled=True) == run(controlled=False)


def test_controller_wfq_reweight_boosts_measured_class_on_real_fleet():
    """The WFQ seam end-to-end: interactive finishes clean while bulk
    streams cancel mid-flight (their tokens classify as waste), so
    measured goodput-per-chip-second diverges and the controller
    boosts interactive ABOVE its operator floor without ever dropping
    bulk below its own."""
    fleet = Fleet(
        [_plain_engine(slots=2, ledger=ChipTimeLedger(name="0"))],
        chip_ids=["chip-0"], hang_timeout_s=None,
        ledger=FleetLedger(),
        wfq_weights={"interactive": 1.0, "bulk": 1.0},
    )
    ctrl = _controller(fleet, wfq_deadband=0.1)
    good = [fleet.submit([70 + i], 20, slo_class="interactive")
            for i in range(2)]
    bad = [fleet.submit([80 + i], 20, slo_class="bulk")
           for i in range(2)]
    out = {}
    for _ in range(2):
        for fr in fleet.step():
            out[fr.rid] = list(fr.tokens)
    for rid in bad:
        fleet.cancel(rid)
    for rid, toks in fleet.run().items():
        out[rid] = list(toks)
    ctrl.poll()
    assert ctrl.wfq_reweights >= 1, ctrl.states()
    assert ctrl._wfq_floor == {"interactive": 1.0, "bulk": 1.0}
    assert fleet.wfq_weights["interactive"] > 1.0
    assert fleet.wfq_weights["bulk"] == 1.0
    assert any(ev.kind == "wfq_reweight" for ev in ctrl.events)
    for rid in good:
        prompt = [70 + good.index(rid)]
        assert list(out[rid]) == _oracle(prompt, 20), rid
    fleet.close()


def test_control_check_smoke():
    """``make control-check``: the seeded waste spike — bad-draft
    engines at always-speculate — is retuned away by the controller
    (breakeven walks down, speculation stops) and the measured goodput
    fraction RECOVERS: the post-retune batch's delta fraction beats
    the spike batch's.  Streams stay oracle-exact and nothing leaks."""
    fleet = _spike_fleet(2)
    # spec_reject_low=0.0: converge to no-speculation and STAY — the
    # smoke wants recovery, not the up-move's win-recapture probing.
    ctrl = _controller(fleet, spec_reject_low=0.0)
    led = fleet.ledger

    def run_batch(seed):
        before = (led.tokens_accounted, led.goodput_tokens)
        reqs = _spike_reqs(seed, 8)
        rids = [ctrl.submit(p, n, slo_class="bulk") for p, n in reqs]
        out = ctrl.run()
        for rid, (prompt, new) in zip(rids, reqs):
            assert list(out[rid]) == _oracle(prompt, new), rid
        d_acc = led.tokens_accounted - before[0]
        d_good = led.goodput_tokens - before[1]
        assert d_acc > 0
        return d_good / d_acc

    spike = run_batch(11)
    assert ctrl.retunes_applied >= 1, ctrl.states()
    for rep in fleet.replicas:
        assert rep.engine.spec_breakeven < 2.0, rep.index
    recovered = run_batch(12)
    assert recovered > spike, (spike, recovered, ctrl.states())
    assert recovered > 0.9, recovered  # speculation actually stopped
    assert ctrl.poll_s >= 0.0
    st = ctrl.states()
    assert st["retunes_applied"] == ctrl.retunes_applied
    assert st["decisions"].get("retune", 0) >= 1
    _control_assert_no_leaks(fleet)
    fleet.close()


# ==== tests/test_control_units.py (renamed here: FAST -> CONTROL_UNITS_FAST)
# Deterministic hysteresis for clock-injected tests: delay(attempt) is
# exactly base * 2**attempt, no jitter.
CONTROL_UNITS_FAST = Backoff(base_s=1.0, factor=2.0, max_s=64.0, jitter=0.0)


# ---- fakes ---------------------------------------------------------------


class FakeEngine:
    """A ServeEngine stand-in honouring the retune() contract the
    controller depends on: change-dict returns, construction-time k
    ceilings, spec="auto" gating, EngineClosed on a closed engine."""

    def __init__(
        self,
        *,
        draft=True,
        spec="auto",
        spec_breakeven=4.0,
        superstep_k=1,
        superstep_k_max=None,
        spec_superstep_k=1,
        spec_superstep_k_max=None,
        slots=8,
    ):
        self.spec = spec
        self.draft_params = object() if draft else None
        self.spec_breakeven = (
            float(spec_breakeven) if spec_breakeven is not None else None
        )
        self.superstep_k = superstep_k
        self._superstep_k_max = (
            superstep_k_max if superstep_k_max is not None else superstep_k
        )
        self.spec_superstep_k = spec_superstep_k
        self._spec_superstep_k_max = (
            spec_superstep_k_max if spec_superstep_k_max is not None
            else spec_superstep_k
        )
        self.slots = slots
        self.closed = False
        self.retune_log = []

    def retune(self, **knobs):
        if self.closed:
            raise EngineClosed("engine is closed; no retune")
        changes = {}
        if "spec_breakeven" in knobs:
            if self.spec != "auto" or self.draft_params is None:
                raise ValueError("spec_breakeven retune needs auto+draft")
            new = float(knobs["spec_breakeven"])
            if new < 0:
                raise ValueError("spec_breakeven must be >= 0")
            if new != self.spec_breakeven:
                changes["spec_breakeven"] = (self.spec_breakeven, new)
        for knob, ceiling in (
            ("superstep_k", self._superstep_k_max),
            ("spec_superstep_k", self._spec_superstep_k_max),
        ):
            if knob in knobs:
                new = int(knobs[knob])
                if not 1 <= new <= ceiling:
                    raise ValueError(f"{knob} out of [1, {ceiling}]")
                if new != getattr(self, knob):
                    changes[knob] = (getattr(self, knob), new)
        for knob, (_, new) in changes.items():
            setattr(self, knob, new)
        if changes:
            self.retune_log.append(dict(changes))
        return changes


class FakeFleetLedger:
    """FleetLedger-shaped totals source: running counters the
    controller's ``_totals`` fleet branch reads, plus an injectable
    ``class_economics`` table for the WFQ seam."""

    def __init__(self):
        self.tokens_accounted = 0
        self.goodput_tokens = 0
        self._chip = ChipTimeLedger(name="fake")
        self.econ = {}

    @property
    def engine_ledgers(self):
        return [("0", self._chip)]

    def feed(self, *, goodput=0, spec_rejected=0, overdecode=0):
        """Account one delta: the controller only ever reads totals."""
        self.tokens_accounted += goodput + spec_rejected + overdecode
        self.goodput_tokens += goodput
        self._chip.waste_tokens["spec_rejected"] += spec_rejected
        self._chip.waste_tokens["overdecode"] += overdecode

    def class_economics(self):
        return {
            cls: dict(row) for cls, row in self.econ.items()
        }


class FakeFleet:
    """Just enough Fleet surface for the controller: replicas, a step
    that finishes nothing, the armed ledger, live WFQ weights."""

    def __init__(self, engines, *, wfq_weights=None):
        self.replicas = [
            SimpleNamespace(index=i, state="serving", engine=e)
            for i, e in enumerate(engines)
        ]
        self.ledger = FakeFleetLedger()
        self.wfq_weights = wfq_weights
        self.closed = False
        self.idle = True
        self.steps = 0

    def step(self):
        self.steps += 1
        return []

    def submit(self, prompt, new):
        return "rid-fake"

    def cancel(self, rid):
        return False


def _ctrl(fleet, **kw):
    kw.setdefault("retune_backoff", CONTROL_UNITS_FAST)
    kw.setdefault("wfq_backoff", CONTROL_UNITS_FAST)
    kw.setdefault("min_sample_tokens", 10)
    clock = kw.pop("clock", None)
    if clock is None:
        t = [0.0]
        kw["clock"] = lambda: t[0]
        return GoodputController(fleet, **kw), t
    kw["clock"] = clock
    return GoodputController(fleet, **kw), None


# ---- construction validation ---------------------------------------------


def test_rejects_invalid_construction():
    fleet = FakeFleet([FakeEngine()])
    with pytest.raises(ValueError, match="step"):
        GoodputController(object())
    with pytest.raises(ValueError, match="ewma_alpha"):
        GoodputController(fleet, ewma_alpha=0.0)
    with pytest.raises(ValueError, match="ewma_alpha"):
        GoodputController(fleet, ewma_alpha=1.5)
    with pytest.raises(ValueError, match="min_sample_tokens"):
        GoodputController(fleet, min_sample_tokens=0)
    with pytest.raises(ValueError, match="spec_reject"):
        GoodputController(fleet, spec_reject_low=0.5, spec_reject_high=0.3)
    with pytest.raises(ValueError, match="overdecode"):
        GoodputController(fleet, overdecode_low=-0.1)
    with pytest.raises(ValueError, match="overdecode"):
        GoodputController(fleet, overdecode_high=1.1)
    with pytest.raises(ValueError, match="breakeven_step"):
        GoodputController(fleet, breakeven_step=0.0)
    with pytest.raises(ValueError, match="wfq_max_boost"):
        GoodputController(fleet, wfq_max_boost=0.5)
    with pytest.raises(ValueError, match="wfq_deadband"):
        GoodputController(fleet, wfq_deadband=-1.0)


def test_driver_defaults_autoscaler_then_target():
    fleet = FakeFleet([FakeEngine()])
    ctrl, _ = _ctrl(fleet)
    assert ctrl.driver is fleet
    asc = SimpleNamespace(waste_fraction_hint=None, closed=False)
    ctrl2, _ = _ctrl(fleet, autoscaler=asc)
    assert ctrl2.driver is asc
    drv = SimpleNamespace(closed=False)
    ctrl3, _ = _ctrl(fleet, autoscaler=asc, driver=drv)
    assert ctrl3.driver is drv


# ---- signal plumbing -----------------------------------------------------


def test_poll_without_ledger_never_actuates():
    eng = FakeEngine()
    eng.step = lambda: []
    eng.ledger = None
    ctrl, _ = _ctrl(eng)
    ctrl.poll()
    assert ctrl.polls == 1
    assert ctrl.samples == 0
    assert ctrl.last_signals is None
    assert ctrl.retunes_applied == 0


def test_min_sample_gating_accumulates_small_deltas():
    fleet = FakeFleet([FakeEngine()])
    ctrl, _ = _ctrl(fleet, min_sample_tokens=10)
    fleet.ledger.feed(goodput=4)
    ctrl.poll()
    # Below the floor: no sample, but the delta is NOT consumed — the
    # baseline holds so small trickles accumulate into one sample.
    assert ctrl.samples == 0
    assert ctrl.last_signals.delta_tokens == 4
    assert ctrl.goodput_fraction_ewma is None
    fleet.ledger.feed(goodput=6)
    ctrl.poll()
    assert ctrl.samples == 1
    assert ctrl.last_signals.delta_tokens == 10
    assert ctrl.goodput_fraction_ewma == 1.0


def test_ewma_seeds_then_blends():
    fleet = FakeFleet([FakeEngine()])
    ctrl, _ = _ctrl(fleet, ewma_alpha=0.5, min_sample_tokens=10)
    fleet.ledger.feed(goodput=10)  # fraction 1.0 seeds
    ctrl.poll()
    assert ctrl.goodput_fraction_ewma == 1.0
    fleet.ledger.feed(spec_rejected=10)  # fraction 0.0 blends
    ctrl.poll()
    assert ctrl.goodput_fraction_ewma == pytest.approx(0.5)
    assert ctrl.spec_rejected_fraction_ewma == pytest.approx(0.5)
    sig = ctrl.last_signals
    assert isinstance(sig, ControlSignals)
    assert sig.accounted_tokens == 20
    assert sig.goodput_fraction == pytest.approx(0.5)


def test_autoscaler_hint_is_clamped_smoothed_waste():
    asc = SimpleNamespace(waste_fraction_hint=None, closed=False)
    fleet = FakeFleet([FakeEngine()])
    ctrl, _ = _ctrl(fleet, autoscaler=asc, driver=fleet, ewma_alpha=1.0)
    ctrl.poll()
    assert asc.waste_fraction_hint is None  # no evidence, no hint
    fleet.ledger.feed(goodput=3, spec_rejected=7)
    ctrl.poll()
    assert asc.waste_fraction_hint == pytest.approx(0.7)


# ---- hill-climb moves ----------------------------------------------------


def _spike(fleet, ctrl, *, goodput=0, spec_rejected=0, overdecode=0):
    fleet.ledger.feed(
        goodput=goodput, spec_rejected=spec_rejected, overdecode=overdecode,
    )
    ctrl.poll()


def test_spec_down_walks_breakeven_then_halves_spec_superstep():
    eng = FakeEngine(
        spec_breakeven=2.0, spec_superstep_k=4, spec_superstep_k_max=4,
    )
    fleet = FakeFleet([eng])
    ctrl, t = _ctrl(fleet, ewma_alpha=1.0, breakeven_step=1.0)
    # Sustained spec_rejected burn: each cooldown expiry lands exactly
    # one knob move — breakeven walks 2 -> 1 -> 0 (clamped), then the
    # fused spec rounds halve 4 -> 2 -> 1, then nothing is left.
    expect = [
        ("spec_breakeven", 1.0), ("spec_breakeven", 0.0),
        ("spec_superstep_k", 2), ("spec_superstep_k", 1),
    ]
    for knob, value in expect:
        t[0] += 1000.0  # past any escalated gate
        _spike(fleet, ctrl, goodput=2, spec_rejected=18)
        assert getattr(eng, knob) == value, (knob, eng.retune_log)
    applied = ctrl.retunes_applied
    t[0] += 1000.0
    _spike(fleet, ctrl, goodput=2, spec_rejected=18)
    assert ctrl.retunes_applied == applied  # floor reached: no-op
    assert ctrl.decisions["retune"] == applied
    kinds = [ev.kind for ev in ctrl.events]
    assert kinds.count("retune") == applied


def test_super_down_halves_superstep_then_spec_superstep():
    eng = FakeEngine(
        draft=False, spec="on", spec_breakeven=None,
        superstep_k=4, superstep_k_max=4,
        spec_superstep_k=2, spec_superstep_k_max=2,
    )
    fleet = FakeFleet([eng])
    ctrl, t = _ctrl(fleet, ewma_alpha=1.0)
    for k_sup, k_spec in ((2, 2), (1, 2), (1, 1)):
        t[0] += 1000.0
        _spike(fleet, ctrl, goodput=2, overdecode=18)
        assert (eng.superstep_k, eng.spec_superstep_k) == (k_sup, k_spec)


def test_spec_up_doubles_spec_superstep_then_raises_breakeven():
    eng = FakeEngine(
        spec_breakeven=1.0, slots=4,
        spec_superstep_k=1, spec_superstep_k_max=4,
    )
    fleet = FakeFleet([eng])
    ctrl, t = _ctrl(fleet, ewma_alpha=1.0, breakeven_step=2.0)
    # Near-zero rejected waste: recapture the fused-round win first
    # (1 -> 2 -> 4, the construction ceiling), then push breakeven
    # toward slots, clamped at slots.
    expect = [
        ("spec_superstep_k", 2), ("spec_superstep_k", 4),
        ("spec_breakeven", 3.0), ("spec_breakeven", 4.0),
    ]
    for knob, value in expect:
        t[0] += 1000.0
        _spike(fleet, ctrl, goodput=100)
        assert getattr(eng, knob) == value, (knob, eng.retune_log)
    t[0] += 1000.0
    applied = ctrl.retunes_applied
    _spike(fleet, ctrl, goodput=100)
    assert ctrl.retunes_applied == applied  # at the ceilings


def test_super_up_doubles_toward_construction_ceiling_only():
    eng = FakeEngine(
        draft=False, spec="off", spec_breakeven=None,
        superstep_k=1, superstep_k_max=8,
    )
    fleet = FakeFleet([eng])
    ctrl, t = _ctrl(fleet, ewma_alpha=1.0)
    for k in (2, 4, 8):
        t[0] += 1000.0
        _spike(fleet, ctrl, goodput=100)
        assert eng.superstep_k == k
    t[0] += 1000.0
    applied = ctrl.retunes_applied
    _spike(fleet, ctrl, goodput=100)
    assert eng.superstep_k == 8  # never above the ceiling
    assert ctrl.retunes_applied == applied


def test_dead_band_holds_and_resets_escalation():
    eng = FakeEngine(spec_breakeven=8.0, slots=8)
    fleet = FakeFleet([eng])
    ctrl, t = _ctrl(
        fleet, ewma_alpha=1.0,
        spec_reject_low=0.05, spec_reject_high=0.3,
    )
    t[0] += 1000.0
    _spike(fleet, ctrl, goodput=60, spec_rejected=40)  # 0.4 > high
    assert ctrl.retunes_applied == 1
    assert ctrl._retune_streak == 1
    # Signal lands inside the dead band: hold, and the escalation
    # streak resets so the next excursion acts at base cadence.
    t[0] += 1000.0
    _spike(fleet, ctrl, goodput=90, spec_rejected=10)  # 0.1 in band
    assert ctrl.retunes_applied == 1
    assert ctrl._retune_streak == 0


def test_hysteresis_gate_blocks_until_cooldown_expires():
    eng = FakeEngine(spec_breakeven=8.0, slots=8)
    fleet = FakeFleet([eng])
    ctrl, t = _ctrl(fleet, ewma_alpha=1.0)
    t[0] = 10.0
    _spike(fleet, ctrl, goodput=2, spec_rejected=18)
    assert ctrl.retunes_applied == 1
    gate = ctrl._retune_gate
    assert gate == 10.0 + CONTROL_UNITS_FAST.derive("retune").delay(1)
    # Polls inside the cooldown never move a knob however hot the
    # signal stays.
    t[0] = gate - 1e-6
    _spike(fleet, ctrl, goodput=2, spec_rejected=18)
    assert ctrl.retunes_applied == 1
    # Past the gate the next single move lands, and the escalated
    # streak buys a LONGER cooldown (delay(2) > delay(1)).
    t[0] = gate
    _spike(fleet, ctrl, goodput=2, spec_rejected=18)
    assert ctrl.retunes_applied == 2
    assert ctrl._retune_gate == gate + CONTROL_UNITS_FAST.derive("retune").delay(2)


def test_incapable_engines_are_never_picked():
    # No draft anywhere and every k ceiling at 1: there is nothing to
    # retune, whatever the waste says.
    eng = FakeEngine(draft=False, spec="off", spec_breakeven=None)
    fleet = FakeFleet([eng])
    ctrl, t = _ctrl(fleet, ewma_alpha=1.0)
    t[0] += 1000.0
    _spike(fleet, ctrl, goodput=1, spec_rejected=10, overdecode=9)
    assert ctrl.retunes_applied == 0
    assert ctrl._pick_move() is None


def test_closed_engine_is_skipped_not_fatal():
    dead = FakeEngine(spec_breakeven=4.0)
    dead.closed = True
    live = FakeEngine(spec_breakeven=4.0)
    fleet = FakeFleet([dead, live])
    ctrl, t = _ctrl(fleet, ewma_alpha=1.0)
    t[0] += 1000.0
    _spike(fleet, ctrl, goodput=2, spec_rejected=18)
    assert dead.spec_breakeven == 4.0
    assert live.spec_breakeven == 3.0
    assert ctrl.retunes_applied == 1


# ---- WFQ re-weighting ----------------------------------------------------


def _wfq_fleet(econ, weights):
    # Engines with nothing to retune, so only the WFQ seam actuates.
    fleet = FakeFleet(
        [FakeEngine(draft=False, spec="off", spec_breakeven=None)],
        wfq_weights=weights,
    )
    fleet.ledger.econ = econ
    return fleet


def test_wfq_boosts_efficient_class_above_operator_floor():
    econ = {
        "interactive": {"goodput_per_chip_s": 30.0, "chip_s": 1.0},
        "bulk": {"goodput_per_chip_s": 10.0, "chip_s": 1.0},
    }
    fleet = _wfq_fleet(econ, {"interactive": 2.0, "bulk": 1.0})
    ctrl, t = _ctrl(fleet, ewma_alpha=1.0, wfq_deadband=0.25)
    assert ctrl._wfq_floor == {"interactive": 2.0, "bulk": 1.0}
    t[0] += 1000.0
    _spike(fleet, ctrl, goodput=100)
    # mean rate 20: interactive earns 1.5x its floor; bulk holds AT its
    # floor (boost-above-floor only — never starved below the operator
    # weight).
    assert fleet.wfq_weights == {"interactive": 3.0, "bulk": 1.0}
    assert ctrl.wfq_reweights == 1
    assert ctrl.decisions["wfq_reweight"] == 1
    assert any(ev.kind == "wfq_reweight" for ev in ctrl.events)


def test_wfq_boost_caps_at_max_boost():
    econ = {"interactive": {"goodput_per_chip_s": 1000.0, "chip_s": 1.0}}
    for i in range(4):
        econ[f"bulk{i}"] = {"goodput_per_chip_s": 1.0, "chip_s": 1.0}
    weights = {cls: 1.0 for cls in econ}
    fleet = _wfq_fleet(econ, weights)
    ctrl, t = _ctrl(fleet, ewma_alpha=1.0, wfq_max_boost=4.0)
    t[0] += 1000.0
    _spike(fleet, ctrl, goodput=100)
    # interactive's raw rate/mean multiplier is ~5x: capped at 4.
    assert fleet.wfq_weights["interactive"] == 4.0
    assert fleet.wfq_weights["bulk0"] == 1.0


def test_wfq_deadband_suppresses_small_moves():
    econ = {
        "interactive": {"goodput_per_chip_s": 22.0, "chip_s": 1.0},
        "bulk": {"goodput_per_chip_s": 18.0, "chip_s": 1.0},
    }
    fleet = _wfq_fleet(econ, {"interactive": 1.0, "bulk": 1.0})
    ctrl, t = _ctrl(fleet, ewma_alpha=1.0, wfq_deadband=0.25)
    t[0] += 1000.0
    _spike(fleet, ctrl, goodput=100)
    # interactive's earned mult is 1.1: an 10% move under the 25%
    # deadband — weights hold, no reweight counted.
    assert fleet.wfq_weights == {"interactive": 1.0, "bulk": 1.0}
    assert ctrl.wfq_reweights == 0


def test_wfq_needs_two_measured_classes():
    econ = {"interactive": {"goodput_per_chip_s": 30.0, "chip_s": 1.0}}
    fleet = _wfq_fleet(econ, {"interactive": 1.0, "bulk": 1.0})
    ctrl, t = _ctrl(fleet, ewma_alpha=1.0)
    t[0] += 1000.0
    _spike(fleet, ctrl, goodput=100)
    assert ctrl.wfq_reweights == 0
    assert fleet.wfq_weights == {"interactive": 1.0, "bulk": 1.0}


def test_wfq_noop_without_weights_or_economics():
    fleet = FakeFleet(
        [FakeEngine(draft=False, spec="off", spec_breakeven=None)],
        wfq_weights=None,
    )
    ctrl, t = _ctrl(fleet, ewma_alpha=1.0)
    t[0] += 1000.0
    _spike(fleet, ctrl, goodput=100)
    assert ctrl.wfq_reweights == 0


# ---- telemetry, events, driving surface ----------------------------------


def test_states_and_drain_events_and_overflow():
    eng = FakeEngine(spec_breakeven=8.0, slots=8)
    fleet = FakeFleet([eng])
    ctrl, t = _ctrl(fleet, ewma_alpha=1.0)
    t[0] += 1000.0
    _spike(fleet, ctrl, goodput=2, spec_rejected=18)
    st = ctrl.states()
    assert st["polls"] == 1
    assert st["samples"] == 1
    assert st["retunes_applied"] == 1
    assert st["goodput_fraction_ewma"] == pytest.approx(0.1)
    assert st["decisions"] == {"retune": 1}
    assert st["poll_s"] >= 0.0
    drained = ctrl.drain_events()
    assert [ev.kind for ev in drained] == ["retune"]
    assert not ctrl.events
    # Ring overflow counts drops instead of growing unbounded.
    from collections import deque

    ctrl.events = deque(maxlen=1)
    ctrl._event("a")
    ctrl._event("b")
    assert ctrl.dropped_events == 1
    assert [ev.kind for ev in ctrl.events] == ["b"]


def test_step_polls_after_driving_and_run_collects():
    eng = FakeEngine(spec_breakeven=8.0, slots=8)
    fleet = FakeFleet([eng])
    ctrl, _ = _ctrl(fleet)
    assert ctrl.step() == []
    assert fleet.steps == 1
    assert ctrl.polls == 1
    # run() drives the wrapped driver to idle, collecting finished
    # streams fleet.run-style.
    fr = SimpleNamespace(rid="r1", tokens=[1, 2, 3])
    fleet.idle = False

    def step_once():
        fleet.steps += 1
        fleet.idle = True
        return [fr]

    fleet.step = step_once
    assert ctrl.run() == {"r1": [1, 2, 3]}
    assert ctrl.submit([1], 2) == "rid-fake"
    assert ctrl.cancel("r1") is False
    assert ctrl.closed is False
    assert ctrl.idle is True


def test_engine_target_reads_chip_ledger_totals():
    eng = FakeEngine(spec_breakeven=2.0)
    eng.step = lambda: []
    eng.ledger = ChipTimeLedger(name="solo")
    ctrl, t = _ctrl(eng, ewma_alpha=1.0)
    assert ctrl.fleet is None and ctrl.engine is eng
    eng.ledger.tokens_accounted = 20
    eng.ledger.goodput_tokens = 2
    eng.ledger.waste_tokens["spec_rejected"] = 18
    t[0] += 1000.0
    ctrl.poll()
    assert ctrl.samples == 1
    assert ctrl.spec_rejected_fraction_ewma == pytest.approx(0.9)
    assert eng.spec_breakeven == 1.0  # retune reached the bare engine


# ---- FleetLedger.class_economics -----------------------------------------


def _fleet_stub(generated=0, replayed=0):
    return SimpleNamespace(
        replicas=(), generated_tokens=generated, tokens_replayed=replayed,
    )


def _fin(n, cls, status="ok"):
    return SimpleNamespace(tokens=[0] * n, slo_class=cls, status=status)


def test_class_economics_empty_ledger_is_empty():
    assert FleetLedger().class_economics() == {}


def test_class_economics_apportions_busy_seconds_by_token_share():
    led = FleetLedger()
    chip = ChipTimeLedger(name="0")
    chip.phase_s["decode"] = 6.0
    chip.phase_s["idle"] = 4.0  # idle never charges a class
    chip.wall_s = 10.0
    led.attach("0", chip)
    led.step_end(
        _fleet_stub(generated=90),
        [_fin(60, "interactive"), _fin(30, "bulk", status="cancelled")],
    )
    econ = led.class_economics()
    assert set(econ) == {"interactive", "bulk"}
    ia, bk = econ["interactive"], econ["bulk"]
    assert ia["goodput_tokens"] == 60 and ia["waste_tokens"] == 0
    assert bk["goodput_tokens"] == 0 and bk["waste_tokens"] == 30
    # Shares partition the classified tokens; busy (non-idle) seconds
    # are charged by share.
    assert ia["token_share"] + bk["token_share"] == pytest.approx(1.0)
    assert ia["chip_s"] == pytest.approx(4.0)
    assert bk["chip_s"] == pytest.approx(2.0)
    assert ia["chip_s_by_phase"]["decode"] == pytest.approx(4.0)
    assert "idle" not in ia["chip_s_by_phase"]
    # The WFQ ranking headline: goodput per attributed chip-second.
    assert ia["goodput_per_chip_s"] == pytest.approx(15.0)
    assert bk["goodput_per_chip_s"] == 0.0


def test_class_economics_zero_seconds_is_zero_safe():
    led = FleetLedger()
    led.step_end(_fleet_stub(generated=10), [_fin(10, "interactive")])
    econ = led.class_economics()
    assert econ["interactive"]["chip_s"] == 0.0
    assert econ["interactive"]["goodput_per_chip_s"] == 0.0
    assert econ["interactive"]["token_share"] == pytest.approx(1.0)


def test_class_economics_untagged_bucket_for_unclassed_traffic():
    led = FleetLedger()
    led.step_end(
        _fleet_stub(generated=10),
        [SimpleNamespace(tokens=[0] * 10, slo_class=None, status="ok")],
    )
    econ = led.class_economics()
    assert econ["untagged"]["goodput_tokens"] == 10
