"""Self-healing fleet supervision: resurrect dead replicas, quarantine
crash loops, shed load while capacity is degraded.

The device plugin survives its environment — it re-registers on kubelet
restarts and marks chips Unhealthy on critical events (PAPER/SURVEY
§0.2–0.3; ``tpu_device_plugin/watchers.py``, ``main.py``) — and the
fleet (PR 6) survives its replicas: a crash fails in-flight work over
to survivors.  But the dead replica stayed dead, so every fault
permanently shrank capacity until an operator called ``add_replica``.
``FleetSupervisor`` closes that loop: fail over, then RECOVER.

One supervisor watches one ``Fleet``.  Each plugin-advertised chip slot
the fleet started with (plus any the supervisor is told to ``adopt``)
becomes a supervised ``ReplicaSlot``; when the fleet marks its replica
DEAD, the supervisor schedules a resurrection:

  * **Backoff, not hammering.**  Restart attempts for a slot escalate
    per consecutive failure through a shared ``workloads.backoff``
    policy (exponential, capped, deterministic seeded jitter keyed by
    chip slot), and reset on a successful rejoin — the same policy the
    daemon's plugin-restart loop now uses.
  * **Crash-loop quarantine.**  ``crash_loop_k`` failures (deaths or
    failed restarts) inside a sliding ``crash_loop_window_s`` window
    quarantine the chip slot: no more restarts until an operator calls
    ``clear()``.  A slot whose chip carries a live ``HealthFanout``
    Unhealthy mark is equally off-limits — resurrection defers until
    the mark lifts (``note_health``; a sick chip gets no new engine).
  * **Half-open probe.**  A respawned engine does not rejoin the router
    blind: one canary request must complete on it BIT-IDENTICALLY to
    the known-good oracle before ``add_replica`` hands it traffic.  A
    failed probe counts as a failed restart (feeding the crash-loop
    window) and the engine is discarded.
  * **Warm restarts.**  The engine factory respawns on the SAME chip
    slot with the fleet's shared weights; in-process XLA compile caches
    make every post-first restart warm.  Each resurrection's
    death → rejoined window lands in ``restore_ms`` (the bench's
    ``selfheal_restore_ms``; ``measure_selfheal`` prices cold vs warm).
  * **Capacity-aware load shedding.**  While capacity is degraded the
    fleet's admission bound scales down with the DISPATCHABLE replica
    count — ACTIVE and not health-paused; a paused or draining
    replica finishes its in-flight work but buys no fresh queue
    budget (``Fleet(max_pending_per_replica=...)`` —
    ``capacity_aware=True`` converts a static ``max_pending`` on
    arming), so pressure surfaces as typed ``QueueFull`` backpressure
    instead of unbounded queue growth over capacity that no longer
    exists.

The supervisor is cooperative and deterministic like the fleet itself:
``poll()`` runs after each ``fleet.step()`` (or use
``supervisor.step()`` / ``run()`` / ``serve_forever``, which wrap the
fleet's), takes no threads of its own, and consults the
``replica_respawn`` fault seam (``workloads/faults.py``) once per
resurrection attempt so chaos tests script repeat-crash-on-restart
deterministically (``crash_loop_schedule``).

Reference pendant: the reference plugin's restart orchestration
(main.go:264-280) restarts ITSELF; nothing in it restarts the workload
side.  This module is the serving half of that contract.

The PyTorch port's own copy of ``workloads/supervisor.py`` (the port
imports nothing of the JAX package); tests/test_torch_copies.py holds
every definition to it.  Two definitions differ: ``note_health`` reads
the daemon's ``HEALTHY`` from a copy (``tpu_device_plugin.api`` imports
gRPC), and ``make_engine_factory`` builds the port's engine on
``device`` with the port's dense ``generate`` as its probe oracle.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field

import torch

from .backoff import Backoff
from .errors import EngineClosed
from .faults import InjectedFault
from .obs import SupervisorEvent

# The daemon's health constant (``tpu_device_plugin.api.constants``),
# copied: that package's ``api/__init__.py`` imports gRPC.
HEALTHY = "Healthy"

# Slot states.
SERVING = "serving"  # its replica is alive in the fleet
BACKOFF = "backoff"  # dead; a resurrection is scheduled
PROBING = "probing"  # transient: respawn + canary in progress
QUARANTINED = "quarantined"  # crash-looped / budget-exhausted; operator-gated
FORGOTTEN = "forgotten"  # operator told the supervisor to stand down


@dataclass
class ReplicaSlot:
    """Supervision state for one plugin-advertised chip slot.  The
    fleet replica INDEX changes across resurrections (``add_replica``
    appends); the chip slot is the stable identity."""

    chip_id: str
    index: int | None  # current fleet replica index; None while down
    # The replica's disaggregation role (Fleet(roles=...)): a
    # resurrected pool member rejoins ITS pool — respawning a dead
    # prefill replica as mixed would silently dissolve the split.
    role: str = "mixed"
    state: str = SERVING
    attempt: int = 0  # consecutive failures since the last success
    restarts: int = 0  # successful resurrections, lifetime
    failures: deque = field(default_factory=deque)  # crash stamps (window)
    next_due: float | None = None
    t_down: float | None = None  # death detection -> restore window start
    reason: str | None = None  # why quarantined / last failure

    @property
    def down(self) -> bool:
        return self.state in (BACKOFF, PROBING, QUARANTINED)


class FleetSupervisor:
    """Watch a ``Fleet`` and resurrect its dead replicas (module
    docstring).  ``engine_factory(slot)`` must return a fresh
    ``ServeEngine`` for the given ``ReplicaSlot`` — homogeneous with
    the fleet's members and built over the SHARED params (see
    ``make_engine_factory``).

    ``probe`` is the half-open canary ``(prompt, max_new_tokens)``;
    ``probe_oracle`` the token stream it must reproduce bit-identically
    (compute it once on a known-good engine — ``make_engine_factory``
    derives it for you).  With ``probe_oracle=None`` the FIRST
    successful probe's stream becomes the oracle (trust-on-first-use:
    still pins every later restart against the first).
    """

    def __init__(
        self,
        fleet,
        engine_factory,
        *,
        backoff: Backoff | None = None,
        max_restarts: int | None = None,
        crash_loop_k: int = 3,
        crash_loop_window_s: float = 30.0,
        probe: tuple[list[int], int] = ([1, 2, 3], 4),
        probe_oracle: list[int] | None = None,
        probe_max_steps: int = 400,
        capacity_aware: bool = True,
        fault_injector=None,
        observer=None,
        snapshot=None,
        journal_every_s: float | None = None,
        clock=time.perf_counter,
    ):
        if crash_loop_k < 1:
            raise ValueError(
                f"crash_loop_k must be >= 1, got {crash_loop_k}"
            )
        if crash_loop_window_s <= 0:
            raise ValueError(
                f"crash_loop_window_s must be > 0, got "
                f"{crash_loop_window_s}"
            )
        if max_restarts is not None and max_restarts < 0:
            raise ValueError(
                f"max_restarts must be >= 0 or None (unbounded), got "
                f"{max_restarts}"
            )
        if probe_max_steps < 1:
            raise ValueError(
                f"probe_max_steps must be >= 1, got {probe_max_steps}"
            )
        prompt, new = probe
        if not prompt or new < 1:
            raise ValueError(
                f"probe needs a non-empty prompt and max_new >= 1, got "
                f"{probe}"
            )
        self.fleet = fleet
        self.engine_factory = engine_factory
        self.backoff = backoff if backoff is not None else Backoff()
        self.max_restarts = max_restarts
        self.crash_loop_k = crash_loop_k
        self.crash_loop_window_s = float(crash_loop_window_s)
        self.probe_prompt = [int(t) for t in prompt]
        self.probe_new = int(new)
        self.probe_max_steps = probe_max_steps
        self._probe_oracle = (
            [int(t) for t in probe_oracle]
            if probe_oracle is not None else None
        )
        # A warm-state snapshot (workloads/faststart.py) can carry the
        # probe oracle from the capture-time engine; seeding it here
        # makes ``calibrate_probe`` a no-op, so arming the supervisor
        # skips the scratch build-probe-close round entirely.  Only a
        # snapshot captured against the SAME probe may seed — a
        # different (prompt, max_new) would pin a stream no respawn
        # can reproduce.
        self.snapshot = snapshot
        if (
            self._probe_oracle is None
            and snapshot is not None
            and getattr(snapshot, "probe_oracle", None) is not None
            and getattr(snapshot, "probe", None) is not None
            and list(snapshot.probe[0]) == self.probe_prompt
            and int(snapshot.probe[1]) == self.probe_new
        ):
            self._probe_oracle = [int(t) for t in snapshot.probe_oracle]
        self._faults = fault_injector
        self._clock = clock
        self._probes = 0
        # One slot per CURRENT fleet replica; dead ones at arm time are
        # adopted as immediately-due resurrections.  Slot identity is
        # the chip id, so it must be UNIQUE: fleets built without chip
        # ids (or with duplicates) get synthesized ``replica-<i>`` ids —
        # otherwise clear()/quarantine()/states() would silently
        # collapse onto the first slot.  (Synthesized ids cannot match
        # per-chip health events — but an id-less fleet never received
        # attributed events anyway; unattributed marks still apply.)
        now = self._clock()
        self.slots: list[ReplicaSlot] = []
        seen_ids: set[str] = set()
        for rep in fleet.replicas:
            chip_id = rep.chip_id
            if not chip_id or chip_id in seen_ids:
                chip_id = f"replica-{rep.index}"
            seen_ids.add(chip_id)
            slot = ReplicaSlot(
                chip_id=chip_id, index=rep.index,
                role=getattr(rep, "role", "mixed"),
            )
            if rep.state == "dead":
                slot.state = BACKOFF
                slot.index = None
                slot.t_down = now
                slot.next_due = now  # already down: no grace owed
            self.slots.append(slot)
        # Capacity-aware shedding: convert a static fleet-wide bound to
        # the per-replica knob so admission tracks dispatchable capacity from
        # here on.  The EXACT fraction is kept (Fleet.admission_bound
        # ceils the product), so the operator's configured bound is
        # preserved bit-for-bit at full capacity.
        if capacity_aware and fleet.max_pending is not None:
            n = max(1, len(self.slots))
            fleet.max_pending_per_replica = fleet.max_pending / n
            fleet.max_pending = None
        # The fleet's revival seam: while a resurrection is pending, a
        # zero-live-replica fleet PARKS its queue for the replacement
        # instead of failing it terminally ("no live replicas remain").
        fleet.revival_hook = self._revival_pending
        # Chip-level health marks the supervisor honors before
        # resurrecting (the HealthEvent all-chips contract: "" marks /
        # clears every chip).
        self._unhealthy: set[str] = set()
        # Durable sessions: with a cadence set (and the fleet built
        # with journal_dir=), every poll past due checkpoints the
        # session journal — and a freshly noted death checkpoints
        # IMMEDIATELY, so a dead slot's sessions replay onto survivors
        # (or a successor process) from durable state no older than
        # the harvest.
        if journal_every_s is not None and journal_every_s <= 0:
            raise ValueError(
                f"journal_every_s must be > 0 or None, got "
                f"{journal_every_s}"
            )
        self.journal_every_s = journal_every_s
        self._t_journal: float | None = None
        # Telemetry (mirrored to the registry by SupervisorObserver).
        self.restarts_total = 0
        self.restart_failures = 0
        self.crash_loops = 0
        self.health_deferrals = 0
        self.restore_s: list[float] = []
        # The supervision timeline: one SupervisorEvent per transition
        # (death, backoff wait, canary probe, quarantine, rejoin, ...)
        # in a bounded ring — the merged fleet trace's supervisor lane
        # (workloads.obs.fleet_trace_events).  Evictions are counted,
        # never silent.
        self.events: deque = deque(maxlen=4096)
        self.dropped_events = 0
        self._obs = observer
        if observer is not None:
            observer._bind(self)

    def _event(
        self, kind: str, chip_id: str, detail: str = "",
        t: float | None = None,
    ) -> None:
        if len(self.events) == self.events.maxlen:
            self.dropped_events += 1
        self.events.append(SupervisorEvent(
            t=self._clock() if t is None else t, kind=kind,
            chip_id=chip_id, detail=detail,
        ))

    def drain_events(self) -> list:
        """Hand back (and clear) the supervision-event ring (the
        observer rings' drain contract)."""
        out = list(self.events)
        self.events.clear()
        return out

    # ---- introspection ---------------------------------------------------

    def slot_for(self, chip_id: str) -> ReplicaSlot:
        for slot in self.slots:
            if slot.chip_id == chip_id:
                return slot
        raise KeyError(f"no supervised slot for chip {chip_id!r}")

    def states(self) -> dict[str, str]:
        return {s.chip_id: s.state for s in self.slots}

    @property
    def quarantined(self) -> list[str]:
        return [s.chip_id for s in self.slots if s.state == QUARANTINED]

    @property
    def healed(self) -> bool:
        """True when every slot the supervisor still owns is serving —
        quarantined and forgotten slots are excluded by design (a
        crash-looping chip REACHING quarantine is the healthy outcome
        for it)."""
        return all(
            s.state == SERVING for s in self.slots
            if s.state not in (QUARANTINED, FORGOTTEN)
        )

    @property
    def restore_ms(self) -> list[float]:
        return [round(s * 1000, 2) for s in self.restore_s]

    def _revival_pending(self) -> bool:
        """True while any slot has a resurrection scheduled, in
        flight, or OWED — a replica that died within the current fleet
        step has not been poll()ed yet, but its slot still serves'
        claim is a promise to schedule one.  The fleet's revival seam
        reads this before declaring its queue unservable."""
        for s in self.slots:
            if s.state in (BACKOFF, PROBING):
                return True
            if s.state == SERVING and (
                s.index is None
                or s.index >= len(self.fleet.replicas)
                or self.fleet.replicas[s.index].state == "dead"
            ):
                return True  # death not yet noted; the next poll schedules
        return False

    # ---- operator surface ------------------------------------------------

    def adopt(self, chip_id: str, index: int) -> None:
        """Supervise a replica the fleet gained after arming
        (operator ``add_replica``)."""
        if any(s.chip_id == chip_id for s in self.slots):
            raise ValueError(
                f"chip {chip_id!r} is already supervised"
            )
        role = "mixed"
        if 0 <= index < len(self.fleet.replicas):
            role = getattr(self.fleet.replicas[index], "role", "mixed")
        self.slots.append(
            ReplicaSlot(chip_id=chip_id, index=index, role=role)
        )

    def forget(self, chip_id: str) -> None:
        """Stand down for one chip slot (an operator decommissioning
        the chip); its replica's death will no longer be healed."""
        self.slot_for(chip_id).state = FORGOTTEN

    def quarantine(self, chip_id: str, reason: str = "operator") -> None:
        slot = self.slot_for(chip_id)
        if slot.state != QUARANTINED:
            slot.state = QUARANTINED
            slot.reason = reason
            self._event("quarantine", chip_id, reason)

    def clear(self, chip_id: str) -> None:
        """Lift a quarantine: the slot's crash history is forgiven and
        a resurrection (half-open probe first) is due on the next
        ``poll``."""
        slot = self.slot_for(chip_id)
        if slot.state != QUARANTINED:
            return
        slot.failures.clear()
        slot.attempt = 0
        slot.reason = None
        self._event("clear", chip_id, "operator lifted quarantine")
        if slot.index is not None and (
            slot.index < len(self.fleet.replicas)
            and self.fleet.replicas[slot.index].state != "dead"
        ):
            slot.state = SERVING
            return
        slot.state = BACKOFF
        slot.index = None
        now = self._clock()
        if slot.t_down is None:
            slot.t_down = now
        slot.next_due = now

    def calibrate_probe(self) -> list[int]:
        """Seed the half-open probe oracle from a SCRATCH engine built
        by the factory right now (arm-time calibration: build, probe,
        close).  For fleets whose canary stream is a function of the
        factory's fixed rng (sampled engines) rather than a dense
        greedy reference — every later respawn must reproduce THIS
        stream bit-identically.  No-op when an oracle already exists;
        returns the oracle."""
        if self._probe_oracle is None:
            scratch = self.engine_factory(None)
            try:
                ok, detail = self._probe(scratch)
                if not ok:
                    raise RuntimeError(
                        f"probe calibration failed: {detail}"
                    )
            finally:
                try:
                    scratch.close()
                except Exception:  # noqa: BLE001 — scratch teardown
                    pass
        return list(self._probe_oracle)

    def note_health(self, events) -> None:
        """Honor ``HealthFanout`` marks: a chip carrying an Unhealthy
        mark gets no resurrection until the mark lifts.  Same
        attribution contract as the fleet's delivery: ``chip_id == ""``
        marks (or clears) every supervised chip."""
        for ev in events:
            if ev.health == HEALTHY:
                if not ev.chip_id:
                    self._unhealthy.clear()
                else:
                    self._unhealthy.discard(ev.chip_id)
            else:
                if not ev.chip_id:
                    self._unhealthy.update(s.chip_id for s in self.slots)
                else:
                    self._unhealthy.add(ev.chip_id)

    def _chip_marked(self, chip_id: str) -> bool:
        if chip_id in self._unhealthy:
            return True
        # A live, health-PAUSED replica on the same chip is the same
        # signal routed through the fleet instead of note_health.
        for rep in self.fleet.replicas:
            if (
                rep.chip_id == chip_id and rep.state != "dead"
                and rep.paused
            ):
                return True
        return False

    # ---- the supervision loop --------------------------------------------

    def poll(self, now: float | None = None) -> None:
        """One supervision pass: detect fresh deaths, then run every
        due resurrection.  Call after each ``fleet.step()`` (or use
        ``step()``/``run()``, which do)."""
        if self.fleet.closed:
            return
        now = self._clock() if now is None else now
        deaths = 0
        for slot in self.slots:
            if slot.state == SERVING and (
                slot.index is None
                or slot.index >= len(self.fleet.replicas)
                or self.fleet.replicas[slot.index].state == "dead"
            ):
                self._note_death(slot, now)
                deaths += 1
        if getattr(self.fleet, "_journal", None) is not None and (
            deaths
            or (
                self.journal_every_s is not None
                and (
                    self._t_journal is None
                    or now - self._t_journal >= self.journal_every_s
                )
            )
        ):
            try:
                self.fleet.journal_now()
            except Exception:  # noqa: BLE001 — supervision must not
                pass  # die because a checkpoint did
            self._t_journal = now
        for slot in self.slots:
            if (
                slot.state == BACKOFF
                and slot.next_due is not None
                and now >= slot.next_due
            ):
                self._resurrect(slot, now)
        if self._obs is not None:
            self._obs._supervisor_poll_end(self)

    def _note_death(self, slot: ReplicaSlot, now: float) -> None:
        slot.index = None
        slot.t_down = now
        slot.attempt = 0
        self._event("death", slot.chip_id, "replica died", t=now)
        self._record_failure(slot, now, "replica died")
        if slot.state == QUARANTINED:
            return
        if (
            self.max_restarts is not None
            and slot.restarts >= self.max_restarts
        ):
            slot.state = QUARANTINED
            slot.reason = (
                f"restart budget exhausted ({slot.restarts} >= "
                f"max_restarts {self.max_restarts})"
            )
            self.crash_loops += 1  # budget exhaustion is a loop verdict
            self._event("quarantine", slot.chip_id, slot.reason, t=now)
            return
        slot.state = BACKOFF
        delay = self._delay(slot)
        slot.next_due = now + delay
        self._event(
            "backoff", slot.chip_id, f"retry in {delay:.3f}s", t=now
        )

    def _delay(self, slot: ReplicaSlot) -> float:
        # Per-slot decorrelation: distinct chips jitter differently
        # even under one shared policy object.
        return self.backoff.derive(slot.chip_id).delay(slot.attempt)

    def _record_failure(
        self, slot: ReplicaSlot, now: float, reason: str
    ) -> None:
        """Append one failure stamp and apply the sliding-window
        crash-loop verdict."""
        slot.failures.append(now)
        slot.reason = reason
        while (
            slot.failures
            and now - slot.failures[0] > self.crash_loop_window_s
        ):
            slot.failures.popleft()
        if (
            len(slot.failures) >= self.crash_loop_k
            and slot.state != QUARANTINED
        ):
            slot.state = QUARANTINED
            slot.reason = (
                f"crash loop: {len(slot.failures)} failures in "
                f"{self.crash_loop_window_s}s (last: {reason})"
            )
            self.crash_loops += 1
            self._event("quarantine", slot.chip_id, slot.reason, t=now)

    def _restart_failed(
        self, slot: ReplicaSlot, now: float, reason: str
    ) -> None:
        self.restart_failures += 1
        slot.attempt += 1
        slot.state = BACKOFF
        self._event("restart_failed", slot.chip_id, reason, t=now)
        self._record_failure(slot, now, reason)
        if slot.state == QUARANTINED:
            return
        delay = self._delay(slot)
        slot.next_due = now + delay
        self._event(
            "backoff", slot.chip_id, f"retry in {delay:.3f}s", t=now
        )

    def _resurrect(self, slot: ReplicaSlot, now: float) -> None:
        """One resurrection attempt: respawn seam -> engine factory ->
        half-open canary probe -> rejoin.  Any failure re-enters
        backoff and feeds the crash-loop window."""
        if self._chip_marked(slot.chip_id):
            # HealthFanout mark honored: not a failure, just not yet —
            # re-check after the current delay without escalating.
            self.health_deferrals += 1
            slot.next_due = now + self._delay(slot)
            self._event(
                "health_deferral", slot.chip_id,
                "chip carries a live Unhealthy mark", t=now,
            )
            return
        slot.state = PROBING
        self._event("probe", slot.chip_id, "half-open canary", t=now)
        try:
            if self._faults is not None:
                self._faults.check("replica_respawn")
            engine = self.engine_factory(slot)
        except InjectedFault as exc:
            self._restart_failed(slot, self._clock(), f"respawn died: {exc}")
            return
        except Exception as exc:  # noqa: BLE001 — a factory failure is
            # a failed restart, not a supervisor crash.
            self._restart_failed(
                slot, self._clock(),
                f"engine factory failed: {type(exc).__name__}: {exc}",
            )
            return
        ok, detail = self._probe(engine)
        if not ok:
            try:
                engine.close()
            except Exception:  # noqa: BLE001 — discard must not raise
                pass
            self._restart_failed(
                slot, self._clock(), f"half-open probe failed: {detail}"
            )
            return
        try:
            slot.index = self.fleet.add_replica(
                engine, slot.chip_id, role=slot.role,
            )
        except EngineClosed:
            # The fleet shut down under us; discard the probed engine
            # rather than leak its pools.
            try:
                engine.close()
            except Exception:  # noqa: BLE001 — discard must not raise
                pass
            return
        slot.state = SERVING
        slot.attempt = 0
        slot.restarts += 1
        self.restarts_total += 1
        done = self._clock()
        if slot.t_down is not None:
            self.restore_s.append(done - slot.t_down)
        self._event(
            "rejoin", slot.chip_id,
            (
                f"restored in {(done - slot.t_down) * 1000:.1f}ms"
                if slot.t_down is not None else "rejoined"
            ),
            t=done,
        )
        slot.t_down = None
        slot.next_due = None
        slot.reason = None

    def _probe(self, engine) -> tuple[bool, str]:
        """Run the canary on the NOT-YET-JOINED engine: it must finish
        'ok' within the step budget with a stream bit-identical to the
        oracle.  Greedy canaries make that a real equivalence check;
        the first success seeds the oracle when none was injected."""
        self._probes += 1
        # Ledger-armed engines classify the canary's chip time and
        # tokens as probe_warmup waste, not goodput (workloads/
        # ledger.py OFFBOOK_PHASES) — the probe brackets one whole
        # request, exactly the offbook contract.
        had_phase = getattr(engine, "ledger_phase", None)
        if had_phase is not None:
            engine.ledger_phase = "probe"
        try:
            tokens, status = run_canary(
                engine, self.probe_prompt, self.probe_new,
                rid=f"canary-{self._probes}",
                max_steps=self.probe_max_steps,
            )
        except Exception as exc:  # noqa: BLE001 — a probe blowing up IS
            # the signal the half-open state exists for.
            return False, f"{type(exc).__name__}: {exc}"
        finally:
            if had_phase is not None:
                engine.ledger_phase = had_phase
        if tokens is None:
            return False, (
                f"canary did not finish within {self.probe_max_steps} steps"
            )
        if status != "ok":
            return False, f"canary finished {status!r}"
        if self._probe_oracle is None:
            self._probe_oracle = tokens
            return True, "oracle seeded"
        if tokens != self._probe_oracle:
            return False, (
                f"canary stream diverged from oracle: {tokens} != "
                f"{self._probe_oracle}"
            )
        return True, "bit-identical"

    # ---- fleet-shaped driving surface ------------------------------------
    # Duck-typed to the Fleet's loop API so drive_open_loop / FleetServer
    # can run SUPERVISED by passing the supervisor where a fleet goes.

    def submit(self, *args, **kwargs):
        return self.fleet.submit(*args, **kwargs)

    def cancel(self, rid: str) -> bool:
        return self.fleet.cancel(rid)

    @property
    def idle(self) -> bool:
        return self.fleet.idle

    @property
    def closed(self) -> bool:
        return self.fleet.closed

    def step(self):
        """One supervised fleet iteration: step the fleet, then heal."""
        finished = self.fleet.step()
        self.poll()
        return finished

    def _parked(self) -> bool:
        """True while the fleet is alive but nothing is dispatchable —
        queued work is waiting on a resurrection (or a health resume),
        so the driver loops must sleep instead of hot-spinning through
        the whole backoff window (the Fleet.run/serve_forever parked
        contract)."""
        fleet = self.fleet
        if any(r.dispatchable for r in fleet.alive):
            return False
        # Nothing dispatchable: parked if anything is alive (health
        # pause / drain) OR a resurrection is on its way to an
        # all-dead fleet.
        return bool(fleet.alive) or self._revival_pending()

    def run(self) -> dict[str, list[int]]:
        """Drive to fleet idle (the fleet.run contract) with the
        supervisor healing between steps.  NOTE: idle means no REQUESTS
        in flight; use ``wait_healed`` to additionally wait out pending
        resurrections."""
        out: dict[str, list[int]] = {}
        while not self.fleet.idle:
            for fr in self.step():
                out[fr.rid] = fr.tokens
            if self._parked():
                time.sleep(0.001)
        return out

    def serve_forever(self, stop_event) -> None:
        """The supervised front-end driver loop (the fleet's
        ``serve_forever`` plus a heal pass per iteration) —
        ``FleetServer(fleet, supervisor=...)`` runs exactly this."""
        drive_forever(
            self.fleet, stop_event,
            step_fn=self.fleet.step, poll_fn=self.poll,
            parked_fn=self._parked,
        )

    def wait_healed(self, timeout_s: float = 30.0) -> bool:
        """Step the (possibly idle) fleet until every supervised,
        non-quarantined slot serves again, or the timeout passes.
        Returns ``healed``."""
        deadline = time.monotonic() + timeout_s
        while not self.healed and time.monotonic() < deadline:
            self.step()
            if not self.healed:
                due = [
                    s.next_due for s in self.slots
                    if s.state == BACKOFF and s.next_due is not None
                ]
                if due:
                    wait = min(due) - self._clock()
                    if wait > 0:
                        time.sleep(min(wait, 0.05))
        return self.healed


def drive_forever(fleet, stop_event, *, step_fn, poll_fn, parked_fn) -> None:
    """The shared front-end driver loop (one copy, three controllers:
    Fleet.serve_forever stays the bare two-state original;
    FleetSupervisor and FleetAutoscaler run this): step under the
    fleet lock while busy, run the CONTROL pass outside it — a heal or
    scale poll may build an engine and run a canary, seconds of work
    the HTTP handler threads must never block on — and sleep when idle
    or parked."""
    while not stop_event.is_set():
        with fleet._lock:
            busy = not fleet.idle and not fleet.closed
            if busy:
                step_fn()
            parked = busy and parked_fn()
        poll_fn()
        if not busy:
            time.sleep(0.002)
        elif parked:
            time.sleep(0.001)


def run_canary(
    engine, prompt, new: int, *, rid: str = "canary",
    max_steps: int = 400,
) -> tuple[list[int] | None, str | None]:
    """Drive ONE request to completion on a not-yet-joined engine — the
    canary primitive shared by the supervisor's half-open probe and the
    autoscaler's probed scale-up.  Returns ``(tokens, status)``; tokens
    is None when the request never finished within ``max_steps``.
    Exceptions propagate — blowing up IS the signal probes exist for,
    and each caller words its own verdict."""
    engine.submit(prompt, new, rid=rid)
    tokens: list[int] | None = None
    status = None
    for _ in range(max_steps):
        for req in engine.step():
            if req.rid == rid:
                tokens = [int(t) for t in req.tokens]
                status = req.status
        if tokens is not None or engine.idle:
            break
    return tokens, status


def make_engine_factory(
    params, config, *, engine_kw=None, probe=None, snapshot=None, device=None,
):
    """The standard ``engine_factory`` for homogeneous fleets: respawn
    a ``ServeEngine`` over the SHARED params (warm restarts — weights
    and built kernels are reused).  Returns ``(factory, oracle)``
    where ``oracle`` is the canary's greedy reference stream from the
    dense model (``None`` when no ``probe`` is given — the supervisor
    then seeds trust-on-first-use).

    Every engine runs on ``device`` (default ``cuda``; pass ``"cpu"``
    explicitly; a ``device`` in ``engine_kw`` wins).  The dense oracle is the port's ``generate``; in bf16
    it may part from the paged engine's K1 stream at a near tie, so a
    bf16 fleet takes ``FleetSupervisor.calibrate_probe``'s oracle.

    ``snapshot`` (faststart.py's ``EngineSnapshot``, duck-typed:
    ``prime(engine)`` and ``probe_oracle``) arms fast start as in the
    JAX package."""
    from .serve import ServeEngine

    engine_kw = dict(engine_kw or {})
    engine_kw.pop("observer", None)  # observers are per-replica identity
    engine_kw.setdefault("device", device)

    def factory(slot):
        kw = dict(engine_kw)
        engine = ServeEngine(params, config, **kw)
        if snapshot is not None:
            snapshot.prime(engine)
        return engine

    oracle = None
    if probe is not None:
        from .generate import generate

        prompt, new = probe
        oracle = [int(t) for t in generate(
            params, torch.tensor([prompt]), config,
            max_new_tokens=new, device=engine_kw["device"],
        )[0].tolist()]
    elif (
        snapshot is not None
        and getattr(snapshot, "probe_oracle", None) is not None
    ):
        oracle = [int(t) for t in snapshot.probe_oracle]
    return factory, oracle
